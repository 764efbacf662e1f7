"""A whole run of each configuration's cell on the CPU at a small size (the
harness's look for a card skipped, the program's plain PyTorch paths),
clean and with the timed path broken underneath: the check has to call the
broken runs wrong."""
import time

import pytest

from benchmark import harness
from benchmark.tests._tiny import BENCH, tiny

SEED = 2**31 + 11


def run(workload, fault=None, seconds=0.5):
    cfg, traffic = tiny(workload)
    return harness.run_cell(BENCH, workload, SEED, seconds, False, "cpu",
                            time.perf_counter(), cfg=cfg, traffic=traffic,
                            fault=fault)


def half_left_out(res, lines):
    """Every second query of a call answered with nothing."""
    keys = sorted(res)
    gone = set(keys[1::2])
    names = {f"Q{k - 1_000_000_000}" for k in gone}
    return ({k: ([] if k in gone else v) for k, v in res.items()},
            [x for x in lines if x.split("\t", 1)[0] not in names])


def answer_altered(res, lines):
    """The first hit of every query reports a wrong target end."""
    for rs in res.values():
        if rs:
            rs[0].t_end += 1
    return res, lines


def score_altered(res, lines):
    for rs in res.values():
        if rs:
            rs[0].score += 1
    return res, lines


def last_slot_altered(res, lines):
    """Only the last query of a call's stack reports a wrong first hit."""
    last = max(res)
    if res[last]:
        res[last][0].score += 1
        res[last][0].t_end += 1
    return res, lines


class Stale:
    """Every call hands back the previous call's answers unchanged."""

    def __init__(self):
        self.last = None

    def __call__(self, res, lines):
        prev, self.last = self.last, (res, lines)
        return prev if prev is not None else ({}, [])


@pytest.mark.parametrize("workload", ["sprot_gpu.proteome",
                                      "sprot_gpu_gapped.proteome"])
def test_clean_run_is_correct(workload):
    out = run(workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("workload,fault", [
    ("sprot_gpu.proteome", half_left_out),
    ("sprot_gpu.proteome", answer_altered),
    ("sprot_gpu.proteome", "stale"),
    ("sprot_gpu_gapped.proteome", half_left_out),
    ("sprot_gpu_gapped.proteome", score_altered),
    ("sprot_gpu_gapped.proteome", "stale"),
])
def test_broken_run_is_wrong(workload, fault):
    # two calls at least, so that a stale answer reaches the check
    out = run(workload, Stale() if fault == "stale" else fault, seconds=2.0)
    assert not out["correct"], out["checks"]


def test_single_cell_clean_run_is_correct():
    out = run("sprot_gpu.single")
    assert out["correct"], out["checks"]


@pytest.mark.cuda
def test_small_cell_on_the_card_is_correct():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg, traffic = tiny("sprot_gpu.proteome", entries=3000)
    out = harness.run_cell(BENCH, "sprot_gpu.proteome", SEED, 1.0, True,
                           "cuda:0", time.perf_counter(), cfg=cfg,
                           traffic=traffic)
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0


@pytest.mark.parametrize("workload", ["sprot_gpu.proteome",
                                      "sprot_gpu_gapped.proteome"])
def test_a_fault_in_one_slot_of_each_call_is_caught(workload):
    # no random draws: the sample's ends of two calls alone catch it
    cfg, traffic = tiny(workload, check_all=False)
    traffic.update(check_queries=0, check_longest=False)
    out = harness.run_cell(BENCH, workload, SEED, 2.0, False, "cpu",
                           time.perf_counter(), cfg=cfg, traffic=traffic,
                           fault=last_slot_altered)
    assert not out["correct"], out["checks"]
