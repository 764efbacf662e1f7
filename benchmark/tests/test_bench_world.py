"""A cell of several cards: worlds of two ranks started by `harness.launch`
(each rank `_world_rank.py`, gloo on the CPU at `_tiny` sizes), against the
one-card path in this process; and `device_report`, which counts the cards
a run used, on cases."""
import json
import os
import sys
import time

import pytest

from benchmark import harness
from benchmark.drivers.search import SearchDriver
from benchmark.tests import _world_rank
from benchmark.tests._tiny import BENCH, tiny

WORKLOAD = "sprot_gpu.proteome"
SEED = 2**31 + 23
SECONDS = 1.5
DEADLINE_S = 240


def world(tmp_path, mode, device="cpu"):
    """(exit codes, rank 0's result, seconds taken, rank 0's m8 lines a
    call) of a two-rank run."""
    lines = tmp_path / "lines.json"
    cmd = [sys.executable, "-m", "benchmark.tests._world_rank",
           "--mode", mode, "--device", device, "--lines", str(lines),
           "--workload", WORKLOAD, "--seed", str(SEED),
           "--seconds", str(SECONDS), "--trace", "0"]
    env = dict(os.environ, OMP_NUM_THREADS="1", FOLDSEEK_TPU_FORK="0")
    t0 = time.perf_counter()
    rcs, out = harness.launch(cmd, 2, t0, t0 + DEADLINE_S, env=env)
    took = time.perf_counter() - t0
    calls = json.loads(lines.read_text()) if lines.exists() else None
    return rcs, out, took, calls


def through_the_merge(res):
    """Records as a world's rank merge hands them back: each sent as its
    text line (`sharded_align_all`) and parsed again."""
    from foldseek_tpu_torch.search.resultdb import parse_result_line
    from foldseek_tpu_torch.search.results import result_to_line
    return {qk: [parse_result_line(f"{qk}\t{result_to_line(r, True)}")[1]
                 for r in rs] for qk, rs in res.items()}


def test_two_ranks_agree_with_one(tmp_path):
    rcs, out, _took, two = world(tmp_path, "clean")
    assert rcs == [0, 0] and out is not None
    devices = out["device"]["devices"]
    assert [d["rank"] for d in devices] == [0, 1]
    assert out["device"]["count"] == 2
    assert out["attempted"] > 0 and out["failed"] == 0

    cfg, traffic = tiny(WORKLOAD)
    rec = _world_rank.Recording
    rec.lines, rec.made = [], []
    one = harness.run_cell(BENCH, WORKLOAD, SEED, SECONDS, False, "cpu",
                           time.perf_counter(), cfg=cfg, traffic=traffic,
                           driver_cls=rec)
    assert len(one["device"]["devices"]) == 1
    # the warm call and at least one call of the window in both runs, the
    # window's calls taking the pool's batches in the same order
    n = min(len(rec.lines), len(two))
    assert n >= 2 and any(two[1:n])
    # Each two-rank line is the one-rank line, or that line as the rank
    # merge leaves it: the merge sends each record as text (`result_to_line`:
    # the identity truncated to three digits, the E-value as "%.3E"), so the
    # m8's fident and E-value can differ from a one-rank run's until the
    # merge is exact. For the same reason `correct` is not asserted:
    # `evalue_gap` reads above its limit of 1e-6 in a world of two ranks.
    merged = 0
    for c in range(n):
        driver, qdb, res = rec.made[c]
        again = SearchDriver.call_format(driver, qdb, through_the_merge(res))
        assert len(two[c]) == len(rec.lines[c])
        for got, exact, after in zip(two[c], rec.lines[c], again):
            assert got in (exact, after)
            merged += got != exact
    print(f"{merged} of {sum(map(len, two[:n]))} lines as the merge leaves "
          f"them; two ranks: {out['checks']}; one rank: {one['checks']}")


def test_an_idle_rank_is_counted_as_idle(tmp_path, capfd):
    rcs, out, _took, _calls = world(tmp_path, "idle")
    assert out is None
    assert rcs[0] != 0
    assert "the run used 1 card(s) of the 2" in capfd.readouterr().err


def test_a_failing_rank_ends_the_run(tmp_path, capfd):
    rcs, out, took, _calls = world(tmp_path, "raise")
    assert out is None
    # rank 1 exits 1 of itself, and rank 0, left waiting for it in a
    # collective, is killed by the launcher before the deadline
    assert rcs[1] == 1 and rcs[0] != 0, rcs
    assert took < DEADLINE_S
    err = capfd.readouterr().err
    assert "rank 1 fails in its second call" in err
    assert "[bench r1]" in err


def rank(r, uuid, peak, **kw):
    return dict(rank=r, platform="gpu", index=r, name="H100", uuid=uuid,
                peak_bytes=peak, **kw)


@pytest.mark.parametrize("ranks,count,peak", [
    ([rank(0, "GPU-a", 5)], 1, 5),
    # two ranks on one card count once, and their memory adds up there
    ([rank(0, "GPU-a", 5), rank(1, "GPU-a", 7)], 1, 12),
    # a card that held nothing is not counted
    ([rank(0, "GPU-a", 5), rank(1, "GPU-b", 0)], 1, 5),
    # the peak is the fullest card's
    ([rank(0, "GPU-a", 5), rank(1, "GPU-b", 9), rank(2, "GPU-c", 2)], 3, 9),
    ([rank(0, "cpu", 0)], 0, 0),
])
def test_device_report_counts_the_cards_that_held_memory(ranks, count, peak):
    out = harness.device_report(ranks)
    assert (out["count"], out["memory_peak_bytes"]) == (count, peak)
    assert out["devices"] == ranks
    assert "busy_s" not in out


def test_device_report_of_a_traced_run():
    out = harness.device_report([
        rank(0, "GPU-a", 5, busy_s=2.0, window_s=10.0),
        rank(1, "GPU-b", 5, busy_s=4.0, window_s=11.0)])
    assert out["busy_s"] == 3.0 and out["window_s"] == 10.0
    assert (out["platform"], out["kind"]) == ("gpu", "H100")
    assert list(out)[:4] == ["platform", "kind", "count",
                             "memory_peak_bytes"]


@pytest.mark.cuda
def test_two_ranks_on_two_cards_count_two(tmp_path):
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    rcs, out, _took, _calls = world(tmp_path, "clean", device="cuda")
    assert rcs == [0, 0] and out is not None
    assert out["device"]["count"] == 2
    assert {d["index"] for d in out["device"]["devices"]} == {0, 1}
    print(json.dumps(out["device"]))
