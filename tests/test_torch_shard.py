"""`search` over a target DB row-sharded across a world of ranks
(`parallel/distributed.py` `sharded_prefilter`, `row_sharded_align`) on
the CPU: gloo worlds of 2 and 4 ranks (`tests/shard_worker.py`, a
`file://` rendezvous in the test's tmp dir) against the world of one in
this process, on DBs of adjacent families whose sizes are no multiple of
ranks x 128, one of them leaving a rank's whole range as padding:
  * every rank's m8 lines and records (E-values to the bit) equal the
    world of one's, call by call;
  * each rank's one resident panel set holds only its rows, built once
    over two calls (`shard.build` and `panel_set_entries` in the first
    call alone);
  * the shard's counts and the exchanges' spans, on every rank, and none
    of them in the world of one;
and the benchmark's four-rank cell `afdb50_gpu.proteome4` at `_tiny`
sizes through `harness.launch`: correct, with every count of its check 0.
"""
import json
import os
import subprocess
import sys
import time

import pytest
import torch

import shard_worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 240
ROW = 128


@pytest.fixture(autouse=True)
def _no_fork(monkeypatch):
    monkeypatch.setenv("FOLDSEEK_TPU_FORK", "0")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def spawn(tmp_path, size: int, entries: int, device: str = "cpu",
          max_accept: int = 0) -> list:
    """Each rank's output of a world of `size` ranks on `device`, in rank
    order."""
    env = dict(os.environ, OMP_NUM_THREADS="1", FOLDSEEK_TPU_FORK="0",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + os.environ.get("PYTHONPATH", "").split(
                       os.pathsep)))
    out = str(tmp_path / "out")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "shard_worker.py"), out,
         "--entries", str(entries), "--init-method",
         f"file://{tmp_path / 'store'}", "--world-size", str(size),
         "--rank", str(r), "--device", device, "--max-accept",
         str(max_accept)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for r in range(size)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=RANK_TIMEOUT)
            assert p.returncode == 0, err.decode()[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for r in range(size):
        with open(f"{out}.{r}.json") as f:
            outs.append(json.load(f))
    return outs


@pytest.fixture(scope="module")
def one():
    """The world of one, by DB size."""
    return {}


def world_of_one(one, entries):
    if entries not in one:
        one[entries] = json.loads(json.dumps(shard_worker.run(entries)))
    return one[entries]


def rows_held(entries, size):
    per_rank = -(-(-(-entries // size)) // ROW) * ROW
    return [max(0, min(entries, (r + 1) * per_rank) - r * per_rank)
            for r in range(size)]


# (ranks, entries): 300 over 2 ranks holds 256 + 44 rows; 450 over 4 holds
# 128 x 3 + 66; 300 over 4 leaves rank 3's whole range as padding
CASES = [(2, 300), (4, 450), (4, 300)]


@pytest.mark.parametrize("size,entries", CASES)
def test_sharded_search_equals_one_rank(tmp_path, one, size, entries):
    ranks = spawn(tmp_path, size, entries)
    single = world_of_one(one, entries)
    held = rows_held(entries, size)
    assert sum(held) == entries and (entries != 300 or size != 4
                                     or held[-1] == 0)
    for r, calls in enumerate(ranks):
        for c, (got, want) in enumerate(zip(calls, single)):
            assert got["lines"] == want["lines"], (r, c)
            assert got["records"] == want["records"], (r, c)
        assert any(call["lines"] for call in calls)
        first, second = calls
        # one resident set, of this rank's rows alone, built in the first
        # call and kept for the second
        for call in calls:
            assert [p["entries"] for p in call["resident"]] == [held[r]]
        assert first["counts"]["shard.rows"] == [held[r]]
        assert first["counts"]["panel_set_entries"] == [held[r]]
        assert "shard.build" in first["times"]
        assert "shard.build" not in second["times"]
        assert "panel_set_entries" not in second["counts"]
        assert "shard.rows" not in second["counts"]


@pytest.mark.parametrize("size,entries", CASES[:2])
def test_shard_counts_and_exchange_spans(tmp_path, one, size, entries):
    ranks = spawn(tmp_path, size, entries)
    single = world_of_one(one, entries)
    for c, want in enumerate(single):
        counts = [calls[c]["counts"] for calls in ranks]
        pairs = [cnt["shard.pairs"] for cnt in counts]
        total = want["counts"]["align_pairs"]
        assert sum(p[0] for p in pairs) == total[0] > 0
        for cnt in counts:
            assert cnt["shard.pairs_all"] == total
            assert cnt["shard.pairs_max"] == [max(p[0] for p in pairs)]
            assert cnt["align_pairs"] == cnt["shard.pairs"]
        for calls in ranks:
            assert {"prefilter.exchange", "align.exchange"} <= set(
                calls[c]["times"])
        # a world of one takes the one-process path: no shard, no exchange
        assert not {k for k in want["counts"] if k.startswith("shard.")}
        assert not {k for k in want["times"]
                    if k.endswith(".exchange") or k.startswith("shard.")}


def test_accept_budget_shards_by_query(tmp_path):
    """An accept budget stops a query's loop in prefilter order, which no
    rank follows over its rows alone: the stage is sharded by query, and
    the m8 lines and records still equal the world of one's."""
    ranks = spawn(tmp_path, 2, 300, max_accept=2)
    single = shard_worker.run(300, max_accept=2)
    assert any(call["lines"] for call in single)
    for calls in ranks:
        for got, want in zip(calls, single):
            assert got["lines"] == want["lines"]
            assert got["records"] == want["records"]
            assert "shard.pairs" not in got["counts"]
            assert "align.exchange" in got["times"]


def test_four_rank_cell_is_correct(tmp_path):
    """`afdb50_gpu.proteome4` at `_tiny` sizes (300 entries: rank 3 holds
    only padding), four gloo ranks on the CPU through the harness: the
    check finds every answer exact."""
    from benchmark import harness
    cmd = [sys.executable, "-m", "benchmark.tests._world_rank", "--mode",
           "clean", "--device", "cpu", "--workload", "afdb50_gpu.proteome4",
           "--seed", str(2**31 + 91), "--seconds", "1.5", "--trace", "1"]
    env = dict(os.environ, OMP_NUM_THREADS="1", FOLDSEEK_TPU_FORK="0")
    t0 = time.perf_counter()
    rcs, out = harness.launch(cmd, 4, t0, t0 + 2 * RANK_TIMEOUT, env=env)
    assert rcs == [0, 0, 0, 0] and out is not None
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert out["device"]["count"] == 4
    checks = out["checks"]
    assert checks.pop("evalue_gap")["value"] <= 1e-6
    assert all(v["value"] == 0 for v in checks.values()), checks
    m = out["metrics"]
    assert m["exchange_ms_per_query.proteome4"]["value"] > 0
    assert 1.0 <= m["pairs_imbalance.proteome4"]["value"] <= 4.0


@pytest.mark.cuda
def test_sharded_search_on_one_card(tmp_path, monkeypatch):
    """Four gloo ranks sharing one card, the kernels and the gate fleets
    (forced on) running there: every rank's records and m8 lines equal the
    world of one's on that card, to the bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setenv("FOLDSEEK_TPU_DEVICE_GATES", "1")
    ranks = spawn(tmp_path, 4, 2000, device="cuda:0")
    single = shard_worker.run(2000, device="cuda:0")
    assert any(call["lines"] for call in single)
    for r, calls in enumerate(ranks):
        for c, (got, want) in enumerate(zip(calls, single)):
            assert got["lines"] == want["lines"], (r, c)
            assert got["records"] == want["records"], (r, c)
    assert any("gate_fleets" in calls[0]["counts"] for calls in ranks)
