"""The port's spans and counters (utils/log.py): a span's seconds and its
profiler range, the thread-CPU spans of the align pool, the keys and counts
a search and its m8 lines leave, how they nest in a torch.profiler trace,
and the operator's `easy-search --profile-dir` trace."""
import json
import os
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from foldseek_tpu_torch.db.storage import load_db
from foldseek_tpu_torch.db.synth import synth_db
from foldseek_tpu_torch.ingest.createdb import create_db
from foldseek_tpu_torch.search import SearchParams, format_results
from foldseek_tpu_torch.search import pipeline as tpipe
from foldseek_tpu_torch.utils import log
from foldseek_tpu_torch.utils.hostpar import map_queries

from _torch_adapters import few_torch_threads

CPU = torch.device("cpu")
MODES = {
    # (prefilter mode, queries, FOLDSEEK_TPU_DEVICE_GATES)
    "mode1": (1, 4, "1"),        # gate fleets on the CPU, the pool's threads
    "mode1_single": (1, 1, None),    # one query: host gates, no pool thread
    "mode3": (3, 4, None),
}
# child -> parent, as the ranges nest on the calling thread
NESTING = {
    "mode1": {"fs.prefilter.profiles": "fs.prefilter",
              "fs.prefilter.launches": "fs.prefilter",
              "fs.prefilter.readback": "fs.prefilter",
              "fs.prefilter.merge": "fs.prefilter",
              "fs.align.setup": "fs.structurealign",
              "fs.sw_scoring": "fs.structurealign",
              "fs.host_loop": "fs.structurealign",
              "fs.gates.dispatch": "fs.host_loop",
              "fs.gates_drain": "fs.structurealign",
              "fs.format.setup": "fs.format",
              "fs.format.lines": "fs.format"},
    "mode1_single": {"fs.prefilter.readback": "fs.prefilter",
                     "fs.align.query_cpu": "fs.host_loop",
                     "fs.align.backtraces_cpu": "fs.align.query_cpu",
                     "fs.align.hits_cpu": "fs.align.query_cpu",
                     "fs.align.gates_cpu": "fs.align.query_cpu"},
    "mode3": {"fs.sw_scoring": "fs.ungapped+gapped_prefilter",
              "fs.host_loop": "fs.ungapped+gapped_prefilter",
              "fs.mode3.evalues": "fs.host_loop",
              "fs.mode3.order": "fs.host_loop",
              "fs.mode3.records": "fs.host_loop",
              "fs.format.lines": "fs.format"},
}
KEYS = {
    "mode1": ("prefilter", "prefilter.profiles", "prefilter.launches",
              "prefilter.readback", "prefilter.merge", "structurealign",
              "align.setup", "sw_scoring", "host_loop", "gates.dispatch",
              "gates_drain", "align.query_cpu", "align.backtraces_cpu",
              "align.hits_cpu", "format", "format.setup", "format.lines"),
    "mode1_single": ("prefilter", "prefilter.readback", "align.setup",
                     "host_loop", "align.query_cpu", "align.backtraces_cpu",
                     "align.hits_cpu", "align.gates_cpu", "format.setup"),
    "mode3": ("ungapped+gapped_prefilter", "sw_scoring", "host_loop",
              "mode3.evalues", "mode3.order", "mode3.records", "format",
              "format.setup", "format.lines"),
}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    yield from few_torch_threads()


@pytest.fixture(scope="module")
def dbs(golden_dir, tmp_path_factory):
    """The 17-entry fixture DB expanded to 120 targets and 4 queries."""
    d = tmp_path_factory.mktemp("torch_tracing")
    inputs = ([str(p) for p in sorted((golden_dir / "msa" / "sup")
                                      .glob("*.pdb"))]
              + [str(golden_dir / "d1asha.fcz")])
    base = create_db(inputs, str(d / "base"))
    synth_db(base, 120, str(d / "t120"), seed=1)
    synth_db(base, 4, str(d / "q4"), seed=4)
    return load_db(str(d / "t120")), load_db(str(d / "q4"))


def _search(dbs, case, monkeypatch):
    """A search of the case's queries and its m8 lines, the registry reset
    just before."""
    tdb, qdb = dbs
    mode, n_q, gates = MODES[case]
    if gates is None:
        monkeypatch.delenv("FOLDSEEK_TPU_DEVICE_GATES", raising=False)
    else:
        monkeypatch.setenv("FOLDSEEK_TPU_DEVICE_GATES", gates)
    if n_q < qdb.size:
        from foldseek_tpu_torch.cluster.workflow import _subdb_view
        qdb = _subdb_view(qdb, [int(k) for k in qdb.keys[:n_q]])
    params = SearchParams(prefilter_mode=mode, add_backtrace=True)
    log.reset_stage_times()
    res = tpipe.search(qdb, tdb, params, CPU, same_db=False)
    lines = format_results(qdb, tdb, res, params.format_output,
                           with_backtrace=True)
    assert lines
    return res, lines


def test_span_adds_wall_seconds_and_nests():
    log.reset_stage_times()
    with log.span("outer") as outer:
        time.sleep(0.02)
        with log.span("outer.inner"):
            time.sleep(0.01)
    with log.Timer("outer(again)"):
        pass
    got = log.snapshot_stage_times()
    assert set(got) == {"outer", "outer.inner"}
    assert got["outer"] >= outer.elapsed >= got["outer.inner"] + 0.02
    assert got["outer.inner"] >= 0.01


@pytest.mark.parametrize("n_items", [1, 4])
def test_pool_span_adds_thread_cpu_seconds(n_items):
    """In a map_queries task, on the pool's threads or (one item) on the
    caller's, a span counts the thread's CPU seconds under "<key>_cpu": a
    sleep adds nothing, work does."""
    def task(i):
        with log.span("task"):
            time.sleep(0.05)
            t0 = time.thread_time()
            while time.thread_time() - t0 < 0.01:
                pass
        return i

    log.reset_stage_times()
    assert map_queries(task, range(n_items)) == list(range(n_items))
    got = log.snapshot_stage_times()
    assert set(got) == {"task_cpu"}
    assert 0.01 * n_items <= got["task_cpu"] < 0.01 * n_items + 0.04
    with log.span("task"):      # outside a task: wall seconds again
        pass
    assert "task" in log.snapshot_stage_times()


def test_add_count_keeps_one_number_until_reset():
    log.reset_stage_times()
    log.add_count("launches.sw")
    log.add_count("launches.sw", 2)
    log.record_count("align_hits", 5)
    log.record_count("align_hits", 1)
    assert log.snapshot_stage_counts() == {"launches.sw": [3],
                                           "align_hits": [5, 1]}
    assert log.stage_count("launches.sw") == 3
    assert log.stage_count("align_hits") == 6
    assert log.stage_count("launches.gapless") == 0
    log.reset_stage_times()
    assert log.stage_count("launches.sw") == 0


def test_no_profiler_enters_no_range(dbs, monkeypatch):
    """With no profiler on, no span opens a record_function."""
    def fail(*a, **k):
        raise AssertionError("record_function entered without a profiler")
    monkeypatch.setattr(torch.profiler, "record_function", fail)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", fail)
    with log.span("x"):
        pass
    for case in MODES:
        _search(dbs, case, monkeypatch)


def _ranges(prof):
    """name -> [(start, end, thread)] of the profile's "fs." ranges."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("fs.") and e.device_type() != \
                torch.autograd.DeviceType.CUDA:
            out.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns(),
                 e.start_thread_id()))
    return out


@pytest.mark.parametrize("case", list(MODES))
def test_search_ranges_nest_under_the_profiler(dbs, case, monkeypatch):
    """Under torch.profiler with the CPU activity alone (as the benchmark's
    trace), the spans of a search and its m8 lines are ranges of the
    calling thread, each inside its parent's; the pool's threads, which
    that profiler does not record, leave none."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _search(dbs, case, monkeypatch)
    ranges = _ranges(prof)
    for child, parent in NESTING[case].items():
        assert child in ranges and parent in ranges, (child, parent, ranges)
        for s, e, tid in ranges[child]:
            assert any(ps <= s and e <= pe and ptid == tid
                       for ps, pe, ptid in ranges[parent]), (child, parent)
    if case == "mode1":
        assert not any(n.startswith("fs.align.") and n.endswith("_cpu")
                       for n in ranges)


@pytest.mark.parametrize("case", list(MODES))
def test_search_records_every_key_and_counter(dbs, case, monkeypatch):
    """Every span and counter of the search path, and they agree: records
    <= tracebacks <= pairs, a stage's parts inside the stage."""
    res, _lines = _search(dbs, case, monkeypatch)
    t, c = log.snapshot_stage_times(), log.snapshot_stage_counts()
    for key in KEYS[case]:
        assert t.get(key, 0) > 0, (key, t)
    if case == "mode3":
        assert "align_pairs" not in c and not log.stage_count("gate_fleets")
        assert sum(t[k] for k in ("mode3.evalues", "mode3.order",
                                  "mode3.records")) <= t["host_loop"]
        return
    hits = sum(len(v) for v in res.values())
    assert c["align_hits"] == [hits] and hits > 0
    assert len(c["align_backtraces"]) == len(c["align_pairs"]) == 1
    assert hits <= c["align_backtraces"][0] <= c["align_pairs"][0]
    assert t["prefilter.readback"] <= t["prefilter"]
    assert (t["prefilter.profiles"] + t["prefilter.launches"]
            + t["prefilter.readback"] + t["prefilter.merge"]) <= t["prefilter"]
    assert t["align.setup"] + t["sw_scoring"] + t["host_loop"] \
        <= t["structurealign"]
    assert t["format.setup"] + t["format.lines"] <= t["format"]
    assert (t["align.backtraces_cpu"] + t["align.hits_cpu"]
            + t.get("align.gates_cpu", 0)) <= t["align.query_cpu"]
    if case == "mode1":
        assert t["gates.dispatch"] <= t["host_loop"]
        assert log.stage_count("gate_fleets") > 0
        assert "align.gates_cpu" not in t
    else:
        assert "gates.dispatch" not in t and "gate_fleets" not in c


def test_easy_search_profile_dir_holds_the_spans(golden_dir, tmp_path,
                                                 monkeypatch):
    """`easy-search --profile-dir D`: the exported trace holds the stage
    ranges and, where this torch profiles every thread, the align pool's
    thread-CPU ranges too."""
    from foldseek_tpu_torch.cli import main as tmain
    monkeypatch.setenv("FOLDSEEK_TPU_FORK", "0")
    sup = sorted((golden_dir / "msa" / "sup").glob("*.pdb"))
    qdir = tmp_path / "q"
    qdir.mkdir()
    for p in sup[:4]:
        os.symlink(p, qdir / p.name)
    assert tmain(["easy-search", str(qdir), str(golden_dir / "msa" / "sup"),
                  str(tmp_path / "out.m8"), str(tmp_path / "tmp"), "--gpu",
                  "1", "--device", "cpu", "-v", "1", "--profile-dir",
                  str(tmp_path / "prof")]) == 0
    events = json.loads((tmp_path / "prof" / "easy_search_trace.json")
                        .read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"fs.prefilter", "fs.host_loop", "fs.format"} <= names
    try:
        torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return
    assert {"fs.align.query_cpu", "fs.align.hits_cpu"} <= names
