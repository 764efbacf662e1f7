"""Metric readers and the yardstick on hand-made inputs, and the
benchmark's files against each other."""
import json
import os
import re
import statistics

import pytest

from benchmark import harness
from benchmark import roofline as R

BENCH = harness.load_json(harness.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def ctx(**kw):
    base = dict(queries=10, window_s=2.0, setup_s=33.0,
                latencies=[0.01 * i for i in range(1, 101)],
                peak_bytes=3 * 2**30, stage_times={"prefilter": 0.5,
                                                   "host_loop": 1.0,
                                                   "gates_drain": 0.1},
                stage_counts={}, spans={"search": 1.5, "format": 0.2},
                trace=None, db_residues=1000, db_entries=10,
                log=lambda m: None)
    base.update(kw)
    return base


def test_cells_and_bounds_from_shapes():
    assert R.cells_all_targets([100, 200], 1000) == 300_000
    cells = 10**12
    s, kind = R.bound_seconds(cells, 0.75, 10**9)
    assert kind == "operations"
    assert s == pytest.approx(cells * 0.75 / (132 * 64 * 1.98e9))
    s, kind = R.bound_seconds(10, 0.75, 3.35e12)
    assert kind == "bytes" and s == pytest.approx(1.0)
    assert R.gapless_bytes([10, 20], 1000, 50) == 1000 + 30 * 128 + 2 * 50 * 4
    assert R.sw_all_bytes([10], 1000, 50) == 1000 + 10 * 128 + 3 * 50 * 4


def test_union_and_kernel_time_of_an_event_list():
    ev = [(0, 100, "gapless_kernel"), (50, 150, "Memcpy DtoH"),
          (300, 400, "sw_kernel"), (350, 380, "elementwise")]
    assert R.union_seconds(ev) == pytest.approx(250e-9)
    assert R.kernel_seconds(ev) == pytest.approx(230e-9)


def test_readers_on_a_hand_made_run():
    read = {m: harness.metric_reader(m) for m in (
        "queries_per_s", "query_p95_s.single", "query_p50_s",
        "device_peak_gib", "setup_s", "prefilter_ms_per_query.single",
        "host_loop_ms_per_query.gpu", "gates_drain_ms_per_query.gpu",
        "format_ms_per_query.gpu", "device_idle.single",
        "gapless_roofline.single", "sw_roofline.gapped")}
    c = ctx()
    assert read["queries_per_s"](c) == 5.0
    assert read["query_p95_s.single"](c) == statistics.quantiles(
        c["latencies"], n=20)[-1]
    assert read["query_p50_s"](c) == pytest.approx(0.505)
    assert read["device_peak_gib"](c) == 3.0
    assert read["setup_s"](c) == 33.0
    assert read["prefilter_ms_per_query.single"](c) == 50.0
    assert read["host_loop_ms_per_query.gpu"](c) == 100.0
    assert read["gates_drain_ms_per_query.gpu"](c) == 10.0
    assert read["format_ms_per_query.gpu"](c) == 20.0
    # no trace: the trace readers find nothing and say so
    assert read["device_idle.single"](c) is None
    assert read["gapless_roofline.single"](c) is None
    # a trace: 1 ms of kernels in a 4 ms wall, two queries of 100 residues
    # against 10^6 residues
    tr = dict(intervals=[(0, 600_000, "k1"), (1_000_000, 1_400_000, "k2")],
              wall_s=0.004, query_lengths=[100, 100])
    c = ctx(trace=tr, db_residues=10**6, db_entries=1000)
    assert read["device_idle.single"](c) == pytest.approx(75.0)
    bound, _ = R.bound_seconds(2 * 10**8, 0.75,
                               R.gapless_bytes([100, 100], 10**6, 1000))
    assert read["gapless_roofline.single"](c) == pytest.approx(
        100 * bound / 0.001)
    assert read["sw_roofline.gapped"](c) > read["gapless_roofline.single"](c)


def test_few_latencies_give_no_tail():
    read = harness.metric_reader("query_p95_s.single")
    assert read(ctx(latencies=[0.1] * 5)) is None


def test_benchmark_files_agree():
    names = [c["name"] for c in BENCH["configs"]] + [
        w["name"] for w in BENCH["workloads"]] + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        cfg = harness.load_json(harness.ROOT, c["file"])
        assert cfg["source"] == c["source"] and len(c["source"]) <= 200
        assert cfg["reduced"] == c["reduced"]
        for mod in ("drivers/" + cfg["driver"], "checks/" + cfg["check"]):
            assert os.path.isfile(os.path.join(harness.HERE, mod + ".py"))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert os.path.isfile(os.path.join(harness.HERE, "metrics",
                                           m["name"] + ".py"))
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200
        assert os.path.isfile(os.path.join(harness.HERE, "traffic",
                                           w["traffic"] + ".json"))
        traffic = harness.load_json(harness.HERE, "traffic",
                                    w["traffic"] + ".json")
        assert os.path.isfile(os.path.join(harness.HERE, "loops",
                                           traffic["loop"] + ".py"))
        e2e = [m["name"] for m in harness.cell_metrics(BENCH, w["name"],
                                                       False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(BENCH, w["name"], True)
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert len(json.dumps(BENCH)) < 64 * 1024


class _Ev:
    def __init__(self, s, e, name, cuda):
        self.s, self.e, self.n, self.c = s, e, name, cuda

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.e - self.s

    def name(self):
        return self.n

    def device_type(self):
        import torch
        return (torch.autograd.DeviceType.CUDA if self.c
                else torch.autograd.DeviceType.CPU)


def test_read_trace_on_a_hand_made_profile():
    from types import SimpleNamespace
    events = [
        _Ev(0, 1000, "bench.search", False),       # the harness's span
        _Ev(0, 1000, "bench.search", True),        # mirrored on the device
        _Ev(100, 200, "aten::topk", False),
        _Ev(150, 300, "gapless_kernel", True),
        _Ev(400, 600, "aten::nonzero", False),
        _Ev(700, 800, "Memcpy DtoH", True),
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    tr = harness.read_trace(prof, 1e-6)
    assert sorted(n for _s, _e, n in tr["intervals"]) == [
        "Memcpy DtoH", "gapless_kernel"]
    assert R.union_seconds(tr["intervals"]) == pytest.approx(250e-9)
    gaps = dict(tr["breakdown"]["idle_gaps"])
    # 0-150 under bench.search (topk ends at 200 but its middle 75 is
    # before it starts), 300-700 in nonzero's time, 800-1000 in the span
    assert gaps == pytest.approx({"bench.search": 350e-9,
                                  "aten::nonzero": 400e-9})
    assert dict(tr["breakdown"]["device_ops"])["gapless_kernel"] == \
        pytest.approx(150e-9)
