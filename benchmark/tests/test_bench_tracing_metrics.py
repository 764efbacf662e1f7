"""The readers of the program's spans and counters (utils/log.py in the
port) on hand-made inputs, the trace reader on the program's ranges, and a
small traced CPU run of each cell in which each of them reads a number."""
import pytest

from benchmark import harness
from benchmark.tests._tiny import BENCH, tiny

SEED = 4294967311
TIMES = {"prefilter": 0.5, "prefilter.launches": 0.2,
         "prefilter.readback": 0.1, "align.setup": 0.03,
         "format.setup": 0.02, "align.backtraces_cpu": 0.4,
         "align.hits_cpu": 0.2, "align.gates_cpu": 0.1,
         "align.query_cpu": 3.0, "host_loop": 1.25, "gates.dispatch": 0.25,
         "mode3.evalues": 0.3, "mode3.order": 0.2}
COUNTS = {"align_backtraces": [600, 400], "align_hits": [300, 200]}
# metric -> its value on TIMES and COUNTS over 10 queries, and a key or
# count whose absence leaves it without a number
WANT = {
    "prefilter_wait_ms_per_query": (30.0, "prefilter.readback"),
    "prefilter_host_ms_per_query": (20.0, "prefilter"),
    "call_setup_ms_per_query.single": (5.0, "format.setup"),
    "backtrace_cpu_us_per_hit": (400.0, "align_backtraces"),
    "hit_loop_cpu_us_per_hit": (400.0, "align_hits"),
    "host_gates_cpu_us_per_hit.single": (200.0, "align.gates_cpu"),
    "align_threads.gpu": (3.0, "align.query_cpu"),
    "gates_dispatch_ms_per_query.gpu": (25.0, "gates.dispatch"),
    "mode3_evalue_ms_per_query.gapped": (30.0, "mode3.evalues"),
    "mode3_order_ms_per_query.gapped": (20.0, "mode3.order"),
}


def ctx(times=TIMES, counts=COUNTS, queries=10):
    return dict(queries=queries, stage_times=dict(times),
                stage_counts={k: list(v) for k, v in counts.items()})


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_hand_made_run(name):
    read = harness.metric_reader(name)
    value, needed = WANT[name]
    assert read(ctx()) == pytest.approx(value)
    # the parent's program, or a cell that never runs the part: no number
    times = {k: v for k, v in TIMES.items() if k != needed}
    counts = {k: v for k, v in COUNTS.items() if k != needed}
    assert read(ctx(times, counts)) is None
    assert read(ctx({}, {})) is None
    if "per_query" in name:
        assert read(ctx(queries=0)) is None


def test_zero_counts_and_missing_dispatch():
    zero = {k: [0] for k in COUNTS}
    for name in ("backtrace_cpu_us_per_hit", "hit_loop_cpu_us_per_hit",
                 "host_gates_cpu_us_per_hit.single"):
        assert harness.metric_reader(name)(ctx(counts=zero)) is None
    # no gate fleets: the whole host loop is the pool's
    times = {k: v for k, v in TIMES.items() if k != "gates.dispatch"}
    assert harness.metric_reader("align_threads.gpu")(ctx(times)) == \
        pytest.approx(2.4)
    # the parts of the prefilter add up to the stage
    c = ctx()
    wait = harness.metric_reader("prefilter_wait_ms_per_query")(c)
    host = harness.metric_reader("prefilter_host_ms_per_query")(c)
    assert wait + host == pytest.approx(1e3 * TIMES["prefilter"] / 10)


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


def test_read_trace_labels_gaps_by_the_program_ranges():
    """The program's "fs." ranges mirrored onto the device's track are no
    device work, and an idle gap goes to the innermost range open at its
    middle."""
    from types import SimpleNamespace
    events = [
        _Ev(0, 1000, "bench.search", False),
        _Ev(0, 1000, "bench.search", True),
        _Ev(5, 500, "fs.prefilter", False),
        _Ev(5, 500, "fs.prefilter", True),
        _Ev(10, 100, "fs.prefilter.profiles", False),
        _Ev(100, 200, "gapless_kernel", True),
        _Ev(200, 500, "fs.prefilter.merge", False),
        _Ev(200, 500, "fs.prefilter.merge", True),
        _Ev(500, 1000, "fs.structurealign", False),
        _Ev(520, 940, "fs.host_loop", False),
        _Ev(950, 960, "sw_kernel", True),
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    tr = harness.read_trace(prof, 1e-6)
    assert sorted(n for _s, _e, n in tr["intervals"]) == [
        "gapless_kernel", "sw_kernel"]
    gaps = dict(tr["breakdown"]["idle_gaps"])
    assert gaps == pytest.approx({"fs.prefilter.profiles": 100e-9,
                                  "fs.host_loop": 750e-9,
                                  "fs.structurealign": 40e-9})


@pytest.mark.parametrize("workload,gates", [
    ("sprot_gpu.proteome", "1"), ("sprot_gpu.single", None),
    ("sprot_gpu_gapped.proteome", None)])
def test_every_new_metric_reads_in_a_traced_cell(workload, gates,
                                                 monkeypatch):
    """A small traced run of the cell on the CPU: each of the cell's
    metrics of the program's spans has a number (the gate fleets run on
    the CPU only when forced)."""
    if gates is None:
        monkeypatch.delenv("FOLDSEEK_TPU_DEVICE_GATES", raising=False)
    else:
        monkeypatch.setenv("FOLDSEEK_TPU_DEVICE_GATES", gates)
    cfg, traffic = tiny(workload, entries=150, check_all=False)
    out = harness.run_cell(BENCH, workload, SEED, 1.0, True, "cpu", 0.0,
                           cfg=cfg, traffic=traffic)
    assert out["correct"]
    names = {m["name"] for m in BENCH["per_layer"]
             if m["name"] in WANT and workload in m["workloads"]}
    assert names
    assert names <= set(out["metrics"]), names - set(out["metrics"])
    m = out["metrics"]
    if "prefilter_wait_ms_per_query" in names:
        assert m["prefilter_wait_ms_per_query"]["value"] > 0
    if "align_threads.gpu" in names:
        assert m["align_threads.gpu"]["value"] > 0
