"""One run of one benchmark cell: generate the cell's DB and queries from the
seed, warm the program up on the cell's own shapes, drive calls in a closed
loop for the window, check a sample of the answers against the reference,
and print one JSON line of metrics.

Everything a cell needs is found by name: the cell in BENCHMARK.json, its
configuration in `configs/<name>.json` (DB sizes, search settings, the
driver and the check it takes, the limits), its traffic in
`traffic/<name>.json`, the way its calls go out in `loops/<loop>.py`
(`drive(window, traffic, seconds)`), each metric in `metrics/<name>.py`
(`read(ctx)`), the driver in `drivers/<name>.py` and the check in
`checks/<name>.py`.

A traced run profiles the window's first `trace_calls` calls; the host
metrics (stage times, spans, latencies) read only the calls after the
profiler has closed, which it slows.

A cell of one card runs in this process on `cuda:0`. A cell of N > 1 cards
runs as N processes, rank r on `cuda:r` (`run_world` starts them, `run_rank`
is each): every rank forms the program's world through the driver's
`join_world`, generates the same inputs from the seed and makes every call
(the program's calls are collectives); rank 0 runs the loop and sends each
call's index to the others over the harness's own gloo group (`World`), and
its clock, calls and check give the result. The devices are measured on
every rank and counted by `device_report`.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import resource
import signal
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from datetime import timedelta
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "foldseek_tpu")
CHECK_STREAM = 4
SLOT_CALLS = 2           # calls whose first and last query the check takes
# seconds a collective of the program's group or of the harness's may wait
# for a peer: more than the longest call or trace reading of one rank, less
# than a run may last
RANK_TIMEOUT_S = 300
# seconds from the launcher's start by which every rank of a world has ended:
# within the first run's allowance, which builds the kernels
WORLD_DEADLINE_S = 1150
LOG_PREFIX = "[bench]"    # "[bench rN]" in rank N > 0 of a world


def log(msg: str) -> None:
    print(f"{LOG_PREFIX} {msg}", file=sys.stderr, flush=True)


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(bench: Dict, workload: str):
    """(cell, configuration, traffic) of a workload, by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(ROOT, conf["file"])
    traffic = load_json(HERE, "traffic", cell["traffic"] + ".json")
    return cell, cfg, traffic


def cell_metrics(bench: Dict, workload: str, trace: bool) -> List[Dict]:
    """The end-to-end metrics of a cell (trace 0) or its per-layer ones: a
    metric with `workloads` where it lists the cell, one without where the
    cell reports the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def metric_reader(name: str) -> Callable:
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}",
        os.path.join(HERE, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cache_env() -> None:
    """Build and kernel caches at fixed places inside the checkout: the
    program builds its kernels into its own `build/` there, and these catch
    any PyTorch extension or Triton cache it might use."""
    base = os.path.join(HERE, ".cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def card_facts() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def read_trace(prof, wall_s: float) -> Dict:
    """Device intervals (kernels, copies, fills) and host events of a
    torch.profiler trace, with the device's time by kernel name and the
    idle gaps by what the host was running then."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        iv = (s, s + e.duration_ns(), e.name())
        (dev if e.device_type() == cuda else host).append(iv)
    # a record_function range is mirrored onto the device's track under
    # its host name: that is no device work
    host_names = {n for _s, _e, n in host}
    dev = [iv for iv in dev if iv[2] not in host_names
           and not iv[2].startswith("bench.")]
    by_name: Dict[str, float] = {}
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e9
    busy = []
    for s, e, _n in sorted(dev):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    gaps = []
    if busy and host:
        t0 = min(h[0] for h in host)
        t1 = max(h[1] for h in host)
        edges = [t0] + [x for b in busy for x in b] + [t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
    # label each gap by the host event most recently started and still open
    # at its middle (one sweep over both, in time order)
    host_sorted = sorted(host)
    by_host: Dict[str, float] = {}
    open_, h = [], 0
    for s, e in gaps:
        mid = (s + e) // 2
        while h < len(host_sorted) and host_sorted[h][0] <= mid:
            open_.append(host_sorted[h])
            h += 1
        while open_ and open_[-1][1] < mid:
            open_.pop()
        label = open_[-1][2] if open_ else "host (no op)"
        by_host[label] = by_host.get(label, 0.0) + (e - s) / 1e9
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                                key=lambda kv: -kv[1])[:10]]
    return dict(intervals=dev, wall_s=wall_s,
                breakdown=dict(device_ops=top(by_name),
                               idle_gaps=top(by_host)))


def read_card(dev) -> Dict:
    """A rank's device as measured: the card's index, name and UUID and
    `max_memory_allocated` over set-up and window. The CPU has no such
    counter: it reads as one device that held nothing."""
    import torch
    if dev.type != "cuda":
        return dict(platform=dev.type, index=-1, name=dev.type,
                    uuid=dev.type, peak_bytes=0)
    return dict(platform="gpu", index=dev.index,
                name=torch.cuda.get_device_name(dev),
                uuid=str(torch.cuda.get_device_properties(dev).uuid),
                peak_bytes=int(torch.cuda.max_memory_allocated(dev)))


def device_report(per_rank: List[Dict]) -> Dict:
    """The run's `device` from every rank's report (`read_card`, with
    `rank` and, in a traced run, `busy_s` and `window_s`), rank 0 first.
    `count` is the cards that held memory, each once by UUID;
    `memory_peak_bytes` the fullest card's peak (ranks that share a card add
    up); `busy_s` the mean over the ranks and `window_s` rank 0's traced
    wall, so the idle share is the average card's; `devices` every report."""
    held: Dict[str, int] = {}
    for r in per_rank:
        held[r["uuid"]] = held.get(r["uuid"], 0) + r["peak_bytes"]
    first = per_rank[0]
    out = dict(platform=first["platform"], kind=first["name"],
               count=sum(1 for b in held.values() if b > 0),
               memory_peak_bytes=max(held.values()))
    if all("busy_s" in r for r in per_rank):
        out["busy_s"] = sum(r["busy_s"] for r in per_rank) / len(per_rank)
        out["window_s"] = first["window_s"]
    out["devices"] = per_rank
    return out


class World:
    """This rank's place in a cell of several cards, and the harness's own
    gloo group for its control traffic (each call's index, the ranks'
    reports), apart from the program's group."""
    STOP = -1

    def __init__(self, rank: int, size: int):
        import torch
        import torch.distributed as dist
        self.rank, self.size, self.dist = rank, size, dist
        self.group = dist.new_group(
            backend="gloo", timeout=timedelta(seconds=RANK_TIMEOUT_S))
        self.box = torch.zeros(1, dtype=torch.int64)

    def send(self, c: int) -> None:
        """Rank 0: the index of the call it makes next, or STOP."""
        self.box[0] = c
        self.dist.broadcast(self.box, 0, group=self.group)

    def recv(self) -> int:
        self.dist.broadcast(self.box, 0, group=self.group)
        return int(self.box[0])

    def barrier(self) -> None:
        self.dist.barrier(group=self.group)

    def gather(self, obj) -> List:
        out = [None] * self.size
        self.dist.all_gather_object(out, obj, group=self.group)
        return out


def follow(win: "Window", world: World) -> None:
    """A rank other than 0 in the window: the calls rank 0 makes, in its
    order, until it sends STOP."""
    c = world.recv()
    while c != World.STOP:
        win.call(c)
        c = world.recv()


class Window:
    """The measured window: one call of a batch of queries at a time
    through the driver, each recorded with its start (its arrival, where
    the loop gives one) and end. The first `n_trace` calls run under
    torch.profiler; once it has closed, the program's counters start
    afresh and `host_from` marks the first call the host metrics read.
    With `lead`, rank 0 of a world sends each call's index before making
    it; with `fatal`, a failed call raises (in a world its peers would wait
    for it in a collective)."""

    def __init__(self, driver, qdbs, batches, n_trace, dev, fault=None,
                 lead: Optional[World] = None, fatal: bool = False):
        self.driver, self.qdbs, self.batches = driver, qdbs, batches
        self.n_trace, self.dev, self.fault = n_trace, dev, fault
        self.lead, self.fatal = lead, fatal
        self.calls: List[Dict] = []
        self.attempted = self.failed = 0
        self.prof, self.traced, self.trace_wall = None, 0, 0.0
        self.host_from = 0
        self.start = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.start

    def running(self, seconds: float) -> bool:
        """Whether calls go on: until `seconds` have passed, and in a traced
        run until one call has run after the profiler closed (closing it
        takes seconds), so that the host metrics have a call to read."""
        return self.elapsed() < seconds or (
            0 < self.n_trace == self.traced
            and len(self.calls) == self.host_from)

    def _sync(self):
        if self.dev.type == "cuda":
            import torch
            torch.cuda.synchronize(self.dev)

    def call(self, c: int, arrival: Optional[float] = None) -> None:
        """Call `c`: pool batch c mod the pool's calls."""
        import torch
        if self.lead is not None:
            self.lead.send(c)
        n = len(self.batches)
        idx = self.batches[c % n]
        if self.traced < self.n_trace and self.prof is None:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self.dev.type == "cuda" else [])
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self.trace_start = time.perf_counter()
        self.attempted += len(idx)
        a = time.perf_counter()
        try:
            with torch.profiler.record_function("bench.search"):
                res = self.driver.call_search(self.qdbs[c % n])
            b = time.perf_counter()
            with torch.profiler.record_function("bench.format_results"):
                lines = self.driver.call_format(self.qdbs[c % n], res)
        except Exception as e:    # alone, a failed call is counted
            if self.fatal:
                raise
            log(f"call {c} failed: {e!r}")
            self.failed += len(idx)
            res, lines, b = None, None, time.perf_counter()
        z = time.perf_counter()
        if self.fault is not None and res is not None:
            res, lines = self.fault(res, lines)
        self.calls.append(dict(idx=idx, res=res, lines=lines,
                               start=a if arrival is None else arrival,
                               search_s=b - a, format_s=z - b, end=z))
        if self.prof is not None and self.traced < self.n_trace:
            self.traced += 1
            if self.traced == self.n_trace:
                self._sync()
                self.trace_wall = time.perf_counter() - self.trace_start
                self.prof.__exit__(None, None, None)
                self.driver.reset_counters()
                self.host_from = len(self.calls)

    def close(self):
        self._sync()
        if self.prof is not None and self.traced < self.n_trace:
            self.prof.__exit__(None, None, None)  # fewer calls than traced


def pick_sample(calls: List[np.ndarray], traffic: Dict, seed: int,
                lengths: np.ndarray) -> List[int]:
    """Pool indices of the queries the check works out again, from the
    seed: the first and the last query of SLOT_CALLS calls (the two ends
    of a call's query stack, in more than one call), `check_queries` more
    from all the calls' queries, and with `check_longest` the longest."""
    rng = np.random.default_rng([CHECK_STREAM, int(seed) % (1 << 64)])
    pick: List[int] = []

    def add(i):
        if int(i) not in pick:
            pick.append(int(i))
    if not calls:
        return pick
    for c in sorted(rng.choice(len(calls), min(SLOT_CALLS, len(calls)),
                               replace=False)):
        add(calls[c][0])
        add(calls[c][-1])
    seen = list(dict.fromkeys(int(i) for idx in calls for i in idx))
    rest = [i for i in seen if i not in pick]
    n_more = min(traffic["check_queries"], len(rest))
    for j in sorted(rng.choice(len(rest), n_more, replace=False)):
        add(rest[j])
    if traffic.get("check_longest"):
        add(max(seen, key=lambda i: lengths[i]))
    return pick


def run_cell(bench: Dict, workload: str, seed: int, seconds: float,
             trace: bool, device, t0: float, cfg: Optional[Dict] = None,
             traffic: Optional[Dict] = None,
             fault: Optional[Callable] = None,
             world: Optional[World] = None, need: int = 0,
             driver_cls: Optional[type] = None) -> Optional[Dict]:
    """One run. `cfg` / `traffic` replace the cell's files (the CPU tests'
    small sizes); `fault(res, lines)` breaks each call's answers (the
    tests that the check catches faults); `driver_cls` replaces the
    configuration's driver. In a `world`, every rank runs this and only
    rank 0 returns the result. Fewer than `need` cards holding memory ends
    the run before its check."""
    import torch
    from benchmark.gen import families as gen
    from benchmark.reference import dp
    cell, cfg0, traffic0 = load_cell(bench, workload)
    cfg, traffic = cfg or cfg0, traffic or traffic0
    loop = importlib.import_module(f"benchmark.loops.{traffic['loop']}")
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    t = time.perf_counter()
    g = gen.make_db(cfg["db"], seed)
    qpc = traffic["queries_per_call"]
    fixed = bool(traffic.get("fixed_query_params", False))
    queries = gen.make_queries(g, cfg["db"], traffic["pool"], seed,
                               fixed_params=fixed)
    warm = gen.make_queries(g, cfg["db"], qpc, seed, stream=gen.STREAM_WARM,
                            fixed_params=fixed)
    order = gen.pool_order(g, queries, cfg["db"],
                           traffic.get("spread_heavy", 0))
    db = g.db
    log(f"generate: {db.size} entries, {int(db.offsets[-1])} residues, "
        f"{len(g.sizes)} families, {traffic['pool']} queries: "
        f"{time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    if driver_cls is None:
        driver_cls = importlib.import_module(
            f"benchmark.drivers.{cfg['driver']}").SearchDriver
    rank, size = (world.rank, world.size) if world is not None else (0, 1)
    driver = driver_cls(cfg, db, dev, rank, size)
    n_calls = traffic["pool"] // qpc
    batches = [order[c * qpc:(c + 1) * qpc] for c in range(n_calls)]
    qdbs = [driver.batch(queries, b) for b in batches]
    log(f"program DBs: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    wres, wlines = driver.call(driver.batch(warm, np.arange(qpc)))
    if cuda:
        torch.cuda.synchronize(dev)
    host_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    dev_gib = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else 0.0
    log(f"warm call (residency, builds, {qpc} queries): "
        f"{time.perf_counter() - t:.3f} s, {len(wlines)} lines; host peak "
        f"{host_gib:.2f} GiB, device peak {dev_gib:.3f} GiB")
    del wres, wlines
    driver.reset_counters()

    n_trace = traffic["trace_calls"] if trace else 0
    if world is not None:
        world.barrier()           # every rank warm before the window opens
    setup_s = time.perf_counter() - t0
    win = Window(driver, qdbs, batches, n_trace, dev, fault,
                 lead=world if rank == 0 and world is not None else None,
                 fatal=world is not None)
    if rank == 0:
        loop.drive(win, traffic, seconds)
        if world is not None:
            world.send(World.STOP)
    else:
        follow(win, world)
    win.close()
    calls, start = win.calls, win.start
    stage_times, stage_counts = driver.counters()
    card = dict(rank=rank, **read_card(dev))
    ok_calls = [c for c in calls if c["res"] is not None]
    done = sum(len(c["idx"]) for c in ok_calls)
    window_s = (max(c["end"] for c in calls) - start) if calls else seconds
    # the calls the host metrics read: those after the profiler closed
    host_calls = [c for c in calls[win.host_from:] if c["res"] is not None]
    host_q = sum(len(c["idx"]) for c in host_calls)
    log(f"window: {len(calls)} calls, {done} queries, {window_s:.3f} s; "
        f"stages of the {len(calls) - win.host_from} calls after the "
        f"profiler {stage_times}")
    prof = win.prof
    if prof is not None and win.traced == n_trace:
        traced_q = sum(len(c["idx"]) for c in calls[:n_trace])
        per_q = win.trace_wall / max(traced_q, 1)
        free = (sum(c["end"] - c["start"] for c in host_calls)
                / max(host_q, 1))
        log(f"profiled calls: {win.trace_wall:.3f} s for {traced_q} queries "
            f"({per_q:.4f} s a query); unprofiled {free:.4f} s a query"
            + (f": profiling stretches the traced wall by "
               f"{100 * (per_q / free - 1):.1f} %" if host_q else ""))

    trace_data = None
    if prof is not None and win.traced == n_trace:
        t = time.perf_counter()
        trace_data = read_trace(prof, win.trace_wall)
        trace_data["query_lengths"] = [
            int(x) for c in calls[:n_trace] for x in queries.lengths[c["idx"]]]
        log(f"trace of {n_trace} calls read: {time.perf_counter() - t:.3f} s")
        from benchmark.roofline import union_seconds
        card.update(busy_s=union_seconds(trace_data["intervals"]),
                    window_s=trace_data["wall_s"])
    device_out = device_report(world.gather(card) if world is not None
                               else [card])
    if rank != 0:
        return None
    if device_out["count"] < need:
        raise SystemExit(
            f"the run used {device_out['count']} card(s) of the "
            f"{need} it was given: a rank's card that held no memory or a "
            f"card that two ranks shared; ranks: {device_out['devices']}")
    prof = win.prof = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the check: a sample of the window's answers against the reference
    t = time.perf_counter()
    check_mod = importlib.import_module(f"benchmark.checks.{cfg['check']}")
    where = {}
    for c in ok_calls:
        for i in c["idx"]:
            where.setdefault(int(i), c)
    pick = pick_sample([c["idx"] for c in ok_calls], traffic, seed,
                       queries.lengths)
    tables = dp.TargetTables(db.ss, db.offsets, dev)
    sample = []
    for i in pick:
        c = where[i]
        name = f"Q{i}"
        o0, o1 = queries.offsets[i], queries.offsets[i + 1]
        q = dict(name=name, key=i, aa=queries.aa[o0:o1], ss=queries.ss[o0:o1],
                 ca=queries.ca[o0:o1],
                 records=driver.records(c["res"], driver.query_key(i)),
                 lines=[x for x in c["lines"]
                        if x.split("\t", 1)[0] == name])
        q["expected"] = check_mod.expected(q, db, tables, cfg["search"], dev)
        sample.append(q)
    numbers = check_mod.compare(sample, db, cfg["limits"], seed)
    del tables
    from benchmark.checks.common import verdict
    correct, lines_out = verdict(numbers, cfg["limits"])
    correct &= win.failed == 0 and done > 0
    log(f"check of {len(sample)} queries ({', '.join(f'Q{i}' for i in pick)}"
        f"): {time.perf_counter() - t:.3f} s, info "
        f"{ {k: v for k, v in numbers.items() if k not in cfg['limits']} }")

    # `queries`, `latencies`, `spans` and the stage counters are those of
    # the host calls: every call of an untraced run
    ctx = dict(queries=host_q, window_s=window_s, setup_s=setup_s,
               latencies=[c["end"] - c["start"] for c in host_calls
                          for _ in c["idx"]],
               peak_bytes=device_out["memory_peak_bytes"],
               ranks=device_out["devices"], stage_times=stage_times,
               stage_counts=stage_counts,
               spans=dict(search=sum(c["search_s"] for c in host_calls),
                          format=sum(c["format_s"] for c in host_calls)),
               trace=trace_data, db_residues=int(db.offsets[-1]),
               db_entries=db.size, log=log)
    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        v = metric_reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
    out = dict(correct=bool(correct), attempted=win.attempted,
               failed=win.failed,
               metrics=metrics, device=device_out)
    if trace_data is not None:
        out["breakdown"] = trace_data["breakdown"]
    out["checks"] = {name: dict(value=numbers[name], limit=lim)
                     for name, lim in cfg["limits"].items()}
    out["_check_lines"] = lines_out
    return out


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def watch_launcher() -> None:
    """End this rank when the launcher that started it has gone (killed
    from outside, it could not end its ranks itself)."""
    ppid = os.getppid()

    def watch():
        while os.getppid() == ppid:
            time.sleep(1.0)
        os._exit(1)
    threading.Thread(target=watch, daemon=True).start()


def run_rank(args, bench: Dict, t0: float, device: Optional[str] = None,
             cfg: Optional[Dict] = None, traffic: Optional[Dict] = None,
             driver_cls: Optional[type] = None) -> int:
    """One rank of a world that `launch` started: rank r on `cuda:r` (or
    `device`), in the program's world and the harness's group, through the
    whole run. Rank 0 prints the result line, with its check's lines under
    `_check_lines` for the launcher; the others print nothing on stdout.
    Any failure ends the rank with a non-zero code: it is never carried on
    past, since its peers would wait for it. Returns the exit code."""
    global LOG_PREFIX
    import torch
    if args.rank:
        LOG_PREFIX = f"[bench r{args.rank}]"
    watch_launcher()
    try:
        _cell, cfg0, _traffic = load_cell(bench, args.workload)
        if driver_cls is None:
            driver_cls = importlib.import_module(
                f"benchmark.drivers.{(cfg or cfg0)['driver']}").SearchDriver
        dev = torch.device(device or f"cuda:{args.rank}")
        driver_cls.join_world(args.init_method, args.rank, args.world_size,
                              str(dev), RANK_TIMEOUT_S)
        world = World(args.rank, args.world_size)
        out = run_cell(bench, args.workload, args.seed, args.seconds,
                       bool(args.trace), dev, t0, cfg=cfg, traffic=traffic,
                       world=world, need=args.world_size,
                       driver_cls=driver_cls)
        bad = forbidden_modules()
        if bad:
            log(f"forbidden modules loaded: {bad}")
            return 3
        if out is not None:
            print(json.dumps(out), flush=True)
        return 0
    except SystemExit as e:     # too few cards, or an unknown cell
        log(str(e.code))
        return 1
    except Exception:       # the rank ends, and the launcher ends its peers
        log(f"failed:\n{traceback.format_exc()}")
        return 1


def exit_rank(rc: int) -> None:
    """Leave a rank's process at once: the program's communicators are not
    torn down one by one against peers that may have gone."""
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)


def launch(cmd: List[str], size: int, t0: float, deadline: float,
           env: Optional[Dict] = None) -> Tuple[List[int], Optional[Dict]]:
    """Start `size` ranks, each `cmd` with its rank's arguments, meeting in
    a file store in a temporary directory; wait for all of them. When one
    exits non-zero or `deadline` (a `perf_counter` time) passes, the others
    are killed. Returns the exit codes and rank 0's result, or None."""
    with tempfile.TemporaryDirectory(prefix="bench-world-") as tmp:
        out0 = os.path.join(tmp, "rank0.out")
        procs = []
        try:
            with open(out0, "w") as f0:
                for r in range(size):
                    procs.append(subprocess.Popen(
                        cmd + ["--rank", str(r), "--world-size", str(size),
                               "--init-method", f"file://{tmp}/store",
                               "--t0", repr(t0)],
                        stdin=subprocess.DEVNULL,
                        stdout=f0 if r == 0 else 2, cwd=ROOT, env=env))
            while True:
                rcs = [p.poll() for p in procs]
                bad = [(r, rc) for r, rc in enumerate(rcs) if rc]
                if bad:
                    log(f"rank {bad[0][0]} exited {bad[0][1]}: ending the "
                        "others")
                    break
                if all(rc == 0 for rc in rcs):
                    break
                if time.perf_counter() > deadline:
                    log(f"the ranks did not end within "
                        f"{deadline - t0:.0f} s: ending them")
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            rcs = [p.wait() for p in procs]
        if any(rcs):
            return rcs, None
        with open(out0) as f:
            lines = f.read().splitlines()
        return rcs, (json.loads(lines[-1]) if lines else None)


def run_world(argv: List[str], size: int, t0: float) -> int:
    """A cell of `size` cards: one rank a card (`run_rank`, started by
    `launch` as this script again with the rank's arguments); this process
    prints rank 0's result, and its check's lines last on stderr, once
    every rank has exited 0."""
    def ended(signum, _frame):
        raise SystemExit(128 + signum)   # the `finally` of `launch` kills
    signal.signal(signal.SIGTERM, ended)
    cmd = [sys.executable, os.path.join(HERE, "run.py"), *argv]
    rcs, out = launch(cmd, size, t0, t0 + WORLD_DEADLINE_S)
    if out is None:
        log(f"no result: the ranks exited {rcs}")
        return 4
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {bad}")
        return 3
    for line in out.pop("_check_lines"):
        log(line)
    print(json.dumps(out), flush=True)
    return 0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0, choices=(0, 1))
    # a rank of a world: given by `launch`, never by a user
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world-size", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--init-method", help=argparse.SUPPRESS)
    ap.add_argument("--t0", type=float, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None, t0: Optional[float] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if args.t0 is not None:
        t0 = args.t0                # a rank: set-up counts from the launcher
    t0 = time.perf_counter() if t0 is None else t0
    bench = load_json(ROOT, "BENCHMARK.json")
    cell, _cfg, _traffic = load_cell(bench, args.workload)
    if importlib.util.find_spec("foldseek_tpu_torch") is None:
        log("the program (foldseek_tpu_torch) is not in this checkout")
        return 2
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        log(f"needs {cell['chips']} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    cache_env()
    if args.rank is not None:
        exit_rank(run_rank(args, bench, t0))
    log(f"card: {card_facts()}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    if cell["chips"] > 1:
        return run_world(argv, cell["chips"], t0)
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda:0", t0, need=cell["chips"])
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {bad}")
        return 3
    for line in out.pop("_check_lines"):
        log(line)
    print(json.dumps(out), flush=True)
    return 0
