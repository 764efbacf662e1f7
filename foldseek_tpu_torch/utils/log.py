"""Logging, timed spans and the stage registry. The reference has 4 debug
levels and per-command wall time reporting (reference:
lib/mmseqs/src/commons/Debug.h:46-49, Application.cpp:44-49); we map those
onto the stdlib logger, and every stage timer is a `span`."""
from __future__ import annotations

import logging
import sys
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

logger = logging.getLogger("foldseek_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("[%(levelname).1s %(asctime)s] %(message)s", "%H:%M:%S"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)

VERBOSITY_TO_LEVEL = {0: logging.CRITICAL, 1: logging.ERROR, 2: logging.WARNING, 3: logging.INFO}


def set_verbosity(v: int):
    logger.setLevel(VERBOSITY_TO_LEVEL.get(int(v), logging.INFO))


# Per-process stage-time registry: every span adds the seconds it timed
# under its key, so that a caller (the benchmark, chip_smoke.py, the profile
# verbs) can attribute where a run's time went post hoc — the reference
# prints per-module "Time for ..." lines the same way
# (lib/mmseqs/src/commons/Application.cpp:44-49); this keeps them
# machine-readable. reset_stage_times() starts a fresh attribution window.
STAGE_TIMES: dict = {}
# Beside it, what each stage worked on: record_count() appends one number a
# call under its label (the pairs an `align_all` call scored, the entries of
# each device panel set made), in call order; add_count() adds to the
# window's one number under its label (kernel launches, gate fleets).
STAGE_COUNTS: dict = {}
_stage_lock = threading.Lock()


class _ThreadState(threading.local):
    """`pool`: None outside a map_queries task; inside one, whether a
    profiler of every thread may be recording it."""
    pool = None


_tls = _ThreadState()


def _stage_key(label: str) -> str:
    """"structurealign(iter 2)" -> "structurealign", "ungapped+gapped
    prefilter" -> "ungapped+gapped_prefilter"."""
    return str(label).split("(")[0].strip().replace(" ", "_")


def _add_seconds(key: str, seconds: float):
    with _stage_lock:
        STAGE_TIMES[key] = STAGE_TIMES.get(key, 0.0) + float(seconds)


def _profiling() -> bool:
    """Whether a torch.profiler records this thread's ranges. While none
    runs this is one read of the Python-side flag. A profiler of one
    thread sets its C state on the thread that entered it alone; one of
    every thread (`profile_all_threads`) sets it on no thread yet records
    them all, so a thread that finds the flag up and its own state down
    records, unless it runs a pool task handed out by a thread that had its
    own state up (whose profiler records no worker)."""
    if not _autograd_profiler._is_profiler_enabled:
        return False
    return (torch._C._autograd._profiler_enabled()
            or _tls.pool is not False)


class span:
    """Time a stage: adds its wall seconds (perf_counter) to STAGE_TIMES
    under its key (`name` up to its first "(", spaces as "_") and, while a
    torch.profiler records this thread, opens the range "fs.<key>" in the
    profiler's timeline, nested under the spans open around it. Inside a
    map_queries task the key takes the suffix "_cpu" and the seconds are
    this thread's CPU seconds (time.thread_time): the pool's threads' wall
    seconds would count their wait for the interpreter lock as work."""

    def __init__(self, name: str):
        self._base = _stage_key(name)
        self.elapsed = 0.0

    def __enter__(self):
        self.key, self._clock = self._base, time.perf_counter
        if _tls.pool is not None:
            self.key, self._clock = self._base + "_cpu", time.thread_time
        self._range = None
        if self.key and _profiling():
            self._range = torch.profiler.record_function("fs." + self.key)
            self._range.__enter__()
        self._t0 = self._clock()
        return self

    def __exit__(self, *exc):
        self.elapsed = self._clock() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        if self.key:
            _add_seconds(self.key, self.elapsed)


class Timer(span):
    """A span that also logs the reference's "Time for <label>: <s>s"
    line."""

    def __init__(self, label: str = ""):
        super().__init__(label)
        self.label = label

    def __exit__(self, *exc):
        super().__exit__(*exc)
        if self.label:
            logger.info("Time for %s: %.3fs", self.label, self.elapsed)


def pool_task(fn):
    """fn as a map_queries task: the spans it opens count thread CPU
    seconds under "<key>_cpu", and open profiler ranges only where a
    profiler records the pool's threads (the handing thread's own profiler
    state is down: none runs, or one of every thread)."""
    all_threads = not torch._C._autograd._profiler_enabled()

    def task(item):
        outer = _tls.pool
        _tls.pool = all_threads
        try:
            return fn(item)
        finally:
            _tls.pool = outer
    return task


def record_count(label: str, n: int):
    with _stage_lock:
        STAGE_COUNTS.setdefault(label, []).append(int(n))


def add_count(label: str, n: int = 1):
    """Add n to the one number under `label` since the last reset."""
    with _stage_lock:
        counts = STAGE_COUNTS.setdefault(label, [0])
        counts[-1] += int(n)


def stage_count(label: str) -> int:
    """The sum of the numbers under `label` since the last reset."""
    with _stage_lock:
        return sum(STAGE_COUNTS.get(label, ()))


def reset_stage_times():
    with _stage_lock:
        STAGE_TIMES.clear()
        STAGE_COUNTS.clear()


def snapshot_stage_times() -> dict:
    with _stage_lock:
        return {k: round(v, 6) for k, v in STAGE_TIMES.items()}


def snapshot_stage_counts() -> dict:
    with _stage_lock:
        return {k: list(v) for k, v in STAGE_COUNTS.items()}
