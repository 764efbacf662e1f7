"""Logging + timers. The reference has 4 debug levels and per-command wall
time reporting (reference: lib/mmseqs/src/commons/Debug.h:46-49,
Application.cpp:44-49); we map those onto the stdlib logger."""
from __future__ import annotations

import logging
import sys
import threading
import time

logger = logging.getLogger("foldseek_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("[%(levelname).1s %(asctime)s] %(message)s", "%H:%M:%S"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)

VERBOSITY_TO_LEVEL = {0: logging.CRITICAL, 1: logging.ERROR, 2: logging.WARNING, 3: logging.INFO}


def set_verbosity(v: int):
    logger.setLevel(VERBOSITY_TO_LEVEL.get(int(v), logging.INFO))


class Timer:
    def __init__(self, label: str = ""):
        self.label = label

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        if self.label:
            logger.info("Time for %s: %.3fs", self.label, self.elapsed)
        record_stage(self.label, self.elapsed)


# Per-process stage-time registry: every Timer and record_stage() call
# accumulates wall seconds under its label so a caller (bench.py, the
# profile verbs) can attribute where a run's time went post hoc — the
# reference prints per-module "Time for ..." lines the same way
# (lib/mmseqs/src/commons/Application.cpp:44-49); this keeps them
# machine-readable. reset_stage_times() starts a fresh attribution window.
STAGE_TIMES: dict = {}
# Beside it, what each stage worked on: record_count() appends one number a
# call under its label (the pairs an `align_all` call scored, the entries of
# each device panel set made), in call order.
STAGE_COUNTS: dict = {}
_stage_lock = threading.Lock()


def record_stage(label: str, seconds: float):
    if not label:
        return
    key = str(label).split("(")[0].strip().replace(" ", "_")
    with _stage_lock:
        STAGE_TIMES[key] = STAGE_TIMES.get(key, 0.0) + float(seconds)


def record_count(label: str, n: int):
    with _stage_lock:
        STAGE_COUNTS.setdefault(label, []).append(int(n))


def reset_stage_times():
    with _stage_lock:
        STAGE_TIMES.clear()
        STAGE_COUNTS.clear()


def snapshot_stage_times() -> dict:
    with _stage_lock:
        return {k: round(v, 4) for k, v in STAGE_TIMES.items()}


def snapshot_stage_counts() -> dict:
    with _stage_lock:
        return {k: list(v) for k, v in STAGE_COUNTS.items()}


class StageTimer:
    """Accumulating substage timer: adds to STAGE_TIMES without logging."""

    def __init__(self, label: str):
        self.label = label

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        record_stage(self.label, time.perf_counter() - self.start)
