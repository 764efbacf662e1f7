"""Host-side thread parallelism over per-query work.

The reference wraps every per-query hot loop in `#pragma omp parallel for
schedule(dynamic, 1)` (structurealign.cpp:318, tmalign.cpp:219,
Prefiltering.cpp). The Python analogue: the heavy per-hit work here runs
in the native host library (ctypes calls release the GIL) or in numpy
(most ufuncs release it too), so a thread pool gives real multi-core
scaling without pickling. FOLDSEEK_TPU_THREADS caps the pool.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, List


_thread_cap = 0  # 0 = auto (all cores); set via --threads


def set_threads(n: int) -> None:
    """CLI `--threads N` (Parameters.cpp PARAM_THREADS). 0 restores auto."""
    global _thread_cap
    _thread_cap = max(0, int(n))


def n_host_threads(n_items: int) -> int:
    cap = _thread_cap or int(os.environ.get("FOLDSEEK_TPU_THREADS", "16"))
    return max(1, min(os.cpu_count() or 1, n_items, cap))


def map_queries(fn: Callable, items: Iterable) -> List:
    """Ordered map of fn over items, thread-parallel when it helps."""
    items = list(items)
    n = n_host_threads(len(items))
    if n <= 1:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(n) as ex:
        return list(ex.map(fn, items))
