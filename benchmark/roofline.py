"""The yardstick of the kernels: cells from shapes, the card's peaks, bound
times, and the device intervals of a torch.profiler trace.

Peaks of one NVIDIA H100 SXM (data sheet): 132 SMs of 64 INT32 lanes at
1.98 GHz, 3.35 TB/s of HBM. The integer instructions a DP cell needs at
least on that card: the packed 16-bit ungapped scan 0.75 (two cells an
instruction pair: viaddmin_relu and half a vimax3), the 3Di-only
Smith-Waterman 5.5 (viaddmax_relu, two viaddmax, a max and half a vimax3);
taken from the kernel sources' own accounting. A bound is the larger of
operations over the integer peak and bytes (inputs read once, outputs
written once) over the HBM peak; the share of it a measured time reaches can
only be understated when the time holds more than the DP.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

SMS = 132
INT32_LANES = 64
CLOCK_HZ = 1.98e9
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = SMS * INT32_LANES * CLOCK_HZ
GAPLESS_OPS_PER_CELL = 0.75
SW_NO_AA_OPS_PER_CELL = 5.5
PROFILE_LANES = 32          # int32 lanes of a query row of either kernel


def cells_all_targets(query_lengths: Iterable[int], db_residues: int) -> int:
    """DP cells of queries against every residue of a DB, no padding."""
    return int(sum(int(x) for x in query_lengths)) * int(db_residues)


def gapless_bytes(query_lengths: Sequence[int], db_residues: int,
                  n_targets: int) -> int:
    """The DB's 3Di letters, each query's profile, one int32 score a pair."""
    q = len(query_lengths)
    return (int(db_residues) + sum(query_lengths) * PROFILE_LANES * 4
            + q * int(n_targets) * 4)


def sw_all_bytes(query_lengths: Sequence[int], db_residues: int,
                 n_targets: int) -> int:
    """The DB's 3Di letters, each query's profile, score and two end
    positions (int32) a pair."""
    q = len(query_lengths)
    return (int(db_residues) + sum(query_lengths) * PROFILE_LANES * 4
            + 3 * q * int(n_targets) * 4)


def bound_seconds(cells: int, ops_per_cell: float,
                  nbytes: int) -> Tuple[float, str]:
    """(least seconds, 'operations' or 'bytes', whichever binds)."""
    ops = cells * ops_per_cell / INT_OPS_PER_S
    mem = nbytes / HBM_BYTES_PER_S
    return (ops, "operations") if ops >= mem else (mem, "bytes")


def is_copy(name: str) -> bool:
    low = name.lower()
    return "memcpy" in low or "memset" in low


def kernel_seconds(intervals: List[Tuple[int, int, str]]) -> float:
    """Summed duration of every kernel (not copies or fills)."""
    return sum(e - s for s, e, n in intervals if not is_copy(n)) / 1e9


def union_seconds(intervals: List[Tuple[int, int, str]]) -> float:
    """Length of the union of the intervals (ns), in seconds."""
    total, end = 0, None
    for s, e, _n in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e9


def roofline_percent(bound_s: float, device_s: float) -> Optional[float]:
    return None if device_s <= 0 else 100.0 * bound_s / device_s


def idle_percent(trace) -> Optional[float]:
    """Share of a trace's wall with nothing on the device, in %."""
    if not trace or not trace["intervals"]:
        return None
    return 100.0 * (1.0 - union_seconds(trace["intervals"]) / trace["wall_s"])
