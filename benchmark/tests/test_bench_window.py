"""The window's mechanics on the CPU with a stand-in driver: the loop found
by name, the calls it makes, the host metrics read only after the profiler
has closed, and the check's sample."""
import time

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.loops import closed


class FakeDriver:
    def __init__(self, call_s=0.0):
        self.call_s = call_s
        self.resets = []          # calls made when the counters were reset
        self.n = 0

    def call_search(self, qdb):
        self.n += 1
        time.sleep(self.call_s)
        return {qdb: []}

    def call_format(self, qdb, res):
        return []

    def reset_counters(self):
        self.resets.append(self.n)


def window(n_trace, calls=6, qpc=4, call_s=0.0):
    batches = [np.arange(c * qpc, (c + 1) * qpc) for c in range(calls)]
    drv = FakeDriver(call_s)
    return harness.Window(drv, list(range(calls)), batches, n_trace,
                          torch.device("cpu")), drv


def test_closed_loop_calls_one_after_another_until_the_end():
    win, drv = window(0, call_s=0.01)
    closed.drive(win, {"clients": 1}, 0.1)
    win.close()
    assert 5 <= len(win.calls) == drv.n
    assert all(a["end"] <= b["start"] for a, b in zip(win.calls,
                                                      win.calls[1:]))
    # the pool's batches in turn, from the first
    assert list(win.calls[0]["idx"]) == [0, 1, 2, 3]
    assert win.attempted == 4 * len(win.calls) and win.failed == 0


def test_closed_loop_is_one_client():
    win, _drv = window(0)
    with pytest.raises(ValueError):
        closed.drive(win, {"clients": 2}, 0.1)


@pytest.mark.parametrize("n_trace", [0, 2])
def test_host_metrics_start_after_the_profiler(n_trace):
    win, drv = window(n_trace)
    for c in range(5):
        win.call(c)
    win.close()
    assert win.host_from == n_trace
    # the counters start afresh once the profiled calls are done, and only
    # then
    assert drv.resets == ([n_trace] if n_trace else [])
    assert (win.prof is not None) == bool(n_trace)
    assert win.trace_wall > 0 or not n_trace


def test_a_failed_call_is_counted():
    win, drv = window(0)

    def boom(qdb):
        raise RuntimeError("no")
    drv.call_search = boom
    win.call(0)
    assert win.failed == 4 and win.calls[0]["res"] is None


def test_sample_takes_both_ends_of_two_calls():
    calls = [np.arange(c * 8, (c + 1) * 8) for c in range(5)]
    lengths = np.arange(40) % 7 * 10 + 50
    lengths[13] = 999
    traffic = dict(check_queries=3, check_longest=True)
    pick = harness.pick_sample(calls, traffic, 2**31 + 9, lengths)
    assert pick == harness.pick_sample(calls, traffic, 2**31 + 9, lengths)
    ends = [c for c in calls if c[0] in pick and c[-1] in pick]
    assert len(ends) >= 2
    assert 13 in pick and len(pick) == 2 * 2 + 3 + 1
    assert len(set(pick)) == len(pick)
    # other seeds take other calls
    picks = {tuple(harness.pick_sample(calls, traffic, s, lengths))
             for s in range(8)}
    assert len(picks) > 1


def test_sample_of_one_query_calls():
    calls = [np.array([i]) for i in range(10)]
    pick = harness.pick_sample(calls, dict(check_queries=2), 5,
                               np.full(10, 100))
    assert len(pick) == 4 and len(set(pick)) == 4


def test_a_traced_window_ends_with_an_unprofiled_call():
    # the profiled calls take the whole window: one call follows them all
    # the same
    win, drv = window(2, call_s=0.05)
    closed.drive(win, {"clients": 1}, 0.07)
    win.close()
    assert len(win.calls) == 3 and win.host_from == 2
