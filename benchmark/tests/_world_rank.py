"""One rank of the worlds that test_bench_world.py starts through
`harness.launch`: the harness's rank path (`harness.run_rank`) at `_tiny`
sizes, on the CPU or on the rank's card, with the driver that `--mode`
names:

  clean  the program's driver; rank 0 writes its calls' m8 lines to --lines
  idle   a stand-in that never runs the program; rank 0's reads as a card
         that held memory, rank 1's as one that held none
  raise  the program's driver, which raises on rank 1 in its second call,
         the window's first

The CPU has no memory counter, so there each rank reads as a card of its
own (`stand_in_card`) that held memory once its driver had run a call; on a
card the harness's own reading stands.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark import harness  # noqa: E402
from benchmark.drivers.search import SearchDriver  # noqa: E402
from benchmark.tests._tiny import BENCH, tiny  # noqa: E402


class Recording(SearchDriver):
    """The program's driver, keeping every call's m8 lines in order (the
    warm call's first) and what they were made from, and counting the calls
    it put through the program."""
    calls = 0
    lines: list = []
    made: list = []

    def call_search(self, qdb):
        type(self).calls += 1
        return super().call_search(qdb)

    def call_format(self, qdb, res):
        out = super().call_format(qdb, res)
        type(self).lines.append(out)
        type(self).made.append((self, qdb, res))
        return out


class Idle(Recording):
    """Answers every query with nothing and never runs the program; only
    rank 0 counts its calls."""

    def call_search(self, qdb):
        if self.rank == 0:
            type(self).calls += 1
        return {}

    def call_format(self, qdb, res):
        return []


class Raising(Recording):
    def call_search(self, qdb):
        # the warm call is the first, the window's first the second
        if self.rank == 1 and type(self).calls == 1:
            raise RuntimeError("rank 1 fails in its second call")
        return super().call_search(qdb)


DRIVERS = {"clean": Recording, "idle": Idle, "raise": Raising}


def stand_in_card(rank: int, driver_cls):
    real = harness.read_card

    def read(dev):
        if dev.type == "cuda":
            return real(dev)
        return dict(platform="cpu", index=rank, name="cpu",
                    uuid=f"cpu-rank{rank}", peak_bytes=driver_cls.calls)
    return read


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=sorted(DRIVERS), required=True)
    ap.add_argument("--device", choices=("cpu", "cuda"), required=True)
    ap.add_argument("--lines")
    own, rest = ap.parse_known_args()
    args = harness.parse_args(rest)
    import torch
    torch.set_num_threads(1)
    driver_cls = DRIVERS[own.mode]
    harness.read_card = stand_in_card(args.rank, driver_cls)
    cfg, traffic = tiny(args.workload)
    device = "cpu" if own.device == "cpu" else f"cuda:{args.rank}"
    rc = harness.run_rank(args, BENCH, args.t0, device=device, cfg=cfg,
                          traffic=traffic, driver_cls=driver_cls)
    if rc == 0 and args.rank == 0 and own.lines:
        with open(own.lines, "w") as f:
            json.dump(driver_cls.lines, f)
    harness.exit_rank(rc)


if __name__ == "__main__":
    main()
