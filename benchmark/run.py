"""Run one benchmark cell once on this machine's card:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

prints set-up, the window and the check on standard error (the numbers
compared, each beside its limit, last) and one JSON line on standard output.
Exits non-zero without a result when the cell's cards are missing or fewer
of them held memory than the cell asks for. A cell of several cards starts
this script again once a card, as the world's ranks, and waits for them.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
