"""Check of a mode-1 search (`--gpu 1`): hit sets, end positions, paths,
E-values, structure bits, order and m8 lines (`common.check_mode1`)."""
from __future__ import annotations

import numpy as np

from ..reference import expect
from .common import check_mode1

# hits a query whose structure bits are worked out again (numpy TM-score
# costs ~0.1 s a hit): the top one and the rest drawn from the seed
TM_HITS_PER_QUERY = 8
TM_STREAM = 5


def expected(q, db, tables, params, device, sat=None):
    return expect.mode1(q["aa"], q["ss"], db, tables, params, device, sat=sat)


def compare(sample, db, limits, seed):
    rng = np.random.default_rng([TM_STREAM, int(seed) % (1 << 64)])

    def tm_pick(idx):
        if len(idx) <= TM_HITS_PER_QUERY:
            return idx
        rest = rng.choice(idx[1:], TM_HITS_PER_QUERY - 1, replace=False)
        return [idx[0]] + sorted(int(x) for x in rest)

    return check_mode1(sample, db, limits, tm_pick)
