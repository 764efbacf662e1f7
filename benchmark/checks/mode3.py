"""Check of a `--prefilter-mode 3` search: ordered hit lists with scores and
end positions, E-values and m8 lines (`common.check_mode3`)."""
from __future__ import annotations

from ..reference import expect
from .common import check_mode3


def expected(q, db, tables, params, device, sat=None):
    return expect.mode3(q["ss"], db, tables, params, sat=sat)


def compare(sample, db, limits, seed):
    return check_mode3(sample, db, limits)
