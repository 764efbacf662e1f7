"""The seeded DB generator: determinism, the sizes its configuration states,
and queries apart from the DB."""
import json
import os

import numpy as np
import pytest

from benchmark.gen import families as F
from benchmark.drivers.search import QUERY_KEY_BASE

CFG = json.load(open(os.path.join(os.path.dirname(__file__), "..", "configs",
                                  "sprot_gpu.json")))["db"]


def small(entries=20000, **kw):
    cfg = dict(CFG, entries=entries)
    cfg.update(kw)
    return cfg


@pytest.fixture(scope="module")
def gen():
    return F.make_db(small(), 2**31 + 77)


def test_same_seed_same_bytes(gen):
    again = F.make_db(small(), 2**31 + 77, threads=3)
    for a in ("aa", "ss", "ca", "offsets", "family"):
        assert np.array_equal(getattr(gen.db, a), getattr(again.db, a))


def test_other_seed_other_bytes(gen):
    other = F.make_db(small(), 2**31 + 78)
    n = min(len(other.db.aa), len(gen.db.aa))
    assert not np.array_equal(other.db.aa[:n], gen.db.aa[:n])
    assert not np.array_equal(other.db.offsets, gen.db.offsets)


def test_every_seed_is_the_same_amount_of_work(gen):
    other = F.make_db(small(), 4)
    assert sorted(other.sizes) == sorted(gen.sizes)
    assert sorted(other.ancestors.lengths) == sorted(gen.ancestors.lengths)
    assert abs(other.db.offsets[-1] / gen.db.offsets[-1] - 1) < 0.01


def test_sizes_as_stated(gen):
    db = gen.db
    assert db.size == 20000 and gen.sizes.sum() == 20000
    lens = db.lengths
    assert lens.max() <= CFG["length_max"] and lens.min() >= CFG["length_min"]
    # family sizes: a power law of exponent 2 puts about 6/pi^2 of the
    # families at size 1 and a tail of a few percent at 20 or more
    share1 = np.mean(gen.sizes == 1)
    assert 0.55 < share1 < 0.66
    assert 0.02 < np.mean(gen.sizes >= 20) < 0.06
    assert gen.sizes.max() <= CFG["family_size_max"]


def test_length_mean_as_stated():
    # a larger DB: the mean is over many families
    g = F.make_db(small(entries=150000), 5)
    assert abs(g.db.lengths.mean() / CFG["length_mean"] - 1) < 0.05


def test_members_resemble_their_family(gen):
    db, fam = gen.db, gen.db.family
    i = int(np.flatnonzero(np.bincount(fam) >= 2)[0])
    a, b = np.flatnonzero(fam == i)[:2]
    ca = db.ca[db.offsets[a]:db.offsets[a + 1]]
    steps = np.linalg.norm(np.diff(ca, axis=0), axis=1)
    assert 2.0 < np.median(steps) < 5.0


def test_queries_apart_from_the_db(gen):
    q = F.make_queries(gen, small(), 256, 2**31 + 77)
    assert q.size == 256
    # no query is a copy of an entry
    db_seqs = {gen.db.aa[gen.db.offsets[i]:gen.db.offsets[i + 1]].tobytes()
               for i in range(gen.db.size)}
    assert not any(q.aa[q.offsets[i]:q.offsets[i + 1]].tobytes() in db_seqs
                   for i in range(q.size))
    # and no query key is a DB key
    assert QUERY_KEY_BASE > gen.db.size
    # a query stream apart from the DB's: another seed's DB is unchanged by
    # drawing queries
    again = F.make_queries(gen, small(), 256, 2**31 + 77)
    assert np.array_equal(again.aa, q.aa)


def test_query_lengths_do_not_depend_on_the_seed(gen):
    a = F.make_queries(gen, small(), 320, 9)
    b = F.make_queries(F.make_db(small(), 10), small(), 320, 10)
    want = F.query_lengths(small(), 320)
    for q in (a, b):
        # the crop gives the length; indels move it by a few residues
        assert np.all(np.abs(q.lengths - want) <= 0.15 * want + 6)
    # every 16 consecutive queries hold one of each length stratum
    whole = np.sort(want)
    lo, hi = whole[0::20], whole[19::20]
    for r in range(0, 320, 16):
        block = np.sort(want[r:r + 16])
        assert np.all((lo <= block) & (block <= hi))


def test_query_families_are_drawn_by_size_and_fixed(gen):
    a = F.make_queries(gen, small(), 512, 9)
    other = F.make_db(small(), 10)
    b = F.make_queries(other, small(), 512, 10)
    size_a, size_b = gen.sizes[a.family], other.sizes[b.family]
    # the same homologue counts and ancestor lengths query by query, for
    # every seed; the letters differ
    assert np.array_equal(size_a, size_b)
    assert np.array_equal(gen.ancestors.lengths[a.family],
                          other.ancestors.lengths[b.family])
    n = min(len(a.aa), len(b.aa))
    assert not np.array_equal(a.aa[:n], b.aa[:n])
    # a random DB entry's family: mean size sum(s^2) / sum(s), far above
    # the mean family's
    s = gen.sizes.astype(np.float64)
    biased = (s * s).sum() / s.sum()
    assert 0.6 * biased < size_a.mean() < 1.5 * biased
    assert np.median(size_a) > 3 * np.median(gen.sizes)


def _identity_to_ancestor(g, q, cfg, n):
    """Each query's AA identity to its ancestor's crop (no indels)."""
    want = F.query_lengths(cfg, n)
    la = g.ancestors.lengths[q.family]
    keep = np.minimum(1.0, want / la)
    lc, start, _sub, _jit = F.member_params(
        np.random.default_rng([F.STREAM_SIZES, F.STREAM_QUERY, 1]), la, cfg,
        keep)
    out = []
    for i in range(q.size):
        a0 = g.ancestors.offsets[q.family[i]] + start[i]
        mine = q.aa[q.offsets[i]:q.offsets[i + 1]]
        assert len(mine) == lc[i]
        out.append(np.mean(mine == g.ancestors.aa[a0:a0 + lc[i]]))
    return np.array(out)


def test_fixed_query_params_make_every_seed_diverge_alike(gen):
    cfg = small(indel_rate=0.0)
    a = F.make_queries(gen, cfg, 128, 9, fixed_params=True)
    other = F.make_db(small(), 10)
    b = F.make_queries(other, cfg, 128, 10, fixed_params=True)
    # the same crop of the same family, diverged by the same rate: query
    # i's identity to its ancestor agrees between the seeds to sampling
    # noise, over rates of 5-70 %
    ia = _identity_to_ancestor(gen, a, cfg, 128)
    ib = _identity_to_ancestor(other, b, cfg, 128)
    assert np.ptp(ia) > 0.3
    assert np.corrcoef(ia, ib)[0, 1] > 0.9
    assert np.median(np.abs(ia - ib)) < 0.04
    # the letters themselves are the seed's
    n = min(len(a.aa), len(b.aa))
    assert not np.array_equal(a.aa[:n], b.aa[:n])
    # without the option the draws are the seed's, as before
    c = F.make_queries(gen, cfg, 128, 9)
    assert not np.array_equal(c.aa, a.aa)


def test_pool_order_spreads_heavy_queries_over_every_prefix(gen):
    n, head = 512, 128
    q = F.make_queries(gen, small(), n, 9)
    order = F.pool_order(gen, q, small(), head)
    assert np.array_equal(np.sort(order), np.arange(n))
    assert np.array_equal(order[head:], np.arange(head, n))
    # the same order for every seed
    other = F.make_db(small(), 10)
    q2 = F.make_queries(other, small(), n, 10)
    assert np.array_equal(F.pool_order(other, q2, small(), head), order)
    # every prefix holds its share of the heaviest tenth, to within two
    want = F.query_lengths(small(), n)[:head].astype(np.float64)
    weight = gen.sizes[q.family[:head]] * want * want
    heavy = np.isin(order[:head], np.argsort(weight, kind="stable")[-13:])
    for k in range(16, head + 1):
        assert abs(heavy[:k].sum() - k * 13 / head) <= 2
    # no head: the pool as drawn
    assert np.array_equal(F.pool_order(gen, q, small(), 0), np.arange(n))
