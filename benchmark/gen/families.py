"""Seeded structure DB of many folds, in memory (numpy only).

A DB is a set of families. Each family has an ancestor: AA and 3Di strings
drawn from first-order Markov chains over the bigram statistics of the frozen
letters in `letters.json`, and a C-alpha trace drawn as a walk of 3.8 A
steps whose successive steps keep C-alpha virtual bond angles. Every entry is
a member of one family: a crop of its ancestor with AA substitutions, 3Di
substitutions at a fraction of that rate, indels of geometric length and
uniform jitter on the coordinates. Family sizes follow a discrete power law
(Qian, Luscombe & Gerstein, JMB 2001); sizes and ancestor lengths are the
same for every seed, in a seeded order. Queries are fresh members of families
drawn on a random stream apart from the DB's, so no query is an entry of
the DB. A query's family is drawn as a random DB entry's family is, in
proportion to its size, as a protein of a proteome falls in one; the
families drawn (so each query's number of true homologues) and the queries'
lengths are the same for every seed (`query_lengths`).

Everything is vectorised over residues or over families: the only Python
loops run over ancestor positions (at most the length cap).

Letters are numbered in foldseek's order, ALPHABET below; 3Di uses the same
20 letters. Nothing here imports the program under test.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict

import numpy as np

ALPHABET = "ACDEFGHIKLMNPQRSTVWYX"
N_LETTERS = 20                      # X is never drawn
LUT_BINS = 4096                     # resolution of the Markov lookup tables
STEP_A = 3.8                        # C-alpha to C-alpha distance
CHUNKS = 16                         # runs of families drawn in parallel
STREAM_DB, STREAM_QUERY, STREAM_WARM, STREAM_SIZES = 1, 2, 3, 5
_LETTERS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "letters.json")


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """Generator of one stream of a run's seed; any integer seed works."""
    return np.random.default_rng([stream, int(seed) % (1 << 64)])


def uniform01(rng, shape) -> np.ndarray:
    """float32 uniform in (0, 1) on a grid of 2**-16, from raw bytes: several
    times faster than `Generator.random` and fine for rates and angles."""
    n = int(np.prod(shape))
    u = np.frombuffer(rng.bytes(2 * n), dtype=np.uint16).astype(np.float32)
    u += np.float32(0.5)
    u *= np.float32(1.0 / 65536)
    return u.reshape(shape)


def symmetric01(rng, shape) -> np.ndarray:
    """float32 uniform in [-1, 1) on a grid of 2**-7, from raw bytes."""
    n = int(np.prod(shape))
    u = np.frombuffer(rng.bytes(n), dtype=np.int8).astype(np.float32)
    u *= np.float32(1.0 / 128)
    return u.reshape(shape)


@dataclass
class Residues:
    """Concatenated entries: numeric AA and 3Di letters, C-alpha, offsets."""
    aa: np.ndarray        # int8 [R]
    ss: np.ndarray        # int8 [R]
    ca: np.ndarray        # float32 [R, 3]
    offsets: np.ndarray   # int64 [n + 1]
    family: np.ndarray    # int64 [n]

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    @property
    def size(self) -> int:
        return len(self.offsets) - 1


class LetterModel:
    """Start distribution and bigram lookup tables of one alphabet."""

    def __init__(self, strings, pseudo: float):
        idx = {c: i for i, c in enumerate(ALPHABET[:N_LETTERS])}
        counts = np.full((N_LETTERS, N_LETTERS), pseudo)
        freq = np.full(N_LETTERS, pseudo)
        for s in strings:
            codes = [idx[c] for c in s.upper() if c in idx]
            for a in codes:
                freq[a] += 1
            for a, b in zip(codes, codes[1:]):
                counts[a, b] += 1
        trans = counts / counts.sum(axis=1, keepdims=True)
        u = (np.arange(LUT_BINS) + 0.5) / LUT_BINS
        self.lut = np.stack([np.searchsorted(np.cumsum(t), u).clip(
            0, N_LETTERS - 1) for t in trans]).astype(np.int8)
        # the letters' background frequencies: the chains' first letters,
        # substitutions and insertions
        self.start_lut = np.searchsorted(
            np.cumsum(freq / freq.sum()), u).clip(0, N_LETTERS - 1).astype(
                np.int8)

    def draw_background(self, rng, n: int) -> np.ndarray:
        u = np.frombuffer(rng.bytes(2 * n), dtype=np.uint16) % LUT_BINS
        return self.start_lut[u]


def letter_models():
    with open(_LETTERS) as f:
        entries = json.load(f)["entries"].values()
    return (LetterModel([e["aa"] for e in entries], pseudo=0.5),
            LetterModel([e["ss"] for e in entries], pseudo=0.1))


def family_sizes(rng, cfg: Dict) -> np.ndarray:
    """Family sizes from the power law, summing to cfg['entries']."""
    k = np.arange(1, cfg["family_size_max"] + 1, dtype=np.float64)
    p = k ** -float(cfg["family_size_exponent"])
    p /= p.sum()
    n_guess = int(cfg["entries"] / float((k * p).sum()) * 1.2) + 16
    sizes = rng.choice(k.astype(np.int64), size=n_guess, p=p)
    cs = np.cumsum(sizes)
    while cs[-1] < cfg["entries"]:
        more = rng.choice(k.astype(np.int64), size=n_guess, p=p)
        sizes = np.concatenate([sizes, more])
        cs = np.cumsum(sizes)
    n_fam = int(np.searchsorted(cs, cfg["entries"])) + 1
    sizes = sizes[:n_fam].copy()
    sizes[-1] -= cs[n_fam - 1] - cfg["entries"]
    return sizes


def ancestor_lengths(rng, cfg: Dict, n: int) -> np.ndarray:
    """Log-normal ancestor lengths: members keep a mean crop of
    (1 + crop_keep_min) / 2, so ancestors are that much longer on average
    than the entries' stated mean."""
    keep_mean = (1.0 + cfg["crop_keep_min"]) / 2.0
    mean = cfg["length_mean"] / keep_mean
    sigma = float(cfg["length_sigma"])
    mu = np.log(mean) - sigma * sigma / 2.0
    lens = np.rint(rng.lognormal(mu, sigma, n))
    return lens.clip(cfg["ancestor_length_min"],
                     cfg["length_max"]).astype(np.int64)


def make_ancestors(rng, lengths: np.ndarray, models) -> Residues:
    """Markov AA and 3Di strings and C-alpha walks of every family, one loop
    over positions with every family that is still that long in step."""
    aa_m, ss_m = models
    n = len(lengths)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    total = int(offsets[-1])
    aa = np.empty(total, dtype=np.int8)
    ss = np.empty(total, dtype=np.int8)
    ca = np.empty((total, 3), dtype=np.float32)
    order = np.argsort(-lengths, kind="stable")
    sorted_len = lengths[order]
    base = offsets[:-1][order]
    # bond angles of C-alpha traces lie between helix (~90 deg) and strand
    # (~125 deg); a few reach 150
    lo, hi = np.deg2rad(85.0), np.deg2rad(150.0)
    pos = np.zeros((n, 3), dtype=np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    prev_aa = prev_ss = None
    for p in range(int(sorted_len[0]) if n else 0):
        # families still longer than p: a prefix of the sorted order
        m = int(np.searchsorted(-sorted_len, -p, side="left"))
        u = (np.frombuffer(rng.bytes(4 * m), dtype=np.uint16)
             % LUT_BINS).reshape(2, m)
        if p == 0:
            cur_aa = aa_m.start_lut[u[0]]
            cur_ss = ss_m.start_lut[u[1]]
        else:
            cur_aa = aa_m.lut[prev_aa[:m], u[0]]
            cur_ss = ss_m.lut[prev_ss[:m], u[1]]
        at = base[:m] + p
        aa[at] = cur_aa
        ss[at] = cur_ss
        ca[at] = pos[:m]
        prev_aa, prev_ss = cur_aa, cur_ss
        # next step: turn the direction by the bond angle's supplement
        # towards a random perpendicular
        r = symmetric01(rng, (m, 3))
        r[:, 0] += np.float32(1.0 / 256)      # never the zero vector
        dm = d[:m]
        r -= (r * dm).sum(axis=1, keepdims=True) * dm
        r /= np.linalg.norm(r, axis=1, keepdims=True)
        turn = np.float32(np.pi - lo) - uniform01(rng, m) * np.float32(
            hi - lo)
        dm = np.cos(turn)[:, None] * dm + np.sin(turn)[:, None] * r
        dm /= np.linalg.norm(dm, axis=1, keepdims=True)
        d[:m] = dm
        pos[:m] += np.float32(STEP_A) * dm
    return Residues(aa=aa, ss=ss, ca=ca, offsets=offsets,
                    family=np.arange(n, dtype=np.int64))


def _exclusive_cumsum(x: np.ndarray) -> np.ndarray:
    out = np.zeros(len(x), dtype=np.int64)
    np.cumsum(x[:-1], out=out[1:])
    return out


def member_params(rng, la: np.ndarray, cfg: Dict, keep: np.ndarray = None):
    """(crop length, crop start, AA substitution rate, jitter) of members of
    ancestors of lengths `la`. `keep` fixes the crop fractions (the queries'
    stratified ones); by default they are uniform in [crop_keep_min, 1]."""
    n = len(la)
    if keep is None:
        keep = rng.uniform(cfg["crop_keep_min"], 1.0, n)
    lc = np.maximum(1, np.rint(keep * la)).astype(np.int64)
    start = (rng.random(n) * (la - lc + 1)).astype(np.int64)
    sub_aa = rng.uniform(cfg["aa_sub_min"], cfg["aa_sub_max"], n)
    jitter = rng.uniform(cfg["jitter_min"], cfg["jitter_max"], n)
    return lc, start, sub_aa, jitter


def make_members(rng, anc: Residues, fam: np.ndarray, cfg: Dict, models,
                 keep: np.ndarray = None, params=None) -> Residues:
    """One member of family fam[i] for every i, all at once: crop, indels,
    substitutions, coordinate jitter. `params` gives `member_params`' tuple
    drawn elsewhere; by default it is drawn from `rng` (with `keep`)."""
    aa_m, ss_m = models
    n = len(fam)
    lc, start, sub_aa, jitter = (
        params if params is not None
        else member_params(rng, anc.lengths[fam], cfg, keep))
    sub_ss = sub_aa * cfg["ss_sub_ratio"]

    tot = int(lc.sum())
    mstart = _exclusive_cumsum(lc)
    member = np.repeat(np.arange(n, dtype=np.int64), lc)
    src = np.arange(tot, dtype=np.int64)
    src += np.repeat(anc.offsets[fam] + start - mstart, lc)
    mend = mstart + lc                      # exclusive, per member

    # indels: events at `indel_rate` a residue, half deletions of the next
    # `len` residues of the member, half insertions of `len` new residues
    ev = np.flatnonzero(uniform01(rng, tot) < cfg["indel_rate"])
    glen = rng.geometric(1.0 / cfg["indel_mean"], len(ev)).astype(np.int64)
    is_del = rng.random(len(ev)) < 0.5
    kept = np.ones(tot, dtype=np.int64)
    dpos, dlen = ev[is_del], glen[is_del]
    if len(dpos):
        within = np.arange(int(dlen.sum()), dtype=np.int64)
        within -= np.repeat(_exclusive_cumsum(dlen), dlen)
        at = np.repeat(dpos, dlen) + within
        ok = at < np.repeat(mend[member[dpos]], dlen)
        kept[at[ok]] = 0
    ins = np.zeros(tot, dtype=np.int64)
    ins[ev[~is_del]] = glen[~is_del]
    counts = kept + ins
    # a member that indels would shrink below min_length keeps its crop
    mlen = np.add.reduceat(counts, mstart) if n else counts[:0]
    short = mlen < cfg["length_min"]
    if short.any():
        redo = short[member]
        counts[redo] = 1
        kept[redo] = 1
        ins[redo] = 0
    out_src = np.repeat(np.arange(tot, dtype=np.int64), counts)
    rank = np.arange(len(out_src), dtype=np.int64)
    rank -= np.repeat(_exclusive_cumsum(counts), counts)
    inserted = rank >= kept[out_src]
    out_member = member[out_src]
    # entries longer than the cap lose their tail
    mlen = np.bincount(out_member, minlength=n)
    out_start = _exclusive_cumsum(mlen)
    pos_in = np.arange(len(out_src), dtype=np.int64) - out_start[out_member]
    ok = pos_in < cfg["length_max"]
    if not ok.all():
        out_src, rank, inserted, out_member = (
            out_src[ok], rank[ok], inserted[ok], out_member[ok])
    mlen = np.bincount(out_member, minlength=n)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(mlen, out=offsets[1:])
    R = len(out_src)
    a_src = src[out_src]

    aa = anc.aa[a_src]
    ss = anc.ss[a_src]
    hit = np.flatnonzero(inserted | (uniform01(rng, R) < sub_aa.astype(
        np.float32)[out_member]))
    aa[hit] = aa_m.draw_background(rng, len(hit))
    hit = np.flatnonzero(inserted | (uniform01(rng, R) < sub_ss.astype(
        np.float32)[out_member]))
    ss[hit] = ss_m.draw_background(rng, len(hit))

    # jitter: uniform in a cube per coordinate, of RMS displacement `jitter`
    ca = anc.ca[a_src]
    noise = symmetric01(rng, (R, 3))
    noise *= jitter.astype(np.float32)[out_member][:, None]
    ca += noise
    ins_at = np.flatnonzero(inserted)
    if len(ins_at):
        # an inserted residue leaves its anchor by one step per rank
        step = rng.standard_normal((len(ins_at), 3)).astype(np.float32)
        step /= np.linalg.norm(step, axis=1, keepdims=True)
        ca[ins_at] += step * np.float32(STEP_A) * (
            rank[ins_at] + 1 - kept[out_src[ins_at]]).astype(
                np.float32)[:, None]
    return Residues(aa=aa, ss=ss, ca=ca, offsets=offsets,
                    family=fam.astype(np.int64))


@dataclass
class Generated:
    db: Residues
    ancestors: Residues
    sizes: np.ndarray     # members a family has in the DB
    order: np.ndarray     # family i is family order[i] of the fixed stream


def concat(parts) -> Residues:
    """Entries of `parts` one after the other."""
    lens = np.concatenate([p.lengths for p in parts])
    offsets = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    return Residues(aa=np.concatenate([p.aa for p in parts]),
                    ss=np.concatenate([p.ss for p in parts]),
                    ca=np.concatenate([p.ca for p in parts]),
                    offsets=offsets,
                    family=np.concatenate([p.family for p in parts]))


def make_db(cfg: Dict, seed: int, threads: int = 8) -> Generated:
    """The DB of one run: families, ancestors and every entry, from
    `seed`'s DB stream. The ancestors are drawn in one loop over positions;
    the entries in CHUNKS runs of families of about equal residue count,
    each on a stream of its own, in a pool of `threads` (numpy releases the
    interpreter lock in its array work), so the result depends on the seed
    alone. Entries of a family lie next to each other."""
    from concurrent.futures import ThreadPoolExecutor
    models = letter_models()
    # the families' sizes and ancestor lengths, paired, are the same for
    # every seed (one fixed stream): the seed orders them and draws the rest,
    # so that every seed's DB is the same amount of work
    fixed = np.random.default_rng([STREAM_SIZES])
    sizes = family_sizes(fixed, cfg)
    lengths = ancestor_lengths(fixed, cfg, len(sizes))
    rng = rng_for(seed, STREAM_DB)
    order = rng.permutation(len(sizes))
    sizes, lengths = sizes[order], lengths[order]
    anc = make_ancestors(rng, lengths, models)
    fam = np.repeat(np.arange(len(sizes), dtype=np.int64), sizes)
    weight = np.cumsum(anc.lengths[fam])
    cuts = np.searchsorted(weight, weight[-1] * np.arange(1, CHUNKS) / CHUNKS)
    bounds = np.concatenate([[0], cuts, [len(fam)]])

    def one(c):
        crng = np.random.default_rng([STREAM_DB, int(seed) % (1 << 64), c])
        return make_members(crng, anc, fam[bounds[c]:bounds[c + 1]], cfg,
                            models)

    with ThreadPoolExecutor(max_workers=max(1, threads)) as pool:
        parts = list(pool.map(one, range(CHUNKS)))
    return Generated(db=concat(parts), ancestors=anc, sizes=sizes,
                     order=order)


def query_lengths(cfg: Dict, n: int, strata: int = 16) -> np.ndarray:
    """The lengths of a pool of `n` queries, in pool order, the same for
    every seed: the quantiles (i + 0.5) / n of the configuration's log-normal
    entry lengths, clipped to its bounds, in an order in which every run of
    `strata` consecutive queries holds one query of each length stratum (a
    fixed interleaving), so that a window that ends anywhere sees the same
    sizes whatever the seed."""
    from statistics import NormalDist
    sigma = float(cfg["length_sigma"])
    mu = np.log(cfg["length_mean"]) - sigma * sigma / 2.0
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    lens = np.rint(np.exp(mu + sigma * z)).clip(
        cfg["length_min"], cfg["length_max"]).astype(np.int64)
    per = -(-n // strata)
    fixed = np.random.default_rng(0)
    order = []
    for r in range(per):
        pick = [s * per + r for s in range(strata)
                if s * per + r < min((s + 1) * per, n)]
        order.extend(fixed.permutation(np.asarray(pick, dtype=np.int64)))
    return lens[np.asarray(order, dtype=np.int64)]


def make_queries(gen: Generated, cfg: Dict, n: int, seed: int,
                 stream: int = STREAM_QUERY,
                 fixed_params: bool = False) -> Residues:
    """`n` fresh members of families, one for each of `query_lengths`:
    query i comes from a family drawn in proportion to its DB size (a random
    DB entry's family) among those whose ancestor can be cropped to its
    length (ancestor length between it and it over crop_keep_min; the
    longest families where none is), cropped to that length before its
    indels. The families are drawn on a fixed stream of their own, among the
    seed-independent (size, ancestor length) pairs, so every seed's queries
    have the same homologue counts; the seed's query stream draws the rest.
    With `fixed_params` each query's crop start, substitution rate and
    jitter come from a fixed stream too, so query i diverges from its
    family as far for every seed: the seed draws its letters, coordinates
    and indels."""
    fixed = np.random.default_rng([STREAM_SIZES, stream])
    want = query_lengths(cfg, n)
    inv = np.empty_like(gen.order)
    inv[gen.order] = np.arange(len(gen.order), dtype=gen.order.dtype)
    la = gen.ancestors.lengths[inv]          # the fixed stream's order
    size = gen.sizes[inv]
    by_len = np.argsort(la, kind="stable")
    sorted_la = la[by_len]
    weight = np.concatenate([[0], np.cumsum(size[by_len])])
    lo = np.searchsorted(sorted_la, want, side="left")
    hi = np.searchsorted(sorted_la, want / cfg["crop_keep_min"], side="right")
    lo = np.minimum(lo, len(la) - 1)
    hi = np.maximum(hi, lo + 1)
    u = weight[lo] + fixed.random(n) * (weight[hi] - weight[lo])
    at = np.searchsorted(weight, u, side="right") - 1
    fam = inv[by_len[np.clip(at, lo, hi - 1)]]
    keep = np.minimum(1.0, want / gen.ancestors.lengths[fam])
    params = (member_params(np.random.default_rng([STREAM_SIZES, stream, 1]),
                            gen.ancestors.lengths[fam], cfg, keep)
              if fixed_params else None)
    return make_members(rng_for(seed, stream), gen.ancestors, fam, cfg,
                        letter_models(), keep=keep, params=params)


def pool_order(gen: Generated, queries: Residues, cfg: Dict,
               head: int) -> np.ndarray:
    """The order in which a window takes the pool's queries: the first
    `head` laid out so that every prefix of them holds the same share of
    heavy queries, the rest as drawn. A query's weight is its family's DB
    size times its length squared (its hits times the cost of each
    backtrace), the same for every seed; the k-th query taken is the one
    whose rank by weight lies at frac(k x golden ratio) of the head, so a
    window that ends after any of them has seen its weights' quantiles
    evenly, and its tail does not hang on where it ends."""
    n = queries.size
    order = np.arange(n, dtype=np.int64)
    head = min(int(head), n)
    if head < 2:
        return order
    want = query_lengths(cfg, n)[:head].astype(np.float64)
    weight = gen.sizes[queries.family[:head]] * want * want
    by_weight = np.argsort(weight, kind="stable")
    golden = np.mod(np.arange(1, head + 1) * ((np.sqrt(5.0) - 1) / 2), 1.0)
    order[:head] = by_weight[np.argsort(np.argsort(golden, kind="stable"),
                                        kind="stable")]
    return order


def take(r: Residues, idx: np.ndarray) -> Residues:
    """Entries `idx` of `r`, in that order."""
    idx = np.asarray(idx, dtype=np.int64)
    lens = r.lengths[idx]
    offsets = np.zeros(len(idx) + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    at = np.arange(int(offsets[-1]), dtype=np.int64)
    at += np.repeat(r.offsets[idx] - offsets[:-1], lens)
    return Residues(aa=r.aa[at], ss=r.ss[at], ca=r.ca[at], offsets=offsets,
                    family=r.family[idx])
