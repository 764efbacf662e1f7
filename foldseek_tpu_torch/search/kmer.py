"""k-mer double-diagonal prefilter (PREF_MODE_KMER, the reference's default
CPU path).

Faithful re-derivation of the MMseqs2 prefilter pipeline as used by foldseek
on 3Di sequences:
  * spaced k-mers (Sequence.h:24-27 seed patterns; k auto 6/7)
  * target index: masked (repeat runs > 6 -> X, Masker.cpp:83-115; lowercase
    -> X), spaced k-mers skipping X, self-score >= threshold on the 8-bit-
    factor seed matrix (IndexTable.h:133-156, Prefiltering.cpp:68)
  * query: composition bias on the seed matrix; per-window threshold
    kmerThr - round(bias sum); similar k-mer generation through cartesian
    products of score-sorted 3-mer lists (KmerGenerator.cpp:107-218,
    ExtendedSubstitutionMatrix.cpp:20-69)
  * double-diagonal candidate detection: a (target, diagonal mod 256) hit
    whose immediately preceding posting for the same target had the same
    diagonal byte (CacheFriendlyOperations.cpp:185-277), deduplicated
  * candidate rescoring: exact integer Kadane along the diagonal with the
    2-bit-factor matrix + bias/4 profile, capped at 255
    (UngappedAlignment.cpp:45-57, :388-421)
  * adaptive score threshold to cap hits at max-seqs, 255-saturation rescue
    via exact rescoring (QueryMatcher.cpp:130-214, :563-586)
  * k-mer score thresholds: k=7: 197.0 - 11.22*s (src/FoldseekBase.cpp:444),
    k=6: 163.2 - 8.917*s (Prefiltering.cpp:1066)

Host-side implementation (the reference's CPU-compat path), numpy and the
native library; the device prefilter is the gapless scan in ungapped.py.
Copy of `foldseek_tpu/search/kmer.py` with the imports rewritten.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np

from ..db.storage import StructDB
from ..ops.matrices import mat3di
from ..ops.sw import calc_comp_bias
from ..utils.log import logger
from .params import SearchParams

SPACED_PATTERNS = {
    6: np.array([1, 1, 0, 1, 0, 1, 0, 0, 1, 1], dtype=bool),
    7: np.array([1, 1, 0, 1, 0, 1, 1, 0, 0, 1, 1], dtype=bool),
}
X = 20
MIN_DIAG_SCORE = 30  # prefilter --min-ungapped-score default

# process-global sorted sub-kmer score lists, keyed by (matrix, sub-kmer)
# — see KmerPrefilter._sub_lists
_GLOBAL_SUB_CACHE: dict = {}

# memo of full similar-k-mer lists keyed by (matrix, window, threshold) —
# deterministic, so repeat searches (iterative search rounds, the same
# query set against several target DBs) skip the cartesian expansion.
# Bounded: oldest half evicted past the cap.
_GLOBAL_KMER_LIST_CACHE: dict = {}
# sized for the cluster cascade: 3 sensitivities x ~1M distinct windows
# thrashed the old 50k cap (477k misses of 2M lookups at 20k entries);
# entries average ~1 KB so the cap is ~400 MB worst case
_KMER_LIST_CACHE_CAP = 400_000
MASK_N_REPEATS = 6



# Util::rankedDescSort20's compare-exchange schedule (Util.cpp:88-113): a
# fixed sorting network with strict-< swaps, so the TIE order of equal
# scores is network-specific (not a stable sort) — the profile k-mer emit
# order, and with it double-diagonal arrival, depends on it.
_SORT20_NETWORK = [
    (0, 16), (1, 17), (2, 18), (3, 19), (4, 12), (5, 13), (6, 14), (7, 15),
    (0, 8), (1, 9), (2, 10), (3, 11),
    (8, 16), (9, 17), (10, 18), (11, 19), (0, 4), (1, 5), (2, 6), (3, 7),
    (8, 12), (9, 13), (10, 14), (11, 15), (4, 16), (5, 17), (6, 18),
    (7, 19), (0, 2), (1, 3),
    (4, 8), (5, 9), (6, 10), (7, 11), (12, 16), (13, 17), (14, 18),
    (15, 19), (0, 1),
    (4, 6), (5, 7), (8, 10), (9, 11), (12, 14), (13, 15), (16, 18),
    (17, 19),
    (2, 16), (3, 17), (6, 12), (7, 13), (18, 19),
    (2, 8), (3, 9), (10, 16), (11, 17),
    (2, 4), (3, 5), (6, 8), (7, 9), (10, 12), (11, 13), (14, 16), (15, 17),
    (2, 3), (4, 5), (6, 7), (8, 9), (10, 11), (12, 13), (14, 15), (16, 17),
    (1, 16), (3, 18), (5, 12), (7, 14),
    (1, 8), (3, 10), (9, 16), (11, 18),
    (1, 4), (3, 6), (5, 8), (7, 10), (9, 12), (11, 14), (13, 16), (15, 18),
    (1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14), (15, 16),
    (17, 18),
]


def _ranked_desc_sort20(vals: np.ndarray):
    """(scores desc, residue indices) with rankedDescSort20's exact tie
    order. vals: [20] ints."""
    v = np.asarray(vals[:20], dtype=np.int32).copy()
    ix = np.arange(20, dtype=np.int64)
    for a, b in _SORT20_NETWORK:
        if v[a] < v[b]:
            v[a], v[b] = v[b], v[a]
            ix[a], ix[b] = ix[b], ix[a]
    return v, ix


def _find_dups(arr_tid: np.ndarray, arr_d16: np.ndarray):
    """CacheFriendlyOperations::findDuplicates (computeTotalScore=false)
    over one hit-buffer chunk: double-diagonal detection per target id in
    arrival order (duplicateBitArray starts zeroed, so the first posting
    of an id on diagonal byte 0 already counts), then consecutive
    same-diagonal runs dedup'd keeping the run head
    (CacheFriendlyOperations.cpp:186-262). Returns (ids, d16) grouped per
    id with per-id arrival order preserved."""
    order = np.argsort(arr_tid, kind="stable")
    st = arr_tid[order]
    sd16 = arr_d16[order]
    sd8 = sd16 & 0xFF
    first = np.ones(len(st), dtype=bool)
    first[1:] = st[1:] != st[:-1]
    prev_d8 = np.empty_like(sd8)
    prev_d8[1:] = sd8[:-1]
    prev_d8[first] = 0
    dup = prev_d8 == sd8
    dt, dd16, dd8 = st[dup], sd16[dup], sd8[dup]
    dfirst = np.ones(len(dt), dtype=bool)
    dfirst[1:] = dt[1:] != dt[:-1]
    dprev = np.empty_like(dd8)
    dprev[1:] = dd8[:-1]
    keep = dfirst.copy()
    keep[~dfirst] = dprev[~dfirst] != dd8[~dfirst]
    return dt[keep], dd16[keep]


def _merge_plain(ids: np.ndarray, d16: np.ndarray, cnt: np.ndarray):
    """mergeElementsByDiagonal keepScoredHits=false
    (CacheFriendlyOperations.cpp::mergeDiagonalDuplicates): per id in
    arrival order keep the head of every consecutive same-diagonal-byte
    run (the stored byte is prefilled with the FIRST element's diag+1, so
    the head always differs). Input arrays are the concatenated
    [overflow | new-chunk] hits; per-id relative order is the arrival
    order (stable sort preserves it)."""
    order = np.argsort(ids, kind="stable")
    si, sd, sc = ids[order], d16[order], cnt[order]
    s8 = sd & 0xFF
    first = np.ones(len(si), dtype=bool)
    first[1:] = si[1:] != si[:-1]
    keep = first.copy()
    keep[~first] = s8[1:][~first[1:]] != s8[:-1][~first[1:]]
    return si[keep], sd[keep], sc[keep]


def _merge_keep_scored(ids: np.ndarray, d16: np.ndarray, cnt: np.ndarray):
    """mergeElementsByDiagonal keepScoredHits=true
    (mergeDiagonalKeepScoredHitsDuplicates): iterated per bin in REVERSE,
    keeping an element when it carries a score (count != 0) or its
    diagonal byte differs from the NEXT same-id element's; the per-id
    output order is therefore reversed arrival order."""
    order = np.argsort(ids, kind="stable")
    si, sd, sc = ids[order], d16[order], cnt[order]
    s8 = sd & 0xFF
    last = np.ones(len(si), dtype=bool)
    last[:-1] = si[1:] != si[:-1]
    keep = last | (sc != 0)
    nxt = np.zeros(len(si), dtype=bool)
    nxt[:-1] = s8[:-1] != s8[1:]
    keep[~last] |= nxt[~last]
    # reverse per-id order: sort kept rows by (id asc, position desc)
    pos = np.nonzero(keep)[0]
    rev = pos[np.lexsort((-pos, si[pos]))]
    return si[rev], sd[rev], sc[rev]


def _keep_max(ids: np.ndarray, d16: np.ndarray, cnt: np.ndarray):
    """keepMaxScoreElementOnly (CacheFriendlyOperations::keepMaxElement):
    per id in scan order, the FIRST element carrying the per-id max count
    is emitted and zeroes the marker byte — after which every LATER
    zero-count element of the same id compares equal to the zeroed marker
    and is emitted too (the `duplicateBitArray[h] * (1 - found)` update,
    CacheFriendlyOperations.cpp:368-377). All elements of an id share a
    bin, so per-id scan order is the input order."""
    n = len(ids)
    if n == 0:
        return ids, d16, cnt
    pos = np.arange(n, dtype=np.int64)
    order = np.lexsort((pos, ids))
    si, sc = ids[order], cnt[order]
    first = np.ones(n, dtype=bool)
    first[1:] = si[1:] != si[:-1]
    starts = np.nonzero(first)[0]
    seg = np.cumsum(first) - 1
    seg_max = np.maximum.reduceat(sc, starts)
    is_max = sc == seg_max[seg]
    idx = np.arange(n, dtype=np.int64)
    first_max = np.minimum.reduceat(np.where(is_max, idx, n), starts)
    p_star = first_max[seg]
    emit = (idx == p_star) | ((sc == 0) & (idx > p_star))
    mask = np.zeros(n, dtype=bool)
    mask[order[emit]] = True
    return ids[mask], d16[mask], cnt[mask]


def chunked_candidates(list_pos: np.ndarray, list_off: np.ndarray,
                       tids: np.ndarray, jpos: np.ndarray,
                       max_db_matches: int, score_fn):
    """QueryMatcher::match()'s hit-buffer flush semantics
    (QueryMatcher.cpp:250-365, diagonalScoring=true) + the matchQuery-side
    align/keepMax (QueryMatcher.cpp:129-181): posting lists arrive in
    (query-position, k-mer) order; when appending a list would overflow
    the raw-match buffer (maxDbMatches entries), the accumulated chunk is
    collapsed with findDuplicates and merged into the running overflow
    block — scoring + keep-max per id after the second flush — and a list
    larger than the whole buffer aborts matching with numMatches == 0
    (the reference then reports zero hits, dropping the overflow block).

    list_pos[i]: query position of posting list i; list_off: [n_lists+1]
    offsets into tids/jpos; score_fn(ids, d16) -> byte-capped diagonal
    scores (UngappedAlignment::align). Returns (ids, counts, d16), one
    row per surviving target.

    Deviation noted: findDuplicates' per-bin output-capacity truncation
    (CacheFriendlyOperations.cpp:210-212, output >= max(1e6, dbSize)
    CounterResults) is not modeled — it needs >1e6 *detected duplicate
    pairs* in one chunk, beyond any workload this path serves."""
    empty = (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64),
             np.zeros(0, dtype=np.int64))
    n_lists = len(list_pos)
    lens = np.diff(list_off)
    # assign each posting list to a chunk (sequential flush recurrence)
    chunk_of = np.zeros(n_lists, dtype=np.int64)
    cur = 0
    chunk = 0
    dropped = False
    for i in range(n_lists):
        n = int(lens[i])
        if cur + n >= max_db_matches:
            chunk += 1
            cur = 0
            if n >= max_db_matches:
                # goto outer with numMatches == 0: zero hits overall
                return empty
        chunk_of[i] = chunk
        cur += n
    if chunk > 0 and cur == 0:
        # overflow flush on the final list with nothing after it:
        # numMatches == 0 skips the output fill and the overflow block
        # is dropped (QueryMatcher.cpp:357 `if (numMatches > 0)`)
        return empty

    d16_all = (np.repeat(list_pos, lens) - jpos) & 0xFFFF
    bounds = np.searchsorted(np.repeat(chunk_of, lens),
                             np.arange(chunk + 2))
    ov = None  # (ids, d16, counts) — the merged overflow block
    for c in range(chunk + 1):
        lo, hi = bounds[c], bounds[c + 1]
        h_ids, h_d16 = _find_dups(tids[lo:hi], d16_all[lo:hi])
        if c < chunk:
            # flush: merge into the overflow block (QueryMatcher.cpp:320-335).
            # The reference guards the merge with `overflowHitCount != 0`
            # (:322): a previous flush that yielded ZERO duplicate hits
            # leaves the overflow block "unstarted", so the next flush
            # initializes instead of merging (merging would re-align and
            # keepMax-collapse the fresh hits, changing tie diagonals)
            if ov is None or len(ov[0]) == 0:
                ov = (h_ids, h_d16, np.zeros(len(h_ids), dtype=np.int64))
            else:
                m_ids = np.concatenate([ov[0], h_ids])
                m_d16 = np.concatenate([ov[1], h_d16])
                m_cnt = np.concatenate(
                    [ov[2], np.zeros(len(h_ids), dtype=np.int64)])
                m_ids, m_d16, _ = _merge_keep_scored(m_ids, m_d16, m_cnt)
                m_cnt = score_fn(m_ids, m_d16)
                k_ids, k_d16, k_cnt = _keep_max(m_ids, m_d16, m_cnt)
                ov = (k_ids, k_d16, k_cnt)
        else:
            if ov is not None:
                f_ids = np.concatenate([ov[0], h_ids])
                f_d16 = np.concatenate([ov[1], h_d16])
                f_cnt = np.concatenate(
                    [ov[2], np.zeros(len(h_ids), dtype=np.int64)])
                f_ids, f_d16, _ = _merge_plain(f_ids, f_d16, f_cnt)
            else:
                f_ids, f_d16 = h_ids, h_d16
            # matchQuery: align everything, then keep the per-id best
            f_cnt = score_fn(f_ids, f_d16)
            k_ids, k_d16, k_cnt = _keep_max(f_ids, f_d16, f_cnt)
            return k_ids, k_cnt, k_d16
    return empty


def kmer_threshold(k: int, sensitivity: float) -> int:
    """k=7 from foldseek's externalThreshold, k=6 from the mmseqs default."""
    if k == 7:
        return int(197.0 - 11.22 * sensitivity)
    if k == 6:
        return int(163.2 - 8.917 * sensitivity)
    if k == 5:
        return int(160.75 - 12.75 * sensitivity)
    raise ValueError(f"unsupported k-mer size {k}")


def kmer_threshold_profile(k: int, sensitivity: float,
                           context_pseudo_counts: bool = False) -> int:
    """Profile-query thresholds (Prefiltering::getKmerThreshold,
    Prefiltering.cpp:1035-1064). The branch keys on the profile DB's
    DBTYPE_EXTENDED_CONTEXT_PSEUDO_COUNTS flag, which result2profile only
    sets under --pseudo-cnt-mode 1 (PCMODE_CONTEXT_SPECIFIC,
    result2profile.cpp:116-118); the DEFAULT pcmode is substitution-score
    (Parameters.cpp:2551), so foldseek profile searches take the no-ctx
    constants — verified against the reference binary's own
    "k-mer similarity threshold" report (75 at k=6 s=9.5)."""
    if context_pseudo_counts:
        if k == 7:
            return int(158.75 - 9.75 * sensitivity)
        if k == 6:
            return int(132.75 - 8.75 * sensitivity)
        if k == 5:
            return int(97.75 - 8.75 * sensitivity)
    else:
        if k == 7:
            return int(149.15 - 6.85 * sensitivity)
        if k == 6:
            return int(134.35 - 6.15 * sensitivity)
        if k == 5:
            return int(108.8 - 4.7 * sensitivity)
    raise ValueError(f"unsupported k-mer size {k}")


def mask_repeats(seq: np.ndarray, n: int = MASK_N_REPEATS) -> np.ndarray:
    """Runs of one letter longer than n -> X (Masker::maskRepeats)."""
    out = seq.copy()
    L = len(seq)
    i = 0
    while i < L:
        j = i
        while j < L and seq[j] == seq[i]:
            j += 1
        if j - i > n:
            out[i:j] = X
        i = j
    return out


@functools.lru_cache(maxsize=4)
def _sorted_submer_lists(k_sub: int):
    """For every sub-kmer (base-20 little-endian index): candidates sorted by
    score desc, ties in lexicographic (first-letter-major) tuple order —
    matching ExtendedSubstitutionMatrix's stable sort over the cartesian
    product enumeration."""
    n = 20 ** k_sub
    # tuples in lexicographic order (a0 major)
    digits = np.stack(np.meshgrid(*[np.arange(20)] * k_sub, indexing="ij"),
                      axis=-1).reshape(n, k_sub)
    # little-endian index of each tuple
    pows = 20 ** np.arange(k_sub)
    tuple_index = digits @ pows  # [n]
    # score[i, j] between sub-kmers i (by tuple order) and j
    # computed lazily per query sub-kmer instead (memory)
    return digits, tuple_index


class KmerPrefilter:
    def __init__(self, tdb: StructDB, params: SearchParams, k: int = 0,
                 bias_scale: float = 1.0, min_diag_score: int = MIN_DIAG_SCORE,
                 entry_range=None, profile_mode: bool = False):
        """entry_range: optional (start, end) target-entry slice — the
        memory-based TARGET_DB_SPLIT analogue (Prefiltering.cpp:289-381
        setupSplit): the posting index covers only the range, and query()
        returns GLOBAL target indices. profile_mode: PSSM queries — the
        profile k-mer threshold formula applies and the target index
        admits every k-mer (Prefiltering.cpp:541 index threshold 0)."""
        self.tdb = tdb
        self.entry_range = ((0, tdb.size) if entry_range is None
                            else (int(entry_range[0]), int(entry_range[1])))
        self.bias_scale = bias_scale
        self.min_diag_score = min_diag_score
        self.profile_mode = bool(profile_mode)
        if k == 0:
            # IndexTable::computeKmerSize (IndexTable.h:439-441): k=6 below
            # 3.35e9 residues, k=7 above (the memory-short branch's
            # optimizeSplit retry is subsumed — this index has no dense
            # 21^k offset array, so k=7 fits wherever k=6 does)
            k = 6 if tdb.total_residues < 3_350_000_000 else 7
        self.k = k
        self.pattern = SPACED_PATTERNS[k]
        self.span = len(self.pattern)
        self.offsets = np.nonzero(self.pattern)[0]
        if self.profile_mode:
            self.kmer_thr = kmer_threshold_profile(k, params.sensitivity)
            self.index_thr = 0
        else:
            self.kmer_thr = kmer_threshold(k, params.sensitivity)
            self.index_thr = self.kmer_thr
        # prefilter matrices carry score bias -0.2
        # (Prefiltering::getSubstitutionMatrix, Prefiltering.cpp:999-1006)
        self.m8 = mat3di(8.0, -0.2)
        self.m2 = mat3di(2.0, -0.2)
        self.mat8 = self.m8.scores.astype(np.int32)
        self.mat2 = self.m2.scores.astype(np.int32)
        self._mat8_key = hash(self.mat8.tobytes())
        self._build_index()

    def _build_index(self):
        from ..db.index import load_index
        r0, r1 = self.entry_range
        idx = (load_index(self.tdb)
               if (r0, r1) == (0, self.tdb.size) else None)
        if (idx is not None
                and idx["manifest"].get("k") == self.k
                and idx["manifest"].get("kmer_thr") == self.index_thr):
            p = idx["postings"]
            self.post_ids = np.asarray(p.kmer_ids, dtype=np.int64)
            self.post_off = np.asarray(p.offsets, dtype=np.int64)
            self.post_tid = np.asarray(p.seq, dtype=np.int64)
            self.post_pos = np.asarray(p.pos, dtype=np.int64)
            masked = np.asarray(idx["masked_ss"])
            offs = self.tdb.offsets
            self.masked_seqs = [masked[offs[i]:offs[i + 1]]
                                for i in range(self.tdb.size)]
            self.masked_flat = masked
            self.seq_off = np.asarray(offs[:-1], dtype=np.int64)
            self.seq_len = np.diff(np.asarray(offs)).astype(np.int32)
            logger.info("kmer prefilter: using precomputed posting index")
            return
        k, span = self.k, self.span
        pows = 20 ** np.arange(k, dtype=np.int64)
        diag8 = np.diag(self.mat8)
        masked_total = 0
        # masking pass into one flat array; masked_seqs are views into it
        # (a python list-of-arrays at AFDB scale wasted GBs). With an
        # entry_range, only the range's residues are masked/indexed
        # (TARGET_DB_SPLIT); LOCAL target ids live in the postings, query()
        # converts to global on output.
        n = r1 - r0
        offs_g = np.asarray(self.tdb.offsets)
        base = int(offs_g[r0])
        offs = offs_g[r0:r1 + 1] - base
        lens = np.diff(offs)
        # whole-range vectorized masking: lowercase mask, then repeat runs
        # (Masker::maskRepeats) over the flat array with entry-boundary
        # breaks (no Python loop over the entries)
        n_res = int(offs[-1])
        flat = np.array(self.tdb.ss[base:base + n_res], dtype=np.int8)
        lc = np.asarray(self.tdb.mask[base:base + n_res])
        flat[lc > 0] = X
        before = int((flat == X).sum())
        brk = np.ones(n_res, dtype=bool)
        if n_res:
            brk[1:] = flat[1:] != flat[:-1]
            brk[offs[1:-1]] = True  # runs never cross entries
            starts = np.nonzero(brk)[0]
            run_len = np.diff(np.append(starts, n_res))
            long_run = run_len > MASK_N_REPEATS
            run_id = np.cumsum(brk) - 1
            flat[long_run[run_id]] = X
        masked_total = int((flat == X).sum()) - before
        self.masked_seqs = [flat[offs[i]:offs[i + 1]] for i in range(n)]
        self.masked_flat = flat
        self.seq_off = np.asarray(offs[:-1], dtype=np.int64)
        self.seq_len = lens.astype(np.int32)

        # vectorized window pass over the whole range in bounded chunks
        # (transient per-chunk buffers stay ~O(chunk * k), independent of
        # DB size; reference: lib/mmseqs/src/prefiltering/IndexBuilder.cpp)
        entry_of = np.repeat(np.arange(n, dtype=np.int64), lens)
        pos_in = np.arange(int(offs[-1]), dtype=np.int64) - offs[entry_of]
        ok_start = pos_in <= lens[entry_of] - span
        all_starts = np.nonzero(ok_start)[0]
        parts_k, parts_t, parts_p = [], [], []
        CHUNK = 1 << 23
        flat64 = flat.astype(np.int64)
        for c0 in range(0, len(all_starts), CHUNK):
            st = all_starts[c0:c0 + CHUNK]
            wins = flat64[st[:, None] + self.offsets[None, :]]  # [c, k]
            valid = ~(wins == X).any(axis=1)
            valid &= diag8[wins].sum(axis=1) >= self.index_thr
            parts_k.append((wins[valid] @ pows))
            parts_t.append(entry_of[st[valid]].astype(np.int32))
            parts_p.append(pos_in[st[valid]].astype(np.int32))
        kmer_a = np.concatenate(parts_k) if parts_k else np.zeros(0, np.int64)
        tid_a = np.concatenate(parts_t) if parts_t else np.zeros(0, np.int32)
        pos_a = np.concatenate(parts_p) if parts_p else np.zeros(0, np.int32)
        del parts_k, parts_t, parts_p, entry_of, pos_in, ok_start, flat64

        # only the first occurrence of each k-mer per sequence is indexed
        # (IndexTable::addSequence dedups after sorting by (kmer, position),
        # IndexTable.h:386-400). One lexsort by (kmer, tid, pos) gives the
        # dedup (first of each (kmer, tid) group = min position) AND the
        # final kmer-major / target-id-minor on-disk layout in one pass.
        order = np.lexsort((pos_a, tid_a, kmer_a))
        kmer_a, tid_a, pos_a = kmer_a[order], tid_a[order], pos_a[order]
        first = np.ones(len(kmer_a), dtype=bool)
        first[1:] = (tid_a[1:] != tid_a[:-1]) | (kmer_a[1:] != kmer_a[:-1])
        kmer_a, tid_a, pos_a = kmer_a[first], tid_a[first], pos_a[first]
        kfirst = np.ones(len(kmer_a), dtype=bool)
        kfirst[1:] = kmer_a[1:] != kmer_a[:-1]
        self.post_ids = kmer_a[kfirst]
        kstarts = np.nonzero(kfirst)[0]
        counts = np.diff(np.append(kstarts, len(kmer_a)))
        off = np.zeros(len(self.post_ids) + 1, dtype=np.int64)
        np.cumsum(counts, out=off[1:])
        self.post_off = off
        self.post_tid = tid_a.astype(np.int64)
        self.post_pos = pos_a.astype(np.int64)
        logger.info("kmer index: k=%d thr=%d, %d kmers, %d masked residues",
                    self.k, self.index_thr, len(self.post_ids), masked_total)

    # --- similar k-mer generation (KmerGenerator semantics) ---

    def _sub_lists(self, sub: np.ndarray, n_top: int = None):
        """Candidates for one query sub-kmer: (scores desc, little-endian
        indices), tie order lexicographic by tuple. Cached per sub-kmer —
        the sorted list depends only on its content (the reference
        precomputes these as ExtendedSubstitutionMatrix score lists). The
        cache is process-global keyed by the substitution matrix so repeated
        searches (and new KmerPrefilter instances) reuse the sorted lists."""
        key = (self._mat8_key, bytes(np.asarray(sub, dtype=np.int8)))
        cached = _GLOBAL_SUB_CACHE.get(key)
        if cached is not None:
            return cached
        k_sub = len(sub)
        digits, tuple_index = _sorted_submer_lists(k_sub)
        # scores[j] = sum_i mat8[sub[i], digits[j, i]]
        scores = np.zeros(len(digits), dtype=np.int32)
        for i in range(k_sub):
            scores += self.mat8[sub[i], digits[:, i]]
        order = np.argsort(-scores, kind="stable")
        out = (scores[order], tuple_index[order])
        _GLOBAL_SUB_CACHE[key] = out
        return out

    def similar_kmers(self, window: np.ndarray, threshold: int) -> np.ndarray:
        """All k-mers scoring >= threshold vs the query window, in the exact
        order KmerGenerator emits them (first sub-kmer outer desc, second
        inner desc). Returns little-endian base-20 indices."""
        memo_key = (self._mat8_key, self.k,
                    bytes(np.asarray(window, dtype=np.int8)), int(threshold))
        cached = _GLOBAL_KMER_LIST_CACHE.get(memo_key)
        if cached is not None:
            return cached
        out = self._similar_kmers_uncached(window, threshold)
        if len(_GLOBAL_KMER_LIST_CACHE) >= _KMER_LIST_CACHE_CAP:
            # evict the oldest half (insertion order) instead of a full
            # clear — the clear threw away the hot window set wholesale
            for _ in range(_KMER_LIST_CACHE_CAP // 2):
                _GLOBAL_KMER_LIST_CACHE.pop(
                    next(iter(_GLOBAL_KMER_LIST_CACHE)))
        _GLOBAL_KMER_LIST_CACHE[memo_key] = out
        return out

    def _similar_kmers_uncached(self, window: np.ndarray,
                                threshold: int) -> np.ndarray:
        k = self.k
        if k == 6:
            # divideStep [3,3] (KmerGenerator::setDivideStrategy case 0)
            splits = [window[:3], window[3:]]
            mults = [1, 20 ** 3]
        elif k == 7:
            # case 1 builds [3,2,2] then std::reverse -> [2,2,3]
            # (KmerGenerator.cpp:55-68,86); emit order follows the
            # reversed schedule, which the double-diagonal arrival
            # order depends on
            splits = [window[:2], window[2:4], window[4:]]
            mults = [1, 20 ** 2, 20 ** 4]
        else:
            raise ValueError(k)
        lists = [self._sub_lists(s) for s in splits]
        return self._expand_kmer_lists(lists, mults, threshold)

    def _expand_kmer_lists(self, lists, mults, threshold):
        """Shared KmerGenerator cartesian expansion over sorted sub-k-mer
        score lists (emit order: outer desc, inner desc)."""
        best_rest = [0] * len(lists)
        for i in range(len(lists) - 2, -1, -1):
            best_rest[i] = best_rest[i + 1] + int(lists[i + 1][0][0])
        # first list: cutoff1
        cutoff1 = threshold - best_rest[0]
        s0, i0 = lists[0]
        n0 = int(np.searchsorted(-s0, -cutoff1, side="right"))
        cur_scores = s0[:n0].astype(np.int64)
        cur_idx = i0[:n0].astype(np.int64) * mults[0]
        for li in range(1, len(lists)):
            s1, i1 = lists[li]
            rest = best_rest[li]
            s1 = s1.astype(np.int64)
            iw = i1.astype(np.int64) * mults[li]
            # vectorized cartesian expansion: for outer entry j keep the top
            # n1[j] inner entries (s1 is sorted desc), preserving the
            # KmerGenerator emit order (outer desc, inner desc)
            cutoffs = threshold - cur_scores - rest
            n1 = np.searchsorted(-s1, -cutoffs, side="right")
            total = int(n1.sum())
            if total == 0:
                return np.zeros(0, dtype=np.int64)
            rep = np.repeat(np.arange(len(cur_scores)), n1)
            off = np.zeros(len(n1), dtype=np.int64)
            np.cumsum(n1[:-1], out=off[1:])
            pos = np.arange(total, dtype=np.int64) - off[rep]
            cur_scores = cur_scores[rep] + s1[pos]
            cur_idx = cur_idx[rep] + iw[pos]
        return cur_idx

    # --- per-query matching ---


    # --- profile (PSSM) queries --------------------------------------------

    def _sub_lists_profile(self, cols: np.ndarray):
        """Candidate sub-k-mers for a PSSM column block [k_sub, 21]:
        scores[j] = sum_i cols[i, digits[j, i]] (the reference sorts the
        profile's per-position score lists for KmerGenerator,
        Sequence.cpp:343-352)."""
        cols = np.ascontiguousarray(cols, dtype=np.int32)
        key = ("prof", cols.tobytes())
        cached = _GLOBAL_SUB_CACHE.get(key)
        if cached is not None:
            return cached
        assert cols.shape[0] == 1  # single-position division for profiles
        out = _ranked_desc_sort20(cols[0])
        _GLOBAL_SUB_CACHE[key] = out
        return out

    def similar_kmers_profile(self, cols: np.ndarray,
                              threshold: int) -> np.ndarray:
        """similar_kmers over a PSSM window [span-selected k, 21]. Profile
        queries divide into k SINGLE positions (KmerGenerator::
        setDivideStrategy(ScoreMatrix** one), KmerGenerator.cpp:31-40) —
        the per-level fold order differs from the sequence path's [3,3]
        blocks and the double-diagonal arrival order depends on it."""
        k = self.k
        lists = [self._sub_lists_profile(cols[i:i + 1]) for i in range(k)]
        mults = [20 ** i for i in range(k)]
        return self._expand_kmer_lists(lists, mults, threshold)

    def query_pssm(self, pssm: np.ndarray, letters: np.ndarray,
                   max_seqs: int,
                   identity_id: int = None) -> List[Tuple[int, int, int]]:
        """PSSM-query variant of query() (QueryMatcher with an HMM_PROFILE
        query): no positional composition bias (QueryMatcher.cpp:109-114
        zeroes it for profiles), k-mers generated against the stored-scale
        PSSM [L, 20+] (bit factor 8; Sequence::mapProfile keeps stored
        scores for the k-mer stage and /4 for alignment) with the
        single-position divide strategy and rankedDescSort20 tie order,
        the diagonal Kadane rescore on the /4 alignment-scale profile.
        `letters` drive the X-window skip (the profile's query sequence).

        The reference's hit-buffer flush semantics — which profile-sized
        hit volumes reach and sequence workloads never do — are modeled
        by `chunked_candidates` (QueryMatcher.cpp:250-365), validated
        element-exact against an oracle compiled from the reference's
        CacheFriendlyOperations on 400+ fuzz streams incl. multi-flush
        and buffer-overrun cases (tests/test_chunked_flush.py). A prior
        A/B vs the reference binary WITHOUT the flush model measured
        candidate recall 97.7% / exact rows 60%; a full-stack re-measure
        with it needs the reference binary rebuilt (tools/fuzz_parity.py).
        The iterative/profile pipelines keep the device PSSM scan as the
        default fast path; query_pssm is the parity-faithful opt-in."""
        r0 = self.entry_range[0]
        if identity_id is not None:
            identity_id = (identity_id - r0
                           if self.entry_range[0] <= identity_id
                           < self.entry_range[1] else None)
        pssm = np.asarray(pssm, dtype=np.int32)
        letters = np.asarray(letters, dtype=np.int64)
        L = len(letters)
        span = self.span
        # alignment-scale profile for the Kadane rescore: stored/4 with
        # C truncation-toward-zero (Sequence.cpp:334), X column 0
        prof = np.zeros((L, self.mat2.shape[1]), dtype=np.int32)
        prof[:, :pssm.shape[1]] = np.trunc(pssm / 4.0).astype(np.int32)
        kidx_parts: List[np.ndarray] = []
        pos_parts: List[np.ndarray] = []
        thr = max(self.kmer_thr, 0)
        for p in range(L - span + 1):
            win = letters[p + self.offsets]
            if (win == X).any():
                continue
            kidxs = self.similar_kmers_profile(pssm[p + self.offsets], thr)
            if len(kidxs):
                kidx_parts.append(kidxs)
                pos_parts.append(np.full(len(kidxs), p, dtype=np.int64))
        return self._match_and_rank(kidx_parts, pos_parts, prof,
                                    letters.astype(np.int8), max_seqs,
                                    identity_id, r0)

    def query(self, q_ss: np.ndarray, max_seqs: int,
              identity_id: int = None) -> List[Tuple[int, int, int]]:
        """Returns [(target_index, pref_score, diagonal)] in final output
        order (identity first when given, then score desc / id asc).
        Target indices and identity_id are GLOBAL DB entry indices even
        under an entry_range split."""
        r0 = self.entry_range[0]
        if identity_id is not None:
            # identity target may live in another split
            identity_id = (identity_id - r0
                           if self.entry_range[0] <= identity_id
                           < self.entry_range[1] else None)
        q = np.asarray(q_ss, dtype=np.int64)
        L = len(q)
        comp_bias = _calc_bias_float(q, self.mat8, self.m8.p_back, self.bias_scale)
        span = self.span
        kidx_parts: List[np.ndarray] = []
        pos_parts: List[np.ndarray] = []
        for p in range(L - span + 1):
            win = q[p + self.offsets]
            if (win == X).any():
                continue
            bias_f = float(np.float32(comp_bias[p + self.offsets].sum()))
            bias = int(bias_f - 0.5) if bias_f < 0 else int(bias_f + 0.5)
            thr = max(self.kmer_thr - bias, 0)
            kidxs = self.similar_kmers(win, thr)
            if len(kidxs):
                kidx_parts.append(kidxs)
                pos_parts.append(np.full(len(kidxs), p, dtype=np.int64))

        prof = self._ungapped_profile(q, comp_bias)
        return self._match_and_rank(kidx_parts, pos_parts, prof, q,
                                    max_seqs, identity_id, r0)

    def _match_and_rank(self, kidx_parts, pos_parts, prof, q, max_seqs,
                        identity_id, r0):
        """Shared posting lookup + double-diagonal detection + rescore +
        rank over generated k-mer lists (sequence or PSSM queries)."""
        # batched posting lookup over the flat sorted arrays; the native
        # fast path runs lookup + double-diagonal detection + Kadane
        # rescore + best-per-target in ONE call (QueryMatcher::matchQuery)
        if kidx_parts:
            K = np.concatenate(kidx_parts)
            P = np.concatenate(pos_parts)
            from .. import native as _native
            # hit-buffer overflow path (QueryMatcher.cpp:44-45: buffer of
            # max(1e6, dbSize)*2 raw matches): when the posting volume can
            # reach a flush boundary, run the chunked-flush semantics —
            # profile/PSSM queries reach it, sequence workloads never do
            n_entries = self.entry_range[1] - self.entry_range[0]
            max_db = max(1_000_000, n_entries) * 2
            loc0 = np.searchsorted(self.post_ids, K)
            fnd0 = loc0 < len(self.post_ids)
            fnd0 &= self.post_ids[np.minimum(loc0, len(self.post_ids) - 1)] == K
            loc0, P0 = loc0[fnd0], P[fnd0]
            cnt0 = self.post_off[loc0 + 1] - self.post_off[loc0]
            if int(cnt0.sum()) >= max_db:
                keepnz = cnt0 > 0
                loc0, P0, cnt0 = loc0[keepnz], P0[keepnz], cnt0[keepnz]
                total = int(cnt0.sum())
                rep = np.repeat(np.arange(len(loc0)), cnt0)
                base = np.zeros(len(loc0), dtype=np.int64)
                np.cumsum(cnt0[:-1], out=base[1:])
                flat = (np.arange(total, dtype=np.int64) - base[rep]
                        + self.post_off[loc0][rep])
                list_off = np.zeros(len(loc0) + 1, dtype=np.int64)
                np.cumsum(cnt0, out=list_off[1:])

                def _score_fn(ids, d16):
                    if len(ids) == 0:
                        return np.zeros(0, dtype=np.int64)
                    return np.minimum(
                        np.asarray(self._diag_scores(list(ids), list(d16),
                                                     prof),
                                   dtype=np.int64), 255)

                c_ids, c_cnt, c_d16 = chunked_candidates(
                    P0, list_off, self.post_tid[flat],
                    self.post_pos[flat], max_db, _score_fn)
                items = list(zip(c_ids.tolist(), c_cnt.tolist(),
                                 c_d16.tolist()))
                return self._rank_items(items, prof, q, max_seqs,
                                        identity_id, r0)
            pc = _native.posting_candidates(
                self.post_ids, self.post_off, self.post_tid, self.post_pos,
                K, P, self.entry_range[1] - self.entry_range[0],
                prof, self.masked_flat, self.seq_off, self.seq_len)
            if pc is not None:
                tids, cnts, d16s = pc
                items = list(zip(tids.tolist(), cnts.tolist(),
                                 d16s.tolist()))
                return self._rank_items(items, prof, q, max_seqs,
                                        identity_id, r0)
            loc = np.searchsorted(self.post_ids, K)
            found = loc < len(self.post_ids)
            found &= self.post_ids[np.minimum(loc, len(self.post_ids) - 1)] == K
            loc, P = loc[found], P[found]
            counts = self.post_off[loc + 1] - self.post_off[loc]
            total = int(counts.sum())
            rep = np.repeat(np.arange(len(loc)), counts)
            base = np.zeros(len(loc), dtype=np.int64)
            np.cumsum(counts[:-1], out=base[1:])
            flat = np.arange(total, dtype=np.int64) - base[rep] + self.post_off[loc][rep]
            arr_tid = self.post_tid[flat]
            arr_d16 = (P[rep] - self.post_pos[flat]) & 0xFFFF
        else:
            arr_tid = np.zeros(0, dtype=np.int64)
            arr_d16 = np.zeros(0, dtype=np.int64)

        # double-diagonal detection (diag byte) + dedup, per target id —
        # grouped per tid in arrival order. The reference's
        # duplicateBitArray starts zeroed, so the FIRST posting of an id on
        # diagonal byte 0 already counts as a duplicate
        # (CacheFriendlyOperations.cpp:186,200-207). One native O(n) pass;
        # numpy fallback below is the same algorithm over a stable sort.
        from .. import native as _native
        dd_res = _native.double_diag_detect(
            arr_tid, arr_d16, self.entry_range[1] - self.entry_range[0])
        if dd_res is not None:
            cand_ids, cand_diags = dd_res
            return self._rescore_and_rank(
                cand_ids, cand_diags, prof, q, max_seqs,
                identity_id, r0)
        order = np.argsort(arr_tid, kind="stable")
        st = arr_tid[order]
        sd16 = arr_d16[order]
        sd8 = sd16 & 0xFF
        first = np.ones(len(st), dtype=bool)
        first[1:] = st[1:] != st[:-1]
        prev_d8 = np.empty_like(sd8)
        prev_d8[1:] = sd8[:-1]
        prev_d8[first] = 0
        dup = prev_d8 == sd8
        dt, dd16, dd8 = st[dup], sd16[dup], sd8[dup]
        dfirst = np.ones(len(dt), dtype=bool)
        dfirst[1:] = dt[1:] != dt[:-1]
        dprev = np.empty_like(dd8)
        dprev[1:] = dd8[:-1]
        keep = dfirst.copy()
        keep[~dfirst] = dprev[~dfirst] != dd8[~dfirst]
        cand_ids = dt[keep]
        cand_diags = dd16[keep]
        return self._rescore_and_rank(cand_ids, cand_diags, prof, q,
                                      max_seqs, identity_id, r0)

    def _rescore_and_rank(self, cand_ids, cand_diags, prof, q,
                          max_seqs, identity_id, r0):
        # diagonal rescoring (exact int, capped 255): one native call for
        # the whole candidate list, then a vectorized best-per-target
        # reduction (strict '>' keeps the earliest max, like the dict loop)
        from .. import native
        scores = native.diag_score_batch(
            prof, self.masked_flat, self.seq_off, self.seq_len,
            cand_ids, cand_diags) if len(cand_ids) else None
        if scores is not None:
            counts = np.minimum(scores, 255)
            order = np.arange(len(cand_ids))
            sel = np.lexsort((order, -counts, cand_ids))
            tid_sorted = cand_ids[sel]
            first = np.ones(len(sel), dtype=bool)
            first[1:] = tid_sorted[1:] != tid_sorted[:-1]
            pick = sel[first]
            items = list(zip(cand_ids[pick].tolist(),
                             counts[pick].tolist(),
                             cand_diags[pick].tolist()))
        else:
            best: Dict[int, Tuple[int, int, int]] = {}  # tid -> (count, diag, order)
            for n, (tid, d16) in enumerate(zip(cand_ids, cand_diags)):
                score = self._diag_score(prof, self.masked_seqs[tid], d16)
                count = min(255, score)
                cur = best.get(tid)
                if cur is None or count > cur[0]:
                    best[tid] = (count, d16, n)
            items = ([(tid, c, d) for tid, (c, d, _) in best.items()]
                     if best else [])
        return self._rank_items(items, prof, q, max_seqs, identity_id, r0)

    def _rank_items(self, items, prof, q, max_seqs, identity_id, r0):
        # adaptive threshold
        hist = np.zeros(256, dtype=np.int64)
        for _, c, _ in items:
            hist[c] += 1
        max_hits = min(max_seqs, self.entry_range[1] - self.entry_range[0])
        thr = _compute_score_threshold(hist, max_hits)
        thr = max(self.min_diag_score, thr)

        results: List[Tuple[int, int, int]] = []
        if identity_id is not None:
            results.append((identity_id, 65535, 0))
        if thr >= 255:
            # saturated: rescore exact, rescale to byte, keep only saturated
            self_score = self._diag_score(prof, q.astype(np.int8), 0, exact=True)
            max_self = max(1, min(self_score - 255, 65535))
            sat = [(tid, d) for tid, c, d in items if c >= 255]
            exacts = self._diag_scores([t_ for t_, _ in sat],
                                       [d_ for _, d_ in sat], prof)
            rescored = []
            for (tid, d), exact in zip(sat, exacts):
                new = min(max(exact - 255, 0), 65535)
                c8 = int(min(new / max_self * 255.0 + 0.5, 255))
                rescored.append((tid, c8, d))
            rescored.sort(key=lambda x: (-x[1], x[0]))
            for tid, c8, d in rescored:
                if len(results) >= max_hits:
                    break
                if identity_id is not None and tid == identity_id:
                    continue
                score = 255 + (c8 * max_self) // 255
                results.append((tid, score, d))
        else:
            kept = [(tid, c, d) for tid, c, d in items if c >= thr]
            kept.sort(key=lambda x: (-x[1], x[0]))
            sat = [(tid, d) for tid, c, d in kept if c >= 255]
            exact_of = dict(zip(sat, self._diag_scores(
                [t_ for t_, _ in sat], [d_ for _, d_ in sat], prof)))
            for tid, c, d in kept:
                if len(results) >= max_hits:
                    break
                if identity_id is not None and tid == identity_id:
                    continue
                score = exact_of[(tid, d)] if c >= 255 else c
                results.append((tid, score, d))
        # final ordering: identity first, rest by (score desc, id asc)
        head = results[:1] if identity_id is not None else []
        tail = results[1:] if identity_id is not None else results
        tail.sort(key=lambda x: (-x[1], x[0]))
        out = head + tail
        if r0:
            out = [(t + r0, s, d) for t, s, d in out]
        return out

    def _diag_scores(self, tids, d16s, prof):
        """Exact diagonal scores for a (tid, d16) list — one native call,
        per-candidate python fallback."""
        if not tids:
            return []
        from .. import native
        out = native.diag_score_batch(prof, self.masked_flat, self.seq_off,
                                      self.seq_len, np.asarray(tids),
                                      np.asarray(d16s))
        if out is not None:
            return [int(v) for v in out]
        return [self._diag_score(prof, self.masked_seqs[t], d)
                for t, d in zip(tids, d16s)]

    def _ungapped_profile(self, q: np.ndarray, comp_bias: np.ndarray) -> np.ndarray:
        """[L, 21] int profile: mat2[q[pos]][a] + round(bias/4). The /4 and
        +-0.5 run in float32 like the reference (UngappedAlignment.cpp:396)."""
        b4 = comp_bias.astype(np.float32) / np.float32(4.0)
        b4 = np.where(b4 < 0, b4 - np.float32(0.5), b4 + np.float32(0.5)).astype(np.int32)
        return self.mat2[q] + b4[:, None]

    @staticmethod
    def _diag_score(prof: np.ndarray, t_seq: np.ndarray, d16: int,
                    exact: bool = False) -> int:
        """Exact integer Kadane along one diagonal
        (UngappedAlignment::computeSingelSequenceScores)."""
        d = d16 - 65536 if d16 >= 32768 else d16
        L_q = prof.shape[0]
        L_t = len(t_seq)
        if d >= 0:
            if d >= L_q:
                return 0
            n = min(L_t, L_q - d)
            qs = prof[d: d + n]
            ts = np.asarray(t_seq[:n], dtype=np.int64)
        else:
            md = -d
            if md >= L_t:
                return 0
            n = min(L_t - md, L_q)
            qs = prof[:n]
            ts = np.asarray(t_seq[md: md + n], dtype=np.int64)
        s = qs[np.arange(n), ts].astype(np.int64)
        # vectorized Kadane: max subarray sum (empty allowed) via prefix sums
        P = np.empty(n + 1, dtype=np.int64)
        P[0] = 0
        np.cumsum(s, out=P[1:])
        return int(np.max(P - np.minimum.accumulate(P)))


def _calc_bias_float(q: np.ndarray, mat8: np.ndarray, back: np.ndarray,
                     scale: float = 1.0) -> np.ndarray:
    """float composition bias without the int8 rounding — QueryMatcher keeps
    it float (QueryMatcher.cpp:240-246). The search workflow runs the
    prefilter at scale 0.15 (src/workflow/StructureSearch.cpp:101)."""
    N = len(q)
    w = 40
    rows = mat8[q].astype(np.int64)
    scores = rows[:, q]
    idx = np.arange(N)
    lo = np.maximum(0, idx - w // 2)
    hi = np.minimum(N, idx + w // 2)
    csum = np.zeros((N, N + 1), dtype=np.int64)
    np.cumsum(scores, axis=1, out=csum[:, 1:])
    win = csum[idx, hi] - csum[idx, lo] - scores[idx, idx]
    delta = (win.astype(np.float64) / (-1.0 * (hi - lo))).astype(np.float32)
    for a in range(mat8.shape[0]):
        delta = (delta.astype(np.float64) + back[a] * rows[:, a].astype(np.float64)).astype(np.float32)
    return (np.float32(scale) * delta).astype(np.float32)


def _compute_score_threshold(hist: np.ndarray, max_hits: int) -> int:
    found = 0
    for thr in range(255, 0, -1):
        found += int(hist[thr])
        if found >= max_hits:
            return thr
    return 0


_FORK_STATE = {}


def _fork_unsafe() -> bool:
    """True when this process holds a CUDA context: forked children would
    inherit it, so the prefilter takes the sequential path then (on the
    default pipeline the k-mer stage runs before any device work, so the
    fork fast path still applies there).
    FOLDSEEK_TPU_FORK=1/0 overrides the probe both ways."""
    import os

    import torch
    env = os.environ.get("FOLDSEEK_TPU_FORK", "")
    if env in ("0", "1"):
        return env == "0"
    return torch.cuda.is_initialized()


def _kmer_query_worker(args):
    qi, max_seqs, identity = args
    pref, qdb = _FORK_STATE["pref"], _FORK_STATE["qdb"]
    return qi, pref.query(np.asarray(qdb.get_ss(qi)), max_seqs, identity)


def _query_split(pref, qdb, params, same_db):
    """All queries against one (possibly range-limited) posting index;
    returns qi -> [(tid, score, diag)] with global tids."""
    import multiprocessing as mp
    import os
    jobs = [(qi, params.max_seqs, qi if same_db else None)
            for qi in range(qdb.size)]
    out = {}
    # fork-parallel over queries — the reference's `#pragma omp parallel
    # for` in Prefiltering; the forked workers share the posting lists
    # copy-on-write
    from ..utils.hostpar import n_host_threads
    n_workers = n_host_threads(len(jobs))
    if n_workers > 1 and len(jobs) > 2 and hasattr(os, "fork") \
            and not _fork_unsafe():
        _FORK_STATE["pref"], _FORK_STATE["qdb"] = pref, qdb
        try:
            with mp.get_context("fork").Pool(n_workers) as pool:
                for qi, hits in pool.imap_unordered(
                        _kmer_query_worker, jobs, chunksize=2):
                    out[qi] = hits
        finally:
            _FORK_STATE.clear()
        return out
    for qi, max_seqs, identity in jobs:
        out[qi] = pref.query(np.asarray(qdb.get_ss(qi)), max_seqs, identity)
    return out


def plan_kmer_splits(tdb: StructDB, budget_bytes: int) -> List[tuple]:
    """Residue-balanced target entry ranges whose posting index fits the
    RAM budget (the reference's memory-based TARGET_DB_SPLIT,
    Prefiltering.cpp:289-381). ~28 B of index per residue measured
    (flat masked seqs + final int64 posting arrays + sort transients)."""
    PER_RESIDUE = 28.0
    need = tdb.total_residues * PER_RESIDUE
    n_splits = max(1, int(-(-need // max(budget_bytes, 1 << 20))))
    if n_splits <= 1:
        return [(0, tdb.size)]
    offs = np.asarray(tdb.offsets)
    per = int(offs[-1]) / n_splits
    bounds = [int(np.searchsorted(offs, per * i)) for i in range(n_splits)]
    bounds.append(tdb.size)
    out = []
    for i in range(n_splits):
        s, e = bounds[i], bounds[i + 1]
        if e > s:
            out.append((s, e))
    return out


def _kmer_ram_budget() -> int:
    import os
    env = os.environ.get("FOLDSEEK_TPU_KMER_RAM_MB", "")
    if env:
        return int(env) * (1 << 20)
    try:
        avail = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
        return int(avail * 0.5)
    except (ValueError, OSError):
        return 8 << 30


def kmer_prefilter(qdb: StructDB, tdb: StructDB, params: SearchParams,
                   k: int = 0, bias_scale: float = 0.15,
                   min_diag_score: int = MIN_DIAG_SCORE) -> Dict[int, List[int]]:
    # the search workflow runs the prefilter at bias scale 0.15
    # (src/workflow/StructureSearch.cpp:101)
    same_db = qdb.path == tdb.path
    tidx_to_key = {i: int(tdb.keys[i]) for i in range(tdb.size)}

    # Util::canBeCovered output gate (Prefiltering.cpp:871-878: applied
    # after matchQuery/truncation, only for cov modes 0/2/5)
    tlens = np.asarray(tdb.lengths(), dtype=np.int64)
    qlens = np.asarray(qdb.lengths(), dtype=np.int64)
    gate = params.cov_thr > 0.0 and params.cov_mode in (0, 2, 5)

    def keep(qi, tids):
        if not gate:
            return tids
        from .params import can_be_covered
        ql = int(qlens[qi])
        return [t for t in tids
                if can_be_covered(params.cov_thr, params.cov_mode, ql,
                                  int(tlens[t]))]

    splits = plan_kmer_splits(tdb, _kmer_ram_budget())
    if len(splits) == 1:
        pref = KmerPrefilter(tdb, params, k=k, bias_scale=bias_scale,
                             min_diag_score=min_diag_score)
        hits = _query_split(pref, qdb, params, same_db)
        return {int(qdb.keys[qi]):
                [tidx_to_key[t]
                 for t in keep(qi, [t for t, _, _ in hits[qi]])]
                for qi in range(qdb.size)}

    # target splits: per-split index build + query, per-query k-way merge
    # by (identity first, score desc, id asc) — the reference's
    # mergeTargetSplits order
    logger.info("kmer prefilter: %d target splits under the RAM budget",
                len(splits))
    merged: Dict[int, list] = {qi: [] for qi in range(qdb.size)}
    for rng in splits:
        pref = KmerPrefilter(tdb, params, k=k, bias_scale=bias_scale,
                             min_diag_score=min_diag_score, entry_range=rng)
        hits = _query_split(pref, qdb, params, same_db)
        for qi, rows in hits.items():
            merged[qi].extend(rows)
        del pref
    out: Dict[int, List[int]] = {}
    for qi in range(qdb.size):
        rows = merged[qi]
        ident = [r for r in rows if same_db and r[0] == qi]
        rest = sorted((r for r in rows if not (same_db and r[0] == qi)),
                      key=lambda x: (-x[1], x[0]))
        kept = (ident[:1] + rest)[: params.max_seqs]
        out[int(qdb.keys[qi])] = [tidx_to_key[t]
                                  for t in keep(qi, [t for t, _, _ in kept])]
    return out
