"""Linear-time k-mer grouping for clustering — the `kmermatcher` module
(reference: lib/mmseqs/src/linclust/kmermatcher.cpp).

Per sequence, select the ~`kmers_per_sequence` k-mers with the smallest
16-bit XXH64 hashes (plus a whole-sequence hash as an identity k-mer), group
all selected k-mers across the database, pick the longest member of every
group as its representative, and emit prefilter-format hits
(member, sharedKmerCount, bestDiagonal) per representative.

K-mers are drawn from the 3Di alphabet reduced to 13 states by iterative
maximum-mutual-information letter merging (ReducedMatrix,
lib/mmseqs/src/prefiltering/ReducedMatrix.cpp) and use the spaced seed
patterns from Sequence.h:23-41.

This stage is hash-bucket bookkeeping, not FLOPs — it runs on the host
(numpy); the downstream alignment stage is the device work. Copy of
`foldseek_tpu/cluster/kmermatcher.py`.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from ..db.storage import StructDB
from ..ops.matrices import ALPHA_SIZE, ALPHABET, mat3di
from ..search.params import can_be_covered
from ..utils.log import logger

USHRT_MAX = 65535

# reference: lib/mmseqs/src/commons/Sequence.h:20-46
SEEDS = {k: [1] * k for k in range(4, 17)}
SPACED_SEEDS = {
    4: [1, 1, 1, 0, 1],
    5: [1, 1, 0, 0, 1, 0, 0, 0, 0, 1, 0, 1],
    6: [1, 1, 0, 1, 0, 1, 0, 0, 1, 1],
    7: [1, 1, 0, 1, 0, 1, 1, 0, 0, 1, 1],
    8: [1, 1, 0, 1, 0, 1, 1, 1, 0, 0, 1, 1],
    9: [1, 1, 0, 1, 0, 1, 1, 0, 0, 1, 1, 0, 1, 1],
    10: [1, 1, 0, 1, 0, 1, 1, 0, 1, 0, 1, 1, 0, 1, 1],
    11: [1, 1, 0, 1, 0, 1, 1, 0, 0, 1, 1, 0, 1, 1, 0, 1, 1],
    12: [1, 1, 0, 1, 0, 1, 1, 0, 0, 1, 1, 0, 1, 1, 0, 1, 0, 1, 1],
    13: [1, 1, 0, 1, 0, 1, 1, 1, 0, 0, 1, 1, 0, 1, 1, 0, 1, 0, 1, 1],
    14: [1, 1, 0, 1, 0, 1, 1, 1, 0, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1],
    15: [1, 1, 1, 0, 1, 0, 1, 1, 1, 1, 0, 1, 1, 0, 0, 0, 1, 0, 1, 1, 0, 1, 1],
    16: [1, 1, 1, 0, 1, 1, 1, 0, 0, 1, 0, 1, 0, 0, 1, 0, 1, 1, 0, 0, 1, 1, 1, 1, 1],
}

# XXH64 primes
_P1 = 11400714785074694791
_P2 = 14029467366897019727
_P3 = 1609587929392839161
_P4 = 9650029242287828579
_P5 = 2870177450012600261
_M64 = (1 << 64) - 1


def xxh64_u64(value: int, seed: int) -> int:
    """XXH64 of the 8 little-endian bytes of `value`
    (kmermatcher.cpp:35-40 hashUInt64)."""
    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & _M64
    h = (seed + _P5 + 8) & _M64
    k1 = (value * _P2) & _M64
    k1 = rotl(k1, 31)
    k1 = (k1 * _P1) & _M64
    h ^= k1
    h = (rotl(h, 27) * _P1 + _P4) & _M64
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    h ^= h >> 32
    return h


def xxh64_u64_batch(values: np.ndarray, seed: int) -> np.ndarray:
    """Vectorized xxh64_u64 over a uint64 array."""
    with np.errstate(over="ignore"):
        v = values.astype(np.uint64)
        P1 = np.uint64(_P1); P2 = np.uint64(_P2); P3 = np.uint64(_P3)
        h = np.uint64((seed + _P5 + 8) & _M64)
        k1 = v * P2
        k1 = (k1 << np.uint64(31)) | (k1 >> np.uint64(33))
        k1 = k1 * P1
        h = h ^ k1
        h = ((h << np.uint64(27)) | (h >> np.uint64(37))) * P1 + np.uint64(_P4)
        h = h ^ (h >> np.uint64(33))
        h = h * P2
        h = h ^ (h >> np.uint64(29))
        h = h * P3
        h = h ^ (h >> np.uint64(32))
        return h


def util_hash(codes: np.ndarray) -> int:
    """Util::hash (lib/mmseqs/src/commons/Util.h:344-352): h = h*31 + x."""
    h = 0
    for x in codes.tolist():
        h = (h * 31 + int(x)) & _M64
    return h


@functools.lru_cache(maxsize=None)
def reduced_3di_alphabet(reduced_size: int = 13) -> Tuple[np.ndarray, str]:
    """Port of ReducedMatrix (lib/mmseqs/src/prefiltering/ReducedMatrix.cpp):
    iteratively merge the pair of (non-X) letters that maximizes the mutual
    information sum(p_ij * log2(p_ij / (p_i p_j))) of the merged probability
    matrix, built from the 3Di substitution model. Returns (char->group
    256-table, group representative letters)."""
    m = mat3di()
    n_full = ALPHA_SIZE          # 21 incl. X
    n = n_full - 1               # 20 letters take part in merging
    prob = m.prob[:n, :n].copy().astype(np.float64)
    # groups[g] = list of original letter indices; representative = first
    letters = [[i] for i in range(n)]

    def mutual_info(p):
        k = p.shape[0]
        pb = p.sum(axis=1)
        mi = 0.0
        for i in range(k):
            for j in range(k):
                mi += p[i][j] * math.log2(p[i][j] / (pb[i] * pb[j]))
        return mi

    def couple(p, i, j):
        q = np.delete(np.delete(p, j, axis=0), j, axis=1).copy()
        q[i, :] = np.delete(p[i, :] + p[j, :], j)
        q[:, i] = np.delete(p[:, i] + p[:, j], j)
        q[i, i] = p[i, i] + p[i, j] + p[j, i] + p[j, j]
        return q

    steps = n_full - reduced_size
    for _ in range(steps):
        best = (0.0, 0, 0)
        k = prob.shape[0]
        for i in range(k):
            for j in range(i + 1, k):
                mi = mutual_info(couple(prob, i, j))
                if mi > best[0]:
                    best = (mi, i, j)
        _, bi, bj = best
        prob = couple(prob, bi, bj)
        letters[bi].extend(letters[bj])
        del letters[bj]

    table = np.full(256, reduced_size - 1, dtype=np.int8)  # default: X group
    reps = []
    for g, group in enumerate(letters):
        reps.append(ALPHABET[group[0]])
        for orig in group:
            table[ord(ALPHABET[orig])] = g
            table[ord(ALPHABET[orig].lower())] = g
    reps.append("X")
    table[ord("X")] = reduced_size - 1
    table[ord("x")] = reduced_size - 1
    return table, "".join(reps)


def auto_kmer_params(total_residues: int, seq_id_thr: float,
                     kmer_size: int, kmers_per_sequence: int):
    """setKmerLengthAndAlphabet (kmermatcher.cpp:1268-1298), AA branch."""
    alphabet_size = 13
    if kmer_size == 0:
        if seq_id_thr + 0.001 >= 0.99:
            kmer_size, alphabet_size = 14, 21
        elif seq_id_thr + 0.001 >= 0.9:
            kmer_size, alphabet_size = 14, 13
        else:
            kmer_size = max(10, int(math.log(float(total_residues)) / math.log(8.7)))
    if kmers_per_sequence == 0:
        kmers_per_sequence = 20
    return kmer_size, alphabet_size, kmers_per_sequence


@dataclass
class KmerMatcherParams:
    kmer_size: int = 0                 # 0 = auto
    kmers_per_sequence: int = 21
    kmers_per_sequence_scale: float = 0.0
    spaced_kmer: bool = False
    hash_shift: int = 67
    cov_thr: float = 0.8
    cov_mode: int = 0
    seq_id_thr: float = 0.0
    include_only_extendable: bool = False
    ignore_multi_kmer: bool = False


def kmermatcher(db: StructDB, params: KmerMatcherParams) -> Dict[int, List[Tuple[int, int, int]]]:
    """Returns prefilter entries: every DB key maps to its result list of
    (targetKey, score, diagonal) lines; group representatives lead with a
    (self, 0, 0) line followed by member hits, everyone else gets the
    singleton (self, 0, 0) entry (kmermatcher.cpp:779-791)."""
    kmer_size, alphabet_size, kmers_per_seq = auto_kmer_params(
        db.total_residues, params.seq_id_thr, params.kmer_size, params.kmers_per_sequence)
    if params.kmers_per_sequence:
        kmers_per_seq = params.kmers_per_sequence
    if alphabet_size == 13:
        reduce_table, groups = reduced_3di_alphabet(13)
        logger.info("kmermatcher: k=%d reduced alphabet (%s)", kmer_size, groups)
    else:
        reduce_table = None
        logger.info("kmermatcher: k=%d full alphabet", kmer_size)

    pattern = (SPACED_SEEDS if params.spaced_kmer else SEEDS).get(kmer_size)
    if pattern is None:
        pattern = [1] * kmer_size
    pattern = np.asarray(pattern, dtype=np.int64)
    span = len(pattern)
    on_pos = np.nonzero(pattern)[0]
    base = alphabet_size - 1
    x_code = alphabet_size - 1
    powers = (np.uint64(base) ** np.arange(kmer_size, dtype=np.uint64))

    # ---- per-sequence k-mer selection (fillKmerPositionArray) ----
    entries_kmer = []     # uint64 k-mer id / whole-seq hash
    entries_id = []       # sequence key
    entries_pos = []      # k-mer start position
    entries_len = []      # sequence length
    for i in range(db.size):
        key = int(db.keys[i])
        ss = np.asarray(db.ss[db.offsets[i]:db.offsets[i + 1]])
        if reduce_table is not None:
            chars = np.frombuffer(
                "".join(ALPHABET[v] for v in ss).encode("ascii"), dtype=np.uint8)
            codes = reduce_table[chars].astype(np.uint8)
        else:
            codes = ss.astype(np.uint8)
        L = len(codes)
        seq_hash = xxh64_u64(util_hash(codes), params.hash_shift)
        # identity k-mer — always selected (kmermatcher.cpp:225-247)
        entries_kmer.append(seq_hash)
        entries_id.append(key)
        entries_pos.append(0)
        entries_len.append(L)

        n_kmers = L - span + 1
        if n_kmers <= 0:
            continue
        windows = np.lib.stride_tricks.sliding_window_view(codes, span)[:, on_pos]
        valid = ~(windows == x_code).any(axis=1)
        kmer_idx = (windows.astype(np.uint64) * powers[None, :]).sum(axis=1)
        kmer_idx = kmer_idx[valid]
        positions = np.nonzero(valid)[0]
        hashes = (xxh64_u64_batch(kmer_idx, params.hash_shift)
                  & np.uint64(0xFFFF)).astype(np.int64)

        count = len(kmer_idx)
        considered = min(
            int(kmers_per_seq - 1 + params.kmers_per_sequence_scale * L), count)
        if count == 0:
            continue
        # histogram threshold with last-bin overflow handling (:210-289)
        hist = np.bincount(hashes, minlength=65536)
        coarse = hist.reshape(128, 512).sum(axis=1)
        in_bins = 0
        ht = 0
        while ht < 128 and in_bins < considered:
            in_bins += int(coarse[ht])
            ht += 1
        ht -= 1 if ht > 0 else 0
        in_bins -= int(coarse[ht])
        threshold = ht * 512
        while threshold <= USHRT_MAX and in_bins < considered:
            in_bins += int(hist[threshold])
            threshold += 1
        too_much = in_bins - considered

        selected = 0
        for j in range(count):
            if selected >= considered:
                break
            h = int(hashes[j])
            if h < threshold:
                if h == threshold - 1 and too_much:
                    too_much -= 1
                    if too_much == 0:
                        threshold -= 1
                selected += 1
                entries_kmer.append(int(kmer_idx[j]))
                entries_id.append(key)
                entries_pos.append(int(positions[j]))
                entries_len.append(L)

    kmer = np.asarray(entries_kmer, dtype=np.uint64)
    seq_id = np.asarray(entries_id, dtype=np.int64)
    pos = np.asarray(entries_pos, dtype=np.int64)
    seq_len = np.asarray(entries_len, dtype=np.int64)

    # ---- sort by (kmer, seqLen desc, id, pos) (compareRepSequenceAndIdAndPos)
    order = np.lexsort((pos, seq_id, -seq_len, kmer))
    kmer, seq_id, pos, seq_len = kmer[order], seq_id[order], pos[order], seq_len[order]

    # ---- assignGroup (kmermatcher.cpp:506-626) ----
    out_rep, out_id, out_diag, out_len = [], [], [], []
    start = 0
    n_entries = len(kmer)
    while start < n_entries:
        end = start
        while end < n_entries and kmer[end] == kmer[start]:
            end += 1
        group_size = end - start
        rep_key = int(seq_id[start])
        rep_pos = int(pos[start])
        rep_len = int(seq_len[start])
        if group_size > 1:
            for j in range(start, end):
                diagonal = rep_pos - int(pos[j])
                if params.include_only_extendable:
                    keep = diagonal < 0 or diagonal > (rep_len - int(seq_len[j]))
                else:
                    keep = can_be_covered(params.cov_thr, params.cov_mode,
                                          rep_len, int(seq_len[j]))
                if keep:
                    out_rep.append(rep_key)
                    out_id.append(int(seq_id[j]))
                    out_diag.append(diagonal)
                    out_len.append(int(seq_len[j]))
        start = end

    rep = np.asarray(out_rep, dtype=np.int64)
    mem = np.asarray(out_id, dtype=np.int64)
    diag = np.asarray(out_diag, dtype=np.int64)

    # ---- sort by (rep, member, diagonal) and write groups ----
    order = np.lexsort((diag, mem, rep))
    rep, mem, diag = rep[order], mem[order], diag[order]

    results: Dict[int, List[Tuple[int, int, int]]] = {}
    covered_reps = set()
    i = 0
    n = len(rep)
    while i < n:
        r = int(rep[i])
        lines: List[Tuple[int, int, int]] = [(r, 0, 0)]
        j = i
        wrote = 0
        while j < n and rep[j] == r:
            t = int(mem[j])
            k = j
            best_diag = int(diag[j])
            max_run = 0
            run = 0
            prev_d = best_diag
            top_score = 0
            while k < n and rep[k] == r and mem[k] == t:
                d = int(diag[k])
                run = run + 1 if d == prev_d else 1
                if run >= max_run:
                    best_diag = d
                    max_run = run
                prev_d = d
                k += 1
                top_score += 1
            if t != r:
                lines.append((t, top_score, best_diag))
                wrote += 1
            j = k
        if wrote > 0:
            results[r] = lines
            covered_reps.add(r)
        i = j

    for i in range(db.size):
        key = int(db.keys[i])
        if key not in covered_reps:
            results.setdefault(key, [(key, 0, 0)])
    return results
