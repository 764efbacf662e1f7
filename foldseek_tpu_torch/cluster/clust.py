"""Graph clustering of alignment results — the `clust` module.

Host-side port of the reference clustering algorithms with identical
tie-breaking (reference: lib/mmseqs/src/clustering/ClusteringAlgorithms.cpp,
Clustering.cpp). Clustering is a pointer-chasing graph problem; it stays on
the host while the expensive alignment graph construction runs on the
device. Copy of `foldseek_tpu/cluster/clust.py`.

Semantics replicated exactly:
- entries are processed in length-descending order, ties by key-sorted
  position ascending (DBReader SORT_BY_LENGTH, DBReader.cpp:347-364)
- adjacency lists keep result-file order (the final readInData pass refills
  them unsorted); missing back-edges are appended after that block in
  source-set ascending order, carrying the forward edge's score
  (AlignmentSymmetry::findMissingLinks/addMissingLinks)
- set-cover picks the largest set first, ties resolved towards the entry
  with the larger internal id (initClustersizes bucket layout +
  descending position scan, ClusteringAlgorithms.cpp:157-190,215)
- members move to a new representative only for a strictly better score
  (setCover: `seqId > bestscore`, ClusteringAlgorithms.cpp:230-234)
- output pairs (repKey, memberKey) sorted ascending (execute() tail)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

USHRT_MAX = 65535
SHRT_MIN = -32768

# Parameters::SET_COVER/CONNECTED_COMPONENT/GREEDY/GREEDY_MEM
MODE_SET_COVER = 0
MODE_CONNECTED_COMPONENT = 1
MODE_GREEDY = 2
MODE_GREEDY_MEM = 3

# Parameters::APC_ALIGNMENTSCORE / APC_SEQID
APC_ALIGNMENTSCORE = 1
APC_SEQID = 2


@dataclass
class AlnEdge:
    """One parsed alignment/prefilter result line: target key + the
    similarity used by set-cover (seqId*1000 for alignment DBs with
    APC_SEQID, |score| for prefilter DBs; AlignmentSymmetry.cpp:80-98)."""
    target_key: int
    score: int  # already quantized to unsigned short range


# score given to the implicit self-edge of an empty result entry
# (AlignmentSymmetry.cpp:45-64): alignment DBs use seqId 1.0 -> 1000,
# prefilter/cluster DBs use USHRT_MAX.
EMPTY_SELF_SCORE_ALIGNMENT = 1000
EMPTY_SELF_SCORE_PREFILTER = USHRT_MAX


def length_sort_order(keys: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Internal id order of DBReader SORT_BY_LENGTH: length descending,
    ties by key-ascending position (the base index is key-sorted)."""
    keys = np.asarray(keys)
    lengths = np.asarray(lengths)
    key_order = np.argsort(keys, kind="stable")
    # stable sort by -length over the key-sorted list
    sub = np.argsort(-lengths[key_order], kind="stable")
    return key_order[sub]


def score_from_alignment_line(score: int, seq_id_str: str, scoretype: int) -> int:
    """AlignmentSymmetry.cpp:80-98: alignment DB -> column 1 (score) as
    unsigned short for APC_ALIGNMENTSCORE else atof(column 2)*1000.0f;
    prefilter DB -> |column 1|. seq_id_str is the 3-decimal text written by
    resultToBuffer so the atof round-trip is exact."""
    if scoretype == APC_ALIGNMENTSCORE:
        return int(score) & USHRT_MAX
    return int(np.float64(float(seq_id_str)) * np.float64(np.float32(1000.0)))


def cluster(keys: Sequence[int], lengths: Sequence[int],
            edges: Dict[int, List[AlnEdge]], mode: int,
            max_iterations: int = 1000,
            empty_self_score: int = EMPTY_SELF_SCORE_ALIGNMENT) -> List[Tuple[int, int]]:
    """Cluster the alignment graph.

    keys/lengths: all sequence DB entries. edges: query key -> parsed result
    lines (a self edge with empty_self_score is substituted for empty
    entries, matching readInData:45-64). Returns (repKey, memberKey) pairs
    sorted ascending, every entry present exactly once as a member.
    """
    keys = np.asarray(keys, dtype=np.uint32)
    lengths = np.asarray(lengths, dtype=np.int64)
    n = len(keys)
    order = length_sort_order(keys, lengths)          # internal id -> entry
    ordered_keys = keys[order]
    key_to_internal = {int(k): i for i, k in enumerate(ordered_keys)}

    assigned = np.full(n, -1, dtype=np.int64)

    if mode in (MODE_GREEDY, MODE_GREEDY_MEM):
        _greedy_incremental(ordered_keys, key_to_internal, edges, assigned)
    else:
        adj, scores = _read_cluster_data(ordered_keys, key_to_internal, edges,
                                         empty_self_score)
        sizes = np.array([len(a) for a in adj], dtype=np.int64)
        if mode == MODE_SET_COVER:
            _set_cover(adj, scores, sizes, assigned)
        elif mode == MODE_CONNECTED_COMPONENT:
            _connected_component(adj, sizes, assigned, max_iterations)
        else:
            raise ValueError(f"unknown clustering mode {mode}")

    pairs = [(int(ordered_keys[assigned[i]]), int(ordered_keys[i])) for i in range(n)]
    pairs.sort()
    return pairs


def _read_cluster_data(ordered_keys, key_to_internal, edges, empty_self_score):
    """Build symmetrized adjacency + score lists exactly as
    readInClusterData does. The final readInData pass refills the lists in
    result-file order (the earlier sortElements pass only feeds the
    missing-link count), so forward edges keep file order here."""
    n = len(ordered_keys)
    adj: List[List[int]] = [[] for _ in range(n)]
    scores: List[List[int]] = [[] for _ in range(n)]
    for i in range(n):
        qkey = int(ordered_keys[i])
        lines = edges.get(qkey, [])
        if not lines:
            adj[i] = [i]
            scores[i] = [empty_self_score]
            continue
        adj[i] = [key_to_internal[int(e.target_key)] for e in lines]
        scores[i] = [int(e.score) for e in lines]

    # findMissingLinks/addMissingLinks: sequential over source sets ascending,
    # append target<-source edge if missing, copying the forward score.
    base_len = [len(a) for a in adj]
    for set_id in range(n):
        for pos in range(base_len[set_id]):
            curr = adj[set_id][pos]
            found = False
            for p2 in range(base_len[curr]):
                if adj[curr][p2] == set_id:
                    found = True
                    break
            if not found:
                adj[curr].append(set_id)
                scores[curr].append(scores[set_id][pos])
    return adj, scores


class _SizeBuckets:
    """Mutable bucket-sorted cluster sizes (initClustersizes +
    removeClustersize/decreaseClustersize, ClusteringAlgorithms.cpp:157-214)."""

    def __init__(self, sizes: np.ndarray):
        n = len(sizes)
        self.clustersizes = sizes.astype(np.int64).copy()
        max_size = int(sizes.max()) if n else 0
        abundance = np.bincount(sizes, minlength=max_size + 1)
        self.borders = np.zeros(max_size + 1, dtype=np.int64)
        np.cumsum(abundance[:-1], out=self.borders[1:])
        self.sorted = np.full(n + 1, -1, dtype=np.int64)
        self.pos_of = np.full(n + 1, -1, dtype=np.int64)
        fill = np.zeros(max_size + 1, dtype=np.int64)
        for i in range(n):
            p = self.borders[sizes[i]] + fill[sizes[i]]
            self.sorted[p] = i
            self.pos_of[i] = p
            fill[sizes[i]] += 1

    def remove(self, cid: int):
        self.clustersizes[cid] = 0
        self.sorted[self.pos_of[cid]] = -1
        self.pos_of[cid] = -1

    def decrease(self, cid: int):
        old_pos = self.pos_of[cid]
        new_pos = self.borders[self.clustersizes[cid]]
        swap_id = self.sorted[new_pos]
        if swap_id != -1:
            self.pos_of[swap_id] = old_pos
        self.sorted[old_pos] = swap_id
        self.sorted[new_pos] = cid
        self.pos_of[cid] = new_pos
        self.borders[self.clustersizes[cid]] += 1
        self.clustersizes[cid] -= 1


def _set_cover(adj, scores, sizes, assigned):
    n = len(adj)
    buckets = _SizeBuckets(sizes)
    best = np.full(n, SHRT_MIN, dtype=np.int64)
    clustersizes = buckets.clustersizes
    for pos in range(n - 1, -1, -1):
        rep = buckets.sorted[pos]
        if rep == -1:
            continue
        buckets.remove(rep)
        assigned[rep] = rep
        members = adj[rep]
        # setCover reads the unsigned-short score through a signed short
        # (`const short seqId`, ClusteringAlgorithms.cpp:228), so e.g. the
        # 65535 self-score of an empty prefilter entry compares as -1.
        mscores = [s - 65536 if s > 32767 else s for s in scores[rep]]
        for j, elem in enumerate(members):
            if mscores[j] > best[elem]:
                assigned[elem] = rep
                best[elem] = mscores[j]
            if elem == rep:
                continue
            if clustersizes[elem] < 1:
                continue
            buckets.remove(elem)
        for elem in members:
            if elem == rep:
                clustersizes[elem] = -1
                continue
            if clustersizes[elem] < 0:
                continue
            clustersizes[elem] = -1
            for other in adj[elem]:
                if clustersizes[other] > 0:
                    buckets.decrease(other)


def _connected_component(adj, sizes, assigned, max_iterations):
    from collections import deque
    n = len(adj)
    buckets = _SizeBuckets(sizes)
    for pos in range(n - 1, -1, -1):
        rep = buckets.sorted[pos]
        if rep == -1 or assigned[rep] != -1:
            continue
        assigned[rep] = rep
        queue = deque([(rep, 0)])
        while queue:
            curr, depth = queue.popleft()
            assigned[curr] = rep
            for elem in adj[curr]:
                if assigned[elem] == -1 and depth < max_iterations:
                    queue.append((elem, depth + 1))
                assigned[elem] = rep


def _greedy_incremental(ordered_keys, key_to_internal, edges, assigned):
    """greedyIncrementalLowMem: iterate length-descending; unassigned entries
    with >1 result lines claim their unassigned members."""
    n = len(ordered_keys)
    for i in range(n):
        if assigned[i] != -1:
            continue
        lines = edges.get(int(ordered_keys[i]), [])
        if len(lines) <= 1:
            continue
        for e in lines:
            elem = key_to_internal[int(e.target_key)]
            if assigned[elem] == -1:
                assigned[elem] = i
    for i in range(n):
        if assigned[i] == -1:
            assigned[i] = i


def pairs_to_clusters(pairs: List[Tuple[int, int]]) -> Dict[int, List[int]]:
    """Group sorted (rep, member) pairs, rep first in member list
    (Clustering::writeData: rep key line, then members != rep)."""
    out: Dict[int, List[int]] = {}
    for rep, member in pairs:
        if rep not in out:
            out[rep] = [rep]
        if member != rep:
            out[rep].append(member)
    return out
