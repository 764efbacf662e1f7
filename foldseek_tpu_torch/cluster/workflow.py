"""Cascaded structure clustering — the `cluster` / `easy-cluster` verbs.

Mirrors the reference workflow (reference: src/workflow/StructureCluster.cpp,
data/structurecluster.sh, lib/mmseqs/data/workflow/easycluster.sh) as an
in-process stage graph:

  linclust stage:  kmermatcher -> structurerescorediagonal -> clust ->
                   filter prefilter to pre-cluster reps -> structurealign ->
                   clust -> mergeclusters
  cascade:         3 search+clust steps at sensitivities 1 -> (1+s)/2 -> s
                   over shrinking representative sets, merged at the end

Parameter schedule ported from setStructureClusterWorkflowDefaults /
setStructuralClusterAutomagicParameters (StructureCluster.cpp:11-79):
cov 0.8, e-value 0.01, no structure-bit sorting, no composition bias,
sensitivity from --min-seq-id (8.0 at the 0.0 default), set-cover clustering.

Copy of `foldseek_tpu/cluster/workflow.py` for one process: every align
stage (the lin stage and each cascade step) is `align_all` on the torch
device the caller names, so the SW kernel scores its pairs on a card. The
query-sharded multi-process align branch is not ported (the world size is
1; `torch.distributed` is ROADMAP queue 1, distribution), so the stage cache is
always on when a tmp dir is given.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..db.storage import StructDB, load_db
from ..search.align import align_all
from ..search.kmer import kmer_prefilter
from ..search.params import INT_MAX, SearchParams
from ..search.results import format_seq_id
from ..utils.log import Timer, logger
from . import clust as clust_mod
from .clust import AlnEdge, MODE_SET_COVER, cluster as run_clust, pairs_to_clusters
from .kmermatcher import KmerMatcherParams, kmermatcher
from .rescorediagonal import rescore_all


@dataclass
class ClusterParams:
    cov_thr: float = 0.8
    cov_mode: int = 0
    evalue_thr: float = 0.01
    seq_id_thr: float = 0.0
    sensitivity: float = 0.0      # 0 = auto from seq_id_thr
    cluster_steps: int = 3
    cluster_mode: int = -1        # -1 = auto (set-cover for symmetric cov)
    single_step: bool = False
    kmers_per_sequence: int = 300
    spaced_kmer: bool = True
    alignment_type: int = 2
    max_res_list_len: int = 1000
    max_iterations: int = 1000
    kmer_size: int = 0


def auto_sensitivity(seq_id_thr: float) -> float:
    """setAutomaticStructureClusterThreshold (StructureCluster.cpp:23-33)."""
    if seq_id_thr <= 0.3:
        return 8.0
    if seq_id_thr > 0.8:
        return 1.0
    return 1.0 + (1.0 * (0.7 - seq_id_thr) * 10)


def _align_params(p: ClusterParams) -> SearchParams:
    return SearchParams(
        alignment_type=p.alignment_type,
        evalue_thr=p.evalue_thr, seq_id_thr=p.seq_id_thr,
        cov_thr=p.cov_thr, cov_mode=p.cov_mode,
        comp_bias_correction=False,
        sort_by_structure_bits=False,
        max_seqs=p.max_res_list_len,
        include_identity=False,
        add_backtrace=False)


def _edges_from_alignments(results) -> Dict[int, List[AlnEdge]]:
    """Alignment results -> clust edges with APC_SEQID scores (the atof
    round-trip goes through the 3-decimal formatted string)."""
    edges: Dict[int, List[AlnEdge]] = {}
    for qkey, rs in results.items():
        if rs:
            edges[int(qkey)] = [
                AlnEdge(r.db_key,
                        clust_mod.score_from_alignment_line(
                            r.score, format_seq_id(r.seq_id), clust_mod.APC_SEQID))
                for r in rs]
    return edges


def _subdb_view(db: StructDB, keys: Sequence[int]) -> StructDB:
    """createsubdb --subdb-mode 1 equivalent: a key-subset view. Entry order
    follows ascending key like a DBReader over the subset index."""
    keyset = set(int(k) for k in keys)
    idx = [i for i in range(db.size) if int(db.keys[i]) in keyset]
    idx.sort(key=lambda i: int(db.keys[i]))
    sub_offsets = np.zeros(len(idx) + 1, dtype=np.int64)
    parts_aa, parts_ss, parts_mask, parts_ca = [], [], [], []
    names, headers, keys_out = [], [], []
    total = 0
    for j, i in enumerate(idx):
        s, e = int(db.offsets[i]), int(db.offsets[i + 1])
        parts_aa.append(db.aa[s:e]); parts_ss.append(db.ss[s:e])
        parts_mask.append(db.mask[s:e])
        if db.ca is not None:
            parts_ca.append(db.ca[s:e])
        total += e - s
        sub_offsets[j + 1] = total
        names.append(db.names[i]); headers.append(db.headers[i])
        keys_out.append(int(db.keys[i]))
    return StructDB(
        path=db.path,
        aa=np.concatenate(parts_aa) if idx else np.zeros(0, np.int8),
        ss=np.concatenate(parts_ss) if idx else np.zeros(0, np.int8),
        mask=np.concatenate(parts_mask) if idx else np.zeros(0, np.uint8),
        ca=(np.concatenate(parts_ca) if parts_ca else None),
        offsets=sub_offsets, keys=np.asarray(keys_out, dtype=np.uint32),
        names=names, headers=headers)


def merge_clusters(all_keys: Sequence[int],
                   steps: List[List[Tuple[int, int]]]) -> Dict[int, List[int]]:
    """mergeclusters (lib/mmseqs/src/util/mergeclusters.cpp): compose
    cascaded clusterings; each step's clusters splice their members'
    accumulated lists."""
    lists: Dict[int, List[int]] = {int(k): [] for k in all_keys}
    first = pairs_to_clusters(steps[0])
    for rep, members in first.items():
        lists[rep] = list(members)
    for pairs in steps[1:]:
        clusters = pairs_to_clusters(pairs)
        for rep, members in clusters.items():
            for m in members:
                if m != rep:
                    lists[rep].extend(lists[m])
                    lists[m] = []
    return {k: v for k, v in lists.items() if v}


def cluster_db(db: StructDB, params: ClusterParams, device: torch.device,
               tmp_dir: str = "") -> Dict[int, List[int]]:
    """Full cascaded clustering; returns repKey -> ordered member keys
    (rep first). With a tmp_dir, each clustering step's pair list is
    persisted under a param-hashed stage dir and a re-invoked run resumes
    after the last completed step (data/structurecluster.sh's notExists
    guards). The align stages run on `device`."""
    from ..search.stages import make_cache
    p = params
    cache = make_cache(tmp_dir, params, db)

    def _step_pairs(name, fn) -> List[Tuple[int, int]]:
        if cache is None:
            return fn()
        pairs = cache.run_json(name, fn)
        return [(int(a), int(b)) for a, b in pairs]
    sens = p.sensitivity if p.sensitivity > 0 else auto_sensitivity(p.seq_id_thr)
    mode = p.cluster_mode if p.cluster_mode >= 0 else MODE_SET_COVER
    keys = [int(k) for k in db.keys]
    lens = db.lengths()
    align_par = _align_params(p)

    # ---- linclust stage (structurecluster.sh:55-130) ----
    def run_pre_pairs():
        logger.info("cluster: linclust stage (kmermatcher + diagonal rescore)")
        km_par = KmerMatcherParams(
            kmer_size=p.kmer_size, kmers_per_sequence=p.kmers_per_sequence,
            spaced_kmer=p.spaced_kmer, cov_thr=p.cov_thr, cov_mode=p.cov_mode,
            seq_id_thr=p.seq_id_thr)
        with Timer("cluster kmermatcher"):
            pref = kmermatcher(db, km_par)
        rescore_par = replace(align_par, include_identity=True)
        hits = {k: [(t, d) for (t, _s, d) in lines] for k, lines in pref.items()}
        with Timer("cluster rescorediagonal"):
            rescored = rescore_all(db, db, hits, rescore_par, same_db=True)
        with Timer("cluster clust pre"):
            pairs = run_clust(keys, lens, _edges_from_alignments(rescored),
                              mode, p.max_iterations)
        # stash the kmermatcher hit lists for the lin stage (avoids a rerun
        # when both stages compute in one invocation)
        run_pre_pairs.pref = pref
        return pairs
    pre_pairs = _step_pairs("clu_pre", run_pre_pairs)
    pre_clusters = pairs_to_clusters(pre_pairs)
    reps = sorted(pre_clusters.keys())
    logger.info("cluster: %d pre-clusters from %d entries", len(reps), db.size)

    def run_lin_pairs():
        pref = getattr(run_pre_pairs, "pref", None)
        if pref is None:  # resumed past the pre stage: recompute hit lists
            km_par = KmerMatcherParams(
                kmer_size=p.kmer_size, kmers_per_sequence=p.kmers_per_sequence,
                spaced_kmer=p.spaced_kmer, cov_thr=p.cov_thr,
                cov_mode=p.cov_mode, seq_id_thr=p.seq_id_thr)
            with Timer("cluster kmermatcher"):
                pref = kmermatcher(db, km_par)
        repset = set(reps)
        pref_filtered = {r: [t for t in (line[0] for line in pref.get(r, []))
                             if t in repset]
                         for r in reps}
        # the reference's lin-stage structurealign runs over the FULL input
        # DB with the prefilter list restricted to reps
        # (structurecluster.sh aln.linclust: "$INPUT" "$INPUT" pref_filter2)
        # — E-values normalize by the full DB's residues, which decides
        # edges sitting at the E gate; only the cascade steps align subset
        # DBs (input_step_redundancy)
        with Timer("cluster lin align"):
            aln = align_all(db, db, pref_filtered, replace(align_par), device,
                            same_db=True)
        sub = _subdb_view(db, reps)
        with Timer("cluster clust lin"):
            return run_clust([int(k) for k in sub.keys], sub.lengths(),
                             _edges_from_alignments(aln), mode,
                             p.max_iterations)
    lin_pairs = _step_pairs("clu_lin", run_lin_pairs)
    merged_steps = [pre_pairs, lin_pairs]

    if not p.single_step:
        # ---- cascade (StructureCluster.cpp:132-177) ----
        clu_red = merge_clusters(keys, merged_steps)
        cur_keys = sorted(clu_red.keys())
        step_pairs: List[List[Tuple[int, int]]] = []
        steps = p.cluster_steps
        sens_step = (sens - 1.0) / (steps - 1) if steps > 1 else 0.0
        for step in range(steps):
            s = sens if steps == 1 else (1.0 + sens_step * step)
            if step == steps - 1:
                max_res = p.max_res_list_len
            elif step == 0:
                max_res = p.max_res_list_len // 10
            else:
                max_res = p.max_res_list_len // (10 // (step + 1))

            def run_step(s=s, max_res=max_res, step=step,
                         cur_keys=cur_keys) -> List[Tuple[int, int]]:
                logger.info(
                    "cluster: cascade step %d sens=%.2f max-seqs=%d over %d reps",
                    step, s, max_res, len(cur_keys))
                sdb = _subdb_view(db, cur_keys)
                spar = replace(align_par, sensitivity=s, max_seqs=max_res)
                # step 0 runs without diagonal score gating, later steps
                # restore the default --min-ungapped-score 15
                # (StructureCluster.cpp:146-160). (A device-gapless
                # cascade prefilter was measured in foldseek_tpu and
                # rejected: the
                # reference's cluster workflow has no GPU path, and
                # top-k-without-threshold candidates change the edge set
                # — 553 vs 1736/1743 clusters at 20k — while the extra
                # align volume made it slower, not faster.)
                with Timer(f"cluster step{step} kmer prefilter"):
                    pref_step = kmer_prefilter(
                        sdb, sdb, spar, min_diag_score=0 if step == 0 else 15)
                with Timer(f"cluster step{step} align"):
                    aln_step = align_all(sdb, sdb, pref_step, spar, device,
                                         same_db=True)
                with Timer(f"cluster step{step} clust"):
                    return run_clust([int(k) for k in sdb.keys],
                                     sdb.lengths(),
                                     _edges_from_alignments(aln_step), mode,
                                     p.max_iterations)
            pairs = _step_pairs(f"clu_step{step}", run_step)
            step_pairs.append(pairs)
            cur_keys = sorted(pairs_to_clusters(pairs).keys())
        return merge_clusters(keys, [pre_pairs, lin_pairs] + step_pairs)

    return merge_clusters(keys, merged_steps)


def write_cluster_tsv(db: StructDB, clusters: Dict[int, List[int]], path: str):
    """createtsv equivalent: repName<TAB>memberName per member, clusters in
    key-ascending order (easycluster.sh:24-27)."""
    key_to_name = {int(k): db.names[i] for i, k in enumerate(db.keys)}
    with open(path, "w") as f:
        for rep in sorted(clusters.keys()):
            rname = key_to_name[rep]
            for m in clusters[rep]:
                f.write(f"{rname}\t{key_to_name[m]}\n")


def write_rep_fasta(db: StructDB, clusters: Dict[int, List[int]], path: str):
    """result2repseq + result2flat --use-fasta-header: full header (trailing
    newline turned into a space) + AA sequence per representative."""
    key_to_idx = db.key_to_index()
    with open(path, "w") as f:
        for rep in sorted(clusters.keys()):
            i = key_to_idx[rep]
            f.write(f">{db.headers[i]} \n")
            f.write(db.get_aa_str(i) + "\n")


def write_all_seqs_fasta(db: StructDB, clusters: Dict[int, List[int]], path: str):
    """createseqfiledb + result2flat: per cluster a '>repName ' separator
    line followed by every member's fasta record. The trailing space is
    the reference's quirk — result2flat turns the rep header's newline
    into a space (result2flat.cpp; byte-compared against the binary)."""
    key_to_idx = db.key_to_index()
    with open(path, "w") as f:
        for rep in sorted(clusters.keys()):
            f.write(f">{db.names[key_to_idx[rep]]} \n")
            for m in clusters[rep]:
                i = key_to_idx[m]
                f.write(f">{db.headers[i]}\n")
                f.write(db.get_aa_str(i) + "\n")
