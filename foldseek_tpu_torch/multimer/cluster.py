"""Multimer (complex-level) clustering — multimercluster / easy-multimercluster
(reference: src/workflow/MultimerCluster.cpp, data/multimercluster.sh,
data/easymultimercluster.sh).

Pipeline: filtered multimersearch (multimer-tm 0.7, chain-tm 0.7,
interface-lddt 0.3 defaults) -> set-mode clustering: every complex is one
set whose edges are the union of its chains' scorecomplex hits mapped to
target complexes (Clustering needSET path, Clustering.cpp:42-165).

Copy of `foldseek_tpu/multimer/cluster.py`; the multimer search runs on the
torch device the caller names.
"""
from __future__ import annotations

import os
from dataclasses import replace
from typing import Dict, List

import torch

from ..cluster.clust import (AlnEdge, APC_SEQID, MODE_SET_COVER, cluster,
                             pairs_to_clusters, score_from_alignment_line)
from ..db.storage import StructDB
from ..search.params import SearchParams
from ..search.pipeline import ensure_db
from ..utils.log import logger
from .filter import MultimerFilterParams
from .report import split_complex_chain
from .scoremultimer import complex_maps
from .workflow import multimer_search


def default_filter_params(cov_thr: float = 0.0, cov_mode: int = 0) -> MultimerFilterParams:
    """setMultimerClusterDefaults + mustsetMultimerCluster
    (MultimerCluster.cpp:10-22)."""
    return MultimerFilterParams(
        mult_tm_thr=0.7, chain_tm_thr=0.7, interface_lddt_thr=0.3,
        cov_thr=cov_thr, cov_mode=cov_mode)


def cluster_complexes(db: StructDB,
                      score_results: Dict[int, List[str]],
                      mode: int = MODE_SET_COVER) -> Dict[int, List[int]]:
    """Set-mode clust: returns rep complex id -> member complex ids."""
    chain_to_complex, complex_chains, complex_order = complex_maps(db)
    key_to_idx = db.key_to_index()
    lengths = {}
    edges: Dict[int, List[AlnEdge]] = {}
    for cid in complex_order:
        lengths[cid] = sum(db.entry_len(key_to_idx[k])
                           for k in complex_chains[cid])
        lines: List[AlnEdge] = []
        for k in complex_chains[cid]:
            for line in score_results.get(k, []):
                cols = line.split("\t")
                t_complex = chain_to_complex.get(int(cols[0]))
                if t_complex is None:
                    continue
                lines.append(AlnEdge(
                    t_complex,
                    score_from_alignment_line(int(cols[1]), cols[2], APC_SEQID)))
        if lines:
            edges[cid] = lines
    cids = sorted(lengths)
    pairs = cluster(cids, [lengths[c] for c in cids], edges, mode)
    return pairs_to_clusters(pairs)


def multimer_cluster(db: StructDB, params: SearchParams,
                     device: torch.device,
                     filter_params: MultimerFilterParams = None,
                     tmp_dir: str = "") -> Dict[int, List[int]]:
    if filter_params is None:
        filter_params = default_filter_params(params.cov_thr, params.cov_mode)
    score_results = multimer_search(db, db, params, device,
                                    filter_params=filter_params,
                                    tmp_dir=tmp_dir)
    return cluster_complexes(db, score_results)


def complex_name(db: StructDB, cid: int, complex_chains) -> str:
    """Complex name = source file name (the reference's .source lookup);
    falls back to stripping the chain suffix from the first chain name."""
    if db.sources is not None and cid < len(db.sources):
        return db.sources[cid]
    first = complex_chains[cid][0]
    idx = db.key_to_index()[first]
    name, _ = split_complex_chain(db.names[idx])
    return name


def easy_multimer_cluster(input_path: str, output_prefix: str, tmp_dir: str,
                          params: SearchParams, device: torch.device,
                          filter_params: MultimerFilterParams = None) -> Dict[int, List[int]]:
    """createdb -> multimercluster -> cluster.tsv + rep fasta
    (data/easymultimercluster.sh:105-131)."""
    os.makedirs(tmp_dir, exist_ok=True)
    db = ensure_db(input_path, tmp_dir, "query")
    clusters = multimer_cluster(db, params, device, filter_params,
                                tmp_dir=tmp_dir)
    _, complex_chains, _ = complex_maps(db)
    key_to_idx = db.key_to_index()

    with open(output_prefix + "_cluster.tsv", "w") as f:
        for rep in sorted(clusters):
            rname = complex_name(db, rep, complex_chains)
            for m in clusters[rep]:
                f.write(f"{rname}\t{complex_name(db, m, complex_chains)}\n")

    # rep fasta: '#complex' separator then each chain's record
    # (postprocessFasta, easymultimercluster.sh:66-86)
    with open(output_prefix + "_rep_seq.fasta", "w") as f:
        for rep in sorted(clusters):
            f.write(f"#{complex_name(db, rep, complex_chains)}\n")
            for k in complex_chains[rep]:
                i = key_to_idx[k]
                f.write(f">{db.headers[i]}\n{db.get_aa_str(i)}\n")
    logger.info("easy-multimercluster: %d complexes -> %d clusters",
                len(complex_chains), len(clusters))
    return clusters
