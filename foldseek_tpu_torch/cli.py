"""Command line of the port.

Usage: python -m foldseek_tpu_torch <command> [args...]

The commands are those of `foldseek_tpu`'s command line that the port
covers: searches (easy-search, search, also with --cluster-search 1),
clustering (cluster, easy-cluster, createclusearchdb), reciprocal best hits
(rbh, easy-rbh) and complexes (multimersearch, easy-multimersearch,
multimercluster, easy-multimercluster and the complexsearch aliases).
Flags, defaults and output bytes are those of `foldseek_tpu`'s verbs;
`--gpu 1` selects the ungapped prefilter as in the reference's GPU mode and
`--prefilter-mode 3` the ungapped + gapped mode that exists only on a GPU.
`--device` picks where the stages run: `cuda` (the CUDA kernels, the
default) or `cpu` (their plain PyTorch versions).
"""
from __future__ import annotations

import argparse
import os
import sys

from .device import get_device
from .search.params import SearchParams
from .utils.log import logger, set_verbosity


def _add_search_params(p: argparse.ArgumentParser):
    p.add_argument("-e", "--evalue", type=float, default=10.0,
                   help="E-value threshold (default 10)")
    p.add_argument("-s", "--sensitivity", type=float, default=9.5)
    p.add_argument("-k", "--kmer-size", dest="kmer_size", type=int,
                   default=0, help="k-mer size (0 = auto)")
    p.add_argument("--max-seqs", type=int, default=1000)
    p.add_argument("-c", "--cov", dest="cov_thr", type=float, default=0.0)
    p.add_argument("--cov-mode", type=int, default=0)
    p.add_argument("--min-seq-id", dest="seq_id_thr", type=float, default=0.0)
    p.add_argument("--min-aln-len", dest="aln_len_thr", type=int, default=0)
    p.add_argument("--alignment-type", type=int, default=2,
                   help="0: 3Di, 1: TM-align, 2: 3Di+AA, 3: LoLalign")
    p.add_argument("--e-profile", dest="e_profile", type=float, default=-1.0,
                   help="e-value gate of non-final profile iterations")
    p.add_argument("--tmscore-threshold", type=float, default=0.0)
    p.add_argument("--tmscore-threshold-mode", type=int, default=0)
    p.add_argument("--lddt-threshold", type=float, default=0.0)
    p.add_argument("--sort-by-structure-bits", type=int, default=1)
    p.add_argument("--exhaustive-search", type=int, default=0)
    p.add_argument("--prefilter-mode", type=int, default=0,
                   help="0: kmer, 1: ungapped, 2: exhaustive, 3: ungapped + "
                        "gapped (alignment results without the align "
                        "stage)")
    p.add_argument("--gpu", type=int, default=0,
                   help="1: accelerated path — forces the ungapped device "
                        "prefilter like the reference's GPU mode "
                        "(StructureSearch.cpp:110-112)")
    p.add_argument("--comp-bias-corr", type=int, default=1)
    p.add_argument("--exact-tmscore", type=int, default=0)
    p.add_argument("--gap-open", type=int, default=10)
    p.add_argument("--gap-extend", type=int, default=1)
    p.add_argument("--format-output", type=str,
                   default=("query,target,fident,alnlen,mismatch,gapopen,"
                            "qstart,qend,tstart,tend,evalue,bits"))
    p.add_argument("--format-mode", type=int, default=0)
    p.add_argument("-a", dest="add_backtrace", action="store_true")
    p.add_argument("--max-accept", type=int, default=2**31 - 1)
    p.add_argument("--max-rejected", type=int, default=2**31 - 1)
    p.add_argument("--alt-ali", dest="alt_alignment", type=int, default=0)
    p.add_argument("--num-iterations", type=int, default=1)
    p.add_argument("--cluster-search", type=int, default=0,
                   help="1: search cluster reps, expand hits to members")
    p.add_argument("--index-server", type=str, default="")
    p.add_argument("--profile-dir", type=str, default="",
                   help="write a profiler trace of the run to this dir "
                        "(not ported)")
    p.add_argument("--threads", type=int, default=0,
                   help="host worker threads (0 = all cores; reference"
                        " PARAM_THREADS default)")
    p.add_argument("--tmalign-hit-order", type=int, default=0,
                   help="0: (qTM+tTM)/2, 1: qTM, 2: tTM, 3: min, 4: max")
    p.add_argument("--tmalign-fast", type=int, default=1)
    p.add_argument("--add-self-matches", action="store_true",
                   help="artificially add self hits (for clustering;"
                        " Parameters.cpp PARAM_INCLUDE_IDENTITY)")
    p.add_argument("-v", "--verbosity", type=int, default=3)


def params_from_args(args) -> SearchParams:
    if getattr(args, "threads", 0):
        from .utils.hostpar import set_threads
        set_threads(args.threads)
    try:
        return _params_from_args(args).validate()
    except ValueError as e:
        raise SystemExit(f"{e}")


def _params_from_args(args) -> SearchParams:
    return SearchParams(
        evalue_thr=args.evalue, sensitivity=args.sensitivity,
        kmer_size=getattr(args, "kmer_size", 0),
        e_profile=getattr(args, "e_profile", -1.0),
        max_seqs=args.max_seqs, cov_thr=args.cov_thr, cov_mode=args.cov_mode,
        aln_len_thr=getattr(args, "aln_len_thr", 0),
        seq_id_thr=args.seq_id_thr, alignment_type=args.alignment_type,
        tmscore_threshold=args.tmscore_threshold,
        tmscore_threshold_mode=args.tmscore_threshold_mode,
        lddt_threshold=args.lddt_threshold,
        sort_by_structure_bits=bool(args.sort_by_structure_bits),
        exhaustive_search=bool(args.exhaustive_search),
        cluster_search=getattr(args, "cluster_search", 0),
        prefilter_mode=(1 if (getattr(args, "gpu", 0)
                              and args.prefilter_mode == 0)
                        else args.prefilter_mode),
        comp_bias_correction=bool(args.comp_bias_corr),
        exact_tmscore=bool(args.exact_tmscore),
        gap_open=args.gap_open, gap_extend=args.gap_extend,
        format_output=args.format_output, format_mode=args.format_mode,
        add_backtrace=args.add_backtrace,
        max_accept=args.max_accept, max_rejected=args.max_rejected,
        alt_alignment=args.alt_alignment,
        num_iterations=args.num_iterations, index_server=args.index_server,
        threads=args.threads,
        tmalign_hit_order=getattr(args, "tmalign_hit_order", 0),
        tmalign_fast=bool(getattr(args, "tmalign_fast", 1)),
        include_identity=bool(getattr(args, "add_self_matches", False)),
    )


def _add_device(p: argparse.ArgumentParser):
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default), cuda:N, or cpu (the "
                        "kernels' plain PyTorch versions)")


def _parser(prog: str, positionals) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=f"foldseek_tpu_torch {prog}")
    for name in positionals:
        p.add_argument(name)
    _add_search_params(p)
    _add_device(p)
    return p


def _parse(p: argparse.ArgumentParser, argv):
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    if args.profile_dir:
        raise NotImplementedError(
            "--profile-dir (a jax.profiler trace) is not ported; ROADMAP "
            "queue 1 names torch.profiler as its replacement")
    return args, params_from_args(args), get_device(args.device)


def cmd_easy_search(argv) -> int:
    from .search.pipeline import easy_search
    args, params, device = _parse(
        _parser("easy-search", ("query", "target", "output", "tmp_dir")), argv)
    easy_search(args.query, args.target, args.output, args.tmp_dir, params,
                device)
    return 0


def cmd_search(argv) -> int:
    from .db.storage import load_db
    from .search.pipeline import iterative_search, profile_search, search
    from .search.profile import is_profile_db, load_profile_db
    from .search.resultdb import write_result_db
    args, params, device = _parse(
        _parser("search", ("query_db", "target_db", "result", "tmp_dir")),
        argv)
    if is_profile_db(args.query_db):
        # profile-vs-sequence search (query side = result2profile output)
        results = profile_search(load_profile_db(args.query_db),
                                 load_db(args.target_db), params, device)
        write_result_db(results, args.result,
                        add_backtrace=params.add_backtrace)
        return 0
    qdb = load_db(args.query_db)
    tdb = qdb if args.target_db == args.query_db else load_db(args.target_db)
    os.makedirs(args.tmp_dir, exist_ok=True)
    if params.num_iterations > 1:
        # the iterative workflow always aligns with -a
        # (StructureSearch.cpp:178)
        params.add_backtrace = True
        results = iterative_search(qdb, tdb, params, params.num_iterations,
                                   device, tmp_dir=args.tmp_dir)
    else:
        results = search(qdb, tdb, params, device, tmp_dir=args.tmp_dir)
    write_result_db(results, args.result, add_backtrace=params.add_backtrace)
    return 0


def _add_cluster_params(p: argparse.ArgumentParser):
    p.add_argument("-c", "--cov", dest="cov_thr", type=float, default=0.8)
    p.add_argument("--cov-mode", type=int, default=0)
    p.add_argument("-e", "--evalue", type=float, default=0.01)
    p.add_argument("--min-seq-id", dest="seq_id_thr", type=float, default=0.0)
    p.add_argument("-s", "--sensitivity", type=float, default=0.0,
                   help="0 = auto from --min-seq-id")
    p.add_argument("--cluster-steps", type=int, default=3)
    p.add_argument("--cluster-mode", type=int, default=-1,
                   help="-1 auto, 0 set-cover, 1 connected-component, 2/3 greedy")
    p.add_argument("--single-step-clustering", action="store_true")
    p.add_argument("--kmer-per-seq", type=int, default=300)
    p.add_argument("--alignment-type", type=int, default=2)
    p.add_argument("--max-seqs", type=int, default=1000)
    p.add_argument("-k", "--kmer-size", type=int, default=0)
    p.add_argument("-v", "--verbosity", type=int, default=3)
    _add_device(p)


def _parse_cluster(prog: str, positionals, argv):
    from .cluster.workflow import ClusterParams
    p = argparse.ArgumentParser(prog=f"foldseek_tpu_torch {prog}")
    for name, kw in positionals:
        p.add_argument(name, **kw)
    _add_cluster_params(p)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    params = ClusterParams(
        cov_thr=args.cov_thr, cov_mode=args.cov_mode, evalue_thr=args.evalue,
        seq_id_thr=args.seq_id_thr, sensitivity=args.sensitivity,
        cluster_steps=args.cluster_steps, cluster_mode=args.cluster_mode,
        single_step=args.single_step_clustering,
        kmers_per_sequence=args.kmer_per_seq,
        alignment_type=args.alignment_type,
        max_res_list_len=args.max_seqs, kmer_size=args.kmer_size)
    return args, params, get_device(args.device)


def cmd_cluster(argv) -> int:
    import json

    from .cluster.workflow import cluster_db
    from .db.storage import load_db
    args, params, device = _parse_cluster(
        "cluster", (("input_db", {}), ("output_db", {}), ("tmp_dir", {})),
        argv)
    db = load_db(args.input_db)
    os.makedirs(args.tmp_dir, exist_ok=True)
    clusters = cluster_db(db, params, device, tmp_dir=args.tmp_dir)
    with open(args.output_db, "w") as f:
        json.dump({str(k): v for k, v in sorted(clusters.items())}, f)
    logger.info("clustered %d entries into %d clusters", db.size, len(clusters))
    return 0


def cmd_easy_cluster(argv) -> int:
    from .cluster.workflow import (cluster_db, write_all_seqs_fasta,
                                   write_cluster_tsv, write_rep_fasta)
    from .db import create_db, is_db, load_db
    args, params, device = _parse_cluster(
        "easy-cluster", (("inputs", dict(nargs="+")), ("output_prefix", {}),
                         ("tmp_dir", {})), argv)
    os.makedirs(args.tmp_dir, exist_ok=True)
    db_path = os.path.join(args.tmp_dir, "input_db")
    if len(args.inputs) == 1 and is_db(args.inputs[0]):
        db = load_db(args.inputs[0])
    else:
        create_db(args.inputs, db_path)
        db = load_db(db_path)
    clusters = cluster_db(db, params, device, tmp_dir=args.tmp_dir)
    write_cluster_tsv(db, clusters, args.output_prefix + "_cluster.tsv")
    write_rep_fasta(db, clusters, args.output_prefix + "_rep_seq.fasta")
    write_all_seqs_fasta(db, clusters, args.output_prefix + "_all_seqs.fasta")
    logger.info("easy-cluster: %d clusters -> %s_{cluster.tsv,rep_seq.fasta,all_seqs.fasta}",
                len(clusters), args.output_prefix)
    return 0


def cmd_createclusearchdb(argv) -> int:
    """Representatives + _seq + _clu triple for --cluster-search
    (reference: lib/mmseqs/src/util/createclusterdb.cpp). Host work only: it
    takes no --device."""
    from .db.storage import load_db
    from .search.clusearch import create_clusearch_db
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch createclusearchdb")
    p.add_argument("sequence_db")
    p.add_argument("cluster_tsv", help="cluster result: rep\\tmember lines "
                   "(names or keys), e.g. easy-cluster's _cluster.tsv")
    p.add_argument("output_db")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    db = load_db(args.sequence_db)
    name_to_key = {db.names[i]: int(db.keys[i]) for i in range(db.size)}

    def resolve(tok: str) -> int:
        if tok in name_to_key:
            return name_to_key[tok]
        return int(tok)

    clusters = {}
    for line in open(args.cluster_tsv):
        r, m = line.rstrip("\n").split("\t")[:2]
        clusters.setdefault(resolve(r), []).append(resolve(m))
    create_clusearch_db(db, clusters, args.output_db)
    return 0


def cmd_rbh(argv) -> int:
    from .db.storage import load_db
    from .search.rbh import rbh
    from .search.resultdb import write_result_db
    args, params, device = _parse(
        _parser("rbh", ("query_db", "target_db", "aln_db", "tmp_dir")), argv)
    results = rbh(load_db(args.query_db), load_db(args.target_db), params,
                  device)
    write_result_db(results, args.aln_db, add_backtrace=False)
    return 0


def cmd_easy_rbh(argv) -> int:
    from .search.rbh import easy_rbh
    args, params, device = _parse(
        _parser("easy-rbh", ("query", "target", "output", "tmp_dir")), argv)
    easy_rbh(args.query, args.target, args.output, args.tmp_dir, params,
             device)
    return 0


def write_complex_db(lines, path: str):
    """The complexres DB of multimersearch: a `#foldseek-tpu complexres v1`
    header, then `qkey\\t<scorecomplex cols>` lines by query key."""
    with open(path, "w") as f:
        f.write("#foldseek-tpu complexres v1\n")
        for qkey in sorted(lines):
            for line in lines[qkey]:
                f.write(f"{qkey}\t{line}\n")


def cmd_multimersearch(argv) -> int:
    from .db.storage import load_db
    from .multimer.workflow import multimer_search
    args, params, device = _parse(
        _parser("multimersearch",
                ("query_db", "target_db", "result_db", "tmp_dir")), argv)
    qdb = load_db(args.query_db)
    tdb = qdb if args.target_db == args.query_db else load_db(args.target_db)
    write_complex_db(multimer_search(qdb, tdb, params, device,
                                     tmp_dir=args.tmp_dir), args.result_db)
    return 0


def cmd_easy_multimersearch(argv) -> int:
    from .multimer.workflow import easy_multimer_search
    args, params, device = _parse(
        _parser("easy-multimersearch",
                ("query", "target", "output_prefix", "tmp_dir")), argv)
    easy_multimer_search(args.query, args.target, args.output_prefix,
                         args.tmp_dir, params, device)
    return 0


def _multimer_cluster_parser(prog: str, positionals):
    p = _parser(prog, positionals)
    p.add_argument("--multimer-tm-threshold", type=float, default=0.7)
    p.add_argument("--chain-tm-threshold", type=float, default=0.7)
    p.add_argument("--interface-lddt-threshold", type=float, default=0.3)
    return p


def _multimer_filter_params(args):
    from .multimer.filter import MultimerFilterParams
    fp = MultimerFilterParams(
        mult_tm_thr=args.multimer_tm_threshold,
        chain_tm_thr=args.chain_tm_threshold,
        interface_lddt_thr=args.interface_lddt_threshold,
        cov_thr=args.cov_thr, cov_mode=args.cov_mode)
    if fp.mult_tm_thr + fp.chain_tm_thr + fp.interface_lddt_thr == 0:
        fp.mult_tm_thr = 0.0001  # mustsetMultimerCluster (MultimerCluster.cpp:19-21)
    return fp


def cmd_multimercluster(argv) -> int:
    """multimercluster on a prebuilt DB (reference:
    src/workflow/MultimerCluster.cpp; FoldseekBase.cpp:316-333)."""
    from .db.storage import load_db
    from .multimer.cluster import complex_name, multimer_cluster
    from .multimer.scoremultimer import complex_maps
    args, params, device = _parse(
        _multimer_cluster_parser("multimercluster",
                                 ("db", "cluster_tsv", "tmp_dir")), argv)
    db = load_db(args.db)
    clusters = multimer_cluster(db, params, device,
                                _multimer_filter_params(args),
                                tmp_dir=args.tmp_dir)
    _, complex_chains, _ = complex_maps(db)
    with open(args.cluster_tsv, "w") as f:
        for rep in sorted(clusters):
            rname = complex_name(db, rep, complex_chains)
            for m in clusters[rep]:
                f.write(f"{rname}\t{complex_name(db, m, complex_chains)}\n")
    logger.info("multimercluster: %d complexes -> %d clusters",
                len(complex_chains), len(clusters))
    return 0


def cmd_easy_multimercluster(argv) -> int:
    from .multimer.cluster import easy_multimer_cluster
    args, params, device = _parse(
        _multimer_cluster_parser("easy-multimercluster",
                                 ("input", "output_prefix", "tmp_dir")), argv)
    easy_multimer_cluster(args.input, args.output_prefix, args.tmp_dir,
                          params, device, _multimer_filter_params(args))
    return 0


COMMANDS = {
    "easy-search": (cmd_easy_search,
                    "Structure search from files (createdb+search+convertalis)"),
    "search": (cmd_search, "Search a query DB against a target DB"),
    "cluster": (cmd_cluster, "Cluster a structure DB (cascaded set-cover)"),
    "easy-cluster": (cmd_easy_cluster, "Cluster structures from files (createdb+cluster+tsv/fasta)"),
    "createclusearchdb": (cmd_createclusearchdb, "Build a clustered search DB for --cluster-search"),
    "rbh": (cmd_rbh, "Reciprocal best hit on prebuilt DBs"),
    "easy-rbh": (cmd_easy_rbh, "Reciprocal best hit search from files"),
    "multimersearch": (cmd_multimersearch, "Complex search on prebuilt DBs"),
    "complexsearch": (cmd_multimersearch, "Alias of multimersearch"),
    "easy-multimersearch": (cmd_easy_multimersearch, "Complex-vs-complex search from files"),
    "easy-complexsearch": (cmd_easy_multimersearch, "Alias of easy-multimersearch"),
    "multimercluster": (cmd_multimercluster, "Cluster complexes in a prebuilt DB"),
    "easy-multimercluster": (cmd_easy_multimercluster, "Cluster complexes from files"),
}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print("foldseek_tpu_torch — PyTorch/CUDA structure search\n\nCommands:")
        for name, (_, desc) in COMMANDS.items():
            print(f"  {name:22s} {desc}")
        return 0 if argv else 1
    if argv[0] not in COMMANDS:
        logger.error("unknown command: %s (the port covers %s)", argv[0],
                     ", ".join(COMMANDS))
        return 1
    return COMMANDS[argv[0]][0](argv[1:])
