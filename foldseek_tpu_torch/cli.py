"""Command line of the port.

Usage: python -m foldseek_tpu_torch <easy-search|search> [args...]

Flags and defaults are those of `foldseek_tpu`'s command line; `--gpu 1`
selects the ungapped prefilter as in the reference's GPU mode and
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


def _parser(prog: str, positionals) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=f"foldseek_tpu_torch {prog}")
    for name in positionals:
        p.add_argument(name)
    _add_search_params(p)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default), cuda:N, or cpu (the "
                        "kernels' plain PyTorch versions)")
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


COMMANDS = {
    "easy-search": (cmd_easy_search,
                    "Structure search from files (createdb+search+convertalis)"),
    "search": (cmd_search, "Search a query DB against a target DB"),
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
