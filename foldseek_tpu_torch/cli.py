"""Command line of the port.

Usage: python -m foldseek_tpu_torch <command> [args...]

The commands are those of `foldseek_tpu`'s command line that the port
covers: the DB and output verbs (createdb, also from FASTA through ProstT5
with --prostt5-model and from gs:// buckets, databases, createindex,
compressca, convertalis), searches (easy-search, search, also with
--cluster-search 1 and --index-server), the stage verbs (prefilter,
ungappedprefilter, structurealign, tmalign, lolalign, aln2tmscore,
samplemulambda, result2profile), the resident index server (indexserver,
gpuserver), clustering (cluster, easy-cluster, createclusearchdb),
reciprocal best hits (rbh, easy-rbh) and complexes (multimersearch,
easy-multimersearch, multimercluster, easy-multimercluster and the
complexsearch aliases).
Flags, defaults and output bytes are those of `foldseek_tpu`'s verbs;
`--gpu 1` selects the ungapped prefilter as in the reference's GPU mode and
`--prefilter-mode 3` the ungapped + gapped mode that exists only on a GPU.
`--device` picks where the stages of a verb that runs them go: `cuda` (the
CUDA kernels, the default) or `cpu` (their plain PyTorch versions); createdb
takes it for ProstT5; the other verbs that only read and write files take
no `--device`.
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


def cmd_createdb(argv) -> int:
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch createdb")
    p.add_argument("inputs", nargs="+")
    p.add_argument("output")
    p.add_argument("--chain-name-mode", type=int, default=0,
                   help="0: auto, 1: always add chain name")
    p.add_argument("--mask-bfactor-threshold", type=float, default=0.0)
    p.add_argument("--prostt5-model", type=str, default="",
                   help="GGUF weights: predict 3Di from FASTA input")
    p.add_argument("--tax-mapping-file", type=str, default="",
                   help="TSV of entry name -> NCBI taxid")
    p.add_argument("--file-include", default=".*",
                   help="regex: directory entries to ingest")
    p.add_argument("--file-exclude", default="^$",
                   help="regex: directory entries to skip")
    p.add_argument("--tar-include", default=".*",
                   help="regex: tar members to ingest")
    p.add_argument("--tar-exclude", default="^$",
                   help="regex: tar members to skip")
    p.add_argument("--input-format", type=int, default=0,
                   help="0: auto-detect (content sniffing), 1: PDB,"
                        " 2: mmCIF, 3: mmJSON, 5: Foldcomp"
                        " (LocalParameters.cpp:36)")
    p.add_argument("--write-lookup", type=int, default=0,
                   help="1: also write a reference-format .lookup file"
                        " (key\\tname\\tfileid)")
    p.add_argument("--coord-store-mode", type=int, default=1,
                   help="1: C-alpha float32 (native layout); 2: also emit"
                        " the int16-diff ca16.bin (Coordinate16 artifact)")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    _add_device(p)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    if args.input_format == 4:
        raise SystemExit("createdb: ChemComp (--input-format 4) is not"
                         " supported")
    if not 0 <= args.input_format <= 5:
        raise SystemExit("invalid value for --input-format")
    from .ingest.createdb import create_db
    db = create_db(args.inputs, args.output,
                   chain_name_mode="add" if args.chain_name_mode == 1 else "auto",
                   mask_bfactor_threshold=args.mask_bfactor_threshold,
                   prostt5_model=args.prostt5_model,
                   file_include=args.file_include,
                   file_exclude=args.file_exclude,
                   tar_include=args.tar_include,
                   tar_exclude=args.tar_exclude,
                   input_format=args.input_format, device=args.device)
    if args.tax_mapping_file:
        from .db.taxonomy import load_tax_mapping, save_db_mapping
        save_db_mapping(db, load_tax_mapping(args.tax_mapping_file))
    if args.write_lookup:
        # reference .lookup format: id\tentryName\tfileNumber
        with open(args.output + ".lookup", "w") as f:
            for i in range(db.size):
                fid = int(db.fileids[i]) if db.fileids is not None else 0
                f.write(f"{int(db.keys[i])}\t{db.names[i]}\t{fid}\n")
    if args.coord_store_mode == 2:
        cmd_compressca([args.output, "-v", "1"])
    return 0


def cmd_createindex(argv) -> int:
    """The bucket panels and k-mer postings of a DB under <db>/index/
    (`db/index.py`); a search of the DB then reads them instead of building
    them. Host work only: it takes no --device."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch createindex")
    p.add_argument("db")
    p.add_argument("tmp_dir", nargs="?")
    p.add_argument("-k", "--kmer-size", type=int, default=0)
    p.add_argument("-s", "--sensitivity", type=float, default=9.5)
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    from .db.index import create_index
    from .db.storage import load_db
    create_index(load_db(args.db), k=args.kmer_size,
                 sensitivity=args.sensitivity)
    return 0


def cmd_compressca(argv) -> int:
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch compressca")
    p.add_argument("db")
    p.add_argument("output", nargs="?", help="default: <db>/ca16.bin")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    import numpy as np

    from .db.coords16 import encode_ca
    from .db.storage import load_db
    db = load_db(args.db)
    out = args.output or os.path.join(args.db, "ca16.bin")
    offsets = [0]
    with open(out, "wb") as f:
        for i in range(db.size):
            payload, _ = encode_ca(np.asarray(db.get_ca(i)))
            f.write(payload)
            offsets.append(offsets[-1] + len(payload))
    np.save(out + ".offsets.npy", np.asarray(offsets, dtype=np.int64))
    raw = db.total_residues * 12
    logger.info("compressca: %d -> %d bytes (%.1fx)", raw, offsets[-1],
                raw / max(offsets[-1], 1))
    return 0


def read_complex_db(path: str):
    """Read the complexres DB written by multimersearch: lines
    `qkey\\t<scorecomplex cols>`."""
    out = {}
    with open(path) as f:
        header = f.readline()
        if not header.startswith("#foldseek-tpu complexres"):
            raise ValueError(f"{path}: not a foldseek-tpu complex result DB")
        for line in f:
            qkey, rest = line.rstrip("\n").split("\t", 1)
            out.setdefault(int(qkey), []).append(rest)
    return out


def cmd_convertalis(argv) -> int:
    """A result DB as BLAST-tab, SAM, HTML or superposed PDB (reference:
    src/strucclustutils/structureconvertalis.cpp). Host work only."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch convertalis")
    for name in ("query_db", "target_db", "result_db", "output"):
        p.add_argument(name)
    _add_search_params(p)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    from .db.storage import is_db, load_db
    from .search.convertalis import (FORMAT_BLAST_TAB_COLUMN_HEADERS,
                                     format_complex_results, write_output)
    from .search.profile import (ProfileQueryDB, is_profile_db,
                                 load_profile_db)
    from .search.resultdb import read_result_db
    if is_profile_db(args.query_db):
        qdb = ProfileQueryDB(load_profile_db(args.query_db))
    else:
        qdb = load_db(args.query_db)
    if args.target_db == args.query_db:
        tdb = qdb
    else:
        # clustered search DB: display against the full _seq DB, which holds
        # the member entries expanded results point at (the reference resolves
        # this via the extended dbtype + combined _seq index)
        seq_path = args.target_db + "_seq"
        tdb = load_db(seq_path if is_db(seq_path) else args.target_db)
    with open(args.result_db) as f:
        first = f.readline()
    if first.startswith("#foldseek-tpu complexres"):
        # scoremultimer output: multimer/complex columns available
        # (reference: the OUTFMT_*COMPLEX* cases only fire on scorecomplex
        # DBs, structureconvertalis.cpp:700 parseScoreComplexResult)
        lines = format_complex_results(qdb, tdb,
                                       read_complex_db(args.result_db),
                                       args.format_output)
        with open(args.output, "w") as f:
            if args.format_mode == FORMAT_BLAST_TAB_COLUMN_HEADERS:
                f.write(args.format_output.replace(",", "\t") + "\n")
            for line in lines:
                f.write(line + "\n")
        return 0
    results, has_bt = read_result_db(args.result_db)
    # the reference always uses a stored backtrace for alnlen/mismatch/
    # gapopen, whatever the column set (structureconvertalis.cpp:727)
    write_output(qdb, tdb, results, args.output, fmt=args.format_output,
                 format_mode=args.format_mode, with_backtrace=has_bt)
    return 0


def _query_target(args):
    """(query DB, target DB) of a verb: one DB when both paths are equal."""
    from .db.storage import load_db
    qdb = load_db(args.query_db)
    tdb = qdb if args.target_db == args.query_db else load_db(args.target_db)
    return qdb, tdb


def cmd_samplemulambda(argv) -> int:
    """Gumbel mu / lambda of each query from its SW scores against shuffled
    targets (the SW kernel on --device)."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch samplemulambda")
    for name in ("query_db", "target_db", "output"):
        p.add_argument(name)
    p.add_argument("--n-samples", type=int, default=100)
    p.add_argument("-v", "--verbosity", type=int, default=3)
    _add_device(p)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    from .search.samplemulambda import sample_mu_lambda
    device = get_device(args.device)
    qdb, tdb = _query_target(args)
    fits = sample_mu_lambda(qdb, tdb, device, n_samples=args.n_samples)
    with open(args.output, "w") as f:
        for key in sorted(fits):
            mu, lam = fits[key]
            f.write(f"{key}\t{mu:.6f}\t{lam:.6f}\n")
    return 0


def cmd_result2profile(argv) -> int:
    """AA + 3Di PSSM profiles from a result DB's alignments. Host work
    only."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch result2profile")
    for name in ("query_db", "target_db", "result_db", "output_db"):
        p.add_argument(name)
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    from .search.profile import result2profile, save_profile_db
    from .search.resultdb import read_result_db
    qdb, tdb = _query_target(args)
    results, _ = read_result_db(args.result_db)
    profiles = result2profile(qdb, tdb, results)
    save_profile_db(profiles, args.output_db)
    logger.info("result2profile: %d profiles -> %s", len(profiles),
                args.output_db)
    return 0


def _cmd_prefilter(argv, prog: str, default_mode: int) -> int:
    """Standalone prefilter verbs (reference: the hidden `prefilter` /
    `ungappedprefilter` base modules the workflow scripts compose). Output:
    a prefilter result DB of `qkey\\ttkey\\tscore` lines (the k-mer
    prefilter adds the diagonal). `ungappedprefilter` runs the gapless
    kernel on --device; `prefilter` is host work and takes no --device."""
    positionals = ("query_db", "target_db", "result_db")
    if default_mode == 1:
        args, params, device = _parse(_parser(prog, positionals), argv)
    else:
        p = argparse.ArgumentParser(prog=f"foldseek_tpu_torch {prog}")
        for name in positionals:
            p.add_argument(name)
        _add_search_params(p)
        args = p.parse_args(argv)
        set_verbosity(args.verbosity)
        params = params_from_args(args)
    import numpy as np
    qdb, tdb = _query_target(args)
    with open(args.result_db, "w") as f:
        f.write("#foldseek-tpu prefres v1\n")
        if default_mode == 1:
            from .search.ungapped import UngappedPrefilter
            pref = UngappedPrefilter(tdb, device)
            seqs = [np.asarray(qdb.get_ss(i)) for i in range(qdb.size)]
            for qi, hits in enumerate(pref.query_batch(seqs, params)):
                for tkey, score in hits:
                    f.write(f"{int(qdb.keys[qi])}\t{tkey}\t{score}\n")
        else:
            from .search.kmer import KmerPrefilter
            pref = KmerPrefilter(tdb, params, bias_scale=0.15)
            same_db = qdb.path == tdb.path
            tkeys = [int(k) for k in tdb.keys]
            for qi in range(qdb.size):
                identity = qi if same_db else None
                hits = pref.query(np.asarray(qdb.get_ss(qi)),
                                  params.max_seqs, identity)
                for ti, score, diag in hits:
                    f.write(f"{int(qdb.keys[qi])}\t{tkeys[ti]}\t{score}\t{diag}\n")
    return 0


def cmd_prefilter(argv) -> int:
    return _cmd_prefilter(argv, "prefilter", 0)


def cmd_ungappedprefilter(argv) -> int:
    return _cmd_prefilter(argv, "ungappedprefilter", 1)


def _cmd_module_align(argv, prog: str, forced_type=None) -> int:
    """Module-level aligner verbs (structurealign/tmalign/lolalign): re-align
    an existing result DB's candidate pairs (reference:
    src/strucclustutils/{structurealign,tmalign}.cpp drivers). The SW kernel
    of structurealign runs on --device; TM-align and LoLalign are host
    work."""
    from .search.pipeline import _align_stage
    from .search.resultdb import read_result_db, write_result_db
    args, params, device = _parse(
        _parser(prog, ("query_db", "target_db", "result_db", "aln_db")), argv)
    qdb, tdb = _query_target(args)
    results_in, _ = read_result_db(args.result_db)
    pref = {qk: [r.db_key for r in rs] for qk, rs in results_in.items()}
    if forced_type is not None:
        params.alignment_type = forced_type
    out = _align_stage(qdb, tdb, pref, params, device,
                       same_db=args.target_db == args.query_db)
    write_result_db(out, args.aln_db, add_backtrace=params.add_backtrace)
    return 0


def cmd_structurealign(argv) -> int:
    return _cmd_module_align(argv, "structurealign")


def cmd_tmalign(argv) -> int:
    return _cmd_module_align(argv, "tmalign", forced_type=1)


def cmd_lolalign(argv) -> int:
    return _cmd_module_align(argv, "lolalign", forced_type=3)


def cmd_aln2tmscore(argv) -> int:
    """TM-score, translation and rotation of each alignment of a result DB
    (reference: src/strucclustutils/aln2tmscore.cpp). Host work only."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch aln2tmscore")
    for name in ("query_db", "target_db", "result_db", "output"):
        p.add_argument(name)
    p.add_argument("--tmscore-threshold-mode", type=int, default=0)
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    import numpy as np

    from .ops import tmscore as tm_ops
    from .search.resultdb import read_result_db
    qdb, tdb = _query_target(args)
    results, _ = read_result_db(args.result_db)
    qidx = qdb.key_to_index()
    tidx = tdb.key_to_index()
    # output: per query key, lines "targetKey TM t0 t1 t2 u00..u22"
    # (reference: src/strucclustutils/aln2tmscore.cpp:104-132)
    with open(args.output, "w") as f:
        for qkey in sorted(results):
            qi = qidx[int(qkey)]
            for r in results[qkey]:
                norm = tm_ops.normalization(
                    args.tmscore_threshold_mode,
                    min(r.q_end - r.q_start, r.t_end - r.t_start),
                    r.q_len, r.t_len)
                res = tm_ops.compute_tm_score(
                    qdb.get_ca(qi), tdb.get_ca(tidx[r.db_key]),
                    r.q_start, r.t_start, r.backtrace, norm)
                u = res.u
                # TM as double "%.3E", t/u as float "%.3f"
                # (aln2tmscore.cpp:108-130 SSTR specializations,
                # Util.cpp:667-679)
                vals = [str(r.db_key), f"{res.tmscore:.3E}"]
                vals += [f"{float(np.float32(v)):.3f}" for v in res.t]
                vals += [f"{float(np.float32(u[i][j])):.3f}"
                         for i in range(3) for j in range(3)]
                f.write(str(qkey) + "\t" + " ".join(vals) + "\n")
    return 0


def cmd_indexserver(argv) -> int:
    """Serve a DB's gapless prefilter from panels resident on --device over
    a unix socket until a client sends `shutdown` (`server.py`)."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch indexserver")
    p.add_argument("db")
    p.add_argument("socket")
    p.add_argument("--max-seqs", type=int, default=1000)
    p.add_argument("-v", "--verbosity", type=int, default=3)
    _add_device(p)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    from .server import serve
    serve(args.db, args.socket, args.max_seqs, get_device(args.device))
    return 0


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
    qdb, tdb = _query_target(args)
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
    from .multimer.workflow import multimer_search
    args, params, device = _parse(
        _parser("multimersearch",
                ("query_db", "target_db", "result_db", "tmp_dir")), argv)
    qdb, tdb = _query_target(args)
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


DATABASES = {
    # name: (description, URL) — the reference's 13 predownloadable DBs
    # (src/FoldseekBase.cpp:446-551, data/structdatabases.sh)
    "Alphafold/UniProt": ("AlphaFold UniProt", "https://foldseek.steineggerlab.workers.dev/afdb"),
    "Alphafold/UniProt50-minimal": ("AlphaFold UniProt 50% clustered (minimal: no taxonomy/plddt)", "https://foldseek.steineggerlab.workers.dev/afdb50_minimal"),
    "Alphafold/UniProt50": ("AlphaFold UniProt 50% clustered", "https://foldseek.steineggerlab.workers.dev/afdb50"),
    "Alphafold/Proteome": ("AlphaFold Proteomes", "https://foldseek.steineggerlab.workers.dev/afdb_proteome"),
    "Alphafold/Swiss-Prot": ("AlphaFold Swiss-Prot", "https://foldseek.steineggerlab.workers.dev/afdb_swissprot"),
    "ESMAtlas30": ("ESM Metagenomic Atlas 30% clustered", "https://foldseek.steineggerlab.workers.dev/highquality_clust30"),
    "PDB": ("RCSB PDB", "https://foldseek.steineggerlab.workers.dev/pdb100"),
    "CATH50": ("CATH 50% clustered", "https://foldseek.steineggerlab.workers.dev/cath50"),
    "BFMD": ("Big Fantastic Multimer Database", "https://foldseek.steineggerlab.workers.dev/bfmd"),
    "BFVD": ("Big Fantastic Virus Database", "https://foldseek.steineggerlab.workers.dev/bfvd"),
    "ProstT5": ("ProstT5 GGUF weights", "https://foldseek.steineggerlab.workers.dev/prostt5"),
    "TED": ("TED domains", "https://foldseek.steineggerlab.workers.dev/ted"),
    "TED50": ("TED domains 50% clustered", "https://foldseek.steineggerlab.workers.dev/ted50"),
}


def cmd_databases(argv) -> int:
    """List the prebuilt databases, or download one (FOLDSEEK_TPU_DB_MIRROR
    replaces the host of its URL), check it and turn it into a DB."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch databases")
    p.add_argument("name", nargs="?")
    p.add_argument("output", nargs="?")
    p.add_argument("tmp_dir", nargs="?")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    if not args.name:
        print("Available databases:")
        for name, (desc, _) in DATABASES.items():
            print(f"  {name:26s} {desc}")
        return 0
    if args.name not in DATABASES:
        logger.error("unknown database %s", args.name)
        return 1
    if not args.output:
        logger.error("usage: databases <name> <output> <tmp>")
        return 1
    import urllib.error

    from .db.databases import download_database
    try:
        download_database(args.name, DATABASES[args.name][1], args.output,
                          args.tmp_dir or args.output + "_tmp")
    except (urllib.error.URLError, OSError) as e:
        logger.error("download failed (%s); download the archive elsewhere, "
                     "then run `createdb` on the extracted structures (set "
                     "FOLDSEEK_TPU_DB_MIRROR to use a mirror).", e)
        return 1
    return 0


COMMANDS = {
    "createdb": (cmd_createdb, "Convert PDB/mmCIF files to a structure DB"),
    "databases": (cmd_databases, "List/download prebuilt structure databases"),
    "easy-search": (cmd_easy_search,
                    "Structure search from files (createdb+search+convertalis)"),
    "search": (cmd_search, "Search a query DB against a target DB"),
    "convertalis": (cmd_convertalis, "Convert alignment DB to BLAST-tab/HTML formats"),
    "createindex": (cmd_createindex, "Precompute the device panels + k-mer index"),
    "indexserver": (cmd_indexserver, "Serve a resident target index over a unix socket"),
    "gpuserver": (cmd_indexserver, "Alias of indexserver"),
    "compressca": (cmd_compressca, "Re-encode C-alpha coords as int16 diffs (6 B/residue)"),
    "prefilter": (cmd_prefilter, "k-mer double-diagonal prefilter to a result DB"),
    "ungappedprefilter": (cmd_ungappedprefilter, "Device gapless prefilter to a result DB"),
    "structurealign": (cmd_structurealign, "Re-align a result DB with the dual-alphabet SW aligner"),
    "tmalign": (cmd_tmalign, "Re-align a result DB with TM-align"),
    "lolalign": (cmd_lolalign, "Re-align a result DB with LoLalign"),
    "aln2tmscore": (cmd_aln2tmscore, "TM-score for existing alignment results"),
    "samplemulambda": (cmd_samplemulambda, "Fit Gumbel mu/lambda from shuffled-target scores"),
    "result2profile": (cmd_result2profile, "Build AA+3Di PSSM profiles from alignment results"),
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
