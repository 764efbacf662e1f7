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
complexsearch aliases); the stage verbs of those workflows (kmermatcher,
structurerescorediagonal, clust, mergeclusters, result2rbh,
mergeresultsbyset, expandmultimer, scoremultimer, createmultimerreport and
their complex aliases), swapresults (swapdb), taxonomy (createtaxdb,
addtaxonomy, filtertaxseqdb, lca, majoritylca, filtertaxdb, taxonomyreport,
easy-taxonomy), the MSA -> profile chain (result2msa, filtera3m,
msa2profile), clusterupdate and warmup; and the file utilities, which only
read and write files: DB housekeeping (mvdb, rmdb, lndb / aliasdb,
renamedbkeys, setextendeddbtype, appenddbtoindex, dbtype, view, compress,
decompress, splitdb, concatdbs, createsubdb, diffseqdbs, prefixid, tsv2db,
tar2db, db2tar, unpackdb, the createindex aliases makepaddeddb,
makepaddedseqdb and mmcreateindex, version), result DBs (sortresult,
subtractdbs, createtsv, mergedbs, filterdb, result2flat, result2repseq,
createseqfiledb, result2stats, summarizeheaders, summarizeresult,
extractalignedregion, apply) and structures out (convert2pdb,
structureto3didescriptor, convert2foldcomp, convert2fasta): all 96 verbs of
`foldseek_tpu`. A verb name may carry the reference's `base:` prefix.
Flags, defaults and output bytes are those of `foldseek_tpu`'s verbs;
`--gpu 1` selects the ungapped prefilter as in the reference's GPU mode and
`--prefilter-mode 3` the ungapped + gapped mode that exists only on a GPU.
`--device` picks where the stages of a verb that runs them go: `cuda` (the
CUDA kernels, the default) or `cpu` (their plain PyTorch versions); createdb
takes it for ProstT5; the other verbs that only read and write files take
no `--device`. `easy-search --profile-dir D` writes a torch.profiler trace
of the run, with the program's "fs.<stage>" ranges, into D. `version`
prints foldseek_tpu's version number with the port's own description.
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
                   help="easy-search: write a torch.profiler trace of the "
                        "run (host and CUDA activity, Chrome trace JSON) to "
                        "this dir; other verbs ignore it")
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
    if args.profile_dir:
        # host + device trace for perf work (SURVEY 5: the reference only
        # has per-stage wallclock)
        import torch
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        kw = {}
        try:
            # every thread, so that the align pool's "fs.align.*" ranges
            # are in the trace too, where this torch can
            kw["experimental_config"] = \
                torch._C._profiler._ExperimentalConfig(
                    profile_all_threads=True)
        except (AttributeError, TypeError):
            pass
        with profile(activities=activities, **kw) as prof:
            easy_search(args.query, args.target, args.output, args.tmp_dir,
                        params, device)
        os.makedirs(args.profile_dir, exist_ok=True)
        trace = os.path.join(args.profile_dir, "easy_search_trace.json")
        prof.export_chrome_trace(trace)
        logger.info("torch.profiler trace written to %s", trace)
        return 0
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


# --- the stage verbs of the cluster and multimer workflows --------------------

def cmd_rescorediagonal(argv) -> int:
    """Ungapped diagonal rescore of a result DB
    (reference: src/strucclustutils/structurerescorediagonal.cpp). Host
    work only."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch structurerescorediagonal")
    for name in ("query_db", "target_db", "result_db", "aln_db"):
        p.add_argument(name)
    p.add_argument("--min-diag-score", type=int, default=30)
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    from .cluster.rescorediagonal import rescore_all
    from .search.resultdb import read_result_db, write_result_db
    qdb, tdb = _query_target(args)
    results_in, _ = read_result_db(args.result_db)
    # diagonal recovered from the stored start positions (prefilter entries
    # carry it directly in the reference)
    pref = {qk: [(r.db_key, r.q_start - r.t_start) for r in rs]
            for qk, rs in results_in.items()}
    out = rescore_all(qdb, tdb, pref, SearchParams(),
                      same_db=args.target_db == args.query_db)
    write_result_db(out, args.aln_db, add_backtrace=False)
    return 0


def cmd_clust(argv) -> int:
    """Cluster an alignment result DB (set-cover/CC/greedy)
    (reference: lib/mmseqs/src/clustering). Host work only."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch clust")
    for name in ("sequence_db", "result_db", "cluster_tsv"):
        p.add_argument(name)
    p.add_argument("--cluster-mode", type=int, default=0,
                   help="0 set-cover, 1 connected-component, 2 greedy")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    from .cluster.workflow import (_edges_from_alignments, pairs_to_clusters,
                                   run_clust, write_cluster_tsv)
    from .db.storage import load_db
    from .search.resultdb import read_result_db
    db = load_db(args.sequence_db)
    results, _ = read_result_db(args.result_db)
    pairs = run_clust([int(k) for k in db.keys], db.lengths(),
                      _edges_from_alignments(results), args.cluster_mode)
    write_cluster_tsv(db, pairs_to_clusters(pairs), args.cluster_tsv)
    return 0


def cmd_kmermatcher(argv) -> int:
    """Standalone linclust k-mer grouping stage (reference:
    lib/mmseqs/src/linclust/kmermatcher.cpp; otherwise internal to the
    cluster workflow). Writes `qkey\\ttkey\\tscore\\tdiag` lines. Host work
    only."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch kmermatcher")
    p.add_argument("input_db")
    p.add_argument("output_tsv")
    p.add_argument("--kmers-per-sequence", type=int, default=300)
    p.add_argument("-k", "--kmer-size", type=int, default=0)
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    from .cluster.kmermatcher import KmerMatcherParams, kmermatcher
    from .db.storage import load_db
    db = load_db(args.input_db)
    pref = kmermatcher(db, KmerMatcherParams(
        kmer_size=args.kmer_size,
        kmers_per_sequence=args.kmers_per_sequence))
    with open(args.output_tsv, "w") as f:
        for q in sorted(pref):
            for t, s, d in pref[q]:
                f.write(f"{q}\t{t}\t{s}\t{d}\n")
    return 0


def cmd_mergeclusters(argv) -> int:
    """Compose cascaded clustering steps (reference:
    lib/mmseqs/src/util/mergeclusters.cpp): each input is a
    `rep\\tmember` TSV; later steps splice earlier steps' member lists."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch mergeclusters")
    p.add_argument("steps", nargs="+",
                   help="two or more rep<TAB>member TSVs, cascade order")
    p.add_argument("output_tsv")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    from .cluster.workflow import merge_clusters
    step_pairs = []
    keys = set()
    for path in args.steps:
        pairs = []
        for line in open(path):
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2:
                rep, mem = int(parts[0]), int(parts[1])
                pairs.append((rep, mem))
                keys.add(rep)
                keys.add(mem)
        step_pairs.append(pairs)
    merged = merge_clusters(sorted(keys), step_pairs)
    with open(args.output_tsv, "w") as f:
        for rep in sorted(merged):
            for m in merged[rep]:
                f.write(f"{rep}\t{m}\n")
    return 0


def cmd_result2rbh(argv) -> int:
    """Extract reciprocal best hits from a merged A->B + swapped-B->A
    result DB (reference: lib/mmseqs/src/util/result2rbh.cpp:33-75 — the
    first line per query is A's best; following lines tying its score are
    the RBH partners)."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch result2rbh")
    p.add_argument("result_db")
    p.add_argument("output_db")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    from .search.resultdb import read_result_db, write_result_db
    results, has_bt = read_result_db(args.result_db)
    out = {}
    for qkey, rs in results.items():
        kept = []
        if rs:
            best = rs[0].score
            for r in rs[1:]:
                if r.score != best:
                    break
                kept.append(r)
        out[qkey] = kept
    write_result_db(out, args.output_db, add_backtrace=has_bt)
    return 0


def cmd_mergeresultsbyset(argv) -> int:
    """Expand per-representative results to every member of its set
    (reference: lib/mmseqs/src/util/mergeresultsbyset.cpp, the
    cluster-search expansion; set membership from a createclusearchdb
    clu.tsv rep->member mapping)."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch mergeresultsbyset")
    p.add_argument("result_db")
    p.add_argument("set_tsv", help="repKey<TAB>memberKey per line")
    p.add_argument("output_db")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    from dataclasses import replace

    from .search.resultdb import read_result_db, write_result_db
    members = {}
    for line in open(args.set_tsv):
        parts = line.rstrip("\n").split("\t")
        if len(parts) >= 2:
            members.setdefault(int(parts[0]), []).append(int(parts[1]))
    results, has_bt = read_result_db(args.result_db)
    out = {qkey: [replace(r, db_key=m) for r in rs
                  for m in members.get(r.db_key, [r.db_key])]
           for qkey, rs in results.items()}
    write_result_db(out, args.output_db, add_backtrace=has_bt)
    return 0


def cmd_expandmultimer(argv) -> int:
    """Standalone expandmultimer verb (reference: src/strucclustutils/
    expandmultimer.cpp; registered FoldseekBase.cpp:421-433). Output is a
    backtrace-less alignment DB of fake entries (score 0) carrying only the
    expanded chain pairs, like the reference's fake prefilter entries. Host
    work only."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch expandmultimer")
    for name in ("query_db", "target_db", "result_db", "output_db"):
        p.add_argument(name)
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    from .multimer.expand import expand_multimer
    from .search.resultdb import read_result_db, write_result_db
    from .search.results import AlnResult
    qdb, tdb = _query_target(args)
    results_in, _ = read_result_db(args.result_db)
    hits = {qk: [r.db_key for r in rs] for qk, rs in results_in.items()}
    expanded = expand_multimer(qdb, tdb, hits)
    q_idx = qdb.key_to_index()
    t_idx = tdb.key_to_index()
    out = {qk: [AlnResult(db_key=tk, score=0, seq_id=0.0, evalue=0.0,
                          q_start=0, q_end=0, q_len=qdb.entry_len(q_idx[qk]),
                          t_start=0, t_end=0, t_len=tdb.entry_len(t_idx[tk]),
                          backtrace="")
                for tk in tks]
           for qk, tks in expanded.items()}
    write_result_db(out, args.output_db, add_backtrace=False)
    return 0


def cmd_scoremultimer(argv) -> int:
    """Standalone scoremultimer verb (reference: src/strucclustutils/
    scoremultimer.cpp; FoldseekBase.cpp:296-313). Host work only (numpy
    TM-scores)."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch scoremultimer")
    p.add_argument("query_db")
    p.add_argument("target_db")
    p.add_argument("aln_db", help="alignment DB with backtraces")
    p.add_argument("output_db")
    p.add_argument("--multimer-tm-threshold", type=float, default=0.0)
    p.add_argument("--chain-tm-threshold", type=float, default=0.0)
    p.add_argument("--interface-lddt-threshold", type=float, default=0.0)
    p.add_argument("--cov-mode", type=int, default=0)
    p.add_argument("-c", "--cov-thr", type=float, default=0.0)
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    from .multimer.filter import MultimerFilterParams
    from .multimer.scoremultimer import score_multimer
    from .search.resultdb import read_result_db
    qdb, tdb = _query_target(args)
    alns, has_bt = read_result_db(args.aln_db)
    if not has_bt:
        logger.error("scoremultimer needs an alignment DB with backtraces "
                     "(structurealign -a / --add-backtrace)")
        return 1
    fp = None
    if (args.multimer_tm_threshold or args.chain_tm_threshold
            or args.interface_lddt_threshold):
        fp = MultimerFilterParams(
            mult_tm_thr=args.multimer_tm_threshold,
            chain_tm_thr=args.chain_tm_threshold,
            interface_lddt_thr=args.interface_lddt_threshold,
            cov_thr=args.cov_thr, cov_mode=args.cov_mode)
    write_complex_db(score_multimer(qdb, tdb, alns, filter_params=fp),
                     args.output_db)
    return 0


def cmd_createmultimerreport(argv) -> int:
    """Standalone createmultimerreport verb (reference: src/strucclustutils/
    createmultimerreport.cpp; FoldseekBase.cpp:400-418). Host work only."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch createmultimerreport")
    p.add_argument("query_db")
    p.add_argument("target_db")
    p.add_argument("complex_db", help="complexres DB from scoremultimer")
    p.add_argument("output_tsv")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    from .multimer.report import create_multimer_report
    qdb, tdb = _query_target(args)
    report = create_multimer_report(qdb, tdb, read_complex_db(args.complex_db))
    with open(args.output_tsv, "w") as f:
        for line in report:
            f.write(line + "\n")
    logger.info("createmultimerreport: %d assignments -> %s",
                len(report), args.output_tsv)
    return 0


def cmd_swapresults(argv) -> int:
    """Swap query/target sides of a result DB (reference:
    lib/mmseqs/src/util/swapresults.cpp — entries regrouped under the
    target key with q/t columns exchanged). E-values are recomputed like
    Matcher::result_t::swapResult with the reference's ALP model: raw
    score from the stored bit score, then K*exp(-lambda*raw) times the
    finite-size-corrected area (search/alp.py; Gumbel fit for the default
    3Di/gap-10-1 system pinned from the reference's own seed-42 fit). Host
    work only."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch swapresults")
    for name in ("query_db", "target_db", "result_db", "output_db"):
        p.add_argument(name)
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    from .db.storage import load_db
    from .search.alp import AlpEvaluer
    from .search.resultdb import read_result_db, write_result_db
    from .search.results import AlnResult, compare_hits
    results, has_bt = read_result_db(args.result_db)
    # Matcher::result_t::swapResult recomputes the e-value for the swapped
    # direction from the stored bit score, against the pre-swap target
    # length and the residue count of the new target DB (the old QUERY DB,
    # swapresults.cpp:76 builds the evaluer over db1).
    evaluer = AlpEvaluer(float(load_db(args.query_db).lengths().sum()))
    out = {}
    for qkey, rs in results.items():
        for r in rs:
            bt = r.backtrace
            if bt:  # I (gap in target) <-> D (gap in query)
                bt = bt.replace("I", "x").replace("D", "I").replace("x", "D")
            ev = evaluer.swapped_evalue(float(r.score), float(r.t_len))
            out.setdefault(int(r.db_key), []).append(AlnResult(
                db_key=int(qkey), score=r.score, seq_id=r.seq_id,
                seq_id_str=r.seq_id_str, evalue=ev,
                q_start=r.t_start, q_end=r.t_end, q_len=r.t_len,
                t_start=r.q_start, t_end=r.q_end, t_len=r.q_len,
                backtrace=bt))
    for rs in out.values():
        rs.sort(key=compare_hits)
    write_result_db(out, args.output_db, add_backtrace=has_bt)
    return 0


# --- taxonomy -----------------------------------------------------------------

def _load_taxonomy(taxdump_arg: str, db_path: str = ""):
    """Resolve a taxdump: explicit --taxdump, FOLDSEEK_TPU_TAXDUMP, or the
    taxdump attached to the DB by `createtaxdb` (<db>/taxdump/)."""
    from .db.taxonomy import NcbiTaxonomy
    taxdump = taxdump_arg or os.environ.get("FOLDSEEK_TPU_TAXDUMP", "")
    if not taxdump and db_path:
        attached = os.path.join(db_path, "taxdump")
        if os.path.isdir(attached):
            taxdump = attached
    if not (taxdump and os.path.isdir(taxdump)):
        raise SystemExit("taxonomy verbs need --taxdump DIR (nodes.dmp/"
                         "names.dmp), FOLDSEEK_TPU_TAXDUMP, or a DB with"
                         " an attached taxdump (createtaxdb)")
    return NcbiTaxonomy(taxdump)


def _copy_entry(writer, db, i: int, key: int = None):
    import numpy as np
    writer.add_entry(int(db.keys[i]) if key is None else key,
                     db.names[i], db.headers[i],
                     np.asarray(db.get_aa(i)), np.asarray(db.get_ss(i)),
                     np.asarray(db.get_ca(i)) if db.ca is not None else None,
                     db.mask[db.offsets[i]:db.offsets[i + 1]],
                     file_id=int(db.fileids[i]) if db.fileids is not None else 0)


def _link_db(src: str, dst: str) -> None:
    """Hard-link every file of DB `src` under `dst` (a symlink across
    devices), as `foldseek_tpu`'s lndb verb does (reference:
    lib/mmseqs/src/util/lndb.cpp)."""
    if os.path.isdir(src):
        os.makedirs(dst, exist_ok=True)
        for root, _, files in os.walk(src):
            rel = os.path.relpath(root, src)
            out_dir = os.path.join(dst, rel) if rel != "." else dst
            os.makedirs(out_dir, exist_ok=True)
            for fn in files:
                target = os.path.join(out_dir, fn)
                if os.path.lexists(target):
                    os.unlink(target)
                try:
                    os.link(os.path.join(root, fn), target)
                except OSError:  # cross-device: fall back to symlink
                    os.symlink(os.path.abspath(os.path.join(root, fn)), target)
    elif os.path.isfile(src):
        if os.path.lexists(dst):
            os.unlink(dst)
        try:
            os.link(src, dst)
        except OSError:
            os.symlink(os.path.abspath(src), dst)
    else:
        raise SystemExit(f"lndb: {src}: no such DB")


def cmd_createtaxdb(argv) -> int:
    """Attach taxonomy to a structure DB (reference:
    lib/mmseqs/src/taxonomy/createtaxdb.cpp — builds the _mapping and
    binary taxonomy files next to the seq DB). Writes <db>/mapping.tsv
    (entry key -> taxid) and copies the taxdump into <db>/taxdump/ so
    downstream taxonomy verbs need no --taxdump flag. Host work only."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch createtaxdb")
    p.add_argument("db")
    p.add_argument("tmp_dir", nargs="?", default="")
    p.add_argument("--ncbi-tax-dump", required=True,
                   help="dir with nodes.dmp/names.dmp (+ merged.dmp)")
    p.add_argument("--tax-mapping-file", required=True,
                   help="TSV: <entry name or source file> <taxid>")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    import shutil

    from .db.storage import load_db
    from .db.taxonomy import load_tax_mapping, save_db_mapping
    db = load_db(args.db)
    save_db_mapping(db, load_tax_mapping(args.tax_mapping_file))
    dest = os.path.join(args.db, "taxdump")
    os.makedirs(dest, exist_ok=True)
    copied = 0
    for fn in ("nodes.dmp", "names.dmp", "merged.dmp", "delnodes.dmp"):
        src = os.path.join(args.ncbi_tax_dump, fn)
        if os.path.isfile(src):
            shutil.copy2(src, os.path.join(dest, fn))
            copied += 1
    if copied < 2:
        raise SystemExit(f"createtaxdb: {args.ncbi_tax_dump} has no"
                         " nodes.dmp/names.dmp")
    logger.info("createtaxdb: mapping for %d entries + taxdump -> %s",
                db.size, args.db)
    return 0


def cmd_addtaxonomy(argv) -> int:
    """Append taxid/rank/name (+ optional ranks/lineage) columns to every
    result record, keyed by the target entry's taxid (reference:
    lib/mmseqs/src/taxonomy/addtaxonomy.cpp:70-92). Host work only."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch addtaxonomy")
    for name in ("target_tax_db", "result_db", "output_db"):
        p.add_argument(name)
    p.add_argument("--taxdump", default="")
    p.add_argument("--tax-output-mode", dest="ranks", default="",
                   help="comma-separated rank names for an extra column")
    p.add_argument("--tax-lineage", type=int, default=0)
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    from .db.taxonomy import load_db_mapping
    from .search.resultdb import read_result_db
    from .search.results import result_to_line
    tax = _load_taxonomy(args.taxdump, args.target_tax_db)
    mapping = load_db_mapping(args.target_tax_db)
    if mapping is None:
        raise SystemExit(f"addtaxonomy: {args.target_tax_db} has no"
                         " mapping.tsv (run createtaxdb)")
    ranks = [r for r in args.ranks.split(",") if r]
    results, has_bt = read_result_db(args.result_db)
    not_found = 0
    with open(args.output_db, "w") as f:
        for qkey in sorted(results):
            for r in results[qkey]:
                taxon = mapping.get(int(r.db_key), 0)
                if taxon == 0 or taxon not in tax.parent:
                    not_found += 1
                    continue
                cols = [str(qkey), result_to_line(r, has_bt),
                        str(taxon), tax.rank.get(taxon, "no rank"),
                        tax.name.get(taxon, str(taxon))]
                if ranks:
                    at = {tax.rank.get(t, ""): tax.name.get(t, str(t))
                          for t in tax.lineage(taxon)}
                    cols.append(";".join(at.get(x, "-") for x in ranks))
                if args.tax_lineage == 1:
                    cols.append(tax.lineage_str(taxon))
                elif args.tax_lineage == 2:
                    cols.append(";".join(str(t)
                                         for t in tax.lineage(taxon)))
                f.write("\t".join(cols) + "\n")
    if not_found:
        logger.info("addtaxonomy: taxonomy for %d records not found",
                    not_found)
    return 0


def cmd_filtertaxseqdb(argv) -> int:
    """Subset a structure DB by a taxonomy expression (reference:
    lib/mmseqs/src/taxonomy/filtertaxseqdb.cpp; expression grammar of
    TaxonomyExpression.h — taxids with !, &&, ||, parentheses). Host work
    only."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch filtertaxseqdb")
    p.add_argument("db")
    p.add_argument("output_db")
    p.add_argument("--taxon-list", required=True)
    p.add_argument("--taxdump", default="")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    from .db.storage import StructDBWriter, load_db
    from .db.taxonomy import TaxonomyExpression, load_db_mapping
    tax = _load_taxonomy(args.taxdump, args.db)
    mapping = load_db_mapping(args.db)
    if mapping is None:
        raise SystemExit(f"filtertaxseqdb: {args.db} has no mapping.tsv"
                         " (run createtaxdb)")
    expr = TaxonomyExpression(args.taxon_list, tax)
    db = load_db(args.db)
    writer = StructDBWriter(args.output_db)
    writer.sources = db.sources or []
    kept_keys = []
    for i in range(db.size):
        taxon = mapping.get(int(db.keys[i]), 0)
        # unmapped entries are dropped regardless of the expression (the
        # reference skips taxon==0 before evaluating, filtertaxseqdb.cpp)
        if taxon and expr.matches(taxon):
            _copy_entry(writer, db, i)
            kept_keys.append(int(db.keys[i]))
    writer.finish()
    # the filtered DB keeps its taxonomy attachment
    with open(os.path.join(args.output_db, "mapping.tsv"), "w") as f:
        for key in kept_keys:
            f.write(f"{key}\t{mapping.get(key, 0)}\n")
    tdump = os.path.join(args.db, "taxdump")
    if os.path.isdir(tdump):
        _link_db(tdump, os.path.join(args.output_db, "taxdump"))
    logger.info("filtertaxseqdb: kept %d/%d entries", len(kept_keys), db.size)
    return 0


def _lca_hits(results, vote_mode: int):
    """Per query the (target key, vote value) pairs `lca_assign` weighs: the
    score under --vote-mode 2, else the e-value."""
    from .db.taxonomy import VOTE_SCORE
    return {q: [(r.db_key, r.score if vote_mode == VOTE_SCORE else r.evalue)
                for r in rs]
            for q, rs in results.items()}


def cmd_lca(argv) -> int:
    """Per-query LCA / weighted-majority taxonomic assignment
    (reference: lib/mmseqs/src/taxonomy/lca.cpp; --vote-mode 0 uniform /
    1 -log(evalue) / 2 score, --majority threshold enables weighted
    majority voting, NcbiTaxonomy::weightedMajorityLCA). Host work only."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch lca")
    for name in ("target_db", "result_db", "output_tsv"):
        p.add_argument(name)
    p.add_argument("--taxdump", default="")
    p.add_argument("--vote-mode", type=int, default=1)
    p.add_argument("--majority", type=float, default=0.0)
    p.add_argument("--blacklist", default="",
                   help="comma-separated ancestor taxids to drop")
    p.add_argument("--lca-ranks", default="",
                   help="comma-separated rank names for an extra column")
    p.add_argument("--tax-lineage", type=int, default=0,
                   help="1: named lineage column, 2: taxid lineage column")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    from .db.storage import load_db
    from .db.taxonomy import lca_assign, load_db_mapping
    from .search.resultdb import read_result_db
    tax = _load_taxonomy(args.taxdump, args.target_db)
    tdb = load_db(args.target_db)
    mapping = load_db_mapping(tdb.path) or {}
    results, _ = read_result_db(args.result_db)
    blacklist = [int(b) for b in args.blacklist.split(",") if b.strip()]
    ranks = [r for r in args.lca_ranks.split(",") if r.strip()]
    lines = lca_assign(tax, _lca_hits(results, args.vote_mode), mapping,
                       vote_mode=args.vote_mode, majority=args.majority,
                       blacklist=blacklist, ranks=ranks,
                       show_lineage=args.tax_lineage)
    with open(args.output_tsv, "w") as f:
        for q in sorted(lines):
            f.write(f"{q}\t{lines[q]}\n")
    logger.info("lca: %d queries assigned -> %s", len(lines), args.output_tsv)
    return 0


def cmd_majoritylca(argv) -> int:
    """lca with weighted majority voting (--majority 0.5 unless given)."""
    return cmd_lca(argv + ([] if any(a.startswith("--majority") for a in argv)
                           else ["--majority", "0.5"]))


def cmd_filtertaxdb(argv) -> int:
    """Keep result records whose target taxon satisfies a taxonomy
    expression (reference: lib/mmseqs/src/taxonomy/filtertaxdb.cpp +
    TaxonomyExpression.h — plain taxid, comma = OR, !/&&/|| boolean). Host
    work only."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch filtertaxdb")
    for name in ("target_db", "result_db", "output_db"):
        p.add_argument(name)
    p.add_argument("--taxon-list", required=True)
    p.add_argument("--taxdump", default="")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    from .db.storage import load_db
    from .db.taxonomy import TaxonomyExpression, load_db_mapping
    from .search.resultdb import read_result_db, write_result_db
    tax = _load_taxonomy(args.taxdump, args.target_db)
    tdb = load_db(args.target_db)
    mapping = load_db_mapping(tdb.path) or {}
    expr = TaxonomyExpression(args.taxon_list, tax)
    results, has_bt = read_result_db(args.result_db)
    out = {q: [r for r in rs if expr.matches(mapping.get(r.db_key, 0))]
           for q, rs in results.items()}
    write_result_db(out, args.output_db, add_backtrace=has_bt)
    n_in = sum(len(v) for v in results.values())
    n_out = sum(len(v) for v in out.values())
    logger.info("filtertaxdb: kept %d/%d records", n_out, n_in)
    return 0


def cmd_easy_taxonomy(argv) -> int:
    """createdb -> search -> lca -> per-query TSV + kraken-style report +
    top-hit m8 (reference: lib/mmseqs/src/workflow/EasyTaxonomy.cpp,
    data/easytaxonomy.sh — outputs <prefix>_lca.tsv, <prefix>_report,
    <prefix>_tophit_aln). The search runs on --device."""
    p = _parser("easy-taxonomy", ("query", "target_db", "output_prefix",
                                  "tmp_dir"))
    p.add_argument("--taxdump", default="")
    p.add_argument("--vote-mode", type=int, default=1)
    p.add_argument("--majority", type=float, default=0.5)
    p.add_argument("--lca-mode", type=int, default=3,
                   help="1: single-search LCA over all hits, 3/4: weighted "
                        "majority (default)")
    args, params, device = _parse(p, argv)
    from collections import Counter

    from .db.storage import load_db
    from .db.taxonomy import lca_assign, load_db_mapping
    from .search.convertalis import format_results
    from .search.pipeline import ensure_db, search
    tax = _load_taxonomy(args.taxdump, args.target_db)
    os.makedirs(args.tmp_dir, exist_ok=True)
    qdb = ensure_db(args.query, args.tmp_dir, "query")
    tdb = load_db(args.target_db)
    mapping = load_db_mapping(tdb.path) or {}
    results = search(qdb, tdb, params, device, same_db=False,
                     tmp_dir=args.tmp_dir)

    majority = args.majority if args.lca_mode != 1 else 0.0
    lines = lca_assign(tax, _lca_hits(results, args.vote_mode), mapping,
                       vote_mode=args.vote_mode, majority=majority,
                       show_lineage=0)
    key_to_name = {int(k): qdb.names[i] for i, k in enumerate(qdb.keys)}
    with open(args.output_prefix + "_lca.tsv", "w") as f:
        for q in sorted(lines):
            f.write(f"{key_to_name.get(q, q)}\t{lines[q]}\n")

    # kraken-style clade report over the assignments
    counts = Counter()
    for q in key_to_name:
        line = lines.get(q, "0\tno rank\tunclassified")
        counts[int(line.split("\t")[0])] += 1
    _write_tax_report(tax, counts, len(key_to_name),
                      args.output_prefix + "_report")

    # top-hit alignment m8
    top = {q: rs[:1] for q, rs in results.items() if rs}
    m8 = format_results(qdb, tdb, top, params.format_output,
                        with_backtrace=False)
    with open(args.output_prefix + "_tophit_aln", "w") as f:
        for line in m8:
            f.write(line + "\n")
    logger.info("easy-taxonomy: %d queries -> %s_{lca.tsv,report,tophit_aln}",
                qdb.size, args.output_prefix)
    return 0


def _write_tax_report(tax, counts, total, path):
    """Kraken-style clade report (taxonomyreport.cpp taxReport)."""
    clade = {}
    for tid, n in counts.items():
        if tid == 0:
            continue
        for anc in tax.lineage(tid):
            clade[anc] = clade.get(anc, 0) + n
    with open(path, "w") as f:
        unc = counts.get(0, 0)
        if unc > 0:  # taxReport writes unclassified only when present
            f.write(f"{100.0 * unc / max(total, 1):.4f}\t{unc}\t{unc}\t"
                    f"no rank\t0\tunclassified\n")

        # parent -> children index once (a 2.4M-node NCBI taxdump would
        # otherwise rescan the whole parent map per emitted clade)
        kids: dict = {}
        for t, par in tax.parent.items():
            if t != par:
                kids.setdefault(par, []).append(t)

        def walk(tid, depth):
            n_clade = clade.get(tid, 0)
            if n_clade == 0:
                return
            f.write(f"{100.0 * n_clade / max(total, 1):.4f}\t{n_clade}\t"
                    f"{counts.get(tid, 0)}\t{tax.rank.get(tid, 'no rank')}\t"
                    f"{tid}\t{'  ' * depth}{tax.name.get(tid, str(tid))}\n")
            for c in sorted(kids.get(tid, ()), key=lambda t: -clade.get(t, 0)):
                walk(c, depth + 1)
        walk(1, 0)
    return path


def cmd_taxonomyreport(argv) -> int:
    """Kraken-style clade report over result taxids
    (reference: lib/mmseqs/src/taxonomy/taxonomyreport.cpp taxReport). Host
    work only."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch taxonomyreport")
    for name in ("target_db", "result_db", "output"):
        p.add_argument(name)
    p.add_argument("--taxdump", default="", help="NCBI taxdump dir (nodes.dmp/names.dmp)")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    from collections import Counter

    from .db.storage import load_db
    from .db.taxonomy import NcbiTaxonomy, load_db_mapping
    from .search.resultdb import read_result_db
    tdb = load_db(args.target_db)
    mapping = load_db_mapping(tdb.path) or {}
    taxdump = args.taxdump or os.environ.get("FOLDSEEK_TPU_TAXDUMP", "") \
        or os.path.join(args.target_db, "taxdump")
    ncbi = NcbiTaxonomy(taxdump) if taxdump and os.path.isdir(taxdump) else None
    counts = Counter()
    total = 0

    def _is_lca_tsv(path):
        if not os.path.isfile(path):
            return False
        with open(path) as f:
            first = f.readline()
        return not first.startswith("#foldseek-tpu alnres")

    if _is_lca_tsv(args.result_db):
        # an LCA assignment TSV (the lca verb's output) — the reference's
        # standard easy-taxonomy flow feeds taxonomyreport the lca DB
        # (taxonomyreport.cpp reads per-query taxid records)
        for line in open(args.result_db):
            if not line.strip():
                continue
            c = line.rstrip("\n").split("\t")
            counts[int(c[1])] += 1
            total += 1
    else:
        results, _ = read_result_db(args.result_db)
        # one taxon per query: best hit's taxid (LCA when taxonomy
        # available)
        for qkey, rs in results.items():
            tids = [mapping.get(r.db_key, 0) for r in rs]
            tids = [t for t in tids if t]
            total += 1
            if not tids:
                counts[0] += 1
            elif ncbi is not None:
                counts[ncbi.lca(tids)] += 1
            else:
                counts[tids[0]] += 1
    # clade counts: propagate up lineages; then a kraken-style DFS with
    # children sorted by clade count descending (taxonomyreport.cpp
    # taxReport:28-74)
    clade = Counter()
    children = {}
    if ncbi is not None:
        for tid, n in counts.items():
            if tid == 0:
                continue
            for anc in ncbi.lineage(tid):
                clade[anc] += n
        for tid, par in ncbi.parent.items():
            if tid != par:
                children.setdefault(par, []).append(tid)
        for v in children.values():
            v.sort()
    with open(args.output, "w") as f:
        if 0 in counts:
            f.write(f"{100.0 * counts[0] / max(total, 1):.4f}\t{counts[0]}\t"
                    f"{counts[0]}\tno rank\t0\tunclassified\n")
        if ncbi is not None:
            def dfs(tid, depth):
                if clade.get(tid, 0) == 0:
                    return
                f.write(f"{100.0 * clade[tid] / max(total, 1):.4f}"
                        f"\t{clade[tid]}\t{counts.get(tid, 0)}"
                        f"\t{ncbi.rank.get(tid, 'no rank')}\t{tid}"
                        f"\t{'  ' * depth}{ncbi.name.get(tid, str(tid))}\n")
                for ch in sorted(children.get(tid, []),
                                 key=lambda t: -clade.get(t, 0)):
                    dfs(ch, depth + 1)
            dfs(1, 0)
        else:
            for tid, n in counts.most_common():
                if tid:
                    f.write(f"{100.0 * n / max(total, 1):.4f}\t{n}\t{n}\t"
                            f"no rank\t{tid}\t{tid}\n")
    return 0


# --- the MSA -> profile chain -------------------------------------------------

def _msa_rows(qlen: int, rs, tdb, tkey_to_idx, a3m: bool):
    """Query-centered MSA rows from backtraced records. Returns
    [(record, row_string)]; a3m keeps target insertions as lowercase
    after the preceding query column (result2msa.cpp:436-470), aligned
    FASTA drops them."""
    out = []
    for r in rs:
        if not r.backtrace:
            continue
        ti = tkey_to_idx.get(r.db_key)
        if ti is None:
            continue
        tseq = tdb.get_aa_str(ti).upper()
        cols = ["-"] * qlen
        inserts = [""] * (qlen + 1)
        qpos, tpos = r.q_start, r.t_start
        for op in r.backtrace:
            if op == "M":
                cols[qpos] = tseq[tpos]
                qpos += 1
                tpos += 1
            elif op == "I":  # gap in target, query advances
                qpos += 1
            else:  # D: target insertion relative to the query
                if a3m:
                    inserts[qpos] += tseq[tpos].lower()
                tpos += 1
        if a3m:
            row = "".join(c + inserts[pos + 1]
                          for pos, c in enumerate(cols))
        else:
            row = "".join(cols)
        out.append((r, row))
    return out


def cmd_result2msa(argv) -> int:
    """Query-centered MSA DB from a backtraced result DB (reference:
    lib/mmseqs/src/util/result2msa.cpp). Modes: 2 aligned FASTA,
    3 FASTA w/ summary header, 5 A3M, 6 A3M w/ alignment info columns.
    Output is a keyed flat DB unpackdb can explode into per-query files.
    Host work only."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch result2msa")
    for name in ("query_db", "target_db", "result_db", "output_db"):
        p.add_argument(name)
    p.add_argument("--msa-format-mode", type=int, default=2,
                   help="2: aligned FASTA, 3: +summary, 5: A3M, 6: A3M"
                        " w/ aln info (Parameters.cpp FORMAT_MSA_*)")
    p.add_argument("--skip-query", type=int, default=0)
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    if args.msa_format_mode not in (2, 3, 5, 6):
        raise SystemExit("result2msa: only --msa-format-mode 2/3/5/6 are"
                         " supported (binary cA3M and Stockholm are not)")
    from .search.resultdb import read_result_db
    from .search.results import result_to_line
    qdb, tdb = _query_target(args)
    results, has_bt = read_result_db(args.result_db)
    if not has_bt:
        raise SystemExit("result2msa: result DB has no backtraces"
                         " (run search/align with -a)")
    qkey_to_idx = qdb.key_to_index()
    tkey_to_idx = tdb.key_to_index()
    thead = {int(tdb.keys[i]): tdb.headers[i] for i in range(tdb.size)}
    a3m = args.msa_format_mode in (5, 6)
    same_db = tdb is qdb
    with open(args.output_db, "w") as f:
        f.write("#foldseek-tpu msadb v1\n")
        for qkey in sorted(results):
            qi = qkey_to_idx.get(qkey)
            if qi is None:
                continue
            qseq = qdb.get_aa_str(qi).upper()
            # same-DB self hit is redundant with the center row
            # (result2msa.cpp:231-234)
            rs = [r for r in results[qkey]
                  if not (same_db and r.db_key == qkey)]
            rows = _msa_rows(len(qseq), rs, tdb, tkey_to_idx, a3m)
            f.write(f"#entry {qkey} {qdb.names[qi]}\n")
            if args.msa_format_mode == 3:
                f.write(f"#{qdb.names[qi]}|{len(rows)} alignments\n")
            if not args.skip_query:
                f.write(f">{qdb.headers[qi].split()[0]}\n{qseq}\n")
            for r, row in rows:
                head = thead.get(r.db_key, str(r.db_key)).split()[0]
                if args.msa_format_mode == 6:
                    # alignment info columns = the record minus target key
                    # and backtrace (result2msa.cpp:427-433)
                    info = result_to_line(r, False).split("\t", 1)[1]
                    f.write(f">{head}\t{info}\n{row}\n")
                else:
                    f.write(f">{head}\n{row}\n")
            f.write("\0\n")
    logger.info("result2msa: %d MSAs -> %s", len(results), args.output_db)
    return 0


def _msa_codes(aligned):
    """Master-aligned MSA rows (no a3m insertions) as an [n, L] uint8 array
    of AA codes, GAP where a row has '-'."""
    import numpy as np

    from .ops.matrices import AA2NUM
    from .search.profile import GAP
    arr = np.stack([AA2NUM[np.frombuffer(s.upper().encode(), np.uint8)]
                    for s in aligned])
    return np.where(np.stack([np.frombuffer(s.encode(), np.uint8)
                              for s in aligned]) == ord("-"),
                    GAP, arr).astype(np.uint8)


def cmd_filtera3m(argv) -> int:
    """Redundancy-filter every MSA in an MSA DB with the reference's
    MsaFilter criteria (reference: lib/mmseqs/src/util/filtera3m.cpp /
    MsaFilter.cpp — the same filter result2profile applies internally).
    Host work only."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch filtera3m")
    p.add_argument("msa_db")
    p.add_argument("output_db")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    from .ops.matrices import blosum62
    from .search.profile import msa_filter
    sub_aa = blosum62(2.0, -0.2).scores
    with open(args.msa_db) as f, open(args.output_db, "w") as out:
        first = f.readline()
        if not first.startswith("#foldseek-tpu msadb"):
            raise SystemExit("filtera3m: input is not an MSA DB"
                             " (result2msa output)")
        out.write(first)

        def flush(header, rows):
            if header is None:
                return
            out.write(header)
            if not rows:
                out.write("\0\n")
                return
            # align rows (drop a3m lowercase) for the filter decision,
            # emit the ORIGINAL row text of the kept ones
            keep = msa_filter(_msa_codes(
                ["".join(c for c in s if not c.islower()) for _, s in rows]),
                sub_aa)
            for ki, (hdr, seq) in enumerate(rows):
                if keep[ki]:
                    out.write(f"{hdr}\n{seq}\n")
            out.write("\0\n")

        header, rows, cur = None, [], None
        for line in f:
            line = line.rstrip("\n")
            if line.startswith("#entry "):
                flush(header, rows)
                header, rows, cur = line + "\n", [], None
            elif line == "\0":
                continue
            elif line.startswith(">"):
                cur = line
            elif cur is not None:
                rows.append((cur, line))
                cur = None
        flush(header, rows)
    return 0


def cmd_msa2profile(argv) -> int:
    """MSA DB (result2msa output or external a3m/FASTA) -> profile DB
    (reference: lib/mmseqs/src/util/msa2profile.cpp). --match-mode 0 keeps
    the first sequence's columns; 1 keeps columns with >= --match-ratio
    residues. The AA track is the MSA PSSM; the 3Di track comes from the
    center sequence's structure when --seq-db is given (a single-sequence
    pseudo-profile, like result2structprofile's ss side for depth-1 MSAs),
    else stays at background. Host work only; `search` of the profile DB
    runs on the card."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch msa2profile")
    p.add_argument("msa_db")
    p.add_argument("output_db")
    p.add_argument("--seq-db", default="",
                   help="structure DB with the center sequences (3Di track)")
    p.add_argument("--match-mode", type=int, default=0)
    p.add_argument("--match-ratio", type=float, default=0.5)
    p.add_argument("--filter-msa", type=int, default=1)
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    import numpy as np

    from .ops.matrices import blosum62, mat3di
    from .search.profile import (GAP, ProfileEntry, compute_pssm_probs,
                                 msa_filter, save_profile_db)

    def parse_entries():
        """Yield (key, name, [aligned row strings]) per MSA."""
        with open(args.msa_db) as f:
            first = f.readline()
            if not first.startswith("#foldseek-tpu msadb"):
                # single flat a3m/FASTA file = one MSA, key 0
                rows = [first] + f.readlines()
                yield 0, os.path.basename(args.msa_db), rows
                return
            key = name = None
            buf = []
            for line in f:
                if line.startswith("#entry "):
                    if key is not None:
                        yield key, name, buf
                    parts = line.split()
                    key, name, buf = int(parts[1]), parts[2], []
                elif line.rstrip("\n") != "\0":
                    buf.append(line)
            if key is not None:
                yield key, name, buf

    sdb = None
    if args.seq_db:
        from .db.storage import load_db
        sdb = load_db(args.seq_db)
        sname_to_idx = {sdb.names[i]: i for i in range(sdb.size)}
    mb, m3 = blosum62(), mat3di()
    sub_aa = blosum62(2.0, -0.2).scores
    profiles = {}
    for key, name, lines in parse_entries():
        seqs = []
        for line in lines:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">") or line.startswith("#"):
                seqs.append("")
            elif seqs:
                seqs[-1] += line
        seqs = [s for s in seqs if s]
        if not seqs:
            continue
        # drop a3m insertions (lowercase) -> all rows master-aligned
        aligned = ["".join(c for c in s if not c.islower()) for s in seqs]
        L0 = len(aligned[0])
        if any(len(s) != L0 for s in aligned):
            raise SystemExit(f"msa2profile: ragged MSA for entry {name}")
        arr = _msa_codes(aligned)
        if args.match_mode == 0:
            match_cols = arr[0] != GAP
        else:
            frac = (arr != GAP).mean(axis=0)
            match_cols = frac >= args.match_ratio
        msa = arr[:, match_cols]
        if args.filter_msa:
            msa = msa[msa_filter(msa, sub_aa)]
        prob_aa = compute_pssm_probs(msa, mb.p_back, mb.pseudo_counts)
        L = msa.shape[1]
        cons = np.where(arr[0, match_cols] == GAP, 20,
                        arr[0, match_cols]).astype(np.int8)
        prob_ss = np.tile(m3.p_back[:20] / m3.p_back[:20].sum(), (L, 1))
        cons_ss = np.full(L, 20, dtype=np.int8)
        if sdb is not None and name in sname_to_idx:
            si = sname_to_idx[name]
            ss = np.asarray(sdb.get_ss(si))
            # master residues map 1:1 onto the structure's residues
            res_idx = np.cumsum(arr[0] != GAP) - 1
            ok = (arr[0, match_cols] != GAP) & \
                (res_idx[match_cols] < len(ss))
            row = np.full(L, GAP, dtype=np.uint8)
            row[ok] = ss[res_idx[match_cols][ok]].astype(np.uint8)
            prob_ss = compute_pssm_probs(row[None, :], m3.p_back,
                                         m3.pseudo_counts)
            cons_ss = np.where(ok, row, 20).astype(np.int8)
        profiles[key] = ProfileEntry(
            key=key, prob_aa=prob_aa, prob_ss=prob_ss,
            consensus_aa=cons, consensus_ss=cons_ss, name=name)
    save_profile_db(profiles, args.output_db)
    logger.info("msa2profile: %d profiles -> %s", len(profiles),
                args.output_db)
    return 0


# --- the workflows on the card: clusterupdate, warmup -------------------------

def cmd_clusterupdate(argv) -> int:
    """Incrementally update a clustering for a new DB version (reference:
    lib/mmseqs/src/workflow/ClusterUpdate + data/update_clustering.sh):
    1) diff old vs new DB by header; 2) keep clusters whose representative
    survives (members re-keyed, removed members dropped); 3) sequences
    that are new or orphaned (rep removed) search against the surviving
    representatives and join their best hit's cluster when it passes the
    thresholds; 4) the rest are clustered among themselves and appended
    as new clusters. The search of 3) and the clustering of 4) run on
    --device."""
    from .cluster.workflow import cluster_db
    from .db.storage import StructDBWriter, load_db
    from .search.pipeline import search
    from .utils.log import Timer
    args, cp, device = _parse_cluster(
        "clusterupdate", [(name, {}) for name in (
            "old_db", "new_db", "old_cluster_tsv", "new_cluster_tsv",
            "tmp_dir")], argv)
    os.makedirs(args.tmp_dir, exist_ok=True)
    old, new = load_db(args.old_db), load_db(args.new_db)

    with Timer("clusterupdate_diff"):
        # 1) header diff: old name -> new name (names are unique per DB)
        new_names = set(new.names)
        kept = {n: n for n in old.names if n in new_names}
        # 2) surviving clusters
        old_clusters = {}
        for line in open(args.old_cluster_tsv):
            rep, mem = line.rstrip("\n").split("\t")[:2]
            old_clusters.setdefault(rep, []).append(mem)
        clusters = {}       # rep name -> member names (new DB)
        placed = set()
        for rep, members in old_clusters.items():
            if rep in kept:
                survivors = [m for m in members if m in kept]
                clusters[rep] = survivors
                placed.update(survivors)
        to_place = [n for n in new.names if n not in placed]
    logger.info("clusterupdate: %d clusters survive, %d sequences to place",
                len(clusters), len(to_place))

    name_to_idx = {new.names[i]: i for i in range(new.size)}

    def subdb(names, label):
        w = StructDBWriter(os.path.join(args.tmp_dir, label))
        for n in names:
            _copy_entry(w, new, name_to_idx[n])
        return w.finish()

    # 3) place against surviving representatives
    unplaced = list(to_place)
    if clusters and to_place:
        with Timer("clusterupdate_place"):
            repdb = subdb(sorted(clusters), "reps")
            qdb = subdb(to_place, "toplace")
            spar = SearchParams(evalue_thr=cp.evalue_thr, cov_thr=cp.cov_thr,
                                cov_mode=cp.cov_mode, seq_id_thr=cp.seq_id_thr,
                                max_seqs=1)
            res = search(qdb, repdb, spar, device, same_db=False,
                         tmp_dir=os.path.join(args.tmp_dir, "place"))
        with Timer("clusterupdate_assign"):
            rname = {int(repdb.keys[i]): repdb.names[i]
                     for i in range(repdb.size)}
            unplaced = []
            for n in to_place:
                qkey = next(int(qdb.keys[i]) for i in range(qdb.size)
                            if qdb.names[i] == n)
                rs = res.get(qkey, [])
                if rs:
                    clusters[rname[rs[0].db_key]].append(n)
                else:
                    unplaced.append(n)
    # 4) cluster the remainder among themselves
    if unplaced:
        with Timer("clusterupdate_rest"):
            restdb = subdb(unplaced, "rest")
            sub = cluster_db(restdb, cp, device,
                             tmp_dir=os.path.join(args.tmp_dir, "restclu"))
            rkey_to_name = {int(restdb.keys[i]): restdb.names[i]
                            for i in range(restdb.size)}
            for rep, members in sub.items():
                clusters[rkey_to_name[rep]] = [rkey_to_name[m]
                                               for m in members]
    # write as name TSV in new-DB key order of the representative
    new_key = {new.names[i]: int(new.keys[i]) for i in range(new.size)}
    with open(args.new_cluster_tsv, "w") as f:
        for rep in sorted(clusters, key=lambda n: new_key[n]):
            members = clusters[rep]
            if rep not in members:
                members = [rep] + members
            seen = set()
            for m in members:
                if m not in seen:
                    seen.add(m)
                    f.write(f"{rep}\t{m}\n")
    logger.info("clusterupdate: %d clusters -> %s", len(clusters),
                args.new_cluster_tsv)
    return 0


def cmd_warmup(argv) -> int:
    """One search of three synthetic queries against a DB on --device in
    each prefilter mode a search of it will take (mode 0, the k-mer
    prefilter; with --gpu 1 also mode 1, the gapless kernel), so that what a
    first search pays once is paid here: on the card the nvcc build of the
    kernels and of the native host library into foldseek_tpu_torch/build/,
    the DB's k-mer index when it has no createindex artifact, and CUDA's
    start-up. Run it after createindex. The seconds of each mode are logged
    and recorded as the stage times warmup_k-mer and warmup_gapless."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch warmup")
    p.add_argument("target_db")
    p.add_argument("--query-lengths", default="120,250,500",
                   help="lengths of the synthetic queries")
    p.add_argument("--gpu", type=int, default=1)
    p.add_argument("-v", "--verbosity", type=int, default=3)
    _add_device(p)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    import tempfile

    import numpy as np

    from .db.storage import StructDBWriter, load_db
    from .search.pipeline import search
    from .utils.log import Timer
    device = get_device(args.device)
    tdb = load_db(args.target_db)
    lens = [int(x) for x in args.query_lengths.split(",") if x]
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as td:
        w = StructDBWriter(os.path.join(td, "warmq"))
        for i, L in enumerate(lens):
            # sample residues/coords from the DB so scoring paths see
            # realistic alphabets; wrap entries shorter than L
            src = int(rng.integers(0, tdb.size))
            aa = np.resize(np.asarray(tdb.get_aa(src)), L).astype(np.int8)
            ss = np.resize(np.asarray(tdb.get_ss(src)), L).astype(np.int8)
            t = np.arange(L) * 0.6
            ca = np.stack([2.3 * np.cos(t), 2.3 * np.sin(t), 1.5 * t],
                          axis=1).astype(np.float32)
            w.add_entry(i, f"warm{i}", f"warm{i}", aa, ss, ca)
        qdb = w.finish()
        modes = [(0, "k-mer")] + ([(1, "gapless")] if args.gpu else [])
        for mode, label in modes:
            # the seconds of each mode also land in the stage times as
            # warmup_<label>
            with Timer(f"warmup {label}") as t:
                params = SearchParams(prefilter_mode=mode, add_backtrace=True,
                                      max_seqs=64)
                search(qdb, tdb, params, device, same_db=False)
            logger.info("warmup: %s-mode search ran in %.1fs", label,
                        t.elapsed)
    logger.info("warmup: done for %s", args.target_db)
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


# --- file utilities: DB housekeeping, result DBs, structures out (host only) --

def cmd_convert2pdb(argv) -> int:
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch convert2pdb")
    p.add_argument("db")
    p.add_argument("output")
    p.add_argument("--pdb-output-mode", type=int, default=0,
                   help="0: multi-model file, 1: one file per complex, 2: per chain")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    from .db.storage import load_db
    from .ingest.convert2pdb import convert2pdb
    convert2pdb(load_db(args.db), args.output, args.pdb_output_mode)
    return 0


def cmd_structureto3didescriptor(argv) -> int:
    """Debug tool: per chain `name\\tAA\\t3Di\\tfeatures` where features are
    the raw 10 per-residue encoder inputs, "%.3E" comma-joined (reference:
    src/strucclustutils/structureto3didescriptor.cpp:137-155; zeros for
    residues without a valid flank window)."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch structureto3didescriptor")
    p.add_argument("inputs", nargs="+")
    p.add_argument("output")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    import numpy as np

    from .ingest.createdb import _parse_structures, collect_input_files
    from .ingest.encoder3di import encode_chain, states_to_string
    with open(args.output, "w") as f:
        for path in collect_input_files(args.inputs):
            sts = _parse_structures(path)
            # the reference's descriptor names entries by the input
            # filename WITH extension (structureto3didescriptor.cpp uses
            # the raw filename, unlike createdb's stripped sort key)
            file_base = os.path.basename(path.split("::", 1)[-1])
            for st in sts:
                multi = len(st.chains) > 1
                base = file_base if len(sts) == 1 else st.name
                for ch in st.chains:
                    if len(ch.aa) <= 3:
                        continue
                    n_arr, c_arr = ch.n, ch.c
                    from .ingest.createdb import is_ca_only
                    if is_ca_only(ch):
                        from .ingest.backbone import rebuild_backbone
                        n_arr, c_arr = rebuild_backbone(ch.ca, ch.aa)
                    states, feats = encode_chain(ch.ca, n_arr, c_arr, ch.cb,
                                                 return_features=True)
                    name = base + (f"_{ch.name}" if multi else "")
                    cols = ",".join(f"{v:.3E}" for v in feats.ravel())
                    f.write(f"{name}\t{ch.aa}\t{states_to_string(states)}"
                            f"\t{cols}\n")
    return 0


def cmd_convert2foldcomp(argv) -> int:
    """Compress structures into a foldcomp (FCMP) database
    (reference: src/strucclustutils/GemmiWrapper.cpp:895-945 GemmiToFoldcomp
    + lib/foldcomp compress/writeStream; backbone N/CA/C per residue)."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch convert2foldcomp")
    p.add_argument("inputs", nargs="+", help="PDB/mmCIF/mmJSON files or dirs")
    p.add_argument("output_db")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    import numpy as np

    from .ingest.createdb import _parse_structures, collect_input_files
    from .ingest.foldcomp import encode_fcz, write_foldcomp_db

    def entries():
        for path in collect_input_files(args.inputs):
            for st in _parse_structures(path):
                multi = len(st.chains) > 1
                for ch in st.chains:
                    if len(ch.aa) <= 3 or np.isnan(ch.n[:, 0]).all():
                        continue
                    name = f"{st.name}_{ch.name}" if multi else st.name
                    blob = encode_fcz(
                        np.nan_to_num(ch.n).astype(np.float32),
                        np.nan_to_num(ch.ca).astype(np.float32),
                        np.nan_to_num(ch.c).astype(np.float32),
                        ch.aa, title="", chain=ch.name or "A",
                        bfactor=ch.bfactor, idx_atom=1)
                    yield name, blob

    write_foldcomp_db(entries(), args.output_db)
    logger.info("convert2foldcomp: wrote %s", args.output_db)
    return 0


def cmd_convert2fasta(argv) -> int:
    """Sequence DB -> FASTA file (reference:
    lib/mmseqs/src/util/convert2fasta.cpp). --use-ss emits the 3Di
    strings instead of AA."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch convert2fasta")
    p.add_argument("db")
    p.add_argument("output_fasta")
    p.add_argument("--use-ss", action="store_true")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    from .db.storage import load_db
    db = load_db(args.db)
    get = db.get_ss_str if args.use_ss else db.get_aa_str
    with open(args.output_fasta, "w") as f:
        for i in range(db.size):
            f.write(f">{db.headers[i]}\n{get(i)}\n")
    logger.info("convert2fasta: %d entries -> %s", db.size, args.output_fasta)
    return 0


def cmd_createsubdb(argv) -> int:
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch createsubdb")
    p.add_argument("id_list", help="file with one key or entry name per line")
    p.add_argument("db")
    p.add_argument("output_db")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    from .db.storage import StructDBWriter, load_db
    db = load_db(args.db)
    wanted = set()
    for line in open(args.id_list):
        line = line.strip()
        if line:
            wanted.add(line)
    writer = StructDBWriter(args.output_db)
    writer.sources = db.sources or []
    kept = 0
    for i in range(db.size):
        if str(int(db.keys[i])) in wanted or db.names[i] in wanted:
            _copy_entry(writer, db, i)
            kept += 1
    writer.finish()
    logger.info("createsubdb: kept %d/%d entries", kept, db.size)
    return 0


def cmd_splitdb(argv) -> int:
    """Split a structure DB into N contiguous sub-DBs named
    <out>_<i>_<N> (reference: lib/mmseqs/src/util/splitdb.cpp;
    --split-aa balances by residue count like decomposeDomainByAminoAcid)."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch splitdb")
    p.add_argument("db")
    p.add_argument("output_db")
    p.add_argument("--split", type=int, required=True)
    p.add_argument("--split-aa", action="store_true")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    from .db.storage import StructDBWriter, load_db
    db = load_db(args.db)
    n = args.split
    if n < 1 or n > db.size:
        raise SystemExit("splitdb: split count must be in [1, db size]")
    bounds = [0]
    if args.split_aa:
        total = db.total_residues
        target, acc = total / n, 0
        for i in range(db.size):
            acc += db.entry_len(i)
            if acc >= target * len(bounds) and len(bounds) < n:
                bounds.append(i + 1)
        # residue mass concentrated in late entries can leave fewer than
        # n split points; pad with empty tail splits
        while len(bounds) < n:
            bounds.append(db.size)
    else:
        bounds = [round(i * db.size / n) for i in range(n)]
    bounds.append(db.size)
    for s in range(n):
        out = f"{args.output_db}_{s}_{n}"
        writer = StructDBWriter(out)
        writer.sources = db.sources or []
        for i in range(bounds[s], bounds[s + 1]):
            _copy_entry(writer, db, i)
        writer.finish()
        logger.info("splitdb: %s <- entries [%d, %d)", out,
                    bounds[s], bounds[s + 1])
    return 0


def cmd_concatdbs(argv) -> int:
    """Concatenate two structure DBs into one (reference:
    lib/mmseqs/src/commons/DBConcat.cpp: A's entries then B's; B's keys
    are shifted past A's unless --preserve-keys)."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch concatdbs")
    p.add_argument("db_a")
    p.add_argument("db_b")
    p.add_argument("output_db")
    p.add_argument("--preserve-keys", action="store_true")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    import numpy as np
    from .db.storage import StructDBWriter, load_db
    a, b = load_db(args.db_a), load_db(args.db_b)
    writer = StructDBWriter(args.output_db)
    # B's source-file (complex) ids must stay distinct from A's: fileids
    # group multimer chains (complex_maps), so a clash would merge
    # complexes across the inputs
    writer.sources = list(a.sources or [])
    fid_shift = len(writer.sources)
    b_sources = list(b.sources or [])
    if not b_sources and b.size and b.fileids is not None:
        b_sources = [""] * (int(np.max(b.fileids)) + 1)
    writer.sources += b_sources
    for i in range(a.size):
        _copy_entry(writer, a, i)
    shift = 0 if args.preserve_keys else \
        (int(a.keys.max()) + 1 if a.size else 0)
    if args.preserve_keys:
        clash = set(int(k) for k in a.keys) & set(int(k) for k in b.keys)
        if clash:
            raise SystemExit(f"concatdbs: --preserve-keys with "
                             f"{len(clash)} clashing keys")
    for i in range(b.size):
        writer.add_entry(int(b.keys[i]) + shift, b.names[i], b.headers[i],
                         np.asarray(b.get_aa(i)), np.asarray(b.get_ss(i)),
                         np.asarray(b.get_ca(i)) if b.ca is not None else None,
                         b.mask[b.offsets[i]:b.offsets[i + 1]],
                         file_id=(int(b.fileids[i]) + fid_shift
                                  if b.fileids is not None else fid_shift))
    writer.finish()
    logger.info("concatdbs: %d + %d entries -> %s", a.size, b.size,
                args.output_db)
    return 0


def cmd_diffseqdbs(argv) -> int:
    """Diff two versions of a structure DB by header (reference:
    lib/mmseqs/src/util/diffseqdbs.cpp): writes removed old keys, an
    old->new key mapping for kept entries, and new keys — the inputs of
    an incremental clustering update. --use-seq-id additionally requires
    identical sequences for a 'kept' match."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch diffseqdbs")
    p.add_argument("old_db")
    p.add_argument("new_db")
    p.add_argument("removed_out", help="keys only in the old DB")
    p.add_argument("mapping_out", help="old_key\\tnew_key for kept entries")
    p.add_argument("new_out", help="keys only in the new DB")
    p.add_argument("--use-seq-id", action="store_true")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    from .db.storage import load_db
    old, new = load_db(args.old_db), load_db(args.new_db)

    def ident(db, i):
        h = db.headers[i]
        return (h, db.get_aa_str(i)) if args.use_seq_id else h

    new_by_id = {}
    for i in range(new.size):
        new_by_id.setdefault(ident(new, i), []).append(int(new.keys[i]))
    removed, kept = [], []
    for i in range(old.size):
        cands = new_by_id.get(ident(old, i))
        if cands:
            kept.append((int(old.keys[i]), cands.pop(0)))
        else:
            removed.append(int(old.keys[i]))
    new_only = sorted(k for lst in new_by_id.values() for k in lst)
    with open(args.removed_out, "w") as f:
        f.writelines(f"{k}\n" for k in sorted(removed))
    with open(args.mapping_out, "w") as f:
        f.writelines(f"{a}\t{b}\n" for a, b in sorted(kept))
    with open(args.new_out, "w") as f:
        f.writelines(f"{k}\n" for k in new_only)
    logger.info("diffseqdbs: %d removed, %d kept, %d new",
                len(removed), len(kept), len(new_only))
    return 0


def cmd_mvdb(argv) -> int:
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch mvdb")
    p.add_argument("src")
    p.add_argument("dst")
    args = p.parse_args(argv)
    import shutil
    shutil.move(args.src, args.dst)
    return 0


def cmd_rmdb(argv) -> int:
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch rmdb")
    p.add_argument("db")
    args = p.parse_args(argv)
    import shutil
    if os.path.isdir(args.db):
        shutil.rmtree(args.db)
    elif os.path.isfile(args.db):
        os.unlink(args.db)
    return 0


def cmd_lndb(argv) -> int:
    """Link a DB under a new path without copying payload (reference:
    lib/mmseqs/src/util/lndb.cpp hardlinks every DB file; workflows use it
    to alias large target DBs into tmp dirs)."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch lndb")
    p.add_argument("src")
    p.add_argument("dst")
    args = p.parse_args(argv)
    _link_db(args.src, args.dst)
    return 0


def cmd_renamedbkeys(argv) -> int:
    """Rename DB entry keys per a two-column mapping file (reference:
    lib/mmseqs/src/util/renamedbkeys.cpp — rewrites the .index keys only,
    payload untouched; workflows use it to re-key sub-DBs)."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch renamedbkeys")
    p.add_argument("mapping", help="TSV: <old_key> <new_key> per line")
    p.add_argument("db")
    p.add_argument("output_db")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    mapping = {}
    with open(args.mapping) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                mapping[int(parts[0])] = int(parts[1])
    from .db.storage import is_db
    if is_db(args.db):
        import numpy as np
        _link_db(args.db, args.output_db)
        keys_path = os.path.join(args.output_db, "keys.npy")
        keys = np.load(keys_path).copy()
        for i, k in enumerate(keys):
            keys[i] = mapping.get(int(k), int(k))
        os.unlink(keys_path)  # never write through a hardlink to the source
        np.save(keys_path, keys)
        # a taxonomy attachment references keys too: re-key it (also
        # copy-on-write — the file is hardlinked to the source DB's)
        map_path = os.path.join(args.output_db, "mapping.tsv")
        if os.path.isfile(map_path):
            lines = []
            for line in open(map_path):
                k, _, rest = line.partition("\t")
                lines.append(f"{mapping.get(int(k), int(k))}\t{rest}")
            os.unlink(map_path)
            with open(map_path, "w") as f:
                f.writelines(lines)
        return 0
    # flat alignment result DB: re-key the leading query column
    from .search.resultdb import read_result_db, write_result_db
    results, has_bt = read_result_db(args.db)
    out = {mapping.get(qk, qk): rs for qk, rs in results.items()}
    write_result_db(out, args.output_db, add_backtrace=has_bt)
    return 0


def cmd_setextendeddbtype(argv) -> int:
    """Tag a DB with an extended dbtype flag (reference:
    lib/mmseqs/src/util/setextendeddbtype.cpp — ORs flag bits into the
    .dbtype; here recorded in the manifest)."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch setextendeddbtype")
    p.add_argument("db")
    p.add_argument("--extended-dbtype", type=int, required=True)
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    import json
    mpath = os.path.join(args.db, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["extended_dbtype"] = (manifest.get("extended_dbtype", 0)
                                   | args.extended_dbtype)
    with open(mpath + ".part", "w") as f:
        json.dump(manifest, f)
    os.replace(mpath + ".part", mpath)
    return 0


def cmd_appenddbtoindex(argv) -> int:
    """Attach extra DBs to a createindex artifact under named ids
    (reference: lib/mmseqs/src/util/appenddbtoindex.cpp — structureindex.sh
    packs the C-alpha and ss DBs into the .idx under reserved keys 500/502
    so a search needs only the index). Our index lives inside the DB dir,
    so satellites are already co-located; this registers extra payloads
    under index/appended/<id> for the same single-artifact deployment."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch appenddbtoindex")
    p.add_argument("dbs", nargs="+", help="DBs to append, then the index DB")
    p.add_argument("--id-list", required=True,
                   help="comma-separated numeric ids, one per appended DB")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    *srcs, index_db = args.dbs
    ids = [int(x) for x in args.id_list.split(",") if x]
    if len(ids) != len(srcs):
        raise SystemExit("appenddbtoindex: --id-list length must match the"
                         " number of appended DBs")
    from .db.index import index_dir
    idx = index_dir(index_db)
    if not os.path.isfile(os.path.join(idx, "manifest.json")):
        raise SystemExit(f"appenddbtoindex: {index_db} has no index"
                         " (run createindex first)")
    import json as _json
    app_root = os.path.join(idx, "appended")
    os.makedirs(app_root, exist_ok=True)
    with open(os.path.join(idx, "manifest.json")) as f:
        manifest = _json.load(f)
    appended = manifest.setdefault("appended", {})
    for src, key in zip(srcs, ids):
        _link_db(src, os.path.join(app_root, str(key)))
        appended[str(key)] = os.path.basename(src.rstrip("/"))
    with open(os.path.join(idx, "manifest.json"), "w") as f:
        _json.dump(manifest, f)
    logger.info("appenddbtoindex: %d DBs under %s", len(srcs), app_root)
    return 0


def cmd_compress(argv) -> int:
    """zstd-compress a flat DB file (reference: lib/mmseqs/src/util/
    compress.cpp; DBWriter --compressed stores zstd frames). Structure
    DBs are directories of binary arrays and are left to filesystem-level
    compression like the reference's .idx."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch compress")
    p.add_argument("db")
    p.add_argument("output_db")
    args = p.parse_args(argv)
    from .utils import zstd
    if not zstd.available():
        raise SystemExit("compress: no zstd library available")
    if os.path.isdir(args.db):
        raise SystemExit("compress: only flat DB files are compressed"
                         " (structure DBs are mmap-ready binary arrays)")
    with open(args.db, "rb") as f:
        data = f.read()
    with open(args.output_db, "wb") as f:
        f.write(zstd.compress(data))
    return 0


def cmd_decompress(argv) -> int:
    """Inverse of compress (reference: lib/mmseqs/src/util/compress.cpp)."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch decompress")
    p.add_argument("db")
    p.add_argument("output_db")
    args = p.parse_args(argv)
    from .utils import zstd
    if not zstd.available():
        raise SystemExit("decompress: no zstd library available")
    with open(args.db, "rb") as f:
        data = f.read()
    with open(args.output_db, "wb") as f:
        f.write(zstd.decompress(data))
    return 0


def cmd_dbtype(argv) -> int:
    """Print the DB type (reference: lib/mmseqs/src/util/dbtype.cpp)."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch dbtype")
    p.add_argument("db")
    args = p.parse_args(argv)
    from .db.storage import is_db
    if is_db(args.db):
        import json as _json
        with open(os.path.join(args.db, "manifest.json")) as f:
            print(_json.load(f).get("kind", "structure"))
        return 0
    if not os.path.isfile(args.db):
        print("Database does not exist")
        return 1
    with open(args.db) as f:
        first = f.readline()
    if first.startswith("#foldseek-tpu alnres"):
        print("Alignment")
    elif first.startswith("#foldseek-tpu msadb"):
        print("A3M MSA")
    elif first.startswith("#foldseek-tpu complexres"):
        print("Multimer alignment")
    else:
        print("Generic")
    return 0


def cmd_view(argv) -> int:
    """Print entry data to stdout (reference:
    lib/mmseqs/src/util/view.cpp)."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch view")
    p.add_argument("db")
    p.add_argument("--id-list", default="", help="comma-separated keys/names")
    args = p.parse_args(argv)
    wanted = set(x for x in args.id_list.split(",") if x)
    from .db.storage import is_db, load_db
    if is_db(args.db):
        db = load_db(args.db)
        for i in range(db.size):
            if wanted and str(int(db.keys[i])) not in wanted \
                    and db.names[i] not in wanted:
                continue
            print(f">{db.headers[i]}\n{db.get_aa_str(i)}")
        return 0
    with open(args.db) as f:
        for line in f:
            if line.startswith("#foldseek-tpu"):
                continue
            if wanted and line.partition("\t")[0] not in wanted:
                continue
            sys.stdout.write(line)
    return 0


def cmd_prefixid(argv) -> int:
    """Prefix (or suffix) every entry line with its key, a mapping name,
    or a fixed string (reference: lib/mmseqs/src/util/prefixid.cpp; the
    TSV building block of the taxonomy/aggregation pipelines)."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch prefixid")
    p.add_argument("db", help="keyed flat DB (alignment/msa/generic TSV)")
    p.add_argument("output_db")
    p.add_argument("--prefix", default="", help="fixed string instead of key")
    p.add_argument("--mapping-file", default="",
                   help="key -> name TSV; prefix with the name")
    p.add_argument("--suffix-mode", action="store_true",
                   help="append instead of prepend")
    p.add_argument("--tsv", action="store_true",
                   help="plain TSV output (no DB header line)")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    mapping = {}
    if args.mapping_file:
        for line in open(args.mapping_file):
            parts = line.split()
            if len(parts) >= 2:
                mapping[parts[0]] = parts[1]

    def tag(key: str) -> str:
        if args.prefix:
            return args.prefix
        if mapping:
            if key not in mapping:
                raise SystemExit(f"prefixid: key {key} not in mapping file")
            return mapping[key]
        return key

    with open(args.db) as f, open(args.output_db, "w") as out:
        first = f.readline()
        header = first.startswith("#foldseek-tpu")
        if not header:
            f = [first] + f.readlines() if first else []
        # no typed header on the output either way: replacing the key
        # column with an arbitrary tag makes it a generic DB (the
        # reference writes DBTYPE_OMIT_FILE / generic too)
        for line in f:
            line = line.rstrip("\n")
            if not line or line == "\0":
                continue
            if "\t" in line:
                key, _, body = line.partition("\t")
            else:
                key = body = line
            if args.suffix_mode:
                out.write(f"{body}\t{tag(key)}\n")
            else:
                out.write(f"{tag(key)}\t{body}\n")
    return 0


def cmd_tsv2db(argv) -> int:
    """Flat TSV -> DB (reference: lib/mmseqs/src/util/tsv2db.cpp groups
    consecutive same-key lines into entries). Alignment-shaped rows become
    a typed alignment result DB; anything else stays a flat keyed TSV (the
    same opaque-entry convention `apply` uses)."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch tsv2db")
    p.add_argument("input_tsv")
    p.add_argument("output_db")
    p.add_argument("--output-dbtype", type=int, default=5,
                   help="5: alignment result (reference"
                        " Parameters::DBTYPE_ALIGNMENT_RES), 0: generic")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    from .search.resultdb import parse_result_line, write_result_db
    rows = []
    with open(args.input_tsv) as f:
        for line in f:
            if line.strip():
                rows.append(line.rstrip("\n"))
    if args.output_dbtype == 5:
        try:
            out = {}
            has_bt = False
            for line in rows:
                qkey, r = parse_result_line(line)
                has_bt = has_bt or bool(r.backtrace)
                out.setdefault(qkey, []).append(r)
            write_result_db(out, args.output_db, add_backtrace=has_bt)
            return 0
        except (ValueError, IndexError):
            logger.info("tsv2db: rows are not alignment-shaped; writing"
                        " a generic keyed DB")
    with open(args.output_db, "w") as f:
        for line in rows:
            f.write(line + "\n")
    return 0


def cmd_tar2db(argv) -> int:
    """Pack the members of tar archive(s) into a keyed flat DB
    (reference: lib/mmseqs/src/util/tar2db.cpp; inverse of db2tar).
    Member names land in a .lookup-style mapping next to the output."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch tar2db")
    p.add_argument("tars", nargs="+")
    p.add_argument("output_db")
    p.add_argument("--tar-include", default=".*",
                   help="regex of member names to include")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    import re
    import tarfile
    pat = re.compile(args.tar_include)
    key = 0
    with open(args.output_db, "w") as out, \
            open(args.output_db + ".lookup", "w") as lk:
        for tpath in args.tars:
            with tarfile.open(tpath) as tar:
                for m in tar:
                    if not m.isfile() or not pat.search(m.name):
                        continue
                    data = tar.extractfile(m).read()
                    try:
                        text = data.decode()
                    except UnicodeDecodeError:
                        import base64
                        text = base64.b64encode(data).decode()
                    for line in text.splitlines():
                        out.write(f"{key}\t{line}\n")
                    lk.write(f"{key}\t{m.name}\n")
                    key += 1
    logger.info("tar2db: %d members -> %s", key, args.output_db)
    return 0


def cmd_db2tar(argv) -> int:
    """Export every DB entry as a PDB member of a tar archive
    (reference: lib/mmseqs/src/util/db2tar.cpp — entry bytes as files)."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch db2tar")
    p.add_argument("db")
    p.add_argument("output_tar")
    p.add_argument("--tar-include", default=".*")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    import io
    import re
    import tarfile

    from .db.storage import load_db
    from .ingest.convert2pdb import _atom_lines, _chain_letter, _title_lines
    db = load_db(args.db)
    pat = re.compile(args.tar_include)
    n = 0
    with tarfile.open(args.output_tar, "w") as tar:
        for i in range(db.size):
            name = db.names[i]
            if not pat.search(name):
                continue
            lines = _title_lines(db.headers[i]) + \
                _atom_lines(db, i, _chain_letter(db, i)) + ["END"]
            blob = ("\n".join(lines) + "\n").encode()
            info = tarfile.TarInfo(name=f"{name}.pdb")
            info.size = len(blob)
            tar.addfile(info, io.BytesIO(blob))
            n += 1
    logger.info("db2tar: %d entries -> %s", n, args.output_tar)
    return 0


def cmd_unpackdb(argv) -> int:
    """Explode a DB into one file per entry (reference:
    lib/mmseqs/src/util/unpackdb.cpp). Accepts our keyed flat DBs (msadb,
    alignment result DBs) and structure DBs (per-chain FASTA)."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch unpackdb")
    p.add_argument("input_db")
    p.add_argument("output_dir")
    p.add_argument("--unpack-suffix", default="")
    p.add_argument("--unpack-name-mode", type=int, default=1,
                   help="0: entry accession/name, 1: numeric key")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    os.makedirs(args.output_dir, exist_ok=True)

    def emit(name_parts, payload: str):
        name = str(name_parts[1] if args.unpack_name_mode == 0
                   and len(name_parts) > 1 else name_parts[0])
        name = name.replace("/", "_") + args.unpack_suffix
        dest = os.path.join(args.output_dir, name)
        if name.endswith(".gz"):
            import gzip
            with gzip.open(dest, "wt") as g:
                g.write(payload)
        else:
            with open(dest, "w") as g:
                g.write(payload)

    n = 0
    from .db.storage import is_db
    if is_db(args.input_db):
        from .db.storage import load_db
        db = load_db(args.input_db)
        for i in range(db.size):
            emit((int(db.keys[i]), db.names[i]),
                 f">{db.headers[i]}\n{db.get_aa_str(i)}\n")
            n += 1
        logger.info("unpackdb: %d entries -> %s", n, args.output_dir)
        return 0
    with open(args.input_db) as f:
        first = f.readline()
        if first.startswith("#foldseek-tpu msadb"):
            parts, buf = None, []
            for line in f:
                if line.startswith("#entry "):
                    if parts is not None:
                        emit(parts, "".join(buf))
                        n += 1
                    parts, buf = line.split()[1:3], []
                elif line.rstrip("\n") != "\0":
                    buf.append(line)
            if parts is not None:
                emit(parts, "".join(buf))
                n += 1
        elif first.startswith("#foldseek-tpu alnres"):
            from .search.resultdb import read_result_db
            from .search.results import result_to_line
            results, has_bt = read_result_db(args.input_db)
            for qkey in sorted(results):
                emit((qkey,), "".join(result_to_line(r, has_bt) + "\n"
                                      for r in results[qkey]))
                n += 1
        else:  # generic keyed TSV: group by leading key
            groups: dict = {}
            for line in [first] + f.readlines():
                if not line.strip():
                    continue
                key, _, rest = line.partition("\t")
                groups.setdefault(key, []).append(rest)
            for key in groups:
                emit((key,), "".join(groups[key]))
                n += 1
    logger.info("unpackdb: %d entries -> %s", n, args.output_dir)
    return 0


def cmd_sortresult(argv) -> int:
    """Re-sort every query's records by the canonical hit order
    (reference: lib/mmseqs/src/util/sortresult.cpp, Matcher::compareHits)."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch sortresult")
    p.add_argument("result_db")
    p.add_argument("output_db")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    from .search.resultdb import read_result_db, write_result_db
    from .search.results import compare_hits
    results, has_bt = read_result_db(args.result_db)
    out = {qk: sorted(rs, key=compare_hits) for qk, rs in results.items()}
    write_result_db(out, args.output_db, add_backtrace=has_bt)
    return 0


def cmd_subtractdbs(argv) -> int:
    """Remove records of result DB B from result DB A per query key
    (reference: lib/mmseqs/src/util/subtractdbs.cpp)."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch subtractdbs")
    p.add_argument("result_db_left")
    p.add_argument("result_db_right")
    p.add_argument("output_db")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    from .search.resultdb import read_result_db, write_result_db
    left, has_bt = read_result_db(args.result_db_left)
    right, _ = read_result_db(args.result_db_right)
    out = {}
    for qkey, rs in left.items():
        drop = {r.db_key for r in right.get(qkey, [])}
        out[qkey] = [r for r in rs if r.db_key not in drop]
    write_result_db(out, args.output_db, add_backtrace=has_bt)
    return 0


def cmd_createtsv(argv) -> int:
    """Result DB -> 3-column TSV with entry names (reference:
    lib/mmseqs/src/util/createtsv.cpp)."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch createtsv")
    p.add_argument("query_db")
    p.add_argument("target_db")
    p.add_argument("result_db")
    p.add_argument("output_tsv")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    from .db.storage import load_db
    from .search.resultdb import read_result_db
    from .search.results import result_to_line
    qdb = load_db(args.query_db)
    tdb = qdb if args.target_db == args.query_db else load_db(args.target_db)
    qname = {int(qdb.keys[i]): qdb.names[i] for i in range(qdb.size)}
    tname = {int(tdb.keys[i]): tdb.names[i] for i in range(tdb.size)}
    results, has_bt = read_result_db(args.result_db)
    with open(args.output_tsv, "w") as f:
        for qkey in sorted(results):
            for r in results[qkey]:
                line = result_to_line(r, has_bt).split("\t", 1)
                f.write(f"{qname.get(qkey, qkey)}\t"
                        f"{tname.get(r.db_key, r.db_key)}\t{line[1]}\n")
    return 0


def cmd_mergedbs(argv) -> int:
    """Concatenate result DBs per query key, first DB's entries first
    (reference: lib/mmseqs/src/util/mergedbs.cpp)."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch mergedbs")
    p.add_argument("result_dbs", nargs="+", help="two or more result DBs")
    p.add_argument("output_db")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    from .search.resultdb import read_result_db, write_result_db
    merged = {}
    any_bt = False
    for path in args.result_dbs:
        results, has_bt = read_result_db(path)
        any_bt = any_bt or has_bt
        for qkey, rs in results.items():
            merged.setdefault(int(qkey), []).extend(rs)
    write_result_db(merged, args.output_db, add_backtrace=any_bt)
    return 0


# filterdb expression evaluation: the reference embeds tinyexpr
# (lib/mmseqs/src/util/filterdb.cpp --filter-expression); here a small safe
# arithmetic evaluator over $N column variables.
_FILTER_OPS = {
    "+": (1, lambda a, b: a + b), "-": (1, lambda a, b: a - b),
    "*": (2, lambda a, b: a * b), "/": (2, lambda a, b: a / b if b else 0.0),
    ">": (0, lambda a, b: float(a > b)), "<": (0, lambda a, b: float(a < b)),
    ">=": (0, lambda a, b: float(a >= b)), "<=": (0, lambda a, b: float(a <= b)),
    "==": (0, lambda a, b: float(a == b)), "!=": (0, lambda a, b: float(a != b)),
}


def _filter_eval(expr: str, cols):
    import re as _re
    toks = _re.findall(r"\$\d+|\d+\.?\d*(?:[eE][-+]?\d+)?|>=|<=|==|!=|[-+*/()<>]",
                       expr)

    def value(tok):
        if tok.startswith("$"):
            return float(cols[int(tok[1:]) - 1])
        return float(tok)

    # shunting-yard to RPN, then evaluate
    out, ops = [], []
    for t in toks:
        if t in _FILTER_OPS:
            while (ops and ops[-1] in _FILTER_OPS
                   and _FILTER_OPS[ops[-1]][0] >= _FILTER_OPS[t][0]):
                out.append(ops.pop())
            ops.append(t)
        elif t == "(":
            ops.append(t)
        elif t == ")":
            while ops and ops[-1] != "(":
                out.append(ops.pop())
            if ops:
                ops.pop()
        else:
            out.append(value(t))
    while ops:
        out.append(ops.pop())
    st = []
    for t in out:
        if isinstance(t, float):
            st.append(t)
        else:
            if len(st) < 2:  # malformed expression (e.g. unary minus)
                raise ValueError(f"bad filter expression: {expr!r}")
            b, a = st.pop(), st.pop()
            st.append(_FILTER_OPS[t][1](a, b))
    return st[0] if st else 0.0


def cmd_filterdb(argv) -> int:
    """Filter result-DB records by column (reference:
    lib/mmseqs/src/util/filterdb.cpp): numeric comparator on a column, a
    regex, or a tinyexpr-style --filter-expression over $N columns."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch filterdb")
    p.add_argument("result_db")
    p.add_argument("output_db")
    p.add_argument("--filter-column", type=int, default=1,
                   help="1-based column of the record (1=targetkey 2=score ...)")
    p.add_argument("--comparison-operator", default="",
                   choices=["", "ge", "le", "e"])
    p.add_argument("--comparison-value", type=float, default=0.0)
    p.add_argument("--filter-regex", default="")
    p.add_argument("--filter-expression", default="",
                   help="arithmetic over $N columns; keeps rows where != 0")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    import re as _re

    from .search.resultdb import read_result_db, write_result_db
    from .search.results import result_to_line
    results, has_bt = read_result_db(args.result_db)
    out = {}
    kept = total = 0
    for qkey, rs in results.items():
        keep = []
        for r in rs:
            cols = result_to_line(r, has_bt).split("\t")
            total += 1
            ok = True
            if args.comparison_operator:
                v = float(cols[args.filter_column - 1])
                ok = {"ge": v >= args.comparison_value,
                      "le": v <= args.comparison_value,
                      "e": v == args.comparison_value}[args.comparison_operator]
            if ok and args.filter_regex:
                ok = _re.search(args.filter_regex,
                                cols[args.filter_column - 1]) is not None
            if ok and args.filter_expression:
                ok = _filter_eval(args.filter_expression, cols) != 0.0
            if ok:
                keep.append(r)
                kept += 1
        out[qkey] = keep
    write_result_db(out, args.output_db, add_backtrace=has_bt)
    logger.info("filterdb: kept %d/%d records", kept, total)
    return 0


def cmd_result2flat(argv) -> int:
    """Result DB -> flat FASTA-style text: per query a header line then one
    '>header\\nsequence' block per hit (reference:
    lib/mmseqs/src/util/result2flat.cpp; composed by easycluster.sh)."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch result2flat")
    p.add_argument("query_db")
    p.add_argument("target_db")
    p.add_argument("result_db")
    p.add_argument("output")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    from .db.storage import load_db
    from .search.resultdb import read_result_db
    qdb = load_db(args.query_db)
    tdb = qdb if args.target_db == args.query_db else load_db(args.target_db)
    q_idx = qdb.key_to_index()
    t_idx = tdb.key_to_index()
    results, _ = read_result_db(args.result_db)
    with open(args.output, "w") as f:
        for qkey in sorted(results):
            f.write(f">{qdb.headers[q_idx[qkey]]}\n")
            for r in results[qkey]:
                ti = t_idx[r.db_key]
                f.write(f">{tdb.headers[ti]}\n{tdb.get_aa_str(ti)}\n")
    return 0


def cmd_result2repseq(argv) -> int:
    """Top hit per query as a sequence FASTA (reference:
    lib/mmseqs/src/util/result2repseq.cpp)."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch result2repseq")
    p.add_argument("sequence_db")
    p.add_argument("result_db")
    p.add_argument("output")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    from .db.storage import load_db
    from .search.resultdb import read_result_db
    db = load_db(args.sequence_db)
    idx = db.key_to_index()
    results, _ = read_result_db(args.result_db)
    with open(args.output, "w") as f:
        for qkey in sorted(results):
            rs = results[qkey]
            rep = rs[0].db_key if rs else qkey
            i = idx[rep]
            f.write(f">{db.headers[i]}\n{db.get_aa_str(i)}\n")
    return 0


def cmd_createseqfiledb(argv) -> int:
    """Per-cluster concatenated member sequences (reference:
    lib/mmseqs/src/util/createseqfiledb.cpp; feeds result2flat for
    all_seqs.fasta)."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch createseqfiledb")
    p.add_argument("sequence_db")
    p.add_argument("cluster_tsv", help="rep\\tmember lines (names or keys)")
    p.add_argument("output")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    from .db.storage import load_db
    db = load_db(args.sequence_db)
    name_to_idx = {db.names[i]: i for i in range(db.size)}
    key_to_idx = db.key_to_index()

    def resolve(tok):
        if tok in name_to_idx:
            return name_to_idx[tok]
        return key_to_idx[int(tok)]

    clusters = {}
    order = []
    for line in open(args.cluster_tsv):
        r, m = line.rstrip("\n").split("\t")[:2]
        ri = resolve(r)
        if ri not in clusters:
            clusters[ri] = []
            order.append(ri)
        clusters[ri].append(resolve(m))
    with open(args.output, "w") as f:
        for ri in order:
            for mi in clusters[ri]:
                f.write(f">{db.headers[mi]}\n{db.get_aa_str(mi)}\n")
            f.write("\0\n")  # record separator like the reference's db entries
    return 0


def cmd_result2stats(argv) -> int:
    """Per-query statistic over result records (reference:
    lib/mmseqs/src/util/result2stats.cpp --stat
    linecount/mean/min/max/sum over a numeric column, or seqlen)."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch result2stats")
    p.add_argument("result_db")
    p.add_argument("output_tsv")
    p.add_argument("--stat", default="linecount",
                   choices=["linecount", "mean", "min", "max", "sum"])
    p.add_argument("--stat-column", type=int, default=2,
                   help="1-based record column for mean/min/max/sum"
                        " (2 = score)")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    from .search.resultdb import read_result_db
    from .search.results import result_to_line
    results, has_bt = read_result_db(args.result_db)
    with open(args.output_tsv, "w") as f:
        for qkey in sorted(results):
            rs = results[qkey]
            if args.stat == "linecount":
                val = len(rs)
            else:
                vals = [float(result_to_line(r, has_bt)
                              .split("\t")[args.stat_column - 1])
                        for r in rs]
                if not vals:
                    val = 0
                else:
                    val = {"mean": sum(vals) / len(vals),
                           "min": min(vals), "max": max(vals),
                           "sum": sum(vals)}[args.stat]
            f.write(f"{qkey}\t{val:g}\n" if isinstance(val, float)
                    else f"{qkey}\t{val}\n")
    return 0


def cmd_summarizeheaders(argv) -> int:
    """Per-cluster summary header: representative header + member count
    + first N member headers (reference:
    lib/mmseqs/src/util/summarizeheaders.cpp)."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch summarizeheaders")
    p.add_argument("query_db")
    p.add_argument("target_db")
    p.add_argument("result_db", help="cluster result DB (rep -> members)")
    p.add_argument("output_tsv")
    p.add_argument("--summary-prefix", default="cl")
    p.add_argument("--headers-per-summary", type=int, default=5)
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    from .db.storage import load_db
    from .search.resultdb import read_result_db
    qdb = load_db(args.query_db)
    tdb = qdb if args.target_db == args.query_db else load_db(args.target_db)
    thead = {int(tdb.keys[i]): tdb.headers[i] for i in range(tdb.size)}
    qhead = {int(qdb.keys[i]): qdb.headers[i] for i in range(qdb.size)}
    results, _ = read_result_db(args.result_db)
    with open(args.output_tsv, "w") as f:
        for qkey in sorted(results):
            members = [thead.get(r.db_key, str(r.db_key))
                       for r in results[qkey]]
            picks = " | ".join(members[:args.headers_per_summary])
            f.write(f"{qkey}\t{args.summary_prefix}|{qhead.get(qkey, qkey)}"
                    f"|n={len(members)}|{picks}\n")
    return 0


def cmd_summarizeresult(argv) -> int:
    """Per query keep highest-ranked alignments whose query interval is not
    already covered more than --overlap by accepted ones
    (reference: lib/mmseqs/src/util/summarizeresult.cpp:60-92)."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch summarizeresult")
    p.add_argument("result_db")
    p.add_argument("output_db")
    p.add_argument("--overlap", type=float, default=0.0)
    p.add_argument("-c", "--cov", dest="cov_thr", type=float, default=0.0)
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    import numpy as np

    from .search.resultdb import read_result_db, write_result_db
    results, has_bt = read_result_db(args.result_db)
    out = {}
    for qkey, rs in results.items():
        kept = []
        covered = None
        for r in rs:
            if covered is None:
                covered = np.zeros(max(r.q_len, 1), dtype=bool)
            lo, hi = sorted((r.q_start, r.q_end))
            if hi > r.q_len:
                continue
            dbcov = (abs(r.t_end - r.t_start) + 1) / max(r.t_len, 1)
            if dbcov < args.cov_thr:
                continue
            seg = covered[lo:hi]
            pct = float(seg.sum()) / max(hi - lo + 1, 1)
            if pct <= args.overlap:
                covered[lo:hi] = True
                kept.append(r)
        out[qkey] = kept
    write_result_db(out, args.output_db, add_backtrace=has_bt)
    return 0


def cmd_extractalignedregion(argv) -> int:
    """Extract the aligned query (or target) region of every record as a
    FASTA-style flat DB (reference:
    lib/mmseqs/src/util/extractalignedregion.cpp --extract-mode)."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch extractalignedregion")
    p.add_argument("query_db")
    p.add_argument("target_db")
    p.add_argument("result_db")
    p.add_argument("output")
    p.add_argument("--extract-mode", type=int, default=2,
                   help="1: query region, 2: target region (default)")
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    from .db.storage import load_db
    from .search.resultdb import read_result_db
    qdb = load_db(args.query_db)
    tdb = qdb if args.target_db == args.query_db else load_db(args.target_db)
    qidx, tidx = qdb.key_to_index(), tdb.key_to_index()
    results, _ = read_result_db(args.result_db)
    with open(args.output, "w") as f:
        for qkey in sorted(results):
            for r in results[qkey]:
                if args.extract_mode == 1:
                    i = qidx.get(int(qkey))
                    if i is None:
                        continue
                    seq = qdb.get_aa_str(i)[r.q_start:r.q_end + 1]
                    name = qdb.names[i]
                else:
                    i = tidx.get(int(r.db_key))
                    if i is None:
                        continue
                    seq = tdb.get_aa_str(i)[r.t_start:r.t_end + 1]
                    name = tdb.names[i]
                f.write(f">{name} {qkey}:{r.db_key}\n{seq}\n")
    return 0


def cmd_apply(argv) -> int:
    """Run a command per query block of a result DB; its stdout becomes the
    block's new records (reference: lib/mmseqs/src/util/apply.cpp — the
    program reads entry data on stdin, MMSEQS_ENTRY_NAME in env)."""
    p = argparse.ArgumentParser(prog="foldseek_tpu_torch apply")
    p.add_argument("result_db")
    p.add_argument("output_db")
    p.add_argument("program", nargs=argparse.REMAINDER)
    p.add_argument("-v", "--verbosity", type=int, default=3)
    args = p.parse_args(argv)
    set_verbosity(args.verbosity)
    if not args.program:
        raise SystemExit("apply: need a program (-- cmd args...)")
    prog = args.program[1:] if args.program[0] == "--" else args.program
    import subprocess

    from .search.resultdb import parse_result_line, read_result_db, write_result_db
    from .search.results import result_to_line
    results, has_bt = read_result_db(args.result_db)
    raw_out: dict = {}
    for qkey in sorted(results):
        blob = "".join(f"{result_to_line(r, has_bt)}\n" for r in results[qkey])
        env = dict(os.environ, MMSEQS_ENTRY_NAME=str(qkey))
        proc = subprocess.run(prog, input=blob.encode(), env=env,
                              capture_output=True)
        if proc.returncode != 0:
            raise SystemExit(
                f"apply: {' '.join(prog)} failed on entry {qkey}: "
                f"{proc.stderr.decode()[-500:]}")
        raw_out[qkey] = [line for line in proc.stdout.decode().splitlines()
                         if line.strip()]
    # like the reference, the program's output is opaque entry data
    # (lib/mmseqs/src/util/apply.cpp writes stdout verbatim). When every
    # line still parses as an alignment record the output stays a typed
    # alignment DB (usable by convertalis etc.); otherwise it is written
    # as a flat qkey\t<line> TSV.
    try:
        out = {}
        for qkey, lines in raw_out.items():
            rs = []
            for line in lines:
                _, r = parse_result_line(f"{qkey}\t{line}")
                rs.append(r)
            out[qkey] = rs
        write_result_db(out, args.output_db, add_backtrace=has_bt)
    except (ValueError, IndexError):
        with open(args.output_db, "w") as f:
            for qkey in sorted(raw_out):
                for line in raw_out[qkey]:
                    f.write(f"{qkey}\t{line}\n")
        logger.info("apply: output is not alignment-shaped; wrote flat TSV")
    return 0


# the version of foldseek_tpu whose verbs, flags and bytes the port follows
VERSION = "0.1.0"


def cmd_version(argv) -> int:
    print(f"foldseek_tpu_torch {VERSION} (PyTorch/CUDA port of foldseek-tpu)")
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
    "structurerescorediagonal": (cmd_rescorediagonal, "Ungapped diagonal rescore of a result DB"),
    "clust": (cmd_clust, "Cluster an alignment result DB (set-cover/CC/greedy)"),
    "kmermatcher": (cmd_kmermatcher, "Linclust k-mer grouping to a TSV"),
    "mergeclusters": (cmd_mergeclusters, "Compose cascaded clustering steps"),
    "result2rbh": (cmd_result2rbh, "Reciprocal best hits from a merged result DB"),
    "mergeresultsbyset": (cmd_mergeresultsbyset, "Expand per-representative results to set members"),
    "expandmultimer": (cmd_expandmultimer, "Expand chain hits to all chain pairs of hit complexes"),
    "expandcomplex": (cmd_expandmultimer, "Alias of expandmultimer"),
    "scoremultimer": (cmd_scoremultimer, "Score chain-pair alignments into complex assignments"),
    "scorecomplex": (cmd_scoremultimer, "Alias of scoremultimer"),
    "createmultimerreport": (cmd_createmultimerreport, "Complex result DB to report TSV"),
    "createcomplexreport": (cmd_createmultimerreport, "Alias of createmultimerreport"),
    "swapresults": (cmd_swapresults, "Swap query/target sides of a result DB"),
    "swapdb": (cmd_swapresults, "Alias of swapresults (base:swapdb)"),
    "createtaxdb": (cmd_createtaxdb, "Attach a tax mapping + taxdump to a DB"),
    "addtaxonomy": (cmd_addtaxonomy, "Append taxonomy columns to result records"),
    "filtertaxseqdb": (cmd_filtertaxseqdb, "Subset a structure DB by taxonomy"),
    "lca": (cmd_lca, "Per-query LCA / weighted-majority taxonomic assignment"),
    "majoritylca": (cmd_majoritylca, "lca with weighted majority voting (majority 0.5 default)"),
    "filtertaxdb": (cmd_filtertaxdb, "Filter results by a taxonomy expression"),
    "taxonomyreport": (cmd_taxonomyreport, "Kraken-style taxonomic clade report"),
    "easy-taxonomy": (cmd_easy_taxonomy, "Taxonomic assignment from files (search+lca+report)"),
    "result2msa": (cmd_result2msa, "Query-centered MSA DB (FASTA/A3M) from results"),
    "filtera3m": (cmd_filtera3m, "Redundancy-filter MSAs in an MSA DB"),
    "msa2profile": (cmd_msa2profile, "MSA DB to a searchable profile DB"),
    "clusterupdate": (cmd_clusterupdate, "Incrementally update a clustering"),
    "warmup": (cmd_warmup, "Run one search a prefilter mode against a DB (builds and loads what a first search would)"),
    "makepaddeddb": (cmd_createindex, "Alias of createindex (padded device layout)"),
    "makepaddedseqdb": (cmd_createindex,
                        "Alias of createindex (reference verb name, "
                        "FoldseekBase.cpp:126)"),
    "mmcreateindex": (cmd_createindex, "Alias of createindex (base-module name)"),
    "convert2pdb": (cmd_convert2pdb, "Structure DB to C-alpha PDB file(s)"),
    "structureto3didescriptor": (cmd_structureto3didescriptor, "Dump AA + 3Di strings per chain"),
    "convert2foldcomp": (cmd_convert2foldcomp, "Compress structures into a foldcomp (.fcz) DB"),
    "convert2fasta": (cmd_convert2fasta, "Sequence DB to FASTA"),
    "createsubdb": (cmd_createsubdb, "Subset a structure DB by key/name list"),
    "splitdb": (cmd_splitdb, "Split a DB into N contiguous sub-DBs"),
    "concatdbs": (cmd_concatdbs, "Concatenate two structure DBs"),
    "diffseqdbs": (cmd_diffseqdbs, "Diff two DB versions (removed/kept/new)"),
    "mvdb": (cmd_mvdb, "Move/rename a DB"),
    "rmdb": (cmd_rmdb, "Remove a DB"),
    "lndb": (cmd_lndb, "Link a DB under a new path (no payload copy)"),
    "aliasdb": (cmd_lndb, "Alias of lndb (base:aliasdb)"),
    "renamedbkeys": (cmd_renamedbkeys, "Rename DB entry keys per mapping file"),
    "setextendeddbtype": (cmd_setextendeddbtype, "Tag a DB with an extended dbtype flag"),
    "appenddbtoindex": (cmd_appenddbtoindex, "Attach DBs to a createindex artifact"),
    "compress": (cmd_compress, "zstd-compress a flat DB file"),
    "decompress": (cmd_decompress, "Decompress a zstd DB file"),
    "dbtype": (cmd_dbtype, "Print the DB type"),
    "view": (cmd_view, "Print DB entries to stdout"),
    "prefixid": (cmd_prefixid, "Prefix entry lines with key/name/string"),
    "tsv2db": (cmd_tsv2db, "Flat TSV to a (result) DB"),
    "tar2db": (cmd_tar2db, "Pack tar members into a keyed flat DB"),
    "db2tar": (cmd_db2tar, "Export DB entries as PDB files in a tar archive"),
    "unpackdb": (cmd_unpackdb, "Explode a DB into one file per entry"),
    "sortresult": (cmd_sortresult, "Re-sort result records into canonical hit order"),
    "subtractdbs": (cmd_subtractdbs, "Remove right DB's records from left result DB"),
    "createtsv": (cmd_createtsv, "Result DB to TSV with entry names"),
    "mergedbs": (cmd_mergedbs, "Concatenate result DBs per query"),
    "filterdb": (cmd_filterdb, "Filter result records by column/regex/expression"),
    "result2flat": (cmd_result2flat, "Result DB to flat FASTA-style text"),
    "result2repseq": (cmd_result2repseq, "Top hit per query as sequence FASTA"),
    "createseqfiledb": (cmd_createseqfiledb, "Per-cluster concatenated member sequences"),
    "result2stats": (cmd_result2stats, "Per-query statistic over result records"),
    "summarizeheaders": (cmd_summarizeheaders, "Per-cluster summary headers"),
    "summarizeresult": (cmd_summarizeresult, "Keep non-overlapping top alignments per query"),
    "extractalignedregion": (cmd_extractalignedregion,
                             "Aligned query/target regions as FASTA"),
    "apply": (cmd_apply, "Run a program per result entry (stdin/stdout)"),
    "version": (cmd_version, "Show version"),
}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print("foldseek_tpu_torch — PyTorch/CUDA structure search\n\nCommands:")
        for name, (_, desc) in COMMANDS.items():
            print(f"  {name:22s} {desc}")
        return 0 if argv else 1
    cmd = argv[0]
    # hidden base modules stay callable with the reference's `base:` prefix
    # (foldseek.cpp:12 hide_base_commands + Application.cpp strip)
    if cmd.startswith("base:"):
        cmd = cmd[len("base:"):]
    if cmd not in COMMANDS:
        logger.error("unknown command: %s (the port covers %s)", cmd,
                     ", ".join(COMMANDS))
        return 1
    return COMMANDS[cmd][0](argv[1:])
