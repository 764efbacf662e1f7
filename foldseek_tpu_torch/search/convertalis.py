"""convertalis: alignment results -> BLAST-m8 style output.

Mirrors the reference formatter (reference:
src/strucclustutils/structureconvertalis.cpp:723-1010): per-row derived
columns (alnlen/mismatch/gapopen differ with vs without a stored backtrace),
custom column list (--format-output), float formats fident %.3f / evalue %.3E
(lib/mmseqs/src/commons/Util.cpp:667-684 SSTR).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..db.storage import StructDB
from ..ops import lddt as lddt_ops
from ..ops import tmscore as tm_ops
from .results import AlnResult, compress_backtrace, compute_aln_length, format_seq_id

DEFAULT_COLUMNS = ("query,target,fident,alnlen,mismatch,gapopen,"
                   "qstart,qend,tstart,tend,evalue,bits")

# columns that require the backtrace to be stored (reference:
# Parameters::getOutputFormat needBacktrace flags, Parameters.cpp:3021-3044,
# + the structure columns computed from the stored cigar in convertalis)
BACKTRACE_COLUMNS = {"qaln", "taln", "cigar", "ppos",
                     "alntmscore", "qtmscore", "ttmscore",
                     "lddt", "lddtfull", "rmsd", "u", "t"}
CA_COLUMNS = {"alntmscore", "qtmscore", "ttmscore", "lddt", "lddtfull", "rmsd",
              "u", "t", "qca", "tca", "prob"}


def needs_backtrace(fmt: str) -> bool:
    return bool(set(fmt.split(",")) & BACKTRACE_COLUMNS)


def _fmt_f(x) -> str:
    return f"{float(x):.3f}"


def _fmt_e(x) -> str:
    return f"{float(x):.3E}"


TAX_COLUMNS = {"taxid", "taxname", "taxlineage"}
# columns computed from the C-alpha coordinates of both entries
CA_COLUMNS = {"qtmscore", "ttmscore", "alntmscore", "rmsd", "lddt",
              "lddtfull", "u", "t", "qca", "tca"}


def require_ca(qdb, tdb, what: str) -> None:
    """Raise when `what` needs C-alpha coordinates that a DB lacks: a DB
    made from sequences by createdb --prostt5-model holds none (the
    reference's convertalis cannot open the missing _ca DB either)."""
    for db in (qdb, tdb):
        if db.ca is None:
            raise ValueError(f"{what} needs C-alpha coordinates, and "
                             f"{db.path} has none")


def format_results(qdb: StructDB, tdb: StructDB,
                   results: Dict[int, List[AlnResult]],
                   fmt: str = DEFAULT_COLUMNS,
                   with_backtrace: bool = False) -> List[str]:
    """Render m8 lines for all queries in query-key order."""
    cols = fmt.split(",")
    if CA_COLUMNS & set(cols) and any(results.values()):
        require_ca(qdb, tdb, "columns "
                   + ",".join(c for c in cols if c in CA_COLUMNS))
    qkey_to_idx = qdb.key_to_index()
    tkey_to_idx = tdb.key_to_index()
    tax = None
    if TAX_COLUMNS & set(cols):
        import os

        from ..db.taxonomy import NcbiTaxonomy, load_db_mapping
        mapping = load_db_mapping(tdb.path) or {}
        taxdump = os.environ.get("FOLDSEEK_TPU_TAXDUMP", "")
        ncbi = NcbiTaxonomy(taxdump) if taxdump and os.path.isdir(taxdump) else None
        tax = (mapping, ncbi)
    lines: List[str] = []
    for qkey in sorted(results):
        qi = qkey_to_idx[int(qkey)]
        qname = qdb.headers[qi].split()[0] if qdb.headers[qi] else qdb.names[qi]
        q_len = qdb.entry_len(qi)
        for r in results[qkey]:
            ti = tkey_to_idx[r.db_key]
            tname = tdb.headers[ti].split()[0] if tdb.headers[ti] else tdb.names[ti]
            lines.append(format_row(r, qname, tname, qdb, tdb, qi, ti, cols,
                                    with_backtrace, tax=tax))
    return lines


def format_row(r: AlnResult, qname: str, tname: str,
               qdb: StructDB, tdb: StructDB, qi: int, ti: int,
               cols: Sequence[str], with_backtrace: bool, tax=None) -> str:
    # stored-record view: seq_id round-trips through the milli-truncated text
    # (resultToBuffer fastSeqIdToBuffer -> parseAlignmentRecord strtod); the
    # truncation multiply runs in float32
    if r.seq_id == 1.0:
        seq_id = 1.0
    else:
        seq_id = float(np.float32(int(np.float32(np.float32(r.seq_id) * 1000)) / 1000.0))
    if with_backtrace and r.backtrace:
        aln_len = len(r.backtrace)
        match_count = r.backtrace.count("M")
        gap_open_count = sum(
            1 for i, op in enumerate(r.backtrace)
            if op in "ID" and (i == 0 or r.backtrace[i - 1] != op))
        identical = int(np.float32(np.float32(seq_id) * np.float32(aln_len) + np.float32(0.5)))
        mismatch = match_count - identical
    else:
        aln_len = compute_aln_length(r.q_start, r.q_end, r.t_start, r.t_end)
        best_match_estimate = np.float32(min(abs(r.q_end - max(r.q_start, 0)),
                                             abs(r.t_end - max(r.t_start, 0))))
        mismatch = int(np.float32(best_match_estimate
                                  * (np.float32(1.0) - np.float32(seq_id)) + np.float32(0.5)))
        gap_open_count = 0

    qcov = (r.q_end - r.q_start + 1) / r.q_len
    tcov = (r.t_end - r.t_start + 1) / r.t_len

    tm_cache = {}

    def tm_with_norm(norm_len):
        if norm_len not in tm_cache:
            tm_cache[norm_len] = tm_ops.compute_tm_score(
                qdb.get_ca(qi), tdb.get_ca(ti), r.q_start, r.t_start,
                r.backtrace, norm_len)
        return tm_cache[norm_len]

    out = []
    for c in cols:
        if c == "query":
            out.append(qname)
        elif c == "target":
            out.append(tname)
        elif c == "fident":
            out.append(_fmt_f(seq_id))
        elif c == "pident":
            out.append(_fmt_f(seq_id * 100))
        elif c == "nident":
            out.append(str(int(seq_id * aln_len + 0.5)))
        elif c == "alnlen":
            out.append(str(aln_len))
        elif c == "mismatch":
            out.append(str(mismatch))
        elif c == "gapopen":
            out.append(str(gap_open_count))
        elif c == "qstart":
            out.append(str(r.q_start + 1))
        elif c == "qend":
            out.append(str(r.q_end + 1))
        elif c == "tstart":
            out.append(str(r.t_start + 1))
        elif c == "tend":
            out.append(str(r.t_end + 1))
        elif c == "qlen":
            out.append(str(r.q_len))
        elif c == "tlen":
            out.append(str(r.t_len))
        elif c == "evalue":
            out.append(_fmt_e(r.evalue))
        elif c == "bits":
            out.append(str(int(r.score)))
        elif c == "raw":
            # ALP raw score from the bit score (structureconvertalis.cpp:875
            # computeRawScoreFromBitScore; constants pinned near _write_sam)
            out.append(str(raw_score_from_bits(int(r.score))))
        elif c == "qcov":
            out.append(_fmt_f(qcov))
        elif c == "tcov":
            out.append(_fmt_f(tcov))
        elif c == "cigar":
            out.append(compress_backtrace(r.backtrace))
        elif c == "qseq":
            out.append(qdb.get_aa_str(qi))
        elif c == "tseq":
            out.append(tdb.get_aa_str(ti))
        elif c == "q3di":
            out.append(qdb.get_ss_str(qi))
        elif c == "t3di":
            out.append(tdb.get_ss_str(ti))
        elif c == "qheader":
            out.append(qdb.headers[qi])
        elif c == "theader":
            out.append(tdb.headers[ti])
        elif c == "qaln":
            # query consumes M/I, shows '-' on D (structureconvertalis
            # structurePrintSeqBasedOnAln)
            out.append(_aligned_string(qdb.get_aa_str(qi), r.q_start, r.backtrace, "D"))
        elif c == "taln":
            out.append(_aligned_string(tdb.get_aa_str(ti), r.t_start, r.backtrace, "I"))
        elif c == "q3dialn":
            out.append(_aligned_string(qdb.get_ss_str(qi), r.q_start, r.backtrace, "D"))
        elif c == "t3dialn":
            out.append(_aligned_string(tdb.get_ss_str(ti), r.t_start, r.backtrace, "I"))
        elif c in ("qset", "qsetid", "tset", "tsetid"):
            # source-file set columns (.lookup third column + .source file;
            # structureconvertalis.cpp needLookup/needSource)
            db_, i_ = (qdb, qi) if c[0] == "q" else (tdb, ti)
            fid = int(db_.fileids[i_]) if db_.fileids is not None else 0
            if c.endswith("id"):
                out.append(str(fid))
            else:
                src = (db_.sources[fid]
                       if db_.sources and fid < len(db_.sources) else str(fid))
                out.append(src)
        elif c == "qtmscore":
            out.append(_fmt_e(tm_with_norm(r.q_len).tmscore))
        elif c == "ttmscore":
            out.append(_fmt_e(tm_with_norm(r.t_len).tmscore))
        elif c == "alntmscore":
            norm = min(r.q_end - r.q_start, r.t_end - r.t_start)
            out.append(_fmt_e(tm_with_norm(norm).tmscore))
        elif c == "rmsd":
            out.append(_fmt_e(tm_with_norm(r.t_len).rmsd))
        elif c == "lddt":
            lr = lddt_ops.compute_lddt(qdb.get_ca(qi), tdb.get_ca(ti),
                                       r.q_start, r.t_start, r.backtrace)
            out.append(_fmt_e(lr.avg_lddt))
        elif c == "lddtfull":
            lr = lddt_ops.compute_lddt(qdb.get_ca(qi), tdb.get_ca(ti),
                                       r.q_start, r.t_start, r.backtrace)
            out.append(",".join(_fmt_f(v) for v in lr.per_col))
        elif c == "u":
            u = tm_with_norm(r.t_len).u
            out.append(",".join(_fmt_e(u[i][j]) for i in range(3) for j in range(3)))
        elif c == "t":
            t = tm_with_norm(r.t_len).t
            out.append(",".join(_fmt_e(t[i]) for i in range(3)))
        elif c == "qca":
            out.append(_ca_to_str(qdb.get_ca(qi)))
        elif c == "tca":
            out.append(_ca_to_str(tdb.get_ca(ti)))
        elif c == "prob":
            out.append(_fmt_f(calc_prob_tp(int(r.score))))
        elif c in TAX_COLUMNS:
            mapping, ncbi = tax if tax else ({}, None)
            tid = mapping.get(r.db_key, 0)
            if c == "taxid":
                out.append(str(tid))
            elif c == "taxname":
                out.append(ncbi.name.get(tid, "unclassified") if ncbi else "unclassified")
            else:
                out.append(ncbi.lineage_str(tid) if ncbi and tid else "-")
        elif c == "empty":
            out.append("-")
        else:
            out.append("-")
    return "\t".join(out)


def _ca_to_str(ca) -> str:
    """caToStr (structureconvertalis.cpp:119-131): x,y,z per residue at %.3f,
    comma-separated, no trailing comma."""
    return ",".join(f"{float(v):.3f}" for row in np.asarray(ca) for v in row)


def _aligned_string(seq: str, start: int, backtrace: str, gap_op: str) -> str:
    """Gapped alignment string: gap_op is the op that does NOT consume this
    sequence ('I' for target view... reference structureconvertalis OUTFMT_QALN
    :924-955: query consumes M/I, gaps on D)."""
    out = []
    pos = start
    for op in backtrace:
        if op == "M":
            out.append(seq[pos])
            pos += 1
        elif op == gap_op:
            out.append("-")
        else:
            out.append(seq[pos])
            pos += 1
    return "".join(out)


FORMAT_BLAST_TAB = 0
FORMAT_SAM = 1
FORMAT_BLAST_TAB_WITH_LEN = 2
FORMAT_BLAST_TAB_WITH_HEADERS = 2  # alias (reference name: BLAST_WITH_LEN)
FORMAT_HTML = 3
FORMAT_BLAST_TAB_COLUMN_HEADERS = 4
FORMAT_PDB_SUPERPOSED = 5


def write_output(qdb: StructDB, tdb: StructDB,
                 results: Dict[int, List[AlnResult]], out_path: str,
                 fmt: str = DEFAULT_COLUMNS, format_mode: int = FORMAT_BLAST_TAB,
                 with_backtrace: bool = False) -> None:
    """Render results in the requested output format
    (reference: structureconvertalis.cpp format switch; modes per
    Parameters::FORMAT_ALIGNMENT_* + LocalParameters PDB_SUPERPOSED=5)."""
    if format_mode == FORMAT_SAM:
        _write_sam(qdb, tdb, results, out_path)
    elif format_mode == FORMAT_HTML:
        _write_html(qdb, tdb, results, out_path, with_backtrace)
    elif format_mode == FORMAT_PDB_SUPERPOSED:
        _write_superposed_pdb(qdb, tdb, results, out_path)
    elif format_mode == FORMAT_BLAST_TAB_WITH_HEADERS:
        # BLAST-TAB + query/target length columns, e-value "%.2E"
        # (structureconvertalis.cpp:1154-1162 FORMAT_ALIGNMENT_BLAST_WITH_LEN)
        lines = format_results(
            qdb, tdb, results,
            "query,target,fident,alnlen,mismatch,gapopen,qstart,qend,"
            "tstart,tend,evalue,bits,qlen,tlen", with_backtrace)
        with open(out_path, "w") as f:
            for line in lines:
                parts = line.split("\t")
                parts[10] = f"{float(parts[10]):.2E}"
                f.write("\t".join(parts) + "\n")
    else:
        lines = format_results(qdb, tdb, results, fmt, with_backtrace)
        with open(out_path, "w") as f:
            if format_mode == FORMAT_BLAST_TAB_COLUMN_HEADERS:
                # mode 4: BLAST-TAB preceded by a column-name header row
                # (structureconvertalis.cpp:258-261 + header emission)
                f.write(fmt.replace(",", "\t") + "\n")
            for line in lines:
                f.write(line + "\n")


def _names(db: StructDB, i: int) -> str:
    return db.headers[i].split()[0] if db.headers[i] else db.names[i]


# multimer/complex columns (LocalParameters getOutputFormat: the complex*
# names are the pre-rename aliases of the multimer* ones)
MULTIMER_COLUMNS = {
    "complexqtmscore", "multimerqtmscore", "complexttmscore",
    "multimerttmscore", "complexu", "multimeru", "complext", "multimert",
    "complexassignid", "multimerassignid", "qcomplexcoverage",
    "qmultimercoverage", "tcomplexcoverage", "tmultimercoverage",
    "qchaintms", "tchaintms", "interfacelddt", "qchains", "tchains",
}


def format_complex_results(qdb: StructDB, tdb: StructDB,
                           complex_lines, fmt: str,
                           with_backtrace: bool = True) -> List[str]:
    """Render columns for a scoremultimer complexres DB: standard columns
    come from the embedded alignment record, multimer columns from the
    appended qTm/tTm/u/t[/filter]/assId fields (record layout:
    MultimerUtil.h:240 parseScoreComplexResult, 16 or 21 words).
    Format parity vs structureconvertalis.cpp:1075-1143: TM scores and
    complex coverages re-parsed then SSTR(double) = %.3E; u/t/chainTms/
    interfaceLddt strings echoed verbatim; unfiltered (16-col) records
    default coverage 0 and chainTms/interfaceLddt "0"; qchains/tchains
    have no renderer in the reference's switch (OUTFMT_COMPLEX_QNAME is
    parsed but unhandled) so they emit empty cells."""
    from .resultdb import parse_result_line
    cols = fmt.split(",")
    std_cols = [c for c in cols if c not in MULTIMER_COLUMNS]
    qkey_to_idx = qdb.key_to_index()
    tkey_to_idx = tdb.key_to_index()
    lines = []
    for qkey in sorted(complex_lines):
        qi = qkey_to_idx[int(qkey)]
        qname = _names(qdb, qi)
        for rest in complex_lines[qkey]:
            parts = rest.split("\t")
            # alignment record: 10 cols + optional backtrace
            n_aln = 11 if with_backtrace else 10
            _, r = parse_result_line(f"{qkey}\t" + "\t".join(parts[:n_aln]))
            extras = parts[n_aln:]
            q_tm, t_tm, ustr, tstr = extras[0], extras[1], extras[2], extras[3]
            filt = extras[4:-1]  # [qcov, tcov, qtms, ttms, ilddt] or []
            ass_id = extras[-1]
            ti = tkey_to_idx[r.db_key]
            row = []
            std_iter = iter(
                format_row(r, qname, _names(tdb, ti), qdb, tdb, qi, ti,
                           std_cols, with_backtrace).split("\t")
                if std_cols else [])
            for c in cols:
                if c not in MULTIMER_COLUMNS:
                    row.append(next(std_iter))
                elif c in ("complexqtmscore", "multimerqtmscore"):
                    row.append(f"{float(q_tm):.3E}")
                elif c in ("complexttmscore", "multimerttmscore"):
                    row.append(f"{float(t_tm):.3E}")
                elif c in ("complexu", "multimeru"):
                    row.append(ustr)
                elif c in ("complext", "multimert"):
                    row.append(tstr)
                elif c in ("complexassignid", "multimerassignid"):
                    row.append(ass_id)
                elif c in ("qcomplexcoverage", "qmultimercoverage"):
                    row.append(f"{float(filt[0]) if filt else 0.0:.3E}")
                elif c in ("tcomplexcoverage", "tmultimercoverage"):
                    row.append(f"{float(filt[1]) if filt else 0.0:.3E}")
                elif c == "qchaintms":
                    row.append(filt[2] if filt else "0")
                elif c == "tchaintms":
                    row.append(filt[3] if filt else "0")
                elif c == "interfacelddt":
                    row.append(filt[4] if filt else "0")
                elif c in ("qchains", "tchains"):
                    row.append("")
            lines.append("\t".join(row))
    return lines


# Gapped Karlin-Altschul parameters of the default 3Di scoring system
# (mat3di, bit factor 2.0, gap 10/1): the reference fits these at startup
# with the ALP library (EvalueComputation.h initGapped, random seed 42 —
# deterministic). Exact values extracted from the reference's own fit
# (same constants as search/alp.py MAT3DI_GAP_10_1).
SAM_KA_LAMBDA = 0.31605198425120906
SAM_KA_LOGK = -2.1291894072283601  # log(K), K = 0.11893366155601298


def raw_score_from_bits(bits: int) -> int:
    """computeRawScoreFromBitScore + the reference's static_cast<int>
    (truncation toward zero, so tiny bit scores go slightly negative
    exactly like the binary's AS:i output)."""
    import math
    return int((SAM_KA_LOGK + bits * math.log(2.0)) / SAM_KA_LAMBDA + 0.5)


def _write_sam(qdb, tdb, results, out_path):
    """SAM with @SQ headers per hit target (structureconvertalis.cpp:470-505,
    :1172-1207): AS:i = the ALP raw score recovered from the bit score
    (computeRawScoreFromBitScore), NM:i = the m8 mismatch count, MAPQ =
    -4.343*log(exp(-raw)) with the reference's exp-underflow quirk (raw >
    ~745 underflows exp to 0 -> inf -> uint32 cast 0 -> MAPQ 4)."""
    import math
    qidx = qdb.key_to_index()
    tidx = tdb.key_to_index()
    with open(out_path, "w") as f:
        f.write("@HD\tVN:1.4\tSO:queryname\n")
        written = set()
        for qkey in sorted(results):
            for r in results[qkey]:
                if r.db_key not in written:
                    written.add(r.db_key)
                    ti = tidx[r.db_key]
                    f.write(f"@SQ\tSN:{_names(tdb, ti)}\tLN:{tdb.entry_len(ti)}\n")
        for qkey in sorted(results):
            qi = qidx[int(qkey)]
            qname = _names(qdb, qi)
            qseq = qdb.get_aa_str(qi).upper()
            for r in results[qkey]:
                ti = tidx[r.db_key]
                strand = 16 if r.q_end > r.q_start else 0
                raw = raw_score_from_bits(int(r.score))
                if raw > 745:  # exp(-raw) underflows (see docstring)
                    mapq = 4
                elif raw < 0:
                    # the reference's uint32 cast of a negative double
                    # wraps huge -> clamped to 254
                    mapq = 254
                else:
                    mapq = min(254, int(int(4.343 * raw) + 4.99))
                cigar = compress_backtrace(r.backtrace) if r.backtrace else "*"
                start = min(r.q_start, r.q_end)
                end = max(r.q_start, r.q_end)
                seq = qseq[start:end + 1]
                if r.backtrace:
                    if r.seq_id == 1.0:
                        seq_id = 1.0
                    else:
                        seq_id = float(np.float32(
                            int(np.float32(np.float32(r.seq_id) * 1000))
                            / 1000.0))
                    identical = int(np.float32(
                        np.float32(seq_id) * np.float32(len(r.backtrace))
                        + np.float32(0.5)))
                    mismatch = r.backtrace.count("M") - identical
                else:
                    mismatch = 0
                f.write(f"{qname}\t{strand}\t{_names(tdb, ti)}\t{r.t_start + 1}"
                        f"\t{mapq}\t{cigar}\t*\t0\t0\t{seq}\t*"
                        f"\tAS:i:{raw}\tNM:i:{mismatch}\n")


def _write_superposed_pdb(qdb, tdb, results, out_path):
    """Per hit: '<out><query>_<target>.pdb' with the target C-alpha trace
    superposed onto the query (structureconvertalis.cpp PDB_SUPERPOSED)."""
    from ..ingest.convert2pdb import THREE
    if any(results.values()):
        require_ca(qdb, tdb, "format mode 5 (superposed PDB)")
    qidx = qdb.key_to_index()
    tidx = tdb.key_to_index()
    for qkey in sorted(results):
        qi = qidx[int(qkey)]
        qname = _names(qdb, qi)
        for r in results[qkey]:
            ti = tidx[r.db_key]
            tname = _names(tdb, ti)
            tmres = tm_ops.compute_tm_score(
                qdb.get_ca(qi), tdb.get_ca(ti), r.q_start, r.t_start,
                r.backtrace, r.t_len)
            u = np.asarray(tmres.u, dtype=np.float64)
            t = np.asarray(tmres.t, dtype=np.float64)
            ca = np.asarray(tdb.get_ca(ti), dtype=np.float64) @ u.T + t
            taa = tdb.get_aa_str(ti).upper()
            with open(f"{out_path}{qname}_{tname}.pdb", "w") as f:
                f.write("MODEL\n")
                f.write(f"REMARK {qname} {tname}\n")
                for p in range(len(ca)):
                    aa3 = THREE.get(taa[p], "UNK")
                    f.write(f"ATOM  {p + 1:5d}   CA {aa3} A{p + 1:4d}    "
                            f"{ca[p][0]:8.3f}{ca[p][1]:8.3f}{ca[p][2]:8.3f}"
                            f"{1.0:6.2f}{0.0:6.2f}\n")
                f.write("ENDMDL\n")


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>foldseek-tpu results</title>
<style>
body {{ font-family: system-ui, sans-serif; margin: 2rem; color: #1a1a2e; }}
h1 {{ font-size: 1.3rem; }}
table {{ border-collapse: collapse; width: 100%; font-size: 0.85rem; }}
th, td {{ padding: 4px 8px; border-bottom: 1px solid #ddd; text-align: left; }}
th {{ cursor: pointer; background: #f0f0f5; position: sticky; top: 0; }}
tr:hover {{ background: #f6f6ff; }}
.aln {{ font-family: monospace; white-space: pre; font-size: 0.75rem;
       display: none; background: #fafafa; padding: 6px; }}
.v3d {{ font-size: 0.75rem; cursor: pointer; }}
.viewer canvas {{ border: 1px solid #ccc; background: #101018;
                  cursor: grab; display: block; margin: 4px 0; }}
.legend {{ font-size: 0.75rem; color: #555; }}
</style></head><body>
<h1>foldseek-tpu search results</h1>
<p>{n_hits} hits, {n_queries} queries. Click a row to toggle the alignment;
the 3D button shows the TM-superposed C-alpha traces
(<span style="color:#4aa3ff">query</span> /
<span style="color:#ffb347">target</span>, drag to rotate, wheel to zoom).</p>
<table id="t"><thead><tr>
<th>query</th><th>target</th><th>fident</th><th>alnlen</th>
<th>qstart-qend</th><th>tstart-tend</th><th>evalue</th><th>bits</th><th></th>
</tr></thead><tbody>
{rows}
</tbody></table>
<script>
var COORDS = {coords};
function show3d(btn) {{
  var holder = btn.closest("tr").nextElementSibling
                  .firstElementChild.children[1];
  if (holder.firstChild) {{ holder.innerHTML = ""; return; }}
  var d = COORDS[parseInt(btn.dataset.v)];
  var cv = document.createElement("canvas");
  cv.width = 520; cv.height = 400;
  holder.appendChild(cv);
  var ctx = cv.getContext("2d");
  var pts = d.q.concat(d.t);
  var c = [0, 1, 2].map(function(k) {{
    return pts.reduce(function(s, p) {{ return s + p[k]; }}, 0) / pts.length;
  }});
  var span = Math.max.apply(null, pts.map(function(p) {{
    return Math.hypot(p[0] - c[0], p[1] - c[1], p[2] - c[2]); }}));
  var rx = 0.5, ry = 0.6, zoom = 180 / Math.max(span, 1);
  function rot(p) {{
    var x = p[0] - c[0], y = p[1] - c[1], z = p[2] - c[2];
    var x1 = x * Math.cos(ry) + z * Math.sin(ry);
    var z1 = -x * Math.sin(ry) + z * Math.cos(ry);
    var y1 = y * Math.cos(rx) - z1 * Math.sin(rx);
    var z2 = y * Math.sin(rx) + z1 * Math.cos(rx);
    return [x1, y1, z2];
  }}
  function draw() {{
    ctx.clearRect(0, 0, cv.width, cv.height);
    [[d.q, "#4aa3ff"], [d.t, "#ffb347"]].forEach(function(trace) {{
      var ca = trace[0], col = trace[1];
      for (var i = 1; i < ca.length; i++) {{
        var a = rot(ca[i - 1]), b = rot(ca[i]);
        // skip chain breaks (> 5 A between consecutive C-alphas)
        var dx = ca[i][0]-ca[i-1][0], dy = ca[i][1]-ca[i-1][1],
            dz = ca[i][2]-ca[i-1][2];
        if (dx*dx + dy*dy + dz*dz > 25) continue;
        var depth = (a[2] + b[2]) / (2 * Math.max(span, 1));
        ctx.strokeStyle = col;
        ctx.globalAlpha = Math.min(1, Math.max(0.25, 0.7 + 0.5 * depth));
        ctx.lineWidth = Math.max(1, 2.2 + 1.5 * depth);
        ctx.beginPath();
        ctx.moveTo(cv.width / 2 + a[0] * zoom, cv.height / 2 - a[1] * zoom);
        ctx.lineTo(cv.width / 2 + b[0] * zoom, cv.height / 2 - b[1] * zoom);
        ctx.stroke();
      }}
    }});
    ctx.globalAlpha = 1;
  }}
  var drag = null;
  cv.addEventListener("mousedown", function(e) {{ drag = [e.clientX, e.clientY]; }});
  window.addEventListener("mouseup", function() {{ drag = null; }});
  window.addEventListener("mousemove", function(e) {{
    if (!drag) return;
    ry += (e.clientX - drag[0]) * 0.01;
    rx += (e.clientY - drag[1]) * 0.01;
    drag = [e.clientX, e.clientY];
    draw();
  }});
  cv.addEventListener("wheel", function(e) {{
    e.preventDefault();
    zoom *= e.deltaY < 0 ? 1.1 : 0.9;
    draw();
  }});
  draw();
}}
document.querySelectorAll("tr[data-aln]").forEach(function(tr) {{
  tr.addEventListener("click", function() {{
    var d = tr.nextElementSibling.firstElementChild.firstElementChild;
    d.style.display = d.style.display === "block" ? "none" : "block";
  }});
}});
document.querySelectorAll("th").forEach(function(th, i) {{
  th.addEventListener("click", function() {{
    var tb = th.closest("table").querySelector("tbody");
    var rows = [];
    var all = Array.from(tb.querySelectorAll("tr"));
    for (var k = 0; k < all.length; k += 2) rows.push([all[k], all[k+1]]);
    rows.sort(function(a, b) {{
      var x = a[0].children[i].innerText, y = b[0].children[i].innerText;
      var nx = parseFloat(x), ny = parseFloat(y);
      return isNaN(nx) || isNaN(ny) ? x.localeCompare(y) : nx - ny;
    }});
    rows.forEach(function(p) {{ tb.appendChild(p[0]); tb.appendChild(p[1]); }});
  }});
}});
</script></body></html>
"""


def _write_html(qdb, tdb, results, out_path, with_backtrace):
    """Self-contained interactive HTML report (the reference embeds its web
    app with a superposed-structure display, structureconvertalis.cpp:
    505-537; this is an original viewer — sortable hit table, expandable
    alignments, and a per-hit 3D C-alpha superposition rendered by a small
    embedded canvas engine). Coordinates: the query trace plus the target
    trace TM-superposed onto it (same transform as format-mode 5)."""
    import html as html_mod
    import json
    qidx = qdb.key_to_index()
    tidx = tdb.key_to_index()
    has_ca = qdb.ca is not None and tdb.ca is not None
    rows = []
    coords = []
    n = 0
    for qkey in sorted(results):
        qi = qidx[int(qkey)]
        qname = _names(qdb, qi)
        for r in results[qkey]:
            ti = tidx[r.db_key]
            aln_len = len(r.backtrace) if r.backtrace else compute_aln_length(
                r.q_start, r.q_end, r.t_start, r.t_end)
            if with_backtrace and r.backtrace:
                qa = _aligned_string(qdb.get_aa_str(qi), r.q_start, r.backtrace, "D")
                ta = _aligned_string(tdb.get_aa_str(ti), r.t_start, r.backtrace, "I")
                aln = html_mod.escape(f"Q {r.q_start + 1:>5} {qa}\n"
                                      f"T {r.t_start + 1:>5} {ta}")
            else:
                aln = "(run with -a for alignments)"
            view_id = -1
            if has_ca and r.backtrace:
                tmres = tm_ops.compute_tm_score(
                    qdb.get_ca(qi), tdb.get_ca(ti), r.q_start, r.t_start,
                    r.backtrace, r.t_len)
                u = np.asarray(tmres.u, dtype=np.float64)
                tt = np.asarray(tmres.t, dtype=np.float64)
                t_sup = np.asarray(tdb.get_ca(ti), np.float64) @ u.T + tt
                q_ca = np.asarray(qdb.get_ca(qi), np.float64)
                view_id = len(coords)
                coords.append({
                    "q": np.round(q_ca, 1).tolist(),
                    "t": np.round(t_sup, 1).tolist()})
            view_btn = (f'<button class="v3d" data-v="{view_id}" '
                        f'onclick="event.stopPropagation();show3d(this)">3D'
                        f"</button>" if view_id >= 0 else "")
            rows.append(
                f'<tr data-aln="1"><td>{html_mod.escape(qname)}</td>'
                f"<td>{html_mod.escape(_names(tdb, ti))}</td>"
                f"<td>{_fmt_f(r.seq_id)}</td><td>{aln_len}</td>"
                f"<td>{r.q_start + 1}-{r.q_end + 1}</td>"
                f"<td>{r.t_start + 1}-{r.t_end + 1}</td>"
                f"<td>{_fmt_e(r.evalue)}</td><td>{int(r.score)}</td>"
                f"<td>{view_btn}</td></tr>"
                f'<tr><td colspan="9"><div class="aln">{aln}</div>'
                f'<div class="viewer"></div></td></tr>')
            n += 1
    with open(out_path, "w") as f:
        f.write(_HTML_TEMPLATE.format(n_hits=n, n_queries=len(results),
                                      rows="\n".join(rows),
                                      coords=json.dumps(coords)))


def calc_prob_tp(score: float) -> float:
    """P(TP | structure bit score): fitted TP/FP gamma mixtures
    (reference: src/commons/CalcProbTP.h)."""
    import math
    s = np.float32(score)
    if s <= 10:
        return 0.0
    if s >= 100:
        return 1.0

    def gamma_pdf(alpha, beta, x):
        return np.float32(math.exp(alpha * math.log(beta) + (alpha - 1) * math.log(x)
                                   - beta * x - math.lgamma(alpha)))

    p_tp = (0.8279 * gamma_pdf(1.8123, 1 / 46.0042, s)
            + 0.1721 * gamma_pdf(1.0057, 1 / 563.5014, s)) * 0.1023
    p_fp = (0.34 * gamma_pdf(4.9259, 1 / 4.745, s)
            + 0.66 * gamma_pdf(9.4834, 1 / 1.3136, s)) * 0.8977
    return float(1.0 / (1.0 + (p_fp / p_tp)))
