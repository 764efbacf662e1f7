"""Alignment result record — mirror of Matcher::result_t
(reference: lib/mmseqs/src/alignment/Matcher.h:32-50) plus the text
serialization used by alignment DBs (Matcher.cpp:279-326)."""
from __future__ import annotations

import re
from dataclasses import dataclass, field


@dataclass
class AlnResult:
    db_key: int
    score: int              # raw fwd-rev score, structure-bit scaled when enabled
    seq_id: float
    evalue: float
    q_start: int
    q_end: int
    q_len: int
    t_start: int
    t_end: int
    t_len: int
    backtrace: str = ""     # expanded M/I/D
    qcov: float = 0.0
    tcov: float = 0.0
    aln_length: int = 0
    identical: int = 0
    lddt: float = 0.0
    tm: float = 0.0
    u: object = None        # [3,3] rotation (target->query frame)
    t: object = None        # [3] translation
    # verbatim seq-id text for records parsed from an alignment DB. The
    # reference's resume path reuses the artifact file bytes; re-deriving
    # the text from the parsed float can drop one milli ((int)(f32(0.253)
    # *1000) == 252), so round-tripped records keep their original text.
    seq_id_str: str = ""


def compress_backtrace(bt: str) -> str:
    """MMMII -> 3M2I (Matcher::compressAlignment)."""
    out = []
    i = 0
    while i < len(bt):
        j = i
        while j < len(bt) and bt[j] == bt[i]:
            j += 1
        out.append(f"{j - i}{bt[i]}")
        i = j
    return "".join(out)


def expand_backtrace(cigar: str) -> str:
    return "".join(op * int(n) for n, op in re.findall(r"(\d+)([MIDmid])", cigar))


def format_seq_id(seq_id: float) -> str:
    """reference: Util::fastSeqIdToBuffer — '1.00' exactly for 1.0, else
    '0.' + truncated milli digits. The multiply happens in float32
    ((int)(seqId * 1000) with float seqId), which rounds e.g.
    float32(0.22)*1000 up to exactly 220.0 before truncation."""
    if seq_id == 1.0:
        return "1.00"
    import numpy as np
    milli = int(np.float32(np.float32(seq_id) * np.float32(1000)))
    return f"0.{milli:03d}"


def result_to_line(r: AlnResult, add_backtrace: bool) -> str:
    """Alignment DB text record (Matcher::resultToBuffer)."""
    fields = [str(r.db_key), str(int(r.score)),
              r.seq_id_str or format_seq_id(r.seq_id),
              f"{r.evalue:.3E}", str(r.q_start), str(r.q_end), str(r.q_len),
              str(r.t_start), str(r.t_end), str(r.t_len)]
    if add_backtrace:
        fields.append(compress_backtrace(r.backtrace))
    return "\t".join(fields)


def compute_aln_length(q_start, q_end, t_start, t_end) -> int:
    """Matcher::computeAlnLength: max span (used when no backtrace stored)."""
    return max(q_end - q_start, t_end - t_start) + 1


def compare_hits_by_structure_bits(r: AlnResult):
    """reference: structurealign.cpp:21-29."""
    return (-r.score, r.t_len, r.db_key)


def compare_hits(r: AlnResult):
    """reference: Matcher.h:157-168."""
    return (r.evalue, -r.score, r.t_len, r.db_key)
