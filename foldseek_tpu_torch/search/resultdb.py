"""Alignment result DB: per-query text records, same line format as the
reference alignment DB (reference: Matcher::resultToBuffer,
lib/mmseqs/src/alignment/Matcher.cpp:279-326) stored as one TSV with a
leading query-key column."""
from __future__ import annotations

import os
from typing import Dict, List, Tuple

from .results import AlnResult, expand_backtrace, result_to_line


def write_result_db(results: Dict[int, List[AlnResult]], path: str,
                    add_backtrace: bool):
    with open(path, "w") as f:
        f.write(f"#foldseek-tpu alnres v1 backtrace={int(add_backtrace)}\n")
        for qkey in sorted(results):
            for r in results[qkey]:
                f.write(f"{qkey}\t{result_to_line(r, add_backtrace)}\n")


def parse_result_line(line: str) -> Tuple[int, AlnResult]:
    """One `qkey\\t<Matcher::resultToBuffer columns>` record."""
    fields = line.rstrip("\n").split("\t")
    qkey = int(fields[0])
    r = AlnResult(
        db_key=int(fields[1]), score=int(fields[2]),
        seq_id=float(fields[3]), seq_id_str=fields[3],
        evalue=float(fields[4]),
        q_start=int(fields[5]), q_end=int(fields[6]), q_len=int(fields[7]),
        t_start=int(fields[8]), t_end=int(fields[9]), t_len=int(fields[10]),
        backtrace=expand_backtrace(fields[11]) if len(fields) > 11 else "")
    return qkey, r


def read_result_db(path: str) -> Tuple[Dict[int, List[AlnResult]], bool]:
    results: Dict[int, List[AlnResult]] = {}
    has_bt = False
    with open(path) as f:
        header = f.readline()
        if header.startswith("#foldseek-tpu alnres"):
            has_bt = "backtrace=1" in header
        else:
            raise ValueError(f"{path}: not a foldseek-tpu alignment result DB")
        for line in f:
            qkey, r = parse_result_line(line)
            results.setdefault(qkey, []).append(r)
    return results, has_bt
