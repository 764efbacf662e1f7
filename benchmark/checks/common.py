"""The comparisons that decide `correct`: what the timed calls reported for
a sample of their queries against what the reference works out for the same
queries from the same generated DB. `mode1.py` and `mode3.py` bind them to
the reference's expectations; a configuration names its check by file.

Every number compared has a limit (the configuration file's `limits`); a
run is correct when every number is within its limit. Records are plain
dicts: key, score, q_start, q_end, t_start, t_end, evalue, backtrace (None
where the side has none, as the control), and each query's m8 lines (None
where the side prints none).
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from ..reference import structure
from ..reference.scoring import GAP_EXTEND, GAP_OPEN, dual_profile

# the m8 text rounds: fident to 3 decimals after the milli truncation of the
# identity, mismatch through that identity (one more a 1,000 columns), the
# E-value to 4 digits
FIDENT_TEXT = 0.0011
MISMATCH_TEXT = 1
EVALUE_TEXT = 5.1e-4
# structure bits int(raw * sqrt(TM * LDDT)): the card's gate fleets compute
# TM and LDDT in float32, the reference in float64, so the truncation to an
# integer may fall on either side: one bit (the program's own band between
# its device and host gates)
BITS_BAND = 1


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-300)


def path_facts(bt: str, q_start: int, t_start: int, q_aa, t_aa, prof):
    """(q_end, t_end, score under the forward profile, identical AA,
    M columns, gap runs) of a backtrace, or None when it leaves the
    sequences."""
    qi, ti, score, ident, m, runs, prev = q_start, t_start, 0, 0, 0, 0, ""
    go, ge = GAP_OPEN, GAP_EXTEND
    lq, lt = len(q_aa), len(t_aa)
    for op in bt:
        if op == "M":
            if not (0 <= qi < lq and 0 <= ti < lt):
                return None
            score += int(prof[0][t_aa[ti], qi]) + int(prof[1][prof[2][ti],
                                                               qi])
            ident += int(q_aa[qi] == t_aa[ti])
            m += 1
            qi += 1
            ti += 1
        else:
            score -= go if op != prev else ge
            runs += op != prev
            if op == "I":
                qi += 1
            else:
                ti += 1
        prev = op
    return qi - 1, ti - 1, score, ident, m, runs


def _m8(line: str):
    f = line.split("\t")
    return dict(query=f[0], target=f[1], fident=float(f[2]), alnlen=int(f[3]),
                mismatch=int(f[4]), gapopen=int(f[5]), qstart=int(f[6]),
                qend=int(f[7]), tstart=int(f[8]), tend=int(f[9]),
                evalue=float(f[10]), bits=int(f[11]))


def check_mode1(sample: List[dict], db, limits: Dict, tm_pick) -> Dict:
    """`sample`: per query {name, key, aa, ss, ca, records, lines,
    expected} with `expected` from reference.expect.mode1. `tm_pick(idx)`
    gives those of a query's hit indices `idx` whose structure bits are
    worked out again. Returns the numbers compared."""
    n = dict(hit_sets_differ=0, ends_wrong=0, paths_wrong=0, order_wrong=0,
             bits_off=0, m8_wrong=0, evalue_gap=0.0, bits_gap=0.0,
             hits_checked=0, block_fail_rows=0)
    for q in sample:
        exp, recs = q["expected"], q["records"]
        if {r["key"] for r in recs} != set(exp) or len(recs) != len(exp):
            n["hit_sets_differ"] += 1
        prof = dual_profile(q["aa"], q["ss"])
        bits_ref = {}
        for j, r in enumerate(recs):
            e = exp.get(r["key"])
            if e is None:
                continue
            n["hits_checked"] += 1
            if (r["q_end"], r["t_end"]) != (e["q_end"], e["t_end"]):
                n["ends_wrong"] += 1
            n["evalue_gap"] = max(n["evalue_gap"], _rel(r["evalue"],
                                                        e["evalue"]))
            bt = r.get("backtrace")
            if bt is None:
                continue
            if not bt:
                n["block_fail_rows"] += 1
                bits_ref[j] = 0
                continue
            t0, t1 = db.offsets[r["key"]], db.offsets[r["key"] + 1]
            facts = path_facts(bt, r["q_start"], r["t_start"], q["aa"],
                               db.aa[t0:t1], (prof[0], prof[1], db.ss[t0:t1]))
            if facts is None or facts[:3] != (e["q_end"], e["t_end"],
                                              e["fwd"]):
                n["paths_wrong"] += 1
            r["_facts"] = facts
        # structure bits of a sample of hits with a path, by the reference's
        # TM-score and LDDT of the reported alignment
        with_path = [j for j, r in enumerate(recs)
                     if r.get("backtrace") and r["key"] in exp]
        for j in tm_pick(with_path):
            r = recs[j]
            t0, t1 = db.offsets[r["key"]], db.offsets[r["key"] + 1]
            norm = min(r["q_end"] - r["q_start"], r["t_end"] - r["t_start"])
            tm = structure.tm_score(q["ca"], db.ca[t0:t1], r["q_start"],
                                    r["t_start"], r["backtrace"], norm)
            ld = structure.lddt(q["ca"], db.ca[t0:t1], r["q_start"],
                                r["t_start"], r["backtrace"])
            f = tm * ld
            raw = exp[r["key"]]["raw"]
            bits_ref[j] = int(raw * math.sqrt(f)) if f > 0 else 0
            n["bits_gap"] = max(n["bits_gap"],
                                float(abs(r["score"] - bits_ref[j])))
            n["bits_off"] += int(abs(r["score"] - bits_ref[j]) > BITS_BAND)
        lens = np.diff(db.offsets)
        for a, b in zip(recs, recs[1:]):
            if ((-a["score"], lens[a["key"]], a["key"])
                    > (-b["score"], lens[b["key"]], b["key"])):
                n["order_wrong"] += 1
        if q["lines"] is None:
            continue
        lines = [_m8(x) for x in q["lines"]]
        if len(lines) != len(recs):
            n["m8_wrong"] += abs(len(lines) - len(recs)) or 1
        for j, (r, x) in enumerate(zip(recs, lines)):
            e = exp.get(r["key"])
            bad = (x["query"] != q["name"] or x["target"] != db_name(r["key"])
                   or e is None)
            if not bad:
                bad = (x["qend"], x["tend"]) != (e["q_end"] + 1,
                                                 e["t_end"] + 1)
                bad |= _rel(x["evalue"], e["evalue"]) > EVALUE_TEXT + limits[
                    "evalue_gap"]
                ref_bits = bits_ref.get(j)
                if ref_bits is not None:
                    bad |= abs(x["bits"] - ref_bits) > BITS_BAND
                else:
                    bad |= not 0 <= x["bits"] <= max(e["raw"], 0)
                facts = r.get("_facts")
                if facts is not None:
                    _qe, _te, _s, ident, m, runs = facts
                    alnlen = len(r["backtrace"])
                    bad |= (x["qstart"], x["tstart"], x["alnlen"],
                            x["gapopen"]) != (r["q_start"] + 1,
                                              r["t_start"] + 1, alnlen, runs)
                    bad |= abs(x["fident"] - ident / alnlen) > FIDENT_TEXT
                    bad |= abs(x["mismatch"] - (m - ident)) > (
                        MISMATCH_TEXT + 0.001 * alnlen)
            n["m8_wrong"] += int(bad)
    return n


def check_mode3(sample: List[dict], db, limits: Dict) -> Dict:
    """`sample`: per query {name, key, ss, records, lines, expected} with
    `expected` the ordered list of reference.expect.mode3."""
    n = dict(lists_differ=0, m8_wrong=0, evalue_gap=0.0, hits_checked=0)
    for q in sample:
        exp, recs = q["expected"], q["records"]
        mine = [(r["key"], r["score"], r["q_end"], r["t_end"]) for r in recs]
        ref = [(e["key"], e["score"], e["q_end"], e["t_end"]) for e in exp]
        if mine != ref:
            n["lists_differ"] += 1
        by_key = {e["key"]: e for e in exp}
        for r in recs:
            e = by_key.get(r["key"])
            if e is not None:
                n["hits_checked"] += 1
                n["evalue_gap"] = max(n["evalue_gap"],
                                      _rel(r["evalue"], e["evalue"]))
        if q["lines"] is None:
            continue
        lines = [_m8(x) for x in q["lines"]]
        if len(lines) != len(exp):
            n["m8_wrong"] += abs(len(lines) - len(exp)) or 1
        for x, e in zip(lines, exp):
            est = min(1.0, max(0.0, e["score"] / float(max(e["q_end"],
                                                            e["t_end"], 1))
                               * 0.1656 + 0.1141))
            bad = (x["query"] != q["name"] or x["target"] != db_name(e["key"])
                   or (x["alnlen"], x["gapopen"], x["qstart"], x["qend"],
                       x["tstart"], x["tend"], x["bits"])
                   != (max(e["q_end"], e["t_end"]) + 1, 0, 1, e["q_end"] + 1,
                       1, e["t_end"] + 1, e["score"])
                   or abs(x["fident"] - est) > FIDENT_TEXT
                   or abs(x["mismatch"] - min(e["q_end"], e["t_end"])
                          * (1.0 - est)) > MISMATCH_TEXT + 0.5
                   or _rel(x["evalue"], e["evalue"])
                   > EVALUE_TEXT + limits["evalue_gap"])
            n["m8_wrong"] += int(bad)
    return n


def db_name(key: int) -> str:
    """Entry name the harness gives DB entry `key`."""
    return f"T{key}"


def verdict(numbers: Dict, limits: Dict) -> (bool, List[str]):
    """(correct, one line a number: name, value, limit)."""
    ok, out = True, []
    for name, lim in limits.items():
        v = numbers.get(name)
        if v is None:
            continue
        good = v <= lim
        ok &= good
        out.append(f"{name} {v!r} limit {lim!r}{'' if good else ' FAILED'}")
    return ok, out
