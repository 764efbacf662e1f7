"""createmultimerreport: scorecomplex results -> complex-level TSV
(reference: src/strucclustutils/createmultimerreport.cpp).

Output columns: qComplex, tComplex, qChains, tChains, qTM, tTM, u, t,
qComplexCov, tComplexCov, qChainTms, tChainTms, interfaceLddt, assId —
TM/cov at %1.5f, u/t passed through as written by scoremultimer. Copy of
`foldseek_tpu/multimer/report.py`.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from ..db.storage import StructDB
from .scoremultimer import complex_maps


def split_complex_chain(name: str) -> Tuple[str, str]:
    """'1tim_A' -> ('1tim', 'A') (getComplexNameChainName)."""
    pos = name.rfind("_")
    if pos < 0:
        return name, ""
    return name[:pos], name[pos + 1:]


def create_multimer_report(qdb: StructDB, tdb: StructDB,
                           score_results: Dict[int, List[str]]) -> List[str]:
    _, q_complex_chains, q_complex_order = complex_maps(qdb)
    q_key_to_idx = qdb.key_to_index()
    t_key_to_idx = tdb.key_to_index()

    out_rows = []  # (qComplexId, assId, line)
    for q_cid in q_complex_order:
        ass_rows: Dict[int, dict] = {}
        ass_order: List[int] = []
        for qk in q_complex_chains[q_cid]:
            for line in score_results.get(qk, []):
                cols = line.split("\t")
                # 16 cols: aln(11) qTm tTm u t assId; 21 adds cov/chainTm/iLddt
                t_key = int(cols[0])
                if len(cols) == 21:
                    (q_tm, t_tm, u, t, q_cov, t_cov,
                     q_chain_tms, t_chain_tms, i_lddt, ass_id) = (
                        float(cols[11]), float(cols[12]), cols[13], cols[14],
                        float(cols[15]), float(cols[16]), cols[17], cols[18],
                        cols[19], int(cols[20]))
                else:
                    (q_tm, t_tm, u, t, ass_id) = (
                        float(cols[11]), float(cols[12]), cols[13], cols[14],
                        int(cols[15]))
                    q_cov = t_cov = 0.0
                    q_chain_tms = t_chain_tms = i_lddt = "0"
                q_name = qdb.names[q_key_to_idx[qk]]
                t_name = tdb.names[t_key_to_idx[t_key]]
                if ass_id not in ass_rows:
                    ass_rows[ass_id] = {
                        "q_names": [q_name], "t_names": [t_name],
                        "q_tm": q_tm, "t_tm": t_tm, "u": u, "t": t,
                        "q_cov": q_cov, "t_cov": t_cov,
                        "q_chain_tms": q_chain_tms, "t_chain_tms": t_chain_tms,
                        "i_lddt": i_lddt}
                    ass_order.append(ass_id)
                else:
                    ass_rows[ass_id]["q_names"].append(q_name)
                    ass_rows[ass_id]["t_names"].append(t_name)
        for ass_id in ass_order:
            row = ass_rows[ass_id]
            q_complex, _ = split_complex_chain(row["q_names"][0])
            t_complex, _ = split_complex_chain(row["t_names"][0])
            q_chains = ",".join(split_complex_chain(n)[1] for n in row["q_names"])
            t_chains = ",".join(split_complex_chain(n)[1] for n in row["t_names"])
            line = (f"{q_complex}\t{t_complex}\t{q_chains}\t{t_chains}\t"
                    f"{row['q_tm']:1.5f}\t{row['t_tm']:1.5f}\t"
                    f"{row['u']}\t{row['t']}\t"
                    f"{row['q_cov']:1.5f}\t{row['t_cov']:1.5f}\t"
                    f"{row['q_chain_tms']}\t{row['t_chain_tms']}\t"
                    f"{row['i_lddt']}\t{ass_id}")
            out_rows.append((q_cid, ass_id, line))
    out_rows.sort(key=lambda r: (r[0], r[1]))
    return [r[2] for r in out_rows]
