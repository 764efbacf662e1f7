"""expandmultimer: widen chain-level hits to all chain pairs of the hit
complexes (reference: src/strucclustutils/expandmultimer.cpp).

For each query complex, collect every target complex containing any hit of
any query chain, then emit every (query chain, target chain) pair over those
complexes, sorted, deduplicated per query chain. Copy of
`foldseek_tpu/multimer/expand.py`.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

from ..db.storage import StructDB
from .scoremultimer import complex_maps


def expand_multimer(qdb: StructDB, tdb: StructDB,
                    hits: Dict[int, Sequence[int]]) -> Dict[int, List[int]]:
    """hits: query chain key -> hit target chain keys.
    Returns query chain key -> expanded candidate target chain keys."""
    _, q_complex_chains, q_complex_order = complex_maps(qdb)
    t_chain_to_complex, t_complex_chains, _ = complex_maps(tdb)

    out: Dict[int, List[int]] = {}
    for q_cid in q_complex_order:
        q_chains = q_complex_chains[q_cid]
        found = set()
        for qk in q_chains:
            for tk in hits.get(qk, []):
                found.add(t_chain_to_complex[int(tk)])
        if not found:
            for qk in q_chains:
                out[qk] = []
            continue
        pairs = []
        for t_cid in sorted(found):  # std::set iteration order
            for qk in q_chains:
                for tk in t_complex_chains[t_cid]:
                    pairs.append((qk, tk))
        pairs.sort()
        for qk in q_chains:
            out.setdefault(qk, [])
        for qk, tk in pairs:
            out[qk].append(tk)
    return out
