"""Cluster-search: search cluster representatives, expand to members.

Equivalent of the reference's `createclusearchdb` + `--cluster-search 1`
flow (reference: lib/mmseqs/src/util/createclusterdb.cpp:15-130 builds a
representatives DB plus a combined `_seq` DB; data/structuresearch.sh:125-140
expands first-pass hits through the cluster members with `mergeresultsbyset`
and re-runs the aligner against the `_seq` DB — structurealign.cpp:248 reads
the `_seq_ca` satellites when the result DB carries the extended dbtype).

Here the clustered target is a directory triple:
  out/        representatives StructDB (original keys preserved)
  out_seq/    full StructDB (reps + members, original keys)
  out_clu.tsv rep_key -> member_key lines (rep listed as its own member)

Copy of `foldseek_tpu/search/clusearch.py`; the search over the triple is
the `cluster_search` branch of `search/pipeline.py`.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..db.storage import StructDB, StructDBWriter, is_db, load_db
from ..utils.log import logger


def _write_subdb(db: StructDB, keys: List[int], out_path: str) -> StructDB:
    key_to_idx = db.key_to_index()
    w = StructDBWriter(out_path)
    w.sources = list(db.sources or [])
    if db.ca is None:
        w._has_ca = False
    for k in sorted(keys):
        i = key_to_idx[int(k)]
        ca = db.get_ca(i) if db.ca is not None else None
        s, e = int(db.offsets[i]), int(db.offsets[i + 1])
        w.add_entry(int(k), db.names[i], db.headers[i],
                    db.aa[s:e], db.ss[s:e], ca, db.mask[s:e],
                    file_id=int(db.fileids[i]) if db.fileids is not None else 0)
    return w.finish()


def create_clusearch_db(db: StructDB, clusters: Dict[int, List[int]],
                        out_path: str) -> StructDB:
    """clusters: rep_key -> member keys (members may or may not include the
    rep; it is always recorded in the mapping like the reference's cluster
    DB entries, which the expansion step concatenates verbatim)."""
    rep_keys = sorted(int(r) for r in clusters)
    rep_db = _write_subdb(db, rep_keys, out_path)
    all_keys = set()
    for r, members in clusters.items():
        all_keys.add(int(r))
        all_keys.update(int(m) for m in members)
    _write_subdb(db, sorted(all_keys), out_path + "_seq")
    with open(out_path + "_clu.tsv", "w") as f:
        for r in rep_keys:
            members = [int(m) for m in clusters[r]]
            if int(r) not in members:
                members = [int(r)] + members
            for m in members:
                f.write(f"{r}\t{m}\n")
    logger.info("createclusearchdb: %d representatives, %d sequences -> %s",
                len(rep_keys), len(all_keys), out_path)
    return rep_db


def load_clusearch(path: str) -> Optional[Tuple[StructDB, StructDB,
                                                Dict[int, List[int]]]]:
    """(rep_db, seq_db, rep->members) if `path` is a clustered search DB."""
    clu = path + "_clu.tsv"
    if not (is_db(path) and is_db(path + "_seq") and os.path.isfile(clu)):
        return None
    mapping: Dict[int, List[int]] = {}
    for line in open(clu):
        r, m = line.split("\t")
        mapping.setdefault(int(r), []).append(int(m))
    return load_db(path), load_db(path + "_seq"), mapping


def expand_hits(results, clu_map: Dict[int, List[int]]) -> Dict[int, List[int]]:
    """mergeresultsbyset equivalent: per query, concatenate the member lists
    of each hit representative in hit order
    (lib/mmseqs/src/util/mergeresultsbyset.cpp:49-64)."""
    expanded: Dict[int, List[int]] = {}
    for qkey, rs in results.items():
        out: List[int] = []
        seen = set()
        for r in rs:
            for m in clu_map.get(int(r.db_key), [int(r.db_key)]):
                if m not in seen:
                    seen.add(m)
                    out.append(m)
        expanded[int(qkey)] = out
    return expanded
