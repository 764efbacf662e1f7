"""Prefilter stages of the port (reference: src/workflow/StructureSearch.cpp:
114-127, data/structuresearch.sh:41-53).

* KMER (mode 0, the default) — the k-mer prefilter on the host,
  search/kmer.py.
* UNGAPPED (mode 1, what `--gpu 1` selects) — the gapless device scan,
  search/ungapped.py.
* EXHAUSTIVE (mode 2 or --exhaustive-search) — every query paired with every
  target in key order.
* INDEX SERVER (`--index-server <socket>`, wins over every mode as in
  `foldseek_tpu`) — one round trip to a running `indexserver` that holds the
  target DB's panels on its device (`server.py`).
Mode 3 (ungapped + gapped, results without the align stage) is dispatched by
`search/pipeline.py` before this stage, with or without a server.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..db.storage import StructDB
from .params import PREF_MODE_EXHAUSTIVE, PREF_MODE_UNGAPPED, SearchParams


def exhaustive_prefilter(qdb: StructDB, tdb: StructDB) -> Dict[int, List[int]]:
    tkeys = [int(k) for k in tdb.keys]
    return {int(qk): tkeys for qk in qdb.keys}


def run_prefilter(qdb: StructDB, tdb: StructDB, params: SearchParams,
                  device: torch.device) -> Dict[int, List[int]]:
    if params.index_server:
        from ..server import server_prefilter
        return server_prefilter(qdb, params.index_server, params.max_seqs)
    if params.exhaustive_search or params.prefilter_mode == PREF_MODE_EXHAUSTIVE:
        return exhaustive_prefilter(qdb, tdb)
    if params.prefilter_mode == PREF_MODE_UNGAPPED:
        from .ungapped import ungapped_prefilter
        return ungapped_prefilter(qdb, tdb, params, device)
    from .kmer import kmer_prefilter
    return kmer_prefilter(qdb, tdb, params, k=params.kmer_size)
