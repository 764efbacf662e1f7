"""Multi-process distribution: `torch.distributed` + per-rank shard loading.

Port of `foldseek_tpu/parallel/distributed.py`. The reference distributes
with MPI: target-DB splits assigned round-robin to ranks, each rank
computing its split and the master merging hit lists through the shared
filesystem (reference: lib/mmseqs/src/prefiltering/Prefiltering.cpp:589-700
runMpiSplits, lib/mmseqs/src/commons/MMseqsMPI.cpp:10-27; workflow scripts
prefix heavy stages with $RUNNER, data/structuresearch.sh:46).

Here one process runs a device and the processes form one process group
(`init_distributed`); each rank loads ONLY its row range of the target DB
onto its device (`mesh.shard_targets`), queries are replicated, and the
per-rank top-ks merge with one all_gather. In `search` the align stage too
works on the rank's rows (`row_sharded_align`); the stages that hold the
whole DB on every rank (TM-align, LoLalign, the cluster cascade, multimer
expansion) are sharded by query (`sharded_align_all`). Either way the
ranks' records cross whole, pickled (`exchange`). No shared-filesystem
round trip, no master rank. Without a process group every entry point runs
as a world of one rank.

Launch every rank with torchrun's environment (MASTER_ADDR, MASTER_PORT,
WORLD_SIZE, RANK, LOCAL_RANK; `torchrun --nproc-per-node N script.py`) or
with explicit arguments, and call `init_distributed()` before any other
work on the device (`parallel/worker.py` is such a script).
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import get_device
from ..utils.log import logger, record_count, span

ROW_MULTIPLE = 128  # the panels' row block; also the per-rank row granularity

_rank_device: Optional[torch.device] = None


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     local_rank: Optional[int] = None,
                     device: str = "cuda",
                     backend: Optional[str] = None,
                     timeout_seconds: Optional[float] = None) -> int:
    """Form the process group from the arguments or torchrun's environment
    (explicit arguments win); returns this process's rank. Without an
    `init_method` and without MASTER_ADDR no world is configured: nothing
    happens and 0 is returned.

    The rank computes on `device`: `cuda` means `cuda:LOCAL_RANK`. The
    backend follows it, `nccl` for a card and `gloo` for the CPU, unless
    `backend` names one (gloo lets several ranks share one card, which NCCL
    refuses). A world that fails to form raises: no rank runs alone."""
    global _rank_device
    env = os.environ
    if init_method is None:
        if "MASTER_ADDR" not in env:
            if int(env.get("WORLD_SIZE", "1")) > 1:
                raise ValueError("WORLD_SIZE > 1 without MASTER_ADDR: the "
                                 "ranks have no address to meet at")
            return 0
        init_method = "env://"
    world_size = (world_size if world_size is not None
                  else int(env.get("WORLD_SIZE", "1")))
    rank = rank if rank is not None else int(env.get("RANK", "0"))
    local_rank = (local_rank if local_rank is not None
                  else int(env.get("LOCAL_RANK", "0")))
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    dev = get_device(str(dev))
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        # NCCL's object collectives send from the current device
        torch.cuda.set_device(dev)
    kwargs = {}
    if timeout_seconds is not None:
        kwargs["timeout"] = timedelta(seconds=timeout_seconds)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kwargs)
    _rank_device = dev
    logger.info("torch.distributed: rank %d/%d on %s, %s via %s", rank,
                world_size, dev, backend, init_method)
    return rank


def world():
    """(rank, world size): (0, 1) without a process group (the JAX
    package's process_index / process_count)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def rank_device() -> torch.device:
    """The device `init_distributed` gave this rank, else `cuda`."""
    return _rank_device if _rank_device is not None else get_device("cuda")


def padded_rows(n: int, size: int) -> int:
    """Rows of the target DB padded over `size` ranks: rows per rank rounded
    up to ROW_MULTIPLE (the JAX package's per-device rows)."""
    per_rank = -(-(-(-n // size)) // ROW_MULTIPLE) * ROW_MULTIPLE
    return per_rank * size


def host_row_range(n_pad: int, rank: int, size: int) -> tuple:
    """Row range [start, end) of the padded DB that `rank` owns (rows are
    distributed contiguously by rank)."""
    per_rank = n_pad // size
    return rank * per_rank, (rank + 1) * per_rank


def distributed_search(qdb, tdb, params, device=None,
                       same_db: Optional[bool] = None):
    """`search` in the current world on `device` (default: the rank's, from
    `init_distributed`): in a world of several ranks the prefilter and the
    align stage run over this rank's rows of the target DB
    (`sharded_prefilter`, `row_sharded_align`). Returns the full {qkey:
    [AlnResult]} on every rank."""
    from ..search.pipeline import search
    device = torch.device(device) if device is not None else rank_device()
    return search(qdb, tdb, params, device, same_db=same_db)


def sharded_prefilter(qdb, tdb, params, device) -> Dict[int, List[int]]:
    """The ungapped prefilter (`--prefilter-mode 1`) of a world: each rank
    scans its rows (`DistributedPrefilter`), the lists merge, and every rank
    gets {qkey: [target key]} as one process would."""
    seqs = [np.asarray(qdb.get_ss(qi)) for qi in range(qdb.size)]
    hits = DistributedPrefilter(tdb, device).query_batch(seqs, params)
    return {int(qdb.keys[qi]): [k for k, _ in hits[qi]]
            for qi in range(qdb.size)}


def exchange(obj) -> list:
    """Every rank's `obj`, in rank order, on every rank: pickled whole, so
    records cross exactly (every float at full precision)."""
    parts = [None] * world()[1]
    dist.all_gather_object(parts, obj)
    return parts


def row_sharded_align(qdb, tdb, prefilter, params, device,
                      same_db: bool) -> Dict[int, list]:
    """The align stage of a world over the row-sharded DB: each rank aligns
    the candidates of every query that lie in its rows (`shard_targets`)
    with `align_all` against its own resident panels (SW kernel, residues,
    C-alpha, gate fleets), E-values over the whole DB's residues and the
    fleets-or-host choice made on the whole stage's pairs, as one process
    makes both. Span `align.exchange`: the ranks' records gathered exactly
    (`exchange`), merged, and each query's list put in the final order
    (`compare_hits_by_structure_bits` or `compare_hits`, stable, so ties
    fall as in one process). Counts: `shard.pairs` (pairs this rank
    aligned), and from the exchange `shard.pairs_max` (the busiest rank's)
    and `shard.pairs_all` (all ranks'). Every rank returns the full {qkey:
    [AlnResult]}.

    An accept/reject budget below INT_MAX stops a query's loop in prefilter
    order, which no rank can follow over its rows alone: the stage is then
    sharded by query (`sharded_align_all`)."""
    from ..search.align import align_all
    from ..search.params import INT_MAX
    from ..search.results import compare_hits, compare_hits_by_structure_bits
    from .mesh import make_mesh, shard_targets

    if params.max_accept < INT_MAX or params.max_rejected < INT_MAX:
        return sharded_align_all(qdb, tdb, prefilter, params, device,
                                 same_db=same_db)
    mesh = make_mesh(device)
    st = shard_targets(tdb, mesh)
    row = tdb.key_to_index()
    mine = {}
    for qk, cands in prefilter.items():
        rows = np.fromiter((row[int(k)] for k in cands), np.int64, len(cands))
        keep = np.nonzero((rows >= st.row_start) & (rows < st.row_end))[0]
        mine[qk] = [cands[i] for i in keep.tolist()]
    n_mine = sum(len(v) for v in mine.values())
    record_count("shard.pairs", n_mine)
    res = align_all(qdb, st.view, mine, params, mesh.device, same_db=same_db,
                    db_residues=tdb.total_residues,
                    gate_pairs=sum(len(v) for v in prefilter.values()))
    with span("align.exchange"):
        parts = exchange((n_mine, res))
        pairs = [n for n, _ in parts]
        record_count("shard.pairs_max", max(pairs))
        record_count("shard.pairs_all", sum(pairs))
        out = {int(qk): [] for qk in prefilter}
        for _n, part in parts:
            for qk, rs in part.items():
                out[int(qk)].extend(rs)
        key = (compare_hits_by_structure_bits
               if params.sort_by_structure_bits else compare_hits)
        for rs in out.values():
            rs.sort(key=key)
    return out


def sharded_align_all(qdb, tdb, prefilter, params, device, same_db=None,
                      query_profiles=None, stage_fn=None):
    """Query-sharded align stage: each rank runs align_all on `device` over
    its slice of the (sorted) query keys against its full target mmap (the
    reference's $RUNNER on structurealign, data/structuresearch.sh:50; the
    TM-align and LoLalign stages, the cluster cascade's and multimer
    expansion's heavy stage, data/structurecluster.sh:95,
    data/multimersearch.sh:27), then the records of every rank are
    gathered exactly (`exchange`, span `align.exchange`), so every rank
    returns the full, identical {qkey: [AlnResult]}. A world of one rank:
    plain align_all, no gather."""
    from ..search.align import align_all

    if same_db is None:
        same_db = qdb.path == tdb.path
    rank, size = world()
    my_pref = {qk: cands
               for i, (qk, cands) in enumerate(sorted(prefilter.items()))
               if i % size == rank}
    if stage_fn is not None:
        # alternative per-hit aligner with the align_all signature minus
        # device and query_profiles (tmalign_all / lolalign_all stages)
        mine = stage_fn(qdb, tdb, my_pref, params, same_db=same_db)
    else:
        mine = align_all(qdb, tdb, my_pref, params, device, same_db=same_db,
                         query_profiles=query_profiles)
    if size == 1:
        return mine
    with span("align.exchange"):
        out = {int(qk): [] for qk in prefilter}
        for part in exchange(mine):
            out.update(part)
    return out


def alignment_backend(align_fn):
    """`align_fn` (the align_all its caller's module holds), lifted across
    ranks when the world has more than one: the $RUNNER-prefix analogue
    workflows use to distribute their heavy align stages without changing
    call sites (both take the same arguments). The caller tells the two
    apart by identity."""
    return sharded_align_all if world()[1] > 1 else align_fn


class DistributedPrefilter:
    """Ungapped prefilter over a row-sharded target DB: this rank's shard
    (`mesh.shard_targets`, made once per DB and kept), scanned and gated
    as `search.ungapped.UngappedPrefilter` gates (score above
    MIN_DIAG_SCORE, the coverage pre-gate, top max_seqs by (score desc, key
    asc)) on every rank, with one all_gather merge."""

    def __init__(self, tdb, device=None):
        from .mesh import make_mesh, shard_targets
        self.tdb = tdb
        self.mesh = make_mesh(device)
        self.st = shard_targets(tdb, self.mesh)

    def query_batch(self, seqs, params) -> List[List[tuple]]:
        from ..search.ungapped import make_query_profile
        from .mesh import sharded_gapless_topk

        profs, biases = [], []
        with span("prefilter.profiles"):
            for q_ss in seqs:
                p, b = make_query_profile(q_ss)
                profs.append(p)
                biases.append(b)
        # queries of any length share the stacks: the gapless kernel has no
        # row limit, so the JAX package's long-query split is not needed
        s, keys = sharded_gapless_topk(self.st, profs, biases, params)
        with span("prefilter.merge"):
            return [list(zip(keys[r][keys[r] >= 0].tolist(),
                             s[r][keys[r] >= 0].tolist()))
                    for r in range(len(seqs))]
