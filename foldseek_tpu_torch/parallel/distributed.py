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
per-rank top-ks merge with one all_gather; the align stage is sharded by
query and its records merge with one all_gather of their text lines. No
shared-filesystem round trip, no master rank. Without a process group every
entry point runs as a world of one rank.

Launch every rank with torchrun's environment (MASTER_ADDR, MASTER_PORT,
WORLD_SIZE, RANK, LOCAL_RANK; `torchrun --nproc-per-node N script.py`) or
with explicit arguments, and call `init_distributed()` before any other
work on the device (`parallel/worker.py` is such a script).
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import get_device
from ..utils.log import logger

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
    """Multi-rank end-to-end search: the prefilter scans the row-sharded
    target DB on every rank (DistributedPrefilter), then the align stage
    (SW kernel, backtraces, TM/LDDT) is sharded by QUERY across the ranks
    (each aligns the queries i % size == rank against its full mmap of the
    target DB, the reference's omp-for over queries lifted to processes;
    $RUNNER on structurealign, data/structuresearch.sh:50) and the records
    are merged with one all_gather. A world of one rank takes the same path.

    Returns the full {qkey: [AlnResult]} on every rank."""
    if same_db is None:
        same_db = qdb.path == tdb.path
    pref_obj = DistributedPrefilter(tdb, device)
    seqs = [np.asarray(qdb.get_ss(i)) for i in range(qdb.size)]
    hits = pref_obj.query_batch(seqs, params)
    pref = {int(qdb.keys[qi]): [t for t, _ in hits[qi]]
            for qi in range(qdb.size)}
    return sharded_align_all(qdb, tdb, pref, params, pref_obj.mesh.device,
                             same_db=same_db)


def sharded_align_all(qdb, tdb, prefilter, params, device, same_db=None,
                      query_profiles=None, stage_fn=None):
    """Query-sharded align stage: each rank runs align_all on `device` over
    its slice of the (sorted) query keys against its full target mmap (the
    reference's $RUNNER on structurealign, data/structuresearch.sh:50; also
    the cluster cascade's and multimer expansion's heavy stage,
    data/structurecluster.sh:95, data/multimersearch.sh:27), then the
    records of every rank are merged with one all_gather of their text
    lines (`result_to_line`, parsed back by `parse_result_line`, as the JAX
    package merges them), so every rank returns the full, identical {qkey:
    [AlnResult]}. A world of one rank: plain align_all, no gather."""
    from ..search.align import align_all
    from ..search.results import result_to_line
    from ..search.resultdb import parse_result_line

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
    text = "\n".join(f"{qk}\t{result_to_line(r, True)}"
                     for qk in sorted(mine) for r in mine[qk])
    texts = [None] * size
    dist.all_gather_object(texts, text)
    out = {int(qk): [] for qk in prefilter}
    for part in texts:
        for line in part.splitlines():
            qk, r = parse_result_line(line)
            out.setdefault(qk, []).append(r)
    return out


def alignment_backend(align_fn):
    """`align_fn` (the align_all its caller's module holds), lifted across
    ranks when the world has more than one: the $RUNNER-prefix analogue
    workflows use to distribute their heavy align stages without changing
    call sites (both take the same arguments). The caller tells the two
    apart by identity."""
    return sharded_align_all if world()[1] > 1 else align_fn


class DistributedPrefilter:
    """Ungapped prefilter over a row-sharded target DB: the gating and
    ordering of search.ungapped.UngappedPrefilter (score above
    MIN_DIAG_SCORE, top max_seqs by (score desc, key asc)), with the scan
    running on every rank and one all_gather merge. Like the JAX package's,
    it applies no coverage pre-gate (`can_be_covered`)."""

    def __init__(self, tdb, device=None):
        from .mesh import make_mesh, shard_targets
        self.tdb = tdb
        self.mesh = make_mesh(device)
        self.st = shard_targets(tdb, self.mesh)

    def query_batch(self, seqs, params) -> List[List[tuple]]:
        from ..search.ungapped import MIN_DIAG_SCORE, make_query_profile
        from .mesh import sharded_gapless_topk

        profs, biases = [], []
        for q_ss in seqs:
            p, b = make_query_profile(q_ss)
            profs.append(p)
            biases.append(b)
        # queries of any length share the stacks: the gapless kernel has no
        # row limit, so the JAX package's long-query split is not needed
        s, keys = sharded_gapless_topk(self.st, profs, biases,
                                       params.max_seqs)
        out: List[List[tuple]] = []
        for r in range(len(seqs)):
            ok = (s[r] > MIN_DIAG_SCORE) & (keys[r] >= 0)
            sr, kr = s[r][ok], keys[r][ok]
            order = np.lexsort((kr, -sr))[: params.max_seqs]
            out.append([(int(kr[i]), int(sr[i])) for i in order])
        return out
