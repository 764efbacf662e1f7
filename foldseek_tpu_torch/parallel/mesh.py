"""Scale-out over ranks: a row-sharded target DB + replicated queries.

Port of `foldseek_tpu/parallel/mesh.py`. The reference distributes with MPI:
target-DB splits assigned round-robin to ranks, each rank computes its
split, the master merges hit lists through the shared filesystem
(reference: lib/mmseqs/src/prefiltering/Prefiltering.cpp:589-700
runMpiSplits, MMseqsMPI.cpp). The JAX package shards the padded target
panel over the devices of a one-axis mesh and merges per-device top-ks with
an all_gather. PyTorch runs one process a device, so here the mesh is the
process group: each rank holds one contiguous row range of the DB as its
own `TorchPanelSet` on its device, scans it with the gapless kernel, keeps a
local top-k and merges the [q, k] candidates of every rank with one
all_gather, with no filesystem round trip and no master rank.

The tensor-parallel ProstT5 mesh of the JAX module (`make_model_mesh`,
`prostt5_shardings`, `prostt5_sharded_forward`) is not ported: the port runs
the encoder on one card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..db.storage import StructDB
from ..search.ungapped import UngappedPrefilter
from ..utils.log import logger
from .distributed import host_row_range, padded_rows, rank_device, world


@dataclass
class Mesh:
    """The ranks one sharded DB spans: the process group (None in a world
    of one process), this rank, the world size and this rank's device."""
    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device

    @property
    def comm_device(self) -> torch.device:
        """Where collective tensors live: the rank's card under NCCL, the
        host under gloo (which also serves ranks sharing one card)."""
        if self.group is not None and dist.get_backend(self.group) == "nccl":
            return self.device
        return torch.device("cpu")


def make_mesh(device=None) -> Mesh:
    """The mesh of the current world: the default process group when
    `init_distributed` formed one, else one rank. `device` defaults to the
    rank's device from `init_distributed`, else `cuda`."""
    rank, size = world()
    dev = torch.device(device) if device is not None else rank_device()
    group = dist.group.WORLD if dist.is_initialized() else None
    return Mesh(group=group, rank=rank, size=size, device=dev)


@dataclass
class ShardedTargets:
    """This rank's rows [row_start, row_end) of the target DB padded over
    the world (rows past the DB's end are padding), as the prefilter over
    their own device panels."""
    mesh: Mesh
    prefilter: UngappedPrefilter
    row_start: int
    row_end: int


def shard_targets(tdb: StructDB, mesh: Mesh) -> ShardedTargets:
    """This rank's row range of the DB (`host_row_range`, the JAX package's
    rows per device) as a key-subset view with its own panels on the rank's
    device: the rank reads only its own rows (the DB is memory-mapped). With
    one process a device, the JAX package's per-host loader
    (`shard_targets_per_host`) and its single-process sharding are this one
    function."""
    from ..cluster.workflow import _subdb_view
    n = tdb.size
    n_pad = padded_rows(n, mesh.size)
    r0, r1 = host_row_range(n_pad, mesh.rank, mesh.size)
    view = _subdb_view(tdb, [int(k) for k in tdb.keys[min(r0, n):min(r1, n)]])
    logger.info("rank %d loads rows [%d, %d) of %d (%d entries) on %s",
                mesh.rank, r0, r1, n_pad, view.size, mesh.device)
    return ShardedTargets(mesh=mesh, prefilter=UngappedPrefilter(
        view, mesh.device), row_start=r0, row_end=r1)


def _local_topk(st: ShardedTargets, profs, byte_biases, k: int):
    """Each query's k best (score, key) of this rank's rows, ties to the
    smaller key, padded with (-1, -1): int64 [q, k] twice."""
    pref = st.prefilter
    scores = np.full((len(profs), k), -1, dtype=np.int64)
    keys = np.full((len(profs), k), -1, dtype=np.int64)
    for g, (s, idx) in enumerate(pref.scan(profs, byte_biases, k)):
        kk = pref.keys[idx]
        order = np.lexsort((kk, -s))[:k]
        scores[g, :len(order)] = s[order]
        keys[g, :len(order)] = kk[order]
    return scores, keys


def sharded_gapless_topk(st: ShardedTargets, profs: Sequence[np.ndarray],
                         byte_biases: Sequence[int], k: int):
    """Score a query batch against the whole sharded DB; return the global
    per-query top-k as int64 (scores [q, k], keys [q, k]), every row in
    (score desc, key asc) order, padded with (-1, -1), the same on every
    rank.

    Per rank: the gapless kernel over the rank's panels, launched as
    `UngappedPrefilter` launches it (one launch a query stack and panel
    piece, the device top-k where a piece is large), then a local top-k;
    merge: one all_gather of the [q, k] candidates over the group (also in
    a world of one rank), then the global top-k.
    Both selections break equal scores by key, so the merged list equals an
    unsharded scan's `lexsort((key, -score))[:k]` whatever order the keys
    have in the DB (the JAX package breaks them by panel row, exact only
    when keys ascend with rows)."""
    mesh = st.mesh
    scores, keys = _local_topk(st, profs, byte_biases, k)
    q = len(profs)
    if mesh.group is not None:
        local = torch.from_numpy(np.stack([scores, keys])).to(mesh.comm_device)
        out = torch.empty((mesh.size * 2, q, k), dtype=torch.int64,
                          device=mesh.comm_device)
        gather = getattr(dist, "all_gather_single", None) \
            or dist.all_gather_into_tensor
        gather(out, local, group=mesh.group)
        both = out.reshape(mesh.size, 2, q, k).cpu().numpy()
        scores = both[:, 0].transpose(1, 0, 2).reshape(q, -1)
        keys = both[:, 1].transpose(1, 0, 2).reshape(q, -1)
    best_s = np.full((q, k), -1, dtype=np.int64)
    best_k = np.full((q, k), -1, dtype=np.int64)
    for r in range(q):
        order = np.lexsort((keys[r], -scores[r]))[:k]
        best_s[r, :len(order)] = scores[r][order]
        best_k[r, :len(order)] = keys[r][order]
    return best_s, best_k


def sharded_gapless_long(st: ShardedTargets, prof: np.ndarray,
                         byte_bias: int, k: int):
    """The global top-k (scores [k], keys [k]) of ONE query of any length
    against the sharded DB. The JAX package chains a separate long-query
    kernel over its shards; the port's gapless kernel takes any query
    length in strips, so this is `sharded_gapless_topk` of one query."""
    scores, keys = sharded_gapless_topk(st, [prof], [byte_bias], k)
    return scores[0], keys[0]
