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

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..db.panels import resident_panels
from ..db.storage import StructDB
from ..search.params import SearchParams
from ..search.ungapped import UngappedPrefilter
from ..utils.log import logger, record_count, span
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
    the world (rows past the DB's end are padding): `view`, those rows as a
    DB of their own (`StructDB.row_view`), and the prefilter over the
    rank's resident panel set of that view, which the align stage's SW
    kernel, residues and C-alpha panel come from too."""
    mesh: Mesh
    tdb: StructDB
    view: StructDB
    row_start: int
    row_end: int
    # the DB's keys when the view was made: a DB whose arrays were replaced
    # since gets a shard of its own
    keys: np.ndarray = field(repr=False)
    _prefilter: Optional[UngappedPrefilter] = field(default=None, init=False,
                                                    repr=False)

    @property
    def prefilter(self) -> UngappedPrefilter:
        """The prefilter over `resident_panels(view)`: made again only when
        the resident set was released or replaced since."""
        panels = resident_panels(self.view, self.mesh.device)
        if self._prefilter is None or self._prefilter.panels is not panels:
            self._prefilter = UngappedPrefilter(self.view, self.mesh.device,
                                                panels=panels)
        return self._prefilter


_resident_shard: dict = {}   # "held" -> ShardedTargets


def shard_targets(tdb: StructDB, mesh: Mesh) -> ShardedTargets:
    """This rank's row range of the DB (`host_row_range`, the JAX package's
    rows per device) as a slice view with its panels on the rank's device:
    the rank reads and uploads only its own rows (the DB is memory-mapped).
    Made once per DB object, world and device and kept (one at a time, as
    `resident_panels` keeps one set): calls against the same DB reuse the
    view, its key map and its resident panels. Span `shard.build` (the view
    and its panels' buckets), count `shard.rows` (the DB rows it holds).
    With one process a device, the JAX package's per-host loader
    (`shard_targets_per_host`) and its single-process sharding are this one
    function."""
    held = _resident_shard.get("held")
    if (held is not None and held.tdb is tdb and held.keys is tdb.keys
            and (held.mesh.rank, held.mesh.size, held.mesh.device)
            == (mesh.rank, mesh.size, mesh.device)):
        return held
    _resident_shard.clear()
    with span("shard.build"):
        n_pad = padded_rows(tdb.size, mesh.size)
        r0, r1 = host_row_range(n_pad, mesh.rank, mesh.size)
        st = ShardedTargets(mesh=mesh, tdb=tdb, view=tdb.row_view(r0, r1),
                            row_start=r0, row_end=r1, keys=tdb.keys)
        st.prefilter     # the view's resident panels
    record_count("shard.rows", st.view.size)
    logger.info("rank %d holds rows [%d, %d) of %d (%d entries) on %s",
                mesh.rank, r0, r1, n_pad, st.view.size, mesh.device)
    _resident_shard["held"] = st
    return st


def sharded_gapless_topk(st: ShardedTargets, profs: Sequence[np.ndarray],
                         byte_biases: Sequence[int], params: SearchParams):
    """Score a query batch against the whole sharded DB; return each
    query's kept candidates as int64 (scores [q, k], keys [q, k]), k =
    max_seqs, every row in (score desc, key asc) order, padded with (-1,
    -1), the same on every rank.

    Per rank: the gapless kernel over the rank's panels, launched as
    `UngappedPrefilter` launches it (one launch a query stack and panel
    piece, the device top-k where a piece is large), then its gate and
    selection (`UngappedPrefilter.select`); merge (span
    `prefilter.exchange`): one all_gather of the [q, k] candidates over the
    group (also in a world of one rank), then the global top-k. The gate is
    per target and both selections break equal scores by key, so the merged
    list equals an unsharded prefilter's whatever order the keys have in
    the DB (the JAX package breaks them by panel row, exact only when keys
    ascend with rows), wherever the score gate alone applies (`-c 0`, the
    default); a coverage gate applied after a piece's device top-k keeps
    what that piece's top-k kept, here as in one process."""
    mesh = st.mesh
    k, q = params.max_seqs, len(profs)
    scores = np.full((q, k), -1, dtype=np.int64)
    keys = np.full((q, k), -1, dtype=np.int64)
    for g, (s, kk) in enumerate(st.prefilter.select(profs, byte_biases,
                                                    params)):
        scores[g, :len(s)] = s
        keys[g, :len(s)] = kk
    with span("prefilter.exchange"):
        if mesh.group is not None:
            local = torch.from_numpy(np.stack([scores, keys])).to(
                mesh.comm_device)
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
                         byte_bias: int, params: SearchParams):
    """The kept candidates (scores [k], keys [k]) of ONE query of any length
    against the sharded DB. The JAX package chains a separate long-query
    kernel over its shards; the port's gapless kernel takes any query
    length in strips, so this is `sharded_gapless_topk` of one query."""
    scores, keys = sharded_gapless_topk(st, [prof], [byte_bias], params)
    return scores[0], keys[0]
