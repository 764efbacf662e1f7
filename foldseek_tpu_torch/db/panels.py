"""The target DB's device residency: length-bucketed 3Di panels for the
gapless prefilter and the concatenated residues for the SW kernel.

Counterpart of `foldseek_tpu/db/panels.py`. Reference analogues:
  * makepaddedseqdb sorts the DB by length and pads for the GPU kernels
    (lib/mmseqs/src/util/makepaddedseqdb.cpp); libmarv batches the DB by
    length partition (lib/mmseqs/lib/libmarv/src/dbbatching.cuh).
  * Prefiltering::setupSplit plans query/target splits from available
    memory (lib/mmseqs/src/prefiltering/Prefiltering.cpp:289-381) and
    merges per-query hit lists across target splits.

Layout: targets are grouped into buckets by padded length (multiples of
128); each bucket is one transposed int8 panel [lt_pad, n_pad], pad letter
21, that a single gapless-kernel launch scans: neighbouring CUDA threads
score neighbouring targets and read neighbouring bytes. Memory scales with
sum(bucket sizes), not max_len * N. When the padded panels exceed a device
memory budget, buckets are partitioned row-wise into splits; each split is
uploaded, scanned for the whole query batch, reduced to a per-query top-k on
the device, and the per-split top-ks are merged on the host.

`TorchPanelSet` is the one owner of what a target DB keeps on the device:
the prefilter takes its panels from it, the alignment stage and
`--prefilter-mode 3` take the residues, the TM/LDDT gate fleets the C-alpha
panel. `resident_panels` keeps one DB's set alive between searches. A DB with
a `createindex` artifact that describes it gives its panels from the index
(`foldseek_tpu/db/panels.py` `PanelSet.from_db(use_index=True)`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import panel_budget
from ..utils.log import logger, record_count

PAD_LETTER = 21
ROW_MULTIPLE = 128
LT_MULTIPLE = 128
# share of the free device memory the resident C-alpha panel may take
CA_PANEL_FRACTION = 0.35


def bucket_boundary(length: int) -> int:
    """Padded length for a target of `length`: next multiple of 128 up to
    512, then ~1.5x growth rounded up to 128 (768, 1152, 1792, 2688, ...)
    so the bucket count stays small at AFDB-like length distributions."""
    if length <= 512:
        return max(LT_MULTIPLE, -(-length // LT_MULTIPLE) * LT_MULTIPLE)
    b = 512
    while b < length:
        b += max(LT_MULTIPLE, b // 2)
        b = -(-b // LT_MULTIPLE) * LT_MULTIPLE
    return b


@dataclass
class Bucket:
    lt_pad: int
    entry_idx: np.ndarray      # [n] original DB entry indices
    panel_T: np.ndarray        # int8 [lt_pad, n_pad] transposed, PAD_LETTER pad

    @property
    def n(self) -> int:
        return len(self.entry_idx)

    @property
    def n_pad(self) -> int:
        return self.panel_T.shape[1]

    @property
    def nbytes(self) -> int:
        # panels stay int8 on the device (the kernel widens in registers)
        return self.lt_pad * self.n_pad


def build_buckets(seqs: Sequence[np.ndarray],
                  lengths: Sequence[int]) -> List[Bucket]:
    """Group sequences into length buckets and pack transposed panels."""
    groups = {}
    for i, L in enumerate(lengths):
        groups.setdefault(bucket_boundary(int(L)), []).append(i)
    buckets = []
    for lt_pad in sorted(groups):
        idx = np.asarray(groups[lt_pad], dtype=np.int64)
        n_pad = -(-len(idx) // ROW_MULTIPLE) * ROW_MULTIPLE
        panel = np.full((n_pad, lt_pad), PAD_LETTER, dtype=np.int8)
        for row, i in enumerate(idx):
            s = seqs[i]
            L = min(len(s), lt_pad)
            panel[row, :L] = s[:L]
        buckets.append(Bucket(lt_pad=lt_pad, entry_idx=idx,
                              panel_T=np.ascontiguousarray(panel.T)))
    return buckets


@dataclass
class SplitPiece:
    bucket: int      # index into the bucket list
    row_start: int   # first panel row (multiple of ROW_MULTIPLE)
    row_end: int     # exclusive, multiple of ROW_MULTIPLE (or n_pad)


def plan_splits(buckets: Sequence[Bucket],
                budget_bytes: Optional[int]) -> List[List[SplitPiece]]:
    """Partition the panels into splits of at most budget_bytes device
    bytes each (the TARGET_DB_SPLIT analogue). A bucket larger than the
    budget is cut row-wise at ROW_MULTIPLE boundaries."""
    if budget_bytes is None:
        return [[SplitPiece(b, 0, buckets[b].n_pad)
                 for b in range(len(buckets))]]
    splits: List[List[SplitPiece]] = []
    cur: List[SplitPiece] = []
    cur_bytes = 0
    for bi, b in enumerate(buckets):
        row = 0
        row_bytes = b.lt_pad
        while row < b.n_pad:
            room = (budget_bytes - cur_bytes) // (row_bytes * ROW_MULTIPLE)
            take = min(int(room) * ROW_MULTIPLE, b.n_pad - row)
            if take <= 0:
                if cur:
                    splits.append(cur)
                    cur, cur_bytes = [], 0
                    continue
                # single block exceeds budget: take one block anyway
                take = min(ROW_MULTIPLE, b.n_pad - row)
            cur.append(SplitPiece(bi, row, row + take))
            cur_bytes += take * row_bytes
            row += take
    if cur:
        splits.append(cur)
    if len(splits) > 1:
        logger.info("prefilter split plan: %d splits over %d buckets "
                    "(budget %.1f MB)", len(splits), len(buckets),
                    budget_bytes / 1e6)
    return splits


class TorchPanelSet:
    """What one target DB keeps on `device`, each part made at first use:
    the bucketed 3Di panels (streamed in splits when they exceed
    `budget_bytes`, resident when they fit in one split), the DB's
    concatenated AA and 3Di residues with their entry offsets, and its
    C-alpha coordinates."""

    def __init__(self, db, device, budget_bytes: Optional[int] = None):
        record_count("panel_set_entries", db.size)
        self.db = db
        self.device = torch.device(device)
        self.n_entries = db.size
        self.offsets = np.asarray(db.offsets, dtype=np.int64)
        self._budget = budget_bytes
        self._buckets: Optional[List[Bucket]] = None
        self._splits: Optional[List[List[SplitPiece]]] = None
        self._resident = {}   # (bucket, row_start, row_end) -> device panel
        self._residues: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._ca: Optional[torch.Tensor] = None

    @property
    def buckets(self) -> List[Bucket]:
        """The bucket panels: the `createindex` artifact's (memory-mapped,
        uploaded as they are) when the DB has an index that describes it,
        else built from the sequences."""
        if self._buckets is None:
            from .index import load_index
            db = self.db
            idx = load_index(db) if db.path else None
            if idx is not None:
                self._buckets = idx["buckets"]
                logger.info("panels: %d buckets from the index of %s",
                            len(self._buckets), db.path)
            else:
                self._buckets = build_buckets(
                    [db.get_ss(i) for i in range(db.size)], db.lengths())
        return self._buckets

    @property
    def splits(self) -> List[List[SplitPiece]]:
        if self._splits is None:
            self._splits = plan_splits(self.buckets, self._budget)
        return self._splits

    @property
    def total_bytes(self) -> int:
        return sum(b.nbytes for b in self.buckets)

    def device_panel(self, piece: SplitPiece, keep: bool) -> torch.Tensor:
        """int8 [lt_pad, rows] panel of one split piece; kept resident when
        `keep` (the panels fit the device in one split)."""
        key = (piece.bucket, piece.row_start, piece.row_end)
        panel = self._resident.get(key)
        if panel is None:
            host = self.buckets[piece.bucket].panel_T[
                :, piece.row_start:piece.row_end]
            panel = torch.from_numpy(np.array(host, order="C")).to(self.device)
            if keep:
                self._resident[key] = panel
        return panel

    def residues(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(res_aa, res_ss): the DB's concatenated residues as int8 tensors
        on the device, uploaded once (the SW kernel reads targets straight
        from them through `offsets`)."""
        if self._residues is None:
            self._residues = tuple(
                torch.tensor(np.asarray(a, dtype=np.int8)).to(self.device)
                for a in (self.db.aa, self.db.ss))
        return self._residues

    def ca(self) -> Optional[torch.Tensor]:
        """float32 [R, 3] C-alpha coordinates of every residue of the DB on
        the device (12 bytes a residue), uploaded once: the gate fleets
        gather aligned coordinates from it by absolute row. None when the DB
        has no coordinates, when the panel would take more than
        CA_PANEL_FRACTION of the free device memory, or when the rows pass
        int32 (the gather indices' type); the caller then uploads the union
        of the targets a fleet needs."""
        if self._ca is None:
            rows = int(self.offsets[-1])
            if self.db.ca is None or rows >= (1 << 31):
                return None
            if self.device.type == "cuda":
                free, _total = torch.cuda.mem_get_info(self.device)
                if rows * 12 > free * CA_PANEL_FRACTION:
                    return None
            self._ca = torch.tensor(
                np.asarray(self.db.ca, dtype=np.float32)).to(self.device)
        return self._ca


_resident_sets: dict = {}   # (tdb identity, device) -> TorchPanelSet


def release_resident_panels() -> None:
    """Drop the resident set: the next search uploads its DB anew."""
    _resident_sets.clear()


def resident_panels(tdb, device) -> TorchPanelSet:
    """Per-process resident TorchPanelSet: repeated searches against the
    same target DB on the same device reuse its panels and residues (the
    reference's gpuserver-resident DB, lib/mmseqs/src/util/gpuserver.cpp,
    in-process). One DB is kept at a time; its panel budget is taken from
    the device's free memory when the set is made."""
    device = torch.device(device)
    key = (getattr(tdb, "path", None), id(tdb.ss), tdb.size, str(device))
    panels = _resident_sets.get(key)
    if panels is None:
        _resident_sets.clear()
        panels = _resident_sets[key] = TorchPanelSet(
            tdb, device, panel_budget(device))
    return panels
