"""Precomputed search index — the `createindex` / `makepaddeddb` artifact
(reference: data/structureindex.sh + lib/mmseqs/src/prefiltering/
PrefilteringIndexReader.cpp `.idx`, lib/mmseqs/src/util/makepaddedseqdb.cpp).

Layout: instead of the reference's serialized k-mer table +
padded byte sequences, the index stores
  * the transposed, padded int8 3Di panel [lt_pad, n_pad] that the gapless
    prefilter kernel consumes directly (mmap -> upload, no conversion)
  * the k-mer posting lists of the host prefilter as flat arrays
    (kmer ids + offsets + (seq, pos) entries)
Both load with mmap so a long-lived index server can share pages across
processes. Copy of `foldseek_tpu/db/index.py` with the imports rewritten
and one check added: `load_index` accepts an index only when it describes
the DB it is asked for (`describes`), so a key-subset view that keeps its
parent's path (`cluster/workflow.py` `_subdb_view`) builds its own postings
and panels. The k-mer prefilter reads the posting lists from it
(`search/kmer.py`), `TorchPanelSet` its bucket panels (`db/panels.py`).
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from ..utils.log import logger
from .storage import StructDB

INDEX_VERSION = 2


def index_dir(db_path: str) -> str:
    return os.path.join(db_path, "index")


def create_index(db: StructDB, k: int = 0, sensitivity: float = 9.5,
                 lt_pad_multiple: int = 128) -> str:
    """Build + persist the length-bucketed device panels and the k-mer
    posting lists (reference: makepaddedseqdb length-sorts + pads for the
    GPU kernels, lib/mmseqs/src/util/makepaddedseqdb.cpp; libmarv
    dbbatching.cuh partitions by length)."""
    out = index_dir(db.path)
    os.makedirs(out, exist_ok=True)

    # --- length-bucketed transposed panels for the gapless kernel ---
    from .panels import build_buckets
    lens = db.lengths()
    seqs = [db.get_ss(i) for i in range(db.size)]
    buckets = build_buckets(seqs, lens)
    for bi, b in enumerate(buckets):
        np.save(os.path.join(out, f"bucket_{bi}_panel_T.npy"), b.panel_T)
        np.save(os.path.join(out, f"bucket_{bi}_idx.npy"), b.entry_idx)

    # --- k-mer postings (host prefilter) ---
    from ..search.kmer import KmerPrefilter
    from ..search.params import SearchParams
    pref = KmerPrefilter(db, SearchParams(sensitivity=sensitivity), k=k,
                         bias_scale=0.15)
    np.save(os.path.join(out, "kmer_ids.npy"), pref.post_ids)
    np.save(os.path.join(out, "kmer_offsets.npy"), pref.post_off)
    np.save(os.path.join(out, "kmer_seq.npy"), pref.post_tid.astype(np.int32))
    np.save(os.path.join(out, "kmer_pos.npy"), pref.post_pos.astype(np.int32))
    np.save(os.path.join(out, "masked_ss.npy"),
            np.concatenate(pref.masked_seqs) if pref.masked_seqs else np.zeros(0, np.int8))
    with open(os.path.join(out, "manifest.json"), "w") as f:
        json.dump({"version": INDEX_VERSION, "k": pref.k,
                   "kmer_thr": pref.kmer_thr, "sensitivity": sensitivity,
                   "n_buckets": len(buckets),
                   "bucket_lt": [b.lt_pad for b in buckets],
                   "n_entries": db.size}, f)
    logger.info("createindex: %d bucket panels (lt %s) + %d k-mers -> %s",
                len(buckets), [b.lt_pad for b in buckets], len(pref.post_ids),
                out)
    return out


class PostingIndex:
    """Read-only k-mer posting lookup over the flat index arrays."""

    def __init__(self, path: str):
        self.kmer_ids = np.load(os.path.join(path, "kmer_ids.npy"), mmap_mode="r")
        self.offsets = np.load(os.path.join(path, "kmer_offsets.npy"), mmap_mode="r")
        self.seq = np.load(os.path.join(path, "kmer_seq.npy"), mmap_mode="r")
        self.pos = np.load(os.path.join(path, "kmer_pos.npy"), mmap_mode="r")

    def get(self, kidx: int):
        i = int(np.searchsorted(self.kmer_ids, kidx))
        if i >= len(self.kmer_ids) or self.kmer_ids[i] != kidx:
            return None
        s, e = int(self.offsets[i]), int(self.offsets[i + 1])
        return list(zip(self.seq[s:e].tolist(), self.pos[s:e].tolist()))


def describes(manifest: dict, masked_ss: np.ndarray, db: StructDB) -> bool:
    """Whether the index of `manifest` / `masked_ss` was built from `db`: the
    same entry count and residue total, and the DB at `db.path` holds the
    same keys in the same order (a view of a subset, or of a reordered set,
    keeps its parent's path but not its parent's entries)."""
    if (manifest.get("n_entries") != db.size
            or len(masked_ss) != int(db.offsets[-1])):
        return False
    keys_path = os.path.join(db.path, "keys.npy")
    return (os.path.isfile(keys_path) and np.array_equal(
        np.load(keys_path, mmap_mode="r"), np.asarray(db.keys)))


def load_index(db: StructDB) -> Optional[dict]:
    """Returns {"manifest", "buckets", "postings", "masked_ss"} or None: None
    also when the index at `db.path` does not describe `db` (`describes`)."""
    out = index_dir(db.path)
    manifest_path = os.path.join(out, "manifest.json")
    if not os.path.isfile(manifest_path):
        return None
    with open(manifest_path) as f:
        manifest = json.load(f)
    if manifest.get("version") != INDEX_VERSION:
        logger.warning("index version mismatch at %s; ignoring "
                       "(re-run createindex)", out)
        return None
    masked_ss = np.load(os.path.join(out, "masked_ss.npy"), mmap_mode="r")
    if not describes(manifest, masked_ss, db):
        logger.info("index at %s was built for another entry set; ignoring "
                    "it for this DB of %d entries", out, db.size)
        return None
    from .panels import Bucket
    buckets = []
    for bi, lt_pad in enumerate(manifest["bucket_lt"]):
        buckets.append(Bucket(
            lt_pad=lt_pad,
            entry_idx=np.load(os.path.join(out, f"bucket_{bi}_idx.npy")),
            panel_T=np.load(os.path.join(out, f"bucket_{bi}_panel_T.npy"),
                            mmap_mode="r")))
    return {
        "manifest": manifest,
        "buckets": buckets,
        "postings": PostingIndex(out),
        "masked_ss": masked_ss,
    }
