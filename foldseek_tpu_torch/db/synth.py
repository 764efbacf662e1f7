"""Synthetic large-scale structure DBs for scale benchmarks.

BASELINE config 5 needs ~100k-1M target entries; the reference's yardstick
is AFDB-scale RAM planning (reference: README.md:95 — 54M entries,
(6 B C-alpha + 1 B 3Di + 1 B AA) x residues). Real AFDB is egress-blocked
here, so scale runs use a DB synthesized from the bundled SCOP example
domains: each entry is a real domain's AA/3Di/C-alpha record with
coordinate jitter and random crops, giving an AFDB-like length mix and
realistic 3Di composition (uniform-random 3Di strings would make the
k-mer prefilter's similar-k-mer lists unrealistically selective)."""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .storage import StructDB, load_db


def synth_db(base: StructDB, n_entries: int, path: str,
             seed: int = 0, jitter: float = 0.35,
             mutate_frac: float = 0.08) -> StructDB:
    """Expand `base` into an n_entries DB at `path` (array-native layout,
    written directly — the StructDBWriter per-entry loop is too slow at
    1M entries)."""
    rng = np.random.default_rng(seed)
    os.makedirs(path, exist_ok=True)
    base_lens = base.lengths()
    picks = rng.integers(0, base.size, size=n_entries)
    # random crops: keep >= 60% of the domain, at least 30 residues
    keep_frac = rng.uniform(0.6, 1.0, size=n_entries)
    new_lens = np.maximum(np.minimum(base_lens[picks], 30),
                          (base_lens[picks] * keep_frac).astype(np.int64))
    starts = (rng.uniform(0, 1, size=n_entries)
              * (base_lens[picks] - new_lens + 1)).astype(np.int64)

    offsets = np.zeros(n_entries + 1, dtype=np.int64)
    np.cumsum(new_lens, out=offsets[1:])
    R = int(offsets[-1])
    # vectorized gather: source residue index for every output residue
    entry_of = np.repeat(np.arange(n_entries), new_lens)
    within = np.arange(R, dtype=np.int64) - offsets[entry_of]
    src = (np.asarray(base.offsets)[picks] + starts)[entry_of] + within
    aa = np.asarray(base.aa)[src]
    ss = np.asarray(base.ss)[src]
    ca = np.asarray(base.ca)[src].astype(np.float32, copy=True)
    # coordinate jitter + whole-entry random rotation is not needed for
    # throughput benchmarking (scores don't care about the frame); jitter
    # alone decorrelates exact duplicates
    ca += rng.normal(scale=jitter, size=ca.shape).astype(np.float32)
    # sprinkle 3Di/AA mutations so identical k-mer postings don't collapse
    nmut = int(R * mutate_frac)
    mut_at = rng.integers(0, R, size=nmut)
    ss[mut_at] = rng.integers(0, 20, size=nmut).astype(np.int8)
    aa[mut_at] = rng.integers(0, 20, size=nmut).astype(np.int8)

    np.save(os.path.join(path, "aa.npy"), aa)
    np.save(os.path.join(path, "ss.npy"), ss)
    np.save(os.path.join(path, "mask.npy"), np.zeros(R, dtype=np.uint8))
    np.save(os.path.join(path, "ca.npy"), ca)
    np.save(os.path.join(path, "offsets.npy"), offsets)
    np.save(os.path.join(path, "keys.npy"),
            np.arange(n_entries, dtype=np.uint32))
    np.save(os.path.join(path, "fileids.npy"),
            np.arange(n_entries, dtype=np.uint32))
    names = [f"syn{i:07d}" for i in range(n_entries)]
    with open(os.path.join(path, "names.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    with open(os.path.join(path, "headers.txt"), "w") as f:
        f.write("\n".join(n + " synthetic" for n in names) + "\n")
    with open(os.path.join(path, "sources.txt"), "w") as f:
        f.write("")
    import json
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"version": 1, "kind": "structure", "n_entries": n_entries,
                   "total_residues": R}, f)
    return load_db(path)


def peak_rss_mb() -> float:
    """Peak resident set of this process in MB (ru_maxrss is KB on Linux)."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def current_rss_mb() -> float:
    """Current resident set in MB (VmRSS from /proc/self/status)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0
