#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (foldseek_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--targets 100000] [--queries 16] [--out-dir DIR]

Phases (any failure exits nonzero and prints no result line):
  1. device: CUDA present, card name and power limit, nvcc build of every
     kernel in foldseek_tpu_torch/csrc and g++ build of the native host
     library, all started together.
  2. gapless kernel vs its plain PyTorch version, exact, at the main path's
     shapes: the query stack against each length bucket of the target DB,
     plus one 4600-residue query (the long-query contract).
  3. SW kernel vs its plain version, exact (score, q_end, t_end of every
     pair): every query's forward and reversed profile against 1000
     candidates, plus queries of 1500 and 2500 residues.
  4. the remaining call shapes of the JAX package's kernels, each first
     driven once (its launches are counted) and then held against its plain
     version, exact: one query with and without a cap against each length
     bucket (gapless_scores_single); one query and the whole query stack,
     AA + 3Di profiles, against the two panels of one bucket
     (gapless_scores_dual, the dual-alphabet kernel); every query's forward
     profile against 1000 shared targets (sw_scores_batch).
  5. end to end, mode 1: `search` + `format_results` with prefilter_mode=1
     and backtraces on the card, cold then warm, over a synthetic DB; the
     gapless and the SW kernel must have launched in the cold run. Once with
     the TM/LDDT gates as the card runs them by default and once with
     FOLDSEEK_TPU_DEVICE_GATES forcing the other side (1: device fleets, 0:
     the host's batch_gates), then twelve warm runs in turns (six pairs,
     alternating which side runs first); the two sides' records are compared hit by hit (equal hit sets and backtraces; TM and
     LDDT within 2e-3, the structure-bit score within 1).
  5b. the gate fleet alone, on that run's own accepted hits: the device
     fleet against the fleet on the CPU (float32 both), host batch_gates
     beside the device fleet at 1,000, 4,000 and 16,000 hits in turns (host,
     device, device, host), the fleet with a convergence test every fourth
     iteration beside the fleet that runs all 20, the profiler's device time,
     the bytes moved and the peak memory.
  5c. PSSM call shapes: profiles from `result2profile` on the mode-1 hits;
     the gapless kernel through `UngappedPrefilter.query_profile` and the SW
     kernel through a `PSSMQueryProfile` pair list (forward and reversed
     slots), each exact against its plain version, timed.
  5d. end to end, the other paths, each once: --num-iterations 2 with
     prefilter mode 1, the default k-mer prefilter (mode 0), --alignment-type
     1 and 3, all at the full --targets depth (the json holds each run's
     target count).
  6. end to end, mode 3: the same with prefilter_mode=3 (3Di-only SW of
     every query against the whole DB); the SW kernel must have launched and
     the gapless kernel must not. Then the SW kernel vs its plain version at
     mode-3 shapes, every query against the DB in chunks of 20000 targets,
     and the full-size call's wrapper time (CUDA events, host plan included)
     beside its kernel time (torch.profiler).
  7. parity: on a 2000-target DB the m8 lines on cuda equal those on cpu,
     byte for byte, for mode 1 with host gates, mode 3, mode 0, two
     iterations and alignment types 1 and 3. With the host's gates, also
     byte for byte on a 1,000-entry DB: easy-cluster's three files (the
     1,000 clustered), the cluster-search m8 over those clusters, the
     easy-rbh m8 (the queries against the 1,000, --gpu 1), the multimer
     score lines and report (both DBs regrouped into two-chain complexes);
     and easy-multimercluster's two files on a 120-entry complex DB. The cpu
     side runs in two spawned worker processes while the main process runs
     the cuda side. Then mode 1 with the device gates on the card against
     the host gates on the cpu, inside the band of phase 5.
  9. easy-cluster with the defaults (cov 0.8, e 0.01, three cascade steps,
     sensitivity 8, set cover, max-seqs 1000) on 20,000 synthetic
     entries through cluster_db and the three writers: each
     stage's seconds, the pairs of each align stage, the SW launches (more
     than 0), the clusters, one upload of the DB's residues an align stage
     (the lin stage's DB, then each cascade step's view), the peak memory
     and the device's busy time by torch.profiler (CUDA activity alone).
     Then easy-rbh --gpu 1 of the queries against those entries with the
     card's default gates, counted: the rbh path; its re-align sorts by
     structure bits, so past 8,192 pairs its gates must run as fleets.
 10. createclusearchdb from those clusters, then the queries with
     --cluster-search 1 --gpu 1: the rep search, the expand and the member
     re-align; both kernels must launch.
 11. multimersearch --gpu 1 + createmultimerreport with the card's default
     gates, the target DB regrouped into two-chain complexes (fileids
     i // 2) and the queries likewise: the stage seconds, the expanded
     pairs, the assignments; both kernels must launch.
 12. the DB, stage and output verbs and the index server, over a copy of
     the target DB indexed by `createindex` (timed): the prefilter over the
     index's panels equals the one over built panels, and a cold mode-1
     search over it gives phase 5's m8 (host gates); `serve` on the card in
     a thread of this script (its gapless launches counted) answers `ping`
     and `query_batch` as the in-process prefilter does, its round trip
     timed beside the in-process call; `search --gpu 1 -a` of the unindexed
     target DB in fresh processes without, with, with and without
     --index-server (the server holds the indexed copy), each printed
     by `convertalis` to phase 5's m8 byte for byte, each process's wall
     recorded; ungappedprefilter (its lines equal the server's hits),
     structurealign -a over a served search's result, samplemulambda (both
     SW launches counted) and aln2tmscore through the command line on the
     card. Phase 7 compares the same verbs on the parity DB, cuda against
     cpu: ungappedprefilter, `search --gpu 1 --max-seqs 50`, structurealign
     -a over it, samplemulambda, convertalis in format modes 0-5, and a
     `search --index-server` through a server on each side's device.
 13. ProstT5 (`createdb --prostt5-model`, no kernel of its own: plain
     PyTorch): (a) the relative-position bucket table on the card equals the
     CPU's for T <= 4096; (b) the release width with 2 layers from seeded
     weights, four sequences of 50-1,000 residues: float32 on the card
     within 1e-4 of float32 on the CPU, bfloat16 (cuBLAS's reduced-precision
     bf16 reduction as it stands, then off) by the margin rule: letters
     equal wherever the CPU's top-two margin exceeds twice the max
     |dlogit|; (c) the full release model (24 layers, d_model 1024) from
     weights drawn on the card, written as an f16 GGUF by the port's writer
     (timed), then `createdb --prostt5-model` through the command line over
     the AA strings of 1,984 target entries and the queries joined into 16
     sequences of 500-2,000 residues: the load, seconds, tokens and peak
     memory of each pad bucket, tokens/s and the share of the bound (two
     operations per matmul parameter and token plus the attention products,
     over the dense bf16 peak); (d) a ProstT5 DB of the queries' AA strings,
     `search --gpu 1 -a` of it against the target DB and against itself,
     both kernels counted, convertalis; (e) that DB against the parity DB
     and against itself, m8 on cuda == m8 on cpu byte for byte. Its numbers
     are the line before the kernels' line.
  8. boundaries: both kernels vs their plain versions, exact, at the shapes
     where their branches change: slot and query lengths just below, at and
     above every instance and pass boundary, a batch mixing a 20-row and a
     1,500-row slot, targets of length 1 and of the panel's full padded
     length, a stack whose caps force the 32-bit gapless instance.
ptxas's registers, shared memory and spills of every instance are copied
from the nvcc logs; a spill fails the run.
Before the card's line come three JSON lines: the gates', phase 13's, and
each kernel's launches, error, times and bound; the last line is {"ok":
true, "device": {...}}. Details go to DIR/chip_smoke.json and
DIR/nvcc_*.log (default foldseek_tpu_torch/build/smoke/, which git ignores).

The bound of a kernel is the larger of two times: the bytes it must move
(each input read once, each output written once) over the card's memory
rate, and its DP cells over real residues times the integer instructions of
one cell over the card's INT32 rate (SMs x 64 lanes x the maximum SM clock
that nvidia-smi reports). The instructions of one cell are the fewest any
kernel for this card could do with (see the constants below), not what the
repo's kernels execute.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
INT32_LANES_PER_SM = 64
# Integer instructions one DP cell needs at least on this card.
# Gapless, capped: h = viaddmin_relu(h_diag, s, cap) is one instruction and
# vimax3(best, h, h') folds two cells into the best, 1.5 a cell; where the
# caps or the lengths, and the profile range, keep h inside 16 bits the
# s16x2 forms do two cells each, 0.75 a cell; every timed single-alphabet
# shape of this script is of that kind (without a cap, too: its diagonals
# are too short to pass 16 bits). Dual: one more for the add of the two profile scores, 2.5.
# SW, from the in-register recurrence: s = aa + ss; h_noF =
# viaddmax_relu(diag, s, E); hgo = h_noF - go; E = viaddmax(E, -ge, hgo);
# F = viaddmax(F, -ge, hgo); H = max(h_noF, F); half a vimax3 for the best:
# 6.5, and 5.5 where the AA profile is all zero and s needs no add.
GAPLESS_PACKED_OPS = 0.75
GAPLESS_DUAL_OPS = 2.5
SW_OPS_PER_CELL = 6.5
SW_OPS_NO_AA = 5.5
MODE3_CHUNK = 20_000           # targets per plain-version comparison
GATE_TOL = 2e-3                # |dTM|, |dLDDT| of float32 fleets vs the host
GATE_FLEET_SIZES = (1_000, 4_000, 16_000)
FP32_PER_S = 67e12             # H100 SXM data sheet, outside the tensor cores
# float operations of the gate fleet, for its bound: one (slot, column) cell
# of a TM iteration (rotate, distance, score, the three minima, the cut and
# its 17 masked sums) and one pair of columns of the LDDT
TM_OPS_PER_CELL = 60
LDDT_OPS_PER_PAIR = 30
NO_LIBRARY = None              # no single PyTorch call computes these DPs
# The parity phase compares the workflows of slice 5 on the --parity-targets
# DB, but easy-multimercluster on a complex DB of MULTIMER_CLUSTER_ENTRIES
# entries: every complex is searched against every other, and its cpu side
# (the plain SW of every pair) took 20 s at 120 entries and 162 s at 240 on
# an 8-core host (tools/torch_workflow_parity_seconds.py).
MULTIMER_CLUSTER_ENTRIES = 120
# entries phase 9 clusters: one organism's predicted structures (the AFDB
# human proteome holds about 23,000 models)
CLUSTER_ENTRIES = 20_000


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 1) -> float:
    """Mean device milliseconds of fn() over `reps` runs (after one warm-up),
    timed with CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ptxas_instances(log: str):
    """[{kernel, registers, smem, spill_stores, spill_loads}] from nvcc's
    `-Xptxas -v` output, one entry per compiled kernel instance."""
    out, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            k = re.search(r"(sw_kernel|gapless_kernel)I\w+?EE|target_lengths",
                          name)
            name = k.group(0) if k else name
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            out.append(dict(kernel=name, registers=int(m.group(1)),
                            smem=int(m.group(2) or 0) + dynamic_smem(name),
                            spill_stores=spills[0], spill_loads=spills[1]))
    return out


def dynamic_smem(kernel: str) -> int:
    """Bytes of dynamic shared memory the current gapless kernels are
    launched with (the tile of their tallest strip, `Layout` in
    csrc/gapless.cu): ptxas sees only static shared memory."""
    m = re.fullmatch(r"gapless_kernelILb([01])ELb([01])E\w+", kernel)
    if not m:
        return 0
    packed, dual = (int(x) for x in m.groups())
    stride = 192 * 8 if packed else 32 + 8     # int16 per letter
    return (2 if dual else 1) * 21 * stride * 2


def profiled_kernel_ms(fn, name_part: str):
    """Device milliseconds of the kernels whose name holds `name_part` in one
    run of fn(), from torch.profiler; None when the profiler saw no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    us = 0.0
    for ev in p.key_averages():
        if name_part in ev.key:
            us += float(getattr(ev, "device_time_total",
                                getattr(ev, "cuda_time_total", 0.0)))
    return us / 1e3 if us > 0 else None


def max_abs_err(got, want) -> int:
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


class Card:
    """The card's rates, for the bounds."""

    def __init__(self, dev):
        import torch
        self.sms = torch.cuda.get_device_properties(dev).multi_processor_count
        self.sm_mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True, text=True,
            check=True).stdout.split()[0])
        self.int32_per_s = self.sms * INT32_LANES_PER_SM * self.sm_mhz * 1e6

    def bound(self, cells: int, ops_per_cell: float, nbytes: int) -> dict:
        op_ms = cells * ops_per_cell / self.int32_per_s * 1e3
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        return dict(bound_ms=max(op_ms, byte_ms),
                    bound_by="operations" if op_ms >= byte_ms else "bytes",
                    cells=int(cells), bytes=int(nbytes))


def total(records) -> dict:
    """One kernel-line entry from the shape records of a phase: times and
    bounds summed, bound by what bounds the largest of them."""
    return dict(max_abs_err=max(r["max_abs_err"] for r in records),
                ms=sum(r["ms"] for r in records),
                plain_ms=sum(r["plain_ms"] for r in records),
                bound_ms=sum(r["bound_ms"] for r in records),
                bound_by=max(records,
                             key=lambda r: r["bound_ms"])["bound_by"],
                library_ms=NO_LIBRARY)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def build_dbs(work: str, n_targets: int, n_queries: int, n_parity: int):
    """Fixture DB from the repo's C-alpha-only PDBs + one Foldcomp entry,
    expanded by `synth_db` into targets and queries."""
    from foldseek_tpu_torch.db import create_db, synth_db
    files = sorted(glob.glob(os.path.join(REPO, "tests/golden/msa/sup/*.pdb")))
    files.append(os.path.join(REPO, "tests/golden/d1asha.fcz"))
    base = create_db(files, os.path.join(work, "base"))
    tdb = synth_db(base, n_targets, os.path.join(work, "targets"), seed=1)
    qdb = synth_db(base, n_queries, os.path.join(work, "queries"), seed=4)
    pdb = synth_db(base, n_parity, os.path.join(work, "parity"), seed=1)
    return base, tdb, qdb, pdb


def prefilter_stack(seqs, dev, capped: bool = True):
    """(prof, q_off, caps) device tensors of the prefilter's profiles."""
    import numpy as np
    import torch

    from foldseek_tpu_torch.ops.gapless import NO_CAP, pack_profiles_batch
    from foldseek_tpu_torch.search.ungapped import (BYTE_CAP,
                                                    make_query_profile)
    profs, caps = [], []
    for s in seqs:
        p, b = make_query_profile(np.asarray(s))
        profs.append(p)
        caps.append(BYTE_CAP - b if capped else NO_CAP)
    return [torch.from_numpy(a).to(dev)
            for a in pack_profiles_batch(profs, caps)]


def gapless_case(card, label, args, real_residues, report_list, reps=5):
    """Drive the single-alphabet gapless kernel once against its plain
    version and time it and the plain version; returns the shape record."""
    import torch

    from foldseek_tpu_torch.ops.gapless import (gapless_scores_batch,
                                                gapless_scores_batch_torch)
    prof, q_off, caps, t_dev = args
    got = gapless_scores_batch(*args)
    want = gapless_scores_batch_torch(*args)
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: gapless_scores_batch(*args), reps)
    rec = dict(label=label, max_abs_err=max_abs_err([got], [want]), ms=ms,
               kernel_ms=profiled_kernel_ms(
                   lambda: gapless_scores_batch(*args), "gapless_kernel"),
               plain_ms=cuda_ms(lambda: gapless_scores_batch_torch(*args)),
               max_score=int(got.max()), ops_per_cell=GAPLESS_PACKED_OPS,
               **card.bound(int(q_off[-1]) * real_residues, GAPLESS_PACKED_OPS,
                            nbytes(prof, q_off, caps, t_dev, got)))
    log(f"gapless {label}: max_abs_err={rec['max_abs_err']} wrapper "
        f"{ms:.3f} ms (kernel alone by the profiler {rec['kernel_ms']}) "
        f"plain {rec['plain_ms']:.3f} ms bound "
        f"{rec['bound_ms']:.3f} ms ({rec['bound_by']}, {GAPLESS_PACKED_OPS} "
        f"ops/cell), {rec['cells'] / ms / 1e6:.1f} GCUPS over real cells")
    report_list.append(rec)
    return rec


def panel_pieces(tdb, dev):
    """[(bucket, device panel, real residues in it)] of the target DB."""
    import numpy as np

    from foldseek_tpu_torch.search.ungapped import UngappedPrefilter
    panels = UngappedPrefilter(tdb, dev).panels
    tlens = np.diff(panels.offsets)
    out = []
    for split in panels.splits:
        for piece in split:
            bucket = panels.buckets[piece.bucket]
            idx = bucket.entry_idx[piece.row_start:piece.row_end]
            out.append((bucket, panels.device_panel(piece, keep=False),
                        int(tlens[idx].sum())))
    return out


def phase_gapless(card, dev, tdb, qdb, pieces, report):
    """Gapless kernel vs plain on every piece of the prefilter's panels."""
    import numpy as np
    stack = prefilter_stack([qdb.get_ss(i) for i in range(qdb.size)], dev)
    records = [gapless_case(
        card, f"{qdb.size} queries x bucket lt={b.lt_pad} ({t.shape[1]} rows)",
        (*stack, t), real, report["gapless"]) for b, t, real in pieces]
    # one 4600-residue query (K2's contract) against the first bucket
    rng = np.random.default_rng(7)
    long_q = rng.integers(0, 20, 4600).astype(np.int8)
    _, t, real = pieces[0]
    long_rec = gapless_case(card, f"4600-residue query x {t.shape[1]} rows",
                            (*prefilter_stack([long_q], dev), t), real,
                            report["gapless"], reps=1)
    if long_rec["max_abs_err"] or any(r["max_abs_err"] for r in records):
        raise AssertionError("gapless kernel disagrees with its plain version")
    # the top-k that follows the kernel on the main path (torch.topk on a
    # packed key; the JAX package too selects outside any kernel body)
    from foldseek_tpu_torch.ops.gapless import gapless_scores_batch, topk_rows
    topk = []
    for b, t, _real in pieces:
        scores = gapless_scores_batch(*stack, t)
        k = min(t.shape[1], 1000)
        top_s, top_r = topk_rows(scores, k)
        rec = dict(label=f"top-{k} of {tuple(scores.shape)} scores",
                   ms=cuda_ms(lambda: topk_rows(scores, k), 5),
                   bound_ms=nbytes(scores, top_s, top_r) / HBM_BYTES_PER_S * 1e3,
                   bound_by="bytes")
        log(f"gapless top-k {rec['label']}: {rec['ms']:.3f} ms, bound "
            f"{rec['bound_ms']:.4f} ms (bytes)")
        topk.append(rec)
    report["gapless_topk"] = topk
    return total(records)


def sw_case(card, label, args, report_list, reps=5, ops=SW_OPS_PER_CELL):
    """Drive the SW kernel once against its plain version and time it and
    the plain version."""
    import numpy as np
    import torch

    from foldseek_tpu_torch.ops.sw_kernels import (sw_scores_pairs,
                                                   sw_scores_pairs_torch)
    paa, pss, slot_off, pair_start, _ra, _rs, toff, tlen = args
    got = sw_scores_pairs(*args)
    want = sw_scores_pairs_torch(*args)
    torch.cuda.synchronize()
    toff, tlen = np.asarray(toff), np.asarray(tlen)
    pairs = np.diff(np.asarray(pair_start))
    cells = int((np.repeat(np.diff(np.asarray(slot_off)), pairs) * tlen).sum())
    _, first = np.unique(toff, return_index=True)
    moved = (nbytes(paa, pss) + 2 * int(tlen[first].sum())
             + len(tlen) * (8 + 4 + 3 * 4))
    ms = cuda_ms(lambda: sw_scores_pairs(*args), reps)
    rec = dict(label=label, pairs=len(tlen),
               max_abs_err=max_abs_err(got, want), ms=ms,
               kernel_ms=profiled_kernel_ms(lambda: sw_scores_pairs(*args),
                                            "sw_kernel"),
               plain_ms=cuda_ms(lambda: sw_scores_pairs_torch(*args)),
               positive=int((got[0] > 0).sum()), ops_per_cell=ops,
               **card.bound(cells, ops, moved))
    log(f"sw {label}: {rec['pairs']} pairs, max_abs_err={rec['max_abs_err']} "
        f"wrapper {ms:.3f} ms (kernel alone by the profiler "
        f"{rec['kernel_ms']}) plain {rec['plain_ms']:.3f} ms "
        f"bound {rec['bound_ms']:.3f} ms ({rec['bound_by']}, {ops} ops/cell), "
        f"{cells / ms / 1e6:.1f} GCUPS, pairs with score > 0: "
        f"{rec['positive']}")
    report_list.append(rec)
    return rec


def sw_args(slots_aa, slots_ss, tids_per_slot, panels, dev):
    """`sw_scores_pairs` arguments for slots with a candidate list each."""
    import numpy as np
    import torch

    from foldseek_tpu_torch.ops.sw_kernels import pack_sw_slots
    paa, pss, slot_off = pack_sw_slots(slots_aa, slots_ss)
    pair_start = np.zeros(len(tids_per_slot) + 1, dtype=np.int64)
    np.cumsum([len(t) for t in tids_per_slot], out=pair_start[1:])
    tids = np.concatenate(tids_per_slot)
    offs = panels.offsets
    return (torch.from_numpy(paa).to(dev), torch.from_numpy(pss).to(dev),
            slot_off, pair_start, *panels.residues(), offs[tids],
            offs[tids + 1] - offs[tids])


def phase_sw(card, dev, tdb, qdb, panels, report):
    """SW kernel vs plain: forward + reversed slots against 1000
    candidates per query, then two long queries."""
    import numpy as np

    from foldseek_tpu_torch.ops.sw import QueryProfile
    rng = np.random.default_rng(3)

    def run(queries, label):
        slots_aa, slots_ss, tids = [], [], []
        for q_aa, q_ss in queries:
            prof = QueryProfile(q_aa, q_ss)
            rprof = prof.reversed()
            ti = rng.choice(tdb.size, min(1000, tdb.size), replace=False)
            slots_aa += [prof.prof_aa, rprof.prof_aa]
            slots_ss += [prof.prof_ss, rprof.prof_ss]
            tids += [ti, ti]
        return sw_case(card, label,
                       sw_args(slots_aa, slots_ss, tids, panels, dev),
                       report["sw"])

    main_q = [(np.asarray(qdb.get_aa(i)), np.asarray(qdb.get_ss(i)))
              for i in range(qdb.size)]
    main = run(main_q, f"{qdb.size} queries x fwd/rev x 1000")
    err = main["max_abs_err"]
    for L in (1500, 2500):
        q = (rng.integers(0, 20, L).astype(np.int8),
             rng.integers(0, 20, L).astype(np.int8))
        err = max(err, run([q], f"{L}-residue query x fwd/rev x 1000")[
            "max_abs_err"])
    if err:
        raise AssertionError("SW kernel disagrees with its plain version")
    return total([main])


def aa_panel(tdb, bucket, dev):
    """The AA twin of a bucket's 3Di panel: int8 [lt_pad, n_pad], pad 21."""
    import numpy as np
    import torch

    from foldseek_tpu_torch.db.panels import PAD_LETTER
    panel = np.full((bucket.n_pad, bucket.lt_pad), PAD_LETTER, dtype=np.int8)
    for row, i in enumerate(bucket.entry_idx):
        s = tdb.get_aa(int(i))
        panel[row, :len(s)] = s
    return torch.from_numpy(np.ascontiguousarray(panel.T)).to(dev)


def phase_call_shapes(card, dev, tdb, qdb, pieces, panels, report):
    """K5, K6 and K7: the JAX package's remaining kernel entry points, at
    their call shapes. Returns (gapless_dual entry, launches of this
    phase's drive)."""
    import numpy as np
    import torch

    from foldseek_tpu_torch.ops import gapless as tg
    from foldseek_tpu_torch.ops.sw import QueryProfile
    from foldseek_tpu_torch.ops.sw_kernels import sw_scores_pairs

    seqs = [np.asarray(qdb.get_ss(i)) for i in range(qdb.size)]
    profs = [QueryProfile(np.asarray(qdb.get_aa(i)), seqs[i])
             for i in range(qdb.size)]

    def dual_stack(ps):
        aa, q_off, _ = tg.pack_profiles_batch([p.prof_aa for p in ps],
                                              [0] * len(ps))
        ss, _, _ = tg.pack_profiles_batch([p.prof_ss for p in ps],
                                          [0] * len(ps))
        return [torch.from_numpy(a).to(dev) for a in (aa, ss, q_off)]

    bucket, t_ss, real = pieces[0]
    t_aa = aa_panel(tdb, bucket, dev)
    rng = np.random.default_rng(5)
    shared = rng.choice(tdb.size, min(1000, tdb.size), replace=False)
    k7 = sw_args([p.prof_aa for p in profs], [p.prof_ss for p in profs],
                 [shared] * len(profs), panels, dev)

    # the drive: every call shape once, launches counted
    tg.gapless_scores_batch.launches = 0
    tg.gapless_scores_dual.launches = 0
    sw_scores_pairs.launches = 0
    k5 = [(f"one query, {name}, x bucket lt={b.lt_pad} ({t.shape[1]} rows)",
           (*prefilter_stack(seqs[:1], dev, capped), t), r)
          for b, t, r in pieces for name, capped in (("capped", True),
                                                     ("no cap", False))]
    for _label, args, _r in k5:
        tg.gapless_scores_batch(*args)
    k6 = [(f"one query x bucket lt={bucket.lt_pad} ({t_ss.shape[1]} rows)",
           dual_stack(profs[:1])),
          (f"{len(profs)} queries x bucket lt={bucket.lt_pad} "
           f"({t_ss.shape[1]} rows)", dual_stack(profs))]
    for _label, (aa, ss, q_off) in k6:
        tg.gapless_scores_dual(aa, ss, q_off, t_aa, t_ss)
    sw_scores_pairs(*k7)
    torch.cuda.synchronize()
    launches = dict(gapless=tg.gapless_scores_batch.launches,
                    gapless_dual=tg.gapless_scores_dual.launches,
                    sw=sw_scores_pairs.launches)
    if not all(launches.values()):
        raise AssertionError(f"a call shape did not launch: {launches}")

    # each against its plain version
    err = 0
    for label, args, r in k5:
        err = max(err, gapless_case(card, label, args, r,
                                    report["gapless_single"])["max_abs_err"])
    dual = []
    for label, (aa, ss, q_off) in k6:
        args = (aa, ss, q_off, t_aa, t_ss)
        got = tg.gapless_scores_dual(*args)
        want = tg.gapless_scores_dual_torch(*args)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: tg.gapless_scores_dual(*args), 5)
        rec = dict(label=label, max_abs_err=max_abs_err([got], [want]), ms=ms,
                   plain_ms=cuda_ms(
                       lambda: tg.gapless_scores_dual_torch(*args)),
                   max_score=int(got.max()), ops_per_cell=GAPLESS_DUAL_OPS,
                   **card.bound(int(q_off[-1]) * real, GAPLESS_DUAL_OPS,
                                nbytes(aa, ss, q_off, t_aa, t_ss, got)))
        log(f"gapless_dual {label}: max_abs_err={rec['max_abs_err']} kernel "
            f"{ms:.3f} ms plain {rec['plain_ms']:.3f} ms "
            f"bound {rec['bound_ms']:.3f} ms ({rec['bound_by']}, "
            f"{GAPLESS_DUAL_OPS} ops/cell), max score {rec['max_score']}")
        report["gapless_dual"].append(rec)
        dual.append(rec)
        err = max(err, rec["max_abs_err"])
    err = max(err, sw_case(
        card, f"{len(profs)} forward profiles x 1000 shared targets", k7,
        report["sw_batch"])["max_abs_err"])
    if err:
        raise AssertionError("a kernel disagrees with its plain version at "
                             "a call shape of K5-K7")
    return total(dual[1:]), launches


def run_search(qdb, tdb, dev, mode: int, iterations: int = 1, **kw):
    """(results, m8 lines) of one search through the port's entry points."""
    from foldseek_tpu_torch.search import SearchParams, format_results, search
    from foldseek_tpu_torch.search.pipeline import iterative_search
    params = SearchParams(prefilter_mode=mode, add_backtrace=mode != 3, **kw)
    if iterations > 1:
        res = iterative_search(qdb, tdb, params, iterations, dev,
                               same_db=False)
    else:
        res = search(qdb, tdb, params, dev, same_db=False)
    return res, format_results(qdb, tdb, res, params.format_output,
                               with_backtrace=params.add_backtrace)


class gates_env:
    """FOLDSEEK_TPU_DEVICE_GATES set to `value` ("" = unset) inside a with."""

    def __init__(self, value: str):
        self.value = value

    def __enter__(self):
        self.old = os.environ.pop("FOLDSEEK_TPU_DEVICE_GATES", None)
        if self.value:
            os.environ["FOLDSEEK_TPU_DEVICE_GATES"] = self.value

    def __exit__(self, *exc):
        os.environ.pop("FOLDSEEK_TPU_DEVICE_GATES", None)
        if self.old is not None:
            os.environ["FOLDSEEK_TPU_DEVICE_GATES"] = self.old


def m8_bytes(qdb, tdb, results) -> bytes:
    """The m8 text of mode-1 results with backtraces, as `search -a` +
    `convertalis` write it."""
    from foldseek_tpu_torch.search import format_results
    from foldseek_tpu_torch.search.params import SearchParams
    lines = format_results(qdb, tdb, results, SearchParams().format_output,
                           with_backtrace=True)
    return ("\n".join(lines) + "\n").encode()


def check_lines(lines, qdb, every_query: bool = True, min_bits: int = 0):
    """Every query (or with every_query False, some query) finds hits; the
    m8 columns parse and are in range (bits from min_bits: a hit of 3Di
    predicted by random weights can score below 0 bits and still pass the
    E-value, whose Gumbel parameters come from the query's 3Di)."""
    import math
    seen = set()
    for line in lines:
        f = line.split("\t")
        if len(f) != 12:
            raise AssertionError(f"malformed m8 line: {line!r}")
        seen.add(f[0])
        fident, ev = float(f[2]), float(f[10])
        if not (0.0 <= fident <= 1.0 and math.isfinite(ev) and ev >= 0
                and int(f[11]) >= min_bits and 1 <= int(f[6]) <= int(f[7])
                and 1 <= int(f[8]) <= int(f[9])):
            raise AssertionError(f"out-of-range m8 line: {line!r}")
    if len(seen) != qdb.size and (every_query or not seen):
        raise AssertionError(f"{qdb.size - len(seen)} queries without hits")


STAGES = ("prefilter", "ungapped+gapped_prefilter", "sw_scoring", "host_loop",
          "gates_drain", "batch_recover", "tmalign", "lolalign")


def reset_counts(dev) -> None:
    """Every launch count, the stage times and the peak memory to 0."""
    import torch

    from foldseek_tpu_torch.ops.gapless import (gapless_scores_batch,
                                                gapless_scores_dual)
    from foldseek_tpu_torch.ops.gates_device import GateFleet
    from foldseek_tpu_torch.ops.sw_kernels import sw_scores_pairs
    from foldseek_tpu_torch.search import reset_stage_times
    reset_stage_times()
    torch.cuda.reset_peak_memory_stats(dev)
    gapless_scores_batch.launches = 0
    gapless_scores_dual.launches = 0
    sw_scores_pairs.launches = 0
    GateFleet.dispatches = 0


def read_counts(dev, stage_names, stage_prefix: str = "") -> dict:
    """The launch counts, gate fleets, the stages named (or starting with
    `stage_prefix`), the per-call counts (the pairs of each `align_all`
    call, the entries of each device panel set made) and the peak memory
    since reset_counts."""
    import torch

    from foldseek_tpu_torch.ops.gapless import (gapless_scores_batch,
                                                gapless_scores_dual)
    from foldseek_tpu_torch.ops.gates_device import GateFleet
    from foldseek_tpu_torch.ops.sw_kernels import sw_scores_pairs
    from foldseek_tpu_torch.search import (snapshot_stage_counts,
                                           snapshot_stage_times)
    stages = snapshot_stage_times()
    return dict(counts=snapshot_stage_counts(),
        launches=dict(gapless=gapless_scores_batch.launches,
                      gapless_dual=gapless_scores_dual.launches,
                      sw=sw_scores_pairs.launches),
        gate_fleets=GateFleet.dispatches,
        stages={k: v for k, v in stages.items() if k in stage_names
                or (stage_prefix and k.startswith(stage_prefix))},
        max_memory_allocated=torch.cuda.max_memory_allocated(dev))


def counted_search(qdb, tdb, dev, mode, **kw):
    """One search with every launch count set to 0 just before and read just
    after: (results, lines, record of seconds, stages, launches, memory)."""
    import torch
    reset_counts(dev)
    t0 = time.perf_counter()
    res, lines = run_search(qdb, tdb, dev, mode, **kw)
    torch.cuda.synchronize()
    rec = dict(seconds=time.perf_counter() - t0, hits=len(lines),
               targets=tdb.size, **read_counts(dev, STAGES))
    check_lines(lines, qdb)
    return res, lines, rec


def phase_e2e(dev, tdb, qdb, mode, report, name=None, gates=""):
    """`search` + `format_results` cold (nothing of the DB on the card) then
    warm; returns (the launches of the cold run, the warm run's results).
    `gates` is the value of FOLDSEEK_TPU_DEVICE_GATES for the two runs."""
    from foldseek_tpu_torch.db.panels import release_resident_panels

    name = name or f"e2e_mode{mode}"
    release_resident_panels()
    out = {}
    with gates_env(gates):
        for run_name in ("cold", "warm"):
            res, lines, rec = counted_search(qdb, tdb, dev, mode)
            out[run_name] = rec
            log(f"{name} {run_name}: {tdb.size} targets x {qdb.size} queries "
                f"{rec['seconds']:.3f} s, {len(lines)} hits, stages "
                f"{rec['stages']}, max_memory_allocated "
                f"{rec['max_memory_allocated']} B, launches {rec['launches']}, "
                f"gate fleets {rec['gate_fleets']}")
            if run_name == "cold":
                cold_lines, cold_res = lines, res
                main_launches = rec["launches"]
            elif lines != cold_lines:
                if not out["warm"]["gate_fleets"]:
                    raise AssertionError("warm run output differs from the "
                                         "cold run")
                # float32 fleets: a sum taken in another order may move a
                # structure-bit score by one; the records stay in the band
                compare_gates(cold_res, res, f"{name}: warm vs cold")
    wanted = ("gapless", "sw") if mode == 1 else ("sw",)
    if not all(main_launches[k] for k in wanted) or (
            mode == 3 and main_launches["gapless"]):
        raise AssertionError(f"mode {mode}: wrong kernels launched: "
                             f"{main_launches}")
    if mode == 1 and gates and \
            bool(out["warm"]["gate_fleets"]) != (gates == "1"):
        raise AssertionError(f"{name}: gate fleets dispatched "
                             f"{out['warm']['gate_fleets']} with "
                             f"FOLDSEEK_TPU_DEVICE_GATES={gates!r}")
    report[name] = out
    return main_launches, res


def phase_gate_turns(dev, tdb, qdb, report):
    """Warm mode-1 searches with the host's gates and with the device fleets
    in turns on the same card, six pairs alternating which side runs first:
    the end-to-end side of the crossover."""
    import statistics
    turns = []
    for gates in ("0", "1", "1", "0") * 3:
        with gates_env(gates):
            _res, _lines, rec = counted_search(qdb, tdb, dev, 1)
        turns.append(dict(gates="device" if gates == "1" else "host",
                          seconds=rec["seconds"], stages=rec["stages"]))
    pairs = [{t["gates"]: t["seconds"] for t in turns[i:i + 2]}
             for i in range(0, len(turns), 2)]
    summary = dict(
        pairs=len(pairs),
        device_ahead=sum(p["device"] < p["host"] for p in pairs),
        host_median=statistics.median(p["host"] for p in pairs),
        device_median=statistics.median(p["device"] for p in pairs))
    log("e2e mode 1 warm, gates in turns: " + "; ".join(
        f"{t['gates']} {t['seconds']:.3f} s (host_loop "
        f"{t['stages'].get('host_loop')}, gates_drain "
        f"{t['stages'].get('gates_drain', 0)})" for t in turns))
    log(f"e2e mode 1 warm, gates in turns: {summary}")
    report["e2e_mode1_gate_turns"] = dict(turns=turns, **summary)


def compare_gates(host_res, dev_res, what: str) -> dict:
    """Records with float32 device gates against records with the host's
    float64 gates: equal hit sets, backtraces and integer columns; TM and
    LDDT within GATE_TOL; the structure-bit score within 1."""
    import numpy as np
    d_tm, d_lddt, d_score = [], [], []
    if set(host_res) != set(dev_res):
        raise AssertionError(f"{what}: different query sets")
    for qk, hs in host_res.items():
        h_by = {r.db_key: r for r in hs}
        d_by = {r.db_key: r for r in dev_res[qk]}
        if set(h_by) != set(d_by):
            raise AssertionError(f"{what}: query {qk}: different hit sets")
        for tk, h in h_by.items():
            d = d_by[tk]
            if (h.backtrace, h.q_start, h.q_end, h.t_start, h.t_end,
                    h.identical, h.evalue) != (
                    d.backtrace, d.q_start, d.q_end, d.t_start, d.t_end,
                    d.identical, d.evalue):
                raise AssertionError(f"{what}: hit {qk}/{tk} differs beyond "
                                     "the gates")
            d_tm.append(abs(h.tm - d.tm))
            d_lddt.append(abs(h.lddt - d.lddt))
            d_score.append(abs(h.score - d.score))
    d_tm, d_lddt, d_score = (np.asarray(x) for x in (d_tm, d_lddt, d_score))
    rec = dict(hits=len(d_tm), tm_max=float(d_tm.max()),
               tm_mean=float(d_tm.mean()), lddt_max=float(d_lddt.max()),
               lddt_mean=float(d_lddt.mean()),
               scores_off_by_one=int((d_score == 1).sum()),
               score_max=int(d_score.max()))
    log(f"{what}: {rec}")
    if rec["tm_max"] > GATE_TOL or rec["lddt_max"] > GATE_TOL \
            or rec["score_max"] > 1:
        raise AssertionError(f"{what}: outside the band {GATE_TOL} / "
                             f"{GATE_TOL} / 1")
    return rec


def profiled_device_ms(fn, top: int = 12):
    """(device milliseconds of everything fn() puts on the card, kernels and
    copies; the `top` largest entries as [name, ms, calls]) from
    torch.profiler; (None, []) when it saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    # the operator rows only: the profiler lists each kernel a second time
    # under its own name, and a sum over both would count it twice
    rows = [(ev.key[:80],
             float(getattr(ev, "self_device_time_total",
                           getattr(ev, "self_cuda_time_total", 0.0))) / 1e3,
             int(ev.count)) for ev in p.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CPU]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    total_ms = sum(r[1] for r in rows)
    return (total_ms, [list(r) for r in rows[:top]]) if rows else (None, [])


def phase_gates(dev, tdb, qdb, results, report):
    """The TM/LDDT gate fleet alone, on the accepted hits of the mode-1 run."""
    import copy

    import numpy as np
    import torch

    from foldseek_tpu_torch.ops import lddt as lddt_ops
    from foldseek_tpu_torch.ops.tm_device import (REFINE_ITERS,
                                                  fragment_slots)
    from foldseek_tpu_torch.search import SearchParams
    from foldseek_tpu_torch.search import align
    from foldseek_tpu_torch.utils.hostpar import map_queries

    params = SearchParams(prefilter_mode=1, add_backtrace=True)
    qk2i, tk2i = qdb.key_to_index(), tdb.key_to_index()
    cpu = torch.device("cpu")
    ctx = {int(k): lddt_ops.lddt_query_context(qdb.get_ca(qk2i[int(k)]))
           for k in results}

    def subset(n_hits):
        per = -(-n_hits // len(results))
        return {qk: [copy.copy(r) for r in rs if r.backtrace][:per]
                for qk, rs in results.items()}

    def host(sub):
        def one(item):
            qk, rs = item
            qi = qk2i[int(qk)]
            align._host_gates_batch(rs, tdb, tk2i, params, qdb.entry_len(qi),
                                    qdb.get_ca(qi), ctx[int(qk)], True, True)
        t0 = time.perf_counter()
        map_queries(one, sub.items())
        return (time.perf_counter() - t0) * 1e3

    fleets_seen = []

    def device(sub, on=dev, check_every=-1):
        t0 = time.perf_counter()
        fleets = align._device_gates_dispatch(qdb, tdb, sub, params, qk2i,
                                              tk2i, True, True, on,
                                              check_every)
        dispatched = (time.perf_counter() - t0) * 1e3
        align._device_gates_finish(fleets, params, True, True)
        fleets_seen[:] = fleets
        return (time.perf_counter() - t0) * 1e3, dispatched

    def values(sub):
        return (np.array([r.tm for rs in sub.values() for r in rs]),
                np.array([r.lddt for rs in sub.values() for r in rs]))

    out = dict(sizes=[])
    # the card's fleet against the host's gates and against the CPU's fleet
    small, small_cpu, small_host = (subset(GATE_FLEET_SIZES[0])
                                    for _ in range(3))
    device(small)
    device(small_cpu, cpu)
    host(small_host)
    (tm_d, ld_d), (tm_c, ld_c), (tm_h, ld_h) = (
        values(x) for x in (small, small_cpu, small_host))
    out["cuda_vs_cpu_fleet"] = dict(
        hits=len(tm_d), tm_max=float(np.abs(tm_d - tm_c).max()),
        lddt_max=float(np.abs(ld_d - ld_c).max()),
        tm_over_1e5=int((np.abs(tm_d - tm_c) > 1e-5).sum()),
        lddt_over_1e5=int((np.abs(ld_d - ld_c) > 1e-5).sum()))
    out["cuda_fleet_vs_host"] = dict(
        tm_max=float(np.abs(tm_d - tm_h).max()),
        tm_mean=float(np.abs(tm_d - tm_h).mean()),
        lddt_max=float(np.abs(ld_d - ld_h).max()),
        lddt_mean=float(np.abs(ld_d - ld_h).mean()))
    log(f"gates: fleet on cuda vs fleet on cpu {out['cuda_vs_cpu_fleet']}; "
        f"fleet on cuda vs host batch_gates {out['cuda_fleet_vs_host']}")
    for rec in (out["cuda_vs_cpu_fleet"], out["cuda_fleet_vs_host"]):
        if rec["tm_max"] > GATE_TOL or rec["lddt_max"] > GATE_TOL:
            raise AssertionError(f"gate fleet outside the band: {rec}")

    for n in GATE_FLEET_SIZES:
        subs = [subset(n) for _ in range(4)]
        torch.cuda.reset_peak_memory_stats(dev)
        h0 = host(subs[0])
        d1, disp1 = device(subs[1])
        peak = torch.cuda.max_memory_allocated(dev)
        d2, disp2 = device(subs[2])
        h3 = host(subs[3])
        hits = sum(len(v) for v in subs[1].values())
        # bytes and operations of this run's fleets, for the bound
        h2d = d2h = cells = pairs = 0
        for items, fleet in fleets_seen:
            h2d += (fleet.qabs.nbytes + fleet.tabs.nbytes + fleet.m_len.nbytes
                    + fleet.norm.nbytes + 16 * fleet.n)
            d2h += 12 * fleet.n
            slots = 2 * len(fragment_slots(fleet.m_pad)[0])
            cells += int(fleet.m_len.sum()) * slots * (REFINE_ITERS + 1)
            pairs += int((fleet.m_len.astype(np.int64) ** 2).sum())
        gathered = 2 * 12 * sum(int(f.m_len.sum()) for _, f in fleets_seen)
        byte_ms = (h2d + d2h + gathered) / HBM_BYTES_PER_S * 1e3
        op_ms = (cells * TM_OPS_PER_CELL
                 + pairs * LDDT_OPS_PER_PAIR) / FP32_PER_S * 1e3
        rec = dict(hits=hits, host_ms=(h0 + h3) / 2, device_ms=(d1 + d2) / 2,
                   device_dispatch_ms=(disp1 + disp2) / 2,
                   host_turns=[h0, h3], device_turns=[d1, d2],
                   fleets=len(fleets_seen),
                   m_pads=sorted({f.m_pad for _, f in fleets_seen}),
                   h2d_bytes=h2d, d2h_bytes=d2h, gathered_bytes=gathered,
                   bound_ms=max(byte_ms, op_ms),
                   bound_by="operations" if op_ms >= byte_ms else "bytes",
                   max_memory_allocated=peak)
        log(f"gates {hits} hits: host batch_gates {rec['host_ms']:.1f} ms "
            f"{rec['host_turns']}, device fleet {rec['device_ms']:.1f} ms "
            f"{rec['device_turns']} (dispatch returns after "
            f"{rec['device_dispatch_ms']:.1f} ms), {rec['fleets']} fleets "
            f"m_pad {rec['m_pads']}, up {h2d} B down {d2h} B, bound "
            f"{rec['bound_ms']:.3f} ms ({rec['bound_by']}), peak memory "
            f"{peak} B")
        out["sizes"].append(rec)

    # the largest fleet: device work by the profiler, and running all 20
    # iterations beside the convergence test every fourth (the default on a
    # card)
    big = GATE_FLEET_SIZES[-1]
    out["profiler_device_ms"], out["profiler_top"] = profiled_device_ms(
        lambda: device(subset(big)))
    log("gates: largest device entries of the fleet by the profiler "
        "(name, ms, calls):" + "".join(f"\n  {r}" for r in out["profiler_top"]))
    a, b, c = subset(big), subset(big), subset(big)
    every4 = [device(a)[0], device(b)[0]]
    run_all = [device(c, check_every=0)[0],
               device(subset(big), check_every=0)[0]]
    if not all(np.array_equal(x, y) for x, y in zip(values(b), values(c))):
        raise AssertionError("gates: stopping at convergence changed a value")
    out["run_all_20_ms"], out["check_every_4_ms"] = run_all, every4
    log(f"gates {big} hits: device work by the profiler "
        f"{out['profiler_device_ms']} ms; all 20 iterations {run_all} ms, "
        f"convergence asked every 4th {every4} ms (equal values)")
    report["gates"] = out
    return out


def phase_pssm(card, dev, tdb, qdb, results, panels, report):
    """K1 and K3 at the inputs the profile path gives them: PSSM profiles
    (no composition bias, stored bytes / 4, an X row of zeros) built by
    `result2profile` from the mode-1 hits."""
    import numpy as np
    import torch

    from foldseek_tpu_torch.ops import gapless as tg
    from foldseek_tpu_torch.search import SearchParams
    from foldseek_tpu_torch.search import ungapped as tung
    from foldseek_tpu_torch.search.profile import (profile_query,
                                                   result2profile)
    t0 = time.perf_counter()
    keep = {qk: rs[:100] for qk, rs in results.items()}
    profiles = result2profile(qdb, tdb, keep)
    qprofs = {k: profile_query(p) for k, p in profiles.items()}
    log(f"pssm: result2profile of {len(profiles)} queries x 100 hits in "
        f"{time.perf_counter() - t0:.1f} s")
    out = dict(gapless=[], sw=[])

    # K1 through query_profile: the stack is caught on its way to the kernel
    pref = tung.resident_prefilter(tdb, dev)
    caught = []
    real = tung.gapless_scores_batch, tung.gapless_topk_batch

    def catching(fn):
        def call(prof, q_off, caps, t_T, *k):
            caught.append((prof, q_off, caps, t_T))
            return fn(prof, q_off, caps, t_T, *k)
        return call
    first = next(iter(qprofs.values()))
    # the prefilter reaches the wrapper by either name (scores, or top-k)
    tung.gapless_scores_batch, tung.gapless_topk_batch = (
        catching(fn) for fn in real)
    try:
        hits = pref.query_profile(first.prof_ss, SearchParams())
    finally:
        tung.gapless_scores_batch, tung.gapless_topk_batch = real
    if not hits or len(caught) != len(pref.panels.buckets):
        raise AssertionError("query_profile did not reach the gapless kernel "
                             "once a bucket")
    tlens = np.diff(pref.panels.offsets)
    for args, bucket in zip(caught, pref.panels.buckets):
        lo, hi = (int(x) for x in args[0][:, :tg.PAD_LETTER].aminmax())
        packed = tg.can_pack(int(args[2].min()), int(args[2].max()), lo, hi,
                             args[0].shape[0], args[3].shape[0])
        rec = gapless_case(
            card, f"PSSM query ({args[0].shape[0]} rows, entries [{lo}, {hi}], "
                  f"{'packed' if packed else '32-bit'}) x bucket "
                  f"lt={bucket.lt_pad} ({args[3].shape[1]} rows)",
            args, int(tlens[bucket.entry_idx].sum()), out["gapless"])
        if rec["max_abs_err"]:
            raise AssertionError("gapless kernel disagrees with its plain "
                                 "version on a PSSM profile")

    # K3 through PSSM slots: forward and reversed profile of every query
    # against 1000 candidates, as PairScorer packs them
    rng = np.random.default_rng(13)
    slots_aa, slots_ss, tids = [], [], []
    for qp in qprofs.values():
        rp = qp.reversed()
        ti = rng.choice(tdb.size, min(1000, tdb.size), replace=False)
        slots_aa += [qp.prof_aa, rp.prof_aa]
        slots_ss += [qp.prof_ss, rp.prof_ss]
        tids += [ti, ti]
    rec = sw_case(card, f"{len(qprofs)} PSSM queries x fwd/rev x 1000",
                  sw_args(slots_aa, slots_ss, tids, panels, dev), out["sw"])
    if rec["max_abs_err"]:
        raise AssertionError("SW kernel disagrees with its plain version on "
                             "PSSM profiles")
    torch.cuda.synchronize()
    report["pssm"] = out
    return total(out["gapless"]), total(out["sw"])


def phase_e2e_paths(dev, tdb, qdb, report):
    """The paths this slice added, each driven once through the entry
    points with the counts set to 0 just before: name -> launches."""
    paths = {"iter2_mode1": dict(mode=1, iterations=2),
             "mode0": dict(mode=0),
             "tmalign": dict(mode=1, alignment_type=1),
             "lolalign": dict(mode=1, alignment_type=3)}
    launches = {}
    for name, kw in paths.items():
        _res, _lines, rec = counted_search(qdb, tdb, dev, **kw)
        log(f"e2e {name}: {tdb.size} targets x {qdb.size} queries "
            f"{rec['seconds']:.3f} s, {rec['hits']} hits, stages "
            f"{rec['stages']}, launches {rec['launches']}, gate fleets "
            f"{rec['gate_fleets']}")
        uses_sw = name in ("iter2_mode1", "mode0")
        if (kw["mode"] == 1 and not rec["launches"]["gapless"]) or \
                bool(rec["launches"]["sw"]) != uses_sw:
            raise AssertionError(f"e2e {name}: wrong kernels launched: "
                                 f"{rec['launches']}")
        report[f"e2e_{name}"] = rec
        launches[name] = rec["launches"]
    return launches


def phase_mode3_kernel(card, dev, tdb, qdb, panels, report):
    """SW kernel vs plain at mode-3 shapes (3Di-only profiles, every query
    against every target, in chunks the plain version's state fits), then
    the whole-DB call: wrapper time beside kernel time."""
    import numpy as np
    import torch

    from foldseek_tpu_torch.ops.sw_kernels import sw_scores_pairs
    from foldseek_tpu_torch.search.ungapped import mode3_profile
    pss = [mode3_profile(np.asarray(qdb.get_ss(i))) for i in range(qdb.size)]
    paa = [np.zeros_like(p) for p in pss]
    records = []
    for c0 in range(0, tdb.size, MODE3_CHUNK):
        chunk = np.arange(c0, min(c0 + MODE3_CHUNK, tdb.size))
        records.append(sw_case(
            card, f"mode 3: {qdb.size} queries x targets {c0}..{chunk[-1]}",
            sw_args(paa, pss, [chunk] * len(pss), panels, dev),
            report["sw_mode3"], reps=2, ops=SW_OPS_NO_AA))
    if any(r["max_abs_err"] for r in records):
        raise AssertionError("SW kernel disagrees with its plain version at "
                             "mode-3 shapes")
    # the whole DB in one call, as the search path makes it: the plan of
    # the pairs built on the card; it must give the chunks' scores
    whole = list(sw_args(paa, pss, [np.arange(tdb.size)] * len(pss), panels,
                         dev))
    whole[6] = torch.as_tensor(whole[6]).to(dev)
    whole[7] = torch.as_tensor(whole[7]).to(dev, torch.int32)
    got = [x.reshape(len(pss), tdb.size) for x in sw_scores_pairs(*whole)]
    for c0 in range(0, tdb.size, MODE3_CHUNK):
        chunk = np.arange(c0, min(c0 + MODE3_CHUNK, tdb.size))
        part = sw_scores_pairs(*sw_args(paa, pss, [chunk] * len(pss), panels,
                                        dev))
        if not all(torch.equal(g[:, c0:c0 + len(chunk)],
                               x.reshape(len(pss), len(chunk)))
                   for g, x in zip(got, part)):
            raise AssertionError("sw mode 3: the whole-DB call disagrees "
                                 f"with the chunk from target {c0}")
    wrapper_ms = cuda_ms(lambda: sw_scores_pairs(*whole), 3)
    kernel_ms = profiled_kernel_ms(lambda: sw_scores_pairs(*whole),
                                   "sw_kernel")
    torch.cuda.synchronize()
    shown = "not measured" if kernel_ms is None else f"{kernel_ms:.3f} ms"
    log(f"sw mode 3 whole DB ({tdb.size * len(pss)} pairs): wrapper "
        f"{wrapper_ms:.3f} ms (CUDA events, plan included), kernel {shown} "
        "(torch.profiler)")
    report["sw_mode3_whole"] = dict(
        pairs=tdb.size * len(pss), wrapper_ms=wrapper_ms, kernel_ms=kernel_ms)
    return total(records)


# --- the workflows of slice 5: easy-cluster, cluster-search, rbh, multimer -----

WORKFLOW_STAGES = ("prefilter", "sw_scoring", "host_loop", "gates_drain",
                   "batch_recover", "search", "expand", "expandmultimer",
                   "structurealign_expand", "scoremultimer")


def device_busy_ms(prof):
    """Milliseconds the card spent in kernels and copies in a profile taken
    with the CUDA activity alone: the raw device events, each counted once,
    launched by PyTorch or through ctypes (summing them skips the
    profiler's per-operator tables, slow for the gate fleets' hundreds of
    thousands of launches); None when it saw no device time."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    ns = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
             if e.device_type() == cuda)
    return ns / 1e6 or None


def counted_run(dev, fn):
    """fn() with the counts of counted_search set to 0 just before and read
    just after, under torch.profiler with the CUDA activity alone: (fn's
    result, record with the device's busy time and idle share)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    reset_counts(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    rec = read_counts(dev, WORKFLOW_STAGES, stage_prefix="cluster")
    t1 = time.perf_counter()
    busy = device_busy_ms(prof)
    return out, dict(
        seconds=seconds, device_busy_ms=busy,
        profile_read_seconds=time.perf_counter() - t1,
        device_idle_share=None if busy is None else 1 - busy / 1e3 / seconds,
        **rec)


def busy_text(rec) -> str:
    if rec["device_busy_ms"] is None:
        return "device busy time not measured (the profiler saw none)"
    return (f"device busy {rec['device_busy_ms']:.1f} ms, idle share "
            f"{rec['device_idle_share']:.4f}")


def complex_db(db, path: str):
    """A copy of `db` at `path` whose fileids group its entries two by two
    (entries 2i and 2i + 1 are the chains of complex i): a data step of this
    script, since synth_db writes one complex per entry."""
    import shutil

    import numpy as np

    from foldseek_tpu_torch.db import load_db
    shutil.copytree(db.path, path)
    np.save(os.path.join(path, "fileids.npy"),
            (np.arange(db.size) // 2).astype(np.uint32))
    return load_db(path)


def cluster_files(db, dev, prefix: str, tmp_dir: str):
    """easy-cluster on a DB: cluster_db with the defaults, then the three
    files; returns the clusters."""
    from foldseek_tpu_torch.cluster import workflow as cwf
    os.makedirs(tmp_dir, exist_ok=True)
    clusters = cwf.cluster_db(db, cwf.ClusterParams(), dev, tmp_dir=tmp_dir)
    cwf.write_cluster_tsv(db, clusters, prefix + "_cluster.tsv")
    cwf.write_rep_fasta(db, clusters, prefix + "_rep_seq.fasta")
    cwf.write_all_seqs_fasta(db, clusters, prefix + "_all_seqs.fasta")
    return clusters


def clusearch_lines(qdb, path: str, dev, tmp_dir: str):
    """`search --cluster-search 1 --gpu 1` of qdb against the triple at
    `path`, formatted as m8 against its `_seq` DB: (results, lines)."""
    from foldseek_tpu_torch.db import load_db
    from foldseek_tpu_torch.search import SearchParams, format_results, search
    params = SearchParams(prefilter_mode=1, cluster_search=1)
    res = search(qdb, load_db(path), params, dev, same_db=False,
                 tmp_dir=tmp_dir)
    return res, format_results(qdb, load_db(path + "_seq"), res,
                               params.format_output)


def multimer_report(qdb, tdb, dev):
    """multimersearch --gpu 1 then createmultimerreport: (score lines,
    report lines)."""
    from foldseek_tpu_torch.multimer.report import create_multimer_report
    from foldseek_tpu_torch.multimer.workflow import multimer_search
    from foldseek_tpu_torch.search import SearchParams
    lines = multimer_search(qdb, tdb, SearchParams(prefilter_mode=1), dev)
    return lines, create_multimer_report(qdb, tdb, lines)


def check_clusters(db, clusters, prefix: str) -> None:
    """Every entry is the member of exactly one cluster, each cluster lists
    its representative first, and the files hold one line per entry and two
    per representative."""
    members = sorted(m for ms in clusters.values() for m in ms)
    if members != sorted(int(k) for k in db.keys) or any(
            ms[0] != r for r, ms in clusters.items()):
        raise AssertionError("easy-cluster: clusters do not partition the DB")
    with open(prefix + "_cluster.tsv") as f:
        tsv = f.read().splitlines()
    with open(prefix + "_rep_seq.fasta") as f:
        fasta = f.read().splitlines()
    if len(tsv) != db.size or len(fasta) != 2 * len(clusters):
        raise AssertionError("easy-cluster: wrong number of output lines")


def phase_cluster(dev, base, work, n_entries, report):
    """9. easy-cluster with the defaults (cov 0.8, e 0.01, three cascade
    steps, sensitivity 8, set cover, max-seqs 1000) on `n_entries`
    synthetic entries: the seconds of each stage, the pairs of each align
    stage, the SW launches and the clusters."""
    from foldseek_tpu_torch.db import synth_db
    db = synth_db(base, n_entries, os.path.join(work, "cluster_db"), seed=2)
    prefix = os.path.join(work, "clu")
    clusters, rec = counted_run(dev, lambda: cluster_files(
        db, dev, prefix, os.path.join(work, "clu_tmp")))
    check_clusters(db, clusters, prefix)
    pairs = rec["counts"].get("align_pairs", [])
    sets = rec["counts"].get("panel_set_entries", [])
    rec.update(entries=db.size, clusters=len(clusters),
               largest_cluster=max(len(m) for m in clusters.values()))
    log(f"cluster {db.size} entries: {rec['seconds']:.3f} s, "
        f"{len(clusters)} clusters (largest {rec['largest_cluster']}), pairs "
        f"per align stage {pairs}, device residues uploaded for DBs of "
        f"{sets} entries, stages {rec['stages']}, launches "
        f"{rec['launches']}, gate fleets {rec['gate_fleets']}, "
        f"max_memory_allocated {rec['max_memory_allocated']} B, "
        f"{busy_text(rec)}")
    if not rec["launches"]["sw"]:
        raise AssertionError("cluster: the SW kernel never launched")
    if len(pairs) != 4 or len(sets) != sum(1 for n in pairs if n):
        raise AssertionError("cluster: not four align stages, or one uploaded "
                             f"its DB more than once: {pairs}, {sets}")
    report["cluster"] = rec
    return db, clusters, rec["launches"]


def phase_clusearch(dev, db, clusters, qdb, work, report):
    """10. createclusearchdb from phase 9's clusters, then the queries with
    --cluster-search 1 --gpu 1: both kernels must launch."""
    from foldseek_tpu_torch.search.clusearch import create_clusearch_db
    path = os.path.join(work, "clusearch")
    t0 = time.perf_counter()
    create_clusearch_db(db, clusters, path)
    create_s = time.perf_counter() - t0
    (_res, lines), rec = counted_run(dev, lambda: clusearch_lines(
        qdb, path, dev, os.path.join(work, "clusearch_tmp")))
    check_lines(lines, qdb)
    rec.update(createclusearchdb_seconds=create_s, representatives=len(clusters),
               hits=len(lines))
    log(f"cluster-search {qdb.size} queries x {len(clusters)} representatives "
        f"of {db.size} entries: createclusearchdb {create_s:.3f} s, search "
        f"{rec['seconds']:.3f} s, {len(lines)} hits, stages {rec['stages']}, "
        f"launches {rec['launches']}, gate fleets {rec['gate_fleets']}, "
        f"{busy_text(rec)}")
    if not (rec["launches"]["gapless"] and rec["launches"]["sw"]):
        raise AssertionError(f"cluster-search: wrong kernels launched: "
                             f"{rec['launches']}")
    report["clusearch"] = rec
    return rec["launches"]


def check_report(report_lines, qdb) -> None:
    """Every query complex has an assignment; the report's columns parse and
    the TM-scores lie in [0, 1]. (A synthetic entry's name has no chain
    suffix, so the report names a complex by its first chain.)"""
    complex_of = {qdb.names[i]: int(qdb.fileids[i]) for i in range(qdb.size)}
    seen = set()
    for line in report_lines:
        f = line.split("\t")
        if len(f) != 14 or not all(0.0 <= float(x) <= 1.0 for x in f[4:6]):
            raise AssertionError(f"malformed report line: {line!r}")
        seen.add(complex_of[f[0]])
    if seen != set(complex_of.values()):
        raise AssertionError(f"{len(set(complex_of.values()) - seen)} query "
                             "complexes without an assignment")


def phase_multimer(dev, tdb, qdb, work, report):
    """11. multimersearch --gpu 1 + createmultimerreport with the card's
    default gates: the target DB regrouped into two-chain complexes, the
    queries likewise."""
    t0 = time.perf_counter()
    tm = complex_db(tdb, os.path.join(work, "multimer_targets"))
    qm = complex_db(qdb, os.path.join(work, "multimer_queries"))
    copy_s = time.perf_counter() - t0
    with gates_env(""):
        (lines, rep), rec = counted_run(dev, lambda: multimer_report(
            qm, tm, dev))
    check_report(rep, qm)
    # align_all calls: the chain search's, then the expand re-align's
    pairs = rec["counts"].get("align_pairs", [])
    rec.update(copy_seconds=copy_s, target_complexes=tdb.size // 2,
               query_complexes=qdb.size // 2,
               expanded_pairs=pairs[-1] if pairs else 0,
               score_lines=sum(len(v) for v in lines.values()),
               assignments=len(rep))
    log(f"multimer {qm.size // 2} query complexes x {tm.size // 2} target "
        f"complexes: {rec['seconds']:.3f} s, {len(rep)} assignments, pairs "
        f"of the chain search and the expand re-align {pairs}, stages "
        f"{rec['stages']}, launches {rec['launches']}, gate fleets "
        f"{rec['gate_fleets']}, max_memory_allocated "
        f"{rec['max_memory_allocated']} B, {busy_text(rec)}")
    if not (rec["launches"]["gapless"] and rec["launches"]["sw"]):
        raise AssertionError(f"multimer: wrong kernels launched: "
                             f"{rec['launches']}")
    report["multimer"] = rec
    return rec["launches"]


def phase_rbh(dev, tdb, qdb, work, report):
    """easy-rbh --gpu 1 of the queries against phase 9's DB with the card's
    default gates: both searches and the re-align, counted as the other
    paths are. The re-align sorts by structure bits, so from
    DEVICE_GATES_MIN_PAIRS pairs on its gates must run as fleets."""
    from foldseek_tpu_torch.search import SearchParams
    from foldseek_tpu_torch.search.align import DEVICE_GATES_MIN_PAIRS
    from foldseek_tpu_torch.search.rbh import easy_rbh
    with gates_env(""):
        lines, rec = counted_run(dev, lambda: easy_rbh(
            qdb.path, tdb.path, os.path.join(work, "rbh.m8"),
            os.path.join(work, "rbh_tmp"), SearchParams(prefilter_mode=1),
            dev))
    # align_all calls: A against B, B against A, the re-align
    pairs = rec["counts"].get("align_pairs", [])
    rec.update(hits=len(lines), targets=tdb.size,
               realigned_pairs=pairs[-1] if pairs else 0)
    log(f"rbh {qdb.size} queries x {tdb.size} targets: {rec['seconds']:.3f} s, "
        f"{len(lines)} reciprocal best hits, pairs of the two searches and "
        f"the re-align {pairs}, stages {rec['stages']}, launches "
        f"{rec['launches']}, gate fleets {rec['gate_fleets']}, "
        f"max_memory_allocated {rec['max_memory_allocated']} B, "
        f"{busy_text(rec)}")
    if not (lines and rec["launches"]["gapless"] and rec["launches"]["sw"]):
        raise AssertionError(f"rbh: no hits or wrong kernels launched: "
                             f"{rec['launches']}")
    if len(pairs) != 3 or (rec["realigned_pairs"] >= DEVICE_GATES_MIN_PAIRS
                           and not rec["gate_fleets"]):
        raise AssertionError(f"rbh: pairs of its align calls {pairs}: not "
                             "three calls, or a re-align past "
                             f"{DEVICE_GATES_MIN_PAIRS} pairs ran no gate "
                             "fleet")
    report["rbh"] = rec
    return rec["launches"]


# --- the DB, stage and output verbs and the index server ----------------------

def socket_path(work: str, name: str) -> str:
    """A unix socket path under `work`, or under a fresh short temporary
    directory when that would pass the 107 bytes an AF_UNIX path holds."""
    path = os.path.join(work, name)
    return path if len(path) < 100 else os.path.join(
        tempfile.mkdtemp(prefix="fs"), name)


class served:
    """`server.serve` of a DB on `device` in a thread of this process inside
    a with: its socket path; shut down and joined on the way out."""

    def __init__(self, db_path: str, sock: str, device):
        self.db_path, self.sock, self.device = db_path, sock, device

    def __enter__(self):
        import threading

        from foldseek_tpu_torch import server
        self.errors = []

        def run():
            try:
                server.serve(self.db_path, self.sock, 1000, self.device)
            except Exception as e:   # the main thread raises it on exit
                self.errors.append(e)
        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        deadline = time.perf_counter() + 300
        while not os.path.exists(self.sock):
            if self.errors or time.perf_counter() > deadline:
                raise AssertionError(f"index server did not come up: "
                                     f"{self.errors}")
            time.sleep(0.05)
        return self.sock

    def __exit__(self, *exc):
        from foldseek_tpu_torch import server
        if os.path.exists(self.sock):
            client = server.IndexServerClient(self.sock)
            client.shutdown()
            client.close()
        self.thread.join(timeout=120)
        if self.thread.is_alive() or self.errors or os.path.exists(self.sock):
            raise AssertionError(f"index server did not shut down cleanly: "
                                 f"{self.errors}")


def cli(*argv) -> None:
    """One verb through the port's command line in this process."""
    from foldseek_tpu_torch.cli import main as port_main
    rc = port_main([*map(str, argv), "-v", "1"])
    if rc != 0:
        raise AssertionError(f"{argv[0]} exited {rc}")


def read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def counted(dev, what: str, fn):
    """fn() with every launch count set to 0 just before and read just
    after: (its value, seconds, launches)."""
    import torch
    reset_counts(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts(dev, ())["launches"]
    log(f"{what}: {seconds:.3f} s, launches {launches}")
    return out, seconds, launches


def phase_verbs_server(dev, tdb, qdb, work, host_m8: bytes, report):
    """12. createindex on a copy of the target DB; the prefilter over the
    index's panels against built panels, and a cold mode-1 search over it;
    the index server on the card in a thread of this process against the
    in-process prefilter; `search --gpu 1 -a` of the unindexed target DB in
    fresh processes without and with --index-server, in turns, printed by
    convertalis and held against phase 5's m8 (host gates); the stage verbs ungappedprefilter,
    structurealign, samplemulambda and aln2tmscore through the command line
    on the card. Returns path -> launches."""
    import shutil

    import numpy as np

    from foldseek_tpu_torch.db import load_db
    from foldseek_tpu_torch.db.panels import release_resident_panels
    from foldseek_tpu_torch.search import SearchParams
    from foldseek_tpu_torch.search.ungapped import UngappedPrefilter
    from foldseek_tpu_torch.server import IndexServerClient
    t_phase = time.perf_counter()
    rec, paths = {}, {}
    d = os.path.join(work, "slice6")
    os.makedirs(d)
    # (a) an indexed copy: the earlier phases' DB stays without an index
    idx_path = os.path.join(d, "targets_indexed")
    shutil.copytree(tdb.path, idx_path)
    t0 = time.perf_counter()
    cli("createindex", idx_path)
    rec["createindex_seconds"] = time.perf_counter() - t0
    idb = load_db(idx_path)
    # (b) the index's panels give the built panels' hits
    seqs = [np.asarray(qdb.get_ss(i)) for i in range(qdb.size)]
    params = SearchParams()
    from_index = UngappedPrefilter(idb, dev)
    if not all(isinstance(b.panel_T, np.memmap)
               for b in from_index.panels.buckets):
        raise AssertionError("the indexed DB's panels were not read from "
                             "its index")
    local_hits = from_index.query_batch(seqs, params)
    if local_hits != UngappedPrefilter(tdb, dev).query_batch(seqs, params):
        raise AssertionError("prefilter hits over the index's panels differ "
                             "from those over built panels")
    release_resident_panels()
    with gates_env("0"):
        _res, lines, cold = counted_search(qdb, idb, dev, 1)
    if ("\n".join(lines) + "\n").encode() != host_m8:
        raise AssertionError("mode 1 over the indexed DB differs from phase "
                             "5's m8")
    rec["cold_mode1_index_panels"] = cold
    rec["cold_mode1_built_panels_seconds"] = \
        report["e2e_mode1_host_gates"]["cold"]["seconds"] \
        if "e2e_mode1_host_gates" in report else None
    log(f"createindex {rec['createindex_seconds']:.2f} s; cold mode 1 over "
        f"the index's panels {cold['seconds']:.3f} s (stages "
        f"{cold['stages']}), phase 5's cold run with host gates "
        f"{rec['cold_mode1_built_panels_seconds']} s")
    sock = socket_path(d, "idx.sock")
    reset_counts(dev)
    with served(idx_path, sock, dev):
        # (c) the server against the in-process prefilter
        client = IndexServerClient(sock)
        try:
            ping = client.ping()
            served_hits = client.query_batch(seqs)
            trips = []
            for _ in range(3):
                t0 = time.perf_counter()
                client.query_batch(seqs)
                trips.append((time.perf_counter() - t0) * 1e3)
        finally:
            client.close()
        paths["server"] = read_counts(dev, ())["launches"]
        in_process = []
        for _ in range(3):
            t0 = time.perf_counter()
            from_index.query_batch(seqs, params)
            in_process.append((time.perf_counter() - t0) * 1e3)
        if ping != {"ok": True, "n_targets": tdb.size}:
            raise AssertionError(f"index server ping: {ping}")
        if served_hits != local_hits:
            raise AssertionError("index server hits differ from the "
                                 "in-process prefilter's")
        if not paths["server"]["gapless"]:
            raise AssertionError(f"the index server launched no gapless "
                                 f"kernel: {paths['server']}")
        rec["server"] = dict(round_trip_ms=trips, in_process_ms=in_process,
                             launches=paths["server"])
        log(f"index server: ping {ping}, 16-query round trips "
            f"{[round(t, 2) for t in trips]} ms, in-process "
            f"{[round(t, 2) for t in in_process]} ms, launches "
            f"{paths['server']}")
        # (d) fresh search processes, without and with the server, in turns
        env = dict(os.environ, PYTHONPATH=REPO, FOLDSEEK_TPU_DEVICE_GATES="0")
        walls = []
        reset_counts(dev)
        for k, use_server in enumerate((False, True, True, False)):
            res = os.path.join(d, f"res{k}")
            argv = [sys.executable, "-m", "foldseek_tpu_torch", "search",
                    qdb.path, tdb.path, res, os.path.join(d, f"tmp{k}"),
                    "--gpu", "1", "-a", "--device", str(dev), "-v", "1"]
            if use_server:
                argv += ["--index-server", sock]
            t0 = time.perf_counter()
            proc = subprocess.run(argv, cwd=REPO, env=env, capture_output=True,
                                  text=True, timeout=600)
            walls.append(dict(index_server=use_server,
                              seconds=time.perf_counter() - t0))
            if proc.returncode != 0:
                raise AssertionError(f"search process exited "
                                     f"{proc.returncode}: {proc.stderr[-2000:]}")
            cli("convertalis", qdb.path, tdb.path, res, res + ".m8")
            if read_bytes(res + ".m8") != host_m8:
                raise AssertionError(f"search process {k} (index server "
                                     f"{use_server}): its m8 differs from "
                                     "phase 5's")
        paths["server_search"] = read_counts(dev, ())["launches"]
        if not paths["server_search"]["gapless"]:
            raise AssertionError("the served searches launched no gapless "
                                 "kernel in the server")
    rec["search_processes"] = walls
    log(f"search processes (without, with, with, without the server): "
        f"{[round(w['seconds'], 2) for w in walls]} s; the server's launches "
        f"{paths['server_search']}")
    # (e) the stage verbs on the card
    res_d = os.path.join(d, "res1")
    out = os.path.join(d, "ungapped")
    _, rec["ungappedprefilter_seconds"], paths["ungappedprefilter"] = counted(
        dev, "ungappedprefilter", lambda: cli(
            "ungappedprefilter", qdb.path, idx_path, out, "--device", dev))
    lines = read_bytes(out).decode().splitlines()[1:]
    want = [f"{int(qdb.keys[qi])}\t{k}\t{sc}" for qi, hits in
            enumerate(local_hits) for k, sc in hits]
    if lines != want:
        raise AssertionError("ungappedprefilter's lines differ from the "
                             "index server's hits")
    out = os.path.join(d, "realigned")
    _, rec["structurealign_seconds"], paths["structurealign"] = counted(
        dev, "structurealign -a", lambda: cli(
            "structurealign", qdb.path, idx_path, res_d, out, "-a",
            "--device", dev))
    rec["structurealign_records"] = read_bytes(out).count(b"\n")
    out = os.path.join(d, "mulambda")
    _, rec["samplemulambda_seconds"], paths["samplemulambda"] = counted(
        dev, "samplemulambda", lambda: cli(
            "samplemulambda", qdb.path, idx_path, out, "--device", dev))
    fits = [line.split("\t") for line in read_bytes(out).decode().splitlines()]
    out = os.path.join(d, "tmscores")
    t0 = time.perf_counter()
    cli("aln2tmscore", qdb.path, idx_path, res_d, out)
    rec["aln2tmscore_seconds"] = time.perf_counter() - t0
    tms = [float(line.split("\t")[1].split()[1])
           for line in read_bytes(out).decode().splitlines()]
    if not (paths["structurealign"]["sw"] and paths["samplemulambda"]["sw"]
            and paths["ungappedprefilter"]["gapless"]):
        raise AssertionError(f"a stage verb launched no kernel: {paths}")
    if len(fits) != qdb.size or not all(
            np.isfinite(float(x)) for f in fits for x in f[1:]):
        raise AssertionError(f"samplemulambda: {fits}")
    if len(tms) != host_m8.count(b"\n") or not all(0 < t <= 1 for t in tms):
        raise AssertionError("aln2tmscore: wrong record count or a "
                             "TM-score outside (0, 1]")
    rec["aln2tmscore_records"] = len(tms)
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"stage verbs: ungappedprefilter {rec['ungappedprefilter_seconds']:.2f}"
        f" s, structurealign {rec['structurealign_seconds']:.2f} s "
        f"({rec['structurealign_records']} records), samplemulambda "
        f"{rec['samplemulambda_seconds']:.2f} s, aln2tmscore "
        f"{rec['aln2tmscore_seconds']:.2f} s ({len(tms)} records)")
    log(f"phase 12 seconds: {rec['seconds']:.1f}")
    report["slice6"] = rec
    return paths


# Phase 7's comparisons, cuda against cpu. Each group is run by one process
# on one device, and the groups stand in the order of their cpu seconds
# (rbh about 115 s, two iterations 75, easy-cluster with cluster-search 65,
# multimer 55, the rest 13-35 on a slow 8-core host) so that the worker
# processes of the cpu side end together.
PARITY_SEARCHES = {"mode1": dict(mode=1), "mode3": dict(mode=3),
                   "mode0": dict(mode=0),
                   "iter2_mode1": dict(mode=1, iterations=2),
                   "tmalign": dict(mode=1, alignment_type=1),
                   "lolalign": dict(mode=1, alignment_type=3)}
PARITY_GROUPS = (("rbh",), ("iter2_mode1",), ("easy_cluster", "clusearch"),
                 ("multimer",), ("multimercluster",), ("lolalign",),
                 ("tmalign",), ("index_server",), ("mode0",), ("mode1",),
                 ("stage_verbs",), ("mode3",))
# entries of the DB the workflow groups (easy-cluster, cluster-search, rbh,
# multimer) compare on: their cpu side grows faster than linearly with it
# (230 s for rbh alone at 2,000 entries on a slow host), and at 2,000 the
# script came within 54 s of its 1,200 s limit
WORKFLOW_PARITY_ENTRIES = 1000
# worker processes of the cpu side: the plain versions keep about half of
# the host's cores busy, so two of them beside the cuda side fill it
PARITY_CPU_WORKERS = 2


def parity_inputs(base, pdb, qdb, work) -> dict:
    """The DBs of phase 7 on disk, by name: the queries, the parity DB, the
    workflow groups' DB of WORKFLOW_PARITY_ENTRIES entries, it and the
    queries regrouped into two-chain complexes, and easy-multimercluster's
    complex DB; "out" is the directory the workflows write to."""
    from foldseek_tpu_torch.db import synth_db
    d = os.path.join(work, "parity_inputs")
    paths = dict(out=os.path.join(work, "parity_outputs"), queries=qdb.path,
                 parity=pdb.path, workflow=os.path.join(d, "workflow"),
                 complex_targets=os.path.join(d, "complex_targets"),
                 complex_queries=os.path.join(d, "complex_queries"),
                 mmclu=os.path.join(d, "mmclu"))
    complex_db(synth_db(base, WORKFLOW_PARITY_ENTRIES, paths["workflow"],
                        seed=1), paths["complex_targets"])
    complex_db(qdb, paths["complex_queries"])
    complex_db(synth_db(base, MULTIMER_CLUSTER_ENTRIES,
                        os.path.join(d, "mmclu_src"), seed=3), paths["mmclu"])
    return paths


def parity_worker_init(threads: int) -> None:
    """A cpu-side worker: its k-mer prefilter runs its queries one after the
    other, as it does in the main process once CUDA is up, and its plain
    versions share the cores with the other worker."""
    import torch
    os.environ["FOLDSEEK_TPU_FORK"] = "0"
    torch.set_num_threads(threads)


def parity_side(group, paths: dict, device):
    """One side of a group of phase 7's comparisons on `device` (a torch
    device or its name): ({name: (outputs as bytes, seconds)}, mode 1's
    results when the group holds it). At module level, so that a worker
    process runs the cpu side while the main process runs the cuda side."""
    import torch

    from foldseek_tpu_torch.db import load_db
    from foldseek_tpu_torch.multimer.cluster import easy_multimer_cluster
    from foldseek_tpu_torch.search import SearchParams
    from foldseek_tpu_torch.search.clusearch import create_clusearch_db
    from foldseek_tpu_torch.search.rbh import easy_rbh
    dev = torch.device(device)
    d = os.path.join(paths["out"], dev.type)
    os.makedirs(d, exist_ok=True)
    qdb = load_db(paths["queries"])

    def files(prefix, suffixes):
        out = []
        for suffix in suffixes:
            with open(prefix + suffix, "rb") as f:
                out.append(f.read())
        return out

    def text(lines):
        return ("\n".join(lines) + "\n").encode()

    out, res_mode1, clusters = {}, None, None
    for name in group:
        t0 = time.perf_counter()
        if name in PARITY_SEARCHES:
            res, lines = run_search(qdb, load_db(paths["parity"]), dev,
                                    **PARITY_SEARCHES[name])
            outputs = [text(lines)]
            if name == "mode1":
                res_mode1 = res
        elif name == "easy_cluster":
            prefix = os.path.join(d, "clu")
            clusters = cluster_files(load_db(paths["workflow"]), dev, prefix,
                                     os.path.join(d, "clu_tmp"))
            outputs = files(prefix, ("_cluster.tsv", "_rep_seq.fasta",
                                     "_all_seqs.fasta"))
        elif name == "clusearch":
            path = os.path.join(d, "clusearch")
            create_clusearch_db(load_db(paths["workflow"]), clusters, path)
            outputs = [text(clusearch_lines(qdb, path, dev, os.path.join(
                d, "clusearch_tmp"))[1])]
        elif name == "rbh":
            outputs = [text(easy_rbh(paths["queries"], paths["workflow"],
                                     os.path.join(d, "rbh.m8"),
                                     os.path.join(d, "rbh_tmp"),
                                     SearchParams(prefilter_mode=1), dev))]
        elif name == "multimer":
            lines, rep = multimer_report(load_db(paths["complex_queries"]),
                                         load_db(paths["complex_targets"]),
                                         dev)
            outputs = [text(f"{q}\t{ln}" for q in sorted(lines)
                            for ln in lines[q]), text(rep)]
        elif name == "stage_verbs":
            outputs = stage_verb_outputs(paths, d, dev)
        elif name == "index_server":
            res = os.path.join(d, "served")
            with served(paths["parity"], socket_path(d, "p.sock"),
                        dev) as sock:
                cli("search", paths["queries"], paths["parity"], res,
                    res + "_tmp", "--gpu", "1", "-a", "--index-server", sock,
                    "--device", dev)
            cli("convertalis", paths["queries"], paths["parity"], res,
                res + ".m8")
            outputs = [read_bytes(res + ".m8")]
        else:   # multimercluster
            prefix = os.path.join(d, "mmclu")
            easy_multimer_cluster(paths["mmclu"], prefix,
                                  os.path.join(d, "mmclu_tmp"),
                                  SearchParams(), dev)
            outputs = files(prefix, ("_cluster.tsv", "_rep_seq.fasta"))
        out[name] = (outputs, time.perf_counter() - t0)
    return out, res_mode1


def stage_verb_outputs(paths: dict, d: str, dev) -> list:
    """The outputs of the stage verbs on `dev` over the parity DB:
    ungappedprefilter, `search --gpu 1 --max-seqs 50`, structurealign -a
    over that result, samplemulambda, and convertalis of the realigned
    result in format modes 0-5 (mode 5 writes a PDB file a hit: their names
    and bytes, in name order)."""
    q, t, pre = paths["queries"], paths["parity"], os.path.join(d, "sv")
    cli("ungappedprefilter", q, t, pre + "_ungapped", "--device", dev)
    cli("search", q, t, pre + "_res", pre + "_tmp", "--gpu", "1",
        "--max-seqs", "50", "--device", dev)
    cli("structurealign", q, t, pre + "_res", pre + "_aln", "-a", "--device",
        dev)
    cli("samplemulambda", q, t, pre + "_mulambda", "--device", dev)
    outputs = [read_bytes(pre + x)
               for x in ("_ungapped", "_res", "_aln", "_mulambda")]
    for mode in range(6):
        out = f"{pre}_mode{mode}"
        if mode == 5:
            os.makedirs(out)
            out += "/"
        cli("convertalis", q, t, pre + "_aln", out, "--format-mode", mode)
        if mode == 5:
            outputs.append(b"".join(
                name.encode() + b"\0" + read_bytes(out + name)
                for name in sorted(os.listdir(out))))
        else:
            outputs.append(read_bytes(out))
    return outputs


def phase_parity(dev, base, pdb, qdb, work, report):
    """7. parity, cuda against cpu, byte for byte, with the host's gates on
    both sides, on the parity DB: the m8 lines of PARITY_SEARCHES and the
    outputs of the stage verbs; on the workflow DB: easy-cluster's three
    files and the cluster-search m8 over those clusters, the easy-rbh m8
    (--gpu 1), the multimer score lines and report (complexes of two
    entries); easy-multimercluster's two files on a smaller complex DB. The
    cpu side runs in PARITY_CPU_WORKERS spawned processes while this one
    runs the cuda side. Then mode 1 with the device gates on the card
    against the host gates on the cpu, inside the band of phase 5."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from foldseek_tpu_torch.db import load_db
    paths = parity_inputs(base, pdb, qdb, work)
    entries = {name: pdb.size for g in PARITY_GROUPS for name in g}
    entries.update(dict.fromkeys(("easy_cluster", "clusearch", "rbh",
                                  "multimer"), WORKFLOW_PARITY_ENTRIES))
    entries["multimercluster"] = load_db(paths["mmclu"]).size
    threads = max(1, (os.cpu_count() or 2) // PARITY_CPU_WORKERS)
    pool = ProcessPoolExecutor(
        PARITY_CPU_WORKERS, mp_context=multiprocessing.get_context("spawn"),
        initializer=parity_worker_init, initargs=(threads,))
    t0 = time.perf_counter()
    try:
        with gates_env("0"):
            on_cpu = [pool.submit(parity_side, g, paths, "cpu")
                      for g in PARITY_GROUPS]
            on_gpu = [parity_side(g, paths, dev) for g in PARITY_GROUPS]
            cuda_seconds = time.perf_counter() - t0
            on_cpu = [f.result() for f in on_cpu]
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    report["parity_seconds"] = dict(cuda_side=cuda_seconds,
                                    both=time.perf_counter() - t0)
    log(f"parity: cuda side {cuda_seconds:.1f} s, both sides "
        f"{report['parity_seconds']['both']:.1f} s ({PARITY_CPU_WORKERS} "
        "cpu workers)")
    host_cpu = next(res for _, res in on_cpu if res is not None)
    for (gpu, _), (cpu, _) in zip(on_gpu, on_cpu):
        for name, (got, cuda_s) in gpu.items():
            want, cpu_s = cpu[name]
            same = got == want
            lines = sum(b.count(b"\n") for b in got)
            log(f"parity {name}, {entries[name]} entries x {qdb.size} "
                f"queries: {lines} lines in {len(got)} outputs, cuda "
                f"{cuda_s:.1f} s, cpu {cpu_s:.1f} s, byte-identical: {same}")
            report[f"parity_{name}"] = dict(
                entries=entries[name], lines=lines, identical=same,
                cuda_seconds=cuda_s, cpu_seconds=cpu_s)
            if not same or not all(b.strip() for b in got):
                raise AssertionError(f"{name}: the output on cuda differs "
                                     "from the output on cpu, or is empty")
    with gates_env("1"):
        res_gpu, _ = run_search(qdb, pdb, dev, mode=1)
    report["parity_mode1_device_gates"] = compare_gates(
        host_cpu, res_gpu, f"parity mode 1, {pdb.size} targets: device gates "
                           "on cuda vs host gates on cpu")

# --- ProstT5: createdb --prostt5-model and its sequence-only DBs -------------

BF16_PER_S = 989e12            # H100 SXM data sheet, dense bf16 tensor cores
# (b): sequences of the 2-layer release-width model, card against CPU
PROSTT5_CHECK_LENGTHS = (50, 333, 667, 1000)
PROSTT5_F32_TOL = 1e-4
# (c): target entries the full model predicts, 248 batches of 8, beside the
# 16 queries joined into sequences of 500-2,000 residues (the 1,024 and
# 2,048 pad buckets)
PROSTT5_FASTA_ENTRIES = 1_984
PROSTT5_JOINED_LENGTHS = (500, 571, 642, 714, 785, 857, 928, 1000,
                          1100, 1228, 1357, 1485, 1614, 1742, 1871, 2000)


def prostt5_flops(cfg, n: int) -> float:
    """Operations of the encoder on one sequence of n tokens: two per matmul
    parameter and token, and the two attention products over n keys
    (4 n H d_kv a token and layer)."""
    inner = cfg.num_heads * cfg.d_kv
    params = cfg.num_layers * (4 * cfg.d_model * inner
                               + 2 * cfg.d_model * cfg.d_ff)
    return 2.0 * params * n + 4.0 * n * n * inner * cfg.num_layers


def prostt5_buckets(seqs, batch_size: int = 8) -> dict:
    """ProstT5.predict's batches by pad length: {T: [tokens of each
    sequence]} (sorted by length, batches of 8, the next power of two of at
    least 16 tokens)."""
    lens = sorted(len(s) + 2 for s in seqs)
    out = {}
    for start in range(0, len(lens), batch_size):
        batch = lens[start:start + batch_size]
        T = max(16, 1 << (max(batch) - 1).bit_length())
        out.setdefault(T, []).extend(batch)
    return out


def prostt5_random_params(cfg, dev, seed: int):
    """The tree of `init_random_params` (normal values times 0.02, norms of
    ones), drawn on `dev` from a seeded torch.Generator: numpy's RandomState
    takes too long for 1.2 B values."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g, device=dev).mul_(0.02)

    def ones(n):
        return torch.ones(n, device=dev)
    inner = cfg.num_heads * cfg.d_kv
    return {
        "embed": r(cfg.vocab_size, cfg.d_model),
        "final_norm": ones(cfg.d_model),
        "rel_bias": r(cfg.rel_buckets, cfg.num_heads),
        "layers": [dict(attn_norm=ones(cfg.d_model),
                        wq=r(cfg.d_model, inner), wk=r(cfg.d_model, inner),
                        wv=r(cfg.d_model, inner), wo=r(inner, cfg.d_model),
                        ffn_norm=ones(cfg.d_model),
                        ffn_up=r(cfg.d_model, cfg.d_ff),
                        ffn_down=r(cfg.d_ff, cfg.d_model))
                   for _ in range(cfg.num_layers)],
        "conv0_w": r(cfg.conv_hidden, cfg.d_model, 1, 7),
        "conv0_b": r(cfg.conv_hidden),
        "conv3_w": r(cfg.n_states, cfg.conv_hidden, 1, 7),
        "conv3_b": r(cfg.n_states)}


def device_ms_by_kind(prof, top: int = 12) -> dict:
    """The device's milliseconds in a profile taken with the CUDA activity
    alone, by kind: matrix products (cuBLAS / CUTLASS kernels, cuBLAS's
    `nvjet` ones included), copies and fills, every other kernel; the count
    of kernels; and the `top` kernel names by milliseconds, each with its
    launches."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    out = dict(gemm=0.0, copy=0.0, other=0.0, kernels=0)
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        name = e.name()
        low = name.lower()
        kind = ("copy" if "memcpy" in low or "memset" in low else
                "gemm" if any(k in low for k in ("gemm", "cutlass", "xmma",
                                                 "nvjet", "sm90_", "cublas"))
                else "other")
        ms = e.duration_ns() / 1e6
        out[kind] += ms
        out["kernels"] += kind != "copy"
        entry = by_name.setdefault(name[:120], [0.0, 0])
        entry[0] += ms
        entry[1] += 1
    out["top"] = [dict(name=n, ms=v[0], launches=v[1]) for n, v in
                  sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]]
    return out


def write_fasta(path: str, records) -> str:
    with open(path, "w") as f:
        for name, seq in records:
            f.write(f">{name}\n{seq}\n")
    return path


def prostt5_card_vs_cpu(dev, cfg, rec):
    """(b): the encoder of `cfg` from seeded host weights, on the card in
    float32 (within PROSTT5_F32_TOL of the CPU's float32) and in bfloat16,
    with cuBLAS's reduced-precision bf16 reduction as it stands and off
    (letters by the margin rule against the CPU's float32)."""
    import numpy as np
    import torch

    from foldseek_tpu_torch.nn import prostt5 as P
    from foldseek_tpu_torch.nn.gguf_writer import default_vocab
    params = P.init_random_params(cfg, seed=11)
    token_id = {t: i for i, t in enumerate(default_vocab(cfg.vocab_size))}
    rng = np.random.RandomState(13)
    seqs = ["".join(rng.choice(list(P.THREE_DI), n))
            for n in PROSTT5_CHECK_LENGTHS]
    cpu = P.ProstT5(cfg=cfg, params=params, token_id=token_id, device="cpu",
                    dtype=torch.float32)
    tokens, mask = cpu.batch(seqs)
    valid = torch.zeros(len(seqs), tokens.shape[1] - 1, dtype=torch.bool)
    for row, seq in enumerate(seqs):
        valid[row, :len(seq)] = True
    t0 = time.perf_counter()
    want = cpu.encoder(tokens, mask)[valid]
    rec["cpu_f32_seconds"] = time.perf_counter() - t0
    del cpu

    def on_card(dtype):
        enc = P.ProstT5Encoder(cfg, P.params_from_numpy(cfg, params, dev,
                                                        dtype))
        return enc(tokens.to(dev), mask.to(dev))[valid.to(dev)].cpu()

    rec["f32_max_abs_dlogit"] = float((on_card(torch.float32) - want)
                                      .abs().max())
    log(f"ProstT5 (b) {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"lengths {PROSTT5_CHECK_LENGTHS}: float32 on the card vs the CPU, "
        f"max |dlogit| {rec['f32_max_abs_dlogit']:.3g}")
    if not rec["f32_max_abs_dlogit"] <= PROSTT5_F32_TOL:
        raise AssertionError("ProstT5 float32 on the card differs from the "
                             f"CPU by more than {PROSTT5_F32_TOL}")
    matmul = torch.backends.cuda.matmul
    default = matmul.allow_bf16_reduced_precision_reduction
    rec["bf16_reduced_precision_reduction_default"] = default
    top2 = want.topk(2, -1).values
    margin = top2[:, 0] - top2[:, 1]
    for name, flag in (("bf16", default), ("bf16_no_reduced_reduction", False)):
        matmul.allow_bf16_reduced_precision_reduction = flag
        try:
            got = on_card(torch.bfloat16)
        finally:
            matmul.allow_bf16_reduced_precision_reduction = default
        d = float((got - want).abs().max())
        differ = got.argmax(-1) != want.argmax(-1)
        rec[name] = dict(max_abs_dlogit=d, residues=len(want),
                         letters_differ=int(differ.sum()),
                         in_band=int((margin <= 2 * d).sum()))
        log(f"ProstT5 (b) {name} (reduced-precision reduction {flag}) vs CPU "
            f"float32: {rec[name]}")
        if (differ & (margin > 2 * d)).any():
            raise AssertionError(f"ProstT5 {name}: a letter differs outside "
                                 "the margin band")


def phase_prostt5(dev, tdb, qdb, pdb, work, report, cfg=None):
    """13. ProstT5: (a) the bucket table on the card equals the CPU's for
    T <= 4096; (b) prostt5_card_vs_cpu at the release width with 2 layers;
    (c) the full release model (`cfg`, default 24 layers, d_model 1024) from
    seeded weights drawn on the card, written as an f16 GGUF (timed), then
    `createdb --prostt5-model` through the command line over the AA strings
    of PROSTT5_FASTA_ENTRIES target entries and the queries joined into 16
    long sequences: seconds, tokens and peak memory per pad bucket beside the
    bound; (d) a ProstT5 DB of the queries' AA strings, `search --gpu 1 -a`
    of it against the target DB and against itself (both kernels counted,
    the gapless kernel must launch in both, the SW kernel in the search
    against itself), convertalis; (e) the ProstT5 DB against the parity DB
    and against itself on cuda and on cpu, byte for byte. Returns the
    launches of (d)'s two searches by path."""
    import torch

    from foldseek_tpu_torch.db import load_db
    from foldseek_tpu_torch.nn import prostt5 as P
    from foldseek_tpu_torch.nn.gguf_writer import write_prostt5_gguf
    from foldseek_tpu_torch.search import (snapshot_stage_counts,
                                           snapshot_stage_times)
    from torch.profiler import ProfilerActivity, profile
    t_phase = time.perf_counter()
    cfg = cfg or P.ProstT5Config()
    rec = report["prostt5"] = dict(layers=cfg.num_layers, d_model=cfg.d_model,
                                   d_ff=cfg.d_ff, heads=cfg.num_heads)
    d = os.path.join(work, "prostt5")
    os.makedirs(d)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on for float32 matmuls; the encoder's "
                             "float32 products need it off")
    # (a)
    for T in (16, 1024, 4096):
        if not torch.equal(P.bucket_table(T, cfg, dev).cpu(),
                           P.bucket_table(T, cfg, "cpu")):
            raise AssertionError(f"ProstT5 bucket table differs at T={T}")
    rec["bucket_table_exact_to"] = 4096
    # (b)
    prostt5_card_vs_cpu(dev, P.ProstT5Config(**{**cfg.__dict__,
                                                "num_layers": 2}), rec)
    # (c)
    gguf = os.path.join(d, "release.gguf")
    t0 = time.perf_counter()
    params = prostt5_random_params(cfg, dev, seed=7)
    torch.cuda.synchronize()
    rec["weights_seconds"] = time.perf_counter() - t0
    rec["matmul_params"] = sum(int(t.numel()) for layer in params["layers"]
                               for t in layer.values() if t.dim() == 2)
    t0 = time.perf_counter()
    write_prostt5_gguf(gguf, cfg, params, f16_weights=True)
    rec["gguf_write_seconds"] = time.perf_counter() - t0
    rec["gguf_bytes"] = os.path.getsize(gguf)
    del params
    torch.cuda.empty_cache()
    q_strs = [qdb.get_aa_str(i).upper() for i in range(qdb.size)]
    joined = []
    for j, n in enumerate(PROSTT5_JOINED_LENGTHS):
        seq = "".join(q_strs[j % len(q_strs):] + q_strs[:j % len(q_strs)])
        while len(seq) < n:
            seq += seq
        joined.append((f"joined_{j}", seq[:n]))
    records = [(tdb.names[i], tdb.get_aa_str(i).upper())
               for i in range(min(PROSTT5_FASTA_ENTRIES, tdb.size))] + joined
    fasta = write_fasta(os.path.join(d, "entries.fasta"), records)
    out = os.path.join(d, "entries_prostt5")
    reset_counts(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cli("createdb", fasta, out, "--prostt5-model", gguf, "--device", dev)
        torch.cuda.synchronize()
        rec["createdb_seconds"] = time.perf_counter() - t0
    rec["device_ms"] = device_ms_by_kind(prof)
    rec["createdb_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    stages, counts = snapshot_stage_times(), snapshot_stage_counts()
    rec["gguf_load_seconds"] = stages["prostt5_load"]
    want_buckets = prostt5_buckets([s for _, s in records])
    buckets, real, padded, predict_s, bound_s = {}, 0, 0, 0.0, 0.0
    for T in sorted(want_buckets):
        label = f"prostt5_T{T}"
        lens = want_buckets[T]
        b = dict(batches=len(counts[label + "_rows"]),
                 rows=sum(counts[label + "_rows"]),
                 tokens=sum(counts[label + "_tokens"]),
                 padded_tokens=sum(counts[label + "_rows"]) * T,
                 seconds=stages[label],
                 peak_bytes=max(counts.get(label + "_peak_bytes", [0])),
                 bound_ms=sum(prostt5_flops(cfg, n) for n in lens)
                 / BF16_PER_S * 1e3)
        if (b["rows"], b["tokens"]) != (len(lens), sum(lens)):
            raise AssertionError(f"ProstT5 bucket {T}: {b} is not the "
                                 "batching of the FASTA")
        b["ms_per_batch"] = b["seconds"] / b["batches"] * 1e3
        b["share_of_bound"] = b["bound_ms"] / (b["seconds"] * 1e3)
        buckets[str(T)] = b
        real += b["tokens"]
        padded += b["padded_tokens"]
        predict_s += b["seconds"]
        bound_s += b["bound_ms"] / 1e3
    rec.update(buckets=buckets, tokens=real, padded_tokens=padded,
               predict_seconds=predict_s, tokens_per_s=real / predict_s,
               padded_tokens_per_s=padded / predict_s, bound_seconds=bound_s,
               share_of_bound=bound_s / predict_s)
    db = load_db(out)
    by_name = dict(records)
    if db.size != len(records) or any(
            db.entry_len(i) != len(by_name[db.names[i]])
            or db.get_aa_str(i) != by_name[db.names[i]]
            for i in range(db.size)):
        raise AssertionError("the ProstT5 DB does not hold the FASTA's "
                             "entries")
    if db.ca is not None or not (0 <= int(db.ss.min())
                                 and int(db.ss.max()) < cfg.n_states):
        raise AssertionError("the ProstT5 DB holds C-alpha data or states "
                             "outside the 3Di alphabet")
    log(f"ProstT5 (c) {cfg.num_layers} layers, d_model {cfg.d_model}: GGUF "
        f"write {rec['gguf_write_seconds']:.1f} s ({rec['gguf_bytes']} B), "
        f"load {rec['gguf_load_seconds']:.1f} s, createdb of {db.size} "
        f"entries {rec['createdb_seconds']:.1f} s, {real} tokens "
        f"({padded} padded) in {predict_s:.2f} s: {rec['tokens_per_s']:.0f} "
        f"tokens/s, {rec['share_of_bound']:.3f} of the bound, peak "
        f"{rec['createdb_peak_bytes'] / 2**30:.2f} GiB; device ms under the "
        f"profiler's CUDA activity: {rec['device_ms']}")
    for T, b in buckets.items():
        log(f"  T={T}: {b['batches']} batches, {b['ms_per_batch']:.1f} ms a "
            f"batch, bound {b['bound_ms']:.1f} ms of {b['seconds'] * 1e3:.1f}"
            f", peak {b['peak_bytes'] / 2**30:.2f} GiB")
    # (d)
    seq_db = os.path.join(d, "queries_prostt5")
    write_fasta(os.path.join(d, "queries.fasta"),
                [(qdb.names[i], qdb.get_aa_str(i)) for i in range(qdb.size)])
    cli("createdb", os.path.join(d, "queries.fasta"), seq_db,
        "--prostt5-model", gguf, "--device", dev)
    os.remove(gguf)
    sdb = load_db(seq_db)
    paths = {}
    for name, target, every_query in (("prostt5", tdb, False),
                                      ("prostt5_self", sdb, True)):
        res = os.path.join(d, name)
        _, seconds, launches = counted(
            dev, f"ProstT5 (d) search --gpu 1 -a of the ProstT5 DB against "
                 f"{target.size} entries",
            lambda: cli("search", seq_db, target.path, res, res + "_tmp",
                        "--gpu", "1", "-a", "--device", dev))
        cli("convertalis", seq_db, target.path, res, res + ".m8")
        with open(res + ".m8") as f:
            lines = f.read().splitlines()
        rec[name] = dict(seconds=seconds, launches=launches,
                         targets=target.size, hits=len(lines),
                         queries_with_hits=len({ln.split("\t")[0]
                                                for ln in lines}))
        log(f"  {rec[name]}")
        paths[name] = launches
        # random weights predict 3Di that need not resemble the targets'
        # (the prefilter scores 3Di alone): against the structure DB a query
        # may find nothing, against its own DB each finds itself
        if lines or every_query:
            check_lines(lines, sdb, every_query, min_bits=-(2 ** 31))
        if not launches["gapless"] > 0 or (every_query
                                           and not launches["sw"] > 0):
            raise AssertionError(f"{name}: a kernel did not launch: "
                                 f"{launches}")
    # (e)
    lines = 0
    for name, target in (("parity", pdb), ("parity_self", sdb)):
        m8 = {}
        for side, device in (("cuda", dev), ("cpu", "cpu")):
            res = os.path.join(d, f"{name}_{side}")
            t0 = time.perf_counter()
            cli("search", seq_db, target.path, res, res + "_tmp", "--gpu",
                "1", "-a", "--device", device)
            cli("convertalis", seq_db, target.path, res, res + ".m8")
            m8[side] = (read_bytes(res + ".m8"), time.perf_counter() - t0)
        rec[name] = dict(entries=target.size,
                         lines=m8["cpu"][0].count(b"\n"),
                         identical=m8["cuda"][0] == m8["cpu"][0],
                         cuda_seconds=m8["cuda"][1], cpu_seconds=m8["cpu"][1])
        log(f"ProstT5 (e) {name}, {target.size} entries: {rec[name]}")
        if not rec[name]["identical"]:
            raise AssertionError(f"ProstT5 {name}: the m8 on cuda differs "
                                 "from the one on cpu")
        lines += rec[name]["lines"]
    if not lines:
        raise AssertionError("ProstT5 parity: both m8 files are empty")
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"phase 13 seconds: {rec['seconds']:.1f}")
    return paths


def phase_boundaries(dev, report):
    """Both kernels against their plain versions, exact, where their
    branches change: every instance and pass boundary, a 20-row slot beside
    a 1,500-row one, targets of length 1 and of the panel's full padded
    length, and a stack whose caps rule out the packed gapless instance."""
    import numpy as np
    import torch

    from foldseek_tpu_torch.ops import gapless as tg
    from foldseek_tpu_torch.ops import sw_kernels as tk
    from foldseek_tpu_torch.ops.sw import QueryProfile
    from foldseek_tpu_torch.search.ungapped import (BYTE_CAP,
                                                    make_query_profile)
    rng = np.random.default_rng(11)
    n, lt = 3072, 128
    lens = rng.integers(1, lt + 1, n)
    lens[0], lens[1] = 1, lt
    panel = np.full((2, n, lt), tg.PAD_LETTER, dtype=np.int8)
    for i, L in enumerate(lens):
        panel[:, i, :L] = rng.integers(0, 20, (2, L))
    t_aa, t_ss = (torch.from_numpy(np.ascontiguousarray(x.T)).to(dev)
                  for x in panel)
    offs = np.concatenate([[0], np.cumsum(lens)])
    res_aa, res_ss = (torch.from_numpy(np.concatenate(
        [x[i, :L] for i, L in enumerate(lens)])).to(dev) for x in panel)
    cases = []

    def seq(L):
        return rng.integers(0, 20, L).astype(np.int8)

    def gapless(label, profs, caps, t_T):
        args = [torch.from_numpy(a).to(dev)
                for a in tg.pack_profiles_batch(profs, caps)] + [t_T]
        q_lens = [p.shape[1] for p in profs]
        packed = tg.can_pack(min(caps), max(caps),
                             int(min(p.min() for p in profs)),
                             int(max(p.max() for p in profs)),
                             max(q_lens), t_T.shape[0])
        plan = tg.plan_gapless_launch(q_lens, t_T.shape[1], t_T.shape[0],
                                      packed)
        cases.append(dict(
            label=f"gapless {label} ({'packed' if packed else '32-bit'}, "
                  f"strips {[tg.strip_rows(L, packed) for L in q_lens]}, "
                  f"{plan['passes']} passes)",
            max_abs_err=max_abs_err([tg.gapless_scores_batch(*args)],
                                    [tg.gapless_scores_batch_torch(*args)])))

    def prefilter_profiles(q_lens, uncapped=()):
        profs, caps = [], []
        for k, L in enumerate(q_lens):
            p, b = make_query_profile(seq(L))
            profs.append(p)
            caps.append(tg.NO_CAP if k in uncapped else BYTE_CAP - b)
        return profs, caps

    for L in sorted({r + d for r in tg.PACKED_ROWS for d in (-1, 0, 1)}
                    | {385}):
        gapless(f"query of {L} rows, capped", *prefilter_profiles([L]), t_ss)
    # no cap, short diagonals: still provably inside 16 bits
    gapless("query of 150 rows, no cap",
            *prefilter_profiles([150], uncapped=(0,)), t_ss)
    gapless("stack of 150, 40, 20 and 200 rows, one cap missing",
            *prefilter_profiles([150, 40, 20, 200], uncapped=(1,)), t_ss)
    # no cap, entries up to 127, a 300-row query on 384-long targets: a
    # diagonal can pass 16 bits, so the 32-bit kernel runs (32-row strips)
    long_lens = rng.integers(1, 385, 512)
    long_lens[0], long_lens[1] = 1, 384
    long_panel = np.full((512, 384), tg.PAD_LETTER, dtype=np.int8)
    for i, L in enumerate(long_lens):
        long_panel[i, :L] = rng.integers(0, 20, L)
    t_long = torch.from_numpy(np.ascontiguousarray(long_panel.T)).to(dev)
    wide = sorted({r + d for r in tg.WIDE_ROWS for d in (-1, 0, 1)} | {300})
    wide_profs = [rng.integers(-128, 128, (21, L)).astype(np.float32)
                  for L in wide]
    wide_profs[-1][:, ::2] = 127
    gapless(f"stack of {wide} rows, no cap, entries up to 127", wide_profs,
            [tg.NO_CAP] * len(wide), t_long)
    for L in (95, 96, 97, 200):
        prof = QueryProfile(seq(L), seq(L))
        aa, q_off, _ = tg.pack_profiles_batch([prof.prof_aa], [0])
        ss, _, _ = tg.pack_profiles_batch([prof.prof_ss], [0])
        args = [torch.from_numpy(a).to(dev) for a in (aa, ss, q_off)] \
            + [t_aa, t_ss]
        cases.append(dict(
            label=f"gapless_dual query of {L} rows",
            max_abs_err=max_abs_err([tg.gapless_scores_dual(*args)],
                                    [tg.gapless_scores_dual_torch(*args)])))

    def sw(label, q_lens, pairs=200):
        profs = [QueryProfile(seq(L), seq(L)) for L in q_lens]
        slots = [p for q in profs for p in (q, q.reversed())]
        paa, pss, slot_off = tk.pack_sw_slots([p.prof_aa for p in slots],
                                              [p.prof_ss for p in slots])
        tids = np.concatenate([np.concatenate([[0, 1], rng.choice(
            n, pairs - 2, replace=False)]) for _ in slots])
        args = (torch.from_numpy(paa).to(dev), torch.from_numpy(pss).to(dev),
                slot_off, np.arange(len(slots) + 1) * pairs, res_aa, res_ss,
                offs[tids], lens[tids])
        slot_lens = np.diff(slot_off).tolist()
        plan = tk.plan_sw_launch(slot_lens, [pairs] * len(slots), lt)
        cases.append(dict(
            label=f"sw {label} (lane groups "
                  f"{sorted({tk.sw_lane_group(L) for L in slot_lens})}, "
                  f"{plan['passes']} passes)",
            max_abs_err=max_abs_err(tk.sw_scores_pairs(*args),
                                    tk.sw_scores_pairs_torch(*args))))

    edges = {tallest for tallest, _ in tk.SW_GROUPS} | {384, 576}
    for L in sorted({e + d for e in edges for d in (-1, 0, 1)} | {1}):
        sw(f"slots of {L} rows", [L])
    sw("slots of 20 and 1,500 rows", [20, 1500])
    torch.cuda.synchronize()
    bad = [c["label"] for c in cases if c["max_abs_err"]]
    log(f"boundaries: {len(cases)} shapes, {len(bad)} disagree"
        + "".join(f"\n  {c['label']}: max_abs_err={c['max_abs_err']}"
                  for c in cases))
    report["boundaries"] = cases
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version at: {bad}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--targets", type=int, default=100_000)
    ap.add_argument("--queries", type=int, default=16)
    ap.add_argument("--parity-targets", type=int, default=2000)
    ap.add_argument("--out-dir", default=os.path.join(REPO, "foldseek_tpu_torch",
                                                     "build", "smoke"))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from foldseek_tpu_torch.db.panels import resident_panels
    from foldseek_tpu_torch.device import get_device
    from foldseek_tpu_torch.ops import _build
    from foldseek_tpu_torch.search.align import native_ready

    dev = get_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = Card(dev)
    log(f"card: {smi}; {card.sms} SMs, max SM clock {card.sm_mhz:.0f} MHz")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(dev)}")
    report = dict(card=smi, sms=card.sms, sm_mhz=card.sm_mhz, gapless=[],
                  sw=[], gapless_single=[], gapless_dual=[], sw_batch=[],
                  sw_mode3=[])
    os.makedirs(args.out_dir, exist_ok=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:   # one compiler per source, together
        native = pool.submit(native_ready)
        built = {name: pool.submit(_build.load, name)
                 for name in ("gapless", "sw")}
        report["ptxas"] = {}
        for name, fut in built.items():
            b = fut.result()
            log(f"built csrc/{name}.cu in {b.seconds:.1f} s -> {b.path}")
            report[f"build_{name}_seconds"] = b.seconds
            with open(os.path.join(args.out_dir, f"nvcc_{name}.log"), "w") as f:
                f.write(b.log)
            instances = report["ptxas"][name] = ptxas_instances(b.log)
            for inst in instances:
                log(f"  ptxas {inst['kernel']}: {inst['registers']} registers, "
                    f"{inst['smem']} B shared, spills "
                    f"{inst['spill_stores']}/{inst['spill_loads']} B")
            if not b.log:
                log(f"  csrc/{name}.cu was built before this run: no ptxas "
                    "output")
            elif not instances or any(
                    i["spill_stores"] or i["spill_loads"] for i in instances):
                raise AssertionError(f"csrc/{name}.cu: ptxas reports spills, "
                                     "or no instance was found in its log")
        if not native.result():
            raise AssertionError("native host library did not build or load")
    report["build_seconds"] = time.perf_counter() - t0
    log(f"kernels and native host library ready in "
        f"{report['build_seconds']:.1f} s")

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as work:
        base, tdb, qdb, pdb = build_dbs(work, args.targets, args.queries,
                                        args.parity_targets)
        pieces = panel_pieces(tdb, dev)
        panels = resident_panels(tdb, dev)
        g = phase_gapless(card, dev, tdb, qdb, pieces, report)
        s = phase_sw(card, dev, tdb, qdb, panels, report)
        d, shape_launches = phase_call_shapes(card, dev, tdb, qdb, pieces,
                                              panels, report)
        del pieces
        # mode 1 as the card runs it by default, then with the gates forced
        # to the other side
        mode1, res_a = phase_e2e(dev, tdb, qdb, 1, report)
        fleets_by_default = report["e2e_mode1"]["warm"]["gate_fleets"] > 0
        _, res_b = phase_e2e(
            dev, tdb, qdb, 1, report,
            name="e2e_mode1_" + ("host" if fleets_by_default else "device")
                 + "_gates", gates="0" if fleets_by_default else "1")
        res_dev, res_host = (res_a, res_b) if fleets_by_default \
            else (res_b, res_a)
        del res_a, res_b
        host_m8 = m8_bytes(qdb, tdb, res_host)
        phase_gate_turns(dev, tdb, qdb, report)
        report["e2e_mode1_gates_vs_host"] = compare_gates(
            res_host, res_dev, f"e2e mode 1, {tdb.size} targets: device "
                               "gates vs host gates")
        phase_gates(dev, tdb, qdb, res_host, report)
        del res_dev
        pssm_g, pssm_s = phase_pssm(card, dev, tdb, qdb, res_host,
                                    resident_panels(tdb, dev), report)
        del res_host
        paths = phase_e2e_paths(dev, tdb, qdb, report)
        mode3, _ = phase_e2e(dev, tdb, qdb, 3, report)
        s3 = phase_mode3_kernel(card, dev, tdb, qdb,
                                resident_panels(tdb, dev), report)
        paths.update(phase_verbs_server(dev, tdb, qdb, work, host_m8, report))
        phase_parity(dev, base, pdb, qdb, work, report)
        clu_db, clusters, paths["cluster"] = phase_cluster(
            dev, base, work, CLUSTER_ENTRIES, report)
        paths["rbh"] = phase_rbh(dev, clu_db, qdb, work, report)
        paths["clusearch"] = phase_clusearch(dev, clu_db, clusters, qdb, work,
                                             report)
        del clu_db, clusters
        paths["multimer"] = phase_multimer(dev, tdb, qdb, work, report)
        paths.update(phase_prostt5(dev, tdb, qdb, pdb, work, report))
        phase_boundaries(dev, report)
    loaded = sorted(k for k in sys.modules if k in ("jax", "foldseek_tpu")
                    or k.startswith(("jax.", "foldseek_tpu.")))
    if loaded:
        raise AssertionError(f"the port's paths imported {loaded}")

    def launches(name):
        by_path = dict(mode1=mode1[name], mode3=mode3[name],
                       call_shapes=shape_launches[name],
                       **{p: counts[name] for p, counts in paths.items()})
        return dict(launches=sum(by_path.values()), launches_by_path=by_path)

    pallas = "foldseek_tpu/ops/gapless_pallas.py"
    kernels = [
        dict(name="gapless", route="cuda",
             source="foldseek_tpu_torch/csrc/gapless.cu",
             replaces=f"{pallas}:200",
             also_replaces=[f"{pallas}:277", f"{pallas}:389"],
             **launches("gapless"), **g, pssm=pssm_g),
        dict(name="gapless_dual", route="cuda",
             source="foldseek_tpu_torch/csrc/gapless.cu",
             replaces=f"{pallas}:412", **launches("gapless_dual"), **d),
        dict(name="sw", route="cuda", source="foldseek_tpu_torch/csrc/sw.cu",
             replaces="foldseek_tpu/ops/sw_pallas.py:336",
             also_replaces=["foldseek_tpu/ops/sw_pallas.py:125",
                            "foldseek_tpu/ops/sw_pallas.py:271"],
             **launches("sw"), **s, mode3=s3, pssm=pssm_s),
    ]
    report["kernels"] = kernels
    with open(os.path.join(args.out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"gates": report["gates"]}))
    print(json.dumps({"prostt5": report["prostt5"]}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
