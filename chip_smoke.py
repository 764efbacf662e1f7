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
     gapless and the SW kernel must have launched in the cold run.
  6. end to end, mode 3: the same with prefilter_mode=3 (3Di-only SW of
     every query against the whole DB); the SW kernel must have launched and
     the gapless kernel must not. Then the SW kernel vs its plain version at
     mode-3 shapes, every query against the DB in chunks of 20000 targets,
     and the full-size call's wrapper time (CUDA events, host plan included)
     beside its kernel time (torch.profiler).
  7. parity: on a 2000-target DB the m8 lines on cuda equal those on cpu,
     for mode 1 and mode 3.
The line before the card's line is a JSON object with each kernel's
launches, error, times and bound; the last line is {"ok": true, "device":
{...}}. Details go to DIR/chip_smoke.json and DIR/nvcc_*.log (default
foldseek_tpu_torch/build/smoke/, which git ignores).

The bound of a kernel is the larger of two times: the bytes it must move
(each input read once, each output written once) over the card's memory
rate, and its DP cells over real residues times the integer instructions of
one cell over the card's INT32 rate (SMs x 64 lanes x the maximum SM clock
that nvidia-smi reports).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
INT32_LANES_PER_SM = 64
# integer instructions one DP cell needs at least: gapless viaddmax, min
# (cap), max (best) - the dual kernel trades the min for the add of its two
# profile scores; SW: s = aa + ss, viaddmax_relu(diag, s, E), g = h + i*ge,
# one max of the prefix scan, F = prefix - const, H = max(h, F), E = max(E -
# ge, h - go) (3), the column max
GAPLESS_OPS_PER_CELL = 3
SW_OPS_PER_CELL = 10
MODE3_CHUNK = 20_000           # targets per plain-version comparison
NO_LIBRARY = None              # no single PyTorch call computes these DPs


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

    def bound(self, cells: int, ops_per_cell: int, nbytes: int) -> dict:
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
    version and time both; returns the shape record."""
    import torch

    from foldseek_tpu_torch.ops.gapless import (gapless_scores_batch,
                                                gapless_scores_batch_torch)
    prof, q_off, caps, t_dev = args
    got = gapless_scores_batch(*args)
    want = gapless_scores_batch_torch(*args)
    torch.cuda.synchronize()
    rec = dict(label=label, max_abs_err=max_abs_err([got], [want]),
               ms=cuda_ms(lambda: gapless_scores_batch(*args), reps),
               plain_ms=cuda_ms(lambda: gapless_scores_batch_torch(*args)),
               max_score=int(got.max()),
               **card.bound(int(q_off[-1]) * real_residues,
                            GAPLESS_OPS_PER_CELL,
                            nbytes(prof, q_off, caps, t_dev, got)))
    log(f"gapless {label}: max_abs_err={rec['max_abs_err']} kernel "
        f"{rec['ms']:.3f} ms plain {rec['plain_ms']:.3f} ms bound "
        f"{rec['bound_ms']:.3f} ms ({rec['bound_by']}), "
        f"{rec['cells'] / rec['ms'] / 1e6:.1f} GCUPS over real cells")
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
    return total(records)


def sw_case(card, label, args, report_list, reps=5):
    """Drive the SW kernel once against its plain version and time both."""
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
             + len(tlen) * (8 + 4 + 8 + 3 * 4))
    rec = dict(label=label, pairs=len(tlen),
               max_abs_err=max_abs_err(got, want),
               ms=cuda_ms(lambda: sw_scores_pairs(*args), reps),
               plain_ms=cuda_ms(lambda: sw_scores_pairs_torch(*args)),
               positive=int((got[0] > 0).sum()),
               **card.bound(cells, SW_OPS_PER_CELL, moved))
    log(f"sw {label}: {rec['pairs']} pairs, max_abs_err={rec['max_abs_err']} "
        f"kernel {rec['ms']:.3f} ms plain {rec['plain_ms']:.3f} ms bound "
        f"{rec['bound_ms']:.3f} ms ({rec['bound_by']}), "
        f"{cells / rec['ms'] / 1e6:.1f} GCUPS, pairs with score > 0: "
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
        rec = dict(label=label, max_abs_err=max_abs_err([got], [want]),
                   ms=cuda_ms(lambda: tg.gapless_scores_dual(*args), 5),
                   plain_ms=cuda_ms(
                       lambda: tg.gapless_scores_dual_torch(*args)),
                   max_score=int(got.max()),
                   **card.bound(int(q_off[-1]) * real, GAPLESS_OPS_PER_CELL,
                                nbytes(aa, ss, q_off, t_aa, t_ss, got)))
        log(f"gapless_dual {label}: max_abs_err={rec['max_abs_err']} kernel "
            f"{rec['ms']:.3f} ms plain {rec['plain_ms']:.3f} ms bound "
            f"{rec['bound_ms']:.3f} ms ({rec['bound_by']}), max score "
            f"{rec['max_score']}")
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


def run_search(qdb, tdb, dev, mode: int):
    from foldseek_tpu_torch.search import SearchParams, format_results, search
    params = SearchParams(prefilter_mode=mode, add_backtrace=mode != 3)
    res = search(qdb, tdb, params, dev, same_db=False)
    return res, format_results(qdb, tdb, res, params.format_output,
                               with_backtrace=params.add_backtrace)


def check_lines(lines, qdb):
    """Every query finds hits; the m8 columns parse and are in range."""
    import math
    seen = set()
    for line in lines:
        f = line.split("\t")
        if len(f) != 12:
            raise AssertionError(f"malformed m8 line: {line!r}")
        seen.add(f[0])
        fident, ev = float(f[2]), float(f[10])
        if not (0.0 <= fident <= 1.0 and math.isfinite(ev) and ev >= 0
                and int(f[11]) >= 0 and 1 <= int(f[6]) <= int(f[7])
                and 1 <= int(f[8]) <= int(f[9])):
            raise AssertionError(f"out-of-range m8 line: {line!r}")
    if len(seen) != qdb.size:
        raise AssertionError(f"{qdb.size - len(seen)} queries without hits")


def phase_e2e(dev, tdb, qdb, mode, report):
    """`search` + `format_results` cold (nothing of the DB on the card) then
    warm; returns the launches of the cold run."""
    import torch

    from foldseek_tpu_torch.db.panels import release_resident_panels
    from foldseek_tpu_torch.ops.gapless import (gapless_scores_batch,
                                                gapless_scores_dual)
    from foldseek_tpu_torch.ops.sw_kernels import sw_scores_pairs
    from foldseek_tpu_torch.search import (reset_stage_times,
                                           snapshot_stage_times)

    release_resident_panels()
    out = {}
    for run_name in ("cold", "warm"):
        reset_stage_times()
        torch.cuda.reset_peak_memory_stats(dev)
        gapless_scores_batch.launches = 0
        gapless_scores_dual.launches = 0
        sw_scores_pairs.launches = 0
        t0 = time.perf_counter()
        _res, lines = run_search(qdb, tdb, dev, mode)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(gapless=gapless_scores_batch.launches,
                        gapless_dual=gapless_scores_dual.launches,
                        sw=sw_scores_pairs.launches)
        stages = snapshot_stage_times()
        out[run_name] = dict(
            seconds=seconds, hits=len(lines), launches=launches,
            stages={k: stages.get(k) for k in (
                "prefilter", "ungapped+gapped_prefilter", "sw_scoring",
                "host_loop", "batch_recover") if k in stages},
            max_memory_allocated=torch.cuda.max_memory_allocated(dev))
        log(f"e2e mode {mode} {run_name}: {tdb.size} targets x {qdb.size} "
            f"queries {seconds:.3f} s, {len(lines)} hits, stages "
            f"{out[run_name]['stages']}, max_memory_allocated "
            f"{out[run_name]['max_memory_allocated']} B, launches {launches}")
        check_lines(lines, qdb)
        if run_name == "cold":
            cold_lines = lines
            main_launches = launches
        elif lines != cold_lines:
            raise AssertionError("warm run output differs from the cold run")
    wanted = ("gapless", "sw") if mode == 1 else ("sw",)
    if not all(main_launches[k] for k in wanted) or (
            mode == 3 and main_launches["gapless"]):
        raise AssertionError(f"mode {mode}: wrong kernels launched: "
                             f"{main_launches}")
    report[f"e2e_mode{mode}"] = out
    return main_launches


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
            report["sw_mode3"], reps=2))
    if any(r["max_abs_err"] for r in records):
        raise AssertionError("SW kernel disagrees with its plain version at "
                             "mode-3 shapes")
    whole = sw_args(paa, pss, [np.arange(tdb.size)] * len(pss), panels, dev)
    wrapper_ms = cuda_ms(lambda: sw_scores_pairs(*whole), 3)
    kernel_ms = profiled_kernel_ms(lambda: sw_scores_pairs(*whole),
                                   "sw_kernel")
    torch.cuda.synchronize()
    log(f"sw mode 3 whole DB ({tdb.size * len(pss)} pairs): wrapper "
        f"{wrapper_ms:.3f} ms (CUDA events, host plan included), kernel "
        f"{'not measured' if kernel_ms is None else f'{kernel_ms:.3f} ms'} "
        f"(torch.profiler)")
    report["sw_mode3_whole"] = dict(pairs=tdb.size * len(pss),
                                    wrapper_ms=wrapper_ms,
                                    kernel_ms=kernel_ms)
    return total(records)


def phase_parity(dev, pdb, qdb, report):
    import torch
    for mode in (1, 3):
        _, on_gpu = run_search(qdb, pdb, dev, mode)
        t0 = time.perf_counter()
        _, on_cpu = run_search(qdb, pdb, torch.device("cpu"), mode)
        cpu_s = time.perf_counter() - t0
        same = on_gpu == on_cpu
        log(f"parity mode {mode}, {pdb.size} targets x {qdb.size} queries: "
            f"{len(on_gpu)} m8 lines on cuda, {len(on_cpu)} on cpu "
            f"({cpu_s:.1f} s), byte-identical: {same}")
        report[f"parity_mode{mode}"] = dict(lines=len(on_gpu), identical=same)
        if not same or not on_gpu:
            raise AssertionError(f"mode {mode}: m8 on cuda differs from m8 "
                                 "on cpu")


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
        for name, fut in built.items():
            b = fut.result()
            log(f"built csrc/{name}.cu in {b.seconds:.1f} s -> {b.path}")
            report[f"build_{name}_seconds"] = b.seconds
            with open(os.path.join(args.out_dir, f"nvcc_{name}.log"), "w") as f:
                f.write(b.log)
        if not native.result():
            raise AssertionError("native host library did not build or load")
    report["build_seconds"] = time.perf_counter() - t0
    log(f"kernels and native host library ready in "
        f"{report['build_seconds']:.1f} s")

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as work:
        _base, tdb, qdb, pdb = build_dbs(work, args.targets, args.queries,
                                         args.parity_targets)
        pieces = panel_pieces(tdb, dev)
        panels = resident_panels(tdb, dev)
        g = phase_gapless(card, dev, tdb, qdb, pieces, report)
        s = phase_sw(card, dev, tdb, qdb, panels, report)
        d, shape_launches = phase_call_shapes(card, dev, tdb, qdb, pieces,
                                              panels, report)
        del pieces
        mode1 = phase_e2e(dev, tdb, qdb, 1, report)
        mode3 = phase_e2e(dev, tdb, qdb, 3, report)
        s3 = phase_mode3_kernel(card, dev, tdb, qdb,
                                resident_panels(tdb, dev), report)
        phase_parity(dev, pdb, qdb, report)
    loaded = sorted(k for k in sys.modules if k in ("jax", "foldseek_tpu")
                    or k.startswith(("jax.", "foldseek_tpu.")))
    if loaded:
        raise AssertionError(f"the port's paths imported {loaded}")

    def launches(name):
        by_path = dict(mode1=mode1[name], mode3=mode3[name],
                       call_shapes=shape_launches[name])
        return dict(launches=sum(by_path.values()), launches_by_path=by_path)

    pallas = "foldseek_tpu/ops/gapless_pallas.py"
    kernels = [
        dict(name="gapless", route="cuda",
             source="foldseek_tpu_torch/csrc/gapless.cu",
             replaces=f"{pallas}:200",
             also_replaces=[f"{pallas}:277", f"{pallas}:389"],
             **launches("gapless"), **g),
        dict(name="gapless_dual", route="cuda",
             source="foldseek_tpu_torch/csrc/gapless.cu",
             replaces=f"{pallas}:412", **launches("gapless_dual"), **d),
        dict(name="sw", route="cuda", source="foldseek_tpu_torch/csrc/sw.cu",
             replaces="foldseek_tpu/ops/sw_pallas.py:336",
             also_replaces=["foldseek_tpu/ops/sw_pallas.py:125",
                            "foldseek_tpu/ops/sw_pallas.py:271"],
             **launches("sw"), **s, mode3=s3),
    ]
    report["kernels"] = kernels
    with open(os.path.join(args.out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
