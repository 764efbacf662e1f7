"""Shape adapters for the port's tests: the JAX package's kernel entry points
(padded target panels, stacked slots, one tall query) expressed through the
port's launch points, `gapless_scores_batch`, `gapless_scores_dual` and
`sw_scores_pairs`. The port's search path calls those directly; these
adapters exist so a test can feed both packages the same padded inputs."""
import numpy as np
import torch

from foldseek_tpu_torch.ops import gapless as tg
from foldseek_tpu_torch.ops.gapless import PAD_LETTER, gapless_scores_batch
from foldseek_tpu_torch.ops.sw_kernels import sw_scores_pairs


def prepare_targets_T(seqs, lengths, lt_pad=None, b_pad=None) -> np.ndarray:
    """Pack sequences into a transposed int8 [lt_pad, b_pad] panel with the
    pad letter in unused positions (gapless_pallas.prepare_targets_T)."""
    B = len(seqs)
    max_len = max((int(l) for l in lengths), default=1)
    lt_pad = lt_pad or max_len
    b_pad = b_pad or (-(-B // 128) * 128)
    t = np.full((b_pad, lt_pad), PAD_LETTER, dtype=np.int8)
    for i, seq in enumerate(seqs):
        L = min(int(lengths[i]), lt_pad)
        t[i, :L] = seq[:L]
    return np.ascontiguousarray(t.T)


def gapless_scores_long(prof: torch.Tensor, t_T: torch.Tensor,
                        cap: int) -> torch.Tensor:
    """One query of any length (K2's contract): prof int32 [Lq, 32] from
    `pack_profile`. Returns int32 [B]."""
    dev = t_T.device
    q_off = torch.tensor([0, prof.shape[0]], dtype=torch.int32, device=dev)
    caps = torch.tensor([int(cap)], dtype=torch.int32, device=dev)
    return gapless_scores_batch(prof, q_off, caps, t_T)[0]


def gapless_scores_single(prof: torch.Tensor, t_T: torch.Tensor,
                          cap=None) -> torch.Tensor:
    """One query against one panel with one scalar cap, or none (K5's
    contract): prof int32 [Lq, 32] from `pack_profile`, t_T int8 [Lt, B].
    Returns int32 [B]."""
    return gapless_scores_long(prof, t_T, tg.NO_CAP if cap is None else cap)


def gapless_scores_dual(prof_aa: torch.Tensor, prof_ss: torch.Tensor,
                        t_aa_T: torch.Tensor,
                        t_ss_T: torch.Tensor) -> torch.Tensor:
    """One query's AA and 3Di profiles (int32 [Lq, 32] each) against the two
    panels of the same targets (K6's contract). Returns int32 [B]."""
    q_off = torch.tensor([0, prof_aa.shape[0]], dtype=torch.int32,
                         device=t_aa_T.device)
    return tg.gapless_scores_dual(prof_aa, prof_ss, q_off, t_aa_T, t_ss_T)[0]


def sw_scores_batch(prof_aa, prof_ss, slot_off, t_aa, t_ss, t_len, q: int,
                    gap_open: int = 10, gap_extend: int = 1):
    """q slots sharing one list of B padded targets (K7's contract): t_aa,
    t_ss int8 [B, Lt], t_len [B]. Returns (score, q_end, t_end) int32
    [q, B]."""
    return sw_scores_batch_multi(prof_aa, prof_ss, slot_off, t_aa[None],
                                 t_ss[None], torch.as_tensor(t_len)[None], 1,
                                 q, gap_open, gap_extend)


def sw_scores_batch_multi(prof_aa, prof_ss, slot_off, t_aa, t_ss, t_len,
                          n_stacks: int, q: int, gap_open: int = 10,
                          gap_extend: int = 1):
    """`n_stacks` stacks of q slots, each stack against its own B padded
    targets: t_aa, t_ss int8 [n_stacks, B, Lt], t_len [n_stacks, B].
    Returns (score, q_end, t_end) int32 [n_stacks * q, B]."""
    S, B, Lt = t_aa.shape
    if S != n_stacks or torch.as_tensor(slot_off).numel() != n_stacks * q + 1:
        raise ValueError("expected n_stacks * q slots and n_stacks panels")
    stack_of_slot = torch.arange(n_stacks * q) // q
    toff = ((stack_of_slot[:, None] * B + torch.arange(B)) * Lt).reshape(-1)
    tlen = torch.as_tensor(t_len).to("cpu", torch.long)[stack_of_slot]
    pair_start = torch.arange(n_stacks * q + 1) * B
    out = sw_scores_pairs(prof_aa, prof_ss, slot_off, pair_start,
                          t_aa.reshape(-1), t_ss.reshape(-1), toff,
                          tlen.reshape(-1), gap_open, gap_extend)
    return tuple(x.reshape(n_stacks * q, B) for x in out)


def sw_scores_query(prof_aa, prof_ss, t_aa, t_ss, t_len, gap_open: int = 10,
                    gap_extend: int = 1):
    """One [21, Lq] profile against B padded targets (int8 [B, Lt]).
    Returns (score, q_end, t_end) int32 [B]. The profile may be a
    QueryProfile table as it is (column-major); it is made contiguous."""
    slot_off = torch.tensor([0, prof_aa.shape[1]])
    out = sw_scores_batch_multi(prof_aa.contiguous(), prof_ss.contiguous(),
                                slot_off, t_aa[None], t_ss[None],
                                torch.as_tensor(t_len)[None], 1, 1,
                                gap_open, gap_extend)
    return tuple(x[0] for x in out)


def torch_fleet_from_jax(jfleet):
    """The port's GateFleet holding the same gather indices as a filled
    `foldseek_tpu.ops.gates_device.GateFleet` (whose arrays are padded to a
    power of two of pairs; the port's hold the real pairs only)."""
    from foldseek_tpu_torch.ops.gates_device import GateFleet
    fleet = GateFleet(jfleet.m_pad, jfleet.n, jfleet.need_tm,
                      jfleet.need_lddt)
    for name in ("qabs", "tabs", "m_len", "norm"):
        getattr(fleet, name)[...] = getattr(jfleet, name)[:jfleet.n]
    return fleet


def fixture_inputs(golden_dir):
    """The structure files the repository carries: 16 superposed globin PDBs
    and one Foldcomp entry."""
    return ([str(p) for p in sorted((golden_dir / "msa" / "sup").glob("*.pdb"))]
            + [str(golden_dir / "d1asha.fcz")])


def make_fixture_dbs(golden_dir, out_dir, n_targets: int, n_queries: int):
    """The 17-entry fixture DB expanded by db/synth.py to `n_targets` targets
    (seed 1) and `n_queries` queries (seed 4), loaded by each package's own
    `load_db`: ((jax targets, jax queries), (port targets, port queries)).
    n_targets 0 keeps the 17 entries themselves as the targets."""
    from foldseek_tpu.db import storage as jstorage
    from foldseek_tpu.db.synth import synth_db
    from foldseek_tpu.ingest.createdb import create_db
    from foldseek_tpu_torch import db as tdbmod
    base = create_db(fixture_inputs(golden_dir), str(out_dir / "base"))
    tdir = str(out_dir / "base")
    if n_targets:
        tdir = str(out_dir / f"t{n_targets}")
        synth_db(base, n_targets, tdir, seed=1)
    qdir = str(out_dir / f"q{n_queries}")
    synth_db(base, n_queries, qdir, seed=4)
    return ((jstorage.load_db(tdir), jstorage.load_db(qdir)),
            (tdbmod.load_db(tdir), tdbmod.load_db(qdir)))


def few_torch_threads():
    """Fixture body: two intra-op threads while a module's tests run. At the
    tests' small shapes more threads gain nothing, and with several test
    workers on one machine they only fight each other for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
