"""Batched TM-score of fixed alignments on the device, in plain PyTorch.

Counterpart of `foldseek_tpu/ops/tm_device.py` (an XLA program there, not a
Pallas kernel): the device-side re-expression of ops/tmscore.py (reference:
src/commons/TMaligner.cpp:50-104, lib/tmalign/TMalign.cpp:394-547
TMscore8_search_standard, :76-143 score_fun8), the same fragment-seeded
iterative superposition search with every data-dependent construct made
fixed-shape so that one program scores a whole fleet of hits:

- superposition: Horn's quaternion method (largest eigenvector of the 4x4
  key matrix) instead of 3x3 SVD Kabsch, the identical proper rotation;
- all fragment slots of a pair run as one batched axis and the pairs as a
  leading axis ([P, S, M] masks, [P, S, 3, 3] rotations); the only
  sequential axis is the refinement;
- the score_fun8 d-growth loop ("grow d by 0.5 until >= 3 points") in
  closed form from the 3rd-smallest pair distance;
- the <= 20 refinement iterations: once a cut set reaches its fixed point
  every further iteration reproduces the same superposition and score, so
  running on never changes the maximum. `check_every` says how often the
  chunk is asked whether any cut set still changed (one synchronisation
  each time); 0 runs all 20 without asking.

What differs from the XLA program, and why the outputs are the same:

- eager PyTorch materialises every temporary that XLA fused, so the masked
  sums of Horn's method are one batched product of the [P, S, M] masks with
  17 per-column features (x, y, the nine x_a * y_b, |x|^2 + |y|^2, 1)
  instead of [P, S, M, 3] centred copies; each pair's coordinates are
  centred on the centroid of its aligned columns first, which keeps the
  subtraction of the means (sum w x y^T - n xb yb^T) from cancelling and
  changes neither rotation nor distance;
- the slot grid drops duplicates: level li of the fragment lengths can have
  at most ceil((M - (M >> li)) / 40) + 1 distinct starts, so it gets that
  many slots and not the (M - 1) // 40 + 2 of the deepest level. The
  maximum runs over the same set of (length, start) fragments.

float32 on the device against float64 on the host path: TM values agree to
about 1e-6 relative when the search path is stable; borderline cut sets can
diverge to about 1e-3. The host native path stays the parity reference.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

SIMPLIFY_STEP = 40
REFINE_ITERS = 20
N_LEVELS = 6
# bytes one [chunk, S, M] float32 temporary of the search may take; about
# ten of them are alive at the peak of an iteration
TM_TEMP_BYTES = 1 << 28


# rows (or columns) of a 4x4 matrix left when one is struck out
_MINOR_OF = ((1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2))


@functools.lru_cache(maxsize=None)
def _constants(device: torch.device, dtype: torch.dtype) -> dict:
    """Small constant tensors of the eigen-solver on `device`."""
    keep = torch.tensor(_MINOR_OF, device=device)
    sign = torch.tensor([[(-1.0) ** (i + j) for j in range(4)]
                         for i in range(4)], device=device, dtype=dtype)
    # Horn's key matrix as a linear map of the 3x3 covariance (row-major)
    xx, xy, xz, yx, yy, yz, zx, zy, zz = range(9)
    entries = [
        [(xx, 1), (yy, 1), (zz, 1)], [(yz, 1), (zy, -1)],
        [(zx, 1), (xz, -1)], [(xy, 1), (yx, -1)],
        [(yz, 1), (zy, -1)], [(xx, 1), (yy, -1), (zz, -1)],
        [(xy, 1), (yx, 1)], [(zx, 1), (xz, 1)],
        [(zx, 1), (xz, -1)], [(xy, 1), (yx, 1)],
        [(yy, 1), (xx, -1), (zz, -1)], [(yz, 1), (zy, 1)],
        [(xy, 1), (yx, -1)], [(zx, 1), (xz, 1)],
        [(yz, 1), (zy, 1)], [(zz, 1), (xx, -1), (yy, -1)]]
    key = torch.zeros(9, 16, device=device, dtype=dtype)
    for col, terms in enumerate(entries):
        for row, coeff in terms:
            key[row, col] = coeff
    # the rotation as a linear map of the quaternion's outer product
    # (row-major w, x, y, z) plus the identity
    _, wx, wy, wz, _, qxx, qxy, qxz, _, _, qyy, qyz, _, _, _, qzz = range(16)
    rot_entries = [
        [(qyy, -2), (qzz, -2)], [(qxy, 2), (wz, -2)], [(qxz, 2), (wy, 2)],
        [(qxy, 2), (wz, 2)], [(qxx, -2), (qzz, -2)], [(qyz, 2), (wx, -2)],
        [(qxz, 2), (wy, -2)], [(qyz, 2), (wx, 2)], [(qxx, -2), (qyy, -2)]]
    rot = torch.zeros(16, 9, device=device, dtype=dtype)
    for col, terms in enumerate(rot_entries):
        for row, coeff in terms:
            rot[row, col] = coeff
    return dict(
        rows=keep[:, None, :, None], cols=keep[None, :, None, :], sign=sign,
        key=key, rot=rot,
        eye3=torch.eye(3, device=device, dtype=dtype).reshape(9),
        eye4=torch.eye(4, device=device, dtype=dtype),
        ident=torch.tensor([1.0, 0.0, 0.0, 0.0], device=device, dtype=dtype))


def _cofactors4(A: torch.Tensor) -> torch.Tensor:
    """Cofactor matrix C of batched 4x4 A (adj(A) = C^T): the sixteen 3x3
    minors are gathered at once and their determinants taken with a dozen
    elementwise operations over [..., 4, 4] (each launch is a fixed cost,
    and there are many small ones in an iteration)."""
    k = _constants(A.device, A.dtype)
    m = A[..., k["rows"], k["cols"]]                     # [..., 4, 4, 3, 3]

    def e(a, b):
        return m[..., a, b]
    det3 = (e(0, 0) * (e(1, 1) * e(2, 2) - e(1, 2) * e(2, 1))
            - e(0, 1) * (e(1, 0) * e(2, 2) - e(1, 2) * e(2, 0))
            + e(0, 2) * (e(1, 0) * e(2, 1) - e(1, 1) * e(2, 0)))
    return det3 * k["sign"]


def _max_eigvec4(N: torch.Tensor, lam0: torch.Tensor, iters: int = 12):
    """Largest eigenvalue and eigenvector of batched symmetric traceless 4x4
    N by Newton on the characteristic quartic from lam0 >= lambda_max and
    the adjugate null-space trick (Theobald 2005, QCP).

    N is normalised by lam0 before the quartic: raw entries scale with
    sum |x|^2, so p(lam) ~ lam^4 would cancel in float32 near the root and
    stall Newton; normalised, all coefficients are O(1)."""
    s = lam0.clamp_min(1e-30)
    N = N / s[..., None, None]
    N2 = N @ N
    N3 = N2 @ N

    def tr(a):
        return a[..., 0, 0] + a[..., 1, 1] + a[..., 2, 2] + a[..., 3, 3]
    c2 = -0.5 * tr(N2)
    c1 = -tr(N3) / 3.0
    Ccof = _cofactors4(N)
    c0 = (N[..., 0, 0] * Ccof[..., 0, 0] + N[..., 0, 1] * Ccof[..., 0, 1]
          + N[..., 0, 2] * Ccof[..., 0, 2] + N[..., 0, 3] * Ccof[..., 0, 3])

    k = _constants(N.device, N.dtype)
    lam = torch.ones_like(lam0)
    tiny = torch.full_like(lam0, 1e-12)
    c2x2 = 2.0 * c2
    for _ in range(iters):
        p = ((lam * lam + c2) * lam + c1) * lam + c0
        dp = (4.0 * lam * lam + c2x2) * lam + c1
        lam = lam - p / torch.where(dp.abs() > 1e-12, dp,
                                    torch.where(dp >= 0, tiny, -tiny))

    A = N - lam[..., None, None] * k["eye4"]
    Ca = _cofactors4(A)            # rows of Ca = columns of adj(A), all ∝ v
    norms = (Ca * Ca).sum(-1)      # [..., 4] squared norm of each candidate
    best = norms.argmax(-1)        # ties: the first index
    v = torch.take_along_dim(
        Ca, best[..., None, None].expand(*best.shape, 1, 4), -2)[..., 0, :]
    nrm = (v * v).sum(-1, keepdim=True).sqrt()
    # degenerate (eigenvalue multiplicity): the adjugate vanishes -> identity
    v = torch.where(nrm > 1e-6, v / nrm.clamp_min(1e-30), k["ident"])
    return lam * s, v


def _column_features(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[P, M, 17] per-column features whose masked sums give Horn's method
    all it needs: x, y, the nine x_a * y_b, |x|^2 + |y|^2, 1."""
    P, M, _ = x.shape
    return torch.cat([
        x, y, (x[:, :, :, None] * y[:, :, None, :]).reshape(P, M, 9),
        (x * x + y * y).sum(-1, keepdim=True), torch.ones_like(x[:, :, :1])],
        -1)


def _horn_from_sums(sums: torch.Tensor):
    """Rotations and translations from the masked feature sums [..., 17]."""
    n = sums[..., 16].clamp_min(1.0)[..., None]           # [..., 1]
    sx, sy = sums[..., 0:3], sums[..., 3:6]
    xb, yb = sx / n, sy / n
    k = _constants(sums.device, sums.dtype)
    lead = sums.shape[:-1]
    S = sums[..., 6:15] - (sx[..., :, None] * yb[..., None, :]).reshape(
        *lead, 9)
    # the key matrix: sums and differences of at most three entries of S
    # (sxx + syy + szz, syz - szy, ...), as one product with a 0/+-1 matrix
    N = (S @ k["key"]).reshape(*lead, 4, 4)
    # lambda_max upper bound: (G1 + G2) / 2 (Theobald's E0)
    lam0 = 0.5 * (sums[..., 15]
                  - ((sx * xb).sum(-1) + (sy * yb).sum(-1)))
    _, q = _max_eigvec4(N, lam0)
    # R = I + the usual +-2 q_a q_b terms (1 - 2 (qy^2 + qz^2), 2 (qx qy -
    # qw qz), ...), as one product of the outer product with a 0/+-2 matrix
    qq = (q[..., :, None] * q[..., None, :]).reshape(*lead, 16)
    R = (qq @ k["rot"] + k["eye3"]).reshape(*lead, 3, 3)
    t = yb - (R @ xb[..., None])[..., 0]
    return R, t


def _horn_masked_batch(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor):
    """Optimal proper rotations for S weighted subsets of each pair's point
    set: x, y [P, M, 3], w [P, S, M] 0/1 weights -> R [P, S, 3, 3],
    t [P, S, 3] with y ~ R x + t per subset (Horn 1987 via the 4x4 key
    matrix). The caller centres x and y for accuracy; the result does not
    depend on it."""
    return _horn_from_sums(torch.bmm(w, _column_features(x, y)))


@functools.lru_cache(maxsize=None)
def fragment_slots(m_pad: int):
    """(level, start index) int64 arrays of the fragment slots of one
    parameterisation for alignments of at most m_pad columns. Level li seeds
    fragments of length max(l >> li, l_min) (l_min for the last level) at
    starts min(40 * sj, l - length); with l <= m_pad these take at most
    ceil((m_pad - (m_pad >> li)) / 40) + 1 distinct values, the last being the
    clamped one."""
    li, sj = [], []
    for level in range(N_LEVELS):
        il_max = (m_pad - (m_pad >> level) if level < N_LEVELS - 1
                  else max(m_pad - 4, 0))
        count = -(-il_max // SIMPLIFY_STEP) + 1
        li += [level] * count
        sj += list(range(count))
    return np.asarray(li, np.int64), np.asarray(sj, np.int64)


def _tm_search(x, y, l_ali, d0_pair, d0_search_pair, score_d8,
               check_every: int):
    """Every pair, both parameterisations (standard + search,
    compute_tm_score :177-185) as the two halves of one slot axis.
    x, y: [P, M, 3] padded aligned target / query coords; l_ali int [P];
    d0_pair, d0_search_pair: [P, 2]; score_d8 [P]. Returns [P, 2] best
    score sums (not yet normalised)."""
    P, M, _ = x.shape
    dt, dev = x.dtype, x.device
    idx = torch.arange(M, device=dev)
    valid = idx[None, :] < l_ali[:, None]                       # [P, M]
    n_val = l_ali.clamp_min(1).to(dt)[:, None]
    x = x - (x * valid[..., None]).sum(1, keepdim=True) / n_val[..., None]
    y = y - (y * valid[..., None]).sum(1, keepdim=True) / n_val[..., None]
    feats = _column_features(x, y)
    xT = x.transpose(1, 2).contiguous()                         # [P, 3, M]
    yT = y.transpose(1, 2).contiguous()
    invalid = ~valid[:, None, :]

    li_np, sj_np = fragment_slots(M)
    n_half = len(li_np)
    S = 2 * n_half
    li = torch.from_numpy(np.tile(li_np, 2)).to(dev)            # [S]
    sj = torch.from_numpy(np.tile(sj_np, 2)).to(dev)
    half = torch.arange(S, device=dev) // n_half
    d0 = d0_pair[:, half]                                       # [P, S]
    d0_search = d0_search_pair[:, half]
    d0_2 = (d0 * d0)[..., None]
    d8_2 = (score_d8 * score_d8)[:, None, None]
    grow_ok = (l_ali > 3)[:, None]
    inf = torch.tensor(float("inf"), dtype=dt, device=dev)

    def score_and_cut(R, t, d):
        # R [P, S, 3, 3], t [P, S, 3], d [P, S] -> scores [P, S], cuts [P, S, M]
        xt = torch.bmm(R.reshape(P, S * 3, 3), xT).view(P, S, 3, M)
        xt.add_(t[..., None]).sub_(yT[:, None])
        di = xt.square_().sum(2)                                # [P, S, M]
        di.masked_fill_(invalid, float("inf"))
        sc = torch.where(di < d8_2, 1.0 / (1.0 + di / d0_2), 0.0).sum(-1)
        cnt = (di < (d * d)[..., None]).sum(-1)
        need_grow = (cnt < 3) & grow_ok
        # 3rd smallest by three masked minima: exact ties are skipped, as
        # in the XLA program (kthvalue / topk would count them)
        m1 = di.amin(-1, keepdim=True)
        d_2 = torch.where(di <= m1, inf, di)
        m2 = d_2.amin(-1, keepdim=True)
        d3 = torch.where(d_2 <= m2, inf, d_2).amin(-1)
        k = torch.floor((d3.sqrt() - d) / 0.5) + 1.0
        d_use = torch.where(need_grow, d + 0.5 * k, d)
        cut = (di < (d_use * d_use)[..., None]).to(dt)          # pad: inf
        return sc, cut

    # fragment masks (duplicates clamp to fragments that are evaluated anyway)
    l_min = l_ali.clamp_max(4)[:, None]                         # [P, 1]
    l_frag = torch.where(li[None, :] >= N_LEVELS - 1, l_min,
                         torch.maximum(l_ali[:, None] >> li[None, :], l_min))
    start = torch.minimum(SIMPLIFY_STEP * sj[None, :], l_ali[:, None] - l_frag)
    frag = ((idx >= start[..., None])
            & (idx < (start + l_frag)[..., None])).to(dt)       # [P, S, M]

    R, t = _horn_from_sums(torch.bmm(frag, feats))
    sc, cut = score_and_cut(R, t, d0_search - 1.0)
    best = sc.view(P, 2, n_half).amax(-1)
    for i in range(REFINE_ITERS):
        R, t = _horn_from_sums(torch.bmm(cut, feats))
        sc, new_cut = score_and_cut(R, t, d0_search + 1.0)
        best = torch.maximum(best, sc.view(P, 2, n_half).amax(-1))
        done = (check_every > 0 and (i + 1) % check_every == 0
                and not bool((new_cut != cut).any()))
        cut = new_cut
        if done:
            break
    return best


def tm_chunk_for(m_pad: int) -> int:
    """Power-of-two number of pairs a chunk of the search holds, bounding each
    [chunk, S, m_pad] float32 temporary to TM_TEMP_BYTES."""
    S = 2 * len(fragment_slots(m_pad)[0])
    c = TM_TEMP_BYTES // (4 * S * m_pad)
    return 1 << max(3, min(13, c.bit_length() - 1))


def tm_chunk(x, y, l_ali, scal, check_every: int) -> torch.Tensor:
    """TM of one chunk normalised by l_ali: max(standard pass with d0_std,
    search pass with d0 / d0_search) (compute_tm_score :177-185). scal
    [4, P]: d0, d0_search, score_d8, d0_std of `_params_for`."""
    d0, d0s, sd8, d0std = scal[0], scal[1], scal[2], scal[3]
    best = _tm_search(x, y, l_ali, torch.stack([d0std, d0], -1),
                      torch.stack([d0std, d0s], -1), sd8, check_every)
    return best.amax(-1) / l_ali.clamp_min(1).to(x.dtype)


def _params_for(norm_len: np.ndarray):
    """Vectorized parameter_set4search + the standard-TMscore d0
    (ops/tmscore.py compute_tm_score :169-183)."""
    lnorm = np.maximum(np.asarray(norm_len, dtype=np.float64), 1.0)
    d0 = np.where(lnorm <= 19, 0.168,
                  1.24 * np.cbrt(np.maximum(lnorm - 15.0, 1e-9)) - 1.8)
    d0 = d0 + 0.8  # d0_min
    d0_search = np.clip(d0, 4.5, 8.0)
    score_d8 = 1.5 * lnorm ** 0.3 + 3.5
    d0_std = np.where(lnorm > 21,
                      1.24 * np.cbrt(np.maximum(lnorm - 15.0, 1e-9)) - 1.8, 0.5)
    d0_std = np.maximum(d0_std, 0.5)
    return (d0.astype(np.float32), d0_search.astype(np.float32),
            score_d8.astype(np.float32), d0_std.astype(np.float32))


def default_check_every(device: torch.device) -> int:
    """How often the refinement asks whether it converged: every iteration on
    the CPU, where asking costs nothing; every fourth on a card, where each
    question is a synchronisation. Running all 20 without asking keeps the
    dispatch asynchronous, but the fleet's many small launches hold the host
    about as long as the card anyway, and stopping at convergence saves both
    (NVIDIA H100 80GB HBM3, 700.00 W, 16,000 hits: 0.42-0.83 s asking every
    fourth iteration, 0.70-1.16 s running all 20, in the same calls;
    chip_smoke.py)."""
    return 1 if torch.device(device).type == "cpu" else 4


def batched_tm_device(xa: np.ndarray, ya: np.ndarray, m_len: np.ndarray,
                      norm_len: np.ndarray, device: torch.device,
                      chunk: int = 0, check_every: int = -1) -> np.ndarray:
    """TM-scores for a fleet of fixed alignments.

    xa / ya: [P, M_pad, 3] padded aligned target / query C-alpha coords
    (x superposed onto y, the TMaligner x = target convention), m_len: [P]
    aligned column counts, norm_len: [P] normalization lengths.
    Returns tm [P] float32."""
    device = torch.device(device)
    P, M, _ = xa.shape
    chunk = chunk or tm_chunk_for(M)
    if check_every < 0:
        check_every = default_check_every(device)
    scal = torch.from_numpy(np.stack(_params_for(np.asarray(norm_len)))).to(device)
    m_len = np.asarray(m_len, dtype=np.int32)
    x = torch.from_numpy(np.asarray(xa, np.float32)).to(device)
    y = torch.from_numpy(np.asarray(ya, np.float32)).to(device)
    l_ali = torch.from_numpy(m_len).to(device)
    out = [tm_chunk(x[c: c + chunk], y[c: c + chunk], l_ali[c: c + chunk],
                    scal[:, c: c + chunk], check_every)
           for c in range(0, P, chunk)]
    tm = (torch.cat(out).cpu().numpy() if out
          else np.zeros(0, np.float32))
    # the fragment score is sum / l_ali; the reference reports
    # score * n_al / norm_len (compute_tm_score :179,183)
    return tm * m_len / np.maximum(np.asarray(norm_len, np.float32), 1.0)
