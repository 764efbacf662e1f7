// Ungapped (gapless) diagonal prefilter scores for an NVIDIA Hopper card.
//
// Replaces the Pallas TPU kernels of foldseek_tpu/ops/gapless_pallas.py:
//   K1  _make_kernel_batch / gapless_scores_batch (stacked queries),
//   K2  _make_kernel_long / gapless_scores_long (queries too tall for one
//       VMEM-resident state, run as 2048-row slabs chained through an
//       HBM boundary row),
//   K5  _make_kernel_single / gapless_scores_single (one query, one scalar
//       cap or none: a stack of one, the cap INT_MAX standing for "none"),
//   K6  _make_kernel_dual / gapless_scores_dual (two alphabets, no cap).
// All compute, for every (query, target) pair, the best ungapped diagonal:
// h = min(max(h_diag + s, 0), cap), best = max(best, h). In the single-
// alphabet kernel s = prof[query row][target letter] and the cap is the
// reference's byte saturation (255 - byte bias), applied at every cell. In
// the dual kernel s = prof_aa[row][t_aa] + prof_ss[row][t_ss] over two
// panels of equal shape, and there is no cap.
//
// What bounds it here: DP cell updates. Every cell is one target byte per
// alphabet (neighbouring threads read neighbouring targets of the transposed
// panel, so a warp's load is one 32-byte sector, L1-resident after the first
// diagonal), one profile word per alphabet (the same profile row for the
// whole warp) and three or four integer operations; the panel itself is read
// from device memory about once per query. The TPU version scored cells with
// one-hot matrix products because its vector unit was the bottleneck;
// integer add/max is native here (DPX viaddmax on sm_90).
//
// Design: one thread per (query, target) pair, walking the DP grid one
// diagonal at a time. Diagonals are independent, so the whole state is one
// running value: there is no row limit, and K2's slab chaining becomes the
// same single launch. Queries are a ragged stack (q_off) rather than the
// TPU's padded stack with separator rows. The profile's pad lanes 21..31
// (target pad letter 21) hold a very negative score, which resets h to 0;
// in the dual kernel a pad column adds two of them (-2^25, no overflow).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // targets per block
constexpr int kLanes = 32;     // profile row: letters 0..20, pad lanes 21..31

// kDual = false: prof/t_T with caps. kDual = true: prof/t_T is the AA
// alphabet, prof2/t2_T the 3Di alphabet, caps is not read.
template <bool kDual>
__global__ void __launch_bounds__(kThreads)
gapless_kernel(const int32_t* __restrict__ prof,   // [rows, 32]
               const int32_t* __restrict__ prof2,  // [rows, 32] (dual)
               const int32_t* __restrict__ q_off,  // [nq + 1] row offsets
               const int32_t* __restrict__ caps,   // [nq] (single alphabet)
               const int8_t* __restrict__ t_T,     // [lt, ld] transposed panel
               const int8_t* __restrict__ t2_T,    // [lt, ld2] (dual)
               int lt, int n, long long ld, long long ld2,
               int32_t* __restrict__ out)          // [nq, n]
{
    const int col = blockIdx.x * kThreads + threadIdx.x;
    const int q = blockIdx.y;
    if (col >= n) return;
    const int r0 = q_off[q];
    const int len = q_off[q + 1] - r0;
    const int cap = kDual ? 0 : caps[q];
    const int32_t* p = prof + (long long)r0 * kLanes;
    const int32_t* p2 = kDual ? prof2 + (long long)r0 * kLanes : nullptr;
    const int8_t* t = t_T + col;
    const int8_t* t2 = kDual ? t2_T + col : nullptr;
    int best = 0;
    for (int d = 1 - len; d < lt; ++d) {      // cells (i, i + d)
        const int i0 = d < 0 ? -d : 0;
        const int i1 = min(len, lt - d);
        int h = 0;
        for (int i = i0; i < i1; ++i) {
            const int letter = (uint8_t)t[(long long)(i + d) * ld] & (kLanes - 1);
            int s = __ldg(p + i * kLanes + letter);
            if (kDual) {
                const int letter2 = (uint8_t)t2[(long long)(i + d) * ld2] & (kLanes - 1);
                s += __ldg(p2 + i * kLanes + letter2);
                h = __viaddmax_s32(h, s, 0);
            } else {
                h = min(__viaddmax_s32(h, s, 0), cap);
            }
            best = max(best, h);
        }
    }
    out[(long long)q * n + col] = best;
}

}  // namespace

// Scores nq stacked queries against the n targets of one transposed panel.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int gapless_scores(const int32_t* prof, const int32_t* q_off,
                              const int32_t* caps, int nq,
                              const int8_t* t_T, int lt, int n, long long ld,
                              int32_t* out, void* stream)
{
    if (nq == 0 || n == 0) return 0;
    const dim3 grid((n + kThreads - 1) / kThreads, nq);
    gapless_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        prof, nullptr, q_off, caps, t_T, nullptr, lt, n, ld, 0, out);
    return (int)cudaGetLastError();
}

// Dual-alphabet scores, no cap: nq stacked (prof_aa, prof_ss) queries against
// the n targets of two transposed panels of equal shape.
extern "C" int gapless_scores_dual(const int32_t* prof_aa,
                                   const int32_t* prof_ss,
                                   const int32_t* q_off, int nq,
                                   const int8_t* t_aa_T, const int8_t* t_ss_T,
                                   int lt, int n, long long ld_aa,
                                   long long ld_ss, int32_t* out, void* stream)
{
    if (nq == 0 || n == 0) return 0;
    const dim3 grid((n + kThreads - 1) / kThreads, nq);
    gapless_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        prof_aa, prof_ss, q_off, nullptr, t_aa_T, t_ss_T, lt, n, ld_aa, ld_ss,
        out);
    return (int)cudaGetLastError();
}
