// Dual-alphabet affine Smith-Waterman score and end positions for an NVIDIA
// Hopper card.
//
// Replaces the Pallas TPU kernels of foldseek_tpu/ops/sw_pallas.py:
//   K3  _make_sw_batch_kernel / sw_scores_batch_multi (stacked query slots),
//   K7  the same body through sw_scores_batch (slots sharing one target list),
//   K4  _make_sw_kernel / sw_scores_query (one query),
// and the per-target numpy loop that foldseek_tpu/search/align.py runs on the
// host for queries longer than 2048. Per (slot, target) pair it computes
// exactly foldseek_tpu/ops/sw.py::sw_score_endpos:
//   h_noF[i] = max(H[i-1] (previous column) + s, E[i], 0)
//   F[i]     = max_{k<i}(h_noF[k] + k*ge) - (i-1)*ge - go
//   H[i]     = max(h_noF[i], F[i]);  E[i] = max(E[i] - ge, h_noF[i] - go)
// with s = prof_aa[t_aa][i] + prof_ss[t_ss][i]. The target end is the first
// column that strictly improves the best score, the query end the smallest
// row reaching that column's max. Columns j >= t_len are not scanned.
//
// What bounds it here: integer instructions on DP cells (the score,
// viaddmax_relu for h_noF, h_noF - go, E, F, H and the column max: six and a
// half a cell where a three-way max folds two cells into the column max);
// the bytes are small (two residue bytes a column, profiles in shared
// memory). An earlier version striped the query rows over a warp's lanes
// and had to rebuild F with a cross-lane prefix scan in every column, about
// forty instructions and nineteen shuffles per 32 cells.
//
// Design: the anti-diagonal wavefront. A group of G lanes scores one pair;
// lane l owns S consecutive query rows, H and E of each in registers, and
// works on column j - l at step j. With consecutive rows in one lane F is
// the ordinary recurrence in a register,
//   F[i] = max(F[i-1] - ge, h_noF[i-1] - go),
// which unrolls to the formula above term by term. Two values cross lanes
// per (lane, column): the last row's H and the F it hands down, one shfl_up
// each for S cells. Profiles sit in shared memory as int16, letter-major,
// and one 128-bit load brings eight rows of one letter; a block scores many
// pairs of its slot on one loaded tile. Each lane keeps its own best cell
// (it meets columns in order and rows in order, and moves on strict
// improvement only); one reduction per pair takes the largest score, then
// the smallest column, then the smallest row. A slot taller than G*S rows
// runs pass after pass; between passes each column hands on two numbers
// (last row's H, F for the next row) through a scratch row of the group.
// Rows beyond the slot's end hold a negative profile score: every value
// there stays strictly below a real cell of an earlier or the same column,
// so they never win the reduction. G and S are template parameters; the
// kernel holds five lane groups and each block takes the one that fits its
// slot's length, so a batch of unequal slots wastes few rows. A kernel
// without the AA alphabet serves profiles whose AA half is all zero.
#include <cstdint>
#include <cuda_runtime.h>

#include "dp_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kNegInf = -(1 << 30);
constexpr int16_t kPadScore = -4096;   // profile score of rows beyond a slot
constexpr int kMaxRows = 256;          // tallest pass of any lane group
constexpr int kMaxPairs = 32;          // most groups a block holds (G = 4)

// All pairs of one slot that this block is to score, with groups of G lanes
// of S rows each. Every thread of the block calls it (the tile is loaded
// between barriers).
template <int G, int S, bool kAA>
__device__ __forceinline__ void score_slot(
    int16_t* s_prof, const int32_t* __restrict__ prof_aa,
    const int32_t* __restrict__ prof_ss, long long total_rows, int row0,
    int len, long long p_begin, long long p_end, int bx, int nbx,
    const int8_t* __restrict__ res_aa, const int8_t* __restrict__ res_ss,
    const long long* __restrict__ pair_toff,
    const int32_t* __restrict__ pair_tlen, int32_t* scratch,
    long long scr_stride, int go, int ge, int32_t* __restrict__ out_score,
    int32_t* __restrict__ out_qend, int32_t* __restrict__ out_tend)
{
    static_assert(S % 8 == 0 && (G & (G - 1)) == 0 && G <= 32, "lane group");
    constexpr int T = G * S;              // query rows per pass
    constexpr int kStride = T + 8;        // int16 per letter row, 16-byte rows
    constexpr int kPairs = kThreads / G;  // pairs per block iteration
    static_assert(T <= kMaxRows && kPairs <= kMaxPairs, "shared tile, scratch");
    const int g = threadIdx.x / G;        // group inside the block
    const int l = threadIdx.x % G;        // lane inside the group
    const int npass = (len + T - 1) / T;
    const long long nchunk = (p_end - p_begin + kPairs - 1) / kPairs;
    int32_t* scr = scratch + ((long long)blockIdx.x * kMaxPairs + g) * scr_stride;
    const int16_t* my_ss = s_prof + l * S;
    const int16_t* my_aa = s_prof + dp::kLetters * kStride + l * S;

    bool tile_loaded = false;
    for (long long chunk = bx; chunk < nchunk; chunk += nbx) {
        const long long p = p_begin + chunk * kPairs + g;
        const bool active = p < p_end;    // uniform over the group
        const int tlen = active ? pair_tlen[p] : 0;
        const long long toff = active ? pair_toff[p] : 0;
        const int steps = __reduce_max_sync(dp::kFullMask, tlen) + G - 1;
        int best = 0, best_j = 0, best_i = len - 1;

        for (int pass = 0; pass < npass; ++pass) {
            const int base = pass * T;
            if (npass > 1 || !tile_loaded) {
                __syncthreads();
                dp::load_tile<T, true>(
                    s_prof, kStride, base, len, kPadScore,
                    [&](int a, int row) {
                        return prof_ss[a * total_rows + row0 + row];
                    },
                    [](int r) { return r; });
                if (kAA)
                    dp::load_tile<T, true>(
                        s_prof + dp::kLetters * kStride, kStride, base, len,
                        kPadScore,
                        [&](int a, int row) {
                            return prof_aa[a * total_rows + row0 + row];
                        },
                        [](int r) { return r; });
                __syncthreads();
                tile_loaded = true;
            }
            const bool last = pass == npass - 1;
            const int my_row0 = base + l * S;

            int H[S], E[S];
#pragma unroll
            for (int k = 0; k < S; ++k) {
                H[k] = 0;
                E[k] = kNegInf;
            }
            int pbest = 0, pbest_j = 0, pbest_i = 0;   // this pass, this lane
            int diag0 = 0;          // row above my first row, previous column
            int hout = 0, fout = kNegInf;   // what I hand to the lane below
            // target letters of my next column, cs | ca << 8
            int cur = 0;
            if (l == 0 && tlen > 0)
                cur = (uint8_t)res_ss[toff] | ((uint8_t)res_aa[toff] << 8);

            for (int t = 0; t < steps; ++t) {
                int hin = __shfl_up_sync(dp::kFullMask, hout, 1, G);
                int fin = __shfl_up_sync(dp::kFullMask, fout, 1, G);
                const int j = t - l;
                const bool on = j >= 0 && j < tlen;
                if (l == 0) {
                    hin = 0;
                    fin = kNegInf;
                    if (pass > 0 && on) {
                        hin = scr[2 * j];
                        fin = scr[2 * j + 1];
                    }
                }
                int nxt = 0;
                if (j + 1 >= 0 && j + 1 < tlen)
                    nxt = (uint8_t)res_ss[toff + j + 1]
                          | ((uint8_t)res_aa[toff + j + 1] << 8);
                if (on) {
                    const int cs = min(cur & 0xff, dp::kLetters - 1);
                    const uint4* ps =
                        reinterpret_cast<const uint4*>(my_ss + cs * kStride);
                    const uint4* pa = ps;
                    if (kAA) {
                        const int ca = min(cur >> 8, dp::kLetters - 1);
                        pa = reinterpret_cast<const uint4*>(my_aa + ca * kStride);
                    }
                    int diag = diag0;
                    int F = fin;
                    int m = 0;
#pragma unroll
                    for (int c = 0; c < S / 8; ++c) {
                        uint4 w = ps[c];
                        if (kAA) {
                            const uint4 wa = pa[c];
                            w.x = __vadd2(w.x, wa.x);
                            w.y = __vadd2(w.y, wa.y);
                            w.z = __vadd2(w.z, wa.z);
                            w.w = __vadd2(w.w, wa.w);
                        }
                        const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
                        for (int u = 0; u < 8; ++u) {
                            const int k = c * 8 + u;
                            const int s = (u & 1) ? dp::hi16(words[u >> 1])
                                                  : dp::lo16(words[u >> 1]);
                            const int hn = __viaddmax_s32_relu(diag, s, E[k]);
                            diag = H[k];
                            const int hgo = hn - go;
                            E[k] = __viaddmax_s32(E[k], -ge, hgo);
                            const int h = max(hn, F);
                            F = __viaddmax_s32(F, -ge, hgo);
                            H[k] = h;
                            m = max(m, h);
                        }
                    }
                    hout = H[S - 1];
                    fout = F;
                    diag0 = hin;
                    if (l == G - 1 && !last) {
                        scr[2 * j] = hout;
                        scr[2 * j + 1] = fout;
                    }
                    if (m > pbest) {
                        pbest = m;
                        pbest_j = j;
                        int kk = S - 1;
#pragma unroll
                        for (int k = S - 2; k >= 0; --k)
                            if (H[k] == m) kk = k;
                        pbest_i = my_row0 + kk;
                    }
                }
                cur = nxt;
            }
            // this pass holds larger rows than the passes before it: it
            // wins on a larger score, or on an equal one at a smaller column
            if (pbest > best || (pbest == best && pbest > 0 && pbest_j < best_j)) {
                best = pbest;
                best_j = pbest_j;
                best_i = pbest_i;
            }
        }
#pragma unroll
        for (int off = G / 2; off > 0; off >>= 1) {
            const int ob = __shfl_xor_sync(dp::kFullMask, best, off);
            const int oj = __shfl_xor_sync(dp::kFullMask, best_j, off);
            const int oi = __shfl_xor_sync(dp::kFullMask, best_i, off);
            if (ob > best || (ob == best && (oj < best_j ||
                                             (oj == best_j && oi < best_i)))) {
                best = ob;
                best_j = oj;
                best_i = oi;
            }
        }
        if (active && l == 0) {
            out_score[p] = best;
            out_qend[p] = best_i;
            out_tend[p] = best_j;
        }
    }
}

// Block b works on slot b / nbx and on every nbx-th chunk of its pairs, with
// the lane group that fits the slot's length.
template <bool kAA>
__global__ void __launch_bounds__(kThreads)
sw_kernel(const int32_t* __restrict__ prof_aa,   // [21, total_rows]
          const int32_t* __restrict__ prof_ss,   // [21, total_rows]
          long long total_rows,
          const int32_t* __restrict__ slot_off,  // [slots + 1] row offsets
          const long long* __restrict__ pair_start,  // [slots + 1]
          int nbx,                               // blocks per slot
          const int8_t* __restrict__ res_aa,     // concatenated target residues
          const int8_t* __restrict__ res_ss,
          const long long* __restrict__ pair_toff,
          const int32_t* __restrict__ pair_tlen,
          int32_t* scratch,                      // [blocks * 32, scr_stride]
          long long scr_stride,
          int go, int ge,
          int32_t* __restrict__ out_score,
          int32_t* __restrict__ out_qend,
          int32_t* __restrict__ out_tend)
{
    __shared__ __align__(16) int16_t s_prof[(kAA ? 2 : 1) * dp::kLetters
                                            * (kMaxRows + 8)];
    const int slot = blockIdx.x / nbx;
    const int row0 = slot_off[slot];
    const int len = slot_off[slot + 1] - row0;
#define SW_SLOT(G, S)                                                         \
    score_slot<G, S, kAA>(s_prof, prof_aa, prof_ss, total_rows, row0, len,    \
                          pair_start[slot], pair_start[slot + 1],             \
                          blockIdx.x - slot * nbx, nbx, res_aa, res_ss,       \
                          pair_toff, pair_tlen, scratch, scr_stride, go, ge,  \
                          out_score, out_qend, out_tend)
    // the fewest padded rows, then the fewest lanes (G - 1 steps of every
    // target fill and drain the group); taller slots run in passes
    if (len <= 32) SW_SLOT(4, 8);
    else if (len <= 64) SW_SLOT(8, 8);
    else if (len <= 128) SW_SLOT(8, 16);
    else if (len <= 192) SW_SLOT(8, 24);
    else if (len <= 256) SW_SLOT(16, 16);
    else SW_SLOT(8, 24);
#undef SW_SLOT
}

}  // namespace

// Scores every pair of every slot with nslots * nbx blocks. with_aa = 0
// takes the kernel that reads only the 3Di profile (the AA profile must then
// be all zero). scratch holds nslots * nbx * 32 rows of scr_stride int32 (at
// least twice the longest target) when a slot is taller than 256 rows, and is
// not touched otherwise. Returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int sw_scores(int with_aa, int nslots, int nbx, void* stream,
                         const int32_t* prof_aa, const int32_t* prof_ss,
                         long long total_rows, const int32_t* slot_off,
                         const long long* pair_start, const int8_t* res_aa,
                         const int8_t* res_ss, const long long* pair_toff,
                         const int32_t* pair_tlen, int32_t* scratch,
                         long long scr_stride, int go, int ge, int32_t* score,
                         int32_t* qend, int32_t* tend)
{
    if (nslots == 0 || nbx == 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    if (with_aa)
        sw_kernel<true><<<nslots * nbx, kThreads, 0, s>>>(
            prof_aa, prof_ss, total_rows, slot_off, pair_start, nbx, res_aa,
            res_ss, pair_toff, pair_tlen, scratch, scr_stride, go, ge, score,
            qend, tend);
    else
        sw_kernel<false><<<nslots * nbx, kThreads, 0, s>>>(
            prof_aa, prof_ss, total_rows, slot_off, pair_start, nbx, res_aa,
            res_ss, pair_toff, pair_tlen, scratch, scr_stride, go, ge, score,
            qend, tend);
    return (int)cudaGetLastError();
}
