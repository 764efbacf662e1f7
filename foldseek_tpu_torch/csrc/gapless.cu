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
// panels of equal shape, and there is no cap. A pad letter (21..31) in a
// column scores so low that it resets h (to min(0, cap)).
//
// What bounds it here: integer instructions on DP cells; a 17 MB panel is
// microseconds of device memory. An earlier version walked diagonals with
// one running value a thread, so every cell paid two loads (the target byte
// again for every query row, and a profile word at a lane-dependent address)
// and sat on a chain of dependent instructions; it also walked the pad
// columns of the panel.
//
// Design: one thread per target walks the target's columns with a strip of
// consecutive query rows in registers. The target letter is read once per
// strip and column; the diagonal shift is the order of the unrolled update
// (row k takes the old value of row k - 1, rows updated from the bottom up).
// The query's profile sits in shared memory as int16, letter-major, and a
// 128-bit load brings eight rows of one letter; the cells of a column are
// independent, so one thread keeps the integer pipe busy. Three kernels:
//   packed  two rows a register, (row k, row k + W) in the low and high
//           half so that the shift stays a register renaming, updated by
//           one __viaddmin_s16x2_relu; exact while no cap is negative, no
//           running score can pass 32512 (because its cap stops it, or
//           because the shorter of query and target times the largest
//           profile entry does) and every profile entry lies in int8 range,
//           which the wrapper proves from its inputs before it takes this
//           kernel. It holds strips of six heights, 32 to 192 rows, and gives
//           every query the shortest that holds it, so a stack of unequal
//           queries wastes few rows;
//   single  one row a register, any cap (INT_MAX = none), 32-row strips;
//   dual    one row a register, two profiles and two panels, no cap, 32-row
//           strips.
// A query taller than the tallest strip runs pass after pass over the same
// columns; between passes each column hands on the last row's value through
// a scratch row of the block's threads. Every warp stops at the longest real
// target among its lanes (a kernel of its own measures the targets once a
// launch): pad columns only reset h and can never raise the best. Blocks
// walk over (query, target tile) work items, neighbouring items sharing a
// query; the wrapper shrinks the block of the 32-bit kernels for launches
// with few items so that a single query still spreads over the card.
#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "dp_common.cuh"

namespace {

constexpr int kLanes = 32;        // profile row in device memory: 32 letters
constexpr int kPadLetter = 21;    // letters 21..31 are pad
constexpr int kMaxThreads = 128;

// Real length of every target: one past the last column whose letter (both
// letters, for two panels) is not pad.
__global__ void target_lengths(const int8_t* __restrict__ t_T,
                               const int8_t* __restrict__ t2_T, int lt, int n,
                               long long ld, long long ld2,
                               int32_t* __restrict__ out)
{
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    if (col >= n) return;
    int tl = lt;
    while (tl > 0) {
        bool pad = ((uint8_t)t_T[(tl - 1) * ld + col] & (kLanes - 1)) >= kPadLetter;
        if (t2_T != nullptr)
            pad = pad || ((uint8_t)t2_T[(tl - 1) * ld2 + col] & (kLanes - 1))
                             >= kPadLetter;
        if (!pad) break;
        --tl;
    }
    out[col] = tl;
}

// The profile tile of one pass in shared memory. The packed kernel makes
// a 128-bit load for every six integer instructions, and its threads read
// whatever letters their targets hold, so a plain tile would serialise on
// bank conflicts: it keeps eight copies of the tile interleaved 16 bytes
// apart, thread t reading copy t % 8, and every phase of a load then falls on
// eight different bank groups. The 32-bit instances feed 32 or more
// instructions from a load and keep one copy, its letter rows padded by one
// chunk so that they spread over the banks.
template <int W, bool kPacked, bool kDual>
struct Layout {
    static constexpr int kRows = kPacked ? 2 * W : W;   // query rows per pass
    static constexpr int kCopies = kPacked ? 8 : 1;
    static constexpr int kStride =                       // int16 per letter
        kPacked ? kRows * kCopies : kRows + 8;
    static constexpr int kBytes =
        (kDual ? 2 : 1) * dp::kLetters * kStride * (int)sizeof(int16_t);
};

// One (query, target tile) item for one thread's target: every pass of the
// query over the target's columns with a strip of W state registers (2 * W
// query rows a pass when kPacked, W otherwise). Returns the best score. Carry
// is the type of the scratch values between passes. All threads of the block
// call it together (the tile is loaded between barriers).
template <int W, bool kPacked, bool kDual, typename Carry>
__device__ __forceinline__ int score_item(
    int16_t* s_prof, const int32_t* __restrict__ prof,
    const int32_t* __restrict__ prof2, int r0, int len, int cap,
    const int8_t* __restrict__ t, const int8_t* __restrict__ t2, long long ld,
    long long ld2, bool valid, int wmax, Carry* scr)
{
    static_assert(!(kPacked && kDual), "the dual kernel has no cap to pack under");
    static_assert(W % 8 == 0, "whole 128-bit loads");
    using L = Layout<W, kPacked, kDual>;
    constexpr int R = L::kRows;
    constexpr int kStride = L::kStride;
    const int npass = (len + R - 1) / R;
    const int zero = min(0, cap);        // h after a pad column
    const unsigned cap2 = (unsigned)cap | ((unsigned)cap << 16);
    // running maxima kept apart so that they do not form one chain of
    // dependent instructions; measured: four help the single-alphabet
    // instances, the dual one is faster with one
    constexpr int kChains = kDual ? 1 : 4;
    int best[kChains] = {};
    unsigned best2[kChains] = {};

    for (int pass = 0; pass < npass; ++pass) {
        const int base = pass * R;
        __syncthreads();
        auto slot = [](int r) {
            // packed: rows (k, k + W) share register k; chunks of eight
            // int16 lie kCopies chunks apart
            const int at = kPacked ? (r < W ? 2 * r : 2 * (r - W) + 1) : r;
            return (at / 8) * 8 * L::kCopies + at % 8;
        };
        dp::load_tile<R, false, L::kCopies>(
            s_prof, kStride, base, len, (int16_t)0,
            [&](int a, int row) {
                return prof[(long long)(r0 + row) * kLanes + a];
            }, slot, 8);
        if (kDual)
            dp::load_tile<R, false, L::kCopies>(
                s_prof + dp::kLetters * kStride, kStride, base, len,
                (int16_t)0,
                [&](int a, int row) {
                    return prof2[(long long)(r0 + row) * kLanes + a];
                }, slot, 8);
        __syncthreads();
        const bool last = pass == npass - 1;

        int h[W];     // packed: (row k, row k + W) of the previous column
#pragma unroll
        for (int k = 0; k < W; ++k) h[k] = 0;
        int prev = 0;   // the pass before, its last row, previous column
        int letter = kPadLetter, letter2 = 0;
        if (valid && wmax > 0) {
            letter = (uint8_t)t[0] & (kLanes - 1);
            if (kDual) letter2 = (uint8_t)t2[0] & (kLanes - 1);
        }
#pragma unroll 1
        for (int j = 0; j < wmax; ++j) {
            int nletter = kPadLetter, nletter2 = 0;
            if (valid && j + 1 < wmax) {
                nletter = (uint8_t)t[(j + 1) * ld] & (kLanes - 1);
                if (kDual) nletter2 = (uint8_t)t2[(j + 1) * ld2] & (kLanes - 1);
            }
            const int cin = prev;
            if (pass > 0) prev = (int)scr[(long long)j * blockDim.x];
            int cout;
            if (letter >= kPadLetter || (kDual && letter2 >= kPadLetter)) {
#pragma unroll
                for (int k = 0; k < W; ++k) h[k] = kPacked ? 0 : zero;
                cout = kPacked ? 0 : zero;
            } else if (kPacked) {
                // this thread's copy of the tile: a bank group of its own
                const uint4* pp = reinterpret_cast<const uint4*>(
                    s_prof + letter * kStride) + (threadIdx.x & (L::kCopies - 1));
                // row 0 takes the pass before; row W takes row W - 1
                const unsigned d0 = ((unsigned)cin & 0xffffu)
                                    | ((unsigned)h[W - 1] << 16);
#pragma unroll
                for (int c = W / 4 - 1; c >= 0; --c) {
                    const uint4 w = pp[c * L::kCopies];
                    const unsigned p[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
                    for (int u = 3; u >= 0; --u) {
                        const int k = 4 * c + u;
                        const unsigned d = k > 0 ? (unsigned)h[k > 0 ? k - 1 : 0]
                                                 : d0;
                        h[k] = (int)__viaddmin_s16x2_relu(d, p[u], cap2);
                    }
                    best2[(2 * c) % kChains] = __vimax3_s16x2(
                        best2[(2 * c) % kChains], (unsigned)h[4 * c],
                        (unsigned)h[4 * c + 1]);
                    best2[(2 * c + 1) % kChains] = __vimax3_s16x2(
                        best2[(2 * c + 1) % kChains], (unsigned)h[4 * c + 2],
                        (unsigned)h[4 * c + 3]);
                }
                cout = (int)((unsigned)h[W - 1] >> 16);
            } else {
                const uint4* pp =
                    reinterpret_cast<const uint4*>(s_prof + letter * kStride);
                const uint4* pp2 = kDual
                    ? reinterpret_cast<const uint4*>(
                          s_prof + (dp::kLetters + letter2) * kStride)
                    : pp;
#pragma unroll
                for (int c = W / 8 - 1; c >= 0; --c) {
                    uint4 w = pp[c];
                    if (kDual) {
                        const uint4 w2 = pp2[c];
                        w.x = __vadd2(w.x, w2.x);
                        w.y = __vadd2(w.y, w2.y);
                        w.z = __vadd2(w.z, w2.z);
                        w.w = __vadd2(w.w, w2.w);
                    }
                    const unsigned p[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
                    for (int u = 7; u >= 0; --u) {
                        const int k = 8 * c + u;
                        const int s = (u & 1) ? dp::hi16(p[u >> 1])
                                              : dp::lo16(p[u >> 1]);
                        const int d = k > 0 ? h[k > 0 ? k - 1 : 0] : cin;
                        h[k] = kDual ? __viaddmax_s32(d, s, 0)
                                     : min(__viaddmax_s32(d, s, 0), cap);
                        if (!(u & 1))
                            best[(k / 2) % kChains] = __vimax3_s32(
                                best[(k / 2) % kChains], h[k], h[k + 1]);
                    }
                }
                cout = h[W - 1];
            }
            if (!last) scr[(long long)j * blockDim.x] = (Carry)cout;
            letter = nletter;
            letter2 = nletter2;
        }
    }
    int top = 0;
#pragma unroll
    for (int x = 0; x < kChains; ++x)
        top = kPacked ? __vimax3_s32(top, (int)(best2[x] & 0xffffu),
                                     (int)(best2[x] >> 16))
                      : max(top, best[x]);
    return top;
}

// Strips of the three kernels, in state registers. The packed one holds 32
// to 192 query rows a pass (16 to 96 registers of two rows): each item takes
// the shortest strip that holds its query, and the tallest, in passes, for a
// taller query. The 32-bit ones hold 32 rows and run taller queries in
// passes: measured on a stack of 92 to 167 rows, strips of 64 and 96 (161
// and 227 registers a thread) were a fifth and a third slower.
template <bool kPacked>
struct Strips {
    static constexpr int kShortest = kPacked ? 16 : 32;
    static constexpr int kStep = 16;
    static constexpr int kTallest = kPacked ? 96 : 32;
};

template <bool kPacked, bool kDual>
struct Tallest : Layout<Strips<kPacked>::kTallest, kPacked, kDual> {};

template <int W, bool kPacked, bool kDual, typename Carry, typename... Args>
__device__ __forceinline__ int score_with_fitting_strip(int len, Args... args)
{
    if constexpr (W >= Strips<kPacked>::kTallest) {
        return score_item<W, kPacked, kDual, Carry>(args...);
    } else {
        if (len <= Layout<W, kPacked, kDual>::kRows)
            return score_item<W, kPacked, kDual, Carry>(args...);
        return score_with_fitting_strip<W + Strips<kPacked>::kStep, kPacked,
                                        kDual, Carry>(len, args...);
    }
}

template <bool kPacked, bool kDual, typename Carry>
__global__ void __launch_bounds__(kMaxThreads)
gapless_kernel(const int32_t* __restrict__ prof,   // [rows, 32]
               const int32_t* __restrict__ prof2,  // [rows, 32] (dual)
               const int32_t* __restrict__ q_off,  // [nq + 1] row offsets
               const int32_t* __restrict__ caps,   // [nq] (single alphabet)
               int nq,
               const int8_t* __restrict__ t_T,     // [lt, ld] transposed panel
               const int8_t* __restrict__ t2_T,    // [lt, ld2] (dual)
               const int32_t* __restrict__ t_len,  // [n] real target lengths
               int lt, int n, long long ld, long long ld2,
               Carry* scratch,                     // [blocks, lt, threads]
               int32_t* __restrict__ out)          // [nq, n]
{
    extern __shared__ __align__(16) int16_t s_prof[];

    const int ntile = (n + blockDim.x - 1) / blockDim.x;
    const long long total = (long long)nq * ntile;
    Carry* scr = scratch + (long long)blockIdx.x * lt * blockDim.x + threadIdx.x;

    for (long long item = blockIdx.x; item < total; item += gridDim.x) {
        const int q = (int)(item / ntile);
        const int col = (int)(item - (long long)q * ntile) * blockDim.x + threadIdx.x;
        const bool valid = col < n;
        const int wmax = __reduce_max_sync(dp::kFullMask, valid ? t_len[col] : 0);
        const int r0 = q_off[q];
        const int len = q_off[q + 1] - r0;
        // the packed kernel never lets h pass 16 bits (the wrapper proved
        // that no score does), so a larger cap is the same as this one
        const int cap = kDual ? INT_MAX
                              : (kPacked ? min(caps[q], 0x7fff) : caps[q]);
        const int8_t* t = t_T + col;
        const int8_t* t2 = kDual ? t2_T + col : nullptr;
        const int top = score_with_fitting_strip<Strips<kPacked>::kShortest,
                                                 kPacked, kDual, Carry>(
            len, s_prof, prof, prof2, r0, len, cap, t, t2, ld, ld2, valid,
            wmax, scr);
        if (valid) out[(long long)q * n + col] = top;
    }
}

template <bool kPacked, bool kDual>
int launch(int grid, int threads, cudaStream_t stream, const int32_t* prof,
           const int32_t* prof2, const int32_t* q_off, const int32_t* caps,
           int nq, const int8_t* t_T, const int8_t* t2_T, int32_t* t_len,
           int lt, int n, long long ld, long long ld2, void* scratch,
           int32_t* out)
{
    using Carry = typename std::conditional<kPacked, uint16_t, int32_t>::type;
    constexpr int kBytes = Tallest<kPacked, kDual>::kBytes;
    if (threads < 32 || threads > kMaxThreads || threads % 32 != 0) return -1;
    target_lengths<<<(n + 127) / 128, 128, 0, stream>>>(t_T, t2_T, lt, n, ld,
                                                        ld2, t_len);
    cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
    if (kBytes > 48 * 1024) {   // beyond the default limit: ask for it
        rc = cudaFuncSetAttribute(gapless_kernel<kPacked, kDual, Carry>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kBytes);
        if (rc != cudaSuccess) return (int)rc;
    }
    gapless_kernel<kPacked, kDual, Carry><<<grid, threads, kBytes, stream>>>(
        prof, prof2, q_off, caps, nq, t_T, t2_T, t_len, lt, n, ld, ld2,
        (Carry*)scratch, out);
    return (int)cudaGetLastError();
}

}  // namespace

// Scores nq stacked queries against the n targets of one transposed panel
// with `grid` blocks of `threads` threads (32, 64, 96 or 128). packed = 1
// takes the packed 16-bit kernel: no cap may be negative, no running score
// may pass 32512 (by its cap, or by the lengths and the largest profile
// entry) and every profile entry must lie in int8 range. t_len is int32 [n]
// of work space; scratch holds grid * lt * threads values (uint16 when
// packed, int32 otherwise) when a query is taller than the tallest strip
// (192 rows packed, 32 otherwise), and is not touched otherwise. Returns
// cudaGetLastError() after the launch (0 = launched), or -1 for a block size
// the kernel does not take.
extern "C" int gapless_scores(int packed, int grid, int threads,
                              const int32_t* prof, const int32_t* q_off,
                              const int32_t* caps, int nq, const int8_t* t_T,
                              int lt, int n, long long ld, int32_t* t_len,
                              void* scratch, int32_t* out, void* stream)
{
    if (nq == 0 || n == 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    return packed
        ? launch<true, false>(grid, threads, s, prof, nullptr, q_off, caps, nq,
                              t_T, nullptr, t_len, lt, n, ld, 0, scratch, out)
        : launch<false, false>(grid, threads, s, prof, nullptr, q_off, caps,
                               nq, t_T, nullptr, t_len, lt, n, ld, 0, scratch,
                               out);
}

// Dual-alphabet scores, no cap: nq stacked (prof_aa, prof_ss) queries against
// the n targets of two transposed panels of equal shape; 32-bit kernel.
extern "C" int gapless_scores_dual(int grid, int threads,
                                   const int32_t* prof_aa,
                                   const int32_t* prof_ss,
                                   const int32_t* q_off, int nq,
                                   const int8_t* t_aa_T, const int8_t* t_ss_T,
                                   int lt, int n, long long ld_aa,
                                   long long ld_ss, int32_t* t_len,
                                   void* scratch, int32_t* out, void* stream)
{
    if (nq == 0 || n == 0) return 0;
    return launch<false, true>(grid, threads, (cudaStream_t)stream, prof_aa,
                               prof_ss, q_off, nullptr, nq, t_aa_T, t_ss_T,
                               t_len, lt, n, ld_aa, ld_ss, scratch, out);
}
