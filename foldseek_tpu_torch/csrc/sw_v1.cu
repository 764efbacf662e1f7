// Dual-alphabet affine Smith-Waterman score and end positions for an NVIDIA
// Hopper card.
//
// Replaces the Pallas TPU kernels of foldseek_tpu/ops/sw_pallas.py:
//   K3  _make_sw_batch_kernel / sw_scores_batch_multi (stacked query slots,
//       F segmented across slots by the SEG_BIG staircase), and
//   K4  _make_sw_kernel / sw_scores_query (one query),
// and the per-target numpy loop that foldseek_tpu/search/align.py runs on the
// host for queries longer than 2048. Per (slot, target) pair it computes
// exactly foldseek_tpu/ops/sw.py::sw_score_endpos:
//   h_noF[i] = max(H[i-1] (previous column) + s, E[i], 0)
//   F[i]     = max_{k<i}(h_noF[k] + k*ge) - (i-1)*ge - go     (lazy F)
//   H[i]     = max(h_noF[i], F[i]);  E[i] = max(E[i] - ge, h_noF[i] - go)
// with s = prof_aa[t_aa][i] + prof_ss[t_ss][i]. The target end is the first
// column that strictly improves the best score, the query end the smallest
// row reaching that column's max. Columns j >= t_len are not scanned (they
// could never improve the score).
//
// What bounds it here: DP cell updates, about 40 integer and shuffle
// instructions per cell row-step of a warp; the bytes are small (two
// residue bytes per column, profiles in shared memory). The TPU version
// scored cells with one-hot matrix products and held the state of a whole
// target block in VMEM; here the state of one pair sits in registers.
//
// Design: one warp per (slot, target) pair, kWarps pairs of the same slot per
// block. Query rows are striped over the lanes: row k*32 + lane of a tile of
// 32*R rows lives in register k of that lane, so the profile reads from
// shared memory are conflict-free. The diagonal input comes from the
// neighbouring lane (shfl_up); F's prefix max is a warp scan per register
// plus a running carry. Slots have their own lengths, so the TPU's pad rows,
// SEG_BIG staircase and rowadd/rowsub constants are gone. A slot longer than
// one tile runs tile after tile; between tiles each column passes on four
// numbers through a per-pair scratch row (F carry, last row's H, column max
// and its row), so any query length runs in the same kernel.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;       // pairs (targets) per block, all of one slot
constexpr int kLetters = 21;
constexpr int kNegInf = -(1 << 30);
constexpr unsigned kFull = 0xffffffffu;

template <int R>
__global__ void __launch_bounds__(kWarps * 32)
sw_kernel(const int32_t* __restrict__ prof_aa,   // [21, total_rows]
          const int32_t* __restrict__ prof_ss,   // [21, total_rows]
          long long total_rows,
          const int32_t* __restrict__ slot_off,  // [S + 1] row offsets
          const int32_t* __restrict__ blk_slot,  // [nblk]
          const int32_t* __restrict__ blk_p0,    // [nblk] first pair
          const int32_t* __restrict__ blk_p1,    // [nblk] end of the slot's pairs
          const int8_t* __restrict__ res_aa,     // concatenated target residues
          const int8_t* __restrict__ res_ss,
          const long long* __restrict__ pair_toff,
          const int32_t* __restrict__ pair_tlen,
          const long long* __restrict__ pair_scr,  // scratch offset (multi-tile slots)
          int32_t* __restrict__ scratch,
          int go, int ge,
          int32_t* __restrict__ out_score,
          int32_t* __restrict__ out_qend,
          int32_t* __restrict__ out_tend)
{
    constexpr int T = 32 * R;   // query rows per tile
    __shared__ int32_t s_aa[kLetters][T];
    __shared__ int32_t s_ss[kLetters][T];

    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x;
    const int slot = blk_slot[b];
    const int p = blk_p0[b] + (threadIdx.x >> 5);
    const bool active = p < blk_p1[b];           // uniform over the warp
    const int row0 = slot_off[slot];
    const int len = slot_off[slot + 1] - row0;
    const int ntile = (len + T - 1) / T;

    int tlen = 0;
    long long toff = 0;
    int32_t* scr = nullptr;
    if (active) {
        tlen = pair_tlen[p];
        toff = pair_toff[p];
        if (ntile > 1) scr = scratch + pair_scr[p];
    }
    int best = 0, best_j = 0, best_q = len - 1;

    for (int tile = 0; tile < ntile; ++tile) {
        const int base = tile * T;
        __syncthreads();
        for (int idx = threadIdx.x; idx < kLetters * T; idx += kWarps * 32) {
            const int a = idx / T;
            const int r = idx - a * T;
            const bool in = base + r < len;
            const long long g = (long long)a * total_rows + row0 + base + r;
            s_aa[a][r] = in ? prof_aa[g] : 0;
            s_ss[a][r] = in ? prof_ss[g] : 0;
        }
        __syncthreads();
        if (!active) continue;

        const bool last = tile == ntile - 1;
        int H[R], E[R];
#pragma unroll
        for (int k = 0; k < R; ++k) {
            H[k] = 0;
            E[k] = kNegInf;
        }
        int bh = 0;   // previous tile's last-row H at column j - 1
        for (int j = 0; j < tlen; ++j) {
            const int ca = min((int)(uint8_t)res_aa[toff + j], kLetters - 1);
            const int cs = min((int)(uint8_t)res_ss[toff + j], kLetters - 1);
            // values the previous tile left for this column (lane 0 owns scratch)
            int bf = kNegInf, ph = 0, pm = -1, parg = 0;
            if (tile > 0) {
                if (lane == 0) {
                    bf = scr[4 * j];
                    ph = scr[4 * j + 1];
                    pm = scr[4 * j + 2];
                    parg = scr[4 * j + 3];
                }
                bf = __shfl_sync(kFull, bf, 0);
                pm = __shfl_sync(kFull, pm, 0);
                parg = __shfl_sync(kFull, parg, 0);
            }

            int diag[R];
#pragma unroll
            for (int k = 0; k < R; ++k) {
                const int up = __shfl_up_sync(kFull, H[k], 1);
                const int wrap = __shfl_sync(kFull, k > 0 ? H[k > 0 ? k - 1 : 0] : 0, 31);
                diag[k] = lane > 0 ? up : (k > 0 ? wrap : bh);
            }

            int run = bf;   // prefix max of h_noF + i*ge over all earlier rows
#pragma unroll
            for (int k = 0; k < R; ++k) {
                const int r = k * 32 + lane;
                const int i = base + r;
                // max(diag + s, E, 0)
                const int hn = __viaddmax_s32_relu(diag[k], s_aa[ca][r] + s_ss[cs][r], E[k]);
                int incl = hn + i * ge;
#pragma unroll
                for (int off = 1; off < 32; off <<= 1) {
                    const int t = __shfl_up_sync(kFull, incl, off);
                    if (lane >= off) incl = max(incl, t);
                }
                int excl = __shfl_up_sync(kFull, incl, 1);
                excl = lane > 0 ? max(excl, run) : run;
                const int f = excl - (i - 1) * ge - go;
                E[k] = max(E[k] - ge, hn - go);
                H[k] = max(hn, f);
                run = max(run, __shfl_sync(kFull, incl, 31));
            }

            // column max over this tile's real rows, and its smallest row
            int m = -1;
#pragma unroll
            for (int k = 0; k < R; ++k)
                if (base + k * 32 + lane < len) m = max(m, H[k]);
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) m = max(m, __shfl_xor_sync(kFull, m, off));
            int arg = INT_MAX;
#pragma unroll
            for (int k = 0; k < R; ++k) {
                const int i = base + k * 32 + lane;
                if (i < len && H[k] == m) arg = min(arg, i);
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) arg = min(arg, __shfl_xor_sync(kFull, arg, off));
            if (tile > 0 && pm >= m) {   // earlier tiles hold the smaller rows
                m = pm;
                arg = parg;
            }

            if (!last) {
                const int hl = __shfl_sync(kFull, H[R - 1], 31);
                if (lane == 0) {
                    scr[4 * j] = run;
                    scr[4 * j + 1] = hl;
                    scr[4 * j + 2] = m;
                    scr[4 * j + 3] = arg;
                }
            } else if (m > best) {
                best = m;
                best_j = j;
                best_q = arg;
            }
            bh = __shfl_sync(kFull, ph, 0);
        }
    }
    if (active && lane == 0) {
        out_score[p] = best;
        out_qend[p] = best_q;
        out_tend[p] = best_j;
    }
}

template <int R>
int launch(int nblk, cudaStream_t stream, const int32_t* prof_aa,
           const int32_t* prof_ss, long long total_rows, const int32_t* slot_off,
           const int32_t* blk_slot, const int32_t* blk_p0, const int32_t* blk_p1,
           const int8_t* res_aa, const int8_t* res_ss, const long long* pair_toff,
           const int32_t* pair_tlen, const long long* pair_scr, int32_t* scratch,
           int go, int ge, int32_t* score, int32_t* qend, int32_t* tend)
{
    sw_kernel<R><<<nblk, kWarps * 32, 0, stream>>>(
        prof_aa, prof_ss, total_rows, slot_off, blk_slot, blk_p0, blk_p1,
        res_aa, res_ss, pair_toff, pair_tlen, pair_scr, scratch, go, ge,
        score, qend, tend);
    return (int)cudaGetLastError();
}

}  // namespace

// Scores every (slot, target) pair described by the block table. R (1..8) is
// the number of query rows per lane in one tile. Returns cudaGetLastError()
// after the launch (0 = launched), or -1 for an R the library was not built for.
extern "C" int sw_scores(int rows_per_lane, int nblk, void* stream,
                         const int32_t* prof_aa, const int32_t* prof_ss,
                         long long total_rows, const int32_t* slot_off,
                         const int32_t* blk_slot, const int32_t* blk_p0,
                         const int32_t* blk_p1, const int8_t* res_aa,
                         const int8_t* res_ss, const long long* pair_toff,
                         const int32_t* pair_tlen, const long long* pair_scr,
                         int32_t* scratch, int go, int ge,
                         int32_t* score, int32_t* qend, int32_t* tend)
{
    if (nblk == 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
#define SW_LAUNCH(R)                                                          \
    case R:                                                                   \
        return launch<R>(nblk, s, prof_aa, prof_ss, total_rows, slot_off,     \
                         blk_slot, blk_p0, blk_p1, res_aa, res_ss, pair_toff, \
                         pair_tlen, pair_scr, scratch, go, ge, score, qend,   \
                         tend);
    switch (rows_per_lane) {
        SW_LAUNCH(1) SW_LAUNCH(2) SW_LAUNCH(3) SW_LAUNCH(4)
        SW_LAUNCH(5) SW_LAUNCH(6) SW_LAUNCH(7) SW_LAUNCH(8)
        default: return -1;
    }
#undef SW_LAUNCH
}
