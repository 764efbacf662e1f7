// Device code shared by the two dynamic-programming kernels (sw.cu,
// gapless.cu): query profiles as int16 tiles in shared memory, letter-major,
// so that one 128-bit load brings eight rows of one letter.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace dp {

constexpr int kLetters = 21;            // scored target letters 0..20
constexpr unsigned kFullMask = 0xffffffffu;

// Sign-extended halves of a word holding two int16 (little endian: the row
// with the lower index is the low half).
__device__ __forceinline__ int lo16(unsigned w) { return (int)(short)(w & 0xffffu); }
__device__ __forceinline__ int hi16(unsigned w) { return (int)w >> 16; }

// Fill an int16 shared tile of kRows query rows, one row of `stride` int16
// per letter, from an int32 profile in device memory. `src(letter, row)`
// gives the score of query row `row` (counted from the query's first row);
// rows at or beyond `len` get `pad`. `slot(r)` maps tile row r to its int16
// position inside a letter's row. kRowFastest says which index neighbouring
// threads share, to match the profile's layout in device memory: true for
// [letters, rows], false for [rows, 32 lanes]. Every value is written kCopies
// times, `copy_step` int16 apart (see the gapless kernel's interleaved
// copies). All threads of the block take part; the caller synchronises
// before and after.
template <int kRows, bool kRowFastest, int kCopies = 1, typename Src,
          typename Slot>
__device__ __forceinline__ void load_tile(int16_t* tile, int stride, int base,
                                          int len, int16_t pad, Src src,
                                          Slot slot, int copy_step = 0)
{
    constexpr int kLanes = 32;
    const int count = kRowFastest ? kLetters * kRows : kRows * kLanes;
    for (int idx = threadIdx.x; idx < count; idx += blockDim.x) {
        const int a = kRowFastest ? idx / kRows : idx % kLanes;
        const int r = kRowFastest ? idx - a * kRows : idx / kLanes;
        if (a >= kLetters) continue;
        const int row = base + r;
        const int16_t v = row < len ? (int16_t)src(a, row) : pad;
#pragma unroll
        for (int copy = 0; copy < kCopies; ++copy)
            tile[a * stride + slot(r) + copy * copy_step] = v;
    }
}

}  // namespace dp
