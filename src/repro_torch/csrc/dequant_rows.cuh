// The dequantising loader of K5 (dequant_stats.cu) and K7
// (dequant_stats_rect.cu): payload[row].f32 * mult[row] for an int8, bf16
// or fp32 payload, in registers.  Both kernels include this one header, so
// K7's symmetric grid runs K5's code.
//
// The loader walks its own columns first (stats_tile::walks_columns,
// stats_tile::elements): the templates hand it their grid-stride column
// walk and a step() that takes one column's rows; it calls step() for the
// columns its packed words cover, in the templates' order, and the
// templates' per-element loop walks the rest through its tiles' load().
// Each thread keeps its columns and its fmaf chains, so the sums are K1's
// on the decoded rows bit for bit.
//
// Element by element, a warp asks for 32 bytes of an int8 row (64 of a
// bf16 one) a request: K1's count of loads for a quarter (a half) of its
// bytes, each after the previous column's products.  So:
//   * each lane loads 4-byte words of 4 int8 (2 bf16) columns: at R = 12
//     rows, three (six) words a lane cover the warp's 32 columns, in place
//     of twelve loads of one element;
//   * __shfl_sync hands each lane the word that holds its own column of a
//     row, and __byte_perm takes its byte (half) out: bf16 widens by a
//     shift, int8 (biased by 0x80 a byte, u = v + 128) by the exact float
//     2^23 + u - (2^23 + 128);
//   * the next group's words are loaded after the current group's
//     products: no word is live across the 78 FMAs, and loads further
//     ahead (in registers or as an L1 prefetch) did not pay;
//   * the multipliers sit in shared memory, 0 past n, read as a broadcast.
//     A symmetric 12-row tile holds 78 accumulators, so registers are what
//     bounds the blocks an SM holds: with the multipliers (or a queue of
//     words) in registers an SM holds one block, and the kernel takes half
//     again as long (PERF.md, PR 19);
//   * the templates hold the symmetric grid's tiles of at most 12 rows to
//     two blocks an SM (128 registers); the rectangular grid runs one
//     block an SM, where its (4, 12) tile needs no spill.
// A row past n has multiplier 0 and a zero word: an exact +0.0, as the
// per-element loop's 0.0f.  The packed words need every row to start on a
// 4-byte boundary (base aligned, d a multiple of the columns in a word)
// and a whole warp inside d: a warp-uniform condition, since a warp's
// columns c0..c0+31 start at a multiple of 32 (the grid stride is chunks *
// 256).  Everything else (a warp's last partial group, an odd d, a view at
// an unaligned offset, fp32, a tile too large for the words) takes the
// per-element loads, with the same multipliers, FMAs and order.
#pragma once

#include <stdint.h>

#include "stats_tile.cuh"

namespace dequant_rows {

using stats_tile::widen;

// The fp32 at a shared-memory address.  Volatile, so that nvcc reads it
// where it is used and does not hoist it into a register for the loop.
__device__ __forceinline__ float shared_at(const float* p) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];"
               : "=f"(v)
               : "r"((unsigned)__cvta_generic_to_shared(p)));
  return v;
}

// R rows row0.. of a payload of type T, with their multipliers, as one lane
// of a warp loads them.  Lane l holds word k of a group: row row0 + l /
// kRowWords + k * kCols, the kCols columns from kCols * (l % kRowWords).
template <class T, int R>
struct Tile {
  static constexpr int kCols = 4 / sizeof(T);     // columns in a word
  static constexpr int kRowWords = 32 / kCols;    // words of a row in 32 columns
  static constexpr int kWords = R / kCols;        // words a lane holds
  static constexpr int kRows = R;
  static_assert(R % kCols == 0, "a lane's words must cover whole rows");
  // int8 words are unpacked biased by 0x80 a byte (the unsigned u = v + 128)
  static constexpr uint32_t kBias = sizeof(T) == 1 ? 0x80808080u : 0u;
  struct Words {
    uint32_t w[kWords];
  };

  const T* p;
  int64_t d;
  int64_t row0;
  const uint32_t* word;  // this lane's word 0 of the group at column 0
  bool live[kWords];     // word k lies in a row below n
  uint32_t sel;          // __byte_perm selector of this lane's column
  const float* m;        // the R multipliers, in shared memory (0 past n)

  __device__ __forceinline__ Tile(const T* p_, const float* m_, int64_t d_,
                                  int64_t row0_, int64_t n_)
      : p(p_), d(d_), row0(row0_), m(m_) {
    const int lane = threadIdx.x & 31;
    const int64_t row = row0 + lane / kRowWords;
    word = (const uint32_t*)p + row * (d / kCols) + lane % kRowWords;
#pragma unroll
    for (int k = 0; k < kWords; ++k) live[k] = row + k * kCols < n_;
    // int8: byte lane % 4 under the exponent byte 0x4B of 2^23; bf16: half
    // lane % 2 moved into the upper half
    sel = sizeof(T) == 1 ? 0x7440u | (lane & 3)
                         : ((lane & 1) ? 0x3244u : 0x1044u);
  }

  // The lane's words of the group at column c0 (a multiple of 32), 0 past
  // n: word k is kCols rows, d words, below word 0.  Nothing here uses the
  // loaded values, so the loads stay in flight until unpack().
  __device__ __forceinline__ void fetch(Words& out, int64_t c0) const {
    const uint32_t* q = word + c0 / kCols;
#pragma unroll
    for (int k = 0; k < kWords; ++k) out.w[k] = live[k] ? __ldg(q + k * d) : 0u;
  }

  __device__ __forceinline__ float decode(uint32_t v) const {
    if constexpr (sizeof(T) == 1) {
      return __fsub_rn(__uint_as_float(__byte_perm(v, 0x4B000000u, sel)), 8388736.0f);
    } else {
      return __uint_as_float(__byte_perm(v, 0u, sel));
    }
  }

  // a[r]: row r at this lane's column of the group, from the lane that holds
  // the word (row r, column / kCols).
  __device__ __forceinline__ void unpack(const Words& in, float (&a)[R]) const {
    const int lane = threadIdx.x & 31;
    uint32_t w[kWords];
#pragma unroll
    for (int k = 0; k < kWords; ++k) w[k] = in.w[k] ^ kBias;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint32_t v = __shfl_sync(0xffffffffu, w[r / kCols],
                                     (r % kCols) * kRowWords + lane / kCols);
      a[r] = __fmul_rn(decode(v), shared_at(m + r));
    }
  }

  // Row `row` (below n) at column c, element by element (the templates'
  // per-element loop).
  __device__ __forceinline__ float load(int64_t row, int64_t c) const {
    return __fmul_rn(widen(__ldg(p + row * d + c)), shared_at(m + (row - row0)));
  }
};

// The whole groups of 32 columns of this warp's walk from column c (one
// lane's; stride apart) while they lie inside d: step(a, b) for each
// group's unpacked words, then the next group's words are loaded.  Returns
// the lane's first column not walked.  Every branch is warp-uniform.
template <bool SAME, class TA, class TB, class Step>
__device__ __forceinline__ int64_t walk_words(const TA& ta, const TB& tb, int64_t c,
                                              int64_t d, int64_t stride, Step& step) {
  const int lane = threadIdx.x & 31;
  int64_t c0 = c - lane;
  if (c0 + 32 > d) return c;
  // the warp's whole groups; the load after the last reloads it (a cache
  // hit, never used), so the loop carries no branch around its loads
  const int groups = (int)((d - 32 - c0) / stride) + 1;
  typename TA::Words wa;
  typename TB::Words wb;
  ta.fetch(wa, c0);
  if constexpr (!SAME) tb.fetch(wb, c0);
#pragma unroll 1
  for (int g = 1; g <= groups; ++g) {
    float a[TA::kRows];
    ta.unpack(wa, a);
    if constexpr (SAME) {
      step(a, a);
    } else {
      float b[TB::kRows];
      tb.unpack(wb, b);
      step(a, b);
    }
    const int64_t next = g < groups ? c0 + stride : c0;
    ta.fetch(wa, next);
    if constexpr (!SAME) tb.fetch(wb, next);
    c0 += stride;
  }
  return c0 + lane;
}

template <class T>
struct DequantRows {
  static constexpr bool kWalksColumns = true;
  static constexpr int kCols = sizeof(T) < 4 ? 4 / sizeof(T) : 1;
  const T* p;
  const float* mult;
  int64_t d;
  bool words;  // rows start on 4-byte words: the packed loads may run

  static DequantRows make(const void* p, const void* mult, int64_t d) {
    return {(const T*)p, (const float*)mult, d,
            kCols > 1 && (uintptr_t)p % 4 == 0 && d % kCols == 0};
  }

  // The packed walk of this thread's columns (stats_tile::elements): from
  // column c, stride apart, step(a, b) for every column it can walk, with a
  // the RA rows i0.. of this payload (< na) and b the RB rows j0.. of
  // `other` (< nb); SAME: b is a (other, j0 and nb are this, i0, na).
  // Advances c past them and returns the tiles, whose element loads walk
  // the rest in the template's loop.
  template <int RA, int RB, bool SAME, class Step>
  __device__ __forceinline__ auto columns(const DequantRows& other, int64_t i0,
                                          int64_t na, int64_t j0, int64_t nb,
                                          int64_t& c, int64_t stride, Step& step) const {
    // the tiles' multipliers, 0 past n, read by the lanes as a broadcast:
    // in registers they would take the SM from two blocks to one
    __shared__ float s_mult[RA + RB];
    if (threadIdx.x < RA) {
      s_mult[threadIdx.x] = i0 + threadIdx.x < na ? __ldg(mult + i0 + threadIdx.x) : 0.0f;
    } else if (threadIdx.x < RA + RB) {
      const int64_t r = j0 + threadIdx.x - RA;
      s_mult[threadIdx.x] = r < nb ? __ldg(other.mult + r) : 0.0f;
    }
    __syncthreads();
    const Tile<T, RA> ta(p, s_mult, d, i0, na);
    const Tile<T, RB> tb(other.p, s_mult + RA, d, j0, nb);
    // a tile of more accumulators than the symmetric 16-row tile's 136 (the
    // rectangular (8, 16) tile: 152) leaves no registers for the words
    constexpr int kAcc = SAME ? RA * (RA + 1) / 2 : RA * RB + RA + RB;
    if constexpr (kCols > 1 && kAcc <= 136) {
      if (words && other.words) c = walk_words<SAME>(ta, tb, c, d, stride, step);
    }
    return stats_tile::Tiles<Tile<T, RA>, Tile<T, RB>>{ta, tb};
  }
};

}  // namespace dequant_rows
