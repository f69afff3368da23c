// The rectangular statistics template of K6 (pairwise_stats_rect.cu) and
// K7 (dequant_stats_rect.cu, on K5's loader in dequant_rows.cuh), and the
// loader of K6 and K4 (pairwise_sqdist.cu), on K1's template
// (stats_tile.cuh).
//
// A rank of the mesh holds its (n_loc, d) row block and the gathered
// (n_full, d) stack.  One grid of d-chunks computes the partial grams of
// every local row against every full row, and the self products of both;
// a second kernel sums the chunks in chunk order into the raw (n_loc,
// n_full) block sq_l + sq_f - 2 g (unclamped, diagonal kept) and the
// (n_full,) squared norms.  Each element repeats K1's arithmetic for the
// same two rows exactly:
//   * the chunk count is K1's for the true worker count (the wrapper takes
//     it from launch_config(n, d)), so the 256-thread grid-stride column
//     walk (stats_tile.cuh's tile_pair) visits the same columns in each
//     thread, and a loader that walks its own columns
//     (stats_tile::walks_columns) keeps that walk;
//   * each thread accumulates fmaf(x_i[c], x_j[c], acc) in column order
//     (fmaf(a, b, c) == fmaf(b, a, c): the operands' order is free);
//   * the block reduces with stats_tile::warp_sum, then sums the warps in
//     warp order from 0, into its chunk's slot of the scratch;
//   * the finalize sums the chunks in chunk order with __fadd_rn and forms
//     (si + sj) - 2 g as K1's finalize_kernel does; the norms are the
//     self products (K1's gram diagonal), not a separate sum of squares.
// None of this depends on the register tile, so the tiles here are free
// to differ from K1's: the block equals K1's matching rows bit for bit.
//
// Scratch: (chunks, n_loc, n_full) cross partials, (chunks, n_loc) and
// (chunks, n_full) self partials; never (chunks, n, n).  Rows past a
// tile's end are exact zeros in registers.  All offsets are 64-bit.
//
// The view path (K6 only: an fp32 stack that fits one full tile, n_full
// <= 16, and a block that is rows r0 .. r0 + n_loc of it, as on the mesh
// path): slot k of the full tile holds stack row view_row(k), the block's
// rows first, so each thread loads each stack row once a column and reads
// the block's rows out of those registers (a compile-time slot), with no
// local self products of their own: a local row's self product is the
// full slot's, the same fmaf chain.  Slots past n_full repeat a real row
// (no predicate in the loop); their products are never stored.  Its
// finalize (rect_finalize_staged_kernel) forms rect_finalize_kernel's sums
// with each thread's loads in flight together.
#pragma once

#include <cuda_pipeline.h>

#include "stats_tile.cuh"

namespace stats_rect {

using stats_tile::kThreads;
using stats_tile::kWarps;
using stats_tile::warp_sum;
using stats_tile::widen;

// An (n, d) stack widened to fp32: for float, K1's loader
// (pairwise_stats.cu, F32Rows); bf16 widens exactly.
template <class T>
struct Rows {
  const T* x;
  int64_t d;
  __device__ __forceinline__ float load(int64_t row, int64_t col) const {
    return widen(__ldg(x + row * d + col));
  }
};

// The view path's slot order: slot k < n_loc holds the block's row r0 + k,
// the other slots the stack's other rows in ascending order.
__device__ __forceinline__ int64_t view_row(int64_t k, int64_t n_loc, int64_t r0) {
  return k < n_loc ? r0 + k : (k < n_loc + r0 ? k - n_loc : k);
}

// One block: local rows i0..i0+RL against full rows j0..j0+RF over the
// columns of chunk `chunk` (K1's blockIdx.x).  The block of the first full
// tile writes the local rows' self products, the block of the first local
// tile the full rows'.  AT >= 0: the view path (loc is full, a Rows<float>
// stack of at most RF rows, the block rows r0 .. r0 + n_loc of it), the
// local tile's rows in slots AT .. AT + RL of the full tile (AT == i0).
template <int RL, int RF, int AT = -1, class Loc, class Full>
__device__ void rect_pair(const Loc& loc, const Full& full,
                          float* __restrict__ part_g, float* __restrict__ part_l,
                          float* __restrict__ part_f, int64_t n_loc,
                          int64_t n_full, int64_t d, int64_t i0, int64_t j0,
                          int64_t chunk, int64_t chunks, bool local_norms,
                          bool full_norms, int64_t r0 = 0) {
  constexpr bool kView = AT >= 0;
  constexpr int kCross = RL * RF;
  constexpr int kLocal = kView ? 0 : RL;
  constexpr int kSlots = kCross + kLocal + RF;
  float acc[kCross];
  float sl[RL];
  float sf[RF];
#pragma unroll
  for (int p = 0; p < kCross; ++p) acc[p] = 0.0f;
#pragma unroll
  for (int r = 0; r < RL; ++r) sl[r] = 0.0f;
#pragma unroll
  for (int r = 0; r < RF; ++r) sf[r] = 0.0f;

  // One column's products: local rows a, full rows b.
  auto step = [&](const float (&a)[RL], const float (&b)[RF]) {
#pragma unroll
    for (int i = 0; i < RL; ++i) {
#pragma unroll
      for (int j = 0; j < RF; ++j) acc[i * RF + j] = fmaf(a[i], b[j], acc[i * RF + j]);
    }
#pragma unroll
    for (int r = 0; r < RL; ++r) sl[r] = fmaf(a[r], a[r], sl[r]);
#pragma unroll
    for (int r = 0; r < RF; ++r) sf[r] = fmaf(b[r], b[r], sf[r]);
  };

  const int64_t stride = chunks * (int64_t)kThreads;
  int64_t c = chunk * kThreads + threadIdx.x;
  if constexpr (kView) {
    const float* ptr[RF];
#pragma unroll
    for (int k = 0; k < RF; ++k) {
      ptr[k] = full.x + view_row(k < n_full ? k : n_full - 1, n_loc, r0) * d + c;
    }
    for (; c < d; c += stride) {
      float b[RF];
#pragma unroll
      for (int k = 0; k < RF; ++k) {
        b[k] = __ldg(ptr[k]);
        ptr[k] += stride;
      }
#pragma unroll
      for (int i = 0; i < RL; ++i) {
        if (AT + i < RF) {  // past the tile: rows the block does not hold
#pragma unroll
          for (int k = 0; k < RF; ++k) acc[i * RF + k] = fmaf(b[AT + i], b[k], acc[i * RF + k]);
        }
      }
#pragma unroll
      for (int k = 0; k < RF; ++k) sf[k] = fmaf(b[k], b[k], sf[k]);
    }
  } else {
    const auto e =
        stats_tile::elements<RL, RF, false>(loc, full, i0, n_loc, j0, n_full, c, stride, step);
    const auto& la = stats_tile::loader<0>(e, loc);
    const auto& lb = stats_tile::loader<1>(e, full);
    for (; c < d; c += stride) {
      float a[RL];
      float b[RF];
#pragma unroll
      for (int r = 0; r < RL; ++r) a[r] = (i0 + r < n_loc) ? la.load(i0 + r, c) : 0.0f;
#pragma unroll
      for (int r = 0; r < RF; ++r) b[r] = (j0 + r < n_full) ? lb.load(j0 + r, c) : 0.0f;
      step(a, b);
    }
  }

  __shared__ float red[kWarps][kSlots];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int p = 0; p < kCross; ++p) {
    const float v = warp_sum(acc[p]);
    if (lane == 0) red[warp][p] = v;
  }
  if constexpr (!kView) {
#pragma unroll
    for (int r = 0; r < RL; ++r) {
      const float v = warp_sum(sl[r]);
      if (lane == 0) red[warp][kCross + r] = v;
    }
  }
#pragma unroll
  for (int r = 0; r < RF; ++r) {
    const float v = warp_sum(sf[r]);
    if (lane == 0) red[warp][kCross + kLocal + r] = v;
  }
  __syncthreads();

  for (int p = threadIdx.x; p < kSlots; p += kThreads) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += red[w][p];
    if constexpr (kView) {
      // slot k to its stack row; the block's rows are slots 0 .. n_loc
      if (p < kCross) {
        const int64_t gi = i0 + p / RF;
        const int64_t k = p % RF;
        if (gi < n_loc && k < n_full) {
          part_g[(chunk * n_loc + gi) * n_full + view_row(k, n_loc, r0)] = s;
        }
      } else {
        const int64_t k = p - kCross;
        if (full_norms && k < n_full) {
          part_f[chunk * n_full + view_row(k, n_loc, r0)] = s;
          if (k < n_loc) part_l[chunk * n_loc + k] = s;
        }
      }
    } else if (p < kCross) {
      const int64_t gi = i0 + p / RF;
      const int64_t gj = j0 + p % RF;
      if (gi < n_loc && gj < n_full) part_g[(chunk * n_loc + gi) * n_full + gj] = s;
    } else if (p < kCross + RL) {
      const int64_t gi = i0 + (p - kCross);
      if (local_norms && gi < n_loc) part_l[chunk * n_loc + gi] = s;
    } else {
      const int64_t gj = j0 + (p - kCross - RL);
      if (full_norms && gj < n_full) part_f[chunk * n_full + gj] = s;
    }
  }
}

// blockIdx.x enumerates the tile pairs (I, J) of ceil(n_loc / RL) local
// tiles x ceil(n_full / RF) full tiles, row-major, and blockIdx.y the
// chunks: the pairs of one chunk are neighbours in launch order, so they
// run together and share the chunk's columns in L2.  Tiles of at most 48
// cross accumulators are held to 128 registers, two blocks an SM, unless
// the loader walks its own columns: K7's (4, 12) tile and its packed words
// spill at 128 registers, so it runs one block.
template <int RL, int RF, class Loc, class Full>
__global__ void __launch_bounds__(kThreads,
                                  (RL * RF <= 48 && !stats_tile::walks_columns<Loc>) ? 2 : 1)
rect_gram_kernel(const Loc loc, const Full full, float* __restrict__ part_g,
                 float* __restrict__ part_l, float* __restrict__ part_f,
                 int64_t n_loc, int64_t n_full, int64_t d, int64_t chunks) {
  const int64_t tiles_full = (n_full + RF - 1) / RF;
  const int64_t I = (int64_t)blockIdx.x / tiles_full;
  const int64_t J = (int64_t)blockIdx.x % tiles_full;
  rect_pair<RL, RF>(loc, full, part_g, part_l, part_f, n_loc, n_full, d,
                    I * RL, J * RF, blockIdx.y, chunks, J == 0, I == 0);
}

// The view path: one full tile (n_full <= RF), blockIdx.x the local tile I
// (at most two: n_loc <= n_full <= RF), blockIdx.y the chunk.  Tile I's
// rows sit in slots I * RL .. of the full tile, a compile-time offset, so
// tile 1 is its own instantiation.  The launch bound is the rectangular
// grid's.
template <int RL, int RF>
__global__ void __launch_bounds__(kThreads, RL * RF <= 48 ? 2 : 1)
rect_view_kernel(const Rows<float> full, float* __restrict__ part_g,
                 float* __restrict__ part_l, float* __restrict__ part_f,
                 int64_t n_loc, int64_t n_full, int64_t d, int64_t chunks,
                 int64_t r0) {
  if constexpr (RL < RF) {
    if (blockIdx.x == 1) {
      rect_pair<RL, RF, RL>(full, full, part_g, part_l, part_f, n_loc, n_full, d,
                            RL, 0, blockIdx.y, chunks, true, false, r0);
      return;
    }
  }
  rect_pair<RL, RF, 0>(full, full, part_g, part_l, part_f, n_loc, n_full, d, 0,
                       0, blockIdx.y, chunks, true, true, r0);
}

// dists[i, j] = (sl_i + sf_j) - 2 g_ij with every sum over chunks in chunk
// order (K1's finalize_kernel on one row block); norms[j] = sf_j.
__global__ void rect_finalize_kernel(const float* __restrict__ part_g,
                                     const float* __restrict__ part_l,
                                     const float* __restrict__ part_f,
                                     float* __restrict__ dists,
                                     float* __restrict__ norms, int64_t n_loc,
                                     int64_t n_full, int64_t chunks) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_loc * n_full) return;
  const int64_t i = idx / n_full;
  const int64_t j = idx % n_full;
  float g = 0.0f, si = 0.0f, sj = 0.0f;
  for (int64_t c = 0; c < chunks; ++c) {
    g = __fadd_rn(g, part_g[c * n_loc * n_full + idx]);
    si = __fadd_rn(si, part_l[c * n_loc + i]);
    sj = __fadd_rn(sj, part_f[c * n_full + j]);
  }
  dists[idx] = __fsub_rn(__fadd_rn(si, sj), __fmul_rn(2.0f, g));
  if (i == 0) norms[j] = sj;
}

// rect_finalize_kernel's sums in the same order, for the view path: that
// kernel's chunk loop waits on each chunk's three loads in turn (1056
// times on the main path's leaves, one thread a cell).  Here each thread
// copies kSeg chunks' values of its cell to shared memory with cp.async,
// all in flight at once, then sums them in chunk order.  A template:
// compiled only where it is launched.
constexpr int kFinalizeThreads = 64;

template <int kSeg>
__global__ void __launch_bounds__(kFinalizeThreads)
rect_finalize_staged_kernel(const float* __restrict__ part_g,
                            const float* __restrict__ part_l,
                            const float* __restrict__ part_f,
                            float* __restrict__ dists, float* __restrict__ norms,
                            int64_t n_loc, int64_t n_full, int64_t chunks) {
  __shared__ float stage[3][kSeg][kFinalizeThreads];
  const int t = threadIdx.x;
  const int64_t cells = n_loc * n_full;
  const int64_t idx = (int64_t)blockIdx.x * kFinalizeThreads + t;
  if (idx >= cells) return;
  const int64_t i = idx / n_full;
  const int64_t j = idx % n_full;
  float g = 0.0f, si = 0.0f, sj = 0.0f;
  for (int64_t c0 = 0; c0 < chunks; c0 += kSeg) {
    const int m = (int)(chunks - c0 < kSeg ? chunks - c0 : kSeg);
    for (int u = 0; u < m; ++u) {
      __pipeline_memcpy_async(&stage[0][u][t], part_g + (c0 + u) * cells + idx, 4);
      __pipeline_memcpy_async(&stage[1][u][t], part_l + (c0 + u) * n_loc + i, 4);
      __pipeline_memcpy_async(&stage[2][u][t], part_f + (c0 + u) * n_full + j, 4);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    for (int u = 0; u < m; ++u) {
      g = __fadd_rn(g, stage[0][u][t]);
      si = __fadd_rn(si, stage[1][u][t]);
      sj = __fadd_rn(sj, stage[2][u][t]);
    }
  }
  dists[idx] = __fsub_rn(__fadd_rn(si, sj), __fmul_rn(2.0f, g));
  if (i == 0) norms[j] = sj;
}

// The (tile_loc, tile_full) pairs the kernels are compiled for: calls
// launch(Tile<RL, RF>{}) for the pair asked for; false for any other.
template <int RL, int RF>
struct Tile {
  static constexpr int kLocal = RL;
  static constexpr int kFull = RF;
};

template <class Launch>
bool with_tile(int64_t tile_loc, int64_t tile_full, Launch&& launch) {
  if (tile_loc == 4 && tile_full == 8) {
    launch(Tile<4, 8>{});
  } else if (tile_loc == 4 && tile_full == 12) {
    launch(Tile<4, 12>{});
  } else if (tile_loc == 4 && tile_full == 16) {
    launch(Tile<4, 16>{});
  } else if (tile_loc == 8 && tile_full == 8) {
    launch(Tile<8, 8>{});
  } else if (tile_loc == 8 && tile_full == 12) {
    launch(Tile<8, 12>{});
  } else if (tile_loc == 8 && tile_full == 16) {
    launch(Tile<8, 16>{});
  } else {
    return false;
  }
  return true;
}

// Both kernels on `s`.  part_g: (chunks, n_loc, n_full), part_l: (chunks,
// n_loc), part_f: (chunks, n_full) fp32 scratch; dists: (n_loc, n_full);
// norms: (n_full,).  tile_loc is 4 or 8, tile_full 8, 12 or 16.  Returns
// cudaGetLastError() (0 on success).
template <class Loc, class Full>
int launch_rect(const Loc& loc, const Full& full, void* part_g, void* part_l,
                void* part_f, void* dists, void* norms, int64_t n_loc,
                int64_t n_full, int64_t d, int64_t chunks, int64_t tile_loc,
                int64_t tile_full, cudaStream_t s) {
  const int64_t pairs = ((n_loc + tile_loc - 1) / tile_loc) *
                        ((n_full + tile_full - 1) / tile_full);
  if (n_loc <= 0 || n_full <= 0 || d <= 0 || chunks <= 0 || chunks > 65535 ||
      pairs > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid((unsigned)pairs, (unsigned)chunks);
  float* pg = (float*)part_g;
  float* pl = (float*)part_l;
  float* pf = (float*)part_f;
  const bool known = with_tile(tile_loc, tile_full, [&](auto t) {
    using T = decltype(t);
    rect_gram_kernel<T::kLocal, T::kFull><<<grid, kThreads, 0, s>>>(
        loc, full, pg, pl, pf, n_loc, n_full, d, chunks);
  });
  if (!known) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t cells = n_loc * n_full;
  const int threads = 256;
  rect_finalize_kernel<<<(unsigned)((cells + threads - 1) / threads), threads, 0, s>>>(
      pg, pl, pf, (float*)dists, (float*)norms, n_loc, n_full, chunks);
  return (int)cudaGetLastError();
}

// The view path's kernels on `s`: the block is rows r0 .. r0 + n_loc of the
// fp32 stack `full`, which fits one full tile (n_full <= tile_full).
// Scratch, outputs and tiles as for launch_rect.  A template, so that only
// the sources that launch the view path compile its kernels.
template <class Full>
int launch_rect_view(const Full& full, void* part_g, void* part_l, void* part_f,
                     void* dists, void* norms, int64_t n_loc, int64_t n_full,
                     int64_t d, int64_t chunks, int64_t tile_loc,
                     int64_t tile_full, int64_t r0, cudaStream_t s) {
  const int64_t tiles_loc = (n_loc + tile_loc - 1) / tile_loc;
  if (n_loc <= 0 || n_full <= 0 || n_full > tile_full || r0 < 0 ||
      r0 + n_loc > n_full || tiles_loc > 2 || d <= 0 || chunks <= 0 ||
      chunks > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid((unsigned)tiles_loc, (unsigned)chunks);
  float* pg = (float*)part_g;
  float* pl = (float*)part_l;
  float* pf = (float*)part_f;
  const bool known = with_tile(tile_loc, tile_full, [&](auto t) {
    using T = decltype(t);
    rect_view_kernel<T::kLocal, T::kFull><<<grid, kThreads, 0, s>>>(
        full, pg, pl, pf, n_loc, n_full, d, chunks, r0);
  });
  if (!known) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks =
      (unsigned)((n_loc * n_full + kFinalizeThreads - 1) / kFinalizeThreads);
  rect_finalize_staged_kernel<32><<<blocks, kFinalizeThreads, 0, s>>>(
      pg, pl, pf, (float*)dists, (float*)norms, n_loc, n_full, chunks);
  return (int)cudaGetLastError();
}

}  // namespace stats_rect
