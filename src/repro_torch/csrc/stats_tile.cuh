// The pairwise statistics template shared by K1 (pairwise_stats.cu) and
// K5 (dequant_stats.cu, on the loader of dequant_rows.cuh).
//
// One grid of d-chunks computes the partial grams of an (n, d) stack whose
// rows come from a loader; a second kernel sums the chunks in a fixed order
// and forms the raw sq_i + sq_j - 2 g_ij (unclamped, diagonal kept) and the
// (n,) squared norms.  A loader is a small struct with
//   __device__ float load(int64_t row, int64_t col) const;
// that returns the fp32 value of one element (K1's reads an fp32 stack).
// A loader that declares kWalksColumns (K5's, dequant_rows.cuh) first
// walks the columns it can itself (elements()): it calls the template's
// per-column step with the same columns in the same order, loading them
// as it chooses, and hands the rest to the per-element loop.  Either
// way everything else (grid, chunk count, register tiles, the order of
// every fp32 operation) is this one template, so K5 on a payload equals
// K1 on the decoded stack bit for bit.
//
// Design (bound on an H100: bytes):
//   * one thread per column (grid-stride): each thread loads the R values
//     of its column for the block's row tiles (coalesced along d across the
//     warp) and accumulates the R x R products in registers, so every
//     element is read from device memory once per row-tile pair;
//   * blocks run in parallel, so each block reduces its registers (warp
//     shuffles, then a fixed-order sum over warps) into its own slot of a
//     (chunks, n, n) scratch buffer, and the finalize kernel sums the chunks
//     in chunk order.  No atomics: results repeat bit for bit;
//   * any n: n <= 16 is one diagonal tile of R = 8, 12 or 16 rows; larger n
//     is cut into tiles of 8 rows and the grid's y (and z) axes walk the
//     tile pairs (I <= J).  Rows past n are exact zeros in registers;
//   * all offsets are 64-bit: an embedding leaf stack holds > 2^31 values.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace stats_tile {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(int8_t v) { return (float)v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// Whether a loader walks its own columns (a compile-time property: the
// loaders without kWalksColumns keep the per-element loop as it was).
template <class Rows, class = void>
constexpr bool walks_columns = false;
template <class Rows>
constexpr bool walks_columns<Rows, std::void_t<decltype(Rows::kWalksColumns)>> =
    Rows::kWalksColumns;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The loaders of a tile pair's per-element column walk.  A loader that
// walks its own columns (K5's) first walks what it can from this thread's
// column c: it calls step() for those columns, advances c past them and
// returns the Tiles that load the rest.  Any other loader (K1's, K4's,
// K6's) walks nothing and loads its own elements (Own): the loop reads
// that loader directly, since a returned struct of references to it changes
// the registers of K6's (4, 12) kernel.
struct Own {};
template <class A, class B>
struct Tiles {
  A a;
  B b;
};

template <int RA, int RB, bool SAME, class LA, class LB, class Step>
__device__ __forceinline__ auto elements(const LA& la, const LB& lb, int64_t ia,
                                         int64_t na, int64_t ib, int64_t nb,
                                         int64_t& c, int64_t stride, Step& step) {
  if constexpr (walks_columns<LA>) {
    return la.template columns<RA, RB, SAME>(lb, ia, na, ib, nb, c, stride, step);
  } else {
    return Own{};
  }
}

// The element loader of row tile K (0: a, 1: b) after elements(): its
// tile, or the template's own loader l.
template <int K, class E, class L>
__device__ __forceinline__ const auto& loader(const E& e, const L& l) {
  if constexpr (std::is_same_v<E, Own>) {
    return l;
  } else if constexpr (K == 0) {
    return e.a;
  } else {
    return e.b;
  }
}

// One block: row tiles I (rows i0..i0+R) and J (rows j0..j0+R) over the
// columns of chunk blockIdx.x.  DIAG: I == J, only j >= i is accumulated.
template <int R, bool DIAG, class Rows>
__device__ void tile_pair(const Rows& rows, float* __restrict__ partial,
                          int64_t n, int64_t d, int64_t i0, int64_t j0,
                          int64_t chunks) {
  float acc[R * R];
#pragma unroll
  for (int p = 0; p < R * R; ++p) acc[p] = 0.0f;

  // One column's products: rows a of tile I, rows b of tile J (b is a on
  // the diagonal).
  auto step = [&](const float (&a)[R], const float (&b)[R]) {
    if constexpr (DIAG) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int j = i; j < R; ++j) acc[i * R + j] = fmaf(a[i], a[j], acc[i * R + j]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int j = 0; j < R; ++j) acc[i * R + j] = fmaf(a[i], b[j], acc[i * R + j]);
      }
    }
  };

  const int64_t stride = chunks * (int64_t)kThreads;
  int64_t c = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const auto e = elements<R, R, DIAG>(rows, rows, i0, n, j0, n, c, stride, step);
  const auto& la = loader<0>(e, rows);
  const auto& lb = loader<1>(e, rows);
  for (; c < d; c += stride) {
    float a[R];
#pragma unroll
    for (int r = 0; r < R; ++r) a[r] = (i0 + r < n) ? la.load(i0 + r, c) : 0.0f;
    if constexpr (DIAG) {
      step(a, a);
    } else {
      float b[R];
#pragma unroll
      for (int r = 0; r < R; ++r) b[r] = (j0 + r < n) ? lb.load(j0 + r, c) : 0.0f;
      step(a, b);
    }
  }

  __shared__ float red[kWarps][R * R];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int p = 0; p < R * R; ++p) {
    if (DIAG && (p % R) < (p / R)) continue;
    const float v = warp_sum(acc[p]);
    if (lane == 0) red[warp][p] = v;
  }
  __syncthreads();

  float* out = partial + (int64_t)blockIdx.x * n * n;
  for (int p = threadIdx.x; p < R * R; p += kThreads) {
    const int i = p / R;
    const int j = p % R;
    if (DIAG && j < i) continue;
    const int64_t gi = i0 + i;
    const int64_t gj = j0 + j;
    if (gi >= n || gj >= n) continue;
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += red[w][p];
    out[gi * n + gj] = s;
    out[gj * n + gi] = s;
  }
}

// SINGLE_TILE: n <= R, one diagonal tile (the main path: n = 11, R = 12,
// 78 live accumulators).  Otherwise blockIdx.z * gridDim.y + blockIdx.y
// enumerates the tile pairs (I, J), I <= J, row-major; off-diagonal pairs
// hold R*R accumulators, so only R = 8 is instantiated for them.
template <int R, bool SINGLE_TILE, class Rows>
__device__ __forceinline__ void partial_gram(const Rows& rows, float* __restrict__ partial,
                                             int64_t n, int64_t d, int64_t chunks) {
  if constexpr (SINGLE_TILE) {
    tile_pair<R, true>(rows, partial, n, d, 0, 0, chunks);
  } else {
    const int64_t tiles = (n + R - 1) / R;
    int64_t rem = (int64_t)blockIdx.z * gridDim.y + blockIdx.y;
    if (rem >= tiles * (tiles + 1) / 2) return;  // the last z row's tail
    int64_t I = 0;
    while (rem >= tiles - I) {
      rem -= tiles - I;
      ++I;
    }
    const int64_t J = I + rem;
    if (I == J) {
      tile_pair<R, true>(rows, partial, n, d, I * R, J * R, chunks);
    } else {
      tile_pair<R, false>(rows, partial, n, d, I * R, J * R, chunks);
    }
  }
}

template <int R, bool SINGLE_TILE, class Rows>
__global__ void __launch_bounds__(kThreads)
partial_gram_kernel(const Rows rows, float* __restrict__ partial, int64_t n,
                    int64_t d, int64_t chunks) {
  partial_gram<R, SINGLE_TILE>(rows, partial, n, d, chunks);
}

// The same for a loader that walks its own columns (K5's), held to two
// blocks an SM at a single tile of at most 12 rows: its 78 accumulators
// and the packed words fit in 128 registers, and a second block is what
// pays (PERF.md, PR 19).  partial_gram_kernel must not carry this bound:
// even a bound of one block changes how ptxas allocates K1's registers.
template <int R, bool SINGLE_TILE, class Rows>
__global__ void __launch_bounds__(kThreads, SINGLE_TILE && R <= 12 ? 2 : 1)
partial_gram_bounded_kernel(const Rows rows, float* __restrict__ partial, int64_t n,
                            int64_t d, int64_t chunks) {
  partial_gram<R, SINGLE_TILE>(rows, partial, n, d, chunks);
}

template <int R, bool SINGLE_TILE, class Rows>
void launch_partial_gram(dim3 grid, cudaStream_t s, const Rows& rows, float* part,
                         int64_t n, int64_t d, int64_t chunks) {
  if constexpr (walks_columns<Rows>) {
    partial_gram_bounded_kernel<R, SINGLE_TILE><<<grid, kThreads, 0, s>>>(rows, part, n, d, chunks);
  } else {
    partial_gram_kernel<R, SINGLE_TILE><<<grid, kThreads, 0, s>>>(rows, part, n, d, chunks);
  }
}

// dists[i, j] = (sq_i + sq_j) - 2 g_ij with g, sq summed over chunks in
// chunk order; the operation order is the Pallas _stats_tile's.
__global__ void finalize_kernel(const float* __restrict__ partial,
                                float* __restrict__ dists, float* __restrict__ norms,
                                int64_t n, int64_t chunks) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * n) return;
  const int64_t i = idx / n;
  const int64_t j = idx % n;
  float g = 0.0f, si = 0.0f, sj = 0.0f;
  for (int64_t c = 0; c < chunks; ++c) {
    const float* p = partial + c * n * n;
    g = __fadd_rn(g, p[i * n + j]);
    si = __fadd_rn(si, p[i * n + i]);
    sj = __fadd_rn(sj, p[j * n + j]);
  }
  dists[idx] = __fsub_rn(__fadd_rn(si, sj), __fmul_rn(2.0f, g));
  if (i == j) norms[i] = si;
}

// Both kernels on `stream` for the rows of `rows`.  partial: (chunks, n, n)
// fp32 scratch; dists: (n, n) fp32; norms: (n,) fp32.  row_tile is the
// smallest of 8, 12, 16 that holds n for n <= 16, else 8.  Returns
// cudaGetLastError() (0 on success).
template <class Rows>
int launch_stats(const Rows& rows, void* partial, void* dists, void* norms,
                 int64_t n, int64_t d, int64_t chunks, int64_t row_tile,
                 cudaStream_t s) {
  if (n <= 0 || d <= 0 || chunks <= 0 || chunks > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t tiles = (n + row_tile - 1) / row_tile;
  const int64_t pairs = tiles * (tiles + 1) / 2;
  const int64_t gy = pairs < 65535 ? pairs : 65535;
  const int64_t gz = (pairs + gy - 1) / gy;
  if (gz > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)chunks, (unsigned)gy, (unsigned)gz);
  float* part = (float*)partial;
  if (row_tile == 16 && n <= 16) {
    launch_partial_gram<16, true>(grid, s, rows, part, n, d, chunks);
  } else if (row_tile == 12 && n <= 12) {
    launch_partial_gram<12, true>(grid, s, rows, part, n, d, chunks);
  } else if (row_tile == 8 && n <= 8) {
    launch_partial_gram<8, true>(grid, s, rows, part, n, d, chunks);
  } else if (row_tile == 8) {
    launch_partial_gram<8, false>(grid, s, rows, part, n, d, chunks);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t cells = n * n;
  const int threads = 256;
  finalize_kernel<<<(unsigned)((cells + threads - 1) / threads), threads, 0, s>>>(
      part, (float*)dists, (float*)norms, n, chunks);
  return (int)cudaGetLastError();
}

}  // namespace stats_tile
