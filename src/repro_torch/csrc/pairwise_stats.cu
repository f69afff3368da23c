// K1: single-pass pairwise statistics of an (n, d) fp32 gradient stack.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/pairwise_sqdist.py::pairwise_stats_pallas
// (body _stats_kernel / _stats_tile): raw ||a||^2 + ||b||^2 - 2<a, b>
// (unclamped, diagonal kept) and the (n,) squared row norms, one read of
// the stack.
//
// Bound on an H100: bytes.  At the main path's shape (n = 11, d up to
// 2.3e8) the kernel must read n*d*4 bytes once; the n^2*d multiply-adds
// are ~3.7x below the fp32 rate at that byte count.  Design:
//   * one thread per column (grid-stride): each thread loads the R values
//     of its column for the block's row tiles (coalesced along d across the
//     warp) and accumulates the R x R products in registers, so every
//     element is read from device memory exactly once per row-tile pair;
//   * the TPU kernel carried its (n, n) sum across a sequential grid; here
//     blocks run in parallel, so each block reduces its registers (warp
//     shuffles, then a fixed-order sum over warps) into its own slot of a
//     (chunks, n, n) scratch buffer, and a second kernel sums the chunks in
//     chunk order and forms sq_i + sq_j - 2 g_ij.  No atomics: the result
//     repeats bit for bit from run to run;
//   * any n: n <= 16 is one diagonal tile of R = 8, 12 or 16 rows (the
//     smallest that holds n: n = 11 keeps 78 accumulators a thread); larger
//     n is cut into tiles of 8 rows and the grid's y axis walks the tile
//     pairs (I <= J).  The paper's CUDA code stopped at n <= 24 because it
//     kept whole rows in shared memory;
//   * all offsets are 64-bit: an embedding leaf stack holds > 2^31 values.
// fp32 accumulation throughout (no TF32, no library GEMM).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One block: row tiles I (rows i0..i0+R) and J (rows j0..j0+R) over the
// columns of chunk blockIdx.x.  DIAG: I == J, only j >= i is accumulated.
template <int R, bool DIAG>
__device__ void tile_pair(const float* __restrict__ x, float* __restrict__ partial,
                          int64_t n, int64_t d, int64_t i0, int64_t j0,
                          int64_t chunks) {
  float acc[R * R];
#pragma unroll
  for (int p = 0; p < R * R; ++p) acc[p] = 0.0f;

  const int64_t stride = chunks * (int64_t)kThreads;
  for (int64_t c = (int64_t)blockIdx.x * kThreads + threadIdx.x; c < d; c += stride) {
    float a[R];
#pragma unroll
    for (int r = 0; r < R; ++r) a[r] = (i0 + r < n) ? x[(i0 + r) * d + c] : 0.0f;
    if constexpr (DIAG) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int j = i; j < R; ++j) acc[i * R + j] = fmaf(a[i], a[j], acc[i * R + j]);
      }
    } else {
      float b[R];
#pragma unroll
      for (int r = 0; r < R; ++r) b[r] = (j0 + r < n) ? x[(j0 + r) * d + c] : 0.0f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int j = 0; j < R; ++j) acc[i * R + j] = fmaf(a[i], b[j], acc[i * R + j]);
      }
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
template <int R, bool SINGLE_TILE>
__global__ void __launch_bounds__(kThreads)
partial_gram_kernel(const float* __restrict__ x, float* __restrict__ partial,
                    int64_t n, int64_t d, int64_t chunks) {
  if constexpr (SINGLE_TILE) {
    tile_pair<R, true>(x, partial, n, d, 0, 0, chunks);
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
      tile_pair<R, true>(x, partial, n, d, I * R, J * R, chunks);
    } else {
      tile_pair<R, false>(x, partial, n, d, I * R, J * R, chunks);
    }
  }
}

// dists[i, j] = (sq_i + sq_j) - 2 g_ij with g, sq summed over chunks in
// chunk order; the operation order is _stats_tile's.
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

}  // namespace

// x: (n, d) fp32 row-major; partial: (chunks, n, n) fp32 scratch;
// dists: (n, n) fp32; norms: (n,) fp32.  row_tile is the smallest of
// 8, 12, 16 that holds n for n <= 16, else 8.  Launches on `stream`; returns cudaGetLastError() (0 on
// success).
extern "C" int pairwise_stats_launch(const void* x, void* partial, void* dists,
                                     void* norms, int64_t n, int64_t d,
                                     int64_t chunks, int64_t row_tile,
                                     void* stream) {
  if (n <= 0 || d <= 0 || chunks <= 0 || chunks > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t tiles = (n + row_tile - 1) / row_tile;
  const int64_t pairs = tiles * (tiles + 1) / 2;
  const int64_t gy = pairs < 65535 ? pairs : 65535;
  const int64_t gz = (pairs + gy - 1) / gy;
  if (gz > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)chunks, (unsigned)gy, (unsigned)gz);
  if (row_tile == 16 && n <= 16) {
    partial_gram_kernel<16, true><<<grid, kThreads, 0, s>>>(
        (const float*)x, (float*)partial, n, d, chunks);
  } else if (row_tile == 12 && n <= 12) {
    partial_gram_kernel<12, true><<<grid, kThreads, 0, s>>>(
        (const float*)x, (float*)partial, n, d, chunks);
  } else if (row_tile == 8 && n <= 8) {
    partial_gram_kernel<8, true><<<grid, kThreads, 0, s>>>(
        (const float*)x, (float*)partial, n, d, chunks);
  } else if (row_tile == 8) {
    partial_gram_kernel<8, false><<<grid, kThreads, 0, s>>>(
        (const float*)x, (float*)partial, n, d, chunks);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t cells = n * n;
  const int threads = 256;
  finalize_kernel<<<(unsigned)((cells + threads - 1) / threads), threads, 0, s>>>(
      (const float*)partial, (float*)dists, (float*)norms, n, chunks);
  return (int)cudaGetLastError();
}
