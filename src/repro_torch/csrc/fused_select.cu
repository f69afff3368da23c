// K2: the fused multi-Bulyan apply phase over an (n, d) fp32 stack.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fused_select.py::fused_select_pallas
// (body _kernel / _select_tile): per coordinate j,
//   ext = w_ext @ x[:, j],  agr = w_agr @ x[:, j]          (theta values each)
//   med = theta-median of ext (midpoint of the middle pair for even theta)
//   out[j] = mean of the beta agr values nearest med, ties to the lower row.
//
// Bound on an H100: bytes.  The kernel must read the stack once and write
// d floats.  What stands between it and that bound is instruction issue:
// each of the theta x n products and sums of a contraction is its own
// instruction (no fused multiply-add, so that the plain version matches
// bit for bit), 4 theta n of them a coordinate, 220 at the main path's
// n = 11, theta = 5.  Design:
//   * compiled for the exact theta (1 <= theta <= 16, one instantiation
//     each): the theta extracted and theta aggregated values of a
//     coordinate sit in registers with no guarded slots, and the
//     coordinate phase (select_tile.cuh, shared with K3) is a sorting
//     network the compiler prunes to the median's exchanges;
//   * C = 2 coordinates a thread (one above theta = 16), j, j + 32,
//     ... within a warp's tile of 32 C columns, so every load is a
//     coalesced 128-byte row segment that needs no alignment of the row
//     (rows start at i d floats; d may be odd), and one broadcast of a
//     (w_ext, w_agr) weight pair from shared memory serves all of a
//     thread's coordinates;
//   * the rows stream kRows = 8 at a time: their loads are issued together
//     (one row pointer, advanced by d; no guard but in a warp's last,
//     partial tile), then each row is contracted in row order, every
//     product and sum rounded on its own (__fmul_rn, __fadd_rn), so the
//     plain PyTorch version in kernels/ref.py reproduces the output bit for
//     bit.  No row is skipped for a zero weight: 0 x inf is NaN here, in
//     the plain version and in JAX;
//   * 17 <= theta <= 32 keeps one coordinate a thread over 32 register
//     slots guarded by the runtime theta (the same phase on NaN-padded
//     slots);
//   * theta > 32 (the counted variant, any theta): one coordinate a
//     thread, kCountThreads a block.  Its theta extracted and theta
//     aggregated values cannot sit in registers, and 8 theta bytes a
//     coordinate in shared memory would cap theta at what one block's
//     threads can hold, so they go to a global scratch the wrapper
//     allocates for the launch (fused_select_scratch_floats says its
//     size), one column per thread of the grid, the grid sized so that
//     the scratch stays within the 50 MB L2.  The
//     contractions run kCands slots at a time, accumulators in registers,
//     while the coordinate's rows stream past (the stack read theta /
//     kCands times; the block's rows are hot in L1 / L2 after the first
//     pass), the slots' (w_ext, w_agr) pairs staged in shared memory
//     kCountRows rows at a time: so the weights, theta n 8 bytes (260 KB
//     at n = 256, theta = 128), never need to fit in shared memory.  The
//     products and sums keep the row order and their rounding, as above;
//     then the coordinate phase by counting (select_count.cuh, shared
//     with K3's variant) reads the column back;
//   * 64-bit offsets: an embedding leaf stack holds > 2^31 values.
#include <cuda_runtime.h>
#include <stdint.h>

#include "select_count.cuh"
#include "select_tile.cuh"

namespace {

constexpr int kThreads = 256;

// Coordinates a thread of the exact kernels (theta <= 16; one above) and
// rows whose loads are in flight together: the fastest pair on the main
// path of 1, 2, 4 coordinates x 4, 8 rows (PERF.md, K2).
constexpr int kCoords = 2, kRows = 8;

template <int THETA>
constexpr int coords_per_thread() {
  return THETA <= 16 ? kCoords : 1;
}

// The weights in shared memory, one (w_ext, w_agr) pair per (row, slot):
// sw[i * theta + t].
__device__ __forceinline__ void stage_weights(const float* __restrict__ w_ext,
                                              const float* __restrict__ w_agr,
                                              float2* sw, int n, int theta) {
  for (int k = threadIdx.x; k < theta * n; k += blockDim.x) {
    const int i = k / theta, t = k % theta;
    sw[k] = make_float2(w_ext[(int64_t)t * n + i], w_agr[(int64_t)t * n + i]);
  }
  __syncthreads();
}

// Slots [0, S) of `theta` slots (S = theta, or 32 with the runtime theta).
template <int S, int C>
__device__ __forceinline__ void contract_row(const float2* __restrict__ w,
                                             const float (&v)[C],
                                             float (&ext)[C][S],
                                             float (&agr)[C][S], int theta) {
#pragma unroll
  for (int t = 0; t < S; ++t) {
    if (t < theta) {
      const float2 we = w[t];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        ext[c][t] = __fadd_rn(ext[c][t], __fmul_rn(we.x, v[c]));
        agr[c][t] = __fadd_rn(agr[c][t], __fmul_rn(we.y, v[c]));
      }
    }
  }
}

// One warp tile, columns [j0 - lane, j0 - lane + 32 C): this thread's
// coordinates j0 + 32 c, c < C.  kFull: all of them lie below d, so no load
// needs a guard and each row's C loads share one address (immediate
// offsets).  The rows stream kRows at a time, the last n mod kRows after.
template <int S, int C, bool kFull>
__device__ __forceinline__ void columns(const float* __restrict__ x,
                                        const float2* __restrict__ sw,
                                        float* __restrict__ out, int n,
                                        int64_t d, int64_t j0, int theta,
                                        int beta) {
  bool in[C];
#pragma unroll
  for (int c = 0; c < C; ++c) in[c] = kFull || j0 + 32 * c < d;
  float ext[C][S], agr[C][S];
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int t = 0; t < S; ++t) {
      ext[c][t] = 0.0f;
      agr[c][t] = 0.0f;
    }
  }
  const float* row = x + j0;  // row i, advanced by d a row
  int i = 0;
  for (; i + kRows <= n; i += kRows) {
    float v[kRows][C];
#pragma unroll
    for (int r = 0; r < kRows; ++r, row += d) {
#pragma unroll
      for (int c = 0; c < C; ++c) v[r][c] = in[c] ? __ldg(row + 32 * c) : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      contract_row<S, C>(sw + (i + r) * theta, v[r], ext, agr, theta);
    }
  }
  if (i < n) {
    float v[kRows - 1][C];
#pragma unroll
    for (int r = 0; r < kRows - 1; ++r, row += d) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        v[r][c] = i + r < n && in[c] ? __ldg(row + 32 * c) : 0.0f;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows - 1; ++r) {
      if (i + r < n) {
        contract_row<S, C>(sw + (i + r) * theta, v[r], ext, agr, theta);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (in[c]) {
      out[j0 + 32 * c] =
          select_tile::select_coordinate<S>(ext[c], agr[c], theta, beta);
    }
  }
}

// S = THETA (exact) or 32 (runtime theta <= 32); C coordinates a thread.
template <int S, int C>
__global__ void __launch_bounds__(kThreads)
fused_select_kernel(const float* __restrict__ x, const float* __restrict__ w_ext,
                    const float* __restrict__ w_agr, float* __restrict__ out,
                    int n, int64_t d, int theta_arg, int beta) {
  // the exact kernels fold theta into every guard and index
  const int theta = S < 32 ? S : theta_arg;
  extern __shared__ float2 sw[];
  stage_weights(w_ext, w_agr, sw, n, theta);

  constexpr int64_t kTile = 32 * C;  // a warp's columns
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t j0 = warp * kTile + lane; j0 - lane < d; j0 += warps * kTile) {
    if (j0 - lane + kTile <= d) {
      columns<S, C, true>(x, sw, out, n, d, j0, theta, beta);
    } else {
      columns<S, C, false>(x, sw, out, n, d, j0, theta, beta);
    }
  }
}

template <int S, int C>
int launch(const float* x, const float* we, const float* wa, float* out, int n,
           int64_t d, int theta, int beta, int64_t max_blocks, cudaStream_t s) {
  const int64_t tiles = (d + 32 * C - 1) / (32 * C);
  const int64_t want = (tiles + kThreads / 32 - 1) / (kThreads / 32);
  const unsigned blocks = (unsigned)(want < max_blocks ? want : max_blocks);
  const size_t smem = (size_t)theta * n * sizeof(float2);
  fused_select_kernel<S, C><<<blocks, kThreads, smem, s>>>(x, we, wa, out, n, d,
                                                           theta, beta);
  return (int)cudaGetLastError();
}

using LaunchFn = int (*)(const float*, const float*, const float*, float*, int,
                         int64_t, int, int, int64_t, cudaStream_t);

// launch<theta, ...> for 1 <= theta <= 16
template <int... T>
LaunchFn exact_launch(int theta, std::integer_sequence<int, T...>) {
  LaunchFn fn = nullptr;
  ((fn = theta == T + 1 ? &launch<T + 1, coords_per_thread<T + 1>()> : fn), ...);
  return fn;
}

// theta > 32: one coordinate a thread, its theta ext and theta agr values
// in the scratch column of the thread (slot t at t * lanes), then the
// coordinate phase by counting.
constexpr int kCountThreads = 128;
constexpr int kCands = select_count::kCands;
// rows whose weight pairs are staged in shared memory at a time
constexpr int kCountRows = 32;

__global__ void __launch_bounds__(kCountThreads)
fused_select_count_kernel(const float* __restrict__ x,
                          const float* __restrict__ w_ext,
                          const float* __restrict__ w_agr,
                          float* __restrict__ out, float* scratch, int n,
                          int64_t d, int theta, int beta) {
  __shared__ float2 sw[kCountRows][kCands];
  const int64_t lanes = (int64_t)gridDim.x * blockDim.x;
  float* ext = scratch + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  float* agr = ext + (int64_t)theta * lanes;
  // every loop bound is the block's, so each thread reaches each
  // __syncthreads (a thread past d loads and stores nothing)
  for (int64_t j0 = (int64_t)blockIdx.x * blockDim.x; j0 < d; j0 += lanes) {
    const int64_t j = j0 + threadIdx.x;
    const bool in = j < d;
    for (int t0 = 0; t0 < theta; t0 += kCands) {
      float e[kCands], a[kCands];
#pragma unroll
      for (int u = 0; u < kCands; ++u) {
        e[u] = 0.0f;
        a[u] = 0.0f;
      }
      for (int i0 = 0; i0 < n; i0 += kCountRows) {
        __syncthreads();
        for (int k = threadIdx.x; k < kCountRows * kCands; k += blockDim.x) {
          const int u = k / kCountRows, r = k % kCountRows;
          const int i = i0 + r, t = t0 + u;
          const bool ok = i < n && t < theta;
          sw[r][u] = make_float2(ok ? w_ext[(int64_t)t * n + i] : 0.0f,
                                 ok ? w_agr[(int64_t)t * n + i] : 0.0f);
        }
        __syncthreads();
        const int rows = n - i0 < kCountRows ? n - i0 : kCountRows;
        const float* row = x + (int64_t)i0 * d + j;
        for (int r = 0; r < rows; ++r, row += d) {
          const float v = in ? __ldg(row) : 0.0f;
#pragma unroll
          for (int u = 0; u < kCands; ++u) {
            const float2 w = sw[r][u];
            e[u] = __fadd_rn(e[u], __fmul_rn(w.x, v));
            a[u] = __fadd_rn(a[u], __fmul_rn(w.y, v));
          }
        }
      }
      if (in) {
#pragma unroll
        for (int u = 0; u < kCands; ++u) {
          if (t0 + u < theta) {
            ext[(int64_t)(t0 + u) * lanes] = e[u];
            agr[(int64_t)(t0 + u) * lanes] = a[u];
          }
        }
      }
    }
    if (in) {
      out[j] = select_count::select_coordinate(
          select_count::Column<false>{ext, lanes},
          select_count::Column<false>{agr, lanes}, theta, beta);
    }
  }
}

// the counted variant's scratch is kept near this size, within the
// H100's 50 MB L2, by capping its grid; one block an SM (132) at least
constexpr int64_t kCountScratchBytes = 32 << 20;

// the counted variant's grid: a block a kCountThreads columns of d,
// capped so that its scratch (2 theta floats a thread) stays near
// kCountScratchBytes
int64_t count_blocks(int64_t d, int64_t theta) {
  const int64_t want = (d + kCountThreads - 1) / kCountThreads;
  int64_t cap = kCountScratchBytes / (8 * theta * kCountThreads);
  cap = cap > 132 ? cap : 132;
  return want < cap ? want : cap;
}

}  // namespace

// The floats of scratch the counted variant (theta > 32) needs for a
// (., d) stack: 2 theta a thread of its grid.  0 for theta <= 32, which
// takes none; -1 for d or theta out of range.
extern "C" int64_t fused_select_scratch_floats(int64_t d, int64_t theta) {
  if (d <= 0 || theta < 1 || theta > 0x7fffffff) return -1;
  if (theta <= 32) return 0;
  return 2 * theta * count_blocks(d, theta) * kCountThreads;
}

// x: (n, d) fp32 row-major; w_ext, w_agr: (theta, n) fp32; out: (d,) fp32.
// max_blocks caps the grid of the theta <= 32 kernels (a grid-stride loop
// covers the rest); 1 <= beta <= theta.  theta > 32 takes the counted
// variant, whose grid is count_blocks(d, theta) and whose scratch, of
// scratch_floats floats, the caller allocates: it must hold
// fused_select_scratch_floats(d, theta) (null and 0 for theta <= 32).
// *variant is set to the kernel taken: theta for the exact kernels
// (theta <= 16), 32 for the runtime-theta one, theta for the counted one
// (theta > 32).  Launches on `stream`; returns cudaGetLastError() (0 on
// success), cudaErrorInvalidValue for an argument out of range or a
// scratch too small.
extern "C" int fused_select_launch(const void* x, const void* w_ext,
                                   const void* w_agr, void* out,
                                   void* scratch, int64_t scratch_floats,
                                   int64_t n, int64_t d, int64_t theta,
                                   int64_t beta, int64_t max_blocks,
                                   void* stream, int32_t* variant) {
  *variant = 0;
  if (n <= 0 || n > 0x7fffffff || d <= 0 || theta < 1 ||
      theta > 0x7fffffff || beta < 1 || beta > theta || max_blocks <= 0 ||
      max_blocks > 0x7fffffff ||
      (theta <= 32 && (size_t)theta * n * sizeof(float2) > 48 * 1024) ||
      (theta > 32 &&
       (scratch == nullptr ||
        scratch_floats < fused_select_scratch_floats(d, theta)))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const float* xp = (const float*)x;
  const float* we = (const float*)w_ext;
  const float* wa = (const float*)w_agr;
  float* op = (float*)out;
  const int nn = (int)n, th = (int)theta, be = (int)beta;
  if (theta <= 16) {
    *variant = th;
    return exact_launch(th, std::make_integer_sequence<int, 16>{})(
        xp, we, wa, op, nn, d, th, be, max_blocks, s);
  }
  if (theta <= 32) {
    *variant = 32;
    return launch<32, coords_per_thread<32>()>(xp, we, wa, op, nn, d, th, be,
                                               max_blocks, s);
  }
  *variant = th;
  const unsigned blocks = (unsigned)count_blocks(d, theta);
  fused_select_count_kernel<<<blocks, kCountThreads, 0, s>>>(
      xp, we, wa, op, (float*)scratch, nn, d, th, be);
  return (int)cudaGetLastError();
}
