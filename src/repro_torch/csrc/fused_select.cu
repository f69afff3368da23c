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
//   * 32 < theta <= 128 (the network variant): kWideCoords = 2
//     coordinates a thread, laid out as above.  The coordinate's column
//     (theta ext and theta agr values, 8 theta bytes) lies in the block's
//     shared memory, [t][thread] (select_count.cuh), and is the
//     contractions' accumulator.  The rows stream kWideRows at a time into
//     registers, each loaded from device memory once, their (w_ext, w_agr)
//     pairs staged in shared memory by cp.async (so the weights, theta n 8
//     bytes, never need to fit there); the next chunk's rows and weights
//     load while this chunk computes (two weight buffers, one
//     __syncthreads a chunk).  The slots are contracted in passes of
//     kWidePass, the last passes 8, 4, 2 and 1 wide as theta leaves them
//     (34 = 16 + 16 + 2), each pass's accumulators in registers over the
//     chunk's rows, read from and written back to the column.  One
//     broadcast float4 holds two slots' pairs, 16 products and sums at 2
//     coordinates; a pass after the first reads the rows from registers,
//     never from L2.  Then the coordinate phase on the column
//     (select_count.cuh: select_tile's network and threshold over the
//     bucket's S slots).  The column bounds the warps an SM holds (at
//     most 13 at theta = 34, 3 at 128); wide_threads gives the block size;
//   * theta > 128 (the counted variant, any theta): one coordinate a
//     thread, kCountThreads a block.  Its theta extracted and theta
//     aggregated values go to a global scratch the wrapper allocates for
//     the launch (fused_select_scratch_floats says its size), one column
//     per thread of the grid, the grid sized so that the scratch stays
//     within the 50 MB L2.  The contractions run kCands slots at a time,
//     accumulators in registers, while the coordinate's rows stream past
//     (the stack read theta / kCands times; the block's rows are hot in L1
//     / L2 after the first pass), the slots' (w_ext, w_agr) pairs staged
//     in shared memory kCountRows rows at a time.  Then the coordinate
//     phase by counting (select_count.cuh, shared with K3's variant) reads
//     the column back;
//   * in every variant the products and sums keep the row order and their
//     rounding, as above;
//   * 64-bit offsets: an embedding leaf stack holds > 2^31 values.
#include <cuda_pipeline.h>
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

// 32 < theta <= 128, in the bucket (L, S]: the network variant.
// Threads a block of the bucket of S slots: 4 warps up to 48 slots, 2 up
// to 96, 3 at 128.  At theta = 128 a column is 1 KB a coordinate, so 4
// warps' would not fit in a block's shared memory.  3 warps in every
// bucket ran 17-49 % slower at theta 33-49 and within 6 % at 64-96
// (tools/time_k1.py --thetas against this choice on one card; PERF.md
// keeps the runs).
__host__ __device__ constexpr int wide_threads(int S) {
  return S <= 48 ? 128 : S <= 96 ? 64 : 96;
}
constexpr int kWideCoords = 2;
// rows in registers at a time; slots a pass (the last passes narrower)
constexpr int kWideRows = 8;
constexpr int kWidePass = 16;

// the staged weight pairs' row stride: theta rounded up to even, so that
// the pairs of slots t, t + 1 (t even) load as one aligned float4
__host__ __device__ __forceinline__ int wide_row_stride(int theta) {
  return (theta + 1) & ~1;
}

// bytes of shared memory of a network variant's block of `threads`
// threads: two buffers of the weight pairs of kWideRows rows, then the
// column (ext, then agr) of every coordinate (at most 208 KB, theta = 128)
size_t wide_smem_bytes(int theta, int threads) {
  return (size_t)2 * kWideRows * wide_row_stride(theta) * sizeof(float2) +
         (size_t)2 * theta * kWideCoords * threads * sizeof(float);
}

// Rows [i0, i0 + kWideRows) of this thread's columns j0 + 32 c, each value
// loaded once (zeros past n and past d).
__device__ __forceinline__ void load_rows(float (&v)[kWideRows][kWideCoords],
                                          const float* __restrict__ x, int n,
                                          int64_t d, int64_t j0, int i0) {
  const float* row = x + (int64_t)i0 * d + j0;
#pragma unroll
  for (int r = 0; r < kWideRows; ++r, row += d) {
#pragma unroll
    for (int c = 0; c < kWideCoords; ++c) {
      v[r][c] = i0 + r < n && j0 + 32 * c < d ? __ldg(row + 32 * c) : 0.0f;
    }
  }
}

// The (w_ext, w_agr) pairs of rows [i0, i0 + kWideRows) below n into
// sw[r stride + t] by cp.async, the block's T threads together.
template <int T>
__device__ __forceinline__ void stage_weights_async(
    float2* sw, const float* __restrict__ w_ext,
    const float* __restrict__ w_agr, int n, int theta, int stride, int i0) {
  for (int k = threadIdx.x; k < kWideRows * theta; k += T) {
    const int t = k / kWideRows, r = k % kWideRows;
    if (i0 + r < n) {
      float2* dst = sw + r * stride + t;
      __pipeline_memcpy_async(&dst->x, w_ext + (int64_t)t * n + i0 + r, 4);
      __pipeline_memcpy_async(&dst->y, w_agr + (int64_t)t * n + i0 + r, 4);
    }
  }
}

// Slots [g0, g0 + P) of this thread's kWideCoords coordinates over the
// chunk's first `rows` rows (v: their values), every product and sum in
// row order; the accumulators start at 0 on the first chunk, else are read
// from the column (slot t of coordinate c at (t kWideCoords + c) T, T the
// block's threads), and are written back.
template <int P, int T>
__device__ __forceinline__ void wide_pass(
    float* __restrict__ ext, float* __restrict__ agr,
    const float2* __restrict__ sw, int stride, int g0,
    const float (&v)[kWideRows][kWideCoords], int rows, bool first) {
  constexpr int C = kWideCoords;
  float e[C][P], a[C][P];
#pragma unroll
  for (int u = 0; u < P; ++u) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int k = ((g0 + u) * C + c) * T;
      e[c][u] = first ? 0.0f : ext[k];
      a[c][u] = first ? 0.0f : agr[k];
    }
  }
#pragma unroll
  for (int r = 0; r < kWideRows; ++r) {
    if (r < rows) {
      const float2* w = sw + r * stride + g0;
      if constexpr (P == 1) {
        const float2 q = w[0];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          e[c][0] = __fadd_rn(e[c][0], __fmul_rn(q.x, v[r][c]));
          a[c][0] = __fadd_rn(a[c][0], __fmul_rn(q.y, v[r][c]));
        }
      } else {
#pragma unroll
        for (int u = 0; u < P; u += 2) {
          const float4 q = *reinterpret_cast<const float4*>(w + u);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            e[c][u] = __fadd_rn(e[c][u], __fmul_rn(q.x, v[r][c]));
            a[c][u] = __fadd_rn(a[c][u], __fmul_rn(q.y, v[r][c]));
            e[c][u + 1] = __fadd_rn(e[c][u + 1], __fmul_rn(q.z, v[r][c]));
            a[c][u + 1] = __fadd_rn(a[c][u + 1], __fmul_rn(q.w, v[r][c]));
          }
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < P; ++u) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int k = ((g0 + u) * C + c) * T;
      ext[k] = e[c][u];
      agr[k] = a[c][u];
    }
  }
}

// The block's steps are (tile b0, chunk i0) pairs, tile by tile (a
// grid-stride loop over tiles of kWideCoords T columns), each tile's chunks
// of kWideRows rows in order; step s + 1's rows (registers) and weights
// (the other buffer, cp.async) are in flight while step s computes, and
// one __syncthreads ends a step.  Every bound is the block's, so each thread
// reaches each __syncthreads (a thread past d loads zeros and stores
// nothing).
template <int L, int S, int T = wide_threads(S)>
__global__ void __launch_bounds__(T)
fused_select_wide_kernel(const float* __restrict__ x,
                         const float* __restrict__ w_ext,
                         const float* __restrict__ w_agr,
                         float* __restrict__ out, int n, int64_t d, int theta,
                         int beta) {
  constexpr int C = kWideCoords, R = kWideRows;
  constexpr int64_t kTile = 32 * C;  // a warp's columns
  constexpr int64_t kBlockCols = (int64_t)C * T;
  extern __shared__ float4 wide_smem[];
  const int stride = wide_row_stride(theta);
  float2* sw = reinterpret_cast<float2*>(wide_smem);
  float* ext = reinterpret_cast<float*>(sw + 2 * R * stride) + threadIdx.x;
  float* agr = ext + theta * C * T;
  const int64_t lane_col = (threadIdx.x >> 5) * kTile + (threadIdx.x & 31);
  const int64_t tiles_step = (int64_t)gridDim.x * kBlockCols;
  const float nan = __int_as_float(0x7fffffff);
  int64_t b0 = (int64_t)blockIdx.x * kBlockCols;
  if (b0 >= d) return;
  int i0 = 0, buf = 0;
  float v[R][C];
  load_rows(v, x, n, d, b0 + lane_col, 0);
  stage_weights_async<T>(sw, w_ext, w_agr, n, theta, stride, 0);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  for (;;) {
    const int64_t j0 = b0 + lane_col;  // columns j0 + 32 c
    int64_t next_b0 = b0;
    int next_i0 = i0 + R;
    if (next_i0 >= n) {
      next_i0 = 0;
      next_b0 += tiles_step;
    }
    const bool more = next_b0 < d;
    float vn[R][C];
    if (more) {
      load_rows(vn, x, n, d, next_b0 + lane_col, next_i0);
      stage_weights_async<T>(sw + (buf ^ 1) * R * stride, w_ext, w_agr, n,
                             theta, stride, next_i0);
    }
    __pipeline_commit();
    const float2* cur = sw + buf * R * stride;
    const int rows = n - i0 < R ? n - i0 : R;
    const bool first = i0 == 0;
    int g0 = 0;
    for (; g0 + kWidePass <= theta; g0 += kWidePass) {
      wide_pass<kWidePass, T>(ext, agr, cur, stride, g0, v, rows, first);
    }
    if (theta - g0 >= 8) {
      wide_pass<8, T>(ext, agr, cur, stride, g0, v, rows, first);
      g0 += 8;
    }
    if (theta - g0 >= 4) {
      wide_pass<4, T>(ext, agr, cur, stride, g0, v, rows, first);
      g0 += 4;
    }
    if (theta - g0 >= 2) {
      wide_pass<2, T>(ext, agr, cur, stride, g0, v, rows, first);
      g0 += 2;
    }
    if (theta - g0 >= 1) {
      wide_pass<1, T>(ext, agr, cur, stride, g0, v, rows, first);
    }
    if (i0 + R >= n) {
      // the tile's last chunk: the coordinate phase, one coordinate at a
      // time (the network's code stands once)
#pragma unroll 1
      for (int c = 0; c < C; ++c) {
        if (j0 + 32 * c < d) {
          float e[S];
#pragma unroll
          for (int t = 0; t < S; ++t) {
            e[t] = t < theta ? ext[(t * C + c) * T] : nan;
          }
          const float med = select_count::network_median<L, S>(e, theta);
          out[j0 + 32 * c] = select_count::nearest_mean<S>(
              select_count::Column<false>{agr + c * T, C * T},
              med, theta, beta);
        }
      }
    }
    if (!more) break;
    __pipeline_wait_prior(0);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int c = 0; c < C; ++c) v[r][c] = vn[r][c];
    }
    b0 = next_b0;
    i0 = next_i0;
    buf ^= 1;
  }
}

// The network variant's launch at theta in the bucket (L, S] on the
// current card (select_count::WideShapes).
template <int L, int S>
cudaError_t wide_shape(int theta, select_count::WideShape* shape) {
  static select_count::WideShapes<L, S> shapes;
  constexpr int T = wide_threads(S);
  return shapes.get(&fused_select_wide_kernel<L, S>, T,
                    [](int t) { return wide_smem_bytes(t, T); }, theta,
                    shape);
}

template <int L, int S>
int launch_wide(const float* x, const float* we, const float* wa, float* out,
                int n, int64_t d, int theta, int beta, cudaStream_t s) {
  select_count::WideShape shape;
  const cudaError_t err = wide_shape<L, S>(theta, &shape);
  if (err != cudaSuccess) return (int)err;
  const int64_t cols = (int64_t)kWideCoords * shape.threads;
  fused_select_wide_kernel<L, S>
      <<<shape.grid((d + cols - 1) / cols), shape.threads, shape.smem, s>>>(
          x, we, wa, out, n, d, theta, beta);
  return (int)cudaGetLastError();
}

// theta > 128: one coordinate a thread, its theta ext and theta agr values
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
      out[j] = select_count::ranked_coordinate(
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

// The floats of scratch the counted variant (theta > 128) needs for a
// (., d) stack: 2 theta a thread of its grid.  0 for theta <= 128, which
// takes none; -1 for d or theta out of range.
extern "C" int64_t fused_select_scratch_floats(int64_t d, int64_t theta) {
  if (d <= 0 || theta < 1 || theta > 0x7fffffff) return -1;
  if (theta <= select_count::kMaxWide) return 0;
  return 2 * theta * count_blocks(d, theta) * kCountThreads;
}

// The network variant's launch at theta (32 < theta <= 128) on the
// current card: the slots of its bucket, its threads a block, the shared
// memory a block uses and the blocks an SM holds at once.
// cudaErrorInvalidValue for a theta it does not take.
extern "C" int fused_select_wide_shape(int64_t theta, int32_t* slots,
                                       int32_t* threads, int64_t* smem_bytes,
                                       int32_t* blocks_per_sm) {
  if (theta <= 32 || theta > select_count::kMaxWide) {
    return (int)cudaErrorInvalidValue;
  }
  select_count::WideShape shape;
  cudaError_t err = cudaSuccess;
  select_count::for_bucket((int)theta, [&](auto L, auto S) {
    err = wide_shape<decltype(L)::value, decltype(S)::value>((int)theta,
                                                             &shape);
  });
  *slots = shape.slots;
  *threads = shape.threads;
  *smem_bytes = (int64_t)shape.smem;
  *blocks_per_sm = shape.per_sm;
  return (int)err;
}

// x: (n, d) fp32 row-major; w_ext, w_agr: (theta, n) fp32; out: (d,) fp32.
// max_blocks caps the grid of the theta <= 32 kernels (a grid-stride loop
// covers the rest); 1 <= beta <= theta.  32 < theta <= 128 takes the
// network variant, whose grid is what the card holds at once.  theta > 128
// takes the counted variant, whose grid is count_blocks(d, theta) and
// whose scratch, of scratch_floats floats, the caller allocates: it must
// hold fused_select_scratch_floats(d, theta) (null and 0 for theta <=
// 128).  *variant is set to the kernel taken: theta for the exact kernels
// (theta <= 16), 32 for the runtime-theta one, theta for the network and
// the counted ones (theta > 32).  Launches on `stream`; returns
// cudaGetLastError() (0 on success), cudaErrorInvalidValue for an
// argument out of range or a scratch too small.
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
      (theta > select_count::kMaxWide &&
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
  if (theta <= select_count::kMaxWide) {
    *variant = select_count::kNetworkVariant;
    int err = 0;
    select_count::for_bucket(th, [&](auto L, auto S) {
      err = launch_wide<decltype(L)::value, decltype(S)::value>(
          xp, we, wa, op, nn, d, th, be, s);
    });
    return err;
  }
  *variant = select_count::kCountedVariant;
  const unsigned blocks = (unsigned)count_blocks(d, theta);
  fused_select_count_kernel<<<blocks, kCountThreads, 0, s>>>(
      xp, we, wa, op, (float*)scratch, nn, d, th, be);
  return (int)cudaGetLastError();
}
