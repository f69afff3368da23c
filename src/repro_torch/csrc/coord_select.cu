// K3: the Bulyan coordinate phase over materialised (theta, d) fp32
// g_ext / g_agr (the two-step apply: the contractions ran before, as
// plain matrix products).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/coord_select.py::coord_select_pallas
// (body _kernel): per coordinate j,
//   med = theta-median of g_ext[:, j] (midpoint of the middle pair for even
//         theta)
//   out[j] = mean of the beta g_agr[:, j] values nearest med, ties to the
//            lower row.
//
// Bound on an H100: bytes.  The kernel must read 2 theta values and write
// one a coordinate; the coordinate phase is a sorting network of a few
// instructions a value, well below the card's rate at that byte count.
// Design (K2's, without the contraction):
//   * one thread per coordinate (grid-stride); a warp reads 32 neighbouring
//     coordinates of each row, so every load is coalesced along d, and the
//     2 theta loads of a thread are independent (all in flight at once);
//   * compiled for the exact theta up to 16, as K2 is; 17 <= theta <= 32
//     runs over 32 register slots guarded by the runtime theta;
//   * the coordinate phase is select_tile.cuh's, the one K2 runs after its
//     contraction: same median, same selection, same row-order sum, same
//     rounding, so the plain PyTorch version in kernels/ref.py reproduces
//     it bit for bit;
//   * theta > 32 (the counted variant, any theta): one thread per
//     coordinate as above, but no register slots: the coordinate phase by
//     counting (select_count.cuh, shared with K2's variant) ranks straight
//     from the coordinate's (theta, d) columns, kCands candidates at a
//     time against all theta values read through the read-only cache
//     (the block's columns stay hot in L1 between the passes);
//   * 64-bit offsets: theta * d exceeds 2^31 on an embedding leaf.
#include <cuda_runtime.h>
#include <stdint.h>

#include "select_count.cuh"
#include "select_tile.cuh"

namespace {

constexpr int kThreads = 256;

// S = theta (exact) or 32 (runtime theta <= 32)
template <int S>
__global__ void __launch_bounds__(kThreads)
coord_select_kernel(const float* __restrict__ g_ext, const float* __restrict__ g_agr,
                    float* __restrict__ out, int64_t d, int theta_arg, int beta) {
  const int theta = S < 32 ? S : theta_arg;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < d; j += stride) {
    float ext[S];
    float agr[S];
#pragma unroll
    for (int t = 0; t < S; ++t) {
      ext[t] = t < theta ? __ldg(g_ext + (int64_t)t * d + j) : 0.0f;
      agr[t] = t < theta ? __ldg(g_agr + (int64_t)t * d + j) : 0.0f;
    }
    out[j] = select_tile::select_coordinate<S>(ext, agr, theta, beta);
  }
}

using LaunchFn = void (*)(const float*, const float*, float*, int64_t, int, int,
                          unsigned, cudaStream_t);

template <int S>
void launch(const float* ge, const float* ga, float* out, int64_t d, int theta,
            int beta, unsigned blocks, cudaStream_t s) {
  coord_select_kernel<S><<<blocks, kThreads, 0, s>>>(ge, ga, out, d, theta, beta);
}

// launch<theta> for 1 <= theta <= 16
template <int... T>
LaunchFn exact_launch(int theta, std::integer_sequence<int, T...>) {
  LaunchFn fn = nullptr;
  ((fn = theta == T + 1 ? &launch<T + 1> : fn), ...);
  return fn;
}

// theta > 32: the coordinate phase by counting on the inputs' columns
__global__ void __launch_bounds__(kThreads)
coord_select_count_kernel(const float* __restrict__ g_ext,
                          const float* __restrict__ g_agr,
                          float* __restrict__ out, int64_t d, int theta,
                          int beta) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < d; j += stride) {
    out[j] = select_count::select_coordinate(
        select_count::Column<true>{g_ext + j, d},
        select_count::Column<true>{g_agr + j, d}, theta, beta);
  }
}

}  // namespace

// g_ext, g_agr: (theta, d) fp32 row-major; out: (d,) fp32.
// blocks: grid size (the wrapper's choice); 1 <= beta <= theta.  *variant
// is set to the kernel taken: theta for the exact kernels (theta <= 16),
// 32 for the runtime-theta one, theta for the counted one (theta > 32).
// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int coord_select_launch(const void* g_ext, const void* g_agr, void* out,
                                   int64_t d, int64_t theta, int64_t beta,
                                   int64_t blocks, void* stream, int32_t* variant) {
  *variant = 0;
  if (d <= 0 || theta < 1 || theta > 0x7fffffff || beta < 1 || beta > theta ||
      blocks <= 0 || blocks > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const float* ge = (const float*)g_ext;
  const float* ga = (const float*)g_agr;
  float* op = (float*)out;
  const int th = (int)theta, be = (int)beta;
  if (theta > 32) {
    *variant = th;
    coord_select_count_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(ge, ga, op, d, th,
                                                                    be);
    return (int)cudaGetLastError();
  }
  *variant = theta <= 16 ? th : 32;
  const LaunchFn fn = theta <= 16
      ? exact_launch(th, std::make_integer_sequence<int, 16>{}) : &launch<32>;
  fn(ge, ga, op, d, th, be, (unsigned)blocks, s);
  return (int)cudaGetLastError();
}
