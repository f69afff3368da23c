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
// one a coordinate; the rank counts cost O(theta^2) integer compares, well
// below the card's rate at that byte count.  Design (K2's, without the
// contraction):
//   * one thread per coordinate (grid-stride); a warp reads 32 neighbouring
//     coordinates of each row, so every load is coalesced along d, and the
//     2 theta loads of a thread are independent (all in flight at once);
//   * the theta values of each input stay in registers (TMAX = 8, 16 or 32
//     unrolled slots, guarded by the runtime theta);
//   * the coordinate phase is select_tile.cuh's, the one K2 runs after its
//     contraction: same ranks, same row-order sum, same rounding, so the
//     plain PyTorch version in kernels/ref.py reproduces it bit for bit;
//   * 64-bit offsets: theta * d exceeds 2^31 on an embedding leaf.
#include <cuda_runtime.h>
#include <stdint.h>

#include "select_tile.cuh"

namespace {

constexpr int kThreads = 256;

template <int TMAX>
__global__ void __launch_bounds__(kThreads)
coord_select_kernel(const float* __restrict__ g_ext, const float* __restrict__ g_agr,
                    float* __restrict__ out, int64_t d, int theta, int beta) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < d; j += stride) {
    float ext[TMAX];
    float agr[TMAX];
#pragma unroll
    for (int t = 0; t < TMAX; ++t) {
      ext[t] = t < theta ? __ldg(g_ext + (int64_t)t * d + j) : 0.0f;
      agr[t] = t < theta ? __ldg(g_agr + (int64_t)t * d + j) : 0.0f;
    }
    out[j] = select_tile::select_coordinate<TMAX>(ext, agr, theta, beta);
  }
}

}  // namespace

// g_ext, g_agr: (theta, d) fp32 row-major; out: (d,) fp32.
// blocks: grid size (the wrapper's choice); 1 <= beta <= theta <= 32.
// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int coord_select_launch(const void* g_ext, const void* g_agr, void* out,
                                   int64_t d, int64_t theta, int64_t beta,
                                   int64_t blocks, void* stream) {
  if (d <= 0 || theta < 1 || theta > 32 || beta < 1 || beta > theta || blocks <= 0 ||
      blocks > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const float* ge = (const float*)g_ext;
  const float* ga = (const float*)g_agr;
  float* op = (float*)out;
  const int th = (int)theta, be = (int)beta;
  if (theta <= 8) {
    coord_select_kernel<8><<<(unsigned)blocks, kThreads, 0, s>>>(ge, ga, op, d, th, be);
  } else if (theta <= 16) {
    coord_select_kernel<16><<<(unsigned)blocks, kThreads, 0, s>>>(ge, ga, op, d, th, be);
  } else {
    coord_select_kernel<32><<<(unsigned)blocks, kThreads, 0, s>>>(ge, ga, op, d, th, be);
  }
  return (int)cudaGetLastError();
}
