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
// d floats; the 4*theta*n flops a coordinate costs are ~3x below the fp32
// rate at that byte count.  Design:
//   * one thread per coordinate (grid-stride); a warp reads 32 neighbouring
//     coordinates of each row, so every load is coalesced along d;
//   * the (theta, n) weight pair is copied into shared memory once per
//     block, rows padded to a multiple of 4 with zeros, and read as float4
//     broadcasts (one shared load per four multiply-adds);
//   * the theta extracted and theta aggregated values stay in registers
//     (TMAX = 8, 16 or 32 unrolled slots, guarded by the runtime theta);
//     the median and the beta-selection are rank counts over them
//     (select_tile.cuh, shared with K3), so no (theta, d) intermediate is
//     ever written to device memory;
//   * products and sums are rounded one operation at a time (__fmul_rn,
//     __fadd_rn: no fused multiply-add), in row order, so the plain PyTorch
//     version in kernels/ref.py reproduces the output bit for bit;
//   * 64-bit offsets: an embedding leaf stack holds > 2^31 values.
#include <cuda_runtime.h>
#include <stdint.h>

#include "select_tile.cuh"

namespace {

constexpr int kThreads = 256;

template <int TMAX>
__global__ void __launch_bounds__(kThreads)
fused_select_kernel(const float* __restrict__ x, const float* __restrict__ w_ext,
                    const float* __restrict__ w_agr, float* __restrict__ out,
                    int64_t n, int64_t d, int theta, int beta) {
  extern __shared__ float4 sw4[];
  const int nv = (int)((n + 3) / 4);  // float4s per weight row
  float* sw = reinterpret_cast<float*>(sw4);
  for (int k = threadIdx.x; k < theta * nv * 4; k += blockDim.x) {
    const int t = k / (nv * 4);
    const int i = k % (nv * 4);
    sw[k] = i < n ? w_ext[(int64_t)t * n + i] : 0.0f;
    sw[theta * nv * 4 + k] = i < n ? w_agr[(int64_t)t * n + i] : 0.0f;
  }
  __syncthreads();
  const float4* we4 = sw4;
  const float4* wa4 = sw4 + theta * nv;

  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < d; j += stride) {
    float ext[TMAX];
    float agr[TMAX];
#pragma unroll
    for (int t = 0; t < TMAX; ++t) {
      ext[t] = 0.0f;
      agr[t] = 0.0f;
    }
    for (int q = 0; q < nv; ++q) {
      const int64_t i = 4 * (int64_t)q;
      // padded rows add (+0 * 0) = +0, which leaves a sum that never
      // holds -0 unchanged
      const float v0 = x[i * d + j];
      const float v1 = i + 1 < n ? x[(i + 1) * d + j] : 0.0f;
      const float v2 = i + 2 < n ? x[(i + 2) * d + j] : 0.0f;
      const float v3 = i + 3 < n ? x[(i + 3) * d + j] : 0.0f;
#pragma unroll
      for (int t = 0; t < TMAX; ++t) {
        if (t < theta) {
          const float4 we = we4[t * nv + q];
          const float4 wa = wa4[t * nv + q];
          float e = ext[t], a = agr[t];
          e = __fadd_rn(e, __fmul_rn(we.x, v0));
          a = __fadd_rn(a, __fmul_rn(wa.x, v0));
          e = __fadd_rn(e, __fmul_rn(we.y, v1));
          a = __fadd_rn(a, __fmul_rn(wa.y, v1));
          e = __fadd_rn(e, __fmul_rn(we.z, v2));
          a = __fadd_rn(a, __fmul_rn(wa.z, v2));
          e = __fadd_rn(e, __fmul_rn(we.w, v3));
          a = __fadd_rn(a, __fmul_rn(wa.w, v3));
          ext[t] = e;
          agr[t] = a;
        }
      }
    }

    out[j] = select_tile::select_coordinate<TMAX>(ext, agr, theta, beta);
  }
}

}  // namespace

// x: (n, d) fp32 row-major; w_ext, w_agr: (theta, n) fp32; out: (d,) fp32.
// blocks: grid size (the wrapper's choice); 1 <= beta <= theta <= 32.
// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int fused_select_launch(const void* x, const void* w_ext, const void* w_agr,
                                   void* out, int64_t n, int64_t d, int64_t theta,
                                   int64_t beta, int64_t blocks, void* stream) {
  if (n <= 0 || d <= 0 || theta < 1 || theta > 32 || beta < 1 || beta > theta ||
      blocks <= 0 || blocks > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = 2 * (size_t)theta * (size_t)((n + 3) / 4) * sizeof(float4);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* xp = (const float*)x;
  const float* we = (const float*)w_ext;
  const float* wa = (const float*)w_agr;
  float* op = (float*)out;
  const int th = (int)theta, be = (int)beta;
  if (theta <= 8) {
    fused_select_kernel<8><<<(unsigned)blocks, kThreads, smem, s>>>(xp, we, wa, op, n, d, th, be);
  } else if (theta <= 16) {
    fused_select_kernel<16><<<(unsigned)blocks, kThreads, smem, s>>>(xp, we, wa, op, n, d, th, be);
  } else {
    fused_select_kernel<32><<<(unsigned)blocks, kThreads, smem, s>>>(xp, we, wa, op, n, d, th, be);
  }
  return (int)cudaGetLastError();
}
