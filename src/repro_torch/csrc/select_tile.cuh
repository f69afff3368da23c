// The Bulyan coordinate phase of one coordinate, shared by K2
// (fused_select.cu) and K3 (coord_select.cu).
//
// Given the theta extracted values ext[] and the theta aggregated values
// agr[] of one coordinate, held in registers (TMAX = 8, 16 or 32 unrolled
// slots, guarded by the runtime theta):
//   med = theta-median of ext, by stable rank (midpoint of the middle pair
//         for even theta);
//   out = mean of the beta agr values nearest med, by rank counting with
//         ties to the lower row; the sum is taken in row order, each
//         operation rounded on its own (__fadd_rn, __fdiv_rn).
// K2 forms ext/agr by its in-register contraction, K3 loads them from the
// materialised (theta, d) g_ext/g_agr.  Everything after that is this one
// function, so the two substrates can differ only through the contraction,
// and the plain version in kernels/ref.py reproduces both bit for bit.
// ext[] is overwritten with the distances to the median.
#pragma once

#include <cuda_runtime.h>

namespace select_tile {

template <int TMAX>
__device__ __forceinline__ float select_coordinate(float (&ext)[TMAX],
                                                   const float (&agr)[TMAX],
                                                   int theta, int beta) {
  // theta-median: sorted[r] is the value of stable rank r
  const int h = theta / 2;
  float lo = 0.0f, hi = 0.0f;
#pragma unroll
  for (int t = 0; t < TMAX; ++t) {
    if (t < theta) {
      int r = 0;
#pragma unroll
      for (int k = 0; k < TMAX; ++k) {
        if (k < theta) r += (ext[k] < ext[t]) || (k < t && ext[k] == ext[t]);
      }
      if (r == h) hi = ext[t];
      if (r == h - 1) lo = ext[t];
    }
  }
  const float med = (theta & 1) ? hi : __fmul_rn(0.5f, __fadd_rn(lo, hi));

  // beta nearest to med by rank counting, ties to the lower index
#pragma unroll
  for (int t = 0; t < TMAX; ++t) ext[t] = fabsf(__fsub_rn(agr[t], med));
  float s = 0.0f;
#pragma unroll
  for (int t = 0; t < TMAX; ++t) {
    if (t < theta) {
      int r = 0;
#pragma unroll
      for (int k = 0; k < TMAX; ++k) {
        if (k < theta) r += (ext[k] < ext[t]) || (k < t && ext[k] == ext[t]);
      }
      if (r < beta) s = __fadd_rn(s, agr[t]);
    }
  }
  return __fdiv_rn(s, (float)beta);
}

}  // namespace select_tile
