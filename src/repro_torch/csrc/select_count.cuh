// The Bulyan coordinate phase of one coordinate for any theta, by counting:
// shared by the theta > 32 variants of K2 (fused_select.cu) and K3
// (coord_select.cu).  select_tile.cuh holds theta <= 32 values in register
// slots; this takes every theta, as the Pallas kernels do.
//
// Given the theta extracted values ext(t) and the theta aggregated values
// agr(t) of one coordinate, read through a Column (a strided column of
// device memory: K2's scratch, or K3's (theta, d) inputs):
//   med = theta-median of ext, the value of the middle order statistic
//         (midpoint of the middle pair for even theta,
//         __fmul_rn(0.5f, __fadd_rn(lo, hi))), NaN ordered last as
//         torch.sort and jnp.sort order it;
//   out = mean of the beta agr values nearest med: the rank count of
//         kernels/ref.py::_coordinate_phase, literally,
//           rank[t] = #{k: dist[k] < dist[t]} + #{k < t: dist[k] == dist[t]},
//         row t taken when rank[t] < beta (a NaN distance compares false
//         both ways, so it ranks 0 and is taken), the taken values summed
//         in row order (__fadd_rn), then __fdiv_rn by beta.
//
// Why counting and no slots: a sorting network needs all theta values in
// registers, which caps theta.  Counting needs only kCands candidates in
// registers at a time, each compared with all theta values streamed from
// the column once per pass: O(theta^2) comparisons a coordinate (ranking
// by counting is what the Pallas kernels do), and no theta a register
// count refuses.
//   * the median: each value's integer key in the NaN-last order (every
//     NaN above +inf and equal to each other, -0 equal to +0), ranked
//     with ties to the lower row, so the ranks are a permutation and
//     order statistic k is the one candidate of rank k.  The value of an
//     order statistic does not depend on how ties break, and a signed zero
//     of the median cannot change |agr - med|, so this is the sort's
//     median.  A NaN median (more than theta - h NaN values) makes every
//     distance NaN, so every row is taken, as in the plain version;
//   * the distances |agr - med| are formed again where they are read (a
//     subtraction and an abs beside each load), so they take no memory.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace select_count {

// candidates held in registers per pass over the theta values
constexpr int kCands = 16;

// value t of a coordinate: p[t * stride]; kLdg reads through the
// read-only cache (inputs the kernel does not write)
template <bool kLdg>
struct Column {
  const float* p;
  int64_t stride;
  __device__ __forceinline__ float operator()(int t) const {
    const float* q = p + (int64_t)t * stride;
    return kLdg ? __ldg(q) : *q;
  }
};

// x's key in the NaN-last order: integer order of the keys is the order
// of the values, every NaN the largest, -0 equal to +0
__device__ __forceinline__ int order_key(float x) {
  if (x != x) return 0x7fffffff;
  int b = __float_as_int(x);
  if (b == (int)0x80000000) b = 0;
  return b >= 0 ? b : b ^ 0x7fffffff;
}

// the theta-median of v(0..theta), NaN last
template <class Col>
__device__ __forceinline__ float median(const Col& v, int theta) {
  const int h = theta / 2;
  float lo = 0.0f, hi = 0.0f;
  for (int t0 = 0; t0 < theta; t0 += kCands) {
    float c[kCands];
    int key[kCands], rank[kCands];
#pragma unroll
    for (int u = 0; u < kCands; ++u) {
      c[u] = t0 + u < theta ? v(t0 + u) : 0.0f;
      key[u] = order_key(c[u]);
      rank[u] = 0;
    }
    for (int k = 0; k < theta; ++k) {
      const int e = order_key(v(k));
#pragma unroll
      for (int u = 0; u < kCands; ++u) {
        rank[u] += e < key[u] || (e == key[u] && k < t0 + u);
      }
    }
#pragma unroll
    for (int u = 0; u < kCands; ++u) {
      if (t0 + u < theta) {
        if (rank[u] == h) hi = c[u];
        if (rank[u] == h - 1) lo = c[u];
      }
    }
  }
  return (theta & 1) ? hi : __fmul_rn(0.5f, __fadd_rn(lo, hi));
}

template <class Col>
__device__ __forceinline__ float select_coordinate(const Col& ext,
                                                   const Col& agr, int theta,
                                                   int beta) {
  const float med = median(ext, theta);
  float s = 0.0f;
  for (int t0 = 0; t0 < theta; t0 += kCands) {
    float a[kCands], dist[kCands];
    int rank[kCands];
#pragma unroll
    for (int u = 0; u < kCands; ++u) {
      a[u] = t0 + u < theta ? agr(t0 + u) : 0.0f;
      dist[u] = fabsf(__fsub_rn(a[u], med));
      rank[u] = 0;
    }
    for (int k = 0; k < theta; ++k) {
      const float dk = fabsf(__fsub_rn(agr(k), med));
#pragma unroll
      for (int u = 0; u < kCands; ++u) {
        rank[u] += dk < dist[u] || (dk == dist[u] && k < t0 + u);
      }
    }
    // row order: passes in increasing t, candidates in increasing t
#pragma unroll
    for (int u = 0; u < kCands; ++u) {
      if (t0 + u < theta && rank[u] < beta) s = __fadd_rn(s, a[u]);
    }
  }
  return __fdiv_rn(s, (float)beta);
}

}  // namespace select_count
