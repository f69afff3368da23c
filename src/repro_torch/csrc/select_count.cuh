// The Bulyan coordinate phase of one coordinate for theta > 32: shared by
// the theta > 32 variants of K2 (fused_select.cu) and K3 (coord_select.cu).
// select_tile.cuh holds theta <= 32 values in register slots; this takes
// every theta, as the Pallas kernels do, in two ways:
//   * up to kMaxWide (128), the network variant: the coordinate's column
//     (its theta ext and theta agr values) lies on chip and is read from
//     device memory once: in the block's shared memory, [t][thread], so a
//     warp's 32 reads of one slot hit 32 banks (K2 both, K3 agr; K3's ext
//     go straight to registers); the selection is select_tile's, over S
//     register slots for a theta in the bucket (L, S] that for_bucket
//     gives;
//   * above it, the counted variant: the column in device memory (K2's
//     scratch, K3's (theta, d) inputs) and every pair ranked.
//
// Given the theta extracted values ext(t) and the theta aggregated values
// agr(t) of one coordinate, both variants compute
//   med = theta-median of ext, the value of the middle order statistic
//         (midpoint of the middle pair for even theta,
//         __fmul_rn(0.5f, __fadd_rn(lo, hi))), NaN ordered last as
//         torch.sort and jnp.sort order it;
//   out = mean of the beta agr values nearest med: the set of the rank count
//         of kernels/ref.py::_coordinate_phase,
//           rank[t] = #{k: dist[k] < dist[t]} + #{k < t: dist[k] == dist[t]},
//         row t taken when rank[t] < beta (a NaN distance compares false
//         both ways, so it ranks 0 and is taken), the taken values summed
//         in row order (__fadd_rn), then __fdiv_rn by beta.
//
// The network variant (cost: select_tile's, on S slots).  The theta values
// fill S register slots, the slots above theta NaN, which sorts after every
// value; a comparator whose upper slot holds NaN moves nothing, so the
// padding never reaches a slot below theta.  Batcher's network
// (select_tile::sort_nan_last<S>) gives the median; the order statistics it
// is read from lie in [L / 2, S / 2] for every theta of the bucket, so the
// compiler keeps only the exchanges those slots depend on.  The buckets
// (for_bucket) are 33-40, 41-48, 49-64, 65-96 and 97-128.  The beta
// nearest are select_tile's threshold rule: T, the beta-th smallest
// distance (a min for beta = 1, the network on the distances otherwise),
// every distance below T (or NaN: !(dist >= T)), then the first `need`
// ties at T in row order; a NaN T takes every row.  That is the rank
// count's set (select_tile.cuh says why), summed in the same order, so
// the bits are the counted variant's and the plain version's.  The
// network is O(S log^2 S) comparators (305 at S = 40, which serves theta =
// 34), two operations each, against about 8 theta^2 operations for the
// ranking (9349 at theta = 34); the distances are formed again where they
// are read (one subtraction and an abs), so they take no memory; the
// column is read on chip, never again from L2.
//
// The counted variant (theta > kMaxWide, no slot count holds the column).
// Counting needs only kCands candidates in registers at a time, each
// compared with all theta values streamed from the column once per pass:
// O(theta^2) comparisons a coordinate, and no theta a register count
// refuses.
//   * the median: each value's integer key in the NaN-last order (every
//     NaN above +inf and equal to each other, -0 equal to +0), ranked
//     with ties to the lower row, so the ranks are a permutation and
//     order statistic k is the one candidate of rank k.  The value of an
//     order statistic does not depend on how ties break, and a signed zero
//     of the median cannot change |agr - med|, so this is the sort's
//     median.  A NaN median (more than theta - h NaN values) makes every
//     distance NaN, so every row is taken, as in the plain version;
//   * the distances |agr - med| are formed again where they are read.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "select_tile.cuh"

namespace select_count {

// the largest theta the network variant takes
constexpr int kMaxWide = 128;

// what a launcher reports in *variant for the theta > 32 variants (the
// theta <= 32 kernels report theta, or 32 for the runtime-theta one)
constexpr int kNetworkVariant = -1;
constexpr int kCountedVariant = -2;

template <int K>
using Int = std::integral_constant<int, K>;

// calls f(Int<L>, Int<S>) for the bucket (L, S] of the network variant
// that holds theta (32 < theta <= kMaxWide): S slots a little above the
// bucket's thetas, so that the padding costs little network
template <class F>
inline void for_bucket(int theta, F&& f) {
  if (theta <= 40) {
    f(Int<32>{}, Int<40>{});
  } else if (theta <= 48) {
    f(Int<40>{}, Int<48>{});
  } else if (theta <= 64) {
    f(Int<48>{}, Int<64>{});
  } else if (theta <= 96) {
    f(Int<64>{}, Int<96>{});
  } else {
    f(Int<96>{}, Int<128>{});
  }
}

// value t of a coordinate's column: p[t * stride] (shared or device
// memory); kLdg reads through the read-only cache (inputs the kernel does
// not write)
template <bool kLdg>
struct Column {
  const float* p;
  int64_t stride;
  __device__ __forceinline__ float operator()(int t) const {
    const float* q = p + (int64_t)t * stride;
    return kLdg ? __ldg(q) : *q;
  }
};

// ------------------------------------------------- the network variant

// A network variant's launch on one card: the bucket's slots, threads a
// block, shared memory a block, the blocks of that memory an SM holds at
// once, and the SMs.
struct WideShape {
  int slots = 0, threads = 0;
  size_t smem = 0;
  int per_sm = 0, sms = 0;
  // at most `want` blocks, and no more than the card holds at once (a
  // grid-stride loop covers the rest)
  unsigned grid(int64_t want) const {
    const int64_t cap = (int64_t)per_sm * sms;
    return (unsigned)(want < cap ? want : cap);
  }
};

// cards whose answers WideShapes keeps (a card above asks every launch)
constexpr int kKeptDevices = 16;

// What the runtime says of one network kernel of the bucket (L, S], asked
// once a card and kept: the kernel's shared-memory cap, raised to the
// bucket's most (smem_of(S)), the SMs and each theta's blocks an SM.  A
// thread that reads a kept value reads what any other would have asked.
template <int L, int S>
class WideShapes {
 public:
  template <class K, class Smem>
  cudaError_t get(K kernel, int threads, Smem smem_of, int theta,
                  WideShape* out) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const bool kept = dev < kKeptDevices;
    int sms = kept ? sms_[dev].load(std::memory_order_relaxed) : 0;
    int per_sm = kept ? per_sm_[dev][theta - L - 1].load(
                            std::memory_order_relaxed) : 0;
    if (sms == 0) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem_of(S));
      if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
      }
      if (err != cudaSuccess) return err;
      if (kept) sms_[dev].store(sms, std::memory_order_relaxed);
    }
    if (per_sm == 0) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, threads, smem_of(theta));
      if (err != cudaSuccess) return err;
      per_sm = per_sm > 0 ? per_sm : 1;
      if (kept) {
        per_sm_[dev][theta - L - 1].store(per_sm, std::memory_order_relaxed);
      }
    }
    *out = WideShape{S, threads, smem_of(theta), per_sm, sms};
    return cudaSuccess;
  }

 private:
  std::atomic<int> sms_[kKeptDevices]{};
  std::atomic<int> per_sm_[kKeptDevices][S - L]{};
};

// v[k] for a k known only at run time to lie in [A, B]
template <int A, int B, int S>
__device__ __forceinline__ float pick_between(const float (&v)[S], int k) {
  float r = v[A];
#pragma unroll
  for (int t = A + 1; t <= B; ++t) {
    if (t == k) r = v[t];
  }
  return r;
}

// the theta-median of v, theta in (L, S]: v holds the theta values, NaN
// above them, and is sorted in place
template <int L, int S>
__device__ __forceinline__ float network_median(float (&v)[S], int theta) {
  select_tile::sort_nan_last(v);
  const int h = theta / 2;
  const float hi = pick_between<L / 2, S / 2>(v, h);
  return (theta & 1)
      ? hi : __fmul_rn(0.5f, __fadd_rn(pick_between<L / 2, S / 2>(v, h - 1),
                                       hi));
}

// the mean of the beta agr values nearest med, theta <= S: select_tile's
// threshold and row-order ties, the distances formed where they are read
template <int S, class Agr>
__device__ __forceinline__ float nearest_mean(const Agr& agr, float med,
                                              int theta, int beta) {
  const float nan = __int_as_float(0x7fffffff);
  // T: the beta-th smallest distance, NaN if fewer than beta are not NaN
  float T = nan;
  if (beta == 1) {
#pragma unroll 8
    for (int t = 0; t < theta; ++t) T = fminf(T, fabsf(__fsub_rn(agr(t), med)));
  } else {
    float w[S];
#pragma unroll
    for (int t = 0; t < S; ++t) {
      w[t] = t < theta ? fabsf(__fsub_rn(agr(t), med)) : nan;
    }
    select_tile::sort_nan_last(w);
    T = select_tile::pick(w, beta - 1);
  }
  int need = beta;
#pragma unroll 8
  for (int t = 0; t < theta; ++t) need -= fabsf(__fsub_rn(agr(t), med)) < T;
  float s = 0.0f;
#pragma unroll 8
  for (int t = 0; t < theta; ++t) {
    const float a = agr(t);
    const float dist = fabsf(__fsub_rn(a, med));
    const bool tie = dist == T;
    if (!(dist >= T) || (tie && need > 0)) s = __fadd_rn(s, a);
    need -= tie;
  }
  return __fdiv_rn(s, (float)beta);
}

// ------------------------------------------------- the counted variant

// candidates held in registers per pass over the theta values
constexpr int kCands = 16;

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
__device__ __forceinline__ float ranked_median(const Col& v, int theta) {
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
__device__ __forceinline__ float ranked_coordinate(const Col& ext,
                                                   const Col& agr, int theta,
                                                   int beta) {
  const float med = ranked_median(ext, theta);
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
