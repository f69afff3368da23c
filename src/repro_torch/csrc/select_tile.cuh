// The Bulyan coordinate phase of one coordinate, shared by K2
// (fused_select.cu) and K3 (coord_select.cu).
//
// Given the theta extracted values ext[] and the theta aggregated values
// agr[] of one coordinate, held in S register slots (S = theta for the
// exact-theta kernels; S = 32 with the runtime theta guarding the slots
// for 16 < theta <= 32):
//   med = theta-median of ext, the value of the middle order statistic
//         (midpoint of the middle pair for even theta), NaN ordered last as
//         torch.sort and jnp.sort order it;
//   out = mean of the beta agr values nearest med, ties to the lower row,
//         every NaN distance taken (the rank count of kernels/ref.py gives
//         a NaN rank 0); the sum is taken in row order, each operation
//         rounded on its own (__fadd_rn, __fdiv_rn).
// K2 forms ext/agr by its in-register contraction, K3 loads them from the
// materialised (theta, d) g_ext/g_agr.  Everything after that is this one
// function, so the two substrates can differ only through the contraction,
// and the plain version in kernels/ref.py reproduces both bit for bit.
//
// Cost: no theta^2 rank counts.  The median is the output of Batcher's
// odd-even merge sort network, written out at compile time for S slots;
// for an exact theta the compiler keeps only the exchanges the middle
// slots depend on (two instructions each).  The value of an order
// statistic does not depend on how ties break, and a signed zero of the
// median cannot change |agr - med|, so the result is the rank count's.  The
// beta nearest are a threshold T (the beta-th smallest distance: a min for
// beta = 1, the network otherwise) plus the ties at T counted in row order,
// the set the rank count selects.
#pragma once

#include <cuda_runtime.h>

#include <utility>

namespace select_tile {

// max.NaN returns NaN when either input is NaN; fminf returns the other
// input.  So exchange() leaves the pair in order with NaN last.
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ void exchange(float& a, float& b) {
  const float lo = fminf(a, b);
  b = max_nan(a, b);
  a = lo;
}

// Batcher's odd-even merge sort on N slots: the network on the next power
// of two with every exchange that touches a slot >= N left out (those
// slots would hold values above all others, so those exchanges never
// move anything).  slot(q, 0) / slot(q, 1) is the lower / upper slot of
// exchange q; size() is how many there are.
template <int N>
struct Network {
  static constexpr __host__ __device__ int slot(int q, int side) {
    int c = 0;
    for (int p = 1; p < N; p <<= 1)
      for (int k = p; k >= 1; k >>= 1)
        for (int j = k % p; j + k < N; j += 2 * k)
          for (int i = 0; i < k && i + j + k < N; ++i)
            if ((i + j) / (2 * p) == (i + j + k) / (2 * p)) {
              if (c == q) return side ? i + j + k : i + j;
              ++c;
            }
    return c;
  }
  static constexpr __host__ __device__ int size() { return slot(-1, 0); }
};

template <int A, int B, int N>
__device__ __forceinline__ void exchange_at(float (&v)[N]) {
  exchange(v[A], v[B]);
}

template <int N, int... Q>
__device__ __forceinline__ void sort_slots(float (&v)[N],
                                           std::integer_sequence<int, Q...>) {
  (exchange_at<Network<N>::slot(Q, 0), Network<N>::slot(Q, 1)>(v), ...);
}

// v sorted ascending, NaN last
template <int N>
__device__ __forceinline__ void sort_nan_last(float (&v)[N]) {
  sort_slots(v, std::make_integer_sequence<int, Network<N>::size()>{});
}

// v[k] for a k known only at run time, without indexing registers
template <int S>
__device__ __forceinline__ float pick(const float (&v)[S], int k) {
  float r = v[0];
#pragma unroll
  for (int t = 1; t < S; ++t) {
    if (t == k) r = v[t];
  }
  return r;
}

template <int S>
__device__ __forceinline__ float select_coordinate(const float (&ext)[S],
                                                   const float (&agr)[S],
                                                   int theta, int beta) {
  // slots at and above theta hold NaN, which sorts after every value
  const float nan = __int_as_float(0x7fffffff);
  float v[S];
#pragma unroll
  for (int t = 0; t < S; ++t) v[t] = t < theta ? ext[t] : nan;
  sort_nan_last(v);
  const int h = theta / 2;
  const float hi = pick(v, h);
  const float med =
      (theta & 1) ? hi : __fmul_rn(0.5f, __fadd_rn(pick(v, h - 1), hi));

  float dist[S];
#pragma unroll
  for (int t = 0; t < S; ++t) {
    dist[t] = t < theta ? fabsf(__fsub_rn(agr[t], med)) : nan;
  }
  // T: the beta-th smallest distance, NaN if fewer than beta are not NaN
  float T;
  if (beta == 1) {
    T = dist[0];
#pragma unroll
    for (int t = 1; t < S; ++t) T = fminf(T, dist[t]);
  } else {
    float w[S];
#pragma unroll
    for (int t = 0; t < S; ++t) w[t] = dist[t];
    sort_nan_last(w);
    T = pick(w, beta - 1);
  }
  // every distance below T (or NaN: !(x >= T)) is taken, then the first
  // `need` ties at T in row order; a NaN T takes every row
  int need = beta;
#pragma unroll
  for (int t = 0; t < S; ++t) need -= dist[t] < T;
  float s = 0.0f;
#pragma unroll
  for (int t = 0; t < S; ++t) {
    if (t < theta) {
      const bool tie = dist[t] == T;
      if (!(dist[t] >= T) || (tie && need > 0)) s = __fadd_rn(s, agr[t]);
      need -= tie;
    }
  }
  return __fdiv_rn(s, (float)beta);
}

}  // namespace select_tile
