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
//   * 32 < theta <= 128 (the network variant, select_count.cuh, shared
//     with K2's): one thread per coordinate as above, kWideThreads a
//     block; each value read from device memory once, all 2 theta loads of
//     a thread issued together: the g_ext values into S register slots
//     (S the bucket's, 40 to 128; NaN above theta), whose network gives the
//     median, the g_agr values by cp.async into the block's shared column
//     (slot t of the thread at t kWideThreads: a warp's reads hit 32
//     banks; no registers held while they fly), which the threshold, the
//     ties and the row-order sum read three times;
//   * theta > 128 (the counted variant, any theta): no register slots: the
//     coordinate phase by counting (select_count.cuh) ranks straight from
//     the coordinate's (theta, d) columns, kCands candidates at a time
//     against all theta values read through the read-only cache (the
//     block's columns stay hot in L1 between the passes);
//   * 64-bit offsets: theta * d exceeds 2^31 on an embedding leaf.
#include <cuda_pipeline.h>
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

// 32 < theta <= 128, in the bucket (L, S]: the network variant
constexpr int kWideThreads = 128;

template <int L, int S>
__global__ void __launch_bounds__(kWideThreads)
coord_select_wide_kernel(const float* __restrict__ g_ext,
                         const float* __restrict__ g_agr,
                         float* __restrict__ out, int64_t d, int theta,
                         int beta) {
  extern __shared__ float wide_col[];  // theta x kWideThreads
  float* agr = wide_col + threadIdx.x;
  const float nan = __int_as_float(0x7fffffff);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < d; j += stride) {
    // the g_agr values straight to the column (cp.async: no registers),
    // in flight with the g_ext loads and the median's network
    const float* src = g_agr + j;
#pragma unroll 8
    for (int t = 0; t < theta; ++t, src += d) {
      __pipeline_memcpy_async(agr + t * kWideThreads, src, 4);
    }
    __pipeline_commit();
    float v[S];
    src = g_ext + j;
#pragma unroll
    for (int t = 0; t < S; ++t, src += d) {
      v[t] = t < theta ? __ldg(src) : nan;
    }
    const float med = select_count::network_median<L, S>(v, theta);
    __pipeline_wait_prior(0);
    out[j] = select_count::nearest_mean<S>(
        select_count::Column<false>{agr, kWideThreads}, med, theta, beta);
  }
}

// The network variant's launch at theta in the bucket (L, S] on the
// current card (select_count::WideShapes).
template <int L, int S>
cudaError_t wide_shape(int theta, select_count::WideShape* shape) {
  static select_count::WideShapes<L, S> shapes;
  return shapes.get(&coord_select_wide_kernel<L, S>, kWideThreads,
                    [](int t) { return t * kWideThreads * sizeof(float); },
                    theta, shape);
}

template <int L, int S>
int launch_wide(const float* ge, const float* ga, float* out, int64_t d,
                int theta, int beta, cudaStream_t s) {
  select_count::WideShape shape;
  const cudaError_t err = wide_shape<L, S>(theta, &shape);
  if (err != cudaSuccess) return (int)err;
  coord_select_wide_kernel<L, S>
      <<<shape.grid((d + kWideThreads - 1) / kWideThreads), kWideThreads,
         shape.smem, s>>>(ge, ga, out, d, theta, beta);
  return (int)cudaGetLastError();
}

// theta > 128: the coordinate phase by counting on the inputs' columns
__global__ void __launch_bounds__(kThreads)
coord_select_count_kernel(const float* __restrict__ g_ext,
                          const float* __restrict__ g_agr,
                          float* __restrict__ out, int64_t d, int theta,
                          int beta) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < d; j += stride) {
    out[j] = select_count::ranked_coordinate(
        select_count::Column<true>{g_ext + j, d},
        select_count::Column<true>{g_agr + j, d}, theta, beta);
  }
}

}  // namespace

// The network variant's launch at theta (32 < theta <= 128) on the
// current card, as fused_select_wide_shape gives K2's.
extern "C" int coord_select_wide_shape(int64_t theta, int32_t* slots,
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

// g_ext, g_agr: (theta, d) fp32 row-major; out: (d,) fp32.
// blocks: grid size (the wrapper's choice) of the theta <= 32 and the
// counted kernels; the network variant sizes its own grid to what the
// card holds at once.  1 <= beta <= theta.  *variant is set to the kernel
// taken: theta for the exact kernels (theta <= 16), 32 for the
// runtime-theta one, kNetworkVariant (32 < theta <= 128) or
// kCountedVariant (theta > 128; select_count.cuh).  Launches on `stream`;
// returns cudaGetLastError() (0 on success).
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
  if (theta > 32 && theta <= select_count::kMaxWide) {
    *variant = select_count::kNetworkVariant;
    int err = 0;
    select_count::for_bucket(th, [&](auto L, auto S) {
      err = launch_wide<decltype(L)::value, decltype(S)::value>(ge, ga, op, d,
                                                                th, be, s);
    });
    return err;
  }
  if (theta > 32) {
    *variant = select_count::kCountedVariant;
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
