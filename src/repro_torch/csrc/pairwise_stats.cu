// K1: single-pass pairwise statistics of an (n, d) fp32 gradient stack.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/pairwise_sqdist.py::pairwise_stats_pallas
// (body _stats_kernel / _stats_tile): raw ||a||^2 + ||b||^2 - 2<a, b>
// (unclamped, diagonal kept) and the (n,) squared row norms, one read of
// the stack.
//
// Bound on an H100: bytes.  At the main path's shape (n = 11, d up to
// 2.3e8) the kernel must read n*d*4 bytes once; the n^2*d multiply-adds
// are ~3.7x below the fp32 rate at that byte count.  The design is the
// template in stats_tile.cuh (one thread per column, register tiles,
// a (chunks, n, n) scratch summed in a fixed order, 64-bit offsets); this
// file gives it a loader that reads the fp32 stack.  The TPU kernel
// carried its (n, n) sum across a sequential grid; blocks on the H100 run
// in parallel, hence the scratch.  The paper's CUDA code stopped at
// n <= 24 because it kept whole rows in shared memory; this has no limit.
// fp32 accumulation throughout (no TF32, no library GEMM).
#include "stats_tile.cuh"

namespace {

struct F32Rows {
  const float* x;
  int64_t d;
  __device__ __forceinline__ float load(int64_t row, int64_t col) const {
    return __ldg(x + row * d + col);
  }
};

}  // namespace

// x: (n, d) fp32 row-major; partial: (chunks, n, n) fp32 scratch;
// dists: (n, n) fp32; norms: (n,) fp32.  row_tile is the smallest of
// 8, 12, 16 that holds n for n <= 16, else 8.  Launches on `stream`;
// returns cudaGetLastError() (0 on success).
extern "C" int pairwise_stats_launch(const void* x, void* partial, void* dists,
                                     void* norms, int64_t n, int64_t d,
                                     int64_t chunks, int64_t row_tile,
                                     void* stream) {
  return stats_tile::launch_stats(F32Rows{(const float*)x, d}, partial, dists,
                                  norms, n, d, chunks, row_tile,
                                  (cudaStream_t)stream);
}
