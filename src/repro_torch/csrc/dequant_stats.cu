// K5: fused dequantize -> pairwise statistics of an encoded (n, d) payload.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/dequant_stats.py::dequant_stats_pallas
// (body _kernel): the raw (n, n) ||a||^2 + ||b||^2 - 2<a, b> (unclamped,
// diagonal kept) and the (n,) squared norms of the DECODED rows
// payload[row].f32 * mult[row], without the fp32 stack ever reaching
// device memory.  The payload is int8 (QSGD / signSGD levels) or bf16 (the
// bf16 wire); fp32 is accepted too.
//
// Bound on an H100: bytes.  The kernel must read the payload once: n*d
// bytes for int8 (3.6 GB at qwen2-1.5b width, 2 layers, n = 11), 2*n*d for
// bf16; the n(n+1)/2 multiply-adds and n decode multiplies per column
// stay below the fp32 rate at those byte counts.  What held it back was
// neither: element by element it issued K1's count of load requests for
// a quarter (int8) or a half (bf16) of K1's bytes, and reloaded each
// row's multiplier with every element.  What bounds it now is the
// registers: the 12-row tile's 78 accumulators leave room for two
// 256-thread blocks an SM (16 warps), and at that occupancy the chain of
// one group of 32 columns (loads, 12 shuffles and decodes, 78 FMAs) is
// not hidden; how far ahead the words are loaded does not move it (PERF.md,
// PR 19: about 5 ms for int8 against a bytes bound of 1.07).
//
// Design: K1's template (stats_tile.cuh) with the dequantising loader of
// dequant_rows.cuh, which walks the template's columns itself: packed
// 4-byte words shared across the warp by __shfl_sync, the next group's
// words loaded after the current group's products, the multipliers in
// shared memory (in registers they cost the SM its second block).  The
// grid, the chunk count (the wrapper calls K1's launch_config), the
// register tiles, each thread's columns and the fixed-order chunk sum
// are K1's, so K5 on a
// payload equals K1 on payload.float() * mult[:, None] bit for bit (the
// contract of the JAX package's DESIGN.md section 9).  __fmul_rn keeps
// nvcc from fusing the decode multiply into the following FMA, so the
// decoded value is the rounded product, as the decode computes it.
// Negative multipliers (the scale_poison wire attack) keep their sign.
// The TPU kernel padded the worker axis to the payload type's sublane tile
// (32 rows for int8, 16 for bf16) with zero payload and zero multiplier;
// here rows past n are exact zeros in registers, which is the same
// contract without the padding.
#include "dequant_rows.cuh"

namespace {

template <class T>
int launch(const void* payload, const void* mult, void* partial, void* dists,
           void* norms, int64_t n, int64_t d, int64_t chunks, int64_t row_tile,
           cudaStream_t s) {
  return stats_tile::launch_stats(
      dequant_rows::DequantRows<T>::make(payload, mult, d), partial, dists,
      norms, n, d, chunks, row_tile, s);
}

}  // namespace

// payload: (n, d) row-major, dtype 0 = fp32, 1 = int8, 2 = bf16;
// mult: (n,) fp32; partial: (chunks, n, n) fp32 scratch; dists: (n, n)
// fp32; norms: (n,) fp32.  row_tile and chunks as for pairwise_stats_launch
// (the same launch_config).  Launches on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int dequant_stats_launch(const void* payload, int64_t dtype,
                                    const void* mult, void* partial, void* dists,
                                    void* norms, int64_t n, int64_t d,
                                    int64_t chunks, int64_t row_tile,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch<float>(payload, mult, partial, dists, norms, n, d, chunks,
                           row_tile, s);
    case 1:
      return launch<int8_t>(payload, mult, partial, dists, norms, n, d, chunks,
                            row_tile, s);
    case 2:
      return launch<__nv_bfloat16>(payload, mult, partial, dists, norms, n, d,
                                   chunks, row_tile, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
