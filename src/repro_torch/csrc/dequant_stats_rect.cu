// K7: rectangular fused dequantize -> pairwise statistics of an encoded
// payload, one mesh rank's row block against the gathered payload.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/dequant_stats.py::dequant_stats_rect_pallas
// (body _rect_kernel): an (n_loc, d) payload block + (n_loc,) fp32 row
// multipliers x the gathered (n, d) payload + (n,) multipliers -> K6's raw
// (n_loc, n) block and (n,) squared norms of the DECODED rows
// payload[row].f32 * mult[row], without the fp32 rows in device memory.
// The payload is int8 (QSGD / signSGD levels) or bf16; fp32 is accepted.
// Block and stack share one type (the wrapper rejects a mix, as the TPU
// kernel does).
//
// Bound on an H100: bytes.  The kernel must read the payload once (n*d
// bytes for int8, 2*n*d for bf16: the block is a view of the gathered
// payload on the mesh path) and the multipliers.
//
// Design: K6's template (stats_rect.cuh) with K5's loader
// (dequant_rows.cuh: packed words shared across the warp, the multipliers
// in shared memory), at K1's chunk count for the true worker count, so the
// block equals K5's matching rows bit for bit, and K6's on the decoded
// rows.  The loader walks the local and the full rows' columns together;
// the packed words need both to start on 4-byte words (a row block of an
// odd d does not: it takes the per-element code).  When the block is the
// whole payload (a one-rank mesh) it runs K5's symmetric grid on K5's
// loader, as K6 runs K1's.  What bounds the rectangular grid is the
// registers: a 4-rank block's (4, 12) tile holds 64 accumulators and 16
// values, which spill at two blocks an SM, so it runs one (PERF.md, PR 19:
// the 4-rank block takes about 11 ms for int8 against a bytes bound of
// 1.17, the parent's 16).
// Rows past a tile's end are exact zeros in registers (the TPU kernel
// padded the worker axis to the payload's sublane tile instead).
#include "dequant_rows.cuh"
#include "stats_rect.cuh"

namespace {

using dequant_rows::DequantRows;

template <class T>
int launch(const void* p_loc, const void* m_loc, const void* p_full,
           const void* m_full, void* part_g, void* part_l, void* part_f,
           void* dists, void* norms, int64_t n_loc, int64_t n_full, int64_t d,
           int64_t chunks, int64_t tile_loc, int64_t tile_full,
           int64_t square_tile, cudaStream_t s) {
  const auto full = DequantRows<T>::make(p_full, m_full, d);
  if (square_tile > 0) {
    if (p_loc != p_full || m_loc != m_full || n_loc != n_full) {
      return (int)cudaErrorInvalidValue;
    }
    return stats_tile::launch_stats(full, part_g, dists, norms, n_full, d,
                                    chunks, square_tile, s);
  }
  return stats_rect::launch_rect(
      DequantRows<T>::make(p_loc, m_loc, d), full,
      part_g, part_l, part_f, dists, norms, n_loc, n_full, d, chunks,
      tile_loc, tile_full, s);
}

}  // namespace

// p_loc: (n_loc, d), p_full: (n_full, d) row-major, both of dtype 0 =
// fp32, 1 = int8, 2 = bf16; m_loc: (n_loc,), m_full: (n_full,) fp32;
// scratch, outputs, tiles, square_tile (> 0 when the block is the whole
// payload: p_loc == p_full and m_loc == m_full; part_l and part_f are then
// null) and chunks as for
// pairwise_stats_rect_launch.
// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int dequant_stats_rect_launch(
    const void* p_loc, const void* m_loc, const void* p_full,
    const void* m_full, int64_t dtype, void* part_g, void* part_l,
    void* part_f, void* dists, void* norms, int64_t n_loc, int64_t n_full,
    int64_t d, int64_t chunks, int64_t tile_loc, int64_t tile_full,
    int64_t square_tile, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch<float>(p_loc, m_loc, p_full, m_full, part_g, part_l,
                           part_f, dists, norms, n_loc, n_full, d, chunks,
                           tile_loc, tile_full, square_tile, s);
    case 1:
      return launch<int8_t>(p_loc, m_loc, p_full, m_full, part_g, part_l,
                            part_f, dists, norms, n_loc, n_full, d, chunks,
                            tile_loc, tile_full, square_tile, s);
    case 2:
      return launch<__nv_bfloat16>(p_loc, m_loc, p_full, m_full, part_g,
                                   part_l, part_f, dists, norms, n_loc, n_full,
                                   d, chunks, tile_loc, tile_full,
                                   square_tile, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
