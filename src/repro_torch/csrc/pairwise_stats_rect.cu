// K6: rectangular pairwise statistics, one mesh rank's row block against
// the gathered fp32 stack.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/pairwise_sqdist.py::pairwise_stats_rect_pallas
// (body _rect_kernel / _rect_tile): an (n_loc, d) row block x the (n, d)
// stack -> the raw (n_loc, n) block sq_l + sq_f - 2 <a, b> (unclamped,
// diagonal kept) and the (n,) squared norms of the stack.  On a mesh of W
// worker ranks each rank computes its n/W rows: O(n_loc n d) work, not
// the square kernel's O(n^2 d) on every rank.
//
// Bound on an H100: bytes.  The kernel must read the block and the stack
// once (the block is a view of the gathered stack on the mesh path, so
// the stack's n*d*4 bytes); the n_loc*n multiply-adds per column are far
// below the fp32 rate at that byte count.
//
// Design: the rectangular template of stats_rect.cuh with K1's fp32
// loader, at K1's chunk count for the true worker count (the wrapper calls
// K1's launch_config), so every element of the block equals K1's matching
// element bit for bit and the sharded statistics equal the replicated
// ones.  The TPU kernel carried its (n_loc, n) sum across a sequential
// grid; blocks on the H100 run in parallel, hence the (chunks, n_loc, n)
// scratch summed in chunk order.  When the block is the whole stack (a
// one-rank mesh: x_loc == x_full, no padding) the block is symmetric, and
// K1's template (stats_tile.cuh, one diagonal tile) computes each product
// once instead of twice: the same values, in half the loads.  When the
// block is rows r0 .. r0 + n_loc of a stack that fits one full tile (a
// W-rank mesh's block of a stack of at most 16 rows) the template's view
// path loads each stack row once a column and reads the block's rows out
// of those registers: at n = 11 on 4 ranks (3 of 12 rows) 12 loads a
// column instead of 16, each product formed as the rectangular grid forms
// it, so the same bits; and its finalize issues each thread's chunk loads
// together, where rect_finalize_kernel waits on them one chunk at a time
// (on the main path's leaves 3.6 of the 4-rank block's 11.1 ms a step
// on an H100: PERF.md).
#include "stats_rect.cuh"

// x_loc: (n_loc, d), x_full: (n_full, d), fp32 row-major; part_g: (chunks,
// n_loc, n_full), part_l: (chunks, n_loc), part_f: (chunks, n_full) fp32
// scratch; dists: (n_loc, n_full); norms: (n_full,).  tile_loc 4 or 8,
// tile_full 8, 12 or 16.  square_tile > 0 when x_loc is x_full: K1's row
// tile for the stack (part_l and part_f are then null).  view_row >= 0
// when x_loc is rows view_row .. view_row + n_loc of x_full and n_full <=
// tile_full: the view path; -1 otherwise.  Launches on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int pairwise_stats_rect_launch(
    const void* x_loc, const void* x_full, void* part_g, void* part_l,
    void* part_f, void* dists, void* norms, int64_t n_loc, int64_t n_full,
    int64_t d, int64_t chunks, int64_t tile_loc, int64_t tile_full,
    int64_t square_tile, int64_t view_row, void* stream) {
  const stats_rect::Rows<float> full{(const float*)x_full, d};
  if (square_tile > 0) {
    if (x_loc != x_full || n_loc != n_full) return (int)cudaErrorInvalidValue;
    return stats_tile::launch_stats(full, part_g, dists, norms, n_full, d,
                                    chunks, square_tile, (cudaStream_t)stream);
  }
  if (view_row >= 0) {
    if (x_loc != full.x + view_row * d) return (int)cudaErrorInvalidValue;
    return stats_rect::launch_rect_view(full, part_g, part_l, part_f, dists,
                                        norms, n_loc, n_full, d, chunks,
                                        tile_loc, tile_full, view_row,
                                        (cudaStream_t)stream);
  }
  return stats_rect::launch_rect(
      stats_rect::Rows<float>{(const float*)x_loc, d}, full, part_g, part_l,
      part_f, dists, norms, n_loc, n_full, d, chunks, tile_loc, tile_full,
      (cudaStream_t)stream);
}
