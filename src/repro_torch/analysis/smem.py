"""Hopper shared-memory, traffic and occupancy estimator for the port's
kernels (cf. ``repro.analysis.vmem``).

For each kernel function that a wrapper call of K1-K7 launches, at an
(n, d) point, it gives the grid and the threads a block, the static and
the dynamic shared memory a block, and for the call the HBM bytes read and
written (each input read once, each output written once: what the bound
counts; the partial sums a kernel writes and reads back are
``scratch_bytes``, beside it), the fp32 operations, and the bound: the
larger of the bytes over ``bounds.HBM_BYTES_PER_S`` and the operations
over ``bounds.FP32_FLOP_PER_S``.  The bytes and operations are
``analysis/bounds.py``'s ``k*_work``, the same arithmetic that
``chip_smoke.py``'s bound column calls.  Given ptxas's registers (the
report ``kernels.build`` keeps beside each library), :func:`against_ptxas`
sets each launch's static shared memory beside ptxas's and gives the
blocks and warps an SM holds (:func:`occupancy`).

As ``vmem.py`` calls ``ops``' tile policy, this module calls the wrappers'
own launch policy and does not re-derive it: ``pairwise_sqdist``'s
``launch_config``, ``rect_tiles``, ``is_whole`` and ``rect_view_arg``, and
``fused_select``'s ``variant_name`` (and ``wide_shape``, which asks the
card, in ``chip_smoke.py``'s check).  What lives only in a ``.cu`` or
``.cuh`` source (a template's block size, its rows, its shared arrays) is
kept here as a named copy; ``chip_smoke.py``'s A1 phase holds every
launched function's static shared memory to ptxas's and the network
variants' blocks an SM to CUDA's occupancy query, so a copy that drifts
fails there.

The shared memory of each source, as modelled:

* K1 / K4 / K5, ``stats_tile.cuh``: ``red[kWarps][R * R]`` floats a
  ``tile_pair`` instantiation (the multi-tile kernel instantiates the
  diagonal and the off-diagonal pair, two arrays); K5's loader
  (``dequant_rows.cuh``) adds ``s_mult[RA + RB]`` to each; the finalize
  none;
* K6 / K7, ``stats_rect.cuh``: ``red[kWarps][kSlots]`` (``kSlots`` = RL
  RF + RL + RF, or RL RF + RF on the view path, whose kernel instantiates
  a second tile when RL < RF), K7 adding ``s_mult``; the view path's
  staged finalize ``stage[3][kSeg][kFinalizeThreads]``;
* K2, ``fused_select.cu``: dynamic θ n 8 bytes (the weight pairs) for θ
  ≤ 32; ``wide_smem_bytes`` for the network variant (33 ≤ θ ≤ 128); the
  counted variant's static ``sw[kCountRows][kCands]`` float2;
* K3, ``coord_select.cu``: none for θ ≤ 32 and the counted variant; the
  network variant's dynamic ``wide_col``, θ × ``kWideThreads`` floats.

Two parts of ``vmem.py`` have no counterpart until the port has a
benchmark:
``predicted_crossover`` and ``diagnose_traffic_linearity`` read the JAX
package's CPU timings in ``BENCH_agg_time.json``.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.analysis import bounds as B
from repro_torch.kernels import coord_select as CS
from repro_torch.kernels import fused_select as FS
from repro_torch.kernels import pairwise_sqdist as PS

# --------------------------------------------------- the card (H100 SXM)
#: SMs, and per SM: 32-bit registers, threads (the hopper-kernels guide)
SMS = 132
REGS_PER_SM = 65536
MAX_REGS_PER_THREAD = 255
MAX_THREADS_PER_SM = 2048
MAX_THREADS_PER_BLOCK = 1024
#: shared memory a block can use: 227 KB, above 48 KB only as dynamic
#: memory after the opt-in (``cudaFuncAttributeMaxDynamicSharedMemorySize``)
SMEM_PER_BLOCK_MAX = 232448
SMEM_DEFAULT_MAX = 48 * 1024
#: CUDA's occupancy calculator for sm_90 (the toolkit's cuda_occupancy.h):
#: shared memory an SM, reserved a block and its allocation unit;
#: registers allocated a warp in units of 256 on each of 4 schedulers;
#: blocks an SM
SMEM_PER_SM = 233472
SMEM_RESERVED_PER_BLOCK = 1024
SMEM_UNIT = 128
REG_UNIT = 256
SCHEDULERS = 4
MAX_BLOCKS_PER_SM = 32

# ------------------------------------ copies of the sources' constants
#: stats_tile.cuh kThreads (K1, K4, K5 and K6 / K7's gram kernels)
STATS_THREADS = 256
STATS_WARPS = STATS_THREADS // 32
#: the finalize kernels' block (launch_stats, launch_rect, K4's)
FINALIZE_THREADS = 256
#: stats_rect.cuh: kFinalizeThreads and the kSeg launch_rect_view takes
STAGED_THREADS = 64
STAGED_SEG = 32
#: fused_select.cu / coord_select.cu kThreads (the θ ≤ 32 kernels)
SELECT_THREADS = 256
#: fused_select.cu kCoords (coordinates a thread for θ ≤ 16; 1 above)
K2_COORDS = 2
#: fused_select.cu kWideCoords, kWideRows (the network variant)
WIDE_COORDS = 2
WIDE_ROWS = 8
#: fused_select.cu kCountThreads, kCountRows, kCountScratchBytes;
#: select_count.cuh kCands
COUNT_THREADS = 128
COUNT_ROWS = 32
COUNT_SCRATCH_BYTES = 32 << 20
CANDS = 16
#: coord_select.cu kWideThreads
K3_WIDE_THREADS = 128
#: the network variant's buckets (L, S] (select_count.cuh for_bucket)
_BUCKET_LOWER = dict(zip(FS.NETWORK_SLOTS, (32,) + FS.NETWORK_SLOTS[:-1]))
_ITEMSIZE = {"float32": 4, "int8": 1, "bfloat16": 2}
#: the mangled template argument of K5's / K7's loader, by payload type
_DEQUANT_ROWS = {"float32": r"\w*DequantRowsIfE", "int8": r"\w*DequantRowsIaE",
                 "bfloat16": r"\w*DequantRowsI13__nv_bfloat16E"}
#: K4's loader (stats_rect::Rows<T>) by stack type
_SQDIST_ROWS = {"float32": r"\w*RowsIfE",
                "bfloat16": r"\w*RowsI13__nv_bfloat16E"}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _cdiv(a, b) * b


# --------------------------------------------------------- occupancy
def occupancy(threads: int, smem: int, registers: Optional[int] = None
              ) -> Dict[str, Any]:
    """Blocks and warps an SM holds of a kernel of ``threads`` threads a
    block, ``smem`` bytes of shared memory a block (static and dynamic)
    and ``registers`` a thread (None: not known, no register limit), as
    CUDA's occupancy calculator counts them; ``limited_by`` names the
    scarcest of blocks, warps, registers and shared memory."""
    warps = _cdiv(threads, 32)
    limits = {"blocks": MAX_BLOCKS_PER_SM,
              "warps": MAX_THREADS_PER_SM // 32 // warps,
              "shared memory": SMEM_PER_SM // _round_up(
                  smem + SMEM_RESERVED_PER_BLOCK, SMEM_UNIT)}
    if registers is not None:
        per_warp = _round_up(registers * 32, REG_UNIT)
        per_scheduler = REGS_PER_SM // SCHEDULERS // per_warp
        limits["registers"] = per_scheduler * SCHEDULERS // warps
    limited_by = min(limits, key=limits.get)
    blocks = limits[limited_by]
    return {"blocks_per_sm": blocks, "warps_per_sm": blocks * warps,
            "limited_by": limited_by}


# ----------------------------------------------------------- estimates
@dataclasses.dataclass(frozen=True)
class Launch:
    """One kernel function a call launches: its name (``function``), a
    regular expression for its mangled name in ptxas's report
    (``pattern``), grid, threads a block, static and dynamic shared memory
    a block, and whether its launcher raises the 48 KB cap and caps its
    grid at what the card holds at once (``network``: the network
    variants, ``select_count.cuh``'s ``WideShape``).  A network launch's
    grid counts shared memory only, so it is an upper bound: the registers,
    which ptxas gives, may hold fewer blocks an SM
    (:func:`against_ptxas`'s ``grid``)."""

    function: str
    pattern: str
    grid: Tuple[int, ...]
    threads: int
    static_smem: int
    dynamic_smem: int = 0
    network: bool = False

    @property
    def smem(self) -> int:
        return self.static_smem + self.dynamic_smem

    def problems(self) -> List[str]:
        """What the card refuses of this launch."""
        out = []
        if self.threads > MAX_THREADS_PER_BLOCK:
            out.append(f"{self.function}: {self.threads} threads a block "
                       f"(at most {MAX_THREADS_PER_BLOCK})")
        cap = SMEM_PER_BLOCK_MAX if self.network else SMEM_DEFAULT_MAX
        if self.static_smem > SMEM_DEFAULT_MAX or self.smem > cap:
            out.append(f"{self.function}: {self.smem} B of shared memory a "
                       f"block, over the {cap} B its launcher allows")
        return out

    def to_json(self) -> Dict[str, Any]:
        return {**dataclasses.asdict(self), "grid": list(self.grid),
                "grid_is_upper_bound": self.network, "smem": self.smem,
                "needs_opt_in": self.smem > SMEM_DEFAULT_MAX}


@dataclasses.dataclass(frozen=True)
class KernelEstimate:
    """One wrapper call: the kernel (its library's name), the stack's rows
    and columns, the wrapper's launch configuration (``config``, as
    ``obs.profile`` records it), the kernel functions it launches, the HBM
    bytes read and written and the fp32 operations the bound counts
    (``bounds.k*_work``), and the scratch bytes written and read back
    beside them."""

    kernel: str
    n: int
    d: int
    config: Dict[str, Any]
    launches: Tuple[Launch, ...]
    hbm_read_bytes: int
    hbm_write_bytes: int
    fp32_ops: int
    scratch_bytes: int

    @property
    def bound(self) -> Dict[str, float]:
        return B.work_bound_s(self.hbm_read_bytes, self.hbm_write_bytes,
                              self.fp32_ops)

    @property
    def bound_s(self) -> float:
        return max(self.bound.values())

    @property
    def bound_by(self) -> str:
        b = self.bound
        return max(b, key=b.get)

    @property
    def smem_per_block(self) -> int:
        """The most shared memory a block of the launched functions uses
        (static and dynamic): ``obs.profile``'s ``vmem_predicted``."""
        return max(launch.smem for launch in self.launches)

    def problems(self) -> List[str]:
        return [p for launch in self.launches for p in launch.problems()]

    def to_json(self) -> Dict[str, Any]:
        return {"kernel": self.kernel, "n": self.n, "d": self.d,
                "config": self.config,
                "launches": [launch.to_json() for launch in self.launches],
                "hbm_read_bytes": self.hbm_read_bytes,
                "hbm_write_bytes": self.hbm_write_bytes,
                "scratch_bytes": self.scratch_bytes,
                "fp32_ops": self.fp32_ops, "bound_ms": 1e3 * self.bound_s,
                "bound_by": self.bound_by,
                "smem_per_block": self.smem_per_block,
                "problems": self.problems()}


def _red_bytes(slots: int) -> int:
    """A reduction array ``red[kWarps][slots]`` of floats."""
    return 4 * STATS_WARPS * slots


def _stats_launches(n: int, d: int, gram: str, loader: str,
                    mult: bool) -> Tuple[Dict[str, Any], List[Launch], int]:
    """K1's template (``stats_tile::launch_stats``) on ``n`` rows:
    (config, launches, scratch bytes).  ``gram`` is the gram kernel's name
    (``partial_gram_kernel``, or ``partial_gram_bounded_kernel`` for K5's
    loader), ``loader`` the regular expression of its loader's mangled
    name, ``mult``: the loader keeps its multipliers in shared memory."""
    row_tile, chunks = PS.launch_config(n, d)
    tiles = _cdiv(n, row_tile)
    pairs = tiles * (tiles + 1) // 2
    gy = min(pairs, 65535)
    grid = (chunks, gy, _cdiv(pairs, gy))
    single = n <= row_tile
    # tile_pair<R, true> alone, or with tile_pair<R, false>: one
    # red[kWarps][R R] (and s_mult[2 R]) each
    per_pair = _red_bytes(row_tile * row_tile) + (8 * row_tile if mult else 0)
    config = {"row_tile": row_tile, "chunks": chunks, "grid": list(grid)}
    launches = [
        Launch(f"{gram}<{row_tile}, {str(single).lower()}>",
               rf"partial_gram\w*ILi{row_tile}ELb{int(single)}E{loader}",
               grid, STATS_THREADS, per_pair * (1 if single else 2)),
        Launch("finalize_kernel", r"\dfinalize_kernel",
               (_cdiv(n * n, FINALIZE_THREADS),), FINALIZE_THREADS, 0)]
    return config, launches, 2 * 4 * chunks * n * n


def estimate_pairwise_stats(n: int, d: int) -> KernelEstimate:
    """K1 on an (n, d) fp32 stack."""
    config, launches, scratch = _stats_launches(
        n, d, "partial_gram_kernel", r"\w*F32Rows", False)
    return KernelEstimate("pairwise_stats", n, d, config, tuple(launches),
                          *B.k1_work(n, d), scratch)


def estimate_dequant_stats(n: int, d: int, dtype: str = "int8"
                           ) -> KernelEstimate:
    """K5 on an (n, d) payload of ``dtype`` (int8, bfloat16 or float32)."""
    config, launches, scratch = _stats_launches(
        n, d, "partial_gram_bounded_kernel", _DEQUANT_ROWS[dtype], True)
    return KernelEstimate("dequant_stats", n, d, {**config, "dtype": dtype},
                          tuple(launches), *B.k5_work(n, d, _ITEMSIZE[dtype]),
                          scratch)


def estimate_pairwise_sqdist(n: int, d: int, dtype: str = "float32"
                             ) -> KernelEstimate:
    """K4 on an (n, d) fp32 or bf16 stack (no caller on any path)."""
    config, launches, scratch = _stats_launches(
        n, d, "partial_gram_kernel", _SQDIST_ROWS[dtype], False)
    launches[1] = dataclasses.replace(
        launches[1], function="finalize_sqdist_kernel",
        pattern="finalize_sqdist_kernel")
    return KernelEstimate("pairwise_sqdist", n, d, {**config, "dtype": dtype},
                          tuple(launches), *B.k4_work(n, d, _ITEMSIZE[dtype]),
                          scratch)


def _rect(kernel: str, n_loc: int, n_full: int, d: int, n: Optional[int],
          grid_kind: str, loader: str, mult: bool, itemsize: int,
          block_in_stack: bool) -> KernelEstimate:
    """K6 (``mult`` False) or K7 on an (n_loc, d) block against the
    (n_full, d) stack: ``grid_kind`` "square" (K1's symmetric grid: the
    block is the stack), "view" (K6's view path) or "rect"."""
    n = n_full if n is None else int(n)
    in_bytes = itemsize * n_full * d + (4 * n_full if mult else 0)
    if not block_in_stack:
        in_bytes += itemsize * n_loc * d + (4 * n_loc if mult else 0)
    work = B.rect_work(in_bytes, n_loc, n_full, d, n_full if mult else 0)
    if grid_kind == "square":
        gram = "partial_gram_bounded_kernel" if mult else "partial_gram_kernel"
        config, launches, scratch = _stats_launches(n, d, gram, loader, mult)
        return KernelEstimate(
            kernel, n_full, d, {**config, "grid_kind": "square",
                                "n_loc": n_loc}, tuple(launches),
            *work, scratch)
    chunks = PS.launch_config(n, d)[1]
    tl, tf = PS.rect_tiles(n_loc, n_full)
    cells = n_loc * n_full
    if grid_kind == "view":
        instances = 2 if tl < tf else 1   # tile 1 is its own instantiation
        launches = (
            Launch(f"rect_view_kernel<{tl}, {tf}>",
                   rf"rect_view_kernelILi{tl}ELi{tf}E",
                   (_cdiv(n_loc, tl), chunks), STATS_THREADS,
                   instances * _red_bytes(tl * tf + tf)),
            Launch(f"rect_finalize_staged_kernel<{STAGED_SEG}>",
                   r"rect_finalize_staged",
                   (_cdiv(cells, STAGED_THREADS),), STAGED_THREADS,
                   4 * 3 * STAGED_SEG * STAGED_THREADS))
    else:
        pairs = _cdiv(n_loc, tl) * _cdiv(n_full, tf)
        launches = (
            Launch(f"rect_gram_kernel<{tl}, {tf}>",
                   rf"rect_gram_kernelILi{tl}ELi{tf}E{loader}",
                   (pairs, chunks), STATS_THREADS,
                   _red_bytes(tl * tf + tl + tf)
                   + (4 * (tl + tf) if mult else 0)),
            Launch("rect_finalize_kernel", r"\drect_finalize_kernel",
                   (_cdiv(cells, FINALIZE_THREADS),), FINALIZE_THREADS, 0))
    scratch = 2 * 4 * chunks * (cells + n_loc + n_full)
    return KernelEstimate(
        kernel, n_full, d, {"grid_kind": grid_kind, "n_loc": n_loc,
                            "chunks": chunks, "tiles": [tl, tf]},
        launches, *work, scratch)


def estimate_pairwise_stats_rect(n_loc: int, n_full: int, d: int, *,
                                 n: Optional[int] = None,
                                 grid_kind: str = "view") -> KernelEstimate:
    """K6 on an (n_loc, d) fp32 block of the (n_full, d) stack; ``n`` the
    true worker count (the chunk count is K1's for it; default n_full).
    ``grid_kind``: "square" (the block is the stack), "view" (the block is
    rows of a stack of at most 16 rows: ``rect_view_arg``), "rect" (a
    block apart from the stack)."""
    return _rect("pairwise_stats_rect", n_loc, n_full, d, n, grid_kind,
                 r"\w*RowsIfE", False, 4, grid_kind != "rect")


def estimate_dequant_stats_rect(n_loc: int, n_full: int, d: int,
                                dtype: str = "int8", *,
                                n: Optional[int] = None,
                                square: bool = False,
                                block_in_stack: bool = True
                                ) -> KernelEstimate:
    """K7 on an (n_loc, d) payload block and the (n_full, d) gathered
    payload of ``dtype``: K5's symmetric grid when ``square`` (the block is
    the payload), else the rectangular grid (K7 has no view path).
    ``block_in_stack``: the block is a view of the gathered payload, so
    its bytes are the payload's."""
    return _rect("dequant_stats_rect", n_loc, n_full, d, n,
                 "square" if square else "rect", _DEQUANT_ROWS[dtype], True,
                 _ITEMSIZE[dtype], block_in_stack)


def bucket(theta: int) -> Tuple[int, int]:
    """The network variant's bucket (L, S] that holds θ (33..128)."""
    slots = B.kernel_slots(theta, FS.NETWORK_SLOTS)
    return _BUCKET_LOWER[slots], slots


def wide_threads(slots: int) -> int:
    """fused_select.cu ``wide_threads``: K2's network block by bucket."""
    return 128 if slots <= 48 else 64 if slots <= 96 else 96


def wide_smem_bytes(theta: int, threads: int) -> int:
    """fused_select.cu ``wide_smem_bytes``: two buffers of the weight
    pairs of ``WIDE_ROWS`` rows (row stride θ rounded up to even), then
    the column (ext, then agr) of every coordinate."""
    stride = (theta + 1) & ~1
    return 2 * WIDE_ROWS * stride * 8 + 2 * theta * WIDE_COORDS * threads * 4


def _wide_grid(want: int, threads: int, smem: int,
               registers: Optional[int] = None) -> int:
    """A network variant's grid: ``want`` blocks, at most what the card
    holds at once (by shared memory alone, an upper bound, unless
    ``registers`` a thread are given)."""
    per_sm = max(occupancy(threads, smem, registers)["blocks_per_sm"], 1)
    return min(want, per_sm * SMS)


def estimate_fused_select(n: int, d: int, theta: int, beta: int
                          ) -> KernelEstimate:
    """K2 on an (n, d) stack with a (θ, n) plan and β."""
    variant = FS.variant_name(theta)
    if theta <= FS.MAX_THETA:
        slots = theta if theta <= FS.MAX_EXACT_THETA else FS.MAX_THETA
        coords = K2_COORDS if theta <= FS.MAX_EXACT_THETA else 1
        blocks = min(_cdiv(_cdiv(d, 32 * coords), SELECT_THREADS // 32),
                     FS.MAX_BLOCKS)
        launch = Launch(f"fused_select_kernel<{slots}, {coords}>",
                        rf"fused_select_kernelILi{slots}E", (blocks,),
                        SELECT_THREADS, 0, theta * n * 8)
        scratch = 0
    elif theta <= FS.MAX_WIDE_THETA:
        lo, slots = bucket(theta)
        threads = wide_threads(slots)
        smem = wide_smem_bytes(theta, threads)
        grid = _wide_grid(_cdiv(d, WIDE_COORDS * threads), threads, smem)
        launch = Launch(f"fused_select_wide_kernel<{lo}, {slots}>",
                        rf"fused_select_wide_kernelILi{lo}ELi{slots}E",
                        (grid,), threads, 0, smem, network=True)
        scratch = 0
    else:
        want = _cdiv(d, COUNT_THREADS)
        cap = max(COUNT_SCRATCH_BYTES // (8 * theta * COUNT_THREADS), SMS)
        blocks = min(want, cap)
        launch = Launch("fused_select_count_kernel",
                        r"fused_select_count_kernel", (blocks,),
                        COUNT_THREADS, COUNT_ROWS * CANDS * 8)
        scratch = 2 * 4 * 2 * theta * blocks * COUNT_THREADS
    return KernelEstimate(
        "fused_select", n, d, {"theta": theta, "beta": int(beta),
                               "variant": variant}, (launch,),
        *B.k2_work(n, d, theta, beta), scratch)


def estimate_coord_select(theta: int, d: int, beta: int
                          ) -> KernelEstimate:
    """K3 on (θ, d) g_ext / g_agr with β."""
    variant = FS.variant_name(theta)
    blocks = min(_cdiv(d, SELECT_THREADS), CS.MAX_BLOCKS)
    if theta <= CS.MAX_THETA:
        slots = theta if theta <= FS.MAX_EXACT_THETA else CS.MAX_THETA
        launch = Launch(f"coord_select_kernel<{slots}>",
                        rf"coord_select_kernelILi{slots}E", (blocks,),
                        SELECT_THREADS, 0)
    elif theta <= FS.MAX_WIDE_THETA:
        lo, slots = bucket(theta)
        smem = theta * K3_WIDE_THREADS * 4
        grid = _wide_grid(_cdiv(d, K3_WIDE_THREADS), K3_WIDE_THREADS, smem)
        launch = Launch(f"coord_select_wide_kernel<{lo}, {slots}>",
                        rf"coord_select_wide_kernelILi{lo}ELi{slots}E",
                        (grid,), K3_WIDE_THREADS, 0, smem, network=True)
    else:
        launch = Launch("coord_select_count_kernel",
                        r"coord_select_count_kernel", (blocks,),
                        SELECT_THREADS, 0)
    return KernelEstimate(
        "coord_select", theta, d, {"theta": theta, "beta": int(beta),
                                   "variant": variant}, (launch,),
        *B.k3_work(d, theta, beta), 0)


def _dtype(t) -> str:
    return str(t.dtype)[len("torch."):]


def _rect_n(x_full, n) -> int:
    return x_full.shape[0] if n is None else int(n)


def estimate_call(kernel: str, *args, **kwargs) -> KernelEstimate:
    """The estimate of one call of a wrapper that ``kernels/ops.py``
    hooks (K1, K5, K6, K7, K2), from its own arguments (tensors on any
    device): the grid each kernel
    function takes is decided as the wrapper decides it (K6: ``is_whole``
    and ``rect_view_arg`` on the tensors)."""
    if kernel == "pairwise_stats":
        return estimate_pairwise_stats(*args[0].shape)
    if kernel == "dequant_stats":
        return estimate_dequant_stats(*args[0].shape, _dtype(args[0]))
    if kernel == "pairwise_stats_rect":
        x_loc, x_full = args
        n = _rect_n(x_full, kwargs.get("n"))
        (n_loc, d), n_full = x_loc.shape, x_full.shape[0]
        if PS.is_whole(x_loc, x_full, n):
            kind = "square"
        else:
            tiles = PS.rect_tiles(n_loc, n_full) + (0,)
            kind = "view" if PS.rect_view_arg(x_loc, x_full, tiles) >= 0 \
                else "rect"
        return estimate_pairwise_stats_rect(n_loc, n_full, d, n=n,
                                            grid_kind=kind)
    if kernel == "dequant_stats_rect":
        p_loc, m_loc, p_full, m_full = args
        n = _rect_n(p_full, kwargs.get("n"))
        square = PS.is_whole(p_loc, p_full, n) and \
            PS.is_whole(m_loc, m_full, n)
        in_stack = p_loc.untyped_storage().data_ptr() == \
            p_full.untyped_storage().data_ptr()
        return estimate_dequant_stats_rect(
            p_loc.shape[0], p_full.shape[0], p_full.shape[1], _dtype(p_full),
            n=n, square=square, block_in_stack=in_stack)
    if kernel == "fused_select":
        x, w_ext, _w_agr, beta = args
        return estimate_fused_select(x.shape[0], x.shape[1],
                                     w_ext.shape[0], beta)
    raise ValueError(f"unknown kernel {kernel!r}")


# ------------------------------------------------- against ptxas's report
def match_ptxas(launch: Launch, report: Dict[str, Dict[str, int]]
                ) -> Tuple[str, Dict[str, int]]:
    """The one entry of ptxas's report (``kernels.build.ptxas_report``)
    whose mangled name matches ``launch``; raises if none or several do."""
    hits = [(name, res) for name, res in sorted(report.items())
            if re.search(launch.pattern, name)]
    if len(hits) != 1:
        raise ValueError(f"{launch.function}: {len(hits)} kernel functions "
                         f"of ptxas's report match {launch.pattern!r}: "
                         f"{[h[0] for h in hits]}")
    return hits[0]


def against_ptxas(est: KernelEstimate, report: Dict[str, Dict[str, int]]
                  ) -> List[Dict[str, Any]]:
    """Each launch of ``est`` beside ptxas's entry for its function: the
    predicted and the reported static shared memory, the registers, the
    blocks and warps an SM those registers leave (:func:`occupancy`), the
    grid (a network launch's capped at those blocks an SM) and the bytes
    ptxas spilled.  A row's ``ok`` is False where the two static figures
    differ."""
    out = []
    for launch in est.launches:
        name, res = match_ptxas(launch, report)
        occ = occupancy(launch.threads, launch.smem, res["registers"])
        # the shared-memory cap is at least the registers' one, so capping
        # the upper bound again gives the launcher's grid
        grid = [_wide_grid(launch.grid[0], launch.threads, launch.smem,
                           res["registers"])] if launch.network \
            else list(launch.grid)
        out.append({"function": launch.function, "mangled": name,
                    "grid": grid,
                    "static_smem": launch.static_smem,
                    "ptxas_smem": res["smem_bytes"],
                    "dynamic_smem": launch.dynamic_smem,
                    "registers": res["registers"],
                    "spill_bytes": res["spill_stores"] + res["spill_loads"],
                    **occ,
                    "ok": launch.static_smem == res["smem_bytes"]})
    return out
