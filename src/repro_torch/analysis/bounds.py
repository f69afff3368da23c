"""The bound arithmetic of the port's kernels on an H100: the one source
of the ``bound_ms`` figures that ``chip_smoke.py``, ``tools/time_k1.py``
and ``analysis/smem.py``'s estimates give.

Each ``k*_work`` function gives a kernel call's (bytes read, bytes
written, fp32 operations): each input read once, each output written
once, and the operations of the algorithm the kernel runs.  Each
``k*_bound_s`` gives that work's least seconds by bytes and by operations
(:func:`work_bound_s`); the bound is the larger of the two.

This module imports nothing of the package, so that a tool can load it by
its path and measure several checkouts against one version of the
arithmetic.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

#: NVIDIA H100 SXM data sheet: HBM3 rate and fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

Work = Tuple[int, int, int]


def bound_s(nbytes: float, ops: float) -> Dict[str, float]:
    """{"bytes": seconds, "operations": seconds} of work that moves
    ``nbytes`` through HBM and does ``ops`` fp32 operations."""
    return {"bytes": nbytes / HBM_BYTES_PER_S,
            "operations": ops / FP32_FLOP_PER_S}


def bytes_bound_s(nbytes: float) -> float:
    """Seconds to move ``nbytes`` through HBM."""
    return nbytes / HBM_BYTES_PER_S


def work_bound_s(read: int, written: int, ops: int) -> Dict[str, float]:
    """:func:`bound_s` of a ``k*_work`` triple."""
    return bound_s(read + written, ops)


def k1_work(n: int, m: int) -> Work:
    """K1 on an (n, m) fp32 stack: the stack read once, the (n, n) and
    (n,) results written once; the gram's upper triangle in fp32."""
    return 4 * n * m, 4 * (n * n + n), n * (n + 1) * m


def k1_bound_s(n: int, m: int) -> Dict[str, float]:
    return work_bound_s(*k1_work(n, m))


def k4_work(n: int, m: int, itemsize: int = 4) -> Work:
    """K4 on an (n, m) stack of ``itemsize`` bytes an element: the stack
    read once, the (n, n) written once; K1's operations."""
    return itemsize * n * m, 4 * n * n, n * (n + 1) * m


def k4_bound_s(n: int, m: int) -> Dict[str, float]:
    return work_bound_s(*k4_work(n, m))


def k5_work(n: int, m: int, itemsize: int) -> Work:
    """K5 on an (n, m) payload of ``itemsize`` bytes an element: the
    payload and the multipliers read once, the outputs written once; K1's
    operations plus one decode multiply an element."""
    return (n * m * itemsize + 4 * n, 4 * (n * n + n),
            (n * (n + 1) + n) * m)


def k5_bound_s(n: int, m: int, itemsize: int) -> Dict[str, float]:
    return work_bound_s(*k5_work(n, m, itemsize))


def rect_work(in_bytes: int, n_loc: int, n_full: int, m: int,
              decode: int = 0) -> Work:
    """K6 / K7 on an (n_loc, m) block against an (n_full, m) stack:
    ``in_bytes`` read once (a block that is a view of the stack is the
    stack's bytes), the (n_loc, n_full) block and (n_full,) norms written
    once; the block's products and the stack's squares (2 a multiply-add;
    a block that is the whole stack needs only the gram's upper triangle,
    as K1's bound counts), and ``decode`` multiplies a column for a
    payload."""
    products = n_full * (n_full + 1) if n_loc == n_full else \
        2 * (n_loc * n_full + n_full)
    return in_bytes, 4 * (n_loc * n_full + n_full), (products + decode) * m


def rect_bound_s(in_bytes: int, n_loc: int, n_full: int, m: int,
                 decode: int = 0) -> Dict[str, float]:
    return work_bound_s(*rect_work(in_bytes, n_loc, n_full, m, decode))


def matmuls_bound_s(n: int, m: int, theta: int) -> Dict[str, float]:
    """The two-step apply's two products: the stack and a (θ, n) weight
    matrix read, θ rows written, 2 θ n operations a coordinate, each of
    the two."""
    return bound_s(2 * 4 * (n * m + theta * n + theta * m),
                   2 * 2 * theta * n * m)


def network_exchanges(slots: int) -> int:
    """Compare-exchanges of select_tile.cuh's Batcher odd-even merge sort
    on ``slots`` slots (its ``Network<N>::size()``)."""
    c, p = 0, 1
    while p < slots:
        k = p
        while k >= 1:
            for j in range(k % p, slots - k, 2 * k):
                c += sum((i + j) // (2 * p) == (i + j + k) // (2 * p)
                         for i in range(min(k, slots - j - k)))
            k //= 2
        p *= 2
    return c


def kernel_slots(theta: int, network_slots: Sequence[int]) -> int:
    """The register slots the kernels' selection runs on at ``theta``:
    θ up to 16, 32 up to 32, the network variant's bucket above
    (``network_slots``, ``fused_select.NETWORK_SLOTS``: the least that
    holds θ), θ above the last bucket (the counted kernels there rank
    every pair instead)."""
    if theta <= 32:
        return theta if theta <= 16 else 32
    return next((s for s in network_slots if theta <= s), theta)


def select_phase_ops(theta: int, beta: int,
                     slots: Optional[int] = None) -> int:
    """fp32 operations of one coordinate's phase as select_tile.cuh's
    algorithm runs it for K2 and K3 on ``slots`` register slots: the
    median's network, two operations an exchange, and the midpoint for an
    even θ; θ differences and abs values; the threshold (θ - 1 mins for
    β = 1, the network again otherwise); a compare below and a compare at
    it a slot, β adds and the division.  ``slots`` defaults to the
    yardstick that versions of the kernels are compared on: θ up to 16,
    32 up to 32, the next power of two above.  :func:`kernel_slots` gives
    the slots the kernels run on: the same up to 32, their bucket's up to
    128 (fewer operations, so a tighter bound), θ above, where the counted
    kernels rank every pair (about 8 θ^2 operations, their algorithm's
    cost, which neither count charges).  Both count this algorithm's
    operations, not the least any algorithm could need."""
    if slots is None:
        slots = theta if theta <= 16 else 32 if theta <= 32 \
            else 1 << (theta - 1).bit_length()
    net = 2 * network_exchanges(slots)
    threshold = theta - 1 if beta == 1 else net
    return net + (0 if theta & 1 else 2) + 2 * theta + threshold \
        + 2 * theta + beta + 1


def k2_work(n: int, m: int, theta: int, beta: int,
            slots: Optional[int] = None) -> Work:
    """K2 on an (n, m) stack: the stack and the two (θ, n) weights read
    once, the (m,) result written once; the two contractions (a multiply
    and an add each a weight) and the coordinate phase
    (:func:`select_phase_ops` on ``slots``)."""
    return (4 * (n * m + 2 * theta * n), 4 * m,
            (4 * theta * n + select_phase_ops(theta, beta, slots)) * m)


def k2_bound_s(n: int, m: int, theta: int, beta: int,
               slots: Optional[int] = None) -> Dict[str, float]:
    return work_bound_s(*k2_work(n, m, theta, beta, slots))


def k3_work(m: int, theta: int, beta: int,
            slots: Optional[int] = None) -> Work:
    """K3 on (θ, m) g_ext and g_agr: both read once, the (m,) result
    written once; the coordinate phase's operations on ``slots``."""
    return 4 * 2 * theta * m, 4 * m, select_phase_ops(theta, beta, slots) * m


def k3_bound_s(m: int, theta: int, beta: int,
               slots: Optional[int] = None) -> Dict[str, float]:
    return work_bound_s(*k3_work(m, theta, beta, slots))
