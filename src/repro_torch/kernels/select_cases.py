"""The θ > 32 cases that K2's and K3's network and counted variants are
held to.

One grid, drawn from seeds, that the card tests
(``tests/test_torch_kernels.py``) and ``chip_smoke.py`` both run: each
case's kernel output must be its plain version's (``ref.fused_select_ref``
or ``ref.coord_select_ref``) bit for bit, NaN in the same places.  A case
is ``(label, args, non_finite)``: the kernel's arguments, and whether its
inputs hold NaN, ±inf, ±0 and 1e30 (the plain output then holds NaN).
Every tensor is drawn on the CPU and moved to ``device``, so a case is the
same on every device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_select import NETWORK_SLOTS

#: θ above the register kernels' 32 slots: each side of every bucket's
#: edge (33 and 129 included), so odd and even θ, and the main path's 34
#: (n = 40, f = 2) and 41 (n = 49, f = 3), neither a multiple of the
#: contraction's 16-slot passes
WIDE_THETAS = tuple(sorted({33, 34, 41, *NETWORK_SLOTS,
                            *(s + 1 for s in NETWORK_SLOTS)}))
#: one column, widths that end inside a 128-column block, and one that
#: runs the grid-stride loop once a large θ caps the grid
WIDE_WIDTHS = (1, 31, 257, 100_003)
#: the width of the non-finite cases
NON_FINITE_WIDTH = 4099
SPECIALS = (float("nan"), float("inf"), float("-inf"), 0.0, -0.0, 1e30)


def betas(theta: int) -> list[int]:
    """β in {1, ⌈θ/2⌉, θ}: the nearest one, half, and the mean."""
    return sorted({1, -(-theta // 2), theta})


def _generator(seed: int) -> torch.Generator:
    gen = torch.Generator()
    gen.manual_seed(seed)
    return gen


def stack(n: int, d: int, seed: int, device) -> torch.Tensor:
    """(n, d) fp32: row i is N(0, (1 + 0.1 i)^2) noise."""
    x = torch.randn((n, d), generator=_generator(seed))
    return x.mul_(1.0 + 0.1 * torch.arange(n, dtype=torch.float32)[:, None]
                  ).to(device)


def synthetic_plan(theta: int, n: int, seed: int, device):
    """(θ, n) weights as a multi-Bulyan plan shapes them: ``w_ext``
    one-hot (rows drawn with repeats, so extracted values tie), ``w_agr``
    uniform 1/m over m drawn rows (every third slot repeats the one
    before, so distances tie)."""
    gen = _generator(seed)
    w_ext = torch.zeros((theta, n))
    w_ext[torch.arange(theta), torch.randint(0, n, (theta,),
                                             generator=gen)] = 1.0
    w_agr = torch.zeros((theta, n))
    for t in range(theta):
        if t % 3 == 2:
            w_agr[t] = w_agr[t - 1]
            continue
        m = int(torch.randint(1, n + 1, (1,), generator=gen))
        rows = torch.randperm(n, generator=gen)[:m]
        w_agr[t, rows] = torch.tensor(1.0) / torch.tensor(float(m))
    return w_ext.to(device), w_agr.to(device)


def coord_inputs(theta: int, d: int, seed: int, ties: bool, device):
    """(θ, d) g_ext and g_agr, N(0, 1) noise; with ``ties`` every g_agr
    value lies 1 from the median 0 (rows alternate +1 / -1, so the tie
    order shows in the result)."""
    gen = _generator(seed)
    ge = torch.randn((theta, d), generator=gen)
    ga = torch.randn((theta, d), generator=gen)
    if ties:
        ge.zero_()
        ga.fill_(1.0)
        ga[1::2] = -1.0
    return ge.to(device), ga.to(device)


def with_specials(x: torch.Tensor) -> torch.Tensor:
    """``x`` (n, d) with NaN, ±inf, ±0 and 1e30 placed: column j holds
    SPECIALS[j % 6] in row 3 j mod n, and every fifth column NaN in its
    first j mod (n + 1) rows (up to every row: a NaN median)."""
    n, d = x.shape
    cols = torch.arange(d, device=x.device)
    vals = torch.tensor(SPECIALS, dtype=x.dtype, device=x.device)
    x[(3 * cols) % n, cols] = vals[cols % len(SPECIALS)]
    rows = torch.arange(n, device=x.device)[:, None]
    x[(rows < (cols % (n + 1))[None]) & (cols % 5 == 0)[None]] = float("nan")
    return x


def k2_cases(theta: int, n: int, device):
    """K2's cases at (θ, n): one-hot / uniform plan weights with ties, β
    in :func:`betas` at every width of WIDE_WIDTHS, then one non-finite
    stack at β = ⌈θ/2⌉."""
    w_ext, w_agr = synthetic_plan(theta, n, theta * 100 + n, device)
    for d in WIDE_WIDTHS:
        x = stack(n, d, theta + n + d, device)
        for beta in betas(theta):
            yield (f"K2 theta={theta} n={n} beta={beta} d={d}",
                   (x, w_ext, w_agr, beta), False)
    x = with_specials(stack(n, NON_FINITE_WIDTH, n, device))
    beta = -(-theta // 2)
    yield (f"K2 theta={theta} n={n} beta={beta} non-finite",
           (x, w_ext, w_agr, beta), True)


def k3_cases(theta: int, ties: bool, device):
    """K3's cases at θ: normal or all-tied inputs, β in :func:`betas` at
    every width of WIDE_WIDTHS; without ``ties`` also NaN-laden inputs at
    β = ⌊θ/3⌋."""
    for d in WIDE_WIDTHS:
        ge, ga = coord_inputs(theta, d, theta + d, ties, device)
        for beta in betas(theta):
            yield (f"K3 theta={theta} beta={beta} d={d} ties={ties}",
                   (ge, ga, beta), False)
    if not ties:
        ge, ga = coord_inputs(theta, NON_FINITE_WIDTH, theta, False, device)
        yield (f"K3 theta={theta} beta={theta // 3} non-finite",
               (with_specials(ge), with_specials(ga), theta // 3), True)
