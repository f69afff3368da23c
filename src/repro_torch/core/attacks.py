"""Byzantine worker attacks, gradient space (cf. ``repro.core.attacks``).

An attack is a function ``(G_correct, f, gen) -> G_byz`` mapping the stack
of the n-f correct gradients ``(n-f, d)`` to the ``(f, d)`` byzantine
proposals; ``gen`` is a ``torch.Generator`` (only ``gaussian`` draws from
it).  The stack handed to the GAR is ``concat([G_byz, G_correct])``.

Attacks are addressed by spec string: a bare registry name or a name with
keyword overrides (``"sign_flip:scale=5"``).  The adaptive and wire attacks
of the JAX module are not ported yet.
"""
from __future__ import annotations

import inspect
from typing import Callable, Dict, Optional, Tuple

import torch

Tensor = torch.Tensor
Attack = Callable[[Tensor, int, Optional[torch.Generator]], Tensor]


def _rows(g: Tensor, f: int) -> Tensor:
    return g.unsqueeze(0).expand((f,) + tuple(g.shape))


def no_attack(G: Tensor, f: int, gen=None) -> Tensor:
    """f extra honest-like gradients (the mean) — the 'mild' case."""
    return _rows(torch.mean(G, dim=0), f)


def sign_flip(G: Tensor, f: int, gen=None, scale: float = 1.0) -> Tensor:
    """Send the negated mean gradient, scaled."""
    return _rows(-scale * torch.mean(G, dim=0), f)


def gaussian_noise(G: Tensor, f: int, gen=None, sigma: float = 10.0
                   ) -> Tensor:
    """Pure noise of large magnitude (torch's generator: the JAX package's
    draws differ, so this matches it in distribution only)."""
    d = G.shape[-1]
    z = torch.randn((f, d), generator=gen, dtype=torch.float32,
                    device=gen.device if gen is not None else G.device)
    return (sigma * z).to(device=G.device, dtype=G.dtype)


def inf_attack(G: Tensor, f: int, gen=None) -> Tensor:
    """Huge-magnitude vectors (hardware-fault / overflow model)."""
    g = torch.mean(G, dim=0)
    return _rows(1e30 * torch.sign(g + 1e-30), f).to(G.dtype)


def little_is_enough(G: Tensor, f: int, gen=None, z: float = 1.5) -> Tensor:
    """Baruch et al. 2019: shift the mean by z per-coordinate deviations."""
    mu = torch.mean(G, dim=0)
    sd = torch.std(G, dim=0, correction=0)
    return _rows(mu - z * sd, f)


def mimic(G: Tensor, f: int, gen=None) -> Tensor:
    """All byzantine workers copy one correct gradient."""
    return _rows(G[0], f)


def omniscient_reverse(G: Tensor, f: int, gen=None, eps: float = 0.1
                       ) -> Tensor:
    """Bend the mean toward its negation within the point cloud radius."""
    mu = torch.mean(G, dim=0)
    radius = torch.sqrt(torch.max(torch.sum((G - mu[None]) ** 2, dim=1)))
    direction = -mu / (torch.linalg.norm(mu) + 1e-30)
    return _rows(mu + (1.0 - eps) * radius * direction, f)


ATTACKS: Dict[str, Attack] = {
    "none": no_attack,
    "sign_flip": sign_flip,
    "gaussian": gaussian_noise,
    "inf": inf_attack,
    "little_is_enough": little_is_enough,
    "mimic": mimic,
    "omniscient": omniscient_reverse,
}


def parse_spec(spec: str) -> Tuple[str, Dict[str, float]]:
    """Split ``"name:k1=v1,k2=v2"`` into ``(name, {k1: v1, ...})``; values
    parse as floats, a bare name parses to ``(name, {})``."""
    name, _, rest = spec.partition(":")
    kwargs: Dict[str, float] = {}
    for item in filter(None, rest.split(",")):
        k, eq, v = item.partition("=")
        if not eq or not k:
            raise ValueError(
                f"bad spec item {item!r} in {spec!r} (want key=value)")
        try:
            kwargs[k] = float(v)
        except ValueError:
            raise ValueError(
                f"non-numeric value {v!r} for {k!r} in spec {spec!r}") from None
    return name, kwargs


def get_attack(spec: str) -> Attack:
    """Resolve an attack spec (``"name"`` or ``"name:k=v,..."``)."""
    name, kwargs = parse_spec(spec)
    try:
        fn = ATTACKS[name]
    except KeyError:
        raise KeyError(f"unknown attack {name!r}; available: "
                       f"{sorted(ATTACKS)}") from None
    if not kwargs:
        return fn
    params = inspect.signature(fn).parameters
    tunable = {k for k, p in params.items()
               if p.default is not p.empty and k != "gen"}
    unknown = set(kwargs) - tunable
    if unknown:
        raise ValueError(f"attack {name!r} has no parameter(s) "
                         f"{sorted(unknown)}; tunable: {sorted(tunable)}")

    def bound(G: Tensor, f: int, gen=None) -> Tensor:
        return fn(G, f, gen, **kwargs)

    bound.__name__ = name
    return bound


def apply_attack(G_correct: Tensor, f: int, name: str,
                 gen: Optional[torch.Generator] = None) -> Tensor:
    """The full (n, d) stack: byzantine rows first, then correct."""
    if f == 0:
        return G_correct
    byz = get_attack(name)(G_correct, f, gen)
    return torch.cat([byz.to(G_correct.dtype), G_correct], dim=0)
