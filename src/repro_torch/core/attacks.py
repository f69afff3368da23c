"""Byzantine worker attacks, gradient space (cf. ``repro.core.attacks``).

An attack is a function ``(G_correct, f, gen) -> G_byz`` mapping the stack
of the n-f correct gradients ``(n-f, d)`` to the ``(f, d)`` byzantine
proposals; ``gen`` is a ``torch.Generator`` (only ``gaussian`` draws from
it).  The stack handed to the GAR is ``concat([G_byz, G_correct])``.

Attacks are addressed by spec string: a bare registry name or a name with
keyword overrides (``"sign_flip:scale=5"``).

Adaptive attacks (``ADAPTIVE``) carry a small state across steps and
receive plan feedback, the previous round's per-worker selection weights:
the adaptive little-is-enough tunes its z to sit just under the rejection
threshold, the adaptive mimic copies whichever honest worker the plan
trusts most.  The stacked trainer threads their state
(``dist.trainer.make_train_step``).  The wire attacks, which forge the
encoded messages of a ``repro_torch.comm`` wire, are at the end of the
module.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Dict, Optional, Tuple, Union

import torch

Tensor = torch.Tensor
Attack = Callable[[Tensor, int, Optional[torch.Generator]], Tensor]
State = Dict[str, Tensor]


def fold_seed(seed: int, data: int) -> int:
    """A seed derived from ``(seed, data)``: the counterpart of
    ``jax.random.fold_in`` for the port's integer seeds."""
    return (seed * 1_000_003 + data) % (2 ** 63)


def leaf_generator(device: Union[str, torch.device], seed: int,
                   leaf_index: int) -> torch.Generator:
    """The generator leaf ``leaf_index`` of a step draws from, on
    ``device``, seeded by ``fold_seed(seed, leaf_index)``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(fold_seed(seed, leaf_index))
    return gen


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
                       f"{sorted(ATTACKS)} (adaptive: {sorted(ADAPTIVE)})"
                       ) from None
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


# --------------------------------------------------------------------------
# adaptive (plan-feedback) attacks
#
# ``init_state(n, f, device=)`` returns a dict of fp32 tensors on
# ``device``; ``propose(G, f, gen, state)`` maps the (n-f, d) correct
# stack to (f, d) proposals exactly like a static attack;
# ``update(state, selection)`` consumes the plan's per-worker selection
# weights (convex (n,) vector, byzantine rows first) after the round and
# returns the next state.  Neither reads a value back to the host.
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AdaptiveAttack:
    name: str = ""

    def init_state(self, n: int, f: int, device=None) -> State:
        raise NotImplementedError

    def propose(self, G: Tensor, f: int, gen, state: State) -> Tensor:
        raise NotImplementedError

    def update(self, state: State, selection: Tensor) -> State:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class AdaptiveLittleIsEnough(AdaptiveAttack):
    """Little-is-enough with a feedback-tuned z (Baruch et al. + probing).

    While the byzantine rows keep winning at least half their uniform share
    of the selection mass, push z up by ``up``; once the plan rejects them,
    back off by ``down`` until re-admitted.
    """

    name: str = "adaptive_lie"
    z0: float = 1.0
    up: float = 1.15
    down: float = 0.7
    z_min: float = 0.25
    z_max: float = 16.0

    def init_state(self, n: int, f: int, device=None) -> State:
        return {"z": torch.tensor(self.z0, dtype=torch.float32,
                                  device=device),
                "share": torch.tensor(f / max(n, 1), dtype=torch.float32,
                                      device=device)}

    def propose(self, G: Tensor, f: int, gen, state: State) -> Tensor:
        mu = torch.mean(G, dim=0)
        sd = torch.std(G, dim=0, correction=0)
        return _rows(mu - state["z"] * sd, f).to(G.dtype)

    def update(self, state: State, selection: Tensor) -> State:
        # byzantine rows come first (inject_byzantine); round half to even
        # in fp32, as jnp.round
        n = selection.shape[0]
        share = state["share"]
        f_rows = torch.clamp(torch.round(share * n).to(torch.int32), min=1)
        rows = torch.arange(n, device=selection.device)
        byz_mass = torch.sum(torch.where(rows < f_rows, selection.float(),
                                         0.0))
        z = torch.where(byz_mass >= 0.5 * share, state["z"] * self.up,
                        state["z"] * self.down)
        return {"z": torch.clamp(z, self.z_min, self.z_max), "share": share}


@dataclasses.dataclass(frozen=True)
class AdaptiveMimic(AdaptiveAttack):
    """Mimic steered by the plan: copy the most-trusted honest worker.

    Tracks an EMA of each honest worker's selection weight and clones the
    current argmax (the first one: at step 0 every trust is 0, so honest
    row 0).
    """

    name: str = "adaptive_mimic"
    ema: float = 0.9

    def init_state(self, n: int, f: int, device=None) -> State:
        return {"trust": torch.zeros((n - f,), dtype=torch.float32,
                                     device=device)}

    def propose(self, G: Tensor, f: int, gen, state: State) -> Tensor:
        # index_select keeps the argmax on the device
        target = torch.argmax(state["trust"]).reshape(1).to(G.device)
        return _rows(torch.index_select(G, 0, target)[0], f).to(G.dtype)

    def update(self, state: State, selection: Tensor) -> State:
        n_honest = state["trust"].shape[0]
        honest_sel = selection[selection.shape[0] - n_honest:].float()
        return {"trust": self.ema * state["trust"]
                + (1.0 - self.ema) * honest_sel}


ADAPTIVE: Dict[str, Callable[..., AdaptiveAttack]] = {
    "adaptive_lie": AdaptiveLittleIsEnough,
    "adaptive_mimic": AdaptiveMimic,
}


def is_adaptive(spec: str) -> bool:
    return parse_spec(spec)[0] in ADAPTIVE


def get_adaptive(spec: str) -> AdaptiveAttack:
    """Resolve an adaptive attack spec to a configured instance."""
    name, kwargs = parse_spec(spec)
    try:
        cls = ADAPTIVE[name]
    except KeyError:
        raise KeyError(
            f"unknown adaptive attack {name!r}; "
            f"available: {sorted(ADAPTIVE)}") from None
    fields = {fl.name for fl in dataclasses.fields(cls) if fl.name != "name"}
    unknown = set(kwargs) - fields
    if unknown:
        raise ValueError(
            f"adaptive attack {name!r} has no parameter(s) {sorted(unknown)}; "
            f"tunable: {sorted(fields)}")
    return cls(**kwargs)


# --------------------------------------------------------------------------
# wire attacks
#
# With a codec on the wire the adversary controls its messages, not its
# gradients: the payload and the scale sidecar are separate fields a GAR
# only sees after decode.  A wire attack is
# ``(P_correct, S_correct, f, gen) -> (P_byz, S_byz)`` per leaf, where
# ``P_correct`` is the (n-f, ...) stack of honest payload rows and
# ``S_correct`` the matching sidecar rows (``None`` for sidecar-free
# codecs).  Byzantine rows stay wire-legal (same dtype and shape): the
# attack model is a malicious worker, not a corrupted channel.
# --------------------------------------------------------------------------
WireAttack = Callable[[Tensor, Optional[Tensor], int,
                       Optional[torch.Generator]],
                      Tuple[Tensor, Optional[Tensor]]]


def scale_poison(P: Tensor, S: Optional[Tensor], f: int, gen=None,
                 gain: float = 100.0) -> Tuple[Tensor, Optional[Tensor]]:
    """Honest-looking payload, poisoned sidecar: copy a correct worker's
    payload rows verbatim and multiply its dequant multiplier by
    ``-gain`` (the decoded rows point ``-gain`` times along a correct
    gradient).  Sidecar-free codecs (and top-k's index sidecar) scale the
    payload itself instead, saturating in int8 so the wire stays legal."""
    shape = (f,) + tuple(P.shape[1:])
    if S is None or not S.is_floating_point():
        scaled = -gain * P[:1].float()
        if not P.is_floating_point():
            info = torch.iinfo(P.dtype)
            scaled = torch.clamp(torch.round(scaled), info.min, info.max)
        Pb = scaled.to(P.dtype).expand(shape)
        Sb = None if S is None else S[:1].expand((f,) + tuple(S.shape[1:]))
        return Pb, Sb
    Sb = (-gain * S[:1]).to(S.dtype).expand((f,) + tuple(S.shape[1:]))
    return P[:1].expand(shape), Sb


def payload_flip(P: Tensor, S: Optional[Tensor], f: int, gen=None
                 ) -> Tuple[Tensor, Optional[Tensor]]:
    """Negate a correct worker's payload rows and keep its sidecar: the
    wire form of ``sign_flip``, invisible to any scale-level check."""
    shape = (f,) + tuple(P.shape[1:])
    if not P.is_floating_point():
        info = torch.iinfo(P.dtype)
        neg = torch.clamp(-P[:1].to(torch.int32), info.min, info.max)
        Pb = neg.to(P.dtype).expand(shape)
    else:
        Pb = (-P[:1]).expand(shape)
    Sb = None if S is None else S[:1].expand((f,) + tuple(S.shape[1:]))
    return Pb, Sb


WIRE_ATTACKS: Dict[str, WireAttack] = {
    "scale_poison": scale_poison,
    "payload_flip": payload_flip,
}


def is_wire_attack(spec: str) -> bool:
    return parse_spec(spec)[0] in WIRE_ATTACKS


def get_wire_attack(spec: str) -> WireAttack:
    """Resolve a wire-attack spec to a callable (same grammar as attacks)."""
    name, kwargs = parse_spec(spec)
    try:
        fn = WIRE_ATTACKS[name]
    except KeyError:
        raise KeyError(f"unknown wire attack {name!r}; available: "
                       f"{sorted(WIRE_ATTACKS)}") from None
    if not kwargs:
        return fn
    params = inspect.signature(fn).parameters
    tunable = {k for k, p in params.items()
               if p.default is not p.empty and k != "gen"}
    unknown = set(kwargs) - tunable
    if unknown:
        raise ValueError(f"wire attack {name!r} has no parameter(s) "
                         f"{sorted(unknown)}; tunable: {sorted(tunable)}")

    def bound(P, S, f, gen=None):
        return fn(P, S, f, gen, **kwargs)

    bound.__name__ = name
    return bound
