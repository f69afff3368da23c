"""Device-resident metrics registry (cf. ``repro.obs.metrics``).

The registry is a :class:`MetricsState` of counters, gauges and
fixed-bucket histograms whose record ops are tensor updates on the
state's device: no ``.item()``, ``float()``, ``.tolist()`` or ``.cpu()``,
so recording never waits for the card.  What may be recorded is what a
function of the step's tensors can be: accumulate now, drain on the host
later (``repro_torch.obs.export``).

The JAX module's contract, kept:

* **disabled is free**: with ``ObsConfig(enabled=False)`` (or no config
  at all) every instrumented step builder takes the code path of the
  uninstrumented one: no ``MetricsState`` is made, the record helpers
  pass ``None`` through, and the step dispatches the same aten ops in the
  same order (``tests/test_torch_obs_train.py``);
* **names are static**: the metric set is fixed by a hashable
  :class:`MetricsSpec`, so recording never changes the state's structure,
  and recording an unknown name is a silent no-op: producers (trainers,
  hier, serve) record unconditionally and the spec decides what is kept;
* **record ops are pure**: each returns a new state and leaves its
  argument unchanged.

Counters and gauges are fp32, histogram buckets int32.  The per-worker
suspicion EMA that ``repro_torch.sim`` carries across a campaign lives
here too (:func:`update_suspicion`, :func:`update_ema`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

Tensor = torch.Tensor
Device = Optional[Union[str, torch.device]]

#: a dataclass field that is configuration, not data: the checkpoint store
#: skips it and a restore takes it from the ``like`` tree (the counterpart
#: of a registered JAX dataclass's ``meta_fields``)
STATIC = {"static": True}


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """The observability switchboard (frozen, hashable).

    Step builders close over one of these (also carried by
    ``core.api.AggregatorBackend``, so every consumer of a backend sees
    the same config); ``enabled=False``, the default, is the
    uninstrumented step.

    * ``trace``: also ring-buffer span records of the
      stats→plan→apply→select_plan pipeline (``repro_torch.obs.trace``);
    * ``ring``: span ring capacity (oldest records overwritten);
    * ``suspicion_ema``: decay of the per-worker suspicion gauge.
    """

    enabled: bool = False
    trace: bool = True
    ring: int = 128
    suspicion_ema: float = 0.9

    def __post_init__(self):
        if self.ring < 1:
            raise ValueError(f"ring capacity must be >= 1, got {self.ring}")
        if not 0.0 <= self.suspicion_ema < 1.0:
            raise ValueError(
                f"suspicion_ema must be in [0, 1), got {self.suspicion_ema}")

    @property
    def on(self) -> bool:
        return self.enabled


def obs_on(obs: Optional[ObsConfig]) -> bool:
    """The one guard every instrumented builder uses."""
    return obs is not None and obs.enabled


@dataclasses.dataclass(frozen=True)
class MetricsSpec:
    """The static metric set: names, gauge shapes, histogram edges.

    Histogram ``edges`` are the sorted right bucket boundaries; a
    histogram with ``k`` edges has ``k + 1`` buckets, bucket ``i``
    counting values ``v`` with ``edges[i-1] <= v < edges[i]``
    (``searchsorted(side="right")``; bucket 0 the underflow, bucket ``k``
    the overflow).
    """

    counters: Tuple[str, ...] = ()
    gauges: Tuple[Tuple[str, Tuple[int, ...]], ...] = ()
    hists: Tuple[Tuple[str, Tuple[float, ...]], ...] = ()

    def __post_init__(self):
        # counters / gauges / hists are separate namespaces: a gauge and a
        # histogram may share a name
        for kind, names in (("counters", self.counters),
                            ("gauges", [n for n, _ in self.gauges]),
                            ("hists", [n for n, _ in self.hists])):
            if len(names) != len(set(names)):
                raise ValueError(
                    f"duplicate {kind} names in spec: {list(names)}")
        for name, edges in self.hists:
            if len(edges) < 1 or list(edges) != sorted(edges):
                raise ValueError(
                    f"histogram {name!r}: edges must be non-empty and "
                    f"sorted, got {edges}")

    def hist_edges(self, name: str) -> Tuple[float, ...]:
        for n, edges in self.hists:
            if n == name:
                return edges
        raise KeyError(f"no histogram {name!r} in spec")


@dataclasses.dataclass(frozen=True)
class MetricsState:
    """The device-resident registry: one tensor per metric.

    * ``counters[name]``: () fp32 accumulator;
    * ``gauges[name]``: fp32 tensor of the spec's shape, last write wins;
    * ``hists[name]``: (len(edges) + 1,) int32 bucket counts.

    ``spec`` and ``edges`` (each histogram's fp32 edges on the state's
    device, made once by :func:`init_metrics`) are static: the checkpoint
    store writes ``...|counters|<name>``, ``...|gauges|<name>`` and
    ``...|hists|<name>``, JAX's keys, and nothing else.
    """

    spec: MetricsSpec = dataclasses.field(metadata=STATIC)
    counters: Dict[str, Tensor]
    gauges: Dict[str, Tensor]
    hists: Dict[str, Tensor]
    edges: Dict[str, Tensor] = dataclasses.field(metadata=STATIC)


def init_metrics(spec: MetricsSpec, *, device: Device = None
                 ) -> MetricsState:
    f32 = dict(dtype=torch.float32, device=device)
    return MetricsState(
        spec=spec,
        counters={n: torch.zeros((), **f32) for n in spec.counters},
        gauges={n: torch.zeros(shape, **f32) for n, shape in spec.gauges},
        hists={n: torch.zeros((len(e) + 1,), dtype=torch.int32,
                              device=device) for n, e in spec.hists},
        edges={n: torch.tensor(e, **f32) for n, e in spec.hists})


def to_f32(value, like: Tensor) -> Tensor:
    """``value`` (a tensor on any device, or a Python number) as an fp32
    tensor on ``like``'s device; a number becomes a fill, never a copy
    from the host."""
    if isinstance(value, Tensor):
        return value.to(device=like.device, dtype=torch.float32)
    return torch.full((), float(value), dtype=torch.float32,
                      device=like.device)


def inc(state: Optional[MetricsState], name: str,
        value=1.0) -> Optional[MetricsState]:
    """Counter += value (pure; no-op when disabled or the name unknown)."""
    if state is None or name not in state.counters:
        return state
    c = dict(state.counters)
    c[name] = c[name] + to_f32(value, c[name])
    return dataclasses.replace(state, counters=c)


def set_gauge(state: Optional[MetricsState], name: str,
              value) -> Optional[MetricsState]:
    """Gauge = value (last write wins; no-op when disabled / unknown)."""
    if state is None or name not in state.gauges:
        return state
    g = dict(state.gauges)
    g[name] = to_f32(value, g[name]).reshape(g[name].shape)
    return dataclasses.replace(state, gauges=g)


def ema_gauge(state: Optional[MetricsState], name: str, value,
              ema: float) -> Optional[MetricsState]:
    """Gauge = ema·gauge + (1-ema)·value, the suspicion-carry update."""
    if state is None or name not in state.gauges:
        return state
    g = dict(state.gauges)
    v = to_f32(value, g[name]).reshape(g[name].shape)
    g[name] = ema * g[name] + (1.0 - ema) * v
    return dataclasses.replace(state, gauges=g)


def observe(state: Optional[MetricsState], name: str,
            value) -> Optional[MetricsState]:
    """Histogram: count every element of ``value`` into its bucket.

    The bucket is ``searchsorted(edges, v, right=True)`` on the state's
    fp32 edges (``np.searchsorted(side="right")``), and the counts are
    added with ``index_add`` into the fixed (k + 1,) tensor.
    ``torch.bincount`` would size its output from the largest index, a
    read back to the host.
    """
    if state is None or name not in state.hists:
        return state
    h = dict(state.hists)
    v = to_f32(value, h[name]).reshape(-1).contiguous()
    idx = torch.searchsorted(state.edges[name], v, right=True)
    h[name] = h[name].index_add(0, idx, torch.ones_like(idx,
                                                        dtype=torch.int32))
    return dataclasses.replace(state, hists=h)


# ---------------------------------------------------------- standard specs
#: log2-spaced gradient-norm buckets: underflow < 1e-3, overflow >= ~8e3
GRAD_NORM_EDGES = tuple(float(2.0 ** e) for e in range(-10, 14))


def train_spec(n_workers: int, *, telemetry: bool = False) -> MetricsSpec:
    """The registry both synchronous trainers record into."""
    gauges = [("loss", ()), ("agg_grad_norm", ())]
    if telemetry:
        gauges += [("suspicion", (n_workers,)), ("byz_mass", ())]
    return MetricsSpec(counters=("rounds",),
                       gauges=tuple(gauges),
                       hists=(("agg_grad_norm", GRAD_NORM_EDGES),))


def serve_spec(n_workers: int, tau: int, *,
               telemetry: bool = False) -> MetricsSpec:
    """The async service registry: staleness accounting on top of train.

    The ``staleness_age`` histogram has one bucket per admissible age
    ``0..tau`` plus the overstale overflow bucket (edges at ``i + 0.5``),
    so the drained snapshot reads as "how stale were the slots each
    round".
    """
    age_edges = tuple(float(i) + 0.5 for i in range(tau + 1))
    gauges = [("loss", ()), ("agg_grad_norm", ()), ("f_defended", ())]
    if telemetry:
        gauges += [("suspicion", (n_workers,)), ("byz_mass", ())]
    return MetricsSpec(
        counters=("rounds", "admitted", "overstale_slots", "degraded"),
        gauges=tuple(gauges),
        hists=(("agg_grad_norm", GRAD_NORM_EDGES),
               ("staleness_age", age_edges)))


# ------------------------------------------------- suspicion EMA (campaigns)
def init_suspicion(n_workers: int, *, device: Device = None) -> Tensor:
    return torch.zeros((n_workers,), dtype=torch.float32, device=device)


def update_suspicion(susp: Tensor, selection: Tensor, ema: float) -> Tensor:
    """EMA of per-worker rejection.

    A worker's per-step rejection is ``1 - selection_i / max_j selection_j``
    (0 for the most-trusted worker, 1 for a fully rejected one) — normalised
    so weighted rules and uniform rules land on the same scale.
    """
    rej = 1.0 - selection / (torch.max(selection) + 1e-12)
    return ema * susp + (1.0 - ema) * rej


def update_ema(prev: Tensor, value: Tensor, ema: float) -> Tensor:
    """Plain per-worker EMA — the suspicion-carry pattern for any 0/1
    indicator (the async service uses it on the per-round overstale mask,
    so campaigns report *sustained* staleness per worker, not one-round
    blips)."""
    return ema * prev + (1.0 - ema) * value.float()
