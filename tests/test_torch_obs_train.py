"""``obs=`` through the port's steps (``repro_torch.dist``,
``repro_torch.hier``, ``repro_torch.serve``, ``repro_torch.sim``) against
the JAX package, on the CPU, at JAX's ``obs-tiny`` size (1 layer,
d_model 32, vocab 64, n = 7, f = 1), activations fp32 on both sides:

* disabled is free: the ``obs=None`` and ``ObsConfig(enabled=False)``
  steps dispatch the same aten ops in the same order (recorded by a
  ``TorchDispatchMode``), give the same launch counts and leave
  ``mstate`` ``None``;
* enabled, the parameters are bit for bit the disabled step's and the
  spans come in pipeline order;
* the registry against JAX's after two steps with ``telemetry=True``
  (stacked, both streaming scopes, stacked ``hier``) and four async
  rounds: counters exact, gauges within ``rtol=1e-4`` (``atol=1e-6``),
  histogram counts exact (each ``agg_grad_norm`` at least 1e-3 relative
  from every bucket edge, so an fp32 rounding cannot move a bucket),
  span seq / round / phase exact and payloads within ``rtol=1e-4``;
* ``run_campaign(obs=)`` against JAX's live ``repro.sim.run_campaign``
  (not ``tests/fixtures_obs/golden_summary.json``), and a resumed
  campaign's snapshot equal to the uninterrupted run's.
"""
import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import models as JMD
from repro import obs as JOBS
from repro.configs.base import ArchConfig as JArch
from repro.configs.base import RobustConfig as JRobust
from repro.data.synthetic import make_lm_batch
from repro.dist import streaming as JST
from repro.dist import trainer as JTR
from repro.hier import GroupConfig as JGroup
from repro.models import modules as JM
from repro.optim import optimizers as JO
from repro.optim import schedules as JS
from repro.core import api as JAPI
from repro.serve import service as JSV
from repro.sim import engine as JEN
from repro.sim import scenario as JSC
from repro_torch import models as TMD
from repro_torch import obs as TOBS
from repro_torch.configs import ArchConfig, RobustConfig
from repro_torch.core import api as TAPI
from repro_torch.dist import streaming as TST
from repro_torch.dist import trainer as TTR
from repro_torch.hier import GroupConfig
from repro_torch.kernels import ops
from repro_torch.optim import optimizers as TO
from repro_torch.optim import schedules as TS
from repro_torch.serve import service as TSV
from repro_torch.sim import engine as TEN
from repro_torch.sim import scenario as TSC
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

#: JAX's ``tests/test_obs.py`` model
OBS_TINY = dict(name="obs-tiny", family="dense", n_layers=1, d_model=32,
                n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=64)
N, F, SEQ, TAU = 7, 1, 16, 1
RTOL, ATOL = 1e-4, 1e-6
ON = dict(enabled=True, ring=32)


@pytest.fixture
def fp32_jax(monkeypatch):
    """The JAX package casts activations to bf16 at the embedding; the
    parity runs cast to fp32 there instead."""
    monkeypatch.setattr(JM, "embedding_apply", functools.partial(
        JM.embedding_apply, dtype=jnp.float32))


def _params():
    jparams = JMD.init_model(jax.random.key(0), JArch(**OBS_TINY))
    return jparams, TMD.params_from_jax(jax.tree.map(np.asarray, jparams),
                                        device="cpu")


def _batches(n, rounds):
    """(JAX's, the port's) worker-split batch of each round."""
    out = []
    for r in range(rounds):
        b = make_lm_batch(jax.random.key(r + 1), OBS_TINY["vocab_size"], n,
                          SEQ)
        b = {k: np.array(v) for k, v in b.items()}
        out.append((JTR.split_workers({k: jnp.asarray(v)
                                       for k, v in b.items()}, n),
                    TTR.split_workers({k: torch.tensor(v).long()
                                       for k, v in b.items()}, n)))
    return out


def _port_step(kind, obs, n=N, f=F, attack="sign_flip", telemetry=True):
    """(optimizer, step) of the port's trainer ``kind``: ``stacked``,
    ``stream_global``, ``stream_block`` or ``hier`` (stacked, g = 7)."""
    opt = TO.sgd(momentum=0.9)
    rcfg = RobustConfig(n_workers=n, f=f, grouped=kind == "hier")
    cfg = ArchConfig(**OBS_TINY, dtype="float32")
    kw = dict(chunk_q=SEQ, attack=attack, telemetry=telemetry, obs=obs)
    if kind.startswith("stream"):
        return opt, TST.make_streaming_train_step(
            cfg, rcfg, opt, TS.constant(0.05), scope=kind[7:], **kw)
    return opt, TTR.make_train_step(
        cfg, rcfg, opt, TS.constant(0.05),
        hier=GroupConfig(g=7) if kind == "hier" else None, **kw)


def _jax_step(kind, obs, n=N, f=F, attack="sign_flip"):
    opt = JO.sgd(momentum=0.9)
    rcfg = JRobust(n_workers=n, f=f, grouped=kind == "hier")
    kw = dict(chunk_q=SEQ, attack=attack, telemetry=True, obs=obs)
    if kind.startswith("stream"):
        step = JST.make_streaming_train_step(
            JArch(**OBS_TINY), rcfg, opt, JS.constant(0.05),
            scope=kind[7:], **kw)
    else:
        step = JTR.make_train_step(
            JArch(**OBS_TINY), rcfg, opt, JS.constant(0.05),
            hier=JGroup(g=7) if kind == "hier" else None, **kw)
    return opt, jax.jit(step)


def _far_from_edges(records, edges):
    """Each round's aggregate norm (its last apply span's payload; under
    ``hier`` the levels' spans come first) at least 1e-3 relative from
    every edge."""
    norms = {r["round"]: r["payload"] for r in records
             if r["phase"] == "apply"}
    for g in norms.values():
        assert min(abs(g - e) / e for e in edges) >= 1e-3, g


def _assert_mstate_close(tms, jms):
    """The port's mstate against JAX's: counters exact, gauges within
    RTOL / ATOL, histograms exact, spans exact but their payloads."""
    got = TOBS.metrics_to_json(tms["m"])
    want = JOBS.metrics_to_json(jax.tree.map(np.asarray, jms["m"]))
    assert got["counters"] == want["counters"]
    assert sorted(got["gauges"]) == sorted(want["gauges"])
    for k in want["gauges"]:
        np.testing.assert_allclose(got["gauges"][k], want["gauges"][k],
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert got["hists"] == want["hists"]
    tr, jr = TOBS.drain(tms["t"]), JOBS.drain(jms["t"])
    assert [(r["seq"], r["round"], r["phase"]) for r in tr] == \
        [(r["seq"], r["round"], r["phase"]) for r in jr]
    np.testing.assert_allclose([r["payload"] for r in tr],
                               [r["payload"] for r in jr], rtol=RTOL,
                               atol=ATOL)
    _far_from_edges(tr, TOBS.GRAD_NORM_EDGES)
    return tr


# --------------------------------------------------------- disabled, free
class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kind", ["stacked", "stream_global", "hier"])
def test_disabled_obs_dispatches_the_same_ops(kind):
    jparams, tparams = _params()
    n = 14 if kind == "hier" else N
    (_, tb), = _batches(n, 1)
    logs, counts = [], []
    for obs in (None, TOBS.ObsConfig(enabled=False)):
        opt, step = _port_step(kind, obs, n=n)
        state = TTR.init_train_state(opt, tparams)
        ops.reset_launch_counts()
        with _OpLog() as log:
            _, new_state, _ = step(tparams, state, tb, 3)
        logs.append(log.ops)
        counts.append(ops.launch_counts())
        assert new_state.mstate is None
    assert len(logs[0]) > 100
    assert logs[0] == logs[1]
    assert counts[0] == counts[1]


@pytest.mark.parametrize("kind", ["stacked", "stream_block"])
def test_enabled_obs_keeps_the_bits_and_records_in_pipeline_order(kind):
    _, tparams = _params()
    batches = _batches(N, 2)
    out = []
    for obs in (None, TOBS.ObsConfig(**ON)):
        opt, step = _port_step(kind, obs)
        p, s = tparams, TTR.init_train_state(opt, tparams)
        for r, (_, tb) in enumerate(batches):
            p, s, m = step(p, s, tb, r)
        out.append((p, s))
    (p0, s0), (p1, s1) = out
    for a, b in zip(tree_leaves(p0), tree_leaves(p1)):
        assert torch.equal(a, b)
    assert s0.mstate is None
    assert float(s1.mstate["m"].counters["rounds"]) == 2.0
    assert [(r["round"], r["phase"]) for r in TOBS.drain(s1.mstate["t"])] \
        == [(0, "stats"), (0, "plan"), (0, "apply"),
            (1, "stats"), (1, "plan"), (1, "apply")]


# --------------------------------------------------- the trainers vs JAX
@pytest.mark.parametrize("kind", ["stacked", "stream_global",
                                  "stream_block", "hier"])
def test_trainer_registry_matches_jax(fp32_jax, kind):
    n = 14 if kind == "hier" else N
    jparams, tparams = _params()
    jopt, jstep = _jax_step(kind, JOBS.ObsConfig(**ON), n=n)
    topt, tstep = _port_step(kind, TOBS.ObsConfig(**ON), n=n)
    # seeded up front: one JAX trace, not a second once mstate is live
    jp, js = jparams, dataclasses.replace(
        JTR.init_train_state(jopt, jparams),
        mstate=JOBS.init_train_obs(JOBS.ObsConfig(**ON), n, telemetry=True))
    tp, ts = tparams, TTR.init_train_state(topt, tparams)
    for r, (jb, tb) in enumerate(_batches(n, 2)):
        jp, js, _ = jstep(jp, js, jb, jax.random.key(r))
        tp, ts, _ = tstep(tp, ts, tb, r)
    recs = _assert_mstate_close(ts.mstate, js.mstate)
    # under hier the two levels' triples, then the step's apply
    per_step = 7 if kind == "hier" else 3
    assert len(recs) == 2 * per_step
    if kind == "hier":
        # the inner level's triple (payload: 2 groups), then the outer's
        assert [r["payload"] for r in recs[:6]] == [2.0] * 3 + [1.0] * 3
        assert [r["phase"] for r in recs[:7]] == \
            ["stats", "plan", "apply"] * 2 + ["apply"]
    if kind == "stream_block":
        assert recs[1]["payload"] == 0.0   # a plan per block
    if kind == "stream_global":
        assert recs[1]["payload"] == 1.0   # one plan for every block


SCHEDULE = ([True] * N, [True] * 5 + [False] * 2, [True] * 5 + [False] * 2,
            [True] * 6 + [False])


def test_async_registry_matches_jax(fp32_jax):
    """Four rounds at tau = 1: all fresh, workers 5-6 late twice (the second
    time overstale, 2 > f: the plan reused), then worker 6 late."""
    jparams, tparams = _params()
    jopt, topt = JO.sgd(momentum=0.9), TO.sgd(momentum=0.9)
    jr, tr = JRobust(n_workers=N, f=F), RobustConfig(n_workers=N, f=F)
    jstep = jax.jit(JSV.make_async_train_step(
        JArch(**OBS_TINY), jr, jopt, JS.constant(0.05), tau=TAU,
        chunk_q=SEQ, attack="sign_flip", telemetry=True,
        obs=JOBS.ObsConfig(**ON)))
    tstep = TSV.make_async_train_step(
        ArchConfig(**OBS_TINY, dtype="float32"), tr, topt,
        TS.constant(0.05), tau=TAU, chunk_q=SEQ, attack="sign_flip",
        telemetry=True, obs=TOBS.ObsConfig(**ON))
    jsvc = JSV.AsyncAggService(backend=JAPI.AggregatorBackend.for_config(
        jr, needs_dists=True), tau=TAU)
    tsvc = TSV.AsyncAggService(backend=TAPI.AggregatorBackend.for_config(
        tr, needs_dists=True, obs=TOBS.ObsConfig(**ON)), tau=TAU)
    assert tsvc.obs == TOBS.ObsConfig(**ON)
    jp, js = jparams, JSV.with_buffer(JTR.init_train_state(jopt, jparams),
                                      jsvc, jparams, N)
    js = dataclasses.replace(js, mstate=JOBS.init_serve_obs(
        JOBS.ObsConfig(**ON), N, TAU, telemetry=True))
    tp, ts = tparams, TSV.with_buffer(TTR.init_train_state(topt, tparams),
                                      tsvc, tparams, N)
    for r, ((jb, tb), fresh) in enumerate(zip(_batches(N, 4), SCHEDULE)):
        fr = np.asarray(fresh)
        jp, js, _ = jstep(jp, js, jb, jax.random.key(r), jnp.asarray(fr))
        tp, ts, _ = tstep(tp, ts, tb, r, torch.from_numpy(fr))
    recs = _assert_mstate_close(ts.mstate, js.mstate)
    c = TOBS.metrics_to_json(ts.mstate["m"])
    assert c["counters"] == {"rounds": 4.0, "admitted": 23.0,
                             "overstale_slots": 3.0, "degraded": 1.0}
    assert sum(c["hists"]["staleness_age"]["counts"]) == 4 * N
    assert [r["phase"] for r in recs[:4]] == ["stats", "plan",
                                              "select_plan", "apply"]
    assert [r["payload"] for r in recs if r["phase"] == "select_plan"] == \
        [0.0, 0.0, 1.0, 0.0]


# ----------------------------------------------------------- campaigns
def _scenarios(**kw):
    phases = ((2, "none"), (2, "sign_flip"))
    out = []
    for mod, arch in ((JSC, JArch(**OBS_TINY)),
                      (TSC, ArchConfig(**OBS_TINY, dtype="float32"))):
        sched = mod.AttackSchedule(tuple(
            mod.AttackPhase(steps=s, attack=a) for s, a in phases))
        out.append(mod.Scenario(name="obs", schedule=sched, n_workers=N,
                                f=F, arch=arch, seq=SEQ, seed=3, **kw))
    return out


@pytest.mark.parametrize("kw", [{}, {"async_tau": 1, "stale_period": 2}],
                         ids=["stacked", "async"])
def test_campaign_obs_matches_jax(fp32_jax, monkeypatch, kw):
    js, ts = _scenarios(**kw)
    jgen = JEN._make_batch_gen(js, None)

    def batch_gen(scenario, mixture):
        def gen(steps):
            b = jgen(jnp.asarray(list(steps)))
            return {k: torch.from_numpy(np.array(v)).long()
                    for k, v in b.items()}
        return gen

    def init_params(scenario, device):
        p = JMD.init_model(jax.random.key(scenario.seed), js.arch)
        return TMD.params_from_jax(jax.tree.map(np.asarray, p),
                                   device=device)

    monkeypatch.setattr(TEN, "_make_batch_gen", batch_gen)
    monkeypatch.setattr(TEN, "_init_params", init_params)
    want = JEN.run_campaign(js, obs=JOBS.ObsConfig(**ON)).obs
    got = TEN.run_campaign(ts, device="cpu", obs=TOBS.ObsConfig(**ON)).obs
    assert TOBS.validate_snapshot(got) == []
    assert got["meta"] == want["meta"]
    assert got["metrics"]["counters"] == want["metrics"]["counters"]
    assert got["metrics"]["hists"] == want["metrics"]["hists"]
    for k, v in want["metrics"]["gauges"].items():
        np.testing.assert_allclose(got["metrics"]["gauges"][k], v,
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    tr, jr = got["trace"]["records"], want["trace"]["records"]
    assert [(r["seq"], r["round"], r["phase"]) for r in tr] == \
        [(r["seq"], r["round"], r["phase"]) for r in jr]
    np.testing.assert_allclose([r["payload"] for r in tr],
                               [r["payload"] for r in jr], rtol=RTOL,
                               atol=ATOL)
    _far_from_edges(tr, TOBS.GRAD_NORM_EDGES)
    assert got["metrics"]["counters"]["rounds"] == 4.0


def test_resumed_campaign_carries_the_registry(tmp_path):
    _, sc = _scenarios()
    obs = TOBS.ObsConfig(**ON)
    d = str(tmp_path / "ck")
    full = TEN.run_campaign(sc, ckpt_dir=d, device="cpu", obs=obs)
    with np.load(f"{d}/ckpt_00000002.npz") as data:
        assert "state|mstate|m|counters|rounds" in data.files
    (tmp_path / "ck" / "ckpt_00000004.npz").unlink()
    resumed = TEN.run_campaign(sc, ckpt_dir=d, resume=True, device="cpu",
                               obs=obs)
    assert resumed.start_step == 2
    assert resumed.obs["metrics"]["counters"] == \
        full.obs["metrics"]["counters"] == {"rounds": 4.0}
    assert resumed.obs["metrics"]["hists"] == full.obs["metrics"]["hists"]
    assert resumed.obs["trace"] == full.obs["trace"]
    without = TEN.run_campaign(sc, device="cpu")
    assert without.obs is None
