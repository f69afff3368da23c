"""Port parity for the bounded-staleness service (``repro_torch.serve``):
the staleness budget, ``select_plan``, the buffer and the service, the
async trainer step, microbatched robust serving and the per-lane decode
positions it runs on, against the JAX package on the CPU.

Inputs come from numpy seeds and go through both packages.  Tolerances:
ages, overstale counts, ``f_defended``, ``admissible``, ``plan_reused``
and the plans' tensors exactly equal; aggregates within fp32 rtol 1e-6
(and 1e-6 of the largest |want|, near 0) on normal stacks (the first f
rows x 5) where no coordinate's pick is near a tie.  The async step:
parameters within rtol 1e-4 (atol 1e-6) on the step tests' config, as
``tests/test_torch_trainer.py`` holds them, the telemetry's integer
fields and the selection exact.  Microbatching: replica logits within 1e-4
relative of JAX's per-lane decodes from caches widened to fp32 (with bf16
caches a written slot's rounding can flip on one fp32 ulp), the fused
logits within 1e-5 relative of JAX's aggregation of the port's own replica
logits (as ``tests/test_torch_serving.py`` holds the robust step: the
coordinate phase is discontinuous) and within JAX's test bound (5e-2) of
JAX's step, the caches within 1e-5.  Per-lane positions: at one position
for every lane, bit for bit the scalar decode; at differing positions
within 1e-5 (relative to the largest logit) of one-lane decodes from
fp32-widened caches.
"""
import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import models as JMD
from repro.configs import get_config as jget
from repro.configs.base import ArchConfig as JArch
from repro.configs.base import RobustConfig as JRobust
from repro.core import api as JAPI
from repro.core import theory as JTH
from repro.data.synthetic import make_lm_batch
from repro.dist import serving as JDS
from repro.dist import trainer as JTR
from repro.models import modules as JM
from repro.optim import optimizers as JO
from repro.optim import schedules as JS
from repro.serve import batching as JSB
from repro.serve import buffer as JBUF
from repro.serve import service as JSV
from repro_torch import models as TMD
from repro_torch.configs import ArchConfig, RobustConfig, get_config
from repro_torch.core import api as TAPI
from repro_torch.core import theory as TTH
from repro_torch.dist import serving as TDS
from repro_torch.dist import trainer as TTR
from repro_torch.optim import optimizers as TO
from repro_torch.optim import schedules as TS
from repro_torch.serve import batching as TSB
from repro_torch.serve import buffer as TBUF
from repro_torch.serve import service as TSV
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)

N, F, TAU, D = 11, 2, 1, 64
GARS = ("multi_bulyan", "multi_krum", "median", "average")


@pytest.fixture
def fp32_jax(monkeypatch):
    """The JAX package casts activations to bf16 at the embedding; the fp32
    parity runs cast to fp32 there instead."""
    monkeypatch.setattr(JM, "embedding_apply", functools.partial(
        JM.embedding_apply, dtype=jnp.float32))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, rel):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * float(np.max(np.abs(want))))


def _same_plan(tp, jp):
    assert (tp.kind, tp.n, tp.f, tp.beta) == (jp.kind, jp.n, jp.f, jp.beta)
    for key in ("weights", "w_ext", "w_agr"):
        a, b = getattr(tp, key), getattr(jp, key)
        assert (a is None) == (b is None), key
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _same_error(fn_t, fn_j):
    with pytest.raises(Exception) as et:
        fn_t()
    with pytest.raises(Exception) as ej:
        fn_j()
    assert type(et.value) is type(ej.value)
    assert str(et.value) == str(ej.value)


# ------------------------------------------------------------------ theory
BUDGET_GRID = [(n, f, tau, rule) for n in (3, 7, 11, 12) for f in (0, 1, 2, 3)
               for tau in (-1, 0, 2)
               for rule in ("multi_bulyan", "multi_krum", "trimmed_mean",
                            "average")]


@pytest.mark.parametrize("n,f,tau,rule", BUDGET_GRID)
def test_staleness_budget_matches_jax(n, f, tau, rule):
    try:
        want = JTH.staleness_budget(n, f, tau, rule=rule)
    except ValueError:
        _same_error(lambda: TTH.staleness_budget(n, f, tau, rule=rule),
                    lambda: JTH.staleness_budget(n, f, tau, rule=rule))
        return
    got = TTH.staleness_budget(n, f, tau, rule=rule)
    assert (got.n, got.f, got.tau) == (want.n, want.f, want.tau)
    for k in range(n + 2):
        assert got.f_defended(k) == want.f_defended(k)
        assert got.admissible(k) == want.admissible(k)
        for b in range(f + 2):
            assert got.covers(b, k) == want.covers(b, k)


def _plans(gar, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, 9)).astype(np.float32)
    x[:F] *= 5.0
    jb = JAPI.AggregatorBackend(gar=gar, f=F, needs_dists=True)
    tb = TAPI.AggregatorBackend(gar=gar, f=F, needs_dists=True)
    return jb.plan_stats(jnp.asarray(x))[0], \
        tb.plan_stats(torch.from_numpy(x))[0]


@pytest.mark.parametrize("pred", [True, False])
@pytest.mark.parametrize("gar", GARS + ("krum", "bulyan"))
def test_select_plan_matches_jax(gar, pred):
    j1, t1 = _plans(gar, 1)
    j2, t2 = _plans(gar, 2)
    got = TAPI.select_plan(torch.tensor(pred), t1, t2)
    want = JAPI.select_plan(jnp.asarray(pred), j1, j2)
    _same_plan(got, want)
    _same_plan(got, t1 if pred else t2)


def test_select_plan_refuses_plans_of_two_kinds():
    _, t1 = _plans("multi_bulyan", 1)
    _, t2 = _plans("multi_krum", 1)
    with pytest.raises(ValueError, match="two plans of one kind"):
        TAPI.select_plan(torch.tensor(True), t1, t2)


# ---------------------------------------------------- buffer and service
def _grads(r, d=D):
    g = np.random.default_rng(1000 + r).normal(size=(N, d)).astype(
        np.float32)
    g[:F] *= 5.0                 # byzantine convention: rows [0, f)
    return {"w": g}


def _services(gar="multi_bulyan", tau=TAU, f=F, needs_dists=False):
    return (TSV.AsyncAggService(backend=TAPI.AggregatorBackend(
                gar=gar, f=f, needs_dists=needs_dists), tau=tau),
            JSV.AsyncAggService(backend=JAPI.AggregatorBackend(
                gar=gar, f=f, needs_dists=needs_dists), tau=tau))


def _run_both(schedule, gar="multi_bulyan", d=D):
    """Replay a delivery schedule through both packages' rounds."""
    tsvc, jsvc = _services(gar)
    jrnd = jax.jit(lambda s, g, fr: jsvc.round(s, g, fr))
    g0 = _grads(0, d)
    tstate = tsvc.init_state({k: torch.from_numpy(v) for k, v in g0.items()})
    jstate = jsvc.init_state({k: jnp.asarray(v) for k, v in g0.items()})
    _same_plan(tstate.plan, jstate.plan)
    out = []
    for r, fresh in enumerate(schedule):
        g = _grads(r, d)
        fresh = np.asarray(fresh, bool)
        tagg, tstate, tinfo = tsvc.round(
            tstate, {k: torch.from_numpy(v) for k, v in g.items()},
            torch.from_numpy(fresh))
        jagg, jstate, jinfo = jrnd(
            jstate, {k: jnp.asarray(v) for k, v in g.items()},
            jnp.asarray(fresh))
        out.append(((tagg, tstate, tinfo), (jagg, jstate, jinfo)))
    return out


def _held(pair):
    """One round of both packages: the integer staleness fields, the
    plan's tensors and the buffer exactly, the aggregate within 1e-6."""
    (tagg, tst, ti), (jagg, jst, ji) = pair
    np.testing.assert_array_equal(tst.age.numpy(), np.asarray(jst.age))
    assert tst.age.dtype == torch.int32
    for key in ("n_overstale", "f_defended", "admissible", "plan_reused",
                "overstale", "admitted", "age"):
        np.testing.assert_array_equal(ti[key].numpy(), np.asarray(ji[key]),
                                      err_msg=key)
    _same_plan(tst.plan, jst.plan)
    np.testing.assert_array_equal(tst.grads["w"].numpy(),
                                  np.asarray(jst.grads["w"]))
    _close(tagg["w"], jagg["w"], 1e-6)


@pytest.mark.parametrize("gar", GARS)
def test_staleness_admission_determinism(gar):
    """Same schedule ⇒ bit-identical aggregates and plans in the port, and
    both held to JAX's round by round."""
    rng = np.random.default_rng(7)
    schedule = [rng.random(N) < 0.7 for _ in range(6)]
    a = _run_both(schedule, gar)
    b = _run_both(schedule, gar)
    for pa, pb in zip(a, b):
        _held(pa)
        (agg_a, st_a, _), (agg_b, st_b, _) = pa[0], pb[0]
        assert torch.equal(agg_a["w"], agg_b["w"])
        for key in ("weights", "w_ext", "w_agr"):
            x, y = getattr(st_a.plan, key), getattr(st_b.plan, key)
            assert (x is None and y is None) or torch.equal(x, y)


@pytest.mark.parametrize("gar", GARS)
def test_all_stale_round_degrades_to_previous_plan(gar):
    """Past tau the round is inadmissible and the previous plan is reused:
    degradation takes tau + 1 consecutive all-stale rounds."""
    fresh, stale = [True] * N, [False] * N
    out = _run_both([fresh, stale, stale], gar)
    for pair in out:
        _held(pair)
    (_, _, i1), (agg2, st2, i2), (agg3, st3, i3) = [p[0] for p in out]
    assert not bool(i1["plan_reused"])
    assert not bool(i2["plan_reused"])          # age 1 <= tau: admissible
    assert bool(i3["plan_reused"])              # age 2 > tau for all n > f
    assert int(i3["n_overstale"]) == N
    assert int(i3["f_defended"]) == 0
    for key in ("weights", "w_ext", "w_agr"):
        x, y = getattr(st3.plan, key), getattr(st2.plan, key)
        assert (x is None and y is None) or torch.equal(x, y)
    assert torch.equal(agg3["w"], agg2["w"])


def test_late_worker_enters_next_plan():
    """A straggler's slot keeps its old gradient until it delivers; its
    next delivery refreshes the slot.  Admission is out of place: the
    states of earlier rounds keep their tensors."""
    miss = np.ones(N, bool)
    miss[-1] = False
    out = _run_both([np.ones(N, bool), miss, np.ones(N, bool)])
    for pair in out:
        _held(pair)
    (_, st1, _), (_, st2, i2), (_, st3, i3) = [p[0] for p in out]
    assert torch.equal(st2.grads["w"][-1], st1.grads["w"][-1])
    assert int(st2.age[-1]) == 1 and int(i2["n_overstale"]) == 0
    np.testing.assert_array_equal(st3.grads["w"][-1].numpy(),
                                  _grads(2)["w"][-1])
    assert int(st3.age[-1]) == 0 and int(i3["n_overstale"]) == 0
    # round 0's state still holds round 0's rows and ages
    np.testing.assert_array_equal(st1.grads["w"].numpy(), _grads(0)["w"])
    assert st1.age.tolist() == [0] * N


@pytest.mark.parametrize("k", range(N + 1))
def test_effective_f_haircut_never_exceeds_contract(k):
    """The tensor staleness arithmetic equals theory.StalenessBudget and
    JAX's for every overstale count k."""
    budget = TTH.staleness_budget(N, F, TAU)
    age = np.zeros(N, np.int32)
    age[N - k:] = TAU + 1
    got = TBUF.staleness_info(torch.from_numpy(age), tau=TAU, f=F)
    want = JBUF.staleness_info(jnp.asarray(age), tau=TAU, f=F)
    for key in got:
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    assert int(got["n_overstale"]) == k
    assert int(got["f_defended"]) == budget.f_defended(k)
    assert bool(got["admissible"]) == budget.admissible(k)
    assert 0 <= int(got["f_defended"]) <= F
    assert got["n_overstale"].dtype == got["f_defended"].dtype == torch.int32


def test_service_budget_gates_infeasible_pairs():
    tsvc, jsvc = _services()
    assert tsvc.budget(N) == TTH.StalenessBudget(n=N, f=F, tau=TAU)
    assert (jsvc.budget(N).n, jsvc.budget(N).f) == (N, F)
    _same_error(lambda: tsvc.budget(F * 4 + 2),
                lambda: jsvc.budget(F * 4 + 2))
    _same_error(
        lambda: TSV.AsyncAggService(backend=tsvc.backend, tau=-1),
        lambda: JSV.AsyncAggService(backend=jsvc.backend, tau=-1))


@pytest.mark.parametrize("gar", GARS)
def test_all_fresh_round_matches_registry_aggregate(gar):
    """The async service on an all-fresh round is the synchronous
    aggregator, bit for bit in the port, within 1e-6 of JAX's."""
    out = _run_both([np.ones(N, bool)], gar)
    _held(out[0])
    (agg, _, info), _ = out[0]
    g = _grads(0)
    want = TAPI.aggregate_tree({"w": torch.from_numpy(g["w"])}, F, gar,
                               use_kernels=True)
    assert torch.equal(agg["w"], want["w"])
    _close(agg["w"], JAPI.aggregate_tree({"w": jnp.asarray(g["w"])}, F,
                                         gar)["w"], 1e-6)
    assert int(info["f_defended"]) == F and not bool(info["plan_reused"])


def test_service_plan_and_apply_are_the_round():
    """``plan`` then ``apply`` on an admitted buffer give the round's plan
    and aggregate bit for bit."""
    tsvc, _ = _services()
    g = {"w": torch.from_numpy(_grads(0)["w"])}
    state = tsvc.init_state(g)
    agg, new, _ = tsvc.round(state, g, torch.ones(N, dtype=torch.bool))
    admitted = TBUF.admit(state, g, torch.ones(N, dtype=torch.bool))
    plan, info = tsvc.plan(admitted)
    assert torch.equal(plan.w_ext, new.plan.w_ext)
    assert torch.equal(plan.w_agr, new.plan.w_agr)
    assert torch.equal(tsvc.apply(plan, admitted)["w"], agg["w"])
    assert "stats" in info


# ------------------------------------------------------- async trainer
SEQ = 16
SCHEDULE = ([True] * N, [True] * 8 + [False] * 3, [True] * 8 + [False] * 3,
            [True] * 10 + [False])


#: the step tests' qwen2-flavoured config (``tests/test_torch_trainer.py``)
TINY = dict(name="tiny-qwen", family="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
            qkv_bias=True, tie_embeddings=True, rope_theta=1e6)


def _async_cfgs(tiny):
    if tiny:
        return JArch(**TINY), ArchConfig(**TINY, dtype="float32")
    return jget("qwen2-1.5b").reduced(), dataclasses.replace(
        get_config("qwen2-1.5b").reduced(), dtype="float32")


def _async_setup(attack, tiny=True):
    jcfg, tcfg = _async_cfgs(tiny)
    jparams = JMD.init_model(jax.random.key(0), jcfg)
    tparams = TMD.params_from_jax(jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    opt_j, opt_t = JO.sgd(momentum=0.9), TO.sgd(momentum=0.9)
    jr = JRobust(n_workers=N, f=F)
    tr = RobustConfig(n_workers=N, f=F)
    jstep = jax.jit(JSV.make_async_train_step(
        jcfg, jr, opt_j, JS.constant(0.05), tau=TAU, chunk_q=SEQ,
        attack=attack, telemetry=True))
    tstep = TSV.make_async_train_step(
        tcfg, tr, opt_t, TS.constant(0.05), tau=TAU, chunk_q=SEQ,
        attack=attack, telemetry=True)
    jsvc = JSV.AsyncAggService(backend=JAPI.AggregatorBackend.for_config(
        jr, needs_dists=True), tau=TAU)
    tsvc = TSV.AsyncAggService(backend=TAPI.AggregatorBackend.for_config(
        tr, needs_dists=True), tau=TAU)
    jstate = JSV.with_buffer(JTR.init_train_state(opt_j, jparams), jsvc,
                             jparams, N)
    tstate = TSV.with_buffer(TTR.init_train_state(opt_t, tparams), tsvc,
                             tparams, N)
    return jcfg, (jparams, jstate, jstep), (tparams, tstate, tstep)


def _async_rounds(attack, tiny):
    """SCHEDULE through both packages' async steps: yields, per round,
    (the port's (params, state, metrics), JAX's)."""
    jcfg, (jp, js, jstep), (tp, ts, tstep) = _async_setup(attack, tiny)
    for r, fresh in enumerate(SCHEDULE):
        batch = make_lm_batch(jax.random.key(r + 1), jcfg.vocab_size, N, SEQ)
        batch = {k: np.array(v) for k, v in batch.items()}
        jb = JTR.split_workers({k: jnp.asarray(v) for k, v in batch.items()},
                               N)
        tb = TTR.split_workers({k: torch.from_numpy(v).long()
                                for k, v in batch.items()}, N)
        fr = np.asarray(fresh)
        jp, js, jm = jstep(jp, js, jb, jax.random.key(r), jnp.asarray(fr))
        tp, ts, tm = tstep(tp, ts, tb, r, torch.from_numpy(fr))
        yield (tp, ts, tm), (jp, js, jm)


def _same_round_records(tm, ts, jm, js):
    """Per-worker losses within 1e-4; the staleness telemetry, the
    selection, the ages and the plan exact."""
    np.testing.assert_allclose(tm["loss_per_worker"].numpy(),
                               np.asarray(jm["loss_per_worker"]), rtol=1e-4)
    jt, tt = jm["telemetry"], tm["telemetry"]
    for key in ("admitted", "overstale", "staleness_age", "n_overstale",
                "f_defended", "plan_reused", "selection"):
        np.testing.assert_array_equal(tt[key].numpy(), np.asarray(jt[key]),
                                      err_msg=key)
    np.testing.assert_allclose(float(tt["byz_mass"]), float(jt["byz_mass"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(ts.bstate.age.numpy(),
                                  np.asarray(js.bstate.age))
    _same_plan(ts.bstate.plan, js.bstate.plan)


@pytest.mark.parametrize("attack", ["inf", "sign_flip"])
def test_async_step_matches_jax_fp32(fp32_jax, attack):
    """Four rounds on the step tests' config: all fresh, workers 8-10 late
    twice (the second time overstale, 3 > f: round 1's plan reused), then
    worker 10 late.  Losses, ``honest_dev`` and parameters within 1e-4,
    the telemetry's integer fields and the selection exact."""
    for (tp, ts, tm), (jp, js, jm) in _async_rounds(attack, tiny=True):
        _same_round_records(tm, ts, jm, js)
        np.testing.assert_allclose(float(tm["telemetry"]["honest_dev"]),
                                   float(jm["telemetry"]["honest_dev"]),
                                   rtol=1e-4)
        for t, j in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                                       atol=1e-6)
    assert int(tm["telemetry"]["n_overstale"]) == 1
    assert ts.opt.step == len(SCHEDULE)


def _jnp_tree(tree):
    return jax.tree.map(jnp.asarray, tree_map(lambda t: t.numpy(), tree))


def _jax_plan(plan):
    arr = (lambda t: None if t is None else jnp.asarray(t.numpy()))
    return JAPI.AggPlan(kind=plan.kind, n=plan.n, f=plan.f,
                        weights=arr(plan.weights), w_ext=arr(plan.w_ext),
                        w_agr=arr(plan.w_agr), beta=plan.beta)


def _jax_state(ts):
    """The port's trainer state (SGD momentum and the buffer) as JAX's."""
    return JTR.TrainerState(
        opt=JO.OptState(step=jnp.asarray(ts.opt.step, jnp.int32),
                        mu=_jnp_tree(ts.opt.mu), nu=None),
        bstate=JBUF.BufferState(grads=_jnp_tree(ts.bstate.grads),
                                age=jnp.asarray(ts.bstate.age.numpy()),
                                plan=_jax_plan(ts.bstate.plan)))


@pytest.mark.parametrize("attack", ["inf", "sign_flip"])
def test_async_step_on_reduced_qwen2_matches_jax_fp32(fp32_jax, attack):
    """The same four rounds on the reduced qwen2, JAX's step started each
    round from the port's parameters and state.  Its coordinate phase
    (β = 1: the aggregate-row value nearest the extracted median) is
    discontinuous, and per-worker gradients 6e-7 apart pick another value
    at one coordinate of round 0 (5.7e-3 apart in the aggregate; the
    synchronous step does the same), so the updated parameters are not
    compared.  Per round: the records and the plan exact, the admitted
    rows within 1e-4 of JAX's, and the port's aggregate of its own buffer
    within 1e-5 of JAX's aggregation of that buffer under the same plan
    (as tests/test_torch_serving.py holds the robust step)."""
    jcfg, (jp, _, jstep), (tp, ts, tstep) = _async_setup(attack, tiny=False)
    jb = JAPI.AggregatorBackend(gar="multi_bulyan", f=F)
    tb = TAPI.AggregatorBackend(gar="multi_bulyan", f=F)
    for r, fresh in enumerate(SCHEDULE):
        batch = make_lm_batch(jax.random.key(r + 1), jcfg.vocab_size, N, SEQ)
        batch = {k: np.array(v) for k, v in batch.items()}
        fr = np.asarray(fresh)
        _, js, jm = jstep(_jnp_tree(tp), _jax_state(ts), JTR.split_workers(
            {k: jnp.asarray(v) for k, v in batch.items()}, N),
            jax.random.key(r), jnp.asarray(fr))
        tp, ts, tm = tstep(tp, ts, TTR.split_workers(
            {k: torch.from_numpy(v).long() for k, v in batch.items()}, N),
            r, torch.from_numpy(fr))
        _same_round_records(tm, ts, jm, js)
        for t, j in zip(tree_leaves(ts.bstate.grads),
                        jax.tree.leaves(js.bstate.grads)):
            _close(t[F:], np.asarray(j)[F:], 1e-4)
        got = tb.apply(ts.bstate.plan, ts.bstate.grads)
        want = jb.apply(_jax_plan(ts.bstate.plan),
                        _jnp_tree(ts.bstate.grads))
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            _close(g, w, 1e-5)


def test_async_step_reuses_the_plan_on_the_degraded_round():
    """Round 2 of SCHEDULE is degraded: its plan is round 1's bit for bit,
    ``f_defended`` [2, 2, 0, 1], ``plan_reused`` only there."""
    _, _, (tp, ts, tstep) = _async_setup("inf")
    cfg = _async_cfgs(True)[1]
    plans, fdef, reused = [], [], []
    for r, fresh in enumerate(SCHEDULE):
        rng = np.random.default_rng(r)
        tok = rng.integers(0, cfg.vocab_size, (N, 1, SEQ))
        tb = {"tokens": torch.from_numpy(tok).long(),
              "labels": torch.from_numpy(np.roll(tok, -1, -1)).long()}
        tp, ts, tm = tstep(tp, ts, tb, r, torch.tensor(fresh))
        plans.append(ts.bstate.plan)
        fdef.append(int(tm["telemetry"]["f_defended"]))
        reused.append(bool(tm["telemetry"]["plan_reused"]))
        assert float(tm["telemetry"]["byz_mass"]) == 0.0
    assert fdef == [2, 2, 0, 1] and reused == [False, False, True, False]
    assert torch.equal(plans[2].w_ext, plans[1].w_ext)
    assert torch.equal(plans[2].w_agr, plans[1].w_agr)


def test_async_step_refusals_match_jax():
    jcfg = jget("qwen2-1.5b").reduced()
    tcfg = get_config("qwen2-1.5b").reduced()
    jr, tr = JRobust(n_workers=N, f=F), RobustConfig(n_workers=N, f=F)
    for kw in ({"attack_f": 3}, {"attack_f": -1}, {"tau": -1}):
        args = {"tau": TAU, **kw}
        _same_error(
            lambda: TSV.make_async_train_step(tcfg, tr, TO.sgd(),
                                              TS.constant(0.05), **args),
            lambda: JSV.make_async_train_step(jcfg, jr, JO.sgd(),
                                              JS.constant(0.05), **args))
    tparams = TMD.init_model(tcfg, seed=0, device="cpu")
    opt = TO.sgd()
    tstep = TSV.make_async_train_step(tcfg, tr, opt, TS.constant(0.05),
                                      tau=TAU)
    with pytest.raises(ValueError, match="needs TrainerState.bstate"):
        tstep(tparams, TTR.init_train_state(opt, tparams), None, 0,
              torch.ones(N, dtype=torch.bool))


# ------------------------------------------------------------ microbatch
MB_N, MB_F = 7, 1
KEY = jax.random.key(0)


def _replicas(jcfg):
    params = [JMD.init_model(jax.random.fold_in(KEY, i), jcfg)
              for i in range(MB_N)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *params)
    return params, stacked, TMD.params_from_jax(
        jax.tree.map(np.asarray, stacked), device="cpu")


def _jcache_np(cache):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), cache)


@pytest.mark.parametrize("tokens,lane_seq", [((3, 5), (8, 12, 8)),
                                             ((7, 2, 9), (5, 11, 14))])
def test_microbatch_fuses_per_lane_positions(fp32_jax, tokens, lane_seq):
    """One plan/apply over the (n, B, V) stack at per-lane positions, held
    to JAX's microbatch step; padded lanes contribute zeros."""
    jcfg = jget("qwen2-1.5b").reduced()
    tcfg = dataclasses.replace(get_config("qwen2-1.5b").reduced(),
                               dtype="float32")
    jr = JRobust(n_workers=MB_N, f=MB_F, use_pallas=True)
    tr = RobustConfig(n_workers=MB_N, f=MB_F, use_kernels=True)
    jbackend = JAPI.AggregatorBackend.for_config(jr)
    B, cache_len = len(lane_seq), 16
    params, jstack, tstack = _replicas(jcfg)
    prefill = jax.jit(lambda p, batch: JMD.prefill_fn(
        p, jcfg, batch, chunk_q=batch["tokens"].shape[1],
        cache_len=cache_len)[1])
    decode = jax.jit(lambda p, tok, c, pos: JMD.decode_fn(
        p, jcfg, tok, c, pos)[0])
    per_replica = []
    for i in range(MB_N):
        row = []
        for b, seq in enumerate(lane_seq):
            batch = JMD.make_batch(jcfg, "prefill", 1, seq,
                                   key=jax.random.fold_in(KEY, 100 + b))
            row.append(prefill(params[i], batch))
        per_replica.append(jax.tree.map(
            lambda *xs: jnp.concatenate(xs, axis=1), *row))
    # the caches widened to fp32 on both sides (the decode writes in the
    # cache's type): with bf16 caches one fp32 ulp between the packages'
    # K/V can flip a written slot's rounding and move the logits by 1e-3
    jcaches = jax.tree.map(lambda *xs: jnp.stack(xs).astype(jnp.float32),
                           *per_replica)
    tcaches = tree_map(lambda t: t.float(), TMD.cache_from_jax(
        _jcache_np(jcaches), device="cpu"))
    jrb = JSB.pack_requests(list(tokens), list(lane_seq[:len(tokens)]),
                            size=B)
    trb = TSB.pack_requests(list(tokens), list(lane_seq[:len(tokens)]),
                            size=B, device="cpu")
    assert trb.tokens.tolist() == np.asarray(jrb.tokens).tolist()
    assert trb.pos.tolist() == np.asarray(jrb.pos).tolist()
    assert trb.active.tolist() == np.asarray(jrb.active).tolist()
    jfused, jnew = JSB.make_microbatch_serve_step(jcfg, jr)(
        jstack, jcaches, jrb)
    tfused, tnew = TSB.make_microbatch_serve_step(tcfg, tr)(
        tstack, tcaches, trb)
    assert tuple(tfused.shape) == (B, tcfg.vocab_size)

    # the replicas' logits: the port's at per-lane positions against JAX's
    # one-lane decodes
    trep = torch.stack([TMD.decode_fn(
        tree_map(lambda t: t[i], tstack), tcfg, trb.tokens,
        tree_map(lambda t: t[i], tcaches), trb.pos)[0]
        for i in range(MB_N)])
    live = len(tokens)
    for i in range(MB_N):
        for b in range(B):
            lane = jax.tree.map(lambda x: x[i, :, b:b + 1], jcaches)
            want = decode(params[i], jrb.tokens[b:b + 1], lane, jrb.pos[b])
            _close(trep[i, b], want[0], 1e-4)
    trep = trep * trb.active[None, :, None].float()
    tplan = TAPI.AggregatorBackend.for_config(tr).plan_stats(trep)[0]
    _same_plan(tplan, jbackend.plan_stats(jnp.asarray(trep.numpy()))[0])
    assert torch.equal(tfused, TAPI.AggregatorBackend.for_config(tr)(trep))
    _close(tfused, jbackend(jnp.asarray(trep.numpy())), 1e-5)
    # JAX's step fuses its own replica logits: its test's bound
    np.testing.assert_allclose(_np(tfused), _np(jfused), rtol=0, atol=5e-2)
    assert trb.active.tolist() == [True] * live + [False] * (B - live)
    assert not bool(torch.any(trep[:, live:]))
    for t, j in zip(tree_leaves(tnew), jax.tree.leaves(jnew)):
        _close(t, j, 1e-5)


def test_microbatch_agrees_with_robust_serve_step_at_uniform_pos(fp32_jax):
    """At one position for every lane the microbatch step is the batched
    robust serve step bit for bit (bf16 caches), and within JAX's test
    bound (5e-2) of JAX's."""
    jcfg = jget("qwen2-1.5b").reduced()
    tcfg = dataclasses.replace(get_config("qwen2-1.5b").reduced(),
                               dtype="float32")
    jr = JRobust(n_workers=MB_N, f=MB_F)
    tr = RobustConfig(n_workers=MB_N, f=MB_F)
    B, seq = 2, 8
    params, jstack, tstack = _replicas(jcfg)
    batch = JMD.make_batch(jcfg, "prefill", B, seq, key=KEY)
    caches = [JMD.prefill_fn(p, jcfg, batch, chunk_q=seq, cache_len=16)[1]
              for p in params]
    jcaches = jax.tree.map(lambda *xs: jnp.stack(xs), *caches)
    tcaches = TMD.cache_from_jax(_jcache_np(jcaches), device="cpu")
    toks = [3, 5]
    want, _ = JDS.make_robust_serve_step(jcfg, jr)(
        jstack, jcaches, jnp.asarray(toks, jnp.int32), jnp.int32(seq))
    robust, rcache = TDS.make_robust_serve_step(tcfg, tr)(
        tstack, tcaches, torch.tensor(toks, dtype=torch.int32), seq)
    rb = TSB.pack_requests(toks, [seq] * B, size=B, device="cpu")
    got, gcache = TSB.make_microbatch_serve_step(tcfg, tr)(tstack, tcaches,
                                                          rb)
    assert torch.equal(got, robust)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(gcache),
                                                 tree_leaves(rcache)))
    # JAX's step fuses its own replica logits: its test's bound
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=5e-2)


@pytest.mark.parametrize("args", [([1, 2, 3], [0, 1, 2], 2),
                                  ([1, 2], [0], 4), ([], [1], 2)])
def test_pack_requests_refusals_match_jax(args):
    _same_error(lambda: TSB.pack_requests(*args, device="cpu"),
                lambda: JSB.pack_requests(*args))


def test_pack_requests_validation():
    rb = TSB.pack_requests([1, 2], [0, 3], size=4, device="cpu")
    assert rb.size == 4
    assert rb.active.tolist() == [True, True, False, False]
    assert rb.tokens.dtype == rb.pos.dtype == torch.int32
    want = JSB.pack_requests([1, 2], [0, 3], size=4)
    for key in ("tokens", "pos", "active"):
        np.testing.assert_array_equal(getattr(rb, key).numpy(),
                                      np.asarray(getattr(want, key)))


# ------------------------------------------------- per-lane decode positions
#: (architecture, window, seq_chunks): dense, its ring buffer, the chunked
#: partial softmax, whisper (rope='none': the sinusoid a lane), the SSM
#: (reads no position) and the MoE
LANE_CASES = [("qwen2-1.5b", 0, 1), ("qwen2-1.5b", 8, 1),
              ("qwen2-1.5b", 0, 2), ("qwen2-1.5b", 8, 2),
              ("whisper-tiny", 0, 1), ("whisper-tiny", 8, 1),
              ("falcon-mamba-7b", 0, 1), ("qwen3-moe-30b-a3b", 0, 1),
              ("qwen3-moe-30b-a3b", 8, 2)]
CACHE_LEN = 24


def _lane_prefill(cfg, params, lens, window, seed):
    """Each lane prefilled alone (B = 1) at its own prompt length; the
    lanes' caches concatenated on the batch axis (dim 1 of every leaf),
    and each lane's own cache."""
    lanes = []
    for b, s in enumerate(lens):
        rng = np.random.default_rng(seed + b)
        batch = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (1, s))).long()}
        if cfg.is_encdec:
            batch["frames"] = TMD.frames(cfg, 1, seed + b, "cpu")
        lanes.append(TMD.prefill_fn(params, cfg, batch, window=window,
                                    chunk_q=s, cache_len=CACHE_LEN)[1])
    return tree_map(lambda *xs: torch.cat(xs, dim=1), *lanes), lanes


@pytest.mark.parametrize("name,window,chunks", LANE_CASES)
def test_uniform_lane_positions_are_the_scalar_decode(name, window, chunks):
    """A (B,) position tensor of one value gives the scalar decode's
    logits and caches bit for bit (the model's own activation type)."""
    cfg = get_config(name).reduced()
    params = TMD.init_model(cfg, seed=3, device="cpu")
    cache, _ = _lane_prefill(cfg, params, (9, 9, 9), window, 40)
    tok = torch.tensor([1, 7, 4], dtype=torch.int32)
    for pos in (9, 10):
        want, wc = TMD.decode_fn(params, cfg, tok, cache, pos, window=window,
                                 seq_chunks=chunks)
        got, gc = TMD.decode_fn(params, cfg, tok, cache,
                                torch.full((3,), pos, dtype=torch.int32),
                                window=window, seq_chunks=chunks)
        assert torch.equal(got, want)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(gc),
                                                     tree_leaves(wc)))
        cache = wc


@pytest.mark.parametrize("name,window,chunks", LANE_CASES)
def test_differing_lane_positions_are_one_lane_decodes(name, window, chunks):
    """Lanes at positions 5, 11 and 14 (past the ring's wrap at window 8)
    decode in one call as each lane decodes alone at B = 1 from the same
    cache, two steps: logits and each lane's cache (written at its own
    slot) within 1e-5 of the largest.  fp32 activations, and the caches
    widened to fp32 (the decode writes in the cache's type): a (3, d) and
    a (1, d) product sum in other orders on the CPU, one fp32 ulp apart,
    which can flip a bf16 cache slot's rounding and move the next layer's
    logits by 1.7e-4."""
    cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32")
    params = TMD.init_model(cfg, seed=4, device="cpu")
    lens = (5, 11, 14)
    cache, _ = _lane_prefill(cfg, params, lens, window, 50)
    cache = tree_map(lambda t: t.float(), cache)
    tok = torch.tensor([2, 9, 6], dtype=torch.int32)
    pos = torch.tensor(lens, dtype=torch.int32)
    for step in range(2):
        got, new = TMD.decode_fn(params, cfg, tok, cache, pos + step,
                                 window=window, seq_chunks=chunks)
        for b, s in enumerate(lens):
            lane = tree_map(lambda t: t[:, b:b + 1], cache)
            want, wc = TMD.decode_fn(params, cfg, tok[b:b + 1], lane,
                                     s + step, window=window,
                                     seq_chunks=chunks)
            _close(got[b], want[0], 1e-5)
            for a, w in zip(tree_leaves(new), tree_leaves(wc)):
                _close(a[:, b:b + 1], w, 1e-5)
        cache = new


def test_lane_positions_must_match_the_batch():
    cfg = get_config("qwen2-1.5b").reduced()
    params = TMD.init_model(cfg, seed=3, device="cpu")
    cache, _ = _lane_prefill(cfg, params, (4, 4, 4), 0, 40)
    with pytest.raises(ValueError, match="2 lane positions for a batch of 3"):
        TMD.decode_fn(params, cfg, torch.tensor([1, 2, 3]), cache,
                      torch.tensor([4, 5]))
