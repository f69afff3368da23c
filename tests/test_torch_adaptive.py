"""Port parity for the adaptive (plan-feedback) attacks: ``propose`` and
``update`` of both attacks, their spec errors, the ``astate`` slot of
``init_train_state`` and three trainer steps of each attack, all held to
the JAX package on the same numpy inputs.

Tolerances: proposals and states within 1e-6 (rtol and atol; the two
frameworks reduce means and deviations in other orders); the decisions of
the adaptive little-is-enough (z up or down) and the mimic's target (the
trust argmax) exactly; the trainer's losses within the trainer tests'
rtol=1e-4 (``tests/test_torch_trainer.py``).
"""
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import models as JMD
from repro.configs.base import ArchConfig as JArch
from repro.configs.base import RobustConfig as JRobust
from repro.core import attacks as JA
from repro.data.synthetic import make_lm_batch
from repro.dist import trainer as JTR
from repro.models import modules as JM
from repro.optim import optimizers as JO
from repro.optim import schedules as JS
from repro_torch import models as TMD
from repro_torch.configs import ArchConfig, RobustConfig
from repro_torch.core import attacks as TA
from repro_torch.dist import trainer as TTR
from repro_torch.optim import optimizers as TO
from repro_torch.optim import schedules as TS

# the suite runs in several worker processes at once: one thread each
# keeps the port's many small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

KEY = jax.random.key(0)
TOL = dict(rtol=1e-6, atol=1e-6)
TINY = dict(name="tiny-qwen", family="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
            qkv_bias=True, tie_embeddings=True, rope_theta=1e6)
N, F, SEQ, STEPS = 11, 2, 16, 3


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _assert_state_close(tstate, jstate):
    assert sorted(tstate) == sorted(jstate)
    for k in jstate:
        assert tstate[k].dtype == torch.float32
        np.testing.assert_allclose(tstate[k].numpy(), np.asarray(jstate[k]),
                                   err_msg=k, **TOL)


# ------------------------------------------- propose / update (test_sim.py)
@pytest.mark.parametrize("spec", ["adaptive_lie:z0=2.0", "adaptive_lie"])
def test_adaptive_lie_matches_jax(spec):
    """The inputs of tests/test_sim.py: a rejected and a selected plan
    move z down and up; the proposal is mean - z * std (ddof 0)."""
    ja, ta = JA.get_adaptive(spec), TA.get_adaptive(spec)
    js, ts = ja.init_state(11, 2), ta.init_state(11, 2)
    _assert_state_close(ts, js)
    rejected = np.concatenate([np.zeros(2), np.full((9,), 1.0 / 9)])
    selected = np.full((11,), 1.0 / 11)
    for sel in (rejected, selected):
        want = ja.update(js, jnp.asarray(sel, jnp.float32))
        got = ta.update(ts, _t(sel))
        _assert_state_close(got, want)
    assert float(ta.update(ts, _t(rejected))["z"]) < ja.z0 \
        < float(ta.update(ts, _t(selected))["z"])
    G = np.random.default_rng(0).normal(size=(9, 8)).astype(np.float32)
    want = ja.propose(jnp.asarray(G), 2, KEY, js)
    got = ta.propose(_t(G), 2, None, ts)
    assert tuple(got.shape) == (2, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_adaptive_lie_clips_and_rounds_like_jax():
    """z stays in [z_min, z_max] after many decisions either way, and the
    byzantine row count round(share * n) rounds half to even in both."""
    ja, ta = JA.get_adaptive("adaptive_lie"), TA.get_adaptive("adaptive_lie")
    for n, f in ((8, 1), (4, 2), (12, 3), (10, 5)):
        js, ts = ja.init_state(n, f), ta.init_state(n, f)
        rng = np.random.default_rng(n)
        for _ in range(40):
            sel = rng.dirichlet(np.ones(n)).astype(np.float32)
            sel[: max(f // 2, 1)] *= rng.choice([0.0, 3.0])
            sel /= sel.sum()
            js = ja.update(js, jnp.asarray(sel))
            ts = ta.update(ts, _t(sel))
            _assert_state_close(ts, js)
        assert ta.z_min <= float(ts["z"]) <= ta.z_max


def test_adaptive_mimic_matches_jax():
    """The inputs of tests/test_sim.py: the mimic copies the honest row
    the EMA trusts most (index 1 here); at step 0 it copies row 0."""
    ja, ta = JA.get_adaptive("adaptive_mimic"), \
        TA.get_adaptive("adaptive_mimic")
    js, ts = ja.init_state(6, 2), ta.init_state(6, 2)
    _assert_state_close(ts, js)
    G = np.random.default_rng(0).normal(size=(4, 8)).astype(np.float32)
    np.testing.assert_array_equal(ta.propose(_t(G), 2, None, ts).numpy(),
                                  np.broadcast_to(G[0], (2, 8)))
    sel = np.asarray([0.0, 0.0, 0.1, 0.5, 0.2, 0.2], np.float32)
    js = ja.update(js, jnp.asarray(sel))
    ts = ta.update(ts, _t(sel))
    _assert_state_close(ts, js)
    want = ja.propose(jnp.asarray(G), 2, KEY, js)
    got = ta.propose(_t(G), 2, None, ts)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[1], G[1])


# ------------------------------------------------------ specs (test_attacks)
def test_get_adaptive_errors_match_jax():
    for spec, exc in (("adaptive_lie:warp=1.0", ValueError),
                      ("adaptive_lye", KeyError)):
        with pytest.raises(exc) as want:
            JA.get_adaptive(spec)
        with pytest.raises(exc) as got:
            TA.get_adaptive(spec)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="no parameter"):
        TA.get_adaptive("adaptive_lie:warp=1.0")


def test_adaptive_registry_and_specs_match_jax():
    assert sorted(TA.ADAPTIVE) == sorted(JA.ADAPTIVE)
    for spec in ("adaptive_lie", "adaptive_mimic:ema=0.5", "inf",
                 "little_is_enough:z=2"):
        assert TA.is_adaptive(spec) == JA.is_adaptive(spec)
    got = TA.get_adaptive("adaptive_lie:up=2.0,z0=0.5")
    want = JA.get_adaptive("adaptive_lie:up=2.0,z0=0.5")
    assert (got.up, got.z0, got.down) == (want.up, want.z0, want.down)
    with pytest.raises(KeyError, match="adaptive"):
        TA.get_attack("adaptive_lie")


# ------------------------------------------------ astate (test_trainer_state)
def test_adaptive_attack_fills_astate():
    params = {"w": torch.zeros(2, 3), "b": torch.ones(3).bfloat16()}
    opt = TO.sgd(momentum=0.9)
    st = TTR.init_train_state(opt, params, n_workers=11,
                              attack="adaptive_lie", attack_f=2)
    jst = JTR.init_train_state(
        JO.sgd(momentum=0.9), {"w": jnp.zeros((2, 3)),
                               "b": jnp.ones((3,), jnp.bfloat16)},
        n_workers=11, attack="adaptive_lie", attack_f=2)
    _assert_state_close(st.astate, jst.astate)
    assert TTR.init_train_state(opt, params).astate is None
    mimic = TTR.init_train_state(opt, params, n_workers=11,
                                 attack="adaptive_mimic", attack_f=2)
    assert tuple(mimic.astate["trust"].shape) == (9,)
    with pytest.raises(ValueError, match="n_workers > 0"):
        TTR.init_train_state(opt, params, attack="adaptive_lie", attack_f=2)


def test_adaptive_step_without_state_raises():
    step = TTR.make_train_step(ArchConfig(**TINY), RobustConfig(N, F),
                               TO.sgd(), TS.constant(0.1),
                               attack="adaptive_lie")
    params = TMD.init_model(ArchConfig(**TINY), seed=0, device="cpu")
    batch = TTR.split_workers(
        {"tokens": torch.zeros((N, SEQ), dtype=torch.long),
         "labels": torch.zeros((N, SEQ), dtype=torch.long)}, N)
    with pytest.raises(ValueError, match="init_train_state"):
        step(params, TTR.init_train_state(TO.sgd(), params), batch, 0)


# --------------------------------------------------------- trainer steps
@pytest.fixture
def fp32_jax(monkeypatch):
    """The JAX package casts activations to bf16 at the embedding; the fp32
    parity runs cast to fp32 there instead."""
    monkeypatch.setattr(JM, "embedding_apply", functools.partial(
        JM.embedding_apply, dtype=jnp.float32))


@pytest.mark.parametrize("attack", ["adaptive_lie", "adaptive_mimic"])
def test_three_adaptive_steps_match_jax(fp32_jax, attack):
    jcfg, tcfg = JArch(**TINY), ArchConfig(**TINY, dtype="float32")
    jparams = JMD.init_model(jax.random.key(0), jcfg)
    tparams = TMD.params_from_jax(jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    opt_j, opt_t = JO.sgd(momentum=0.9), TO.sgd(momentum=0.9)
    jstep = jax.jit(JTR.make_train_step(
        jcfg, JRobust(n_workers=N, f=F), opt_j, JS.constant(0.05),
        chunk_q=SEQ, attack=attack, telemetry=True))
    tstep = TTR.make_train_step(
        tcfg, RobustConfig(n_workers=N, f=F), opt_t, TS.constant(0.05),
        chunk_q=SEQ, attack=attack, telemetry=True)
    js = JTR.init_train_state(opt_j, jparams, n_workers=N, attack=attack,
                              attack_f=F)
    ts = TTR.init_train_state(opt_t, tparams, n_workers=N, attack=attack,
                              attack_f=F)
    decisions_j, decisions_t = [], []
    for i in range(STEPS):
        batch = {k: np.asarray(v) for k, v in make_lm_batch(
            jax.random.key(1 + i), TINY["vocab_size"], N, SEQ).items()}
        if attack == "adaptive_mimic":
            decisions_j.append(int(jnp.argmax(js.astate["trust"])))
            decisions_t.append(int(torch.argmax(ts.astate["trust"])))
        if attack == "adaptive_lie":
            zj, zt = float(js.astate["z"]), float(ts.astate["z"])
        jparams, js, jm = jstep(
            jparams, js, JTR.split_workers(
                {k: jnp.asarray(v) for k, v in batch.items()}, N),
            jax.random.key(10 + i))
        tparams, ts, tm = tstep(
            tparams, ts, TTR.split_workers(
                {k: torch.tensor(v).long() for k, v in batch.items()}, N),
            10 + i)
        np.testing.assert_allclose(tm["loss_per_worker"].numpy(),
                                   np.asarray(jm["loss_per_worker"]),
                                   rtol=1e-4)
        # the same rows selected; the mass per row within 1e-6 (the rounds
        # of a plan can average in another order)
        tsel = tm["telemetry"]["selection"].numpy()
        jsel = np.asarray(jm["telemetry"]["selection"])
        np.testing.assert_array_equal(tsel > 0, jsel > 0, err_msg=str(i))
        np.testing.assert_allclose(tsel, jsel, **TOL)
        _assert_state_close(ts.astate, js.astate)
        if attack == "adaptive_lie":
            decisions_j.append(float(js.astate["z"]) > zj)
            decisions_t.append(float(ts.astate["z"]) > zt)
    assert decisions_t == decisions_j
    assert ts.opt.step == STEPS


# ------------------------------------------------------------ the launcher
@pytest.mark.parametrize("attack", ["adaptive_lie", "adaptive_mimic"])
def test_launcher_records_astate_and_selection(attack, capsys):
    """Each record carries the state after the step and the plan's
    selection; the state follows its update rule from that selection,
    recomputed here in fp32 (the rule ``chip_smoke.py`` checks on the
    card)."""
    from repro_torch.launch import train
    _, hist = train.run(["--device", "cpu", "--reduced", "--seq", "8",
                         "--workers", "7", "--f", "1",
                         "--per-worker-batch", "1", "--steps", "3",
                         "--log-every", "100", "--attack", attack])
    atk = TA.get_adaptive(attack)
    state = atk.init_state(7, 1)
    for rec in hist:
        assert len(rec["selection"]) == 7
        assert np.isclose(sum(rec["selection"]), 1.0)
        state = atk.update(state, _t(rec["selection"]))
        assert sorted(rec["astate"]) == sorted(state)
        for k, v in state.items():
            np.testing.assert_array_equal(np.float32(rec["astate"][k]),
                                          v.numpy(), err_msg=k)
    assert "[train] done" in capsys.readouterr().out
