"""The port's campaign simulator (``repro_torch.sim``, with the part of
``repro_torch.obs`` it reads and the non-IID data of
``repro_torch.data``) against the JAX package's ``repro.sim``, on the CPU.

* ``Scenario``: the same refusals (exception type and message) as JAX,
  the same ``bounds()``, ``describe()`` and ``to_json()``;
* the digest (``obs.export.phase_summary``), the report
  (``sim.report``: dict, JSON and CSV bytes) and the suspicion EMA on one
  numpy trace: equal to JAX's;
* the non-IID walk on JAX's own draws: JAX's tokens exactly; the
  mixture's rows sum to 1 within 1e-6 and batches are worker-major;
* churn: stale workers frozen to the phase's first batch, the async
  delivery masks exactly JAX's;
* engine parity: two-phase campaigns against the live
  ``repro.sim.run_campaign``, the port fed JAX's initial parameters and
  JAX's batches through the engine's seams (``_init_params``,
  ``_make_batch_gen``), activations fp32 on both sides.  Per step:
  selection, byzantine mass and the plan fields (phase, the async
  service's admitted / overstale / ages / ``n_overstale`` /
  ``f_defended`` / ``plan_reused``, the grouped ``group_selection``)
  exactly; ``loss``, ``loss_per_worker``, ``honest_dev``,
  ``agg_grad_norm``, the score fields and the suspicion EMAs within fp32
  ``rtol=1e-4`` (``atol=1e-6``).  Divergences of ``ROADMAP.md`` queue 3
  that these campaigns meet: step 0's learning rate is 0 on both sides
  (``warmup_cosine``), so step 1 still sees the initial parameters; a
  grouped campaign's two-level selection mass is the product of a group
  and an inner weight, rounded an ulp apart (within 3e-7 relative, the
  plans exact); the checkpoints carry the same keys, shapes and dtypes;
* resume: a resume at a phase boundary replays the tail bit for bit
  (stacked with non-IID data and worker momentum, and async with the
  buffer); a resume from another step raises JAX's message.
"""
import dataclasses
import functools
import json
import os
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import models as JMD
from repro.configs.base import ArchConfig as JArch
from repro.data import synthetic as JSY
from repro.models import modules as JM
from repro.obs import export as JEX
from repro.obs import metrics as JME
from repro.sim import engine as JEN
from repro.sim import report as JRE
from repro.sim import scenario as JSC
from repro_torch import models as TMD
from repro_torch.configs import ArchConfig
from repro_torch.data import synthetic as TSY
from repro_torch.dist import split_workers
from repro_torch.obs import export as TEX
from repro_torch.obs import metrics as TME
from repro_torch.sim import engine as TEN
from repro_torch.sim import report as TRE
from repro_torch.sim import scenario as TSC

torch.set_num_threads(1)

KEY = jax.random.key(0)
#: the engine tests' model (``tests/test_sim.py``'s SMALL)
SMALL = dict(name="sim-test", family="dense", n_layers=2, d_model=64,
             n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128)
RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture
def fp32_jax(monkeypatch):
    """The JAX package casts activations to bf16 at the embedding; the fp32
    parity runs cast to fp32 there instead."""
    monkeypatch.setattr(JM, "embedding_apply", functools.partial(
        JM.embedding_apply, dtype=jnp.float32))


def _build(mod, **kw):
    """One scenario of package ``mod`` (``JSC`` or ``TSC``), the arch and
    the kernel flag translated; ``phases`` holds (steps, attack, f,
    stale_workers) tuples."""
    phases = kw.pop("phases", ((4, "none", None, ()),))
    arch = kw.pop("arch", None)
    kernels = kw.pop("kernels", True)
    if mod is JSC:
        kw["use_pallas"] = kernels
        if arch is not None:
            kw["arch"] = JArch(**arch)
    else:
        kw["use_kernels"] = kernels
        if arch is not None:
            kw["arch"] = ArchConfig(**arch, dtype="float32")
    sched = mod.AttackSchedule(tuple(
        mod.AttackPhase(steps=s, attack=a, f=f, stale_workers=st)
        for s, a, f, st in phases))
    return mod.Scenario(name="x", schedule=sched, **kw)


def _pair(**kw):
    """The scenario built by both packages: (JAX's, the port's)."""
    return _build(JSC, **dict(kw)), _build(TSC, **dict(kw))


# ------------------------------------------------------------ scenario
BAD = {
    "unknown trainer": dict(trainer="warp"),
    "effective f": dict(phases=((2, "none", 3, ()),), f=2),
    "unknown attack": dict(phases=((2, "not_an_attack", None, ()),)),
    "bad attack spec": dict(phases=((2, "sign_flip:scale", None, ()),)),
    "stale range": dict(phases=((2, "none", None, (99,)),), n_workers=11),
    "adaptive streaming": dict(phases=((2, "adaptive_lie", None, ()),),
                               trainer="stream_block"),
    "transforms streaming": dict(transforms=("clip:max_norm=1.0",),
                                 trainer="stream_global"),
    "wire attack without codec": dict(
        phases=((2, "scale_poison", None, ()),)),
    "unknown codec": dict(codec="zip"),
    "codec parameter": dict(codec="qsgd:levels=3"),
    "ef streaming": dict(codec="topk:frac=0.1,ef=1", trainer="stream_block"),
    "ef hier": dict(codec="topk:frac=0.1,ef=1", hier_g=7, n_workers=14,
                    f=1),
    "negative hier": dict(hier_g=-1),
    "infeasible hier": dict(hier_g=3, n_workers=11, f=2),
    "hier outer": dict(hier_g=7, n_workers=21, f=7, hier_f_inner=1,
                       hier_f_outer=0),
    "negative tau": dict(async_tau=-1),
    "stale period": dict(async_tau=1, stale_period=0),
    "async streaming": dict(async_tau=1, trainer="stream_global"),
    "async codec": dict(async_tau=1, codec="bf16"),
    "async adaptive": dict(async_tau=1,
                           phases=((2, "adaptive_mimic", None, ()),)),
}


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return type(e), str(e)
    return None


@pytest.mark.parametrize("case", sorted(BAD))
def test_scenario_refusals_match_jax(case):
    kw = BAD[case]
    want = _error(lambda: _build(JSC, **dict(kw)))
    got = _error(lambda: _build(TSC, **dict(kw)))
    assert want is not None
    assert got == want


@pytest.mark.parametrize("build", [
    lambda m: m.AttackPhase(steps=0),
    lambda m: m.AttackSchedule(()),
    lambda m: m.DataConfig(noniid_alpha=-1.0),
    lambda m: m.DataConfig(noniid_alpha=0.5, n_domains=1),
    lambda m: m.Scenario(name="x", schedule=m.AttackSchedule(
        (m.AttackPhase(steps=2),)), transforms=("warp:x=1",)
        ).build_transforms(),
], ids=["steps", "schedule", "alpha", "domains", "transform"])
def test_scenario_part_refusals_match_jax(build):
    want = _error(lambda: build(JSC))
    assert want is not None
    assert _error(lambda: build(TSC)) == want


GOOD = {
    "flat": dict(phases=((3, "none", None, ()),
                         (5, "little_is_enough:z=4.0", 1, (4, 7)))),
    "codec and transforms": dict(codec="qsgd:bits=8",
                                 transforms=("worker_momentum:beta=0.9",),
                                 kernels=False),
    "hier": dict(n_workers=35, f=7, hier_g=7, hier_f_inner=1,
                 hier_f_outer=1, hier_outer_rule="krum",
                 hier_enforce=False),
    "async": dict(async_tau=2, stale_period=3, seed=4,
                  phases=((8, "sign_flip", None, (9, 10)),)),
    "data": dict(data=None, arch=SMALL, per_worker_batch=3, seq=32,
                 lr=0.01, momentum=0.5, trainer="stream_block"),
}


@pytest.mark.parametrize("case", sorted(GOOD))
def test_scenario_matches_jax(case):
    kw = dict(GOOD[case])
    if "data" in kw:
        del kw["data"]
        js, ts = _pair(**kw)
        js = dataclasses.replace(js, data=JSC.DataConfig(0.3, 5))
        ts = dataclasses.replace(ts, data=TSC.DataConfig(0.3, 5))
    else:
        js, ts = _pair(**kw)
    assert ts.schedule.bounds() == js.schedule.bounds()
    assert ts.schedule.describe() == js.schedule.describe()
    assert ts.schedule.total_steps == js.schedule.total_steps
    assert ts.to_json() == js.to_json()
    assert [ts.phase_f(p) for p in ts.schedule.phases] == \
        [js.phase_f(p) for p in js.schedule.phases]
    assert [type(t).__name__ for t in ts.build_transforms()] == \
        [type(t).__name__ for t in js.build_transforms()]


def test_switch_scenario_matches_jax():
    js = JSC.switch_scenario("multi_krum", pre=3, post=4, seed=2,
                             use_pallas=True)
    ts = TSC.switch_scenario("multi_krum", pre=3, post=4, seed=2)
    assert ts.to_json() == js.to_json()
    assert ts.arch.name == js.arch.name == "sim-tiny"
    for field in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                  "vocab_size"):
        assert getattr(ts.arch, field) == getattr(js.arch, field)


# ------------------------------------------------- digest, report, EMA
def _trace(n, steps, groups, seed):
    """A campaign trace of every field kind, float32 (``phase`` int32)."""
    rng = np.random.default_rng(seed)
    sel = rng.random((steps, n)).astype(np.float32)
    tr = {"loss": rng.random(steps), "lr": rng.random(steps),
          "agg_grad_norm": rng.random(steps), "honest_dev": rng.random(steps),
          "byz_mass": rng.random(steps), "score_gap": rng.random(steps),
          "mean_dist": rng.random(steps), "n_overstale": rng.random(steps),
          "f_defended": rng.random(steps), "plan_reused": rng.random(steps),
          "selection": sel / sel.sum(1, keepdims=True),
          "suspicion": rng.random((steps, n)),
          "score_spectrum": rng.random((steps, n)),
          "loss_per_worker": rng.random((steps, n)),
          "admitted": rng.random((steps, n)),
          "overstale": rng.random((steps, n)),
          "staleness_ema": rng.random((steps, n)),
          "group_selection": rng.random((steps, groups)),
          "group_suspicion": rng.random((steps, groups))}
    tr = {k: v.astype(np.float32) for k, v in tr.items()}
    tr["phase"] = np.repeat(np.arange(3, dtype=np.int32), [2, 3, 2])[:steps]
    return tr


@pytest.mark.parametrize("start_step,wire", [
    (0, None), (2, {"codec": "bf16", "bytes_per_worker": 10}), (5, None)])
def test_phase_summary_and_report_match_jax(tmp_path, start_step, wire):
    js, ts = _pair(n_workers=14, f=1, hier_g=7, phases=(
        (2, "none", None, ()), (3, "sign_flip", None, ()),
        (2, "inf", 0, (3,))))
    tr = _trace(14, 7 - start_step, 2, start_step)
    want = JEX.phase_summary(tr, js, start_step, wire=wire)
    got = TEX.phase_summary(tr, ts, start_step, wire=wire)
    assert got == want
    for full in (False, True):
        jr = types.SimpleNamespace(scenario=js, trace=tr, summary=want,
                                   start_step=start_step, wall_s=1.23456)
        tres = types.SimpleNamespace(scenario=ts, trace=tr, summary=got,
                                     start_step=start_step, wall_s=1.23456)
        assert TRE.result_to_json(tres, full_trace=full) == \
            JRE.result_to_json(jr, full_trace=full)
    for writer in ("write_json", "write_csv"):
        a = getattr(JRE, writer)(str(tmp_path / f"j.{writer}"), jr)
        b = getattr(TRE, writer)(str(tmp_path / f"t.{writer}"), tres)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


def test_suspicion_ema_matches_jax():
    rng = np.random.default_rng(3)
    js = JME.init_suspicion(11)
    ts = TME.init_suspicion(11, device="cpu")
    jst, tst = js, ts
    for step in range(12):
        sel = rng.random(11).astype(np.float32)
        sel[:2] = 0.0 if step % 3 else sel[:2]
        sel /= sel.sum()
        js = JME.update_suspicion(js, jnp.asarray(sel), 0.9)
        ts = TME.update_suspicion(ts, torch.from_numpy(sel), 0.9)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        mask = rng.random(11) < 0.3
        jst = JME.update_ema(jst, jnp.asarray(mask), 0.8)
        tst = TME.update_ema(tst, torch.from_numpy(mask), 0.8)
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    assert ts.dtype == tst.dtype == torch.float32


# ------------------------------------------------------------- data
def _jax_draws(key, vocab, n, pw, seq, mixture):
    """The draws JAX's ``make_noniid_lm_batch`` takes from ``key``."""
    rows = n * pw
    kd, k0, k1 = jax.random.split(key, 3)
    row_logits = jnp.repeat(jnp.log(mixture + 1e-20), pw, axis=0)
    domains = jax.random.categorical(kd, row_logits, axis=-1)
    start = jax.random.randint(k0, (rows,), 0, vocab, dtype=jnp.int32)
    choices = jax.random.randint(k1, (rows, seq), 0, 4, dtype=jnp.int32)
    return domains, start, choices


@pytest.mark.parametrize("n,pw,seq,alpha,seed", [
    (6, 2, 16, 0.2, 1234), (11, 3, 9, 1.0, 77), (4, 1, 5, 0.05, 5)])
def test_noniid_walk_matches_jax(n, pw, seq, alpha, seed):
    vocab, domains_k = 128, 3
    mix = JSY.dirichlet_mixture(KEY, n, domains_k, alpha)
    key = jax.random.fold_in(KEY, seed)
    want = JSY.make_noniid_lm_batch(key, vocab, n, pw, seq, mix, seed=seed)
    dom, start, choices = _jax_draws(key, vocab, n, pw, seq, mix)
    tables = torch.from_numpy(np.stack(
        [TSY._bigram_table(vocab, seed + k) for k in range(domains_k)]))
    got = TSY.lm_walk(tables, torch.from_numpy(np.array(dom)),
                      torch.from_numpy(np.array(start)),
                      torch.from_numpy(np.array(choices)))
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_lm_batch_walk_matches_jax():
    """One table: ``make_lm_batch``'s walk on JAX's draws gives JAX's
    tokens."""
    want = JSY.make_lm_batch(KEY, 128, 6, 12, seed=9)
    k0, k1 = jax.random.split(KEY)
    start = jax.random.randint(k0, (6,), 0, 128, dtype=jnp.int32)
    choices = jax.random.randint(k1, (6, 12), 0, 4, dtype=jnp.int32)
    got = TSY.lm_walk(torch.from_numpy(TSY._bigram_table(128, 9))[None],
                      torch.zeros(6, dtype=torch.long),
                      torch.from_numpy(np.array(start)),
                      torch.from_numpy(np.array(choices)))
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def test_dirichlet_mixture_properties():
    mix = TSY.dirichlet_mixture(_gen(0), 8, 4, alpha=0.1)
    assert mix.shape == (8, 4) and mix.dtype == torch.float32
    np.testing.assert_allclose(mix.sum(1).numpy(), 1.0, atol=1e-6)
    assert bool(torch.all(mix >= 0))
    # small alpha concentrates workers on few domains, large spreads them
    assert float(mix.max(1).values.mean()) > 0.7
    wide = TSY.dirichlet_mixture(_gen(0), 400, 4, alpha=50.0)
    np.testing.assert_allclose(wide.mean(0).numpy(), 0.25, atol=0.01)
    assert float(wide.max(1).values.mean()) < 0.4
    assert torch.equal(TSY.dirichlet_mixture(_gen(5), 6, 3, 0.3),
                       TSY.dirichlet_mixture(_gen(5), 6, 3, 0.3))


@pytest.mark.parametrize("args", [(8, 0, 0.5), (8, 4, 0.0), (8, 4, -1.0)])
def test_dirichlet_refusals_match_jax(args):
    want = _error(lambda: JSY.dirichlet_mixture(KEY, *args))
    assert want is not None
    assert _error(lambda: TSY.dirichlet_mixture(_gen(0), *args)) == want


def test_noniid_batch_worker_major():
    """One-hot mixtures: worker w's rows walk automaton w only, rows in
    worker order, deterministic in the generator's state."""
    n, pw, seq, vocab = 3, 2, 10, 64
    mix = torch.eye(n)
    b = TSY.make_noniid_lm_batch(_gen(1), vocab, n, pw, seq, mix, seed=40)
    b2 = TSY.make_noniid_lm_batch(_gen(1), vocab, n, pw, seq, mix, seed=40)
    assert b["tokens"].shape == (n * pw, seq)
    assert torch.equal(b["tokens"], b2["tokens"])
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    per = split_workers(b, n)
    for w in range(n):
        table = TSY._bigram_table(vocab, 40 + w)
        for row_t, row_l in zip(per["tokens"][w], per["labels"][w]):
            for a, c in zip(row_t.tolist(), row_l.tolist()):
                assert c in table[a]
    jmix = JSY.dirichlet_mixture(KEY, 6, 3, 0.2)
    want = _error(lambda: JSY.make_noniid_lm_batch(KEY, 128, 5, 2, 16, jmix))
    got = _error(lambda: TSY.make_noniid_lm_batch(
        _gen(0), 128, 5, 2, 16, torch.from_numpy(np.array(jmix))))
    assert want is not None and got == want


# ------------------------------------------------------------- churn
def test_phase_batches_freeze_stale_workers():
    sc = TSC.Scenario(name="churn", schedule=TSC.AttackSchedule(
        (TSC.AttackPhase(steps=4, stale_workers=(1, 3)),)),
        n_workers=5, f=0, gar="average", arch=ArchConfig(**SMALL), seq=16)
    gen = TEN._make_batch_gen(sc, None)
    batches = TEN._phase_batches(gen, sc.schedule.phases[0], 6)
    toks = batches["tokens"]
    assert tuple(toks.shape) == (4, 5, 2, 16)
    for w in (1, 3):
        for t in range(1, 4):
            assert torch.equal(toks[t, w], toks[0, w])
    assert not torch.equal(toks[1, 0], toks[0, 0])
    # keyed by the global step: the phase's unfrozen rows are step 6-9's
    fresh = TEN._phase_batches(gen, sc.schedule.phases[0], 6, freeze=False)
    assert torch.equal(fresh["tokens"][2, 1], gen([8])["tokens"][0, 1])
    assert torch.equal(fresh["tokens"][:, 0], toks[:, 0])


@pytest.mark.parametrize("start,period", [(0, 4), (3, 2), (10, 3)])
def test_async_fresh_masks_match_jax(start, period):
    js, ts = _pair(async_tau=1, stale_period=period,
                   phases=((7, "none", None, (2, 9)),))
    want = JEN._phase_fresh(js, js.schedule.phases[0], start)
    got = TEN._phase_fresh(ts, ts.schedule.phases[0], start)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------- engine parity
#: (trainer fields, phases): each campaign's two phases
CAMPAIGNS = {
    "stacked": dict(phases=((2, "none", None, ()),
                            (3, "sign_flip", None, (5,)))),
    "stream_global": dict(trainer="stream_global", phases=(
        (2, "none", None, ()), (2, "little_is_enough:z=4.0", None, ()))),
    "async": dict(async_tau=1, stale_period=2, phases=(
        (2, "none", None, ()), (3, "sign_flip", None, (9,)))),
    "hier": dict(n_workers=14, f=1, hier_g=7, phases=(
        (2, "none", None, ()), (2, "little_is_enough:z=4.0", None, ()))),
}
EXACT = ("phase", "admitted", "overstale", "staleness_age",
         "n_overstale", "f_defended", "plan_reused", "group_selection")
MASS = ("selection", "byz_mass")


def _ckpt_meta(directory):
    out = {}
    for name in sorted(os.listdir(directory)):
        with np.load(os.path.join(directory, name)) as data:
            out[name] = {k: (data[k].shape, data[k].dtype.str)
                         for k in data.files}
    return out


@pytest.mark.parametrize("case", sorted(CAMPAIGNS))
def test_campaign_matches_jax(fp32_jax, monkeypatch, tmp_path, case):
    js, ts = _pair(arch=SMALL, seq=16, seed=3,
                   **dict(CAMPAIGNS[case]))
    jcfg = js.arch
    jgen = JEN._make_batch_gen(js, None)

    def batch_gen(scenario, mixture):
        def gen(steps):
            b = jgen(jnp.asarray(list(steps)))
            return {k: torch.from_numpy(np.array(v)).long()
                    for k, v in b.items()}
        return gen

    def init_params(scenario, device):
        p = JMD.init_model(jax.random.key(scenario.seed), jcfg)
        return TMD.params_from_jax(jax.tree.map(np.asarray, p),
                                   device=device)

    monkeypatch.setattr(TEN, "_make_batch_gen", batch_gen)
    monkeypatch.setattr(TEN, "_init_params", init_params)
    want = JEN.run_campaign(js, ckpt_dir=str(tmp_path / "j"))
    got = TEN.run_campaign(ts, ckpt_dir=str(tmp_path / "t"), device="cpu")
    jt, tt = want.trace, got.trace
    assert sorted(tt) == sorted(jt)
    bad = []
    for k in sorted(jt):
        a, b = tt[k], np.asarray(jt[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        try:
            if k in EXACT:
                np.testing.assert_array_equal(a, b)
            elif k in MASS:
                # the selected rows exactly, their mass an ulp apart
                np.testing.assert_array_equal(a > 0, b > 0)
                if case == "hier":
                    np.testing.assert_allclose(a, b, rtol=3e-7, atol=0)
                else:
                    np.testing.assert_array_max_ulp(a, b, maxulp=1)
            else:
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
        except AssertionError as e:
            bad.append(f"{k}: {e}")
    assert not bad, "\n".join(bad)
    assert tt["lr"][0] == 0.0
    assert list(got.summary) == list(want.summary)
    assert [p["attack"] for p in got.summary["phases"]] == \
        [p["attack"] for p in want.summary["phases"]]
    assert _ckpt_meta(tmp_path / "t") == _ckpt_meta(tmp_path / "j")


# ------------------------------------------------------------ resume
RESUME = {
    # non-IID data + a stateful transform: the resume must reproduce the
    # Dirichlet assignment and restore the per-worker momentum slots
    "stacked": dict(data=TSC.DataConfig(noniid_alpha=0.3),
                    transforms=("worker_momentum:beta=0.9",)),
    # the buffer, its ages and its last plan ride the checkpoint
    "async": dict(async_tau=1, stale_period=2),
}


@pytest.mark.parametrize("case", sorted(RESUME))
def test_resume_replays_tail_bit_for_bit(tmp_path, case):
    stale = (9,) if case == "async" else ()
    sched = TSC.AttackSchedule((
        TSC.AttackPhase(steps=3, attack="none"),
        TSC.AttackPhase(steps=3, attack="little_is_enough:z=2.0",
                        stale_workers=stale)))
    sc = TSC.Scenario(name="resume", schedule=sched, n_workers=11, f=2,
                      gar="multi_bulyan", arch=ArchConfig(**SMALL), seq=16,
                      **RESUME[case])
    d = str(tmp_path / "ck")
    full = TEN.run_campaign(sc, ckpt_dir=d, device="cpu")
    assert sorted(os.listdir(d)) == ["ckpt_00000003.npz",
                                     "ckpt_00000006.npz"]
    os.remove(os.path.join(d, "ckpt_00000006.npz"))
    resumed = TEN.run_campaign(sc, ckpt_dir=d, resume=True, device="cpu")
    assert resumed.start_step == 3
    assert sorted(resumed.trace) == sorted(full.trace)
    for k, v in resumed.trace.items():
        np.testing.assert_array_equal(v, full.trace[k][3:], err_msg=k)
    ph = resumed.summary["phases"]
    assert len(ph) == 1 and ph[0]["attack"] == "little_is_enough:z=2.0"
    # a resume from a step that is not a phase boundary is refused
    os.remove(os.path.join(d, "ckpt_00000006.npz"))
    os.replace(os.path.join(d, "ckpt_00000003.npz"),
               os.path.join(d, "ckpt_00000004.npz"))
    with pytest.raises(ValueError) as e:
        TEN.run_campaign(sc, ckpt_dir=d, resume=True, device="cpu")
    assert str(e.value) == (
        "checkpoint step 4 is not a phase boundary of schedule "
        "'none@3 -> little_is_enough:z=2.0@3'")


def test_report_round_trips(tmp_path):
    """A campaign's JSON report re-reads as ``result_to_json`` gives it,
    and its CSV has one row a step."""
    sc = TSC.switch_scenario("multi_bulyan", pre=1, post=1,
                             arch=ArchConfig(**SMALL), seq=16)
    r = TEN.run_campaign(sc, device="cpu")
    path = TRE.write_json(str(tmp_path / "r.json"), r)
    with open(path) as fh:
        back = json.load(fh)
    assert back == json.loads(json.dumps(TRE.result_to_json(r)))
    assert back["schema"] == "sim.campaign.v1"
    assert back["scenario"]["use_pallas"] is True
    rows = open(TRE.write_csv(str(tmp_path / "r.csv"), r)).read().split()
    assert len(rows) == 3 and rows[0].startswith("step,")
