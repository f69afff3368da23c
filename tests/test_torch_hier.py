"""The port's hierarchical aggregation (``repro_torch.hier``) against the
JAX package's ``repro.hier``, on the CPU.

* the grouped budget arithmetic (``core.theory``: ``max_f``,
  ``group_sizes``, ``FBudget``, ``split_f_budget``), ``GroupConfig``'s
  spec grammar and ``comm.hier_wire_stats``: the same numbers and the same
  ``ValueError`` messages as JAX;
* ``hier_aggregate_tree`` on numpy-seeded trees: every inner and outer
  plan exactly JAX's, the selection weights within 1 ulp (the two
  frameworks round a bulyan plan's row mean apart), the aggregate within
  ``rtol=atol=1e-5``, on plain trees and on JAX's wire containers carried
  across (``comm.codecs.encoded_from_jax``; the leader re-encode on the
  deterministic codecs, whose bytes must match exactly);
* the invariants of ``tests/test_hier.py`` on the port: ``g >= n`` bit
  for bit the flat path, permutation invariance, the poisoned subtree,
  the budget refusal;
* trainer steps at n = 14, g = 7 against JAX's (parameters within
  ``rtol=1e-4, atol=1e-6``, as ``tests/test_torch_trainer.py`` holds the
  flat step), the streaming trainer's global scope bit for bit the
  stacked step (port against port, uncompressed and under QSGD), its
  block scope against JAX, the refusals and the launcher's lines.
"""
import dataclasses
import functools
import re
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import models as JMD
from repro.comm import codecs as JC
from repro.comm import transport as JTP
from repro.configs.base import ArchConfig as JArch
from repro.configs.base import RobustConfig as JRobust
from repro.core import theory as JTH
from repro.data.synthetic import make_lm_batch
from repro.dist import streaming as JST
from repro.dist import trainer as JTR
from repro.hier import GroupConfig as JGroup
from repro.hier import hier_aggregate_tree as jhier
from repro.models import modules as JM
from repro.optim import optimizers as JO
from repro.optim import schedules as JS
from repro_torch import comm as TCM
from repro_torch import models as TMD
from repro_torch.comm import codecs as TC
from repro_torch.configs import ArchConfig, RobustConfig
from repro_torch.core import api as TAPI
from repro_torch.core import theory as TTH
from repro_torch.core.attacks import fold_seed
from repro_torch.dist import streaming as TST
from repro_torch.dist import trainer as TTR
from repro_torch.hier import (GroupConfig, HierPlan, LEADER_ENCODE_STREAM,
                              hier_aggregate_tree)
from repro_torch.hier import aggregate as THA
from repro_torch.launch import train as TLT
from repro_torch.optim import optimizers as TO
from repro_torch.optim import schedules as TS
from repro_torch.tree import tree_items, tree_leaves

torch.set_num_threads(1)

#: leaf widths of the aggregation cases: d not a multiple of 128, a 3-d leaf
LEAVES = {"a": (100,), "b": (257,), "c": (3, 5)}


def _raises(fn):
    """The ValueError message ``fn`` raises (None when it returns)."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _np_tree(n, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=(n,) + s).astype(np.float32)
            for k, s in LEAVES.items()}


def _jt(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _tt(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _close_ulp(got, want):
    """Within one fp32 ulp of ``want``, elementwise."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_less(
        np.abs(got - want), np.spacing(np.abs(want)) * 1.01 + 1e-30)


def _same_plan(tp, jp):
    """A flat plan exactly JAX's: its kind, the bulyan weights and beta or
    the krum weights (selection weights within an ulp)."""
    if jp.w_ext is not None:
        assert tp.kind == "bulyan" and tp.beta == jp.beta
        np.testing.assert_array_equal(tp.w_ext.numpy(), np.asarray(jp.w_ext))
        np.testing.assert_array_equal(tp.w_agr.numpy(), np.asarray(jp.w_agr))
    elif jp.weights is not None:
        assert tp.kind == "weighted"
        np.testing.assert_array_equal(tp.weights.numpy(),
                                      np.asarray(jp.weights))
    _close_ulp(tp.selection_weights().numpy(), jp.selection_weights())


def _same_hier(tplan, jplan):
    assert (tplan.n, tplan.f, tplan.g, tplan.bounds, tplan.f_inner,
            tplan.f_outer, tplan.rule, tplan.outer_rule) == \
        (jplan.n, jplan.f, jplan.g, jplan.bounds, jplan.f_inner,
         jplan.f_outer, jplan.rule, jplan.outer_rule)
    assert tplan.n_groups == jplan.n_groups
    for tp, jp in zip(tplan.inner, jplan.inner):
        _same_plan(tp, jp)
    assert (tplan.outer is None) == (jplan.outer is None)
    if jplan.outer is not None:
        _same_plan(tplan.outer, jplan.outer)
    _close_ulp(tplan.group_selection().numpy(), jplan.group_selection())
    # worker mass = group mass x inner mass: an ulp of each
    np.testing.assert_allclose(tplan.selection_weights().numpy(),
                               np.asarray(jplan.selection_weights()),
                               rtol=3e-7, atol=1e-30)


def _same_diag(td, jd):
    """The diagnostics within 1e-5; the score gap, a difference of two
    scores, within 1e-5 of the largest score."""
    assert sorted(td) == sorted(jd)
    for k in jd:
        atol = 1e-6
        if k == "score_gap":
            atol = 1e-5 * float(np.nanmax(np.abs(np.asarray(
                jd["score_spectrum"]))))
        np.testing.assert_allclose(td[k].numpy(), np.asarray(jd[k]),
                                   rtol=1e-5, atol=atol, err_msg=k)


def _same_agg(tagg, jagg, rtol=1e-5, atol=1e-5):
    for k in LEAVES:
        assert tuple(tagg[k].shape) == tuple(jagg[k].shape)
        np.testing.assert_allclose(tagg[k].numpy(), np.asarray(jagg[k]),
                                   rtol=rtol, atol=atol, err_msg=k)


#: one bf16 wire step, relative to the largest magnitude it scales
WIRE_STEP = 2.0 ** -7


def _close_but_wire(got, want, *, scale, rtol, atol, what=""):
    """Within ``rtol`` / ``atol`` except where a deterministic codec
    encoded values an ulp apart to neighbouring wire values (the known
    divergence of ``tests/test_torch_comm.py``): at most max(1, 0.1 %)
    of the entries, each within one wire step of ``scale``."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    diff = np.abs(got - want)
    off = diff > atol + rtol * np.abs(want)
    assert off.sum() <= max(1, int(0.001 * want.size)), (what, off.sum())
    assert np.all(diff[off] <= WIRE_STEP * scale), (what, diff[off], scale)


# ====================================================== budget arithmetic
BUDGET_CASES = [
    (256, 7, 16, {}), (11, 2, 11, {}), (49, 3, 7, {}), (21, 1, 7, {}),
    (14, 1, 7, {}), (5, 0, 8, {}), (11, 4, 4, {}), (2048, 31, 64, {}),
    (12, 1, 4, {}), (64, 7, 16, {"f_inner": 5}),
    (21, 7, 7, {"f_inner": 1, "f_outer": 0}),
    (21, 7, 7, {"f_inner": 1, "f_outer": 0, "enforce": False}),
    (35, 7, 7, {"f_inner": 1, "f_outer": 1, "enforce": False,
                "outer_rule": "krum"}),
    (35, 7, 7, {"f_inner": 1, "f_outer": 1, "enforce": False}),
    (21, 1, 7, {"outer_rule": "krum"}), (21, 1, 7, {"outer_rule": "median"}),
    (49, 3, 7, {"rule": "multi_krum"}), (30, 4, 10, {"rule": "krum"}),
    (30, 4, 10, {"rule": "trimmed_mean"}), (30, 4, 10, {"rule": "average"}),
    (9, 2, 0, {}), (0, 1, 4, {}), (21, -1, 7, {}), (11, 2, 20, {}),
    (11, 3, 20, {"f_inner": 2, "enforce": False}),
]


@pytest.mark.parametrize("n,f,g,kw", BUDGET_CASES)
def test_split_f_budget_matches_jax(n, f, g, kw):
    """The same budget (sizes, per-level f, bounds, coverage) or the same
    ValueError message."""
    def run(th):
        b = th.split_f_budget(n, f, g, **kw)
        return (b.n, b.f, b.g, b.group_sizes, b.n_groups, b.f_inner,
                b.f_outer, b.bounds(), b.capturable_groups(), b.covers(),
                [b.covers(k) for k in range(0, 2 * f + 2)],
                [b.capturable_groups(k) for k in range(0, 2 * f + 2)])
    jmsg, tmsg = _raises(lambda: run(JTH)), _raises(lambda: run(TTH))
    assert tmsg == jmsg
    if jmsg is None:
        assert run(TTH) == run(JTH)


@pytest.mark.parametrize("rule", ["multi_bulyan", "bulyan", "krum",
                                  "multi_krum", "trimmed_mean", "median",
                                  "average"])
def test_max_f_group_sizes_and_check_level_match_jax(rule):
    for n in range(1, 70):
        assert TTH.max_f(rule, n) == JTH.max_f(rule, n)
        for g in (1, 3, 7, 16, 64):
            assert TTH.group_sizes(n, g) == JTH.group_sizes(n, g)
        for f in (-1, 0, 1, 3):
            for level in (None, "inner", "outer"):
                assert _raises(lambda: TTH.check_level(
                    n, f, rule=rule, level=level)) == _raises(
                    lambda: JTH.check_level(n, f, rule=rule, level=level))


# ================================================================ specs
SPECS = ["g=64", "7", "g=7,rule=multi_krum,outer_rule=krum,f_inner=1,"
         "enforce=0", " g = 5 , f_outer = 2 ,", "g=4,enforce=false",
         "g=4,enforce=1", "rule=krum", "g=4,zap=1", "g=x", ""]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("rule", ["multi_bulyan", "median"])
def test_group_config_from_spec_matches_jax(spec, rule):
    jmsg = _raises(lambda: JGroup.from_spec(spec, rule=rule))
    tmsg = _raises(lambda: GroupConfig.from_spec(spec, rule=rule))
    assert tmsg == jmsg
    if jmsg is None:
        assert dataclasses.asdict(GroupConfig.from_spec(spec, rule=rule)) \
            == dataclasses.asdict(JGroup.from_spec(spec, rule=rule))


@pytest.mark.parametrize("n,f,kw", [(21, 1, {}), (49, 3, {}),
                                    (21, 1, {"outer_rule": "krum"}),
                                    (21, 7, {"f_inner": 1, "f_outer": 0,
                                             "enforce_budget": False})])
def test_group_config_budget_and_outer_rule_match_jax(n, f, kw):
    tcfg, jcfg = GroupConfig(g=7, **kw), JGroup(g=7, **kw)
    tb, jb = tcfg.budget(n, f), jcfg.budget(n, f)
    assert dataclasses.asdict(tb) == dataclasses.asdict(jb)
    assert tcfg.resolve_outer_rule(tb) == jcfg.resolve_outer_rule(jb)


@pytest.mark.parametrize("codec", ["qsgd:bits=8", "bf16", "signsgd",
                                   "topk:frac=0.1", "fp32"])
@pytest.mark.parametrize("n,g", [(21, 7), (49, 7), (11, 4), (5, 8)])
def test_hier_wire_stats_match_jax(codec, n, g):
    rng = np.random.default_rng(0)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in LEAVES.items()}
    got = TCM.hier_wire_stats(codec, _tt(params), n=n, g=g)
    want = JTP.hier_wire_stats(codec, _jt(params), n=n, g=g)
    assert [w.to_json() for w in got] == [w.to_json() for w in want]
    assert [w.level for w in got] == ["workers_to_leaders",
                                      "leaders_to_server"]
    # the flat gather keeps its keys: no "level"
    flat = TCM.wire_stats(codec, _tt(params), n=n)
    assert "level" not in flat.to_json()
    assert flat.to_json() == JTP.wire_stats(codec, _jt(params),
                                            n=n).to_json()


# ======================================================== the aggregation
AGG_CASES = [
    ("multi_bulyan", 21, 1, {}), ("multi_bulyan", 49, 3, {}),
    ("multi_bulyan", 14, 1, {}), ("multi_krum", 21, 1, {}),
    ("multi_krum", 49, 3, {}), ("multi_krum", 14, 1, {}),
    ("multi_bulyan", 21, 1, {"outer_rule": "krum"}),
    ("multi_bulyan", 21, 1, {"outer_rule": "median"}),
    ("multi_bulyan", 49, 3, {"outer_rule": "krum"}),
    ("multi_bulyan", 49, 3, {"outer_rule": "median"}),
    ("multi_bulyan", 35, 7, {"f_inner": 1, "f_outer": 1,
                             "outer_rule": "krum", "enforce_budget": False}),
    ("multi_krum", 35, 7, {"f_inner": 1, "f_outer": 1,
                           "enforce_budget": False}),
]


def _both(tree, f, rule, kw, *, needs_dists=None, **extra):
    """(port's (agg, plan, info), JAX's) on the same numpy tree."""
    tout = hier_aggregate_tree(_tt(tree), f, GroupConfig(g=7, rule=rule,
                                                         **kw),
                               use_kernels=True, needs_dists=needs_dists,
                               **extra)
    jout = jhier(_jt(tree), f, JGroup(g=7, rule=rule, **kw),
                 needs_dists=needs_dists, **extra)
    return tout, jout


@pytest.mark.parametrize("rule,n,f,kw", AGG_CASES)
def test_hier_aggregate_tree_matches_jax(rule, n, f, kw):
    """Plans exact, the aggregate within 1e-5, the diagnostics (with and
    without distances) and the per-group statistics."""
    tree = _np_tree(n, n)
    (tagg, tplan, tinfo), (jagg, jplan, jinfo) = _both(
        tree, f, rule, kw, needs_dists=True)
    assert isinstance(tplan, HierPlan)
    _same_hier(tplan, jplan)
    _same_agg(tagg, jagg)
    _same_diag(tplan.diagnostics(tinfo["inner_stats"]),
               jplan.diagnostics(jinfo["inner_stats"]))
    _same_diag(tplan.diagnostics(), jplan.diagnostics())
    assert tinfo["leader_wire_bytes"] == jinfo["leader_wire_bytes"] == 0
    for ts, js in zip(tinfo["inner_stats"], jinfo["inner_stats"]):
        assert (ts.n, ts.f) == (js.n, js.f)
        np.testing.assert_allclose(ts.dists.numpy(), np.asarray(js.dists),
                                   rtol=1e-5, atol=1e-4)
    assert (tinfo["outer_stats"] is None) == (jinfo["outer_stats"] is None)


@pytest.mark.parametrize("codec,n,f", [
    ("bf16", 21, 1), ("signsgd", 21, 1), ("topk:frac=0.1", 21, 1),
    ("bf16", 49, 3)])
def test_wire_container_and_leader_reencode_match_jax(codec, n, f):
    """JAX's worker container carried across; the group aggregates
    re-encoded with the same deterministic codec: the plans exact, the
    aggregate within 1e-5, the leader bytes exactly JAX's (n_groups times
    a worker's)."""
    tree = _np_tree(n, 100 + n)
    jenc, _ = JC.get_codec(codec).encode(_jt(tree), key=jax.random.key(0))
    tenc = TC.encoded_from_jax(jenc, device="cpu")
    tagg, tplan, tinfo = hier_aggregate_tree(
        tenc, f, GroupConfig(g=7), codec=codec, seed=0, use_kernels=True,
        needs_dists=True)
    jagg, jplan, jinfo = jhier(jenc, f, JGroup(g=7), codec=codec,
                               key=jax.random.key(0), needs_dists=True)
    _same_hier(tplan, jplan)
    # the leader hop encodes group aggregates an ulp apart
    for k in LEAVES:
        _close_but_wire(tagg[k].numpy(), jagg[k], rtol=1e-5, atol=1e-5,
                        scale=float(np.abs(np.asarray(jagg[k])).max()),
                        what=k)
    assert tinfo["leader_wire_bytes"] == jinfo["leader_wire_bytes"]
    n_groups = len(TTH.group_sizes(n, 7))
    assert tinfo["leader_wire_bytes"] == n_groups * (tenc.wire_bytes // n)
    _same_diag(tplan.diagnostics(tinfo["inner_stats"]),
               jplan.diagnostics(jinfo["inner_stats"]))


@pytest.mark.parametrize("codec", ["qsgd:bits=8", "qsgd:bits=4"])
def test_qsgd_inner_level_matches_jax_and_leader_hop_is_exact(codec):
    """QSGD's draws differ by framework: the inner level is held to JAX on
    JAX's worker container, and the leader hop by its exact bytes and by
    decoding, in the port, what the port encoded."""
    tree = _np_tree(21, 5)
    jenc, _ = JC.get_codec(codec).encode(_jt(tree), key=jax.random.key(3))
    tenc = TC.encoded_from_jax(jenc, device="cpu")
    tagg, tplan, _ = hier_aggregate_tree(tenc, 1, GroupConfig(g=7),
                                         use_kernels=True)
    jagg, jplan, _ = jhier(jenc, 1, JGroup(g=7))
    _same_hier(tplan, jplan)
    _same_agg(tagg, jagg)
    c = TC.get_codec(codec)
    agg2, plan2, info = hier_aggregate_tree(tenc, 1, GroupConfig(g=7),
                                            codec=codec, seed=9,
                                            use_kernels=True)
    want = sum(c.leaf_wire_bytes((3,) + s) for s in LEAVES.values())
    assert info["leader_wire_bytes"] == want
    # the hop, by hand: encode the stacked group aggregates with the
    # leader stream, decode, average (f_outer = 0)
    inter = THA.stack_groups([
        TAPI.get_aggregator("multi_bulyan").apply(
            p, TC.slice_workers(tenc, s, e), use_kernels=True)
        for p, (s, e) in zip(plan2.inner, plan2.bounds)])
    enc2, _ = c.encode(inter, seed=fold_seed(9, LEADER_ENCODE_STREAM))
    dec = c.decode(enc2)
    for k in LEAVES:
        assert torch.equal(agg2[k], torch.mean(dec[k], dim=0))
    # the same seed gives the same bits; the leader stream is its own
    again = hier_aggregate_tree(tenc, 1, GroupConfig(g=7), codec=codec,
                                seed=9, use_kernels=True)[0]
    assert all(torch.equal(agg2[k], again[k]) for k in LEAVES)


def test_leader_stream_is_disjoint_from_the_trainer_streams():
    assert LEADER_ENCODE_STREAM == 2 ** 31 - 3
    assert len({LEADER_ENCODE_STREAM, TTR.ENCODE_STREAM,
                TTR.TRANSFORM_STREAM}) == 3
    for seed in (0, 1, 7, 2 ** 40):
        streams = {s: {fold_seed(fold_seed(seed, s), i) for i in range(512)}
                   for s in (LEADER_ENCODE_STREAM, TTR.ENCODE_STREAM,
                             TTR.TRANSFORM_STREAM)}
        attack = {fold_seed(seed, i) for i in range(512)}
        sets = list(streams.values()) + [attack]
        assert sum(len(s) for s in sets) == len(set().union(*sets))


@pytest.mark.parametrize("codec", ["qsgd:bits=8", "bf16", "topk:frac=0.1"])
def test_decoded_stack_gives_the_bits_of_decoding_each_group(codec):
    """The trainer hands the decoded stack: the same bits as decoding each
    group's slice of the container."""
    tree = _tt(_np_tree(21, 11))
    c = TC.get_codec(codec)
    enc, _ = c.encode(tree, seed=4)
    a, pa, _ = hier_aggregate_tree(enc, 1, GroupConfig(g=7), codec=codec,
                                   seed=1, use_kernels=True)
    b, pb, _ = hier_aggregate_tree(enc, 1, GroupConfig(g=7), codec=codec,
                                   seed=1, use_kernels=True,
                                   decoded=c.decode(enc))
    for k in LEAVES:
        assert torch.equal(a[k], b[k])
    assert torch.equal(pa.selection_weights(), pb.selection_weights())


@pytest.mark.parametrize("n,f", [(21, 1)])
def test_coord_chunk_matches_jax_and_the_fused_apply(n, f):
    tree = _np_tree(n, 200 + n)
    (tagg, tplan, _), (jagg, jplan, _) = _both(tree, f, "multi_bulyan", {},
                                               coord_chunk=64)
    _same_hier(tplan, jplan)
    _same_agg(tagg, jagg)
    fused = hier_aggregate_tree(_tt(tree), f, GroupConfig(g=7),
                                use_kernels=True)[0]
    _same_agg(tagg, {k: v.numpy() for k, v in fused.items()}, rtol=1e-6,
              atol=1e-6)
    two = hier_aggregate_tree(_tt(tree), f, GroupConfig(g=7),
                              use_kernels=True, fused=False)[0]
    _same_agg(two, {k: v.numpy() for k, v in tagg.items()}, rtol=1e-6,
              atol=1e-6)


def test_error_feedback_leader_codec_is_refused_as_in_jax():
    tree = _np_tree(21, 0)
    jmsg = _raises(lambda: jhier(_jt(tree), 1, JGroup(g=7),
                                 codec="signsgd:ef=1"))
    tmsg = _raises(lambda: hier_aggregate_tree(_tt(tree), 1,
                                               GroupConfig(g=7),
                                               codec="signsgd:ef=1"))
    assert tmsg == jmsg and "error-feedback" in tmsg


# =========================================================== invariants
@pytest.mark.parametrize("rule", ["multi_bulyan", "multi_krum"])
@pytest.mark.parametrize("n,f", [(7, 1), (11, 2), (15, 3), (12, 2)])
def test_single_group_is_the_flat_path_bit_for_bit(rule, n, f):
    tree = _tt(_np_tree(n, 300 + n))
    flat = TAPI.aggregate_tree(tree, f, name=rule, use_kernels=True)
    agg, plan, info = hier_aggregate_tree(
        tree, f, GroupConfig(g=n, rule=rule), use_kernels=True)
    assert plan.outer is None and plan.n_groups == 1
    for k in LEAVES:
        assert torch.equal(flat[k], agg[k]), k
    assert plan.diagnostics(info["inner_stats"])[
        "group_selection"].tolist() == [1.0]
    # and on a wire container, the statistics off its payloads
    enc, _ = TC.get_codec("qsgd:bits=8").encode(tree, seed=n)
    flat = TAPI.aggregate_tree(enc, f, name=rule, use_kernels=True)
    agg = hier_aggregate_tree(enc, f, GroupConfig(g=2 * n, rule=rule),
                              use_kernels=True)[0]
    for k in LEAVES:
        assert torch.equal(flat[k], agg[k]), k


@pytest.mark.parametrize("n,f,kw", [(21, 1, {}), (49, 3, {}), (7, 1, {}),
                                    (21, 1, {"outer_rule": "median"}),
                                    (35, 7, {"f_inner": 1, "f_outer": 1,
                                             "outer_rule": "krum",
                                             "enforce_budget": False})])
def test_hier_plan_build_gives_jax_plan_fields(n, f, kw):
    """``HierPlan.build`` from a budget and the level plans (what the
    streaming trainer's global scope calls) carries JAX's n, f, g,
    bounds, per-level budgets and rules, one group (g >= n) included."""
    cfg = GroupConfig(g=7, **kw)
    tree = _np_tree(n, n)
    _, tplan, _ = hier_aggregate_tree(_tt(tree), f, cfg, use_kernels=True)
    _, jplan, _ = jhier(_jt(tree), f, JGroup(g=7, **kw))
    built = HierPlan.build(cfg.budget(n, f), cfg, tplan.inner, tplan.outer)
    _same_hier(built, jplan)
    assert built == tplan


def test_permutations_within_and_across_groups():
    """Rows permuted inside each group, or whole groups permuted (a robust
    outer level, f_outer = 1): the same aggregate."""
    n, f, g = 49, 3, 7
    tree = _tt(_np_tree(n, 1))
    cfg = GroupConfig(g=g)
    agg, plan, _ = hier_aggregate_tree(tree, f, cfg)
    assert (plan.f_inner, plan.f_outer) == (1, 1)
    rng = np.random.default_rng(0)
    within = np.concatenate([k * g + rng.permutation(g) for k in range(7)])
    across = np.concatenate([np.arange(k * g, (k + 1) * g)
                             for k in [3, 0, 6, 1, 5, 2, 4]])
    for rows in (within, across):
        perm = {k: v[torch.from_numpy(rows)] for k, v in tree.items()}
        got = hier_aggregate_tree(perm, f, cfg)[0]
        _same_agg(got, {k: v.numpy() for k, v in agg.items()}, rtol=2e-5,
                  atol=2e-6)


def test_poisoned_subtree_rejected_by_a_robust_outer_level():
    """All 7 traitors in group 0 with f_inner = 1: group 0 falls, and the
    krum outer level over the 7 groups routes no mass to it (as JAX)."""
    n, f = 49, 7
    tree = _np_tree(n, 2)
    tree = {k: np.concatenate([v[:f] + 50.0, v[f:]]) for k, v in
            tree.items()}
    kw = dict(f_inner=1, f_outer=1, outer_rule="krum",
              enforce_budget=False)
    (tagg, tplan, tinfo), (jagg, jplan, _) = _both(tree, f, "multi_bulyan",
                                                   kw)
    d = tplan.diagnostics(tinfo["inner_stats"])
    assert float(d["group_selection"][0]) == 0.0
    assert float(d["byz_mass"]) == 0.0
    _same_hier(tplan, jplan)
    _same_agg(tagg, jagg)


def test_poisoned_subtree_captured_without_a_robust_outer_level():
    n, f = 21, 7
    tree = _np_tree(n, 3)
    tree = {k: np.concatenate([v[:f] + 50.0, v[f:]]) for k, v in
            tree.items()}
    kw = dict(f_inner=1, f_outer=0, enforce_budget=False)
    (tagg, tplan, _), (jagg, jplan, _) = _both(tree, f, "multi_bulyan", kw)
    assert float(tplan.diagnostics()["byz_mass"]) == pytest.approx(
        1 / 3, abs=0.05)
    _same_hier(tplan, jplan)
    _same_agg(tagg, jagg)


def test_budget_rejection_through_the_aggregate_matches_jax():
    tree = _np_tree(21, 4)
    cfg = dict(g=7, f_inner=1, f_outer=0)
    jmsg = _raises(lambda: jhier(_jt(tree), 7, JGroup(**cfg)))
    tmsg = _raises(lambda: hier_aggregate_tree(_tt(tree), 7,
                                               GroupConfig(**cfg)))
    assert tmsg == jmsg and "does not cover contract" in tmsg


def test_grouped_robust_config_skips_the_flat_check():
    with pytest.raises(ValueError, match="requires n >= 4f"):
        RobustConfig(n_workers=21, f=5)
    assert RobustConfig(n_workers=21, f=5, grouped=True).grouped
    assert dataclasses.asdict(RobustConfig(n_workers=21, f=5,
                                           grouped=True))["grouped"] == \
        JRobust(n_workers=21, f=5, grouped=True).grouped


# ============================================================= trainers
TINY = dict(name="tiny-qwen", family="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
            qkv_bias=True, tie_embeddings=True, rope_theta=1e6)
N, F, SEQ, G = 14, 1, 16, 7
#: (attack, codec) of the trainer cases against JAX
STEP_CASES = [("none", None), ("inf", None), ("adaptive_lie", None),
              ("sign_flip", "bf16")]


@pytest.fixture(scope="module")
def setup():
    """(JAX parameters, the port's, the JAX batch, the port's batch)."""
    jparams = JMD.init_model(jax.random.key(0), JArch(**TINY))
    tparams = TMD.params_from_jax(jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    batch = make_lm_batch(jax.random.key(1), TINY["vocab_size"], N, SEQ)
    batch = {k: np.asarray(v) for k, v in batch.items()}
    jb = JTR.split_workers({k: jnp.asarray(v) for k, v in batch.items()}, N)
    tb = TTR.split_workers({k: torch.tensor(v).long()
                            for k, v in batch.items()}, N)
    return jparams, tparams, jb, tb


def _rcfg():
    return RobustConfig(n_workers=N, f=F, grouped=True)


def _port_step(make, **kw):
    opt = TO.sgd(momentum=0.9)
    return opt, make(ArchConfig(**TINY, dtype="float32"), _rcfg(), opt,
                     TS.constant(0.05), chunk_q=SEQ, telemetry=True,
                     hier=GroupConfig(g=G), **kw)


def _stream(scope):
    return functools.partial(TST.make_streaming_train_step, scope=scope)


def _assert_tree_close(tparams, jparams, rtol=1e-4, atol=1e-6):
    for (path, t), j in zip(tree_items(tparams), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol,
                                   atol=atol, err_msg="/".join(path))


@pytest.fixture(scope="module")
def jax_steps(setup):
    """{case: (params, state, metrics)} of one JAX hier step (fp32
    activations, key 2); ``("block", attack)`` for streaming block
    scope."""
    jparams, _, jb, _ = setup
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JM, "embedding_apply", functools.partial(
            JM.embedding_apply, dtype=jnp.float32))
        for attack, codec in STEP_CASES + [("block", "inf")]:
            opt = JO.sgd(momentum=0.9)
            common = dict(chunk_q=SEQ, codec=None if attack == "block"
                          else codec, telemetry=True, hier=JGroup(g=G))
            rcfg = JRobust(n_workers=N, f=F, grouped=True)
            if attack == "block":
                step = JST.make_streaming_train_step(
                    JArch(**TINY), rcfg, opt, JS.constant(0.05),
                    scope="block", attack=codec, **common)
            else:
                step = JTR.make_train_step(
                    JArch(**TINY), rcfg, opt, JS.constant(0.05),
                    attack=attack, **common)
            state = JTR.init_train_state(opt, jparams, n_workers=N,
                                         attack=attack, attack_f=F)
            out[attack, codec] = jax.tree.map(
                np.asarray, jax.jit(step)(jparams, state, jb,
                                          jax.random.key(2)))
    return out


@pytest.mark.parametrize("attack,codec", STEP_CASES)
def test_hier_train_step_matches_jax(setup, jax_steps, attack, codec):
    """One stacked ``hier`` step: losses and parameters within 1e-4, the
    selection within 1 ulp, the group mass and the byte counts exact, the
    adaptive state's update from the two-level selection."""
    _, tparams, _, tb = setup
    jp, js, jm = jax_steps[attack, codec]
    opt, step = _port_step(TTR.make_train_step, attack=attack, codec=codec)
    state = TTR.init_train_state(opt, tparams, n_workers=N, attack=attack,
                                 attack_f=F)
    tp, ts, tm = step(tparams, state, tb, 2)
    np.testing.assert_allclose(tm["loss_per_worker"].numpy(),
                               jm["loss_per_worker"], rtol=1e-4)
    jt, tt = jm["telemetry"], tm["telemetry"]
    assert sorted(tt) == sorted(jt)
    _close_ulp(tt["selection"].numpy(), jt["selection"])
    np.testing.assert_array_equal(tt["group_selection"].numpy(),
                                  jt["group_selection"])
    np.testing.assert_allclose(float(tt["byz_mass"]), float(jt["byz_mass"]),
                               rtol=1e-6, atol=1e-30)
    if attack == "inf":
        assert float(tt["byz_mass"]) == 0.0
    np.testing.assert_allclose(float(tt["honest_dev"]),
                               float(jt["honest_dev"]), rtol=1e-4)
    if codec is not None:
        assert tt["wire_bytes_per_worker"] == int(jt["wire_bytes_per_worker"])
        assert tt["leader_wire_bytes"] == int(jt["leader_wire_bytes"])
    if attack == "adaptive_lie":
        for k, v in js.astate.items():
            np.testing.assert_allclose(ts.astate[k].numpy(), v, rtol=1e-6,
                                       atol=1e-7, err_msg=k)
    if codec is None:
        _assert_tree_close(tp, jp)
        return
    # bf16 wire: gradients an ulp apart may encode a wire step apart
    jparams = setup[0]
    for (path, t), j, j0 in zip(tree_items(tp), jax.tree.leaves(jp),
                                jax.tree.leaves(jparams)):
        upd = float(np.abs(np.asarray(j) - np.asarray(j0)).max())
        _close_but_wire(t.numpy(), j, rtol=1e-4, atol=1e-6, scale=upd,
                        what="/".join(path))


def test_stream_block_hier_step_matches_jax(setup, jax_steps):
    _, tparams, _, tb = setup
    jp, _, jm = jax_steps["block", "inf"]
    opt, step = _port_step(_stream("block"), attack="inf")
    tp, _, tm = step(tparams, TTR.init_train_state(opt, tparams), tb, 2)
    np.testing.assert_allclose(tm["loss_per_worker"].numpy(),
                               jm["loss_per_worker"], rtol=1e-4)
    tt, jt = tm["telemetry"], jm["telemetry"]
    assert sorted(tt) == sorted(jt)
    # the mean over the block plans: an ulp apart, the same rows selected
    np.testing.assert_allclose(tt["selection"].numpy(), jt["selection"],
                               rtol=1e-6, atol=1e-30)
    np.testing.assert_array_equal(tt["selection"].numpy() > 0,
                                  jt["selection"] > 0)
    assert float(tt["byz_mass"]) == float(jt["byz_mass"]) == 0.0
    _assert_tree_close(tp, jp)


def _same_bits(a, b):
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.parametrize("attack,codec", [("inf", None),
                                          ("scale_poison", "qsgd:bits=8")])
def test_stream_global_hier_is_the_stacked_step_bit_for_bit(setup, attack,
                                                            codec):
    """Two steps from one state: parameters, losses, every telemetry entry
    and the byte counts the same bits (the leader hop's QSGD draws
    included)."""
    _, tparams, _, tb = setup
    runs = []
    for make in (TTR.make_train_step, _stream("global")):
        opt, step = _port_step(make, attack=attack, codec=codec)
        p, s, out = tparams, TTR.init_train_state(opt, tparams), []
        for i in range(2):
            p, s, m = step(p, s, tb, 2 + i)
            out.append((p, m))
        runs.append(out)
    for (pa, ma), (pb, mb) in zip(*runs):
        assert all(_same_bits(x, y) for x, y in zip(tree_leaves(pa),
                                                    tree_leaves(pb)))
        assert _same_bits(ma["loss_per_worker"], mb["loss_per_worker"])
        ta, tb_ = ma["telemetry"], mb["telemetry"]
        assert sorted(ta) == sorted(tb_)
        for k in ta:
            assert _same_bits(torch.as_tensor(ta[k]),
                              torch.as_tensor(tb_[k])), k
        assert float(ta["byz_mass"]) == 0.0
    if codec is not None:
        assert ma["telemetry"]["leader_wire_bytes"] == sum(
            TC.get_codec(codec).leaf_wire_bytes((2,) + tuple(p.shape))
            for p in tree_leaves(tparams))


def test_hier_refusals_carry_jax_messages():
    """A mesh, an ef=1 codec: the messages of the JAX trainers."""
    args = (JArch(**TINY), JRobust(n_workers=N, f=F, grouped=True),
            JO.sgd(), JS.constant(0.1))
    targs = (ArchConfig(**TINY), _rcfg(), TO.sgd(), TS.constant(0.1))
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    tmesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                  shape=(1, 1))
    for jmake, tmake in ((JTR.make_train_step, TTR.make_train_step),
                         (functools.partial(JST.make_streaming_train_step,
                                            scope="global"),
                          _stream("global"))):
        with pytest.raises(NotImplementedError) as je:
            jmake(*args, hier=JGroup(g=G), shard_map_mesh=jmesh)
        with pytest.raises(NotImplementedError) as te:
            tmake(*targs, hier=GroupConfig(g=G), shard_map_mesh=tmesh)
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError) as je:
        JTR.make_train_step(*args, hier=JGroup(g=G),
                            codec="topk:frac=0.1,ef=1")
    with pytest.raises(ValueError) as te:
        TTR.make_train_step(*targs, hier=GroupConfig(g=G),
                            codec="topk:frac=0.1,ef=1")
    assert str(te.value) == str(je.value)
    assert re.search("error-feedback", str(te.value))


# ============================================================= launcher
@pytest.mark.parametrize("codec", [None, "bf16"])
def test_launcher_prints_jax_hier_line(capsys, codec):
    """``--hier g=7`` at n = 14: JAX's hier line (its launcher's format on
    JAX's budget) and, under a codec, JAX's two wire lines."""
    flags = ["--device", "cpu", "--reduced", "--steps", "1", "--seq", "8",
             "--per-worker-batch", "1", "--workers", str(N), "--f", "1",
             "--hier", "g=7", "--attack", "inf"]
    if codec:
        flags += ["--codec", codec]
    _, hist = TLT.run(flags)
    out = capsys.readouterr().out
    jcfg = JGroup.from_spec("g=7", rule="multi_bulyan")
    b = jcfg.budget(N, 1)
    line = (f"[train] hier: {b.n_groups} groups {list(b.group_sizes)} "
            f"f_inner={b.f_inner} f_outer={b.f_outer} inner={jcfg.rule} "
            f"outer={jcfg.resolve_outer_rule(b)}")
    assert line in out.splitlines()
    assert hist[0]["byz_mass"] == 0.0 and len(hist[0]["group_selection"]) \
        == 2
    if codec:
        from repro.configs import get_config as jget
        jp = JMD.init_model(jax.random.key(0), jget("qwen2-1.5b").reduced())
        for ws in JTP.hier_wire_stats(codec, jp, n=N, g=7):
            assert (f"[train] wire[{ws.level}]: {ws.n} x "
                    f"{ws.bytes_per_worker:,} B/step "
                    f"({ws.compression:.1f}x vs fp32)") in out.splitlines()
        assert hist[0]["leader_wire_bytes"] == 2 * hist[0][
            "wire_bytes_per_worker"]


def test_launcher_parses_and_checks_the_hier_spec_once(monkeypatch):
    """``run`` parses ``--hier`` and checks its budget once, then hands
    that config to the trainer's builder."""
    calls = {"from_spec": 0, "budget": 0}
    from_spec, budget = GroupConfig.from_spec.__func__, GroupConfig.budget

    def counted_from_spec(cls, *a, **k):
        calls["from_spec"] += 1
        return from_spec(cls, *a, **k)

    def counted_budget(self, *a, **k):
        calls["budget"] += 1
        return budget(self, *a, **k)

    class Built(Exception):
        pass

    def make_trainer(args, cfg, rcfg, lr_fn, mesh=None, hier=None):
        raise Built(hier)

    monkeypatch.setattr(GroupConfig, "from_spec",
                        classmethod(counted_from_spec))
    monkeypatch.setattr(GroupConfig, "budget", counted_budget)
    monkeypatch.setattr(TLT, "make_trainer", make_trainer)
    with pytest.raises(Built) as got:
        TLT.run(["--device", "cpu", "--reduced", "--workers", "21", "--f",
                 "1", "--hier", "g=7,outer_rule=median"])
    assert got.value.args[0] == GroupConfig(g=7, outer_rule="median")
    assert calls == {"from_spec": 1, "budget": 1}
    assert TLT.hier_config(TLT.parse_args(["--reduced"])) == (None, None)


def test_launcher_hier_budget_fails_before_the_model(capsys):
    with pytest.raises(ValueError, match="does not cover contract"):
        TLT.run(["--device", "cpu", "--reduced", "--workers", "21", "--f",
                 "7", "--hier", "g=7,f_inner=1,f_outer=0"])
    assert "[train] arch" not in capsys.readouterr().out
