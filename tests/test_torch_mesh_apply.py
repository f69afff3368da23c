"""The port's mesh-native apply (``Aggregator.apply(plan, row_block(...),
mesh_ctx=)``, ``aggregate_tree(mesh_ctx=)``) and the mesh training step
(``make_train_step(shard_map_mesh=)``) on ``torch.distributed``.

On the CPU, gloo worlds of 1, 2 and 4 ranks (each started once, as
processes of ``tests/_torch_mesh_apply_worker.py``, all within
``tests/test_torch_mesh.py``'s SPAWN_DEADLINE) run the meshes W×M ∈
{1×1, 2×1, 1×2, 2×2, 4×1} and a (pod, data, model) = 2×2×1 mesh:

* every rule (average, median, trimmed_mean, krum, multi_krum, bulyan,
  multi_bulyan) on three-leaf trees of n ∈ {11, 13} workers, f = 2, whose
  first f rows are forged well apart from the rest, on three substrates
  (plain, the kernels' plain versions, ``fused=False``), with the plan of
  the replicated statistics, and end to end through ``aggregate_tree``:
  held to the JAX package's single-device ``Aggregator.apply`` /
  ``aggregate_tree`` at the port's fp32 tolerance (``atol=1e-5·scale,
  rtol=1e-5``), and to the port's single-device apply bit for bit at
  1×1 and within 1e-6 absolute elsewhere (the zero-padded rows and the
  column tiles change a contraction's summation order, as in JAX's
  ``tests/test_spmd.py``);
* the encoded apply of ``qsgd:bits=8``, ``bf16``, ``topk:frac=0.1`` and
  ``identity`` containers (one rule of each plan kind) against JAX's
  ``agg.apply(plan, enc)`` and the port's single-device one, alike;
* two steps of the mesh train step (the 2-layer d_model-64 model of
  ``tests/test_torch_trainer.py``, ``sign_flip`` with telemetry, and
  ``qsgd:bits=8`` with ``scale_poison``), of the stacked trainer and of
  the streaming trainer's global scope (``stream_*``: the statistics of
  each leaf of each block on the mesh, one running total, K2 on each
  block's column tiles), each against the same trainer's replicated
  step: the first step's losses equal, selections exact, parameters bit
  for bit at 1×1 and within 1e-6 elsewhere; the first ``sign_flip`` step
  also against JAX's replicated ``make_train_step``, as
  ``tests/test_torch_trainer.py`` holds the port's;
* every rank holds the same results bit for bit, and its rank in the
  model group is its model index (the order the tiles' results are
  gathered in).
"""
import functools
import pathlib
import time
import types

import numpy as np
import pytest
import torch

from repro_torch.core import api
from repro_torch.dist import trainer as TTR
from repro_torch.tree import tree_leaves
from test_torch_mesh import MESHES, SPAWN_DEADLINE, WORLDS, _map, _np, \
    _same, _spawn

torch.set_num_threads(1)

WORKER = pathlib.Path(__file__).resolve().parent / \
    "_torch_mesh_apply_worker.py"
F = 2
TREES = {"n11": 11, "n13": 13}
RULES = ("average", "median", "trimmed_mean", "krum", "multi_krum", "bulyan",
         "multi_bulyan")
WIRE_RULES = ("average", "median", "multi_krum", "multi_bulyan")
SUBSTRATES = {"plain": (False, True), "kernels": (True, True),
              "two_step": (True, False)}
WIRES = ("qsgd:bits=8", "bf16", "topk:frac=0.1", "identity")
TRAIN_CASES = ("sign_flip", "qsgd", "stream_sign_flip", "stream_qsgd")
TINY = dict(name="tiny-qwen", family="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
            qkv_bias=True, tie_embeddings=True, rope_theta=1e6)
N_TRAIN, SEQ = 11, 16
#: the port's fp32 tolerance against JAX (tests/test_torch_gar.py)
TOL = 1e-5
#: the mesh against the port's single-device apply, off 1x1
MESH_ATOL = 1e-6


def _tree(n, seed):
    """Three leaves (one 3-d, one of width 1): honest row i is
    N(0, 1) x (1 + 0.1 i); the first F rows are forged 8 above the honest
    mean in every coordinate, far from every honest row, so no selection
    sits near a tie."""
    rng = np.random.default_rng(seed)
    scale = 1.0 + 0.1 * np.arange(n, dtype=np.float32)
    out = {}
    for k, shape in (("a", (6, 9)), ("c", (77,)), ("e", (1,))):
        v = rng.normal(size=(n,) + shape).astype(np.float32)
        v = v * scale.reshape((n,) + (1,) * len(shape))
        v[:F] = v[F:].mean(axis=0) + 8.0 + 0.1 * v[:F]
        out[k] = v.astype(np.float32)
    return {"a": out["a"], "b": {"c": out["c"]}, "e": out["e"]}


def _tol_close(got, want, tol=TOL):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _mesh_close(label, got, want):
    """Bit for bit at 1x1, within MESH_ATOL elsewhere, leaf by leaf."""
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
        if label == "1x1":
            assert _same(g, w)
        else:
            np.testing.assert_allclose(_np(g), _np(w), rtol=0,
                                       atol=MESH_ATOL)


# ============================================= the JAX side and the ranks
@pytest.fixture(scope="module")
def inputs():
    """numpy trees, the JAX package's wire containers of ``n11``, and the
    tiny model's JAX-initialised parameters and batch."""
    import jax
    import jax.numpy as jnp
    from repro import models as JMD
    from repro.comm import codecs as JC
    from repro.configs.base import ArchConfig as JArch
    from repro.data.synthetic import make_lm_batch
    trees = {name: _tree(n, seed=5 + n) for name, n in TREES.items()}
    jwires = {spec: JC.get_codec(spec).encode(
        _map(jnp.asarray, trees["n11"]), key=jax.random.key(3))[0]
        for spec in WIRES}
    jparams = JMD.init_model(jax.random.key(0), JArch(**TINY))
    batch = make_lm_batch(jax.random.key(1), TINY["vocab_size"], N_TRAIN,
                          SEQ)
    return types.SimpleNamespace(
        trees=trees, jwires=jwires, jparams=jparams,
        params=jax.tree.map(np.asarray, jparams),
        batch={k: np.asarray(v) for k, v in batch.items()})


def _port_wires(inputs):
    from repro_torch.comm import codecs as TC
    return {k: TC.encoded_from_jax(v, device="cpu")
            for k, v in inputs.jwires.items()}


def _port_batch(inputs):
    return TTR.split_workers({k: torch.tensor(v).long()
                              for k, v in inputs.batch.items()}, N_TRAIN)


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """{mesh label: [each rank's results]} and {world: [each rank's
    results]}: worlds of 1, 2 and 4 ranks, one after another, within one
    deadline of SPAWN_DEADLINE seconds."""
    from repro_torch import models as TMD
    tmp = tmp_path_factory.mktemp("mesh_apply")
    wires = {k: {"payload": w.payload, "sidecar": w.sidecar, "spec": w.spec,
                 "n": w.n, "shapes": [list(s) for s in w.shapes],
                 "wire_bytes": w.wire_bytes}
             for k, w in _port_wires(inputs).items()}
    path = tmp / "inputs.pt"
    torch.save({"trees": {k: _map(torch.from_numpy, v)
                          for k, v in inputs.trees.items()},
                "wires": wires, "tiny": TINY, "seq": SEQ,
                "params": TMD.params_from_jax(inputs.params, device="cpu"),
                "batch": _port_batch(inputs)}, path)
    deadline = time.monotonic() + SPAWN_DEADLINE
    by_label, by_world = {}, {}
    for world, labels in WORLDS.items():
        results = _spawn(world, tmp, path, deadline, worker=WORKER)
        by_world[world] = results
        for label in labels:
            by_label[label] = [{k[len(label) + 1:]: v for k, v in r.items()
                                if k.startswith(label + "/")}
                               for r in results]
    return by_label, by_world


@pytest.fixture(scope="module")
def jax_applies(inputs):
    """The JAX package's single-device results: per (tree, rule) its
    ``apply`` of the replicated plan and its ``aggregate_tree``; per
    (wire, rule) its ``apply(plan, enc)``."""
    import jax.numpy as jnp
    from repro.core import api as JA
    out = {}
    for name, tree in inputs.trees.items():
        jt = _map(jnp.asarray, tree)
        stats = JA.compute_stats(jt, F)
        for rule in RULES:
            agg = JA.get_aggregator(rule)
            out[name, rule] = agg.apply(agg.plan(stats), jt)
            out[name, rule, "tree"] = JA.aggregate_tree(jt, F, rule)
    for spec, enc in inputs.jwires.items():
        stats = JA.compute_stats(enc, F)
        for rule in WIRE_RULES:
            agg = JA.get_aggregator(rule)
            out[spec, rule] = agg.apply(agg.plan(stats), enc)
    return out


@pytest.fixture(scope="module")
def port_applies(inputs):
    """The port's single-device results of the same calls, per substrate."""
    out = {}
    for name, tree in inputs.trees.items():
        tt = _map(torch.from_numpy, tree)
        stats = api.compute_stats(tt, F)
        for rule in RULES:
            agg = api.get_aggregator(rule)
            plan = agg.plan(stats)
            for sub, (k, fused) in SUBSTRATES.items():
                out[name, rule, sub] = agg.apply(plan, tt, use_kernels=k,
                                                 fused=fused)
            out[name, rule, "aggregate_tree"] = api.aggregate_tree(
                tt, F, rule, use_kernels=True)
    for spec, enc in _port_wires(inputs).items():
        stats = api.compute_stats(enc, F)
        for rule in WIRE_RULES:
            agg = api.get_aggregator(rule)
            plan = agg.plan(stats)
            for sub in ("plain", "kernels"):
                out[spec, rule, sub] = agg.apply(
                    plan, enc, use_kernels=SUBSTRATES[sub][0])
    return out


@pytest.fixture(scope="module")
def jax_step(inputs):
    """One step of JAX's replicated ``make_train_step`` (``sign_flip``,
    telemetry, key 2) with fp32 activations, as
    ``tests/test_torch_trainer.py`` runs it."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ArchConfig as JArch
    from repro.configs.base import RobustConfig as JRobust
    from repro.dist import trainer as JTR
    from repro.models import modules as JM
    from repro.optim import optimizers as JO
    from repro.optim import schedules as JS
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JM, "embedding_apply", functools.partial(
            JM.embedding_apply, dtype=jnp.float32))
        opt = JO.sgd(momentum=0.9)
        step = jax.jit(JTR.make_train_step(
            JArch(**TINY), JRobust(n_workers=N_TRAIN, f=F,
                                   gar="multi_bulyan"),
            opt, JS.constant(0.05), chunk_q=SEQ, attack="sign_flip",
            telemetry=True))
        batch = JTR.split_workers({k: jnp.asarray(v)
                                   for k, v in inputs.batch.items()},
                                  N_TRAIN)
        params, _, m = step(inputs.jparams,
                            JTR.init_train_state(opt, inputs.jparams),
                            batch, jax.random.key(2))
        return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, m)


# ===================================================== the mesh itself
@pytest.mark.parametrize("label", MESHES)
def test_model_group_order_is_the_model_index(ranks, label):
    """The tiles' results are gathered over the model group in group-rank
    order, so each rank's group rank must be its model index (a swap would
    also show at once in every comparison below at 1x2 and 2x2); the same
    for the worker group and the rows."""
    by_label, _ = ranks
    seen = set()
    for r in by_label[label]:
        ix = r["index"]
        assert ix["model_group_rank"] == ix["model_index"]
        assert ix["worker_group_rank"] == ix["worker_index"]
        seen.add((ix["worker_index"], ix["model_index"]))
    assert len(seen) == len(by_label[label])


def _flat(v):
    if isinstance(v, dict):
        return [x for k in sorted(v) for x in _flat(v[k])]
    if isinstance(v, (tuple, list)):
        return [x for e in v for x in _flat(e)]
    return [v]


@pytest.mark.parametrize("label", MESHES)
def test_every_rank_holds_the_same_result(ranks, label):
    by_label, _ = ranks
    first = by_label[label][0]
    for other in by_label[label][1:]:
        for key, val in first.items():
            if key in ("index",):
                continue
            a, b = _flat(val), _flat(other[key])
            assert len(a) == len(b), key
            for x, y in zip(a, b):
                if isinstance(x, torch.Tensor):
                    assert _same(x, y), key
                else:
                    assert x == y, key


# ====================================================== the contracts
@pytest.mark.parametrize("label", MESHES)
def test_c201_c202_proven_on_every_rank(ranks, label):
    """``analysis.op_audit``'s C201 (the apply gathers at most the
    (n_pad, d_pad/M) tile over the worker group and the (d_pad/M,) result
    over the model group) and C202 (no decode in the apply above the
    rank's (n_pad, d_pad/M) of a leaf) on every rank of every mesh."""
    by_label, _ = ranks
    for r in by_label[label]:
        for name in ("C201-apply-shard-gather", "C202-decode-invariant"):
            res = r["audits"][name]
            assert res["status"] == "proven", res
            assert res["contract"] == name and res["violations"] == []


@pytest.mark.parametrize("label", MESHES)
def test_c201_trips_on_a_full_leaf_gather(ranks, label):
    """A worker-group gather of a leaf's full rows (every column) breaks
    C201's bound wherever the model axis cuts the columns (M > 1), and
    is the tile itself at M = 1."""
    by_label, _ = ranks
    for r in by_label[label]:
        violations, gathers = r["full_leaf_gather"]
        assert gathers == 1
        if r["index"]["model_size"] > 1:
            assert violations and "exceeds the (n_pad, d_pad/M) tile" in \
                violations[0], violations
        else:
            assert violations == []


# ========================================================== the rules
@pytest.mark.parametrize("sub", list(SUBSTRATES))
@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("name", list(TREES))
@pytest.mark.parametrize("label", MESHES)
def test_mesh_apply_matches_jax_and_the_port(ranks, jax_applies,
                                             port_applies, label, name,
                                             rule, sub):
    by_label, _ = ranks
    got = by_label[label][0][f"{name}/{rule}/{sub}"]
    want = jax_applies[name, rule]
    import jax
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == tuple(w.shape)
        _tol_close(_np(g), np.asarray(w))
    _mesh_close(label, got, port_applies[name, rule, sub])


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("name", list(TREES))
@pytest.mark.parametrize("label", MESHES)
def test_mesh_aggregate_tree_matches_jax_and_the_port(
        ranks, jax_applies, port_applies, label, name, rule):
    """End to end: the mesh statistics, the plan and the mesh apply (the
    kernels' plain versions)."""
    import jax
    by_label, _ = ranks
    got = by_label[label][0][f"{name}/{rule}/aggregate_tree"]
    for g, w in zip(tree_leaves(got),
                    jax.tree.leaves(jax_applies[name, rule, "tree"])):
        _tol_close(_np(g), np.asarray(w))
    _mesh_close(label, got, port_applies[name, rule, "aggregate_tree"])


@pytest.mark.parametrize("sub", ["plain", "kernels"])
@pytest.mark.parametrize("rule", WIRE_RULES)
@pytest.mark.parametrize("spec", WIRES)
@pytest.mark.parametrize("label", MESHES)
def test_mesh_wire_apply_matches_jax_and_the_port(
        ranks, jax_applies, port_applies, label, spec, rule, sub):
    """A wire container's row block: int8 / bf16 payload tiles
    dequantised per tile, top-k and identity rows decoded first; fp32
    leaves of the original shapes."""
    import jax
    by_label, _ = ranks
    got = by_label[label][0][f"{spec}/{rule}/{sub}"]
    for g, w in zip(tree_leaves(got), jax.tree.leaves(jax_applies[spec, rule])):
        assert g.dtype == torch.float32
        assert tuple(g.shape) == tuple(w.shape)
        _tol_close(_np(g), np.asarray(w))
    _mesh_close(label, got, port_applies[spec, rule, sub])


# ========================================================== the trainer
@pytest.mark.parametrize("case", TRAIN_CASES)
@pytest.mark.parametrize("label", MESHES)
def test_mesh_train_step_matches_the_replicated_step(ranks, label, case):
    """Per step: the same selection; the first step's losses equal (the
    forward/backward is the replicated one); parameters bit for bit at
    1x1, within 1e-6 elsewhere; the second step's losses within rtol
    1e-5 (they see those parameters)."""
    by_label, by_world = ranks
    world = len(by_label[label])
    got = by_label[label][0]["train"][case]
    want = by_world[world][0]["replicated/train"][case]
    assert len(got) == len(want) == 2
    for i, ((pg, lg, lwg, sg, bg), (pw, lw, lww, sw, bw)) in enumerate(
            zip(got, want)):
        assert torch.equal(sg, sw), f"step {i}: selection"
        assert float(bg) == float(bw)
        if i == 0:
            assert _same(lg, lw) and _same(lwg, lww)
        else:
            np.testing.assert_allclose(_np(lwg), _np(lww), rtol=1e-5)
        _mesh_close(label, pg, pw)
    if case.endswith("qsgd"):
        # scale_poison's forged multipliers are rejected
        assert all(float(s[4]) == 0.0 for s in got)


@pytest.mark.parametrize("label", MESHES)
def test_mesh_train_step_matches_jax(ranks, jax_step, label):
    """The first ``sign_flip`` step on the mesh against JAX's replicated
    step, to ``tests/test_torch_trainer.py``'s fp32 tolerances."""
    _hold_to_jax(ranks, jax_step, label, "sign_flip")


@pytest.mark.parametrize("label", MESHES)
def test_mesh_streaming_step_matches_jax(ranks, jax_step, label):
    """The first ``sign_flip`` step of the streaming trainer's global
    scope on the mesh against JAX's replicated (stacked) step: global
    scope is the stacked step, so the same tolerances hold."""
    _hold_to_jax(ranks, jax_step, label, "stream_sign_flip")


def _hold_to_jax(ranks, jax_step, label, case):
    import jax
    by_label, _ = ranks
    params, loss, lpw, sel, byz = by_label[label][0]["train"][case][0]
    jp, jm = jax_step
    np.testing.assert_allclose(float(loss), float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(_np(lpw), jm["loss_per_worker"], rtol=1e-4)
    np.testing.assert_array_equal(_np(sel), jm["telemetry"]["selection"])
    np.testing.assert_allclose(float(byz), float(jm["telemetry"]["byz_mass"]),
                               rtol=1e-6)
    for t, j in zip(tree_leaves(params), jax.tree.leaves(jp)):
        np.testing.assert_allclose(_np(t), j, rtol=1e-4, atol=1e-6)


# ================================================ the API without ranks
def _fake_mesh(names=("data", "model"), shape=(1, 1)):
    return types.SimpleNamespace(mesh_dim_names=tuple(names),
                                 shape=tuple(shape))


def test_derive_mesh_ctx_turns_on_with_a_mesh():
    ctx = TTR._derive_mesh_ctx(_fake_mesh(), None, None)
    assert isinstance(ctx, api.MeshContext)
    assert ctx.worker_axes == ("data",) and ctx.model_axis == "model"
    assert TTR._derive_mesh_ctx(None, None, None) is None


def test_derive_mesh_ctx_spmd_false_keeps_the_replicated_path():
    assert TTR._derive_mesh_ctx(_fake_mesh(), ("data",), False) is None


def test_derive_mesh_ctx_axes_override_the_mesh_names():
    mesh = _fake_mesh(("pod", "data", "model"), (2, 2, 1))
    assert TTR._derive_mesh_ctx(mesh, None, None).worker_axes == \
        ("pod", "data")
    ctx = TTR._derive_mesh_ctx(mesh, ["data"], True)
    assert ctx.worker_axes == ("data",) and ctx.worker_size == 2


def test_derive_mesh_ctx_spmd_without_a_mesh_raises_as_jax():
    from repro.dist import trainer as JTR
    with pytest.raises(ValueError) as want:
        JTR._derive_mesh_ctx(None, None, True)
    with pytest.raises(ValueError) as got:
        TTR._derive_mesh_ctx(None, None, True)
    assert str(got.value) == str(want.value)


def test_mesh_apply_needs_a_row_block_of_the_plan_s_workers():
    ctx = types.SimpleNamespace(worker_size=1, worker_index=0)
    tree = _map(torch.from_numpy, _tree(11, seed=1))
    plan = api.get_aggregator("average").plan(api.compute_stats(tree, F))
    with pytest.raises(TypeError, match="RowBlock"):
        api.get_aggregator("average").apply(plan, tree, mesh_ctx=ctx)
    with pytest.raises(ValueError, match="n=11 workers"):
        api.get_aggregator("average").apply(
            plan, api.RowBlock(rows=tree, n=12), mesh_ctx=ctx)
