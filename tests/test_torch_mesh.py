"""The port's mesh-native statistics (``compute_stats(mesh_ctx=)`` on a
``torch.distributed`` ``DeviceMesh``) and the kernels they run, K6
``pairwise_stats_rect`` and K7 ``dequant_stats_rect``, with K4
``pairwise_sqdist``.

On the CPU:

* the plain versions of K6, K7 and K4 are held to the Pallas kernels in
  interpret mode on the edge grid of ``tests/test_kernels.py`` (n not a
  multiple of 8, d not a multiple of 128, d = 1), with rows of inf;
  fp32 ``atol=1e-5·scale, rtol=1e-5``;
* gloo worlds of 1, 2 and 4 ranks (each started once, as processes of
  ``tests/_torch_mesh_worker.py``, under one deadline) run the meshes
  W×M ∈ {1×1, 1×2, 2×1, 2×2, 4×1} and a (pod, data, model) = 2×2×1 mesh
  on trees (one with the ``inf`` attack, one of 13 workers) and on the
  qsgd, bf16, identity and top-k wires, with and without kernels.  Every
  rank must hold the same statistics bit for bit.  They are held to the
  JAX package's replicated ``compute_stats``, to its
  ``compute_stats(mesh_ctx=)`` on its one-device host mesh and to the
  port's replicated path: the plain block formula sums a row subset in
  another order than the whole product, so on the CPU the tolerance is
  fp32 ``rtol=1e-5`` and ``1e-5`` of the largest norm; non-finite entries
  in the same places; the multi-Bulyan and multi-Krum selections exact;
* the model-axis statistics: bit for bit the worker-axis ones at M = 1,
  within 1e-6 of the largest norm at M = 2.

Tests marked ``cuda`` hold K6 to K1's matching rows, K7 to K5's and K4
to ``finalize_dists`` of K1 bit for bit on the card, and run the
statistics of a real one-rank NCCL world; they skip elsewhere.  JAX is
imported only by the tests that use it, so on a GPU machine without JAX
they run with ``python -m pytest --noconftest -m cuda
tests/test_torch_mesh.py``.
"""
import os
import pathlib
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from repro_torch.core import api
from repro_torch.kernels import ops, ref
from repro_torch.kernels.dequant_stats import dequant_stats_rect_cuda
from repro_torch.kernels.pairwise_sqdist import (is_whole, launch_config,
                                                 pairwise_sqdist_cuda,
                                                 pairwise_stats_rect_cuda,
                                                 rect_scratch, rect_tiles,
                                                 rect_view_arg, view_row)
from repro_torch.launch.mesh import data_parallel_size, host_mesh_shape

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
WORKER = pathlib.Path(__file__).resolve().parent / "_torch_mesh_worker.py"
#: every spawned world must finish inside this many seconds, all together
SPAWN_DEADLINE = 240
WORLDS = {1: ("1x1",), 2: ("2x1", "1x2"), 4: ("2x2", "4x1", "pod2x2x1")}
MESHES = [m for ms in WORLDS.values() for m in ms]
F = 2
TREES = {"tree": (11, False), "tree_inf": (11, True), "tree13": (13, False)}
WIRES = ("qsgd:bits=8", "bf16", "identity", "topk:frac=0.1")
INPUTS = list(TREES) + list(WIRES)
TOL = 1e-5


def _tree(n, seed, attack=False):
    """A three-leaf stacked tree as numpy (one leaf 3-d, one of width 1);
    row i scaled by 1 + 0.1 i so the selections are well clear of ties;
    with ``attack`` the first F rows carry the ``inf`` attack."""
    rng = np.random.default_rng(seed)
    scale = (1.0 + 0.1 * np.arange(n, dtype=np.float32))
    tree = {"a": rng.normal(size=(n, 6, 9)).astype(np.float32),
            "b": {"c": rng.normal(size=(n, 77)).astype(np.float32)},
            "e": rng.normal(size=(n, 1)).astype(np.float32)}
    out = {}
    for k, v in (("a", tree["a"]), ("c", tree["b"]["c"]), ("e", tree["e"])):
        v = v * scale.reshape((n,) + (1,) * (v.ndim - 1))
        if attack:
            honest = v[F:].mean(axis=0)
            v[:F] = 1e30 * np.sign(honest + 1e-30)
        out[k] = v.astype(np.float32)
    return {"a": out["a"], "b": {"c": out["c"]}, "e": out["e"]}


def _map(fn, tree):
    return {k: _map(fn, v) for k, v in tree.items()} \
        if isinstance(tree, dict) else fn(tree)


def _np(t):
    return t.detach().float().cpu().numpy()


def _close(got, want, norms, tol=TOL):
    """fp32 closeness of raw or finalised distances: ``tol`` of the
    largest finite norm (a distance is sq_i + sq_j - 2 g), non-finite
    entries in the same places."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    norms = np.asarray(norms, dtype=np.float64)
    fin = np.isfinite(norms)
    scale = max(1.0, 2.0 * float(np.max(norms[fin]))) if fin.any() else 1.0
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _same(a, b):
    """Bit for bit, NaN in the same places."""
    a, b = a.detach().cpu(), b.detach().cpu()
    return a.shape == b.shape and torch.equal(torch.isnan(a), torch.isnan(b)) \
        and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


# ============================================= the JAX side and the ranks
@pytest.fixture(scope="module")
def inputs():
    """numpy trees, and the JAX package's wire containers of ``tree``."""
    import jax
    import jax.numpy as jnp
    from repro.comm import codecs as JC
    trees = {name: _tree(n, seed=n + 7 * i, attack=att)
             for i, (name, (n, att)) in enumerate(TREES.items())}
    jwires = {spec: JC.get_codec(spec).encode(
        _map(jnp.asarray, trees["tree"]), key=jax.random.key(3))[0]
        for spec in WIRES}
    return trees, jwires


@pytest.fixture(scope="module")
def jax_stats(inputs):
    """Per input: the JAX package's replicated statistics, its
    ``compute_stats(mesh_ctx=)`` on its one-device host mesh, and its
    multi-Bulyan and multi-Krum plans from the replicated distances."""
    import jax.numpy as jnp
    from repro.core import api as JA
    from repro.launch.mesh import make_host_mesh
    trees, jwires = inputs
    ctx = JA.MeshContext.for_mesh(make_host_mesh())
    out = {}
    for name in INPUTS:
        g = _map(jnp.asarray, trees[name]) if name in trees else jwires[name]
        rep = JA.compute_stats(g, F)
        mesh = JA.compute_stats(g, F, mesh_ctx=ctx)
        mb = JA.get_aggregator("multi_bulyan").plan(rep)
        mk = JA.get_aggregator("multi_krum").plan(rep)
        out[name] = types.SimpleNamespace(
            dists=np.asarray(rep.dists), norms=np.asarray(rep.sq_norms),
            mesh_dists=np.asarray(mesh.dists),
            mesh_norms=np.asarray(mesh.sq_norms),
            w_ext=np.asarray(mb.w_ext), w_agr=np.asarray(mb.w_agr),
            weights=np.asarray(mk.weights))
    return out


def _port_inputs(inputs):
    """The same inputs as the port's tensors (containers carried across)."""
    from repro_torch.comm import codecs as TC
    trees, jwires = inputs
    ttrees = {k: _map(torch.from_numpy, v) for k, v in trees.items()}
    twires = {k: TC.encoded_from_jax(v, device="cpu")
              for k, v in jwires.items()}
    return ttrees, twires


def _spawn(world, tmp, inputs_path, deadline, worker=WORKER):
    """Run the ``world`` ranks of ``worker`` as processes; returns each
    rank's saved results.  Kills them all if one fails or the deadline
    passes."""
    store = tmp / f"store{world}"
    outs = [tmp / f"out{world}_{r}.pt" for r in range(world)]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(key, None)
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(r), str(world), str(store),
         str(inputs_path), str(outs[r])], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            try:
                logs.append(p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))[0])
            except subprocess.TimeoutExpired:
                pytest.fail(f"world of {world}: a rank passed the "
                            f"{SPAWN_DEADLINE}s deadline")
            if p.returncode != 0:
                pytest.fail(f"world of {world}: a rank exited with "
                            f"{p.returncode}:\n{logs[-1][-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [torch.load(o, weights_only=True) for o in outs]


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """{mesh label: [each rank's results]}: worlds of 1, 2 and 4 ranks,
    one after another (at most 4 processes at a time), within one
    deadline of SPAWN_DEADLINE seconds."""
    tmp = tmp_path_factory.mktemp("mesh")
    ttrees, twires = _port_inputs(inputs)
    wires = {k: {"payload": w.payload, "sidecar": w.sidecar, "spec": w.spec,
                 "n": w.n, "shapes": [list(s) for s in w.shapes],
                 "wire_bytes": w.wire_bytes} for k, w in twires.items()}
    path = tmp / "inputs.pt"
    torch.save({"trees": ttrees, "wires": wires}, path)
    deadline = time.monotonic() + SPAWN_DEADLINE
    out = {}
    for world, labels in WORLDS.items():
        results = _spawn(world, tmp, path, deadline)
        for label in labels:
            out[label] = [{k[len(label) + 1:]: v for k, v in r.items()
                           if k.startswith(label + "/")} for r in results]
    return out


@pytest.fixture(scope="module")
def port_replicated(inputs):
    """The port's replicated statistics of every input, plain and with
    the kernels' plain versions."""
    ttrees, twires = _port_inputs(inputs)
    out = {}
    for name in INPUTS:
        g = ttrees[name] if name in ttrees else twires[name]
        for k in (0, 1):
            out[name, k] = api.compute_stats(g, F, use_kernels=bool(k))
    return out


# ===================================================== the mesh itself
@pytest.mark.parametrize("label", MESHES)
def test_mesh_shape_and_pod_major_worker_index(ranks, label):
    """Each rank's flat worker index is pod-major over its coordinate and
    equals its rank in the worker group (the all-gather order)."""
    world = len(ranks[label])
    names, shape = ranks[label][0]["shape"]
    assert int(np.prod(shape)) == world
    if label in ("1x1", "1x2", "2x2"):         # make_host_mesh's own
        assert names == ["data", "model"]
        assert tuple(shape) == host_mesh_shape(world)
    sizes = dict(zip(names, shape))
    workers = sorted(r["index"]["worker_index"] for r in ranks[label])
    W = sizes["data"] * sizes.get("pod", 1)
    assert workers == sorted(list(range(W)) * sizes["model"])
    for r in ranks[label]:
        ix = r["index"]
        coord = dict(zip(names, ix["coordinate"]))
        want = coord["data"] + sizes["data"] * coord.get("pod", 0)
        assert ix["worker_index"] == want == ix["worker_group_rank"]
        assert ix["worker_size"] == ix["data_parallel_size"] == W
        assert ix["model_size"] == sizes["model"]
        assert ix["model_index"] == coord["model"]
        assert ix["worker_axes"] == (["pod", "data"] if "pod" in names
                                     else ["data"])


@pytest.mark.parametrize("label", MESHES)
def test_every_rank_holds_the_same_statistics(ranks, label):
    first = ranks[label][0]
    for other in ranks[label][1:]:
        for key, val in first.items():
            if key in ("index",):
                continue
            got = other[key]
            flat_a = val if isinstance(val, (tuple, list)) else (val,)
            flat_b = got if isinstance(got, (tuple, list)) else (got,)
            for a, b in zip(flat_a, flat_b):
                if isinstance(a, tuple):
                    assert all(_same(x, y) for x, y in zip(a, b)), key
                elif isinstance(a, torch.Tensor):
                    assert _same(a, b), key


@pytest.mark.parametrize("k", [0, 1])
@pytest.mark.parametrize("name", INPUTS)
@pytest.mark.parametrize("label", MESHES)
def test_mesh_stats_match_jax(ranks, jax_stats, label, name, k):
    """Against the JAX package's replicated statistics and its own mesh
    path on its one-device mesh; finalised dists are the raw ones
    finalised."""
    dists, norms, raw = ranks[label][0][f"{name}/k{k}"]
    js = jax_stats[name]
    n = js.norms.shape[0]
    assert dists.shape == (n, n) and norms.shape == (n,)
    assert dists.dtype == norms.dtype == torch.float32
    for want_d, want_s in ((js.dists, js.norms),
                           (js.mesh_dists, js.mesh_norms)):
        _close(_np(dists), want_d, want_s)
        _close(_np(norms), want_s, want_s)
    assert _same(dists, api.finalize_dists(raw))


@pytest.mark.parametrize("k", [0, 1])
@pytest.mark.parametrize("name", INPUTS)
@pytest.mark.parametrize("label", MESHES)
def test_mesh_stats_match_port_replicated(ranks, port_replicated, label,
                                          name, k):
    dists, norms, _ = ranks[label][0][f"{name}/k{k}"]
    rep = port_replicated[name, k]
    _close(_np(dists), _np(rep.dists), _np(rep.sq_norms))
    _close(_np(norms), _np(rep.sq_norms), _np(rep.sq_norms))


@pytest.mark.parametrize("name", INPUTS)
@pytest.mark.parametrize("label", MESHES)
def test_mesh_selection_is_exact(ranks, jax_stats, label, name):
    """Both paths of the mesh statistics give JAX's multi-Bulyan and
    multi-Krum selections exactly."""
    js = jax_stats[name]
    n = js.norms.shape[0]
    for k in (0, 1):
        dists = ranks[label][0][f"{name}/k{k}"][0]
        stats = api.AggStats(n=n, f=F, dists=dists)
        mb = api.get_aggregator("multi_bulyan").plan(stats)
        mk = api.get_aggregator("multi_krum").plan(stats)
        np.testing.assert_array_equal(_np(mb.w_ext), js.w_ext)
        np.testing.assert_array_equal(_np(mb.w_agr), js.w_agr)
        np.testing.assert_array_equal(_np(mk.weights), js.weights)


@pytest.mark.parametrize("name", INPUTS)
@pytest.mark.parametrize("label", MESHES)
def test_mesh_norms_alone(ranks, jax_stats, label, name):
    """``needs_dists=False, needs_norms=True``: a tree's gathered row sums,
    a wire's sharded pass; the norms of the distance pass either way."""
    norms = ranks[label][0][f"{name}/norms"]
    _close(_np(norms), jax_stats[name].norms, jax_stats[name].norms)
    _close(_np(norms), _np(ranks[label][0][f"{name}/k0"][1]),
           jax_stats[name].norms)


@pytest.mark.parametrize("k", [0, 1])
@pytest.mark.parametrize("name", list(TREES))
@pytest.mark.parametrize("label", MESHES)
def test_model_axis_stats(ranks, jax_stats, label, name, k):
    """Bit for bit the worker-axis statistics at M = 1; within 1e-6 of
    the largest norm at M = 2 (the model-axis sum is another order)."""
    (ma_d, ma_s), (wa_d, wa_s) = ranks[label][0][f"{name}/model_axis/k{k}"]
    M = dict(zip(*ranks[label][0]["shape"]))["model"]
    if M == 1:
        assert _same(ma_d, wa_d) and _same(ma_s, wa_s)
    else:
        _close(_np(ma_d), _np(wa_d), _np(wa_s), tol=1e-6)
        _close(_np(ma_s), _np(wa_s), _np(wa_s), tol=1e-6)
    _close(_np(api.finalize_dists(ma_d)), jax_stats[name].dists,
           jax_stats[name].norms)


# ================================================ the API without ranks
def _fake_mesh(names, shape):
    return types.SimpleNamespace(mesh_dim_names=tuple(names),
                                 shape=tuple(shape))


@pytest.mark.parametrize("names,shape,workers,model", [
    (("data", "model"), (2, 4), ("data",), "model"),
    (("pod", "data", "model"), (2, 2, 2), ("pod", "data"), "model"),
    (("data",), (4,), ("data",), None)])
def test_for_mesh_derivation(names, shape, workers, model):
    ctx = api.MeshContext.for_mesh(_fake_mesh(names, shape))
    assert ctx.worker_axes == workers and ctx.model_axis == model
    sizes = dict(zip(names, shape))
    assert ctx.worker_size == int(np.prod([sizes[a] for a in workers]))
    assert ctx.model_size == (sizes[model] if model else 1)
    assert data_parallel_size(types.SimpleNamespace(
        mesh_dim_names=names, shape=shape)) == ctx.worker_size


def test_for_mesh_error_text_is_jax_s():
    from repro.core import api as JA
    from repro.launch.mesh import make_host_mesh
    with pytest.raises(ValueError) as want:
        JA.MeshContext.for_mesh(make_host_mesh(), worker_axes=("pod",))
    with pytest.raises(ValueError) as got:
        api.MeshContext.for_mesh(_fake_mesh(("data", "model"), (1, 1)),
                                 worker_axes=("pod",))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("world,want", [(1, (1, 1)), (2, (1, 2)),
                                        (4, (2, 2)), (6, (2, 3)),
                                        (8, (2, 4)), (16, (4, 4))])
def test_host_mesh_shape_factors_as_jax(world, want):
    assert host_mesh_shape(world) == want


@pytest.mark.parametrize("W,idx", [(1, 0), (4, 0), (4, 3), (8, 6)])
def test_row_block_cuts_and_pads(W, idx):
    """Rows [idx n_loc, (idx + 1) n_loc) of the stack, zero rows past n,
    a container's payload and sidecar alike with its bytes re-derived."""
    from repro_torch.comm import codecs as TC
    ctx = types.SimpleNamespace(worker_size=W, worker_index=idx)
    tree = _map(torch.from_numpy, _tree(11, seed=1))
    n_loc = -(-11 // W)
    block = api.row_block(tree, ctx)
    assert block.n == 11
    for full, part in zip(api.tree_leaves(tree), api.tree_leaves(block.rows)):
        want = torch.zeros((n_loc,) + tuple(full.shape[1:]))
        rows = full[idx * n_loc:(idx + 1) * n_loc]
        want[:rows.shape[0]] = rows
        assert torch.equal(part, want)
    enc, _ = TC.get_codec("qsgd:bits=8").encode(tree, seed=0)
    eb = api.row_block(enc, ctx)
    assert eb.n == 11 and eb.rows.n == n_loc
    assert eb.rows.shapes == tuple((n_loc,) + s[1:] for s in enc.shapes)
    codec = TC.get_codec(enc.spec)
    assert eb.rows.wire_bytes == sum(codec.leaf_wire_bytes(s)
                                     for s in eb.rows.shapes)
    dec = codec.decode(eb.rows)
    for full, part in zip(api.tree_leaves(codec.decode(enc)),
                          api.tree_leaves(dec)):
        rows = full[idx * n_loc:(idx + 1) * n_loc]
        assert torch.equal(part[:rows.shape[0]], rows)
        assert not bool(part[rows.shape[0]:].any())


def test_column_tile_pads_to_the_model_axis():
    ctx = types.SimpleNamespace(model_size=3, model_index=2)
    x = torch.arange(2 * 7, dtype=torch.float32).reshape(2, 7)
    tile = api.column_tile(api.RowBlock(rows={"x": x}, n=2), ctx).rows["x"]
    assert torch.equal(tile, torch.tensor([[6.0, 0.0, 0.0],
                                           [13.0, 0.0, 0.0]]))


def test_mesh_stats_need_a_row_block():
    ctx = types.SimpleNamespace(worker_size=1, worker_index=0)
    tree = _map(torch.from_numpy, _tree(11, seed=2))
    with pytest.raises(TypeError, match="RowBlock"):
        api.compute_stats(tree, F, mesh_ctx=ctx)


# ============================== plain versions against the Pallas kernels
EDGE = [(3, 1), (11, 100), (13, 257), (17, 2000)]


def _x(n, d, seed, inf_rows=(), nan_rows=()):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[: max(1, n // 5)] *= 20.0
    for r in inf_rows:
        x[r, ::3] = np.inf
    for r in nan_rows:
        x[r, d // 2] = np.nan
    return x


def _blocks(n, W):
    n_loc = -(-n // W)
    return n_loc, [(w * n_loc, (w + 1) * n_loc) for w in range(W)]


@pytest.fixture(scope="module")
def jk():
    import jax.numpy as jnp
    from repro.kernels.dequant_stats import dequant_stats_rect_pallas
    from repro.kernels.pairwise_sqdist import (pairwise_sqdist_pallas,
                                               pairwise_stats_rect_pallas)
    return types.SimpleNamespace(jnp=jnp, rect=pairwise_stats_rect_pallas,
                                 dq_rect=dequant_stats_rect_pallas,
                                 sqdist=pairwise_sqdist_pallas)


@pytest.mark.parametrize("inf", [False, True])
@pytest.mark.parametrize("W", [1, 4])
@pytest.mark.parametrize("n,d", EDGE)
def test_rect_plain_matches_pallas(jk, n, d, W, inf):
    """K6's plain version on the last block of a W-rank mesh (padding rows
    included) against ``pairwise_stats_rect_pallas``."""
    x = _x(n, d, seed=n * d + W, inf_rows=(1,) if inf else ())
    n_loc, blocks = _blocks(n, W)
    full = np.zeros((n_loc * W, d), np.float32)
    full[:n] = x
    a, b = blocks[-1]
    want_d, want_s = jk.rect(jk.jnp.asarray(full[a:b]),
                             jk.jnp.asarray(full), d_tile=128,
                             interpret=True)
    got_d, got_s = ref.pairwise_stats_rect_ref(torch.from_numpy(full[a:b]),
                                               torch.from_numpy(full))
    assert got_d.shape == (n_loc, n_loc * W) and got_s.shape == (n_loc * W,)
    _close(_np(got_d), np.asarray(want_d), np.asarray(want_s))
    _close(_np(got_s), np.asarray(want_s), np.asarray(want_s))


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("W", [1, 4])
@pytest.mark.parametrize("n,d", EDGE)
def test_dequant_rect_plain_matches_pallas(jk, n, d, W, dtype):
    """K7's plain version against ``dequant_stats_rect_pallas``; row 0's
    multiplier is negative, as a ``scale_poison`` row sends it."""
    rng = np.random.default_rng(n + d + W)
    n_loc, blocks = _blocks(n, W)
    if dtype == "int8":
        p = rng.integers(-127, 128, size=(n, d)).astype(np.int8)
        jp = jk.jnp.asarray(p)
        tp = torch.from_numpy(p)
    else:
        x = _x(n, d, seed=n + d)
        jp = jk.jnp.asarray(x).astype(jk.jnp.bfloat16)
        tp = torch.from_numpy(x).to(torch.bfloat16)
    m = np.zeros(n_loc * W, np.float32)       # padding rows: zero mult
    m[:n] = (rng.random(n) + 0.5) / 127.0
    m[0] = -100.0 * m[0]
    jp = jk.jnp.pad(jp, ((0, n_loc * W - n), (0, 0)))
    tp = torch.cat([tp, tp.new_zeros((n_loc * W - n, d))])
    a, b = blocks[-1]
    want_d, want_s = jk.dq_rect(jp[a:b], jk.jnp.asarray(m[a:b]), jp,
                                jk.jnp.asarray(m), d_tile=128,
                                interpret=True)
    tm = torch.from_numpy(m)
    got_d, got_s = ref.dequant_stats_rect_ref(tp[a:b], tm[a:b], tp, tm)
    _close(_np(got_d), np.asarray(want_d), np.asarray(want_s))
    _close(_np(got_s), np.asarray(want_s), np.asarray(want_s))


def test_dequant_rect_rejects_mixed_payloads_as_jax(jk):
    p8 = np.zeros((6, 40), np.int8)
    m = np.ones(6, np.float32)
    with pytest.raises(ValueError) as want:
        jk.dq_rect(jk.jnp.asarray(p8[:3]), jk.jnp.asarray(m[:3]),
                   jk.jnp.asarray(p8).astype(jk.jnp.bfloat16),
                   jk.jnp.asarray(m), interpret=True)
    t8, tm = torch.from_numpy(p8), torch.from_numpy(m)
    for fn in (ops.dequant_stats_rect, ref.dequant_stats_rect_ref):
        with pytest.raises(ValueError) as got:
            fn(t8[:3], tm[:3], t8.to(torch.bfloat16), tm)
        assert str(got.value).split(":")[0] == str(want.value).split(":")[0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("inf", [False, True])
@pytest.mark.parametrize("n,d", EDGE)
def test_sqdist_plain_matches_pallas(jk, n, d, inf, dtype):
    """K4's plain version against ``pairwise_sqdist_pallas``: clamped at
    0, the diagonal x * 0 (NaN on a row of inf, as in the reference)."""
    x = _x(n, d, seed=n + 3 * d, inf_rows=(n - 1,) if inf else ())
    jx = jk.jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(jk.sqdist(jx, d_tile=128, interpret=True))
    got = ref.pairwise_sqdist_ref(tx)
    norms = np.sum(np.asarray(jx.astype("float32"), np.float64) ** 2, axis=1)
    _close(_np(got), want, norms)
    assert bool((got[torch.isfinite(got)] >= 0).all())
    diag = torch.diagonal(got)
    assert bool((diag[torch.isfinite(diag)] == 0).all())
    if inf:
        assert bool(torch.isnan(diag[n - 1]))


def test_sqdist_plain_is_finalized_k1_plain():
    x = torch.from_numpy(_x(11, 300, seed=5, inf_rows=(2,)))
    assert _same(ref.pairwise_sqdist_ref(x),
                 api.finalize_dists(ref.pairwise_stats_ref(x)[0]))


def test_rect_plain_rows_equal_square_plain_rows():
    """Held here to the square plain version's rows: the plain versions
    sum in float64 and round once, so a row subset changes nothing."""
    x = torch.from_numpy(_x(13, 500, seed=8))
    sq_d, sq_s = ref.pairwise_stats_ref(x)
    for a, b in _blocks(13, 4)[1]:
        d, s = ref.pairwise_stats_rect_ref(x[a:b], x)
        _close(_np(d), _np(sq_d[a:b]), _np(sq_s), tol=1e-6)
        _close(_np(s), _np(sq_s), _np(sq_s), tol=1e-6)


def test_ops_rect_and_sqdist_take_plain_versions_on_cpu():
    ops.reset_launch_counts()
    x = torch.from_numpy(_x(11, 100, seed=2))
    p = torch.from_numpy(np.arange(11 * 100, dtype=np.int64).reshape(11, 100)
                         % 255 - 127).to(torch.int8)
    m = torch.ones(11)
    for a, b in zip(ops.pairwise_stats_rect(x[3:6], x, n=11),
                    ref.pairwise_stats_rect_ref(x[3:6], x)):
        assert torch.equal(a, b)
    for a, b in zip(ops.dequant_stats_rect(p[3:6], m[3:6], p, m),
                    ref.dequant_stats_rect_ref(p[3:6], m[3:6], p, m)):
        assert torch.equal(a, b)
    assert torch.equal(ops.pairwise_sqdist(x), ref.pairwise_sqdist_ref(x))
    assert set(ops.launch_counts().values()) == {0}


def test_rect_wrappers_refuse_cpu_tensors_and_bad_shapes():
    """The kernel wrappers launch or raise; they never compute on the CPU."""
    x = torch.zeros((11, 64))
    p = torch.zeros((11, 64), dtype=torch.int8)
    m = torch.ones(11)
    with pytest.raises(ValueError, match="CUDA"):
        pairwise_stats_rect_cuda(x[:3], x)
    with pytest.raises(ValueError, match="CUDA"):
        dequant_stats_rect_cuda(p[:3], m[:3], p, m)
    with pytest.raises(ValueError, match="CUDA"):
        pairwise_sqdist_cuda(x)
    with pytest.raises(ValueError, match="lane axes differ"):
        ops.pairwise_stats_rect(x[:3, :10], x)
    with pytest.raises(ValueError, match="must lie in"):
        ops.pairwise_stats_rect(x[:3], x, n=12)
    with pytest.raises(ValueError, match="mult must be"):
        ops.dequant_stats_rect(p[:3], m, p, m)


@pytest.mark.parametrize("n_loc,n_full,want", [
    (3, 12, (4, 12)), (11, 11, (8, 12)), (6, 12, (8, 12)), (1, 16, (4, 16)),
    (5, 37, (8, 8)), (2, 8, (4, 8))])
def test_rect_tiles(n_loc, n_full, want):
    assert rect_tiles(n_loc, n_full) == want


@pytest.mark.parametrize("square", [False, True])
def test_rect_scratch_is_the_block_and_no_more(square):
    """K1's chunk count for the true n; a (chunks, n_loc, n_full) cross
    scratch; the self-product scratch only on the rectangular grid (the
    symmetric grid keeps the self products on the gram's diagonal)."""
    d = 5000
    full = torch.zeros((11 if square else 12, d))
    blk = full if square else full[3:6]
    row_tile, want_chunks = launch_config(11, d)
    chunks, tiles, scratch, (dists, norms) = rect_scratch(blk, full, 11,
                                                          square)
    n_loc, n_full = blk.shape[0], full.shape[0]
    assert chunks == want_chunks
    assert tiles == rect_tiles(n_loc, n_full) + (row_tile if square else 0,)
    assert scratch[0].shape == (chunks, n_loc, n_full)
    if square:
        assert scratch[1:] == (None, None)
    else:
        assert [t.shape for t in scratch[1:]] == [(chunks, n_loc),
                                                  (chunks, n_full)]
    assert dists.shape == (n_loc, n_full) and norms.shape == (n_full,)
    # the C entry's view_row: the block's row offset on the rectangular
    # grid (it is rows 3..6 of a 12-row stack), -1 on the symmetric grid
    assert rect_view_arg(blk, full, tiles) == (-1 if square else 3)
    assert rect_view_arg(blk.clone(), full, tiles) == -1


@pytest.mark.parametrize("n_full,rows,want", [
    (12, (3, 6), 3), (12, (0, 12), 0), (16, (12, 16), 12), (9, (6, 9), 6),
    (17, (0, 5), -1), (24, (6, 12), -1)])
def test_rect_view_arg_takes_the_view_path_within_one_full_tile(n_full, rows,
                                                                want):
    """K6's view path runs for a block that is rows of a stack of at most
    16 rows (one full tile), whatever the block's offset or size; a larger
    stack (8-row full tiles) keeps the rectangular grid's pairs."""
    full = torch.zeros((n_full, 300))
    blk = full[rows[0]:rows[1]]
    n = n_full - 1          # a padding row: never the symmetric grid
    tiles = rect_scratch(blk, full, n, False)[1]
    assert rect_view_arg(blk, full, tiles) == want


@pytest.mark.parametrize("case,want", [
    ("rank 0", 0), ("rank 1", 3), ("rank 2", 6), ("rank 3", 9),
    ("the stack", 0), ("copy", None), ("column slice", None),
    ("starts before the stack", None), ("rows past the end", None),
    ("non-contiguous", None), ("between rows", None), ("int32 view", None)])
def test_view_row_finds_the_block_in_the_stack(case, want):
    """``view_row`` gives r0 only for rows [r0, r0 + n_loc) of the stack's
    own memory: each rank's block of a 12-row padded stack (that lies
    inside a larger buffer) and the stack itself; never a copy, a column
    slice, memory before or after the stack, a strided block, a start
    between two rows or another dtype over the same bytes."""
    big = torch.zeros((20, 64))
    full = big[4:16]
    part = {"rank 0": lambda: full[0:3], "rank 1": lambda: full[3:6],
            "rank 2": lambda: full[6:9], "rank 3": lambda: full[9:12],
            "the stack": lambda: full, "copy": lambda: full[3:6].clone(),
            "column slice": lambda: full[3:6, :32],
            "starts before the stack": lambda: big[2:5],
            "rows past the end": lambda: big[14:17],
            "non-contiguous": lambda: full[0:6:2],
            "between rows": lambda: big.view(-1)[4 * 64 + 7:
                                                  7 * 64 + 7].view(3, 64),
            "int32 view": lambda: full.view(torch.int32)[3:6]}[case]()
    assert view_row(part, full) == want


@pytest.mark.parametrize("case,want", [
    ("itself", True), ("full view", True), ("copy", False),
    ("row subset", False), ("padded", False)])
def test_is_whole_means_the_same_memory_without_padding(case, want):
    """The symmetric grid runs only on the stack itself: a copy of it, a
    row subset or a stack with padding rows takes the rectangular grid."""
    x = torch.zeros((12, 64))
    part, n = {"itself": (x, 12), "full view": (x[:], 12),
               "copy": (x.clone(), 12), "row subset": (x[:11], 12),
               "padded": (x, 11)}[case]
    assert is_whole(part, x, n) is want


def test_reset_clears_square_launch_counts():
    pairwise_stats_rect_cuda.square_launches = 3
    dequant_stats_rect_cuda.square_launches = 2
    pairwise_stats_rect_cuda.view_launches = 4
    assert ops.square_launch_counts() == {"pairwise_stats_rect": 3,
                                          "dequant_stats_rect": 2}
    assert ops.view_launch_counts() == {"pairwise_stats_rect": 4}
    ops.reset_launch_counts()
    assert ops.square_launch_counts() == {"pairwise_stats_rect": 0,
                                          "dequant_stats_rect": 0}
    assert ops.view_launch_counts() == {"pairwise_stats_rect": 0}


# ======================================================== on the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernels run only there")
    return torch.device("cuda")


def _padded(x, W):
    n_loc, blocks = _blocks(x.shape[0], W)
    full = torch.zeros((n_loc * W,) + tuple(x.shape[1:]), dtype=x.dtype,
                       device=x.device)
    full[:x.shape[0]] = x
    return full, blocks


def _k6_launch(blk, full, n):
    """K6 on one block: ((raw block, norms), symmetric-grid launches,
    view-path launches) of that launch."""
    sq, vw = (pairwise_stats_rect_cuda.square_launches,
              pairwise_stats_rect_cuda.view_launches)
    out = pairwise_stats_rect_cuda(blk, full, n=n)
    return (out, pairwise_stats_rect_cuda.square_launches - sq,
            pairwise_stats_rect_cuda.view_launches - vw)


@pytest.mark.cuda
@pytest.mark.parametrize("inf", [False, True])
@pytest.mark.parametrize("d", [1, 255, 257, 4095, 100_003])
@pytest.mark.parametrize("W", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("n", [7, 11, 12, 13, 15, 16, 23, 37])
def test_k6_rows_equal_k1_rows_on_card(card, n, W, d, inf):
    """Every rank's block of K6 (a view of the padded stack, K1's chunk
    count for the true n; at W = 1 the stack itself, on K1's symmetric
    grid) and a copy of it (the rectangular grid, no view path) is K1's
    matching rows bit for bit, NaN and inf in the same places, and within
    1e-5 of its plain version.  The view and the copy give the same bits
    on the whole (n_loc, n_pad) block and norms, padding columns included.
    The grid and path that ran are the ones the block's memory selects:
    the view path for every block of a W > 1 mesh whose padded stack fits
    one full tile (at most 16 rows), never for a copy."""
    from repro_torch.kernels.pairwise_sqdist import pairwise_stats_cuda
    x = torch.from_numpy(_x(n, d, seed=n * W + d,
                            inf_rows=(0,) if inf else (),
                            nan_rows=(n - 1,) if inf else ())).to(card)
    k1_d, k1_s = pairwise_stats_cuda(x)
    full, blocks = _padded(x, W)
    for a, b in blocks:
        (got_d, got_s), square, view = _k6_launch(full[a:b], full, n)
        (copy_d, copy_s), c_square, c_view = _k6_launch(full[a:b].clone(),
                                                        full, n)
        want_d, want_s = ref.pairwise_stats_rect_ref(full[a:b], full)
        torch.cuda.synchronize()
        assert (square, view) == (W == 1, W > 1 and full.shape[0] <= 16)
        assert (c_square, c_view) == (0, 0)
        assert _same(got_d, copy_d) and _same(got_s, copy_s)
        rows = min(b, n) - a
        if rows > 0:
            assert _same(got_d[:rows, :n], k1_d[a:a + rows])
        assert _same(got_s[:n], k1_s)
        _close(_np(got_d[:rows, :n]), _np(want_d[:rows, :n]), _np(want_s))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [(0, 16), (0, 12), (2, 14), (4, 16), (9, 16)])
@pytest.mark.parametrize("d", [1, 4095, 100_003])
def test_k6_view_past_one_local_tile_on_card(card, d, rows):
    """Blocks of more than one local tile (n_loc > 8) of a 16-row stack with
    a padding row (n = 15): the view path's second local tile reads its
    rows from slots 8.. of the full tile.  Each equals its copy and K1's
    rows bit for bit."""
    from repro_torch.kernels.pairwise_sqdist import pairwise_stats_cuda
    n = 15
    x = torch.from_numpy(_x(n, d, seed=d + rows[0], inf_rows=(3,),
                            nan_rows=(11,))).to(card)
    k1_d, k1_s = pairwise_stats_cuda(x)
    full, _ = _padded(x, 16)
    a, b = rows
    (got_d, got_s), square, view = _k6_launch(full[a:b], full, n)
    (copy_d, copy_s), _, c_view = _k6_launch(full[a:b].clone(), full, n)
    torch.cuda.synchronize()
    assert (square, view, c_view) == (0, 1, 0)
    assert _same(got_d, copy_d) and _same(got_s, copy_s)
    assert _same(got_d[:min(b, n) - a, :n], k1_d[a:min(b, n)])
    assert _same(got_s[:n], k1_s)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 4095, 100_003, 4096, 100_004, 1 << 20])
@pytest.mark.parametrize("W", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [11, 13, 37])
def test_k7_rows_equal_k5_rows_on_card(card, n, W, d, dtype):
    """Every rank's block of K7 is K5's matching rows bit for bit (a
    negative multiplier included), and K6's on the decoded rows.  A block
    is a view at offset a * d of the padded payload: at a d that is a
    multiple of 4 its rows start on 4-byte words (the packed loads), at
    an odd d they do not (the per-element loads)."""
    from repro_torch.kernels.dequant_stats import dequant_stats_cuda
    rng = np.random.default_rng(n * W + d)
    if dtype == torch.int8:
        p = torch.from_numpy(rng.integers(-127, 128, size=(n, d))
                             .astype(np.int8)).to(card)
    else:
        p = torch.from_numpy(_x(n, d, seed=n + d)).to(dtype).to(card)
    m = torch.from_numpy(((rng.random(n) + 0.5) / 127.0)
                         .astype(np.float32)).to(card)
    m[0] = -100.0 * m[0]
    k5_d, k5_s = dequant_stats_cuda(p, m)
    pf, blocks = _padded(p, W)
    mf, _ = _padded(m, W)
    g = (pf.float() * mf[:, None]).contiguous()
    views = [(a, b, pf[a:b], mf[a:b], g[a:b]) for a, b in blocks]
    if W == 1:          # a copy of the whole payload: the rectangular grid
        views.append((0, n, pf.clone(), mf.clone(), g.clone()))
    for a, b, pb, mb, gb in views:
        got_d, got_s = dequant_stats_rect_cuda(pb, mb, pf, mf, n=n)
        k6_d, k6_s = pairwise_stats_rect_cuda(gb, g, n=n)
        torch.cuda.synchronize()
        rows = min(b, n) - a
        if rows > 0:
            assert _same(got_d[:rows, :n], k5_d[a:a + rows])
        assert _same(got_s[:n], k5_s)
        assert _same(got_d, k6_d) and _same(got_s, k6_s)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("W", [1, 4])
def test_k7_unaligned_base_equals_k5_rows_on_card(card, W, dtype):
    """The padded payload one element into a larger buffer (no block's rows
    start on 4-byte words; at W = 1 the block is the payload itself, on
    K5's symmetric grid): every block is still K5's rows bit for bit."""
    from repro_torch.kernels.dequant_stats import dequant_stats_cuda
    n, d = 11, 4096
    rng = np.random.default_rng(W + d)
    if dtype == torch.int8:
        p = torch.from_numpy(rng.integers(-127, 128, size=(n, d))
                             .astype(np.int8)).to(card)
    else:
        p = torch.from_numpy(_x(n, d, seed=n + d)).to(dtype).to(card)
    m = torch.from_numpy(((rng.random(n) + 0.5) / 127.0)
                         .astype(np.float32)).to(card)
    m[0] = -100.0 * m[0]
    k5_d, k5_s = dequant_stats_cuda(p, m)
    pf, blocks = _padded(p, W)
    mf, _ = _padded(m, W)
    buf = torch.zeros(pf.numel() + 1, dtype=dtype, device=card)
    buf[1:] = pf.reshape(-1)
    pf = buf[1:].view(pf.shape)
    assert pf.data_ptr() % 4 != 0
    for a, b in blocks:
        got_d, got_s = dequant_stats_rect_cuda(pf[a:b], mf[a:b], pf, mf, n=n)
        torch.cuda.synchronize()
        rows = min(b, n) - a
        assert _same(got_d[:rows, :n], k5_d[a:a + rows])
        assert _same(got_s[:n], k5_s)


@pytest.mark.cuda
def test_k7_rejects_mixed_payload_types_on_card(card):
    p = torch.zeros((6, 64), dtype=torch.int8, device=card)
    m = torch.ones(6, device=card)
    with pytest.raises(ValueError, match="payload dtypes differ"):
        dequant_stats_rect_cuda(p[:3], m[:3], p.to(torch.bfloat16), m)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("inf", [False, True])
@pytest.mark.parametrize("d", [1, 4095, 100_003])
@pytest.mark.parametrize("n", [3, 11, 17, 37])
def test_k4_equals_finalized_k1_on_card(card, n, d, inf, dtype):
    """K4 is ``finalize_dists`` of K1's raw output bit for bit (on
    ``x.float()`` for bf16): NaN kept by the clamp, an inf diagonal NaN,
    every finite diagonal exactly 0."""
    from repro_torch.kernels.pairwise_sqdist import pairwise_stats_cuda
    x = torch.from_numpy(_x(n, d, seed=n + d, inf_rows=(1,) if inf else ())
                         ).to(dtype).to(card)
    got = pairwise_sqdist_cuda(x)
    want = api.finalize_dists(pairwise_stats_cuda(x.float().contiguous())[0])
    torch.cuda.synchronize()
    assert _same(got, want)
    diag = torch.diagonal(got)
    assert bool((diag[torch.isfinite(diag)] == 0).all())


@pytest.mark.cuda
def test_mesh_stats_of_a_one_rank_nccl_world_on_card(card):
    """A real one-rank NCCL world (``make_host_mesh()``, 1x1): the mesh
    statistics of a tree and of an int8 wire equal the replicated kernel
    path's bit for bit, through K6 / K7 once per leaf (K1 / K5 never), each
    on the symmetric grid: the one rank's block is the gathered stack."""
    import torch.distributed as dist
    from repro_torch.comm import codecs as TC
    from repro_torch.launch.mesh import make_host_mesh
    tree = _map(lambda a: torch.from_numpy(a).to(card),
                _tree(11, seed=4, attack=True))
    enc, _ = TC.get_codec("qsgd:bits=8").encode(tree, seed=4)
    mesh = make_host_mesh()
    try:
        ctx = api.MeshContext.for_mesh(mesh)
        assert (ctx.worker_size, ctx.model_size) == (1, 1)
        for grads, kernel, square in ((tree, "pairwise_stats_rect",
                                       "pairwise_stats"),
                                      (enc, "dequant_stats_rect",
                                       "dequant_stats")):
            want = api.compute_stats(grads, F, use_kernels=True)
            block = api.row_block(grads, ctx)
            ops.reset_launch_counts()
            got = api.compute_stats(block, F, use_kernels=True, mesh_ctx=ctx)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            assert counts[kernel] == 3 and counts[square] == 0
            assert ops.square_launch_counts()[kernel] == 3
            assert _same(got.dists, want.dists)
            assert _same(got.sq_norms, want.sq_norms)
    finally:
        dist.destroy_process_group()
