"""Port parity for the checkpoint store (``repro_torch.checkpoint``): the
round-trip contract of ``tests/test_checkpoint.py`` and the
``TrainerState`` layout of ``tests/test_trainer_state.py`` on the port's
trees, and the file format shared with the JAX package: a checkpoint
written by either package is restored by the other bit for bit, bf16
leaves included, and the CPU launcher's ``--ckpt-dir`` file is read by
JAX's ``restore`` into JAX's parameter tree."""
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import models as JMD
from repro.checkpoint import restore as jrestore
from repro.checkpoint import save as jsave
from repro.configs import get_config as jget_config
from repro.dist import trainer as JTR
from repro.optim import optimizers as JO
from repro_torch.checkpoint import latest_step, restore, save
from repro_torch.dist import trainer as TTR
from repro_torch.launch import train
from repro_torch.models import params_from_jax
from repro_torch.optim import optimizers as TO
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)


def _leaves(tree):
    """Leaves of a port tree in the store's order (dicts by sorted key,
    containers by field), ``None`` skipped."""
    out = []

    def walk(node):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, TTR.TrainerState):
            for name in ("opt", "tstates", "astate", "cres"):
                walk(getattr(node, name))
        elif isinstance(node, (tuple, list)):
            for x in node:
                walk(x)
        else:
            out.append(node)

    walk(tree)
    return out


def _bits(x):
    """Raw bits of a port or JAX leaf, as a numpy array of unsigned ints
    (a Python int as int32, as the store writes it)."""
    if isinstance(x, int):
        return np.asarray(x, np.int32)
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_same_bits(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        gb, wb = _bits(g), _bits(w)
        assert gb.dtype == wb.dtype and gb.shape == wb.shape
        np.testing.assert_array_equal(gb, wb)


def _nested_tree():
    return {
        "params": {
            "embed": {"w": torch.arange(12, dtype=torch.float32
                                        ).reshape(3, 4)},
            "layers": [
                {"w": torch.ones((2, 2), dtype=torch.bfloat16) * 1.5,
                 "b": torch.zeros((2,), dtype=torch.float32)},
                {"w": torch.full((2, 2), -2.25, dtype=torch.bfloat16),
                 "b": torch.ones((2,), dtype=torch.float32)},
            ],
        },
        "step": torch.tensor(7, dtype=torch.int32),
        "scales": (torch.tensor([0.5, 0.25]),
                   torch.tensor(3, dtype=torch.int32)),
    }


# ------------------------------------------------- tests/test_checkpoint.py
def test_roundtrip_nested_tree_preserves_values_and_dtypes(tmp_path):
    tree = _nested_tree()
    path = save(str(tmp_path), 5, tree)
    assert path.endswith("ckpt_00000005.npz")
    like = {"params": {"embed": {"w": torch.zeros(3, 4)},
                       "layers": [{"w": torch.zeros(2, 2,
                                                    dtype=torch.bfloat16),
                                   "b": torch.zeros(2)}] * 2},
            "step": torch.tensor(0, dtype=torch.int32),
            "scales": (torch.zeros(2), torch.tensor(0, dtype=torch.int32))}
    out = restore(str(tmp_path), 5, like)
    assert isinstance(out["params"]["layers"], list)
    assert isinstance(out["scales"], tuple)
    for a, b in zip(_leaves(out), _leaves(tree)):
        assert a.dtype == b.dtype
    _assert_same_bits(_leaves(out), _leaves(tree))


def test_bfloat16_bits_survive(tmp_path):
    # values not exactly representable in fp16 / fp32 round trips: the
    # uint16 bit view, not a numeric cast
    vals = torch.tensor([1.0 / 3.0, np.pi, -1e-20, 3e38]).bfloat16()
    save(str(tmp_path), 1, {"x": vals})
    out = restore(str(tmp_path), 1, {"x": torch.zeros_like(vals)})
    assert out["x"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(out["x"]), _bits(vals))
    with np.load(os.path.join(tmp_path, "ckpt_00000001.npz")) as data:
        assert data.files == ["x::bfloat16"]
        assert data["x::bfloat16"].dtype == np.uint16


def test_latest_step_and_missing_dir(tmp_path):
    d = str(tmp_path / "ck")
    assert latest_step(d) is None
    for s in (3, 12, 7):
        save(d, s, {"x": torch.ones(2)})
    assert latest_step(d) == 12
    assert not any(f.endswith(".tmp") for f in os.listdir(d))


def test_restore_validates_structure(tmp_path):
    d = str(tmp_path)
    save(d, 2, {"a": torch.ones(2, 2), "b": torch.zeros(3)})
    with pytest.raises(KeyError, match="checkpoint missing key 'c'"):
        restore(d, 2, {"a": torch.ones(2, 2), "c": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        restore(d, 2, {"a": torch.ones(2, 3), "b": torch.zeros(3)})


def test_optimizer_state_roundtrip(tmp_path):
    """OptState NamedTuples round-trip; the step is an int again."""
    opt = TO.sgd(momentum=0.9)
    params = {"w": torch.ones(3, 2), "b": torch.zeros(2)}
    st = opt.init(params)
    new_p, st = opt.update({k: torch.ones_like(v) for k, v in params.items()},
                           st, params, 0.1)
    save(str(tmp_path), 1, {"opt": st, "params": new_p})
    out = restore(str(tmp_path), 1, {"opt": opt.init(params),
                                     "params": params})
    assert out["opt"].step == 1 and isinstance(out["opt"].step, int)
    assert out["opt"].nu is None
    _assert_same_bits(_leaves(out), _leaves({"opt": st, "params": new_p}))


# ---------------------------------------------- tests/test_trainer_state.py
PARAMS = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
          "b": torch.ones(3, dtype=torch.bfloat16)}


def test_checkpoint_round_trip_current_layout(tmp_path):
    st = TTR.init_train_state(TO.sgd(momentum=0.9), PARAMS, n_workers=7,
                              codec="topk:frac=0.1,ef=1")
    save(str(tmp_path), 5, {"params": PARAMS, "state": st})
    loaded = restore(str(tmp_path), 5, {"params": PARAMS, "state": st})
    assert isinstance(loaded["state"], TTR.TrainerState)
    _assert_same_bits(_leaves(loaded["state"]), _leaves(st))
    with np.load(os.path.join(tmp_path, "ckpt_00000005.npz")) as data:
        assert "state|opt|step" in data.files
        assert "state|cres|w" in data.files


def test_restore_onto_another_device_and_dtype(tmp_path):
    save(str(tmp_path), 1, {"x": torch.tensor([1.5, -2.0])})
    out = restore(str(tmp_path), 1, {"x": torch.zeros(2, dtype=torch.bfloat16)},
                  device="cpu")
    assert out["x"].dtype == torch.bfloat16 and out["x"].device.type == "cpu"
    np.testing.assert_array_equal(out["x"].float().numpy(), [1.5, -2.0])


# ------------------------------------------------------ across the packages
def _jax_state():
    """A JAX (params, TrainerState) with a bf16 parameter, momentum after
    one update and the adaptive little-is-enough's state."""
    params = {"w": jnp.asarray(np.random.default_rng(0).normal(
                  size=(2, 3)).astype(np.float32)),
              "b": jnp.asarray([1.0 / 3.0, np.pi, -1e-20], jnp.bfloat16)}
    opt = JO.sgd(momentum=0.9)
    st = JTR.init_train_state(opt, params, n_workers=11,
                              attack="adaptive_lie", attack_f=2)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.3, p.dtype), params)
    params, opt_state = opt.update(grads, st.opt, params, 0.1)
    st = JTR.TrainerState(opt=opt_state, astate={
        "z": jnp.asarray(1.15, jnp.float32), "share": st.astate["share"]})
    return {"params": params, "state": st}


def _port_like():
    params = {"w": torch.zeros(2, 3), "b": torch.zeros(3,
                                                       dtype=torch.bfloat16)}
    st = TTR.init_train_state(TO.sgd(momentum=0.9), params, n_workers=11,
                              attack="adaptive_lie", attack_f=2)
    return {"params": params, "state": st}


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jtree = _jax_state()
    jsave(str(tmp_path), 4, jtree)
    out = restore(str(tmp_path), 4, _port_like())
    assert out["state"].opt.step == 1
    assert out["params"]["b"].dtype == torch.bfloat16
    assert sorted(out["state"].astate) == ["share", "z"]
    _assert_same_bits(_leaves(out), jax.tree.leaves(jtree))


def test_port_checkpoint_restores_in_jax(tmp_path):
    jtree = _jax_state()
    jsave(str(tmp_path / "j"), 4, jtree)
    tree = restore(str(tmp_path / "j"), 4, _port_like())
    save(str(tmp_path / "t"), 4, tree)
    # the same keys, dtypes and bits as JAX's own file
    with np.load(str(tmp_path / "j" / "ckpt_00000004.npz")) as want, \
            np.load(str(tmp_path / "t" / "ckpt_00000004.npz")) as got:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    like = jax.tree.map(jnp.zeros_like, jtree)
    out = jrestore(str(tmp_path / "t"), 4, like)
    assert isinstance(out["state"], JTR.TrainerState)
    _assert_same_bits(jax.tree.leaves(out), jax.tree.leaves(jtree))


def test_launcher_ckpt_dir_is_read_by_jax(tmp_path, capsys):
    d = str(tmp_path / "ck")
    params, _ = train.run(["--device", "cpu", "--reduced", "--seq", "8",
                           "--workers", "7", "--f", "1",
                           "--per-worker-batch", "1", "--steps", "3",
                           "--log-every", "100", "--ckpt-dir", d])
    path = os.path.join(d, "ckpt_00000003.npz")
    assert f"[train] checkpoint -> {path}" in capsys.readouterr().out
    like = {"params": JMD.init_model(jax.random.key(0),
                                     jget_config("qwen2-1.5b").reduced())}
    out = jrestore(d, 3, like)["params"]
    want = tree_leaves(params)
    got = jax.tree.leaves(out)
    assert len(got) == len(want)
    _assert_same_bits(got, want)
    back = params_from_jax(jax.tree.map(np.asarray, out), device="cpu")
    _assert_same_bits(tree_leaves(back), want)


def test_hybrid_tree_round_trips_jax_port_jax(tmp_path):
    """The reduced jamba hybrid (mamba and attention mixers, dense and MoE
    MLPs): JAX's file restores into the port's own tree (``init_model``'s
    layout), the port writes it back, and JAX restores that file, every
    leaf bit for bit along the way."""
    from repro_torch import models as TMD
    from repro_torch.configs import get_config
    cfg = get_config("jamba-1.5-large-398b").reduced()
    jparams = JMD.init_model(jax.random.key(3),
                             jget_config("jamba-1.5-large-398b").reduced())
    jsave(str(tmp_path / "j"), 1, {"params": jparams})
    like = {"params": TMD.init_model(cfg, seed=0, device="cpu")}
    tree = restore(str(tmp_path / "j"), 1, like)
    _assert_same_bits(_leaves(tree), jax.tree.leaves(jparams))
    save(str(tmp_path / "t"), 1, tree)
    back = jrestore(str(tmp_path / "t"), 1,
                    {"params": jax.tree.map(jnp.zeros_like, jparams)})
    _assert_same_bits(jax.tree.leaves(back), jax.tree.leaves(jparams))
