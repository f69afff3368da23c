"""Port parity for the MoE layer (``repro_torch.models.moe``) against the
JAX package's ``repro.models.moe`` on the CPU.

The JAX layer's parameters are carried across (``params_from_jax``) and
both sides get the same numpy input.  Router weights are built so the
router logits of every token are a permutation of E values 1 apart
(``_separated``): the k-th and (k+1)-th probabilities stay well apart, so
an ulp cannot flip a top-k choice.  Tolerances (fp32): outputs within
``rtol=1e-5, atol=1e-6``, the auxiliary loss within ``rtol=1e-6``,
gradients (entries of order 1, summed over tokens in another order)
within ``rtol=1e-4, atol=1e-5``; expert ids and the slots of
every (token, choice), dropped ones included, exactly; at bf16
activations the output within two bf16 ulps of its largest entry.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.configs.base import MoEConfig as JMoE
from repro.models import modules as JM
from repro.models import moe as JE
from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe as TE
from repro_torch.models.api import params_from_jax
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

B, S, D = 2, 24, 64           # 48 tokens <= D: the router fit is exact


def _cfgs(**kw):
    base = dict(n_experts=4, top_k=2, d_expert=16, capacity_factor=8.0)
    base.update(kw)
    return JMoE(**base), MoEConfig(**base)


def _separated(x, n_experts, seed):
    """Router weights (D, E) whose logits ``x @ w`` are, for each token, a
    random permutation of 0, 1, ..., E-1 (least squares, exact: T <= D)."""
    rng = np.random.default_rng(seed)
    t = x.shape[0] * x.shape[1]
    want = np.stack([rng.permutation(n_experts) for _ in range(t)]
                    ).astype(np.float64)
    w, *_ = np.linalg.lstsq(x.reshape(t, -1).astype(np.float64), want,
                            rcond=None)
    return w.astype(np.float32)


def _setup(jcfg, activation, seed=0):
    jp = JE.moe_init(jax.random.key(seed), D, jcfg, activation)
    jp = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(seed + 1)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    jp["router"]["w"] = _separated(x, jcfg.n_experts, seed + 2)
    return jp, x


def _jax_route(jp, x, jcfg):
    """JAX's router, top-k and slot assignment (``repro.models.moe``'s
    own lines, on its own functions)."""
    t = x.shape[0] * x.shape[1]
    e, k = jcfg.n_experts, jcfg.top_k
    c = JE.capacity(t, jcfg)
    xf = jnp.asarray(x).reshape(t, -1)
    logits = JM.linear_apply(jax.tree.map(jnp.asarray, jp["router"]),
                             xf).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, ids = jax.lax.top_k(probs, k)
    eid = ids.reshape(t * k)
    onehot = jax.nn.one_hot(eid, e, dtype=jnp.int32)
    pos = jnp.sum(jnp.cumsum(onehot, axis=0) * onehot, axis=1) - 1
    dest = jnp.where(pos < c, eid * c + pos, e * c)
    return np.asarray(ids), np.asarray(dest), np.asarray(logits)


@pytest.mark.parametrize("activation", ["swiglu", "relu"])
@pytest.mark.parametrize("capacity_factor", [8.0, 1.0, 0.25])
def test_moe_matches_jax(activation, capacity_factor):
    """Output, auxiliary loss, expert ids and slots (so the same tokens
    drop) at a capacity with no drops (8), at 1 (some drop) and at 0.25
    (many drop), fp32."""
    jcfg, tcfg = _cfgs(capacity_factor=capacity_factor)
    jp, x = _setup(jcfg, activation)
    ids_j, dest_j, logits_j = _jax_route(jp, x, jcfg)
    top = np.sort(logits_j, axis=1)
    assert np.min(top[:, -jcfg.top_k] - top[:, -jcfg.top_k - 1]) > 0.5
    yj, auxj = JE.moe_apply(jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                            jcfg, activation)
    tp = params_from_jax(jp, device="cpu")
    xt = torch.from_numpy(x)
    _, ids_t, dest_t, _ = TE.route(xt.reshape(B * S, D), tp["router"], tcfg)
    np.testing.assert_array_equal(ids_t.numpy(), ids_j)
    np.testing.assert_array_equal(dest_t.numpy(), dest_j)
    yt, auxt = TE.moe_apply(tp, xt, tcfg, activation)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(auxt), float(auxj), rtol=1e-6)
    dropped = dest_j == jcfg.n_experts * JE.capacity(B * S, jcfg)
    if capacity_factor == 8.0:
        assert not dropped.any()
    else:
        assert dropped.any()
    # a token whose every choice dropped passes as exact zeros
    gone = dropped.reshape(B * S, jcfg.top_k).all(axis=1)
    assert np.all(yt.numpy().reshape(B * S, D)[gone] == 0.0)


@pytest.mark.parametrize("activation", ["swiglu", "relu"])
@pytest.mark.parametrize("capacity_factor", [8.0, 1.0])
def test_moe_gradients_match_jax(activation, capacity_factor):
    """Gradients of ``sum(y * r) + aux`` with respect to the router, the
    experts and the input (the dispatch's gathered backward), fp32."""
    jcfg, tcfg = _cfgs(capacity_factor=capacity_factor)
    jp, x = _setup(jcfg, activation, seed=3)
    r = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = JE.moe_apply(p, xx, jcfg, activation)
        return jnp.sum(y * jnp.asarray(r)) + aux

    gp_j, gx_j = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    tp = params_from_jax(jp, device="cpu")
    for leaf in tree_leaves(tp):
        leaf.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = TE.moe_apply(tp, xt, tcfg, activation)
    (torch.sum(y * torch.from_numpy(r)) + aux).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tp["router"]["w"].grad.numpy(),
                               np.asarray(gp_j["router"]["w"]), rtol=1e-4,
                               atol=1e-5)
    for name in ("w_in", "w_out") + (("w_gate",) if activation == "swiglu"
                                      else ()):
        g = tp[name].grad.numpy()
        np.testing.assert_allclose(g, np.asarray(gp_j[name]), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
        assert np.abs(g).sum() > 0


def test_moe_bf16_matches_jax():
    """bf16 activations on both sides, the gate cast to bf16 before the
    multiply: within two bf16 ulps of the largest output entry."""
    jcfg, tcfg = _cfgs(capacity_factor=1.0)
    jp, x = _setup(jcfg, "swiglu", seed=5)
    yj, auxj = JE.moe_apply(jax.tree.map(jnp.asarray, jp),
                            jnp.asarray(x, jnp.bfloat16), jcfg, "swiglu")
    yt, auxt = TE.moe_apply(params_from_jax(jp, device="cpu"),
                            torch.from_numpy(x).bfloat16(), tcfg, "swiglu")
    assert yt.dtype == torch.bfloat16
    want = np.asarray(yj.astype(jnp.float32))
    bound = 2 * 2.0 ** -7 * np.abs(want).max()
    assert np.abs(yt.float().numpy() - want).max() <= bound
    np.testing.assert_allclose(float(auxt), float(auxj), rtol=1e-3)


def test_capacity_matches_jax():
    for t in (1, 7, 48, 256, 512, 4096):
        for kw in (dict(n_experts=128, top_k=8, d_expert=8),
                   dict(n_experts=16, top_k=2, d_expert=8,
                        capacity_factor=0.5)):
            assert TE.capacity(t, MoEConfig(**kw)) == \
                JE.capacity(t, JMoE(**kw))


def test_aux_loss_balanced_router_is_minimal():
    """Uniform routing: the Switch aux loss is the weight (JAX's test)."""
    cfg = MoEConfig(n_experts=4, top_k=1, d_expert=8, aux_loss_weight=1.0)
    gen = torch.Generator().manual_seed(0)
    p = TE.moe_init(gen, 4, cfg, "relu")
    p["router"] = {"w": torch.zeros_like(p["router"]["w"])}
    x = torch.randn((2, 32, 4), generator=gen)
    _, aux = TE.moe_apply(p, x, cfg, "relu")
    assert float(aux) == pytest.approx(1.0, rel=0.05)


def test_backward_is_the_same_bits_twice():
    """The gathered combine and dispatch backward: two backward passes of
    one input give the same gradient bits."""
    jcfg, tcfg = _cfgs(capacity_factor=1.0)
    jp, x = _setup(jcfg, "swiglu", seed=7)
    grads = []
    for _ in range(2):
        tp = params_from_jax(jp, device="cpu")
        xt = torch.from_numpy(x).requires_grad_(True)
        y, aux = TE.moe_apply(tp, xt, tcfg, "swiglu")
        (torch.sum(y ** 2) + aux).backward()
        grads.append(xt.grad.clone())
    assert torch.equal(grads[0], grads[1])


def test_init_tree_matches_jax():
    for act in ("swiglu", "relu"):
        jcfg, tcfg = _cfgs()
        jp = JE.moe_init(jax.random.key(0), D, jcfg, act)
        tp = TE.moe_init(torch.Generator().manual_seed(0), D, tcfg, act)
        assert sorted(tp) == sorted(jp)
        for k in jp:
            jl = jax.tree.leaves(jp[k])
            tl = [tp[k]["w"]] if k == "router" else [tp[k]]
            assert [tuple(a.shape) for a in tl] == [tuple(a.shape) for a in jl]
