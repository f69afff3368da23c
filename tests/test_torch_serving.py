"""Port parity for the serving path: the KV caches, the cached decode
attention, prefill, decode, ``generate`` and the robust replica ensemble,
against the JAX package on the CPU.

Configuration: reduced qwen2-1.5b (2 layers, d_model 256, vocab 512), the
same JAX-initialised parameters on both sides (``params_from_jax``), inputs
from numpy seeds.  The fp32 parity runs set ``dtype="float32"`` on the port
and cast the JAX package's embedding to fp32 (it hard-codes bf16
activations); the caches are bf16 on both sides.  Tolerances: the caches
bit for bit where both sides pack the same K/V, else within one bf16 ulp
(or 1e-6 of the largest entry, near 0; at most 0.1 % of the entries of a
prefill differing); ``attend_cached`` within
1e-5 relative; prefill and decode logits within 1e-4 relative (``_close``:
relative to each entry and to the largest |want|); the port's decode
against its own forward within JAX's ``TOL = 5e-2`` (bf16 activations);
the ensemble's selections exact and its fused logits within 1e-5 relative
of JAX's aggregation on the same replica logits, bit for bit the honest
logits when the honest replicas are identical.
"""
import dataclasses
import functools
import importlib.util
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import models as JMD
from repro.configs import get_config as jget
from repro.configs.base import RobustConfig as JRobust
from repro.core import api as JAPI
from repro.dist import serving as JSV
from repro.models import attention as JA
from repro.models import modules as JM
from repro_torch import models as TMD
from repro_torch.configs import RobustConfig, get_config
from repro_torch.core import api as TAPI
from repro_torch.dist import serving as TSV
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.tree import tree_leaves, tree_map

# the suite runs in several worker processes at once: one thread each
# keeps the port's many small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

B, S = 2, 12
TOL = 5e-2                  # tests/test_serving.py's decode-vs-forward bound
BF16_ULP = 2.0 ** -7        # one bf16 ulp, relative to the value, at most
N, F = 11, 2


@pytest.fixture
def fp32_jax(monkeypatch):
    """The JAX package casts activations to bf16 at the embedding; the fp32
    parity runs cast to fp32 there instead."""
    monkeypatch.setattr(JM, "embedding_apply", functools.partial(
        JM.embedding_apply, dtype=jnp.float32))


def _cfgs(dtype="float32"):
    jcfg = jget("qwen2-1.5b").reduced()
    tcfg = dataclasses.replace(get_config("qwen2-1.5b").reduced(),
                               dtype=dtype)
    return jcfg, tcfg


def _params(jcfg, seed=0):
    jp = JMD.init_model(jax.random.key(seed), jcfg)
    return jp, TMD.params_from_jax(jax.tree.map(np.asarray, jp),
                                   device="cpu")


def _tokens(shape, seed, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _jcache_np(cache):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), cache)


def _close(got, want, rel):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * float(np.max(np.abs(want))))


def _within_ulp(got, want, max_share=None):
    """bf16 caches within one ulp of each entry, or within 1e-6 of the
    largest entry where the fp32 K/V before the cast cancel to near 0 (the
    two sides' fp32 sums differ by about that much); with ``max_share``, at
    most that share of the entries differing at all."""
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=BF16_ULP,
                               atol=1e-6 * float(np.max(np.abs(want))))
    if max_share is not None:
        assert np.mean(got != want) <= max_share


# ------------------------------------------------------------------ caches
@pytest.mark.parametrize("s,window", [(12, 0), (12, 8), (5, 8), (8, 8)])
def test_cache_from_prefill_bit_for_bit(s, window):
    rng = np.random.default_rng(s + window)
    k = rng.normal(size=(B, s, 2, 64)).astype(np.float32)
    v = rng.normal(size=(B, s, 2, 64)).astype(np.float32)
    want = JA.cache_from_prefill(jnp.asarray(k), jnp.asarray(v), s + 4,
                                 window)
    got = TA.cache_from_prefill(torch.from_numpy(k), torch.from_numpy(v),
                                s + 4, window)
    for key in ("k", "v"):
        assert got[key].dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(got[key]), _np(want[key]))


def test_cache_from_prefill_refuses_a_short_cache():
    k = torch.zeros((1, 6, 2, 8))
    with pytest.raises(ValueError, match="cache_len 4 < prompt length 6"):
        TA.cache_from_prefill(k, k, 4, 0)


@pytest.mark.parametrize("window", [0, 8])
def test_init_cache_matches_jax_layout(window):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    want = JMD.init_cache_fn(jp, jcfg, B, 20, window=window)
    got = TMD.init_cache_fn(tp, tcfg, B, 20, window=window)
    jl = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [tuple(k.key for k in p) for p, _ in jl] == [
        ("l0", "k"), ("l0", "v")]
    for (_, j), t in zip(jl, tree_leaves(got)):
        assert tuple(t.shape) == tuple(j.shape)
        assert t.dtype == torch.bfloat16 and not bool(t.any())


def test_cache_from_jax_is_exact_bf16():
    jcfg, _ = _cfgs()
    jp = JMD.init_model(jax.random.key(0), jcfg)
    _, cache = JMD.prefill_fn(jp, jcfg, {"tokens": jnp.asarray(
        _tokens((B, S), 1))}, chunk_q=S)
    got = TMD.cache_from_jax(_jcache_np(cache), device="cpu")
    for t, j in zip(tree_leaves(got), jax.tree.leaves(cache)):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(t), _np(j))


# --------------------------------------------------------- attend_cached
@pytest.mark.parametrize("seq_chunks", [1, 2, 4])
@pytest.mark.parametrize("window,pos", [(0, 0), (0, 9), (0, 15), (8, 5),
                                        (8, 8), (8, 13), (8, 22)])
def test_attend_cached_matches_jax(window, pos, seq_chunks):
    """Full cache and ring buffer, before and past the ring's wrap."""
    jcfg, tcfg = _cfgs()
    jp = JA.attn_init(jax.random.key(3), jcfg)
    tp = TMD.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(pos * 10 + window)
    length = window or 16
    x = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
    shape = (B, length, jcfg.n_kv_heads, jcfg.resolved_head_dim)
    cache = {k: jnp.asarray(rng.normal(size=shape), jnp.bfloat16)
             for k in ("k", "v")}
    want_y, want_c = JA.attend_cached(jp, jnp.asarray(x), cache,
                                      jnp.int32(pos), jcfg, window=window,
                                      seq_chunks=seq_chunks)
    tcache = TMD.cache_from_jax(_jcache_np(cache), device="cpu")
    got_y, got_c = TA.attend_cached(tp, torch.from_numpy(x), tcache, pos,
                                    tcfg, window=window,
                                    seq_chunks=seq_chunks)
    _close(got_y, want_y, 1e-5)
    for key in ("k", "v"):
        _within_ulp(got_c[key], want_c[key])
        # written out of place: the cache passed in is as it was
        np.testing.assert_array_equal(_np(tcache[key]), _np(cache[key]))


def test_attend_cached_takes_a_tensor_position():
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg)
    lp = tree_map(lambda t: t[0], tp["groups"])["l0"]["attn"]
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(B, 1, tcfg.d_model)).astype(np.float32))
    cache = TA.init_kv_cache(B, 8, tcfg.n_kv_heads, tcfg.resolved_head_dim)
    a = TA.attend_cached(lp, x, cache, 11, tcfg, window=8)
    b = TA.attend_cached(lp, x, cache, torch.tensor(11, dtype=torch.int32),
                         tcfg, window=8)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(a[1][k], b[1][k]) for k in ("k", "v"))


# --------------------------------------------------------- prefill/decode
@pytest.mark.parametrize("window", [0, 8])
def test_prefill_matches_jax(fp32_jax, window):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    tok = _tokens((B, S), 2)
    want_l, want_c = JMD.prefill_fn(jp, jcfg, {"tokens": jnp.asarray(tok)},
                                    window=window, chunk_q=S,
                                    cache_len=S + 4)
    got_l, got_c = TMD.prefill_fn(tp, tcfg, {"tokens": torch.from_numpy(tok)},
                                  window=window, chunk_q=S, cache_len=S + 4)
    assert tuple(got_l.shape) == (B, jcfg.vocab_size)
    _close(got_l, want_l, 1e-4)
    for t, j in zip(tree_leaves(got_c), jax.tree.leaves(want_c)):
        assert tuple(t.shape) == tuple(j.shape)
        _within_ulp(t, j, max_share=1e-3)


@pytest.mark.parametrize("window", [0, 8])
def test_decode_steps_match_jax(fp32_jax, window):
    """Two steps from JAX's prefill cache carried across, each side
    carrying its own updated cache into the second step."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    tok = _tokens((B, S), 3)
    _, jc = JMD.prefill_fn(jp, jcfg, {"tokens": jnp.asarray(tok)},
                           window=window, chunk_q=S, cache_len=S + 4)
    tc = TMD.cache_from_jax(_jcache_np(jc), device="cpu")
    for step in range(2):
        nxt = _tokens((B,), 10 + step)
        want, jc = JMD.decode_fn(jp, jcfg, jnp.asarray(nxt), jc,
                                 jnp.int32(S + step), window=window)
        got, tc = TMD.decode_fn(tp, tcfg, torch.from_numpy(nxt), tc,
                                S + step, window=window)
        _close(got, want, 1e-4)


def _extended(batch, tok):
    return {"tokens": torch.cat([batch["tokens"], tok[:, None]], dim=1)}


@pytest.mark.parametrize("window", [0, 8])
def test_prefill_decode_matches_forward(window):
    """Within the port (bf16 activations), as tests/test_serving.py."""
    _, tcfg = _cfgs("bfloat16")
    params = TMD.init_model(tcfg, seed=0, device="cpu")
    batch = {"tokens": torch.from_numpy(_tokens((B, S), 4))}
    last, cache = TMD.prefill_fn(params, tcfg, batch, chunk_q=S,
                                 window=window)
    full = TMD.forward_fn(params, tcfg, batch, chunk_q=S, logits_tail=1,
                          window=window)[:, -1]
    np.testing.assert_allclose(_np(last), _np(full), atol=TOL, rtol=0)
    cur = batch
    for step in range(2):
        tok = torch.from_numpy(_tokens((B,), 20 + step))
        cur = _extended(cur, tok)
        want = TMD.forward_fn(params, tcfg, cur, chunk_q=1, logits_tail=1,
                              window=window)[:, -1]
        got, cache = TMD.decode_fn(params, tcfg, tok, cache, S + step,
                                   window=window)
        np.testing.assert_allclose(_np(got), _np(want), atol=TOL, rtol=0)


def test_ring_buffer_matches_forward_past_the_wrap():
    """6 steps from a 12-token prompt at W = 8 (tests/test_serving.py)."""
    _, tcfg = _cfgs("bfloat16")
    params = TMD.init_model(tcfg, seed=1, device="cpu")
    W = 8
    cur = {"tokens": torch.from_numpy(_tokens((1, 12), 5))}
    _, cache = TMD.prefill_fn(params, tcfg, cur, chunk_q=12, window=W)
    for step in range(6):
        tok = torch.from_numpy(_tokens((1,), 100 + step))
        cur = _extended(cur, tok)
        want = TMD.forward_fn(params, tcfg, cur, chunk_q=1, logits_tail=1,
                              window=W)[:, -1]
        got, cache = TMD.decode_fn(params, tcfg, tok, cache, 12 + step,
                                   window=W)
        np.testing.assert_allclose(_np(got), _np(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("chunks", [2, 4])
def test_chunked_decode_matches_unchunked(chunks):
    """The flash-style partial softmax against the port's own unchunked
    path (fp32: the same math in another order)."""
    _, tcfg = _cfgs()
    params = TMD.init_model(tcfg, seed=2, device="cpu")
    batch = {"tokens": torch.from_numpy(_tokens((B, 16), 6))}
    _, cache = TMD.prefill_fn(params, tcfg, batch, chunk_q=16, cache_len=32)
    tok = torch.from_numpy(_tokens((B,), 7))
    l1, c1 = TMD.decode_fn(params, tcfg, tok, cache, 16, seq_chunks=1)
    l2, c2 = TMD.decode_fn(params, tcfg, tok, cache, 16, seq_chunks=chunks)
    _close(l2, l1, 1e-5)
    for a, b in zip(tree_leaves(c1), tree_leaves(c2)):
        # the first layer writes the same K/V; the second's come from the
        # first's output, which the chunking reorders
        assert torch.equal(a[0], b[0])
        _within_ulp(a, b)


# ---------------------------------------------------------------- generate
def test_generate_greedy_matches_jax(fp32_jax):
    """JAX's greedy tokens, where every step's top-2 gap exceeds 1e-3 x
    max |logit| (checked here); where it does not, JAX's tokens are
    teacher-forced into the port's decode and the logits compared."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=4)
    prompt = _tokens((B, 8), 8)
    new = 6
    want = np.asarray(JSV.generate(jp, jcfg, jnp.asarray(prompt), new,
                                   chunk_q=8))
    got = TSV.generate(tp, tcfg, torch.from_numpy(prompt), new, chunk_q=8)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, new)
    # JAX's logits at every step, its own tokens fed back
    jl, jc = JMD.prefill_fn(jp, jcfg, {"tokens": jnp.asarray(prompt)},
                            chunk_q=8, cache_len=8 + new)
    tl, tc = TMD.prefill_fn(tp, tcfg, {"tokens": torch.from_numpy(prompt)},
                            chunk_q=8, cache_len=8 + new)
    gaps_ok = True
    for t in range(new):
        top2 = np.sort(_np(jl), axis=-1)[:, -2:]
        gaps_ok &= bool(np.all(top2[:, 1] - top2[:, 0]
                               > 1e-3 * np.max(np.abs(_np(jl)))))
        _close(tl, jl, 1e-4)
        if t + 1 < new:
            tok = want[:, t]
            jl, jc = JMD.decode_fn(jp, jcfg, jnp.asarray(tok), jc,
                                   jnp.int32(8 + t))
            tl, tc = TMD.decode_fn(tp, tcfg, torch.tensor(tok), tc,
                                   8 + t)
    if gaps_ok:
        np.testing.assert_array_equal(got.numpy(), want)


def test_generate_categorical_is_reproducible():
    _, tcfg = _cfgs("bfloat16")
    params = TMD.init_model(tcfg, seed=0, device="cpu")
    prompt = torch.from_numpy(_tokens((B, 8), 9))
    a = TSV.generate(params, tcfg, prompt, 6, chunk_q=8,
                     sample="categorical", seed=3)
    b = TSV.generate(params, tcfg, prompt, 6, chunk_q=8,
                     sample="categorical", seed=3)
    c = TSV.generate(params, tcfg, prompt, 6, chunk_q=8,
                     sample="categorical", seed=4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert bool(((a >= 0) & (a < tcfg.vocab_size)).all())


def test_select_token_draw_depends_on_seed_and_step_only():
    logits = torch.zeros((4, 64))
    a = TSV._select_token(logits, "categorical", 5, 3)
    TSV._select_token(logits, "categorical", 5, 2)
    assert torch.equal(TSV._select_token(logits, "categorical", 5, 3), a)
    peaked = torch.full((4, 64), -1e4)
    peaked[:, 17] = 0.0
    assert torch.equal(TSV._select_token(peaked, "categorical", 5, 0),
                       torch.full((4,), 17, dtype=torch.int32))
    assert torch.equal(TSV._select_token(peaked, "greedy", None, 0),
                       torch.full((4,), 17, dtype=torch.int32))


def test_categorical_draws_follow_the_distribution():
    """Gumbel-max draws over 4000 rows against softmax(logits)."""
    logits = torch.log(torch.tensor([0.5, 0.3, 0.2]))[None].repeat(4000, 1)
    tok = TSV._select_token(logits, "categorical", 0, 0)
    freq = torch.bincount(tok.long(), minlength=3).float() / 4000
    assert torch.allclose(freq, torch.tensor([0.5, 0.3, 0.2]), atol=0.03)


# ---------------------------------------------------------------- refusals
def _other_family():
    """A family the port still lacks: the audio encoder-decoder (the
    decoder-only families all run)."""
    return dataclasses.replace(_cfgs()[1], family="audio", name="audio-cfg")


def _refusals():
    _, tcfg = _cfgs()
    params = TMD.init_model(tcfg, seed=0, device="cpu")
    tok = torch.zeros((1, 4), dtype=torch.int32)
    batch = {"tokens": tok}
    cache = TMD.init_cache_fn(params, tcfg, 1, 8)
    moe, none = _other_family(), dataclasses.replace(tcfg, rope="none")
    return {
        "prefill_moe": (NotImplementedError, "encoder-decoder family",
                        lambda: TMD.prefill_fn(params, moe, batch)),
        "decode_moe": (NotImplementedError, "encoder-decoder family",
                       lambda: TMD.decode_fn(params, moe, tok[:, 0], cache,
                                             4)),
        "forward_moe": (NotImplementedError, "encoder-decoder family",
                        lambda: TMD.forward_fn(params, moe, batch)),
        "init_cache_moe": (NotImplementedError, "encoder-decoder family",
                           lambda: TMD.init_cache_fn(params, moe, 1, 8)),
        "decode_rope_none": (NotImplementedError, "rope='none'",
                             lambda: TMD.decode_fn(params, none, tok[:, 0],
                                                   cache, 4)),
        "prefill_rope_none": (NotImplementedError, "rope='none'",
                              lambda: TMD.prefill_fn(params, none, batch)),
        "prefix_embeds": (ValueError, "prefix_embeds",
                          lambda: TMD.prefill_fn(params, tcfg, {
                              **batch, "prefix_embeds": torch.zeros(1)})),
        "frames": (NotImplementedError, "frames",
                   lambda: TMD.forward_fn(params, tcfg, {
                       **batch, "frames": torch.zeros(1)})),
        "memory": (NotImplementedError, "encoder-decoder",
                   lambda: TMD.init_cache_fn(params, tcfg, 1, 8,
                                             memory=torch.zeros(1))),
        "extra_batch": (NotImplementedError, "extra_batch",
                        lambda: TSV.generate(params, tcfg, tok, 2,
                                             extra_batch={
                                                 "frames": torch.zeros(1)})),
        "categorical_no_seed": (ValueError, "needs a seed",
                                lambda: TSV.generate(params, tcfg, tok, 2,
                                                     sample="categorical")),
        "unknown_sample": (ValueError, "unknown sample mode",
                           lambda: TSV.generate(params, tcfg, tok, 2,
                                                sample="top_k")),
    }


@pytest.mark.parametrize("case", [
    "prefill_moe", "decode_moe", "forward_moe", "init_cache_moe",
    "decode_rope_none", "prefill_rope_none", "prefix_embeds", "frames",
    "memory", "extra_batch", "categorical_no_seed", "unknown_sample"])
def test_refusals(case):
    exc, match, fn = _refusals()[case]
    with pytest.raises(exc, match=match):
        fn()


# --------------------------------------------------------------- backend
def _stack_tree(n, seed):
    rng = np.random.default_rng(seed)
    scale = (1.0 + 0.1 * np.arange(n, dtype=np.float32))
    return {"a": (rng.normal(size=(n, 3, 5)) * scale[:, None, None]).astype(
                np.float32),
            "b": (rng.normal(size=(n, 7)) * scale[:, None]).astype(
                np.float32)}


def _same_plan(tp, jp):
    assert tp.kind == jp.kind and tp.beta == jp.beta
    for key in ("weights", "w_ext", "w_agr"):
        a, b = getattr(tp, key), getattr(jp, key)
        assert (a is None) == (b is None), key
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("gar", ["average", "median", "trimmed_mean", "krum",
                                 "multi_krum", "bulyan", "multi_bulyan"])
def test_backend_call_and_plan_stats_match_jax(gar):
    tree = _stack_tree(N, 0)
    jb = JAPI.AggregatorBackend(gar=gar, f=F)
    tb = TAPI.AggregatorBackend(gar=gar, f=F, use_kernels=True)
    jplan, jstats = jb.plan_stats({k: jnp.asarray(v) for k, v in
                                   tree.items()})
    tplan, tstats = tb.plan_stats({k: torch.from_numpy(v) for k, v in
                                   tree.items()})
    _same_plan(tplan, jplan)
    assert (tstats.dists is None) == (jstats.dists is None)
    if tstats.dists is not None:
        _close(tstats.dists, jstats.dists, 1e-5)
    want = jb({k: jnp.asarray(v) for k, v in tree.items()})
    got = tb({k: torch.from_numpy(v) for k, v in tree.items()})
    for key in tree:
        _close(got[key], want[key], 1e-5)


# ------------------------------------------------------- robust ensemble
@pytest.mark.parametrize("gar", ["multi_bulyan", "multi_krum", "median"])
def test_aggregate_replica_logits_matches_jax(gar):
    rng = np.random.default_rng(11)
    logits = rng.normal(size=(N, B, 512)).astype(np.float32) \
        + rng.normal(size=(1, B, 512)).astype(np.float32)
    logits[0] *= 1e4
    jr = JRobust(n_workers=N, f=F, gar=gar, use_pallas=True)
    tr = RobustConfig(n_workers=N, f=F, gar=gar, use_kernels=True)
    want = JSV.aggregate_replica_logits(jnp.asarray(logits), jr)
    got = TSV.aggregate_replica_logits(torch.from_numpy(logits), tr)
    assert tuple(got.shape) == (B, 512)
    _close(got, want, 1e-5)
    jplan, _ = JAPI.AggregatorBackend.for_config(jr).plan_stats(
        jnp.asarray(logits))
    tplan, _ = TAPI.AggregatorBackend.for_config(tr).plan_stats(
        torch.from_numpy(logits))
    _same_plan(tplan, jplan)


def _replica_params(jcfg, seeds, corrupt):
    """JAX replicas from distinct seeds, ``corrupt`` {replica: factor} on
    the embedding table; stacked on a leading axis, and the port's copy."""
    reps = []
    for i, s in enumerate(seeds):
        p = JMD.init_model(jax.random.key(s), jcfg)
        if i in corrupt:
            p = dict(p, embed={"table": p["embed"]["table"] * corrupt[i]})
        reps.append(p)
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *reps)
    return stacked, TMD.params_from_jax(jax.tree.map(np.asarray, stacked),
                                        device="cpu")


def test_robust_serve_step_matches_jax(fp32_jax):
    """Distinct-seed replicas, replica 0 corrupted, two steps, each from
    JAX's caches carried across.  Every replica's logits within 1e-4
    relative of JAX's and the same selection (plans exact).  The fused
    logits are held within 1e-5 relative to JAX's aggregation of the
    port's replica logits: the coordinate phase picks the value nearest the
    median (beta = 1), so replica logits 5e-5 apart can pick another value
    (27 of 1024 fused logits moved by up to 0.018 on this input at step 2,
    within JAX alone).  The returned caches within one bf16 ulp."""
    jcfg, tcfg = _cfgs()
    jstack, tstack = _replica_params(jcfg, range(N), {0: 1e4})
    jr = JRobust(n_workers=N, f=F, gar="multi_bulyan", use_pallas=True)
    tr = RobustConfig(n_workers=N, f=F, gar="multi_bulyan", use_kernels=True)
    prompt = jnp.asarray(_tokens((B, 8), 12))
    _, jc = jax.vmap(lambda p: JMD.prefill_fn(
        p, jcfg, {"tokens": prompt}, chunk_q=8, cache_len=12))(jstack)
    jstep = JSV.make_robust_serve_step(jcfg, jr)
    tstep = TSV.make_robust_serve_step(tcfg, tr)
    jb = JAPI.AggregatorBackend.for_config(jr)
    tb = TAPI.AggregatorBackend.for_config(tr)
    for step in range(2):
        tc = TMD.cache_from_jax(_jcache_np(jc), device="cpu")
        tok = _tokens((B,), 30 + step)
        jrep, _ = jax.vmap(lambda p, c: JMD.decode_fn(
            p, jcfg, jnp.asarray(tok), c, jnp.int32(8 + step)))(jstack, jc)
        trep = torch.stack([TMD.decode_fn(
            tree_map(lambda t: t[i], tstack), tcfg, torch.from_numpy(tok),
            tree_map(lambda t: t[i], tc), 8 + step)[0] for i in range(N)])
        for i in range(N):
            _close(trep[i], jrep[i], 1e-4)
        tplan = tb.plan_stats(trep)[0]
        _same_plan(tplan, jb.plan_stats(jrep)[0])
        # the corrupted replica takes no selection mass (replica 1 is
        # honest here)
        assert float(tplan.selection_weights()[0]) == 0.0
        _, jc = jstep(jstack, jc, jnp.asarray(tok), jnp.int32(8 + step))
        got, tc = tstep(tstack, tc, torch.from_numpy(tok), 8 + step)
        assert torch.equal(got, TSV.aggregate_replica_logits(trep, tr))
        _close(got, JSV.aggregate_replica_logits(jnp.asarray(trep.numpy()),
                                                 jr), 1e-5)
        for t, j in zip(tree_leaves(tc), jax.tree.leaves(jc)):
            _within_ulp(t, j)


def _identical_honest(tcfg, n, f):
    """n replicas, the honest ones one model, replicas 0 and 1 its
    embedding table x 1e4 and x -1e4 (f = 2) or replica 0 x 1e4 (f = 1)."""
    honest = TMD.init_model(tcfg, seed=7, device="cpu")
    reps = []
    for i in range(n):
        p = honest
        if i < f:
            p = dict(honest, embed={"table": honest["embed"]["table"]
                                    * (1e4 if i == 0 else -1e4)})
        reps.append(p)
    return honest, tree_map(lambda *xs: torch.stack(xs), *reps)


def test_identical_honest_replicas_fuse_to_the_honest_logits_bit_for_bit():
    """bf16 activations: the fused prefill and decode logits are the
    honest model's bit for bit, the byzantine mass 0, and the greedy tokens
    those of ``generate`` on the honest parameters."""
    _, tcfg = _cfgs("bfloat16")
    honest, stack = _identical_honest(tcfg, N, F)
    rcfg = RobustConfig(n_workers=N, f=F, gar="multi_bulyan",
                        use_kernels=True)
    backend = TAPI.AggregatorBackend.for_config(rcfg)
    prompt = torch.from_numpy(_tokens((B, 8), 13))
    new = 4
    outs = [TMD.prefill_fn(tree_map(lambda t: t[i], stack), tcfg,
                           {"tokens": prompt}, chunk_q=8,
                           cache_len=8 + new) for i in range(N)]
    reps = torch.stack([lg for lg, _ in outs])
    caches = tree_map(lambda *xs: torch.stack(xs), *[c for _, c in outs])
    want, hcache = TMD.prefill_fn(honest, tcfg, {"tokens": prompt},
                                  chunk_q=8, cache_len=8 + new)
    step = TSV.make_robust_serve_step(tcfg, rcfg, backend=backend)
    fused = TSV.aggregate_replica_logits(reps, rcfg, backend)
    tokens = []
    for t in range(new):
        assert fused.dtype == torch.bfloat16
        assert torch.equal(fused, want), t
        plan, _ = backend.plan_stats(reps)
        assert float(plan.diagnostics()["byz_mass"]) == 0.0
        tok = torch.argmax(fused, dim=-1).int()
        tokens.append(tok)
        if t + 1 < new:
            reps = torch.stack([TMD.decode_fn(
                tree_map(lambda x: x[i], stack), tcfg, tok,
                tree_map(lambda x: x[i], caches), 8 + t)[0]
                for i in range(N)])
            fused, caches = step(stack, caches, tok, 8 + t)
            want, hcache = TMD.decode_fn(honest, tcfg, tok, hcache, 8 + t)
    ref = TSV.generate(honest, tcfg, prompt, new, chunk_q=8)
    assert torch.equal(torch.stack(tokens, dim=1), ref)


def test_broadcast_cache_stack_gives_what_real_copies_give():
    """A replica stack of caches built by ``expand`` shares one storage;
    the step writes out of place, so it gives the logits and caches of
    real copies and leaves the shared cache as it was."""
    _, tcfg = _cfgs()
    n, f = 7, 1
    _, stack = _identical_honest(tcfg, n, f)
    stack = tree_map(lambda t: t.clone(), stack)
    stack["groups"]["l0"]["mlp"]["in"]["w"][2:] *= 1.01     # distinct
    rcfg = RobustConfig(n_workers=n, f=f, gar="multi_bulyan")
    prompt = torch.from_numpy(_tokens((B, 8), 14))
    _, one = TMD.prefill_fn(tree_map(lambda t: t[3], stack), tcfg,
                            {"tokens": prompt}, chunk_q=8, cache_len=12)
    before = tree_map(lambda t: t.clone(), one)
    shared = tree_map(lambda t: t[None].expand((n,) + t.shape), one)
    copies = tree_map(lambda t: t[None].repeat((n,) + (1,) * t.dim()), one)
    step = TSV.make_robust_serve_step(tcfg, rcfg)
    for t in range(2):
        tok = torch.from_numpy(_tokens((B,), 40 + t))
        a, shared = step(stack, shared, tok, 8 + t)
        b, copies = step(stack, copies, tok, 8 + t)
        assert torch.equal(a, b)
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(shared),
                                                     tree_leaves(copies)))
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(one),
                                                 tree_leaves(before)))


def test_serve_step_is_decode_fn():
    _, tcfg = _cfgs()
    params = TMD.init_model(tcfg, seed=0, device="cpu")
    prompt = torch.from_numpy(_tokens((B, 8), 15))
    _, cache = TMD.prefill_fn(params, tcfg, {"tokens": prompt}, chunk_q=8)
    tok = torch.from_numpy(_tokens((B,), 16))
    a = TSV.make_serve_step(tcfg, window=0)(params, cache, tok, 8)
    b = TMD.decode_fn(params, tcfg, tok, cache, 8)
    assert torch.equal(a[0], b[0])


def test_apply_lm_tail_readout_is_the_full_readouts_tail():
    """``apply_lm``'s ``logits_tail`` reads out the last rows only (another
    matrix shape, so within 1e-6 relative of the full readout's rows)."""
    _, tcfg = _cfgs()
    params = TMD.init_model(tcfg, seed=0, device="cpu")
    tok = torch.from_numpy(_tokens((B, S), 17))
    full, _ = TT.apply_lm(params, tcfg, tok)
    tail, _ = TT.apply_lm(params, tcfg, tok, logits_tail=3)
    assert tuple(tail.shape) == (B, 3, tcfg.vocab_size)
    _close(tail, full[:, -3:], 1e-6)


@pytest.mark.parametrize("flags", [[], ["--window", "16", "--sample",
                                        "categorical"]],
                         ids=["full", "window"])
def test_serving_example_runs(capsys, flags):
    """``examples/robust_serving_torch.py`` on the CPU: its lines and a
    (batch, new_tokens) int32 result in the vocabulary."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "robust_serving_torch.py")
    spec = importlib.util.spec_from_file_location("robust_serving_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--device", "cpu", "--batch", "3", "--prompt-len", "24",
                    "--new-tokens", "5"] + flags)
    text = capsys.readouterr().out
    assert out.dtype == torch.int32 and tuple(out.shape) == (3, 5)
    assert bool(((out >= 0) & (out < 512)).all())
    assert "[serve] qwen2-1.5b-smoke: 1,313,024 params, batch=3" in text
    assert "[serve] 3x5 tokens in " in text
    assert text.count("[serve] seq ") == 3
