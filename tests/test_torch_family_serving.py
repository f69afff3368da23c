"""Serving parity of the MoE, SSM, hybrid and VLM families (reduced
qwen3-moe-30b-a3b, falcon-mamba-7b, jamba-1.5-large-398b, internvl2-1b)
against the JAX package on the CPU, and within the port.

The same JAX-initialised parameters on both sides (``params_from_jax``),
inputs from numpy seeds.  Within the port (bf16 activations), prefill and
two decode steps against the growing forward within JAX's ``TOL = 5e-2``
(``tests/test_serving.py``; window 0 and 8, the SSM model at 0 only, as
there).  Against JAX (fp32 activations, the caches bf16 for attention and
fp32 for mamba on both sides): the cache layout and types exactly, the
prefill logits and the decode logits from JAX's own prefill cache carried
across (``cache_from_jax``) within 1e-4 relative (``_close``: relative to
each entry and to the largest |want|), and ``generate``'s greedy tokens
with a VLM prefix equal to JAX's.
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
from repro.dist import serving as JSV
from repro.models import modules as JM
from repro_torch import models as TMD
from repro_torch.configs import get_config
from repro_torch.dist import serving as TSV
from repro_torch.launch import serve
from repro_torch.tree import tree_items, tree_leaves

torch.set_num_threads(1)

B, S = 2, 12
TOL = 5e-2                  # tests/test_serving.py's decode-vs-forward bound
FAMILIES = ("qwen3-moe-30b-a3b", "falcon-mamba-7b", "jamba-1.5-large-398b",
            "internvl2-1b")
CASES = [(name, w) for name in FAMILIES for w in (0, 8)
         if not (w and name == "falcon-mamba-7b")]


@pytest.fixture
def fp32_jax(monkeypatch):
    """The JAX package casts activations to bf16 at the embedding; the fp32
    parity runs cast to fp32 there instead."""
    monkeypatch.setattr(JM, "embedding_apply", functools.partial(
        JM.embedding_apply, dtype=jnp.float32))


def _cfgs(name, dtype="float32"):
    return jget(name).reduced(), dataclasses.replace(
        get_config(name).reduced(), dtype=dtype)


def _params(jcfg, seed=0):
    jp = JMD.init_model(jax.random.key(seed), jcfg)
    return jp, TMD.params_from_jax(jax.tree.map(np.asarray, jp),
                                   device="cpu")


def _batch(cfg, seed, batch=B, seq=S):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(
        np.int32)}
    if cfg.n_patches:
        out["prefix_embeds"] = rng.normal(
            size=(batch, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, rel):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * float(np.max(np.abs(want))))


@pytest.mark.parametrize("name,window", CASES)
def test_init_cache_matches_jax_layout(name, window):
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(jcfg)
    want = JMD.init_cache_fn(jp, jcfg, B, 20, window=window)
    got = TMD.init_cache_fn(tp, tcfg, B, 20, window=window)
    jl = jax.tree_util.tree_flatten_with_path(want)[0]
    tl = list(tree_items(got))
    assert [path for path, _ in tl] == [tuple(k.key for k in p)
                                        for p, _ in jl]
    for (path, t), (_, j) in zip(tl, jl):
        assert tuple(t.shape) == tuple(j.shape)
        assert str(t.dtype).split(".")[-1] == str(j.dtype), path
        assert not bool(t.any())


@pytest.mark.parametrize("name,window", CASES)
def test_prefill_and_decode_match_jax(fp32_jax, name, window):
    """Prefill logits and the cache's layout and types against JAX's;
    then two decode steps from JAX's cache carried across, each side
    carrying its own updated cache into the second step."""
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(jcfg)
    b = _batch(tcfg, seed=1)
    cache_len = S + tcfg.n_patches + 4
    want_l, jc = JMD.prefill_fn(jp, jcfg, _jb(b), window=window, chunk_q=S,
                                cache_len=cache_len)
    got_l, tc = TMD.prefill_fn(tp, tcfg, _tb(b), window=window, chunk_q=S,
                               cache_len=cache_len)
    _close(got_l, want_l, 1e-4)
    for (path, t), j in zip(tree_items(tc), jax.tree.leaves(jc)):
        assert tuple(t.shape) == tuple(j.shape), path
        assert str(t.dtype).split(".")[-1] == str(j.dtype), path
    tc = TMD.cache_from_jax(jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)), jc), device="cpu")
    pos = S + tcfg.n_patches
    for step in range(2):
        nxt = np.random.default_rng(10 + step).integers(
            0, tcfg.vocab_size, (B,)).astype(np.int32)
        want, jc = JMD.decode_fn(jp, jcfg, jnp.asarray(nxt), jc,
                                 jnp.int32(pos + step), window=window)
        got, tc = TMD.decode_fn(tp, tcfg, torch.from_numpy(nxt), tc,
                                pos + step, window=window)
        _close(got, want, 1e-4)


@pytest.mark.parametrize("name,window", CASES)
def test_prefill_decode_matches_forward(name, window):
    """Within the port (bf16 activations), as tests/test_serving.py."""
    _, tcfg = _cfgs(name, "bfloat16")
    params = TMD.init_model(tcfg, seed=0, device="cpu")
    batch = _tb(_batch(tcfg, seed=4))
    last, cache = TMD.prefill_fn(params, tcfg, batch, chunk_q=S,
                                 window=window)
    full = TMD.forward_fn(params, tcfg, batch, chunk_q=S, logits_tail=1,
                          window=window)[:, -1]
    np.testing.assert_allclose(_np(last), _np(full), atol=TOL, rtol=0)
    cur = batch
    pos = S + tcfg.n_patches
    for step in range(2):
        tok = torch.from_numpy(np.random.default_rng(20 + step).integers(
            0, tcfg.vocab_size, (B,)).astype(np.int32))
        cur = dict(cur, tokens=torch.cat([cur["tokens"], tok[:, None]], 1))
        want = TMD.forward_fn(params, tcfg, cur, chunk_q=1, logits_tail=1,
                              window=window)[:, -1]
        got, cache = TMD.decode_fn(params, tcfg, tok, cache, pos + step,
                                   window=window)
        np.testing.assert_allclose(_np(got), _np(want), atol=TOL, rtol=0)


def test_prefill_is_the_forwards_last_row_bit_for_bit():
    """Prefill and the forward share the pass: the MoE model's last-row
    logits are the same bits (the gate the chip run holds at full width,
    where tokens drop)."""
    _, tcfg = _cfgs("qwen3-moe-30b-a3b", "bfloat16")
    params = TMD.init_model(tcfg, seed=3, device="cpu")
    batch = _tb(_batch(tcfg, seed=5))
    last, _ = TMD.prefill_fn(params, tcfg, batch, chunk_q=S)
    full = TMD.forward_fn(params, tcfg, batch, chunk_q=S, logits_tail=1)
    assert torch.equal(last, full[:, -1])


def test_generate_with_a_prefix_matches_jax(fp32_jax):
    """``generate`` on the VLM: the prefix takes the first cache slots and
    the decode positions start after it; greedy tokens equal JAX's."""
    jcfg, tcfg = _cfgs("internvl2-1b")
    jp, tp = _params(jcfg)
    b = _batch(tcfg, seed=6, seq=8)
    extra = {"prefix_embeds": b["prefix_embeds"]}
    want = JSV.generate(jp, jcfg, jnp.asarray(b["tokens"]), 5, chunk_q=8,
                        extra_batch=_jb(extra))
    got = TSV.generate(tp, tcfg, torch.from_numpy(b["tokens"]), 5,
                       chunk_q=8, extra_batch=_tb(extra))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", FAMILIES)
def test_serve_cli_runs(capsys, name):
    """``launch/serve.py --reduced --device cpu`` for each new family."""
    out = serve.run(["--device", "cpu", "--reduced", "--arch", name,
                     "--batch", "2", "--prompt-len", "8", "--new-tokens",
                     "4"])
    tok = out["tokens"]
    assert tuple(tok.shape) == (2, 4) and tok.dtype == torch.int32
    assert bool(((tok >= 0) & (tok < 512)).all())
    cfg = get_config(name).reduced()
    assert (out["extra"] is not None) == bool(cfg.n_patches)
    text = capsys.readouterr().out
    assert f"[serve] arch={cfg.name} params={cfg.param_count():,}" in text


def test_mamba_cache_from_jax_keeps_fp32():
    jcfg, _ = _cfgs("jamba-1.5-large-398b")
    jp, _ = _params(jcfg)
    _, jc = JMD.prefill_fn(jp, jcfg, _jb(_batch(jcfg, seed=7)), chunk_q=S)
    got = TMD.cache_from_jax(jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)), jc), device="cpu")
    for (path, t), j in zip(tree_items(got), jax.tree.leaves(jc)):
        assert str(t.dtype).split(".")[-1] == str(j.dtype), path
        np.testing.assert_array_equal(_np(t), _np(j))
    assert {path[-1] for path, _ in tree_items(got)} == {"k", "v", "conv",
                                                         "h"}
    assert len(tree_leaves(got)) == 4
