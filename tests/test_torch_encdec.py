"""Port parity of the encoder-decoder family (``models/encdec.py``):
whisper-tiny reduced (2 encoder and 2 decoder layers, d_model 256, 16
frames, vocab 512) against the JAX package on the CPU, and within the port.

Both sides start from the JAX-initialised parameters (``params_from_jax``)
and take the same numpy inputs.  The fp32 runs set ``dtype="float32"`` on
the port and widen the JAX package's two bf16 casts: the embedding's (as
the other parity files do) and ``encode``'s cast of the frames, which this
file patches inside the test (``repro.models.encdec`` sees a ``jnp`` whose
``bfloat16`` is ``float32``; nothing in the JAX package changes).
Tolerances: the config fields, the tree's key paths, shapes and leaf
count and the parameter counts exactly; the encoder memory within 1e-5
relative (``_close``: relative to each entry and to the largest |want|);
the prefill and decode logits within 1e-4 relative, the self-attention
caches within one bf16 ulp (at most 0.1 % of a prefill's entries
differing), the cross K/V within 1e-5 relative; ``generate``'s greedy
tokens equal to JAX's where every step's top-2 gap exceeds 1e-3 x max
|logit|; the robust ensemble's selections exact and its fused logits
within 1e-5 relative of JAX's aggregation of the same replica logits.
Within the port (bf16 activations) prefill and decode against the growing
forward within JAX's ``TOL = 5e-2``.  The loss and its gradients are held
to JAX's in ``tests/test_torch_archs.py`` (every architecture), one
robust stacked step here with ``tests/test_torch_archs_step.py``'s bounds.
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
from repro.configs.base import RobustConfig as JRobust
from repro.core import api as JAPI
from repro.dist import serving as JSV
from repro.models import encdec as JED
from repro.models import modules as JM
from repro_torch import models as TMD
from repro_torch.configs import RobustConfig, get_config
from repro_torch.core import api as TAPI
from repro_torch.dist import serving as TSV
from repro_torch.launch import serve, train
from repro_torch.models import encdec as TED
from repro_torch.tree import tree_items, tree_leaves, tree_map

from test_torch_archs_step import step_matches_jax

torch.set_num_threads(1)

NAME = "whisper-tiny"
B, S = 2, 8
TOL = 5e-2                  # tests/test_serving.py's decode-vs-forward bound
BF16_ULP = 2.0 ** -7
N, F = 11, 2


class _WideNumpy:
    """``jax.numpy`` with ``bfloat16`` read as ``float32``."""
    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def fp32_jax(monkeypatch):
    """fp32 activations in the JAX package: the embedding's cast and
    ``encode``'s cast of the frames widened."""
    monkeypatch.setattr(JM, "embedding_apply", functools.partial(
        JM.embedding_apply, dtype=jnp.float32))
    monkeypatch.setattr(JED, "jnp", _WideNumpy())


def _cfgs(dtype="float32"):
    return jget(NAME).reduced(), dataclasses.replace(
        get_config(NAME).reduced(), dtype=dtype)


def _params(jcfg, seed=0):
    jp = JMD.init_model(jax.random.key(seed), jcfg)
    return jp, TMD.params_from_jax(jax.tree.map(np.asarray, jp),
                                   device="cpu")


def _tokens(shape, seed, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _frames(cfg, seed, b=B):
    return np.random.default_rng(seed).normal(
        size=(b, cfg.n_frames, cfg.d_model)).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, rel):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * float(np.max(np.abs(want))))


def _within_ulp(got, want, max_share=None):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=BF16_ULP,
                               atol=1e-6 * float(np.max(np.abs(want))))
    if max_share is not None:
        assert np.mean(got != want) <= max_share


def _jcache_np(cache):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), cache)


def _same_cache(got, want):
    """The port's cache against JAX's: the self caches within a bf16 ulp,
    the cross K/V (JAX's tuple, the port's dict) within 1e-5."""
    for t, j in zip(tree_leaves(got["self"]), jax.tree.leaves(want["self"])):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == j.shape
        _within_ulp(t, j, max_share=1e-3)
    for key, j in zip(("k", "v"), want["cross"]):
        assert tuple(got["cross"][key].shape) == j.shape
        _close(got["cross"][key], j, 1e-5)


# ------------------------------------------------------------ the model
def test_whisper_config_tree_and_count_at_full_size():
    """The published widths: 56,378,112 parameters in 41 leaves, the
    port's own init on JAX's key paths and shapes (JAX's by shape only)."""
    tcfg, jcfg = get_config(NAME), jget(NAME)
    assert tcfg.is_encdec and tcfg.family == "audio"
    assert (tcfg.n_layers, tcfg.n_encoder_layers, tcfg.n_frames) == (4, 4,
                                                                    1500)
    assert tcfg.param_count() == jcfg.param_count() == 56_378_112
    shapes = jax.eval_shape(lambda: JMD.init_model(jax.random.key(0), jcfg))
    want = [(tuple(k.key for k in path), tuple(v.shape)) for path, v in
            jax.tree_util.tree_flatten_with_path(shapes)[0]]
    tp = TMD.init_model(tcfg, seed=0, device="cpu")
    got = [(path, tuple(v.shape)) for path, v in tree_items(tp)]
    assert got == want and len(got) == 41
    assert sum(v.numel() for v in tree_leaves(tp)) == 56_378_112
    assert all(v.dtype == torch.float32 for v in tree_leaves(tp))


def test_reduced_config_is_jax_reduced():
    t, j = get_config(NAME).reduced(), jget(NAME).reduced()
    assert (t.n_layers, t.n_encoder_layers, t.n_frames) == (2, 2, 16)
    assert (t.n_encoder_layers, t.n_frames) == (j.n_encoder_layers,
                                                j.n_frames)
    assert t.param_count() == j.param_count()


def test_sinusoidal_positions_match_jax():
    """The same angles; sin / cos of each library round apart by an fp32
    ulp at most (1.2e-7 near 1)."""
    from repro_torch.models import modules as TM
    got = TM.sinusoidal_positions(37, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        JM.sinusoidal_positions(37, 64)), rtol=0, atol=1.2e-7)


def test_encode_matches_jax(fp32_jax):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    fr = _frames(tcfg, 1)
    want = JED.encode(jp, jcfg, jnp.asarray(fr), chunk_q=8)
    got = TED.encode(tp, tcfg, torch.from_numpy(fr), chunk_q=8)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _close(got, want, 1e-5)


def test_encode_casts_frames_to_the_activation_type():
    """bf16 activations (the config's own type): the memory is bf16, and
    the frames' cast is the first thing encode does, as in JAX."""
    _, tcfg = _cfgs("bfloat16")
    tp = TMD.init_model(tcfg, seed=0, device="cpu")
    fr = torch.from_numpy(_frames(tcfg, 2))
    mem = TED.encode(tp, tcfg, fr)
    assert mem.dtype == torch.bfloat16
    assert torch.equal(mem, TED.encode(tp, tcfg, fr.to(torch.bfloat16)))


def test_one_robust_stacked_step_matches_jax(fp32_jax):
    """11 workers under ``inf``, f = 2, multi-Bulyan, SGD momentum: the
    per-worker losses, the selected workers (exact), the byzantine mass 0
    and the updated parameters (``test_torch_archs_step.assert_step_close``).
    The per-worker selection mass is the mean of the plan's θ = 5 rows of
    w_agr; jitted ``jnp.mean`` and ``torch.mean`` round that mean apart by
    an ulp for most such rows (on this batch 2 of 11 entries), so it is
    held within 1 ulp here."""
    step_matches_jax(NAME, selection_ulps=1)


# ---------------------------------------------------------------- serving
@pytest.mark.parametrize("window", [0, 4])
def test_prefill_and_decode_match_jax(fp32_jax, window):
    """Prefill's logits and cache, then two decode steps from JAX's prefill
    cache carried across (``cache_from_jax``, the cross K/V in fp32 here),
    each side carrying its own updated cache into the second step."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    tok, fr = _tokens((B, S), 3), _frames(tcfg, 4)
    want_l, jc = JMD.prefill_fn(
        jp, jcfg, {"tokens": jnp.asarray(tok), "frames": jnp.asarray(fr)},
        window=window, chunk_q=S, cache_len=S + 4)
    got_l, tc = TMD.prefill_fn(
        tp, tcfg, {"tokens": torch.from_numpy(tok),
                   "frames": torch.from_numpy(fr)},
        window=window, chunk_q=S, cache_len=S + 4)
    assert tuple(got_l.shape) == (B, jcfg.vocab_size)
    _close(got_l, want_l, 1e-4)
    _same_cache(tc, jc)
    tc = TMD.cache_from_jax(_jcache_np(jc), device="cpu")
    for step in range(2):
        nxt = _tokens((B,), 10 + step)
        want, jc = JMD.decode_fn(jp, jcfg, jnp.asarray(nxt), jc,
                                 jnp.int32(S + step), window=window)
        got, tc = TMD.decode_fn(tp, tcfg, torch.from_numpy(nxt), tc,
                                S + step, window=window)
        _close(got, want, 1e-4)
    _same_cache(tc, jc)


def test_init_cache_matches_jax_layout(fp32_jax):
    """``init_cache_fn(memory=)``: empty bf16 self caches beside the
    memory's cross K/V, stacked over the decoder layers."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    fr = _frames(tcfg, 5)
    jmem = JED.encode(jp, jcfg, jnp.asarray(fr))
    tmem = TED.encode(tp, tcfg, torch.from_numpy(fr))
    want = JMD.init_cache_fn(jp, jcfg, B, 12, memory=jmem)
    got = TMD.init_cache_fn(tp, tcfg, B, 12, memory=tmem)
    assert all(not t.any() for t in tree_leaves(got["self"]))
    _same_cache(got, want)
    with pytest.raises(ValueError, match="encoder memory"):
        TMD.init_cache_fn(tp, tcfg, B, 12)


@pytest.mark.parametrize("window", [0, 4])
def test_prefill_decode_matches_forward(window):
    """Within the port (bf16 activations), as tests/test_serving.py: the
    prefill's logits are the forward's last row, each decode step's the
    forward's over the grown prompt."""
    _, tcfg = _cfgs("bfloat16")
    params = TMD.init_model(tcfg, seed=0, device="cpu")
    fr = torch.from_numpy(_frames(tcfg, 6)).to(torch.bfloat16)
    cur = {"tokens": torch.from_numpy(_tokens((B, S), 7)), "frames": fr}
    last, cache = TMD.prefill_fn(params, tcfg, cur, chunk_q=S,
                                 window=window)
    full = TMD.forward_fn(params, tcfg, cur, chunk_q=S, window=window)
    assert torch.equal(last, full[:, -1])
    for step in range(3):
        tok = torch.from_numpy(_tokens((B,), 20 + step))
        cur = {"tokens": torch.cat([cur["tokens"], tok[:, None]], dim=1),
               "frames": fr}
        want = TMD.forward_fn(params, tcfg, cur, chunk_q=1,
                              window=window)[:, -1]
        got, cache = TMD.decode_fn(params, tcfg, tok, cache, S + step,
                                   window=window)
        np.testing.assert_allclose(_np(got), _np(want), atol=TOL, rtol=0)


def test_generate_with_frames_matches_jax(fp32_jax):
    """``generate(extra_batch={"frames": ...})``: the memory takes no cache
    slots, so decoding starts at the prompt's length; greedy tokens equal
    JAX's (every step's top-2 gap checked), the logits of JAX's tokens fed
    back within 1e-4."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=4)
    prompt, fr = _tokens((B, S), 8), _frames(tcfg, 9)
    new = 5
    want = np.asarray(JSV.generate(jp, jcfg, jnp.asarray(prompt), new,
                                   chunk_q=S, extra_batch={
                                       "frames": jnp.asarray(fr)}))
    got = TSV.generate(tp, tcfg, torch.from_numpy(prompt), new, chunk_q=S,
                       extra_batch={"frames": torch.from_numpy(fr)})
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, new)
    jb = {"tokens": jnp.asarray(prompt), "frames": jnp.asarray(fr)}
    tb = {"tokens": torch.from_numpy(prompt), "frames": torch.from_numpy(fr)}
    jl, jc = JMD.prefill_fn(jp, jcfg, jb, chunk_q=S, cache_len=S + new)
    tl, tc = TMD.prefill_fn(tp, tcfg, tb, chunk_q=S, cache_len=S + new)
    gaps_ok = True
    for t in range(new):
        top2 = np.sort(_np(jl), axis=-1)[:, -2:]
        gaps_ok &= bool(np.all(top2[:, 1] - top2[:, 0]
                               > 1e-3 * np.max(np.abs(_np(jl)))))
        _close(tl, jl, 1e-4)
        if t + 1 < new:
            tok = want[:, t]
            jl, jc = JMD.decode_fn(jp, jcfg, jnp.asarray(tok), jc,
                                   jnp.int32(S + t))
            tl, tc = TMD.decode_fn(tp, tcfg, torch.tensor(tok), tc, S + t)
    assert gaps_ok
    np.testing.assert_array_equal(got.numpy(), want)


def test_robust_ensemble_matches_jax(fp32_jax):
    """11 replicas of distinct seeds, replica 0's lm_head x 1e4, each
    with its own cross K/V: two ensemble steps from JAX's caches carried
    across.  Every replica's logits within 1e-4 of JAX's, the plans exact,
    the corrupted replica unselected, the fused logits the port's
    aggregation of its replica logits bit for bit and within 1e-5 relative
    of JAX's aggregation of them."""
    jcfg, tcfg = _cfgs()
    reps = []
    for i in range(N):
        p = JMD.init_model(jax.random.key(100 + i), jcfg)
        if i == 0:
            p = dict(p, lm_head={"w": p["lm_head"]["w"] * 1e4})
        reps.append(p)
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs), *reps)
    tstack = TMD.params_from_jax(jax.tree.map(np.asarray, jstack),
                                 device="cpu")
    jr = JRobust(n_workers=N, f=F, gar="multi_bulyan", use_pallas=True)
    tr = RobustConfig(n_workers=N, f=F, gar="multi_bulyan")
    batch = {"tokens": jnp.asarray(_tokens((B, S), 12)),
             "frames": jnp.asarray(_frames(tcfg, 13))}
    _, jc = jax.vmap(lambda p: JMD.prefill_fn(
        p, jcfg, batch, chunk_q=S, cache_len=S + 4))(jstack)
    jstep = JSV.make_robust_serve_step(jcfg, jr)
    tstep = TSV.make_robust_serve_step(tcfg, tr)
    jb = JAPI.AggregatorBackend.for_config(jr)
    tb = TAPI.AggregatorBackend.for_config(tr)
    for step in range(2):
        tc = TMD.cache_from_jax(_jcache_np(jc), device="cpu")
        tok = _tokens((B,), 30 + step)
        jrep, _ = jax.vmap(lambda p, c: JMD.decode_fn(
            p, jcfg, jnp.asarray(tok), c, jnp.int32(S + step)))(jstack, jc)
        trep = torch.stack([TMD.decode_fn(
            tree_map(lambda t: t[i], tstack), tcfg, torch.from_numpy(tok),
            tree_map(lambda t: t[i], tc), S + step)[0] for i in range(N)])
        for i in range(N):
            _close(trep[i], jrep[i], 1e-4)
        tplan = tb.plan_stats(trep)[0]
        jplan = jb.plan_stats(jrep)[0]
        assert tplan.kind == jplan.kind and tplan.beta == jplan.beta
        for key in ("w_ext", "w_agr"):
            np.testing.assert_array_equal(getattr(tplan, key).numpy(),
                                          np.asarray(getattr(jplan, key)))
        assert float(tplan.selection_weights()[0]) == 0.0
        _, jc = jstep(jstack, jc, jnp.asarray(tok), jnp.int32(S + step))
        got, tc = tstep(tstack, tc, torch.from_numpy(tok), S + step)
        assert torch.equal(got, TSV.aggregate_replica_logits(trep, tr))
        _close(got, JSV.aggregate_replica_logits(jnp.asarray(trep.numpy()),
                                                 jr), 1e-5)
        assert torch.equal(tc["cross"]["k"], TMD.cache_from_jax(
            _jcache_np(jc), device="cpu")["cross"]["k"])


# -------------------------------------------------------------- launchers
@pytest.mark.parametrize("trainer", ["stream_block", "stream_global"])
def test_streaming_trainers_refuse_encdec_before_the_model(capsys,
                                                          trainer):
    """As the JAX launcher: an encoder-decoder trains on the stacked
    trainer only, refused before anything is built."""
    with pytest.raises(SystemExit, match="only the stacked trainer"):
        train.run(["--device", "cpu", "--reduced", "--arch", NAME,
                   "--trainer", trainer])
    assert "[train] arch" not in capsys.readouterr().out


def test_train_cli_runs_whisper(capsys):
    """``launch/train.py --arch whisper-tiny --reduced --device cpu``: two
    steps under ``inf``, finite losses, byzantine mass 0, the frames of
    each step from ``--seed`` (a second run gives the same records)."""
    argv = ["--device", "cpu", "--reduced", "--arch", NAME, "--steps", "2",
            "--seq", "8", "--attack", "inf"]
    _, hist = train.run(argv)
    assert len(hist) == 2
    assert all(np.isfinite(r["loss"]) and r["byz_mass"] == 0.0
               for r in hist)
    text = capsys.readouterr().out
    cfg = get_config(NAME).reduced()
    assert f"params={cfg.param_count():,}" in text
    _, again = train.run(argv)
    assert [r["loss"] for r in again] == [r["loss"] for r in hist]


def test_train_frames_come_from_the_seed_and_the_step():
    args = train.parse_args(["--device", "cpu", "--reduced", "--arch", NAME,
                             "--seq", "8"])
    cfg = get_config(NAME).reduced()
    batches = train.worker_batches(args, cfg, torch.device("cpu"))
    b0, b1 = next(batches), next(batches)
    assert b0["frames"].dtype == torch.bfloat16
    assert tuple(b0["frames"].shape) == (11, 2, 16, 256)
    from repro_torch.core.attacks import fold_seed
    want = TMD.frames(cfg, 22, fold_seed(0, TMD.FRAMES_STREAM + 1), "cpu")
    assert torch.equal(b1["frames"].reshape(22, 16, 256), want)
    assert not torch.equal(b0["frames"], b1["frames"])


def test_serve_cli_runs_whisper(capsys):
    out = serve.run(["--device", "cpu", "--reduced", "--arch", NAME,
                     "--batch", "2", "--prompt-len", "8", "--new-tokens",
                     "4"])
    tok = out["tokens"]
    assert tuple(tok.shape) == (2, 4) and tok.dtype == torch.int32
    assert bool(((tok >= 0) & (tok < 512)).all())
    assert tuple(out["extra"]["frames"].shape) == (2, 16, 256)
    cfg = get_config(NAME).reduced()
    text = capsys.readouterr().out
    assert f"[serve] arch={cfg.name} params={cfg.param_count():,}" in text
