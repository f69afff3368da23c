"""The port's compressed gradient wire (``repro_torch.comm``), the K5 plain
version, the wire attacks and the trainer under a codec, held to the JAX
package on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: identity and bf16 payloads and decodes exactly; signSGD and
top-k payloads exactly (top-k inputs have no ties in magnitude, so the
tie order cannot differ); signSGD's multiplier, a mean whose summation
order differs between XLA and torch, to rtol 1e-6; QSGD exactly, given
JAX's uniforms (torch's generator cannot reproduce ``jax.random``); the
K5 plain version and encoded statistics to fp32 rtol 1e-5; the wire
attacks exactly; the 2-step trainer runs to rtol 1e-4 (the tolerance of
the uncompressed step in ``test_torch_trainer.py``).
"""
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.comm import codecs as JC
from repro.comm import transport as JT
from repro.core import api as JAPI
from repro.dist import trainer as JTR
from repro_torch.comm import codecs as TC
from repro_torch.comm import transport as TT
from repro_torch.core import api as TAPI
from repro_torch.core import attacks as TATK
from repro_torch.dist import trainer as TTR
from repro_torch.kernels import ops, ref
from repro_torch.kernels.dequant_stats import dequant_stats_cuda
from repro_torch.tree import tree_leaves

# the suite runs in several worker processes at once: one thread each
# keeps the port's many small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

KEY = jax.random.key(0)
F = 2


def _tree(n, seed=0):
    """A two-leaf stacked gradient tree as numpy, no ties in magnitude."""
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(n, 6, 9)).astype(np.float32),
            "b": {"c": rng.normal(size=(n, 77)).astype(np.float32)}}


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _ttree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _bits(a):
    """Comparable numpy view of a payload (bf16 as its 16-bit pattern)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.contiguous().view(torch.int16).numpy()
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _leaves_equal(t_tree, j_tree):
    tl, jl = tree_leaves(t_tree), jax.tree.leaves(j_tree)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        np.testing.assert_array_equal(_bits(t), _bits(j))


def _encode_both(spec, tree, key=KEY):
    """JAX encodes; the port gets the same container carried across."""
    jenc, _ = JC.get_codec(spec).encode(_jtree(tree), key=key)
    return jenc, TC.encoded_from_jax(jenc, device="cpu")


# ================================================== codec parity with JAX
@pytest.mark.parametrize("n", [3, 11])
@pytest.mark.parametrize("spec", ["identity", "bf16", "signsgd",
                                  "topk:frac=0.1"])
def test_codec_matches_jax(spec, n):
    tree = _tree(n, seed=n)
    jc, tcod = JC.get_codec(spec), TC.get_codec(spec)
    jenc, _ = jc.encode(_jtree(tree), key=KEY)
    tenc, _ = tcod.encode(_ttree(tree), seed=0)
    assert tenc.spec == jenc.spec and tenc.n == jenc.n == n
    assert tenc.shapes == jenc.shapes
    assert tenc.wire_bytes == jenc.wire_bytes
    _leaves_equal(tenc.payload, jenc.payload)
    assert (tenc.sidecar is None) == (jenc.sidecar is None)
    if spec == "signsgd":
        for t, j in zip(tree_leaves(tenc.sidecar),
                        jax.tree.leaves(jenc.sidecar)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)
    elif tenc.sidecar is not None:
        _leaves_equal(tenc.sidecar, jenc.sidecar)
    if spec != "signsgd":
        _leaves_equal(tcod.decode(tenc), jc.decode(jenc))


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("n,m", [(3, 1), (7, 33), (11, 257)])
def test_qsgd_quantize_matches_jax_encode_exactly(bits, n, m):
    """Given JAX's uniforms, the port's quantize gives JAX's int8 payload
    and multiplier exactly; a zero row (multiplier 0) and an outlier row
    take the same branch on both sides."""
    rng = np.random.default_rng(bits * 100 + m)
    x = rng.normal(size=(n, m)).astype(np.float32)
    x[0] = 0.0
    x[-1, 0] = 1e30
    key = jax.random.fold_in(KEY, bits)
    jp, jm = JC.get_codec(f"qsgd:bits={bits}").encode_leaf(jnp.asarray(x),
                                                           key)
    u = np.asarray(jax.random.uniform(key, x.shape, jnp.float32))
    tp, tm = TC.get_codec(f"qsgd:bits={bits}").quantize(
        torch.from_numpy(x), torch.from_numpy(u.copy()))
    assert tp.dtype == torch.int8 and tm.dtype == torch.float32
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_qsgd_draws_from_the_per_leaf_generator():
    """The encode draws leaf i's uniforms from leaf_generator(seed, i):
    same seed, same payload; another seed, another payload."""
    tree = _ttree(_tree(5))
    c = TC.get_codec("qsgd:bits=4")
    a, _ = c.encode(tree, seed=3)
    b, _ = c.encode(tree, seed=3)
    other, _ = c.encode(tree, seed=4)
    _leaves_equal(a.payload, b.payload)
    x = tree_leaves(tree)[1].reshape(5, -1)
    u = TC.draw_uniform(tuple(x.shape), TATK.leaf_generator("cpu", 3, 1))
    assert torch.equal(c.quantize(x, u)[0],
                       tree_leaves(a.payload)[1].reshape(5, -1))
    assert any(not torch.equal(p, q) for p, q in
               zip(tree_leaves(a.payload), tree_leaves(other.payload)))


# ====================================================== K5 plain version
K5_GRID = [(1, 1), (1, 257), (7, 100), (11, 1), (11, 257), (13, 100)]


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("n,d", K5_GRID)
def test_dequant_stats_plain_matches_pallas(n, d, dtype):
    """The plain version against the Pallas kernel in interpret mode, on
    n not a multiple of 8 (nor of the int8 / bf16 sublane tiles), d not a
    multiple of 128 and d = 1, with a negative multiplier in row 0."""
    from repro.kernels.dequant_stats import dequant_stats_pallas
    rng = np.random.default_rng(n * 1000 + d)
    mult = (rng.random(n) + 0.5).astype(np.float32) / 127.0
    mult[0] *= -100.0
    if dtype == "int8":
        p = rng.integers(-127, 128, size=(n, d)).astype(np.int8)
        jp, tp = jnp.asarray(p), torch.from_numpy(p.copy())
    else:
        x = rng.normal(size=(n, d)).astype(np.float32)
        jp = jnp.asarray(x).astype(jnp.bfloat16)
        tp = torch.from_numpy(x).to(torch.bfloat16)
    want_d, want_s = dequant_stats_pallas(jp, jnp.asarray(mult), d_tile=128,
                                          interpret=True)
    got_d, got_s = ref.dequant_stats_ref(tp, torch.from_numpy(mult))
    _close_stats(got_d, got_s, want_d, want_s)


def _close_stats(got_d, got_s, want_d, want_s, tol=1e-5):
    """fp32 tolerance for raw statistics: a raw distance is formed as
    sq_i + sq_j - 2 g_ij, so its rounding error scales with the norms
    (the diagonal, exactly 0 in real arithmetic, is pure rounding)."""
    want_d = np.asarray(want_d, np.float64)
    want_s = np.asarray(want_s, np.float64)
    scale = max(1.0, float(np.max(np.abs(want_d))),
                2.0 * float(np.max(want_s)))
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=tol,
                               atol=tol * scale)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=tol,
                               atol=tol * max(1.0, float(np.max(want_s))))


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
def test_dequant_stats_plain_equals_k1_plain_on_decoded(dtype):
    """The plain version is K1's plain version on payload.float() * mult,
    bit for bit, also across its column pieces."""
    rng = np.random.default_rng(5)
    p = torch.from_numpy(rng.normal(size=(11, 3001)).astype(np.float32)
                         * 50).to(dtype)
    mult = torch.from_numpy((rng.random(11) - 0.3).astype(np.float32))
    dec = p.float() * mult[:, None]
    for chunk in (1000, 1 << 20):
        got = ref.dequant_stats_ref(p, mult, chunk=chunk)
        want = ref.pairwise_stats_ref(dec, chunk=chunk)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_ops_dequant_stats_takes_plain_version_on_cpu():
    ops.reset_launch_counts()
    p = torch.randint(-127, 128, (11, 100), dtype=torch.int8)
    mult = torch.rand(11)
    for a, b in zip(ops.dequant_stats(p, mult),
                    ref.dequant_stats_ref(p, mult)):
        assert torch.equal(a, b)
    assert ops.launch_counts() == {"pairwise_stats": 0, "fused_select": 0,
                                   "dequant_stats": 0, "coord_select": 0,
                                   "pairwise_stats_rect": 0,
                                   "dequant_stats_rect": 0,
                                   "pairwise_sqdist": 0}


def test_dequant_stats_rejects_bad_inputs():
    p = torch.zeros((5, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match=r"mult must be \(5,\)"):
        ops.dequant_stats(p, torch.ones(4))
    with pytest.raises(ValueError, match="payload must be"):
        ops.dequant_stats(p.to(torch.int32), torch.ones(5))
    with pytest.raises(ValueError, match=r"\(n, d\)"):
        ops.dequant_stats(torch.zeros(5, dtype=torch.int8), torch.ones(5))
    with pytest.raises(ValueError, match="CUDA"):
        dequant_stats_cuda(p, torch.ones(5))


# ==================================================== encoded statistics
@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("spec", ["identity", "bf16", "qsgd:bits=8",
                                  "signsgd", "topk:frac=0.2"])
def test_encoded_pairwise_stats_matches_jax(spec, use_kernels):
    """On a container JAX encoded and carried across as numpy."""
    jenc, tenc = _encode_both(spec, _tree(11, seed=4))
    want_d, want_s = JC.encoded_pairwise_stats(jenc)
    got_d, got_s = TC.encoded_pairwise_stats(tenc, use_kernels=use_kernels)
    _close_stats(got_d, got_s, want_d, want_s)


@pytest.mark.parametrize("spec", ["bf16", "qsgd:bits=8", "topk:frac=0.2"])
def test_compute_stats_on_container_equals_decoded(spec):
    """core.api on the container == on the decoded stack, bit for bit
    (the plain versions decode in the same pieces); the apply accepts the
    container."""
    tree = _ttree(_tree(11, seed=6))
    c = TC.get_codec(spec)
    enc, _ = c.encode(tree, seed=1)
    dec = c.decode(enc)
    for uk in (False, True):
        se = TAPI.compute_stats(enc, F, needs_dists=True, needs_norms=True,
                                use_kernels=uk)
        sd = TAPI.compute_stats(dec, F, needs_dists=True, needs_norms=True,
                                use_kernels=uk)
        assert se.n == 11
        assert torch.equal(se.dists, sd.dists)
        assert torch.equal(se.sq_norms, sd.sq_norms)
    for a, b in zip(tree_leaves(TAPI.aggregate_tree(enc, F)),
                    tree_leaves(TAPI.aggregate_tree(dec, F))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("spec", ["identity", "bf16", "qsgd:bits=8",
                                  "signsgd", "topk:frac=0.2"])
def test_decode_into_the_stack_changes_no_value(spec):
    tree = _ttree(_tree(7, seed=2))
    c = TC.get_codec(spec)
    enc, _ = c.encode(tree, seed=0)
    want = c.decode(enc)
    out = _ttree(_tree(7, seed=9))
    got = c.decode(enc, out=out)
    assert got is out
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)


# ========================================================== wire attacks
@pytest.mark.parametrize("spec", ["identity", "bf16", "qsgd:bits=8",
                                  "signsgd", "topk:frac=0.2"])
@pytest.mark.parametrize("attack", ["scale_poison", "scale_poison:gain=50",
                                    "payload_flip"])
def test_wire_attack_matches_jax(attack, spec):
    """Both wire attacks on the same container: payload and sidecar equal
    to JAX's exactly (int8 saturation, bf16 rounding, top-k's index
    sidecar included)."""
    tree = _tree(11, seed=8)
    tree["b"]["c"][F] = np.round(tree["b"]["c"][F] * 40.0)    # saturates
    jenc, tenc = _encode_both(spec, tree)
    jatt = JTR.inject_wire(jenc, F, attack, KEY)
    tatt = TTR.inject_wire(tenc, F, attack, 0)
    _leaves_equal(tatt.payload, jatt.payload)
    assert (tatt.sidecar is None) == (jatt.sidecar is None)
    if tatt.sidecar is not None:
        _leaves_equal(tatt.sidecar, jatt.sidecar)
    assert tatt.wire_bytes == tenc.wire_bytes
    # the honest container is not modified
    _leaves_equal(tenc.payload, jenc.payload)


def _honest_stack(n, d=60, seed=0):
    rng = np.random.default_rng(seed)
    return (np.ones(d) + 0.05 * rng.normal(size=(n, d))).astype(np.float32)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("attack", ["scale_poison:gain=100", "payload_flip"])
def test_wire_attacks_get_no_multi_bulyan_mass(attack, use_kernels):
    n = 11
    G = torch.from_numpy(np.concatenate([_honest_stack(F),
                                         _honest_stack(n - F, seed=1)]))
    enc, _ = TC.get_codec("qsgd:bits=8").encode(G, seed=0)
    enc = TTR.inject_wire(enc, F, attack, 0)
    stats = TAPI.compute_stats(enc, F, needs_dists=True,
                               use_kernels=use_kernels)
    plan = TAPI.get_aggregator("multi_bulyan").plan(stats)
    assert float(plan.diagnostics(stats)["byz_mass"]) == 0.0
    avg = TAPI.get_aggregator("average").plan(stats).diagnostics(stats)
    np.testing.assert_allclose(float(avg["byz_mass"]), F / n, rtol=1e-6)


def test_scale_poison_keeps_the_negative_multiplier():
    n, gain = 7, 50.0
    G = torch.from_numpy(np.concatenate([_honest_stack(F),
                                         _honest_stack(n - F, seed=1)]))
    c = TC.get_codec("qsgd:bits=8")
    enc, _ = c.encode(G, seed=0)
    poisoned = TTR.inject_wire(enc, F, f"scale_poison:gain={gain}", 0)
    assert torch.equal(poisoned.payload[0], poisoned.payload[F])
    assert float(poisoned.sidecar[0]) < 0.0
    dec = c.decode(poisoned)
    honest = c.decode(enc)[F]
    np.testing.assert_allclose(dec[0].numpy(), -gain * honest.numpy(),
                               rtol=1e-5)
    raw_k = ops.dequant_stats(poisoned.payload, poisoned.sidecar)
    raw_d = ref.pairwise_stats_ref(dec)
    for a, b in zip(raw_k, raw_d):
        assert torch.equal(a, b)


def test_wire_attack_spec_validation():
    with pytest.raises(KeyError, match="unknown wire attack"):
        TATK.get_wire_attack("garbage")
    with pytest.raises(ValueError, match="no parameter"):
        TATK.get_wire_attack("payload_flip:gain=2")
    assert TATK.is_wire_attack("scale_poison:gain=3")
    assert not TATK.is_wire_attack("sign_flip")


# ============================================================ codec laws
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_qsgd_unbiased_over_generator_seeds(bits):
    """E[decode(encode(g))] = g: the mean over many seeds stays within 3
    standard errors of the quantization step, coordinate by coordinate."""
    rng = np.random.default_rng(bits)
    g = torch.from_numpy(rng.normal(size=(5, 40)).astype(np.float32))
    c = TC.get_codec(f"qsgd:bits={bits}")
    seeds = 300
    acc = np.zeros((5, 40), np.float64)
    for s in range(seeds):
        enc, _ = c.encode(g, seed=s)
        acc += c.decode(enc).numpy().astype(np.float64)
    step = (torch.amax(torch.abs(g), dim=1) / c.levels).numpy()[:, None]
    tol = np.broadcast_to(3.0 * step / np.sqrt(seeds) + 1e-6, (5, 40))
    np.testing.assert_array_less(np.abs(acc / seeds - g.numpy()), tol)


@pytest.mark.parametrize("n,m", [(3, 1), (5, 17), (12, 90)])
def test_topk_norm_retention(n, m):
    rng = np.random.default_rng(n * 7 + m)
    x = rng.normal(size=(n, m)).astype(np.float32)
    c = TC.get_codec("topk:frac=0.25")
    k = c.row_k(m)
    enc, _ = c.encode(torch.from_numpy(x))
    dec = c.decode(enc).numpy()
    want = np.sort(x ** 2, axis=1)[:, ::-1][:, :k].sum(axis=1)
    np.testing.assert_allclose((dec ** 2).sum(axis=1), want, rtol=1e-5)
    assert np.all((dec ** 2).sum(axis=1) >= (k / m) * (x ** 2).sum(axis=1)
                  - 1e-5)


@pytest.mark.parametrize("spec", ["signsgd:ef=1", "topk:frac=0.1,ef=1",
                                  "qsgd:bits=4,ef=1"])
def test_error_feedback_telescopes(spec):
    """sum_t decode_t + e_T = sum_t g_t; encode leaves its inputs as
    they were."""
    c = TC.get_codec(spec)
    assert c.stateful
    rng = np.random.default_rng(3)
    gs = [torch.from_numpy(rng.normal(size=(4, 30)).astype(np.float32))
          for _ in range(6)]
    res = c.init_residual(gs[0])
    sent = np.zeros((4, 30), np.float64)
    total = np.zeros((4, 30), np.float64)
    for t, g in enumerate(gs):
        g0, r_in, r0 = g.clone(), res, res.clone()
        enc, res = c.encode(g, seed=t, residual=res)
        assert torch.equal(g, g0) and torch.equal(r_in, r0)
        sent += c.decode(enc).numpy().astype(np.float64)
        total += g.numpy().astype(np.float64)
    np.testing.assert_allclose(sent + res.numpy(), total, atol=1e-3)


def test_error_feedback_residual_matches_jax():
    """The signSGD residual of one ef=1 encode, against JAX's (its
    multiplier is a mean: rtol 1e-6, atol 1e-6 of the unit-scale rows)."""
    tree = _tree(5, seed=12)
    res = _tree(5, seed=13)
    _, jres = JC.get_codec("signsgd:ef=1").encode(
        _jtree(tree), key=KEY, residual=_jtree(res))
    _, tres = TC.get_codec("signsgd:ef=1").encode(
        _ttree(tree), seed=0, residual=_ttree(res))
    for t, j in zip(tree_leaves(tres), jax.tree.leaves(jres)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-6)


def test_stateless_codec_rejects_missing_residual_only_when_ef():
    g = _ttree(_tree(5))
    TC.get_codec("bf16").encode(g)
    with pytest.raises(ValueError, match="residual"):
        TC.get_codec("bf16:ef=1").encode(g)


def test_wire_bytes_ordering_and_container():
    g = _ttree(_tree(11))
    sizes = {}
    for spec in ("fp32", "bf16", "qsgd:bits=8", "signsgd"):
        enc, _ = TC.get_codec(spec).encode(g, seed=0)
        assert enc.n == 11
        assert enc.wire_bytes == 11 * enc.bytes_per_worker
        sizes[spec] = enc.wire_bytes
    assert sizes["fp32"] > sizes["bf16"] > sizes["qsgd:bits=8"] \
        > sizes["signsgd"]


@pytest.mark.parametrize("spec", ["fp32", "bf16", "qsgd:bits=8",
                                  "signsgd:ef=1", "topk:frac=0.01"])
def test_wire_stats_match_jax(spec):
    """Shape-only accounting from a parameter tree equals JAX's and the
    exact accounting off an encoded container."""
    params = {"w": np.zeros((40, 30), np.float32),
              "b": np.zeros((30,), np.float32)}
    jws = JT.wire_stats(spec, _jtree(params), n=11, chunk_bytes=1024)
    tws = TT.wire_stats(spec, _ttree(params), n=11, chunk_bytes=1024)
    assert tws.to_json() == jws.to_json()
    g = {k: torch.zeros((11,) + v.shape) for k, v in params.items()}
    c = TC.get_codec(spec)
    enc, _ = c.encode(g, seed=0, residual=c.init_residual(g)
                      if c.stateful else None)
    assert TT.gather_stats(enc, chunk_bytes=1024).to_json() == \
        tws.to_json()


def test_codec_spec_errors():
    with pytest.raises(KeyError, match="unknown codec"):
        TC.get_codec("zstd")
    with pytest.raises(ValueError, match="no parameter"):
        TC.get_codec("bf16:bits=8")
    with pytest.raises(ValueError, match="bits"):
        TC.get_codec("qsgd:bits=9")
    with pytest.raises(ValueError, match="frac"):
        TC.get_codec("topk:frac=0")
    with pytest.raises(ValueError, match="PRNG seed"):
        TC.get_codec("qsgd").encode(_ttree(_tree(4)))
    assert TC.available_codecs() == JC.available_codecs()
    assert TC.get_codec("topk:frac=0.5,ef=1").spec() == \
        JC.get_codec("topk:frac=0.5,ef=1").spec()


def test_slice_workers_matches_jax():
    jenc, tenc = _encode_both("qsgd:bits=8", _tree(11, seed=3))
    js, ts = JC.slice_workers(jenc, 2, 7), TC.slice_workers(tenc, 2, 7)
    assert (ts.n, ts.shapes, ts.wire_bytes) == (js.n, js.shapes,
                                                js.wire_bytes)
    _leaves_equal(ts.payload, js.payload)
    _leaves_equal(ts.sidecar, js.sidecar)
    with pytest.raises(ValueError, match="bad worker slice"):
        TC.slice_workers(tenc, 5, 5)


# ======================================================= trainer parity
TINY = dict(name="tiny-qwen", family="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
            qkv_bias=True, tie_embeddings=True, rope_theta=1e6)
N, SEQ = 11, 16


@pytest.fixture
def fp32_jax(monkeypatch):
    """The JAX package casts activations to bf16 at the embedding; the
    fp32 parity runs cast to fp32 there instead."""
    from repro.models import modules as JM
    monkeypatch.setattr(JM, "embedding_apply", functools.partial(
        JM.embedding_apply, dtype=jnp.float32))


def _wire_step(codec, grads, res, rows):
    """Per leaf, the most that the fp32 noise between the two frameworks'
    gradients (about 1e-6 apart) can move one worker's wire value, over
    the worker ``rows``: one bf16 ulp, at most 2^-7 of the leaf's largest
    |value|, under bf16; a sign flip, twice the row multiplier mean|g + r|,
    under signSGD."""
    out = []
    for i, g in enumerate(tree_leaves(grads)):
        x = g[rows].reshape(g[rows].shape[0], -1).double()
        if codec.startswith("bf16"):
            out.append(2.0 ** -7 * float(torch.max(torch.abs(x))))
        else:
            r = tree_leaves(res)[i][rows]
            x = x + r.reshape(x.shape).double()
            out.append(2.0 * float(torch.max(torch.mean(torch.abs(x),
                                                         dim=1))))
    return np.asarray(out)


def _close_but_for_wire_flips(t_tree, j_tree, caps, rtol=1e-4, atol=1e-6,
                              frac=1e-3):
    """Each leaf within fp32 rtol/atol except at most max(1, frac × size)
    of its coordinates, each off by no more than its leaf's ``cap``: those
    where the two frameworks' gradients encode to different wire values (a
    bf16 rounding boundary, or a signSGD coordinate within noise of 0).
    Returns the number of such coordinates."""
    n_off = 0
    for t, j, cap in zip(tree_leaves(t_tree), jax.tree.leaves(j_tree), caps):
        j = np.asarray(j)
        diff = np.abs(t.numpy().astype(np.float64) - j)
        off = diff > atol + rtol * np.abs(j)
        k = int(np.sum(off))
        assert k <= max(1, int(np.ceil(frac * j.size))), \
            f"{k} of {j.size} coordinates of a {j.shape} leaf differ"
        if k:
            assert float(np.max(diff[off])) <= cap, \
                f"a {j.shape} leaf is off by {np.max(diff[off])} > {cap}"
        n_off += k
    return n_off


@pytest.mark.parametrize("codec,attack", [("bf16", "inf"),
                                          ("signsgd:ef=1", "payload_flip")])
def test_two_train_steps_match_jax_under_codec(fp32_jax, codec, attack):
    """Two steps of the stacked trainer under a deterministic codec, from
    the same parameters and batches: per-worker losses to rtol 1e-4, the
    same selection support (its values, means over the plan's rows, to an
    ulp), and the updated parameters and the error-feedback residual,
    carried from step to step, as :func:`_close_but_for_wire_flips`
    states.  A wire value that differs moves the aggregate by at most its
    step W, so after k steps of SGD (lr, momentum m) a parameter is off by
    at most lr (1 + m) ΣW and a residual by ΣW (1 % slack for rounding)."""
    from repro import models as JMD
    from repro.configs.base import ArchConfig as JArch
    from repro.configs.base import RobustConfig as JRobust
    from repro.data.synthetic import make_lm_batch
    from repro.optim import optimizers as JO
    from repro.optim import schedules as JS
    from repro_torch import models as TMD
    from repro_torch.configs import ArchConfig, RobustConfig
    from repro_torch.optim import optimizers as TO
    from repro_torch.optim import schedules as TS
    jcfg, tcfg = JArch(**TINY), ArchConfig(**TINY, dtype="float32")
    jparams = JMD.init_model(jax.random.key(0), jcfg)
    tparams = TMD.params_from_jax(jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    opt_j, opt_t = JO.sgd(momentum=0.9), TO.sgd(momentum=0.9)
    jstep = jax.jit(JTR.make_train_step(
        jcfg, JRobust(n_workers=N, f=F), opt_j, JS.constant(0.05),
        chunk_q=SEQ, attack=attack, codec=codec, telemetry=True))
    tstep = TTR.make_train_step(
        tcfg, RobustConfig(n_workers=N, f=F), opt_t, TS.constant(0.05),
        chunk_q=SEQ, attack=attack, codec=codec, telemetry=True)
    js = JTR.init_train_state(opt_j, jparams, n_workers=N, codec=codec)
    ts = TTR.init_train_state(opt_t, tparams, n_workers=N, codec=codec)
    assert (ts.cres is None) == (js.cres is None)
    w_honest = w_all = 0.0
    for i in range(2):
        batch = make_lm_batch(jax.random.key(10 + i), TINY["vocab_size"],
                              N, SEQ)
        batch = {k: np.asarray(v) for k, v in batch.items()}
        jb = JTR.split_workers({k: jnp.asarray(v) for k, v in batch.items()},
                               N)
        tb = TTR.split_workers({k: torch.tensor(v).long()
                                for k, v in batch.items()}, N)
        _, g = TTR.per_worker_grads(tparams, tcfg, tb, chunk_q=SEQ)
        # the inf attack's rows take no part in the aggregate
        w_honest = w_honest + _wire_step(codec, g, ts.cres, slice(F, N))
        w_all = w_all + _wire_step(codec, g, ts.cres, slice(0, N))
        jparams, js, jm = jstep(jparams, js, jb, jax.random.key(2 + i))
        tparams, ts, tm = tstep(tparams, ts, tb, 2 + i)
        np.testing.assert_allclose(tm["loss_per_worker"].numpy(),
                                   np.asarray(jm["loss_per_worker"]),
                                   rtol=1e-4)
        tsel = tm["telemetry"]["selection"].numpy()
        jsel = np.asarray(jm["telemetry"]["selection"])
        np.testing.assert_array_equal(tsel > 0, jsel > 0)
        np.testing.assert_allclose(tsel, jsel, rtol=1e-6)
        assert tm["telemetry"]["wire_bytes_per_worker"] == \
            float(jm["telemetry"]["wire_bytes_per_worker"])
        n_off = _close_but_for_wire_flips(tparams, jparams,
                                          1.01 * 0.05 * 1.9 * w_honest)
        msg = f"{codec} step {i + 1}: {n_off} parameter coordinates"
        if ts.cres is not None:
            n_off = _close_but_for_wire_flips(ts.cres, js.cres,
                                              1.01 * w_all)
            msg += f", {n_off} residual coordinates"
        print(msg + " off by a wire value")
    if ts.cres is not None:
        assert any(float(torch.max(torch.abs(r))) > 0.0
                   for r in tree_leaves(ts.cres))


@pytest.mark.parametrize("attack", ["none", "scale_poison", "payload_flip"])
@pytest.mark.parametrize("spec", ["bf16", "qsgd:bits=8", "signsgd",
                                  "topk:frac=0.2"])
def test_aggregate_of_a_container_matches_jax(spec, attack):
    """The aggregator on the same (attacked) container: the same plan
    weights exactly, the aggregate to fp32 rtol 1e-5."""
    jenc, tenc = _encode_both(spec, _tree(11, seed=21))
    if attack != "none":
        jenc = JTR.inject_wire(jenc, F, attack, KEY)
        tenc = TTR.inject_wire(tenc, F, attack, 0)
    jstats = JAPI.compute_stats(jenc, F, needs_dists=True)
    tstats = TAPI.compute_stats(tenc, F, needs_dists=True, use_kernels=True)
    jplan = JAPI.get_aggregator("multi_bulyan").plan(jstats)
    tplan = TAPI.get_aggregator("multi_bulyan").plan(tstats)
    np.testing.assert_array_equal(tplan.w_ext.numpy(),
                                  np.asarray(jplan.w_ext))
    np.testing.assert_array_equal(tplan.w_agr.numpy(),
                                  np.asarray(jplan.w_agr))
    want = JAPI.get_aggregator("multi_bulyan").apply(jplan, jenc)
    got = TAPI.get_aggregator("multi_bulyan").apply(tplan, tenc,
                                                    use_kernels=True)
    for t, j in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-6)


def test_wire_attack_needs_a_codec():
    from repro_torch.configs import ArchConfig, RobustConfig
    from repro_torch.optim import optimizers as TO
    from repro_torch.optim import schedules as TS
    with pytest.raises(ValueError, match="needs a codec"):
        TTR.make_train_step(ArchConfig(**TINY), RobustConfig(N, F),
                            TO.sgd(), TS.constant(0.1),
                            attack="scale_poison")
    with pytest.raises(KeyError, match="unknown codec"):
        TTR.make_train_step(ArchConfig(**TINY), RobustConfig(N, F),
                            TO.sgd(), TS.constant(0.1), codec="zstd")


def test_encoded_from_jax_keeps_every_field():
    jenc, tenc = _encode_both("bf16", _tree(4))
    assert isinstance(tenc, TC.EncodedGrads)
    assert (tenc.spec, tenc.n, tenc.shapes, tenc.wire_bytes) == \
        (jenc.spec, jenc.n, jenc.shapes, jenc.wire_bytes)
    assert tenc.sidecar is None
    assert tree_leaves(tenc.payload)[0].dtype == torch.bfloat16
    _leaves_equal(tenc.payload, jenc.payload)
