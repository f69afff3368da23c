"""The port's quickstart (``examples/quickstart_torch.py``) and the legacy
GAR entry points it calls (``repro_torch.core.gar``: ``GARS``,
``get_gar``, ``aggregate``), held to the JAX package on the CPU.

Tolerances: part 1's cosines within 1e-5 of JAX's on the same numpy stack;
``aggregate`` bit for bit the port's ``aggregate_matrix`` and within 1e-6
(rtol and atol) of JAX's ``aggregate`` for every rule.
"""
import importlib.util
import math
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import apply_attack as japply_attack
from repro.core import gar as JG
from repro.core import theory as JT
from repro_torch.core import api as TAPI
from repro_torch.core import gar as TG

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _quickstart():
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", os.path.join(REPO, "examples",
                                         "quickstart_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cos64(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def test_part1_cosines_match_jax(capsys):
    """JAX's example on the same stack: its aggregate and its cosine.  The
    average of the ``inf`` stack points along the all-ones true gradient
    (its entries are about 2e29), where JAX's fp32 ``cone_cosine``
    overflows its norm and reads 0; the port's cosine sums in float64, so
    there it is held to the float64 cosine of JAX's aggregate."""
    got = _quickstart().part1_gar("cpu")
    out = capsys.readouterr().out
    assert "=== 1. the GAR itself ===" in out
    assert "multi-bulyan slowdown vs averaging = 0.47" in out
    n, f, d = 15, 3, 1000
    rng = np.random.default_rng(0)
    g_true = np.ones(d, np.float32)
    correct = g_true + 0.1 * rng.normal(size=(n - f, d)).astype(np.float32)
    stack = japply_attack(jnp.asarray(correct), f, "inf", jax.random.key(0))
    assert sorted(got) == sorted(("average", "median", "multi_krum",
                                  "multi_bulyan"))
    for rule, cos in got.items():
        agg = JG.aggregate(stack, f, rule)
        assert abs(cos - _cos64(agg, g_true)) < 1e-5, rule
        want = JT.cone_cosine(agg, jnp.asarray(g_true))
        if rule == "average":
            assert want == 0.0 and not math.isfinite(
                float(jnp.linalg.norm(agg)))
        else:
            assert abs(cos - want) < 1e-5, rule
    assert got["multi_bulyan"] > 0.9


def test_gars_table_matches_jax():
    assert list(TG.GARS) == list(JG.GARS)
    for name in JG.GARS:
        assert TG.get_gar(name) is TG.GARS[name]
    with pytest.raises(KeyError) as want:
        JG.get_gar("multi_bulyn")
    with pytest.raises(KeyError) as got:
        TG.get_gar("multi_bulyn")
    assert str(got.value) == str(want.value)


def _stack(n, d, seed):
    """Rows N(0, s_i^2) with distinct s_i: selections are well apart."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x * (1.0 + 0.1 * np.arange(n, dtype=np.float32))[:, None]


@pytest.mark.parametrize("name", list(JG.GARS))
def test_aggregate_is_aggregate_matrix_and_matches_jax(name):
    n, f = 15, 3
    G = _stack(n, 257, seed=5)
    got = TG.aggregate(torch.from_numpy(G), f, name)
    assert torch.equal(got, TAPI.aggregate_matrix(torch.from_numpy(G), f,
                                                  name))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(JG.aggregate(jnp.asarray(G), f,
                                                       name)),
                               rtol=1e-6, atol=1e-6)


def test_part2_trains_with_finite_losses(capsys):
    losses = _quickstart().part2_training("cpu")
    assert len(losses) == 8
    assert all(math.isfinite(v) for v in losses)
    out = capsys.readouterr().out
    assert out.count("2 byzantine workers sending 1e30s") == 8
