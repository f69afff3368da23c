"""One robust stacked training step of each dense architecture of the
registry, reduced, against the JAX package's ``make_train_step`` on the
CPU; the inputs, the step and the tolerances are
``tests/test_torch_archs_step.py``'s (chatglm3's partial rotary,
nemotron's squared ReLU, qwen2.5's and qwen2's GQA with QKV bias)."""
import pytest

from test_torch_archs_step import fp32_jax, step_matches_jax  # noqa: F401

DENSE = ("chatglm3-6b", "nemotron-4-15b", "qwen2.5-32b", "qwen2-1.5b")


@pytest.mark.parametrize("name", DENSE)
def test_one_robust_step_matches_jax(fp32_jax, name):  # noqa: F811
    step_matches_jax(name)
