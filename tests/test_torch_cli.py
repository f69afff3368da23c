"""The port's training CLI (``python -m repro_torch.launch.train``) on the
CPU: fail-fast probes before any step, and the paper's contrast under the
``inf`` attack (finite under multi_bulyan, blown up under average)."""
import math
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import train

# the suite runs in several worker processes at once: one thread each
# keeps the port's many small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--reduced", "--seq", "8", "--workers", "7",
         "--f", "1", "--per-worker-batch", "1", "--log-every", "100"]


def _run(capsys, *flags):
    out = train.run(SMALL + list(flags))
    return out, capsys.readouterr().out


def test_too_few_workers_fails_before_any_step(capsys):
    with pytest.raises(ValueError, match=r"multi_bulyan requires n >= 4f\+3"):
        _run(capsys, "--workers", "10", "--f", "2", "--gar", "multi_bulyan")
    assert "[train] step" not in capsys.readouterr().out


def test_unknown_gar_lists_the_available_ones(capsys):
    with pytest.raises(ValueError, match="unknown GAR 'multi_bulyn'") as e:
        _run(capsys, "--gar", "multi_bulyn")
    for rule in ("average", "median", "trimmed_mean", "krum", "multi_krum",
                 "bulyan", "multi_bulyan"):
        assert rule in str(e.value)
    assert "[train] step" not in capsys.readouterr().out


def test_missing_gpu_raises_without_device_flag():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.run(["--reduced", "--steps", "1"])


def test_inf_attack_stays_finite_under_multi_bulyan(capsys):
    (params, hist), out = _run(capsys, "--steps", "3", "--attack", "inf",
                               "--gar", "multi_bulyan", "--lr", "0.5")
    assert len(hist) == 3
    for rec in hist:
        assert math.isfinite(rec["loss"])
        assert all(math.isfinite(v) for v in rec["loss_per_worker"])
        assert rec["byz_mass"] == 0.0
    assert "[train] done: final loss" in out


def test_inf_attack_blows_up_average(capsys):
    # step 0 runs at the warm-up's lr 0; step 1's update carries the 1e30s
    (params, hist), _ = _run(capsys, "--steps", "3", "--attack", "inf",
                             "--gar", "average")
    last = hist[-1]["loss"]
    assert not math.isfinite(last) or last > 1e3
    assert hist[0]["byz_mass"] > 0.0


def test_kernel_flag_gives_the_same_losses_on_cpu(capsys):
    """On CPU tensors the kernels' plain versions run: --use-kernels and
    --no-use-kernels train identically to fp32 rounding."""
    (_, a), _ = _run(capsys, "--steps", "2", "--attack", "sign_flip")
    (_, b), _ = _run(capsys, "--steps", "2", "--attack", "sign_flip",
                     "--no-use-kernels")
    for ra, rb in zip(a, b):
        assert math.isclose(ra["loss"], rb["loss"], rel_tol=1e-5)


def test_module_entry_point_fails_fast_in_a_subprocess():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--reduced", "--workers", "10", "--f", "2"],
        capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode != 0
    assert "requires n >= 4f+3" in res.stderr
    assert "[train] step" not in res.stdout
