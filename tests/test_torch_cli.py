"""The port's training CLI (``python -m repro_torch.launch.train``) on the
CPU: fail-fast probes before any step, the paper's contrast under the
``inf`` attack (finite under multi_bulyan, blown up under average), the
compressed wire (``--codec``) with its byte line held to JAX's,
``--mesh host`` in a one-rank gloo world (the process group it starts is
gone after ``run``, one started before it is left up), and the streaming
trainer (``--trainer stream_global|stream_block``: global scope gives the
stacked run's records bit for bit, alone and with ``--codec``, ``--mesh
host`` and ``--ckpt-dir``; its refusals come before the model is
built).  Then the serving CLI (``python -m repro_torch.launch.serve``):
its three ``[serve]`` lines, greedy, categorical and on the ring buffer,
its tokens those of ``dist.serving.generate`` on the same parameters, and
its refusal to run on a missing GPU."""
import math
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from repro_torch.launch import serve, train
from repro_torch.tree import tree_leaves

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


def test_codec_run_prints_jax_wire_bytes_and_rejects_the_attack(capsys):
    """--codec qsgd:bits=8 --attack scale_poison: finite losses, no
    selection mass on the forged rows, and the wire line's byte count is
    the JAX package's wire_stats for the same parameter shapes."""
    import jax
    from repro import models as JMD
    from repro.comm import wire_stats
    from repro.configs import get_config as jget
    (_, hist), out = _run(capsys, "--steps", "2", "--workers", "11",
                          "--f", "2", "--codec", "qsgd:bits=8",
                          "--attack", "scale_poison")
    shapes = jax.eval_shape(lambda: JMD.init_model(
        jax.random.key(0), jget("qwen2-1.5b").reduced()))
    ws = wire_stats("qsgd:bits=8", shapes, n=11)
    line = next(ln for ln in out.splitlines()
                if ln.startswith("[train] wire:"))
    assert line.startswith(f"[train] wire: {ws.bytes_per_worker:,} "
                           f"B/worker/step ({ws.compression:.1f}x vs fp32")
    for rec in hist:
        assert math.isfinite(rec["loss"]) and rec["byz_mass"] == 0.0
        assert rec["wire_bytes_per_worker"] == ws.bytes_per_worker


def test_wire_attack_without_a_codec_is_refused_as_in_jax(capsys):
    from repro.configs.base import ArchConfig, RobustConfig
    from repro.dist import make_train_step
    from repro.optim import constant, sgd
    with pytest.raises(ValueError, match="needs a codec= wire to attack"):
        make_train_step(ArchConfig(name="t", family="dense"),
                        RobustConfig(n_workers=11, f=2), sgd(),
                        constant(0.1), attack="scale_poison")
    with pytest.raises(ValueError, match="needs a codec= wire to attack"):
        _run(capsys, "--attack", "scale_poison")
    assert "[train] arch" not in capsys.readouterr().out


def test_unknown_codec_lists_the_available_ones(capsys):
    with pytest.raises(KeyError, match="unknown codec 'zstd'") as e:
        _run(capsys, "--codec", "zstd")
    for name in ("bf16", "qsgd", "signsgd", "topk", "identity"):
        assert name in str(e.value)
    assert "[train] step" not in capsys.readouterr().out


def test_error_feedback_run_records_a_nonzero_residual(capsys):
    (_, hist), _ = _run(capsys, "--steps", "2", "--codec", "signsgd:ef=1",
                        "--attack", "payload_flip")
    for rec in hist:
        assert math.isfinite(rec["loss"])
        assert 0.0 < rec["residual_max_abs"] < math.inf


def test_mesh_host_prints_the_mesh_line_and_trains_as_without(capsys):
    """A one-rank gloo world (1x1): JAX's mesh line, and the losses of the
    same run without ``--mesh``; the process group is gone after."""
    flags = ["--steps", "2", "--workers", "11", "--f", "2", "--attack",
             "sign_flip"]
    (_, mesh), out = _run(capsys, *flags, "--mesh", "host")
    assert not dist.is_initialized()
    assert "[train] mesh=host shape={'data': 1, 'model': 1} (worker axis " \
        "sharded over data, d over model)" in out
    (_, plain), out = _run(capsys, *flags)
    assert "mesh=" not in out
    for a, b in zip(mesh, plain):
        assert a["loss"] == b["loss"]
        assert a["loss_per_worker"] == b["loss_per_worker"]
        assert a["byz_mass"] == b["byz_mass"]
        assert a["selection"] == b["selection"]


def test_mesh_production_is_refused_by_argparse(capsys):
    with pytest.raises(SystemExit) as e:
        train.parse_args(["--mesh", "production"])
    assert e.value.code == 2
    assert "invalid choice: 'production'" in capsys.readouterr().err


def test_mesh_run_that_raises_still_destroys_its_group(capsys):
    with pytest.raises(KeyError, match="unknown codec"):
        _run(capsys, "--mesh", "host", "--codec", "zstd")
    assert not dist.is_initialized()


def test_mesh_run_leaves_a_group_it_did_not_start(capsys):
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        (_, hist), out = _run(capsys, "--steps", "1", "--mesh", "host")
        assert len(hist) == 1 and "[train] mesh=host" in out
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------- the streaming trainer
STREAM = ["--steps", "2", "--seq", "16", "--workers", "11", "--f", "2",
          "--attack", "sign_flip"]


def test_stream_global_gives_the_stacked_records_bit_for_bit(capsys):
    (_, stacked), _ = _run(capsys, *STREAM)
    (_, stream), out = _run(capsys, *STREAM, "--trainer", "stream_global")
    assert len(stream) == 2 and "[train] done: final loss" in out
    for a, b in zip(stream, stacked):
        for key in ("loss", "loss_per_worker", "selection", "byz_mass",
                    "honest_dev", "agg_grad_norm"):
            assert a[key] == b[key], key


def test_stream_block_runs_and_rejects_inf(capsys):
    (_, hist), out = _run(capsys, *STREAM[:-1], "inf", "--trainer",
                          "stream_block")
    assert len(hist) == 2 and "[train] done: final loss" in out
    for rec in hist:
        assert math.isfinite(rec["loss"]) and rec["byz_mass"] == 0.0


def test_stream_global_composes_with_codec_mesh_and_checkpoint(capsys,
                                                              tmp_path):
    """``--codec`` with a wire attack, ``--mesh host`` and ``--ckpt-dir``
    on the streaming trainer: the stacked run's records (the wire bytes
    too) and a checkpoint of the same parameters."""
    from repro_torch.checkpoint import restore
    flags = [*STREAM[:-1], "scale_poison", "--codec", "qsgd:bits=8"]
    (p_stacked, stacked), _ = _run(capsys, *flags)
    (p_stream, stream), out = _run(
        capsys, *flags, "--trainer", "stream_global", "--mesh", "host",
        "--ckpt-dir", str(tmp_path))
    assert not dist.is_initialized()
    assert "[train] mesh=host" in out and "[train] checkpoint ->" in out
    for a, b in zip(stream, stacked):
        for key in ("loss", "loss_per_worker", "selection", "byz_mass",
                    "wire_bytes_per_worker"):
            assert a[key] == b[key], key
    saved = restore(str(tmp_path), 2, {"params": p_stream})["params"]
    for a, b, c in zip(tree_leaves(saved), tree_leaves(p_stream),
                       tree_leaves(p_stacked)):
        assert torch.equal(a, b) and torch.equal(b, c)


@pytest.mark.parametrize("flags,match", [
    (["--attack", "adaptive_lie"], "adaptive attacks need the stacked"),
    (["--codec", "signsgd:ef=1"], "error-feedback codecs carry"),
])
def test_streaming_refusals_come_before_the_model(capsys, flags, match):
    with pytest.raises(NotImplementedError, match=match):
        _run(capsys, "--trainer", "stream_global", *flags)
    assert "[train] arch" not in capsys.readouterr().out


# ------------------------------------------------------------------ serve
SERVE = ["--reduced", "--device", "cpu", "--batch", "2", "--prompt-len",
         "16", "--new-tokens", "8"]


@pytest.mark.parametrize("flags", [[], ["--sample", "categorical"],
                                   ["--window", "8"]],
                         ids=["greedy", "categorical", "window"])
def test_serve_prints_its_three_lines(capsys, flags):
    from repro_torch.dist.serving import generate
    rec = serve.run(SERVE + flags)
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 3
    assert out[0] == "[serve] arch=qwen2-1.5b-smoke params=1,313,024"
    assert out[1].startswith("[serve] generated (2, 8) tokens in ")
    assert out[1].endswith(" tok/s)")
    toks = rec["tokens"]
    assert toks.dtype == torch.int32 and tuple(toks.shape) == (2, 8)
    assert bool(((toks >= 0) & (toks < 512)).all())
    assert out[2] == f"[serve] first sequence: {toks[0].tolist()}"
    window = int(flags[1]) if "--window" in flags else 0
    seed = 0 if "categorical" in flags else None
    from repro_torch.configs import get_config
    cfg = get_config("qwen2-1.5b").reduced()
    again = generate(rec["params"], cfg, rec["prompt"], 8, window=window,
                     chunk_q=16, sample="categorical" if seed == 0 else
                     "greedy", seed=seed)
    assert torch.equal(again, toks)


def test_serve_without_device_flag_fails_in_a_subprocess():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--batch", "2", "--prompt-len", "8", "--new-tokens", "2"],
        capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode != 0
    assert "--device cpu" in res.stderr
    assert "[serve] generated" not in res.stdout
