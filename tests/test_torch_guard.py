"""The port stands alone: nothing under ``src/repro_torch`` and nothing in
``chip_smoke.py``, ``tools/time_k1.py``, ``examples/quickstart_torch.py``,
``examples/robust_serving_torch.py``,
``examples/streaming_at_scale_torch.py`` or
``examples/byzantine_training_torch.py`` imports ``jax``, ``ml_dtypes``
or the JAX package ``repro``, and the smoke script refuses to run without
a card or outside a checkout."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tools" / "time_k1.py",
    REPO / "examples" / "quickstart_torch.py",
    REPO / "examples" / "robust_serving_torch.py",
    REPO / "examples" / "streaming_at_scale_torch.py",
    REPO / "examples" / "byzantine_training_torch.py"]


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes")


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(REPO)) for p in SOURCES])
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "id", getattr(node.func, "attr", "")) in \
                ("import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names = [str(node.args[0].value)]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_the_wire_package_is_covered():
    """The compressed wire (``repro_torch.comm``) and the K5 wrapper are
    among the checked sources."""
    names = {str(p.relative_to(REPO)) for p in SOURCES}
    for want in ("comm/__init__.py", "comm/codecs.py", "comm/container.py",
                 "comm/transport.py", "kernels/dequant_stats.py"):
        want = f"src/repro_torch/{want}"
        assert want in names


def test_the_substrate_modules_are_covered():
    """K3's wrapper and the robust façade are among the checked sources."""
    names = {str(p.relative_to(REPO)) for p in SOURCES}
    for want in ("kernels/coord_select.py", "core/robust.py", "core/api.py",
                 "dist/trainer.py"):
        assert f"src/repro_torch/{want}" in names


def test_the_mesh_modules_are_covered():
    """The mesh statistics' modules and the K6 / K7 / K4 wrappers are among
    the checked sources."""
    names = {str(p.relative_to(REPO)) for p in SOURCES}
    for want in ("launch/mesh.py", "core/api.py", "comm/codecs.py",
                 "kernels/pairwise_sqdist.py", "kernels/dequant_stats.py",
                 "kernels/ops.py", "kernels/ref.py"):
        assert f"src/repro_torch/{want}" in names


def test_the_checkpoint_and_core_modules_are_covered():
    """The checkpoint store, the quickstart and the modules that gained the
    adaptive attacks, the theory and the legacy GAR entry points are among
    the checked sources."""
    names = {str(p.relative_to(REPO)) for p in SOURCES}
    for want in ("checkpoint/__init__.py", "checkpoint/store.py",
                 "core/__init__.py", "core/attacks.py", "core/theory.py",
                 "core/gar.py", "launch/train.py"):
        assert f"src/repro_torch/{want}" in names
    assert "examples/quickstart_torch.py" in names


def test_the_streaming_trainer_is_covered():
    """The streaming trainer and the modules it extends are among the
    checked sources."""
    names = {str(p.relative_to(REPO)) for p in SOURCES}
    for want in ("dist/streaming.py", "dist/__init__.py", "dist/trainer.py",
                 "comm/codecs.py", "launch/train.py"):
        assert f"src/repro_torch/{want}" in names


def test_the_serving_modules_are_covered():
    """The serving path, its CLI, its example and the modules that gained
    the decode are among the checked sources."""
    names = {str(p.relative_to(REPO)) for p in SOURCES}
    for want in ("dist/serving.py", "dist/__init__.py", "launch/serve.py",
                 "models/attention.py", "models/transformer.py",
                 "models/api.py", "models/__init__.py", "core/api.py"):
        assert f"src/repro_torch/{want}" in names
    assert "examples/robust_serving_torch.py" in names


def test_the_model_families_are_covered():
    """The decoder families' modules, their configs and the streaming
    example are among the checked sources."""
    names = {str(p.relative_to(REPO)) for p in SOURCES}
    for want in ("models/moe.py", "models/ssm.py", "models/transformer.py",
                 "configs/base.py", "configs/__init__.py",
                 "configs/qwen3_moe_30b_a3b.py", "configs/falcon_mamba_7b.py",
                 "configs/jamba_1_5_large_398b.py", "configs/internvl2_1b.py"):
        assert f"src/repro_torch/{want}" in names
    assert "examples/streaming_at_scale_torch.py" in names


def test_the_mesh_worker_imports_no_jax():
    """The spawned ranks of ``tests/test_torch_mesh.py`` import the port
    only."""
    test_no_jax_or_reference_import(REPO / "tests" / "_torch_mesh_worker.py")


def test_the_mesh_apply_worker_imports_no_jax():
    """The spawned ranks of ``tests/test_torch_mesh_apply.py`` import the
    port only."""
    test_no_jax_or_reference_import(
        REPO / "tests" / "_torch_mesh_apply_worker.py")


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 37      # every module was imported


def test_chip_smoke_alone_fails_without_a_result(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_the_serve_package_is_covered():
    """The bounded-staleness service (``repro_torch.serve``) and the
    modules it extends are among the checked sources."""
    names = {str(p.relative_to(REPO)) for p in SOURCES}
    for want in ("serve/__init__.py", "serve/buffer.py", "serve/service.py",
                 "serve/batching.py", "serve/loadgen.py", "core/api.py",
                 "core/theory.py", "dist/trainer.py", "models/attention.py",
                 "models/transformer.py", "models/encdec.py"):
        assert f"src/repro_torch/{want}" in names


def test_the_sim_package_is_covered():
    """The campaign simulator (``repro_torch.sim``), the part of
    ``repro_torch.obs`` it reads, its CLI, its example and the data it
    draws are among the checked sources."""
    names = {str(p.relative_to(REPO)) for p in SOURCES}
    for want in ("sim/__init__.py", "sim/scenario.py", "sim/engine.py",
                 "sim/telemetry.py", "sim/report.py", "obs/__init__.py",
                 "obs/metrics.py", "obs/export.py", "launch/simulate.py",
                 "data/synthetic.py", "data/__init__.py"):
        assert f"src/repro_torch/{want}" in names
    assert "examples/byzantine_training_torch.py" in names


def test_the_obs_package_is_covered():
    """The observability subsystem (``repro_torch.obs``: registry, span
    ring, profile hooks, drain), its report driver and the modules that
    gained ``obs=`` or the profile hooks are among the checked sources."""
    names = {str(p.relative_to(REPO)) for p in SOURCES}
    for want in ("obs/__init__.py", "obs/metrics.py", "obs/trace.py",
                 "obs/profile.py", "obs/export.py", "launch/obs_report.py",
                 "launch/train.py", "kernels/ops.py", "kernels/build.py",
                 "checkpoint/store.py", "dist/trainer.py",
                 "dist/streaming.py", "hier/aggregate.py",
                 "serve/service.py", "sim/engine.py", "sim/report.py"):
        assert f"src/repro_torch/{want}" in names


def test_the_analysis_package_is_covered():
    """The port's static analysis (``repro_torch.analysis``: the lint, the
    op auditors, the Hopper estimator) and its entry point are among the
    checked sources."""
    names = {str(p.relative_to(REPO)) for p in SOURCES}
    for want in ("analysis/__init__.py", "analysis/lint.py",
                 "analysis/op_audit.py", "analysis/smem.py",
                 "launch/analyze.py"):
        assert f"src/repro_torch/{want}" in names
