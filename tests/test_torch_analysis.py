"""repro_torch.analysis: the port's lint, op auditors and Hopper estimator.

Every rule and auditor must trip on its known-bad fixture and pass on the
real tree, and meets the JAX package where the two can: R003 / R004 give
``repro.analysis.lint``'s verdicts on one list of specs, and C205 gives
``repro.analysis.jaxpr_audit.audit_hier_decode``'s on the same numpy
gradients.  C201 and C202 need a mesh: they run in the ranks that
``tests/test_torch_mesh_apply.py`` already starts.  The estimator is held
to the bound figures of PERF.md §6 and to the static shared memory ptxas
reported for K1 and K5 in chip_smoke.py's O5 phase (NVIDIA H100 80GB
HBM3, 700.00 W).
"""
import ast
import dataclasses
import importlib.util
import json
import math
import os
import pathlib
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.analysis import jaxpr_audit as JA
from repro.analysis import lint as JLINT
from repro_torch.analysis import bounds, lint, op_audit as OA, smem
from repro_torch.core import api
from repro_torch.kernels import build
from repro_torch.kernels import fused_select as FS
from repro_torch.launch import analyze

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures_torch_analysis"
F = 2


def _np_tree(n, seed, shapes):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((n,) + s).astype(np.float32)
            for k, s in shapes.items()}


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


# ================================================================= lint
@pytest.mark.parametrize("rule", sorted(lint.RULES))
def test_lint_rule_trips_on_its_fixture_only(rule):
    path = FIXTURES / f"bad_{rule.lower()}.py"
    found = [v.rule for v in lint.lint_paths([str(path)])]
    assert found and set(found) == {rule}, (rule, found)


def test_port_tree_lints_clean():
    paths = lint.port_paths(str(REPO))
    assert len(paths) >= 4 and str(REPO / "chip_smoke.py") in paths
    violations = lint.lint_paths(paths)
    assert violations == [], "\n".join(str(v) for v in violations)


def test_r001_spares_function_bodies_and_the_availability_query():
    src = ("import torch\n"
           "OK = torch.cuda.is_available()\n"
           "DT = torch.float32\n"
           "def f():\n"
           "    return torch.zeros(3).cuda()\n")
    assert lint.lint_source(src, "m.py") == []
    (v,) = lint.lint_source("import torch\nX = torch.empty(3)\n", "m.py")
    assert v.rule == "R001" and v.line == 2 and "m.py:2" in str(v)
    assert v.to_json()["rule"] == "R001"


def test_r006_covers_the_serve_package_by_path():
    src = "import torch.distributed as dist\ndef f(x):\n    dist.barrier()\n"
    assert lint.lint_source(src, "src/repro_torch/core/x.py") == []
    (v,) = lint.lint_source(src, "src/repro_torch/serve/x.py")
    assert v.rule == "R006"


def test_r007_exempts_obs_by_path():
    src = "def step(x):\n    print(x)\n"
    assert [v.rule for v in lint.lint_source(src, "a.py")] == ["R007"]
    assert lint.lint_source(src, "src/repro_torch/obs/a.py") == []


#: one list of valid and misspelt specs for both packages' registries
SPECS = [
    ("attack", "sign_flip"), ("attack", "sign_flip:scale=3.0"),
    ("attack", "definitely_not_an_attack"), ("attack", "inf"),
    ("attack", "gaussian:sigma=2.0"), ("attack", "little_is_enough"),
    ("attack", "sign_flip:bogus=1"), ("attack", "scale_poison"),
    ("attack", "adaptive_lie"), ("attack", "none"),
    ("codec", "qsgd:bits=8"), ("codec", "qsgd:bits=nope"), ("codec", "bf16"),
    ("codec", "topk:frac=0.01"), ("codec", "topk:frac=0.01,ef=1"),
    ("codec", "signsgd"), ("codec", "nope"), ("codec", "qsgd:levels=3"),
    ("hier", "g=7"), ("hier", "g=7,bogus=1"), ("hier", "g=x"),
    ("hier", "g=11,rule=krum,outer_rule=median,f_inner=1"),
]


def _spec_source():
    lines = []
    for kind, spec in SPECS:
        if kind == "hier":
            lines.append(f"GroupConfig.from_spec({spec!r})")
        elif kind == "attack":
            lines.append(f"ATK.get_attack({spec!r})")
        else:
            lines.append(f"make_step(codec={spec!r})")
    lines += ["make_step(hier='g=7,bogus=1', attack='sign_flip')",
              "state[0]", "tstate[-1]", "state['opt']", "trainer_state[3]",
              "params[0]"]
    return "\n".join(lines) + "\n"


def test_r003_r004_verdicts_are_the_jax_lint_s():
    src = _spec_source()
    ours = {(v.rule, v.line) for v in lint.lint_source(src, "specs.py")}
    theirs = {(v.rule, v.line) for v in JLINT.lint_source(src, "specs.py")
              if v.rule in ("R003", "R004")}
    assert ours == theirs
    # both sides found misspelt specs and positional indexing
    assert {r for r, _ in ours} == {"R003", "R004"}
    bad = {line for r, line in ours if r == "R003"}
    assert 3 in bad and 1 not in bad


# ========================================================== op audits
def test_c205_proven_on_the_grouped_path_as_jax():
    grads = _np_tree(21, 0, {"w": (8, 32)})
    ours = OA.audit_hier_decode(_torch(grads), f=1, spec="g=7")
    theirs = JA.audit_hier_decode(
        {k: jax.numpy.asarray(v) for k, v in grads.items()}, f=1,
        spec="g=7")
    assert ours.ok, ours.violations
    assert ours.status == theirs.status == "proven"
    assert ours.contract == theirs.contract


def test_c205_trips_on_a_full_stack_decode():
    with OA.OpRecorder() as rec:
        p = torch.zeros((21, 16), dtype=torch.int8)
        m = torch.ones(21)
        (p.float() * m[:, None])[:7].mean(0)
    violations, decodes = OA.full_stack_decodes(rec, 21)
    assert decodes == 1 and violations and "(21, 16)" in violations[0]


def test_c202_trips_on_a_replicated_decode():
    with OA.OpRecorder() as rec:
        p = torch.zeros((8, 16), dtype=torch.int8)
        (p * torch.ones(8)[:, None]).sum(0)     # promotes: a decode too
    violations, decodes = OA.decode_violations(rec, 8 * 16 // 2)
    assert decodes == 1 and violations and "over the rank's" in violations[0]


def test_c204_holds_the_plain_route_to_zero_builds():
    grads = _torch(_np_tree(11, 1, {"w": (8, 32), "b": (16,)}))
    res = OA.audit_single_build(
        lambda g: api.aggregate_tree(g, F, "multi_bulyan", use_kernels=True),
        lambda: (grads,), label="plain route")
    assert res.ok, res.violations
    assert "0 nvcc run(s) and 0 load(s) on the first call" in res.detail


def test_c204_trips_on_a_call_that_loads_again():
    def reloads(x):
        build._COUNTS["library_loads"] += 1     # what library() counts
        return x + 1

    res = OA.audit_single_build(reloads, lambda: (torch.ones(2),),
                                label="reloads")
    assert not res.ok and "2 library load(s)" in res.violations[0]


def test_c204_fails_when_it_audited_nothing():
    res = OA.audit_single_build(lambda: None, lambda: (), label="empty")
    assert not res.ok and "no op" in res.violations[0]


# ============================================================ estimator
@pytest.fixture(scope="module")
def qwen2_leaves():
    """qwen2-1.5b's 14 leaf sizes at 2 layers (326,970,880 values)."""
    from repro import models as JMD
    from repro.configs import get_config
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=2)
    shapes = jax.eval_shape(lambda: JMD.init_model(jax.random.key(0), cfg))
    out = [math.prod(x.shape) for x in jax.tree.leaves(shapes)]
    assert len(out) == 14 and sum(out) == 326_970_880
    return out


def _sum_bound_ms(bounds):
    """(ms, "bytes" | "operations") of per-leaf bounds summed over the
    leaves side by side, as chip_smoke.py's timing phase sums them."""
    tot = {"bytes": 0.0, "operations": 0.0}
    for b in bounds:
        for key in tot:
            tot[key] += b[key]
    by = max(tot, key=tot.get)
    return 1e3 * tot[by], by


#: PERF.md §6's bound column over qwen2-1.5b's leaves at n = 11 (theta =
#: 5, beta = 1; K6 / K7 on a 4-rank mesh's block: 3 of the 12 zero-padded
#: rows, a view), ms
PERF_MD_BOUNDS = {"k1": 4.2945, "k2": 4.6850, "k3": 4.2945,
                  "k5_int8": 1.0736, "k5_bf16": 2.1473, "k6_block": 4.6850,
                  "k7_int8": 1.1712, "k7_bf16": 2.3425}


def _chip_smoke_bounds(m, n=11):
    """Each kernel's bound on one leaf, called as chip_smoke.py's timing
    phases call analysis/bounds.py."""
    return {"k1": bounds.k1_bound_s(n, m), "k2": bounds.k2_bound_s(n, m, 5, 1),
            "k3": bounds.k3_bound_s(m, 5, 1),
            "k5_int8": bounds.k5_bound_s(n, m, 1),
            "k5_bf16": bounds.k5_bound_s(n, m, 2),
            "k6_block": bounds.rect_bound_s(4 * 12 * m, 3, 12, m),
            "k7_int8": bounds.rect_bound_s(12 * m + 4 * 12, 3, 12, m,
                                           decode=12),
            "k7_bf16": bounds.rect_bound_s(2 * 12 * m + 4 * 12, 3, 12, m,
                                           decode=12)}


def _estimates(m, n=11):
    """The same calls' estimates (analysis/smem.py)."""
    return {"k1": smem.estimate_pairwise_stats(n, m),
            "k2": smem.estimate_fused_select(n, m, 5, 1),
            "k3": smem.estimate_coord_select(5, m, 1),
            "k5_int8": smem.estimate_dequant_stats(n, m, "int8"),
            "k5_bf16": smem.estimate_dequant_stats(n, m, "bfloat16"),
            "k6_block": smem.estimate_pairwise_stats_rect(3, 12, m, n=n),
            "k7_int8": smem.estimate_dequant_stats_rect(3, 12, m, "int8",
                                                        n=n),
            "k7_bf16": smem.estimate_dequant_stats_rect(3, 12, m, "bfloat16",
                                                        n=n)}


def test_estimator_gives_perf_md_bounds(qwen2_leaves):
    per_leaf = [_chip_smoke_bounds(m) for m in qwen2_leaves]
    got = {k: _sum_bound_ms([b[k] for b in per_leaf])
           for k in PERF_MD_BOUNDS}
    assert {k: round(ms, 4) for k, (ms, _) in got.items()} == PERF_MD_BOUNDS
    assert {by for _, by in got.values()} == {"bytes"}


def test_estimates_bound_is_the_bounds_module_s(qwen2_leaves):
    for m in qwen2_leaves:
        ests, want = _estimates(m), _chip_smoke_bounds(m)
        assert {k: e.bound for k, e in ests.items()} == want
        assert all(e.bound_by == "bytes" for e in ests.values())


def test_estimator_gives_k2_theta_34_bounds(qwen2_leaves):
    # n = 40, f = 2: theta = 34, beta = 30; the selection on the
    # yardstick's 64 slots and on the kernel's own 40
    ests = [smem.estimate_fused_select(40, m, 34, 30) for m in qwen2_leaves]
    ms, by = _sum_bound_ms([e.bound for e in ests])
    assert (round(ms, 2), by) == (37.97, "operations")
    assert [e.bound for e in ests] == [bounds.k2_bound_s(40, m, 34, 30)
                                       for m in qwen2_leaves]
    slots = bounds.kernel_slots(34, FS.NETWORK_SLOTS)
    assert slots == 40
    own = _sum_bound_ms([bounds.k2_bound_s(40, m, 34, 30, slots)
                         for m in qwen2_leaves])
    assert (round(own[0], 2), own[1]) == (33.33, "operations")
    assert bounds.select_phase_ops(34, 30) == 2341


def test_bounds_module_loads_alone_by_its_path():
    # tools/time_k1.py loads it so beside a checkout of another version
    path = REPO / "src" / "repro_torch" / "analysis" / "bounds.py"
    tree = ast.parse(path.read_text())
    imported = {a.name.split(".")[0] for node in ast.walk(tree)
                if isinstance(node, ast.Import) for a in node.names} | {
        node.module.split(".")[0] for node in ast.walk(tree)
        if isinstance(node, ast.ImportFrom)}
    assert imported <= {"__future__", "typing"}
    spec = importlib.util.spec_from_file_location("bounds_alone", path)
    alone = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(alone)
    assert alone.k2_bound_s(40, 4096, 34, 30) == \
        bounds.k2_bound_s(40, 4096, 34, 30)


def test_estimator_gives_ptxas_static_smem():
    # chip_smoke.py O5's report: partial_gram_kernel<12, true> 4608 B,
    # <16, true> 8192 B; K5 on int8 4704 B and 8320 B at n = 11 and 15
    for n, k1, k5 in ((11, 4608, 4704), (15, 8192, 8320)):
        gram, fin = smem.estimate_pairwise_stats(n, 4096).launches
        assert gram.static_smem == k1 and fin.static_smem == 0
        assert smem.estimate_dequant_stats(
            n, 4096, "int8").launches[0].static_smem == k5


def test_estimator_gives_16_warps_for_k5_int8_at_n11():
    gram = smem.estimate_dequant_stats(11, 4096, "int8").launches[0]
    occ = smem.occupancy(gram.threads, gram.smem, registers=128)
    assert occ == {"blocks_per_sm": 2, "warps_per_sm": 16,
                   "limited_by": "registers"}


def test_estimator_matches_ptxas_report_by_name():
    report = {
        "_ZN10stats_tile19partial_gram_kernelILi12ELb1E7F32RowsEEvT1_Pflll":
            {"registers": 115, "smem_bytes": 4608, "stack_frame": 0,
             "spill_stores": 0, "spill_loads": 0},
        "_ZN10stats_tile15finalize_kernelEPKfPfS2_ll":
            {"registers": 32, "smem_bytes": 0, "stack_frame": 0,
             "spill_stores": 0, "spill_loads": 0}}
    rows = smem.against_ptxas(smem.estimate_pairwise_stats(11, 4096), report)
    assert [r["ok"] for r in rows] == [True, True]
    assert rows[0]["warps_per_sm"] == 16 and rows[0]["registers"] == 115
    report["_ZN10stats_tile15finalize_kernelEPKfPfS2_ll"]["smem_bytes"] = 4
    assert not smem.against_ptxas(smem.estimate_pairwise_stats(11, 4096),
                                  report)[1]["ok"]
    with pytest.raises(ValueError, match="0 kernel functions"):
        smem.against_ptxas(smem.estimate_pairwise_stats(15, 4096), report)


def test_network_grid_counts_ptxas_registers():
    # K2 at theta = 34 on 2^22 columns wants 16,384 blocks of 128 threads;
    # 73,984 B of shared memory a block leave 3 an SM, so at most 396 on
    # 132 SMs; 255 registers a thread leave 2 an SM, so 264
    est = smem.estimate_fused_select(40, 1 << 22, 34, 30)
    (launch,) = est.launches
    assert launch.grid == (396,)
    assert est.to_json()["launches"][0]["grid_is_upper_bound"]
    report = {"_Z24fused_select_wide_kernelILi32ELi40EEvPKfS1_S1_Pfl": {
        "registers": 255, "smem_bytes": 0, "stack_frame": 0,
        "spill_stores": 0, "spill_loads": 0}}
    (row,) = smem.against_ptxas(est, report)
    assert (row["blocks_per_sm"], row["limited_by"], row["grid"]) == (
        2, "registers", [264])
    # a kernel without the cap keeps its grid
    k1 = smem.estimate_pairwise_stats(11, 4096)
    assert not k1.to_json()["launches"][0]["grid_is_upper_bound"]


def test_estimate_call_follows_the_wrappers_grid():
    x = torch.zeros((12, 4096))
    view = smem.estimate_call("pairwise_stats_rect", x[3:6], x, n=11)
    rect = smem.estimate_call("pairwise_stats_rect", x[3:6].clone(), x, n=11)
    square = smem.estimate_call("pairwise_stats_rect", x, x)
    assert [e.config["grid_kind"] for e in (view, rect, square)] == [
        "view", "rect", "square"]
    # the copy's rows are read besides the stack's
    assert rect.hbm_read_bytes == view.hbm_read_bytes + 4 * 3 * 4096
    wide = smem.estimate_call("fused_select", torch.zeros((40, 8)),
                              torch.zeros((34, 40)), torch.zeros((34, 40)),
                              30)
    (launch,) = wide.launches
    assert launch.dynamic_smem == smem.wide_smem_bytes(34, 128) == 73984
    assert launch.network and not wide.problems()


def test_estimator_flags_what_the_card_refuses():
    # theta <= 32 stages theta n weight pairs without the opt-in: the
    # launcher refuses more than 48 KB
    est = smem.estimate_fused_select(256, 4096, 32, 1)
    assert est.launches[0].dynamic_smem == 32 * 256 * 8
    (problem,) = est.problems()
    assert f"over the {48 * 1024} B its launcher allows" in problem
    with pytest.raises(ValueError, match="unknown kernel"):
        smem.estimate_call("warp_drive", torch.zeros((15, 4096)))


# ================================================================== CLI
class _StandInWorld:
    """The CLI's 2x2 gloo world, stood in for by its verdicts."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def results(self):
        return {c: {"contract": c, "status": "proven",
                    "world": analyze.MESH_WORLD, "detail": "stand-in",
                    "violations": []}
                for c in ("C201-apply-shard-gather", "C202-decode-invariant")}


@pytest.fixture
def no_world(monkeypatch):
    """The ranks of tests/test_torch_mesh_apply.py prove C201 and C202 on
    every mesh, so the CLI's tests start no world of their own."""
    monkeypatch.setattr(analyze, "MeshWorld", _StandInWorld)


def test_analyze_cpu_strict_writes_analysis_v1(no_world, tmp_path, capsys):
    jax_report = (REPO / "ANALYSIS.json").read_bytes()
    out = tmp_path / "report.json"
    rc = analyze.main(["--device", "cpu", "--json", str(out), "--strict",
                       "--root", str(REPO)])
    assert rc == 0, capsys.readouterr()
    report = json.loads(out.read_text())
    assert report["schema"] == "analysis.v1"
    assert set(report["results"]) == {"lint", "contracts", "analysis"}
    assert report["results"]["lint"]["violations"] == []
    assert {k: v["status"] for k, v in report["results"]["contracts"].items()
            } == {"C201-apply-shard-gather": "proven",
                  "C202-decode-invariant": "proven",
                  "C204-single-build/plain": "proven",
                  "C205-hier-decode": "proven"}
    k = report["results"]["analysis"]["kernels"]
    assert k["pairwise_stats"]["n=11,d=4096"]["smem_per_block"] == 4608
    # the JAX package's report is not the port's to write
    assert (REPO / "ANALYSIS.json").read_bytes() == jax_report


def test_analyze_strict_fails_on_a_bad_root(no_world, tmp_path):
    pkg = tmp_path / "src" / "repro_torch"
    pkg.mkdir(parents=True)
    shutil.copy(FIXTURES / "bad_r004.py", pkg / "bad.py")
    rc = analyze.main(["--device", "cpu", "--json",
                       str(tmp_path / "r.json"), "--strict", "--root",
                       str(tmp_path)])
    assert rc == 1
    report = json.loads((tmp_path / "r.json").read_text())
    assert [v["rule"] for v in report["results"]["lint"]["violations"]] \
        == ["R004", "R004"]
    assert os.path.relpath(str(pkg), str(tmp_path)) in \
        report["results"]["lint"]["paths"]
