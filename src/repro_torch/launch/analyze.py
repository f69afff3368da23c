"""Static contract verification of the port (cf. ``repro.launch.analyze``).

Runs the three ``repro_torch.analysis`` passes and writes the
``analysis.v1`` report (the JAX report's keys: ``schema`` and
``results.{lint, contracts, analysis}``):

* the AST lint over the port's tree under ``--root``;
* the contracts: C201 and C202 in a 2x2 gloo world on the CPU that this
  command starts itself (4 processes: one card cannot hold two NCCL
  ranks), C204 on the plain route, and C205 on the CPU; on ``cuda`` also
  C204 on a training step with the kernels;
* the Hopper estimates of K1-K7 at ``KERNEL_POINTS``; on ``cuda`` each
  launch set beside ptxas's report (static shared memory, registers, the
  blocks an SM those registers leave), the libraries built first.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.analyze \\
      [--device cuda|cpu] [--json PATH] [--strict] [--root .]

``--device`` defaults to ``cuda``: a missing card raises.  The report goes
to stdout (the summary then to stderr) unless ``--json PATH`` names a
file; it never writes ``ANALYSIS.json``, the JAX package's report.
``--strict`` exits nonzero on any lint violation, any violated contract,
any estimate over a limit of the card, and on ``cuda`` any launch whose
static shared memory differs from ptxas's.
"""
from __future__ import annotations

import argparse
import datetime
import json
import multiprocessing
import os
import queue as queue_mod
import sys
import tempfile
import time
from typing import Any, Dict, List

SCHEMA = "analysis.v1"
#: the JAX analyzer's (n, d) points: the main path's n and a deeper one
KERNEL_POINTS = ((11, 4096), (15, 100_000), (15, 1_000_000))
#: the world C201 and C202 run in: (worker shards, model shards)
MESH_SHAPE = (2, 2)
MESH_WORLD = f"{MESH_SHAPE[0]}x{MESH_SHAPE[1]} gloo world on the CPU " \
    f"({MESH_SHAPE[0] * MESH_SHAPE[1]} ranks)"
#: seconds the world may take, start-up included
MESH_TIMEOUT_S = 300
#: the training step of the cuda C204: the tests' 2-layer d_model-64 LM
TINY = dict(name="tiny-qwen", family="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128, qkv_bias=True,
            tie_embeddings=True, rope_theta=1e6)


def _grads(n: int, shapes, seed: int):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(
        rng.standard_normal((n,) + s).astype(np.float32))
        for k, s in shapes.items()}


# ------------------------------------------------------------------ lint
def run_lint(root: str = ".") -> Dict[str, Any]:
    from repro_torch.analysis import lint
    paths = lint.port_paths(root)
    return {"paths": [os.path.relpath(p, root) for p in paths],
            "rules": sorted(lint.RULES),
            "violations": [v.to_json() for v in lint.lint_paths(paths)]}


# ------------------------------------------------------------- contracts
def mesh_rank_contracts(mesh_ctx) -> List[Any]:
    """C201 and C202 on this rank of a mesh: the JAX analyzer's two-leaf
    tree of 11 workers, f = 2, multi-Bulyan."""
    from repro_torch.analysis import op_audit as OA
    grads = _grads(11, {"w": (8, 32), "b": (16,)}, seed=0)
    return [OA.audit_apply_gather(grads, f=2, mesh_ctx=mesh_ctx),
            OA.audit_decode_invariant(grads, f=2, mesh_ctx=mesh_ctx)]


def _mesh_rank(rank: int, world: int, store: str, out) -> None:
    """One rank of :class:`MeshWorld`: its results, or its error, on
    ``out``."""
    try:
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.core import api
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=120))
        try:
            mesh = init_device_mesh("cpu", MESH_SHAPE,
                                    mesh_dim_names=("data", "model"))
            res = mesh_rank_contracts(api.MeshContext.for_mesh(mesh))
            out.put((rank, [r.to_json() for r in res], None))
        finally:
            dist.destroy_process_group()
    except Exception as e:                       # noqa: BLE001 — reported
        out.put((rank, None, f"{type(e).__name__}: {e}"))


class MeshWorld:
    """C201 and C202 on every rank of a ``MESH_SHAPE`` gloo world on the
    CPU (a context manager): entering starts the ranks, which then work
    while the caller does; :meth:`results` waits for them.  A contract is
    proven when every rank proves it.  Leaving stops every rank."""

    def __init__(self):
        self.world = MESH_SHAPE[0] * MESH_SHAPE[1]

    def __enter__(self) -> "MeshWorld":
        ctx = multiprocessing.get_context("spawn")
        self._tmp = tempfile.TemporaryDirectory()
        self._out = ctx.Queue()
        store = os.path.join(self._tmp.name, "store")
        self._procs = [ctx.Process(target=_mesh_rank,
                                   args=(r, self.world, store, self._out))
                       for r in range(self.world)]
        for p in self._procs:
            p.start()
        self._deadline = time.monotonic() + MESH_TIMEOUT_S
        return self

    def __exit__(self, *exc) -> None:
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        self._tmp.cleanup()

    def _collect(self) -> List[Any]:
        """Each rank's (rank, results, error); raises once a rank has
        exited without one or ``MESH_TIMEOUT_S`` has passed."""
        got: Dict[int, Any] = {}
        while len(got) < self.world:
            try:
                item = self._out.get(timeout=1.0)
                got[item[0]] = item
                continue
            except queue_mod.Empty:
                pass
            # a rank posts before it exits, so one that exited with an
            # error and posted nothing never will (it failed to start)
            dead = [r for r, p in enumerate(self._procs)
                    if r not in got and p.exitcode not in (None, 0)]
            if dead:
                raise RuntimeError(f"the {MESH_WORLD}: rank(s) {dead} "
                                   "exited without a result")
            if time.monotonic() > self._deadline:
                raise RuntimeError(f"the {MESH_WORLD} gave no result "
                                   f"within {MESH_TIMEOUT_S} s")
        return [got[r] for r in sorted(got)]

    def results(self) -> Dict[str, Dict[str, Any]]:
        got = self._collect()
        failed = [f"rank {r}: {err}" for r, _, err in got if err is not None]
        if failed:
            raise RuntimeError(f"the {MESH_WORLD} failed: "
                               + "; ".join(failed))
        merged: Dict[str, Dict[str, Any]] = {}
        for rank, results, _ in got:
            for r in results:
                m = merged.setdefault(r["contract"], {
                    "contract": r["contract"], "status": "proven",
                    "world": MESH_WORLD, "detail": [], "violations": []})
                m["detail"].append(f"rank {rank}: {r['detail']}")
                m["violations"] += [f"rank {rank}: {v}"
                                    for v in r["violations"]]
                if r["status"] != "proven":
                    m["status"] = "violated"
        for m in merged.values():
            m["detail"] = "; ".join(m["detail"])
        return merged


def _train_step_args(device):
    """(step, make_args) of the stacked trainer's step at TINY on
    ``device``: 11 workers, f = 2, multi-Bulyan with the kernels, the
    ``inf`` attack, SGD."""
    import torch

    from repro_torch.configs import ArchConfig, RobustConfig
    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.dist import init_train_state, make_train_step
    from repro_torch.dist.trainer import split_workers
    from repro_torch.models.api import init_model
    from repro_torch.optim import constant, sgd
    cfg = ArchConfig(**TINY)
    opt = sgd(momentum=0.9)
    step = make_train_step(cfg, RobustConfig(n_workers=11, f=2), opt,
                           constant(0.05), chunk_q=16, attack="inf")
    params = init_model(cfg, seed=0, device=device)
    gen = torch.Generator()
    gen.manual_seed(1)
    batch = {k: v.to(device) for k, v in split_workers(
        make_lm_batch(gen, TINY["vocab_size"], 22, 16), 11).items()}
    state = init_train_state(opt, params)
    return step, lambda: (params, state, batch, 2)


def local_contracts(device) -> Dict[str, Dict[str, Any]]:
    """C204 on the plain route (``aggregate_tree`` on CPU tensors, the
    kernels' plain versions) and C205 on the CPU; on ``cuda`` also C204 on
    the training step with the kernels."""
    from repro_torch.analysis import op_audit as OA
    from repro_torch.core import api
    grads = _grads(11, {"w": (8, 32), "b": (16,)}, seed=0)
    out = {}
    res = OA.audit_single_build(
        lambda g: api.aggregate_tree(g, 2, "multi_bulyan", use_kernels=True),
        lambda: (grads,), label="aggregate_tree, plain route (cpu)")
    out["C204-single-build/plain"] = res.to_json()
    if device.type == "cuda":
        step, make_args = _train_step_args(device)
        res = OA.audit_single_build(step, make_args,
                                    label="training step, kernels (cuda)")
        out["C204-single-build/train_step"] = res.to_json()
    res = OA.audit_hier_decode(_grads(21, {"w": (8, 32)}, seed=0), f=1,
                               spec="g=7")
    out[res.contract] = res.to_json()
    return out


# ------------------------------------------------------------- estimates
def point_estimates(n: int, d: int) -> Dict[str, Any]:
    """The estimates of K1-K7 at (n, d): f and θ = n - 2f - 2 as the JAX
    benchmark grid takes them, β = θ - 2f; the mesh kernels on rank 1's
    block of a 4-rank mesh (the stack zero-padded to 4 ceil(n / 4) rows;
    K6 on its view path where that stack fits one tile)."""
    from repro_torch.analysis import smem
    from repro_torch.obs.profile import f_for_bench
    f = f_for_bench(n)
    theta = n - 2 * f - 2
    beta = theta - 2 * f
    n_loc = -(-n // 4)
    n_pad = 4 * n_loc
    view = "view" if n_pad <= 16 else "rect"
    return {
        "pairwise_stats": smem.estimate_pairwise_stats(n, d),
        "dequant_stats/int8": smem.estimate_dequant_stats(n, d, "int8"),
        "dequant_stats/bfloat16": smem.estimate_dequant_stats(
            n, d, "bfloat16"),
        "pairwise_sqdist": smem.estimate_pairwise_sqdist(n, d),
        "pairwise_stats_rect": smem.estimate_pairwise_stats_rect(
            n_loc, n_pad, d, n=n, grid_kind=view),
        "dequant_stats_rect/int8": smem.estimate_dequant_stats_rect(
            n_loc, n_pad, d, "int8", n=n),
        "fused_select": smem.estimate_fused_select(n, d, theta, beta),
        "coord_select": smem.estimate_coord_select(theta, d, beta)}


def run_kernels(device) -> Dict[str, Any]:
    """Every estimate at KERNEL_POINTS; on ``cuda`` each beside ptxas's
    report of its library (built here if it is not)."""
    from repro_torch.analysis import smem
    from repro_torch.kernels import build
    reports = None
    if device.type == "cuda":
        build.build()
        reports = {name: build.ptxas_report(name) for name in build.KERNELS}
    kernels: Dict[str, Dict[str, Any]] = {}
    for n, d in KERNEL_POINTS:
        for key, est in point_estimates(n, d).items():
            row = est.to_json()
            if reports is not None:
                report = reports[est.kernel]
                if report is None:
                    raise RuntimeError(f"{est.kernel}: no ptxas report "
                                       "beside its library")
                row["ptxas"] = smem.against_ptxas(est, report)
            kernels.setdefault(key, {})[f"n={n},d={d}"] = row
    return {"device": str(device), "kernels": kernels,
            "limits": {"smem_per_block": smem.SMEM_PER_BLOCK_MAX,
                       "smem_without_opt_in": smem.SMEM_DEFAULT_MAX,
                       "registers_per_sm": smem.REGS_PER_SM,
                       "max_registers_per_thread": smem.MAX_REGS_PER_THREAD,
                       "threads_per_sm": smem.MAX_THREADS_PER_SM}}


# ----------------------------------------------------------------- report
def gate_problems(report: Dict[str, Any]) -> List[str]:
    """Everything ``--strict`` refuses to ship."""
    problems = []
    res = report["results"]
    for v in res["lint"]["violations"]:
        problems.append(
            f"lint {v['rule']} {v['path']}:{v['line']}: {v['msg']}")
    for name, r in res["contracts"].items():
        if r["status"] != "proven":
            problems.append(f"contract {name} violated: "
                            + "; ".join(r["violations"]))
    for key, points in res["analysis"]["kernels"].items():
        for point, row in points.items():
            problems += [f"estimate {key} {point}: {p}"
                         for p in row["problems"]]
            for p in row.get("ptxas", ()):
                if not p["ok"]:
                    problems.append(
                        f"estimate {key} {point}: {p['function']} static "
                        f"shared memory {p['static_smem']} B, ptxas "
                        f"{p['ptxas_smem']} B")
    return problems


def build_report(root: str, device) -> Dict[str, Any]:
    """The ``analysis.v1`` report; the mesh world works while the lint,
    the local contracts and the estimates run."""
    with MeshWorld() as world:
        lint_res = run_lint(root)
        local = local_contracts(device)
        kernels = run_kernels(device)
        contracts = {**world.results(), **local}
    return {"schema": SCHEMA,
            "results": {"lint": lint_res, "contracts": contracts,
                        "analysis": kernels}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="where the estimates meet ptxas and C204 runs a "
                         "training step (cpu: neither; a missing card "
                         "raises)")
    ap.add_argument("--json", default="-",
                    help="report path ('-': stdout, the default)")
    ap.add_argument("--strict", action="store_true",
                    help="exit nonzero on any violation")
    ap.add_argument("--root", default=".",
                    help="repo root to lint (default: cwd)")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device
    device = resolve_device(args.device)
    report = build_report(args.root, device)
    problems = gate_problems(report)

    say = sys.stderr if args.json == "-" else sys.stdout
    if args.json == "-":
        json.dump(report, sys.stdout, indent=1, sort_keys=True)
        sys.stdout.write("\n")
    else:
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=1, sort_keys=True)
            fh.write("\n")
    res = report["results"]
    print(f"lint: {len(res['lint']['violations'])} violation(s) over "
          f"{res['lint']['paths']}", file=say)
    for name, r in sorted(res["contracts"].items()):
        print(f"{name}: {r['status']} — {r['detail']}", file=say)
    n_est = sum(len(v) for v in res["analysis"]["kernels"].values())
    print(f"estimates: {n_est} at {list(KERNEL_POINTS)} on "
          f"{res['analysis']['device']}", file=say)
    if problems:
        print(f"{len(problems)} problem(s):", file=say)
        for p in problems:
            print(f"  ✗ {p}", file=say)
    else:
        print("all contracts proven, the port lints clean, every estimate "
              "within the card's limits", file=say)
    if args.json != "-":
        print(f"report written to {args.json}", file=say)
    return 1 if (args.strict and problems) else 0


if __name__ == "__main__":
    sys.exit(main())
