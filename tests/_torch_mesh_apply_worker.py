"""One rank of a gloo world running the port's mesh-native apply and mesh
training step on the CPU: the helper of ``tests/test_torch_mesh_apply.py``,
which starts the ranks and holds what they save to the JAX package.

    python tests/_torch_mesh_apply_worker.py RANK WORLD STORE INPUTS OUT

The world is joined as ``tests/_torch_mesh_worker.py`` joins it, and runs
the same meshes.  On each mesh, every tree of INPUTS goes through
``apply(plan, row_block(...), mesh_ctx=)`` for all seven rules (the plan
from the replicated statistics) on three substrates (plain, the kernels'
plain versions, the two-step substrate) and through
``aggregate_tree(row_block(...), mesh_ctx=)``; every wire container
through the apply of four rules, one of each plan kind; and the tiny
model through two steps of ``make_train_step(shard_map_mesh=)`` and of
the streaming trainer's global scope
(``make_streaming_train_step(scope="global", shard_map_mesh=)``), each
under ``sign_flip`` and under ``qsgd:bits=8`` with ``scale_poison``; and
the contracts C201 and C202 (``analysis.op_audit``) on the ``n11`` tree,
with C201's check on a gather of a full leaf.  The
replicated train steps (no mesh) run once, before the meshes.  What it got
goes to OUT (``torch.save``).  Imports torch and the port only.
"""
import datetime
import sys

import torch

from _torch_mesh_worker import F, container, meshes

RULES = ("average", "median", "trimmed_mean", "krum", "multi_krum", "bulyan",
         "multi_bulyan")
#: one rule of each plan kind: mean, coordinate, weighted, bulyan
WIRE_RULES = ("average", "median", "multi_krum", "multi_bulyan")
#: (label, use_kernels, fused) of each apply substrate
SUBSTRATES = (("plain", False, True), ("kernels", True, True),
              ("two_step", True, False))
#: (label, trainer, step keywords) of each trainer case: the stacked
#: trainer and the streaming trainer's global scope
TRAIN_CASES = tuple(
    (prefix + label, trainer, kw)
    for prefix, trainer in (("", "stacked"), ("stream_", "stream_global"))
    for label, kw in (("sign_flip", {"attack": "sign_flip"}),
                      ("qsgd", {"attack": "scale_poison",
                                "codec": "qsgd:bits=8"})))
TRAIN_STEPS = 2
#: the seed of the first step (JAX's key 2 in tests/test_torch_trainer.py)
SEED0 = 2


def run_apply(ctx, inputs, out, label):
    from repro_torch.core import api
    for name, tree in inputs["trees"].items():
        block = api.row_block(tree, ctx)
        stats = api.compute_stats(tree, F)
        for rule in RULES:
            agg = api.get_aggregator(rule)
            plan = agg.plan(stats)
            for sub, k, fused in SUBSTRATES:
                out[f"{label}/{name}/{rule}/{sub}"] = agg.apply(
                    plan, block, use_kernels=k, fused=fused, mesh_ctx=ctx)
            out[f"{label}/{name}/{rule}/aggregate_tree"] = \
                api.aggregate_tree(block, F, rule, use_kernels=True,
                                   mesh_ctx=ctx)
    for spec, wire in inputs["wires"].items():
        enc = container(wire)
        block = api.row_block(enc, ctx)
        stats = api.compute_stats(enc, F)
        for rule in WIRE_RULES:
            agg = api.get_aggregator(rule)
            plan = agg.plan(stats)
            for sub, k, fused in SUBSTRATES[:2]:
                out[f"{label}/{spec}/{rule}/{sub}"] = agg.apply(
                    plan, block, use_kernels=k, fused=fused, mesh_ctx=ctx)


def run_audits(ctx, inputs, out, label):
    """C201 and C202 (``analysis.op_audit``) on this rank's share of the
    ``n11`` tree, and C201's gather check on a worker-group gather of the
    largest leaf's full rows (every column): (violations, gathers)."""
    from repro_torch.analysis import op_audit as OA
    from repro_torch.core import api
    from repro_torch.tree import tree_leaves
    tree = inputs["trees"]["n11"]
    out[f"{label}/audits"] = {r.contract: r.to_json() for r in (
        OA.audit_apply_gather(tree, f=F, mesh_ctx=ctx),
        OA.audit_decode_invariant(tree, f=F, mesh_ctx=ctx))}
    rows = max(tree_leaves(api.row_block(tree, ctx).rows),
               key=lambda x: x[0].numel())
    worker, model = OA.apply_gather_bounds(tree, ctx)
    with OA.OpRecorder({"worker": ctx.worker_group,
                        "model": ctx.model_group}) as rec:
        api._all_gather(rows.reshape(rows.shape[0], -1), ctx.worker_group,
                        ctx.worker_size)
    out[f"{label}/full_leaf_gather"] = OA.gather_violations(
        rec, worker=worker, model=model)


def run_train(mesh, inputs):
    """{case: [per step (params, loss, loss_per_worker, selection,
    byz_mass)]} of TRAIN_STEPS steps, mesh-native on ``mesh`` (None: the
    replicated step)."""
    from repro_torch.configs import ArchConfig, RobustConfig
    from repro_torch.dist import (init_train_state,
                                  make_streaming_train_step, make_train_step)
    from repro_torch.optim import constant, sgd
    cfg = ArchConfig(**inputs["tiny"], dtype="float32")
    n = inputs["batch"]["tokens"].shape[0]
    rcfg = RobustConfig(n_workers=n, f=F, gar="multi_bulyan")
    res = {}
    for case, trainer, kw in TRAIN_CASES:
        opt = sgd(momentum=0.9)
        if trainer == "stream_global":
            kw = dict(kw, scope="global")
        make = make_train_step if trainer == "stacked" else \
            make_streaming_train_step
        step = make(cfg, rcfg, opt, constant(0.05), chunk_q=inputs["seq"],
                    telemetry=True, shard_map_mesh=mesh, **kw)
        params = inputs["params"]
        state = init_train_state(opt, params)
        steps = []
        for i in range(TRAIN_STEPS):
            params, state, m = step(params, state, inputs["batch"],
                                    SEED0 + i)
            tel = m["telemetry"]
            steps.append((params, m["loss"], m["loss_per_worker"],
                          tel["selection"], tel["byz_mass"]))
        res[case] = steps
    return res


def run_mesh(mesh, inputs, out, label):
    import torch.distributed as dist
    from repro_torch.core import api
    ctx = api.MeshContext.for_mesh(mesh)
    out[f"{label}/index"] = {
        "worker_index": ctx.worker_index,
        "worker_group_rank": dist.get_rank(ctx.worker_group),
        "model_index": ctx.model_index,
        "model_group_rank": dist.get_rank(ctx.model_group),
        "model_size": ctx.model_size}
    run_apply(ctx, inputs, out, label)
    run_audits(ctx, inputs, out, label)
    out[f"{label}/train"] = run_train(mesh, inputs)


def main(rank, world, store, inputs_path, out_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    if world > 1:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=120))
    inputs = torch.load(inputs_path, weights_only=True)
    out = {"replicated/train": run_train(None, inputs)}
    try:
        for label, names, shape in meshes(world):
            mesh = make_host_mesh("cpu") if shape is None else \
                init_device_mesh("cpu", shape, mesh_dim_names=names)
            out[f"{label}/shape"] = (list(mesh.mesh_dim_names),
                                     [int(s) for s in mesh.shape])
            run_mesh(mesh, inputs, out, label)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.save(out, out_path)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         sys.argv[5])
