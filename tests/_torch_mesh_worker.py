"""One rank of a gloo world running the port's mesh-native statistics on
the CPU: the helper of ``tests/test_torch_mesh.py``, which starts the
ranks and holds what they save to the JAX package.

    python tests/_torch_mesh_worker.py RANK WORLD STORE INPUTS OUT

With WORLD > 1 the rank joins the world through a ``FileStore`` at STORE;
a world of one rank is started by ``launch.mesh.make_host_mesh`` itself
(an in-process store).  On each mesh of :func:`meshes` it runs every
input of INPUTS (``torch.load``: stacked trees, and wire containers as
dicts of their fields) through ``compute_stats(row_block(...),
mesh_ctx=)`` with and without kernels (their plain versions on the CPU),
norms alone, and the model-axis statistics of the trees, and saves what
it got to OUT (``torch.save``).  Imports torch and the port only.
"""
import datetime
import sys

import torch

#: byzantine workers of every case (n = 11 and 13 take multi-Bulyan)
F = 2


def meshes(world):
    """(label, dim names, shape) of each mesh a world of ``world`` ranks
    runs: ``None`` is ``make_host_mesh``'s own factoring."""
    if world == 1:
        return [("1x1", None, None)]
    if world == 2:
        return [("2x1", ("data", "model"), (2, 1)), ("1x2", None, None)]
    return [("2x2", None, None), ("4x1", ("data", "model"), (4, 1)),
            ("pod2x2x1", ("pod", "data", "model"), (2, 2, 1))]


def container(d):
    from repro_torch.comm.container import EncodedGrads
    return EncodedGrads(payload=d["payload"], sidecar=d["sidecar"],
                        spec=d["spec"], n=d["n"],
                        shapes=tuple(tuple(s) for s in d["shapes"]),
                        wire_bytes=d["wire_bytes"])


def run_mesh(mesh, inputs, out, label):
    import torch.distributed as dist
    from repro_torch.core import api
    from repro_torch.launch.mesh import data_parallel_size
    ctx = api.MeshContext.for_mesh(mesh)
    out[f"{label}/index"] = {
        "worker_index": ctx.worker_index,
        "worker_group_rank": dist.get_rank(ctx.worker_group),
        "worker_size": ctx.worker_size, "model_size": ctx.model_size,
        "model_index": ctx.model_index,
        "data_parallel_size": data_parallel_size(mesh),
        "coordinate": list(mesh.get_coordinate()),
        "worker_axes": list(ctx.worker_axes)}
    cases = [(name, tree, True) for name, tree in inputs["trees"].items()]
    cases += [(name, container(wire), False)
              for name, wire in inputs["wires"].items()]
    for name, grads, is_tree in cases:
        block = api.row_block(grads, ctx)
        for k in (0, 1):
            st = api.compute_stats(block, F, use_kernels=bool(k),
                                   mesh_ctx=ctx)
            raw = api.raw_pairwise_stats(block, use_kernels=bool(k),
                                         mesh_ctx=ctx)
            out[f"{label}/{name}/k{k}"] = (st.dists, st.sq_norms, raw[0])
        norms = api.compute_stats(block, F, needs_dists=False,
                                  needs_norms=True, mesh_ctx=ctx).sq_norms
        out[f"{label}/{name}/norms"] = norms
        if not is_tree:
            continue
        tiles = api.column_tile(block, ctx)
        for k in (0, 1):
            out[f"{label}/{name}/model_axis/k{k}"] = (
                api.sharded_raw_stats_model_axis(tiles, mesh_ctx=ctx,
                                                 use_kernels=bool(k)),
                api.sharded_raw_stats(block, mesh_ctx=ctx,
                                      use_kernels=bool(k)))


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
    out = {}
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
