"""The host mesh on ``torch.distributed`` (cf. ``repro.launch.mesh``).

:func:`make_host_mesh` factors the ranks of the world into a ("data",
"model") ``DeviceMesh`` as the JAX package factors its devices, and
starts the default process group first if none is up.  The JAX module's
``make_production_mesh`` (16 x 16 chips a pod, 2 pods multi-pod) has no
counterpart: the port runs on one card, or a few cards of one host.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

#: how long a collective waits for the other ranks before it fails
TIMEOUT = datetime.timedelta(minutes=5)


def host_mesh_shape(world: int) -> Tuple[int, int]:
    """(data, model) for ``world`` ranks: the most-square split with
    data <= model, data a power of two (1 -> 1x1, 2 -> 1x2, 4 -> 2x2,
    8 -> 2x4), as ``repro.launch.mesh.make_host_mesh`` splits devices."""
    data = 1
    while world % (data * 2) == 0 and data * 2 <= world // (data * 2):
        data *= 2
    return data, world // data


def init_process_group(device: torch.device) -> None:
    """Start the default process group unless one is up: NCCL for a
    ``cuda`` device, gloo for the CPU; ``env://`` when ``RANK`` and
    ``WORLD_SIZE`` are set (the launcher's rendezvous), else a world of
    one rank on an in-process store."""
    if dist.is_initialized():
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        # each rank's card, before NCCL and the mesh look for it
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://",
                                timeout=TIMEOUT)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=TIMEOUT)


def make_host_mesh(device: Optional[Union[str, torch.device]] = None):
    """("data", "model") ``DeviceMesh`` over every rank of the world, on
    ``device`` (``cuda`` unless asked otherwise; the process group is
    started if none is up, and its caller destroys it).  One rank gives a
    1x1 mesh: the mesh path with one-rank collectives."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    init_process_group(dev)
    return init_device_mesh(dev.type, host_mesh_shape(dist.get_world_size()),
                            mesh_dim_names=("data", "model"))


def data_parallel_size(mesh) -> int:
    """Number of byzantine-game workers the mesh supports (pod x data)."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    size = sizes["data"]
    if "pod" in sizes:
        size *= sizes["pod"]
    return int(size)
