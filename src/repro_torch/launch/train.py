"""End-to-end training entry point of the port (cf. ``repro.launch.train``).

Runs byzantine-robust training of any decoder-only architecture of the
registry (dense, MoE, SSM, hybrid, VLM) on one device: ``cuda`` unless
``--device cpu`` is passed (a missing GPU raises; nothing falls back).
``--layers`` cuts the depth while keeping the published widths (a
multiple of the architecture's layer period); ``--reduced`` takes the
smoke-scale variant.  A VLM config gets a bf16 normal soft prefix of
``n_patches`` embeddings per sequence, drawn anew each step from
``--seed``.  ``--mesh host``
runs the aggregation mesh-native on ``launch.mesh.make_host_mesh``: a
world of one rank (an in-process store), or every rank of a
``torchrun`` launch (one process a card, ``env://``); only rank 0
prints and writes ``--ckpt-dir``.  ``--trainer stream_block|stream_global``
takes the streaming trainer (``dist.streaming``), which holds one
parameter block's gradient stack at a time; ``stream_global`` gives the
stacked trainer's step bit for bit.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --layers 2 --steps 3 --workers 11 --f 2 --gar multi_bulyan \\
      --attack inf
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \\
      --steps 3 --seq 16
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --layers 2 --steps 3 --codec qsgd:bits=8 --attack scale_poison
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \\
      --steps 3 --seq 16 --attack adaptive_lie --ckpt-dir ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --layers 8 --steps 2 --trainer stream_global
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \\
      --arch jamba-1.5-large-398b --steps 2 --seq 16
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch qwen2-1.5b --layers 2 --steps 3 --mesh host
"""
from __future__ import annotations

import argparse
import itertools
import time
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import torch
import torch.distributed as dist

from repro_torch import models as MD
from repro_torch.checkpoint import save
from repro_torch.comm import wire_stats
from repro_torch.configs import ARCH_NAMES, ArchConfig, RobustConfig
from repro_torch.core.attacks import fold_seed
from repro_torch.data import lm_batches
from repro_torch.device import resolve_device
from repro_torch.dist import (init_train_state, make_streaming_train_step,
                              make_train_step, split_workers)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.tree import tree_leaves


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_NAMES, default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced smoke-scale variant")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the "
                         "config's own)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--per-worker-batch", type=int, default=2)
    ap.add_argument("--workers", type=int, default=11)
    ap.add_argument("--f", type=int, default=2)
    ap.add_argument("--gar", default="multi_bulyan")
    ap.add_argument("--attack", default="none")
    ap.add_argument("--codec", default=None,
                    help="wire codec spec (repro_torch.comm): qsgd:bits=8, "
                         "bf16, signsgd, topk:frac=0.01[,ef=1], fp32; "
                         "attacks then hit the wire format (scale_poison, "
                         "payload_flip are wire-level attacks)")
    ap.add_argument("--trainer", default="stacked",
                    choices=("stacked", "stream_block", "stream_global"),
                    help="stacked: the whole (n, d) gradient stack at once; "
                         "stream_*: one parameter block's stack at a time, "
                         "with one plan per block (block) or one plan from "
                         "a first pass over every block (global)")
    ap.add_argument("--use-kernels", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="route stats + bulyan apply through the CUDA "
                         "kernels (their plain versions on the CPU)")
    ap.add_argument("--optimizer", default="sgd", choices=("sgd", "adamw"))
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default="none", choices=("none", "host"),
                    help="run aggregation mesh-native: 'host' factors the "
                         "ranks of the torch.distributed world (one, or "
                         "torchrun's) into a (data, model) mesh, the "
                         "worker axis sharded over data, d over model")
    ap.add_argument("--ckpt-dir", default=None,
                    help="save {'params': ...} here after the last step "
                         "(repro_torch.checkpoint, the JAX package's "
                         "format)")
    ap.add_argument("--log-every", type=int, default=1)
    return ap.parse_args(argv)


def robust_config(args: argparse.Namespace) -> RobustConfig:
    """The aggregation of the flags (validates n, f and the GAR)."""
    return RobustConfig(n_workers=args.workers, f=args.f, gar=args.gar,
                        use_kernels=args.use_kernels)


def make_trainer(args: argparse.Namespace, cfg: ArchConfig,
                 rcfg: RobustConfig, lr_fn: Callable[[Any], Any],
                 mesh=None) -> Tuple[Any, Callable]:
    """The optimizer and the step function of the flags' trainer.  Checks
    the attack and codec specs (a wire attack needs a codec; the
    streaming trainer refuses adaptive attacks and ef=1) before any model
    is built."""
    opt = make_optimizer(args.optimizer,
                         **({"momentum": 0.9} if args.optimizer == "sgd"
                            else {}))
    kw = dict(chunk_q=min(args.seq, 512), attack=args.attack,
              codec=args.codec, telemetry=True, shard_map_mesh=mesh)
    if args.trainer == "stacked":
        return opt, make_train_step(cfg, rcfg, opt, lr_fn, **kw)
    return opt, make_streaming_train_step(
        cfg, rcfg, opt, lr_fn, scope=args.trainer[len("stream_"):], **kw)


def worker_batches(args: argparse.Namespace, cfg: ArchConfig,
                   device: torch.device) -> Iterator[Dict[str, torch.Tensor]]:
    """Step i's batch, split over the workers, for i = 0, 1, ...: the
    seeded token stream and, for a VLM, the soft prefix of
    ``fold_seed(seed, PREFIX_STREAM + i)``."""
    data = lm_batches(cfg.vocab_size, args.workers * args.per_worker_batch,
                      args.seq, seed=args.seed)
    for i in itertools.count():
        batch = {k: v.to(device) for k, v in next(data).items()}
        if cfg.n_patches:
            batch["prefix_embeds"] = MD.prefix_embeds(
                cfg, batch["tokens"].shape[0],
                fold_seed(args.seed, MD.PREFIX_STREAM + i), device)
        yield split_workers(batch, args.workers)


def run(argv: Optional[Sequence[str]] = None
        ) -> Tuple[Any, List[Dict[str, Any]]]:
    """Train as the flags say.  Returns the final parameters and one record
    per step (``loss``, ``loss_per_worker``, ``byz_mass``, ``selection``,
    the plan's (n,) selection weights, ``honest_dev``, ``agg_grad_norm``,
    ``lr``, ``seconds``; under a codec also ``wire_bytes_per_worker`` and,
    with ``ef=1``, ``residual_max_abs``, the largest magnitude in the
    error-feedback residual after the step; under an adaptive attack also
    ``astate``, the attack's state after the step as host floats and
    lists).  Under ``--mesh host`` every rank
    returns them; a process group that ``run`` started is destroyed when
    it returns or raises, one that was up before is left up."""
    args = parse_args(argv)
    cfg = MD.arch_config(args.arch, reduced=args.reduced,
                         layers=args.layers)
    if args.per_worker_batch <= 0:
        raise SystemExit("--per-worker-batch must be positive")
    # validates (n, f, gar) before anything is built
    rcfg = robust_config(args)
    device = resolve_device(args.device)
    started = args.mesh == "host" and not dist.is_initialized()
    try:
        mesh = make_host_mesh(device) if args.mesh == "host" else None
        return _train(args, cfg, rcfg, device, mesh)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _train(args: argparse.Namespace, cfg, rcfg: RobustConfig,
           device: torch.device, mesh) -> Tuple[Any, List[Dict[str, Any]]]:
    """:func:`run` once the flags are checked and the mesh (or None) is
    up."""
    lead = mesh is None or dist.get_rank() == 0

    def say(msg: str) -> None:
        if lead:
            print(msg, flush=True)

    lr_fn = warmup_cosine(args.lr, warmup=max(args.steps // 20, 1),
                          total_steps=args.steps)
    opt, step_fn = make_trainer(args, cfg, rcfg, lr_fn, mesh)
    params = MD.init_model(cfg, seed=args.seed, device=device)
    n_params = sum(p.numel() for p in tree_leaves(params))
    say(f"[train] arch={cfg.name} layers={cfg.n_layers} "
        f"params={n_params:,} device={device} workers={args.workers} "
        f"f={args.f} gar={args.gar} attack={args.attack} "
        f"codec={args.codec} kernels={args.use_kernels}")
    if mesh is not None:
        shape = dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))
        say(f"[train] mesh={args.mesh} shape={shape} (worker axis sharded "
            f"over data, d over model)")
    if args.codec:
        ws = wire_stats(args.codec, params, n=args.workers)
        say(f"[train] wire: {ws.bytes_per_worker:,} B/worker/step "
            f"({ws.compression:.1f}x vs fp32, "
            f"{ws.chunks_per_worker} chunk(s) of {ws.chunk_bytes:,} B)")
    state = init_train_state(opt, params, n_workers=args.workers,
                             attack=args.attack, attack_f=args.f,
                             codec=args.codec)
    history: List[Dict[str, Any]] = []
    for i, wb in zip(range(args.steps), worker_batches(args, cfg, device)):
        t0 = time.perf_counter()
        params, state, metrics = step_fn(params, state, wb, args.seed + i)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
        tel = metrics["telemetry"]
        rec = {"loss": float(metrics["loss"]),
               "loss_per_worker": metrics["loss_per_worker"].tolist(),
               "byz_mass": float(tel["byz_mass"]),
               "selection": tel["selection"].tolist(),
               "honest_dev": float(tel["honest_dev"]),
               "agg_grad_norm": float(metrics["agg_grad_norm"]),
               "lr": float(metrics["lr"]), "seconds": seconds}
        if "wire_bytes_per_worker" in tel:
            rec["wire_bytes_per_worker"] = tel["wire_bytes_per_worker"]
        if state.astate is not None:
            rec["astate"] = {k: v.tolist() for k, v in state.astate.items()}
        if state.cres is not None:
            rec["residual_max_abs"] = max(
                float(torch.max(torch.abs(r))) for r in tree_leaves(state.cres))
        history.append(rec)
        if i % args.log_every == 0 or i == args.steps - 1:
            say(f"[train] step {i:5d} loss {rec['loss']:.4f} "
                f"byz_mass {rec['byz_mass']:.4f} lr {rec['lr']:.2e} "
                f"({seconds:.3f}s)")
    if args.ckpt_dir and lead:
        path = save(args.ckpt_dir, args.steps, {"params": params})
        say(f"[train] checkpoint -> {path}")
    say(f"[train] done: final loss {history[-1]['loss']:.4f}"
        if history else "[train] done: no steps")
    return params, history


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
