"""End-to-end training entry point of the port (cf. ``repro.launch.train``).

Runs byzantine-robust training of a dense architecture on one device:
``cuda`` unless ``--device cpu`` is passed (a missing GPU raises; nothing
falls back).  ``--layers`` cuts the depth while keeping the published
widths; ``--reduced`` takes the smoke-scale variant.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --layers 2 --steps 3 --workers 11 --f 2 --gar multi_bulyan \\
      --attack inf
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \\
      --steps 3 --seq 16
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import models as MD
from repro_torch.configs import ARCH_NAMES, RobustConfig, get_config
from repro_torch.data import lm_batches
from repro_torch.device import resolve_device
from repro_torch.dist import init_train_state, make_train_step, split_workers
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
    ap.add_argument("--use-kernels", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="route stats + bulyan apply through the CUDA "
                         "kernels (their plain versions on the CPU)")
    ap.add_argument("--optimizer", default="sgd", choices=("sgd", "adamw"))
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--log-every", type=int, default=1)
    return ap.parse_args(argv)


def run(argv: Optional[Sequence[str]] = None
        ) -> Tuple[Any, List[Dict[str, Any]]]:
    """Train as the flags say.  Returns the final parameters and one record
    per step (``loss``, ``loss_per_worker``, ``byz_mass``, ``honest_dev``,
    ``agg_grad_norm``, ``lr``, ``seconds``)."""
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.per_worker_batch <= 0:
        raise SystemExit("--per-worker-batch must be positive")
    # validates (n, f, gar) before anything is built
    rcfg = RobustConfig(n_workers=args.workers, f=args.f, gar=args.gar,
                        use_kernels=args.use_kernels)
    device = resolve_device(args.device)
    params = MD.init_model(cfg, seed=args.seed, device=device)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"[train] arch={cfg.name} layers={cfg.n_layers} "
          f"params={n_params:,} device={device} workers={args.workers} "
          f"f={args.f} gar={args.gar} attack={args.attack} "
          f"kernels={args.use_kernels}", flush=True)
    opt = make_optimizer(args.optimizer,
                         **({"momentum": 0.9} if args.optimizer == "sgd"
                            else {}))
    state = init_train_state(opt, params)
    lr_fn = warmup_cosine(args.lr, warmup=max(args.steps // 20, 1),
                          total_steps=args.steps)
    step_fn = make_train_step(cfg, rcfg, opt, lr_fn,
                              chunk_q=min(args.seq, 512),
                              attack=args.attack, telemetry=True)
    data = lm_batches(cfg.vocab_size, args.workers * args.per_worker_batch,
                      args.seq, seed=args.seed)
    history: List[Dict[str, Any]] = []
    for i in range(args.steps):
        wb = {k: v.to(device) for k, v in
              split_workers(next(data), args.workers).items()}
        t0 = time.perf_counter()
        params, state, metrics = step_fn(params, state, wb, args.seed + i)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
        tel = metrics["telemetry"]
        rec = {"loss": float(metrics["loss"]),
               "loss_per_worker": metrics["loss_per_worker"].tolist(),
               "byz_mass": float(tel["byz_mass"]),
               "honest_dev": float(tel["honest_dev"]),
               "agg_grad_norm": float(metrics["agg_grad_norm"]),
               "lr": float(metrics["lr"]), "seconds": seconds}
        history.append(rec)
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"[train] step {i:5d} loss {rec['loss']:.4f} "
                  f"byz_mass {rec['byz_mass']:.4f} lr {rec['lr']:.2e} "
                  f"({seconds:.3f}s)", flush=True)
    print(f"[train] done: final loss {history[-1]['loss']:.4f}"
          if history else "[train] done: no steps", flush=True)
    return params, history


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
