"""End-to-end training entry point of the port (cf. ``repro.launch.train``).

Runs byzantine-robust training of any architecture of the registry
(dense, MoE, SSM, hybrid, VLM, encoder-decoder) on one device: ``cuda``
unless ``--device cpu`` is passed (a missing GPU raises; nothing falls
back).  ``--layers`` cuts the depth while keeping the published widths (a
multiple of the architecture's layer period); ``--reduced`` takes the
smoke-scale variant.  A VLM config gets a bf16 normal soft prefix of
``n_patches`` embeddings per sequence, an encoder-decoder config bf16
normal audio frames (``n_frames`` per sequence), each drawn anew each
step from ``--seed``; an encoder-decoder trains on the stacked trainer
only, as in the JAX launcher.  ``--mesh host``
runs the aggregation mesh-native on ``launch.mesh.make_host_mesh``: a
world of one rank (an in-process store), or every rank of a
``torchrun`` launch (one process a card, ``env://``); only rank 0
prints and writes ``--ckpt-dir``.  ``--trainer stream_block|stream_global``
takes the streaming trainer (``dist.streaming``), which holds one
parameter block's gradient stack at a time; ``stream_global`` gives the
stacked trainer's step bit for bit.  ``--hier g=7`` aggregates in two
levels (``repro_torch.hier``) on either trainer: within groups of at most
7 workers, then over the group aggregates.  ``--obs`` records the
observability registry and span ring (``repro_torch.obs``) in the step,
brackets each step in a host wall-clock span (the step and its
``torch.cuda.synchronize()``), and after the run writes an ``obs.v1``
snapshot (``--obs-json``) and a Chrome / Perfetto trace (``--obs-trace``)
that ``launch/obs_report.py`` reads.

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
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny \\
      --steps 3 --workers 11 --f 2 --attack inf
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --layers 2 --steps 3 --workers 21 --f 1 --hier g=7 --attack inf
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --layers 2 --steps 3 --attack inf --obs
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch qwen2-1.5b --layers 2 --steps 3 --mesh host
"""
from __future__ import annotations

import argparse
import itertools
import time
from contextlib import nullcontext
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import torch
import torch.distributed as dist

from repro_torch import models as MD
from repro_torch import obs as OBS
from repro_torch.checkpoint import save
from repro_torch.comm import hier_wire_stats, wire_stats
from repro_torch.configs import ARCH_NAMES, ArchConfig, RobustConfig
from repro_torch.core.attacks import fold_seed
from repro_torch.core.theory import FBudget
from repro_torch.data import lm_batches
from repro_torch.device import resolve_device
from repro_torch.dist import (init_train_state, make_streaming_train_step,
                              make_train_step, split_workers)
from repro_torch.hier import GroupConfig
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
    ap.add_argument("--hier", default=None, metavar="SPEC",
                    help="two-level grouped aggregation (repro_torch.hier): "
                         "'g=64' groups the workers into ceil(n/64) "
                         "groups, robust-aggregates within each, then "
                         "across the group outputs. Optional keys: rule=, "
                         "outer_rule=, f_inner=, f_outer=, enforce=0")
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
    ap.add_argument("--obs", action="store_true",
                    help="runtime observability: the metrics registry and "
                         "span ring in the step, host wall-clock spans "
                         "around it; drains to an obs.v1 snapshot and a "
                         "Perfetto/Chrome trace after the run")
    ap.add_argument("--obs-json", default="obs_snapshot.json",
                    help="obs.v1 snapshot output path (with --obs)")
    ap.add_argument("--obs-trace", default="obs_trace.json",
                    help="Chrome-trace output path (with --obs); open at "
                         "https://ui.perfetto.dev")
    ap.add_argument("--log-every", type=int, default=1)
    return ap.parse_args(argv)


def robust_config(args: argparse.Namespace) -> RobustConfig:
    """The aggregation of the flags (validates n, f and the GAR; under
    ``--hier`` the per-level budget check owns feasibility)."""
    return RobustConfig(n_workers=args.workers, f=args.f, gar=args.gar,
                        use_kernels=args.use_kernels,
                        grouped=args.hier is not None)


def hier_config(args: argparse.Namespace
                ) -> Tuple[Optional[GroupConfig], Optional[FBudget]]:
    """The ``--hier`` spec's :class:`GroupConfig` (its inner rule
    defaults to ``--gar``) and its checked budget for ``--workers`` /
    ``--f``; (None, None) without the flag."""
    if args.hier is None:
        return None, None
    hier = GroupConfig.from_spec(args.hier, rule=args.gar)
    return hier, hier.budget(args.workers, args.f)


def make_trainer(args: argparse.Namespace, cfg: ArchConfig,
                 rcfg: RobustConfig, lr_fn: Callable[[Any], Any],
                 mesh=None, hier: Optional[GroupConfig] = None
                 ) -> Tuple[Any, Callable]:
    """The optimizer and the step function of the flags' trainer (``hier``
    the ``--hier`` config of :func:`hier_config`).  Checks the attack and
    codec specs (a wire attack needs a codec; the streaming trainer
    refuses adaptive attacks and ef=1) before any model is built."""
    opt = make_optimizer(args.optimizer,
                         **({"momentum": 0.9} if args.optimizer == "sgd"
                            else {}))
    # JAX's ring: 4 records a step, at least 128 (a step writes 3, 6
    # under --hier)
    obs = OBS.ObsConfig(enabled=True, ring=max(128, 4 * args.steps)) \
        if args.obs else None
    kw = dict(chunk_q=min(args.seq, 512), attack=args.attack,
              codec=args.codec, telemetry=True, shard_map_mesh=mesh,
              hier=hier, obs=obs)
    if args.trainer == "stacked":
        return opt, make_train_step(cfg, rcfg, opt, lr_fn, **kw)
    return opt, make_streaming_train_step(
        cfg, rcfg, opt, lr_fn, scope=args.trainer[len("stream_"):], **kw)


def worker_batches(args: argparse.Namespace, cfg: ArchConfig,
                   device: torch.device) -> Iterator[Dict[str, torch.Tensor]]:
    """Step i's batch, split over the workers, for i = 0, 1, ...: the
    seeded token stream and, for a VLM, the soft prefix of
    ``fold_seed(seed, PREFIX_STREAM + i)``, for an encoder-decoder the
    frames of ``fold_seed(seed, FRAMES_STREAM + i)``."""
    data = lm_batches(cfg.vocab_size, args.workers * args.per_worker_batch,
                      args.seq, seed=args.seed)
    for i in itertools.count():
        batch = {k: v.to(device) for k, v in next(data).items()}
        if cfg.is_encdec:
            batch["frames"] = MD.frames(
                cfg, batch["tokens"].shape[0],
                fold_seed(args.seed, MD.FRAMES_STREAM + i), device)
        if cfg.n_patches:
            batch["prefix_embeds"] = MD.prefix_embeds(
                cfg, batch["tokens"].shape[0],
                fold_seed(args.seed, MD.PREFIX_STREAM + i), device)
        yield split_workers(batch, args.workers)


def run(argv: Optional[Sequence[str]] = None
        ) -> Tuple[Any, List[Dict[str, Any]]]:
    """:func:`run_state` without the final trainer state."""
    params, history, _ = run_state(argv)
    return params, history


def run_state(argv: Optional[Sequence[str]] = None
              ) -> Tuple[Any, List[Dict[str, Any]], Any]:
    """Train as the flags say.  Returns the final parameters, one record
    per step (``loss``, ``loss_per_worker``, ``byz_mass``, ``selection``,
    the plan's (n,) selection weights, ``honest_dev``, ``agg_grad_norm``,
    ``lr``, ``seconds``; under ``--hier`` also ``group_selection``, the
    outer level's (n_groups,) mass; under a codec also
    ``wire_bytes_per_worker`` (with ``--hier`` ``leader_wire_bytes``) and,
    with ``ef=1``, ``residual_max_abs``, the largest magnitude in the
    error-feedback residual after the step; under an adaptive attack also
    ``astate``, the attack's state after the step as host floats and
    lists) and the final ``TrainerState`` (its ``mstate`` the registry and
    ring under ``--obs``).  Under ``--mesh host`` every rank
    returns them; a process group that ``run`` started is destroyed when
    it returns or raises, one that was up before is left up."""
    args = parse_args(argv)
    cfg = MD.arch_config(args.arch, reduced=args.reduced,
                         layers=args.layers)
    if args.per_worker_batch <= 0:
        raise SystemExit("--per-worker-batch must be positive")
    if cfg.is_encdec and args.trainer != "stacked":
        raise SystemExit("enc-dec supports only the stacked trainer")
    # validates (n, f, gar) and the --hier budget before anything is built
    rcfg = robust_config(args)
    hier, budget = hier_config(args)
    device = resolve_device(args.device)
    started = args.mesh == "host" and not dist.is_initialized()
    try:
        mesh = make_host_mesh(device) if args.mesh == "host" else None
        return _train(args, cfg, rcfg, device, mesh, hier, budget)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _train(args: argparse.Namespace, cfg, rcfg: RobustConfig,
           device: torch.device, mesh, hier: Optional[GroupConfig],
           budget: Optional[FBudget]
           ) -> Tuple[Any, List[Dict[str, Any]], Any]:
    """:func:`run_state` once the flags are checked (``hier`` and ``budget`` as
    :func:`hier_config` gives them) and the mesh (or None) is up."""
    lead = mesh is None or dist.get_rank() == 0

    def say(msg: str) -> None:
        if lead:
            print(msg, flush=True)

    lr_fn = warmup_cosine(args.lr, warmup=max(args.steps // 20, 1),
                          total_steps=args.steps)
    opt, step_fn = make_trainer(args, cfg, rcfg, lr_fn, mesh, hier)
    if hier is not None:
        say(f"[train] hier: {budget.n_groups} groups "
            f"{list(budget.group_sizes)} f_inner={budget.f_inner} "
            f"f_outer={budget.f_outer} inner={hier.rule} "
            f"outer={hier.resolve_outer_rule(budget)}")
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
    if args.codec and hier is not None:
        for ws in hier_wire_stats(args.codec, params, n=args.workers,
                                  g=hier.g):
            say(f"[train] wire[{ws.level}]: {ws.n} x "
                f"{ws.bytes_per_worker:,} B/step "
                f"({ws.compression:.1f}x vs fp32)")
    elif args.codec:
        ws = wire_stats(args.codec, params, n=args.workers)
        say(f"[train] wire: {ws.bytes_per_worker:,} B/worker/step "
            f"({ws.compression:.1f}x vs fp32, "
            f"{ws.chunks_per_worker} chunk(s) of {ws.chunk_bytes:,} B)")
    state = init_train_state(opt, params, n_workers=args.workers,
                             attack=args.attack, attack_f=args.f,
                             codec=args.codec)
    history: List[Dict[str, Any]] = []
    tracer = OBS.SpanTracer() if args.obs else None
    for i, wb in zip(range(args.steps), worker_batches(args, cfg, device)):
        t0 = time.perf_counter()
        with tracer.span("step", round=i) if tracer else nullcontext():
            params, state, metrics = step_fn(params, state, wb,
                                             args.seed + i)
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
        if "group_selection" in tel:
            rec["group_selection"] = tel["group_selection"].tolist()
        if "leader_wire_bytes" in tel:
            rec["leader_wire_bytes"] = tel["leader_wire_bytes"]
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
    if args.obs and lead and state.mstate is not None:
        write_obs(args, cfg, state.mstate, tracer)
    say(f"[train] done: final loss {history[-1]['loss']:.4f}"
        if history else "[train] done: no steps")
    return params, history, state


def write_obs(args: argparse.Namespace, cfg: ArchConfig, mstate,
              tracer: OBS.SpanTracer) -> None:
    """Drain ``mstate`` into the ``--obs-json`` snapshot and, with the
    tracer's host spans, the ``--obs-trace`` Chrome trace; prints the
    ``[train] obs:`` line."""
    recs = OBS.drain(mstate.get("t"))
    snap = OBS.snapshot(
        metrics=mstate["m"], trace_records=recs,
        meta={"source": "launch.train", "arch": cfg.name,
              "trainer": args.trainer, "steps": args.steps,
              "workers": args.workers, "f": args.f, "gar": args.gar,
              "attack": args.attack})
    OBS.write_snapshot(args.obs_json, snap)
    n_ev = OBS.export_chrome_trace(
        args.obs_trace, device_records=recs, host_spans=tracer.spans,
        meta={"source": "launch.train", "arch": cfg.name})
    print(f"[train] obs: {len(recs)} span records, "
          f"counters {snap['metrics']['counters']} "
          f"-> {args.obs_json}, {n_ev} trace events -> "
          f"{args.obs_trace}", flush=True)


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
