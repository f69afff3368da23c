"""End-to-end byzantine-robust training campaign on the PyTorch port.

Runs an attack-schedule *campaign* through the ``repro_torch.sim`` engine:
a clean warmup phase, then the selected attack switches on mid-run, with
plan-level telemetry showing which workers the rule selects and rejects
and how far the aggregate strays from the honest mean.

On a CUDA card (the default) every robust step's statistics and
multi-Bulyan apply run the port's kernels, K1 and K2, once per gradient
leaf.

Presets:
  smoke  ~1.5M params,  20+20 steps   [default]
  10m    ~11M params,  100+100 steps
  100m   ~124M params, 150+150 steps

Run:  PYTHONPATH=src python examples/byzantine_training_torch.py \\
          --preset smoke --attack little_is_enough:z=4.0 \\
          --gar multi_bulyan --compare-average [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.configs import ArchConfig
from repro_torch.sim import (AttackPhase, AttackSchedule, DataConfig,
                             Scenario, report, run_campaign)

PRESETS = {
    "smoke": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                  d_ff=512, vocab_size=512, seq=64, steps=20),
    "10m": dict(n_layers=4, d_model=320, n_heads=8, n_kv_heads=4,
                d_ff=1280, vocab_size=2048, seq=128, steps=100),
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                 d_ff=3072, vocab_size=8192, seq=256, steps=150),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--preset", choices=PRESETS, default="smoke")
    ap.add_argument("--gar", default="multi_bulyan")
    ap.add_argument("--attack", default="little_is_enough:z=4.0",
                    help="attack spec for the second phase "
                         "(adaptive_lie / adaptive_mimic also work)")
    ap.add_argument("--workers", type=int, default=11)
    ap.add_argument("--f", type=int, default=2)
    ap.add_argument("--per-worker-batch", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--trainer", default="stacked",
                    choices=("stacked", "stream_block", "stream_global"))
    ap.add_argument("--transform", action="append", default=[],
                    help="e.g. worker_momentum:beta=0.9 (repeatable)")
    ap.add_argument("--noniid-alpha", type=float, default=0.0)
    ap.add_argument("--report", default=None, help="JSON campaign report")
    ap.add_argument("--compare-average", action="store_true",
                    help="also run the campaign with plain averaging")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    p = PRESETS[args.preset]
    cfg = ArchConfig(name=f"byz-{args.preset}", family="dense",
                     n_layers=p["n_layers"], d_model=p["d_model"],
                     n_heads=p["n_heads"], n_kv_heads=p["n_kv_heads"],
                     d_ff=p["d_ff"], vocab_size=p["vocab_size"])
    schedule = AttackSchedule((
        AttackPhase(steps=p["steps"], attack="none"),
        AttackPhase(steps=p["steps"], attack=args.attack),
    ))
    runs = [args.gar] + (["average"] if args.compare_average else [])
    results = {}
    for gar in runs:
        sc = Scenario(
            name=f"byz-{args.preset}-{gar}", schedule=schedule,
            n_workers=args.workers, f=args.f, gar=gar,
            transforms=tuple(args.transform), trainer=args.trainer,
            arch=cfg, data=DataConfig(noniid_alpha=args.noniid_alpha),
            per_worker_batch=args.per_worker_batch, seq=p["seq"],
            lr=args.lr)
        print(f"[byz] gar={gar} schedule={schedule.describe()} "
              f"n={args.workers} f={args.f} trainer={args.trainer}")
        result = run_campaign(sc, verbose=True, device=args.device)
        post = result.summary["phases"][-1]
        sel = np.asarray(post["selection_mean"])
        print(f"[byz]   under {post['attack']}: loss "
              f"{post['loss_first']:.4f} -> {post['loss_last']:.4f}, "
              f"honest_dev mean {post['honest_dev_mean']:.3f}, byzantine "
              f"selection mass {post['byz_mass_mean']:.4f}")
        print(f"[byz]   mean selection  byz={np.round(sel[:args.f], 3)} "
              f"honest={np.round(sel[args.f:], 3)}")
        print(f"[byz]   final suspicion {np.round(post['suspicion_last'], 2)}")
        if args.report:
            stem, dot, ext = args.report.rpartition(".")
            path = f"{stem}.{gar}.{ext}" if dot else f"{args.report}.{gar}"
            print(f"[byz]   report -> {report.write_json(path, result)}")
        results[gar] = result
    return results


if __name__ == "__main__":
    main()
