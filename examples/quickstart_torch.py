"""Quickstart of the PyTorch port: MULTI-BULYAN in 60 seconds.

1. aggregate a stack of gradients containing byzantine rows;
2. run byzantine-robust distributed training of a small LM.

On a CUDA card (the default) part 2's statistics and multi-Bulyan apply
run the port's kernels, K1 and K2, once per gradient leaf per step.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
from typing import Dict, List

import numpy as np
import torch

from repro_torch import models as MD
from repro_torch.configs import ArchConfig, RobustConfig
from repro_torch.core import aggregate, apply_attack, theory
from repro_torch.data import lm_batches
from repro_torch.device import resolve_device
from repro_torch.dist import init_train_state, make_train_step, split_workers
from repro_torch.optim import constant, sgd

RULES = ("average", "median", "multi_krum", "multi_bulyan")
#: part 2's model: a 2-layer dense LM
CFG = ArchConfig(name="quickstart", family="dense", n_layers=2, d_model=64,
                 n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128)


def part1_gar(device) -> Dict[str, float]:
    """The four rules on a (15, 1000) stack with 3 ``inf`` rows; returns
    each rule's cosine to the true gradient."""
    print("=== 1. the GAR itself ===")
    device = resolve_device(device)
    n, f, d = 15, 3, 1000
    rng = np.random.default_rng(0)
    g_true = np.ones(d, np.float32)                      # the true gradient
    correct = g_true + 0.1 * rng.normal(size=(n - f, d)).astype(np.float32)
    stack = apply_attack(torch.from_numpy(correct).to(device), f,
                         "inf")                          # f byzantine rows
    cosines = {}
    for rule in RULES:
        agg = aggregate(stack, f, rule)
        cosines[rule] = theory.cone_cosine(agg.cpu(),
                                           torch.from_numpy(g_true))
        print(f"  {rule:13s} cos(angle to true gradient) = "
              f"{cosines[rule]:+.3f}")
    print(f"  theory: multi-bulyan slowdown vs averaging = "
          f"{theory.multi_bulyan_slowdown(n, f):.2f} "
          f"(Thm 2(iii) — and it is byzantine-proof)")
    return cosines


def part2_training(device, steps: int = 8) -> List[float]:
    """A 2-layer dense LM trained by 11 workers, 2 of them sending 1e30s,
    under multi-Bulyan; returns the losses."""
    print("=== 2. robust distributed training ===")
    device = resolve_device(device)
    rcfg = RobustConfig(n_workers=11, f=2, gar="multi_bulyan")
    params = MD.init_model(CFG, seed=0, device=device)
    opt = sgd(momentum=0.9)
    state = init_train_state(opt, params)
    step = make_train_step(CFG, rcfg, opt, constant(0.05), chunk_q=16,
                           attack="inf")
    data = lm_batches(CFG.vocab_size, 22, 16)
    losses = []
    for i in range(steps):
        batch = {k: v.to(device) for k, v in
                 split_workers(next(data), rcfg.n_workers).items()}
        params, state, m = step(params, state, batch, i)
        losses.append(float(m["loss"]))
        print(f"  step {i}: loss={losses[-1]:.4f}  "
              f"(2 byzantine workers sending 1e30s — training unharmed)")
    return losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    part1_gar(args.device)
    part2_training(args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
