"""Streaming multi-Bulyan on the PyTorch port: exact Algorithm-1
robustness without the whole gradient stack.

The paper's rule needs all n worker gradients at once; the streaming
trainer's global scope (``repro_torch.dist.streaming``) holds one
parameter block's stack at a time, takes the plan from a first pass over
every block and applies it in a second.  On a miniature jamba (hybrid
attention / mamba, MoE every other layer), where both fit, this example
runs one step of each trainer from the same state and checks that the
streaming step is the stacked one bit for bit.

Run:  PYTHONPATH=src python examples/streaming_at_scale_torch.py [--device cpu]
"""
import argparse

import torch

from repro_torch import models as MD
from repro_torch.configs import (ArchConfig, HybridConfig, MoEConfig,
                                 RobustConfig, SSMConfig)
from repro_torch.data import lm_batches
from repro_torch.device import resolve_device
from repro_torch.dist import (init_train_state, make_streaming_train_step,
                              make_train_step, split_workers)
from repro_torch.optim import constant, sgd
from repro_torch.tree import tree_leaves

#: a miniature jamba: hybrid attn/mamba with MoE every other layer
CFG = ArchConfig(
    name="mini-jamba", family="hybrid", n_layers=4, d_model=128,
    n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=512,
    moe=MoEConfig(n_experts=4, top_k=2, d_expert=128, every=2,
                  capacity_factor=8.0),
    ssm=SSMConfig(dt_rank=8),
    hybrid=HybridConfig(period=2, attn_index=1))


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rcfg = RobustConfig(n_workers=11, f=2, gar="multi_bulyan")
    params = MD.init_model(CFG, seed=0, device=device)
    opt = sgd(momentum=0.9)
    state = init_train_state(opt, params)
    batch = {k: v.to(device) for k, v in split_workers(
        next(lm_batches(CFG.vocab_size, 22, 32)), 11).items()}

    stacked = make_train_step(CFG, rcfg, opt, constant(0.05), chunk_q=16,
                              attack="sign_flip")
    stream = make_streaming_train_step(CFG, rcfg, opt, constant(0.05),
                                       scope="global", chunk_q=16,
                                       attack="sign_flip")
    p1, _, m1 = stacked(params, state, batch, 0)
    p2, _, m2 = stream(params, state, batch, 0)
    diff = max(float(torch.max(torch.abs(a - b)))
               for a, b in zip(tree_leaves(p1), tree_leaves(p2)))
    print(f"[stream] loss stacked={float(m1['loss']):.4f} "
          f"streaming={float(m2['loss']):.4f}")
    print(f"[stream] max |param diff| stacked vs streaming-global: {diff:g}")
    print("[stream] peak gradient memory: n·d (stacked) vs the largest "
          "block's n·d_block (streaming)")
    # the streaming step's gradients are the stacked step's bits (the same
    # per-worker backward, one block's leaves at a time), its statistics
    # sum the leaves in the stacked trainer's order: the two are one step
    assert diff == 0.0, diff
    return diff


if __name__ == "__main__":
    main()
