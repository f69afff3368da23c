"""Batched serving example on the port: prefill a request batch, decode
continuations (the port of ``examples/robust_serving.py``).

Shows the serving path (KV caches, the sliding-window ring cache for long
contexts) on the reduced qwen2-1.5b, on the card unless ``--device cpu``.

Run:  PYTHONPATH=src python examples/robust_serving_torch.py --device cpu \\
          --batch 8 --prompt-len 48 --new-tokens 24 --window 16
"""
import argparse
import time

import torch

from repro_torch import models as MD
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.device import resolve_device
from repro_torch.dist.serving import generate
from repro_torch.tree import tree_leaves


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_NAMES, default="qwen2-1.5b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--window", type=int, default=0,
                    help=">0 = sliding-window ring cache")
    ap.add_argument("--sample", default="greedy",
                    choices=("greedy", "categorical"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    params = MD.init_model(cfg, seed=0, device=device)
    print(f"[serve] {cfg.name}: "
          f"{sum(p.numel() for p in tree_leaves(params)):,} params, "
          f"batch={args.batch}, window={args.window or 'full cache'}")

    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=device, dtype=torch.int32)
    t0 = time.perf_counter()
    out = generate(params, cfg, prompts, args.new_tokens,
                   window=args.window, chunk_q=min(args.prompt_len, 512),
                   sample=args.sample,
                   seed=None if args.sample == "greedy" else 0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"[serve] {args.batch}x{args.new_tokens} tokens in {dt:.2f}s "
          f"({args.batch * args.new_tokens / dt:.1f} tok/s)")
    for i in range(min(3, args.batch)):
        print(f"[serve] seq {i}: {out[i].tolist()}")
    return out


if __name__ == "__main__":
    main()
