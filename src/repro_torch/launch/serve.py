"""Serving entry point of the port (cf. ``repro.launch.serve``): prefill a
batch of random prompts and decode new tokens with ``dist.serving.generate``.

Runs on ``cuda`` unless ``--device cpu`` is passed (a missing GPU raises;
nothing falls back).  The parameters are random, from ``--seed``;
``--layers`` cuts the depth and keeps the published widths (a multiple of
the architecture's layer period), ``--reduced`` takes the smoke-scale
variant.  A VLM config is served with a bf16 normal soft prefix of
``n_patches`` embeddings per sequence, an encoder-decoder config with bf16
normal audio frames (``n_frames`` per sequence), both from ``--seed``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --batch 4 --prompt-len 128 --new-tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \\
      --batch 2 --prompt-len 16 --new-tokens 8 --sample categorical
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \\
      --batch 4 --prompt-len 128 --new-tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \\
      --batch 4 --prompt-len 128 --new-tokens 32
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch import models as MD
from repro_torch.configs import ARCH_NAMES
from repro_torch.core.attacks import fold_seed
from repro_torch.device import resolve_device
from repro_torch.dist.serving import generate
from repro_torch.tree import tree_leaves


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_NAMES, default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced smoke-scale variant")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the "
                         "config's own)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--window", type=int, default=0,
                    help="sliding-window size (0 = full cache)")
    ap.add_argument("--sample", default="greedy",
                    choices=("greedy", "categorical"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Serve as the flags say and print the three ``[serve]`` lines.
    Returns ``params``, ``prompt``, ``extra`` (the VLM prefix or the
    encoder-decoder frames batch, or None), ``tokens`` ((batch, new_tokens) int32) and ``seconds``
    (prefill and decode, up to the last token on the device)."""
    args = parse_args(argv)
    cfg = MD.arch_config(args.arch, reduced=args.reduced,
                         layers=args.layers)
    device = resolve_device(args.device)
    params = MD.init_model(cfg, seed=args.seed, device=device)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"[serve] arch={cfg.name} params={n_params:,}", flush=True)

    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=device, dtype=torch.int32)
    extra = None
    if cfg.n_patches:
        extra = {"prefix_embeds": MD.prefix_embeds(
            cfg, args.batch, fold_seed(args.seed, MD.PREFIX_STREAM), device)}
    if cfg.is_encdec:
        extra = {"frames": MD.frames(
            cfg, args.batch, fold_seed(args.seed, MD.FRAMES_STREAM), device)}
    t0 = time.perf_counter()
    out = generate(params, cfg, prompt, args.new_tokens, window=args.window,
                   chunk_q=min(args.prompt_len, 512), sample=args.sample,
                   seed=None if args.sample == "greedy" else args.seed,
                   extra_batch=extra)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"[serve] generated {tuple(out.shape)} tokens in {dt:.2f}s "
          f"({args.batch * args.new_tokens / dt:.1f} tok/s)", flush=True)
    print("[serve] first sequence:", out[0].tolist(), flush=True)
    return {"params": params, "prompt": prompt, "extra": extra,
            "tokens": out, "seconds": dt}


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
