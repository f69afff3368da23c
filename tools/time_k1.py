#!/usr/bin/env python3
"""Time K1 (``pairwise_stats``) or K2 (``fused_select``) of several
checkouts of the port on one card.

    python3 tools/time_k1.py SRC_A SRC_B [--kernel k1|k2] [--order ABBA]
                             [--reps 5]

Each ``SRC`` is the ``src`` directory of a checkout of this repository
(for example a ``git archive`` of an earlier commit unpacked beside this
one).  The checkouts run one after another in ``--order`` (letters index
the ``SRC`` arguments), each in a child process of its own, so that two
versions of the package never share an interpreter.  A child builds the
checkout's kernels, then times the kernel's wrapper on each gradient leaf
of qwen2-1.5b cut to 2 layers at n = 11 (the leaves of ``chip_smoke.py``'s
training phase, filled as there; K2 with the multi-Bulyan plan of their
K1 distances, f = 2) and sums the median ms of each leaf: the same
per-step number as ``chip_smoke.py``'s ``ms`` for that kernel.  It also
prints a hash of the kernel's outputs over every leaf, so that two
versions that should agree bit for bit can be seen to.

The card's name and power limit come first; the last line is one JSON
object with every run and, per checkout, the median over its runs.
Needs one CUDA card and nvcc.
"""
import argparse
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys

N, F = 11, 2


def child(src, kernel, reps):
    sys.path.insert(0, src)
    import dataclasses

    import torch

    from repro_torch import models as MD
    from repro_torch.configs import get_config
    from repro_torch.core import api
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_select import fused_select_cuda
    from repro_torch.kernels.pairwise_sqdist import pairwise_stats_cuda
    from repro_torch.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build(("pairwise_stats", "fused_select"))
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=2)
    params = MD.init_model(cfg, seed=0, device="cuda")
    numels = [math.prod(p.shape) for p in tree_leaves(params)]
    del params
    torch.cuda.empty_cache()
    leaves = []
    raw = torch.zeros((N, N), dtype=torch.float32, device="cuda")
    for i, m in enumerate(numels):
        # chip_smoke.py's rows_stack: row i is N(0, (1 + 0.1 i)^2) noise
        gen = torch.Generator(device="cuda")
        gen.manual_seed(i)
        x = torch.empty((N, m), dtype=torch.float32, device="cuda")
        x.normal_(generator=gen)
        x.mul_(1.0 + 0.1 * torch.arange(N, dtype=torch.float32,
                                        device="cuda")[:, None])
        leaves.append(x)
        raw = raw + pairwise_stats_cuda(x)[0]
    plan = api.get_aggregator("multi_bulyan").plan(
        api.AggStats(n=N, f=F, dists=api.finalize_dists(raw)))
    if kernel == "k1":
        def fn(x):
            return pairwise_stats_cuda(x)
    else:
        def fn(x):
            return (fused_select_cuda(x, plan.w_ext, plan.w_agr, plan.beta),)
    digest = hashlib.sha256()
    total = 0.0
    for x in leaves:
        m = x.shape[1]
        for out in fn(x):
            digest.update(out.cpu().numpy().tobytes())
        times = []
        for _ in range(reps if m > 10_000_000 else 4 * reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn(x)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        total += statistics.median(times)
    print(json.dumps({"src": src, "kernel": kernel, "ms": total,
                      "leaves": len(numels),
                      "sha256": digest.hexdigest()}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("srcs", nargs="+")
    ap.add_argument("--kernel", choices=("k1", "k2"), default="k1")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.srcs[0], args.kernel, args.reps)
        return 0
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(out.stdout.strip(), flush=True)
    runs = []
    for letter in args.order:
        src = os.path.abspath(args.srcs[ord(letter) - ord("A")])
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--child", "--kernel", args.kernel, "--reps",
                              str(args.reps), src],
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr, flush=True)
            return 1
        run = json.loads(res.stdout.strip().splitlines()[-1])
        run["label"] = letter
        print(json.dumps(run), flush=True)
        runs.append(run)
    per = {}
    for run in runs:
        per.setdefault(run["label"], []).append(run["ms"])
    print(json.dumps({"runs": runs, "kernel": args.kernel, "median_ms": {
        k: statistics.median(v) for k, v in per.items()},
        "same_outputs": len({r["sha256"] for r in runs}) == 1}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
