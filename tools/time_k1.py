#!/usr/bin/env python3
"""Time K1 (``pairwise_stats``), K2 (``fused_select``), K3
(``coord_select``), K5 (``dequant_stats``), K6 (``pairwise_stats_rect``)
or K7 (``dequant_stats_rect``) of several checkouts of the port on one
card.

    python3 tools/time_k1.py SRC_A SRC_B [--kernel k1|k2|k3|k5|k6|k7]
                             [--dtype int8|bf16] [--grid square|block]
                             [--copy] [--profile] [--order ABBA]
                             [--reps 5] [--n 11] [--f 2]
                             [--thetas 33,34,...]

Each ``SRC`` is the ``src`` directory of a checkout of this repository
(for example a ``git archive`` of an earlier commit unpacked beside this
one).  The checkouts run one after another in ``--order`` (letters index
the ``SRC`` arguments), each in a child process of its own, so that two
versions of the package never share an interpreter.  A child builds the
checkout's kernels, then times the kernel's wrapper on each gradient leaf
of qwen2-1.5b cut to 2 layers, stacked ``--n`` rows deep (the leaves of
``chip_smoke.py``'s training phase at n = 11, filled as there, one leaf
on the card at a time) and sums the median ms of each leaf: the same
per-step number as ``chip_smoke.py``'s ``ms`` for that kernel.  K2 takes
the multi-Bulyan plan of the leaves' K1 distances at ``--f`` (theta =
n - 2f - 2, beta = theta - 2f); K3 takes that plan's theta and beta on
(theta, d) ``g_ext``/``g_agr`` filled with the leaf's noise (one product
of the stack would not fit beside the stack at theta = 32).  K5 and K7
take the leaf's wire payload in ``--dtype``: the QSGD int8 (``qsgd:bits=8``)
or the bf16 form, with its per-row multipliers (QSGD's scales, bf16's
ones) and row 0's negated, as a ``scale_poison`` row sends it.  K6 and
K7 take ``--grid``: ``square`` is the whole stack (payload) as the block
(a one-rank mesh: K1's / K5's symmetric grid); ``block`` pads it to 4
ranks' rows with zero rows (and multipliers; n_loc = 3 of 12 at n = 11,
as in ``chip_smoke.py``'s mesh phase), times rank 1's block (the
rectangular grid; K6 on a view of the padded stack, its view path) and
hashes every rank's.  K6's ``--copy`` makes each block a copy (the
rectangular grid without the view path): the same bits, so the same
hash.  It also prints a hash of the kernel's outputs over every leaf, so
that two versions that should agree bit for bit can be seen to.
``--profile`` adds one more pass over the leaves under ``torch.profiler``
and reports the device time of each CUDA kernel it launched, summed over
the leaves (``"profile"``: {kernel name: ms}).  K2 and K3 also report
their bound over the leaves (``"bound_ms"``, ``"bound_by"``), as
``analysis/bounds.py``'s ``k2_bound_s`` / ``k3_bound_s`` count it, and the
same with the selection on the kernel's own slots (``"slots_bound_ms"``,
``bounds.kernel_slots`` on the checkout's ``NETWORK_SLOTS``).  The bounds
come from this tool's own tree (``bounds.py`` loaded by its path, as it
imports nothing of the package), so that every checkout is held to one
version of the arithmetic, and a checkout older than that module runs
too.
``--thetas`` (K2 / K3) times each listed theta on ``chip_smoke.py``'s
sweep stack in place of the leaves (``wide_sweep_case``: 2^22 columns, K2
on theta + 6 rows with ``kernels/select_cases.py``'s ``synthetic_plan``,
K3 on (theta, 2^22) inputs, beta = theta - 4); ``"per_theta"`` holds each
theta's median ms and bounds, and for a network variant (theta 33 to
128) its bucket's slots, threads a block, shared memory bytes a block and
blocks an SM (``fused_select.wide_shape``, where the checkout has it).

The card's name and power limit come first; the last line is one JSON
object with every run and, per checkout, the median over its runs.
Needs one CUDA card and nvcc.
"""
import argparse
import hashlib
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys

N, F = 11, 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tool_bounds():
    """This tool's own ``src/repro_torch/analysis/bounds.py``, loaded by
    its path (not the checkout's under test)."""
    path = os.path.join(ROOT, "src", "repro_torch", "analysis", "bounds.py")
    spec = importlib.util.spec_from_file_location("time_k1_bounds", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def fill(torch, rows, m, seed):
    """chip_smoke.py's rows_stack: row i is N(0, (1 + 0.1 i)^2) noise."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.empty((rows, m), dtype=torch.float32, device="cuda")
    x.normal_(generator=gen)
    x.mul_(1.0 + 0.1 * torch.arange(rows, dtype=torch.float32,
                                    device="cuda")[:, None])
    return x


def wire_payload(torch, x, dtype, seed):
    """(payload, fp32 multipliers) of x's int8 QSGD or bf16 wire, row 0's
    multiplier negated."""
    from repro_torch.comm import codecs as CC
    codec = CC.get_codec("qsgd:bits=8" if dtype == "int8" else "bf16")
    enc, _ = codec.encode(x, seed=seed)
    p, mult = codec.dequant_form(enc.payload, enc.sidecar)
    mult = mult.float().contiguous()
    mult[0] = -mult[0]
    return p.contiguous(), mult


def padded(torch, x, ranks=4):
    """``x`` with zero rows appended to ``ranks`` blocks of n_loc rows
    (``chip_smoke.py``'s ``padded``), and n_loc."""
    n_loc = -(-x.shape[0] // ranks)
    full = x.new_zeros((n_loc * ranks,) + tuple(x.shape[1:]))
    full[:x.shape[0]] = x
    return full, n_loc


def padded_blocks(torch, *tensors, ranks=4, copy=False):
    """Each tensor padded to ``ranks`` blocks of rows, and the blocks: for
    each rank the tuple of its rows of every padded tensor (views, or
    copies with ``copy``)."""
    fulls = [padded(torch, t, ranks)[0] for t in tensors]
    n_loc = fulls[0].shape[0] // ranks
    cut = (lambda t: t.clone()) if copy else (lambda t: t)
    return fulls, [tuple(cut(f[r * n_loc:(r + 1) * n_loc]) for f in fulls)
                   for r in range(ranks)]


def device_ms(torch, fn):
    """{kernel name: device ms} of the CUDA kernels ``fn()`` launches,
    from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return out


def theta_sweep(torch, kernel, thetas, reps):
    """{"ms": the sum, "sha256", "per_theta": {theta: {"ms", "bound_ms",
    "bound_by", "slots_bound_ms", and the network variant's "slots",
    "threads", "smem_bytes", "blocks_per_sm"}}} of K2 or K3 at each theta on ``chip_smoke.py``'s
    sweep stack (``wide_sweep_case``)."""
    sys.path.insert(1, ROOT)
    import chip_smoke
    from repro_torch.kernels import fused_select
    shape_fn = getattr(fused_select, "wide_shape", None)
    library = "fused_select" if kernel == "k2" else "coord_select"
    digest, per = hashlib.sha256(), {}
    for theta in thetas:
        fn, args, bound, own = chip_smoke.wide_sweep_case(
            torch, kernel, theta, tool_bounds())
        digest.update(fn(*args).cpu().numpy().tobytes())
        per[theta] = {"ms": chip_smoke.time_ms(torch, lambda: fn(*args),
                                               reps),
                      "bound_ms": 1e3 * max(bound.values()),
                      "bound_by": max(bound, key=bound.get),
                      "slots_bound_ms": 1e3 * max(own.values())}
        shape = shape_fn and shape_fn(theta, library)
        if shape:
            per[theta].update(shape)
        del args
        torch.cuda.empty_cache()
    return {"ms": sum(r["ms"] for r in per.values()),
            "sha256": digest.hexdigest(), "per_theta": per}


def child(src, kernel, reps, n, f, dtype, grid, copy, profile, thetas):
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
    names = ("pairwise_stats", "fused_select")
    if kernel == "k3":
        from repro_torch.kernels.coord_select import coord_select_cuda
        names += ("coord_select",)
    if kernel in ("k5", "k7"):
        from repro_torch.kernels.dequant_stats import (
            dequant_stats_cuda, dequant_stats_rect_cuda)
        names += ("dequant_stats", "dequant_stats_rect")
    if kernel == "k6":
        from repro_torch.kernels.pairwise_sqdist import \
            pairwise_stats_rect_cuda
        names += ("pairwise_stats_rect",)
    build.build(names)
    if thetas:
        print(json.dumps({"src": src, "kernel": kernel,
                          **theta_sweep(torch, kernel, thetas, reps)}),
              flush=True)
        return
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=2)
    params = MD.init_model(cfg, seed=0, device="cuda")
    numels = [math.prod(p.shape) for p in tree_leaves(params)]
    del params
    torch.cuda.empty_cache()
    raw = torch.zeros((n, n), dtype=torch.float32, device="cuda")
    for i, m in enumerate(numels):
        raw = raw + pairwise_stats_cuda(fill(torch, n, m, i))[0]
    plan = api.get_aggregator("multi_bulyan").plan(
        api.AggStats(n=n, f=f, dists=api.finalize_dists(raw)))
    theta = plan.w_ext.shape[0]
    bound = {}
    if kernel in ("k2", "k3"):
        from repro_torch.kernels import fused_select
        bounds = tool_bounds()
        # a checkout without the network variant counts theta above 32
        own_slots = bounds.kernel_slots(
            theta, getattr(fused_select, "NETWORK_SLOTS", ()))
        s, own = ({"bytes": 0.0, "operations": 0.0} for _ in range(2))
        for slots, tot in ((None, s), (own_slots, own)):
            for m in numels:
                leaf = bounds.k2_bound_s(n, m, theta, plan.beta, slots) \
                    if kernel == "k2" else bounds.k3_bound_s(
                        m, theta, plan.beta, slots)
                for key in tot:
                    tot[key] += leaf[key]
        bound = {"bound_ms": 1e3 * max(s.values()),
                 "bound_by": max(s, key=s.get),
                 "slots_bound_ms": 1e3 * max(own.values())}

    def inputs(i, m):
        if kernel in ("k5", "k7"):
            return wire_payload(torch, fill(torch, n, m, i), dtype, i)
        if kernel != "k3":
            return (fill(torch, n, m, i),)
        g = fill(torch, 2 * theta, m, i)
        return g[:theta], g[theta:]

    hashed = None       # what is hashed, when it is not what is timed
    blocks = None       # --grid block: the padded inputs and every rank's

    if kernel == "k1":
        def fn(x):
            return pairwise_stats_cuda(x)
    elif kernel == "k2":
        def fn(x):
            return (fused_select_cuda(x, plan.w_ext, plan.w_agr, plan.beta),)
    elif kernel == "k3":
        def fn(ge, ga):
            return (coord_select_cuda(ge, ga, plan.beta),)
    elif kernel == "k5":
        def fn(p, mult):
            return dequant_stats_cuda(p, mult)
    elif kernel == "k6" and grid == "square":
        def fn(x):
            return pairwise_stats_rect_cuda(x, x, n=n)
    elif kernel == "k6":
        def fn(x):
            return pairwise_stats_rect_cuda(*blocks[1][1], *blocks[0], n=n)

        def hashed(x):
            return [t for b in blocks[1] for t in
                    pairwise_stats_rect_cuda(*b, *blocks[0], n=n)]
    elif grid == "square":
        def fn(p, mult):
            return dequant_stats_rect_cuda(p, mult, p, mult, n=n)
    else:
        def fn(p, mult):
            pf, mf = blocks[0]
            return dequant_stats_rect_cuda(*blocks[1][1], pf, mf, n=n)

        def hashed(p, mult):
            pf, mf = blocks[0]
            return [t for b in blocks[1] for t in dequant_stats_rect_cuda(
                *b, pf, mf, n=n)]
    digest = hashlib.sha256()
    total = 0.0
    per_kernel = {}
    for i, m in enumerate(numels):
        args = inputs(i, m)
        if kernel in ("k6", "k7") and grid == "block":
            blocks = padded_blocks(torch, *args, copy=copy)
        for out in (hashed or fn)(*args):
            digest.update(out.cpu().numpy().tobytes())
        times = []
        for _ in range(reps if m > 10_000_000 else 4 * reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn(*args)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        total += statistics.median(times)
        if profile:
            for name, ms in device_ms(torch, lambda: fn(*args)).items():
                per_kernel[name] = per_kernel.get(name, 0.0) + ms
        del args
        blocks = None
    print(json.dumps({"src": src, "kernel": kernel, "ms": total,
                      "leaves": len(numels), "n": n, "theta": theta,
                      "beta": plan.beta, "dtype": dtype, "grid": grid,
                      "copy": copy, "sha256": digest.hexdigest(), **bound,
                      **({"profile": per_kernel} if profile else {})}),
          flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("srcs", nargs="+")
    ap.add_argument("--kernel", choices=("k1", "k2", "k3", "k5", "k6", "k7"),
                    default="k1")
    ap.add_argument("--dtype", choices=("int8", "bf16"), default="int8",
                    help="K5 / K7: the wire payload's type")
    ap.add_argument("--grid", choices=("square", "block"), default="square",
                    help="K6 / K7: the whole stack, or rank 1 of 4 blocks")
    ap.add_argument("--copy", action="store_true",
                    help="K6 --grid block: copies of the blocks, not views")
    ap.add_argument("--profile", action="store_true",
                    help="device ms of each kernel launched, by name")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--f", type=int, default=F)
    ap.add_argument("--thetas", default="",
                    help="K2 / K3: comma-separated thetas on a synthetic "
                         "stack in place of the leaves")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    thetas = [int(t) for t in args.thetas.split(",") if t]
    if thetas and args.kernel not in ("k2", "k3"):
        ap.error("--thetas takes --kernel k2 or k3")
    if args.child:
        child(args.srcs[0], args.kernel, args.reps, args.n, args.f,
              args.dtype, args.grid, args.copy, args.profile, thetas)
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
                              str(args.reps), "--n", str(args.n), "--f",
                              str(args.f), "--dtype", args.dtype, "--grid",
                              args.grid, *(["--copy"] if args.copy else []),
                              *(["--profile"] if args.profile else []),
                              "--thetas", args.thetas, src],
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr, flush=True)
            return 1
        run = json.loads(res.stdout.strip().splitlines()[-1])
        run["label"] = letter
        print(json.dumps(run), flush=True)
        runs.append(run)
    per, per_theta = {}, {}
    for run in runs:
        per.setdefault(run["label"], []).append(run["ms"])
        for theta, r in run.get("per_theta", {}).items():
            per_theta.setdefault(theta, {}).setdefault(
                run["label"], []).append(r["ms"])
    print(json.dumps({"runs": runs, "kernel": args.kernel, "n": args.n,
                      "f": args.f, "dtype": args.dtype, "grid": args.grid,
                      "copy": args.copy,
                      "median_ms": {
        k: statistics.median(v) for k, v in per.items()},
        **({"median_ms_per_theta": {
            t: {k: statistics.median(v) for k, v in by.items()}
            for t, by in per_theta.items()}} if per_theta else {}),
        "same_outputs": len({r["sha256"] for r in runs}) == 1}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
