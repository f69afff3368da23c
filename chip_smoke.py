#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Phases; any failure exits non-zero and no result line is printed:

1. header: the card's name and power limit, as ``nvidia-smi`` reports them;
2. build: compile the CUDA kernels from ``src/repro_torch/csrc`` with
   ``nvcc`` for ``sm_90a`` (one process per source, started together);
3. kernels vs plain versions: K1 ``pairwise_stats`` and K2
   ``fused_select`` at n = 11 on d in {1, 4095, 100003, 1000000}, on the
   qwen2-1.5b embedding leaf (11, 233373696) and on one stack carrying the
   ``inf`` attack.  Tolerances: K1 distances and norms within
   1e-5 x max(1, max |plain|) on finite entries, with non-finite entries
   (NaN, inf) at the same places; K2 within 1e-6 x max(1, max |plain|).
   The multi-Bulyan plan built from the kernel's distances must equal the
   plan built from the plain distances bit for bit;
4. training: ``repro_torch.launch.train`` through its entry point at
   qwen2-1.5b's full width (d_model 1536, 12/2 heads, d_ff 8960, vocab
   151936) cut to 2 layers: 11 workers, f = 2, multi_bulyan, the ``inf``
   attack, SGD with momentum, seq 128, 2 sequences a worker, 3 steps,
   kernels on.  Every loss must be finite, the byzantine selection mass 0
   at every step, and K1 and K2 must each launch once per gradient leaf
   per step;
5. timing at the main path's leaf shapes (one launch per leaf, summed over
   the leaves of one step; median of repeats, CUDA events);
6. profile: one more steady-state step of the same configuration under
   ``torch.profiler``: device-busy share and the kernels that take the
   most device time;
7. the ``kernels`` JSON line, then the last line:
   ``{"ok": true, "device": {...}}``.

Run from the repository root, on a machine with one CUDA card and nvcc:
    python3 chip_smoke.py
"""
import collections
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

N, F = 11, 2
CHECK_WIDTHS = (1, 4095, 100_003, 1_000_000)
EMBED_WIDTH = 151936 * 1536           # qwen2-1.5b's tied embedding leaf
K1_TOL, K2_TOL = 1e-5, 1e-6
HBM_BYTES_PER_S = 3.35e12             # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12               # H100 SXM data sheet, non-tensor fp32
TRAIN_ARGS = ["--arch", "qwen2-1.5b", "--layers", "2", "--steps", "3",
              "--seq", "128", "--per-worker-batch", "2", "--workers", str(N),
              "--f", str(F), "--gar", "multi_bulyan", "--attack", "inf",
              "--optimizer", "sgd", "--use-kernels", "--device", "cuda"]


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


# ------------------------------------------------------------------ phases
def header():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    line = out.stdout.strip().splitlines()[0]
    print(line, flush=True)
    return line


def build_kernels():
    from repro_torch.kernels import build
    seconds, logs = build.build()
    for name, text in logs.items():
        for ln in text.splitlines():
            if "registers" in ln or "spill" in ln or "error" in ln.lower():
                log(f"nvcc {name}: {ln.strip()}")
    log(f"build: {len(logs)} kernel(s) compiled in {seconds:.1f}s")


def rows_stack(torch, d, seed):
    """(N, d) fp32 on the card: row i is N(0, s_i^2) noise with distinct
    s_i, so pairwise distances (about d (s_i^2 + s_j^2)) are well apart
    and the plan cannot flip on an ulp."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.empty((N, d), dtype=torch.float32, device="cuda")
    x.normal_(generator=gen)
    scale = 1.0 + 0.1 * torch.arange(N, dtype=torch.float32, device="cuda")
    return x.mul_(scale[:, None])


def with_inf_attack(torch, x):
    from repro_torch.core import attacks as ATK
    x[:F] = ATK.inf_attack(x[F:], F)
    return x


def plan_of(raw):
    from repro_torch.core import api
    stats = api.AggStats(n=N, f=F, dists=api.finalize_dists(raw))
    return api.get_aggregator("multi_bulyan").plan(stats)


def compare_k1(torch, got, want):
    """(max abs err, max rel err) over finite entries; non-finite entries
    must sit at the same places."""
    check(torch.equal(torch.isnan(got), torch.isnan(want)),
          "NaN pattern differs")
    fin = torch.isfinite(want)
    check(torch.equal(torch.isfinite(got), fin), "inf pattern differs")
    check(torch.equal(got[~fin & ~torch.isnan(want)],
                      want[~fin & ~torch.isnan(want)]), "inf signs differ")
    if not bool(fin.any()):
        return 0.0, 0.0
    err = float(torch.max(torch.abs(got[fin] - want[fin])))
    scale = max(1.0, float(torch.max(torch.abs(want[fin]))))
    return err, err / scale


def kernels_vs_plain(torch):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fused_select import fused_select_cuda
    from repro_torch.kernels.pairwise_sqdist import pairwise_stats_cuda
    cases = [(f"d={d}", d, False) for d in CHECK_WIDTHS]
    cases += [(f"embed d={EMBED_WIDTH}", EMBED_WIDTH, False),
              ("inf attack d=1000000", 1_000_000, True)]
    worst = {"pairwise_stats": 0.0, "fused_select": 0.0}
    for label, d, attacked in cases:
        x = rows_stack(torch, d, seed=d)
        if attacked:
            x = with_inf_attack(torch, x)
        raw_k, sq_k = pairwise_stats_cuda(x)
        raw_p, sq_p = ref.pairwise_stats_ref(x)
        torch.cuda.synchronize()
        e_d, r_d = compare_k1(torch, raw_k, raw_p)
        e_s, r_s = compare_k1(torch, sq_k, sq_p)
        check(r_d <= K1_TOL and r_s <= K1_TOL,
              f"K1 {label}: rel err dists {r_d:.3e} norms {r_s:.3e} "
              f"> {K1_TOL}")
        plan_k, plan_p = plan_of(raw_k), plan_of(raw_p)
        same_plan = torch.equal(plan_k.w_ext, plan_p.w_ext) and \
            torch.equal(plan_k.w_agr, plan_p.w_agr)
        check(same_plan, f"K1 {label}: plan from kernel distances differs")
        if attacked:
            byz = float(torch.sum(plan_k.selection_weights()[:F]))
            check(byz == 0.0, f"inf attack: byzantine plan mass {byz}")
        out_k = fused_select_cuda(x, plan_p.w_ext, plan_p.w_agr,
                                  plan_p.beta)
        out_p = ref.fused_select_ref(x, plan_p.w_ext, plan_p.w_agr,
                                     plan_p.beta)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out_k).all()), f"K2 {label}: non-finite")
        e_2 = float(torch.max(torch.abs(out_k - out_p)))
        scale = max(1.0, float(torch.max(torch.abs(out_p))))
        check(e_2 <= K2_TOL * scale,
              f"K2 {label}: abs err {e_2:.3e} > {K2_TOL} x {scale:.3e}")
        log(f"{label:24s} K1 dists abs {e_d:.3e} rel {r_d:.3e} | norms "
            f"abs {e_s:.3e} rel {r_s:.3e} | plan identical | K2 abs "
            f"{e_2:.3e} bitwise={bool(torch.equal(out_k, out_p))}")
        worst["pairwise_stats"] = max(worst["pairwise_stats"], e_d, e_s)
        worst["fused_select"] = max(worst["fused_select"], e_2)
        del x, raw_k, sq_k, raw_p, sq_p, out_k, out_p
        torch.cuda.empty_cache()
    ops.reset_launch_counts()
    return worst


def training(torch):
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, history = train.run(TRAIN_ARGS)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    shapes = [(N,) + tuple(p.shape) for p in tree_leaves(params)]
    del params
    torch.cuda.empty_cache()
    steps = len(history)
    check(steps == 3, f"expected 3 steps, got {steps}")
    for i, rec in enumerate(history):
        check(math.isfinite(rec["loss"]) and all(
            math.isfinite(v) for v in rec["loss_per_worker"]),
            f"step {i}: non-finite loss {rec['loss']}")
        check(rec["byz_mass"] == 0.0,
              f"step {i}: byzantine selection mass {rec['byz_mass']}")
    want = len(shapes) * steps
    for name, got in counts.items():
        check(got == want, f"{name}: {got} launches, want {want} "
              f"({len(shapes)} leaves x {steps} steps)")
    step_s = [rec["seconds"] for rec in history]
    log(f"training: {steps} steps, losses "
        f"{[round(r['loss'], 4) for r in history]}, byz_mass 0 each step, "
        f"launches {counts} = {len(shapes)} leaves x {steps} steps; "
        f"step seconds {[round(s, 4) for s in step_s]} (first includes "
        f"warm-up); wall {wall:.1f}s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return counts, shapes, step_s


def time_ms(torch, fn, reps):
    """Median ms of ``fn()`` over ``reps`` runs after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def timing(torch, shapes):
    """Per-step sums over the main path's leaves of each function's median
    time, with the bound from this run's shapes."""
    from repro_torch.core import api
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_select import fused_select_cuda
    from repro_torch.kernels.pairwise_sqdist import pairwise_stats_cuda
    numels = [math.prod(s[1:]) for s in shapes]
    leaves = [rows_stack(torch, m, seed=i) for i, m in enumerate(numels)]
    raw = torch.zeros((N, N), dtype=torch.float32, device="cuda")
    for x in leaves:
        raw = raw + pairwise_stats_cuda(x)[0]
    plan = plan_of(raw)
    theta = plan.w_ext.shape[0]
    tot = {k: 0.0 for k in ("k1", "k1_plain", "k1_lib", "k2", "k2_plain")}
    bound = {k: {"bytes": 0.0, "operations": 0.0} for k in ("k1", "k2")}
    for x in leaves:
        m = x.shape[1]
        reps = 5 if m > 10_000_000 else 20
        tot["k1"] += time_ms(torch, lambda: pairwise_stats_cuda(x), reps)
        tot["k1_plain"] += time_ms(
            torch, lambda: ref.pairwise_stats_ref(x), reps)
        tot["k1_lib"] += time_ms(torch, lambda: torch.mm(x, x.t()), reps)
        tot["k2"] += time_ms(torch, lambda: fused_select_cuda(
            x, plan.w_ext, plan.w_agr, plan.beta), reps)
        tot["k2_plain"] += time_ms(torch, lambda: ref.fused_select_ref(
            x, plan.w_ext, plan.w_agr, plan.beta), min(reps, 3))
        # each input read once, each output written once; fp32 operations
        # outside the tensor cores (the gram's upper triangle for K1, the
        # two (theta, n) contractions for K2)
        bound["k1"]["bytes"] += 4 * (N * m + N * N + N) / HBM_BYTES_PER_S
        bound["k1"]["operations"] += N * (N + 1) * m / FP32_FLOP_PER_S
        bound["k2"]["bytes"] += 4 * (N * m + m + 2 * theta * N) \
            / HBM_BYTES_PER_S
        bound["k2"]["operations"] += 4 * theta * N * m / FP32_FLOP_PER_S
    for k, b in bound.items():
        tot[f"{k}_bound_by"] = max(b, key=b.get)
        tot[f"{k}_bound"] = 1e3 * max(b.values())
    del leaves
    torch.cuda.empty_cache()
    log(f"timing over {len(shapes)} leaves ({sum(numels):,} coordinates "
        f"x {N} workers), ms per step: " + ", ".join(
            f"{k} {v}" for k, v in tot.items()))
    return tot


def profile_step(torch):
    """One steady-state step of the training phase's configuration, traced:
    device time summed over the kernels the profiler saw, against the
    step's wall time (synchronised; the profiler's own cost included)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import models as MD
    from repro_torch.configs import RobustConfig, get_config
    from repro_torch.data import lm_batches
    from repro_torch.dist import (init_train_state, make_train_step,
                                  split_workers)
    from repro_torch.optim import constant, sgd
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=2)
    rcfg = RobustConfig(n_workers=N, f=F, gar="multi_bulyan")
    opt = sgd(momentum=0.9)
    params = MD.init_model(cfg, seed=0, device="cuda")
    state = init_train_state(opt, params)
    step = make_train_step(cfg, rcfg, opt, constant(0.05), chunk_q=128,
                           attack="inf", telemetry=True)
    data = lm_batches(cfg.vocab_size, 2 * N, 128, seed=0)

    def one(params, state, i):
        wb = {k: v.to("cuda") for k, v in split_workers(next(data),
                                                         N).items()}
        return step(params, state, wb, i)

    params, state, _ = one(params, state, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, _ = one(params, state, 1)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    del params, state
    torch.cuda.empty_cache()
    per_kernel = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            acc = per_kernel[e.name]
            acc[0] += e.time_range.elapsed_us() / 1e3
            acc[1] += 1
    busy_ms = sum(v[0] for v in per_kernel.values())
    rows = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    log(f"profile: one step {wall_ms:.1f} ms wall under the profiler, "
        f"kernels busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%), "
        f"{sum(v[1] for v in per_kernel.values())} kernel launches")
    for name, (ms, count) in rows[:15]:
        log(f"  {ms:10.3f} ms {count:6d}x  {name[:100]}")


def main():
    try:
        import torch
    except ImportError:
        print("[chip_smoke] FAIL: torch is not installed", flush=True)
        return 2
    if not torch.cuda.is_available():
        print("[chip_smoke] FAIL: torch.cuda.is_available() is False; this "
              "smoke run needs a CUDA card", flush=True)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"[chip_smoke] FAIL: no src/repro_torch next to {__file__}; "
              "run from a checkout of the repository", flush=True)
        return 2
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        power = header()
        build_kernels()
        t0 = time.perf_counter()
        worst = kernels_vs_plain(torch)
        log(f"kernels vs plain versions: {time.perf_counter() - t0:.1f}s")
        counts, shapes, step_s = training(torch)
        tot = timing(torch, shapes)
        profile_step(torch)
    except SmokeFailure as e:
        print(f"[chip_smoke] FAIL: {e}", flush=True)
        return 1
    kernels = [
        {"name": "pairwise_stats", "route": "cuda",
         "source": "src/repro_torch/csrc/pairwise_stats.cu",
         "replaces": "src/repro/kernels/pairwise_sqdist.py:139",
         "launches": counts["pairwise_stats"],
         "max_abs_err": worst["pairwise_stats"],
         "ms": tot["k1"], "plain_ms": tot["k1_plain"],
         "bound_ms": tot["k1_bound"], "bound_by": tot["k1_bound_by"],
         "library_ms": tot["k1_lib"]},
        {"name": "fused_select", "route": "cuda",
         "source": "src/repro_torch/csrc/fused_select.cu",
         "replaces": "src/repro/kernels/fused_select.py:142",
         "launches": counts["fused_select"],
         "max_abs_err": worst["fused_select"],
         "ms": tot["k2"], "plain_ms": tot["k2_plain"],
         "bound_ms": tot["k2_bound"], "bound_by": tot["k2_bound_by"],
         "library_ms": None},
    ]
    log(f"card: {power}; step seconds {step_s}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
