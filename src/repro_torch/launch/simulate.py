"""Byzantine campaign simulator CLI of the port (cf.
``repro.launch.simulate``; ``repro_torch.sim``).

Runs a declarative attack-schedule campaign through the sim engine and
writes a JSON/CSV report with plan-level telemetry (per-worker selection,
Krum score spectra, honest-mean deviation, suspicion EMA).  Campaigns run
on ``--device`` (``cuda`` unless ``--device cpu``: a missing card raises;
nothing falls back), with the CUDA kernels unless ``--no-use-kernels``
(on the CPU their plain versions).

Phases are ``STEPS=ATTACK_SPEC`` (attack specs take parameter overrides
after a colon), optionally with ``@f=K`` to lower the effective number of
byzantine workers for that phase:

  PYTHONPATH=src python -m repro_torch.launch.simulate \\
      --gar multi_bulyan --workers 11 --f 2 \\
      --phase 20=none --phase 20=little_is_enough:z=4.0 \\
      --report campaign.json --csv campaign.csv
  PYTHONPATH=src python -m repro_torch.launch.simulate --smoke --device cpu

``--smoke`` runs the acceptance campaign — a 40-step
``no_attack -> little_is_enough`` switch — for the selected robust rule AND
for plain averaging, asserts the paper's story on the traces (robust rule:
bounded post-switch honest-mean deviation, ≈ 0 byzantine selection mass;
averaging: dragged far off the honest mean), and exits non-zero otherwise.
It then sweeps codec × attack: short switch campaigns over the
``repro_torch.comm`` wire formats — including a wire-level attack —
asserting the robust rule stays bounded on the *decoded* stack, per-phase
``WireStats`` land in the ``sim.campaign.v1`` summary, and wire bytes are
strictly ordered fp32 > bf16 > qsgd int8.  ``--smoke --async-tau 1`` and
``--smoke --hier g=7`` run the async churn and the poisoned-subtree
acceptance campaigns instead.  The thresholds and exit codes are the JAX
CLI's.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Tuple

from repro_torch.sim import (AttackPhase, AttackSchedule, DataConfig,
                             Scenario, report, run_campaign,
                             switch_scenario)

# --smoke acceptance thresholds (the JAX CLI's): the robust rule must
# keep its aggregate within 2x of the honest-gradient scale with < 2%
# byzantine selection mass; averaging
# under little_is_enough:z=4 is fully captured (byzantine mass = its f/n
# share), sits >= 2x the robust rule's honest-mean deviation and stops
# making loss progress.
ROBUST_DEV_MAX = 2.0
ROBUST_BYZ_MASS = 0.02
AVERAGE_DEV_FACTOR = 2.0
AVERAGE_CAPTURE = 0.75          # of its f/n share
AVERAGE_LOSS_MARGIN = 0.2


def parse_phase(text: str) -> AttackPhase:
    """``STEPS=SPEC[@f=K][@stale=W1+W2...]`` -> AttackPhase."""
    steps_s, eq, rest = text.partition("=")
    if not eq:
        raise ValueError(f"bad --phase {text!r} (want STEPS=ATTACK_SPEC)")
    try:
        steps = int(steps_s)
    except ValueError:
        raise ValueError(f"bad step count in --phase {text!r}") from None
    spec, f_eff, stale = rest, None, ()
    if "@" in rest:
        spec, *mods = rest.split("@")
        for mod in mods:
            k, _, v = mod.partition("=")
            if k == "f":
                f_eff = int(v)
            elif k == "stale":
                stale = tuple(int(w) for w in v.split("+") if w)
            else:
                raise ValueError(f"unknown phase modifier {mod!r} in "
                                 f"--phase {text!r}")
    return AttackPhase(steps=steps, attack=spec, f=f_eff,
                       stale_workers=stale)


def _smoke(args) -> int:
    """Acceptance campaign: robust rule vs averaging across the switch."""
    import numpy as np

    results = {}
    for gar in (args.gar, "average"):
        sc = switch_scenario(
            gar, pre=20, post=20, n_workers=args.workers, f=args.f,
            trainer=args.trainer, use_kernels=args.use_kernels,
            seed=args.seed)
        results[gar] = run_campaign(sc, verbose=True, device=args.device)
        if args.report:
            stem, dot, ext = args.report.rpartition(".")
            path = f"{stem}.{gar}.{ext}" if dot else f"{args.report}.{gar}"
            print(f"[sim] report -> {report.write_json(path, results[gar])}")

    post = slice(20, 40)
    rb, av = results[args.gar].trace, results["average"].trace
    rb_dev = float(np.mean(rb["honest_dev"][post]))
    rb_dev_max = float(np.max(rb["honest_dev"][post]))
    rb_byz = float(np.mean(rb["byz_mass"][post]))
    av_dev = float(np.mean(av["honest_dev"][post]))
    av_byz = float(np.mean(av["byz_mass"][post]))
    share = args.f / args.workers
    print(f"[sim] --smoke post-switch: {args.gar} honest_dev "
          f"mean={rb_dev:.3f} max={rb_dev_max:.3f} byz_mass={rb_byz:.4f}; "
          f"average honest_dev mean={av_dev:.3f} byz_mass={av_byz:.4f}")
    problems: List[str] = []
    if rb_dev_max > ROBUST_DEV_MAX:
        problems.append(f"{args.gar} post-switch honest_dev max {rb_dev_max:.3f} "
                        f"> {ROBUST_DEV_MAX}")
    if rb_byz > ROBUST_BYZ_MASS:
        problems.append(f"{args.gar} post-switch byzantine selection mass "
                        f"{rb_byz:.4f} > {ROBUST_BYZ_MASS}")
    if av_dev < AVERAGE_DEV_FACTOR * rb_dev:
        problems.append(f"average honest_dev {av_dev:.3f} not >= "
                        f"{AVERAGE_DEV_FACTOR}x {args.gar}'s {rb_dev:.3f}")
    if av_byz < AVERAGE_CAPTURE * share:
        problems.append(f"average byzantine mass {av_byz:.4f} below "
                        f"{AVERAGE_CAPTURE}x its f/n share {share:.3f} — "
                        f"attack did not engage?")
    rb_final = float(rb["loss"][-1])
    av_final = float(av["loss"][-1])
    if av_final < rb_final + AVERAGE_LOSS_MARGIN:
        problems.append(f"average final loss {av_final:.3f} not >= "
                        f"{args.gar}'s {rb_final:.3f} + "
                        f"{AVERAGE_LOSS_MARGIN} — averaging kept learning "
                        f"under the attack")
    problems += _smoke_codec_sweep(args)
    for p in problems:
        print(f"[sim] SMOKE FAILED: {p}", file=sys.stderr)
    if not problems:
        print("[sim] --smoke OK: robust rule bounded, byzantine rows "
              "deselected, averaging dragged off the honest mean; codec "
              "sweep bounded with ordered wire bytes")
    return 1 if problems else 0


# codec × attack sweep grid: a gradient-space attack that must survive the
# quantized wire + a wire-format attack that only exists because of it
SWEEP_CODECS = ("fp32", "bf16", "qsgd:bits=8")
SWEEP_ATTACKS = ("little_is_enough:z=4.0", "scale_poison:gain=50")
SWEEP_STEPS = 6                 # per phase — selection stabilises in 2-3


def _smoke_codec_sweep(args) -> List[str]:
    """Short codec × attack switch campaigns on the robust rule."""
    import numpy as np

    problems: List[str] = []
    bytes_per_worker = {}
    for codec in SWEEP_CODECS:
        for attack in SWEEP_ATTACKS:
            if attack.startswith("scale_poison") and codec == "fp32":
                # the identity wire has no scale sidecar — the attack
                # degenerates to payload scaling; skip the redundant cell
                continue
            sc = switch_scenario(
                args.gar, pre=SWEEP_STEPS, post=SWEEP_STEPS, attack=attack,
                n_workers=args.workers, f=args.f, trainer=args.trainer,
                use_kernels=args.use_kernels, seed=args.seed, codec=codec)
            r = run_campaign(sc, device=args.device)
            post = slice(SWEEP_STEPS, 2 * SWEEP_STEPS)
            byz = float(np.mean(r.trace["byz_mass"][post]))
            dev = float(np.max(r.trace["honest_dev"][post]))
            wire = r.summary.get("wire")
            print(f"[sim] codec sweep {codec} × {attack}: honest_dev "
                  f"max={dev:.3f} byz_mass={byz:.4f} "
                  f"bytes/worker={wire and wire['bytes_per_worker']}")
            tag = f"codec {codec} × {attack}"
            if wire is None or \
                    any("wire" not in ph for ph in r.summary["phases"]):
                problems.append(f"{tag}: WireStats missing from the "
                                "campaign summary phases")
                continue
            bytes_per_worker[codec] = wire["bytes_per_worker"]
            if dev > ROBUST_DEV_MAX:
                problems.append(f"{tag}: post-switch honest_dev {dev:.3f} "
                                f"> {ROBUST_DEV_MAX}")
            if byz > ROBUST_BYZ_MASS:
                problems.append(f"{tag}: byzantine selection mass "
                                f"{byz:.4f} > {ROBUST_BYZ_MASS}")
    order = [bytes_per_worker.get(c, 0) for c in SWEEP_CODECS]
    if not order[0] > order[1] > order[2] > 0:
        problems.append(
            f"wire bytes not strictly ordered fp32 > bf16 > qsgd int8: "
            f"{dict(zip(SWEEP_CODECS, order))}")
    return problems


# --smoke --async-tau churn acceptance: the same no_attack -> attack
# switch, but every round goes through the real bounded-staleness buffer
# (repro_torch.serve) with two honest stragglers delivering only every
# ``stale_period`` rounds.  stale_period > tau+1 makes their slots
# overstale between deliveries, so the campaign actually exercises the
# effective-f haircut — asserted via the n_overstale telemetry — while
# the robust rule must hold the same deviation/selection-mass thresholds
# as the synchronous smoke.
ASYNC_SMOKE_STEPS = 8
ASYNC_STALE = (9, 10)           # honest stragglers (byz rows come first)


def _smoke_async(args) -> int:
    import numpy as np

    sched = AttackSchedule((
        AttackPhase(steps=ASYNC_SMOKE_STEPS, attack="none"),
        AttackPhase(steps=ASYNC_SMOKE_STEPS,
                    attack="little_is_enough:z=4.0",
                    stale_workers=ASYNC_STALE)))
    sc = Scenario(name="async-churn", schedule=sched, gar=args.gar,
                  n_workers=args.workers, f=args.f, seed=args.seed,
                  use_kernels=args.use_kernels,
                  async_tau=args.async_tau, stale_period=args.stale_period)
    r = run_campaign(sc, verbose=True, device=args.device)
    if args.report:
        print(f"[sim] report -> {report.write_json(args.report, r)}")

    post = slice(ASYNC_SMOKE_STEPS, 2 * ASYNC_SMOKE_STEPS)
    dev = float(np.max(r.trace["honest_dev"][post]))
    byz = float(np.mean(r.trace["byz_mass"][post]))
    n_over_max = float(np.max(r.trace["n_overstale"]))
    f_def_min = float(np.min(r.trace["f_defended"]))
    reused = float(np.sum(r.trace["plan_reused"]))
    print(f"[sim] async churn (tau={args.async_tau}, "
          f"period={args.stale_period}): honest_dev max={dev:.3f} "
          f"byz_mass={byz:.4f} n_overstale max={n_over_max:.0f} "
          f"f_defended min={f_def_min:.0f} plans_reused={reused:.0f}")
    problems: List[str] = []
    if dev > ROBUST_DEV_MAX:
        problems.append(f"async churn honest_dev max {dev:.3f} > "
                        f"{ROBUST_DEV_MAX}")
    if byz > ROBUST_BYZ_MASS:
        problems.append(f"async churn byzantine selection mass {byz:.4f} "
                        f"> {ROBUST_BYZ_MASS}")
    if args.stale_period > args.async_tau + 1 and n_over_max < 1:
        problems.append(
            f"stale_period {args.stale_period} > tau+1 "
            f"{args.async_tau + 1} but no overstale slot was ever "
            "charged — the churn never reached the buffer")
    if n_over_max >= 1 and f_def_min >= args.f:
        problems.append("overstale slots were charged but f_defended "
                        "never dropped below the contract — the haircut "
                        "is not wired")
    for p in problems:
        print(f"[sim] SMOKE FAILED: {p}", file=sys.stderr)
    if not problems:
        print("[sim] --smoke --async-tau OK: churn replayed through the "
              "real buffer, overstale slots haircut the budget, robust "
              "rule stayed bounded with byzantine rows deselected")
    return 1 if problems else 0


def _hier_fields(args) -> dict:
    """``--hier SPEC`` -> the Scenario hier_* field dict (empty when unset)."""
    if not args.hier:
        return {}
    from repro_torch.hier import GroupConfig
    gc = GroupConfig.from_spec(args.hier, rule=args.gar)
    return dict(hier_g=gc.g, hier_rule=gc.rule, hier_outer_rule=gc.outer_rule,
                hier_f_inner=gc.f_inner, hier_f_outer=gc.f_outer,
                hier_enforce=gc.enforce_budget)


# --smoke --hier poisoned-subtree acceptance: the adversary owns a whole
# contiguous group (rows 0..f-1 = group 0 under the contiguous balanced
# assignment).  Three campaigns tell the story end to end:
#   defended  — within-budget hierarchy, byzantine rows deselected inside
#               their groups exactly like the flat rule;
#   captured  — deliberately under-provisioned inner budget (f_inner=1
#               against a fully colluding group, enforce=0) with a plain
#               averaging outer level: group 0's aggregate is byzantine and
#               its full 1/n_groups mass flows into the update;
#   rejected  — same under-provisioned inner budget, but a robust outer
#               rule (krum over 5 group aggregates, f_outer=1) throws the
#               captured group's aggregate away: byzantine mass back to ≈ 0,
#               group 0 gets zero outer selection mass under attack, and its
#               suspicion EMA rises every attacked step.  (Krum's one-hot
#               selection leaves most *honest* groups unselected each step
#               too, so an argmax-suspicion check would be flaky — the
#               deterministic signature is zero mass + monotone suspicion.)
HIER_SMOKE_STEPS = 6
HIER_CAPTURE_MIN = 0.2          # captured byz mass ≥ this (its share is 1/3)


def _smoke_hier(args) -> int:
    import numpy as np

    def run(name, **kw):
        sched = AttackSchedule((
            AttackPhase(steps=HIER_SMOKE_STEPS, attack="none"),
            AttackPhase(steps=HIER_SMOKE_STEPS,
                        attack="little_is_enough:z=4.0")))
        sc = Scenario(name=name, schedule=sched, gar=args.gar,
                      trainer=args.trainer, use_kernels=args.use_kernels,
                      seed=args.seed, **kw)
        r = run_campaign(sc, verbose=True, device=args.device)
        if args.report:
            stem, dot, ext = args.report.rpartition(".")
            path = f"{stem}.{name}.{ext}" if dot else f"{args.report}.{name}"
            print(f"[sim] report -> {report.write_json(path, r)}")
        return r

    post = slice(HIER_SMOKE_STEPS, 2 * HIER_SMOKE_STEPS)
    problems: List[str] = []

    defended = run("hier-defended", n_workers=21, f=1, hier_g=7)
    byz = float(np.mean(defended.trace["byz_mass"][post]))
    dev = float(np.max(defended.trace["honest_dev"][post]))
    print(f"[sim] hier defended: honest_dev max={dev:.3f} "
          f"byz_mass={byz:.4f}")
    if byz > ROBUST_BYZ_MASS:
        problems.append(f"hier-defended byz_mass {byz:.4f} > "
                        f"{ROBUST_BYZ_MASS}")
    if dev > ROBUST_DEV_MAX:
        problems.append(f"hier-defended honest_dev max {dev:.3f} > "
                        f"{ROBUST_DEV_MAX}")
    if "group_selection" not in defended.trace:
        problems.append("hier-defended trace missing group_selection")

    captured = run("hier-captured", n_workers=21, f=7, hier_g=7,
                   hier_f_inner=1, hier_f_outer=0, hier_enforce=False)
    byz = float(np.mean(captured.trace["byz_mass"][post]))
    print(f"[sim] hier captured (under-provisioned inner): "
          f"byz_mass={byz:.4f} (group share 1/3)")
    if byz < HIER_CAPTURE_MIN:
        problems.append(f"hier-captured byz_mass {byz:.4f} < "
                        f"{HIER_CAPTURE_MIN} — the poisoned subtree "
                        "should have flowed through the averaging outer")

    rejected = run("hier-rejected", n_workers=35, f=7, hier_g=7,
                   hier_f_inner=1, hier_f_outer=1, hier_outer_rule="krum",
                   hier_enforce=False)
    byz = float(np.mean(rejected.trace["byz_mass"][post]))
    gsel0 = float(np.mean(rejected.trace["group_selection"][post, 0]))
    gsusp0 = rejected.trace["group_suspicion"][post, 0]
    print(f"[sim] hier rejected (robust outer): byz_mass={byz:.4f} "
          f"group0_selection={gsel0:.4f} "
          f"group0_suspicion={np.round(gsusp0, 3).tolist()}")
    if byz > ROBUST_BYZ_MASS:
        problems.append(f"hier-rejected byz_mass {byz:.4f} > "
                        f"{ROBUST_BYZ_MASS} — krum outer should drop the "
                        "captured group aggregate")
    if gsel0 > ROBUST_BYZ_MASS:
        problems.append(f"hier-rejected group 0 outer selection mass "
                        f"{gsel0:.4f} > {ROBUST_BYZ_MASS} — the poisoned "
                        "subtree's aggregate should never be picked")
    if not np.all(np.diff(gsusp0) > 0):
        problems.append(f"hier-rejected group 0 suspicion not strictly "
                        f"rising under attack: {gsusp0.tolist()}")

    for p in problems:
        print(f"[sim] SMOKE FAILED: {p}", file=sys.stderr)
    if not problems:
        print("[sim] --smoke --hier OK: within-budget hierarchy bounded, "
              "under-provisioned subtree captured through an averaging "
              "outer, robust outer rejects it with group 0 at zero "
              "selection mass and rising suspicion")
    return 1 if problems else 0


def main(argv: Optional[Tuple[str, ...]] = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--smoke", action="store_true",
                    help="run + assert the acceptance switch campaign")
    ap.add_argument("--phase", action="append", default=[],
                    metavar="STEPS=SPEC[@f=K][@stale=W1+W2]",
                    help="append a schedule phase (repeatable)")
    ap.add_argument("--gar", default="multi_bulyan")
    ap.add_argument("--workers", type=int, default=11)
    ap.add_argument("--f", type=int, default=2)
    ap.add_argument("--trainer", default="stacked",
                    choices=("stacked", "stream_block", "stream_global"))
    ap.add_argument("--hier", default=None, metavar="SPEC",
                    help="two-level grouped aggregation (repro_torch.hier), "
                         "e.g. 'g=7' or 'g=7,f_inner=1,f_outer=0,enforce=0'; "
                         "with --smoke runs the poisoned-subtree "
                         "acceptance campaigns instead of the flat switch")
    ap.add_argument("--transform", action="append", default=[],
                    help="pre-aggregation transform spec (repeatable), "
                         "e.g. worker_momentum:beta=0.9")
    ap.add_argument("--codec", default=None,
                    help="wire codec spec (repro_torch.comm), e.g. "
                         "qsgd:bits=8; enables wire attacks (scale_poison, payload_flip) "
                         "in --phase specs and per-phase WireStats in the "
                         "report")
    ap.add_argument("--async-tau", type=int, default=0, dest="async_tau",
                    help="bounded-staleness async aggregation "
                         "(repro_torch.serve): buffer slots older than TAU rounds are overstale "
                         "and haircut the byzantine budget (0 = sync "
                         "lockstep); with --smoke runs the async churn "
                         "acceptance campaign")
    ap.add_argument("--stale-period", type=int, default=4,
                    dest="stale_period",
                    help="async churn: stale workers deliver every PERIOD "
                         "rounds (default 4)")
    ap.add_argument("--noniid-alpha", type=float, default=0.0,
                    help="Dirichlet alpha for non-IID worker data "
                         "(0 = i.i.d.)")
    ap.add_argument("--n-domains", type=int, default=4)
    ap.add_argument("--per-worker-batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--use-kernels", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="route stats + bulyan apply through the CUDA "
                         "kernels (their plain versions on the CPU)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--report", default=None, help="JSON report path")
    ap.add_argument("--csv", default=None, help="CSV trace path")
    ap.add_argument("--name", default="campaign")
    args = ap.parse_args(argv)

    if args.smoke:
        if args.hier:
            return _smoke_hier(args)
        if args.async_tau > 0:
            return _smoke_async(args)
        return _smoke(args)

    if not args.phase:
        ap.error("need at least one --phase (or --smoke)")
    sc = Scenario(
        name=args.name,
        schedule=AttackSchedule(tuple(parse_phase(p) for p in args.phase)),
        n_workers=args.workers, f=args.f, gar=args.gar,
        transforms=tuple(args.transform), codec=args.codec,
        trainer=args.trainer, use_kernels=args.use_kernels,
        data=DataConfig(noniid_alpha=args.noniid_alpha,
                        n_domains=args.n_domains),
        per_worker_batch=args.per_worker_batch, seq=args.seq, lr=args.lr,
        seed=args.seed, async_tau=args.async_tau,
        stale_period=args.stale_period, **_hier_fields(args))
    print(f"[sim] {sc.name}: {sc.schedule.describe()} gar={sc.gar} "
          f"n={sc.n_workers} f={sc.f} trainer={sc.trainer}")
    result = run_campaign(sc, ckpt_dir=args.ckpt_dir, resume=args.resume,
                          verbose=True, device=args.device)
    if not result.summary:  # resume found every phase already completed
        print(f"[sim] nothing left to run: checkpoint already covers all "
              f"{sc.schedule.total_steps} steps")
        return 0
    s = result.summary
    print(f"[sim] done: {s['total_steps']} steps, final loss "
          f"{s['final_loss']:.4f}, honest_dev max "
          f"{s.get('honest_dev_max', float('nan')):.3f}, byz_mass mean "
          f"{s.get('byz_mass_mean', float('nan')):.4f} "
          f"({result.wall_s:.1f}s)")
    if args.report:
        print(f"[sim] report -> {report.write_json(args.report, result)}")
    if args.csv:
        print(f"[sim] trace  -> {report.write_csv(args.csv, result)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
