"""Observability report driver (cf. ``repro.launch.obs_report``): validate
and digest ``obs.v1`` snapshots.

Reads the snapshot that ``launch/train.py --obs`` (or the sim engine's
``CampaignResult.obs``) wrote, checks its schema, and prints a compact
digest: counters, gauges, histogram mass, the span ring's tail.  With
``--kernels`` it also runs K1, K5 and K2 at two (n, d) points under an
``obs.KernelProfiler`` on ``--device`` (``cuda`` unless ``--device cpu``,
which runs their plain versions; a missing card raises) and prints each
launch's configuration and ``vmem_predicted`` (``analysis/smem.py``'s
shared memory a block) beside what ptxas reported for its kernel
(registers, static shared memory, stack frame, spills).  Only
``--kernels`` touches a device.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.obs_report \\
      --snapshot obs_snapshot.json [--trace obs_trace.json] \\
      [--validate] [--kernels] [--device cuda]

``--validate`` exits 1 on any problem; ``--trace`` also checks that the
Chrome-trace file parses and counts its events.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence, Tuple

from repro_torch import obs as OBS
from repro_torch.device import resolve_device

#: (n, d) points for --kernels: the JAX driver's (one shallow and one
#: multi-chunk launch a kernel)
KERNEL_POINTS = ((11, 4096), (15, 65536))


def _digest(snap) -> None:
    m = snap.get("metrics") or {}
    print(f"[obs_report] schema={snap.get('schema')} "
          f"meta={json.dumps(snap.get('meta', {}), sort_keys=True)}")
    for name, v in sorted((m.get("counters") or {}).items()):
        print(f"[obs_report] counter {name} = {v:g}")
    for name, v in sorted((m.get("gauges") or {}).items()):
        flat = v if isinstance(v, list) else [v]
        if len(flat) > 4:
            print(f"[obs_report] gauge {name} = "
                  f"[{flat[0]:.4g} .. {flat[-1]:.4g}] ({len(flat)} slots)")
        else:
            print(f"[obs_report] gauge {name} = "
                  f"{[round(float(x), 4) for x in flat]}")
    for name, h in sorted((m.get("hists") or {}).items()):
        total = sum(h["counts"])
        print(f"[obs_report] hist {name}: {total} obs over "
              f"{len(h['edges']) + 1} buckets, counts={h['counts']}")
    recs = (snap.get("trace") or {}).get("records", [])
    print(f"[obs_report] span ring: {len(recs)} records retained")
    for r in recs[-8:]:
        print(f"[obs_report]   seq={r['seq']:>5} round={r['round']:>5} "
              f"{r['phase']:<12} payload={r['payload']:.4g}")
    sv = snap.get("serve")
    if sv:
        print(f"[obs_report] serve: rounds={sv.get('rounds')} "
              f"round_us p50/p95/p99 = "
              f"{sv['round_us']['p50']:.0f}/{sv['round_us']['p95']:.0f}/"
              f"{sv['round_us']['p99']:.0f}")


def _kernel_report(points: Tuple[Tuple[int, int], ...], device) -> None:
    for rec in OBS.profile_points(points, device=device):
        ptxas = rec["ptxas"]
        res = "-" if ptxas is None else "; ".join(
            f"{name}: {r['registers']} regs, {r['smem_bytes']} B smem, "
            f"{r['stack_frame']} B stack, {r['spill_stores']}/"
            f"{r['spill_loads']} B spilled" for name, r in ptxas.items())
        print(f"[obs_report] kernel {rec['kernel']:<15} {rec['route']:<5} "
              f"n={rec['n']:<4} d={rec['d']:<8} "
              f"config={json.dumps(rec['config'], sort_keys=True)} "
              f"vmem_predicted={rec['vmem_predicted']} B smem ptxas={res}")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--snapshot", default="obs_snapshot.json",
                    help="obs.v1 snapshot to digest")
    ap.add_argument("--trace", default=None,
                    help="Chrome-trace JSON to check (optional)")
    ap.add_argument("--validate", action="store_true",
                    help="exit 1 on any schema problem")
    ap.add_argument("--kernels", action="store_true",
                    help="profile K1, K5 and K2's launch configurations "
                         "at two (n, d) points (runs the real kernels)")
    ap.add_argument("--device", default="cuda",
                    help="where --kernels runs (cpu: the plain versions)")
    args = ap.parse_args(argv)

    problems = []
    try:
        with open(args.snapshot) as fh:
            snap = json.load(fh)
    except FileNotFoundError:
        problems.append(f"{args.snapshot}: missing — run "
                        "`python -m repro_torch.launch.train --obs` first")
        snap = None
    except json.JSONDecodeError as e:
        problems.append(f"{args.snapshot}: not valid JSON ({e})")
        snap = None
    if snap is not None:
        problems += [f"{args.snapshot}: {p}"
                     for p in OBS.validate_snapshot(snap)]
        _digest(snap)

    if args.trace:
        try:
            with open(args.trace) as fh:
                doc = json.load(fh)
            events = doc.get("traceEvents")
            if not isinstance(events, list) or not events:
                problems.append(f"{args.trace}: no traceEvents")
            else:
                n_dev = sum(1 for e in events if e.get("pid") == 1
                            and e.get("ph") == "X")
                print(f"[obs_report] trace: {len(events)} events "
                      f"({n_dev} device-logical) — open at "
                      "https://ui.perfetto.dev")
        except FileNotFoundError:
            problems.append(f"{args.trace}: missing")
        except json.JSONDecodeError as e:
            problems.append(f"{args.trace}: not valid JSON ({e})")

    if args.kernels:
        _kernel_report(KERNEL_POINTS, resolve_device(args.device))

    for p in problems:
        print(f"[obs_report] PROBLEM: {p}")
    if problems and args.validate:
        return 1
    if not problems:
        print("[obs_report] OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
