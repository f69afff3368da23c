"""Campaign engine (cf. ``repro.sim.engine``): execute a
:class:`~repro_torch.sim.scenario.Scenario`.

Structure: the *phase loop* and the *step loop* are host-side Python.
Each phase has its own threat model (attack spec, effective f, churn
mask), so each distinct ``(attack, f)`` gets one trainer step, built by
``dist.make_train_step``, ``dist.make_streaming_train_step`` or
``serve.service.make_async_train_step`` with ``telemetry=True`` and
reused by every phase that shares it.  The JAX engine's per-phase jitted
``lax.scan`` has no counterpart: a phase is its steps, one after another,
each step's record copied to the host as numpy when it ends.

Data (including the Dirichlet non-IID assignment and the straggler/churn
masks — stale workers are frozen to their phase-entry batch, or on the
async path deliver only every ``stale_period`` rounds) is synthesised on
the host per phase.  The batch and the step's attack and codec
randomness are keyed by the *global* step index (``fold_seed(seed,
step)``), so traces are reproducible and a resume from a phase-boundary
checkpoint replays the remaining phases exactly.

With ``obs=`` the registry and span ring ride in ``TrainerState.mstate``
across every phase, in the boundary checkpoints, and drain once at the
end into ``CampaignResult.obs``.  The JAX engine's legacy checkpoint key
aliases are not needed: the port never wrote that layout.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import models as MD
from repro_torch import obs as OBS
from repro_torch.checkpoint import latest_step, restore, save
from repro_torch.configs.base import RobustConfig
from repro_torch.core import attacks as ATK
from repro_torch.data import (dirichlet_mixture, make_lm_batch,
                              make_noniid_lm_batch)
from repro_torch.device import resolve_device
from repro_torch.dist import (TrainerState, init_train_state,
                              make_streaming_train_step, make_train_step,
                              split_workers)
from repro_torch.optim import sgd, warmup_cosine
from repro_torch.sim import telemetry as TEL
from repro_torch.sim.scenario import AttackPhase, Scenario

Tree = Any
Tensor = torch.Tensor

#: the seed stream of the non-IID mixture, as the JAX engine's
#: ``fold_in(key, 424242)``
MIXTURE_STREAM = 424242


@dataclasses.dataclass
class CampaignResult:
    """A finished campaign: the stacked per-step trace + per-phase digest.

    ``trace`` maps field name -> (steps, ...) numpy array (see
    ``telemetry.step_record`` for the schema); ``summary`` is the host-side
    per-phase digest (``telemetry.summarize``).  ``start_step`` > 0 when the
    run resumed from a checkpoint (the trace covers executed steps only).
    ``wire`` is the campaign's ``comm.WireStats`` accounting as a plain dict
    (None without a codec) — ``summarize`` repeats it per phase so the
    ``sim.campaign.v1`` report carries it.  ``obs`` is the drained
    ``obs.v1`` snapshot when the campaign ran with an enabled
    ``obs.ObsConfig`` (None otherwise: the report then has no ``obs``
    key).
    """

    scenario: Scenario
    trace: Dict[str, np.ndarray]
    summary: Dict[str, Any]
    start_step: int = 0
    wall_s: float = 0.0
    wire: Optional[Dict[str, Any]] = None
    obs: Optional[Dict[str, Any]] = None


def _init_params(scenario: Scenario, device: torch.device) -> Tree:
    """The campaign's initial parameters, from ``scenario.seed``."""
    return MD.init_model(scenario.arch, seed=scenario.seed, device=device)


def _make_batch_gen(scenario: Scenario, mixture: Optional[Tensor]
                    ) -> Callable[[Sequence[int]], Dict[str, Tensor]]:
    """One batch generator per campaign: global step indices -> worker-split
    int64 token batches on the CPU, leaves (steps, n, pwb, seq).

    Step s draws from a generator seeded ``fold_seed(scenario.seed, s)``,
    so phase layout does not change the data.
    """
    n, pwb, seq = scenario.n_workers, scenario.per_worker_batch, scenario.seq
    vocab = scenario.arch.vocab_size

    def one(step_idx: int) -> Dict[str, Tensor]:
        gen = torch.Generator()
        gen.manual_seed(ATK.fold_seed(scenario.seed, step_idx))
        if mixture is not None:
            b = make_noniid_lm_batch(gen, vocab, n, pwb, seq, mixture,
                                     seed=scenario.seed + 77)
        else:
            b = make_lm_batch(gen, vocab, n * pwb, seq,
                              seed=scenario.seed + 77)
        return split_workers(b, n)

    def gen(steps: Sequence[int]) -> Dict[str, Tensor]:
        batches = [one(int(s)) for s in steps]
        return {k: torch.stack([b[k] for b in batches])
                for k in batches[0]}

    return gen


def _phase_batches(gen, phase: AttackPhase, start: int,
                   *, freeze: bool = True) -> Dict[str, Tensor]:
    """Worker-split token batches for one phase: leaves (steps, n, pwb, ...).

    Stale (churned) workers are frozen to the phase's first batch — they
    keep resubmitting gradients computed on old data.  On the async path
    (``freeze=False``) the data stays fresh: staleness is modelled by the
    real gradient buffer instead (missed deadlines replay the worker's
    *buffered* gradient, see :func:`_phase_fresh`).
    """
    batches = gen(range(start, start + phase.steps))
    if freeze:
        for w in phase.stale_workers:
            for x in batches.values():
                x[:, w] = x[0, w]
    return batches


def _phase_fresh(scenario: Scenario, phase: AttackPhase,
                 start: int) -> Tensor:
    """(steps, n) bool delivery masks for the async buffered path, on the
    CPU.

    A phase's ``stale_workers`` miss the round deadline and deliver only
    every ``scenario.stale_period`` rounds (keyed by *global* step so
    resume replays the same arrival schedule); everyone else delivers
    every round.
    """
    fresh = np.ones((phase.steps, scenario.n_workers), dtype=bool)
    for w in phase.stale_workers:
        for t in range(phase.steps):
            fresh[t, w] = (start + t) % scenario.stale_period == 0
    return torch.from_numpy(fresh)


_PLAN_DATA = ("weights", "w_ext", "w_agr")


def _ckpt_state(state: TrainerState) -> TrainerState:
    """``state`` as the checkpoint stores it: the buffered plan by its data
    fields only, as the JAX package's registered ``AggPlan`` flattens."""
    if state.bstate is None:
        return state
    plan = state.bstate.plan
    return dataclasses.replace(state, bstate=dataclasses.replace(
        state.bstate, plan={k: getattr(plan, k) for k in _PLAN_DATA}))


def _restored_state(loaded: TrainerState, like: TrainerState
                    ) -> TrainerState:
    """Undo :func:`_ckpt_state`: the plan's meta fields from ``like``."""
    if like.bstate is None:
        return loaded
    plan = dataclasses.replace(like.bstate.plan, **loaded.bstate.plan)
    return dataclasses.replace(loaded, bstate=dataclasses.replace(
        loaded.bstate, plan=plan))


def run_campaign(scenario: Scenario, *, ckpt_dir: Optional[str] = None,
                 resume: bool = False, verbose: bool = False,
                 device: Optional[Union[str, torch.device]] = None,
                 obs: Optional[OBS.ObsConfig] = None) -> CampaignResult:
    """Run a scenario end to end on ``device`` (``cuda`` unless asked
    otherwise; a missing card raises); returns the trace + summary.

    ``ckpt_dir`` enables checkpointing at phase boundaries (params,
    optimizer state, transform states, the error-feedback residual, the
    async buffer, the suspicion EMAs — keyed by global step, in the JAX
    package's file format).  With ``resume`` the engine restores the
    latest phase-boundary checkpoint and replays only the remaining
    phases; the returned trace then starts at ``start_step``.

    ``obs`` (an enabled ``obs.ObsConfig``) seeds the registry and span ring
    into ``TrainerState.mstate`` before the phase loop (``serve_spec`` on
    the async path, ``train_spec(telemetry=True)`` otherwise), threads it
    through every step of every phase and through the boundary
    checkpoints (a resume restores it), and drains it into
    ``CampaignResult.obs`` as an ``obs.v1`` snapshot.
    """
    t0 = time.time()
    dev = resolve_device(device)
    cfg = scenario.arch
    n = scenario.n_workers
    rcfg = RobustConfig(n_workers=n, f=scenario.f, gar=scenario.gar,
                        use_kernels=scenario.use_kernels,
                        grouped=scenario.hier_g > 0)
    transforms = scenario.build_transforms()
    total_steps = scenario.schedule.total_steps

    params = _init_params(scenario, dev)
    opt = sgd(momentum=scenario.momentum)
    hier = scenario.hier_config()
    wire = None
    if scenario.codec is not None:
        if hier is not None:
            # two-hop accounting: workers→leaders + leaders→server
            from repro_torch.comm import hier_wire_stats
            lv0, lv1 = hier_wire_stats(scenario.codec, params, n=n,
                                       g=scenario.hier_g)
            wire = {"levels": [lv0.to_json(), lv1.to_json()]}
        else:
            from repro_torch.comm import wire_stats
            wire = wire_stats(scenario.codec, params, n=n).to_json()
    # attack state is per-phase (seeded at each phase entry below), so the
    # cross-phase TrainerState carries astate=None between phases; the
    # error-feedback residual (like transform states) is cross-phase
    tstate = init_train_state(opt, params, transforms, n_workers=n,
                              codec=scenario.codec)
    is_async = scenario.async_tau > 0
    if is_async:
        # the campaign replays through the real bounded-staleness buffer
        from repro_torch.core import api
        from repro_torch.serve import service as SRV
        svc = SRV.AsyncAggService(
            backend=api.AggregatorBackend.for_config(rcfg, needs_dists=True),
            tau=scenario.async_tau)
        tstate = SRV.with_buffer(tstate, svc, params, n)
    if OBS.obs_on(obs):
        ms = OBS.init_serve_obs(obs, n, scenario.async_tau, telemetry=True,
                                device=dev) if is_async else \
            OBS.init_train_obs(obs, n, telemetry=True, device=dev)
        tstate = dataclasses.replace(tstate, mstate=ms)
    susp = TEL.init_suspicion(n, device=dev)
    stale_ema = TEL.init_suspicion(n, device=dev)
    gsusp = None
    if hier is not None:
        gsusp = TEL.init_suspicion(hier.budget(n, scenario.f).n_groups,
                                   device=dev)
    lr_fn = warmup_cosine(scenario.lr, warmup=max(total_steps // 20, 1),
                          total_steps=total_steps)

    mixture = None
    if scenario.data.noniid_alpha > 0:
        mgen = torch.Generator()
        mgen.manual_seed(ATK.fold_seed(scenario.seed, MIXTURE_STREAM))
        mixture = dirichlet_mixture(mgen, n, scenario.data.n_domains,
                                    scenario.data.noniid_alpha)

    def ckpt_tree():
        ck = {"params": params, "state": _ckpt_state(tstate), "susp": susp}
        if gsusp is not None:
            ck["gsusp"] = gsusp
        if is_async:
            ck["stale"] = stale_ema
        return ck

    start_step = 0
    if ckpt_dir and resume:
        latest = latest_step(ckpt_dir)
        boundary_steps = {stop for _, stop in scenario.schedule.bounds()}
        if latest is not None and latest not in boundary_steps:
            raise ValueError(
                f"checkpoint step {latest} is not a phase boundary of "
                f"schedule {scenario.schedule.describe()!r}")
        if latest is not None:
            loaded = restore(ckpt_dir, latest, ckpt_tree())
            params = loaded["params"]
            tstate = _restored_state(loaded["state"], tstate)
            susp = loaded["susp"]
            gsusp = loaded.get("gsusp", gsusp)
            stale_ema = loaded.get("stale", stale_ema)
            start_step = latest
            if verbose:
                print(f"[sim] resumed {scenario.name} at step {latest}",
                      flush=True)

    chunk_q = min(scenario.seq, 512)
    phase_traces = []
    batch_gen = _make_batch_gen(scenario, mixture)
    step_fns: Dict[tuple, Callable] = {}

    def make_step(attack: str, f_eff: int):
        if is_async:
            from repro_torch.serve.service import make_async_train_step
            return make_async_train_step(
                cfg, rcfg, opt, lr_fn, tau=scenario.async_tau,
                chunk_q=chunk_q, attack=attack, attack_f=f_eff,
                telemetry=True, obs=obs)
        if scenario.trainer == "stacked":
            return make_train_step(
                cfg, rcfg, opt, lr_fn, chunk_q=chunk_q, attack=attack,
                attack_f=f_eff, transforms=transforms,
                codec=scenario.codec, telemetry=True, hier=hier, obs=obs)
        scope = "global" if scenario.trainer.endswith("global") else "block"
        return make_streaming_train_step(
            cfg, rcfg, opt, lr_fn, scope=scope, chunk_q=chunk_q,
            attack=attack, attack_f=f_eff, codec=scenario.codec,
            telemetry=True, hier=hier, obs=obs)

    ema = scenario.suspicion_ema
    for phase_idx, ((start, stop), phase) in enumerate(
            zip(scenario.schedule.bounds(), scenario.schedule.phases)):
        if stop <= start_step:
            continue  # phase fully covered by the restored checkpoint
        f_eff = scenario.phase_f(phase)
        key = (phase.attack, f_eff)
        if key not in step_fns:
            step_fns[key] = make_step(phase.attack, f_eff)
        step_fn = step_fns[key]

        astate = None
        if ATK.is_adaptive(phase.attack):
            astate = ATK.get_adaptive(phase.attack).init_state(
                n, f_eff, device=dev)
        # every trainer speaks TrainerState; the adaptive-attack slot is
        # phase-local, everything else carries across phases
        state = dataclasses.replace(tstate, astate=astate)

        batches = _phase_batches(batch_gen, phase, start, freeze=not is_async)
        fresh = _phase_fresh(scenario, phase, start) if is_async else None
        records = []
        for t in range(stop - start):
            batch = {k: v[t].to(dev) for k, v in batches.items()}
            seed = ATK.fold_seed(scenario.seed, start + t)
            if is_async:
                params, state, m = step_fn(params, state, batch, seed,
                                           fresh[t].to(dev))
                stale_ema = TEL.update_ema(
                    stale_ema, m["telemetry"]["overstale"].to(dev), ema)
            else:
                params, state, m = step_fn(params, state, batch, seed)
            tel = m["telemetry"]
            # a uniform plan (averaging) makes its selection on the CPU
            susp = TEL.update_suspicion(susp, tel["selection"].to(dev), ema)
            if gsusp is not None:
                gsusp = TEL.update_suspicion(
                    gsusp, tel["group_selection"].to(dev), ema)
            records.append(TEL.step_record(
                m, susp, phase_idx, gsusp=gsusp,
                stale=stale_ema if is_async else None))
        tstate = dataclasses.replace(state, astate=None)
        phase_traces.append(TEL.stack_records(records))
        if verbose:
            tr = phase_traces[-1]
            print(f"[sim] {scenario.name} phase {phase_idx} "
                  f"({phase.attack}, f={f_eff}, steps {start}-{stop}): "
                  f"loss {tr['loss'][0]:.4f} -> {tr['loss'][-1]:.4f} "
                  f"honest_dev {np.mean(tr['honest_dev']):.3f} "
                  f"byz_mass {np.mean(tr['byz_mass']):.3f}", flush=True)
        if ckpt_dir:
            save(ckpt_dir, stop, ckpt_tree())

    trace = TEL.concat_traces(phase_traces)
    summary = TEL.summarize(trace, scenario, start_step, wire=wire) \
        if trace else {}
    obs_snap = None
    if OBS.obs_on(obs) and tstate.mstate is not None:
        obs_snap = OBS.snapshot(
            metrics=tstate.mstate["m"],
            trace_records=OBS.drain(tstate.mstate["t"]),
            meta={"source": "sim.engine", "scenario": scenario.name,
                  "trainer": scenario.trainer,
                  "async_tau": scenario.async_tau})
    return CampaignResult(scenario=scenario, trace=trace, summary=summary,
                          start_step=start_step, wall_s=time.time() - t0,
                          wire=wire, obs=obs_snap)
