"""The port's observability pieces (``repro_torch.obs``) against the JAX
package's ``repro.obs``, on the CPU, from the same numpy inputs:

* the registry: one sequence of record ops (values on bucket edges,
  underflow, overflow, a vector ``observe``) drains to JAX's JSON, the
  counters and histogram counts exactly, the gauges within
  ``rtol=1e-6``; unknown names and ``None`` pass through; the spec's
  refusals are JAX's; a record op leaves its argument unchanged;
* the ring: a ring that wraps drains as JAX's does, exactly;
* the export: ``snapshot``, ``validate_snapshot`` (with JAX's
  corruptions), ``serve_metrics``, ``percentiles`` and
  ``export_chrome_trace`` equal JAX's (the trace's exporter name aside);
* the profile hooks: nothing recorded without a profiler; with one, a
  record per wrapper call with the configuration ``launch_config`` gives,
  and ptxas's report parsed from a library's kept compiler output;
* the checkpoint: an ``mstate`` saved by the port restores in JAX and one
  saved by JAX in the port, under identical keys, and ``mstate_from_jax``
  continues a JAX registry in the port;
* the launcher: ``launch/train.py --device cpu --obs`` writes a snapshot
  and a trace that ``launch/obs_report.py --validate`` accepts (exit 0);
  a corrupted snapshot exits 1.
"""
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import obs as JOBS
from repro.checkpoint import restore as jrestore
from repro.checkpoint import save as jsave
from repro_torch import obs as TOBS
from repro_torch.analysis import smem
from repro_torch.checkpoint import restore, save
from repro_torch.kernels import build, ops
from repro_torch.kernels.pairwise_sqdist import launch_config
from repro_torch.launch import obs_report, train

torch.set_num_threads(1)

EDGES = (0.5, 1.5, 2.5, 4.0)
SPEC = dict(counters=("n", "m"), gauges=(("g", ()), ("v", (3,))),
            hists=(("h", EDGES), ("age", (0.5, 1.5))))


def _ops(mod, to):
    """One sequence of record ops through package ``mod``; ``to`` makes
    its arrays from numpy."""
    rng = np.random.default_rng(7)
    m = mod.init_metrics(mod.MetricsSpec(**SPEC))
    vals = np.concatenate([
        rng.uniform(-1.0, 6.0, size=40),
        np.asarray(EDGES), [-5.0, 1e6, 0.4999999, 4.0000005]]
    ).astype(np.float32)
    for i, v in enumerate(vals):
        m = mod.inc(m, "n")
        m = mod.inc(m, "m", to(np.asarray(v, np.float32)))
        m = mod.observe(m, "h", to(np.asarray(v, np.float32)))
        m = mod.set_gauge(m, "g", to(np.asarray(v * 0.5, np.float32)))
        m = mod.ema_gauge(m, "v", to(vals[i:i + 3] if i + 3 <= len(vals)
                                     else vals[:3]), 0.9)
    m = mod.observe(m, "h", to(vals))
    m = mod.observe(m, "age", to(np.asarray([0.0, 1.0, 1.0, 2.0, 3.0],
                                            np.float32)))
    m = mod.inc(m, "n", 2.5)
    m = mod.set_gauge(m, "g", 1.25)
    return m


def _assert_metrics_json(got, want):
    assert got["counters"] == want["counters"]
    assert sorted(got["gauges"]) == sorted(want["gauges"])
    for k in want["gauges"]:
        np.testing.assert_allclose(got["gauges"][k], want["gauges"][k],
                                   rtol=1e-6, atol=0, err_msg=k)
    assert got["hists"] == want["hists"]


# ------------------------------------------------------------- registry
def test_registry_drains_to_jax_json():
    want = JOBS.metrics_to_json(_ops(JOBS, jnp.asarray))
    got = TOBS.metrics_to_json(_ops(TOBS, torch.from_numpy))
    _assert_metrics_json(got, want)
    assert sum(got["hists"]["h"]["counts"]) == 2 * 48
    assert got["hists"]["age"]["counts"] == [1, 2, 2]


def test_record_ops_are_pure_and_typed():
    m0 = TOBS.init_metrics(TOBS.MetricsSpec(**SPEC))
    m1 = TOBS.observe(TOBS.inc(m0, "n", 3.0), "h", torch.tensor([1.0, 9.0]))
    assert float(m0.counters["n"]) == 0.0
    assert m0.hists["h"].tolist() == [0] * 5
    assert m1.counters["n"].dtype == torch.float32
    assert m1.hists["h"].dtype == torch.int32
    assert m1.hists["h"].tolist() == [0, 1, 0, 0, 1]
    assert m1.edges is m0.edges


def test_unknown_names_and_none_pass_through():
    m = TOBS.init_metrics(TOBS.MetricsSpec(counters=("a",)))
    for op in (lambda: TOBS.inc(m, "nope"),
               lambda: TOBS.observe(m, "nope", 1.0),
               lambda: TOBS.set_gauge(m, "nope", 1.0),
               lambda: TOBS.ema_gauge(m, "nope", 1.0, 0.5)):
        assert op() is m
    assert TOBS.inc(None, "a") is None
    assert TOBS.observe(None, "a", 1.0) is None
    assert TOBS.record(None, TOBS.PH_STATS, 0) is None
    assert TOBS.init_train_obs(None, 7) is None
    assert TOBS.init_train_obs(TOBS.ObsConfig(enabled=False), 7) is None


@pytest.mark.parametrize("build_bad", [
    lambda mod: mod.MetricsSpec(counters=("a", "a")),
    lambda mod: mod.MetricsSpec(gauges=(("g", ()), ("g", (2,)))),
    lambda mod: mod.MetricsSpec(hists=(("h", (2.0, 1.0)),)),
    lambda mod: mod.MetricsSpec(hists=(("h", ()),)),
    lambda mod: mod.ObsConfig(enabled=True, ring=0),
    lambda mod: mod.ObsConfig(enabled=True, suspicion_ema=1.0),
], ids=["dup-counter", "dup-gauge", "unsorted", "no-edges", "ring",
        "ema"])
def test_spec_refusals_match_jax(build_bad):
    errors = []
    for mod in (JOBS, TOBS):
        with pytest.raises(ValueError) as e:
            build_bad(mod)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("tau", [0, 1, 3])
@pytest.mark.parametrize("telemetry", [False, True])
def test_standard_specs_match_jax(tau, telemetry):
    assert TOBS.GRAD_NORM_EDGES == JOBS.GRAD_NORM_EDGES
    for t, j in ((TOBS.train_spec(7, telemetry=telemetry),
                  JOBS.train_spec(7, telemetry=telemetry)),
                 (TOBS.serve_spec(7, tau, telemetry=telemetry),
                  JOBS.serve_spec(7, tau, telemetry=telemetry))):
        assert (t.counters, t.gauges, t.hists) == \
            (j.counters, j.gauges, j.hists)


# ------------------------------------------------------------------ ring
@pytest.mark.parametrize("capacity,writes", [(4, 11), (4, 3), (5, 5),
                                             (1, 2)])
def test_ring_drains_as_jax(capacity, writes):
    jt, tt = JOBS.init_trace(capacity), TOBS.init_trace(capacity)
    for i in range(writes):
        ph, p = i % len(JOBS.PHASES), float(i) * 0.25 - 1.0
        jt = JOBS.record(jt, ph, i // 3, payload=p)
        tt = TOBS.record(tt, ph, i // 3,
                         payload=torch.tensor(p) if i % 2 else p)
    assert TOBS.drain(tt) == JOBS.drain(jt)
    assert int(tt.head) == writes and tt.head.dtype == torch.int32
    np.testing.assert_array_equal(tt.slots.numpy(), np.asarray(jt.slots))


# ---------------------------------------------------------------- export
def _snapshots():
    out = []
    for mod, to in ((JOBS, jnp.asarray), (TOBS, torch.from_numpy)):
        ms = mod.init_train_obs(mod.ObsConfig(enabled=True), 7,
                                telemetry=True)
        m = mod.observe(mod.inc(ms["m"], "rounds", 3.0), "agg_grad_norm",
                        to(np.asarray(2.5, np.float32)))
        t = mod.record(ms["t"], mod.PH_PLAN, 1, 0.25)
        out.append(mod.snapshot(metrics=m, trace_records=mod.drain(t),
                                kernels=[{"kernel": "k"}],
                                meta={"source": "test"}))
    return out


def test_snapshot_and_validation_match_jax():
    want, got = _snapshots()
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert TOBS.validate_snapshot(got) == [] == JOBS.validate_snapshot(want)
    corruptions = [
        lambda s: s.update(schema="obs.v0"),
        lambda s: s["metrics"]["hists"]["agg_grad_norm"].update(counts=[0]),
        lambda s: s.pop("kernels"),
        lambda s: s["trace"]["records"].append({"seq": -1}),
        lambda s: s.update(kernels={}),
        lambda s: s.update(serve={"round_us": {"p50": 1.0}}),
        lambda s: s["metrics"].pop("gauges"),
    ]
    for corrupt in corruptions:
        bad = json.loads(json.dumps(got))
        corrupt(bad)
        problems = TOBS.validate_snapshot(bad)
        assert problems and problems == JOBS.validate_snapshot(bad)
    assert TOBS.validate_snapshot([]) == JOBS.validate_snapshot([])


def test_serve_metrics_and_percentiles_match_jax():
    rng = np.random.default_rng(3)
    round_us = rng.uniform(50.0, 900.0, size=37)
    ages = rng.integers(0, 4, size=(37, 7))
    kw = dict(agg_us=rng.uniform(1.0, 9.0, size=37), ages=ages, tau=2,
              counters={"rounds": 37.0, "degraded": 2.0})
    assert TOBS.serve_metrics(round_us, **kw) == \
        JOBS.serve_metrics(round_us, **kw)
    assert TOBS.serve_metrics(round_us, ages=ages) == \
        JOBS.serve_metrics(round_us, ages=ages)
    assert TOBS.percentiles(round_us) == JOBS.percentiles(round_us)
    with pytest.raises(ValueError, match="empty"):
        TOBS.percentiles([])


def test_chrome_trace_matches_jax(tmp_path):
    recs = [{"seq": i, "round": i // 3, "phase": JOBS.PHASES[i % 3],
             "payload": 0.5 * i} for i in range(9)]
    spans = [{"name": "step", "ts_us": 10.0 + 100.0 * r, "dur_us": 90.0,
              "args": {"round": r}} for r in range(2)]
    docs = []
    for mod, name in ((JOBS, "j.json"), (TOBS, "t.json")):
        n = mod.export_chrome_trace(str(tmp_path / name),
                                    device_records=recs, host_spans=spans,
                                    meta={"source": "test"})
        with open(tmp_path / name) as fh:
            docs.append((n, json.load(fh)))
    (jn, jdoc), (tn, tdoc) = docs
    assert tn == jn
    assert tdoc["otherData"].pop("exporter") == "repro_torch.obs.trace"
    jdoc["otherData"].pop("exporter")
    assert tdoc == jdoc


def test_span_tracer_records_wall_clock():
    tracer = TOBS.SpanTracer()
    with tracer.span("step", round=2, tag=object()):
        pass
    (s,) = tracer.spans
    assert s["name"] == "step" and s["dur_us"] >= 0.0
    assert s["args"]["round"] == 2 and isinstance(s["args"]["tag"], str)


# --------------------------------------------------------------- profile
def test_no_profiler_no_record():
    x = torch.randn(11, 64)
    with TOBS.KernelProfiler() as prof:
        pass
    ops.pairwise_stats(x)
    assert prof.records == []


def test_profiler_records_one_record_a_call():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((11, 4096)).astype(np.float32))
    w = torch.from_numpy(rng.random((5, 11)).astype(np.float32))
    payload = torch.from_numpy(rng.integers(-127, 127, (11, 4096))
                               .astype(np.int8))
    mult = torch.ones(11)
    with TOBS.KernelProfiler() as prof:
        ops.pairwise_stats(x)
        ops.pairwise_stats(x)
        ops.dequant_stats(payload, mult)
        ops.fused_select(x, w, w, beta=1)
        ops.pairwise_stats_rect(x, x)
        ops.pairwise_stats_rect(x[3:6], x)
        ops.dequant_stats_rect(payload[:3], mult[:3], payload, mult)
        ops.coord_select(x[:5], x[:5], 1)
    recs = [r.to_json() for r in prof.records]
    assert [r["kernel"] for r in recs] == [
        "pairwise_stats", "pairwise_stats", "dequant_stats", "fused_select",
        "pairwise_stats_rect", "pairwise_stats_rect", "dequant_stats_rect"]
    row_tile, chunks = launch_config(11, 4096)
    for r in recs:
        assert r["route"] == "plain" and r["ptxas"] is None
        assert (r["n"], r["d"]) == (11, 4096)
    # analysis/smem.py's shared memory a block, the most of the launched
    # functions: K1's red[8][12 x 12] floats; K5 int8 adds s_mult[24];
    # K2 theta = 5 the (5 x 11) weight pairs; K6 on the stack K1's; the
    # view path's staged finalize stage[3][32][64]; K7's (4, 12) tile
    # red[8][48 + 4 + 12] and s_mult[16]
    assert [r["vmem_predicted"] for r in recs] == [
        4608, 4608, 4704, 5 * 11 * 8, 4608, 3 * 32 * 64 * 4, 2112]
    assert recs[0]["config"] == {"row_tile": row_tile, "chunks": chunks,
                                 "grid": [chunks, 1, 1]}
    assert recs[2]["config"]["dtype"] == "int8"
    assert recs[3]["config"] == {"theta": 5, "beta": 1,
                                 "variant": "theta=5"}
    assert recs[4]["config"]["grid_kind"] == "square"
    assert recs[5]["config"]["grid_kind"] == "view"
    assert recs[6]["config"]["grid_kind"] == "rect"
    assert TOBS.profile_points([(11, 256)], device="cpu")[0]["config"] == \
        {"row_tile": 12, "chunks": 1, "grid": [1, 1, 1]}


PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN10stats_tile19partial_gram_kernelILi12ELb1E7F32RowsEEvT1_Pflll' for 'sm_90a'
ptxas info    : Function properties for _ZN10stats_tile19partial_gram_kernelILi12ELb1E7F32RowsEEvT1_Pflll
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 0 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN10stats_tile19partial_gram_kernelILi8ELb0E7F32RowsEEvT1_Pflll' for 'sm_90a'
ptxas info    : Function properties for _ZN10stats_tile19partial_gram_kernelILi8ELb0E7F32RowsEEvT1_Pflll
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 2048 bytes smem, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN10stats_tile15finalize_kernelEPKfPfS2_ll' for 'sm_90a'
ptxas info    : Function properties for _ZN10stats_tile15finalize_kernelEPKfPfS2_ll
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 18 registers, used 0 barriers, 392 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN10stats_tile27partial_gram_bounded_kernelILi12ELb1EN12dequant_rows11DequantRowsIaEEEEvT1_Pflll' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 4704 bytes smem, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN10stats_tile27partial_gram_bounded_kernelILi12ELb1EN12dequant_rows11DequantRowsI13__nv_bfloat16EEEEvT1_Pflll' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 126 registers, used 1 barriers, 4704 bytes smem, 384 bytes cmem[0]
"""


def test_ptxas_report_is_parsed_and_matched(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    assert build.ptxas_report("pairwise_stats") is None
    build.report_path("pairwise_stats").write_text(PTXAS)
    rep = build.ptxas_report("pairwise_stats")
    k8 = "_ZN10stats_tile19partial_gram_kernelILi8ELb0E7F32RowsEEvT1_Pflll"
    assert rep[k8] == {"registers": 255, "smem_bytes": 2048,
                       "stack_frame": 8, "spill_stores": 4,
                       "spill_loads": 12}
    fns = [launch.pattern for launch in smem.estimate_call(
        "pairwise_stats", torch.zeros(11, 4096)).launches]
    got = TOBS.profile.launched_resources("pairwise_stats", fns)
    assert sorted(got) == [
        "_ZN10stats_tile15finalize_kernelEPKfPfS2_ll",
        "_ZN10stats_tile19partial_gram_kernelILi12ELb1E7F32RowsEEvT1_Pflll"]
    assert got["_ZN10stats_tile15finalize_kernelEPKfPfS2_ll"][
        "registers"] == 18
    # K5 on an int8 payload: its own loader's instantiation only
    payload = torch.zeros((11, 4096), dtype=torch.int8)
    fns = [launch.pattern for launch in smem.estimate_call(
        "dequant_stats", payload, torch.ones(11)).launches]
    got = TOBS.profile.launched_resources("pairwise_stats", fns)
    int8 = [k for k in got if "DequantRows" in k]
    assert len(int8) == 1 and "DequantRowsIaE" in int8[0]
    assert got[int8[0]]["smem_bytes"] == 4704


# ------------------------------------------------------------ checkpoint
def _mstates():
    """The same filled mstate in both packages: (JAX's, the port's)."""
    out = []
    for mod, to in ((JOBS, jnp.asarray), (TOBS, torch.from_numpy)):
        ms = mod.init_serve_obs(mod.ObsConfig(enabled=True, ring=4), 7, 2,
                                telemetry=True)
        m = mod.inc(ms["m"], "rounds", 3.0)
        m = mod.observe(m, "staleness_age",
                        to(np.asarray([0, 1, 3, 2, 0, 0, 1], np.float32)))
        m = mod.set_gauge(m, "suspicion",
                          to(np.linspace(0, 1, 7).astype(np.float32)))
        t = ms["t"]
        for i in range(6):
            t = mod.record(t, i % 4, i, payload=float(i))
        out.append({"m": m, "t": t})
    return out


def test_mstate_checkpoints_both_ways_under_jax_keys(tmp_path):
    jms, tms = _mstates()
    jsave(str(tmp_path / "j"), 1, {"state": {"mstate": jms}})
    save(str(tmp_path / "t"), 1, {"state": {"mstate": tms}})
    with np.load(tmp_path / "j" / "ckpt_00000001.npz") as jf, \
            np.load(tmp_path / "t" / "ckpt_00000001.npz") as tf:
        assert sorted(tf.files) == sorted(jf.files)
        assert "state|mstate|t|head" in tf.files
        assert "state|mstate|m|counters|rounds" in tf.files
        for k in jf.files:
            assert tf[k].dtype == jf[k].dtype, k
            np.testing.assert_array_equal(tf[k], jf[k], err_msg=k)
    # the port's file in JAX, JAX's in the port
    jlike = {"state": {"mstate": JOBS.init_serve_obs(
        JOBS.ObsConfig(enabled=True, ring=4), 7, 2, telemetry=True)}}
    tlike = {"state": {"mstate": TOBS.init_serve_obs(
        TOBS.ObsConfig(enabled=True, ring=4), 7, 2, telemetry=True)}}
    jback = jrestore(str(tmp_path / "t"), 1, jlike)["state"]["mstate"]
    tback = restore(str(tmp_path / "j"), 1, tlike)["state"]["mstate"]
    assert JOBS.drain(jback["t"]) == JOBS.drain(jms["t"])
    assert TOBS.drain(tback["t"]) == TOBS.drain(tms["t"])
    _assert_metrics_json(TOBS.metrics_to_json(tback["m"]),
                         JOBS.metrics_to_json(jback["m"]))
    assert tback["m"].spec == tms["m"].spec and tback["t"].capacity == 4


def test_mstate_from_jax_continues_the_registry():
    jms, tms = _mstates()
    got = TOBS.mstate_from_jax(jax.tree.map(np.asarray, jms), device="cpu")
    assert got["m"].spec == tms["m"].spec
    _assert_metrics_json(TOBS.metrics_to_json(got["m"]),
                         TOBS.metrics_to_json(tms["m"]))
    assert TOBS.drain(got["t"]) == TOBS.drain(tms["t"])
    # one more record on each side: the same again
    jm = JOBS.observe(jms["m"], "agg_grad_norm", jnp.float32(3.0))
    tm = TOBS.observe(got["m"], "agg_grad_norm", 3.0)
    _assert_metrics_json(TOBS.metrics_to_json(tm),
                         JOBS.metrics_to_json(jm))
    assert TOBS.drain(TOBS.record(got["t"], 2, 9, 1.5)) == \
        JOBS.drain(JOBS.record(jms["t"], 2, 9, 1.5))


# --------------------------------------------------------------- the CLIs
def test_launcher_obs_files_validate(tmp_path, capsys):
    snap, trace = str(tmp_path / "s.json"), str(tmp_path / "t.json")
    params, hist, state = train.run_state([
        "--device", "cpu", "--reduced", "--seq", "8", "--steps", "2",
        "--workers", "7", "--f", "1", "--obs", "--obs-json", snap,
        "--obs-trace", trace])
    out = capsys.readouterr().out
    assert "[train] obs: 6 span records, counters {'rounds': 2.0}" in out
    with open(snap) as fh:
        doc = json.load(fh)
    assert TOBS.validate_snapshot(doc) == []
    assert [(r["round"], r["phase"]) for r in doc["trace"]["records"]] == \
        [(0, "stats"), (0, "plan"), (0, "apply"),
         (1, "stats"), (1, "plan"), (1, "apply")]
    assert doc["metrics"]["counters"] == {"rounds": 2.0}
    assert state.mstate is not None
    assert obs_report.main(["--snapshot", snap, "--trace", trace,
                            "--validate"]) == 0
    assert "[obs_report] OK" in capsys.readouterr().out
    doc["metrics"]["hists"]["agg_grad_norm"]["counts"] = [0]
    with open(snap, "w") as fh:
        json.dump(doc, fh)
    assert obs_report.main(["--snapshot", snap, "--validate"]) == 1
    assert obs_report.main(["--snapshot", str(tmp_path / "none.json"),
                            "--validate"]) == 1
    assert "PROBLEM" in capsys.readouterr().out


@pytest.mark.parametrize("extra", [["--mesh", "host"],
                                   ["--trainer", "stream_global"]],
                         ids=["mesh", "stream_global"])
def test_launcher_obs_records_as_the_stacked_run(tmp_path, capsys, extra):
    """The mesh step (a one-rank gloo world) and ``stream_global`` record
    what the stacked run records: the same counters, histograms and spans
    (the apply payloads, the aggregate's norm, bit for bit)."""
    snaps = []
    for i, flags in enumerate(([], extra)):
        path = str(tmp_path / f"s{i}.json")
        train.run_state(["--device", "cpu", "--reduced", "--seq", "8",
                         "--steps", "2", "--workers", "7", "--f", "1",
                         "--obs", "--obs-json", path, "--obs-trace",
                         str(tmp_path / f"t{i}.json"), *flags])
        with open(path) as fh:
            snaps.append(json.load(fh))
    capsys.readouterr()
    want, got = snaps
    assert got["metrics"]["counters"] == want["metrics"]["counters"]
    assert got["metrics"]["hists"] == want["metrics"]["hists"]
    assert [(r["round"], r["phase"]) for r in got["trace"]["records"]] == \
        [(r["round"], r["phase"]) for r in want["trace"]["records"]]
    assert [r["payload"] for r in got["trace"]["records"]
            if r["phase"] == "apply"] == \
        [r["payload"] for r in want["trace"]["records"]
         if r["phase"] == "apply"]
