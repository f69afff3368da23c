"""The port's campaign CLI (``repro_torch.launch.simulate``) and its
example on the CPU: the phase grammar and its refusals against JAX's
``repro.launch.simulate``, the ``--smoke --async-tau`` acceptance campaign
at the TINY model with JAX's thresholds, exiting 0, the flat ``--smoke``'s
campaigns and gates on stand-in traces, and a ``--phase`` campaign writing
its reports.  The flat ``--smoke`` (140 TINY steps) and ``--smoke --hier``
run end to end on the card (``chip_smoke.py`` C2)."""
import csv
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.launch import simulate as JSIM
from repro_torch.launch import simulate as TSIM
from repro_torch.sim import AttackPhase, AttackSchedule

torch.set_num_threads(1)


@pytest.mark.parametrize("text", [
    "20=little_is_enough:z=4.0@f=1@stale=2+5", "3=none", "7=inf@f=0",
    "4=sign_flip:scale=3.0@stale=9", "5=none@stale="])
def test_phase_parsing_matches_jax(text):
    assert TSIM.parse_phase(text).__dict__ == JSIM.parse_phase(text).__dict__


@pytest.mark.parametrize("text", [
    "little_is_enough", "abc=none", "0=none", "3=none@g=1", "3=none@f=x"])
def test_phase_refusals_match_jax(text):
    with pytest.raises(ValueError) as want:
        JSIM.parse_phase(text)
    with pytest.raises(ValueError) as got:
        TSIM.parse_phase(text)
    assert str(got.value) == str(want.value)


def test_thresholds_are_jax_s():
    for name in ("ROBUST_DEV_MAX", "ROBUST_BYZ_MASS", "AVERAGE_DEV_FACTOR",
                 "AVERAGE_CAPTURE", "AVERAGE_LOSS_MARGIN", "SWEEP_CODECS",
                 "SWEEP_ATTACKS", "SWEEP_STEPS", "ASYNC_SMOKE_STEPS",
                 "ASYNC_STALE", "HIER_SMOKE_STEPS", "HIER_CAPTURE_MIN"):
        assert getattr(TSIM, name) == getattr(JSIM, name), name


@pytest.mark.parametrize("extra", [["--async-tau", "1"]], ids=["async"])
def test_smoke_exits_zero(extra, capsys):
    assert TSIM.main(["--smoke", "--device", "cpu"] + extra) == 0
    assert "--smoke --async-tau OK" in capsys.readouterr().out


WIRE_BYTES = {"fp32": 4000, "bf16": 2000, "qsgd:bits=8": 1000}


def _stand_in_campaigns(fault, seen):
    """``run_campaign`` returning traces that tell the paper's story, or
    break it by ``fault``; ``seen`` collects the scenarios it was given."""
    def run(sc, **kw):
        seen.append((sc.gar, sc.codec, sc.schedule.describe()))
        n, av = sc.schedule.total_steps, sc.gar == "average"
        byz = sc.f / sc.n_workers if av else 0.0
        if fault == "robust_selects_byzantine" and not av:
            byz = 0.1
        loss = 4.0 if (av and fault == "average_kept_learning") else \
            5.0 if av else 4.0
        trace = {"honest_dev": np.full(n, 3.0 if av else 0.5),
                 "byz_mass": np.full(n, byz), "loss": np.full(n, loss)}
        wire = None
        if sc.codec is not None:
            b = WIRE_BYTES[sc.codec]
            if fault == "wire_bytes_unordered" and sc.codec == "bf16":
                b = WIRE_BYTES["fp32"]
            wire = {"bytes_per_worker": b}
        phases = [{"wire": wire} if wire else {} for _ in range(2)]
        return SimpleNamespace(trace=trace,
                               summary={"wire": wire, "phases": phases})
    return run


@pytest.mark.parametrize("fault,problem", [
    (None, None),
    ("robust_selects_byzantine", "byzantine selection mass"),
    ("average_kept_learning", "averaging kept learning"),
    ("wire_bytes_unordered", "not strictly ordered"),
])
def test_flat_smoke_campaigns_and_gates(fault, problem, monkeypatch, capsys):
    seen = []
    monkeypatch.setattr(TSIM, "run_campaign", _stand_in_campaigns(fault, seen))
    rc = TSIM.main(["--smoke", "--device", "cpu"])
    out, err = capsys.readouterr()
    switch = AttackSchedule((AttackPhase(20, "none"),
                             AttackPhase(20, "little_is_enough:z=4.0")))
    want = [("multi_bulyan", None, switch.describe()),
            ("average", None, switch.describe())]
    for codec in TSIM.SWEEP_CODECS:
        for attack in TSIM.SWEEP_ATTACKS:
            if not (attack.startswith("scale_poison") and codec == "fp32"):
                want.append(("multi_bulyan", codec, AttackSchedule((
                    AttackPhase(TSIM.SWEEP_STEPS, "none"),
                    AttackPhase(TSIM.SWEEP_STEPS, attack))).describe()))
    assert seen == want
    if fault is None:
        assert rc == 0 and "--smoke OK" in out and not err
    else:
        assert rc == 1 and "SMOKE FAILED" in err and problem in err


def test_phase_campaign_writes_reports(tmp_path, capsys):
    rep, tab = tmp_path / "c.json", tmp_path / "c.csv"
    argv = ["--device", "cpu", "--phase", "2=none",
            "--phase", "2=inf@f=1@stale=4", "--seq", "16",
            "--gar", "multi_krum", "--report", str(rep), "--csv", str(tab)]
    assert TSIM.main(argv) == 0
    out = capsys.readouterr().out
    assert "[sim] done: 4 steps" in out
    r = json.loads(rep.read_text())
    assert r["schema"] == "sim.campaign.v1"
    assert [p["f"] for p in r["scenario"]["phases"]] == [2, 1]
    assert r["summary"]["phases"][1]["byz_mass_mean"] == 0.0
    rows = list(csv.reader(tab.open()))
    assert [row[0] for row in rows] == ["step", "0", "1", "2", "3"]
    # a resume from the end has nothing left to run
    ck = tmp_path / "ck"
    assert TSIM.main(argv + ["--ckpt-dir", str(ck)]) == 0
    capsys.readouterr()
    assert TSIM.main(argv + ["--ckpt-dir", str(ck), "--resume"]) == 0
    assert "nothing left to run" in capsys.readouterr().out


def test_example_runs(capsys):
    from importlib import util
    import pathlib
    path = pathlib.Path(__file__).resolve().parent.parent / "examples" / \
        "byzantine_training_torch.py"
    spec = util.spec_from_file_location("byzantine_training_torch", path)
    mod = util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.PRESETS["smoke"] = dict(mod.PRESETS["smoke"], steps=2, seq=16)
    results = mod.main(["--device", "cpu", "--attack", "inf",
                        "--compare-average"])
    assert set(results) == {"multi_bulyan", "average"}
    assert results["multi_bulyan"].summary["phases"][1]["byz_mass_mean"] \
        == 0.0
    assert "[byz]   mean selection" in capsys.readouterr().out
