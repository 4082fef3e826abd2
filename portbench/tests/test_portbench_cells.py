"""Every cell end to end on the CPU at a tiny size: the port's answers
equal the plain reference's; the control and faults planted under the
timed path come out not correct; a cell is added by files alone."""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench.control import control
from portbench.tests.tiny import BENCH, ROOT, run_cell, tiny_bench

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]


def metrics_of(cell, group):
    return {m["name"] for m in BENCHMARK[group]
            if "workloads" not in m or cell in m["workloads"]}


@pytest.mark.parametrize("cell,trace", [(c, t) for c in CELLS
                                        for t in (0, 1)])
def test_cell_matches_reference(tiny, capsys, cell, trace):
    line = run_cell(tiny, cell, trace=trace, capsys=capsys)
    assert line["correct"] and line["failed"] == 0 and line["attempted"]
    assert list(line)[-1] == "checks"
    assert all(c["value"] == 0 for c in line["checks"].values())
    if trace:
        # No device here: the profiler's metrics are left out.
        got = set(line["metrics"])
        assert got and got <= metrics_of(cell, "per_layer")
    else:
        assert set(line["metrics"]) == metrics_of(cell, "end_to_end")


@pytest.mark.parametrize("cell", CELLS)
def test_control_not_correct(tiny, capsys, cell):
    line = run_cell(tiny, cell, control=control, capsys=capsys)
    assert not line["correct"]


def altered_answer(monkeypatch):
    """One answer changed where the engine produces it."""
    from repro_torch.match import engine
    orig = engine.CompiledMatch.run

    def run(self):
        res = orig(self)
        res.best_scores = res.best_scores.copy()
        res.best_scores[0] += 1
        return res
    monkeypatch.setattr(engine.CompiledMatch, "run", run)
    monkeypatch.setattr(engine.CompiledMatch, "__call__", run)


def half_left_out(monkeypatch):
    """A fused launch whose second half of queries get the first half's
    columns."""
    from repro_torch.match import service
    orig = service.MatchService._scatter

    def scatter(self, res, q, n_q, k_q):
        return orig(self, res, q % max(1, n_q // 2), n_q, k_q)
    monkeypatch.setattr(service.MatchService, "_scatter", scatter)


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in (altered_answer,
                                                  half_left_out)],
                         ids=lambda x: getattr(x, "__name__", x))
def test_fault_not_correct(tiny, capsys, monkeypatch, cell, fault):
    fault(monkeypatch)
    line = run_cell(tiny, cell, capsys=capsys, seconds=0.3)
    assert not line["correct"]


def digest(path):
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_new_cell_by_files_only(tmp_path):
    """A configuration, a mix, a metric and a cell, added as new files and
    entries in a temporary copy, run without editing a file."""
    root = tiny_bench(tmp_path, copy_tree=True)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    before = {p: digest(p) for p in (root / "portbench").rglob("*")
              if p.is_file()}
    cfg = json.loads((root / bench["configs"][0]["file"]).read_text())
    cfg["name"] = "tiny-extra"
    (root / "portbench/configs/tiny-extra.json").write_text(json.dumps(cfg))
    mix = json.loads((BENCH / "traffic/probe-iupac.json").read_text())
    mix.update(clients=3, wildcards=20, threshold=90, check_every=1,
               warm_ticks=1)
    (root / "portbench/traffic/probe-wide.json").write_text(json.dumps(mix))
    (root / "portbench/metrics/read_p95_ms.probe.py").write_text(
        (BENCH / "metrics/read_p95_ms.batch.py").read_text())
    bench["configs"].append({"name": "tiny-extra", "source": "test",
                             "file": "portbench/configs/tiny-extra.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "extra-probe", "config": "tiny-extra",
                               "traffic": "probe-wide", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "reads_per_s":
            m["workloads"].append("extra-probe")
    bench["per_layer"].append({"name": "read_p95_ms.probe", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "service", "moves": "reads_per_s",
                               "workloads": ["extra-probe"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "extra-probe",
         "--seed", "4", "--seconds", "0.2", "--trace", "1", "--device",
         "cpu"], cwd=root, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and "read_p95_ms.probe" in line["metrics"]
    assert {p: digest(p) for p in before} == before


def test_forbidden_modules_seen(monkeypatch):
    from portbench import harness
    for name in ("jax", "repro.match"):
        monkeypatch.setitem(sys.modules, name, sys)
    monkeypatch.setitem(sys.modules, "repro_torch_extra", sys)
    found = harness.forbidden_modules()
    assert {"jax", "repro"} <= set(found)
    assert "repro_torch_extra" not in found and "repro_torch" not in found


def test_no_card_no_result(tiny, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from portbench import harness
    rc = harness.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                       "1"], root=tiny)
    assert rc != 0 and capsys.readouterr().out == ""


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_on_card(cuda, tiny, capsys, cell):
    line = run_cell(tiny, cell, device="cuda", capsys=capsys)
    assert line["correct"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_card(cuda, tiny, capsys, cell):
    line = run_cell(tiny, cell, device="cuda", control=control,
                    capsys=capsys)
    assert not line["correct"]


def test_reference_first_best():
    from portbench.reference import match as ref
    frags = torch.tensor([[0, 1, 0, 1, 0, 1]], dtype=torch.uint8)
    locs, scores = ref.best(frags, ref.as_masks(np.array([[0, 1]])))
    assert (locs[0, 0], scores[0, 0]) == (0, 2)
