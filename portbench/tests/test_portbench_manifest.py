"""BENCHMARK.json against the naming rules; the generator's seeding."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from portbench import generator, manifest
from portbench.tests.tiny import BENCH, ROOT

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}


def test_manifest_keys_and_rules():
    assert set(BENCHMARK) == TOP
    assert manifest.problems(BENCHMARK, ROOT) == []
    assert BENCHMARK["paths"] == ["portbench"]
    assert all(w["chips"] == 1 for w in BENCHMARK["workloads"])
    for c in BENCHMARK["configs"]:
        assert set(c) == CONFIG_KEYS
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert set(c["reduced"]) <= set(cfg) and set(c["reduced"]) == set(
            cfg["reduced"])
    for m in BENCHMARK["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCHMARK["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


@pytest.mark.parametrize("bad", ["a b", "x/y", "", "é", "a" * 65])
def test_names_refused(bad):
    bench = json.loads(json.dumps(BENCHMARK))
    bench["workloads"][0]["name"] = bad
    assert manifest.problems(bench, ROOT)


def drop_config_why(b):
    del b["configs"][0]["why"]


def extra_cell_key(b):
    b["workloads"][0]["bound"] = 0.1


def long_why(b):
    b["configs"][0]["why"] = "x" * 201


def run_seconds_52(b):
    b["run_seconds"] = 52


def path_up(b):
    b["paths"] = ["../portbench"]


def bound_too_loose(b):
    b["end_to_end"][0]["bound"] = 0.3


@pytest.mark.parametrize("breach", [drop_config_why, extra_cell_key, long_why,
                                    run_seconds_52, path_up, bound_too_loose])
def test_form_refused(breach):
    bench = json.loads(json.dumps(BENCHMARK))
    breach(bench)
    assert manifest.problems(bench, ROOT)


def frags(seed=3):
    return np.random.default_rng(seed).integers(0, 4, (40, 500), np.uint8)


@pytest.mark.parametrize("mix", sorted(p.stem for p in
                                       (BENCH / "traffic").glob("*.json")))
def test_traffic_seeded(mix):
    tr = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
    cfg = {"read_chars": 100, "fragment_chars": 500, "reference_bp": 5000}

    def make(seed):
        r = generator.Requests(tr, cfg, frags(), seed, stream=0)
        got = [r.get(i) for i in (0, 1, 5000)]
        keep = [r.sampled(i) for i in range(300)]
        return np.concatenate([g["codes"] for g in got]
                              + [np.array(keep, np.uint8)])
    big = 2 ** 31 + 12345
    assert np.array_equal(make(big), make(big))
    assert not np.array_equal(make(big), make(big + 1))


def test_reference_and_fold():
    cfg = {"reference_bp": 9000}
    a = generator.reference_codes(cfg, 2 ** 31 + 7, "cpu")
    assert torch.equal(a, generator.reference_codes(cfg, 2 ** 31 + 7, "cpu"))
    assert not torch.equal(a, generator.reference_codes(cfg, 8, "cpu"))
    rows = generator.fold(a, 500, 100)
    step = 401
    for r in range(rows.shape[0]):
        want = a[r * step:r * step + 500]
        assert torch.equal(rows[r, :len(want)], want)
        assert not rows[r, len(want):].any()
    assert rows.shape[0] == -(-(9000 - 99) // step)
