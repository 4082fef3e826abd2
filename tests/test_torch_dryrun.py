"""The dry run in the PyTorch port (``repro_torch.launch.dryrun``) and its
per-op cost counter (``repro_torch.distributed.op_analysis``): the
counterparts of ``tests/test_hlo_walker.py`` and ``tests/test_dryrun.py``.

* The counter's rules: a matmul's flops exactly 2 M K N; flops that scale
  with a loop's count; elementwise ops charged to ``bytes_strict`` and
  not to ``bytes``; strict at least the proxy; the dominant term at the
  card's rates; one rank's local ops only under a DTensor matmul split
  four ways (a quarter of the flops), with its collectives by kind; a
  quarter of the expert, RG-LRU core and SSD per-head flops a device on
  four ``model`` ranks.
* Full-size cells under a ``fake`` group: llama3.2-1b ``decode_32k`` on
  the 16x16 (256 ranks) and 2x16x16 (512) meshes and mamba2-130m
  ``long_500k`` are ``ok`` with flops; llama3.2-1b ``long_500k`` is
  ``skipped`` for want of a sub-quadratic mechanism.
* In a subprocess (importing ``repro.launch.dryrun`` forces 512 host
  devices): every cell's ``status``/``reason``, ``analytic_bytes_per_dev``,
  ``params``, ``active_params``, ``tokens`` and ``model_flops_global``
  from the reference's own ``lower_cell``, its compile stubbed out, equal
  the port's on both meshes (32 ``ok`` and 8 ``skipped`` each).
* In another subprocess: the reference walker's ``hlo_flops_per_dev`` for
  llama smoke's train, prefill and decode steps on a 2x2 mesh (the
  reference's ``SHAPES`` patched with small ``InputShape``s there,
  nothing of ``src/repro`` changed); the port's per-device flops for the
  same cells on a 2x2 mesh under a fake group of 4 are within 25%.

Every fake group is destroyed after its test.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import warnings
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.configs import get_config as tget
from repro_torch.distributed import op_analysis as oa
from repro_torch.distributed import sharding as ts
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.models import layers
from repro_torch.models.config import SHAPES, InputShape

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"tiny_train": ("train", 64, 8), "tiny_prefill": ("prefill", 64, 8),
         "tiny_decode": ("decode", 64, 8)}
FLOPS_RTOL = 0.25

# The reference's lower_cell on every cell of both meshes, its compile
# stubbed (the record's arithmetic is computed by its own code).
REF_ARITHMETIC = """
import json
import repro.launch.dryrun as d
import jax
class _Compiled:
    def cost_analysis(self): return {}
    def memory_analysis(self): return None
    def as_text(self): return ""
class _Lowered:
    def compile(self): return _Compiled()
class _Jit:
    def __init__(self, *a, **k): pass
    def lower(self, *a, **k): return _Lowered()
jax.jit = _Jit
keys = ("status", "reason", "analytic_bytes_per_dev", "params",
        "active_params", "tokens", "model_flops_global", "n_devices")
out = []
for multi_pod in (False, True):
    mesh = d.make_production_mesh(multi_pod=multi_pod)
    for arch in d.ARCHS:
        cfg = d.get_config(arch)
        for shape in d.SHAPES:
            rec = d.lower_cell(arch, shape, multi_pod, cfg=cfg, mesh=mesh)
            out.append({k: rec.get(k) for k in ("arch", "shape", "mesh")
                        + keys})
print(json.dumps(out))
"""

# The reference walker's per-device flops for llama smoke on a 2x2 mesh.
REF_WALKER = """
import json, sys
import repro.launch.dryrun as d
import jax
from repro.models.config import InputShape
small = json.loads(sys.argv[1])
for name, (kind, seq, batch) in small.items():
    d.SHAPES[name] = InputShape(name, kind, seq, batch)
orig = d.analytic_bytes_per_dev
d.analytic_bytes_per_dev = lambda cfg, shape, n_dev: orig(cfg, shape, n_dev,
                                                          tp=2)
import numpy as np
mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                         ("data", "model"))
cfg = d.get_config("llama3.2-1b", smoke=True)
out = {}
for name in small:
    rec = d.lower_cell("llama3.2-1b", name, False, cfg=cfg, mesh=mesh)
    out[name] = {k: rec.get(k) for k in ("status", "error",
                                         "hlo_flops_per_dev")}
print(json.dumps(out))
"""


def _spawn(code: str, *args) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", code, *args], env=env,
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def reference():
    """Both reference subprocesses, started once (the first test of the
    module asks for them) and read by the tests that need them."""
    procs = {"arith": _spawn(REF_ARITHMETIC),
             "walker": _spawn(REF_WALKER, json.dumps(SMALL))}
    box: dict = {}

    def result(key):
        if key not in box:
            out, err = procs[key].communicate(timeout=300)
            assert procs[key].returncode == 0, err[-3000:]
            box[key] = json.loads(out.strip().splitlines()[-1])
        return box[key]
    yield result
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture
def fake_world():
    """``fake_world(n)`` joins a ``fake`` group of ``n`` ranks; destroyed
    after the test."""
    import torch.distributed as dist
    yield dryrun.fake_group
    if dist.is_initialized():
        dist.destroy_process_group()


def test_reference_subprocesses_start(reference):
    """Starts the reference's runs, which go on beside the tests below."""
    assert callable(reference)


# -- the counter's rules ------------------------------------------------------

def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("M, K, N", [(64, 32, 48), (1, 4096, 128),
                                     (300, 7, 5)])
def test_dot_flops_exactly_2mkn(M, K, N):
    _, c = oa.count_ops(lambda: meta(M, K) @ meta(K, N))
    assert c.cost.flops == 2.0 * M * K * N
    _, c = oa.count_ops(lambda: torch.bmm(meta(3, M, K), meta(3, K, N)))
    assert c.cost.flops == 2.0 * 3 * M * K * N
    _, c = oa.count_ops(lambda: torch.einsum("bsd,dhk->bhsk", meta(2, M, K),
                                             meta(K, 4, N)))
    assert c.cost.flops == 2.0 * 2 * M * K * 4 * N


@pytest.mark.parametrize("n", [1, 3, 8])
def test_flops_scale_with_a_loops_count(n):
    a, b = meta(16, 32), meta(32, 32)

    def loop():
        x = a
        for _ in range(n):
            x = torch.tanh(x @ b)
        return x
    _, one = oa.count_ops(lambda: torch.tanh(a @ b))
    _, many = oa.count_ops(loop)
    assert many.cost.flops == n * one.cost.flops
    assert many.cost.bytes == n * one.cost.bytes


def test_elementwise_is_strict_only():
    x, y = meta(128, 64), meta(128, 64)
    _, c = oa.count_ops(lambda: x + y)
    assert c.cost.flops == 128 * 64
    assert c.cost.bytes == 0
    assert c.cost.bytes_strict == 3 * 128 * 64 * 4
    _, c = oa.count_ops(lambda: x.to(torch.bfloat16))
    assert c.cost.bytes == 0 and c.cost.bytes_strict == 128 * 64 * 6


def test_reductions_and_gathers_are_charged():
    x = meta(64, 100)
    _, c = oa.count_ops(lambda: x.sum(-1))
    assert c.cost.flops == 64 * 100
    assert c.cost.bytes == c.cost.bytes_strict == (64 * 100 + 64) * 4
    idx = torch.zeros(10, dtype=torch.long, device="meta")
    _, c = oa.count_ops(lambda: x[idx])
    assert c.cost.bytes == 2 * 10 * 100 * 4
    # A slice write charges its update, read and written.
    buf = meta(64, 100)
    _, c = oa.count_ops(lambda: buf[:, 3].copy_(meta(64)))
    assert c.cost.bytes == 2 * 64 * 4


def test_views_are_free_and_memory_peaks():
    x = meta(1024, 1024)

    def views():
        return x.view(1024 * 1024).reshape(1024, 1024).t()[3:5]
    _, c = oa.count_ops(views)
    assert c.cost.bytes_strict == 0 and c.cost.flops == 0

    def temporaries():
        a = torch.zeros(1024, 1024, device="meta")      # 4 MiB
        b = a * 2                                        # 4 MiB
        del a
        return b.sum()
    _, c = oa.count_ops(temporaries)
    assert c.cost.peak_bytes == 2 * 4 * 2 ** 20


def test_strict_is_at_least_the_proxy():
    from repro_torch.models import model as tm
    cfg = tget("llama3.2-1b", smoke=True)
    lm = tm.CausalLM(cfg, tm.abstract_params(cfg))
    tokens = torch.zeros(2, 32, dtype=torch.int32, device="meta")
    _, c = oa.count_ops(tm.forward, cfg, lm, {"tokens": tokens})
    assert c.cost.flops > 2 * cfg.n_params() * 64 * 0.5
    assert c.cost.bytes_strict >= c.cost.bytes > 0
    top = oa.top_bytes_contributors(c, 5)
    assert top and top == sorted(top, key=lambda kv: -kv[1])


def test_dominant_term_at_the_cards_rates():
    from repro_torch.core.tech import H100
    cost = oa.Cost(flops=989e12, bytes=3.35e12 * 2)
    roof = oa.roofline_from_cost(cost)
    assert (roof.compute_s, roof.memory_s) == (1.0, 2.0)
    assert roof.dominant == "memory"
    cost.coll_bytes["all-gather"] = 450e9 * 3
    assert oa.roofline_from_cost(cost).dominant == "collective"
    assert oa.roofline_from_cost(oa.Cost(flops=1e15)).dominant == "compute"
    assert (H100.peak_bf16_flops, H100.hbm_bw, H100.nvlink_bw) == (
        989e12, 3.35e12, 450e9)


def test_local_ops_only_under_a_four_way_dtensor_matmul(fake_world):
    """A DTensor matmul whose rows split over a 2x2 mesh: one rank's local
    product, a quarter of the flops; a contraction split four ways
    reduced to replicas: two all-reduces of the local output."""
    from torch.distributed.tensor import Replicate, Shard
    fake_world(4)
    mesh = tmesh.make_debug_mesh(2, 2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, whole = oa.count_ops(lambda: meta(64, 32) @ meta(32, 48))
        a = ts.from_local(meta(16, 32), mesh, [Shard(0), Shard(0)], (64, 32))
        b = ts.from_local(meta(32, 48), mesh, [Replicate()] * 2, (32, 48))
        _, rows = oa.count_ops(lambda: a @ b)
        assert rows.cost.flops == whole.cost.flops / 4
        assert sum(rows.cost.coll_counts.values()) == 0
        a = ts.from_local(meta(64, 8), mesh, [Shard(1), Shard(1)], (64, 32))
        b = ts.from_local(meta(8, 48), mesh, [Shard(0), Shard(0)], (32, 48))
        _, split = oa.count_ops(lambda: (a @ b).redistribute(
            mesh, [Replicate()] * 2))
    assert split.cost.flops == whole.cost.flops / 4
    assert split.cost.coll_counts["all-reduce"] == 2
    assert split.cost.coll_bytes["all-reduce"] == 2 * 64 * 48 * 4


@pytest.mark.parametrize("profile", ["2d", "fsdp"])
def test_expert_flops_a_device_are_a_quarter_on_four_model_ranks(
        fake_world, monkeypatch, profile):
    """olmoe smoke's prefill on a (1, 4) mesh under a fake group: each rank
    holds and runs 2 of the 8 experts (under "fsdp" on every rank's
    buffers, exchanged by all-to-all), so the expert einsums' flops a
    device are a quarter of one device's (a 1x1 mesh) on the same
    batch."""
    cfg = dataclasses.replace(tget("olmoe-1b-7b", smoke=True),
                              sharding_profile=profile)
    shape = InputShape("tiny_prefill", "prefill", 64, 8)
    inner = layers._experts

    def expert_flops(n_model):
        counted = []

        def experts(p, ein):
            with oa.OpCounter() as c:
                out = inner(p, ein)
            counted.append(c.cost.flops)
            return out
        fake_world(n_model)
        monkeypatch.setattr(layers, "_experts", experts)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            rec = dryrun.lower_cell("olmoe-1b-7b", shape, cfg=cfg,
                                    mesh=tmesh.make_debug_mesh(1, n_model))
        monkeypatch.setattr(layers, "_experts", inner)
        assert rec["status"] == "ok", rec.get("traceback")
        assert len(counted) == cfg.n_layers
        return sum(counted), rec
    one, _ = expert_flops(1)
    four, rec = expert_flops(4)
    assert one > 0 and four == one / 4
    a2a = rec["collective_counts"]["all-to-all"]
    assert a2a == (2 * cfg.n_layers if profile == "fsdp" else 0)


@pytest.mark.parametrize("arch, fields", [
    ("recurrentgemma-9b", {}), ("recurrentgemma-9b", {"rglru_block_diag": 4}),
    ("mamba2-130m", {})], ids=["rglru-dense", "rglru-blocks", "ssd"])
def test_block_flops_a_device_are_a_quarter_on_four_model_ranks(
        fake_world, monkeypatch, arch, fields):
    """Smoke prefills on a (1, 4) mesh under a fake group: each rank runs
    the RG-LRU core (gates, decays, scan) on r/4 channels and the SSD's
    per-head core (its chunked form less the C.B product and the masks,
    which every rank forms alike) on H/4 heads, so their flops a device
    are a quarter of one device's (a 1x1 mesh) on the same batch."""
    from repro_torch.models import rglru, ssm
    cfg = dataclasses.replace(tget(arch, smoke=True), **fields)
    shape = InputShape("tiny_prefill", "prefill", 64, 8)
    mod, name = ((rglru, "_rglru_core") if cfg.family == "hybrid"
                 else (ssm, "_ssd_chunked"))
    inner, shared = getattr(mod, name), ssm._head_shared

    def block_flops(n_model):
        counted = []

        def counting(fn, sign):
            def run(*a, **kw):
                with oa.OpCounter() as c:
                    out = fn(*a, **kw)
                counted.append(sign * c.cost.flops)
                return out
            return run
        fake_world(n_model)
        monkeypatch.setattr(mod, name, counting(inner, 1))
        monkeypatch.setattr(ssm, "_head_shared", counting(shared, -1))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            rec = dryrun.lower_cell(arch, shape, cfg=cfg,
                                    mesh=tmesh.make_debug_mesh(1, n_model))
        monkeypatch.setattr(mod, name, inner)
        monkeypatch.setattr(ssm, "_head_shared", shared)
        assert rec["status"] == "ok", rec.get("traceback")
        n_blocks = sum(k in ("rglru", "ssd") for k in cfg.layer_pattern)
        assert sum(x > 0 for x in counted) == n_blocks
        return sum(counted)
    one = block_flops(1)
    four = block_flops(4)
    assert one > 0 and four == one / 4


# -- full-size cells under a fake group --------------------------------------

@pytest.mark.parametrize("arch, shape, multi_pod", [
    ("llama3.2-1b", "decode_32k", False),
    ("llama3.2-1b", "decode_32k", True),
    ("mamba2-130m", "long_500k", False),
])
def test_full_size_cells_lower(fake_world, arch, shape, multi_pod):
    fake_world(512 if multi_pod else 256)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rec = dryrun.lower_cell(arch, shape, multi_pod)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["n_devices"] == (512 if multi_pod else 256)
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert rec["hlo_flops_per_dev"] > 0
    assert rec["hlo_bytes_strict_per_dev"] >= rec["hlo_bytes_per_dev"] > 0
    assert rec["dominant"] in ("compute", "memory", "collective")
    mem = rec["memory"]
    assert mem["argument_bytes"] > 0 and mem["temp_bytes"] > 0
    if arch == "llama3.2-1b":
        assert sum(rec["collective_counts"].values()) > 0


def test_full_attention_long_context_is_skipped():
    rec = dryrun.lower_cell("llama3.2-1b", "long_500k", False)
    assert rec["status"] == "skipped"
    assert "sub-quadratic" in rec["reason"]


def test_cli_runs_one_cell(fake_world, tmp_path, capsys):
    out = tmp_path / "dry.jsonl"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dryrun.main(["--arch", "mamba2-130m", "--shape", "long_500k",
                     "--out", str(out)])
    rec = json.loads(out.read_text().strip())
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert json.loads(capsys.readouterr().out.strip())["status"] == "ok"
    assert not torch.distributed.is_initialized()


# -- against the reference, in subprocesses -----------------------------------

def test_arithmetic_fields_equal_the_references(reference):
    ref = reference("arith")
    assert len(ref) == 2 * len(ARCHS) * len(SHAPES)
    counts = {"16x16": {"ok": 0, "skipped": 0},
              "2x16x16": {"ok": 0, "skipped": 0}}
    for r in ref:
        cfg = tget(r["arch"])
        shape = SHAPES[r["shape"]]
        counts[r["mesh"]][r["status"]] += 1
        if r["status"] == "skipped":
            rec = dryrun.lower_cell(r["arch"], shape)
            assert rec["status"] == "skipped"
            assert rec["reason"] == r["reason"]
            continue
        assert r["status"] == "ok", r
        got = dryrun.cell_arithmetic(cfg, shape, r["n_devices"])
        for k in ("analytic_bytes_per_dev", "params", "active_params",
                  "tokens", "model_flops_global"):
            assert math.isclose(got[k], r[k], rel_tol=1e-12), (r, k)
    assert counts == {"16x16": {"ok": 32, "skipped": 8},
                      "2x16x16": {"ok": 32, "skipped": 8}}


@pytest.mark.parametrize("name", list(SMALL))
def test_small_cells_flops_near_the_reference_walker(reference, fake_world,
                                                     name):
    ref = reference("walker")[name]
    assert ref["status"] == "ok", ref
    fake_world(4)
    kind, seq, batch = SMALL[name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rec = dryrun.lower_cell("llama3.2-1b", InputShape(name, kind, seq,
                                                          batch),
                                cfg=tget("llama3.2-1b", smoke=True),
                                mesh=tmesh.make_debug_mesh(2, 2))
    assert rec["status"] == "ok", rec.get("traceback")
    got, want = rec["hlo_flops_per_dev"], ref["hlo_flops_per_dev"]
    assert abs(got - want) <= FLOPS_RTOL * want, (name, got, want)
