"""LM serving on a ``(data, model)`` mesh in the PyTorch port: prefill and
decode with caches placed by ``cache_specs``' logical axes, against the
port's one-device calls and the JAX package's one-device steps.

* One spawn of 4 gloo ranks (``launch.cluster``'s worker helpers) on a
  2x2 CPU mesh under the ``"2d"`` profile: for each family (``CASES``:
  dense, int8 KV, MoE, RG-LRU with local attention, SSD, whisper with its
  encoder output, pixtral on embeddings) a prefill, two decode steps at a
  scalar position and one at per-row positions, through
  ``runtime.steps.make_prefill_step``/``make_decode_step``.  llama's
  caches are a one-device tree the steps place; the others come from
  ``init_cache(mesh=)``.  Each call's logits are held to the port's
  one-device call (computed meanwhile) within relative L2 1e-3, the
  gathered caches too, int8 values at most one step apart; llama's logits
  also to the reference's one-device ``make_prefill_step`` /
  ``make_decode_step`` within ``test_torch_lm_serving.py``'s tolerance
  (``rtol = atol = 3e-2``).  The batch is 8 rows (4 a rank): the CPU's
  bf16 matmul rounds a 4-row product otherwise than an 8-row one, so a
  one-device batch of 4 is not what its rows give alone.  recurrentgemma
  under "2d" is held at 5e-3 (``FAMILY_RTOL``: one element of its first
  block one ulp off, carried by the recurrence), and at 1e-3 under
  "fsdp"; every family's first block output is one device's but for at
  most one element in a thousand, each one ulp off.
* Every cache leaf's placements on every rank: those of ``spec_for`` on
  its ``cache_specs`` axes, the reference's spec entry for entry.
* ``init_cache(mesh=, device="meta")`` at full size on the 16x16 mesh
  under a ``fake`` group: each rank's block, nothing allocated.
* A CPU rehearsal of ``chip_smoke.py``'s phase 14 (z3) (threaded ranks,
  the smoke config).
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
import tempfile
import threading
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.distributed import context as dc
from repro_torch.distributed import sharding as ts
from repro_torch.launch import cluster
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model as tm
from repro_torch.models import ssm
from repro_torch.models.spec import leaves, tree_axes
from repro_torch.runtime import steps

ROOT = Path(__file__).resolve().parents[1]
B, S, SMAX = 8, 16, 32
N_RANKS = 4
RTOL = 1e-3                  # relative L2, sharded against one device
JAX_RTOL = JAX_ATOL = 3e-2   # test_torch_lm_serving.py's logit tolerance
CALLS = ("prefill", "decode", "decode2", "decode_rows")
ROW_INDEX = np.array([S + 2, S + 5, S + 2, S + 3, S + 4, S + 2, S + 6,
                      S + 3])
# What the rules read of the 2x2 mesh: axis names and sizes.
BARE = SimpleNamespace(axis_names=("data", "model"),
                       shape={"data": 2, "model": 2})

# (name, arch, config fields): the families the gloo ranks serve.
CASES = [
    ("llama", "llama3.2-1b", {}),
    ("llama-int8", "llama3.2-1b", {"kv_quant": True}),
    ("olmoe", "olmoe-1b-7b", {}),
    ("recurrentgemma", "recurrentgemma-9b", {}),
    ("recurrentgemma-fsdp", "recurrentgemma-9b", {"sharding_profile": "fsdp"}),
    ("mamba2", "mamba2-130m", {}),
    ("whisper", "whisper-tiny", {}),
    ("pixtral", "pixtral-12b", {}),
]
# recurrentgemma under "2d": the tensor-parallel MLP's f32 partial sums
# round to bf16 once, as one device's product does, but their f32 order
# is not one device's, so a rare element lands on the other side of a
# rounding boundary: on these inputs one element of the first block's
# output, 1 ulp off (``test_first_block_differs_by_rounding``), which the
# recurrent stack carries to ~2e-3 of the logits.  Under "fsdp" (whole
# weights on each rank's rows) it is held at RTOL.
FAMILY_RTOL = {"recurrentgemma": 5e-3}


def case_config(name):
    _, arch, fields = next(c for c in CASES if c[0] == name)
    return dataclasses.replace(tget(arch, smoke=True), **fields)


def inputs(cfg):
    """Seeded prefill inputs and decode tokens (numpy, float inputs
    rounded to bf16 as the model rounds them)."""
    rng = np.random.default_rng(7)
    pre = {}
    if cfg.input_mode == "embeddings":
        pre["embeds"] = torch.from_numpy(rng.normal(
            size=(B, S, cfg.d_model)).astype(np.float32)).bfloat16()
    else:
        pre["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.is_encdec:
        pre["frames"] = torch.from_numpy(rng.normal(
            size=(B, cfg.n_audio_frames, cfg.d_model)).astype(
                np.float32)).bfloat16()
    dec = [rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
           for _ in CALLS[1:]]
    return pre, list(zip(dec, (S, S + 1, ROW_INDEX)))


def full(t):
    return t.full_tensor() if dc.is_dtensor(t) else t


def serve(cfg, lm, mesh=None, plain_caches=False):
    """The four calls through the steps: ([logits (B, V) f32 a call],
    the cache tree after them, the prefill's first block output).  On a
    mesh the caches come from ``init_cache(mesh=)``, or, with
    ``plain_caches``, as one device's tree the steps place."""
    pre, decodes = inputs(cfg)
    caches = tm.init_cache(cfg, B, SMAX, device="cpu",
                           mesh=None if plain_caches else mesh)
    prefill = steps.make_prefill_step(cfg)
    decode = steps.make_decode_step(cfg)
    first: list = []
    inner = tm.block_apply

    def block_apply(*args, **kw):
        y, aux = inner(*args, **kw)
        if not first:
            first.append(full(y).float().numpy())
        return y, aux
    tm.block_apply = block_apply
    try:
        logits, caches = prefill(lm, dict(pre, caches=caches))
    finally:
        tm.block_apply = inner
    out = [full(logits).float()]
    enc = None
    if cfg.is_encdec:
        frames = pre["frames"]
        if mesh is not None:
            frames = steps._place_batch({"frames": frames}, mesh,
                                        None)["frames"]
        enc = tm.encode(cfg, lm, frames)
    for toks, ci in decodes:
        logits, caches = decode(lm, {"caches": caches, "tokens": toks,
                                     "cache_index": ci, "enc_out": enc})
        out.append(full(logits).float())
    return out, caches, first[0]


def cache_arrays(caches) -> dict:
    return {p: full(t).float().numpy() for p, t in leaves(caches)
            if p != ssm.STATE_BF16}


def _worker(out_dir: str) -> None:
    """One gloo rank: every case on a 2x2 CPU mesh."""
    torch.manual_seed(0)
    cluster.initialize(backend="gloo", device="cpu")
    rank = torch.distributed.get_rank()
    mesh = tmesh.make_debug_mesh(2, 2, device_type="cpu")
    out = Path(out_dir)
    summary = {"coord": list(mesh.get_coordinate())}
    for name, *_ in CASES:
        cfg = case_config(name)
        rules = ts.RULE_PROFILES[cfg.sharding_profile]
        lm = convert.shard_params(tm.init_params(cfg, 0, device="cpu"),
                                  mesh, rules)
        with dc.activation_sharding(mesh, rules):
            logits, caches, first = serve(cfg, lm, mesh,
                                          plain_caches=name == "llama")
        summary[name] = {
            "placements": {p: [repr(q) for q in t.placements]
                           for p, t in leaves(caches)
                           if p != ssm.STATE_BF16},
            "local": {p: list(t.to_local().shape) for p, t in leaves(caches)
                      if p != ssm.STATE_BF16}}
        arrays = cache_arrays(caches)
        if rank == 0:
            np.savez(out / f"{name}.npz",
                     **{f"logits/{c}": lg.numpy()
                        for c, lg in zip(CALLS, logits)},
                     **{f"cache/{p}": a for p, a in arrays.items()},
                     first=first)
    with open(out / f"rank{rank}.json", "w") as fh:
        json.dump(summary, fh)
    cluster.shutdown()


def one_device(name):
    """The port's one-device calls."""
    cfg = case_config(name)
    logits, caches, first = serve(cfg, tm.init_params(cfg, 0, device="cpu"))
    return {"logits": [lg.numpy() for lg in logits],
            "caches": cache_arrays(caches), "first": first}


def jax_llama():
    """The reference's one-device ``make_prefill_step`` and
    ``make_decode_step`` (compiled with every bf16 rounding kept) on the
    port's llama weights and the same inputs: the logits of each call."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import model as jmodel
    from repro.runtime import steps as jsteps
    cj = get_config("llama3.2-1b", smoke=True)
    ct = case_config("llama")
    params = jax.tree.map(jnp.asarray, convert.to_numpy(
        tm.init_params(ct, 0, device="cpu")))
    opts = {"xla_allow_excess_precision": False}
    pre, decodes = inputs(ct)
    batch = {"tokens": jnp.asarray(pre["tokens"]),
             "caches": jmodel.init_cache(cj, B, SMAX)}
    fn = jax.jit(jsteps.make_prefill_step(cj))
    logits, caches = fn.lower(params, batch).compile(
        compiler_options=opts)(params, batch)
    out = [np.asarray(logits, np.float32)]
    dec = jax.jit(jsteps.make_decode_step(cj))
    for toks, ci in decodes:
        b = {"caches": caches, "tokens": jnp.asarray(toks),
             "cache_index": jnp.asarray(ci, jnp.int32)}
        logits, caches = dec.lower(params, b).compile(
            compiler_options=opts)(params, b)
        out.append(np.asarray(logits, np.float32))
    return out


@pytest.fixture(scope="module")
def ranks():
    """One run of the 4 gloo ranks, with the port's one-device calls and
    the reference's llama computed meanwhile."""
    box: dict = {}
    tmp = tempfile.TemporaryDirectory(prefix="repro_torch_sharded_serve_")
    out = tmp.name

    def spawn():
        try:
            coord = f"127.0.0.1:{cluster.free_port()}"
            envs = [cluster.cpu_process_env(r, N_RANKS, coord, 1)
                    for r in range(N_RANKS)]
            cluster.run_workers([sys.executable, __file__, "--worker", out],
                                envs, [f"rank{r}" for r in range(N_RANKS)],
                                timeout=300, log_dir=out)
        except BaseException as e:       # re-raised on the test's thread
            box["error"] = e
    worker = threading.Thread(target=spawn)
    worker.start()
    try:
        box["port"] = {name: one_device(name) for name, *_ in CASES}
        box["jax"] = jax_llama()
    finally:
        worker.join(timeout=400)
    assert not worker.is_alive()
    if "error" in box:
        raise box["error"]
    box["ranks"] = []
    for r in range(N_RANKS):
        with open(Path(out) / f"rank{r}.json") as fh:
            box["ranks"].append(json.load(fh))
    box["npz"] = {name: dict(np.load(Path(out) / f"{name}.npz"))
                  for name, *_ in CASES}
    yield box
    tmp.cleanup()


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("call", range(len(CALLS)), ids=CALLS)
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_sharded_logits_match_one_device(ranks, name, call):
    got = ranks["npz"][name][f"logits/{CALLS[call]}"]
    want = ranks["port"][name]["logits"][call]
    assert got.shape == want.shape == (B, case_config(name).padded_vocab)
    assert np.all(np.isfinite(got))
    tol = FAMILY_RTOL.get(name, RTOL)
    assert rel(got, want) <= tol, (name, CALLS[call], rel(got, want))


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_gathered_caches_match_one_device(ranks, name):
    """Every cache leaf after the four calls, gathered whole: within
    relative L2 1e-3 of one device's, int8 values at most one step
    apart."""
    npz = ranks["npz"][name]
    want = ranks["port"][name]["caches"]
    assert {k[len("cache/"):] for k in npz if k.startswith("cache/")} \
        == set(want)
    quant = case_config(name).kv_quant
    tol = FAMILY_RTOL.get(name, RTOL)
    for path, w in want.items():
        g = npz[f"cache/{path}"]
        assert g.shape == w.shape, path
        if quant and path.endswith(("/k", "/v")):
            assert np.abs(g - w).max() <= 1, path
        else:
            assert rel(g, w) <= tol, (path, rel(g, w))
    if name == "mamba2":
        assert any(np.any(w) for p, w in want.items()
                   if p.endswith("/state"))


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_first_block_differs_by_rounding(ranks, name):
    """The prefill's first block output (the residual stream after one
    layer) on the mesh: each element one device's, or one bf16 ulp from
    it, in at most one element in a thousand."""
    got = ranks["npz"][name]["first"]
    want = ranks["port"][name]["first"]
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    off = got != want
    assert np.all(np.abs(got - want)[off] <= ulp[off]), name
    assert off.sum() <= want.size // 1000, (name, int(off.sum()))


@pytest.mark.parametrize("call", range(len(CALLS)), ids=CALLS)
def test_sharded_llama_matches_jax_one_device(ranks, call):
    got = ranks["npz"]["llama"][f"logits/{CALLS[call]}"]
    np.testing.assert_allclose(got, ranks["jax"][call], rtol=JAX_RTOL,
                               atol=JAX_ATOL)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_cache_leaves_placed_by_spec_for(ranks, name):
    """Each leaf's placements on every rank are those of ``spec_for`` on
    its ``cache_specs`` axes (the rule table of the config's profile), and
    its local block that spec's block at the rank's coordinate."""
    cfg = case_config(name)
    rules = ts.RULE_PROFILES[cfg.sharding_profile]
    axes = dict(leaves(tree_axes(tm.cache_specs(cfg, B, SMAX))))
    shapes = {p: tuple(a.shape) for p, a in
              ranks["port"][name]["caches"].items()}
    assert set(axes) == set(shapes)
    sharded = 0
    for r in ranks["ranks"]:
        for path, ax in axes.items():
            want = ts.NamedSharding(BARE, ts.spec_for(ax, shapes[path],
                                                      BARE, rules))
            placed = [repr(p) for p in want.placements]
            assert r[name]["placements"][path] == placed, path
            block = list(shapes[path])
            for p in want.placements:
                if p.is_shard():
                    block[p.dim] //= 2
            assert r[name]["local"][path] == block, path
            sharded += placed != ["Replicate()"] * 2
    assert sharded


@pytest.fixture(scope="module")
def jsh():
    from jax.sharding import AbstractMesh
    from repro.distributed import sharding
    return AbstractMesh, sharding




@pytest.mark.parametrize("name", ["llama-int8", "recurrentgemma", "mamba2",
                                  "whisper"])
def test_cache_specs_match_reference_spec_for(jsh, name):
    """The port's cache placements on the 2x2 mesh follow the
    reference's ``spec_for`` entry for entry."""
    AbstractMesh, jsharding = jsh
    cfg = case_config(name)
    rules = ts.RULE_PROFILES[cfg.sharding_profile]
    jmesh = AbstractMesh((2, 2), ("data", "model"))
    for path, s in leaves(tm.cache_specs(cfg, B, SMAX)):
        want = tuple(jsharding.spec_for(s.axes, s.shape, jmesh,
                                        jsharding.RULE_PROFILES[
                                            cfg.sharding_profile]))
        got = ts.spec_for(s.axes, s.shape, BARE, rules)
        assert got == want + (None,) * (len(got) - len(want)), path


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-130m"])
def test_init_cache_on_the_production_mesh_is_abstract(arch):
    """A serving config's cache at decode_32k on the 16x16 mesh under a
    ``fake`` group: every leaf a DTensor of meta shards, rank 0's block
    the ``local_slices`` of its sharding; the host flag stays plain."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    cfg = tget(arch, optimized=True, kind="serve")
    try:
        dryrun.fake_group(256)
        mesh = tmesh.make_production_mesh()
        caches = tm.init_cache(cfg, 128, 32768, device="meta", mesh=mesh)
        placed = tm.cache_shardings(cfg, caches, mesh)
        n = 0
        for path, t in leaves(caches):
            if path == ssm.STATE_BF16:
                assert not dc.is_dtensor(t)
                continue
            n += 1
            assert t.to_local().is_meta
            want = ts.local_slices(t.shape, dict(leaves(placed))[path])
            assert list(t.to_local().shape) == [s.stop - s.start
                                                for s in want]
        assert n == (4 if cfg.kv_quant else 2)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_plain_caches_are_left_as_they_are_off_a_mesh():
    """Without a mesh the steps pass the batch through untouched."""
    cfg = case_config("llama")
    lm = tm.init_params(cfg, 0, device="cpu")
    caches = tm.init_cache(cfg, B, SMAX, device="cpu")
    batch = {"tokens": np.zeros((B, S), np.int32), "caches": caches}
    assert steps._place_serving(cfg, lm, batch) is batch


# -- chip_smoke.py's phase 14 (z3), rehearsed on the CPU ----------------------

def load_chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_z3_rehearsal():
    """(z3) on threaded CPU ranks at smoke size: llama's serving config
    and mamba2 through prefill and decode on the mesh, held to one
    device; it reports its timings and a decode step's collectives,
    which (z4)'s dry run of that step counts alike."""
    cs = load_chip_smoke()
    cs.SERVE_S, cs.SERVE_MAX = 32, 64
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = cs.sharded_z3(device="cpu", sync=lambda: None, smoke=True)
    llama = out["llama"]
    assert llama["worst_rel"] <= cs.SERVE_RTOL
    assert llama["calls"] == 2 + cs.SERVE_DECODES
    assert llama["comm"]["counts"] and llama["arg_bytes"] > 0
    assert out["mamba2"]["worst_rel"] <= cs.SERVE_RTOL
    assert math.isfinite(llama["ms_decode"])
    cell = cs.dryrun_cell("z3 decode", llama["cfg"], "decode",
                          cs.SERVE_MAX, cs.SERVE_B, llama["comm"],
                          llama["arg_bytes"])
    z4 = cs.sharded_z4([cell], device="cpu")
    assert z4["z3 decode"]["hlo_flops_per_dev"] > 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _worker(sys.argv[2])
