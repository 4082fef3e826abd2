"""The SSD and RG-LRU blocks tensor-parallel on a ``(data, model)`` mesh in
the PyTorch port, against the port's and the JAX package's one-device
runs.

One spawn of 4 gloo ranks (``launch.cluster``'s worker helpers, this file
with ``--worker DIR``) runs ``CASES`` on CPU meshes, smoke widths, 8 rows
of 32 tokens (two SSD chunks):

* recurrentgemma under ``"2d"``: dense gates on 2x2 (r = 64, 32 channels
  a rank; each rank forms its gate outputs from the gathered channels and
  its columns of the gate, an all-to-all of its rows), block-diagonal
  gates of 4 blocks on 1x4 (one block a rank: local) and of 2 blocks on
  1x4 (a block across two ranks);
* mamba2 under ``"2d"``: 8 heads on 2x2 (``heads`` and ``heads_inner``
  both over ``model``: 4 whole heads a rank, the state local), and
  ``d_model=48`` on 1x4 (6 heads of 16, 96 channels: ``heads``
  replicates, 24 channels a rank, a head and a half: each rank runs the
  two heads its channels touch, the state replicated and gathered on
  write); the gated norm's sums of squares summed across ``model``;
* mamba2 under ``"fsdp"`` on 2x2: the batch over every dim, the block on
  each rank's rows with whole weights (``layers.on_batch_rows``).

Each case against the port's one-device run (computed meanwhile): a
forward's logits, a prefill, a scalar and a per-row decode within 1e-3
relative L2 (5e-3 for recurrentgemma, ``FAMILY_RTOL``), one train step's
loss within 1e-3 and gradient norm within 1e-2, every gradient leaf and
updated leaf within 3e-2 (a leaf initialised at zero entry by entry, as
``test_torch_lm_sharding.py`` holds it); the dense-gate recurrentgemma
and both mamba2 layouts also against the JAX package's one-device
``forward`` and ``make_train_step`` on the same weights
(``convert.to_numpy``), at the same gates.  Structure: each
rank's RG-LRU core sees r/m channels and its SSD core H/m heads (or its
channel block's heads); no all-gather over ``model`` takes an RG-LRU or
SSD leaf's block; no cache leaf is redistributed and no collective takes
a block of the RG-LRU ``h``/``conv`` or a sharded SSD ``state``; after
the serving calls each rank's local cache block is one device's cache
block that the reference's ``spec_for`` assigns it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
import tempfile
import threading
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.distributed import context as dc
from repro_torch.distributed import sharding as ts
from repro_torch.launch import cluster
from repro_torch.launch import mesh as tmesh
from repro_torch.models import layers, rglru, ssm
from repro_torch.models import model as tm
from repro_torch.models.spec import leaves
from repro_torch.optim import adamw
from repro_torch.runtime import steps

B, S, SMAX = 8, 32, 48
N_RANKS = 4
LOGIT_RTOL, LOSS_RTOL, NORM_RTOL, LEAF_RTOL = 1e-3, 1e-3, 1e-2, 3e-2
FAMILY_RTOL = {"recurrentgemma": 5e-3}
OPT = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=10)
ROW_INDEX = np.array([S + 2, S + 5, S + 2, S + 3, S + 4, S + 2, S + 6,
                      S + 3])
CALLS = ("prefill", "decode", "decode_rows")

# (name, arch, profile, (data, model), config fields).
CASES = [
    ("recurrentgemma-2d-2x2", "recurrentgemma-9b", "2d", (2, 2), {}),
    ("recurrentgemma-bd4-1x4", "recurrentgemma-9b", "2d", (1, 4),
     {"rglru_block_diag": 4}),
    ("recurrentgemma-bd2-1x4", "recurrentgemma-9b", "2d", (1, 4),
     {"rglru_block_diag": 2}),
    ("mamba2-2d-2x2", "mamba2-130m", "2d", (2, 2), {}),
    ("mamba2-d48-1x4", "mamba2-130m", "2d", (1, 4), {"d_model": 48}),
    ("mamba2-fsdp-2x2", "mamba2-130m", "fsdp", (2, 2), {}),
]
NAMES = [c[0] for c in CASES]
TP = [c[0] for c in CASES if c[2] == "2d"]
# Held to the reference's one-device step too: the dense gates, both SSD
# layouts.
JAX = ["recurrentgemma-2d-2x2", "mamba2-2d-2x2", "mamba2-d48-1x4"]
BLOCKS = ("/rglru/", "/ssd/")


def case(name):
    _, arch, profile, shape, fields = next(c for c in CASES if c[0] == name)
    cfg = dataclasses.replace(tget(arch, smoke=True),
                              sharding_profile=profile, **fields)
    return cfg, shape


def tol(name):
    return FAMILY_RTOL.get(name.split("-")[0], LOGIT_RTOL)


def make_batch(cfg):
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[:, :2] = -1
    return {"tokens": torch.from_numpy(tokens),
            "labels": torch.from_numpy(labels)}


def decodes(cfg):
    rng = np.random.default_rng(5)
    return [(rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32), ci)
            for ci in (S, ROW_INDEX)]


def full(t):
    return t.full_tensor() if dc.is_dtensor(t) else t


def block_leaves(tree):
    """(path, leaf) of the SSD and RG-LRU leaves of a parameter or cache
    tree."""
    return [(p, t) for p, t in leaves(tree)
            if any(b in "/" + p for b in BLOCKS)]


def run_case(name, mesh=None, record=None):
    """One case on ``mesh`` (None: one device): a forward's logits, the
    serving calls' logits and the SSD/RG-LRU cache leaves after them (on
    a mesh each rank's local blocks), then the gradients and one train
    step's (loss, norm) and updated leaves.  ``record`` (a dispatch mode)
    is active over those calls, not over the gathers that bring their
    results whole for the comparison."""
    cfg, _ = case(name)
    rules = ts.RULE_PROFILES[cfg.sharding_profile]
    lm = tm.init_params(cfg, 0, device="cpu", trainable=True)
    batch = make_batch(cfg)
    placed = batch
    ctx = contextlib.nullcontext()
    if mesh is not None:
        lm = convert.shard_params(lm, mesh, rules)
        placed = steps._place_batch(batch, mesh, None)
        ctx = dc.activation_sharding(mesh, rules)
    rec = record or contextlib.nullcontext()
    out = {}
    with ctx:
        with torch.no_grad(), rec:
            logits, _, _ = tm.forward(cfg, lm, {"tokens": placed["tokens"]})
        out["logits"] = full(logits).float().numpy()
        caches = tm.init_cache(cfg, B, SMAX, device="cpu", mesh=mesh)
        calls = [(steps.make_prefill_step(cfg), {
            "tokens": batch["tokens"].numpy()})]
        calls += [(steps.make_decode_step(cfg), {
            "tokens": toks, "cache_index": ci}) for toks, ci in decodes(cfg)]
        out["serve"] = []
        for fn, b in calls:
            with rec:
                if record is not None:
                    record.phase = "serve"
                lg, caches = fn(lm, dict(b, caches=caches))
                if record is not None:
                    record.phase = "train"
            out["serve"].append(full(lg).float().numpy())
        out["cache"] = {p: (t.to_local() if dc.is_dtensor(t) else t
                            ).float().numpy() for p, t in block_leaves(caches)}
        ps = [p for _, p in leaves(lm.params)]
        with rec:
            _, grads = steps._grads_of(cfg, lm, ps, placed)
        out["grads"] = {p: full(g).float().numpy()
                        for (p, _), g in zip(leaves(lm.params), grads)}
        step = steps.make_train_step(cfg, adamw.OptConfig(**OPT))
        st = adamw.init(lm)
        with rec:
            new, _, m = step(lm, st, batch)
        out["hist"] = (float(m["loss"]), float(m["grad_norm"]))
        out["leaves"] = dict(leaves(convert.to_numpy(new)))
    return out, new


class Collectives(TorchDispatchMode):
    """The functional collectives of float tensors one rank issues: (op,
    group name, input shape, ``phase``: "serve" in the serving calls),
    DTensor-level calls left to DTensor.  The leaves and the states are
    float; the embedding lookup's gather of the integer tokens is left
    out."""

    def __init__(self):
        super().__init__()
        self.log = []
        self.phase = "train"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        name = func.__name__.split(".")[0]
        tensor = isinstance(args[0], torch.Tensor)
        integer = tensor and not args[0].is_floating_point()
        if (func.namespace == "_c10d_functional" and name != "wait_tensor"
                and not integer):
            names = [a for a in list(args) + list((kwargs or {}).values())
                     if isinstance(a, str)]
            shape = list(args[0].shape) if tensor else []
            self.log.append((name, names[-1] if names else None, shape,
                             self.phase))
        return func(*args, **(kwargs or {}))


def leaf_blocks(lm, mesh) -> list:
    """The shapes an SSD or RG-LRU leaf's block takes on this rank, one
    layer's (the stacked dim dropped), as held and with its ``data``
    shards gathered."""
    data = mesh.mesh_dim_names.index("data")
    shapes = set()
    for path, t in block_leaves(lm.params):
        local = list(t.to_local().shape)
        if path.startswith("blocks/units/"):
            local = local[1:]
        shapes.add(tuple(local))
        pl = t.placements[data]
        if pl.is_shard():
            d = pl.dim - (t.ndim - len(local))
            grown = list(local)
            grown[d] *= mesh.shape[data]
            shapes.add(tuple(grown))
    return sorted(shapes)


def _worker(out_dir: str) -> None:
    """One gloo rank: every case on its mesh, its cores, cache moves and
    collectives recorded."""
    torch.manual_seed(0)
    cluster.initialize(backend="gloo", device="cpu")
    rank = torch.distributed.get_rank()
    out = Path(out_dir)
    summary = {}
    seen, moved = [], []
    inner = {"rglru_core": rglru._rglru_core, "ssd_core": ssm._ssd_chunked,
             "rglru_mix": rglru.rglru_mix, "ssd_mix": ssm.ssd_mix,
             "cache_blocks": layers._cache_blocks}

    def rglru_core(cfg, p, x, *a, **kw):
        seen.append(("rglru_core", x.shape[-1]))
        return inner["rglru_core"](cfg, p, x, *a, **kw)

    def ssd_core(cfg, xs, *a):
        seen.append(("ssd_core", xs.shape[2]))
        return inner["ssd_core"](cfg, xs, *a)

    def rglru_mix(cfg, p, x, *a, **kw):
        seen.append(("rglru_mix", p["wx"].shape[-1]))
        return inner["rglru_mix"](cfg, p, x, *a, **kw)

    def ssd_mix(cfg, p, x, *a, **kw):
        seen.append(("ssd_mix", p["wx"].shape[-1], p["A_log"].shape[0]))
        return inner["ssd_mix"](cfg, p, x, *a, **kw)

    def cache_blocks(cache, mesh, target):
        moved.extend(n for n, t in (cache or {}).items()
                     if list(t.placements) != target(t))
        return inner["cache_blocks"](cache, mesh, target)
    rglru._rglru_core, ssm._ssd_chunked = rglru_core, ssd_core
    rglru.rglru_mix, ssm.ssd_mix = rglru_mix, ssd_mix
    layers._cache_blocks = cache_blocks
    meshes = {}
    for name, _, _, shape, _ in CASES:
        if shape not in meshes:
            meshes[shape] = tmesh.make_debug_mesh(*shape, device_type="cpu")
        mesh = meshes[shape]
        seen.clear()
        moved.clear()
        mode = Collectives()
        res, lm = run_case(name, mesh, record=mode)
        model_group = mesh.get_group("model").group_name
        summary[name] = {
            "hist": res["hist"], "coord": list(mesh.get_coordinate()),
            "calls": sorted({tuple(x) for x in seen}),
            "moved": sorted(set(moved)),
            "leaf_blocks": leaf_blocks(lm, mesh),
            "cache_blocks": sorted({tuple(a.shape[1:] if p.startswith(
                "units/") else a.shape) for p, a in res["cache"].items()}),
            "state_blocks": sorted({tuple(a.shape[1:] if p.startswith(
                "units/") else a.shape) for p, a in res["cache"].items()
                if p.endswith(("/h", "/conv")) and "/rglru/" in p
                or p.endswith("/state")}),
            "collectives": [[n, g == model_group, shp, ph]
                            for n, g, shp, ph in mode.log]}
        arrays = {f"cache/{p}": a for p, a in res["cache"].items()}
        if rank == 0:
            arrays.update({"logits": res["logits"],
                           **{f"grad/{p}": g for p, g in res["grads"].items()},
                           **{f"leaf/{p}": a
                              for p, a in res["leaves"].items()}})
            for i, lg in enumerate(res["serve"]):
                arrays[f"serve/{i}"] = lg
        np.savez(out / f"{name}.rank{rank}.npz", **arrays)
    with open(out / f"rank{rank}.json", "w") as fh:
        json.dump(summary, fh)
    cluster.shutdown()


def one_device(name):
    res, _ = run_case(name)
    res["init"] = dict(leaves(convert.to_numpy(
        tm.init_params(case(name)[0], 0, device="cpu"))))
    return res


def jax_one_device(name):
    """The JAX package's one-device ``forward`` and ``make_train_step``
    (compiled with every bf16 rounding kept) on the port's initial
    weights of case ``name`` and the same batch: the logits, (loss, grad
    norm) and the leaves after the step."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import model as jmodel
    from repro.optim import adamw as jadamw
    from repro.runtime import steps as jsteps
    cfg, _ = case(name)
    _, arch, _, _, fields = next(c for c in CASES if c[0] == name)
    cj = dataclasses.replace(get_config(arch, smoke=True), **fields)
    jp = jax.tree.map(jnp.asarray, convert.to_numpy(
        tm.init_params(cfg, 0, device="cpu")))
    batch = {k: jnp.asarray(v.numpy()) for k, v in make_batch(cfg).items()}
    opts = {"xla_allow_excess_precision": False}
    fwd = jax.jit(lambda p, t: jmodel.forward(cj, p, {"tokens": t})[0])
    logits = fwd.lower(jp, batch["tokens"]).compile(
        compiler_options=opts)(jp, batch["tokens"])
    js = jadamw.init(jp)
    fn = jsteps.make_train_step(cj, jadamw.OptConfig(**OPT))
    jp, js, m = jax.jit(fn).lower(jp, js, batch).compile(
        compiler_options=opts)(jp, js, batch)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    return {"logits": np.asarray(logits, np.float32),
            "hist": (float(m["loss"]), float(m["grad_norm"])),
            "leaves": {"/".join(str(getattr(k, "key", k)) for k in path):
                       np.asarray(leaf) for path, leaf in flat}}


@pytest.fixture(scope="module")
def ranks():
    """One run of the 4 gloo ranks, with the port's and the reference's
    one-device runs computed meanwhile."""
    box: dict = {}
    tmp = tempfile.TemporaryDirectory(prefix="repro_torch_head_parallel_")
    out = tmp.name

    def spawn():
        try:
            coord = f"127.0.0.1:{cluster.free_port()}"
            envs = [cluster.cpu_process_env(r, N_RANKS, coord, 1)
                    for r in range(N_RANKS)]
            cluster.run_workers([sys.executable, __file__, "--worker", out],
                                envs, [f"rank{r}" for r in range(N_RANKS)],
                                timeout=400, log_dir=out)
        except BaseException as e:       # re-raised on the test's thread
            box["error"] = e
    worker = threading.Thread(target=spawn)
    worker.start()
    try:
        box["port"] = {name: one_device(name) for name in NAMES}
        box["jax"] = {name: jax_one_device(name) for name in JAX}
    finally:
        worker.join(timeout=500)
    assert not worker.is_alive()
    if "error" in box:
        raise box["error"]
    box["ranks"] = []
    for r in range(N_RANKS):
        with open(Path(out) / f"rank{r}.json") as fh:
            box["ranks"].append(json.load(fh))
    box["npz"] = {name: [dict(np.load(Path(out) / f"{name}.rank{r}.npz"))
                         for r in range(N_RANKS)] for name in NAMES}
    yield box
    tmp.cleanup()


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def hold_leaves(got, want, init, grads):
    """Every updated leaf within LEAF_RTOL relative L2 of ``want``; a leaf
    initialised at zero entry by entry: an entry off by more than
    LEAF_RTOL lr must have a one-device gradient under LEAF_RTOL of its
    leaf's gradient norm."""
    lr = float(adamw.schedule(adamw.OptConfig(**OPT), torch.tensor(1.0)))
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        if np.any(init[path]):
            assert rel(g, w) < LEAF_RTOL, (path, rel(g, w))
            continue
        grad = grads[path]
        off = np.abs(g - w) > LEAF_RTOL * lr
        small = np.abs(grad) <= LEAF_RTOL * np.linalg.norm(grad)
        assert np.all(small[off]), (path, int(off.sum()))


@pytest.mark.parametrize("name", NAMES)
def test_logits_match_one_device(ranks, name):
    got, want = ranks["npz"][name][0]["logits"], ranks["port"][name]["logits"]
    assert got.shape == want.shape == (B, S, case(name)[0].padded_vocab)
    assert np.all(np.isfinite(got))
    assert rel(got, want) <= tol(name), (name, rel(got, want))


@pytest.mark.parametrize("call", range(len(CALLS)), ids=CALLS)
@pytest.mark.parametrize("name", NAMES)
def test_serving_matches_one_device(ranks, name, call):
    got = ranks["npz"][name][0][f"serve/{call}"]
    want = ranks["port"][name]["serve"][call]
    assert got.shape == want.shape and np.all(np.isfinite(got))
    assert rel(got, want) <= tol(name), (name, call, rel(got, want))


@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_one_device(ranks, name):
    """Loss and gradient norm on every rank, every gradient leaf, every
    updated leaf."""
    want = ranks["port"][name]
    for r in ranks["ranks"]:
        gl, gn = r[name]["hist"]
        np.testing.assert_allclose(gl, want["hist"][0], rtol=LOSS_RTOL)
        np.testing.assert_allclose(gn, want["hist"][1], rtol=NORM_RTOL)
    npz = ranks["npz"][name][0]
    for path, w in want["grads"].items():
        assert rel(npz[f"grad/{path}"], w) < LEAF_RTOL, path
    got = {k[len("leaf/"):]: v for k, v in npz.items()
           if k.startswith("leaf/")}
    hold_leaves(got, want["leaves"], want["init"], want["grads"])


@pytest.mark.parametrize("name", JAX)
def test_mesh_matches_jax_one_device(ranks, name):
    """The tensor-parallel forward and train step against the reference's
    one-device ``forward`` and ``make_train_step`` on the same weights and
    batch: logits, loss and gradient norm on every rank, every updated
    leaf."""
    ref = ranks["jax"][name]
    npz = ranks["npz"][name][0]
    assert rel(npz["logits"], ref["logits"]) <= tol(name), (
        name, rel(npz["logits"], ref["logits"]))
    wl, wn = ref["hist"]
    for r in ranks["ranks"]:
        gl, gn = r[name]["hist"]
        np.testing.assert_allclose(gl, wl, rtol=LOSS_RTOL)
        np.testing.assert_allclose(gn, wn, rtol=NORM_RTOL)
    got = {k[len("leaf/"):]: v for k, v in npz.items()
           if k.startswith("leaf/")}
    port = ranks["port"][name]
    hold_leaves(got, ref["leaves"], port["init"], port["grads"])


def expected_cores(name):
    """The (core, width) calls each rank makes: the RG-LRU core on r/m
    channels; the SSD block on its c channels with the per-head leaves'
    heads, its core on the heads those channels touch."""
    cfg, (_, m) = case(name)
    if cfg.family == "hybrid":
        r = cfg.rnn_width // (m if name in TP else 1)
        return {("rglru_core", r), ("rglru_mix", r)}
    H, Pd = cfg.ssd_heads, cfg.ssm_head_dim
    if name not in TP:
        return {("ssd_mix", H * Pd, H), ("ssd_core", H)}
    c = H * Pd // m
    if H % m == 0:
        return {("ssd_mix", c, H // m), ("ssd_core", H // m)}
    touched = {-(-(c0 + c) // Pd) - c0 // Pd for c0 in range(0, H * Pd, c)}
    return {("ssd_mix", c, H)} | {("ssd_core", n) for n in touched}


@pytest.mark.parametrize("name", NAMES)
def test_each_rank_core_sees_its_channels(ranks, name):
    want = expected_cores(name)
    got = set()
    for r in ranks["ranks"]:
        got |= {tuple(c) for c in r[name]["calls"]}
    assert got == want, (name, got, want)


def test_split_heads_touch_two_of_six():
    """The case-(b) layout: 96 channels over 4 ranks, each rank's 24
    channels reach two of the six heads."""
    assert expected_cores("mamba2-d48-1x4") == {("ssd_mix", 24, 6),
                                                ("ssd_core", 2)}


@pytest.mark.parametrize("name", TP)
def test_no_block_leaf_is_gathered_over_model(ranks, name):
    """No all-gather over ``model`` takes an SSD or RG-LRU leaf's block
    (as held or with its ``data`` shards gathered); the block's own
    collectives over ``model`` ran (the gate's all-to-all and its
    input's gather under dense or straddling gates, the gated norm's
    all-reduce)."""
    cfg, _ = case(name)
    for r in ranks["ranks"]:
        blocks = {tuple(b) for b in r[name]["leaf_blocks"]}
        over_model = [(n, tuple(s)) for n, m, s, _ in
                      r[name]["collectives"] if m]
        gathered = {s for n, s in over_model
                    if n == "all_gather_into_tensor"}
        assert not blocks & gathered, (name, blocks & gathered)
        kinds = {n for n, _ in over_model}
        if cfg.family == "ssm":
            assert "all_reduce" in kinds, (name, kinds)
        elif name != "recurrentgemma-bd4-1x4":
            assert "all_gather_into_tensor" in kinds, (name, kinds)
        if name == "recurrentgemma-2d-2x2":
            assert "all_to_all_single" in kinds, (name, kinds)


@pytest.mark.parametrize("name", NAMES)
def test_caches_stay_where_placed(ranks, name):
    """No cache leaf is redistributed for the block, and no collective of
    the serving calls takes a block of the RG-LRU ``h``/``conv`` or of an
    SSD ``state`` that shards its heads."""
    cfg, (_, m) = case(name)
    for r in ranks["ranks"]:
        assert r[name]["moved"] == [], (name, r[name]["moved"])
        local = {tuple(b) for b in r[name]["state_blocks"]}
        if cfg.family == "ssm" and cfg.ssd_heads % m:
            local = {b for b in local if len(b) != 4}
        taken = {tuple(s) for _, _, s, ph in r[name]["collectives"]
                 if ph == "serve"}
        assert not local & taken, (name, local & taken)


@pytest.fixture(scope="module")
def jspec():
    from jax.sharding import AbstractMesh
    from repro.distributed import sharding
    return AbstractMesh, sharding


@pytest.mark.parametrize("name", NAMES)
def test_cache_blocks_are_one_devices(ranks, jspec, name):
    """After the prefill and the decodes, each rank's local block of every
    SSD and RG-LRU cache leaf equals (within the logit gate) the block of
    one device's cache that the reference's ``spec_for`` places on its
    mesh coordinate."""
    AbstractMesh, jsharding = jspec
    cfg, shape = case(name)
    jmesh = AbstractMesh(shape, ("data", "model"))
    rules = jsharding.RULE_PROFILES[cfg.sharding_profile]
    specs = dict(leaves(tm.cache_specs(cfg, B, SMAX)))
    sizes = dict(zip(("data", "model"), shape))
    want = ranks["port"][name]["cache"]
    assert want
    for r, npz in zip(ranks["ranks"], ranks["npz"][name]):
        coord = dict(zip(("data", "model"), r[name]["coord"]))
        for path, whole in want.items():
            s = specs[path]
            spec = tuple(jsharding.spec_for(s.axes, s.shape, jmesh, rules))
            block = []
            for n, entry in zip(whole.shape, spec + (None,) * len(
                    whole.shape)):
                axes = (entry if isinstance(entry, tuple)
                        else (entry,) if entry else ())
                k, i = 1, 0
                for a in axes:
                    k, i = k * sizes[a], i * sizes[a] + coord[a]
                block.append(slice(i * n // k, (i + 1) * n // k))
            got = npz[f"cache/{path}"]
            assert got.shape == whole[tuple(block)].shape, path
            assert rel(got, whole[tuple(block)]) <= tol(name), (
                name, path, rel(got, whole[tuple(block)]))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _worker(sys.argv[2])
