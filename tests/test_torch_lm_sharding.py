"""The LM's sharding in the PyTorch port: the logical-axis rules as DTensor
placements on a named ``(data, model)`` mesh, against the JAX package.

* (a) The rules, spec for spec, against ``repro.distributed.sharding.
  spec_for``: the ``TestRules`` cases of ``tests/test_sharding.py``,
  every parameter leaf of the ten archs at full size (plain and
  ``optimized=True`` for training and serving, under each config's
  profile), every ``cache_specs`` leaf at ``decode_32k`` and
  ``batch_specs`` over ``input_specs`` for every applicable (arch,
  shape), over the 16x16 and 2x16x16 meshes.  The reference is handed a
  ``jax.sharding.AbstractMesh`` (no devices needed).
* (b) The abstract trees (``abstract``/``tree_axes``/``abstract_params``/
  ``param_axes``/``input_specs``): meta tensors whose shapes and dtypes,
  and axes, equal the reference's ``ShapeDtypeStruct``s and axes.
* (c) ``make_production_mesh``/``make_debug_mesh`` under a ``fake``
  process group of 256 and 512 ranks (destroyed after), the refusal of a
  smaller world, and the full-size embedding's local block there.
* (d) Placement order: on a 2x2x2 ``(pod, data, model)`` mesh of
  threaded CPU ranks, each rank's block of a tensor placed by a composite
  entry equals the block JAX puts on the device at that coordinate
  (``devices_indices_map``, computed in a subprocess with 8 host
  devices).
* (e) One shared spawn of 4 gloo ranks (``launch.cluster``'s worker
  helpers) on a 2x2 CPU mesh: the llama3.2-1b smoke train step under the
  ``"2d"`` and ``"fsdp"`` profiles against the JAX one-device
  ``make_train_step`` and the port's one-device step (loss 1e-3,
  gradient norm 1e-2, every updated leaf 3e-2 relative L2), with
  microbatches and with ``remat``; one step of each other family against
  the port's one-device step; the placements ``constrain`` leaves at its
  three sites; and both cases of the reference's
  ``test_elastic_checkpoint_restore_onto_mesh``, bit for bit.  Every
  gradient leaf is held too (3e-2 relative L2).  A leaf initialised at
  zero (a bias, ``A_log``, ``dt_bias``; llama has none) is held entry by
  entry: AdamW's first step from zero sets each entry to about -lr times
  the sign of its gradient, so an entry whose gradient is so small that
  rounding flips its sign steps the other way.  An entry may be off the
  one-device step by more than 3e-2 lr only where its one-device
  gradient is under 3e-2 of its leaf's gradient norm: the entries whose
  sign the gradient's own tolerance lets rounding flip.  A key bias
  without RoPE, whose exact gradient is 0, has a gradient under 1e-4 of
  the norm (``test_torch_lm_train.py``'s rule) and moves at most 2 lr.
  olmoe is held in full under its training deployment's ``"fsdp"``
  profile, and by its loss and gradient norm under ``"2d"`` (see
  ``CASES``).
* (f) With no mesh installed ``constrain`` is the identity;
  ``activation_sharding`` nests and resets.
* A CPU rehearsal of ``chip_smoke.py``'s phase 14 (threaded ranks, the
  smoke config).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS
from repro_torch.configs import get_config as tget
from repro_torch.distributed import context as dc
from repro_torch.distributed import sharding as ts
from repro_torch.launch import cluster
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model as tm
from repro_torch.models import spec as tspec
from repro_torch.models.config import SHAPES, shape_applicable
from repro_torch.models.spec import leaves
from repro_torch.optim import adamw
from repro_torch.runtime import steps

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL, NORM_RTOL, LEAF_RTOL = 1e-3, 1e-2, 3e-2
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
OPT = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=10)
B, S = 4, 16
N_RANKS = 4


# -- helpers ------------------------------------------------------------------

@dataclasses.dataclass
class BareMesh:
    """What the rules read of a mesh: axis names and sizes."""
    axis_names: tuple
    shape: dict


def bare(shape, names) -> BareMesh:
    return BareMesh(tuple(names), dict(zip(names, shape)))


@pytest.fixture(scope="module")
def jsh():
    from jax.sharding import AbstractMesh
    from repro.configs import get_config
    from repro.distributed import sharding
    from repro.models import model, spec
    from repro.models.config import SHAPES as JSHAPES
    return dict(AbstractMesh=AbstractMesh, get_config=get_config,
                sharding=sharding, model=model, spec=spec, SHAPES=JSHAPES)


def jax_leaves(tree, is_leaf):
    """(path, leaf) of a reference tree in the port's path order."""
    import jax
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return sorted(("/".join(str(getattr(k, "key", k)) for k in path), leaf)
                  for path, leaf in flat)


def config_variants():
    return [(arch, opt, kind) for arch in ARCHS
            for opt, kind in ((False, "train"), (True, "train"),
                              (True, "serve"))]


def smoke(arch, **replace):
    return dataclasses.replace(tget(arch, smoke=True), **replace)


def make_batch(cfg, seed=0):
    """Numpy inputs for one step of ``cfg`` at B x S (whisper's frames,
    pixtral's embeddings), float inputs rounded to bf16 as the port's
    model rounds them."""
    rng = np.random.default_rng(seed)
    batch = {"labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    batch["labels"][:, :2] = -1
    if cfg.input_mode == "embeddings":
        batch["embeds"] = rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.is_encdec:
        batch["frames"] = rng.normal(
            size=(B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v).bfloat16() if v.dtype == np.float32
            else torch.from_numpy(v) for k, v in batch.items()}


# (name, arch, config fields, steps, held): the cases the gloo ranks run.
# ``held`` "all": every check of the module; "norms": the loss and the
# gradient norm only (olmoe under "2d": tensor parallelism rounds layer 0's
# router logits otherwise than one device does, and a near-tie routing
# decision there goes the other way, which moves that layer's MoE
# gradients by ~6%; under "fsdp", its training deployment's profile, every
# rank routes its rows as one device does).
CASES = [
    ("llama-2d", "llama3.2-1b", {}, 2, "all"),
    ("llama-fsdp", "llama3.2-1b", {"sharding_profile": "fsdp"}, 1, "all"),
    ("llama-microbatch", "llama3.2-1b", {"microbatch": 2}, 1, "all"),
    ("llama-remat", "llama3.2-1b", {"remat": True}, 1, "all"),
    ("olmoe", "olmoe-1b-7b", {"sharding_profile": "fsdp"}, 1, "all"),
    ("olmoe-2d", "olmoe-1b-7b", {}, 1, "norms"),
    ("recurrentgemma", "recurrentgemma-9b", {}, 1, "all"),
    ("mamba2", "mamba2-130m", {}, 1, "all"),
    ("whisper", "whisper-tiny", {}, 1, "all"),
    ("pixtral", "pixtral-12b", {}, 1, "all"),
]


def case_config(name):
    _, arch, fields, n, _ = next(c for c in CASES if c[0] == name)
    return smoke(arch, **fields), n


def one_device(name):
    """The port's one-device run of a case: gradients at the first step,
    (loss, grad norm) a step, the leaves after the last step."""
    cfg, n = case_config(name)
    lm = tm.init_params(cfg, 0, device="cpu", trainable=True)
    init = {p: a for p, a in leaves(convert.to_numpy(lm))}
    ps = [p for _, p in leaves(lm.params)]
    _, grads = steps._grads_of(cfg, lm, ps, make_batch(cfg))
    step = steps.make_train_step(cfg, adamw.OptConfig(**OPT))
    st = adamw.init(lm)
    hist = []
    for s in range(n):
        lm, st, m = step(lm, st, make_batch(cfg, seed=s))
        hist.append((float(m["loss"]), float(m["grad_norm"])))
    return {"hist": hist, "init": init,
            "grads": {p: g.float().numpy()
                      for (p, _), g in zip(leaves(lm.params), grads)},
            "leaves": dict(leaves(convert.to_numpy(lm)))}


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def zero_grad_leaf(cfg, path: str) -> bool:
    """A key bias that no RoPE rotates: its exact gradient is 0."""
    return cfg.rope_theta <= 0 and path.endswith("/bk")


def block_of(a: np.ndarray, placements, coord, sizes) -> np.ndarray:
    """The block of ``a`` at mesh coordinate ``coord`` under DTensor
    placements (strings ``Shard(dim=d)``/``Replicate()``), mesh dims split
    left to right -- written out here apart from DTensor."""
    index = [slice(None)] * a.ndim
    for p, c, n in zip(placements, coord, sizes):
        if p.startswith("Shard"):
            d = int(p.split("=")[1].rstrip(")"))
            s = index[d]
            lo, hi = s.start or 0, a.shape[d] if s.stop is None else s.stop
            step = (hi - lo) // n
            index[d] = slice(lo + c * step, lo + (c + 1) * step)
    return a[tuple(index)]


# -- (a) the rules, spec for spec ---------------------------------------------

@pytest.mark.parametrize("axes, shape, mesh, want", [
    (("vocab", "embed"), (64, 32), ((2, 2), ("data", "model")),
     ("model", "data")),
    (("heads", None), (3, 7), ((2, 2), ("data", "model")), (None, None)),
    (("vocab", "ff"), (64, 64), ((2, 2), ("data", "model")),
     ("model", None)),
    (("batch", None), (8, 4), ((2, 2, 2), ("pod", "data", "model")),
     (("pod", "data"), None)),
    (("batch",), (2,), ((2, 2, 2), ("pod", "data", "model")), ("data",)),
])
def test_rules_cases_match_reference(jsh, axes, shape, mesh, want):
    """The five ``TestRules`` cases."""
    got = ts.spec_for(axes, shape, bare(*mesh))
    ref = jsh["sharding"].spec_for(axes, shape,
                                   jsh["AbstractMesh"](*mesh))
    assert got == tuple(ref) == want


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch, opt, kind", config_variants())
def test_param_specs_match_reference(jsh, arch, opt, kind, mesh):
    """Every parameter leaf at full size: the same paths, shapes and axes,
    and under the config's profile the same spec."""
    ct = tget(arch, optimized=opt, kind=kind)
    cj = jsh["get_config"](arch, optimized=opt, kind=kind)
    assert ct.sharding_profile == cj.sharding_profile
    rt = ts.RULE_PROFILES[ct.sharding_profile]
    rj = jsh["sharding"].RULE_PROFILES[cj.sharding_profile]
    tmesh_, jmesh = bare(*MESHES[mesh]), jsh["AbstractMesh"](*MESHES[mesh])
    got = dict(leaves(tm.param_specs(ct)))
    want = dict(jax_leaves(jsh["model"].param_specs(cj),
                           jsh["spec"].is_spec))
    assert set(got) == set(want)
    for path, w in want.items():
        s = got[path]
        assert (s.shape, s.axes) == (tuple(w.shape), tuple(w.axes)), path
        assert ts.spec_for(s.axes, s.shape, tmesh_, rt) == tuple(
            jsh["sharding"].spec_for(w.axes, w.shape, jmesh, rj)), path


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch, opt, kind", config_variants())
def test_cache_specs_match_reference(jsh, arch, opt, kind, mesh):
    """Every ``cache_specs`` leaf at ``decode_32k``."""
    shape = SHAPES["decode_32k"]
    ct = tget(arch, optimized=opt, kind=kind)
    cj = jsh["get_config"](arch, optimized=opt, kind=kind)
    rt = ts.RULE_PROFILES[ct.sharding_profile]
    rj = jsh["sharding"].RULE_PROFILES[cj.sharding_profile]
    tmesh_, jmesh = bare(*MESHES[mesh]), jsh["AbstractMesh"](*MESHES[mesh])
    specs = tm.cache_specs(ct, shape.global_batch, shape.seq_len)
    axes = tspec.tree_axes(specs)
    got = dict(leaves(specs))
    want = dict(jax_leaves(jsh["model"].cache_specs(cj, shape.global_batch,
                                                    shape.seq_len),
                           jsh["spec"].is_spec))
    assert set(got) == set(want)
    flat_axes = dict(leaves(axes))
    for path, w in want.items():
        s = got[path]
        assert tuple(s.shape) == tuple(w.shape), path
        assert flat_axes[path] == tuple(w.axes) == s.axes, path
        assert ts.spec_for(s.axes, s.shape, tmesh_, rt) == tuple(
            jsh["sharding"].spec_for(w.axes, w.shape, jmesh, rj)), path


def applicable():
    return [(arch, shape) for arch in ARCHS for shape in SHAPES
            if shape_applicable(tget(arch), SHAPES[shape])[0]]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch, shape", applicable())
def test_batch_specs_match_reference(jsh, arch, shape, mesh):
    """``batch_specs`` over ``input_specs``: leaf for leaf the
    reference's spec; ``batch_sharding``, ``replicated`` and
    ``total_dp`` along."""
    ct, cj = tget(arch), jsh["get_config"](arch)
    jmesh = jsh["AbstractMesh"](*MESHES[mesh])
    tmesh_ = bare(*MESHES[mesh])
    got = dict(leaves(ts.batch_specs(
        tm.input_specs(ct, SHAPES[shape]), tmesh_)))
    want = dict(jax_leaves(jsh["sharding"].batch_specs(
        jsh["model"].input_specs(cj, jsh["SHAPES"][shape]), jmesh),
        lambda x: hasattr(x, "spec")))
    assert set(got) == set(want)
    for path, w in want.items():
        spec = tuple(w.spec)
        assert got[path].spec == spec + (None,) * (
            len(got[path].spec) - len(spec)), path
    assert ts.total_dp(tmesh_) == jsh["sharding"].total_dp(jmesh)
    assert ts.batch_sharding(tmesh_).spec == tuple(
        jsh["sharding"].batch_sharding(jmesh).spec)
    assert ts.replicated(tmesh_).spec == tuple(
        jsh["sharding"].replicated(jmesh).spec)


# -- (b) the abstract trees ---------------------------------------------------

def _struct(t):
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_and_axes_match_reference(jsh, arch):
    ct, cj = tget(arch), jsh["get_config"](arch)
    got = dict(leaves(tm.abstract_params(ct)))
    assert all(t.device.type == "meta" for t in got.values())
    want = dict(jax_leaves(jsh["model"].abstract_params(cj), None))
    assert set(got) == set(want)
    for path, w in want.items():
        assert _struct(got[path]) == (tuple(w.shape), str(w.dtype)), path
    axes = dict(leaves(tm.param_axes(ct)))
    jaxes = dict(jax_leaves(jsh["model"].param_axes(cj),
                            lambda x: isinstance(x, tuple)))
    assert axes == jaxes
    assert dict(leaves(tspec.tree_axes(tm.param_specs(ct)))) == axes


@pytest.mark.parametrize("arch, shape", applicable())
def test_input_specs_match_reference(jsh, arch, shape):
    """Every key, shape and dtype (the caches' from ``abstract``)."""
    ct = tget(arch, optimized=True, kind=SHAPES[shape].kind)
    cj = jsh["get_config"](arch, optimized=True, kind=SHAPES[shape].kind)
    got = dict(leaves(tm.input_specs(ct, SHAPES[shape])))
    want = dict(jax_leaves(jsh["model"].input_specs(
        cj, jsh["SHAPES"][shape]), None))
    assert set(got) == set(want)
    for path, w in want.items():
        assert got[path].device.type == "meta"
        dtype = str(w.dtype)
        if path.endswith("/ssd/state"):
            # The port holds the SSD state in f32 where the reference
            # declares bf16 (``ssm.ssd_cache_specs``).
            assert dtype == "bfloat16"
            dtype = "float32"
        assert _struct(got[path]) == (tuple(w.shape), dtype), path


def test_abstract_allocates_nothing():
    specs = tm.param_specs(tget("qwen1.5-32b"))
    tree = tspec.abstract(specs)
    assert sum(t.numel() for _, t in leaves(tree)) == tspec.count_params(
        specs)
    # 32 billion parameters: only a meta tensor holds that without memory.
    assert all(t.is_meta for _, t in leaves(tree))


# -- (c) the meshes -----------------------------------------------------------

@pytest.fixture
def fake_world():
    """``fake_world(n)`` joins a ``fake`` group of ``n`` ranks (no devices,
    no collectives); the group is destroyed after."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def join(n):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    yield join
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_under_fake_group(fake_world, jsh, multi_pod):
    shape, names = MESHES["multipod" if multi_pod else "pod"]
    fake_world(math.prod(shape))
    mesh = tmesh.make_production_mesh(multi_pod=multi_pod)
    assert mesh.device_type == "cuda"
    assert tuple(mesh.shape) == shape
    assert mesh.mesh_dim_names == names
    assert ts.axis_sizes(mesh) == dict(zip(names, shape))
    # The DeviceMesh reads as the bare mesh does; the embedding's block.
    cfg = tget("llama3.2-1b")
    rules = ts.RULE_PROFILES[cfg.sharding_profile]
    for path, s in leaves(tm.param_specs(cfg)):
        assert ts.spec_for(s.axes, s.shape, mesh, rules) == ts.spec_for(
            s.axes, s.shape, bare(shape, names), rules), path
    embed = ts.NamedSharding(mesh, ts.spec_for(
        ("vocab", "embed"), (128256, 2048), mesh, rules))
    block = ts.local_slices((128256, 2048), embed)
    assert [s.stop - s.start for s in block] == [128256 // 16, 2048 // 16]
    # One rank short: the reference's numbers in the message.
    fake_world(math.prod(shape) - 1)
    with pytest.raises(RuntimeError, match=(
            rf"need {math.prod(shape)} devices for mesh "
            rf"\({', '.join(map(str, shape))}\), have "
            rf"{math.prod(shape) - 1}")):
        tmesh.make_production_mesh(multi_pod=multi_pod)


def test_debug_mesh_under_fake_group(fake_world):
    fake_world(8)
    mesh = tmesh.make_debug_mesh(2, 2, multi_pod=True)
    assert tuple(mesh.shape) == (2, 2, 2)
    assert mesh.mesh_dim_names == ("pod", "data", "model")
    assert tmesh.make_debug_mesh(2, 4).mesh_dim_names == ("data", "model")
    cpu = tmesh.make_debug_mesh(device_type="cpu")
    assert cpu.device_type == "cpu" and tuple(cpu.shape) == (2, 2)
    fake_world(3)
    with pytest.raises(RuntimeError, match=r"need 4 devices for mesh "
                                           r"\(2, 2\), have 3"):
        tmesh.make_debug_mesh()


# -- (d) placement order against JAX's device blocks --------------------------

ORDER_CASES = [
    ((16, 8), (("pod", "data"), None)),
    ((16, 8), (("pod", "data", "model"), None)),
    ((8, 16), ("data", "model")),
    ((8, 16), ("model", ("pod", "data"))),
    ((16, 8), (("data", "model"), "pod")),
]

JAX_BLOCKS = """
import json, sys
import jax
from jax.sharding import NamedSharding, PartitionSpec
cases = json.loads(sys.argv[1])
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                     devices=jax.devices()[:8])
out = []
for shape, spec in cases:
    spec = [tuple(e) if isinstance(e, list) else e for e in spec]
    idx = NamedSharding(mesh, PartitionSpec(*spec)).devices_indices_map(
        tuple(shape))
    blocks = {}
    for coord in [(i, j, k) for i in range(2) for j in range(2)
                  for k in range(2)]:
        sl = idx[mesh.devices[coord]]
        blocks[str(list(coord))] = [[s.start or 0, n if s.stop is None
                                     else s.stop]
                                    for s, n in zip(sl, shape)]
    out.append(blocks)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_blocks():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run([sys.executable, "-c", JAX_BLOCKS,
                          json.dumps(ORDER_CASES)], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_placement_order_matches_jax_blocks(jax_blocks):
    """Each of 8 threaded ranks' local block of an arange tensor placed
    by the spec is JAX's block at the rank's mesh coordinate."""
    def rank(r):
        mesh = tmesh.make_debug_mesh(2, 2, multi_pod=True,
                                     device_type="cpu")
        coord = tuple(mesh.get_coordinate())
        out = []
        for shape, spec in ORDER_CASES:
            full = torch.arange(math.prod(shape)).reshape(shape)
            t = ts.distribute(full, ts.NamedSharding(mesh, spec))
            out.append((coord, full, t.to_local().clone(),
                        [repr(p) for p in t.placements]))
        return out
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        results = tmesh.run_threaded(8, rank)
    coords = set()
    for per_rank in results:
        for (coord, full, local, _), blocks in zip(per_rank, jax_blocks):
            coords.add(coord)
            want = full[tuple(slice(a, b) for a, b in
                              blocks[str(list(coord))])]
            assert torch.equal(local, want), (coord, blocks)
    assert len(coords) == 8


def test_composite_entry_must_follow_mesh_order():
    mesh = bare((2, 2), ("data", "model"))
    assert ts.NamedSharding(mesh, (("data", "model"),)).spec
    with pytest.raises(ValueError, match="axis order"):
        ts.NamedSharding(mesh, (("model", "data"),)).placements


# -- (f) no mesh --------------------------------------------------------------

def test_constrain_without_mesh_is_identity():
    x = torch.randn(2, 3, 4)
    assert dc.current_mesh() is None
    assert dc.constrain(x, ("batch", None, None)) is x


def test_activation_sharding_nests_and_resets():
    outer, inner = bare((2, 2), ("data", "model")), bare((4,), ("data",))
    x = torch.randn(4, 2)
    with dc.activation_sharding(outer):
        assert dc.current_mesh() is outer
        with dc.activation_sharding(inner, ts.FSDP_RULES):
            assert dc.current_mesh() is inner
            # A plain tensor passes; a rank that differs from the axes too.
            assert dc.constrain(x, ("batch", None)) is x
            assert dc.constrain(x, ("batch",)) is x
        assert dc.current_mesh() is outer
    assert dc.current_mesh() is None


def test_forward_without_mesh_is_unchanged():
    """The constrain sites and the replication switch leave a one-device
    forward as it was: the loss equals the model's own op-by-op value."""
    cfg = smoke("llama3.2-1b")
    lm = tm.init_params(cfg, 0, device="cpu")
    batch = make_batch(cfg)
    with dc.activation_sharding(bare((2, 2), ("data", "model"))):
        inside = tm.loss_fn(cfg, lm, batch)
    assert torch.equal(inside, tm.loss_fn(cfg, lm, batch))


# -- (e) the sharded train step on 4 gloo ranks -------------------------------

def _record_constrain(log):
    """Wrap the model's ``constrain`` to log (axes, placements after)."""
    inner = tm.constrain

    def constrain(x, axes):
        out = inner(x, axes)
        if dc.is_dtensor(out):
            log.append([list(axes), [repr(p) for p in out.placements]])
        return out
    return constrain


def _worker(out_dir: str) -> None:
    """One gloo rank: every case on a 2x2 CPU mesh, then the restores."""
    torch.manual_seed(0)
    cluster.initialize(backend="gloo", device="cpu")
    rank = torch.distributed.get_rank()
    mesh = tmesh.make_debug_mesh(2, 2, device_type="cpu")
    out = Path(out_dir)
    summary = {"coord": list(mesh.get_coordinate())}
    for name, arch, fields, n, _ in CASES:
        cfg = smoke(arch, **fields)
        lm = convert.shard_params(
            tm.init_params(cfg, 0, device="cpu", trainable=True), mesh)
        ps = [p for _, p in leaves(lm.params)]
        rules = ts.RULE_PROFILES[cfg.sharding_profile]
        log: list = []
        tm.constrain, inner = _record_constrain(log), tm.constrain
        try:
            with dc.activation_sharding(mesh, rules):
                _, grads = steps._grads_of(cfg, lm, ps, make_batch(cfg))
        finally:
            tm.constrain = inner
        grads = [g.full_tensor().float().numpy() for g in grads]
        step = steps.make_train_step(cfg, adamw.OptConfig(**OPT))
        st = adamw.init(lm)
        hist = []
        with dc.activation_sharding(mesh, rules):
            for s in range(n):
                lm, st, m = step(lm, st, make_batch(cfg, seed=s))
                hist.append((float(m["loss"]), float(m["grad_norm"])))
        placed = {p: [repr(q) for q in t.placements]
                  for p, t in leaves(lm.params)}
        moments = all(list(t.placements) == list(p.placements)
                      for (_, t), (_, p) in zip(leaves(st["m"]),
                                                leaves(lm.params)))
        final = dict(leaves(convert.to_numpy(lm)))
        summary[name] = {"hist": hist, "constrain": log,
                         "placements": placed, "moments_placed": moments}
        if rank == 0:
            np.savez(out / f"{name}.npz",
                     **{f"leaf/{p}": a for p, a in final.items()},
                     **{f"grad/{p}": g for (p, _), g in
                        zip(leaves(lm.params), grads)})
    # Restores: a mesh-less checkpoint written by rank 0, read on the mesh.
    cfg = smoke("llama3.2-1b")
    like = tm.init_params(cfg, 1, device="cpu")
    small = {"w": torch.arange(64.0).reshape(8, 8), "b": torch.ones(4)}
    ckpt = out / "ckpt"
    if rank == 0:
        mgr = CheckpointManager(ckpt, async_write=False)
        mgr.save(3, small, blocking=True)
        mgr.save(4, like, blocking=True)
    torch.distributed.barrier()
    mgr = CheckpointManager(ckpt, async_write=False, keep=10)
    sh = {"w": ts.NamedSharding(mesh, ("data", "model")),
          "b": ts.replicated(mesh)}
    got, step3 = mgr.restore(small, step=3, shardings=sh)
    rules = ts.RULE_PROFILES[cfg.sharding_profile]
    psh = ts.shardings_for(tm.param_axes(cfg), tm.abstract_params(cfg),
                           mesh, rules)
    model_got, step4 = mgr.restore(like, step=4, shardings=psh)
    blocks = {f"small/{k}": v.to_local().numpy() for k, v in got.items()}
    blocks.update({f"model/{p}": t.to_local().numpy()
                   for p, t in leaves(model_got.params)})
    np.savez(out / f"blocks{rank}.npz", **blocks)
    # The sharded tree saved back (gathered, written by rank 0) restores
    # without a mesh.
    mgr.save(5, model_got, blocking=True)
    back, _ = mgr.restore(like, step=5, device="cpu")
    summary["restore"] = {
        "steps": [step3, step4],
        "placements": {**{f"small/{k}": [repr(p) for p in v.placements]
                          for k, v in got.items()},
                       **{f"model/{p}": [repr(q) for q in t.placements]
                          for p, t in leaves(model_got.params)}},
        "roundtrip": all(torch.equal(a, b) for (_, a), (_, b) in
                         zip(leaves(back.params), leaves(like.params))),
        "trainable": any(p.requires_grad for p in model_got.parameters())}
    with open(out / f"rank{rank}.json", "w") as fh:
        json.dump(summary, fh)
    cluster.shutdown()


def jax_llama_steps(n):
    """The JAX package's one-device ``make_train_step`` (compiled with
    every bf16 rounding kept) on the port's initial llama weights and the
    same batches: [(loss, grad norm)] a step and the leaves after it."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.optim import adamw as jadamw
    from repro.runtime import steps as jsteps
    cj = get_config("llama3.2-1b", smoke=True)
    ct = smoke("llama3.2-1b")
    jp = jax.tree.map(jnp.asarray, convert.to_numpy(
        tm.init_params(ct, 0, device="cpu")))
    js = jadamw.init(jp)
    fn = jsteps.make_train_step(cj, jadamw.OptConfig(**OPT))
    compiled, out = None, []
    for s in range(n):
        batch = {k: jnp.asarray(v.numpy()) for k, v in
                 make_batch(ct, seed=s).items()}
        compiled = compiled or jax.jit(fn).lower(jp, js, batch).compile(
            compiler_options={"xla_allow_excess_precision": False})
        jp, js, m = compiled(jp, js, batch)
        flat = jax.tree_util.tree_flatten_with_path(jp)[0]
        out.append(((float(m["loss"]), float(m["grad_norm"])),
                    {"/".join(str(getattr(k, "key", k)) for k in path):
                     np.asarray(leaf) for path, leaf in flat}))
    return out


@pytest.fixture(scope="module")
def ranks():
    """One run of the 4 gloo ranks, with the JAX one-device llama steps
    and the port's one-device runs computed meanwhile."""
    box: dict = {}
    tmp = tempfile.TemporaryDirectory(prefix="repro_torch_lm_sharding_")
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
        box["port"] = {name: one_device(name) for name, *_ in CASES}
        box["jax"] = jax_llama_steps(2)
    finally:
        worker.join(timeout=500)
    assert not worker.is_alive()
    if "error" in box:
        raise box["error"]
    box["ranks"] = []
    for r in range(N_RANKS):
        with open(Path(out) / f"rank{r}.json") as fh:
            box["ranks"].append(json.load(fh))
    box["npz"] = {name: dict(np.load(Path(out) / f"{name}.npz"))
                  for name, *_ in CASES}
    box["blocks"] = [dict(np.load(Path(out) / f"blocks{r}.npz"))
                     for r in range(N_RANKS)]
    box["dir"] = out
    yield box
    tmp.cleanup()


def _hold_leaves(cfg, got: dict, want: dict, init: dict, grads: dict):
    """Every leaf after one step within LEAF_RTOL relative L2, but a noise
    leaf within 2 lr and a leaf initialised at zero entry by entry: an
    entry off the one-device step by more than LEAF_RTOL lr must have a
    one-device gradient under LEAF_RTOL of its leaf's gradient norm (the
    entries whose sign the gradient's tolerance lets rounding flip)."""
    assert set(got) == set(want)
    lr = float(adamw.schedule(adamw.OptConfig(**OPT), torch.tensor(1.0)))
    for path, w in want.items():
        g = got[path]
        if zero_grad_leaf(cfg, path):
            assert np.abs(g - w).max() <= 2.02 * lr, path
        elif not np.any(init[path]):
            off = np.abs(g - w) > LEAF_RTOL * lr
            small = (np.abs(grads[path])
                     <= LEAF_RTOL * np.linalg.norm(grads[path]))
            assert np.all(small[off]), (path, int(off.sum()))
        else:
            assert rel(g, w) < LEAF_RTOL, (path, rel(g, w))


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_sharded_step_matches_one_device(ranks, name):
    """Loss and grad norm at every step on every rank, every gradient
    leaf, and every updated leaf against the port's one-device run."""
    cfg, n = case_config(name)
    held = next(c[4] for c in CASES if c[0] == name)
    want = ranks["port"][name]
    for r in ranks["ranks"]:
        assert len(r[name]["hist"]) == n
        for (gl, gn), (wl, wn) in zip(r[name]["hist"], want["hist"]):
            np.testing.assert_allclose(gl, wl, rtol=LOSS_RTOL)
            np.testing.assert_allclose(gn, wn, rtol=NORM_RTOL)
        assert r[name]["moments_placed"]
    if held == "norms":
        return
    npz = ranks["npz"][name]
    norm = math.sqrt(sum(float(np.sum(np.square(g, dtype=np.float64)))
                         for g in want["grads"].values()))
    for path, w in want["grads"].items():
        g = npz[f"grad/{path}"]
        if zero_grad_leaf(cfg, path):
            assert np.linalg.norm(g) < 1e-4 * norm, path
            continue
        assert rel(g, w) < LEAF_RTOL, (path, rel(g, w))
    got = {k[len("leaf/"):]: v for k, v in npz.items()
           if k.startswith("leaf/")}
    if name.startswith("llama"):
        assert all(np.any(a) for a in want["init"].values())
    if n == 1:
        _hold_leaves(cfg, got, want["leaves"], want["init"], want["grads"])
    else:
        for path, w in want["leaves"].items():
            assert rel(got[path], w) < LEAF_RTOL, (path, rel(got[path], w))


@pytest.mark.parametrize("name, steps_", [("llama-2d", 2),
                                          ("llama-fsdp", 1)])
def test_sharded_llama_matches_jax_one_device(ranks, name, steps_):
    """The sharded step under both profiles against the reference's
    one-device step on the same weights and batches."""
    cfg, _ = case_config(name)
    for r in ranks["ranks"]:
        for (gl, gn), ((wl, wn), _) in zip(r[name]["hist"],
                                           ranks["jax"][:steps_]):
            np.testing.assert_allclose(gl, wl, rtol=LOSS_RTOL)
            np.testing.assert_allclose(gn, wn, rtol=NORM_RTOL)
    want = ranks["jax"][steps_ - 1][1]
    got = {k[len("leaf/"):]: v for k, v in ranks["npz"][name].items()
           if k.startswith("leaf/")}
    for path, w in want.items():
        assert rel(got[path], w) < LEAF_RTOL, (path, rel(got[path], w))


def test_remat_under_dtensor_gives_the_same_values(ranks):
    """``cfg.remat`` recomputes each unit under DTensor: the same loss and
    leaves as the sharded run without it."""
    a, b = ranks["ranks"][0]["llama-2d"], ranks["ranks"][0]["llama-remat"]
    assert a["hist"][0] == b["hist"][0]
    for k, v in ranks["npz"]["llama-2d"].items():
        if k.startswith("grad/"):
            np.testing.assert_array_equal(ranks["npz"]["llama-remat"][k], v)


@pytest.mark.parametrize("name", ["llama-2d", "llama-fsdp"])
def test_constrain_sites_place_activations(ranks, jsh, name):
    """The three sites in order (the embedding, each unit's block, the
    logits), each leaving the placements of the reference's spec."""
    cfg, _ = case_config(name)
    jmesh = jsh["AbstractMesh"]((2, 2), ("data", "model"))
    rules = jsh["sharding"].RULE_PROFILES[cfg.sharding_profile]
    act = (B, S, cfg.d_model)
    sites = ([("batch", None, None)] * (1 + cfg.n_layers)
             + [("batch", None, "vocab")])
    for r in ranks["ranks"]:
        log = r[name]["constrain"]
        assert [tuple(a) for a, _ in log] == sites
        for (axes, placed), site in zip(log, sites):
            shape = act if site[2] is None else (B, S, cfg.padded_vocab)
            spec = tuple(jsh["sharding"].spec_for(site, shape, jmesh, rules))
            assert placed == [repr(p) for p in ts.NamedSharding(
                bare((2, 2), ("data", "model")), spec).placements]
    if cfg.sharding_profile == "2d":
        assert log[0][1] == ["Shard(dim=0)", "Replicate()"]
        assert log[-1][1] == ["Shard(dim=0)", "Shard(dim=2)"]
    else:
        assert log[-1][1] == ["Shard(dim=0)", "Shard(dim=0)"]


def test_parameters_keep_their_rule_placements(ranks):
    """After the steps each leaf still has the placements its rules give
    (the updates run in place on the shards)."""
    for name in ("llama-2d", "llama-fsdp", "olmoe", "mamba2"):
        cfg, _ = case_config(name)
        want = ts.shardings_for(tm.param_axes(cfg), tm.abstract_params(cfg),
                                bare((2, 2), ("data", "model")),
                                ts.RULE_PROFILES[cfg.sharding_profile])
        for r in ranks["ranks"]:
            for path, ns in leaves(want):
                assert r[name]["placements"][path] == [
                    repr(p) for p in ns.placements], (name, path)


def test_elastic_restore_onto_mesh_small_tree(ranks):
    """The reference's ``{"w", "b"}`` case: each rank's local block is
    the saved array's block at its coordinate, bit for bit."""
    full = {"w": np.arange(64.0, dtype=np.float32).reshape(8, 8),
            "b": np.ones(4, np.float32)}
    for r, blocks in zip(ranks["ranks"], ranks["blocks"]):
        info = r["restore"]
        assert info["steps"] == [3, 4]
        assert info["placements"]["small/w"] == ["Shard(dim=0)",
                                                 "Shard(dim=1)"]
        assert info["placements"]["small/b"] == ["Replicate()"] * 2
        for k, a in full.items():
            want = block_of(a, info["placements"][f"small/{k}"],
                            r["coord"], (2, 2))
            np.testing.assert_array_equal(blocks[f"small/{k}"], want)
    # Four distinct blocks of w.
    assert len({blocks["small/w"].tobytes()
                for blocks in ranks["blocks"]}) == 4


def test_elastic_restore_onto_mesh_model_tree(ranks):
    """A model tree: every leaf's local block on every rank bit for bit;
    the sharded tree saved back restores without a mesh, equal."""
    cfg = smoke("llama3.2-1b")
    full = dict(leaves(convert.to_numpy(tm.init_params(cfg, 1,
                                                       device="cpu"))))
    for r, blocks in zip(ranks["ranks"], ranks["blocks"]):
        info = r["restore"]
        assert info["roundtrip"] and not info["trainable"]
        for path, a in full.items():
            placed = info["placements"][f"model/{path}"]
            want = block_of(a, placed, r["coord"], (2, 2))
            np.testing.assert_array_equal(blocks[f"model/{path}"], want,
                                          err_msg=path)


# -- chip_smoke.py's phase 14, rehearsed on the CPU ---------------------------

def load_chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_phase14_rehearsal(tmp_path):
    """The phase on threaded CPU ranks at smoke size, its "2d" profile (the
    "fsdp" run is the same code on other rules; the gloo ranks above
    hold both), (z3)'s prompts cut to 32 tokens: its checks pass and it
    reports its numbers."""
    cs = load_chip_smoke()
    cs.ROOT = tmp_path
    cs.SERVE_S, cs.SERVE_MAX = 32, 64
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = cs.lm_sharding_phase(device="cpu", smoke=True,
                                   profiles=("2d",))
    assert out["z1"]["2d"]["steps"] == 2
    assert out["z1"]["2d"]["comm"]["counts"]
    assert "fsdp" not in out["z1"]
    assert out["z2"]["leaves"] > 0
    assert not (tmp_path / "build" / "sharded_ckpt").exists()
    # (z3) and (z4), the dry run of (z1)'s step and (z3)'s decode step
    # holding its collectives to CommDebugMode's.
    assert out["z3"]["llama"]["worst_rel"] <= cs.SERVE_RTOL
    assert set(out["z4"]) == {"z1 2d train", "z3 decode", "wall_s"}


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _worker(sys.argv[2])
