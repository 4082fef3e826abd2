"""The embedding lookup on a ``(data, model)`` mesh in the PyTorch port
(``layers.embed_lookup``), against one device, the JAX package's one-device
steps and the reference's compiled collectives.

One spawn of 4 gloo ranks (``launch.cluster``'s worker helpers, this file
with ``--worker DIR``) runs:

* (a) ``embed_lookup`` alone on 2x2 ``"2d"``, 1x4 ``"2d"`` (no embed
  shard), 4x1 ``"2d"`` (no vocab shard), 2x2 ``"fsdp"`` and 2x2 with an
  odd vocab (replicated), the table and the tokens placed by the rules
  and ``batch_specs``: the forward equals one device's
  ``F.embedding(...).to(bf16)`` bit for bit and is placed as
  ``constrain(x, ("batch", None, None))`` places it; for a seeded
  upstream gradient each rank's block of the table's gradient is within
  1e-6 relative L2 of one device's block and equal in the rows of tokens
  that occur once; the forward issues no float all-gather, and no
  collective of the forward or the backward takes the table's block.
* (b) llama3.2-1b smoke under ``"2d"`` and ``"fsdp"`` on 2x2: a forward,
  one train step and a prefill and a decode against the JAX package's
  one-device ``forward``, ``make_train_step``, ``make_prefill_step`` and
  ``make_decode_step`` on the same weights (``convert.to_numpy``), at
  ``test_torch_lm_sharding.py``'s gates (logits 1e-3 relative L2 against
  the reference compiled with every bf16 rounding kept, serving logits
  ``test_torch_lm_sharded_serving.py``'s 3e-2; loss 1e-3, gradient norm
  1e-2, every updated leaf 3e-2); in those calls the lookup's collectives
  take no block of the table and gather only the integer tokens.
* (c) The lookup's collectives, forward and backward, on 2x2 with the
  tokens placed as the reference's (``P("data", None)`` under ``"2d"``,
  ``P(("data", "model"), None)`` under ``"fsdp"``), against the HLO
  that the reference's ``jnp.take`` plus ``with_sharding_constraint``
  compiles to on 4 forced host devices (a subprocess): the same kinds, in
  the same order, over the same mesh dims, integer where the reference's
  is.  The reference gathers the tokens under ``"2d"`` by a
  collective-permute and an all-gather over the other dim, which together
  gather over ``data``; its gradient program recomputes the token
  gather, so the backward is held by its float collectives.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
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
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.distributed import context as dc
from repro_torch.distributed import sharding as ts
from repro_torch.launch import cluster
from repro_torch.launch import mesh as tmesh
from repro_torch.models import layers
from repro_torch.models import model as tm
from repro_torch.models.spec import leaves
from repro_torch.optim import adamw
from repro_torch.runtime import steps

N_RANKS = 4
GRAD_RTOL = 1e-6
LOGIT_RTOL, LOSS_RTOL, NORM_RTOL, LEAF_RTOL = 1e-3, 1e-3, 1e-2, 3e-2
SERVE_RTOL = SERVE_ATOL = 3e-2
OPT = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=10)

# (a): (name, profile, (data, model), vocab); the table is (V, D_A).
LAYOUTS = [
    ("2d-2x2", "2d", (2, 2), 64),
    ("2d-1x4", "2d", (1, 4), 64),
    ("2d-4x1", "2d", (4, 1), 64),
    ("fsdp-2x2", "fsdp", (2, 2), 64),
    ("odd-vocab-2x2", "2d", (2, 2), 63),
]
A_NAMES = [c[0] for c in LAYOUTS]
B_A, S_A, D_A = 8, 6, 16
# (b): llama smoke, 8 rows of 16 tokens, a cache of 24 positions.
PROFILES = ("2d", "fsdp")
B, S, SMAX = 8, 16, 24
# (c): the tokens' placement under each profile, as the reference's.
REF_TOKENS = {"2d": ("data", None), "fsdp": (("data", "model"), None)}
V_C = 4096
KIND = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
        "all_to_all_single": "all-to-all",
        "reduce_scatter_tensor": "reduce-scatter"}


def layout(name):
    _, profile, shape, V = next(c for c in LAYOUTS if c[0] == name)
    return profile, shape, V


def layout_inputs(V, seed=0):
    """The table (V, D_A) f32, tokens (B_A, S_A) int32 and an upstream
    gradient (B_A, S_A, D_A) bf16, from a seed."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, D_A)).astype(np.float32)
    tokens = rng.integers(0, V, (B_A, S_A)).astype(np.int32)
    grad = rng.standard_normal((B_A, S_A, D_A)).astype(np.float32)
    return (torch.from_numpy(table), torch.from_numpy(tokens),
            torch.from_numpy(grad).bfloat16())


def one_device_lookup(V):
    """One device's lookup and the table's gradient for the upstream
    gradient."""
    table, tokens, grad = layout_inputs(V)
    table.requires_grad_(True)
    x = torch.nn.functional.embedding(tokens.long(), table).to(torch.bfloat16)
    x.backward(grad)
    return x.detach(), table.grad


def llama(profile):
    return dataclasses.replace(tget("llama3.2-1b", smoke=True),
                               sharding_profile=profile)


def make_batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[:, :2] = -1
    return {"tokens": torch.from_numpy(tokens),
            "labels": torch.from_numpy(labels)}


def serve_inputs(cfg):
    """A prompt of S - 4 tokens and one decode token a row."""
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab, (B, S - 4)).astype(np.int32)
    tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    return prompt, tok


def full(t):
    return t.full_tensor() if dc.is_dtensor(t) else t


class Collectives(TorchDispatchMode):
    """The functional collectives one rank issues: [kind, mesh dim name,
    float, input shape, phase], DTensor-level calls left to DTensor."""

    def __init__(self, mesh):
        super().__init__()
        self.dims = {mesh.get_group(i).group_name: n
                     for i, n in enumerate(mesh.mesh_dim_names)}
        self.log = []
        self.phase = "forward"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        name = func.__name__.split(".")[0]
        if func.namespace == "_c10d_functional" and name in KIND:
            group = [a for a in args if isinstance(a, str)][-1]
            self.log.append([KIND[name], self.dims.get(group),
                             bool(args[0].dtype.is_floating_point),
                             list(args[0].shape), self.phase])
        return func(*args, **(kwargs or {}))


def run_layout(name, mesh, rules, token_spec=None):
    """``embed_lookup`` on ``mesh`` and its gradient for the seeded
    upstream gradient: (forward whole, this rank's block of the table's
    gradient, whether the output is placed as ``constrain`` places it,
    the collectives, the table block's shape)."""
    _, _, V = layout(name) if name in A_NAMES else (None, None, V_C)
    table, tokens, grad = layout_inputs(V)
    sh = ts.NamedSharding(mesh, ts.spec_for(("vocab", "embed"), (V, D_A),
                                            mesh, rules))
    embed = ts.distribute(table, sh).requires_grad_(True)
    tok_sh = (ts.NamedSharding(mesh, token_spec) if token_spec else
              ts.batch_specs({"tokens": tokens}, mesh)["tokens"])
    tokens = ts.distribute(tokens, tok_sh)
    mode = Collectives(mesh)
    with dc.activation_sharding(mesh, rules):
        with mode:
            x = layers.embed_lookup(embed, tokens)
        placed = (list(x.placements)
                  == list(dc.constrain(x, ("batch", None, None)).placements))
        g = ts.distribute(grad, ts.NamedSharding(mesh, ())).redistribute(
            mesh, x.placements)
        mode.phase = "backward"
        with mode:
            gr, = torch.autograd.grad(x, embed, g)
            gr = gr.redistribute(mesh, embed.placements)
    return (full(x).detach().float().numpy(), gr.to_local().numpy(), placed,
            mode.log, list(embed.to_local().shape), sh)


def run_llama(profile, mesh=None, record=None):
    """llama smoke under ``profile``: a forward's logits, one train step's
    (loss, norm) and leaves, a prefill's and a decode's logits;
    ``record`` (a dispatch mode) active over the model's calls."""
    cfg = llama(profile)
    rules = ts.RULE_PROFILES[profile]
    lm = tm.init_params(cfg, 0, device="cpu", trainable=True)
    batch = make_batch(cfg)
    ctx = contextlib.nullcontext()
    placed = batch
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
        prompt, tok = serve_inputs(cfg)
        caches = tm.init_cache(cfg, B, SMAX, device="cpu", mesh=mesh)
        with rec:
            lg, caches = steps.make_prefill_step(cfg)(
                lm, {"tokens": prompt, "caches": caches})
            lg2, caches = steps.make_decode_step(cfg)(
                lm, {"tokens": tok, "cache_index": S - 4, "caches": caches})
        out["serve"] = [full(lg).float().numpy(), full(lg2).float().numpy()]
        step = steps.make_train_step(cfg, adamw.OptConfig(**OPT))
        st = adamw.init(lm)
        with rec:
            new, _, m = step(lm, st, batch)
        out["hist"] = (float(m["loss"]), float(m["grad_norm"]))
        out["leaves"] = dict(leaves(convert.to_numpy(new)))
    return out, lm


def _worker(out_dir: str) -> None:
    """One gloo rank: (a) on each layout, (c) on 2x2, (b) on 2x2."""
    torch.manual_seed(0)
    cluster.initialize(backend="gloo", device="cpu")
    rank = torch.distributed.get_rank()
    out = Path(out_dir)
    summary = {}
    meshes = {}
    for name, profile, shape, _ in LAYOUTS:
        if shape not in meshes:
            meshes[shape] = tmesh.make_debug_mesh(*shape, device_type="cpu")
        mesh = meshes[shape]
        x, grad, placed, log, block, sh = run_layout(
            name, mesh, ts.RULE_PROFILES[profile])
        rows = ts.local_slices((layout(name)[2], D_A), sh)
        summary[name] = {"placed": placed, "collectives": log,
                         "block": block,
                         "rows": [rows[0].start, rows[0].stop],
                         "cols": [rows[1].start, rows[1].stop]}
        np.savez(out / f"a-{name}.rank{rank}.npz", x=x, grad=grad)
    mesh = meshes[(2, 2)]
    for profile in PROFILES:
        *_, log, block, _ = run_layout(
            f"ref-{profile}", mesh, ts.RULE_PROFILES[profile],
            REF_TOKENS[profile])
        summary[f"c-{profile}"] = {"collectives": log, "block": block}
    inner = layers.embed_lookup
    for profile in PROFILES:
        mode = Collectives(mesh)

        def lookup(embed, tokens, _mode=mode):
            _mode.phase = "lookup"
            try:
                return inner(embed, tokens)
            finally:
                _mode.phase = "model"
        layers.embed_lookup = lookup
        try:
            res, lm = run_llama(profile, mesh, record=mode)
        finally:
            layers.embed_lookup = inner
        summary[f"b-{profile}"] = {
            "hist": res["hist"], "collectives": mode.log,
            "embed_block": list(lm.params["embed"].to_local().shape)}
        if rank == 0:
            np.savez(out / f"b-{profile}.npz", logits=res["logits"],
                     **{f"serve/{i}": a for i, a in enumerate(res["serve"])},
                     **{f"leaf/{p}": a for p, a in res["leaves"].items()})
    with open(out / f"rank{rank}.json", "w") as fh:
        json.dump(summary, fh)
    cluster.shutdown()


def jax_llama(profile):
    """The JAX package's one-device forward, train step, prefill and decode
    (compiled with every bf16 rounding kept) on the port's initial llama
    weights and the same inputs."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import model as jmodel
    from repro.optim import adamw as jadamw
    from repro.runtime import steps as jsteps
    cj = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                             sharding_profile=profile)
    jp = jax.tree.map(jnp.asarray, convert.to_numpy(
        tm.init_params(llama(profile), 0, device="cpu")))
    opts = {"xla_allow_excess_precision": False}

    def run(fn, *args):
        return jax.jit(fn).lower(*args).compile(compiler_options=opts)(*args)
    batch = {k: jnp.asarray(v.numpy()) for k, v in
             make_batch(llama(profile)).items()}
    logits = run(lambda p, t: jmodel.forward(cj, p, {"tokens": t})[0], jp,
                 batch["tokens"])
    prompt, tok = serve_inputs(cj)
    b = {"tokens": jnp.asarray(prompt),
         "caches": jmodel.init_cache(cj, B, SMAX)}
    lg, caches = run(jsteps.make_prefill_step(cj), jp, b)
    b = {"tokens": jnp.asarray(tok), "caches": caches,
         "cache_index": jnp.asarray(S - 4, jnp.int32)}
    lg2, _ = run(jsteps.make_decode_step(cj), jp, b)
    js = jadamw.init(jp)
    jp, js, m = run(jsteps.make_train_step(cj, jadamw.OptConfig(**OPT)), jp,
                    js, batch)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    return {"logits": np.asarray(logits, np.float32),
            "serve": [np.asarray(lg, np.float32), np.asarray(lg2,
                                                            np.float32)],
            "hist": (float(m["loss"]), float(m["grad_norm"])),
            "leaves": {"/".join(str(getattr(k, "key", k)) for k in path):
                       np.asarray(leaf) for path, leaf in flat}}


# The reference's lookup compiled on 4 forced host devices, a (data=2,
# model=2) mesh: its collectives, forward and gradient, as JSON lines
# [kind, mesh dims, integer payload] (a permute folded into the gather it
# feeds: the groups of its sources).
REF_SCRIPT = r"""
import json, re, sys
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
V, D, B, S = (int(a) for a in sys.argv[1:5])
devs = np.array(jax.devices()).reshape(2, 2)
mesh = Mesh(devs, ("data", "model"))
coord = {int(d.id): (i, j) for (i, j), d in np.ndenumerate(devs)}
tok = {"2d": P("data", None), "fsdp": P(("data", "model"), None)}
xs = {"2d": P("data", None, None), "fsdp": P(("data", "model"), None, None)}
table = {"2d": P("model", "data"), "fsdp": P("model", None)}
KINDS = ("all-gather", "all-reduce", "all-to-all", "reduce-scatter",
         "collective-permute")
def groups(line):
    m = re.search(r"replica_groups=\[([\d,]+)\]<=\[([\d,]+)\](?:T\(([\d,]+)\))?",
                  line)
    if m:
        shape = [int(a) for a in m.group(1).split(",")]
        ids = np.arange(int(np.prod([int(a) for a in m.group(2).split(",")])))
        ids = ids.reshape([int(a) for a in m.group(2).split(",")])
        if m.group(3):
            ids = ids.transpose([int(a) for a in m.group(3).split(",")])
        return ids.reshape(shape).tolist()
    m = re.search(r"replica_groups=\{(\{[\d,]*\}(?:,\{[\d,]*\})*)\}", line)
    return [[int(a) for a in g.split(",")] for g in
            re.findall(r"\{([\d,]*)\}", m.group(1))]
def dims(gs):
    out = set()
    for g in gs:
        for k, name in enumerate(("data", "model")):
            if len({coord[d][k] for d in g}) > 1:
                out.add(name)
    return sorted(out)
def collectives(txt):
    seq, perms = [], {}
    for line in txt.splitlines():
        m = re.match(r"\s*(?:ROOT )?(%[\w.-]+) = (\(?[a-z0-9]+)\[.*? "
                     r"([a-z-]+?)(?:-start)?\((%[\w.-]+)", line)
        if not m or m.group(3) not in KINDS:
            continue
        out, dtype, kind, arg = m.groups()
        integer = dtype.lstrip("(").startswith(("s", "u"))
        if kind == "collective-permute":
            pairs = re.search(r"source_target_pairs=\{(.*?)\}\}", line)
            src = {int(t): int(s) for s, t in re.findall(
                r"\{(\d+),(\d+)", pairs.group(1) + "}")}
            perms[out] = src
            continue
        gs = groups(line)
        if arg in perms:
            gs = [[perms[arg][d] for d in g] for g in gs]
            perms.pop(arg)
        seq.append([kind, dims(gs), integer])
    seq += [["collective-permute", [], None] for _ in perms]
    return seq
res = {}
for prof in ("2d", "fsdp"):
    ts_, ks, xs_ = (NamedSharding(mesh, s[prof]) for s in (table, tok, xs))
    def f(t, k):
        x = jnp.take(t, k, axis=0).astype(jnp.bfloat16)
        return jax.lax.with_sharding_constraint(x, xs_)
    def g(t, k, ct):
        return jax.vjp(lambda t_: f(t_, k), t)[1](ct)[0]
    t = jax.ShapeDtypeStruct((V, D), jnp.float32, sharding=ts_)
    k = jax.ShapeDtypeStruct((B, S), jnp.int32, sharding=ks)
    ct = jax.ShapeDtypeStruct((B, S, D), jnp.bfloat16, sharding=xs_)
    fwd = jax.jit(f, out_shardings=xs_).lower(t, k).compile().as_text()
    bwd = jax.jit(g, out_shardings=ts_).lower(t, k, ct).compile().as_text()
    res[prof] = {"forward": collectives(fwd), "backward": collectives(bwd)}
print(json.dumps(res))
"""


def reference_collectives():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    return subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(V_C), str(D_A), str(B_A),
         str(S_A)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


@pytest.fixture(scope="module")
def ranks():
    """One run of the 4 gloo ranks, with one device's lookups, the JAX
    package's one-device llama calls and the reference's compiled
    collectives computed meanwhile."""
    box: dict = {}
    tmp = tempfile.TemporaryDirectory(prefix="repro_torch_embed_parallel_")
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
    ref = reference_collectives()
    worker = threading.Thread(target=spawn)
    worker.start()
    try:
        box["one"] = {name: one_device_lookup(layout(name)[2])
                      for name in A_NAMES}
        box["jax"] = {p: jax_llama(p) for p in PROFILES}
    finally:
        worker.join(timeout=500)
        stdout, stderr = ref.communicate(timeout=300)
    assert not worker.is_alive()
    if "error" in box:
        raise box["error"]
    assert ref.returncode == 0, stderr[-3000:]
    box["ref"] = json.loads(stdout.strip().splitlines()[-1])
    box["ranks"] = []
    for r in range(N_RANKS):
        with open(Path(out) / f"rank{r}.json") as fh:
            box["ranks"].append(json.load(fh))
    box["a"] = {name: [dict(np.load(Path(out) / f"a-{name}.rank{r}.npz"))
                       for r in range(N_RANKS)] for name in A_NAMES}
    box["b"] = {p: dict(np.load(Path(out) / f"b-{p}.npz"))
                for p in PROFILES}
    yield box
    tmp.cleanup()


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("name", A_NAMES)
def test_lookup_is_one_devices_bit_for_bit(ranks, name):
    want, _ = ranks["one"][name]
    for npz in ranks["a"][name]:
        got = torch.from_numpy(npz["x"]).bfloat16()
        assert got.shape == want.shape
        assert torch.equal(got, want), name


@pytest.mark.parametrize("name", A_NAMES)
def test_lookup_is_placed_as_constrain_places_it(ranks, name):
    assert all(r[name]["placed"] for r in ranks["ranks"]), name


@pytest.mark.parametrize("name", A_NAMES)
def test_table_gradient_lands_in_each_block(ranks, name):
    """Each rank's block of the table's gradient within GRAD_RTOL of one
    device's block, and equal in the rows of tokens that occur once."""
    _, V = layout(name)[1:]
    _, tokens, _ = layout_inputs(V)
    once = np.bincount(tokens.numpy().ravel(), minlength=V) == 1
    _, want = ranks["one"][name]
    want = want.numpy()
    for r, npz in zip(ranks["ranks"], ranks["a"][name]):
        r0, r1 = r[name]["rows"]
        c0, c1 = r[name]["cols"]
        block = want[r0:r1, c0:c1]
        got = npz["grad"]
        assert got.shape == block.shape
        assert rel(got, block) <= GRAD_RTOL, (name, rel(got, block))
        np.testing.assert_array_equal(got[once[r0:r1]], block[once[r0:r1]])


@pytest.mark.parametrize("name", A_NAMES)
def test_no_float_all_gather_and_no_table_block_moved(ranks, name):
    """The forward gathers only the integer tokens; no collective of the
    forward or the backward takes the table's block (the reduction of a
    gradient partial over ``data`` under ``"fsdp"`` takes the block's
    gradient, a partial sum, not the table)."""
    profile, (nd, nm), V = layout(name)
    for r in ranks["ranks"]:
        log = r[name]["collectives"]
        block = r[name]["block"]
        fwd = [c for c in log if c[4] == "forward"]
        assert not [c for c in fwd if c[0] == "all-gather" and c[2]], (
            name, fwd)
        assert not [c for c in log if c[0] == "all-gather"
                    and c[3] == block], (name, log)
        kinds = {c[0] for c in fwd if c[2]}
        want = set()
        if V % nm == 0 and nm > 1:
            want.add("all-reduce")
        if profile == "2d" and nd > 1 and D_A % nd == 0:
            want.add("all-to-all")
        assert kinds == want, (name, kinds, want)


def test_odd_vocab_replicates_and_masks_nothing(ranks):
    """V % model != 0: the vocab replicates, so each rank holds every row
    of its embed block and sums nothing over ``model``."""
    for r in ranks["ranks"]:
        assert r["odd-vocab-2x2"]["block"] == [63, D_A // 2]
        assert r["2d-2x2"]["block"] == [32, D_A // 2]
        assert r["fsdp-2x2"]["block"] == [32, D_A]


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("phase", ["forward", "backward"])
def test_collectives_match_the_reference_hlo(ranks, profile, phase):
    """The lookup's collectives on 2x2, the tokens placed as the
    reference's, against the reference's compiled program: kind, mesh
    dims and integer payload in order (the backward by its float
    collectives: the reference's gradient program recomputes the token
    gather)."""
    ref = [[k, d, bool(i)] for k, d, i in ranks["ref"][profile][phase]]
    if phase == "backward":
        ref = [c for c in ref if not c[2]]
    for r in ranks["ranks"]:
        got = [[k, [d], not f] for k, d, f, _, ph in
               r[f"c-{profile}"]["collectives"] if ph == phase]
        if phase == "backward":
            got = [c for c in got if not c[2]]
        assert got == ref, (profile, phase, got, ref)


def test_reference_sequences_are_the_issued_ones(ranks):
    """The reference's forward under "2d": the integer tokens over data,
    the rows' sum over model, the embed shard to the batch shard over
    data; under "fsdp": the tokens over model and the sum over model."""
    assert ranks["ref"]["2d"]["forward"] == [
        ["all-gather", ["data"], True], ["all-reduce", ["model"], False],
        ["all-to-all", ["data"], False]]
    assert ranks["ref"]["fsdp"]["forward"] == [
        ["all-gather", ["model"], True], ["all-reduce", ["model"], False]]


@pytest.mark.parametrize("profile", PROFILES)
def test_llama_matches_jax_one_device(ranks, profile):
    """The forward's logits, the prefill's and the decode's, and one
    train step (loss and norm on every rank, every updated leaf) against
    the JAX package's one-device calls on the same weights."""
    ref, npz = ranks["jax"][profile], ranks["b"][profile]
    assert npz["logits"].shape == ref["logits"].shape
    assert rel(npz["logits"], ref["logits"]) <= LOGIT_RTOL, (
        profile, rel(npz["logits"], ref["logits"]))
    for i, want in enumerate(ref["serve"]):
        np.testing.assert_allclose(npz[f"serve/{i}"], want, rtol=SERVE_RTOL,
                                   atol=SERVE_ATOL)
    wl, wn = ref["hist"]
    for r in ranks["ranks"]:
        gl, gn = r[f"b-{profile}"]["hist"]
        np.testing.assert_allclose(gl, wl, rtol=LOSS_RTOL)
        np.testing.assert_allclose(gn, wn, rtol=NORM_RTOL)
    got = {k[len("leaf/"):]: v for k, v in npz.items()
           if k.startswith("leaf/")}
    assert set(got) == set(ref["leaves"])
    for path, w in ref["leaves"].items():
        assert rel(got[path], w) < LEAF_RTOL, (path, rel(got[path], w))


@pytest.mark.parametrize("profile", PROFILES)
def test_llama_lookup_gathers_only_tokens(ranks, profile):
    """In the forward, the serving calls and the train step, the lookup's
    collectives take no block of the table and gather only the integer
    tokens, and its rows are summed over ``model``.  (The tied head
    gathers the table as the reference's einsum does: over ``data`` under
    "2d", over every dim that splits the batch under "fsdp".)"""
    for r in ranks["ranks"]:
        res = r[f"b-{profile}"]
        block = res["embed_block"]
        log = [c for c in res["collectives"] if c[4] == "lookup"]
        assert log, profile
        assert not [c for c in log if c[3] == block], (profile, log)
        gathers = [c for c in log if c[0] == "all-gather"]
        assert gathers and not [c for c in gathers if c[2]], gathers
        assert ["all-reduce", "model", True] in [c[:3] for c in log], log


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _worker(sys.argv[2])
