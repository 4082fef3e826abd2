"""Expert parallelism and query-head sharding on a ``(data, model)`` mesh in
the PyTorch port, against the port's one-device runs.

One spawn of 4 gloo ranks (``launch.cluster``'s worker helpers, this file
with ``--worker DIR``) runs ``CASES`` on CPU meshes:

* olmoe and moonshot smoke (8 experts, capacity 4.0: no drops) under the
  ``"2d"`` rules on a 2x2 mesh (each rank of a data group routes the same
  tokens, fills only its experts' buffer slots and sums its f32 partial
  combine across ``model``) and under ``"fsdp"`` on 2x2 and 1x4 (each
  rank routes its own rows and exchanges buffers with the experts'
  owners by all-to-all over ``model``): a forward's logits within 1e-3
  relative L2 of one device's, one train step's loss within 1e-3 and
  gradient norm within 1e-2, every gradient leaf and updated leaf within
  3e-2 relative L2 (a leaf initialised at zero entry by entry, as
  ``test_torch_lm_sharding.py`` holds it); each rank's expert leaves
  local blocks of E/m experts and every expert call on such a block; no
  all-gather over ``model`` of an expert leaf's block; under "fsdp" four
  all-to-alls a MoE layer a step (two forward, two back) and none under
  "2d".  olmoe's one-device loss, and its loss, gradient norm and
  updated leaves on the mesh under both profiles, are also held to the
  JAX package's one-device ``make_train_step`` on the same weights and
  batch, at the same gates.
* llama smoke (4 query heads over 2 KV heads) on 1x4 and recurrentgemma
  smoke (4 over 1, MQA local attention) on 2x2 under "2d": a prefill, a
  scalar and a per-row decode (logits within 1e-3 relative L2; 5e-3 for
  recurrentgemma, whose tensor-parallel MLP sums f32 partials in another
  order, carried by the recurrence, as ``test_torch_lm_sharded_serving``
  holds it) and a train step as above; each rank's attention core (the
  cacheless cores, the prefill and the decode core) sees H/m query heads
  and one KV head.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
import tempfile
import threading
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

B, S, SMAX = 8, 16, 32
N_RANKS = 4
LOGIT_RTOL, LOSS_RTOL, NORM_RTOL, LEAF_RTOL = 1e-3, 1e-3, 1e-2, 3e-2
FAMILY_RTOL = {"recurrentgemma": 5e-3}
OPT = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=10)
ROW_INDEX = np.array([S + 2, S + 5, S + 2, S + 3, S + 4, S + 2, S + 6,
                      S + 3])

# (name, arch, profile, (data, model)).
CASES = [
    ("olmoe-2d-2x2", "olmoe-1b-7b", "2d", (2, 2)),
    ("olmoe-fsdp-2x2", "olmoe-1b-7b", "fsdp", (2, 2)),
    ("olmoe-fsdp-1x4", "olmoe-1b-7b", "fsdp", (1, 4)),
    ("moonshot-2d-2x2", "moonshot-v1-16b-a3b", "2d", (2, 2)),
    ("moonshot-fsdp-2x2", "moonshot-v1-16b-a3b", "fsdp", (2, 2)),
    ("moonshot-fsdp-1x4", "moonshot-v1-16b-a3b", "fsdp", (1, 4)),
    ("llama-2d-1x4", "llama3.2-1b", "2d", (1, 4)),
    ("recurrentgemma-2d-2x2", "recurrentgemma-9b", "2d", (2, 2)),
]
MOE = [c[0] for c in CASES if c[1] != "llama3.2-1b"
       and c[1] != "recurrentgemma-9b"]
ATTN = [c[0] for c in CASES if c[0] not in MOE]
EXPERT_LEAVES = ("wg", "wu", "wd")


def case(name):
    _, arch, profile, shape = next(c for c in CASES if c[0] == name)
    cfg = dataclasses.replace(tget(arch, smoke=True),
                              sharding_profile=profile)
    return cfg, shape


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


def run_case(name, mesh=None, record=None):
    """One case on ``mesh`` (None: one device): a forward's logits, for
    the attention cases the serving calls' logits, then the gradients
    and one train step's (loss, norm) and updated leaves (the step
    updates the parameters in place, so it comes last).  ``record`` (a
    dispatch mode) is active over those calls, not over the gathers that
    bring their results whole for the comparison."""
    cfg, _ = case(name)
    rules = ts.RULE_PROFILES[cfg.sharding_profile]
    lm = tm.init_params(cfg, 0, device="cpu", trainable=True)
    batch = make_batch(cfg)
    tokens = batch["tokens"]
    ctx = contextlib.nullcontext()
    if mesh is not None:
        lm = convert.shard_params(lm, mesh, rules)
        tokens = steps._place_batch({"tokens": tokens}, mesh, None)["tokens"]
        ctx = dc.activation_sharding(mesh, rules)
    rec = record or contextlib.nullcontext()
    out = {}
    with ctx:
        with torch.no_grad(), rec:
            logits, _, _ = tm.forward(cfg, lm, {"tokens": tokens})
        out["logits"] = full(logits).float().numpy()
        if name in ATTN:
            caches = tm.init_cache(cfg, B, SMAX, device="cpu", mesh=mesh)
            calls = [(steps.make_prefill_step(cfg), {
                "tokens": batch["tokens"].numpy()})]
            calls += [(steps.make_decode_step(cfg), {
                "tokens": toks, "cache_index": ci})
                for toks, ci in decodes(cfg)]
            out["serve"] = []
            for fn, b in calls:
                with rec:
                    lg, caches = fn(lm, dict(b, caches=caches))
                out["serve"].append(full(lg).float().numpy())
        ps = [p for _, p in leaves(lm.params)]
        with rec:
            _, grads = steps._grads_of(cfg, lm, ps, batch)
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
    """The functional collectives one rank issues: (op, group name, input
    shape), DTensor-level calls left to DTensor."""

    def __init__(self):
        super().__init__()
        self.log = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        name = func.__name__.split(".")[0]
        if func.namespace == "_c10d_functional" and name != "wait_tensor":
            names = [a for a in list(args) + list((kwargs or {}).values())
                     if isinstance(a, str)]
            shape = list(args[0].shape) if isinstance(
                args[0], torch.Tensor) else []
            self.log.append((name, names[-1] if names else None, shape))
        return func(*args, **(kwargs or {}))


def _worker(out_dir: str) -> None:
    """One gloo rank: every case on its mesh."""
    torch.manual_seed(0)
    cluster.initialize(backend="gloo", device="cpu")
    rank = torch.distributed.get_rank()
    out = Path(out_dir)
    summary = {}
    seen = []
    inner = {n: getattr(layers, n) for n in (
        "_experts", "_online_softmax_scan", "_local_block_attention",
        "_prefill_core", "_decode_core")}

    def experts(p, ein):
        seen.append(("experts", int(p["wg"].shape[0])))
        return inner["_experts"](p, ein)

    def core(n):
        def run(q, k, v, **kw):
            seen.append(("core", q.shape[1], k.shape[1]))
            return inner[n](q, k, v, **kw)
        return run

    def cache_core(n):
        def run(cfg, cache, q, *kv, **kw):
            seen.append(("core", q.shape[1],
                         cache["k"][:, kw["heads"]].shape[1]))
            return inner[n](cfg, cache, q, *kv, **kw)
        return run
    layers._experts = experts
    for n in ("_online_softmax_scan", "_local_block_attention"):
        setattr(layers, n, core(n))
    for n in ("_prefill_core", "_decode_core"):
        setattr(layers, n, cache_core(n))
    meshes = {}
    for name, _, _, shape in CASES:
        if shape not in meshes:
            meshes[shape] = tmesh.make_debug_mesh(*shape, device_type="cpu")
        mesh = meshes[shape]
        seen.clear()
        mode = Collectives()
        res, lm = run_case(name, mesh, record=mode)
        model_group = mesh.get_group("model").group_name
        blocks = {p: list(t.to_local().shape) for p, t in leaves(lm.params)
                  if p.rsplit("/", 1)[-1] in EXPERT_LEAVES and "/moe/" in p}
        summary[name] = {
            "hist": res["hist"], "experts": blocks,
            "calls": sorted({tuple(x) for x in seen}),
            "model_collectives": [[n, shp] for n, g, shp in mode.log
                                  if g == model_group],
            "n_all_to_all": sum(n == "all_to_all_single"
                                for n, g, _ in mode.log
                                if g == model_group)}
        if rank == 0:
            arrays = {"logits": res["logits"],
                      **{f"grad/{p}": g for p, g in res["grads"].items()},
                      **{f"leaf/{p}": a for p, a in res["leaves"].items()}}
            for i, lg in enumerate(res.get("serve", [])):
                arrays[f"serve/{i}"] = lg
            np.savez(out / f"{name}.npz", **arrays)
    with open(out / f"rank{rank}.json", "w") as fh:
        json.dump(summary, fh)
    cluster.shutdown()


def one_device(name):
    res, lm = run_case(name)
    res["init"] = dict(leaves(convert.to_numpy(
        tm.init_params(case(name)[0], 0, device="cpu"))))
    return res


def jax_olmoe_step():
    """The JAX package's one-device ``make_train_step`` (compiled with
    every bf16 rounding kept) on the port's initial olmoe smoke weights
    and the same batch: (loss, grad norm) and the leaves after it."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.optim import adamw as jadamw
    from repro.runtime import steps as jsteps
    cfg, _ = case("olmoe-fsdp-2x2")
    jp = jax.tree.map(jnp.asarray, convert.to_numpy(
        tm.init_params(cfg, 0, device="cpu")))
    js = jadamw.init(jp)
    batch = {k: jnp.asarray(v.numpy()) for k, v in make_batch(cfg).items()}
    cj = get_config("olmoe-1b-7b", smoke=True)
    fn = jsteps.make_train_step(cj, jadamw.OptConfig(**OPT))
    compiled = jax.jit(fn).lower(jp, js, batch).compile(
        compiler_options={"xla_allow_excess_precision": False})
    jp, js, m = compiled(jp, js, batch)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    return ((float(m["loss"]), float(m["grad_norm"])),
            {"/".join(str(getattr(k, "key", k)) for k in path):
             np.asarray(leaf) for path, leaf in flat})


@pytest.fixture(scope="module")
def ranks():
    """One run of the 4 gloo ranks, with the port's one-device runs and
    the reference's one-device olmoe step computed meanwhile."""
    box: dict = {}
    tmp = tempfile.TemporaryDirectory(prefix="repro_torch_expert_parallel_")
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
        box["jax"] = jax_olmoe_step()
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
    yield box
    tmp.cleanup()


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_logits_match_one_device(ranks, name):
    got, want = ranks["npz"][name]["logits"], ranks["port"][name]["logits"]
    assert got.shape == want.shape == (B, S, case(name)[0].padded_vocab)
    assert np.all(np.isfinite(got))
    tol = FAMILY_RTOL.get(name.split("-")[0], LOGIT_RTOL)
    assert rel(got, want) <= tol, (name, rel(got, want))


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_train_step_matches_one_device(ranks, name):
    """Loss and gradient norm on every rank, every gradient leaf, every
    updated leaf (a leaf initialised at zero entry by entry: an entry off
    the one-device step by more than LEAF_RTOL lr must have a one-device
    gradient under LEAF_RTOL of its leaf's gradient norm)."""
    want = ranks["port"][name]
    for r in ranks["ranks"]:
        gl, gn = r[name]["hist"]
        np.testing.assert_allclose(gl, want["hist"][0], rtol=LOSS_RTOL)
        np.testing.assert_allclose(gn, want["hist"][1], rtol=NORM_RTOL)
    npz = ranks["npz"][name]
    for path, w in want["grads"].items():
        assert rel(npz[f"grad/{path}"], w) < LEAF_RTOL, path
    lr = float(adamw.schedule(adamw.OptConfig(**OPT), torch.tensor(1.0)))
    for path, w in want["leaves"].items():
        g = npz[f"leaf/{path}"]
        if np.any(want["init"][path]):
            assert rel(g, w) < LEAF_RTOL, (path, rel(g, w))
            continue
        grad = want["grads"][path]
        off = np.abs(g - w) > LEAF_RTOL * lr
        small = np.abs(grad) <= LEAF_RTOL * np.linalg.norm(grad)
        assert np.all(small[off]), (path, int(off.sum()))


def test_olmoe_one_device_loss_matches_jax(ranks):
    got = ranks["port"]["olmoe-fsdp-2x2"]["hist"][0]
    np.testing.assert_allclose(got, ranks["jax"][0][0], rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", [n for n in MOE if n.startswith("olmoe")])
def test_olmoe_on_the_mesh_matches_jax_one_device(ranks, name):
    """The expert-parallel step under both profiles against the
    reference's one-device step on the same weights and batch: loss and
    gradient norm on every rank, every updated leaf."""
    (wl, wn), want = ranks["jax"]
    for r in ranks["ranks"]:
        gl, gn = r[name]["hist"]
        np.testing.assert_allclose(gl, wl, rtol=LOSS_RTOL)
        np.testing.assert_allclose(gn, wn, rtol=NORM_RTOL)
    npz = ranks["npz"][name]
    assert set(want) == {k[len("leaf/"):] for k in npz
                         if k.startswith("leaf/")}
    for path, w in want.items():
        got = npz[f"leaf/{path}"]
        assert rel(got, w) < LEAF_RTOL, (path, rel(got, w))


@pytest.mark.parametrize("name", MOE)
def test_each_rank_holds_and_runs_its_experts(ranks, name):
    """Every rank's expert leaves are local blocks of E/m experts (the
    leaves stack the layers on a leading dim), and every expert call of
    the forward, the gradient and the step ran on such a block."""
    cfg, (_, m) = case(name)
    for r in ranks["ranks"]:
        blocks = r[name]["experts"]
        assert len(blocks) == len(EXPERT_LEAVES) * len(cfg.block_pattern)
        assert all(shp[-3] == cfg.n_experts // m for shp in blocks.values())
        calls = [c for c in r[name]["calls"] if c[0] == "experts"]
        assert calls == [["experts", cfg.n_experts // m]]


@pytest.mark.parametrize("name", MOE)
def test_no_expert_leaf_is_gathered_over_model(ranks, name):
    """No all-gather over ``model`` takes a block of an expert leaf (a
    layer's local block, with or without its ``embed`` dim gathered)."""
    cfg, (d, m) = case(name)
    E, f, dm = cfg.n_experts // m, cfg.moe_d_ff, cfg.d_model
    blocks = set()
    for dd in {dm, dm // d}:
        blocks |= {(E, dd, f), (E, f, dd)}
    for r in ranks["ranks"]:
        gathered = [tuple(shp[-3:]) for n, shp in
                    r[name]["model_collectives"]
                    if n == "all_gather_into_tensor"]
        assert not blocks & set(gathered), (name, gathered)


@pytest.mark.parametrize("name", MOE)
def test_all_to_all_dispatch_under_fsdp_only(ranks, name):
    """"fsdp": two all-to-alls over ``model`` a MoE layer forward (the
    logits), four in the gradient pass and four in the train step (two
    forward, two back): ten a layer; "2d": none (the combine's partials
    are summed by an all-reduce; the embedding lookup's all-to-alls run
    over ``data``)."""
    cfg, _ = case(name)
    want = 10 * cfg.n_layers if cfg.sharding_profile == "fsdp" else 0
    for r in ranks["ranks"]:
        assert r[name]["n_all_to_all"] == want, (name, r[name])


@pytest.mark.parametrize("name", ATTN)
def test_each_rank_core_sees_its_query_heads(ranks, name):
    """Every attention core call on a rank: H/m query heads, one KV head."""
    cfg, (_, m) = case(name)
    for r in ranks["ranks"]:
        calls = {tuple(c[1:]) for c in r[name]["calls"] if c[0] == "core"}
        assert calls == {(cfg.n_heads // m, 1)}, (name, calls)


@pytest.mark.parametrize("call", range(3), ids=["prefill", "decode",
                                                "decode_rows"])
@pytest.mark.parametrize("name", ATTN)
def test_serving_matches_one_device(ranks, name, call):
    got = ranks["npz"][name][f"serve/{call}"]
    want = ranks["port"][name]["serve"][call]
    assert got.shape == want.shape and np.all(np.isfinite(got))
    tol = FAMILY_RTOL.get(name.split("-")[0], LOGIT_RTOL)
    assert rel(got, want) <= tol, (name, call, rel(got, want))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        _worker(sys.argv[2])
