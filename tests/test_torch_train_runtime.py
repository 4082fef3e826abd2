"""Training runtime parity for the PyTorch port: ``repro_torch.optim``,
``runtime``, ``checkpoint``, ``data.pipeline`` and ``launch.train``
against ``repro.optim`` / ``runtime`` / ``checkpoint`` / ``data`` /
``launch``.

Every case of the reference's ``TestOptimizer``, ``TestTrainStep``,
``TestCheckpoint``, ``TestWatchdog`` and ``TestData``
(``tests/test_runtime.py``) runs on the port with ``device="cpu"``.
Then the port is held to the reference on the same inputs: AdamW fed the
reference's own f32 gradients (params, ``m`` and ``v`` within 1e-6
relative, ``step`` exact), the schedule, int8 compression exact, three
train steps on carried params and state with microbatch 1 and 2 (losses
within 1e-3 relative), the data batches exact, and checkpoints written
by either package restored by the other (f32 trees).

On a card (``-m gpu``): one train step of the smoke model on the card
against the same port code on the CPU.  JAX is imported inside a fixture:
the machine with the card has no JAX.
"""

import dataclasses
import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM, TextLM, host_shard
from repro_torch.launch import train as launch_train
from repro_torch.models import model
from repro_torch.models.spec import leaves, map_tree
from repro_torch.optim import adamw
from repro_torch.runtime import loop, steps

CFG = get_config("llama3.2-1b", smoke=True)
OPT = adamw.OptConfig(peak_lr=1e-3, warmup_steps=5, decay_steps=50)
CPU = "cpu"


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from repro.checkpoint.manager import CheckpointManager as JaxCkpt
    from repro.configs import get_config as jget
    from repro.data import pipeline
    from repro.models import model as jmodel
    from repro.optim import adamw as jadamw
    from repro.runtime import steps as jsteps

    def exact(fn, *args):
        """``fn`` compiled for ``args``' shapes with every bf16 rounding
        kept (the LM parity files' compile)."""
        return jax.jit(fn).lower(*args).compile(compiler_options={
            "xla_allow_excess_precision": False})
    return SimpleNamespace(jax=jax, jnp=jnp, get_config=jget, model=jmodel,
                           adamw=jadamw, steps=jsteps, pipeline=pipeline,
                           Ckpt=JaxCkpt, exact=exact)


def to_np(jx, tree):
    return jx.jax.tree.map(np.asarray, tree)


def params(seed=0, cfg=CFG):
    return model.init_params(cfg, seed, device=CPU, trainable=True)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def flat(tree):
    return dict(leaves(tree))


# -- the reference's TestOptimizer -------------------------------------------

class TestOptimizer:
    def test_schedule_shape(self):
        lrs = [float(adamw.schedule(OPT, torch.tensor(float(s))))
               for s in range(60)]
        assert lrs[0] < lrs[4] <= max(lrs)            # warmup rises
        assert lrs[-1] < max(lrs)                     # decays
        assert min(lrs[5:]) >= OPT.peak_lr * OPT.min_lr_ratio * 0.99

    def test_clip(self):
        g = {"a": torch.full((4,), 100.0)}
        clipped, norm = adamw.clip_by_global_norm(g, 1.0)
        assert float(norm) == pytest.approx(200.0)
        assert float(adamw.global_norm(clipped)) == pytest.approx(
            1.0, rel=1e-5)

    def test_update_moves_params(self):
        lm = params()
        before = convert.to_numpy(lm)
        state = adamw.init(lm)
        grads = map_tree(lambda p: torch.ones_like(p.detach()), lm.params)
        new_params, new_state, metrics = adamw.update(OPT, grads, state, lm)
        assert int(new_state["step"]) == 1
        diff = np.sqrt(sum(np.sum(np.square(a - b)) for (_, a), (_, b) in
                           zip(leaves(before),
                               leaves(convert.to_numpy(new_params)))))
        assert diff > 0

    def test_grad_compression_roundtrip(self):
        cfg8 = adamw.OptConfig(grad_compression="int8")
        g = {"w": torch.from_numpy(np.random.default_rng(0).normal(
            size=(64,)).astype(np.float32))}
        out = adamw.decompress(cfg8, adamw.compress(cfg8, g))
        err = float(torch.max(torch.abs(out["w"] - g["w"])))
        assert err < float(torch.max(torch.abs(g["w"]))) / 100


# -- the reference's TestTrainStep -------------------------------------------

class TestTrainStep:
    def test_microbatch_equals_full_batch(self):
        """Grad accumulation over microbatches == single big batch."""
        cfg1 = dataclasses.replace(CFG, microbatch=1)
        cfg4 = dataclasses.replace(CFG, microbatch=4)
        rng = np.random.default_rng(0)
        batch = {"tokens": rng.integers(0, CFG.vocab, (8, 16)),
                 "labels": rng.integers(0, CFG.vocab, (8, 16))}
        p1, p4 = params(0, cfg1), params(0, cfg4)
        _, _, m1 = steps.make_train_step(cfg1, OPT)(p1, adamw.init(p1),
                                                    batch)
        _, _, m4 = steps.make_train_step(cfg4, OPT)(p4, adamw.init(p4),
                                                    batch)
        np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                                   rtol=1e-3)
        d = {k: a - flat(p4.params)[k] for k, a in flat(p1.params).items()}
        ratio = adamw.global_norm(d) / adamw.global_norm(p1)
        assert float(ratio) < 1e-3


# -- the reference's TestCheckpoint ------------------------------------------

class TestCheckpoint:
    def test_save_restore_roundtrip(self, tmp_path):
        mgr = CheckpointManager(tmp_path, async_write=False)
        lm = params()
        mgr.save(7, lm, blocking=True)
        restored, step = mgr.restore(lm)
        assert step == 7
        assert isinstance(restored, model.CausalLM)
        for (pa, a), (pb, b) in zip(leaves(lm.params),
                                    leaves(restored.params)):
            assert pa == pb
            assert torch.equal(a, b) and b.requires_grad

    def test_latest_and_gc(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep=2, async_write=False)
        tree = {"w": torch.arange(4.0)}
        for s in (1, 2, 3, 4):
            mgr.save(s, tree, blocking=True)
        assert mgr.latest_step() == 4
        assert mgr.all_steps() == [3, 4]      # GC keeps last 2

    def test_atomicity_partial_dir_ignored(self, tmp_path):
        mgr = CheckpointManager(tmp_path, async_write=False)
        tree = {"w": torch.arange(4.0)}
        mgr.save(1, tree, blocking=True)
        # Simulate a preempted writer: a .tmp dir without manifest.
        (tmp_path / "step_000000002.tmp").mkdir()
        assert mgr.latest_step() == 1

    def test_resume_training_continues(self, tmp_path):
        """Kill/restart: resumed run continues from the checkpoint step."""
        mgr = CheckpointManager(tmp_path, async_write=False)
        data = SyntheticLM(vocab=CFG.vocab, seq_len=16, global_batch=4)
        loop.train(CFG, OPT, data, 6, ckpt=mgr, ckpt_every=3,
                   log_every=0, log=lambda *_: None, device=CPU)
        assert mgr.latest_step() == 6
        r2 = loop.train(CFG, OPT, data, 10, ckpt=mgr, ckpt_every=100,
                        log_every=0, log=lambda *_: None, device=CPU)
        assert r2.final_step == 10
        assert len(r2.losses) == 4            # only steps 6..9 re-run

    def test_async_save(self, tmp_path):
        mgr = CheckpointManager(tmp_path, async_write=True)
        mgr.save(1, {"w": torch.arange(8.0)})
        mgr.wait()
        assert mgr.latest_step() == 1


# -- the reference's TestWatchdog --------------------------------------------

class TestWatchdog:
    def test_straggler_detection_and_snapshot(self, tmp_path):
        mgr = CheckpointManager(tmp_path, async_write=False)
        data = SyntheticLM(vocab=CFG.vocab, seq_len=16, global_batch=4)

        stamps = []

        def delay(step):
            stamps.append(time.perf_counter())
            if step == 8:
                # The reference's 1 s, or 10x the steps so far where they
                # run slower (the eager CPU step, beside other processes):
                # a straggler either way.
                per_step = (stamps[-1] - stamps[1]) / (len(stamps) - 2)
                time.sleep(max(1.0, 10 * per_step))

        res = loop.train(CFG, OPT, data, 10, ckpt=mgr, ckpt_every=0,
                         watchdog_factor=3.0, step_hook=delay,
                         log_every=0, log=lambda *_: None, device=CPU)
        assert any(e.step == 8 for e in res.straggler_events)
        # the watchdog snapshotted mid-run
        assert 9 in mgr.all_steps() or mgr.latest_step() is not None


# -- the reference's TestData ------------------------------------------------

class TestData:
    def test_deterministic_seek(self):
        d = SyntheticLM(vocab=100, seq_len=8, global_batch=4, seed=3)
        a = d.batch_at(17)
        b = d.batch_at(17)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])

    def test_labels_are_next_tokens(self):
        d = SyntheticLM(vocab=100, seq_len=8, global_batch=4)
        b = d.batch_at(0)
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])

    def test_text_pipeline(self):
        corpus = bytes(range(256)) * 20
        d = TextLM(corpus=corpus, seq_len=16, global_batch=2)
        b = d.batch_at(0)
        assert b["tokens"].shape == (2, 16)
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])

    def test_host_shard(self):
        d = SyntheticLM(vocab=100, seq_len=8, global_batch=8)
        b = d.batch_at(0)
        s0 = host_shard(b, 0, 4)
        s3 = host_shard(b, 3, 4)
        assert s0["tokens"].shape == (2, 8)
        np.testing.assert_array_equal(s3["tokens"], b["tokens"][6:8])


# -- parity with the reference -----------------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 0), (3, 17), (7, 123_456)])
def test_synthetic_batches_equal_reference(jx, seed, step):
    for vocab, S, B in ((100, 8, 4), (128_256, 128, 8)):
        want = jx.pipeline.SyntheticLM(vocab, S, B, seed).batch_at(step)
        got = SyntheticLM(vocab, S, B, seed).batch_at(step)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        for h in range(2):
            for k, v in jx.pipeline.host_shard(want, h, 2).items():
                np.testing.assert_array_equal(host_shard(got, h, 2)[k], v)


def test_text_batches_equal_reference_on_repo_text(jx):
    from pathlib import Path
    corpus = (Path(__file__).resolve().parents[1] / "PAPER.md").read_bytes()
    for step in (0, 5, 99):
        want = jx.pipeline.TextLM(corpus, 64, 4, seed=2).batch_at(step)
        got = TextLM(corpus, 64, 4, seed=2).batch_at(step)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_schedule_equals_reference(jx):
    cfg_j = jx.adamw.OptConfig(peak_lr=3e-4, warmup_steps=20,
                               decay_steps=200)
    cfg_t = adamw.OptConfig(peak_lr=3e-4, warmup_steps=20, decay_steps=200)
    s = np.arange(0, 260, dtype=np.float32)
    want = np.asarray(jx.jax.jit(
        lambda x: jx.adamw.schedule(cfg_j, x))(jx.jnp.asarray(s)))
    got = adamw.schedule(cfg_t, torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _grads_like(rng, tree, scale):
    return {k: (rng.standard_normal(v.shape) * scale).astype(np.float32)
            for k, v in tree.items()}


@pytest.mark.parametrize("clip", [1.0, 1e3])
def test_update_equals_reference_on_its_grads(jx, clip):
    """Three AdamW steps fed the reference's own f32 gradients: params, m
    and v within 1e-6 relative, step exact, lr and grad_norm too.  clip
    1.0 clips every step (norm ~ 6), 1e3 none."""
    cj = jx.get_config("llama3.2-1b", smoke=True)
    oj = jx.adamw.OptConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=10,
                            clip_norm=clip)
    ot = adamw.OptConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=10,
                         clip_norm=clip)
    jp = jx.model.init_params(cj, jx.jax.random.PRNGKey(0))
    js = jx.adamw.init(jp)
    lm = convert.params_from_numpy(CFG, to_np(jx, jp), device=CPU)
    ts = convert.opt_state_from_numpy(CFG, to_np(jx, js), device=CPU)
    upd = jx.jax.jit(lambda g, s, p: jx.adamw.update(oj, g, s, p))
    rng = np.random.default_rng(0)
    for _ in range(3):
        g = jx.jax.tree.map(
            lambda x: (rng.standard_normal(x.shape) * 0.3).astype(
                np.float32), to_np(jx, jp))
        jp, js, jm = upd(g, js, jp)
        g_t = jx.jax.tree.map(torch.from_numpy, g)
        lm, ts, tm = adamw.update(ot, g_t, ts, lm)
        assert int(ts["step"]) == int(js["step"])
        assert ts["step"].dtype == torch.int32
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-6)
        for name, want, got in (("params", jp, lm), ("m", js["m"], ts["m"]),
                                ("v", js["v"], ts["v"])):
            w, t = flat(to_np(jx, want)), flat(convert.to_numpy(got))
            assert set(w) == set(t)
            for path in w:
                assert rel(t[path], w[path]) < 1e-6, (name, path)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_int8_compression_is_exact(jx, dtype):
    """compress/decompress equal the compiled reference's int8 values,
    scales and dequantized f32, a bf16 leaf whose quotient rounds to 128
    (saturated to 127) among them."""
    jnp = jx.jnp
    cj = jx.adamw.OptConfig(grad_compression="int8")
    ct = adamw.OptConfig(grad_compression="int8")
    rng = np.random.default_rng(1)
    tree = {f"w{i}": (rng.standard_normal((257, 33))
                      * 10 ** rng.uniform(-4, 2)).astype(np.float32)
            for i in range(24)}
    tree["zero"] = np.zeros((5,), np.float32)          # the 1e-9 floor
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    tt = {k: torch.from_numpy(v) for k, v in tree.items()}
    if dtype == "bf16":
        jt = {k: v.astype(jnp.bfloat16) for k, v in jt.items()}
        tt = {k: v.bfloat16() for k, v in tt.items()}
    jq = jx.jax.jit(lambda g: jx.adamw.compress(cj, g))(jt)
    tq = adamw.compress(ct, tt)
    jd = jx.jax.jit(lambda q: jx.adamw.decompress(cj, q))(jq)
    td = adamw.decompress(ct, tq)
    saturated = 0
    for k in tree:
        np.testing.assert_array_equal(tq[k][0].numpy(), np.asarray(jq[k][0]))
        assert float(tq[k][1]) == float(jq[k][1])
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]))
        saturated += int((torch.round(tt[k] / tq[k][1]) > 127).sum())
    if dtype == "bf16":
        assert saturated > 0
    for mode in ("none", "bf16"):
        out = adamw.compress(adamw.OptConfig(grad_compression=mode), tt)
        want = jx.adamw.compress(jx.adamw.OptConfig(grad_compression=mode),
                                 jt)
        for k in tree:
            np.testing.assert_array_equal(out[k].float().numpy(),
                                          np.asarray(want[k], np.float32))


@pytest.mark.parametrize("microbatch", [1, 2])
def test_train_steps_follow_reference(jx, microbatch):
    """Three ``make_train_step`` steps on carried params and state: the
    losses within 1e-3 relative of the reference's (compiled exactly),
    and the params after them within 1e-3 relative L2."""
    cj = dataclasses.replace(jx.get_config("llama3.2-1b", smoke=True),
                             microbatch=microbatch)
    ct = dataclasses.replace(CFG, microbatch=microbatch)
    oj = jx.adamw.OptConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=10)
    jp = jx.model.init_params(cj, jx.jax.random.PRNGKey(0))
    js = jx.adamw.init(jp)
    lm = convert.params_from_numpy(ct, to_np(jx, jp), device=CPU)
    lm.requires_grad_(True)
    ts = convert.opt_state_from_numpy(ct, to_np(jx, js), device=CPU)
    data = SyntheticLM(vocab=CFG.vocab, seq_len=16, global_batch=4, seed=1)
    jstep = tstep = None
    for s in range(3):
        b = data.batch_at(s)
        jb = {k: jx.jnp.asarray(v) for k, v in b.items()}
        jstep = jstep or jx.exact(jx.steps.make_train_step(cj, oj),
                                  jp, js, jb)
        tstep = tstep or steps.make_train_step(ct, adamw.OptConfig(
            peak_lr=1e-3, warmup_steps=2, decay_steps=10))
        jp, js, jm = jstep(jp, js, jb)
        lm, ts, tm = tstep(lm, ts, b)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-3)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-2)
        assert int(ts["step"]) == s + 1
    w, t = flat(to_np(jx, jp)), flat(convert.to_numpy(lm))
    num = sum(np.sum(np.square(t[k] - w[k])) for k in w)
    den = sum(np.sum(np.square(w[k])) for k in w)
    assert np.sqrt(num / den) < 1e-3


def test_make_step_kinds():
    """``make_step``'s prefill and decode steps are ``model.prefill`` and
    ``model.decode_step`` on a batch dict; an unknown kind is refused."""
    lm = model.init_params(CFG, 0, device=CPU)
    toks = np.arange(8, dtype=np.int32)[None]
    want_c = lm.init_cache(1, 16)
    want, _ = model.prefill(CFG, lm, {"tokens": toks}, want_c)
    got_c = lm.init_cache(1, 16)
    got, _ = steps.make_step(CFG, "prefill")(lm, {"tokens": toks,
                                                  "caches": got_c})
    assert torch.equal(got, want)
    want, _ = model.decode_step(CFG, lm, want_c, toks[:, :1], 8)
    got, _ = steps.make_step(CFG, "decode")(lm, {
        "caches": got_c, "tokens": toks[:, :1], "cache_index": 8})
    assert torch.equal(got, want)
    assert callable(steps.make_step(CFG, "train"))
    with pytest.raises(ValueError):
        steps.make_step(CFG, "eval")


def test_train_step_grad_compression_runs():
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, CFG.vocab, (2, 16)),
             "labels": rng.integers(0, CFG.vocab, (2, 16))}
    for mode in ("bf16", "int8"):
        lm = params()
        opt = adamw.OptConfig(grad_compression=mode)
        _, state, m = steps.make_train_step(CFG, opt)(lm, adamw.init(lm),
                                                      batch)
        assert np.isfinite(float(m["loss"])) and int(state["step"]) == 1


# -- checkpoints across packages ---------------------------------------------

def _train_tree_pair(jx):
    cj = jx.get_config("llama3.2-1b", smoke=True)
    jp = jx.model.init_params(cj, jx.jax.random.PRNGKey(5))
    g = jx.jax.tree.map(lambda x: x * 0 + 0.01, jp)
    jp, js, _ = jx.adamw.update(jx.adamw.OptConfig(), g,
                                jx.adamw.init(jp), jp)
    lm = convert.params_from_numpy(CFG, to_np(jx, jp), device=CPU)
    lm.requires_grad_(True)
    ts = convert.opt_state_from_numpy(CFG, to_np(jx, js), device=CPU)
    return (jp, js), (lm, ts)


def test_reference_checkpoint_restores_in_port(jx, tmp_path):
    (jp, js), (lm, ts) = _train_tree_pair(jx)
    jx.Ckpt(tmp_path, async_write=False).save(3, (jp, js), blocking=True)
    like = (params(9), adamw.init(params(9)))
    (rp, rs), step = CheckpointManager(tmp_path).restore(like)
    assert step == 3
    assert isinstance(rp, model.CausalLM) and rs["step"].dtype == torch.int32
    for (a, b) in ((lm, rp), (ts, rs)):
        fa, fb = flat(convert.to_numpy(a)), flat(convert.to_numpy(b))
        assert set(fa) == set(fb)
        for k in fa:
            np.testing.assert_array_equal(fb[k], fa[k])


def test_port_checkpoint_restores_in_reference(jx, tmp_path):
    (jp, js), (lm, ts) = _train_tree_pair(jx)
    mgr = CheckpointManager(tmp_path, async_write=True)
    mgr.save(4, (lm, ts))
    mgr.wait()
    assert mgr.last_save["bytes"] > 0 and mgr.last_save["write_s"] >= 0
    manifest = json.loads((tmp_path / "step_000000004" /
                           "manifest.json").read_text())["arrays"]
    assert "0/embed" in manifest and "1/m/embed" in manifest
    assert manifest["1/step"]["dtype"] == "int32"
    like = jx.jax.tree.map(np.zeros_like, to_np(jx, (jp, js)))
    (rp, rs), step = jx.Ckpt(tmp_path).restore(like)
    assert step == 4
    for want, got in ((jp, rp), (js, rs)):
        w, g = flat(to_np(jx, want)), flat(to_np(jx, got))
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def test_bf16_checkpoint_round_trips_in_port(jx, tmp_path):
    """A bf16 tree (serving weights) writes its 16-bit patterns and comes
    back bit for bit; the reference's own bf16 file (``np.save`` of an
    ``ml_dtypes`` array) restores in the port the same way."""
    cfg = dataclasses.replace(CFG, param_dtype="bf16")
    lm = model.init_params(cfg, 2, device=CPU)
    mgr = CheckpointManager(tmp_path / "port", async_write=False)
    mgr.save(1, lm)
    back, _ = mgr.restore(lm)
    for (_, a), (_, b) in zip(leaves(lm.params), leaves(back.params)):
        assert b.dtype == torch.bfloat16 and torch.equal(a, b)
    x = np.arange(-8, 8, dtype=np.float32) / 3
    jx.Ckpt(tmp_path / "ref", async_write=False).save(
        1, {"w": jx.jnp.asarray(x, jx.jnp.bfloat16)}, blocking=True)
    got, _ = CheckpointManager(tmp_path / "ref").restore(
        {"w": torch.zeros(16, dtype=torch.bfloat16)})
    assert torch.equal(got["w"], torch.from_numpy(x).bfloat16())


def test_restore_places_leaves_on_like_devices(tmp_path):
    mgr = CheckpointManager(tmp_path, async_write=False)
    mgr.save(2, {"w": torch.arange(4.0), "n": torch.tensor(3)})
    got, _ = mgr.restore({"w": torch.zeros(4), "n": np.zeros((), np.int64)},
                         device=CPU)
    assert got["w"].device.type == "cpu" and int(got["n"]) == 3
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore({})
    with pytest.raises(KeyError, match="missing array x"):
        mgr.restore({"x": torch.zeros(1)})


# -- the launcher -------------------------------------------------------------

def test_launcher_done_line_and_resume(tmp_path, capsys):
    args = ["--smoke", "--device", "cpu", "--steps", "6", "--batch", "4",
            "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"]
    res = launch_train.main(args)
    out = capsys.readouterr().out
    assert res.final_step == 6 and len(res.losses) == 6
    done = [line for line in out.splitlines() if line.startswith("done:")]
    assert done == [f"done: 6 steps, loss {res.losses[0]:.4f} -> "
                    f"{res.losses[-1]:.4f}, median step "
                    f"{sorted(res.step_times)[3] * 1e3:.1f} ms, "
                    f"stragglers 0"]
    assert CheckpointManager(tmp_path).all_steps() == [3, 6]
    res2 = launch_train.main(args[:4] + ["9"] + args[5:])
    out = capsys.readouterr().out
    assert "[resume] restored checkpoint at step 6" in out
    assert res2.final_step == 9 and len(res2.losses) == 3


def test_resumed_losses_equal_uninterrupted(tmp_path):
    """Steps 4-7 after a restart from step 4 equal the same steps of an
    uninterrupted run (the data seeks, the state restores exactly)."""
    data = SyntheticLM(vocab=CFG.vocab, seq_len=16, global_batch=4)
    kw = dict(log_every=0, log=lambda *_: None, device=CPU)
    whole = loop.train(CFG, OPT, data, 8, **kw)
    mgr = CheckpointManager(tmp_path, async_write=False)
    loop.train(CFG, OPT, data, 4, ckpt=mgr, ckpt_every=4, **kw)
    resumed = loop.train(CFG, OPT, data, 8, ckpt=mgr, **kw)
    assert len(resumed.losses) == 4
    np.testing.assert_allclose(resumed.losses, whole.losses[4:], rtol=1e-6)


def test_training_entry_points_need_a_device_without_cuda(monkeypatch,
                                                          tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = SyntheticLM(vocab=CFG.vocab, seq_len=8, global_batch=2)
    mgr = CheckpointManager(tmp_path, async_write=False)
    mgr.save(1, {"w": torch.zeros(2)})
    for call in (lambda: loop.train(CFG, OPT, data, 1),
                 lambda: launch_train.main(["--smoke", "--steps", "1"]),
                 lambda: mgr.restore({"w": np.zeros(2, np.float32)})):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_chip_smoke_train_phase_rehearses_on_cpu(tmp_path, monkeypatch,
                                                 capsys):
    """``chip_smoke.py``'s phase 11 on the CPU with every config cut to its
    smoke variant: (t1)-(t4) run their checks (the card against the CPU
    becomes the CPU against itself) and print their lines; the
    checkpoint directory goes under the patched root and is removed."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_train", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setattr(cs, "ROOT", tmp_path)
    info = cs.train_phase(device=CPU, sync=lambda: None, smoke=True,
                          profile=False)
    json.dumps(info)
    out = capsys.readouterr().out
    assert info["t1"]["steps"] == cs.TRAIN_STEPS
    assert set(info["t2"]) == {"olmoe", "rgemma", "mamba2", "whisper",
                               "pixtral"}
    assert set(info["t3"]) == {"dense", "moe", "hybrid", "ssm", "encdec",
                               "embeds"}
    assert info["t3"]["encdec"]["noise_leaves"]
    assert info["t4"]["bit_equal"] and info["t4"]["checkpoints"] == [4, 8]
    for tag in ("(t1)", "(t2) pixtral", "(t3) embeds", "(t4)"):
        assert tag in out
    assert not (tmp_path / "build" / "train_ckpt").exists()


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("microbatch", [1, 2])
def test_card_train_step_matches_cpu(cuda, microbatch):
    cfg = dataclasses.replace(CFG, microbatch=microbatch)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, CFG.vocab, (4, 32)),
             "labels": rng.integers(0, CFG.vocab, (4, 32))}
    out = {}
    for dev in ("cpu", cuda):
        lm = model.init_params(cfg, 0, device="cpu", trainable=True)
        lm = convert.params_from_numpy(cfg, convert.to_numpy(lm), device=dev)
        lm.requires_grad_(True)
        lm, st, m = steps.make_train_step(cfg, OPT)(lm, adamw.init(lm),
                                                    batch)
        out[str(dev)] = (float(m["loss"]), flat(convert.to_numpy(lm)))
    (l_cpu, p_cpu), (l_card, p_card) = out["cpu"], out[str(cuda)]
    np.testing.assert_allclose(l_card, l_cpu, rtol=1e-3)
    for k in p_cpu:
        assert rel(p_card[k], p_cpu[k]) < 3e-2, k
