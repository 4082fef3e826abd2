"""Hybrid LM parity for the PyTorch port: local (sliding-window)
attention, ``repro_torch.models.ssm._causal_conv``, the RG-LRU block
(``repro_torch.models.rglru``) and recurrentgemma against ``repro.models``.

The same numpy inputs and the JAX ``init_params`` tree, carried across
with ``repro_torch.convert.params_from_numpy``, go through both packages,
the port's on ``device="cpu"``; the reference is compiled with
``xla_allow_excess_precision`` off.  Tolerances: the reference's bf16
tolerance on logits and activations (``rtol = atol = 3e-2``); the RG-LRU
core in f32 holds ``tests/test_models.py::TestRGLRU``'s 2e-3 (the port's
log-depth scan associates the products in another order than
``lax.associative_scan``); the convolution is bit for bit.  Serving
streams equal the reference's under the margin rule of
``tests/test_torch_lm_serving.py``, including the reference's leak of
recurrent state between engine slots, which the port keeps.

On a card (``-m gpu``): the smoke model's logits on the card against the
CPU, with dense and block-diagonal gates.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from test_torch_lm_model import TOL, carried, configs, f32, to_np
from test_torch_lm_serving import same_stream

from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.models import layers as tl
from repro_torch.models import model as tm
from repro_torch.models import rglru as trg
from repro_torch.models import ssm as tssm
from repro_torch.serving.engine import Engine, Request, generate_greedy
from repro_torch.serving.speculative import SpeculativeDecoder

ARCH = "recurrentgemma-9b"
CORE_TOL = dict(rtol=2e-3, atol=2e-3)
GATES = {"dense": dict(), "block": dict(rglru_block_diag=4)}


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import layers, model, rglru, spec, ssm
    from repro.serving import engine, speculative

    def exact(fn, *args):
        return jax.jit(fn).lower(*args).compile(compiler_options={
            "xla_allow_excess_precision": False})

    def run(fn, *args):
        return exact(fn, *args)(*args)
    return SimpleNamespace(jax=jax, jnp=jnp, get_config=get_config,
                           layers=layers, model=model, rglru=rglru,
                           spec=spec, ssm=ssm, engine=engine,
                           speculative=speculative, exact=exact, run=run)


def bf16(jx, x):
    return jx.jnp.asarray(x).astype(jx.jnp.bfloat16)


def tensors(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


# -- local attention ----------------------------------------------------------

@pytest.mark.parametrize("window,n_chunks,kv_heads", [(4, 3, 1), (8, 2, 2),
                                                      (16, 1, 4)])
def test_local_block_attention(jx, window, n_chunks, kv_heads):
    rng = np.random.default_rng(window)
    S = window * n_chunks
    q = rng.standard_normal((2, 4, S, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, kv_heads, S, 16)).astype(np.float32)
            for _ in range(2))
    want = jx.run(lambda q, k, v: jx.layers._local_block_attention(
        q, k, v, window=window), bf16(jx, q), bf16(jx, k), bf16(jx, v))
    got = tl._local_block_attention(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)), window=window)
    np.testing.assert_allclose(f32(got), f32(want), **TOL)


LOCAL_BRANCHES = ["full_block", "full_scan", "prefill", "continuation",
                  "decode_scalar", "decode_rows"]


def _local_case(jx, kv_quant, branch, seed=4):
    """One branch of ``attention_apply(local=True)`` in both packages, the
    cache holding 20 positions (past the smoke window of 16); returns
    (y_jax, y_port, cache_jax, cache_port)."""
    cj, ct = configs(ARCH, kv_quant=kv_quant)
    jnp = jx.jnp
    jp = jx.spec.initialize(jx.layers.attention_specs(cj),
                            jx.jax.random.PRNGKey(seed))
    tp = tensors(jp)
    rng = np.random.default_rng(seed)
    B, n_ctx, S_max = 2, 20, 48

    def attend(p, x, c, i, pos, mode):
        return jx.layers.attention_apply(cj, p, x, positions=pos, mode=mode,
                                         cache=c, cache_index=i, local=True)
    ctx = rng.standard_normal((B, n_ctx, cj.d_model)).astype(np.float32)
    cspecs = jx.layers.attn_cache_specs(cj, B, S_max)
    jcache = {k: jnp.zeros(s.shape, s.dtype) for k, s in cspecs.items()}
    ctx_pos = jnp.broadcast_to(jnp.arange(n_ctx)[None], (B, n_ctx))
    _, jcache = jx.run(lambda p, x, c, pos: attend(p, x, c, 0, pos, "full"),
                       jp, bf16(jx, ctx), jcache, ctx_pos)
    tcache = {k: (torch.from_numpy(np.array(v.astype(jnp.float32))).bfloat16()
                  if v.dtype == jnp.bfloat16
                  else torch.from_numpy(np.array(v)))
              for k, v in jcache.items()}
    S, ci, jc_, tc_, mode = 6, 20, jcache, tcache, "full"
    if branch == "full_block":
        S, ci, jc_, tc_ = 32, None, None, None
    elif branch == "full_scan":
        S, ci, jc_, tc_ = 24, None, None, None
    elif branch == "prefill":
        S, ci = 24, 0
        jc_ = {k: jnp.zeros_like(v) for k, v in jcache.items()}
        tc_ = {k: torch.zeros_like(v) for k, v in tcache.items()}
    elif branch == "decode_scalar":
        S, mode = 1, "decode"
    elif branch == "decode_rows":
        S, ci, mode = 1, np.array([20, 17], np.int32), "decode"
    x = rng.standard_normal((B, S, cj.d_model)).astype(np.float32)
    base = 0 if ci is None else np.asarray(ci).reshape(-1, 1)
    pos = np.broadcast_to(base + np.arange(S)[None], (B, S)).astype(np.int32)
    jci = None if ci is None else jnp.asarray(ci)
    yj, cj_out = jx.run(lambda p, x, c, i, pos: attend(p, x, c, i, pos, mode),
                        jp, bf16(jx, x), jc_, jci, jnp.asarray(pos))
    yt, ct_out = tl.attention_apply(
        ct, tp, torch.from_numpy(x).bfloat16(),
        positions=torch.from_numpy(pos), mode=mode, cache=tc_,
        cache_index=ci, local=True)
    return yj, yt, cj_out, ct_out


@pytest.mark.parametrize("branch", LOCAL_BRANCHES)
@pytest.mark.parametrize("kv_quant", [False, True])
def test_attention_apply_local(jx, kv_quant, branch):
    """Every local branch: block-local (32 tokens, two windows), the
    windowed scan (24 tokens), the prefill and the continuation into a
    cache, and decode past the window at one and at per-row positions."""
    yj, yt, cj, ct = _local_case(jx, kv_quant, branch)
    np.testing.assert_allclose(f32(yt), f32(yj), **TOL)
    if cj is None:
        assert ct is None
        return
    for k in cj:
        want = np.asarray(cj[k])
        if want.dtype == np.int8:
            np.testing.assert_array_equal(ct[k].numpy(), want, err_msg=k)
        else:
            np.testing.assert_allclose(f32(ct[k]), want.astype(np.float32),
                                       err_msg=k, **TOL)


def test_local_window_hides_old_positions():
    """Decode past the window attends the last ``window`` positions only:
    changing the cache at an older position leaves the output alone."""
    cfg = tget(ARCH, smoke=True)
    lm = tm.init_params(cfg, 0, device="cpu")
    p = lm.params["blocks"]["units"]["2"]["attn"]
    p = {k: v[0] for k, v in p.items()}
    torch.manual_seed(0)
    cache = {"k": torch.randn(1, 1, 40, 16).bfloat16(),
             "v": torch.randn(1, 1, 40, 16).bfloat16()}
    x = torch.randn(1, 1, cfg.d_model).bfloat16()
    pos = torch.tensor([[30]])

    def out(c):
        c = {k: v.clone() for k, v in c.items()}
        return tl.attention_apply(cfg, p, x, positions=pos, mode="decode",
                                  cache=c, cache_index=30, local=True)[0]
    old = {k: v.clone() for k, v in cache.items()}
    old["v"][:, :, 14] += 5        # 16 positions back: outside the window
    assert torch.equal(out(cache), out(old))
    near = {k: v.clone() for k, v in cache.items()}
    near["v"][:, :, 15] += 5       # 15 back: inside
    assert not torch.equal(out(cache), out(near))


# -- the RG-LRU block -------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(jx, with_state):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    st = rng.standard_normal((2, 3, 24)).astype(np.float32)
    args = (bf16(jx, x), jx.jnp.asarray(w)) + (
        (bf16(jx, st),) if with_state else ())
    yj, sj = jx.run(jx.ssm._causal_conv, *args)
    yt, stt = tssm._causal_conv(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
        torch.from_numpy(st).bfloat16() if with_state else None)
    np.testing.assert_array_equal(f32(yt), f32(yj))
    np.testing.assert_array_equal(f32(stt), f32(sj))


def _core_params(r, rng, nb=0):
    gate = (nb, r // nb, r // nb) if nb else (r, r)
    return {"w_a": rng.normal(size=gate).astype(np.float32) * 0.1,
            "b_a": rng.normal(size=(r,)).astype(np.float32),
            "w_i": rng.normal(size=gate).astype(np.float32) * 0.1,
            "b_i": rng.normal(size=(r,)).astype(np.float32),
            "lam": np.abs(rng.normal(size=(r,))).astype(np.float32)}


@pytest.mark.parametrize("case", ["full", "full_h0", "decode",
                                  "decode_h0"])
def test_rglru_core(jx, case):
    """``_rglru_core`` on f32 inputs, 2e-3 (``TestRGLRU``'s tolerance)."""
    cj, ct = configs(ARCH)
    rng = np.random.default_rng(2)
    r = cj.rnn_width
    p = _core_params(r, rng)
    S = 1 if case.startswith("decode") else 24
    x = rng.normal(size=(2, S, r)).astype(np.float32)
    h0 = rng.normal(size=(2, r)).astype(np.float32) if "h0" in case else None
    mode = "decode" if S == 1 else "full"
    hj, lj = jx.run(lambda p, x, h: jx.rglru._rglru_core(
        cj, p, x, h, cj.rglru_c, mode), {k: jx.jnp.asarray(v)
                                         for k, v in p.items()},
        jx.jnp.asarray(x), None if h0 is None else jx.jnp.asarray(h0))
    ht, lt = trg._rglru_core(ct, tensors(p), torch.from_numpy(x),
                             None if h0 is None else torch.from_numpy(h0),
                             ct.rglru_c, mode)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **CORE_TOL)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **CORE_TOL)


def test_linear_scan_matches_a_loop():
    """The log-depth scan against the step-by-step recurrence, at lengths
    around powers of two."""
    rng = np.random.default_rng(3)
    for S in (1, 2, 3, 8, 13, 64, 100):
        a = torch.from_numpy(rng.uniform(0.5, 1, (2, S, 5)))
        b = torch.from_numpy(rng.normal(size=(2, S, 5)))
        h, want = torch.zeros(2, 5, dtype=a.dtype), []
        for t in range(S):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        torch.testing.assert_close(trg._linear_scan(a, b),
                                   torch.stack(want, 1))


@pytest.mark.parametrize("mode", ["full", "prefill", "decode"])
@pytest.mark.parametrize("gates", list(GATES))
def test_rglru_apply(jx, gates, mode):
    """The whole block: without a cache, filling a zero cache, and one
    decode step from a carried state; the cache's conv and h too."""
    cj, ct = configs(ARCH, **GATES[gates])
    jp = jx.spec.initialize(jx.rglru.rglru_specs(cj),
                            jx.jax.random.PRNGKey(5))
    jp = dict(jp, b_a=jp["b_a"] + 0.3, b_i=jp["b_i"] - 0.2)
    rng = np.random.default_rng(5)
    S = 1 if mode == "decode" else 9
    x = rng.standard_normal((2, S, cj.d_model)).astype(np.float32)
    if mode == "full":
        jc = tc = None
    else:
        r = cj.rnn_width
        conv = rng.standard_normal((2, 3, r)).astype(np.float32)
        h = rng.standard_normal((2, r)).astype(np.float32)
        if mode == "prefill":
            conv, h = 0 * conv, 0 * h
        jc = {"conv": bf16(jx, conv), "h": bf16(jx, h)}
        tc = {"conv": torch.from_numpy(conv).bfloat16(),
              "h": torch.from_numpy(h).bfloat16()}
    run_mode = "decode" if mode == "decode" else "full"
    yj, cj_out = jx.run(lambda p, x, c: jx.rglru.rglru_apply(
        cj, p, x, mode=run_mode, cache=c), jp, bf16(jx, x), jc)
    yt, ct_out = trg.rglru_apply(ct, tensors(jp),
                                 torch.from_numpy(x).bfloat16(),
                                 mode=run_mode, cache=tc)
    np.testing.assert_allclose(f32(yt), f32(yj), **TOL)
    if cj_out is None:
        assert ct_out is None
        return
    np.testing.assert_array_equal(f32(ct_out["conv"]), f32(cj_out["conv"]))
    np.testing.assert_allclose(f32(ct_out["h"]), f32(cj_out["h"]), **TOL)


def test_rglru_launches_do_not_grow_with_the_sequence():
    """The full-mode recurrence is a log-depth scan: the aten ops of one
    ``rglru_apply`` (a torch.profiler count) grow by the same round at
    every doubling of S from 32 to 256, not with the steps."""
    from torch.profiler import ProfilerActivity, profile
    cfg = tget(ARCH, smoke=True)
    p = {k: v[0] for k, v in tm.init_params(cfg, 0, device="cpu").params[
        "blocks"]["units"]["0"]["rglru"].items()}
    counts = {}
    for S in (32, 64, 128, 256):
        x = torch.randn(1, S, cfg.d_model).bfloat16()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            trg.rglru_apply(cfg, p, x, mode="full")
        counts[S] = sum(e.count for e in prof.key_averages()
                        if e.key.startswith("aten::"))
    round_ = counts[64] - counts[32]
    assert 0 < round_ <= 24, counts
    assert counts[256] - counts[32] == 3 * round_, counts


# -- the model ----------------------------------------------------------------

@pytest.mark.parametrize("gates", list(GATES))
@pytest.mark.parametrize("kv_quant", [False, True])
def test_forward_prefill_decode(jx, kv_quant, gates):
    """forward (the block-local path: 32 tokens, two windows), prefill and
    per-row decode past the window against the reference; with the bf16
    cache, prefill + decode against the port's own full forward."""
    jnp = jx.jnp
    cj, ct = configs(ARCH, kv_quant=kv_quant, **GATES[gates])
    jp, tp = carried(jx, cj, ct)
    rng = np.random.default_rng(5)
    B, S, n_pre = 2, 32, 12
    toks = rng.integers(0, cj.vocab, (B, S)).astype(np.int32)
    full_j = jx.run(lambda p, t: jx.model.forward(cj, p, {"tokens": t})[0],
                    jp, jnp.asarray(toks))
    full_t, _, aux = tm.forward(ct, tp, {"tokens": toks})
    assert float(aux) == 0.0
    np.testing.assert_allclose(full_t.numpy(), np.asarray(full_j), **TOL)

    jc = jx.model.init_cache(cj, B, 40)
    tc = tm.init_cache(ct, B, 40, device="cpu")
    lj, jc = jx.run(lambda p, t, c: jx.model.prefill(cj, p, {"tokens": t},
                                                     c),
                    jp, jnp.asarray(toks[:, :n_pre]), jc)
    lt, tc = tm.prefill(ct, tp, {"tokens": toks[:, :n_pre]}, tc)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    decode = None
    for t in range(n_pre, S):
        ci = np.full(B, t, np.int32)
        args = (jp, jc, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(ci))
        decode = decode or jx.exact(
            lambda p, c, tk, i: jx.model.decode_step(cj, p, c, tk, i), *args)
        lj, jc = decode(*args)
        lt, tc = tm.decode_step(ct, tp, tc, toks[:, t:t + 1], ci)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        if not kv_quant:
            np.testing.assert_allclose(lt.numpy(), full_t[:, t].numpy(),
                                       **TOL)


def test_mid_stream_cache_carries_across(jx):
    """A cache the reference's prefill filled (attention and recurrent
    leaves), carried across with ``cache_from_numpy``, decodes to the
    reference's logits; so does a cache with recurrent leaves only."""
    jnp = jx.jnp
    for n_layers in (5, 2):
        cj, ct = configs(ARCH, n_layers=n_layers)
        jp, tp = carried(jx, cj, ct, seed=1)
        toks = np.random.default_rng(6).integers(
            0, cj.vocab, (2, 9)).astype(np.int32)
        jc = jx.model.init_cache(cj, 2, 24)
        _, jc = jx.run(lambda p, t, c: jx.model.prefill(
            cj, p, {"tokens": t}, c), jp, jnp.asarray(toks[:, :8]), jc)
        tc = convert.cache_from_numpy(ct, to_np(jc), device="cpu")
        assert ("units" in tc) == (n_layers == 5)
        want, _ = jx.run(lambda p, c, t: jx.model.decode_step(
            cj, p, c, t, 8), jp, jc, jnp.asarray(toks[:, 8:]))
        got, _ = tm.decode_step(ct, tp, tc, toks[:, 8:], 8)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_host_row_positions_past_the_recurrent_cache():
    """Per-row host positions are checked against the attention cache's
    length, not the first cache leaf's (the recurrent ``conv``, 3 wide);
    a model with recurrent layers only has no positions to check."""
    cfg = tget(ARCH, smoke=True)
    lm = tm.init_params(cfg, 0, device="cpu")
    caches = lm.init_cache(2, 16)
    tok = np.zeros((2, 1), np.int32)
    logits, _ = lm.decode_step(caches, tok, np.array([5, 9]))
    assert logits.shape == (2, cfg.vocab)
    with pytest.raises(ValueError, match="outside the cache's 16"):
        lm.decode_step(caches, tok, np.array([5, 16]))
    rec = tm.init_params(dataclasses.replace(cfg, n_layers=2), 0,
                         device="cpu")
    logits, _ = rec.decode_step(rec.init_cache(2, 16), tok,
                                np.array([7, 40]))
    assert logits.shape == (2, cfg.vocab)


# -- serving ----------------------------------------------------------------

@pytest.fixture(scope="module")
def served(jx):
    """(reference namespace for the margin rule, port LM) of
    recurrentgemma smoke on the reference's PRNGKey(0) weights."""
    cj = jx.get_config(ARCH, smoke=True)
    params = jx.model.init_params(cj, jx.jax.random.PRNGKey(0))
    ref = SimpleNamespace(jnp=jx.jnp, model=jx.model, cfg=cj, params=params)
    return ref, convert.params_from_numpy(tget(ARCH, smoke=True),
                                          to_np(params), device="cpu")


def test_generate_greedy_matches_reference(jx, served):
    ref, lm = served
    prompts = np.random.default_rng(0).integers(0, 256, (2, 20),
                                                dtype=np.int32)
    want = jx.engine.generate_greedy(ref.cfg, ref.params, prompts,
                                     max_new=6, max_seq=32)
    got = generate_greedy(lm.cfg, lm, prompts, max_new=6, max_seq=32)
    for p, w, g in zip(prompts, want, got):
        same_stream(ref, p, w, g, "hybrid generate_greedy")


def test_engine_matches_reference(jx, served):
    """Three requests through two slots: each stream equals the reference
    engine's (which folds its neighbours' junk steps into every slot's
    recurrent state; the port does the same)."""
    ref, lm = served
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, n, dtype=np.int32) for n in (5, 9, 4)]
    jreqs = [jx.engine.Request(prompt=p, max_new=6) for p in prompts]
    treqs = [Request(prompt=p, max_new=6) for p in prompts]
    jeng = jx.engine.Engine(ref.cfg, ref.params, max_seq=32, n_slots=2)
    teng = Engine(lm.cfg, lm, max_seq=32, n_slots=2)
    jeng.run(list(jreqs))
    teng.run(list(treqs))
    equal = [same_stream(ref, p, j.out, t.out, "hybrid engine")
             for p, j, t in zip(prompts, jreqs, treqs)]
    if all(equal):
        np.testing.assert_array_equal(teng.slot_pos,
                                      np.asarray(jeng.slot_pos))


def _slot0_logits(eng_cls, req_cls, cfg, params, prompts):
    """Slot 0's logits at its first engine step, with ``prompts[1:]``
    admitted beside it."""
    seen = []

    def sampler(logits):
        seen.append(np.asarray(logits[0], np.float32))
        return (logits.argmax(-1) if isinstance(logits, torch.Tensor)
                else np.asarray(logits).argmax(-1))
    eng = eng_cls(cfg, params, max_seq=32, n_slots=2, sampler=sampler)
    for p in prompts:
        assert eng.add(req_cls(prompt=p, max_new=4))
    eng.step()
    return seen[0]


def test_engine_leaks_recurrent_state_like_the_reference(jx, served):
    """The reference's engine prefills a new request by decoding every
    slot, so a neighbour's admission steps slot 0's recurrent state on
    junk tokens (its attention rows are overwritten later).  Slot 0's
    next logits move with a neighbour admitted, in both packages alike."""
    ref, lm = served
    rng = np.random.default_rng(7)
    a, b = (rng.integers(0, 256, n, dtype=np.int32) for n in (6, 5))
    runs = {}
    for name, eng, req, cfg, params in (
            ("ref", jx.engine.Engine, jx.engine.Request, ref.cfg,
             ref.params),
            ("port", Engine, Request, lm.cfg, lm)):
        runs[name] = (_slot0_logits(eng, req, cfg, params, [a]),
                      _slot0_logits(eng, req, cfg, params, [a, b]))
    for alone, beside in runs.values():
        assert np.abs(alone - beside).max() > 0.1
    for i in range(2):
        np.testing.assert_allclose(runs["port"][i], runs["ref"][i], **TOL)


def test_speculative_matches_reference(jx, served):
    """A motif prompt: the speculative stream and its counts equal the
    reference decoder's (whose verify also folds rejected tokens into the
    recurrent state)."""
    ref, lm = served
    motif = np.random.default_rng(4).integers(0, 256, 6, dtype=np.int32)
    prompt = np.tile(motif, 4)
    out, stats = SpeculativeDecoder(lm.cfg, lm, max_seq=96, k=4).generate(
        prompt, max_new=16)
    jout, jstats = jx.speculative.SpeculativeDecoder(
        ref.cfg, ref.params, max_seq=96, k=4).generate(prompt, max_new=16)
    if same_stream(ref, prompt, jout, out, "hybrid speculative"):
        assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)
    assert stats.proposed > 0


def test_lm_launcher_serves_recurrentgemma(capsys):
    from repro_torch.launch import serve
    got = serve.main(["--workload", "lm", "--arch", ARCH, "--device", "cpu",
                      "--requests", "2", "--max-new", "6"])
    assert got["n_tokens"] == 12
    assert "served 2 requests, 12 tokens" in capsys.readouterr().out


# -- chip_smoke.py phase 10 (r), rehearsed ------------------------------------

def test_chip_smoke_hybrid_phase_rehearses_on_cpu(monkeypatch):
    """Phase 10's hybrid checks at smoke size on the CPU: the block-local
    forward against the windowed prefill, decode past the window, the
    engine against its reduced-depth twin, the speculator up to its first
    rejecting verify."""
    from test_torch_lm_serving import load_chip_smoke
    cs, count = load_chip_smoke(monkeypatch)
    cfg = dataclasses.replace(tget(ARCH, smoke=True), rglru_block_diag=4)
    launches, info = cs.lm_phase(
        [("r", cfg)], zero_counts=lambda: count.update(match_swar=0),
        read_counts=lambda: dict(count), sync=lambda: None, device="cpu",
        profile_step=False)
    out = info["r"]
    assert launches == out["spec_launches"]["match_swar"] > 0
    assert out["err_block_local_vs_scan"]["rel_l2"] <= 3e-2
    assert out["err_decode_past_window"]["rel_l2"] <= 3e-2
    assert out["engine_tokens"] == cs.LM_MR_REQUESTS * cs.LM_MR_NEW
    assert out["engine_twin_ties"] == 0
    assert out["spec_held_tokens"] > 0


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("gates", list(GATES))
def test_card_logits_match_cpu(cuda, gates):
    cfg = dataclasses.replace(tget(ARCH, smoke=True), **GATES[gates])
    cpu = tm.init_params(cfg, 0, device="cpu")
    card = tm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                          device=cuda)
    card.load_state_dict(cpu.state_dict())
    toks = np.random.default_rng(9).integers(0, cfg.vocab,
                                             (2, 40)).astype(np.int32)
    for lm in (cpu, card):
        lm._full = lm.forward({"tokens": toks[:, :32]})[0]
        caches = lm.init_cache(2, 48)
        lm._last = lm.prefill({"tokens": toks[:, :36]}, caches)[0]
        lm._step = lm.decode_step(caches, toks[:, 36:37],
                                  np.array([36, 36]))[0]
    for name in ("_full", "_last", "_step"):
        np.testing.assert_allclose(getattr(card, name).cpu().numpy(),
                                   getattr(cpu, name).numpy(), **TOL)
