"""Encoder-decoder and embeddings-input parity for the PyTorch port:
bidirectional and cross attention, the encoder (``encode``,
``_sinusoid``), whisper-tiny and pixtral-12b against ``repro.models``.

The same numpy inputs and the JAX ``init_params`` tree, carried across
with ``repro_torch.convert.params_from_numpy``, go through both packages,
the port's on ``device="cpu"``; the reference is compiled with
``xla_allow_excess_precision`` off.  Tolerances: whisper's logits and
activations within 4e-2 (``rtol = atol``), as the reference's own
``tests/test_models.py::TestPrefillDecode::test_whisper_encdec_decode``
holds them; pixtral's within the bf16 tolerance of the other LM tests,
3e-2; ``_sinusoid`` bit for bit; ``_sinusoid_at`` within one f32 unit in
the last place of its largest angle (its divisor ``10000 ** (2i / d)`` is
XLA's ``pow``, which rounds apart from torch's at some exponents).  Serving
streams equal the reference's under the margin rule of
``tests/test_torch_lm_serving.py``.

The reference's serving path (``Engine``, ``generate_greedy``, the
speculator) passes tokens only, so whisper's cross-attention layers run
there as causal self-attention over their own cross caches; the port
keeps that (ROADMAP Queue 3), and the encoder-decoder path proper,
``encode`` -> ``prefill({"enc_out", "tokens"})`` -> ``decode_step(...,
enc_out=...)``, is held beside it.

On a card (``-m gpu``): the smoke models' logits on the card against the
CPU.
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
from repro_torch.serving.engine import Engine, Request, generate_greedy
from repro_torch.serving.speculative import SpeculativeDecoder

WHISPER, PIXTRAL = "whisper-tiny", "pixtral-12b"
WTOL = dict(rtol=4e-2, atol=4e-2)


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import layers, model, spec
    from repro.serving import engine, speculative

    def exact(fn, *args):
        return jax.jit(fn).lower(*args).compile(compiler_options={
            "xla_allow_excess_precision": False})

    def run(fn, *args):
        return exact(fn, *args)(*args)
    return SimpleNamespace(jax=jax, jnp=jnp, get_config=get_config,
                           layers=layers, model=model, spec=spec,
                           engine=engine, speculative=speculative,
                           exact=exact, run=run)


def bf16(jx, x):
    return jx.jnp.asarray(x).astype(jx.jnp.bfloat16)


def to_torch(tree):
    """A JAX tree of arrays as torch tensors (bf16 kept), copied."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = to_torch(v)
        elif v.dtype.name == "bfloat16":
            out[k] = torch.from_numpy(np.array(v.astype("float32"))).bfloat16()
        else:
            out[k] = torch.from_numpy(np.array(v))
    return out


def frames(cfg, B, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)


# -- attention ----------------------------------------------------------------

@pytest.mark.parametrize("block", [32, 8])
def test_online_softmax_scan_bidir(jx, block):
    """The unmasked scan, one KV block and four, bit for bit, and against
    a plain softmax."""
    rng = np.random.default_rng(block)
    q = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 2, 32, 16)).astype(np.float32)
            for _ in range(2))
    want = jx.run(lambda q, k, v: jx.layers._online_softmax_scan(
        q, k, v, causal=False, window=None,
        q_offset=jx.jnp.zeros((2,), jx.jnp.int32), block_kv=block,
        bidir=True), bf16(jx, q), bf16(jx, k), bf16(jx, v))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = tl._online_softmax_scan(tq, tk, tv, q_offset=0, block_kv=block,
                                  bidir=True)
    np.testing.assert_array_equal(f32(got), f32(want))
    kk, vv = (t.float().repeat_interleave(2, 1) for t in (tk, tv))
    plain = torch.softmax(tq.float() @ kk.transpose(-1, -2) / 4.0, -1) @ vv
    np.testing.assert_allclose(f32(got), plain.numpy(), **WTOL)


CROSS_BRANCHES = ["bidir", "cross_full", "cross_prefill", "cross_decode",
                  "self_on_xattn_prefill", "self_on_xattn_decode"]


def _cross_case(jx, branch, seed=3):
    """One branch in both packages on whisper smoke's attention: the
    encoder's bidirectional self-attention (QKV bias), cross-attention
    over an encoder output without a cache, writing its cache at 0 and
    decoding against it, and a cross-attention layer without ``xa`` (the
    reference's serving path: causal self-attention over its own cross
    cache, prefill and per-row decode).  Returns (y_jax, y_port,
    cache_jax, cache_port)."""
    cj, ct = configs(WHISPER)
    jnp = jx.jnp
    cross = branch != "bidir"
    jp = jx.spec.initialize(jx.layers.attention_specs(cj, cross=cross),
                            jx.jax.random.PRNGKey(seed))
    jp = {k: v + 0.1 if k.startswith("b") else v for k, v in jp.items()}
    assert ("bq" in jp) == (not cross)
    tp = to_torch(jp)
    rng = np.random.default_rng(seed)
    B, Sx = 2, cj.n_audio_frames
    xa = rng.standard_normal((B, Sx, cj.d_model)).astype(np.float32)
    cspecs = jx.layers.attn_cache_specs(cj, B, Sx)
    jcache = {k: jnp.zeros(s.shape, s.dtype) for k, s in cspecs.items()}
    S, mode, ci, use_xa, jc_ = 6, "full", None, True, None
    if branch == "bidir":
        use_xa = False
    elif branch == "cross_prefill":
        ci, jc_ = 0, jcache
    elif branch == "cross_decode":
        # The cache as a prefill with the encoder output left it.
        _, jc_ = jx.run(lambda p, x, xa, c: jx.layers.attention_apply(
            cj, p, x, positions=None, mode="full", cache=c, cache_index=0,
            xa=xa), jp, bf16(jx, rng.standard_normal(
                (B, 3, cj.d_model))), bf16(jx, xa), jcache)
        S, mode, ci = 1, "decode", np.array([3, 5], np.int32)
    elif branch == "self_on_xattn_prefill":
        S, ci, use_xa, jc_ = 6, 0, False, jcache
    elif branch == "self_on_xattn_decode":
        _, jc_ = jx.run(lambda p, x, c: jx.layers.attention_apply(
            cj, p, x, positions=jnp.broadcast_to(jnp.arange(8)[None],
                                                 (B, 8)),
            mode="full", cache=c, cache_index=0), jp,
            bf16(jx, rng.standard_normal((B, 8, cj.d_model))), jcache)
        S, mode, ci, use_xa = 1, "decode", np.array([8, 5], np.int32), False
    tc_ = None if jc_ is None else to_torch(jc_)
    x = rng.standard_normal((B, S, cj.d_model)).astype(np.float32)
    base = 0 if ci is None else np.asarray(ci).reshape(-1, 1)
    pos = np.broadcast_to(base + np.arange(S)[None], (B, S)).astype(np.int32)
    jxa = bf16(jx, xa) if use_xa else None
    jci = None if ci is None else jnp.asarray(ci)
    yj, cj_out = jx.run(lambda p, x, c, i, pos, xa: jx.layers.attention_apply(
        cj, p, x, positions=pos, mode=mode, cache=c, cache_index=i,
        bidir=branch == "bidir", xa=xa), jp, bf16(jx, x), jc_, jci,
        jnp.asarray(pos), jxa)
    yt, ct_out = tl.attention_apply(
        ct, tp, torch.from_numpy(x).bfloat16(),
        positions=torch.from_numpy(pos), mode=mode, cache=tc_,
        cache_index=ci, bidir=branch == "bidir",
        xa=torch.from_numpy(xa).bfloat16() if use_xa else None)
    return yj, yt, cj_out, ct_out


@pytest.mark.parametrize("branch", CROSS_BRANCHES)
def test_attention_apply_cross_and_bidir(jx, branch):
    yj, yt, cj, ct = _cross_case(jx, branch)
    np.testing.assert_allclose(f32(yt), f32(yj), **WTOL)
    if cj is None:
        assert ct is None
        return
    for k in cj:
        np.testing.assert_allclose(f32(ct[k]), f32(cj[k]), err_msg=k,
                                   **WTOL)


def test_cross_cache_holds_the_encoder_kv(jx):
    """A full-mode call with ``xa`` writes all of the cross cache from
    position 0; without it, only the positions of its own tokens (the
    reference's serving path), in both packages alike."""
    for branch, n in (("cross_prefill", 32), ("self_on_xattn_prefill", 6)):
        _, _, cj, ct = _cross_case(jx, branch)
        got, want = f32(ct["k"]), f32(cj["k"])
        assert (np.abs(want[:, :, :n]).sum(-1) > 0).all()
        assert not want[:, :, n:].any() and not got[:, :, n:].any()
        np.testing.assert_allclose(got, want, **WTOL)


# -- the encoder --------------------------------------------------------------

@pytest.mark.parametrize("seq,d", [(1500, 384), (32, 64)])
def test_sinusoid_bit_for_bit(jx, seq, d):
    np.testing.assert_array_equal(tm._sinusoid(seq, d),
                                  jx.model._sinusoid(seq, d))
    pos = np.random.default_rng(0).integers(0, 2048, (2, 7)).astype(np.int32)
    want = jx.run(lambda p: jx.model._sinusoid_at(p, d), jx.jnp.asarray(pos))
    got = tm._sinusoid_at(torch.from_numpy(pos), d)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=np.spacing(np.float32(pos.max())))


def test_encode_matches_reference(jx):
    cj, ct = configs(WHISPER)
    jp, tp = carried(jx, cj, ct)
    fr = frames(cj, 2)
    want = jx.run(lambda p, f: jx.model.encode(cj, p, f), jp,
                  jx.jnp.asarray(fr))
    got = tp.encode(fr)
    assert got.dtype == torch.bfloat16 and got.shape == fr.shape
    np.testing.assert_allclose(f32(got), f32(want), **WTOL)


def test_param_tree_is_encoder_decoder(jx):
    cj, ct = configs(WHISPER)
    _, tp = carried(jx, cj, ct)
    p = tp.params
    assert set(p) == {"embed", "encoder", "decoder"}
    assert set(p["encoder"]["blocks"]["units"]["0"]) == {"ln1", "attn",
                                                         "ln2", "mlp"}
    dec = p["decoder"]["blocks"]["units"]["0"]
    assert {"lnx", "xattn"} <= set(dec) and "bq" not in dec["xattn"]
    assert "bq" in dec["attn"]
    assert p["encoder"]["blocks"]["units"]["0"]["attn"]["wq"].shape[0] == \
        ct.n_enc_layers


# -- whisper ------------------------------------------------------------------

def test_whisper_encdec_decode(jx):
    """``test_whisper_encdec_decode`` on the port: the first token's
    prefill with ``enc_out`` and decode steps with it reproduce the full
    forward over ``frames``; every step also equals the reference's."""
    jnp = jx.jnp
    cj, ct = configs(WHISPER)
    jp, tp = carried(jx, cj, ct, seed=5)
    B, S = 2, 8
    fr = frames(cj, B, seed=1)
    toks = np.random.default_rng(2).integers(0, cj.vocab,
                                             (B, S)).astype(np.int32)
    full_j = jx.run(lambda p, f, t: jx.model.forward(
        cj, p, {"frames": f, "tokens": t})[0], jp, bf16(jx, fr),
        jnp.asarray(toks))
    full_t, _, _ = tm.forward(ct, tp, {"frames": fr, "tokens": toks})
    np.testing.assert_allclose(full_t.numpy(), np.asarray(full_j), **WTOL)
    enc_j = jx.run(lambda p, f: jx.model.encode(cj, p, f), jp, bf16(jx, fr))
    enc_t = tm.encode(ct, tp, fr)
    jc = jx.model.init_cache(cj, B, S)
    tc = tm.init_cache(ct, B, S, device="cpu")
    lj, jc = jx.run(lambda p, e, t, c: jx.model.prefill(
        cj, p, {"enc_out": e, "tokens": t}, c), jp, enc_j,
        jnp.asarray(toks[:, :1]), jc)
    lt, tc = tm.prefill(ct, tp, {"enc_out": enc_t, "tokens": toks[:, :1]},
                        tc)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **WTOL)
    np.testing.assert_allclose(lt.numpy(), full_t[:, 0].numpy(), **WTOL)
    decode = None
    for t in range(1, S):
        args = (jp, jc, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t), enc_j)
        decode = decode or jx.exact(
            lambda p, c, tk, i, e: jx.model.decode_step(cj, p, c, tk, i, e),
            *args)
        lj, jc = decode(*args)
        lt, tc = tm.decode_step(ct, tp, tc, toks[:, t:t + 1], t,
                                enc_out=enc_t)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **WTOL)
        np.testing.assert_allclose(lt.numpy(), full_t[:, t].numpy(), **WTOL)


def test_whisper_tokens_only_forward_prefill_decode(jx):
    """The reference's serving path: no encoder output, so the cross
    layers attend their own cross caches.  forward, prefill and per-row
    decode against the reference and against the port's own forward."""
    jnp = jx.jnp
    cj, ct = configs(WHISPER)
    jp, tp = carried(jx, cj, ct)
    rng = np.random.default_rng(5)
    B, S, n_pre = 2, 12, 8
    toks = rng.integers(0, cj.vocab, (B, S)).astype(np.int32)
    full_j = jx.run(lambda p, t: jx.model.forward(cj, p, {"tokens": t})[0],
                    jp, jnp.asarray(toks))
    full_t, _, _ = tm.forward(ct, tp, {"tokens": toks})
    np.testing.assert_allclose(full_t.numpy(), np.asarray(full_j), **WTOL)
    jc = jx.model.init_cache(cj, B, 16)
    tc = tm.init_cache(ct, B, 16, device="cpu")
    lj, jc = jx.run(lambda p, t, c: jx.model.prefill(cj, p, {"tokens": t},
                                                     c),
                    jp, jnp.asarray(toks[:, :n_pre]), jc)
    lt, tc = tm.prefill(ct, tp, {"tokens": toks[:, :n_pre]}, tc)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **WTOL)
    decode = None
    for t in range(n_pre, S):
        ci = np.full(B, t, np.int32)
        args = (jp, jc, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(ci))
        decode = decode or jx.exact(
            lambda p, c, tk, i: jx.model.decode_step(cj, p, c, tk, i), *args)
        lj, jc = decode(*args)
        lt, tc = tm.decode_step(ct, tp, tc, toks[:, t:t + 1], ci)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **WTOL)
        np.testing.assert_allclose(lt.numpy(), full_t[:, t].numpy(), **WTOL)


def test_whisper_paths_differ_in_both_packages(jx):
    """Pins the reference's quirk: a decode step without the encoder
    output is another function than with it (the cross layers attend
    their own tokens), in both packages alike."""
    jnp = jx.jnp
    cj, ct = configs(WHISPER)
    jp, tp = carried(jx, cj, ct, seed=2)
    fr = frames(cj, 1, seed=3)
    toks = np.random.default_rng(4).integers(0, cj.vocab,
                                             (1, 5)).astype(np.int32)
    enc_j = jx.run(lambda p, f: jx.model.encode(cj, p, f), jp, bf16(jx, fr))
    enc_t = tm.encode(ct, tp, fr)
    outs = {}
    for with_enc in (True, False):
        def ref(p, t, e):
            c = jx.model.init_cache(cj, 1, 16)
            b = {"tokens": t[:, :4]}
            if e is not None:
                b["enc_out"] = e
            _, c = jx.model.prefill(cj, p, b, c)
            return jx.model.decode_step(cj, p, c, t[:, 4:], 4, e)[0]
        want = jx.run(ref, jp, jnp.asarray(toks),
                      enc_j if with_enc else None)
        c = tm.init_cache(ct, 1, 16, device="cpu")
        b = {"tokens": toks[:, :4]}
        if with_enc:
            b["enc_out"] = enc_t
        tm.prefill(ct, tp, b, c)
        got, _ = tm.decode_step(ct, tp, c, toks[:, 4:], 4,
                                enc_out=enc_t if with_enc else None)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **WTOL)
        outs[with_enc] = (got.numpy(), np.asarray(want))
    for i in range(2):
        assert np.abs(outs[True][i] - outs[False][i]).max() > 0.1


def test_whisper_continuation_with_enc_out(jx):
    """A verify window with the encoder output, at a cache offset, against
    token-by-token decode with it."""
    cj, ct = configs(WHISPER)
    _, tp = carried(jx, cj, ct, seed=6)
    fr = frames(cj, 1, seed=6)
    enc = tm.encode(ct, tp, fr)
    toks = np.random.default_rng(6).integers(0, cj.vocab,
                                             (1, 12)).astype(np.int32)
    c1 = tm.init_cache(ct, 1, 24, device="cpu")
    tm.prefill(ct, tp, {"enc_out": enc, "tokens": toks[:, :8]}, c1)
    win, _, _ = tm.forward(ct, tp, {"enc_out": enc, "tokens": toks[:, 8:]},
                           caches=c1, cache_index=8)
    c2 = tm.init_cache(ct, 1, 24, device="cpu")
    tm.prefill(ct, tp, {"enc_out": enc, "tokens": toks[:, :8]}, c2)
    steps = [tm.decode_step(ct, tp, c2, toks[:, t:t + 1], t, enc_out=enc)[0]
             for t in range(8, 12)]
    np.testing.assert_allclose(win[0].numpy(), torch.cat(steps).numpy(),
                               **WTOL)


def test_host_positions_checked_against_the_written_caches():
    """whisper smoke's caches: self-attention ``max_seq`` (40 here, or 16)
    and cross ``n_audio_frames`` (32).  Per-row host positions are held
    to the caches the call writes: both without an encoder output (the
    cross layers then write their own cache), the self-attention cache
    alone with one."""
    cfg = tget(WHISPER, smoke=True)
    lm = tm.init_params(cfg, 0, device="cpu")
    enc = lm.encode(frames(cfg, 2))
    tok = np.zeros((2, 1), np.int32)
    caches = lm.init_cache(2, 40)
    with pytest.raises(ValueError, match="outside the cache's 32"):
        lm.decode_step(caches, tok, np.array([3, 35]))
    logits, _ = lm.decode_step(caches, tok, np.array([3, 35]), enc_out=enc)
    assert logits.shape == (2, cfg.vocab)
    with pytest.raises(ValueError, match="outside the cache's 40"):
        lm.decode_step(caches, tok, np.array([3, 40]), enc_out=enc)
    small = lm.init_cache(2, 16)
    with pytest.raises(ValueError, match="outside the cache's 16"):
        lm.decode_step(small, tok, np.array([3, 20]))
    logits, _ = lm.decode_step(small, tok, np.array([3, 15]))
    assert logits.shape == (2, cfg.vocab)


def test_whisper_cache_carries_across(jx):
    """A cache the reference's prefill filled with the encoder output,
    ``max_seq`` (24) unlike ``n_audio_frames`` (32), carried across with
    ``cache_from_numpy``, decodes to the reference's logits."""
    jnp = jx.jnp
    cj, ct = configs(WHISPER)
    jp, tp = carried(jx, cj, ct, seed=1)
    fr = frames(cj, 2, seed=7)
    toks = np.random.default_rng(7).integers(0, cj.vocab,
                                             (2, 9)).astype(np.int32)
    enc_j = jx.run(lambda p, f: jx.model.encode(cj, p, f), jp, bf16(jx, fr))
    jc = jx.model.init_cache(cj, 2, 24)
    _, jc = jx.run(lambda p, e, t, c: jx.model.prefill(
        cj, p, {"enc_out": e, "tokens": t}, c), jp, enc_j,
        jnp.asarray(toks[:, :8]), jc)
    tc = convert.cache_from_numpy(ct, to_np(jc), device="cpu")
    unit = tc["units"]["0"]
    assert unit["attn"]["k"].shape[-2] == 24
    assert unit["xattn"]["k"].shape[-2] == 32
    want, _ = jx.run(lambda p, c, t, e: jx.model.decode_step(
        cj, p, c, t, 8, e), jp, jc, jnp.asarray(toks[:, 8:]), enc_j)
    got, _ = tm.decode_step(ct, tp, tc, toks[:, 8:], 8,
                            enc_out=tm.encode(ct, tp, fr))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **WTOL)


# -- pixtral: embeddings input ---------------------------------------------

def embeds(cfg, B, S, seed=0):
    """Seeded stand-ins for the stub vision frontend's embeddings, at the
    token table's scale."""
    return (np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)) / np.sqrt(cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_embeds_forward_prefill_decode(jx, kv_quant):
    """forward over embeddings, a prefill of embeddings and token decode
    steps against the reference; with the bf16 cache, the steps against
    one forward over the embeddings with the decoded tokens' embedding
    rows appended (each cast to bf16 as ``forward`` casts it)."""
    jnp = jx.jnp
    cj, ct = configs(PIXTRAL, kv_quant=kv_quant)
    jp, tp = carried(jx, cj, ct)
    B, n_pre, n_dec = 2, 10, 4
    em = embeds(cj, B, n_pre)
    toks = np.random.default_rng(1).integers(0, cj.vocab,
                                             (B, n_dec)).astype(np.int32)
    full_j = jx.run(lambda p, e: jx.model.forward(cj, p, {"embeds": e})[0],
                    jp, jnp.asarray(em))
    full_t, _, _ = tm.forward(ct, tp, {"embeds": em})
    np.testing.assert_allclose(full_t.numpy(), np.asarray(full_j), **TOL)
    jc = jx.model.init_cache(cj, B, 32)
    tc = tm.init_cache(ct, B, 32, device="cpu")
    lj, jc = jx.run(lambda p, e, c: jx.model.prefill(cj, p, {"embeds": e},
                                                     c),
                    jp, jnp.asarray(em), jc)
    lt, tc = tm.prefill(ct, tp, {"embeds": em}, tc)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    steps = [lt]
    for t in range(n_dec - 1):
        args = (jp, jc, jnp.asarray(toks[:, t:t + 1]), n_pre + t)
        lj, jc = jx.run(lambda p, c, tk, i: jx.model.decode_step(
            cj, p, c, tk, i), *args)
        lt, tc = tm.decode_step(ct, tp, tc, toks[:, t:t + 1], n_pre + t)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        steps.append(lt)
    rows = tp.params["embed"][torch.from_numpy(toks[:, :-1]).long()]
    joined = torch.cat([torch.from_numpy(em).bfloat16(),
                        rows.bfloat16()], 1)
    full, _, _ = tm.forward(ct, tp, {"embeds": joined})
    if not kv_quant:    # the int8 cache is lossy against full
        np.testing.assert_allclose(torch.stack(steps, 1).numpy(),
                                   full[:, n_pre - 1:].numpy(), **TOL)


def test_embeds_only_for_embeddings_models(jx):
    """``embeds`` feeds a model whose ``input_mode`` is "embeddings"; a
    token model ignores the key and reads its tokens, as the reference
    does."""
    jnp = jx.jnp
    cj, ct = configs("llama3.2-1b")
    jp, tp = carried(jx, cj, ct)
    toks = np.random.default_rng(2).integers(0, cj.vocab,
                                             (1, 6)).astype(np.int32)
    em = embeds(cj, 1, 6)
    want = jx.run(lambda p, t, e: jx.model.forward(
        cj, p, {"tokens": t, "embeds": e})[0], jp, jnp.asarray(toks),
        jnp.asarray(em))
    got, _, _ = tm.forward(ct, tp, {"tokens": toks, "embeds": em})
    plain, _, _ = tm.forward(ct, tp, {"tokens": toks})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.equal(got, plain)


# -- serving ----------------------------------------------------------------

@pytest.fixture(scope="module", params=[WHISPER, PIXTRAL])
def served(jx, request):
    """(reference namespace for the margin rule, port LM) of the smoke
    arch on the reference's PRNGKey(0) weights."""
    arch = request.param
    cj = jx.get_config(arch, smoke=True)
    params = jx.model.init_params(cj, jx.jax.random.PRNGKey(0))
    ref = SimpleNamespace(jnp=jx.jnp, model=jx.model, cfg=cj, params=params)
    return ref, convert.params_from_numpy(tget(arch, smoke=True),
                                          to_np(params), device="cpu")


def test_generate_greedy_matches_reference(jx, served):
    ref, lm = served
    prompts = np.random.default_rng(0).integers(0, 256, (2, 10),
                                                dtype=np.int32)
    want = jx.engine.generate_greedy(ref.cfg, ref.params, prompts,
                                     max_new=6, max_seq=24)
    got = generate_greedy(lm.cfg, lm, prompts, max_new=6, max_seq=24)
    for p, w, g in zip(prompts, want, got):
        same_stream(ref, p, w, g, f"{lm.cfg.name} generate_greedy")


def test_engine_matches_reference_and_generate(jx, served):
    """Three requests through two slots: each stream equals the reference
    engine's and the port's own ``generate_greedy`` (whisper's cross
    layers attend their own caches there, which a later write overwrites
    and the causal mask hides meanwhile, as for self-attention)."""
    ref, lm = served
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, n, dtype=np.int32) for n in (5, 9, 4)]
    jreqs = [jx.engine.Request(prompt=p, max_new=6) for p in prompts]
    treqs = [Request(prompt=p, max_new=6) for p in prompts]
    jeng = jx.engine.Engine(ref.cfg, ref.params, max_seq=24, n_slots=2)
    teng = Engine(lm.cfg, lm, max_seq=24, n_slots=2)
    jeng.run(list(jreqs))
    teng.run(list(treqs))
    what = f"{lm.cfg.name} engine"
    equal = [same_stream(ref, p, j.out, t.out, what)
             for p, j, t in zip(prompts, jreqs, treqs)]
    if all(equal):
        np.testing.assert_array_equal(teng.slot_pos,
                                      np.asarray(jeng.slot_pos))
    for p, t in zip(prompts, treqs):
        g = generate_greedy(lm.cfg, lm, p[None], max_new=6, max_seq=24)[0]
        same_stream(ref, p, g, t.out, f"{what} vs generate_greedy")


def test_speculative_matches_reference(jx, served):
    ref, lm = served
    motif = np.random.default_rng(4).integers(0, 256, 6, dtype=np.int32)
    prompt = np.tile(motif, 3)
    out, stats = SpeculativeDecoder(lm.cfg, lm, max_seq=64, k=4).generate(
        prompt, max_new=16)
    jout, jstats = jx.speculative.SpeculativeDecoder(
        ref.cfg, ref.params, max_seq=64, k=4).generate(prompt, max_new=16)
    if same_stream(ref, prompt, jout, out, f"{lm.cfg.name} speculative"):
        assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)
    # Greedy equivalence on the port's own path.
    g = generate_greedy(lm.cfg, lm, prompt[None], max_new=16, max_seq=64)[0]
    same_stream(ref, prompt, g, out, f"{lm.cfg.name} speculative vs greedy")


# -- chip_smoke.py phase 10 (w) and (p), rehearsed ----------------------------

def test_chip_smoke_encdec_and_embeds_phase_rehearses_on_cpu(monkeypatch):
    """Phase 10's whisper and pixtral checks at smoke size on the CPU:
    encode, prefill with the encoder output + decode against the forward
    over frames, prefill of embeddings + token decode against the forward
    over the joined embeddings, and the token path's streams."""
    from test_torch_lm_serving import load_chip_smoke
    cs, count = load_chip_smoke(monkeypatch)
    pix = dataclasses.replace(tget(PIXTRAL, smoke=True), kv_quant=True,
                              param_dtype="bf16", n_kv_heads=4)
    # Frames past the cut LM_MAX_SEQ, as the full width's 1,500 are past
    # its 512: the token path's cross caches then hold every position.
    whisper = dataclasses.replace(tget(WHISPER, smoke=True),
                                  n_audio_frames=128)
    launches, info = cs.lm_phase(
        [("w", whisper), ("p", pix)],
        zero_counts=lambda: count.update(match_swar=0),
        read_counts=lambda: dict(count), sync=lambda: None, device="cpu",
        profile_step=False)
    assert launches == sum(v["spec_launches"]["match_swar"]
                           for v in info.values()) > 0
    for out in info.values():
        assert out["err_prefill_decode"]["rel_l2"] <= 3e-2
        assert out["err_verify"]["rel_l2"] <= 3e-2
        assert out["engine_ties"] == 0 and not out["spec_tie"]
    assert info["w"]["encode_shape"] == [cs.LM_PROMPTS, 128, 64]


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_whisper_logits_match_cpu(cuda):
    cfg = tget(WHISPER, smoke=True)
    cpu = tm.init_params(cfg, 0, device="cpu")
    card = tm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                          device=cuda)
    card.load_state_dict(cpu.state_dict())
    fr = frames(cfg, 2)
    toks = np.random.default_rng(9).integers(0, cfg.vocab,
                                             (2, 10)).astype(np.int32)
    for lm in (cpu, card):
        enc = lm.encode(fr)
        lm._full = lm.forward({"frames": fr, "tokens": toks})[0]
        caches = lm.init_cache(2, 16)
        lm._last = lm.prefill({"enc_out": enc, "tokens": toks[:, :8]},
                              caches)[0]
        lm._step = lm.decode_step(caches, toks[:, 8:9], np.array([8, 8]),
                                  enc_out=enc)[0]
    for name in ("_full", "_last", "_step"):
        np.testing.assert_allclose(getattr(card, name).cpu().numpy(),
                                   getattr(cpu, name).numpy(), **WTOL)


@pytest.mark.gpu
def test_card_pixtral_logits_match_cpu(cuda):
    cfg = tget(PIXTRAL, smoke=True)
    cpu = tm.init_params(cfg, 0, device="cpu")
    card = tm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                          device=cuda)
    card.load_state_dict(cpu.state_dict())
    em = embeds(cfg, 2, 8)
    toks = np.random.default_rng(9).integers(0, cfg.vocab,
                                             (2, 1)).astype(np.int32)
    for lm in (cpu, card):
        lm._full = lm.forward({"embeds": em})[0]
        caches = lm.init_cache(2, 16)
        lm._last = lm.prefill({"embeds": em}, caches)[0]
        lm._step = lm.decode_step(caches, toks, np.array([8, 8]))[0]
    for name in ("_full", "_last", "_step"):
        np.testing.assert_allclose(getattr(card, name).cpu().numpy(),
                                   getattr(cpu, name).numpy(), **TOL)
