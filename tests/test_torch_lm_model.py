"""LM model parity for the PyTorch port: ``repro_torch.models`` and
``repro_torch.configs`` against ``repro.models`` / ``repro.configs``.

The same numpy inputs and the JAX ``init_params(cfg, PRNGKey(s))`` tree,
carried across with ``repro_torch.convert.params_from_numpy``, go through
both packages, the port's on ``device="cpu"``.  Tolerance is the
reference's own for bf16 logits and activations (``rtol=3e-2,
atol=3e-2``, as ``tests/test_models.py`` and ``tests/test_speculative.py``
hold the reference); int8 cache values and every config field are exact.

The reference is compiled with XLA's ``xla_allow_excess_precision``
off (``jx.run``): its code with every casting point as written, equal to
running it op by op.  With that option on (the default) XLA may keep a
fused bf16 intermediate in f32, so the default-compiled reference differs
from its own op-by-op result by up to ~0.04 in smoke logits; against the
exact reference the port agrees to the last bit or close to it.

On a card (``-m gpu``): the smoke model's logits on the card against the
same port code on the CPU.  JAX is imported inside a fixture: the machine
with the card has no JAX and collects this file for its ``gpu`` tests
alone.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import ARCHS
from repro_torch.configs import get_config as tget
from repro_torch.models import layers as tl
from repro_torch.models import model as tm
from repro_torch.models import spec as tspec

TOL = dict(rtol=3e-2, atol=3e-2)
# pixtral's stack is dense; its embeddings input is held in
# tests/test_torch_lm_encdec.py.
DENSE = ["llama3.2-1b", "stablelm-3b", "qwen1.5-32b", "internlm2-20b",
         "pixtral-12b"]
PORTED = list(ARCHS)
# The reference's own counts at full width (``n_params``), and pixtral's
# serving deployment (KV heads padded 8 -> 16).
FULL_COUNTS = {("mamba2-130m", ""): 128_946_624,
               ("whisper-tiny", ""): 36_475_392,
               ("pixtral-12b", ""): 12_247_782_400,
               ("pixtral-12b", "serve"): 12_667_212_800}
VARIANTS = {"smoke": dict(smoke=True), "full": dict(),
            "train": dict(optimized=True, kind="train"),
            "serve": dict(optimized=True, kind="serve")}


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import layers, model, spec

    def exact(fn, *args):
        """``fn`` compiled for ``args``' shapes with every bf16 rounding
        kept."""
        return jax.jit(fn).lower(*args).compile(compiler_options={
            "xla_allow_excess_precision": False})

    def run(fn, *args):
        return exact(fn, *args)(*args)
    return SimpleNamespace(jax=jax, jnp=jnp, get_config=get_config,
                           layers=layers, model=model, spec=spec,
                           exact=exact, run=run)


def configs(arch, kv_quant=False, **kw):
    """(JAX config, port config) of the smoke arch, both replaced alike."""
    from repro.configs import get_config
    kw = dict(kv_quant=kv_quant, **kw)
    return (dataclasses.replace(get_config(arch, smoke=True), **kw),
            dataclasses.replace(tget(arch, smoke=True), **kw))


def to_np(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def f32(x):
    """A JAX or torch array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype("float32"))


def carried(jx, cfg_j, cfg_t, seed=0):
    jp = jx.model.init_params(cfg_j, jx.jax.random.PRNGKey(seed))
    return jp, convert.params_from_numpy(cfg_t, to_np(jp), device="cpu")


# -- configs ------------------------------------------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_get_config_matches_reference(jx, arch, variant):
    kw = VARIANTS[variant]
    want = dataclasses.asdict(jx.get_config(arch, **kw))
    assert dataclasses.asdict(tget(arch, **kw)) == want


def test_unknown_arch_is_refused():
    with pytest.raises(KeyError, match="unknown arch"):
        tget("gpt-5")


@pytest.mark.parametrize("arch", PORTED)
def test_n_params_matches_reference(jx, arch):
    for kw in (dict(), dict(optimized=True, kind="serve")):
        assert tget(arch, **kw).n_params() == jx.get_config(
            arch, **kw).n_params()
        assert tget(arch, **kw).n_active_params() == jx.get_config(
            arch, **kw).n_active_params()
    if arch in DENSE:
        assert tget(arch).n_active_params() == tget(arch).n_params()
    for (name, kind), n in FULL_COUNTS.items():
        if name == arch:
            kw = dict(optimized=True, kind=kind) if kind else dict()
            assert tget(arch, **kw).n_params() == n


def test_moe_and_hybrid_full_width_counts():
    """The reference's own counts at full width, the serving deployments'
    too (recurrentgemma's block-diagonal gates are smaller)."""
    serve = dict(optimized=True, kind="serve")
    assert tget("olmoe-1b-7b", **serve).n_params() == 6_919_096_320
    assert tget("recurrentgemma-9b").n_params() == 7_484_321_792
    assert tget("recurrentgemma-9b", **serve).n_params() == 6_666_432_512
    assert tget("olmoe-1b-7b").n_active_params() == 1_281_951_744


def test_llama_full_width_counts():
    cfg = tget("llama3.2-1b")
    assert (cfg.n_layers, cfg.d_model, cfg.padded_heads,
            cfg.padded_kv_heads, cfg.head_dim, cfg.d_ff,
            cfg.padded_vocab) == (16, 2048, 32, 8, 64, 8192, 128_256)
    assert cfg.tie_embeddings and cfg.rope_theta == 500_000.0
    serve = tget("llama3.2-1b", optimized=True, kind="serve")
    assert serve.padded_kv_heads == 16 and serve.kv_quant
    assert serve.param_dtype == "bf16"
    assert 1.2e9 < cfg.n_params() < 1.3e9


# -- specs and initialisation ------------------------------------------------

def test_param_tree_matches_reference_leaf_for_leaf(jx):
    for arch in PORTED:
        for kw in (dict(smoke=True), dict(optimized=True, kind="serve")):
            cj, ct = jx.get_config(arch, **kw), tget(arch, **kw)
            want = jx.spec.abstract(jx.model.param_specs(cj))
            flat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
                    for path, leaf in
                    jx.jax.tree_util.tree_flatten_with_path(want)[0]}
            got = dict(tspec.leaves(tm.param_specs(ct)))
            assert set(got) == set(flat)
            for path, s in got.items():
                assert s.shape == flat[path].shape, path
                assert str(s.dtype).split(".")[-1] == flat[path].dtype.name


def test_init_params_is_seeded_and_follows_the_init_rules():
    cfg = tget("llama3.2-1b", smoke=True)
    a = tm.init_params(cfg, 3, device="cpu")
    b = tm.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    c = tm.init_params(cfg, 4, device="cpu")
    for (n, x), (_, y), (_, z) in zip(a.named_parameters(),
                                      b.named_parameters(),
                                      c.named_parameters()):
        assert torch.equal(x, y), n
        assert not x.requires_grad
    p = a.params
    assert torch.equal(p["ln_f"]["scale"], torch.ones(cfg.d_model))
    wq = p["blocks"]["units"]["0"]["attn"]["wq"]
    assert wq.shape == (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim)
    # fan_in: every dim but the last (the stacked and head dims too).
    fan_in = cfg.n_layers * cfg.d_model * cfg.n_heads
    assert abs(wq.std().item() * fan_in ** 0.5 - 1) < 0.1
    assert not torch.equal(p["embed"], c.params["embed"])
    bf = tm.init_params(dataclasses.replace(cfg, param_dtype="bf16"),
                        device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in bf.parameters())


def test_params_from_numpy_checks_the_tree(jx):
    cj, ct = configs("llama3.2-1b")
    tree = to_np(jx.model.init_params(cj, jx.jax.random.PRNGKey(0)))
    lm = convert.params_from_numpy(ct, tree, device="cpu")
    assert torch.equal(lm.params["embed"], torch.from_numpy(tree["embed"]))
    bad = dict(tree, embed=tree["embed"][:-1])
    with pytest.raises(ValueError, match="embed: shape"):
        convert.params_from_numpy(ct, bad, device="cpu")
    bad = dict(tree, embed=tree["embed"].astype(np.float16))
    with pytest.raises(ValueError, match="embed: dtype"):
        convert.params_from_numpy(ct, bad, device="cpu")
    bad = {k: v for k, v in tree.items() if k != "ln_f"}
    with pytest.raises(ValueError, match="missing"):
        convert.params_from_numpy(ct, bad, device="cpu")


def test_params_from_numpy_carries_bf16(jx):
    cj = jx.get_config("llama3.2-1b", smoke=True)
    cj = dataclasses.replace(cj, param_dtype="bf16")
    ct = dataclasses.replace(tget("llama3.2-1b", smoke=True),
                             param_dtype="bf16")
    tree = to_np(jx.model.init_params(cj, jx.jax.random.PRNGKey(1)))
    lm = convert.params_from_numpy(ct, tree, device="cpu")
    assert lm.params["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(lm.params["embed"].float().numpy(),
                                  tree["embed"].astype(np.float32))


# -- layers -------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3.2-1b", "stablelm-3b"])
def test_apply_norm(jx, arch):
    cj, ct = configs(arch)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, cj.d_model)).astype(np.float32) * 3
    p = {"scale": (1 + 0.1 * rng.standard_normal(cj.d_model)).astype(
        np.float32), "bias": rng.standard_normal(cj.d_model).astype(
        np.float32)}
    if cj.norm == "rms":
        del p["bias"]
    want = jx.layers.apply_norm(cj, {k: jx.jnp.asarray(v)
                                     for k, v in p.items()},
                                jx.jnp.asarray(x).astype(jx.jnp.bfloat16))
    got = tl.apply_norm(ct, {k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), **TOL)


@pytest.mark.parametrize("theta", [1e4, 500_000.0, 0.0])
def test_apply_rope(jx, theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 9, 16)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 9)).astype(np.int32)
    want = jx.layers.apply_rope(jx.jnp.asarray(x).astype(jx.jnp.bfloat16),
                                jx.jnp.asarray(pos), theta)
    got = tl.apply_rope(torch.from_numpy(x).bfloat16(),
                        torch.from_numpy(pos), theta)
    np.testing.assert_allclose(f32(got), f32(want), **TOL)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "stablelm-3b"])
def test_mlp_apply(jx, arch):
    cj, ct = configs(arch)
    jp = jx.spec.initialize(jx.layers.mlp_specs(cj),
                            jx.jax.random.PRNGKey(2))
    jp = {k: v + 0.1 if k.startswith("b") else v for k, v in jp.items()}
    x = np.random.default_rng(2).standard_normal(
        (2, 5, cj.d_model)).astype(np.float32)
    want = jx.layers.mlp_apply(cj, jp, jx.jnp.asarray(x).astype(
        jx.jnp.bfloat16))
    got = tl.mlp_apply(ct, {k: torch.from_numpy(np.array(v))
                            for k, v in jp.items()},
                       torch.from_numpy(x).bfloat16())
    np.testing.assert_allclose(f32(got), f32(want), **TOL)


def test_kv_quantize_is_exact(jx):
    x = np.random.default_rng(3).standard_normal((2, 3, 7, 16)).astype(
        np.float32)
    x[0, 0, 0] = 0.0                                 # the 1e-8 floor
    jq, js = jx.run(jx.layers._kv_quantize,
                    jx.jnp.asarray(x).astype(jx.jnp.bfloat16))
    tq, ts = tl._kv_quantize(torch.from_numpy(x).bfloat16())
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


ATTN_BRANCHES = ["full", "prefill", "continuation", "decode_scalar",
                 "decode_rows"]


def _attn_case(jx, arch, kv_quant, branch, seed=4):
    """Run one attention branch in both packages; returns (y_jax, y_port,
    cache_jax, cache_port)."""
    cj, ct = configs(arch, kv_quant=kv_quant)
    jnp = jx.jnp
    jp = jx.spec.initialize(jx.layers.attention_specs(cj),
                            jx.jax.random.PRNGKey(seed))
    # Non-zero biases so the bias branch shows.
    jp = {k: v + 0.1 * jx.jax.random.normal(jx.jax.random.PRNGKey(9),
                                            v.shape)
          if k.startswith("b") else v for k, v in jp.items()}
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(seed)
    B, S, S_max = 2, 6, 32
    # A cache holding 10 positions of context (as a prefill leaves it).
    ctx = rng.standard_normal((B, 10, cj.d_model)).astype(np.float32)
    cspecs = jx.layers.attn_cache_specs(cj, B, S_max)
    jcache = {k: jnp.zeros(s.shape, s.dtype) for k, s in cspecs.items()}
    _, jcache = jx.run(lambda p, x, c: jx.layers.attention_apply(
        cj, p, x, positions=jnp.broadcast_to(jnp.arange(10)[None], (B, 10)),
        mode="full", cache=c, cache_index=0), jp,
        jnp.asarray(ctx).astype(jnp.bfloat16), jcache)
    tcache = {k: torch.from_numpy(np.array(v).astype(np.float32)).to(
        torch.bfloat16) if v.dtype == jnp.bfloat16 else torch.from_numpy(
        np.array(v)) for k, v in jcache.items()}
    if branch == "full":
        jc_, tc_, ci, S_ = None, None, None, S
    elif branch == "prefill":
        jcache = {k: jnp.zeros_like(v) for k, v in jcache.items()}
        tcache = {k: torch.zeros_like(v) for k, v in tcache.items()}
        jc_, tc_, ci, S_ = jcache, tcache, 0, S
    elif branch == "continuation":
        jc_, tc_, ci, S_ = jcache, tcache, 10, S
    elif branch == "decode_scalar":
        jc_, tc_, ci, S_ = jcache, tcache, 10, 1
    else:
        jc_, tc_, ci, S_ = jcache, tcache, np.array([10, 7], np.int32), 1
    x = rng.standard_normal((B, S_, cj.d_model)).astype(np.float32)
    if ci is None:
        pos = np.broadcast_to(np.arange(S_)[None], (B, S_))
    else:
        pos = np.asarray(ci).reshape(-1, 1) + np.arange(S_)[None]
        pos = np.broadcast_to(pos, (B, S_))
    pos = pos.astype(np.int32)
    mode = "decode" if branch.startswith("decode") else "full"
    jci = None if ci is None else jnp.asarray(ci)
    yj, cj_out = jx.run(lambda p, x, c, i: jx.layers.attention_apply(
        cj, p, x, positions=jnp.asarray(pos), mode=mode, cache=c,
        cache_index=i), jp, jnp.asarray(x).astype(jnp.bfloat16), jc_, jci)
    yt, ct_out = tl.attention_apply(
        ct, tp, torch.from_numpy(x).bfloat16(),
        positions=torch.from_numpy(pos), mode=mode, cache=tc_,
        cache_index=ci)
    return yj, yt, cj_out, ct_out


@pytest.mark.parametrize("branch", ATTN_BRANCHES)
@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen1.5-32b"])
def test_attention_apply(jx, arch, kv_quant, branch):
    """Every ported branch; qwen carries the QKV bias, llama GQA."""
    yj, yt, cj, ct = _attn_case(jx, arch, kv_quant, branch)
    np.testing.assert_allclose(f32(yt), f32(yj), **TOL)
    if cj is None:
        assert ct is None
        return
    assert set(ct) == set(cj)
    for k in cj:
        want = np.asarray(cj[k])
        if want.dtype == np.int8:
            np.testing.assert_array_equal(ct[k].numpy(), want, err_msg=k)
        else:
            np.testing.assert_allclose(f32(ct[k]), want.astype(np.float32),
                                       err_msg=k, **TOL)


def test_full_mode_refuses_per_row_offsets():
    cfg = tget("llama3.2-1b", smoke=True)
    lm = tm.init_params(cfg, 0, device="cpu")
    caches = lm.init_cache(2, 16)
    with pytest.raises(ValueError, match="per-row"):
        lm.forward({"tokens": np.zeros((2, 3), np.int32)}, caches=caches,
                   cache_index=np.array([1, 2]))


def test_decode_refuses_host_positions_outside_the_cache():
    """The reference drops a per-row write past the cache (and decodes on
    a stale row); the port refuses host positions outside it."""
    cfg = tget("llama3.2-1b", smoke=True)
    lm = tm.init_params(cfg, 0, device="cpu")
    caches = lm.init_cache(2, 8)
    tok = np.zeros((2, 1), np.int32)
    for bad in ([3, 8], [-1, 0]):
        with pytest.raises(ValueError, match="outside the cache"):
            lm.decode_step(caches, tok, np.array(bad))
    logits, _ = lm.decode_step(caches, tok, np.array([3, 7]))
    assert logits.shape == (2, cfg.vocab)


# -- the model ----------------------------------------------------------------

@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_prefill_decode(jx, arch, kv_quant):
    """forward, prefill and per-row decode against the reference; and,
    with the bf16 cache, prefill + decode against the port's own full
    forward (the reference's ``test_prefill_plus_decode_equals_full``)."""
    jnp = jx.jnp
    cj, ct = configs(arch, kv_quant=kv_quant)
    jp, tp = carried(jx, cj, ct)
    rng = np.random.default_rng(5)
    B, S, n_pre = 2, 12, 8
    toks = rng.integers(0, cj.vocab, (B, S)).astype(np.int32)
    full_j = jx.run(lambda p, t: jx.model.forward(cj, p, {"tokens": t})[0],
                    jp, jnp.asarray(toks))
    full_t, caches_none, _ = tm.forward(ct, tp, {"tokens": toks})
    assert caches_none is None and full_t.dtype == torch.float32
    np.testing.assert_allclose(full_t.numpy(), np.asarray(full_j), **TOL)

    jc = jx.model.init_cache(cj, B, 32)
    tc = tm.init_cache(ct, B, 32, device="cpu")
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
        if not kv_quant:    # the int8 cache is lossy against full
            np.testing.assert_allclose(lt.numpy(), full_t[:, t].numpy(),
                                       **TOL)


def test_mid_stream_cache_carries_across(jx):
    """A cache the reference's prefill filled, carried across with
    ``cache_from_numpy``, decodes to the reference's logits."""
    jnp = jx.jnp
    for kv_quant in (False, True):
        cj, ct = configs("llama3.2-1b", kv_quant=kv_quant)
        jp, tp = carried(jx, cj, ct, seed=1)
        toks = np.random.default_rng(6).integers(
            0, cj.vocab, (2, 9)).astype(np.int32)
        jc = jx.model.init_cache(cj, 2, 16)
        _, jc = jx.run(lambda p, t, c: jx.model.prefill(
            cj, p, {"tokens": t}, c), jp, jnp.asarray(toks[:, :8]), jc)
        tc = convert.cache_from_numpy(ct, to_np(jc), device="cpu")
        want, _ = jx.run(lambda p, c, t: jx.model.decode_step(
            cj, p, c, t, 8), jp, jc, jnp.asarray(toks[:, 8:]))
        got, _ = tm.decode_step(ct, tp, tc, toks[:, 8:], 8)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="shape"):
        bad = to_np(jc)
        bad["units"]["0"]["attn"]["k_scale"] = bad["units"]["0"]["attn"][
            "k_scale"][..., :-1]
        convert.cache_from_numpy(ct, bad, device="cpu")


def test_chunked_continuation_attention(jx):
    """``tests/test_speculative.py``'s case on the port: the verify path
    (a window forward at a cache offset) equals the full forward's logits
    for the same positions, and the reference's verify logits."""
    jnp = jx.jnp
    for kv_quant in (False, True):
        cj, ct = configs("llama3.2-1b", kv_quant=kv_quant)
        jp, tp = carried(jx, cj, ct)
        S_pre, W = 10, 4
        tokens = np.random.default_rng(2).integers(
            0, cj.vocab, (1, S_pre + W))
        full, _, _ = tm.forward(ct, tp, {"tokens": tokens})
        caches = tm.init_cache(ct, 1, 64, device="cpu")
        _, caches = tm.prefill(ct, tp, {"tokens": tokens[:, :S_pre]}, caches)
        logits, _, _ = tm.forward(ct, tp, {"tokens": tokens[:, S_pre:]},
                                  mode="full", caches=caches,
                                  cache_index=S_pre)
        np.testing.assert_allclose(logits.numpy(),
                                   full[:, S_pre:].numpy(), **TOL)

        def verify(p, t):
            c = jx.model.init_cache(cj, 1, 64)
            _, c = jx.model.prefill(cj, p, {"tokens": t[:, :S_pre]}, c)
            return jx.model.forward(cj, p, {"tokens": t[:, S_pre:]},
                                    mode="full", caches=c,
                                    cache_index=S_pre)[0]
        want = jx.run(verify, jp, jnp.asarray(tokens))
        np.testing.assert_allclose(logits.numpy(), np.asarray(want), **TOL)


def test_stacked_units_and_rest_layout(jx):
    """A depth that is not a multiple of the unit runs the remainder
    unrolled, as the reference does (a two-kind pattern of ``attn``)."""
    jnp = jx.jnp
    kw = dict(n_layers=3, block_pattern=("attn", "attn"))
    cj, ct = configs("llama3.2-1b", **kw)
    jp, tp = carried(jx, cj, ct, seed=2)
    assert set(tp.params["blocks"]) == {"units", "rest"}
    toks = np.random.default_rng(8).integers(0, cj.vocab,
                                             (1, 7)).astype(np.int32)
    want = jx.run(lambda p, t: jx.model.forward(cj, p, {"tokens": t})[0],
                  jp, jnp.asarray(toks))
    got, _, _ = tm.forward(ct, tp, {"tokens": toks})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jc = jx.model.init_cache(cj, 1, 16)
    tc = convert.cache_from_numpy(ct, to_np(jc), device="cpu")
    lj, jc = jx.run(lambda p, t, c: jx.model.prefill(cj, p, {"tokens": t},
                                                     c),
                    jp, jnp.asarray(toks), jc)
    lt, tc = tm.prefill(ct, tp, {"tokens": toks}, tc)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(
        tc["rest"]["0"]["attn"]["k"].float().numpy(),
        np.asarray(jc["rest"]["0"]["attn"]["k"]).astype(np.float32), **TOL)


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kv_quant", [False, True])
def test_card_logits_match_cpu(cuda, kv_quant):
    cfg = dataclasses.replace(tget("llama3.2-1b", smoke=True),
                              kv_quant=kv_quant)
    cpu = tm.init_params(cfg, 0, device="cpu")
    card = convert.params_from_numpy(cfg, _tree_np(cpu), device=cuda)
    toks = np.random.default_rng(9).integers(0, cfg.vocab,
                                             (2, 10)).astype(np.int32)
    for lm in (cpu, card):
        caches = lm.init_cache(2, 32)
        lm._last = lm.prefill({"tokens": toks[:, :8]}, caches)[0]
        lm._step = lm.decode_step(caches, toks[:, 8:9],
                                  np.array([8, 8]))[0]
    np.testing.assert_allclose(card._last.cpu().numpy(),
                               cpu._last.numpy(), **TOL)
    np.testing.assert_allclose(card._step.cpu().numpy(),
                               cpu._step.numpy(), **TOL)


def _tree_np(lm):
    def walk(node):
        if isinstance(node, torch.Tensor):
            return node.detach().cpu().numpy()
        return {k: walk(v) for k, v in node.items()}
    return walk(lm.params)
