"""SSD (Mamba-2) parity for the PyTorch port: ``repro_torch.models.ssm``
and mamba2-130m against ``repro.models``.

The same numpy inputs and the JAX ``init_params`` tree, carried across
with ``repro_torch.convert.params_from_numpy``, go through both packages,
the port's on ``device="cpu"``; the reference is compiled with
``xla_allow_excess_precision`` off.  Tolerances:

* the reference's bf16 tolerance on logits and block outputs (``rtol =
  atol = 3e-2``);
* the SSD core, f32, within 2e-3: a decode step's state, and the final
  state of the chunked form (the reference's taken from its chunk
  ``lax.scan``, run op by op; the port's from ``_ssd_chunked``), whose
  inter-chunk recurrence the port sums in closed form;
* the chunked form against the sequential recurrence of
  ``tests/test_models.py::TestSSD._naive_ssd`` as a relative L2 error
  within 5e-3 (the intra-chunk product and the chunk states are bf16 in
  both packages, so a few outputs miss that test's elementwise 2e-2);
* a state the reference stores in bf16 (after a full-mode call) within
  one bf16 unit in the last place of it (``rtol=2**-7``): the two f32
  states before the rounding differ in the last f32 bits.

Serving streams equal the reference's under the margin rule of
``tests/test_torch_lm_serving.py``, including the reference's leak of SSD
state between engine slots, which the port keeps.

On a card (``-m gpu``): the smoke model's logits on the card against the
CPU.
"""

import dataclasses
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from test_torch_lm_hybrid import _slot0_logits
from test_torch_lm_model import TOL, carried, configs, f32, to_np

from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.models import model as tm
from repro_torch.models import ssm as tssm
from repro_torch.serving.engine import Engine, Request, generate_greedy
from repro_torch.serving.speculative import SpeculativeDecoder

ARCH = "mamba2-130m"
CORE_TOL = dict(rtol=2e-3, atol=2e-3)
BF16_ULP = dict(rtol=2.0 ** -7, atol=1e-6)
FLAG = tssm.STATE_BF16


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import model, spec, ssm
    from repro.serving import engine, speculative

    def exact(fn, *args):
        return jax.jit(fn).lower(*args).compile(compiler_options={
            "xla_allow_excess_precision": False})

    def run(fn, *args):
        return exact(fn, *args)(*args)
    return SimpleNamespace(jax=jax, jnp=jnp, get_config=get_config,
                           model=model, spec=spec, ssm=ssm, engine=engine,
                           speculative=speculative, exact=exact, run=run)


def bf16(jx, x):
    return jx.jnp.asarray(x).astype(jx.jnp.bfloat16)


def block_params(jx, cj, seed=5, dt_bias=0.3):
    """``ssd_specs`` seeded, with non-trivial ``dt_bias``, ``A_log`` and
    ``D`` (zeros and ones at init) so that each shows."""
    jp = jx.spec.initialize(jx.ssm.ssd_specs(cj), jx.jax.random.PRNGKey(seed))
    H = cj.ssd_heads
    r = np.random.default_rng(seed)
    jp = dict(jp, dt_bias=jx.jnp.asarray(
        dt_bias + 0.3 * r.standard_normal(H), jx.jnp.float32),
        A_log=jx.jnp.asarray(0.5 * r.standard_normal(H), jx.jnp.float32),
        D=jx.jnp.asarray(1 + 0.5 * r.standard_normal(H), jx.jnp.float32))
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def state_cache(jx, cj, rng, B, zero=False, state_dtype="bfloat16"):
    """A cache (conv, state) in both packages' forms: the reference's
    state in ``state_dtype``, the port's f32 leaf holding its values."""
    di = cj.ssd_heads * cj.ssm_head_dim
    conv = rng.standard_normal((B, cj.ssm_conv - 1, di + 2 * cj.ssm_state))
    st = 0.3 * rng.standard_normal((B, cj.ssd_heads, cj.ssm_head_dim,
                                    cj.ssm_state))
    if zero:
        conv, st = 0 * conv, 0 * st
    jst = jx.jnp.asarray(st, jx.jnp.float32).astype(state_dtype)
    jc = {"conv": bf16(jx, conv.astype(np.float32)), "state": jst}
    tc = {"conv": torch.from_numpy(conv.astype(np.float32)).bfloat16(),
          "state": torch.from_numpy(np.array(jst.astype(jx.jnp.float32)))}
    return jc, tc


class ChunkScan:
    """While open, records the final state of every reference chunk scan
    (a wrapper over ``jax.lax.scan``; run the reference op by op)."""

    def __init__(self, jax):
        self.jax, self.finals = jax, []

    def __enter__(self):
        self.scan = self.jax.lax.scan

        def recording(fn, init, xs, *a, **kw):
            out = self.scan(fn, init, xs, *a, **kw)
            self.finals.append(np.asarray(out[0]))
            return out
        self.jax.lax.scan = recording
        return self

    def __exit__(self, *exc):
        self.jax.lax.scan = self.scan
        return False


FULL_CASES = {"one_chunk": dict(S=16), "chunks": dict(S=48),
              "chunks_h0": dict(S=48, h0=True),
              "bf16_intra": dict(S=48, h0=True, intra=True),
              "short": dict(S=5, h0=True)}


@pytest.mark.parametrize("case", list(FULL_CASES))
def test_ssd_apply_full(jx, case, monkeypatch):
    """Full mode: one chunk (16 tokens), three, three from a carried state
    (bf16, as a prefill leaves it), with ``ssd_bf16_intra``, and a
    5-token continuation (the speculative verify's window): the block's
    output, the cache's conv (exact) and state; the core's final f32 state
    within 2e-3 of the reference's chunk scan."""
    kw = FULL_CASES[case]
    cj, ct = configs(ARCH, ssd_bf16_intra=kw.get("intra", False))
    jp, tp = block_params(jx, cj)
    rng = np.random.default_rng(7)
    B, S = 2, kw["S"]
    x = rng.standard_normal((B, S, cj.d_model)).astype(np.float32)
    jc, tc = state_cache(jx, cj, rng, B, zero=not kw.get("h0"))
    with ChunkScan(jx.jax) as scans:
        yj, cj_out = jx.ssm.ssd_apply(cj, jp, bf16(jx, x), mode="full",
                                      cache=jc)
    finals = []
    chunked = tssm._ssd_chunked

    def recording(*a):
        out = chunked(*a)
        finals.append(out[1])
        return out
    monkeypatch.setattr(tssm, "_ssd_chunked", recording)
    yt, ct_out = tssm.ssd_apply(ct, tp, torch.from_numpy(x).bfloat16(),
                                mode="full", cache=tc)
    assert ct_out is tc and tc["state"].dtype == torch.float32
    np.testing.assert_allclose(f32(yt), f32(yj), **TOL)
    np.testing.assert_allclose(finals[0].numpy(), scans.finals[0],
                               **CORE_TOL)
    np.testing.assert_array_equal(f32(tc["conv"]), f32(cj_out["conv"]))
    assert cj_out["state"].dtype == jx.jnp.bfloat16
    np.testing.assert_allclose(tc["state"].numpy(), f32(cj_out["state"]),
                               **BF16_ULP)
    # The stored state holds bf16 values, as the reference's does.
    torch.testing.assert_close(tc["state"], tc["state"].bfloat16().float(),
                               rtol=0, atol=0)


def test_ssd_apply_full_without_cache(jx):
    cj, ct = configs(ARCH)
    jp, tp = block_params(jx, cj)
    x = np.random.default_rng(8).standard_normal(
        (2, 32, cj.d_model)).astype(np.float32)
    yj, cj_out = jx.run(lambda p, x: jx.ssm.ssd_apply(cj, p, x, mode="full"),
                        jp, bf16(jx, x))
    yt, ct_out = tssm.ssd_apply(ct, tp, torch.from_numpy(x).bfloat16(),
                                mode="full")
    assert cj_out is None and ct_out is None
    np.testing.assert_allclose(f32(yt), f32(yj), **TOL)


@pytest.mark.parametrize("state_dtype", ["bfloat16", "float32"])
def test_ssd_apply_decode(jx, state_dtype):
    """One decode step from a state the reference holds in bf16 (after a
    prefill: its ``dBx`` rounds to bf16) and in f32 (after a decode): the
    output, and the new state within 2e-3, f32 in both packages."""
    cj, ct = configs(ARCH)
    jp, tp = block_params(jx, cj)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 1, cj.d_model)).astype(np.float32)
    jc, tc = state_cache(jx, cj, rng, 2, state_dtype=state_dtype)
    yj, cj_out = jx.run(lambda p, x, c: jx.ssm.ssd_apply(
        cj, p, x, mode="decode", cache=c), jp, bf16(jx, x), jc)
    yt, _ = tssm.ssd_apply(ct, tp, torch.from_numpy(x).bfloat16(),
                           mode="decode", cache=tc,
                           state_bf16=state_dtype == "bfloat16")
    assert cj_out["state"].dtype == jx.jnp.float32
    np.testing.assert_allclose(f32(yt), f32(yj), **TOL)
    np.testing.assert_allclose(tc["state"].numpy(),
                               np.asarray(cj_out["state"]), **CORE_TOL)
    np.testing.assert_array_equal(f32(tc["conv"]), f32(cj_out["conv"]))


def test_decode_rounds_its_update_on_a_bf16_state():
    """The flag changes the step exactly where the reference's dtype rule
    does: from a zero state, the new state is ``dBx`` rounded to bf16 or
    not."""
    cfg = tget(ARCH, smoke=True)
    p = {k: v[0] for k, v in tm.init_params(cfg, 0, device="cpu").params[
        "blocks"]["units"]["0"]["ssd"].items()}
    x = torch.randn(2, 1, cfg.d_model, generator=torch.Generator().manual_seed(
        1)).bfloat16()
    states = []
    for flag in (True, False):
        c = tm.init_cache(cfg, 2, 8, device="cpu")["units"]["0"]["ssd"]
        c = {k: v[0] for k, v in c.items()}
        tssm.ssd_apply(cfg, p, x, mode="decode", cache=c, state_bf16=flag)
        states.append(c["state"])
    assert torch.equal(states[0], states[0].bfloat16().float())
    assert not torch.equal(states[1], states[1].bfloat16().float())
    torch.testing.assert_close(states[0], states[1].bfloat16().float(),
                               rtol=0, atol=0)


@pytest.mark.parametrize("n_chunks", [1, 4])
@pytest.mark.parametrize("h0", [False, True])
def test_chunked_core_equals_the_sequential_recurrence(n_chunks, h0):
    """``_ssd_chunked`` against ``TestSSD._naive_ssd``'s sequential
    recurrence (float64 numpy, a carried state added) on that test's
    inputs, ``xs``, ``B`` and ``C`` rounded to bf16 as the block feeds
    them.  The intra-chunk product and the chunk states are bf16, as in
    the reference, so a few of the 16,384 outputs miss TestSSD's
    elementwise 2e-2 (which holds its float64 extraction of the chunk
    math); the relative L2 error is held within 5e-3 (2.4e-3 measured)."""
    from test_models import TestSSD     # imports JAX: not at collection
    cfg = tget(ARCH, smoke=True)
    rng = np.random.default_rng(0)
    B, S = 2, 64
    H, P, N = cfg.ssd_heads, cfg.ssm_head_dim, cfg.ssm_state

    def bf16_values(a):
        return torch.from_numpy(a).bfloat16().float().numpy()
    xs = bf16_values(rng.normal(size=(B, S, H, P)).astype(np.float32))
    Bv = bf16_values(rng.normal(size=(B, S, N)).astype(np.float32))
    Cv = bf16_values(rng.normal(size=(B, S, N)).astype(np.float32))
    dt = np.abs(rng.normal(size=(B, S, H))).astype(np.float32) * 0.5
    A = -np.abs(rng.normal(size=(H,))).astype(np.float32)
    D = rng.normal(size=(H,)).astype(np.float32)
    st = rng.normal(size=(B, H, P, N)).astype(np.float32) if h0 else None
    want = TestSSD()._naive_ssd(xs, Bv, Cv, dt, A, D)
    if h0:
        # The carried state's share: C_t . (prod_{s<=t} a_s) h0.
        decay = np.exp(np.cumsum(dt * A, 1))                   # (B,S,H)
        want = want + np.einsum("bsn,bsh,bhpn->bshp", Cv, decay, st)
    cfg = dataclasses.replace(cfg, ssm_chunk=S // n_chunks)
    got, _ = tssm._ssd_chunked(
        cfg, *(torch.from_numpy(a) for a in (xs, Bv, Cv, dt, dt * A, D)),
        None if st is None else torch.from_numpy(st))
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel <= 5e-3, rel


def test_long_chunk_with_large_dt_has_no_nan(jx):
    """A 256-token chunk with dt ~ 4: the masked intra-chunk decays reach
    exp(+1000), inf in f32.  The reference's ``where`` discards them;
    the port never forms them.  Outputs finite and equal."""
    cj, ct = configs(ARCH, ssm_chunk=256)
    jp, tp = block_params(jx, cj, dt_bias=4.0)
    jp["A_log"] = jx.jnp.zeros_like(jp["A_log"])
    tp["A_log"] = torch.zeros_like(tp["A_log"])
    x = np.random.default_rng(10).standard_normal(
        (1, 256, cj.d_model)).astype(np.float32)
    yj, _ = jx.run(lambda p, x: jx.ssm.ssd_apply(cj, p, x, mode="full"),
                   jp, bf16(jx, x))
    yt, _ = tssm.ssd_apply(ct, tp, torch.from_numpy(x).bfloat16(),
                           mode="full")
    assert torch.isfinite(yt).all() and np.isfinite(f32(yj)).all()
    np.testing.assert_allclose(f32(yt), f32(yj), **TOL)


def test_sequence_must_divide_the_chunk(jx):
    """The reference's assert, kept with its message: a full-mode call
    over 20 tokens with chunk 16 fails in both packages."""
    cj, ct = configs(ARCH)
    jp, tp = block_params(jx, cj)
    x = np.zeros((1, 20, cj.d_model), np.float32)
    with pytest.raises(AssertionError, match="seq must divide ssm_chunk"):
        jx.ssm.ssd_apply(cj, jp, bf16(jx, x), mode="full")
    with pytest.raises(AssertionError, match="seq must divide ssm_chunk"):
        tssm.ssd_apply(ct, tp, torch.from_numpy(x).bfloat16(), mode="full")


# Aten ops that only make views: they launch no kernel (the CPU's bf16
# batched matmul also slices its batch into blocks, by size).
VIEW_OPS = {"aten::as_strided", "aten::slice", "aten::narrow", "aten::view",
            "aten::reshape", "aten::_reshape_alias", "aten::expand",
            "aten::permute", "aten::transpose", "aten::unsqueeze",
            "aten::squeeze", "aten::select", "aten::split",
            "aten::split_with_sizes", "aten::_unsafe_view", "aten::alias",
            "aten::t", "aten::detach", "aten::lift_fresh"}


def test_ssd_launches_do_not_grow_with_the_chunks():
    """The inter-chunk recurrence runs in closed form: the kernel-launching
    aten ops of one full-mode ``ssd_apply`` (a torch.profiler count, view
    ops left out) are the same at 4 chunks and at 32."""
    from torch.profiler import ProfilerActivity, profile
    cfg = tget(ARCH, smoke=True)
    p = {k: v[0] for k, v in tm.init_params(cfg, 0, device="cpu").params[
        "blocks"]["units"]["0"]["ssd"].items()}
    counts = {}
    for n in (4, 32):
        x = torch.randn(1, n * cfg.ssm_chunk, cfg.d_model).bfloat16()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            tssm.ssd_apply(cfg, p, x, mode="full")
        counts[n] = sum(e.count for e in prof.key_averages()
                        if e.key.startswith("aten::")
                        and e.key not in VIEW_OPS)
    assert counts[4] == counts[32], counts


# -- the model ----------------------------------------------------------------

def test_forward_prefill_decode(jx):
    """forward over three chunks, a two-chunk prefill and per-row decode
    steps against the reference and against the port's own forward; the
    state after the prefill (bf16 in the reference) and after each decode
    (f32) equal the reference's, and the flag follows its dtype."""
    jnp = jx.jnp
    cj, ct = configs(ARCH)
    jp, tp = carried(jx, cj, ct)
    rng = np.random.default_rng(5)
    B, S, n_pre = 2, 48, 32
    toks = rng.integers(0, cj.vocab, (B, S)).astype(np.int32)
    full_j = jx.run(lambda p, t: jx.model.forward(cj, p, {"tokens": t})[0],
                    jp, jnp.asarray(toks))
    full_t, _, aux = tm.forward(ct, tp, {"tokens": toks})
    assert float(aux) == 0.0
    np.testing.assert_allclose(full_t.numpy(), np.asarray(full_j), **TOL)

    jc = jx.model.init_cache(cj, B, S)
    tc = tm.init_cache(ct, B, S, device="cpu")
    assert bool(tc[FLAG])
    lj, jc = jx.run(lambda p, t, c: jx.model.prefill(cj, p, {"tokens": t},
                                                     c),
                    jp, jnp.asarray(toks[:, :n_pre]), jc)
    lt, tc = tm.prefill(ct, tp, {"tokens": toks[:, :n_pre]}, tc)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    state = ("units", "0", "ssd", "state")

    def leaf(tree):
        for k in state:
            tree = tree[k]
        return tree
    assert leaf(jc).dtype == jnp.bfloat16 and bool(tc[FLAG])
    np.testing.assert_allclose(leaf(tc).numpy(), f32(leaf(jc)), **BF16_ULP)
    decode = {}
    for t in range(n_pre, S):
        ci = np.full(B, t, np.int32)
        args = (jp, jc, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(ci))
        key = leaf(jc).dtype      # the reference retraces on the new dtype
        decode[key] = decode.get(key) or jx.exact(
            lambda p, c, tk, i: jx.model.decode_step(cj, p, c, tk, i), *args)
        lj, jc = decode[key](*args)
        lt, tc = tm.decode_step(ct, tp, tc, toks[:, t:t + 1], ci)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        np.testing.assert_allclose(lt.numpy(), full_t[:, t].numpy(), **TOL)
        assert leaf(jc).dtype == jnp.float32 and not bool(tc[FLAG])
        np.testing.assert_allclose(leaf(tc).numpy(), np.asarray(leaf(jc)),
                                   **CORE_TOL)


def test_verify_window_equals_decode(jx):
    """The speculative verify (a 5-token full-mode call from the prefill's
    state) against token-by-token decode and the reference's verify; the
    state after it is bf16 in the reference again."""
    jnp = jx.jnp
    cj, ct = configs(ARCH)
    jp, tp = carried(jx, cj, ct, seed=3)
    toks = np.random.default_rng(11).integers(0, cj.vocab,
                                              (1, 21)).astype(np.int32)
    caches = tm.init_cache(ct, 1, 32, device="cpu")
    tm.prefill(ct, tp, {"tokens": toks[:, :16]}, caches)
    win, _, _ = tm.forward(ct, tp, {"tokens": toks[:, 16:]}, caches=caches,
                           cache_index=16)
    assert bool(caches[FLAG])
    c2 = tm.init_cache(ct, 1, 32, device="cpu")
    tm.prefill(ct, tp, {"tokens": toks[:, :16]}, c2)
    steps = [tm.decode_step(ct, tp, c2, toks[:, t:t + 1], t)[0]
             for t in range(16, 21)]
    np.testing.assert_allclose(win[0].numpy(), torch.cat(steps).numpy(),
                               **TOL)

    def verify(p, t):
        c = jx.model.init_cache(cj, 1, 32)
        _, c = jx.model.prefill(cj, p, {"tokens": t[:, :16]}, c)
        return jx.model.forward(cj, p, {"tokens": t[:, 16:]}, mode="full",
                                caches=c, cache_index=16)
    want, jc, _ = jx.run(verify, jp, jnp.asarray(toks))
    np.testing.assert_allclose(win.numpy(), np.asarray(want), **TOL)
    assert jc["units"]["0"]["ssd"]["state"].dtype == jnp.bfloat16


@pytest.mark.parametrize("after", ["prefill", "decode"])
def test_mid_stream_cache_carries_across(jx, after):
    """A cache the reference filled, its state bf16 (after a prefill) or
    f32 (after a decode), carried across with ``cache_from_numpy``
    (widened exactly, the flag set from its dtype) decodes to the
    reference's logits; a model of SSD layers has no ``k`` or ``h`` leaf
    to read the batch off."""
    jnp = jx.jnp
    cj, ct = configs(ARCH)
    jp, tp = carried(jx, cj, ct, seed=1)
    toks = np.random.default_rng(6).integers(0, cj.vocab,
                                             (2, 18)).astype(np.int32)
    jc = jx.model.init_cache(cj, 2, 24)
    _, jc = jx.run(lambda p, t, c: jx.model.prefill(
        cj, p, {"tokens": t}, c), jp, jnp.asarray(toks[:, :16]), jc)
    if after == "decode":
        _, jc = jx.run(lambda p, c, t: jx.model.decode_step(
            cj, p, c, t, 16), jp, jc, jnp.asarray(toks[:, 16:17]))
    tc = convert.cache_from_numpy(ct, to_np(jc), device="cpu")
    st = jc["units"]["0"]["ssd"]["state"]
    assert bool(tc[FLAG]) == (after == "prefill")
    assert tc["units"]["0"]["ssd"]["state"].dtype == torch.float32
    np.testing.assert_array_equal(tc["units"]["0"]["ssd"]["state"].numpy(),
                                  f32(st))
    want, _ = jx.run(lambda p, c, t: jx.model.decode_step(
        cj, p, c, t, 17), jp, jc, jnp.asarray(toks[:, 17:]))
    got, _ = tm.decode_step(ct, tp, tc, toks[:, 17:], 17)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cache_from_numpy_refuses_mixed_state_dtypes(jx):
    cj, ct = configs(ARCH, n_layers=2, block_pattern=("ssd", "ssd"))
    tree = to_np(jx.model.init_cache(cj, 1, 8))
    unit = tree["units"]["0"]["ssd"]
    unit["state"] = unit["state"].astype(np.float32)
    with pytest.raises(ValueError, match="several dtypes"):
        convert.cache_from_numpy(ct, tree, device="cpu")


def test_host_row_positions_are_not_checked_without_attention():
    """A model of SSD layers has no positions to check."""
    cfg = tget(ARCH, smoke=True)
    lm = tm.init_params(cfg, 0, device="cpu")
    logits, _ = lm.decode_step(lm.init_cache(2, 8), np.zeros((2, 1),
                                                             np.int32),
                               np.array([3, 40]))
    assert logits.shape == (2, cfg.vocab)


# -- serving ----------------------------------------------------------------

@pytest.fixture(scope="module")
def served(jx):
    """(reference namespace for the margin rule, port LM) of mamba2 smoke
    on the reference's PRNGKey(0) weights."""
    cj = jx.get_config(ARCH, smoke=True)
    params = jx.model.init_params(cj, jx.jax.random.PRNGKey(0))
    ref = SimpleNamespace(jnp=jx.jnp, model=jx.model, cfg=cj, params=params)
    return ref, convert.params_from_numpy(tget(ARCH, smoke=True),
                                          to_np(params), device="cpu")


def same_under_margin(want, got, top2_at, what) -> bool:
    """Token-for-token equality; where the streams differ, the reference's
    top-1/top-2 margin at the first differing step (``top2_at(i)``, from
    the reference's own calls) must be under the logit tolerance.  The
    margin rule of ``tests/test_torch_lm_serving.py``, whose forward over
    the context is another function here: it runs every token through
    the chunked form, whose length must divide the chunk, and it skips
    the state the engine and the verify fold in.  True when equal."""
    want, got = np.asarray(want).reshape(-1), np.asarray(got).reshape(-1)
    diff = np.flatnonzero(want != got)
    if not len(diff):
        return True
    i = int(diff[0])
    top1, top2 = top2_at(i)
    tol = TOL["atol"] + TOL["rtol"] * abs(top1)
    assert top1 - top2 < tol, (
        f"{what}: streams differ at step {i} ({want[i]} vs {got[i]}) where "
        f"the reference's top-1/top-2 margin is {top1 - top2:.4f}, past "
        f"{tol:.4f}")
    warnings.warn(f"{what}: near-tie at step {i}: reference {want[i]}, port "
                  f"{got[i]}, margin {top1 - top2:.4f} < {tol:.4f}")
    return False


def greedy_top2(jx, ref, prompt, want, max_seq):
    """``top2_at`` for a greedy stream: the reference's prefill of the
    prompt, then ``want``'s first i tokens decoded."""
    def top2_at(i):
        c = jx.model.init_cache(ref.cfg, 1, max_seq)
        logits, c = jx.model.prefill(ref.cfg, ref.params, {
            "tokens": jx.jnp.asarray(np.asarray(prompt)[None])}, c)
        for t in range(i):
            logits, c = jx.model.decode_step(
                ref.cfg, ref.params, c, jx.jnp.asarray([[want[t]]]),
                len(prompt) + t)
        top = np.sort(np.asarray(logits[0], np.float32))[-2:]
        return float(top[1]), float(top[0])
    return top2_at


def recorded_engine(eng_cls, req_cls, cfg, params, prompts, max_new,
                    n_slots, max_seq=32):
    """The slot engine over ``prompts``: (requests, each one's (top-1,
    top-2) logits step by step: the first token's from its admission,
    the rest from the sampler's row of its slot)."""
    top2 = {}

    def top(row):
        t = np.sort(np.asarray(row, np.float32))[-2:]
        return float(t[1]), float(t[0])

    def sampler(logits):
        for i, r in enumerate(eng.slot_req):
            if r is not None and not r.done:
                top2.setdefault(id(r), []).append(top(logits[i]))
        return (logits.argmax(-1) if isinstance(logits, torch.Tensor)
                else np.asarray(logits).argmax(-1))
    eng = eng_cls(cfg, params, max_seq=max_seq, n_slots=n_slots,
                  sampler=sampler)
    reqs = [req_cls(prompt=p, max_new=max_new) for p in prompts]
    eng.run(list(reqs))
    return eng, reqs, [[top(r._last_logits)] + top2.get(id(r), [])
                       for r in reqs]


def test_generate_greedy_matches_reference(jx, served):
    ref, lm = served
    prompts = np.random.default_rng(0).integers(0, 256, (2, 16),
                                                dtype=np.int32)
    want = jx.engine.generate_greedy(ref.cfg, ref.params, prompts,
                                     max_new=8, max_seq=32)
    got = generate_greedy(lm.cfg, lm, prompts, max_new=8, max_seq=32)
    for p, w, g in zip(prompts, want, got):
        same_under_margin(w, g, greedy_top2(jx, ref, p, w, 32),
                          "ssd generate_greedy")


def test_engine_matches_reference(jx, served):
    """Three requests through two slots: each stream equals the reference
    engine's (which steps every slot's SSD state on its neighbours'
    admissions; the port does the same), the margin read off the
    reference engine's own logits."""
    ref, lm = served
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, n, dtype=np.int32) for n in (5, 9, 4)]
    jeng, jreqs, top2 = recorded_engine(jx.engine.Engine, jx.engine.Request,
                                        ref.cfg, ref.params, prompts, 6, 2)
    teng, treqs, _ = recorded_engine(Engine, Request, lm.cfg, lm, prompts,
                                     6, 2)
    equal = [same_under_margin(j.out, t.out, steps.__getitem__,
                               "ssd engine")
             for j, t, steps in zip(jreqs, treqs, top2)]
    if all(equal):
        np.testing.assert_array_equal(teng.slot_pos,
                                      np.asarray(jeng.slot_pos))


def test_engine_leaks_ssd_state_like_the_reference(jx, served):
    """The reference's engine prefills a request by decoding every slot,
    so a neighbour's admission steps slot 0's SSD state on junk tokens.
    Slot 0's next logits move with a neighbour admitted, in both packages
    alike."""
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
        assert np.abs(alone - beside).max() > 1e-3
    for i in range(2):
        np.testing.assert_allclose(runs["port"][i], runs["ref"][i], **TOL)


def test_speculative_matches_reference(jx, served):
    """A 16-token prompt (one chunk) of a repeated motif, 64 new tokens
    (the smoke model repeats itself rarely, so the proposer finds exact
    suffixes late): the speculative stream and its counts equal the
    reference decoder's (whose verify also folds rejected tokens into the
    SSD state)."""
    ref, lm = served
    motif = np.random.default_rng(0).integers(0, 256, 4, dtype=np.int32)
    prompt = np.tile(motif, 4)
    out, stats = SpeculativeDecoder(lm.cfg, lm, max_seq=96, k=4).generate(
        prompt, max_new=64)
    jout, jstats = jx.speculative.SpeculativeDecoder(
        ref.cfg, ref.params, max_seq=96, k=4).generate(prompt, max_new=64)
    if same_under_margin(jout, out, greedy_top2(jx, ref, prompt, jout, 96),
                         "ssd speculative"):
        assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)
    assert stats.proposed > 0


# -- chip_smoke.py phase 10 (s), rehearsed ------------------------------------

def test_chip_smoke_ssd_phase_rehearses_on_cpu(monkeypatch):
    """Phase 10's SSD checks at smoke size on the CPU: prefill + decode
    and the verify against the forward, the long forward against a
    prefill plus a continuation, the engine against its CPU twin at full
    depth, the speculator up to its first rejecting verify."""
    from test_torch_lm_serving import load_chip_smoke
    cs, count = load_chip_smoke(monkeypatch)
    # Chunks of 64: the forward checks' lengths (32, 35, 4) are at most
    # one chunk, as the full width's (128, 131, 4) are of 256; the long
    # forward is two.
    monkeypatch.setattr(cs, "LM_SSD_LONG", 128)
    cfg = dataclasses.replace(tget(ARCH, smoke=True), ssm_chunk=64)
    launches, info = cs.lm_phase(
        [("s", cfg)], zero_counts=lambda: count.update(match_swar=0),
        read_counts=lambda: dict(count), sync=lambda: None, device="cpu",
        profile_step=False)
    out = info["s"]
    assert launches == out["spec_launches"]["match_swar"] > 0
    assert out["err_prefill_decode"]["rel_l2"] <= 3e-2
    assert out["err_verify"]["rel_l2"] <= 3e-2
    assert out["err_long_vs_continuation"]["rel_l2"] <= 3e-2
    assert {k: out["ssd_long"][k] for k in ("tokens", "chunks", "calls")} \
        == {"tokens": 128, "chunks": 2, "calls": cfg.n_layers}
    assert out["cpu_layers"] == cfg.n_layers
    assert out["engine_twin_ties"] == 0
    assert out["spec_held_tokens"] > 0


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_logits_match_cpu(cuda):
    cfg = tget(ARCH, smoke=True)
    cpu = tm.init_params(cfg, 0, device="cpu")
    card = tm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                          device=cuda)
    card.load_state_dict(cpu.state_dict())
    toks = np.random.default_rng(9).integers(0, cfg.vocab,
                                             (2, 40)).astype(np.int32)
    for lm in (cpu, card):
        lm._full = lm.forward({"tokens": toks[:, :32]})[0]
        caches = lm.init_cache(2, 48)
        lm._last = lm.prefill({"tokens": toks[:, :32]}, caches)[0]
        lm._step = lm.decode_step(caches, toks[:, 32:33],
                                  np.array([32, 32]))[0]
    for name in ("_full", "_last", "_step"):
        np.testing.assert_allclose(getattr(card, name).cpu().numpy(),
                                   getattr(cpu, name).numpy(), **TOL)
