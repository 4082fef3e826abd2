"""MoE parity for the PyTorch port: ``repro_torch.models.layers.moe_route``
/ ``moe_apply`` and the MoE archs (olmoe, moonshot) against
``repro.models``.

The same numpy inputs and the JAX ``init_params`` tree, carried across
with ``repro_torch.convert.params_from_numpy``, go through both packages,
the port's on ``device="cpu"``.  The reference is compiled with
``xla_allow_excess_precision`` off, as ``tests/test_torch_lm_model.py``
compiles it.  Routing is integer for integer: the chosen experts, their
order, every assignment's capacity position and the drop mask equal the
reference's lines (``src/repro/models/layers.py:440-457``, reproduced in
``ref_route`` below), with ties forced by duplicate router columns and
with drops forced by ``capacity_factor=1.25`` at the smoke width.  Logits,
MoE outputs and the aux loss hold the reference's bf16 tolerance (``rtol
= atol = 3e-2``); the renormalized gates hold f32's (1e-6).  Serving
streams equal the reference's under the margin rule of
``tests/test_torch_lm_serving.py``.

On a card (``-m gpu``): ``moe_route`` on the card against the CPU on the
same f32 gates, and the smoke model's logits on the card against the CPU.
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

MOE = ["olmoe-1b-7b", "moonshot-v1-16b-a3b"]
DROPS = dict(capacity_factor=1.25)      # the full configs' factor


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


def ref_route(jx, cfg, gates):
    """``moe_apply``'s routing lines as the reference runs them, each
    assignment's capacity position and keep flag read off at its expert:
    (idx, probs, C, pos, keep), each (G, Sg, k) but C."""
    jax, jnp = jx.jax, jx.jnp
    G, Sg, E = gates.shape
    k = cfg.top_k
    probs, idx = jax.lax.top_k(gates, k)
    probs = probs / jnp.maximum(probs.sum(-1, keepdims=True), 1e-9)
    C = max(int(k * Sg * cfg.capacity_factor / E), 4)
    counts = jnp.zeros((G, 1, E), jnp.int32)
    pos_k, keep_k = [], []
    for slot in range(k):
        mask = jax.nn.one_hot(idx[:, :, slot], E, dtype=jnp.int32)
        pos = jnp.cumsum(mask, axis=1) - 1 + counts
        keep = (pos < C) & (mask > 0)
        pos_k.append((pos * mask).sum(-1))
        keep_k.append(keep.any(-1))
        counts = counts + mask.sum(axis=1, keepdims=True)
    return (np.asarray(idx), np.asarray(probs), C,
            np.stack([np.asarray(p) for p in pos_k], -1),
            np.stack([np.asarray(k_) for k_ in keep_k], -1))


def router_gates(jx, cfg, x, router):
    """The reference's gates: softmax of the bf16 router logits, in f32."""
    jnp = jx.jnp
    G = x.shape[0] * x.shape[1] // min(cfg.moe_group_size,
                                       x.shape[0] * x.shape[1])
    xt = jnp.asarray(x).astype(jnp.bfloat16).reshape(G, -1, x.shape[-1])
    logits = jnp.einsum("gsd,de->gse", xt, jnp.asarray(router).astype(
        jnp.bfloat16))
    return np.array(jx.jax.nn.softmax(logits.astype(jnp.float32), -1))


def route_case(jx, case):
    """(JAX config, port config, f32 gates) of one routing case."""
    rng = np.random.default_rng(11)
    arch = "moonshot-v1-16b-a3b" if case == "moonshot" else "olmoe-1b-7b"
    cj, ct = configs(arch, **(DROPS if case in ("drops", "ties") else {}))
    router = rng.standard_normal((cj.d_model, cj.n_experts)).astype(
        np.float32) / np.sqrt(cj.d_model)
    if case == "ties":
        # Duplicate columns: experts 3, 5 and 6 tie with expert 1 exactly.
        router[:, [3, 5, 6]] = router[:, [1]]
    x = rng.standard_normal((4, 16, cj.d_model)).astype(np.float32)
    return cj, ct, router_gates(jx, cj, x, router)


@pytest.mark.parametrize("case", ["smoke", "ties", "drops", "moonshot"])
def test_moe_route_matches_reference(jx, case):
    cj, ct, gates = route_case(jx, case)
    idx, probs, C, pos, keep = ref_route(jx, cj, jx.jnp.asarray(gates))
    got = tl.moe_route(ct, torch.from_numpy(gates))
    assert got.C == C
    np.testing.assert_array_equal(got.idx.numpy(), idx)
    np.testing.assert_array_equal(got.pos.numpy(), pos)
    np.testing.assert_array_equal(got.keep.numpy(), keep)
    np.testing.assert_allclose(got.probs.numpy(), probs, rtol=1e-6)
    if case == "ties":
        # Tied experts were chosen side by side, the lower index first.
        both = (idx == 1).any(-1) & (idx == 3).any(-1)
        assert both.any()
        order = np.argmax(idx == 1, -1) < np.argmax(idx == 3, -1)
        assert order[both].all()
    if case == "drops":
        assert not keep.all()
    if case == "smoke":     # capacity_factor E/k: nothing drops
        assert keep.all()


def test_moe_route_ties_by_lower_index():
    """All-equal gates: every token picks experts 0..k-1 in order, and the
    capacity positions count them token after token."""
    cfg = tget("olmoe-1b-7b", smoke=True)
    gates = torch.full((1, 6, cfg.n_experts), 1.0 / cfg.n_experts)
    r = tl.moe_route(cfg, gates)
    assert r.idx.tolist() == [[list(range(cfg.top_k))] * 6]
    assert r.pos[0, :, 0].tolist() == list(range(6))
    assert bool(r.keep.all())


@pytest.mark.parametrize("case", ["smoke", "drops", "moonshot"])
def test_moe_apply_matches_reference(jx, case):
    arch = "moonshot-v1-16b-a3b" if case == "moonshot" else "olmoe-1b-7b"
    cj, ct = configs(arch, **(DROPS if case == "drops" else {}))
    jp = jx.spec.initialize(jx.layers.moe_specs(cj),
                            jx.jax.random.PRNGKey(3))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(3).standard_normal(
        (2, 32, cj.d_model)).astype(np.float32)
    xb = jx.jnp.asarray(x).astype(jx.jnp.bfloat16)
    want, aux_j = jx.run(lambda p, x: jx.layers.moe_apply(cj, p, x), jp, xb)
    got, aux_t = tl.moe_apply(ct, tp, torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16 and aux_t.dtype == torch.float32
    np.testing.assert_allclose(f32(got), f32(want), **TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)
    if case == "drops":
        gates = router_gates(jx, cj, x, jp["router"])
        assert not ref_route(jx, cj, jx.jnp.asarray(gates))[4].all()


def test_moe_apply_refuses_tokens_off_the_group():
    """B*S must divide the group (the reference's assert, same error)."""
    cfg = tget("olmoe-1b-7b", smoke=True)
    lm = tm.init_params(cfg, 0, device="cpu")
    with pytest.raises(AssertionError, match="divide the MoE group size"):
        lm.forward({"tokens": np.zeros((2, 33), np.int32)})
    logits, _, aux = lm.forward({"tokens": np.zeros((2, 32), np.int32)})
    assert logits.shape == (2, 32, cfg.vocab) and float(aux) > 0


# -- the model ----------------------------------------------------------------

@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("arch", MOE)
def test_forward_prefill_decode(jx, arch, kv_quant):
    """forward (logits and the summed aux), prefill and per-row decode
    against the reference; with the bf16 cache and nothing dropped,
    prefill + decode against the port's own full forward."""
    jnp = jx.jnp
    cj, ct = configs(arch, kv_quant=kv_quant)
    jp, tp = carried(jx, cj, ct)
    rng = np.random.default_rng(5)
    B, S, n_pre = 2, 16, 12
    toks = rng.integers(0, cj.vocab, (B, S)).astype(np.int32)
    full_j, _, aux_j = jx.run(lambda p, t: jx.model.forward(
        cj, p, {"tokens": t}), jp, jnp.asarray(toks))
    full_t, _, aux_t = tm.forward(ct, tp, {"tokens": toks})
    np.testing.assert_allclose(full_t.numpy(), np.asarray(full_j), **TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-4)

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
        if not kv_quant:
            np.testing.assert_allclose(lt.numpy(), full_t[:, t].numpy(),
                                       **TOL)


def test_mid_stream_cache_carries_across(jx):
    """A cache the reference's prefill filled, carried across with
    ``cache_from_numpy``, decodes to the reference's logits."""
    jnp = jx.jnp
    for kv_quant in (False, True):
        cj, ct = configs("olmoe-1b-7b", kv_quant=kv_quant)
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


def test_forward_with_drops(jx):
    """The full olmoe's capacity factor at the smoke width: forward and a
    prefill that drop assignments agree with the reference's, and the
    chunked verify (5 tokens, C = 4) with it."""
    jnp = jx.jnp
    cj, ct = configs("olmoe-1b-7b", **DROPS)
    jp, tp = carried(jx, cj, ct, seed=2)
    toks = np.random.default_rng(7).integers(0, cj.vocab,
                                             (2, 37)).astype(np.int32)
    want = jx.run(lambda p, t: jx.model.forward(cj, p, {"tokens": t})[0],
                  jp, jnp.asarray(toks[:, :32]))
    got, _, _ = tm.forward(ct, tp, {"tokens": toks[:, :32]})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    def verify(p, t):
        c = jx.model.init_cache(cj, 2, 64)
        _, c = jx.model.prefill(cj, p, {"tokens": t[:, :32]}, c)
        return jx.model.forward(cj, p, {"tokens": t[:, 32:]}, mode="full",
                                caches=c, cache_index=32)[0]
    want = jx.run(verify, jp, jnp.asarray(toks))
    caches = tm.init_cache(ct, 2, 64, device="cpu")
    tm.prefill(ct, tp, {"tokens": toks[:, :32]}, caches)
    got, _, _ = tm.forward(ct, tp, {"tokens": toks[:, 32:]}, caches=caches,
                           cache_index=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -- serving ----------------------------------------------------------------

@pytest.fixture(scope="module")
def served(jx):
    """(reference namespace for the margin rule, port LM) of olmoe smoke
    on the reference's PRNGKey(0) weights."""
    cj = jx.get_config("olmoe-1b-7b", smoke=True)
    ct = tget("olmoe-1b-7b", smoke=True)
    params = jx.model.init_params(cj, jx.jax.random.PRNGKey(0))
    ref = SimpleNamespace(jnp=jx.jnp, model=jx.model, cfg=cj, params=params)
    return ref, convert.params_from_numpy(ct, to_np(params), device="cpu")


def test_generate_greedy_matches_reference(jx, served):
    ref, lm = served
    prompts = np.random.default_rng(0).integers(0, 256, (2, 8),
                                                dtype=np.int32)
    want = jx.engine.generate_greedy(ref.cfg, ref.params, prompts,
                                     max_new=6, max_seq=32)
    got = generate_greedy(lm.cfg, lm, prompts, max_new=6, max_seq=32)
    for p, w, g in zip(prompts, want, got):
        same_stream(ref, p, w, g, "moe generate_greedy")


def test_engine_matches_reference(jx, served):
    """Three requests through two slots (one admitted into a freed slot):
    the port's streams and slot state equal the reference engine's."""
    ref, lm = served
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, n, dtype=np.int32) for n in (5, 9, 3)]
    jreqs = [jx.engine.Request(prompt=p, max_new=5) for p in prompts]
    treqs = [Request(prompt=p, max_new=5) for p in prompts]
    jeng = jx.engine.Engine(ref.cfg, ref.params, max_seq=32, n_slots=2)
    teng = Engine(lm.cfg, lm, max_seq=32, n_slots=2)
    jeng.run(list(jreqs))
    teng.run(list(treqs))
    equal = [same_stream(ref, p, j.out, t.out, "moe engine")
             for p, j, t in zip(prompts, jreqs, treqs)]
    if all(equal):
        np.testing.assert_array_equal(teng.slot_pos,
                                      np.asarray(jeng.slot_pos))


def test_speculative_matches_reference(jx, served):
    """A motif prompt: the speculative stream and its counts equal the
    reference decoder's, and the port's stream equals its own greedy."""
    ref, lm = served
    motif = np.random.default_rng(4).integers(0, 256, 6, dtype=np.int32)
    prompt = np.tile(motif, 4)
    out, stats = SpeculativeDecoder(lm.cfg, lm, max_seq=96, k=4).generate(
        prompt, max_new=16)
    own = generate_greedy(lm.cfg, lm, prompt[None], max_new=16,
                          max_seq=96)[0]
    np.testing.assert_array_equal(out, own)
    jout, jstats = jx.speculative.SpeculativeDecoder(
        ref.cfg, ref.params, max_seq=96, k=4).generate(prompt, max_new=16)
    if same_stream(ref, prompt, jout, out, "moe speculative"):
        assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)
    assert stats.proposed > 0


def test_lm_launcher_serves_moe_archs(capsys):
    from repro_torch.launch import serve
    for arch in MOE:
        got = serve.main(["--workload", "lm", "--arch", arch, "--device",
                          "cpu", "--requests", "2", "--max-new", "6"])
        assert got["n_tokens"] == 12
    assert "served 2 requests, 12 tokens" in capsys.readouterr().out


# -- chip_smoke.py phase 10 (m), rehearsed ------------------------------------

def test_chip_smoke_moe_phase_rehearses_on_cpu(monkeypatch):
    """Phase 10's MoE checks at smoke size on the CPU, with the full
    config's capacity factor and group size, so that calls drop
    assignments: the drop counts, the held comparisons and the route held
    against itself."""
    from test_torch_lm_serving import load_chip_smoke
    cs, count = load_chip_smoke(monkeypatch)
    cfg = dataclasses.replace(tget("olmoe-1b-7b", smoke=True), **DROPS,
                              moe_group_size=256, kv_quant=True,
                              param_dtype="bf16")
    launches, info = cs.lm_phase(
        [("m", cfg)], zero_counts=lambda: count.update(match_swar=0),
        read_counts=lambda: dict(count), sync=lambda: None, device="cpu",
        profile_step=False)
    out = info["m"]
    assert launches == out["spec_launches"]["match_swar"] > 0
    drops = out["moe_drops"]
    assert drops["prefill"] > 0 and drops["decode"] == 0
    assert "m engine vs decode loop" in out["held"]
    assert out["engine_tokens"] == cs.LM_MR_REQUESTS * cs.LM_MR_NEW
    assert out["route_ties"] >= 0 and out["route_assignments"] > 0


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_moe_route_matches_cpu(cuda):
    cfg = dataclasses.replace(tget("olmoe-1b-7b", smoke=True), **DROPS)
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(2, 32, cfg.n_experts, generator=g)
    logits[..., 5] = logits[..., 2]            # a tie in every row
    gates = torch.softmax(logits.bfloat16().float(), -1)
    want = tl.moe_route(cfg, gates)
    got = tl.moe_route(cfg, gates.to(cuda))
    for name in ("idx", "pos", "keep"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name))
    assert got.C == want.C


@pytest.mark.gpu
@pytest.mark.parametrize("arch", MOE)
def test_card_logits_match_cpu(cuda, arch):
    cfg = dataclasses.replace(tget(arch, smoke=True), kv_quant=True)
    cpu = tm.init_params(cfg, 0, device="cpu")
    card = tm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                          device=cuda)
    card.load_state_dict(cpu.state_dict())
    toks = np.random.default_rng(9).integers(0, cfg.vocab,
                                             (2, 16)).astype(np.int32)
    for lm in (cpu, card):
        caches = lm.init_cache(2, 32)
        lm._last = lm.prefill({"tokens": toks[:, :8]}, caches)[0]
        lm._step = lm.decode_step(caches, toks[:, 8:9],
                                  np.array([8, 8]))[0]
    np.testing.assert_allclose(card._last.cpu().numpy(),
                               cpu._last.numpy(), **TOL)
    np.testing.assert_allclose(card._step.cpu().numpy(),
                               cpu._step.numpy(), **TOL)
