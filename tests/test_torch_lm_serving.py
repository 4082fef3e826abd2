"""LM serving parity for the PyTorch port: ``repro_torch.serving`` and the
launcher's ``lm`` workload against ``repro.serving`` / ``repro.launch``.

Every case of ``tests/test_runtime.py::TestServing`` and
``tests/test_speculative.py`` runs through both packages on the same seeded
prompts and the same weights (the JAX ``init_params`` tree carried across
with ``repro_torch.convert.params_from_numpy``), the port's on
``device="cpu"`` (the n-gram proposer's ``match_swar`` through its plain
version).  The reference runs as it is shipped (compiled by default).

Greedy token streams must be equal token for token.  Where they differ,
the test fails unless the reference's top-1/top-2 logit margin at the
first differing step is under the logit tolerance (``rtol=3e-2,
atol=3e-2``, the reference's own): such a tie is reported as a warning,
and the rest of that stream is not compared.  Integers are exact:
crumbs, proposals, match confidences, slot positions and ``SpecStats``.
"""

import dataclasses
import re
import sys
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tm
from repro_torch.serving import ngram_cache as tng
from repro_torch.serving.engine import Engine, Request, generate_greedy
from repro_torch.serving.speculative import SpeculativeDecoder

ARCH = "llama3.2-1b"
RTOL = ATOL = 3e-2


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.launch import serve
    from repro.models import model
    from repro.serving import engine, ngram_cache, speculative
    cfg = get_config(ARCH, smoke=True)
    params = model.init_params(cfg, jax.random.PRNGKey(0))
    return SimpleNamespace(jax=jax, jnp=jnp, model=model, engine=engine,
                           ngram=ngram_cache, spec=speculative, serve=serve,
                           cfg=cfg, params=params)


@pytest.fixture(scope="module")
def lm(jx):
    """The reference's PRNGKey(0) weights as the port's ``CausalLM``."""
    cfg = tget(ARCH, smoke=True)
    tree = jx.jax.tree.map(np.asarray, jx.params)
    return convert.params_from_numpy(cfg, tree, device="cpu")


CFG = tget(ARCH, smoke=True)


def same_stream(jx, prompt, want, got, what) -> bool:
    """Token-for-token equality under the margin rule; True when equal."""
    want = np.asarray(want).reshape(-1)
    got = np.asarray(got).reshape(-1)
    n = min(len(want), len(got))
    diff = np.flatnonzero(want[:n] != got[:n])
    if len(diff) == 0:
        assert len(want) == len(got), what
        return True
    i = int(diff[0])
    ctx = np.concatenate([np.asarray(prompt).reshape(-1), want[:i]])
    logits, _, _ = jx.model.forward(jx.cfg, jx.params,
                                    {"tokens": jx.jnp.asarray(ctx[None])})
    top2 = np.sort(np.asarray(logits[0, -1]))[-2:]
    margin = float(top2[1] - top2[0])
    tol = ATOL + RTOL * abs(float(top2[1]))
    assert margin < tol, (
        f"{what}: streams differ at step {i} ({want[i]} vs {got[i]}) where "
        f"the reference's top-1/top-2 margin is {margin:.4f}, past the "
        f"logit tolerance {tol:.4f}")
    warnings.warn(f"{what}: near-tie at step {i}: reference {want[i]}, port "
                  f"{got[i]}, top-1/top-2 margin {margin:.4f} < {tol:.4f}")
    return False


# -- generate_greedy and the slot engine (tests/test_runtime.py) ----------

def test_generate_greedy_deterministic(jx, lm):
    prompts = np.random.default_rng(0).integers(
        0, CFG.vocab, (2, 6), dtype=np.int32)
    a = generate_greedy(CFG, lm, prompts, max_new=5, max_seq=32)
    b = generate_greedy(CFG, lm, prompts, max_new=5, max_seq=32)
    np.testing.assert_array_equal(a, b)
    assert a.dtype == np.int32 and a.shape == (2, 5)
    want = jx.engine.generate_greedy(jx.cfg, jx.params, prompts, max_new=5,
                                     max_seq=32)
    for p, w, g in zip(prompts, want, a):
        same_stream(jx, p, w, g, "generate_greedy")


def _run_both(jx, lm, prompts, max_new, max_seq, n_slots):
    """The same requests through both engines; returns both engines and
    request lists."""
    jreqs = [jx.engine.Request(prompt=p, max_new=max_new) for p in prompts]
    treqs = [Request(prompt=p, max_new=max_new) for p in prompts]
    jeng = jx.engine.Engine(jx.cfg, jx.params, max_seq=max_seq,
                            n_slots=n_slots)
    teng = Engine(CFG, lm, max_seq=max_seq, n_slots=n_slots)
    jeng.run(list(jreqs))
    teng.run(list(treqs))
    return jeng, teng, jreqs, treqs


def _check_engines(jx, prompts, jeng, teng, jreqs, treqs, what):
    equal = [same_stream(jx, p, j.out, t.out, what)
             for p, j, t in zip(prompts, jreqs, treqs)]
    assert [t.done for t in treqs] == [j.done for j in jreqs]
    if all(equal):
        np.testing.assert_array_equal(teng.slot_pos, np.asarray(
            jeng.slot_pos))
        assert [r is None for r in teng.slot_req] == \
            [r is None for r in jeng.slot_req]


def test_engine_serves_all_requests(jx, lm):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, CFG.vocab, 4, dtype=np.int32)
               for _ in range(3)]
    jeng, teng, jreqs, treqs = _run_both(jx, lm, prompts, 6, 32, 2)
    assert all(len(r.out) == 6 for r in treqs)
    _check_engines(jx, prompts, jeng, teng, jreqs, treqs, "engine")


def test_engine_rejects_empty_prompt(lm):
    eng = Engine(CFG, lm, max_seq=32, n_slots=1)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.add(Request(prompt=np.zeros(0, np.int32), max_new=4))
    # The engine stays usable: no slot was consumed by the rejection.
    assert eng.add(Request(prompt=np.array([1, 2], np.int32), max_new=2))


def test_engine_rejects_oversized_prompt(lm):
    eng = Engine(CFG, lm, max_seq=8, n_slots=1)
    with pytest.raises(ValueError, match="exceeds"):
        eng.add(Request(prompt=np.arange(8, dtype=np.int32), max_new=2))
    assert eng.add(Request(prompt=np.arange(7, dtype=np.int32), max_new=2))
    # One slot: the next admission waits for it.
    assert not eng.add(Request(prompt=np.arange(3, dtype=np.int32),
                               max_new=2))


def test_engine_mixed_prompt_lengths(jx, lm):
    """Slots admitted with different prompt lengths decode at their own
    cache positions: each stream equals the request's greedy generation
    in the port, and the reference engine's stream."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, CFG.vocab, n, dtype=np.int32)
               for n in (3, 9)]
    refs = [generate_greedy(CFG, lm, p[None], max_new=5, max_seq=32)[0]
            for p in prompts]
    jeng, teng, jreqs, treqs = _run_both(jx, lm, prompts, 5, 32, 2)
    for req, ref in zip(treqs, refs):
        np.testing.assert_array_equal(np.asarray(req.out), ref)
    _check_engines(jx, prompts, jeng, teng, jreqs, treqs, "mixed lengths")


def test_engine_slot_reuse_isolated_from_predecessor(jx, lm):
    """A request admitted to a freed slot does not attend the previous
    occupant's KV rows."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, CFG.vocab, n, dtype=np.int32)
               for n in (5, 7, 4)]
    refs = [generate_greedy(CFG, lm, p[None], max_new=4, max_seq=32)[0]
            for p in prompts]
    jeng, teng, jreqs, treqs = _run_both(jx, lm, prompts, 4, 32, 2)
    for req, ref in zip(treqs, refs):
        np.testing.assert_array_equal(np.asarray(req.out), ref)
    _check_engines(jx, prompts, jeng, teng, jreqs, treqs, "slot reuse")


def test_engine_matches_generate(jx, lm):
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, CFG.vocab, 6, dtype=np.int32)
    ref = generate_greedy(CFG, lm, prompt[None], max_new=5, max_seq=32)[0]
    jeng, teng, jreqs, treqs = _run_both(jx, lm, [prompt], 5, 32, 1)
    np.testing.assert_array_equal(np.asarray(treqs[0].out), ref)
    _check_engines(jx, [prompt], jeng, teng, jreqs, treqs, "one slot")


def test_engine_stops_at_max_seq(jx, lm):
    """A slot that reaches max_seq - 1 finishes early and is freed."""
    prompt = np.arange(1, 6, dtype=np.int32)
    jeng, teng, jreqs, treqs = _run_both(jx, lm, [prompt], 20, 12, 1)
    assert treqs[0].done and len(treqs[0].out) == 12 - 1 - 5 + 1
    _check_engines(jx, [prompt], jeng, teng, jreqs, treqs, "max_seq")


def test_engine_sampler_is_pluggable(lm):
    """The sampler picks every token after the first (which the prefill's
    logits seed, as in the reference)."""
    eng = Engine(CFG, lm, max_seq=32, n_slots=2,
                 sampler=lambda logits: torch.full(
                     (logits.shape[0],), 7, dtype=torch.long))
    reqs = [Request(prompt=np.array([1, 2, 3], np.int32), max_new=4)
            for _ in range(2)]
    eng.run(reqs)
    first = generate_greedy(CFG, lm, np.array([[1, 2, 3]], np.int32),
                            max_new=1, max_seq=32)[0, 0]
    assert all(r.out == [first, 7, 7, 7] for r in reqs)


# -- speculative decoding (tests/test_speculative.py) ----------------------

def test_exact_greedy_equivalence(jx, lm):
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, CFG.vocab, 8, dtype=np.int32)
    ref = generate_greedy(CFG, lm, prompt[None], max_new=20, max_seq=96)[0]
    out, stats = SpeculativeDecoder(CFG, lm, max_seq=96, k=3).generate(
        prompt, max_new=20)
    np.testing.assert_array_equal(out, ref)
    jout, jstats = jx.spec.SpeculativeDecoder(
        jx.cfg, jx.params, max_seq=96, k=3).generate(prompt, max_new=20)
    if same_stream(jx, prompt, jout, out, "speculative"):
        assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)


def test_fewer_calls_on_repetitive_stream(jx, lm):
    """Greedy generation converges to a loop; once the history repeats,
    n-gram proposals verify and calls/token drops below 1 -- with the
    reference's counts."""
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, CFG.vocab, 8, dtype=np.int32)
    out, stats = SpeculativeDecoder(CFG, lm, max_seq=160, k=3).generate(
        prompt, max_new=48)
    assert stats.tokens_out == 48
    assert stats.tokens_per_call > 1.0, stats
    jout, jstats = jx.spec.SpeculativeDecoder(
        jx.cfg, jx.params, max_seq=160, k=3).generate(prompt, max_new=48)
    if same_stream(jx, prompt, jout, out, "repetitive speculative"):
        assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)
        assert stats.acceptance == jstats.acceptance


def test_speculative_on_a_motif_prompt(jx, lm):
    """A prompt of a repeated motif: proposals come from the prompt
    itself; output equals greedy generation and the reference's."""
    motif = np.random.default_rng(4).integers(0, CFG.vocab, 6,
                                              dtype=np.int32)
    prompt = np.tile(motif, 4)
    ref = generate_greedy(CFG, lm, prompt[None], max_new=24, max_seq=96)[0]
    out, stats = SpeculativeDecoder(CFG, lm, max_seq=96, k=4).generate(
        prompt, max_new=24)
    np.testing.assert_array_equal(out, ref)
    assert stats.proposed > 0
    jout, jstats = jx.spec.SpeculativeDecoder(
        jx.cfg, jx.params, max_seq=96, k=4).generate(prompt, max_new=24)
    if same_stream(jx, prompt, jout, out, "motif speculative"):
        assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)


# -- the n-gram proposer --------------------------------------------------

def test_tokens_to_crumbs_matches_reference(jx):
    ids = np.random.default_rng(5).integers(0, 128_256, (3, 17))
    for a in (ids, ids[0], np.array([0, 1, 65_535, 65_536, 128_255])):
        np.testing.assert_array_equal(tng.tokens_to_crumbs(a),
                                      jx.ngram.tokens_to_crumbs(a))


def _histories():
    rng = np.random.default_rng(6)
    motif = rng.integers(0, 128_256, 5)
    yield "random", list(rng.integers(0, 256, 300)), list(
        rng.integers(0, 256, 4))
    rep = list(np.tile(motif, 6)) + list(rng.integers(0, 256, 40))
    yield "motif", rep, list(motif[:4])
    yield "long", list(rng.integers(0, 50, 2000)), list(
        rng.integers(0, 50, 4))
    yield "short", [3, 4, 5], [3, 4]
    yield "too short", [3, 4], [3, 4]
    # Ids 65,536 apart share their low 16 bits: the history holds
    # x + 65,536 and the suffix x; both packages propose what follows the
    # alias (the model then verifies it).
    x = [11, 22, 33, 44]
    yield "alias", [7] * 20 + [t + 65_536 for t in x] + [99, 98, 97, 96] + [
        5] * 10, x


@pytest.mark.parametrize("case", [c[0] for c in _histories()])
def test_propose_matches_reference(jx, case):
    hist, suffix = next((h, s) for n, h, s in _histories() if n == case)
    for fragment_tokens in (128, 16):
        got = tng.NgramSpeculator(fragment_tokens=fragment_tokens,
                                  device="cpu")
        want = jx.ngram.NgramSpeculator(fragment_tokens=fragment_tokens)
        got.feed(hist)
        want.feed(hist)
        (gt, gc), (wt, wc) = got.propose(suffix, k=4), want.propose(suffix,
                                                                     k=4)
        np.testing.assert_array_equal(gt, wt)
        assert gc == wc
        if case == "alias":
            assert list(gt) == [99, 98, 97, 96] and gc == 1.0


def test_verify_prefix(jx):
    for p, a in [([1, 2, 3], [1, 2, 4]), ([1], [2]), ([], [1]),
                 ([5, 6], [5, 6, 7])]:
        assert tng.verify(np.array(p), np.array(a)) == jx.ngram.verify(
            np.array(p), np.array(a))


# -- the launcher's lm workload -----------------------------------------

def test_lm_launcher_counts_match_reference(jx, lm, capsys, monkeypatch):
    """``--workload lm`` at the reference's defaults, the port on the
    reference's PRNGKey(0) weights: the same printed counts."""
    streams = []

    class Recording(jx.engine.Engine):
        def run(self, requests, max_steps=10_000):
            super().run(requests, max_steps)
            streams.extend(list(r.out) for r in requests)

    monkeypatch.setattr(jx.serve, "Engine", Recording)
    monkeypatch.setattr(sys, "argv", ["serve", "--workload", "lm"])
    assert jx.serve.main() is None
    ref_out = capsys.readouterr().out
    args = tserve.build_parser().parse_args(["--workload", "lm", "--device",
                                             "cpu"])
    got = tserve.run_lm(args, params=lm)
    port_out = capsys.readouterr().out
    served = r"served (\d+) requests, (\d+) tokens"
    assert re.search(served, port_out).groups() == re.search(
        served, ref_out).groups()
    assert (got["n_requests"], got["n_tokens"]) == (6, 96)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, CFG.vocab, 8, dtype=np.int32)
               for _ in range(6)]
    equal = [same_stream(jx, p, w, g, "launcher")
             for p, w, g in zip(prompts, streams, got["streams"])]
    if all(equal):
        acc = r"acceptance: (\d+/\d+)"
        assert re.search(acc, port_out).groups() == re.search(
            acc, ref_out).groups()
        assert f"{got['n_accepted']}/{got['n_tried']}" == re.search(
            acc, port_out).group(1)


def test_lm_launcher_seeded_run_on_cpu(capsys):
    """Without carried weights the launcher seeds its own model."""
    got = tserve.main(["--workload", "lm", "--device", "cpu",
                       "--requests", "2", "--max-new", "10"])
    assert got["n_tokens"] == 20 and got["n_tried"] == 8
    assert "served 2 requests, 20 tokens" in capsys.readouterr().out


def load_chip_smoke(monkeypatch):
    """``chip_smoke.py`` as a module with phase 10's sizes cut to smoke
    size, and a counting wrapper patched over ``match_swar`` (it stands in
    for the card's launch counter): (module, the count)."""
    import importlib.util
    from pathlib import Path

    from repro_torch.kernels import match_swar as ksw
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_lm", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for name, value in dict(LM_PROMPT_LEN=32, LM_MAX_NEW=8, LM_MAX_SEQ=96,
                            LM_SPEC_NEW=24, LM_MIN_PROMPT=4,
                            LM_REQUESTS=5, LM_LONG=64, LM_LONG_TAIL=4,
                            LM_MR_REQUESTS=3, LM_MR_NEW=6,
                            LM_CPU_REQUESTS=3, LM_CPU_NEW=3).items():
        monkeypatch.setattr(cs, name, value)
    count = {"match_swar": 0}
    kernel = ksw.match_swar

    def counting(*args, **kw):
        count["match_swar"] += 1
        return kernel(*args, **kw)
    monkeypatch.setattr(ksw, "match_swar", counting)
    return cs, count


def test_chip_smoke_lm_phase_rehearses_on_cpu(monkeypatch):
    """``chip_smoke.py``'s phase 10 at smoke size on the CPU: every check
    runs (a counting wrapper stands in for the card's launch counter)."""
    cs, count = load_chip_smoke(monkeypatch)
    serve = dataclasses.replace(CFG, kv_quant=True, param_dtype="bf16",
                                n_kv_heads=4)
    launches, info = cs.lm_phase(
        [("l1", CFG), ("l2", serve)],
        zero_counts=lambda: count.update(match_swar=0),
        read_counts=lambda: dict(count), sync=lambda: None, device="cpu",
        profile_step=False)
    assert launches == sum(v["spec_launches"]["match_swar"]
                           for v in info.values()) > 0
    for out in info.values():
        assert out["engine_tokens"] == 5 * 8 and out["engine_ties"] == 0
        assert out["spec_tokens"] >= 24 and not out["spec_tie"]
        assert out["err_verify"]["rel_l2"] <= 3e-2
        assert out["propose_launch"]["pattern_chars"] == 32


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_engine_and_speculator_match_cpu(cuda):
    """The smoke model on the card serves the same greedy streams as the
    same weights on the CPU, and its proposer launches ``match_swar``."""
    from repro_torch.kernels import match_swar
    cpu = tm.init_params(CFG, 0, device="cpu")
    card = tm.init_params(CFG, torch.Generator(device=cuda).manual_seed(0),
                          device=cuda)
    card.load_state_dict(cpu.state_dict())
    prompt = np.tile(np.arange(5, 11, dtype=np.int32), 3)
    want = generate_greedy(CFG, cpu, prompt[None], max_new=12, max_seq=64)
    got = generate_greedy(CFG, card, prompt[None], max_new=12, max_seq=64)
    np.testing.assert_array_equal(got, want)
    n0 = match_swar.match_swar.n_launches
    out, stats = SpeculativeDecoder(CFG, card, max_seq=64, k=4).generate(
        prompt, max_new=12)
    np.testing.assert_array_equal(out, want[0])
    assert match_swar.match_swar.n_launches > n0
