"""Standing-query bank parity: the port's ``PatternBank`` against the JAX
package's.

Both banks get the same registrations (seeded with numpy), the same
injected clock and the same document batches; the JAX bank runs its
kernels in Pallas interpret mode on the CPU, the port's runs the plain
versions (``device="cpu"``).  Hits (in the engine's doc, loc, launch-
column order), ``stats()``, ``hit_counts()``, the device forms and the
prefilter flags must be identical, with the prefilter forced on and off.
"""

import numpy as np
import pytest
import torch

import repro.match as jm
import repro_torch.match as tm
from repro.kernels import filter_qgram as jfq
from repro_torch import convert
from repro_torch.kernels import filter_qgram as tfq

F, P = 96, 16
N_PATTERNS = 40


def onehot(codes):
    return (np.uint8(1) << np.asarray(codes, np.uint8)).astype(np.uint8)


def make_docs(n=24, seed=0):
    return np.random.default_rng(seed).integers(0, 4, (n, F), np.uint8)


def specs(docs, seed=1):
    """(pattern, threshold) pairs: exact, wildcard and IUPAC patterns, some
    planted in the docs, thresholds P, P - 1 and P - 2."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(N_PATTERNS):
        s = "".join("ACGT"[c] for c in rng.integers(0, 4, P))
        if i % 7 == 3:
            s = "NN" + s[2:]
        elif i % 7 == 5:
            s = s[:6] + "RY" + s[8:]
        if i < 12:
            real = np.array([{"N": 0, "R": 0, "Y": 1}.get(ch, "ACGT".find(ch))
                             for ch in s], np.uint8)
            d, off = i, 3 + 5 * i
            docs[d, off:off + P] = real
        out.append((s, (P, P - 1, P - 2)[i % 3]))
    return out


class Pair:
    """One JAX bank and one port bank driven identically."""

    def __init__(self, filter, clock, capacity=16):
        self.j = jm.PatternBank(F, P, capacity=capacity, filter=filter,
                                clock=clock)
        self.t = tm.PatternBank(F, P, capacity=capacity, filter=filter,
                                clock=clock, device="cpu")

    def both(self, name, *args, **kw):
        a = getattr(self.j, name)(*args, **kw)
        b = getattr(self.t, name)(*args, **kw)
        return a, b

    def scan(self, docs):
        a, b = self.both("scan", docs)
        np.testing.assert_array_equal(b.hits, a.hits)
        assert b.hits.dtype == a.hits.dtype == np.int64
        for f in ("n_docs", "n_patterns", "n_verified", "survivor_frac",
                  "n_bank_launches"):
            assert getattr(a, f) == getattr(b, f), f
        assert a.plan.strategy == b.plan.strategy
        self.same_state()
        return b

    def same_state(self):
        assert self.j.stats() == self.t.stats()
        assert self.j.hit_counts() == self.t.hit_counts()
        np.testing.assert_array_equal(self.j.live_ids(), self.t.live_ids())


@pytest.mark.parametrize("filter", [True, False])
def test_bank_lifecycle_matches_jax(filter):
    clock = [0.0]
    docs = make_docs()
    pair = Pair(filter, lambda: clock[0])
    calls = []
    pids = []
    for i, (s, thr) in enumerate(specs(docs)):
        kw = {"ttl_s": 5.0} if i % 4 == 1 else {}
        if i == 0:
            kw["on_hit"] = lambda pid, hits: calls.append(hits.copy())
        a, b = pair.both("register", s, threshold=thr, **kw)
        assert a == b
        pids.append(a)
    pair.same_state()                            # capacity grew 16 -> 64
    t = pair.scan(docs)
    # The callback went to both banks: once each, with the same hits.
    assert t.hits.shape[0] >= 12 and len(calls) == 2
    np.testing.assert_array_equal(calls[0], calls[1])
    for pid in (pids[2], pids[7], pids[39]):
        pair.both("unregister", pid)
    pair.scan(docs[:9])
    clock[0] = 5.0
    a, b = pair.both("expire")
    assert a == b and len(a) == 10
    pair.scan(docs)
    pair.both("register", docs[4, 1:1 + P].copy(), threshold=P)
    t = pair.scan(np.concatenate([docs, docs[:3]]))
    assert pair.t.n_bank_launches == 4 == pair.t.n_scans
    assert pair.t.n_prefilter_launches == (4 if filter else 0)
    assert pair.t.plane_pack_count == 1
    assert pair.t.sig_pack_count == (1 if filter else 0)
    # The device forms carry across bit for bit.
    sigs, slacks = pair.j.filter_operands()
    planes, tsigs, tslacks = convert.bank_forms_from_numpy(
        np.asarray(pair.j.planes()), np.asarray(sigs), np.asarray(slacks),
        "cpu")
    assert torch.equal(pair.t.planes(), planes)
    assert torch.equal(pair.t.filter_operands()[0], tsigs)
    assert torch.equal(pair.t.filter_operands()[1], tslacks)


def test_filter_and_scan_hits_equal_and_match_adhoc():
    docs = make_docs(seed=5)
    tickets = {}
    for filter in (True, False):
        bank = tm.PatternBank(F, P, capacity=8, filter=filter,
                              device="cpu")
        for s, thr in specs(docs, seed=6):
            bank.register(s, threshold=thr)
        tickets[filter] = bank.scan(docs)
    np.testing.assert_array_equal(tickets[True].hits, tickets[False].hits)
    assert tickets[True].n_verified < tickets[False].n_verified
    engine = tm.MatchEngine(docs, device="cpu", index=False)
    for pid in bank.live_ids():
        mine = tickets[False].hits[tickets[False].hits[:, 2] == pid]
        want = engine.match(bank.pattern(pid).query).hits
        np.testing.assert_array_equal(mine[:, [0, 1, 3]], want)


def test_empty_batch_and_empty_bank_launch_nothing():
    docs = make_docs()
    bank = tm.PatternBank(F, P, device="cpu")
    assert bank.scan(docs).hits.shape == (0, 4) and bank.n_scans == 0
    bank.register(docs[0, :P].copy(), threshold=P)
    t = bank.scan(np.zeros((0, F), np.uint8))
    assert t.hits.shape == (0, 4) and bank.n_bank_launches == 0
    t = bank.scan(docs, base_row=100)
    assert (t.corpus_rows == 100 + t.hits[:, 0]).all()


@pytest.mark.parametrize("n_docs", [1, 8, 300])
def test_bank_prefilter_plain_matches_pallas(n_docs):
    import jax.numpy as jnp
    rng = np.random.default_rng(n_docs)
    Q, Wb = 2 * jfq.FILTER_ROW_TILE, 8
    psigs = rng.integers(0, 2**32, (Q, Wb), dtype=np.uint32)
    psigs &= rng.integers(0, 2**32, (Q, Wb), dtype=np.uint32)
    dsigs = rng.integers(0, 2**32, (n_docs, Wb), dtype=np.uint32)
    dsigs |= rng.integers(0, 2**32, (n_docs, Wb), dtype=np.uint32)
    if n_docs > 1:
        dsigs[n_docs // 2] = 0                  # an all-zero (pad) doc
    slacks = rng.integers(-1, 30, (Q, 1)).astype(np.int32)
    slacks[-40:] = -1                           # pad rows
    want = np.asarray(jfq.bank_prefilter(
        jnp.asarray(psigs), jnp.asarray(dsigs), jnp.asarray(slacks),
        interpret=True))
    got = tfq.bank_prefilter(*convert.bank_forms_from_numpy(
        psigs, dsigs, slacks, "cpu"))
    assert got.dtype == torch.int32 and got.shape == (Q, 1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < int(got.sum()) < Q - 40


def test_plan_bank_fields_match_jax():
    from repro.match import planner as jpl
    from repro_torch.match import planner as tpl
    names = [f for f in tpl.BankPlan.__dataclass_fields__]
    assert names == [f for f in jpl.BankPlan.__dataclass_fields__]
    for force in (True, False):
        for prunable in (True, False):
            kw = dict(n_docs=256, fragment_chars=500, pattern_chars=100,
                      n_patterns=4096, sig_words=8, survivor_frac=0.24,
                      prunable=prunable, force=force)
            a, b = jpl.Planner().plan_bank(**kw), tpl.Planner().plan_bank(**kw)
            for f in ("strategy", "n_docs", "n_patterns",
                      "est_survivor_frac", "est_verify_patterns"):
                assert getattr(a, f) == getattr(b, f), f
    with pytest.raises(ValueError, match="no documents"):
        tpl.Planner().plan_bank(n_docs=0, fragment_chars=F,
                                pattern_chars=P, n_patterns=1, sig_words=8,
                                survivor_frac=1.0)
