"""A fused batched query's best pair crosses to the host query-major.

``ShardMerger.pull(..., query_major=True)`` transposes a (rows, Q) block
on the device after the cross-shard join and un-permute, so the engine's
per-chunk blocks arrive as C-contiguous (Q, rows) arrays and the batched
result's ``best_locs`` / ``best_scores`` are F-contiguous (R, Q): each
query's column is contiguous memory for the service's scatter.  On the
CPU, no JAX:

* the pull on a 2-shard cyclic value equals today's un-permuted pull,
  transposed;
* over reduction x rows (whole corpus, a row subset, tombstoned rows) x
  shards (1, 2 on the CPU), the fused result keeps its (R, Q) shape and
  dtype, is F-contiguous, and equals the solo queries element for
  element, dead-row sentinels included; every array the scatter returns
  is C-contiguous and owns its data.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import repro_torch.match as tm
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_row_mesh
from repro_torch.match.merge import ShardMerger

ROWS, F, P, CHUNK = 256, 64, 12, 32
SOURCES = (3, 200, 77)
SUBSET = np.array([250, 3, 17, 200, 18, 77, 128, 5, 64, 99], np.int64)
DEAD = np.arange(1, ROWS, 9)          # includes 199 and 73
SCATTERED = ("best_locs", "best_scores", "scores", "topk_rows",
             "topk_scores", "hits", "survivor_rows")


def test_pull_query_major_is_the_transposed_unpermuted_pull():
    S, J, Q = 2, 24, 5
    m = ShardMerger(mesh=make_row_mesh(S, devices=["cpu"] * S), n_shards=S)
    g = torch.arange(S * J * Q, dtype=torch.int32).view(S * J, Q)
    # Physical, shard-major order: shard s holds logical rows j*S + s.
    phys = sharding.cyclic_permute(g, S)
    shards = [phys[s * J:(s + 1) * J].clone() for s in range(S)]
    want = m.pull(shards, unpermute=True)
    np.testing.assert_array_equal(want, g.numpy())
    got = m.pull(shards, unpermute=True, query_major=True)
    assert got.shape == (Q, S * J) and got.flags.c_contiguous
    np.testing.assert_array_equal(got, want.T)
    # One tensor, no join: the same transpose.
    one = m.pull(g, query_major=True)
    assert one.flags.c_contiguous
    np.testing.assert_array_equal(one, g.numpy().T)


def queries(frags: np.ndarray, reduction: str, rows):
    kw = dict(reduction=reduction, chunk_rows=CHUNK, rows=rows)
    if reduction == "threshold":
        kw.update(threshold=float(P - 2), filter=False)
    if reduction == "topk":
        kw.update(k=4)
    return [tm.MatchQuery.exact(frags[r, 5:5 + P].copy(), **kw)
            for r in SOURCES]


@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("rows", ["all", "subset", "tombstoned"])
@pytest.mark.parametrize("reduction", ["best", "threshold", "topk"])
def test_fused_best_pair_is_query_major(reduction, rows, n_shards):
    frags = np.random.default_rng(35).integers(0, 4, (ROWS, F), np.uint8)
    kw = (dict(device="cpu") if n_shards == 1 else
          dict(mesh=make_row_mesh(n_shards, devices=["cpu"] * n_shards)))
    eng = tm.MatchEngine(frags, **kw)
    assert eng.n_shards == n_shards
    if rows == "tombstoned":
        eng.corpus.tombstone(DEAD)
    qs = queries(frags, reduction, SUBSET if rows == "subset" else None)
    fused = []
    engine_match = eng.match

    def match(query):
        fused.append(engine_match(query))
        return fused[-1]
    eng.match = match
    svc = tm.MatchService(eng)
    tickets = [svc.submit(q) for q in qs]
    svc.tick()
    assert svc.stats.n_coalesced_launches == 1
    (res,) = fused
    n_rows = len(SUBSET) if rows == "subset" else ROWS
    for a in (res.best_locs, res.best_scores):
        assert a.shape == (n_rows, len(qs))
        assert a.flags.f_contiguous and not a.flags.c_contiguous
    solos = [engine_match(q) for q in qs]
    assert res.best_locs.dtype == solos[0].best_locs.dtype
    assert res.best_scores.dtype == solos[0].best_scores.dtype
    for q, (t, solo) in enumerate(zip(tickets, solos)):
        assert t.done and t.error is None
        np.testing.assert_array_equal(res.best_locs[:, q], solo.best_locs)
        np.testing.assert_array_equal(res.best_scores[:, q],
                                      solo.best_scores)
        for f in SCATTERED:
            got, want = getattr(t.result, f), getattr(solo, f)
            assert (got is None) == (want is None), f
            if got is None:
                continue
            assert got.dtype == want.dtype, f
            np.testing.assert_array_equal(got, want, err_msg=f)
            assert got.flags.c_contiguous and got.flags.owndata, f
    if rows == "tombstoned":
        assert (res.best_scores[DEAD] == -1).all()
        assert (res.best_locs[DEAD] == 0).all()
