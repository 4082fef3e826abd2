"""Per-chunk reductions and host pulls (port of ``repro.match.merge``).

``ShardMerger`` is the one place chunk results are reduced and cross to
the host.  On one device there is nothing to merge across shards: every
reduction is a few torch ops on the chunk's device scores, and only the
reduced state is pulled.  The transfer counters (``reduced_pull_bytes``,
``block_pull_bytes``, ``n_pulls``) keep the JAX package's meaning; the
collective counters arrive with the multi-GPU slice.

* ``chunk_best``  -- per-row argmax / max over alignments.  Both
  ``torch.argmax`` and ``jnp.argmax`` return the first maximal index; the
  locations are cast to int32, ``jnp.argmax``'s type with x64 off.
  ``slice_best`` takes the same pair from a kernel that reduced in its
  epilogue (``match_mxu_best``, ``match_swar_best``) and only trims the
  padded columns.
* ``hot_mask`` / ``gather_rows`` -- the threshold reduction's sparse
  two-phase pull (integer-exact ``s >= ceil(t)``).
* ``or_`` / ``survivor_union`` -- the filter stage's union across
  patterns (on the device) and its one pull of the final bitmap.
* ``topk_*`` -- running global top-k under the total order (score desc,
  row asc); dead and padding entries carry the (-1, INT32_MAX) sentinel
  pair and sort last.  torch has no ``lexsort``: one int64 key
  ``(-score) << 32 | row`` sorts the same way.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.obs import NULL_OBS, Observability

# Sentinel pair for dead / padding top-k entries: any real row scores
# >= 0 and has an id strictly below ROW_SENTINEL, so sentinels sort
# strictly after every live candidate under (score desc, row asc).
ROW_SENTINEL = np.int32(np.iinfo(np.int32).max)
SCORE_SENTINEL = np.int32(-1)


class ShardMerger:
    """Chunk reductions + host pulls for one single-device engine."""

    def __init__(self, obs: Optional[Observability] = None):
        self.obs = obs if obs is not None else NULL_OBS
        self.reduced_pull_bytes = 0
        self.block_pull_bytes = 0
        self.n_pulls = 0

    @property
    def merge_path(self) -> str:
        """"host": one shard, nothing combines across devices."""
        return "host"

    def pull(self, x: torch.Tensor, *, kind: str = "reduced") -> np.ndarray:
        """Device tensor -> host ndarray (blocks on the device)."""
        tr = self.obs.tracer
        with tr.span("pull", {"kind": kind} if tr.enabled else None) as sp:
            out = x.cpu().numpy()
            self.n_pulls += 1
            if kind == "block":
                self.block_pull_bytes += out.nbytes
            else:
                self.reduced_pull_bytes += out.nbytes
            if tr.enabled:
                sp.set("bytes", int(out.nbytes))
        return out

    def chunk_best(self, scores: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(rows, L[, Q]) -> ((rows[, Q]) int32 argmax, (rows[, Q]) max)."""
        tr = self.obs.tracer
        with tr.span("merge", {"op": "best"} if tr.enabled else None):
            return (scores.argmax(dim=1).to(torch.int32),
                    scores.amax(dim=1))

    def slice_best(self, best_loc: torch.Tensor, best_score: torch.Tensor,
                   n_patterns: int, *, batched: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """A fused kernel's (rows, q >= n_patterns) best pair -> the
        ``chunk_best`` shapes: (rows, n_patterns) batched, else column 0
        as (rows,)."""
        tr = self.obs.tracer
        with tr.span("merge", {"op": "best"} if tr.enabled else None):
            if batched:
                return best_loc[:, :n_patterns], best_score[:, :n_patterns]
            return best_loc[:, 0], best_score[:, 0]

    def hot_mask(self, scores: torch.Tensor,
                 thr_int: np.ndarray) -> torch.Tensor:
        """(rows,) bool: any alignment (any query) reaches the threshold.

        ``thr_int`` is ``ceil(threshold)`` as int32 ((1,) or (Q,)): scores
        are integers, so the integer compare is exact.
        """
        tr = self.obs.tracer
        with tr.span("merge", {"op": "hot_mask"} if tr.enabled else None):
            t = torch.from_numpy(np.asarray(thr_int, np.int32)).to(
                scores.device)
            m = scores >= (t.view(1, 1, -1) if scores.ndim == 3 else t)
            return m.flatten(1).any(dim=1)

    def or_(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Elementwise OR (the filter stage's union across patterns)."""
        return a | b

    def gather_rows(self, arr: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
        """Rows ``idx`` (host int array) of a device tensor."""
        tr = self.obs.tracer
        with tr.span("merge",
                     {"op": "gather_rows"} if tr.enabled else None):
            i = torch.from_numpy(np.asarray(idx, np.int64)).to(arr.device)
            return arr.index_select(0, i)

    # -- top-k -------------------------------------------------------------------
    def topk_init(self, k: int, n_cols: int, device: torch.device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sentinel-filled running state ((k[, Q]) scores + rows)."""
        shape = (k, n_cols) if n_cols else (k,)
        return (torch.full(shape, int(SCORE_SENTINEL), dtype=torch.int32,
                           device=device),
                torch.full(shape, int(ROW_SENTINEL), dtype=torch.int32,
                           device=device))

    def topk_update(self, state, bs: torch.Tensor, *,
                    alive_chunk: np.ndarray, rows_np: np.ndarray):
        """Fold one chunk's best scores into the running top-k state.

        ``bs`` follows logical candidate order, ``rows_np`` carries the
        corpus ids and ``alive_chunk`` the in-chunk validity/tombstone
        mask.
        """
        st_s, st_r = state
        tr = self.obs.tracer
        with tr.span("merge", {"op": "topk"} if tr.enabled else None):
            dev = bs.device
            alive = torch.from_numpy(np.asarray(alive_chunk, bool)).to(dev)
            rows = torch.from_numpy(np.asarray(rows_np, np.int64)).to(dev)
            bs2 = bs if bs.ndim == 2 else bs[:, None]
            st_s2 = st_s if st_s.ndim == 2 else st_s[:, None]
            st_r2 = st_r if st_r.ndim == 2 else st_r[:, None]
            k = st_s2.shape[0]
            sc = torch.where(alive[:, None], bs2.to(torch.int64),
                             int(SCORE_SENTINEL))
            rw = torch.where(alive[:, None], rows[:, None].expand_as(bs2),
                             int(ROW_SENTINEL))
            cs = torch.cat([st_s2.to(torch.int64), sc], 0)
            cr = torch.cat([st_r2.to(torch.int64), rw], 0)
            # Scores are >= -1 and rows < 2**31, so the key orders
            # (score desc, row asc) exactly; equal keys are identical
            # sentinel pairs, whose order does not matter.
            key = torch.sort((-cs << 32) | cr, dim=0).values[:k]
            out_s = (-(key >> 32)).to(torch.int32)
            out_r = (key & 0xFFFFFFFF).to(torch.int32)
            if bs.ndim == 1:
                return out_s[:, 0], out_r[:, 0]
            return out_s, out_r

    def topk_finalize(self, state, n_alive: int, k: int):
        """Pull the state, trim sentinels: ((kk[, Q]) rows, scores) with
        kk = min(k, live candidates seen)."""
        st_s, st_r = state
        rows = self.pull(st_r, kind="reduced").astype(np.int64)
        scores = self.pull(st_s, kind="reduced")
        kk = min(int(k), int(n_alive))
        return rows[:kk], scores[:kk]

    # -- filter survivor union -------------------------------------------------
    def survivor_union(self, flags: torch.Tensor, n_rows: int) -> np.ndarray:
        """(R_pad, 1) candidate flags -> (n_rows,) bool, in one pull.

        On one device the union across patterns already happened on the
        device (``or_``); only the final bitmap crosses to the host.
        """
        out = self.pull(flags, kind="reduced")
        return out[:n_rows, 0].astype(bool)
