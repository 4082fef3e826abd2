"""Per-chunk reductions, cross-shard merges and host pulls (port of
``repro.match.merge``).

``ShardMerger`` is the one place chunk results are reduced, combine
across row shards and cross to the host.  A *sharded value* is a list of
per-shard tensors, shard ``s``'s on its own device, in the corpus's
cyclic layout (shard ``s``'s slot ``j`` of a chunk starting at logical row
``c0`` is row ``c0 + j*S + s``); an entry is ``None`` where another
process owns the shard.  Reductions run shard by shard where the shard's
rows are; the reduced state then joins on the join device (this
process's first shard's device): the local shards ``torch.cat`` there
(``.to(dev, non_blocking=True)``; on one card the ``.to`` is a no-op)
and, on a mesh that spans processes, one ``all_gather`` over the group
brings every rank's block (``RowMesh.all_gather``: staged through the
host under gloo, device tensors under NCCL), so every rank holds the
same joined value and runs the same un-permute or merge on it.  The
join is the counterpart of the JAX package's ``all_gather`` under
``shard_map``; ``n_collectives`` and ``collective_bytes`` count it as the
reference counts its collectives (a ring's ``(S-1)/S`` of the joined
payload) at any process count, and ``collective_seconds`` is the host
time spent in the process group's collectives, staging included (a copy
to the host first waits for the device work queued before it).

* ``pull`` -- a tensor or a sharded value -> host ndarray; a sharded one
  is joined first and, with ``unpermute=True``, put back in logical row
  order on the device.  With ``query_major=True`` a (rows, Q) block is
  then transposed on the device and crosses as a C-contiguous (Q, rows)
  block: the engine pulls a batched query's best pair so, which makes
  each query's column contiguous host memory for the service's
  per-request scatter (a column of a row-major (R, Q) array is a strided
  read, a cache line per element).
* ``chunk_best``  -- per-row argmax / max over alignments.  Both
  ``torch.argmax`` and ``jnp.argmax`` return the first maximal index; the
  locations are cast to int32, ``jnp.argmax``'s type with x64 off.
  ``slice_best`` takes the same pair from a kernel that reduced in its
  epilogue (``match_mxu_best``, ``match_swar_best``) and only trims the
  padded columns.
* ``hot_mask`` / ``gather_rows`` -- the threshold reduction's sparse
  two-phase pull (integer-exact ``s >= ceil(t)``); a sharded gather takes
  each row from its shard and returns them in the order asked.
* ``or_`` / ``survivor_union`` -- the filter stage's union across
  patterns (on each shard's device) and its one pull of the final
  bitmap, in logical row order.
* ``topk_*`` -- running global top-k under the total order (score desc,
  row asc); dead and padding entries carry the (-1, INT32_MAX) sentinel
  pair and sort last.  torch has no ``lexsort``: one int64 key
  ``(-score) << 32 | row`` sorts the same way.  On a sharded chunk each
  shard first keeps its own top-k over the logical ids
  ``c0 + slot*S + s``; only those candidates join the running state,
  which every process holds alike.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.distributed import sharding as _sharding
from repro_torch.obs import NULL_OBS, Observability

# Sentinel pair for dead / padding top-k entries: any real row scores
# >= 0 and has an id strictly below ROW_SENTINEL, so sentinels sort
# strictly after every live candidate under (score desc, row asc).
ROW_SENTINEL = np.int32(np.iinfo(np.int32).max)
SCORE_SENTINEL = np.int32(-1)

Value = Union[torch.Tensor, List[Optional[torch.Tensor]]]


def _map(fn, x: Value) -> Value:
    """``fn`` on a tensor, or on each local shard of a sharded value."""
    if isinstance(x, list):
        return [None if t is None else fn(t) for t in x]
    return fn(x)


class ShardMerger:
    """Chunk reductions, cross-shard merges and host pulls for one engine.

    ``n_shards == 1`` is the one-device engine (``merge_path == "host"``);
    with shards, every cross-shard combine joins on the mesh's join device
    and, across processes, over the mesh's group (``merge_path ==
    "device"``).  ``row_axes`` (the mesh axes the rows shard over) is the
    reference's argument; the joins follow the mesh's shard list and do
    not read it.
    """

    def __init__(self, mesh=None, row_axes=None, n_shards: int = 1,
                 obs: Optional[Observability] = None):
        self.obs = obs if obs is not None else NULL_OBS
        self.n_shards = int(n_shards)
        self.mesh = mesh if self.n_shards > 1 else None
        # The join device: where cross-shard results meet before a pull.
        self.device = None if self.mesh is None else self.mesh.device
        self.multiprocess = self.mesh is not None and self.mesh.multiprocess
        self.collective_bytes = 0
        self.reduced_pull_bytes = 0
        self.block_pull_bytes = 0
        self.n_collectives = 0
        self.n_pulls = 0
        self.collective_seconds = 0.0

    @property
    def merge_path(self) -> str:
        """"device" when shards combine on the join device, else "host"."""
        return "device" if self.n_shards > 1 else "host"

    def _count_collective(self, nbytes: int) -> None:
        self.n_collectives += 1
        self.collective_bytes += (int(nbytes) * (self.n_shards - 1)
                                  ) // self.n_shards

    def _gather(self, g: Optional[torch.Tensor], rows=None) -> torch.Tensor:
        """This process's joined block -> every process's, in rank order
        (``RowMesh.all_gather``); timed into ``collective_seconds``."""
        t = time.perf_counter()
        out = self.mesh.all_gather(g, rows)
        self.collective_seconds += time.perf_counter() - t
        return out

    def join(self, parts: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
        """Per-shard blocks, each of one shape -> one tensor on the join
        device (physical, shard-major order): the local shards
        concatenated, then, across processes, every rank's block."""
        if len(parts) == 1:
            return parts[0]
        g = torch.cat([p.to(self.device, non_blocking=True)
                       for p in parts if p is not None], 0)
        if self.multiprocess:
            g = self._gather(g, [g.shape[0]] * self.mesh.world)
        return g

    def pull(self, x: Value, *, unpermute: bool = False,
             kind: str = "reduced", query_major: bool = False
             ) -> np.ndarray:
        """Device value -> host ndarray (blocks on the device).

        A sharded value joins on the join device first (one collective)
        and, with ``unpermute``, returns to logical row order there.
        ``query_major`` takes a (rows, Q) value and returns it as a
        C-contiguous (Q, rows) array, transposed on the device after the
        join and un-permute.  ``kind`` buckets the transfer accounting
        ("reduced" state vs. score "block").
        """
        tr = self.obs.tracer
        with tr.span("pull", {"kind": kind} if tr.enabled else None) as sp:
            if isinstance(x, list):
                g = self.join(x)
                if len(x) > 1:
                    if unpermute:
                        g = _sharding.cyclic_unpermute(
                            g, len(x)).contiguous()
                    self._count_collective(g.numel() * g.element_size())
                x = g
            if query_major:
                x = x.t().contiguous()
            out = x.cpu().numpy()
            self.n_pulls += 1
            if kind == "block":
                self.block_pull_bytes += out.nbytes
            else:
                self.reduced_pull_bytes += out.nbytes
            if tr.enabled:
                sp.set("bytes", int(out.nbytes))
        return out

    def chunk_best(self, scores: Value) -> Tuple[Value, Value]:
        """(rows, L[, Q]) -> ((rows[, Q]) int32 argmax, (rows[, Q]) max),
        shard by shard for a sharded value."""
        tr = self.obs.tracer
        with tr.span("merge", {"op": "best"} if tr.enabled else None):
            return (_map(lambda s: s.argmax(dim=1).to(torch.int32), scores),
                    _map(lambda s: s.amax(dim=1), scores))

    def slice_best(self, best_loc: Value, best_score: Value,
                   n_patterns: int, *, batched: bool
                   ) -> Tuple[Value, Value]:
        """A fused kernel's (rows, q >= n_patterns) best pair -> the
        ``chunk_best`` shapes: (rows, n_patterns) batched, else column 0
        as (rows,)."""
        tr = self.obs.tracer
        with tr.span("merge", {"op": "best"} if tr.enabled else None):
            if batched:
                return (_map(lambda t: t[:, :n_patterns], best_loc),
                        _map(lambda t: t[:, :n_patterns], best_score))
            return (_map(lambda t: t[:, 0], best_loc),
                    _map(lambda t: t[:, 0], best_score))

    def hot_mask(self, scores: Value, thr_int: np.ndarray) -> Value:
        """(rows,) bool: any alignment (any query) reaches the threshold.

        ``thr_int`` is ``ceil(threshold)`` as int32 ((1,) or (Q,)): scores
        are integers, so the integer compare is exact.
        """
        thr = np.asarray(thr_int, np.int32)

        def hot(s):
            t = torch.from_numpy(thr).to(s.device)
            m = s >= (t.view(1, 1, -1) if s.ndim == 3 else t)
            return m.flatten(1).any(dim=1)
        tr = self.obs.tracer
        with tr.span("merge", {"op": "hot_mask"} if tr.enabled else None):
            return _map(hot, scores)

    def or_(self, a: Value, b: Value) -> Value:
        """Elementwise OR (the filter stage's union across patterns), on
        each shard's device."""
        if isinstance(a, list):
            return [None if x is None else x | y for x, y in zip(a, b)]
        return a | b

    def gather_rows(self, arr: Value, idx: np.ndarray) -> torch.Tensor:
        """Rows ``idx`` (host int array) of a device tensor, or physical
        rows ``idx`` of a sharded value (position p is shard p // J, slot
        p % J), on the join device in the order of ``idx``."""
        idx = np.asarray(idx, np.int64)
        tr = self.obs.tracer
        with tr.span("merge",
                     {"op": "gather_rows"} if tr.enabled else None):
            if not isinstance(arr, list):
                i = torch.from_numpy(idx).to(arr.device)
                return arr.index_select(0, i)
            J = _sharding.first_local(arr).shape[0]
            owner = idx // J
            parts = []
            for s, a in enumerate(arr):
                pos = np.flatnonzero(owner == s)
                if a is not None and pos.size:
                    slots = torch.from_numpy(idx[pos] % J).to(a.device)
                    parts.append(a.index_select(0, slots))
            return self.join_rows(parts, np.argsort(owner, kind="stable"))

    def join_rows(self, parts: Sequence[torch.Tensor],
                  order: np.ndarray) -> torch.Tensor:
        """Row blocks of this process's shards -> one tensor on the join
        device holding every shard's rows: ``order`` lists, for the rows
        of every shard in shard order (each process's part of them in its
        ``parts``), the place each takes in the output.  The parts differ
        in size between processes (one may hold none), so the ranks
        exchange their counts first."""
        if len(parts) == 1 and self.n_shards == 1:
            return parts[0]
        g = (torch.cat([p.to(self.device, non_blocking=True)
                        for p in parts], 0) if parts else None)
        if self.multiprocess:
            g = self._gather(g)
        inv = np.empty_like(order)
        inv[order] = np.arange(order.size)
        out = g.index_select(0, torch.from_numpy(inv).to(g.device))
        self._count_collective(out.numel() * out.element_size())
        return out

    # -- top-k -------------------------------------------------------------------
    def topk_init(self, k: int, n_cols: int, device: torch.device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sentinel-filled running state ((k[, Q]) scores + rows)."""
        shape = (k, n_cols) if n_cols else (k,)
        return (torch.full(shape, int(SCORE_SENTINEL), dtype=torch.int32,
                           device=device),
                torch.full(shape, int(ROW_SENTINEL), dtype=torch.int32,
                           device=device))

    def topk_update(self, state, bs: Value, *, alive_chunk: np.ndarray,
                    rows_np: Optional[np.ndarray] = None, c0: int = 0,
                    phys: bool = False):
        """Fold one chunk's best scores into the running top-k state.

        ``phys=False``: ``bs`` follows logical candidate order,
        ``rows_np`` carries the corpus ids.  ``phys=True``: ``bs`` is a
        sharded chunk starting at logical row ``c0``; each shard keeps its
        top-k over its logical ids ``c0 + slot*S + s`` and only those
        candidates join the state on the join device.  ``alive_chunk`` is
        the in-chunk validity/tombstone mask over logical positions.
        """
        st_s, st_r = state
        alive_chunk = np.asarray(alive_chunk, bool)
        tr = self.obs.tracer
        with tr.span("merge", {"op": "topk"} if tr.enabled else None):
            st_s2 = st_s if st_s.ndim == 2 else st_s[:, None]
            st_r2 = st_r if st_r.ndim == 2 else st_r[:, None]
            k = st_s2.shape[0]
            if phys:
                S = len(bs)
                b0 = _sharding.first_local(bs)
                jc = b0.shape[0]
                # Logical position slot*S + s: shard s's mask is column s.
                alive_all = torch.from_numpy(alive_chunk).to(
                    b0.device).view(jc, S)
                cands: List[Optional[torch.Tensor]] = [None] * S
                for s, b in enumerate(bs):
                    if b is None:
                        continue
                    dev = b.device
                    alive = alive_all[:, s].to(dev)
                    rows = torch.arange(jc, device=dev) * S + (c0 + s)
                    keys = self._candidate_keys(b, rows, alive)
                    cands[s] = torch.sort(keys, dim=0).values[:k]
                if S > 1:
                    self.n_collectives += 1
                    q = b0.shape[1] if b0.ndim == 2 else 1
                    self.collective_bytes += (S - 1) * min(k, jc) * q * 12
                cand = self.join(cands)
                ndim = b0.ndim
            else:
                dev = bs.device
                alive = torch.from_numpy(alive_chunk).to(dev)
                rows = torch.from_numpy(np.asarray(rows_np, np.int64)).to(dev)
                cand = self._candidate_keys(bs, rows, alive)
                ndim = bs.ndim
            st_key = (-st_s2.to(torch.int64) << 32) | st_r2.to(torch.int64)
            key = torch.sort(torch.cat([st_key, cand.to(st_key.device)], 0),
                             dim=0).values[:k]
            out_s = (-(key >> 32)).to(torch.int32)
            out_r = (key & 0xFFFFFFFF).to(torch.int32)
            if ndim == 1:
                return out_s[:, 0], out_r[:, 0]
            return out_s, out_r

    @staticmethod
    def _candidate_keys(bs: torch.Tensor, rows: torch.Tensor,
                        alive: torch.Tensor) -> torch.Tensor:
        """(n[, Q]) best scores -> (n, Q) int64 keys ``(-score) << 32 |
        row``, dead rows as the sentinel pair.  Scores are >= -1 and rows
        < 2**31, so the keys order (score desc, row asc) exactly; equal
        keys are identical sentinel pairs, whose order does not matter."""
        bs2 = bs if bs.ndim == 2 else bs[:, None]
        sc = torch.where(alive[:, None], bs2.to(torch.int64),
                         int(SCORE_SENTINEL))
        rw = torch.where(alive[:, None], rows[:, None].expand_as(bs2),
                         int(ROW_SENTINEL))
        return (-sc << 32) | rw

    def topk_finalize(self, state, n_alive: int, k: int):
        """Pull the state, trim sentinels: ((kk[, Q]) rows, scores) with
        kk = min(k, live candidates seen)."""
        st_s, st_r = state
        rows = self.pull(st_r, kind="reduced").astype(np.int64)
        scores = self.pull(st_s, kind="reduced")
        kk = min(int(k), int(n_alive))
        return rows[:kk], scores[:kk]

    # -- filter survivor union -------------------------------------------------
    def survivor_union(self, flags: Value, n_rows: int) -> np.ndarray:
        """(R_pad, 1) candidate flags, or a shard's (jn, 1) each ->
        (n_rows,) logical bool, in one pull.

        The union across patterns already happened on each shard's
        device (``or_``); the shards join and return to logical row order
        on the join device, and only the final bitmap crosses to the host.
        """
        out = self.pull(flags, unpermute=True, kind="reduced")
        return out[:n_rows, 0].astype(bool)
