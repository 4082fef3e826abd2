"""Device-resident growable packed corpus (port of ``repro.match.corpus``).

The reference never moves once laid out: the fragment matrix is packed
*once* into the two kernel-native forms, both stay resident on the
device, and every later query is served from them.

* SWAR form    -- (C_pad, W) int32 carrying uint32 words, 16 two-bit chars
  per word, rows padded to ``match_swar.ROW_TILE``; read by the SWAR
  kernels.
* one-hot form -- (C_pad, F4) bf16, char-major flattened one-hot; read by
  the tensor-core kernel.

Both forms are built lazily on first use, on the device, from the uint8
codes (the host never builds the 4-byte-per-channel one-hot, which would
be ~5 GB at a human chromosome), and zero-extended on the device when a
query needs wider rows.  ``swar_pack_count`` / ``onehot_pack_count``
count full-corpus packing events; the steady state never repacks.

The corpus grows in place: ``capacity`` row slots are reserved (doubled
on demand), ``append_rows`` / ``set_rows`` pack only the touched rows and
write them into the resident forms in place, ``tombstone`` marks rows
dead without moving anything (the engine masks them out), and
``compact`` shifts the live tail down and rewrites only the moved rows.
``generation`` bumps on every content mutation.

Derived forms (the q-gram ``CorpusIndex``) attach as observers
(``attach_index``) and ride the same mutation events: row splices,
capacity growth and ``invalidate``.

Row shards (``shard_rows``, set by an engine built on a row mesh): each
form is a list of per-shard tensors, shard ``s``'s on its own device.
Logical row ``r`` lives on shard ``r % S`` at slot ``r // S`` (the cyclic
layout of ``repro_torch.distributed.sharding``), each shard holds
``shard_stride`` slots, and row padding rises to ``ROW_TILE * S``.  Appends
round-robin over the shards, growth zero-extends each shard in place (a
row never changes shard or slot), and a splice writes each touched row
at its shard and slot; packing stays one event a form, not one a shard.
With one shard the list holds the one form of the whole corpus.

On a mesh that spans processes (one process a card, ``launch.cluster``)
each process holds only its own shards: ``devices`` and every per-shard
list hold ``None`` for a shard another process owns.  The host fragment
buffer stays whole on every process (every ingest call presents the same
rows everywhere, the SPMD discipline); packing, growth, splices and
``compact`` touch only the local shards, and the pack counters stay flat
per process (one event a form on each).  This is the counterpart of the
JAX corpus's per-host packing.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import encoding
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import first_local
from repro_torch.kernels import match_swar as _swar
from repro_torch.obs import NULL_OBS

ROW_TILE = _swar.ROW_TILE
# Rows packed per step on the device (bounds the int64 / bool temporaries).
PACK_ROW_BLOCK = 1 << 16


def _as_i32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensor carrying the same bits."""
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def pack_words(codes: torch.Tensor, n_words: int) -> torch.Tensor:
    """(n, F) uint8 codes -> (n, n_words) int32 SWAR words (LSB-first).

    Bit-identical to ``encoding.pack_codes_u32`` (zero-padded to
    ``n_words``), computed on the codes' device.
    """
    n, F = codes.shape
    lanes = torch.zeros((n, n_words * 16), dtype=torch.int64,
                        device=codes.device)
    lanes[:, :F] = codes
    shifts = 2 * torch.arange(16, device=codes.device)
    return _as_i32((lanes.view(n, n_words, 16) << shifts).sum(-1))


def one_hot_flat(codes: torch.Tensor, width: int) -> torch.Tensor:
    """(n, F) uint8 codes -> (n, width) bf16 char-major one-hot, zero padded."""
    n, F = codes.shape
    out = torch.zeros((n, width), dtype=torch.bfloat16, device=codes.device)
    chans = torch.arange(4, dtype=torch.uint8, device=codes.device)
    out[:, :F * 4] = (codes[..., None] == chans).reshape(n, F * 4)
    return out


class PackedCorpus:
    """Fragments packed once into device-resident, growable kernel forms.

    ``fragments`` is the (R, F) uint8 code matrix of *live* rows (the host
    copy stays the source of truth for incremental updates and for the
    ``ref`` backend); ``capacity`` row slots are reserved so appends are
    in-place row writes.  ``device=None`` means the CUDA device.
    """

    def __init__(self, fragments: np.ndarray, *, row_pad: int = ROW_TILE,
                 capacity: Optional[int] = None, device: DeviceLike = None):
        self.device = resolve_device(device)
        # Own copy: set_rows/append_rows mutate, and the caller's array
        # must not change underneath the packed device forms.
        fragments = np.array(fragments, np.uint8)
        if fragments.ndim != 2:
            raise ValueError("fragments must be (R, F)")
        if row_pad % ROW_TILE:
            raise ValueError(f"row_pad must be a multiple of {ROW_TILE}")
        self.row_pad = row_pad
        self._n_rows = fragments.shape[0]
        cap = max(self._n_rows, 0 if capacity is None else int(capacity))
        if cap > self._n_rows:
            buf = np.zeros((cap, fragments.shape[1]), np.uint8)
            buf[:self._n_rows] = fragments
            fragments = buf
        self._frags = fragments               # (capacity, F) host buffer
        # Row-shard layout, set by an engine on a row mesh (shard_rows).
        self.n_shards = 1
        self._mesh = None
        self._devices = (self.device,)
        # Cached device forms (lazy), one tensor a shard, each sized to
        # the shard's padded slots: (J, W) int32 words, (J, F4) bf16.
        self._swar: Optional[List[torch.Tensor]] = None
        self._onehot: Optional[List[torch.Tensor]] = None
        self.obs = NULL_OBS
        # Full-corpus packing events, per form.
        self.swar_pack_count = 0
        self.onehot_pack_count = 0
        # Incremental row writes (in-place splices, not repacks).
        self.row_update_count = 0
        self.generation = 0
        # Tombstone mask over the capacity buffer: a dead row stays
        # resident (its device rows are untouched) but reductions mask
        # it out; compact() reclaims the slots.
        self._dead = np.zeros(self.capacity, bool)
        self.n_dead = 0
        self.n_compactions = 0
        # Derived-form observers (CorpusIndex), notified on every row
        # splice, capacity growth and invalidate.
        self._indexes: list = []

    # -- geometry ------------------------------------------------------------
    @property
    def fragments(self) -> np.ndarray:
        """(n_rows, F) live rows -- a view into the capacity buffer."""
        return self._frags[:self._n_rows]

    @property
    def n_rows(self) -> int:
        """Live (appended) rows; grows under ``append_rows``."""
        return self._n_rows

    @property
    def capacity(self) -> int:
        """Reserved row slots; appends within capacity never reallocate."""
        return self._frags.shape[0]

    @property
    def fragment_chars(self) -> int:
        return self._frags.shape[1]

    @property
    def n_rows_padded(self) -> int:
        """Live rows rounded up to ``row_pad`` (what queries stream over)."""
        return -(-self._n_rows // self.row_pad) * self.row_pad

    @property
    def capacity_padded(self) -> int:
        """Capacity rounded up to ``row_pad`` (device-form row count)."""
        return -(-self.capacity // self.row_pad) * self.row_pad

    @property
    def host_pack_count(self) -> int:
        """Total full-corpus packing events (both forms)."""
        return self.swar_pack_count + self.onehot_pack_count

    # -- tombstones ------------------------------------------------------------
    @property
    def n_live(self) -> int:
        """Rows that are appended and not tombstoned."""
        return self._n_rows - self.n_dead

    @property
    def dead_mask(self) -> np.ndarray:
        """(n_rows,) bool tombstone mask over the live region (read-only)."""
        m = self._dead[:self._n_rows]
        m.flags.writeable = False
        return m

    def live_row_ids(self) -> np.ndarray:
        """Ascending logical ids of non-tombstoned rows."""
        return np.flatnonzero(~self._dead[:self._n_rows])

    # -- row sharding ----------------------------------------------------------
    @property
    def shard_stride(self) -> int:
        """Slots a shard holds, J: logical row r sits at slot r // S of
        shard r % S (physical index (r % S) * J + r // S)."""
        return self.capacity_padded // self.n_shards

    @property
    def devices(self) -> tuple:
        """One device a shard (the corpus's own device when unsharded);
        ``None`` for a shard another process owns."""
        return self._devices

    @property
    def local_shards(self) -> List[int]:
        """The shards this process holds."""
        return [s for s, d in enumerate(self._devices) if d is not None]

    def _shard_live(self, s: int) -> int:
        S, n = self.n_shards, self._n_rows
        return max(0, (n - s + S - 1) // S)

    @property
    def shard_live_rows(self) -> np.ndarray:
        """(S,) logical rows per shard under the cyclic layout.

        Shard ``s`` holds rows ``{r < n_rows : r % S == s}``; contiguous
        appends round-robin, so counts differ by at most one row.
        """
        return np.array([self._shard_live(s) for s in range(self.n_shards)],
                        np.int64)

    def shard_rows(self, mesh, row_axes, n_shards: int) -> None:
        """Configure the cyclic row layout over ``mesh.devices``.

        Called by the engine after resolving the mesh row axes
        (``row_axes``, the reference's argument: a shard goes to its
        device of ``mesh.devices``, ``None`` where another process owns
        it).  Raises ``row_pad`` to a
        multiple of ``ROW_TILE * n_shards`` and drops the cached forms
        when the layout changes (forms built for another shard count are
        laid out differently).  Reconfiguring to the same layout is a
        no-op: no repack, no generation bump.
        """
        n_shards = max(1, int(n_shards))
        need_pad = ROW_TILE * n_shards
        relayout = (n_shards != self.n_shards
                    or self.row_pad % need_pad != 0
                    or (n_shards > 1 and self._mesh is not None
                        and mesh != self._mesh))
        self._mesh = mesh
        self.n_shards = n_shards
        self._devices = (tuple(mesh.devices) if n_shards > 1
                         else (self.device,))
        if not relayout:
            return
        if self.row_pad % need_pad:
            self.row_pad = need_pad
        if (self._swar is not None or self._onehot is not None
                or self._indexes):
            self.invalidate()

    def attach_index(self, index) -> None:
        """Register a derived-form observer (see ``match.index``).

        The observer must expose ``_on_rows_written(start, rows)``,
        ``_on_capacity()`` and ``_on_invalidate()``.
        """
        self._indexes.append(index)

    def detach_index(self, index) -> None:
        """Stop notifying (and so stop updating) an attached observer.

        An abandoned index otherwise keeps re-deriving signatures on every
        row splice and pins its device form; detaching one that is not
        attached is a no-op.
        """
        self._indexes = [ix for ix in self._indexes if ix is not index]

    @classmethod
    def from_reference(cls, ref_codes: np.ndarray, fragment_len: int,
                       pattern_len: int, *, row_pad: int = ROW_TILE,
                       device: DeviceLike = None) -> "PackedCorpus":
        """Fold a long reference into overlapping rows (Fig. 3 layout)."""
        frags = encoding.fold_reference(ref_codes, fragment_len, pattern_len)
        return cls(frags, row_pad=row_pad, device=device)

    # -- packing -------------------------------------------------------------
    def _shard_codes(self, s: int, j0: int, j1: int) -> torch.Tensor:
        """uint8 codes of shard ``s``'s slots [j0, j1) on its device (the
        logical rows s + j*S)."""
        S = self.n_shards
        rows = self._frags[s + j0 * S:s + j1 * S:S]
        return torch.from_numpy(np.ascontiguousarray(rows)).to(
            self._devices[s])

    def _pack_form(self, width: int, dtype: torch.dtype, pack
                   ) -> List[torch.Tensor]:
        """Full-capacity form, a tensor a shard: live rows packed on the
        shard's device, the rest 0."""
        forms: List[Optional[torch.Tensor]] = []
        for s in range(self.n_shards):
            if self._devices[s] is None:
                forms.append(None)
                continue
            form = torch.zeros((self.shard_stride, width), dtype=dtype,
                               device=self._devices[s])
            live = self._shard_live(s)
            for j0 in range(0, live, PACK_ROW_BLOCK):
                j1 = min(j0 + PACK_ROW_BLOCK, live)
                form[j0:j1] = pack(self._shard_codes(s, j0, j1), width)
            forms.append(form)
        return forms

    def _one_form(self, forms: List[torch.Tensor], name: str
                  ) -> torch.Tensor:
        if self.n_shards > 1:
            raise ValueError(
                f"a {self.n_shards}-shard corpus holds its {name} form a "
                f"tensor a shard: read {name}_shards()")
        return forms[0]

    def swar_words(self, need_words: int) -> torch.Tensor:
        """(C_pad, W >= need_words) int32 SWAR words of an unsharded
        corpus (``swar_shards`` for a sharded one)."""
        return self._one_form(self.swar_shards(need_words), "swar")

    def onehot_flat(self, f_chars: int) -> torch.Tensor:
        """(C_pad, F4 >= f_chars*4) bf16 one-hot of an unsharded corpus
        (``onehot_shards`` for a sharded one)."""
        return self._one_form(self.onehot_shards(f_chars), "onehot")

    def swar_shards(self, need_words: int) -> List[torch.Tensor]:
        """A (J, W >= need_words) int32 SWAR form a shard, device-resident.

        The first call packs (one event, however many shards); later
        calls reuse the cached forms, zero-extending their word axis on
        the device when a query needs deeper reads.  Reserved rows are
        zero words (code 0 packs to 0), so appends are pure row writes.
        """
        if self._swar is None:
            tr = self.obs.tracer
            with tr.span("pack",
                         {"form": "swar", "rows": self.capacity_padded}
                         if tr.enabled else None):
                width = max(-(-self.fragment_chars // 16), need_words)
                self._swar = self._pack_form(width, torch.int32, pack_words)
            self.swar_pack_count += 1
            self.obs.metrics.counter("corpus.packs").inc()
        elif first_local(self._swar).shape[1] < need_words:
            self._swar = [self._grow_cols(f, need_words) for f in self._swar]
        return self._swar

    def onehot_shards(self, f_chars: int) -> List[torch.Tensor]:
        """A (J, F4 >= f_chars*4) bf16 one-hot form a shard.

        Padding chars and reserved rows are all-zero one-hot (contribute 0
        to every score), so growing either way is a zero-extension on the
        device.
        """
        if self._onehot is None:
            tr = self.obs.tracer
            with tr.span("pack",
                         {"form": "onehot", "rows": self.capacity_padded}
                         if tr.enabled else None):
                width = max(f_chars, self.fragment_chars) * 4
                self._onehot = self._pack_form(width, torch.bfloat16,
                                               one_hot_flat)
            self.onehot_pack_count += 1
            self.obs.metrics.counter("corpus.packs").inc()
        elif first_local(self._onehot).shape[1] < f_chars * 4:
            self._onehot = [self._grow_cols(f, f_chars * 4)
                            for f in self._onehot]
        return self._onehot

    @staticmethod
    def _grow_cols(form: Optional[torch.Tensor], width: int
                   ) -> Optional[torch.Tensor]:
        if form is None:
            return None
        pad = torch.zeros((form.shape[0], width - form.shape[1]),
                          dtype=form.dtype, device=form.device)
        return torch.cat([form, pad], 1)

    @staticmethod
    def _grow_rows(form: Optional[torch.Tensor], rows: int
                   ) -> Optional[torch.Tensor]:
        if form is None:
            return None
        pad = torch.zeros((rows - form.shape[0], form.shape[1]),
                          dtype=form.dtype, device=form.device)
        return torch.cat([form, pad], 0)

    # -- growth ----------------------------------------------------------------
    def reserve(self, capacity: int) -> None:
        """Grow reserved row slots to at least ``capacity``, in place.

        The host buffer extends with zero rows and each shard's cached
        forms zero-extend on its device -- a row keeps its shard and slot,
        resident rows are never re-read or repacked, the pack counters
        and ``generation`` do not move.
        """
        capacity = int(capacity)
        if capacity < self._n_rows:
            raise ValueError(
                f"cannot reserve capacity {capacity} below the live row "
                f"count: corpus holds {self._n_rows} live rows (capacity "
                f"{self.capacity}); shrinking a PackedCorpus is not "
                "supported")
        if capacity <= self.capacity:
            return
        grow = np.zeros((capacity - self.capacity, self.fragment_chars),
                        np.uint8)
        self._dead = np.concatenate(
            [self._dead, np.zeros(capacity - self.capacity, bool)])
        self._frags = np.concatenate([self._frags, grow], 0)
        j = self.shard_stride
        if self._swar is not None and first_local(self._swar).shape[0] < j:
            self._swar = [self._grow_rows(f, j) for f in self._swar]
        if (self._onehot is not None
                and first_local(self._onehot).shape[0] < j):
            self._onehot = [self._grow_rows(f, j) for f in self._onehot]
        for ix in self._indexes:
            ix._on_capacity()

    def append_rows(self, rows: np.ndarray) -> int:
        """Append live rows in place; returns the first new row's index.

        Packs only the appended rows and writes them into the cached
        device forms.  Capacity doubles on demand; ``generation`` bumps
        once per non-empty call.
        """
        rows = np.asarray(rows, np.uint8)
        if rows.ndim == 1:
            rows = rows[None, :]
        if rows.ndim != 2 or rows.shape[1] != self.fragment_chars:
            raise ValueError(
                f"appended rows must be (n, {self.fragment_chars}); got "
                f"shape {rows.shape}")
        n = rows.shape[0]
        if n == 0:
            return self._n_rows
        start = self._n_rows
        if start + n > self.capacity:
            self.reserve(max(self.capacity * 2, start + n, ROW_TILE))
        self._frags[start:start + n] = rows
        self._n_rows = start + n
        self._splice_device(start, rows)
        self.generation += 1
        return start

    # -- incremental updates ---------------------------------------------------
    def shard_slices(self, start: int, n: int):
        """Logical rows [start, start+n) by local shard: ``(s, i0, j0, m)``
        for each shard of this process holding some, where ``rows[i0::S]``
        (m rows) are shard ``s``'s slots [j0, j0+m)."""
        S = self.n_shards
        out = []
        for s in self.local_shards:
            i0 = (s - start) % S
            if i0 < n:
                out.append((s, i0, (start + i0) // S, -(-(n - i0) // S)))
        return out

    def _splice_device(self, start: int, rows: np.ndarray) -> None:
        """Pack ``rows`` (touched rows only) into the cached forms, in place.

        Each row lands at its shard and slot.  The resident forms are
        updated in place (torch tensors are mutable, unlike the JAX arrays
        the reference rebuilds with ``.at[].set``); work queued earlier on
        the stream has already read them, so no in-flight query sees a
        half-written form.
        """
        tr = self.obs.tracer
        with tr.span("pack",
                     {"form": "splice", "rows": rows.shape[0]}
                     if tr.enabled else None):
            n = rows.shape[0]
            if self._swar is not None or self._onehot is not None:
                S = self.n_shards
                for s, i0, j0, m in self.shard_slices(start, n):
                    codes = torch.from_numpy(np.ascontiguousarray(
                        rows[i0::S])).to(self._devices[s])
                    if self._swar is not None:
                        f = self._swar[s]
                        f[j0:j0 + m] = pack_words(codes, f.shape[1])
                    if self._onehot is not None:
                        f = self._onehot[s]
                        f[j0:j0 + m] = one_hot_flat(codes, f.shape[1])
            for ix in self._indexes:
                ix._on_rows_written(start, rows)
            self.row_update_count += n
        self.obs.metrics.counter("corpus.splice_rows").inc(rows.shape[0])

    def set_rows(self, start: int, rows: np.ndarray) -> None:
        """Overwrite live rows [start, start+n) -- packs only those rows."""
        rows = np.asarray(rows, np.uint8)
        if rows.ndim == 1:
            rows = rows[None, :]
        n = rows.shape[0]
        if rows.shape[1] != self.fragment_chars:
            raise ValueError(
                f"row width mismatch: rows have {rows.shape[1]} chars, "
                f"corpus fragments have {self.fragment_chars}")
        if start < 0 or start + n > self._n_rows:
            raise ValueError(
                f"row range [{start}, {start + n}) out of bounds for "
                f"{self._n_rows} live rows (capacity {self.capacity}); "
                "use append_rows to grow the corpus")
        self._frags[start:start + n] = rows
        self._splice_device(start, rows)
        self.generation += 1

    # -- eviction ----------------------------------------------------------------
    def tombstone(self, rows) -> int:
        """Mark live rows dead; returns how many were newly tombstoned.

        No device work: the mask is host state the engine's reductions
        honor (dead rows produce no threshold hits, are excluded from
        top-k, and report the -1 best-score sentinel).
        """
        rows = np.atleast_1d(np.asarray(rows, np.int64))
        if rows.size == 0:
            return 0
        if rows.min() < 0 or rows.max() >= self._n_rows:
            raise ValueError(
                f"tombstone rows must be in [0, {self._n_rows}), got "
                f"[{rows.min()}, {rows.max()}]")
        newly = int((~self._dead[rows]).sum())
        if newly:
            self._dead[rows] = True
            self.n_dead += newly
            self.generation += 1
            self.obs.metrics.counter("corpus.tombstoned_rows").inc(newly)
        return newly

    def compact(self) -> int:
        """Reclaim tombstoned slots; returns the number of rows dropped.

        Live rows shift down in the host buffer (order preserved) and only
        the rows at or after the first dead slot are re-spliced into the
        cached device forms; the vacated tail is zeroed like reserved
        capacity.  The pack counters stay flat.
        """
        if self.n_dead == 0:
            return 0
        tr = self.obs.tracer
        with tr.span("compact",
                     {"n_dead": self.n_dead} if tr.enabled else None):
            old_n = self._n_rows
            dead = self._dead[:old_n]
            first = int(np.argmax(dead))
            live_after = np.flatnonzero(~dead[first:]) + first
            new_n = first + live_after.size
            moved = np.array(self._frags[live_after])
            self._frags[first:new_n] = moved
            self._frags[new_n:old_n] = 0
            self._dead[:old_n] = False
            self.n_dead = 0
            self._n_rows = new_n
            self._splice_device(first, self._frags[first:old_n])
            self.generation += 1
            self.n_compactions += 1
        self.obs.metrics.counter("corpus.compactions").inc()
        return old_n - new_n

    def invalidate(self) -> None:
        """Drop cached device forms (next query repacks)."""
        self._swar = None
        self._onehot = None
        for ix in self._indexes:
            ix._on_invalidate()
        self.generation += 1
