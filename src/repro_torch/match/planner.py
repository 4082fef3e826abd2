"""Query planner: workload shape -> kernel + geometry (port of
``repro.match.planner``).

Kernel selection by roofline arithmetic: estimate each kernel's compute
and memory terms, take ``max`` per kernel, pick the minimum.  Structural
constraints come first (the tensor-core formulation has no per-row
pattern path; a batched query on the SWAR kernel re-reads the corpus per
pattern, where the one-hot contraction amortizes the reference read
across patterns), and an explicit ``backend=`` override always wins.

The analytic layer prices against a ``GPURoofline`` (``H100`` by
default): the SWAR kernels are priced on the card's INT32 issue rate
(the role ``VPU_SLOWDOWN`` plays against the bf16 peak in the JAX
planner), the ``mxu`` backend on the tensor cores' bf16 rate.  Backend
*choices* may therefore differ from the JAX planner's; the geometry
(``_swar_geometry``, ``_mxu_geometry``, padding, chunking) is identical,
so a forced backend yields the same ``Plan`` geometry fields.

Not in this slice: the filter-then-verify pricing (``FilterContext``),
``plan_batch`` (the service slice), ``plan_bank`` (the standing-query
slice) and shard-aware pricing (multi-GPU slice).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.tech import (H100, CostSource, GPURoofline,
                                   StaticCostSource)
from repro_torch.kernels import match_mxu as _mxu
from repro_torch.kernels import match_swar as _swar
from repro_torch.match.feedback import FeedbackStore, kernel_key

BACKENDS = ("swar", "mxu", "ref")

# Below this many (row, loc, patchar, query) ops the kernel launch
# dominates and the plain torch reference is fastest (the static model's
# launch-overhead belief, as in the JAX planner).
TINY_OPS = 4096
# SWAR integer ops per (row, loc, word): funnel shift, xor, or/shift/and
# fold, popcount, accumulate.
SWAR_OPS_PER_WORD = 12
# Accept-set SWAR variant: four lane-equality tests + plane ANDs replace
# the single XOR (see match_swar_masks) -- ~2.5x the integer work.
SWAR_OPS_PER_WORD_MASKS = 30
# Plain torch reference throughput: only has to rank the ref backend
# sanely against the kernels.
REF_OPS_PER_S = 1e9


def kernel_name(backend: str, predicate: str = "exact") -> str:
    """Cost-model kernel identifier for a (backend, predicate) pair."""
    if backend == "swar" and predicate == "accept":
        return "swar_masks"
    return backend


# -- analytic layer: shape -> roofline seconds, no overheads ------------------

def analytic_swar_seconds(roofline: GPURoofline, R: int, L: int, P: int,
                          Q: int = 1, predicate: str = "exact") -> float:
    """Roofline seconds for one fused SWAR dispatch over Q pattern sets."""
    wp, need = _swar_geometry(P, L)
    if predicate == "accept":
        ops_per_word, pat_words = SWAR_OPS_PER_WORD_MASKS, 4 * wp
    else:
        ops_per_word, pat_words = SWAR_OPS_PER_WORD, wp
    ops = Q * R * L * wp * ops_per_word
    bytes_hbm = Q * (R * need * 4 + R * pat_words * 4 + R * L * 4)
    t_compute = ops / roofline.peak_int32_ops
    t_mem = bytes_hbm / roofline.hbm_bw
    return max(t_compute, t_mem)


def analytic_mxu_seconds(roofline: GPURoofline, R: int, L: int, P: int,
                         Q: int = 1) -> float:
    """Roofline seconds for one batched tensor-core pass over all Q."""
    l_pad, p_chars, q_pad, f_chars = _mxu_geometry(P, L, Q)
    n_chunks = p_chars // _mxu.CHARS_PER_CHUNK
    flops = R * l_pad * (n_chunks * _mxu.K_CHUNK) * 2 * q_pad
    bytes_hbm = (R * f_chars * 4 * 2 + p_chars * 4 * q_pad * 2
                 + R * l_pad * q_pad * 4)
    t_compute = flops / roofline.peak_bf16_flops
    t_mem = bytes_hbm / roofline.hbm_bw
    return max(t_compute, t_mem)


def analytic_ref_seconds(roofline: GPURoofline, R: int, L: int, P: int,
                         Q: int = 1) -> float:
    """Plain torch reference compute for Q passes (overhead per call)."""
    del roofline
    return Q * R * L * P / REF_OPS_PER_S


@dataclasses.dataclass(frozen=True)
class Plan:
    """Everything the executor needs to run one query (same fields as the
    JAX package's ``Plan``, so results compare field for field)."""

    backend: str                # "swar" | "mxu" | "ref"
    mode: str                   # "shared" | "per_row" | "batched"
    n_rows: int                 # R (unpadded)
    fragment_chars: int         # F
    pattern_chars: int          # P
    n_patterns: int             # Q (1 unless batched)
    n_locs: int                 # L = F - P + 1
    # SWAR geometry.
    wp: int = 0                 # pattern words
    need_words: int = 0         # min corpus word width incl. look-ahead pad
    # Tensor-core geometry.
    l_pad: int = 0              # alignment rows produced (mult of L_TILE)
    p_chars_pad: int = 0        # pattern chars padded to CHARS_PER_CHUNK
    q_pad: int = 0              # patterns padded to 128
    f_chars: int = 0            # one-hot reference chars needed
    # Streaming.
    chunk_rows: int = 0         # rows per executor chunk (mult of row tile)
    est_seconds: float = 0.0    # roofline estimate for the whole query
    reason: str = ""            # human-readable selection rationale
    predicate: str = "exact"    # "exact" | "accept" (accept-set masks)
    # Two-stage execution: always "scan" until the filter slice lands.
    strategy: str = "scan"
    filter_words: int = 0
    est_survivor_frac: float = 1.0
    n_shards: int = 1
    est_collective_bytes: float = 0.0
    cost_source: str = "static"
    est_base_seconds: float = 0.0
    est_filter_seconds: float = 0.0
    est_filter_base_seconds: float = 0.0


def _swar_geometry(P: int, L: int) -> tuple[int, int]:
    wp = -(-P // 16)
    need = (L - 1) // 16 + wp + 1
    return wp, need


def _mxu_geometry(P: int, L: int, Q: int) -> tuple[int, int, int, int]:
    n_chunks = -(-P // _mxu.CHARS_PER_CHUNK)
    p_chars = n_chunks * _mxu.CHARS_PER_CHUNK
    l_pad = max(-(-L // _mxu.L_TILE) * _mxu.L_TILE, _mxu.L_TILE)
    q_pad = -(-Q // 128) * 128
    return l_pad, p_chars, q_pad, l_pad + p_chars


class Planner:
    """Kernel selection: analytic roofline x cost source x runtime feedback."""

    def __init__(self, roofline: GPURoofline = H100,
                 memory_budget_bytes: float = 256 * 2**20,
                 cost_source: Optional[CostSource] = None,
                 feedback: Optional[FeedbackStore] = None):
        self.roofline = roofline
        self.memory_budget_bytes = memory_budget_bytes
        self.cost_source = cost_source or StaticCostSource()
        self.feedback = feedback if feedback is not None else FeedbackStore()

    # -- cost terms -----------------------------------------------------------
    def _price(self, kernel: str, analytic_s: float, n_dispatch: int,
               R: int, x: int, Q: int, base: bool) -> float:
        """Analytic seconds -> wall seconds via source, then feedback
        (skipped for ``base=True``, the estimate runtimes are recorded
        against)."""
        priced = self.cost_source.price(kernel, analytic_s, n_dispatch)
        if base:
            return priced
        return priced * self.feedback.factor(kernel_key(kernel, R, x, Q))

    def swar_seconds(self, R: int, L: int, P: int, Q: int = 1,
                     predicate: str = "exact", *, base: bool = False) -> float:
        """One fused SWAR dispatch over Q pattern sets (batched queries
        tile the corpus chunk Q times, so work scales with Q)."""
        analytic = analytic_swar_seconds(self.roofline, R, L, P, Q, predicate)
        return self._price(kernel_name("swar", predicate), analytic, 1,
                           R, P, Q, base)

    def ref_seconds(self, R: int, L: int, P: int, Q: int = 1,
                    *, base: bool = False) -> float:
        """Q plain-torch reference passes (batched ref still loops Q)."""
        analytic = analytic_ref_seconds(self.roofline, R, L, P, Q)
        return self._price("ref", analytic, Q, R, P, Q, base)

    def mxu_seconds(self, R: int, L: int, P: int, Q: int = 1,
                    *, base: bool = False) -> float:
        """One batched tensor-core pass over all Q patterns (identical for
        exact and accept-set predicates: a wildcard is a multi-hot
        column)."""
        analytic = analytic_mxu_seconds(self.roofline, R, L, P, Q)
        return self._price("mxu", analytic, 1, R, P, Q, base)

    def backend_seconds(self, backend: str, R: int, L: int, P: int,
                        Q: int = 1, predicate: str = "exact",
                        *, base: bool = False) -> float:
        """Price any scan backend by name."""
        if backend == "swar":
            return self.swar_seconds(R, L, P, Q, predicate, base=base)
        if backend == "mxu":
            return self.mxu_seconds(R, L, P, Q, base=base)
        return self.ref_seconds(R, L, P, Q, base=base)

    # -- chunking -------------------------------------------------------------
    def _chunk_rows(self, R_pad: int, plan_bytes_per_row: int,
                    row_tile: int, override: Optional[int]) -> int:
        """Rows per streaming chunk (a multiple of the row tile)."""
        if override is not None:
            chunk = -(-override // row_tile) * row_tile
        else:
            rows = int(self.memory_budget_bytes
                       // max(plan_bytes_per_row, 1))
            chunk = max(row_tile, (rows // row_tile) * row_tile)
        return min(chunk, R_pad)

    # -- the planner ----------------------------------------------------------
    def plan(self, *, n_rows: int, fragment_chars: int, pattern_chars: int,
             n_patterns: Optional[int] = None, per_row: bool = False,
             backend: Optional[str] = None,
             chunk_rows: Optional[int] = None,
             predicate: str = "exact") -> Plan:
        R, F, P = n_rows, fragment_chars, pattern_chars
        if R < 1:
            raise ValueError("corpus has no rows")
        if P < 1:
            raise ValueError("pattern must have at least one character")
        L = F - P + 1
        if L <= 0:
            raise ValueError("pattern longer than fragment")
        if per_row and n_patterns is not None:
            raise ValueError("per_row and batched are mutually exclusive")
        if predicate not in ("exact", "accept"):
            raise ValueError(f"unknown predicate {predicate!r}")
        Q = 1 if n_patterns is None else int(n_patterns)
        mode = "per_row" if per_row else ("batched" if n_patterns is not None
                                          else "shared")
        if backend is not None and backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        if backend == "mxu" and per_row:
            raise ValueError("mxu kernel has no per-row-pattern formulation")

        t_swar = self.swar_seconds(R, L, P, Q, predicate)
        t_mxu = self.mxu_seconds(R, L, P, Q)

        if backend is not None:
            chosen, reason = backend, "explicit override"
        elif per_row:
            chosen, reason = "swar", "per-row patterns: SWAR only"
        elif (self.cost_source.name == "static"
              and R * L * P * Q <= TINY_OPS):
            chosen, reason = "ref", "tiny workload: launch overhead dominates"
        elif t_mxu < t_swar:
            chosen = "mxu"
            reason = f"roofline: mxu {t_mxu:.3g}s < swar {t_swar:.3g}s (Q={Q})"
        else:
            chosen = "swar"
            reason = f"roofline: swar {t_swar:.3g}s <= mxu {t_mxu:.3g}s (Q={Q})"

        wp, need = _swar_geometry(P, L)
        l_pad, p_chars, q_pad, f_chars = _mxu_geometry(P, L, Q)
        row_pad = _swar.ROW_TILE
        R_pad = -(-R // row_pad) * row_pad

        if chosen == "swar":
            # Batched swar tiles each chunk Q times (one fused launch), so
            # a chunk's footprint scales with Q; accept-set planes are 4
            # words per pattern word.
            pat_words = 4 * wp if predicate == "accept" else wp
            bytes_per_row = (need * 4 + pat_words * 4 + L * 4) * Q
            row_tile = _swar.ROW_TILE
            est = t_swar
            est_base = self.swar_seconds(R, L, P, Q, predicate, base=True)
        elif chosen == "mxu":
            bytes_per_row = f_chars * 4 * 2 + l_pad * q_pad * 4
            row_tile = 1
            est = t_mxu
            est_base = self.mxu_seconds(R, L, P, Q, base=True)
        else:
            bytes_per_row = F + L * 4 * Q
            row_tile = 1
            est = self.ref_seconds(R, L, P, Q)
            est_base = self.ref_seconds(R, L, P, Q, base=True)
        chunk = self._chunk_rows(R_pad, bytes_per_row, row_tile, chunk_rows)

        reason += f" [cost={self.cost_source.tag}]"
        return Plan(backend=chosen, mode=mode, n_rows=R, fragment_chars=F,
                    pattern_chars=P, n_patterns=Q, n_locs=L, wp=wp,
                    need_words=need, l_pad=l_pad, p_chars_pad=p_chars,
                    q_pad=q_pad, f_chars=f_chars, chunk_rows=chunk,
                    est_seconds=est, reason=reason, predicate=predicate,
                    cost_source=self.cost_source.tag,
                    est_base_seconds=est_base)
