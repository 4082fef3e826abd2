"""CRAM-PM pattern matching: Fig. 3 data layout + Algorithm 1.

Port of ``repro.core.matcher``.  Each array row holds ``| fragment |
pattern | match-string | score/scratch |`` (2 bits per character).  For
every alignment location ``loc``:

* **Phase 1 (match)** -- per character: two bit-level XORs (each the 3-step
  NOR/COPY/TH sequence) + one NOR produce one match bit (Fig. 4a).
* **Phase 2 (score)** -- a reduction tree of MAJ-gate full adders pops the
  match string into an N-bit similarity score (Fig. 4b).

One gate executes per row at a time; all rows run in lock step (Sec. 2.4) --
which is what the array interpreter in ``array.py`` implements, one kernel
launch a program on the card.

``Matcher`` keeps its array on the device, caches each location's program
packed for the kernel there, and leaves each alignment's scores on the
device until the run ends; ``mem_stats`` counts as the reference does.
``sliding_scores`` is the NumPy oracle used by tests; the fast path lives
in ``repro_torch.kernels`` (same semantics, packed SWAR / tensor-core
one-hot).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike
from repro_torch.kernels.cram_array import PackedProgram, pack_program

from .array import CRAMArray, Program
from .isa import CodeGen, ColumnAllocator


@dataclasses.dataclass(frozen=True)
class RowLayout:
    """Column map of one CRAM-PM row (Fig. 3)."""

    fragment_chars: int
    pattern_chars: int
    n_cols: int

    @property
    def frag_lo(self) -> int:
        return 0

    @property
    def pat_lo(self) -> int:
        return 2 * self.fragment_chars

    @property
    def match_lo(self) -> int:
        return self.pat_lo + 2 * self.pattern_chars

    @property
    def scratch_lo(self) -> int:
        return self.match_lo + self.pattern_chars

    @property
    def score_bits(self) -> int:
        return int(np.floor(np.log2(self.pattern_chars))) + 1

    @property
    def n_alignments(self) -> int:
        return self.fragment_chars - self.pattern_chars + 1

    def frag_bit_cols(self, char_idx: int) -> Tuple[int, int]:
        return (2 * char_idx, 2 * char_idx + 1)

    def pat_bit_cols(self, char_idx: int) -> Tuple[int, int]:
        return (self.pat_lo + 2 * char_idx, self.pat_lo + 2 * char_idx + 1)


def plan_layout(n_cols: int, pattern_chars: int,
                scratch_budget: int = 48) -> RowLayout:
    """Maximal fragment length for a given row width (Sec. 3.1: fragment
    length is the design parameter bounded by the ~2K-cell row limit)."""
    score = int(np.floor(np.log2(pattern_chars))) + 1
    avail = n_cols - 2 * pattern_chars - pattern_chars - score - scratch_budget
    frag = avail // 2
    if frag < pattern_chars:
        raise ValueError("row too narrow for this pattern length")
    return RowLayout(frag, pattern_chars, n_cols)


def compile_alignment(layout: RowLayout, loc: int, opt: bool = False
                      ) -> Tuple[Program, List[int]]:
    """Micro-program for one iteration of Algorithm 1 at location ``loc``.

    Returns (program, score_columns little-endian).  ``opt`` selects the
    gang-preset schedule (NaiveOpt/OracularOpt) -- functionally identical,
    priced differently by the cost model.
    """
    if not 0 <= loc < layout.n_alignments:
        raise ValueError("loc out of range")
    # Consumed match-string columns may be recycled by the reduction tree
    # (reuse_lo = match_lo): that is how Phase 2 fits in the ~2K-cell row.
    scratch = ColumnAllocator(layout.scratch_lo, layout.n_cols,
                              reuse_lo=layout.match_lo)
    cg = CodeGen(scratch, opt=opt)
    # Phase 1: aligned comparison -> match string.
    for i in range(layout.pattern_chars):
        f0, f1 = layout.frag_bit_cols(loc + i)
        p0, p1 = layout.pat_bit_cols(i)
        m = cg.char_match(f0, f1, p0, p1)
        # Move the match bit to its dedicated compartment column.
        cg.gate("COPY", (m,), layout.match_lo + i)
        cg.scratch.release([m])
    # Phase 2: similarity score = popcount of the match string.
    match_cols = [layout.match_lo + i for i in range(layout.pattern_chars)]
    score_cols = cg.popcount_tree(match_cols)
    return cg.prog, score_cols


def count_alignment_ops(pattern_chars: int, n_cols: int = 2048,
                        opt: bool = False) -> dict:
    """Static op-count census of one alignment (drives the cost model)."""
    layout = plan_layout(n_cols, pattern_chars)
    prog, score_cols = compile_alignment(layout, 0, opt=opt)
    counts = prog.op_counts()
    counts["TOTAL_LOGIC"] = prog.n_logic_ops()
    gang, row = prog.n_presets()
    counts["PRESETS"] = gang + row
    counts["SCORE_BITS"] = len(score_cols)
    counts["FA_COUNT"] = counts.get("MAJ3", 0)
    return counts


class Matcher:
    """Run Algorithm 1 on a functional CRAM-PM array (on ``device``; None
    means the card)."""

    def __init__(self, fragments: np.ndarray, pattern_chars: int,
                 n_cols: int | None = None, opt: bool = True,
                 device: DeviceLike = None):
        fragments = np.asarray(fragments, np.uint8)
        n_rows, frag_chars = fragments.shape
        if n_cols is None:
            # Tight layout: just enough room for this fragment length.
            score = int(np.floor(np.log2(pattern_chars))) + 1
            n_cols = 2 * frag_chars + 3 * pattern_chars + score + 48
        self.layout = RowLayout(frag_chars, pattern_chars, n_cols)
        self.opt = opt
        self.array = CRAMArray(n_rows, n_cols, device=device)
        self.array.write_column_rows(0, _bit_planes(fragments,
                                                    self.array.device))
        self._programs: Dict[int, Tuple[PackedProgram, List[int]]] = {}

    def load_pattern(self, pattern: np.ndarray) -> None:
        """Same pattern distributed across all rows (paper's default)."""
        self.array.write_column_rows(
            self.layout.pat_lo,
            _bit_planes(np.asarray(pattern, np.uint8)[None, :],
                        self.array.device))

    def load_patterns_per_row(self, patterns: np.ndarray) -> None:
        """Oracular-style: a (possibly) different pattern per row."""
        if patterns.shape[0] != self.array.n_rows:
            raise ValueError(f"{patterns.shape[0]} patterns for "
                             f"{self.array.n_rows} rows")
        self.array.write_column_rows(
            self.layout.pat_lo,
            _bit_planes(np.asarray(patterns, np.uint8), self.array.device))

    def _program_for(self, loc: int) -> Tuple[PackedProgram, List[int]]:
        """Location ``loc``'s program, packed on the array's device once."""
        if loc not in self._programs:
            prog, score_cols = compile_alignment(self.layout, loc, self.opt)
            self._programs[loc] = (
                pack_program(*prog.encode(), self.layout.n_cols,
                             self.array.device), score_cols)
        return self._programs[loc]

    def run(self, locs: range | None = None) -> np.ndarray:
        """Execute Algorithm 1; returns scores (n_rows, n_locs) uint16."""
        locs = locs if locs is not None else range(self.layout.n_alignments)
        dev = self.array.device
        # int16 on the device, read back as uint16: the same bits as the
        # reference's uint16 sum, half the bytes of int32 to pull.
        scores = torch.zeros((self.array.n_rows, len(locs)),
                             dtype=torch.int16, device=dev)
        weights = torch.tensor([1 << i for i in range(self.layout.score_bits)],
                               dtype=torch.int32, device=dev)
        for j, loc in enumerate(locs):
            packed, score_cols = self._program_for(loc)
            self.array.run_packed(packed)
            bits = self.array.read_columns_device(score_cols)
            scores[:, j] = (bits.to(torch.int32)
                            * weights[:len(score_cols)]).sum(-1)
        return scores.cpu().numpy().view(np.uint16)


def _bit_planes(codes: np.ndarray, device: torch.device) -> torch.Tensor:
    """``encoding.codes_to_bits`` on the device: (R, n) codes -> (R, 2n)
    uint8 bit planes, LSB first per character."""
    c = torch.from_numpy(np.ascontiguousarray(codes)).to(device)
    return torch.stack([c & 1, (c >> 1) & 1], -1).reshape(c.shape[0], -1)


def sliding_scores(fragments: np.ndarray, patterns: np.ndarray) -> np.ndarray:
    """NumPy oracle: per-row, per-alignment character-match counts.

    fragments: (R, F) uint8 codes; patterns: (P,) shared or (R, P) per-row.
    Returns (R, F-P+1) int32.
    """
    fragments = np.asarray(fragments)
    patterns = np.asarray(patterns)
    if patterns.ndim == 1:
        patterns = np.broadcast_to(patterns, (fragments.shape[0],) + patterns.shape)
    R, F = fragments.shape
    P = patterns.shape[1]
    n_locs = F - P + 1
    windows = np.lib.stride_tricks.sliding_window_view(fragments, P, axis=1)
    # windows: (R, n_locs, P)
    return (windows == patterns[:, None, :]).sum(-1).astype(np.int32)[:, :n_locs]


def sliding_scores_masks(fragments: np.ndarray,
                         masks: np.ndarray) -> np.ndarray:
    """NumPy oracle for accept-set predicates (wildcards / IUPAC).

    fragments: (R, F) uint8 codes; masks: (P,) shared or (R, P) per-row
    uint8 accept masks (bit c set iff code c accepted).  Returns
    (R, F-P+1) int32 counts of accepted positions.  One-hot masks reduce
    this to ``sliding_scores`` exactly.
    """
    fragments = np.asarray(fragments)
    masks = np.asarray(masks, np.uint8)
    if masks.ndim == 1:
        masks = np.broadcast_to(masks, (fragments.shape[0],) + masks.shape)
    R, F = fragments.shape
    P = masks.shape[1]
    n_locs = F - P + 1
    windows = np.lib.stride_tricks.sliding_window_view(fragments, P, axis=1)
    hits = (masks[:, None, :] >> windows) & 1
    return hits.sum(-1).astype(np.int32)[:, :n_locs]


def best_alignment(scores: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row (best_loc, best_score) -- what the host extracts (Sec. 3.2)."""
    locs = scores.argmax(axis=1)
    return locs, scores[np.arange(scores.shape[0]), locs]
