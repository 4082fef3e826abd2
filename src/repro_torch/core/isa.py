"""Macro -> micro instruction code generation (paper Sec. 3.3).

Port of ``repro.core.isa`` (NumPy and Python, copied); it emits the
port's ``MicroOp``s, which ``array`` runs on the card.

Macro-instructions operate on multi-bit column operands, all rows at once;
code generation lowers them into straight-line ``MicroOp`` sequences with
explicit output presets.  The spatio-temporal scheduling choices of the paper
are reproduced:

* **Interleaved presets** (Naive/Oracular): every gate's output column is
  preset immediately before the gate fires, via *row-sequential* standard
  writes (the expensive path that dominates latency, Fig. 6).
* **Coalesced gang presets** (NaiveOpt/OracularOpt): consecutive computation
  steps are laid out on disjoint scratch columns so all presets of a phase are
  hoisted to the start and issued as gang presets (Sec. 3.4 "gang preset"),
  which the cost model prices as a single parallel COPY-class operation.

The number of presets is identical in both schedules (the paper: "energy
consumption of the optimized case is unchanged"); only their scheduling and
hence latency differs.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from .array import MicroOp, Program

PRESET_FOR = {  # required output preset per gate type (Sec. 2.2)
    "NOR": 0, "OR": 1, "NAND": 0, "AND": 1, "INV": 0, "COPY": 1,
    "MAJ3": 1, "MAJ5": 1, "TH": 0,
}


class ColumnAllocator:
    """Scratch column allocator for one row-compartment (Fig. 3 layout).

    Fresh columns come from [lo, hi); dead columns at or above ``reuse_lo``
    may be recycled (every gate presets its output before writing, so reuse
    is always safe once all readers have executed -- programs are straight
    line).  Setting ``reuse_lo`` below ``lo`` lets e.g. consumed match-string
    compartment columns be recycled by the reduction tree, which is how the
    paper fits Phase 2 into the ~2K-cell row.
    """

    def __init__(self, lo: int, hi: int, reuse_lo: int | None = None):
        self.lo, self.hi = lo, hi
        self.reuse_lo = lo if reuse_lo is None else reuse_lo
        self.next = lo
        self.free: List[int] = []

    def alloc(self, n: int = 1) -> List[int]:
        cols = []
        while n > 0 and self.free:
            cols.append(self.free.pop())
            n -= 1
        if n > 0:
            if self.next + n > self.hi:
                raise RuntimeError(
                    f"scratch overflow: need {n} cols beyond {self.next}/{self.hi}")
            cols.extend(range(self.next, self.next + n))
            self.next += n
        return cols

    def release(self, cols: Sequence[int]) -> None:
        self.free.extend(c for c in cols if c >= self.reuse_lo)

    @property
    def high_water(self) -> int:
        return self.next


@dataclasses.dataclass
class CodeGen:
    """Emits micro-ops; `opt=True` coalesces presets into gang presets."""

    scratch: ColumnAllocator
    opt: bool = False

    def __post_init__(self):
        self.prog = Program()
        self._pending_presets: List[MicroOp] = []

    # -- primitive emission -------------------------------------------------
    def _preset(self, col: int, val: int) -> None:
        op = MicroOp(f"PRESET{val}", (), col, gang=self.opt)
        if self.opt:
            # Hoist: gang presets are batched ahead of the computation they
            # feed; functionally we can emit in place (columns are disjoint
            # by construction under opt), the *cost model* prices them as
            # hoisted gangs.
            self.prog.append(op)
        else:
            self.prog.append(op)

    def gate(self, kind: str, ins: Tuple[int, ...], out: int) -> int:
        self._preset(out, PRESET_FOR[kind])
        self.prog.append(MicroOp(kind, ins, out))
        return out

    # -- derived operations (Sec. 2.2) --------------------------------------
    def xor(self, a: int, b: int) -> int:
        """2-input XOR: S1 = NOR(a,b); S2 = COPY(S1); out = TH(a,b,S1,S2)."""
        s1, s2, out = self.scratch.alloc(3)
        self.gate("NOR", (a, b), s1)
        self.gate("COPY", (s1,), s2)
        self.gate("TH", (a, b, s1, s2), out)
        self.scratch.release([s1, s2])
        return out

    def xnor(self, a: int, b: int) -> int:
        x = self.xor(a, b)
        out = self.scratch.alloc(1)[0]
        self.gate("INV", (x,), out)
        self.scratch.release([x])
        return out

    def char_match(self, a0: int, a1: int, b0: int, b1: int) -> int:
        """2-bit character compare (Fig. 4a): NOR of the two bit-XORs.

        Yields 1 iff both bit pairs are equal (character match)."""
        x0 = self.xor(a0, b0)
        x1 = self.xor(a1, b1)
        out = self.scratch.alloc(1)[0]
        self.gate("NOR", (x0, x1), out)
        self.scratch.release([x0, x1])
        return out

    def full_adder(self, a: int, b: int, cin: int) -> Tuple[int, int]:
        """MAJ-gate full adder (Fig. 2): returns (sum, carry_out).

        Steps: Cout = MAJ3(a,b,cin); S1 = INV(Cout); S2 = COPY(S1);
               Sum  = MAJ5(a,b,cin,S1,S2).
        """
        cout, s1, s2, s = self.scratch.alloc(4)
        self.gate("MAJ3", (a, b, cin), cout)
        self.gate("INV", (cout,), s1)
        self.gate("COPY", (s1,), s2)
        self.gate("MAJ5", (a, b, cin, s1, s2), s)
        self.scratch.release([s1, s2])
        return s, cout

    def half_adder(self, a: int, b: int) -> Tuple[int, int]:
        """Half adder still costs one 1-bit FA pass in the paper's accounting;
        we implement it as a full adder with a preset-0 carry-in."""
        zero = self.scratch.alloc(1)[0]
        self._preset(zero, 0)
        s, cout = self.full_adder(a, b, zero)
        self.scratch.release([zero])
        return s, cout

    def ripple_add(self, a_cols: Sequence[int], b_cols: Sequence[int]) -> List[int]:
        """Add two little-endian multi-bit operands; returns sum columns
        (len = max+1).  Costs max(len) 1-bit FAs, as the paper counts.
        Consumed operand and dead carry columns are recycled."""
        n = max(len(a_cols), len(b_cols))
        zero = None
        carry = None
        out: List[int] = []
        for i in range(n):
            if i < len(a_cols) and i < len(b_cols):
                a, b = a_cols[i], b_cols[i]
            else:
                if zero is None:
                    zero = self.scratch.alloc(1)[0]
                    self._preset(zero, 0)
                a = a_cols[i] if i < len(a_cols) else zero
                b = b_cols[i] if i < len(b_cols) else zero
            if carry is None:
                s, new_carry = self.half_adder(a, b)
            else:
                s, new_carry = self.full_adder(a, b, carry)
                self.scratch.release([carry])
            carry = new_carry
            # Operand bits are dead after this FA.
            dead = [c for c in (a, b) if c != zero]
            self.scratch.release(dead)
            out.append(s)
        if zero is not None:
            self.scratch.release([zero])
        out.append(carry)
        return out

    def popcount_tree(self, bit_cols: Sequence[int]) -> List[int]:
        """Reduction tree of 1-bit adders (Fig. 4b): popcount of the match
        string.  Pairs equal-width operands level by level; the total 1-bit-FA
        count for 100 inputs is ~188, matching the paper's Sec. 3.2 estimate.
        Returns little-endian score columns (N = floor(log2 n) + 1 bits).
        """
        operands: List[List[int]] = [[c] for c in bit_cols]
        while len(operands) > 1:
            operands.sort(key=len)
            nxt: List[List[int]] = []
            i = 0
            while i + 1 < len(operands):
                nxt.append(self.ripple_add(operands[i], operands[i + 1]))
                i += 2
            if i < len(operands):
                nxt.append(operands[i])
            operands = nxt
        # The result can never exceed n = len(bit_cols); top columns beyond
        # N = floor(log2 n) + 1 bits are provably zero -- drop them (paper:
        # N = 7 for a 100-char pattern).
        n_bits = int(np.floor(np.log2(len(bit_cols)))) + 1 if bit_cols else 1
        result = operands[0]
        self.scratch.release(result[n_bits:])
        return result[:n_bits]

    def fa_count(self) -> int:
        """Number of 1-bit full-adder invocations emitted (MAJ3 count)."""
        return self.prog.op_counts().get("MAJ3", 0)
