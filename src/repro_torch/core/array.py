"""CRAM-PM array: state + row-parallel micro-instruction interpreter.

Port of ``repro.core.array``.  The array is a 2-D grid of cells (uint8
logic states).  Per the paper (Sec. 2.4) a single gate may be active per
row at a time, but every row executes that same gate on the same columns
simultaneously: each micro-instruction is a column-wise SIMD operation
across all rows.  ``OPCODES``, ``MicroOp`` and ``Program`` (with
``encode``) are the reference's.

``execute`` is functional, as in JAX: it returns a new ``(rows, cols)``
uint8 tensor.  The reference runs a program as a ``jax.lax.scan``; here
the card runs it as one launch of a hand-written kernel
(``kernels/cram_array.py``, ``csrc/cram_array.cu``) and the CPU as the
kernel's plain version, ``execute_plain``.  ``CRAMArray`` keeps its state
on the device and updates it in place (``run``), through the kernel's
in-place entry: a copy per program would move the whole state each time.
It keeps a ``binary`` flag, the kernel's rule for its bit-sliced form:
true at construction (zeros), cleared by a write of a value above 1 and
by a program that reads an out-of-range column (255).
Cost accounting is done on the program (host side), never in the
interpreter -- see ``costmodel.py``; ``mem_stats`` counts memory-
configuration operations exactly as the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import cram_array as _kernel
from repro_torch.kernels.cram_array import (MAX_ARITY, PackedProgram,
                                            execute_plain)

__all__ = ["OPCODES", "OPCODE_ID", "ARITY", "MAX_ARITY", "MicroOp",
           "Program", "execute", "execute_plain", "run_program",
           "CRAMArray"]

# Opcode table. PRESET0/PRESET1 write a constant into the output column;
# whether a preset is issued as a gang preset (one op, Sec. 3.4) or as
# row-sequential writes is a *scheduling* attribute (MicroOp.gang) consumed by
# the cost model -- the functional result is identical.
OPCODES: Tuple[str, ...] = (
    "PRESET0", "PRESET1", "NOR", "OR", "NAND", "AND", "INV", "COPY",
    "MAJ3", "MAJ5", "TH",
)
OPCODE_ID: Dict[str, int] = {name: i for i, name in enumerate(OPCODES)}
ARITY: Dict[str, int] = {
    "PRESET0": 0, "PRESET1": 0, "NOR": 2, "OR": 2, "NAND": 2, "AND": 2,
    "INV": 1, "COPY": 1, "MAJ3": 3, "MAJ5": 5, "TH": 4,
}


@dataclasses.dataclass(frozen=True)
class MicroOp:
    """One CRAM-PM micro-instruction (Sec. 3.3 code generation)."""

    op: str
    ins: Tuple[int, ...] = ()
    out: int = 0
    gang: bool = True  # presets only: gang preset vs row-sequential write

    def __post_init__(self):
        if self.op not in OPCODE_ID:
            raise ValueError(f"unknown opcode {self.op}")
        if len(self.ins) != ARITY[self.op]:
            raise ValueError(
                f"{self.op} expects {ARITY[self.op]} inputs, got {len(self.ins)}")


class Program:
    """A straight-line micro-program plus scheduling statistics."""

    def __init__(self, ops: Iterable[MicroOp] = ()):  # noqa: D401
        self.ops: List[MicroOp] = list(ops)

    def append(self, op: MicroOp) -> None:
        self.ops.append(op)

    def extend(self, ops: Iterable[MicroOp]) -> None:
        self.ops.extend(ops)

    def __len__(self) -> int:
        return len(self.ops)

    def __iter__(self):
        return iter(self.ops)

    def op_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for op in self.ops:
            key = op.op
            if key.startswith("PRESET"):
                key = "PRESET_GANG" if op.gang else "PRESET_ROW"
            counts[key] = counts.get(key, 0) + 1
        return counts

    def n_logic_ops(self) -> int:
        return sum(1 for op in self.ops if not op.op.startswith("PRESET"))

    def n_presets(self) -> Tuple[int, int]:
        """(gang, row-sequential) preset counts."""
        gang = sum(1 for o in self.ops if o.op.startswith("PRESET") and o.gang)
        row = sum(1 for o in self.ops if o.op.startswith("PRESET") and not o.gang)
        return gang, row

    # -- encoding for the interpreter -------------------------------------
    def encode(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        n = len(self.ops)
        opc = np.zeros((n,), np.int32)
        ins = np.zeros((n, MAX_ARITY), np.int32)
        out = np.zeros((n,), np.int32)
        for i, op in enumerate(self.ops):
            opc[i] = OPCODE_ID[op.op]
            for j, c in enumerate(op.ins):
                ins[i, j] = c
            out[i] = op.out
        return opc, ins, out


def execute(state: torch.Tensor, opc, ins, out) -> torch.Tensor:
    """Run an encoded micro-program on array ``state`` (rows, cols) uint8;
    returns a new state (the kernel on the card, the plain version on the
    CPU)."""
    return _kernel.cram_execute(state, opc, ins, out)


def run_program(state: torch.Tensor, program: Program) -> torch.Tensor:
    opc, ins, out = program.encode()
    if len(program) == 0:
        return state
    return execute(state, opc, ins, out)


class CRAMArray:
    """Stateful wrapper over a device-resident state.

    Memory-configuration operations (read/write, Sec. 2.1) are host-mediated
    and tracked in ``mem_stats`` for the cost model; logic-configuration
    operations come in as ``Program``s (or programs already packed for the
    kernel, ``run_packed``) and update the state in place.
    """

    def __init__(self, n_rows: int, n_cols: int, device: DeviceLike = None):
        self.n_rows = n_rows
        self.n_cols = n_cols
        self.device = resolve_device(device)
        self.state = torch.zeros((n_rows, n_cols), dtype=torch.uint8,
                                 device=self.device)
        # Every cell is 0 or 1: programs may take the bit-sliced kernel.
        # Writes through ``write_row`` / ``write_column_rows`` keep it
        # true; a caller that writes ``state`` itself sets it.
        self.binary = True
        self.mem_stats = {"row_writes": 0, "bits_written": 0,
                          "row_reads": 0, "bits_read": 0}

    # -- memory configuration ---------------------------------------------
    def _tensor(self, bits) -> torch.Tensor:
        if isinstance(bits, torch.Tensor):
            return bits.to(self.device, torch.uint8)
        return torch.from_numpy(np.ascontiguousarray(bits, np.uint8)).to(
            self.device)

    def _note(self, bits: torch.Tensor) -> None:
        if self.binary and bits.numel() and bool(bits.amax() > 1):
            self.binary = False

    def write_row(self, row: int, col0: int, bits: Sequence[int]) -> None:
        bits = np.asarray(bits, np.uint8)
        self._note(torch.from_numpy(bits))
        self.state[row, col0:col0 + len(bits)] = self._tensor(bits)
        self.mem_stats["row_writes"] += 1
        self.mem_stats["bits_written"] += int(len(bits))

    def write_column_rows(self, col0: int, bits2d) -> None:
        """Write the same column range of every row (counted as per-row writes,
        since at most one row can be written at a time, Sec. 3.3).  ``bits2d``
        is (n_rows, n) numpy or a tensor, or (1, n) written to every row."""
        bits2d = self._tensor(bits2d)
        if bits2d.shape[0] not in (1, self.n_rows):
            raise ValueError(f"{bits2d.shape[0]} rows of bits for an array "
                             f"of {self.n_rows}")
        n = int(bits2d.shape[1])
        self._note(bits2d)
        self.state[:, col0:col0 + n] = bits2d
        self.mem_stats["row_writes"] += self.n_rows
        self.mem_stats["bits_written"] += n * self.n_rows

    def read_row(self, row: int, col0: int, n: int) -> np.ndarray:
        self.mem_stats["row_reads"] += 1
        self.mem_stats["bits_read"] += n
        return np.array(self.state[row, col0:col0 + n].cpu())  # a copy

    def read_columns(self, col0: int, n: int) -> np.ndarray:
        """Read-out of the same columns in all rows (score buffer drain)."""
        return self.read_columns_device([col0 + i for i in range(n)],
                                        calls=1).cpu().numpy()

    def read_columns_device(self, cols: Sequence[int],
                            calls: int | None = None) -> torch.Tensor:
        """(n_rows, len(cols)) of the state, left on the device; counted as
        ``calls`` read-outs of all rows (one a column by default)."""
        calls = len(cols) if calls is None else calls
        self.mem_stats["row_reads"] += self.n_rows * calls
        self.mem_stats["bits_read"] += len(cols) * self.n_rows
        return self.state[:, list(cols)]

    # -- logic configuration ------------------------------------------------
    def run(self, program: Program) -> None:
        if len(program) == 0:
            return
        self.run_packed(_kernel.pack_program(*program.encode(), self.n_cols,
                                             self.device))

    def run_packed(self, packed: PackedProgram) -> None:
        """Run a program packed by ``kernels.cram_array.pack_program`` (and
        placed on this array's device) in place; a program that reads an
        out-of-range column (255) clears ``binary``."""
        _kernel.cram_execute_(self.state, packed, binary=self.binary)
        if packed.reads_fill:
            self.binary = False
