"""CRAM-PM array interpreter: CUDA kernel + plain version.

Counterpart of ``repro.core.array.execute`` (a ``jax.lax.scan`` under
``jax.jit``, not a Pallas kernel): one encoded micro-program -- ``opc``
(n,), ``ins`` (n, MAX_ARITY), ``out`` (n,) int columns, as
``Program.encode`` gives them -- run op by op on every row of a
``(rows, cols)`` uint8 state.  Each op gathers its input columns, applies
its gate in int32 and scatters its output column cast to uint8, so a
state that is not 0/1 behaves as in the reference (INV of 2 is 255).

``pack_program`` checks and encodes a program for the kernel once, on
the state's device (the touched columns remapped to local indices,
written ones first; each op one 16-byte word), so a caller that runs one
program many times (``core.matcher.Matcher``) packs it once.  ``cram_execute_`` runs a packed program in place (what
``CRAMArray.run`` calls); ``cram_execute`` is the functional form: it
clones the state and runs the in-place entry on the clone.

A CPU tensor takes the plain version (``execute_plain``: a loop over
ops of column gathers, the gate, a column scatter); a CUDA tensor
launches the kernel (``csrc/cram_array.cu``) or raises.
``cram_execute.n_launches`` counts kernel launches, from either entry.
``launch_geometry`` is the launch's shape arithmetic, kept in Python so
that the CPU tests reach it.

Deliberate divergence from the reference: a used input or an output
column outside ``[0, cols)`` raises ``ValueError`` here, where JAX reads
255 for such an input and drops such an output.  A program may touch at
most 65,536 distinct columns (the kernel's local indices are 16-bit).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _build

MAX_ARITY = 5
N_OPCODES = 11
# Inputs each opcode reads, by opcode id (PRESET0, PRESET1, NOR, OR, NAND,
# AND, INV, COPY, MAJ3, MAJ5, TH), as ``core.array.ARITY``.
ARITY_BY_ID = np.array([0, 0, 2, 2, 2, 2, 1, 1, 3, 5, 4], np.int64)
# Each opcode as the kernel evaluates it, without a branch: (t, eq, neg,
# lin, c0, c1).  A threshold gate sums its ARITY inputs into s and gives
# (s == t if eq else s < t) != neg; a linear one (lin) gives c0 + c1 * a0.
# The reference's formulas: NOR s2 == 0, OR s2 > 0, NAND s2 < 2, AND s2 ==
# 2, MAJ3 s3 >= 2, MAJ5 s5 >= 3, TH s4 <= 1, INV 1 - a0, COPY a0.
GATE_FIELDS = np.array([
    (0, 0, 0, 1, 0, 0),      # PRESET0
    (0, 0, 0, 1, 1, 0),      # PRESET1
    (0, 1, 0, 0, 0, 0),      # NOR: s2 == 0
    (0, 1, 1, 0, 0, 0),      # OR: not s2 == 0
    (2, 0, 0, 0, 0, 0),      # NAND: s2 < 2
    (2, 1, 0, 0, 0, 0),      # AND: s2 == 2
    (0, 0, 0, 1, 1, -1),     # INV: 1 - a0
    (0, 0, 0, 1, 0, 1),      # COPY: a0
    (2, 0, 1, 0, 0, 0),      # MAJ3: not s3 < 2
    (3, 0, 1, 0, 0, 0),      # MAJ5: not s5 < 3
    (2, 0, 0, 0, 0, 0),      # TH: s4 < 2
], np.int64)


def gate_word(opc: np.ndarray, out_local: np.ndarray) -> np.ndarray:
    """The first word of each packed op: opcode (bits 0-3), inputs k
    (4-6), t (7-8), eq (9), neg (10), lin (11), c0 (12), c1 as 0, 1 or 2
    for -1 (13-14), the output's local column (16-31)."""
    t, eq, neg, lin, c0, c1 = GATE_FIELDS[opc].T
    return (opc | ARITY_BY_ID[opc] << 4 | t << 7 | eq << 9 | neg << 10
            | lin << 11 | c0 << 12 | np.where(c1 < 0, 2, c1) << 13
            | out_local << 16)
MAX_LOCAL = 1 << 16
SMEM_LIMIT = 232448          # dynamic shared memory a block may opt in to
PROGRAM_BYTES = 256 * 16     # the staged chunk of the program: 256 ops
BLOCK_ROWS = (128, 64, 32)   # rows a block, the largest that fits first
UNSTAGED_ROWS = 128


class Geometry(NamedTuple):
    block_rows: int    # B rows a block, one thread each
    pitch: int         # bytes between staged columns (B + 4: odd words)
    smem_bytes: int    # program chunk + T * pitch staged, the chunk alone
    staged: bool       # unstaged


def launch_geometry(n_touched: int) -> Geometry:
    """The largest block (128, 64, 32 rows) whose ``n_touched`` staged
    columns fit ``SMEM_LIMIT`` beside the program chunk; else unstaged,
    128 rows a block."""
    if not 1 <= n_touched <= MAX_LOCAL:
        raise ValueError(f"a program touches 1..{MAX_LOCAL} columns, got "
                         f"{n_touched}")
    for b in BLOCK_ROWS:
        smem = PROGRAM_BYTES + n_touched * (b + 4)
        if smem <= SMEM_LIMIT:
            return Geometry(b, b + 4, smem, True)
    return Geometry(UNSTAGED_ROWS, 0, PROGRAM_BYTES, False)


@dataclasses.dataclass(frozen=True)
class PackedProgram:
    """A checked program, encoded for the kernel.

    ``opc``/``ins``/``out`` are the program as given (int64 numpy; the
    plain version runs them).  ``ops`` is (n, 4) int32 carrying one
    16-byte word an op: ``gate_word`` (the gate's fields and the output),
    then inputs 0-1, 2-3 and 4 as 16-bit local columns.  ``cols`` (T,)
    int32 maps local columns to state columns, the ``n_written`` written
    ones first.  ``ops`` and ``cols`` live on ``ops.device``.
    """

    opc: np.ndarray
    ins: np.ndarray
    out: np.ndarray
    n_cols: int
    ops: torch.Tensor
    cols: torch.Tensor
    n_written: int

    def __len__(self) -> int:
        return len(self.opc)

    @property
    def n_touched(self) -> int:
        return int(self.cols.shape[0])


def pack_program(opc, ins, out, n_cols: int,
                 device: Optional[torch.device] = None) -> PackedProgram:
    """Check an encoded program against a state of ``n_cols`` columns and
    pack it for the kernel (on ``device``, the CPU if None)."""
    opc = np.asarray(opc, np.int64).reshape(-1)
    n = len(opc)
    ins = np.asarray(ins, np.int64)
    out = np.asarray(out, np.int64).reshape(-1)
    if ins.shape != (n, MAX_ARITY) or out.shape != (n,):
        raise ValueError(f"a program is opc (n,), ins (n, {MAX_ARITY}), out "
                         f"(n,); got {opc.shape}, {ins.shape}, {out.shape}")
    if n and (opc.min() < 0 or opc.max() >= N_OPCODES):
        raise ValueError(f"opcodes lie in [0, {N_OPCODES})")
    used = np.arange(MAX_ARITY)[None, :] < ARITY_BY_ID[opc][:, None]
    read = ins[used]
    for what, c in (("input", read), ("output", out)):
        bad = (c < 0) | (c >= n_cols)
        if bad.any():
            raise ValueError(
                f"{what} column {int(c[bad][0])} outside the state's "
                f"{n_cols} columns (the reference reads 255 for an input "
                "and drops an output out of range; the port refuses both)")
    written = np.unique(out)
    cols = np.concatenate([written, np.setdiff1d(read, written)])
    if len(cols) > MAX_LOCAL:
        raise ValueError(f"the program touches {len(cols)} columns; the "
                         f"kernel takes at most {MAX_LOCAL}")
    local = np.zeros(n_cols, np.int64)
    local[cols] = np.arange(len(cols))
    li = np.where(used, local[np.where(used, ins, 0)], 0)
    words = np.stack([gate_word(opc, local[out]), li[:, 0] | li[:, 1] << 16,
                      li[:, 2] | li[:, 3] << 16, li[:, 4]], -1)
    ops = torch.from_numpy(words.astype(np.uint32).view(np.int32))
    dev = torch.device("cpu") if device is None else device
    return PackedProgram(opc, ins, out, int(n_cols), ops.to(dev),
                         torch.from_numpy(cols.astype(np.int32)).to(dev),
                         len(written))


def _check_state(state: torch.Tensor) -> None:
    if state.dtype != torch.uint8 or state.ndim != 2:
        raise ValueError("the state must be a 2-D uint8 tensor, got "
                         f"{state.dtype} {tuple(state.shape)}")
    if not state.is_contiguous():
        raise ValueError("the state must be contiguous")


def cram_execute_(state: torch.Tensor, prog: PackedProgram) -> torch.Tensor:
    """Run ``prog`` on ``state`` in place; returns ``state``."""
    _check_state(state)
    if prog.n_cols != state.shape[1]:
        raise ValueError(f"the program was packed for {prog.n_cols} columns, "
                         f"the state has {state.shape[1]}")
    dev = state.device
    if dev.type == "cpu":
        return _run_plain(state, prog)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    R, C = state.shape
    if len(prog) == 0 or R == 0:
        return state
    if prog.ops.device != dev or prog.cols.device != dev:
        raise ValueError(f"the program lives on {prog.ops.device}, the "
                         f"state on {dev}: pack it for the state's device")
    geo = launch_geometry(prog.n_touched)
    lib = _build.load("cram_array")
    fn = lib.cram_execute_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(state.data_ptr(), R, C, prog.ops.data_ptr(), len(prog),
                 prog.cols.data_ptr(), prog.n_touched, prog.n_written,
                 geo.block_rows, geo.pitch, geo.smem_bytes, int(geo.staged),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "cram_execute", lib)
    cram_execute.n_launches += 1
    return state


def cram_execute(state: torch.Tensor, opc, ins, out) -> torch.Tensor:
    """Functional form: a new state, ``state`` untouched."""
    _check_state(state)
    prog = pack_program(opc, ins, out, state.shape[1], state.device)
    return cram_execute_(state.clone(), prog)


cram_execute.n_launches = 0


def _s(vals, k):
    s = vals[0]
    for v in vals[1:k]:
        s = s + v
    return s


# The gate table, by opcode id: int32 input columns -> int32 result,
# the formulas of the reference's ``_apply_gate``.
_GATES = (
    None,                                  # PRESET0
    None,                                  # PRESET1
    lambda v: (_s(v, 2) == 0).int(),       # NOR
    lambda v: (_s(v, 2) > 0).int(),        # OR
    lambda v: (_s(v, 2) < 2).int(),        # NAND
    lambda v: (_s(v, 2) == 2).int(),       # AND
    lambda v: 1 - v[0],                    # INV
    lambda v: v[0],                        # COPY
    lambda v: (_s(v, 3) >= 2).int(),       # MAJ3
    lambda v: (_s(v, 5) >= 3).int(),       # MAJ5
    lambda v: (_s(v, 4) <= 1).int(),       # TH
)


def _run_plain(state: torch.Tensor, prog: PackedProgram) -> torch.Tensor:
    for o, i, c in zip(prog.opc.tolist(), prog.ins.tolist(),
                       prog.out.tolist()):
        if o <= 1:
            state[:, c] = o
            continue
        vals = [state[:, k].to(torch.int32)
                for k in i[:int(ARITY_BY_ID[o])]]
        state[:, c] = _GATES[o](vals).to(torch.uint8)
    return state


def execute_plain(state: torch.Tensor, opc, ins, out) -> torch.Tensor:
    """The kernel's arithmetic in plain torch, on a new state: per op,
    gather the opcode's input columns (padded inputs are never read),
    apply its gate in int32, scatter the output column cast to uint8."""
    _check_state(state)
    return _run_plain(state.clone(),
                      pack_program(opc, ins, out, state.shape[1]))
