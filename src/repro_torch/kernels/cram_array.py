"""CRAM-PM array interpreter: CUDA kernels (two forms) + plain version.

Counterpart of ``repro.core.array.execute`` (a ``jax.lax.scan`` under
``jax.jit``, not a Pallas kernel): one encoded micro-program -- ``opc``
(n,), ``ins`` (n, MAX_ARITY), ``out`` (n,) int columns, as
``Program.encode`` gives them -- run op by op on every row of a
``(rows, cols)`` uint8 state.  Each op gathers its input columns, applies
its gate in int32 and scatters its output column cast to uint8, so a
state that is not 0/1 behaves as in the reference (INV of 2 is 255).
Columns resolve as the reference's gather and scatter resolve them: a
column in ``[-cols, 0)`` wraps; a used input column outside
``[-cols, cols)`` reads 255, and an output column there is dropped.

``pack_program`` checks and encodes a program for the kernels once, on
the state's device, so a caller that runs one program many times
(``core.matcher.Matcher``) packs it once.  The touched columns are
remapped to local indices: the written ones first, then the read-only
ones, then a sink local for dropped outputs and a fill local (255) for
out-of-range inputs, each only where the program needs it; neither of
the last two is ever written back.

The card runs a packed program in one of two forms (``csrc/cram_array.cu``):

* ``cram_execute_bits``, bit-sliced: 32 rows a 32-bit word, every gate
  a word formula.  It holds where every staged cell is 0 or 1, which
  every gate preserves.  Each op is the threshold "at least 3 of 5
  inputs" (MAJ5) of its inputs padded with constant ZERO / ONES words,
  xor a negation mask (``bits_fields``, derived from ``GATE_FIELDS``).
* ``cram_execute_bytes``, a byte a cell: the reference's int32 semantics
  for any uint8 state, and for programs that read the fill local or
  whose touched columns do not fit the bit-sliced staging.

``cram_execute_`` runs a packed program in place, picking the form by a
stated rule on its input (``pick_form``): bit-sliced where ``binary``
(the caller's word that every touched cell is 0/1; ``None`` checks the
columns the kernel stages with one device reduction, ``touched_binary``),
the program reads no fill and its columns fit; else bytes.  Never by
trying one form and falling back.  ``cram_execute`` is the functional
form: it clones the state and runs the in-place entry on the clone.  The
bit-sliced kernel counts every staged byte above 1 into
``over_one(device)``; a run whose ``binary`` was true leaves it at 0.

A CPU tensor takes the plain version (``execute_plain``: a loop over
ops of column gathers, the gate, a column scatter); a CUDA tensor
launches a kernel or raises.  ``cram_execute_bits.n_launches`` and
``cram_execute_bytes.n_launches`` count each form's launches.
``launch_geometry`` (bytes) and ``bits_geometry`` are the launches'
shape arithmetic, kept in Python so that the CPU tests reach them.  A
program may touch at most 65,536 distinct columns (local indices are
16-bit).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from . import _build

MAX_ARITY = 5
N_OPCODES = 11
# Inputs each opcode reads, by opcode id (PRESET0, PRESET1, NOR, OR, NAND,
# AND, INV, COPY, MAJ3, MAJ5, TH), as ``core.array.ARITY``.
ARITY_BY_ID = np.array([0, 0, 2, 2, 2, 2, 1, 1, 3, 5, 4], np.int64)
# Each opcode as the byte kernel evaluates it, without a branch: (t, eq,
# neg, lin, c0, c1).  A threshold gate sums its ARITY inputs into s and
# gives (s == t if eq else s < t) != neg; a linear one (lin) gives c0 + c1
# * a0.  The reference's formulas: NOR s2 == 0, OR s2 > 0, NAND s2 < 2,
# AND s2 == 2, MAJ3 s3 >= 2, MAJ5 s5 >= 3, TH s4 <= 1, INV 1 - a0, COPY a0.
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
    """The first word of each byte-form op: opcode (bits 0-3), inputs k
    (4-6), t (7-8), eq (9), neg (10), lin (11), c0 (12), c1 as 0, 1 or 2
    for -1 (13-14), the output's local column (16-31)."""
    t, eq, neg, lin, c0, c1 = GATE_FIELDS[opc].T
    return (opc | ARITY_BY_ID[opc] << 4 | t << 7 | eq << 9 | neg << 10
            | lin << 11 | c0 << 12 | np.where(c1 < 0, 2, c1) << 13
            | out_local << 16)


def bits_fields() -> np.ndarray:
    """Each opcode as the bit-sliced kernel evaluates it: (ones, negate).

    On 0/1 inputs every gate of ``GATE_FIELDS`` is [s >= t*] of its k
    inputs, negated or not: ``s < t`` is not [s >= t]; ``s == 0`` is not
    [s >= 1]; ``s == k`` is [s >= k]; c0 + c1 * a0 is [0 >= 1] (0), [0 >=
    0] (1), [a0 >= 1] or its negation.  [s >= t*] over k inputs is MAJ5
    (at least 3 of 5) of the inputs, 3 - t* ONES and the rest ZERO."""
    rows = []
    for opc, (t, eq, neg, lin, c0, c1) in enumerate(GATE_FIELDS):
        k = int(ARITY_BY_ID[opc])
        if lin:
            t_star, flip = (1 - c0, False) if c1 == 0 else (1, c1 < 0)
        elif eq:
            if t not in (0, k):
                raise ValueError(f"opcode {opc}: s == {t} of {k} inputs is "
                                 "no single threshold")
            t_star, flip = (1, True) if t == 0 else (k, False)
        else:
            t_star, flip = t, True
        ones = 3 - t_star
        if not (0 <= ones and k + ones <= MAX_ARITY):
            raise ValueError(f"opcode {opc}: [s >= {t_star}] of {k} inputs "
                             "is no MAJ5 of padded inputs")
        rows.append((ones, int(flip != bool(neg))))
    return np.array(rows, np.int64)


BITS_FIELDS = bits_fields()
MAX_LOCAL = 1 << 16
SMEM_LIMIT = 232448          # dynamic shared memory a block may opt in to
SM_SMEM = 233472             # shared memory an SM holds (228 KB)
SMEM_RESERVED = 1024         # shared memory the runtime keeps a block
PROGRAM_BYTES = 256 * 16     # the staged chunk of the program: 256 ops
BLOCK_ROWS = (128, 64, 32)   # byte form: rows a block, largest first
UNSTAGED_ROWS = 128
BITS_WORDS = (64, 32, 16, 8)  # bit-sliced form: 32-row words a block
BITS_THREADS = 128
BITS_BLOCKS_SM = 8           # __launch_bounds__(128, 8): 64 registers
BITS_MAX_COLS = (2**31 - 1) >> 5  # 32 rows' offsets stay 32-bit


class Geometry(NamedTuple):
    block_rows: int    # B rows a block, one thread each
    pitch: int         # bytes between staged columns (B + 4: odd words)
    smem_bytes: int    # program chunk + T * pitch staged, the chunk alone
    staged: bool       # unstaged


def launch_geometry(n_touched: int) -> Geometry:
    """Byte form: the largest block (128, 64, 32 rows) whose
    ``n_touched`` staged columns fit ``SMEM_LIMIT`` beside the program
    chunk; else unstaged, 128 rows a block."""
    if not 1 <= n_touched <= MAX_LOCAL:
        raise ValueError(f"a program touches 1..{MAX_LOCAL} columns, got "
                         f"{n_touched}")
    for b in BLOCK_ROWS:
        smem = PROGRAM_BYTES + n_touched * (b + 4)
        if smem <= SMEM_LIMIT:
            return Geometry(b, b + 4, smem, True)
    return Geometry(UNSTAGED_ROWS, 0, PROGRAM_BYTES, False)


class BitsGeometry(NamedTuple):
    words: int         # W 32-row words a block, one computing thread each
    pitch: int         # words between staged columns (W + 1: odd)
    smem_bytes: int    # program chunk + (T + 2) * pitch words
    blocks: int        # grid: ceil(rows / 32 W)
    blocks_per_sm: int  # resident blocks an SM, by shared memory


def bits_smem(n_touched: int, words: int) -> int:
    """The T touched columns and the ZERO and ONES words, ``words + 1``
    words apart, beside the program chunk."""
    return PROGRAM_BYTES + (n_touched + 2) * (words + 1) * 4


def bits_geometry(n_touched: int, n_rows: int, n_sms: int,
                  words: Optional[int] = None) -> Optional[BitsGeometry]:
    """Bit-sliced form: of the block sizes in ``BITS_WORDS`` whose staging
    fits ``SMEM_LIMIT``, the one that runs ``n_rows`` in the fewest waves
    over ``n_sms`` SMs (resident blocks an SM by shared memory, at most
    ``BITS_BLOCKS_SM``), the smallest on a tie (less staging a block).
    ``words`` forces a block size.  None where no block size fits."""
    if not 1 <= n_touched <= MAX_LOCAL - 2 or n_rows < 1 or n_sms < 1:
        raise ValueError(f"bits_geometry({n_touched}, {n_rows}, {n_sms})")
    if words is not None and words not in BITS_WORDS:
        raise ValueError(f"words is one of {BITS_WORDS}, got {words}")
    n_words = -(-n_rows // 32)
    best = None
    for w in BITS_WORDS if words is None else (words,):
        smem = bits_smem(n_touched, w)
        if smem > SMEM_LIMIT:
            continue
        per_sm = min(SM_SMEM // (smem + SMEM_RESERVED), BITS_BLOCKS_SM)
        blocks = -(-n_words // w)
        geo = BitsGeometry(w, w + 1, smem, blocks, per_sm)
        key = (-(-blocks // (n_sms * per_sm)), w)
        if best is None or key < best[0]:
            best = (key, geo)
    return None if best is None else best[1]


def _resolve(c: np.ndarray, n_cols: int) -> np.ndarray:
    """Columns as the reference's gather and scatter resolve them: [-n, 0)
    wraps, anything else outside [0, n) becomes -1 (255 read, dropped)."""
    c = np.where((c < 0) & (c >= -n_cols), c + n_cols, c)
    return np.where((c < 0) | (c >= n_cols), -1, c)


@dataclasses.dataclass(frozen=True)
class PackedProgram:
    """A checked program, encoded for both kernel forms.

    ``opc``/``ins``/``out`` are the program with its columns resolved
    (int64 numpy; the plain version runs them): wrapped into ``[0,
    n_cols)``, or -1 for an input that reads 255 and an output that is
    dropped; inputs past an opcode's arity are 0.  ``cols`` (T,) int32
    maps local columns to state columns, the ``n_written`` written ones
    first, and of those the ``n_fresh`` written before any read (never
    staged); -1 marks the sink and fill locals.  ``ops`` is (n, 4) int32,
    one 16-byte word an op for the byte form: ``gate_word``, then inputs
    0-1, 2-3 and 4 as 16-bit locals.  ``ops_bits`` is the same for the
    bit-sliced form: inputs 0-1, 2-3, then input 4 and the output, then
    the negation mask; the five inputs are the gate's own, then ONES
    (local T + 1) and ZERO (local T) as ``BITS_FIELDS`` says.
    ``reads_fill``: an input reads 255.  The tensors live on
    ``ops.device``.
    """

    opc: np.ndarray
    ins: np.ndarray
    out: np.ndarray
    n_cols: int
    ops: torch.Tensor
    ops_bits: torch.Tensor
    cols: torch.Tensor
    n_written: int
    n_fresh: int
    reads_fill: bool

    def __len__(self) -> int:
        return len(self.opc)

    @property
    def n_touched(self) -> int:
        return int(self.cols.shape[0])


def bits_words(opc: np.ndarray, li: np.ndarray, lo: np.ndarray,
               n_touched: int) -> np.ndarray:
    """The bit-sliced form's (n, 4) uint32 op words from opcodes, local
    inputs (n, MAX_ARITY) and local outputs (n,): inputs 0-1, 2-3, then
    input 4 and the output, then the negation mask (0 or all ones)."""
    ones, neg = BITS_FIELDS[opc].T
    k = ARITY_BY_ID[opc]
    slot = np.arange(MAX_ARITY)[None, :]
    pad = np.where(slot < (k + ones)[:, None], n_touched + 1, n_touched)
    s = np.where(slot < k[:, None], li, pad)
    return np.stack([s[:, 0] | s[:, 1] << 16, s[:, 2] | s[:, 3] << 16,
                     s[:, 4] | lo << 16, neg * 0xFFFFFFFF],
                    -1).astype(np.uint32)


def pack_program(opc, ins, out, n_cols: int,
                 device: Optional[torch.device] = None) -> PackedProgram:
    """Check an encoded program against a state of ``n_cols`` columns and
    pack it for the kernels (on ``device``, the CPU if None)."""
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
    ins = np.where(used, _resolve(ins, n_cols), 0)
    out = _resolve(out, n_cols)
    read = ins[used]
    reads_fill = bool((read < 0).any())
    # Written columns whose first access is a write need no staging: the
    # n_fresh of them lead the locals.  An op gathers before it scatters,
    # so a column it reads and writes counts as read first.
    first_read = np.full(n_cols, n)
    np.minimum.at(first_read, read[read >= 0],
                  np.nonzero(used)[0][read >= 0])
    first_write = np.full(n_cols, n)
    np.minimum.at(first_write, out[out >= 0], np.nonzero(out >= 0)[0])
    written = np.unique(out[out >= 0])
    fresh = first_write[written] < first_read[written]
    read_only = np.setdiff1d(read[read >= 0], written)
    sink = len(written) + len(read_only)
    drops = bool((out < 0).any())
    fill = sink + drops
    cols = np.concatenate([written[fresh], written[~fresh], read_only,
                           np.full(drops + reads_fill, -1, np.int64)])
    if len(cols) > MAX_LOCAL:
        raise ValueError(f"the program touches {len(cols)} columns; the "
                         f"kernel takes at most {MAX_LOCAL}")
    local = np.zeros(n_cols, np.int64)
    local[cols[:sink]] = np.arange(sink)
    li = np.where(used, np.where(ins >= 0, local[np.maximum(ins, 0)], fill),
                  0)
    lo = np.where(out >= 0, local[np.maximum(out, 0)], sink)
    words = np.stack([gate_word(opc, lo), li[:, 0] | li[:, 1] << 16,
                      li[:, 2] | li[:, 3] << 16, li[:, 4]], -1)
    # Locals T and T + 1 (ZERO, ONES) must be 16-bit too.
    bits = (bits_words(opc, li, lo, len(cols))
            if len(cols) + 2 <= MAX_LOCAL else np.zeros((n, 4), np.uint32))
    dev = torch.device("cpu") if device is None else device

    def put(a):
        return torch.from_numpy(
            np.ascontiguousarray(a.astype(np.uint32).view(np.int32))).to(dev)

    return PackedProgram(opc, ins, out, int(n_cols), put(words), put(bits),
                         put(cols), len(written), int(fresh.sum()),
                         reads_fill)


def _check_state(state: torch.Tensor) -> None:
    if state.dtype != torch.uint8 or state.ndim != 2:
        raise ValueError("the state must be a 2-D uint8 tensor, got "
                         f"{state.dtype} {tuple(state.shape)}")
    if not state.is_contiguous():
        raise ValueError("the state must be contiguous")


def _check_packed(state: torch.Tensor, prog: PackedProgram) -> None:
    _check_state(state)
    if prog.n_cols != state.shape[1]:
        raise ValueError(f"the program was packed for {prog.n_cols} columns, "
                         f"the state has {state.shape[1]}")


def touched_binary(state: torch.Tensor, prog: PackedProgram) -> bool:
    """Whether every cell of the state columns ``prog`` stages (it touches,
    less those written before any read) is 0 or 1 (one reduction on the
    state's device)."""
    cols = prog.cols[prog.n_fresh:].to(state.device).long()
    cols = cols[cols >= 0]
    if cols.numel() == 0 or state.shape[0] == 0:
        return True
    return bool(state.index_select(1, cols).amax() <= 1)


def pick_form(prog: PackedProgram, binary: bool, n_rows: int,
              n_sms: int) -> str:
    """The rule: "bits" where every touched cell is 0/1 (``binary``), no
    input reads the fill (255), the touched columns fit the bit-sliced
    staging and a row is at most ``BITS_MAX_COLS``; else "bytes"."""
    if (binary and not prog.reads_fill and prog.n_touched + 2 <= MAX_LOCAL
            and prog.n_cols <= BITS_MAX_COLS
            and bits_geometry(prog.n_touched, max(n_rows, 1), n_sms)
            is not None):
        return "bits"
    return "bytes"


_OVER_ONE: Dict[torch.device, torch.Tensor] = {}


def over_one(device) -> torch.Tensor:
    """The device counter of staged bytes above 1 that the bit-sliced
    kernel saw (int32 (1,)); ``.zero_()`` resets it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in _OVER_ONE:
        _OVER_ONE[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    return _OVER_ONE[dev]


def _has_work(state: torch.Tensor, prog: PackedProgram) -> bool:
    """Whether a program has ops and rows to run on the state's CUDA
    device; raises on another device or a program packed elsewhere."""
    dev = state.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if prog.ops.device != dev or prog.cols.device != dev:
        raise ValueError(f"the program lives on {prog.ops.device}, the "
                         f"state on {dev}: pack it for the state's device")
    return len(prog) > 0 and state.shape[0] > 0


def cram_execute_bytes(state: torch.Tensor,
                       prog: PackedProgram) -> torch.Tensor:
    """Run ``prog`` on ``state`` in place with the byte kernel (any uint8
    state); returns ``state``."""
    _check_packed(state, prog)
    if state.device.type == "cpu":
        return _run_plain(state, prog)
    if not _has_work(state, prog):
        return state
    R, C = state.shape
    dev = state.device
    geo = launch_geometry(prog.n_touched)
    lib = _build.load("cram_array")
    fn = lib.cram_execute_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(state.data_ptr(), R, C, prog.ops.data_ptr(), len(prog),
                 prog.cols.data_ptr(), prog.n_touched, prog.n_written,
                 prog.n_fresh, geo.block_rows, geo.pitch, geo.smem_bytes,
                 int(geo.staged), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "cram_execute_bytes", lib)
    cram_execute_bytes.n_launches += 1
    return state


def _n_sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def cram_execute_bits(state: torch.Tensor, prog: PackedProgram,
                      words: Optional[int] = None) -> torch.Tensor:
    """Run ``prog`` on ``state`` in place with the bit-sliced kernel;
    returns ``state``.  The caller vouches that every touched cell is 0
    or 1 (staged bytes above 1 are counted into ``over_one``); raises
    where the program reads the fill or its columns do not fit.
    ``words`` forces the block size (``bits_geometry``)."""
    _check_packed(state, prog)
    if state.device.type == "cpu":
        return _run_plain(state, prog)
    if not _has_work(state, prog):
        return state
    if prog.reads_fill:
        raise ValueError("the program reads an out-of-range column (255): "
                         "the bit-sliced form takes 0/1 cells only")
    if prog.n_cols > BITS_MAX_COLS:
        raise ValueError(f"rows of {prog.n_cols} columns: the bit-sliced "
                         f"form takes at most {BITS_MAX_COLS}")
    R, C = state.shape
    dev = state.device
    geo = (bits_geometry(prog.n_touched, R, _n_sms(dev), words)
           if prog.n_touched + 2 <= MAX_LOCAL else None)
    if geo is None:
        raise ValueError(f"{prog.n_touched} touched columns do not fit the "
                         "bit-sliced staging"
                         + (f" at {words} words a block" if words else ""))
    counter = over_one(dev)
    lib = _build.load("cram_array")
    fn = lib.cram_bits_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(state.data_ptr(), R, C, prog.ops_bits.data_ptr(), len(prog),
                 prog.cols.data_ptr(), prog.n_touched, prog.n_written,
                 prog.n_fresh, geo.words, geo.smem_bytes, counter.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "cram_execute_bits", lib)
    cram_execute_bits.n_launches += 1
    return state


cram_execute_bits.n_launches = 0
cram_execute_bytes.n_launches = 0


def cram_execute_(state: torch.Tensor, prog: PackedProgram,
                  binary: Optional[bool] = None) -> torch.Tensor:
    """Run ``prog`` on ``state`` in place, in the form ``pick_form``
    gives; ``binary`` None asks ``touched_binary`` on the device.
    Returns ``state``."""
    _check_packed(state, prog)
    if state.device.type == "cpu":
        return _run_plain(state, prog)
    if not _has_work(state, prog):
        return state
    if binary is None:
        binary = touched_binary(state, prog)
    if pick_form(prog, binary, state.shape[0],
                 _n_sms(state.device)) == "bits":
        return cram_execute_bits(state, prog)
    return cram_execute_bytes(state, prog)


def cram_execute(state: torch.Tensor, opc, ins, out) -> torch.Tensor:
    """Functional form: a new state, ``state`` untouched."""
    _check_state(state)
    prog = pack_program(opc, ins, out, state.shape[1], state.device)
    return cram_execute_(state.clone(), prog)


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
    fill = torch.full((state.shape[0],), 255, dtype=torch.int32,
                      device=state.device)
    for o, i, c in zip(prog.opc.tolist(), prog.ins.tolist(),
                       prog.out.tolist()):
        if o <= 1:
            res = o
        else:
            vals = [state[:, k].to(torch.int32) if k >= 0 else fill
                    for k in i[:int(ARITY_BY_ID[o])]]
            res = _GATES[o](vals).to(torch.uint8)
        if c >= 0:
            state[:, c] = res
    return state


def execute_plain(state: torch.Tensor, opc, ins, out) -> torch.Tensor:
    """The kernels' arithmetic in plain torch, on a new state: per op,
    gather the opcode's input columns (padded inputs are never read; out
    of range reads 255), apply its gate in int32, scatter the output
    column cast to uint8 (out of range: dropped)."""
    _check_state(state)
    return _run_plain(state.clone(),
                      pack_program(opc, ins, out, state.shape[1]))
