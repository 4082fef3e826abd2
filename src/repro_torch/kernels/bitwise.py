"""Bulk bitwise ops: CUDA kernel + plain version.

Port of ``repro.kernels.bitwise`` (the Pallas ``_bitwise_kernel``, the
CRAM-PM Fig. 11 gate analogue): NOT, OR, AND, NAND, NOR or XOR over
``(N, W)`` uint32 words carried in int32 tensors, ``N % N_TILE == 0``
(``kernels.ops.bitwise`` pads and slices back).  Two's-complement int32
bit operations are the uint32 ones, so no widening is needed.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
(``csrc/bitwise.cu``, the op a template parameter) or raises.
``bitwise.n_launches`` counts kernel launches only.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

N_TILE = 256
OPS = ("NOT", "OR", "NAND", "XOR", "AND", "NOR")
# Op codes of ``bitwise_launch`` in csrc/bitwise.cu.
OP_CODES = {"NOT": 0, "OR": 1, "AND": 2, "NAND": 3, "NOR": 4, "XOR": 5}


def bitwise(op: str, a: torch.Tensor,
            b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, W) elementwise bulk op; N % N_TILE == 0; NOT ignores ``b``."""
    if op not in OPS:
        raise ValueError(op)
    if b is None:
        b = a
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.int32 or t.ndim != 2:
            raise ValueError(f"{name} must be a 2-D int32 tensor carrying "
                             f"uint32 words, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if b.shape != a.shape or b.device != a.device:
        raise ValueError(f"operands differ: {tuple(a.shape)} on {a.device}, "
                         f"{tuple(b.shape)} on {b.device}")
    N, W = a.shape
    if N % N_TILE or W < 1:
        raise ValueError(f"rows must be padded to a multiple of {N_TILE}")
    dev = a.device
    if dev.type == "cpu":
        return bitwise_plain(op, a, b)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty_like(a)
    lib = _build.load("bitwise")
    fn = lib.bitwise_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(OP_CODES[op], a.data_ptr(), b.data_ptr(), out.data_ptr(),
                 a.numel(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "bitwise", lib)
    bitwise.n_launches += 1
    return out


bitwise.n_launches = 0


def bitwise_plain(op: str, a: torch.Tensor,
                  b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's arithmetic in plain torch ((N, W) int32)."""
    b = a if b is None else b
    if op == "NOT":
        return ~a
    if op == "OR":
        return a | b
    if op == "AND":
        return a & b
    if op == "NAND":
        return ~(a & b)
    if op == "NOR":
        return ~(a | b)
    if op == "XOR":
        return a ^ b
    raise ValueError(op)
