"""Bulk per-row popcount: CUDA kernel + plain version.

Port of ``repro.kernels.popcount`` (the Pallas ``_popcount_kernel``, the
CRAM-PM adder-tree analogue).  ``(N, W)`` uint32 words carried in an
int32 tensor -> ``(N, 1)`` int32 per-row bit counts, ``N % N_TILE == 0``
(``kernels.ops.popcount`` pads and slices back).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
(``csrc/popcount.cu``) or raises.  ``popcount.n_launches`` counts kernel
launches only.  The per-word SWAR helper ``popcount_words`` lives in
``kernels.ref`` (the filter kernels' plain versions share it).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import as_u32, popcount_words

N_TILE = 256


def popcount(words: torch.Tensor) -> torch.Tensor:
    """(N, W) int32-carried uint32 -> (N, 1) int32; N % N_TILE == 0."""
    if words.dtype != torch.int32 or words.ndim != 2:
        raise ValueError("words must be a 2-D int32 tensor carrying uint32 "
                         f"words, got {words.dtype} {tuple(words.shape)}")
    if not words.is_contiguous():
        raise ValueError("words must be contiguous")
    N, W = words.shape
    if N % N_TILE or W < 1:
        raise ValueError(f"rows must be padded to a multiple of {N_TILE}")
    dev = words.device
    if dev.type == "cpu":
        return popcount_plain(words)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty((N, 1), dtype=torch.int32, device=dev)
    lib = _build.load("popcount")
    fn = lib.popcount_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(words.data_ptr(), N, W, out.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "popcount", lib)
    popcount.n_launches += 1
    return out


popcount.n_launches = 0


def popcount_plain(words: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain torch ((N, 1) int32)."""
    return popcount_words(as_u32(words)).sum(-1, keepdim=True).to(
        torch.int32)
