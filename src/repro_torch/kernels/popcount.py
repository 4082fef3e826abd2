"""Bulk per-row popcount: CUDA kernel + plain version.

Port of ``repro.kernels.popcount`` (the Pallas ``_popcount_kernel``, the
CRAM-PM adder-tree analogue).  ``(N, W)`` uint32 words carried in an
int32 tensor -> ``(N, 1)`` int32 per-row bit counts.

``popcount_rows`` takes any ``N >= 1`` and ``W >= 1`` (the kernel masks
its ragged last tile); ``popcount`` keeps the JAX contract, ``N %
N_TILE == 0``, and calls it.  Both want a contiguous, 16-byte aligned
operand (the kernel stages tiles with bulk copies).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
(``csrc/popcount.cu``) or raises.  ``popcount.n_launches`` counts kernel
launches only, from either entry.  ``launch_geometry`` is the launch's
shape arithmetic (tile rows, threads per row, shared memory, grid), kept
in Python so that the CPU tests reach it.  The per-word SWAR helper
``popcount_words`` lives in ``kernels.ref`` (the filter kernels' plain
versions share it).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from .ref import as_u32, popcount_words

N_TILE = 256
TILE_BYTES = 32 * 1024   # staged bytes a block: its tile, or a chunk of it
BLOCK_THREADS = 128
MAX_TILE_ROWS = 128
MAX_ROW_THREADS = 32


class Geometry(NamedTuple):
    rows_per_tile: int    # T, a multiple of 4: every tile starts on 16 bytes
    threads_per_row: int  # G, a power of two up to 32
    smem_bytes: int       # the tile, or a chunk of it when W > 2048
    grid: int             # ceil(N / T) blocks, one a tile


def launch_geometry(n_rows: int, n_words: int) -> Geometry:
    """The kernel's launch over ``(n_rows, n_words)`` words: the most rows
    a tile (up to 128) whose bytes fit ``TILE_BYTES``, at least 4, and
    ``BLOCK_THREADS`` threads a block (a thread a row up to W = 64)."""
    if n_rows < 1 or n_words < 1:
        raise ValueError(f"need at least one row and one word, got "
                         f"({n_rows}, {n_words})")
    t = MAX_TILE_ROWS
    while t > 4 and t * n_words * 4 > TILE_BYTES:
        t //= 2
    g = min(MAX_ROW_THREADS, BLOCK_THREADS // t)
    return Geometry(t, g, min(t * n_words * 4, TILE_BYTES), -(-n_rows // t))


def _check(words: torch.Tensor) -> None:
    if words.dtype != torch.int32 or words.ndim != 2:
        raise ValueError("words must be a 2-D int32 tensor carrying uint32 "
                         f"words, got {words.dtype} {tuple(words.shape)}")
    if not words.is_contiguous():
        raise ValueError("words must be contiguous")
    if words.shape[1] < 1:
        raise ValueError("words must have at least one word a row")
    if words.data_ptr() % 16:
        raise ValueError("words must be 16-byte aligned (the kernel stages "
                         "tiles with bulk copies)")


def popcount_rows(words: torch.Tensor) -> torch.Tensor:
    """(N, W) int32-carried uint32 -> (N, 1) int32, for any N and W >= 1."""
    _check(words)
    dev = words.device
    if dev.type == "cpu":
        return popcount_plain(words)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    N, W = words.shape
    out = torch.empty((N, 1), dtype=torch.int32, device=dev)
    if N == 0:
        return out
    geo = launch_geometry(N, W)
    lib = _build.load("popcount")
    fn = lib.popcount_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(words.data_ptr(), N, W, *geo, out.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "popcount", lib)
    popcount.n_launches += 1
    return out


def popcount(words: torch.Tensor) -> torch.Tensor:
    """(N, W) int32-carried uint32 -> (N, 1) int32; N % N_TILE == 0."""
    if words.ndim == 2 and words.shape[0] % N_TILE:
        raise ValueError(f"rows must be padded to a multiple of {N_TILE}")
    return popcount_rows(words)


popcount.n_launches = 0


def popcount_plain(words: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain torch ((N, 1) int32)."""
    return popcount_words(as_u32(words)).sum(-1, keepdim=True).to(
        torch.int32)
