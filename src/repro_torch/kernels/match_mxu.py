"""One-hot correlation string match on the tensor cores: kernel + plain version.

Port of ``repro.kernels.match_mxu`` (the Pallas ``_mxu_kernel``).
score(r, o, q) = sum_i sum_c ref1h[r, o+i, c] * pat1h[q, i, c] is a
sliding contraction; in char-major one-hot layout the im2col window
matrix is a *stride-4 view* of the flat reference row,

    A[l, k] = flat[(o0 + l) * 4 + k],

so each alignment tile is a plain matrix product against the pattern
matrix.  Same contract as the JAX kernel:

  ref_flat (R, F4)       bf16 -- one-hot rows, char-major (F4 = 4 * chars),
                                 zero padded; F4 >= 4 * l_pad + P4.
  pat_mat  (P4, Q)       bf16 -- multi-hot patterns (i*4+c, q); P4 % 128 == 0,
                                 Q % 128 == 0 (zero columns pad Q).
  out      (R, l_pad, Q) f32  -- scores; the caller trims to L and rounds.

``match_mxu_best`` is the same contraction with the ``best`` reduction in
the kernel's epilogue: per (row, pattern) the best rounded score over the
first ``n_locs`` alignments and the first alignment attaining it, as
``round`` + slice + ``argmax``/``amax`` over the full block give them, so
the (R, l_pad, Q) block never leaves the chip.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
(``csrc/match_mxu.cu``, one mainloop with a store and a best epilogue)
or raises.  ``match_mxu.n_launches`` and ``match_mxu_best.n_launches``
count kernel launches only.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

L_TILE = 256
K_CHUNK = 128            # = 32 characters * 4 channels
CHARS_PER_CHUNK = K_CHUNK // 4
# Rows per step of the plain version (its im2col copy is rows*l_pad*P4 f32).
PLAIN_ROW_BLOCK = 256

_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p]
_BEST_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                  ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_void_p]


def _check(ref_flat: torch.Tensor, pat_mat: torch.Tensor, l_pad: int) -> None:
    for name, t in (("ref_flat", ref_flat), ("pat_mat", pat_mat)):
        if t.dtype != torch.bfloat16 or t.ndim != 2:
            raise ValueError(f"{name} must be a 2-D bf16 tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if pat_mat.device != ref_flat.device:
        raise ValueError(f"pat_mat is on {pat_mat.device}, ref_flat on "
                         f"{ref_flat.device}")
    F4 = ref_flat.shape[1]
    P4, Q = pat_mat.shape
    if P4 % K_CHUNK or Q % 128:
        raise ValueError("pattern rows must be padded to 128, Q to 128")
    if l_pad % L_TILE or l_pad < L_TILE:
        raise ValueError("l_pad must be a multiple of L_TILE")
    if F4 % 4:
        raise ValueError("ref_flat rows must hold 4 channels per char")
    deepest = 4 * l_pad + P4
    if deepest > F4:
        raise ValueError(f"ref_flat too short: need {deepest}, have {F4}")


def match_mxu(ref_flat: torch.Tensor, pat_mat: torch.Tensor, *,
              l_pad: int) -> torch.Tensor:
    """ref_flat (R, F4) bf16, pat_mat (P4, Q) bf16 -> (R, l_pad, Q) f32."""
    _check(ref_flat, pat_mat, l_pad)
    dev = ref_flat.device
    if dev.type == "cpu":
        return match_mxu_plain(ref_flat, pat_mat, l_pad=l_pad)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_aligned(ref_flat, pat_mat)
    R, F4 = ref_flat.shape
    P4, Q = pat_mat.shape
    out = torch.empty((R, l_pad, Q), dtype=torch.float32, device=dev)
    lib = _build.load("match_mxu")
    fn = lib.match_mxu_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(ref_flat.data_ptr(), R, F4, pat_mat.data_ptr(), P4, Q,
                 l_pad, out.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "match_mxu_launch", lib)
    match_mxu.n_launches += 1
    return out


match_mxu.n_launches = 0


def _check_aligned(ref_flat: torch.Tensor, pat_mat: torch.Tensor) -> None:
    # The kernel's bulk copies read 16-byte aligned spans (a row that
    # starts only 8 bytes aligned is copied from 8 bytes earlier, which
    # stays inside the tensor when its first row is 16-byte aligned).
    if ref_flat.data_ptr() % 16 or pat_mat.data_ptr() % 16:
        raise ValueError("match_mxu operands must be 16-byte aligned")


def best_l_pad(n_locs: int) -> int:
    """The ``l_pad`` (multiple of L_TILE) that covers ``n_locs``."""
    return max(-(-n_locs // L_TILE) * L_TILE, L_TILE)


def _check_best(ref_flat: torch.Tensor, pat_mat: torch.Tensor, n_locs: int,
                n_k: int) -> None:
    if n_locs < 1:
        raise ValueError(f"n_locs must be >= 1, got {n_locs}")
    _check(ref_flat, pat_mat, best_l_pad(n_locs))
    if not 1 <= n_k <= pat_mat.shape[0]:
        raise ValueError(f"n_k must be in [1, {pat_mat.shape[0]}], got {n_k}")


def match_mxu_best(ref_flat: torch.Tensor, pat_mat: torch.Tensor, *,
                   n_locs: int, n_k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ref_flat (R, F4) bf16, pat_mat (P4, Q) bf16 -> (best_loc, best_score),
    each (R, Q) int32, over alignments l < n_locs.

    Pattern rows at and past ``n_k`` (= 4P) must be zero: the kernel does
    not read them.
    """
    _check_best(ref_flat, pat_mat, n_locs, n_k)
    dev = ref_flat.device
    if dev.type == "cpu":
        return match_mxu_best_plain(ref_flat, pat_mat, n_locs=n_locs, n_k=n_k)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_aligned(ref_flat, pat_mat)
    R, F4 = ref_flat.shape
    P4, Q = pat_mat.shape
    best_loc = torch.empty((R, Q), dtype=torch.int32, device=dev)
    best_score = torch.empty((R, Q), dtype=torch.int32, device=dev)
    lib = _build.load("match_mxu")
    fn = lib.match_mxu_best_launch
    fn.argtypes, fn.restype = _BEST_ARGTYPES, ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(ref_flat.data_ptr(), R, F4, pat_mat.data_ptr(), P4, Q, n_k,
                 n_locs, best_l_pad(n_locs), best_loc.data_ptr(),
                 best_score.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "match_mxu_best_launch", lib)
    match_mxu_best.n_launches += 1
    return best_loc, best_score


match_mxu_best.n_launches = 0


def match_mxu_plain(ref_flat: torch.Tensor, pat_mat: torch.Tensor, *,
                    l_pad: int) -> torch.Tensor:
    """Stride-4 im2col view times the pattern matrix, in float32.

    Products and sums of 0/1 values are exact in float32 (and in TF32,
    whose inputs round nothing here), so the result is bit-identical to
    the tensor-core kernel's.
    """
    R, F4 = ref_flat.shape
    P4, Q = pat_mat.shape
    pat = pat_mat.float()
    out = torch.empty((R, l_pad, Q), dtype=torch.float32,
                      device=ref_flat.device)
    for r0 in range(0, R, PLAIN_ROW_BLOCK):
        r1 = min(r0 + PLAIN_ROW_BLOCK, R)
        flat = ref_flat[r0:r1].float()
        win = flat.as_strided((r1 - r0, l_pad, P4), (F4, 4, 1))
        out[r0:r1] = torch.matmul(win, pat)
    return out


def match_mxu_best_plain(ref_flat: torch.Tensor, pat_mat: torch.Tensor, *,
                         n_locs: int, n_k: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``match_mxu_plain``, rounded, sliced to ``n_locs``, then the first
    argmax and the max over alignments, in int32.  Reads all P4 pattern
    rows (``n_k`` only bounds what the kernel reads)."""
    del n_k
    out = match_mxu_plain(ref_flat, pat_mat, l_pad=best_l_pad(n_locs))
    scores = torch.round(out[:, :n_locs, :]).to(torch.int32)
    return scores.argmax(dim=1).to(torch.int32), scores.amax(dim=1)
