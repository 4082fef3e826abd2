"""Q-gram signature filters: CUDA kernels + plain versions.

Port of ``repro.kernels.filter_qgram`` (the Pallas ``_filter_kernel``
and ``_bank_kernel``).  Stage one of filter-then-verify: a row whose
absent required-bit count ``popcount(qsig & ~row_sig)`` exceeds the
query's slack (the q-gram lemma's ``e * q``) cannot hold a qualifying
alignment.  ``bank_prefilter`` reads the lemma with rows and queries
exchanged: a standing pattern survives a document batch iff some doc's
occurrence signature admits it.

Data layout (uint32 bits carried in int32 tensors, as in ``match_swar``):
  filter_qgram    row_sigs (R, Wb), qsig (1, Wb), int slack
                  -> (R, 1) int32, 1 iff the row is a candidate;
                  R % FILTER_ROW_TILE == 0; a negative slack marks no row.
  bank_prefilter  pat_sigs (Q, Wb), doc_sigs (D, Wb), slacks (Q, 1) int32
                  -> (Q, 1) int32, 1 iff some doc admits the pattern;
                  Q % FILTER_ROW_TILE == 0; pad rows carry slack -1.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
(``csrc/filter_qgram.cu``) or raises.  ``filter_qgram.n_launches`` /
``bank_prefilter.n_launches`` count kernel launches only.  The slack is
a runtime argument of the CUDA kernel (the JAX kernel compiles one
program per static slack); it is clamped to the int32 range, which
leaves every comparison with a count in [0, 32 * Wb] unchanged.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import as_u32, popcount_words

FILTER_ROW_TILE = 128
# Patterns per step of the bank's plain version (bounds its (b, D, Wb)
# int64 temporary).
PLAIN_PATTERN_BLOCK = 1024
_I32_MAX = 2 ** 31 - 1


def _clamp_slack(slack: int) -> int:
    return max(-1, min(int(slack), _I32_MAX))


def _check_words(**tensors: torch.Tensor) -> torch.device:
    dev = None
    for name, t in tensors.items():
        if t.dtype != torch.int32 or t.ndim != 2:
            raise ValueError(f"{name} must be a 2-D int32 tensor carrying "
                             f"uint32 words, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, not {dev}")
        dev = t.device
    return dev


def filter_qgram(row_sigs: torch.Tensor, qsig: torch.Tensor, *,
                 slack: int) -> torch.Tensor:
    """Candidate-row bitmap: see module docstring for layouts."""
    dev = _check_words(row_sigs=row_sigs, qsig=qsig)
    R, Wb = row_sigs.shape
    if R % FILTER_ROW_TILE:
        raise ValueError(
            f"rows must be padded to a multiple of {FILTER_ROW_TILE}")
    if tuple(qsig.shape) != (1, Wb):
        raise ValueError(f"qsig must be (1, {Wb}); got {tuple(qsig.shape)}")
    slack = _clamp_slack(slack)
    if dev.type == "cpu":
        return filter_qgram_plain(row_sigs, qsig, slack=slack)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty((R, 1), dtype=torch.int32, device=dev)
    lib = _build.load("filter_qgram")
    fn = lib.filter_qgram_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(row_sigs.data_ptr(), R, Wb, qsig.data_ptr(), slack,
                 out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "filter_qgram", lib)
    filter_qgram.n_launches += 1
    return out


def bank_prefilter(pat_sigs: torch.Tensor, doc_sigs: torch.Tensor,
                   slacks: torch.Tensor) -> torch.Tensor:
    """Surviving-pattern bitmap for one document batch (module docstring)."""
    dev = _check_words(pat_sigs=pat_sigs, doc_sigs=doc_sigs, slacks=slacks)
    Q, Wb = pat_sigs.shape
    D = doc_sigs.shape[0]
    if Q % FILTER_ROW_TILE:
        raise ValueError(
            f"patterns must be padded to a multiple of {FILTER_ROW_TILE}")
    if doc_sigs.shape[1] != Wb or D < 1:
        raise ValueError(f"doc_sigs must be (D >= 1, {Wb}); got "
                         f"{tuple(doc_sigs.shape)}")
    if tuple(slacks.shape) != (Q, 1):
        raise ValueError(f"slacks must be ({Q}, 1); got "
                         f"{tuple(slacks.shape)}")
    if dev.type == "cpu":
        return bank_prefilter_plain(pat_sigs, doc_sigs, slacks)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty((Q, 1), dtype=torch.int32, device=dev)
    lib = _build.load("filter_qgram")
    fn = lib.bank_prefilter_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(pat_sigs.data_ptr(), Q, Wb, doc_sigs.data_ptr(), D,
                 slacks.data_ptr(), out.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "bank_prefilter", lib)
    bank_prefilter.n_launches += 1
    return out


filter_qgram.n_launches = 0
bank_prefilter.n_launches = 0


# -- plain versions -----------------------------------------------------------

def filter_qgram_plain(row_sigs: torch.Tensor, qsig: torch.Tensor, *,
                       slack: int) -> torch.Tensor:
    """The filter kernel's arithmetic in plain torch ((R, 1) int32)."""
    absent = as_u32(qsig) & ~as_u32(row_sigs)
    counts = popcount_words(absent).sum(-1, keepdim=True)
    return (counts <= int(slack)).to(torch.int32)


def bank_prefilter_plain(pat_sigs: torch.Tensor, doc_sigs: torch.Tensor,
                         slacks: torch.Tensor) -> torch.Tensor:
    """The bank kernel's arithmetic in plain torch ((Q, 1) int32)."""
    ds = ~as_u32(doc_sigs)[None, :, :]
    Q = pat_sigs.shape[0]
    out = torch.empty((Q, 1), dtype=torch.int32, device=pat_sigs.device)
    for p0 in range(0, Q, PLAIN_PATTERN_BLOCK):
        p1 = min(p0 + PLAIN_PATTERN_BLOCK, Q)
        absent = popcount_words(as_u32(pat_sigs[p0:p1])[:, None, :] & ds)
        fits = absent.sum(-1) <= slacks[p0:p1].to(torch.int64)   # (b, D)
        out[p0:p1] = fits.any(dim=1, keepdim=True).to(torch.int32)
    return out
