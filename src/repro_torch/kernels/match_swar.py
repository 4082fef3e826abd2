"""SWAR bit-parallel sliding string match: CUDA kernel + plain version.

Port of ``repro.kernels.match_swar`` (the Pallas ``_swar_kernel`` and
``_swar_masks_kernel``).  16 two-bit characters per uint32 word; per
alignment a window word is funnel-shifted out of ``Wp + 1`` reference
words, compared lane-wise with the pattern, and the mismatching lanes
counted.  ``match_swar_masks`` is the accept-set variant: the pattern is
four bit-planes (plane c has the low bit of lane i set iff code c is
accepted at pattern position i), which IUPAC codes, N wildcards and
character classes all lower to.  ``match_swar_best`` is ``match_swar``
with the ``best`` reduction in the kernel's epilogue: per row the best
score over the ``n_locs`` alignments and the first alignment attaining
it, as ``argmax``/``amax`` over ``match_swar``'s block give them, so the
(R, L) block never leaves the chip.

Data layout (the JAX package's contract; uint32 bits carried in int32
tensors, ``torch.from_numpy(a.view(np.int32))``):
  ref_words  (R, W)    int32 -- folded fragments, 16 chars/word, padded
                                with >= 1 zero word; R % ROW_TILE == 0.
  pat_words  (R, Wp)   int32 -- per-row pattern words; a broadcast view
                                (row stride 0) of one pattern is accepted.
  pat_planes (R, 4*Wp) int32 -- plane c in columns [c*Wp, (c+1)*Wp).
  valid_mask (1, Wp)   int32 -- low-bit-of-lane mask of valid pattern chars.
  out        (R, L)    int32 -- P - mismatches per alignment.
  best_loc, best_score (R,) int32 -- ``match_swar_best``'s pair.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
(``csrc/match_swar.cu``: one exact mainloop with a store and a best
epilogue, and the accept-set loop) or raises.  ``match_swar.n_launches``,
``match_swar_best.n_launches`` and ``match_swar_masks.n_launches`` count
kernel launches only.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from .ref import M1, M2, M4, MUL, U32, as_u32

ROW_TILE = 8  # callers pad rows to a multiple of it (the Pallas row tile)
# Rows per step of the plain versions (bounds their int64 temporaries).
PLAIN_ROW_BLOCK = 4096
# Code c replicated into every 2-bit lane (lane equality test operand).
CODE_LANES = tuple(c * 0x55555555 for c in range(4))

_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p]
_BEST_ARGTYPES = _ARGTYPES[:-1] + [ctypes.c_void_p, ctypes.c_void_p]


def _check(ref_words: torch.Tensor, pat_words: torch.Tensor,
           valid_mask: torch.Tensor, n_locs: int, pattern_chars: int,
           planes: int) -> int:
    """Validate the contract; returns Wp."""
    for name, t in (("ref_words", ref_words), ("pat_words", pat_words),
                    ("valid_mask", valid_mask)):
        if t.dtype != torch.int32 or t.ndim != 2:
            raise ValueError(f"{name} must be a 2-D int32 tensor carrying "
                             f"uint32 words, got {t.dtype} {tuple(t.shape)}")
        if t.device != ref_words.device:
            raise ValueError(f"{name} is on {t.device}, ref_words on "
                             f"{ref_words.device}")
    R, W = ref_words.shape
    if R % ROW_TILE:
        raise ValueError(f"rows must be padded to a multiple of {ROW_TILE}")
    if pat_words.shape[1] % planes:
        raise ValueError(f"pat_planes must hold {planes} concatenated plane "
                         "blocks")
    wp = pat_words.shape[1] // planes
    if pat_words.shape[0] != R or wp < 1:
        raise ValueError(f"pattern words must be (R={R}, {planes}*Wp), got "
                         f"{tuple(pat_words.shape)}")
    if tuple(valid_mask.shape) != (1, wp):
        raise ValueError(f"valid_mask must be (1, {wp}), got "
                         f"{tuple(valid_mask.shape)}")
    if not (ref_words.is_contiguous() and valid_mask.is_contiguous()):
        raise ValueError("ref_words and valid_mask must be contiguous")
    if pat_words.stride(1) != 1 or pat_words.stride(0) not in (
            0, pat_words.shape[1]):
        raise ValueError("pattern words must be contiguous or a row-"
                         "broadcast view (row stride 0)")
    if n_locs < 1 or not 1 <= pattern_chars <= 16 * wp:
        raise ValueError(f"bad geometry: n_locs={n_locs}, "
                         f"pattern_chars={pattern_chars}, Wp={wp}")
    need = (n_locs - 1) // 16 + wp + 1
    if W < need:
        raise ValueError(f"ref_words too narrow: need {need} words, have {W}")
    return wp


def _launch(symbol: str, ref_words: torch.Tensor, pat_words: torch.Tensor,
            valid_mask: torch.Tensor, wp: int, n_locs: int,
            pattern_chars: int, outs: Tuple[torch.Size, ...]
            ) -> Tuple[torch.Tensor, ...]:
    """Launch ``symbol`` into fresh int32 outputs of the given shapes."""
    dev = ref_words.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    R, W = ref_words.shape
    res = tuple(torch.empty(shape, dtype=torch.int32, device=dev)
                for shape in outs)
    lib = _build.load("match_swar")
    fn = getattr(lib, symbol)
    fn.argtypes = _ARGTYPES if len(outs) == 1 else _BEST_ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(ref_words.data_ptr(), R, W, pat_words.data_ptr(),
                 pat_words.stride(0), valid_mask.data_ptr(), wp, n_locs,
                 pattern_chars, *(t.data_ptr() for t in res),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, symbol, lib)
    return res


def match_swar(ref_words: torch.Tensor, pat_words: torch.Tensor,
               valid_mask: torch.Tensor, *, n_locs: int,
               pattern_chars: int) -> torch.Tensor:
    """Packed sliding match: see module docstring for layouts."""
    wp = _check(ref_words, pat_words, valid_mask, n_locs, pattern_chars, 1)
    if ref_words.device.type == "cpu":
        return match_swar_plain(ref_words, pat_words, valid_mask,
                                n_locs=n_locs, pattern_chars=pattern_chars)
    out, = _launch("match_swar_launch", ref_words, pat_words, valid_mask, wp,
                   n_locs, pattern_chars, ((ref_words.shape[0], n_locs),))
    match_swar.n_launches += 1
    return out


def match_swar_best(ref_words: torch.Tensor, pat_words: torch.Tensor,
                    valid_mask: torch.Tensor, *, n_locs: int,
                    pattern_chars: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best_loc, best_score), each (R,) int32: ``match_swar``'s best
    alignment per row (first on ties), reduced in the kernel."""
    wp = _check(ref_words, pat_words, valid_mask, n_locs, pattern_chars, 1)
    if ref_words.device.type == "cpu":
        return match_swar_best_plain(ref_words, pat_words, valid_mask,
                                     n_locs=n_locs,
                                     pattern_chars=pattern_chars)
    R = ref_words.shape[0]
    best = _launch("match_swar_best_launch", ref_words, pat_words,
                   valid_mask, wp, n_locs, pattern_chars, ((R,), (R,)))
    match_swar_best.n_launches += 1
    return best


def match_swar_masks(ref_words: torch.Tensor, pat_planes: torch.Tensor,
                     valid_mask: torch.Tensor, *, n_locs: int,
                     pattern_chars: int) -> torch.Tensor:
    """Accept-set sliding match: see module docstring for layouts."""
    wp = _check(ref_words, pat_planes, valid_mask, n_locs, pattern_chars, 4)
    if ref_words.device.type == "cpu":
        return match_swar_masks_plain(ref_words, pat_planes, valid_mask,
                                      n_locs=n_locs,
                                      pattern_chars=pattern_chars)
    out, = _launch("match_swar_masks_launch", ref_words, pat_planes,
                   valid_mask, wp, n_locs, pattern_chars,
                   ((ref_words.shape[0], n_locs),))
    match_swar_masks.n_launches += 1
    return out


match_swar.n_launches = 0
match_swar_best.n_launches = 0
match_swar_masks.n_launches = 0


# -- plain versions -----------------------------------------------------------

def _windows(ref64: torch.Tensor, n_locs: int, wp: int) -> torch.Tensor:
    """(r, W) unsigned words -> (r, L, Wp) window words, all alignments."""
    dev = ref64.device
    locs = torch.arange(n_locs, device=dev)
    sh = ((locs % 16) * 2)[None, :, None]
    idx = (locs // 16)[:, None] + torch.arange(wp + 1, device=dev)[None, :]
    seg = ref64[:, idx]                                   # (r, L, Wp + 1)
    lo = seg[..., :wp] >> sh
    # Shift 0 takes no high part (the C++ ``x << 32`` is undefined).
    hi = (seg[..., 1:] << ((32 - sh) % 32)) & U32
    return lo | torch.where(sh == 0, 0, hi)


def _mismatch_count(mism: torch.Tensor) -> torch.Tensor:
    """Per-alignment count of a (r, L, Wp) word stack, <= 1 bit per lane."""
    v = (mism & M2) + ((mism >> 2) & M2)
    v = (v + (v >> 4)) & M4
    return (((v * MUL) & U32) >> 24).sum(-1)


def match_swar_plain(ref_words: torch.Tensor, pat_words: torch.Tensor,
                     valid_mask: torch.Tensor, *, n_locs: int,
                     pattern_chars: int) -> torch.Tensor:
    """The kernel's arithmetic in plain torch (mirrors
    ``ref.match_scores_swar_ref``, vectorized over alignments)."""
    wp = pat_words.shape[1]
    valid = as_u32(valid_mask).reshape(1, 1, wp)
    R = ref_words.shape[0]
    out = torch.empty((R, n_locs), dtype=torch.int32,
                      device=ref_words.device)
    for r0 in range(0, R, PLAIN_ROW_BLOCK):
        r1 = min(r0 + PLAIN_ROW_BLOCK, R)
        win = _windows(as_u32(ref_words[r0:r1]), n_locs, wp)
        diff = win ^ as_u32(pat_words[r0:r1])[:, None, :]
        mism = (diff | (diff >> 1)) & M1 & valid
        out[r0:r1] = pattern_chars - _mismatch_count(mism)
    return out


def match_swar_best_plain(ref_words: torch.Tensor, pat_words: torch.Tensor,
                          valid_mask: torch.Tensor, *, n_locs: int,
                          pattern_chars: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``match_swar_plain``, then the first ``argmax`` and the ``amax`` over
    alignments, in int32 (the merger's ``chunk_best``)."""
    scores = match_swar_plain(ref_words, pat_words, valid_mask,
                              n_locs=n_locs, pattern_chars=pattern_chars)
    return scores.argmax(dim=1).to(torch.int32), scores.amax(dim=1)


def match_swar_masks_plain(ref_words: torch.Tensor, pat_planes: torch.Tensor,
                           valid_mask: torch.Tensor, *, n_locs: int,
                           pattern_chars: int) -> torch.Tensor:
    """Plain torch mirror of the accept-set kernel (``_swar_masks_kernel``)."""
    wp = pat_planes.shape[1] // 4
    valid = as_u32(valid_mask).reshape(1, 1, wp)
    R = ref_words.shape[0]
    out = torch.empty((R, n_locs), dtype=torch.int32,
                      device=ref_words.device)
    for r0 in range(0, R, PLAIN_ROW_BLOCK):
        r1 = min(r0 + PLAIN_ROW_BLOCK, R)
        win = _windows(as_u32(ref_words[r0:r1]), n_locs, wp)
        planes = as_u32(pat_planes[r0:r1])[:, None, :]
        accept = torch.zeros_like(win)
        for c in range(4):
            diff = win ^ CODE_LANES[c]
            eq = ~(diff | (diff >> 1)) & M1
            accept |= eq & planes[..., c * wp:(c + 1) * wp]
        out[r0:r1] = pattern_chars - _mismatch_count(valid & ~accept)
    return out
