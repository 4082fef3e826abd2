"""Thin wrappers over the match engine and the bulk kernels (port of
``repro.kernels.ops``).

``match_scores`` is a one-shot shim for callers that match once against a
throwaway fragment set; all packing, padding and kernel selection live in
``repro_torch.match``.  Long-lived callers hold a ``MatchEngine`` so the
corpus stays resident.

``popcount`` and ``bitwise`` are direct kernel wrappers.  ``popcount``
hands the caller's rows to ``popcount_rows`` unpadded (the kernel takes
any row count); ``bitwise`` pads rows to its kernel's ``N_TILE`` and
slices back, as the JAX ops do.  Their operands are uint32 words: a
numpy uint32 array (uploaded to ``device``, ``None`` meaning the card)
or an int32 tensor carrying the bits, which stays on its own device.
Results are int32 tensors on that device.
"""

from __future__ import annotations

import warnings
from typing import Literal, Optional, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

from . import bitwise as _bitwise
from . import popcount as _popcount

Words = Union[np.ndarray, torch.Tensor]


def match_scores(fragments: np.ndarray, patterns,
                 method: Optional[Literal["swar", "mxu", "ref"]] = None, *,
                 backend: Optional[str] = None,
                 device: DeviceLike = None) -> np.ndarray:
    """Similarity scores for all alignments (Algorithm 1 fast path).

    fragments: (R, F) uint8 codes.  patterns: (P,) shared, (R, P) per-row,
    or (Q, P) batched (-> (R, L, Q)) uint8 codes -- or a ``MatchQuery``
    (its reduction is forced to "full").  Returns (R, L) or (R, L, Q)
    int32, L = F - P + 1.  ``backend=None`` lets the planner pick;
    ``method=`` is the deprecated spelling of ``backend=``.
    """
    from repro_torch.match import MatchEngine

    if method is not None:
        warnings.warn("ops.match_scores(method=...) is deprecated; pass "
                      "backend=... or compile a MatchQuery",
                      DeprecationWarning, stacklevel=2)
        if backend is None:
            backend = method

    eng = MatchEngine(np.asarray(fragments, np.uint8), device=device)
    kw = {} if backend is None else {"backend": backend}
    return eng.scores(patterns if hasattr(patterns, "masks_b")
                      else np.asarray(patterns, np.uint8), **kw)


def _words(x: Words, device: DeviceLike) -> torch.Tensor:
    """uint32 words -> contiguous int32 bit-carrier tensor."""
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.int32:
            raise ValueError(f"word tensors carry uint32 bits in int32, got "
                             f"{x.dtype}")
        return x.contiguous()
    a = np.ascontiguousarray(np.asarray(x, np.uint32))
    return torch.from_numpy(a.view(np.int32)).to(resolve_device(device))


def _pad_rows(x: torch.Tensor, mult: int) -> torch.Tensor:
    r = (-x.shape[0]) % mult
    if r:
        x = torch.cat([x, x.new_zeros((r,) + tuple(x.shape[1:]))], 0)
    return x


def popcount(words: Words, *, device: DeviceLike = None) -> torch.Tensor:
    """(N, W) uint32 words -> (N,) int32 per-row bit counts."""
    w = _words(words, device)
    if w.data_ptr() % 16:   # a row slice that starts at an odd row, say
        w = w.clone()
    return _popcount.popcount_rows(w)[:, 0]


def bitwise(op: str, a: Words, b: Optional[Words] = None, *,
            device: DeviceLike = None) -> torch.Tensor:
    """Bulk bitwise op over (N, W) uint32 operands -> (N, W) int32 bits."""
    at = _words(a, device)
    n = at.shape[0]
    ap = _pad_rows(at, _bitwise.N_TILE)
    bp = None if b is None else _pad_rows(_words(b, at.device),
                                          _bitwise.N_TILE)
    return _bitwise.bitwise(op, ap, bp)[:n]
