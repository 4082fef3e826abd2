"""The semantics of a match, written out plainly.

A read of P positions aligned at offset ``l`` of a row of F codes scores
the number of positions ``j`` whose accept mask holds the row's code at
``l + j`` (an exact read accepts only its own base; ``N`` accepts all
four).  Over the ``F - P + 1`` offsets of a row:

* ``best``: the highest score and the first offset that reaches it;
* ``hits``: every (row, offset, score) with score >= the threshold.

``skip`` leaves positions out of every score.  No sound check uses it:
it is the control, an answer that is no longer exact.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

# Scores held at once: (rows, offsets, reads) under 512 MiB.
BLOCK_SCORES = 1 << 27


def _block(masks: np.ndarray, F: int) -> int:
    k, P = masks.shape
    return max(64, min(1 << 15, BLOCK_SCORES // ((F - P + 1) * max(k, 1))))


def as_masks(codes: np.ndarray) -> np.ndarray:
    """(k, P) codes 0..3 -> (k, P) one-base accept masks."""
    return (np.uint8(1) << np.asarray(codes, np.uint8)).astype(np.uint8)


def _scores(rows: torch.Tensor, masks: torch.Tensor,
            skip: Optional[Sequence[int]]) -> torch.Tensor:
    """(n, F) codes x (k, P) masks -> (n, L, k) int32 scores.

    The sliding count is a correlation of the rows' one-hot codes with the
    masks' accept bits, in float32 with TF32 off: every product is 0 or 1
    and every sum at most P, so the float result is the exact count (it
    is rounded only against an FFT algorithm's last-bit noise)."""
    P = masks.shape[1]
    bits = ((masks[:, None, :].long()
             >> torch.arange(4, device=masks.device)[None, :, None]) & 1)
    weight = bits.to(torch.float32)                   # (k, 4, P)
    if skip:
        weight[:, :, list(skip)] = 0
    onehot = torch.nn.functional.one_hot(rows.long(), 4).to(
        torch.float32).transpose(1, 2)                # (n, 4, F)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        out = torch.nn.functional.conv1d(onehot, weight)  # (n, k, L)
    return out.round().to(torch.int32).transpose(1, 2)


def best(frags: torch.Tensor, masks: np.ndarray,
         skip: Optional[Sequence[int]] = None,
         rows: Optional[np.ndarray] = None):
    """Per row and read: (locs (n, k) int64, scores (n, k) int64) on the
    host; the first offset that reaches the row's best score."""
    m = torch.from_numpy(np.ascontiguousarray(masks, np.uint8)).to(
        frags.device)
    idx = None if rows is None else torch.from_numpy(
        np.asarray(rows, np.int64)).to(frags.device)
    n = frags.shape[0] if idx is None else idx.shape[0]
    block = _block(masks, frags.shape[1])
    locs, scores = [], []
    for r0 in range(0, n, block):
        part = (frags[r0:r0 + block] if idx is None
                else frags[idx[r0:r0 + block]])
        sc = _scores(part, m, skip)                   # (b, L, k)
        top = sc.amax(1, keepdim=True)
        L = sc.shape[1]
        pos = torch.arange(L, device=sc.device).view(1, L, 1)
        first = torch.where(sc == top, pos, L).amin(1)
        locs.append(first.cpu())
        scores.append(top[:, 0].cpu())
    return (torch.cat(locs).numpy().astype(np.int64),
            torch.cat(scores).numpy().astype(np.int64))


def hits(frags: torch.Tensor, masks: np.ndarray, thresholds: Sequence[float],
         skip: Optional[Sequence[int]] = None) -> List[np.ndarray]:
    """Per read: (n, 3) int64 rows ``[row, offset, score]`` with score >=
    its threshold, ascending by row then offset."""
    m = torch.from_numpy(np.ascontiguousarray(masks, np.uint8)).to(
        frags.device)
    thr = torch.tensor([float(t) for t in thresholds], device=frags.device)
    found: List[List[torch.Tensor]] = [[] for _ in range(m.shape[0])]
    block = _block(masks, frags.shape[1])
    for r0 in range(0, frags.shape[0], block):
        sc = _scores(frags[r0:r0 + block], m, skip)
        for q in range(m.shape[0]):
            at = torch.nonzero(sc[:, :, q] >= thr[q])
            if at.shape[0]:
                vals = sc[at[:, 0], at[:, 1], q]
                at[:, 0] += r0
                found[q].append(torch.cat([at, vals[:, None].long()], 1)
                                .cpu())
    out = []
    for f in found:
        h = (torch.cat(f).numpy().astype(np.int64) if f
             else np.zeros((0, 3), np.int64))
        out.append(h[np.lexsort((h[:, 1], h[:, 0]))])
    return out
