"""Plain-torch oracles of the match semantics (port of ``repro.kernels.ref``).

These are the planner's ``ref`` backend (plain tensor ops the planner
picks for tiny workloads) and the tests' oracles.  They are not the
kernels' plain versions: those live beside each kernel
(``match_swar.match_swar_plain`` and friends) and repeat the kernel's own
arithmetic.

uint32 words travel as int32 tensors carrying the same bits
(``torch.from_numpy(a.view(np.int32))``).  torch has no logical right
shift on int32 and no shifts at all on uint32 on the CPU, so the packed
mirror widens to int64, masks to 32 bits, and shifts there.
"""

from __future__ import annotations

import torch

M1 = 0x55555555
M2 = 0x33333333
M4 = 0x0F0F0F0F
MUL = 0x01010101
U32 = 0xFFFFFFFF


def as_u32(words: torch.Tensor) -> torch.Tensor:
    """int32 bit-carrier -> int64 holding the unsigned value in [0, 2**32)."""
    return words.to(torch.int64) & U32


def popcount_words(v: torch.Tensor) -> torch.Tensor:
    """Branch-free SWAR popcount per word (the JAX ``popcount_words``).

    ``v`` holds unsigned words in int64 (``as_u32``); the counts come back
    as int64.  The plain versions of the filter and popcount kernels use
    it.
    """
    v = v - ((v >> 1) & M1)
    v = (v & M2) + ((v >> 2) & M2)
    v = (v + (v >> 4)) & M4
    return ((v * MUL) & U32) >> 24


def match_scores_ref(fragments: torch.Tensor,
                     patterns: torch.Tensor) -> torch.Tensor:
    """Character-level sliding similarity scores (Algorithm 1 semantics).

    fragments: (R, F) uint8 codes; patterns: (P,) or (R, P).
    Returns (R, F-P+1) int32: number of character matches per alignment.
    """
    if patterns.ndim == 1:
        patterns = patterns.expand(fragments.shape[0], patterns.shape[0])
    F = fragments.shape[1]
    P = patterns.shape[1]
    cols = [(fragments[:, o:o + P] == patterns).sum(-1, dtype=torch.int32)
            for o in range(F - P + 1)]
    return torch.stack(cols, dim=1)


def match_scores_masks_ref(fragments: torch.Tensor,
                           masks: torch.Tensor) -> torch.Tensor:
    """Accept-set sliding scores (predicate semantics).

    fragments: (R, F) uint8 codes; masks: (P,) or (R, P) uint8 accept
    masks -- bit c of position i set iff code c matches there.  Returns
    (R, F-P+1) int32: number of accepted positions per alignment.
    """
    masks = masks.to(torch.uint8)
    if masks.ndim == 1:
        masks = masks.expand(fragments.shape[0], masks.shape[0])
    F = fragments.shape[1]
    P = masks.shape[1]
    cols = [((masks >> fragments[:, o:o + P]) & 1).sum(-1, dtype=torch.int32)
            for o in range(F - P + 1)]
    return torch.stack(cols, dim=1)


def match_scores_swar_ref(ref_words: torch.Tensor, pat_words: torch.Tensor,
                          valid_mask: torch.Tensor, n_locs: int,
                          pattern_chars: int) -> torch.Tensor:
    """Mirror of the SWAR kernel's packed semantics, one alignment at a time.

    ref_words: (R, W) uint32 bits in int32, 16 2-bit chars/word, padded
    with >= 1 zero word beyond the last alignment's reach.  pat_words:
    (R, Wp).  valid_mask: (Wp,) or (1, Wp) -- low bit of each valid lane.
    """
    ref = as_u32(ref_words)
    pat = as_u32(pat_words)
    valid = as_u32(valid_mask).reshape(1, -1)
    Wp = pat.shape[1]
    out = []
    for loc in range(n_locs):
        base, sh = divmod(loc, 16)
        seg = ref[:, base:base + Wp + 1]
        window = seg[:, :Wp] >> (2 * sh)
        if sh:
            window = (window | (seg[:, 1:] << (32 - 2 * sh))) & U32
        diff = window ^ pat
        mism = (diff | (diff >> 1)) & M1 & valid
        # mism has at most one bit per 2-bit lane -> start SWAR at stage 2.
        v = (mism & M2) + ((mism >> 2) & M2)
        v = (v + (v >> 4)) & M4
        mismatches = (((v * MUL) & U32) >> 24).sum(-1)
        out.append(pattern_chars - mismatches)
    return torch.stack(out, dim=1).to(torch.int32)


def onehot_scores_ref(fragments: torch.Tensor,
                      patterns: torch.Tensor) -> torch.Tensor:
    """Batched-pattern scores via one-hot contraction (MXU formulation).

    fragments: (R, F) uint8; patterns: (Q, P) uint8.
    Returns (R, L, Q) int32 -- score of pattern q aligned at loc o of row r.
    """
    R, F = fragments.shape
    Q, P = patterns.shape
    f1h = one_hot(fragments, 4)              # (R, F, 4)
    p1h = one_hot(patterns, 4).reshape(Q, P * 4)
    out = [f1h[:, o:o + P, :].reshape(R, P * 4) @ p1h.T
           for o in range(F - P + 1)]
    return torch.stack(out, dim=1).to(torch.int32)


def one_hot(x: torch.Tensor, n: int,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (x[..., None] == torch.arange(n, dtype=x.dtype,
                                         device=x.device)).to(dtype)
