"""N-gram speculative proposer backed by the CRAM-PM matcher (port of
``repro.serving.ngram_cache``).

Token history is transcoded to the 2-bit alphabet (each token id -> 8
crumbs, its low 16 bits) and folded across rows like the paper's reference
(Fig. 3).  To propose continuations for the current suffix, the suffix is
matched row-parallel against the history through
``repro_torch.kernels.ops.match_scores`` -- on the card the ``match_swar``
CUDA kernel (a full-reduction scan, STORE) -- and the tokens following the
best-scoring alignment are proposed.  As in the reference, each call
builds a one-shot ``MatchEngine`` over the folded history.

Ids that agree in their low 16 bits alias in the match (vocabularies past
65,536 ids, such as llama3.2-1b's 128,256); the reference does the same,
and greedy output stays exact because the model verifies every proposal.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.core import encoding
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops

CRUMBS_PER_TOKEN = 8    # 16-bit token ids -> 8 two-bit crumbs


def tokens_to_crumbs(tokens: np.ndarray) -> np.ndarray:
    tokens = np.asarray(tokens, np.uint32)
    shifts = (2 * np.arange(CRUMBS_PER_TOKEN, dtype=np.uint32))
    return ((tokens[..., None] >> shifts) & 3).astype(np.uint8).reshape(
        tokens.shape[:-1] + (-1,))


class NgramSpeculator:
    def __init__(self, suffix_tokens: int = 4, fragment_tokens: int = 128,
                 method: str = "swar", device: DeviceLike = None):
        self.suffix_tokens = suffix_tokens
        self.fragment_tokens = fragment_tokens
        self.method = method
        self.device = resolve_device(device)
        self.history: List[int] = []

    def feed(self, tokens) -> None:
        self.history.extend(int(t) for t in np.asarray(tokens).reshape(-1))

    def propose(self, suffix, k: int = 4) -> Tuple[np.ndarray, float]:
        """Speculative continuation of length k after the best match of
        ``suffix`` in the history.  Returns (tokens (<=k,), confidence)."""
        suffix = np.asarray(suffix, np.int64).reshape(-1)[-self.suffix_tokens:]
        hist = np.asarray(self.history, np.int64)
        if len(hist) < len(suffix) + 1:
            return np.zeros((0,), np.int64), 0.0
        crumbs = tokens_to_crumbs(hist)
        pat = tokens_to_crumbs(suffix)
        frag_len = min(self.fragment_tokens * CRUMBS_PER_TOKEN, len(crumbs))
        frags = encoding.fold_reference(crumbs, frag_len, len(pat))
        scores = np.asarray(ops.match_scores(frags, pat, backend=self.method,
                                             device=self.device))
        r, loc = np.unravel_index(scores.argmax(), scores.shape)
        conf = float(scores[r, loc]) / len(pat)
        # Token index right after the matched suffix in the original stream.
        step = frag_len - (len(pat) - 1)
        crumb_pos = r * step + loc + len(pat)
        tok_pos = crumb_pos // CRUMBS_PER_TOKEN
        if crumb_pos % CRUMBS_PER_TOKEN:
            tok_pos += 1
        return hist[tok_pos: tok_pos + k], conf


def verify(proposed: np.ndarray, actual: np.ndarray) -> int:
    """Speculation acceptance: length of the agreeing prefix."""
    n = min(len(proposed), len(actual))
    agree = 0
    for i in range(n):
        if proposed[i] != actual[i]:
            break
        agree += 1
    return agree
