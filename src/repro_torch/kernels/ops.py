"""One-shot ``match_scores`` shim over the match engine (port of the
``match_scores`` half of ``repro.kernels.ops``).

Kept for callers that match once against a throwaway fragment set; all
packing, padding and kernel selection live in ``repro_torch.match``.
Long-lived callers hold a ``MatchEngine`` so the corpus stays resident.
The bulk ``popcount`` / ``bitwise`` wrappers wait for their kernels.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.device import DeviceLike


def match_scores(fragments: np.ndarray, patterns, *,
                 backend: Optional[str] = None,
                 device: DeviceLike = None) -> np.ndarray:
    """Similarity scores for all alignments (Algorithm 1 fast path).

    fragments: (R, F) uint8 codes.  patterns: (P,) shared, (R, P) per-row,
    or (Q, P) batched (-> (R, L, Q)) uint8 codes -- or a ``MatchQuery``
    (its reduction is forced to "full").  Returns (R, L) or (R, L, Q)
    int32, L = F - P + 1.  ``backend=None`` lets the planner pick.
    """
    from repro_torch.match import MatchEngine

    eng = MatchEngine(np.asarray(fragments, np.uint8), device=device)
    kw = {} if backend is None else {"backend": backend}
    return eng.scores(patterns if hasattr(patterns, "masks_b")
                      else np.asarray(patterns, np.uint8), **kw)
