"""State-space helpers (port of ``repro.models.ssm``).

Ported: ``_causal_conv``, the depthwise causal convolution that the RG-LRU
block (``repro_torch.models.rglru``) runs before its recurrence.  The
Mamba-2 SSD block itself (``ssd_specs``, ``ssd_apply``, its cache) waits
for ROADMAP Queue 1 item 16b; the port refuses the ``ssd`` block kind by
name (``repro_torch.models.model.check_ported``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv, kernel k.  x (B,S,C), w (k,C).  ``state``
    (B,k-1,C) holds the trailing context for decode; returns (y,
    new_state), ``new_state`` a view of the padded input.

    The taps add in the reference's order, each product and each partial
    sum rounded to x's dtype: ``0 + t0 + t1 + ... + t(k-1)`` (its Python
    ``sum``; the leading 0 changes nothing)."""
    k = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], k - 1, x.shape[-1]))
    xp = torch.cat([state, x], 1)
    S = x.shape[1]
    wx = w.to(x.dtype)
    y = xp[:, :S] * wx[0]
    for i in range(1, k):
        y = y + xp[:, i:i + S] * wx[i]
    return y, xp[:, -(k - 1):]
