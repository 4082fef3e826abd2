"""Peak rates of one NVIDIA H100 SXM at its full 700 W power limit.

NVIDIA's H100 data sheet (dense, without sparsity) gives the bf16 tensor
rate and the HBM3 bandwidth; the INT32 and population-count rates follow
from the Hopper white paper's 132 SMs at the 1.98 GHz boost clock, 64
INT32 operations a clock a SM, and the CUDA C++ Programming Guide's 16
population counts a clock a SM on compute capability 9.0.  A card set
below 700 W runs slower under load: every share is stated against these
peaks with the card's power limit beside it.
"""

from __future__ import annotations

from typing import Dict, Tuple

HBM_BYTES_PER_S = 3.35e12
PEAKS: Dict[str, float] = {
    "bf16_flop": 989e12,
    "int32_op": 132 * 64 * 1.98e9,
    "popc": 132 * 16 * 1.98e9,
}


def least_seconds(work: Dict[str, float]) -> Tuple[float, str]:
    """(least seconds, what bounds it) for ``work``: ``bytes`` over the
    HBM bandwidth, or an operation count over its peak, the larger."""
    best, by = work.get("bytes", 0.0) / HBM_BYTES_PER_S, "bytes"
    for kind, rate in PEAKS.items():
        t = work.get(kind, 0.0) / rate
        if t > best:
            best, by = t, kind
    return best, by
