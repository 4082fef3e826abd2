"""The planner's cost layer: GPU roofline constants and ``CostSource``.

Port of the cost half of ``repro.core.tech``.  The planner turns a shape
into analytic roofline seconds against a ``GPURoofline`` (pure
arithmetic, no overheads); the active ``CostSource`` turns those into
wall seconds.  ``StaticCostSource`` is the datasheet model: analytic
seconds plus a fixed per-dispatch overhead.  ``CalibratedCostSource``
prices each kernel by its measured ``KernelCurve`` (fitted by
``repro_torch.match.calibrate``).  The MTJ / CRAM technology
tables of the reference module describe the paper's substrate, not this
card, and belong to the later CRAM-model slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional


@dataclasses.dataclass(frozen=True)
class GPURoofline:
    """One NVIDIA card's peak rates for the planner's roofline terms."""

    name: str
    peak_bf16_flops: float        # dense tensor-core bf16, FLOP/s
    peak_int32_ops: float         # CUDA-core INT32 rate, op/s
    hbm_bw: float                 # device memory bytes/s


# NVIDIA H100 SXM5 data sheet and Hopper architecture white paper (dense
# rates, no sparsity, at the full 700 W power limit): 989 TFLOP/s bf16,
# 3.35 TB/s HBM3, 132 SMs at a 1.98 GHz boost clock, each issuing 64
# INT32 ops per clock -> 132 * 64 * 1.98e9 ~ 16.7e12 int ops/s.
# Data-sheet figures, not measurements.
H100 = GPURoofline(
    name="H100-SXM",
    peak_bf16_flops=989e12,
    peak_int32_ops=132 * 64 * 1.98e9,
    hbm_bw=3.35e12,
)

# Per-kernel-dispatch overhead the *static* cost source charges: the
# order of magnitude of one CUDA launch plus its Python wrapper (an
# assumption, not a measurement).  A calibrated source replaces it with
# each kernel's measured intercept (``KernelCurve.beta``).
DISPATCH_OVERHEAD_S = 5e-6
# The ref backend is a Python loop of small torch ops per call, with
# overhead well above one kernel launch (assumption, not measured).
REF_CALL_OVERHEAD_S = 5e-5


class CostSource:
    """Prices one kernel dispatch from its analytic roofline seconds.

    ``tag`` is the provenance string recorded in every ``Plan.reason``
    ("static" for the datasheet model).
    """

    name = "abstract"

    def price(self, kernel: str, analytic_s: float,
              n_dispatch: int = 1) -> float:
        raise NotImplementedError

    @property
    def tag(self) -> str:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.tag})"


@dataclasses.dataclass(frozen=True)
class StaticCostSource(CostSource):
    """Datasheet pricing: analytic roofline + fixed dispatch overhead."""

    dispatch_overhead_s: float = DISPATCH_OVERHEAD_S
    ref_call_overhead_s: float = REF_CALL_OVERHEAD_S
    name = "static"

    def price(self, kernel: str, analytic_s: float,
              n_dispatch: int = 1) -> float:
        per = (self.ref_call_overhead_s if kernel == "ref"
               else self.dispatch_overhead_s)
        return analytic_s + n_dispatch * per

    @property
    def tag(self) -> str:
        return "static"


@dataclasses.dataclass(frozen=True)
class KernelCurve:
    """One kernel's fitted cost curve: measured = alpha*analytic + beta.

    ``alpha`` is the measured overhead factor over the analytic op/byte
    model (the SNIPPETS.md Sec. 2 idiom: measured cycles / pure-FMACS
    cycles); ``beta`` is the measured per-dispatch intercept (launch,
    wrapper, synchronize).  Both are fitted under positivity
    constraints, so calibrated pricing inherits the analytic model's
    monotonicity in R, P and Q.
    """

    alpha: float                  # overhead factor (> 0)
    beta: float                   # per-dispatch fixed seconds (>= 0)
    n_samples: int = 0
    rel_err: float = 0.0          # max relative residual of the fit

    def seconds(self, analytic_s: float, n_dispatch: int = 1) -> float:
        return self.alpha * analytic_s + n_dispatch * self.beta


class CalibratedCostSource(CostSource):
    """Measured per-kernel curves; unknown kernels fall back to static."""

    name = "calibrated"

    def __init__(self, curves: Mapping[str, KernelCurve], *, digest: str,
                 meta: Optional[Mapping] = None,
                 fallback: Optional[CostSource] = None):
        self.curves: Dict[str, KernelCurve] = dict(curves)
        self.digest = str(digest)
        self.meta = dict(meta or {})
        self.fallback = fallback or StaticCostSource()

    def price(self, kernel: str, analytic_s: float,
              n_dispatch: int = 1) -> float:
        curve = self.curves.get(kernel)
        if curve is None:
            return self.fallback.price(kernel, analytic_s, n_dispatch)
        return curve.seconds(analytic_s, n_dispatch)

    @property
    def tag(self) -> str:
        return f"calibrated:{self.digest[:8]}"
