"""Technology tables of CRAM-PM and the planner's cost layer (port of
``repro.core.tech``).

The MTJ half is the paper's substrate, copied from the reference
(Table 3): ``MTJTech`` with its two points ``NEAR_TERM`` (45 nm
interfacial PMTJ, demonstrated devices) and ``LONG_TERM`` (10 nm
projected), the reported gate windows ``PAPER_VGATE_V``, the series
resistance ``R_SERIES_OHM`` of the analog gate model, ``ArrayGeometry``
and the NVSIM-style ``Periphery``.  ``gates`` and ``costmodel`` price the
CRAM-PM model from them.  NVSIM is not redistributable, so the periphery
constants are fixed calibration values chosen to reproduce the paper's
Fig. 6 shares (preset 43.86% of energy, 97.25% of latency; BL driver
under 1% of energy, 2.7% of latency; write under 1%), asserted by the
cost-model tests.

The cost half serves the planner.  It turns a shape into analytic
roofline seconds against a ``GPURoofline`` (pure arithmetic, no
overheads); the active ``CostSource`` turns those into wall seconds.
``StaticCostSource`` is the datasheet model: analytic seconds plus a
fixed per-dispatch overhead.  ``CalibratedCostSource`` prices each
kernel by its measured ``KernelCurve`` (fitted by
``repro_torch.match.calibrate``).  The reference's TPU roofline has no
counterpart here: the port's roofline is ``GPURoofline`` / ``H100``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional


@dataclasses.dataclass(frozen=True)
class MTJTech:
    """One column of paper Table 3 (plus the WER guard-band multiplier)."""

    name: str
    mtj_diameter_nm: float
    tmr_pct: float                 # tunnel magneto-resistance ratio
    ra_product_ohm_um2: float
    i_crit_ua: float               # 50%-switching critical current
    i_crit_multiplier: float       # WER guard band (2x near / 5x long, Sec. 4)
    switching_latency_ns: float    # MTJ free-layer switching time
    r_p_kohm: float                # parallel (logic 0) resistance
    r_ap_kohm: float               # anti-parallel (logic 1) resistance
    write_latency_ns: float
    read_latency_ns: float
    write_energy_pj: float         # per cell
    read_energy_pj: float          # per cell

    @property
    def i_crit_eff_ua(self) -> float:
        """Effective switching threshold used for gate design (Sec. 4)."""
        return self.i_crit_ua * self.i_crit_multiplier

    @property
    def r_p_ohm(self) -> float:
        return self.r_p_kohm * 1e3

    @property
    def r_ap_ohm(self) -> float:
        return self.r_ap_kohm * 1e3


NEAR_TERM = MTJTech(
    name="near-term",
    mtj_diameter_nm=45.0,
    tmr_pct=133.0,
    ra_product_ohm_um2=5.0,
    i_crit_ua=100.0,
    i_crit_multiplier=2.0,
    switching_latency_ns=3.0,
    r_p_kohm=3.15,
    r_ap_kohm=7.34,
    write_latency_ns=3.65,
    read_latency_ns=1.21,
    write_energy_pj=0.36,
    read_energy_pj=0.83,
)

LONG_TERM = MTJTech(
    name="long-term",
    mtj_diameter_nm=10.0,
    tmr_pct=500.0,
    ra_product_ohm_um2=1.0,
    i_crit_ua=3.95,
    i_crit_multiplier=5.0,
    switching_latency_ns=1.0,
    r_p_kohm=12.7,
    r_ap_kohm=76.39,
    write_latency_ns=1.72,
    read_latency_ns=1.24,
    write_energy_pj=0.308,
    read_energy_pj=0.78,
)

TECHS = {t.name: t for t in (NEAR_TERM, LONG_TERM)}

# Paper-reported V_gate windows (Table 3) -- used as a sanity reference by the
# gate-model tests (our analytically derived windows must preserve ordering and
# overlap the reported ranges after series-resistance calibration).
PAPER_VGATE_V = {
    "near-term": {
        "INV": (0.84, 1.30), "COPY": (0.84, 1.30), "NOR": (0.68, 0.74),
        "MAJ3": (0.65, 0.69), "MAJ5": (0.61, 0.62), "TH": (0.62, 0.63),
    },
    "long-term": {
        "INV": (0.23, 0.48), "COPY": (0.23, 0.48), "NOR": (0.20, 0.22),
        "MAJ3": (0.20, 0.21), "MAJ5": (0.19, 0.20), "TH": (0.19, 0.20),
    },
}


@dataclasses.dataclass(frozen=True)
class ArrayGeometry:
    """CRAM-PM array geometry (Sec. 3.4 / Sec. 4)."""

    n_rows: int = 512
    n_cols: int = 512
    # Max row width at 22nm with 160nm Cu LL segments (Sec. 3.4): ~2K cells.
    max_row_cells: int = 2048
    # Latency penalty of max-distance LL drive relative to MTJ switching time.
    ll_rc_penalty: float = 0.017


@dataclasses.dataclass(frozen=True)
class Periphery:
    """Peripheral circuit overheads (NVSIM-style, 22 nm), per array access.

    Calibrated so the step-accurate model reproduces the paper's Fig. 6
    shares; see module docstring.
    """

    # Row decoder + mux + precharge latency charged once per micro-op issue.
    decode_latency_ns: float = 0.42
    decode_energy_pj: float = 0.9
    # Bit-line driver: charged per activated BSL column per micro-op.
    bl_drive_latency_ns: float = 0.08
    bl_drive_energy_pj: float = 0.0035
    # Sense amplifier: reads only (computation excludes SAs entirely, Sec 3.4).
    sense_latency_ns: float = 0.30
    sense_energy_pj: float = 0.05
    # SMC micro-instruction issue overhead (decode from LUT + sequencing).
    smc_issue_latency_ns: float = 0.25
    smc_issue_energy_pj: float = 0.4


@dataclasses.dataclass(frozen=True)
class GPURoofline:
    """One NVIDIA card's peak rates for the planner's roofline terms."""

    name: str
    peak_bf16_flops: float        # dense tensor-core bf16, FLOP/s
    peak_int32_ops: float         # CUDA-core INT32 rate, op/s
    hbm_bw: float                 # device memory bytes/s
    nvlink_bw: float              # card-to-card bytes/s, one direction

    def merge_bw(self, one_card: bool) -> float:
        """Bytes/s a cross-shard merge crosses: device memory when every
        row shard sits on one card (the join is a copy within it), the
        card-to-card link when they sit on several."""
        return self.hbm_bw if one_card else self.nvlink_bw


# NVIDIA H100 SXM5 data sheet and Hopper architecture white paper (dense
# rates, no sparsity, at the full 700 W power limit): 989 TFLOP/s bf16,
# 3.35 TB/s HBM3, 132 SMs at a 1.98 GHz boost clock, each issuing 64
# INT32 ops per clock -> 132 * 64 * 1.98e9 ~ 16.7e12 int ops/s; NVLink 4
# at 900 GB/s both directions together, so 450 GB/s each way.
# Data-sheet figures, not measurements.
H100 = GPURoofline(
    name="H100-SXM",
    peak_bf16_flops=989e12,
    peak_int32_ops=132 * 64 * 1.98e9,
    hbm_bw=3.35e12,
    nvlink_bw=450e9,
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


# Conservative series resistance seen by each cell's current path (access
# transistor on-resistance + LL interconnect segment).  Single calibration
# knob for the analog gate model; chosen so near-term gate windows land on
# the paper's Table 3 values (NOR (0.68,0.74), MAJ3 (0.65,0.69), INV/COPY
# (0.84,1.30) -- see tests/test_gates.py).
R_SERIES_OHM = 1500.0
