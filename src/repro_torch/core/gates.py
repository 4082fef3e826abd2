"""Gate-level model of the CRAM-PM cell (paper Sec. 2.1-2.2).

Port of ``repro.core.gates``: NumPy and Python only, copied so the port
imports nothing of the JAX package.

Two views of every gate are provided and cross-checked in tests:

1. **Analog threshold model** (`output_current`, `vgate_window`): the gate is a
   resistive divider.  Input MTJs (resistance R_P for logic 0 / R_AP for 1)
   connect their BSL voltage ``V`` to the logic line LL; the output MTJ
   connects LL to ground.  The output switches away from its preset value iff
   the current through it exceeds the (guard-banded) critical current.  Gate
   *function* is selected purely by ``V_gate`` + the output preset, exactly as
   in the paper: the truth tables below *emerge* from device physics, they are
   not hard-coded.

2. **Functional model** (`GATE_FNS`): fast vectorized logic used by the array
   interpreter, validated against (1) for every input combination in
   ``tests/test_gates.py``.

Circuit solved (Fig. 1(c)): let ``u`` be the LL node voltage, ``g_i = 1/(R_i +
R_s)`` the input branch conductances (R_s = series transistor+wire resistance)
and ``g_o = 1/(R_out + R_s)`` the output branch conductance.  KCL gives::

    u = V * sum(g_i) / (g_o + sum(g_i))          (all input BSLs at V, out at 0)
    I_out = u * g_o  =  V * g_o * sum(g_i) / (g_o + sum(g_i))

``I_out`` is linear and increasing in ``V``, so for each input combination
there is a unique threshold voltage ``V* = I_crit / slope`` and every gate's
feasible window is an interval -- which is how the paper derives Table 3.

Two calibration facts recovered from the paper's own Table 3:

* Reported V_INV == V_COPY exactly, although INV presets the output to 0
  (R_P) and COPY to 1 (R_AP).  Hence the paper evaluates the output branch
  with a preset-independent resistance; we use R_P ("switching onset"
  resistance) for window derivation.
* Reported windows correspond to the *raw* 50%-switching I_crit; the 2x/5x
  WER guard band of Sec. 4 is applied to latency/energy derivation only.

With R_SERIES = 1.5 kOhm this model lands on the paper's near-term windows to
within a few tens of mV (asserted in tests/test_gates.py).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, Sequence, Tuple

import numpy as np

from .tech import MTJTech, R_SERIES_OHM


# ---------------------------------------------------------------------------
# Analog threshold model
# ---------------------------------------------------------------------------

def _branch_conductance(bit: int, tech: MTJTech, r_series: float) -> float:
    r = tech.r_ap_ohm if bit else tech.r_p_ohm
    return 1.0 / (r + r_series)


def output_current_slope(
    input_bits: Sequence[int], preset: int, tech: MTJTech,
    r_series: float = R_SERIES_OHM,
) -> float:
    """d(I_out)/dV for the given input combination.

    The output branch is evaluated at R_P (switching-onset resistance),
    independent of the preset -- see module docstring (this is what makes the
    paper's V_INV == V_COPY identity hold).  ``preset`` is kept in the
    signature for clarity at call sites.
    """
    del preset  # output branch modeled at R_P; see docstring.
    g_in = sum(_branch_conductance(b, tech, r_series) for b in input_bits)
    g_out = _branch_conductance(0, tech, r_series)
    return g_out * g_in / (g_out + g_in)


def output_current(
    input_bits: Sequence[int], preset: int, v_gate: float, tech: MTJTech,
    r_series: float = R_SERIES_OHM,
) -> float:
    """I_out (amps) through the output MTJ for input BSLs driven at v_gate."""
    return v_gate * output_current_slope(input_bits, preset, tech, r_series)


@dataclasses.dataclass(frozen=True)
class GateSpec:
    """A CRAM-PM gate = arity + output preset + which input combos switch.

    ``switches(bits) == True`` means I_out must exceed I_crit for that combo,
    flipping the output from ``preset`` to ``1 - preset``.
    """

    name: str
    arity: int
    preset: int
    switches: Callable[[Tuple[int, ...]], bool]

    def truth(self, bits: Tuple[int, ...]) -> int:
        return (1 - self.preset) if self.switches(bits) else self.preset


# Paper Sec. 2.2 gate set.  `switches` predicates follow directly from the
# current ordering I_00 > I_01 = I_10 > I_11 (more zeros => more current).
GATES: Dict[str, GateSpec] = {
    # NOR: preset 0; only the all-zeros combo drives enough current to switch.
    "NOR": GateSpec("NOR", 2, 0, lambda b: sum(b) == 0),
    # OR: same voltage window as NOR but preset 1 (out drops to 0 only on 00).
    "OR": GateSpec("OR", 2, 1, lambda b: sum(b) == 0),
    # NAND: preset 0; any combo with at least one zero switches.
    "NAND": GateSpec("NAND", 2, 0, lambda b: sum(b) <= 1),
    # AND: NAND window with preset 1.
    "AND": GateSpec("AND", 2, 1, lambda b: sum(b) <= 1),
    # INV: preset 0; switches when the single input is 0.
    "INV": GateSpec("INV", 1, 0, lambda b: b[0] == 0),
    # COPY (buffer): preset 1; switches to 0 when the input is 0.
    "COPY": GateSpec("COPY", 1, 1, lambda b: b[0] == 0),
    # MAJ3: preset 1; switches to 0 when fewer than two ones (majority 0).
    "MAJ3": GateSpec("MAJ3", 3, 1, lambda b: sum(b) < 2),
    # MAJ5: preset 1; switches to 0 when fewer than three ones.
    "MAJ5": GateSpec("MAJ5", 5, 1, lambda b: sum(b) < 3),
    # TH ("threshold", XOR helper, Sec. 2.2): 4 inputs, preset 0, switches
    # when at most one input is 1 (>=3 low-resistance branches).
    "TH": GateSpec("TH", 4, 0, lambda b: sum(b) <= 1),
}


def vgate_window(
    gate: str, tech: MTJTech, r_series: float = R_SERIES_OHM,
    i_crit_scale: float = 1.0,
) -> Tuple[float, float]:
    """Feasible (V_min, V_max) for `gate`; raises if the window is empty.

    ``i_crit_scale`` perturbs I_crit for the process-variation study (Sec 5.5).
    """
    spec = GATES[gate]
    i_crit = tech.i_crit_ua * 1e-6 * i_crit_scale   # raw I_crit; see docstring
    v_switch, v_hold = [], []
    for bits in itertools.product((0, 1), repeat=spec.arity):
        slope = output_current_slope(bits, spec.preset, tech, r_series)
        v_star = i_crit / slope
        (v_switch if spec.switches(bits) else v_hold).append(v_star)
    v_min = max(v_switch)            # must exceed every switching threshold
    v_max = min(v_hold) if v_hold else float("inf")
    if v_min >= v_max:
        raise ValueError(f"empty V_gate window for {gate} on {tech.name}")
    return (v_min, v_max)


def vgate_center(gate: str, tech: MTJTech, **kw) -> float:
    lo, hi = vgate_window(gate, tech, **kw)
    return 0.5 * (lo + hi)


def analog_gate_output(
    gate: str, input_bits: Sequence[int], tech: MTJTech,
    v_gate: float | None = None, r_series: float = R_SERIES_OHM,
    i_crit_scale: float = 1.0,
) -> int:
    """Evaluate a gate through the analog model (device-physics ground truth)."""
    spec = GATES[gate]
    if len(input_bits) != spec.arity:
        raise ValueError(f"{gate} expects {spec.arity} inputs")
    if v_gate is None:
        v_gate = vgate_center(gate, tech, r_series=r_series)
    i_out = output_current(input_bits, spec.preset, v_gate, tech, r_series)
    i_crit = tech.i_crit_ua * 1e-6 * i_crit_scale
    return (1 - spec.preset) if i_out > i_crit else spec.preset


# ---------------------------------------------------------------------------
# Functional (vectorized) model -- used by the array interpreter
# ---------------------------------------------------------------------------

def _maj(*xs):
    s = sum(x.astype(np.int32) if hasattr(x, "astype") else int(x) for x in xs)
    return (s * 2 > len(xs)).astype(xs[0].dtype) if hasattr(xs[0], "astype") else int(s * 2 > len(xs))


GATE_FNS: Dict[str, Callable] = {
    "NOR": lambda a, b: 1 - (a | b),
    "OR": lambda a, b: a | b,
    "NAND": lambda a, b: 1 - (a & b),
    "AND": lambda a, b: a & b,
    "INV": lambda a: 1 - a,
    "COPY": lambda a: a,
    "MAJ3": lambda a, b, c: ((a + b + c) >= 2).astype(a.dtype) if hasattr(a, "astype") else int(a + b + c >= 2),
    "MAJ5": lambda a, b, c, d, e: ((a + b + c + d + e) >= 3).astype(a.dtype) if hasattr(a, "astype") else int(a + b + c + d + e >= 3),
    "TH": lambda a, b, c, d: ((a + b + c + d) <= 1).astype(a.dtype) if hasattr(a, "astype") else int(a + b + c + d <= 1),
}


def gate_energy_pj(gate: str, tech: MTJTech, r_series: float = R_SERIES_OHM) -> float:
    """Worst-case per-row energy of one gate invocation (pJ).

    Energy = sum over branches of V_drop * I * t_switch, evaluated at the
    gate's center voltage for the highest-current input combination (all
    zeros), plus the output switching event itself.  This ties the cost model
    to the device model instead of a free constant.
    """
    spec = GATES[gate]
    v = vgate_center(gate, tech, r_series=r_series)
    bits = (0,) * spec.arity                      # highest-current case
    g_in = [_branch_conductance(b, tech, r_series) for b in bits]
    g_out = _branch_conductance(spec.preset, tech, r_series)
    u = v * sum(g_in) / (g_out + sum(g_in))
    t = tech.switching_latency_ns * 1e-9
    p_inputs = sum((v - u) * (v - u) * g for g in g_in)   # input branch drops
    p_out = u * u * g_out
    return (p_inputs + p_out) * t * 1e12


# Gates actually used by the pattern-matching workload (Sec. 3.2).
PM_GATE_SET = ("NOR", "INV", "COPY", "MAJ3", "MAJ5", "TH")


def icrit_tolerance(gate: str, tech: MTJTech) -> Tuple[float, float]:
    """Multiplicative I_crit drift interval tolerated at the nominal V_gate.

    Windows scale linearly with I_crit, so with V fixed at the nominal center
    ``c`` of window (lo, hi), the gate stays correct for scale s in
    (c/hi, c/lo).  Returns that interval.
    """
    lo, hi = vgate_window(gate, tech)
    c = 0.5 * (lo + hi)
    return (c / hi, c / lo)


def variation_study(tech: MTJTech, scales=(0.05, 0.10, 0.20)) -> Dict[str, object]:
    """Sec. 5.5 process-variation analysis.

    The paper's claim is that switching-current variation is "unlikely" to
    make gate *functions overlap* because gates with close V_gate are
    distinguished by preset value or input count.  Within the pattern
    matching gate set this is structural: no two gates share (arity, preset),
    so no variation can alias one used gate into another.  Per-gate absolute
    tolerance (drift the gate survives without V_gate recalibration) is also
    reported; narrow-window MAJ gates need recalibration beyond ~1-3% --
    consistent with the sliver-thin MAJ windows in the paper's own Table 3.
    """
    arity_preset = {(GATES[g].arity, GATES[g].preset) for g in PM_GATE_SET}
    structural_distinct = len(arity_preset) == len(PM_GATE_SET)
    tol = {g: icrit_tolerance(g, tech) for g in GATES}
    per_scale = {
        s: {g: (tol[g][0] <= 1 - s and 1 + s <= tol[g][1]) for g in GATES}
        for s in scales
    }
    return {
        "pm_gates_structurally_distinct": structural_distinct,
        "tolerance_interval": tol,
        "survives_plus_minus": per_scale,
    }
