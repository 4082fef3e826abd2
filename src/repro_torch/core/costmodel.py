"""Step-accurate throughput/energy model of CRAM-PM (paper Secs. 4-5).

Port of ``repro.core.costmodel`` (Python only, copied); it prices the
port's own code generation (``isa``, ``matcher``) and device model
(``gates``, ``tech``), so its numbers equal the reference's exactly.

Reproduces the paper's evaluation pipeline: stages (1)-(8) of Sec. 4,
per-stage latency and energy from the device model (``gates``/``tech``) plus
NVSIM-style periphery, composed over the pattern schedule (Naive / Oracular,
plain / Opt, near- / long-term MTJ).

Calibration policy (documented, single-sourced):

* Per-op latency ``t_op = switching + periphery`` where periphery =
  decode + SMC issue + BL drive = 0.745 ns.  This reproduces the paper's
  long-term boost of ~2.15x exactly: (3+0.745)/(1+0.745) = 2.146.
* Row-sequential preset latency = n_rows * write_latency *
  ``SMC_WRITE_PIPELINE`` (write pipelining inside the SMC; the only free
  scalar, calibrated once so the Naive DNA run lands on the paper's
  23 215.3 hours; everything else -- Oracular hours, preset shares, Opt
  speedups, sensitivity curves -- is then *derived*).
* Gate energy per row = I_crit_eff * V_gate_center * t_switch (one output
  MTJ switching event at the gate's operating point).  This lands the
  unoptimized preset energy share at ~42-44% (paper: 43.86%) with no tuning.

Baselines (GPU / NMP / Ambit / Pinatubo) are analytic models parameterized
from published data; see class docstrings.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

from . import gates
from .matcher import count_alignment_ops, plan_layout
from .scheduler import oracular_passes_analytic
from .tech import LONG_TERM, NEAR_TERM, MTJTech, Periphery

SMC_WRITE_PIPELINE = 0.515  # calibrated once against Naive = 23215.3 h
N_BANKS = 8                 # EverSpin-style banking (Sec. 3.4)


@dataclasses.dataclass(frozen=True)
class Design:
    """A CRAM-PM design point for the DNA case study (Sec. 4)."""

    tech: MTJTech = NEAR_TERM
    periphery: Periphery = Periphery()
    n_arrays: int = 300
    n_rows: int = 10_000
    n_cols: int = 2_400            # ~24 Mb per array (Sec. 3.4)
    pattern_chars: int = 100
    opt: bool = False              # gang-preset schedule (Sec. 3.4)
    ref_len: int = 3_000_000_000

    @property
    def t_op_ns(self) -> float:
        """One row-parallel logic step (switch + decode + SMC + BL drive)."""
        p = self.periphery
        return (self.tech.switching_latency_ns + p.decode_latency_ns
                + p.smc_issue_latency_ns + p.bl_drive_latency_ns)

    @property
    def total_rows(self) -> int:
        return self.n_arrays * self.n_rows


# Average per-row gate energies, from the analog device model.
def _gate_energy_table(tech: MTJTech) -> Dict[str, float]:
    table = {}
    for g in ("NOR", "OR", "NAND", "AND", "INV", "COPY", "MAJ3", "MAJ5", "TH"):
        v = gates.vgate_center(g, tech)
        table[g] = tech.i_crit_eff_ua * 1e-6 * v * tech.switching_latency_ns * 1e-9 * 1e12  # pJ
    return table


@dataclasses.dataclass
class StageCost:
    latency_s: float = 0.0
    energy_j: float = 0.0

    def __iadd__(self, other: "StageCost"):
        self.latency_s += other.latency_s
        self.energy_j += other.energy_j
        return self


@dataclasses.dataclass
class PassCost:
    """Latency/energy of one substrate pass, broken down by stage (Sec. 4)."""

    stages: Dict[str, StageCost]
    n_alignments: int

    @property
    def latency_s(self) -> float:
        return sum(s.latency_s for s in self.stages.values())

    @property
    def energy_j(self) -> float:
        return sum(s.energy_j for s in self.stages.values())

    def share(self, stage: str, kind: str = "latency") -> float:
        total = self.latency_s if kind == "latency" else self.energy_j
        val = (self.stages[stage].latency_s if kind == "latency"
               else self.stages[stage].energy_j)
        return val / total if total else 0.0


def alignment_census(design: Design) -> dict:
    return count_alignment_ops(design.pattern_chars, design.n_cols,
                               opt=design.opt)


def pass_cost(design: Design) -> PassCost:
    """One pass = write pattern (1) + per-alignment stages (2)-(8)."""
    tech, p = design.tech, design.periphery
    census = alignment_census(design)
    layout = plan_layout(design.n_cols, design.pattern_chars,
                         scratch_budget=128)
    n_align = layout.n_alignments
    e_gate = _gate_energy_table(tech)
    n_rows = design.n_rows

    logic_counts = {k: v for k, v in census.items() if k in e_gate}
    n_logic = census["TOTAL_LOGIC"]
    n_presets = census["PRESETS"]
    score_bits = census["SCORE_BITS"]

    stages: Dict[str, StageCost] = {}

    # Stage 1: write pattern into every row (row-parallel word write per row,
    # rows sequential; arrays in parallel).  2 bits/char.
    write_bits_per_row = 2 * design.pattern_chars
    stages["1_write_pattern"] = StageCost(
        latency_s=n_rows * tech.write_latency_ns * 1e-9,
        energy_j=(n_rows * write_bits_per_row * tech.write_energy_pj * 1e-12
                  * design.n_arrays),
    )

    # Stages 2+5: presets.  Energy identical for both schedules (same number
    # of preset cell-switches, paper Sec. 5.1); latency differs drastically.
    preset_energy = (n_presets * n_rows * tech.write_energy_pj * 1e-12
                     * design.n_arrays * n_align)
    if design.opt:
        preset_latency = n_presets * design.t_op_ns * 1e-9 * n_align
    else:
        preset_latency = (n_presets * n_rows * tech.write_latency_ns
                          * SMC_WRITE_PIPELINE * 1e-9 * n_align)
    stages["2_5_presets"] = StageCost(preset_latency, preset_energy)

    # Stages 3+6: bit-line activation (BSL voltage setup per micro-op).
    stages["3_6_bl_drive"] = StageCost(
        latency_s=n_logic * p.bl_drive_latency_ns * 1e-9 * n_align * 0.0,
        energy_j=(n_logic * 3.5 * p.bl_drive_energy_pj * 1e-12
                  * design.n_arrays * n_align),
    )
    # BL drive latency is part of t_op (see Design.t_op_ns); kept at zero here
    # to avoid double counting, energy charged per driven column.

    # Stages 4+7: match-phase and score-phase gate execution.
    per_char_ops = {"NOR": 3, "COPY": 3, "TH": 2}  # Fig. 4a per character
    match_ops = {k: per_char_ops.get(k, 0) * design.pattern_chars
                 for k in logic_counts}
    score_ops = {k: logic_counts[k] - match_ops.get(k, 0)
                 for k in logic_counts}

    def phase_cost(ops: Dict[str, int]) -> StageCost:
        n = sum(ops.values())
        e = sum(cnt * e_gate[k] for k, cnt in ops.items())
        return StageCost(
            latency_s=n * design.t_op_ns * 1e-9 * n_align,
            energy_j=e * 1e-12 * n_rows * design.n_arrays * n_align,
        )

    stages["4_match"] = phase_cost(match_ops)
    stages["7_score"] = phase_cost(score_ops)

    # Stage 8: score read-out (score buffer; one row at a time per bank).
    readout_latency = (n_rows / N_BANKS) * tech.read_latency_ns * 1e-9 * n_align
    readout_energy = (n_rows * score_bits * tech.read_energy_pj * 1e-12
                      * design.n_arrays * n_align)
    compute_latency = (stages["4_match"].latency_s + stages["7_score"].latency_s
                       + (stages["2_5_presets"].latency_s if design.opt else 0))
    if design.opt:
        # Masked behind gang presets + compute via banking (Secs. 3.2/3.4).
        readout_latency = max(0.0, readout_latency - compute_latency)
    stages["8_readout"] = StageCost(readout_latency, readout_energy)

    return PassCost(stages, n_align)


@dataclasses.dataclass
class RunResult:
    n_patterns: int
    n_passes: float
    total_time_s: float
    total_energy_j: float

    @property
    def match_rate(self) -> float:
        return self.n_patterns / self.total_time_s

    @property
    def power_mw(self) -> float:
        return self.total_energy_j / self.total_time_s * 1e3

    @property
    def efficiency(self) -> float:
        """patterns / s / mW (paper's compute-efficiency metric)."""
        return self.match_rate / self.power_mw


def run_workload(design: Design, n_patterns: int, scheduling: str,
                 kmer: int | None = None) -> RunResult:
    """End-to-end DNA run (Fig. 5): Naive or Oracular x plain/Opt design.

    ``kmer=None`` uses the adaptive seed length (scheduler.adaptive_seed_k).
    """
    pc = pass_cost(design)
    if scheduling == "naive":
        n_passes = float(n_patterns)
    elif scheduling == "oracular":
        n_passes = oracular_passes_analytic(
            n_patterns, design.total_rows, design.ref_len,
            design.pattern_chars, k=kmer)
    else:
        raise ValueError(scheduling)
    return RunResult(
        n_patterns=n_patterns,
        n_passes=n_passes,
        total_time_s=n_passes * pc.latency_s,
        total_energy_j=n_passes * pc.energy_j,
    )


def peak_array_current_a(design: Design) -> float:
    """Peak current of one array during row-parallel compute (Sec. 3.4)."""
    i_per_row = design.tech.i_crit_eff_ua * 1e-6 * 2.0  # output + input paths
    return design.n_rows * i_per_row


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GPUBaseline:
    """BarraCUDA-class GPU BWA aligner (paper refs [12],[26]).

    Published end-to-end throughput ~25M reads/hour; the pattern-matching
    kernel is 88% of runtime at 4 mismatches (paper footnote 1), so the
    kernel-only rate we compare against is end_to_end / 0.88.
    """

    reads_per_hour: float = 25e6
    kernel_share: float = 0.88
    board_power_w: float = 250.0

    @property
    def match_rate(self) -> float:
        return self.reads_per_hour / 3600.0 / self.kernel_share

    @property
    def efficiency(self) -> float:
        return self.match_rate / (self.board_power_w * 1e3 * self.kernel_share)


@dataclasses.dataclass(frozen=True)
class NMPBaseline:
    """HMC + ARM Cortex-A5 logic-layer model (paper Sec. 4).

    64 single-issue in-order cores at 1 GHz (peak 5.12 W); four links at
    160 GB/s.  Throughput = max(compute, memory) over profiled instruction
    and byte counts per work item.  ``hyp=True`` = 128 cores, zero memory
    overhead (NMP-Hyp).
    """

    n_cores: int = 64
    freq_hz: float = 1e9
    ipc: float = 1.0
    link_bw: float = 4 * 160e9
    core_power_w: float = 0.08
    dram_power_w: float = 10.0
    hyp: bool = False

    def time_per_item(self, instrs: float, mem_bytes: float) -> float:
        t_compute = instrs / (self.n_cores * self.freq_hz * self.ipc)
        if self.hyp:
            return instrs / (2 * self.n_cores * self.freq_hz * self.ipc)
        t_mem = mem_bytes / self.link_bw
        return max(t_compute, t_mem)

    def run(self, n_items: float, instrs: float, mem_bytes: float) -> RunResult:
        t = n_items * self.time_per_item(instrs, mem_bytes)
        cores = self.n_cores * (2 if self.hyp else 1)
        power = cores * self.core_power_w + (0 if self.hyp else self.dram_power_w)
        return RunResult(int(n_items), float(n_items), t, t * power)


# Per-application workload characterization (Table 4).  For each app:
# CRAM-PM per-item micro-op counts (logic, presets) and per-item NMP cost
# (instructions, memory bytes).  CRAM items map one-per-row; throughput
# follows from row-level parallelism over the arrays that hold the dataset.
@dataclasses.dataclass(frozen=True)
class AppModel:
    name: str
    n_items: float            # work items (patterns / vectors / words)
    item_bits: int            # payload bits per row
    cram_logic_ops: int       # per item (one row)
    cram_presets: int
    cram_rows_total: int      # rows across all arrays holding the dataset
    nmp_instrs: float         # per item
    nmp_bytes: float          # per item
    cram_array_rows: int = 512


def _popcount_ops(n_bits: int) -> Tuple[int, int]:
    """(logic, presets) of a reduction tree over n_bits (from the ISA)."""
    from .isa import CodeGen, ColumnAllocator
    cg = CodeGen(ColumnAllocator(0, 4096))
    cols = cg.scratch.alloc(n_bits)
    cg.popcount_tree(cols)
    gang, row = cg.prog.n_presets()
    return cg.prog.n_logic_ops(), gang + row


def _byte_match_ops(n_chars: int) -> Tuple[int, int]:
    """(logic, presets) for matching n 8-bit characters + popcount."""
    from .isa import CodeGen, ColumnAllocator
    cg = CodeGen(ColumnAllocator(0, 8192))
    match_bits = []
    for _ in range(n_chars):
        xors = []
        for _ in range(8):
            a, b = cg.scratch.alloc(2)
            xors.append(cg.xor(a, b))
        # OR-reduce the 8 bit-diffs, then INV -> char-match bit.
        while len(xors) > 1:
            a, b = xors.pop(), xors.pop()
            o = cg.scratch.alloc(1)[0]
            cg.gate("OR", (a, b), o)
            cg.scratch.release([a, b])
            xors.append(o)
        m = cg.scratch.alloc(1)[0]
        cg.gate("INV", (xors[0],), m)
        match_bits.append(m)
    cg.popcount_tree(match_bits)
    gang, row = cg.prog.n_presets()
    return cg.prog.n_logic_ops(), gang + row


def table4_apps() -> Dict[str, AppModel]:
    bc_logic, bc_presets = _popcount_ops(32)
    sm_logic, sm_presets = _byte_match_ops(10)
    wc_logic, wc_presets = _byte_match_ops(4)        # 32-bit word match
    # RC4: 248-bit keystream XOR per word-segment: 248 bit-XORs.
    from .isa import CodeGen, ColumnAllocator
    cg = CodeGen(ColumnAllocator(0, 2048))
    for _ in range(248):
        a, b = cg.scratch.alloc(2)
        x = cg.xor(a, b)
        cg.scratch.release([a, b, x])
    rc4_logic = cg.prog.n_logic_ops()
    rc4_presets = sum(cg.prog.n_presets())
    # NMP per-item costs (in-order A5, 1 IPC): BC uses a LUT popcount
    # (12 instr); SM compares 10 byte-chars (~60 instr); RC4's PRGA is
    # inherently serial (~15 instr/byte over 31 bytes); WC matches each text
    # word against ~100 search words (~30 instr each).  WC on CRAM-PM uses
    # the paper's data-replication trade-off (Sec. 2.6): each row holds one
    # (text word, search word) pair, so all search words match concurrently
    # -- this is what produces the paper's largest match-rate gain (133552x
    # long-term, Fig. 9).
    return {
        "BC": AppModel("BC", 1e6, 32, bc_logic, bc_presets,
                       cram_rows_total=int(1e6),
                       nmp_instrs=12, nmp_bytes=4),
        "SM": AppModel("SM", 10_396_542, 160, sm_logic, sm_presets,
                       cram_rows_total=10_396_542,
                       nmp_instrs=60, nmp_bytes=20),
        "RC4": AppModel("RC4", 10_396_542, 248, rc4_logic, rc4_presets,
                        cram_rows_total=10_396_542,
                        nmp_instrs=465, nmp_bytes=62, cram_array_rows=1024),
        "WC": AppModel("WC", 1_471_016, 32, wc_logic, wc_presets,
                       cram_rows_total=1_471_016 * 100,
                       nmp_instrs=3000, nmp_bytes=640),
    }


def app_cram_run(app: AppModel, tech: MTJTech, opt: bool = True) -> RunResult:
    """All items resident, one per row; every row computes in parallel.

    One program execution processes cram_rows_total items; with row-parallel
    lock-step execution the time is that of a single row's program.
    """
    design = Design(tech=tech, opt=opt, n_rows=app.cram_array_rows)
    e_gate = _gate_energy_table(tech)
    e_avg = sum(e_gate.values()) / len(e_gate)
    t_ops = app.cram_logic_ops * design.t_op_ns * 1e-9
    if opt:
        t_presets = app.cram_presets * design.t_op_ns * 1e-9
    else:
        t_presets = (app.cram_presets * app.cram_array_rows
                     * tech.write_latency_ns * SMC_WRITE_PIPELINE * 1e-9)
    t_total = t_ops + t_presets
    energy = (app.cram_logic_ops * e_avg + app.cram_presets
              * tech.write_energy_pj) * 1e-12 * app.cram_rows_total
    return RunResult(int(app.n_items), 1.0, t_total, energy)


def app_nmp_run(app: AppModel, hyp: bool = False) -> RunResult:
    nmp = NMPBaseline(hyp=hyp)
    return nmp.run(app.n_items, app.nmp_instrs, app.nmp_bytes)


def dna_nmp_run(design: Design, n_patterns: int, hyp: bool = False) -> RunResult:
    """NMP DNA model: stream-scan the reference per pattern."""
    nmp = NMPBaseline(hyp=hyp)
    instrs = design.ref_len * design.pattern_chars * 2.0  # cmp+acc per char
    mem_bytes = design.ref_len * design.pattern_chars / 4.0  # 2-bit chars
    return nmp.run(n_patterns, instrs, mem_bytes)


# ---------------------------------------------------------------------------
# Gate-level characterization (Fig. 11)
# ---------------------------------------------------------------------------

# Bulk-bitwise baseline constants, GOps/s on a 32MB vector.  The CRAM-PM
# paper reports *speedup ratios* against Ambit (MICRO'17) and Pinatubo
# (DAC'16) without disclosing the absolute baseline operating points, so the
# anchored constants below are DERIVED from the paper's near-term ratios
# (NOT: 178x, XOR: 1.34x, Pinatubo OR: ~6x) applied to our structural
# near-term model; Ambit OR/NAND (no ratio given) are set to NOT/2 following
# Ambit's triple-row-activation cost.  The benchmark reports both our model
# ratios and the paper's claimed ratios side by side.
AMBIT_GOPS = {"NOT": 255.0, "OR": 127.5, "NAND": 127.5, "XOR": 11292.0}
PINATUBO_OR_GOPS = 7565.7

# CRAM-PM per-bit micro-op cost (logic steps, gang presets) for bulk ops:
BULK_OP_STEPS = {"NOT": (1, 1), "OR": (1, 1), "NAND": (1, 1), "XOR": (3, 3)}


def bulk_gops(op: str, tech: MTJTech, vector_mb: int = 32,
              n_rows: int = 10_000, n_cols: int = 2_400) -> float:
    """CRAM-PM bulk bitwise throughput, data-resident (gang presets).

    The 32MB operand vectors live across as many 24Mb arrays as needed
    (3 cells per element: two operands + result); all arrays and all rows
    compute in parallel, one element column at a time (Sec. 2.4 semantics:
    "lack of actual data transfer within the array").
    """
    design = Design(tech=tech, opt=True, n_rows=n_rows, n_cols=n_cols)
    n_bits = vector_mb * 2**20 * 8
    cells = 3 * n_bits
    n_arrays = math.ceil(cells / (n_rows * n_cols))
    elems_per_step = n_rows * n_arrays
    logic, presets = BULK_OP_STEPS[op]
    t_elem = (logic + presets) * design.t_op_ns * 1e-9
    return elems_per_step / t_elem / 1e9
