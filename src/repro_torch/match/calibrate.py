"""Measured cost-model calibration (port of ``repro.match.calibrate``).

The planner's static pricing is data-sheet roofline seconds plus an
assumed per-dispatch overhead (``core.tech.DISPATCH_OVERHEAD_S``).
``autotune()`` replaces both with measurements on the current device:
it times each kernel the planner prices, through the wrapper the engine
calls, at a grid of shapes, and fits per kernel the two-parameter curve

    measured = alpha * analytic + beta

where *analytic* is the planner's roofline estimate for the same shape
(``planner.analytic_*_seconds``).  ``alpha`` is the measured overhead
factor over the op/byte model; ``beta`` the measured per-dispatch
intercept (ctypes wrapper, launch, synchronize).  A curve over the
analytic model -- not a shape-indexed lookup -- prices unseen shapes
through the same arithmetic, and the positivity clamps keep the priced
seconds monotone in R, P and Q.

Timing is the host clock: the minimum of N readings, each a call that
ends in ``torch.cuda.synchronize()``, the first call discarded (it
builds the kernel library).  The readings are taken in N rounds over
the whole grid, so a slow spell of the host lands on one reading of
every point instead of on every reading of one kernel's points.  The
curve prices *wall* seconds, which is what the planner compares and
what ``FeedbackStore`` observes; CUDA events would leave out the launch
and wrapper cost that ``beta`` is there to capture.  Operands are
built once on the device from a seeded numpy generator, outside the
timed call.

The grid is the port's own: the JAX package's grid is sized for a TPU
and its interpret mode, and on an H100 every one of its shapes prices
under ~1 us analytic, so every sample would sit in the intercept.  Each
kernel here spans more than two decades of analytic seconds, up to the
main path's own launch.  ``bank_prefilter`` has a key of its own (the
JAX planner prices that kernel under ``filter``).

Fitted parameters are quantized to quarter-octave log2 bins (~+-9%), so
two back-to-back calibrations on a quiet card land on the same curves
and timing noise cannot flip near-tie plan decisions
(``decisions_stable``).

Tables persist as JSON keyed by (device kind, backend, interpret flag)
under ``<repo>/calibration/torch/`` (override with
``REPRO_TORCH_CALIBRATION_DIR``), in the JAX package's file-name scheme
and schema, so equal tables have equal digests in both packages.  The
``interpret`` flag means "the plain versions ran": it is true only on
the CPU, where every wrapper takes its plain version.
``load_cost_source()`` returns the matching ``CalibratedCostSource`` or
``None``, so callers degrade to the static source when no table fits.

    python -m repro_torch.match.calibrate [--fast] [--out DIR] [--no-save]
                                          [--check-stability]
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import os
import re
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import encoding
from repro_torch.core.tech import (H100, CalibratedCostSource, CostSource,
                                   GPURoofline, KernelCurve)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import filter_qgram as _fq
from repro_torch.kernels import match_mxu as _mxu
from repro_torch.kernels import match_swar as _swar
from repro_torch.kernels import ref as _kref
from repro_torch.launch import cluster as _cluster
from repro_torch.match.planner import (FilterContext, Planner,
                                       _mxu_geometry,
                                       _swar_geometry,
                                       analytic_bank_prefilter_seconds,
                                       analytic_filter_seconds,
                                       analytic_mxu_seconds,
                                       analytic_ref_seconds,
                                       analytic_swar_seconds)

TABLE_VERSION = 1
KERNELS = ("swar", "swar_masks", "mxu", "ref", "filter", "bank_prefilter")

# Measurement grid in the planner's own vocabulary: R rows, F fragment
# chars, P pattern chars, Q patterns; sig_words for the filter kernels,
# Q patterns x D docs for the bank prefilter.  Row counts respect the
# kernel tiles (swar: 8, filter: 128).  Each kernel spans > 2 decades of
# analytic seconds on the H100 roofline, and each grid holds the main
# path's launch: a SWAR chunk of query (a) (152,168 rows of 500 chars,
# 100-char reads), the planner's tensor-core chunk at Q = 128 (1,004
# rows), the corpus filter over chr1's 620,928 padded rows, the bank
# prefilter for 4,096 patterns x 256 docs.  For SWAR and the tensor
# cores that launch is the top point.  The two filter kernels' launches
# on the main path take less device time than the wrapper's ~25 us, so
# their grids go on to 4-16M rows and 16,384 patterns x 1-4K docs,
# where the kernel's time is several times the intercept and the slope
# can be read.  The ref backend is measured only where the planner could
# plausibly pick it (<= 1,024 rows).  Below ~128 rows the tensor-core
# launch sits on a floor (~100 us on an H100 at F = 500) that a line
# cannot follow, so most of its points, and most SWAR points, lie where
# the time scales with the rows: a grid with a point at F = 256 between
# floor points fitted an alpha that crossed a quantization bin from one
# autotune to the next.
FULL_GRID: Dict[str, List[dict]] = {
    "swar": [
        dict(R=1024, F=500, P=100),
        dict(R=8192, F=500, P=100),
        dict(R=32768, F=256, P=32),
        dict(R=32768, F=500, P=100),
        dict(R=65536, F=500, P=100),
        dict(R=98304, F=500, P=100),
        dict(R=152168, F=500, P=100),
    ],
    "swar_masks": [
        dict(R=1024, F=500, P=100),
        dict(R=8192, F=500, P=100),
        dict(R=32768, F=256, P=32),
        dict(R=152168, F=500, P=100),
    ],
    "mxu": [dict(R=r, F=500, P=100, Q=128)
            for r in (8, 32, 128, 256, 512, 1004)],
    "ref": [
        dict(R=64, F=128, P=16),
        dict(R=256, F=256, P=32),
        dict(R=1024, F=500, P=100),
    ],
    "filter": [dict(R=r, sig_words=8)
               for r in (4096, 131072, 620928, 4194304, 16777216)],
    "bank_prefilter": [
        dict(Q=256, D=16, sig_words=8),
        dict(Q=4096, D=256, sig_words=8),
        dict(Q=16384, D=1024, sig_words=8),
        dict(Q=16384, D=4096, sig_words=8),
    ],
}

# Reduced grid: 2-3 shapes per kernel, the top shape and the main path's
# launch kept.
FAST_GRID: Dict[str, List[dict]] = {
    "swar": [dict(R=1024, F=500, P=100), dict(R=32768, F=256, P=32),
             dict(R=152168, F=500, P=100)],
    "swar_masks": [dict(R=1024, F=500, P=100),
                   dict(R=152168, F=500, P=100)],
    "mxu": [dict(R=r, F=500, P=100, Q=128) for r in (8, 256, 1004)],
    "ref": [dict(R=64, F=128, P=16), dict(R=1024, F=500, P=100)],
    "filter": [dict(R=r, sig_words=8) for r in (4096, 620928, 16777216)],
    "bank_prefilter": [dict(Q=256, D=16, sig_words=8),
                       dict(Q=4096, D=256, sig_words=8),
                       dict(Q=16384, D=4096, sig_words=8)],
}

# The fused kernels the engine launches for best / top-k reductions (the
# reduction in the kernel's epilogue), with the key the planner prices
# them under.  ``measure`` times them beside the STORE launch of that
# key; they are not fitted into the table.
FUSED = {"swar_best": "swar", "mxu_best": "mxu"}

# Golden shape matrix for decision-stability and persistence round-trip
# checks: the JAX package's eight shapes (tiny shapes, batched Q,
# accept-set predicates, plain scans), then the shapes users meet on
# the card: a chr1-sized corpus (620,839 rows of 500 chars) read by
# 100-char reads, exact at Q = 1, 32 and 128 and accept-set at Q = 1
# and 16.
GOLDEN_SHAPES: Tuple[dict, ...] = (
    dict(n_rows=2, fragment_chars=20, pattern_chars=8),
    dict(n_rows=64, fragment_chars=128, pattern_chars=16),
    dict(n_rows=512, fragment_chars=1024, pattern_chars=100),
    dict(n_rows=512, fragment_chars=1024, pattern_chars=100, n_patterns=128),
    dict(n_rows=4096, fragment_chars=256, pattern_chars=32, n_patterns=64),
    dict(n_rows=16384, fragment_chars=256, pattern_chars=32),
    dict(n_rows=1024, fragment_chars=256, pattern_chars=48,
         predicate="accept"),
    dict(n_rows=2048, fragment_chars=512, pattern_chars=64, n_patterns=256),
    dict(n_rows=620839, fragment_chars=500, pattern_chars=100),
    dict(n_rows=620839, fragment_chars=500, pattern_chars=100,
         n_patterns=32),
    dict(n_rows=620839, fragment_chars=500, pattern_chars=100,
         n_patterns=128),
    dict(n_rows=620839, fragment_chars=500, pattern_chars=100,
         predicate="accept"),
    dict(n_rows=620839, fragment_chars=500, pattern_chars=100,
         n_patterns=16, predicate="accept"),
)

# Filter-then-verify shapes (``plan`` with a ``FilterContext``; the
# decision is backend and strategy): query (e) on the chr1-sized corpus
# at the planner's survivor estimate (1e-4) and at the fraction the card
# measured (10.3%), and an accept-set group of 16.  Standing-bank shapes
# (``plan_bank``; the decision is the strategy): the 4,096-pattern bank
# against a 256-doc batch at its estimated survivor fraction, and at
# half the bank surviving.  Their prices read the ``filter`` and
# ``bank_prefilter`` curves, which the matrix above never does.
GOLDEN_FILTER_SHAPES: Tuple[dict, ...] = (
    dict(n_rows=620839, fragment_chars=500, pattern_chars=100, sig_words=8,
         survivor_frac=1e-4),
    dict(n_rows=620839, fragment_chars=500, pattern_chars=100, sig_words=8,
         survivor_frac=0.103),
    dict(n_rows=620839, fragment_chars=500, pattern_chars=100, sig_words=8,
         survivor_frac=0.01, n_patterns=16, predicate="accept"),
)
GOLDEN_BANK_SHAPES: Tuple[dict, ...] = (
    dict(n_docs=256, fragment_chars=500, pattern_chars=100, n_patterns=4096,
         sig_words=8, survivor_frac=0.0263),
    dict(n_docs=256, fragment_chars=500, pattern_chars=100, n_patterns=4096,
         sig_words=8, survivor_frac=0.5),
)

# A plan flip between two calibration runs is tolerated only when it is
# cost-neutral: the two choices price within this factor of each other
# under either table.  Two curves can each land one quarter-octave bin
# apart between runs (2^0.25 each, ~1.41 combined); the bound sits just
# under that, so it tolerates quantization-edge flips and fails real ones.
STABILITY_COST_TOL = 1.35

SEED = 0xC0FFEE


# -- substrate identity -------------------------------------------------------

def device_kind(device: DeviceLike = None) -> str:
    """The card's name (``torch.cuda.get_device_name``), or ``"cpu"``."""
    dev = resolve_device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def backend_name(device: DeviceLike = None) -> str:
    """``"cuda"`` or ``"cpu"``."""
    return resolve_device(device).type


def default_interpret(device: DeviceLike = None) -> bool:
    """True where every wrapper takes its plain version: the CPU."""
    return resolve_device(device).type == "cpu"


def _slug(s: str) -> str:
    return re.sub(r"[^a-z0-9]+", "-", s.lower()).strip("-") or "unknown"


def table_filename(dev_kind: str, backend: str, interpret: bool) -> str:
    mode = "interp" if interpret else "compiled"
    return f"{_slug(dev_kind)}--{_slug(backend)}--{mode}.json"


def calibration_dir() -> Path:
    """``REPRO_TORCH_CALIBRATION_DIR`` or ``<repo>/calibration/torch``."""
    env = os.environ.get("REPRO_TORCH_CALIBRATION_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "calibration" / "torch"


# -- measurement --------------------------------------------------------------

def _time_rounds(fns: Sequence[Callable[[], object]], repeats: int,
                 sync: Callable[[], None]) -> List[float]:
    """Min-of-N host-clock seconds of each of ``fns`` to ``sync``.

    The N readings are taken in N rounds, each of which times every call
    once, so a slow spell of the shared host raises one reading of every
    point rather than all readings of the few points timed during it
    (which tilts a curve).  The first call of each is discarded (it
    builds and loads the kernel library).
    """
    for fn in fns:
        fn()
    sync()
    best = [math.inf] * len(fns)
    for _ in range(max(1, repeats)):
        for i, fn in enumerate(fns):
            t0 = time.perf_counter()
            fn()
            sync()
            best[i] = min(best[i], time.perf_counter() - t0)
    return best


def _words(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """uint32 host words -> int32 device tensor carrying the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(
        np.int32)).to(dev)


def _build_call(kernel: str, shape: Mapping, dev: torch.device,
                roofline: GPURoofline = H100):
    """(callable, analytic_s) for one (kernel, shape) point: the launch
    the engine makes for a plan priced under ``kernel``, on operands
    built once on ``dev``; the analytic seconds are the planner's, on
    ``roofline``."""
    rng = np.random.default_rng(SEED)

    def u32(*s):
        return rng.integers(0, 2**32, s, dtype=np.uint32)

    if kernel == "bank_prefilter":
        Q, D, wb = int(shape["Q"]), int(shape["D"]), int(shape["sig_words"])
        # Sparse pattern signatures against dense doc signatures, as a
        # bank's 100-char patterns meet 500-char docs; slack 4 passes no
        # pair, so every (pattern, doc) pair is tested (the analytic
        # model's no-early-exit count).
        pats = _words(u32(Q, wb) & u32(Q, wb), dev)
        docs = _words(u32(D, wb) | u32(D, wb), dev)
        slacks = torch.full((Q, 1), 4, dtype=torch.int32, device=dev)
        analytic = analytic_bank_prefilter_seconds(roofline, Q, wb, D)
        return (lambda: _fq.bank_prefilter(pats, docs, slacks)), analytic

    R = int(shape["R"])
    if kernel == "filter":
        wb = int(shape["sig_words"])
        rows, qsig = _words(u32(R, wb), dev), _words(u32(1, wb), dev)
        analytic = analytic_filter_seconds(roofline, R, wb, 1)
        return (lambda: _fq.filter_qgram(rows, qsig, slack=4)), analytic

    F, P = int(shape["F"]), int(shape["P"])
    L = F - P + 1
    if kernel == "ref":
        frags = torch.from_numpy(
            rng.integers(0, 4, (R, F), dtype=np.uint8)).to(dev)
        pat = torch.from_numpy(rng.integers(0, 4, (P,), dtype=np.uint8)).to(
            dev)
        analytic = analytic_ref_seconds(roofline, R, L, P, 1)
        return (lambda: _kref.match_scores_ref(frags, pat)), analytic

    if kernel in ("mxu", "mxu_best"):
        Q = int(shape.get("Q", 128))
        l_pad, p_chars, q_pad, f_chars = _mxu_geometry(P, L, Q)
        ref_flat = torch.from_numpy(rng.integers(
            0, 2, (R, f_chars * 4)).astype(np.float32)).to(dev,
                                                           torch.bfloat16)
        pat = rng.integers(0, 2, (p_chars * 4, q_pad)).astype(np.float32)
        pat[4 * P:] = 0                   # the engine's zero pattern pad
        pat_mat = torch.from_numpy(pat).to(dev, torch.bfloat16)
        analytic = analytic_mxu_seconds(roofline, R, L, P, Q)
        if kernel == "mxu_best":
            return (lambda: _mxu.match_mxu_best(
                ref_flat, pat_mat, n_locs=L, n_k=4 * P)), analytic
        return (lambda: _mxu.match_mxu(ref_flat, pat_mat, l_pad=l_pad)), \
            analytic

    # swar / swar_masks / swar_best: a shared pattern rides a row-broadcast
    # view, as the engine launches a single query.
    wp, need = _swar_geometry(P, L)
    words = _words(u32(R, need), dev)
    mask_codes = np.zeros(wp * 16, np.uint32)
    mask_codes[:P] = 1
    valid = _words(encoding.pack_codes_u32(mask_codes[None, :]), dev)
    if kernel == "swar_masks":
        planes = _words(u32(1, 4 * wp), dev).expand(R, -1)
        analytic = analytic_swar_seconds(roofline, R, L, P, 1, "accept")
        return (lambda: _swar.match_swar_masks(
            words, planes, valid, n_locs=L, pattern_chars=P)), analytic
    pats = _words(u32(1, wp), dev).expand(R, -1)
    analytic = analytic_swar_seconds(roofline, R, L, P, 1, "exact")
    if kernel == "swar_best":
        return (lambda: _swar.match_swar_best(
            words, pats, valid, n_locs=L, pattern_chars=P)), analytic
    return (lambda: _swar.match_swar(
        words, pats, valid, n_locs=L, pattern_chars=P)), analytic


def _sync_for(dev: torch.device) -> Callable[[], None]:
    if dev.type == "cuda":
        return lambda: torch.cuda.synchronize(dev)
    return lambda: None


def measure(kernel: str, shape: Mapping, *, device: DeviceLike = None,
            repeats: int = 3,
            roofline: GPURoofline = H100) -> Tuple[float, float]:
    """(analytic_s, measured_s) for one kernel (a key of ``KERNELS`` or
    ``FUSED``) at one shape, the analytic seconds on ``roofline``."""
    dev = resolve_device(device)
    fn, analytic = _build_call(kernel, shape, dev, roofline)
    return analytic, _time_rounds([fn], repeats, _sync_for(dev))[0]


# -- fitting ------------------------------------------------------------------

def quantize_q2(v: float) -> float:
    """Snap ``v`` to the nearest quarter-octave log2 bin (~+-9%).

    Two calibration runs whose raw fits differ by timing noise land in
    the same bin, so the decisions they imply are bit-identical; 0 stays
    0 (a zero intercept is a legitimate fit outcome).
    """
    if v <= 0.0:
        return 0.0
    return float(2.0 ** (round(math.log2(v) * 4.0) / 4.0))


def fit_curve(analytic: Sequence[float],
              measured: Sequence[float]) -> KernelCurve:
    """Fit measured = alpha*analytic + beta, alpha > 0, beta >= 0.

    Weighted least squares with 1/y^2 weights (minimizes *relative*
    error: a 100us shape matters as much as a 100ms one).  Three
    constrained candidates are fitted and the lowest-residual one wins:

    * the unconstrained 2-parameter fit, admitted only when it already
      satisfies alpha > 0, beta >= 0;
    * through-origin (beta = 0): right when the data is slope-dominated
      and noise pushed the free intercept negative;
    * constant-dominated (beta = weighted mean, alpha = median residual
      slope): right when the grid's slope signal drowns in the fixed
      per-call cost, where a through-origin fit would underprice small
      shapes and flip decisions between back-to-back runs on fit noise.

    Picking by residual is deterministic in the samples, and both
    parameters are quarter-octave quantized, so quiet-machine reruns
    land on identical curves.
    """
    x = np.asarray(analytic, np.float64)
    y = np.asarray(measured, np.float64)
    if x.size == 0:
        raise ValueError("cannot fit a curve to zero samples")
    w = 1.0 / np.maximum(y, 1e-12) ** 2
    sxx, sx, s1 = (w * x * x).sum(), (w * x).sum(), w.sum()
    sxy, sy = (w * x * y).sum(), (w * y).sum()
    det = sxx * s1 - sx * sx

    def rel_err_of(a: float, b: float) -> float:
        pred = a * x + b
        return float(np.max(np.abs(pred - y) / np.maximum(y, 1e-12)))

    candidates = []
    if x.size >= 2 and det > 0:
        a2 = (sxy * s1 - sx * sy) / det
        b2 = (sxx * sy - sx * sxy) / det
        if a2 > 0.0 and b2 >= 0.0:
            candidates.append((a2, b2))
    a1 = sxy / max(sxx, 1e-300)           # x, y > 0, so a1 > 0 always
    candidates.append((a1, 0.0))
    bc = sy / s1
    resid = np.maximum(y - bc, 0.0) / np.maximum(x, 1e-300)
    ac = float(np.median(resid))
    if ac <= 0.0:
        # Flat data: keep a vanishing slope so pricing still grows
        # (slowly) past the grid instead of treating all shapes as free.
        ac = bc / (100.0 * float(x.max()))
    candidates.append((ac, bc))
    alpha, beta = min(candidates, key=lambda ab: rel_err_of(*ab))
    alpha, beta = quantize_q2(alpha), quantize_q2(beta)
    return KernelCurve(alpha=alpha, beta=beta, n_samples=int(x.size),
                       rel_err=round(rel_err_of(alpha, beta), 4))


# -- the table ----------------------------------------------------------------

@dataclasses.dataclass
class CalibrationTable:
    """Fitted per-kernel cost curves for one (device, backend, mode)."""

    device_kind: str
    backend: str
    interpret: bool
    curves: Dict[str, KernelCurve]
    samples: Dict[str, List[dict]] = dataclasses.field(default_factory=dict)
    meta: Dict = dataclasses.field(default_factory=dict)

    def _canonical(self) -> str:
        body = {
            "version": TABLE_VERSION,
            "device_kind": self.device_kind,
            "backend": self.backend,
            "interpret": self.interpret,
            "curves": {k: dataclasses.asdict(c)
                       for k, c in sorted(self.curves.items())},
        }
        return json.dumps(body, sort_keys=True, separators=(",", ":"))

    @property
    def digest(self) -> str:
        """Content digest of the decision-relevant fields (stable key)."""
        return hashlib.blake2b(self._canonical().encode(),
                               digest_size=16).hexdigest()

    def cost_source(self) -> CalibratedCostSource:
        return CalibratedCostSource(
            self.curves, digest=self.digest,
            meta={"device_kind": self.device_kind, "backend": self.backend,
                  "interpret": self.interpret})

    # -- persistence ----------------------------------------------------------
    def to_json(self) -> dict:
        return {
            "version": TABLE_VERSION,
            "device_kind": self.device_kind,
            "backend": self.backend,
            "interpret": self.interpret,
            "digest": self.digest,
            "curves": {k: dataclasses.asdict(c)
                       for k, c in sorted(self.curves.items())},
            "samples": self.samples,
            "meta": self.meta,
        }

    @classmethod
    def from_json(cls, doc: Mapping) -> "CalibrationTable":
        if doc.get("version") != TABLE_VERSION:
            raise ValueError(f"calibration table version "
                             f"{doc.get('version')!r} != {TABLE_VERSION}")
        curves = {k: KernelCurve(**c) for k, c in doc["curves"].items()}
        table = cls(device_kind=doc["device_kind"], backend=doc["backend"],
                    interpret=bool(doc["interpret"]), curves=curves,
                    samples=dict(doc.get("samples", {})),
                    meta=dict(doc.get("meta", {})))
        stored = doc.get("digest")
        if stored and stored != table.digest:
            raise ValueError("calibration table digest mismatch: file "
                             "edited or truncated; re-run autotune")
        return table

    def path(self, directory: Optional[Path] = None) -> Path:
        d = Path(directory) if directory is not None else calibration_dir()
        return d / table_filename(self.device_kind, self.backend,
                                  self.interpret)

    def save(self, directory: Optional[Path] = None) -> Path:
        p = self.path(directory)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.to_json(), indent=2, sort_keys=True)
                     + "\n")
        return p

    @classmethod
    def load(cls, dev_kind: Optional[str] = None,
             backend: Optional[str] = None,
             interpret: Optional[bool] = None,
             directory: Optional[Path] = None, *,
             device: DeviceLike = None) -> "CalibrationTable":
        """The table for (dev_kind, backend, interpret); a field left out
        is read off ``device`` (``None``: the card)."""
        dev_kind = dev_kind if dev_kind is not None else device_kind(device)
        backend = backend if backend is not None else backend_name(device)
        interpret = (interpret if interpret is not None
                     else default_interpret(device))
        d = Path(directory) if directory is not None else calibration_dir()
        p = d / table_filename(dev_kind, backend, interpret)
        return cls.from_json(json.loads(p.read_text()))


def load_cost_source(dev_kind: Optional[str] = None,
                     backend: Optional[str] = None,
                     interpret: Optional[bool] = None,
                     directory: Optional[Path] = None, *,
                     device: DeviceLike = None
                     ) -> Optional[CalibratedCostSource]:
    """The persisted source for this substrate, or None (static fallback).

    "Calibrate once, then serve": construct the engine with
    ``cost_source=load_cost_source()`` -- a missing, unreadable, edited
    or wrong-substrate table degrades to the static source instead of
    failing.
    """
    try:
        return CalibrationTable.load(dev_kind, backend, interpret,
                                     directory, device=device).cost_source()
    except (OSError, ValueError, KeyError, json.JSONDecodeError):
        return None


def _power_limit_w(dev: torch.device) -> Optional[float]:
    """This card's power limit in watts from ``nvidia-smi``, asked for by
    the card's UUID, which names the same card whatever
    ``CUDA_VISIBLE_DEVICES`` renumbers (None on the CPU, or when the tool
    does not answer)."""
    if dev.type != "cuda":
        return None
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    uuid = str(torch.cuda.get_device_properties(idx).uuid)
    if not uuid.startswith("GPU-"):
        uuid = "GPU-" + uuid
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", uuid, "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return None


def bench_provenance(cost_source: Optional[CostSource] = None, *,
                     device: DeviceLike = None) -> dict:
    """Provenance block for a measurement artifact.

    ``calibration`` is the cost-source tag that priced the run's planner
    decisions ("static" when no source was loaded); ``n_processes`` /
    ``n_hosts`` the controller topology, read off the process group when
    one is initialised (a multi-process artifact measured collective
    merges, a one-process one did not; the host names are those
    ``launch.cluster.initialize`` gathered, ``None`` for a group it did
    not make);
    ``power_limit_w`` the card's power limit, since a card set below its
    maximum runs slower under load.
    """
    dev = resolve_device(device)
    return {
        "device_kind": device_kind(dev),
        "backend": backend_name(dev),
        "calibration": cost_source.tag if cost_source is not None
        else "static",
        "n_processes": _cluster.process_count(),
        "n_hosts": _cluster.host_count(),
        "power_limit_w": _power_limit_w(dev),
    }


# -- autotune -----------------------------------------------------------------

def autotune(*, fast: bool = False, device: DeviceLike = None,
             repeats: Optional[int] = None,
             roofline: GPURoofline = H100,
             kernels: Sequence[str] = KERNELS,
             verbose: bool = False) -> CalibrationTable:
    """Measure the grid of ``kernels`` (keys of ``KERNELS``; another key
    raises ``KeyError``), fit their curves over the analytic seconds on
    ``roofline``, return the table."""
    dev = resolve_device(device)
    # Min of 30 readings a point: with 10, back-to-back autotunes on an
    # H100 moved the swar and mxu slopes across quantization bins.
    repeats = (10 if fast else 30) if repeats is None else repeats
    grid = FAST_GRID if fast else FULL_GRID
    curves: Dict[str, KernelCurve] = {}
    samples: Dict[str, List[dict]] = {}
    calls = [_build_call(kernel, shape, dev, roofline)
             for kernel in kernels for shape in grid[kernel]]
    measured = _time_rounds([fn for fn, _ in calls], repeats, _sync_for(dev))
    points = iter(zip(calls, measured))
    for kernel in kernels:
        xs, ys, rows = [], [], []
        for shape in grid[kernel]:
            (_, analytic), m = next(points)
            xs.append(analytic)
            ys.append(m)
            rows.append({**shape, "analytic_s": analytic,
                         "measured_s": round(m, 9)})
            if verbose:
                print(f"  {kernel} {shape}: analytic {analytic:.3g}s "
                      f"measured {m:.3g}s "
                      f"(x{m / max(analytic, 1e-300):.3g})", flush=True)
        curves[kernel] = fit_curve(xs, ys)
        samples[kernel] = rows
    return CalibrationTable(
        device_kind=device_kind(dev), backend=backend_name(dev),
        interpret=default_interpret(dev), curves=curves, samples=samples,
        meta={"grid": "fast" if fast else "full", "repeats": repeats,
              "roofline": roofline.name})


# -- decision stability -------------------------------------------------------

def _shape_key(shape: Mapping) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(shape.items()))


def _filter_split(shape: Mapping) -> Tuple[dict, FilterContext]:
    kw = {k: v for k, v in shape.items()
          if k not in ("sig_words", "survivor_frac")}
    return kw, FilterContext(sig_words=shape["sig_words"],
                             n_queries=shape.get("n_patterns", 1),
                             prunable=True,
                             survivor_frac=shape["survivor_frac"])


def _golden(planner: Planner) -> List[Tuple[str, str, Callable]]:
    """(shape-key, choice, price) over the golden matrix: ``price(c)`` is
    what ``planner`` charges for choice ``c`` at that shape."""
    out = []
    for shape in GOLDEN_SHAPES:
        plan = planner.plan(**shape)
        out.append((_shape_key(shape), plan.backend,
                    lambda b, shape=shape: planner.plan(
                        **shape, backend=b).est_seconds))
    for shape in GOLDEN_FILTER_SHAPES:
        kw, ctx = _filter_split(shape)
        plan = planner.plan(**kw, filter_ctx=ctx)

        def price(choice, kw=kw, ctx=ctx):
            backend, strategy = choice.split("/")
            forced = (dataclasses.replace(ctx, force=True)
                      if strategy == "filter" else None)
            return planner.plan(**kw, backend=backend,
                                filter_ctx=forced).est_seconds
        out.append(("filter:" + _shape_key(shape),
                    f"{plan.backend}/{plan.strategy}", price))
    for shape in GOLDEN_BANK_SHAPES:
        out.append(("bank:" + _shape_key(shape),
                    planner.plan_bank(**shape).strategy,
                    lambda s, shape=shape: planner.plan_bank(
                        **shape, force=s == "filter").est_seconds))
    return out


def golden_decisions(source: CostSource) -> List[Tuple[str, str]]:
    """(shape-key, choice) over the golden matrix for one source: the
    backend at a scan shape, backend/strategy at a filter-then-verify
    shape, the strategy at a bank shape."""
    return [(key, choice)
            for key, choice, _ in _golden(Planner(cost_source=source))]


def decisions_stable(src_a: CostSource, src_b: CostSource,
                     tol: float = STABILITY_COST_TOL
                     ) -> Tuple[bool, List[dict]]:
    """Compare plan decisions of two sources over the golden matrix.

    A differing choice is tolerated only when it is cost-neutral: each
    source prices the other's pick within ``tol`` of its own.  Returns
    (all_stable, per-shape report rows).
    """
    ga = _golden(Planner(cost_source=src_a))
    gb = _golden(Planner(cost_source=src_b))
    rows, ok = [], True
    for (key, choice_a, price_a), (_, choice_b, price_b) in zip(ga, gb):
        stable = choice_a == choice_b
        neutral = (not stable
                   and price_a(choice_b) <= tol * price_a(choice_a)
                   and price_b(choice_a) <= tol * price_b(choice_b))
        rows.append({"shape": key, "choice_a": choice_a,
                     "choice_b": choice_b, "stable": stable,
                     "cost_neutral": neutral})
        ok = ok and (stable or neutral)
    return ok, rows


# -- CLI ----------------------------------------------------------------------

def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Time the match kernels on the card and fit the "
                    "calibrated cost table for it.")
    ap.add_argument("--fast", action="store_true",
                    help="reduced grid + fewer repeats")
    ap.add_argument("--out", type=Path, default=None,
                    help="directory to write the table (default: "
                         "REPRO_TORCH_CALIBRATION_DIR or "
                         "<repo>/calibration/torch)")
    ap.add_argument("--no-save", action="store_true",
                    help="fit and report only")
    ap.add_argument("--check-stability", type=int, nargs="?", const=1,
                    default=0, metavar="N",
                    help="run N more autotunes (default 1) and require "
                         "each to make the first's golden-matrix "
                         "decisions (or cost-neutral ones)")
    args = ap.parse_args(argv)

    table = autotune(fast=args.fast, verbose=True)
    for kernel in sorted(table.curves):
        c = table.curves[kernel]
        print(f"CALIB kernel={kernel} alpha={c.alpha:.6g} "
              f"beta={c.beta:.6g} rel_err={c.rel_err:.3g} "
              f"n={c.n_samples}")
    print(f"CALIB table device_kind={table.device_kind!r} "
          f"backend={table.backend} interpret={table.interpret} "
          f"digest={table.digest[:8]}")
    if not args.no_save:
        path = table.save(args.out)
        print(f"CALIB saved {path}")

    n_failed = 0
    for run in range(1, args.check_stability + 1):
        table2 = autotune(fast=args.fast)
        ok, rows = decisions_stable(table.cost_source(),
                                    table2.cost_source())
        for r in rows:
            if args.check_stability == 1 or not r["stable"]:
                print(f"CALIB stability shape[{r['shape']}] "
                      f"a={r['choice_a']} b={r['choice_b']} "
                      f"stable={r['stable']} neutral={r['cost_neutral']}")
        print(f"CALIB stability run {run}: digest {table2.digest[:8]}, "
              f"{'OK' if ok else 'FAILED'}; curves " + json.dumps(
                  {k: [c.alpha, c.beta] for k, c in
                   sorted(table2.curves.items())}))
        n_failed += not ok
    if n_failed:
        print(f"CALIB stability FAILED: decisions flipped in {n_failed} "
              f"of {args.check_stability} runs against the first")
        return 1
    if args.check_stability:
        print("CALIB stability OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
