"""Time the exact SWAR kernel's and the bank prefilter's design choices.

Run on one NVIDIA card from the root of the checkout::

    PYTHONPATH=src python -m repro_torch.kernels.match_swar_variants [--out F]

The exact SWAR kernel (``csrc/match_swar.cu``) has four design choices:
a register window (each thread loads the wp + 1 words its 16 alignments
share once, instead of two shared loads per word and alignment), word
pairs (one popcount counts two pattern words), the best reduction in the
kernel's epilogue (instead of the full (R, L) block, then
``argmax``/``amax``) and, for the full block, staged row-contiguous
stores (instead of each thread storing its 16 scores).  The bank
prefilter (``csrc/filter_qgram.cu``) has one: the lanes per pattern (1
is the thread-per-pattern design it replaced).  The variants live in a
library of their own, ``csrc/match_swar_variants.cu``
(``match_swar_exact_variant``, ``bank_prefilter_variant``), built from
the same templates as the shipped kernels; it also reports the shipped
design (``match_swar_variants_shipped``), which labels the rows.  The
best epilogue undone is the shipped STORE kernel followed by the
merger's ``argmax``/``amax``.

Shapes are the main path's, as ``chip_smoke.py`` drives it: query (a)'s
launch, taken from the planner (``engine.compile(query).plan``) on a
seeded random reference of GRCh38 chr1's length folded into 500-char
rows -- the first ``chunk_rows`` rows of the SWAR form against one
broadcast 100-char read -- and the standing bank's launch, 4,096
patterns against one batch of 256 seeded docs with 32 planted hits.
Each variant is checked against the plain version bit for bit (the SWAR
ones on the first 16,384 rows), then all are timed in turns, each
reading the mean device time of ``--reps`` launches with the L2
overwritten before each (``obs.device_time.device_ms``), over
``--rounds`` rounds.  ``--sass`` also prints static opcode counts of the
shipped exact kernels (BEST and STORE, patterns of 5-8 words), of BEST
with one popcount a word, and of the accept-set kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from ..obs.device_time import device_ms
from . import _build
from . import filter_qgram as kfq
from . import match_swar as ksw

L2_FLUSH_BYTES = 128 * 2**20  # the H100's L2 is 50 MB
SEED = 0
# Query (a)'s corpus and read, as chip_smoke.py builds them.
CHR1_BP, FRAG, READ = 248_956_422, 500, 100
CHECK_ROWS = 16_384
# The standing bank of chip_smoke.py phase 4b.
BANK_PATTERNS, BANK_DOCS, BANK_PLANTED = 4096, 256, 32
# Rows per block timed beside the shipped launch's pick (32 at (a)'s
# shape): 26 groups of 16 alignments per row are 3.25 items per thread
# at 32 rows, 6.5 at 64 and 13 at 128.
ROWS_PER_BLOCK = (64, 128)
BANK_LPG = (1, 4, 8, 16, 32)


def _lib():
    return _build.load("match_swar_variants")


def shipped() -> dict:
    """The shipped design, as the kernels' own constants give it:
    window, pair, stage (1 or 0) and the bank's lanes per pattern."""
    lib = _lib()
    flags = (ctypes.c_int * 4)()
    fn = lib.match_swar_variants_shipped
    fn.argtypes, fn.restype = [ctypes.c_void_p], None
    fn(ctypes.addressof(flags))
    return dict(zip(("window", "pair", "stage", "lpg"), flags))


def sass_kernels(ship: dict) -> dict:
    """{label: (library, mangled-name fragment)} for ``--sass``: the
    shipped exact kernels at WPT = 8 (patterns of 5-8 words), BEST with
    the pairs undone, and the accept-set kernel."""
    def frag(epi, pair):
        return (f"swar_exact_kernelILi8ELi{epi}ELb{ship['window']}"
                f"ELb{pair}ELb{ship['stage']}E")
    return {"BEST (shipped)": ("match_swar", frag(1, ship["pair"])),
            "STORE (shipped)": ("match_swar", frag(0, ship["pair"])),
            "BEST, pairs undone": ("match_swar_variants",
                                   frag(1, 1 - ship["pair"])),
            "accept-set": ("match_swar", "swar_masks_kernelILi8E")}


def exact_variant(ref, pat, valid, *, best: int, window: int, pair: int,
                  stage: int, n_locs: int, pattern_chars: int,
                  rows_per_block: int = 0):
    """One launch of ``match_swar_exact_variant``: the (R, L) block, or
    the (best_loc, best_score) pair when ``best``; ``rows_per_block`` 0
    picks the rows per block as the shipped launch does."""
    R = ref.shape[0]
    dev = ref.device
    if best:
        out = None
        loc, score = (torch.empty(R, dtype=torch.int32, device=dev)
                      for _ in range(2))
    else:
        out = torch.empty((R, n_locs), dtype=torch.int32, device=dev)
        loc = score = None
    lib = _lib()
    fn = lib.match_swar_exact_variant
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptr = [0 if t is None else t.data_ptr() for t in (out, loc, score)]
    err = fn(ref.data_ptr(), R, ref.shape[1], pat.data_ptr(), pat.stride(0),
             valid.data_ptr(), pat.shape[1], n_locs, pattern_chars, *ptr,
             best, window, pair, stage, rows_per_block,
             torch.cuda.current_stream().cuda_stream)
    _build.check(err, "match_swar_exact_variant", lib)
    return (loc, score) if best else out


def bank_variant(psigs, dsigs, slacks, lpg: int):
    """One launch of ``bank_prefilter_variant`` with ``lpg`` lanes per
    pattern."""
    out = torch.empty((psigs.shape[0], 1), dtype=torch.int32,
                      device=psigs.device)
    lib = _lib()
    fn = lib.bank_prefilter_variant
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(psigs.data_ptr(), psigs.shape[0], psigs.shape[1],
             dsigs.data_ptr(), dsigs.shape[0], slacks.data_ptr(),
             out.data_ptr(), lpg, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "bank_prefilter_variant", lib)
    return out


def sass_mix(kernels: dict) -> dict:
    """Static opcode counts (``cuobjdump -sass`` of the built libraries):
    {label: {opcode: count}} for the kernel whose mangled name holds each
    label's fragment, ``kernels`` as ``sass_kernels`` gives them."""
    exe = Path(_build.nvcc_path()).with_name("cuobjdump")
    mix = {}
    for lib in sorted({lib for lib, _ in kernels.values()}):
        text = subprocess.run(
            [str(exe), "-sass", str(_build.library_path(lib))],
            capture_output=True, text=True, check=True).stdout
        for chunk in text.split("Function : ")[1:]:
            name = chunk.split("\n", 1)[0]
            for label, (klib, frag) in kernels.items():
                if klib == lib and frag in name:
                    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+"
                                     r"(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
                                     chunk)
                    mix[label] = dict(Counter(ops).most_common())
    return mix


def variant_name(ship: dict, best: int, window: int, pair: int,
                 stage: int) -> str:
    flags = dict(window=window, pair=pair, stage=stage)
    is_shipped = all(flags[k] == ship[k] for k in flags
                     if best == 0 or k != "stage")
    return (f"{'BEST' if best else 'STORE'}: "
            f"{'register window' if window else '2 shared loads/word'}, "
            f"{'word pairs' if pair else '1 popcount/word'}"
            + ("" if best else
               f", {'staged rows' if stage else 'per-thread stores'}")
            + (" (shipped)" if is_shipped else ""))


def swar_operands(dev):
    """(a)'s launch as the engine makes it: the plan of an exact best
    query for one read of a chr1-sized seeded reference, the first
    ``chunk_rows`` rows of the SWAR form and the read broadcast to them.
    Returns (words, pattern, valid mask, plan)."""
    from repro_torch.core import encoding
    from repro_torch.match import MatchEngine, MatchQuery, PackedCorpus
    rng = np.random.default_rng(SEED)
    ref = encoding.random_dna(rng, CHR1_BP)
    corpus = PackedCorpus.from_reference(ref, FRAG, READ, device=dev)
    engine = MatchEngine(corpus, index=False)
    pos = int(rng.integers(0, CHR1_BP - READ))
    cm = engine.compile(MatchQuery.exact(ref[pos:pos + READ].copy(),
                                         reduction="best", backend="swar"))
    plan = cm.plan
    R = plan.chunk_rows
    words = corpus.swar_words(plan.need_words)[:R]
    pat_rows, valid = cm._packed
    return words, pat_rows[:1].expand(R, -1), valid, plan


def bank_operands(dev):
    """The standing bank's prefilter operands: chip_smoke.py's 4,096
    patterns (thresholds 100 and 99, 3:1) and one planted doc batch."""
    from repro_torch.core import encoding
    from repro_torch.match import PatternBank
    from repro_torch.match.index import signature_words
    rng = np.random.default_rng(SEED)
    ref = encoding.random_dna(rng, 4_000_000)
    starts = rng.integers(0, len(ref) - READ, BANK_PATTERNS)
    pats = np.stack([ref[s:s + READ] for s in starts])
    bank = PatternBank(FRAG, READ, device=dev)
    for i, p in enumerate(pats):
        bank.register(p, threshold=float(READ - 1 if i % 4 == 3 else READ))
    docs = rng.integers(0, 4, (BANK_DOCS, FRAG), np.uint8)
    for d, p, lo in zip(rng.choice(BANK_DOCS, BANK_PLANTED, replace=False),
                        rng.choice(BANK_PATTERNS, BANK_PLANTED,
                                   replace=False),
                        rng.integers(0, FRAG - READ + 1, BANK_PLANTED)):
        docs[d, lo:lo + READ] = pats[p]
    psigs, slacks = bank.filter_operands()
    dsigs, _ = signature_words(torch.from_numpy(docs).to(dev), bank.q,
                               bank.n_bits)
    return psigs, dsigs, slacks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--sass", action="store_true",
                    help="also print the SWAR kernels' static opcode counts")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("match_swar_variants: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    ship = shipped()
    ref, pat, valid, plan = swar_operands(dev)
    kw = dict(n_locs=plan.n_locs, pattern_chars=plan.pattern_chars)
    sub = (ref[:CHECK_ROWS], pat[:CHECK_ROWS], valid)
    want = ksw.match_swar_plain(*sub, **kw)
    want_best = (want.argmax(dim=1).to(torch.int32), want.amax(dim=1))
    fns = {}
    for best in (1, 0):
        for window in (1, 0):
            for pair in (1, 0):
                for stage in ((0,) if best else (1, 0)):
                    v = dict(best=best, window=window, pair=pair,
                             stage=stage)
                    got = exact_variant(*sub, **v, **kw)
                    same = (all(torch.equal(x, y)
                                for x, y in zip(got, want_best)) if best
                            else torch.equal(got, want))
                    if not same:
                        raise RuntimeError(f"{variant_name(ship, **v)}: "
                                           "differs from match_swar_plain")
                    fns[variant_name(ship, **v)] = (
                        lambda v=v: exact_variant(ref, pat, valid, **v, **kw))

    for best in (1, 0):
        for rpb in ROWS_PER_BLOCK:
            v = dict(best=best, stage=1 - best, rows_per_block=rpb,
                     **{k: ship[k] for k in ("window", "pair")})
            got = exact_variant(*sub, **v, **kw)
            if not (all(torch.equal(x, y) for x, y in zip(got, want_best))
                    if best else torch.equal(got, want)):
                raise RuntimeError(f"{rpb} rows per block: differs from "
                                   "match_swar_plain")
            name = (f"{'BEST' if best else 'STORE'}: shipped design, {rpb} "
                    "rows per block")
            fns[name] = (lambda v=v: exact_variant(ref, pat, valid, **v,
                                                   **kw))

    def store_then_reduce():
        scores = ksw.match_swar(ref, pat, valid, **kw)
        return scores.argmax(dim=1).to(torch.int32), scores.amax(dim=1)
    fns["BEST undone: shipped STORE + argmax/amax"] = store_then_reduce

    psigs, dsigs, slacks = bank_operands(dev)
    want = kfq.bank_prefilter_plain(psigs, dsigs, slacks)
    for lpg in BANK_LPG:
        if not torch.equal(bank_variant(psigs, dsigs, slacks, lpg), want):
            raise RuntimeError(f"bank_prefilter, {lpg} lanes per pattern: "
                               "differs from bank_prefilter_plain")
        name = (f"bank_prefilter: {lpg} lanes per pattern"
                + (" (shipped)" if lpg == ship["lpg"] else ""))
        fns[name] = (lambda lpg=lpg: bank_variant(psigs, dsigs, slacks, lpg))
    del want, want_best
    l2 = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)

    def flush():
        l2.zero_()
    readings = {k: [] for k in fns}
    for _ in range(args.rounds):
        for k, fn in fns.items():
            readings[k].append(device_ms(fn, args.reps, flush))
    rows = [{"name": k, "mean_ms": sum(r) / len(r), "min_ms": min(r),
             "max_ms": max(r), "profiler_ms": r} for k, r in readings.items()]
    result = {"card": smi, "shipped": ship,
              "swar_shape": [plan.chunk_rows, int(ref.shape[1]),
                             plan.pattern_chars, plan.n_locs],
              "bank_shape": [int(psigs.shape[0]), int(dsigs.shape[0]),
                             int(psigs.shape[1])],
              "reps": args.reps, "rounds": args.rounds, "rows": rows}
    if args.sass:
        result["sass"] = sass_mix(sass_kernels(ship))
        for label, ops in result["sass"].items():
            print(f"sass {label}: {ops}")
    for row in rows:
        print(f"{row['name']:72s} {row['mean_ms']:.4f} ms "
              f"[{row['min_ms']:.4f}-{row['max_ms']:.4f}]")
    print(f"(a)'s launch: {result['swar_shape']} (rows, words, pattern "
          f"chars, alignments); card: {smi}")
    text = json.dumps(result)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
