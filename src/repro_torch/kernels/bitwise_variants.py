"""Time the bulk XOR kernel's design choices against ``torch.bitwise_xor``.

Run on one NVIDIA card from the root of the checkout::

    PYTHONPATH=src python -m repro_torch.kernels.bitwise_variants [--out F]

Three choices bear on the XOR kernel's HBM rate: the grid (one wave of
resident blocks walking the operands, or one block per trip), the 16-byte
vectors each thread loads per operand per trip (1, 2 or 4) and streaming
hints (``__ldcs`` / ``__stcs``).  ``bitwise_xor_variant`` in
``csrc/bitwise.cu`` launches XOR with each of the twelve combinations;
``bitwise_launch`` uses ``SHIPPED``.  Each variant's output is checked
against ``torch.bitwise_xor`` first; then every variant and the library
call are timed in turns (library, every variant, library, ...), each
reading the mean device time of ``--reps`` launches, each launch after
the L2 is overwritten.  Two clocks: ``torch.profiler``'s kernel time
(``obs.device_time.device_ms``, which retakes a reading with device
events lost) and CUDA events around each single launch.  A reading
below the bytes bound is physically impossible and is reported as a
fault, not a time.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch

from ..obs.device_time import device_ms
from . import _build

XOR_BYTES = 256 * 2**20      # each operand, as chip_smoke.py's bulk XOR
L2_FLUSH_BYTES = 128 * 2**20  # the H100's L2 is 50 MB
HBM_BW = 3.35e12              # H100 SXM data sheet, bytes/s
# (vectors per thread, streaming hints, one-wave grid).
VARIANTS = [(v, h, w) for w in (1, 0) for h in (1, 0) for v in (4, 2, 1)]
SHIPPED = (1, 0, 0)                 # the design of bitwise_launch


def variant_name(vecs: int, hints: int, one_wave: int) -> str:
    return (f"{'one-wave grid' if one_wave else 'block per trip'}, "
            f"{vecs} x 16 B per thread, "
            f"{'__ldcs/__stcs' if hints else 'no hints'}"
            + (" (shipped)" if (vecs, hints, one_wave) == SHIPPED else ""))


def xor_variant(a: torch.Tensor, b: torch.Tensor, vecs: int, hints: int,
                one_wave: int) -> torch.Tensor:
    out = torch.empty_like(a)
    lib = _build.load("bitwise")
    fn = lib.bitwise_xor_variant
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(), vecs,
             hints, one_wave, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "bitwise_xor_variant", lib)
    return out


def event_ms(fn, reps: int, flush) -> float:
    """Mean ms of one launch between two CUDA events, L2 flushed before."""
    pairs = []
    for _ in range(reps):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bitwise_variants: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    a, b = (torch.randint(-2**31, 2**31, (XOR_BYTES // 4 // 256, 256),
                          dtype=torch.int32, device=dev, generator=gen)
            for _ in range(2))
    bound_ms = 3 * a.numel() * 4 / HBM_BW * 1e3
    want = torch.bitwise_xor(a, b)
    fns = {"torch.bitwise_xor": lambda: torch.bitwise_xor(a, b)}
    for v in VARIANTS:
        check = xor_variant(a, b, *v)
        if not torch.equal(check, want):
            raise RuntimeError(f"{variant_name(*v)}: differs from "
                               "torch.bitwise_xor")
        fns[variant_name(*v)] = (lambda v=v: xor_variant(a, b, *v))
    del check, want
    l2 = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)

    def flush():
        l2.zero_()
    readings = {k: {"profiler_ms": [], "event_ms": []} for k in fns}
    for _ in range(args.rounds):
        for k, fn in fns.items():
            r = readings[k]
            r["profiler_ms"].append(device_ms(fn, args.reps, flush))
            r["event_ms"].append(event_ms(fn, args.reps, flush))
    rows = []
    faults = []
    for k, r in readings.items():
        faults += [f"{k}: {ms} ms" for ms in r["profiler_ms"]
                   if ms < bound_ms]
        p = r["profiler_ms"]
        rows.append({"name": k, "mean_ms": sum(p) / len(p),
                     "min_ms": min(p), "max_ms": max(p), **r})
    result = {"card": smi, "shape": list(a.shape), "bound_ms": bound_ms,
              "reps": args.reps, "rounds": args.rounds, "faults": faults,
              "rows": rows}
    for row in rows:
        events = [round(e, 4) for e in row["event_ms"]]
        share = 100 * bound_ms / row["mean_ms"]
        print(f"{row['name']:60s} {row['mean_ms']:.4f} ms "
              f"[{row['min_ms']:.4f}-{row['max_ms']:.4f}]  events {events}"
              f"  ({share:.1f}% of bound)")
    print(f"card: {smi}; bound {bound_ms:.4f} ms (bytes); faults: {faults}")
    text = json.dumps(result)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
