"""Time the bulk popcount of two or more source trees in turns.

Run on one NVIDIA card from the root of the checkout::

    PYTHONPATH=src python -m repro_torch.kernels.popcount_turns \\
        --tree . --tree OTHER_CHECKOUT [--rounds 2] [--out F]

Each ``--tree`` is the root of a checkout of this repository.  In every
round each tree, in the order given, runs one child process with only
its own ``src`` on the path, so each side times its own ``ops.popcount``
and ``kernels.popcount``.  On seeded words of the shape of the chr1 SWAR
form (620,840 x 33, as ``chip_smoke.py``'s phase 4c counts) a child
checks both against the plain version, then reads:

* ``ops.popcount`` end to end: host clock around a call that ends in
  ``torch.cuda.synchronize()``, the least and the median of 20 calls
  after a warm-up;
* the device memory one call allocates (the peak above what was
  allocated before it, the (N,) result included);
* the device time of one call's kernels, and of ``kernels.popcount`` at
  the words padded to 256-row tiles and at four times as many rows
  (``obs.device_time.device_ms``, mean of 50), each launch after the L2
  is flushed.  Two flushes: a write of 128 MB (``chip_smoke.py``'s
  method), which leaves the L2 full of dirty lines that the timed kernel
  then writes back to HBM, and a read of the same 128 MB, which leaves
  it full of clean ones.

It prints each reading as it comes, the card's name and power limit,
and one JSON summary line; ``--out`` also writes the summary to a file.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROWS, WIDTH = 620_840, 33     # the SWAR form of GRCh38 chr1 (chip_smoke.py)
HOST_CALLS = 20
DEVICE_REPS = 50
L2_FLUSH_BYTES = 128 * 2**20  # the H100's L2 is 50 MB


def measure(seed: int = 0) -> dict:
    """One tree's readings (imports the ``repro_torch`` on ``sys.path``)."""
    import time

    import torch

    import repro_torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import popcount as kpc
    from repro_torch.obs.device_time import device_ms
    if not torch.cuda.is_available():
        raise RuntimeError("popcount_turns times the CUDA kernel and needs "
                           "an NVIDIA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    words = torch.randint(-2**31, 2**31, (ROWS, WIDTH), dtype=torch.int32,
                          device=dev, generator=gen)
    n_pad = -(-ROWS // kpc.N_TILE) * kpc.N_TILE
    padded = torch.zeros((n_pad, WIDTH), dtype=torch.int32, device=dev)
    padded[:ROWS] = words
    want = kpc.popcount_plain(words)[:, 0]
    if not (torch.equal(ops.popcount(words), want)
            and torch.equal(kpc.popcount(padded)[:ROWS, 0], want)):
        raise RuntimeError("popcount differs from its plain version")

    for _ in range(3):
        ops.popcount(words)
    torch.cuda.synchronize()
    host = []
    for _ in range(HOST_CALLS):
        t0 = time.perf_counter()
        ops.popcount(words)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    host.sort()

    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = ops.popcount(words)
    torch.cuda.synchronize()
    alloc = torch.cuda.max_memory_allocated() - before
    del out

    # The write flush is an add: a fill kernel would share its key with
    # the zero rows an op may allocate.  The read flush is a sum.
    l2 = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    flushes = {"": lambda: l2.add_(1), "_read_flush": lambda: l2.sum()}
    big = padded.repeat(4, 1)
    res = {"package": repro_torch.__file__, "rows": ROWS, "width": WIDTH,
           "ops_host_min_ms": host[0],
           "ops_host_median_ms": host[len(host) // 2],
           "ops_alloc_bytes": alloc, "padded_rows": n_pad}
    for tag, flush in flushes.items():
        res["ops_device_ms" + tag] = device_ms(lambda: ops.popcount(words),
                                               DEVICE_REPS, flush)
        res["popcount_padded_device_ms" + tag] = device_ms(
            lambda: kpc.popcount(padded), DEVICE_REPS, flush)
        res["popcount_4x_device_ms" + tag] = device_ms(
            lambda: kpc.popcount(big), DEVICE_REPS, flush)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="root of a checkout; give two or more")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", help="also write the summary JSON here")
    ap.add_argument("--measure", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.measure:
        print(json.dumps(measure()))
        return 0
    if not args.tree:
        ap.error("give at least one --tree")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    readings = {t: [] for t in args.tree}
    for rnd in range(args.rounds):
        for tree in args.tree:
            src = Path(tree).resolve() / "src"
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--measure"],
                env=dict(os.environ, PYTHONPATH=str(src)),
                capture_output=True, text=True, timeout=600)
            if proc.returncode:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return proc.returncode
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            readings[tree].append(res)
            print(f"round {rnd} {tree}: " + json.dumps(res), flush=True)
    summary = {"card": card, "readings": readings}
    if args.out:
        Path(args.out).write_text(json.dumps(summary, indent=1))
    print(card)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    # Run as a file (each tree's child), this directory heads sys.path;
    # the tree's package comes from PYTHONPATH alone.
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p != here]
    sys.exit(main())
