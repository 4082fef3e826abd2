"""Quickstart on the PyTorch/CUDA port: CRAM-PM in five minutes.

1. Gates emerge from device physics (V_gate windows).
2. A micro-program runs row-parallel on the array interpreter (the
   ``cram_execute`` CUDA kernel on the card).
3. Algorithm 1 (match + score) on the functional array.
4. The same search through the match engine (planner-selected kernel,
   device-resident packed corpus).

The twin of ``quickstart.py``: the same seeds, sizes, printed lines and
asserts, on ``repro_torch``.  It runs on the card; ``main(device="cpu")``
runs every kernel's plain PyTorch version on the CPU instead.

Run:  PYTHONPATH=src python examples/quickstart_torch.py
"""

import numpy as np

from repro_torch.core import encoding, gates, matcher
from repro_torch.core.array import CRAMArray, MicroOp, Program
from repro_torch.core.tech import NEAR_TERM
from repro_torch.device import resolve_device
from repro_torch.match import MatchEngine


def main(device=None) -> None:
    dev = resolve_device(device)
    print("== 1. gates from device physics ==")
    for g in ("NOR", "MAJ3", "TH"):
        lo, hi = gates.vgate_window(g, NEAR_TERM)
        print(f"  {g:4s}: V_gate in ({lo:.3f}, {hi:.3f}) V")

    print("\n== 2. row-parallel micro-program ==")
    arr = CRAMArray(n_rows=4, n_cols=16, device=dev)
    arr.write_column_rows(0, np.array(
        [[0, 0], [0, 1], [1, 0], [1, 1]], np.uint8))
    arr.run(Program([MicroOp("PRESET0", (), 8), MicroOp("NOR", (0, 1), 8)]))
    print("  NOR of columns 0,1 across all rows:",
          arr.state[:, 8].cpu().numpy())

    print("\n== 3. Algorithm 1 on the array ==")
    rng = np.random.default_rng(0)
    frags = rng.integers(0, 4, (6, 48), np.uint8)
    pattern = rng.integers(0, 4, 12, np.uint8)
    frags[4, 20:32] = pattern                     # plant a perfect hit
    m = matcher.Matcher(frags, pattern_chars=12, device=dev)
    m.load_pattern(pattern)
    scores = m.run()
    locs, best = matcher.best_alignment(scores)
    print(f"  best alignment per row: locs={locs.tolist()} "
          f"scores={best.tolist()} (pattern planted at row 4, loc 20)")

    print(f"\n== 4. match engine: same semantics on the {dev.type} fast "
          "path ==")
    engine = MatchEngine(frags, device=dev)
    plan = engine.plan(pattern)
    print(f"  planner chose {plan.backend!r} ({plan.reason})")
    fast = np.asarray(engine.scores(pattern))
    assert np.array_equal(fast, scores)
    print("  engine scores == CRAM array scores:", True)
    best = engine.match(pattern, reduction="best")
    print("  per-row best (fused reduction): locs="
          f"{best.best_locs.tolist()} scores={best.best_scores.tolist()}")
    print("  corpus host pack events across queries:",
          engine.corpus.host_pack_count,
          "(packed forms build lazily, only for kernels that need them)")
    print("  pattern:", encoding.decode_dna(pattern))


if __name__ == "__main__":
    main()
