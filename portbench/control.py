"""The control: the plain reference in the program's place, with one
guarantee the configuration states broken.  ``correct`` must come out
false for it, or the check could not tell an exact answer from a near
one.

    python3 portbench/control.py --workload <cell> --seed <n> \
        --seconds <s>

runs the cell as ``run.py`` does, then, before the check, replaces the
program's answers with the control's, and prints the result line and a
last line ``control: correct=<bool>``.  The benchmark's own runs never run
this.  The configuration states exact answers and no precision, so the
control breaks exactness: the reference's answers with
the last read position left out of every score.
"""

from __future__ import annotations

import sys
import time

T0 = time.perf_counter()

from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def control(run, out) -> None:
    import torch
    from portbench import judge
    answers = out["answers"]
    ids = sorted(answers)
    frags = torch.from_numpy(out["frags"]).to(run.device)
    masks = judge.request_masks(out["reqs"], ids)
    P = masks.shape[1]
    want = judge.reference_answers(frags, run.cell.traffic, masks,
                                   [None] * len(ids), skip=[P - 1])
    out["answers"] = dict(zip(ids, want))


def main() -> int:
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    import torch
    torch.set_num_threads(4)
    from portbench import harness
    runs = []

    def hook(run, out):
        control(run, out)
        runs.append(run)

    rc = harness.main(sys.argv[1:], t0=T0, root=ROOT, control=hook)
    for run in runs:
        print(f"control: correct={harness.is_correct(run)}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
