"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout (``BENCHMARK.json`` names the cells).  The
last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``); the numbers compared for
``correct`` end standard error, each beside its limit.  Without a CUDA
device the run exits non-zero and prints no result.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    # Caches of anything the program compiles stay inside the checkout;
    # the CUDA kernels build into build/kernels/ there on their own.
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    import torch
    torch.set_num_threads(4)
    from portbench import harness
    return harness.main(sys.argv[1:], t0=T0, root=ROOT)


if __name__ == "__main__":
    sys.exit(main())
