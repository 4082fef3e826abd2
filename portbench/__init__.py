"""Benchmark of the PyTorch and CUDA port (``repro_torch``) on one H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line.  Everything a cell needs is found by name:

* ``configs/<config>.json``: the deployment (sizes and guarantees);
* ``traffic/<mix>.json``: the traffic mix, read by ``generator.py``;
* ``metrics/<metric>.py``: the reader of one per-layer metric;
* ``roofline/<kernel>.py``: one kernel's bytes and operations.

``reference/`` holds the plain answers that decide ``correct``.  Nothing
here imports JAX or the JAX package; ``reference/`` imports nothing of
the port either.
"""
