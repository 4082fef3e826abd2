"""Hand-written Hopper kernels of the port, with their plain versions.

* ``match_swar``   -- SWAR sliding match, exact: the full score block
  (``match_swar``) or the best alignment per row reduced in the kernel's
  epilogue (``match_swar_best``); accept-set (``match_swar_masks``);
  CUDA C++ in ``csrc/match_swar.cu``.
* ``match_mxu``    -- one-hot correlation on the tensor cores
  (``wgmma``): the full score block (``match_mxu``) or the best
  alignment per (row, pattern) reduced in the kernel's epilogue
  (``match_mxu_best``); CUDA C++ in ``csrc/match_mxu.cu``.
* ``filter_qgram`` -- q-gram signature filters: the corpus filter
  (``filter_qgram``) and the standing bank's prefilter
  (``bank_prefilter``); CUDA C++ in ``csrc/filter_qgram.cu``.
* ``popcount`` / ``bitwise`` -- bulk per-row popcount and bulk bitwise
  ops; CUDA C++ in ``csrc/popcount.cu`` and ``csrc/bitwise.cu``.
* ``cram_array`` -- the CRAM-PM array interpreter (``cram_execute``: one
  micro-program on every row of a uint8 state; the counterpart of
  ``repro.core.array.execute``, a ``jax.lax.scan`` rather than a Pallas
  kernel), in two forms: bit-sliced, 32 rows a word, for 0/1 cells
  (``cram_execute_bits``), and a byte a cell for any state
  (``cram_execute_bytes``); CUDA C++ in ``csrc/cram_array.cu``.

Each wrapper takes its plain PyTorch version for a CPU tensor and
launches its kernel (or raises) for a CUDA tensor; ``<wrapper>.n_launches``
counts kernel launches.  ``_build`` compiles ``csrc/`` with nvcc at first
use.  ``ref`` holds the plain-torch oracles that the planner's ``ref``
backend runs and the shared ``popcount_words`` helper; ``ops`` keeps the
one-shot ``match_scores`` shim and the padded bulk ``popcount`` /
``bitwise`` entry points.  The module names mirror ``repro.kernels`` (so
``match_swar`` here is the module, as there).
"""
