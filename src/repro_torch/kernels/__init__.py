"""Hand-written Hopper kernels of the match path, with their plain versions.

* ``match_swar``  -- SWAR sliding match, exact (``match_swar``) and
  accept-set (``match_swar_masks``); CUDA C++ in ``csrc/match_swar.cu``.
* ``match_mxu``   -- one-hot correlation on the tensor cores (WMMA);
  CUDA C++ in ``csrc/match_mxu.cu``.

Each wrapper takes its plain PyTorch version for a CPU tensor and
launches its kernel (or raises) for a CUDA tensor; ``<wrapper>.n_launches``
counts kernel launches.  ``_build`` compiles ``csrc/`` with nvcc at first
use.  ``ref`` holds the plain-torch oracles that the planner's ``ref``
backend runs; ``ops`` keeps the one-shot ``match_scores`` shim.  The
module names mirror ``repro.kernels`` (so ``match_swar`` here is the
module, as there).
"""
