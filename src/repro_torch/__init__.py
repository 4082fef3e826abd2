"""PyTorch/CUDA port of the CRAM-PM match stack (counterpart of ``repro``).

The JAX package ``repro`` stays the reference; this package mirrors its
module layout (``core``, ``obs``, ``kernels``, ``match``) so each
counterpart is easy to find, and never imports JAX or anything of
``repro``.  Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (``repro_torch.device.resolve_device``).  Each Pallas
kernel of the ported path is a hand-written CUDA C++ kernel for Hopper
(``kernels/csrc``), built with ``nvcc`` at first use and bound with
``ctypes`` (``kernels/_build.py``).

Ported so far: the match engine with its q-gram filter index
(``MatchEngine``, ``CorpusIndex``), on one device or row-sharded over a
row mesh of devices in one process (``launch.mesh.make_row_mesh``,
``distributed.sharding``), the standing-query
``PatternBank``, the multi-tenant ``MatchService``, calibration, ``obs``,
and all seven kernels of the JAX package -- ``match_swar``,
``match_swar_masks``, ``match_mxu``, ``filter_qgram``, ``bank_prefilter``,
``popcount`` and ``bitwise``; and the CRAM-PM functional model of
``core`` (the array interpreter, a CUDA kernel of its own, code
generation, Algorithm 1's ``Matcher``, the analog gate model, the
schedules and the paper's cost model).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
