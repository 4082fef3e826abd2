"""PyTorch/CUDA port of the CRAM-PM match stack (counterpart of ``repro``).

The JAX package ``repro`` stays the reference; this package mirrors its
module layout (``core``, ``obs``, ``kernels``, ``match``) so each
counterpart is easy to find, and never imports JAX or anything of
``repro``.  Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (``repro_torch.device.resolve_device``).  Each Pallas
kernel of the ported path is a hand-written CUDA C++ kernel for Hopper
(``kernels/csrc``), built with ``nvcc`` at first use and bound with
``ctypes`` (``kernels/_build.py``).

Ported so far: the match engine on one device without the q-gram index
(``MatchEngine(..., index=False)``) and its three match kernels
``match_swar``, ``match_swar_masks`` and ``match_mxu``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
