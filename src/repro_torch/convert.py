"""Carry the JAX package's state across to the port, as numpy arrays.

No JAX object crosses: the caller hands over ``np.asarray`` of whatever
the reference holds, and these functions build the port's equivalent on
``device`` (``None`` means the CUDA device).

* ``corpus_from_numpy`` -- a ``PackedCorpus`` with the same live rows,
  capacity and tombstones as a JAX ``PackedCorpus`` (``fragments``,
  ``capacity``, ``dead_mask``).
* ``swar_words_from_numpy`` -- uint32 words (``swar_words(n)``, packed
  pattern words, valid masks, a ``CorpusIndex.signatures()`` form) as
  the int32 bit-carrier tensor the kernels take.
* ``onehot_from_numpy`` -- a float32 or bf16 one-hot / multi-hot array
  (``onehot_flat(n)``, a pattern matrix) as the bf16 tensor the
  tensor-core kernel takes.
* ``bank_forms_from_numpy`` -- a JAX ``PatternBank``'s ``planes()`` and
  ``filter_operands()`` (uint32 planes and signatures, int32 slacks) as
  the port bank's device forms.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.match.corpus import PackedCorpus


def corpus_from_numpy(fragments: np.ndarray, *,
                      capacity: Optional[int] = None,
                      dead_mask: Optional[np.ndarray] = None,
                      device: DeviceLike = None) -> PackedCorpus:
    corpus = PackedCorpus(fragments, capacity=capacity, device=device)
    if dead_mask is not None:
        corpus.tombstone(np.flatnonzero(np.asarray(dead_mask, bool)))
    return corpus


def swar_words_from_numpy(u32: np.ndarray,
                          device: DeviceLike = None) -> torch.Tensor:
    a = np.asarray(u32)
    if a.dtype != np.uint32:
        raise ValueError(f"expected uint32 words, got {a.dtype}")
    # A copy: the caller's array (often read-only, from JAX) stays apart.
    return torch.from_numpy(np.array(a).view(np.int32)).to(
        resolve_device(device))


def onehot_from_numpy(f32: np.ndarray,
                      device: DeviceLike = None) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(f32, np.float32))
    return torch.from_numpy(a).to(resolve_device(device), torch.bfloat16)


def bank_forms_from_numpy(planes: np.ndarray, sigs: np.ndarray,
                          slacks: np.ndarray, device: DeviceLike = None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    s = np.asarray(slacks)
    if s.dtype != np.int32:
        raise ValueError(f"expected int32 slacks, got {s.dtype}")
    return (swar_words_from_numpy(planes, device),
            swar_words_from_numpy(sigs, device),
            torch.from_numpy(np.array(s)).to(
                resolve_device(device)))
