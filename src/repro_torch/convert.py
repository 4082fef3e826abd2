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
* ``params_from_numpy`` -- a JAX ``init_params`` tree (``jax.tree.map(
  np.asarray, params)``) as a ``CausalLM``, leaf for leaf, every path,
  shape and dtype checked against the port's ``param_specs``.
* ``cache_from_numpy`` -- a JAX cache tree (``init_cache``, or one a
  prefill or a decode filled) as the port's cache tree, checked the same
  way; an SSD state comes in bf16 or f32 (the reference's dtype changes
  with the call that last wrote it) and is widened to the port's f32
  leaf exactly, its dtype kept in the tree's ``STATE_BF16`` flag.
* ``opt_state_from_numpy`` -- the reference's AdamW state (``{"m", "v",
  "step"}``, numpy leaves) as the port's: ``m`` and ``v`` f32, checked
  against the parameters' paths and shapes, ``step`` a 0-d int32 tensor.
* ``shard_params`` -- a one-device ``CausalLM`` (from ``init_params`` or
  ``params_from_numpy``) onto a named mesh: every leaf a DTensor placed
  by ``shardings_for(param_axes, abstract_params, mesh, rules)``, the
  config's rule profile by default; each rank copies only its own block.
* ``to_numpy`` -- the other way: a port tree (a ``CausalLM``, a tree of
  tensors such as gradients or the AdamW state) as nested dicts of numpy
  arrays (copies), bf16 leaves widened to f32 (exact), so a test holds them
  against the reference's ``jax.tree.map(np.asarray, ...)``; a DTensor
  leaf is gathered whole first (a collective: every rank calls it).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import sharding as _sharding
from repro_torch.distributed.context import is_dtensor
from repro_torch.match.corpus import PackedCorpus
from repro_torch.models import model as _model
from repro_torch.models import ssm as _ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.spec import P, leaves, map_tree, tree_map


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


def _leaf_tensor(path: str, a: np.ndarray, want: torch.dtype,
                 shape, dev: torch.device,
                 widen: bool = False) -> torch.Tensor:
    """One leaf; ``widen`` also takes a bf16 array for an f32 spec."""
    a = np.asarray(a)
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"{path}: shape {a.shape}, the port's spec says "
                         f"{tuple(shape)}")
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: carry the bits
        if want != torch.bfloat16 and not (widen and want == torch.float32):
            raise ValueError(f"{path}: dtype bfloat16, the port's spec says "
                             f"{want}")
        bits = np.ascontiguousarray(a).view(np.int16)
        t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
        return t.to(dev, want)          # bf16 -> f32 is exact
    t = torch.from_numpy(np.array(a))
    if t.dtype != want:
        raise ValueError(f"{path}: dtype {a.dtype}, the port's spec says "
                         f"{want}")
    return t.to(dev)


def _tree_from_numpy(specs, tree, dev: torch.device,
                     widen: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """``tree`` checked against ``specs`` path for path; leaves whose path
    ends with one of ``widen`` may be bf16 where the spec says f32."""
    want, got = dict(leaves(specs)), dict(leaves(tree))
    if set(want) != set(got):
        raise ValueError(f"tree paths differ from the port's specs: missing "
                         f"{sorted(set(want) - set(got))}, extra "
                         f"{sorted(set(got) - set(want))}")
    out: Dict[str, Any] = {}
    for path, s in want.items():
        node = out
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = _leaf_tensor(path, got[path], s.dtype, s.shape, dev,
                                  widen=path.endswith(widen))
    return out


def params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any],
                      device: DeviceLike = None) -> "_model.CausalLM":
    """The reference's parameter tree (numpy leaves) as a ``CausalLM``."""
    dev = resolve_device(device)
    return _model.CausalLM(cfg, _tree_from_numpy(_model.param_specs(cfg),
                                                 tree, dev))


def cache_from_numpy(cfg: ModelConfig, tree: Dict[str, Any],
                     device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's cache tree (numpy leaves) as the port's.  Batch and
    length are read off its first self-attention ``k`` leaf (a cross
    cache's length is ``cfg.n_audio_frames``); a model with recurrent
    layers only gives its batch from its first ``h`` or SSD ``state``
    leaf, and no length.  SSD states may be bf16 or f32, all alike."""
    dev = resolve_device(device)
    flat = list(leaves(tree))
    k = next((v for p, v in flat if p.endswith("/attn/k")), None)
    if k is not None:
        batch, seq_len = k.shape[-4], k.shape[-2]
    else:
        path, h = next((p, v) for p, v in flat
                       if p.endswith(("/rglru/h", "/ssd/state")))
        # h is (..., B, r); an SSD state (..., B, H, Pd, N).
        batch, seq_len = h.shape[-4 if path.endswith("state") else -2], 0
    out = _tree_from_numpy(_model.cache_specs(cfg, batch, seq_len), tree,
                           dev, widen=("/ssd/state",))
    states = {np.asarray(v).dtype.name for p, v in flat
              if p.endswith("/ssd/state")}
    if states:
        if len(states) > 1:
            raise ValueError(f"SSD states of several dtypes: {states}")
        out[_ssm.STATE_BF16] = torch.tensor(states == {"bfloat16"})
    return out


def opt_state_from_numpy(cfg: ModelConfig, tree: Dict[str, Any],
                         device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's ``adamw.init``/``update`` state (numpy leaves) as
    the port's."""
    dev = resolve_device(device)
    specs = tree_map(lambda s: P(s.shape, s.axes, s.init, torch.float32),
                     _model.param_specs(cfg))
    step = np.asarray(tree["step"])
    if step.dtype != np.int32 or step.shape != ():
        raise ValueError(f"step: {step.dtype} {step.shape}, the port's "
                         f"state holds a 0-d int32")
    return {"m": _tree_from_numpy(specs, tree["m"], dev),
            "v": _tree_from_numpy(specs, tree["v"], dev),
            "step": torch.from_numpy(np.array(step)).to(dev)}


def to_numpy(tree) -> Any:
    """A port tree as nested dicts of numpy arrays (bf16 widened to
    f32)."""
    def leaf(t):
        if is_dtensor(t):
            t = t.full_tensor()
        t = t.detach().to("cpu", copy=True)      # apart from the tensor
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return map_tree(leaf, _model.param_tree(tree))


def shard_params(lm: "_model.CausalLM", mesh,
                 rules=None) -> "_model.CausalLM":
    """``lm``'s parameters as DTensors on ``mesh`` (a new ``CausalLM``, as
    trainable as ``lm``), placed by the config's rule profile unless
    ``rules`` names a table.  Every rank calls it with the same weights."""
    cfg = lm.cfg
    if rules is None:
        rules = _sharding.RULE_PROFILES[cfg.sharding_profile]
    placed = _sharding.shardings_for(_model.param_axes(cfg),
                                     _model.abstract_params(cfg), mesh,
                                     rules)
    tree = map_tree(_sharding.distribute, _model.param_tree(lm), placed)
    trainable = any(p.requires_grad for p in lm.parameters())
    return _model.CausalLM(cfg, tree, trainable=trainable)
