"""AdamW + warmup-cosine schedule + global-norm clipping (port of
``repro.optim.adamw``), written as tensor ops.

The reference's math, op for op: ``m`` and ``v`` in f32 whatever the
parameter's dtype, gradients widened to f32 and clipped by their global
norm, the schedule and the bias corrections computed in f32 tensors on
the device (not Python floats), and each parameter updated in f32 and
cast back.  ``torch.optim.AdamW`` is none of these: it keeps its
moments in the parameter's dtype and has no clip and no schedule.

On a mesh the parameters are DTensors: the moments are made with
their placements (``zeros_like``), the gradients must come with them
(the train step redistributes them), and ``global_norm`` sums each
leaf's squares over the whole tensor, not over this rank's shard.

Trees are nested dicts of tensors (a ``CausalLM`` stands for its
``params``); the state is ``{"m": tree, "v": tree, "step": 0-d int32}``,
``m`` and ``v`` mirroring the parameters path for path, so a checkpoint
holds the reference's paths.  ``update`` works in place under
``no_grad`` (parameters, ``m``, ``v`` and ``step``), where the
reference's jitted step donates them: at full width a second copy of
the weights and moments would cost gigabytes.  Gradient compression
(``compress``/``decompress``) is applied in the train step, not here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.distributed.context import is_dtensor
from repro_torch.models.model import param_tree
from repro_torch.models.spec import leaves, map_tree


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    grad_compression: str = "none"      # none | bf16 | int8


def _leaves(tree) -> List[torch.Tensor]:
    """A tree's leaves in path order (a list is taken as they)."""
    if isinstance(tree, list):
        return tree
    return [t for _, t in leaves(param_tree(tree))]


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an f32 tensor): linear warmup, then
    cosine decay to ``min_lr_ratio`` x peak."""
    warm = cfg.peak_lr * torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def init(params) -> Dict[str, Any]:
    """Zero moments (f32, on each parameter's device, with its
    placements on a mesh) and step 0."""
    tree = param_tree(params)
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    dev = next(leaves(tree))[1].device
    return {"m": map_tree(zeros, tree), "v": map_tree(zeros, tree),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares (a
    DTensor's over all its shards)."""
    total = 0
    for g in _leaves(tree):
        sq = torch.sum(torch.square(g.float()))
        total = total + (sq.full_tensor() if is_dtensor(sq) else sq)
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before)."""
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return map_tree(lambda g: g * scale, param_tree(grads)), norm


@torch.no_grad()
def update(cfg: OptConfig, grads, state: Dict[str, Any], params
           ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, in place: returns (params, state, metrics) -- the
    objects passed in, updated -- with metrics ``grad_norm`` (before the
    clip) and ``lr``.  ``grads`` mirrors the parameters."""
    gs = [g.float() for g in _leaves(grads)]
    norm = global_norm(gs)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(norm, 1e-9), 1.0)
    state["step"] += 1
    step = state["step"].float()
    lr = schedule(cfg, step)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, device=step.device), step)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, device=step.device), step)
    # The reference's expressions, each product and sum rounded where
    # its are, written in place to bound the temporaries to a leaf or two.
    for p, g, m, v in zip(_leaves(params), gs, _leaves(state["m"]),
                          _leaves(state["v"])):
        g = g * scale
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))       # b1 m + (1 - b1) g
        v.mul_(cfg.b2).add_(g.square_().mul_(1 - cfg.b2))
        del g
        step_ = (v / b2c).sqrt_().add_(cfg.eps)     # sqrt(vh) + eps
        step_ = torch.div(m, b1c).div_(step_)       # mh / (...)
        p32 = p.float()
        step_.add_(cfg.weight_decay * p32).mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(step_)
        else:
            p.copy_(p32.sub_(step_))
    return params, state, {"grad_norm": norm, "lr": lr}


def compress(cfg: OptConfig, grads):
    """Gradient-compression hook applied before the cross-replica reduce.

    bf16: plain down-cast.  int8: per-leaf symmetric quantization, each
    leaf a tuple (int8 values, scale in the leaf's dtype); rounding half
    to even, as the reference's ``jnp.round``, and saturating, as its
    ``astype(int8)`` compiles."""
    if cfg.grad_compression == "none":
        return grads
    if cfg.grad_compression == "bf16":
        return map_tree(lambda g: g.to(torch.bfloat16),
                        param_tree(grads))
    if cfg.grad_compression == "int8":
        def q(g):
            # The compiled reference divides by the constant as XLA rewrites
            # it, a multiply by its reciprocal (1 ulp off a true divide at
            # times).
            scale = (torch.clamp_min(torch.amax(torch.abs(g)), 1e-9)
                     * (1.0 / 127.0))
            # A bf16 quotient can round to 128; XLA's convert saturates
            # it to 127 where a plain cast would wrap it to -128.
            q = torch.clamp(torch.round(g / scale), -128, 127)
            return q.to(torch.int8), scale
        return map_tree(q, param_tree(grads))
    raise ValueError(cfg.grad_compression)


def decompress(cfg: OptConfig, grads):
    if cfg.grad_compression == "int8":
        return map_tree(lambda t: t[0].float() * t[1], grads)
    return grads
