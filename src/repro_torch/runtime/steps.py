"""Step functions (port of ``repro.runtime.steps``): the train step with
microbatch gradient accumulation, the prefill step and the decode step.

Where the reference runs its microbatches under a ``lax.scan`` that sums
f32 gradients, the port loops: each microbatch's loss is differentiated
with ``torch.autograd.grad`` (never summed into ``.grad``, which for a
bf16 parameter would round at every microbatch), added into explicit f32
buffers, and divided by the count at the end.  Gradients then pass the
compression hook and AdamW updates the parameters and state in place.

On a mesh (the parameters are DTensors, ``convert.shard_params``) the
same step runs sharded: a plain batch is placed by
``distributed.sharding.batch_specs`` (a DTensor batch is taken as it
is; microbatches are split from the whole batch, then placed), the loss
and its gradients run under implicit replication, and each gradient is
redistributed to its parameter's placements before accumulation,
compression and the update -- the data-parallel reduction XLA inserts
for the reference's ``out_shardings``.  The accumulators and AdamW's
moments carry the parameters' placements.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch.distributed import sharding
from repro_torch.distributed.context import is_dtensor, replicating
from repro_torch.models import model
from repro_torch.models.config import ModelConfig
from repro_torch.models.spec import leaves, map_tree
from repro_torch.optim import adamw


def _split_microbatches(batch: Dict[str, Any], n: int) -> Dict[str, Any]:
    """Every array with a batch dim reshaped to (n, B // n, ...)."""
    def sp(x):
        if getattr(x, "ndim", 0) == 0:
            return x
        return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))
    return {k: sp(v) for k, v in batch.items()}


def _place_batch(batch: Dict[str, Any], mesh, dev) -> Dict[str, Any]:
    """The batch's arrays on ``dev``, or, on a mesh, as DTensors placed
    by ``batch_specs`` (a DTensor is taken as it is)."""
    if mesh is None:
        return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    plain = {k: v for k, v in batch.items() if not is_dtensor(v)}
    plain = {k: torch.as_tensor(v) for k, v in plain.items()}
    specs = sharding.batch_specs(plain, mesh)
    return {k: (v if is_dtensor(v)
                else sharding.distribute(plain[k], specs[k]))
            for k, v in batch.items()}


def _whole(x):
    """A batch array whole on every rank (a DTensor's full tensor)."""
    return x.full_tensor() if is_dtensor(x) else torch.as_tensor(x)


def _grads_of(cfg: ModelConfig, params, ps: List[torch.Tensor], batch
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """(loss, its gradient for each of ``ps``; zeros for a parameter the
    batch does not reach, as ``jax.grad`` gives).  On a mesh each
    gradient comes back with its parameter's placements."""
    sharded = is_dtensor(ps[0])
    loss = model.loss_fn(cfg, params, batch)
    with replicating(sharded):
        grads = torch.autograd.grad(loss, ps, allow_unused=True,
                                    materialize_grads=True)
    if sharded:
        grads = tuple(g.redistribute(p.device_mesh, p.placements)
                      for g, p in zip(grads, ps))
        loss = loss.full_tensor()
    return loss.detach(), grads


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.OptConfig
                    ) -> Callable[[Any, dict, Dict[str, Any]],
                                  Tuple[Any, dict, dict]]:
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics): the objects passed in, updated in place; metrics ``loss``,
    ``grad_norm`` and ``lr`` (0-d tensors).  ``params`` is a trainable
    ``CausalLM`` (or its tree); the batch's arrays go to its device."""

    def train_step(params, opt_state, batch):
        tree = model.param_tree(params)
        ps = [p for _, p in leaves(tree)]
        dev = ps[0].device
        mesh = ps[0].device_mesh if is_dtensor(ps[0]) else None
        n_mb = max(cfg.microbatch, 1)
        if n_mb > 1:
            whole = ({k: _whole(v) for k, v in batch.items()}
                     if mesh is not None else _place_batch(batch, None, dev))
            mbs = _split_microbatches(whole, n_mb)
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = [torch.zeros_like(p, dtype=torch.float32) for p in ps]
            for i in range(n_mb):
                mb = {k: v[i] if v.ndim else v for k, v in mbs.items()}
                mb_loss, mb_grads = _grads_of(cfg, params, ps,
                                              _place_batch(mb, mesh, dev))
                loss = loss + mb_loss
                with torch.no_grad():
                    for acc, g in zip(grads, mb_grads):
                        acc += g.float()
            loss = loss / n_mb
            with torch.no_grad():
                for acc in grads:
                    acc /= n_mb
        else:
            loss, grads = _grads_of(cfg, params, ps,
                                    _place_batch(batch, mesh, dev))
        it = iter(grads)
        grads = map_tree(lambda _: next(it), tree)
        grads = adamw.decompress(opt_cfg, adamw.compress(opt_cfg, grads))
        params, opt_state, metrics = adamw.update(opt_cfg, grads, opt_state,
                                                  params)
        return params, opt_state, dict(metrics, loss=loss)

    return train_step


def _place_serving(cfg: ModelConfig, params, batch: Dict[str, Any]
                   ) -> Dict[str, Any]:
    """A serving batch as the step takes it.  On a mesh (DTensor
    parameters) its arrays are placed by ``batch_specs`` and its caches by
    ``model.cache_shardings`` (the counterpart of the reference's
    ``in_shardings`` over ``cache_specs``' axes); a DTensor is taken as
    it is, and ``cache_index`` stays on the host, where the model checks
    per-row positions against the cache.  Off a mesh the batch is passed
    as it is."""
    embed = model.param_tree(params)["embed"]
    if not is_dtensor(embed):
        return batch
    mesh = embed.device_mesh
    out = dict(batch)
    arrays = {k: v for k, v in batch.items()
              if k not in ("caches", "cache_index") and v is not None}
    out.update(_place_batch(arrays, mesh, None))
    caches = batch.get("caches")
    if caches is not None:
        placed = model.cache_shardings(cfg, caches, mesh)
        out["caches"] = {k: (v if k not in placed else map_tree(
            lambda t, sh: t if is_dtensor(t) else sharding.distribute(t, sh),
            v, placed[k])) for k, v in caches.items()}
    return out


def make_prefill_step(cfg: ModelConfig):
    """Returns prefill_step(params, batch) -> (last logits (B, V),
    caches): ``batch`` holds the inputs and ``caches``; on a mesh a plain
    batch and cache tree are placed first (``_place_serving``)."""
    def prefill_step(params, batch):
        batch = _place_serving(cfg, params, batch)
        caches = batch["caches"]
        inputs = {k: v for k, v in batch.items() if k != "caches"}
        return model.prefill(cfg, params, inputs, caches)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """Returns decode_step(params, batch) -> (logits (B, V), caches):
    ``batch`` holds ``caches``, ``tokens`` (B, 1), ``cache_index`` and an
    encoder-decoder's ``enc_out``; placed on a mesh as the prefill's."""
    def decode_step(params, batch):
        batch = _place_serving(cfg, params, batch)
        return model.decode_step(
            cfg, params, batch["caches"], batch["tokens"],
            batch["cache_index"], enc_out=batch.get("enc_out"))
    return decode_step


def make_step(cfg: ModelConfig, kind: str, opt_cfg=None):
    if kind == "train":
        return make_train_step(cfg, opt_cfg or adamw.OptConfig())
    if kind == "prefill":
        return make_prefill_step(cfg)
    if kind == "decode":
        return make_decode_step(cfg)
    raise ValueError(kind)
