"""Activation-sharding context (port of ``repro.distributed.context``):
logical layout constraints inside model code.

Model code calls ``constrain(x, ("batch", None, "vocab"))`` at
layout-critical points (the residual stream after each unit's block and
after the embedding, the logits).  When a mesh has been installed with
``activation_sharding(mesh)``, the logical axes resolve through the same
rule table as the parameters, and a DTensor ``x`` is redistributed to
those placements: the counterpart of ``with_sharding_constraint``, which
pins where the batch lives instead of leaving it to propagation.  Without
an installed mesh (one device, unit tests), for a plain tensor, or where
``x``'s rank differs from ``axes``', it returns ``x`` unchanged.

The installed mesh is a context variable: each thread (each rank of a
``"threaded"`` process group) installs its own.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Tuple

import torch

from . import sharding

_MESH: contextvars.ContextVar[Optional[tuple]] = contextvars.ContextVar(
    "activation_mesh", default=None)


@contextlib.contextmanager
def activation_sharding(mesh, rules=None):
    token = _MESH.set((mesh, rules))
    try:
        yield
    finally:
        _MESH.reset(token)


def current_mesh():
    cur = _MESH.get()
    return cur[0] if cur else None


def constrain(x, axes: Tuple[Optional[str], ...]):
    cur = _MESH.get()
    if cur is None:
        return x
    mesh, rules = cur
    if getattr(x, "ndim", None) != len(axes):
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = sharding.spec_for(axes, tuple(x.shape), mesh, rules)
    placements = sharding.NamedSharding(mesh, spec).placements
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def is_dtensor(x) -> bool:
    """``x`` is a DTensor (without importing ``torch.distributed.tensor``
    where no DTensor can exist)."""
    if not isinstance(x, torch.Tensor) or type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


@contextlib.contextmanager
def replicating(active: bool = True):
    """While ``active``, a plain tensor that meets a DTensor in an op is
    taken as replicated over the DTensor's mesh (DTensor's implicit
    replication), and the previous setting comes back after.  The flag is
    per thread, so each rank of a ``"threaded"`` group sets its own."""
    if not active:
        yield
        return
    from torch.distributed.tensor import DTensor
    dispatcher = DTensor._op_dispatcher
    prev = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = prev


def whole_dim(t, dim: int):
    """A DTensor ``t`` with tensor dim ``dim`` gathered (no mesh dim
    shards it; the others keep their shards); anything else as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    placements = [Replicate() if p.is_shard(dim) else p
                  for p in t.placements]
    if placements == list(t.placements):
        return t
    return t.redistribute(t.device_mesh, placements)
