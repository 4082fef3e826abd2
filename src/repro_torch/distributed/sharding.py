"""Logical-axis rules and the cyclic row layout (port of
``repro.distributed.sharding``).

Every parameter, cache or corpus dimension carries a *logical* axis name;
the rule tables map logical names onto mesh axes.  Resolution enforces
divisibility: a dimension that does not divide its mapped mesh axes
falls back to partial sharding or replication (``warn=True`` makes the
fallback audible).  The match stack reads the ``rows`` rule: corpus rows
over the mesh's ``data`` axis, the counterpart of the paper's
independent CRAM arrays (Sec. 3.4).

A mesh here is anything with ``axis_names`` and a ``shape`` mapping from
axis name to size (``repro_torch.launch.mesh.RowMesh``), read as the JAX
rules read a ``jax.sharding.Mesh``.

The cyclic row layout helpers work on numpy arrays and torch tensors
alike (reshape and ``swapaxes`` only).  ``spec_for``, ``shardings_for``,
``batch_specs``, ``replicated`` and ``total_dp`` belong to the LM's
sharding and are not ported yet.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

LOGICAL_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "embed": ("data",),
    "vocab": ("model",),
    "ff": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "heads_inner": ("model",),
    "experts": ("model",),
    "layers": (),
    "seq": (),
    # Match-engine corpus rows: embarrassingly parallel, the counterpart
    # of the paper's independent CRAM arrays (Sec. 3.4).
    "rows": ("data",),
}

# ZeRO-3/FSDP-only profile: weights shard over every axis on their
# d_model dim and are gathered per layer.
FSDP_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data", "model"),
    "embed": ("data", "model"),
    "vocab": ("model",),
    "ff": (),
    "heads": (),
    "kv_heads": (),
    "heads_inner": (),
    "experts": ("model",),
    "layers": (),
    "seq": (),
    "rows": ("data", "model"),   # no TP dim in a match query: rows over all
}

RULE_PROFILES = {"2d": LOGICAL_RULES, "fsdp": FSDP_RULES}


def resolve_axis(name: Optional[str], dim: int, mesh,
                 rules: Optional[Dict[str, Tuple[str, ...]]] = None, *,
                 warn: bool = False):
    """Mesh axes for one dimension, with divisibility fallback.

    Returns ``None`` (replicated), one axis name, or a tuple of names.
    When ``dim`` does not divide the mapped axes, leading axes are dropped
    until it does (partial sharding), else the dimension replicates;
    ``warn=True`` raises a ``UserWarning`` naming the axis, the dimension
    and the mesh sizes instead of falling back silently.
    """
    if name is None:
        return None
    rules = rules or LOGICAL_RULES
    want = [a for a in rules.get(name, ()) if a in mesh.axis_names]
    if not want:
        return None
    size = int(np.prod([mesh.shape[a] for a in want]))
    if size <= 1:
        return None
    if dim % size != 0:
        for i in range(1, len(want)):
            sub = want[i:]
            s = int(np.prod([mesh.shape[a] for a in sub]))
            if dim % s == 0:
                if warn:
                    warnings.warn(
                        f"logical axis {name!r}: dim {dim} does not divide "
                        f"mesh axes {tuple(want)} (sizes "
                        f"{tuple(int(mesh.shape[a]) for a in want)}); "
                        f"partially sharding over {tuple(sub)} only",
                        UserWarning, stacklevel=2)
                return tuple(sub) if len(sub) > 1 else sub[0]
        if warn:
            warnings.warn(
                f"logical axis {name!r}: dim {dim} does not divide mesh "
                f"axes {tuple(want)} (sizes "
                f"{tuple(int(mesh.shape[a]) for a in want)}); falling "
                f"back to replication",
                UserWarning, stacklevel=2)
        return None
    return tuple(want) if len(want) > 1 else want[0]


# -- cyclic row layout (match stack) ------------------------------------------
# Logical row r lives on shard s = r % S at slot j = r // S; in the
# physical (shard-major) order of a form that stacked every shard's block,
# that is index p = s * J + j for per-shard stride J.  So:
#   * contiguous logical appends round-robin across shards (ingest is
#     balanced by construction);
#   * capacity growth zero-extends each shard's block: a row never changes
#     shard or slot;
#   * slots [j0, j1) of every shard are the logical rows [j0*S, j1*S), so a
#     chunk is one contiguous slice per shard, with no copy.

def cyclic_physical_rows(rows, n_shards: int, stride: int):
    """Physical indices of logical row ids under the cyclic layout."""
    if not isinstance(rows, torch.Tensor):
        rows = np.asarray(rows)
    if n_shards == 1:
        return rows
    return (rows % n_shards) * stride + rows // n_shards


def cyclic_permute(a, n_shards: int):
    """Logical (R, ...) -> physical (R, ...): row j*S+s -> row s*J+j.

    Works on numpy arrays and torch tensors; R must be a multiple of
    ``n_shards``.
    """
    if n_shards == 1:
        return a
    R = a.shape[0]
    J = R // n_shards
    return a.reshape(J, n_shards, *a.shape[1:]).swapaxes(0, 1).reshape(
        R, *a.shape[1:])


def cyclic_unpermute(a, n_shards: int):
    """Physical (R, ...) -> logical (R, ...): inverse of cyclic_permute."""
    if n_shards == 1:
        return a
    R = a.shape[0]
    J = R // n_shards
    return a.reshape(n_shards, J, *a.shape[1:]).swapaxes(0, 1).reshape(
        R, *a.shape[1:])


def first_local(xs):
    """The first entry of a per-shard list that this process holds (the
    others are ``None``: shards another process owns)."""
    return next(x for x in xs if x is not None)
