"""Logical-axis rules and the cyclic row layout (port of
``repro.distributed.sharding``).

Every parameter, cache or corpus dimension carries a *logical* axis name;
the rule tables map logical names onto mesh axes.  Resolution enforces
divisibility: a dimension that does not divide its mapped mesh axes
falls back to partial sharding or replication (``warn=True`` makes the
fallback audible).  The match stack reads the ``rows`` rule: corpus rows
over the mesh's ``data`` axis, the counterpart of the paper's
independent CRAM arrays (Sec. 3.4).

A mesh here is a named ``torch.distributed`` ``DeviceMesh``
(``mesh_dim_names``, ``shape`` a tuple; ``launch.mesh.make_debug_mesh``,
``make_production_mesh``), a ``launch.mesh.RowMesh``, or anything with
``axis_names`` and a ``shape`` mapping from axis name to size, read as
the JAX rules read a ``jax.sharding.Mesh``.

The LM's sharding: ``spec_for`` turns a leaf's logical axes into a spec
with one entry a tensor dim (``None``, a mesh axis name, or a tuple of
names), entry for entry the reference's ``PartitionSpec``;
``NamedSharding(mesh, spec)`` turns a spec into DTensor placements, one
a mesh dim (``Shard(d)`` where the spec puts tensor dim ``d`` on that
axis, else ``Replicate()``).  A composite entry such as ``("pod",
"data")`` shards one tensor dim over both mesh dims; DTensor splits
mesh dims left to right, which is JAX's major-to-minor order, so each
device holds the block the reference's device at its coordinate holds.
``shardings_for``, ``batch_sharding``, ``replicated``, ``batch_specs``
and ``total_dp`` build them for parameter, cache and batch trees.

The cyclic row layout helpers work on numpy arrays and torch tensors
alike (reshape and ``swapaxes`` only).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Optional, Tuple

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


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a mesh, in mesh order: a ``DeviceMesh``'s
    ``mesh_dim_names`` and ``shape`` tuple, else ``axis_names`` and a
    ``shape`` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(n) for n in mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


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
    sizes = axis_sizes(mesh)
    want = [a for a in rules.get(name, ()) if a in sizes]
    if not want:
        return None
    size = int(np.prod([sizes[a] for a in want]))
    if size <= 1:
        return None
    if dim % size != 0:
        for i in range(1, len(want)):
            sub = want[i:]
            s = int(np.prod([sizes[a] for a in sub]))
            if dim % s == 0:
                if warn:
                    warnings.warn(
                        f"logical axis {name!r}: dim {dim} does not divide "
                        f"mesh axes {tuple(want)} (sizes "
                        f"{tuple(sizes[a] for a in want)}); "
                        f"partially sharding over {tuple(sub)} only",
                        UserWarning, stacklevel=2)
                return tuple(sub) if len(sub) > 1 else sub[0]
        if warn:
            warnings.warn(
                f"logical axis {name!r}: dim {dim} does not divide mesh "
                f"axes {tuple(want)} (sizes "
                f"{tuple(sizes[a] for a in want)}); falling "
                f"back to replication",
                UserWarning, stacklevel=2)
        return None
    return tuple(want) if len(want) > 1 else want[0]


# -- the LM's sharding: specs and DTensor placements --------------------------

Spec = Tuple[Any, ...]


def spec_for(axes: Tuple[Optional[str], ...], shape: Tuple[int, ...],
             mesh, rules=None) -> Spec:
    """One entry a tensor dim (``None``, an axis name or a tuple of
    names): each logical axis resolved with its fallback, and a mesh axis
    used at most once per spec (a later dim that wants it replicates)."""
    used: set = set()
    out = []
    for name, dim in zip(axes, shape):
        r = resolve_axis(name, dim, mesh, rules)
        flat = (r if isinstance(r, tuple) else (r,)) if r else ()
        if any(a in used for a in flat):
            r = None            # a mesh axis may appear once per spec
        else:
            used.update(flat)
        out.append(r)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a named mesh; ``placements`` are its DTensor
    placements, one a mesh dim.  A spec may be shorter than the tensor's
    rank: the trailing dims replicate."""

    mesh: Any
    spec: Spec = ()

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard
        names = list(axis_sizes(self.mesh))
        dim_of: Dict[str, int] = {}
        for d, entry in enumerate(self.spec):
            flat = entry if isinstance(entry, tuple) else (entry,)
            if entry is not None and len(flat) > 1 and sorted(
                    flat, key=names.index) != list(flat):
                # DTensor splits mesh dims left to right (major first).
                raise ValueError(f"composite entry {entry} is not in the "
                                 f"mesh's axis order {tuple(names)}")
            for a in flat:
                if a is not None:
                    dim_of[a] = d
        return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                     for a in names)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _map_axes(fn, axes, abstract):
    if _is_axes(axes):
        return fn(axes, abstract)
    return {k: _map_axes(fn, axes[k], abstract[k]) for k in sorted(axes)}


def shardings_for(tree_axes: Any, tree_abstract: Any, mesh,
                  rules=None) -> Any:
    """A nested-dict tree of ``NamedSharding``s matching (axes, abstract
    shapes): a leaf of ``tree_axes`` is a tuple of logical names, a leaf
    of ``tree_abstract`` anything with ``shape`` (a meta tensor)."""
    def mk(axes, aval):
        return NamedSharding(mesh, spec_for(axes, tuple(aval.shape), mesh,
                                            rules))
    return _map_axes(mk, tree_axes, tree_abstract)


def batch_sharding(mesh) -> NamedSharding:
    axes = tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))
    return NamedSharding(mesh, (axes if len(axes) > 1 else axes[0],))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def batch_specs(batch_abstract: Dict[str, Any], mesh) -> Dict[str, Any]:
    """Shardings for an input batch tree: the leading dim over the batch
    axes where it divides ``total_dp``, the rest replicated; scalars
    replicated."""
    bs = batch_sharding(mesh)

    def mk(aval):
        ndim = len(getattr(aval, "shape", ()))
        if ndim == 0:
            return replicated(mesh)
        if aval.shape[0] % total_dp(mesh) == 0:
            return NamedSharding(mesh, (bs.spec[0],) + (None,) * (ndim - 1))
        return replicated(mesh)

    def walk(t):
        if hasattr(t, "keys"):
            return {k: walk(t[k]) for k in sorted(t.keys())}
        return mk(t)
    return walk(batch_abstract)


def total_dp(mesh) -> int:
    sizes = axis_sizes(mesh)
    return int(np.prod([sizes[a] for a in ("pod", "data") if a in sizes]))


def local_slices(shape: Tuple[int, ...], sharding: NamedSharding
                 ) -> Tuple[slice, ...]:
    """This rank's block of a tensor of global ``shape`` under
    ``sharding`` (DTensor's own layout), one slice a dim."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    local, offset = compute_local_shape_and_global_offset(
        tuple(shape), sharding.mesh, sharding.placements)
    return tuple(slice(o, o + n) for o, n in zip(offset, local))


def local_rows(t) -> slice:
    """The rows (dim 0) of DTensor ``t`` that this rank's shard holds."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    local, offset = compute_local_shape_and_global_offset(
        tuple(t.shape), t.device_mesh, t.placements)
    return slice(offset[0], offset[0] + local[0])


def mesh_device(mesh) -> torch.device:
    """The device this rank's shards of ``mesh`` sit on."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    handle = getattr(torch, mesh.device_type)
    return torch.device(mesh.device_type, handle.current_device())


def from_local(local: torch.Tensor, mesh, placements, shape):
    """A DTensor of global ``shape``, laid out contiguously, whose shard
    on this rank is ``local`` (made contiguous)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(tuple(shape),
                                                 device="meta").stride())


def from_block(block: torch.Tensor, shape: Tuple[int, ...],
               sharding: NamedSharding):
    """A DTensor of global ``shape`` whose local shard on this rank is
    ``block`` (this rank's ``local_slices``), copied to the mesh's
    device; a meta block stays meta (an abstract tree: no device)."""
    local = (block.detach() if block.is_meta
             else block.detach().to(mesh_device(sharding.mesh), copy=True))
    return from_local(local, sharding.mesh, sharding.placements, shape)


def distribute(t: torch.Tensor, sharding: NamedSharding):
    """``t`` (every rank holding the whole of it) as a DTensor placed by
    ``sharding``: each rank copies only its own block, no collective."""
    return from_block(t[local_slices(t.shape, sharding)], tuple(t.shape),
                      sharding)


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
