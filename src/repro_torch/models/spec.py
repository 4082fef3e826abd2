"""Parameter-spec system (port of ``repro.models.spec``).

Each parameter is declared once as ``P(shape, axes, init, dtype)``, its
``axes`` naming the *logical* mesh axis of every dim.  From the same
declarations:

* ``abstract(specs)`` -- ``device="meta"`` tensors of each leaf's shape
  and dtype, no allocation (the counterpart of ``ShapeDtypeStruct``s);
* ``tree_axes(specs)`` -- the logical-axis tree that
  ``repro_torch.distributed.sharding.shardings_for`` turns into DTensor
  placements on a mesh;
* ``initialize(specs, generator, device)`` -- materialized tensors, the
  reference's init rules drawn from an explicit ``torch.Generator``
  (JAX's PRNG stream is not reproduced; parity carries weights across
  with ``repro_torch.convert.params_from_numpy``);
* ``count_params(specs)``.

``leaves`` and ``map_tree`` walk any nested-dict tree (of specs,
tensors or arrays): gradients and optimizer moments mirror the
parameters path for path.

Spec trees are nested dicts; leaves are visited in sorted-key order, as
JAX flattens dicts.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class P:
    """One parameter declaration."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "fan_in"       # fan_in | zeros | ones | normal | embed
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape/axes rank mismatch: {self}")


def is_spec(x) -> bool:
    return isinstance(x, P)


def tree_map(fn: Callable[[P], Any], specs) -> Any:
    if is_spec(specs):
        return fn(specs)
    return {k: tree_map(fn, v) for k, v in specs.items()}


def leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs of a nested-dict tree (of specs, tensors or
    arrays) in sorted-key order; paths join keys with '/'."""
    if not hasattr(tree, "keys"):
        yield prefix, tree
        return
    for k in sorted(tree.keys()):
        yield from leaves(tree[k], f"{prefix}/{k}" if prefix else k)


def map_tree(fn: Callable[..., Any], tree, *rest) -> Any:
    """``fn`` over the leaves of nested-dict trees of one structure (a
    ``ParameterDict`` counts as a dict; anything without ``keys`` is a
    leaf), leaf by leaf across ``tree`` and ``rest`` in ``leaves``'
    order; plain dicts out."""
    if not hasattr(tree, "keys"):
        return fn(tree, *rest)
    return {k: map_tree(fn, tree[k], *(r[k] for r in rest))
            for k in sorted(tree.keys())}


def abstract(specs) -> Any:
    """A tree of meta tensors (shape and dtype only, no storage)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), specs)


def tree_axes(specs) -> Any:
    return tree_map(lambda s: s.axes, specs)


def _init_leaf(s: P, gen: torch.Generator, device) -> torch.Tensor:
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=s.dtype, device=device)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=s.dtype, device=device)

    def normal():
        return torch.randn(s.shape, generator=gen, dtype=s.dtype,
                           device=device)
    if s.init == "normal":
        return 0.02 * normal()
    if s.init == "embed":
        return normal() / math.sqrt(s.shape[-1])
    if s.init == "fan_in":
        # Treat the last axis as output; fan-in is the product of the rest.
        fan_in = max(1, math.prod(s.shape[:-1]))
        return (1.0 / math.sqrt(fan_in)) * normal()
    raise ValueError(s.init)


def initialize(specs, generator: torch.Generator, device) -> Any:
    """Nested dict of tensors on ``device`` (the generator's device)."""
    if is_spec(specs):
        return _init_leaf(specs, generator, device)
    return {k: initialize(specs[k], generator, device) for k in sorted(specs)}


def stack(n: int, specs) -> Any:
    """Add a leading stacked-layers dim to every spec."""
    return tree_map(
        lambda s: P((n,) + s.shape, ("layers",) + s.axes, s.init, s.dtype),
        specs)


def count_params(specs) -> int:
    return sum(math.prod(s.shape) for _, s in leaves(specs))


