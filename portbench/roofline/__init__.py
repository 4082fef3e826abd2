"""A kernel's bytes and operations, from the shapes of one call.

``roofline/<kernel>.py`` holds, for the wrapper of one kernel of the port:
``WRAPPER``, the module and function the benchmark records calls of;
``describe(args, kw)``, what of one call it keeps (shapes, scalars); and
``work(desc, geom)``, the bytes and operations the algorithm needs for
that call (``geom``: the configuration's widths), whatever implements
it: each input byte read once, each output byte written once, and the
fewest operations a design of that kind issues, so that a share of the
least time can never pass 100%.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

# id -> (tensor, count): the tensor is held so that its id is not reused.
_used: Dict[int, Tuple[torch.Tensor, int]] = {}


def used_columns(pat: torch.Tensor) -> int:
    """Columns of a padded pattern matrix that hold a pattern (the rest
    are zero padding), counted once per tensor."""
    key = id(pat)
    if key not in _used:
        _used[key] = (pat, int((pat != 0).any(0).sum()))
    return _used[key][1]


def forget() -> None:
    _used.clear()
