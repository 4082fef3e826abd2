"""Row meshes for sharded match engines (port of ``repro.launch.mesh``'s
``make_row_mesh``).

A mesh here is one controller process's list of devices, one per row
shard, under the single axis ``data`` (the ``rows`` rule's axis).  Each
shard's corpus forms are tensors on its own device; the engine launches
the kernels shard by shard and joins the reduced results on the first
device.  ``make_production_mesh`` and ``make_debug_mesh`` belong to the
LM's sharding and are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.device import DeviceLike, canonical_device, resolve_device


@dataclasses.dataclass(frozen=True)
class RowMesh:
    """A 1-D ``("data",)`` mesh: one ``torch.device`` per row shard.

    ``axis_names`` and ``shape`` read as a ``jax.sharding.Mesh``'s do, so
    ``repro_torch.distributed.sharding.resolve_axis`` takes either.
    """

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("data",)

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def n_cards(self) -> int:
        """Distinct devices the shards sit on."""
        return len(set(self.devices))


def make_row_mesh(n_shards: int,
                  devices: Optional[Sequence[DeviceLike]] = None) -> RowMesh:
    """``n_shards`` row shards, one per device.

    ``devices=None`` takes the first ``n_shards`` visible CUDA cards and
    raises when there are fewer.  Several shards on one card, or on the
    CPU, must be asked for by name: ``devices=["cuda:0"] * 4`` or
    ``["cpu"] * S``.
    """
    n_shards = int(n_shards)
    if n_shards < 1:
        raise ValueError(f"a row mesh needs >= 1 shard, got {n_shards}")
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_shards:
            raise RuntimeError(
                f"need {n_shards} CUDA devices for a {n_shards}-shard row "
                f"mesh, have {have} -- pass devices=[...] to place several "
                "shards on one card (['cuda:0'] * S) or on the CPU "
                "(['cpu'] * S)")
        devices = [f"cuda:{i}" for i in range(n_shards)]
    devs = tuple(canonical_device(resolve_device(d)) for d in devices)
    if len(devs) != n_shards:
        raise ValueError(f"a {n_shards}-shard row mesh needs {n_shards} "
                         f"devices, got {len(devs)}")
    return RowMesh(devices=devs)
