"""Meshes (port of ``repro.launch.mesh``): the LM's named
``(data, model)`` / ``(pod, data, model)`` meshes, and row meshes for
sharded match engines.

``make_production_mesh`` and ``make_debug_mesh`` build a named
``torch.distributed`` ``DeviceMesh`` over the initialised process group
(one rank a device of the reference's mesh, ranks in row-major order as
``jax.make_mesh`` lays out devices); the LM's parameters, batches and
activations are placed on it as DTensors
(``repro_torch.distributed.sharding``, ``convert.shard_params``).  The
device type is ``cuda`` unless the caller names ``"cpu"``.
``run_threaded`` runs a function on each rank of a ``"threaded"`` process
group: ranks that are threads of one process, whose collectives are
device copies, so a 2x2 mesh fits on one card (every rank's shards on
``cuda:0``) or a card a rank where there are enough.

A row mesh is the list of row shards under the single axis ``data``
(the ``rows`` rule's axis), one ``torch.device`` a shard.  In one
process every shard is local: each shard's corpus forms are tensors on
its own device, the engine launches the kernels shard by shard and
joins the reduced results on the first device.

Under an initialised ``torch.distributed`` group (``launch.cluster``)
the mesh spans the group's ranks: ``size`` and ``axis_names`` read the
same on every rank, shard ``s`` is owned by rank ``s // (S / world)``
(rank 0 holds the first block of shards, as ``jax.devices()`` orders
devices by process for the reference's mesh), and ``devices`` holds
``None`` for every shard another rank owns.  ``all_gather`` and
``all_reduce_sum`` are the mesh's collectives over the group: under
gloo they stage through host tensors (``.cpu()`` before, ``.to(dev)``
after), under NCCL device tensors go in directly.
``make_production_mesh`` and ``make_debug_mesh`` belong to the LM's
sharding and are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
import socket
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.device import DeviceLike, canonical_device, resolve_device
from repro_torch.launch import cluster

# dtypes a varying-size ``all_gather`` can announce in its header.
_DTYPES = (torch.bool, torch.uint8, torch.int32, torch.int64,
           torch.bfloat16, torch.float32)
_HEADER = 6     # rows, ndim, three trailing dims, dtype index


@dataclasses.dataclass(frozen=True)
class RowMesh:
    """A 1-D ``("data",)`` mesh: one ``torch.device`` per row shard.

    ``axis_names`` and ``shape`` read as a ``jax.sharding.Mesh``'s do, so
    ``repro_torch.distributed.sharding.resolve_axis`` takes either.
    ``devices[s]`` is ``None`` where another rank owns shard ``s``;
    ``homes[s]`` names the device of shard ``s`` alike on every rank
    (host name and device), so every rank counts the same cards.
    """

    devices: Tuple[Optional[torch.device], ...]
    axis_names: Tuple[str, ...] = ("data",)
    homes: Tuple[str, ...] = ()
    rank: int = 0
    world: int = 1
    backend: Optional[str] = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def n_cards(self) -> int:
        """Distinct devices the shards sit on, over every rank."""
        return len(set(self.homes or self.devices))

    @property
    def multiprocess(self) -> bool:
        """The shards span more than one process."""
        return self.world > 1

    def owner(self, shard: int) -> int:
        """The rank that holds shard ``shard``."""
        return int(shard) // (self.size // self.world)

    @property
    def local_shards(self) -> Tuple[int, ...]:
        """The shards this rank holds, in shard order."""
        return tuple(s for s, d in enumerate(self.devices) if d is not None)

    @property
    def device(self) -> torch.device:
        """This rank's first shard's device: where its shards join."""
        return self.devices[self.local_shards[0]]

    # -- collectives over the group -------------------------------------------
    def _stage(self, t: torch.Tensor) -> torch.Tensor:
        """Where the group's collectives take ``t``: the host under gloo,
        its device under NCCL."""
        return t.cpu() if self.backend == "gloo" else t

    def all_gather(self, t: Optional[torch.Tensor],
                   rows: Optional[Sequence[int]] = None) -> torch.Tensor:
        """Every rank's ``t`` joined on dim 0 in rank order, on this
        rank's join device.

        ``rows`` gives each rank's row count where every rank knows them
        (then one collective).  Without it the ranks exchange a header
        first (rows, shape, dtype) and pad to the largest; a rank with no
        rows passes ``None`` and learns the trailing shape and dtype from
        the others.
        """
        dev = self.device if t is None else t.device
        if rows is None:
            head = torch.full((_HEADER,), -1, dtype=torch.int64)
            if t is not None:
                head[0], head[1] = t.shape[0], t.ndim
                head[2:2 + t.ndim - 1] = torch.tensor(t.shape[1:])
                head[5] = _DTYPES.index(t.dtype)
            if self.backend != "gloo":
                head = head.to(dev)
            heads = [torch.empty_like(head) for _ in range(self.world)]
            torch.distributed.all_gather(heads, head)
            heads = torch.stack(heads).cpu()
            rows = [max(0, int(h[0])) for h in heads]
            full = next(h for h in heads if int(h[1]) > 0)
            trail = tuple(int(d) for d in full[2:2 + int(full[1]) - 1])
            dtype = _DTYPES[int(full[5])]
            if t is None:
                t = torch.empty((0, *trail), dtype=dtype, device=dev)
        top = max(rows)
        x = self._stage(t)
        if x.shape[0] < top:
            x = torch.cat([x, x.new_zeros((top - x.shape[0],
                                           *x.shape[1:]))], 0)
        outs = [torch.empty_like(x) for _ in range(self.world)]
        torch.distributed.all_gather(outs, x.contiguous())
        g = torch.cat([o[:n] for o, n in zip(outs, rows)], 0)
        return g.to(dev)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, on every rank, on ``t``'s device."""
        x = self._stage(t).clone()
        torch.distributed.all_reduce(x)
        return x.to(t.device)


def _home(device: torch.device) -> str:
    return f"{socket.gethostname()}/{device}"


def _rank_cards(local: int, world: int) -> List[str]:
    """This rank's default cards: ``local`` of them from card
    ``local_rank * local``, by ``launch.cluster.initialize``'s rule (its
    index among the processes of its host: SLURM's local id, else its
    rank).  Raises when this host has too few visible cards."""
    first = (cluster.local_rank(cluster.detect_environment()) * local
             if world > 1 else 0)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < first + local:
        raise RuntimeError(
            f"need CUDA devices {first}..{first + local - 1} for this "
            f"process's {local} shard(s) of a row mesh, have {have} -- pass "
            "devices=[...] to place several shards on one card "
            "(['cuda:0'] * S) or on the CPU (['cpu'] * S)")
    return [f"cuda:{first + i}" for i in range(local)]


def make_row_mesh(n_shards: int,
                  devices: Optional[Sequence[DeviceLike]] = None) -> RowMesh:
    """``n_shards`` row shards, one per device.

    One process: ``devices=None`` takes the first ``n_shards`` visible
    CUDA cards and raises when there are fewer.  Several shards on one
    card, or on the CPU, must be asked for by name: ``devices=["cuda:0"]
    * 4`` or ``["cpu"] * S``.

    Under an initialised process group ``devices`` are this rank's own
    ``L = n_shards / world`` shards (``None``: ``L`` cards from card
    ``local_rank * L`` of this host's visible ones); ``n_shards`` must
    divide by the world size.  Under NCCL the first of them, where this
    rank's shards join, becomes the current card.  Every rank calls this
    together: the ranks exchange the names of their devices.
    """
    n_shards = int(n_shards)
    if n_shards < 1:
        raise ValueError(f"a row mesh needs >= 1 shard, got {n_shards}")
    world = cluster.process_count()
    rank = cluster.process_index()
    if n_shards % world:
        raise ValueError(f"a {n_shards}-shard row mesh does not divide over "
                         f"{world} processes")
    local = n_shards // world
    if devices is None:
        devices = _rank_cards(local, world)
    devs = tuple(canonical_device(resolve_device(d)) for d in devices)
    if len(devs) != local:
        raise ValueError(f"a {n_shards}-shard row mesh needs {local} devices "
                         f"a process ({world} processes), got {len(devs)}")
    if world == 1:
        return RowMesh(devices=devs, homes=tuple(_home(d) for d in devs))
    backend = torch.distributed.get_backend()
    if backend == "nccl" and devs[0].type == "cuda":
        torch.cuda.set_device(devs[0])
    homes: List[Optional[list]] = [None] * world
    torch.distributed.all_gather_object(homes, [_home(d) for d in devs])
    all_devs: List[Optional[torch.device]] = [None] * n_shards
    all_devs[rank * local:(rank + 1) * local] = devs
    return RowMesh(devices=tuple(all_devs),
                   homes=tuple(h for hs in homes for h in hs),
                   rank=rank, world=world, backend=backend)


# -- the LM's meshes ----------------------------------------------------------

def _named_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
                device_type: str, hint: str):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the first
    prod(shape) ranks of the initialised process group."""
    from torch.distributed.device_mesh import DeviceMesh
    n = math.prod(shape)
    have = (torch.distributed.get_world_size()
            if torch.distributed.is_initialized() else 1)
    if have < n:
        raise RuntimeError(f"need {n} devices for mesh {shape}, have {have}"
                           f" -- {hint}")
    if device_type == "cuda" and torch.cuda.is_available():
        # Rank r on card r % cards: every rank on cuda:0 with one card.
        rank = torch.distributed.get_rank()
        torch.cuda.set_device(rank % torch.cuda.device_count())
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16x16 ``(data, model)`` for one pod; 2x16x16 ``(pod, data, model)``
    for two pods, over the first prod(shape) ranks of the process group
    (raises with fewer)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _named_mesh(shape, axes, device_type,
                       "initialise a process group of that many ranks "
                       "(a 'fake' group builds it without devices)")


def make_debug_mesh(n_data: int = 2, n_model: int = 2,
                    multi_pod: bool = False, device_type: str = "cuda"):
    """A small mesh for sharding tests: ``(n_data, n_model)``, or
    ``(2, n_data, n_model)`` with a pod axis."""
    shape = (2, n_data, n_model) if multi_pod else (n_data, n_model)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _named_mesh(shape, axes, device_type,
                       "initialise a process group of that many ranks "
                       "(run_threaded gives one in threads)")


def run_threaded(world_size: int, fn: Callable[[int], Any],
                 timeout: float = 600.0) -> List[Any]:
    """``fn(rank)`` on each rank of a ``"threaded"`` process group of
    ``world_size`` ranks (threads of this process); returns the results
    in rank order.  The first rank's exception is raised after every
    thread has stopped (a failing rank wakes the others' collectives)."""
    from torch.testing._internal.distributed import multi_threaded_pg as mt
    c10d = torch.distributed
    results: List[Any] = [None] * world_size
    errors: List[Optional[BaseException]] = [None] * world_size
    torch._C._distributed_c10d._set_thread_isolation_mode(True)
    world = mt._install_threaded_pg()
    if not hasattr(world, "comms"):
        # Some torch releases' thread-local world lacks the list that
        # ``destroy_process_group`` empties; it never holds anything here.
        world.comms = []
    store = c10d.HashStore()
    failing = threading.Lock()

    def worker(rank: int) -> None:
        c10d.init_process_group("threaded", rank=rank,
                                world_size=world_size, store=store)
        try:
            results[rank] = fn(rank)
        except BaseException as e:       # re-raised on the caller's thread
            errors[rank] = e
            with failing:       # wake the ranks waiting in a collective
                try:
                    mt.ProcessLocalGroup.exception_handle(e)
                except RuntimeError:    # a collective started meanwhile
                    pass
        finally:
            if c10d.distributed_c10d._world is world:
                c10d.destroy_process_group()

    threads = [threading.Thread(target=worker, args=(r,), daemon=True)
               for r in range(world_size)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout)
        if any(t.is_alive() for t in threads):
            raise TimeoutError(f"threaded ranks still running after "
                               f"{timeout} s")
    finally:
        mt.ProcessLocalGroup.reset()
        mt._uninstall_threaded_pg()
        torch._C._distributed_c10d._set_thread_isolation_mode(False)
    for e in errors:
        if e is not None:
            raise e
    return results
