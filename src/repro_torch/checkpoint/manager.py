"""Checkpoint manager (port of ``repro.checkpoint.manager``): atomic,
async, auto-resuming, on the reference's on-disk layout.

* **Layout**: ``step_%09d/`` holds one ``.npy`` a leaf and
  ``manifest.json``, keyed by the leaf's ``"/"``-joined path (a
  ``(params, opt_state)`` tuple gives ``0/embed``, ``1/m/...``,
  ``1/step``), so an f32 checkpoint written by either package restores
  in the other.  A bf16 leaf (which has no numpy form) is written as its
  16-bit pattern with ``"dtype": "bfloat16"`` in the manifest, and
  restored by that dtype; the reference's own bf16 files (``np.save`` of
  an ``ml_dtypes`` array, read back as ``|V2``) restore here the same
  way.
* **Atomic**: a step directory is staged as ``step_N.tmp`` and renamed
  only after the manifest is fsync'd; a preempted writer never leaves a
  half-checkpoint that ``restore`` would accept.
* **Async**: ``save`` snapshots every leaf to host memory (a copy, since
  the optimizer then updates the parameters in place) before it hands the
  write to a background thread.
* **Auto-resume**: ``latest_step``/``restore`` pick up the newest
  complete checkpoint.

``restore`` places each leaf on the device of ``like``'s leaf; a leaf
of ``like`` that is not a tensor goes to ``device`` (``None``: the
card, raising without one).  With ``shardings`` (a tree of
``distributed.sharding.NamedSharding``s matching ``like``) every leaf
comes back as a DTensor with those placements on any mesh, whatever mesh
(or none) wrote it: each rank reads only its own block of the file
(``np.load(mmap_mode="r")``).  ``save`` of a tree of DTensors gathers
each leaf whole and writes on rank 0 alone, so a sharded run's
checkpoint restores with or without a mesh; a blocking save returns on
every rank once the checkpoint is on disk.
"""

from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import sharding as _sharding
from repro_torch.distributed.context import is_dtensor
from repro_torch.models.model import CausalLM

BF16 = "bfloat16"


def _items(node):
    """(key, child) pairs of an inner node, or None for a leaf."""
    if isinstance(node, CausalLM):
        node = node.params
    if isinstance(node, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(node)]
    if hasattr(node, "keys"):
        return [(str(k), node[k]) for k in sorted(node.keys())]
    return None


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{"/"-joined path: leaf}, as the reference keys its manifest."""
    items = _items(tree)
    if items is None:
        return {prefix: tree}
    flat: Dict[str, Any] = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return flat


def _rebuild(like, flat: Dict[str, Any], prefix: str = ""):
    """A tree of ``like``'s structure with ``flat``'s leaves."""
    items = _items(like)
    if items is None:
        return flat[prefix]
    kids = {k: _rebuild(v, flat, f"{prefix}/{k}" if prefix else k)
            for k, v in items}
    if isinstance(like, CausalLM):
        trainable = any(p.requires_grad for p in like.parameters())
        return CausalLM(like.cfg, kids, trainable=trainable)
    if isinstance(like, (tuple, list)):
        return type(like)(kids[str(i)] for i in range(len(like)))
    return kids


def _to_host(x) -> Tuple[np.ndarray, str]:
    """(a numpy copy of ``x``, its dtype's name); bf16 as its bits."""
    if isinstance(x, torch.Tensor):
        if is_dtensor(x):
            x = x.full_tensor()
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        a = t.numpy()
    else:
        a = np.array(x)
    return a, str(a.dtype)


def _from_file(path: pathlib.Path, dtype: str,
               sharding=None) -> torch.Tensor:
    """The saved array, or with ``sharding`` a DTensor whose local shard
    is this rank's block of it (only that block is read)."""
    if sharding is None:
        return _to_tensor(np.load(path), dtype)
    a = np.load(path, mmap_mode="r")
    block = _to_tensor(a[_sharding.local_slices(a.shape, sharding)], dtype)
    return _sharding.from_block(block, a.shape, sharding)


def _to_tensor(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == BF16:
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, keep: int = 3,
                 async_write: bool = True):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        # The last save's host snapshot and write times (s) and bytes.
        self.last_save: Dict[str, float] = {}

    # -- write --------------------------------------------------------------
    def save(self, step: int, tree: Any, *, blocking: bool = False) -> None:
        """Snapshot now; write in the background unless blocking.  A
        tree with DTensor leaves is gathered on every rank (each rank
        calls this) and written by rank 0."""
        t0 = time.perf_counter()
        flat = _flatten(tree)
        sharded = any(is_dtensor(v) for v in flat.values())
        host = {k: _to_host(v) for k, v in flat.items()}
        snapshot_s = time.perf_counter() - t0
        self.wait()
        self.last_save = {"snapshot_s": snapshot_s}
        if sharded and torch.distributed.get_rank() != 0:
            pass                    # rank 0 writes
        elif self.async_write and not blocking:
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, host)
        if sharded and blocking:
            torch.distributed.barrier()

    def _write(self, step: int, host: Dict[str, Tuple[np.ndarray, str]]
               ) -> None:
        t0 = time.perf_counter()
        final = self.dir / f"step_{step:09d}"
        tmp = self.dir / f"step_{step:09d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {}
        for key, (arr, dtype) in host.items():
            fname = key.replace("/", "__") + ".npy"
            np.save(tmp / fname, arr)
            manifest[key] = {"file": fname, "shape": list(arr.shape),
                             "dtype": dtype}
        with open(tmp / "manifest.json", "w") as f:
            json.dump({"step": step, "arrays": manifest}, f)
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)          # atomicity boundary
        self._gc()
        self.last_save.update(
            write_s=time.perf_counter() - t0,
            bytes=sum(a.nbytes for a, _ in host.values()))

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    # -- read ----------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.iterdir():
            m = re.fullmatch(r"step_(\d+)", p.name)
            if m and (p / "manifest.json").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None,
                device: DeviceLike = None,
                shardings: Any = None) -> Tuple[Any, int]:
        """Restore into the structure of ``like`` (a ``CausalLM`` comes
        back as a new one, as trainable as ``like``).  Each leaf keeps the
        dtype it was saved with and goes to the device of ``like``'s leaf,
        or to ``device`` where ``like``'s leaf is not a tensor; with
        ``shardings`` (a matching tree of ``NamedSharding``s) it comes
        back as a DTensor placed by its sharding.  Returns (tree,
        step)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:09d}"
        with open(d / "manifest.json") as f:
            manifest = json.load(f)["arrays"]
        flat_like = _flatten(like)
        flat_sh = _flatten(shardings) if shardings is not None else {}
        dev = None
        loaded = {}
        for key, leaf in flat_like.items():
            if key not in manifest:
                raise KeyError(f"checkpoint missing array {key}")
            if shardings is not None:
                loaded[key] = _from_file(d / manifest[key]["file"],
                                         manifest[key]["dtype"],
                                         flat_sh[key])
                continue
            if isinstance(leaf, torch.Tensor):
                target = leaf.device
            else:
                dev = dev or resolve_device(device)
                target = dev
            loaded[key] = _from_file(d / manifest[key]["file"],
                                     manifest[key]["dtype"]).to(target)
        return _rebuild(like, loaded), step
