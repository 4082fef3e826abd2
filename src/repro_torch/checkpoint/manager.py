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
card, raising without one).  The reference's ``shardings=`` waits for
the port's sharding (ROADMAP item 14).
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
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        a = t.numpy()
    else:
        a = np.array(x)
    return a, str(a.dtype)


def _from_file(path: pathlib.Path, dtype: str) -> torch.Tensor:
    a = np.load(path)
    if dtype == BF16:
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(a)


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
        """Snapshot now; write in the background unless blocking."""
        t0 = time.perf_counter()
        host = {k: _to_host(v) for k, v in _flatten(tree).items()}
        snapshot_s = time.perf_counter() - t0
        self.wait()
        self.last_save = {"snapshot_s": snapshot_s}
        if self.async_write and not blocking:
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, host)

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
                device: DeviceLike = None) -> Tuple[Any, int]:
        """Restore into the structure of ``like`` (a ``CausalLM`` comes
        back as a new one, as trainable as ``like``).  Each leaf keeps the
        dtype it was saved with and goes to the device of ``like``'s leaf,
        or to ``device`` where ``like``'s leaf is not a tensor.  Returns
        (tree, step)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:09d}"
        with open(d / "manifest.json") as f:
            manifest = json.load(f)["arrays"]
        flat_like = _flatten(like)
        dev = None
        loaded = {}
        for key, leaf in flat_like.items():
            if key not in manifest:
                raise KeyError(f"checkpoint missing array {key}")
            if isinstance(leaf, torch.Tensor):
                target = leaf.device
            else:
                dev = dev or resolve_device(device)
                target = dev
            loaded[key] = _from_file(d / manifest[key]["file"],
                                     manifest[key]["dtype"]).to(target)
        return _rebuild(like, loaded), step
