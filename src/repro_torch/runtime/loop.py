"""Training loop (port of ``repro.runtime.loop``): metrics, step watchdog
(straggler mitigation), preemption-safe checkpointing, auto-resume.

Straggler policy (DESIGN.md Sec. 5): step wall-times feed a rolling median;
a step exceeding ``watchdog_factor x median`` raises a StragglerEvent which
the loop handles by (a) recording it, (b) forcing a non-blocking checkpoint
so a drop-and-reshard restart loses no work.

A step is timed from before ``step_hook`` to the loss's ``.item()``, which
waits for the device, as the reference times it to ``float(loss)``.  The
loop runs on the card unless the caller passes ``device="cpu"``; the
parameters are seeded with ``rng_seed`` on that device (JAX's PRNG stream
is not reproduced, so the port's run starts from other weights than the
reference's).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.runtime import steps


@dataclasses.dataclass
class StragglerEvent:
    step: int
    step_time: float
    median_time: float


@dataclasses.dataclass
class TrainResult:
    losses: List[float]
    step_times: List[float]
    straggler_events: List[StragglerEvent]
    final_step: int


def train(cfg: ModelConfig, opt_cfg: adamw.OptConfig, data, n_steps: int,
          *, ckpt: Optional[CheckpointManager] = None,
          ckpt_every: int = 50, log_every: int = 10,
          watchdog_factor: float = 5.0,
          rng_seed: int = 0,
          step_hook: Optional[Callable[[int], None]] = None,
          log: Callable[[str], None] = print,
          device: DeviceLike = None) -> TrainResult:
    """Single-process training loop (examples + integration tests).

    Auto-resumes from the newest checkpoint in ``ckpt`` if one exists.
    ``step_hook`` is a test seam (e.g. to inject a straggler delay).
    """
    dev = resolve_device(device)
    params = model.init_params(cfg, rng_seed, device=dev, trainable=True)
    opt_state = adamw.init(params)
    start_step = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        (params, opt_state), start_step = ckpt.restore((params, opt_state))
        log(f"[resume] restored checkpoint at step {start_step}")

    train_step = steps.make_train_step(cfg, opt_cfg)

    losses: List[float] = []
    times: List[float] = []
    events: List[StragglerEvent] = []
    step = start_step
    for step in range(start_step, n_steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in data.batch_at(step).items()}
        t0 = time.perf_counter()
        if step_hook is not None:
            step_hook(step)
        params, opt_state, metrics = train_step(params, opt_state, batch)
        loss = metrics["loss"].item()
        dt = time.perf_counter() - t0
        losses.append(loss)
        times.append(dt)
        if len(times) >= 5:
            med = float(np.median(times[-50:]))
            if dt > watchdog_factor * med:
                ev = StragglerEvent(step, dt, med)
                events.append(ev)
                log(f"[watchdog] step {step} took {dt:.3f}s "
                    f"(median {med:.3f}s) -- snapshotting for reshard")
                if ckpt is not None:
                    ckpt.save(step + 1, (params, opt_state))
        if log_every and step % log_every == 0:
            log(f"step {step:5d}  loss {loss:.4f}  {dt*1e3:7.1f} ms"
                f"  lr {metrics['lr'].item():.2e}")
        if ckpt is not None and ckpt_every and (step + 1) % ckpt_every == 0:
            ckpt.save(step + 1, (params, opt_state))
    if ckpt is not None:
        ckpt.save(n_steps, (params, opt_state), blocking=True)
    return TrainResult(losses, times, events, step + 1)
