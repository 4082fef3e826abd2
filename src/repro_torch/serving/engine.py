"""Serving engine (port of ``repro.serving.engine``): batched decode over a
fixed pool of slots.

Continuous-batching-lite: finished requests free their slot and queued
prompts are prefilled into it (cache rows are per slot, so admission is a
cache write).  Greedy sampling (argmax) keeps the engine deterministic;
the sampler is pluggable (a function of the (n_slots, V) logits tensor
returning (n_slots,) token ids).  The cache lives on the model's device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.models import model
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class Request:
    prompt: np.ndarray            # (S,) int32
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, -1)


class Engine:
    def __init__(self, cfg: ModelConfig, params: model.CausalLM, *,
                 max_seq: int, n_slots: int,
                 sampler: Optional[Callable] = None):
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.n_slots = n_slots
        self.sampler = sampler or greedy
        self.device = params.device
        self.caches = model.init_cache(cfg, n_slots, max_seq,
                                       device=self.device)
        self.slot_pos = np.zeros(n_slots, np.int32)
        self.slot_req: List[Optional[Request]] = [None] * n_slots

    def _decode(self, toks: np.ndarray) -> torch.Tensor:
        logits, self.caches = model.decode_step(
            self.cfg, self.params, self.caches, toks, self.slot_pos.copy())
        return logits

    # -- admission -----------------------------------------------------------
    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slot_req):
            if r is None:
                return i
        return None

    def add(self, req: Request) -> bool:
        if len(req.prompt) == 0:
            # A zero-length prompt has no logits to seed decoding from.
            raise ValueError("empty prompt: at least one token required")
        if len(req.prompt) > self.max_seq - 1:
            # Cache rows past max_seq-1 don't exist.
            raise ValueError(f"prompt length {len(req.prompt)} exceeds "
                             f"max_seq-1 ({self.max_seq - 1})")
        slot = self._free_slot()
        if slot is None:
            return False
        # Per-slot prefill: decode the prompt token by token into the slot's
        # cache rows.  Every decode call writes KV for *all* slots, each at
        # its own position: the admitted slot at its growing prefill
        # position, every other slot at its next free row (slot_pos), where
        # the junk is overwritten by that slot's own next real decode and
        # its causal mask (kv_pos <= pos) never attends it meanwhile.
        for tok in req.prompt:
            toks = np.zeros((self.n_slots, 1), np.int32)
            toks[slot, 0] = tok
            logits = self._decode(toks)
            self.slot_pos[slot] += 1
        self.slot_req[slot] = req
        req._last_logits = logits[slot].cpu().numpy()  # type: ignore
        return True

    # -- decode --------------------------------------------------------------
    def step(self) -> None:
        """One batched decode step across all active slots."""
        toks = np.zeros((self.n_slots, 1), np.int32)
        active = []
        for i, r in enumerate(self.slot_req):
            if r is None or r.done:
                continue
            last = r.out[-1] if r.out else int(
                np.argmax(r._last_logits))  # type: ignore
            if not r.out:
                r.out.append(last)
            toks[i, 0] = r.out[-1]
            active.append(i)
        if not active:
            return
        # Per-slot positions: slots admitted with shorter prompts sit at
        # lower positions than their neighbours.
        nxt = self.sampler(self._decode(toks)).cpu().numpy()
        for i in active:
            r = self.slot_req[i]
            r.out.append(int(nxt[i]))
            self.slot_pos[i] += 1
            if len(r.out) >= r.max_new or self.slot_pos[i] >= self.max_seq - 1:
                r.done = True
                self.slot_req[i] = None
                # Reset the freed slot to position 0: the next admission
                # prefills from the start, and the causal mask hides the
                # previous occupant's stale KV rows until overwritten.
                self.slot_pos[i] = 0

    @torch.no_grad()
    def run(self, requests: List[Request], max_steps: int = 10_000) -> None:
        queue = list(requests)
        steps = 0
        while (queue or any(self.slot_req)) and steps < max_steps:
            while queue and self.add(queue[0]):
                queue.pop(0)
            self.step()
            steps += 1


@torch.no_grad()
def generate_greedy(cfg: ModelConfig, params: model.CausalLM,
                    prompts: np.ndarray, max_new: int,
                    max_seq: int) -> np.ndarray:
    """Batched prefill + greedy decode.

    prompts: (B, S) int32 -> (B, max_new) int32 greedy continuations.
    """
    B, S = prompts.shape
    caches = model.init_cache(cfg, B, max_seq, device=params.device)
    logits, caches = model.prefill(cfg, params, {"tokens": prompts}, caches)
    tok = torch.argmax(logits, -1)[:, None]
    out = []
    for t in range(max_new):
        out.append(tok[:, 0])
        logits, caches = model.decode_step(cfg, params, caches, tok, S + t)
        tok = torch.argmax(logits, -1)[:, None]
    return torch.stack(out, 1).cpu().numpy().astype(np.int32)
