"""Speculative decoding with the CRAM-PM n-gram proposer (port of
``repro.serving.speculative``).

Draft-free speculation (prompt-lookup class): the matcher proposes k
continuation tokens from the generation history; the target model
verifies all k in ONE forward at a cache offset (scoring positions
t..t+k), and the longest agreeing prefix is accepted, plus the model's own
next token.  Greedy equivalence is exact: accepted tokens are what
step-by-step decoding would have produced.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.models import model
from repro_torch.models.config import ModelConfig

from .ngram_cache import NgramSpeculator


@dataclasses.dataclass
class SpecStats:
    model_calls: int = 0
    tokens_out: int = 0
    proposed: int = 0
    accepted: int = 0

    @property
    def tokens_per_call(self) -> float:
        return self.tokens_out / max(self.model_calls, 1)

    @property
    def acceptance(self) -> float:
        return self.accepted / max(self.proposed, 1)


class SpeculativeDecoder:
    """Greedy speculative decoding for a single stream.

    Verification runs the full-mode forward over the (k+1)-token window at
    the cache offset: one model call scores every proposed position plus
    the bonus token.  The proposer runs on the model's device.
    """

    def __init__(self, cfg: ModelConfig, params: model.CausalLM, *,
                 max_seq: int, k: int = 4, min_confidence: float = 1.0):
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.k = k
        self.min_confidence = min_confidence
        self.spec = NgramSpeculator(suffix_tokens=4, device=params.device)

    def _verify(self, caches, window: np.ndarray, start: int):
        """window (1, k+1) tokens at positions start..start+k -> greedy
        next token at every position (numpy) + updated caches."""
        logits, caches, _ = model.forward(
            self.cfg, self.params, {"tokens": window}, mode="full",
            caches=caches, cache_index=start)
        return torch.argmax(logits, -1).cpu().numpy(), caches

    @torch.no_grad()
    def generate(self, prompt: np.ndarray, max_new: int
                 ) -> Tuple[np.ndarray, SpecStats]:
        stats = SpecStats()
        caches = model.init_cache(self.cfg, 1, self.max_seq,
                                  device=self.params.device)
        toks = list(int(t) for t in prompt)
        self.spec.feed(toks)
        logits, caches = model.prefill(self.cfg, self.params,
                                       {"tokens": np.asarray([toks])}, caches)
        stats.model_calls += 1
        cur = int(torch.argmax(logits[0]))
        out: List[int] = [cur]
        pos = len(toks)
        while len(out) < max_new and pos + self.k + 1 < self.max_seq:
            prop, conf = self.spec.propose(toks + out, k=self.k)
            if conf >= self.min_confidence and len(prop) == self.k:
                window = np.array([[cur] + [int(t) for t in prop]], np.int32)
                greedy, caches = self._verify(caches, window, pos)
                greedy = greedy[0]
                stats.model_calls += 1
                stats.proposed += self.k
                # position i's greedy output is the target token after
                # window[:i+1]; accept while the proposal agrees.
                n_acc = 0
                for i in range(self.k):
                    if int(prop[i]) == int(greedy[i]):
                        n_acc += 1
                    else:
                        break
                stats.accepted += n_acc
                accepted = [int(t) for t in prop[:n_acc]]
                bonus = int(greedy[n_acc])       # model's own next token
                out.extend(accepted + [bonus])
                self.spec.feed(accepted + [bonus])
                pos += n_acc + 1
                cur = bonus
                # The cache holds K/V for all k+1 window positions, but
                # only n_acc+1 are valid; decoding continues at pos
                # (overwrites).
            else:
                logits, caches = model.decode_step(
                    self.cfg, self.params, caches, np.asarray([[cur]]), pos)
                stats.model_calls += 1
                cur = int(torch.argmax(logits[0]))
                out.append(cur)
                self.spec.feed([cur])
                pos += 1
            stats.tokens_out = len(out)
        return np.asarray(out[:max_new]), stats
