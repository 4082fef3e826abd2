"""The one general generator: every input of a cell, made from ``--seed``.

A configuration fixes the reference (its length and the fragment and read
widths); a traffic mix fixes what arrives.  Both are data files; this
module reads their keys and nothing else decides what a cell sends:

* ``reference_codes`` / ``fold``: the seeded reference, drawn on the
  device in one call, folded into overlapping rows as the paper lays a
  reference out (adjacent rows overlap by ``read_chars - 1``);
* ``Requests``: reads drawn from random rows and offsets of the corpus,
  with ``substitutions`` changed codes and ``wildcards`` positions made
  ``N`` (accept any base), in blocks whose content depends only on the
  seed and the block's index, so the i-th request of a seed is the same
  however many a run sends.

Every seed gets the same sizes and the same mix; only the content moves.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

BLOCK_REQUESTS = 4096


def sub_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for one named stream of ``seed`` (any whole number)."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, *stream))


def device_randint(n: tuple, high: int, seed: int, device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randint(0, high, n, generator=g, device=device,
                         dtype=torch.uint8)


def reference_codes(config: dict, seed: int, device) -> torch.Tensor:
    """(reference_bp,) uint8 codes 0..3, uniform, on ``device``."""
    return device_randint((int(config["reference_bp"]),), 4,
                          sub_seed(seed, 0), device)


def fold(codes: torch.Tensor, fragment_chars: int,
         read_chars: int) -> torch.Tensor:
    """(n_rows, F) rows: row r holds codes [r*step, r*step + F) with
    step = F - (P - 1), the tail padded with code 0."""
    F, P = int(fragment_chars), int(read_chars)
    step = F - (P - 1)
    n = codes.shape[0]
    n_rows = max(1, -(-max(n - (P - 1), 1) // step))
    need = (n_rows - 1) * step + F
    if need > n:
        codes = torch.cat([codes, codes.new_zeros(need - n)])
    return codes[:need].unfold(0, F, step).contiguous()


class Requests:
    """The i-th request of a mix: a read, its row and offset, and how it
    is asked (codes or accept masks, reduction, threshold)."""

    def __init__(self, traffic: dict, config: dict, frags: np.ndarray,
                 seed: int, stream: int):
        self.traffic = traffic
        self.frags = frags
        self.P = int(config["read_chars"])
        self.seed = seed
        self.stream = stream
        self._blocks: Dict[int, dict] = {}

    def block(self, b: int) -> dict:
        out = self._blocks.get(b)
        if out is None:
            out = self._blocks[b] = self._make(b)
        return out

    def _make(self, b: int) -> dict:
        t, P, B = self.traffic, self.P, BLOCK_REQUESTS
        R, F = self.frags.shape
        r = rng(self.seed, 1, self.stream, b)
        rows = r.integers(0, R, B)
        offs = r.integers(0, F - P + 1, B)
        codes = self.frags[rows[:, None], offs[:, None] + np.arange(P)]
        smin, smax = t.get("substitutions", (0, 0))
        n_sub = r.integers(smin, smax + 1, B)
        if smax:
            pos = np.argsort(r.random((B, P)), 1)[:, :smax]
            bump = r.integers(1, 4, (B, smax)).astype(np.uint8)
            hit = np.arange(smax)[None, :] < n_sub[:, None]
            ii = np.broadcast_to(np.arange(B)[:, None], pos.shape)
            codes[ii[hit], pos[hit]] = (codes[ii[hit], pos[hit]]
                                        + bump[hit]) % 4
        masks = None
        w = int(t.get("wildcards", 0))
        if w:
            masks = (np.uint8(1) << codes).astype(np.uint8)
            wpos = np.argsort(r.random((B, P)), 1)[:, :w]
            masks[np.arange(B)[:, None], wpos] = 0b1111
        return {"rows": rows, "offs": offs, "codes": codes, "masks": masks,
                "n_sub": n_sub}

    def get(self, i: int) -> dict:
        blk = self.block(i // BLOCK_REQUESTS)
        j = i % BLOCK_REQUESTS
        return {"codes": blk["codes"][j],
                "masks": None if blk["masks"] is None else blk["masks"][j],
                "row": int(blk["rows"][j]), "off": int(blk["offs"][j])}

    def sampled(self, i: int) -> bool:
        """Whether request i's answer is kept for the check: one in
        ``check_every``, drawn from the seed."""
        every = int(self.traffic["check_every"])
        blk = self.block(i // BLOCK_REQUESTS)
        if "keep" not in blk:
            blk["keep"] = rng(self.seed, 2, self.stream,
                              i // BLOCK_REQUESTS).integers(
                                  0, every, BLOCK_REQUESTS) == 0
        return bool(blk["keep"][i % BLOCK_REQUESTS])
