"""RG-LRU recurrent block (port of ``repro.models.rglru``; Griffin /
RecurrentGemma, arXiv:2402.19427).

Recurrence: with r_t = sigma(W_a x_t + b_a), i_t = sigma(W_x x_t + b_x),

    log a_t = -c * softplus(Lambda) * r_t
    h_t     = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The block is x -> [linear -> conv1d(4) -> RG-LRU] * gelu(linear) -> out
projection.  Gates and recurrence run in f32; the carried ``h`` is stored
in bf16 between calls, as the reference stores it.

Where the reference runs the full-sequence recurrence as a
``lax.associative_scan`` over time, the port runs the same ``combine``
as a log-depth (Hillis-Steele) scan of plain tensor ops: ceil(log2 S)
rounds of four launches, where a loop over steps would launch S times
(the decode step is the one-step update).  The sums associate in another
order than the reference's scan, so the two agree within f32 rounding
(``tests/test_models.py::TestRGLRU``'s 2e-3 on the core).

Caches are updated in place, like the attention caches: every call with
a cache writes every row's ``conv`` and ``h``, as the reference returns
them for every row.

On a mesh whose rules shard ``ff`` (the ``"2d"`` rules) the block runs
on each rank's block of r/m channels (``rglru_mix`` under
``layers.on_channel_block``): the projections, the convolution, the
recurrence and the cache are channel-local, and so are block-diagonal
gates whose blocks lie whole on a rank.  A gate output whose inputs lie
on other ranks (a dense gate, or a block that straddles ranks) is formed
on the rank that holds it, from every rank's channels (one all-gather of
the branch input for both gates) and its columns of the gate (a dense
gate's rows, as the rules place them, brought to columns by an
all-to-all): one device's products and sums for that output.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .config import ModelConfig
from .layers import COMPUTE_DTYPE, _gelu_tanh
from .spec import P
from .ssm import _causal_conv, _softplus


def rglru_specs(cfg: ModelConfig) -> Dict[str, P]:
    d = cfg.d_model
    r = cfg.rnn_width or d
    nb = cfg.rglru_block_diag
    if nb:
        def gate():
            return P((nb, r // nb, r // nb), ("ff", None, None))
    else:
        def gate():
            return P((r, r), ("ff", None))
    return {
        "wx": P((d, r), ("embed", "ff")),
        "wy": P((d, r), ("embed", "ff")),
        "conv": P((4, r), (None, "ff"), "normal"),
        "w_a": gate(),
        "b_a": P((r,), ("ff",), "zeros"),
        "w_i": gate(),
        "b_i": P((r,), ("ff",), "zeros"),
        "lam": P((r,), ("ff",), "ones"),
        "wo": P((r, d), ("ff", "embed")),
    }


def _gates(x: torch.Tensor, p, group=None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The r and i gates' pre-activations, x @ w_a and x @ w_i (B,S,c) in
    x's dtype (dense or block-diagonal), for x's c channels: all r off a
    mesh, a rank's block on one (``group``, its ``layers.ChannelGroup``).
    A rank holds a dense gate's rows (c, r) and the blocks that lie whole
    on it, or every block where they straddle ranks.  Outputs whose
    inputs are all the rank's are formed locally; the others from every
    rank's channels and the gate's columns (``_columns``)."""
    w_a, w_i = p["w_a"], p["w_i"]
    if group is None or _local_gate(w_a, x.shape[-1]):
        return _local_product(x, w_a), _local_product(x, w_i)
    xf = group.gather(x, 2)                             # (B,S,r)
    c0, c = group.rank * x.shape[-1], x.shape[-1]
    return (_columns(xf, w_a, c0, c, group),
            _columns(xf, w_i, c0, c, group))


def _local_gate(w: torch.Tensor, c: int) -> bool:
    """Gate ``w`` maps c channels to themselves: a square dense gate, or
    whole blocks covering them."""
    if w.ndim == 3:
        return w.shape[0] * w.shape[1] == c
    return w.shape[0] == w.shape[1] == c


def _local_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B,S,c) @ w for a gate local to x's channels."""
    if w.ndim == 3:
        B, S, c = x.shape
        n, k = w.shape[0], w.shape[1]
        out = torch.einsum("bsnk,nkj->bsnj", x.reshape(B, S, n, k),
                           w.to(x.dtype))
        return out.reshape(B, S, c)
    return x @ w.to(x.dtype)


def _columns(xf: torch.Tensor, w: torch.Tensor, c0: int, c: int,
             group) -> torch.Tensor:
    """Outputs c0 .. c0 + c of xf (B,S,r) @ w: w a dense gate's rows
    (c, r) this rank holds, brought to its columns (r, c) by an
    all-to-all, or the whole block-diagonal gate (n, k, k), each block
    the outputs reach on its own inputs."""
    if w.ndim == 2:
        return xf @ group.columns(w.to(xf.dtype))
    k = w.shape[1]
    outs = []
    for b in range(c0 // k, (c0 + c - 1) // k + 1):
        lo, hi = max(c0, b * k), min(c0 + c, (b + 1) * k)
        outs.append(xf[..., b * k:(b + 1) * k]
                    @ w[b, :, lo - b * k:hi - b * k].to(xf.dtype))
    return torch.cat(outs, -1) if len(outs) > 1 else outs[0]


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0: the inclusive
    scan of the reference's ``combine`` ((a1, b1), (a2, b2)) -> (a2 a1,
    a2 b1 + b2), Hillis-Steele, four launches a round."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:],
                                               b[:, :-d])], 1)
        if 2 * d < S:      # the last round reads no a
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], 1)
        d *= 2
    return b


def _rglru_core(cfg: ModelConfig, p, x: torch.Tensor,
                h0: Optional[torch.Tensor], c: float, mode: str,
                group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,c) branch input, its c channels (all of them, or a rank's
    block: ``group``); returns (h (B,S,c) in x's dtype, h_last (B,c)
    f32)."""
    g_a, g_i = _gates(x, p, group)
    r_gate = torch.sigmoid(g_a.float() + p["b_a"])
    i_gate = torch.sigmoid(g_i.float() + p["b_i"])
    log_a = -c * _softplus(p["lam"]) * r_gate               # (B,S,c) f32
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                       1e-12)) * i_gate * x.float()

    if mode == "decode":
        h = a[:, 0] * (h0 if h0 is not None else 0.0) + gated[:, 0]
        return h[:, None].to(x.dtype), h

    if h0 is not None:
        # Fold the carried state in as a virtual step 0.
        a = torch.cat([torch.ones_like(a[:, :1]), a], 1)
        gated = torch.cat([h0[:, None], gated], 1)
    hh = _linear_scan(a, gated)
    if h0 is not None:
        hh = hh[:, 1:]
    return hh.to(x.dtype), hh[:, -1]


def rglru_mix(cfg: ModelConfig, p, x: torch.Tensor, cache=None, group=None,
              *, mode: str) -> torch.Tensor:
    """The recurrent block up to its output projection: x (B,S,d) -> the
    gated branch (B,S,c) for the c channels ``p``'s channel leaves hold
    (all r, or a rank's block: ``group``, ``layers.on_channel_block``);
    ``cache``'s ``conv`` and ``h`` (those channels) overwritten."""
    xb = x @ p["wx"].to(x.dtype)
    yb = _gelu_tanh(x @ p["wy"].to(x.dtype))
    xb, new_conv = _causal_conv(xb, p["conv"],
                                cache["conv"] if cache else None)
    h0 = cache["h"].float() if cache else None
    hh, h_last = _rglru_core(cfg, p, xb, h0, cfg.rglru_c, mode, group)
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["h"].copy_(h_last)           # rounds to bf16, as astype does
    return hh * yb


def rglru_apply(cfg: ModelConfig, p, x: torch.Tensor, *, mode: str,
                cache: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Full recurrent block.  x (B,S,d) -> (y (B,S,d), cache): the cache
    passed in, its ``conv`` and ``h`` overwritten (None without one)."""
    out = rglru_mix(cfg, p, x, cache, mode=mode) @ p["wo"].to(x.dtype)
    return out, cache


def rglru_cache_specs(cfg: ModelConfig, batch: int) -> Dict[str, P]:
    r = cfg.rnn_width or cfg.d_model
    return {
        "conv": P((batch, 3, r), ("batch", None, "ff"), "zeros",
                  COMPUTE_DTYPE),
        "h": P((batch, r), ("batch", "ff"), "zeros", COMPUTE_DTYPE),
    }
