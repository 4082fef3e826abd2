"""Mamba-2 SSD block (port of ``repro.models.ssm``; state-space duality,
arXiv:2405.21060), and the depthwise causal convolution it shares with
the RG-LRU block.

Full mode is the chunked SSD algorithm: the quadratic attention-like form
*within* chunks, then a linear recurrence *across* chunks.  Decode is the
O(1) recurrent state update.  The casting points are the reference's
(projections in bf16, ``dt`` and the decays in f32, the intra-chunk
product in bf16), with two differences of form:

* The reference runs the inter-chunk recurrence ``h_n = a_n h_{n-1} +
  s_n`` as a ``lax.scan`` over chunks.  The port runs its closed form:
  one product with the (nc+1) x (nc+1) matrix of decays ``exp(C_n -
  C_j)``, the carried ``h0`` as source 0, so the launches do not grow
  with the number of chunks.  Its f32 sums associate in another order.
* The intra-chunk decay ``exp(La_i - La_j)`` is positive above the
  diagonal and overflows to ``inf`` at full width (a 256-token chunk at
  ``dt ~ 0.7`` reaches ``exp(+180)``); the reference's ``jnp.where``
  discards it.  The port masks the exponent with ``-inf`` before the
  ``exp``, here and in the inter-chunk decays, so no ``inf`` (and no
  ``inf * 0``) ever forms.

The state's dtype changes in the reference: a full-mode call stores it in
bf16 (``h_final.astype(bf16)``), and a decode step computes ``h * a`` with
``a`` in f32, so its cache comes back f32.  The port's caches are
updated in place, so its ``state`` leaf is f32 throughout: full mode
stores the bf16-rounded values, decode stores f32.  A decode step on a
state the reference holds in bf16 also rounds its ``dBx`` update to bf16
(``dBx.astype(h.dtype)``); the cache tree carries that fact in a host
flag, ``STATE_BF16`` (``repro_torch.models.model.init_cache``), so every
step's values are the reference's.

On a mesh whose rules shard ``heads_inner`` (the ``"2d"`` rules) the
block runs on each rank's block of the inner channels (``ssd_mix`` under
``layers.on_channel_block``), as the heads those channels touch: every
head's whole where ``heads`` shards over the same dim (its ``dt``, decay,
``D`` and ``state`` local), else (mamba2's 24 heads over 16 ranks: 96
channels, a head and a half) the per-head leaves and the ``state``
replicate, and the rank runs the two heads its channels reach, the
other channels of those heads zero and dropped.  B and C replicate
(their specs say so), so every rank forms the same C.B product.  The
gated RMSNorm's mean runs over all ``di`` channels: the f32 sums of
squares are summed across the dim.  The ``conv`` cache (and a replicated
``state``) is written whole on every rank: its B and C channels as every
rank computed them, its inner channels gathered.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import COMPUTE_DTYPE, _logistic
from .spec import P

# Top-level key of a cache tree holding SSD layers: a 0-d bool tensor on
# the host, True while the reference would hold the state in bf16 (the
# cache is fresh or was last written by a full-mode call).
STATE_BF16 = "ssd_state_bf16"


def _d_inner(cfg: ModelConfig) -> int:
    return cfg.ssd_heads * cfg.ssm_head_dim


def ssd_specs(cfg: ModelConfig) -> Dict[str, P]:
    d, N, H = cfg.d_model, cfg.ssm_state, cfg.ssd_heads
    di = _d_inner(cfg)
    kc = cfg.ssm_conv
    return {
        "wz": P((d, di), ("embed", "heads_inner")),
        "wx": P((d, di), ("embed", "heads_inner")),
        "wB": P((d, N), ("embed", None)),
        "wC": P((d, N), ("embed", None)),
        "wdt": P((d, H), ("embed", "heads")),
        "dt_bias": P((H,), ("heads",), "zeros"),
        "A_log": P((H,), ("heads",), "zeros"),
        "D": P((H,), ("heads",), "ones"),
        "conv_x": P((kc, di), (None, "heads_inner"), "normal"),
        "conv_B": P((kc, N), (None, None), "normal"),
        "conv_C": P((kc, N), (None, None), "normal"),
        "norm": P((di,), ("heads_inner",), "ones"),
        "wo": P((di, d), ("heads_inner", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv, kernel k.  x (B,S,C), w (k,C).  ``state``
    (B,k-1,C) holds the trailing context for decode; returns (y,
    new_state), ``new_state`` a view of the padded input.

    The taps add in the reference's order, each product and each partial
    sum rounded to x's dtype: ``0 + t0 + t1 + ... + t(k-1)`` (its Python
    ``sum``; the leading 0 changes nothing)."""
    k = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], k - 1, x.shape[-1]))
    xp = torch.cat([state, x], 1)
    S = x.shape[1]
    wx = w.to(x.dtype)
    y = xp[:, :S] * wx[0]
    for i in range(1, k):
        y = y + xp[:, i:i + S] * wx[i]
    return y, xp[:, -(k - 1):]


def _silu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.silu op for op, as the port's MLP traces it.
    return x * _logistic(x)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is logaddexp(x, 0).
    return torch.logaddexp(x, torch.zeros_like(x))


def _masked_exp(diff: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """exp(diff) where ``keep``, exactly 0 elsewhere; the masked entries
    never reach the exp (they may be large and positive)."""
    return torch.exp(torch.where(keep, diff, -math.inf))


def _chunk_states(w: torch.Tensor, Bc: torch.Tensor,
                  xc: torch.Tensor) -> torch.Tensor:
    """einsum("bnch,bncm,bnchp->bnhpm") of bf16 operands, contracted in
    the reference's order: its einsum takes the pair whose product is
    smaller first (``w * xc`` when the head width is under the state
    width, else the outer product ``Bc x w``; a tie takes the latter), and
    each step rounds to bf16."""
    P_, N = xc.shape[-1], Bc.shape[-1]
    if P_ < N:
        wx = w[..., None] * xc                                  # (b,n,c,h,p)
        return torch.einsum("bnchp,bncm->bnhpm", wx, Bc)
    bw = Bc[..., :, None] * w[..., None, :]                     # (b,n,c,m,h)
    return torch.einsum("bnchp,bncmh->bnhpm", xc, bw)


def _head_shared(Cc: torch.Tensor, Bc: torch.Tensor):
    """What every head of a chunked call shares: C.B within each chunk
    (B,nc,c,c) f32, the causal mask within a chunk (c,c,1) and the one
    across the nc + 1 chunk boundaries (nc+1,nc+1,1)."""
    nc, c = Cc.shape[1], Cc.shape[2]
    G = torch.matmul(Cc.float(), Bc.float().transpose(-1, -2))
    ii = torch.arange(c, device=Cc.device)
    jj = torch.arange(nc + 1, device=Cc.device)
    return (G, (ii[:, None] >= ii[None, :])[:, :, None],
            (jj[:, None] >= jj[None, :])[:, :, None])


def _ssd_chunked(cfg: ModelConfig, xs, Bv, Cv, dt, log_a, D,
                 h0: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The full-mode core.  xs (B,S,H,Pd) bf16; Bv, Cv (B,S,N) bf16; dt,
    log_a (B,S,H) f32; D (H,); h0 (B,H,Pd,N) f32 or None.  Returns (y
    (B,S,H,Pd) f32, the final state (B,H,Pd,N) f32)."""
    B, S, H, Pd = xs.shape
    N = Bv.shape[-1]
    c = min(cfg.ssm_chunk, S)
    nc = S // c
    if nc * c != S:
        raise AssertionError("seq must divide ssm_chunk")
    xc = xs.reshape(B, nc, c, H, Pd)
    Bc = Bv.reshape(B, nc, c, N)
    Cc = Cv.reshape(B, nc, c, N)
    dtc = dt.reshape(B, nc, c, H)
    La = torch.cumsum(log_a.reshape(B, nc, c, H), 2)           # (B,nc,c,H)

    # Intra-chunk: the quadratic ("duality") form.
    intra = COMPUTE_DTYPE if cfg.ssd_bf16_intra else torch.float32
    G, causal, chunks = _head_shared(Cc, Bc)
    G = G.to(intra)
    decay = _masked_exp(La[:, :, :, None, :] - La[:, :, None, :, :],
                        causal).to(intra)                       # (B,nc,c,c,H)
    M = G[..., None] * decay * dtc[:, :, None, :, :].to(intra)
    y_intra = torch.einsum("bnijh,bnjhp->bnihp", M.to(COMPUTE_DTYPE),
                           xc.to(COMPUTE_DTYPE))

    # Chunk states, then the inter-chunk recurrence in closed form.
    tail = torch.exp(La[:, :, -1:, :] - La)                     # (B,nc,c,H)
    states = _chunk_states((tail * dtc).to(COMPUTE_DTYPE),
                           Bc.to(COMPUTE_DTYPE), xc.to(COMPUTE_DTYPE))
    if h0 is None:
        h0 = xs.new_zeros((B, H, Pd, N), dtype=torch.float32)
    # Sources j = 0..nc: h0, then chunk j-1's state; outputs n = 0..nc:
    # the state entering chunk n (n = nc: the final state).  The weight
    # of source j in output n is exp(Cx_n - Cx_j) for j <= n, with Cx the
    # chunk decays' cumulative log, 0 first.
    src = torch.cat([h0[:, None], states.float()], 1)           # (B,nc+1,..)
    Cx = torch.cat([La.new_zeros((B, 1, H)),
                    torch.cumsum(La[:, :, -1, :], 1)], 1)       # (B,nc+1,H)
    W = _masked_exp(Cx[:, :, None, :] - Cx[:, None, :, :],
                    chunks)                                     # (B,n,j,H)
    hs = torch.einsum("bnjh,bjhpm->bnhpm", W, src)              # (B,nc+1,..)
    y_inter = torch.einsum("bncm,bnhpm->bnchp", Cc.float(), hs[:, :nc]) \
        * torch.exp(La)[..., None]
    y = y_intra.float() + y_inter + D[:, None] * xc.float()
    return y.reshape(B, S, H, Pd), hs[:, nc]


def ssd_mix(cfg: ModelConfig, p, x: torch.Tensor, cache=None, group=None,
            *, mode: str, state_bf16: bool = True) -> torch.Tensor:
    """The SSD block up to its output projection: x (B,S,d) -> the normed
    gated output (B,S,c) in x's dtype for the c inner channels ``p``'s
    channel leaves hold (all di, or a rank's block: ``group``,
    ``layers.on_channel_block``); ``cache``'s ``conv`` and ``state``
    overwritten.  ``state_bf16``: see ``ssd_apply``.

    Channels c0 .. c0 + c run as the heads they touch, zero-padded to
    whole heads (each channel of a head is independent given the head's
    ``dt``, B and C); the per-head leaves and the ``state`` hold every
    head, or exactly those heads where they shard with the channels."""
    B, S, _ = x.shape
    N, Pd = cfg.ssm_state, cfg.ssm_head_dim
    di = _d_inner(cfg)
    c = p["wx"].shape[-1]
    c0 = group.rank * c if group is not None else 0
    held = 0 if p["A_log"].shape[0] * Pd == di else c0 // Pd
    ha, hb = c0 // Pd, -(-(c0 + c) // Pd)          # the heads touched
    lo, hi = c0 - ha * Pd, hb * Pd - c0 - c        # their other channels
    heads, nh = slice(ha - held, hb - held), hb - ha
    z = x @ p["wz"].to(x.dtype)
    xs = x @ p["wx"].to(x.dtype)
    Bv = x @ p["wB"].to(x.dtype)
    Cv = x @ p["wC"].to(x.dtype)
    dt = _softplus((x @ p["wdt"][:, heads].to(x.dtype)).float()
                   + p["dt_bias"][heads])
    conv = cache["conv"] if cache else None
    if conv is not None and c < di:
        conv = torch.cat([conv[..., c0:c0 + c], conv[..., di:]], -1)
    packed = torch.cat([xs, Bv, Cv], -1)
    wconv = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]], -1)
    packed, new_conv = _causal_conv(packed, wconv, conv)
    packed = _silu(packed)
    xs, Bv, Cv = torch.split(packed, [c, N, N], -1)
    if lo or hi:
        xs = F.pad(xs, (lo, hi))
    A = -torch.exp(p["A_log"][heads])                           # (nh,)
    log_a = dt * A                                              # (B,S,nh) <= 0
    D = p["D"][heads]

    if mode == "decode":
        assert S == 1 and cache is not None
        h = cache["state"][:, heads].float()                    # (B,nh,Pd,N)
        a = torch.exp(log_a[:, 0])                              # (B,nh)
        xh = xs[:, 0].reshape(B, nh, Pd)
        dBx = (dt[:, 0, :, None] * xh.float())[..., None] \
            * Bv[:, 0, None, None, :].float()
        if state_bf16:
            dBx = dBx.to(COMPUTE_DTYPE).float()
        h = h * a[:, :, None, None] + dBx
        y = torch.matmul(h, Cv[:, 0, None, :, None].float())[..., 0]
        y = y + D[None, :, None] * xh.float()
        y = y.reshape(B, 1, nh * Pd).to(x.dtype)
    elif mode == "full":
        h0 = cache["state"][:, heads].float() if cache else None
        y, h = _ssd_chunked(cfg, xs.reshape(B, S, nh, Pd), Bv, Cv, dt,
                            log_a, D, h0)
        y = y.reshape(B, S, nh * Pd).to(x.dtype)
        # Stored as the reference stores it: rounded to bf16.
        h = h.to(COMPUTE_DTYPE)
    else:
        raise ValueError(mode)
    if lo or hi:
        y = y[..., lo:lo + c]
    if cache is not None:
        _write_cache(cache, h, new_conv, c, di, lo, group)

    # Gated RMSNorm (the Mamba-2 block's epilogue) over all di channels.
    y = y * _silu(z)
    y32 = y.float()
    if group is None:
        ms = y32.square().mean(-1, keepdim=True)
    else:
        ms = group.sum(y32.square().sum(-1, keepdim=True)) / di
    return (y32 * torch.rsqrt(ms + 1e-6) * p["norm"]).to(x.dtype)


def _write_cache(cache, h: torch.Tensor, new_conv: torch.Tensor, c: int,
                 di: int, lo: int, group) -> None:
    """The state h (B,nh,Pd,N) of the heads a block's c channels touch
    (channel 0 at ``lo``) and the conv context (B,k-1,c+2N) written:
    where the cache holds more channels than the block ran (replicated
    over the group), every rank's channels gathered into it."""
    state = cache["state"]
    B, nh, Pd, N = h.shape
    if state.shape[1] * Pd == c:
        state.copy_(h)
    else:
        mine = h.reshape(B, nh * Pd, N)[:, lo:lo + c]
        state.copy_(group.gather(mine, 1).reshape(state.shape))
    if c < di:
        cache["conv"][..., :di].copy_(group.gather(new_conv[..., :c], 2))
        cache["conv"][..., di:].copy_(new_conv[..., c:])
    else:
        cache["conv"].copy_(new_conv)


def ssd_apply(cfg: ModelConfig, p, x: torch.Tensor, *, mode: str,
              cache: Optional[Dict] = None, state_bf16: bool = True
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x (B,S,d) -> (y (B,S,d), cache): the cache passed in, its ``conv``
    and ``state`` overwritten (None without one).  ``state_bf16``: the
    reference would hold the cache's state in bf16 (``STATE_BF16``), so a
    decode step rounds its update to bf16 as the reference's does."""
    y = ssd_mix(cfg, p, x, cache, mode=mode, state_bf16=state_bf16)
    return y @ p["wo"].to(x.dtype), cache


def ssd_cache_specs(cfg: ModelConfig, batch: int) -> Dict[str, P]:
    """The reference's SSD cache, but ``state`` is f32 (the reference
    declares bf16 and its decode turns it f32; see the module doc)."""
    H, N, Pd = cfg.ssd_heads, cfg.ssm_state, cfg.ssm_head_dim
    ch = _d_inner(cfg) + 2 * N
    return {
        "conv": P((batch, cfg.ssm_conv - 1, ch), ("batch", None, None),
                  "zeros", COMPUTE_DTYPE),
        "state": P((batch, H, Pd, N), ("batch", "heads", None, None),
                   "zeros", torch.float32),
    }
