"""Core LM layers (port of ``repro.models.layers``): norms, RoPE,
memory-bounded causal attention with its KV cache (global and
sliding-window), the MLP, and the GShard-style MoE.

The math is plain PyTorch ops, as the reference's is plain ``jnp`` (no
Pallas kernel sits on this path).  The casting points are the
reference's, so bf16 rounding matches it:

* activations are ``COMPUTE_DTYPE`` (bf16); weights are cast with
  ``.to(x.dtype)`` at each use;
* a projection (``einsum`` of two bf16 operands) rounds its result to
  bf16, as JAX's default does;
* attention scores and the PV product accumulate in f32, where the
  reference passes ``preferred_element_type=f32``: the bf16 operands are
  widened to f32 (each product is exact there) before the product;
* the softmax weights are rounded to the value dtype before the PV
  product (``p.astype(v.dtype)``).

Caches are preallocated tensors updated **in place** (the reference
updates functionally and returns the new tree; the port returns the same
tree).  The semantics are the reference's: a scalar write position is
clamped as ``lax.dynamic_update_slice`` clamps it, every decode call
writes all rows at their own positions, and the causal mask
``kv_pos <= pos`` hides rows past a row's position.

Ported: every branch of the reference -- ``full`` with and without a
cache, the continuation at a cache offset (the speculative verify),
``decode`` with a scalar or per-row index, QKV bias, GQA grouping, the
int8 KV cache (``kv_quant``), the sliding window (block-local on a
cacheless forward whose length the window divides, a windowed scan
otherwise, a windowed mask in decode), bidirectional attention (the
encoder's), cross-attention over an encoder output ``xa`` (its K/V
written to the cross cache at 0 in full mode, read with every position
valid in decode), and the MoE's top-k routing with per-group capacity
(``moe_route``).  Without ``xa`` a cross-attention layer runs the
reference's other branch: causal self-attention over its own cross cache
(the reference's serving path, which never passes an encoder output).

On a mesh (DTensor parameters and activations) a weight is gathered
over the mesh dims that shard the batch at each use and keeps its other
shards (``weight``), the attention core runs on each rank's batch rows
and heads (``_on_shards``), and the MoE, SSD and RG-LRU blocks run on
each rank's batch rows with whole weights (``moe_apply``,
``on_batch_rows``): the same per-row arithmetic as one device's, with
the collectives at the edges.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.distributed.context import is_dtensor
from repro_torch.distributed.sharding import from_local, local_rows

from .config import ModelConfig
from .spec import P

COMPUTE_DTYPE = torch.bfloat16
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_specs(cfg: ModelConfig) -> Dict[str, P]:
    if cfg.norm == "rms":
        return {"scale": P((cfg.d_model,), ("embed",), "ones")}
    return {"scale": P((cfg.d_model,), ("embed",), "ones"),
            "bias": P((cfg.d_model,), ("embed",), "zeros")}


def weight(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A weight cast to ``x``'s dtype for its use on ``x``.  On a mesh it
    is gathered over the mesh dims that shard ``x``'s batch (FSDP's
    gather before use) and keeps its other shards (tensor parallelism),
    so the product with ``x`` needs no other collective on its way in."""
    w = w.to(x.dtype)
    if not (is_dtensor(w) and is_dtensor(x)):
        return w
    from torch.distributed.tensor import Replicate
    placements = [Replicate() if xp.is_shard(0) else wp
                  for wp, xp in zip(w.placements, x.placements)]
    if placements == list(w.placements):
        return w
    return w.redistribute(w.device_mesh, placements)


def project(a: torch.Tensor, w: torch.Tensor,
            eq: Optional[str] = None) -> torch.Tensor:
    """``a @ w`` (or ``einsum(eq, a, w)``) in ``a``'s dtype, ``w`` taken
    by ``weight``.  Where a mesh splits the contraction (tensor
    parallelism's row-parallel projections: ``w`` sharded on its first
    dim), each rank's partial product is formed in f32 and the partials
    are summed in f32 before the one rounding to ``a``'s dtype, as one
    device's product accumulates in f32 and rounds once (bf16 partials,
    each rounded, would add a rounding a layer)."""
    w = weight(w, a)

    def mul(x, y):
        return x @ y if eq is None else torch.einsum(eq, x, y)
    if not (is_dtensor(w) and any(p.is_shard(0) for p in w.placements)):
        return mul(a, w)
    from torch.distributed.tensor import Replicate
    y = mul(a.float(), w.float())
    y = y.redistribute(y.device_mesh, [Replicate() if p.is_partial() else p
                                       for p in y.placements])
    return y.to(a.dtype)


def apply_norm(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    if cfg.norm == "rms":
        var = x32.square().mean(-1, keepdim=True)
        out = x32 * torch.rsqrt(var + 1e-6) * p["scale"]
    else:
        mu = x32.mean(-1, keepdim=True)
        var = x32.var(-1, keepdim=True, correction=0)
        out = (x32 - mu) * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]
    return out.to(COMPUTE_DTYPE)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, H, S, D); positions: (B, S) integer."""
    if theta <= 0:
        return x
    half = x.shape[-1] // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    ang = positions[:, None, :, None].float() * freqs      # (B,1,S,half)
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def attention_specs(cfg: ModelConfig, cross: bool = False) -> Dict[str, Any]:
    d, hd = cfg.d_model, cfg.head_dim
    H, K = cfg.padded_heads, cfg.padded_kv_heads
    specs: Dict[str, Any] = {
        "wq": P((d, H, hd), ("embed", "heads", None)),
        "wk": P((d, K, hd), ("embed", "kv_heads", None)),
        "wv": P((d, K, hd), ("embed", "kv_heads", None)),
        "wo": P((H, hd, d), ("heads", None, "embed")),
    }
    if cfg.qkv_bias and not cross:      # cross-attention carries no bias
        specs["bq"] = P((H, hd), ("heads", None), "zeros")
        specs["bk"] = P((K, hd), ("kv_heads", None), "zeros")
        specs["bv"] = P((K, hd), ("kv_heads", None), "zeros")
    return specs


def _pick_block(skv: int, max_blk: int) -> int:
    """Largest divisor of skv that is <= max_blk."""
    b = min(max_blk, skv)
    while skv % b:
        b -= 1
    return b


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated in f32 (``preferred_element_type=f32``)."""
    return torch.matmul(a.float(), b.float())


def _online_softmax_scan(q, k, v, *, q_offset, block_kv: int,
                         window: Optional[int] = None, bidir: bool = False):
    """Causal attention. q (B,H,Sq,D); k,v (B,K,Skv,D) -> (B,H,Sq,D).
    Never materializes the full score matrix: walks KV blocks with a
    running (max, denom, acc).  ``q_offset`` is (B,) or an int; a
    ``window`` also hides keys ``window`` or more positions back;
    ``bidir`` masks nothing (every query sees every key)."""
    B, H, Sq, D = q.shape
    _, K, Skv, _ = k.shape
    G = H // K
    scale = 1.0 / math.sqrt(D)
    nb = Skv // block_kv
    assert nb * block_kv == Skv, "Skv must be divisible by block_kv"
    dev = q.device
    qg = q.reshape(B, K, G, Sq, D)
    kb = k.reshape(B, K, nb, block_kv, D)
    vb = v.reshape(B, K, nb, block_kv, D)
    q_off = torch.as_tensor(q_offset, dtype=torch.int64, device=dev)
    q_pos = (q_off.reshape(-1, 1)
             + torch.arange(Sq, device=dev)[None, :])       # (B|1, Sq)
    m = torch.full((B, K, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, K, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, K, G, Sq, D), dtype=torch.float32, device=dev)
    for j in range(nb):
        k_j, v_j = kb[:, :, j], vb[:, :, j]
        s = _dot_f32(qg, k_j[:, :, None].transpose(-1, -2)) * scale
        if not bidir:
            kv_pos = j * block_kv + torch.arange(block_kv, device=dev)
            mask = q_pos[:, None, None, :, None] >= kv_pos
            if window is not None:
                mask &= (q_pos[:, None, None, :, None] - kv_pos) < window
            s = torch.where(mask, s, NEG_INF)
        new_m = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - new_m)
        p = torch.exp(s - new_m[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + _dot_f32(p.to(v_j.dtype),
                                               v_j[:, :, None])
        m = new_m
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, H, Sq, D).to(q.dtype)


def _on_shards(core, q, k, v, **kw):
    """``core(q, k, v, **kw)`` (an attention core); on a mesh each rank
    runs it on its own batch rows and heads.  The batch dim keeps its
    shards, the heads dim keeps them where the KV heads divide over them
    (a query head's KV head is on the same rank), every other mesh dim
    replicates; the output is placed as the inputs were brought."""
    if not is_dtensor(q):
        return core(q, k, v, **kw)
    from torch.distributed.tensor import Replicate
    mesh = q.device_mesh
    K = k.shape[1]
    placements, split = [], 1
    for p, n in zip(q.placements, mesh.shape):
        if p.is_shard(0):
            placements.append(p)
        elif p.is_shard(1) and K % (split * n) == 0:
            placements.append(p)
            split *= n
        else:
            placements.append(Replicate())
    q, k, v = (t.redistribute(mesh, placements) for t in (q, k, v))
    out = core(q.to_local(), k.to_local(), v.to_local(), **kw)
    return from_local(out, mesh, placements, q.shape)


def _local_block_attention(q, k, v, *, window: int):
    """Sliding-window causal attention in block-local form: each query
    chunk of ``window`` positions attends to the (previous, own) key
    chunks only, one (w x 2w) score tile at a time.  Shapes as in
    ``_online_softmax_scan``; needs Sq == Skv, a multiple of the window."""
    B, H, S, D = q.shape
    K = k.shape[1]
    G = H // K
    w = window
    nc = S // w
    assert nc * w == S
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    qg = q.reshape(B, K, G, nc, w, D)
    kc = k.reshape(B, K, nc, w, D)
    vc = v.reshape(B, K, nc, w, D)
    qi = torch.arange(w, device=dev)[:, None] + w     # position in the 2w span
    ki = torch.arange(2 * w, device=dev)[None, :]
    mask = (qi >= ki) & ((qi - ki) < w)                # (w, 2w)
    mask0 = mask & (ki >= w)                           # no previous chunk
    outs = []
    for c in range(nc):
        if c:
            kp, vp = kc[:, :, c - 1], vc[:, :, c - 1]
        else:
            kp = torch.zeros_like(kc[:, :, 0])
            vp = torch.zeros_like(vc[:, :, 0])
        k2 = torch.cat([kp, kc[:, :, c]], 2)          # (B,K,2w,D)
        v2 = torch.cat([vp, vc[:, :, c]], 2)
        s = _dot_f32(qg[:, :, :, c], k2[:, :, None].transpose(-1, -2)) \
            * scale
        s = torch.where(mask if c else mask0, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = _dot_f32(p.to(v2.dtype), v2[:, :, None])
        outs.append(o.to(q.dtype))
    out = torch.stack(outs, 3)                        # (B,K,G,nc,w,D)
    return out.reshape(B, H, S, D)


def scalar_index(cache_index) -> Optional[int]:
    """The write position as an int when it is one position for all rows
    (an int, a 0-d array or tensor); None for a per-row vector."""
    if isinstance(cache_index, int):
        return cache_index
    if getattr(cache_index, "ndim", 1) == 0:
        return int(cache_index)
    return None


def _cache_call(fn, cache, q, *kv, **kw):
    """``fn(cache, q, *kv, rows=..., **kw)``: an attention core that
    reads and writes ``cache`` in place; returns its output (B, H, Sq,
    D).  On a mesh (DTensor cache leaves, every leaf of one layer placed
    alike by ``attn_cache_specs``' axes) each rank runs ``fn`` on its own
    block: ``q`` and ``kv`` are brought to the cache's placements (rows
    on the batch axes, heads where the cache shards its KV heads), the
    cache's leaves are the rank's local tensors, written in place, and
    ``rows`` is the slice of the batch the rank holds (for per-row write
    positions).  The output is placed as the cache is."""
    ref = cache["k"]
    if not is_dtensor(ref):
        return fn(cache, q, *kv, rows=slice(None), **kw)
    mesh, placements = ref.device_mesh, ref.placements
    local = {n: t.to_local() for n, t in cache.items()}
    q_l, *kv_l = (None if t is None
                  else t.redistribute(mesh, placements).to_local()
                  for t in (q, *kv))
    out = fn(local, q_l, *kv_l, rows=local_rows(ref), **kw)
    return from_local(out, mesh, placements, q.shape)


def _write_span(cfg: ModelConfig, cache, k, v, start: int) -> None:
    """K/V (B, K, S, hd) written at positions ``start`` .. ``start + S``
    of every row (quantized for the int8 cache)."""
    S = k.shape[2]
    if cfg.kv_quant:
        kq, ks = _kv_quantize(k)
        vq, vs = _kv_quantize(v)
        cache["k"][:, :, start:start + S] = kq
        cache["v"][:, :, start:start + S] = vq
        cache["k_scale"][:, :, start:start + S] = ks
        cache["v_scale"][:, :, start:start + S] = vs
    else:
        cache["k"][:, :, start:start + S] = k.to(cache["k"].dtype)
        cache["v"][:, :, start:start + S] = v.to(cache["v"].dtype)


def _write_at_0(cfg: ModelConfig, cache, q, k, v, *, rows) -> torch.Tensor:
    """A full-mode write without a cache index: K/V at position 0
    (clamped as ``_prefill_core`` clamps); returns ``q`` (the attention
    runs over k, v, not the cache)."""
    _write_span(cfg, cache, k, v, min(0, cache["k"].shape[2] - k.shape[2]))
    return q


def _prefill_core(cfg: ModelConfig, cache, q, k, v, *, rows, offset: int,
                  window: Optional[int]) -> torch.Tensor:
    """Full mode into a cache: K/V written at ``offset`` (clamped into
    range, as ``lax.dynamic_update_slice`` clamps the start), then the
    queries attend the updated cache (the chunked continuation: the
    speculative verify, a prefill into a cache); the causal mask (q_pos =
    offset + i) hides stale higher positions."""
    S, S_max = k.shape[2], cache["k"].shape[2]
    _write_span(cfg, cache, k, v, min(max(offset, 0), S_max - S))
    if cfg.kv_quant:
        kk = (cache["k"].to(COMPUTE_DTYPE)
              * cache["k_scale"][..., None].to(COMPUTE_DTYPE))
        vv = (cache["v"].to(COMPUTE_DTYPE)
              * cache["v_scale"][..., None].to(COMPUTE_DTYPE))
    else:
        kk, vv = cache["k"], cache["v"]
    return _online_softmax_scan(
        q, kk.to(q.dtype), vv.to(q.dtype), q_offset=offset, window=window,
        block_kv=_pick_block(kk.shape[2], cfg.attn_block_kv))


def _cross_core(cfg: ModelConfig, cache, q, k, v, *, rows) -> torch.Tensor:
    """Cross-attention in full mode: the encoder's K/V cached from
    position 0, cast to the cache's dtype as the reference casts them;
    every query sees every key of k, v (not of the cache)."""
    Sx = k.shape[2]
    cache["k"][:, :, :Sx] = k.to(cache["k"].dtype)
    cache["v"][:, :, :Sx] = v.to(cache["v"].dtype)
    return _online_softmax_scan(
        q, k, v, q_offset=0, bidir=True,
        block_kv=_pick_block(Sx, cfg.attn_block_kv))


def _decode_write(cfg: ModelConfig, cache, k, v, cache_index,
                  window: Optional[int], rows: slice) -> torch.Tensor:
    """Write decode's one new position of K/V into ``cache`` (quantized
    for the int8 cache), each row at its position; returns the positions
    each row may attend, (B|1, S_max) bool.  ``rows``: the batch rows
    ``cache`` holds (a rank's block on a mesh)."""
    B = k.shape[0]
    S_max = cache["k"].shape[2]
    ci = scalar_index(cache_index)
    kv_pos = torch.arange(S_max, device=k.device)
    if ci is not None:
        # dynamic_update_slice: one position for all rows, clamped.
        c = min(max(ci, 0), S_max - 1)

        def write(buf, val):
            buf[:, :, c] = val[:, :, 0]
        valid = (kv_pos <= ci)[None, :]
        if window is not None:
            valid = valid & ((ci - kv_pos) < window)[None, :]
    else:
        # (B,) positions: row b writes at ci_b[b] (serving slots whose
        # lengths diverge).
        ci_b = torch.as_tensor(cache_index, device=k.device).long()[rows]
        b_idx = torch.arange(B, device=k.device)

        def write(buf, val):
            buf[b_idx, :, ci_b] = val[:, :, 0]
        valid = kv_pos[None, :] <= ci_b[:, None]
        if window is not None:
            valid &= (ci_b[:, None] - kv_pos[None, :]) < window
    if cfg.kv_quant:
        kq, ks = _kv_quantize(k)
        vq, vs = _kv_quantize(v)
        write(cache["k"], kq)
        write(cache["v"], vq)
        write(cache["k_scale"], ks)
        write(cache["v_scale"], vs)
    else:
        write(cache["k"], k.to(cache["k"].dtype))
        write(cache["v"], v.to(cache["v"].dtype))
    return valid


def _decode_core(cfg: ModelConfig, cache, q, k, v, *, rows, cache_index,
                 window: Optional[int]) -> torch.Tensor:
    """One query position (B, H, 1, hd) against the cache, after writing
    its K/V (``k`` None: cross-attention over the encoder's cached K/V,
    every position valid)."""
    valid = None
    if k is not None:
        valid = _decode_write(cfg, cache, k, v, cache_index, window, rows)
    kk, vv = cache["k"], cache["v"]
    B, H, _, hd = q.shape
    K = kk.shape[1]
    qg = q.reshape(B, K, H // K, 1, hd)
    # int8 cache: the per-(b,k,s) scale is constant over hd, so it folds
    # outside the dots (exact algebra).
    s = _dot_f32(qg, kk.to(q.dtype)[:, :, None].transpose(-1, -2)) \
        * (1.0 / math.sqrt(hd))      # "/ sqrt(hd)", compiled as XLA does
    if cfg.kv_quant:
        s = s * cache["k_scale"][:, :, None, None, :]
    if valid is not None:
        s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    if cfg.kv_quant:
        pr = pr * cache["v_scale"][:, :, None, None, :]
    out = _dot_f32(pr.to(COMPUTE_DTYPE), vv.to(COMPUTE_DTYPE)[:, :, None])
    return out.reshape(B, H, 1, hd).to(q.dtype)


def attention_apply(cfg: ModelConfig, p, x: torch.Tensor, *, positions,
                    mode: str, cache: Optional[Dict] = None,
                    cache_index=None, local: bool = False,
                    bidir: bool = False, xa=None):
    """Attention sub-layer (projections + mixing + out projection).

    mode: "full" (prefill over the whole sequence; with a cache and a
    ``cache_index`` it is the continuation at that offset) or "decode"
    (one new token against the cache).  Returns (out, cache): the cache
    tree passed in, updated in place (None without one).
    ``cache``: {"k","v": (B, K, S_max, hd)} (+ "k_scale","v_scale" for
    the int8 cache).  ``bidir``: no causal mask (the encoder).  ``xa``
    (B, Sx, d): cross-attention's keys and values come from it, without
    RoPE, its K/V cached from position 0 in full mode; decode reads that
    cache with every position valid.
    """
    q = torch.einsum("bsd,dhk->bhsk", x, weight(p["wq"], x))
    if "bq" in p:
        q = q + weight(p["bq"], x)[None, :, None, :]
    k = v = None      # cross-attention decode reads the cached enc K/V
    if mode != "decode" or xa is None:
        kv_src = x if xa is None else xa
        k = torch.einsum("bsd,dhk->bhsk", kv_src, weight(p["wk"], x))
        v = torch.einsum("bsd,dhk->bhsk", kv_src, weight(p["wv"], x))
        if "bk" in p:
            k = k + weight(p["bk"], x)[None, :, None, :]
            v = v + weight(p["bv"], x)[None, :, None, :]
    if cfg.rope_theta > 0 and xa is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    window = cfg.local_window if local else None

    if mode == "full":
        offset = 0 if cache_index is None else scalar_index(cache_index)
        if offset is None:
            raise ValueError("full mode writes the cache at one offset for "
                             "all rows; got a per-row cache_index")
        if cache is not None and xa is not None:
            out = _cache_call(partial(_cross_core, cfg), cache, q, k, v)
        elif cache is not None and cache_index is not None:
            out = _cache_call(partial(_prefill_core, cfg), cache, q, k, v,
                              offset=offset, window=window)
        elif xa is not None or bidir:
            # Every query sees every key of k, v.
            out = _on_shards(
                _online_softmax_scan, q, k, v, q_offset=0, bidir=True,
                block_kv=_pick_block(k.shape[2], cfg.attn_block_kv))
        else:
            if cache is not None:
                # A cache without an index: written at 0, attended as a
                # cacheless forward.
                _cache_call(partial(_write_at_0, cfg), cache, q, k, v)
            if local and k.shape[2] % window == 0:
                out = _on_shards(_local_block_attention, q, k, v,
                                 window=window)
            else:
                out = _on_shards(
                    _online_softmax_scan, q, k, v, q_offset=0,
                    window=window,
                    block_kv=_pick_block(k.shape[2], cfg.attn_block_kv))
    elif mode == "decode":
        assert cache is not None
        out = _cache_call(partial(_decode_core, cfg), cache, q, k, v,
                          cache_index=cache_index, window=window)
    else:
        raise ValueError(mode)

    return project(out.to(x.dtype), p["wo"], "bhsk,hkd->bsd"), cache


def attn_cache_specs(cfg: ModelConfig, batch: int,
                     seq_len: int) -> Dict[str, P]:
    K, hd = cfg.padded_kv_heads, cfg.head_dim
    ax = ("batch", "kv_heads", None, None)
    if cfg.kv_quant:
        sax = ("batch", "kv_heads", None)
        return {
            "k": P((batch, K, seq_len, hd), ax, "zeros", torch.int8),
            "v": P((batch, K, seq_len, hd), ax, "zeros", torch.int8),
            "k_scale": P((batch, K, seq_len), sax, "zeros", torch.float32),
            "v_scale": P((batch, K, seq_len), sax, "zeros", torch.float32),
        }
    return {"k": P((batch, K, seq_len, hd), ax, "zeros", COMPUTE_DTYPE),
            "v": P((batch, K, seq_len, hd), ax, "zeros", COMPUTE_DTYPE)}


def _kv_quantize(x: torch.Tensor):
    """(B,K,S,hd) -> (int8 values, f32 scale (B,K,S)).  Symmetric per-token
    per-head scaling; exact dequant is x_q * scale."""
    x32 = x.float()
    amax = x32.abs().amax(-1)
    # The compiled reference divides by the constant as XLA rewrites it, a
    # multiply by its reciprocal (1 ulp off a true divide at times).
    scale = torch.clamp_min(amax, 1e-8) * (1.0 / 127.0)
    q = torch.round(x32 / scale[..., None])
    return torch.clamp(q, -127, 127).to(torch.int8), scale


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_specs(cfg: ModelConfig) -> Dict[str, P]:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act == "silu":
        return {"wg": P((d, f), ("embed", "ff")),
                "wu": P((d, f), ("embed", "ff")),
                "wd": P((f, d), ("ff", "embed"))}
    return {"wi": P((d, f), ("embed", "ff")),
            "bi": P((f,), ("ff",), "zeros"),
            "wo": P((f, d), ("ff", "embed")),
            "bo": P((d,), ("embed",), "zeros")}


def _logistic(x: torch.Tensor) -> torch.Tensor:
    # XLA expands ``logistic`` into 1 / (1 + exp(-x)), each op rounded to
    # the operand dtype.
    return 1 / (1 + torch.exp(-x))


# ``jax.nn.gelu``'s tanh form with its constants rounded to bf16, as the
# reference traces them for bf16 operands: 0.044715 -> 0.044677734375 and
# sqrt(2 / pi) -> 0.796875 (both exact in bf16, so a python float carries
# them unchanged).
_GELU_C3 = 0.044677734375
_GELU_C = 0.796875


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    cdf = 0.5 * (1.0 + torch.tanh(_GELU_C * (x + _GELU_C3 * (x * x * x))))
    return x * cdf


def mlp_apply(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """The reference's MLP, op for op in the activation dtype: SwiGLU's
    ``jax.nn.silu`` is x * logistic(x) and GELU is ``jax.nn.gelu``'s tanh
    form (its default), so bf16 rounds where the reference's does."""
    if cfg.act == "silu":
        h = x @ weight(p["wg"], x)
        g = h * _logistic(h)
        u = x @ weight(p["wu"], x)
        return project(g * u, p["wd"])
    h = _gelu_tanh(x @ weight(p["wi"], x) + weight(p["bi"], x))
    return project(h, p["wo"]) + weight(p["bo"], x)


# ---------------------------------------------------------------------------
# MoE (GShard-style grouped capacity dispatch)
# ---------------------------------------------------------------------------

def moe_specs(cfg: ModelConfig) -> Dict[str, P]:
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    return {
        "router": P((d, E), ("embed", "experts")),
        "wg": P((E, d, f), ("experts", "embed", "ff")),
        "wu": P((E, d, f), ("experts", "embed", "ff")),
        "wd": P((E, f, d), ("experts", "ff", "embed")),
    }


class MoERoute(NamedTuple):
    """Token-choice top-k routing of (G, Sg) tokens, each field (G, Sg, k)
    but ``C``: the chosen experts (``idx``, best first), their
    renormalized gates (``probs``), each assignment's position in its
    expert's buffer (``pos``) and whether it fits under the capacity
    ``C`` (``keep``; a dropped assignment contributes nothing)."""

    idx: torch.Tensor
    probs: torch.Tensor
    C: int
    pos: torch.Tensor
    keep: torch.Tensor


def moe_route(cfg: ModelConfig, gates: torch.Tensor) -> MoERoute:
    """The reference's routing (``moe_apply``'s top-k and capacity loop)
    on f32 gates (G, Sg, E), integer for integer.

    Top-k breaks ties by the lower expert index, as ``jax.lax.top_k``
    does: a stable descending sort keeps equal gates in index order.  An
    assignment's position is the count of earlier assignments to its
    expert in slot-major order (every token's first choice, then every
    token's second, ...), dropped ones included, as the reference's
    per-slot cumsum plus running counts gives it."""
    G, Sg, E = gates.shape
    k = cfg.top_k
    probs, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    probs, idx = probs[..., :k], idx[..., :k]
    probs = probs / torch.clamp_min(probs.sum(-1, keepdim=True), 1e-9)
    C = max(int(k * Sg * cfg.capacity_factor / E), 4)
    slot_major = idx.transpose(1, 2).reshape(G, k * Sg, 1)
    # (G, k*Sg, E) one-hot in slot-major order, counted along the tokens.
    onehot = (slot_major == torch.arange(E, device=gates.device)).int()
    pos = (torch.cumsum(onehot, 1) - 1).gather(2, slot_major)
    pos = pos.reshape(G, k, Sg).transpose(1, 2)
    return MoERoute(idx, probs, C, pos, pos < C)


def moe_apply(cfg: ModelConfig, p, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out, aux_loss).  Token-choice top-k with per-group
    capacity.  Where the reference multiplies one-hot dispatch and combine
    tensors, the port writes each kept assignment's token into its
    expert's buffer slot and gathers each token's k expert outputs back,
    summed under its gate weights: the same sums, since each buffer slot
    holds at most one token.  Every expert runs on its whole buffer,
    empty slots too, as the reference's do.

    On a mesh each rank routes its own batch rows through whole expert
    weights (the groups are runs of tokens, so a rank whose rows hold
    whole groups routes them as one device does; otherwise every rank
    takes the whole batch), and the load-balance statistics are averaged
    over the ranks' groups before the aux loss is formed."""
    B, S, d = x.shape
    T = B * S
    Sg = min(cfg.moe_group_size, T)
    if T % Sg:
        raise AssertionError("tokens must divide the MoE group size")
    if not is_dtensor(x):
        out, f_e, p_e = _moe_core(cfg, p, x, Sg)
        return out, cfg.n_experts * torch.sum(f_e * p_e)
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    placements = [xp if xp.is_shard(0) else Replicate()
                  for xp in x.placements]
    split = math.prod(n for pl, n in zip(placements, mesh.shape)
                      if pl.is_shard(0))
    if B % split or (T // split) % Sg:
        placements, split = [Replicate()] * mesh.ndim, 1
    out, f_e, p_e = _moe_core(cfg, _whole_leaves(p, placements),
                              x.redistribute(mesh, placements).to_local(),
                              Sg)
    out = from_local(out, mesh, placements, x.shape)
    # Each rank's means over its groups, one row a batch shard: their mean
    # is the mean over every group.
    f_e, p_e = (from_local(t[None], mesh, placements,
                            (split, cfg.n_experts)).mean(0)
                for t in (f_e, p_e))
    return out, cfg.n_experts * torch.sum(f_e * p_e)


def _moe_core(cfg: ModelConfig, p, x: torch.Tensor, Sg: int):
    """(out, f_e, p_e): the MoE over x's tokens in groups of ``Sg``, with
    the top-1 share ``f_e`` and mean gate ``p_e`` of each expert."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    G = B * S // Sg
    xt = x.reshape(G, Sg, d)
    logits = torch.einsum("gsd,de->gse", xt, p["router"].to(x.dtype))
    gates = torch.softmax(logits.float(), -1)
    r = moe_route(cfg, gates)
    C = r.C
    # Buffer slot of each assignment; a dropped one goes to a spare row.
    g_base = torch.arange(G, device=x.device)[:, None, None] * (E * C)
    slot = torch.where(r.keep, g_base + r.idx * C + r.pos, G * E * C)
    ein = x.new_zeros((G * E * C + 1, d))
    ein[slot.reshape(-1)] = xt[:, :, None].expand(G, Sg, k, d).reshape(-1, d)
    ein = ein[:-1].view(G, E, C, d)
    h = torch.einsum("gecd,edf->gecf", ein, p["wg"].to(ein.dtype))
    h = h * _logistic(h)
    u = torch.einsum("gecd,edf->gecf", ein, p["wu"].to(ein.dtype))
    eo = torch.einsum("gecf,efd->gecd", h * u, p["wd"].to(ein.dtype))
    # combine.astype(eo.dtype): the gate weights round to bf16; the sum of
    # a token's k products runs in f32 and rounds once, as the einsum's.
    w = torch.where(r.keep, r.probs, 0.0).to(eo.dtype)
    picked = eo.reshape(G * E * C, d)[torch.where(r.keep, slot, 0)]
    out = _dot_f32(w[..., None, :], picked).to(eo.dtype)   # (G,Sg,1,d)
    # Load-balance aux loss (Switch): E * sum_e f_e * P_e.
    f_e = (r.idx[..., 0, None] == torch.arange(E, device=x.device)
           ).float().mean((0, 1))
    p_e = gates.mean((0, 1))
    return out.reshape(B, S, d), f_e, p_e


# ---------------------------------------------------------------------------
# Blocks run on each rank's batch rows
# ---------------------------------------------------------------------------

def _whole_leaves(p, rows):
    """A parameter tree with every DTensor leaf gathered whole, as plain
    tensors for a computation on this rank's batch rows (``rows``: the
    placements of those rows).  Each rank's gradient of a leaf covers its
    own rows, so it is a partial sum over the mesh dims that split the
    batch, reduced on its way back to the shards."""
    if hasattr(p, "keys"):
        return {k: _whole_leaves(p[k], rows) for k in p.keys()}
    if not is_dtensor(p):
        return p
    from torch.distributed.tensor import Partial, Replicate
    whole = p.redistribute(p.device_mesh, [Replicate()] * len(rows))
    return whole.to_local(grad_placements=[
        Partial() if r.is_shard(0) else Replicate() for r in rows])


def on_batch_rows(fn, p, x: torch.Tensor, cache=None) -> torch.Tensor:
    """``fn(p, x, cache)`` -> y of x's shape, each row of y from the same
    row of x (a recurrent or SSD block over its sequence), ``cache`` (a
    dict of leaves with a leading batch dim, or None) updated in place.
    On a mesh each rank runs ``fn`` on its own batch rows with the weights
    whole, and y is placed as those rows are.  A cache leaf is read as
    those rows with every other dim whole (its ``heads`` or ``ff`` shards
    gathered) and written back into its own placements, so the stored
    cache keeps the layout its specs give it."""
    if not is_dtensor(x):
        return fn(p, x, cache)
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    placements = [xp if xp.is_shard(0) else Replicate()
                  for xp in x.placements]
    cache = cache or {}
    moved = {n for n, t in cache.items() if list(t.placements) != placements}
    rows = {n: (t.redistribute(mesh, placements) if n in moved else t
                ).to_local() for n, t in cache.items()}
    y = fn(_whole_leaves(p, placements),
           x.redistribute(mesh, placements).to_local(), rows or None)
    for n in moved:
        t = cache[n]
        back = from_local(rows[n], mesh, placements, t.shape)
        t.to_local().copy_(back.redistribute(mesh, t.placements).to_local())
    return from_local(y, mesh, placements, x.shape)
