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
shards (``weight``); the embedding lookup runs on each rank's block of
the table and sums the rows it looked up over the vocab's dims
(``embed_lookup``).  The attention core runs on each rank's batch rows
and heads (``_on_shards``, ``_cache_call``): where the KV heads replicate
over the dim that shards the query heads, each rank keeps its query
heads and reads only the KV head they share (``_query_heads``).  The
MoE routes each rank's batch rows; where the experts shard over a mesh
dim each rank holds and runs only its block of experts, summing the
combine's f32 partials across the dim ("2d") or exchanging its buffers
with the experts' owners by all-to-all ("fsdp"), else it runs every
expert with whole weights (``moe_apply``).  The SSD and RG-LRU blocks
run on each rank's batch rows and its block of their channels where the
rules shard those over a mesh dim (``on_channel_block``): the rank reads
its shards of the channel leaves and whole copies of the leaves the rules
replicate, keeps its cache blocks where the cache specs put them, and
crosses the dim only where the block mixes channels (a dense gate, the
gated norm's mean, the output projection); elsewhere (the ``"fsdp"``
profile) they run on the rank's batch rows with whole weights
(``on_batch_rows``).  Each is the same per-row arithmetic as one
device's, with the collectives at the edges.
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


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows ``tokens`` (B, S) of the table ``embed`` (V, d): (B, S, d) in
    COMPUTE_DTYPE.

    On a mesh no rank gathers the table.  With Dv the mesh dims that shard
    its vocab dim, De those that shard its embed dim and Db those that
    shard the tokens' batch (placed as ``constrain`` places the batch),
    the tokens are gathered over Db's dims in Dv or De (the integer ids
    only); each rank looks them up in its own block of the table, an id
    outside the block giving a zero row; the rows, a partial sum over Dv
    with a single non-zero term an element, are summed over Dv (an
    all-reduce: one device's values to the bit); the embed shard becomes
    the batch shard over De (an all-to-all) and each rank keeps its rows.
    So the output is placed as ``constrain(x, ("batch", None, None))``
    places it, as the reference's compiled program lowers its
    ``jnp.take``.  The payload is bf16: the sum of one value and zeros
    is that value, so f32 would carry the same bits at twice the bytes.
    The table's gradient lands in each rank's block, the moves run back
    (the all-to-all back; where the rank kept rows of the sum, the rows'
    gradients gathered), a partial sum over the batch dims that replicate
    the table, reduced on its way to the shards."""
    if not is_dtensor(embed):
        return torch.nn.functional.embedding(tokens.long(), embed).to(
            COMPUTE_DTYPE)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    from repro_torch.distributed.context import constrain
    mesh = embed.device_mesh
    n = mesh.ndim
    if not is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * n,
                                    run_check=False)
    tokens = constrain(tokens, ("batch", None))
    tp = embed.placements
    dv = [i for i in range(n) if tp[i].is_shard(0)]
    de = [i for i in range(n) if tp[i].is_shard(1)]
    db = [i for i in range(n) if tokens.placements[i].is_shard(0)]
    moved = [i for i in db if i in dv or i in de]
    kept = [i for i in db if i not in moved]
    if kept and moved and max(kept) > min(moved):
        raise NotImplementedError(
            f"embed_lookup: the batch's mesh dims {kept} that keep their "
            f"rows must precede those it gathers {moved}")
    local = tokens.redistribute(mesh, [
        Shard(0) if i in kept else Replicate() for i in range(n)]).to_local()
    shape, offset = compute_local_shape_and_global_offset(
        tuple(embed.shape), mesh, tp)
    table = embed.to_local(grad_placements=[
        Partial() if i in kept else p for i, p in enumerate(tp)])
    ids = local.long() - offset[0]
    if shape[0] < embed.shape[0]:
        hit = (ids >= 0) & (ids < shape[0])
        x = torch.nn.functional.embedding(ids.clamp(0, shape[0] - 1), table)
        x = torch.where(hit[..., None], x, 0)
    else:
        x = torch.nn.functional.embedding(ids, table)
    # Rows (one axis a gathered batch dim, in mesh order), S, d block.
    x = x.to(COMPUTE_DTYPE).unflatten(
        0, [mesh.shape[i] for i in moved] + [-1])
    for i in dv:
        axis = moved.index(i) if i in moved else None
        x = _SumRows.apply(x, mesh.get_group(i).group_name, axis,
                           mesh.shape[i], mesh.get_local_rank(i))
        if axis is not None:
            moved.remove(i)
    # Inner mesh dims first: each move joins embed blocks in rank order,
    # so the blocks of nested shards come out in the table's order.
    for i in reversed(de):
        if i in moved:
            x = _all_to_all(x.movedim(moved.index(i), 0), mesh.get_group(i))
            x = x.movedim(0, -2).flatten(-2)
            moved.remove(i)
        else:
            x = _Join.apply(x, x.ndim - 1, mesh.shape[i],
                            mesh.get_group(i).group_name,
                            mesh.get_local_rank(i))
    B, S = tokens.shape
    return from_local(x, mesh, [
        Shard(0) if i in db else Replicate() for i in range(n)],
        (B, S, embed.shape[1]))


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
    (a query head's KV head is on the same rank) or where each rank's
    query heads read one KV head of replicated k/v (``_query_heads``);
    every other mesh dim replicates.  The output is placed as q was
    brought."""
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
    q_pl, heads = _query_heads(q, K, placements)
    k, v = (_kv_local(t, placements, q_pl)[:, heads] for t in (k, v))
    out = core(q.redistribute(mesh, q_pl).to_local(), k, v, **kw)
    return from_local(out, mesh, q_pl, q.shape)


def _query_heads(q, K: int, kv_placements) -> Tuple[list, slice]:
    """Query-head sharding over replicated KV heads: (q's placements,
    the KV heads this rank's query heads read).  Where q shards its
    heads over mesh dims on which the ``K`` KV heads replicate
    (``kv_placements``: the KV heads shard over no mesh dim) and each
    rank's H/m query heads lie within one KV group (query head h reads KV
    head h // (H/K)), q keeps those shards and the rank reads one KV
    head; otherwise q is placed as the KV heads are and reads all of
    them."""
    keep = slice(None)
    dims = [i for i, (qp, kp) in enumerate(zip(q.placements, kv_placements))
            if qp.is_shard(1) and not kp.is_shard(1)]
    if not dims or any(kp.is_shard(1) for kp in kv_placements):
        return list(kv_placements), keep
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    H = q.shape[1]
    m = math.prod(q.device_mesh.shape[i] for i in dims)
    if H % m or H % K or (H // K) % (H // m):
        return list(kv_placements), keep
    q_pl = [q.placements[i] if i in dims else p
            for i, p in enumerate(kv_placements)]
    _, offset = compute_local_shape_and_global_offset(
        tuple(q.shape), q.device_mesh, q_pl)
    kv = offset[1] // (H // K)
    return q_pl, slice(kv, kv + 1)


def _kv_local(t, placements, q_pl) -> torch.Tensor:
    """K or V placed by ``placements``, as this rank's local tensor.
    Where q keeps a heads shard that ``placements`` replicates, each
    rank reads only its query heads' KV heads, so the gradient of the
    replicated block is a partial sum over those mesh dims."""
    from torch.distributed.tensor import Partial
    grads = [Partial() if qp.is_shard(1) and not p.is_shard(1) else p
             for p, qp in zip(placements, q_pl)]
    return t.redistribute(t.device_mesh, placements).to_local(
        grad_placements=grads)


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
    """``fn(cache, q, *kv, rows=..., heads=..., **kw)``: an attention
    core that reads and writes ``cache`` in place; returns its output (B,
    H, Sq, D).  On a mesh (DTensor cache leaves, every leaf of one layer
    placed alike by ``attn_cache_specs``' axes) each rank runs ``fn`` on
    its own block: ``kv`` are brought to the cache's placements (rows on
    the batch axes, heads where the cache shards its KV heads), ``q`` too
    but where it keeps its heads shard over a replicated cache
    (``_query_heads``), the cache's leaves are the rank's local tensors,
    written in place (a replicated cache whole on every rank), ``rows``
    is the slice of the batch the rank holds (for per-row write
    positions) and ``heads`` the KV heads of the local cache the rank's
    query heads read.  The output is placed as q was brought."""
    ref = cache["k"]
    if not is_dtensor(ref):
        return fn(cache, q, *kv, rows=slice(None), heads=slice(None), **kw)
    mesh, placements = ref.device_mesh, ref.placements
    q_pl, heads = _query_heads(q, ref.shape[1], placements)
    local = {n: t.to_local() for n, t in cache.items()}
    kv_l = (None if t is None
            else t.redistribute(mesh, placements).to_local() for t in kv)
    out = fn(local, q.redistribute(mesh, q_pl).to_local(), *kv_l,
             rows=local_rows(ref), heads=heads, **kw)
    return from_local(out, mesh, q_pl, q.shape)


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


def _write_at_0(cfg: ModelConfig, cache, q, k, v, *, rows,
                heads) -> torch.Tensor:
    """A full-mode write without a cache index: K/V at position 0
    (clamped as ``_prefill_core`` clamps); returns ``q`` (the attention
    runs over k, v, not the cache)."""
    _write_span(cfg, cache, k, v, min(0, cache["k"].shape[2] - k.shape[2]))
    return q


def _prefill_core(cfg: ModelConfig, cache, q, k, v, *, rows, heads,
                  offset: int, window: Optional[int]) -> torch.Tensor:
    """Full mode into a cache: K/V written at ``offset`` (clamped into
    range, as ``lax.dynamic_update_slice`` clamps the start), then the
    queries attend the updated cache's KV ``heads`` (the chunked
    continuation: the speculative verify, a prefill into a cache); the
    causal mask (q_pos = offset + i) hides stale higher positions."""
    S, S_max = k.shape[2], cache["k"].shape[2]
    _write_span(cfg, cache, k, v, min(max(offset, 0), S_max - S))
    read = {n: t[:, heads] for n, t in cache.items()}
    if cfg.kv_quant:
        kk = (read["k"].to(COMPUTE_DTYPE)
              * read["k_scale"][..., None].to(COMPUTE_DTYPE))
        vv = (read["v"].to(COMPUTE_DTYPE)
              * read["v_scale"][..., None].to(COMPUTE_DTYPE))
    else:
        kk, vv = read["k"], read["v"]
    return _online_softmax_scan(
        q, kk.to(q.dtype), vv.to(q.dtype), q_offset=offset, window=window,
        block_kv=_pick_block(kk.shape[2], cfg.attn_block_kv))


def _cross_core(cfg: ModelConfig, cache, q, k, v, *, rows,
                heads) -> torch.Tensor:
    """Cross-attention in full mode: the encoder's K/V cached from
    position 0, cast to the cache's dtype as the reference casts them;
    every query sees every key of k, v's ``heads`` (not of the cache)."""
    Sx = k.shape[2]
    cache["k"][:, :, :Sx] = k.to(cache["k"].dtype)
    cache["v"][:, :, :Sx] = v.to(cache["v"].dtype)
    return _online_softmax_scan(
        q, k[:, heads], v[:, heads], q_offset=0, bidir=True,
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


def _decode_core(cfg: ModelConfig, cache, q, k, v, *, rows, heads,
                 cache_index, window: Optional[int]) -> torch.Tensor:
    """One query position (B, H, 1, hd) against the cache's KV ``heads``,
    after writing its K/V (``k`` None: cross-attention over the encoder's
    cached K/V, every position valid)."""
    valid = None
    if k is not None:
        valid = _decode_write(cfg, cache, k, v, cache_index, window, rows)
    read = {n: t[:, heads] for n, t in cache.items()}
    kk, vv = read["k"], read["v"]
    B, H, _, hd = q.shape
    K = kk.shape[1]
    qg = q.reshape(B, K, H // K, 1, hd)
    # int8 cache: the per-(b,k,s) scale is constant over hd, so it folds
    # outside the dots (exact algebra).
    s = _dot_f32(qg, kk.to(q.dtype)[:, :, None].transpose(-1, -2)) \
        * (1.0 / math.sqrt(hd))      # "/ sqrt(hd)", compiled as XLA does
    if cfg.kv_quant:
        s = s * read["k_scale"][:, :, None, None, :]
    if valid is not None:
        s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    if cfg.kv_quant:
        pr = pr * read["v_scale"][:, :, None, None, :]
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

    On a mesh each rank routes its own batch rows (the groups are runs of
    tokens, so a rank whose rows hold whole groups routes them as one
    device does), and the load-balance statistics are averaged over the
    ranks' groups before the aux loss is formed.  Where the expert
    weights shard their experts over a mesh dim (``_expert_dim``), each
    rank holds and runs only its block of E/m experts:

    * the batch replicated over that dim (the "2d" rules): the ranks of
      the dim hold the same tokens; each fills only its experts' buffer
      slots and forms each token's combine over them as an f32 partial,
      and the partials are summed across the dim in f32 and rounded once,
      as ``project`` sums a row-parallel product;
    * the batch sharded over it ("fsdp"): each rank routes its own rows,
      its (G, E, C, d) buffer goes to the experts' owners by an
      all-to-all over the dim and the expert outputs come back by the
      reverse all-to-all before the combine (``_exchange``), the
      reference's dispatch under pjit.

    Where the experts do not divide the dim, or a rank's rows do not hold
    whole groups, every rank runs every expert with whole weights."""
    B, S, d = x.shape
    T = B * S
    Sg = min(cfg.moe_group_size, T)
    if T % Sg:
        raise AssertionError("tokens must divide the MoE group size")
    if not is_dtensor(x):
        out, f_e, p_e = _moe_core(cfg, p, x, Sg)
        return out, cfg.n_experts * torch.sum(f_e * p_e)
    from torch.distributed.tensor import Partial, Replicate
    mesh = x.device_mesh
    placements = [xp if xp.is_shard(0) else Replicate()
                  for xp in x.placements]
    split = math.prod(n for pl, n in zip(placements, mesh.shape)
                      if pl.is_shard(0))
    ep = _expert_dim(p)
    if B % split or (T // split) % Sg:
        placements, split, ep = [Replicate()] * mesh.ndim, 1, None
    if ep is None:
        out, f_e, p_e = _moe_core(cfg, _whole_leaves(p, placements),
                                  x.redistribute(mesh, placements).to_local(),
                                  Sg)
        out = from_local(out, mesh, placements, x.shape)
    else:
        m = mesh.shape[ep]
        tokens_split = placements[ep].is_shard(0)
        # Under "2d" every rank of the experts' dim holds the same tokens
        # and adds only its experts' share to their gradient: partial sums
        # over the dim, as the combine's partials are.
        shared = [Partial() if i == ep and not tokens_split else pl
                  for i, pl in enumerate(placements)]
        pe = {n: _local_block(p[n], placements, ep)
              for n in ("wg", "wu", "wd")}
        pe["router"] = _whole_leaves(p["router"], shared)
        x_l = x.redistribute(mesh, placements).to_local(
            grad_placements=shared)
        if tokens_split:
            out, f_e, p_e = _moe_core(
                cfg, pe, x_l, Sg,
                run=partial(_exchange, group=mesh.get_group(ep)))
            out = from_local(out, mesh, placements, x.shape)
        else:
            n_own = cfg.n_experts // m
            out, f_e, p_e = _moe_core(
                cfg, pe, x_l, Sg, block=(mesh.get_local_rank(ep) * n_own,
                                         n_own))
            out = from_local(out, mesh, shared, x.shape).redistribute(
                mesh, placements).to(x.dtype)
    # Each rank's means over its groups, one row a batch shard: their mean
    # is the mean over every group.
    f_e, p_e = (from_local(t[None], mesh, placements,
                            (split, cfg.n_experts)).mean(0)
                for t in (f_e, p_e))
    return out, cfg.n_experts * torch.sum(f_e * p_e)


def _expert_dim(p) -> Optional[int]:
    """The mesh dim over which the expert weights (``wg``, ``wu``,
    ``wd``) shard their experts in whole blocks, or None (plain weights,
    experts replicated or split over several dims)."""
    dims = set()
    for n in ("wg", "wu", "wd"):
        if not is_dtensor(p[n]):
            return None
        dims.add(tuple(i for i, pl in enumerate(p[n].placements)
                       if pl.is_shard(0)))
    if len(dims) != 1 or len(next(iter(dims))) != 1:
        return None
    ep = next(iter(dims))[0]
    w = p["wg"]
    return None if w.shape[0] % w.device_mesh.shape[ep] else ep


def _local_block(w: torch.Tensor, rows, dim: int) -> torch.Tensor:
    """This rank's block of ``w`` over mesh dim ``dim`` (an expert
    weight's E/m experts, a channel leaf's block of channels), every other
    mesh dim gathered (the ``embed`` dim's FSDP shards, as ``weight``
    gathers them), as a plain tensor.  Its gradient covers the tokens of
    this rank's batch rows (``rows``: their placements), so it is a
    partial sum over the mesh dims that split the batch, other than
    ``dim``."""
    from torch.distributed.tensor import Partial, Replicate
    keep = w.placements[dim]
    target = [keep if i == dim else Replicate() for i in range(len(rows))]
    grads = [keep if i == dim else Partial() if r.is_shard(0)
             else Replicate() for i, r in enumerate(rows)]
    return w.redistribute(w.device_mesh, target).to_local(
        grad_placements=grads)


def _experts(p, ein: torch.Tensor) -> torch.Tensor:
    """The SwiGLU experts on their buffers: ein (G, E, C, d) -> (G, E, C,
    d), expert e of ``p``'s leaves on ``ein[:, e]``."""
    h = torch.einsum("gecd,edf->gecf", ein, p["wg"].to(ein.dtype))
    h = h * _logistic(h)
    u = torch.einsum("gecd,edf->gecf", ein, p["wu"].to(ein.dtype))
    return torch.einsum("gecf,efd->gecd", h * u, p["wd"].to(ein.dtype))


def _exchange(p, ein: torch.Tensor, *, group) -> torch.Tensor:
    """The experts on this rank's buffers (G, E, C, d) when each of the m
    ranks of ``group`` holds E/m of them (``p``'s blocks): each block of
    experts' buffers goes to its owner by an all-to-all, the owner runs
    its experts on the buffers of every rank, and the outputs come back
    by the reverse all-to-all."""
    G, E, C, d = ein.shape
    m = group.size()
    send = ein.view(G, m, E // m, C, d).transpose(0, 1)
    got = _all_to_all(send, group)                 # (m sources, G, E/m, ...)
    eo = _experts(p, got.reshape(m * G, E // m, C, d))
    back = _all_to_all(eo.view(m, G, E // m, C, d), group)
    return back.transpose(0, 1).reshape(G, E, C, d)


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """t (m, ...) over the m ranks of ``group``: block i goes to rank i,
    block j of the result came from rank j; the gradient goes back the
    same way.  A functional collective, so ``CommDebugMode`` and
    ``op_analysis`` count it as an all-to-all."""
    from torch.distributed._functional_collectives import (
        all_to_all_single_autograd)
    splits = [1] * t.shape[0]
    return all_to_all_single_autograd(t.contiguous(), splits, splits, group)


class _ScaleGrad(torch.autograd.Function):
    """The identity, its gradient scaled by ``s``."""

    @staticmethod
    def forward(ctx, t, s):
        ctx.s = s
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.s, None


def _moe_core(cfg: ModelConfig, p, x: torch.Tensor, Sg: int, *,
              block: Optional[Tuple[int, int]] = None, run=None):
    """(out, f_e, p_e): the MoE over x's tokens in groups of ``Sg``, with
    the top-1 share ``f_e`` and mean gate ``p_e`` of each expert.
    ``run(p, ein)`` runs the experts on their buffers (``_experts`` by
    default).  ``block`` (first
    expert, count): only those experts (``p``'s leaves hold them) fill
    buffer slots and enter the combine, and ``out`` is the f32 partial
    over them, not rounded, and ``p_e``'s gradient is scaled by the
    block's share n/E of the experts: each of the E/n ranks that hold the
    same tokens forms the same statistic, and adds its share."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    G = B * S // Sg
    xt = x.reshape(G, Sg, d)
    logits = torch.einsum("gsd,de->gse", xt, p["router"].to(x.dtype))
    gates = torch.softmax(logits.float(), -1)
    r = moe_route(cfg, gates)
    C = r.C
    lo, n = block or (0, E)
    keep = r.keep
    if block is not None:
        keep = keep & (r.idx >= lo) & (r.idx < lo + n)
    # Buffer slot of each assignment; a dropped one goes to a spare row.
    g_base = torch.arange(G, device=x.device)[:, None, None] * (n * C)
    slot = torch.where(keep, g_base + (r.idx - lo) * C + r.pos, G * n * C)
    ein = x.new_zeros((G * n * C + 1, d))
    ein[slot.reshape(-1)] = xt[:, :, None].expand(G, Sg, k, d).reshape(-1, d)
    eo = (run or _experts)(p, ein[:-1].view(G, n, C, d))
    # combine.astype(eo.dtype): the gate weights round to bf16; the sum of
    # a token's k products runs in f32 and rounds once, as the einsum's.
    w = torch.where(keep, r.probs, 0.0).to(eo.dtype)
    picked = eo.reshape(G * n * C, d)[torch.where(keep, slot, 0)]
    out = _dot_f32(w[..., None, :], picked)             # (G,Sg,1,d) f32
    if block is None:
        out = out.to(eo.dtype)
    # Load-balance aux loss (Switch): E * sum_e f_e * P_e.
    f_e = (r.idx[..., 0, None] == torch.arange(E, device=x.device)
           ).float().mean((0, 1))
    if block is not None:
        gates = _ScaleGrad.apply(gates, n / E)
    p_e = gates.mean((0, 1))
    return out.reshape(B, S, d), f_e, p_e


# ---------------------------------------------------------------------------
# Blocks run on each rank's batch rows
# ---------------------------------------------------------------------------

def _whole_leaves(p, rows):
    """A parameter tree with every DTensor leaf gathered whole, as plain
    tensors for a computation on this rank's batch rows (``rows``: the
    placements of those rows; a ``Partial`` among them marks a mesh dim
    whose ranks hold the same rows but each add only a share).  Each
    rank's gradient of a leaf covers its own rows, so it is a partial sum
    over the mesh dims that split the batch, reduced on its way back to
    the shards."""
    if hasattr(p, "keys"):
        return {k: _whole_leaves(p[k], rows) for k in p.keys()}
    if not is_dtensor(p):
        return p
    from torch.distributed.tensor import Partial, Replicate
    whole = p.redistribute(p.device_mesh, [Replicate()] * len(rows))
    return whole.to_local(grad_placements=[
        Partial() if r.is_shard(0) or r.is_partial() else Replicate()
        for r in rows])


def _cache_blocks(cache, mesh, target):
    """Each leaf of ``cache`` (a dict of DTensors, or None) as this rank's
    local tensor under the placements ``target(leaf)`` gives it, and a
    function that writes the leaves that had to move back into their own
    placements; a leaf already so placed is its local tensor, updated in
    place."""
    cache = cache or {}
    want = {n: target(t) for n, t in cache.items()}
    moved = {n for n, t in cache.items() if list(t.placements) != want[n]}
    local = {n: (t.redistribute(mesh, want[n]) if n in moved else t
                 ).to_local() for n, t in cache.items()}

    def write_back():
        for n in moved:
            t = cache[n]
            back = from_local(local[n], mesh, want[n], t.shape)
            t.to_local().copy_(back.redistribute(mesh, t.placements)
                               .to_local())
    return local or None, write_back


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
    rows, write_back = _cache_blocks(cache, mesh, lambda t: placements)
    y = fn(_whole_leaves(p, placements),
           x.redistribute(mesh, placements).to_local(), rows)
    write_back()
    return from_local(y, mesh, placements, x.shape)


# ---------------------------------------------------------------------------
# Blocks run on each rank's batch rows and block of channels
# ---------------------------------------------------------------------------

def _c10d(op: str, *args) -> torch.Tensor:
    """The functional collective ``op`` (``CommDebugMode`` and
    ``op_analysis`` count it), waited for."""
    ops = torch.ops._c10d_functional
    return ops.wait_tensor(getattr(ops, op)(*args))


def _gather(t: torch.Tensor, dim: int, m: int, name: str) -> torch.Tensor:
    """Every rank's ``t`` of group ``name`` (m ranks) joined along
    ``dim`` in rank order."""
    got = _c10d("all_gather_into_tensor", t.contiguous(), m, name)
    return got.reshape(m, *t.shape).movedim(0, dim).flatten(dim, dim + 1)


def _scatter_sum(t: torch.Tensor, dim: int, m: int,
                 name: str) -> torch.Tensor:
    """This rank's block of ``dim`` of every rank's ``t`` summed."""
    blocks = t.unflatten(dim, (m, -1)).movedim(dim, 0).contiguous()
    out = _c10d("reduce_scatter_tensor", blocks.flatten(0, 1), "sum", m,
                name)
    return out.reshape(blocks.shape[1:])


class _AllReduce(torch.autograd.Function):
    """The sum of every rank's tensor; each rank's gradient of it is a
    share, so the gradient is summed the same way."""

    @staticmethod
    def forward(ctx, t, name):
        ctx.name = name
        return _c10d("all_reduce", t.contiguous(), "sum", name)

    @staticmethod
    def backward(ctx, grad):
        return _c10d("all_reduce", grad.contiguous(), "sum", ctx.name), None


class _SumRows(torch.autograd.Function):
    """Every rank's tensor summed, and, where ``axis`` is given, this
    rank's index ``rank`` of the ``m`` along it (its rows of the sum).
    Each rank uses what it keeps whole, so the gradient of the sum passes
    unchanged, and the gradients of the kept rows are gathered back along
    ``axis``."""

    @staticmethod
    def forward(ctx, t, name, axis, m, rank):
        ctx.name, ctx.axis, ctx.m = name, axis, m
        s = _c10d("all_reduce", t.contiguous(), "sum", name)
        return s if axis is None else s.select(axis, rank).contiguous()

    @staticmethod
    def backward(ctx, grad):
        if ctx.axis is not None:
            grad = _gather(grad.unsqueeze(ctx.axis), ctx.axis, ctx.m,
                           ctx.name)
        return grad, None, None, None, None


class _SumGrad(torch.autograd.Function):
    """The identity, its gradient summed over a group's ranks: the entry
    of a block whose ranks each add their channels' share of the
    gradient of the input they share."""

    @staticmethod
    def forward(ctx, t, name):
        ctx.name = name
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return _c10d("all_reduce", grad.contiguous(), "sum", ctx.name), None


class _AllGather(torch.autograd.Function):
    """Every rank's tensor joined along a dim; each rank's gradient of
    the whole is a share, so each rank's block of it is summed back."""

    @staticmethod
    def forward(ctx, t, dim, m, name):
        ctx.dim, ctx.m, ctx.name = dim, m, name
        return _gather(t, dim, m, name)

    @staticmethod
    def backward(ctx, grad):
        return (_scatter_sum(grad, ctx.dim, ctx.m, ctx.name), None, None,
                None)


class _Join(torch.autograd.Function):
    """Every rank's block joined along a dim into a tensor each rank then
    uses whole; its gradient is whole on every rank, so each block's is
    its slice."""

    @staticmethod
    def forward(ctx, t, dim, m, name, rank):
        ctx.dim, ctx.rank, ctx.n = dim, rank, t.shape[dim]
        return _gather(t, dim, m, name)

    @staticmethod
    def backward(ctx, grad):
        return (grad.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None,
                None, None)


class ChannelGroup:
    """The ranks of one mesh dim that hold the same batch rows and split a
    block's channels into contiguous blocks, rank ``rank`` of ``size``
    the ``rank``-th (``on_channel_block``), and the collectives the block
    needs across them, each with its gradient."""

    def __init__(self, mesh, dim: int):
        self.group = mesh.get_group(dim)
        self.name = self.group.group_name
        self.rank = mesh.get_local_rank(dim)
        self.size = mesh.shape[dim]

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` summed."""
        return _AllReduce.apply(t, self.name)

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` joined along ``dim`` in rank order, each
        rank's use of it adding a share of its gradient."""
        return _AllGather.apply(t, dim, self.size, self.name)

    def join(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` joined along ``dim`` in rank order, used
        alike on every rank (its gradient whole on each)."""
        return _Join.apply(t, dim, self.size, self.name, self.rank)

    def columns(self, w: torch.Tensor) -> torch.Tensor:
        """This rank's block of columns (m c, n / m) of a matrix whose
        block of rows (c, n) each of the m ranks holds, by one
        all-to-all."""
        c, n = w.shape
        m = self.size
        send = w.reshape(c, m, n // m).transpose(0, 1)
        return _all_to_all(send, self.group).reshape(m * c, n // m)


def _channel_dim(w, rows) -> Optional[int]:
    """The mesh dim over which channel leaf ``w`` shards its last dim,
    where that is one dim and the batch rows (``rows``: their placements)
    replicate over it; else None."""
    if not is_dtensor(w):
        return None
    dims = [i for i, pl in enumerate(w.placements) if pl.is_shard(w.ndim - 1)]
    if len(dims) != 1 or rows[dims[0]].is_shard(0):
        return None
    return dims[0]


def on_channel_block(fn, p, x: torch.Tensor, cache=None, *,
                     channels: str = "wx", out: str = "wo") -> torch.Tensor:
    """``fn(p, x, cache, group) @ p[out]``: a block over x (B, S, d) whose
    channels (the last dim of ``p[channels]``) mix only within a batch
    row, then its output projection ``p[out]`` (channels, d); ``cache``
    (a dict of leaves with a leading batch dim, or None) is updated in
    place.

    Where the rules shard the channels over one mesh dim that does not
    split the batch, each rank runs ``fn`` on its own batch rows and its
    block of the channels, ``group`` the ``ChannelGroup`` of that dim:
    a leaf the rules shard over the dim is read as this rank's block
    (gathered over the other dims, ``_local_block``: its gradient partial
    over the batch dims only), a leaf they replicate whole (its gradient
    partial over the dim too, as each rank adds its channels' share), and
    a cache leaf as this rank's rows with its own placement over the dim
    (a block, or whole where the specs replicate it), written in place.
    ``fn`` returns this rank's channels (B_r, S, c).  The projection
    forms each rank's block of output columns from every rank's channels
    (gathered) and its columns of ``p[out]`` (an all-to-all of its
    rows), so each output is one device's sum, and the blocks are joined
    on every rank.  The gradient of x is summed over the dim where the
    block starts, so it leaves the block whole on every rank, as x came.
    Elsewhere (no mesh: ``group`` None; the batch over every dim, or the
    channels replicated: ``on_batch_rows``) ``fn`` sees whole weights and
    the projection is ``project``'s."""
    if not is_dtensor(x):
        return project(fn(p, x, cache, None), p[out])
    from torch.distributed.tensor import Partial, Replicate
    mesh = x.device_mesh
    rows = [xp if xp.is_shard(0) else Replicate() for xp in x.placements]
    tp = _channel_dim(p[channels], rows)
    if tp is None:
        return on_batch_rows(
            lambda pp, xx, cc: project(fn(pp, xx, cc, None), pp[out]),
            p, x, cache)
    shared = [Partial() if i == tp else r for i, r in enumerate(rows)]
    local = {n: (_local_block(t, rows, tp) if t.placements[tp].is_shard()
                 else _whole_leaves(t, shared))
             for n, t in p.items() if n != out}
    cache_l, write_back = _cache_blocks(cache, mesh, lambda t: [
        t.placements[tp] if i == tp else r for i, r in enumerate(rows)])
    group = ChannelGroup(mesh, tp)
    x_l = _SumGrad.apply(x.redistribute(mesh, rows).to_local(), group.name)
    y = fn(local, x_l, cache_l, group)
    write_back()
    w = group.columns(_local_block(p[out], rows, tp).to(y.dtype))
    out_cols = group.gather(y, 2) @ w
    return from_local(group.join(out_cols, 2), mesh, rows, x.shape)
