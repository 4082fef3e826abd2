"""Model assembly (port of ``repro.models.model``): parameter specs, the
stacked layer layout, the encoder, and the serving entry points.

The layer stack is organized as repeating *units* (``cfg.block_pattern``):
every full unit's parameters are stacked along a leading dim
(``blocks/units/<i>/...``) and any remainder layers sit unrolled under
``blocks/rest/<i>/...``, the reference's tree leaf for leaf, so JAX's
``init_params`` tree carries across unchanged
(``repro_torch.convert.params_from_numpy``).  An encoder-decoder (whisper)
holds ``encoder/{blocks,ln_f}`` and ``decoder/{blocks,ln_f}`` in their
place, the decoder's blocks with a cross-attention sub-layer (``lnx``,
``xattn``).  Where the reference runs the units under ``lax.scan``, the
port runs a Python loop over the stacked dim.  Caches are stacked the same
way and updated in place.

Entry points: ``init_params`` (-> ``CausalLM``), ``encode``, ``forward``,
``loss_fn``, ``prefill``, ``decode_step``, ``cache_specs`` and
``init_cache``.  Every block kind of the reference is ported (``attn``,
``local_attn``, ``moe``, ``ssd``, ``rglru``), the encoder-decoder and
``input_mode="embeddings"`` too.  ``forward``, ``encode`` and ``loss_fn``
build an autograd graph when the parameters take gradients
(``init_params(..., trainable=True)``); the serving entry points
(``prefill``, ``decode_step`` and ``CausalLM``'s methods) run under
``torch.no_grad()``.  Where the reference wraps its scanned units in
``jax.checkpoint`` (``cfg.remat``, a cacheless full-mode call), the port
wraps each unit in ``torch.utils.checkpoint`` when it records a graph:
memory, not values.

Under a mesh the parameters are DTensors (``convert.shard_params``) and
the training entry points (``forward``, ``encode``, ``loss_fn``) run the
same code.  The reference's three ``constrain`` hints (after each unit's
block, after the embedding, on the logits) redistribute the activations
where ``distributed.context.activation_sharding`` installed a mesh.
Tensors the model builds at the global shapes a DTensor reports
(positions, RoPE tables, the loss's vocab ids) are taken as replicated
(``replicating``: DTensor's implicit replication, entered only when a
parameter is a DTensor).  The embedding lookup takes whole rows of the
table, and ``loss_fn`` takes the gold logit through a one-hot select,
which is right on vocab-sharded logits (``layers`` says how the blocks
run).  ``abstract_params``, ``param_axes`` and ``input_specs`` give the
meta trees and logical axes the sharding rules read.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import sharding
from repro_torch.distributed.context import (constrain, is_dtensor,
                                             replicating, whole_dim)

from . import layers, rglru, ssm
from .config import InputShape, ModelConfig
from .layers import COMPUTE_DTYPE
from .spec import (P, abstract, initialize, leaves, map_tree, stack,
                   tree_axes, tree_map)


# ---------------------------------------------------------------------------
# Block-level dispatch
# ---------------------------------------------------------------------------

def block_specs(cfg: ModelConfig, kind: str,
                cross: bool = False) -> Dict[str, Any]:
    if kind in ("attn", "local_attn"):
        d: Dict[str, Any] = {"ln1": layers.norm_specs(cfg),
                             "attn": layers.attention_specs(cfg),
                             "ln2": layers.norm_specs(cfg),
                             "mlp": layers.mlp_specs(cfg)}
        if cross:
            d["lnx"] = layers.norm_specs(cfg)
            d["xattn"] = layers.attention_specs(cfg, cross=True)
        return d
    if kind == "moe":
        return {"ln1": layers.norm_specs(cfg),
                "attn": layers.attention_specs(cfg),
                "ln2": layers.norm_specs(cfg),
                "moe": layers.moe_specs(cfg)}
    if kind == "ssd":
        return {"ln1": layers.norm_specs(cfg), "ssd": ssm.ssd_specs(cfg)}
    if kind == "rglru":
        return {"ln1": layers.norm_specs(cfg),
                "rglru": rglru.rglru_specs(cfg),
                "ln2": layers.norm_specs(cfg),
                "mlp": layers.mlp_specs(cfg)}
    raise ValueError(kind)


def block_cache_specs(cfg: ModelConfig, kind: str, batch: int,
                      seq_len: int, cross_len: int = 0) -> Dict[str, Any]:
    if kind in ("attn", "local_attn", "moe"):
        d = {"attn": layers.attn_cache_specs(cfg, batch, seq_len)}
        if cross_len:
            d["xattn"] = layers.attn_cache_specs(cfg, batch, cross_len)
        return d
    if kind == "ssd":
        return {"ssd": ssm.ssd_cache_specs(cfg, batch)}
    if kind == "rglru":
        return {"rglru": rglru.rglru_cache_specs(cfg, batch)}
    raise ValueError(kind)


def block_apply(cfg: ModelConfig, kind: str, p, x, *, positions, mode: str,
                cache=None, cache_index=None, xa=None, bidir: bool = False,
                state_bf16: bool = True):
    """Returns (x after the block, the MoE load-balance loss or None);
    ``cache`` (if any) is updated in place.  ``xa``: the encoder output
    for a cross-attention sub-layer; ``state_bf16``: see
    ``ssm.ssd_apply``."""
    h = layers.apply_norm(cfg, p["ln1"], x)
    if kind == "ssd":
        s = layers.on_batch_rows(
            lambda pp, hh, cc: ssm.ssd_apply(
                cfg, pp, hh, mode=mode, cache=cc,
                state_bf16=state_bf16)[0], p["ssd"], h,
            cache["ssd"] if cache else None)
        return x + s, None
    if kind == "rglru":
        r = layers.on_batch_rows(
            lambda pp, hh, cc: rglru.rglru_apply(
                cfg, pp, hh, mode=mode, cache=cc)[0], p["rglru"], h,
            cache["rglru"] if cache else None)
        x = x + r
    elif kind in ("attn", "local_attn", "moe"):
        a, _ = layers.attention_apply(
            cfg, p["attn"], h, positions=positions, mode=mode,
            cache=cache["attn"] if cache else None, cache_index=cache_index,
            local=kind == "local_attn", bidir=bidir)
        x = x + a
        if "xattn" in p:
            # Cross-attention: full mode computes the encoder's K/V, decode
            # reads them from the cache (without ``xa``: see layers).
            h = layers.apply_norm(cfg, p["lnx"], x)
            a, _ = layers.attention_apply(
                cfg, p["xattn"], h, positions=positions, mode=mode,
                cache=cache["xattn"] if cache else None,
                cache_index=cache_index, xa=xa)
            x = x + a
    else:
        raise ValueError(kind)
    h = layers.apply_norm(cfg, p["ln2"], x)
    if kind == "moe":
        m, aux = layers.moe_apply(cfg, p["moe"], h)
        return x + m, aux
    return x + layers.mlp_apply(cfg, p["mlp"], h), None


# ---------------------------------------------------------------------------
# Stack layout: full units stacked, remainder unrolled
# ---------------------------------------------------------------------------

def _unit_layout(cfg: ModelConfig,
                 n_layers: int) -> Tuple[int, Tuple[str, ...]]:
    unit = cfg.block_pattern
    n_units = n_layers // len(unit)
    rest = tuple(cfg.layer_pattern[n_units * len(unit): n_layers])
    return n_units, rest


def _stack_param_specs(cfg: ModelConfig, n_layers: int,
                       cross: bool = False) -> Dict[str, Any]:
    n_units, rest = _unit_layout(cfg, n_layers)
    out: Dict[str, Any] = {}
    if n_units:
        out["units"] = stack(n_units, {str(i): block_specs(cfg, kind, cross)
                                       for i, kind in
                                       enumerate(cfg.block_pattern)})
    if rest:
        out["rest"] = {str(i): block_specs(cfg, kind, cross)
                       for i, kind in enumerate(rest)}
    return out


def _stack_param_specs_enc(cfg: ModelConfig) -> Dict[str, Any]:
    return {"units": stack(cfg.n_enc_layers,
                           {"0": block_specs(cfg, "attn")})}


def _stack_cache_specs(cfg: ModelConfig, n_layers: int, batch: int,
                       seq_len: int, cross_len: int = 0) -> Dict[str, Any]:
    n_units, rest = _unit_layout(cfg, n_layers)
    out: Dict[str, Any] = {}
    if n_units:
        out["units"] = stack(n_units, {
            str(i): block_cache_specs(cfg, kind, batch, seq_len, cross_len)
            for i, kind in enumerate(cfg.block_pattern)})
    if rest:
        out["rest"] = {str(i): block_cache_specs(cfg, kind, batch, seq_len,
                                                 cross_len)
                       for i, kind in enumerate(rest)}
    return out


def _unstack(tree, n: int):
    """The ``n`` units of a stacked tree, each a tree of views.  One
    ``unbind`` a leaf: its backward stacks the units' gradients in one
    write, where indexing each unit would add a full-size zero tensor a
    unit."""
    if isinstance(tree, torch.Tensor):
        return torch.unbind(tree, 0)
    per_key = {k: _unstack(v, n) for k, v in tree.items()}
    return [{k: v[u] for k, v in per_key.items()} for u in range(n)]


def _apply_layers(cfg: ModelConfig, run, x, unit: bool, **kw):
    """``run``'s (kind, params, cache) layers in turn: (x, aux or None).
    ``unit``: the layers are a stacked unit's, whose output the reference
    constrains after each block."""
    aux_total = None
    for kind, p, cache in run:
        x, aux = block_apply(cfg, kind, p, x, cache=cache, **kw)
        if unit:
            x = constrain(x, ("batch", None, None))
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
    return x, aux_total


def _apply_stack(cfg: ModelConfig, stack_params, x, *, positions, mode,
                 caches=None, cache_index=None, xa=None, bidir: bool = False,
                 pattern: Optional[Tuple[str, ...]] = None,
                 state_bf16: bool = True):
    """Returns (x, the summed MoE aux loss: a 0-d f32 tensor).
    ``pattern`` (default ``cfg.block_pattern``) names the unit's kinds."""
    pattern = pattern or cfg.block_pattern
    kw = dict(positions=positions, mode=mode, cache_index=cache_index,
              xa=xa, bidir=bidir, state_bf16=state_bf16)
    groups = []         # (layers, remat, unit): a unit each, then the rest
    if "units" in stack_params:
        units = stack_params["units"]
        n_units = next(leaves(units))[1].shape[0]
        u_caches = (_unstack(caches["units"], n_units) if caches
                    else [None] * n_units)
        # Only a graph that records the units' parameters has memory to
        # save.
        remat = (cfg.remat and mode == "full" and caches is None
                 and torch.is_grad_enabled()
                 and next(leaves(units))[1].requires_grad)
        for u_params, u_cache in zip(_unstack(units, n_units), u_caches):
            groups.append(([(kind, u_params[str(i)],
                             u_cache[str(i)] if u_cache else None)
                            for i, kind in enumerate(pattern)], remat, True))
    if "rest" in stack_params:
        # Remainder layers continue the pattern from a unit boundary.
        groups.append(([(pattern[i % len(pattern)], stack_params["rest"][key],
                         caches["rest"][key] if caches else None)
                        for i, key in enumerate(sorted(stack_params["rest"],
                                                       key=int))], False,
                       False))
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for run, remat, unit in groups:
        if remat:
            x, aux = checkpoint(_apply_layers, cfg, run, x, unit,
                                use_reentrant=False, **kw)
        else:
            x, aux = _apply_layers(cfg, run, x, unit, **kw)
        if aux is not None:
            aux_total = aux_total + aux
    return x, aux_total


# ---------------------------------------------------------------------------
# Whole-model specs and parameters
# ---------------------------------------------------------------------------

def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, V = cfg.d_model, cfg.padded_vocab
    # The token embedding always exists (a stub-frontend arch still decodes
    # text tokens; its prefill may take precomputed embeddings instead).
    out: Dict[str, Any] = {"embed": P((V, d), ("vocab", "embed"), "embed")}
    if cfg.is_encdec:
        out["encoder"] = {"blocks": _stack_param_specs_enc(cfg),
                          "ln_f": layers.norm_specs(cfg)}
        out["decoder"] = {"blocks": _stack_param_specs(cfg, cfg.n_layers,
                                                       cross=True),
                          "ln_f": layers.norm_specs(cfg)}
    else:
        out["blocks"] = _stack_param_specs(cfg, cfg.n_layers)
        out["ln_f"] = layers.norm_specs(cfg)
    if not cfg.tie_embeddings:
        out["unembed"] = P((d, V), ("embed", "vocab"))
    if cfg.param_dtype == "bf16":
        # Serving deployments hold weights in bf16.
        out = tree_map(lambda s: P(s.shape, s.axes, s.init, torch.bfloat16),
                       out)
    return out


def abstract_params(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree as meta tensors (no allocation)."""
    return abstract(param_specs(cfg))


def param_axes(cfg: ModelConfig) -> Dict[str, Any]:
    return tree_axes(param_specs(cfg))


def _to_param_tree(tree, trainable: bool) -> nn.ParameterDict:
    return nn.ParameterDict({
        k: (nn.Parameter(v, requires_grad=trainable)
            if isinstance(v, torch.Tensor) else _to_param_tree(v, trainable))
        for k, v in tree.items()})


class CausalLM(nn.Module):
    """An LM (a decoder, or whisper's encoder-decoder): ``cfg`` plus the
    reference's parameter tree held as nested ``ParameterDict``s
    (``params["blocks"]["units"]["0"]["attn"]["wq"]``, stacked unit dim
    first).  ``trainable``: the parameters take gradients (training);
    serving keeps them without (``requires_grad_`` switches later)."""

    def __init__(self, cfg: ModelConfig, tree: Dict[str, Any],
                 trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self.params = _to_param_tree(tree, trainable)

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    def forward(self, batch, *, mode: str = "full", caches=None,
                cache_index=None):
        return forward(self.cfg, self, batch, mode=mode, caches=caches,
                       cache_index=cache_index)

    @torch.no_grad()
    def encode(self, frames):
        return encode(self.cfg, self, frames)

    @torch.no_grad()
    def prefill(self, batch, caches):
        return prefill(self.cfg, self, batch, caches)

    @torch.no_grad()
    def decode_step(self, caches, tokens, cache_index, enc_out=None):
        return decode_step(self.cfg, self, caches, tokens, cache_index,
                           enc_out)

    def init_cache(self, batch: int, seq_len: int):
        """A zeroed cache on the parameters' device, or, for sharded
        parameters, placed on their mesh."""
        embed = self.params["embed"]
        if is_dtensor(embed):
            return init_cache(self.cfg, batch, seq_len,
                              mesh=embed.device_mesh)
        return init_cache(self.cfg, batch, seq_len, device=self.device)


Params = Union[CausalLM, Dict[str, Any]]


def param_tree(params: Params):
    """The nested parameter tree (a ``CausalLM``'s ``params``)."""
    return params.params if isinstance(params, CausalLM) else params


def _generator(generator: Union[int, torch.Generator],
               device: torch.device) -> torch.Generator:
    if isinstance(generator, torch.Generator):
        return generator
    return torch.Generator(device=device).manual_seed(int(generator))


def init_params(cfg: ModelConfig, generator: Union[int, torch.Generator] = 0,
                device: DeviceLike = None,
                trainable: bool = False) -> CausalLM:
    """Seeded random parameters on ``device`` (``None``: the card).
    ``generator`` is a seed or a ``torch.Generator`` on that device;
    ``trainable``: the parameters take gradients."""
    dev = resolve_device(device)
    with torch.no_grad():
        tree = initialize(param_specs(cfg), _generator(generator, dev), dev)
    return CausalLM(cfg, tree, trainable=trainable)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _sinusoid(seq: int, d: int) -> np.ndarray:
    """The encoder's positions: computed in float64 numpy and cast to f32,
    as the reference computes them."""
    pos = np.arange(seq)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d)
    return np.concatenate([np.sin(ang), np.cos(ang)], -1).astype(np.float32)


def _sinusoid_at(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal embedding at positions (B, S) -> (B, S, d), in f32."""
    i = torch.arange(d // 2, dtype=torch.float32,
                     device=positions.device)[None, None, :]
    ang = positions[..., None].float() / torch.pow(10000.0, 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def _positions(cache_index, B: int, S: int, device) -> torch.Tensor:
    steps = torch.arange(S, device=device)
    if cache_index is None:
        return steps[None].expand(B, S)
    ci = layers.scalar_index(cache_index)
    if ci is not None:
        return (ci + steps)[None].expand(B, S)
    # Per-row cache positions (serving slots at diverging lengths).
    return cache_index[:, None] + steps[None, :]


def _written_positions(caches, cross: bool) -> Optional[int]:
    """Positions of the attention caches a decode call writes, the least
    of them: every self-attention cache (``.../attn/k``), and the cross
    caches (``.../xattn/k``) when ``cross`` (a call without an encoder
    output writes them too).  None without caches or without an
    attention layer (a recurrent layer's cache has no positions)."""
    if caches is None:
        return None
    ends = ("/attn/k", "/xattn/k") if cross else ("/attn/k",)
    return min((t.shape[-2] for path, t in leaves(caches)
                if path.endswith(ends)), default=None)


def _on(x, dev) -> torch.Tensor:
    """``x`` as a tensor on ``dev``; a DTensor stays as it is."""
    return x if is_dtensor(x) else torch.as_tensor(x, device=dev)


def _sharded(p) -> bool:
    """The parameters are DTensors (on a mesh)."""
    return is_dtensor(p["embed"])


def encode(cfg: ModelConfig, params: Params, frames) -> torch.Tensor:
    """Whisper-style encoder over precomputed (stub) frame embeddings
    (B, n_frames, d): sinusoidal positions, then bidirectional attention
    blocks; (B, n_frames, d) bf16."""
    p = param_tree(params)
    with replicating(_sharded(p)):
        return _encode(cfg, p, frames)


def _encode(cfg: ModelConfig, p, frames) -> torch.Tensor:
    dev = p["embed"].device
    x = _on(frames, dev).to(COMPUTE_DTYPE)
    B, S = x.shape[0], x.shape[1]
    pos = torch.from_numpy(_sinusoid(S, cfg.d_model)).to(dev)
    x = x + pos.to(COMPUTE_DTYPE)[None]
    x, _ = _apply_stack(cfg, p["encoder"]["blocks"], x,
                        positions=_positions(None, B, S, dev), mode="full",
                        bidir=True, pattern=("attn",))
    return layers.apply_norm(cfg, p["encoder"]["ln_f"], x)


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, Any], *,
            mode: str = "full", caches=None, cache_index=None):
    """Returns (logits f32 (B, S, V), caches, aux).  ``batch`` holds
    ``tokens``, or ``embeds`` (B, S, d) for an ``input_mode="embeddings"``
    model; an encoder-decoder also takes ``frames`` (encoded here) or
    ``enc_out`` (``encode``'s output).  ``caches`` is the tree passed in,
    updated in place (None without one); ``aux`` is the MoE load-balance
    loss summed over the layers, a 0-d f32 tensor (0 without MoE
    blocks)."""
    p = param_tree(params)
    with replicating(_sharded(p)):
        return _forward(cfg, p, batch, mode, caches, cache_index)


def _forward(cfg: ModelConfig, p, batch, mode, caches, cache_index):
    embed = p["embed"]
    dev = embed.device
    xa = None
    if cfg.is_encdec:
        xa = (_encode(cfg, p, batch["frames"]) if "frames" in batch
              else batch.get("enc_out"))
    if cfg.input_mode == "embeddings" and "embeds" in batch:
        x = _on(batch["embeds"], dev).to(COMPUTE_DTYPE)
        B, S = x.shape[0], x.shape[1]
    else:
        tokens = _on(batch["tokens"], dev).long()
        B, S = tokens.shape
        # On a mesh the lookup takes whole rows of the table: a lookup on
        # vocab shards leaves a masked partial sum that DTensor cannot
        # reduce once the batch is sharded too.
        x = torch.nn.functional.embedding(
            tokens, whole_dim(embed, 0)).to(COMPUTE_DTYPE)
    x = constrain(x, ("batch", None, None))
    if is_dtensor(cache_index):
        cache_index = cache_index.full_tensor()
    if cache_index is not None and layers.scalar_index(cache_index) is None:
        s_max = _written_positions(caches, cross=xa is None)
        if s_max is not None and not isinstance(cache_index, torch.Tensor):
            # Host positions are checked before upload: the reference
            # drops a write past the cache, the port refuses it.
            if not all(0 <= int(c) < s_max for c in cache_index):
                raise ValueError(f"per-row cache_index "
                                 f"{[int(c) for c in cache_index]} "
                                 f"outside the cache's {s_max} positions")
        cache_index = torch.as_tensor(cache_index, device=dev).long()
    positions = _positions(cache_index, B, S, dev)
    if cfg.is_encdec and cfg.rope_theta <= 0:
        x = x + _sinusoid_at(positions, cfg.d_model).to(COMPUTE_DTYPE)
    stack_p = p["decoder"] if cfg.is_encdec else p
    flag = caches.get(ssm.STATE_BF16) if caches is not None else None
    x, aux = _apply_stack(cfg, stack_p["blocks"], x, positions=positions,
                          mode=mode, caches=caches, cache_index=cache_index,
                          xa=xa, state_bf16=True if flag is None
                          else bool(flag))
    if flag is not None:
        # A decode leaves the reference's SSD state f32, a full-mode call
        # bf16.
        flag.fill_(mode != "decode")
    x = layers.apply_norm(cfg, stack_p["ln_f"], x)
    # Serving on a mesh (no graph) gathers the table over the dims that
    # shard the batch (``layers.weight``), so no rank sums partial logits
    # in bf16.  A training step keeps DTensor's own placement of the
    # product, which forms the table's gradient in one product a rank
    # where the gathered table's would be bf16 partials reduced over the
    # batch axes (a loss ~1.8e-3 off one device's after three steps).
    table = embed if cfg.tie_embeddings else p["unembed"]
    table = (table.to(x.dtype) if torch.is_grad_enabled()
             else layers.weight(table, x))
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, table)
    else:
        logits = x @ table
    logits = constrain(logits, ("batch", None, "vocab"))
    return logits.float(), caches, aux


def loss_fn(cfg: ModelConfig, params: Params, batch) -> torch.Tensor:
    """Next-token cross entropy over the positions whose ``labels`` are
    >= 0, plus 0.01 x the MoE load-balance loss: a 0-d f32 tensor.
    ``batch`` is ``forward``'s plus ``labels`` (B, S)."""
    p = param_tree(params)
    with replicating(_sharded(p)):
        logits, _, aux = _forward(cfg, p, batch, "full", None, None)
        labels = _on(batch["labels"], logits.device).long()
        logz = torch.logsumexp(logits, -1)
        if is_dtensor(logits):
            # A gather on vocab-sharded logits is not right on a shard; a
            # one-hot select is, and sums to the same value.
            vocab = torch.arange(logits.shape[-1], device=logits.device)
            hot = labels.clamp_min(0)[..., None] == vocab
            gold = torch.where(hot, logits, 0.0).sum(-1)
        else:
            gold = logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
        mask = (labels >= 0).float()
        ce = ((logz - gold) * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
        return ce + 0.01 * aux


# ---------------------------------------------------------------------------
# Caches / serving entry points
# ---------------------------------------------------------------------------

def cache_specs(cfg: ModelConfig, batch: int, seq_len: int) -> Dict[str, Any]:
    cross_len = cfg.n_audio_frames if cfg.is_encdec else 0
    return _stack_cache_specs(cfg, cfg.n_layers, batch, seq_len, cross_len)


def cache_shardings(cfg: ModelConfig, caches, mesh):
    """The ``NamedSharding`` of every leaf of a cache tree (plain, meta or
    DTensor leaves; the host flag ``ssm.STATE_BF16`` left out) on
    ``mesh``: its ``cache_specs`` axes resolved by the rules of
    ``cfg.sharding_profile``, the counterpart of the reference's
    ``shardings_for(tree_axes(cache_specs(...)))``."""
    tree = {k: v for k, v in caches.items() if k != ssm.STATE_BF16}
    return sharding.shardings_for(
        tree_axes(cache_specs(cfg, 1, 1)), tree, mesh,
        sharding.RULE_PROFILES[cfg.sharding_profile])


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device: DeviceLike = None, *, mesh=None) -> Dict[str, Any]:
    """Zeroed cache tree on ``device`` (``None``: the card).  A model with
    SSD layers also gets the host flag ``ssm.STATE_BF16``, True: a fresh
    state is bf16 in the reference.

    With ``mesh`` every leaf is a DTensor placed by ``cache_shardings``
    and each rank allocates only its own block, on the mesh's device (or
    ``device="meta"``: an abstract tree, nothing allocated)."""
    if mesh is None:
        # Zeros draw nothing from the generator.
        tree = initialize(cache_specs(cfg, batch, seq_len), None,
                          resolve_device(device))
    else:
        dev = (torch.device("meta") if str(device) == "meta"
               else sharding.mesh_device(mesh))
        abstract_tree = abstract(cache_specs(cfg, batch, seq_len))

        def zeros(t, sh):
            block = t[sharding.local_slices(t.shape, sh)]
            return sharding.from_local(
                torch.zeros(block.shape, dtype=t.dtype, device=dev), mesh,
                sh.placements, t.shape)
        tree = map_tree(zeros, abstract_tree,
                        cache_shardings(cfg, abstract_tree, mesh))
    if "ssd" in cfg.layer_pattern:
        tree[ssm.STATE_BF16] = torch.tensor(True)
    return tree


@torch.no_grad()
def prefill(cfg: ModelConfig, params: Params, batch, caches):
    """Full-sequence forward that fills the decode cache; returns
    (last_logits (B, V), caches)."""
    logits, caches, _ = forward(cfg, params, batch, mode="full",
                                caches=caches, cache_index=0)
    return logits[:, -1], caches


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Params, caches, tokens,
                cache_index, enc_out=None):
    """One decode step: tokens (B, 1) -> (logits (B, V), caches).

    ``cache_index`` is a scalar (all rows at the same position) or a (B,)
    vector of per-row positions; each row's KV is written at its own
    position either way.  ``enc_out``: an encoder-decoder's encoder
    output (without it, the cross-attention layers run the reference's
    self-attention branch over their own caches).
    """
    batch = {"tokens": tokens}
    if cfg.is_encdec:
        batch["enc_out"] = enc_out
    logits, caches, _ = forward(cfg, params, batch, mode="decode",
                                caches=caches, cache_index=cache_index)
    return logits[:, -1], caches


# ---------------------------------------------------------------------------
# input_specs: meta-tensor stand-ins for a batch (no allocation)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """The batch an (arch x shape) step takes, as meta tensors: the
    reference's keys, shapes and dtypes, caches from ``abstract(
    cache_specs(...))``."""
    B, S = shape.global_batch, shape.seq_len
    tok = _meta((B, S), torch.int32)
    frames = lambda: _meta((B, cfg.n_audio_frames, cfg.d_model),
                           COMPUTE_DTYPE)
    if shape.kind == "train":
        if cfg.is_encdec:
            return {"frames": frames(), "tokens": tok, "labels": tok}
        if cfg.input_mode == "embeddings":
            return {"embeds": _meta((B, S, cfg.d_model), COMPUTE_DTYPE),
                    "labels": tok}
        return {"tokens": tok, "labels": tok}
    if shape.kind == "prefill":
        base: Dict[str, Any] = {"caches": abstract(cache_specs(cfg, B, S))}
        if cfg.is_encdec:
            base.update({"frames": frames(), "tokens": tok})
        elif cfg.input_mode == "embeddings":
            base["embeds"] = _meta((B, S, cfg.d_model), COMPUTE_DTYPE)
        else:
            base["tokens"] = tok
        return base
    if shape.kind == "decode":
        base = {"caches": abstract(cache_specs(cfg, B, S)),
                "tokens": _meta((B, 1), torch.int32),
                "cache_index": _meta((), torch.int32)}
        if cfg.is_encdec:
            base["enc_out"] = frames()
        return base
    raise ValueError(shape.kind)
