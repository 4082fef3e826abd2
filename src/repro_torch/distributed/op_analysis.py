"""Per-op cost counter: flops, bytes and collective traffic of one rank's
step (the port's counterpart of ``repro.distributed.hlo_analysis``).

The reference walks the optimized HLO text of a compiled step and
multiplies each ``while`` body by its trip count.  The port has no HLO:
it runs the step eagerly, so this module counts the ops the step
dispatches, under a ``TorchDispatchMode`` (``OpCounter``), usually on
meta tensors (``launch.dryrun``: nothing is allocated or computed).
Every layer and microbatch runs in turn, so there is no trip count to
recover: the count is the sum over the ops run.

* DTensor ops reach the mode twice: once with DTensor arguments at the
  global shape, then, after DTensor's dispatch, as the local ops on this
  rank's shards and the collectives between them.  The counter declines
  the first (``NotImplemented``, as ``CommDebugMode`` does) and counts the
  second: one rank's work, never the global op.  Ops on fake tensors
  (DTensor's sharding propagation, which runs an op at the global shape
  the first time it meets its signature) are not counted either.
* **Flops**: a matmul-family op (``mm``, ``bmm``, ``addmm``, ...) 2 M K N
  from its shapes; an elementwise op one flop an output element; a
  reduction one flop an input element (``_flops_only``'s rules; a
  softmax, which the reference sees as two reductions and three
  elementwise ops, five an element).
* **bytes_strict**: every op's inputs plus outputs, what the eager port
  moves (views are free: they move nothing).
* **bytes**: the heavy ops' (``HEAVY_OPS``: matmuls, reductions,
  gathers, scatters, slice writes, sorts) plus the movement ops a fused
  program would keep (copies, concatenations); elementwise ops and the
  movement a fusion absorbs (casts, creation, padding) are charged to
  ``bytes_strict`` only, as the reference charges them.  A gather
  charges twice its output, a slice write or a scatter twice its
  update.
* **Collectives**: count and input bytes by the reference's five kinds
  (``COLLECTIVES``), from the ``_c10d_functional`` ops (and DTensor's
  ``shard_dim_alltoall``) the redistributions issue.
* **Memory**: the bytes of the storages that ops create and that are
  still alive, at their peak (``peak_bytes``): the counterpart of XLA's
  temporary buffers.

``Cost``, ``Roofline``, ``roofline_from_cost`` and
``top_bytes_contributors`` keep the reference's names; the roofline
defaults to the card's rates (``core.tech.H100``), not a TPU's.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.tech import H100

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# Functional-collective (and DTensor) ops -> the reference's kinds.  A
# broadcast moves one rank's block to the others, the permute's traffic.
COLLECTIVE_KIND = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}

_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "matmul", "mv",
           "dot", "_scaled_mm", "linear"}

ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "neg", "exp", "expm1", "log",
    "log1p", "tanh", "rsqrt", "sqrt", "pow", "sigmoid", "maximum",
    "minimum", "where", "eq", "ne", "lt", "le", "gt", "ge", "abs", "clamp",
    "clamp_min", "clamp_max", "logaddexp", "sin", "cos", "round", "floor",
    "ceil", "sign", "remainder", "fmod", "erf", "bitwise_and",
    "bitwise_or", "bitwise_xor", "bitwise_not", "logical_and",
    "logical_or", "logical_not", "square", "reciprocal", "addcmul",
    "addcdiv", "lerp", "silu", "gelu", "relu", "sigmoid_backward",
    "tanh_backward", "threshold_backward", "masked_fill", "isnan",
    "isinf", "atan2", "exp2", "trunc", "sgn", "frac",
}

# Reductions: one flop an input element (``_SOFTMAX``: five).
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "prod", "var",
           "std", "var_mean", "norm", "linalg_vector_norm", "cumsum",
           "cumprod", "argmax", "argmin", "any", "all", "logsumexp",
           "_softmax_backward_data", "_log_softmax_backward_data"}
_SOFTMAX = {"_softmax", "_log_softmax", "logsumexp"}

_GATHER = {"index", "index_select", "gather", "embedding", "take",
           "embedding_dense_backward"}
_SCATTER = {"index_put", "index_put_", "scatter", "scatter_add",
            "scatter_add_", "scatter_", "index_add", "index_add_",
            "index_copy", "index_copy_", "masked_scatter",
            "_index_put_impl_"}
_SORT = {"sort", "topk", "argsort"}

# Movement a fused program keeps (charged to ``bytes``); the slice write
# (``copy_`` into a view: ``dynamic-update-slice``) charges its update.
_MOVEMENT = {"clone", "cat", "stack", "repeat", "flip", "roll",
             "copy", "copy_", "slice_scatter", "select_scatter",
             "diagonal_scatter", "narrow_copy", "expand_copy",
             "unbind_copy", "split_copy", "_unsafe_index"}
# Movement a fusion absorbs (``_FUSED_AWAY``: casts, creation, padding):
# ``bytes_strict`` only.
_FUSED_AWAY = {"_to_copy", "to", "zeros", "zeros_like", "ones",
               "ones_like", "full", "full_like", "empty", "empty_like",
               "empty_strided", "new_zeros", "new_ones", "new_full",
               "new_empty", "new_empty_strided", "arange", "fill", "zero",
               "scalar_tensor", "constant_pad_nd", "pad",
               "lift_fresh", "_local_scalar_dense", "tril", "triu",
               "_to_copy_", "contiguous", "resize_", "set_"}

HEAVY_OPS = _MATMUL | _REDUCE | _SOFTMAX | _GATHER | _SCATTER | _SORT | {
    "convolution", "copy_", "slice_scatter", "select_scatter"}


def _base(func) -> str:
    """``aten.add_.Tensor`` -> ``add``; in-place and out variants map to
    their functional op (but the ops whose name ends in ``_`` by
    themselves, ``copy_`` and the scatters)."""
    name = func.__name__.split(".")[0]
    if name in COLLECTIVE_KIND or name in HEAVY_OPS or name in _MOVEMENT:
        return name
    return name[:-1] if name.endswith("_") else name


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _tensors(e)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _matmul_flops(name: str, args) -> float:
    a, b = args[0], args[1]
    if name in ("addmm", "baddbmm", "addbmm"):
        a, b = args[1], args[2]
    if a.dim() == 1 or b.dim() == 1:          # mv / dot
        return 2.0 * a.numel() * (b.shape[-1] if b.dim() > 1 else 1)
    out = math.prod(a.shape[:-1]) * b.shape[-1]
    flops = 2.0 * out * a.shape[-1]
    if name in ("addmm", "baddbmm", "addbmm"):
        flops += out                          # the added input
    return flops


@dataclasses.dataclass
class Cost:
    """``bytes`` is the fused-program proxy traffic (matmul / reduction
    / gather / scatter / kept movement); ``bytes_strict`` additionally
    charges every elementwise op and absorbed movement, what the eager
    port moves.  ``peak_bytes``: the most bytes of storages made during
    the step alive at once."""

    flops: float = 0.0
    bytes: float = 0.0
    bytes_strict: float = 0.0
    coll_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})
    coll_counts: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})
    peak_bytes: float = 0.0
    n_ops: int = 0

    def add(self, other: "Cost") -> None:
        self.flops += other.flops
        self.bytes += other.bytes
        self.bytes_strict += other.bytes_strict
        for k in COLLECTIVES:
            self.coll_bytes[k] += other.coll_bytes[k]
            self.coll_counts[k] += other.coll_counts[k]
        self.n_ops += other.n_ops

    @property
    def total_coll_bytes(self) -> float:
        return sum(self.coll_bytes.values())


def op_cost(func, args, kwargs, out) -> Tuple[str, Cost]:
    """(kind key, cost) of one plain-tensor op: its flops, bytes and
    collective traffic by the module's rules."""
    name = _base(func)
    c = Cost(n_ops=1)
    ins = _tensors(list(args) + list((kwargs or {}).values()))
    outs = _tensors(out)
    in_b, out_b = _nbytes(ins), _nbytes(outs)
    if name in COLLECTIVE_KIND:
        kind = COLLECTIVE_KIND[name]
        c.coll_counts[kind] += 1
        c.coll_bytes[kind] += in_b or out_b
        return kind, c
    if name in _MATMUL:
        c.flops = _matmul_flops(name, args)
        c.bytes = c.bytes_strict = in_b + out_b
    elif name == "convolution":
        c.flops = 2.0 * sum(t.numel() for t in outs)
        c.bytes = c.bytes_strict = in_b + out_b
    elif name in ELEMENTWISE:
        c.flops = float(sum(t.numel() for t in outs))
        c.bytes_strict = in_b + out_b
    elif name in _SOFTMAX or name in _REDUCE:
        per = 5.0 if name in _SOFTMAX else 1.0
        c.flops = per * (ins[0].numel() if ins else 0)
        c.bytes = c.bytes_strict = in_b + out_b
    elif name in _GATHER:
        c.bytes = c.bytes_strict = 2 * out_b         # read slice + write
    elif name in _SCATTER or name in ("copy_", "slice_scatter",
                                      "select_scatter"):
        # The update is the last tensor argument (``copy_``'s source,
        # ``index_put``'s values, a scatter's src).
        upd = ins[-1] if ins else None
        c.bytes = c.bytes_strict = 2 * (_nbytes([upd]) if upd is not None
                                        else out_b)
    elif name in _SORT or name in _MOVEMENT:
        c.bytes = c.bytes_strict = in_b + out_b
    elif name in _FUSED_AWAY:
        c.bytes_strict = in_b + out_b
    else:
        # A view (``view``, ``permute``, ``slice``, ``expand``, ...), a
        # ``wait_tensor``, a detach: nothing moves.
        c.n_ops = 0
    return name, c


class OpCounter(TorchDispatchMode):
    """Counts the plain-tensor ops dispatched while active (DTensor ops
    are left to DTensor, whose local ops come back here): ``cost`` the
    totals, ``by_op`` the cost by op name (``top_bytes_contributors``).
    Storages the ops create are tracked while alive: ``cost.peak_bytes``
    is the most alive at once."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.by_op: Dict[str, Cost] = {}
        # storage -> (its bytes, {id: weakref} of the tensors on it)
        self._live: Dict[int, Tuple[int, Dict[int, weakref.ref]]] = {}
        self._live_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if any(issubclass(t, FakeTensor) for t in types) or any(
                isinstance(t, FakeTensor) for t in _tensors(out)):
            # DTensor's sharding propagation runs the op on fake tensors
            # at the global shape (the first time it meets a signature):
            # shape inference, not the rank's work.
            return out
        name, c = op_cost(func, args, kwargs, out)
        if c.n_ops or name in COLLECTIVE_KIND:
            self.cost.add(c)
            self.by_op.setdefault(name, Cost()).add(c)
        for t in _tensors(out):
            self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        try:
            st = t.untyped_storage()
        except (NotImplementedError, RuntimeError):
            return
        key = st._cdata
        entry = self._live.get(key)
        if entry is None:
            entry = (st.nbytes(), {})
            self._live[key] = entry
            self._live_bytes += entry[0]
            self.cost.peak_bytes = max(self.cost.peak_bytes,
                                       self._live_bytes)
        ref = weakref.ref(t, lambda r, k=key: self._release(k, r))
        entry[1][id(ref)] = ref

    def _release(self, key: int, ref) -> None:
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1].pop(id(ref), None)
        if not entry[1]:
            del self._live[key]
            self._live_bytes -= entry[0]


def count_ops(fn: Callable, *args, **kwargs) -> Tuple[object, OpCounter]:
    """(``fn(*args, **kwargs)``, the ``OpCounter`` that counted it)."""
    with OpCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter


# ---------------------------------------------------------------------------
# Roofline terms
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Roofline:
    """Per-device roofline terms in seconds."""

    flops: float
    hbm_bytes: float
    collective_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    collectives: Dict[str, float]
    collective_counts: Dict[str, float]


def top_bytes_contributors(counter: OpCounter, n: int = 15
                           ) -> List[Tuple[str, float]]:
    """The heaviest op names by ``bytes`` (the fused-program proxy), as
    the reference lists its heaviest HLO ops for the perf loop."""
    items = [(k, c.bytes) for k, c in counter.by_op.items() if c.bytes]
    return sorted(items, key=lambda kv: -kv[1])[:n]


def roofline_from_cost(cost: Cost, peak_flops: float = H100.peak_bf16_flops,
                       hbm_bw: float = H100.hbm_bw,
                       link_bw: float = H100.nvlink_bw) -> Roofline:
    """The three terms, by default at the card's data-sheet rates (bf16
    tensor-core peak, HBM3, one direction of NVLink 4)."""
    terms = {
        "compute": cost.flops / peak_flops,
        "memory": cost.bytes / hbm_bw,
        "collective": cost.total_coll_bytes / link_bw,
    }
    dom = max(terms, key=terms.get)
    return Roofline(cost.flops, cost.bytes, cost.total_coll_bytes,
                    terms["compute"], terms["memory"], terms["collective"],
                    dom, dict(cost.coll_bytes), dict(cost.coll_counts))
