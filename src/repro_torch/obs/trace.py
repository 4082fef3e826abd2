"""Structured nested spans for the match stack (DESIGN.md Sec. 3l).

A ``Tracer`` records a tree of timed spans around every stage of a
request's life -- service enqueue/coalesce, planner decision, corpus
pack/splice/compact, filter, per-chunk launch, cross-shard merge and
host pull.  Zero dependencies (stdlib only): the match stack can thread
a tracer everywhere without importing anything heavy, and the disabled
path is a true no-op.

Design constraints, in order:

* **Disabled means free.**  ``Tracer(enabled=False).span(name)`` returns
  one module-level singleton no-op context manager -- no ``Span``
  object, no dict, no list append; the hot per-chunk loop pays two
  method calls and nothing else.  Tests assert zero allocations on this
  path (``tests/test_obs.py``).  Attribute dicts are therefore passed
  as an optional positional ``attrs`` mapping, never ``**kwargs`` (a
  kwargs dict would be materialized even when disabled); hot callers
  guard dict construction with ``tracer.enabled``.
* **Times are honest.**  Every span carries a monotonic start/end
  (``time.perf_counter``) for durations; a wall-clock start for
  correlation with external logs is derived at export time from the
  tracer's paired ``perf_counter``/``time.time`` epochs (no per-span
  wall-clock read on the hot path).  CUDA launches are
  asynchronous: a ``launch`` span measures dispatch, the blocking
  device->host transfer lands in the enclosing ``pull`` span -- the
  trace shows where the *host* actually waited, which is what serving
  latency is made of.
* **Exportable two ways.**  ``write_jsonl`` emits one JSON object per
  span (machine-diffable); ``chrome_trace`` / ``write_chrome`` emit the
  Chrome trace-event format (``{"traceEvents": [...]}`` with complete
  "X" events in microseconds), loadable directly in Perfetto / Chrome
  ``about:tracing`` for timeline viewing.

Optional ``torch.profiler`` hook: ``Tracer(profiler=True)`` additionally
enters a ``torch.profiler.record_function`` range per span, so spans
line up with kernel activity inside a captured ``torch.profiler``
trace.  The import is lazy; the module itself never imports torch.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

# Stage names the per-request timing breakdown aggregates over
# (MatchResult.timings / ServiceStats.snapshot()["timings"]).  The span
# taxonomy is larger (service.*, splice, compact, bank scans); these are
# the stages every request's critical path decomposes into.
STAGES: Tuple[str, ...] = ("plan", "pack", "filter", "launch", "merge",
                           "pull")

# Spans the port records and ``repro.obs`` does not: host work between
# the reference's spans, named so a traced run can charge it.  None is a
# stage.
PORT_SPANS: Dict[str, str] = {
    "service.plan": "Planner.plan_batch pricing one group: fused or one "
                    "launch a query",
    "service.scatter": "a fused launch's per-query result views, cache "
                       "entries and ticket completions",
    "assemble": "the per-chunk blocks joined into the result's arrays",
    "hits": "a gathered hot block's threshold hits found and mapped to "
            "rows on the host",
}

_ATTR_TYPES = (str, int, float, bool, type(None))
_np_generic = None   # cached numpy scalar base; resolved on first use


def _coerce(value: Any) -> Any:
    """Typed attributes only: pass through JSON scalars, stringify rest."""
    if isinstance(value, _ATTR_TYPES):
        return value
    global _np_generic
    if _np_generic is None:
        try:
            import numpy as _np  # localized: obs itself stays stdlib-only
            _np_generic = _np.generic
        except Exception:
            _np_generic = ()
    if _np_generic and isinstance(value, _np_generic):
        return value.item()
    return str(value)


class _NoopSpan:
    """Shared do-nothing span: the disabled tracer's entire cost."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, key: str, value: Any) -> None:
        pass


NOOP_SPAN = _NoopSpan()


class Span:
    """One timed stage: monotonic times, typed attrs, children.

    The hot path is deliberately lean (the overhead gate in
    ``BENCH_match_obs.json`` depends on it): one ``perf_counter`` call
    per boundary, no wall-clock read (derived from the tracer's paired
    epochs at export), no attrs dict unless the caller passed or set
    one, and attribute *coercion* deferred to export -- ``set`` coerces
    eagerly since mid-span values may be mutated later by the caller,
    constructor attrs are coerced when serialized.
    """

    __slots__ = ("tracer", "name", "span_id", "parent_id", "t0", "t1",
                 "attrs", "children", "_prof")

    def __init__(self, tracer: "Tracer", name: str,
                 attrs: Optional[Dict[str, Any]]):
        self.tracer = tracer
        self.name = name
        self.t1: Optional[float] = None
        self.attrs: Optional[Dict[str, Any]] = attrs
        self.children: List["Span"] = []
        self._prof = None

    # -- context protocol ------------------------------------------------------
    def __enter__(self) -> "Span":
        tr = self.tracer
        tr._n_spans += 1
        self.span_id = tr._n_spans
        stack = tr._stack
        self.parent_id = stack[-1].span_id if stack else None
        stack.append(self)
        if tr._annotation is not None:
            self._prof = tr._annotation(self.name)
            self._prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter()
        if self._prof is not None:
            self._prof.__exit__(*exc)
            self._prof = None
        tr = self.tracer
        stack = tr._stack
        # Tolerate a corrupted stack (an exception unwinding through
        # nested spans) instead of mis-attributing children.
        while stack and stack[-1] is not self:
            stack.pop()
        if stack:
            stack.pop()
        if stack:
            stack[-1].children.append(self)
        elif len(tr.roots) < tr.max_spans:
            tr.roots.append(self)
        else:
            tr.n_dropped += 1
        return False

    # -- attributes ------------------------------------------------------------
    def set(self, key: str, value: Any) -> None:
        """Attach one typed attribute mid-span."""
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = _coerce(value)

    @property
    def wall0(self) -> float:
        """Wall-clock start, derived from the tracer's paired epochs."""
        return self.tracer.wall_epoch + (self.t0 - self.tracer.t_epoch)

    @property
    def duration_s(self) -> float:
        return (self.t1 - self.t0) if self.t1 is not None else 0.0

    def walk(self) -> Iterator["Span"]:
        """This span and every descendant, depth-first, start order."""
        yield self
        for ch in self.children:
            yield from ch.walk()

    def stage_seconds(self, stages: Sequence[str] = STAGES
                      ) -> Dict[str, float]:
        """Disjoint per-stage self-times under this span.

        A stage span's time is its duration minus the time of stage
        spans nested inside it (a ``pull`` inside ``filter`` counts as
        pull, not twice), so the stage values sum to at most this span's
        duration and read as a true breakdown.
        """
        out = {s: 0.0 for s in stages}
        known = set(stages)

        def visit(span: "Span") -> float:
            child_stage = 0.0
            for ch in span.children:
                child_stage += visit(ch)
            if span.name in known:
                out[span.name] += max(0.0, span.duration_s - child_stage)
                return span.duration_s
            return child_stage
        for ch in self.children:
            visit(ch)
        if self.name in known:
            out[self.name] += max(0.0,
                                  self.duration_s - sum(out.values()))
        return out

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.duration_s * 1e3:.3f}ms, "
                f"{len(self.children)} children)")


class Tracer:
    """Span recorder with a bounded root store and two export formats.

    Single-threaded by design (the whole match stack is); ``enabled``
    may be flipped at runtime, in-flight spans finish normally.
    ``max_spans`` bounds retained *root* spans (a serve run's requests);
    overflow increments ``n_dropped`` instead of growing without bound.
    """

    def __init__(self, *, enabled: bool = False, profiler: bool = False,
                 max_spans: int = 100_000):
        self.enabled = bool(enabled)
        self.max_spans = int(max_spans)
        self.roots: List[Span] = []
        self.n_dropped = 0
        self._stack: List[Span] = []
        self._n_spans = 0
        # perf_counter epoch for trace-event timestamps; wall epoch for
        # human correlation (recorded in trace metadata).
        self.t_epoch = time.perf_counter()
        self.wall_epoch = time.time()
        self._annotation = None
        if profiler:
            from torch.profiler import record_function
            self._annotation = record_function

    @property
    def n_spans(self) -> int:
        """Spans started since construction or the last ``clear()``
        (dropped roots included)."""
        return self._n_spans

    def span(self, name: str, attrs: Optional[Dict[str, Any]] = None):
        """Context manager for one stage; free no-op when disabled."""
        if not self.enabled:
            return NOOP_SPAN
        return Span(self, name, attrs)

    def current(self) -> Optional[Span]:
        """Innermost open span (None outside any span or when disabled)."""
        return self._stack[-1] if self._stack else None

    def clear(self) -> None:
        self.roots = []
        self._stack = []
        self.n_dropped = 0
        self._n_spans = 0

    def iter_spans(self) -> Iterator[Span]:
        for root in self.roots:
            yield from root.walk()

    # -- export ----------------------------------------------------------------
    @staticmethod
    def _attrs_out(span: Span) -> Dict[str, Any]:
        """Coerce constructor attrs at export (kept raw on the hot path)."""
        if not span.attrs:
            return {}
        return {k: _coerce(v) for k, v in span.attrs.items()}

    def _span_record(self, span: Span) -> Dict[str, Any]:
        return {
            "span_id": span.span_id,
            "parent_id": span.parent_id,
            "name": span.name,
            "wall0": span.wall0,
            "t0_s": span.t0 - self.t_epoch,
            "dur_s": span.duration_s,
            "attrs": self._attrs_out(span),
        }

    def to_jsonl(self) -> str:
        """One JSON object per span (depth-first, start order)."""
        return "\n".join(json.dumps(self._span_record(s))
                         for s in self.iter_spans())

    def write_jsonl(self, path) -> int:
        n = 0
        with open(path, "w") as fh:
            for s in self.iter_spans():
                fh.write(json.dumps(self._span_record(s)) + "\n")
                n += 1
        return n

    def chrome_trace(self, *, pid: int = 0) -> Dict[str, Any]:
        """Chrome/Perfetto trace-event JSON (complete "X" events, us).

        All spans ride one pid/tid (the stack is single-threaded);
        Perfetto nests same-track events by time containment, which
        matches the span tree exactly.
        """
        events = []
        for s in self.iter_spans():
            events.append({
                "name": s.name,
                "cat": "match",
                "ph": "X",
                "ts": (s.t0 - self.t_epoch) * 1e6,
                "dur": s.duration_s * 1e6,
                "pid": pid,
                "tid": 0,
                "args": self._attrs_out(s),
            })
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "wall_epoch": self.wall_epoch,
                "n_spans": self._n_spans,
                "n_dropped_roots": self.n_dropped,
            },
        }

    def write_chrome(self, path, *, pid: int = 0) -> int:
        trace = self.chrome_trace(pid=pid)
        with open(path, "w") as fh:
            json.dump(trace, fh)
        return len(trace["traceEvents"])
