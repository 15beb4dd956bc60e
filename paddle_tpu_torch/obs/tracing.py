"""Span tracing over a fixed-size ring buffer, after
paddle_tpu/obs/tracing.py (the same Span records, ring and API).

A thread-safe ``Span`` record + ``trace()`` context manager write
completed spans into a bounded ring (``FLAGS.trace_buffer_events``):

* the hot path never blocks and never raises: a span append is one
  ``deque.append`` on a maxlen deque (old spans fall off the far end;
  overflow is silent and counted);
* disabled tracing (``FLAGS.trace = False``) is one module-global bool
  test: ``trace()`` returns a shared no-op context manager;
* spans are plain data (name, trace_id, kind, wall start, duration,
  small attr dict), wire-encodable as dicts so the serving ``trace``
  verb ships them unchanged.

Trace ids: every serving request gets one minted at admission (or
carries one in on the wire ``"trace_id"`` field, echoed in the reply).
A trace id groups the request's stage spans (queue_wait / coalesce /
lane_wait / dispatch / compute / scatter), stamped from contiguous
timestamps so they sum to the root ``serving/request`` span.
"""

import collections
import random
import threading
import time

__all__ = ["Span", "trace", "new_trace_id", "enabled", "chrome_events",
           "set_enabled", "configure", "recent_spans", "spans_for_trace",
           "clear", "stats", "add_span"]

_lock = threading.Lock()           # guards reconfiguration only
_ring = collections.deque(maxlen=4096)
_enabled = True
_spans_total = 0                   # lifetime appends (overflow = total - len)
_rng = random.Random()
_configured = False

# one listener hook: the MetricsRegistry aggregates train/serving span
# totals without the emitters knowing about metrics at all
_on_span = None


class Span(object):
    """One completed timed region.  ``ts`` is wall-clock epoch seconds
    (chrome-trace compatible); ``dur_ms`` the measured duration;
    ``attrs`` a SMALL dict of wire-encodable values (str/int/float)."""

    __slots__ = ("name", "kind", "trace_id", "ts", "dur_ms", "attrs",
                 "thread")

    def __init__(self, name, kind="", trace_id=None, ts=None, dur_ms=0.0,
                 attrs=None, thread=None):
        self.name = name
        self.kind = kind
        self.trace_id = trace_id
        self.ts = time.time() if ts is None else ts
        self.dur_ms = dur_ms
        self.attrs = attrs or {}
        self.thread = threading.get_ident() if thread is None else thread

    def to_dict(self):
        d = {"name": self.name, "kind": self.kind, "ts": self.ts,
             "dur_ms": round(self.dur_ms, 4)}
        if self.trace_id is not None:
            d["trace_id"] = self.trace_id
        if self.attrs:
            d["attrs"] = {str(k): (v if isinstance(v, (int, float, bool))
                                   else str(v))
                          for k, v in self.attrs.items()}
        return d

    def __repr__(self):
        return "Span(%r, %.2fms, trace=%s, %s)" % (
            self.name, self.dur_ms, self.trace_id, self.attrs)


def new_trace_id():
    """16 hex chars, random.  Cheap (no uuid machinery) and long enough
    that a collision inside one ring buffer's lifetime is negligible."""
    return "%016x" % _rng.getrandbits(64)


def _flag(name, default):
    """Read a flag, tolerating a half-initialized flag registry (the
    on_change hooks can fire while flags.py itself is importing)."""
    try:
        from ..flags import FLAGS
        return getattr(FLAGS, name)
    except Exception:
        return default


def _ensure_configured():
    """Lazy first-use sync with FLAGS (flags may be set before this
    module is ever imported; on_change hooks keep us in sync after)."""
    global _configured
    if _configured:
        return
    with _lock:
        if _configured:
            return
        _apply(_flag("trace", _enabled),
               _flag("trace_buffer_events", _ring.maxlen))
        _configured = True


def _apply(enabled_, capacity):
    global _enabled, _ring
    _enabled = bool(enabled_)
    capacity = max(int(capacity), 1)
    if capacity != _ring.maxlen:
        _ring = collections.deque(_ring, maxlen=capacity)


def configure(enabled=None, capacity=None):
    """Reconfigure the tracer (flags on_change hooks route here)."""
    global _configured
    with _lock:
        _apply(_flag("trace", _enabled) if enabled is None else enabled,
               _flag("trace_buffer_events", _ring.maxlen)
               if capacity is None else capacity)
        _configured = True


def enabled():
    _ensure_configured()
    return _enabled


def set_enabled(on):
    global _enabled, _configured
    _enabled = bool(on)
    _configured = True


def set_span_listener(fn):
    """Install the single span listener (MetricsRegistry aggregation);
    None removes it.  Listener exceptions are swallowed — telemetry must
    never take down the traffic it observes."""
    global _on_span
    _on_span = fn


def add_span(span):
    """Append one completed Span.  The hot-path primitive: instrumented
    code that stamps its own timestamps (the batcher's contiguous stage
    spans) builds Spans directly and lands them here."""
    global _spans_total
    _ring.append(span)
    _spans_total += 1
    if _on_span is not None:
        try:
            _on_span(span)
        except Exception:
            pass


class _NullCtx(object):
    """Shared no-op context manager: the disabled-tracing fast path."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False


_NULL = _NullCtx()


class _LiveSpan(object):
    """Context manager for one in-progress span; ``__exit__`` stamps the
    duration and lands it in the ring.  An exception inside the region
    still records the span (with ``error`` attr) and propagates."""

    __slots__ = ("_span", "_t0")

    def __init__(self, span):
        self._span = span
        self._t0 = time.perf_counter()

    def __enter__(self):
        return self._span

    def __exit__(self, exc_type, exc, tb):
        s = self._span
        s.dur_ms = (time.perf_counter() - self._t0) * 1e3
        if exc_type is not None:
            s.attrs = dict(s.attrs, error=exc_type.__name__)
        add_span(s)
        return False


def trace(name, kind="", trace_id=None, **attrs):
    """``with trace("serving/compute", trace_id=tid, step=3): ...`` —
    the span API everything instruments through.  Returns a no-op
    context when tracing is disabled (one bool test, no allocation)."""
    _ensure_configured()
    if not _enabled:
        return _NULL
    return _LiveSpan(Span(name, kind=kind, trace_id=trace_id,
                          attrs=attrs))


def clear():
    global _spans_total
    with _lock:
        _ring.clear()
        _spans_total = 0


def stats():
    """Ring statistics for the metrics surface."""
    return {"enabled": _enabled, "capacity": _ring.maxlen or 0,
            "buffered": len(_ring), "spans_total": _spans_total,
            "dropped": max(_spans_total - len(_ring), 0)}


def recent_spans(limit=None, kind=None, name=None):
    """Most-recent-last list of span dicts (wire-encodable).  Snapshot
    is GIL-consistent; concurrent appends during iteration are fine."""
    spans = list(_ring)
    if kind:
        spans = [s for s in spans if s.kind == kind]
    if name:
        spans = [s for s in spans if s.name == name]
    if limit is not None and len(spans) > limit:
        spans = spans[-int(limit):]
    return [s.to_dict() for s in spans]


def spans_for_trace(trace_id):
    """Every buffered span of one trace, oldest first — the span tree a
    reply-visible trace_id resolves to."""
    return [s.to_dict() for s in list(_ring) if s.trace_id == trace_id]


def chrome_events(spans=None, pid=None):
    """Span dicts as chrome-trace ``X`` events, one thread row per span
    kind, so they merge into the torch.profiler timeline
    (fluid/profiler.py export_chrome_tracing)."""
    import os
    if spans is None:
        spans = recent_spans()
    pid = os.getpid() if pid is None else pid
    out = [{"ph": "M", "pid": pid, "name": "process_name",
            "args": {"name": "paddle_tpu_torch obs spans"}}]
    tids = {}
    for s in spans:
        kind = s.get("kind") or "obs"
        tid = tids.get(kind)
        if tid is None:
            tid = tids[kind] = len(tids) + 1
            out.append({"ph": "M", "pid": pid, "tid": tid,
                        "name": "thread_name",
                        "args": {"name": "obs:%s" % kind}})
        args = dict(s.get("attrs") or {})
        if s.get("trace_id"):
            args["trace_id"] = s["trace_id"]
        out.append({"ph": "X", "pid": pid, "tid": tid,
                    "name": s["name"], "ts": s["ts"] * 1e6,
                    "dur": s["dur_ms"] * 1e3, "args": args})
    return out
