"""paddle_tpu_torch.obs — span tracing and unified telemetry, after
paddle_tpu/obs (pure Python, the port's own copy):

* ``tracing`` — ``Span``/``trace()`` over a fixed ring buffer
  (``FLAGS.trace_buffer_events``); serving requests carry a ``trace_id``
  minted at admission;
* ``events`` — the structured event log (hot-swap flips, sheds,
  deadline expiries, slow requests, degraded speculative lanes, SLO
  transitions), a memory ring plus an optional JSONL file;
* ``registry`` — ``MetricsRegistry``: one Prometheus-style exposition of
  the attached ServingMetrics, SLO monitors and span aggregates, served
  by the ``metrics`` verb;
* ``slo`` — declared per-model SLOs with multi-window burn rates and the
  ok/degraded/breach state the ``health`` verb renders.

The flight recorder (``obs/flightrec.py``) waits (ROADMAP.md queue 1).
Importing this package installs the default registry as the span ring's
listener, so per-stage aggregates accumulate from the first span.
"""

from . import events, tracing  # noqa: F401
from .tracing import (Span, new_trace_id, recent_spans,  # noqa: F401
                      spans_for_trace, trace)
from .events import emit, recent_events  # noqa: F401
from . import registry  # noqa: F401
from .registry import MetricsRegistry  # noqa: F401
from .registry import default as default_registry  # noqa: F401
from . import slo  # noqa: F401
from .slo import SLO, SLOMonitor  # noqa: F401

__all__ = ["tracing", "events", "registry", "trace", "Span",
           "new_trace_id", "recent_spans", "spans_for_trace", "emit",
           "recent_events", "MetricsRegistry", "default_registry",
           "slo", "SLO", "SLOMonitor"]

default_registry()
