"""Unified metrics surface, after paddle_tpu/obs/registry.py (the same
families, labels and text).

``MetricsRegistry`` absorbs into ONE Prometheus-style exposition:

* every attached ``ServingMetrics`` (the server attaches at start,
  detaches at shutdown): their ``snapshot()`` dicts are flattened into
  labeled metric families at render time, so a hot swap keeps its
  no-counter-reset semantics;
* every attached ``SLOMonitor``'s burn-rate / compliance / state rows;
* span aggregates: the registry listens to the tracing ring and keeps
  per-(kind, name) call counts and total milliseconds;
* the tracing ring's and the event log's own health.

``prometheus_text()`` renders it (``# TYPE`` headers, ``name{label="v"}
value`` samples) for the server's ``metrics`` verb.  The metric names
keep the JAX package's ``paddle_tpu_`` prefix, so one scraper reads
either server.  The compile-cache, fleet, federation and flight-recorder
families wait with those subsystems (ROADMAP.md queue 1).
"""

import threading

__all__ = ["MetricsRegistry", "default"]

_PREFIX = "paddle_tpu_"

# ServingMetrics snapshot ints rendered as labeled counters
_SERVING_COUNTERS = ("requests", "responses", "errors", "shed",
                     "deadline_expired", "dispatches",
                     # generation counters (absent for one-shot models)
                     "streams", "prefills", "decode_tokens",
                     "decode_steps",
                     # fused multi-step decode (SERVING.md): dispatches
                     # issued — tokens/dispatches is the amortization
                     "decode_dispatches",
                     # speculative decoding (absent without a draft)
                     "spec_rounds", "draft_tokens", "accepted_tokens",
                     "spec_degraded")
# ... and floats rendered as labeled gauges
_SERVING_GAUGES = ("qps_recent", "qps_lifetime", "batch_fill",
                   "bucket_fill_ratio", "queue_depth",
                   # continuous-batching decode gauges (SERVING.md)
                   "tokens_per_sec", "slot_occupancy",
                   # measured KV slot-table bytes across lanes — reads
                   # ~0.25x under kv_cache_dtype=int8 (QUANTIZE.md
                   # "Quantized KV cache")
                   "kv_cache_bytes",
                   # lifetime draft accept fraction (SERVING.md
                   # speculative decoding — the speedup dial)
                   "spec_accept_rate")
_SERVING_HISTS = ("latency_ms", "queue_wait_ms", "ttft_ms",
                  "tokens_per_dispatch")
_QUANTILES = ("p50", "p95", "p99")


def _esc(v):
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
                 .replace("\n", "\\n")


def _labels(d):
    if not d:
        return ""
    return "{%s}" % ",".join('%s="%s"' % (k, _esc(v))
                             for k, v in sorted(d.items()))


def _num(v):
    if isinstance(v, float):
        return repr(round(v, 6))
    return str(v)


class MetricsRegistry(object):
    def __init__(self):
        self._lock = threading.Lock()
        self._serving = []     # attached ServingMetrics
        self._slo = []         # attached SLOMonitors (obs/slo.py)
        self._span_agg = {}    # (kind, name) -> [count, total_ms]

    # -- absorbed sources --------------------------------------------

    def attach_serving(self, serving_metrics):
        with self._lock:
            if serving_metrics not in self._serving:
                self._serving.append(serving_metrics)

    def detach_serving(self, serving_metrics):
        with self._lock:
            if serving_metrics in self._serving:
                self._serving.remove(serving_metrics)

    def attach_slo(self, monitor):
        """Absorb one SLOMonitor: its burn-rate / compliance / state
        gauges render as first-class families."""
        with self._lock:
            if monitor not in self._slo:
                self._slo.append(monitor)

    def detach_slo(self, monitor):
        with self._lock:
            if monitor in self._slo:
                self._slo.remove(monitor)

    def note_span(self, span):
        """Tracing-ring listener: fold one completed span into the
        per-(kind, name) totals."""
        key = (span.kind, span.name)
        with self._lock:
            rec = self._span_agg.get(key)
            if rec is None:
                self._span_agg[key] = [1, span.dur_ms]
            else:
                rec[0] += 1
                rec[1] += span.dur_ms

    def span_totals(self, kind=None):
        """{(kind, name): {"count", "total_ms"}} — the per-stage time
        budget (trace_top's aggregate view reads this via metrics)."""
        with self._lock:
            return {k: {"count": v[0], "total_ms": round(v[1], 3)}
                    for k, v in self._span_agg.items()
                    if kind is None or k[0] == kind}

    # -- exposition ---------------------------------------------------

    @staticmethod
    def _model_labels(model_key, m, **extra):
        """Label set of one serving lane: the plain model name plus a
        ``precision`` label for non-fp32 lanes (the QUANTIZE.md A/B
        axis — an int8 lane keys as 'name@int8' in the snapshot but
        scrapes as model='name', precision='int8')."""
        labels = {"model": m.get("model", model_key)}
        prec = m.get("precision")
        if prec and prec != "fp32":
            labels["precision"] = prec
        labels.update(extra)
        return labels

    def _render_serving(self, lines):
        snaps = []
        with self._lock:
            serving = list(self._serving)
        for sm in serving:
            try:
                snaps.append(sm.snapshot())
            except Exception:
                continue
        for field in _SERVING_COUNTERS:
            mname = _PREFIX + "serving_%s_total" % field
            samples = []
            for snap in snaps:
                for model, m in sorted(snap.get("models", {}).items()):
                    if field in m:
                        samples.append(
                            (mname, self._model_labels(model, m),
                             m[field]))
            _family(lines, mname, "counter", samples)
        for field in _SERVING_GAUGES:
            mname = _PREFIX + "serving_" + field
            samples = []
            for snap in snaps:
                for model, m in sorted(snap.get("models", {}).items()):
                    if field in m:
                        samples.append(
                            (mname, self._model_labels(model, m),
                             m[field]))
            _family(lines, mname, "gauge", samples)
        for hist_field in _SERVING_HISTS:
            mname = _PREFIX + "serving_" + hist_field
            samples = []
            for snap in snaps:
                for model, m in sorted(snap.get("models", {}).items()):
                    if hist_field not in m:
                        continue  # e.g. ttft_ms on a one-shot model
                    h = m.get(hist_field) or {}
                    for q in _QUANTILES:
                        if h.get(q) is not None:
                            samples.append(
                                (mname,
                                 self._model_labels(model, m,
                                                    quantile=q),
                                 h[q]))
                    samples.append((mname + "_count",
                                    self._model_labels(model, m),
                                    h.get("count", 0)))
            _family(lines, mname, "summary", samples)
        # priority-shed + per-model compile-cache attribution
        samples = []
        for snap in snaps:
            for model, m in sorted(snap.get("models", {}).items()):
                for pri, n in sorted(
                        (m.get("shed_by_priority") or {}).items()):
                    samples.append((_PREFIX + "serving_shed_by_priority_"
                                    "total",
                                    self._model_labels(model, m,
                                                       priority=pri),
                                    n))
        _family(lines, _PREFIX + "serving_shed_by_priority_total",
                "counter", samples)
        # static resource estimates: per-replica peak memory and
        # one-step FLOPs (set by the admission fit check, which waits
        # for analysis/: no port's snapshot carries them yet)
        for field, mname in (("est_peak_mb",
                              _PREFIX + "model_est_peak_mb"),
                             ("est_flops",
                              _PREFIX + "model_est_flops")):
            samples = []
            for snap in snaps:
                for model, m in sorted(snap.get("models", {}).items()):
                    if field in m:
                        samples.append(
                            (mname, self._model_labels(model, m),
                             m[field]))
            _family(lines, mname, "gauge", samples)
        # mesh shape per replica lane (SERVING.md "Mesh replicas"):
        # member-device count of each lane — 1 for a plain single-chip
        # replica; a dead mesh lane keeps exporting so a scraper can
        # still see the shape it lost
        samples = []
        for snap in snaps:
            for model, m in sorted(snap.get("models", {}).items()):
                for row in m.get("replicas") or []:
                    samples.append(
                        (_PREFIX + "replica_mesh_size",
                         self._model_labels(
                             model, m,
                             replica=str(row.get("replica", "")),
                             device=str(row.get("device", ""))),
                         int(row.get("mesh", 1) or 1)))
        _family(lines, _PREFIX + "replica_mesh_size", "gauge", samples)

    def _render_slo(self, lines):
        """Burn-rate / compliance / state families from every attached
        SLOMonitor (its [(metric, labels, value, type)] export rows)."""
        with self._lock:
            monitors = list(self._slo)
        by_name = {}
        for mon in monitors:
            try:
                rows = mon.export()
            except Exception:
                continue
            for metric, labels, value, mtype in rows:
                by_name.setdefault((metric, mtype), []).append(
                    (_PREFIX + metric, labels, value))
        for (metric, mtype), samples in sorted(by_name.items()):
            _family(lines, _PREFIX + metric, mtype, samples)

    def prometheus_text(self):
        """The one metrics surface, Prometheus text exposition."""
        lines = []
        # span aggregates: training per-stage breakdown + serving stages
        with self._lock:
            agg = sorted((k, list(v)) for k, v in self._span_agg.items())
        _family(lines, _PREFIX + "span_ms_total", "counter",
                [(_PREFIX + "span_ms_total",
                  {"kind": k or "none", "span": n}, round(v[1], 3))
                 for (k, n), v in agg])
        _family(lines, _PREFIX + "span_count_total", "counter",
                [(_PREFIX + "span_count_total",
                  {"kind": k or "none", "span": n}, v[0])
                 for (k, n), v in agg])
        self._render_serving(lines)
        self._render_slo(lines)
        # subsystem health: tracing ring and event log
        # — each a FIRST-CLASS family (span drops, event drops, sink
        # state) so a scraper can alert on telemetry loss directly
        from . import events, tracing
        ts = tracing.stats()
        _family(lines, _PREFIX + "trace_spans_total", "counter",
                [(_PREFIX + "trace_spans_total", {}, ts["spans_total"])])
        _family(lines, _PREFIX + "trace_buffered", "gauge",
                [(_PREFIX + "trace_buffered", {}, ts["buffered"])])
        _family(lines, _PREFIX + "trace_dropped_total", "counter",
                [(_PREFIX + "trace_dropped_total", {}, ts["dropped"])])
        es = events.stats()
        _family(lines, _PREFIX + "events_total", "counter",
                [(_PREFIX + "events_total", {}, es["events_total"])])
        _family(lines, _PREFIX + "events_buffered", "gauge",
                [(_PREFIX + "events_buffered", {}, es["buffered"])])
        _family(lines, _PREFIX + "events_dropped_total", "counter",
                [(_PREFIX + "events_dropped_total", {}, es["dropped"])])
        _family(lines, _PREFIX + "events_rotations_total", "counter",
                [(_PREFIX + "events_rotations_total", {},
                  es["rotations"])])
        # 1 = a configured file sink has died (memory-only fallback);
        # 0 covers both "healthy sink" and "no sink configured"
        _family(lines, _PREFIX + "events_sink_dead", "gauge",
                [(_PREFIX + "events_sink_dead", {},
                  int(es["sink_dead"]))])
        return "\n".join(lines) + "\n"


def _family(lines, name, mtype, samples):
    if not samples:
        return
    lines.append("# TYPE %s %s" % (name, mtype))
    for sname, labels, value in samples:
        lines.append("%s%s %s" % (sname, _labels(labels), _num(value)))


_default = None
_default_lock = threading.Lock()


def default():
    """The process-wide registry; first use wires it as the tracing
    ring's span listener so train/serving stage totals accumulate."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                reg = MetricsRegistry()
                from . import tracing
                tracing.set_span_listener(reg.note_span)
                _default = reg
    return _default
