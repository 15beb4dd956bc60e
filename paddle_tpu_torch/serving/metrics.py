"""Serving metrics: per-model counters and reservoir histograms, after
paddle_tpu/serving/metrics.py (the same counters, snapshot keys and
reservoir).

Everything here is a plain in-process structure whose `snapshot()` is
wire-encodable (str keys, numbers, lists), so the same dict travels over
the `stats` verb and into bench output.  Histograms are fixed-capacity
reservoirs (Vitter's algorithm R): O(1) memory however long the server
runs.  QPS is reported two ways: lifetime average and a sliding recent
window.  The compile-cache, paging and resource-estimate fields of the
JAX snapshot wait with those subsystems (ROADMAP.md queue 1).
"""

import collections
import random
import threading
import time

__all__ = ["Counter", "ReservoirHistogram", "ModelMetrics",
           "ServingMetrics"]


class Counter:
    """Monotonic counter; `add` returns the new total."""

    def __init__(self):
        self._value = 0
        self._lock = threading.Lock()

    def add(self, n=1):
        with self._lock:
            self._value += n
            return self._value

    @property
    def value(self):
        return self._value


class ReservoirHistogram:
    """Fixed-memory histogram over an unbounded stream: keeps a uniform
    random sample of `capacity` observations (reservoir sampling), plus
    exact count/sum/min/max.  Percentiles interpolate over the sorted
    reservoir — accurate to the sample, never unbounded in memory."""

    def __init__(self, capacity=512, seed=0):
        self.capacity = int(capacity)
        self._samples = []
        self._count = 0
        self._sum = 0.0
        self._min = None
        self._max = None
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def record(self, value):
        v = float(value)
        with self._lock:
            self._count += 1
            self._sum += v
            self._min = v if self._min is None else min(self._min, v)
            self._max = v if self._max is None else max(self._max, v)
            if len(self._samples) < self.capacity:
                self._samples.append(v)
            else:
                j = self._rng.randrange(self._count)
                if j < self.capacity:
                    self._samples[j] = v

    @property
    def count(self):
        return self._count

    def percentile(self, q):
        """Linear-interpolated percentile (q in [0,100]) over the
        reservoir; None when empty."""
        with self._lock:
            s = sorted(self._samples)
        if not s:
            return None
        if len(s) == 1:
            return s[0]
        pos = (len(s) - 1) * (float(q) / 100.0)
        lo = int(pos)
        hi = min(lo + 1, len(s) - 1)
        frac = pos - lo
        return s[lo] * (1.0 - frac) + s[hi] * frac

    def summary(self):
        with self._lock:
            n, total = self._count, self._sum
            mn, mx = self._min, self._max
        out = {"count": n}
        if n:
            out.update({
                "mean": total / n, "min": mn, "max": mx,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99),
            })
        return out


class ModelMetrics:
    """One served model's telemetry: request/response/shed counters, a
    latency + queue-wait histogram, and dispatch geometry (how full each
    micro-batch ran).  The batcher installs `queue_depth_fn` so depth is
    read live at snapshot time rather than sampled."""

    QPS_WINDOW_SECS = 60.0

    def __init__(self, name, precision="fp32"):
        self.name = name
        # the numerics lane these counters meter: an int8
        # A/B sibling of the same model name gets its OWN ModelMetrics,
        # so per-precision QPS/latency/compile-cache rows never blur
        self.precision = str(precision or "fp32")
        self.requests = Counter()        # accepted submits
        self.responses = Counter()       # futures resolved with a result
        self.errors = Counter()          # futures resolved with an error
        self.shed = Counter()            # rejected at admission
        self.deadline_expired = Counter()  # dropped overdue pre-dispatch
        self.dispatches = Counter()      # micro-batches executed
        self.coalesced = Counter()       # requests carried by dispatches
        self.batch_slots = Counter()     # real rows dispatched
        self.padded_slots = Counter()    # pad rows added to reach bucket
        self.latency_ms = ReservoirHistogram()
        self.queue_wait_ms = ReservoirHistogram()
        # generation telemetry (continuous batching): one
        # stream = one autoregressive request; tokens are the decode
        # throughput unit, TTFT the decode latency unit
        self.streams = Counter()         # streaming requests admitted
        self.prefills = Counter()        # prefill phases run
        self.decode_tokens = Counter()   # generated tokens emitted
        self.decode_steps = Counter()    # whole-slot-table step launches
        self.ttft_ms = ReservoirHistogram()  # time to first token
        # fused multi-step decode: one dispatch carries up to
        # fuse_steps tokens per slot — dispatches and the
        # tokens-per-dispatch histogram
        # are the direct readout of the host-amortization win (TPD ~1
        # at N=1, ~N·occupancy when fused)
        self.decode_dispatches = Counter()  # device dispatches issued
        self.tokens_per_dispatch = ReservoirHistogram()
        # speculative decoding: drafts/accepts telemetry —
        # the accept rate IS the speedup dial (tokens per verify step =
        # 1 + accepted/round), and with a same-weights draft it doubles
        # as a bit-exactness probe (any verify-vs-step numeric drift
        # shows up as a rejected draft before it shows up anywhere else)
        self.spec_rounds = Counter()     # draft->verify rounds run
        self.draft_tokens = Counter()    # draft proposals offered
        self.accepted_tokens = Counter()  # proposals accepted by verify
        self.spec_degraded = Counter()   # lanes fallen back target-only
        self.accept_rate = ReservoirHistogram()  # per-round accept frac
        self._token_stamps = collections.deque()  # (t, n) recent window
        self.queue_depth_fn = None
        # installed by the batcher: live per-replica lane snapshot
        # (device id, in-flight, lane queue, batches/rows executed)
        self.replica_stats_fn = None
        # installed by the decode batcher: live (occupied, total) slot
        # count across this model's lanes — the occupancy gauge
        self.slot_occupancy_fn = None
        # installed by the decode batcher: (kv_cache_dtype, measured
        # cache bytes across lanes) — the quantized-KV-cache axis the
        # bench A/B reads
        self.kv_cache_fn = None
        self._shed_by_priority = {}      # priority class -> shed count
        self._started = time.monotonic()
        # (t, latency_ms) completion stamps: one deque feeds BOTH the
        # recent-QPS window and the SLO monitor's interval-windowed
        # p95 (obs/slo.py) — the lifetime reservoir would blur a fresh
        # regression under hours of healthy history
        self._completions = collections.deque()
        self._ttft_stamps = collections.deque()  # (t, ttft_ms) recent
        self._lock = threading.Lock()

    def note_shed(self, priority=0):
        """One admission shed of the given priority class (lowest-
        priority-first overload policy)."""
        self.shed.add()
        with self._lock:
            key = int(priority)
            self._shed_by_priority[key] = \
                self._shed_by_priority.get(key, 0) + 1

    def note_completion(self, latency_ms, queue_wait_ms=None):
        self.responses.add()
        self.latency_ms.record(latency_ms)
        if queue_wait_ms is not None:
            self.queue_wait_ms.record(queue_wait_ms)
        now = time.monotonic()
        with self._lock:
            self._completions.append((now, float(latency_ms)))
            horizon = now - self.QPS_WINDOW_SECS
            while self._completions and \
                    self._completions[0][0] < horizon:
                self._completions.popleft()

    def note_spec(self, proposed, accepted):
        """One speculative round: `proposed` draft tokens offered to
        the verify step, `accepted` of them greedily accepted."""
        self.spec_rounds.add()
        if proposed:
            self.draft_tokens.add(int(proposed))
            self.accepted_tokens.add(int(accepted))
            self.accept_rate.record(accepted / proposed)

    def note_prefill(self, ttft_ms):
        """One prefill completed: the request's first token exists —
        the TTFT instant (time_to_first_token satellite metric)."""
        self.prefills.add()
        self.ttft_ms.record(ttft_ms)
        now = time.monotonic()
        with self._lock:
            self._ttft_stamps.append((now, float(ttft_ms)))
            horizon = now - self.QPS_WINDOW_SECS
            while self._ttft_stamps and \
                    self._ttft_stamps[0][0] < horizon:
                self._ttft_stamps.popleft()

    def note_decode_dispatch(self, tokens):
        """One decode dispatch completed, having emitted `tokens`
        stream tokens across its slots (0 counts too — an all-
        cancelled window is still a dispatch the host paid for)."""
        self.decode_dispatches.add()
        self.tokens_per_dispatch.record(float(tokens))

    def note_tokens(self, n):
        """`n` generated tokens emitted (across whatever slots the step
        served); feeds both the lifetime counter and the recent
        tokens/sec window."""
        self.decode_tokens.add(n)
        now = time.monotonic()
        with self._lock:
            self._token_stamps.append((now, int(n)))
            horizon = now - self.QPS_WINDOW_SECS
            while self._token_stamps and \
                    self._token_stamps[0][0] < horizon:
                self._token_stamps.popleft()

    def tokens_per_sec(self):
        """Recent-window aggregate generation rate — the continuous-
        batching acceptance number (>= 2x static batching on the mixed-
        length lane)."""
        now = time.monotonic()
        with self._lock:
            horizon = now - self.QPS_WINDOW_SECS
            while self._token_stamps and \
                    self._token_stamps[0][0] < horizon:
                self._token_stamps.popleft()
            total = sum(n for _, n in self._token_stamps)
            if not total:
                return 0.0
            span = min(self.QPS_WINDOW_SECS, now - self._started)
        return total / max(span, 1e-9)

    def note_dispatch(self, n_requests, real_rows, padded_rows):
        self.dispatches.add()
        self.coalesced.add(n_requests)
        self.batch_slots.add(real_rows)
        self.padded_slots.add(padded_rows)

    def recent_qps(self):
        now = time.monotonic()
        with self._lock:
            horizon = now - self.QPS_WINDOW_SECS
            while self._completions and \
                    self._completions[0][0] < horizon:
                self._completions.popleft()
            n = len(self._completions)
            if not n:
                return 0.0
            span = min(self.QPS_WINDOW_SECS, now - self._started)
        return n / max(span, 1e-9)

    @staticmethod
    def _window_p95(stamps, window_s):
        now = time.monotonic()
        horizon = now - max(float(window_s), 1e-3)
        vals = sorted(v for t, v in stamps if t >= horizon)
        if not vals:
            return None
        if len(vals) == 1:
            return vals[0]
        pos = (len(vals) - 1) * 0.95
        lo = int(pos)
        hi = min(lo + 1, len(vals) - 1)
        frac = pos - lo
        return vals[lo] * (1.0 - frac) + vals[hi] * frac

    def recent_latency_p95(self, window_s):
        """p95 latency over completions in the last `window_s` seconds
        (None with no traffic) — the SLO monitor's interval SLI; the
        window is capped by QPS_WINDOW_SECS of retained stamps."""
        with self._lock:
            stamps = list(self._completions)
        return self._window_p95(stamps, window_s)

    def recent_ttft_p95(self, window_s):
        """p95 time-to-first-token over prefills in the last
        `window_s` seconds (None for one-shot models / no streams)."""
        with self._lock:
            stamps = list(self._ttft_stamps)
        return self._window_p95(stamps, window_s)

    def snapshot(self):
        uptime = time.monotonic() - self._started
        dispatches = self.dispatches.value
        slots = self.batch_slots.value
        padded = self.padded_slots.value
        snap = {
            "model": self.name,
            "precision": self.precision,
            "uptime_sec": round(uptime, 3),
            "requests": self.requests.value,
            "responses": self.responses.value,
            "errors": self.errors.value,
            "shed": self.shed.value,
            "deadline_expired": self.deadline_expired.value,
            "dispatches": dispatches,
            "qps_recent": round(self.recent_qps(), 3),
            "qps_lifetime": round(self.responses.value / max(uptime, 1e-9),
                                  3),
            # requests per dispatch: > 1 means cross-request coalescing
            # is actually happening (the acceptance criterion's number)
            "batch_fill": round(self.coalesced.value / dispatches, 3)
            if dispatches else 0.0,
            # real rows / (real + pad) rows: how much of each bucket the
            # traffic filled — the utilization lever
            "bucket_fill_ratio": round(slots / (slots + padded), 3)
            if (slots + padded) else 0.0,
            "latency_ms": self.latency_ms.summary(),
            "queue_wait_ms": self.queue_wait_ms.summary(),
        }
        if self.streams.value or self.slot_occupancy_fn is not None:
            # generation telemetry, flat keys so the Prometheus render
            # picks them up with zero schema plumbing
            snap["streams"] = self.streams.value
            snap["prefills"] = self.prefills.value
            snap["decode_tokens"] = self.decode_tokens.value
            snap["decode_steps"] = self.decode_steps.value
            snap["decode_dispatches"] = self.decode_dispatches.value
            snap["tokens_per_dispatch"] = \
                self.tokens_per_dispatch.summary()
            snap["tokens_per_sec"] = round(self.tokens_per_sec(), 3)
            snap["ttft_ms"] = self.ttft_ms.summary()
            if self.slot_occupancy_fn is not None:
                try:
                    occupied, total = self.slot_occupancy_fn()
                    snap["slot_occupancy"] = round(
                        occupied / total, 3) if total else 0.0
                    snap["decode_slots"] = int(total)
                    snap["decode_slots_busy"] = int(occupied)
                except Exception:
                    snap["slot_occupancy"] = -1.0
            if self.kv_cache_fn is not None:
                try:
                    kv_dtype, kv_bytes = self.kv_cache_fn()
                    snap["kv_cache_dtype"] = str(kv_dtype)
                    snap["kv_cache_bytes"] = int(kv_bytes)
                except Exception:
                    pass
        if self.spec_rounds.value or self.spec_degraded.value:
            # speculative decoding telemetry (the Prometheus spec_*
            # families)
            proposed = self.draft_tokens.value
            snap["spec_rounds"] = self.spec_rounds.value
            snap["draft_tokens"] = proposed
            snap["accepted_tokens"] = self.accepted_tokens.value
            snap["spec_degraded"] = self.spec_degraded.value
            snap["spec_accept_rate"] = round(
                self.accepted_tokens.value / proposed, 4) \
                if proposed else 0.0
            snap["accept_rate"] = self.accept_rate.summary()
        if self.queue_depth_fn is not None:
            try:
                snap["queue_depth"] = int(self.queue_depth_fn())
            except Exception:
                snap["queue_depth"] = -1
        with self._lock:
            if self._shed_by_priority:
                # str keys: the snapshot must stay wire-encodable
                snap["shed_by_priority"] = {
                    str(k): v
                    for k, v in sorted(self._shed_by_priority.items())}
        if self.replica_stats_fn is not None:
            try:
                snap["replicas"] = list(self.replica_stats_fn())
            except Exception:
                snap["replicas"] = []
        return snap


class ServingMetrics:
    """The server-wide registry: one ModelMetrics per model name (shared
    across that model's versions — a hot swap does not reset counters)."""

    def __init__(self):
        self._models = {}
        self._lock = threading.Lock()
        self._started = time.monotonic()

    def model(self, name, precision=None):
        """One ModelMetrics per (name, precision lane).  The fp32 lane
        keeps the bare-name key (and so the pre-quantization wire
        schema); other lanes key as ``name@precision`` — two lanes of
        one model render as two rows in stats and Prometheus."""
        key = name if precision in (None, "fp32") \
            else "%s@%s" % (name, precision)
        with self._lock:
            m = self._models.get(key)
            if m is None:
                m = self._models[key] = ModelMetrics(
                    name, precision=precision or "fp32")
            return m

    def drop(self, name):
        with self._lock:
            self._models.pop(name, None)
            for key in [k for k in self._models
                        if k.startswith(name + "@")]:
                self._models.pop(key, None)

    def snapshot(self):
        with self._lock:
            models = dict(self._models)
        return {
            "uptime_sec": round(time.monotonic() - self._started, 3),
            "models": {name: m.snapshot() for name, m in models.items()},
        }
