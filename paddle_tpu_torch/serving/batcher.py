"""Serving batchers of the port, after paddle_tpu/serving/batcher.py:
the cross-request `DynamicBatcher` for one-shot models and the
continuous-batching `DecodeBatcher` for autoregressive decode, each over
one or more replica lanes.

DynamicBatcher: many callers each submit a small (often batch-1)
request; the predictor wants its largest batch bucket.  The batcher
closes that gap:

  * a bounded queue per model (admission control: a submit past
    `max_queue` is shed with `ServerOverloaded`, never parked on an
    unbounded backlog).  Requests carry a `priority`: under overload an
    arriving request evicts the lowest strictly-lower-priority queued
    request, or is shed itself;
  * a router thread takes the head request, greedily pulls compatible
    queued requests until the largest bucket is full or the
    `FLAGS.serving_batch_deadline_ms` window expires, then hands the
    group to the least-loaded replica lane (fewest in-flight batches,
    then shortest lane queue).  When every lane holds `lane_depth`
    groups the router waits, so overload sheds at admission;
  * requests coalesce only when their feed names, trailing shapes,
    dtypes and side-feed bytes agree (side feeds ride through whole);
    batch-major feeds are concatenated, the predictor pads the merged
    batch to its bucket, and the lane scatters each caller's rows back
    to its Future — replies are bit-equal to a direct `Predictor.run`
    at the same bucket.

DecodeBatcher: each request is many tiny steps over growing state, so
the lever is slot occupancy over time.  Each replica lane keeps one
DecodeSession (slot-indexed KV cache, inference/decode.py) and runs a
continuous loop: a waiting request joins the RUNNING decode batch the
step after any slot frees (EOS / max-new-tokens / deadline / cancel).
`continuous=False` is the static-batching baseline.  With a draft
predictor and `spec_k` >= 1 a lane runs speculative rounds; with
`fuse_steps` N > 1 one dispatch runs a fused window of up to N steps
(one CUDA-graph replay on the card).  Every stream is bit-identical to
the one-token-per-step path.

Both batchers land the `serving/*` stage spans of obs/tracing.py under
each request's trace id, and the `shed`, `deadline_expired`, `slow` and
`spec_degraded` events of obs/events.py.  A failed dispatch fails its
requests typed; a failed decode step ends its lane (its streams fail
with the error, and `lane_stats()` names it).  Mesh and tensor-parallel
lanes wait (ROADMAP.md queue 1, item 12).

Chaos: `set_dispatch_delay(secs)` (or env
`PADDLE_TPU_SERVING_CHAOS="dispatch_delay=<secs>"`) injects a stall in
every dispatch; `set_draft_delay` and `set_host_delay` price a draft
step and a decode dispatch's host round-trip the same way.
"""

import binascii
import collections
import os
import queue as queue_mod
import threading
import time
from concurrent.futures import Future

import numpy as np

from ..flags import FLAGS
from ..obs import events as obs_events
from ..obs import tracing as obs_tracing

__all__ = ["DynamicBatcher", "DecodeBatcher", "DecodeStream",
           "ServerOverloaded", "DeadlineExceeded", "BatcherClosed",
           "set_dispatch_delay", "set_draft_delay", "set_host_delay"]

_CHAOS_ENV = "PADDLE_TPU_SERVING_CHAOS"


class ServerOverloaded(RuntimeError):
    """Admission control shed: the model's request queue is full.
    Explicit and immediate — the client can back off and retry
    (utils/retry.py jitter) instead of waiting on a hidden backlog.
    `priority` names the class of the request that was shed (the
    arriving one, or a lower-priority queued request it evicted)."""

    def __init__(self, message, priority=None):
        super().__init__(message)
        self.priority = priority


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed before its dispatch completed."""


class BatcherClosed(RuntimeError):
    """Submit on a draining/retired batcher (e.g. mid hot-swap retire),
    or on one whose every lane died."""


_dispatch_delay = 0.0


def set_dispatch_delay(secs):
    """Chaos hook: every subsequent dispatch (a one-shot group, a decode
    step, round or window) sleeps `secs` first — the in-process
    slow-worker fault (0 clears).  The sleep releases the GIL, so
    concurrent replica lanes overlap their stalls."""
    global _dispatch_delay
    _dispatch_delay = float(secs)


def _chaos_delay(key="dispatch_delay", direct=None):
    if direct is None:
        direct = _dispatch_delay
    if direct:
        return direct
    spec = os.environ.get(_CHAOS_ENV)
    if spec:
        for part in spec.split(","):
            name, _, val = part.partition("=")
            if name.strip() == key:
                try:
                    return float(val)
                except ValueError:
                    pass
    return 0.0


_draft_delay = 0.0


def set_draft_delay(secs):
    """Per-DRAFT-step stand-in cost for speculative decode lanes (the
    companion of set_dispatch_delay, which prices the target/verify
    step): every draft decode step sleeps `secs` first, GIL released
    (0 clears)."""
    global _draft_delay
    _draft_delay = float(secs)


def _draft_chaos_delay():
    return _chaos_delay(key="draft_delay", direct=_draft_delay)


_host_delay = 0.0


def set_host_delay(secs):
    """Per-DISPATCH host-side cost stand-in: every decode dispatch
    sleeps `secs` once before launching, GIL released — a model of the
    host round-trip that fused decode amortizes (at fuse_steps=N a
    stream pays it once per N tokens; 0 clears)."""
    global _host_delay
    _host_delay = float(secs)


def _host_chaos_delay():
    return _chaos_delay(key="host_cost", direct=_host_delay)


def _predictor_device_label(predictor):
    from ..inference.predictor import _device_label
    return _device_label(getattr(predictor, "device", None))


def _guarded(fn, model_name_fn, thread_kind):
    """Wrap a batcher thread main: an exception escaping the loop is a
    dead router/lane; it lands a `server_thread_death` event before
    re-raising.  (The JAX package also arms its flight recorder here,
    which waits.)"""
    def _run(*args):
        try:
            fn(*args)
        except BaseException as e:
            name = threading.current_thread().name
            obs_events.emit("server_thread_death",
                            model=model_name_fn(), thread=name,
                            thread_kind=thread_kind,
                            error="%s: %s" % (type(e).__name__, e))
            raise
    return _run


class _Request:
    __slots__ = ("feeds", "batch", "future", "group_key", "enqueued",
                 "deadline", "priority", "trace_id", "t_taken",
                 "t_grouped")

    def __init__(self, feeds, batch, group_key, deadline, priority,
                 trace_id=None):
        self.feeds = feeds
        self.batch = batch
        self.group_key = group_key
        self.deadline = deadline
        self.priority = priority
        self.future = Future()
        self.enqueued = time.monotonic()
        # observability: the request's trace id plus
        # the monotonic stamps the stage spans are cut from — contiguous
        # by construction, so queue_wait + coalesce + lane_wait +
        # dispatch + compute + scatter sums to the root span exactly
        self.trace_id = trace_id or obs_tracing.new_trace_id()
        self.t_taken = None     # router popped/pulled it off the queue
        self.t_grouped = None   # its dispatch group closed coalescing


class _Lane:
    """One replica's execution lane: a bounded ready deque feeding this
    replica's dispatch worker(s), plus the load counters the router's
    least-loaded choice reads (in-flight batches first, then queue
    length)."""

    __slots__ = ("index", "predictor", "device", "ready", "inflight",
                 "batches", "rows", "last_t", "disp_ewma")

    def __init__(self, index, predictor):
        self.index = index
        self.predictor = predictor
        self.device = _predictor_device_label(predictor)
        self.ready = collections.deque()
        self.inflight = 0   # groups a worker is currently dispatching
        self.batches = 0    # micro-batches this replica executed
        self.rows = 0       # real rows it served
        self.last_t = None  # monotonic end of this lane's last dispatch
        self.disp_ewma = None  # EWMA seconds per dispatch (run only)

    def load(self):
        return (self.inflight, len(self.ready), self.index)


class DynamicBatcher:
    """Micro-batcher over one or more replica predictors (each a
    `Predictor` — anything with `.run(dict)->list` plus the serving
    introspection quartet: `batch_buckets`, `feed_specs`,
    `batched_feed_names`, `fetch_batched_flags`).

    `replicas`: optional list of device-placed predictors sharing one
    model's weights (the registry builds them via `clone_to`); the
    batcher runs one execution lane per replica and routes each
    coalesced group to the least-loaded lane.  Without it, the single
    `predictor` forms the only lane — the pre-multichip behavior."""

    def __init__(self, predictor, max_queue=None, deadline_ms=None,
                 workers=None, metrics=None, replicas=None,
                 lane_depth=None):
        preds = list(replicas) if replicas else [predictor]
        self.predictor = predictor if predictor is not None else preds[0]
        self.max_queue = int(FLAGS.serving_max_queue
                             if max_queue is None else max_queue)
        self.deadline_s = (FLAGS.serving_batch_deadline_ms
                           if deadline_ms is None else
                           float(deadline_ms)) / 1000.0
        self.lane_depth = max(int(FLAGS.serving_lane_depth
                                  if lane_depth is None else lane_depth),
                              1)
        self.metrics = metrics
        self.buckets = tuple(self.predictor.batch_buckets())
        if self.buckets:
            self.max_batch = self.buckets[-1]
        else:
            self.max_batch = 64  # unbucketed predictor: a sane coalesce cap
        self._batched_feeds = frozenset(
            self.predictor.batched_feed_names())
        self._fetch_flags = self.predictor.fetch_batched_flags()
        self._cv = threading.Condition()
        self._pending = collections.deque()
        self._lanes = [_Lane(i, p) for i, p in enumerate(preds)]
        self._carrying = False  # router holds a taken-but-unrouted group
        self._closing = False
        self._stopped = False
        if metrics is not None:
            metrics.queue_depth_fn = lambda: len(self._pending)
            metrics.replica_stats_fn = self.replica_stats
        n_workers = max(int(FLAGS.serving_workers if workers is None
                            else workers), 1)
        self._router = threading.Thread(
            target=_guarded(self._route, lambda: self._model_name,
                            "router"),
            daemon=True, name="paddle-tpu-torch-serving-router")
        self._lane_threads = {lane.index: [] for lane in self._lanes}
        self._threads = []
        for lane in self._lanes:
            for i in range(n_workers):
                t = threading.Thread(
                    target=_guarded(self._worker,
                                    lambda: self._model_name, "lane"),
                    args=(lane,), daemon=True,
                    name="paddle-tpu-torch-serving-lane%d-%d"
                         % (lane.index, i))
                self._threads.append(t)
                self._lane_threads[lane.index].append(t)
        self._router.start()
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------------
    # submit side (admission control)
    # ------------------------------------------------------------------

    @property
    def _model_name(self):
        return self.metrics.name if self.metrics is not None else None

    def _build_request(self, feeds, deadline, priority, trace_id=None):
        named = {k: np.asarray(v) for k, v in feeds.items()}
        batch = None
        key_parts = []
        for name in sorted(named):
            arr = named[name]
            if name in self._batched_feeds and arr.ndim >= 1:
                b = arr.shape[0]
                if batch is None:
                    batch = b
                elif b != batch:
                    raise ValueError(
                        "inconsistent request batch: feed %r has leading "
                        "dim %d, another batch-major feed has %d"
                        % (name, b, batch))
                key_parts.append((name, arr.shape[1:], str(arr.dtype)))
            else:
                # side feeds must be byte-identical to share a dispatch
                key_parts.append((name, arr.shape, str(arr.dtype),
                                  binascii.crc32(
                                      np.ascontiguousarray(arr).tobytes())))
        if batch is not None and batch > self.max_batch:
            raise ValueError(
                "request batch %d exceeds the largest servable bucket %d "
                "(buckets %s) — split the request"
                % (batch, self.max_batch, self.buckets or "(none)"))
        return _Request(named, batch, tuple(key_parts), deadline,
                        int(priority), trace_id=trace_id)

    def submit(self, feeds, deadline=None, priority=0, trace_id=None):
        """Enqueue one request (dict name->array).  Returns a Future
        resolving to the fetch list (this request's rows only).
        `deadline` is an absolute time.monotonic() instant or None.
        `priority`: larger = more important; under overload the queue
        sheds lowest-priority-first.  Raises ServerOverloaded /
        BatcherClosed / ValueError synchronously — admission decisions
        are immediate.  `trace_id` carries a caller-minted id (the wire
        `"trace_id"` field); one is minted here otherwise, and the
        returned future exposes it (plus the server-measured stage
        timings) as ``future.obs_info`` once resolved."""
        req = self._build_request(feeds, deadline, priority,
                                  trace_id=trace_id)
        evicted = None
        with self._cv:
            if self._closing:
                raise BatcherClosed("model batcher is draining/retired")
            if len(self._pending) >= self.max_queue:
                # priority shed: evict the lowest strictly-lower-priority
                # queued request (earliest such) in favor of this one;
                # with no lower class queued, the arrival itself sheds
                victim = None
                for r in self._pending:
                    if r.priority < req.priority and \
                            (victim is None
                             or r.priority < victim.priority):
                        victim = r
                if victim is None:
                    if self.metrics is not None:
                        self.metrics.note_shed(priority=req.priority)
                    # a shed happens BEFORE lane routing, so no replica
                    # owns it; the lane-occupancy context says whether
                    # the lanes were saturated or just the queue
                    obs_events.emit("shed", model=self._model_name,
                                    priority=req.priority,
                                    trace_id=req.trace_id,
                                    queue=len(self._pending),
                                    inflight=self._inflight_total())
                    raise ServerOverloaded(
                        "request queue full (%d waiting, max_queue=%d) — "
                        "priority-%d request shed; back off and retry"
                        % (len(self._pending), self.max_queue,
                           req.priority),
                        priority=req.priority)
                self._pending.remove(victim)
                evicted = victim
            self._pending.append(req)
            if self.metrics is not None:
                self.metrics.requests.add()
            # notify_all, not notify: the router AND the lane workers
            # share this condition — a single notify could wake a lane
            # worker (predicate false) and leave the router sleeping
            # out its 0.1s poll, which the new queue_wait span exposed
            # as a ~100ms floor on idle-server latency
            self._cv.notify_all()
        req.future.trace_id = req.trace_id
        if evicted is not None:
            if self.metrics is not None:
                self.metrics.note_shed(priority=evicted.priority)
            obs_events.emit("shed", model=self._model_name,
                            priority=evicted.priority,
                            trace_id=evicted.trace_id, evicted=True,
                            by_priority=req.priority,
                            inflight=self._inflight_total())
            if evicted.future.set_running_or_notify_cancel():
                evicted.future.set_exception(ServerOverloaded(
                    "priority-%d request shed from a full queue by a "
                    "priority-%d arrival (lowest-priority-first "
                    "overload policy)"
                    % (evicted.priority, req.priority),
                    priority=evicted.priority))
        return req.future

    def queue_depth(self):
        return len(self._pending)

    def replica_stats(self):
        """Per-replica lane snapshot (device id, in-flight batches,
        lane queue depth, batches/rows executed, `dispatch_ms` the EWMA
        time per dispatch, None until the first one) — the numbers
        `stats` surfaces.  `mesh` (members behind the lane), `dead` and
        `tp` keep the JAX rows' keys: one device, never dead, never
        tensor-parallel, until mesh replicas are ported."""
        with self._cv:
            return [{"replica": l.index, "device": l.device,
                     "mesh": 1, "dead": None, "tp": False,
                     "dispatch_ms": round(l.disp_ewma * 1000.0, 3)
                     if l.disp_ewma is not None else None,
                     "inflight": l.inflight, "queue": len(l.ready),
                     "batches": l.batches, "rows": l.rows}
                    for l in self._lanes]

    def lane_liveness(self):
        """Thread-level health of this batcher (the `health` RPC verb's
        per-model section): is the router alive, is each lane's worker
        set alive, and how long since each lane last finished a
        dispatch (None = never dispatched yet)."""
        now = time.monotonic()
        with self._cv:
            lanes = []
            for l in self._lanes:
                threads = self._lane_threads.get(l.index, [])
                lanes.append({
                    "replica": l.index, "device": l.device,
                    "mesh": 1, "dead": None,
                    "alive": sum(1 for t in threads if t.is_alive()),
                    "workers": len(threads),
                    "inflight": l.inflight, "queue": len(l.ready),
                    "last_dispatch_age_s":
                        round(now - l.last_t, 3)
                        if l.last_t is not None else None})
            return {"kind": "batch",
                    "router_alive": self._router.is_alive(),
                    "queue_depth": len(self._pending),
                    "closing": self._closing, "lanes": lanes}

    def _inflight_total(self):
        return sum(l.inflight + len(l.ready) for l in self._lanes)

    # ------------------------------------------------------------------
    # coalescing front-end + least-loaded router
    # ------------------------------------------------------------------

    def _bucket_cap(self, total):
        for cap in self.buckets:
            if total <= cap:
                return cap
        return total

    def _take_group(self):
        """Pop the head request plus every compatible queued request up
        to the largest bucket, waiting up to the coalescing deadline for
        stragglers.  Returns None only at shutdown.  Marks the router as
        carrying the group so drain() sees it between queue and lane."""
        with self._cv:
            while not self._pending:
                if self._stopped or self._closing:
                    return None
                self._cv.wait(0.1)
            head = self._pending.popleft()
            head.t_taken = time.monotonic()
            group = [head]
            # carrying from the pop on: drain() must see the group while
            # the coalescing window below waits on the condition (the
            # JAX batcher sets it only after the window, so a close
            # landing inside the window failed the group)
            self._carrying = True
            if head.batch is None:
                # no batch-major feed: nothing to coalesce on
                return group
            total = head.batch
            window = time.monotonic() + self.deadline_s
            while total < self.max_batch:
                took = False
                for i, r in enumerate(self._pending):
                    if r.group_key == head.group_key and \
                            total + r.batch <= self.max_batch:
                        del self._pending[i]
                        r.t_taken = time.monotonic()
                        group.append(r)
                        total += r.batch
                        took = True
                        break
                if took:
                    continue
                if self._pending:
                    # only incompatible (or non-fitting) requests wait —
                    # dispatch now rather than head-of-line block them
                    break
                remaining = window - time.monotonic()
                if remaining <= 0 or self._stopped or self._closing:
                    break
                self._cv.wait(min(remaining, 0.05))
            return group

    def _assign(self, group):
        """Hand `group` to the least-loaded lane: fewest in-flight
        batches, then shortest lane queue, then lowest index.  When
        every lane's queue is at `lane_depth` the router WAITS here
        (sticky back-pressure) — the admission queue upstream fills and
        sheds, rather than any lane queue growing unboundedly.  Returns
        False only on hard stop (group unrouted)."""
        with self._cv:
            while True:
                if self._stopped:
                    self._carrying = False
                    return False
                lane = min(self._lanes, key=_Lane.load)
                if len(lane.ready) < self.lane_depth:
                    lane.ready.append(group)
                    self._carrying = False
                    self._cv.notify_all()
                    return True
                self._cv.wait(0.05)

    def _route(self):
        while True:
            group = self._take_group()
            if group is None:
                return
            t_grouped = time.monotonic()
            for r in group:
                r.t_grouped = t_grouped
            if not self._assign(group):
                # hard stop with a group in hand: fail it explicitly
                for r in group:
                    if r.future.set_running_or_notify_cancel():
                        r.future.set_exception(BatcherClosed(
                            "server shut down before dispatch"))
                    if self.metrics is not None:
                        self.metrics.errors.add()
                return

    # ------------------------------------------------------------------
    # lane dispatch side
    # ------------------------------------------------------------------

    def _merge_feeds(self, group):
        first = group[0]
        if len(group) == 1:
            return dict(first.feeds)
        merged = {}
        for name, arr in first.feeds.items():
            if name in self._batched_feeds and arr.ndim >= 1:
                merged[name] = np.concatenate(
                    [r.feeds[name] for r in group], axis=0)
            else:
                merged[name] = arr  # group key proved byte-equality
        return merged

    def _emit_request_spans(self, r, lane, t_start, t_run, t_run_end,
                            now, n_live, total):
        """Land one request's stage span set in the tracing ring.  The
        stamps are contiguous monotonic instants, so the stages tile the
        root `serving/request` span exactly: a p99 outlier decomposes
        into WHICH stage ate the time.  Wall-clock
        `ts` per span is reconstructed from one time.time() anchor."""
        wall_now = time.time()
        model = self._model_name
        tid = r.trace_id
        t_taken = r.t_taken if r.t_taken is not None else t_start
        t_grouped = r.t_grouped if r.t_grouped is not None else t_start

        def _mk(name, t0, t1, **attrs):
            if t1 < t0:
                t1 = t0
            a = {"model": model} if model else {}
            a.update(attrs)
            obs_tracing.add_span(obs_tracing.Span(
                name, kind="serving", trace_id=tid,
                ts=wall_now - (now - t0), dur_ms=(t1 - t0) * 1e3,
                attrs=a))

        _mk("serving/queue_wait", r.enqueued, t_taken)
        _mk("serving/coalesce", t_taken, t_grouped)
        _mk("serving/lane_wait", t_grouped, t_start, replica=lane.index)
        _mk("serving/dispatch", t_start, t_run, replica=lane.index)
        _mk("serving/compute", t_run, t_run_end, replica=lane.index,
            rows=total, batch_fill=n_live)
        _mk("serving/scatter", t_run_end, now)
        _mk("serving/request", r.enqueued, now, replica=lane.index,
            batch=r.batch or 0, batch_fill=n_live, priority=r.priority)

    def _scatter(self, group, fetches, total, lane, t_start, t_run,
                 t_run_end):
        flags = self._fetch_flags
        offset = 0
        now = time.monotonic()
        traced = obs_tracing.enabled()
        try:
            slow_ms = float(FLAGS.trace_slow_ms)
        except Exception:
            slow_ms = 0.0
        for r in group:
            outs = []
            for i, a in enumerate(fetches):
                if flags is not None:
                    batched = i < len(flags) and flags[i]
                else:
                    batched = a.ndim >= 1 and a.shape[0] == total
                if batched and r.batch is not None:
                    outs.append(a[offset:offset + r.batch])
                else:
                    outs.append(a)
            offset += r.batch or 0
            total_ms = (now - r.enqueued) * 1000.0
            queue_wait_ms = ((r.t_taken if r.t_taken is not None else now)
                             - r.enqueued) * 1000.0
            if traced:
                self._emit_request_spans(r, lane, t_start, t_run,
                                         t_run_end, now, len(group),
                                         total)
            if slow_ms and total_ms >= slow_ms:
                # the slow-request log: findable after the ring
                # wrapped, attributed to the lane that served it so
                # per-replica triage works from the event log alone
                obs_events.emit("slow", model=self._model_name,
                                trace_id=r.trace_id,
                                replica=lane.index, device=lane.device,
                                total_ms=round(total_ms, 3),
                                queue_wait_ms=round(queue_wait_ms, 3),
                                compute_ms=round(
                                    (t_run_end - t_run) * 1e3, 3))
            if not r.future.set_running_or_notify_cancel():
                continue  # caller cancelled while queued
            # server-measured latency attribution, readable by the
            # caller (ServingClient debug replies) without server access
            r.future.obs_info = {
                "trace_id": r.trace_id,
                "queue_wait_ms": round(queue_wait_ms, 3),
                "coalesce_ms": round(
                    ((r.t_grouped or now) -
                     (r.t_taken if r.t_taken is not None else now))
                    * 1e3, 3),
                "lane_wait_ms": round(
                    (t_start - (r.t_grouped or t_start)) * 1e3, 3),
                "compute_ms": round((t_run_end - t_run) * 1e3, 3),
                "server_ms": round(total_ms, 3),
                "batch_fill": len(group),
                "batch_rows": total,
                "replica": lane.index,
            }
            r.future.set_result(outs)
            if self.metrics is not None:
                self.metrics.note_completion(
                    latency_ms=total_ms, queue_wait_ms=queue_wait_ms)

    def _dispatch(self, group, lane):
        t_start = time.monotonic()
        delay = _chaos_delay()
        if delay:
            time.sleep(delay)
        now = time.monotonic()
        live = []
        for r in group:
            if r.deadline is not None and now > r.deadline:
                if self.metrics is not None:
                    self.metrics.deadline_expired.add()
                    self.metrics.errors.add()
                obs_events.emit("deadline_expired",
                                model=self._model_name,
                                trace_id=r.trace_id,
                                replica=lane.index, device=lane.device,
                                waited_ms=round(
                                    (now - r.enqueued) * 1000.0, 3))
                if r.future.set_running_or_notify_cancel():
                    r.future.set_exception(DeadlineExceeded(
                        "deadline passed after %.1f ms in queue"
                        % ((now - r.enqueued) * 1000.0)))
            else:
                live.append(r)
        if not live:
            return
        feeds = self._merge_feeds(live)
        total = sum(r.batch or 0 for r in live)
        t_run = time.monotonic()
        fetches = lane.predictor.run(feeds)
        t_run_end = time.monotonic()
        with self._cv:
            lane.batches += 1
            lane.rows += total
            lane.last_t = t_run_end
            dt = t_run_end - t_run
            lane.disp_ewma = dt if lane.disp_ewma is None \
                else 0.8 * lane.disp_ewma + 0.2 * dt
        if self.metrics is not None:
            cap = self._bucket_cap(total) if total else 0
            self.metrics.note_dispatch(
                n_requests=len(live), real_rows=total,
                padded_rows=max(cap - total, 0))
        self._scatter(live, fetches, total, lane, t_start, t_run,
                      t_run_end)

    def _worker(self, lane):
        while True:
            with self._cv:
                while not lane.ready:
                    if self._stopped:
                        return
                    self._cv.wait(0.1)
                group = lane.ready.popleft()
                lane.inflight += 1
                self._cv.notify_all()
            try:
                self._dispatch(group, lane)
            except BaseException as e:
                for r in group:
                    if not r.future.done() and \
                            r.future.set_running_or_notify_cancel():
                        r.future.set_exception(e)
                if self.metrics is not None:
                    self.metrics.errors.add(len(group))
            finally:
                with self._cv:
                    lane.inflight -= 1
                    self._cv.notify_all()

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def _busy(self):
        return (self._pending or self._carrying
                or any(l.ready or l.inflight for l in self._lanes))

    def drain(self, timeout=None):
        """Block until every queued, routed, and in-flight request has
        resolved — across all replica lanes."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            self._cv.notify_all()
            while self._busy():
                rem = None if deadline is None else \
                    max(deadline - time.monotonic(), 0.0)
                if rem == 0.0:
                    raise TimeoutError(
                        "batcher still has %d queued + %d lane-queued + "
                        "%d in-flight requests after %.1fs"
                        % (len(self._pending),
                           sum(len(l.ready) for l in self._lanes),
                           sum(l.inflight for l in self._lanes),
                           timeout))
                self._cv.wait(0.05 if rem is None else min(rem, 0.05))

    def close(self, drain=True, timeout=30.0):
        """Stop accepting; optionally finish everything queued first
        (the graceful-drain half of a hot swap or shutdown), then stop
        the router and lane workers.  With drain=False, queued requests
        fail with BatcherClosed."""
        with self._cv:
            self._closing = True
            self._cv.notify_all()
        if drain:
            self.drain(timeout)
        with self._cv:
            self._stopped = True
            leftovers = list(self._pending)
            self._pending.clear()
            for lane in self._lanes:
                while lane.ready:
                    leftovers.extend(lane.ready.popleft())
            self._cv.notify_all()
        for r in leftovers:
            if r.future.set_running_or_notify_cancel():
                r.future.set_exception(
                    BatcherClosed("server shut down before dispatch"))
            if self.metrics is not None:
                self.metrics.errors.add()
        self._router.join(timeout=5.0)
        for t in self._threads:
            t.join(timeout=5.0)


# ---------------------------------------------------------------------------
# continuous batching for autoregressive decode
# ---------------------------------------------------------------------------


class DecodeStream:
    """The caller's handle on one streaming generation: an event queue
    the owning lane feeds (token chunks, then exactly one terminal
    event), iterable as token-chunk lists.  ``result()`` collects the
    whole stream — the Future-shaped surface the server's one-shot
    `infer` verb uses on decode models."""

    def __init__(self, trace_id, prompt_len, max_new_tokens):
        self.trace_id = trace_id
        self.prompt_len = int(prompt_len)
        self.max_new_tokens = int(max_new_tokens)
        self.obs_info = None     # stage timing attribution, at finish
        self.finish_reason = None
        self._q = queue_mod.Queue()
        self._tokens = []
        self._done = threading.Event()
        self._cancel = threading.Event()
        self._error = None

    # -- lane side ------------------------------------------------------

    def _put_tokens(self, toks):
        self._tokens.extend(int(t) for t in toks)
        self._q.put(("tokens", [int(t) for t in toks]))

    def _finish(self, reason, obs_info=None):
        self.finish_reason = reason
        self.obs_info = obs_info
        self._done.set()
        self._q.put(("done", reason))

    def _fail(self, exc):
        self._error = exc
        self.finish_reason = "error"
        self._done.set()
        self._q.put(("error", exc))

    # -- caller side ----------------------------------------------------

    def cancel(self):
        """Ask the owning lane to evict this request; the slot is freed
        (and zeroed) within one dispatch.  The server's stream handler
        calls this when the client connection dies mid-reply."""
        self._cancel.set()

    def cancelled(self):
        return self._cancel.is_set()

    def done(self):
        return self._done.is_set()

    @property
    def tokens(self):
        """Tokens generated so far (grows while streaming)."""
        return list(self._tokens)

    def events(self, timeout=None):
        """Yield ("tokens", [ints]) chunks then one terminal ("done",
        reason) / ("error", exc) event.  `timeout` bounds the wait for
        EACH event."""
        while True:
            ev = self._q.get(timeout=timeout)
            yield ev
            if ev[0] != "tokens":
                return

    def __iter__(self):
        """Token-chunk iterator; raises the stream's typed error at the
        point of failure."""
        for kind, payload in self.events():
            if kind == "tokens":
                yield payload
            elif kind == "error":
                raise payload

    def result(self, timeout=None):
        """Block to completion; returns [int32 array of every generated
        token] or raises the stream's typed error."""
        if not self._done.wait(timeout=timeout):
            raise TimeoutError(
                "decode stream still running after %.1fs (%d tokens)"
                % (timeout or 0.0, len(self._tokens)))
        if self._error is not None:
            raise self._error
        return [np.asarray(self._tokens, np.int32)]


class _DecodeRequest:
    __slots__ = ("prompt", "max_new", "chunk", "deadline", "priority",
                 "trace_id", "stream", "enqueued", "t_admitted",
                 "t_first", "buf", "gen")

    def __init__(self, prompt, max_new, chunk, deadline, priority,
                 trace_id):
        self.prompt = prompt
        self.max_new = int(max_new)
        self.chunk = max(int(chunk), 1)
        self.deadline = deadline
        self.priority = int(priority)
        self.trace_id = trace_id or obs_tracing.new_trace_id()
        self.stream = DecodeStream(self.trace_id, len(prompt), max_new)
        self.enqueued = time.monotonic()
        self.t_admitted = None
        self.t_first = None
        self.buf = []
        self.gen = []


class _DecodeLane:
    """One replica's decode lane: its slot-table session plus the slot
    -> request assignment the continuous loop walks, and its counters.
    With a draft and spec_k >= 1 the session is a
    SpeculativeDecodeSession and the lane advances slots 1..k+1 tokens
    per round."""

    __slots__ = ("index", "predictor", "session", "spec", "assigned",
                 "steps", "trips", "tokens", "step_s", "step_ewma",
                 "last_step_t", "degraded_noted", "dead")

    def __init__(self, index, predictor, n_slots, draft=None, spec_k=0):
        self.index = index
        self.predictor = predictor
        self.spec = draft is not None and int(spec_k) >= 1
        if self.spec:
            from ..inference.decode import SpeculativeDecodeSession
            self.session = SpeculativeDecodeSession(predictor, draft,
                                                    n_slots, spec_k)
        else:
            self.session = predictor.new_session(n_slots)
        self.assigned = {}   # slot -> _DecodeRequest
        self.steps = 0       # dispatches: decode steps, rounds or windows
        self.trips = 0       # logical steps (a fused window's trips)
        self.tokens = 0      # tokens emitted (prefill first tokens too)
        self.step_s = 0.0    # seconds spent in dispatches
        # EWMA seconds per logical step (per trip under fusion): the
        # deadline governor's estimate for clamping a window's trips
        self.step_ewma = None
        self.last_step_t = None  # monotonic end of the last dispatch
        self.degraded_noted = False
        self.dead = None     # error string once the lane's loop died


class DecodeBatcher:
    """Slot-based continuous batching over one or more replica
    GenerativePredictors, one lane thread each.  Admission control
    matches the DynamicBatcher's (bounded queue, lowest-priority-first
    shed, shed-not-hang); past admission the lifecycle is streaming:
    prefill into a free slot, then ride the lane's running decode loop
    until EOS / max-new-tokens / deadline / cancel frees the slot for
    the next waiting request.

    ``continuous=False`` is the static-batching baseline: a lane admits
    only when idle, takes a full batch and decodes until its LAST member
    finishes.

    `draft` (or one draft per replica in `draft_replicas`, each sharing
    its target's vocab and eos) with `spec_k` (default
    FLAGS.serving_spec_k; < 1 disables it) makes the lanes speculative.
    A draft failure degrades a lane to target-only rounds within one
    round (the `spec_degraded` event and counter), never wedging a
    stream; a kernel that fails to build or launch ends the lane
    instead, as on a plain lane.

    `fuse_steps` (default FLAGS.serving_decode_fuse_steps, at least 1) is
    the fused window: above 1 a plain lane runs up to that many steps a
    dispatch, and a speculative lane fuses each round into one
    dispatch.  Cancelled and expired streams leave at window boundaries,
    and a deadline clamps a window's trips to what the lane's EWMA step
    time says fits, so it overshoots by about one window at most."""

    def __init__(self, predictor, replicas=None, n_slots=None,
                 max_queue=None, metrics=None, max_new_tokens=None,
                 continuous=True, draft=None, draft_replicas=None,
                 spec_k=None, fuse_steps=None):
        preds = list(replicas) if replicas else [predictor]
        self.predictor = predictor if predictor is not None else preds[0]
        self.n_slots = max(int(FLAGS.serving_decode_slots
                               if n_slots is None else n_slots), 1)
        self.max_queue = int(FLAGS.serving_max_queue
                             if max_queue is None else max_queue)
        self.max_new_cap = max(int(FLAGS.serving_max_new_tokens
                                   if max_new_tokens is None
                                   else max_new_tokens), 1)
        self.continuous = bool(continuous)
        self.metrics = metrics
        self.fuse_steps = max(int(FLAGS.serving_decode_fuse_steps
                                  if fuse_steps is None else fuse_steps), 1)
        self.spec_k = int(FLAGS.serving_spec_k if spec_k is None
                          else spec_k)
        drafts = list(draft_replicas) if draft_replicas else (
            [draft] * len(preds) if draft is not None else None)
        if drafts is not None and len(drafts) != len(preds):
            raise ValueError(
                "%d draft replicas for %d target replicas — the spec "
                "lanes pair one draft per target"
                % (len(drafts), len(preds)))
        if not drafts or self.spec_k < 1:
            drafts, self.spec_k = None, 0
        self.draft_replicas = drafts
        self._cv = threading.Condition()
        self._pending = collections.deque()
        self._lanes = [_DecodeLane(i, p, self.n_slots,
                                   draft=(drafts[i] if drafts else None),
                                   spec_k=self.spec_k)
                       for i, p in enumerate(preds)]
        self._closing = False
        self._stopped = False
        if metrics is not None:
            metrics.queue_depth_fn = lambda: len(self._pending)
            metrics.replica_stats_fn = self.replica_stats
            metrics.slot_occupancy_fn = self.slot_occupancy
            metrics.kv_cache_fn = self.kv_cache_info
        self._threads = [
            threading.Thread(
                target=self._lane_loop, args=(lane,), daemon=True,
                name="paddle-tpu-torch-decode-lane%d" % lane.index)
            for lane in self._lanes]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------------

    @property
    def session(self):
        """The first lane's session: a DecodeSession (its slot table), or
        the SpeculativeDecodeSession of a speculative lane."""
        return self._lanes[0].session

    @property
    def _model_name(self):
        return self.metrics.name if self.metrics is not None else None

    def queue_depth(self):
        return len(self._pending)

    def slot_occupancy(self):
        """(occupied, total) across every live lane — the occupancy
        gauge (a dead lane contributes no capacity)."""
        occupied = sum(len(l.assigned) for l in self._lanes)
        live = sum(1 for l in self._lanes if l.dead is None)
        return occupied, self.n_slots * live

    def lane_stats(self, replica=0):
        """One lane's busy slots, dispatches (`steps`: decode steps,
        rounds or fused windows), logical steps (`trips`: a fused
        window's trips, one a step or round otherwise), tokens emitted,
        seconds in dispatches, the EWMA ms per logical step and the
        lane's error once it died; a speculative lane adds its verify
        and plain rounds, draft tokens proposed and accepted, `degraded`
        (latched by its session) and `degrade_error`, the draft failure
        that degraded it."""
        lane = self._lanes[replica]
        with self._cv:
            stats = {"device": str(lane.predictor.device),
                     "dead": lane.dead, "inflight": len(lane.assigned),
                     "steps": lane.steps, "trips": lane.trips,
                     "tokens": lane.tokens, "step_s": lane.step_s,
                     "step_ewma_ms": None if lane.step_ewma is None
                     else lane.step_ewma * 1e3,
                     "fuse_steps": self.fuse_steps, "spec_k": self.spec_k}
            if lane.spec:
                sess = lane.session
                stats.update(rounds=sess.rounds,
                             plain_steps=sess.plain_steps,
                             proposed=sess.proposed,
                             accepted=sess.accepted,
                             degraded=sess.degraded,
                             degrade_error=sess.degrade_error)
            return stats

    def lane_liveness(self):
        """Thread-level health (the `health` verb): per decode lane, is
        its loop thread alive, how many slots are busy, and the age of
        its last completed dispatch — a wedged lane reads as a growing
        last_step_age_s with busy slots."""
        now = time.monotonic()
        with self._cv:
            lanes = []
            for i, l in enumerate(self._lanes):
                t = self._threads[i] if i < len(self._threads) else None
                lanes.append({
                    "replica": l.index,
                    "alive": int(bool(t is not None and t.is_alive())),
                    "workers": 1,
                    "dead": l.dead,
                    "slots_busy": len(l.assigned),
                    "slots": self.n_slots,
                    "steps": l.steps,
                    "last_step_age_s":
                        round(now - l.last_step_t, 3)
                        if l.last_step_t is not None else None})
            return {"kind": "decode", "router_alive": True,
                    "queue_depth": len(self._pending),
                    "closing": self._closing, "lanes": lanes}

    def kv_cache_info(self):
        """(kv_cache_dtype, measured slot-table bytes summed across the
        lanes): each target table's K and V plus an int8 cache's scale
        table (a speculative lane's draft table is not counted)."""
        return (str(self.predictor.kv_cache_dtype),
                sum(int(l.session.cache_bytes()) for l in self._lanes))

    def _slots_busy_total(self):
        return sum(len(l.assigned) for l in self._lanes)

    def warm(self):
        """Before any request: on every lane's OWN session, prefill each
        prompt bucket and run one dispatch of the lane's kind (a step, a
        fused window or a speculative round), then free the slot.  The
        kernels, buffers and (on the card) the lane's CUDA graph exist
        before the first stream, which pays none of it; the JAX registry
        warms the shared executables the same way."""
        with self._cv:
            if self._pending or self._busy() or any(
                    l.steps for l in self._lanes):
                raise RuntimeError("warm() runs before the first request")
        for lane in self._lanes:
            sess, pred = lane.session, lane.predictor
            for bucket in pred.prefill_buckets():
                # a prompt filling the cache is unservable: the largest
                # bucket warms with the longest servable prompt
                sess.prefill(0, [0] * min(bucket, pred.max_seq_len - 1))
                if lane.spec:
                    sess.step(fused=self.fuse_steps > 1)
                elif self.fuse_steps > 1:
                    sess.decode_fused(self.fuse_steps)
                else:
                    sess.decode()
                sess.free(0)

    def replica_stats(self):
        """Per-lane rows with the DynamicBatcher's keys: `batches` are
        dispatches, `rows` tokens, `dispatch_ms` the EWMA per logical
        step."""
        from ..inference.predictor import _device_label
        with self._cv:
            return [{"replica": l.index,
                     "device": _device_label(l.predictor.device),
                     "mesh": 1, "dead": l.dead, "tp": False,
                     "dispatch_ms": round(l.step_ewma * 1000.0, 3)
                     if l.step_ewma is not None else None,
                     "inflight": len(l.assigned), "queue": 0,
                     "batches": l.steps, "rows": l.tokens}
                    for l in self._lanes]

    # ------------------------------------------------------------------
    # submit side: the same admission-control contract as DynamicBatcher
    # ------------------------------------------------------------------

    def submit(self, tokens, max_new_tokens=None, deadline=None,
               priority=0, trace_id=None, chunk_tokens=None):
        """Enqueue one generation request; returns a DecodeStream.
        `max_new_tokens` is clamped to the server-side cap; `deadline` is
        an absolute time.monotonic() instant covering queue wait, prefill
        AND decode — a request past it is evicted from its slot
        mid-generation."""
        prompt = np.asarray(tokens, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        self.predictor.check_tokens(prompt)
        # unservable prompts are rejected synchronously; this also
        # guarantees that at least one generated token fits
        self.predictor.prompt_bucket(int(prompt.size))
        if prompt.size >= self.predictor.max_seq_len:
            raise ValueError(
                "prompt of %d tokens leaves no cache room to generate "
                "(max_seq_len %d)" % (prompt.size,
                                      self.predictor.max_seq_len))
        max_new = self.max_new_cap if max_new_tokens is None else \
            max(min(int(max_new_tokens), self.max_new_cap), 1)
        chunk = int(FLAGS.serving_stream_chunk_tokens
                    if chunk_tokens is None else chunk_tokens)
        req = _DecodeRequest([int(t) for t in prompt], max_new, chunk,
                             deadline, priority, trace_id)
        evicted = None
        with self._cv:
            if self._closing:
                raise BatcherClosed("model batcher is draining/retired")
            dead = [l.dead for l in self._lanes if l.dead is not None]
            if len(dead) == len(self._lanes):
                raise BatcherClosed("the decode lane is dead (%s)"
                                    % dead[0])
            if len(self._pending) >= self.max_queue:
                victim = None
                for r in self._pending:
                    if r.priority < req.priority and \
                            (victim is None
                             or r.priority < victim.priority):
                        victim = r
                if victim is None:
                    if self.metrics is not None:
                        self.metrics.note_shed(priority=req.priority)
                    obs_events.emit("shed", model=self._model_name,
                                    priority=req.priority,
                                    trace_id=req.trace_id,
                                    queue=len(self._pending),
                                    slots_busy=self._slots_busy_total())
                    raise ServerOverloaded(
                        "decode queue full (%d waiting, max_queue=%d) — "
                        "priority-%d request shed; back off and retry"
                        % (len(self._pending), self.max_queue,
                           req.priority),
                        priority=req.priority)
                self._pending.remove(victim)
                evicted = victim
            self._pending.append(req)
            if self.metrics is not None:
                self.metrics.requests.add()
                self.metrics.streams.add()
            self._cv.notify_all()
        if evicted is not None:
            if self.metrics is not None:
                self.metrics.note_shed(priority=evicted.priority)
            obs_events.emit("shed", model=self._model_name,
                            priority=evicted.priority,
                            trace_id=evicted.trace_id, evicted=True,
                            by_priority=req.priority,
                            slots_busy=self._slots_busy_total())
            evicted.stream._fail(ServerOverloaded(
                "priority-%d request shed from a full decode queue by "
                "a priority-%d arrival (lowest-priority-first overload "
                "policy)" % (evicted.priority, req.priority),
                priority=evicted.priority))
        return req.stream

    # ------------------------------------------------------------------
    # the continuous loop (one thread per replica lane)
    # ------------------------------------------------------------------

    def _admissible(self, lane):
        if not self._pending:
            return False
        if self.continuous:
            return len(lane.assigned) < self.n_slots
        # static baseline: only an IDLE lane admits (then decodes the
        # whole batch to completion before admitting again)
        return not lane.assigned

    def _take_admits_locked(self, lane):
        """Pop the requests this lane admits right now (caller holds
        _cv)."""
        room = self.n_slots - len(lane.assigned)
        out = []
        while self._pending and room > 0:
            out.append(self._pending.popleft())
            room -= 1
        return out

    def _emit_request_spans(self, req, lane, now):
        """Stage spans cut from contiguous monotonic stamps so
        queue_wait + prefill + decode tile serving/request exactly."""
        wall_now = time.time()
        model = self._model_name
        t_adm = req.t_admitted if req.t_admitted is not None \
            else req.enqueued
        t_first = req.t_first if req.t_first is not None else t_adm

        def _mk(name, t0, t1, **attrs):
            if t1 < t0:
                t1 = t0
            a = {"model": model} if model else {}
            a.update(attrs)
            obs_tracing.add_span(obs_tracing.Span(
                name, kind="serving", trace_id=req.trace_id,
                ts=wall_now - (now - t0), dur_ms=(t1 - t0) * 1e3,
                attrs=a))

        _mk("serving/queue_wait", req.enqueued, t_adm)
        _mk("serving/prefill", t_adm, t_first, replica=lane.index,
            prompt=len(req.prompt))
        _mk("serving/decode", t_first, now, replica=lane.index,
            tokens=len(req.gen))
        _mk("serving/request", req.enqueued, now, replica=lane.index,
            prompt=len(req.prompt), tokens=len(req.gen),
            priority=req.priority)

    def _obs_info(self, req, lane, now):
        t_adm = req.t_admitted or now
        t_first = req.t_first or t_adm
        return {
            "trace_id": req.trace_id,
            "queue_wait_ms": round((t_adm - req.enqueued) * 1e3, 3),
            "prefill_ms": round((t_first - t_adm) * 1e3, 3),
            "decode_ms": round((now - t_first) * 1e3, 3),
            "server_ms": round((now - req.enqueued) * 1e3, 3),
            "ttft_ms": round((t_first - req.enqueued) * 1e3, 3),
            "tokens": len(req.gen),
            "replica": lane.index,
        }

    def _finish(self, lane, slot, req, reason, exc=None):
        """Terminal transition: flush, emit spans/metrics, free (and
        therefore ZERO) the slot so the next admit starts clean, resolve
        the stream."""
        now = time.monotonic()
        if req.buf:
            req.stream._put_tokens(req.buf)
            req.buf = []
        if slot is not None:
            lane.session.free(slot)
            with self._cv:
                lane.assigned.pop(slot, None)
        if obs_tracing.enabled():
            self._emit_request_spans(req, lane, now)
        info = self._obs_info(req, lane, now)
        info["finish_reason"] = reason
        if exc is not None:
            if self.metrics is not None:
                self.metrics.errors.add()
                if isinstance(exc, DeadlineExceeded):
                    self.metrics.deadline_expired.add()
            req.stream.obs_info = info
            req.stream._fail(exc)
        else:
            if self.metrics is not None and reason != "cancelled":
                self.metrics.note_completion(
                    latency_ms=info["server_ms"],
                    queue_wait_ms=info["queue_wait_ms"])
            req.stream._finish(reason, obs_info=info)

    def _expire(self, lane, slot, req, now):
        """Deadline eviction — at admission or mid-decode.
        `overshoot_ms` stamps how far past the deadline the eviction
        landed (about one dispatch at most under fused decode)."""
        obs_events.emit("deadline_expired", model=self._model_name,
                        trace_id=req.trace_id, replica=lane.index,
                        tokens=len(req.gen),
                        waited_ms=round((now - req.enqueued) * 1e3, 3),
                        overshoot_ms=round((now - req.deadline) * 1e3, 3)
                        if req.deadline is not None else None)
        self._finish(lane, slot, req, "deadline", exc=DeadlineExceeded(
            "deadline passed after %.1f ms (%d tokens generated)"
            % ((now - req.enqueued) * 1e3, len(req.gen))))

    def _prefill(self, lane, req):
        """Admit one request into a free slot: prefill the prompt and
        stream the first token (the time-to-first-token instant)."""
        now = time.monotonic()
        req.t_admitted = now
        if req.stream.cancelled():
            self._finish(lane, None, req, "cancelled")
            return
        if req.deadline is not None and now > req.deadline:
            self._expire(lane, None, req, now)
            return
        sess = lane.session
        slot = sess.free_slots()[0]
        try:
            with obs_tracing.trace("serving/prefill_compute",
                                   kind="serving", trace_id=req.trace_id,
                                   model=self._model_name,
                                   replica=lane.index,
                                   prompt=len(req.prompt)):
                first = sess.prefill(slot, req.prompt)
        except Exception as e:
            self._finish(lane, None, req, "error", exc=e)
            return
        req.t_first = time.monotonic()
        if self.metrics is not None:
            self.metrics.note_prefill(
                ttft_ms=(req.t_first - req.enqueued) * 1e3)
            self.metrics.note_tokens(1)
        lane.tokens += 1
        req.gen.append(first)
        req.buf.append(first)
        with self._cv:
            lane.assigned[slot] = req
        if first == self.predictor.eos_id:
            self._finish(lane, slot, req, "eos")
        elif req.max_new <= 1 or sess.room(slot) <= 0:
            self._finish(lane, slot, req, "length")
        elif len(req.buf) >= req.chunk:
            req.stream._put_tokens(req.buf)
            req.buf = []

    def _emit_step_spans(self, lane, t0, t_draft_end, now, n_slots,
                         accepted=None, tokens=None, trips=None):
        """Per-dispatch spans: `serving/decode_step` always (`tokens`
        emitted and `trips` loop iterations ride as attrs); on a
        speculative round its `serving/draft` + `serving/verify` children
        tile the round exactly (draft end == verify start)."""
        wall_now = time.time()
        attrs = {"model": self._model_name or "", "replica": lane.index,
                 "slots": n_slots}

        def _mk(name, a, b, **extra):
            at = dict(attrs)
            at.update(extra)
            obs_tracing.add_span(obs_tracing.Span(
                name, kind="serving", ts=wall_now - (now - a),
                dur_ms=(max(b, a) - a) * 1e3, attrs=at))

        if t_draft_end is not None:
            _mk("serving/draft", t0, t_draft_end,
                spec_k=lane.session.spec_k)
            _mk("serving/verify", t_draft_end, now, accepted=accepted)
        _mk("serving/decode_step", t0, now, tokens=tokens, trips=trips)

    def _note_degraded(self, lane):
        """First observation of a degraded speculative session: the event
        and counter exactly once per lane."""
        if lane.degraded_noted or not lane.spec \
                or not lane.session.degraded:
            return
        lane.degraded_noted = True
        if self.metrics is not None:
            self.metrics.spec_degraded.add()
        obs_events.emit("spec_degraded", model=self._model_name,
                        replica=lane.index,
                        error=str(lane.session.degrade_error or ""))

    def _lane_dead(self, lane, exc):
        """Retire a lane after its loop raised (a CUDA error, a kernel
        that failed to build or launch): fail its in-flight streams with
        the error, and everything queued once no live lane remains to
        admit it — never leave a stream hanging.  Sibling lanes keep
        serving."""
        with self._cv:
            lane.dead = "%s: %s" % (type(exc).__name__, exc)
            victims = list(lane.assigned.values())
            lane.assigned.clear()
            pend = []
            if all(l.dead is not None for l in self._lanes):
                pend = list(self._pending)
                self._pending.clear()
            self._cv.notify_all()
        obs_events.emit("server_thread_death", model=self._model_name,
                        thread=threading.current_thread().name,
                        thread_kind="decode-lane", replica=lane.index,
                        error=lane.dead)
        if self.metrics is not None and (victims or pend):
            self.metrics.errors.add(len(victims) + len(pend))
        for req in victims + pend:
            req.buf = []
            req.stream._fail(exc)

    def _lane_loop(self, lane):
        while True:
            try:
                if not self._lane_iter(lane):
                    return
            except Exception as e:
                self._lane_dead(lane, e)
                return

    def _lane_iter(self, lane):
        """One iteration of the continuous loop: admit + prefill, one
        dispatch (a decode step, a round or a fused window), stream
        bookkeeping.  Returns False to stop."""
        sess = lane.session
        eos = self.predictor.eos_id
        with self._cv:
            while not lane.assigned and not self._admissible(lane):
                if self._stopped:
                    return False
                self._cv.wait(0.1)
            if self._stopped and not lane.assigned:
                return False
            admits = self._take_admits_locked(lane) \
                if self._admissible(lane) else []
        # prefill outside the lock: submits and other lanes go on
        for req in admits:
            self._prefill(lane, req)
        if not lane.assigned:
            self._note_degraded(lane)
            return True
        fuse = self.fuse_steps
        if fuse > 1:
            # window-boundary housekeeping: drop cancelled and expired
            # streams BEFORE spending a window on them
            nowb = time.monotonic()
            for slot, req in list(lane.assigned.items()):
                if req.stream.cancelled():
                    req.buf = []
                    self._finish(lane, slot, req, "cancelled")
                elif req.deadline is not None and nowb > req.deadline:
                    self._expire(lane, slot, req, nowb)
            if not lane.assigned:
                return True
        n_act = len(lane.assigned)
        t0 = time.monotonic()
        delay = _chaos_delay()
        host_delay = _host_chaos_delay()
        if host_delay:
            time.sleep(host_delay)
        trips = 1
        spec_round = False
        if lane.spec:
            toks, counts = sess.step(fused=fuse > 1, step_delay=delay,
                                     draft_delay=_draft_chaos_delay())
            spec_round = sess.last_spec
        elif fuse > 1:
            # per-slot budgets (max-new and cache-room headroom) and the
            # deadline governor: the lane's EWMA step time clamps the
            # trips so a deadlined stream overshoots by ~one window
            budget = np.zeros(self.n_slots, np.int32)
            max_trips = fuse
            for slot, req in lane.assigned.items():
                budget[slot] = min(req.max_new - len(req.gen),
                                   sess.room(slot), fuse)
                if req.deadline is not None and lane.step_ewma:
                    allow = int((req.deadline - t0) / lane.step_ewma)
                    max_trips = min(max_trips, max(allow, 1))
            toks, counts, trips = sess.decode_fused(
                fuse, budget=budget, max_trips=max_trips)
            if delay:
                # the device-cost stand-in scales with the trips run
                time.sleep(delay * trips)
        else:
            if delay:
                time.sleep(delay)
            toks = sess.decode()[:, None]
            counts = np.ones(len(toks), np.int32)
        now = time.monotonic()
        lane.steps += 1
        lane.trips += trips
        lane.step_s += now - t0
        lane.last_step_t = now
        per_step = (now - t0) / max(trips, 1)
        lane.step_ewma = per_step if lane.step_ewma is None \
            else 0.5 * lane.step_ewma + 0.5 * per_step
        if self.metrics is not None:
            self.metrics.decode_steps.add(trips)
            if spec_round:
                # k proposals per occupied slot, counts[s] - 1 accepted
                self.metrics.note_spec(sess.spec_k * n_act,
                                       int(counts.sum()) - n_act)
        self._note_degraded(lane)
        emitted = 0
        for slot, req in list(lane.assigned.items()):
            # a speculative round commits 1..k+1 tokens per slot, a fused
            # window up to fuse_steps: consume them in stream order with
            # per-token EOS / max-new cuts, so the stream is bit-identical
            # to the one-token-per-step path
            finished = None
            for j in range(int(counts[slot])):
                tok = int(toks[slot, j])
                req.gen.append(tok)
                req.buf.append(tok)
                emitted += 1
                if tok == eos:
                    finished = "eos"
                    break
                if len(req.gen) >= req.max_new:
                    finished = "length"
                    break
            if req.stream.cancelled():
                # client gone: nobody reads the flush — just free
                req.buf = []
                self._finish(lane, slot, req, "cancelled")
                continue
            if req.deadline is not None and now > req.deadline:
                self._expire(lane, slot, req, now)
                continue
            if finished is None and sess.room(slot) <= 0:
                finished = "length"
            if finished is not None:
                self._finish(lane, slot, req, finished)
            elif len(req.buf) >= req.chunk:
                req.stream._put_tokens(req.buf)
                req.buf = []
        if obs_tracing.enabled():
            self._emit_step_spans(
                lane, t0, sess.last_draft_end if spec_round else None,
                now, n_act,
                accepted=(int(counts.sum()) - n_act) if spec_round
                else None,
                tokens=emitted, trips=trips)
        lane.tokens += emitted
        if self.metrics is not None:
            # tokens per dispatch: ~1 at fuse_steps 1, ~N when fused
            self.metrics.note_decode_dispatch(emitted)
            if emitted:
                self.metrics.note_tokens(emitted)
        with self._cv:
            self._cv.notify_all()
        return True

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def _busy(self):
        return bool(self._pending
                    or any(l.assigned for l in self._lanes))

    def drain(self, timeout=None):
        """Block until every queued and in-slot request has resolved."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            self._cv.notify_all()
            while self._busy():
                rem = None if deadline is None else \
                    max(deadline - time.monotonic(), 0.0)
                if rem == 0.0:
                    raise TimeoutError(
                        "decode batcher still has %d queued + %d "
                        "in-slot requests after %.1fs"
                        % (len(self._pending),
                           sum(len(l.assigned) for l in self._lanes),
                           timeout))
                self._cv.wait(0.05 if rem is None else min(rem, 0.05))

    def close(self, drain=True, timeout=30.0):
        """Stop accepting; optionally finish everything queued first,
        then stop the lanes.  With drain=False, queued requests fail with
        BatcherClosed and in-slot ones are cancelled."""
        with self._cv:
            self._closing = True
            self._cv.notify_all()
        if drain:
            self.drain(timeout)
        with self._cv:
            self._stopped = True
            leftovers = list(self._pending)
            self._pending.clear()
            for lane in self._lanes:
                for req in lane.assigned.values():
                    req.stream.cancel()
            self._cv.notify_all()
        for req in leftovers:
            req.stream._fail(
                BatcherClosed("server shut down before dispatch"))
            if self.metrics is not None:
                self.metrics.errors.add()
        for t in self._threads:
            t.join(timeout=timeout)
