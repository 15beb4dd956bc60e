"""Continuous batching for autoregressive decode — the port of
paddle_tpu/serving/batcher.py's `DecodeBatcher` (its one-lane path, plain
or speculative, one step or round per dispatch or fused windows).

Each request is many tiny steps over growing state, so the utilization
lever is slot occupancy over time.  The DecodeBatcher keeps one
DecodeSession (slot-indexed KV cache, inference/decode.py) in its lane
and runs a continuous loop: a waiting request joins the RUNNING
decode batch the step after any slot frees (EOS / max-new-tokens /
deadline / cancel) — no coalesce window, no waiting for the batch to
drain.

With a draft predictor and `spec_k` >= 1 the lane runs a
SpeculativeDecodeSession: each round the draft proposes k tokens, one
target verify step scores all k + 1 positions, and slots advance 1..k+1
committed tokens, consumed in stream order with per-token EOS and
max-new cuts, so every stream is bit-identical to the plain path.

With `fuse_steps` N > 1 (default FLAGS.serving_decode_fuse_steps) one
dispatch runs a fused window: up to N steps of a plain lane
(`DecodeSession.decode_fused`, per-slot budgets, the deadline governor's
trip clamp), or one fused speculative round.  On the card each is a
CUDA-graph replay.  Requests join and leave at window boundaries; the
streams are bit-identical to the one-step path.

Admission control: a bounded queue (`max_queue`); past it, an arriving
request evicts the lowest strictly-lower-priority queued request or is
shed itself with `ServerOverloaded` (shed, never hang).

Not ported yet: replica lanes, mesh / tensor-parallel lanes, the
static-batching baseline, serving metrics, trace ids and the obs spans
and events (among them `spec_degraded`: a lane reports degradation in
`lane_stats()`).
"""

import collections
import queue as queue_mod
import threading
import time

import numpy as np

from ..flags import FLAGS

__all__ = ["DecodeBatcher", "DecodeStream", "ServerOverloaded",
           "DeadlineExceeded", "BatcherClosed"]


class ServerOverloaded(RuntimeError):
    """Admission control shed: the model's request queue is full.
    `priority` names the class of the request that was shed (the
    arriving one, or a lower-priority queued request it evicted)."""

    def __init__(self, message, priority=None):
        super().__init__(message)
        self.priority = priority


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed before its generation completed."""


class BatcherClosed(RuntimeError):
    """Submit on a draining/closed batcher, or one whose lane died."""


class DecodeStream:
    """The caller's handle on one streaming generation: an event queue
    the lane feeds (token chunks, then exactly one terminal event),
    iterable as token-chunk lists.  ``result()`` collects the whole
    stream."""

    def __init__(self, prompt_len, max_new_tokens):
        self.prompt_len = int(prompt_len)
        self.max_new_tokens = int(max_new_tokens)
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

    def _finish(self, reason):
        self.finish_reason = reason
        self._done.set()
        self._q.put(("done", reason))

    def _fail(self, exc):
        self._error = exc
        self.finish_reason = "error"
        self._done.set()
        self._q.put(("error", exc))

    # -- caller side ----------------------------------------------------

    def cancel(self):
        """Ask the lane to evict this request; the slot is freed (and
        zeroed) within one decode step."""
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
                 "stream", "enqueued", "buf", "gen")

    def __init__(self, prompt, max_new, chunk, deadline, priority):
        self.prompt = prompt
        self.max_new = int(max_new)
        self.chunk = max(int(chunk), 1)
        self.deadline = deadline
        self.priority = int(priority)
        self.stream = DecodeStream(len(prompt), max_new)
        self.enqueued = time.monotonic()
        self.buf = []
        self.gen = []


class _DecodeLane:
    """The decode lane: its slot-table session plus the slot -> request
    assignment the continuous loop walks, and its counters.  With a
    draft and spec_k >= 1 the session is a SpeculativeDecodeSession and
    the lane advances slots 1..k+1 tokens per round."""

    __slots__ = ("session", "spec", "assigned", "steps", "trips", "tokens",
                 "step_s", "step_ewma", "dead")

    def __init__(self, predictor, n_slots, draft=None, spec_k=0):
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
        self.dead = None     # error string once the lane's loop died


class DecodeBatcher:
    """Slot-based continuous batching over one GenerativePredictor, in
    one lane thread.  Admission control: bounded queue, lowest-priority-
    first shed, shed-not-hang.  Past admission the lifecycle is
    streaming: prefill into a free slot, then ride the running decode
    loop until EOS / max-new-tokens / deadline / cancel frees the slot
    for the next waiting request.

    `draft` (a GenerativePredictor sharing the target's vocab and eos)
    with `spec_k` (default FLAGS.serving_spec_k; < 1 disables it) makes
    the lane speculative.  A draft failure degrades the lane to
    target-only rounds within one round, never wedging a stream; a
    kernel that fails to build or launch ends the lane instead, as on a
    plain lane.

    `fuse_steps` (default FLAGS.serving_decode_fuse_steps, at least 1) is
    the fused window: above 1 a plain lane runs up to that many steps a
    dispatch, and a speculative lane fuses each round into one
    dispatch.  Cancelled and expired streams leave at window boundaries,
    and a deadline clamps a window's trips to what the lane's EWMA step
    time says fits, so it overshoots by about one window at most."""

    def __init__(self, predictor, n_slots=None, max_queue=None,
                 max_new_tokens=None, draft=None, spec_k=None,
                 fuse_steps=None):
        self.predictor = predictor
        self.n_slots = max(int(FLAGS.serving_decode_slots
                               if n_slots is None else n_slots), 1)
        self.max_queue = int(FLAGS.serving_max_queue
                             if max_queue is None else max_queue)
        self.max_new_cap = max(int(FLAGS.serving_max_new_tokens
                                   if max_new_tokens is None
                                   else max_new_tokens), 1)
        self.spec_k = int(FLAGS.serving_spec_k if spec_k is None
                          else spec_k)
        if draft is None or self.spec_k < 1:
            self.spec_k = 0
        self.fuse_steps = max(int(FLAGS.serving_decode_fuse_steps
                                  if fuse_steps is None else fuse_steps), 1)
        self._cv = threading.Condition()
        self._pending = collections.deque()
        self._lane = _DecodeLane(predictor, self.n_slots, draft=draft,
                                 spec_k=self.spec_k)
        self._closing = False
        self._stopped = False
        self._thread = threading.Thread(
            target=self._lane_loop, daemon=True,
            name="paddle-tpu-torch-decode-lane")
        self._thread.start()

    # ------------------------------------------------------------------

    @property
    def session(self):
        """The lane's session: a DecodeSession (its slot table), or the
        SpeculativeDecodeSession of a speculative lane."""
        return self._lane.session

    def queue_depth(self):
        return len(self._pending)

    def lane_stats(self):
        """Busy slots, dispatches (`steps`: decode steps, rounds or fused
        windows), logical steps (`trips`: a fused window's trips, one a
        step or round otherwise), tokens emitted, seconds in dispatches,
        the EWMA ms per logical step and the lane's error once it died;
        a speculative lane adds its verify and plain rounds, draft tokens
        proposed and accepted, `degraded` (latched by its session) and
        `degrade_error`, the draft failure that degraded it."""
        lane = self._lane
        with self._cv:
            stats = {"device": str(self.predictor.device),
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

    def kv_cache_info(self):
        """(kv_cache_dtype, measured slot-table bytes of the lane): the
        target table's K and V plus an int8 cache's scale table (a
        speculative lane's draft table is not counted)."""
        return (str(self.predictor.kv_cache_dtype),
                int(self._lane.session.cache_bytes()))

    # ------------------------------------------------------------------
    # submit side
    # ------------------------------------------------------------------

    def submit(self, tokens, max_new_tokens=None, deadline=None,
               priority=0, chunk_tokens=None):
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
                             deadline, priority)
        evicted = None
        with self._cv:
            if self._closing:
                raise BatcherClosed("model batcher is draining/closed")
            if self._lane.dead is not None:
                raise BatcherClosed("the decode lane is dead (%s)"
                                    % self._lane.dead)
            if len(self._pending) >= self.max_queue:
                victim = None
                for r in self._pending:
                    if r.priority < req.priority and \
                            (victim is None
                             or r.priority < victim.priority):
                        victim = r
                if victim is None:
                    raise ServerOverloaded(
                        "decode queue full (%d waiting, max_queue=%d) — "
                        "priority-%d request shed; back off and retry"
                        % (len(self._pending), self.max_queue,
                           req.priority),
                        priority=req.priority)
                self._pending.remove(victim)
                evicted = victim
            self._pending.append(req)
            self._cv.notify_all()
        if evicted is not None:
            evicted.stream._fail(ServerOverloaded(
                "priority-%d request shed from a full decode queue by "
                "a priority-%d arrival (lowest-priority-first overload "
                "policy)" % (evicted.priority, req.priority),
                priority=evicted.priority))
        return req.stream

    # ------------------------------------------------------------------
    # the continuous loop (the lane thread)
    # ------------------------------------------------------------------

    def _take_admits_locked(self):
        """Pop the requests the lane admits right now (caller holds
        _cv)."""
        room = self.n_slots - len(self._lane.assigned)
        out = []
        while self._pending and room > 0:
            out.append(self._pending.popleft())
            room -= 1
        return out

    def _finish(self, slot, req, reason, exc=None):
        """Terminal transition: flush, free (and therefore ZERO) the slot
        so the next admit starts clean, resolve the stream."""
        if req.buf:
            req.stream._put_tokens(req.buf)
            req.buf = []
        if slot is not None:
            self._lane.session.free(slot)
            with self._cv:
                self._lane.assigned.pop(slot, None)
        if exc is not None:
            req.stream._fail(exc)
        else:
            req.stream._finish(reason)

    def _expire(self, slot, req, now):
        """Deadline eviction — at admission or mid-decode."""
        self._finish(slot, req, "deadline", exc=DeadlineExceeded(
            "deadline passed after %.1f ms (%d tokens generated)"
            % ((now - req.enqueued) * 1e3, len(req.gen))))

    def _prefill(self, req):
        """Admit one request into a free slot: prefill the prompt and
        stream the first token (the time-to-first-token instant)."""
        now = time.monotonic()
        if req.stream.cancelled():
            self._finish(None, req, "cancelled")
            return
        if req.deadline is not None and now > req.deadline:
            self._expire(None, req, now)
            return
        lane = self._lane
        sess = lane.session
        slot = sess.free_slots()[0]
        try:
            first = sess.prefill(slot, req.prompt)
        except Exception as e:
            self._finish(None, req, "error", exc=e)
            return
        lane.tokens += 1
        req.gen.append(first)
        req.buf.append(first)
        with self._cv:
            lane.assigned[slot] = req
        if first == self.predictor.eos_id:
            self._finish(slot, req, "eos")
        elif req.max_new <= 1 or sess.room(slot) <= 0:
            self._finish(slot, req, "length")
        elif len(req.buf) >= req.chunk:
            req.stream._put_tokens(req.buf)
            req.buf = []

    def _lane_dead(self, exc):
        """Retire the lane after its loop raised: fail its in-flight and
        queued streams with the error (never leave them hanging)."""
        lane = self._lane
        with self._cv:
            lane.dead = "%s: %s" % (type(exc).__name__, exc)
            victims = list(lane.assigned.values()) + list(self._pending)
            lane.assigned.clear()
            self._pending.clear()
            self._cv.notify_all()
        for req in victims:
            req.buf = []
            req.stream._fail(exc)

    def _lane_loop(self):
        while True:
            try:
                if not self._lane_iter():
                    return
            except Exception as e:
                # a failed step (a CUDA error, a kernel that refused its
                # inputs) ends the lane; its streams fail typed
                self._lane_dead(e)
                return

    def _lane_iter(self):
        """One iteration of the continuous loop: admit + prefill, one
        dispatch (a decode step, a round or a fused window), stream
        bookkeeping.  Returns False to stop."""
        lane = self._lane
        sess = lane.session
        eos = self.predictor.eos_id
        with self._cv:
            while not lane.assigned and not self._pending:
                if self._stopped:
                    return False
                self._cv.wait(0.1)
            if self._stopped and not lane.assigned:
                return False
            admits = self._take_admits_locked()
        # prefill outside the lock: submits keep landing meanwhile
        for req in admits:
            self._prefill(req)
        if not lane.assigned:
            return True
        fuse = self.fuse_steps
        if fuse > 1:
            # window-boundary housekeeping: drop cancelled and expired
            # streams BEFORE spending a window on them
            nowb = time.monotonic()
            for slot, req in list(lane.assigned.items()):
                if req.stream.cancelled():
                    req.buf = []
                    self._finish(slot, req, "cancelled")
                elif req.deadline is not None and nowb > req.deadline:
                    self._expire(slot, req, nowb)
            if not lane.assigned:
                return True
        t0 = time.monotonic()
        trips = 1
        if lane.spec:
            toks, counts = sess.step(fused=fuse > 1)
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
        else:
            toks = sess.decode()[:, None]
            counts = np.ones(len(toks), np.int32)
        now = time.monotonic()
        lane.steps += 1
        lane.trips += trips
        lane.step_s += now - t0
        per_step = (now - t0) / max(trips, 1)
        lane.step_ewma = per_step if lane.step_ewma is None \
            else 0.5 * lane.step_ewma + 0.5 * per_step
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
                lane.tokens += 1
                if tok == eos:
                    finished = "eos"
                    break
                if len(req.gen) >= req.max_new:
                    finished = "length"
                    break
            if req.stream.cancelled():
                # client gone: nobody reads the flush — just free
                req.buf = []
                self._finish(slot, req, "cancelled")
                continue
            if req.deadline is not None and now > req.deadline:
                self._expire(slot, req, now)
                continue
            if finished is None and sess.room(slot) <= 0:
                finished = "length"
            if finished is not None:
                self._finish(slot, req, finished)
            elif len(req.buf) >= req.chunk:
                req.stream._put_tokens(req.buf)
                req.buf = []
        with self._cv:
            self._cv.notify_all()
        return True

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def _busy(self):
        return bool(self._pending or self._lane.assigned)

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
                        % (len(self._pending), len(self._lane.assigned),
                           timeout))
                self._cv.wait(0.05 if rem is None else min(rem, 0.05))

    def close(self, drain=True, timeout=30.0):
        """Stop accepting; optionally finish everything queued first,
        then stop the lane.  With drain=False, queued requests fail with
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
            for req in self._lane.assigned.values():
                req.stream.cancel()
            self._cv.notify_all()
        for req in leftovers:
            req.stream._fail(
                BatcherClosed("server shut down before dispatch"))
        self._thread.join(timeout=timeout)
