"""Asynchronous step pipeline, after paddle_tpu/fluid/pipeline.py:
in-flight dispatch and a deferred host sync.

A CUDA step launched from the host returns as soon as its kernels are
queued; the host only waits when it reads a result.  The pipeline keeps
it from reading too early: `Executor.run(..., as_future=True)` returns
a `FetchFuture` that holds the step's fetches as tensors on the card
and a `torch.cuda.Event` recorded on the compute stream after the step,
and the train loop keeps up to `FLAGS.async_dispatch_depth` of them in
flight, resolving each at the pipeline tail.

* `FetchFuture` — one dispatched step's fetches.  `ready()` asks the
  event (`event.query()`, no wait).  `result()` resolves once and caches:
  ONE batched device-to-host copy of every fetch — a copy stream waits
  on the step's event, every fetch is copied non-blocking into a pinned
  host buffer there, and one event on the copy stream is waited for —
  never one `.cpu()` per fetch, and never a wait on the steps dispatched
  after this one.  Under `FLAGS.step_watchdog_secs` the drain runs under
  the wall-clock watchdog (fluid/executor.py `_watchdog_call`: the wait
  happens on a helper thread and the caller's wait is bounded).
* `DispatchPipeline` — a bounded in-flight window: `submit` enqueues a
  future (plus caller metadata) and, once more than `depth` steps are
  live, drains the oldest; `drain`, `drain_all` and `discard_inflight`
  as in the JAX package.

On the CPU the fetches are host tensors already and a future resolves
without any copy.
"""

import collections
import threading

import torch

__all__ = ["FetchFuture", "DispatchPipeline", "to_host"]

_UNSET = object()

_copy_streams = {}
_copy_lock = threading.Lock()


def _copy_stream(device):
    """The side stream the batched device-to-host copies of `device` run
    on (one per card, shared by every future)."""
    with _copy_lock:
        s = _copy_streams.get(device)
        if s is None:
            s = _copy_streams[device] = torch.cuda.Stream(device=device)
        return s


def to_host(values, event=None):
    """`values` (tensors, None, or host objects) with every CUDA tensor
    copied to a pinned host tensor in ONE batch per card: the copy stream
    waits on `event` (the step's; the caller's current stream when None),
    the copies are issued non-blocking there, and one event recorded
    after them is waited for.  The source tensors are marked as used on
    the copy stream, so the caching allocator cannot hand their memory
    out before the copies are done."""
    values = list(values)
    by_device = {}
    for i, v in enumerate(values):
        if isinstance(v, torch.Tensor) and v.is_cuda:
            by_device.setdefault(v.device, []).append(i)
    if not by_device:
        return values
    out = list(values)
    done = []
    for device, idx in by_device.items():
        copy = _copy_stream(device)
        if event is not None:
            copy.wait_event(event)
        else:
            copy.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(copy):
            for i in idx:
                v = values[i]
                v.record_stream(copy)
                h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                h.copy_(v, non_blocking=True)
                out[i] = h
            ev = torch.cuda.Event()
            ev.record(copy)
        done.append(ev)
    for ev in done:
        ev.synchronize()
    return out


class FetchFuture:
    """One dispatched step's fetched values, kept on the card until
    `result()` resolves them.  Resolution happens at most once (the
    value is cached): one batched copy to the host (`to_host`), then the
    caller's `post` hook (LoD reassembly, numpy conversion).

    When `FLAGS.step_watchdog_secs` is set the watchdog wraps the
    resolve; `watchdog_scale` scales the budget by how many steps the
    drain may be waiting behind."""

    def __init__(self, fetches, post=None, return_numpy=True,
                 what="pipeline drain", event=None):
        self._fetches = list(fetches)
        self._post = post
        self._return_numpy = return_numpy
        self._what = what
        self._event = event
        self._value = _UNSET

    def done(self):
        """True once `result()` has resolved (no device query)."""
        return self._value is not _UNSET

    def ready(self):
        """True when `result()` would not wait for the card: the step's
        event has completed (`event.query()`), or there is no event (a
        CPU step)."""
        if self._value is not _UNSET or self._event is None:
            return True
        return self._event.query()

    def _resolve(self):
        vals = self._fetches
        if self._return_numpy:
            vals = to_host(vals, self._event)
        if self._post is not None:
            return self._post(vals, self._return_numpy)
        if self._return_numpy:
            from .executor import as_numpy
            return [None if v is None else as_numpy(v) for v in vals]
        return vals

    def result(self, watchdog_scale=1, step=None):
        """Resolve (the host sync) and return the step's fetches.  The
        pipeline's only mandatory host-device synchronization: the
        watchdog, when enabled, wraps exactly this, and the obs
        `train/drain` span measures it.  `step` labels the span with the
        dispatch-order step id."""
        if self._value is not _UNSET:
            return self._value
        from ..flags import FLAGS
        from ..obs import tracing as obs_tracing
        wd = FLAGS.step_watchdog_secs
        with obs_tracing.trace("train/drain", kind="train",
                               **({} if step is None else {"step": step})):
            if wd and wd > 0:
                from .executor import _watchdog_call
                self._value = _watchdog_call(
                    self._resolve, wd * max(int(watchdog_scale), 1),
                    self._what)
            else:
                self._value = self._resolve()
        return self._value


class DispatchPipeline:
    """Bounded window of in-flight steps.  `submit(future, **meta)`
    enqueues; once more than `depth` steps are live the oldest is
    resolved and returned, so the host never runs more than `depth`
    steps ahead of the card.  `depth=0` is fully synchronous."""

    def __init__(self, depth):
        self.depth = max(int(depth), 0)
        self._inflight = collections.deque()

    def __len__(self):
        return len(self._inflight)

    def submit(self, future, **meta):
        """Enqueue one dispatched step; returns the (result, meta) pairs
        drained to honor the depth bound (empty, or one)."""
        self._inflight.append((future, meta))
        drained = []
        while len(self._inflight) > self.depth:
            drained.append(self.drain())
        return drained

    def drain(self):
        """Resolve and return the oldest in-flight step as (result,
        meta); None when nothing is in flight."""
        if not self._inflight:
            return None
        future, meta = self._inflight.popleft()
        # the oldest of N queued steps may need N steps of wall clock
        return future.result(watchdog_scale=len(self._inflight) + 1,
                             step=meta.get("step")), meta

    def drain_all(self):
        """Resolve everything in flight, oldest first: the pipeline's
        sync boundary (epoch end, checkpoint, shutdown)."""
        out = []
        while self._inflight:
            out.append(self.drain())
        return out

    def discard_inflight(self):
        """Drop every in-flight step without resolving it and return the
        (future, meta) pairs: the sentinel's recovery path (steps
        dispatched after a reverted one computed from poisoned state)."""
        dropped = list(self._inflight)
        self._inflight.clear()
        return dropped
