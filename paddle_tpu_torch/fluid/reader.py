"""PyReader, after paddle_tpu/fluid/reader.py (reference operators/reader/:
create_py_reader feeding a LoDTensorBlockingQueue, decorated by a
double_buffer reader that prefetches to the device).

A daemon thread pulls batches from the user's provider into a bounded
queue of `capacity` (the blocking queue).  With the double buffer on,
the thread also turns each batch into the step's tensors
(`executor.prepare_feeds`: dtype casts, LoD padding and companions) and
stages them on the reader's place, the card unless a place is given,
with reader/decorator.py's `_stage`: pinned host memory, a side stream
and an event.  `next_feed` hands the consumer the next batch after
`_consume` (its stream waits on the event; each tensor is marked used
there), so the Executor takes the feed on the card as it is.  Without
the double buffer the batches stay numpy on the host.

The thread never blocks for good: it puts with a timeout in a loop that
checks the stop event, the end-of-data sentinel included, and `reset()`
sets the event, drains the queue and joins the thread.  A provider that
raises reaches the consumer as `reader.ReaderWorkerFailed`.
`timings` holds, per batch of the last `start()`, the ms the thread
spent reading it (the provider's next batch, e.g. a RecordIO record
decoded, and its conversion to the step's tensors) and staging it.
"""

import queue
import threading
import time

import numpy as np

__all__ = ["PyReader"]

_PUT_POLL_S = 0.1
_JOIN_S = 60.0


class _End:
    pass


class PyReader:
    def __init__(self, capacity, feed_vars, use_double_buffer=True,
                 place=None):
        self.capacity = max(int(capacity), 1)
        self.feed_vars = list(feed_vars)
        self.output_vars = self.feed_vars
        self.use_double_buffer = use_double_buffer
        # the double buffer's place: None is the card
        self.place = place
        self.timings = []
        self._paddle_reader = None
        self._queue = None
        self._thread = None
        self._device = None
        self._done = False
        self._stop = threading.Event()

    def decorate_paddle_reader(self, reader, places=None):
        """`reader`: a callable returning an iterator of batches, each a
        tuple in feed_vars order or a {name: value} dict."""
        self._paddle_reader = reader

    decorate_sample_list_generator = decorate_paddle_reader
    decorate_tensor_provider = decorate_paddle_reader
    decorate_batch_generator = decorate_paddle_reader

    @property
    def thread(self):
        """The worker of the running pass (None after reset())."""
        return self._thread

    def _staging_device(self):
        import torch

        from .. import resolve_device
        if not self.use_double_buffer:
            return None
        dev = resolve_device(None if self.place is None
                             else self.place.torch_device())
        if dev.type == "cuda" and dev.index is None:
            # the worker names its card (a new thread starts on card 0)
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev

    def _to_feed(self, item):
        from .lod import LoDTensor
        if not isinstance(item, dict):
            item = {v.name: value for v, value in zip(self.feed_vars, item)}
        return {k: v if isinstance(v, LoDTensor) else np.asarray(v)
                for k, v in item.items()}

    def _put(self, item):
        """Put with a timeout, in a loop that honours reset(): False once
        stopped."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=_PUT_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def start(self):
        """Start a pass: the worker begins to fill the queue."""
        if self._paddle_reader is None:
            raise RuntimeError("PyReader.start: decorate the reader with "
                               "a provider first")
        if self._thread is not None:
            raise RuntimeError("PyReader.start: the reader is running; "
                               "reset() it first")
        from ..reader.decorator import _stage, _WorkerError
        from .executor import prepare_feeds
        device = self._device = self._staging_device()
        program = self.feed_vars[0].block.program if self.feed_vars \
            else None
        provider = self._paddle_reader
        timings = self.timings = []
        self._queue = queue.Queue(maxsize=self.capacity)
        self._stop.clear()
        self._done = False

        def worker():
            try:
                stream = None
                if device is not None and device.type == "cuda":
                    import torch
                    torch.cuda.set_device(device)
                    stream = torch.cuda.Stream(device=device)
                batches = iter(provider())
                while not self._stop.is_set():
                    t0 = time.perf_counter()
                    item = next(batches, _End)
                    if item is _End:
                        break
                    feed = self._to_feed(item)
                    if device is not None:
                        feed = prepare_feeds(program, feed)
                    t1 = time.perf_counter()
                    staged = _stage(feed, device, stream) \
                        if device is not None else (feed, None)
                    timings.append(((t1 - t0) * 1e3,
                                    (time.perf_counter() - t1) * 1e3))
                    if not self._put(staged):
                        return
            except Exception as e:  # noqa: BLE001 - reaches the consumer
                self._put((_WorkerError(e), None))
                return
            if not self._stop.is_set():
                self._put(_End)

        self._thread = threading.Thread(target=worker, daemon=True,
                                        name="paddle-tpu-torch-py-reader")
        self._thread.start()

    def next_feed(self):
        """The next feed dict; StopIteration at the end of the pass."""
        from ..reader.decorator import (ReaderWorkerFailed, _consume,
                                        _WorkerError)
        if self._queue is None:
            raise RuntimeError("PyReader: start() the reader first")
        if self._done:
            raise StopIteration
        item = self._queue.get()
        if item is _End:
            self._done = True
            raise StopIteration
        feed, event = item
        if isinstance(feed, _WorkerError):
            self._done = True
            raise ReaderWorkerFailed(
                "PyReader: the provider raised %s" % feed.exc_repr,
                feed.exc_repr)
        return _consume(feed, event, self._device)

    def __iter__(self):
        while True:
            try:
                yield self.next_feed()
            except StopIteration:
                return

    def reset(self):
        """End the pass: stop the worker, drop what it queued, join it."""
        self._stop.set()
        if self._queue is not None:
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
        if self._thread is not None:
            self._thread.join(_JOIN_S)
            if self._thread.is_alive():
                raise RuntimeError(
                    "PyReader.reset: the worker is still inside the "
                    "provider after %.0f s" % _JOIN_S)
        self._thread = None
        self._queue = None
