"""Reader decorators, after paddle_tpu/reader/decorator.py (reference
python/paddle/reader/decorator.py): map_readers, shuffle, chain,
compose, buffered, firstn, cache, xmap_readers, multiprocess_reader,
retry_reader, PipeReader and Fake, plus the device prefetch queue
`prefetch_to_device`.

A reader creator is a zero-argument callable returning an iterator over
samples; each decorator returns another.  A worker (thread or process)
that dies mid-stream surfaces as `ReaderWorkerFailed` to the consumer,
never as a hang or a silently short epoch.
"""

import itertools
import queue
import random
import threading

__all__ = [
    "map_readers", "buffered", "compose", "chain", "shuffle", "firstn",
    "xmap_readers", "cache", "ComposeNotAligned",
    "multiprocess_reader", "PipeReader", "Fake", "retry_reader",
    "prefetch_to_device", "ReaderWorkerFailed",
]


class ReaderWorkerFailed(RuntimeError):
    """A reader worker (thread or process) died mid-stream.  Raised to
    the consumer instead of hanging on a sentinel that will never come
    or silently truncating the epoch; `cause_repr` carries the worker's
    exception (string form — it may have crossed a process boundary)."""

    def __init__(self, message, cause_repr=None):
        super(ReaderWorkerFailed, self).__init__(message)
        self.cause_repr = cause_repr


class _WorkerError(object):
    """In-band error marker a failing worker emits before exiting; must
    be pickle-stable so it survives the multiprocessing pipe/queue."""

    def __init__(self, exc):
        self.exc_repr = repr(exc)

    def __reduce__(self):
        w = _WorkerError.__new__(_WorkerError)
        w.exc_repr = self.exc_repr
        return (_rebuild_worker_error, (self.exc_repr,))


def _rebuild_worker_error(exc_repr):
    w = _WorkerError.__new__(_WorkerError)
    w.exc_repr = exc_repr
    return w


class ComposeNotAligned(ValueError):
    pass


def map_readers(func, *readers):
    """Apply func to the items of several readers zipped together
    (reference decorator.py:36)."""

    def reader():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)

    return reader


def shuffle(reader, buf_size):
    """Buffered shuffle (reference decorator.py:60)."""

    def data_reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if buf:
            random.shuffle(buf)
            for b in buf:
                yield b

    return data_reader


def chain(*readers):
    """Concatenate readers (reference decorator.py:88)."""

    def reader():
        rs = [r() for r in readers]
        for e in itertools.chain(*rs):
            yield e

    return reader


def compose(*readers, **kwargs):
    """Zip readers into tuple samples (reference decorator.py:118);
    check_alignment raises ComposeNotAligned on length mismatch."""
    check_alignment = kwargs.pop("check_alignment", True)

    def make_tuple(x):
        if isinstance(x, tuple):
            return x
        return (x,)

    def reader():
        rs = [r() for r in readers]
        if not check_alignment:
            for outputs in zip(*rs):
                yield sum(list(map(make_tuple, outputs)), ())
        else:
            for outputs in itertools.zip_longest(*rs):
                if any(o is None for o in outputs):
                    raise ComposeNotAligned(
                        "outputs of readers are not aligned")
                yield sum(list(map(make_tuple, outputs)), ())

    return reader


def buffered(reader, size):
    """Background-thread prefetch buffer (reference decorator.py:180)."""

    class _End:
        pass

    def data_reader():
        r = reader()
        q = queue.Queue(maxsize=size)

        def fill():
            try:
                for d in r:
                    q.put(d)
            finally:
                q.put(_End)

        t = threading.Thread(target=fill, daemon=True)
        t.start()
        while True:
            e = q.get()
            if e is _End:
                return
            yield e

    return data_reader


def firstn(reader, n):
    """First n samples (reference decorator.py:230)."""

    def firstn_reader():
        for i, item in enumerate(reader()):
            if i == n:
                return
            yield item

    return firstn_reader


def cache(reader):
    """Materialize once, replay from memory."""
    all_data = []
    filled = []

    def cache_reader():
        if not filled:
            all_data.extend(reader())
            filled.append(True)
        for d in all_data:
            yield d

    return cache_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map over a reader with worker threads (reference
    decorator.py xmap_readers). Order-preserving mode tags samples with
    sequence ids and reorders on the output side."""

    class _End:
        pass

    def data_reader():
        in_q = queue.Queue(buffer_size)
        out_q = queue.Queue(buffer_size)

        def feed():
            try:
                for i, sample in enumerate(reader()):
                    in_q.put((i, sample))
            except Exception as e:
                # the source reader died: tell the CONSUMER directly —
                # workers may be blocked on in_q and the consumer must
                # not wait forever for sentinels that will never come
                out_q.put(_WorkerError(e))
            finally:
                for _ in range(process_num):
                    in_q.put(_End)

        def work():
            while True:
                item = in_q.get()
                if item is _End:
                    out_q.put(_End)
                    return
                i, sample = item
                try:
                    mapped = mapper(sample)
                except Exception as e:
                    # a mapper crash mid-stream surfaces to the consumer
                    # (reference xmap handled exceptions by re-raising in
                    # the output thread) — never a silent short epoch
                    out_q.put(_WorkerError(e))
                    out_q.put(_End)
                    return
                out_q.put((i, mapped))

        def _raise(err):
            raise ReaderWorkerFailed(
                "xmap_readers worker failed mid-stream: %s" % err.exc_repr,
                cause_repr=err.exc_repr)

        threading.Thread(target=feed, daemon=True).start()
        for _ in range(process_num):
            threading.Thread(target=work, daemon=True).start()

        finished = 0
        if not order:
            while finished < process_num:
                item = out_q.get()
                if item is _End:
                    finished += 1
                    continue
                if isinstance(item, _WorkerError):
                    _raise(item)
                yield item[1]
        else:
            next_id = 0
            held = {}
            while finished < process_num or held:
                if next_id in held:
                    yield held.pop(next_id)
                    next_id += 1
                    continue
                if finished >= process_num:
                    # drain remaining out-of-order items
                    if not held:
                        break
                    continue
                item = out_q.get()
                if item is _End:
                    finished += 1
                    continue
                if isinstance(item, _WorkerError):
                    _raise(item)
                i, mapped = item
                if i == next_id:
                    yield mapped
                    next_id += 1
                else:
                    held[i] = mapped

    return data_reader


class _EndOfStream(object):
    """Pickle-stable end sentinel for multiprocess_reader — a plain None
    would truncate streams whose readers legitimately yield None."""

    def __reduce__(self):
        return (_EndOfStream, ())


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """Merge readers, one OS process each (reference decorator.py:338).
    Each child streams items; the parent interleaves until every child
    has sent its end sentinel.  A child whose reader raises ships the
    exception in-band (a `_WorkerError` before its sentinel) and the
    parent raises ReaderWorkerFailed; a child that dies without ANY
    sentinel (kill -9, segfault) is detected at EOF and also raises —
    an epoch is never silently truncated."""
    import multiprocessing
    import sys
    assert isinstance(readers, (list, tuple)) and len(readers) > 0

    def _raise(err):
        raise ReaderWorkerFailed(
            "multiprocess_reader worker failed mid-stream: %s"
            % err.exc_repr, cause_repr=err.exc_repr)

    def _feed(reader, q):
        try:
            for item in reader():
                q.put(item)
        except Exception as e:
            q.put(_WorkerError(e))
        finally:
            q.put(_EndOfStream())

    def queue_reader():
        q = multiprocessing.Queue(queue_size)
        procs = [multiprocessing.Process(target=_feed, args=(r, q))
                 for r in readers]
        for p in procs:
            p.daemon = True
            p.start()
        finished = 0
        while finished < len(readers):
            item = q.get()
            if isinstance(item, _EndOfStream):
                finished += 1
            elif isinstance(item, _WorkerError):
                _raise(item)
            else:
                yield item
        for p in procs:
            p.join()

    def pipe_reader():
        from multiprocessing.connection import wait
        conns = []
        procs = []
        for r in readers:
            parent, child = multiprocessing.Pipe(duplex=False)

            def _feed_pipe(reader, conn):
                try:
                    for item in reader():
                        conn.send(item)
                except Exception as e:
                    try:
                        conn.send(_WorkerError(e))
                    except (ValueError, OSError):
                        pass  # unpicklable/broken pipe: EOF path catches
                finally:
                    try:
                        conn.send(_EndOfStream())
                        conn.close()
                    except OSError:
                        pass
            p = multiprocessing.Process(target=_feed_pipe,
                                        args=(r, child))
            p.daemon = True
            p.start()
            child.close()   # parent must drop its copy or EOF never fires
            conns.append(parent)
            procs.append(p)
        live = list(conns)
        while live:
            for conn in wait(live):
                try:
                    item = conn.recv()
                except EOFError:   # child died before its sentinel
                    idx = conns.index(conn)
                    procs[idx].join(timeout=5.0)
                    code = procs[idx].exitcode
                    raise ReaderWorkerFailed(
                        "multiprocess_reader worker %d died before its "
                        "end-of-stream sentinel (exitcode %r) — epoch "
                        "would have been silently truncated" % (idx, code))
                if isinstance(item, _EndOfStream):
                    live.remove(conn)
                elif isinstance(item, _WorkerError):
                    _raise(item)
                else:
                    yield item
        for p in procs:
            p.join()

    if sys.platform == "win32":
        raise NotImplementedError("multiprocess_reader: POSIX only")
    return pipe_reader if use_pipe else queue_reader


def _stage(item, device, stream):
    """One batch on `device`: a dict's numpy arrays, numpy scalars and
    host tensors become tensors there (anything else, a LoDTensor or a
    tensor already there, passes through: the caller's `prepare` job).
    On a card each host tensor is pinned (`pin_memory()`: from pageable
    memory a copy is quietly synchronous) and copied non-blocking on the
    worker's `stream`; the returned event is recorded after the copies.
    Returns (item, event or None)."""
    import numpy as np
    import torch
    from ..fluid.executor import as_tensor
    if not isinstance(item, dict):
        return item, None
    on_card = device.type == "cuda"
    out = {}
    copied = False
    for k, v in item.items():
        if isinstance(v, torch.Tensor) and v.device == device:
            out[k] = v
        elif isinstance(v, (np.ndarray, np.generic, torch.Tensor)):
            t = v if isinstance(v, torch.Tensor) else as_tensor(v)
            if not on_card:
                out[k] = t.to(device)
                continue
            if t.device.type == "cpu" and not t.is_pinned():
                t = t.pin_memory()
            with torch.cuda.stream(stream):
                out[k] = t.to(device, non_blocking=True)
            copied = True
        else:
            out[k] = v
    if not copied:
        return out, None
    event = torch.cuda.Event()
    event.record(stream)
    return out, event


def _consume(item, event, device):
    """The consumer's side of a staged batch: its current stream waits
    for the copies, and each copied tensor is marked as used there, so
    the caching allocator does not hand its memory to the next batch's
    copy while the step still reads it."""
    if event is None:
        return item
    import torch
    cur = torch.cuda.current_stream(device)
    cur.wait_event(event)
    for v in item.values():
        if isinstance(v, torch.Tensor) and v.device == device:
            v.record_stream(cur)
    return item


def prefetch_to_device(reader, depth=2, prepare=None, device=None,
                       group=None):
    """Device prefetch queue (after the JAX package's, the reference's
    double_buffer / py_reader infeed overlap): a bounded background
    thread pulls batches from `reader`, runs `prepare` on them (the
    Trainer passes the Executor's `prepare_feeds`: dtype casts, LoD
    padding) and copies each dict's arrays to the card on a side
    stream, from pinned memory and non-blocking, while the current step
    computes.  The consumer's stream waits on the copies' event before
    the step reads the batch.

    `device` is the card by default (`resolve_device`; `"cpu"` stages
    nothing but the tensor conversion).  `group` (a ParallelExecutor's
    `pe.group`, parallel/mesh.py) is the data-parallel mode: the reader
    yields this rank's share of the global batch (a dict, or a list of
    per-device dicts, merged as ParallelExecutor.run merges them) and
    the worker copies it to the rank's card, where the ParallelExecutor
    takes it without a second copy.

    Semantics the tests pin:

    * bounded backpressure: at most `depth` prepared batches wait in the
      queue (plus one in the worker's hand);
    * clean shutdown: closing the returned generator (or the end of the
      epoch) stops the worker and joins it;
    * worker death: an exception in the source reader or in `prepare`
      reaches the consumer as ReaderWorkerFailed, never a hang or a
      silently short epoch.
    """
    import torch
    from .. import resolve_device
    depth = max(int(depth), 1)
    if group is not None:
        device = group.device
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        # the worker thread must name its card (set_device)
        device = torch.device("cuda", torch.cuda.current_device())
    host_prep = prepare if prepare is not None else (lambda x: x)
    if group is not None:
        from ..fluid.parallel_executor import _local_feed
        prep = lambda item: _local_feed(host_prep(item))  # noqa: E731
    else:
        prep = host_prep

    class _End(object):
        pass

    def data_reader():
        q = queue.Queue(maxsize=depth)
        stop = threading.Event()

        def _put(item):
            # bounded put that still honors shutdown: a worker blocked
            # on a full queue must notice the consumer has gone away
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                stream = None
                if device.type == "cuda":
                    # a new thread starts on card 0: a rank's is another
                    torch.cuda.set_device(device)
                    stream = torch.cuda.Stream(device=device)
                for item in reader():
                    if stop.is_set():
                        return
                    if not _put(_stage(prep(item), device, stream)):
                        return
            except Exception as e:
                _put(_WorkerError(e))
                return
            _put(_End)

        t = threading.Thread(target=worker, daemon=True,
                             name="paddle-tpu-prefetch")
        t.start()
        try:
            import time as _time
            from ..obs import tracing as _obs_tracing
            # prefetch_wait: how long the train loop blocked on the
            # queue for each batch (0 when prefetch hides the host work)
            wait_t0 = _time.perf_counter()
            while True:
                try:
                    item = q.get(timeout=1.0)
                except queue.Empty:
                    if not t.is_alive():
                        raise ReaderWorkerFailed(
                            "prefetch_to_device worker died without an "
                            "end-of-stream sentinel: the epoch would have "
                            "been silently truncated")
                    continue
                if item is _End:
                    return
                if isinstance(item, _WorkerError):
                    raise ReaderWorkerFailed(
                        "prefetch_to_device worker failed mid-stream: %s"
                        % item.exc_repr, cause_repr=item.exc_repr)
                if _obs_tracing.enabled():
                    wait_ms = (_time.perf_counter() - wait_t0) * 1e3
                    _obs_tracing.add_span(_obs_tracing.Span(
                        "train/prefetch_wait", kind="train",
                        ts=_time.time() - wait_ms / 1e3,
                        dur_ms=wait_ms))
                yield _consume(item[0], item[1], device)
                wait_t0 = _time.perf_counter()
        finally:
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5.0)

    return data_reader


def retry_reader(reader, policy=None, retry_on=(Exception,)):
    """Wrap a reader with the fault-tolerance RetryPolicy (the SAME
    policy object family as the RPC re-dial wrappers — utils/retry.py):
    when the underlying reader raises mid-stream, back off with jitter,
    re-open it, skip the samples already delivered, and continue the
    epoch from where it broke.  Exhausting the policy's attempts
    re-raises the reader's exception.

    Correct only for deterministic re-openable sources (files, PipeReader
    commands): the skip replays the prefix to find the resume point."""
    if policy is None:
        from ..utils.retry import RetryPolicy
        policy = RetryPolicy(max_attempts=3, base_delay=0.05,
                             retry_on=retry_on)
    retry_on = tuple(retry_on)

    def data_reader():
        delivered = 0
        delays = policy.delays()
        while True:
            try:
                for i, item in enumerate(reader()):
                    if i < delivered:
                        continue  # replaying the already-yielded prefix
                    yield item
                    delivered += 1
                return
            except retry_on:
                # next() must not raise StopIteration inside a generator
                # (PEP 479 would mask the reader's exception)
                delay = next(delays, None)
                if delay is None:
                    raise
                policy.sleep(delay)

    return data_reader


class PipeReader:
    """Stream a shell command's stdout and parse it into lines
    (reference decorator.py:438) — read corpora from another program
    (hdfs/ceph/s3 cat, curl, zcat, ...)."""

    def __init__(self, command, bufsize=8192, file_type="plain"):
        import subprocess
        import zlib
        if not isinstance(command, str):
            raise TypeError("left_cmd must be a string")
        if file_type == "gzip":
            self.dec = zlib.decompressobj(32 + zlib.MAX_WBITS)
        elif file_type != "plain":
            raise TypeError("file_type %s is not allowed" % file_type)
        self.file_type = file_type
        self.bufsize = bufsize
        self.process = subprocess.Popen(
            command.split(" "), bufsize=bufsize, stdout=subprocess.PIPE)

    def get_line(self, cut_lines=True, line_break="\n"):
        remained = ""
        while True:
            buff = self.process.stdout.read(self.bufsize)
            if not buff:
                break
            if self.file_type == "gzip":
                decomp = self.dec.decompress(buff).decode(
                    "utf-8", "replace")
            else:
                decomp = buff.decode("utf-8", "replace")
            if cut_lines:
                pieces = (remained + decomp).split(line_break)
                remained = pieces[-1]
                for line in pieces[:-1]:
                    yield line
            else:
                yield decomp
        if cut_lines and remained:
            yield remained


class Fake(object):
    """Cache the first item a reader yields and repeat it data_num times
    (reference decorator.py:509) — pins the input for speed testing."""

    _EMPTY = object()      # source reader yielded nothing
    _UNSET = object()      # first item not cached yet (None is a legal
                           # item — it must not re-trigger consumption)

    def __init__(self):
        self.data = Fake._UNSET

    def __call__(self, reader, data_num):
        def fake_reader():
            if self.data is Fake._UNSET:
                self.data = next(reader(), Fake._EMPTY)
            if self.data is Fake._EMPTY:
                return   # empty source reader -> empty stream
            for _ in range(data_num):
                yield self.data

        return fake_reader
