"""Threaded inference server and client over the typed wire codec, after
paddle_tpu/serving/server.py.  The frames (distributed/rpc.py over
native/wire.py — no pickle on the socket) and the verbs are the JAX
package's, so either package's client talks to either server:

  infer         {"cmd","model","feeds"{name->ndarray},"deadline_ms"?,
                 "version"?,"priority"?,"precision"?,"max_new_tokens"?,
                 "trace_id"?,"debug"?} -> {"ok","trace_id","fetches"}
                 or {"error","code"} with code in {"overloaded",
                 "deadline","no_model","bad_request","internal"}; an
                 "overloaded" reply carries "shed_priority"
  infer_stream  {"cmd","model","tokens",...} -> chunk frames {"chunk",
                 "seq","tokens","trace_id"}, then one terminal frame
  load_model    {"cmd","name","path",...} — load or hot swap
  unload_model  {"cmd","name"} — drain then remove
  stats         -> the ServingMetrics snapshot + the registry's models
  health        -> per-model lane liveness + SLO state
  metrics       -> the Prometheus-style text of obs.registry
  trace         {"trace_id"?,"limit"?,"kind"?} -> spans of the ring
  drain         {"resume"?} — stop (or resume) accepting new requests
  shutdown      graceful drain, then the server stops accepting
  exit          close this connection and stop the accept loop

  flight        {"reason"?,"force"?} -> commit a flight-recorder bundle
                (obs/flightrec.py; {"bundle": None} while
                FLAGS.flight_dir is unset)

The verbs `fleet`, `page_model`, `resize_model` and `fault_model`
answer a typed `bad_request` naming the ROADMAP.md item that ports them,
and a server asked for federation or the fleet controller raises at
construction.  While it runs, a server is a flight-recorder provider:
every bundle carries its stats, models, health and SLO timeline.

Admission control is the batcher's bounded queue: a request past
`FLAGS.serving_max_queue` is answered at once with "overloaded".  The
client's `infer` re-offers shed requests under the jittered-backoff
RetryPolicy until its deadline.  A model's batcher error (a CUDA or
kernel error included) reaches the client as an "internal" error reply.
"""

import socket
import socketserver
import threading
import time

import numpy as np

from ..distributed.rpc import _recv_msg, _send_msg
from ..flags import FLAGS
from ..native.wire import WireError
from ..obs import flightrec
from ..obs import registry as obs_registry
from ..obs import tracing as obs_tracing
from .batcher import BatcherClosed, DeadlineExceeded, ServerOverloaded
from .metrics import ServingMetrics
from .model_registry import ModelRegistry

__all__ = ["InferenceServer", "ServingClient", "ServingError",
           "StreamBroken"]

_CLOSE = object()

# verbs of the JAX server whose subsystems are not ported yet
_WAITING_VERBS = {
    "fleet": "the fleet controller (serving/fleet.py)",
    "page_model": "paging (with the fleet controller)",
    "resize_model": "resize (with the fleet controller)",
    "fault_model": "fault-in (with the fleet controller)",
}


class ServingError(RuntimeError):
    """Server-side failure reported over the wire (non-typed codes);
    `code` is the reply's code."""


class StreamBroken(ServingError):
    """An ``infer_stream`` connection died mid-generation.  ``received``
    counts the tokens already yielded (the server committed them).  Not
    a ConnectionError: a reconnect-and-retry wrapper must never restart
    a broken stream from token 0 and duplicate committed output."""

    def __init__(self, message, trace_id=None, received=0,
                 backend=None):
        super(StreamBroken, self).__init__(message)
        self.trace_id = trace_id
        self.received = int(received)
        self.backend = backend


def _no_delay(sock):
    """Send each frame at once: without TCP_NODELAY the tail segment of a
    large frame (an image batch) can wait on the peer's delayed ACK."""
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass


def _error_reply(exc):
    if isinstance(exc, ServerOverloaded):
        reply = {"error": str(exc), "code": "overloaded"}
        if getattr(exc, "priority", None) is not None:
            reply["shed_priority"] = int(exc.priority)
        return reply
    if isinstance(exc, (DeadlineExceeded, TimeoutError)):
        return {"error": str(exc), "code": "deadline"}
    if isinstance(exc, KeyError):
        return {"error": str(exc.args[0]) if exc.args else str(exc),
                "code": "no_model"}
    if isinstance(exc, (ValueError, TypeError, BatcherClosed,
                        NotImplementedError)):
        return {"error": str(exc), "code": "bad_request"}
    return {"error": "%s: %s" % (type(exc).__name__, exc),
            "code": "internal"}


class InferenceServer:
    """One serving endpoint over a ModelRegistry.  `replicas` is the
    default placement of every load (resolve_placement: N, 'auto', or a
    device list such as 'cpu' or 'cuda:0,cuda:1'); a `load_model`
    request may override it per model.  `federation` (a frontend to
    lease against) waits with federation and raises."""

    def __init__(self, endpoint="127.0.0.1:0", max_queue=None,
                 deadline_ms=None, workers=None, buckets=None,
                 replicas=None, federation=None):
        if federation or FLAGS.federation_frontend:
            raise NotImplementedError(
                "federation (paddle_tpu/federation) is not ported to "
                "paddle_tpu_torch yet (ROADMAP.md queue 1)")
        if FLAGS.fleet_controller:
            raise NotImplementedError(
                "FLAGS.fleet_controller: the fleet controller "
                "(serving/fleet.py) is not ported to paddle_tpu_torch yet "
                "(ROADMAP.md queue 1)")
        host, port = endpoint.rsplit(":", 1)
        self._addr = (host, int(port))
        self.metrics = ServingMetrics()
        self._obs_registry = obs_registry.default()
        self._obs_registry.attach_serving(self.metrics)
        self.slo = None
        if FLAGS.slo_monitor:
            from ..obs import slo as obs_slo
            self.slo = obs_slo.SLOMonitor.from_flags(self.metrics)
        self.registry = ModelRegistry(
            metrics=self.metrics, max_queue=max_queue,
            deadline_ms=deadline_ms, workers=workers, replicas=replicas)
        self._default_buckets = buckets
        self._stopped = False
        self._draining = False
        self._shutdown_lock = threading.Lock()
        self._server = None
        self._thread = None

    # ------------------------------------------------------------------

    def start(self, background=True):
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def setup(self):
                _no_delay(self.request)

            def handle(self):
                try:
                    while True:
                        msg = _recv_msg(self.request)
                        if msg.get("cmd") == "infer_stream":
                            # the stream handler owns the socket until
                            # its final frame (or the connection dies,
                            # which cancels the stream)
                            outer._handle_infer_stream(msg, self.request)
                            continue
                        try:
                            reply = outer._dispatch(msg)
                        except BaseException as e:
                            reply = _error_reply(e)
                        if reply is _CLOSE:
                            _send_msg(self.request, {"ok": True})
                            break
                        try:
                            _send_msg(self.request, reply)
                        except WireError as e:
                            # an oversize reply: the stream is still in
                            # sync, so say what failed
                            _send_msg(self.request, {"error": str(e),
                                                     "code": "internal"})
                except (WireError, ConnectionError, EOFError, OSError):
                    pass  # a dead or desynced connection: drop it

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True
            # admission belongs to the batcher's queue, not the kernel's
            # listen backlog
            request_queue_size = 128

        self._server = Server(self._addr, Handler)
        self._addr = self._server.server_address
        if self.slo is not None:
            self.slo.name = self.endpoint
            self.slo.start()
            self._obs_registry.attach_slo(self.slo)
        self._flight_provider = "serving_%s" % \
            self.endpoint.replace(":", "_").replace(".", "-")
        flightrec.add_provider(self._flight_provider, self._flight_snapshot)
        if background:
            self._thread = threading.Thread(
                target=self._serve, daemon=True,
                name="paddle-tpu-torch-server-%d" % self._addr[1])
            self._thread.start()
        else:
            self._serve()
        return self

    @property
    def endpoint(self):
        return "%s:%d" % (self._addr[0], self._addr[1])

    def _serve(self):
        """The accept loop: it waits at most 0.2 s per turn and so sees
        `_stopped` promptly; the listening socket closes when it ends.
        No thread is ever left blocked in accept()."""
        self._server.timeout = 0.2
        with self._server:
            while not self._stopped:
                self._server.handle_request()

    def shutdown(self, drain=True, timeout=30.0):
        """Graceful stop: refuse new work, drain every queued request,
        then stop the accept loop and close the listening socket.
        Idempotent."""
        with self._shutdown_lock:
            if self._stopped and self._thread is None:
                return
            self._draining = True
            self.registry.close_all(drain=drain, timeout=timeout)
            self._stopped = True
            if self.slo is not None:
                self.slo.stop()
                self._obs_registry.detach_slo(self.slo)
            if getattr(self, "_flight_provider", None) is not None:
                flightrec.remove_provider(self._flight_provider)
                self._flight_provider = None
            self._obs_registry.detach_serving(self.metrics)
            t, self._thread = self._thread, None
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)

    # ------------------------------------------------------------------

    def _health_snapshot(self):
        """The `health` verb payload: per-model lane liveness and the SLO
        state."""
        h = {"draining": bool(self._draining),
             "accepting": not self._draining,
             "models": self.registry.health()}
        if self.slo is not None:
            h["slo"] = self.slo.state()
            h["slo_monitor"] = {"running": self.slo.running,
                                "interval_s": self.slo.interval_s}
        rec = flightrec.get_recorder()
        if rec is not None:
            h["flight"] = rec.stats()
        return h

    def _flight_snapshot(self):
        """Flight-recorder provider: this server at dump time (the
        bundle's serving_<endpoint>.json)."""
        snap = {"endpoint": self.endpoint,
                "stats": self.metrics.snapshot(),
                "describe": self.registry.describe(),
                "health": self._health_snapshot()}
        if self.slo is not None:
            snap["slo_timeline"] = self.slo.timeline()
        return snap

    def _dispatch(self, msg):
        cmd = msg.get("cmd")
        if cmd == "infer":
            return self._handle_infer(msg)
        if cmd == "stats":
            return {"ok": True, "stats": self.metrics.snapshot(),
                    "models": self.registry.describe()}
        if cmd == "health":
            return {"ok": True, "health": self._health_snapshot()}
        if cmd == "flight":
            # a bundle now (cooldown bypassed unless the caller asks
            # otherwise); None while the recorder is disabled
            path = flightrec.trigger(
                str(msg.get("reason") or "manual_rpc"),
                force=bool(msg.get("force", True)), endpoint=self.endpoint)
            return {"ok": True, "bundle": path,
                    "enabled": flightrec.get_recorder() is not None}
        if cmd == "metrics":
            return {"ok": True,
                    "text": self._obs_registry.prometheus_text()}
        if cmd == "trace":
            if msg.get("trace_id"):
                spans = obs_tracing.spans_for_trace(msg["trace_id"])
            else:
                spans = obs_tracing.recent_spans(
                    limit=int(msg.get("limit", 2048)),
                    kind=msg.get("kind") or None)
            return {"ok": True, "spans": spans,
                    "tracing": obs_tracing.stats()}
        if cmd == "load_model":
            return self._handle_load(msg)
        if cmd == "unload_model":
            self.registry.unload_model(msg["name"])
            return {"ok": True}
        if cmd == "drain":
            # stop ACCEPTING without stopping: in-flight requests and
            # streams run to completion; `resume` flips back
            self._draining = not msg.get("resume")
            return {"ok": True, "accepting": not self._draining,
                    "draining": bool(self._draining)}
        if cmd == "shutdown":
            threading.Thread(target=self.shutdown, daemon=True).start()
            return {"ok": True, "draining": True}
        if cmd == "exit":
            self._stopped = True
            return _CLOSE
        if cmd in _WAITING_VERBS:
            return {"error": "verb %r: %s is not ported to "
                             "paddle_tpu_torch yet (ROADMAP.md queue 1)"
                             % (cmd, _WAITING_VERBS[cmd]),
                    "code": "bad_request"}
        return {"error": "unknown cmd %r" % cmd, "code": "bad_request"}

    def _handle_load(self, msg):
        if self._draining:
            raise BatcherClosed("server is draining")
        if msg.get("fleet_policy"):
            raise ValueError(
                "load_model carried fleet_policy but the fleet controller "
                "is not ported to paddle_tpu_torch yet (ROADMAP.md "
                "queue 1)")
        entry = self.registry.load_model(
            msg["name"], msg["path"], version=msg.get("version"),
            buckets=msg.get("buckets") or self._default_buckets,
            replicas=msg.get("replicas"), devices=msg.get("devices"),
            decode_slots=msg.get("decode_slots"),
            decode_mode=msg.get("decode_mode"),
            precision=msg.get("precision"),
            ab_weight=msg.get("ab_weight"), draft=msg.get("draft"),
            spec_k=msg.get("spec_k"),
            kv_cache_dtype=msg.get("kv_cache_dtype"),
            fuse_steps=msg.get("fuse_steps"))
        reply = {"ok": True, "name": entry.name, "version": entry.version,
                 "buckets": list(entry.predictor.batch_buckets()),
                 "replicas": len(entry.replicas),
                 "devices": entry.device_labels(),
                 "precision": entry.precision}
        if entry.is_decode:
            reply["decode"] = True
            reply["decode_slots"] = entry.batcher.n_slots
            reply["max_seq_len"] = entry.predictor.max_seq_len
            reply["eos_id"] = entry.predictor.eos_id
            reply["kv_cache_dtype"] = str(entry.predictor.kv_cache_dtype)
            reply["fuse_steps"] = int(entry.batcher.fuse_steps)
            if entry.batcher.spec_k:
                reply["spec_k"] = entry.batcher.spec_k
                reply["draft"] = entry.draft_path
        return reply

    def _handle_infer(self, msg):
        name = msg["model"]
        feeds = msg["feeds"]
        if not isinstance(feeds, dict) or not feeds:
            raise ValueError("infer needs a non-empty feeds dict")
        if self._draining:
            raise ServerOverloaded("server is draining — request refused")
        trace_id = str(msg.get("trace_id") or obs_tracing.new_trace_id())
        deadline_ms = msg.get("deadline_ms")
        deadline = None
        wait = 120.0  # never park a handler thread forever
        if deadline_ms is not None:
            deadline = time.monotonic() + float(deadline_ms) / 1000.0
            wait = float(deadline_ms) / 1000.0 + 5.0
        with obs_tracing.trace("serving/rpc", kind="serving",
                               trace_id=trace_id, model=name):
            future = self.registry.submit(
                name, feeds, version=msg.get("version"),
                deadline=deadline, priority=int(msg.get("priority", 0)),
                trace_id=trace_id,
                max_new_tokens=msg.get("max_new_tokens"),
                precision=msg.get("precision"))
            try:
                fetches = future.result(timeout=wait)
            except DeadlineExceeded:
                raise
            except TimeoutError:
                raise DeadlineExceeded(
                    "request did not complete within its %.0f ms "
                    "deadline" % (deadline_ms if deadline_ms is not None
                                  else wait * 1e3))
        reply = {"ok": True, "trace_id": trace_id,
                 "fetches": [np.ascontiguousarray(a) for a in fetches]}
        if getattr(future, "finish_reason", None):
            # a decode model through the one-shot verb: the whole greedy
            # stream is fetches[0], plus why it ended
            reply["finish_reason"] = str(future.finish_reason)
        if msg.get("debug"):
            reply["debug"] = dict(getattr(future, "obs_info", None)
                                  or {"trace_id": trace_id})
        return reply

    def _handle_infer_stream(self, msg, sock):
        """Chunked streaming generation: {"chunk": True, "seq": i,
        "tokens": [...], "trace_id"} frames as the lane emits them, then
        exactly one terminal frame ({"ok": True, "done": True,
        "finish_reason", "new_tokens", "trace_id"} or {"error", "code",
        "done": True, ...}).  A dead client connection cancels the
        stream, so its slot frees (and zeroes) within one dispatch."""
        trace_id = str(msg.get("trace_id") or obs_tracing.new_trace_id())
        stream = None
        try:
            if self._draining:
                raise ServerOverloaded(
                    "server is draining — request refused")
            tokens = msg.get("tokens")
            if tokens is None:
                raise ValueError(
                    "infer_stream needs a 'tokens' prompt array")
            deadline_ms = msg.get("deadline_ms")
            deadline = None
            if deadline_ms is not None:
                deadline = time.monotonic() + float(deadline_ms) / 1000.0
            stream = self.registry.submit_stream(
                msg["model"], tokens, version=msg.get("version"),
                max_new_tokens=msg.get("max_new_tokens"),
                deadline=deadline, priority=int(msg.get("priority", 0)),
                trace_id=trace_id,
                chunk_tokens=msg.get("stream_chunk_tokens"))
        except BaseException as e:
            reply = _error_reply(e)
            reply["done"] = True
            reply["trace_id"] = trace_id
            _send_msg(sock, reply)
            return
        seq = 0
        try:
            for kind, payload in stream.events():
                if kind == "tokens":
                    _send_msg(sock, {"chunk": True, "seq": seq,
                                     "tokens": [int(t) for t in payload],
                                     "trace_id": trace_id})
                    seq += 1
                elif kind == "error":
                    reply = _error_reply(payload)
                    reply["done"] = True
                    reply["trace_id"] = trace_id
                    reply["new_tokens"] = len(stream.tokens)
                    _send_msg(sock, reply)
                else:
                    final = {"ok": True, "done": True,
                             "trace_id": trace_id,
                             "finish_reason": str(payload),
                             "new_tokens": len(stream.tokens)}
                    if msg.get("debug"):
                        final["debug"] = dict(stream.obs_info
                                              or {"trace_id": trace_id})
                    _send_msg(sock, final)
        except (ConnectionError, EOFError, OSError, WireError):
            # the client went away mid-stream: evict the request so its
            # slot is reclaimed for waiting traffic
            stream.cancel()
            raise


class ServingClient:
    """Wire client for InferenceServer (either package's).  Connections
    are thread-local: one socket per (thread, endpoint), a blocking
    round-trip per call.

    `infer` semantics: with a deadline, shed ("overloaded") replies and
    connection failures are retried under the jittered-backoff
    RetryPolicy until the deadline; without one, a shed surfaces at once
    as ServerOverloaded so the caller owns the policy."""

    def __init__(self, endpoint, deadline_ms=None, retry_policy=None):
        self.endpoint = endpoint
        self.deadline_ms = deadline_ms
        self.last_trace_id = None
        self.last_stream_info = None  # final infer_stream frame metadata
        self._policy = retry_policy
        self._tls = threading.local()

    def _connect(self):
        host, port = self.endpoint.rsplit(":", 1)
        s = socket.create_connection((host, int(port)),
                                     timeout=FLAGS.rpc_deadline)
        _no_delay(s)
        return s

    def _conn(self):
        s = getattr(self._tls, "sock", None)
        if s is None:
            s = self._tls.sock = self._connect()
        return s

    def _drop_conn(self):
        s = getattr(self._tls, "sock", None)
        self._tls.sock = None
        if s is not None:
            try:
                s.close()
            except OSError:
                pass

    def _call_once(self, msg):
        s = self._conn()
        try:
            _send_msg(s, msg)
            reply = _recv_msg(s)
        except (ConnectionError, EOFError, OSError, WireError):
            self._drop_conn()
            raise
        if "error" in reply:
            code = reply.get("code")
            if code == "overloaded":
                raise ServerOverloaded(reply["error"],
                                       priority=reply.get("shed_priority"))
            if code == "deadline":
                raise DeadlineExceeded(reply["error"])
            err = ServingError("%s (code=%s)" % (reply["error"], code))
            err.code = code
            raise err
        return reply

    def call(self, msg):
        """One-shot forward of a raw verb dict, with no retry policy."""
        return self._call_once(dict(msg))

    def _call(self, msg, retry_deadline=None, retry_on=()):
        if retry_deadline is None:
            return self._call_once(msg)
        from ..utils.retry import default_rpc_policy
        policy = self._policy or default_rpc_policy(
            max_attempts=1 << 20, max_delay=0.5)
        return policy.call(
            lambda: self._call_once(msg),
            retry_on=(ConnectionError, OSError, EOFError) + tuple(retry_on),
            on_retry=lambda e, attempt: self._drop_conn()
            if isinstance(e, (ConnectionError, OSError, EOFError))
            else None,
            deadline=retry_deadline)

    def infer_stream(self, model, tokens, max_new_tokens=None,
                     deadline_ms=None, version=None, priority=None,
                     trace_id=None, chunk_tokens=None, debug=False):
        """Streaming generation: an iterator yielding token-delta lists as
        the server decodes them.  The final frame's metadata lands on
        ``self.last_stream_info`` (finish_reason, new_tokens, trace_id,
        and the server's stage timings with ``debug=True``).  A
        mid-stream error raises its typed exception at the point of
        failure; tokens already yielded are real.  Closing the iterator
        early drops the connection, which evicts the request from its
        decode slot.  The stream uses a connection of its own."""
        msg = {"cmd": "infer_stream", "model": model,
               "tokens": np.ascontiguousarray(
                   np.asarray(tokens, np.int32))}
        if max_new_tokens is not None:
            msg["max_new_tokens"] = int(max_new_tokens)
        if deadline_ms is not None:
            msg["deadline_ms"] = float(deadline_ms)
        if version is not None:
            msg["version"] = version
        if priority is not None:
            msg["priority"] = int(priority)
        if trace_id is not None:
            msg["trace_id"] = str(trace_id)
        if chunk_tokens is not None:
            msg["stream_chunk_tokens"] = int(chunk_tokens)
        if debug:
            msg["debug"] = True
        self.last_stream_info = None

        def _gen():
            s = self._connect()
            received = 0  # tokens already yielded: committed output
            try:
                try:
                    _send_msg(s, msg)
                except (ConnectionError, EOFError, OSError,
                        WireError) as e:
                    raise StreamBroken(
                        "stream to %s broke before placement: %s"
                        % (self.endpoint, e),
                        trace_id=msg.get("trace_id"), received=0)
                while True:
                    try:
                        reply = _recv_msg(s)
                    except (ConnectionError, EOFError, OSError,
                            WireError) as e:
                        self.last_stream_info = {
                            "code": "stream_broken",
                            "new_tokens": received,
                            "trace_id": msg.get("trace_id")}
                        raise StreamBroken(
                            "stream to %s broke after %d token(s): %s"
                            % (self.endpoint, received, e),
                            trace_id=msg.get("trace_id"),
                            received=received)
                    if "error" in reply:
                        self.last_stream_info = {
                            k: reply[k] for k in
                            ("trace_id", "new_tokens", "code", "backend")
                            if k in reply}
                        self.last_trace_id = reply.get("trace_id")
                        code = reply.get("code")
                        if code == "overloaded":
                            raise ServerOverloaded(
                                reply["error"],
                                priority=reply.get("shed_priority"))
                        if code == "deadline":
                            raise DeadlineExceeded(reply["error"])
                        if code == "stream_broken":
                            raise StreamBroken(
                                reply["error"],
                                trace_id=reply.get("trace_id"),
                                received=received,
                                backend=reply.get("backend"))
                        err = ServingError("%s (code=%s)"
                                           % (reply["error"], code))
                        err.code = code
                        raise err
                    if reply.get("chunk"):
                        toks = [int(t) for t in reply["tokens"]]
                        received += len(toks)
                        yield toks
                        continue
                    self.last_stream_info = {
                        k: v for k, v in reply.items() if k != "ok"}
                    self.last_trace_id = reply.get("trace_id")
                    return
            finally:
                # any exit, an early close included: this connection
                # carries nothing else, and a dropped socket is the
                # eviction signal for an abandoned stream
                try:
                    s.close()
                except OSError:
                    pass

        return _gen()

    def infer(self, model, feeds, deadline_ms=None, version=None,
              retry_sheds=None, priority=None, debug=False,
              trace_id=None, max_new_tokens=None, precision=None):
        """Run one request.  Returns the fetch list; with ``debug=True``
        ``(fetches, info)``, `info` the server-measured latency
        attribution (trace_id, queue_wait_ms, compute_ms, batch_fill,
        replica ...).  `precision` pins the request to one numerics lane
        ('fp32' / 'int8')."""
        deadline_ms = self.deadline_ms if deadline_ms is None \
            else deadline_ms
        msg = {"cmd": "infer", "model": model,
               "feeds": {k: np.ascontiguousarray(np.asarray(v))
                         for k, v in feeds.items()}}
        if version is not None:
            msg["version"] = version
        if precision is not None:
            msg["precision"] = str(precision)
        if max_new_tokens is not None:
            msg["max_new_tokens"] = int(max_new_tokens)
        if priority is not None:
            msg["priority"] = int(priority)
        if debug:
            msg["debug"] = True
        if trace_id is not None:
            msg["trace_id"] = str(trace_id)
        retry_deadline = None
        retry_on = ()
        if deadline_ms is not None:
            msg["deadline_ms"] = float(deadline_ms)
            retry_deadline = time.monotonic() + float(deadline_ms) / 1000.0
            if retry_sheds is None or retry_sheds:
                retry_on = (ServerOverloaded,)
        elif retry_sheds:
            raise ValueError("retry_sheds needs a deadline_ms to bound it")
        reply = self._call(msg, retry_deadline=retry_deadline,
                           retry_on=retry_on)
        self.last_trace_id = reply.get("trace_id")
        fetches = list(reply["fetches"])
        if debug:
            return fetches, dict(reply.get("debug") or {})
        return fetches

    def load_model(self, name, path, version=None, buckets=None,
                   replicas=None, devices=None, decode_slots=None,
                   decode_mode=None, precision=None, ab_weight=None,
                   draft=None, spec_k=None, kv_cache_dtype=None,
                   fuse_steps=None):
        """Load or hot-swap `path` as `name` on the server (its keyword
        arguments are ModelRegistry.load_model's)."""
        msg = {"cmd": "load_model", "name": name, "path": path}
        if kv_cache_dtype is not None:
            msg["kv_cache_dtype"] = str(kv_cache_dtype)
        if draft is not None:
            msg["draft"] = str(draft)
        if spec_k is not None:
            msg["spec_k"] = int(spec_k)
        if fuse_steps is not None:
            msg["fuse_steps"] = int(fuse_steps)
        if version is not None:
            msg["version"] = version
        if precision is not None:
            msg["precision"] = str(precision)
        if ab_weight is not None:
            msg["ab_weight"] = float(ab_weight)
        if buckets is not None:
            msg["buckets"] = [int(b) for b in buckets]
        if replicas is not None:
            msg["replicas"] = replicas if isinstance(replicas, str) \
                else int(replicas)
        if devices is not None:
            msg["devices"] = [str(d) for d in devices]
        if decode_slots is not None:
            msg["decode_slots"] = int(decode_slots)
        if decode_mode is not None:
            msg["decode_mode"] = str(decode_mode)
        return self._call(msg)

    def unload_model(self, name):
        return self._call({"cmd": "unload_model", "name": name})

    def drain(self, resume=False):
        """Flip the server out of (or with ``resume=True`` back into) the
        accepting state: in-flight work finishes, new admissions refuse."""
        return self._call({"cmd": "drain", "resume": bool(resume)})

    def stats(self):
        return self._call({"cmd": "stats"})

    def health(self):
        """The `health` verb's payload: {"draining", "accepting",
        "models": {...}, "slo": {...}, ...}."""
        return self._call({"cmd": "health"})["health"]

    def flight(self, reason="manual_rpc", force=True):
        """Commit a flight-recorder bundle on the server; returns its
        path, or None while the server's FLAGS.flight_dir is unset."""
        return self._call({"cmd": "flight", "reason": str(reason),
                           "force": bool(force)}).get("bundle")

    def metrics_text(self):
        """The server's Prometheus-style exposition."""
        return self._call({"cmd": "metrics"})["text"]

    def trace(self, trace_id=None, limit=2048, kind=None):
        """Span-ring readout: all spans of one trace_id, or the most
        recent `limit` (optionally of one kind)."""
        msg = {"cmd": "trace", "limit": int(limit)}
        if trace_id is not None:
            msg["trace_id"] = str(trace_id)
        if kind is not None:
            msg["kind"] = str(kind)
        return self._call(msg)

    def shutdown_server(self, drain=True):
        try:
            return self._call({"cmd": "shutdown", "drain": bool(drain)})
        except (ConnectionError, OSError, EOFError):
            return None

    def close(self):
        self._drop_conn()
