"""paddle_tpu_torch's obs/ (span ring, event log, metrics registry, SLO
monitor), its flags' environment ingestion, the retry policy and the
wire framing, held against the JAX package's modules on the same inputs:
the same span records, the same event records, the same Prometheus text
for the same counter values, the same SLO transitions, the same retry
delays and byte-equal frames."""

import json
import os
import random
import signal
import socket
import subprocess
import sys

import pytest

from paddle_tpu.distributed import rpc as jrpc
from paddle_tpu.obs import events as jevents
from paddle_tpu.obs import registry as jregistry
from paddle_tpu.obs import slo as jslo
from paddle_tpu.obs import tracing as jtracing
from paddle_tpu.serving import metrics as jmetrics
from paddle_tpu.utils import retry as jretry
from paddle_tpu_torch.distributed import rpc as trpc
from paddle_tpu_torch.flags import FLAGS, parse_flag
from paddle_tpu_torch.obs import events as tevents
from paddle_tpu_torch.obs import registry as tregistry
from paddle_tpu_torch.obs import slo as tslo
from paddle_tpu_torch.obs import tracing as ttracing
from paddle_tpu_torch.serving import metrics as tmetrics
from paddle_tpu_torch.utils import retry as tretry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_TIMEOUT_S = 60


@pytest.fixture(autouse=True)
def _per_test_timeout():
    def _expired(signum, frame):
        raise TimeoutError("test exceeded %d s" % TEST_TIMEOUT_S)
    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(TEST_TIMEOUT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _strip(d):
    """A span or event dict without its clock and thread fields."""
    return {k: v for k, v in d.items() if k not in ("ts", "dur_ms")}


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mod", [jtracing, ttracing], ids=["jax", "torch"])
def test_ring_wraps_and_counts_drops(mod):
    mod.configure(enabled=True, capacity=4)
    try:
        mod.clear()
        for i in range(6):
            mod.add_span(mod.Span("s%d" % i, kind="t"))
        assert [s["name"] for s in mod.recent_spans()] == \
            ["s2", "s3", "s4", "s5"]
        st = mod.stats()
        assert (st["capacity"], st["buffered"], st["spans_total"],
                st["dropped"]) == (4, 4, 6, 2)
    finally:
        mod.configure(capacity=4096)
        mod.clear()


def _drive_spans(mod):
    """One fixed sequence of spans through a package's tracer."""
    mod.configure(enabled=True, capacity=64)
    mod.clear()
    mod.add_span(mod.Span("serving/queue_wait", kind="serving",
                          trace_id="t1", ts=1.0, dur_ms=2.5,
                          attrs={"model": "m", "replica": 0}))
    with mod.trace("serving/rpc", kind="serving", trace_id="t1",
                   model="m"):
        pass
    with pytest.raises(KeyError):
        with mod.trace("serving/compute", kind="serving", trace_id="t2",
                       rows=3):
            raise KeyError("boom")
    mod.set_enabled(False)
    with mod.trace("ignored", kind="serving"):
        pass
    mod.set_enabled(True)
    out = ([_strip(s) for s in mod.recent_spans()],
           [_strip(s) for s in mod.spans_for_trace("t1")],
           [_strip(s) for s in mod.recent_spans(kind="serving", limit=1)],
           {k: v for k, v in mod.stats().items() if k != "capacity"})
    mod.configure(capacity=4096)
    mod.clear()
    return out


def test_spans_match_jax():
    assert _drive_spans(ttracing) == _drive_spans(jtracing)
    a, b = ttracing.new_trace_id(), ttracing.new_trace_id()
    assert a != b and len(a) == 16 and int(a, 16) >= 0


# ---------------------------------------------------------------------------
# events
# ---------------------------------------------------------------------------

def _drive_events(mod, path):
    log = mod.EventLog(path=path, max_bytes=1 << 20, ring=3)
    log.emit("shed", model="m", priority=1, trace_id="abc", queue=4)
    log.emit("hot_swap", model="m", version=2, from_version=None,
             precision="fp32", replicas=1)
    log.emit("slow", model="m", total_ms=12.5, obj=[1, 2])
    log.emit("deadline_expired", model="m", waited_ms=3.25)
    log.close()
    with open(path) as f:
        lines = [_strip(json.loads(ln)) for ln in f]
    return ([_strip(e) for e in log.recent()], lines,
            {k: v for k, v in log.stats().items()})


def test_events_match_jax(tmp_path):
    t = _drive_events(tevents, str(tmp_path / "t.jsonl"))
    j = _drive_events(jevents, str(tmp_path / "j.jsonl"))
    assert t == j
    assert t[2]["dropped"] == 1 and t[2]["sink"] == "ok"


def test_event_log_rotates_and_never_raises(tmp_path):
    path = str(tmp_path / "ev" / "log.jsonl")
    log = tevents.EventLog(path=path, max_bytes=200)
    for i in range(20):
        log.emit("tick", i=i)
    log.close()
    assert log.stats()["rotations"] >= 1
    assert os.path.exists(path + ".1")
    bad = tevents.EventLog(path=str(tmp_path / "no" / "\0bad"))
    with pytest.warns(UserWarning):
        bad.emit("x")
    assert bad.stats()["sink_dead"] and bad.recent()[-1]["kind"] == "x"


# ---------------------------------------------------------------------------
# serving metrics and the Prometheus text
# ---------------------------------------------------------------------------

def _drive_metrics(mod):
    sm = mod.ServingMetrics()
    m = sm.model("m")
    q = sm.model("m", "int8")
    d = sm.model("lm")
    rng = random.Random(5)
    for i in range(40):
        m.requests.add()
        m.note_completion(latency_ms=rng.uniform(1, 50),
                          queue_wait_ms=rng.uniform(0, 5))
        if i % 4 == 0:
            m.note_dispatch(n_requests=4, real_rows=4, padded_rows=4)
    m.note_shed(priority=0)
    m.note_shed(priority=2)
    m.errors.add(3)
    m.deadline_expired.add()
    q.requests.add(2)
    q.note_completion(latency_ms=7.0)
    d.streams.add(3)
    d.requests.add(3)
    for i in range(5):
        d.note_prefill(ttft_ms=10.0 + i)
        d.note_tokens(4)
        d.note_decode_dispatch(4)
        d.decode_steps.add(4)
    d.note_spec(8, 6)
    d.spec_degraded.add()
    d.slot_occupancy_fn = lambda: (3, 8)
    d.kv_cache_fn = lambda: ("int8", 4096)
    m.queue_depth_fn = lambda: 2
    m.replica_stats_fn = lambda: [{"replica": 0, "device": "cpu:0",
                                   "mesh": 1, "dead": None, "tp": False,
                                   "dispatch_ms": 1.0, "inflight": 0,
                                   "queue": 0, "batches": 10, "rows": 40}]
    return sm


# keys whose values are times (uptime, rates per second) or subsystems
# the port does not have yet (the compile cache)
_CLOCK_KEYS = ("uptime_sec", "qps_recent", "qps_lifetime",
               "tokens_per_sec", "compile_cache")


def _no_clock(snap):
    if isinstance(snap, dict):
        return {k: _no_clock(v) for k, v in snap.items()
                if k not in _CLOCK_KEYS}
    return snap


def test_serving_metrics_snapshot_matches_jax():
    t = _no_clock(_drive_metrics(tmetrics).snapshot())
    j = _no_clock(_drive_metrics(jmetrics).snapshot())
    assert t == j


def _serving_lines(mod, sm):
    reg = mod.MetricsRegistry()
    reg.attach_serving(sm)
    text = reg.prometheus_text()
    return [ln for ln in text.splitlines()
            if "serving_" in ln and "compile_cache" not in ln
            and "qps_" not in ln and "tokens_per_sec" not in ln]


def test_prometheus_text_matches_jax():
    t = _serving_lines(tregistry, _drive_metrics(tmetrics))
    j = _serving_lines(jregistry, _drive_metrics(jmetrics))
    assert t == j
    assert 'paddle_tpu_serving_requests_total{model="m"} 40' in t
    assert any('precision="int8"' in ln for ln in t)
    assert any(ln.startswith("# TYPE paddle_tpu_serving_ttft_ms summary")
               for ln in t)


def test_registry_span_aggregates():
    reg = tregistry.MetricsRegistry()
    reg.note_span(ttracing.Span("serving/compute", kind="serving",
                                dur_ms=2.0))
    reg.note_span(ttracing.Span("serving/compute", kind="serving",
                                dur_ms=3.0))
    text = reg.prometheus_text()
    assert ('paddle_tpu_span_count_total{kind="serving",'
            'span="serving/compute"} 2') in text
    assert ('paddle_tpu_span_ms_total{kind="serving",'
            'span="serving/compute"} 5.0') in text
    assert reg.span_totals()[("serving", "serving/compute")] == \
        {"count": 2, "total_ms": 5.0}


# ---------------------------------------------------------------------------
# SLO monitor
# ---------------------------------------------------------------------------

def test_slo_spec_parses_like_jax():
    spec = ("p95_ms=250,error_rate=0.01;llm:ttft_p95_ms=400,"
            "spec_accept=0.5,fast_window=3")
    t, j = tslo.parse_slo_spec(spec), jslo.parse_slo_spec(spec)
    assert {k: v.to_dict() for k, v in t.items()} == \
        {k: v.to_dict() for k, v in j.items()}
    for mod in (tslo, jslo):
        with pytest.raises(ValueError):
            mod.parse_slo_spec("bogus=1")


def _slo_timeline(slo_mod, metrics_mod):
    """A hard error burst then recovery through a monitor stepped by
    hand; (transition kinds, final state without clock fields)."""
    sm = metrics_mod.ServingMetrics()
    m = sm.model("m")
    mon = slo_mod.SLOMonitor(
        sm, slos={"m": slo_mod.SLO(error_rate=0.1, fast_window=3,
                                   breach_evals=2, recover_evals=2)},
        interval_s=1.0)
    kinds = []
    for tick in range(12):
        bad = 3 <= tick < 7
        m.requests.add(10)
        if bad:
            m.errors.add(10)
        else:
            m.responses.add(10)
        kinds += [k for k, _ in mon.tick()]
    state = mon.state()["m"]
    state.pop("last_sample_age_s")
    return kinds, state, sorted(mon.export())


def test_slo_monitor_matches_jax():
    t = _slo_timeline(tslo, tmetrics)
    j = _slo_timeline(jslo, jmetrics)
    assert t == j
    assert t[0] == ["slo_degraded", "slo_breach", "slo_recovered"]


# ---------------------------------------------------------------------------
# flags, retry, wire framing
# ---------------------------------------------------------------------------

def test_flags_have_the_jax_names_and_defaults():
    from paddle_tpu.flags import FLAGS as JFLAGS
    for name in ("serving_batch_deadline_ms", "serving_workers",
                 "serving_lane_depth", "trace", "trace_buffer_events",
                 "trace_slow_ms", "event_log", "event_log_max_kb",
                 "slo_monitor", "slo_eval_interval_ms", "serving_slo",
                 "serving_replicas", "serving_spec_draft", "rpc_deadline",
                 "rpc_retry_times", "rpc_retry_backoff",
                 "fleet_controller", "federation_frontend"):
        assert getattr(FLAGS, name) == getattr(JFLAGS, name), name
    assert parse_flag("x", "on", False) is True
    assert parse_flag("x", "0", True) is False
    assert parse_flag("x", "7", 1) == 7
    assert parse_flag("x", "2.5", 1.0) == 2.5
    with pytest.raises(ValueError):
        parse_flag("x", "maybe", False)


def test_flags_read_the_environment():
    env = dict(os.environ, FLAGS_serving_workers="3", FLAGS_trace="off",
               FLAGS_serving_slo="p95_ms=5",
               PYTHONPATH=REPO + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-c",
         "from paddle_tpu_torch.flags import FLAGS; "
         "from paddle_tpu_torch.obs import tracing; "
         "print(FLAGS.serving_workers, FLAGS.trace, FLAGS.serving_slo, "
         "tracing.enabled())"],
        env=env, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["3", "False", "p95_ms=5", "False"]


def test_retry_policy_matches_jax():
    kw = dict(max_attempts=6, base_delay=0.05, max_delay=0.3)
    t = list(tretry.RetryPolicy(rng=random.Random(3), **kw).delays())
    j = list(jretry.RetryPolicy(rng=random.Random(3), **kw).delays())
    assert t == j and len(t) == 5
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("down")
        return "up"
    pol = tretry.RetryPolicy(max_attempts=5, sleep=lambda s: None)
    assert pol.call(flaky, retry_on=(ConnectionError,)) == "up"
    assert len(calls) == 3
    assert tretry.default_rpc_policy().max_attempts == FLAGS.rpc_retry_times


def _frame(send, msg):
    a, b = socket.socketpair()
    try:
        send(a, msg)
        a.shutdown(socket.SHUT_WR)
        out = b""
        while True:
            chunk = b.recv(65536)
            if not chunk:
                return out
            out += chunk
    finally:
        a.close()
        b.close()


def test_frames_are_byte_equal_and_cross_decode():
    import numpy as np
    msg = {"cmd": "infer", "model": "m", "priority": 2,
           "feeds": {"x": np.arange(12, dtype=np.float32).reshape(3, 4)},
           "deadline_ms": 50.0, "debug": True, "ids": [1, "a", None]}
    t = _frame(trpc._send_msg, msg)
    assert t == _frame(jrpc._send_msg, msg)
    a, b = socket.socketpair()
    try:
        a.sendall(t)
        got = jrpc._recv_msg(b)
        assert got["model"] == "m" and got["feeds"]["x"].shape == (3, 4)
        a.sendall(_frame(jrpc._send_msg, [1, 2]))
        with pytest.raises(trpc.WireError):
            trpc._recv_msg(b)
    finally:
        a.close()
        b.close()
