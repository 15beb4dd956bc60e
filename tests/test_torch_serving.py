"""paddle_tpu_torch's serving front end for one-shot models on the CPU:
the DynamicBatcher, the ModelRegistry and the InferenceServer /
ServingClient over the wire, held against the JAX package.

Artifacts are exported by the JAX package's fluid, so both packages load
the same directory.  Every batch pads to ONE bucket (8), so a coalesced
dispatch and a direct `Predictor.run` compute the same shape and the
replies are bit-equal; against the JAX Predictor they agree within
rtol 1e-5 / atol 1e-6.  The overload scenario (shed, priority eviction,
deadline expiry) runs through both packages' batchers and must end the
same way, with the same events.  The JAX client talks to the port's
server and the port's client to the JAX server.  Every socket binds
port 0; every test runs under a per-test alarm."""

import signal
import socket
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu.serving as jserving
from paddle_tpu.inference import AnalysisConfig as JConfig
from paddle_tpu.inference import Predictor as JPredictor
from paddle_tpu.obs import events as jevents
from paddle_tpu.obs import tracing as jtracing
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.flags import FLAGS
from paddle_tpu_torch.inference import AnalysisConfig, Predictor
from paddle_tpu_torch.inference import quantize_inference_model
from paddle_tpu_torch.obs import events as tevents
from paddle_tpu_torch.obs import tracing as ttracing

TEST_TIMEOUT_S = 90
BUCKETS = (8,)
RTOL, ATOL = 1e-5, 1e-6
# reply keys of subsystems the port does not have yet: the compile cache
# and the resource estimates of the admission fit check (analysis/)
WAITING_KEYS = {"compile_cache", "est_peak_mb", "est_flops"}


@pytest.fixture(autouse=True)
def _per_test_timeout():
    def _expired(signum, frame):
        raise TimeoutError("test exceeded %d s" % TEST_TIMEOUT_S)
    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(TEST_TIMEOUT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)
    tserving.set_dispatch_delay(0.0)
    jserving.set_dispatch_delay(0.0)


@pytest.fixture(autouse=True, scope="module")
def _settings():
    """The JAX compile cache off (these tests measure serving, not the
    store), short client socket timeouts, no SLO monitor thread."""
    jold = jfluid.get_flags(["compile_cache", "rpc_deadline",
                             "slo_monitor"])
    jfluid.set_flags({"compile_cache": False, "rpc_deadline": 30.0,
                      "slo_monitor": False})
    old = (FLAGS.rpc_deadline, FLAGS.slo_monitor)
    FLAGS.rpc_deadline, FLAGS.slo_monitor = 30.0, False
    yield
    FLAGS.rpc_deadline, FLAGS.slo_monitor = old
    jfluid.set_flags(jold)


def _export_fc(path, seed, with_aux=False):
    """A tiny fc model exported by the JAX package; returns its dir."""
    main, startup = jfluid.Program(), jfluid.Program()
    main.random_seed = startup.random_seed = seed
    with jfluid.program_guard(main, startup):
        x = jfluid.layers.data(name="x", shape=[4], dtype="float32")
        feeds = ["x"]
        h = jfluid.layers.fc(input=x, size=6, act="relu")
        if with_aux:
            aux = jfluid.layers.data(name="aux", shape=[6],
                                     dtype="float32",
                                     append_batch_size=False)
            h = jfluid.layers.elementwise_add(h, aux, axis=-1)
            feeds.append("aux")
        pred = jfluid.layers.fc(input=h, size=6, act="softmax")
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        jfluid.save_inference_model(path, feeds, [pred], exe,
                                    main_program=main)
    return path


@pytest.fixture(scope="module")
def arts(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_serving")
    out = {"m": _export_fc(str(d / "m"), 3),
           "m2": _export_fc(str(d / "m2"), 4),
           "aux": _export_fc(str(d / "aux"), 5, with_aux=True)}
    old = FLAGS.quantize_min_weight_elems
    FLAGS.quantize_min_weight_elems = 16
    try:
        rng = np.random.RandomState(1)
        calib = [{"x": rng.randn(8, 4).astype(np.float32)}
                 for _ in range(2)]
        out["m_int8"] = quantize_inference_model(
            out["m"], calib_feeds=calib, place=tfluid.CPUPlace())["dst"]
    finally:
        FLAGS.quantize_min_weight_elems = old
    return out


def _direct(path):
    cfg = AnalysisConfig(path, device="cpu")
    cfg.batch_size_buckets = BUCKETS
    return Predictor(cfg)


def _jax_direct(path):
    cfg = JConfig(model_dir=path)
    cfg.batch_size_buckets = BUCKETS
    return JPredictor(cfg)


def _rows(n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(1 + i % 2, 4).astype(np.float32) for i in range(n)]


def _server(**kw):
    return tserving.InferenceServer("127.0.0.1:0", replicas="cpu",
                                    buckets=list(BUCKETS), **kw).start()


# ---------------------------------------------------------------------------
# DynamicBatcher
# ---------------------------------------------------------------------------

def test_coalesces_bit_equal_to_direct_and_close_to_jax(arts):
    direct, jdirect = _direct(arts["m"]), _jax_direct(arts["m"])
    metrics = tserving.ServingMetrics().model("m")
    b = tserving.DynamicBatcher(_direct(arts["m"]), max_queue=64,
                                deadline_ms=50, metrics=metrics)
    xs = _rows(12, 0)
    try:
        futs = [b.submit({"x": x}) for x in xs]
        outs = [f.result(timeout=30) for f in futs]
    finally:
        b.close()
    snap = metrics.snapshot()
    assert snap["responses"] == 12
    assert 1 <= snap["dispatches"] < 12 and snap["batch_fill"] > 1
    for x, out in zip(xs, outs):
        np.testing.assert_array_equal(out[0], direct.run({"x": x})[0])
        np.testing.assert_allclose(out[0], jdirect.run({"x": x})[0],
                                   rtol=RTOL, atol=ATOL)
    assert all(f.obs_info["batch_rows"] >= 1 for f in futs)


def test_side_feeds_coalesce_only_when_byte_equal(arts):
    direct = _direct(arts["aux"])
    auxes = [np.full((6,), v, np.float32) for v in (0.0, 1.0)]
    metrics = tserving.ServingMetrics().model("aux")
    b = tserving.DynamicBatcher(_direct(arts["aux"]), deadline_ms=50,
                                metrics=metrics)
    xs = _rows(8, 1)
    try:
        futs = [b.submit({"x": x, "aux": auxes[i % 2]})
                for i, x in enumerate(xs)]
        outs = [f.result(timeout=30) for f in futs]
    finally:
        b.close()
    for i, (x, out) in enumerate(zip(xs, outs)):
        np.testing.assert_array_equal(
            out[0], direct.run({"x": x, "aux": auxes[i % 2]})[0])
    snap = metrics.snapshot()
    assert 2 <= snap["dispatches"] < 8
    with pytest.raises(ValueError, match="largest servable bucket"):
        b2 = tserving.DynamicBatcher(_direct(arts["m"]))
        try:
            b2.submit({"x": np.zeros((9, 4), np.float32)})
        finally:
            b2.close()


def _wait_for(cond, timeout=30.0):
    """Poll until cond() holds (the lane has picked work up)."""
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out waiting"
        time.sleep(0.005)


def _overload(pkg, evmod, make_pred):
    """One lane held 0.4 s per dispatch, a queue of 2: two priority-0
    arrivals fill the queue behind the first dispatch, a priority-1
    arrival evicts the earlier of them, a further priority-0 arrival is
    shed, and the queued request with a 50 ms deadline expires.  Returns the outcome of
    each request, the events' kinds with their keys, and the counters."""
    evmod.configure(path="")
    metrics = pkg.ServingMetrics().model("m")
    b = pkg.DynamicBatcher(make_pred(), max_queue=2, deadline_ms=0,
                           metrics=metrics)
    x = np.ones((1, 4), np.float32)
    try:
        b.submit({"x": x}).result(timeout=30)   # warm
        pkg.set_dispatch_delay(0.4)
        first = b.submit({"x": x})
        _wait_for(lambda: b.replica_stats()[0]["inflight"] == 1)
        low = b.submit({"x": x}, priority=0)
        late = b.submit({"x": x}, deadline=time.monotonic() + 0.05)
        high = b.submit({"x": x}, priority=1)   # evicts `low`, the first
        try:
            b.submit({"x": x}, priority=0)
            shed = "admitted"
        except pkg.ServerOverloaded as e:
            shed = "shed p%d" % e.priority

        def outcome(f):
            try:
                f.result(timeout=30)
                return "ok"
            except Exception as e:
                return type(e).__name__
        outs = [outcome(f) for f in (first, late, low, high)] + [shed]
    finally:
        pkg.set_dispatch_delay(0.0)
        b.close()
    evs = [(e["kind"], sorted(k for k in e if k not in ("ts",)))
           for e in evmod.recent_events()
           if e["kind"] in ("shed", "deadline_expired")]
    snap = metrics.snapshot()
    counters = {k: snap[k] for k in ("requests", "responses", "errors",
                                     "shed", "deadline_expired")}
    return outs, evs, counters, snap.get("shed_by_priority")


def test_overload_sheds_and_expires_like_jax(arts):
    t = _overload(tserving, tevents, lambda: _direct(arts["m"]))
    j = _overload(jserving, jevents, lambda: _jax_direct(arts["m"]))
    assert t == j
    outs = t[0]
    assert outs == ["ok", "DeadlineExceeded", "ServerOverloaded", "ok",
                    "shed p0"]


def test_request_spans_match_jax(arts):
    def spans(pkg, trmod, pred):
        trmod.clear()
        b = pkg.DynamicBatcher(pred, deadline_ms=1,
                               metrics=pkg.ServingMetrics().model("m"))
        try:
            f = b.submit({"x": np.ones((1, 4), np.float32)},
                         trace_id="feedbeef00000001")
            f.result(timeout=30)
        finally:
            b.close()
        return sorted((s["name"], s["kind"], sorted(s.get("attrs", {})))
                      for s in trmod.spans_for_trace("feedbeef00000001"))
    t = spans(tserving, ttracing, _direct(arts["m"]))
    assert t == spans(jserving, jtracing, _jax_direct(arts["m"]))
    assert [n for n, _, _ in t] == sorted(
        ["serving/queue_wait", "serving/coalesce", "serving/lane_wait",
         "serving/dispatch", "serving/compute", "serving/scatter",
         "serving/request"])


def test_slow_requests_land_an_event(arts):
    FLAGS.trace_slow_ms = 0.001
    try:
        b = tserving.DynamicBatcher(_direct(arts["m"]), deadline_ms=1)
        try:
            f = b.submit({"x": np.ones((1, 4), np.float32)})
            f.result(timeout=30)
        finally:
            b.close()
    finally:
        FLAGS.trace_slow_ms = 0.0
    ev = [e for e in tevents.recent_events(kind="slow")
          if e.get("trace_id") == f.trace_id]
    assert ev and ev[0]["replica"] == 0 and ev[0]["device"] == "cpu:0"


# ---------------------------------------------------------------------------
# ModelRegistry
# ---------------------------------------------------------------------------

def test_registry_hot_swap_drops_nothing_and_unloads(arts):
    reg = tserving.ModelRegistry(deadline_ms=1, replicas="cpu")
    d1, d2 = _direct(arts["m"]), _direct(arts["m2"])
    x = np.ones((1, 4), np.float32)
    try:
        e1 = reg.load_model("m", arts["m"], buckets=BUCKETS)
        assert e1.version == 1 and e1.device_labels() == ["cpu:0"]
        futs, stop = [], threading.Event()

        def traffic():
            while not stop.is_set():
                futs.append(reg.submit("m", {"x": x}))
                time.sleep(0.002)
        th = threading.Thread(target=traffic)
        th.start()
        e2 = reg.load_model("m", arts["m2"], buckets=BUCKETS)
        time.sleep(0.05)
        stop.set()
        th.join()
        outs = [f.result(timeout=30)[0] for f in futs]
        want = {d1.run({"x": x})[0].tobytes(), d2.run({"x": x})[0].tobytes()}
        assert outs and all(o.tobytes() in want for o in outs)
        assert e2.version == 2
        np.testing.assert_array_equal(reg.infer("m", {"x": x})[0],
                                      d2.run({"x": x})[0])
        desc = reg.describe()["m"]
        assert (desc["latest"], desc["versions"], desc["replicas"]) == \
            (2, [2], 1)
        reg.unload_model("m")
        with pytest.raises(KeyError):
            reg.submit("m", {"x": x})
    finally:
        reg.close_all()


def test_precision_lanes_route_and_split(arts):
    reg = tserving.ModelRegistry(deadline_ms=1, replicas="cpu")
    x = _rows(1, 2)[0]
    try:
        reg.load_model("m", arts["m"], buckets=BUCKETS)
        e8 = reg.load_model("m", arts["m_int8"], buckets=BUCKETS)
        assert e8.precision == "int8"
        fp = reg.infer("m", {"x": x})[0]
        q8 = reg.infer("m", {"x": x}, precision="int8")[0]
        np.testing.assert_array_equal(fp, _direct(arts["m"]).run(
            {"x": x})[0])
        np.testing.assert_array_equal(q8, _direct(arts["m_int8"]).run(
            {"x": x})[0])
        assert not np.array_equal(fp, q8)
        reg.set_ab_weights("m", {"int8": 0.5})
        got = [reg.infer("m", {"x": x})[0].tobytes() for _ in range(4)]
        assert got.count(q8.tobytes()) == 2
        desc = reg.describe()["m"]
        assert desc["precisions"] == {"fp32": 1, "int8": 2}
        with pytest.raises(KeyError):
            reg.infer("m", {"x": x}, precision="bf16")
        assert set(reg.health()["m"]["lanes"]) == {"fp32", "int8"}
    finally:
        reg.close_all()


def test_replicas_are_clones_on_their_devices(arts):
    reg = tserving.ModelRegistry(deadline_ms=1)
    x = np.ones((2, 4), np.float32)
    try:
        e = reg.load_model("m", arts["m"], buckets=BUCKETS,
                           devices=["cpu", "cpu"])
        assert len(e.replicas) == 2
        assert e.replicas[1].program is e.replicas[0].program
        outs = [reg.submit("m", {"x": x}) for _ in range(6)]
        want = _direct(arts["m"]).run({"x": x})[0]
        for f in outs:
            np.testing.assert_array_equal(f.result(timeout=30)[0], want)
        rows = e.batcher.replica_stats()
        assert [r["device"] for r in rows] == ["cpu:0", "cpu:0"]
    finally:
        reg.close_all()


def test_placement_defaults_to_the_card(monkeypatch):
    assert tserving.resolve_placement("cpu") == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserving.resolve_placement(None)
    with pytest.raises(NotImplementedError, match="item 12"):
        tserving.resolve_placement("mesh:2")


def test_aot_artifacts_raise(tmp_path):
    d = tmp_path / "aot"
    d.mkdir()
    (d / "aot_meta.bin").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="item 11"):
        tserving.open_predictor(str(d), device="cpu")


# ---------------------------------------------------------------------------
# InferenceServer / ServingClient
# ---------------------------------------------------------------------------

def _jax_server():
    return jserving.InferenceServer("127.0.0.1:0",
                                    buckets=list(BUCKETS)).start()


def test_server_verbs_and_reply_keys_match_jax(arts):
    srv, jsrv = _server(), _jax_server()
    cli = tserving.ServingClient(srv.endpoint)
    jcli = jserving.ServingClient(jsrv.endpoint)
    x = _rows(3, 4)[2]
    try:
        lt = cli.load_model("m", arts["m"], buckets=BUCKETS)
        lj = jcli.load_model("m", arts["m"], buckets=BUCKETS)
        assert set(lt) == set(lj) - WAITING_KEYS
        assert lt["devices"] == ["cpu:0"]
        out, info = cli.infer("m", {"x": x}, debug=True,
                              trace_id="00000000000000aa")
        jout, jinfo = jcli.infer("m", {"x": x}, debug=True)
        np.testing.assert_allclose(out[0], jout[0], rtol=RTOL, atol=ATOL)
        assert set(info) == set(jinfo)
        assert cli.last_trace_id == "00000000000000aa"
        st, jst = cli.stats(), jcli.stats()
        assert set(st) == set(jst)
        assert set(st["stats"]["models"]["m"]) == \
            set(jst["stats"]["models"]["m"]) - WAITING_KEYS
        assert set(st["models"]["m"]) == \
            set(jst["models"]["m"]) - WAITING_KEYS
        h, jh = cli.health(), jcli.health()
        assert set(h) == set(jh)
        assert set(h["models"]["m"]["lanes"]["fp32"]["liveness"]) == \
            set(jh["models"]["m"]["lanes"]["fp32"]["liveness"])
        assert 'paddle_tpu_serving_requests_total{model="m"} 1' in \
            cli.metrics_text()
        names = {s["name"] for s in
                 cli.trace(trace_id="00000000000000aa")["spans"]}
        assert {"serving/rpc", "serving/request"} <= names
        assert cli.drain() == {"ok": True, "accepting": False,
                               "draining": True}
        with pytest.raises(tserving.ServerOverloaded):
            cli.infer("m", {"x": x})
        cli.drain(resume=True)
        for verb in ("fleet", "flight", "page_model", "resize_model",
                     "fault_model", "bogus"):
            with pytest.raises(tserving.ServingError) as ei:
                cli.call({"cmd": verb, "name": "m"})
            assert ei.value.code == "bad_request"
            if verb != "bogus":
                assert "ROADMAP.md" in str(ei.value)
        with pytest.raises(tserving.ServingError) as ei:
            cli.infer("nope", {"x": x})
        assert ei.value.code == "no_model"
        cli.unload_model("m")
        assert "m" not in cli.stats()["models"]
    finally:
        cli.close()
        jcli.close()
        srv.shutdown()
        jsrv.shutdown()


def test_cross_package_wire(arts):
    """The JAX client against the port's server gives the port client's
    replies, and the port's client works against the JAX server."""
    srv, jsrv = _server(), _jax_server()
    cli = tserving.ServingClient(srv.endpoint)
    jcli = jserving.ServingClient(srv.endpoint)
    cli_on_j = tserving.ServingClient(jsrv.endpoint)
    jcli_on_j = jserving.ServingClient(jsrv.endpoint)
    xs = _rows(3, 5)
    try:
        assert jcli.load_model("m", arts["m"], buckets=BUCKETS)["ok"]
        cli_on_j.load_model("m", arts["m"], buckets=BUCKETS)
        for x in xs:
            a = cli.infer("m", {"x": x})
            b = jcli.infer("m", {"x": x})
            np.testing.assert_array_equal(a[0], b[0])
            c = cli_on_j.infer("m", {"x": x})
            d = jcli_on_j.infer("m", {"x": x})
            np.testing.assert_array_equal(c[0], d[0])
            np.testing.assert_allclose(a[0], c[0], rtol=RTOL, atol=ATOL)
        assert jcli.stats()["stats"]["models"]["m"]["responses"] == 6
        assert cli_on_j.health()["models"]["m"]["latest"] == 1
        with pytest.raises(jserving.ServerOverloaded):
            jcli.drain()
            jcli.infer("m", {"x": xs[0]})
    finally:
        for c in (cli, jcli, cli_on_j, jcli_on_j):
            c.close()
        srv.shutdown()
        jsrv.shutdown()


def test_shutdown_closes_the_listener_and_leaves_no_accept_thread(arts):
    srv = _server()
    port = srv._addr[1]
    cli = tserving.ServingClient(srv.endpoint)
    cli.load_model("m", arts["m"], buckets=BUCKETS)
    assert cli.shutdown_server() == {"ok": True, "draining": True}
    cli.close()
    deadline = time.monotonic() + 10
    name = "paddle-tpu-torch-server-%d" % port
    while time.monotonic() < deadline and any(
            t.name == name for t in threading.enumerate()):
        time.sleep(0.05)
    assert not any(t.name == name for t in threading.enumerate())
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=2).close()
    srv.shutdown()   # idempotent


def test_waiting_subsystems_refuse_at_construction():
    with pytest.raises(NotImplementedError, match="federation"):
        tserving.InferenceServer(federation="127.0.0.1:1")
    FLAGS.fleet_controller = True
    try:
        with pytest.raises(NotImplementedError, match="fleet"):
            tserving.InferenceServer()
    finally:
        FLAGS.fleet_controller = False
