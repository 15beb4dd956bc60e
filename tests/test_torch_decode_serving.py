"""paddle_tpu_torch's decode serving on the CPU: `infer_stream` through
the InferenceServer and the port's DecodeBatcher (the rest of it: the
static baseline, replicas, metrics, trace ids, spans and events), held
against the JAX package's GenerativePredictor.

The decode artifact is written by the JAX package's
`build_tiny_decode_model`, so both packages load the same directory.
Every served stream must be token-identical to the JAX package's greedy
decode of the same prompt: fp32 and int8 KV caches, one step or fused
windows a dispatch, the static baseline and a speculative lane.  A
client that drops its connection frees its slot.  Every socket binds
port 0; every test runs under a per-test alarm."""

import signal
import threading
import time

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu.serving as jserving
from paddle_tpu.inference import decode as jdecode
from paddle_tpu.obs import tracing as jtracing
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.flags import FLAGS
from paddle_tpu_torch.inference import decode as tdecode
from paddle_tpu_torch.obs import events as tevents
from paddle_tpu_torch.obs import tracing as ttracing

TEST_TIMEOUT_S = 120
PROMPTS = [[3, 1, 4], [1, 5, 9, 2, 6], [5, 3], [5, 8, 9, 7, 9, 3],
           [2, 3, 8, 4]]
MAX_NEW = [7, 12, 3, 9, 12]


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
    tdecode.set_draft_poison(None)


@pytest.fixture(autouse=True, scope="module")
def _settings():
    jold = jfluid.get_flags(["compile_cache", "slo_monitor"])
    jfluid.set_flags({"compile_cache": False, "slo_monitor": False})
    old = (FLAGS.rpc_deadline, FLAGS.slo_monitor)
    FLAGS.rpc_deadline, FLAGS.slo_monitor = 30.0, False
    yield
    FLAGS.rpc_deadline, FLAGS.slo_monitor = old
    jfluid.set_flags(jold)


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_decode_serving") / "lm")
    jdecode.build_tiny_decode_model(d, vocab_size=32, d_model=16,
                                    n_heads=2, n_layers=2, max_seq_len=64,
                                    eos_id=-1, seed=7)
    return d


@pytest.fixture(scope="module")
def jax_refs(art):
    """The JAX package's greedy stream of each prompt, per cache dtype."""
    out = {}
    for kv in ("float32", "int8"):
        pred = jdecode.GenerativePredictor(art, kv_cache_dtype=kv)
        out[kv] = [jdecode.greedy_decode(pred, p, n)[0]
                   for p, n in zip(PROMPTS, MAX_NEW)]
    return out


@pytest.fixture(scope="module")
def server():
    srv = tserving.InferenceServer("127.0.0.1:0", replicas="cpu").start()
    yield srv
    srv.shutdown()


def _streams(endpoint, model, prompts=PROMPTS, max_new=MAX_NEW):
    """Every prompt streamed concurrently, one client each."""
    outs = [None] * len(prompts)

    def run(i):
        cli = tserving.ServingClient(endpoint)
        try:
            outs[i] = [t for c in cli.infer_stream(
                model, prompts[i], max_new_tokens=max_new[i],
                deadline_ms=60000.0) for t in c]
        finally:
            cli.close()
    ths = [threading.Thread(target=run, args=(i,))
           for i in range(len(prompts))]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=90)
    return outs


@pytest.mark.parametrize("kv, fuse, mode, spec_k", [
    ("float32", 1, None, 0), ("float32", 4, None, 0),
    ("int8", 1, None, 0), ("int8", 4, None, 0),
    ("float32", 1, "static", 0), ("float32", 4, None, 2),
    ("int8", 1, None, 2)],
    ids=["fp32", "fp32-fused", "int8", "int8-fused", "static",
         "spec-fused", "int8-spec"])
def test_streams_are_token_identical_to_jax(server, art, jax_refs, kv, fuse,
                                            mode, spec_k):
    cli = tserving.ServingClient(server.endpoint)
    name = "lm-%s-%d-%s-%d" % (kv, fuse, mode, spec_k)
    try:
        rep = cli.load_model(name, art, decode_slots=3, fuse_steps=fuse,
                             kv_cache_dtype=kv, decode_mode=mode,
                             draft=art if spec_k else None, spec_k=spec_k)
        assert (rep["decode"], rep["kv_cache_dtype"], rep["fuse_steps"]) \
            == (True, kv, fuse)
        assert rep.get("spec_k", 0) == spec_k
        assert _streams(server.endpoint, name) == jax_refs[kv]
        one = cli.infer(name, {"tokens": np.asarray(PROMPTS[1], np.int32)},
                        max_new_tokens=MAX_NEW[1])
        assert one[0].tolist() == jax_refs[kv][1]
        st = cli.stats()["stats"]["models"][name]
        assert st["streams"] == len(PROMPTS) + 1
        assert st["decode_tokens"] == sum(MAX_NEW) + MAX_NEW[1]
        if spec_k:
            assert st["spec_rounds"] > 0 and st["spec_accept_rate"] > 0.5
    finally:
        cli.unload_model(name)
        cli.close()


def test_load_reply_keys_match_jax(art):
    jsrv = jserving.InferenceServer("127.0.0.1:0").start()
    srv = tserving.InferenceServer("127.0.0.1:0", replicas="cpu").start()
    try:
        kw = dict(decode_slots=2, fuse_steps=2, draft=art, spec_k=2)
        rep = tserving.ServingClient(srv.endpoint).load_model("lm", art,
                                                              **kw)
        jrep = jserving.ServingClient(jsrv.endpoint).load_model("lm", art,
                                                                **kw)
        assert set(rep) == set(jrep) - {"compile_cache"}
        for k in ("buckets", "decode_slots", "max_seq_len", "eos_id",
                  "kv_cache_dtype", "fuse_steps", "spec_k", "precision"):
            assert rep[k] == jrep[k], k
    finally:
        srv.shutdown()
        jsrv.shutdown()


def test_dropped_client_frees_its_slot(server, art):
    cli = tserving.ServingClient(server.endpoint)
    cli.load_model("drop", art, decode_slots=1)
    try:
        tserving.set_dispatch_delay(0.05)   # 60 tokens take >= 3 s
        gen = cli.infer_stream("drop", PROMPTS[0], max_new_tokens=60)
        assert len(next(gen)) == 1
        gen.close()           # the connection drops mid-stream
        deadline = time.monotonic() + 20
        busy = None
        while time.monotonic() < deadline:
            lane = cli.health()["models"]["drop"]["lanes"]["fp32"]
            busy = lane["liveness"]["lanes"][0]["slots_busy"]
            if busy == 0:
                break
            time.sleep(0.05)
        assert busy == 0
        # freed by the cancel, not by running out its budget
        assert cli.stats()["stats"]["models"]["drop"]["decode_tokens"] < 60
        tserving.set_dispatch_delay(0.0)
        out = [t for c in cli.infer_stream("drop", PROMPTS[2],
                                           max_new_tokens=4) for t in c]
        assert len(out) == 4
        assert cli.last_stream_info["finish_reason"] == "length"
    finally:
        tserving.set_dispatch_delay(0.0)
        cli.unload_model("drop")
        cli.close()


def test_decode_spans_match_jax(art):
    def names(pkg, trmod, pred):
        trmod.clear()
        b = pkg.DecodeBatcher(pred, n_slots=2,
                              metrics=pkg.ServingMetrics().model("lm"))
        try:
            b.submit(PROMPTS[0], max_new_tokens=3,
                     trace_id="00000000000000d1").result(timeout=60)
        finally:
            b.close()
        return sorted({(s["name"], tuple(sorted(s.get("attrs", {}))))
                       for s in trmod.spans_for_trace("00000000000000d1")})
    t = names(tserving, ttracing,
              tdecode.GenerativePredictor(art, device="cpu"))
    j = names(jserving, jtracing, jdecode.GenerativePredictor(art))
    assert t == j
    assert {n for n, _ in t} == {"serving/queue_wait", "serving/prefill",
                                 "serving/prefill_compute",
                                 "serving/decode", "serving/request"}


def test_spec_lane_spans_and_degraded_event(art):
    ttracing.clear()
    pred = tdecode.GenerativePredictor(art, device="cpu")
    metrics = tserving.ServingMetrics().model("spec")
    b = tserving.DecodeBatcher(pred, n_slots=2, draft=pred, spec_k=2,
                               metrics=metrics)
    try:
        s = b.submit(PROMPTS[1], max_new_tokens=10)
        ref = tdecode.greedy_decode(pred, PROMPTS[1], 10)[0]
        assert s.result(timeout=60)[0].tolist() == ref
        names = {sp["name"] for sp in ttracing.recent_spans()}
        assert {"serving/draft", "serving/verify",
                "serving/decode_step"} <= names
        tdecode.set_draft_poison(0)
        s = b.submit(PROMPTS[3], max_new_tokens=8)
        assert s.result(timeout=60)[0].tolist() == \
            tdecode.greedy_decode(pred, PROMPTS[3], 8)[0]
    finally:
        b.close()
    assert b.lane_stats()["degraded"]
    ev = [e for e in tevents.recent_events(kind="spec_degraded")
          if e.get("model") == "spec"]
    assert len(ev) == 1 and metrics.snapshot()["spec_degraded"] == 1


def test_decode_overload_and_deadline(art):
    pred = tdecode.GenerativePredictor(art, device="cpu")
    metrics = tserving.ServingMetrics().model("ovl")
    b = tserving.DecodeBatcher(pred, n_slots=1, max_queue=1,
                               metrics=metrics)
    try:
        tserving.set_dispatch_delay(0.05)
        busy = b.submit(PROMPTS[0], max_new_tokens=100)
        deadline = time.monotonic() + 30
        while b.lane_stats()["inflight"] != 1:   # admitted into its slot
            assert time.monotonic() < deadline
            time.sleep(0.005)
        late = b.submit(PROMPTS[1], max_new_tokens=5,
                        deadline=time.monotonic() + 0.1)
        with pytest.raises(tserving.ServerOverloaded):
            b.submit(PROMPTS[2], max_new_tokens=5)
        time.sleep(0.2)
        busy.cancel()   # frees the slot; `late` is admitted expired
        with pytest.raises(tserving.DeadlineExceeded):
            late.result(timeout=60)
        assert busy.result(timeout=60) and busy.finish_reason == "cancelled"
    finally:
        tserving.set_dispatch_delay(0.0)
        b.close()
    snap = metrics.snapshot()
    assert (snap["shed"], snap["deadline_expired"]) == (1, 1)
    kinds = {e["kind"] for e in tevents.recent_events()
             if e.get("model") == "ovl"}
    assert {"shed", "deadline_expired"} <= kinds


def test_replica_lanes_serve_identical_streams(art):
    pred = tdecode.GenerativePredictor(art, device="cpu")
    reps = [pred, pred.clone_to("cpu")]
    b = tserving.DecodeBatcher(pred, replicas=reps, n_slots=1)
    try:
        streams = [b.submit(p, max_new_tokens=n)
                   for p, n in zip(PROMPTS, MAX_NEW)]
        outs = [s.result(timeout=60)[0].tolist() for s in streams]
        rows = b.replica_stats()
    finally:
        b.close()
    assert outs == [tdecode.greedy_decode(pred, p, n)[0]
                    for p, n in zip(PROMPTS, MAX_NEW)]
    assert len(rows) == 2 and all(r["batches"] > 0 for r in rows)
    assert b.kv_cache_info() == ("float32", 2 * pred.kv_cache_bytes(1))
