"""paddle_tpu_torch.bench_serving on the CPU: `--smoke` prints valid
open-loop points through the whole client -> wire -> router -> lane ->
predictor path, the decode lane prints streamed tokens/s and TTFT points
whose replay is bit-exact, the precision lane drives both numerics lanes,
and the JAX tool's lanes that are not ported raise."""

import json
import os
import signal
import subprocess
import sys

import pytest

from paddle_tpu_torch import bench_serving
from paddle_tpu_torch.flags import FLAGS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def _per_test_timeout():
    def _expired(signum, frame):
        raise TimeoutError("test exceeded %d s" % TEST_TIMEOUT_S)
    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(TEST_TIMEOUT_S)
    old_slo = FLAGS.slo_monitor
    FLAGS.slo_monitor = False
    yield
    FLAGS.slo_monitor = old_slo
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _records(out):
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def test_smoke_subprocess_prints_valid_points():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), FLAGS_slo_monitor="0")
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.bench_serving", "--smoke",
         "--device", "cpu", "--duration", "1"],
        env=env, capture_output=True, text=True, timeout=100, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    recs = _records(proc.stdout)
    assert len(recs) == 1
    r = recs[0]
    assert r["metric"] == "serving_qps" and r["model"] == "fc"
    assert r["bit_exact"] is True and r["errors"] == 0
    assert r["ok"] == r["sent"] > 0 and r["achieved_qps"] > 0
    assert r["served_qps"] > 0
    assert r["p50_ms"] <= r["p95_ms"] <= r["p99_ms"]
    assert r["devices"] == ["cpu:0"] and r["backend"] == "cpu"
    assert r["buckets"] == [2, 4, 8]


def test_decode_lane_points(capsys):
    bench_serving.main(["--decode", "--device", "cpu", "--qps", "10",
                        "--duration", "1", "--fuse_steps", "1,4",
                        "--kv_dtype", "int8"])
    recs = _records(capsys.readouterr().out)
    assert [r["fuse_steps"] for r in recs] == [1, 4]
    for r in recs:
        assert r["metric"] == "serving_decode" and r["bit_exact"] is True
        assert r["completion_rate"] == 1.0 and r["errors"] == 0
        assert r["tokens_per_sec"] > 0 and r["kv_cache_dtype"] == "int8"
        assert r["ttft_p50_ms"] <= r["ttft_p95_ms"] <= r["ttft_p99_ms"]
    assert recs[1]["tokens_per_dispatch"] > recs[0]["tokens_per_dispatch"]


def test_spec_and_precision_lanes(capsys):
    bench_serving.main(["--decode", "--device", "cpu", "--qps", "10",
                        "--duration", "0.5", "--spec_k", "2"])
    rec, = _records(capsys.readouterr().out)
    assert rec["spec_k"] == 2 and rec["bit_exact"] is True
    assert rec["accept_rate"] > 0.5
    old = FLAGS.quantize_min_weight_elems
    FLAGS.quantize_min_weight_elems = 64
    try:
        bench_serving.main(["--smoke", "--device", "cpu", "--duration",
                            "0.5", "--precision", "both"])
    finally:
        FLAGS.quantize_min_weight_elems = old
    recs = _records(capsys.readouterr().out)
    assert [r["precision"] for r in recs] == ["fp32", "int8"]
    assert all(r["bit_exact"] and r["errors"] == 0 for r in recs)
    # the lane also served the bit-exact replay
    assert recs[1]["lane_requests"] >= recs[1]["sent"]


@pytest.mark.parametrize("flag", [["--mesh", "2"], ["--fleet", "on"],
                                  ["--topology", "2x1"], ["--chaos_proxy"],
                                  ["--compile_cache_dir", "/nonexistent"]])
def test_unported_lanes_raise(flag):
    with pytest.raises(NotImplementedError, match="not ported"):
        bench_serving.main(["--smoke", "--device", "cpu"] + flag)


def test_open_loop_percentiles_follow_the_jax_tool():
    vals = [float(v) for v in range(1, 101)]
    assert (bench_serving._pct(vals, 50), bench_serving._pct(vals, 99)) \
        == (51.0, 100.0)
    assert bench_serving._pct([], 50) is None
    a = bench_serving.decode_request(3, 5, 64)
    assert a == bench_serving.decode_request(3, 5, 64)
    assert 2 <= len(a[0]) <= 7 and a[1] in (6, 12, 48)
