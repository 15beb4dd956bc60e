"""`python -m paddle_tpu_torch.bench`, the port's ResNet-50 training
benchmark: on the CPU (BENCH_DEVICE=cpu, batch 2) it prints one
well-formed JSON line that says cpu, and its knobs (fp32, NCHW, per-op,
remat) land in that line (run in process at 32 x 32 images: a CPU test
worker cannot afford 224 x 224); run as `python -m` without CUDA and
without BENCH_DEVICE it exits non-zero and prints no result; BENCH_PREFETCH raises; importing the module runs nothing.  The
card case runs it at batch 8."""

import importlib
import json
import os
import subprocess
import sys

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this file runs: the suite runs six
    workers on a few cores, and training steps at eight threads each
    oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

KEYS = {"metric", "value", "unit", "card", "power_limit", "device", "amp",
        "layout", "batch", "whole_graph"}


def _bench(env, timeout=300):
    full = dict(os.environ, **env)
    for k in ("BENCH_DEVICE", "BENCH_BATCH", "BENCH_PREFETCH"):
        if k not in env:
            full.pop(k, None)
    full["PYTHONPATH"] = REPO
    return subprocess.run([sys.executable, "-m", "paddle_tpu_torch.bench"],
                          cwd=REPO, env=full, capture_output=True,
                          text=True, timeout=timeout)


def _check_line(stdout, want):
    lines = stdout.strip().splitlines()
    assert len(lines) == 1, stdout
    out = json.loads(lines[0])
    assert KEYS <= set(out)
    assert out["metric"] == "resnet50_train_images_per_sec"
    assert out["unit"] == "images/sec"
    assert (out["card"], out["device"], out["power_limit"]) == (
        "cpu", "cpu", None)
    assert out["value"] > 0
    for k, v in want.items():
        assert out[k] == v, k
    assert "vs_baseline" not in out


@pytest.mark.parametrize("knobs,want", [
    ({}, {"amp": True, "layout": "NHWC", "whole_graph": True}),
    ({"BENCH_AMP": "0", "BENCH_LAYOUT": "NCHW", "BENCH_WHOLEGRAPH": "0"},
     {"amp": False, "layout": "NCHW", "whole_graph": False}),
    ({"BENCH_REMAT": "1", "BENCH_REMAT_POLICY": "block_out"},
     {"amp": True, "whole_graph": True, "remat_policy": "block_out"}),
    ({"BENCH_REMAT": "1", "BENCH_WHOLEGRAPH": "0"},
     {"whole_graph": True, "remat_policy": "conv_out"}),
], ids=["defaults", "fp32-nchw-per-op", "remat-block-out",
        "remat-default-policy"])
def test_cpu_run_prints_one_json_line(knobs, want, monkeypatch, capsys):
    from paddle_tpu_torch import bench
    monkeypatch.setattr(bench, "IMAGE_HW", 32)
    for k in ("BENCH_AMP", "BENCH_LAYOUT", "BENCH_WHOLEGRAPH", "BENCH_REMAT",
              "BENCH_REMAT_POLICY", "BENCH_PREFETCH"):
        monkeypatch.delenv(k, raising=False)
    for k, v in dict(knobs, BENCH_DEVICE="cpu", BENCH_BATCH="2").items():
        monkeypatch.setenv(k, v)
    assert bench.main() == 0
    _check_line(capsys.readouterr().out, dict(want, batch=2))


@pytest.mark.parametrize("env,stderr", [
    ({}, "CUDA is not available"),
    ({"BENCH_DEVICE": "cpu"}, "needs BENCH_BATCH"),
    ({"BENCH_DEVICE": "tpu", "BENCH_BATCH": "1"}, "BENCH_DEVICE"),
    ({"BENCH_PREFETCH": "2", "BENCH_DEVICE": "cpu", "BENCH_BATCH": "1"},
     "prefetch_to_device"),
], ids=["no-card", "cpu-without-batch", "unknown-device", "prefetch"])
def test_refuses_without_a_card_or_a_batch(env, stderr):
    proc = _bench(dict(env, CUDA_VISIBLE_DEVICES=""), timeout=120)
    assert proc.returncode != 0
    assert stderr in proc.stderr
    assert "images_per_sec" not in proc.stdout


def test_importing_runs_nothing(capsys):
    mod = importlib.import_module("paddle_tpu_torch.bench")
    importlib.reload(mod)
    assert capsys.readouterr().out == ""
    assert (mod.WARMUP, mod.ITERS, mod.N_BATCHES) == (2, 20, 4)


@pytest.mark.cuda
def test_cuda_bench_at_batch_8():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    proc = _bench({"BENCH_BATCH": "8"}, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["device"] == "cuda" and out["batch"] == 8
    assert out["card"] == torch.cuda.get_device_name(0)
    assert out["value"] > 0 and out["whole_graph"] is True
