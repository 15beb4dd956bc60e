"""fluid.profiler of paddle_tpu_torch on the CPU: the summary table's text
equals the JAX package's `_format_table` for the same rows under every
sorted_key; concurrent RecordEvents lose no update (the thread hammer of
tests/test_profiler.py, against the port's `_record`); a session prints
and writes the table of host events; a torch.profiler session exports a
chrome trace with the obs spans merged in; reset_profiler clears the
table; `fluid_benchmark --profile` writes its table and trace.  Only the
JAX package's pure functions are called (never its start_profiler, whose
device trace would outlive the test), every file lands under tmp_path,
and a fixture restores the port profiler's process-wide state.  The
`cuda` case checks the table's CUDA kernel rows on the card."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from paddle_tpu.fluid import profiler as jprof
from paddle_tpu_torch import fluid_benchmark as fb
from paddle_tpu_torch.fluid import profiler as tprof
from paddle_tpu_torch.obs import tracing as obs_tracing

import paddle_tpu_torch.fluid as tfluid


@pytest.fixture(autouse=True)
def _profiler_state(tmp_path, monkeypatch):
    """A clean table, no session, and the default trace directory under
    tmp_path; the previous state back after."""
    monkeypatch.setenv("PADDLE_TPU_TORCH_TRACE_DIR", str(tmp_path / "trace"))
    saved = (tprof._enabled, tprof._trace_dir)
    tprof.reset_profiler()
    yield
    if tprof._torch_prof is not None:
        tprof._torch_prof.__exit__(None, None, None)
        tprof._torch_prof = None
    tprof.reset_profiler()
    tprof._enabled, tprof._trace_dir = saved


ROWS = [("step", 3, 12.5, 3.0, 5.5), ("feed", 10, 4.0, 0.2, 0.7),
        ("cuda::volta_sgemm_128x64_nn_with_a_name_longer_than_44_chars",
         40, 20.25, 0.3, 0.9), ("idle", 1, 0.0, 0.0, 0.0)]


@pytest.mark.parametrize("sorted_key", [None, "calls", "total", "min",
                                        "max", "ave", "default", "other"])
def test_table_text_equals_jax(sorted_key):
    assert tprof._format_table(ROWS, sorted_key) == \
        jprof._format_table(ROWS, sorted_key)


def test_concurrent_record_events_no_lost_updates():
    n_threads, n_calls = 4, 400

    def hammer():
        for _ in range(n_calls):
            tprof._record("hammered", 1.0)

    threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    calls, total_ms, mn, mx = tprof._host_events["hammered"]
    assert calls == n_threads * n_calls
    assert total_ms == float(n_threads * n_calls)
    assert mn == mx == 1.0


def _tiny_run():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[4], dtype="float32")
        loss = tfluid.layers.mean(tfluid.layers.fc(x, size=4))
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe.run(startup)
        exe.run(main, feed={"x": np.ones((2, 4), np.float32)},
                fetch_list=[loss])


def test_profiler_sorted_table(tmp_path, capsys):
    report = tmp_path / "profile.txt"
    with tfluid.profiler.profiler(sorted_key="total",
                                  profile_path=str(report)):
        for _ in range(2):
            with tfluid.profiler.RecordEvent("forward_and_fetch"):
                _tiny_run()
    out = capsys.readouterr().out
    assert "Profiling Report" in out
    row = [ln for ln in out.splitlines() if "forward_and_fetch" in ln][0]
    assert row.split()[1] == "2"
    assert "forward_and_fetch" in report.read_text()
    assert not tprof.enabled()
    assert (tmp_path / "trace" / "trace.json").exists()


def test_start_stop_and_chrome_export_merge_obs_spans(tmp_path, capsys):
    trace_dir = str(tmp_path / "t")
    obs_tracing.add_span(obs_tracing.Span("profiler-test-span",
                                          kind="train", dur_ms=1.5))
    tfluid.profiler.start_profiler("All", output_dir=trace_dir)
    assert tprof.enabled()
    with tfluid.profiler.RecordEvent("step"):
        _tiny_run()
    assert tfluid.profiler.stop_profiler(
        sorted_key="max", profile_path=str(tmp_path / "p.txt")) == trace_dir
    assert "step" in capsys.readouterr().out
    path = tfluid.profiler.export_chrome_tracing(trace_dir)
    assert path == os.path.join(trace_dir, "timeline.json")
    data = json.load(open(path))
    names = {e.get("name") for e in data["traceEvents"]}
    assert "step" in names and "profiler-test-span" in names
    # the CPU trace has no device rows
    assert tprof._device_events(trace_dir) == {}


def test_device_rows_come_from_the_trace_kernels(tmp_path):
    """Kernel, memcpy and memset events of a chrome trace aggregate as
    `cuda::` rows (what torch.profiler writes on the card)."""
    events = [{"ph": "X", "cat": "kernel", "name": "k", "dur": 1500},
              {"ph": "X", "cat": "kernel", "name": "k", "dur": 500},
              {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
               "dur": 250},
              {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 9},
              {"ph": "M", "name": "process_name"}]
    (tmp_path / "trace.json").write_text(json.dumps(
        {"traceEvents": events}))
    rows = tprof._device_events(str(tmp_path))
    assert rows == {"cuda::k": [2, 2.0, 0.5, 1.5],
                    "cuda::Memcpy HtoD": [1, 0.25, 0.25, 0.25]}


def test_reset_profiler(tmp_path):
    tfluid.profiler.start_profiler("All", output_dir=str(tmp_path / "r"))
    with tfluid.profiler.RecordEvent("r1"):
        pass
    tfluid.profiler.reset_profiler()
    tfluid.profiler.stop_profiler(profile_path=str(tmp_path / "p.txt"))
    assert "r1" not in tprof._host_events


def test_fluid_benchmark_profile_writes_table_and_trace(tmp_path, capsys):
    pdir = str(tmp_path / "fbp")
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        record, _ = fb.benchmark(fb.parse_args(
            ["--model", "mnist", "--device", "CPU", "--iterations", "2",
             "--skip_batch_num", "1", "--batch_size", "2", "--profile",
             "--profile_dir", pdir]))
    finally:
        torch.set_num_threads(torch_threads)
    prof = record["profile"]
    assert prof["table"] == os.path.join(pdir, "profile.txt")
    assert prof["trace"] == os.path.join(pdir, "timeline.json")
    table = open(prof["table"]).read()
    assert not any(ln.startswith("cuda::") for ln in table.splitlines())
    step = [ln for ln in table.splitlines()
            if ln.startswith("fluid_benchmark/step")][0]
    assert step.split()[1] == "2"
    assert "fluid_benchmark/feed" in capsys.readouterr().out
    assert "traceEvents" in json.load(open(prof["trace"]))


@pytest.mark.cuda
def test_cuda_table_has_kernel_rows(tmp_path, capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    tfluid.profiler.start_profiler("All", output_dir=str(tmp_path / "g"))
    with tfluid.profiler.RecordEvent("matmul"):
        a = torch.randn(256, 256, device="cuda")
        (a @ a).sum().item()
    tfluid.profiler.stop_profiler("total", str(tmp_path / "p.txt"))
    out = capsys.readouterr().out
    assert "matmul" in out and "cuda::" in out
