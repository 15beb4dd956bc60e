"""`python -m paddle_tpu_torch.fluid_benchmark`, the port's counterpart of
the JAX package's tools/fluid_benchmark.py, on the CPU (`--device CPU`,
2 timed iterations, a tiny batch) for every ported model: its record
holds the JAX tool's keys and says cpu; its synthetic batches are the
JAX tool's for the same seed (ragged ids included); the pipeline flags
(--prefetch_depth, --async_depth, --staged_feed, --fetch_every,
--host_stall_ms) keep the plain run's losses and say themselves in the
record; each flag and model that needs parts not ported yet raises
NotImplementedError; without
`--device CPU` on a host without CUDA it raises rather than fall back.
`--parallel` on the CPU starts CPU_NUM gloo trainers and trainer 0 prints
the record; a failed trainer fails the run; benchmark() outside a
trainer's environment raises for --parallel and --update_method nccl2."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch import fluid_benchmark as fb
from paddle_tpu_torch.flags import FLAGS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the JAX tool's record keys (device_loop and layout where it writes them)
JAX_KEYS = {"model", "batch_size", "iterations", "examples_per_sec",
            "last_loss", "device", "parallel", "update_method",
            "whole_graph_ad", "remat_policy"}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_fluid_benchmark", os.path.join(REPO, "tools",
                                            "fluid_benchmark.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cpu(model, *extra):
    return ["--model", model, "--device", "CPU", "--iterations", "2",
            "--skip_batch_num", "1"] + list(extra)


# tiny shapes for the CPU: batch 2 (1 at SE-ResNeXt's 224 x 224), the
# ResNet at CIFAR-10's 32 x 32, the transformer at 16 tokens
_RUNS = {
    "mnist": ("--batch_size", "2"),
    "vgg": ("--batch_size", "2"),
    "stacked_dynamic_lstm": ("--batch_size", "2"),
    "resnet": ("--batch_size", "2", "--data_set", "cifar10",
               "--layout", "NHWC"),
    "se_resnext": ("--batch_size", "1", "--layout", "NHWC",
                   "--iterations", "1"),
    "transformer": ("--batch_size", "2", "--seq_len", "16"),
    "machine_translation": ("--batch_size", "2"),
}


@pytest.mark.parametrize("model", sorted(_RUNS))
def test_every_ported_model_runs_on_the_cpu(model):
    record, detail = fb.benchmark(fb.parse_args(_cpu(model, *_RUNS[model])))
    assert JAX_KEYS <= set(record)
    assert ("layout" in record) == (model in ("resnet", "se_resnext"))
    assert record["model"] == model and record["device"] == "cpu"
    assert record["card"] == "cpu" and record["power_limit"] is None
    assert record["amp"] is False and record["parallel"] is False
    assert record["examples_per_sec"] > 0 and record["ms_per_step"] > 0
    assert np.isfinite(record["last_loss"])
    assert len(detail["step_s"]) == record["iterations"]
    assert not FLAGS.whole_graph_ad and not FLAGS.remat_policy


def test_device_loop_whole_graph_and_remat_land_in_the_record():
    record, _ = fb.benchmark(fb.parse_args(_cpu(
        "mnist", "--batch_size", "2", "--device_loop", "2",
        "--whole_graph_ad", "--remat_policy", "nothing")))
    assert record["device_loop"] == 2
    assert record["whole_graph_ad"] is True
    assert record["remat_policy"] == "nothing"
    assert record["iterations"] == 2
    assert not FLAGS.whole_graph_ad and not FLAGS.remat_policy


@pytest.mark.parametrize("model,extra", [
    ("stacked_dynamic_lstm", ()), ("stacked_dynamic_lstm", ("--seq_len",
                                                            "256")),
    ("vgg", ()), ("se_resnext", ("--layout", "NHWC"))],
    ids=["lstm", "lstm_len256", "vgg", "se_resnext"])
def test_synthetic_batches_are_the_jax_tools(model, extra):
    """The JAX tool's synth_feed and the port's give equal arrays and LoDs
    for the same seed; --seq_len S draws the LSTM's lengths from
    [S // 4, S]."""
    jtool = _jax_tool()
    args = fb.parse_args(["--model", model, "--batch_size", "4"]
                         + list(extra))
    main, _, feeds, _, _, _ = fb.build_model(args)
    tb = fb.synth_feed(feeds, 4, np.random.RandomState(0), program=main,
                       lengths=fb.lod_lengths(args))
    import paddle_tpu.fluid as jfluid
    from paddle_tpu import models  # noqa: F401
    jmod = importlib.import_module("paddle_tpu.models.%s" % model)
    kw = {"layout": "NHWC"} if model == "se_resnext" else {}
    with jfluid.unique_name.guard():
        jmain, _, jfeeds, _, _, _ = jmod.get_model(**kw)
    if args.seq_len:
        return _check_lengths(tb, args.seq_len)
    jb = jtool.synth_feed(jfeeds, 4, np.random.RandomState(0),
                          program=jmain)
    assert sorted(tb) == sorted(jb)
    for k in jb:
        np.testing.assert_array_equal(np.asarray(tb[k]), np.asarray(jb[k]))
        if hasattr(jb[k], "lod"):
            assert tb[k].lod() == jb[k].lod()


def test_machine_translation_target_and_label_share_lengths():
    """The label is the target shifted by one token (the reference's
    wmt14 reader): one draw of lengths serves both; the source draws its
    own."""
    args = fb.parse_args(["--model", "machine_translation",
                          "--batch_size", "6"])
    main, _, feeds, _, _, _ = fb.build_model(args)
    rng = np.random.RandomState(0)
    for _ in range(3):
        b = fb.synth_feed(feeds, 6, rng, program=main,
                          lengths=fb.lod_lengths(args),
                          same_lengths=fb._SAME_LENGTHS[args.model])
        lens = {k: v.recursive_sequence_lengths() for k, v in b.items()}
        assert lens["label_sequence"] == lens["target_sequence"]
        assert all(3 <= n <= 11 for n in lens["source_sequence"][0])


def _check_lengths(batch, seq_len):
    lens = batch["words"].recursive_sequence_lengths()[0]
    assert len(lens) == 4
    assert all(seq_len // 4 <= n <= seq_len for n in lens)


@pytest.mark.parametrize("extra", [
    # --parallel, nccl2 and the pipeline flags are ported: what still
    # raises beside them
    ("--parallel", "--update_method", "pserver"),
    ("--update_method", "pserver")],
    ids=["parallel", "pserver"])
def test_unported_flags_and_models_raise(extra):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        fb.benchmark(fb.parse_args(_cpu("mnist") + list(extra)))


@pytest.mark.parametrize("extra,keys", [
    (("--prefetch_depth", "2"), {"prefetch_depth": 2}),
    (("--async_depth", "2"), {"async_depth": 2}),
    (("--staged_feed", "2"), {"staged_feed": 2, "staged_transfer": True}),
    (("--prefetch_depth", "2", "--async_depth", "2", "--host_stall_ms",
      "1"), {"prefetch_depth": 2, "async_depth": 2, "host_stall_ms": 1.0}),
    (("--fetch_every", "2"), {})],
    ids=["prefetch_depth", "async_depth", "staged_feed", "pipelined",
         "fetch_every"])
def test_pipeline_flags_train_the_sync_trajectory(extra, keys):
    """The JAX tool's pipeline flags: the record says them, and the
    steps are the plain run's bit for bit (the same batches, the same
    order on one stream; staged batches repeat, so only their first
    loss is the plain run's)."""
    argv = _cpu("mnist") + ["--iterations", "3"]
    base, bd = fb.benchmark(fb.parse_args(argv))
    rec, d = fb.benchmark(fb.parse_args(argv + list(extra)))
    for k, v in keys.items():
        assert rec[k] == v, k
    assert set(keys) == set(rec) - set(base)
    if "--staged_feed" in extra:
        np.testing.assert_array_equal(d["losses"][0], bd["losses"][0])
    elif "--fetch_every" in extra:
        # one warm-up step, 3 timed: fetched at 0, 1 and the last, 3
        assert d["losses"] == [bd["losses"][i] for i in (0, 1, 3)]
    else:
        assert d["losses"] == bd["losses"]
        assert rec["last_loss"] == base["last_loss"]


def test_prefetch_and_staged_feed_are_exclusive():
    with pytest.raises(SystemExit, match="mutually exclusive"):
        fb.benchmark(fb.parse_args(_cpu("mnist") + [
            "--prefetch_depth", "2", "--staged_feed", "2"]))


def test_nccl2_with_async_depth_needs_a_trainer():
    """--update_method nccl2 with --async_depth is ported too: outside a
    launcher's environment it raises as nccl2 alone does."""
    with pytest.raises(RuntimeError, match="trainer process"):
        fb.benchmark(fb.parse_args(_cpu("mnist") + [
            "--update_method", "nccl2", "--async_depth", "2"]))


@pytest.mark.parametrize("extra", [("--parallel",),
                                   ("--update_method", "nccl2")],
                         ids=["parallel", "nccl2"])
def test_data_parallel_runs_need_a_trainers_environment(extra, monkeypatch):
    """benchmark() is one trainer's part: outside a launcher's
    environment it raises, naming what to set; the module's `--parallel`
    starts the trainers itself."""
    for k in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS", "PADDLE_COORDINATOR"):
        monkeypatch.delenv(k, raising=False)
    args = fb.parse_args(_cpu("mnist") + list(extra))
    with pytest.raises(RuntimeError, match="PADDLE_COORDINATOR"):
        fb.benchmark(args)
    if extra == ("--update_method", "nccl2"):
        with pytest.raises(RuntimeError, match="PADDLE_TRAINER_ID"):
            fb.main(_cpu("mnist") + list(extra))


def test_parallel_trains_on_cpu_num_trainers():
    """`--parallel --device CPU` with CPU_NUM=2: two gloo trainers, each
    on half of the global batch of 4; only trainer 0 prints its record,
    which says so.  `--trace_steps` adds the staged steps and trainer
    0's profile, with the host time inside the collectives' ranges."""
    env = dict(os.environ, PYTHONPATH=REPO, CPU_NUM="2")
    for k in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS", "PADDLE_COORDINATOR"):
        env.pop(k, None)
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.fluid_benchmark",
         "--model", "stacked_dynamic_lstm", "--device", "CPU",
         "--batch_size", "4", "--iterations", "2", "--parallel",
         "--trace_steps", "1"],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "starts 2 trainers" in out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    record = json.loads(lines[0])
    assert JAX_KEYS <= set(record)
    assert record["parallel"] is True and record["world"] == 2
    assert record["batch_size"] == 4 and np.isfinite(record["last_loss"])
    # a step's collectives: the gradient buckets, the loss mean and its
    # grad, accuracy's counts
    calls = {k: v["calls"] for k, v in record["collectives"].items()}
    # ~31 MB of fp32 gradients: two 25 MiB buckets
    assert calls == {"grad": 2.0, "mean": 1.0, "mean_grad": 1.0,
                     "accuracy": 1.0}
    assert record["grad_allreduce"]["buckets"] == 2
    assert record["staged"]["steps"] == 1
    assert record["staged"]["step_ms"] > 0
    trace = record["trace"]
    assert trace["busy_share"] is None and trace["groups_ms"] == {}
    assert {"grad buckets", "allreduce grad", "allreduce mean",
            "allreduce accuracy"} <= set(trace["host_ms"])
    assert trace["host_ms"]["grad buckets"] >= \
        trace["host_ms"]["allreduce grad"] > 0


def test_a_failed_trainer_fails_the_run():
    """A global batch that does not split over the trainers fails every
    trainer; the run exits non-zero and prints no record."""
    env = dict(os.environ, PYTHONPATH=REPO, CPU_NUM="2")
    for k in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS", "PADDLE_COORDINATOR"):
        env.pop(k, None)
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.fluid_benchmark",
         "--model", "mnist", "--device", "CPU", "--batch_size", "3",
         "--iterations", "1", "--parallel"],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO)
    assert out.returncode == 1
    assert "does not split over 2 trainers" in out.stderr
    assert "trainers failed" in out.stderr and out.stdout.strip() == ""


def test_the_card_is_the_default_and_never_falls_back():
    args = fb.parse_args(["--model", "mnist", "--batch_size", "2"])
    assert args.device == "GPU"
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fb.benchmark(args)


def test_module_prints_one_json_record():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.fluid_benchmark",
         "--model", "stacked_dynamic_lstm", "--device", "CPU",
         "--batch_size", "2", "--iterations", "2"],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    record = json.loads(lines[0])
    assert JAX_KEYS <= set(record) and record["device"] == "cpu"
