"""The async training pipeline of paddle_tpu_torch (fluid/pipeline.py,
reader.prefetch_to_device, Executor.run(as_future=True), the Trainer's
in-flight loop), the cases of the JAX package's tests/test_pipeline.py
on the CPU:

* prefetch_to_device: parity with the direct feed, bounded-depth
  backpressure, clean worker shutdown on early exit, worker death as
  ReaderWorkerFailed, a slow host hidden by the queue, and the
  data-parallel group mode (a 2-rank gloo world);
* FetchFuture / DispatchPipeline: results bit-equal to the sync run,
  one-shot resolution, the watchdog wrapping the drain;
* the Trainer's pipelined loop: the sync trajectory bit for bit at depth
  >= 2 with dropout (so the RNG step folds match), with prefetch too,
  checkpoints at flush boundaries, the depth-aware sentinel (skip and
  redispatch, rollback), deferred-drain test();
* no step writes a state tensor in place (sgd, momentum, adam), which
  the sentinel's snapshots and the async checkpoint saver rely on.

The cases marked `cuda` hold the prefetch queue's side-stream copies on
the card and skip here.  Every wait in this file is bounded.
"""

import os
import signal
import sys
import threading
import time
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import reader as reader_mod
from paddle_tpu_torch.flags import FLAGS
from paddle_tpu_torch.fluid import checkpoint as ckpt
from paddle_tpu_torch.fluid import functionalizer
from paddle_tpu_torch.fluid import sentinel as sentinel_mod
from paddle_tpu_torch.fluid.executor import StepWatchdogTimeout
from paddle_tpu_torch.fluid.pipeline import DispatchPipeline, FetchFuture
from paddle_tpu_torch.reader import ReaderWorkerFailed

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dp_worker as W  # noqa: E402

CPU = torch.device("cpu")
_FLAGS = ("async_dispatch_depth", "reader_prefetch_depth",
          "step_watchdog_secs", "sentinel_nan_check", "sentinel_policy",
          "sentinel_max_bad_steps", "check_nan_inf", "benchmark")


TEST_TIMEOUT_S = 300


@pytest.fixture(autouse=True)
def _per_test_timeout():
    """A SIGALRM bounds every test, whatever it waits on."""
    def _expired(signum, frame):
        raise TimeoutError("test exceeded %d s" % TEST_TIMEOUT_S)
    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(TEST_TIMEOUT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture(autouse=True)
def _reset_pipeline_flags():
    saved = {k: getattr(FLAGS, k) for k in _FLAGS}
    yield
    for k, v in saved.items():
        setattr(FLAGS, k, v)


def set_flags(**kw):
    for k, v in kw.items():
        setattr(FLAGS, k, v)


def slow_host_reader(reader, stall_ms):
    """Every batch costs `stall_ms` of host time before it is yielded."""
    def slowed():
        for item in reader():
            time.sleep(stall_ms / 1000.0)
            yield item
    return slowed


def nan_poison_reader(reader, poison_steps):
    """Batches at `poison_steps` get every float array replaced by NaN."""
    poison_steps = frozenset(poison_steps)

    def poisoned():
        for i, batch in enumerate(reader()):
            if i not in poison_steps:
                yield batch
                continue
            yield [tuple(np.full_like(np.asarray(p), np.nan)
                         if np.asarray(p).dtype.kind == "f"
                         else np.asarray(p) for p in sample)
                   for sample in batch]

    return poisoned


# ---------------------------------------------------------------------------
# prefetch_to_device
# ---------------------------------------------------------------------------

def test_prefetch_parity_and_device_staging():
    """Every item arrives, in order, and a dict's arrays arrive as
    tensors on the device."""
    def src():
        for i in range(16):
            yield {"x": np.full((3,), i, np.float32), "tag": i}

    out = list(reader_mod.prefetch_to_device(src, 3, device="cpu")())
    assert [o["tag"] for o in out] == list(range(16))
    for i, o in enumerate(out):
        assert isinstance(o["x"], torch.Tensor) and o["x"].device == CPU
        np.testing.assert_array_equal(o["x"].numpy(),
                                      np.full((3,), i, np.float32))


def test_prefetch_backpressure_bounded_depth():
    """A stalled consumer bounds the producer: at most depth (queued) + 1
    (in the worker's hand) + 1 (yielded) items are pulled."""
    pulled = []

    def src():
        for i in range(100):
            pulled.append(i)
            yield {"x": np.zeros(2, np.float32)}

    gen = reader_mod.prefetch_to_device(src, 2, device="cpu")()
    try:
        next(gen)
        deadline = time.time() + 2.0
        while time.time() < deadline and len(pulled) < 4:
            time.sleep(0.02)
        time.sleep(0.2)  # would overrun here if the bound leaked
        assert len(pulled) <= 4, \
            "prefetch ran %d items ahead of a stalled consumer" % len(pulled)
    finally:
        gen.close()


def test_prefetch_clean_shutdown_on_early_exit():
    """Closing the generator mid-epoch stops and joins the worker."""
    def src():
        i = 0
        while True:
            i += 1
            yield {"x": np.full((2,), i, np.float32)}

    gen = reader_mod.prefetch_to_device(src, 2, device="cpu")()
    next(gen)
    next(gen)
    gen.close()
    deadline = time.time() + 5.0
    while time.time() < deadline:
        alive = [t for t in threading.enumerate()
                 if t.name == "paddle-tpu-prefetch" and t.is_alive()]
        if not alive:
            break
        time.sleep(0.05)
    assert not alive, "prefetch worker leaked after generator close"


def test_prefetch_source_death_raises():
    def src():
        yield {"x": np.zeros(2, np.float32)}
        raise RuntimeError("shard read failed")

    gen = reader_mod.prefetch_to_device(src, 2, device="cpu")()
    next(gen)
    with pytest.raises(ReaderWorkerFailed) as ei:
        for _ in gen:
            pass
    assert "shard read failed" in str(ei.value)
    assert ei.value.cause_repr is not None


def test_prefetch_prepare_death_raises():
    def src():
        for _ in range(4):
            yield {"x": np.zeros(2, np.float32)}

    def bad_prepare(item):
        raise ValueError("prepare exploded")

    gen = reader_mod.prefetch_to_device(src, 2, prepare=bad_prepare,
                                        device="cpu")()
    with pytest.raises(ReaderWorkerFailed, match="prepare exploded"):
        list(gen)


def test_prefetch_hides_slow_host_stall():
    """A reader costing ~35 ms a batch fed to a consumer costing ~35 ms a
    step runs ~2x faster through the queue than directly."""
    stall_ms, n = 35.0, 8

    def src():
        for _ in range(n):
            yield {"x": np.zeros(4, np.float32)}

    slowed = slow_host_reader(src, stall_ms)

    def consume(creator):
        t0 = time.perf_counter()
        for _ in creator():
            time.sleep(stall_ms / 1000.0)  # the "device step"
        return time.perf_counter() - t0

    t_sync = consume(slowed)
    t_pre = consume(reader_mod.prefetch_to_device(slowed, 4, device="cpu"))
    assert t_pre < t_sync * 0.8, \
        "prefetch did not hide the host stall: %.3fs vs %.3fs" % (t_pre,
                                                                  t_sync)


def test_prefetch_defaults_to_the_card(monkeypatch):
    """The entry point runs on the card unless asked for the CPU: without
    CUDA it raises, never falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        reader_mod.prefetch_to_device(lambda: iter([]), 2)


def test_prefetch_group_mode_world_of_one(monkeypatch):
    """group= (a ParallelExecutor's group): a list of per-device dicts is
    merged as ParallelExecutor.run merges it and staged on the group's
    device, where the ParallelExecutor takes it as it is."""
    monkeypatch.setenv("CPU_NUM", "1")
    main, startup, loss, _ = W.mlp(fluid)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.Executor(fluid.CPUPlace()).run(startup)
    pe = fluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                main_program=main, scope=scope)
    batches = W.mlp_batches(steps=2)

    def src():
        for f in batches:
            yield [{k: v[:4] for k, v in f.items()},
                   {k: v[4:] for k, v in f.items()}]

    staged = list(reader_mod.prefetch_to_device(src, 2, group=pe.group)())
    for f, s in zip(batches, staged):
        assert set(s) == {"x", "y"} and s["x"].device == pe.group.device
        np.testing.assert_array_equal(s["x"].numpy(), f["x"])
        prepped = pe._exe._prepare_feeds(main, s)
        assert prepped["x"] is s["x"], "a staged feed was copied again"


def test_pe_pipeline_in_a_two_rank_world(tmp_path):
    """A 2-rank gloo world: the ParallelExecutor's losses and gathered
    predictions are the same bit for bit from sync run(),
    run(as_future=True) and batches staged by prefetch_to_device with the
    PE's group, which it takes without a second copy."""
    import json
    from paddle_tpu_torch.parallel import mesh
    main, startup, _, _ = W.mlp(fluid)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.Executor(fluid.CPUPlace()).run(startup)
    np.savez(str(tmp_path / "init_mlp.npz"), **{
        n: fluid.as_numpy(scope.get(n))
        for n in functionalizer.persistable_names(main)})
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "torch_dp_worker.py")
    results = mesh.launch([worker, "pipeline", str(tmp_path)], 2,
                          use_cuda=False, capture=True, timeout=240)
    for rank, (rc, _, err) in enumerate(results):
        assert rc == 0, "rank %d failed:\n%s" % (rank, err[-4000:])
    for rank in range(2):
        with np.load(str(tmp_path / ("rank%d_pipeline.npz" % rank))) as z:
            a = {k: z[k] for k in z.files}
        with open(str(tmp_path / ("rank%d_pipeline.json" % rank))) as f:
            msgs = json.load(f)
        assert msgs["future_type"] == "FetchFuture"
        assert msgs["staged_device"] == msgs["group_device"] == "cpu"
        assert msgs["taken_as_is"]
        assert a["preds_sync"].shape == (3, W.GLOBAL_BATCH, 1)
        for label in ("future", "prefetch"):
            np.testing.assert_array_equal(a["losses_" + label],
                                          a["losses_sync"])
            np.testing.assert_array_equal(a["preds_" + label],
                                          a["preds_sync"])


# ---------------------------------------------------------------------------
# FetchFuture / executor futures
# ---------------------------------------------------------------------------

def _build_net(opt="sgd", dropout=False):
    def train_func():
        x = fluid.layers.data("x", shape=[4], dtype="float32")
        y = fluid.layers.data("y", shape=[1], dtype="float32")
        h = x
        if dropout:
            h = fluid.layers.fc(x, size=8, act="relu")
            h = fluid.layers.dropout(h, dropout_prob=0.3)
        pred = fluid.layers.fc(h, size=1)
        return fluid.layers.mean(fluid.layers.square_error_cost(pred, y))

    def optimizer_func():
        if opt == "momentum":
            return fluid.optimizer.Momentum(learning_rate=0.05, momentum=0.9)
        if opt == "adam":
            return fluid.optimizer.Adam(learning_rate=0.01)
        return fluid.optimizer.SGD(learning_rate=0.05)

    return train_func, optimizer_func


def _build_program(opt="sgd"):
    train_func, optimizer_func = _build_net(opt)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss = train_func()
        optimizer_func().minimize(loss)
    return main, startup, loss


def _xy(batch=8):
    rng = np.random.RandomState(0)
    xs = rng.randn(batch, 4).astype(np.float32)
    return xs, xs.sum(axis=1, keepdims=True)


def test_executor_future_matches_sync_bit_exact():
    xs, ys = _xy()
    outs = []
    for as_future in (False, True):
        main, startup, loss = _build_program()
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(fluid.Scope()):
            exe.run(startup)
            got = [exe.run(main, feed={"x": xs, "y": ys},
                           fetch_list=[loss], as_future=as_future)
                   for _ in range(4)]
            if as_future:
                assert all(isinstance(f, FetchFuture) for f in got)
                assert all(f.ready() for f in got)  # no event on the CPU
                got = [f.result() for f in got]
        outs.append([g[0] for g in got])
    for a, b in zip(*outs):
        assert isinstance(b, np.ndarray)
        np.testing.assert_array_equal(a, b)


def test_future_without_numpy_keeps_tensors():
    xs, ys = _xy()
    main, startup, loss = _build_program()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fut = exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[loss],
                      return_numpy=False, as_future=True)
        val, = fut.result()
    assert isinstance(val, torch.Tensor) and torch.isfinite(val).all()


def test_fetch_future_resolves_once_and_caches():
    calls = []

    def post(vals, rn):
        calls.append(1)
        return list(vals)

    fut = FetchFuture([torch.tensor(3.0)], post=post)
    assert not fut.done()
    a = fut.result()
    b = fut.result()
    assert a is b and len(calls) == 1 and fut.done() and fut.ready()


def test_fetch_future_watchdog_wraps_drain():
    """The watchdog guards the drain: a resolve that wedges raises
    StepWatchdogTimeout out of result() instead of hanging the loop."""
    def wedged(vals, rn):
        time.sleep(5.0)
        return list(vals)

    set_flags(step_watchdog_secs=0.2)
    fut = FetchFuture([torch.tensor(1.0)], post=wedged, what="test drain")
    t0 = time.perf_counter()
    with pytest.raises(StepWatchdogTimeout):
        fut.result()
    assert time.perf_counter() - t0 < 3.0


def test_async_dispatch_skips_per_step_watchdog_sync():
    """With the watchdog set, an as_future dispatch runs on the caller's
    thread (the watchdog wraps the drain) and resolves afterwards."""
    xs, ys = _xy()
    main, startup, loss = _build_program()
    exe = fluid.Executor(fluid.CPUPlace())
    set_flags(step_watchdog_secs=30.0)
    seen = []
    run = functionalizer.build_step_fn

    def spy(*a, **kw):
        fn = run(*a, **kw)
        return lambda *b: (seen.append(threading.current_thread()),
                           fn(*b))[1]

    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        functionalizer.build_step_fn = spy
        try:
            fut = exe.run(main, feed={"x": xs, "y": ys},
                          fetch_list=[loss], as_future=True)
        finally:
            functionalizer.build_step_fn = run
        val = fut.result(watchdog_scale=2)[0]
    assert seen == [threading.current_thread()]
    assert np.isfinite(val).all()


def test_dispatch_pipeline_backpressure_and_flush():
    resolved = []

    def mk(i):
        return FetchFuture([torch.tensor(float(i))],
                           post=lambda vals, rn, i=i: resolved.append(i)
                           or [i])

    p = DispatchPipeline(2)
    drained = []
    for i in range(5):
        drained += p.submit(mk(i), step=i)
    # depth 2: submits 0..4 force drains of 0, 1, 2 (oldest first)
    assert [m["step"] for _, m in drained] == [0, 1, 2]
    assert resolved == [0, 1, 2] and len(p) == 2
    rest = p.drain_all()
    assert [m["step"] for _, m in rest] == [3, 4] and len(p) == 0
    assert p.drain() is None
    p2 = DispatchPipeline(3)
    p2.submit(mk(10))
    p2.submit(mk(11))
    dropped = p2.discard_inflight()
    assert len(dropped) == 2 and len(p2) == 0
    assert 10 not in resolved and 11 not in resolved


def test_parallel_executor_future_matches_sync(monkeypatch):
    """A world of one: PE as_future matches the sync return."""
    monkeypatch.setenv("CPU_NUM", "1")
    xs, ys = _xy(8)
    outs = []
    for as_future in (False, True):
        main, startup, loss = _build_program()
        with fluid.scope_guard(fluid.Scope()):
            fluid.Executor(fluid.CPUPlace()).run(startup)
            pe = fluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                        main_program=main)
            got = [pe.run([loss], feed={"x": xs, "y": ys},
                          as_future=as_future) for _ in range(3)]
            if as_future:
                got = [f.result() for f in got]
        outs.append([g[0] for g in got])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
def test_steps_never_write_state_in_place(opt):
    """Every optimizer lowering the Trainer reaches returns new tensors:
    after sync and in-flight steps each state tensor the step read still
    holds its values and its version counter, so a snapshot of references
    (the sentinel's pre/post, the async checkpoint saver) is exact."""
    xs, ys = _xy()
    main, startup, loss = _build_program(opt)
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()) as scope:
        exe.run(startup)
        names = functionalizer.persistable_names(main)
        before = {n: scope.get(n) for n in names if scope.get(n) is not None}
        versions = {n: t._version for n, t in before.items()}
        values = {n: t.clone() for n, t in before.items()}
        exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[loss])
        futs = [exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[loss],
                        as_future=True) for _ in range(2)]
        [f.result() for f in futs]
        changed = [n for n in before if scope.get(n) is not before[n]]
    assert changed, "no state moved"
    for n, t in before.items():
        assert t._version == versions[n], "%s was written in place" % n
        assert torch.equal(t, values[n]), "%s changed" % n


# ---------------------------------------------------------------------------
# the Trainer's pipelined loop
# ---------------------------------------------------------------------------

def _regression_data(n=10, seed=0):
    rng = np.random.RandomState(seed)
    return [(x, np.array([x.sum()], np.float32))
            for x in [rng.randn(4).astype(np.float32) for _ in range(n)]]


def _reader(data):
    def reader():
        for x, y in data:
            yield [(x, y)]
    return reader


def _run_trainer_pipeline(data, depth, prefetch=0, num_epochs=2,
                          dropout=True, ckpt_dir=None, step_interval=4):
    """Train in a fresh scope; returns (losses in EndStepEvent order,
    (epoch, step) ids, persistables)."""
    train_func, optimizer_func = _build_net(dropout=dropout)
    set_flags(async_dispatch_depth=depth, reader_prefetch_depth=prefetch)
    with fluid.scope_guard(fluid.Scope()) as scope:
        cfg = None
        if ckpt_dir is not None:
            cfg = fluid.contrib.CheckpointConfig(
                checkpoint_dir=ckpt_dir, step_interval=step_interval)
        trainer = fluid.contrib.Trainer(train_func, optimizer_func,
                                        place=fluid.CPUPlace(),
                                        checkpoint_config=cfg)
        losses, ids = [], []

        def handler(ev):
            if isinstance(ev, fluid.contrib.EndStepEvent):
                losses.append(np.asarray(ev.metrics[0]).copy())
                ids.append((ev.epoch, ev.step))

        trainer.train(num_epochs=num_epochs, event_handler=handler,
                      reader=_reader(data), feed_order=["x", "y"])
        names = functionalizer.persistable_names(trainer.train_program)
        params = {n: fluid.as_numpy(scope.get(n)) for n in names
                  if scope.get(n) is not None}
    return losses, ids, params


def test_trainer_async_trajectory_bit_exact():
    """Async (depth 3) reproduces the sync loss trajectory bit for bit,
    dropout included: the RNG step folds and the dispatch order match."""
    data = _regression_data()
    l0, ids0, p0 = _run_trainer_pipeline(data, depth=0)
    l3, ids3, p3 = _run_trainer_pipeline(data, depth=3)
    assert len(l0) == len(l3) == 2 * len(data)
    assert ids0 == ids3
    for i, (a, b) in enumerate(zip(l0, l3)):
        np.testing.assert_array_equal(a, b, err_msg="step %d" % i)
    for n in p0:
        np.testing.assert_array_equal(p0[n], p3[n], err_msg=n)


def test_trainer_async_plus_prefetch_trajectory_bit_exact():
    data = _regression_data()
    l0, _, p0 = _run_trainer_pipeline(data, depth=0)
    lp, _, pp = _run_trainer_pipeline(data, depth=2, prefetch=3)
    for a, b in zip(l0, lp):
        np.testing.assert_array_equal(a, b)
    for n in p0:
        np.testing.assert_array_equal(p0[n], pp[n])


def test_trainer_async_checkpoints_at_flush_boundaries(tmp_path):
    """Saves land at flush boundaries, the vault verifies, and the
    trajectory is unchanged by them."""
    data = _regression_data(8)
    l0, _, p0 = _run_trainer_pipeline(data, depth=0)
    vault = str(tmp_path / "vault")
    l3, _, p3 = _run_trainer_pipeline(data, depth=3, ckpt_dir=vault,
                                      step_interval=4)
    for a, b in zip(l0, l3):
        np.testing.assert_array_equal(a, b)
    for n in p0:
        np.testing.assert_array_equal(p0[n], p3[n])
    latest = ckpt.latest_checkpoint(vault)
    assert latest is not None
    meta = ckpt.normalize_meta(ckpt.verify_checkpoint_dir(latest)["meta"])
    assert meta["step"] >= 4
    # the RNG step fold travels with the checkpoint
    assert meta["rng_step"] == meta["step"]


def test_trainer_async_sentinel_skip_redispatches_inflight():
    """Depth-aware skip: the bad step reverts, the in-flight window is
    discarded unobserved and its batches redispatched; every batch still
    gets an EndStepEvent and the state stays finite."""
    data = _regression_data()
    poisoned = nan_poison_reader(_reader(data), poison_steps={4})
    train_func, optimizer_func = _build_net()
    set_flags(sentinel_nan_check=True, sentinel_policy="skip",
              sentinel_max_bad_steps=5, async_dispatch_depth=3)
    with fluid.scope_guard(fluid.Scope()) as scope:
        trainer = fluid.contrib.Trainer(train_func, optimizer_func,
                                        place=fluid.CPUPlace())
        steps = []

        def handler(ev):
            if isinstance(ev, fluid.contrib.EndStepEvent):
                steps.append(ev.step)

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            trainer.train(num_epochs=1, event_handler=handler,
                          reader=poisoned, feed_order=["x", "y"])
        msgs = [str(w.message) for w in caught]
        assert any("reverted" in m for m in msgs), msgs
        assert any("re-dispatched" in m for m in msgs), msgs
        assert sorted(steps) == list(range(len(data))), steps
        for n in functionalizer.persistable_names(trainer.train_program):
            v = scope.get(n)
            if v is not None:
                assert torch.isfinite(v).all(), n


def test_trainer_async_sentinel_skip_equals_a_run_without_the_batch():
    """The skipped batch leaves no trace: the state after a skip at depth
    2 equals, bit for bit, a run that never saw the batch (no dropout)."""
    data = _regression_data(8)
    poisoned = nan_poison_reader(_reader(data), poison_steps={3})
    clean = [d for i, d in enumerate(data) if i != 3]
    set_flags(sentinel_nan_check=True, sentinel_max_bad_steps=3)
    train_func, optimizer_func = _build_net()
    states = []
    for rd, depth in ((poisoned, 2), (_reader(clean), 0)):
        set_flags(async_dispatch_depth=depth)
        with fluid.scope_guard(fluid.Scope()) as scope:
            trainer = fluid.contrib.Trainer(train_func, optimizer_func,
                                            place=fluid.CPUPlace())
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                trainer.train(num_epochs=1, event_handler=lambda ev: None,
                              reader=rd, feed_order=["x", "y"])
            states.append({n: scope.get(n) for n in scope.keys()})
    assert sorted(states[0]) == sorted(states[1])
    for n in states[0]:
        assert torch.equal(states[0][n], states[1][n]), n


def test_trainer_async_sentinel_rollback(tmp_path):
    """With dispatch depth > 1 the sentinel still catches an injected NaN
    streak and rolls back to the last-good checkpoint."""
    data = _regression_data(12)
    poisoned = nan_poison_reader(_reader(data), poison_steps={5, 6})
    train_func, optimizer_func = _build_net()
    set_flags(sentinel_nan_check=True, sentinel_policy="rollback",
              sentinel_max_bad_steps=2, async_dispatch_depth=3)
    with fluid.scope_guard(fluid.Scope()) as scope:
        cfg = fluid.contrib.CheckpointConfig(
            checkpoint_dir=str(tmp_path / "vault"), step_interval=3)
        trainer = fluid.contrib.Trainer(train_func, optimizer_func,
                                        place=fluid.CPUPlace(),
                                        checkpoint_config=cfg)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            trainer.train(num_epochs=1, event_handler=lambda ev: None,
                          reader=poisoned, feed_order=["x", "y"])
        msgs = [str(w.message) for w in caught]
        assert any("reverted" in m for m in msgs), msgs
        assert any("rolled back" in m for m in msgs), msgs
        for n in functionalizer.persistable_names(trainer.train_program):
            v = scope.get(n)
            if v is not None:
                assert torch.isfinite(v).all(), n


def test_trainer_test_deferred_drain_parity():
    """Trainer.test rides the deferred-drain path: the async depth
    changes nothing in its result."""
    data = _regression_data(6)

    def eval_once(depth):
        train_func, optimizer_func = _build_net()
        set_flags(async_dispatch_depth=depth)
        with fluid.scope_guard(fluid.Scope()):
            trainer = fluid.contrib.Trainer(train_func, optimizer_func,
                                            place=fluid.CPUPlace())
            return trainer.test(_reader(data), feed_order=["x", "y"])

    base = eval_once(0)
    deferred = eval_once(3)
    assert len(base) == len(deferred) == 1
    np.testing.assert_array_equal(base[0], deferred[0])


def test_sentinel_depth_bookkeeping():
    s = sentinel_mod.AnomalySentinel(max_bad_steps=3, policy="skip",
                                     pipeline_depth=4)
    assert s.pipeline_depth == 4
    assert s.observe([("loss", np.float32(1.0))], step=0) == sentinel_mod.OK
    assert s.last_step_observed == 0 and s.steps_observed == 1
    assert s.observe([("loss", torch.tensor(float("nan")))], step=1) == \
        sentinel_mod.SKIP
    assert s.note_inflight_discarded(3) == 3
    assert s.total_discarded == 3 and s.max_observe_lag == 3
    # discards never touch the consecutive-bad streak
    assert s.consecutive_bad == 1
    assert s.observe([("loss", np.float32(1.0))], step=2) == sentinel_mod.OK
    assert s.consecutive_bad == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_cuda_prefetch_lands_on_the_ranks_card():
    """The batch lands on the device asked for (the last card, as a rank's
    would be), although the worker thread starts on card 0."""
    _need_card()
    dev = torch.device("cuda", torch.cuda.device_count() - 1)

    def src():
        for i in range(4):
            yield {"x": np.full((64, 64), i, np.float32)}

    out = list(reader_mod.prefetch_to_device(src, 2, device=dev)())
    for i, o in enumerate(out):
        assert o["x"].device == dev
        assert torch.equal(o["x"].cpu(), torch.full((64, 64), float(i)))


@pytest.mark.cuda
def test_cuda_pinned_source_is_copied_without_a_host_sync():
    """A pinned source (and a pageable one, which the worker pins first)
    is copied non-blocking: consuming the queue under
    set_sync_debug_mode("error") raises nothing."""
    _need_card()
    dev = torch.device("cuda")
    host = [torch.randn(256, 256).pin_memory() for _ in range(4)]
    pageable = [np.random.RandomState(i).randn(256, 256).astype(np.float32)
                for i in range(4)]

    def src():
        for h, p in zip(host, pageable):
            yield {"pinned": h, "pageable": p}

    gen = reader_mod.prefetch_to_device(src, 2, device=dev)()
    got = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for item in gen:
            got.append(item)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for item, h, p in zip(got, host, pageable):
        assert torch.equal(item["pinned"].cpu(), h)
        assert torch.equal(item["pageable"].cpu(), torch.from_numpy(p))


@pytest.mark.cuda
def test_cuda_prefetch_equals_a_sync_copy_under_a_busy_stream():
    """With the compute stream kept busy (a spin kernel before every
    step), every prefetched batch read by the step equals a synchronous
    copy of it: the step's stream waits on the copy event, and the
    allocator does not reuse a batch's memory while the step reads it."""
    _need_card()
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    host = [rng.randn(1024, 1024).astype(np.float32) for _ in range(12)]

    def src():
        for h in host:
            yield {"x": h}

    results = []
    for item in reader_mod.prefetch_to_device(src, 3, device=dev)():
        torch.cuda._sleep(2_000_000)  # ~1 ms of a busy compute stream
        results.append((item["x"] * 2.0).sum(dim=0))
    torch.cuda.synchronize()
    for got, h in zip(results, host):
        want = (torch.from_numpy(h).to(dev) * 2.0).sum(dim=0)
        assert torch.equal(got, want)
