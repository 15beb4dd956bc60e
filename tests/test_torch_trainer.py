"""fluid.contrib.Trainer and Inferencer of paddle_tpu_torch on the CPU,
held against the JAX package's: the events and checkpointing of
tests/test_contrib.py::test_trainer_events_and_checkpoint; the same
losses as the JAX Trainer over 5 steps (rtol 1e-5, the absolute floor
1e-5 times the largest loss) from one startup state carried across with
fluid.scope_from_jax, sync, in flight and with prefetch; the card as the
default place; save_params read back by the Inferencer;
save_inference_model; the Executor's check_nan_inf and benchmark modes;
stop() under async dispatch and the train spans.
"""

import os
import signal

import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.flags import FLAGS
from paddle_tpu_torch.obs import tracing

_FLAGS = ("async_dispatch_depth", "reader_prefetch_depth", "check_nan_inf",
          "benchmark")
RTOL = 1e-5


TEST_TIMEOUT_S = 240


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
def _reset_flags():
    saved = {k: getattr(FLAGS, k) for k in _FLAGS}
    yield
    for k, v in saved.items():
        setattr(FLAGS, k, v)


def _net(pkg, hidden=0, opt="sgd"):
    def train_func():
        x = pkg.layers.data("x", shape=[4], dtype="float32")
        y = pkg.layers.data("y", shape=[1], dtype="float32")
        h = pkg.layers.fc(x, size=hidden, act="relu") if hidden else x
        pred = pkg.layers.fc(h, size=1)
        return pkg.layers.mean(pkg.layers.square_error_cost(pred, y))

    def optimizer_func():
        if opt == "adam":
            return pkg.optimizer.Adam(learning_rate=0.01)
        return pkg.optimizer.SGD(learning_rate=0.05)

    return train_func, optimizer_func


def _data(n, seed=0):
    rng = np.random.RandomState(seed)
    return [(x, np.array([x.sum()], np.float32))
            for x in [rng.randn(4).astype(np.float32) for _ in range(n)]]


def _reader(data):
    def reader():
        for x, y in data:
            yield [(x, y)]
    return reader


def test_trainer_events_and_checkpoint(tmp_path):
    data = _data(8)
    train_func, optimizer_func = _net(fluid)
    ckpt_dir = str(tmp_path / "ckpt")
    cfg = fluid.contrib.CheckpointConfig(checkpoint_dir=ckpt_dir,
                                         step_interval=4)
    with fluid.scope_guard(fluid.Scope()):
        trainer = fluid.contrib.Trainer(train_func, optimizer_func,
                                        place=fluid.CPUPlace(),
                                        checkpoint_config=cfg)
        events, losses = [], []

        def handler(ev):
            events.append(type(ev).__name__)
            if isinstance(ev, fluid.contrib.EndStepEvent):
                losses.append(float(np.asarray(ev.metrics[0]).ravel()[0]))

        trainer.train(num_epochs=2, event_handler=handler,
                      reader=_reader(data), feed_order=["x", "y"])
    assert events[:2] == ["BeginEpochEvent", "BeginStepEvent"]
    assert events.count("EndStepEvent") == 16
    assert events[-1] == "EndEpochEvent"
    assert losses[-1] < losses[0]
    assert os.path.isdir(ckpt_dir)
    with fluid.scope_guard(fluid.Scope()):
        t2 = fluid.contrib.Trainer(
            train_func, optimizer_func, place=fluid.CPUPlace(),
            checkpoint_config=fluid.contrib.CheckpointConfig(
                checkpoint_dir=ckpt_dir))
    assert t2.checkpoint_cfg.step_id == 16 and \
        t2.checkpoint_cfg.epoch_id == 2


def _jax_trainer_losses(data, hidden, opt):
    import paddle_tpu.fluid as jfluid
    train_func, optimizer_func = _net(jfluid, hidden, opt)
    with jfluid.scope_guard(jfluid.Scope()) as js:
        tr = jfluid.contrib.Trainer(train_func, optimizer_func,
                                    place=jfluid.CPUPlace())
        init = {n: np.asarray(js.get(n)) for n in js.keys()
                if js.get(n) is not None}
        losses = []
        tr.train(1, lambda ev: losses.append(
            float(np.asarray(ev.metrics[0]).ravel()[0]))
            if isinstance(ev, jfluid.contrib.EndStepEvent) else None,
            reader=_reader(data), feed_order=["x", "y"])
    return init, losses


@pytest.mark.parametrize("depth,prefetch", [(0, 0), (2, 0), (2, 2)],
                         ids=["sync", "async", "async-prefetch"])
def test_trainer_matches_the_jax_trainer(depth, prefetch):
    """5 steps of the same net (fc-relu-fc, Adam) from the JAX Trainer's
    startup state on the same seeded batches: the port's losses at rtol
    1e-5 with the absolute floor scaled by the largest loss."""
    data = _data(5)
    init, want = _jax_trainer_losses(data, hidden=8, opt="adam")
    FLAGS.async_dispatch_depth = depth
    FLAGS.reader_prefetch_depth = prefetch
    train_func, optimizer_func = _net(fluid, 8, "adam")
    with fluid.scope_guard(fluid.Scope()) as scope:
        tr = fluid.contrib.Trainer(train_func, optimizer_func,
                                   place=fluid.CPUPlace())
        assert set(scope.keys()) == set(init)
        fluid.scope_from_jax(init, scope=scope, place=fluid.CPUPlace())
        got = []
        tr.train(1, lambda ev: got.append(
            float(np.asarray(ev.metrics[0]).ravel()[0]))
            if isinstance(ev, fluid.contrib.EndStepEvent) else None,
            reader=_reader(data), feed_order=["x", "y"])
    assert len(got) == len(want) == 5
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * max(abs(v) for v in want))


def test_trainer_default_place_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    train_func, optimizer_func = _net(fluid)
    with fluid.scope_guard(fluid.Scope()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fluid.contrib.Trainer(train_func, optimizer_func)


def test_save_params_then_the_inferencer_predicts(tmp_path):
    """Inferencer rebuilds the topology, loads what Trainer.save_params
    wrote, and predicts what the trained program predicts."""
    data = _data(6)
    train_func, optimizer_func = _net(fluid, hidden=8)

    def infer_func():
        x = fluid.layers.data("x", shape=[4], dtype="float32")
        h = fluid.layers.fc(x, size=8, act="relu")
        return fluid.layers.fc(h, size=1)

    xs = np.stack([x for x, _ in data])
    with fluid.scope_guard(fluid.Scope()) as scope:
        tr = fluid.contrib.Trainer(train_func, optimizer_func,
                                   place=fluid.CPUPlace())
        tr.train(1, lambda ev: None, reader=_reader(data),
                 feed_order=["x", "y"])
        tr.save_params(str(tmp_path / "params"))
        w = {p.name: fluid.as_numpy(scope.get(p.name))
             for p in tr.train_program.all_parameters()}
    inf = fluid.contrib.Inferencer(infer_func, str(tmp_path / "params"),
                                   place=fluid.CPUPlace())
    out, = inf.infer({"x": xs})
    assert sorted(w) == ["fc_0.b_0", "fc_0.w_0", "fc_1.b_0", "fc_1.w_0"]
    h = np.maximum(xs @ w["fc_0.w_0"] + w["fc_0.b_0"], 0)
    np.testing.assert_allclose(out, h @ w["fc_1.w_0"] + w["fc_1.b_0"],
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        inf.infer(xs)


def test_trainer_save_inference_model(tmp_path):
    train_func, optimizer_func = _net(fluid)
    with fluid.scope_guard(fluid.Scope()):
        tr = fluid.contrib.Trainer(train_func, optimizer_func,
                                   place=fluid.CPUPlace())
        tr.save_inference_model(str(tmp_path / "m"), ["x", "y"], [0])
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        prog, feeds, fetches = fluid.load_inference_model(
            str(tmp_path / "m"), exe)
        xs = np.ones((3, 4), np.float32)
        loss, = exe.run(prog, feed={"x": xs, "y": np.zeros((3, 1),
                                                           np.float32)},
                        fetch_list=fetches)
    assert feeds == ["x", "y"] and np.isfinite(loss).all()


def _program():
    train_func, optimizer_func = _net(fluid)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss = train_func()
        optimizer_func().minimize(loss)
    return main, startup, loss


def test_check_nan_inf_names_the_bad_values():
    FLAGS.check_nan_inf = True
    main, startup, loss = _program()
    exe = fluid.Executor(fluid.CPUPlace())
    xs = np.ones((2, 4), np.float32)
    with fluid.scope_guard(fluid.Scope()) as scope:
        exe.run(startup)
        fut = exe.run(main, feed={"x": xs, "y": np.ones((2, 1), np.float32)},
                      fetch_list=[loss], as_future=True)
        assert fut.done()  # the mode resolved it already
        before = dict((n, scope.get(n)) for n in scope.keys())
        with pytest.raises(FloatingPointError, match=loss.name):
            exe.run(main, feed={"x": xs * np.nan,
                                "y": np.ones((2, 1), np.float32)},
                    fetch_list=[loss])
        # the bad step's state never reached the scope
        assert all(scope.get(n) is v for n, v in before.items())
        with pytest.raises(RuntimeError, match="check_nan_inf"):
            exe.run_loop(main, feed={"x": xs, "y": xs[:, :1]},
                         fetch_list=[loss], steps=2)


def test_benchmark_mode_returns_a_resolved_future():
    FLAGS.benchmark = True
    main, startup, loss = _program()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fut = exe.run(main, feed={"x": np.ones((2, 4), np.float32),
                                  "y": np.ones((2, 1), np.float32)},
                      fetch_list=[loss], as_future=True)
    assert fut.done() and np.isfinite(fut.result()[0]).all()


def test_trainer_stop_lands_within_the_window_and_spans_are_traced():
    """stop() under async dispatch: the in-flight window still drains (its
    events fire), and the loop's dispatch and drain spans are traced."""
    FLAGS.async_dispatch_depth = 2
    tracing.clear()
    train_func, optimizer_func = _net(fluid)
    with fluid.scope_guard(fluid.Scope()):
        tr = fluid.contrib.Trainer(train_func, optimizer_func,
                                   place=fluid.CPUPlace())
        steps = []

        def handler(ev):
            if isinstance(ev, fluid.contrib.EndStepEvent):
                steps.append(ev.step)
                if ev.step == 1:
                    tr.stop()

        tr.train(1, handler, reader=_reader(_data(10)),
                 feed_order=["x", "y"])
    assert steps == list(range(len(steps))) and 2 <= len(steps) <= 4
    names = {s["name"] for s in tracing.recent_spans(kind="train")}
    assert {"train/dispatch", "train/drain"} <= names
