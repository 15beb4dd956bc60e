"""The reader pipeline of paddle_tpu_torch (fluid/reader.py PyReader and
the reader layers of fluid/layers/io.py) on the CPU: a small regression
net trained through py_reader (with and without the double buffer),
create_py_reader_by_data and open_files over a RecordIO file gives the
losses of direct feeds bit for bit, and the JAX package's py_reader
losses within 1e-5; end of data, reset and restart; a reset while the
worker is blocked on a full queue or inside an endless provider ends
the thread (asserted by `is_alive()` after reset, never by sleeping);
a provider that raises reaches the consumer; shuffle keeps the
multiset; Preprocessor's ops transform the reader's vars; batch stacks
samples; random_data_generator's shapes and range; a double buffer on
the card raises on a host without CUDA rather than stage on the host.
The `cuda` case stages the batches on the card and checks the losses
against the CPU."""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.reader import ReaderWorkerFailed

BATCHES = 5
SHAPES = [(-1, 13), (-1, 1)]
DTYPES = ["float32", "float32"]


def _batches():
    rng = np.random.RandomState(7)
    w = rng.randn(13, 1).astype(np.float32)
    out = []
    for _ in range(BATCHES):
        x = rng.randn(8, 13).astype(np.float32)
        out.append((x, (x @ w + 0.1 * rng.randn(8, 1)).astype(np.float32)))
    return out


def _net(fluid, how, path=None):
    """(main, startup, loss, reader, [x, y]): fc regression with SGD,
    its inputs made by `how`: "data" (plain feeds), "py_reader",
    "by_data" (create_py_reader_by_data over the data vars) or
    "open_files" (over the RecordIO file `path`)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    reader = None
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        if how == "py_reader":
            reader = L.py_reader(capacity=4, shapes=SHAPES, dtypes=DTYPES,
                                 name="uci")
            x, y = L.read_file(reader)
        elif how == "open_files":
            reader = L.open_files([path], shapes=SHAPES, lod_levels=[0, 0],
                                  dtypes=DTYPES)
            x, y = L.read_file(reader)
        else:
            x = L.data("x", shape=[13], dtype="float32")
            y = L.data("y", shape=[1], dtype="float32")
            if how == "by_data":
                reader = L.create_py_reader_by_data(4, [x, y])
        pred = L.fc(x, size=1)
        loss = L.mean(L.square_error_cost(input=pred, label=y))
        fluid.optimizer.SGD(learning_rate=0.01).minimize(loss)
    return main, startup, loss, reader, [x, y]


def _init():
    main, startup, _, _, _ = _net(tfluid, "data")
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        tfluid.Executor(tfluid.CPUPlace()).run(startup)
    return {n: tfluid.as_numpy(scope.get(n)) for n in scope.keys()}


def _train(how, init, passes=2, place=None, double_buffer=True,
           path=None, fluid=tfluid):
    """The losses of `passes` passes over the batches, from `init`."""
    place = place or fluid.CPUPlace()
    main, _, loss, reader, (x, y) = _net(fluid, how, path)
    exe = fluid.Executor(place)
    if fluid is tfluid:
        scope = tfluid.scope_from_jax(init, tfluid.Scope(), place)
    else:
        scope = fluid.Scope()
        for n, v in init.items():
            scope.set(n, v)
    losses = []

    def run(feed):
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        losses.append(float(np.asarray(out).ravel()[0]))

    if reader is None:
        for _ in range(passes):
            for xb, yb in _batches():
                run({x.name: xb, y.name: yb})
        return losses
    if how != "open_files":
        reader.decorate_paddle_reader(lambda: iter(_batches()))
    if fluid is tfluid:
        if double_buffer:
            tfluid.layers.double_buffer(reader, place=place)
        else:
            reader.use_double_buffer = False
    for _ in range(passes):
        reader.start()
        for feed in reader:
            run(feed)
        reader.reset()
        if fluid is tfluid:
            assert reader.thread is None
    return losses


@pytest.fixture(scope="module")
def direct():
    init = _init()
    return init, _train("data", init)


@pytest.mark.parametrize("how,double_buffer", [
    ("py_reader", True), ("py_reader", False), ("by_data", True)],
    ids=["py_reader", "py_reader_no_double_buffer", "by_data"])
def test_reader_losses_are_the_direct_feeds(direct, how, double_buffer):
    init, want = direct
    got = _train(how, init, double_buffer=double_buffer)
    assert len(got) == 2 * BATCHES
    assert got == want


def test_open_files_losses_are_the_direct_feeds(direct, tmp_path):
    init, want = direct
    path = str(tmp_path / "uci.rio")
    tfluid.recordio_writer.convert_reader_to_recordio_file(
        path, lambda: iter(_batches()))
    assert _train("open_files", init, path=path) == want


def test_py_reader_losses_match_jax(direct):
    init, want = direct
    jinit = {n: np.asarray(v) for n, v in init.items()}
    got = _train("py_reader", jinit, fluid=jfluid)
    np.testing.assert_allclose(want, got, rtol=1e-5, atol=1e-6)


def _reader(provider, capacity=4):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        r = tfluid.layers.py_reader(capacity=capacity, shapes=[(-1, 2)],
                                    dtypes=["float32"],
                                    use_double_buffer=False)
    r.decorate_paddle_reader(provider)
    return r


def test_end_of_data_reset_and_restart():
    r = _reader(lambda: ((np.full((1, 2), i, np.float32),)
                         for i in range(3)))
    with pytest.raises(RuntimeError, match="start"):
        r.next_feed()
    for _ in range(2):
        r.start()
        got = [float(f[r.feed_vars[0].name][0, 0]) for f in r]
        assert got == [0.0, 1.0, 2.0]
        with pytest.raises(StopIteration):
            r.next_feed()
        with pytest.raises(RuntimeError, match="reset"):
            r.start()
        thread = r.thread
        r.reset()
        assert not thread.is_alive()


def test_reset_ends_a_worker_blocked_on_a_full_queue():
    r = _reader(lambda: ((np.zeros((1, 2), np.float32),)
                         for _ in range(100)), capacity=1)
    r.start()
    r.next_feed()
    thread = r.thread
    r.reset()
    assert not thread.is_alive()


def test_reset_ends_an_endless_provider():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        r = tfluid.layers.random_data_generator(-1.0, 1.0,
                                                shapes=[[3, 4], [3, 1]],
                                                lod_levels=[0, 0])
    r.start()
    feeds = [r.next_feed() for _ in range(3)]
    thread = r.thread
    r.reset()
    assert not thread.is_alive()
    names = [v.name for v in r.output_vars]
    for f in feeds:
        assert f[names[0]].shape == (3, 4) and f[names[1]].shape == (3, 1)
        assert f[names[0]].dtype == np.float32
        assert (np.abs(f[names[0]]) <= 1.0).all()


def test_a_provider_that_raises_reaches_the_consumer():
    def provider():
        yield (np.zeros((1, 2), np.float32),)
        raise ValueError("bad batch file")

    r = _reader(provider)
    r.start()
    r.next_feed()
    with pytest.raises(ReaderWorkerFailed, match="bad batch file"):
        r.next_feed()
    r.reset()


def test_shuffle_keeps_the_multiset(tmp_path):
    path = str(tmp_path / "s.rio")
    tfluid.recordio_writer.convert_reader_to_recordio_file(
        path, lambda: ((np.full((2,), i, np.float32),) for i in range(6)))
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        reader = tfluid.layers.open_files([path], shapes=[[-1, 2]],
                                          lod_levels=[0],
                                          dtypes=["float32"])
        reader = tfluid.layers.shuffle(reader, buffer_size=6)
        out = tfluid.layers.scale(reader.output_vars[0], scale=1.0)
    exe = tfluid.Executor(tfluid.CPUPlace())
    reader.start()
    seen = [float(np.asarray(exe.run(main, feed=f, fetch_list=[out],
                                     scope=tfluid.Scope())[0]).ravel()[0])
            for f in reader]
    reader.reset()
    assert sorted(seen) == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]


def test_preprocessor_transforms_the_reader_vars():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        reader = tfluid.layers.py_reader(capacity=2, shapes=[(-1, 3)],
                                         dtypes=["float32"],
                                         use_double_buffer=False)
        p = tfluid.layers.Preprocessor(reader)
        with p.block():
            x, = p.inputs()
            p.outputs(tfluid.layers.scale(x, scale=3.0))
        y, = tfluid.layers.read_file(p())
        out = tfluid.layers.elementwise_add(y, y)
    reader.decorate_paddle_reader(
        lambda: iter([(np.ones((2, 3), np.float32),)]))
    reader.start()
    feed = reader.next_feed()
    got, = tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed=feed, fetch_list=[out], scope=tfluid.Scope())
    reader.reset()
    np.testing.assert_array_equal(got, np.full((2, 3), 6.0, np.float32))


def test_batch_stacks_samples():
    r = _reader(lambda: ((np.full((2,), i, np.float32),) for i in range(5)))
    tfluid.layers.batch(r, 2)
    r.start()
    got = [f[r.feed_vars[0].name] for f in r]
    r.reset()
    assert [g.shape for g in got] == [(2, 2), (2, 2), (1, 2)]
    assert got[1][:, 0].tolist() == [2.0, 3.0]


def test_a_card_double_buffer_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("the host has a card")
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        r = tfluid.layers.py_reader(capacity=2, shapes=[(-1, 2)],
                                    dtypes=["float32"])
    r.decorate_paddle_reader(lambda: iter([]))
    with pytest.raises(RuntimeError, match="CUDA"):
        r.start()
    assert r.thread is None


@pytest.mark.cuda
def test_cuda_double_buffer_stages_on_the_card(direct):
    """The double buffer hands the Executor feeds already on the card
    (the reader's thread staged them), and the losses are the CPU's
    within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    init, want = direct
    main, _, loss, reader, _ = _net(tfluid, "py_reader")
    reader.decorate_paddle_reader(lambda: iter(_batches()))
    tfluid.layers.double_buffer(reader)
    reader.start()
    feeds = list(reader)
    reader.reset()
    assert all(v.is_cuda for f in feeds for v in f.values())
    got = _train("py_reader", init, place=tfluid.CUDAPlace(0))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
