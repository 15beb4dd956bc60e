"""The fault-tolerant runtime of paddle_tpu_torch on the CPU, the cases of
the JAX package's tests/test_fault_tolerance.py that apply to the port:

* the checkpoint vault (fluid/checkpoint.py): meta schema, rotation and
  the `latest` pointer, CRC rejection naming the array, interrupted
  saves (in process at every pre-commit point, and a real SIGKILL of a
  paused child), the async saver;
* the vault across packages: a checkpoint of either package loads in
  the other, byte for byte the same files; bfloat16 written as the JAX
  package writes it and read back as bfloat16;
* the Trainer's resume (exact mid-epoch, dropout masks included), the
  anomaly sentinel's state machine and policies, the step watchdog;
* the reader decorators and their worker-death handling;
* the flight recorder (obs/flightrec.py): its bundles pass the JAX
  package's validate_bundle; the watchdog, the sentinel and an SLO
  breach fire it; cooldown, rotation and the stale-tmp sweep.

Every subprocess and wait here is bounded.
"""

import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
import paddle_tpu_torch.reader as rd
from paddle_tpu_torch.flags import FLAGS
from paddle_tpu_torch.fluid import checkpoint as ckpt
from paddle_tpu_torch.fluid import functionalizer
from paddle_tpu_torch.fluid import io as fluid_io
from paddle_tpu_torch.fluid import sentinel as sentinel_mod
from paddle_tpu_torch.fluid.executor import StepWatchdogTimeout, \
    _watchdog_call
from paddle_tpu_torch.obs import flightrec
from paddle_tpu_torch.utils.retry import RetryPolicy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FLAGS = ("sentinel_nan_check", "sentinel_policy", "sentinel_max_bad_steps",
          "step_watchdog_secs", "flight_dir", "flight_keep",
          "flight_cooldown_s", "async_dispatch_depth")


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


def _build_net(dropout=False):
    def train_func():
        x = fluid.layers.data("x", shape=[4], dtype="float32")
        y = fluid.layers.data("y", shape=[1], dtype="float32")
        h = x
        if dropout:
            h = fluid.layers.dropout(fluid.layers.fc(x, size=8, act="relu"),
                                     dropout_prob=0.3)
        pred = fluid.layers.fc(h, size=1)
        return fluid.layers.mean(fluid.layers.square_error_cost(pred, y))

    def optimizer_func():
        return fluid.optimizer.SGD(learning_rate=0.05)

    return train_func, optimizer_func


def _small_program():
    train_func, optimizer_func = _build_net()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss = train_func()
        optimizer_func().minimize(loss)
    return main, startup, loss


def _data(n, seed=0):
    rng = np.random.RandomState(seed)
    return [(x, np.array([x.sum()], np.float32))
            for x in [rng.randn(4).astype(np.float32) for _ in range(n)]]


def _reader(data):
    def reader():
        for x, y in data:
            yield [(x, y)]
    return reader


def nan_poison_reader(reader, poison_steps):
    poison_steps = frozenset(poison_steps)

    def poisoned():
        for i, batch in enumerate(reader()):
            if i in poison_steps:
                batch = [tuple(np.full_like(np.asarray(p), np.nan)
                               for p in sample) for sample in batch]
            yield batch

    return poisoned


def bit_flip(path, bit=3):
    with open(path, "rb") as f:
        raw = bytearray(f.read())
    raw[len(raw) // 2] ^= (1 << bit)
    with open(path, "wb") as f:
        f.write(raw)


# ---------------------------------------------------------------------------
# vault: layout, meta schema, rotation
# ---------------------------------------------------------------------------

def test_checkpoint_meta_roundtrip_int_step(tmp_path):
    root = str(tmp_path / "vault")
    with fluid.scope_guard(fluid.Scope()):
        main, startup, _ = _small_program()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        written = fluid_io.save_checkpoint(exe, root, main_program=main,
                                           step=7)
        assert written == {"epoch": 0, "step": 7}
        meta = fluid_io.load_checkpoint(exe, root, main_program=main)
    assert meta == {"epoch": 0, "step": 7}


def test_checkpoint_meta_legacy_layout(tmp_path):
    """Pre-vault flat checkpoints (npz + __meta__.json) still load,
    normalized to the canonical schema."""
    d = str(tmp_path)
    with fluid.scope_guard(fluid.Scope()):
        main, startup, _ = _small_program()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        fluid_io.save_persistables(exe, d, main,
                                   filename="__checkpoint__.npz")
        with open(os.path.join(d, "__meta__.json"), "w") as f:
            json.dump({"step": 5}, f)
        assert fluid_io.load_checkpoint(exe, d, main) == \
            {"epoch": 0, "step": 5}
        with open(os.path.join(d, "__meta__.json"), "w") as f:
            json.dump({"step": {"epoch": 1, "step": 9}}, f)
        meta = fluid_io.load_checkpoint(exe, d, main)
    assert meta["epoch"] == 1 and meta["step"] == 9


def test_vault_rotation_and_latest(tmp_path):
    root = str(tmp_path)
    arrays = {"w": torch.arange(4, dtype=torch.float32)}
    for s in range(1, 6):
        ckpt.save_checkpoint_dir(root, arrays, {"epoch": 0, "step": s},
                                 max_num_checkpoints=2)
    assert [s for s, _ in ckpt.list_checkpoints(root)] == [4, 5]
    assert ckpt.latest_checkpoint(root).endswith("checkpoint_5")
    with open(os.path.join(root, ckpt.LATEST_NAME)) as f:
        assert f.read().strip() == "checkpoint_5"


def test_empty_dir_raises_filenotfound(tmp_path):
    with fluid.scope_guard(fluid.Scope()):
        main, startup, _ = _small_program()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        with pytest.raises(FileNotFoundError):
            fluid_io.load_checkpoint(exe, str(tmp_path), main)


# ---------------------------------------------------------------------------
# vault: corruption and crash atomicity
# ---------------------------------------------------------------------------

def test_bit_flip_rejected_naming_array(tmp_path):
    root = str(tmp_path)
    arrays = {"fc_w": np.arange(24, dtype=np.float32).reshape(4, 6),
              "fc_b": np.ones(6, np.float32)}
    path = ckpt.save_checkpoint_dir(root, arrays, {"epoch": 0, "step": 1})
    ent = ckpt.read_manifest(path)["arrays"]["fc_w"]
    bit_flip(os.path.join(path, ent["file"]))
    with pytest.raises(ckpt.CheckpointCorruptionError, match="fc_w"):
        ckpt.load_checkpoint_dir(path)
    arrays2, _ = ckpt.load_checkpoint_dir(path, names={"fc_b"})
    np.testing.assert_array_equal(arrays2["fc_b"], arrays["fc_b"])


class _Interrupt(BaseException):
    """In-process stand-in for a crash at an exact protocol point."""


@pytest.mark.parametrize("point", ["array_written", "arrays_written",
                                   "manifest_written"])
def test_interrupted_save_keeps_last_good(tmp_path, point):
    root = str(tmp_path)
    arrays = {"w": np.arange(8, dtype=np.float32),
              "b": np.ones(3, np.float32)}
    ckpt.save_checkpoint_dir(root, arrays, {"epoch": 0, "step": 1})

    def boom(p):
        if p == point:
            raise _Interrupt(p)

    ckpt.set_chaos_hook(boom)
    try:
        with pytest.raises(_Interrupt):
            ckpt.save_checkpoint_dir(root, arrays, {"epoch": 0, "step": 2})
    finally:
        ckpt.set_chaos_hook(None)
    latest = ckpt.latest_checkpoint(root)
    assert latest.endswith("checkpoint_1")
    ckpt.verify_checkpoint_dir(latest)
    assert any(n.startswith("_tmp.checkpoint_") for n in os.listdir(root))
    ckpt.save_checkpoint_dir(root, arrays, {"epoch": 0, "step": 3})
    assert not any(n.startswith("_tmp.checkpoint_")
                   for n in os.listdir(root))
    assert ckpt.latest_checkpoint(root).endswith("checkpoint_3")


_CHILD = """
import sys
sys.path.insert(0, %r)
import numpy as np
from paddle_tpu_torch.fluid import checkpoint as ckpt
for s in (1, 2):
    ckpt.save_checkpoint_dir(sys.argv[1], {"w": np.full(4, s, np.float32)},
                             {"epoch": 0, "step": s})
    print("SAVED", s, flush=True)
"""


def test_kill9_mid_save_subprocess(tmp_path):
    """A real SIGKILL delivered while a child is paused inside the second
    save's commit (after its manifest) leaves the first checkpoint as a
    loadable, CRC-verified last-good one."""
    root = str(tmp_path / "crash")
    env = dict(os.environ,
               PADDLE_TPU_CHAOS="manifest_written=pause:120@2")
    proc = subprocess.Popen([sys.executable, "-c", _CHILD % REPO, root],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=env)
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                     daemon=True).start()
    saved = 0
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            line = lines.get(timeout=max(deadline - time.time(), 0.1))
            if line.startswith("SAVED"):
                saved = int(line.split()[1])
            if line.startswith("CHAOS_PAUSE"):
                os.kill(proc.pid, signal.SIGKILL)
                break
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert proc.returncode == -signal.SIGKILL and saved == 1
    latest = ckpt.latest_checkpoint(root)
    manifest = ckpt.verify_checkpoint_dir(latest)
    assert manifest["meta"]["step"] == 1
    assert any(n.startswith("_tmp.checkpoint_2") for n in os.listdir(root))


def test_async_save_commits_and_reports_errors(tmp_path):
    root = str(tmp_path / "vault")
    saver = ckpt.AsyncCheckpointSaver()
    arrays = {"w": np.arange(4, dtype=np.float32)}
    for s in (1, 2, 3):
        saver.submit(root, arrays, {"epoch": 0, "step": s},
                     max_num_checkpoints=2)
    saver.wait(timeout=30)
    assert [s for s, _ in ckpt.list_checkpoints(root)] == [2, 3]
    bad_root = str(tmp_path / "not_a_dir")
    with open(bad_root, "w") as f:
        f.write("x")
    saver.submit(bad_root, arrays, {"epoch": 0, "step": 9})
    with pytest.raises(ckpt.CheckpointError):
        saver.wait(timeout=30)


def test_async_save_writes_the_state_of_its_step(tmp_path):
    """The saver takes references to the live state tensors and writes
    them after later steps ran: what lands on disk is the state at
    submit, because no step writes a state tensor in place."""
    root = str(tmp_path / "vault")
    xs = np.random.RandomState(0).randn(8, 4).astype(np.float32)
    ys = xs.sum(axis=1, keepdims=True)
    gate = threading.Event()
    with fluid.scope_guard(fluid.Scope()) as scope:
        main, startup, loss = _small_program()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[loss])
        want = {n: fluid.as_numpy(scope.get(n))
                for n in functionalizer.persistable_names(main)}
        ckpt.set_chaos_hook(lambda p: gate.wait(30)
                            if p == "array_written" else None)
        try:
            fluid_io.save_checkpoint(exe, root, main_program=main, step=1,
                                     async_save=True)
            for _ in range(3):
                exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[loss])
            gate.set()
            ckpt.wait_for_async_saves(timeout=30)
        finally:
            ckpt.set_chaos_hook(None)
        moved = fluid.as_numpy(scope.get(main.all_parameters()[0].name))
    arrays, meta = ckpt.load_checkpoint_dir(ckpt.latest_checkpoint(root))
    assert meta["step"] == 1 and set(arrays) == set(want)
    for n in want:
        np.testing.assert_array_equal(arrays[n], want[n])
    assert not np.array_equal(moved, want[main.all_parameters()[0].name])


# ---------------------------------------------------------------------------
# the vault across packages
# ---------------------------------------------------------------------------

def _jax_program():
    import paddle_tpu.fluid as jfluid
    train_func, optimizer_func = _jax_net(jfluid)
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup), jfluid.unique_name.guard():
        loss = train_func()
        optimizer_func().minimize(loss)
    return main, startup, loss


def _jax_net(jfluid):
    def train_func():
        x = jfluid.layers.data("x", shape=[4], dtype="float32")
        y = jfluid.layers.data("y", shape=[1], dtype="float32")
        pred = jfluid.layers.fc(x, size=1)
        return jfluid.layers.mean(jfluid.layers.square_error_cost(pred, y))

    return train_func, lambda: jfluid.optimizer.SGD(learning_rate=0.05)


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    """A Trainer-state checkpoint the JAX package commits loads in the
    port with equal arrays and meta."""
    import paddle_tpu.fluid as jfluid
    from paddle_tpu.fluid import io as jio
    root = str(tmp_path / "vault")
    jmain, jstartup, _ = _jax_program()
    with jfluid.scope_guard(jfluid.Scope()) as js:
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstartup)
        jio.save_checkpoint(jexe, root, main_program=jmain, step=3, epoch=1,
                            epoch_step=2)
        want = {n: np.asarray(js.get(n)) for n in js.keys()
                if js.get(n) is not None}
    with fluid.scope_guard(fluid.Scope()) as scope:
        main, _, _ = _small_program()
        exe = fluid.Executor(fluid.CPUPlace())
        meta = fluid_io.load_checkpoint(exe, root, main_program=main)
        got = {n: fluid.as_numpy(scope.get(n)) for n in scope.keys()}
    assert meta == {"epoch": 1, "step": 3, "epoch_step": 2}
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n])


def test_port_checkpoint_loads_in_jax(tmp_path):
    import paddle_tpu.fluid as jfluid
    from paddle_tpu.fluid import io as jio
    root = str(tmp_path / "vault")
    with fluid.scope_guard(fluid.Scope()) as scope:
        main, startup, _ = _small_program()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        fluid_io.save_checkpoint(exe, root, main_program=main, step=4)
        want = {n: fluid.as_numpy(scope.get(n)) for n in scope.keys()}
    jmain, _, _ = _jax_program()
    with jfluid.scope_guard(jfluid.Scope()) as js:
        meta = jio.load_checkpoint(jfluid.Executor(jfluid.CPUPlace()), root,
                                   main_program=jmain)
        got = {n: np.asarray(js.get(n)) for n in js.keys()
               if js.get(n) is not None}
    assert meta == {"epoch": 0, "step": 4}
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n])


def test_checkpoint_files_are_byte_identical_to_jax(tmp_path):
    """The same arrays and meta commit the same bytes in both packages:
    every array file, the manifest and the `latest` pointer."""
    from paddle_tpu.fluid import checkpoint as jckpt
    rng = np.random.RandomState(0)
    arrays = {"fc_0.w_0": rng.randn(4, 3).astype(np.float32),
              "a/b": rng.randint(0, 9, (5,)).astype(np.int64),
              "lr": np.array([0.1], np.float32)}
    meta = {"epoch": 2, "step": 11, "epoch_step": 3}
    jdir = jckpt.save_checkpoint_dir(str(tmp_path / "jax"), arrays, meta)
    tdir = ckpt.save_checkpoint_dir(
        str(tmp_path / "port"), {k: torch.from_numpy(v)
                                 for k, v in arrays.items()}, meta)
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    for name in os.listdir(jdir):
        with open(os.path.join(jdir, name), "rb") as a, \
                open(os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read(), name
    for root in ("jax", "port"):
        with open(str(tmp_path / root / "latest")) as f:
            assert f.read() == "checkpoint_11\n"


def test_bf16_checkpoint_writes_the_jax_bytes_and_reads_back_bf16(tmp_path):
    """numpy has no bfloat16: a torch bf16 tensor is written as the JAX
    package's np.save writes an ml_dtypes.bfloat16 array (2-byte records,
    "bfloat16" in the manifest), never widened to fp32, and the port reads
    it back as bfloat16 bit for bit."""
    import ml_dtypes
    from paddle_tpu.fluid import checkpoint as jckpt
    t = torch.randn(6, 5).to(torch.bfloat16)
    ref = fluid.as_numpy(t)
    assert ref.dtype == ml_dtypes.bfloat16
    jdir = jckpt.save_checkpoint_dir(str(tmp_path / "jax"), {"w": ref},
                                     {"step": 1})
    tdir = ckpt.save_checkpoint_dir(str(tmp_path / "port"), {"w": t},
                                    {"step": 1})
    for name in ("w.npy", ckpt.MANIFEST_NAME):
        with open(os.path.join(jdir, name), "rb") as a, \
                open(os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read(), name
    ent = ckpt.read_manifest(tdir)["arrays"]["w"]
    assert ent["dtype"] == "bfloat16" and ent["nbytes"] == 60
    arrays, _ = ckpt.load_checkpoint_dir(jdir)
    assert arrays["w"].dtype == ml_dtypes.bfloat16
    back = fluid.executor.as_tensor(arrays["w"])
    assert back.dtype == torch.bfloat16 and torch.equal(back, t)


# ---------------------------------------------------------------------------
# Trainer: resume
# ---------------------------------------------------------------------------

def _run_trainer(ckpt_dir, num_epochs, data, stop_after=None,
                 step_interval=1, dropout=False):
    train_func, optimizer_func = _build_net(dropout)
    with fluid.scope_guard(fluid.Scope()) as scope:
        cfg = None
        if ckpt_dir is not None:
            cfg = fluid.contrib.CheckpointConfig(
                checkpoint_dir=ckpt_dir, step_interval=step_interval)
        trainer = fluid.contrib.Trainer(train_func, optimizer_func,
                                        place=fluid.CPUPlace(),
                                        checkpoint_config=cfg)
        losses = []

        def handler(ev):
            if isinstance(ev, fluid.contrib.EndStepEvent):
                losses.append(np.asarray(ev.metrics[0]).copy())
                if stop_after is not None and len(losses) >= stop_after:
                    trainer.stop()

        trainer.train(num_epochs=num_epochs, event_handler=handler,
                      reader=_reader(data), feed_order=["x", "y"])
        names = functionalizer.persistable_names(trainer.train_program)
        return {n: fluid.as_numpy(scope.get(n)) for n in names
                if scope.get(n) is not None}, losses


def test_trainer_resume_reproduces_trajectory(tmp_path):
    """Resume from last-good reproduces the uninterrupted run exactly:
    a mid-epoch interruption (epoch_step in the meta, deterministic
    reader replay) with a crash-interrupted save left in the vault."""
    data = _data(5)
    baseline, _ = _run_trainer(None, 2, data)
    vault = str(tmp_path / "vault")
    _run_trainer(vault, 2, data, stop_after=7)

    def boom(p):
        if p == "manifest_written":
            raise _Interrupt(p)
    ckpt.set_chaos_hook(boom)
    try:
        with pytest.raises(_Interrupt):
            ckpt.save_checkpoint_dir(vault, {"junk": np.zeros(2, np.float32)},
                                     {"epoch": 9, "step": 999})
    finally:
        ckpt.set_chaos_hook(None)
    meta = ckpt.load_checkpoint_dir(ckpt.latest_checkpoint(vault))[1]
    assert meta["step"] == 7 and meta["epoch"] == 1 and \
        meta["epoch_step"] == 2, meta
    resumed, _ = _run_trainer(vault, 2, data)
    assert set(resumed) == set(baseline)
    for n in baseline:
        np.testing.assert_array_equal(resumed[n], baseline[n], err_msg=n)


def test_trainer_resume_draws_the_same_dropout_masks(tmp_path):
    """The port's checkpoint meta carries the Executor's step counter
    (`rng_step`), so a resumed run with dropout gives the uninterrupted
    run's losses bit for bit."""
    data = _data(6)
    _, base = _run_trainer(None, 1, data, dropout=True)
    vault = str(tmp_path / "vault")
    _, first = _run_trainer(vault, 1, data, stop_after=3, step_interval=3,
                            dropout=True)
    meta = ckpt.load_checkpoint_dir(ckpt.latest_checkpoint(vault))[1]
    assert meta["rng_step"] == 3
    _, rest = _run_trainer(vault, 1, data, step_interval=100, dropout=True)
    assert len(first) + len(rest) == len(base)
    for a, b in zip(first + rest, base):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# sentinel
# ---------------------------------------------------------------------------

def test_sentinel_state_machine():
    s = sentinel_mod.AnomalySentinel(max_bad_steps=3, policy="skip")
    good = [("loss", np.float32(1.0))]
    bad = [("loss", np.float32(np.nan))]
    assert s.observe(good) == sentinel_mod.OK
    assert s.observe(bad) == sentinel_mod.SKIP
    assert s.observe(bad) == sentinel_mod.SKIP
    with pytest.raises(sentinel_mod.SentinelError):
        s.observe(bad)
    s2 = sentinel_mod.AnomalySentinel(max_bad_steps=2, policy="rollback")
    assert s2.observe(bad) == sentinel_mod.SKIP
    assert s2.observe(bad) == sentinel_mod.ROLLBACK
    assert s2.observe(good) == sentinel_mod.OK
    assert s2.observe([("loss", torch.tensor([np.inf]))]) == \
        sentinel_mod.SKIP
    assert s2.observe(bad) == sentinel_mod.ROLLBACK
    with pytest.raises(sentinel_mod.SentinelError):
        for _ in range(4):
            s2.observe(bad)
    with pytest.raises(ValueError):
        sentinel_mod.AnomalySentinel(policy="ignore")


def test_sentinel_nan_poison_skip_then_rollback(tmp_path):
    """Poisoned batches are reverted, and K consecutive poisoned steps
    roll back to the last-good checkpoint."""
    FLAGS.sentinel_nan_check = True
    FLAGS.sentinel_policy = "rollback"
    FLAGS.sentinel_max_bad_steps = 2
    train_func, optimizer_func = _build_net()
    with fluid.scope_guard(fluid.Scope()):
        cfg = fluid.contrib.CheckpointConfig(
            checkpoint_dir=str(tmp_path), step_interval=3)
        trainer = fluid.contrib.Trainer(train_func, optimizer_func,
                                        place=fluid.CPUPlace(),
                                        checkpoint_config=cfg)
        poisoned = nan_poison_reader(_reader(_data(10)), poison_steps={5, 6})
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            trainer.train(num_epochs=1, event_handler=lambda ev: None,
                          reader=poisoned, feed_order=["x", "y"])
    msgs = [str(w.message) for w in caught]
    assert any("reverted" in m for m in msgs), msgs
    assert any("rolled back" in m for m in msgs), msgs


def test_sentinel_skip_policy_raises_without_checkpoint():
    FLAGS.sentinel_nan_check = True
    FLAGS.sentinel_policy = "skip"
    FLAGS.sentinel_max_bad_steps = 2
    train_func, optimizer_func = _build_net()
    poisoned = nan_poison_reader(_reader(_data(8, seed=1)),
                                 poison_steps={2, 3, 4})
    with fluid.scope_guard(fluid.Scope()):
        trainer = fluid.contrib.Trainer(train_func, optimizer_func,
                                        place=fluid.CPUPlace())
        with pytest.warns(UserWarning, match="reverted"):
            with pytest.raises(sentinel_mod.SentinelError):
                trainer.train(num_epochs=1, event_handler=lambda ev: None,
                              reader=poisoned, feed_order=["x", "y"])


# ---------------------------------------------------------------------------
# watchdog
# ---------------------------------------------------------------------------

def test_watchdog_raises_on_hung_step():
    t0 = time.monotonic()
    with pytest.raises(StepWatchdogTimeout):
        _watchdog_call(lambda: time.sleep(10), 0.2, "wedged step")
    assert time.monotonic() - t0 < 5.0
    assert _watchdog_call(lambda: 42, 5.0) == 42
    with pytest.raises(ValueError):
        _watchdog_call(lambda: (_ for _ in ()).throw(ValueError("x")), 5.0)


def test_watchdog_executor_step_passes_under_budget():
    FLAGS.step_watchdog_secs = 60.0
    with fluid.scope_guard(fluid.Scope()):
        main, startup, loss = _small_program()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        xs = np.ones((4, 4), np.float32)
        l1, = exe.run(main, feed={"x": xs, "y": xs.sum(1, keepdims=True)},
                      fetch_list=[loss])
        l2, = exe.run_loop(main, feed={"x": xs,
                                       "y": xs.sum(1, keepdims=True)},
                           fetch_list=[loss], steps=2)
    assert np.isfinite(l1).all() and np.isfinite(l2).all()


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------

def test_retry_reader_resumes_epoch():
    attempts = {"n": 0}

    def flaky_reader():
        attempts["n"] += 1
        fail_this = attempts["n"] == 1

        def it():
            for i in range(10):
                if fail_this and i == 5:
                    raise OSError("stream broke")
                yield i
        return it()

    policy = RetryPolicy(max_attempts=3, retry_on=(OSError,),
                         sleep=lambda d: None)
    got = list(rd.retry_reader(flaky_reader, policy=policy)())
    assert got == list(range(10)) and attempts["n"] == 2

    def always_broken():
        def it():
            yield 0
            raise OSError("dead source")
        return it()

    with pytest.raises(OSError):
        list(rd.retry_reader(always_broken, policy=RetryPolicy(
            max_attempts=2, retry_on=(OSError,), sleep=lambda d: None))())


@pytest.mark.parametrize("order", [False, True])
def test_xmap_mapper_death_surfaces(order):
    def mapper(x):
        if x == 7:
            raise ValueError("mapper died on sample 7")
        return x * 2

    r = rd.xmap_readers(mapper, lambda: iter(range(30)), 4, 8, order=order)
    with pytest.raises(rd.ReaderWorkerFailed, match="sample 7"):
        list(r())
    assert sorted(rd.xmap_readers(lambda x: x * 2, lambda: iter(range(9)),
                                  3, 4, order=order)()) == \
        [2 * i for i in range(9)]


def test_xmap_source_death_surfaces():
    def bad_src():
        def it():
            yield 1
            yield 2
            raise RuntimeError("source reader died")
        return it()

    r = rd.xmap_readers(lambda x: x, bad_src, 2, 4)
    with pytest.raises(rd.ReaderWorkerFailed, match="source reader died"):
        list(r())


def _good():
    return iter([1, 2, 3])


def _bad():
    def it():
        yield 10
        raise ValueError("child reader exploded")
    return it()


def _victim():
    def it():
        yield 1
        os.kill(os.getpid(), signal.SIGKILL)
        yield 2  # pragma: no cover
    return it()


@pytest.mark.parametrize("use_pipe", [True, False])
def test_multiprocess_reader_child_exception(use_pipe):
    r = rd.multiprocess_reader([_good, _bad], use_pipe=use_pipe)
    with pytest.raises(rd.ReaderWorkerFailed, match="exploded"):
        list(r())


def test_multiprocess_reader_child_killed():
    r = rd.multiprocess_reader([_victim], use_pipe=True)
    with pytest.raises(rd.ReaderWorkerFailed, match="died before"):
        list(r())


def test_reader_decorators_compose(tmp_path):
    """The rest of the decorator set against plain Python."""
    a = lambda: iter(range(5))  # noqa: E731
    b = lambda: iter(range(10, 15))  # noqa: E731
    assert list(rd.map_readers(lambda x, y: x + y, a, b)()) == \
        [10, 12, 14, 16, 18]
    assert list(rd.chain(a, b)()) == list(range(5)) + list(range(10, 15))
    assert list(rd.compose(a, b)()) == list(zip(range(5), range(10, 15)))
    with pytest.raises(rd.ComposeNotAligned):
        list(rd.compose(a, lambda: iter(range(3)))())
    assert list(rd.compose(a, lambda: iter(range(3)),
                           check_alignment=False)()) == \
        [(0, 0), (1, 1), (2, 2)]
    assert sorted(rd.shuffle(a, 2)()) == list(range(5))
    assert list(rd.buffered(a, 2)()) == list(range(5))
    assert list(rd.firstn(a, 3)()) == [0, 1, 2]
    assert list(rd.batch(a, 2)()) == [[0, 1], [2, 3], [4]]
    assert list(rd.batch(a, 2, drop_last=True)()) == [[0, 1], [2, 3]]
    pulls = []

    def counted():
        pulls.append(1)
        return iter(range(3))

    c = rd.cache(counted)
    assert list(c()) == list(c()) == [0, 1, 2] and len(pulls) == 1
    assert list(rd.Fake()(a, 3)()) == [0, 0, 0]
    assert list(rd.creator.np_array(np.arange(6).reshape(3, 2))())[1]\
        .tolist() == [2, 3]
    p = tmp_path / "t.txt"
    p.write_text("x\ny\n")
    assert list(rd.creator.text_file(str(p))()) == ["x", "y"]
    from paddle_tpu_torch.native import RecordIOWriter
    rio = str(tmp_path / "t.rio")
    with RecordIOWriter(rio) as w:
        for rec in (b"a", b"", b"bc"):
            w.write(rec)
    assert list(rd.creator.recordio(rio)()) == [b"a", b"", b"bc"]


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

def _bundles(root):
    return flightrec.list_bundles(str(root))


def test_flight_recorder_is_a_noop_while_unset(tmp_path):
    FLAGS.flight_dir = ""
    assert flightrec.get_recorder() is None
    assert flightrec.trigger("manual") is None


def test_flight_bundle_passes_the_jax_validator(tmp_path):
    """A port bundle has the JAX layout: the JAX package's
    validate_bundle (and the port's) finds no problem, providers land as
    <name>.json, and a tampered file is caught."""
    from paddle_tpu.obs import flightrec as jflightrec
    FLAGS.flight_dir = str(tmp_path)
    flightrec.add_provider("trainer_state", lambda: {"step": 3})
    try:
        path = flightrec.trigger("manual", force=True, step=3)
    finally:
        flightrec.remove_provider("trainer_state")
    assert path is not None and _bundles(tmp_path) == [path]
    assert jflightrec.validate_bundle(path) == []
    assert flightrec.validate_bundle(path) == []
    manifest = jflightrec.read_manifest(path)
    assert manifest["reason"] == "manual" and \
        manifest["context"] == {"step": 3}
    assert set(jflightrec.REQUIRED_FILES) < set(manifest["files"])
    with open(os.path.join(path, "trainer_state.json")) as f:
        assert json.load(f) == {"step": 3}
    with open(os.path.join(path, "flags.json")) as f:
        assert json.load(f)["flight_dir"] == str(tmp_path)
    bit_flip(os.path.join(path, "threads.txt"))
    assert any("corrupt" in p for p in jflightrec.validate_bundle(path))


def test_flight_cooldown_rotation_and_stale_sweep(tmp_path):
    FLAGS.flight_cooldown_s = 60.0
    FLAGS.flight_keep = 2
    FLAGS.flight_dir = str(tmp_path)
    assert flightrec.trigger("storm") is not None
    assert flightrec.trigger("storm") is None  # inside the cooldown
    os.makedirs(str(tmp_path / "_tmp.flight_dead"))
    for _ in range(3):
        assert flightrec.trigger("storm", force=True) is not None
    assert len(_bundles(tmp_path)) == 2
    assert not os.path.exists(str(tmp_path / "_tmp.flight_dead"))
    assert flightrec.get_recorder().stats()["dumps"] == 4


def test_watchdog_and_sentinel_fire_the_flight_recorder(tmp_path):
    FLAGS.flight_dir = str(tmp_path)
    FLAGS.flight_cooldown_s = 0.0
    with pytest.raises(StepWatchdogTimeout):
        _watchdog_call(lambda: time.sleep(5), 0.1, "wedged step")
    s = sentinel_mod.AnomalySentinel(max_bad_steps=1, policy="rollback")
    assert s.observe([("loss", np.float32(np.nan))], step=4) == \
        sentinel_mod.ROLLBACK
    with pytest.raises(sentinel_mod.SentinelError):
        sentinel_mod.AnomalySentinel(max_bad_steps=1).observe(
            [("loss", np.float32(np.nan))], step=5)
    reasons = [flightrec.read_manifest(b)["reason"]
               for b in _bundles(tmp_path)]
    assert sorted(reasons) == ["sentinel_giveup", "sentinel_rollback",
                               "watchdog_fire"]
    for b in _bundles(tmp_path):
        assert flightrec.validate_bundle(b) == []


def test_slo_breach_fires_the_flight_recorder(tmp_path):
    from paddle_tpu_torch.obs import slo as slo_mod
    from paddle_tpu_torch.serving.metrics import ServingMetrics
    FLAGS.flight_dir = str(tmp_path)
    FLAGS.flight_cooldown_s = 0.0
    sm = ServingMetrics()
    m = sm.model("m")
    mon = slo_mod.SLOMonitor(
        sm, slos={"m": slo_mod.SLO(error_rate=0.1, fast_window=3,
                                   breach_evals=2, recover_evals=2)},
        interval_s=1.0)
    flightrec.add_provider("slo", mon.timeline)
    try:
        kinds = []
        for tick in range(8):
            m.requests.add(10)
            (m.errors if tick >= 3 else m.responses).add(10)
            kinds += [k for k, _ in mon.tick()]
    finally:
        flightrec.remove_provider("slo")
    assert "slo_breach" in kinds
    bundles = _bundles(tmp_path)
    assert [flightrec.read_manifest(b)["reason"] for b in bundles] == \
        ["slo_breach"]
    with open(os.path.join(bundles[0], "slo.json")) as f:
        assert len(json.load(f)["m"]) >= 4


def test_training_flags_have_the_jax_names_and_defaults():
    from paddle_tpu.flags import FLAGS as JFLAGS
    for name in ("async_dispatch_depth", "reader_prefetch_depth",
                 "step_watchdog_secs", "check_nan_inf", "benchmark",
                 "sentinel_nan_check", "sentinel_policy",
                 "sentinel_max_bad_steps", "sentinel_check_params",
                 "flight_dir", "flight_keep", "flight_cooldown_s"):
        assert getattr(FLAGS, name) == getattr(JFLAGS, name), name


def test_training_flags_come_from_the_environment():
    code = ("from paddle_tpu_torch.flags import FLAGS; "
            "print(FLAGS.async_dispatch_depth, FLAGS.sentinel_nan_check, "
            "FLAGS.step_watchdog_secs, FLAGS.sentinel_policy)")
    env = dict(os.environ, FLAGS_async_dispatch_depth="3",
               FLAGS_sentinel_nan_check="on", FLAGS_step_watchdog_secs="2.5",
               FLAGS_sentinel_policy="rollback", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.split() == ["3", "True", "2.5", "rollback"], out.stderr
