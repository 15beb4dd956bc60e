"""Collective-mode data parallelism of the port, end to end on the CPU (the
pattern of test_dist_collective.py: local trainer processes, per-step
losses compared against single-process runs).

dist_collective_trainer.py's MLP goes through the port's
DistributeTranspiler in collective mode: the startup program's
gen_collective_id joins a gloo world of 2 or 4 ranks (PADDLE_COORDINATOR
from parallel.mesh.launch), and a ParallelExecutor with num_trainers and
trainer_id trains 5 SGD steps, each rank on its share of the global
batch (tests/torch_dp_worker.py).  Held:

* the per-step losses, at rtol 1e-5, against the JAX ParallelExecutor on
  a mesh of as many virtual CPU devices and against the port's Executor
  on the global batch; equal on every rank;
* the prediction, a batch-axis fetch, and its grad gathered in rank
  order: the Executor's on the global batch;
* the ranks started from different seeds; the ParallelExecutor's
  construction broadcasts rank 0's state;
* a world or rank that does not match the ParallelExecutor's arguments
  raises; CollectiveId is [trainer_id].

In one process: the transpiler's program rewrite against the JAX
package's, pserver mode raising, and `launch` ending every rank when one
fails or the time runs out.
"""

import json
import os
import sys
import time

import jax
import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
import torch_dp_worker as W
from paddle_tpu.parallel.mesh import DATA_AXIS, make_mesh
from paddle_tpu_torch.parallel import mesh

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_dp_worker.py")
RTOL = 1e-5
SPAWN_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def init(tmp_path_factory):
    """The JAX package's startup state of the MLP; (workdir, state)."""
    wd = str(tmp_path_factory.mktemp("collective"))
    startup = W.mlp(jfluid)[1]
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
    state = {n: np.asarray(scope.get(n)) for n in scope.keys()}
    np.savez(os.path.join(wd, "init_mlp.npz"), **state)
    return wd, state


def _spawn(n, workdir):
    results = mesh.launch([WORKER, "mlp", workdir], n, use_cuda=False,
                          capture=True, timeout=SPAWN_TIMEOUT_S)
    for rank, (rc, out, err) in enumerate(results):
        assert rc == 0, "rank %d failed:\n%s" % (rank, err[-4000:])
    out = []
    for rank in range(n):
        stem = os.path.join(workdir, "rank%d_mlp" % rank)
        with np.load(stem + ".npz") as z:
            arrays = {k: z[k] for k in z.files}
        with open(stem + ".json") as f:
            out.append((arrays, json.load(f)))
    return out


@pytest.fixture(scope="module")
def world2(init):
    return 2, _spawn(2, init[0])


@pytest.fixture(scope="module")
def world4(init):
    return 4, _spawn(4, init[0])


@pytest.fixture(params=[2, 4], ids=["world2", "world4"])
def world(request):
    return request.getfixturevalue("world%d" % request.param)


@pytest.fixture(scope="module")
def executor(init):
    """The port's Executor on the global batches: (losses, predictions,
    the predictions' grads)."""
    main, _, loss, pred = W.mlp(tfluid)
    scope = tfluid.scope_from_jax(init[1], tfluid.Scope(), tfluid.CPUPlace())
    exe = tfluid.Executor(tfluid.CPUPlace())
    losses, preds, grads = [], [], []
    with tfluid.scope_guard(scope):
        for feed in W.mlp_batches():
            lv, pv, gv = exe.run(main, feed=feed, fetch_list=[
                loss, pred, pred.name + "@GRAD"])
            losses.append(float(np.asarray(lv).ravel()[0]))
            preds.append(pv)
            grads.append(gv)
    return losses, preds, grads


def _jax_pe_losses(state, n):
    main, _, loss, _ = W.mlp(jfluid)
    scope = jfluid.Scope()
    for k, v in state.items():
        scope.set(k, v)
    losses = []
    with jfluid.scope_guard(scope):
        pe = jfluid.ParallelExecutor(
            use_cuda=False, loss_name=loss.name, main_program=main,
            mesh=make_mesh({DATA_AXIS: n}, jax.devices()[:n]))
        for feed in W.mlp_batches():
            lv, = pe.run([loss.name], feed=feed)
            losses.append(float(np.asarray(lv).ravel()[0]))
    return losses


def test_losses_match_the_jax_parallel_executor(world, init):
    n, ranks = world
    want = _jax_pe_losses(init[1], n)
    np.testing.assert_allclose(ranks[0][0]["losses"], want, rtol=RTOL)
    assert want[-1] < want[0]


def test_losses_match_the_executor_on_the_global_batch(world, executor):
    n, ranks = world
    np.testing.assert_allclose(ranks[0][0]["losses"], executor[0],
                               rtol=RTOL)


def test_every_rank_sees_the_same_losses_and_state(world):
    n, ranks = world
    a0 = ranks[0][0]
    for arrays, _ in ranks[1:]:
        np.testing.assert_array_equal(arrays["losses"], a0["losses"])
        for k in a0:
            if k.startswith("final/"):
                np.testing.assert_array_equal(arrays[k], a0[k], err_msg=k)


def test_batch_axis_fetch_is_gathered_in_rank_order(world, executor):
    """The prediction and its grad (an activation's grad, which the
    global step's is: each rank's replica of the loss seeds its own
    backward) are the Executor's on the global batch."""
    n, ranks = world
    for arrays, _ in ranks:
        assert arrays["preds"].shape == (W.STEPS, W.GLOBAL_BATCH, 1)
        np.testing.assert_allclose(arrays["preds"], np.stack(executor[1]),
                                   rtol=RTOL, atol=RTOL)
        want = np.stack(executor[2])
        np.testing.assert_allclose(arrays["pred_grads"], want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())


def test_construction_broadcasts_rank_zeros_state(world):
    n, ranks = world
    pre0 = {k[4:]: v for k, v in ranks[0][0].items() if k.startswith("pre/")}
    assert pre0
    # the ranks did start apart (startup seeds 100 + rank)
    pre1 = ranks[1][0]
    assert any(not np.array_equal(pre1["pre/" + k], v)
               for k, v in pre0.items())
    for arrays, msgs in ranks:
        assert msgs["device_count"] == n
        for k, v in pre0.items():
            np.testing.assert_array_equal(arrays["post/" + k], v, err_msg=k)


def test_world_and_rank_mismatches_raise(world):
    n, ranks = world
    for rank, (arrays, msgs) in enumerate(ranks):
        assert "num_trainers=%d" % (n + 1) in msgs["world"]
        assert "world has %d processes" % n in msgs["world"]
        assert msgs["rank"] == ("trainer_id=%d does not match collective "
                                "rank %d" % ((rank + 1) % n, rank))


def test_gen_collective_id_returns_the_trainer_id(world):
    n, ranks = world
    for rank, (arrays, _) in enumerate(ranks):
        assert arrays["collective_id"].tolist() == [rank]
        assert arrays["collective_id"].dtype == np.int64


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------

def _transpiled(pkg, mode="collective"):
    main, startup, loss, _ = W.mlp(pkg)
    cfg = pkg.DistributeTranspilerConfig()
    cfg.mode = mode
    t = pkg.DistributeTranspiler(config=cfg)
    t.transpile(1, program=main, trainers=1, startup_program=startup)
    return t, main, startup


@pytest.mark.parametrize("mode", ["collective", "nccl2"])
def test_transpiler_rewrites_the_programs_as_the_jax_one(mode):
    jt, jmain, jstartup = _transpiled(jfluid, mode)
    tt, tmain, tstartup = _transpiled(tfluid, mode)

    def ops(p):
        return [(op.type, op.inputs, op.outputs, op.attrs)
                for op in p.global_block().ops]

    assert ops(tstartup) == ops(jstartup)
    assert tstartup.global_block().ops[0].type == "gen_collective_id"
    assert ops(tmain) == ops(jmain)
    assert (tmain._num_trainers, tmain._trainer_id) == (1, 1)
    assert tt.get_trainer_program() is tmain
    # transpiling picks no card: the launcher or the world's join does
    from paddle_tpu_torch.fluid import core
    assert core._SELECTED == []
    v = tstartup.global_block().var("CollectiveId")
    assert v.persistable and tuple(v.shape) == (1,)


def test_pserver_mode_raises():
    main, startup, _, _ = W.mlp(tfluid)
    t = tfluid.DistributeTranspiler()
    with pytest.raises(NotImplementedError, match="queue 1 item 12"):
        t.transpile(0, program=main, pservers="127.0.0.1:6174",
                    trainers=2, startup_program=startup)
    with pytest.raises(NotImplementedError, match="queue 1 item 12"):
        t.get_pserver_program("127.0.0.1:6174")


def test_gen_collective_id_without_a_coordinator_joins_nothing(
        monkeypatch):
    import torch.distributed as dist
    monkeypatch.delenv("PADDLE_COORDINATOR", raising=False)
    _, _, startup = _transpiled(tfluid)
    # two trainers but no coordinator: the op only reports its id
    startup.global_block().ops[0].attrs["num_trainers"] = 2
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        cid, = tfluid.Executor(tfluid.CPUPlace()).run(
            startup, fetch_list=["CollectiveId"])
    assert cid.tolist() == [1] and not dist.is_initialized()


def test_launch_ends_every_rank_when_one_fails(tmp_path):
    script = tmp_path / "fail.py"
    script.write_text(
        "import os, sys, time\n"
        "if os.environ['PADDLE_TRAINER_ID'] == '1':\n"
        "    sys.exit(3)\n"
        "time.sleep(120)\n")
    t0 = time.time()
    results = mesh.launch([str(script)], 3, use_cuda=False, capture=True,
                          timeout=100)
    assert time.time() - t0 < 60
    rcs = [r[0] for r in results]
    assert rcs[1] == 3 and rcs[0] != 0 and rcs[2] != 0


def test_launch_sets_each_ranks_environment(tmp_path):
    script = tmp_path / "env.py"
    script.write_text(
        "import os\n"
        "print(os.environ['PADDLE_TRAINER_ID'], "
        "os.environ['PADDLE_TRAINERS'], "
        "os.environ['PADDLE_COORDINATOR'].startswith('127.0.0.1:'), "
        "os.environ.get('FLAGS_selected_gpus'), os.environ['EXTRA'])\n")
    results = mesh.launch([str(script)], 2, use_cuda=True, capture=True,
                          env={"EXTRA": "x"}, timeout=60)
    assert [r[1].split() for r in results] == [
        ["0", "2", "True", "0", "x"], ["1", "2", "True", "1", "x"]]


def test_launch_times_out(tmp_path):
    script = tmp_path / "sleep.py"
    script.write_text("import time\ntime.sleep(120)\n")
    t0 = time.time()
    with pytest.raises(TimeoutError):
        mesh.launch([str(script)], 2, use_cuda=False, capture=True,
                    timeout=2)
    assert time.time() - t0 < 60


def test_selected_gpus_name_the_ranks_card(monkeypatch):
    from paddle_tpu_torch.fluid import core
    monkeypatch.setattr(core, "_SELECTED", [])
    monkeypatch.setenv("FLAGS_selected_gpus", "3,1")
    assert core.selected_gpus() == [3, 1]
    assert tfluid.CUDAPlace(0).torch_device().index == 3
    assert tfluid.CUDAPlace(1).torch_device().index == 1
    with pytest.raises(ValueError, match="selected cards"):
        tfluid.CUDAPlace(2).torch_device()
    assert mesh.rank_card(5) == 3
    monkeypatch.delenv("FLAGS_selected_gpus")
    assert core.selected_gpus() == []
    assert tfluid.CUDAPlace(2).torch_device().index == 2
    core.select_gpus([2])
    assert tfluid.CUDAPlace(0).torch_device().index == 2
    assert tfluid.CPUPlace().torch_device().type == "cpu"


def test_the_worker_imports_no_jax():
    import subprocess
    code = ("import sys; sys.path.insert(0, %r); import torch_dp_worker; "
            "import paddle_tpu_torch.fluid; "
            "print(any(m == 'jax' or m.startswith(('jax.', 'paddle_tpu.')) "
            "or m == 'paddle_tpu' for m in sys.modules))" % HERE)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(HERE))
    assert out.stdout.strip() == "False", out.stderr[-2000:]


@pytest.mark.cuda
def test_cuda_collective_mlp_on_the_visible_cards(init):
    """The transpiler's path on every visible card: gen_collective_id
    joins an NCCL world, each rank computes on its own card
    (FLAGS_selected_gpus), the losses equal the JAX ParallelExecutor's at
    rtol 1e-5 and rank 0's state was broadcast."""
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip("needs two or more cards, this host has %d" % n)
    if W.GLOBAL_BATCH % n:
        pytest.skip("the global batch of %d does not split over %d cards"
                    % (W.GLOBAL_BATCH, n))
    wd, state = init
    results = mesh.launch([WORKER, "mlp", wd], n, use_cuda=True,
                          env={"PADDLE_DP_DEVICE": "cuda"}, capture=True,
                          timeout=SPAWN_TIMEOUT_S)
    for rank, (rc, out, err) in enumerate(results):
        assert rc == 0, "rank %d failed:\n%s" % (rank, err[-4000:])
    ranks = []
    for rank in range(n):
        with np.load(os.path.join(wd, "rank%d_mlp.npz" % rank)) as z:
            ranks.append({k: z[k] for k in z.files})
    np.testing.assert_allclose(ranks[0]["losses"],
                               _jax_pe_losses(state, n), rtol=RTOL)
    for rank, arrays in enumerate(ranks):
        assert arrays["collective_id"].tolist() == [rank]
        np.testing.assert_array_equal(arrays["losses"], ranks[0]["losses"])
        for k, v in ranks[0].items():
            if k.startswith("pre/"):
                np.testing.assert_array_equal(arrays["post/" + k[4:]], v)
