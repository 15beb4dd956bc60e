"""The sequence and recurrent ops under paddle_tpu_torch's
ParallelExecutor, in a 2-rank gloo world on the CPU.  Two of the new ops
make a rank's result depend on the other ranks' rows, and the row-mixing
check raises for them when the executor is built: lod_reset by Y or by
target_lod (it regroups rows across the batch's sequences) and
sequence_mask with maxlen -1 (its width is max(lengths) over the batch).
Their row-local forms build.  The other new ops compute each sequence on
its own row: a GRU net's steps in the world are the Executor's on the
global batch.

Run as a script, this file is one rank of that world (parallel.mesh.
launch starts it)."""

import os
import sys

import numpy as np
import pytest

WORLD = 2
STEPS = 2
DICT = 30
SPAWN_TIMEOUT_S = 300


def _row_mixing_programs(fluid):
    """{lane: (main, loss, raises)}: the ops the check raises for, and
    their row-local forms."""
    out = {}
    for lane, raises in (("lod_reset_y", True), ("lod_reset_target", True),
                         ("lod_reset_plain", False),
                         ("sequence_mask_dynamic", True),
                         ("sequence_mask_static", False)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            L = fluid.layers
            x = L.data("x", shape=[4], dtype="float32", lod_level=1)
            h = L.fc(x, size=3)
            if lane.startswith("lod_reset"):
                y = L.data("y", shape=[1], dtype="float32", lod_level=1)
                r = L.lod_reset(h, y=y if lane == "lod_reset_y" else None,
                                target_lod=[0, 2, 5]
                                if lane == "lod_reset_target" else None)
                loss = L.mean(r)
            else:
                lens = L.data("lens", shape=[1], dtype="int64")
                m = L.sequence_mask(lens, maxlen=None if raises else 8,
                                    dtype="float32")
                loss = L.elementwise_add(L.mean(h), L.mean(m))
            fluid.optimizer.SGD(0.1).minimize(loss)
        out[lane] = (main, loss, raises)
    return out


def _gru_net(fluid):
    """embedding, fc, dynamic_gru, max pool, fc softmax, cross entropy;
    SGD 0.5 -> (main, startup, loss)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        words = L.data("words", shape=[1], dtype="int64", lod_level=1)
        label = L.data("label", shape=[1], dtype="int64")
        emb = L.embedding(words, size=[DICT, 8])
        gru = L.dynamic_gru(L.fc(emb, size=12), size=4, is_reverse=True)
        pred = L.fc(L.sequence_pool(gru, "max"), size=2, act="softmax")
        loss = L.mean(L.cross_entropy(input=pred, label=label))
        fluid.optimizer.SGD(0.5).minimize(loss)
    return main, startup, loss


def _global_batches():
    """STEPS global batches of 4 sequences: (rows, lengths, labels)."""
    rng = np.random.RandomState(11)
    out = []
    for _ in range(STEPS):
        lens = [int(n) for n in rng.randint(1, 8, size=4)]
        rows = rng.randint(0, DICT, size=(sum(lens), 1)).astype(np.int64)
        out.append((rows, lens,
                    rng.randint(0, 2, size=(4, 1)).astype(np.int64)))
    return out


def _feed(fluid, batch, rank=0, world=1):
    """Rank `rank`'s share of a global batch: whole sequences."""
    rows, lens, labels = batch
    per = len(lens) // world
    offs = np.concatenate([[0], np.cumsum(lens)])
    lo, hi = rank * per, (rank + 1) * per
    return {"words": fluid.create_lod_tensor(rows[offs[lo]:offs[hi]],
                                             [lens[lo:hi]], None),
            "label": labels[lo:hi]}


def _rank_main(workdir):
    """One rank: build each row-mixing lane's ParallelExecutor and keep
    its error; then the GRU net's steps on this rank's share from the
    parent's startup state."""
    import torch
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.parallel import mesh
    torch.set_num_threads(1)
    tid = int(os.environ["PADDLE_TRAINER_ID"])
    world = int(os.environ["PADDLE_TRAINERS"])
    mesh.init_collective(os.environ["PADDLE_COORDINATOR"], world, tid,
                         device_type="cpu")
    out = {}
    for lane, (main, loss, _) in _row_mixing_programs(fluid).items():
        try:
            fluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                   main_program=main, num_trainers=world,
                                   trainer_id=tid, scope=fluid.Scope())
            out["error/" + lane] = np.asarray("")
        except NotImplementedError as e:
            out["error/" + lane] = np.asarray(str(e))
    main, _, loss = _gru_net(fluid)
    with np.load(os.path.join(workdir, "init.npz")) as z:
        init = {k: z[k] for k in z.files}
    scope = fluid.scope_from_jax(init, fluid.Scope(), fluid.CPUPlace())
    pe = fluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                main_program=main, num_trainers=world,
                                trainer_id=tid, scope=scope)
    losses = [float(np.asarray(pe.run([loss.name], feed=_feed(
        fluid, b, tid, world))[0]).ravel()[0]) for b in _global_batches()]
    out["losses"] = np.asarray(losses)
    for p in main.all_parameters():
        out["param/" + p.name] = fluid.as_numpy(scope.get(p.name))
    np.savez(os.path.join(workdir, "rank%d.npz" % tid), **out)
    return 0


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the GRU net's Executor losses and parameters on the global
    batches, each rank's arrays)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.parallel import mesh
    workdir = str(tmp_path_factory.mktemp("seq_pe"))
    main, startup, loss = _gru_net(fluid)
    scope0 = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope0)
    init = {n: fluid.as_numpy(scope0.get(n)) for n in scope0.keys()}
    np.savez(os.path.join(workdir, "init.npz"), **init)
    scope = fluid.scope_from_jax(init, fluid.Scope(), fluid.CPUPlace())
    exe = fluid.Executor(fluid.CPUPlace())
    losses = [float(np.asarray(exe.run(main, feed=_feed(fluid, b),
                                       fetch_list=[loss], scope=scope)[0])
                    .ravel()[0]) for b in _global_batches()]
    params = {p.name: fluid.as_numpy(scope.get(p.name))
              for p in main.all_parameters()}
    results = mesh.launch([os.path.abspath(__file__), workdir], WORLD,
                          use_cuda=False, capture=True,
                          timeout=SPAWN_TIMEOUT_S)
    for rank, (rc, _, err) in enumerate(results):
        assert rc == 0, "rank %d failed:\n%s" % (rank, err[-4000:])
    ranks = []
    for rank in range(WORLD):
        with np.load(os.path.join(workdir, "rank%d.npz" % rank)) as z:
            ranks.append({k: z[k] for k in z.files})
    return (losses, params), ranks


@pytest.mark.parametrize("lane", ["lod_reset_y", "lod_reset_target",
                                  "sequence_mask_dynamic"])
def test_ops_mixing_the_batch_rows_raise_at_construction(world, lane):
    op = lane.rsplit("_", 1)[0]
    for rank in world[1]:
        err = str(rank["error/" + lane])
        assert op in err and "batch axis" in err, err


@pytest.mark.parametrize("lane", ["lod_reset_plain", "sequence_mask_static"])
def test_their_row_local_forms_build(world, lane):
    for rank in world[1]:
        assert str(rank["error/" + lane]) == ""


def test_gru_net_steps_are_the_executors_on_the_global_batch(world):
    """The recurrent ops compute each sequence on its own row: each rank's
    losses and final parameters are the Executor's on the global
    batches."""
    (losses, params), ranks = world
    for rank in ranks:
        np.testing.assert_allclose(rank["losses"], losses, rtol=1e-5)
        for n, want in params.items():
            np.testing.assert_allclose(rank["param/" + n], want, rtol=1e-5,
                                       atol=1e-6, err_msg=n)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.exit(_rank_main(sys.argv[1]))
