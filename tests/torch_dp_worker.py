"""One rank of a data-parallel world of paddle_tpu_torch, for
test_torch_dist_collective.py and test_torch_parallel_executor.py (the
pattern of dist_collective_trainer.py: local subprocesses, per-step
results compared against single-process runs by the parent test).

    python tests/torch_dp_worker.py <scenario> <workdir> [<lane> ...]

`paddle_tpu_torch.parallel.mesh.launch` starts one process per rank with
PADDLE_TRAINER_ID, PADDLE_TRAINERS and PADDLE_COORDINATOR set.  Each rank
loads the startup state the parent wrote (`<workdir>/init_<net>.npz`),
feeds its share of the global batches below and writes its results to
`<workdir>/rank<id>_<scenario>.npz` (arrays) and `.json` (messages).
With PADDLE_DP_DEVICE=cuda the ranks train on their cards over NCCL
(deterministic cuDNN), else on the CPU over gloo.  This module imports
no jax: the parent builds the JAX package's programs with the same
builders.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

STEPS = 5
GLOBAL_BATCH = 8
CUDA = os.environ.get("PADDLE_DP_DEVICE", "cpu") == "cuda"
# small_resnet's learning rate, small as in test_convergence_parity.py's
# batch-norm case: a relu whose input is a rounding away from 0 can flip
# between two summation orders, and at 4 ranks one did (97 elements of
# one image's gradient at the first batch norm moved by up to 5%); at lr
# 0.1 that moved a conv weight by 1.5e-5 of the state's largest
# magnitude after one step, at 0.01 by a tenth of that
LR = 0.01


# ---------------------------------------------------------------------------
# the nets, for either package (`pkg` is its fluid, `models` its
# models.resnet)
# ---------------------------------------------------------------------------

def mlp(pkg):
    """dist_collective_trainer.py's model: fc-relu-fc, square error, SGD
    0.1; also returns the prediction (a batch-axis fetch)."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[4], dtype="float32")
        y = pkg.layers.data("y", shape=[1], dtype="float32")
        h = pkg.layers.fc(x, size=16, act="relu")
        pred = pkg.layers.fc(h, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        pkg.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss, pred


def mlp_batches(steps=STEPS, global_bs=GLOBAL_BATCH):
    """dist_collective_trainer.py's global batches."""
    rng = np.random.RandomState(7)
    w = rng.randn(4, 1).astype(np.float32)
    out = []
    for _ in range(steps):
        xb = rng.randn(global_bs, 4).astype(np.float32)
        yb = (xb @ w + 0.1 * rng.randn(global_bs, 1)).astype(np.float32)
        out.append({"x": xb, "y": yb})
    return out


def small_resnet(pkg, models):
    """A small ResNet with batch norm kept and no dropout: conv-bn, two
    basic blocks, global pool, fc softmax over 10 classes; Momentum (LR)
    with L2Decay(1e-4).  (main, startup, loss, acc, predict)."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 9
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        image = pkg.layers.data(name="data", shape=[3, 32, 32],
                                dtype="float32")
        label = pkg.layers.data(name="label", shape=[1], dtype="int64")
        x = models.conv_bn_layer(image, 8, 3, 1, 1)
        x = models.basic_block(x, 8, 1)
        x = models.basic_block(x, 16, 2)
        x = pkg.layers.pool2d(x, pool_type="avg", global_pooling=True)
        predict = pkg.layers.fc(x, size=10, act="softmax")
        loss = pkg.layers.mean(pkg.layers.cross_entropy(predict, label))
        acc = pkg.layers.accuracy(input=predict, label=label)
        pkg.optimizer.Momentum(
            learning_rate=LR, momentum=0.9,
            regularization=pkg.regularizer.L2Decay(1e-4)).minimize(loss)
    return main, startup, loss, acc, predict


def image_batches(steps=STEPS, global_bs=GLOBAL_BATCH):
    rng = np.random.RandomState(6)
    return [{"data": rng.randn(global_bs, 3, 32, 32).astype(np.float32),
             "label": rng.randint(0, 10, (global_bs, 1)).astype(np.int64)}
            for _ in range(steps)]


def small_lstm(pkg, models):
    """stacked_dynamic_lstm at a small size: 2 layers, emb and hid 16,
    dict 50; Adam.  (main, startup, loss, acc, predict)."""
    with pkg.unique_name.guard():
        main, startup, _, loss, acc, predict = models.get_model(
            batch_size=GLOBAL_BATCH, dict_dim=50, emb_dim=16, hid_dim=16,
            stacked_num=2, class_dim=2, lr=0.01)
    return main, startup, loss, acc, predict


def ragged_mean_net(pkg):
    """Embedding over ragged ids, fc, and the loss a `mean` over the
    ragged rows (its count differs between ranks); SGD.  (main, startup,
    loss, hidden) where hidden is a ragged fetch."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        words = pkg.layers.data(name="words", shape=[1], dtype="int64",
                                lod_level=1)
        emb = pkg.layers.embedding(words, size=[50, 8])
        hidden = pkg.layers.fc(emb, size=1)
        loss = pkg.layers.mean(pkg.layers.elementwise_mul(hidden, hidden))
        pkg.optimizer.SGD(0.5).minimize(loss)
    return main, startup, loss, hidden


def ragged_batches(LoDTensor, steps=STEPS, global_bs=GLOBAL_BATCH,
                   labels=True):
    """Per step (lengths, ids, labels) of `global_bs` sequences with
    lengths 1-11, as global feeds made by `LoDTensor`."""
    rng = np.random.RandomState(11)
    out = []
    for _ in range(steps):
        lens = rng.randint(1, 12, size=global_bs)
        ids = rng.randint(0, 50, size=(int(lens.sum()), 1)).astype(np.int64)
        t = LoDTensor(ids)
        t.set_recursive_sequence_lengths([lens.tolist()])
        feed = {"words": t}
        if labels:
            feed["label"] = rng.randint(0, 2, (global_bs, 1)).astype(
                np.int64)
        out.append(feed)
    return out


def rowmix_net(pkg, op):
    """fc 4 -> 3, then an op that mixes rows of the batch axis, then the
    loss mean(r * r); SGD 0.1.  `op`: "cumsum" (along axis 0), "slice"
    (global rows 0:2), "slice_keep" (rows 0 to past the batch and columns
    1:3: the output keeps the batch axis and stays batch-sharded),
    "softmax" (over the last axis: the control, which mixes none) or
    "reshape" ([1, -1], folding the batch axis away, then softmax).
    (main, startup, loss, r)."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[4], dtype="float32")
        h = pkg.layers.fc(x, size=3)
        if op == "cumsum":
            r = pkg.layers.cumsum(h, axis=0)
        elif op == "slice":
            r = pkg.layers.slice(h, axes=[0], starts=[0], ends=[2])
        elif op == "slice_keep":
            r = pkg.layers.slice(h, axes=[0, 1], starts=[0, 1],
                                 ends=[1 << 30, 3])
        elif op == "softmax":
            r = pkg.layers.softmax(h)
        else:
            r = pkg.layers.softmax(pkg.layers.reshape(h, [1, -1]))
        loss = pkg.layers.mean(pkg.layers.elementwise_mul(r, r))
        pkg.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss, r


def rowmix_batches(steps=3, global_bs=GLOBAL_BATCH):
    rng = np.random.RandomState(5)
    return [{"x": rng.randn(global_bs, 4).astype(np.float32)}
            for _ in range(steps)]


def shard(feed, rank, world, LoDTensor):
    """Rank `rank`'s share of a global feed: rows of a dense array,
    whole sequences of a LoDTensor."""
    out = {}
    for k, v in feed.items():
        if isinstance(v, LoDTensor):
            lens = v.recursive_sequence_lengths()[0]
            per = len(lens) // world
            offs = np.concatenate([[0], np.cumsum(lens)])
            lo, hi = rank * per, (rank + 1) * per
            t = LoDTensor(v.numpy()[offs[lo]:offs[hi]])
            t.set_recursive_sequence_lengths([lens[lo:hi]])
            out[k] = t
        else:
            per = v.shape[0] // world
            out[k] = v[rank * per:(rank + 1) * per]
    return out


def accuracy_counts(main):
    """The Correct and Total var names of the program's accuracy op."""
    op = next(op for op in main.global_block().ops if op.type == "accuracy")
    return op.outputs["Correct"][0], op.outputs["Total"][0]


# ---------------------------------------------------------------------------
# the rank's side
# ---------------------------------------------------------------------------

def _place(fluid):
    return fluid.CUDAPlace(0) if CUDA else fluid.CPUPlace()


def _scope_from(fluid, path):
    with np.load(path) as z:
        init = {k: z[k] for k in z.files}
    return fluid.scope_from_jax(init, fluid.Scope(), _place(fluid))


def _state(fluid, scope, main):
    from paddle_tpu_torch.fluid.functionalizer import persistable_names
    return {n: fluid.as_numpy(scope.get(n)) for n in persistable_names(main)
            if scope.get(n) is not None}


def _collective_world(fluid, main, startup, tid, world):
    """Transpile for the collective mode and run the startup program: its
    gen_collective_id joins the gloo world.  Returns (scope, CollectiveId)."""
    cfg = fluid.DistributeTranspilerConfig()
    cfg.mode = "collective"
    fluid.DistributeTranspiler(cfg).transpile(
        tid, program=main, trainers=world, startup_program=startup)
    exe, scope = fluid.Executor(_place(fluid)), fluid.Scope()
    with fluid.scope_guard(scope):
        cid, = exe.run(startup, fetch_list=["CollectiveId"])
    return scope, cid


def scenario_mlp(tid, world, workdir, lanes):
    """The MLP through the collective transpiler: the CollectiveId, the
    rank-0 broadcast from ranks started with different seeds, the
    world/rank mismatch errors, then 5 steps from the parent's startup
    state with the losses, the gathered predictions and their grads."""
    import paddle_tpu_torch.fluid as fluid
    main, startup, loss, pred = mlp(fluid)
    startup.random_seed = 100 + tid  # the ranks start apart
    scope, cid = _collective_world(fluid, main, startup, tid, world)
    arrays, msgs = {"collective_id": cid}, {}
    for n, v in _state(fluid, scope, main).items():
        arrays["pre/" + n] = v
    for name, kw in (("world", {"num_trainers": world + 1,
                                "trainer_id": tid}),
                     ("rank", {"num_trainers": world,
                               "trainer_id": (tid + 1) % world})):
        try:
            fluid.ParallelExecutor(use_cuda=CUDA, loss_name=loss.name,
                                   main_program=main, scope=scope, **kw)
            msgs[name] = None
        except RuntimeError as e:
            msgs[name] = str(e)
    pe = fluid.ParallelExecutor(use_cuda=CUDA, loss_name=loss.name,
                                main_program=main, num_trainers=world,
                                trainer_id=tid, scope=scope)
    msgs["device_count"] = pe.device_count
    for n, v in _state(fluid, scope, main).items():
        arrays["post/" + n] = v
    scope = _scope_from(fluid, os.path.join(workdir, "init_mlp.npz"))
    pe = fluid.ParallelExecutor(use_cuda=CUDA, loss_name=loss.name,
                                main_program=main, num_trainers=world,
                                trainer_id=tid, scope=scope)
    losses, preds, pgrads = [], [], []
    for feed in mlp_batches():
        lv, pv, gv = pe.run([loss.name, pred.name, pred.name + "@GRAD"],
                            feed=shard(feed, tid, world, fluid.LoDTensor))
        losses.append(float(np.asarray(lv).ravel()[0]))
        preds.append(pv)
        pgrads.append(gv)
    arrays["losses"] = np.asarray(losses)
    arrays["preds"] = np.stack(preds)
    arrays["pred_grads"] = np.stack(pgrads)
    for n, v in _state(fluid, scope, main).items():
        arrays["final/" + n] = v
    return arrays, msgs


def _train_lane(fluid, build, init, feeds, tid, world, fetch_extra=(),
                strategy=None, loop=0):
    """A fresh program and scope from `init`, a ParallelExecutor over
    the world and len(feeds) steps of this rank's shares (or, with
    `loop`, run_loop(loop) on the first feed); (losses, fetches, state)."""
    main, startup, loss = build()[:3]
    scope = _scope_from(fluid, init)
    pe = fluid.ParallelExecutor(use_cuda=CUDA, loss_name=loss.name,
                                main_program=main, num_trainers=world,
                                trainer_id=tid, scope=scope,
                                build_strategy=strategy)
    fetch = [loss.name] + list(fetch_extra)
    losses, fetched, states = [], [], []
    if loop:
        outs = pe.run_loop(fetch, feed=shard(feeds[0], tid, world,
                                             fluid.LoDTensor), steps=loop)
        return [float(np.asarray(outs[0]).ravel()[0])], [outs], \
            [_state(fluid, scope, main)]
    for feed in feeds:
        outs = pe.run(fetch, feed=shard(feed, tid, world, fluid.LoDTensor))
        losses.append(float(np.asarray(outs[0]).ravel()[0]))
        fetched.append(outs)
        states.append(_state(fluid, scope, main))
    return losses, fetched, states


def scenario_train(tid, world, workdir, lanes):
    """The ParallelExecutor lanes of test_torch_parallel_executor.py, each
    from the parent's startup state:
      coeff   — the small ResNet, per op, 5 steps; fetches the loss,
                accuracy, Correct, Total and the prediction;
      wg      — the same under whole-graph AD;
      remat   — whole-graph AD under the block_out remat policy;
      one     — GradientScaleStrategy.One, per op, 1 step;
      one_wg  — the same under whole-graph AD;
      loop    — run_loop(3) on the first batch; loop_runs — 3 run()s of it;
      lstm    — the small stacked_dynamic_lstm, 3 steps, ragged feeds;
      ragged  — ragged_mean_net, 3 steps (the ragged mean);
      cumsum, slice, slice_keep, softmax — rowmix_net with that op,
                3 steps;
                fetches the op's output;
      reshape — rowmix_net's reshape case: the ParallelExecutor's
                NotImplementedError at construction."""
    import torch

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.flags import FLAGS
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.models import stacked_dynamic_lstm

    torch.set_num_threads(1)
    # no startup program runs here: the world comes from the launcher's
    # environment directly
    from paddle_tpu_torch.parallel import mesh
    mesh.init_collective(os.environ["PADDLE_COORDINATOR"], world, tid,
                         device_type="cuda" if CUDA else "cpu")
    arrays, msgs = {}, {}
    res_init = os.path.join(workdir, "init_resnet.npz")
    build = lambda: small_resnet(fluid, resnet)  # noqa: E731
    main0, _, _, acc, predict = build()
    correct, total = accuracy_counts(main0)
    one = fluid.BuildStrategy()
    one.gradient_scale_strategy = \
        fluid.BuildStrategy.GradientScaleStrategy.One
    batches = image_batches()
    for lane in lanes:
        FLAGS.whole_graph_ad = lane in ("wg", "remat", "one_wg")
        FLAGS.remat_policy = "block_out" if lane == "remat" else ""
        try:
            if lane in ("coeff", "wg", "remat"):
                losses, fetched, state = _train_lane(
                    fluid, build, res_init, batches, tid, world,
                    fetch_extra=(acc.name, correct, total, predict.name))
                arrays[lane + "/acc"] = np.stack([f[1] for f in fetched])
                arrays[lane + "/correct"] = np.stack([f[2] for f in fetched])
                arrays[lane + "/total"] = np.stack([f[3] for f in fetched])
                arrays[lane + "/predict"] = np.stack([f[4] for f in fetched])
            elif lane in ("one", "one_wg"):
                losses, _, state = _train_lane(
                    fluid, build, res_init, batches[:1], tid, world,
                    strategy=one)
            elif lane in ("loop", "loop_runs"):
                feeds = batches[:1] * 3
                losses, _, state = _train_lane(
                    fluid, build, res_init, feeds, tid, world,
                    loop=3 if lane == "loop" else 0)
            elif lane == "lstm":
                losses, _, state = _train_lane(
                    fluid, lambda: small_lstm(fluid, stacked_dynamic_lstm),
                    os.path.join(workdir, "init_lstm.npz"),
                    ragged_batches(fluid.LoDTensor, steps=3), tid, world)
            elif lane in ("cumsum", "slice", "slice_keep", "softmax"):
                init = os.path.join(workdir, "init_rowmix_%s.npz" % lane)
                r = rowmix_net(fluid, lane)[3]
                losses, fetched, state = _train_lane(
                    fluid, lambda: rowmix_net(fluid, lane), init,
                    rowmix_batches(), tid, world, fetch_extra=(r.name,))
                arrays[lane + "/r"] = np.stack([f[1] for f in fetched])
            elif lane == "reshape":
                main, _, loss, _ = rowmix_net(fluid, "reshape")
                try:
                    fluid.ParallelExecutor(
                        use_cuda=CUDA, loss_name=loss.name,
                        main_program=main, num_trainers=world,
                        trainer_id=tid, scope=fluid.Scope())
                    err = ""
                except NotImplementedError as e:
                    err = str(e)
                arrays[lane + "/error"] = np.asarray(err)
                continue
            elif lane == "ragged":
                hidden = ragged_mean_net(fluid)[3]
                losses, fetched, state = _train_lane(
                    fluid, lambda: ragged_mean_net(fluid),
                    os.path.join(workdir, "init_ragged.npz"),
                    ragged_batches(fluid.LoDTensor, steps=3, labels=False),
                    tid, world, fetch_extra=(hidden.name,))
                hid = fetched[0][1]
                arrays[lane + "/hidden"] = hid.numpy()
                arrays[lane + "/hidden_lens"] = np.asarray(
                    hid.recursive_sequence_lengths()[0])
            else:
                raise ValueError("unknown lane %r" % lane)
        finally:
            FLAGS.whole_graph_ad, FLAGS.remat_policy = False, ""
        arrays[lane + "/losses"] = np.asarray(losses)
        # the state after each step, stacked
        for n in state[-1]:
            arrays[lane + "/state/" + n] = np.stack([st[n] for st in state])
    return arrays, msgs


SCENARIOS = {"mlp": scenario_mlp, "train": scenario_train}


def main():
    scenario, workdir, lanes = sys.argv[1], sys.argv[2], sys.argv[3:]
    tid = int(os.environ["PADDLE_TRAINER_ID"])
    world = int(os.environ["PADDLE_TRAINERS"])
    import torch
    torch.set_num_threads(1)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    arrays, msgs = SCENARIOS[scenario](tid, world, workdir, lanes)
    stem = os.path.join(workdir, "rank%d_%s" % (tid, scenario))
    np.savez(stem + ".npz", **arrays)
    with open(stem + ".json", "w") as f:
        json.dump(msgs, f)


if __name__ == "__main__":
    main()
