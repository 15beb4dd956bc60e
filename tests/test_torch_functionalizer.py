"""Whole-graph AD, rematerialization and run_loop on the port
(fluid/functionalizer.py), on the CPU.

* `FLAGS.whole_graph_ad` serves the backward region with one
  torch.autograd.grad over the forward region: three Momentum steps of a
  small residual net agree with the per-op path (losses and every state
  to rtol 1e-5 of each array's largest magnitude: autograd sums the
  fan-in grads in another order than the `sum` ops), and with the JAX
  package's whole-graph step (`build_whole_graph_step_fn` through its
  Executor), to the same tolerance.
* Each remat policy recomputes (the forward lowerings run again in the
  backward) and changes no result: losses and states equal the
  no-remat run's bit for bit, a dropout inside a recomputed segment
  included (its generator is seeded per op and step).
* A policy name the JAX package does not know raises; a remat policy on a
  program whole-graph AD cannot serve raises instead of running per op.
* `Executor.run_loop(steps=K)` equals K `Executor.run` calls bit for bit,
  dropout included, and advances the step counter only on success.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.flags import get_flags, set_flags
from paddle_tpu.models import resnet as jresnet
from paddle_tpu_torch.flags import FLAGS
from paddle_tpu_torch.fluid import functionalizer
from paddle_tpu_torch.fluid.executor import as_numpy
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.ops import registry


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this file runs: the suite runs six
    workers on a few cores, and training steps at eight threads each
    oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _flags_back():
    yield
    FLAGS.whole_graph_ad = False
    FLAGS.remat_policy = ""


def _net(pkg, models, dropout=0.0):
    """conv-bn, two tagged basic blocks (a dropout between them), fc;
    Momentum 0.1 with L2Decay."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 9
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        image = pkg.layers.data(name="data", shape=[3, 16, 16],
                                dtype="float32")
        label = pkg.layers.data(name="label", shape=[1], dtype="int64")
        x = models.conv_bn_layer(image, 8, 3, 1, 1)
        x = models.basic_block(x, 8, 1)
        if dropout:
            x = pkg.layers.dropout(x, dropout_prob=dropout)
        x = models.basic_block(x, 16, 2)
        x = pkg.layers.pool2d(x, pool_type="avg", global_pooling=True)
        predict = pkg.layers.fc(x, size=5, act="softmax")
        loss = pkg.layers.mean(pkg.layers.cross_entropy(predict, label))
        pkg.optimizer.Momentum(
            learning_rate=0.1, momentum=0.9,
            regularization=pkg.regularizer.L2Decay(1e-4)).minimize(loss)
    return main, startup, loss


def _feed(seed=0):
    rng = np.random.RandomState(seed)
    return {"data": rng.randn(4, 3, 16, 16).astype(np.float32),
            "label": rng.randint(0, 5, size=(4, 1)).astype(np.int64)}


def _jax_init(js):
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(js)
    return {n: np.asarray(scope.get(n)) for n in scope.keys()}


def _train(main, loss, init, steps=3, feed=None):
    """`steps` Executor.run calls from `init`; (losses, {name: numpy})."""
    scope = tfluid.scope_from_jax(init, tfluid.Scope(), tfluid.CPUPlace())
    exe = tfluid.Executor(tfluid.CPUPlace())
    losses = []
    with tfluid.scope_guard(scope):
        for _ in range(steps):
            out, = exe.run(main, feed=feed or _feed(), fetch_list=[loss])
            losses.append(float(np.asarray(out).ravel()[0]))
    return losses, {n: as_numpy(scope.get(n)) for n in scope.keys()}


def _close(got, want, rtol=1e-5):
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_allclose(
            got[n], want[n], rtol=rtol,
            atol=rtol * float(np.abs(want[n]).max()), err_msg=n)


@pytest.fixture(scope="module")
def net():
    jm, js, jloss = _net(jfluid, jresnet)
    tm, _, tloss = _net(tfluid, tresnet)
    return jm, jloss, tm, tloss, _jax_init(js)


def test_whole_graph_matches_per_op(net):
    _, _, tm, tloss, init = net
    per_op = _train(tm, tloss, init)
    FLAGS.whole_graph_ad = True
    whole = _train(tm, tloss, init)
    np.testing.assert_allclose(whole[0], per_op[0], rtol=1e-5)
    assert whole[0][-1] < whole[0][0]
    _close(whole[1], per_op[1])
    assert any(n.endswith(".mean_0") for n in init)


def test_whole_graph_matches_jax_whole_graph(net):
    jm, jloss, tm, tloss, init = net
    old = get_flags(["whole_graph_ad"])
    set_flags({"whole_graph_ad": True})
    try:
        jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
        for n, v in init.items():
            jscope.set(n, v)
        jlosses = []
        with jfluid.scope_guard(jscope):
            for _ in range(3):
                out, = jexe.run(jm, feed=_feed(), fetch_list=[jloss])
                jlosses.append(float(np.asarray(out).ravel()[0]))
    finally:
        set_flags(old)
    FLAGS.whole_graph_ad = True
    losses, state = _train(tm, tloss, init)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    _close(state, {n: np.asarray(jscope.get(n)) for n in jscope.keys()})


def test_whole_graph_runs_one_autograd_grad(net, monkeypatch):
    """One torch.autograd.grad a step, and no generic grad op runs."""
    _, _, tm, tloss, init = net
    calls = []
    grad = torch.autograd.grad
    monkeypatch.setattr(torch.autograd, "grad",
                        lambda *a, **k: calls.append(1) or grad(*a, **k))
    FLAGS.whole_graph_ad = True
    _train(tm, tloss, init, steps=2)
    assert len(calls) == 2
    calls.clear()
    FLAGS.whole_graph_ad = False
    _train(tm, tloss, init, steps=1)
    assert len(calls) == sum(1 for op in tm.global_block().ops
                             if functionalizer._is_generic_grad(op))


def _count_lowerings(monkeypatch, op_type):
    od = registry.get_op_def(op_type)
    lower, calls = od.lower, []

    def counted(ctx):
        calls.append(1)
        return lower(ctx)
    monkeypatch.setattr(od, "lower", counted)
    return calls


@pytest.mark.parametrize("policy", ["block_out", "conv_out", "dots",
                                    "nothing", "conv_out,block_out"])
def test_remat_policy_changes_no_result(policy, monkeypatch):
    _, js, _ = _net(jfluid, jresnet, dropout=0.3)
    tm, _, tloss = _net(tfluid, tresnet, dropout=0.3)
    init = _jax_init(js)
    FLAGS.whole_graph_ad = True
    convs = _count_lowerings(monkeypatch, "conv2d")
    base = _train(tm, tloss, init)
    n_convs = len(convs)
    convs.clear()
    FLAGS.remat_policy = policy
    remat = _train(tm, tloss, init)
    # the forward lowerings run again in the backward
    assert len(convs) > n_convs
    assert remat[0] == base[0]
    for n in base[1]:
        np.testing.assert_array_equal(remat[1][n], base[1][n], err_msg=n)


def test_remat_segments_cut_at_block_out_tags():
    tm, _, _ = _net(tfluid, tresnet)
    fwd, _, loss = functionalizer._partition_whole_graph(tm.global_block())
    policy = functionalizer._resolve_remat_policy("block_out")
    segs = functionalizer._segments(fwd, policy.segment_tags)
    assert len(segs) == 3
    assert [s[-1].type for s in segs[:2]] == ["remat_tag"] * 2
    assert sum(len(s) for s in segs) == len(fwd)
    assert any(loss in op.output_arg_names for op in segs[-1])
    assert functionalizer._resolve_remat_policy(None) is None
    assert functionalizer._resolve_remat_policy("conv_out").save_ops


@pytest.mark.parametrize("policy", ["conv", "block_out,typo", "", " , "])
def test_unknown_remat_policy_raises(policy):
    if policy == "":
        assert functionalizer._resolve_remat_policy(None) is None
        policy = " , "
    with pytest.raises(ValueError, match="unknown remat policy"):
        functionalizer._resolve_remat_policy(policy)
    with pytest.raises(TypeError):
        functionalizer._resolve_remat_policy(len)


def test_remat_on_an_ineligible_program_raises(net):
    """Fetching an activation's grad needs the per-op path: whole-graph AD
    falls back to it, and a remat policy refuses to run unlabelled."""
    _, _, tm, tloss, init = net
    act = [op for op in tm.global_block().ops
           if op.type == "remat_tag"][0].output("Out")[0]
    fetch = [tloss, act + "@GRAD"]
    scope = tfluid.scope_from_jax(init, tfluid.Scope(), tfluid.CPUPlace())
    exe = tfluid.Executor(tfluid.CPUPlace())
    FLAGS.whole_graph_ad = True
    with tfluid.scope_guard(scope):
        loss, g = exe.run(tm, feed=_feed(), fetch_list=fetch)
        assert np.isfinite(g).all() and g.shape == (4, 8, 16, 16)
        FLAGS.remat_policy = "block_out"
        with pytest.raises(RuntimeError, match="ineligible"):
            exe.run(tm, feed=_feed(), fetch_list=fetch)
    assert functionalizer.build_whole_graph_step_fn(
        tm, ["data", "label"], [act + "@GRAD"], []) is None


def test_executor_caches_one_step_fn_per_flags(net):
    _, _, tm, tloss, init = net
    scope = tfluid.scope_from_jax(init, tfluid.Scope(), tfluid.CPUPlace())
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(scope):
        for wga, remat in [(False, ""), (False, ""), (True, ""),
                           (True, "block_out"), (True, "")]:
            FLAGS.whole_graph_ad, FLAGS.remat_policy = wga, remat
            exe.run(tm, feed=_feed(), fetch_list=[tloss])
    assert len(exe._cache) == 3


@pytest.mark.parametrize("whole_graph", [False, True],
                         ids=["per_op", "whole_graph"])
def test_run_loop_equals_k_runs(whole_graph):
    _, js, _ = _net(jfluid, jresnet, dropout=0.3)
    tm, _, tloss = _net(tfluid, tresnet, dropout=0.3)
    init = _jax_init(js)
    FLAGS.whole_graph_ad = whole_graph
    losses, state = _train(tm, tloss, init, steps=4)
    scope = tfluid.scope_from_jax(init, tfluid.Scope(), tfluid.CPUPlace())
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(scope):
        out, = exe.run_loop(tm, feed=_feed(), fetch_list=[tloss], steps=4)
        assert exe._step_counters[id(tm)] == 4
        with pytest.raises(registry.OpError):
            exe.run_loop(tm, feed={"data": _feed()["data"]},
                         fetch_list=[tloss], steps=2)
        assert exe._step_counters[id(tm)] == 4
        with pytest.raises(ValueError, match="steps"):
            exe.run_loop(tm, feed=_feed(), fetch_list=[tloss], steps=0)
    assert float(np.asarray(out).ravel()[0]) == losses[-1]
    for n in state:
        np.testing.assert_array_equal(as_numpy(scope.get(n)), state[n],
                                      err_msg=n)
    # the dropout masks differ per step: four steps on one feed are not
    # four copies of the first
    assert len(set(losses)) == 4


def test_dropout_draws_per_step():
    """run_loop folds the step: a loop from step 0 and one from step 2
    end in other states."""
    _, js, _ = _net(jfluid, jresnet, dropout=0.5)
    tm, _, tloss = _net(tfluid, tresnet, dropout=0.5)
    init = _jax_init(js)
    ends = []
    for step0 in (0, 2):
        scope = tfluid.scope_from_jax(init, tfluid.Scope(),
                                      tfluid.CPUPlace())
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe._step_counters[id(tm)] = step0
        with tfluid.scope_guard(scope):
            out, = exe.run_loop(tm, feed=_feed(), fetch_list=[tloss],
                                steps=1)
        ends.append(float(np.asarray(out).ravel()[0]))
    assert ends[0] != ends[1]


@pytest.mark.cuda
def test_cuda_amp_whole_graph_step_matches_per_op():
    """On the card under AMP: one whole-graph step of the small residual
    net against its per-op step from one scope (the loss to one bf16
    ulp, every state to a Frobenius error of 2^-6: the fan-in grads sum
    bf16 products in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    _, js, _ = _net(jfluid, jresnet)
    tm, _, tloss = _net(tfluid, tresnet)
    init = _jax_init(js)
    runs = {}
    tfluid.set_amp(True)
    try:
        for whole in (False, True):
            FLAGS.whole_graph_ad = whole
            scope = tfluid.scope_from_jax(init, tfluid.Scope(),
                                          tfluid.CUDAPlace(0))
            exe = tfluid.Executor(tfluid.CUDAPlace(0))
            with tfluid.scope_guard(scope):
                out, = exe.run(tm, feed=_feed(), fetch_list=[tloss])
            runs[whole] = (float(np.asarray(out).ravel()[0]),
                           {n: scope.get(n) for n in scope.keys()})
    finally:
        tfluid.set_amp(False)
    np.testing.assert_allclose(runs[True][0], runs[False][0],
                               rtol=2.0 ** -7)
    for n, want in runs[False][1].items():
        got = runs[True][1][n]
        assert got.dtype == want.dtype == torch.float32, n
        err = float(torch.linalg.vector_norm(got - want) /
                    torch.linalg.vector_norm(want).clamp_min(1e-30))
        assert err <= 2.0 ** -6, (n, err)
