"""ResNet training: paddle_tpu_torch against paddle_tpu on the CPU.

`get_model(is_train=True)` builds the JAX package's program op for op:
batch norm on batch statistics, a `remat_tag` at every block's output,
Momentum 0.9 with L2Decay(1e-4), the same var names, attrs and op order.

Momentum steps (lr 0.1) are compared two ways, from one startup scope
carried across from the JAX package:

  * `resnet_cifar10(depth=8)` (basic blocks), 32 x 32, batch 2, trains
    three steps free running in both packages, NCHW and NHWC.  In fp32
    the losses and every parameter, velocity and moving statistic agree
    to rtol 1e-5 of each array's largest magnitude.  Under AMP the first
    loss agrees to one bf16 ulp (2^-7), the losses fall and every state
    stays fp32 and moves; later losses and the states are not compared,
    because the JAX package sums a batch norm's bf16 scale and bias
    cotangents in bf16 (its bias grad lies 34% from the exact sum in the
    op-by-op test below, the port's 0.2%), and the steps carry that on.
  * The bottleneck ResNet-50 graph (`resnet_imagenet(depth=50)`, 10
    classes) is chaotic at a few images: at 32 x 32 and batch 2 its last
    stage normalises 2 values per channel, and moving the input by one
    float32 ulp moves the JAX package's own first loss 4.81 -> 5.40.
    Free-running trajectories of two correct implementations part there,
    and even one batch norm on the same inputs is ill-conditioned.  So
    the graph runs at batch 8 (8 values per channel in the last stage),
    and each of three steps is held op by op: the port runs
    every op of the step (forward, generic grads and their fan-in sums,
    the regularizer, Momentum) on the JAX package's values of that op's
    inputs, and every value it writes (activations, grads, the updated
    parameters, velocities and moving statistics) must lie within a
    Frobenius error of 1e-4 of the JAX package's in fp32 (measured:
    1.4e-5, a batch-norm variance summed in another order), and of 2^-5
    under AMP (four bf16 ulps; measured 0.8%, a scale grad summed from
    bf16 products), where a batch norm's scale and bias grads are held
    against their exact float64 sums instead of the JAX package's.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.models import resnet as jresnet
from paddle_tpu_torch.fluid import functionalizer as tfunc
from paddle_tpu_torch.fluid.executor import as_numpy, as_tensor
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.ops import registry as treg


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
def _amp_off_after():
    yield
    jfluid.set_amp(False)
    tfluid.set_amp(False)


def _op_list(program):
    return [(op.type, op.inputs, op.outputs,
             {k: v for k, v in op.attrs.items() if k != "fwd_uid"})
            for op in program.global_block().ops]


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_train_program_matches_jax(layout):
    """ResNet-50 at 224 x 224, 1000 classes, lr 0.1: the main and startup
    programs op for op (types, var names, attrs), the persistable set,
    and the optimizer's velocity and regularizer ops."""
    kw = dict(batch_size=4, depth=50, dataset="imagenet", lr=0.1,
              is_train=True, layout=layout)
    with jfluid.unique_name.guard():
        jm, js, _, jloss, jacc, _ = jresnet.get_model(**kw)
    with tfluid.unique_name.guard():
        tm, ts, _, tloss, tacc, _ = tresnet.get_model(**kw)
    assert (tloss.name, tacc.name) == (jloss.name, jacc.name)
    assert _op_list(tm) == _op_list(jm)
    assert _op_list(ts) == _op_list(js)
    assert tfunc.persistable_names(tm) == \
        jfluid.functionalizer.persistable_names(jm)
    types = [op.type for op in tm.global_block().ops]
    assert types.count("momentum") == len(tm.all_parameters()) == 161
    assert types.count("remat_tag") == 16
    assert all(op.attrs["mu"] == 0.9 for op in tm.global_block().ops
               if op.type == "momentum")
    decay = [op for op in tm.global_block().ops if op.type == "scale"
             and op.output("Out")[0].startswith("l2_decay")]
    assert len(decay) == 161
    assert all(op.attrs["scale"] == 1e-4 for op in decay)
    bn = [op for op in tm.global_block().ops if op.type == "batch_norm"]
    assert len(bn) == 53 and not any(op.attrs["is_test"] for op in bn)


# the bottleneck graph's op-by-op steps: its last stage normalises
# 1 x 1 x 8 = 8 values per channel
R50_BATCH, R50_HW = 8, 32


def _small_program(pkg, models, net, layout, hw=32):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        shape = [3, hw, hw] if layout == "NCHW" else [hw, hw, 3]
        image = pkg.layers.data(name="data", shape=shape, dtype="float32")
        label = pkg.layers.data(name="label", shape=[1], dtype="int64")
        if net == "cifar8":
            predict = models.resnet_cifar10(image, class_dim=10, depth=8,
                                            layout=layout)
        else:
            predict = models.resnet_imagenet(image, class_dim=10, depth=50,
                                             layout=layout)
        loss = pkg.layers.mean(pkg.layers.cross_entropy(predict, label))
        pkg.optimizer.Momentum(
            learning_rate=0.1, momentum=0.9,
            regularization=pkg.regularizer.L2Decay(1e-4)).minimize(loss)
    return main, startup, loss


def _feed(layout, seed=0, batch=2, hw=32):
    rng = np.random.RandomState(seed)
    shape = (batch, 3, hw, hw) if layout == "NCHW" else (batch, hw, hw, 3)
    return {"data": rng.randn(*shape).astype(np.float32),
            "label": rng.randint(0, 10, size=(batch, 1)).astype(np.int64)}


def _jax_start(jstartup):
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup)
    return jexe, jscope


def _state(jscope):
    return {n: np.asarray(jscope.get(n)) for n in jscope.keys()}


def _frobenius(got, want):
    """||got - want|| / ||want||, summed in float32 (the checks are at
    1e-4 and coarser)."""
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), 1e-30))


def _close(got, want, rtol, what):
    got = np.asarray(got).astype(np.float64)
    want = np.asarray(want).astype(np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_cifar8_trains_three_steps_like_jax(layout, amp):
    jm, js, jloss = _small_program(jfluid, jresnet, "cifar8", layout)
    tm, _, tloss = _small_program(tfluid, tresnet, "cifar8", layout)
    jexe, jscope = _jax_start(js)
    init = _state(jscope)
    tscope = tfluid.scope_from_jax(init, tfluid.Scope(), tfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    jfluid.set_amp(amp)
    tfluid.set_amp(amp)
    feed = _feed(layout)
    losses = {"jax": [], "torch": []}
    for _ in range(3):
        with jfluid.scope_guard(jscope):
            jl, = jexe.run(jm, feed=feed, fetch_list=[jloss])
        with tfluid.scope_guard(tscope):
            tl, = texe.run(tm, feed=feed, fetch_list=[tloss])
        losses["jax"].append(float(np.asarray(jl).ravel()[0]))
        losses["torch"].append(float(np.asarray(tl).ravel()[0]))
    if amp:
        np.testing.assert_allclose(losses["torch"][0], losses["jax"][0],
                                   rtol=2.0 ** -7)
    else:
        np.testing.assert_allclose(losses["torch"], losses["jax"],
                                   rtol=1e-5)
    assert losses["torch"][-1] < losses["torch"][0]
    names = sorted(init)
    assert any(n.endswith("_velocity_0") for n in names)
    assert any(n.endswith(".mean_0") for n in names)
    for n in names:
        t = tscope.get(n)
        assert t.dtype == torch.float32, n
        if amp:
            assert torch.isfinite(t).all(), n
            if n.endswith(("_velocity_0", ".mean_0", ".w_0")):
                assert not np.array_equal(as_numpy(t), init[n]), n
        else:
            _close(as_numpy(t), jscope.get(n), 1e-5, n)


# ---------------------------------------------------------------------------
# the bottleneck graph, op by op on the JAX package's values
# ---------------------------------------------------------------------------

def _writers(ops):
    """name -> index of the last op that writes it."""
    last = {}
    for i, op in enumerate(ops):
        for names in op.outputs.values():
            for n in names:
                if n:
                    last[n] = i
    return last


def _exact_affine_grads(op, jvals):
    """A batch norm's scale and bias grads as float64 sums, over every
    axis but the channel, of the JAX package's values: dY * xhat and
    dY, xhat from its X and saved statistics."""
    def val(slot):
        return np.asarray(jvals[op.inputs[slot][0]]).astype(np.float64)
    dy = val("GRAD:Y")
    c = dy.ndim - 1 if op.attrs["fwd_attrs"].get("data_layout") == "NHWC" \
        else 1

    def per_channel(t):
        return np.moveaxis(t, c, -1).reshape(-1, dy.shape[c])
    xhat = (per_channel(val("X")) - val("Out:SavedMean")) * \
        val("Out:SavedVariance")
    return {op.outputs["GRAD:Scale"][0]: (per_channel(dy) * xhat).sum(0),
            op.outputs["GRAD:Bias"][0]: per_channel(dy).sum(0)}


def _forced_step(tmain, state, feed, jvals, step, amp_affine_exact=False):
    """Run every op of the port's program on the JAX package's values of
    its inputs.  Returns how many values were compared (every value an
    op writes last) and the worst (Frobenius error relative to the JAX
    package's value, name, op type); integer values must be equal.
    With amp_affine_exact a batch norm's scale and bias grads are held
    against exact sums instead (_exact_affine_grads)."""
    exe = tfluid.Executor(tfluid.CPUPlace())
    env = {n: as_tensor(v) for n, v in state.items()}
    env.update(exe._prepare_feeds(tmain, feed))
    ops = tmain.global_block().ops
    last = _writers(ops)
    needed = {op.attrs["fwd_uid"] for op in ops
              if tfunc._is_generic_grad(op)}
    cache = {}
    checked = 0
    worst = (0.0, "", "")
    with torch.no_grad():
        for i, op in enumerate(ops):
            if tfunc._is_generic_grad(op):
                tfunc._run_grad_op(op, env, cache)
            else:
                od = treg.get_op_def(op.type)
                ctx = treg.ExecContext(op, tfunc._gather_inputs(op, env),
                                       step=step, seed=tmain.random_seed)
                if op.uid in needed:
                    outs, vjp = treg.make_forward_and_vjp(op, od, ctx)
                    cache[op.uid] = (vjp, outs)
                else:
                    outs = treg.call_lower(od, ctx)
                tfunc._write_outputs(op, outs, env)
            for names in op.outputs.values():
                for n in names:
                    if not n or last[n] != i:
                        continue
                    want = np.asarray(jvals[n])
                    got = as_numpy(env[n])
                    if want.dtype.kind in "iu":
                        np.testing.assert_array_equal(got, want, err_msg=n)
                    else:
                        assert got.dtype == want.dtype, n
                        ref = want
                        if amp_affine_exact and op.type == "batch_norm_grad":
                            ref = _exact_affine_grads(op, jvals).get(n, want)
                        worst = max(worst, (_frobenius(got, ref), n, op.type))
                    env[n] = as_tensor(want)
                    checked += 1
    return checked, worst


@pytest.mark.parametrize("layout,amp", [("NCHW", False), ("NHWC", True)],
                         ids=["nchw-fp32", "nhwc-amp"])
def test_bottleneck_resnet50_steps_match_jax_op_by_op(layout, amp):
    jm, js, jloss = _small_program(jfluid, jresnet, "r50", layout, R50_HW)
    tm, _, _ = _small_program(tfluid, tresnet, "r50", layout, R50_HW)
    jexe, jscope = _jax_start(js)
    names = sorted(set(n for op in jm.global_block().ops
                       for ns in op.outputs.values() for n in ns if n))
    jfluid.set_amp(amp)
    tfluid.set_amp(amp)
    tol = 2.0 ** -5 if amp else 1e-4
    for step in range(3):
        state = _state(jscope)
        feed = _feed(layout, step, R50_BATCH, R50_HW)
        with jfluid.scope_guard(jscope):
            vals = jexe.run(jm, feed=feed, fetch_list=names)
        jvals = dict(zip(names, vals))
        assert np.isfinite(np.asarray(jvals[jloss.name])).all()
        checked, (err, name, op_type) = _forced_step(
            tm, state, feed, jvals, step, amp_affine_exact=amp)
        assert checked == len(names)
        assert err <= tol, (step, name, op_type, err)
        for n in state:
            if n.endswith(("_velocity_0", ".mean_0", ".var_0", ".w_0")):
                assert not np.array_equal(jvals[n], state[n]), n
