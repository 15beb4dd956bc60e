"""The MNIST CNN (conv5x5x20/pool2, conv5x5x50/pool2, fc10): the port's
`models.mnist.get_model` builds the JAX package's program op for op, and
three steps under Adam (the default) and under Momentum (`use_adam=
False`) agree with the JAX package on the CPU, from one startup scope
carried across: losses and accuracies to rtol 1e-5, and every parameter
and optimizer state to a Frobenius error of 1e-4 of the JAX package's
(a conv weight's grad sums 8 x 24 x 24 products in another order; where
a grad is near zero, Adam divides two moments near zero, and single
elements part by up to 9e-4 of themselves).  The smallest check
of conv2d and pool2d training through the generic `<type>_grad` ops, and
of `fluid.nets.simple_img_conv_pool`."""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.models import mnist as jmnist
from paddle_tpu_torch.fluid.executor import as_numpy
from paddle_tpu_torch.models import mnist as tmnist


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this file runs: the suite runs six
    workers on a few cores, and training steps at eight threads each
    oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ops(program):
    return [(op.type, op.inputs, op.outputs,
             {k: v for k, v in op.attrs.items() if k != "fwd_uid"})
            for op in program.global_block().ops]


@pytest.mark.parametrize("use_adam", [True, False], ids=["adam", "momentum"])
def test_mnist_trains_like_jax(use_adam):
    with jfluid.unique_name.guard():
        jm, js, _, jloss, jacc, _ = jmnist.get_model(lr=0.001,
                                                     use_adam=use_adam)
    with tfluid.unique_name.guard():
        tm, ts, _, tloss, tacc, _ = tmnist.get_model(lr=0.001,
                                                     use_adam=use_adam)
    assert _ops(tm) == _ops(jm)
    assert _ops(ts) == _ops(js)
    opt = "adam" if use_adam else "momentum"
    assert [op.type for op in tm.global_block().ops].count(opt) == 6

    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(js)
    init = {n: np.asarray(jscope.get(n)) for n in jscope.keys()}
    tscope = tfluid.scope_from_jax(init, tfluid.Scope(), tfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    rng = np.random.RandomState(11)
    feed = {"pixel": rng.rand(8, 1, 28, 28).astype(np.float32),
            "label": rng.randint(0, 10, size=(8, 1)).astype(np.int64)}
    got = {"jax": [], "torch": []}
    for _ in range(3):
        with jfluid.scope_guard(jscope):
            jl, ja = jexe.run(jm, feed=feed, fetch_list=[jloss, jacc])
        with tfluid.scope_guard(tscope):
            tl, ta = texe.run(tm, feed=feed, fetch_list=[tloss, tacc])
        got["jax"].append((float(np.asarray(jl).ravel()[0]),
                           float(np.asarray(ja).ravel()[0])))
        got["torch"].append((float(np.asarray(tl).ravel()[0]),
                             float(np.asarray(ta).ravel()[0])))
    np.testing.assert_allclose(got["torch"], got["jax"], rtol=1e-5)
    assert got["torch"][-1][0] < got["torch"][0][0]
    for n in init:
        want = np.asarray(jscope.get(n), np.float64)
        got = as_numpy(tscope.get(n)).astype(np.float64)
        assert got.shape == want.shape, n
        assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want), n


def test_img_conv_group_builds_the_jax_program():
    """Two 3x3 convs with batch norm and dropout, then a max pool."""
    def build(pkg):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            x = pkg.layers.data("x", shape=[3, 16, 16], dtype="float32")
            out = pkg.nets.img_conv_group(
                input=x, conv_num_filter=[8, 8], pool_size=2,
                conv_act="relu", conv_with_batchnorm=True,
                conv_batchnorm_drop_rate=[0.3, 0.0], pool_stride=2)
        return main, startup, out

    jm, js, jout = build(jfluid)
    tm, ts, tout = build(tfluid)
    assert _ops(tm) == _ops(jm) and _ops(ts) == _ops(js)
    assert tuple(tout.shape) == tuple(jout.shape) == (-1, 8, 8, 8)
    types = [op.type for op in tm.global_block().ops]
    assert (types.count("conv2d"), types.count("batch_norm"),
            types.count("dropout"), types[-1]) == (2, 2, 1, "pool2d")
