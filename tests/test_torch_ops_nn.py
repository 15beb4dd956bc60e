"""The core nn ops of paddle_tpu_torch (one_hot, pad, pad2d,
conv2d_transpose, depthwise_conv2d, group_norm, the losses
sigmoid_cross_entropy_with_logits, smooth_l1_loss, huber_loss, log_loss,
hinge_loss and margin_rank_loss, bilinear_interp and nearest_interp)
held against the JAX lowerings on the CPU, forward and vjp; their
layers against the JAX layers, with a backward; the card twins against
the CPU."""

import numpy as np
import pytest
import torch

import torch_op_cases as cases
from test_torch_ops import RTOL, ATOL, _assert_parity
from torch_train_parity import Pair, build_both, program_ops

_IDS = [c[0] for c in cases.NN_CASES]


@pytest.mark.parametrize("case", cases.NN_CASES, ids=_IDS)
def test_nn_lowering_matches_jax_forward_and_vjp(case):
    inputs, rng = cases.case_inputs(case)
    _assert_parity(case[1], case[3], inputs, rng)


@pytest.mark.cuda
@pytest.mark.parametrize("case", cases.NN_CASES, ids=_IDS)
def test_cuda_nn_lowering_matches_cpu(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    worst, where = cases.max_mismatch(cases.run_case(case, "cuda"),
                                      cases.run_case(case, "cpu"),
                                      RTOL, ATOL)
    assert worst <= 0, (case[0], where, worst)


def _nn_layers(pkg, main):
    L = pkg.layers
    img = L.data("img", shape=[4, 6, 6], dtype="float32")
    ids = L.data("ids", shape=[1], dtype="int64")
    lab = L.data("lab", shape=[1], dtype="float32")
    up = L.conv2d_transpose(img, num_filters=6, filter_size=3, stride=2,
                            padding=1, act="relu")
    up2 = L.conv2d_transpose(img, num_filters=4, output_size=8, groups=2)
    gn = L.group_norm(up, groups=3, act="tanh")
    dw = L.conv2d(gn, num_filters=6, filter_size=3, groups=6, padding=1)
    rb = L.resize_bilinear(dw, out_shape=[5, 7])
    rn = L.resize_nearest(up2, scale=0.5)
    ir = L.image_resize(img, out_shape=[9, 4], align_corners=False,
                        align_mode=0)
    p = L.pad2d(rb, paddings=[1, 0, 2, 1], mode="reflect")
    q = L.pad(rn, paddings=[0, 0, 1, 0, 0, 1, 2, 0], pad_value=0.5)
    feat = L.reduce_mean(L.concat([L.flatten(p), L.flatten(q),
                                   L.flatten(ir)], axis=1), dim=1,
                         keep_dim=True)
    onehot = L.one_hot(ids, depth=5)
    pos = L.sigmoid(feat)
    losses = [L.sigmoid_cross_entropy_with_logits(feat, lab),
              L.smooth_l1(feat, lab, sigma=2.0), L.huber_loss(feat, lab, 0.5),
              L.log_loss(pos, lab), L.hinge_loss(feat, lab),
              L.margin_rank_loss(lab, feat, L.scale(feat, scale=0.5))]
    loss = L.mean(L.sums([L.reduce_sum(x) for x in losses])) + \
        L.reduce_sum(onehot) * 0.0
    pkg.optimizer.SGD(0.1).minimize(loss)
    return [loss, onehot, up, gn, rb, rn, ir, p, q] + losses


def test_nn_layers_build_the_jax_ops_and_train_alike():
    """The layers' program, with its backward and SGD update, is the JAX
    package's op for op; two steps from the JAX startup scope agree on
    every fetch and every parameter."""
    built = build_both(_nn_layers)
    assert program_ops(built["torch"][0]) == program_ops(built["jax"][0])
    pair = Pair(built)
    rng = np.random.RandomState(2)
    for step in range(2):
        feed = {"img": rng.randn(3, 4, 6, 6).astype(np.float32),
                "ids": np.array([[1], [4], [7]], np.int64),
                "lab": (rng.rand(3, 1) < 0.5).astype(np.float32)}
        jr, tr = pair.step(feed, built["torch"][2])
        for i, (j, t) in enumerate(zip(jr, tr)):
            np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL,
                                       err_msg="step %d fetch %d"
                                       % (step, i))
    pair.assert_state_close(rtol=RTOL)
