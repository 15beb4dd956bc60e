"""bf16 automatic mixed precision and the bf16 op lowerings:
paddle_tpu_torch against paddle_tpu on the CPU.

`set_amp(True)` casts the inputs of the AMP_WHITE ops to bf16 and of the
AMP_BLACK ops to fp32 inside the differentiated lowering call, so fp32
master weights get fp32 gradients.  Held against the JAX package: the
lists themselves, each lowering of the AMP training path and of the bf16
serving path on the same bf16 (or AMP-cast) inputs, and three Adam steps
of an MLP and of a small transformer from one startup scope carried
across, under AMP in both packages."""

import types

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.models import transformer as jt
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.flags import FLAGS as TFLAGS
from paddle_tpu_torch.fluid.executor import as_numpy, as_tensor
from paddle_tpu_torch.models import transformer as tt
from paddle_tpu_torch.ops import pallas_kernels as tkernels
from paddle_tpu_torch.ops import registry as treg

BF16 = ml_dtypes.bfloat16
# one bf16 ulp relative (values that both sides round from fp32 sums taken
# in other orders may sit on neighbouring bf16 values)
ULP = 2.0 ** -7


@pytest.fixture(autouse=True)
def _amp_off_after():
    yield
    jfluid.set_amp(False)
    tfluid.set_amp(False)


def test_amp_lists_and_switches_are_the_jax_packages():
    assert treg.AMP_WHITE == jreg.AMP_WHITE
    assert treg.AMP_BLACK == jreg.AMP_BLACK
    assert "flash_attention" in treg.AMP_WHITE
    assert "fused_bottleneck" not in treg.AMP_WHITE
    assert not tfluid.amp_enabled()
    tfluid.set_amp(True)
    assert tfluid.amp_enabled() and treg.amp_enabled()
    tfluid.set_amp(False)
    TFLAGS.use_bf16_amp = True
    try:
        assert tfluid.amp_enabled()
    finally:
        TFLAGS.use_bf16_amp = False
    assert not tfluid.amp_enabled()


def test_amp_casts_white_and_black_inputs_but_never_lengths():
    seen = {}

    def spy(ctx):
        seen.update({slot: [v.dtype if isinstance(v, torch.Tensor) else v
                            for v in vals]
                     for slot, vals in ctx._inputs.items()})
        return {}

    od = treg.OpDef("mul", spy)
    op = types.SimpleNamespace(type="mul", uid=1, attrs={}, inputs={},
                               outputs={})
    ins = {"X": [torch.ones(2)], "Y": [torch.ones(2, dtype=torch.bfloat16)],
           "X@LOD_LEN": [torch.ones(2)],
           "I": [torch.ones(2, dtype=torch.int64), None]}
    tfluid.set_amp(True)
    treg.call_lower(od, treg.ExecContext(op, ins))
    assert seen == {"X": [torch.bfloat16], "Y": [torch.bfloat16],
                    "X@LOD_LEN": [torch.float32],
                    "I": [torch.int64, None]}
    od.type = "adam"
    treg.call_lower(od, treg.ExecContext(op, ins))
    assert seen["Y"] == [torch.float32] and seen["X"] == [torch.float32]
    od.type = "relu"
    treg.call_lower(od, treg.ExecContext(op, ins))
    assert seen["Y"] == [torch.bfloat16]
    tfluid.set_amp(False)
    od.type = "mul"
    treg.call_lower(od, treg.ExecContext(op, ins))
    assert seen["X"] == [torch.float32]


# ---------------------------------------------------------------------------
# one op in both packages, through each registry's call_lower
# ---------------------------------------------------------------------------

def _run_op(op_type, ins, attrs, amp):
    """{slot: [numpy]} -> ({slot: jax outs}, {slot: torch outs}) of one
    op's lowering in each package, AMP on or off in both."""
    op = types.SimpleNamespace(
        type=op_type, uid=1, attrs=attrs, outputs={},
        inputs={slot: ["%s%d" % (slot, i) for i in range(len(v))]
                for slot, v in ins.items()})
    jfluid.set_amp(amp)
    tfluid.set_amp(amp)
    try:
        jout = jreg.call_lower(jreg.get_op_def(op_type), jreg.ExecContext(
            op, {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}))
        tout = treg.call_lower(treg.get_op_def(op_type), treg.ExecContext(
            op, {s: [as_tensor(a) for a in v] for s, v in ins.items()}))
    finally:
        jfluid.set_amp(False)
        tfluid.set_amp(False)
    return jout, tout


def _compare(jout, tout, slots, exact=False):
    for slot in slots:
        j = jout[slot]
        j = np.asarray(j[0] if isinstance(j, (list, tuple)) else j)
        t = tout[slot]
        t = as_numpy(t[0] if isinstance(t, (list, tuple)) else t)
        assert t.shape == j.shape, (slot, t.shape, j.shape)
        if j.dtype.kind in "iu":
            # the JAX package runs without x64: its int64 is int32
            assert t.dtype.kind in "iu", (slot, t.dtype)
            np.testing.assert_array_equal(t, j, err_msg=slot)
            continue
        assert t.dtype == j.dtype, (slot, t.dtype, j.dtype)
        jf, tf = j.astype(np.float64), t.astype(np.float64)
        if exact:
            np.testing.assert_array_equal(tf, jf, err_msg=slot)
        else:
            rtol = ULP if j.dtype == BF16 else 1e-5
            np.testing.assert_allclose(tf, jf, rtol=rtol,
                                       atol=rtol * np.abs(jf).max(),
                                       err_msg=slot)


def _rand(rng, *shape, dtype=np.float32):
    return rng.randn(*shape).astype(np.float32).astype(dtype)


# the AMP training path's ops on fp32 (and, past a white op, bf16) inputs,
# AMP on: each output's dtype and values are the JAX lowering's
_AMP_CASES = {
    "mul": lambda r: ({"X": [_rand(r, 2, 5, 8)], "Y": [_rand(r, 8, 6)]},
                      {"x_num_col_dims": 2, "y_num_col_dims": 1}, ["Out"]),
    "matmul": lambda r: ({"X": [_rand(r, 3, 4, 8)], "Y": [_rand(r, 3, 6, 8)]},
                         {"transpose_Y": True, "alpha": 0.5}, ["Out"]),
    "elementwise_add": lambda r: (
        {"X": [_rand(r, 2, 5, 6, dtype=BF16)], "Y": [_rand(r, 6)]},
        {"axis": -1}, ["Out"]),
    "elementwise_add_0d": lambda r: (
        {"X": [_rand(r, 2, 3, dtype=BF16)],
         "Y": [np.asarray(1.37, np.float32)]}, {"axis": -1}, ["Out"]),
    "slice": lambda r: ({"Input": [_rand(r, 2, 4, 12, dtype=BF16)]},
                        {"axes": [2], "starts": [4], "ends": [8]}, ["Out"]),
    "reshape2": lambda r: ({"X": [_rand(r, 2, 4, 6, dtype=BF16)]},
                           {"shape": [-1, 6]}, ["Out"]),
    "gelu": lambda r: ({"X": [_rand(r, 4, 16, dtype=BF16)]}, {}, ["Out"]),
    "layer_norm": lambda r: (
        {"X": [_rand(r, 2, 3, 8, dtype=BF16)], "Scale": [_rand(r, 8)],
         "Bias": [_rand(r, 8)]}, {"begin_norm_axis": 2, "epsilon": 1e-5},
        ["Y", "Mean", "Variance"]),
    "softmax_with_cross_entropy": lambda r: (
        {"Logits": [_rand(r, 6, 10, dtype=BF16)],
         "Label": [r.randint(0, 10, size=(6, 1)).astype(np.int64)]}, {},
        ["Loss", "Softmax"]),
    "mean": lambda r: ({"X": [_rand(r, 4, 6, dtype=BF16)]}, {}, ["Out"]),
    "lookup_table": lambda r: (
        {"W": [_rand(r, 10, 4)],
         "Ids": [r.randint(0, 10, size=(2, 3)).astype(np.int64)]},
        {"padding_idx": -1}, ["Out"]),
    "adam": lambda r: (
        {"Param": [_rand(r, 5)], "Grad": [_rand(r, 5, dtype=BF16)],
         "Moment1": [_rand(r, 5) * 0.1], "Moment2": [np.abs(_rand(r, 5))],
         "Beta1Pow": [np.asarray([0.9], np.float32)],
         "Beta2Pow": [np.asarray([0.999], np.float32)],
         "LearningRate": [np.asarray([1e-3], np.float32)]},
        {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
        ["ParamOut", "Moment1Out", "Moment2Out"]),
}


@pytest.mark.parametrize("case", sorted(_AMP_CASES))
def test_amp_lowerings_match_jax(case):
    ins, attrs, slots = _AMP_CASES[case](np.random.RandomState(len(case)))
    jout, tout = _run_op(case.replace("_0d", ""), ins, attrs, amp=True)
    _compare(jout, tout, slots)


# the bf16 serving path's ops on bf16 inputs (AMP off): the JAX lowerings'
# dtypes and values.  Pooling, relu, the adds, softmax and top_k round
# the same fp32 values the same way: bit for bit
_BF16_CASES = {
    "conv2d": lambda r: (
        {"Input": [_rand(r, 2, 7, 7, 8, dtype=BF16)],
         "Filter": [_rand(r, 12, 8, 3, 3, dtype=BF16) * BF16(0.2)]},
        {"strides": [2, 2], "paddings": [1, 1], "data_format": "NHWC"},
        ["Output"], False),
    "elementwise_add": lambda r: (
        {"X": [_rand(r, 2, 4, 4, 8, dtype=BF16)],
         "Y": [_rand(r, 8, dtype=BF16)]}, {"axis": -1}, ["Out"], True),
    "relu": lambda r: ({"X": [_rand(r, 3, 9, dtype=BF16)]}, {}, ["Out"],
                       True),
    "pool2d_max": lambda r: (
        {"X": [_rand(r, 2, 9, 9, 4, dtype=BF16)]},
        {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
         "paddings": [1, 1], "data_format": "NHWC"}, ["Out"], True),
    "pool2d_avg_global": lambda r: (
        {"X": [_rand(r, 2, 7, 7, 16, dtype=BF16) * BF16(3)]},
        {"pooling_type": "avg", "global_pooling": True,
         "data_format": "NHWC"}, ["Out"], True),
    "pool2d_avg_padded": lambda r: (
        {"X": [_rand(r, 2, 8, 8, 4, dtype=BF16)]},
        {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
         "paddings": [1, 1], "data_format": "NHWC"}, ["Out"], True),
    "mul": lambda r: ({"X": [_rand(r, 4, 64, dtype=BF16)],
                       "Y": [_rand(r, 64, 10, dtype=BF16)]}, {}, ["Out"],
                      False),
    "softmax": lambda r: ({"X": [_rand(r, 4, 100, dtype=BF16) * BF16(3)]},
                          {}, ["Out"], True),
    "top_k": lambda r: ({"X": [_rand(r, 4, 50, dtype=BF16)]}, {"k": 5},
                        ["Out", "Indices"], True),
}


@pytest.mark.parametrize("case", sorted(_BF16_CASES))
def test_bf16_serving_lowerings_match_jax(case):
    ins, attrs, slots, exact = _BF16_CASES[case](
        np.random.RandomState(len(case)))
    jout, tout = _run_op(case.split("_")[0] if case.startswith("pool2d")
                         else case, ins, attrs, amp=False)
    _compare(jout, tout, slots, exact=exact)


def test_bf16_avg_pool_sums_in_bf16_one_element_at_a_time():
    """A 4 x 4 window of bf16 values whose fp32 sum rounds elsewhere than
    the running bf16 sum: the JAX lowering's (and so the port's) result is
    the sequential one."""
    x = np.full((1, 4, 4, 1), 1.0, np.float32)
    x[0, 0, 0, 0] = 256.0
    xb = x.astype(BF16)
    jout, tout = _run_op("pool2d", {"X": [xb]},
                         {"pooling_type": "avg", "global_pooling": True,
                          "data_format": "NHWC"}, amp=False)
    got = as_numpy(tout["Out"]).astype(np.float32).ravel()[0]
    assert got == np.asarray(jout["Out"]).astype(np.float32).ravel()[0]
    # 256 + 1 rounds back to 256 in bf16 every time: 256 / 16, not 271 / 16
    assert got == 16.0


# ---------------------------------------------------------------------------
# whole programs under AMP, three Adam steps, one startup scope carried
# ---------------------------------------------------------------------------

def _mlp(pkg):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 3
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[16], dtype="float32")
        y = pkg.layers.data("y", shape=[1], dtype="int64")
        h = pkg.layers.fc(x, size=32, act="relu")
        logits = pkg.layers.fc(h, size=4)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, y))
        pkg.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, loss


SMALL_TRANSFORMER = dict(batch_size=2, seq_len=32, vocab_size=64, d_model=64,
                         n_heads=2, n_layers=2, d_ff=128, lr=1e-3)


def _transformer(pkg, models):
    with pkg.unique_name.guard():
        main, startup, _, loss, _, _ = models.get_model(**SMALL_TRANSFORMER)
    drops = [op for op in main.global_block().ops if op.type == "dropout"]
    drops[0].attrs["dropout_prob"] = 0.0   # the RNG streams differ
    return main, startup, loss


def _train_both(jbuilt, tbuilt, feed, steps=3):
    """AMP on in both packages; the JAX startup scope carried across by
    name.  Returns (jax losses, torch losses, torch scope, params)."""
    (jm, js, jloss), (tm, _, tloss) = jbuilt, tbuilt
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(js)
    init = {n: np.asarray(jscope.get(n)) for n in jscope.keys()}
    tscope = tfluid.scope_from_jax(init, tfluid.Scope(), tfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    jfluid.set_amp(True)
    tfluid.set_amp(True)
    params = sorted(p.name for p in tm.all_parameters())
    losses = {"jax": [], "torch": []}
    grads = None
    for step in range(steps):
        fetch = [jloss.name] + ([p + "@GRAD" for p in params]
                                if step == 0 else [])
        with jfluid.scope_guard(jscope):
            jr = jexe.run(jm, feed=feed, fetch_list=fetch)
        with tfluid.scope_guard(tscope):
            tr = texe.run(tm, feed=feed, fetch_list=fetch)
        losses["jax"].append(float(np.asarray(jr[0]).ravel()[0]))
        losses["torch"].append(float(np.asarray(tr[0]).ravel()[0]))
        if step == 0:
            grads = tr[1:]
    return losses, tscope, params, grads


def _masters_fp32(tscope, params, grads):
    for name, g in zip(params, grads):
        assert tscope.get(name).dtype == torch.float32, name
        assert g.dtype == np.float32, name + "@GRAD"
    for name in tscope.keys():
        assert tscope.get(name).dtype != torch.bfloat16, name


def test_amp_mlp_matches_jax_and_keeps_fp32_masters():
    rng = np.random.RandomState(0)
    xs = rng.randn(32, 16).astype(np.float32)
    ys = (xs[:, :4].argmax(1)[:, None]).astype(np.int64)
    losses, tscope, params, grads = _train_both(
        _mlp(jfluid), _mlp(tfluid), {"x": xs, "y": ys})
    # bf16 matmuls on both sides, summed in other orders: a product may
    # round one bf16 ulp apart, which moves the loss ~2e-4 relative here
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=1e-3)
    assert losses["torch"][-1] < losses["torch"][0]
    _masters_fp32(tscope, params, grads)


def test_amp_transformer_matches_jax_and_keeps_fp32_masters():
    """2 layers, d_model 64, 2 heads of 32, seq 32: the bf16 matmuls and
    flash attention (K1/K2's bf16 plain versions against the JAX kernel
    pair) under AMP in both packages."""
    tokens = np.random.RandomState(1).randint(
        0, SMALL_TRANSFORMER["vocab_size"],
        size=(SMALL_TRANSFORMER["batch_size"],
              SMALL_TRANSFORMER["seq_len"] + 1))
    feed = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    tkernels.reset_launch_counts()
    losses, tscope, params, grads = _train_both(
        _transformer(jfluid, jt), _transformer(tfluid, tt), feed)
    # as the MLP: bf16 roundings one ulp apart, through 2 layers
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=1e-3)
    assert losses["torch"][-1] < losses["torch"][0]
    _masters_fp32(tscope, params, grads)
    assert all(n == 0 for n in tkernels.launch_counts.values())


def test_amp_flash_attention_gets_bf16_and_returns_bf16():
    """Under AMP the transformer's attention op sees bf16 q/k/v (the white
    list casts the fp32 qkv slices) and hands bf16 to the projection."""
    main, startup, loss = _transformer(tfluid, tt)
    seen = []
    od = treg.get_op_def("flash_attention")
    lower = od.lower

    def spy(ctx):
        out = lower(ctx)
        seen.append((ctx.input("Q").dtype, out["Out"].dtype))
        return out

    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    tokens = np.random.RandomState(2).randint(0, 64, size=(2, 33))
    od.lower = spy
    try:
        with tfluid.scope_guard(scope):
            exe.run(startup)
            tfluid.set_amp(True)
            exe.run(main, feed={"tokens": tokens[:, :-1],
                                "labels": tokens[:, 1:]},
                    fetch_list=[loss])
    finally:
        od.lower = lower
    assert seen == [(torch.bfloat16, torch.bfloat16)] * 2
