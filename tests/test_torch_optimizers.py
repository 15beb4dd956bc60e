"""SGD, Momentum and weight decay: paddle_tpu_torch against paddle_tpu on
the CPU.

The `sgd`, `momentum` (plain and Nesterov) and `sign` lowerings on the
same inputs agree with the JAX package's to rtol 1e-6; the program that
`minimize` builds with L2Decay or L1Decay, global or per parameter (a
parameter's own regularizer wins), is the JAX package's op for op: types,
var names and attrs; and three steps of a small MLP under each optimizer
agree (losses and every state to rtol 1e-5 of each array's largest
magnitude), from one startup scope carried across; `momentum` on a
SelectedRows grad, and Momentum under a parameter's GradientClipByValue,
against the JAX package."""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.fluid.executor import as_numpy, as_tensor
from paddle_tpu_torch.ops import registry as treg


def _lower_both(op_type, ins, attrs):
    op = types.SimpleNamespace(
        type=op_type, uid=1, attrs=attrs, outputs={},
        inputs={slot: ["%s%d" % (slot, i) for i in range(len(v))]
                for slot, v in ins.items()})
    jout = jreg.call_lower(jreg.get_op_def(op_type), jreg.ExecContext(
        op, {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}))
    tout = treg.call_lower(treg.get_op_def(op_type), treg.ExecContext(
        op, {s: [as_tensor(a) for a in v] for s, v in ins.items()}))
    return jout, tout


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


_CASES = {
    "sgd": lambda r: ("sgd", {"Param": [_rand(r, 4, 5)],
                              "Grad": [_rand(r, 4, 5)],
                              "LearningRate": [np.asarray([0.1],
                                                          np.float32)]},
                      {}, ["ParamOut"]),
    "momentum": lambda r: ("momentum", {
        "Param": [_rand(r, 7)], "Grad": [_rand(r, 7)],
        "Velocity": [_rand(r, 7)],
        "LearningRate": [np.asarray([0.05], np.float32)]},
        {"mu": 0.9, "use_nesterov": False}, ["ParamOut", "VelocityOut"]),
    "momentum_nesterov": lambda r: ("momentum", {
        "Param": [_rand(r, 3, 4)], "Grad": [_rand(r, 3, 4)],
        "Velocity": [_rand(r, 3, 4)],
        "LearningRate": [np.asarray([0.05], np.float32)]},
        {"mu": 0.8, "use_nesterov": True}, ["ParamOut", "VelocityOut"]),
    "sign": lambda r: ("sign", {"X": [np.asarray(
        [-2.5, -0.0, 0.0, 1e-30, -1e-30, 3.0, np.inf, -np.inf],
        np.float32)]}, {}, ["Out"]),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_lowering_matches_jax(case):
    op_type, ins, attrs, slots = _CASES[case](np.random.RandomState(3))
    jout, tout = _lower_both(op_type, ins, attrs)
    for slot in slots:
        want = np.asarray(jout[slot])
        got = as_numpy(tout[slot])
        assert got.dtype == want.dtype and got.shape == want.shape, slot
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0,
                                   err_msg=slot)


def test_sign_keeps_nan():
    _, tout = _lower_both("sign", {"X": [np.asarray([np.nan, -1.0],
                                                    np.float32)]}, {})
    got = as_numpy(tout["Out"])
    assert np.isnan(got[0]) and got[1] == -1.0


def test_sparse_grad_raises():
    """momentum on a SelectedRows grad (a sparse embedding's: duplicate
    rows, a padding id past the table) densifies it, as the JAX lowering
    does, and agrees with the JAX package to rtol 1e-6."""
    from paddle_tpu.fluid.selected_rows import SelectedRowsValue as JSR
    from paddle_tpu_torch.fluid.selected_rows import SelectedRowsValue as TSR
    rng = np.random.RandomState(4)
    p, v = _rand(rng, 6, 3), _rand(rng, 6, 3)
    rows = np.asarray([1, 4, 1, 6], np.int32)  # 6 == height: dropped
    vals = _rand(rng, 4, 3)
    lr = np.asarray([0.05], np.float32)
    op = types.SimpleNamespace(type="momentum", uid=1, outputs={},
                               attrs={"mu": 0.9, "use_nesterov": False},
                               inputs={})
    jout = jreg.get_op_def("momentum").lower(jreg.ExecContext(op, {
        "Param": [jnp.asarray(p)], "Velocity": [jnp.asarray(v)],
        "LearningRate": [jnp.asarray(lr)],
        "Grad": [JSR(jnp.asarray(rows), jnp.asarray(vals), 6)]}))
    tout = treg.get_op_def("momentum").lower(treg.ExecContext(op, {
        "Param": [as_tensor(p)], "Velocity": [as_tensor(v)],
        "LearningRate": [as_tensor(lr)],
        "Grad": [TSR(as_tensor(rows), as_tensor(vals), 6)]}))
    for slot in ("ParamOut", "VelocityOut"):
        np.testing.assert_allclose(as_numpy(tout[slot]),
                                   np.asarray(jout[slot]), rtol=1e-6,
                                   atol=1e-7)


def _mlp(pkg, opt, reg, per_param):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[12], dtype="float32")
        y = pkg.layers.data("y", shape=[1], dtype="int64")
        attr = None
        if per_param:
            attr = pkg.ParamAttr(regularizer=getattr(
                pkg.regularizer, per_param)(3e-3))
        h = pkg.layers.fc(x, size=16, act="relu", param_attr=attr)
        logits = pkg.layers.fc(h, size=4)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, y))
        kw = {}
        if reg:
            kw["regularization"] = getattr(pkg.regularizer, reg)(1e-2)
        if opt == "sgd":
            o = pkg.optimizer.SGD(learning_rate=0.2, **kw)
        elif opt == "nesterov":
            o = pkg.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                       use_nesterov=True, **kw)
        else:
            o = pkg.optimizer.Momentum(learning_rate=0.1, momentum=0.9, **kw)
        o.minimize(loss)
    return main, startup, loss


def _ops(program):
    return [(op.type, op.inputs, op.outputs,
             {k: v for k, v in op.attrs.items() if k != "fwd_uid"})
            for op in program.global_block().ops]


# (optimizer, global regularizer, the first fc weight's own regularizer)
_PROGRAMS = [
    ("sgd", None, None), ("momentum", None, None),
    ("momentum", "L2Decay", None), ("momentum", "L1Decay", None),
    ("nesterov", "L2DecayRegularizer", "L1DecayRegularizer"),
    ("sgd", None, "L2Decay"), ("momentum", "L1Decay", "L2Decay"),
]


@pytest.mark.parametrize("opt,reg,per_param", _PROGRAMS)
def test_minimize_builds_the_jax_program_and_trains_alike(opt, reg,
                                                          per_param):
    jm, js, jloss = _mlp(jfluid, opt, reg, per_param)
    tm, ts, tloss = _mlp(tfluid, opt, reg, per_param)
    assert _ops(tm) == _ops(jm)
    assert _ops(ts) == _ops(js)
    # 4 params; the first fc weight's own regularizer wins over `reg`
    effective = [per_param or reg] + [reg] * 3
    types_ = [op.type for op in tm.global_block().ops]
    assert types_.count("sgd" if opt == "sgd" else "momentum") == 4
    assert types_.count("sign") == sum(
        1 for r in effective if r and r.startswith("L1"))
    assert sum(1 for op in tm.global_block().ops if op.type == "sum"
               and op.output("Out")[0].startswith("regularized")) == sum(
        1 for r in effective if r)

    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(js)
    init = {n: np.asarray(jscope.get(n)) for n in jscope.keys()}
    tscope = tfluid.scope_from_jax(init, tfluid.Scope(), tfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    rng = np.random.RandomState(7)
    feed = {"x": rng.randn(16, 12).astype(np.float32),
            "y": rng.randint(0, 4, size=(16, 1)).astype(np.int64)}
    losses = {"jax": [], "torch": []}
    for _ in range(3):
        with jfluid.scope_guard(jscope):
            jl, = jexe.run(jm, feed=feed, fetch_list=[jloss])
        with tfluid.scope_guard(tscope):
            tl, = texe.run(tm, feed=feed, fetch_list=[tloss])
        losses["jax"].append(float(np.asarray(jl).ravel()[0]))
        losses["torch"].append(float(np.asarray(tl).ravel()[0]))
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=1e-5)
    assert losses["torch"][-1] < losses["torch"][0]
    for n in init:
        want = np.asarray(jscope.get(n))
        np.testing.assert_allclose(as_numpy(tscope.get(n)), want,
                                   rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()),
                                   err_msg=n)


def test_gradient_clip_still_raises():
    """Momentum with a parameter's GradientClipByValue: the program that
    minimize builds is the JAX package's op for op (the clip op before
    the update), and three steps train alike."""
    def build(pkg):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 5
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            x = pkg.layers.data("x", shape=[12], dtype="float32")
            y = pkg.layers.data("y", shape=[1], dtype="int64")
            w = pkg.ParamAttr(
                gradient_clip=pkg.clip.GradientClipByValue(0.01))
            logits = pkg.layers.fc(x, size=4, param_attr=w)
            loss = pkg.layers.mean(
                pkg.layers.softmax_with_cross_entropy(logits, y))
            pkg.optimizer.Momentum(0.1, 0.9).minimize(loss)
        return main, startup, loss

    jm, js, jloss = build(jfluid)
    tm, ts, tloss = build(tfluid)
    assert _ops(tm) == _ops(jm) and _ops(ts) == _ops(js)
    types_ = [op.type for op in tm.global_block().ops]
    assert types_.count("clip") == 1 and \
        types_.index("clip") < types_.index("momentum")
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(js)
    init = {n: np.asarray(jscope.get(n)) for n in jscope.keys()}
    tscope = tfluid.scope_from_jax(init, tfluid.Scope(), tfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    rng = np.random.RandomState(3)
    feed = {"x": rng.randn(16, 12).astype(np.float32),
            "y": rng.randint(0, 4, size=(16, 1)).astype(np.int64)}
    for _ in range(3):
        with jfluid.scope_guard(jscope):
            jl, = jexe.run(jm, feed=feed, fetch_list=[jloss])
        with tfluid.scope_guard(tscope):
            tl, = texe.run(tm, feed=feed, fetch_list=[tloss])
        np.testing.assert_allclose(np.asarray(tl).ravel(),
                                   np.asarray(jl).ravel(), rtol=1e-5)
    for n in init:
        want = np.asarray(jscope.get(n))
        np.testing.assert_allclose(as_numpy(tscope.get(n)), want,
                                   rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()),
                                   err_msg=n)
