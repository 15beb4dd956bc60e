"""The other optimizers and ModelAverage: paddle_tpu_torch against
paddle_tpu on the CPU.

Each update op's forward (lars_momentum, adamax, adagrad,
decayed_adagrad, adadelta, rmsprop plain and centered, ftrl at two
powers, proximal_gd, average_accumulates) and each math op that
clipping and the schedules append agrees with the JAX lowering to rtol
1e-6 (test_torch_ops.py holds their vjps); each optimizer class builds
the JAX program op for op and three steps of a small MLP agree (losses
and every state to rtol 1e-5 of each array's largest magnitude; 1e-4
for the states of Ftrl at lr_power -0.6, whose update subtracts two
close powers);
ModelAverage's window and its apply/restore agree with the JAX
package's; the module's names and aliases are the JAX package's."""

import types

import numpy as np
import pytest

import jax.numpy as jnp

from torch_train_parity import (Pair, assert_scaled_close, build_both,
                                program_ops)

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.fluid.executor import as_numpy, as_tensor
from paddle_tpu_torch.ops import registry as treg

# (op, inputs: slot -> kind, attrs); kinds: f randn, pos rand + 0.1,
# lr / b1p constants, i<n> an int64 [1] counter below n
_FORWARD = [
    ("lars_momentum", {"Param": "f", "Grad": "f", "Velocity": "f",
                       "LearningRate": "lr"},
     {"mu": 0.9, "lars_coeff": 0.001, "lars_weight_decay": 0.0005}),
    ("adamax", {"Param": "f", "Grad": "f", "Moment": "f", "InfNorm": "pos",
                "LearningRate": "lr", "Beta1Pow": "b1p"},
     {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    ("adagrad", {"Param": "f", "Grad": "f", "Moment": "pos",
                 "LearningRate": "lr"}, {"epsilon": 1e-6}),
    ("decayed_adagrad", {"Param": "f", "Grad": "f", "Moment": "pos",
                         "LearningRate": "lr"},
     {"decay": 0.95, "epsilon": 1e-6}),
    ("adadelta", {"Param": "f", "Grad": "f", "AvgSquaredGrad": "pos",
                  "AvgSquaredUpdate": "pos"}, {"rho": 0.95, "epsilon": 1e-6}),
    ("rmsprop", {"Param": "f", "Grad": "f", "MeanSquare": "pos",
                 "Moment": "f", "MeanGrad": "f", "LearningRate": "lr"},
     {"decay": 0.95, "epsilon": 1e-6, "momentum": 0.9, "centered": False}),
    ("rmsprop", {"Param": "f", "Grad": "f", "MeanSquare": "pos",
                 "Moment": "f", "MeanGrad": "pos", "LearningRate": "lr"},
     {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.0, "centered": True}),
    ("ftrl", {"Param": "f", "Grad": "f", "SquaredAccumulator": "pos",
              "LinearAccumulator": "f", "LearningRate": "lr"},
     {"l1": 0.1, "l2": 0.2, "lr_power": -0.5}),
    ("ftrl", {"Param": "f", "Grad": "f", "SquaredAccumulator": "pos",
              "LinearAccumulator": "f", "LearningRate": "lr"},
     {"l1": 0.0, "l2": 0.1, "lr_power": -0.7}),
    ("proximal_gd", {"Param": "f", "Grad": "f", "LearningRate": "lr"},
     {"l1": 0.5, "l2": 0.1}),
    ("average_accumulates", {
        "param": "f", "in_sum_1": "f", "in_sum_2": "f", "in_sum_3": "f",
        "in_num_accumulates": "i4", "in_old_num_accumulates": "i4",
        "in_num_updates": "i9"},
     {"average_window": 0.5, "min_average_window": 2,
      "max_average_window": 4}),
    ("exp", {"X": "f"}, {}), ("cos", {"X": "f"}, {}),
    ("sqrt", {"X": "pos"}, {}), ("ceil", {"X": "f"}, {}),
    ("abs", {"X": "f"}, {}), ("pow", {"X": "pos"}, {"factor": 1.7}),
    ("elementwise_div", {"X": "f", "Y": "pos"}, {"axis": -1}),
    ("elementwise_max", {"X": "f", "Y": "f"}, {"axis": -1}),
    ("elementwise_pow", {"X": "pos", "Y": "f"}, {"axis": -1}),
    ("clip", {"X": "f"}, {"min": -0.3, "max": 0.4}),
    ("clip_by_norm", {"X": "f"}, {"max_norm": 0.5}),
    ("squared_l2_norm", {"X": "f"}, {}),
]


def _input(kind, rng):
    if kind == "f":
        return rng.randn(5, 3).astype(np.float32)
    if kind == "pos":
        return rng.rand(5, 3).astype(np.float32) + 0.1
    if kind.startswith("i"):
        return rng.randint(0, int(kind[1:]), size=(1,)).astype(np.int64)
    return np.full((1,), {"lr": 0.05, "b1p": 0.9 ** 3}[kind], np.float32)


@pytest.mark.parametrize("case", range(len(_FORWARD)),
                         ids=["%s_%d" % (c[0], i)
                              for i, c in enumerate(_FORWARD)])
def test_forward_matches_jax_to_1e_6(case):
    op_type, kinds, attrs = _FORWARD[case]
    rng = np.random.RandomState(case)
    ins = {s: _input(k, rng) for s, k in kinds.items()}
    op = types.SimpleNamespace(type=op_type, uid=1, attrs=attrs, outputs={},
                               inputs={s: [s] for s in ins})
    jout = jreg.get_op_def(op_type).lower(jreg.ExecContext(
        op, {s: [jnp.asarray(a)] for s, a in ins.items()}))
    tout = treg.get_op_def(op_type).lower(treg.ExecContext(
        op, {s: [as_tensor(a)] for s, a in ins.items()}))
    assert sorted(tout) == sorted(jout)
    for slot in jout:
        want = np.asarray(jout[slot])
        got = as_numpy(tout[slot])
        assert got.shape == want.shape, slot
        np.testing.assert_allclose(got.astype(want.dtype), want, rtol=1e-6,
                                   atol=1e-7, err_msg=slot)


_OPTIMIZERS = {
    "lars_momentum": lambda pkg: pkg.optimizer.LarsMomentum(
        0.5, 0.9, lars_coeff=0.01, lars_weight_decay=0.001),
    "adagrad": lambda pkg: pkg.optimizer.Adagrad(0.1, epsilon=1e-5),
    "adamax": lambda pkg: pkg.optimizer.Adamax(0.02, beta1=0.8),
    "decayed_adagrad": lambda pkg: pkg.optimizer.DecayedAdagrad(0.05,
                                                                decay=0.9),
    "adadelta": lambda pkg: pkg.optimizer.Adadelta(1.0, rho=0.9),
    "rmsprop": lambda pkg: pkg.optimizer.RMSProp(0.01, momentum=0.5),
    "rmsprop_centered": lambda pkg: pkg.optimizer.RMSProp(0.01,
                                                          centered=True),
    "ftrl": lambda pkg: pkg.optimizer.Ftrl(0.1, l1=0.001, l2=0.01),
    "ftrl_power": lambda pkg: pkg.optimizer.Ftrl(0.1, lr_power=-0.6),
    "adam_schedule": lambda pkg: pkg.optimizer.Adam(
        pkg.layers.exponential_decay(0.01, 2, 0.5)),
}


def _mlp(opt, average=False):
    def fn(pkg, main):
        x = pkg.layers.data("x", shape=[12], dtype="float32")
        y = pkg.layers.data("y", shape=[1], dtype="int64")
        h = pkg.layers.fc(x, size=16, act="relu")
        logits = pkg.layers.fc(h, size=4)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, y))
        opt(pkg).minimize(loss)
        model_average = None
        if average:
            model_average = pkg.optimizer.ModelAverage(
                0.5, min_average_window=2, max_average_window=3)
        return loss, model_average
    return fn


def _feed(step):
    rng = np.random.RandomState(10 + step)
    return {"x": rng.randn(16, 12).astype(np.float32),
            "y": rng.randint(0, 4, size=(16, 1)).astype(np.int64)}


# Ftrl at a power other than -0.5 updates by (n_new^-p - n^-p) / lr * w,
# a difference of two close powers: the one-ulp differences of torch's
# and XLA's pow (each within 1e-7 of float64) come out of it as relative
# errors of a few 1e-5 on an element's weight after three steps
_STATE_RTOL = {"ftrl_power": 1e-4}


@pytest.mark.parametrize("name", sorted(_OPTIMIZERS))
def test_optimizer_builds_the_jax_program_and_trains_alike(name):
    built = build_both(_mlp(_OPTIMIZERS[name]))
    for i in (0, 1):
        assert program_ops(built["torch"][i]) == program_ops(built["jax"][i])
    pair = Pair(built)
    loss = built["torch"][2][0].name
    for step in range(3):
        (jl,), (tl,) = pair.step(_feed(step), [loss])
        assert_scaled_close(tl, jl, 1e-5, step)
    pair.assert_state_close(_STATE_RTOL.get(name, 1e-5))


def test_model_average_window_apply_and_restore_match_jax():
    built = build_both(_mlp(lambda pkg: pkg.optimizer.Momentum(0.1, 0.9),
                            average=True))
    for i in (0, 1):
        assert program_ops(built["torch"][i]) == program_ops(built["jax"][i])
    types_ = [op.type for op in built["torch"][0].global_block().ops]
    assert types_.count("average_accumulates") == 4
    pair = Pair(built)
    loss = built["torch"][2][0].name
    for step in range(5):  # past the window: sum_3 and the counters roll
        (jl,), (tl,) = pair.step(_feed(step), [loss])
        assert_scaled_close(tl, jl, 1e-5, step)
    pair.assert_state_close(1e-5)
    jma, tma = built["jax"][2][1], built["torch"][2][1]
    params = [p.name for p in tma.params]
    trained = {n: as_numpy(pair.tscope.get(n)) for n in params}
    with jfluid.scope_guard(pair.jscope), tfluid.scope_guard(pair.tscope):
        with jma.apply(pair.jexe), tma.apply(pair.texe):
            for n in params:
                want = np.asarray(pair.jscope.get(n))
                assert_scaled_close(as_numpy(pair.tscope.get(n)), want,
                                    1e-5, n)
                assert not np.array_equal(want, trained[n])
    for n in params:  # restored
        np.testing.assert_array_equal(as_numpy(pair.tscope.get(n)),
                                      trained[n])


def test_names_and_aliases_are_the_jax_packages():
    assert sorted(tfluid.optimizer.__all__) == \
        sorted(jfluid.optimizer.__all__)
    for name in jfluid.optimizer.__all__ + ["RMSProp"]:
        assert hasattr(tfluid.optimizer, name), name
    for alias, cls in (("LarsMomentum", "LarsMomentumOptimizer"),
                       ("Adamax", "AdamaxOptimizer"),
                       ("RMSProp", "RMSPropOptimizer"),
                       ("Ftrl", "FtrlOptimizer")):
        assert getattr(tfluid.optimizer, alias) is \
            getattr(tfluid.optimizer, cls)
    assert sorted(tfluid.clip.__all__) == sorted(
        set(jfluid.clip.__all__) | {"error_clip_callback"})
