"""Sparse (SelectedRows) embedding gradients: paddle_tpu_torch against
paddle_tpu on the CPU.

`lookup_table_sparse_grad` (duplicate ids, padding_idx), SelectedRowsValue's
`merged` and `to_dense`, and the sparse paths of sgd, momentum, adam and
adagrad agree with the JAX package's to rtol 1e-6; `embedding(is_sparse=
True)` builds the JAX program op for op, a table with another consumer
declines to the dense grad in both; three training steps of a
bag-of-words classifier agree with the JAX package's (rtol 1e-5 of each
array's largest magnitude) under each optimizer with a JAX sparse path,
and the port's sparse program gives its dense program's results under the
others; whole-graph AD falls back to the per-op step as the JAX package's
does; the data-parallel step gathers a sparse grad's rows over the
ranks."""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_train_parity import (Pair, assert_scaled_close, build_both,
                                program_ops)

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.flags import FLAGS as JFLAGS
from paddle_tpu.fluid.selected_rows import SelectedRowsValue as JSR
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.flags import FLAGS as TFLAGS
from paddle_tpu_torch.fluid import functionalizer as tfunc
from paddle_tpu_torch.fluid.executor import as_numpy, as_tensor
from paddle_tpu_torch.fluid.selected_rows import SelectedRowsValue as TSR
from paddle_tpu_torch.ops import registry as treg

VOCAB, DIM, T, BATCH = 30, 6, 5, 8


def _op(op_type, attrs):
    return types.SimpleNamespace(type=op_type, uid=1, attrs=attrs,
                                 inputs={}, outputs={})


def _ids(seed):
    """[BATCH, T, 1] ids with duplicates across and within rows, and the
    padding id 2."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, VOCAB, size=(BATCH, T, 1)).astype(np.int64)
    ids[0, :3] = 7
    ids[1, 1] = 7
    ids[2, 0] = 2
    return ids


@pytest.mark.parametrize("squeeze", [True, False])
@pytest.mark.parametrize("padding_idx", [-1, 2])
def test_lookup_table_sparse_grad_matches_jax(squeeze, padding_idx):
    ids = _ids(1)
    if not squeeze:
        ids = ids[..., 0]
    rng = np.random.RandomState(2)
    w = rng.randn(VOCAB, DIM).astype(np.float32)
    d_out = rng.randn(BATCH, T, DIM).astype(np.float32)
    op = _op("lookup_table_sparse_grad", {"padding_idx": padding_idx})
    jout = jreg.get_op_def(op.type).lower(jreg.ExecContext(op, {
        "W": [jnp.asarray(w)], "Ids": [jnp.asarray(ids)],
        "GRAD:Out": [jnp.asarray(d_out)]}))["GRAD:W"]
    tout = treg.get_op_def(op.type).lower(treg.ExecContext(op, {
        "W": [as_tensor(w)], "Ids": [as_tensor(ids)],
        "GRAD:Out": [as_tensor(d_out)]}))["GRAD:W"]
    assert isinstance(tout, TSR) and tout.height == jout.height == VOCAB
    assert tout.rows.dtype == torch.int32
    np.testing.assert_array_equal(tout.rows.numpy(), np.asarray(jout.rows))
    np.testing.assert_allclose(tout.values.numpy(), np.asarray(jout.values),
                               rtol=1e-6)
    # merged and dense forms
    jm, tm = jout.merged(), tout.merged()
    np.testing.assert_array_equal(tm.rows.numpy(), np.asarray(jm.rows))
    np.testing.assert_allclose(tm.values.numpy(), np.asarray(jm.values),
                               rtol=1e-6, atol=1e-7)
    for a, b in ((tout, jout), (tm, jm)):
        np.testing.assert_allclose(a.to_dense().numpy(),
                                   np.asarray(b.to_dense()), rtol=1e-6,
                                   atol=1e-7)


_SPARSE_OPS = {
    "sgd": ({}, {}, ["ParamOut"]),
    "momentum": ({"Velocity": "f"}, {"mu": 0.9, "use_nesterov": True},
                 ["ParamOut", "VelocityOut"]),
    "adam": ({"Moment1": "f", "Moment2": "pos", "Beta1Pow": 0.9 ** 2,
              "Beta2Pow": 0.999 ** 2},
             {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
             ["ParamOut", "Moment1Out", "Moment2Out"]),
    "adagrad": ({"Moment": "pos"}, {"epsilon": 1e-6},
                ["ParamOut", "MomentOut"]),
}


@pytest.mark.parametrize("op_type", sorted(_SPARSE_OPS))
def test_sparse_update_matches_jax(op_type):
    state, attrs, outs = _SPARSE_OPS[op_type]
    rng = np.random.RandomState(len(op_type))
    ins = {"Param": rng.randn(VOCAB, DIM).astype(np.float32),
           "LearningRate": np.asarray([0.05], np.float32)}
    for slot, kind in state.items():
        ins[slot] = (rng.randn(VOCAB, DIM) if kind == "f" else
                     rng.rand(VOCAB, DIM) + 0.1 if kind == "pos" else
                     np.full((1,), kind)).astype(np.float32)
    # duplicates, and the padding id `height` of a merged grad
    rows = np.asarray([3, 9, 3, 29, 0, 9, VOCAB], np.int32)
    vals = rng.randn(len(rows), DIM).astype(np.float32)
    op = _op(op_type, attrs)
    jout = jreg.get_op_def(op_type).lower(jreg.ExecContext(op, dict(
        {s: [jnp.asarray(a)] for s, a in ins.items()},
        Grad=[JSR(jnp.asarray(rows), jnp.asarray(vals), VOCAB)])))
    tout = treg.get_op_def(op_type).lower(treg.ExecContext(op, dict(
        {s: [as_tensor(a)] for s, a in ins.items()},
        Grad=[TSR(as_tensor(rows), as_tensor(vals), VOCAB)])))
    for slot in outs:
        np.testing.assert_allclose(as_numpy(tout[slot]),
                                   np.asarray(jout[slot]), rtol=1e-6,
                                   atol=1e-7, err_msg=slot)
    # rows no id touched keep their values (lazy updates)
    untouched = sorted(set(range(VOCAB)) - set(rows.tolist()))
    if op_type != "momentum":
        np.testing.assert_array_equal(
            as_numpy(tout["ParamOut"])[untouched], ins["Param"][untouched])


def _bow(opt, sparse=True, tied=False):
    """Bag of words: a sparse table, mean-pooled, fc, softmax cross
    entropy; with `tied` the table also feeds a tied output head."""
    def fn(pkg, main):
        ids = pkg.layers.data("ids", shape=[T, 1], dtype="int64")
        label = pkg.layers.data("label", shape=[1], dtype="int64")
        emb = pkg.layers.embedding(
            ids, size=[VOCAB, DIM], is_sparse=sparse, padding_idx=2,
            param_attr=pkg.ParamAttr(name="table"))
        pooled = pkg.layers.scale(pkg.layers.reduce_sum(emb, dim=1),
                                  scale=1.0 / T)
        logits = pkg.layers.fc(pooled, size=4)
        if tied:
            table = main.global_block().var("table")
            logits = pkg.layers.elementwise_add(logits, pkg.layers.reduce_sum(
                pkg.layers.matmul(pooled, table, transpose_y=True), dim=1,
                keep_dim=True))
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, label))
        opt(pkg).minimize(loss)
        return loss
    return fn


def _feed(step):
    rng = np.random.RandomState(100 + step)
    return {"ids": _ids(step),
            "label": rng.randint(0, 4, size=(BATCH, 1)).astype(np.int64)}


_JAX_SPARSE = {
    "sgd": lambda pkg: pkg.optimizer.SGD(0.5),
    "momentum": lambda pkg: pkg.optimizer.Momentum(0.3, 0.9),
    "adam": lambda pkg: pkg.optimizer.Adam(0.05),
    "adam_lazy": lambda pkg: pkg.optimizer.Adam(0.05, lazy_mode=True),
    "adagrad": lambda pkg: pkg.optimizer.Adagrad(0.3),
}


@pytest.mark.parametrize("name", sorted(_JAX_SPARSE))
def test_sparse_training_matches_jax(name):
    built = build_both(_bow(_JAX_SPARSE[name]))
    for i in (0, 1):
        assert program_ops(built["torch"][i]) == program_ops(built["jax"][i])
    types_ = [op.type for op in built["torch"][0].global_block().ops]
    assert "lookup_table_sparse_grad" in types_
    assert "lookup_table_grad" not in types_
    pair = Pair(built)
    loss = built["torch"][2].name
    for step in range(3):
        (jl,), (tl,) = pair.step(_feed(step), [loss])
        assert_scaled_close(tl, jl, 1e-5, step)
    pair.assert_state_close(1e-5)


def test_a_tied_table_declines_to_the_dense_grad_in_both():
    built = build_both(_bow(_JAX_SPARSE["sgd"], tied=True))
    assert program_ops(built["torch"][0]) == program_ops(built["jax"][0])
    types_ = [op.type for op in built["torch"][0].global_block().ops]
    assert "lookup_table_sparse_grad" not in types_
    assert "lookup_table_grad" in types_


def test_the_sparse_grad_fetches_as_selected_rows():
    built = build_both(_bow(_JAX_SPARSE["sgd"]))
    pair = Pair(built)
    with tfluid.scope_guard(pair.tscope):
        g, = pair.texe.run(pair.tmain, feed=_feed(1),
                           fetch_list=["table@GRAD"])
    assert isinstance(g, TSR) and g.height == VOCAB
    assert isinstance(g.rows, np.ndarray) and g.rows.shape == (BATCH * T,)
    assert g.values.shape == (BATCH * T, DIM)
    np.testing.assert_array_equal(g.rows, _ids(1).reshape(-1))


# the optimizers whose JAX lowering has no sparse path (the port
# densifies), and SGD, whose sparse step must give the dense one's
_AGAINST_DENSE = {
    "sgd": lambda pkg: pkg.optimizer.SGD(0.5),
    "rmsprop": lambda pkg: pkg.optimizer.RMSProp(0.05, momentum=0.5),
    "adamax": lambda pkg: pkg.optimizer.Adamax(0.05),
    "adadelta": lambda pkg: pkg.optimizer.Adadelta(1.0),
    "decayed_adagrad": lambda pkg: pkg.optimizer.DecayedAdagrad(0.2),
    "ftrl": lambda pkg: pkg.optimizer.Ftrl(0.2, l1=0.01, l2=0.01),
    "lars_momentum": lambda pkg: pkg.optimizer.LarsMomentum(0.5, 0.9),
}


@pytest.mark.parametrize("name", sorted(_AGAINST_DENSE))
def test_sparse_program_gives_the_dense_programs_results(name):
    """The port's sparse program against its dense program (the same
    updates on the densified grad), and that dense program against the
    JAX package's."""
    sparse = build_both(_bow(_AGAINST_DENSE[name], sparse=True))
    dense = build_both(_bow(_AGAINST_DENSE[name], sparse=False))
    ps, pd = Pair(sparse), Pair(dense)
    assert set(ps.init) == set(pd.init)
    pd.tscope = tfluid.scope_from_jax(ps.init, tfluid.Scope(),
                                      tfluid.CPUPlace())
    pd.jscope = jfluid.Scope()
    for n, a in ps.init.items():
        pd.jscope.set(n, jnp.asarray(a))
    loss = sparse["torch"][2].name
    for step in range(3):
        with tfluid.scope_guard(ps.tscope):
            sl, = ps.texe.run(ps.tmain, feed=_feed(step), fetch_list=[loss])
        (jl,), (dl,) = pd.step(_feed(step), [loss])
        assert_scaled_close(sl, dl, 1e-6, step)
        assert_scaled_close(dl, jl, 1e-5, step)
    for n in ps.init:
        assert_scaled_close(as_numpy(ps.tscope.get(n)),
                            as_numpy(pd.tscope.get(n)), 1e-6, n)
    pd.assert_state_close(1e-5)


@pytest.fixture
def whole_graph():
    saved = (JFLAGS.whole_graph_ad, TFLAGS.whole_graph_ad)
    JFLAGS.whole_graph_ad = TFLAGS.whole_graph_ad = True
    yield
    JFLAGS.whole_graph_ad, TFLAGS.whole_graph_ad = saved


def test_whole_graph_ad_falls_back_to_the_per_op_step(whole_graph):
    """The sparse grad op is a grad op of its own: both packages' whole-
    graph builders decline the program, and the per-op step runs it."""
    built = build_both(_bow(_JAX_SPARSE["adam"]))
    main = built["torch"][0]
    assert tfunc._partition_whole_graph(main.global_block()) is None
    pair = Pair(built)
    loss = built["torch"][2].name
    for step in range(2):
        (jl,), (tl,) = pair.step(_feed(step), [loss])
        assert_scaled_close(tl, jl, 1e-5, step)
    pair.assert_state_close(1e-5)


def test_data_parallel_step_gathers_sparse_grad_rows():
    """_reduce_state_grads: a dense grad is averaged over the ranks, a
    SelectedRows grad gathered (rows and values of every rank, values
    over the world size), so its merge sums what the average would."""
    class Group:
        world_size, active = 2, True

        def all_reduce_(self, t, kind):
            t.mul_(2)  # both ranks hold the same grad here

        def all_gather_rows(self, t):
            return torch.cat([t, t + (1 if t.dtype == torch.int32 else 0)])

        time_grads = False

    dense = torch.randn(4, 3)
    sr = TSR(torch.tensor([0, 2], dtype=torch.int32), torch.randn(2, 3), 5)
    env = {"w@GRAD": dense.clone(), "table@GRAD": sr}
    tfunc._reduce_state_grads(env, ["w", "table"], Group())
    torch.testing.assert_close(env["w@GRAD"], dense)
    got = env["table@GRAD"]
    assert isinstance(got, TSR) and got.height == 5
    assert got.rows.tolist() == [0, 2, 1, 3]
    torch.testing.assert_close(got.values, torch.cat([sr.values] * 2) / 2)
