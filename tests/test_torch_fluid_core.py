"""The port's Fluid core against paddle_tpu's: the same layer calls build the
same Program (op types, var names, shapes, dtypes, attrs), append_backward
emits the same grad ops, Adam the same accumulators; shape inference on
meta tensors handles a -1 batch dim; the eager Executor, its Scope and the
scope carried across packages."""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.ops import registry as treg

INT64 = tfluid.core.VarDesc.VarType.INT64
INT32 = tfluid.core.VarDesc.VarType.INT32


def _net(fluid, adam=True):
    """A small program touching every ported layer."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.layers.data("ids", shape=[6], dtype="int64")
        label = fluid.layers.data("label", shape=[6], dtype="int64")
        emb = fluid.layers.embedding(ids, size=[20, 8])
        pos = fluid.layers.cumsum(fluid.layers.fill_constant(
            [1, 6], "int64", 1), axis=1, exclusive=True)
        x = fluid.layers.elementwise_add(
            emb, fluid.layers.embedding(pos, size=[6, 8]))
        x = fluid.layers.dropout(x, dropout_prob=0.1)
        h = fluid.layers.layer_norm(x, begin_norm_axis=2)
        qkv = fluid.layers.fc(h, size=24, num_flatten_dims=2)
        q, k, v = (fluid.layers.slice(qkv, axes=[2], starts=[8 * i],
                                      ends=[8 * i + 8]) for i in range(3))
        att = fluid.layers.flash_attention(q, k, v, num_heads=2,
                                           causal=True)
        h = fluid.layers.fc(att, size=16, num_flatten_dims=2, act="gelu")
        h = fluid.layers.remat_checkpoint(
            fluid.layers.elementwise_add(x, fluid.layers.fc(
                h, size=8, num_flatten_dims=2)))
        logits = fluid.layers.fc(h, size=20, num_flatten_dims=2,
                                 bias_attr=False)
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            fluid.layers.reshape(logits, [-1, 20]),
            fluid.layers.reshape(label, [-1, 1])))
        if adam:
            fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, loss


def _dtype(d):
    # the JAX package runs with x64 off: its shape inference records the
    # int64 results of fill_constant/cumsum/reshape as int32
    return INT32 if d == INT64 else d


def _vars(program, canon):
    return [(n, v.shape, _dtype(v.dtype) if canon else v.dtype,
             v.persistable, v.stop_gradient, type(v).__name__)
            for n, v in program.global_block().vars.items()]


def _ops(program):
    return [(op.type, op.inputs, op.outputs,
             {k: v for k, v in op.attrs.items() if k != "fwd_attrs"})
            for op in program.global_block().ops]


@pytest.fixture(scope="module")
def programs():
    return _net(jfluid), _net(tfluid)


def test_forward_program_equals_jax():
    (jm, js, _), (tm, ts, _) = _net(jfluid, adam=False), \
        _net(tfluid, adam=False)
    assert _ops(tm) == _ops(jm)
    assert _vars(tm, canon=True) == _vars(jm, canon=True)
    assert _ops(ts) == _ops(js)
    assert _vars(ts, canon=False) == _vars(js, canon=False)


def test_append_backward_emits_the_same_grad_ops(programs):
    (jm, _, _), (tm, _, _) = programs
    jgrad = [o for o in _ops(jm) if o[0].endswith("_grad") or o[0] == "sum"]
    tgrad = [o for o in _ops(tm) if o[0].endswith("_grad") or o[0] == "sum"]
    assert len(tgrad) > 10 and tgrad == jgrad
    # each grad op names its forward op by uid, and the uids agree
    for jop, top in zip(jm.global_block().ops, tm.global_block().ops):
        assert top.uid == jop.uid
        assert top.attrs.get("fwd_uid") == jop.attrs.get("fwd_uid")
    # fan-in: the layer norm's input feeds the residual too -> a sum op
    assert any(o[0] == "sum" and len(o[1]["X"]) > 1 for o in tgrad)


def test_adam_creates_the_same_accumulators(programs):
    (jm, js, _), (tm, ts, _) = programs
    assert _ops(tm) == _ops(jm)
    assert _vars(tm, canon=True) == _vars(jm, canon=True)
    assert _ops(ts) == _ops(js)
    names = {n for n, v in ts.global_block().vars.items() if v.persistable}
    assert names == {n for n, v in js.global_block().vars.items()
                     if v.persistable}
    assert "learning_rate_0" in names
    for suffix in ("moment1_0", "moment2_0", "beta1_pow_acc_0",
                   "beta2_pow_acc_0"):
        assert "embedding_0.w_0_" + suffix in names
    assert [o[0] for o in _ops(tm)].count("adam") == len(tm.all_parameters())


def test_meta_shape_inference_keeps_the_batch_dim():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[5, 7])
        h = tfluid.layers.fc(x, size=3, num_flatten_dims=2, act="gelu")
        flat = tfluid.layers.reshape(h, [-1, 3])
        loss = tfluid.layers.mean(flat)
    assert x.shape == (-1, 5, 7)
    assert h.shape == (-1, 5, 3) and flat.shape[1] == 3
    assert loss.shape == ()
    mul = next(op for op in main.global_block().ops if op.type == "mul")
    assert main.global_block().var(mul.output("Out")[0]).shape \
        == (-1, 5, 3)
    # the dummy batch extent is one no input dim uses
    assert treg._pick_dummy(mul, main.global_block()) == 97


def test_executor_trains_on_cpu_and_counts_no_kernel():
    from paddle_tpu_torch.ops import pallas_kernels as pk
    main, startup, loss = _net(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    rng = np.random.RandomState(0)
    feed = {"ids": rng.randint(0, 20, (4, 6)),
            "label": rng.randint(0, 20, (4, 6))}
    pk.reset_launch_counts()
    with tfluid.scope_guard(scope):
        exe.run(startup)
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
                  for _ in range(8)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(n == 0 for n in pk.launch_counts.values())
    w = scope.get("fc_0.w_0")
    assert isinstance(w, torch.Tensor) and w.device.type == "cpu"


def test_startup_is_seeded_by_program_and_op():
    def params(seed):
        main, startup, _ = _net(tfluid)
        startup.random_seed = seed
        scope = tfluid.Scope()
        with tfluid.scope_guard(scope):
            tfluid.Executor(tfluid.CPUPlace()).run(startup)
        return tfluid.scope_to_jax(scope)

    a, b, c = params(1), params(1), params(2)
    assert sorted(a) == sorted(c)
    assert all(np.array_equal(a[n], b[n]) for n in a)
    assert not np.array_equal(a["fc_0.w_0"], c["fc_0.w_0"])
    # Xavier bounds of the [8, 24] qkv weight
    limit = np.sqrt(6.0 / (8 + 24))
    assert np.abs(a["fc_0.w_0"]).max() <= limit
    assert np.array_equal(a["layer_norm_0.w_0"], np.ones(8, np.float32))


def test_scope_carried_from_jax_round_trips():
    _, js, _ = _net(jfluid)
    jscope = jfluid.executor.Scope()
    with jfluid.scope_guard(jscope):
        jfluid.Executor(jfluid.CPUPlace()).run(js)
    state = {n: np.asarray(jscope.get(n)) for n in jscope.keys()}
    scope = tfluid.scope_from_jax(state, tfluid.Scope(), tfluid.CPUPlace())
    back = tfluid.scope_to_jax(scope)
    assert sorted(back) == sorted(state)
    for n in state:
        assert back[n].dtype == state[n].dtype
        assert np.array_equal(back[n], state[n])


def test_executor_defaults_to_the_card_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfluid.Executor()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfluid.Executor(tfluid.CUDAPlace(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfluid.scope_from_jax({"w": np.zeros(2, np.float32)},
                              tfluid.Scope())
    assert tfluid.Executor(tfluid.CPUPlace()).device.type == "cpu"
    assert tfluid.CUDAPlace(1).torch_device() == torch.device("cuda", 1)
    assert paddle_tpu_torch.resolve_device("cpu").type == "cpu"


def test_unported_features_raise():
    """The nested (lod_level 2) feed path still raises.  Sparse embedding
    grads and gradient clipping are ported: they are held against the
    JAX package in test_torch_sparse_embedding.py and test_torch_clip.py."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        with pytest.raises(NotImplementedError):
            tfluid.layers.data("seq", shape=[1], lod_level=2)


def test_fetch_of_an_unwritten_var_raises():
    main, startup, loss = _net(tfluid, adam=False)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        with pytest.raises(KeyError, match="no op"):
            exe.run(main, feed={"ids": np.zeros((1, 6), np.int64),
                                "label": np.zeros((1, 6), np.int64)},
                    fetch_list=["nope"])
