"""Control flow (sub-blocks): paddle_tpu_torch against paddle_tpu on the
CPU, the cases of tests/test_control_flow.py, each held against the JAX
package's result on the same inputs (numpy seeds) and, for training,
from one JAX startup scope carried across.

  * Forward programs — the while sum, conditional_block on both
    branches, the StaticRNN accumulator, the DynamicRNN ragged sum,
    IfElse row-wise, the LoD rank table and reorder, the step counter
    beside an LR schedule: the fetches agree at rtol 1e-5 / atol 1e-6
    (integers and ids exactly).
  * Gradients through a `while`: the bounded fc loop, the unbounded loop
    with fan-in and a trainable producer, and the carry with and without
    a pre-loop consumer (bounded and unbounded): every parameter grad
    agrees with the JAX package's at rtol 1e-5 of its largest magnitude
    and with central finite differences of the port's own loss.
  * Training through while, StaticRNN and DynamicRNN: the losses agree
    step by step at rtol 1e-5 of the first loss, and fall.
  * append_backward over a `while` and a `recurrent` gives the JAX
    package's op type sequence; a program with sub-blocks survives
    clone and the JSON round trip into the other package.
"""

import warnings

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid.executor import as_numpy, as_tensor

PKGS = {"jax": jfluid, "torch": tfluid}


def _np(x):
    if isinstance(x, torch.Tensor):
        return as_numpy(x)
    return np.asarray(x)


def _lod(fluid, rows, lens):
    return fluid.create_lod_tensor(rows, [lens], None)


# ---------------------------------------------------------------------------
# the programs: fluid -> (main, startup, fetch vars, feed fn(fluid, step))
# ---------------------------------------------------------------------------

def _while_sum(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        L = fluid.layers
        i = L.fill_constant([1], "float32", 0)
        n = L.fill_constant([1], "float32", 10)
        s = L.fill_constant([1], "float32", 0)
        cond = L.less_than(i, n)
        w = L.While(cond)
        with w.block():
            L.assign(L.elementwise_add(s, i), s)
            L.increment(i, 1.0, in_place=True)
            L.less_than(i, n, cond=cond)
    return main, startup, [s, i], lambda f, k: {}


def _conditional_block(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        L = fluid.layers
        x = L.data("x", shape=[1], dtype="float32", append_batch_size=False)
        out = L.fill_constant([1], "float32", 0)
        cond = L.less_than(x, L.fill_constant([1], "float32", 5.0))
        cb = L.ConditionalBlock([cond])
        with cb.block():
            L.assign(L.scale(x, scale=2.0), out)
    return main, startup, [out], lambda f, k: {
        "x": np.array([3.0 if k == 0 else 7.0], np.float32)}


def _static_rnn_accumulator(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        L = fluid.layers
        x = L.data("x", shape=[3, 2, 4], dtype="float32",
                   append_batch_size=False)
        rnn = L.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            mem = rnn.memory(shape=[2, 4], batch_ref=x)
            acc = L.elementwise_add(mem, xt)
            rnn.update_memory(mem, acc)
            rnn.step_output(acc)
        out = rnn()
    return main, startup, [out], lambda f, k: {
        "x": np.random.RandomState(k).randn(3, 2, 4).astype(np.float32)}


def _dynamic_rnn_ragged_sum(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        L = fluid.layers
        x = L.data("x", shape=[3], dtype="float32", lod_level=1)
        init = L.data("init", shape=[3], dtype="float32")
        rnn = L.DynamicRNN()
        with rnn.block():
            xt = rnn.step_input(x)
            mem = rnn.memory(init=init)
            acc = L.elementwise_add(mem, xt)
            rnn.update_memory(mem, acc)
            rnn.output(acc)
        pooled = L.sequence_pool(rnn(), "last")

    def feed(f, k):
        rng = np.random.RandomState(k)
        return {"x": _lod(f, rng.randn(5, 3).astype(np.float32), [2, 3]),
                "init": rng.randn(2, 3).astype(np.float32)}
    return main, startup, [pooled], feed


def _ifelse_rowwise(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        L = fluid.layers
        x = L.data("x", shape=[2], dtype="float32")
        feat = L.slice(x, axes=[1], starts=[0], ends=[1])
        cond = L.cast(L.less_than(feat, L.fill_constant([1], "float32",
                                                        0.0)), "int32")
        ie = L.IfElse(cond)
        with ie.true_block():
            ie.output(L.scale(ie.input(x), scale=-1.0))
        with ie.false_block():
            ie.output(L.scale(ie.input(x), scale=10.0))
        out = ie()[0]
    return main, startup, [out], lambda f, k: {
        "x": np.random.RandomState(k).randn(5, 2).astype(np.float32)}


def _lod_rank_table(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        L = fluid.layers
        x = L.data("x", shape=[2], dtype="float32", lod_level=1)
        table = L.lod_rank_table(x)
        reordered = L.reorder_lod_tensor_by_rank(x, table)
        pooled = L.sequence_pool(reordered, "last")
    return main, startup, [table, pooled], lambda f, k: {
        "x": _lod(f, np.arange(10, dtype=np.float32).reshape(5, 2),
                  [1, 3, 1])}


def _step_counter(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        L = fluid.layers
        x = L.data("x", shape=[2])
        lr = L.piecewise_decay([2], [0.1, 0.01])
        ctr = L.autoincreased_step_counter()
        L.mean(x)
    return main, startup, [ctr, lr], lambda f, k: {
        "x": np.zeros((1, 2), np.float32)}


_FORWARD = {"while_sum": _while_sum, "conditional_block": _conditional_block,
            "static_rnn_accumulator": _static_rnn_accumulator,
            "dynamic_rnn_ragged_sum": _dynamic_rnn_ragged_sum,
            "ifelse_rowwise": _ifelse_rowwise,
            "lod_rank_table": _lod_rank_table,
            "step_counter_with_lr_schedule": _step_counter}


def _start(fluid, startup):
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
    return exe, scope


def _carry(jscope):
    """The JAX startup scope as (numpy dict, the port's Scope)."""
    init = {n: np.asarray(jscope.get(n)) for n in jscope.keys()}
    return init, tfluid.scope_from_jax(init, tfluid.Scope(),
                                       tfluid.CPUPlace())


@pytest.mark.parametrize("case", sorted(_FORWARD))
def test_forward_matches_jax(case):
    built = {}
    for name, fluid in PKGS.items():
        with fluid.unique_name.guard():
            built[name] = _FORWARD[case](fluid)
    jexe, jscope = _start(jfluid, built["jax"][1])
    _, tscope = _carry(jscope)
    texe = tfluid.Executor(tfluid.CPUPlace())
    for k in range(3):
        jm, _, jfetch, feed = built["jax"]
        tm, _, tfetch, _ = built["torch"]
        jout = jexe.run(jm, feed=feed(jfluid, k), fetch_list=jfetch,
                        scope=jscope)
        tout = texe.run(tm, feed=feed(tfluid, k), fetch_list=tfetch,
                        scope=tscope)
        for j, t in zip(jout, tout):
            j, t = np.asarray(j), _np(t)
            assert t.shape == j.shape, (case, t.shape, j.shape)
            if t.dtype.kind in "iub":
                np.testing.assert_array_equal(t, j)
            else:
                np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)
    if case == "while_sum":
        assert float(_np(tout[0]).ravel()[0]) == 45.0
    if case == "step_counter_with_lr_schedule":
        assert float(_np(tout[0]).ravel()[0]) == 3.0


# ---------------------------------------------------------------------------
# gradients through a while
# ---------------------------------------------------------------------------

def _normal(fluid, name):
    return fluid.layers.create_parameter(
        [3, 3], "float32", name=name,
        default_initializer=fluid.initializer.Normal(scale=0.3))


def _loop_on(fluid, state, n, body, max_iters=None):
    L = fluid.layers
    i = L.fill_constant([1], "float32", 0.0)
    cond = L.less_than(i, n)
    loop = L.While(cond, max_iters=max_iters)
    with loop.block():
        L.assign(body(state), state)
        L.increment(i)
        L.less_than(i, n, cond=cond)


def _grad_bounded_fc(fluid):
    """h = W (W (W x)) through a bounded while reading W each trip."""
    L = fluid.layers
    x = L.data("x", shape=[4], dtype="float32")
    h = L.assign(x)
    i = L.fill_constant([1], "int64", 0)
    n = L.fill_constant([1], "int64", 3)
    cond = L.less_than(i, n)
    w = L.While(cond, max_iters=3)
    with w.block():
        L.assign(L.fc(h, size=4, bias_attr=False,
                      param_attr=fluid.ParamAttr(
                          name="loop_w",
                          initializer=fluid.initializer.Constant(0.4))), h)
        L.increment(i, 1.0, in_place=True)
        L.less_than(i, n, cond=cond)
    return L.mean(h), ["loop_w"], {}


def _grad_fan_in(fluid):
    """An unbounded loop (its limit fed) reading fw, which is also read
    after the loop, over a state made by a trainable producer fw0."""
    L = fluid.layers
    x = L.data("x", shape=[3])
    n = L.data("n", shape=[1])
    w0, w = _normal(fluid, "fw0"), _normal(fluid, "fw")
    state = L.mul(x, w0)
    _loop_on(fluid, state, n, lambda s: L.tanh(L.mul(s, w)))
    loss = L.elementwise_add(L.mean(state), L.mean(L.mul(x, w)))
    return loss, ["fw0", "fw"], {"n": np.array([[2.0]], np.float32)}


def _grad_pre_loop(fluid, bounded):
    """The carry is also consumed before the loop."""
    L = fluid.layers
    x = L.data("x", shape=[3])
    w0 = _normal(fluid, "pw0")
    state = L.mul(x, w0)
    pre = L.mean(state)
    if bounded:
        n, feed = L.fill_constant([1], "float32", 2.0), {}
    else:
        n, feed = L.data("n", shape=[1]), {"n": np.array([[2.0]],
                                                         np.float32)}
    _loop_on(fluid, state, n, lambda s: L.tanh(L.scale(s, scale=0.9)),
             max_iters=2 if bounded else None)
    return L.elementwise_add(L.mean(state), pre), ["pw0"], feed


def _grad_no_pre_loop(fluid):
    L = fluid.layers
    x = L.data("x", shape=[3])
    state = L.mul(x, _normal(fluid, "nbw0"))
    n = L.fill_constant([1], "float32", 2.0)
    _loop_on(fluid, state, n, lambda s: L.tanh(L.scale(s, scale=0.9)),
             max_iters=2)
    return L.mean(state), ["nbw0"], {}


_GRADS = {"bounded_fc": _grad_bounded_fc, "fan_in_producer": _grad_fan_in,
          "pre_loop_consumer_unbounded":
              lambda f: _grad_pre_loop(f, bounded=False),
          "pre_loop_consumer_bounded":
              lambda f: _grad_pre_loop(f, bounded=True),
          "no_pre_loop_consumer": _grad_no_pre_loop}


@pytest.mark.parametrize("case", sorted(_GRADS))
def test_while_grads_match_jax_and_finite_differences(case):
    built = {}
    for name, fluid in PKGS.items():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), \
                fluid.program_guard(main, startup):
            loss, params, feed = _GRADS[case](fluid)
            pg = fluid.backward.append_backward(loss)
        gmap = {p.name: g.name for p, g in pg}
        assert sorted(gmap) == sorted(params), (name, sorted(gmap))
        built[name] = (main, startup, loss, gmap)
    jtypes = [op.type for op in built["jax"][0].global_block().ops]
    ttypes = [op.type for op in built["torch"][0].global_block().ops]
    assert ttypes == jtypes
    assert "while_grad" in ttypes
    dim = 4 if case == "bounded_fc" else 3
    feed["x"] = np.random.RandomState(len(case)).randn(3, dim) \
        .astype(np.float32)
    jm, js, jloss, jg = built["jax"]
    tm, _, tloss, tg = built["torch"]
    jexe, jscope = _start(jfluid, js)
    init, tscope = _carry(jscope)
    texe = tfluid.Executor(tfluid.CPUPlace())
    jout = jexe.run(jm, feed=feed, fetch_list=[jloss] + [jg[p] for p in
                                                          params],
                    scope=jscope)
    tout = texe.run(tm, feed=feed, fetch_list=[tloss] + [tg[p] for p in
                                                          params],
                    scope=tscope)
    for j, t in zip(jout, tout):
        j = np.asarray(j)
        np.testing.assert_allclose(_np(t), j, rtol=1e-5,
                                   atol=1e-5 * np.abs(j).max())

    def loss_at(name, value):
        tscope.set(name, as_tensor(value))
        (lv,) = texe.run(tm, feed=feed, fetch_list=[tloss], scope=tscope)
        return float(_np(lv).ravel()[0])

    eps = 1e-3
    for p, g in zip(params, tout[1:]):
        base = init[p].copy()
        for idx in [(0, 0), (1, 2)]:
            d = base.copy()
            d[idx] += eps
            lp = loss_at(p, d)
            d[idx] -= 2 * eps
            lm = loss_at(p, d)
            np.testing.assert_allclose(_np(g)[idx], (lp - lm) / (2 * eps),
                                       atol=5e-3, err_msg="%s%s" % (p, idx))
        loss_at(p, base)


def test_gradients_through_a_while_match_jax():
    """fluid.backward.gradients (calc_gradient) of the bounded fc loop's
    loss with respect to its weight: the JAX package's op types and
    value."""
    got = {}
    feed = {"x": np.random.RandomState(3).randn(3, 4).astype(np.float32)}
    for name, fluid in PKGS.items():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), \
                fluid.program_guard(main, startup):
            loss = _grad_bounded_fc(fluid)[0]
            (wgrad,) = fluid.backward.gradients(
                loss, [main.global_block().var("loop_w")])
        exe, scope = _start(fluid, startup)
        (g,) = exe.run(main, feed=feed, fetch_list=[wgrad], scope=scope)
        got[name] = ([op.type for op in main.global_block().ops], _np(g))
    assert got["torch"][0] == got["jax"][0]
    np.testing.assert_allclose(got["torch"][1], got["jax"][1], rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# training through control flow
# ---------------------------------------------------------------------------

def _train_while(fluid, derived):
    L = fluid.layers
    x = L.data("x", shape=[4], dtype="float32")
    h = L.assign(x)
    i = L.fill_constant([1], "int64", 0)
    n = L.fill_constant([1], "int64", 3)
    cond = L.less_than(i, n)
    w = L.While(cond, max_iters=None if derived else 3)
    with w.block():
        L.assign(L.fc(h, size=4, bias_attr=False,
                      param_attr=fluid.ParamAttr(name="w2")), h)
        L.increment(i, 1.0, in_place=True)
        L.less_than(i, n, cond=cond)
    loss = L.mean(L.square(h))
    fluid.optimizer.SGD(0.05).minimize(loss)
    xb = np.random.RandomState(2).randn(3, 4).astype(np.float32)
    return loss, lambda f, k: {"x": xb}


def _train_dynamic_while(fluid):
    L = fluid.layers
    x = L.data("x", shape=[4])
    n_steps = L.data("n", shape=[1])
    w = L.create_parameter([4, 4], "float32", name="dw_w")
    i = L.fill_constant([1], "float32", 0.0)
    state = L.elementwise_add(x, L.fill_constant([1], "float32", 0.0))
    cond = L.less_than(i, n_steps)
    loop = L.While(cond)
    with loop.block():
        L.assign(L.tanh(L.mul(state, w)), state)
        L.increment(i)
        L.less_than(i, n_steps, cond=cond)
    loss = L.mean(L.square_error_cost(state, L.data("t", shape=[4])))
    fluid.optimizer.SGD(0.2).minimize(loss)

    def feed(f, k):
        rng = np.random.RandomState(k)
        trips = 1 + k % 3   # the trip count is data
        xv = rng.randn(2, 4).astype(np.float32)
        tv = xv
        for _ in range(trips):
            tv = np.tanh(tv @ np.full((4, 4), 0.1, np.float32))
        return {"x": xv, "n": np.array([[float(trips)]], np.float32),
                "t": tv}
    return loss, feed


def _train_static_rnn(fluid):
    L = fluid.layers
    T, B, D, H = 4, 8, 5, 6
    x = L.data("x", shape=[T, B, D], dtype="float32",
               append_batch_size=False)
    label = L.data("label", shape=[B, 1], dtype="int64",
                   append_batch_size=False)
    rnn = L.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(x)
        mem = rnn.memory(shape=[B, H], batch_ref=x)
        h = L.fc(input=[xt, mem], size=H, act="tanh")
        rnn.update_memory(mem, h)
        rnn.step_output(h)
    last = L.squeeze(L.slice(rnn(), axes=[0], starts=[T - 1], ends=[T]),
                     axes=[0])
    pred = L.fc(input=last, size=3, act="softmax")
    loss = L.mean(L.cross_entropy(input=pred, label=label))
    fluid.optimizer.Adam(learning_rate=0.05).minimize(loss)
    rng = np.random.RandomState(0)
    lab = rng.randint(0, 3, (B, 1)).astype("int64")
    xv = rng.randn(T, B, D).astype("float32") + lab.reshape(1, B, 1)
    return loss, lambda f, k: {"x": xv, "label": lab}


def _train_dynamic_rnn(fluid):
    L = fluid.layers
    x = L.data("x", shape=[4], dtype="float32", lod_level=1)
    init = L.data("init", shape=[6], dtype="float32")
    label = L.data("label", shape=[1], dtype="int64")
    rnn = L.DynamicRNN()
    with rnn.block():
        xt = rnn.step_input(x)
        mem = rnn.memory(init=init)
        h = L.fc(input=[xt, mem], size=6, act="tanh")
        rnn.update_memory(mem, h)
        rnn.output(h)
    pred = L.fc(input=L.sequence_pool(rnn(), "last"), size=2,
                act="softmax")
    loss = L.mean(L.cross_entropy(input=pred, label=label))
    fluid.optimizer.Adam(learning_rate=0.05).minimize(loss)

    def feed(f, k):
        rng = np.random.RandomState(k)
        seqs, labels = [], []
        for _ in range(8):
            lab = int(rng.randint(0, 2))
            seqs.append((rng.randn(int(rng.randint(2, 6)), 4) + 2 * lab)
                        .astype("float32"))
            labels.append(lab)
        return {"x": _lod(f, np.concatenate(seqs, 0),
                          [len(s) for s in seqs]),
                "init": np.zeros((8, 6), np.float32),
                "label": np.array(labels, "int64").reshape(-1, 1)}
    return loss, feed


_TRAIN = {"while_bounded": (lambda f: _train_while(f, False), 12),
          "while_bound_derived": (lambda f: _train_while(f, True), 10),
          "while_dynamic_bound": (_train_dynamic_while, 12),
          "static_rnn": (_train_static_rnn, 20),
          "dynamic_rnn_params": (_train_dynamic_rnn, 20)}


@pytest.mark.parametrize("case", sorted(_TRAIN))
def test_training_through_control_flow_matches_jax(case):
    build, steps = _TRAIN[case]
    built = {}
    for name, fluid in PKGS.items():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), \
                fluid.program_guard(main, startup):
            loss, feed = build(fluid)
        built[name] = (main, startup, loss)
    jm, js, jloss = built["jax"]
    tm, _, tloss = built["torch"]
    if case == "while_bound_derived":
        for m in (jm, tm):
            wop = next(op for op in m.global_block().ops
                       if op.type == "while")
            assert wop.attrs.get("max_iters") == 3
    assert [op.type for op in tm.global_block().ops] == \
        [op.type for op in jm.global_block().ops]
    jexe, jscope = _start(jfluid, js)
    _, tscope = _carry(jscope)
    texe = tfluid.Executor(tfluid.CPUPlace())
    losses = {"jax": [], "torch": []}
    for k in range(steps):
        (jl,) = jexe.run(jm, feed=feed(jfluid, k), fetch_list=[jloss],
                         scope=jscope)
        (tl,) = texe.run(tm, feed=feed(tfluid, k), fetch_list=[tloss],
                         scope=tscope)
        losses["jax"].append(float(np.asarray(jl).ravel()[0]))
        losses["torch"].append(float(_np(tl).ravel()[0]))
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=1e-5,
                               atol=1e-5 * abs(losses["jax"][0]))
    t = losses["torch"]
    assert np.mean(t[-3:]) < np.mean(t[:3]), t


def test_ifelse_cross_row_op_warns():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        L = tfluid.layers
        x = L.data("x", shape=[1])
        cond = L.less_than(x, L.fill_constant([1], "float32", 0.0))
        ie = L.IfElse(cond)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            with ie.true_block():
                xt = ie.input(x)
                L.mean(xt)
                ie.output(xt)
        assert any("cross-row" in str(m.message) for m in w)


# ---------------------------------------------------------------------------
# program structure
# ---------------------------------------------------------------------------

def _recurrent_net(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        loss, _ = _train_dynamic_rnn(fluid)
    return main, loss


def test_sub_block_programs_serialize_across_packages():
    """A `recurrent` program's backward is the JAX package's op for op;
    clone keeps its sub-block; its JSON loads in the JAX package and the
    JAX package's JSON loads in the port, the sub_block attr resolving to
    a block of the loading program."""
    jm, _ = _recurrent_net(jfluid)
    tm, _ = _recurrent_net(tfluid)
    assert [op.type for op in tm.global_block().ops] == \
        [op.type for op in jm.global_block().ops]
    assert "recurrent_grad" in [op.type for op in tm.global_block().ops]
    assert len(tm.blocks) == len(jm.blocks) == 2
    for prog in (tm.clone(), tfluid.Program.parse_from_string(
            jm.serialize_to_string())):
        rec = next(op for op in prog.global_block().ops
                   if op.type == "recurrent")
        assert rec.attrs["sub_block"] is prog.blocks[1]
        assert [op.type for op in prog.blocks[1].ops] == \
            [op.type for op in tm.blocks[1].ops]
    back = jfluid.Program.parse_from_string(tm.serialize_to_string())
    assert back.global_block().ops[-1].type == \
        jm.global_block().ops[-1].type
    grad = next(op for op in back.global_block().ops
                if op.type == "recurrent_grad")
    assert grad.attrs["fwd_attrs"]["sub_block"] is back.blocks[1]


def test_tensor_array_lowerings_match_jax():
    """The tensor-array ops on the arrays themselves (Python lists in
    the env, as in the JAX package): write_to_array grows and copies the
    env's array, read_from_array, array_length, array_to_lod_tensor,
    lod_tensor_to_array and max_sequence_len give the JAX lowerings'
    values."""
    import types

    import jax.numpy as jnp

    import paddle_tpu.ops  # noqa: F401
    from paddle_tpu.ops import registry as jreg
    from paddle_tpu_torch.ops import registry as treg

    rng = np.random.RandomState(4)
    xs = [rng.randn(3, 2).astype(np.float32) for _ in range(4)]

    def run(op_type, inputs, outputs=None, env=None):
        op = types.SimpleNamespace(
            type=op_type, attrs={}, uid=1, outputs=outputs or {},
            inputs={s: ["%s%d" % (s, i) for i in range(len(v))]
                    for s, v in inputs.items()})
        jenv = None if env is None else dict(env["jax"])
        tenv = None if env is None else dict(env["torch"])
        jin = {s: [[jnp.asarray(a) for a in x] if isinstance(x, list)
                   else jnp.asarray(x) for x in v]
               for s, v in inputs.items()}
        tin = {s: [[torch.from_numpy(a) for a in x] if isinstance(x, list)
                   else torch.from_numpy(np.asarray(x)) for x in v]
               for s, v in inputs.items()}
        jout = jreg.get_op_def(op_type).lower(jreg.ExecContext(
            op, jin, env=jenv))
        tout = treg.get_op_def(op_type).lower(treg.ExecContext(
            op, tin, device="cpu", env=tenv))
        return jout, tout, jenv, tenv

    def same(t, j):
        np.testing.assert_allclose(_np(t), np.asarray(j), rtol=1e-6)

    # write_to_array at the array's end (the JAX lowering appends an
    # index it gets as a device array; the port writes at the index,
    # growing the array with None past its end)
    env = {"jax": {"arr": [jnp.asarray(xs[0])]},
           "torch": {"arr": [torch.from_numpy(xs[0])]}}
    _, _, jenv, tenv = run("write_to_array", {"X": [xs[1]],
                                              "I": [np.array([1])]},
                           outputs={"Out": ["arr"]}, env=env)
    assert len(tenv["arr"]) == len(jenv["arr"]) == 2
    same(tenv["arr"][1], jenv["arr"][1])
    assert len(env["torch"]["arr"]) == 1   # the array is copied
    _, _, _, tenv = run("write_to_array", {"X": [xs[2]],
                                           "I": [np.array([3])]},
                        outputs={"Out": ["arr"]}, env=env)
    assert len(tenv["arr"]) == 4 and tenv["arr"][1:3] == [None, None]
    same(tenv["arr"][3], xs[2])
    jout, tout, _, _ = run("read_from_array", {"X": [xs],
                                               "I": [np.array([3])]})
    same(tout["Out"], jout["Out"])
    jout, tout, _, _ = run("array_length", {"X": [xs]})
    assert int(_np(tout["Out"])[0]) == int(np.asarray(jout["Out"])[0]) == 4
    jout, tout, _, _ = run("array_to_lod_tensor", {"X": [xs]})
    same(tout["Out"], jout["Out"])
    assert tuple(tout["Out"].shape) == (3, 4, 2)
    (tarr,) = run("lod_tensor_to_array",
                  {"X": [np.stack(xs, axis=1)]})[1]["Out"]
    assert len(tarr) == 4
    for a, x in zip(tarr, xs):
        same(a, x)
    jout, tout, _, _ = run("max_sequence_len", {
        "RankTable": [np.zeros(3, np.int32)],
        "RankTable@LOD_LEN": [np.array([2, 7, 4], np.int32)]})
    assert int(_np(tout["Out"])[0]) == int(np.asarray(jout["Out"])[0]) == 7


def test_inference_artifact_with_a_sub_block_loads_in_both_packages(
        tmp_path):
    """save_inference_model keeps a `recurrent` op and its sub-block (the
    pruning follows what the block reads); the artifact loads in the
    port and in the JAX package, and both give the program's outputs."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        L = tfluid.layers
        x = L.data("x", shape=[4], dtype="float32", lod_level=1)
        init = L.data("init", shape=[6], dtype="float32")
        rnn = L.DynamicRNN()
        with rnn.block():
            xt = rnn.step_input(x)
            mem = rnn.memory(init=init)
            h = L.fc(input=[xt, mem], size=6, act="tanh")
            rnn.update_memory(mem, h)
            rnn.output(h)
        pred = L.fc(L.sequence_pool(rnn(), "last"), size=2, act="softmax")
    texe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    rng = np.random.RandomState(6)
    lens = [3, 1, 4]
    feed_np = {"rows": rng.randn(sum(lens), 4).astype(np.float32),
               "init": rng.randn(3, 6).astype(np.float32)}
    with tfluid.scope_guard(scope):
        texe.run(startup)
        tfluid.save_inference_model(str(tmp_path), ["x", "init"], [pred],
                                    texe, main)
        (want,) = texe.run(main, feed={
            "x": _lod(tfluid, feed_np["rows"], lens),
            "init": feed_np["init"]}, fetch_list=[pred])
    outs = {}
    for name, fluid in PKGS.items():
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(fluid.Scope()):
            prog, feeds, fetch = fluid.io.load_inference_model(
                str(tmp_path), exe)
            assert len(prog.blocks) == 2
            assert "recurrent" in [op.type for op in
                                   prog.global_block().ops]
            (outs[name],) = exe.run(prog, feed={
                "x": _lod(fluid, feed_np["rows"], lens),
                "init": feed_np["init"]}, fetch_list=fetch)
    np.testing.assert_allclose(_np(outs["torch"]), _np(want), rtol=1e-6)
    np.testing.assert_allclose(_np(outs["jax"]), _np(want), rtol=1e-5,
                               atol=1e-6)
