"""The benchmark/fluid model zoo's training path: paddle_tpu_torch against
paddle_tpu on the CPU.

  * `vgg.get_model()`, `se_resnext.get_model()` (NHWC and NCHW) and
    `stacked_dynamic_lstm.get_model()` build the JAX package's programs
    op for op: the same op types and counts, var names, attrs and
    startup programs.
  * A small stacked_dynamic_lstm (2 layers, emb and hid 16, dict 50,
    batch 4, lengths 3, 7, 1, 5) trains three Adam steps free running
    from a JAX startup scope carried across, per op and whole graph:
    the losses, every parameter and every Adam moment agree to rtol 1e-5
    of each array's largest magnitude.
  * VGG-16 (32 x 32, batch 4) and SE-ResNeXt-50 (32 x 32, batch 8, 10
    classes, NHWC) are batch-norm nets that are chaotic at a few images
    (one ulp of input moves a later loss by percents; see
    test_torch_resnet_train.py), so each of two steps is held op by op:
    every op of the port's program runs on the JAX package's values of
    its inputs, and every value it writes lies within a Frobenius error
    of 1e-4 of the JAX package's.  Dropout draws from other generators in
    the two packages, so its rate is set to 0 in both programs here.
    VGG's conv and fc biases feed batch norms, so their grads are sums
    that cancel to rounding noise (the JAX package's own value has a norm
    of 2e-8 to 1.2e-7 of its terms'): each is held against its float64 sum of
    the JAX package's cotangent instead, to 1e-4 of the norm of the sum
    of the terms' magnitudes (the error bound of a float32 sum).
  * `piecewise_decay` across its boundaries: the step counter and the
    learning rate equal the JAX package's step by step, per op, whole
    graph and under block_out remat.
  * SE-ResNeXt's whole-graph step, plain and under block_out remat,
    against its per-op step: the counter advances once a step on every
    path, and the first loss is the same.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.fluid import lod as jlod
from paddle_tpu.models import se_resnext as jse
from paddle_tpu.models import stacked_dynamic_lstm as jlstm
from paddle_tpu.models import vgg as jvgg
from paddle_tpu_torch.flags import FLAGS as TFLAGS
from paddle_tpu_torch.fluid import functionalizer as tfunc
from paddle_tpu_torch.fluid.executor import as_numpy, as_tensor
from paddle_tpu_torch.models import se_resnext as tse
from paddle_tpu_torch.models import stacked_dynamic_lstm as tlstm
from paddle_tpu_torch.models import vgg as tvgg
from paddle_tpu_torch.ops import registry as treg

COUNTER = "@LR_DECAY_COUNTER@"


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this file runs: the suite runs six
    workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _flags_off_after():
    yield
    TFLAGS.whole_graph_ad = False
    TFLAGS.remat_policy = ""


def _op_list(program):
    return [(op.type, op.inputs, op.outputs,
             {k: v for k, v in op.attrs.items() if k != "fwd_uid"})
            for op in program.global_block().ops]


def _var_list(program):
    return [(v.name, v.shape, v.lod_level, v.persistable)
            for v in program.global_block().vars.values()]


_PROGRAMS = {
    "vgg": (jvgg, tvgg, {}, {"conv2d": 13, "batch_norm": 14,
                             "dropout": 10, "adam": 60}),
    "se_resnext_nhwc": (jse, tse, {"layout": "NHWC", "batch_size": 64},
                        {"conv2d": 53, "batch_norm": 53, "sigmoid": 16,
                         "elementwise_mul": 16, "momentum": 225,
                         "increment": 1, "less_than": 3, "where": 3,
                         "remat_tag": 16}),
    "se_resnext_nchw": (jse, tse, {"layout": "NCHW"},
                        {"conv2d": 53, "momentum": 225}),
    "stacked_dynamic_lstm": (jlstm, tlstm, {},
                             {"lstm": 3, "sequence_pool": 3, "adam": 17,
                              "lookup_table": 1}),
}


@pytest.mark.parametrize("name", sorted(_PROGRAMS))
def test_zoo_program_matches_jax(name):
    """The main and startup programs op for op (types, var names, attrs),
    the vars' names, shapes and LoD levels, and the op counts."""
    jmod, tmod, kw, counts = _PROGRAMS[name]
    with jfluid.unique_name.guard():
        jm, js, jfeeds, jloss, jacc, _ = jmod.get_model(**kw)
    with tfluid.unique_name.guard():
        tm, ts, tfeeds, tloss, tacc, _ = tmod.get_model(**kw)
    assert (tloss.name, tacc.name) == (jloss.name, jacc.name)
    assert _op_list(tm) == _op_list(jm)
    assert _op_list(ts) == _op_list(js)
    assert _var_list(tm) == _var_list(jm)
    assert tfunc.persistable_names(tm) == \
        jfluid.functionalizer.persistable_names(jm)
    types = [op.type for op in tm.global_block().ops]
    assert {k: types.count(k) for k in counts} == counts
    expected_len = {"vgg": 339, "se_resnext_nhwc": 1436,
                    "se_resnext_nchw": 1436, "stacked_dynamic_lstm": 98}
    assert len(types) == expected_len[name]


# ---------------------------------------------------------------------------
# the small stacked LSTM, free running
# ---------------------------------------------------------------------------

_LSTM_KW = dict(dict_dim=50, emb_dim=16, hid_dim=16, stacked_num=2)
_LENGTHS = [3, 7, 1, 5]


def _lstm_feed(mod, step):
    rng = np.random.RandomState(step)
    words = mod.create_lod_tensor(
        rng.randint(0, 50, size=(sum(_LENGTHS), 1)).astype(np.int64),
        [_LENGTHS], None)
    return {"words": words,
            "label": rng.randint(0, 2, size=(len(_LENGTHS), 1))
            .astype(np.int64)}


def _close(got, want, rtol, what):
    got = np.asarray(got).astype(np.float64)
    want = np.asarray(want).astype(np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()),
                               err_msg=what)


def _jax_start(jstartup):
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup)
    return jexe, jscope


def _state(jscope):
    return {n: np.asarray(jscope.get(n)) for n in jscope.keys()}


@pytest.mark.parametrize("ad", ["per_op", "whole_graph"])
def test_small_stacked_lstm_trains_three_steps_like_jax(ad):
    with jfluid.unique_name.guard():
        jm, js, _, jloss, _, _ = jlstm.get_model(**_LSTM_KW)
    with tfluid.unique_name.guard():
        tm, _, _, tloss, _, _ = tlstm.get_model(**_LSTM_KW)
    jexe, jscope = _jax_start(js)
    init = _state(jscope)
    tscope = tfluid.scope_from_jax(init, tfluid.Scope(), tfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    TFLAGS.whole_graph_ad = ad == "whole_graph"
    hidden = "lstm_1.tmp_0"
    losses = {"jax": [], "torch": []}
    for step in range(3):
        jl, jh = jexe.run(jm, feed=_lstm_feed(jlod, step),
                          fetch_list=[jloss, hidden], scope=jscope)
        tl, th = texe.run(tm, feed=_lstm_feed(tfluid.lod, step),
                          fetch_list=[tloss, hidden], scope=tscope)
        losses["jax"].append(float(np.asarray(jl).ravel()[0]))
        losses["torch"].append(float(np.asarray(tl).ravel()[0]))
        assert isinstance(th, tfluid.LoDTensor)
        assert th.recursive_sequence_lengths() == [_LENGTHS]
        _close(np.asarray(th), np.asarray(jh), 1e-5, hidden)
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=1e-5)
    names = sorted(init)
    assert sum(n.endswith(("_moment1_0", "_moment2_0")) for n in names) \
        == 2 * 12
    for n in names:
        _close(as_numpy(tscope.get(n)), jscope.get(n), 1e-5, n)
        if n.endswith((".w_0", "_moment1_0")):
            assert not np.array_equal(init[n], as_numpy(tscope.get(n))), n


# ---------------------------------------------------------------------------
# VGG-16 and SE-ResNeXt-50, op by op on the JAX package's values
# ---------------------------------------------------------------------------

def _no_dropout(program):
    for op in program.global_block().ops:
        if op.type == "dropout":
            op.attrs["dropout_prob"] = 0.0
        if op.type == "dropout_grad":
            op.attrs["fwd_attrs"]["dropout_prob"] = 0.0
    program._bump_version()


def _vgg(pkg, mod):
    with pkg.unique_name.guard():
        main, startup, _, loss, _, _ = mod.get_model(batch_size=4)
    _no_dropout(main)
    return main, startup, loss


def _se(pkg, mod):
    with pkg.unique_name.guard():
        main, startup, _, loss, _, _ = mod.get_model(
            batch_size=8, class_dim=10, img_size=32, layout="NHWC")
    _no_dropout(main)
    return main, startup, loss


def _image_feed(shape, step, classes=10):
    rng = np.random.RandomState(step)
    return {"data": rng.randn(*shape).astype(np.float32),
            "label": rng.randint(0, classes, size=(shape[0], 1))
            .astype(np.int64)}


def _frobenius(got, want):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), 1e-30))


def _bias_sums(op, jvals):
    """The exact float64 sum of an elementwise_add's Y grad (its bias, of
    shape Y) from the JAX package's cotangent of Out, and the sum of the
    terms' magnitudes."""
    dy = np.asarray(jvals[op.inputs["GRAD:Out"][0]]).astype(np.float64)
    ndim_y = np.asarray(jvals[op.inputs["Y"][0]]).ndim
    axis = op.attrs["fwd_attrs"].get("axis", -1)
    axis = dy.ndim - ndim_y if axis == -1 else axis
    keep = range(axis, axis + ndim_y)
    red = tuple(i for i in range(dy.ndim) if i not in keep)
    return dy.sum(axis=red), np.abs(dy).sum(axis=red)


def _forced_step(tmain, state, feed, jvals, step):
    """Every op of the port's program on the JAX package's values of its
    inputs: (values compared, the worst (Frobenius error, name, op
    type)); integer and boolean values must be equal."""
    exe = tfluid.Executor(tfluid.CPUPlace())
    env = {n: as_tensor(v) for n, v in state.items()}
    env.update(exe._prepare_feeds(tmain, feed))
    ops = tmain.global_block().ops
    last = {}
    for i, op in enumerate(ops):
        for n in op.output_arg_names:
            if n:
                last[n] = i
    needed = {op.attrs["fwd_uid"] for op in ops
              if tfunc._is_generic_grad(op)}
    normalized = {n for op in ops if op.type == "batch_norm"
                  for n in op.inputs["X"]}
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
            for n in op.output_arg_names:
                if not n or last[n] != i:
                    continue
                want = np.asarray(jvals[n])
                got = as_numpy(env[n])
                if want.dtype.kind in "biu":
                    np.testing.assert_array_equal(got, want, err_msg=n)
                elif op.type == "elementwise_add_grad" and \
                        op.outputs["GRAD:Y"] == [n] and \
                        op.inputs["Out:Out"][0] in normalized:
                    exact, mag = _bias_sums(op, jvals)
                    err = float(np.linalg.norm(got - exact) /
                                max(np.linalg.norm(mag), 1e-30))
                    worst = max(worst, (err, n, op.type))
                else:
                    worst = max(worst, (_frobenius(got, want), n, op.type))
                env[n] = as_tensor(want)
                checked += 1
    return checked, worst


@pytest.mark.parametrize("model", ["vgg", "se_resnext"])
def test_zoo_cnn_steps_match_jax_op_by_op(model):
    build, mods, shape = {
        "vgg": (_vgg, (jvgg, tvgg), (4, 3, 32, 32)),
        "se_resnext": (_se, (jse, tse), (8, 32, 32, 3))}[model]
    jm, js, jloss = build(jfluid, mods[0])
    tm, _, _ = build(tfluid, mods[1])
    jexe, jscope = _jax_start(js)
    names = sorted(set(n for op in jm.global_block().ops
                       for n in op.output_arg_names if n))
    for step in range(2):
        state = _state(jscope)
        feed = _image_feed(shape, step)
        vals = jexe.run(jm, feed=feed, fetch_list=names, scope=jscope)
        jvals = dict(zip(names, vals))
        assert np.isfinite(np.asarray(jvals[jloss.name])).all()
        checked, (err, name, op_type) = _forced_step(tm, state, feed, jvals,
                                                     step)
        assert checked == len(names)
        assert err <= 1e-4, (step, name, op_type, err)
        if model == "se_resnext":
            assert float(jvals[COUNTER][0]) == step
        for n in state:
            if n.endswith(("_moment1_0", "_velocity_0", ".mean_0")):
                assert not np.array_equal(jvals[n], state[n]), n


# ---------------------------------------------------------------------------
# piecewise decay and the step counter
# ---------------------------------------------------------------------------

def _decayed(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[3])
        y = pkg.layers.fc(pkg.layers.fc(x, size=4, act="relu"), size=1)
        y = pkg.layers.remat_checkpoint(y)
        loss = pkg.layers.mean(pkg.layers.sigmoid(y))
        lr = pkg.layers.piecewise_decay(boundaries=[2, 4],
                                        values=[0.1, 0.01, 0.001])
        pkg.optimizer.Momentum(learning_rate=lr, momentum=0.9).minimize(
            loss)
    return main, startup, loss, lr


@pytest.mark.parametrize("ad", [None, "whole_graph", "block_out"])
def test_piecewise_decay_matches_jax_step_by_step(ad):
    """Boundaries 2 and 4: the counter reads 0, 1, ..., 5 and the LR 0.1,
    0.1, 0.01, 0.01, 0.001, 0.001 in both packages, and the losses agree;
    the counter's increment is the program's first op."""
    jm, js, jloss, jlr = _decayed(jfluid)
    tm, _, tloss, tlr = _decayed(tfluid)
    assert _op_list(tm) == _op_list(jm)
    assert tm.global_block().ops[0].type == "increment"
    jexe, jscope = _jax_start(js)
    init = _state(jscope)
    assert init[COUNTER] == -1.0
    tscope = tfluid.scope_from_jax(init, tfluid.Scope(), tfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    TFLAGS.whole_graph_ad = ad is not None
    TFLAGS.remat_policy = "block_out" if ad == "block_out" else ""
    feed = {"x": np.random.RandomState(0).randn(5, 3).astype(np.float32)}
    want_lr = [0.1, 0.1, 0.01, 0.01, 0.001, 0.001]
    for step in range(6):
        jr = jexe.run(jm, feed=feed, fetch_list=[jloss, jlr, COUNTER],
                      scope=jscope)
        tr = texe.run(tm, feed=feed, fetch_list=[tloss, tlr, COUNTER],
                      scope=tscope)
        assert float(tr[2][0]) == float(jr[2][0]) == step
        assert float(tr[1][0]) == float(jr[1][0]) == np.float32(
            want_lr[step])
        np.testing.assert_allclose(float(tr[0]), float(jr[0]), rtol=1e-5)
    assert float(tscope.get(COUNTER)[0]) == 5.0


@pytest.mark.parametrize("remat", [None, "block_out"])
def test_se_resnext_whole_graph_step_matches_per_op(remat):
    """Two steps of SE-ResNeXt-50 (32 x 32, batch 2, NHWC, dropout on):
    whole graph (and under block_out remat, which recomputes every
    block's interior, the counter's increment included) against per op
    from one startup state: the counter advances once a step, the first
    loss is equal and the second agrees to 1e-4."""
    with tfluid.unique_name.guard():
        main, startup, _, loss, _, _ = tse.get_model(
            batch_size=2, class_dim=10, img_size=32, layout="NHWC")
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope0 = tfluid.Scope()
    with tfluid.scope_guard(scope0):
        exe.run(startup)
    init = {n: as_numpy(scope0.get(n)) for n in scope0.keys()}
    feed = _image_feed((2, 32, 32, 3), 0)
    runs = []
    for wga in (False, True):
        TFLAGS.whole_graph_ad = wga
        TFLAGS.remat_policy = remat if wga and remat else ""
        scope = tfluid.scope_from_jax(init, tfluid.Scope(), tfluid.CPUPlace())
        e = tfluid.Executor(tfluid.CPUPlace())
        runs.append([float(np.asarray(e.run(main, feed=feed,
                                            fetch_list=[loss],
                                            scope=scope)[0]).ravel()[0])
                     for _ in range(2)])
        assert float(scope.get(COUNTER)[0]) == 1.0
    assert runs[1][0] == runs[0][0]
    np.testing.assert_allclose(runs[1][1], runs[0][1], rtol=1e-4)
