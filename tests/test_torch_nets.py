"""fluid.nets' sequence helpers on paddle_tpu_torch against paddle_tpu on
the CPU: the sequence_conv lowering (forward and vjp, ragged and dense);
the book's text conv net (06.understand_sentiment convolution_net:
embedding, two sequence_conv_pool, fc softmax, cross entropy, Adagrad)
at small widths for three steps from the JAX startup scope;
scaled_dot_product_attention and glu forward and backward.  Then the
fluid root surface (initializers, name_scope, flags).  The card twins
hold the card against the CPU."""

import numpy as np
import pytest
import torch

import torch_op_cases as cases
from test_torch_ops import RTOL, ATOL, _assert_parity
from torch_train_parity import assert_scaled_close, build_both, program_ops

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid.executor import as_numpy

_IDS = [c[0] for c in cases.SEQUENCE_CASES]

# the text conv net at test width: dict, embedding, filters, classes
TC = dict(dict_dim=100, emb_dim=16, hid_dim=32, class_dim=2)
TC_BATCH, TC_STEPS = 4, 3


@pytest.mark.parametrize("case", cases.SEQUENCE_CASES, ids=_IDS)
def test_sequence_conv_matches_jax_forward_and_vjp(case):
    inputs, rng = cases.case_inputs(case)
    _assert_parity(case[1], case[3], inputs, rng)


@pytest.mark.cuda
@pytest.mark.parametrize("case", cases.SEQUENCE_CASES, ids=_IDS)
def test_cuda_sequence_conv_matches_cpu(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    worst, where = cases.max_mismatch(cases.run_case(case, "cuda"),
                                      cases.run_case(case, "cpu"),
                                      RTOL, ATOL)
    assert worst <= 0, (case[0], where, worst)


def text_conv_net(pkg, main, dict_dim, emb_dim, hid_dim, class_dim, lr):
    """The book's convolution_net -> (loss, accuracy, prediction)."""
    L = pkg.layers
    words = L.data("words", shape=[1], dtype="int64", lod_level=1)
    label = L.data("label", shape=[1], dtype="int64")
    emb = L.embedding(words, size=[dict_dim, emb_dim], is_sparse=True)
    conv_3 = pkg.nets.sequence_conv_pool(emb, num_filters=hid_dim,
                                         filter_size=3, act="tanh",
                                         pool_type="sqrt")
    conv_4 = pkg.nets.sequence_conv_pool(emb, num_filters=hid_dim,
                                         filter_size=4, act="tanh",
                                         pool_type="sqrt")
    prediction = L.fc(input=[conv_3, conv_4], size=class_dim,
                      act="softmax")
    loss = L.mean(L.cross_entropy(input=prediction, label=label))
    acc = L.accuracy(input=prediction, label=label)
    pkg.optimizer.Adagrad(learning_rate=lr).minimize(loss)
    return loss, acc, prediction


def _text_feed(pkg, step, dict_dim, batch=TC_BATCH):
    """Lengths in [2, 9], ids in [0, dict_dim), labels 0/1, from a seed."""
    rng = np.random.RandomState(40 + step)
    lens = [int(n) for n in rng.randint(2, 10, size=batch)]
    rows = rng.randint(0, dict_dim, size=(sum(lens), 1)).astype(np.int64)
    return {"words": pkg.create_lod_tensor(rows, [lens], None),
            "label": rng.randint(0, 2, size=(batch, 1)).astype(np.int64)}


def test_text_conv_net_trains_as_jax():
    """The program is the JAX package's op for op; three Adagrad steps
    (the book's rate, 0.002) from the JAX startup scope give its losses
    and accuracies and each step's dense parameter gradients at the op
    tolerances, and after them every parameter to rtol 1e-5 of each
    array's largest magnitude.
    (Adagrad divides a gradient by its own root mean square: where one
    is ~1e-7, rounding that the gradients' tolerance admits moves the
    step by percents, so a far larger rate would compare rounding.)"""
    built = build_both(lambda pkg, main: text_conv_net(pkg, main, lr=0.002,
                                                       **TC))
    jm, js, (jloss, jacc, _) = built["jax"]
    tm, _, (tloss, tacc, _) = built["torch"]
    assert program_ops(tm) == program_ops(jm)
    assert "sequence_conv" in [op.type for op in tm.global_block().ops]
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(js, scope=jscope)
    init = {n: np.asarray(jscope.get(n)) for n in jscope.keys()}
    tscope = tfluid.scope_from_jax(init, tfluid.Scope(), tfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    params = [p.name for p in tm.all_parameters()]
    assert len(params) == 8   # table, 2 x (filter, bias), fc's 2 w and b
    # the table's gradient is a SelectedRows value: held by its update
    grads = [n + "@GRAD" for n in params if not n.startswith("embedding")]
    losses = []
    for step in range(TC_STEPS):
        jr = jexe.run(jm, feed=_text_feed(jfluid, step, TC["dict_dim"]),
                      fetch_list=[jloss, jacc] + grads, scope=jscope)
        tr = texe.run(tm, feed=_text_feed(tfluid, step, TC["dict_dim"]),
                      fetch_list=[tloss, tacc] + grads, scope=tscope)
        for j, t, what in zip(jr, tr, ["loss", "accuracy"] + grads):
            np.testing.assert_allclose(np.asarray(t), np.asarray(j),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg="step %d %s" % (step, what))
        losses.append(float(np.asarray(tr[0]).ravel()[0]))
    assert np.isfinite(losses).all()
    for n in params:
        assert_scaled_close(as_numpy(tscope.get(n)), jscope.get(n), RTOL, n)


def _attention(pkg, main, T, d, heads):
    L = pkg.layers
    x = L.data("x", shape=[T, d], dtype="float32")
    q = L.fc(x, size=d, num_flatten_dims=2)
    k = L.fc(x, size=d, num_flatten_dims=2)
    v = L.fc(x, size=d, num_flatten_dims=2)
    att = pkg.nets.scaled_dot_product_attention(q, k, v, num_heads=heads)
    gated = pkg.nets.glu(L.fc(x, size=2 * d, num_flatten_dims=2))
    loss = L.mean(L.square(att)) + L.mean(gated)
    pkg.optimizer.SGD(0.5).minimize(loss)
    return loss, att, gated


def test_scaled_dot_product_attention_and_glu_match_jax():
    """Multi-head attention at B 2, T 16, d 32, 4 heads and a glu over
    [B, T, 64]: the program is the JAX package's; the outputs, the loss
    and, after one SGD step, every parameter agree."""
    built = build_both(lambda pkg, main: _attention(pkg, main, 16, 32, 4))
    jm, js, jouts = built["jax"]
    tm, _, touts = built["torch"]
    assert program_ops(tm) == program_ops(jm)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(js, scope=jscope)
    init = {n: np.asarray(jscope.get(n)) for n in jscope.keys()}
    tscope = tfluid.scope_from_jax(init, tfluid.Scope(), tfluid.CPUPlace())
    feed = {"x": np.random.RandomState(5).randn(2, 16, 32).astype(
        np.float32)}
    jr = jexe.run(jm, feed=feed, fetch_list=list(jouts), scope=jscope)
    tr = tfluid.Executor(tfluid.CPUPlace()).run(
        tm, feed=feed, fetch_list=list(touts), scope=tscope)
    for j, t, what in zip(jr, tr, ("loss", "attention", "glu")):
        assert np.asarray(t).shape == np.asarray(j).shape, what
        np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=RTOL,
                                   atol=ATOL, err_msg=what)
    # at the op tolerances: the keys' bias has a zero gradient (softmax
    # is blind to a shift of every key), so both sides keep it at 0 plus
    # rounding of ~1e-10, which no relative measure compares
    for p in tm.all_parameters():
        np.testing.assert_allclose(as_numpy(tscope.get(p.name)),
                                   np.asarray(jscope.get(p.name)),
                                   rtol=RTOL, atol=ATOL, err_msg=p.name)


def _card_vs_cpu(fn, feeds):
    """One program (fn under fresh Programs) run on the card and on the
    CPU from one startup state: the fetches of each step and the final
    parameters, card then CPU."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        fetch = list(fn(tfluid, main))
    scope0 = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope0)
    init = {n: as_numpy(scope0.get(n)) for n in scope0.keys()}
    res = []
    for place in (tfluid.CUDAPlace(0), tfluid.CPUPlace()):
        scope = tfluid.scope_from_jax(init, tfluid.Scope(), place)
        exe = tfluid.Executor(place)
        outs = [[np.asarray(a) for a in exe.run(main, feed=f(),
                                                fetch_list=fetch,
                                                scope=scope)]
                for f in feeds]
        res.append((outs, {p.name: as_numpy(scope.get(p.name))
                           for p in main.all_parameters()}))
    return res


@pytest.mark.cuda
def test_cuda_text_conv_net_and_attention_match_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for fn, feeds in (
            (lambda pkg, main: text_conv_net(pkg, main, lr=0.002, **TC),
             [lambda s=s: _text_feed(tfluid, s, TC["dict_dim"])
              for s in range(TC_STEPS)]),
            (lambda pkg, main: _attention(pkg, main, 16, 32, 4),
             [lambda: {"x": np.random.RandomState(5).randn(
                 2, 16, 32).astype(np.float32)}])):
        (gout, gpar), (cout, cpar) = _card_vs_cpu(fn, feeds)
        for gs, cs in zip(gout, cout):
            for g, c in zip(gs, cs):
                np.testing.assert_allclose(g, c, rtol=RTOL, atol=ATOL)
        for n in cpar:
            np.testing.assert_allclose(gpar[n], cpar[n], rtol=RTOL,
                                       atol=ATOL, err_msg=n)


def test_fluid_root_exports_the_jax_names():
    names = ["Constant", "Normal", "Uniform", "Xavier", "MSRA", "gradients",
             "DispatchPipeline", "Trainer", "Inferencer", "name_scope",
             "set_flags", "get_flags"]
    for n in names:
        assert hasattr(tfluid, n) and hasattr(jfluid, n), n
    init = tfluid.initializer
    for n in ("TruncatedNormal", "MSRA", "Bilinear", "NumpyArrayInitializer",
              "init_on_cpu", "force_init_on_cpu"):
        assert hasattr(init, n), n
    assert tfluid.Trainer is tfluid.contrib.Trainer
    assert tfluid.MSRA is init.MSRAInitializer


def _init_program(pkg, main):
    init, L = pkg.initializer, pkg.layers
    with init.init_on_cpu():
        outs = [
            L.create_parameter([4, 4, 3, 3], "float32", name="bilinear",
                               default_initializer=init.Bilinear()),
            L.create_parameter([2, 3], "float32", name="numpy",
                               default_initializer=init.NumpyArrayInitializer(
                                   np.arange(6.0).reshape(2, 3))),
            L.create_parameter([64, 32], "float32", name="msra_u",
                               default_initializer=init.MSRA()),
            L.create_parameter([64, 32], "float32", name="msra_n",
                               default_initializer=init.MSRA(
                                   uniform=False)),
            L.create_parameter([64, 32], "float32", name="xavier_n",
                               default_initializer=init.Xavier(
                                   uniform=False, fan_in=10)),
            L.create_parameter([128, 64], "float32", name="trunc",
                               default_initializer=init.TruncatedNormal(
                                   0.5, 0.2))]
    with pkg.name_scope("block1"):
        with pkg.name_scope("inner"):
            L.scale(outs[0], scale=2.0)
    return outs


def test_initializers_and_name_scope_match_jax():
    """The startup ops are the JAX package's; Bilinear and
    NumpyArrayInitializer give its values, the random ones its bounds and
    moments; name_scope labels ops as it does."""
    built = build_both(_init_program)
    (jm, js, _), (tm, ts, _) = built["jax"], built["torch"]
    assert program_ops(ts) == program_ops(js)
    assert program_ops(tm) == program_ops(jm)
    assert tm.global_block().ops[-1].attrs["op_namescope"] == "block1/inner"
    jscope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(js, scope=jscope)
    tscope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(ts, scope=tscope)
    got = {n: as_numpy(tscope.get(n)) for n in ("bilinear", "numpy",
                                                "msra_u", "msra_n",
                                                "xavier_n", "trunc")}
    for n in ("bilinear", "numpy"):
        np.testing.assert_array_equal(got[n], np.asarray(jscope.get(n)))
    # a [64, 32] weight: fan_in 64, fan_out 32
    limit = np.sqrt(6.0 / 64)
    assert limit * 0.95 < np.abs(got["msra_u"]).max() <= limit
    for n, std in (("msra_n", np.sqrt(2.0 / 64)),
                   ("xavier_n", np.sqrt(2.0 / (10 + 32)))):
        assert abs(got[n].std() - std) < 0.1 * std
    t = got["trunc"]
    assert t.min() >= 0.5 - 0.4 and t.max() <= 0.5 + 0.4
    assert abs(t.mean() - 0.5) < 0.01


def test_set_and_get_flags():
    before = tfluid.get_flags(["benchmark", "async_dispatch_depth"])
    try:
        tfluid.set_flags({"benchmark": "true", "async_dispatch_depth": 2})
        assert tfluid.get_flags(["benchmark", "async_dispatch_depth"]) == {
            "benchmark": True, "async_dispatch_depth": 2}
        assert tfluid.FLAGS.benchmark is True
    finally:
        tfluid.set_flags(before)
    with pytest.raises(KeyError):
        tfluid.set_flags({"no_such_flag": 1})
