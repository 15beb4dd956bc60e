"""The text-classification GRU net (PaddlePaddle/models
text_classification nets.py gru_net: embedding with a 30x learning rate,
fc to 3 x hidden, dynamic_gru, max pool, tanh, fc tanh, fc softmax,
cross entropy, Adagrad 0.002) on paddle_tpu_torch against paddle_tpu on
the CPU, at narrow widths: the same program op for op, three steps from
the JAX startup scope carried across by `scope_from_jax`, with the loss,
the accuracy and every dense gradient (the embedding table's too) at
rtol 1e-5 of each array's largest magnitude, and the gru op's batch
outputs.  The card twin holds the card against the CPU."""

import numpy as np
import pytest
import torch

from test_torch_ops import RTOL
from test_torch_seq_ops import assert_same_vars
from torch_train_parity import assert_scaled_close, build_both, program_ops

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid.executor import as_numpy

# the net at test width: dict, embedding, GRU hidden, second fc, classes
GRU_NET = dict(dict_dim=100, emb_dim=16, hid_dim=8, hid_dim2=6, class_dim=2)
GRU_BATCH, GRU_STEPS, GRU_LR = 4, 3, 0.002


def gru_net(pkg, main, dict_dim, emb_dim, hid_dim, hid_dim2, class_dim,
            lr=GRU_LR):
    """gru_net -> (loss, accuracy, prediction, the gru's hidden)."""
    L = pkg.layers
    words = L.data("words", shape=[1], dtype="int64", lod_level=1)
    label = L.data("label", shape=[1], dtype="int64")
    emb = L.embedding(input=words, size=[dict_dim, emb_dim],
                      param_attr=pkg.ParamAttr(learning_rate=30.0))
    fc0 = L.fc(input=emb, size=hid_dim * 3)
    gru_h = L.dynamic_gru(input=fc0, size=hid_dim, is_reverse=False)
    gru_max = L.sequence_pool(input=gru_h, pool_type="max")
    fc1 = L.fc(input=L.tanh(gru_max), size=hid_dim2, act="tanh")
    prediction = L.fc(input=fc1, size=class_dim, act="softmax")
    loss = L.mean(L.cross_entropy(input=prediction, label=label))
    acc = L.accuracy(input=prediction, label=label)
    pkg.optimizer.Adagrad(learning_rate=lr).minimize(loss)
    return loss, acc, prediction, gru_h


def gru_feed(pkg, step, dict_dim=GRU_NET["dict_dim"], batch=GRU_BATCH):
    """Lengths in [1, 9], ids in [0, dict_dim), labels 0/1, from a seed."""
    rng = np.random.RandomState(60 + step)
    lens = [int(n) for n in rng.randint(1, 10, size=batch)]
    rows = rng.randint(0, dict_dim, size=(sum(lens), 1)).astype(np.int64)
    return {"words": pkg.create_lod_tensor(rows, [lens], None),
            "label": rng.randint(0, 2, size=(batch, 1)).astype(np.int64)}


def _gru_op(main):
    return next(op for op in main.global_block().ops if op.type == "gru")


def test_gru_net_builds_the_jax_program():
    """The op types, slots, attrs and the parameters' names and shapes are
    the JAX package's: GRU Weight [H, 3H] and Bias [1, 3H]."""
    built = build_both(lambda pkg, main: gru_net(pkg, main, **GRU_NET))
    (jm, _, _), (tm, _, _) = built["jax"], built["torch"]
    assert program_ops(tm) == program_ops(jm)
    H = GRU_NET["hid_dim"]
    op = _gru_op(tm)
    w = tm.global_block().var(op.input("Weight")[0])
    b = tm.global_block().var(op.input("Bias")[0])
    assert tuple(w.shape) == (H, 3 * H) and tuple(b.shape) == (1, 3 * H)
    assert op.attrs["gate_activation"] == "sigmoid"
    assert op.attrs["activation"] == "tanh"
    assert {p.name: tuple(p.shape) for p in tm.all_parameters()} == \
        {p.name: tuple(p.shape) for p in jm.all_parameters()}
    assert_same_vars(tm, jm)


def _summed_cotangents(main):
    """{a bias's gradient: the gradient whose rows it sums}: an fc's bias
    sums the rows of its add's output gradient, the gru's bias those of
    the gru's Input gradient (BatchGate is Input + Bias)."""
    params = {p.name for p in main.all_parameters()}
    out = {}
    for op in main.global_block().ops:
        if op.type == "elementwise_add" and op.input("Y")[0] in params:
            out[op.input("Y")[0] + "@GRAD"] = op.output("Out")[0] + "@GRAD"
        elif op.type == "gru":
            out[op.input("Bias")[0] + "@GRAD"] = \
                op.input("Input")[0] + "@GRAD"
    return out


def _floor_scale(grad, terms):
    """The magnitude a gradient's rounding scales with: its largest
    element, or for a bias the largest column sum of |the rows it
    sums| (the first step's balanced labels cancel the softmax's rows
    of the last fc's bias gradient to 1/150 of them)."""
    scale = float(np.abs(grad).max())
    if terms is not None:
        t = np.abs(np.asarray(terms, np.float64))
        scale = max(scale, float(t.reshape(-1, t.shape[-1]).sum(0).max()))
    return scale


def test_gru_net_trains_as_jax():
    """Three Adagrad steps from the JAX startup scope carried across: the
    loss and the accuracy at rtol 1e-5, each step's dense gradients
    (table, fc, GRU weight and bias, fcs) at rtol 1e-5 with the absolute
    floor scaled by the array's largest magnitude (a bias's by the rows
    it sums), then every parameter at rtol 1e-5 of its largest
    magnitude or of the steps' updates."""
    built = build_both(lambda pkg, main: gru_net(pkg, main, **GRU_NET))
    jm, js, (jloss, jacc, _, _) = built["jax"]
    tm, _, (tloss, tacc, _, _) = built["torch"]
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(js, scope=jscope)
    init = {n: np.asarray(jscope.get(n)) for n in jscope.keys()}
    tscope = tfluid.scope_from_jax(init, tfluid.Scope(), tfluid.CPUPlace())
    for n, a in init.items():   # carried unchanged, the GRU's included
        np.testing.assert_array_equal(as_numpy(tscope.get(n)), a)
    texe = tfluid.Executor(tfluid.CPUPlace())
    params = sorted(p.name for p in tm.all_parameters())
    assert len(params) == 9   # table, fc0 w b, gru w b, fc1 w b, fc2 w b
    grads = [n + "@GRAD" for n in params]
    summed = _summed_cotangents(tm)
    assert len(summed) == 4   # the three fc biases and the gru's
    terms = sorted(set(summed.values()))
    losses = []
    for step in range(GRU_STEPS):
        fetch = [jloss.name, jacc.name] + grads
        jr = jexe.run(jm, feed=gru_feed(jfluid, step),
                      fetch_list=fetch + terms, scope=jscope)
        tr = texe.run(tm, feed=gru_feed(tfluid, step), fetch_list=fetch,
                      scope=tscope)
        jterms = dict(zip(terms, jr[len(fetch):]))
        for j, t, what in zip(jr[:2], tr[:2], ("loss", "accuracy")):
            np.testing.assert_allclose(np.asarray(t), np.asarray(j),
                                       rtol=RTOL, err_msg="step %d %s"
                                       % (step, what))
        for g, j, t in zip(grads, jr[2:], tr[2:]):
            j, t = np.asarray(j, np.float64), np.asarray(t, np.float64)
            scale = _floor_scale(j, jterms.get(summed.get(g)))
            np.testing.assert_allclose(t, j, rtol=RTOL, atol=RTOL * scale,
                                       err_msg="step %d %s" % (step, g))
        losses.append(float(np.asarray(tr[0]).ravel()[0]))
    assert np.isfinite(losses).all()
    # Adagrad moves an element by up to its rate a step whatever the
    # gradient's size (the table's rate is 30x), so an element's rounding
    # scales with the steps' rate as well as with the parameter
    for n in params:
        want = np.asarray(jscope.get(n), np.float64)
        rate = GRU_LR * (30.0 if n.startswith("embedding") else 1.0)
        np.testing.assert_allclose(
            as_numpy(tscope.get(n)), want, rtol=RTOL,
            atol=RTOL * max(float(np.abs(want).max()), rate * GRU_STEPS),
            err_msg=n)


def test_gru_batch_outputs_match_jax():
    """Fetching the gru's BatchGate (Input + Bias), BatchResetHiddenPrev
    and BatchHidden (the hidden) gives the JAX package's values."""
    built = build_both(lambda pkg, main: gru_net(pkg, main, **GRU_NET))
    jm, js, (_, _, _, jh) = built["jax"]
    tm, _, (_, _, _, th) = built["torch"]
    op = _gru_op(tm)
    names = [th.name] + [op.output(s)[0] for s in
                         ("BatchGate", "BatchResetHiddenPrev",
                          "BatchHidden")]
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(js, scope=jscope)
    init = {n: np.asarray(jscope.get(n)) for n in jscope.keys()}
    tscope = tfluid.scope_from_jax(init, tfluid.Scope(), tfluid.CPUPlace())
    jr = jexe.run(jm, feed=gru_feed(jfluid, 0), fetch_list=names,
                  scope=jscope, return_numpy=False)
    tr = tfluid.Executor(tfluid.CPUPlace()).run(
        tm, feed=gru_feed(tfluid, 0), fetch_list=names, scope=tscope,
        return_numpy=False)
    for n, j, t in zip(names, jr, tr):
        assert_scaled_close(np.asarray(t), np.asarray(j), RTOL, n)
    # the hidden is ragged: its lengths are the feed's
    assert tr[0].recursive_sequence_lengths() == \
        jr[0].recursive_sequence_lengths()


@pytest.mark.cuda
def test_cuda_gru_net_matches_cpu():
    """Three steps on the card and on the CPU from one startup state: the
    losses at rtol 1e-5 and the dense gradients at rtol 1e-5 with the
    floor of the CPU test (each array's largest magnitude, a bias's
    summed rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        loss = gru_net(tfluid, main, **GRU_NET)[0]
    scope0 = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope0)
    init = {n: as_numpy(scope0.get(n)) for n in scope0.keys()}
    grads = [p.name + "@GRAD" for p in main.all_parameters()]
    summed = _summed_cotangents(main)
    terms = sorted(set(summed.values()))
    fetch = [loss.name] + grads + terms
    res = []
    for place in (tfluid.CUDAPlace(0), tfluid.CPUPlace()):
        scope = tfluid.scope_from_jax(init, tfluid.Scope(), place)
        exe = tfluid.Executor(place)
        res.append([[np.asarray(a, np.float64) for a in exe.run(
            main, feed=gru_feed(tfluid, s), fetch_list=fetch, scope=scope)]
            for s in range(GRU_STEPS)])
    for step, (g, c) in enumerate(zip(*res)):
        np.testing.assert_allclose(g[0], c[0], rtol=RTOL,
                                   err_msg="step %d loss" % step)
        cterms = dict(zip(terms, c[1 + len(grads):]))
        for name, a, b in zip(grads, g[1:], c[1:]):
            scale = _floor_scale(b, cterms.get(summed.get(name)))
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * scale,
                                       err_msg="step %d %s" % (step, name))
