"""The recurrent family of paddle_tpu_torch (gru, gru_unit, lstm_unit,
lstmp, simple_rnn, attention_lstm) and the fused recurrent ops
(fusion_lstm, fusion_gru, fusion_seqconv_eltadd_relu,
fusion_seqexpand_concat_fc, fused_embedding_fc_lstm) held against the
JAX lowerings on the CPU: forward and vjp in fp32, with the sequence
input in bf16 (the AMP path), and the JAX gru's activation attrs pinned;
the recurrent layers against the JAX layers, in fp32 and under AMP; the
card twins against the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_op_cases as cases
from test_torch_ops import (BF16, RTOL, ATOL, ULP, _assert_parity,
                            _jax_cotangent, _to_numpy, _to_torch)
from test_torch_seq_ops import assert_same_vars
from torch_train_parity import (Pair, assert_scaled_close, build_both,
                                program_ops)

import paddle_tpu.fluid as jfluid
import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.ops import registry as treg

_CASES = cases.RECURRENT_CASES + cases.FUSED_CASES
_IDS = [c[0] for c in _CASES]
_BY_ID = dict(zip(_IDS, _CASES))

# the cases again with their sequence input in bf16 (an fc without a bias
# gives the next op bf16 under AMP) and the weights fp32 masters: the
# carry is fp32, the JAX lowering's dtypes, its values to one bf16 ulp
_BF16_SLOTS = {
    "gru": "Input", "gru_reverse_h0": "Input", "lstmp_peepholes": "Input",
    "lstmp_reverse_h0_c0": "Input", "simple_rnn": "Input",
    "attention_lstm": "X", "fusion_lstm": "X", "fusion_gru": "X",
    "fusion_seqexpand_concat_fc": "X",
    "fused_embedding_fc_lstm": "Embeddings",
}


@pytest.fixture(autouse=True)
def _amp_off_after():
    yield
    jfluid.set_amp(False)
    tfluid.set_amp(False)


@pytest.mark.parametrize("case", _CASES, ids=_IDS)
def test_recurrent_lowering_matches_jax_forward_and_vjp(case):
    inputs, rng = cases.case_inputs(case)
    _assert_parity(case[1], case[3], inputs, rng)


def _bf16_close(got, want, what):
    """One bf16 ulp of the array's largest magnitude, with the fp32 op
    tolerance's absolute floor: a gradient that is 0 but for rounding
    (attention_lstm's scalar bias shifts every valid score alike, which
    the softmax does not see) has no magnitude to scale by."""
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    w = want.astype(np.float64)
    scale = float(np.abs(w).max()) if w.size else 0.0
    np.testing.assert_allclose(got.astype(np.float64), w, rtol=ULP,
                               atol=max(ULP * scale, ATOL), err_msg=what)


@pytest.mark.parametrize("name", sorted(_BF16_SLOTS))
def test_recurrent_lowering_matches_jax_with_bf16_input(name):
    """The sequence input in bf16, every other input fp32: outputs and
    input grads dtype for dtype, to one bf16 ulp of each array's largest
    magnitude."""
    _, op_type, _, attrs = case = _BY_ID[name]
    inputs, rng = cases.case_inputs(case)
    slot = _BF16_SLOTS[name]
    inputs[slot] = [a.astype(BF16) for a in inputs[slot]]
    op = cases.case_op(op_type, attrs, inputs)
    jouts, jvjp = jreg.make_forward_and_vjp(
        op, jreg.get_op_def(op_type), jreg.ExecContext(
            op, {s: [jnp.asarray(a) for a in v] for s, v in inputs.items()}))
    touts, tvjp = treg.make_forward_and_vjp(
        op, treg.get_op_def(op_type), treg.ExecContext(
            op, {s: [_to_torch(a) for a in v] for s, v in inputs.items()},
            device="cpu"))
    assert sorted(jouts) == sorted(touts)
    cts = {}
    for s in jouts:
        cts[s] = []
        for jv, tv in zip(jouts[s], touts[s]):
            jv = np.asarray(jv)
            got = _to_numpy(tv)
            if jv.dtype.kind in "iu":   # x64 off: int64 comes back int32
                got = got.astype(jv.dtype)
            _bf16_close(got, jv, s)
            cts[s].append(np.asarray(rng.randn(*jv.shape)).astype(jv.dtype)
                          if jv.dtype.kind == "f" or jv.dtype == BF16
                          else None)
    for slot in ("Hidden", "Projection", "Out"):   # the fp32 carry
        if slot in touts:
            assert touts[slot][0].dtype == torch.float32, slot
    jgrads = jvjp({s: [_jax_cotangent(v, c) for v, c in zip(jouts[s], cs)]
                   for s, cs in cts.items()})
    tgrads = tvjp({s: [None if c is None else _to_torch(c) for c in cs]
                   for s, cs in cts.items()})
    for s, vals in inputs.items():
        for i, a in enumerate(vals):
            if a.dtype.kind != "f" and a.dtype != BF16:
                assert tgrads[s][i] is None, s
                continue
            _bf16_close(_to_numpy(tgrads[s][i]), np.asarray(jgrads[s][i]),
                        "grad " + s)


def test_gru_reads_neither_activation_attr():
    """The JAX gru lowering is always sigmoid and tanh (ROADMAP queue 3):
    relu / identity in the attrs give the defaults' values in both
    packages."""
    case = _BY_ID["gru_activation_attrs_ignored"]
    inputs, _ = cases.case_inputs(case)
    outs = {}
    for attrs in (case[3], {}):
        op = cases.case_op("gru", attrs, inputs)
        outs[bool(attrs)] = treg.get_op_def("gru").lower(treg.ExecContext(
            op, {s: [torch.from_numpy(a) for a in v]
                 for s, v in inputs.items()}))["Hidden"]
        j = jreg.get_op_def("gru").lower(jreg.ExecContext(
            op, {s: [jnp.asarray(a) for a in v]
                 for s, v in inputs.items()}))["Hidden"]
        np.testing.assert_allclose(outs[bool(attrs)].numpy(), np.asarray(j),
                                   rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(outs[True], outs[False], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", _CASES, ids=_IDS)
def test_cuda_recurrent_lowering_matches_cpu(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    worst, where = cases.max_mismatch(cases.run_case(case, "cuda"),
                                      cases.run_case(case, "cpu"),
                                      RTOL, ATOL)
    assert worst <= 0, (case[0], where, worst)


def _recurrent_layers(pkg, main):
    """dynamic_gru (forward, and reversed from an h_0), dynamic_lstmp,
    gru_unit and lstm_unit over an embedding and dense feeds; SGD 0.1 on
    the sum of their means."""
    L = pkg.layers
    words = L.data("words", shape=[1], dtype="int64", lod_level=1)
    x = L.data("x", shape=[5], dtype="float32")
    h_prev = L.data("h_prev", shape=[4], dtype="float32")
    c_prev = L.data("c_prev", shape=[4], dtype="float32")
    emb = L.embedding(words, size=[40, 6])
    gru = L.dynamic_gru(L.fc(emb, size=12), size=4)
    gru_r = L.dynamic_gru(L.fc(emb, size=12), size=4, is_reverse=True,
                          h_0=L.fc(x, size=4))
    proj, cell = L.dynamic_lstmp(L.fc(emb, size=16), size=16, proj_size=3)
    proj_r, _ = L.dynamic_lstmp(L.fc(emb, size=8), size=8, proj_size=2,
                                use_peepholes=False, is_reverse=True,
                                proj_activation="identity")
    hu, reset, gate = L.gru_unit(L.fc(x, size=12), h_prev, size=12)
    h, c = L.lstm_unit(x, h_prev, c_prev, forget_bias=1.0)
    outs = [gru, gru_r, proj, cell, proj_r, hu, reset, gate, h, c]
    loss = L.sums([L.mean(o) for o in outs])
    pkg.optimizer.SGD(0.1).minimize(loss)
    return [loss] + outs


def _recurrent_feed(pkg, step):
    rng = np.random.RandomState(50 + step)
    lens = [4, 1, 6]
    rows = rng.randint(0, 40, size=(sum(lens), 1)).astype(np.int64)
    return {"words": pkg.create_lod_tensor(rows, [lens], None),
            "x": rng.randn(3, 5).astype(np.float32),
            "h_prev": rng.randn(3, 4).astype(np.float32),
            "c_prev": rng.randn(3, 4).astype(np.float32)}


def test_recurrent_layers_build_the_jax_program_and_train_alike():
    """The layers' program is the JAX package's op for op, with its
    build-time shapes and parameter shapes (LSTMP's ProjWeight [D, P]);
    two SGD steps from the JAX startup scope agree on every fetch and
    every parameter."""
    built = build_both(_recurrent_layers)
    (jm, _, _), (tm, _, tout) = built["jax"], built["torch"]
    assert program_ops(tm) == program_ops(jm)
    assert_same_vars(tm, jm)
    lstmp = next(op for op in tm.global_block().ops if op.type == "lstmp")
    pw = tm.global_block().var(lstmp.input("ProjWeight")[0])
    assert tuple(pw.shape) == (4, 3)
    pair = Pair(built)
    for step in range(2):
        with jfluid.scope_guard(pair.jscope), \
                tfluid.scope_guard(pair.tscope):
            jr = pair.jexe.run(pair.jmain, feed=_recurrent_feed(jfluid, step),
                               fetch_list=[v.name for v in tout])
            tr = pair.texe.run(pair.tmain, feed=_recurrent_feed(tfluid, step),
                               fetch_list=[v.name for v in tout])
        for v, j, t in zip(tout, jr, tr):
            np.testing.assert_allclose(np.asarray(t), np.asarray(j),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg="step %d %s" % (step, v.name))
    pair.assert_state_close(rtol=RTOL)


def _amp_gru(pkg, main):
    """An embedding, an fc with no bias (bf16 out under AMP), a
    dynamic_gru, max pool, an fc softmax and cross entropy; Adam 0.01."""
    L = pkg.layers
    words = L.data("words", shape=[1], dtype="int64", lod_level=1)
    label = L.data("label", shape=[1], dtype="int64")
    emb = L.embedding(words, size=[40, 16])
    gru = L.dynamic_gru(L.fc(emb, size=24, bias_attr=False), size=8)
    pred = L.fc(L.sequence_pool(gru, "max"), size=2, act="softmax")
    loss = L.mean(L.cross_entropy(input=pred, label=label))
    pkg.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return loss, gru


def test_dynamic_gru_under_amp_matches_jax():
    """set_amp(True) in both packages: the fc gives the gru a bf16 input
    while its weights stay fp32 masters, so the carry and the hidden are
    fp32 in both; three Adam steps' losses agree to the AMP tolerance of
    the other AMP tests, the first step's fp32 gradients to one bf16
    ulp of each array's largest magnitude."""
    built = build_both(_amp_gru)
    (jm, _, (jloss, jgru)), (tm, _, (tloss, tgru)) = \
        built["jax"], built["torch"]
    pair = Pair(built)
    jfluid.set_amp(True)
    tfluid.set_amp(True)
    params = sorted(p.name for p in tm.all_parameters())
    rng = np.random.RandomState(7)
    lens = [5, 2, 7, 3]
    feed_rows = rng.randint(0, 40, size=(sum(lens), 1)).astype(np.int64)
    labels = rng.randint(0, 2, size=(4, 1)).astype(np.int64)
    losses = {"jax": [], "torch": []}
    for step in range(3):
        fetch = [tloss.name, tgru.name] + (
            [p + "@GRAD" for p in params] if step == 0 else [])
        outs = []
        for key, pkg, scope, exe, main in (
                ("jax", jfluid, pair.jscope, pair.jexe, pair.jmain),
                ("torch", tfluid, pair.tscope, pair.texe, pair.tmain)):
            feed = {"words": pkg.create_lod_tensor(feed_rows, [lens], None),
                    "label": labels}
            with pkg.scope_guard(scope):
                r = exe.run(main, feed=feed, fetch_list=fetch)
            losses[key].append(float(np.asarray(r[0]).ravel()[0]))
            outs.append(r)
        jr, tr = outs
        assert np.asarray(tr[1]).dtype == np.float32
        if step == 0:
            for name, j, t in zip(fetch[1:], jr[1:], tr[1:]):
                assert np.asarray(t).dtype == np.float32, name
                assert_scaled_close(np.asarray(t), np.asarray(j),
                                    2.0 ** -7, name)
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=1e-3)
    assert losses["torch"][-1] < losses["torch"][0]


def _fused_ops_program(pkg, main):
    """The recurrent and fused ops that have no layer, appended to the
    block as the IR passes append them, on packed [-1, D] inputs."""
    block = main.global_block()

    def var(name, shape, dtype="float32", lod_level=0):
        return block.create_var(name=name, shape=shape, dtype=dtype,
                                lod_level=lod_level)
    x = var("x", [-1, 4], lod_level=1)
    ids = var("ids", [-1, 1], "int64", lod_level=1)
    for n, shape in (("wx", [4, 12]), ("wh", [3, 12]), ("b7", [1, 21]),
                     ("gwx", [4, 9]), ("gwh", [3, 9]), ("gb", [1, 9]),
                     ("emb", [7, 12]), ("c0", [-1, 3]), ("aw", [7, 1]),
                     ("lw", [7, 12]), ("lb", [1, 12]), ("rw", [4, 4]),
                     ("filt", [12, 5]), ("fb", [1, 5])):
        var(n, shape)
    specs = [
        ("fusion_lstm", {"X": x, "WeightX": "wx", "WeightH": "wh",
                         "Bias": "b7"}, ("Hidden", "Cell", "XX")),
        ("fusion_gru", {"X": x, "WeightX": "gwx", "WeightH": "gwh",
                        "Bias": "gb"}, ("Hidden", "XX")),
        ("fused_embedding_fc_lstm", {"Ids": ids, "Embeddings": "emb",
                                     "WeightH": "wh", "Bias": "b7"},
         ("Hidden", "Cell", "XX")),
        ("attention_lstm", {"X": x, "C0": "c0", "AttentionWeight": "aw",
                            "LSTMWeight": "lw", "LSTMBias": "lb"},
         ("Hidden", "Cell")),
        ("simple_rnn", {"Input": x, "Weight": "rw"}, ("Out",)),
        ("fusion_seqconv_eltadd_relu", {"X": x, "Filter": "filt",
                                        "Bias": "fb"}, ("Out", "ColMat")),
    ]
    outs = []
    for i, (op_type, inputs, out_slots) in enumerate(specs):
        ins = {k: [v if isinstance(v, str) else v.name]
               for k, v in inputs.items()}
        o = {s: [var("%s_%d_%s" % (op_type, i, s.lower()), None).name]
             for s in out_slots}
        block.append_op(type=op_type, inputs=ins, outputs=o,
                        attrs={"contextLength": 3, "contextStart": -1})
        outs += [block.var(n[0]) for n in o.values()]
    return outs


def test_fused_ops_infer_the_jax_packages_shapes():
    """Each package's shape function gives the same build-time shapes:
    [-1, D] a packed time step for the hidden and cell."""
    built = build_both(_fused_ops_program)
    (jm, _, _), (tm, _, _) = built["jax"], built["torch"]
    assert_same_vars(tm, jm)
    shapes = {v.name: v.shape for v in built["torch"][2]}
    assert shapes["fusion_lstm_0_hidden"] == (-1, 3)
    assert shapes["attention_lstm_3_cell"] == (-1, 3)
