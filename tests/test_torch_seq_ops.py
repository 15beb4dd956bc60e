"""The flat LoD sequence ops of paddle_tpu_torch (sequence_mask,
sequence_length, sequence_reverse, sequence_concat, sequence_unpad,
sequence_enumerate, sequence_slice, sequence_erase, sequence_reshape),
misc_ops' sequence_scatter, sequence_expand_as and row_conv, lod_reset
and lrn, held against the JAX lowerings on the CPU, forward and vjp;
their layers against the JAX layers (op for op, the build-time shapes,
two SGD steps from one startup scope); the card twins against the
CPU."""

import numpy as np
import pytest
import torch

import torch_op_cases as cases
from test_torch_ops import RTOL, ATOL, _assert_parity
from torch_train_parity import Pair, build_both, program_ops

import paddle_tpu.fluid as jfluid
import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.fluid import core as tcore
from paddle_tpu_torch.ops import registry as treg

_IDS = [c[0] for c in cases.SEQ_FLAT_CASES]

# the JAX package runs with x64 off: its int64 vars are recorded int32
_INT = {int(tcore.VarDesc.VarType.INT64), int(tcore.VarDesc.VarType.INT32)}


def assert_same_vars(tprog, jprog):
    """Every var of the two global blocks has the same build-time shape
    (None where neither infers one), lod_level and dtype (int64 and
    int32 alike)."""
    tv, jv = tprog.global_block().vars, jprog.global_block().vars
    assert sorted(tv) == sorted(jv)
    for n, v in tv.items():
        w = jv[n]
        assert (None if v.shape is None else tuple(v.shape)) == \
            (None if w.shape is None else tuple(w.shape)), n
        assert v.lod_level == w.lod_level, n
        a, b = int(v.dtype), int(w.dtype)
        assert a == b or {a, b} <= _INT, (n, v.dtype, w.dtype)


@pytest.mark.parametrize("case", cases.SEQ_FLAT_CASES, ids=_IDS)
def test_flat_sequence_lowering_matches_jax_forward_and_vjp(case):
    inputs, rng = cases.case_inputs(case)
    _assert_parity(case[1], case[3], inputs, rng)


@pytest.mark.cuda
@pytest.mark.parametrize("case", cases.SEQ_FLAT_CASES, ids=_IDS)
def test_cuda_flat_sequence_lowering_matches_cpu(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    worst, where = cases.max_mismatch(cases.run_case(case, "cuda"),
                                      cases.run_case(case, "cpu"),
                                      RTOL, ATOL)
    assert worst <= 0, (case[0], where, worst)


def _lower(reg, op_type, attrs, inputs, to):
    op = cases.case_op(op_type, attrs, inputs)
    return reg.get_op_def(op_type).lower(reg.ExecContext(
        op, {s: [to(a) for a in v] for s, v in inputs.items()}))


def test_sequence_reshape_of_an_indivisible_dense_input_raises():
    """T * D = 12 is not a multiple of new_dim 5: ValueError in both
    lowerings, as the reference's per-sequence check."""
    import jax.numpy as jnp
    inputs = {"X": [np.zeros((2, 3, 4), np.float32)]}
    for reg, to in ((treg, torch.from_numpy), (jreg, jnp.asarray)):
        with pytest.raises(ValueError, match="not divisible"):
            _lower(reg, "sequence_reshape", {"new_dim": 5}, inputs, to)


def test_sequence_erase_compacts_with_no_sort(monkeypatch):
    """The survivors are numbered by a cumsum and scattered: no sort runs
    (a sort's order of equal keys is not promised on the card)."""
    def refuse(*a, **k):
        raise AssertionError("sequence_erase sorted")
    for name in ("sort", "argsort"):
        monkeypatch.setattr(torch, name, refuse)
        monkeypatch.setattr(torch.Tensor, name, refuse)
    case = next(c for c in cases.SEQ_FLAT_CASES
                if c[0] == "sequence_erase_dense_repeats")
    inputs, _ = cases.case_inputs(case)
    out = _lower(treg, "sequence_erase", case[3], inputs, torch.from_numpy)
    assert out["Out"].tolist() == [[2, 0, 0, 0, 0, 0], [0] * 6,
                                   [2, 2, 0, 4, 4, 2]]
    assert out["Out@LOD_LEN"].tolist() == [1, 0, 6]


def test_sequence_length_and_mask_are_int64_where_jax_is_int32():
    """Queue 3's deliberate difference: the port keeps int64 (the JAX
    package, x64 off, gives int32); the values are equal."""
    import jax.numpy as jnp
    for name in ("sequence_length", "sequence_mask_maxlen"):
        case = next(c for c in cases.SEQ_FLAT_CASES if c[0] == name)
        inputs, _ = cases.case_inputs(case)
        t = _lower(treg, case[1], case[3], inputs, torch.from_numpy)
        j = _lower(jreg, case[1], case[3], inputs, jnp.asarray)
        slot = "Out" if name == "sequence_length" else "Y"
        assert t[slot].dtype == torch.int64
        assert np.asarray(j[slot]).dtype == np.int32
        np.testing.assert_array_equal(t[slot].numpy(), np.asarray(j[slot]))


DICT = 50


def _flat_layers(pkg, main):
    """Every flat sequence layer, lod_reset, row_conv and lrn, over an fc
    of the feeds so that gradients reach parameters; SGD 0.1 on the sum
    of their means."""
    L = pkg.layers
    words = L.data("words", shape=[1], dtype="int64", lod_level=1)
    x = L.data("x", shape=[6], dtype="float32", lod_level=1)
    y = L.data("y", shape=[1], dtype="float32", lod_level=1)
    padded = L.data("padded", shape=[5, 6], dtype="float32")
    plen = L.data("plen", shape=[1], dtype="int64")
    offset = L.data("offset", shape=[1], dtype="int64")
    length = L.data("length", shape=[1], dtype="int64")
    img = L.data("img", shape=[4, 3, 3], dtype="float32")
    h = L.fc(x, size=6)
    rev = L.sequence_reverse(h)
    cat = L.sequence_concat([h, rev])
    enum = L.sequence_enumerate(words, win_size=2)
    rs = L.sequence_reshape(h, new_dim=3)
    lens = pkg.layers.sequence._sequence_length(h)
    mask = L.sequence_mask(lens, dtype="float32")
    sl = L.sequence_slice(h, offset, length)
    up = L.sequence_unpad(L.fc(padded, size=6, num_flatten_dims=2), plen)
    pooled = L.sequence_pool(h, "sum")
    ea = L.sequence_expand_as(pooled, h)
    sc = L.sequence_scatter(L.fc(pooled, size=DICT), words,
                            L.fc(h, size=1))
    lr = L.lod_reset(h, y=y)
    rc = L.row_conv(h, future_context_size=2, act="tanh")
    lrn = L.lrn(L.conv2d(img, num_filters=5, filter_size=1), n=3,
                alpha=0.1)
    outs = [rev, cat, rs, sl, up, ea, sc, lr, rc, lrn]
    loss = L.sums([L.mean(o) for o in outs])
    pkg.optimizer.SGD(0.1).minimize(loss)
    return [loss, enum, lens, mask] + outs


def _flat_feed(pkg, step):
    rng = np.random.RandomState(30 + step)
    lens = [3, 5, 2]
    n = sum(lens)

    def ragged(a, ls=lens):
        return pkg.create_lod_tensor(a, [ls], None)
    return {
        "words": ragged(rng.randint(0, DICT, size=(n, 1)).astype(np.int64)),
        "x": ragged(rng.randn(n, 6).astype(np.float32)),
        "y": ragged(rng.randn(n, 1).astype(np.float32), [4, 6]),
        "padded": rng.randn(3, 5, 6).astype(np.float32),
        "plen": np.array([[2], [5], [0]], np.int64),
        "offset": np.array([[0], [1], [1]], np.int64),
        "length": np.array([[2], [3], [1]], np.int64),
        "img": rng.randn(3, 4, 3, 3).astype(np.float32)}


def test_flat_layers_build_the_jax_program_and_train_alike():
    """The layers' program is the JAX package's op for op, with its
    build-time shapes; two SGD steps from the JAX startup scope agree
    on every fetch (ragged ones with their lengths) and every
    parameter."""
    built = build_both(_flat_layers)
    (jm, _, jout), (tm, _, tout) = built["jax"], built["torch"]
    assert program_ops(tm) == program_ops(jm)
    assert_same_vars(tm, jm)
    types_ = {op.type for op in tm.global_block().ops}
    assert {"sequence_reverse", "sequence_concat", "sequence_enumerate",
            "sequence_reshape", "sequence_length", "sequence_mask",
            "sequence_slice", "sequence_unpad", "sequence_expand_as",
            "sequence_scatter", "lod_reset", "row_conv", "lrn"} <= types_
    pair = Pair(built)
    names = [v.name for v in tout]
    for step in range(2):
        with jfluid.scope_guard(pair.jscope), \
                tfluid.scope_guard(pair.tscope):
            jr = pair.jexe.run(pair.jmain, feed=_flat_feed(jfluid, step),
                               fetch_list=names, return_numpy=False)
            tr = pair.texe.run(pair.tmain, feed=_flat_feed(tfluid, step),
                               fetch_list=names, return_numpy=False)
        for n, j, t in zip(names, jr, tr):
            np.testing.assert_allclose(np.asarray(t), np.asarray(j),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg="step %d %s" % (step, n))
            assert _lengths(t) == _lengths(j), n
    pair.assert_state_close(rtol=RTOL)


def _lengths(v):
    """A fetched LoDTensor's lengths as lists of ints ([] for a dense
    fetch)."""
    if not hasattr(v, "recursive_sequence_lengths"):
        return []
    return [[int(n) for n in level]
            for level in v.recursive_sequence_lengths()]


def test_sequence_mask_reads_its_width_on_the_host():
    """maxlen None: the mask is as wide as the longest length fed, in both
    packages' Executors."""
    def prog(pkg, main):
        lens = pkg.layers.data("lens", shape=[1], dtype="int64")
        return pkg.layers.sequence_mask(lens, dtype="float32")
    built = build_both(prog)
    (jm, _, jy), (tm, _, ty) = built["jax"], built["torch"]
    for lens in ([[2], [7], [0]], [[1], [3], [4]]):
        feed = {"lens": np.array(lens, np.int64)}
        j = jfluid.Executor(jfluid.CPUPlace()).run(jm, feed=feed,
                                                   fetch_list=[jy])
        t = tfluid.Executor(tfluid.CPUPlace()).run(tm, feed=feed,
                                                   fetch_list=[ty])
        assert np.asarray(t[0]).shape == (3, 1, max(lens)[0])
        np.testing.assert_array_equal(np.asarray(t[0]), np.asarray(j[0]))


def test_sequence_mask_build_shape_is_the_jax_packages():
    """[.., maxlen] at build time, -1 for a width read at run time."""
    def prog(pkg, main):
        lens = pkg.layers.data("lens", shape=[1], dtype="int64")
        return (pkg.layers.sequence_mask(lens, maxlen=6),
                pkg.layers.sequence_mask(lens))
    built = build_both(prog)
    (_, _, jys), (_, _, tys) = built["jax"], built["torch"]
    assert [tuple(y.shape) for y in tys] == [(-1, 1, 6), (-1, 1, -1)]
    assert [tuple(y.shape) for y in tys] == [tuple(y.shape) for y in jys]
