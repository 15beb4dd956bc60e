"""LoD (ragged) tensors in paddle_tpu_torch against paddle_tpu on the CPU:
the LoDTensor API, pad_lod_feed's bucketing and its invalid-LoD raise,
the DataFeeder, and the Executor's ragged feeds and fetches (a LoDTensor
in, the padded tensor plus `@LOD_LEN` lengths inside, a packed LoDTensor
out) through a program with an embedding, an fc, a dynamic LSTM and a
sequence pool, from one startup scope carried across.  Values agree to
rtol 1e-5 (fp32 sums in other orders); lengths and LoDs are equal.  The
`cuda` case holds the same program on the card against the CPU."""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.fluid import lod as jlod
from paddle_tpu.fluid.data_feeder import DataFeeder as JDataFeeder
from paddle_tpu_torch.fluid import lod as tlod

RTOL = 1e-5


def _both(fn):
    return fn(jlod), fn(tlod)


def test_lod_tensor_api_matches_jax():
    rows = np.arange(12, dtype=np.float32).reshape(6, 2)
    for mod in (jlod, tlod):
        t = mod.LoDTensor(rows)
        assert t.lod() == [] and t.has_valid_recursive_sequence_lengths()
        t.set_recursive_sequence_lengths([[2, 3, 1]])
        assert t.lod() == [[0, 2, 5, 6]]
        assert t.recursive_sequence_lengths() == [[2, 3, 1]]
        assert t.has_valid_recursive_sequence_lengths()
        t.set_lod([[0, 1, 6]])
        assert t.recursive_sequence_lengths() == [[1, 5]]
        assert t.shape() == [6, 2]
        np.testing.assert_array_equal(np.asarray(t), rows)
        t.set_lod([[0, 2, 5]])
        assert not t.has_valid_recursive_sequence_lengths()
    assert tlod.recursive_seq_lens_to_lod([[2, 3], [1, 2, 1, 2, 2]]) == \
        jlod.recursive_seq_lens_to_lod([[2, 3], [1, 2, 1, 2, 2]])
    assert tlod.lod_to_recursive_seq_lens([[0, 2, 5], [0, 1, 3, 4, 6, 8]]) \
        == jlod.lod_to_recursive_seq_lens([[0, 2, 5], [0, 1, 3, 4, 6, 8]])
    # from per-sequence row lists and from packed rows
    seqs = [np.ones((2, 3)), np.zeros((1, 3)), np.full((4, 3), 2.0)]
    j, t = _both(lambda m: m.create_lod_tensor(seqs, [[2, 1, 4]], None))
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
    assert t.lod() == j.lod() == [[0, 2, 3, 7]]
    with pytest.raises(ValueError):
        tlod.create_lod_tensor(rows, [[2, 2]], None)
    np.random.seed(3)
    r = tfluid.create_random_int_lodtensor([[3, 1, 2]], [1], None, 4, 9)
    assert r.shape() == [6, 1] and r.lod() == [[0, 3, 4, 6]]
    assert np.asarray(r).dtype == np.int64
    assert (np.asarray(r) >= 4).all() and (np.asarray(r) <= 9).all()
    assert tfluid.LoDTensor is tlod.LoDTensor
    assert tfluid.create_lod_tensor is tlod.create_lod_tensor


@pytest.mark.parametrize("lengths", [[1], [3, 7, 1, 5], [16, 2], [17],
                                     [33, 0, 8], [100, 64]],
                         ids=lambda x: "-".join(map(str, x)))
def test_pad_lod_feed_buckets_as_jax(lengths):
    """T is the next power of two >= the longest sequence, at least 16;
    rows past each length are zero; the lengths are int32."""
    rng = np.random.RandomState(len(lengths))
    rows = rng.randn(sum(lengths), 3).astype(np.float32)
    jt, tt = _both(lambda m: m.create_lod_tensor(rows, [lengths], None))
    jp, jl, js = jlod.pad_lod_feed(jt)
    tp, tl, ts = tlod.pad_lod_feed(tt)
    assert tp.shape == jp.shape and tp.dtype == jp.dtype
    assert tp.shape[1] == max(16, 1 << max(0, max(lengths) - 1)
                              .bit_length())
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tl, jl)
    assert tl.dtype == np.int32 and ts is None and js is None
    back = tlod.unpad_to_lod_tensor(tp, tl)
    np.testing.assert_array_equal(np.asarray(back), rows)
    assert back.recursive_sequence_lengths() == [lengths]


def test_pad_lod_feed_nested_counts_as_jax():
    rows = np.arange(14, dtype=np.int64).reshape(7, 2)
    lens = [[2, 0, 1], [3, 1, 3]]
    jt, tt = _both(lambda m: m.create_lod_tensor(rows, lens, None))
    jp, jl, js = jlod.pad_lod_feed(jt)
    tp, tl, ts = tlod.pad_lod_feed(tt)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(ts, js)


@pytest.mark.parametrize("lod", [[[3, 4]], [[0, 3, 2, 7]], [[1, 3, 7]],
                                 [[0, 3, 6]], [[0, 3], [0, 3, 7]]],
                         ids=["lengths", "not_monotone", "not_from_0",
                              "short", "nested_mismatch"])
def test_invalid_lod_raises_as_jax(lod):
    """The reference's CheckLoD: a lengths list passed as offsets (and
    every other broken level) raises the JAX package's ValueError."""
    rows = np.zeros((7, 1), np.float32)
    msgs = []
    for mod in (jlod, tlod):
        t = mod.LoDTensor(rows)
        t.set_lod(lod)
        with pytest.raises(ValueError) as e:
            mod.pad_lod_feed(t)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_data_feeder_matches_jax():
    """Dense and ragged columns of reader samples into feeds."""
    def build(pkg):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            w = pkg.layers.data("words", shape=[1], dtype="int64",
                                lod_level=1)
            img = pkg.layers.data("img", shape=[2, 2], dtype="float32")
            y = pkg.layers.data("label", shape=[1], dtype="int64")
        return [w, img, y], main
    rng = np.random.RandomState(0)
    samples = [([1, 4, 2], rng.randn(4).astype(np.float32), 1),
               ([7], rng.randn(4).astype(np.float32), 0),
               ([3, 3], rng.randn(4).astype(np.float32), 1)]
    jvars, jm = build(jfluid)
    tvars, tm = build(tfluid)
    jf = JDataFeeder(jvars, jfluid.CPUPlace(), program=jm).feed(samples)
    tf = tfluid.DataFeeder(tvars, tfluid.CPUPlace(), program=tm).feed(samples)
    assert sorted(jf) == sorted(tf)
    for k in jf:
        np.testing.assert_array_equal(np.asarray(tf[k]), np.asarray(jf[k]))
        assert np.asarray(tf[k]).dtype == np.asarray(jf[k]).dtype
    assert isinstance(tf["words"], tfluid.LoDTensor)
    assert tf["words"].lod() == jf["words"].lod() == [[0, 3, 4, 6]]
    assert tf["img"].shape == (3, 2, 2)


def test_nested_lod_is_not_ported():
    """Two LoD levels are ported (tests/test_torch_nested_lod.py); a feed
    of three is not: the runtime carries inner lengths and outer counts
    only, so it raises rather than drop a level."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[1], lod_level=2)
        out = tfluid.layers.scale(x, 2.0)
    deep = tfluid.create_lod_tensor(np.ones((3, 1), np.float32),
                                    [[1], [1, 1], [2, 1]], None)
    with pytest.raises(NotImplementedError, match="two LoD levels"):
        tfluid.Executor(tfluid.CPUPlace()).run(
            main, feed={"x": deep}, fetch_list=[out],
            scope=tfluid.Scope())


# ---------------------------------------------------------------------------
# the Executor's ragged feeds and fetches
# ---------------------------------------------------------------------------

def _ragged_program(pkg):
    """words (ragged ids) -> embedding -> fc tanh -> dynamic_lstm ->
    max pool -> fc -> mean; Adam.  Returns (main, startup, fetches)."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        words = pkg.layers.data("words", shape=[1], dtype="int64",
                                lod_level=1)
        feat = pkg.layers.data("feat", shape=[3], dtype="float32",
                               lod_level=1)
        emb = pkg.layers.embedding(words, size=[20, 5])
        proj = pkg.layers.fc([emb, feat], size=8, act="tanh")
        hidden, cell = pkg.layers.dynamic_lstm(proj, size=8)
        pooled = pkg.layers.sequence_pool(hidden, "max")
        logit = pkg.layers.fc(pooled, size=1)
        loss = pkg.layers.mean(logit)
        pkg.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, [loss, proj, hidden, cell, pooled]


def _ragged_feed(mod, seed=0, lengths=(3, 7, 1, 5)):
    rng = np.random.RandomState(seed)
    n = sum(lengths)
    words = mod.create_lod_tensor(
        rng.randint(0, 20, size=(n, 1)).astype(np.int64), [list(lengths)],
        None)
    feat = mod.create_lod_tensor(rng.randn(n, 3).astype(np.float32),
                                 [list(lengths)], None)
    return {"words": words, "feat": feat}


def _init_state(jstartup):
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup)
    return jexe, jscope, {n: np.asarray(jscope.get(n))
                          for n in jscope.keys()}


@pytest.mark.parametrize("return_numpy", [True, False])
def test_executor_ragged_feed_and_fetch_match_jax(return_numpy):
    """Two Adam steps: the loss equals the JAX Executor's, and each ragged
    fetch comes back as a packed LoDTensor with the feed's lengths (the
    pool, reduced over time, as a dense array), whatever return_numpy
    says."""
    jm, js, jfetch = _ragged_program(jfluid)
    tm, _, tfetch = _ragged_program(tfluid)
    assert [v.lod_level for v in tfetch] == [v.lod_level for v in jfetch]
    jexe, jscope, init = _init_state(js)
    tscope = tfluid.scope_from_jax(init, tfluid.Scope(), tfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    for step in range(2):
        jr = jexe.run(jm, feed=_ragged_feed(jlod, step),
                      fetch_list=jfetch, scope=jscope)
        tr = texe.run(tm, feed=_ragged_feed(tlod, step),
                      fetch_list=tfetch, scope=tscope,
                      return_numpy=return_numpy)
        for name, j, t in zip([v.name for v in tfetch], jr, tr):
            assert isinstance(t, tfluid.LoDTensor) == \
                isinstance(j, jlod.LoDTensor), name
            if isinstance(t, tfluid.LoDTensor):
                assert t.lod() == j.lod() == [[0, 3, 10, 11, 16]], name
            elif not return_numpy:
                t = t.numpy()
            np.testing.assert_allclose(np.asarray(t), np.asarray(j),
                                       rtol=RTOL, atol=RTOL, err_msg=name)
    for n in init:
        np.testing.assert_allclose(tscope.get(n).numpy(),
                                   np.asarray(jscope.get(n)), rtol=RTOL,
                                   atol=RTOL, err_msg=n)


@pytest.mark.parametrize("ad", ["whole_graph", "remat_nothing", "run_loop"])
def test_ragged_program_paths_agree_with_per_op(ad):
    """The whole-graph step, its remat and run_loop thread the lengths as
    the per-op step does: equal fetches, LoDs and state, bit for bit."""
    from paddle_tpu_torch.flags import FLAGS
    tm, ts, tfetch = _ragged_program(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scopes = [tfluid.Scope(), tfluid.Scope()]
    with tfluid.scope_guard(scopes[0]):
        exe.run(ts)
    for n in scopes[0].keys():
        scopes[1].set(n, scopes[0].get(n).clone())
    feed = _ragged_feed(tlod, 1)
    outs = []
    for i, scope in enumerate(scopes):
        e = tfluid.Executor(tfluid.CPUPlace())
        try:
            if i == 1 and ad != "run_loop":
                FLAGS.whole_graph_ad = True
                FLAGS.remat_policy = "nothing" if ad == "remat_nothing" \
                    else ""
            if i == 1 and ad == "run_loop":
                outs.append(e.run_loop(tm, feed=feed, fetch_list=tfetch,
                                       steps=2, scope=scope))
            else:
                for _ in range(2):
                    r = e.run(tm, feed=feed, fetch_list=tfetch, scope=scope)
                outs.append(r)
        finally:
            FLAGS.whole_graph_ad = False
            FLAGS.remat_policy = ""
    for a, b in zip(*outs):
        if isinstance(a, tfluid.LoDTensor):
            assert a.lod() == b.lod()
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for n in scopes[0].keys():
        assert torch.equal(scopes[0].get(n), scopes[1].get(n)), n


@pytest.mark.cuda
def test_cuda_ragged_feed_and_fetch_match_cpu():
    """The ragged program's two steps on the card against the CPU from one
    startup scope: the lengths live on the card, the fetches come back
    as LoDTensors with the feed's LoD, values within rtol 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    tm, ts, tfetch = _ragged_program(tfluid)
    cpu = tfluid.Executor(tfluid.CPUPlace())
    init_scope = tfluid.Scope()
    with tfluid.scope_guard(init_scope):
        cpu.run(ts)
    init = {n: init_scope.get(n).numpy() for n in init_scope.keys()}
    res = {}
    for name, place in (("cpu", tfluid.CPUPlace()),
                        ("gpu", tfluid.CUDAPlace(0))):
        scope = tfluid.scope_from_jax(init, tfluid.Scope(), place)
        exe = tfluid.Executor(place)
        feeds = exe._prepare_feeds(tm, _ragged_feed(tlod, 0))
        assert feeds["words@LOD_LEN"].device.type == (
            "cuda" if name == "gpu" else "cpu")
        res[name] = [exe.run(tm, feed=_ragged_feed(tlod, s),
                             fetch_list=tfetch, scope=scope)
                     for s in range(2)]
    for rc, rg in zip(res["cpu"], res["gpu"]):
        for a, b in zip(rc, rg):
            if isinstance(a, tfluid.LoDTensor):
                assert isinstance(b, tfluid.LoDTensor)
                assert a.lod() == b.lod()
            np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                       rtol=RTOL, atol=RTOL)
