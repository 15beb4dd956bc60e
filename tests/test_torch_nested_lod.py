"""Nested (2-level) LoD in paddle_tpu_torch against paddle_tpu on the CPU:
the Fluid cases of tests/test_nested_lod.py in both packages (a nested
feed through a compute op and back with both levels, the kmax_seq_score
-> sub_nested_seq selection with a compute op before it, a trailing
empty outer group, -1 padding of unfilled slots, sequence_expand's
general counts from a nested Y), nested_to_outer's gradient into an
upstream fc and embedding (a hierarchical document encoder, one SGD
step), the selection program at small sizes, DataFeeder at lod_level 2,
and the ParallelExecutor's rule in a 2-rank gloo world: a nested feed
or a nested op raises when the executor is built.  Values agree to 1e-5
of each array's largest magnitude (fp32 sums in other orders); LoDs and
indices are equal.  The `cuda` case runs the document encoder on the
card against the CPU.

Run as a script, this file is one rank of that world (parallel.mesh.
launch starts it)."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_nested_cases as nc  # noqa: E402

TOL = 1e-5
WORLD = 2
SPAWN_TIMEOUT_S = 300


def _spread(a, b):
    """max |a - b| over max |a| (1 for an all-zero a)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1.0)) \
        if a.size else 0.0


def _nested_feed(fluid):
    """2 outer groups of 2 and 3 inner sequences (lengths 2, 1 | 1, 3, 2),
    value = 10 * inner index + position."""
    lens = [2, 1, 1, 3, 2]
    rows = [[10.0 * i + p] for i, n in enumerate(lens) for p in range(n)]
    t = fluid.LoDTensor(np.asarray(rows, np.float32))
    t.set_recursive_sequence_lengths([[2, 3], lens])
    return t, lens


def _scores(fluid, lens, per_seq):
    t = fluid.LoDTensor(np.asarray([[s] for n, s in zip(lens, per_seq)
                                    for _ in range(n)], np.float32))
    t.set_recursive_sequence_lengths([[2, 3], lens])
    return t


def _both(build, feed):
    """{pkg: fetched list} of build(fluid) -> fetch vars, run on the CPU
    with feed(fluid)."""
    import paddle_tpu.fluid as jfluid
    import paddle_tpu_torch.fluid as tfluid
    out = {}
    for name, fluid in (("jax", jfluid), ("torch", tfluid)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            fetch = build(fluid)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            out[name] = exe.run(main, feed=feed(fluid), fetch_list=fetch)
    return out


def _assert_lod_equal(a, b):
    assert type(a).__name__ == type(b).__name__ == "LoDTensor"
    assert a.recursive_sequence_lengths() == b.recursive_sequence_lengths()
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=TOL,
                               atol=TOL)


def test_nested_feed_round_trip():
    def build(fluid):
        x = fluid.layers.data("x", shape=[1], dtype="float32", lod_level=2)
        return [fluid.layers.scale(x, scale=2.0)]

    out = _both(build, lambda f: {"x": _nested_feed(f)[0]})
    _assert_lod_equal(out["jax"][0], out["torch"][0])
    assert out["torch"][0].recursive_sequence_lengths() == \
        [[2, 3], [2, 1, 1, 3, 2]]


@pytest.mark.parametrize("through_compute", [False, True],
                         ids=["direct", "after_scale"])
def test_kmax_then_sub_nested_seq(through_compute):
    """The top inner sequence of each group by its first score: inner
    sequences 1 and 4 (rows [10] and [40, 41]); with a scale op before
    the selection the companions cross it."""
    def build(fluid):
        L = fluid.layers
        x = L.data("x", shape=[1], dtype="float32", lod_level=2)
        s = L.data("s", shape=[1], dtype="float32", lod_level=2)
        if through_compute:
            x, s = L.scale(x, scale=1.0), L.scale(s, scale=2.0)
            assert s.lod_level == 2
        idx = nc.kmax_seq_score(fluid, s, 1)
        return [nc.sub_nested_seq(fluid, x, idx), idx]

    def feed(fluid):
        t, lens = _nested_feed(fluid)
        return {"x": t, "s": _scores(fluid, lens,
                                     [0.1, 0.9, 0.5, 0.2, 0.8])}

    out = _both(build, feed)
    _assert_lod_equal(out["jax"][0], out["torch"][0])
    assert out["torch"][0].recursive_sequence_lengths() == [[1, 1], [1, 2]]
    np.testing.assert_allclose(np.asarray(out["torch"][0]).ravel(),
                               [10.0, 40.0, 41.0])
    np.testing.assert_array_equal(out["torch"][1], out["jax"][1])


def test_trailing_empty_outer_group_survives():
    def build(fluid):
        x = fluid.layers.data("x", shape=[1], dtype="float32", lod_level=2)
        return [fluid.layers.scale(x, scale=1.0)]

    def feed(fluid):
        t = fluid.LoDTensor(np.asarray([[1.0], [2.0]], np.float32))
        t.set_recursive_sequence_lengths([[2, 0], [1, 1]])
        return {"x": t}

    out = _both(build, feed)
    _assert_lod_equal(out["jax"][0], out["torch"][0])
    assert out["torch"][0].recursive_sequence_lengths() == [[2, 0], [1, 1]]


def test_kmax_pads_unfilled_slots_with_minus_one():
    """beam 3 over groups of 2 and 3 inner sequences: the first group's
    third slot is -1, and sub_nested_seq skips it."""
    def build(fluid):
        L = fluid.layers
        x = L.data("x", shape=[1], dtype="float32", lod_level=2)
        s = L.data("s", shape=[1], dtype="float32", lod_level=2)
        idx = nc.kmax_seq_score(fluid, s, 3)
        return [idx, nc.sub_nested_seq(fluid, x, idx)]

    def feed(fluid):
        t, lens = _nested_feed(fluid)
        return {"x": t, "s": _scores(fluid, lens,
                                     [0.3, 0.7, 0.5, 0.2, 0.8])}

    out = _both(build, feed)
    np.testing.assert_array_equal(out["torch"][0], out["jax"][0])
    np.testing.assert_array_equal(out["torch"][0], [[1, 0, -1], [2, 0, 1]])
    _assert_lod_equal(out["jax"][1], out["torch"][1])
    assert out["torch"][1].recursive_sequence_lengths()[0] == [2, 3]


def test_kmax_seq_score_flat_pads_as_jax():
    """The flat form: the top scores of each sequence's real prefix, the
    slots past its length -1."""
    def build(fluid):
        s = fluid.layers.data("s", shape=[1], dtype="float32", lod_level=1)
        return [nc.kmax_seq_score(fluid, s, 4)]

    rng = np.random.RandomState(5)
    vals = rng.randn(9, 1).astype(np.float32)
    out = _both(build, lambda f: {"s": f.create_lod_tensor(vals, [[2, 5, 2]],
                                                           None)})
    np.testing.assert_array_equal(out["torch"][0], out["jax"][0])
    assert (out["torch"][0][0, 2:] == -1).all()


def _expand_case():
    x = np.array([[[1.0], [2.0]], [[3.0], [0.0]], [[5.0], [6.0]]],
                 np.float32)
    return {"X": x, "Y": np.zeros((6, 2, 1), np.float32),
            "X@LOD_LEN": np.array([2, 1, 2], np.int32),
            "Y@LOD_LEN": np.array([2, 1, 1, 2, 2, 2], np.int32),
            "Y@LOD_SEG": np.array([2, 1, 3], np.int32)}


def _run_op(pkg, op_type, vals, attrs=None):
    """A lowering of either package's registry on one context."""
    from torch_op_cases import case_op
    op = case_op(op_type, attrs or {}, {k: [v] for k, v in vals.items()})
    if pkg == "jax":
        import jax.numpy as jnp
        from paddle_tpu.ops import registry as reg
        ctx = reg.ExecContext(op, {k: [jnp.asarray(v)]
                                   for k, v in vals.items()})
    else:
        from paddle_tpu_torch.ops import registry as reg
        ctx = reg.ExecContext(op, {k: [torch.from_numpy(v)]
                                   for k, v in vals.items()})
    return reg.call_lower(reg.get_op_def(op_type), ctx)


def test_sequence_expand_general_counts():
    """counts 2, 1, 3: 6 rows, X's own lengths repeated."""
    j = _run_op("jax", "sequence_expand", _expand_case())
    t = _run_op("torch", "sequence_expand", _expand_case())
    for k in ("Out", "Out@LOD_LEN"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
    np.testing.assert_array_equal(t["Out@LOD_LEN"].numpy(),
                                  [2, 2, 1, 2, 2, 2])
    bad = dict(_expand_case(), **{"Y@LOD_SEG": np.array([2, 1], np.int32)})
    with pytest.raises(Exception, match="outer counts"):
        _run_op("torch", "sequence_expand", bad)


def test_nested_to_outer_and_its_gradient_match_jax():
    rng = np.random.RandomState(2)
    vals = {"X": rng.randn(5, 4, 3).astype(np.float32),
            "X@LOD_LEN": np.array([4, 1, 2, 3, 1], np.int32),
            "X@LOD_SEG": np.array([2, 0, 3], np.int32)}
    j = _run_op("jax", "nested_to_outer", vals)
    t = _run_op("torch", "nested_to_outer", vals)
    for k in ("Out", "Out@LOD_LEN", "OutLens", "OutLens@LOD_LEN"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
    g = dict(vals, **{"GRAD:Out": rng.randn(3, 3, 4, 3).astype(np.float32)})
    jg = _run_op("jax", "nested_to_outer_grad", g)
    tg = _run_op("torch", "nested_to_outer_grad", g)
    np.testing.assert_array_equal(tg["GRAD:X"].numpy(),
                                  np.asarray(jg["GRAD:X"]))


def _encoder_step(fluid, init, feed, vocab, emb, hid):
    """One SGD step of the document encoder from the startup state `init`
    (None: run the startup program): the startup state, the loss with
    every parameter's gradient, and the parameters after."""
    main, startup, loss = nc.doc_encoder_program(fluid, vocab, emb, hid)
    params = [p.name for p in main.all_parameters()]
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    if init is None:
        with fluid.scope_guard(scope):
            exe.run(startup)
        before = {n: np.array(scope.get(n)) for n in scope.keys()}
    else:
        scope = fluid.scope_from_jax(init, scope, fluid.CPUPlace())
        before = init
    with fluid.scope_guard(scope):
        out = exe.run(main, feed=feed, fetch_list=[loss] + [
            p + "@GRAD" for p in params])
        after = {n: np.array(scope.get(n)) for n in params}
    return before, dict(zip(["loss"] + params, out)), after


def test_doc_encoder_gradient_crosses_nested_to_outer_as_jax():
    """The embedding's and the upstream fc's gradients reach them through
    nested_to_outer_grad; loss, gradients and the updated parameters
    agree with the JAX package's from one startup state."""
    import paddle_tpu.fluid as jfluid
    import paddle_tpu_torch.fluid as tfluid
    vocab, emb, hid = 60, 8, 6
    feed_j = nc.doc_batch(jfluid, np.random.RandomState(4), 5, (1, 4),
                          (1, 6), vocab)
    feed_t = nc.doc_batch(tfluid, np.random.RandomState(4), 5, (1, 4),
                          (1, 6), vocab)
    init, jout, jafter = _encoder_step(jfluid, None, feed_j, vocab, emb,
                                       hid)
    _, tout, tafter = _encoder_step(tfluid, init, feed_t, vocab, emb, hid)
    for k, want in jout.items():
        assert _spread(want, tout[k]) <= TOL, k
    emb_grad = np.asarray(tout["embedding_0.w_0"])
    assert np.abs(emb_grad).max() > 0
    for k, want in jafter.items():
        assert _spread(want, tafter[k]) <= TOL, k


def test_selection_program_matches_jax():
    import paddle_tpu.fluid as jfluid
    import paddle_tpu_torch.fluid as tfluid
    out = {}
    init = None
    for name, fluid in (("jax", jfluid), ("torch", tfluid)):
        main, startup, fetch = nc.selection_program(fluid, 40, 6, 2)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        if init is None:
            with fluid.scope_guard(scope):
                exe.run(startup)
            init = {n: np.asarray(scope.get(n)) for n in scope.keys()}
        else:
            scope = fluid.scope_from_jax(init, scope, fluid.CPUPlace())
        with fluid.scope_guard(scope):
            feed = nc.doc_batch(fluid, np.random.RandomState(8), 4, (1, 5),
                                (2, 7), 40, titled=True)
            feed.pop("label")
            out[name] = exe.run(main, feed=feed, fetch_list=fetch)
    for a, b in zip(out["jax"], out["torch"]):
        _assert_lod_equal(a, b)


def test_data_feeder_level_two_matches_jax():
    import paddle_tpu.fluid as jfluid
    import paddle_tpu_torch.fluid as tfluid
    samples = [([[1, 2], [3]], 0), ([[4], [5, 6, 7], [8]], 1), ([], 0)]
    feeds = {}
    for name, fluid in (("jax", jfluid), ("torch", tfluid)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            w = fluid.layers.data("w", shape=[1], dtype="int64",
                                  lod_level=2)
            y = fluid.layers.data("y", shape=[1], dtype="int64")
        feeds[name] = fluid.DataFeeder([w, y], fluid.CPUPlace()).feed(
            samples)
    j, t = feeds["jax"], feeds["torch"]
    assert t["w"].lod() == j["w"].lod() == [[0, 2, 5, 5],
                                            [0, 2, 3, 4, 7, 8]]
    np.testing.assert_array_equal(np.asarray(t["w"]), np.asarray(j["w"]))
    np.testing.assert_array_equal(t["y"], j["y"])


# ---------------------------------------------------------------------------
# the ParallelExecutor in a 2-rank gloo world
# ---------------------------------------------------------------------------

def _pe_programs(fluid):
    """{lane: (main, loss)}: a lod_level-2 feed; a nested op
    (nested_to_outer) on a flat ragged feed, which raises for the op
    alone; and a flat ragged program, which builds."""
    out = {}
    for lane in ("nested_feed", "nested_op", "flat"):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            L = fluid.layers
            x = L.data("x", shape=[4], dtype="float32",
                       lod_level=2 if lane == "nested_feed" else 1)
            h = L.fc(x, size=3)
            if lane == "nested_op":
                h, _ = nc.nested_to_outer(fluid, h)
            loss = L.mean(h)
            fluid.optimizer.SGD(0.1).minimize(loss)
        out[lane] = (main, loss)
    return out


def _rank_main(workdir):
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.parallel import mesh
    torch.set_num_threads(1)
    tid = int(os.environ["PADDLE_TRAINER_ID"])
    world = int(os.environ["PADDLE_TRAINERS"])
    mesh.init_collective(os.environ["PADDLE_COORDINATOR"], world, tid,
                         device_type="cpu")
    out = {}
    for lane, (main, loss) in _pe_programs(fluid).items():
        try:
            fluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                   main_program=main, num_trainers=world,
                                   trainer_id=tid, scope=fluid.Scope())
            out[lane] = np.asarray("")
        except NotImplementedError as e:
            out[lane] = np.asarray(str(e))
    np.savez(os.path.join(workdir, "rank%d.npz" % tid), **out)
    return 0


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from paddle_tpu_torch.parallel import mesh
    workdir = str(tmp_path_factory.mktemp("nested_pe"))
    results = mesh.launch([os.path.abspath(__file__), workdir], WORLD,
                          use_cuda=False, capture=True,
                          timeout=SPAWN_TIMEOUT_S)
    for rank, (rc, _, err) in enumerate(results):
        assert rc == 0, "rank %d failed:\n%s" % (rank, err[-4000:])
    ranks = []
    for rank in range(WORLD):
        with np.load(os.path.join(workdir, "rank%d.npz" % rank)) as z:
            ranks.append({k: str(z[k]) for k in z.files})
    return ranks


@pytest.mark.parametrize("lane,words", [
    ("nested_feed", ("feed 'x'", "lod_level 2")),
    ("nested_op", ("nested_to_outer", "outer groups"))])
def test_parallel_executor_raises_for_nested_at_construction(world, lane,
                                                             words):
    for rank in world:
        assert all(w in rank[lane] for w in words), rank[lane]


def test_parallel_executor_builds_a_flat_ragged_program(world):
    for rank in world:
        assert rank["flat"] == ""


@pytest.mark.cuda
def test_cuda_doc_encoder_matches_cpu():
    """The encoder's step on the card against the CPU from one startup
    state: the loss and every gradient within 1e-6 of its largest
    magnitude."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import paddle_tpu_torch.fluid as tfluid
    vocab, emb, hid = 300, 16, 12
    main, startup, loss = nc.doc_encoder_program(tfluid, vocab, emb, hid)
    grads = [p.name + "@GRAD" for p in main.all_parameters()]
    init_scope = tfluid.Scope()
    with tfluid.scope_guard(init_scope):
        tfluid.Executor(tfluid.CPUPlace()).run(startup)
    init = {n: init_scope.get(n).numpy() for n in init_scope.keys()}
    res = {}
    for name, place in (("cpu", tfluid.CPUPlace()),
                        ("gpu", tfluid.CUDAPlace(0))):
        scope = tfluid.scope_from_jax(init, tfluid.Scope(), place)
        feed = nc.doc_batch(tfluid, np.random.RandomState(3), 8, (2, 6),
                            (2, 12), vocab)
        res[name] = tfluid.Executor(place).run(
            main, feed=feed, fetch_list=[loss] + grads, scope=scope)
    for a, b in zip(res["cpu"], res["gpu"]):
        assert _spread(a, b) <= 1e-6


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.exit(_rank_main(sys.argv[1]))
