"""The beam-search ops (ops/beam_ops.py): paddle_tpu_torch against
paddle_tpu on the CPU.

  * The hand-checked cases of tests/test_machine_translation.py: one
    expansion with a finished beam, and the backtrack of three steps.
  * `beam_search` on seeded scores with ties and NaNs: the selected ids
    and parents equal the JAX package's (jax.lax.top_k's order: ties to
    the lower index, NaNs by IEEE totalOrder), the scores too.
  * `beam_search_decode` on seeded pointers: the sentences and lengths
    equal, the scores at rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid.executor import as_numpy

PKGS = {"jax": jfluid, "torch": tfluid}


def _np(x):
    return as_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _search_program(fluid, K, W, end_id):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        pre_ids = L.data("pre_ids", shape=[1], dtype="int64")
        pre_scores = L.data("pre_scores", shape=[1], dtype="float32")
        scores = L.data("scores", shape=[K], dtype="float32")
        out = L.beam_search(pre_ids, pre_scores, None, scores,
                            beam_size=W, end_id=end_id,
                            return_parent_idx=True)
    return main, startup, list(out)


def _run(fluid, main, startup, feed, fetch):
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        return exe.run(main, feed=feed, fetch_list=fetch,
                       return_numpy=False)


def test_beam_search_selects_top_candidates():
    """1 source, beam 2, vocab 4: beam 0 unfinished (id 2), beam 1
    finished (id 0 == end_id, score -0.5): the frozen beam -0.5 first,
    then beam 0's -1.5 (id 3)."""
    main, startup, fetch = _search_program(tfluid, 4, 2, 0)
    ids, scores, parent = _run(tfluid, main, startup, {
        "pre_ids": np.array([[2], [0]], np.int64),
        "pre_scores": np.array([[-1.0], [-0.5]], np.float32),
        "scores": np.array([[-9., -2., -3., -1.5],
                            [-9., -9., -9., -9.]], np.float32)}, fetch)
    np.testing.assert_array_equal(_np(ids).reshape(-1), [0, 3])
    np.testing.assert_allclose(_np(scores).reshape(-1), [-0.5, -1.5])
    np.testing.assert_array_equal(_np(parent).reshape(-1), [1, 0])


def _decode_program(fluid, T, BW, end_id):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        i = L.data("i", shape=[T, BW], dtype="int64",
                   append_batch_size=False)
        p = L.data("p", shape=[T, BW], dtype="int32",
                   append_batch_size=False)
        s = L.data("s", shape=[T, BW], dtype="float32",
                   append_batch_size=False)
        out = L.beam_search_decode(i, s, beam_size=2, end_id=end_id,
                                   parent_idx=p)
    return main, startup, list(out)


def test_beam_search_decode_backtracks():
    """Beam 0 at t2: token 8, parent 1 -> t1 token 7, parent 0 -> t0
    token 5; beam 1 at t2: token 1 (end), parent 0 -> t1 token 6 -> 5."""
    main, startup, fetch = _decode_program(tfluid, 3, 2, 1)
    ids, scores = _run(tfluid, main, startup, {
        "i": np.array([[5, 5], [6, 7], [8, 1]], np.int64),
        "p": np.array([[0, 1], [0, 0], [1, 0]], np.int32),
        "s": np.array([[-1, -1], [-2, -2], [-3, -2.5]], np.float32)},
        fetch)
    assert isinstance(ids, tfluid.LoDTensor)
    np.testing.assert_array_equal(np.asarray(ids).reshape(-1),
                                  [5, 7, 8, 5, 6, 1])
    assert ids.recursive_sequence_lengths() == [[3, 3]]
    np.testing.assert_allclose(_np(scores).reshape(-1), [-3.0, -2.5])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_beam_search_matches_jax_with_ties_and_nans(seed):
    B, W, K, end_id = 3, 3, 5, 1
    rng = np.random.RandomState(seed)
    # scores on a coarse grid: many ties inside and across beams
    scores = np.round(rng.randn(B * W, K), 0).astype(np.float32)
    if seed == 2:
        scores[0, 2] = np.nan
        scores[4, :] = np.nan
    pre_ids = rng.randint(0, 4, (B * W, 1)).astype(np.int64)
    pre_scores = np.round(rng.randn(B * W, 1), 0).astype(np.float32)
    feed = {"pre_ids": pre_ids, "pre_scores": pre_scores, "scores": scores}
    got = {}
    for name, fluid in PKGS.items():
        main, startup, fetch = _search_program(fluid, K, W, end_id)
        got[name] = [_np(v) for v in _run(fluid, main, startup, feed,
                                          fetch)]
    (ti, ts, tp), (ji, js, jp) = got["torch"], got["jax"]
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(np.isnan(ts), np.isnan(js))
    np.testing.assert_allclose(ts, js, rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_beam_search_decode_matches_jax(seed):
    T, BW, end_id = 5, 2, 1
    rng = np.random.RandomState(seed)
    feed = {"i": rng.randint(0, 4, (T, BW)).astype(np.int64),
            "p": rng.randint(0, BW, (T, BW)).astype(np.int32),
            "s": rng.randn(T, BW).astype(np.float32)}
    got = {}
    for name, fluid in PKGS.items():
        main, startup, fetch = _decode_program(fluid, T, BW, end_id)
        ids, scores = _run(fluid, main, startup, feed, fetch)
        got[name] = (np.asarray(ids).ravel(),
                     ids.recursive_sequence_lengths(), _np(scores))
    np.testing.assert_array_equal(got["torch"][0], got["jax"][0])
    assert got["torch"][1] == got["jax"][1]
    np.testing.assert_allclose(got["torch"][2], got["jax"][2], rtol=1e-5)
