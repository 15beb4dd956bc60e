"""The seq2seq machine-translation model (models/machine_translation.py):
paddle_tpu_torch against paddle_tpu on the CPU at widths of 16.

  * Training (bi-LSTM encoder, attention LSTM decoder through DynamicRNN,
    cross-entropy, Adam) and generation (dense beam search) build the
    JAX package's programs op for op, with the same parameter names and
    shapes; the training and generation parameter sets share every
    decoder parameter by name and shape.
  * Three Adam steps from one JAX startup scope carried across: the
    losses agree at rtol 1e-5 and every parameter at rtol 1e-5 of its
    largest magnitude.  The target and label lengths are equal, as in
    the reference's wmt14 reader.
  * Thirty steps on one batch: the loss falls below 0.7 of its start, as
    tests/test_machine_translation.py asks of the JAX package.
  * Generation from one scope: the sentences (ids and lengths) are
    identical to the JAX package's and the scores agree at rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.models import machine_translation as jmt
from paddle_tpu_torch.fluid.executor import as_numpy
from paddle_tpu_torch.models import machine_translation as tmt

PKGS = {"jax": (jfluid, jmt), "torch": (tfluid, tmt)}
DICT = 30


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(x):
    return as_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _build(fluid, mod, generating, lr=0.01):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = mod.seq_to_seq_net(16, 16, 16, DICT, DICT,
                                 is_generating=generating, beam_size=3,
                                 max_length=5)
        if not generating:
            fluid.optimizer.Adam(learning_rate=lr).minimize(out[0])
    return main, startup, out


def _feed(fluid, step, src=(3, 5, 2), trg=(4, 2, 6)):
    """Source, target and label sequences; the label's lengths are the
    target's (the reference's wmt14 reader shifts one by one token)."""
    rng = np.random.RandomState(step)
    out = {}
    for name, lens in (("source_sequence", src), ("target_sequence", trg),
                       ("label_sequence", trg)):
        rows = rng.randint(1, DICT, (sum(lens), 1)).astype(np.int64)
        out[name] = fluid.create_lod_tensor(rows, [list(lens)], None)
    return out


def _ops(program):
    return [(op.type, op.inputs, op.outputs)
            for blk in program.blocks for op in blk.ops]


@pytest.mark.parametrize("generating", [False, True])
def test_programs_match_jax(generating):
    (jm, js, _), (tm, ts, _) = [_build(f, m, generating)
                                for f, m in PKGS.values()]
    assert _ops(tm) == _ops(jm)
    assert _ops(ts) == _ops(js)
    assert {p.name: tuple(p.shape) for p in tm.all_parameters()} == \
        {p.name: tuple(p.shape) for p in jm.all_parameters()}


def test_train_and_generation_share_parameters():
    train = {p.name: tuple(p.shape)
             for p in _build(tfluid, tmt, False)[0].all_parameters()}
    gen = {p.name: tuple(p.shape)
           for p in _build(tfluid, tmt, True)[0].all_parameters()}
    shared = set(train) & set(gen)
    assert set(gen) <= set(train)
    for needle in ("decoder_lstm_g0_w0", "decoder_lstm_g3_b",
                   "decoder_out_w", "decoder_out_b", "att_score_w",
                   "att_state_w", "trg_emb"):
        assert needle in shared, needle
    for name in shared:
        assert train[name] == gen[name], name


def _jax_start(startup):
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
    return exe, scope


def test_three_adam_steps_match_jax():
    jm, js, (jcost, _, _) = _build(jfluid, jmt, False)
    tm, _, (tcost, _, _) = _build(tfluid, tmt, False)
    jexe, jscope = _jax_start(js)
    init = {n: np.asarray(jscope.get(n)) for n in jscope.keys()}
    tscope = tfluid.scope_from_jax(init, tfluid.Scope(), tfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    losses = {"jax": [], "torch": []}
    for step in range(3):
        (jl,) = jexe.run(jm, feed=_feed(jfluid, step), fetch_list=[jcost],
                         scope=jscope)
        (tl,) = texe.run(tm, feed=_feed(tfluid, step), fetch_list=[tcost],
                         scope=tscope)
        losses["jax"].append(float(np.asarray(jl).ravel()[0]))
        losses["torch"].append(float(_np(tl).ravel()[0]))
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=1e-5)
    params = [p.name for p in tm.all_parameters()]
    assert len(params) == len(jm.all_parameters()) == 26
    for n in params:
        want = np.asarray(jscope.get(n)).astype(np.float64)
        got = _np(tscope.get(n)).astype(np.float64)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=n)
        assert not np.array_equal(got, init[n]), n


def test_loss_falls_over_thirty_steps():
    jm, js, _ = _build(jfluid, jmt, False)
    tm, _, (tcost, _, _) = _build(tfluid, tmt, False)
    _, jscope = _jax_start(js)
    tscope = tfluid.scope_from_jax(
        {n: np.asarray(jscope.get(n)) for n in jscope.keys()},
        tfluid.Scope(), tfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    feed = _feed(tfluid, 0, src=(3, 4), trg=(4, 3))
    losses = []
    for _ in range(30):
        (l,) = texe.run(tm, feed=feed, fetch_list=[tcost], scope=tscope)
        losses.append(float(_np(l).ravel()[0]))
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.7 * losses[0], (losses[0], losses[-1])


def test_generation_matches_jax_from_one_scope():
    built = {name: _build(f, m, True) for name, (f, m) in PKGS.items()}
    jm, js, (jids, jscores, _) = built["jax"]
    tm, _, (tids, tscores, _) = built["torch"]
    _, jscope = _jax_start(js)
    # larger weights than the initializers' so the beams part ways
    rng = np.random.RandomState(5)
    state = {}
    for n in jscope.keys():
        v = np.asarray(jscope.get(n))
        state[n] = (rng.randn(*v.shape) * 0.5).astype(v.dtype)
        jscope.set(n, state[n])
    tscope = tfluid.scope_from_jax(state, tfluid.Scope(), tfluid.CPUPlace())
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    src_rng = np.random.RandomState(1)
    lens = [3, 2, 4]
    rows = src_rng.randint(1, DICT, (sum(lens), 1)).astype(np.int64)
    ji, js_ = jexe.run(jm, feed={"source_sequence": jfluid.create_lod_tensor(
        rows, [lens], None)}, fetch_list=[jids, jscores], scope=jscope,
        return_numpy=False)
    ti, ts_ = texe.run(tm, feed={"source_sequence": tfluid.create_lod_tensor(
        rows, [lens], None)}, fetch_list=[tids, tscores], scope=tscope,
        return_numpy=False)
    assert isinstance(ti, tfluid.LoDTensor)
    assert ti.recursive_sequence_lengths() == ji.recursive_sequence_lengths()
    assert len(ti.recursive_sequence_lengths()[0]) == 3 * 3
    np.testing.assert_array_equal(np.asarray(ti).ravel(),
                                  np.asarray(ji).ravel())
    scores = _np(ts_).ravel()
    np.testing.assert_allclose(scores, np.asarray(js_).ravel(), rtol=1e-5)
    for b in range(3):   # each source's beams ranked best first
        assert scores[3 * b] >= scores[3 * b + 1] >= scores[3 * b + 2]
