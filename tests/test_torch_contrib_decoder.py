"""fluid.contrib.decoder (StateCell, TrainingDecoder, BeamSearchDecoder):
paddle_tpu_torch against paddle_tpu on the CPU, the cases of
tests/test_contrib_decoder.py.

  * The TrainingDecoder (a DynamicRNN over the cell) trains the echo task
    from one JAX startup scope carried across: the losses agree to rtol
    1e-5 step by step, and the port's loss falls as the JAX package's.
  * The BeamSearchDecoder generates from the same trained scope: the
    sentences (ids and lengths) are identical and the scores agree to
    rtol 1e-5.
  * The custom `block()` decoder (a While over tensor arrays) and its
    `early_stop()` give the JAX package's sentences.
  * The StateCell's guards raise as the JAX package's do.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid.executor import as_numpy, as_tensor

V, EMB, H, END_ID = 12, 6, 8, 1
PKGS = {"jax": jfluid, "torch": tfluid}


def _np(x):
    return as_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _build_cell(fluid, encoder_last):
    c = fluid.contrib
    cell = c.StateCell(inputs={"x": None},
                       states={"h": c.InitState(init=encoder_last)},
                       out_state="h")

    @cell.state_updater
    def updater(state_cell):
        x = state_cell.get_input("x")
        h = state_cell.get_state("h")
        nh = fluid.layers.fc(
            input=[x, h], size=H, act="tanh", bias_attr=False,
            param_attr=[fluid.ParamAttr(name="cell_x_w"),
                        fluid.ParamAttr(name="cell_h_w")])
        state_cell.set_state("h", nh)

    return cell


def _encoder(fluid, src):
    emb = fluid.layers.embedding(
        src, size=[V, EMB], param_attr=fluid.ParamAttr(name="src_emb"))
    proj = fluid.layers.fc(emb, size=H, act="tanh",
                           param_attr=fluid.ParamAttr(name="enc_w"),
                           bias_attr=False)
    return fluid.layers.sequence_last_step(proj)


def _train_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        src = fluid.layers.data("src", shape=[1], dtype="int64",
                                lod_level=1)
        trg = fluid.layers.data("trg", shape=[1], dtype="int64",
                                lod_level=1)
        lbl = fluid.layers.data("lbl", shape=[1], dtype="int64",
                                lod_level=1)
        cell = _build_cell(fluid, _encoder(fluid, src))
        decoder = fluid.contrib.TrainingDecoder(cell)
        trg_emb = fluid.layers.embedding(
            trg, size=[V, EMB], param_attr=fluid.ParamAttr(name="trg_emb"))
        with decoder.block():
            cur = decoder.step_input(trg_emb)
            decoder.state_cell.compute_state(inputs={"x": cur})
            h = decoder.state_cell.get_state("h")
            out = fluid.layers.fc(
                h, size=V, act="softmax",
                param_attr=fluid.ParamAttr(name="score_w"),
                bias_attr=fluid.ParamAttr(name="score_b"))
            decoder.state_cell.update_states()
            decoder.output(out)
        cost = fluid.layers.mean(fluid.layers.cross_entropy(decoder(), lbl))
        fluid.optimizer.Adam(learning_rate=0.05).minimize(cost)
    return main, startup, cost


def _gen_program(fluid, beam_size=3, max_len=4):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        src = fluid.layers.data("src", shape=[1], dtype="int64",
                                lod_level=1)
        enc_last = _encoder(fluid, src)
        cell = _build_cell(fluid, enc_last)
        init_ids = fluid.layers.fill_constant_batch_size_like(
            input=enc_last, shape=[-1, 1], value=0, dtype="int64")
        init_scores = fluid.layers.fill_constant_batch_size_like(
            input=enc_last, shape=[-1, 1], value=0.0, dtype="float32")
        decoder = fluid.contrib.BeamSearchDecoder(
            state_cell=cell, init_ids=init_ids, init_scores=init_scores,
            target_dict_dim=V, word_dim=EMB, input_var_dict={},
            topk_size=V, sparse_emb=False, max_len=max_len,
            beam_size=beam_size, end_id=END_ID,
            emb_param_attr=fluid.ParamAttr(name="trg_emb"),
            score_param_attr=fluid.ParamAttr(name="score_w"),
            score_bias_attr=fluid.ParamAttr(name="score_b"))
        decoder.decode()
        ids, scores = decoder()
    return main, startup, ids, scores


def _toy_batch(fluid, rng, n=6):
    """The echo task: the target is <s> then the source's last token, the
    label that token then </s>."""
    srcs, trgs, lbls = [], [], []
    for _ in range(n):
        s = rng.randint(2, V, size=int(rng.randint(2, 5)))
        srcs.append(s.reshape(-1, 1).astype(np.int64))
        trgs.append(np.array([[0], [s[-1]]], np.int64))
        lbls.append(np.array([[s[-1]], [END_ID]], np.int64))
    return {k: fluid.create_lod_tensor(np.concatenate(v),
                                       [[len(a) for a in v]], None)
            for k, v in (("src", srcs), ("trg", trgs), ("lbl", lbls))}


def test_training_decoder_trains_and_beam_decoder_generates_like_jax():
    runs = {}
    for name, fluid in PKGS.items():
        main, startup, cost = _train_program(fluid)
        runs[name] = (main, startup, cost, fluid.Executor(fluid.CPUPlace()),
                      fluid.Scope())
    jmain, jstart, jcost, jexe, jscope = runs["jax"]
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
    init = {n: np.asarray(jscope.get(n)) for n in jscope.keys()}
    tmain, _, tcost, texe, _ = runs["torch"]
    tscope = tfluid.scope_from_jax(init, tfluid.Scope(), tfluid.CPUPlace())
    losses = {"jax": [], "torch": []}
    rng = np.random.RandomState(0)
    for _ in range(40):
        state = rng.get_state()
        (jl,) = jexe.run(jmain, feed=_toy_batch(jfluid, rng),
                         fetch_list=[jcost], scope=jscope)
        rng.set_state(state)
        (tl,) = texe.run(tmain, feed=_toy_batch(tfluid, rng),
                         fetch_list=[tcost], scope=tscope)
        losses["jax"].append(float(np.asarray(jl).ravel()[0]))
        losses["torch"].append(float(np.asarray(tl).ravel()[0]))
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=1e-5)
    assert losses["torch"][-1] < 0.5 * losses["torch"][0], losses["torch"]

    # generation from the trained scope, in each package
    trained = {n: np.asarray(jscope.get(n)) for n in
               ["src_emb", "enc_w", "cell_x_w", "cell_h_w", "trg_emb",
                "score_w", "score_b"]}
    for n in trained:
        np.testing.assert_allclose(as_numpy(tscope.get(n)), trained[n],
                                   rtol=1e-5,
                                   atol=1e-5 * np.abs(trained[n]).max())
    out = {}
    gen_rng = np.random.RandomState(7)
    src = _toy_batch(jfluid, gen_rng, n=4)["src"]
    rows, lens = np.asarray(src), src.recursive_sequence_lengths()
    for name, fluid in PKGS.items():
        gmain, gstart, ids_var, scores_var = _gen_program(fluid)
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(gstart)
        for n, v in trained.items():
            scope.set(n, v if fluid is jfluid else as_tensor(v))
        ids, scores = exe.run(
            gmain, feed={"src": fluid.create_lod_tensor(rows, lens, None)},
            fetch_list=[ids_var, scores_var], return_numpy=False,
            scope=scope)
        out[name] = (np.asarray(ids).ravel(),
                     ids.recursive_sequence_lengths(),
                     _np(scores).ravel())
    np.testing.assert_array_equal(out["torch"][0], out["jax"][0])
    assert out["torch"][1] == out["jax"][1]
    np.testing.assert_allclose(out["torch"][2], out["jax"][2], rtol=1e-5)


def test_state_cell_guards():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        boot = tfluid.layers.data("b", shape=[H], dtype="float32")
        cell = tfluid.contrib.StateCell(
            inputs={"x": None}, states={"h": tfluid.contrib.InitState(
                init=boot)}, out_state="h")
        with pytest.raises(ValueError):
            cell.get_state("nope")
        with pytest.raises(ValueError):
            cell.get_state("h")   # outside a decoder block
        with pytest.raises(ValueError):
            cell.update_states()


def _custom_block_program(fluid, max_len, use_early_stop):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        boot = fluid.layers.data("b", shape=[H], dtype="float32")
        init_ids = fluid.layers.data("ids", shape=[1], dtype="int64")
        init_scores = fluid.layers.data("scores", shape=[1],
                                        dtype="float32")
        decoder = fluid.contrib.BeamSearchDecoder(
            state_cell=_build_cell(fluid, boot), init_ids=init_ids,
            init_scores=init_scores, target_dict_dim=V, word_dim=EMB,
            max_len=max_len, beam_size=1, end_id=V + 7)
        with decoder.block():
            prev_ids = decoder.read_array(init=init_ids, is_ids=True)
            prev_scores = decoder.read_array(init=init_scores,
                                             is_scores=True)
            one = fluid.layers.fill_constant_batch_size_like(
                input=prev_ids, shape=[-1, 1], value=1, dtype="int64")
            next_ids = fluid.layers.elementwise_add(prev_ids, one)
            next_scores = fluid.layers.scale(prev_scores, scale=0.5)
            if use_early_stop:
                decoder.early_stop()
            decoder.update_array(prev_ids, next_ids)
            decoder.update_array(prev_scores, next_scores)
        sent_ids, sent_scores = decoder()
    return main, startup, sent_ids, sent_scores


@pytest.mark.parametrize("max_len,early_stop,lod,flat", [
    (3, False, [0, 4, 8], [3, 4, 5, 6, 10, 11, 12, 13]),
    (5, True, [0, 1, 2], [3, 10])])
def test_beam_search_decoder_custom_block(max_len, early_stop, lod, flat):
    """The build-your-own-step contract: a custom body threading tensor
    arrays through the decoder's While (its trips, or one with
    early_stop), the same sentences in both packages."""
    got = {}
    for name, fluid in PKGS.items():
        main, startup, sent_ids, sent_scores = _custom_block_program(
            fluid, max_len, early_stop)
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            ids, scores = exe.run(
                main, feed={"b": np.zeros((2, H), np.float32),
                            "ids": np.array([[3], [10]], np.int64),
                            "scores": np.ones((2, 1), np.float32)},
                fetch_list=[sent_ids, sent_scores], return_numpy=False)
        got[name] = (np.asarray(ids).ravel(), ids.lod(),
                     _np(scores).ravel())
    np.testing.assert_array_equal(got["torch"][0], flat)
    assert [list(x) for x in got["torch"][1]] == [lod]
    np.testing.assert_array_equal(got["torch"][0], got["jax"][0])
    np.testing.assert_allclose(got["torch"][2], got["jax"][2], rtol=1e-5)
