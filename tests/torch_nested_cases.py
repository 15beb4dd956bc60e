"""Nested (2-level LoD) programs built the same way in either package
(`fluid` is paddle_tpu.fluid or paddle_tpu_torch.fluid), numpy only: the
CPU tests hold the port against the JAX package with them, and
chip_smoke.py runs them on the card against the CPU.

The nested ops have no fluid.layers function in either package; they are
appended as the JAX package's v2 layers append them
(paddle_tpu/v2/layer.py: recurrent_group over a SubsequenceInput lowers
to nested_to_outer, a DynamicRNN over the sentences, attach_lod)."""

import numpy as np


def nested_to_outer(fluid, x):
    """(rows [B_outer, S_max, T, D], lengths [B_outer, S_max]), each with
    the outer counts as its lengths."""
    helper = fluid.LayerHelper("nested_to_outer")
    out = helper.create_variable_for_type_inference(x.dtype)
    lmat = helper.create_variable_for_type_inference("int32")
    out.lod_level = lmat.lod_level = 1
    helper.append_op(type="nested_to_outer", inputs={"X": x},
                     outputs={"Out": out, "OutLens": lmat},
                     infer_shape=False)
    out.shape = tuple(x.shape)
    lmat.shape = (-1, 1)
    return out, lmat


def attach_lod(fluid, x, lens):
    helper = fluid.LayerHelper("attach_lod")
    out = helper.create_variable_for_type_inference(x.dtype)
    out.lod_level = 1
    helper.append_op(type="attach_lod", inputs={"X": x, "Lens": lens},
                     outputs={"Out": out}, infer_shape=False)
    out.shape = tuple(x.shape)
    return out


def kmax_seq_score(fluid, x, beam_size):
    helper = fluid.LayerHelper("kmax_seq_score")
    idx = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="kmax_seq_score", inputs={"X": x},
                     outputs={"Out": idx},
                     attrs={"beam_size": beam_size, "force_host": True},
                     infer_shape=False)
    return idx


def sub_nested_seq(fluid, x, idx):
    helper = fluid.LayerHelper("sub_nested_seq")
    sel = helper.create_variable_for_type_inference(x.dtype)
    sel.lod_level = 2
    helper.append_op(type="sub_nested_seq",
                     inputs={"X": x, "Indices": idx},
                     outputs={"Out": sel}, infer_shape=False)
    sel.shape = tuple(x.shape)
    return sel


def doc_encoder_program(fluid, vocab, emb_dim, hid, seed=1, lr=0.1):
    """A hierarchical document classifier: words (lod_level 2: documents
    of sentences of words) -> embedding -> fc tanh -> nested_to_outer ->
    a DynamicRNN over each document's sentences (the rows and the length
    matrix stepped, attach_lod, a sum pool of the sentence, a memory
    updated by fc tanh over the pool and the memory) -> the last
    sentence's state -> fc softmax over 2 classes -> cross entropy.
    SGD `lr`.  Returns (main, startup, loss)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        words = L.data("words", shape=[1], dtype="int64", lod_level=2)
        label = L.data("label", shape=[1], dtype="int64")
        emb = L.embedding(words, size=[vocab, emb_dim])
        proj = L.fc(emb, size=hid, act="tanh")
        rows, lmat = nested_to_outer(fluid, proj)
        init = L.fill_constant_batch_size_like(
            input=label, shape=[-1, hid], dtype="float32", value=0.0)
        drnn = L.DynamicRNN()
        with drnn.block():
            xs = drnn.step_input(rows)
            ls = drnn.step_input(lmat)
            pooled = L.sequence_pool(attach_lod(fluid, xs, ls), "sum")
            mem = drnn.memory(init=init)
            h = L.fc([pooled, mem], size=hid, act="tanh")
            drnn.update_memory(mem, h)
            drnn.output(h)
        last = L.sequence_last_step(drnn())
        pred = L.fc(last, size=2, act="softmax")
        loss = L.mean(L.cross_entropy(input=pred, label=label))
        fluid.optimizer.SGD(lr).minimize(loss)
    return main, startup, loss


def selection_program(fluid, vocab, emb_dim, beam_size, seed=2):
    """The nested selection ops on documents: a score per sentence (fc
    to 1 over the word embeddings, its first word's score), the top
    `beam_size` sentences of each document (kmax_seq_score) picked out
    of the projected words (sub_nested_seq), and each document's title
    (a lod_level-1 feed) repeated once per sentence (sequence_expand
    with the nested words as Y).  Returns (main, startup, [sel, exp])."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        words = L.data("words", shape=[1], dtype="int64", lod_level=2)
        title = L.data("title", shape=[1], dtype="int64", lod_level=1)
        emb = L.embedding(words, size=[vocab, emb_dim])
        scores = L.fc(emb, size=1)
        idx = kmax_seq_score(fluid, scores, beam_size)
        sel = sub_nested_seq(fluid, L.fc(emb, size=emb_dim), idx)
        temb = L.embedding(title, size=[vocab, emb_dim])
        exp = L.sequence_expand(x=temb, y=emb)
        # the JAX package jits an op unless it is marked for its host
        # path, where the nested counts are concrete; the port ignores it
        main.global_block().ops[-1].attrs["force_host"] = True
    return main, startup, [sel, exp]


def doc_batch(fluid, rng, batch, sents, words, vocab, titled=False):
    """A seeded batch of `batch` documents of randint(sents) sentences of
    randint(words) word ids: {"words": 2-level LoDTensor, "label": [B,
    1]} (and "title", a lod_level-1 LoDTensor, with `titled`)."""
    docs = [[rng.randint(0, vocab, size=(rng.randint(words[0],
                                                     words[1] + 1), 1))
             .astype(np.int64)
             for _ in range(rng.randint(sents[0], sents[1] + 1))]
            for _ in range(batch)]
    rows = np.concatenate([s for d in docs for s in d], axis=0)
    feed = {"words": fluid.create_lod_tensor(
        rows, [[len(d) for d in docs], [len(s) for d in docs for s in d]],
        None),
        "label": rng.randint(0, 2, size=(batch, 1)).astype(np.int64)}
    if titled:
        tl = [int(n) for n in rng.randint(words[0], words[1] + 1,
                                          size=batch)]
        feed["title"] = fluid.create_lod_tensor(
            rng.randint(0, vocab, size=(sum(tl), 1)).astype(np.int64),
            [tl], None)
    return feed
