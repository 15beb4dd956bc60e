"""Seq2seq machine translation (WMT14-shaped), after
paddle_tpu/models/machine_translation.py: the same programs, parameter
names and shapes, so one scope drives both packages.

Training (reference benchmark/fluid/models/machine_translation.py
seq_to_seq_net): a bi-LSTM encoder, then an attention LSTM decoder as a
DynamicRNN (one `recurrent` op, whose static inputs close the padded
encoder states into the step), cross-entropy and Adam.  Attention is
sequence_expand + masked sequence_softmax + sequence_pool over the ragged
encoder axis.

Generation: `max_length` dense beam steps unrolled into the program
(every source keeps exactly beam_size rows, ops/beam_ops.py), from the
encoder's final state, then beam_search_decode backtracks the stacked
parent pointers.  The decoder's parameters are pinned by name
(`decoder_lstm_g*_w*`, `att_state_w`, `att_score_w`, `decoder_out_w/_b`,
`trg_emb`), so a trained scope drives generation.
"""

import paddle_tpu_torch.fluid as fluid


def lstm_step(x_t, hidden_t_prev, cell_t_prev, size, param_prefix=None):
    """One LSTM cell step from fc gates (reference lstm_step in
    benchmark/fluid/models/machine_translation.py). `param_prefix` pins the
    gate parameter names so an unrolled decode loop shares one cell's
    weights across all timesteps."""
    gate_idx = [0]

    def linear(inputs):
        if param_prefix is None:
            return fluid.layers.fc(input=inputs, size=size, bias_attr=True)
        g = gate_idx[0]
        gate_idx[0] += 1
        return fluid.layers.fc(
            input=inputs, size=size,
            param_attr=[fluid.ParamAttr(name="%s_g%d_w%d" %
                                        (param_prefix, g, i))
                        for i in range(len(inputs))],
            bias_attr=fluid.ParamAttr(name="%s_g%d_b" % (param_prefix, g)))

    forget_gate = fluid.layers.sigmoid(linear([hidden_t_prev, x_t]))
    input_gate = fluid.layers.sigmoid(linear([hidden_t_prev, x_t]))
    output_gate = fluid.layers.sigmoid(linear([hidden_t_prev, x_t]))
    cell_tilde = fluid.layers.tanh(linear([hidden_t_prev, x_t]))
    cell_t = fluid.layers.sums(input=[
        fluid.layers.elementwise_mul(x=forget_gate, y=cell_t_prev),
        fluid.layers.elementwise_mul(x=input_gate, y=cell_tilde)])
    hidden_t = fluid.layers.elementwise_mul(
        x=output_gate, y=fluid.layers.tanh(cell_t))
    return hidden_t, cell_t


def bi_lstm_encoder(input_seq, gate_size):
    fwd_proj = fluid.layers.fc(input=input_seq, size=gate_size * 4,
                               bias_attr=False)
    forward, _ = fluid.layers.dynamic_lstm(
        input=fwd_proj, size=gate_size * 4, use_peepholes=False)
    rev_proj = fluid.layers.fc(input=input_seq, size=gate_size * 4,
                               bias_attr=False)
    reversed_, _ = fluid.layers.dynamic_lstm(
        input=rev_proj, size=gate_size * 4, is_reverse=True,
        use_peepholes=False)
    return forward, reversed_


def simple_attention(encoder_vec, encoder_proj, decoder_state, decoder_size):
    """Additive attention over the ragged encoder axis. Parameter names are
    pinned ("att_state_w", "att_score_w") so the dense generation decoder
    (below) can reuse the trained weights."""
    state_proj = fluid.layers.fc(
        input=decoder_state, size=decoder_size, bias_attr=False,
        param_attr=fluid.ParamAttr(name="att_state_w"))
    state_expand = fluid.layers.sequence_expand(x=state_proj, y=encoder_proj)
    concated = fluid.layers.concat(input=[encoder_proj, state_expand], axis=1)
    weights = fluid.layers.fc(input=concated, size=1, act="tanh",
                              bias_attr=False,
                              param_attr=fluid.ParamAttr(name="att_score_w"))
    weights = fluid.layers.sequence_softmax(input=weights)
    weights = fluid.layers.reshape(x=weights, shape=[-1])
    scaled = fluid.layers.elementwise_mul(x=encoder_vec, y=weights, axis=0)
    return fluid.layers.sequence_pool(input=scaled, pool_type="sum")


def seq_to_seq_net(embedding_dim, encoder_size, decoder_size,
                   source_dict_dim, target_dict_dim, is_generating=False,
                   beam_size=3, max_length=8):
    src_word_idx = fluid.layers.data(name="source_sequence", shape=[1],
                                     dtype="int64", lod_level=1)
    src_embedding = fluid.layers.embedding(
        input=src_word_idx, size=[source_dict_dim, embedding_dim],
        dtype="float32")
    src_forward, src_reversed = bi_lstm_encoder(src_embedding, encoder_size)
    encoded_vector = fluid.layers.concat(
        input=[src_forward, src_reversed], axis=1)
    encoded_proj = fluid.layers.fc(input=encoded_vector, size=decoder_size,
                                   bias_attr=False)
    backward_first = fluid.layers.sequence_pool(input=src_reversed,
                                                pool_type="first")
    decoder_boot = fluid.layers.fc(input=backward_first, size=decoder_size,
                                   bias_attr=False, act="tanh")

    if not is_generating:
        trg_word_idx = fluid.layers.data(name="target_sequence", shape=[1],
                                         dtype="int64", lod_level=1)
        trg_embedding = fluid.layers.embedding(
            input=trg_word_idx, size=[target_dict_dim, embedding_dim],
            dtype="float32", param_attr=fluid.ParamAttr(name="trg_emb"))

        rnn = fluid.layers.DynamicRNN()
        cell_init = fluid.layers.fill_constant_batch_size_like(
            input=decoder_boot, value=0.0, shape=[-1, decoder_size],
            dtype="float32")
        cell_init.stop_gradient = False
        with rnn.block():
            current_word = rnn.step_input(trg_embedding)
            encoder_vec = rnn.static_input(encoded_vector)
            encoder_proj = rnn.static_input(encoded_proj)
            hidden_mem = rnn.memory(init=decoder_boot, need_reorder=True)
            cell_mem = rnn.memory(init=cell_init)
            context = simple_attention(encoder_vec, encoder_proj,
                                       hidden_mem, decoder_size)
            decoder_inputs = fluid.layers.concat(
                input=[context, current_word], axis=1)
            h, c = lstm_step(decoder_inputs, hidden_mem, cell_mem,
                             decoder_size, param_prefix="decoder_lstm")
            rnn.update_memory(hidden_mem, h)
            rnn.update_memory(cell_mem, c)
            # shared names with the generation decoder so trained weights
            # drive beam-search decoding
            out = fluid.layers.fc(
                input=h, size=target_dict_dim, act="softmax",
                param_attr=fluid.ParamAttr(name="decoder_out_w"),
                bias_attr=fluid.ParamAttr(name="decoder_out_b"))
            rnn.output(out)
        prediction = rnn()

        label = fluid.layers.data(name="label_sequence", shape=[1],
                                  dtype="int64", lod_level=1)
        cost = fluid.layers.cross_entropy(input=prediction, label=label)
        avg_cost = fluid.layers.mean(cost)
        feeding_list = ["source_sequence", "target_sequence",
                        "label_sequence"]
        return avg_cost, prediction, feeding_list

    # -- generation: dense beam search with per-step attention, sharing the
    # training decoder's parameters (attention + lstm gates + output fc) --
    W = beam_size
    # replicate per-source state to W beam rows: [B, D] -> [B*W, D]
    boot0 = fluid.layers.unsqueeze(decoder_boot, axes=[1])      # [B, 1, D]
    boot0 = fluid.layers.expand(boot0, expand_times=[1, W, 1])  # [B, W, D]
    boot_beam = fluid.layers.reshape(boot0, shape=[-1, decoder_size])

    # dense (padded) encoder states + validity mask, gathered per beam row
    pad0 = fluid.layers.fill_constant([1], "float32", 0.0)
    enc_pad, _ = fluid.layers.sequence_pad(encoded_vector, pad0)  # [B,T,2E]
    proj_pad, _ = fluid.layers.sequence_pad(encoded_proj, pad0)   # [B,T,D]
    ones_ragged = fluid.layers.scale(
        fluid.layers.cast(src_word_idx, "float32"), scale=0.0, bias=1.0)
    mask_pad, _ = fluid.layers.sequence_pad(ones_ragged, pad0)    # [B,T,1]
    ones_bw = fluid.layers.fill_constant_batch_size_like(
        input=boot_beam, shape=[-1, 1], value=1.0, dtype="float32")
    ramp = fluid.layers.cumsum(ones_bw, axis=0, exclusive=True)  # 0..BW-1
    src_idx = fluid.layers.cast(
        fluid.layers.floor(fluid.layers.scale(ramp, scale=1.0 / W)), "int32")
    src_idx = fluid.layers.reshape(src_idx, shape=[-1])
    enc_beam = fluid.layers.gather(enc_pad, src_idx)      # [BW, T, 2E]
    proj_beam = fluid.layers.gather(proj_pad, src_idx)    # [BW, T, D]
    mask_beam = fluid.layers.gather(mask_pad, src_idx)    # [BW, T, 1]

    # attention score weight shared with training: att_score_w [2D, 1],
    # split into the encoder-proj half and the state half
    helper = fluid.LayerHelper("gen_attention")
    att_w = helper.create_parameter(
        attr=fluid.ParamAttr(name="att_score_w"),
        shape=[2 * decoder_size, 1], dtype="float32")
    w_proj = fluid.layers.slice(att_w, axes=[0], starts=[0],
                                ends=[decoder_size])
    w_state = fluid.layers.slice(att_w, axes=[0], starts=[decoder_size],
                                 ends=[2 * decoder_size])

    def dense_attention(hidden):
        """Same math as simple_attention, on padded beam tensors:
        fc(concat([proj, state])) == proj @ w_proj + state @ w_state."""
        state_proj = fluid.layers.fc(
            input=hidden, size=decoder_size, bias_attr=False,
            param_attr=fluid.ParamAttr(name="att_state_w"))
        s_enc = fluid.layers.matmul(proj_beam, w_proj)     # [BW, T, 1]
        s_state = fluid.layers.unsqueeze(
            fluid.layers.matmul(state_proj, w_state), axes=[1])  # [BW,1,1]
        score = fluid.layers.tanh(
            fluid.layers.elementwise_add(s_enc, s_state))
        neg = fluid.layers.scale(mask_beam, scale=1e9, bias=-1e9)
        score = fluid.layers.elementwise_add(
            fluid.layers.elementwise_mul(score, mask_beam), neg)
        score = fluid.layers.squeeze(score, axes=[2])      # [BW, T]
        att = fluid.layers.softmax(score)
        att = fluid.layers.unsqueeze(att, axes=[2])        # [BW, T, 1]
        ctx = fluid.layers.reduce_sum(
            fluid.layers.elementwise_mul(enc_beam, att), dim=1)
        return ctx                                          # [BW, 2E]

    start_id = 0
    end_id = 1
    pre_ids = fluid.layers.fill_constant_batch_size_like(
        input=boot_beam, shape=[-1, 1], value=start_id, dtype="int64")
    pre_scores = fluid.layers.fill_constant_batch_size_like(
        input=boot_beam, shape=[-1, 1], value=0.0, dtype="float32")

    step_ids, step_scores, step_parents = [], [], []
    hidden = boot_beam
    cell = fluid.layers.fill_constant_batch_size_like(
        input=boot_beam, shape=[-1, decoder_size], value=0.0,
        dtype="float32")
    first = True
    for t in range(max_length):
        word_emb = fluid.layers.embedding(
            input=pre_ids, size=[target_dict_dim, embedding_dim],
            dtype="float32", param_attr=fluid.ParamAttr(name="trg_emb"))
        word_emb = fluid.layers.reshape(word_emb,
                                        shape=[-1, embedding_dim])
        context = dense_attention(hidden)
        dec_in = fluid.layers.concat(input=[context, word_emb], axis=1)
        hidden, cell = lstm_step(dec_in, hidden, cell, decoder_size,
                                 param_prefix="decoder_lstm")
        probs = fluid.layers.fc(
            input=hidden, size=target_dict_dim, act="softmax",
            param_attr=fluid.ParamAttr(name="decoder_out_w"),
            bias_attr=fluid.ParamAttr(name="decoder_out_b"))
        log_probs = fluid.layers.log(probs)
        accu = fluid.layers.elementwise_add(log_probs, pre_scores, axis=0)
        if first:
            # deactivate the W-1 duplicate start beams per source so the
            # first expansion selects from one beam only (the reference
            # starts with a single LoD beam per source)
            first = False
            accu = fluid.layers.elementwise_add(
                accu, _beam_slot_mask(boot_beam, W), axis=0)
        sel_ids, sel_scores, parent_idx = fluid.layers.beam_search(
            pre_ids, pre_scores, None, accu, beam_size=W, end_id=end_id,
            return_parent_idx=True)
        step_ids.append(sel_ids)
        step_scores.append(sel_scores)
        step_parents.append(parent_idx)
        pre_ids, pre_scores = sel_ids, sel_scores
        # reorder recurrent state by parent pointers
        hidden = fluid.layers.gather(hidden, parent_idx)
        cell = fluid.layers.gather(cell, parent_idx)

    ids_arr = fluid.layers.stack([fluid.layers.reshape(i, shape=[-1])
                                  for i in step_ids], axis=0)
    scores_arr = fluid.layers.stack([fluid.layers.reshape(s, shape=[-1])
                                     for s in step_scores], axis=0)
    parents_arr = fluid.layers.stack(step_parents, axis=0)
    sent_ids, sent_scores = fluid.layers.beam_search_decode(
        ids_arr, scores_arr, beam_size=W, end_id=end_id,
        parent_idx=parents_arr)
    return sent_ids, sent_scores, ["source_sequence"]


def _beam_slot_mask(context, W):
    return fluid.layers.beam_slot_mask(context, W)


def get_model(batch_size=16, embedding_dim=512, encoder_size=512,
              decoder_size=512, dict_size=30000, lr=0.0002):
    """Training program (reference get_model: Adam, dict 30k, dim 512)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        avg_cost, prediction, feeding_list = seq_to_seq_net(
            embedding_dim, encoder_size, decoder_size, dict_size, dict_size,
            is_generating=False)
        fluid.optimizer.Adam(learning_rate=lr).minimize(avg_cost)
    return main, startup, feeding_list, avg_cost, None, prediction
