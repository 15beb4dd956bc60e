"""Decoder-only Transformer language model, the port of
paddle_tpu/models/transformer.py: the same program, built with the port's
fluid layers.  Pre-norm blocks, learned positional embeddings, GELU MLP,
causal flash attention (K1/K2 on the card), next-token cross entropy and
Adam."""

import paddle_tpu_torch.fluid as fluid


def transformer_block(x, d_model, n_heads, d_ff, prefix, is_train=True):
    """Pre-norm block: x [N, S, D] -> [N, S, D]."""
    ln1 = fluid.layers.layer_norm(x, begin_norm_axis=2,
                                  param_attr=fluid.ParamAttr(
                                      name=prefix + "_ln1_w"),
                                  bias_attr=fluid.ParamAttr(
                                      name=prefix + "_ln1_b"))
    qkv = fluid.layers.fc(
        input=ln1, size=3 * d_model, num_flatten_dims=2,
        param_attr=fluid.ParamAttr(name=prefix + "_qkv_w"),
        bias_attr=fluid.ParamAttr(name=prefix + "_qkv_b"))
    q = fluid.layers.slice(qkv, axes=[2], starts=[0], ends=[d_model])
    k = fluid.layers.slice(qkv, axes=[2], starts=[d_model],
                           ends=[2 * d_model])
    v = fluid.layers.slice(qkv, axes=[2], starts=[2 * d_model],
                           ends=[3 * d_model])
    att = fluid.layers.flash_attention(q, k, v, num_heads=n_heads,
                                       causal=True)
    proj = fluid.layers.fc(
        input=att, size=d_model, num_flatten_dims=2,
        param_attr=fluid.ParamAttr(name=prefix + "_proj_w"),
        bias_attr=fluid.ParamAttr(name=prefix + "_proj_b"))
    x = fluid.layers.elementwise_add(x, proj)

    ln2 = fluid.layers.layer_norm(x, begin_norm_axis=2,
                                  param_attr=fluid.ParamAttr(
                                      name=prefix + "_ln2_w"),
                                  bias_attr=fluid.ParamAttr(
                                      name=prefix + "_ln2_b"))
    h = fluid.layers.fc(
        input=ln2, size=d_ff, num_flatten_dims=2, act="gelu",
        param_attr=fluid.ParamAttr(name=prefix + "_ff1_w"),
        bias_attr=fluid.ParamAttr(name=prefix + "_ff1_b"))
    h = fluid.layers.fc(
        input=h, size=d_model, num_flatten_dims=2,
        param_attr=fluid.ParamAttr(name=prefix + "_ff2_w"),
        bias_attr=fluid.ParamAttr(name=prefix + "_ff2_b"))
    out = fluid.layers.elementwise_add(x, h)
    # layer-boundary remat tag, kept so the program equals the JAX
    # package's; the port runs it as the identity
    return fluid.layers.remat_checkpoint(out) if is_train else out


def build(tokens, vocab_size, seq_len, d_model=512, n_heads=8, n_layers=6,
          d_ff=2048, is_train=True):
    """tokens [N, S] int64 -> logits [N, S, vocab]."""
    emb = fluid.layers.embedding(
        input=tokens, size=[vocab_size, d_model], dtype="float32",
        param_attr=fluid.ParamAttr(name="tok_emb"))
    pos_ids = fluid.layers.cumsum(
        fluid.layers.fill_constant([1, seq_len], "int64", 1), axis=1,
        exclusive=True)
    pos_emb = fluid.layers.embedding(
        input=pos_ids, size=[seq_len, d_model], dtype="float32",
        param_attr=fluid.ParamAttr(name="pos_emb"))
    x = fluid.layers.elementwise_add(emb, pos_emb)
    if is_train:
        x = fluid.layers.dropout(x, dropout_prob=0.1, is_test=not is_train)
    for i in range(n_layers):
        x = transformer_block(x, d_model, n_heads, d_ff, "blk%d" % i,
                              is_train=is_train)
    x = fluid.layers.layer_norm(x, begin_norm_axis=2,
                                param_attr=fluid.ParamAttr(name="lnf_w"),
                                bias_attr=fluid.ParamAttr(name="lnf_b"))
    return fluid.layers.fc(
        input=x, size=vocab_size, num_flatten_dims=2,
        param_attr=fluid.ParamAttr(name="lm_head_w"), bias_attr=False)


def get_model(batch_size=8, seq_len=512, vocab_size=32000, d_model=512,
              n_heads=8, n_layers=6, d_ff=2048, lr=1e-3, is_train=True):
    """Training program: next-token cross entropy, Adam; feeds tokens
    [N, S] and labels [N, S] (int64).  Returns (main, startup, feed
    names, avg_loss, None, logits), as the JAX package's get_model."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        tokens = fluid.layers.data("tokens", shape=[seq_len], dtype="int64")
        labels = fluid.layers.data("labels", shape=[seq_len], dtype="int64")
        logits = build(tokens, vocab_size, seq_len, d_model, n_heads,
                       n_layers, d_ff, is_train=is_train)
        flat = fluid.layers.reshape(logits, [-1, vocab_size])
        flat_l = fluid.layers.reshape(labels, [-1, 1])
        loss = fluid.layers.softmax_with_cross_entropy(flat, flat_l)
        avg_loss = fluid.layers.mean(loss)
        if is_train:
            fluid.optimizer.Adam(learning_rate=lr).minimize(avg_loss)
    return main, startup, ["tokens", "labels"], avg_loss, None, logits
