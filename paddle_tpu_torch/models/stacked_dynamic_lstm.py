"""The stacked dynamic-LSTM text classifier, a copy of
paddle_tpu/models/stacked_dynamic_lstm.py (the reference
benchmark/fluid/models/stacked_dynamic_lstm.py, IMDB sentiment):
embedding, then N x (fc 4H -> dynamic_lstm), a max sequence_pool of each
layer, and an fc softmax over the pools, trained with Adam.  The word ids
are a ragged (lod_level=1) feed: padded [B, T, 1] plus lengths at run
time, each LSTM a loop over T (ops/sequence_ops.py)."""

import paddle_tpu_torch.fluid as fluid


def lstm_net(data, dict_dim, class_dim=2, emb_dim=512, hid_dim=512,
             stacked_num=3):
    emb = fluid.layers.embedding(input=data, size=[dict_dim, emb_dim],
                                 is_sparse=False)
    pools = []
    fc1 = fluid.layers.fc(input=emb, size=hid_dim * 4)
    lstm1, cell1 = fluid.layers.dynamic_lstm(input=fc1, size=hid_dim * 4)
    pools.append(fluid.layers.sequence_pool(lstm1, pool_type="max"))
    inputs = lstm1
    for _ in range(2, stacked_num + 1):
        fc = fluid.layers.fc(input=inputs, size=hid_dim * 4)
        lstm, cell = fluid.layers.dynamic_lstm(input=fc,
                                               size=hid_dim * 4)
        pools.append(fluid.layers.sequence_pool(lstm, pool_type="max"))
        inputs = lstm
    prediction = fluid.layers.fc(input=pools, size=class_dim, act="softmax")
    return prediction


def get_model(batch_size=64, dict_dim=5147, emb_dim=512, hid_dim=512,
              stacked_num=3, class_dim=2, lr=0.002):
    """(main, startup, feeds, loss, acc, predict), as the JAX package's
    get_model; feed `words` as a LoDTensor of int64 ids [rows, 1] and
    `label` as int64 [B, 1]."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        data = fluid.layers.data(name="words", shape=[1], dtype="int64",
                                 lod_level=1)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        prediction = lstm_net(data, dict_dim, class_dim, emb_dim, hid_dim,
                              stacked_num)
        cost = fluid.layers.cross_entropy(input=prediction, label=label)
        avg_cost = fluid.layers.mean(cost)
        acc = fluid.layers.accuracy(input=prediction, label=label)
        fluid.optimizer.Adam(learning_rate=lr).minimize(avg_cost)
    return main, startup, [data, label], avg_cost, acc, prediction
