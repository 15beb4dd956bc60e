"""SE-ResNeXt (50/101/152) for ImageNet-shaped inputs, a copy of
paddle_tpu/models/se_resnext.py (the reference's dist_se_resnext.py):
grouped 3x3 convolutions (cardinality 32 for depths 50 and 101, 64 for
152) and squeeze-excitation with reduction 16, a `remat_tag` at every
block's output, trained with Momentum 0.9, piecewise decay and
L2Decay(1e-4).  The same layer calls, names and op list as the JAX
package.  `remove_bn` and `remove_dropout` are the reference's
Executor-against-ParallelExecutor comparison switches; `layout` selects
NCHW or NHWC activations (OIHW filters in both)."""

import paddle_tpu_torch.fluid as fluid


def conv_bn_layer(input, num_filters, filter_size, stride=1, groups=1,
                  act=None, is_train=True, remove_bn=False,
                  layout="NCHW"):
    conv = fluid.layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        stride=stride, padding=(filter_size - 1) // 2, groups=groups,
        act=act if remove_bn else None, bias_attr=False,
        data_format=layout)
    if remove_bn:
        # the reference drops batch norm and the activation here; the
        # JAX package keeps the activation (a nonlinear net), and so does
        # the port
        return conv
    return fluid.layers.batch_norm(input=conv, act=act,
                                   is_test=not is_train,
                                   data_layout=layout)


def squeeze_excitation(input, num_channels, reduction_ratio,
                       layout="NCHW"):
    pool = fluid.layers.pool2d(input=input, pool_type="avg",
                               global_pooling=True, data_format=layout)
    pool = fluid.layers.reshape(pool, [-1, num_channels])
    squeeze = fluid.layers.fc(input=pool,
                              size=num_channels // reduction_ratio,
                              act="relu")
    excitation = fluid.layers.fc(input=squeeze, size=num_channels,
                                 act="sigmoid")
    bshape = ([-1, num_channels, 1, 1] if layout == "NCHW"
              else [-1, 1, 1, num_channels])
    excitation = fluid.layers.reshape(excitation, bshape)
    return fluid.layers.elementwise_mul(x=input, y=excitation)


def shortcut(input, ch_out, stride, is_train=True, remove_bn=False,
             layout="NCHW"):
    ch_in = input.shape[1] if layout == "NCHW" else input.shape[-1]
    if ch_in != ch_out or stride != 1:
        filter_size = 1
        return conv_bn_layer(input, ch_out, filter_size, stride,
                             is_train=is_train, remove_bn=remove_bn,
                             layout=layout)
    return input


def bottleneck_block(input, num_filters, stride, cardinality,
                     reduction_ratio, is_train=True, remove_bn=False,
                     layout="NCHW"):
    conv0 = conv_bn_layer(input, num_filters, 1, act="relu",
                          is_train=is_train, remove_bn=remove_bn,
                          layout=layout)
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride=stride,
                          groups=cardinality, act="relu", is_train=is_train,
                          remove_bn=remove_bn, layout=layout)
    conv2 = conv_bn_layer(conv1, num_filters * 2, 1, act=None,
                          is_train=is_train, remove_bn=remove_bn,
                          layout=layout)
    scale = squeeze_excitation(conv2, num_filters * 2, reduction_ratio,
                               layout=layout)
    short = shortcut(input, num_filters * 2, stride, is_train=is_train,
                     remove_bn=remove_bn, layout=layout)
    out = fluid.layers.elementwise_add(x=short, y=scale, act="relu")
    # the whole-graph step's block_out remat boundary
    return fluid.layers.remat_checkpoint(out) if is_train else out


def build(img, layers=50, class_dim=1000, is_train=True, remove_bn=False,
          remove_dropout=False, layout="NCHW"):
    """img [N, 3, H, W] (layout="NCHW") or [N, H, W, 3] ("NHWC")
    -> logits [N, class_dim] (pre-softmax fc)."""
    # cardinality per depth matches dist_se_resnext.py:60,:78,:96 —
    # 32 groups for SE-ResNeXt-50/101, 64 for 152
    supported = {50: ([3, 4, 6, 3], [128, 256, 512, 1024], 32),
                 101: ([3, 4, 23, 3], [128, 256, 512, 1024], 32),
                 152: ([3, 8, 36, 3], [128, 256, 512, 1024], 64)}
    depth, num_filters, cardinality = supported[layers]
    reduction_ratio = 16

    if layers == 152:
        conv = conv_bn_layer(img, 64, 3, stride=2, act="relu",
                             is_train=is_train, remove_bn=remove_bn,
                             layout=layout)
        conv = conv_bn_layer(conv, 64, 3, act="relu", is_train=is_train,
                             remove_bn=remove_bn, layout=layout)
        conv = conv_bn_layer(conv, 128, 3, act="relu", is_train=is_train,
                             remove_bn=remove_bn, layout=layout)
    else:
        conv = conv_bn_layer(img, 64, 7, stride=2, act="relu",
                             is_train=is_train, remove_bn=remove_bn,
                             layout=layout)
    conv = fluid.layers.pool2d(input=conv, pool_size=3, pool_stride=2,
                               pool_padding=1, pool_type="max",
                               data_format=layout)
    for block in range(len(depth)):
        for i in range(depth[block]):
            conv = bottleneck_block(
                conv, num_filters[block], 2 if i == 0 and block != 0 else 1,
                cardinality, reduction_ratio, is_train=is_train,
                remove_bn=remove_bn, layout=layout)
    pool = fluid.layers.pool2d(input=conv, pool_type="avg",
                               global_pooling=True, data_format=layout)
    nch = pool.shape[1] if layout == "NCHW" else pool.shape[-1]
    pool = fluid.layers.reshape(pool, [-1, nch])
    if remove_dropout:
        drop = pool
    else:
        drop = fluid.layers.dropout(pool, dropout_prob=0.2,
                                    is_test=not is_train)
    return fluid.layers.fc(input=drop, size=class_dim)


def get_model(batch_size=32, class_dim=1000, layers=50, img_size=224,
              lr=0.1, is_train=True, remove_bn=False, remove_dropout=False,
              layout="NCHW"):
    """(main, startup, feed names, loss, acc, prob), as the JAX package's
    get_model: Momentum 0.9 on a piecewise-decayed LR (x0.1 at epochs 30,
    60 and 90 of 1252 steps) with L2Decay(1e-4)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img_shape = ([3, img_size, img_size] if layout == "NCHW"
                     else [img_size, img_size, 3])
        img = fluid.layers.data("data", shape=img_shape, dtype="float32")
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        logits = build(img, layers=layers, class_dim=class_dim,
                       is_train=is_train, remove_bn=remove_bn,
                       remove_dropout=remove_dropout, layout=layout)
        prob = fluid.layers.softmax(logits)
        loss = fluid.layers.cross_entropy(input=prob, label=label)
        avg_loss = fluid.layers.mean(loss)
        acc = fluid.layers.accuracy(input=prob, label=label)
        if is_train:
            epochs = [30, 60, 90]
            steps_per_pass = 1252
            bd = [e * steps_per_pass for e in epochs]
            lrs = [lr * (0.1 ** i) for i in range(len(bd) + 1)]
            opt = fluid.optimizer.Momentum(
                learning_rate=fluid.layers.piecewise_decay(
                    boundaries=bd, values=lrs),
                momentum=0.9,
                regularization=fluid.regularizer.L2Decay(1e-4))
            opt.minimize(avg_loss)
    return main, startup, ["data", "label"], avg_loss, acc, prob
