"""ResNet for ImageNet (50/101/152 bottleneck) and CIFAR-10 (20/32/44/56),
a copy of paddle_tpu/models/resnet.py: conv7x7/2 + maxpool3/2 +
bottleneck stacks + global avgpool + fc(softmax), batch norm after every
conv.  The same layer calls, names and op list as the JAX package, so an
artifact saved by either package serves in the other.

`layout` selects the activation layout (NCHW, or NHWC — the layout
FuseBottleneckPass fuses); filters are OIHW in both.  `is_train=True`
builds the training program that the JAX package's bench.py times: batch
norm on batch statistics, a `remat_tag` at every block's output (the
boundary of the whole-graph step's `block_out` remat), and Momentum 0.9
with L2Decay(1e-4).
"""

import paddle_tpu_torch.fluid as fluid


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act="relu",
                  is_train=True, layout="NCHW"):
    conv1 = fluid.layers.conv2d(
        input=input, filter_size=filter_size, num_filters=ch_out,
        stride=stride, padding=padding, act=None, bias_attr=False,
        data_format=layout)
    return fluid.layers.batch_norm(input=conv1, act=act,
                                   is_test=not is_train, data_layout=layout)


def _channels(v, layout):
    return v.shape[1] if layout == "NCHW" else v.shape[-1]


def _tag_block_out(x, is_train):
    """The JAX package's remat tag at the block boundary, emitted only
    for training programs."""
    return fluid.layers.remat_checkpoint(x) if is_train else x


def shortcut(input, ch_out, stride, is_train=True, layout="NCHW"):
    ch_in = _channels(input, layout)
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, 0, act=None,
                             is_train=is_train, layout=layout)
    return input


def bottleneck_block(input, num_filters, stride, is_train=True,
                     layout="NCHW"):
    conv0 = conv_bn_layer(input, num_filters, 1, 1, 0, is_train=is_train,
                          layout=layout)
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride, 1,
                          is_train=is_train, layout=layout)
    conv2 = conv_bn_layer(conv1, num_filters * 4, 1, 1, 0, act=None,
                          is_train=is_train, layout=layout)
    short = shortcut(input, num_filters * 4, stride, is_train=is_train,
                     layout=layout)
    out = fluid.layers.elementwise_add(x=short, y=conv2, act="relu")
    return _tag_block_out(out, is_train)


def basic_block(input, num_filters, stride, is_train=True, layout="NCHW"):
    conv0 = conv_bn_layer(input, num_filters, 3, stride, 1,
                          is_train=is_train, layout=layout)
    conv1 = conv_bn_layer(conv0, num_filters, 3, 1, 1, act=None,
                          is_train=is_train, layout=layout)
    short = shortcut(input, num_filters, stride, is_train=is_train,
                     layout=layout)
    out = fluid.layers.elementwise_add(x=short, y=conv1, act="relu")
    return _tag_block_out(out, is_train)


def resnet_imagenet(input, class_dim=1000, depth=50, is_train=True,
                    layout="NCHW"):
    cfg = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}[depth]
    conv = conv_bn_layer(input, 64, 7, 2, 3, is_train=is_train,
                         layout=layout)
    pool = fluid.layers.pool2d(input=conv, pool_size=3, pool_stride=2,
                               pool_padding=1, pool_type="max",
                               data_format=layout)
    res = pool
    for stage, count in enumerate(cfg):
        num_filters = 64 * (2 ** stage)
        for i in range(count):
            stride = 2 if i == 0 and stage > 0 else 1
            res = bottleneck_block(res, num_filters, stride,
                                   is_train=is_train, layout=layout)
    pool = fluid.layers.pool2d(input=res, pool_type="avg",
                               global_pooling=True, data_format=layout)
    out = fluid.layers.fc(input=pool, size=class_dim, act="softmax")
    return out


def resnet_cifar10(input, class_dim=10, depth=32, is_train=True,
                   layout="NCHW"):
    if (depth - 2) % 6:
        raise ValueError("resnet_cifar10: depth - 2 must be a multiple "
                         "of 6, got %d" % depth)
    n = (depth - 2) // 6
    conv = conv_bn_layer(input, 16, 3, 1, 1, is_train=is_train,
                         layout=layout)
    res = conv
    for stage in range(3):
        num_filters = 16 * (2 ** stage)
        for i in range(n):
            stride = 2 if i == 0 and stage > 0 else 1
            res = basic_block(res, num_filters, stride, is_train=is_train,
                              layout=layout)
    pool = fluid.layers.pool2d(input=res, pool_type="avg",
                               global_pooling=True, data_format=layout)
    out = fluid.layers.fc(input=pool, size=class_dim, act="softmax")
    return out


def get_model(batch_size=256, class_dim=1000, depth=50, dataset="imagenet",
              lr=0.1, is_train=True, dtype="float32", layout="NCHW"):
    """(main, startup, feeds, loss, acc, predict), as the JAX package's
    get_model.  With layout="NHWC" the `data` feed is channels-last
    ([H, W, 3])."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        if dataset == "imagenet":
            hw = 224
            model_fn = lambda im: resnet_imagenet(
                im, class_dim=class_dim, depth=depth, is_train=is_train,
                layout=layout)
        else:
            hw = 32
            model_fn = lambda im: resnet_cifar10(
                im, class_dim=class_dim, depth=depth, is_train=is_train,
                layout=layout)
        image_shape = [3, hw, hw] if layout == "NCHW" else [hw, hw, 3]
        image = fluid.layers.data(name="data", shape=image_shape,
                                  dtype=dtype)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        predict = model_fn(image)
        cost = fluid.layers.cross_entropy(input=predict, label=label)
        avg_cost = fluid.layers.mean(cost)
        batch_acc = fluid.layers.accuracy(input=predict, label=label)
        if is_train:
            opt = fluid.optimizer.Momentum(
                learning_rate=lr, momentum=0.9,
                regularization=fluid.regularizer.L2Decay(1e-4))
            opt.minimize(avg_cost)
    return main, startup, [image, label], avg_cost, batch_acc, predict
