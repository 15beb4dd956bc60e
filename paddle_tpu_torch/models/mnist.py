"""MNIST CNN, a copy of paddle_tpu/models/mnist.py: conv5x5x20/pool2 +
conv5x5x50/pool2 + fc10 (softmax), Adam by default or Momentum 0.9."""

import numpy as np

import paddle_tpu_torch.fluid as fluid


def cnn_model(data):
    conv_pool_1 = fluid.nets.simple_img_conv_pool(
        input=data, filter_size=5, num_filters=20, pool_size=2,
        pool_stride=2, act="relu")
    conv_pool_2 = fluid.nets.simple_img_conv_pool(
        input=conv_pool_1, filter_size=5, num_filters=50, pool_size=2,
        pool_stride=2, act="relu")
    size = 10
    param_shape = [int(np.prod(conv_pool_2.shape[1:]))] + [size]
    scale = (2.0 / (param_shape[0] ** 2 * size)) ** 0.5
    return fluid.layers.fc(
        input=conv_pool_2, size=size, act="softmax",
        param_attr=fluid.ParamAttr(
            initializer=fluid.initializer.NormalInitializer(
                loc=0.0, scale=scale)))


def get_model(batch_size=128, lr=0.001, use_adam=True):
    """(main, startup, feeds, loss, acc, predict), as the JAX package's
    get_model."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        images = fluid.layers.data(name="pixel", shape=[1, 28, 28],
                                   dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        predict = cnn_model(images)
        cost = fluid.layers.cross_entropy(input=predict, label=label)
        avg_cost = fluid.layers.mean(cost)
        batch_acc = fluid.layers.accuracy(input=predict, label=label)
        if use_adam:
            opt = fluid.optimizer.AdamOptimizer(
                learning_rate=lr, beta1=0.9, beta2=0.999)
        else:
            opt = fluid.optimizer.Momentum(learning_rate=lr, momentum=0.9)
        opt.minimize(avg_cost)
    return main, startup, [images, label], avg_cost, batch_acc, predict
