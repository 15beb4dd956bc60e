"""VGG-16 with batch norm and dropout, a copy of paddle_tpu/models/vgg.py
(the reference benchmark/fluid/models/vgg.py): five conv groups, each
conv followed by batch norm and dropout, then two fc-512 heads and an fc
softmax, trained with Adam; CIFAR-10 (32 x 32) or flowers (224 x 224).
The same layer calls, names and op list as the JAX package."""

import paddle_tpu_torch.fluid as fluid


def vgg16_bn_drop(input, is_train=True):
    def conv_block(ipt, num_filter, groups, dropouts):
        return fluid.nets.img_conv_group(
            input=ipt, pool_size=2, pool_stride=2,
            conv_num_filter=[num_filter] * groups, conv_filter_size=3,
            conv_act="relu", conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=dropouts, pool_type="max")

    conv1 = conv_block(input, 64, 2, [0.3, 0])
    conv2 = conv_block(conv1, 128, 2, [0.4, 0])
    conv3 = conv_block(conv2, 256, 3, [0.4, 0.4, 0])
    conv4 = conv_block(conv3, 512, 3, [0.4, 0.4, 0])
    conv5 = conv_block(conv4, 512, 3, [0.4, 0.4, 0])

    drop = fluid.layers.dropout(x=conv5, dropout_prob=0.5,
                                is_test=not is_train)
    fc1 = fluid.layers.fc(input=drop, size=512, act=None)
    bn = fluid.layers.batch_norm(input=fc1, act="relu",
                                 is_test=not is_train)
    drop2 = fluid.layers.dropout(x=bn, dropout_prob=0.5,
                                 is_test=not is_train)
    fc2 = fluid.layers.fc(input=drop2, size=512, act=None)
    return fc2


def get_model(batch_size=128, class_dim=10, dataset="cifar10", lr=1e-3,
              is_train=True):
    """(main, startup, feeds, loss, acc, predict), as the JAX package's
    get_model; the `data` feed is NCHW."""
    main, startup = fluid.Program(), fluid.Program()
    image_shape = [3, 32, 32] if dataset == "cifar10" else [3, 224, 224]
    with fluid.program_guard(main, startup):
        image = fluid.layers.data(name="data", shape=image_shape,
                                  dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        net = vgg16_bn_drop(image, is_train=is_train)
        predict = fluid.layers.fc(input=net, size=class_dim, act="softmax")
        cost = fluid.layers.cross_entropy(input=predict, label=label)
        avg_cost = fluid.layers.mean(cost)
        batch_acc = fluid.layers.accuracy(input=predict, label=label)
        if is_train:
            opt = fluid.optimizer.Adam(learning_rate=lr)
            opt.minimize(avg_cost)
    return main, startup, [image, label], avg_cost, batch_acc, predict
