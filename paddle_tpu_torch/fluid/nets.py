"""Composed nets, after paddle_tpu/fluid/nets.py: simple_img_conv_pool,
img_conv_group, sequence_conv_pool, glu and
scaled_dot_product_attention."""

from . import layers

__all__ = ["simple_img_conv_pool", "img_conv_group", "sequence_conv_pool",
           "glu", "scaled_dot_product_attention"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1, conv_padding=0,
                         conv_dilation=1, conv_groups=1, param_attr=None,
                         bias_attr=None, act=None, use_cudnn=True):
    conv_out = layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        stride=conv_stride, padding=conv_padding, dilation=conv_dilation,
        groups=conv_groups, param_attr=param_attr, bias_attr=bias_attr,
        act=act, use_cudnn=use_cudnn)
    return layers.pool2d(
        input=conv_out, pool_size=pool_size, pool_type=pool_type,
        pool_stride=pool_stride, pool_padding=pool_padding,
        global_pooling=global_pooling, use_cudnn=use_cudnn)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    """conv (+ batch_norm and dropout) per entry of `conv_num_filter`,
    then one pool; a scalar option applies to every conv."""
    if not isinstance(conv_num_filter, (list, tuple)):
        raise TypeError("img_conv_group: conv_num_filter must be a list "
                        "or tuple")

    def _expand(obj):
        if not hasattr(obj, "__len__"):
            return [obj] * len(conv_num_filter)
        return obj

    conv_padding = _expand(conv_padding)
    conv_filter_size = _expand(conv_filter_size)
    param_attr = _expand(param_attr)
    conv_with_batchnorm = _expand(conv_with_batchnorm)
    conv_batchnorm_drop_rate = _expand(conv_batchnorm_drop_rate)

    tmp = input
    for i in range(len(conv_num_filter)):
        local_conv_act = None if conv_with_batchnorm[i] else conv_act
        tmp = layers.conv2d(
            input=tmp, num_filters=conv_num_filter[i],
            filter_size=conv_filter_size[i], padding=conv_padding[i],
            param_attr=param_attr[i], act=local_conv_act,
            use_cudnn=use_cudnn)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            drop_rate = conv_batchnorm_drop_rate[i]
            if abs(drop_rate) > 1e-5:
                tmp = layers.dropout(x=tmp, dropout_prob=drop_rate)
    return layers.pool2d(input=tmp, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride,
                         use_cudnn=use_cudnn)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max"):
    """sequence_conv then sequence_pool (`pool_type`) over each
    sequence."""
    conv_out = layers.sequence_conv(
        input=input, num_filters=num_filters, filter_size=filter_size,
        param_attr=param_attr, act=act)
    return layers.sequence_pool(input=conv_out, pool_type=pool_type)


def glu(input, dim=-1):
    """The gated linear unit: input split in two halves a, b along `dim`,
    a * sigmoid(b)."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(x=a, y=layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Multi-head attention over [B, T, D] queries, keys and values:
    heads split from D, softmax(q k^T / sqrt(D / num_heads)) v per head
    (matmul, softmax and, with `dropout_rate`, dropout ops), the heads
    joined back to [B, T, D]."""
    if queries.shape[-1] % num_heads != 0:
        raise ValueError("hidden size must divide num_heads")

    def split_heads(x):
        if num_heads == 1:
            return x
        b, t = x.shape[0], x.shape[1]
        reshaped = layers.reshape(
            x, shape=[b if b > 0 else -1, t, num_heads,
                      x.shape[-1] // num_heads])
        return layers.transpose(reshaped, perm=[0, 2, 1, 3])

    def combine_heads(x):
        if num_heads == 1:
            return x
        trans = layers.transpose(x, perm=[0, 2, 1, 3])
        return layers.reshape(
            trans, shape=[trans.shape[0] if trans.shape[0] > 0 else -1,
                          trans.shape[1],
                          trans.shape[2] * trans.shape[3]])

    q, k, v = split_heads(queries), split_heads(keys), split_heads(values)
    key_dim = float(queries.shape[-1] // num_heads)
    scaled_q = layers.scale(x=q, scale=key_dim ** -0.5)
    product = layers.matmul(x=scaled_q, y=k, transpose_y=True)
    weights = layers.softmax(product)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate,
                                 is_test=False)
    ctx_multiheads = layers.matmul(weights, v)
    return combine_heads(ctx_multiheads)
