"""Unary activation layers, after paddle_tpu/fluid/layers/ops.py, which
generates one layer function per unary op type (attrs as keywords),
plus thresholded_relu and cumsum."""

from ..layer_helper import LayerHelper

_UNARY_OPS = [
    "sigmoid", "logsigmoid", "exp", "tanh", "tanh_shrink", "softshrink",
    "sqrt", "rsqrt", "abs", "ceil", "floor", "cos", "sin", "round",
    "reciprocal", "log", "square", "softplus", "softsign", "hard_shrink",
    "gelu", "erf", "logical_not",
]

__all__ = list(_UNARY_OPS) + ["cumsum", "thresholded_relu"]


def _make_unary(op_type):
    def layer(x, name=None, **attrs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(type=op_type, inputs={"X": x},
                         outputs={"Out": out}, attrs=attrs)
        return out
    layer.__name__ = op_type
    layer.__doc__ = "%s activation (ops/math_ops.py)" % op_type
    return layer


for _op in _UNARY_OPS:
    globals()[_op] = _make_unary(_op)


_thresholded_relu = _make_unary("thresholded_relu")


def thresholded_relu(x, threshold=1.0):
    return _thresholded_relu(x, threshold=threshold)


def cumsum(x, axis=None, exclusive=None, reverse=None):
    from . import nn
    return nn.cumsum(x, axis, exclusive, reverse)
