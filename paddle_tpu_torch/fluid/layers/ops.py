"""Unary activation layers, after paddle_tpu/fluid/layers/ops.py, which
generates one layer function per unary op type: sigmoid, tanh, floor,
log, square and logical_not."""

from ..layer_helper import LayerHelper

_UNARY_OPS = ["sigmoid", "tanh", "floor", "log", "square", "logical_not"]

__all__ = list(_UNARY_OPS)


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
