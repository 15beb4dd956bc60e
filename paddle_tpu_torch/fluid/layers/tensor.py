"""Tensor creation layers, after paddle_tpu/fluid/layers/tensor.py."""

from ..initializer import Constant
from ..layer_helper import LayerHelper

__all__ = ["create_global_var", "fill_constant"]


def create_global_var(shape, value, dtype, persistable=False, name=None):
    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(
        dtype=dtype, shape=shape, persistable=persistable,
        name=name, stop_gradient=True)
    helper.set_variable_initializer(var, Constant(value))
    return var


def fill_constant(shape, dtype, value, out=None):
    helper = LayerHelper("fill_constant")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="fill_constant", outputs={"Out": out},
                     attrs={"shape": list(shape), "dtype": out.dtype,
                            "value": float(value)})
    out.stop_gradient = True
    return out
