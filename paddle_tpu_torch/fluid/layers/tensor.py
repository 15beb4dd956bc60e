"""Tensor creation layers, after paddle_tpu/fluid/layers/tensor.py."""

from .. import core
from ..framework import Variable
from ..initializer import Constant
from ..layer_helper import LayerHelper

__all__ = ["create_global_var", "create_parameter", "fill_constant",
           "fill_constant_batch_size_like", "cast", "concat", "sums",
           "assign", "zeros", "zeros_like"]


def create_global_var(shape, value, dtype, persistable=False, name=None):
    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(
        dtype=dtype, shape=shape, persistable=persistable,
        name=name, stop_gradient=True)
    helper.set_variable_initializer(var, Constant(value))
    return var


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    from ..param_attr import ParamAttr
    helper = LayerHelper("create_parameter", name=name)
    if attr is None:
        attr = ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    """`force_cpu` is taken for the JAX package's signature; the value
    lives on the Executor's device."""
    helper = LayerHelper("fill_constant")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="fill_constant", outputs={"Out": out},
                     attrs={"shape": list(shape), "dtype": out.dtype,
                            "value": float(value)})
    out.stop_gradient = True
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="fill_constant_batch_size_like",
                     inputs={"Input": input}, outputs={"Out": out},
                     attrs={"shape": list(shape), "dtype": out.dtype,
                            "value": float(value),
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx})
    out.stop_gradient = True
    return out


def cast(x, dtype):
    helper = LayerHelper("cast")
    if not isinstance(dtype, int):
        dtype = core.convert_np_dtype_to_dtype_(dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="cast", inputs={"X": x}, outputs={"Out": out},
                     attrs={"in_dtype": x.dtype, "out_dtype": dtype})
    return out


def concat(input, axis=0, name=None):
    from . import nn
    return nn.concat(input, axis, name)


def sums(input, out=None):
    helper = LayerHelper("sum")
    if out is None:
        out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op(type="sum", inputs={"X": input}, outputs={"Out": out})
    return out


def assign(input, output=None):
    """Copy a Variable into `output` (a new var by default)."""
    if not isinstance(input, Variable):
        raise TypeError("assign: the port takes a Variable, got %s"
                        % type(input).__name__)
    helper = LayerHelper("assign")
    if output is None:
        output = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="assign", inputs={"X": input},
                     outputs={"Out": output})
    return output


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(shape=shape, dtype=dtype, value=0.0)


def zeros_like(x, out=None):
    helper = LayerHelper("zeros_like")
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="fill_zeros_like", inputs={"X": x},
                     outputs={"Out": out})
    out.stop_gradient = True
    return out
