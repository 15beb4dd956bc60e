"""Tensor creation layers, after paddle_tpu/fluid/layers/tensor.py."""

import numpy as np

from .. import core
from ..framework import Variable
from ..initializer import Constant
from ..layer_helper import LayerHelper

__all__ = ["create_tensor", "create_global_var", "create_parameter",
           "fill_constant", "fill_constant_batch_size_like", "cast",
           "concat", "sums", "sum", "assign", "ones", "zeros", "zeros_like",
           "reverse", "isfinite", "has_inf", "has_nan", "range", "linspace",
           "argmin", "argmax", "argsort"]


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.create_variable(name=helper.name, dtype=dtype,
                                  persistable=persistable)


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
    """Copy a Variable, or a float32 / int32 / int64 numpy array (an
    assign_value op), into `output` (a new var by default)."""
    helper = LayerHelper("assign")
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op(type="assign", inputs={"X": input},
                         outputs={"Out": output})
        return output
    if not isinstance(input, np.ndarray):
        raise TypeError("assign: takes a Variable or a numpy array, got %s"
                        % type(input).__name__)
    if input.dtype == np.float32:
        dtype, key = core.VarDesc.VarType.FP32, "fp32_values"
        values = [float(v) for v in input.flat]
    elif input.dtype in (np.int32, np.int64):
        wide = input.dtype == np.int64
        dtype = core.VarDesc.VarType.INT64 if wide \
            else core.VarDesc.VarType.INT32
        key = "int64_values" if wide else "int32_values"
        values = [int(v) for v in input.flat]
    else:
        raise TypeError("assign only accepts float32/int32/int64 arrays")
    if output is None:
        output = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="assign_value", outputs={"Out": output},
                     attrs={"dtype": dtype, "shape": list(input.shape),
                            key: values})
    return output


def ones(shape, dtype, force_cpu=False):
    return fill_constant(shape=shape, dtype=dtype, value=1.0)


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


def sum(x):
    """The elementwise sum of a Variable list (the sum op)."""
    return sums(x if isinstance(x, (list, tuple)) else [x])


def reverse(x, axis):
    helper = LayerHelper("reverse")
    if isinstance(axis, int):
        axis = [axis]
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="reverse", inputs={"X": x}, outputs={"Out": out},
                     attrs={"axis": axis})
    return out


def _bool_check(op_type, x):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(
        core.VarDesc.VarType.BOOL, stop_gradient=True)
    helper.append_op(type=op_type, inputs={"X": x}, outputs={"Out": out})
    return out


def isfinite(x):
    return _bool_check("isfinite", x)


def has_inf(x):
    return _bool_check("isinf", x)


def has_nan(x):
    return _bool_check("isnan", x)


def _scalar(v, dtype):
    return v if isinstance(v, Variable) else fill_constant([1], dtype, v)


def range(start, end, step, dtype):
    """The op's output is fp32 whatever `dtype`, as in the JAX package;
    `dtype` types the bounds' constants."""
    helper = LayerHelper("range")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="range",
                     inputs={"Start": _scalar(start, dtype),
                             "End": _scalar(end, dtype),
                             "Step": _scalar(step, dtype)},
                     outputs={"Out": out})
    return out


def linspace(start, stop, num, dtype):
    helper = LayerHelper("linspace")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="linspace",
                     inputs={"Start": _scalar(start, dtype),
                             "Stop": _scalar(stop, dtype),
                             "Num": _scalar(num, "int32")},
                     outputs={"Out": out})
    return out


def argmin(x, axis=0):
    from . import nn
    return nn.argmin(x, axis)


def argmax(x, axis=0):
    from . import nn
    return nn.argmax(x, axis)


def argsort(x, axis=-1, name=None):
    from . import nn
    return nn.argsort(x, axis, name)
