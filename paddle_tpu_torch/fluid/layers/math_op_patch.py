"""Operator overloading on Variable, after
paddle_tpu/fluid/layers/math_op_patch.py: `a + b`, `2.0 * a`, `a ** -0.5`,
`a < b` and the rest append the elementwise or compare op the JAX package
appends (a Python number becomes a [1] fill_constant of the Variable's
dtype), so the LR schedules build the same programs in both packages."""

from ..framework import Variable
from ..layer_helper import LayerHelper

__all__ = ["monkey_patch_variable"]


def monkey_patch_variable():
    def create_scalar(value, dtype):
        from . import tensor
        return tensor.fill_constant([1], dtype, value)

    def _elemwise(op_type, reverse=False):
        def impl(self, other):
            if isinstance(other, (int, float)):
                other = create_scalar(other, self.dtype)
            lhs, rhs = (other, self) if reverse else (self, other)
            helper = LayerHelper(op_type)
            out = helper.create_variable_for_type_inference(lhs.dtype)
            helper.append_op(type=op_type, inputs={"X": lhs, "Y": rhs},
                             outputs={"Out": out}, attrs={"axis": -1})
            return out
        return impl

    Variable.__add__ = _elemwise("elementwise_add")
    Variable.__radd__ = _elemwise("elementwise_add", reverse=True)
    Variable.__sub__ = _elemwise("elementwise_sub")
    Variable.__rsub__ = _elemwise("elementwise_sub", reverse=True)
    Variable.__mul__ = _elemwise("elementwise_mul")
    Variable.__rmul__ = _elemwise("elementwise_mul", reverse=True)
    Variable.__truediv__ = _elemwise("elementwise_div")
    Variable.__rtruediv__ = _elemwise("elementwise_div", reverse=True)
    Variable.__div__ = Variable.__truediv__
    Variable.__pow__ = _elemwise("elementwise_pow")
    Variable.__rpow__ = _elemwise("elementwise_pow", reverse=True)
    Variable.__mod__ = _elemwise("elementwise_mod")
    Variable.__lt__ = _elemwise("less_than")
    Variable.__le__ = _elemwise("less_equal")
    Variable.__gt__ = _elemwise("greater_than")
    Variable.__ge__ = _elemwise("greater_equal")

    def _neg(self):
        from . import nn
        return nn.scale(self, scale=-1.0)

    Variable.__neg__ = _neg
