"""Control-flow layers, after paddle_tpu/fluid/layers/control_flow.py:
the step counter's `increment` and the compare `less_than` (the
sub-block layers wait for control flow, ROADMAP.md queue 1 item 13)."""

from .. import core
from ..layer_helper import LayerHelper

__all__ = ["increment", "less_than"]


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(
        x.dtype)
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)},
                     infer_shape=False)
    return out


def less_than(x, y, force_cpu=None, cond=None):
    helper = LayerHelper("less_than")
    if cond is None:
        cond = helper.create_variable_for_type_inference(
            core.VarDesc.VarType.BOOL, stop_gradient=True)
    helper.append_op(type="less_than", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [cond]})
    return cond
