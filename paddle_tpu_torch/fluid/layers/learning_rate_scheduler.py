"""In-graph learning-rate schedules, after
paddle_tpu/fluid/layers/learning_rate_scheduler.py: a persistable step
counter advanced by an `increment` op at the head of the program, and
`piecewise_decay` built from fill_constant, less_than and where as the
JAX package builds it.  The other schedules are not ported."""

from ..initializer import Constant
from ..layer_helper import LayerHelper
from . import nn, tensor

__all__ = ["autoincreased_step_counter", "piecewise_decay"]

LR_COUNTER_NAME = "@LR_DECAY_COUNTER@"


def _decay_step_counter(begin=0):
    """The shared LR counter: begin on the first step, one more on each
    step after."""
    return autoincreased_step_counter(counter_name=LR_COUNTER_NAME,
                                      begin=begin, step=1)


def _less_than(x, y):
    """x < y as the JAX package's `Variable.__lt__` emits it."""
    helper = LayerHelper("less_than")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="less_than", inputs={"X": x, "Y": y},
                     outputs={"Out": out}, attrs={"axis": -1})
    return out


def piecewise_decay(boundaries, values):
    """values[i] while the step counter is below boundaries[i] (and past
    every earlier one), values[-1] after the last."""
    if len(values) - len(boundaries) != 1:
        raise ValueError("piecewise_decay: %d values for %d boundaries"
                         % (len(values), len(boundaries)))
    global_step = _decay_step_counter()
    lr = tensor.fill_constant([1], "float32", float(values[-1]))
    for i in reversed(range(len(boundaries))):
        bound = tensor.fill_constant([1], "float32", float(boundaries[i]))
        is_before = _less_than(global_step, bound)
        val = tensor.fill_constant([1], "float32", float(values[i]))
        lr = nn.where(is_before, val, lr)
    return lr


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """A persistable float32 [1] counter that reads `begin` on the first
    run and advances by `step` per run: initialised to begin - step, its
    `increment` op prepended to the program once, at first creation
    (a later call returns the same var, with no second increment)."""
    name = counter_name or "@STEP_COUNTER@"
    helper = LayerHelper("global_step_counter")
    gb = helper.main_program.global_block()
    if gb.has_var(name):
        counter = gb.var(name)
        counter.stop_gradient = True
        return counter
    counter = helper.create_global_variable(
        name=name, dtype="float32", shape=[1], persistable=True,
        stop_gradient=True)
    helper.set_variable_initializer(counter, Constant(float(begin) - step))
    gb._prepend_op(
        type="increment", inputs={"X": [counter.name]},
        outputs={"Out": [counter.name]}, attrs={"step": float(step)})
    counter.stop_gradient = True
    return counter
