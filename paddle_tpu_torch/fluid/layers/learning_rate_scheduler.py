"""In-graph learning-rate schedules, after
paddle_tpu/fluid/layers/learning_rate_scheduler.py: a persistable step
counter `@LR_DECAY_COUNTER@` advanced by an `increment` op at the head of
the program, and each schedule built over it from the ops the JAX package
appends (Variable operators, math_op_patch.py, and the unary layers), so
a schedule's program is the JAX package's op for op."""

import math

from ..initializer import Constant
from ..layer_helper import LayerHelper
from . import nn, ops, tensor

__all__ = [
    "autoincreased_step_counter", "append_LARS",
    "exponential_decay", "natural_exp_decay", "inverse_time_decay",
    "polynomial_decay", "piecewise_decay", "noam_decay", "cosine_decay",
    "linear_lr_warmup",
]

LR_COUNTER_NAME = "@LR_DECAY_COUNTER@"


def _decay_step_counter(begin=0):
    """The shared LR counter: begin on the first step, one more on each
    step after."""
    return autoincreased_step_counter(counter_name=LR_COUNTER_NAME,
                                      begin=begin, step=1)


def noam_decay(d_model, warmup_steps):
    """d_model^-0.5 * min(step^-0.5, warmup_steps^-1.5 * step), the
    counter starting at 1."""
    global_step = _decay_step_counter(1)
    a = global_step ** -0.5
    b = (warmup_steps ** -1.5) * global_step
    return (d_model ** -0.5) * nn.elementwise_min(a, b)


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    global_step = _decay_step_counter()
    div_res = global_step / float(decay_steps)
    if staircase:
        div_res = ops.floor(div_res)
    return learning_rate * (float(decay_rate) ** div_res)


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    global_step = _decay_step_counter()
    div_res = global_step / float(decay_steps)
    if staircase:
        div_res = ops.floor(div_res)
    return learning_rate * ops.exp(-1 * decay_rate * div_res)


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    global_step = _decay_step_counter()
    div_res = global_step / float(decay_steps)
    if staircase:
        div_res = ops.floor(div_res)
    return learning_rate / (1 + float(decay_rate) * div_res)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=1e-4,
                     power=1.0, cycle=False):
    """With `cycle` the decay restarts every decay_steps * ceil(step /
    decay_steps) steps; without it the step stops at decay_steps."""
    global_step = _decay_step_counter()
    if cycle:
        div_res = ops.ceil(global_step / float(decay_steps))
        tensor.fill_constant([1], "float32", 0.0)  # the JAX program's op
        one_var = tensor.fill_constant([1], "float32", 1.0)
        div_res = nn.elementwise_max(div_res, one_var)
        decay_steps_var = div_res * float(decay_steps)
    else:
        decay_steps_var = tensor.fill_constant([1], "float32",
                                               float(decay_steps))
        global_step = nn.elementwise_min(global_step, decay_steps_var)
    return (learning_rate - end_learning_rate) * \
        ((1 - global_step / decay_steps_var) ** power) + end_learning_rate


def piecewise_decay(boundaries, values):
    """values[i] while the step counter is below boundaries[i] (and past
    every earlier one), values[-1] after the last: compare and where ops,
    the whole schedule inside the step."""
    if len(values) - len(boundaries) != 1:
        raise ValueError("piecewise_decay: %d values for %d boundaries"
                         % (len(values), len(boundaries)))
    global_step = _decay_step_counter()
    lr = tensor.fill_constant([1], "float32", float(values[-1]))
    for i in reversed(range(len(boundaries))):
        bound = tensor.fill_constant([1], "float32", float(boundaries[i]))
        is_before = global_step < bound
        val = tensor.fill_constant([1], "float32", float(values[i]))
        lr = nn.where(is_before, val, lr)
    return lr


def cosine_decay(learning_rate, step_each_epoch, epochs):
    global_step = _decay_step_counter()
    cur_epoch = ops.floor(global_step / step_each_epoch)
    return learning_rate * 0.5 * (
        ops.cos(cur_epoch * math.pi / epochs) + 1)


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    """start_lr to end_lr linearly over warmup_steps, then learning_rate
    (a float or a schedule's Variable)."""
    global_step = _decay_step_counter()
    warmup_var = tensor.fill_constant([1], "float32", float(warmup_steps))
    before = global_step < warmup_var
    warm_lr = start_lr + (end_lr - start_lr) * global_step / float(
        warmup_steps)
    if isinstance(learning_rate, (float, int)):
        learning_rate = tensor.fill_constant([1], "float32",
                                             float(learning_rate))
    return nn.where(before, warm_lr, learning_rate)


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


def append_LARS(params_grads, learning_rate, weight_decay):
    """Per-parameter layer-adaptive rates, lr * ||w|| / (||g|| + wd *
    ||w||) (||g|| + ||w|| at wd 1): one decayed learning-rate Variable per
    (param, grad)."""
    def _balanced_weight(param_norm, grad_norm):
        if weight_decay == 1.0:
            return grad_norm + param_norm
        return grad_norm + weight_decay * param_norm

    out = []
    for param, grad in params_grads:
        param_lr = param.optimize_attr.get("learning_rate", 1.0) \
            if hasattr(param, "optimize_attr") else 1.0
        param_norm = ops.sqrt(nn.reduce_sum(ops.square(param)))
        grad_norm = ops.sqrt(nn.reduce_sum(ops.square(grad)))
        scaled = nn.scale(param_norm, scale=param_lr)
        if isinstance(learning_rate, (int, float)):
            scaled = nn.scale(scaled, scale=float(learning_rate))
        else:  # a schedule's Variable
            scaled = nn.elementwise_mul(scaled, learning_rate)
        out.append(nn.elementwise_div(
            scaled, _balanced_weight(param_norm, grad_norm)))
    return out
