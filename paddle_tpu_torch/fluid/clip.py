"""Gradient and error clipping, after paddle_tpu/fluid/clip.py: value,
norm and global-norm clipping of parameter gradients, appended as ops
before the optimizer's update (Optimizer.apply_gradients: clipping, then
regularization), and error clipping of a variable's gradient right after
the op that writes it (append_backward calls error_clip_callback)."""

from . import layers
from .framework import Variable, default_main_program
from .layer_helper import LayerHelper

__all__ = ["ErrorClipByValue", "GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm", "set_gradient_clip",
           "append_gradient_clip_ops", "error_clip_callback"]


class BaseErrorClipAttr:
    def _append_clip_op(self, block, grad_name):
        raise NotImplementedError


class ErrorClipByValue(BaseErrorClipAttr):
    """Clip a variable's gradient to [min, max] (min defaults to -max)."""

    def __init__(self, max, min=None):
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max

    def _append_clip_op(self, block, grad_name):
        block.append_op(type="clip", inputs={"X": grad_name},
                        outputs={"Out": grad_name},
                        attrs={"min": self.min, "max": self.max},
                        infer_shape=False)

    def _insert_clip_op(self, block, idx, grad_name):
        block._insert_op(idx, type="clip", inputs={"X": [grad_name]},
                         outputs={"Out": [grad_name]},
                         attrs={"min": self.min, "max": self.max})


class BaseGradientClipAttr:
    def _process_context(self, context, param, grad):
        raise NotImplementedError

    def _create_operators(self, param, grad):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    def _process_context(self, context, param, grad):
        pass

    def _create_operators(self, param, grad):
        return param, grad


class GradientClipByValue(BaseGradientClipAttr):
    """Each gradient element clipped to [min, max]."""

    def __init__(self, max, min=None):
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max

    def _process_context(self, context, param, grad):
        pass

    def _create_operators(self, param, grad):
        return param, layers.clip(x=grad, min=self.min, max=self.max)


class GradientClipByNorm(BaseGradientClipAttr):
    """Each gradient scaled to an L2 norm of at most clip_norm."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _process_context(self, context, param, grad):
        pass

    def _create_operators(self, param, grad):
        return param, layers.clip_by_norm(x=grad, max_norm=self.clip_norm)


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """Every gradient of a group scaled by clip_norm / max(global_norm,
    clip_norm), the global norm over the whole group's gradients."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _process_context(self, context, param, grad):
        if self.group_name not in context:
            context[self.group_name] = []
            context[self.group_name + "_clip_value"] = self.clip_norm
        elif context[self.group_name + "_clip_value"] != self.clip_norm:
            raise ValueError("all parameters in a group should share the "
                             "same clip norm")
        context[self.group_name].append(_squared_l2_norm(grad))
        self.context = context

    def _create_operators(self, param, grad):
        group_scale_name = self.group_name + "_scale"
        if group_scale_name not in self.context:
            group_norm = layers.sums(input=self.context[self.group_name])
            group_norm = layers.sqrt(x=group_norm)
            clip_var = layers.fill_constant(shape=[1], dtype="float32",
                                            value=self.clip_norm)
            group_scale = layers.elementwise_div(
                x=clip_var,
                y=layers.elementwise_max(x=clip_var, y=group_norm))
            self.context[group_scale_name] = group_scale
        return param, layers.elementwise_mul(
            x=grad, y=self.context[group_scale_name])


def _squared_l2_norm(grad):
    helper = LayerHelper("squared_l2_norm")
    out = helper.create_variable_for_type_inference(grad.dtype)
    helper.append_op(type="squared_l2_norm", inputs={"X": grad},
                     outputs={"Out": out}, infer_shape=False)
    return out


def set_gradient_clip(clip, param_list=None, program=None):
    """Give `clip` to the parameters of `program` (its every parameter by
    default; the default main program when none is given)."""
    if program is None:
        program = default_main_program()
    if param_list is None:
        param_list = program.global_block().all_parameters()
    for p in param_list:
        name = p.name if isinstance(p, Variable) else p
        program.global_block().var(name).gradient_clip_attr = clip


def error_clip_callback(block, context):
    """A clip op right after each op that writes the gradient of a var
    with an `error_clip`, so the grad ops that read it later, in block
    order, see the clipped value."""
    i = 0
    while i < len(block.ops):
        op = block.ops[i]
        inserted = 0
        for grad_n in op.output_arg_names:
            if not grad_n.endswith("@GRAD"):
                continue
            fwd_var = block._find_var_recursive(grad_n[:-5])
            if fwd_var is None:
                continue
            error_clip = getattr(fwd_var, "error_clip", None)
            if error_clip is not None:
                error_clip._insert_clip_op(block, i + 1 + inserted, grad_n)
                inserted += 1
        i += 1 + inserted  # past the clip ops just inserted


def append_gradient_clip_ops(param_grads):
    """[(param, grad)] with each clipped grad in its grad's place; as
    given where no parameter has a clip."""
    context = {}
    any_clip = False
    for p, g in param_grads:
        if g is None:
            continue
        clip_attr = getattr(p, "gradient_clip_attr", None)
        if clip_attr is None:
            clip_attr = NullGradientClipAttr()
        if not isinstance(clip_attr, NullGradientClipAttr):
            any_clip = True
        clip_attr._process_context(context, p, g)
    if not any_clip:
        return param_grads
    clipped = []
    for p, g in param_grads:
        clip_attr = getattr(p, "gradient_clip_attr", None)
        if g is None or clip_attr is None or \
                isinstance(clip_attr, NullGradientClipAttr):
            clipped.append((p, g))
        else:
            clipped.append(clip_attr._create_operators(p, g))
    return clipped
