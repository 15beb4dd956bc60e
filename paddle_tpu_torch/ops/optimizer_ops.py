"""Optimizer update op lowerings, after paddle_tpu/ops/optimizer_ops.py:
sgd, momentum (with its Nesterov case) and adam.  Each update is a pure
function of its inputs; the Executor writes ParamOut / VelocityOut /
Moment*Out back under the same names.  Grads are dense: a SelectedRows
(sparse embedding) grad is not ported, and the `lookup_table` grad that
would make one raises first."""

import torch

from .registry import register_op


def _lr(ctx, p):
    return ctx.input("LearningRate").reshape(()).to(p.dtype)


def _dense(g, op_type):
    if not isinstance(g, torch.Tensor):
        raise NotImplementedError(
            "%s: a sparse (SelectedRows) grad is not ported to "
            "paddle_tpu_torch yet" % op_type)
    return g


@register_op("sgd")
def _sgd(ctx):
    p = ctx.input("Param")
    g = _dense(ctx.input("Grad"), "sgd")
    return {"ParamOut": p - _lr(ctx, p) * g.to(p.dtype)}


@register_op("momentum")
def _momentum(ctx):
    p, v = ctx.input("Param"), ctx.input("Velocity")
    g = _dense(ctx.input("Grad"), "momentum")
    mu = ctx.attr("mu")
    lr = _lr(ctx, p)
    v_out = mu * v + g
    if ctx.attr("use_nesterov", False):
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    return {"ParamOut": p_out, "VelocityOut": v_out}


@register_op("adam")
def _adam(ctx):
    p, g = ctx.input("Param"), ctx.input("Grad")
    m1, m2 = ctx.input("Moment1"), ctx.input("Moment2")
    b1p, b2p = ctx.input("Beta1Pow"), ctx.input("Beta2Pow")
    beta1, beta2 = ctx.attr("beta1", 0.9), ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    lr = ctx.input("LearningRate").reshape(())
    m1_out = beta1 * m1 + (1 - beta1) * g
    m2_out = beta2 * m2 + (1 - beta2) * torch.square(g)
    lr_t = lr * torch.sqrt(1 - b2p.reshape(())) / (1 - b1p.reshape(()))
    p_out = p - lr_t.to(p.dtype) * (m1_out / (torch.sqrt(m2_out) + eps))
    return {"ParamOut": p_out, "Moment1Out": m1_out, "Moment2Out": m2_out}
