"""Optimizer update op lowerings, after paddle_tpu/ops/optimizer_ops.py:
adam.  Each update is a pure function of its inputs; the Executor writes
ParamOut/Moment*Out back under the same names."""

import torch

from .registry import register_op


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
