"""Optimizer update op lowerings, after paddle_tpu/ops/optimizer_ops.py:
sgd, momentum (with its Nesterov case), lars_momentum, adam, adamax,
adagrad, decayed_adagrad, adadelta, rmsprop (centered too), ftrl,
proximal_gd, and average_accumulates (ModelAverage's window).  Each
update is a pure function of its inputs; the Executor writes ParamOut /
VelocityOut / Moment*Out ... back under the same names.

Sparse (SelectedRows) grads, from an embedding built with is_sparse=True
(fluid/selected_rows.py): sgd, adam (lazy: only the touched rows' moments
and params move) and adagrad update the merged rows alone, as the JAX
lowerings do; momentum densifies, as the JAX one does (its velocity is
dense).  The ops whose JAX lowering has no sparse path (lars_momentum,
adamax, decayed_adagrad, adadelta, rmsprop, ftrl, proximal_gd) densify
the grad too, so each gives what its dense program gives.  The JAX
package's multi-batch-merge gates on these ops wait for its
multi_batch_merge pass, which is not ported (fluid/ir_passes.py)."""

import torch

from ..fluid.selected_rows import SelectedRowsValue
from .registry import register_op


def _lr(ctx, p):
    return ctx.input("LearningRate").reshape(()).to(p.dtype)


def _is_sparse(g):
    return isinstance(g, SelectedRowsValue)


def _dense(g):
    """A grad as a dense tensor (a SelectedRows grad scattered)."""
    return g.to_dense() if _is_sparse(g) else g


def _row_index(sr):
    """The merged rows as gather/scatter indices, and the [K, 1] float
    mask of the entries in the table (padding ids clamp to the last row
    for gathers; their scatters are masked off)."""
    valid = sr.valid()
    idx = torch.clamp(sr.rows.long(), 0, sr.height - 1)
    return idx, valid


def _scatter_add(t, sr_idx, valid, vals):
    """t with vals added at rows sr_idx, the invalid entries dropped."""
    mask = valid.view((-1,) + (1,) * (vals.dim() - 1)).to(vals.dtype)
    return t.index_add(0, sr_idx, (vals * mask).to(t.dtype))


def _scatter_set(t, sr_idx, valid, vals):
    """t with rows sr_idx set to vals, the invalid entries dropped (sent
    to a scratch row past the end and cut off)."""
    idx = torch.where(valid, sr_idx, t.shape[0])
    ext = torch.cat([t, t.new_zeros((1,) + tuple(t.shape[1:]))])
    ext[idx] = vals.to(t.dtype)
    return ext[:t.shape[0]]


@register_op("sgd")
def _sgd(ctx):
    p, g = ctx.input("Param"), ctx.input("Grad")
    lr = _lr(ctx, p)
    if _is_sparse(g):
        sr = g.merged()
        idx, valid = _row_index(sr)
        return {"ParamOut": _scatter_add(p, idx, valid,
                                         -lr * sr.values.to(p.dtype))}
    return {"ParamOut": p - lr * g.to(p.dtype)}


@register_op("momentum")
def _momentum(ctx):
    p, v = ctx.input("Param"), ctx.input("Velocity")
    g = _dense(ctx.input("Grad"))  # the velocity is dense
    mu = ctx.attr("mu")
    lr = _lr(ctx, p)
    v_out = mu * v + g
    if ctx.attr("use_nesterov", False):
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    return {"ParamOut": p_out, "VelocityOut": v_out}


@register_op("lars_momentum")
def _lars_momentum(ctx):
    p, v = ctx.input("Param"), ctx.input("Velocity")
    g = _dense(ctx.input("Grad"))
    mu = ctx.attr("mu")
    lars_coeff = ctx.attr("lars_coeff", 0.001)
    lars_weight_decay = ctx.attr("lars_weight_decay", 0.0005)
    lr = _lr(ctx, p)
    p_norm = torch.sqrt(torch.sum(torch.square(p)))
    g_norm = torch.sqrt(torch.sum(torch.square(g)))
    local_lr = torch.where(
        (p_norm > 0) & (g_norm > 0),
        lr * lars_coeff * p_norm / (g_norm + lars_weight_decay * p_norm),
        lr)
    v_out = mu * v + local_lr * (g + lars_weight_decay * p)
    return {"ParamOut": p - v_out, "VelocityOut": v_out}


@register_op("adam")
def _adam(ctx):
    p, g = ctx.input("Param"), ctx.input("Grad")
    m1, m2 = ctx.input("Moment1"), ctx.input("Moment2")
    b1p, b2p = ctx.input("Beta1Pow"), ctx.input("Beta2Pow")
    beta1, beta2 = ctx.attr("beta1", 0.9), ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    lr = ctx.input("LearningRate").reshape(())
    lr_t = lr * torch.sqrt(1 - b2p.reshape(())) / (1 - b1p.reshape(()))
    if _is_sparse(g):
        # lazy sparse adam: only the touched rows' moments and params move
        sr = g.merged()
        idx, valid = _row_index(sr)
        vals = sr.values
        m1r = beta1 * m1[idx] + (1 - beta1) * vals
        m2r = beta2 * m2[idx] + (1 - beta2) * torch.square(vals)
        upd = -lr_t.to(p.dtype) * (m1r / (torch.sqrt(m2r) + eps))
        return {"ParamOut": _scatter_add(p, idx, valid, upd),
                "Moment1Out": _scatter_set(m1, idx, valid, m1r),
                "Moment2Out": _scatter_set(m2, idx, valid, m2r)}
    m1_out = beta1 * m1 + (1 - beta1) * g
    m2_out = beta2 * m2 + (1 - beta2) * torch.square(g)
    p_out = p - lr_t.to(p.dtype) * (m1_out / (torch.sqrt(m2_out) + eps))
    return {"ParamOut": p_out, "Moment1Out": m1_out, "Moment2Out": m2_out}


@register_op("adamax")
def _adamax(ctx):
    p, g = ctx.input("Param"), _dense(ctx.input("Grad"))
    m, inf = ctx.input("Moment"), ctx.input("InfNorm")
    b1p = ctx.input("Beta1Pow")
    beta1, beta2 = ctx.attr("beta1", 0.9), ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    lr = ctx.input("LearningRate").reshape(())
    m_out = beta1 * m + (1 - beta1) * g
    # epsilon inside the max, as the JAX lowering (and adamax_op.h) has it
    inf_out = torch.maximum(torch.abs(g), beta2 * inf + eps)
    lr_t = lr / (1 - b1p.reshape(()))
    p_out = p - lr_t.to(p.dtype) * m_out / inf_out
    return {"ParamOut": p_out, "MomentOut": m_out, "InfNormOut": inf_out}


@register_op("adagrad")
def _adagrad(ctx):
    p, g, m = ctx.input("Param"), ctx.input("Grad"), ctx.input("Moment")
    eps = ctx.attr("epsilon", 1e-6)
    lr = _lr(ctx, p)
    if _is_sparse(g):
        sr = g.merged()
        idx, valid = _row_index(sr)
        vals = sr.values
        mr = m[idx] + torch.square(vals)
        return {"ParamOut": _scatter_add(p, idx, valid,
                                         -lr * vals / (torch.sqrt(mr) + eps)),
                "MomentOut": _scatter_set(m, idx, valid, mr)}
    m_out = m + torch.square(g)
    return {"ParamOut": p - lr * g / (torch.sqrt(m_out) + eps),
            "MomentOut": m_out}


@register_op("decayed_adagrad")
def _decayed_adagrad(ctx):
    p, g = ctx.input("Param"), _dense(ctx.input("Grad"))
    m = ctx.input("Moment")
    decay = ctx.attr("decay", 0.95)
    eps = ctx.attr("epsilon", 1e-6)
    m_out = decay * m + (1 - decay) * torch.square(g)
    p_out = p - _lr(ctx, p) * g / (torch.sqrt(m_out) + eps)
    return {"ParamOut": p_out, "MomentOut": m_out}


@register_op("adadelta")
def _adadelta(ctx):
    p, g = ctx.input("Param"), _dense(ctx.input("Grad"))
    avg_sq_g = ctx.input("AvgSquaredGrad")
    avg_sq_u = ctx.input("AvgSquaredUpdate")
    rho = ctx.attr("rho", 0.95)
    eps = ctx.attr("epsilon", 1e-6)
    avg_sq_g_out = rho * avg_sq_g + (1 - rho) * torch.square(g)
    update = -torch.sqrt((avg_sq_u + eps) / (avg_sq_g_out + eps)) * g
    avg_sq_u_out = rho * avg_sq_u + (1 - rho) * torch.square(update)
    return {"ParamOut": p + update, "AvgSquaredGradOut": avg_sq_g_out,
            "AvgSquaredUpdateOut": avg_sq_u_out}


@register_op("rmsprop")
def _rmsprop(ctx):
    p, g = ctx.input("Param"), _dense(ctx.input("Grad"))
    ms, mom = ctx.input("MeanSquare"), ctx.input("Moment")
    rho = ctx.attr("decay", 0.95)
    eps = ctx.attr("epsilon", 1e-6)
    momentum = ctx.attr("momentum", 0.0)
    lr = _lr(ctx, p)
    outs = {}
    ms_out = rho * ms + (1 - rho) * torch.square(g)
    if ctx.attr("centered", False):
        mg_out = rho * ctx.input("MeanGrad") + (1 - rho) * g
        denom = ms_out - torch.square(mg_out) + eps
        outs["MeanGradOut"] = mg_out
    else:
        denom = ms_out + eps
    mom_out = momentum * mom + lr * g / torch.sqrt(denom)
    outs.update({"ParamOut": p - mom_out, "MeanSquareOut": ms_out,
                 "MomentOut": mom_out})
    return outs


@register_op("ftrl")
def _ftrl(ctx):
    p, g = ctx.input("Param"), _dense(ctx.input("Grad"))
    sq_accum = ctx.input("SquaredAccumulator")
    lin_accum = ctx.input("LinearAccumulator")
    l1, l2 = ctx.attr("l1", 0.0), ctx.attr("l2", 0.0)
    lr_power = ctx.attr("lr_power", -0.5)
    lr = _lr(ctx, p)
    new_accum = sq_accum + torch.square(g)
    if lr_power == -0.5:
        lin_delta = g - (torch.sqrt(new_accum) - torch.sqrt(sq_accum)) / lr * p
        x = 2 * l2 + torch.sqrt(new_accum) / lr
    else:
        lin_delta = g - (new_accum ** (-lr_power)
                         - sq_accum ** (-lr_power)) / lr * p
        x = 2 * l2 + new_accum ** (-lr_power) / lr
    lin_out = lin_accum + lin_delta
    pre_shrink = (torch.sign(lin_out) * l1 - lin_out) / x
    p_out = torch.where(torch.abs(lin_out) > l1, pre_shrink,
                        torch.zeros_like(p))
    return {"ParamOut": p_out, "SquaredAccumOut": new_accum,
            "LinearAccumOut": lin_out}


@register_op("proximal_gd")
def _proximal_gd(ctx):
    p, g = ctx.input("Param"), _dense(ctx.input("Grad"))
    l1, l2 = ctx.attr("l1", 0.0), ctx.attr("l2", 0.0)
    lr = _lr(ctx, p)
    prox = p - lr * g
    p_out = torch.sign(prox) * torch.clamp(torch.abs(prox) - lr * l1,
                                           min=0.0) / (1.0 + lr * l2)
    return {"ParamOut": p_out}


# kMaxNumAccumulates of average_accumulates_op.h
_K_MAX_ACCUMULATES = 16384


@register_op("average_accumulates")
def _average_accumulates(ctx):
    """ModelAverage's sliding window (average_accumulates_op.h): sum_1
    takes each step's param, rolls into sum_2 every kMaxNumAccumulates
    updates, and everything rolls into sum_3 (the window restarting) once
    the window passes its min and its size min(max_window, num_updates *
    average_window), that product truncated toward zero as the C++ does.
    Branch-free, as the JAX lowering."""
    p = ctx.input("param")
    s1, s2, s3 = (ctx.input("in_sum_%d" % i) for i in (1, 2, 3))
    num_acc = ctx.input("in_num_accumulates").reshape(())
    old_num = ctx.input("in_old_num_accumulates").reshape(())
    num_upd = ctx.input("in_num_updates").reshape(())
    counter_dtype = num_acc.dtype
    num_acc, old_num, num_upd = (t.to(torch.int32)
                                 for t in (num_acc, old_num, num_upd))
    avg_window = float(ctx.attr("average_window", 0.0))
    max_w = int(ctx.attr("max_average_window", 10000))
    min_w = int(ctx.attr("min_average_window", 10000))

    num_upd = num_upd + 1
    num_acc = num_acc + 1
    s1 = s1 + p.to(s1.dtype)
    move = (num_upd % _K_MAX_ACCUMULATES) == 0
    s2 = torch.where(move, s2 + s1, s2)
    s1 = torch.where(move, torch.zeros_like(s1), s1)
    window = torch.minimum(
        torch.tensor(max_w, dtype=torch.int32, device=p.device),
        torch.floor(num_upd.to(torch.float32)
                    * torch.tensor(avg_window, dtype=torch.float32))
        .to(torch.int32))
    roll = (num_acc >= min_w) & (num_acc >= window)
    s3 = torch.where(roll, s1 + s2, s3)
    s1 = torch.where(roll, torch.zeros_like(s1), s1)
    s2 = torch.where(roll, torch.zeros_like(s2), s2)
    old_num = torch.where(roll, num_acc, old_num)
    num_acc = torch.where(roll, torch.zeros_like(num_acc), num_acc)
    return {"out_sum_1": s1, "out_sum_2": s2, "out_sum_3": s3,
            "out_num_accumulates": num_acc.reshape((1,)).to(counter_dtype),
            "out_old_num_accumulates":
                old_num.reshape((1,)).to(counter_dtype),
            "out_num_updates": num_upd.reshape((1,)).to(counter_dtype)}
