"""NN op lowerings, after paddle_tpu/ops/nn_ops.py: conv2d,
depthwise_conv2d, conv2d_transpose, pool2d, batch_norm, layer_norm,
group_norm, lrn, dropout, lookup_table (embedding), one_hot, pad, pad2d,
bilinear_interp, nearest_interp, the losses (softmax_with_cross_entropy,
cross_entropy, sigmoid_cross_entropy_with_logits, square_error_cost,
smooth_l1_loss, huber_loss, log_loss, hinge_loss, margin_rank_loss) and
accuracy.  The convolutions are cuDNN's through torch (the JAX package
runs them through lax.conv_*, outside any Pallas call).

Image ops take NCHW or NHWC activations (the `data_format` /
`data_layout` attr) with OIHW filters in either layout, as the JAX
package.  torch's convolutions and pools are NCHW: an NHWC tensor goes
in as its permuted view (on the card a channels-last NCHW tensor, which
cuDNN reads in place) and comes back permuted to NHWC.

Under a data-parallel group (ExecContext.group) batch_norm's training
statistics and accuracy's counts are those of the global batch, summed
over the ranks, as the JAX package's SPMD step computes them.
"""

import math

import torch
import torch.nn.functional as F

from ..parallel.mesh import all_reduce_sum
from .math_ops import jabs, jmax
from .registry import register_op, set_grad_maker


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _pads(ctx):
    """The (H, W) padding of a conv2d or pool2d: the first two entries of
    `paddings`, as the JAX lowerings read a four-element list."""
    return _pair(ctx.attr("paddings", [0, 0]))[:2]


def _img_layout(ctx):
    return ctx.attr("data_format", None) or ctx.attr("data_layout", None) \
        or "NCHW"


def _to_nchw(x, layout):
    return x.permute(0, 3, 1, 2) if layout == "NHWC" else x


def _from_nchw(x, layout):
    return x.permute(0, 2, 3, 1) if layout == "NHWC" else x


def conv2d_nchw(x, w, strides, pads, dilations, groups):
    """The convolution of the conv2d lowering on an NCHW (view of the)
    input with an OIHW filter; symmetric padding."""
    return F.conv2d(x, w.to(x.dtype), None, strides, pads, dilations,
                    groups)


@register_op("conv2d")
def _conv2d(ctx):
    x, w = ctx.input("Input"), ctx.input("Filter")
    layout = _img_layout(ctx)
    out = _from_nchw(conv2d_nchw(
        _to_nchw(x, layout), w, _pair(ctx.attr("strides", [1, 1])),
        _pads(ctx),
        _pair(ctx.attr("dilations", [1, 1])),
        int(ctx.attr("groups", 1) or 1)), layout)
    if ctx.has_input("Bias"):
        bshape = (1, 1, 1, -1) if layout == "NHWC" else (1, -1, 1, 1)
        out = out + ctx.input("Bias").reshape(bshape)
    return {"Output": out}


register_op("depthwise_conv2d")(_conv2d)


@register_op("conv2d_transpose")
def _conv2d_transpose(ctx):
    """The transposed convolution of an NCHW input with a [in_c, out_c /
    groups, kh, kw] filter: output extent (H - 1) s - 2 p + d (k - 1) + 1,
    as the JAX lowering's lax.conv_transpose with padding d (k - 1) - p."""
    x, w = ctx.input("Input"), ctx.input("Filter")
    groups = int(ctx.attr("groups", 1) or 1)
    if x.shape[1] % groups:
        raise ValueError("conv2d_transpose: input channels (%d) must be "
                         "divisible by groups (%d)" % (x.shape[1], groups))
    return {"Output": F.conv_transpose2d(
        x, w.to(x.dtype), None, _pair(ctx.attr("strides", [1, 1])),
        _pads(ctx), 0, groups,
        _pair(ctx.attr("dilations", [1, 1])))}


def _ceil_extra_pad(extent, k, s, p):
    """Extra high-side padding that gives the reference's ceil_mode output
    size with floor-mode windows (the JAX lowering's ceil_extra_pad)."""
    out_ceil = (extent + 2 * p - k + s - 1) // s + 1
    return max((out_ceil - 1) * s + k - (extent + 2 * p), 0)


def _unfold_sum(x, ksize, strides):
    return x.unfold(2, ksize[0], strides[0]).unfold(
        3, ksize[1], strides[1]).sum(dim=(-2, -1))


def _sequential_window_sum(x, ksize, strides):
    """The window sums with each window's elements added one at a time in
    row-major order, every partial sum rounded to x's dtype: one
    elementwise add per window element."""
    (kh, kw), (sh, sw) = ksize, strides
    Ho = (x.shape[2] - kh) // sh + 1
    Wo = (x.shape[3] - kw) // sw + 1
    if (Ho, Wo) == (1, 1):
        # one window: its taps as the leading dim, each a cheap select
        # ([N, C] rows in the same row-major order)
        taps = x[:, :, :kh, :kw].permute(2, 3, 0, 1).reshape(
            kh * kw, x.shape[0], x.shape[1])
        acc = taps[0]
        for k in range(1, kh * kw):
            acc = acc + taps[k]
        return acc[:, :, None, None]
    acc = None
    for i in range(kh):
        for j in range(kw):
            tap = x[:, :, i:i + sh * (Ho - 1) + 1:sh,
                    j:j + sw * (Wo - 1) + 1:sw]
            acc = tap if acc is None else acc + tap
    return acc


class _SequentialWindowSum(torch.autograd.Function):
    """_sequential_window_sum's values with the window sum's gradient
    (every element of a window gets the window's cotangent), computed in
    one pass: differentiating the adds one by one would materialize a
    full-size gradient per window element (3136 of them for a 56 x 56
    global pool)."""

    @staticmethod
    def forward(ctx, x, ksize, strides):
        ctx.shape, ctx.ksize, ctx.strides = x.shape, ksize, strides
        ctx.dtype, ctx.device = x.dtype, x.device
        return _sequential_window_sum(x, ksize, strides)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            z = torch.zeros(ctx.shape, dtype=ctx.dtype, device=ctx.device,
                            requires_grad=True)
            gx, = torch.autograd.grad(
                _unfold_sum(z, ctx.ksize, ctx.strides), z, g)
        return gx, None, None


def _window_sum(x, ksize, strides):
    """Sums over every (kh, kw) window of an NCHW tensor, no padding.  A
    16-bit float tensor sums as XLA's reduce_window does in that dtype
    (the JAX lowering's bf16 avg pool): the window's elements are added
    one at a time in row-major order, each partial sum rounded to the
    dtype (_SequentialWindowSum)."""
    if x.dtype not in (torch.bfloat16, torch.float16):
        return _unfold_sum(x, ksize, strides)
    return _SequentialWindowSum.apply(x, tuple(ksize), tuple(strides))


@register_op("pool2d")
def _pool2d(ctx):
    """Max or average pooling with the JAX lowering's window arithmetic:
    symmetric padding plus the ceil_mode extra on the high side; a
    padded average window divides by its count of real elements when
    `exclusive` (the default), else by kh * kw.  The average sums and
    divides in x's dtype (bf16 serving: see _window_sum)."""
    x = ctx.input("X")
    layout = _img_layout(ctx)
    xc = _to_nchw(x, layout)
    ptype = ctx.attr("pooling_type", "max")
    ksize = _pair(ctx.attr("ksize", [2, 2]))
    strides = _pair(ctx.attr("strides", [1, 1]))
    pads = _pads(ctx)
    ceil_mode = bool(ctx.attr("ceil_mode", False))
    if ctx.attr("global_pooling", False) or (
            ctx.attr("adaptive", False) and tuple(ksize) == (1, 1)):
        ksize = (xc.shape[2], xc.shape[3])
        strides, pads, ceil_mode = ksize, (0, 0), False
    extras = [_ceil_extra_pad(xc.shape[2 + i], ksize[i], strides[i],
                              pads[i]) if ceil_mode else 0
              for i in range(2)]
    spec = (pads[1], pads[1] + extras[1], pads[0], pads[0] + extras[0])
    if ptype == "max":
        if not any(extras) and all(p <= k // 2
                                   for p, k in zip(pads, ksize)):
            out = F.max_pool2d(xc, ksize, strides, pads)
        else:
            low = float("-inf") if xc.is_floating_point() \
                else torch.iinfo(xc.dtype).min
            out = F.max_pool2d(F.pad(xc, spec, value=low), ksize, strides)
        return {"Out": _from_nchw(out, layout)}
    padded = any(pads) or any(extras)
    summed = _window_sum(F.pad(xc, spec) if padded else xc, ksize, strides)
    if ctx.attr("exclusive", True) and padded:
        ones = torch.ones((1, 1) + tuple(xc.shape[2:]), dtype=xc.dtype,
                          device=xc.device)
        out = summed / _window_sum(F.pad(ones, spec), ksize, strides)
    else:
        out = summed / (ksize[0] * ksize[1])
    return {"Out": _from_nchw(out, layout)}


@register_op("batch_norm")
def _batch_norm(ctx):
    """With is_test (or use_global_stats) the moving statistics
    normalise; otherwise the batch's, in one sum / sum-of-squares pass,
    and MeanOut / VarianceOut carry the momentum update back to the
    persistable Mean / Variance vars."""
    x = ctx.input("X")
    scale, bias = ctx.input("Scale"), ctx.input("Bias")
    mean, var = ctx.input("Mean"), ctx.input("Variance")
    eps = ctx.attr("epsilon", 1e-5)
    momentum = ctx.attr("momentum", 0.9)
    c_axis = x.dim() - 1 if _img_layout(ctx) == "NHWC" else 1
    axes = tuple(i for i in range(x.dim()) if i != c_axis)
    bshape = tuple(-1 if i == c_axis else 1 for i in range(x.dim()))
    if ctx.attr("is_test", False) or ctx.attr("use_global_stats", False):
        use_mean, use_var = mean, var
        saved_mean = mean
        saved_inv_std = 1.0 / torch.sqrt(var + eps)
        mean_out, var_out = mean, var
    else:
        xf = x.float()
        n = float(math.prod(x.shape[i] for i in axes))
        s1, s2 = xf.sum(dim=axes), torch.square(xf).sum(dim=axes)
        if ctx.group is not None:
            # the global batch's statistics: the [2, C] sums and the row
            # count summed over the ranks in one all-reduce
            tot = all_reduce_sum(torch.cat([s1, s2, s1.new_full((1,), n)]),
                                 ctx.group, "batch_norm")
            s1, s2, n = tot[:s1.numel()], tot[s1.numel():-1], tot[-1]
        use_mean = s1 / n
        use_var = torch.clamp_min(s2 / n - torch.square(use_mean), 0.0)
        mean_out = mean * momentum + use_mean * (1.0 - momentum)
        var_out = var * momentum + use_var * (1.0 - momentum)
        saved_mean = use_mean
        saved_inv_std = 1.0 / torch.sqrt(use_var + eps)
    xhat = (x - use_mean.reshape(bshape).to(x.dtype)) * \
        saved_inv_std.reshape(bshape).to(x.dtype)
    y = xhat * scale.reshape(bshape).to(x.dtype) + \
        bias.reshape(bshape).to(x.dtype)
    return {"Y": y, "MeanOut": mean_out, "VarianceOut": var_out,
            "SavedMean": saved_mean, "SavedVariance": saved_inv_std}


@register_op("layer_norm")
def _layer_norm(ctx):
    x = ctx.input("X")
    begin = ctx.attr("begin_norm_axis", 1)
    eps = ctx.attr("epsilon", 1e-5)
    axes = tuple(range(begin, x.dim()))
    mean = torch.mean(x, dim=axes, keepdim=True)
    var = torch.var(x, dim=axes, unbiased=False, keepdim=True)
    y = (x - mean) * (1.0 / torch.sqrt(var + eps))
    shape = tuple(x.shape[begin:])
    if ctx.has_input("Scale"):
        y = y * ctx.input("Scale").reshape(shape)
    if ctx.has_input("Bias"):
        y = y + ctx.input("Bias").reshape(shape)
    rows = math.prod(x.shape[:begin])
    return {"Y": y, "Mean": mean.reshape(rows),
            "Variance": var.reshape(rows)}


@register_op("group_norm")
def _group_norm(ctx):
    """NCHW normalized per (sample, group of C / groups channels) with
    the biased variance; Mean and Variance are [N, groups]."""
    x = ctx.input("X")
    groups = ctx.attr("groups", 32)
    eps = ctx.attr("epsilon", 1e-5)
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, groups, c // groups) + tuple(x.shape[2:]))
    axes = tuple(range(2, xg.dim()))
    mean = torch.mean(xg, dim=axes, keepdim=True)
    var = torch.var(xg, dim=axes, unbiased=False, keepdim=True)
    y = ((xg - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    bshape = (1, -1) + (1,) * (x.dim() - 2)
    if ctx.has_input("Scale"):
        y = y * ctx.input("Scale").reshape(bshape)
    if ctx.has_input("Bias"):
        y = y + ctx.input("Bias").reshape(bshape)
    return {"Y": y, "Mean": mean.reshape((n, groups)),
            "Variance": var.reshape((n, groups))}


@register_op("lrn")
def _lrn(ctx):
    """Local response normalization across the channels of an NCHW X:
    MidOut = k + alpha * (the sum of x^2 over the channel window [c -
    (n-1)//2, c + n-1 - (n-1)//2], asymmetric for an even n), Out = X *
    MidOut^-beta (MidOut before the power, as the reference's grad
    kernel reads it)."""
    x = ctx.input("X")
    n = ctx.attr("n", 5)
    pre = (n - 1) // 2
    sq = F.pad(torch.square(x), (0, 0, 0, 0, pre, n - 1 - pre))
    C = x.shape[1]
    acc = sq[:, 0:C]
    for j in range(1, n):
        acc = acc + sq[:, j:j + C]
    mid = ctx.attr("k", 2.0) + ctx.attr("alpha", 1e-4) * acc
    return {"Out": x * mid ** (-ctx.attr("beta", 0.75)), "MidOut": mid}


@register_op("dropout")
def _dropout(ctx):
    """Keep mask drawn from the op's torch.Generator (ExecContext.
    generator): not the JAX package's bits, the same distribution.
    p = 0 and is_test are exact, as in the JAX lowering."""
    x = ctx.input("X")
    p = ctx.attr("dropout_prob", 0.5)
    imp = ctx.attr("dropout_implementation", "downgrade_in_infer")
    if ctx.attr("is_test", False) or p == 0.0:
        if imp == "downgrade_in_infer" and ctx.attr("is_test", False):
            return {"Out": x * (1.0 - p), "Mask": torch.ones_like(x)}
        return {"Out": x, "Mask": torch.ones_like(x)}
    keep = torch.empty_like(x).uniform_(generator=ctx.generator()) \
        < (1.0 - p)
    mask = keep.to(x.dtype)
    if imp == "upscale_in_train":
        return {"Out": x * mask / (1.0 - p), "Mask": mask}
    return {"Out": x * mask, "Mask": mask}


@register_op("lookup_table")
def _lookup_table(ctx):
    """Rows of W for the ids (a trailing size-1 ids dim is squeezed); ids
    at padding_idx read zeros.  Out-of-range ids read as `jnp.take` reads
    them: an id in [-rows, 0) wraps, any other reads a NaN row (a zero
    row for an integer W) that passes no gradient.  Decided on the
    device, with no host sync (the step can stay in flight); the gather
    itself reads clamped ids, so a bad id never faults the card."""
    w, ids = ctx.input("W"), ctx.input("Ids")
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    ids = ids.long()
    rows = w.shape[0]
    ids = torch.where(ids < 0, ids + rows, ids)
    valid = (ids >= 0) & (ids < rows)
    out = torch.nn.functional.embedding(ids.clamp(0, rows - 1), w)
    fill = float("nan") if out.is_floating_point() else 0
    out = torch.where(valid[..., None], out, out.new_full((), fill))
    padding_idx = ctx.attr("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = out * (ids != padding_idx)[..., None].to(out.dtype)
    return {"Out": out}


# ---------------------------------------------------------------------------
# the sparse (SelectedRows) embedding gradient, after the JAX package's
# lookup_table_sparse_grad and its grad maker (ops/nn_ops.py there)
# ---------------------------------------------------------------------------

@register_op("lookup_table_sparse_grad")
def _lookup_table_sparse_grad(ctx):
    """W's grad as a SelectedRowsValue: rows = the looked-up ids, values =
    the output cotangent's rows (zero at padding_idx), instead of a dense
    scatter into the whole table."""
    from ..fluid.selected_rows import SelectedRowsValue
    w, ids = ctx.input("W"), ctx.input("Ids")
    d_out = ctx.input("GRAD:Out")
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    flat_ids = ids.reshape(-1).to(torch.int32)
    values = d_out.reshape(-1, w.shape[-1])
    padding_idx = ctx.attr("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        values = values * (flat_ids != padding_idx)[:, None].to(
            values.dtype)
    return {"GRAD:W": SelectedRowsValue(flat_ids, values, w.shape[0])}


def _lookup_table_grad_maker(op, block, grad_map, no_grad_set, bw_ctx=None):
    """The sparse grad op where is_sparse is set; None (the generic dense
    vjp) otherwise, and also where W feeds any other op: a tied head's
    dense partial grad would overwrite the sparse one, so such a table
    takes the dense path, whose fan-in sum covers every consumer."""
    if not op.attrs.get("is_sparse", False):
        return None
    from ..fluid.framework import grad_var_name
    w_name = op.inputs["W"][0]
    out_name = op.outputs["Out"][0]
    if w_name in no_grad_set or out_name not in grad_map:
        return None
    if any(o is not op and any(w_name in names
                               for names in o.inputs.values())
           for o in block.ops):
        return None
    gname = grad_var_name(w_name)
    w_var = block._find_var_recursive(w_name)
    gvar = block.create_var(name=gname, dtype=w_var.dtype,
                            shape=w_var.shape, stop_gradient=True)
    gvar.is_selected_rows = True
    block.append_op(
        type="lookup_table_sparse_grad",
        inputs={"W": [w_name], "Ids": list(op.inputs["Ids"]),
                "GRAD:Out": [grad_map[out_name]]},
        outputs={"GRAD:W": [gname]},
        attrs={"padding_idx": op.attrs.get("padding_idx", -1),
               "op_role": "Backward"},
        infer_shape=False)
    grad_map[w_name] = gname
    return [gname]


def _take_label(x, label):
    """x[..., label] [..., 1] as `jnp.take_along_axis` picks it: a label
    in [-C, 0) wraps, any other label outside [0, C) picks NaN (and its
    row gets a zero gradient).  Decided on the device, with no host
    check, so an out-of-range label neither syncs nor faults the card."""
    C = x.shape[-1]
    idx = label.long()[..., None]
    idx = torch.where(idx < 0, idx + C, idx)
    valid = (idx >= 0) & (idx < C)
    picked = torch.gather(x, -1, idx.clamp(0, C - 1))
    return torch.where(valid, picked, torch.full_like(picked, float("nan")))


@register_op("softmax_with_cross_entropy")
def _softmax_with_ce(ctx):
    logits, label = ctx.input("Logits"), ctx.input("Label")
    logp = torch.log_softmax(logits, dim=-1)
    if ctx.attr("soft_label", False):
        loss = -torch.sum(label * logp, dim=-1, keepdim=True)
    else:
        lab = label.reshape(label.shape[:-1]) \
            if label.dim() == logits.dim() else label
        loss = -_take_label(logp, lab)
        ignore = ctx.attr("ignore_index", -100)
        if ignore >= 0:
            loss = torch.where(lab[..., None] == ignore,
                               torch.zeros_like(loss), loss)
    return {"Softmax": torch.exp(logp), "Loss": loss}


@register_op("cross_entropy")
def _cross_entropy(ctx):
    """-log of the picked probability (hard labels) or -sum(label *
    log p) (soft labels), the probabilities floored at 1e-8."""
    x, label = ctx.input("X"), ctx.input("Label")
    eps = 1e-8
    if ctx.attr("soft_label", False):
        loss = -torch.sum(label * torch.log(torch.clamp_min(x, eps)),
                          dim=-1, keepdim=True)
    else:
        if label.dim() == x.dim():
            label = label.reshape(label.shape[:-1])
        picked = _take_label(x, label)
        loss = -torch.log(torch.clamp_min(picked, eps))
    return {"Y": loss}


@register_op("square_error_cost")
def _square_error_cost(ctx):
    return {"Out": torch.square(ctx.input("X") - ctx.input("Y"))}


@register_op("accuracy")
def _accuracy(ctx):
    """Share of rows whose label is among the top-k Indices."""
    pred_idx = ctx.input("Indices")
    label = ctx.input("Label")
    if label.dim() == 2 and label.shape[-1] == 1:
        label = label.reshape(-1)
    correct = (pred_idx == label[:, None].to(pred_idx.dtype)).any(dim=1)
    num_correct = correct.to(torch.float32).sum()
    total = pred_idx.shape[0]
    if ctx.group is not None:
        # over the global batch: Correct and Total summed over the ranks
        tot = ctx.group.all_reduce_(
            torch.stack([num_correct, num_correct.new_tensor(total)]),
            "accuracy")
        return {"Accuracy": (tot[0] / tot[1]).reshape((1,)),
                "Correct": tot[0].to(torch.int32).reshape((1,)),
                "Total": tot[1].to(torch.int32).reshape((1,))}
    return {"Accuracy": (num_correct / float(total)).reshape((1,)),
            "Correct": num_correct.to(torch.int32).reshape((1,)),
            "Total": torch.full((1,), total, dtype=torch.int32,
                                device=pred_idx.device)}


@register_op("one_hot")
def _one_hot(ctx):
    """fp32 [..., depth] (a trailing size-1 dim of X squeezed); an id
    outside [0, depth) gives an all-zero row, as jax.nn.one_hot (where
    F.one_hot raises)."""
    x = ctx.input("X")
    if x.dim() >= 2 and x.shape[-1] == 1:
        x = x.reshape(x.shape[:-1])
    depth = int(ctx.attr("depth"))
    return {"Out": (x.long()[..., None] == torch.arange(
        depth, device=x.device)).to(torch.float32)}


@register_op("sigmoid_cross_entropy_with_logits")
def _sigmoid_ce(ctx):
    """max(x, 0) - x z + log(1 + exp(-|x|)), zero where the label is
    ignore_index (when that is >= 0)."""
    x, label = ctx.input("X"), ctx.input("Label")
    loss = jmax(x, 0.0) - x * label + torch.log1p(torch.exp(-jabs(x)))
    ignore = ctx.attr("ignore_index", -100)
    if ignore >= 0:
        loss = torch.where(label == ignore, torch.zeros_like(loss), loss)
    return {"Out": loss}


@register_op("huber_loss")
def _huber_loss(ctx):
    x, y = ctx.input("X"), ctx.input("Y")
    delta = ctx.attr("delta", 1.0)
    r = y - x
    ar = jabs(r)
    return {"Out": torch.where(ar <= delta, 0.5 * r * r,
                               delta * (ar - 0.5 * delta)),
            "Residual": r}


@register_op("smooth_l1_loss")
def _smooth_l1(ctx):
    """Per row, the sum of the smooth-L1 of (X - Y) weighted inside by
    InsideWeight and outside by OutsideWeight, sigma^2 at the knee."""
    x, y = ctx.input("X"), ctx.input("Y")
    s2 = ctx.attr("sigma", 1.0) ** 2
    diff = x - y
    if ctx.has_input("InsideWeight"):
        diff = diff * ctx.input("InsideWeight")
    ad = jabs(diff)
    loss = torch.where(ad < 1.0 / s2, 0.5 * s2 * diff * diff, ad - 0.5 / s2)
    if ctx.has_input("OutsideWeight"):
        loss = loss * ctx.input("OutsideWeight")
    return {"Out": torch.sum(loss.reshape(loss.shape[0], -1), dim=1,
                             keepdim=True),
            "Diff": diff}


@register_op("log_loss")
def _log_loss(ctx):
    p, label = ctx.input("Predicted"), ctx.input("Labels")
    eps = ctx.attr("epsilon", 1e-4)
    return {"Loss": -label * torch.log(p + eps)
            - (1 - label) * torch.log(1 - p + eps)}


@register_op("hinge_loss")
def _hinge_loss(ctx):
    logits, labels = ctx.input("Logits"), ctx.input("Labels")
    return {"Loss": jmax(1.0 - (2 * labels - 1) * logits, 0.0)}


@register_op("margin_rank_loss")
def _margin_rank_loss(ctx):
    x1, x2, label = ctx.input("X1"), ctx.input("X2"), ctx.input("Label")
    out = jmax(-label * (x1 - x2) + ctx.attr("margin", 0.0), 0.0)
    return {"Out": out, "Activated": (out > 0).to(x1.dtype)}


def _interp_grid(ctx, in_sz, out_sz, device):
    """The interpolations' fp32 source coordinates, as the JAX
    lowering's _interp_grid: align-corners by default (ratio (in - 1) /
    (out - 1), src = ratio dst); without it, align_mode 0 is half-pixel
    (src = max(ratio (dst + 0.5) - 0.5, 0)) and 1 is src = ratio dst,
    ratio in / out."""
    dst = torch.arange(out_sz, dtype=torch.float32, device=device)
    if ctx.attr("align_corners", True):
        ratio = (in_sz - 1) / (out_sz - 1) if out_sz > 1 else 0.0
        return dst * ratio
    ratio = in_sz / out_sz
    if ctx.attr("align_mode", 1) == 0:
        return torch.clamp_min(dst * ratio + (0.5 * ratio - 0.5), 0.0)
    return dst * ratio


@register_op("bilinear_interp")
def _bilinear_interp(ctx):
    """NCHW to [out_h, out_w] by the four-corner blend on _interp_grid's
    coordinates, in x's dtype."""
    x = ctx.input("X")
    H, W = x.shape[2], x.shape[3]
    y = _interp_grid(ctx, H, ctx.attr("out_h"), x.device)
    xw = _interp_grid(ctx, W, ctx.attr("out_w"), x.device)
    y0 = torch.clamp_max(torch.floor(y).long(), H - 1)
    x0 = torch.clamp_max(torch.floor(xw).long(), W - 1)
    y1 = torch.clamp_max(y0 + 1, H - 1)
    x1 = torch.clamp_max(x0 + 1, W - 1)
    dy = (y - y0).to(x.dtype)[:, None]
    dx = (xw - x0).to(x.dtype)[None, :]
    yg0, yg1, xg0, xg1 = y0[:, None], y1[:, None], x0[None, :], x1[None, :]
    top = x[:, :, yg0, xg0] * (1 - dx) + x[:, :, yg0, xg1] * dx
    bot = x[:, :, yg1, xg0] * (1 - dx) + x[:, :, yg1, xg1] * dx
    return {"Out": (top * (1 - dy) + bot * dy).to(x.dtype)}


@register_op("nearest_interp")
def _nearest_interp(ctx):
    """NCHW to [out_h, out_w] at the rounded source coordinates
    (truncation of grid + 0.5, clamped), as the JAX lowering."""
    x = ctx.input("X")
    H, W = x.shape[2], x.shape[3]
    yi = torch.clamp((_interp_grid(ctx, H, ctx.attr("out_h"), x.device)
                      + 0.5).to(torch.int32), 0, H - 1).long()
    xi = torch.clamp((_interp_grid(ctx, W, ctx.attr("out_w"), x.device)
                      + 0.5).to(torch.int32), 0, W - 1).long()
    return {"Out": x[:, :, yi][..., xi]}


@register_op("pad")
def _pad(ctx):
    """`paddings` as (before, after) pairs, one per axis, filled with
    pad_value."""
    x = ctx.input("X")
    p = ctx.attr("paddings")
    spec = []
    for i in reversed(range(x.dim())):
        spec += [int(p[2 * i]), int(p[2 * i + 1])]
    return {"Out": F.pad(x, spec, value=ctx.attr("pad_value", 0.0))}


@register_op("pad2d")
def _pad2d(ctx):
    """[top, bottom, left, right] spatial padding, constant, reflect or
    edge, on NCHW or (data_format) NHWC."""
    x = ctx.input("X")
    p = [int(v) for v in ctx.attr("paddings", [0, 0, 0, 0])]
    layout = ctx.attr("data_format", "NCHW")
    mode = ctx.attr("mode", "constant")
    xc = _to_nchw(x, layout)
    spec = [p[2], p[3], p[0], p[1]]
    if mode == "constant":
        out = F.pad(xc, spec, value=ctx.attr("pad_value", 0.0))
    else:
        out = F.pad(xc, spec, mode={"reflect": "reflect",
                                    "edge": "replicate"}[mode])
    return {"Out": _from_nchw(out, layout)}


set_grad_maker("lookup_table", _lookup_table_grad_maker)
