"""NN op lowerings, after paddle_tpu/ops/nn_ops.py: layer_norm, dropout,
lookup_table (embedding) and softmax_with_cross_entropy."""

import math

import torch

from .registry import register_op


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
    at padding_idx read zeros.  Ids outside [0, rows) raise ValueError,
    where the JAX gather clamps: on the card an out-of-range gather
    would fault the CUDA context."""
    w, ids = ctx.input("W"), ctx.input("Ids")
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    ids = ids.long()
    if ids.device.type != "meta" and ids.numel() and bool(
            ((ids < 0) | (ids >= w.shape[0])).any()):
        raise ValueError("lookup_table: ids outside [0, %d)" % w.shape[0])
    out = torch.nn.functional.embedding(ids, w)
    padding_idx = ctx.attr("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = out * (ids != padding_idx)[..., None].to(out.dtype)
    return {"Out": out}


@register_op("softmax_with_cross_entropy")
def _softmax_with_ce(ctx):
    logits, label = ctx.input("Logits"), ctx.input("Label")
    logp = torch.log_softmax(logits, dim=-1)
    if ctx.attr("soft_label", False):
        loss = -torch.sum(label * logp, dim=-1, keepdim=True)
    else:
        lab = label.reshape(label.shape[:-1]) \
            if label.dim() == logits.dim() else label
        lab = lab.long()
        loss = -torch.gather(logp, -1, lab[..., None])
        ignore = ctx.attr("ignore_index", -100)
        if ignore >= 0:
            loss = torch.where(lab[..., None] == ignore,
                               torch.zeros_like(loss), loss)
    return {"Softmax": torch.exp(logp), "Loss": loss}
