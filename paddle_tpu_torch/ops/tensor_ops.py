"""Tensor creation / manipulation / RNG op lowerings, after
paddle_tpu/ops/tensor_ops.py: fill_constant, assign, remat_tag,
uniform_random, gaussian_random, reshape2, slice and where."""

import numpy as np
import torch

from ..parallel.mesh import gather_rows, row_counts
from .math_ops import _promote
from .registry import register_op


def _torch_dtype(attr_dtype, default=torch.float32):
    from ..fluid import core as fcore
    if attr_dtype is None:
        return default
    return fcore.convert_dtype_to_torch(attr_dtype)


@register_op("fill_constant")
def _fill_constant(ctx):
    shape = tuple(int(d) for d in ctx.attr("shape", [1]))
    return {"Out": torch.full(shape, ctx.attr("value", 0.0),
                              dtype=_torch_dtype(ctx.attr("dtype")),
                              device=ctx.device)}


@register_op("assign")
def _assign(ctx):
    return {"Out": ctx.input("X")}


@register_op("remat_tag")
def _remat_tag(ctx):
    """The identity: the tag names a value for the JAX package's remat
    policies, a memory trade that the eager Executor does not make."""
    return {"Out": ctx.input("X")}


@register_op("uniform_random")
def _uniform_random(ctx):
    """U[min, max) from the op's torch.Generator (ExecContext.generator):
    deterministic per (seed attr, program seed, op uid, step), but not
    the JAX package's threefry values."""
    shape = tuple(int(d) for d in ctx.attr("shape"))
    out = torch.empty(shape, dtype=_torch_dtype(ctx.attr("dtype")),
                      device=ctx.device)
    return {"Out": out.uniform_(ctx.attr("min", -1.0), ctx.attr("max", 1.0),
                                generator=ctx.generator())}


def _target_shape(x, shape):
    shape = list(shape)
    neg = [i for i, d in enumerate(shape) if d == -1]
    for i, d in enumerate(shape):
        if d == 0:
            shape[i] = x.shape[i]
    if neg:
        known = int(np.prod([d for d in shape if d > 0])) or 1
        shape[neg[0]] = int(np.prod(x.shape)) // known
    return tuple(shape)


def _ragged_target(ctx, x, shape):
    """A ragged X's program shapes are the packed [rows, ...] ones and its
    run-time layout the padded [B, T, ...]: a leading -1 maps to
    [B, T]."""
    if ctx.lod_len("X") is not None and shape and shape[0] == -1:
        return tuple(x.shape[:2]) + tuple(int(d) for d in shape[1:])
    return _target_shape(x, shape)


@register_op("reshape2")
def _reshape2(ctx):
    x = ctx.input("X")
    out = torch.reshape(x, _ragged_target(ctx, x, ctx.attr("shape")))
    return {"Out": out, "XShape": x.new_zeros((0,) + tuple(x.shape))}


@register_op("slice")
def _slice(ctx):
    """Under a data-parallel group a slice of a batch-sharded input's
    axis 0 names global rows.  Where the output is replicated, the ranks'
    rows are gathered and sliced.  Where it stays batch-sharded, each
    rank keeps the rows of the slice that it holds itself, so the output
    is split as the input is and lines up with the rank's other
    batch-sharded vars (the fetch gathers it back in rank order)."""
    x = ctx.input("Input")
    off, own, total = 0, None, None
    if any(a % x.dim() == 0 for a in ctx.attr("axes")) and \
            ctx.batch_sharded(ctx.op.inputs["Input"][0]):
        if ctx.batch_sharded(ctx.op.outputs["Out"][0]):
            sizes = row_counts(x, ctx.group)
            off, own = sum(sizes[:ctx.group.rank]), x.shape[0]
            total = sum(sizes)
        else:
            x = gather_rows(x, ctx.group, "slice")
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(ctx.attr("axes"), ctx.attr("starts"),
                       ctx.attr("ends")):
        mine = own is not None and a % x.dim() == 0
        dim = total if mine else x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        if mine:
            # global rows [s, e) that lie in this rank's [off, off + own)
            s = min(max(s, off), off + own)
            e = max(min(e, off + own), s)
            s, e = s - off, e - off
        idx[a] = slice(s, e)
    return {"Out": x[tuple(idx)]}


@register_op("gaussian_random")
def _gaussian_random(ctx):
    """N(mean, std) from the op's torch.Generator: the JAX package's
    distribution, not its threefry values."""
    shape = tuple(int(d) for d in ctx.attr("shape"))
    out = torch.empty(shape, dtype=_torch_dtype(ctx.attr("dtype")),
                      device=ctx.device)
    out.normal_(generator=ctx.generator())
    return {"Out": out * ctx.attr("std", 1.0) + ctx.attr("mean", 0.0)}


@register_op("where")
def _where(ctx):
    """X where Condition, else Y; float operands promoted by dtype, as
    jnp.where."""
    x, y = _promote(ctx.input("X"), ctx.input("Y"))
    return {"Out": torch.where(ctx.input("Condition"), x, y)}
