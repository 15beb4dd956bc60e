"""Tensor creation / manipulation / RNG op lowerings, after
paddle_tpu/ops/tensor_ops.py: fill_constant,
fill_constant_batch_size_like, fill_zeros_like, assign, remat_tag,
uniform_random, gaussian_random, reshape2, slice, where, concat, gather,
stack, unsqueeze(2), squeeze(2), expand, is_empty and print."""

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


@register_op("fill_constant_batch_size_like")
def _fill_constant_bsl(ctx):
    """`shape` with its output_dim_idx taken from Input's input_dim_idx
    (the batch): a padded ragged Input gives its B."""
    ref = ctx.input("Input")
    shape = [int(d) for d in ctx.attr("shape")]
    shape[ctx.attr("output_dim_idx", 0)] = \
        ref.shape[ctx.attr("input_dim_idx", 0)]
    return {"Out": torch.full(tuple(shape), ctx.attr("value", 0.0),
                              dtype=_torch_dtype(ctx.attr("dtype")),
                              device=ref.device)}


@register_op("fill_zeros_like")
def _fill_zeros_like(ctx):
    return {"Out": torch.zeros_like(ctx.input("X"))}


@register_op("concat")
def _concat(ctx):
    """Along `axis`; over ragged inputs an axis >= 1 moves past the
    padded layout's time dim."""
    axis = ctx.attr("axis", 0)
    if axis >= 1 and any(n is not None for n in ctx.lod_lens("X")):
        axis += 1
    xs = ctx.inputs("X")
    if any(x.is_floating_point() for x in xs):
        dt = xs[0].dtype
        for x in xs[1:]:
            dt = torch.promote_types(dt, x.dtype)
        xs = [x.to(dt) for x in xs]
    return {"Out": torch.cat(xs, dim=axis)}


@register_op("gather")
def _gather(ctx):
    """Rows of X at Index (an [N, 1] index is flattened)."""
    x, idx = ctx.input("X"), ctx.input("Index")
    if idx.dim() == 2 and idx.shape[1] == 1:
        idx = idx.reshape(-1)
    return {"Out": torch.index_select(x, 0, idx.to(torch.int64))}


@register_op("stack")
def _stack(ctx):
    return {"Y": torch.stack(ctx.inputs("X"), dim=ctx.attr("axis", 0))}


def _unsqueezed(x, axes):
    for a in sorted(axes):
        x = torch.unsqueeze(x, a)
    return x


def _squeezed(x, axes):
    if not axes:
        return torch.squeeze(x)
    axes = tuple(a % x.dim() for a in axes if x.shape[a % x.dim()] == 1)
    return torch.squeeze(x, axes) if axes else x


@register_op("unsqueeze")
def _unsqueeze(ctx):
    return {"Out": _unsqueezed(ctx.input("X"), ctx.attr("axes"))}


@register_op("unsqueeze2")
def _unsqueeze2(ctx):
    x = ctx.input("X")
    return {"Out": _unsqueezed(x, ctx.attr("axes")),
            "XShape": x.new_zeros((0,) + tuple(x.shape))}


@register_op("squeeze")
def _squeeze(ctx):
    return {"Out": _squeezed(ctx.input("X"), ctx.attr("axes", []))}


@register_op("squeeze2")
def _squeeze2(ctx):
    x = ctx.input("X")
    return {"Out": _squeezed(x, ctx.attr("axes", [])),
            "XShape": x.new_zeros((0,) + tuple(x.shape))}


@register_op("expand")
def _expand(ctx):
    """X tiled `expand_times` along each axis (jnp.tile)."""
    return {"Out": ctx.input("X").repeat(
        tuple(int(t) for t in ctx.attr("expand_times")))}


@register_op("is_empty")
def _is_empty(ctx):
    return {"Out": torch.tensor([ctx.input("X").numel() == 0],
                                device=ctx.device)}


@register_op("print")
def _print(ctx):
    """Prints `message` and the value in the forward phase; the
    identity.  (A host read of the value, where the JAX package's
    jax.debug.print is a device callback.)"""
    x = ctx.input("In")
    if x.device.type != "meta" and \
            ctx.attr("print_phase", "both") in ("forward", "both"):
        print((ctx.attr("message", "") or "") + " " + str(x))
    return {"Out": x}
