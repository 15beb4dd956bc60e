"""Tensor creation / manipulation / RNG op lowerings, after
paddle_tpu/ops/tensor_ops.py: fill_constant,
fill_constant_batch_size_like, fill_zeros_like, assign, assign_value,
remat_tag, shape, range, linspace, the random ops (uniform_random,
uniform_random_batch_size_like, gaussian_random,
truncated_gaussian_random, randint), reshape(2), transpose(2),
flatten(2), slice, strided_slice, where, concat, split, stack, unstack,
gather, gather_nd, scatter, unsqueeze(2), squeeze(2), expand,
expand_as, tile, reverse, is_empty, print and lod_reset.

The indexed reads and writes take JAX's out-of-range semantics on the
device, with no host check and no out-of-bounds access (an index that
faults is a device-side assert on the card): `gather` reads as jnp.take
(an index in [-N, 0) wraps, any other reads a NaN row), `gather_nd`
as jnp's basic indexing (a negative index wraps once, then every index
clamps into range) and `scatter` as `.at[]` (a negative id wraps once,
then an id out of range is dropped)."""

import math

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


def _xshape(x):
    """The XShape output of the *2 ops: [0] + x's shape, no data."""
    return x.new_zeros((0,) + tuple(x.shape))


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
    return {"Out": out, "XShape": _xshape(x)}


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


def _flat_ids(idx):
    """An [N, 1] index flattened to [N], as int64."""
    if idx.dim() == 2 and idx.shape[1] == 1:
        idx = idx.reshape(-1)
    return idx.to(torch.int64)


def _wrapped(idx, n):
    """An index in [-n, 0) moved into [0, n); any other left as it is."""
    return torch.where(idx < 0, idx + n, idx)


@register_op("gather")
def _gather(ctx):
    """Rows of X at Index (an [N, 1] index is flattened), read as
    jnp.take reads them: an index in [-N, 0) wraps, any other outside
    [0, N) reads a NaN row (a zero row for an integer X) that passes no
    gradient.  The read itself uses clamped indices."""
    x = ctx.input("X")
    n = x.shape[0]
    idx = _wrapped(_flat_ids(ctx.input("Index")), n)
    valid = (idx >= 0) & (idx < n)
    out = torch.index_select(x, 0, idx.clamp(0, max(n - 1, 0)))
    fill = float("nan") if out.is_floating_point() else 0
    valid = valid.reshape((-1,) + (1,) * (x.dim() - 1))
    return {"Out": torch.where(valid, out, out.new_full((), fill))}


@register_op("gather_nd")
def _gather_nd(ctx):
    """X at the index tuples of Index's last axis, as `x[tuple(idx)]`
    reads them in JAX: each component wraps once if negative and is then
    clamped into its axis; a read whose wrapped index lay outside X
    passes no gradient (XLA drops its scatter)."""
    x, idx = ctx.input("X"), ctx.input("Index").to(torch.int64)
    parts, valid = [], None
    for k in range(idx.shape[-1]):
        n = x.shape[k]
        i = _wrapped(idx[..., k], n)
        ok = (i >= 0) & (i < n)
        valid = ok if valid is None else valid & ok
        parts.append(i.clamp(0, n - 1))
    out = x[tuple(parts)]
    if valid is None:
        return {"Out": out}
    valid = valid.reshape(tuple(valid.shape) + (1,) * (out.dim()
                                                      - valid.dim()))
    return {"Out": torch.where(valid, out, out.detach())}


@register_op("scatter")
def _scatter(ctx):
    """X with rows Ids set to (`overwrite`) or incremented by Updates, as
    `.at[ids].set / .add`: a negative id wraps once, then an id out of
    range is dropped (written to a spare row that is cut off).  With
    overwrite, duplicate ids leave one of their rows, in an order that
    neither framework defines."""
    x, upd = ctx.input("X"), ctx.input("Updates")
    n = x.shape[0]
    ids = _wrapped(_flat_ids(ctx.input("Ids")), n)
    ids = torch.where((ids >= 0) & (ids < n), ids, torch.full_like(ids, n))
    spare = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    out = spare.index_put((ids,), upd.to(x.dtype),
                          accumulate=not ctx.attr("overwrite", True))
    return {"Out": out[:n]}


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
    return {"Out": _unsqueezed(x, ctx.attr("axes")), "XShape": _xshape(x)}


@register_op("squeeze")
def _squeeze(ctx):
    return {"Out": _squeezed(ctx.input("X"), ctx.attr("axes", []))}


@register_op("squeeze2")
def _squeeze2(ctx):
    x = ctx.input("X")
    return {"Out": _squeezed(x, ctx.attr("axes", [])), "XShape": _xshape(x)}


@register_op("expand")
def _expand(ctx):
    """X tiled `expand_times` along each axis (jnp.tile)."""
    return {"Out": _tiled(ctx.input("X"), ctx.attr("expand_times"))}


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


@register_op("assign_value")
def _assign_value(ctx):
    """The constant of the attrs (fp32_values, int64_values or
    int32_values) in `shape` and `dtype`."""
    if ctx.attr("fp32_values"):
        vals = np.array(ctx.attr("fp32_values"), dtype=np.float32)
    elif ctx.attr("int64_values"):
        vals = np.array(ctx.attr("int64_values"), dtype=np.int64)
    else:
        vals = np.array(ctx.attr("int32_values"), dtype=np.int32)
    return {"Out": torch.as_tensor(
        vals.reshape(ctx.attr("shape")), device=ctx.device).to(
            _torch_dtype(ctx.attr("dtype")))}


@register_op("shape")
def _shape(ctx):
    return {"Out": torch.tensor(list(ctx.input("Input").shape),
                                dtype=torch.int32, device=ctx.device)}


def _host_scalar(v):
    """A [1] (or 0-dim) input read on the host: the output's length
    depends on it, as the JAX lowering requires a concrete value (which
    it takes only from a 0-dim array: its own layers' [1] bounds fail
    there)."""
    return float(v.reshape(-1)[0])


@register_op("range")
def _range(ctx):
    """arange(Start, End, Step) in fp32, as the JAX lowering (float
    bounds whatever their dtype)."""
    return {"Out": torch.arange(_host_scalar(ctx.input("Start")),
                                _host_scalar(ctx.input("End")),
                                _host_scalar(ctx.input("Step")),
                                dtype=torch.float32, device=ctx.device)}


@register_op("linspace")
def _linspace(ctx):
    return {"Out": torch.linspace(_host_scalar(ctx.input("Start")),
                                  _host_scalar(ctx.input("Stop")),
                                  int(_host_scalar(ctx.input("Num"))),
                                  dtype=torch.float32, device=ctx.device)}


def _batch_like_shape(ctx):
    shape = [int(d) for d in ctx.attr("shape")]
    shape[ctx.attr("output_dim_idx", 0)] = \
        ctx.input("Input").shape[ctx.attr("input_dim_idx", 0)]
    return tuple(shape)


@register_op("uniform_random_batch_size_like")
def _uniform_random_bsl(ctx):
    """U[min, max) in `shape` with its output_dim_idx taken from Input's
    input_dim_idx, from the op's torch.Generator."""
    out = torch.empty(_batch_like_shape(ctx),
                      dtype=_torch_dtype(ctx.attr("dtype")),
                      device=ctx.device)
    return {"Out": out.uniform_(ctx.attr("min", -1.0), ctx.attr("max", 1.0),
                                generator=ctx.generator())}


@register_op("truncated_gaussian_random")
def _truncated_gaussian_random(ctx):
    """N(0, 1) truncated to [-2, 2] (jax.random.truncated_normal's bounds,
    drawn by its inverse-CDF method from the op's torch.Generator), then
    times std plus mean."""
    shape = tuple(int(d) for d in ctx.attr("shape"))
    dtype = _torch_dtype(ctx.attr("dtype"))
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.empty(shape, dtype=torch.float32, device=ctx.device)
    u.uniform_(lo, hi, generator=ctx.generator())
    z = torch.clamp(math.sqrt(2.0) * torch.erfinv(u), -2.0, 2.0)
    return {"Out": (z * ctx.attr("std", 1.0) + ctx.attr("mean", 0.0)).to(
        dtype)}


@register_op("randint")
def _randint(ctx):
    """Integers in [low, high) as int64, from the op's torch.Generator."""
    shape = tuple(int(d) for d in ctx.attr("shape"))
    return {"Out": torch.randint(int(ctx.attr("low", 0)),
                                 int(ctx.attr("high")), shape,
                                 generator=ctx.generator(),
                                 dtype=torch.int64, device=ctx.device)}


@register_op("reshape")
def _reshape(ctx):
    """To `shape`, or to the Shape input's values (read on the host)."""
    x = ctx.input("X")
    if ctx.has_input("Shape"):
        shape = [int(d) for d in ctx.input("Shape").reshape(-1).tolist()]
    else:
        shape = ctx.attr("shape")
    return {"Out": torch.reshape(x, _ragged_target(ctx, x, shape))}


@register_op("transpose")
def _transpose(ctx):
    return {"Out": ctx.input("X").permute(tuple(ctx.attr("axis")))}


@register_op("transpose2")
def _transpose2(ctx):
    x = ctx.input("X")
    return {"Out": x.permute(tuple(ctx.attr("axis"))), "XShape": _xshape(x)}


def _flattened(ctx):
    x = ctx.input("X")
    axis = ctx.attr("axis", 1)
    lead = int(np.prod(x.shape[:axis])) if axis > 0 else 1
    return torch.reshape(x, (lead, -1))


@register_op("flatten")
def _flatten(ctx):
    return {"Out": _flattened(ctx)}


@register_op("flatten2")
def _flatten2(ctx):
    return {"Out": _flattened(ctx), "XShape": _xshape(ctx.input("X"))}


@register_op("split")
def _split(ctx):
    """`num` equal parts along `axis`, or parts of the `sections`
    sizes."""
    x = ctx.input("X")
    axis = ctx.attr("axis", 0)
    sections = ctx.attr("sections", [])
    if sections:
        cuts = np.cumsum(sections)[:-1].tolist()
    else:
        num = ctx.attr("num", 0)
        if x.shape[axis] % num:
            raise ValueError("split: axis %d of extent %d does not split "
                             "into %d equal parts" % (axis, x.shape[axis],
                                                      num))
        step = x.shape[axis] // num
        cuts = list(range(step, x.shape[axis], step))
    return {"Out": list(torch.tensor_split(x, cuts, dim=axis))}


@register_op("unstack")
def _unstack(ctx):
    x = ctx.input("X")
    return {"Y": list(torch.unbind(x, dim=ctx.attr("axis", 0)))}


@register_op("strided_slice")
def _strided_slice(ctx):
    """Python slice semantics per axis, as the JAX lowering's
    x[slice(start, end, stride)]; a negative stride reads the selected
    positions through an index."""
    x = ctx.input("Input")
    axes = ctx.attr("axes")
    strides = ctx.attr("strides", [1] * len(axes))
    for a, s, e, st in zip(axes, ctx.attr("starts"), ctx.attr("ends"),
                           strides):
        idx = [slice(None)] * x.dim()
        if st > 0:
            idx[a] = slice(s, e, st)
            x = x[tuple(idx)]
        else:
            pos = list(range(*slice(s, e, st).indices(x.shape[a])))
            x = torch.index_select(x, a, torch.tensor(
                pos, dtype=torch.int64, device=x.device))
    return {"Out": x}


def _tiled(x, times):
    """jnp.tile: `times` padded with leading 1s to x's rank."""
    times = tuple(int(t) for t in times)
    return x.repeat((1,) * (x.dim() - len(times)) + times)


@register_op("tile")
def _tile(ctx):
    return {"Out": _tiled(ctx.input("X"), ctx.attr("repeat_times"))}


@register_op("expand_as")
def _expand_as(ctx):
    x, y = ctx.input("X"), ctx.input("target_tensor")
    return {"Out": _tiled(x, [t // s for t, s in zip(y.shape, x.shape)])}


@register_op("reverse")
def _reverse(ctx):
    axes = ctx.attr("axis")
    return {"Out": torch.flip(ctx.input("X"), tuple(
        [axes] if isinstance(axes, int) else axes))}


@register_op("lod_reset")
def _lod_reset(ctx):
    """X's rows regrouped by Y's lengths (or by the offsets `target_lod`):
    X's valid rows compacted into one flat run in row-major order (a
    cumsum of the mask numbers them, and each is written to its number,
    the padding to a spare row that is cut off), then laid out in Y's
    padded [B_y, T_y, ...] (T_y Y's padded width, or the flat row count
    for a Y of rank 2 or less), zero past each length.  Without Y or
    target_lod, X passes through."""
    x = ctx.input("X")
    xlens, ylens = ctx.lod_len("X"), ctx.lod_len("Y")
    if ylens is None:
        target = ctx.attr("target_lod", [])
        if not target:
            return {"Out": x}
        offsets = np.asarray(target, np.int64)
        ylens = torch.as_tensor(offsets[1:] - offsets[:-1],
                                dtype=torch.int32, device=x.device)
    if x.dim() >= 3 or xlens is not None:
        B_x, T_x = x.shape[0], x.shape[1]
        if xlens is None:
            xlens = torch.full((B_x,), T_x, dtype=torch.int32,
                               device=x.device)
        n = B_x * T_x
        mask = (torch.arange(T_x, device=x.device)[None, :]
                < xlens[:, None]).reshape(-1)
        rows = x.reshape((n,) + tuple(x.shape[2:]))
        pos = torch.cumsum(mask.to(torch.int64), dim=0) - 1
        dest = torch.where(mask, pos, torch.full_like(pos, n))
        flat = rows.new_zeros((n + 1,) + tuple(rows.shape[1:])).index_put(
            (dest,), rows)[:n]
    else:
        flat = x
    B_y = ylens.shape[0]
    y = ctx.input("Y")
    T_y = y.shape[1] if (y is not None and y.dim() >= 3) \
        else int(flat.shape[0])
    ylens64 = ylens.to(torch.int64)
    off = torch.cumsum(ylens64, dim=0) - ylens64
    t = torch.arange(T_y, device=x.device)[None, :]
    idx = torch.clamp(off[:, None] + t, 0, flat.shape[0] - 1)
    out = torch.index_select(flat, 0, idx.reshape(-1)).reshape(
        (B_y, T_y) + tuple(flat.shape[1:]))
    m = (t < ylens64[:, None]).reshape(
        (B_y, T_y) + (1,) * (flat.dim() - 1)).to(out.dtype)
    return {"Out": out * m, "Out@LOD_LEN": ylens}
