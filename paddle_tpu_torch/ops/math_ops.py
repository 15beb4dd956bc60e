"""Math / elementwise / reduction / activation op lowerings, after
paddle_tpu/ops/math_ops.py: gelu, sigmoid, tanh, floor, log, square,
logical_not, cast, elementwise_add, _sub, _mul and _min with fluid's
`axis` broadcasting, less_than and equal, mul (fc's matmul), matmul,
sum, scale, mean, reduce_sum, cumsum, relu, sign, increment, softmax and
top_k.  The matmuls are plain torch.matmul (TF32 off; bf16 summed in
fp32 and rounded once), as the JAX package leaves them to XLA.

On a ragged (LoD) X, padded [B, T, ...] at run time where the program's
shapes are the packed [rows, ...] ones, `mul` flattens one more leading
dim, the elementwise ops shift an `axis` >= 1 by one, and `mean`
averages over the real rows only, as the JAX lowerings do.  Under a
data-parallel group (ExecContext.group) `mean` is the global batch's:
its sum and its count are each summed over the ranks; `cumsum` along a
batch-sharded axis 0 adds the lower ranks' totals."""

import numpy as np
import torch

from ..parallel.mesh import all_reduce_sum, gather_rows
from .registry import register_op


@register_op("gelu")
def _gelu(ctx):
    """Exact erf GELU unless the `approximate` attr asks for the tanh
    form."""
    approx = "tanh" if ctx.attr("approximate", False) else "none"
    return {"Out": torch.nn.functional.gelu(ctx.input("X"),
                                            approximate=approx)}


def _broadcast_y(x, y, axis):
    """Fluid semantics: Y's shape matches a contiguous run of X's shape
    starting at `axis` (axis == -1 aligns trailing dims)."""
    if x.dim() == y.dim():
        return y
    if axis is None or axis == -1:
        axis = x.dim() - y.dim()
    # strip trailing size-1 dims the reference tolerates (e.g. [N,1] bias)
    yshape = list(y.shape)
    while len(yshape) > 1 and yshape[-1] == 1 and \
            axis + len(yshape) > x.dim():
        yshape = yshape[:-1]
    return torch.reshape(y, [1] * axis + yshape
                         + [1] * (x.dim() - axis - len(yshape)))


def _promote(x, y):
    """Two float operands in their common dtype by dtype alone, as JAX
    promotes (bf16 + fp32 is fp32 even where one is 0-dim; torch would
    keep a tensor's dtype against a 0-dim one)."""
    if x.dtype != y.dtype and x.is_floating_point() \
            and y.is_floating_point():
        dt = torch.promote_types(x.dtype, y.dtype)
        return x.to(dt), y.to(dt)
    return x, y


@register_op("sigmoid")
def _sigmoid(ctx):
    return {"Out": torch.sigmoid(ctx.input("X"))}


@register_op("tanh")
def _tanh(ctx):
    return {"Out": torch.tanh(ctx.input("X"))}


def _register_elementwise(name, fn):
    """X (op) Y with Y broadcast from `axis`; on a ragged X an axis >= 1
    moves one right, past the padded layout's time dim."""
    def lower(ctx):
        x, y = _promote(ctx.input("X"), ctx.input("Y"))
        axis = ctx.attr("axis", -1)
        if ctx.lod_len("X") is not None and axis is not None and axis >= 1:
            axis += 1
        return {"Out": fn(x, _broadcast_y(x, y, axis))}
    register_op(name)(lower)


_register_elementwise("elementwise_add", torch.add)
_register_elementwise("elementwise_mul", torch.mul)
_register_elementwise("elementwise_sub", torch.sub)
_register_elementwise("elementwise_min", torch.minimum)


@register_op("equal")
def _equal(ctx):
    x, y = _promote(ctx.input("X"), ctx.input("Y"))
    if x.dim() != y.dim():
        y = _broadcast_y(x, y, ctx.attr("axis", -1))
    return {"Out": torch.eq(x, y)}


def _register_unary(name, fn):
    register_op(name)(lambda ctx: {"Out": fn(ctx.input("X"))})


_register_unary("floor", torch.floor)
_register_unary("log", torch.log)
_register_unary("square", torch.square)
_register_unary("logical_not", torch.logical_not)


@register_op("cast")
def _cast(ctx):
    from ..fluid import core as fcore
    return {"Out": ctx.input("X").to(
        fcore.convert_dtype_to_torch(ctx.attr("out_dtype")))}


@register_op("reduce_sum")
def _reduce_sum(ctx):
    """Over `dim` (every axis with `reduce_all`), in x's dtype as
    jnp.sum (an int32 sum stays int32)."""
    x = ctx.input("X")
    if ctx.attr("reduce_all", False):
        dim = tuple(range(x.dim()))
    else:
        dim = ctx.attr("dim", [0])
        dim = tuple(d % x.dim() for d in
                    ([dim] if isinstance(dim, int) else dim))
    return {"Out": torch.sum(x, dim=dim, keepdim=ctx.attr("keep_dim", False),
                             dtype=x.dtype)}


@register_op("less_than")
def _less_than(ctx):
    x, y = _promote(ctx.input("X"), ctx.input("Y"))
    if x.dim() != y.dim():
        y = _broadcast_y(x, y, ctx.attr("axis", -1))
    return {"Out": torch.lt(x, y)}


def _flatten2d(x, num_col_dims):
    lead = int(np.prod(x.shape[:num_col_dims])) if num_col_dims > 0 else 1
    return torch.reshape(x, (lead, -1))


@register_op("mul")
def _mul(ctx):
    x, y = ctx.input("X"), ctx.input("Y")
    xd = ctx.attr("x_num_col_dims", 1)
    yd = ctx.attr("y_num_col_dims", 1)
    if ctx.lod_len("X") is not None:
        xd += 1  # the padded [B, T, ...] layout has one more leading dim
    out = torch.matmul(_flatten2d(x, xd), _flatten2d(y, yd))
    return {"Out": torch.reshape(out, tuple(x.shape[:xd])
                                 + tuple(y.shape[yd:]))}


@register_op("matmul")
def _matmul(ctx):
    x, y = ctx.input("X"), ctx.input("Y")
    if ctx.attr("transpose_X", False) and x.dim() > 1:
        x = x.transpose(-1, -2)
    if ctx.attr("transpose_Y", False) and y.dim() > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = ctx.attr("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": out}


@register_op("sum")
def _sum(ctx):
    xs = ctx.inputs("X")
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": out}


@register_op("scale")
def _scale(ctx):
    x = ctx.input("X")
    s, b = ctx.attr("scale", 1.0), ctx.attr("bias", 0.0)
    if ctx.attr("bias_after_scale", True):
        return {"Out": x * s + b}
    return {"Out": (x + b) * s}


def seq_mask(lens, T, dtype):
    """[B] lengths -> [B, T] 0/1 mask of the real positions."""
    return (torch.arange(T, device=lens.device)[None, :]
            < lens[:, None]).to(dtype)


@register_op("mean")
def _mean(ctx):
    """The mean; over a ragged X, over its real rows only (padding out of
    the sum and the count), in x's dtype as the JAX lowering."""
    x = ctx.input("X")
    lens = ctx.lod_len("X")
    if lens is None and ctx.group is None:
        return {"Out": torch.mean(x)}
    if lens is None:
        total = x.sum(dtype=_acc_dtype(x))
        count = total.new_tensor(float(x.numel()))
    else:
        B, T = x.shape[0], x.shape[1]
        m = seq_mask(lens, T, x.dtype).reshape(
            (B, T) + (1,) * (x.dim() - 2))
        per_step = int(np.prod(x.shape[2:])) if x.dim() > 2 else 1
        if ctx.group is None:
            count = torch.clamp_min(lens.sum().to(x.dtype) * per_step, 1)
            return {"Out": torch.sum(x * m) / count}
        total = torch.sum(x * m, dtype=_acc_dtype(x))
        count = (lens.sum() * per_step).to(total.dtype)
    # the global batch's mean: sum and count summed over the ranks
    # separately (ragged ranks hold different numbers of real rows)
    tot = all_reduce_sum(torch.stack([total, count]), ctx.group, "mean")
    return {"Out": (tot[0] / torch.clamp_min(tot[1], 1)).to(x.dtype)}


def _acc_dtype(x):
    """fp32 accumulation below fp32, as jnp.mean sums bf16."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


@register_op("cumsum")
def _cumsum(ctx):
    """Along a batch-sharded X's axis 0 under a data-parallel group, the
    global batch's: the rank's own prefix plus the totals of the ranks
    before it (after it, reversed), from one gather of every rank's
    column totals."""
    x = ctx.input("X")
    axis = ctx.attr("axis", -1)
    reverse = ctx.attr("reverse", False)
    y = torch.flip(x, (axis,)) if reverse else x
    out = torch.cumsum(y, dim=axis, dtype=x.dtype)
    if ctx.attr("exclusive", False):
        out = out - y  # exclusive prefix = inclusive - self
    if reverse:
        out = torch.flip(out, (axis,))
    if axis % x.dim() == 0 and ctx.batch_sharded(ctx.op.inputs["X"][0]):
        tot = gather_rows(x.sum(dim=0, keepdim=True), ctx.group, "cumsum")
        r = ctx.group.rank
        before = tot[r + 1:] if reverse else tot[:r]
        out = out + before.sum(dim=0).to(x.dtype)
    return {"Out": out}


@register_op("relu")
def _relu(ctx):
    return {"Out": torch.relu(ctx.input("X"))}


@register_op("sign")
def _sign(ctx):
    """-1, 0 or 1, and a NaN stays NaN (torch.sign gives 0), as
    jnp.sign; L1Decay's op."""
    x = ctx.input("X")
    return {"Out": torch.where(torch.isnan(x), x, torch.sign(x))}


@register_op("increment")
def _increment(ctx):
    """X + step in X's dtype (the LR schedules' step counter)."""
    x = ctx.input("X")
    return {"Out": x + torch.as_tensor(ctx.attr("step", 1.0),
                                       dtype=x.dtype)}


@register_op("softmax")
def _softmax(ctx):
    """Over the last axis, as the JAX lowering (which ignores `axis`).  A
    16-bit float input rounds where jax.nn.softmax does: exp(x - max) in
    x's dtype, its sum in fp32 rounded once, the quotient in x's dtype."""
    x = ctx.input("X")
    if x.dtype not in (torch.bfloat16, torch.float16):
        return {"Out": torch.softmax(x, dim=-1)}
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return {"Out": e / e.sum(dim=-1, keepdim=True)}


# the signed integer type of each float type's width, for _order_key
_KEY_INTS = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _order_key(x):
    """Integer keys whose order is IEEE totalOrder on x (x itself for an
    integer tensor): -NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN.  A
    negative float's magnitude bits are flipped, so a larger magnitude
    sorts lower."""
    if not x.is_floating_point():
        return x
    bits = x.detach().view(_KEY_INTS[x.element_size()])
    mag = torch.iinfo(bits.dtype).max
    return bits ^ ((bits >> (8 * x.element_size() - 1)) & mag)


@register_op("top_k")
def _top_k(ctx):
    """jax.lax.top_k's order: descending in IEEE totalOrder (NaNs of
    either sign at the ends, -0 below +0), the lower index first among
    equal values."""
    x, k = ctx.input("X"), int(ctx.attr("k", 1))
    idx = torch.sort(_order_key(x), dim=-1, descending=True,
                     stable=True).indices[..., :k]
    return {"Out": x.gather(-1, idx), "Indices": idx.to(torch.int64)}
