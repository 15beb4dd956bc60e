"""Math / elementwise / reduction / activation op lowerings, after
paddle_tpu/ops/math_ops.py: every op type registered there.  The
activations (gelu, sigmoid, logsigmoid, tanh, tanh_shrink, relu, relu6,
leaky_relu, elu, softplus, softsign, softshrink, hard_shrink, brelu,
soft_relu, stanh, hard_sigmoid, swish, thresholded_relu, erf and the
unary math), cast, the elementwise binary ops with fluid's `axis`
broadcasting, the compares and logical ops, clip, clip_by_norm,
squared_l2_norm, mul (fc's matmul), matmul, sum, scale, mean, the
reduce_* family, arg_max, arg_min, argsort, top_k, cumsum, softmax,
log_softmax, isfinite / isinf / isnan, l2_normalize and increment.  The
matmuls are plain torch.matmul (TF32 off; bf16 summed in fp32 and
rounded once), as the JAX package leaves them to XLA.

Where torch's gradient rule differs from JAX's at a tie, a zero or a
NaN, the lowering keeps JAX's: `abs` passes the cotangent at +-0 (its
sign is taken as x >= 0), `maximum` / `minimum` (so `clip`, relu6,
brelu, hard_sigmoid and soft_relu, built from them as jnp.clip is) give
each operand half at a tie and neither anything where an operand is
NaN, and `sign` passes nothing at a NaN.

On a ragged (LoD) X, padded [B, T, ...] at run time where the program's
shapes are the packed [rows, ...] ones, `mul` flattens one more leading
dim, the elementwise ops shift an `axis` >= 1 by one, and `mean`
averages over the real rows only, as the JAX lowerings do.  Under a
data-parallel group (ExecContext.group) `mean` is the global batch's:
its sum and its count are each summed over the ranks; `cumsum` along a
batch-sharded axis 0 adds the lower ranks' totals."""

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.mesh import all_reduce_sum, gather_rows
from .registry import register_op


class _JaxMaxMin(torch.autograd.Function):
    """torch.maximum / torch.minimum's value with jnp.maximum's gradient:
    the cotangent to the operand that wins, half to each at a tie, and
    none to either where one is NaN (no comparison holds there).  x and
    y have one shape."""

    @staticmethod
    def forward(ctx, x, y, take_max):
        ctx.save_for_backward(x, y)
        ctx.take_max = take_max
        return torch.maximum(x, y) if take_max else torch.minimum(x, y)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        wins_x = x > y if ctx.take_max else x < y
        wins_y = y > x if ctx.take_max else y < x
        half = (x == y).to(g.dtype) * 0.5
        gx = g * (wins_x.to(g.dtype) + half) \
            if ctx.needs_input_grad[0] else None
        gy = g * (wins_y.to(g.dtype) + half) \
            if ctx.needs_input_grad[1] else None
        return gx, gy, None


def _operands(x, y):
    if not isinstance(y, torch.Tensor):
        y = torch.full((), y, dtype=x.dtype, device=x.device)
    return torch.broadcast_tensors(x, y)


def jmax(x, y):
    """jnp.maximum (y a tensor or a number)."""
    return _JaxMaxMin.apply(*_operands(x, y), True)


def jmin(x, y):
    """jnp.minimum (y a tensor or a number)."""
    return _JaxMaxMin.apply(*_operands(x, y), False)


def jclip(x, lo, hi):
    """jnp.clip: minimum(maximum(x, lo), hi), so x at a bound gets half
    the cotangent."""
    return jmin(jmax(x, lo), hi)


class _JaxAbs(torch.autograd.Function):
    """torch.abs's value with lax.abs's gradient: sign taken as x >= 0,
    so +-0 pass the cotangent (torch.abs gives 0) and NaN negates it."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def jabs(x):
    return _JaxAbs.apply(x) if x.is_floating_point() else torch.abs(x)


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
_register_elementwise("elementwise_min", jmin)
_register_elementwise("elementwise_div", torch.div)
_register_elementwise("elementwise_max", jmax)
_register_elementwise("elementwise_pow", torch.pow)
# jnp.mod: the remainder takes the divisor's sign
_register_elementwise("elementwise_mod", torch.remainder)


def _floor_divide(x, y):
    """jnp.floor_divide: an integer quotient rounded down; for floats
    JAX's divmod, (x - fmod(x, y)) / y stepped down by one where the
    remainder's sign is not the divisor's, then rounded (a zero divisor
    gives NaN, where torch.floor_divide gives +-inf).  No gradient, as
    in JAX (whose zero tangent of the rounding is structural: through
    autograd, 0 / 0 at a zero divisor would be NaN)."""
    x, y = x.detach(), y.detach()
    if not x.is_floating_point():
        return torch.div(x, y, rounding_mode="floor")
    mod = torch.fmod(x, y)
    div = (x - mod) / y
    fix = (mod != 0) & (torch.sign(y) != torch.sign(mod))
    return torch.round(torch.where(fix, div - 1, div))


_register_elementwise("elementwise_floordiv", _floor_divide)


@register_op("equal")
def _equal(ctx):
    x, y = _promote(ctx.input("X"), ctx.input("Y"))
    if x.dim() != y.dim():
        y = _broadcast_y(x, y, ctx.attr("axis", -1))
    return {"Out": torch.eq(x, y)}


def _register_unary(name, fn):
    register_op(name)(lambda ctx: {"Out": fn(ctx.input("X"))})


_register_unary("floor", torch.floor)
_register_unary("ceil", torch.ceil)
_register_unary("exp", torch.exp)
_register_unary("sqrt", torch.sqrt)
_register_unary("abs", jabs)
_register_unary("cos", torch.cos)
_register_unary("sin", torch.sin)
_register_unary("log", torch.log)
_register_unary("square", torch.square)
_register_unary("logical_not", torch.logical_not)
_register_unary("round", torch.round)       # half to even, as jnp.round
_register_unary("erf", torch.erf)
_register_unary("reciprocal", lambda x: 1.0 / x)
_register_unary("rsqrt", lambda x: 1.0 / torch.sqrt(x))
_register_unary("logsigmoid", lambda x: -F.softplus(-x))
_register_unary("tanh_shrink", lambda x: x - torch.tanh(x))
# jax.nn.softplus's value and its gradient, sigmoid(x)
_register_unary("softplus", F.softplus)
_register_unary("softsign", lambda x: x / (torch.abs(x) + 1))


def _register_activation(name, fn):
    """An activation with attrs: `fn(x, attr)` as the JAX lowering's
    formula, in x's dtype."""
    register_op(name)(lambda ctx: {"Out": fn(ctx.input("X"), ctx.attr)})


_register_activation("relu6", lambda x, a: jclip(
    x, 0.0, a("threshold", 6.0)))
_register_activation("brelu", lambda x, a: jclip(
    x, a("t_min", 0.0), a("t_max", 24.0)))
_register_activation("hard_sigmoid", lambda x, a: jclip(
    a("slope", 0.2) * x + a("offset", 0.5), 0.0, 1.0))
_register_activation("soft_relu", lambda x, a: torch.log1p(torch.exp(jclip(
    x, -a("threshold", 40.0), a("threshold", 40.0)))))
# jax.nn.leaky_relu: the identity's gradient at 0
_register_activation("leaky_relu", lambda x, a: torch.where(
    x >= 0, x, a("alpha", 0.02) * x))
_register_activation("elu", lambda x, a: torch.where(
    x > 0, x, a("alpha", 1.0) * torch.expm1(torch.where(
        x > 0, torch.zeros_like(x), x))))
_register_activation("stanh", lambda x, a: a("scale_b", 1.7159) * torch.tanh(
    a("scale_a", 2.0 / 3.0) * x))
_register_activation("swish", lambda x, a: x * torch.sigmoid(
    a("beta", 1.0) * x))
_register_activation("thresholded_relu", lambda x, a: torch.where(
    x > a("threshold", 1.0), x, torch.zeros_like(x)))
_register_activation("hard_shrink", lambda x, a: torch.where(
    torch.abs(x) > a("threshold", 0.5), x, torch.zeros_like(x)))


def _softshrink(x, a):
    lam = a("lambda", 0.5)
    return torch.where(x > lam, x - lam, torch.where(
        x < -lam, x + lam, torch.zeros_like(x)))


_register_activation("softshrink", _softshrink)


_INT_TYPES = (torch.int8, torch.uint8, torch.int16, torch.int32,
              torch.int64)


def float_to_int(x, dtype):
    """A float tensor converted to integer `dtype` as XLA converts it:
    truncated toward zero, saturated at the type's limits (+-inf too),
    NaN to 0.  Decided in float64, where every limit of these types is
    exact (2^31 in fp32 would round and overflow again); the conversion
    itself only sees values in range."""
    info = torch.iinfo(dtype)
    xf = torch.nan_to_num(x.to(torch.float64))  # +-inf to +-DBL_MAX
    big = xf >= float(info.max) + 1.0
    small = xf < float(info.min)
    safe = torch.where(big | small, torch.zeros_like(xf), xf).to(dtype)
    return torch.where(big, torch.full_like(safe, info.max),
                       torch.where(small, torch.full_like(safe, info.min),
                                   safe))


@register_op("cast")
def _cast(ctx):
    """Float to an integer type saturates as JAX does (float_to_int); an
    int64 target keeps the port's int64 (the JAX package's x64-off
    int32 saturates at int32's limits)."""
    from ..fluid import core as fcore
    x = ctx.input("X")
    dtype = fcore.convert_dtype_to_torch(ctx.attr("out_dtype"))
    if x.is_floating_point() and dtype in _INT_TYPES:
        return {"Out": float_to_int(x, dtype)}
    return {"Out": x.to(dtype)}


def _reduce_dims(ctx, x):
    """The reduced axes: `dim` (every axis with `reduce_all`)."""
    if ctx.attr("reduce_all", False):
        return tuple(range(x.dim()))
    dim = ctx.attr("dim", [0])
    return tuple(sorted({d % x.dim() for d in
                         ([dim] if isinstance(dim, int) else dim)}))


def _reduce_each(fn, x, dims, keep):
    """fn(x, dim, keepdim) applied over `dims` one axis at a time, the
    last first (for torch reductions that take a single axis)."""
    for d in reversed(dims):
        x = fn(x, d, keepdim=keep)
    return x


def _register_reduce(name, fn):
    def lower(ctx):
        x = ctx.input("X")
        return {"Out": fn(x, _reduce_dims(ctx, x),
                          ctx.attr("keep_dim", False))}
    register_op(name)(lower)


# reduce_sum in x's dtype as jnp.sum (an int32 sum stays int32);
# reduce_max / _min through amax / amin, whose gradient splits evenly
# among tied maxima as jnp.max's does
_register_reduce("reduce_sum", lambda x, d, k: torch.sum(
    x, dim=d, keepdim=k, dtype=x.dtype))
_register_reduce("reduce_mean", lambda x, d, k: torch.mean(
    x, dim=d, keepdim=k))
_register_reduce("reduce_max", lambda x, d, k: torch.amax(
    x, dim=d, keepdim=k))
_register_reduce("reduce_min", lambda x, d, k: torch.amin(
    x, dim=d, keepdim=k))
_register_reduce("reduce_prod", lambda x, d, k: _reduce_each(
    torch.prod, x, d, k))
_register_reduce("reduce_all", lambda x, d, k: _reduce_each(
    torch.all, x.bool(), d, k))
_register_reduce("reduce_any", lambda x, d, k: _reduce_each(
    torch.any, x.bool(), d, k))


def _register_compare(name, fn):
    def lower(ctx):
        x, y = _promote(ctx.input("X"), ctx.input("Y"))
        if x.dim() != y.dim():
            y = _broadcast_y(x, y, ctx.attr("axis", -1))
        return {"Out": fn(x, y)}
    register_op(name)(lower)


_register_compare("less_than", torch.lt)
_register_compare("less_equal", torch.le)
_register_compare("greater_than", torch.gt)
_register_compare("greater_equal", torch.ge)
_register_compare("not_equal", torch.ne)
_register_compare("logical_and", torch.logical_and)
_register_compare("logical_or", torch.logical_or)
_register_compare("logical_xor", torch.logical_xor)


@register_op("pow")
def _pow(ctx):
    """x ** factor in x's dtype."""
    x = ctx.input("X")
    return {"Out": torch.pow(x, ctx.attr("factor", 1.0)).to(x.dtype)}


@register_op("clip")
def _clip(ctx):
    return {"Out": jclip(ctx.input("X"), ctx.attr("min"), ctx.attr("max"))}


@register_op("clip_by_norm")
def _clip_by_norm(ctx):
    """x * min(max_norm / max(||x||, 1e-12), 1): x whole, scaled to at
    most max_norm in L2."""
    x = ctx.input("X")
    norm = torch.sqrt(torch.sum(torch.square(x)))
    scale = torch.clamp(ctx.attr("max_norm") / torch.clamp(norm, min=1e-12),
                        max=1.0)
    return {"Out": x * scale}


@register_op("squared_l2_norm")
def _squared_l2_norm(ctx):
    return {"Out": torch.sum(torch.square(ctx.input("X"))).reshape((1,))}


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
    jnp.sign, with no gradient anywhere (a NaN's too); L1Decay's op."""
    x = ctx.input("X")
    return {"Out": torch.where(torch.isnan(x),
                               torch.full_like(x, float("nan")),
                               torch.sign(x))}


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


@register_op("log_softmax")
def _log_softmax(ctx):
    """Over the last axis, as the JAX lowering."""
    return {"Out": torch.log_softmax(ctx.input("X"), dim=-1)}


def _first_index(hit, axis):
    """The first index along `axis` where `hit` holds (int64)."""
    n = hit.shape[axis]
    shape = [1] * hit.dim()
    shape[axis] = n
    pos = torch.arange(n, device=hit.device).reshape(shape)
    return torch.where(hit, pos, torch.full_like(pos, n)).amin(dim=axis)


def _arg_extreme(x, axis, largest):
    """jnp.argmax / argmin: the first index of the extreme value, or of
    the first NaN where the axis holds one; int64 (the port's rule for
    ids), decided on the device."""
    axis = axis % x.dim()
    ext = x.amax(dim=axis, keepdim=True) if largest \
        else x.amin(dim=axis, keepdim=True)
    hit = x == ext
    if x.is_floating_point():
        nan = torch.isnan(x)
        hit = torch.where(nan.any(dim=axis, keepdim=True), nan, hit)
    return _first_index(hit, axis)


@register_op("arg_max")
def _arg_max(ctx):
    return {"Out": _arg_extreme(ctx.input("X"), ctx.attr("axis", -1),
                                True)}


@register_op("arg_min")
def _arg_min(ctx):
    return {"Out": _arg_extreme(ctx.input("X"), ctx.attr("axis", -1),
                                False)}


@register_op("argsort")
def _argsort(ctx):
    """Ascending and stable as jnp.sort / jnp.argsort: -0 and +0 equal,
    NaNs of either sign last; Indices int64.  Sorted on integer keys of
    the canonicalized values (on the card torch.sort of floats puts a
    negative NaN first), the values gathered back from X."""
    x = ctx.input("X")
    axis = ctx.attr("axis", -1)
    if x.is_floating_point():
        canon = torch.where(torch.isnan(x), torch.full_like(x, float("nan")),
                            torch.where(x == 0, torch.zeros_like(x), x))
        key = _order_key(canon)
    else:
        key = x
    idx = torch.sort(key, dim=axis, stable=True).indices
    return {"Out": torch.gather(x, axis, idx), "Indices": idx}


@register_op("isfinite")
def _isfinite(ctx):
    """One [1] bool: every element finite (the reference reduces)."""
    return {"Out": torch.isfinite(ctx.input("X")).all().reshape((1,))}


@register_op("isinf")
def _isinf(ctx):
    return {"Out": torch.isinf(ctx.input("X")).any().reshape((1,))}


@register_op("isnan")
def _isnan(ctx):
    return {"Out": torch.isnan(ctx.input("X")).any().reshape((1,))}


@register_op("l2_normalize")
def _l2_normalize(ctx):
    """x / max(||x||, epsilon) along `axis`, the norm clamped after the
    sqrt; Norm is the unclamped norm."""
    x = ctx.input("X")
    norm = torch.sqrt(torch.sum(torch.square(x), dim=ctx.attr("axis", -1),
                                keepdim=True))
    return {"Out": x / jmax(norm, ctx.attr("epsilon", 1e-10)),
            "Norm": norm}
