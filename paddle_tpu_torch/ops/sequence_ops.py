"""Sequence (LoD) op lowerings, after paddle_tpu/ops/sequence_ops.py:
sequence_pool (and its first/last-step forms), sequence_softmax,
sequence_expand, sequence_pad, sequence_conv and the dynamic LSTM
(`lstm`).

A ragged var is a padded [B, T, ...] tensor plus its int32 [B] lengths
(`ctx.lod_len`, fluid/functionalizer.py).  The JAX package runs the LSTM
as one `lax.scan` over the padded time axis with per-step masks; the
port runs the same step in a Python loop over T, each step a handful of
torch ops on [B, H] tensors, differentiated by autograd through the
registry's make_forward_and_vjp like every other op.  Outputs at padded
positions are zero.
"""

import torch

from .math_ops import seq_mask
from .registry import register_op


def _lens_or_full(lens, B, T, device):
    if lens is None:
        return torch.full((B,), T, dtype=torch.int32, device=device)
    return lens


def _expand_mask(m, ref):
    """[B, T] -> [B, T, 1, ...], broadcastable to ref."""
    return m.reshape(tuple(m.shape) + (1,) * (ref.dim() - 2))


def _reverse_valid(x, lens):
    """Each row's VALID prefix reversed along the time axis, the padded
    tail left in place."""
    B, T = x.shape[0], x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    ln = lens.to(torch.int64)[:, None]
    idx = torch.where(t < ln, ln - 1 - t, t)
    idx = idx.reshape((B, T) + (1,) * (x.dim() - 2)).expand(x.shape)
    return torch.gather(x, 1, idx)


def _set_out_shape(block, op, slot, shape):
    for n in op.outputs.get(slot, []):
        v = block._find_var_recursive(n)
        if v is not None:
            v.shape = tuple(shape)


def _in_shape(block, op, slot):
    names = op.inputs.get(slot, [])
    if not names:
        return None
    v = block._find_var_recursive(names[0])
    return None if v is None or v.shape is None else tuple(v.shape)


def _infer_sequence_pool(op, block):
    """Out has X's (packed) shape, as the JAX package records it."""
    s = _in_shape(block, op, "X")
    if s:
        _set_out_shape(block, op, "Out", s)


def _infer_lstm(op, block):
    s = _in_shape(block, op, "Input")
    if s:
        H = s[-1] // 4
        _set_out_shape(block, op, "Hidden", (-1, H))
        _set_out_shape(block, op, "Cell", (-1, H))


@register_op("sequence_pool", infer_shape=_infer_sequence_pool)
def _sequence_pool(ctx):
    """AVERAGE, SUM, SQRT, MAX, LAST or FIRST over each sequence's real
    positions.  MAX fills the padding with -1e30 and reduces with amax,
    whose gradient splits ties evenly as jnp.max's does; an empty
    sequence averages to 0 and takes its LAST / FIRST from position 0."""
    x = ctx.input("X")
    ptype = ctx.attr("pooltype", "AVERAGE").upper()
    B, T = x.shape[0], x.shape[1]
    lens = _lens_or_full(ctx.lod_len("X"), B, T, x.device)
    m = _expand_mask(seq_mask(lens, T, x.dtype), x)
    denom = torch.clamp_min(lens.to(x.dtype), 1.0).reshape(
        (B,) + (1,) * (x.dim() - 2))
    if ptype == "AVERAGE":
        out = torch.sum(x * m, dim=1) / denom
    elif ptype == "SUM":
        out = torch.sum(x * m, dim=1)
    elif ptype == "SQRT":
        out = torch.sum(x * m, dim=1) / torch.sqrt(denom)
    elif ptype == "MAX":
        out = torch.amax(torch.where(m > 0, x, torch.full_like(x, -1e30)),
                         dim=1)
    elif ptype == "LAST":
        idx = torch.clamp_min(lens.to(torch.int64) - 1, 0)
        idx = idx.reshape((B, 1) + (1,) * (x.dim() - 2)).expand(
            (B, 1) + tuple(x.shape[2:]))
        out = torch.gather(x, 1, idx)[:, 0]
    elif ptype == "FIRST":
        out = x[:, 0]
    else:
        raise NotImplementedError("sequence_pool type %s" % ptype)
    return {"Out": out}


def lstm_sequence(x, lens, w, bias, h0, c0, use_peepholes, is_reverse):
    """The LSTM over padded pre-projected gates x [B, T, 4H]: (hidden,
    cell), each [B, T, H].  Gate columns {candidate, input, forget,
    output}; peepholes from bias[:, 4H:7H].  A position past a
    sequence's end keeps h and c and outputs zeros; `is_reverse` runs
    each sequence's valid region backwards.  The carry takes the dtype
    that x and w promote to: under AMP x is bf16 while the weights stay
    fp32 masters, and the gate sum is fp32."""
    B, T, H4 = x.shape
    H = H4 // 4
    cdt = torch.promote_types(x.dtype, w.dtype)
    h, c = h0.to(cdt), c0.to(cdt)
    b_gate = bias[..., :4 * H].reshape(1, 4 * H)
    if use_peepholes:
        w_ic = bias[..., 4 * H:5 * H].reshape(1, H)
        w_fc = bias[..., 5 * H:6 * H].reshape(1, H)
        w_oc = bias[..., 6 * H:7 * H].reshape(1, H)
    live = (seq_mask(lens, T, x.dtype) > 0)[..., None]  # [B, T, 1]
    xs = _reverse_valid(x, lens) if is_reverse else x
    hs, cs = [], []
    # the time steps as one unbind: its backward stacks the steps' grads
    # once, where a slice a step would add a full-size grad a step
    for xt, mt in zip(torch.unbind(xs, dim=1), torch.unbind(live, dim=1)):
        gates = xt + h @ w + b_gate
        cand, i, f, o = torch.chunk(gates, 4, dim=-1)
        if use_peepholes:
            i = i + c * w_ic
            f = f + c * w_fc
        i = torch.sigmoid(i)
        f = torch.sigmoid(f)
        c_new = f * c + i * torch.tanh(cand)
        if use_peepholes:
            o = o + c_new * w_oc
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        h = torch.where(mt, h_new, h)
        c = torch.where(mt, c_new, c)
        hs.append(torch.where(mt, h, 0.0))
        cs.append(torch.where(mt, c, 0.0))
    hidden, cell = torch.stack(hs, dim=1), torch.stack(cs, dim=1)
    if is_reverse:
        hidden = _reverse_valid(hidden, lens)
        cell = _reverse_valid(cell, lens)
    return hidden, cell


@register_op("lstm", infer_shape=_infer_lstm)
def _lstm(ctx):
    """Input [B, T, 4H] (projected by an fc before, as in the reference),
    Weight [H, 4H], Bias [1, 4H] or [1, 7H] with peepholes; optional H0
    and C0 [B, H].  Hidden and Cell carry Input's lengths."""
    x, w, bias = ctx.input("Input"), ctx.input("Weight"), ctx.input("Bias")
    B, T = x.shape[0], x.shape[1]
    H = x.shape[2] // 4
    lens = _lens_or_full(ctx.lod_len("Input"), B, T, x.device)
    h0, c0 = ctx.input("H0"), ctx.input("C0")
    if h0 is None:
        h0 = torch.zeros((B, H), dtype=x.dtype, device=x.device)
    if c0 is None:
        c0 = torch.zeros((B, H), dtype=x.dtype, device=x.device)
    use_peepholes = ctx.attr("use_peepholes", True) and \
        bias.shape[-1] == 7 * H
    hidden, cell = lstm_sequence(x, lens, w, bias, h0, c0, use_peepholes,
                                 ctx.attr("is_reverse", False))
    return {"Hidden": hidden, "Cell": cell,
            "Hidden@LOD_LEN": lens, "Cell@LOD_LEN": lens}


def _pool_as(ctx, ptype):
    ctx.attrs = dict(ctx.attrs, pooltype=ptype)
    return _sequence_pool(ctx)


@register_op("sequence_last_step", infer_shape=_infer_sequence_pool)
def _sequence_last_step(ctx):
    return _pool_as(ctx, "LAST")


@register_op("sequence_first_step", infer_shape=_infer_sequence_pool)
def _sequence_first_step(ctx):
    return _pool_as(ctx, "FIRST")


@register_op("sequence_softmax")
def _sequence_softmax(ctx):
    """Softmax over each sequence's real positions of X [B, T] (or [B, T,
    1]); the padding scores -1e30 and outputs 0."""
    x = ctx.input("X")
    squeeze = x.dim() == 3 and x.shape[-1] == 1
    xx = x[..., 0] if squeeze else x
    B, T = xx.shape[0], xx.shape[1]
    lens = _lens_or_full(ctx.lod_len("X"), B, T, x.device)
    m = seq_mask(lens, T, xx.dtype)
    logits = torch.where(m > 0, xx, torch.full_like(xx, -1e30))
    out = torch.softmax(logits, dim=1) * m
    return {"Out": out[..., None] if squeeze else out}


def _conform(out, out_lens, Ty):
    """The expanded [B, Tx, ...] padded or cut to Y's padded width Ty.  A
    cut may only drop padding: a row whose length passes Ty is poisoned
    with NaN (float outputs) rather than clipped, with no host read, as
    the JAX lowering does under jit."""
    if Ty >= out.shape[1]:
        pad = [0, 0] * (out.dim() - 2) + [0, Ty - out.shape[1]]
        return torch.nn.functional.pad(out, pad), out_lens
    trimmed = out[:, :Ty]
    if trimmed.is_floating_point():
        bad = (out_lens > Ty).reshape((-1,) + (1,) * (out.dim() - 1))
        trimmed = torch.where(bad, torch.full_like(trimmed, float("nan")),
                              trimmed)
    return trimmed, torch.clamp_max(out_lens, Ty)


@register_op("sequence_expand")
def _sequence_expand(ctx):
    """A dense X [B, D...] tiled along ragged Y's time axis ([B, Ty, D...],
    masked to Y's lengths, carrying them); a ragged X repeated k = By / Bx
    times a row (Y's rows a static multiple of X's: the beam-style
    case), keeping its own lengths, laid out at Y's padded width.  Y's
    nested per-group counts (the @LOD_SEG path) are not ported."""
    x, y = ctx.input("X"), ctx.input("Y")
    ylens = _lens_or_full(ctx.lod_len("Y"), y.shape[0], y.shape[1],
                          y.device)
    if x.dim() != y.dim():
        T = y.shape[1]
        out = x[:, None].expand((x.shape[0], T) + tuple(x.shape[1:]))
        m = _expand_mask(seq_mask(ylens, T, x.dtype), out)
        return {"Out": out * m, "Out@LOD_LEN": ylens}
    Bx, By = x.shape[0], y.shape[0]
    if By % Bx:
        raise NotImplementedError(
            "sequence_expand of a ragged X needs Y's rows to be a multiple "
            "of X's (got %d and %d); nested Y counts (@LOD_SEG) are not "
            "ported to paddle_tpu_torch yet (ROADMAP.md, queue 1 item 13)"
            % (Bx, By))
    k = By // Bx
    xlens = ctx.lod_len("X")
    out = torch.repeat_interleave(x, k, dim=0)
    out_lens = torch.repeat_interleave(xlens, k, dim=0) \
        if xlens is not None else torch.full(
            (By,), x.shape[1], dtype=torch.int32, device=x.device)
    out, out_lens = _conform(out, out_lens, y.shape[1])
    m = _expand_mask(seq_mask(out_lens, out.shape[1], out.dtype), out)
    return {"Out": out * m, "Out@LOD_LEN": out_lens}


@register_op("sequence_pad")
def _sequence_pad(ctx):
    """The padded [B, T, ...] with PadValue past each length (T the
    padded width, or `padded_length`), and the lengths as int64."""
    x = ctx.input("X")
    lens = _lens_or_full(ctx.lod_len("X"), x.shape[0], x.shape[1],
                         x.device)
    padded_length = ctx.attr("padded_length", -1)
    T = x.shape[1] if padded_length in (None, -1, 0) else padded_length
    out = x[:, :T]
    if T > x.shape[1]:
        out = torch.nn.functional.pad(
            x, [0, 0] * (x.dim() - 2) + [0, T - x.shape[1]])
    pad_value = ctx.input("PadValue")
    if pad_value is not None:
        m = _expand_mask(seq_mask(lens, T, x.dtype), out)
        out = out * m + (1 - m) * pad_value.reshape(
            (1, 1) + (1,) * (out.dim() - 2))
    return {"Out": out, "Length": lens.to(torch.int64)}


def _infer_sequence_conv(op, block):
    """Out is X's packed shape with Filter's width last."""
    s, w = _in_shape(block, op, "X"), _in_shape(block, op, "Filter")
    if s and w:
        _set_out_shape(block, op, "Out", tuple(s[:-1]) + (w[1],))


def context_matrix(x, lens, ctx_len, ctx_start):
    """The context windows of a padded [B, T, D] sequence: [B, T, ctx_len
    * D], position t holding rows t + ctx_start ... t + ctx_start +
    ctx_len - 1 side by side, a row outside [0, T) or past the length as
    zeros; and the [B, T] mask of real positions."""
    B, T, D = x.shape
    m = seq_mask(lens, T, x.dtype)
    xm = x * m[..., None]
    t = torch.arange(T, device=x.device)
    shifted = []
    for k in range(ctx_len):
        src = t + ctx_start + k
        valid = ((src >= 0) & (src < T))[None, :, None]
        g = torch.index_select(xm, 1, src.clamp(0, T - 1))
        shifted.append(torch.where(valid, g, torch.zeros_like(g)))
    return torch.cat(shifted, dim=-1), m


@register_op("sequence_conv", infer_shape=_infer_sequence_conv)
def _sequence_conv(ctx):
    """The context-window projection: each position's `contextLength`
    rows from `contextStart` on (zeros outside the sequence) times Filter
    [contextLength * D, M], zero past each length; Out carries X's
    lengths."""
    x, w = ctx.input("X"), ctx.input("Filter")
    B, T = x.shape[0], x.shape[1]
    lens = _lens_or_full(ctx.lod_len("X"), B, T, x.device)
    stacked, m = context_matrix(x, lens, ctx.attr("contextLength", 3),
                                ctx.attr("contextStart", 0))
    dt = torch.promote_types(stacked.dtype, w.dtype)
    out = torch.matmul(stacked.to(dt), w.to(dt))
    return {"Out": out * m[..., None], "Out@LOD_LEN": lens}
