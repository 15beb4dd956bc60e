"""Sequence (LoD) op lowerings, after paddle_tpu/ops/sequence_ops.py:
sequence_pool (and its first/last-step forms), sequence_softmax,
sequence_expand, sequence_pad, sequence_conv, the flat sequence ops
(mask, length, reverse, concat, unpad, enumerate, slice, erase,
reshape), the recurrent family (lstm, lstmp, gru, gru_unit, lstm_unit,
simple_rnn, attention_lstm) and the fused recurrent ops (fusion_lstm,
fusion_gru, fusion_seqconv_eltadd_relu, fusion_seqexpand_concat_fc,
fused_embedding_fc_lstm) and the nested (2-level LoD) ops
(nested_to_outer and its gradient, attach_lod, kmax_seq_score,
sub_nested_seq).

A ragged var is a padded [B, T, ...] tensor plus its int32 [B] lengths
(`ctx.lod_len`, fluid/functionalizer.py).  The JAX package runs each
recurrence as one `lax.scan` over the padded time axis with per-step
masks; the port runs the same step in a Python loop over T, each step a
handful of torch ops on [B, H] tensors, differentiated by autograd
through the registry's make_forward_and_vjp like every other op.
Outputs at padded positions are zero.

A nested var's inner sequences are the rows of that encoding; its
`@LOD_SEG` companion (`ctx.lod_seg`) counts them per outer group.  The
sizes that depend on the counts (the most sentences in a group, the
rows a selection keeps) are read on the host once per op, as
sequence_mask(maxlen=-1) reads max(x); the data stays on the device.
"""
import numpy as np
import torch

from .math_ops import _promote, jabs, jmax, seq_mask
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


def _infer_same(slot_in, slot_out):
    """Out keeps the input's (packed) shape, as the JAX package records
    it."""
    def fn(op, block):
        s = _in_shape(block, op, slot_in)
        if s:
            _set_out_shape(block, op, slot_out, s)
    return fn


def _zeros_state(x, B, width):
    return torch.zeros((B, width), dtype=x.dtype, device=x.device)


def _h0_c0(ctx, x, B, D):
    """The H0 and C0 inputs, zeros [B, D] in x's dtype where absent."""
    h0, c0 = ctx.input("H0"), ctx.input("C0")
    return (_zeros_state(x, B, D) if h0 is None else h0,
            _zeros_state(x, B, D) if c0 is None else c0)


def _infer_rows(slot, width, *outs):
    """The outputs `outs` are [-1, width(shape of `slot`)]: one packed row
    a time step of the ragged input."""
    def fn(op, block):
        s = _in_shape(block, op, slot)
        if s:
            for out in outs:
                _set_out_shape(block, op, out, (-1, width(s)))
    return fn


@register_op("sequence_pool", infer_shape=_infer_same("X", "Out"))
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


def _steps(x, lens, is_reverse):
    """The time steps of a padded [B, T, ...] sequence, each sequence's
    valid region reversed with `is_reverse`, and each step's [B, 1] mask
    of the rows still running.  One unbind each: its backward stacks the
    steps' grads once, where a slice a step would add a full-size grad a
    step."""
    live = (seq_mask(lens, x.shape[1], x.dtype) > 0)[..., None]
    xs = _reverse_valid(x, lens) if is_reverse else x
    return zip(torch.unbind(xs, dim=1), torch.unbind(live, dim=1))


def _stack_steps(outs, lens, is_reverse):
    """The steps' [B, ...] outputs as one [B, T, ...] sequence, in the
    input's time order."""
    y = torch.stack(outs, dim=1)
    return _reverse_valid(y, lens) if is_reverse else y


def lstm_sequence(x, lens, w, bias, h0, c0, use_peepholes, is_reverse,
                  proj=None):
    """The LSTM over padded pre-projected gates x [B, T, 4H]: (hidden,
    cell), each [B, T, H].  Gate columns {candidate, input, forget,
    output}; peepholes from bias[:, 4H:7H].  A position past a
    sequence's end keeps h and c and outputs zeros; `is_reverse` runs
    each sequence's valid region backwards.  With `proj` (LSTMP) the
    recurrent state is proj(h) [B, P], which w [P, 4H] multiplies and
    which comes out in place of the hidden.  The carry takes the dtype
    that x and w promote to: under AMP x is bf16 while the weights stay
    fp32 masters, and the gate sum is fp32."""
    H = x.shape[2] // 4
    cdt = torch.promote_types(x.dtype, w.dtype)
    h, c = h0.to(cdt), c0.to(cdt)
    b_gate = bias[..., :4 * H].reshape(1, 4 * H)
    if use_peepholes:
        w_ic = bias[..., 4 * H:5 * H].reshape(1, H)
        w_fc = bias[..., 5 * H:6 * H].reshape(1, H)
        w_oc = bias[..., 6 * H:7 * H].reshape(1, H)
    hs, cs = [], []
    for xt, mt in _steps(x, lens, is_reverse):
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
        if proj is not None:
            h_new = proj(h_new)
        h = torch.where(mt, h_new, h)
        c = torch.where(mt, c_new, c)
        hs.append(torch.where(mt, h, 0.0))
        cs.append(torch.where(mt, c, 0.0))
    return (_stack_steps(hs, lens, is_reverse),
            _stack_steps(cs, lens, is_reverse))


@register_op("lstm", infer_shape=_infer_rows(
    "Input", lambda s: s[-1] // 4, "Hidden", "Cell"))
def _lstm(ctx):
    """Input [B, T, 4H] (projected by an fc before, as in the reference),
    Weight [H, 4H], Bias [1, 4H] or [1, 7H] with peepholes; optional H0
    and C0 [B, H].  Hidden and Cell carry Input's lengths."""
    x, w, bias = ctx.input("Input"), ctx.input("Weight"), ctx.input("Bias")
    B, T = x.shape[0], x.shape[1]
    H = x.shape[2] // 4
    lens = _lens_or_full(ctx.lod_len("Input"), B, T, x.device)
    h0, c0 = _h0_c0(ctx, x, B, H)
    use_peepholes = ctx.attr("use_peepholes", True) and \
        bias.shape[-1] == 7 * H
    hidden, cell = lstm_sequence(x, lens, w, bias, h0, c0, use_peepholes,
                                 ctx.attr("is_reverse", False))
    return {"Hidden": hidden, "Cell": cell,
            "Hidden@LOD_LEN": lens, "Cell@LOD_LEN": lens}


def _pool_as(ctx, ptype):
    ctx.attrs = dict(ctx.attrs, pooltype=ptype)
    return _sequence_pool(ctx)


@register_op("sequence_last_step", infer_shape=_infer_same("X", "Out"))
def _sequence_last_step(ctx):
    return _pool_as(ctx, "LAST")


@register_op("sequence_first_step", infer_shape=_infer_same("X", "Out"))
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
    masked to Y's lengths, carrying them); a ragged X repeated per
    sequence, keeping its own lengths, laid out at Y's padded width.
    With a nested Y (its @LOD_SEG counts) X's sequence i repeats
    counts[i] times, the reference's ref_level expansion
    (sequence_expand_op.h); the counts are read on the host, as the
    output's row count depends on them.  Otherwise Y's rows must be a
    static multiple k of X's (the beam-style case: each row k times)."""
    x, y = ctx.input("X"), ctx.input("Y")
    ylens = _lens_or_full(ctx.lod_len("Y"), y.shape[0], y.shape[1],
                          y.device)
    if x.dim() != y.dim():
        T = y.shape[1]
        out = x[:, None].expand((x.shape[0], T) + tuple(x.shape[1:]))
        m = _expand_mask(seq_mask(ylens, T, x.dtype), out)
        return {"Out": out * m, "Out@LOD_LEN": ylens}
    Bx, By = x.shape[0], y.shape[0]
    xlens = _lens_or_full(ctx.lod_len("X"), Bx, x.shape[1], x.device)
    seg = ctx.lod_seg("Y")
    if seg is not None:
        counts = [int(c) for c in seg.tolist()]
        if len(counts) != Bx or sum(counts) != By:
            raise ValueError(
                "sequence_expand: Y's outer counts %r do not match X's %d "
                "sequences / Y's %d rows" % (counts, Bx, By))
        reps = torch.tensor(counts, dtype=torch.int64, device=x.device)
        out = torch.repeat_interleave(x, reps, dim=0, output_size=By)
        out_lens = torch.repeat_interleave(xlens, reps, dim=0,
                                           output_size=By)
    elif By % Bx:
        raise NotImplementedError(
            "sequence_expand of a ragged X needs Y's rows to be a multiple "
            "of X's (got %d and %d), or a nested Y carrying per-sequence "
            "repeat counts" % (Bx, By))
    else:
        k = By // Bx
        out = torch.repeat_interleave(x, k, dim=0)
        out_lens = torch.repeat_interleave(xlens, k, dim=0)
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


# ---------------------------------------------------------------------------
# the flat sequence ops: mask, length, reverse, concat, unpad, enumerate,
# slice, erase, reshape
# ---------------------------------------------------------------------------

def _infer_sequence_mask(op, block):
    s = _in_shape(block, op, "X")
    if s:
        _set_out_shape(block, op, "Y", tuple(s) + (op.attrs.get("maxlen",
                                                                 -1),))


def _squeezed_ids(x):
    """A [B, T, 1] id sequence as [B, T] (and whether it was)."""
    squeeze = x.dim() == 3 and x.shape[-1] == 1
    return (x[..., 0] if squeeze else x), squeeze


@register_op("sequence_mask", infer_shape=_infer_sequence_mask)
def _sequence_mask(ctx):
    """Y[..., j] = j < X[...], in `out_dtype` (int64 by default).  With
    maxlen -1 the width is max(X), read on the host: the output's shape
    depends on the data, as the reference computed it at launch."""
    from ..fluid import core as fcore
    x = ctx.input("X")
    maxlen = ctx.attr("maxlen", -1)
    if maxlen is None or maxlen < 0:
        maxlen = int(x.max()) if x.numel() else 0
    dtype = fcore.convert_dtype_to_torch(
        ctx.attr("out_dtype", fcore.VarDesc.VarType.INT64))
    flat = x.reshape(-1)
    m = torch.arange(maxlen, device=x.device)[None, :] < flat[:, None]
    return {"Y": m.to(dtype).reshape(tuple(x.shape) + (maxlen,))}


@register_op("sequence_length")
def _sequence_length(ctx):
    """Each sequence's length [B], int64 (the JAX package's is int32:
    x64 off); a dense X is full-width."""
    x = ctx.input("X")
    lens = _lens_or_full(ctx.lod_len("X"), x.shape[0], x.shape[1], x.device)
    return {"Out": lens.to(torch.int64)}


@register_op("sequence_reverse", infer_shape=_infer_same("X", "Y"))
def _sequence_reverse(ctx):
    x = ctx.input("X")
    lens = _lens_or_full(ctx.lod_len("X"), x.shape[0], x.shape[1], x.device)
    return {"Y": _reverse_valid(x, lens), "Y@LOD_LEN": lens}


def _time_gather(x, idx):
    """x [B, T, ...] at the time positions idx [B, T'] -> [B, T', ...]."""
    idx = idx.reshape(tuple(idx.shape) + (1,) * (x.dim() - 2)).expand(
        tuple(idx.shape) + tuple(x.shape[2:]))
    return torch.gather(x, 1, idx.to(torch.int64))


@register_op("sequence_concat", infer_shape=_infer_same("X", "Out"))
def _sequence_concat(ctx):
    """Row b of Out is the valid rows of row b of each X, one after the
    other; Out's padded width is the sum of the inputs'."""
    xs = ctx.inputs("X")
    B = xs[0].shape[0]
    lens = [_lens_or_full(l, B, x.shape[1], x.device)
            for x, l in zip(xs, ctx.lod_lens("X"))]
    T_out = sum(x.shape[1] for x in xs)
    out = xs[0].new_zeros((B, T_out) + tuple(xs[0].shape[2:]))
    total = torch.zeros((B,), dtype=torch.int32, device=xs[0].device)
    t_idx = torch.arange(T_out, device=xs[0].device)[None, :]
    for x, l in zip(xs, lens):
        src = torch.clamp(t_idx - total[:, None], 0, x.shape[1] - 1)
        in_range = (t_idx >= total[:, None]) & (t_idx < (total + l)[:, None])
        out = torch.where(_expand_mask(in_range, out), _time_gather(x, src),
                          out)
        total = total + l
    return {"Out": out, "Out@LOD_LEN": total}


@register_op("sequence_unpad", infer_shape=_infer_same("X", "Out"))
def _sequence_unpad(ctx):
    """The padded X as a ragged var of lengths Length, zero past them."""
    x = ctx.input("X")
    lens = ctx.input("Length").reshape(-1).to(torch.int32)
    return {"Out": x * _expand_mask(seq_mask(lens, x.shape[1], x.dtype), x),
            "Out@LOD_LEN": lens}


@register_op("sequence_enumerate", infer_shape=_infer_same("X", "Out"))
def _sequence_enumerate(ctx):
    """Each position's window of `win_size` ids from it on, `pad_value`
    past the sequence's end: [B, T, win_size]."""
    xx, _ = _squeezed_ids(ctx.input("X"))
    B, T = xx.shape
    lens = _lens_or_full(ctx.lod_len("X"), B, T, xx.device)
    pad = torch.full_like(xx, ctx.attr("pad_value", 0))
    cols = []
    for k in range(ctx.attr("win_size")):
        idx = torch.arange(T, device=xx.device) + k
        g = torch.index_select(xx, 1, torch.clamp(idx, 0, T - 1))
        cols.append(torch.where(idx[None, :] < lens[:, None], g, pad))
    out = torch.stack(cols, dim=-1)
    m = seq_mask(lens, T, out.dtype)[..., None]
    return {"Out": (out * m).to(xx.dtype), "Out@LOD_LEN": lens}


@register_op("sequence_slice", infer_shape=_infer_same("X", "Out"))
def _sequence_slice(ctx):
    """Row b's Length[b] positions from Offset[b] on (clamped into the
    padded width), zero past Length[b]."""
    x = ctx.input("X")
    offset = ctx.input("Offset").reshape(-1).to(torch.int64)
    length = ctx.input("Length").reshape(-1).to(torch.int32)
    T = x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    out = _time_gather(x, torch.clamp(offset[:, None] + t, 0, T - 1))
    return {"Out": out * _expand_mask(seq_mask(length, T, x.dtype), out),
            "Out@LOD_LEN": length}


@register_op("sequence_erase")
def _sequence_erase(ctx):
    """Each sequence without the listed `tokens`, the survivors moved to
    the front in their order: a cumsum of the keep mask numbers them,
    and each is scattered to its number (the dropped to a spare column
    that is cut off).  No sort: a sort's order of equal keys is what the
    card does not promise."""
    xx, squeeze = _squeezed_ids(ctx.input("X"))
    B, T = xx.shape
    lens = _lens_or_full(ctx.lod_len("X"), B, T, xx.device)
    keep = torch.arange(T, device=xx.device)[None, :] < lens[:, None]
    for tok in ctx.attr("tokens", []) or []:
        keep = keep & (xx != tok)
    pos = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    dest = torch.where(keep, pos, torch.full_like(pos, T))
    out = xx.new_zeros((B, T + 1)).scatter(1, dest, xx)[:, :T]
    new_lens = keep.sum(dim=1).to(torch.int32)
    return {"Out": out[..., None] if squeeze else out,
            "Out@LOD_LEN": new_lens}


@register_op("sequence_reshape", infer_shape=_infer_same("X", "Out"))
def _sequence_reshape(ctx):
    """Each sequence's flat payload (length * D values, row-major)
    re-chunked into rows of `new_dim`; the padded width is the static
    ceil(T * D / new_dim).  A dense X whose T * D new_dim does not divide
    raises ValueError, as the reference's per-sequence check."""
    x = ctx.input("X")
    lens = ctx.lod_len("X")
    new_dim = int(ctx.attr("new_dim"))
    B, T, D = x.shape
    if D == new_dim:
        out = {"Out": x}
        if lens is not None:
            out["Out@LOD_LEN"] = lens
        return out
    if lens is None and (T * D) % new_dim:
        raise ValueError("sequence_reshape: T*D = %d*%d = %d not divisible "
                         "by new_dim %d" % (T, D, T * D, new_dim))
    T_out = -(-(T * D) // new_dim)
    flat_idx = (torch.arange(T_out, device=x.device)[:, None] * new_dim
                + torch.arange(new_dim, device=x.device)[None, :])
    out = x[:, torch.clamp(flat_idx // D, 0, T - 1), flat_idx % D]
    if lens is None:
        return {"Out": out}
    valid = flat_idx[None] < (lens.to(torch.int64) * D)[:, None, None]
    return {"Out": torch.where(valid, out, torch.zeros_like(out)),
            "Out@LOD_LEN": (lens * D) // new_dim}


# ---------------------------------------------------------------------------
# the recurrent family: GRU (sequence and unit), the LSTM unit, LSTMP, the
# Elman RNN and the attention LSTM, each step written out (the reference's
# gate layouts are not torch.nn's) and differentiated by autograd
# ---------------------------------------------------------------------------

def _infer_lstmp(op, block):
    s = _in_shape(block, op, "Input")
    pw = _in_shape(block, op, "ProjWeight")
    if s and pw:
        _set_out_shape(block, op, "Projection", (-1, pw[1]))
        _set_out_shape(block, op, "Cell", (-1, s[-1] // 4))


def _mm(a, b):
    """a @ b in the dtype the two promote to (jnp.einsum promotes; torch's
    matmul refuses mixed dtypes)."""
    a, b = _promote(a, b)
    return torch.matmul(a, b)


def gru_sequence(x, lens, w, h0, is_reverse):
    """The GRU over padded gates x [B, T, 3H] (bias already added): the
    hidden [B, T, H].  Fluid's gate columns are {update u, reset r,
    candidate}: u and r from x[:, :2H] + h @ W[:, :2H], the candidate
    from x[:, 2H:] + (r * h) @ W[:, 2H:] (the reset applied before the
    product), and h' = (1 - u) * h + u * candidate.  Always sigmoid and
    tanh, as the JAX lowering (it reads neither activation attr).  The
    carry is masked as lstm_sequence's, in the dtype x and w promote
    to."""
    H = x.shape[2] // 3
    h = h0.to(torch.promote_types(x.dtype, w.dtype))
    w_rz, w_c = w[:, :2 * H], w[:, 2 * H:]
    hs = []
    for xt, mt in _steps(x, lens, is_reverse):
        u, r = torch.chunk(torch.sigmoid(xt[:, :2 * H] + h @ w_rz), 2,
                           dim=-1)
        cand = torch.tanh(xt[:, 2 * H:] + (r * h) @ w_c)
        h = torch.where(mt, (1 - u) * h + u * cand, h)
        hs.append(torch.where(mt, h, 0.0))
    return _stack_steps(hs, lens, is_reverse)


@register_op("gru", infer_shape=_infer_rows(
    "Input", lambda s: s[-1] // 3, "Hidden"))
def _gru(ctx):
    """Input [B, T, 3H] (projected by an fc before), Weight [H, 3H], Bias
    [1, 3H], optional H0 [B, H].  BatchGate is Input + Bias; the batch
    reset-hidden and hidden outputs are the hidden, as in the JAX
    lowering."""
    x, w, bias = ctx.input("Input"), ctx.input("Weight"), ctx.input("Bias")
    B, T = x.shape[0], x.shape[1]
    H = x.shape[2] // 3
    lens = _lens_or_full(ctx.lod_len("Input"), B, T, x.device)
    h0 = ctx.input("H0")
    if h0 is None:
        h0 = _zeros_state(x, B, H)
    if bias is not None:
        x = x + bias.reshape(1, 1, 3 * H)
    hidden = gru_sequence(x, lens, w, h0, ctx.attr("is_reverse", False))
    return {"Hidden": hidden, "Hidden@LOD_LEN": lens, "BatchGate": x,
            "BatchResetHiddenPrev": hidden, "BatchHidden": hidden}


_UNIT_ACTS = {"tanh": torch.tanh, "relu": torch.relu,
              "sigmoid": torch.sigmoid, "identity": lambda v: v}


@register_op("gru_unit")
def _gru_unit(ctx):
    """One GRU step: Input [B, 3H] (+ Bias), HiddenPrev [B, H], Weight
    [H, 3H], with the `gate_activation` and `activation` attrs.  Gate is
    the activated [u, r, candidate]; ResetHiddenPrev is r * h_prev."""
    x, h_prev, w = (ctx.input("Input"), ctx.input("HiddenPrev"),
                    ctx.input("Weight"))
    bias = ctx.input("Bias")
    H = h_prev.shape[-1]
    if bias is not None:
        x = x + bias.reshape(1, -1)
    act = _UNIT_ACTS[ctx.attr("activation", "tanh")]
    gate_act = _UNIT_ACTS[ctx.attr("gate_activation", "sigmoid")]
    rz = gate_act(x[:, :2 * H] + h_prev @ w[:, :2 * H])
    u, r = torch.chunk(rz, 2, dim=-1)
    cand = act(x[:, 2 * H:] + (r * h_prev) @ w[:, 2 * H:])
    return {"Hidden": (1 - u) * h_prev + u * cand,
            "Gate": torch.cat([rz, cand], dim=-1),
            "ResetHiddenPrev": r * h_prev}


@register_op("lstm_unit")
def _lstm_unit(ctx):
    """One LSTM step from X [B, 4H] with the unit's gate order {i, f, o,
    g}, `forget_bias` added to f before its sigmoid: C and H."""
    i, f, o, cand = torch.chunk(ctx.input("X"), 4, dim=-1)
    c = (torch.sigmoid(f + ctx.attr("forget_bias", 0.0)) * ctx.input("C_prev")
         + torch.sigmoid(i) * torch.tanh(cand))
    return {"C": c, "H": torch.sigmoid(o) * torch.tanh(c)}


@register_op("lstmp", infer_shape=_infer_lstmp)
def _lstmp(ctx):
    """The LSTM with a recurrent projection: Input [B, T, 4D], Weight
    [P, 4D] from the projection to the gates, ProjWeight [D, P], Bias
    [1, 4D] or [1, 7D] with peepholes; the projection r = act(h @
    ProjWeight) (`proj_activation` tanh, sigmoid or identity) is the
    recurrent state and the Projection output.  Optional H0 [B, P] and
    C0 [B, D]."""
    x, w, w_proj = ctx.input("Input"), ctx.input("Weight"), \
        ctx.input("ProjWeight")
    bias = ctx.input("Bias")
    B, T = x.shape[0], x.shape[1]
    D = x.shape[2] // 4
    lens = _lens_or_full(ctx.lod_len("Input"), B, T, x.device)
    h0, c0 = ctx.input("H0"), ctx.input("C0")
    if h0 is None:
        h0 = _zeros_state(x, B, w_proj.shape[1])
    if c0 is None:
        c0 = _zeros_state(x, B, D)
    act = {"tanh": torch.tanh, "sigmoid": torch.sigmoid}.get(
        ctx.attr("proj_activation", "tanh"), lambda v: v)
    use_peepholes = ctx.attr("use_peepholes", True) and \
        bias.shape[-1] == 7 * D
    proj, cell = lstm_sequence(x, lens, w, bias, h0, c0, use_peepholes,
                               ctx.attr("is_reverse", False),
                               proj=lambda h: act(h @ w_proj))
    return {"Projection": proj, "Cell": cell,
            "Projection@LOD_LEN": lens, "Cell@LOD_LEN": lens}


_RNN_ACTS = {"tanh": torch.tanh, "relu": torch.relu,
             "sigmoid": torch.sigmoid, "identity": lambda v: v,
             "abs": jabs, "square": torch.square, "exp": torch.exp,
             "softsign": lambda v: v / (jabs(v) + 1)}


@register_op("simple_rnn")
def _simple_rnn(ctx):
    """The Elman recurrence h_t = act(x_t + h_{t-1} @ W) over a
    pre-projected Input [B, T, H] (+ Bias).  Unlike the LSTM and GRU
    carries, h is zeroed past each sequence's end inside the carry, as
    the JAX lowering does."""
    x, w, bias = ctx.input("Input"), ctx.input("Weight"), ctx.input("Bias")
    B, T, H = x.shape
    lens = _lens_or_full(ctx.lod_len("Input"), B, T, x.device)
    if bias is not None:
        x = x + bias.reshape(1, 1, H)
    name = ctx.attr("activation", "tanh")
    if name not in _RNN_ACTS:
        raise NotImplementedError("simple_rnn activation %r (supported: %s)"
                                  % (name, sorted(_RNN_ACTS)))
    act = _RNN_ACTS[name]
    reverse = bool(ctx.attr("is_reverse", False))
    h = _zeros_state(x, B, H).to(torch.promote_types(x.dtype, w.dtype))
    hs = []
    for xt, mt in _steps(x, lens, reverse):
        h = torch.where(mt, act(xt + h @ w), 0.0)
        hs.append(h)
    return {"Out": _stack_steps(hs, lens, reverse), "Out@LOD_LEN": lens}


@register_op("attention_lstm", infer_shape=_infer_rows(
    "C0", lambda s: s[-1], "Hidden", "Cell"))
def _attention_lstm(ctx):
    """Each step attends over the whole of its sequence X [B, T, M] with
    the previous cell: score = relu(relu(x @ w_x + c @ w_h + b) * scalar
    + scalar_bias) (AttentionWeight [M + D, 1], the optional scalars
    [1, 1]), padded steps at -1e30 before the softmax and the weights
    times the mask after it; the pooled x and h feed an LSTM step with
    gates = [h; x] @ LSTMWeight [D + M, 4D] + LSTMBias, columns {f, i,
    o, candidate}.  C0 [B, D] is given, H0 optional."""
    x, c0, h0 = ctx.input("X"), ctx.input("C0"), ctx.input("H0")
    att_w, att_b = ctx.input("AttentionWeight"), ctx.input("AttentionBias")
    att_scalar = ctx.input("AttentionScalar")
    att_scalar_b = ctx.input("AttentionScalarBias")
    lstm_w, lstm_b = ctx.input("LSTMWeight"), ctx.input("LSTMBias")
    B, T, M = x.shape
    D = c0.shape[1]
    lens = _lens_or_full(ctx.lod_len("X"), B, T, x.device)
    if h0 is None:
        h0 = _zeros_state(x, B, D)
    cdt = torch.promote_types(x.dtype, lstm_w.dtype)
    h, c = h0.to(cdt), c0.to(cdt)
    valid = seq_mask(lens, T, x.dtype)
    w_x, w_h = att_w[:M], att_w[M:]
    lw_x, lw_h = lstm_w[D:], lstm_w[:D]
    att_x = _mm(x, w_x)[..., 0]
    hs, cs = [], []
    for t in range(T):
        score = att_x + (c @ w_h)[..., 0][:, None]
        if att_b is not None:
            score = score + att_b.reshape(())
        score = torch.relu(score)
        if att_scalar is not None:
            score = score * att_scalar.reshape(())
        if att_scalar_b is not None:
            score = score + att_scalar_b.reshape(())
        score = torch.relu(score)
        score = torch.where(valid > 0, score, torch.full_like(score, -1e30))
        alpha = torch.softmax(score, dim=1) * valid
        lstm_x = _mm(alpha[:, None, :], x)[:, 0]
        gates = h @ lw_h + _mm(lstm_x, lw_x) + lstm_b.reshape(1, -1)
        f, i, o, cand = torch.chunk(gates, 4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(cand)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        mt = (t < lens)[:, None]
        h = torch.where(mt, h_new, h)
        c = torch.where(mt, c_new, c)
        hs.append(torch.where(mt, h, 0.0))
        cs.append(torch.where(mt, c, 0.0))
    return {"Hidden": torch.stack(hs, dim=1), "Cell": torch.stack(cs, dim=1),
            "Hidden@LOD_LEN": lens, "Cell@LOD_LEN": lens}


# ---------------------------------------------------------------------------
# the fused recurrent ops: the x-projection (a product, or a gather from a
# pre-multiplied table) then the same recurrences
# ---------------------------------------------------------------------------

@register_op("fusion_lstm", infer_shape=_infer_rows(
    "WeightH", lambda s: s[0], "Hidden", "Cell"))
def _fusion_lstm(ctx):
    """XX = X [B, T, M] @ WeightX [M, 4D] (+ BiasX, the bias of an fc
    folded in), then the lstm over it with WeightH [D, 4D] and Bias."""
    x, wx, wh, bias = (ctx.input("X"), ctx.input("WeightX"),
                       ctx.input("WeightH"), ctx.input("Bias"))
    B, T = x.shape[0], x.shape[1]
    D = wh.shape[0]
    lens = _lens_or_full(ctx.lod_len("X"), B, T, x.device)
    h0, c0 = _h0_c0(ctx, x, B, D)
    xx = _mm(x, wx)
    bias_x = ctx.input("BiasX")
    if bias_x is not None:
        xx = xx + bias_x.reshape(1, 1, -1)
    use_peepholes = ctx.attr("use_peepholes", True) and \
        bias.shape[-1] == 7 * D
    hidden, cell = lstm_sequence(xx, lens, wh, bias, h0, c0, use_peepholes,
                                 ctx.attr("is_reverse", False))
    return {"Hidden": hidden, "Cell": cell, "XX": xx,
            "Hidden@LOD_LEN": lens, "Cell@LOD_LEN": lens}


@register_op("fusion_gru", infer_shape=_infer_rows(
    "WeightH", lambda s: s[0], "Hidden"))
def _fusion_gru(ctx):
    """XX = X @ WeightX [M, 3D] + Bias, then the gru over it with
    WeightH [D, 3D]."""
    x, wx, wh, bias = (ctx.input("X"), ctx.input("WeightX"),
                       ctx.input("WeightH"), ctx.input("Bias"))
    B, T = x.shape[0], x.shape[1]
    D = wh.shape[0]
    lens = _lens_or_full(ctx.lod_len("X"), B, T, x.device)
    h0 = ctx.input("H0")
    if h0 is None:
        h0 = _zeros_state(x, B, D)
    xx = _mm(x, wx)
    if bias is not None:
        xx = xx + bias.reshape(1, 1, 3 * D)
    hidden = gru_sequence(xx, lens, wh, h0, ctx.attr("is_reverse", False))
    return {"Hidden": hidden, "XX": xx, "Hidden@LOD_LEN": lens}


@register_op("fusion_seqconv_eltadd_relu")
def _fusion_seqconv_eltadd_relu(ctx):
    """sequence_conv, plus Bias [1, M], then a relu (jnp.maximum's: half
    the cotangent at 0); ColMat is the context matrix."""
    x, w, bias = ctx.input("X"), ctx.input("Filter"), ctx.input("Bias")
    B, T = x.shape[0], x.shape[1]
    lens = _lens_or_full(ctx.lod_len("X"), B, T, x.device)
    col, m = context_matrix(x, lens, ctx.attr("contextLength", 3),
                            ctx.attr("contextStart", 0))
    out = jmax(_mm(col, w) + bias.reshape(1, 1, -1), 0.0)
    return {"Out": out * m[..., None], "ColMat": col, "Out@LOD_LEN": lens}


_FC_ACTS = {"relu": lambda v: jmax(v, 0.0), "tanh": torch.tanh,
            "sigmoid": torch.sigmoid}


@register_op("fusion_seqexpand_concat_fc")
def _fusion_seqexpand_concat_fc(ctx):
    """X[0] is the ragged [B, T, D0]; each of X[1:] is one [B, D_i] row a
    sequence, repeated along its time axis; the features side by side
    through the fc FCWeight [sum D_i, M] (+ FCBias) and `fc_activation`,
    zero past each length.  FCOut is Out."""
    xs = ctx.inputs("X")
    w, bias = ctx.input("FCWeight"), ctx.input("FCBias")
    seq = xs[0]
    B, T = seq.shape[0], seq.shape[1]
    lens = _lens_or_full(ctx.lod_lens("X")[0], B, T, seq.device)
    feats = [seq] + [e[:, None, :].expand(B, T, e.shape[-1])
                     for e in xs[1:]]
    dt = feats[0].dtype
    for f in feats[1:]:
        dt = torch.promote_types(dt, f.dtype)
    out = _mm(torch.cat([f.to(dt) for f in feats], dim=-1), w)
    if bias is not None:
        out = out + bias.reshape(1, 1, -1)
    out = _FC_ACTS.get(ctx.attr("fc_activation", "identity"),
                       lambda v: v)(out)
    out = out * seq_mask(lens, T, out.dtype)[..., None]
    return {"Out": out, "FCOut": out, "Out@LOD_LEN": lens}


@register_op("fused_embedding_fc_lstm", infer_shape=_infer_rows(
    "WeightH", lambda s: s[0], "Hidden", "Cell"))
def _fused_embedding_fc_lstm(ctx):
    """The fc of fusion_lstm folded into the table (Embeddings [V, 4D] =
    table @ WeightX + bias): XX is a gather of Ids [B, T, 1], each id
    clipped into [0, V) (not lookup_table's jnp.take semantics), then
    the lstm with WeightH and Bias."""
    ids, emb = ctx.input("Ids"), ctx.input("Embeddings")
    wh, bias = ctx.input("WeightH"), ctx.input("Bias")
    idx = ids.reshape(ids.shape[0], ids.shape[1]).to(torch.int64)
    B, T = idx.shape
    D = wh.shape[0]
    lens = _lens_or_full(ctx.lod_len("Ids"), B, T, ids.device)
    xx = torch.index_select(emb, 0, torch.clamp(idx, 0, emb.shape[0] - 1)
                            .reshape(-1)).reshape(B, T, emb.shape[1])
    h0, c0 = _h0_c0(ctx, xx, B, D)
    use_peepholes = ctx.attr("use_peepholes", True) and \
        bias.shape[-1] == 7 * D
    hidden, cell = lstm_sequence(xx, lens, wh, bias, h0, c0, use_peepholes,
                                 ctx.attr("is_reverse", False))
    return {"Hidden": hidden, "Cell": cell, "XX": xx,
            "Hidden@LOD_LEN": lens, "Cell@LOD_LEN": lens}


# ---------------------------------------------------------------------------
# nested (2-level) LoD
# ---------------------------------------------------------------------------

def _group_slots(counts, device):
    """(group, slot) int64 index vectors over the inner sequences of
    outer groups with `counts` (host ints): inner sequence j of group g
    sits at (g, j)."""
    g = [gi for gi, c in enumerate(counts) for _ in range(c)]
    j = [ji for c in counts for ji in range(c)]
    return (torch.tensor(g, dtype=torch.int64, device=device),
            torch.tensor(j, dtype=torch.int64, device=device))


def _nested_counts(ctx, slot, what):
    seg = ctx.lod_seg(slot)
    if seg is None:
        raise ValueError("%s needs a nested (lod_level-2) input" % what)
    return seg, [int(c) for c in seg.tolist()]


@register_op("nested_to_outer")
def _nested_to_outer(ctx):
    """Re-batch a nested var for iteration over its OUTER level: the
    inner sequences [N, T, ...], grouped by the counts [B_outer], become
    [B_outer, S_max, T, ...] (zero-padded slots) with the inner-length
    matrix [B_outer, S_max]; both carry the counts as their lengths, so
    a DynamicRNN over them steps through the sentences of each group
    (the v2 SubsequenceInput).  The gradient is nested_to_outer_grad."""
    x = ctx.input("X")
    seg, counts = _nested_counts(ctx, "X", "nested_to_outer")
    lens = _lens_or_full(ctx.lod_len("X"), x.shape[0], x.shape[1], x.device)
    B, S = len(counts), max(counts, default=0)
    g, j = _group_slots(counts, x.device)
    out = x.new_zeros((B, S) + tuple(x.shape[1:]))
    out[g, j] = x
    lmat = torch.zeros((B, S), dtype=torch.int32, device=x.device)
    lmat[g, j] = lens.to(torch.int32)
    seg = seg.to(torch.int32)
    return {"Out": out, "Out@LOD_LEN": seg, "OutLens": lmat,
            "OutLens@LOD_LEN": seg}


@register_op("nested_to_outer_grad")
def _nested_to_outer_grad(ctx):
    """The explicit gradient of nested_to_outer: the outer-major
    cotangent [B_outer, S_max, T, ...] back to the inner rows [N, T,
    ...]."""
    x, d_out = ctx.input("X"), ctx.input("GRAD:Out")
    _, counts = _nested_counts(ctx, "X", "nested_to_outer_grad")
    if d_out is None:
        return {"GRAD:X": torch.zeros_like(x)}
    g, j = _group_slots(counts, d_out.device)
    return {"GRAD:X": d_out[g, j].to(x.dtype)}


@register_op("attach_lod")
def _attach_lod(ctx):
    """Out = X with Lens attached as its lengths: a dense per-step slice
    of a recurrent block becomes a ragged var again (the inner-sequence
    view of a SubsequenceInput step)."""
    return {"Out": ctx.input("X"),
            "Out@LOD_LEN": ctx.input("Lens").to(torch.int32)}


@register_op("kmax_seq_score")
def _kmax_seq_score(ctx):
    """The indices of the beam_size highest scores in each sequence's
    real prefix, [B, beam_size] int64, unfilled slots -1 (the reference's
    KmaxSeqScoreLayer).  For a nested input (a score per inner sequence,
    its first element) each outer group's top inner sequences, indices
    local to the group, ranked on the host with numpy's argsort as the
    JAX package ranks them (the reference layer is host-side too)."""
    x = ctx.input("X")
    if x.dim() == 3:
        x = x[..., 0]
    k = int(ctx.attr("beam_size", 1))
    if ctx.lod_seg("X") is not None:
        _, counts = _nested_counts(ctx, "X", "kmax_seq_score")
        scores = x[:, 0].detach().cpu().numpy()
        out = np.full((len(counts), k), -1, np.int64)
        start = 0
        for gi, c in enumerate(counts):
            order = np.argsort(-scores[start:start + c])[:k]
            out[gi, :len(order)] = order
            start += c
        return {"Out": torch.from_numpy(out).to(x.device)}
    B, T = x.shape
    lens = _lens_or_full(ctx.lod_len("X"), B, T, x.device)
    valid = torch.arange(T, device=x.device)[None, :] < lens[:, None]
    masked = torch.where(valid, x, torch.full_like(x, -float("inf")))
    idx = torch.argsort(-masked, dim=1, stable=True)[:, :k]
    slot = torch.arange(idx.shape[1], device=x.device)[None, :]
    idx = torch.where(slot < lens[:, None], idx, torch.full_like(idx, -1))
    if idx.shape[1] < k:
        idx = torch.cat([idx, torch.full((B, k - idx.shape[1]), -1,
                                         dtype=idx.dtype, device=x.device)],
                        dim=1)
    return {"Out": idx.to(torch.int64)}


@register_op("sub_nested_seq")
def _sub_nested_seq(ctx):
    """Select inner sequences of a nested X per outer group by LOCAL
    indices [B_outer, K] (-1 skipped; the reference's
    SubNestedSequenceLayer after kmax_seq_score): the selected rows,
    their lengths, and per group the count selected as Out@LOD_SEG.  The
    indices and counts are read on the host; the rows are gathered on
    X's device."""
    x = ctx.input("X")
    _, counts = _nested_counts(ctx, "X", "sub_nested_seq")
    idx = ctx.input("Indices").detach().cpu().numpy().astype(np.int64)
    lens = _lens_or_full(ctx.lod_len("X"), x.shape[0], x.shape[1], x.device)
    if len(idx) != len(counts):
        raise ValueError("sub_nested_seq: Indices rows (%d) != outer "
                         "groups (%d)" % (len(idx), len(counts)))
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    rows, out_counts = [], []
    for gi in range(len(idx)):
        picked = [int(i) for i in idx[gi] if i >= 0]
        bad = [i for i in picked if i >= counts[gi]]
        if bad:
            raise ValueError(
                "sub_nested_seq: index %d out of range for outer group %d "
                "with %d inner sequences" % (bad[0], gi, counts[gi]))
        rows += [int(starts[gi]) + i for i in picked]
        out_counts.append(len(picked))
    rows = torch.tensor(rows, dtype=torch.int64, device=x.device)
    return {"Out": torch.index_select(x, 0, rows),
            "Out@LOD_LEN": torch.index_select(lens, 0, rows).to(
                torch.int32),
            "Out@LOD_SEG": torch.tensor(out_counts, dtype=torch.int32,
                                        device=x.device)}
