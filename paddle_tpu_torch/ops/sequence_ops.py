"""Sequence (LoD) op lowerings, after paddle_tpu/ops/sequence_ops.py:
sequence_pool and the dynamic LSTM (`lstm`).

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
