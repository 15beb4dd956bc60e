"""Sequence op lowerings of paddle_tpu/ops/misc_ops.py: sequence_scatter,
sequence_expand_as and row_conv (the module's other ops are not ported
yet: ROADMAP.md, queue 1 item 15)."""

import torch

from .math_ops import seq_mask
from .registry import register_op
from .tensor_ops import _wrapped


@register_op("sequence_scatter")
def _sequence_scatter(ctx):
    """X [B, D] with Updates added at (b, Ids[b, t]) for each valid t of
    the ragged Ids (`.at[].add`: a negative id wraps once, then an id
    out of range is dropped, written to a spare column that is cut
    off)."""
    x, ids, upd = ctx.input("X"), ctx.input("Ids"), ctx.input("Updates")
    if ids.dim() == 3:
        ids = ids[..., 0]
    if upd.dim() == 3:
        upd = upd[..., 0]
    B, T = ids.shape
    D = x.shape[1]
    lens = ctx.lod_len("Ids")
    if lens is not None:
        upd = torch.where(seq_mask(lens, T, torch.int32) > 0, upd,
                          torch.zeros_like(upd))
    cols = _wrapped(ids.to(torch.int64), D)
    cols = torch.where((cols >= 0) & (cols < D), cols,
                       torch.full_like(cols, D))
    rows = torch.arange(B, device=x.device)[:, None].expand(B, T)
    spare = torch.cat([x, x.new_zeros((B, 1))], dim=1)
    out = spare.index_put((rows.reshape(-1), cols.reshape(-1)),
                          upd.reshape(-1).to(x.dtype), accumulate=True)
    return {"Out": out[:, :D]}


@register_op("sequence_expand_as")
def _sequence_expand_as(ctx):
    """X [B, D...], one row a sequence, repeated along ragged Y's time
    axis ([B, T, D...], zero past Y's lengths, carrying them)."""
    x, y = ctx.input("X"), ctx.input("Y")
    T = y.shape[1] if y.dim() > 1 else y.shape[0]
    B = x.shape[0]
    ylens = ctx.lod_len("Y")
    if ylens is None:
        ylens = torch.full((B,), T, dtype=torch.int32, device=x.device)
    out = x[:, None].expand((B, T) + tuple(x.shape[1:]))
    m = seq_mask(ylens, T, x.dtype).reshape((B, T) + (1,) * (x.dim() - 1))
    return {"Out": out * m, "Out@LOD_LEN": ylens}


@register_op("row_conv")
def _row_conv(ctx):
    """The lookahead row convolution of a ragged X [B, T, D] with Filter
    [k, D]: out[t] = sum_j Filter[j] * x[t + j], x zero past each
    length."""
    x, w = ctx.input("X"), ctx.input("Filter")
    lens = ctx.lod_len("X")
    T = x.shape[1]
    k = w.shape[0]
    if lens is not None:
        x = x * seq_mask(lens, T, x.dtype)[:, :, None]
    padded = torch.nn.functional.pad(x, (0, 0, 0, k))
    out = torch.zeros_like(x)
    for j in range(k):
        out = out + padded[:, j:j + T, :] * w[j][None, None, :]
    return {"Out": out}
