"""The LoD rank table and the IfElse split/merge, after the part of
paddle_tpu/ops/compat_ops.py they come from: `lod_rank_table`,
`reorder_lod_tensor_by_rank`, `split_lod_tensor` and `merge_lod_tensor`.
The rest of that module waits (ROADMAP.md, queue 1 item 15).

In the padded encoding the rank table is the permutation [B] that
orders the sequences by length, longest first (stable); IfElse's split
keeps every row in both outputs, zeroing the rows of the other branch,
and the merge picks each row from its branch (predication, no dynamic
shapes), so a row-wise branch computes what the row split would.
"""

import torch

from .registry import register_op


@register_op("lod_rank_table")
def _lod_rank_table(ctx):
    x = ctx.input("X")
    B = x.shape[0]
    lens = ctx.lod_len("X")
    if lens is None:
        lens = torch.full((B,), x.shape[1] if x.dim() > 1 else 1,
                          dtype=torch.int32, device=x.device)
    # stable descending by length: ascending in (-len, index)
    idx = torch.arange(B, device=x.device)
    key = -lens.to(torch.int64) * B - (B - 1 - idx)
    return {"Out": torch.argsort(key).to(torch.int32)}


@register_op("reorder_lod_tensor_by_rank")
def _reorder_lod_tensor_by_rank(ctx):
    x = ctx.input("X")
    table = ctx.input("RankTable").to(torch.int64)
    res = {"Out": torch.index_select(x, 0, table)}
    lens = ctx.lod_len("X")
    if lens is not None:
        res["Out@LOD_LEN"] = torch.index_select(lens, 0, table)
    return res


def _row_mask(mask, x):
    m = mask.reshape(-1).to(torch.bool)
    return m.reshape((-1,) + (1,) * (x.dim() - 1))


@register_op("split_lod_tensor")
def _split_lod_tensor(ctx):
    x = ctx.input("X")
    m = _row_mask(ctx.input("Mask"), x)
    zero = torch.zeros_like(x)
    return {"OutTrue": torch.where(m, x, zero),
            "OutFalse": torch.where(m, zero, x)}


@register_op("merge_lod_tensor")
def _merge_lod_tensor(ctx):
    t, f = ctx.input("InTrue"), ctx.input("InFalse")
    return {"Out": torch.where(_row_mask(ctx.input("Mask"), t), t, f)}
