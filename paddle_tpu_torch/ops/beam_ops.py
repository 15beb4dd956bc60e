"""Beam-search op lowerings, after paddle_tpu/ops/beam_ops.py: one
expansion step (`beam_search`) and the backtrack of the stacked per-step
selections into hypotheses (`beam_search_decode`).

The dense encoding of the JAX package: every source keeps exactly
`beam_size` rows at all times.  A finished beam (its pre_id is end_id)
offers one candidate, the end token at its frozen score, so it survives
selection unchanged while an unfinished beam offers its K candidates;
the caller deactivates the duplicate start beams at step 0 with -1e9
scores (layers.beam_slot_mask).  The selection's order is
`jax.lax.top_k`'s — descending in IEEE totalOrder, the lower index first
among equal scores — through the `_order_key` of ops/math_ops.py.  The
backtrack is a loop over the T steps of gathers, no host read.
"""

import torch

from .math_ops import _order_key
from .registry import register_op

_NEG_INF = -1e9


def _topk(x, k):
    """(values, indices) of the k largest along the last axis, in
    jax.lax.top_k's order."""
    idx = torch.sort(_order_key(x), dim=-1, descending=True,
                     stable=True).indices[..., :k]
    return x.gather(-1, idx), idx


@register_op("beam_search")
def _beam_search(ctx):
    """pre_ids / pre_scores [B*W, 1]; scores [B*W, K] log-probs
    (accumulated unless is_accumulated is False, then probabilities);
    ids [B*W, K] (0 ... K-1 when absent).  Outputs selected_ids and
    selected_scores [B*W, 1] and parent_idx [B*W], the global row of each
    selected beam's parent."""
    pre_ids, pre_scores = ctx.input("pre_ids"), ctx.input("pre_scores")
    scores, ids = ctx.input("scores"), ctx.input("ids")
    W, end_id = int(ctx.attr("beam_size")), int(ctx.attr("end_id"))
    rows, K = scores.shape
    B = rows // W
    dev = scores.device
    if ids is None:
        ids = torch.arange(K, dtype=torch.int32, device=dev)[None, :] \
            .expand(rows, K)
    ids = ids.to(torch.int32)
    pre_ids_f = pre_ids.reshape(-1).to(torch.int32)
    pre_scores_f = pre_scores.reshape(-1).float()
    scores = scores.float()
    if not ctx.attr("is_accumulated", True):
        scores = torch.log(torch.clamp_min(scores, 1e-20)) \
            + pre_scores_f[:, None]
    finished = pre_ids_f == end_id
    neg = torch.full_like(scores, _NEG_INF)
    cand = torch.where(finished[:, None], neg, scores)
    frozen = torch.where(finished, pre_scores_f,
                         torch.full_like(pre_scores_f, _NEG_INF))[:, None]
    all_scores = torch.cat([cand, frozen], dim=1)            # [BW, K+1]
    all_ids = torch.cat([ids, torch.full((rows, 1), end_id,
                                         dtype=torch.int32, device=dev)],
                        dim=1)
    top_scores, top_idx = _topk(all_scores.reshape(B, W * (K + 1)), W)
    parent_beam = torch.div(top_idx, K + 1, rounding_mode="floor")
    parent_row = torch.arange(B, device=dev)[:, None] * W + parent_beam
    sel_ids = torch.gather(all_ids.reshape(B, W * (K + 1)), 1, top_idx)
    return {"selected_ids": sel_ids.reshape(-1, 1).to(torch.int64),
            "selected_scores": top_scores.reshape(-1, 1),
            "parent_idx": parent_row.reshape(-1).to(torch.int32)}


def _stack_array(entries):
    """A tensor array (a list, written by a custom decoder block) as [T,
    BW]: an entry of fewer rows (the [B, ...] init beside [B*W, ...]
    selections) repeats each row across its beam slots."""
    rows = [e.reshape(-1) for e in entries if e is not None]
    bw = max(r.shape[0] for r in rows)
    out = []
    for r in rows:
        if r.shape[0] != bw:
            if bw % r.shape[0]:
                raise ValueError(
                    "beam_search_decode: array entry rows %d do not tile "
                    "into beam width %d" % (r.shape[0], bw))
            r = torch.repeat_interleave(r, bw // r.shape[0])
        out.append(r)
    return torch.stack(out, dim=0)


@register_op("beam_search_decode")
def _beam_search_decode(ctx):
    """Ids and ParentIdx stacked [T, B*W] (ParentIdx absent: each row its
    own chain), Scores [T, B*W]: SentenceIds [B*W, T] backtracked from the
    last step, ragged with lengths up to and including the first end_id
    (else T), and SentenceScores [B*W, 1], the last step's scores."""
    ids, scores = ctx.input("Ids"), ctx.input("Scores")
    if isinstance(ids, list):
        ids = _stack_array(ids)
    if isinstance(scores, list):
        scores = _stack_array(scores)
    ids = ids.to(torch.int64)
    end_id = int(ctx.attr("end_id"))
    T, BW = ids.shape
    parents = ctx.input("ParentIdx")
    cur = torch.arange(BW, device=ids.device)
    toks = []
    for t in range(T - 1, -1, -1):
        toks.append(ids[t].gather(0, cur))
        if parents is not None:
            cur = parents[t].to(torch.int64).gather(0, cur)
    seq = torch.stack(toks[::-1], dim=1)                      # [BW, T]
    is_end = seq == end_id
    first_end = torch.argmax(is_end.to(torch.int32), dim=1)
    lens = torch.where(is_end.any(dim=1), first_end + 1,
                       torch.full_like(first_end, T)).to(torch.int32)
    return {"SentenceIds": seq,
            "SentenceIds@LOD_LEN": lens,
            "SentenceScores": scores[-1].reshape(-1, 1)}
