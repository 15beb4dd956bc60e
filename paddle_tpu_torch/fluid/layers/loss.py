"""Beam-search layers, after paddle_tpu/fluid/layers/loss.py:
`beam_search` (one expansion step, ops/beam_ops.py) and
`beam_search_decode` (the backtrack into hypotheses).  The rest of that
module waits (ROADMAP.md, queue 1 item 13)."""

from .. import core
from ..layer_helper import LayerHelper

__all__ = ["beam_search", "beam_search_decode"]


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, name=None, return_parent_idx=False):
    """One beam-search expansion step in the dense encoding (every source
    keeps exactly beam_size rows); with return_parent_idx also the
    selected beams' parent rows, which decoding needs."""
    helper = LayerHelper("beam_search", name=name)
    sel_ids = helper.create_variable_for_type_inference(
        core.VarDesc.VarType.INT64, stop_gradient=True)
    sel_scores = helper.create_variable_for_type_inference(
        "float32", stop_gradient=True)
    parent_idx = helper.create_variable_for_type_inference(
        core.VarDesc.VarType.INT32, stop_gradient=True)
    inputs = {"pre_ids": pre_ids, "pre_scores": pre_scores, "scores": scores}
    if ids is not None:
        inputs["ids"] = ids
    helper.append_op(
        type="beam_search", inputs=inputs,
        outputs={"selected_ids": sel_ids, "selected_scores": sel_scores,
                 "parent_idx": parent_idx},
        attrs={"beam_size": beam_size, "end_id": end_id, "level": level,
               "is_accumulated": True})
    if return_parent_idx:
        return sel_ids, sel_scores, parent_idx
    return sel_ids, sel_scores


def beam_search_decode(ids, scores, beam_size, end_id, parent_idx=None,
                       name=None):
    """(sentence_ids, sentence_scores) from the stacked [T, B*W] ids,
    scores and parent pointers (or tensor arrays of them)."""
    helper = LayerHelper("beam_search_decode", name=name)
    sent_ids = helper.create_variable_for_type_inference(
        core.VarDesc.VarType.INT64, stop_gradient=True)
    sent_scores = helper.create_variable_for_type_inference(
        "float32", stop_gradient=True)
    sent_ids.lod_level = 1
    inputs = {"Ids": ids, "Scores": scores}
    if parent_idx is not None:
        inputs["ParentIdx"] = parent_idx
    helper.append_op(
        type="beam_search_decode", inputs=inputs,
        outputs={"SentenceIds": sent_ids, "SentenceScores": sent_scores},
        attrs={"beam_size": beam_size, "end_id": end_id})
    return sent_ids, sent_scores
