"""Sequence layer functions, after paddle_tpu/fluid/layers/sequence.py:
the recurrent layers (dynamic_lstm, dynamic_lstmp, dynamic_gru,
gru_unit), sequence_conv and the flat sequence layers (pool, first and
last step, softmax, expand, expand_as, pad, unpad, reverse, mask,
enumerate, reshape, slice, concat, scatter), with the JAX package's
parameter names, shapes and initializers, so a startup scope carries
across by name."""

from .. import core
from ..layer_helper import LayerHelper

__all__ = [
    "dynamic_lstm", "dynamic_lstmp", "dynamic_gru", "gru_unit",
    "sequence_conv", "sequence_pool", "sequence_softmax", "sequence_expand",
    "sequence_first_step", "sequence_last_step", "sequence_reverse",
    "sequence_pad", "sequence_unpad", "sequence_mask", "sequence_enumerate",
    "sequence_reshape", "sequence_slice", "sequence_concat",
    "sequence_scatter", "sequence_expand_as",
]


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None):
    """The `lstm` op over `input`, the pre-projected [*, 4H] sequence (an
    fc comes first, as in the reference); returns the ragged (hidden,
    cell)."""
    helper = LayerHelper("lstm", param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    if size % 4:
        raise ValueError("dynamic_lstm: size %d is not 4 * hidden" % size)
    H = size // 4
    weight = helper.create_parameter(attr=helper.param_attr,
                                     shape=[H, 4 * H], dtype=dtype)
    bias_size = [1, 7 * H if use_peepholes else 4 * H]
    bias = helper.create_parameter(attr=helper.bias_attr, shape=bias_size,
                                   dtype=dtype, is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    hidden.lod_level = max(input.lod_level, 1)
    cell.lod_level = max(input.lod_level, 1)
    batch_gate = helper.create_variable_for_type_inference(dtype, True)
    batch_cell_pre_act = helper.create_variable_for_type_inference(
        dtype, True)
    inputs = {"Input": input, "Weight": weight, "Bias": bias}
    if h_0 is not None:
        inputs["H0"] = h_0
    if c_0 is not None:
        inputs["C0"] = c_0
    helper.append_op(
        type="lstm", inputs=inputs,
        outputs={"Hidden": hidden, "Cell": cell, "BatchGate": batch_gate,
                 "BatchCellPreAct": batch_cell_pre_act},
        attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation})
    return hidden, cell


def dynamic_lstmp(input, size, proj_size, h_0=None, c_0=None,
                  param_attr=None, bias_attr=None, use_peepholes=True,
                  is_reverse=False, gate_activation="sigmoid",
                  cell_activation="tanh", candidate_activation="tanh",
                  proj_activation="tanh", dtype="float32", name=None):
    """The `lstmp` op: the LSTM with a recurrent projection over `input`,
    the pre-projected [*, size] sequence (hidden D = size / 4,
    projection P = proj_size).  Returns the ragged (projection, cell)."""
    helper = LayerHelper("lstmp", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    if size % 4:
        raise ValueError("dynamic_lstmp: size %d is not 4 * hidden" % size)
    D, P = size // 4, int(proj_size)
    weight = helper.create_parameter(attr=helper.param_attr,
                                     shape=[P, 4 * D], dtype=dtype)
    proj_weight = helper.create_parameter(attr=helper.param_attr,
                                          shape=[D, P], dtype=dtype)
    bias = helper.create_parameter(
        attr=helper.bias_attr, shape=[1, 7 * D if use_peepholes else 4 * D],
        dtype=dtype, is_bias=True)
    proj = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    proj.lod_level = max(input.lod_level, 1)
    cell.lod_level = max(input.lod_level, 1)
    inputs = {"Input": input, "Weight": weight, "ProjWeight": proj_weight,
              "Bias": bias}
    if h_0 is not None:
        inputs["H0"] = h_0
    if c_0 is not None:
        inputs["C0"] = c_0
    helper.append_op(
        type="lstmp", inputs=inputs,
        outputs={"Projection": proj, "Cell": cell},
        attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation,
               "proj_activation": proj_activation})
    return proj, cell


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, name=None):
    """The `gru` op over `input`, the pre-projected [*, 3 * size]
    sequence; returns the ragged hidden [*, size].  The activation attrs
    are recorded; the lowering is sigmoid and tanh whatever they say, as
    the JAX package's."""
    helper = LayerHelper("gru", param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    dtype = input.dtype
    weight = helper.create_parameter(attr=helper.param_attr,
                                     shape=[size, 3 * size], dtype=dtype)
    bias = helper.create_parameter(attr=helper.bias_attr,
                                   shape=[1, 3 * size], dtype=dtype,
                                   is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    hidden.lod_level = max(input.lod_level, 1)
    batch_gate = helper.create_variable_for_type_inference(dtype, True)
    batch_reset = helper.create_variable_for_type_inference(dtype, True)
    batch_hidden = helper.create_variable_for_type_inference(dtype, True)
    inputs = {"Input": input, "Weight": weight, "Bias": bias}
    if h_0 is not None:
        inputs["H0"] = h_0
    helper.append_op(
        type="gru", inputs=inputs,
        outputs={"Hidden": hidden, "BatchGate": batch_gate,
                 "BatchResetHiddenPrev": batch_reset,
                 "BatchHidden": batch_hidden},
        attrs={"is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "activation": candidate_activation})
    return hidden


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid"):
    """One GRU step of `input` [B, size] from `hidden` [B, size / 3]:
    returns (hidden, reset hidden prev, gate)."""
    helper = LayerHelper("gru_unit", param_attr=param_attr,
                         bias_attr=bias_attr)
    dtype = input.dtype
    H = size // 3
    weight = helper.create_parameter(attr=helper.param_attr,
                                     shape=[H, 3 * H], dtype=dtype)
    bias = helper.create_parameter(attr=helper.bias_attr, shape=[1, 3 * H],
                                   dtype=dtype, is_bias=True)
    out = helper.create_variable_for_type_inference(dtype)
    gate = helper.create_variable_for_type_inference(dtype, True)
    reset = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op(
        type="gru_unit",
        inputs={"Input": input, "HiddenPrev": hidden, "Weight": weight,
                "Bias": bias},
        outputs={"Hidden": out, "Gate": gate, "ResetHiddenPrev": reset},
        attrs={"activation": activation,
               "gate_activation": gate_activation})
    return out, reset, gate


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None,
                  name=None):
    """The context-window projection over a ragged input: a
    [filter_size * D, num_filters] filter over windows centred on each
    position (contextStart -filter_size // 2), then the bias over the
    last axis and `act`.  `padding` is taken for the signature, as the
    JAX layer takes it."""
    helper = LayerHelper("sequence_conv", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    filter_param = helper.create_parameter(
        attr=helper.param_attr, shape=[filter_size * input.shape[-1],
                                       num_filters], dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    out.lod_level = max(input.lod_level, 1)
    helper.append_op(
        type="sequence_conv",
        inputs={"X": [input], "Filter": [filter_param]},
        outputs={"Out": [out]},
        attrs={"contextStride": filter_stride,
               "contextStart": -int(filter_size // 2),
               "contextLength": filter_size})
    pre_act = helper.append_bias_op(out, dim_start=2)
    return helper.append_activation(pre_act)


def sequence_pool(input, pool_type, is_test=False):
    """One row per sequence: average, sum, sqrt, max, last or first."""
    helper = LayerHelper("sequence_pool")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="sequence_pool", inputs={"X": input},
                     outputs={"Out": out},
                     attrs={"pooltype": pool_type.upper()})
    return out


def _seq_single(op_type, input, lod_out=False, out_slot="Out"):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(input.dtype)
    if lod_out:
        out.lod_level = max(input.lod_level, 1)
    helper.append_op(type=op_type, inputs={"X": input},
                     outputs={out_slot: out})
    return out


def sequence_first_step(input):
    return _seq_single("sequence_first_step", input)


def sequence_last_step(input):
    return _seq_single("sequence_last_step", input)


def sequence_softmax(input, use_cudnn=False, name=None):
    return _seq_single("sequence_softmax", input, lod_out=True)


def sequence_expand(x, y, ref_level=-1, name=None):
    helper = LayerHelper("sequence_expand", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.lod_level = max(y.lod_level, 1)
    helper.append_op(type="sequence_expand", inputs={"X": x, "Y": y},
                     outputs={"Out": out}, attrs={"ref_level": ref_level})
    return out


def sequence_pad(x, pad_value, maxlen=None, name=None):
    helper = LayerHelper("sequence_pad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    length = helper.create_variable_for_type_inference(
        core.VarDesc.VarType.INT64, stop_gradient=True)
    helper.append_op(type="sequence_pad",
                     inputs={"X": x, "PadValue": pad_value},
                     outputs={"Out": out, "Length": length},
                     attrs={"padded_length": maxlen if maxlen else -1})
    return out, length


def sequence_reverse(x, name=None):
    return _seq_single("sequence_reverse", x, lod_out=True, out_slot="Y")


def sequence_unpad(x, length, name=None):
    """The padded `x` as a ragged var of lengths `length`."""
    helper = LayerHelper("sequence_unpad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.lod_level = 1
    helper.append_op(type="sequence_unpad",
                     inputs={"X": x, "Length": length},
                     outputs={"Out": out})
    return out


def _sequence_length(input):
    """Each sequence's length [B], int64 (the @LOD_LEN companion as a
    tensor; internal, as in the JAX package)."""
    helper = LayerHelper("sequence_length")
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="sequence_length", inputs={"X": input},
                     outputs={"Out": out})
    return out


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """The mask [..., maxlen] of the lengths `x`.  With maxlen None the
    width is max(x), read on the host at run time."""
    helper = LayerHelper("sequence_mask", name=name)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="sequence_mask", inputs={"X": x},
                     outputs={"Y": out},
                     attrs={"maxlen": maxlen if maxlen else -1,
                            "out_dtype": out.dtype})
    return out


def sequence_enumerate(input, win_size, pad_value=0, name=None):
    helper = LayerHelper("sequence_enumerate", name=name)
    out = helper.create_variable_for_type_inference(input.dtype, True)
    out.lod_level = 1
    helper.append_op(type="sequence_enumerate", inputs={"X": input},
                     outputs={"Out": out},
                     attrs={"win_size": win_size, "pad_value": pad_value})
    return out


def sequence_reshape(input, new_dim):
    helper = LayerHelper("sequence_reshape")
    out = helper.create_variable_for_type_inference(input.dtype)
    out.lod_level = 1
    helper.append_op(type="sequence_reshape", inputs={"X": input},
                     outputs={"Out": out}, attrs={"new_dim": new_dim})
    return out


def sequence_slice(input, offset, length, name=None):
    helper = LayerHelper("sequence_slice", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    out.lod_level = 1
    helper.append_op(type="sequence_slice",
                     inputs={"X": input, "Offset": offset,
                             "Length": length},
                     outputs={"Out": out})
    return out


def sequence_concat(input, name=None):
    helper = LayerHelper("sequence_concat", name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    out.lod_level = 1
    helper.append_op(type="sequence_concat", inputs={"X": input},
                     outputs={"Out": out})
    return out


def sequence_scatter(input, index, updates, name=None):
    """`input` [B, D] with each sequence's `updates` added at its
    `index` positions."""
    helper = LayerHelper("sequence_scatter", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="sequence_scatter",
                     inputs={"X": input, "Ids": index, "Updates": updates},
                     outputs={"Out": out})
    return out


def sequence_expand_as(x, y, name=None):
    """Row i of `x` repeated along the i-th sequence of `y`."""
    helper = LayerHelper("sequence_expand_as", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="sequence_expand_as", inputs={"X": x, "Y": y},
                     outputs={"Out": out})
    return out
