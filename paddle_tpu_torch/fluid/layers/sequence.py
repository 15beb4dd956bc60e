"""Sequence layer functions, after paddle_tpu/fluid/layers/sequence.py:
dynamic_lstm, sequence_conv, sequence_pool, sequence_first_step,
sequence_last_step, sequence_softmax, sequence_expand and sequence_pad,
with the JAX
package's parameter names, shapes and initializers, so a startup scope
carries across by name."""

from .. import core
from ..layer_helper import LayerHelper

__all__ = ["dynamic_lstm", "sequence_conv", "sequence_pool", "sequence_first_step",
           "sequence_last_step", "sequence_softmax", "sequence_expand",
           "sequence_pad"]


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


def _seq_single(op_type, input, lod_out=False):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(input.dtype)
    if lod_out:
        out.lod_level = max(input.lod_level, 1)
    helper.append_op(type=op_type, inputs={"X": input},
                     outputs={"Out": out})
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
