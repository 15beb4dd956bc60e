"""NN layer functions building ops into the current program, after
paddle_tpu/fluid/layers/nn.py: the same signatures, parameter names, op
types and attrs for the layers the transformer calls."""

import numpy as np

from ..initializer import Constant
from ..layer_helper import LayerHelper

__all__ = [
    "fc", "embedding", "layer_norm", "dropout", "softmax_with_cross_entropy",
    "elementwise_add", "mean", "scale", "reshape", "slice", "cumsum",
    "remat_checkpoint", "flash_attention",
]


def _single_op_layer(helper, op_type, x, attrs=None):
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type=op_type, inputs={"X": x}, outputs={"Out": out},
                     attrs=attrs or {})
    return out


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Fully-connected layer: each input times its own weight, summed,
    plus bias, then the activation."""
    helper = LayerHelper("fc", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = helper.input_dtype()
    mul_results = []
    for input_var, p_attr in helper.iter_inputs_and_params():
        param_shape = [
            int(np.prod(input_var.shape[num_flatten_dims:]))] + [size]
        w = helper.create_parameter(attr=p_attr, shape=param_shape,
                                    dtype=dtype, is_bias=False)
        tmp = helper.create_variable_for_type_inference(dtype)
        helper.append_op(
            type="mul", inputs={"X": input_var, "Y": w},
            outputs={"Out": tmp},
            attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1})
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(dtype)
        helper.append_op(type="sum", inputs={"X": mul_results},
                         outputs={"Out": pre_bias})
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """lookup_table op; the table's gradient is dense (the sparse,
    SelectedRows gradient is not ported)."""
    if is_sparse or is_distributed:
        raise NotImplementedError(
            "embedding(is_sparse/is_distributed): sparse table gradients "
            "are not ported to paddle_tpu_torch yet")
    helper = LayerHelper("embedding", param_attr=param_attr)
    w = helper.create_parameter(attr=helper.param_attr, shape=size,
                                dtype=dtype, is_bias=False)
    tmp = helper.create_variable_for_type_inference(dtype)
    padding_idx = -1 if padding_idx is None else (
        padding_idx if padding_idx >= 0 else size[0] + padding_idx)
    helper.append_op(
        type="lookup_table", inputs={"Ids": input, "W": w},
        outputs={"Out": tmp},
        attrs={"is_sparse": is_sparse, "is_distributed": is_distributed,
               "padding_idx": padding_idx})
    return tmp


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    param_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": input}
    if scale:
        inputs["Scale"] = helper.create_parameter(
            attr=helper.param_attr, shape=param_shape, dtype=dtype,
            default_initializer=Constant(1.0))
    if shift:
        inputs["Bias"] = helper.create_parameter(
            attr=helper.bias_attr, shape=param_shape, dtype=dtype,
            is_bias=True)
    out = helper.create_variable_for_type_inference(dtype)
    mean = helper.create_variable_for_type_inference(dtype,
                                                     stop_gradient=True)
    var = helper.create_variable_for_type_inference(dtype,
                                                    stop_gradient=True)
    helper.append_op(
        type="layer_norm", inputs=inputs,
        outputs={"Y": out, "Mean": mean, "Variance": var},
        attrs={"begin_norm_axis": begin_norm_axis, "epsilon": epsilon})
    return helper.append_activation(out)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference(x.dtype,
                                                     stop_gradient=True)
    helper.append_op(
        type="dropout", inputs={"X": x},
        outputs={"Out": out, "Mask": mask},
        attrs={"dropout_prob": dropout_prob, "is_test": is_test,
               "seed": seed if seed is not None else 0,
               "dropout_implementation": dropout_implementation})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, return_softmax=False):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax_out = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op(type="softmax_with_cross_entropy",
                     inputs={"Logits": logits, "Label": label},
                     outputs={"Softmax": softmax_out, "Loss": loss},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index})
    if return_softmax:
        return loss, softmax_out
    return loss


def elementwise_add(x, y, axis=-1, act=None, name=None):
    helper = LayerHelper("elementwise_add", act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="elementwise_add", inputs={"X": x, "Y": y},
                     outputs={"Out": out}, attrs={"axis": axis})
    return helper.append_activation(out)


def mean(x, name=None):
    return _single_op_layer(LayerHelper("mean", name=name), "mean", x)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper("scale", act=act, name=name)
    out = _single_op_layer(helper, "scale", x,
                           {"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out)


def reshape(x, shape, act=None, name=None):
    helper = LayerHelper("reshape2", act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op(type="reshape2", inputs={"X": x},
                     outputs={"Out": out, "XShape": xshape},
                     attrs={"shape": list(shape)})
    return helper.append_activation(out)


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="slice", inputs={"Input": input},
                     outputs={"Out": out},
                     attrs={"axes": axes, "starts": starts, "ends": ends})
    return out


def cumsum(x, axis=None, exclusive=None, reverse=None):
    helper = LayerHelper("cumsum")
    attrs = {}
    if axis is not None:
        attrs["axis"] = axis
    if exclusive is not None:
        attrs["exclusive"] = exclusive
    if reverse is not None:
        attrs["reverse"] = reverse
    return _single_op_layer(helper, "cumsum", x, attrs)


def remat_checkpoint(x, tag="block_out", name=None):
    """Identity carrying a rematerialisation tag.  Recomputation is a
    memory policy of the JAX package's whole-graph AD, not semantics: the
    port's eager Executor runs `remat_tag` as the identity."""
    helper = LayerHelper("remat_tag", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="remat_tag", inputs={"X": x},
                     outputs={"Out": out}, attrs={"tag": tag})
    return out


def flash_attention(q, k, v, num_heads=1, causal=False, name=None):
    """Fused attention layer — q/k/v [B, S, D] (num_heads splits D) or
    [B, S, H, Dh]; on the card it runs the K1/K2 CUDA kernels
    (ops/pallas_kernels.py)."""
    helper = LayerHelper("flash_attention", name=name)
    if len(q.shape) == 3 and q.shape[-1] is not None and \
            q.shape[-1] > 0 and q.shape[-1] % num_heads:
        raise ValueError(
            "flash_attention: hidden size %d not divisible by num_heads %d"
            % (q.shape[-1], num_heads))
    out = helper.create_variable_for_type_inference(q.dtype)
    helper.append_op(type="flash_attention",
                     inputs={"Q": q, "K": k, "V": v},
                     outputs={"Out": out},
                     attrs={"num_heads": int(num_heads),
                            "causal": bool(causal)})
    return out
