"""NN layer functions building ops into the current program, after
paddle_tpu/fluid/layers/nn.py: the same signatures, parameter names, op
types and attrs, for the layers whose ops the port registers."""

import numpy as np

from .. import core, unique_name
from ..initializer import Constant, NormalInitializer
from ..layer_helper import LayerHelper

__all__ = [
    "fc", "embedding", "conv2d", "pool2d", "batch_norm", "layer_norm",
    "dropout", "softmax", "relu", "cross_entropy", "square_error_cost",
    "softmax_with_cross_entropy", "accuracy", "topk", "elementwise_add",
    "elementwise_mul", "elementwise_sub", "elementwise_min", "elementwise_div",
    "elementwise_max", "elementwise_pow", "pow", "clip", "clip_by_norm",
    "where", "mean",
    "scale", "reshape", "slice", "cumsum", "remat_checkpoint",
    "flash_attention", "mul", "matmul", "concat", "stack", "gather",
    "expand", "unsqueeze", "squeeze", "reduce_sum", "beam_slot_mask",
    "conv2d_transpose", "group_norm", "sigmoid_cross_entropy_with_logits",
    "one_hot", "reduce_mean", "reduce_max", "reduce_min", "reduce_prod",
    "sign", "leaky_relu", "soft_relu", "brelu", "elu", "relu6",
    "hard_sigmoid", "swish", "stanh", "l2_normalize", "transpose",
    "flatten", "split", "unstack", "gather_nd", "scatter", "pad", "pad2d",
    "argmax", "argmin", "argsort", "shape", "smooth_l1", "huber_loss",
    "log_loss", "hinge_loss", "margin_rank_loss", "image_resize",
    "resize_bilinear", "resize_nearest", "uniform_random",
    "gaussian_random", "uniform_random_batch_size_like",
    "gaussian_random_batch_size_like", "logical_and", "logical_or",
    "logical_xor", "lrn", "row_conv", "lod_reset", "lstm_unit",
]


def _single_op_layer(helper, op_type, x, attrs=None, out_dtype=None):
    out = helper.create_variable_for_type_inference(
        dtype=x.dtype if out_dtype is None else out_dtype)
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
    out = helper.append_activation(pre_act)
    # ShareLoD: a row-wise fc keeps the ragged structure
    first_in = helper.multiple_input()[0]
    if first_in.lod_level > 0:
        out.lod_level = first_in.lod_level
    return out


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """lookup_table op.  With is_sparse the table's gradient is a
    SelectedRows value (ops/nn_ops.py lookup_table_sparse_grad) where the
    table has no other consumer; is_distributed is kept as an attribute
    (its parameter-server use is not ported: ROADMAP.md queue 1 item
    12)."""
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
    tmp.lod_level = input.lod_level  # ShareLoD
    return tmp


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_format="NCHW"):
    """data_format NCHW or NHWC; the filter is OIHW in either, with the
    JAX package's default init N(0, sqrt(2 / (kh * kw * C)))."""
    helper = LayerHelper("conv2d", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    num_channels = input.shape[1] if data_format == "NCHW" \
        else input.shape[-1]
    groups = groups or 1
    if isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    if isinstance(stride, int):
        stride = [stride, stride]
    if isinstance(padding, int):
        padding = [padding, padding]
    if isinstance(dilation, int):
        dilation = [dilation, dilation]
    filter_shape = [num_filters, num_channels // groups] + list(filter_size)
    std = (2.0 / (filter_size[0] * filter_size[1] * num_channels)) ** 0.5
    w = helper.create_parameter(
        attr=helper.param_attr, shape=filter_shape, dtype=dtype,
        default_initializer=NormalInitializer(0.0, std, 0))
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="conv2d",
        inputs={"Input": input, "Filter": w},
        outputs={"Output": pre_bias},
        attrs={"strides": stride, "paddings": padding, "dilations": dilation,
               "groups": groups, "use_cudnn": use_cudnn,
               "data_format": data_format})
    c_dim = 1 if data_format == "NCHW" else 3
    pre_act = helper.append_bias_op(pre_bias, dim_start=c_dim,
                                    dim_end=c_dim + 1)
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, exclusive=True, name=None, data_format="NCHW"):
    helper = LayerHelper("pool2d", name=name)
    if isinstance(pool_size, int):
        pool_size = [pool_size, pool_size]
    if isinstance(pool_stride, int):
        pool_stride = [pool_stride, pool_stride]
    if isinstance(pool_padding, int):
        pool_padding = [pool_padding, pool_padding]
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="pool2d", inputs={"X": input}, outputs={"Out": out},
        attrs={"pooling_type": pool_type, "ksize": pool_size,
               "strides": pool_stride, "paddings": pool_padding,
               "global_pooling": global_pooling, "ceil_mode": ceil_mode,
               "exclusive": exclusive, "data_format": data_format})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None, do_model_average_for_mean_and_var=
               False, fuse_with_relu=False, use_global_stats=False):
    """Scale and Bias are parameters; the moving Mean and Variance are
    persistable vars filled by the startup program (0 and 1) and written
    back by the op's MeanOut / VarianceOut."""
    helper = LayerHelper("batch_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    channels = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    param_shape = [channels]
    scale = helper.create_parameter(attr=helper.param_attr, shape=param_shape,
                                    dtype=dtype,
                                    default_initializer=Constant(1.0))
    bias = helper.create_parameter(attr=helper.bias_attr, shape=param_shape,
                                   dtype=dtype, is_bias=True)
    mean_name = moving_mean_name or unique_name.generate(helper.name
                                                         + ".mean")
    var_name = moving_variance_name or unique_name.generate(helper.name
                                                            + ".var")
    gb = helper.main_program.global_block()
    mean = gb.create_var(name=mean_name, shape=param_shape, dtype=dtype,
                         persistable=True, stop_gradient=True)
    variance = gb.create_var(name=var_name, shape=param_shape, dtype=dtype,
                             persistable=True, stop_gradient=True)
    helper.set_variable_initializer(mean, Constant(0.0))
    helper.set_variable_initializer(variance, Constant(1.0))
    saved_mean = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="batch_norm",
        inputs={"X": input, "Scale": scale, "Bias": bias, "Mean": mean,
                "Variance": variance},
        outputs={"Y": out, "MeanOut": mean, "VarianceOut": variance,
                 "SavedMean": saved_mean, "SavedVariance": saved_var},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "use_global_stats": use_global_stats,
               "data_layout": data_layout})
    return helper.append_activation(out)


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


def softmax(input, use_cudnn=True, name=None, axis=-1):
    return _single_op_layer(LayerHelper("softmax", name=name), "softmax",
                            input, {"axis": axis})


def relu(x, name=None):
    return _single_op_layer(LayerHelper("relu", name=name), "relu", x)


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="cross_entropy",
                     inputs={"X": input, "Label": label},
                     outputs={"Y": out},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index})
    return out


def square_error_cost(input, label):
    """(input - label) ** 2, elementwise."""
    helper = LayerHelper("square_error_cost")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="square_error_cost",
                     inputs={"X": input, "Y": label},
                     outputs={"Out": out})
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


def accuracy(input, label, k=1, correct=None, total=None):
    """top_k, then the accuracy op over its indices."""
    helper = LayerHelper("accuracy")
    topk_out = helper.create_variable_for_type_inference(input.dtype)
    topk_indices = helper.create_variable_for_type_inference(
        core.VarDesc.VarType.INT64, stop_gradient=True)
    helper.append_op(type="top_k", inputs={"X": input},
                     outputs={"Out": topk_out, "Indices": topk_indices},
                     attrs={"k": k})
    acc_out = helper.create_variable_for_type_inference("float32",
                                                        stop_gradient=True)
    if correct is None:
        correct = helper.create_variable_for_type_inference(
            core.VarDesc.VarType.INT32, stop_gradient=True)
    if total is None:
        total = helper.create_variable_for_type_inference(
            core.VarDesc.VarType.INT32, stop_gradient=True)
    helper.append_op(
        type="accuracy",
        inputs={"Out": topk_out, "Indices": topk_indices, "Label": label},
        outputs={"Accuracy": acc_out, "Correct": correct, "Total": total})
    return acc_out


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference(
        core.VarDesc.VarType.INT64, stop_gradient=True)
    helper.append_op(type="top_k", inputs={"X": input},
                     outputs={"Out": values, "Indices": indices},
                     attrs={"k": k})
    return values, indices


def _elementwise(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type, act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type=op_type, inputs={"X": x, "Y": y},
                     outputs={"Out": out}, attrs={"axis": axis})
    return helper.append_activation(out)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_add", x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_mul", x, y, axis, act, name)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_sub", x, y, axis, act, name)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_min", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_div", x, y, axis, act, name)


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_max", x, y, axis, act, name)


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_pow", x, y, axis, act, name)


def pow(x, factor=1.0, name=None):
    return _single_op_layer(LayerHelper("pow", name=name), "pow", x,
                            {"factor": factor})


def clip(x, min, max, name=None):
    return _single_op_layer(LayerHelper("clip", name=name), "clip", x,
                            {"min": min, "max": max})


def clip_by_norm(x, max_norm, name=None):
    return _single_op_layer(LayerHelper("clip_by_norm", name=name),
                            "clip_by_norm", x, {"max_norm": max_norm})


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="mul", inputs={"X": x, "Y": y},
                     outputs={"Out": out},
                     attrs={"x_num_col_dims": x_num_col_dims,
                            "y_num_col_dims": y_num_col_dims})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0,
           name=None):
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="matmul", inputs={"X": x, "Y": y},
                     outputs={"Out": out},
                     attrs={"transpose_X": transpose_x,
                            "transpose_Y": transpose_y, "alpha": alpha})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op(type="concat", inputs={"X": input},
                     outputs={"Out": out}, attrs={"axis": axis})
    return out


def stack(x, axis=0):
    helper = LayerHelper("stack")
    out = helper.create_variable_for_type_inference(x[0].dtype)
    helper.append_op(type="stack", inputs={"X": x}, outputs={"Y": out},
                     attrs={"axis": axis})
    return out


def gather(input, index):
    helper = LayerHelper("gather")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="gather", inputs={"X": input, "Index": index},
                     outputs={"Out": out})
    return out


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="expand", inputs={"X": x}, outputs={"Out": out},
                     attrs={"expand_times": expand_times})
    return out


def squeeze(input, axes, name=None):
    helper = LayerHelper("squeeze", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    xshape = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op(type="squeeze2", inputs={"X": input},
                     outputs={"Out": out, "XShape": xshape},
                     attrs={"axes": axes})
    return out


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    xshape = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op(type="unsqueeze2", inputs={"X": input},
                     outputs={"Out": out, "XShape": xshape},
                     attrs={"axes": axes})
    return out


def _reduce(op_type, input, dim=None, keep_dim=False, name=None):
    helper = LayerHelper(op_type, name=name)
    if dim is not None and not isinstance(dim, (list, tuple)):
        dim = [dim]
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type=op_type, inputs={"X": input},
                     outputs={"Out": out},
                     attrs={"dim": dim if dim is not None else [0],
                            "keep_dim": keep_dim,
                            "reduce_all": dim is None})
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_sum", input, dim, keep_dim, name)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_mean", input, dim, keep_dim, name)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_max", input, dim, keep_dim, name)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_min", input, dim, keep_dim, name)


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_prod", input, dim, keep_dim, name)


def beam_slot_mask(context, beam_size):
    """[B*W, 1] additive mask: 0 for each source's beam slot 0 and -1e9
    for the other W - 1 start beams (rows grouped per source, slot = row
    % W), so the first expansion selects from one beam a source."""
    from .ops import floor
    from .tensor import fill_constant_batch_size_like
    W = beam_size
    ones = fill_constant_batch_size_like(
        input=context, shape=[-1, 1], value=1.0, dtype="float32")
    ramp = cumsum(ones, axis=0, exclusive=True)   # 0, 1, 2, ...
    slot = elementwise_sub(
        ramp, scale(floor(scale(ramp, scale=1.0 / W)), scale=float(W)))
    return scale(elementwise_min(slot, ones), scale=-1e9)


def where(condition, x=None, y=None):
    helper = LayerHelper("where")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="where",
                     inputs={"Condition": condition, "X": x, "Y": y},
                     outputs={"Out": out})
    return out


def mean(x, name=None):
    return _single_op_layer(LayerHelper("mean", name=name), "mean", x)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper("scale", act=act, name=name)
    out = _single_op_layer(helper, "scale", x,
                           {"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out)


def reshape(x, shape, actual_shape=None, act=None, inplace=False,
            name=None):
    """`actual_shape` and `inplace` are taken for the JAX package's
    signature, which ignores them too."""
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


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    """NCHW; the filter [in_c, num_filters / groups, kh, kw], its size
    given or derived from `output_size`."""
    helper = LayerHelper("conv2d_transpose", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    groups = groups or 1
    if isinstance(stride, int):
        stride = [stride, stride]
    if isinstance(padding, int):
        padding = [padding, padding]
    if isinstance(dilation, int):
        dilation = [dilation, dilation]
    if filter_size is None:
        if output_size is None:
            raise ValueError("output_size or filter_size required")
        if isinstance(output_size, int):
            output_size = [output_size, output_size]
        h_in, w_in = input.shape[2], input.shape[3]
        filter_size = [
            (output_size[0] - (h_in - 1) * stride[0] + 2 * padding[0] - 1)
            // dilation[0] + 1,
            (output_size[1] - (w_in - 1) * stride[1] + 2 * padding[1] - 1)
            // dilation[1] + 1]
    elif isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    if input.shape[1] % groups or num_filters % groups:
        raise ValueError(
            "conv2d_transpose: in_channels (%d) and num_filters (%d) must "
            "both be divisible by groups (%d)"
            % (input.shape[1], num_filters, groups))
    filter_shape = [input.shape[1], num_filters // groups] + list(filter_size)
    w = helper.create_parameter(attr=helper.param_attr, shape=filter_shape,
                                dtype=dtype)
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="conv2d_transpose", inputs={"Input": input, "Filter": w},
        outputs={"Output": pre_bias},
        attrs={"strides": stride, "paddings": padding, "dilations": dilation,
               "groups": groups})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, data_layout="NCHW", name=None):
    helper = LayerHelper("group_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    channels = input.shape[1]
    inputs = {"X": input}
    if helper.param_attr is not False:
        inputs["Scale"] = helper.create_parameter(
            attr=helper.param_attr, shape=[channels], dtype=dtype,
            default_initializer=Constant(1.0))
    if helper.bias_attr is not False:
        inputs["Bias"] = helper.create_parameter(
            attr=helper.bias_attr, shape=[channels], dtype=dtype,
            is_bias=True)
    out = helper.create_variable_for_type_inference(dtype)
    mean = helper.create_variable_for_type_inference(dtype, True)
    var = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op(type="group_norm", inputs=inputs,
                     outputs={"Y": out, "Mean": mean, "Variance": var},
                     attrs={"groups": groups, "epsilon": epsilon})
    return helper.append_activation(out)


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      name=None):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="sigmoid_cross_entropy_with_logits",
                     inputs={"X": x, "Label": label},
                     outputs={"Out": out},
                     attrs={"ignore_index": ignore_index})
    return out


def one_hot(input, depth):
    helper = LayerHelper("one_hot")
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op(type="one_hot", inputs={"X": input},
                     outputs={"Out": out}, attrs={"depth": depth})
    return out


def sign(x):
    return _single_op_layer(LayerHelper("sign"), "sign", x)


def _op_layer(op_type, x, name, **attrs):
    """One `op_type` op from X to Out with `attrs`."""
    return _single_op_layer(LayerHelper(op_type, name=name), op_type, x,
                            attrs)


def leaky_relu(x, alpha=0.02, name=None):
    return _op_layer("leaky_relu", x, name, alpha=alpha)


def soft_relu(x, threshold=40.0, name=None):
    return _op_layer("soft_relu", x, name, threshold=threshold)


def brelu(x, t_min=0.0, t_max=24.0, name=None):
    return _op_layer("brelu", x, name, t_min=t_min, t_max=t_max)


def elu(x, alpha=1.0, name=None):
    return _op_layer("elu", x, name, alpha=alpha)


def relu6(x, threshold=6.0, name=None):
    return _op_layer("relu6", x, name, threshold=threshold)


def hard_sigmoid(x, slope=0.2, offset=0.5, name=None):
    return _op_layer("hard_sigmoid", x, name, slope=slope, offset=offset)


def swish(x, beta=1.0, name=None):
    return _op_layer("swish", x, name, beta=beta)


def stanh(x, scale_a=2.0 / 3.0, scale_b=1.7159, name=None):
    return _op_layer("stanh", x, name, scale_a=float(scale_a),
                       scale_b=float(scale_b))


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    helper = LayerHelper("l2_normalize", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    norm = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op(type="l2_normalize", inputs={"X": x},
                     outputs={"Out": out, "Norm": norm},
                     attrs={"axis": axis, "epsilon": epsilon})
    return out


def _with_xshape(layer, op_type, x, attrs, name=None):
    helper = LayerHelper(layer, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op(type=op_type, inputs={"X": x},
                     outputs={"Out": out, "XShape": xshape}, attrs=attrs)
    return out


def transpose(x, perm, name=None):
    return _with_xshape("transpose", "transpose2", x, {"axis": list(perm)},
                        name)


def flatten(x, axis=1, name=None):
    return _with_xshape("flatten2", "flatten2", x, {"axis": axis}, name)


def split(input, num_or_sections, dim=-1, name=None):
    """`num_or_sections` equal parts (an int) or parts of the listed
    sizes, along `dim`: a list of Variables."""
    helper = LayerHelper("split", name=name)
    dim = dim if dim >= 0 else dim + len(input.shape)
    if isinstance(num_or_sections, int):
        num, sections = num_or_sections, []
    else:
        num, sections = 0, list(num_or_sections)
    outs = [helper.create_variable_for_type_inference(input.dtype)
            for _ in range(num if num else len(sections))]
    helper.append_op(type="split", inputs={"X": input},
                     outputs={"Out": outs},
                     attrs={"num": num, "sections": sections, "axis": dim})
    return outs


def unstack(x, axis=0, num=None):
    helper = LayerHelper("unstack")
    if num is None:
        num = x.shape[axis]
    outs = [helper.create_variable_for_type_inference(x.dtype)
            for _ in range(num)]
    helper.append_op(type="unstack", inputs={"X": x}, outputs={"Y": outs},
                     attrs={"axis": axis, "num": num})
    return outs


def gather_nd(input, index, name=None):
    helper = LayerHelper("gather_nd", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="gather_nd", inputs={"X": input, "Index": index},
                     outputs={"Out": out})
    return out


def scatter(input, index, updates, name=None, overwrite=True):
    helper = LayerHelper("scatter", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="scatter",
                     inputs={"X": input, "Ids": index, "Updates": updates},
                     outputs={"Out": out}, attrs={"overwrite": overwrite})
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    return _op_layer("pad", x, name, paddings=paddings,
                       pad_value=pad_value)


def pad2d(input, paddings=[0, 0, 0, 0], mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    """`data_format` is not passed to the op, as in the JAX layer (the op
    reads NCHW)."""
    return _op_layer("pad2d", input, name, paddings=paddings, mode=mode,
                       pad_value=pad_value)


def argmax(x, axis=0, name=None):
    return _single_op_layer(LayerHelper("arg_max", name=name), "arg_max",
                            x, {"axis": axis},
                            out_dtype=core.VarDesc.VarType.INT64)


def argmin(x, axis=0, name=None):
    return _single_op_layer(LayerHelper("arg_min", name=name), "arg_min",
                            x, {"axis": axis},
                            out_dtype=core.VarDesc.VarType.INT64)


def argsort(input, axis=-1, name=None):
    helper = LayerHelper("argsort", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    ids = helper.create_variable_for_type_inference(
        core.VarDesc.VarType.INT64, stop_gradient=True)
    helper.append_op(type="argsort", inputs={"X": input},
                     outputs={"Out": out, "Indices": ids},
                     attrs={"axis": axis})
    return out, ids


def shape(input):
    helper = LayerHelper("shape")
    out = helper.create_variable_for_type_inference(
        core.VarDesc.VarType.INT32, stop_gradient=True)
    helper.append_op(type="shape", inputs={"Input": input},
                     outputs={"Out": out})
    return out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    helper = LayerHelper("smooth_l1_loss")
    diff = helper.create_variable_for_type_inference(x.dtype, True)
    out = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": x, "Y": y}
    if inside_weight is not None:
        inputs["InsideWeight"] = inside_weight
    if outside_weight is not None:
        inputs["OutsideWeight"] = outside_weight
    helper.append_op(type="smooth_l1_loss", inputs=inputs,
                     outputs={"Diff": diff, "Out": out},
                     attrs={"sigma": sigma if sigma is not None else 1.0})
    return out


def huber_loss(input, label, delta):
    helper = LayerHelper("huber_loss")
    residual = helper.create_variable_for_type_inference(input.dtype, True)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="huber_loss", inputs={"X": input, "Y": label},
                     outputs={"Out": out, "Residual": residual},
                     attrs={"delta": delta})
    return out


def log_loss(input, label, epsilon=1e-4, name=None):
    helper = LayerHelper("log_loss", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="log_loss",
                     inputs={"Predicted": input, "Labels": label},
                     outputs={"Loss": out}, attrs={"epsilon": epsilon})
    return out


def hinge_loss(input, label, name=None):
    helper = LayerHelper("hinge_loss", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="hinge_loss",
                     inputs={"Logits": input, "Labels": label},
                     outputs={"Loss": out})
    return out


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    helper = LayerHelper("margin_rank_loss", name=name)
    out = helper.create_variable_for_type_inference(left.dtype)
    act = helper.create_variable_for_type_inference(left.dtype, True)
    helper.append_op(type="margin_rank_loss",
                     inputs={"Label": label, "X1": left, "X2": right},
                     outputs={"Out": out, "Activated": act},
                     attrs={"margin": margin})
    return out


def image_resize(input, out_shape=None, scale=None, name=None,
                 resample="BILINEAR", actual_shape=None, align_corners=True,
                 align_mode=1):
    """bilinear_interp or nearest_interp of an NCHW input to `out_shape`
    (or its H, W times `scale`); `actual_shape` is taken for the
    signature."""
    helper = LayerHelper("interp", name=name)
    if out_shape is None:
        out_shape = [int(input.shape[2] * scale),
                     int(input.shape[3] * scale)]
    op_type = "bilinear_interp" if resample == "BILINEAR" \
        else "nearest_interp"
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type=op_type, inputs={"X": input},
                     outputs={"Out": out},
                     attrs={"out_h": int(out_shape[0]),
                            "out_w": int(out_shape[1]),
                            "align_corners": align_corners,
                            "align_mode": align_mode})
    return out


def resize_bilinear(input, out_shape=None, scale=None, name=None,
                    actual_shape=None):
    return image_resize(input, out_shape, scale, name, "BILINEAR")


def resize_nearest(input, out_shape=None, scale=None, name=None,
                   actual_shape=None):
    return image_resize(input, out_shape, scale, name, "NEAREST")


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="uniform_random", outputs={"Out": out},
                     attrs={"shape": shape, "dtype": out.dtype, "min": min,
                            "max": max, "seed": seed})
    return out


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("gaussian_random")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="gaussian_random", outputs={"Out": out},
                     attrs={"shape": shape, "mean": mean, "std": std,
                            "seed": seed, "dtype": out.dtype})
    return out


def uniform_random_batch_size_like(input, shape, dtype="float32",
                                   input_dim_idx=0, output_dim_idx=0,
                                   min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="uniform_random_batch_size_like",
                     inputs={"Input": input}, outputs={"Out": out},
                     attrs={"shape": shape, "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx, "min": min,
                            "max": max, "seed": seed, "dtype": out.dtype})
    return out


def gaussian_random_batch_size_like(input, shape, input_dim_idx=0,
                                    output_dim_idx=0, mean=0.0, std=1.0,
                                    seed=0, dtype="float32"):
    """The op the JAX layer appends: uniform_random_batch_size_like with
    `mean` and `std` attrs, which that op does not read, so it draws
    U[-1, 1) (kept as the JAX package's program has it)."""
    helper = LayerHelper("gaussian_random_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="uniform_random_batch_size_like",
                     inputs={"Input": input}, outputs={"Out": out},
                     attrs={"shape": shape, "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx,
                            "mean": mean, "std": std, "seed": seed,
                            "dtype": out.dtype})
    return out


def _logical_binary(op_type, x, y, out=None, name=None):
    helper = LayerHelper(op_type, name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(
            core.VarDesc.VarType.BOOL)
    helper.append_op(type=op_type, inputs={"X": x, "Y": y},
                     outputs={"Out": out})
    return out


def logical_and(x, y, out=None, name=None):
    return _logical_binary("logical_and", x, y, out, name)


def logical_or(x, y, out=None, name=None):
    return _logical_binary("logical_or", x, y, out, name)


def logical_xor(x, y, out=None, name=None):
    return _logical_binary("logical_xor", x, y, out, name)


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    helper = LayerHelper("lrn", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    mid = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op(type="lrn", inputs={"X": input},
                     outputs={"Out": out, "MidOut": mid},
                     attrs={"n": n, "k": k, "alpha": alpha, "beta": beta})
    return out


def row_conv(input, future_context_size, param_attr=None, act=None):
    """The lookahead convolution over a ragged [*, D] input with a
    [future_context_size + 1, D] filter."""
    helper = LayerHelper("row_conv", param_attr=param_attr, act=act)
    w = helper.create_parameter(
        attr=helper.param_attr, shape=[future_context_size + 1,
                                       input.shape[-1]], dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="row_conv", inputs={"X": input, "Filter": w},
                     outputs={"Out": out})
    return helper.append_activation(out)


def lod_reset(x, y=None, target_lod=None):
    """`x`'s rows regrouped by `y`'s sequences (or by the offsets
    `target_lod`); Out keeps x's build-time shape."""
    helper = LayerHelper("lod_reset")
    out = helper.create_variable_for_type_inference(x.dtype)
    out.lod_level = 1
    inputs = {"X": x}
    if y is not None:
        inputs["Y"] = y
    helper.append_op(type="lod_reset", inputs=inputs, outputs={"Out": out},
                     attrs={"target_lod": target_lod or []},
                     infer_shape=False)
    out.shape = tuple(x.shape)
    return out


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """One LSTM step: an fc of [x_t, hidden_t_prev] to the 4D gates, then
    the lstm_unit op's cell update.  Returns (h, c)."""
    helper = LayerHelper("lstm_unit_layer", name=name,
                         param_attr=param_attr, bias_attr=bias_attr)
    size = int(cell_t_prev.shape[-1])
    fc_out = fc(concat([x_t, hidden_t_prev], axis=1), size=4 * size,
                param_attr=helper.param_attr, bias_attr=helper.bias_attr,
                num_flatten_dims=1)
    h = helper.create_variable_for_type_inference(x_t.dtype)
    c = helper.create_variable_for_type_inference(x_t.dtype)
    helper.append_op(type="lstm_unit",
                     inputs={"X": fc_out, "C_prev": cell_t_prev},
                     outputs={"H": h, "C": c},
                     attrs={"forget_bias": float(forget_bias)},
                     infer_shape=False)
    h.shape = tuple(cell_t_prev.shape)
    c.shape = tuple(cell_t_prev.shape)
    return h, c
