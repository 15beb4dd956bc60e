"""Every op lowering of paddle_tpu_torch/ops held against its JAX lowering
in paddle_tpu/ops on a seeded input: the forward outputs, and the input
gradients through each package's generic vjp (registry.
make_forward_and_vjp) for seeded cotangents on every float output."""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
import torch_op_cases
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.fluid import core as tcore
from paddle_tpu_torch.ops import registry as treg
from torch_op_cases import _f, _i, _len
from torch_op_cases import make_input as _make

# fp32 on both sides, summed in other orders (matmuls, reductions)
RTOL, ATOL = 1e-5, 1e-5

FP32 = tcore.VarDesc.VarType.FP32
INT64 = tcore.VarDesc.VarType.INT64


# (case id, op type, {slot: [input spec]}, attrs)
_CASES = [
    ("fill_constant", "fill_constant", {},
     {"shape": [2, 3], "dtype": FP32, "value": 1.5}),
    ("fill_constant_int64", "fill_constant", {},
     {"shape": [1, 5], "dtype": INT64, "value": 1.0}),
    ("assign", "assign", {"X": [_f(3, 4)]}, {}),
    ("remat_tag", "remat_tag", {"X": [_f(3, 4)]}, {"tag": "block_out"}),
    ("reshape2", "reshape2", {"X": [_f(2, 3, 4)]}, {"shape": [-1, 4]}),
    ("reshape2_zero", "reshape2", {"X": [_f(2, 3, 4)]}, {"shape": [0, 12]}),
    ("slice", "slice", {"Input": [_f(2, 5, 6)]},
     {"axes": [2], "starts": [1], "ends": [4]}),
    ("slice_negative", "slice", {"Input": [_f(2, 5, 6)]},
     {"axes": [1, 2], "starts": [-3, 0], "ends": [10, -2]}),
    ("gelu", "gelu", {"X": [_f(4, 6)]}, {}),
    ("gelu_tanh", "gelu", {"X": [_f(4, 6)]}, {"approximate": True}),
    ("elementwise_add", "elementwise_add", {"X": [_f(2, 3, 4)],
                                            "Y": [_f(2, 3, 4)]},
     {"axis": -1}),
    ("elementwise_add_trailing", "elementwise_add",
     {"X": [_f(2, 3, 4)], "Y": [_f(4)]}, {"axis": -1}),
    ("elementwise_add_axis", "elementwise_add",
     {"X": [_f(2, 3, 4)], "Y": [_f(3)]}, {"axis": 1}),
    ("elementwise_add_broadcast", "elementwise_add",
     {"X": [_f(2, 3, 4)], "Y": [_f(1, 3, 4)]}, {"axis": -1}),
    ("mul", "mul", {"X": [_f(2, 3, 4)], "Y": [_f(4, 5)]},
     {"x_num_col_dims": 2, "y_num_col_dims": 1}),
    ("matmul", "matmul", {"X": [_f(2, 3, 4)], "Y": [_f(2, 4, 5)]}, {}),
    ("matmul_transposed", "matmul", {"X": [_f(4, 3)], "Y": [_f(5, 4)]},
     {"transpose_X": True, "transpose_Y": True, "alpha": 0.5}),
    ("sum", "sum", {"X": [_f(3, 4), _f(3, 4), _f(3, 4)]}, {}),
    ("scale", "scale", {"X": [_f(3, 4)]},
     {"scale": 0.5, "bias": 0.1, "bias_after_scale": True}),
    ("scale_bias_first", "scale", {"X": [_f(3, 4)]},
     {"scale": 0.5, "bias": 0.1, "bias_after_scale": False}),
    ("mean", "mean", {"X": [_f(3, 4, 2)]}, {}),
    ("square_error_cost", "square_error_cost",
     {"X": [_f(5, 1)], "Y": [_f(5, 1)]}, {}),
    ("gen_collective_id", "gen_collective_id", {},
     {"trainer_id": 3, "num_trainers": 1}),
    ("cumsum_exclusive", "cumsum", {"X": [_f(2, 5)]},
     {"axis": 1, "exclusive": True}),
    ("cumsum_reverse", "cumsum", {"X": [_f(2, 5)]},
     {"axis": 0, "reverse": True}),
    ("cumsum_int64", "cumsum", {"X": [_i(3, 1, 6)]},
     {"axis": 1, "exclusive": True}),
    ("layer_norm", "layer_norm",
     {"X": [_f(2, 3, 8)], "Scale": [_f(8)], "Bias": [_f(8)]},
     {"begin_norm_axis": 2, "epsilon": 1e-5}),
    ("layer_norm_axis1", "layer_norm",
     {"X": [_f(2, 3, 8)], "Scale": [_f(24)], "Bias": [_f(24)]},
     {"begin_norm_axis": 1, "epsilon": 1e-5}),
    ("dropout_p0", "dropout", {"X": [_f(3, 4)]},
     {"dropout_prob": 0.0, "is_test": False, "seed": 0,
      "dropout_implementation": "downgrade_in_infer"}),
    ("dropout_is_test", "dropout", {"X": [_f(3, 4)]},
     {"dropout_prob": 0.25, "is_test": True, "seed": 0,
      "dropout_implementation": "downgrade_in_infer"}),
    ("lookup_table", "lookup_table",
     {"W": [_f(10, 4)], "Ids": [_i(10, 2, 3)]}, {"padding_idx": -1}),
    ("lookup_table_padding", "lookup_table",
     {"W": [_f(10, 4)], "Ids": [_i(10, 2, 3, 1)]}, {"padding_idx": 2}),
    ("softmax_with_cross_entropy", "softmax_with_cross_entropy",
     {"Logits": [_f(6, 10)], "Label": [_i(10, 6, 1)]},
     {"soft_label": False, "ignore_index": -100}),
    ("softmax_with_cross_entropy_ignore", "softmax_with_cross_entropy",
     {"Logits": [_f(6, 10)], "Label": [_i(4, 6, 1)]},
     {"soft_label": False, "ignore_index": 3}),
    ("adam", "adam",
     {"Param": [_f(4, 3)], "Grad": [_f(4, 3)], "Moment1": [_f(4, 3)],
      "Moment2": [("pos", (4, 3))], "LearningRate": [("lr", (1,))],
      "Beta1Pow": [("b1p", (1,))], "Beta2Pow": [("b2p", (1,))]},
     {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    ("flash_attention", "flash_attention",
     {"Q": [_f(2, 16, 32)], "K": [_f(2, 16, 32)], "V": [_f(2, 16, 32)]},
     {"num_heads": 2, "causal": True}),
    ("sgd", "sgd",
     {"Param": [_f(4, 3)], "Grad": [_f(4, 3)],
      "LearningRate": [("lr", (1,))]}, {}),
    ("momentum", "momentum",
     {"Param": [_f(4, 3)], "Grad": [_f(4, 3)], "Velocity": [_f(4, 3)],
      "LearningRate": [("lr", (1,))]}, {"mu": 0.9, "use_nesterov": False}),
    ("momentum_nesterov", "momentum",
     {"Param": [_f(5)], "Grad": [_f(5)], "Velocity": [_f(5)],
      "LearningRate": [("lr", (1,))]}, {"mu": 0.9, "use_nesterov": True}),
    ("sign", "sign", {"X": [("ties", (4, 6))]}, {}),
    ("relu", "relu", {"X": [_f(3, 4)]}, {}),
    ("softmax", "softmax", {"X": [_f(3, 5)]}, {}),
    ("top_k", "top_k", {"X": [_f(4, 7)]}, {"k": 3}),
    # equal values (the lower index first), NaNs of both signs, infinities
    # and signed zeros (jax.lax.top_k orders by IEEE totalOrder)
    ("top_k_ties", "top_k", {"X": [("ties", (6, 40))]}, {"k": 9}),
    ("top_k_nans", "top_k", {"X": [("nans", (6, 24))]}, {"k": 24}),
    ("conv2d_nchw", "conv2d",
     {"Input": [_f(2, 3, 7, 7)], "Filter": [_f(4, 3, 3, 3)]},
     {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1],
      "groups": 1, "data_format": "NCHW"}),
    ("conv2d_nhwc_groups_dilation", "conv2d",
     {"Input": [_f(2, 6, 6, 4)], "Filter": [_f(6, 2, 3, 3)]},
     {"strides": [1, 1], "paddings": [2, 2], "dilations": [2, 2],
      "groups": 2, "data_format": "NHWC"}),
    ("conv2d_nhwc_bias", "conv2d",
     {"Input": [_f(2, 5, 5, 3)], "Filter": [_f(4, 3, 1, 1)],
      "Bias": [_f(4)]},
     {"strides": [2, 2], "paddings": [0, 0], "data_format": "NHWC"}),
    ("pool2d_max_ceil_nhwc", "pool2d", {"X": [_f(2, 7, 7, 3)]},
     {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
      "paddings": [1, 1], "ceil_mode": True, "data_format": "NHWC"}),
    ("pool2d_max_wide_pad", "pool2d", {"X": [_f(2, 3, 6, 6)]},
     {"pooling_type": "max", "ksize": [2, 2], "strides": [2, 2],
      "paddings": [2, 2]}),
    ("pool2d_avg_exclusive_ceil", "pool2d", {"X": [_f(2, 3, 7, 7)]},
     {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
      "paddings": [1, 1], "ceil_mode": True, "exclusive": True}),
    ("pool2d_avg_inclusive", "pool2d", {"X": [_f(2, 3, 7, 7)]},
     {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
      "paddings": [1, 1], "exclusive": False}),
    ("pool2d_global_avg_nhwc", "pool2d", {"X": [_f(2, 5, 5, 4)]},
     {"pooling_type": "avg", "ksize": [1, 1], "global_pooling": True,
      "data_format": "NHWC"}),
    # four `paddings`: the JAX lowerings pad (H, W) by the first two
    ("conv2d_nchw_four_paddings", "conv2d",
     {"Input": [_f(2, 3, 7, 7)], "Filter": [_f(4, 3, 3, 3)]},
     {"strides": [1, 1], "paddings": [1, 2, 0, 1], "data_format": "NCHW"}),
    ("conv2d_nhwc_four_paddings", "conv2d",
     {"Input": [_f(2, 6, 6, 3)], "Filter": [_f(4, 3, 3, 3)]},
     {"strides": [2, 2], "paddings": [0, 1, 1, 0], "data_format": "NHWC"}),
    ("pool2d_max_nchw_four_paddings", "pool2d", {"X": [_f(2, 3, 7, 7)]},
     {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
      "paddings": [1, 0, 0, 1], "data_format": "NCHW"}),
    ("pool2d_max_nhwc_four_paddings", "pool2d", {"X": [_f(2, 7, 7, 3)]},
     {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
      "paddings": [0, 1, 1, 0], "data_format": "NHWC"}),
    ("pool2d_avg_nchw_four_paddings", "pool2d", {"X": [_f(2, 3, 7, 7)]},
     {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
      "paddings": [1, 0, 0, 1], "exclusive": True, "data_format": "NCHW"}),
    ("pool2d_avg_nhwc_four_paddings", "pool2d", {"X": [_f(2, 7, 7, 3)]},
     {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
      "paddings": [0, 1, 1, 0], "exclusive": False, "data_format": "NHWC"}),
    ("batch_norm_is_test_nhwc", "batch_norm",
     {"X": [_f(2, 4, 4, 3)], "Scale": [_f(3)], "Bias": [_f(3)],
      "Mean": [_f(3)], "Variance": [("pos", (3,))]},
     {"is_test": True, "epsilon": 1e-5, "data_layout": "NHWC"}),
    ("batch_norm_train", "batch_norm",
     {"X": [_f(3, 4, 5, 5)], "Scale": [_f(4)], "Bias": [_f(4)],
      "Mean": [_f(4)], "Variance": [("pos", (4,))]},
     {"is_test": False, "epsilon": 1e-5, "momentum": 0.9}),
    ("cross_entropy", "cross_entropy",
     {"X": [("pos", (5, 6))], "Label": [_i(6, 5, 1)]},
     {"soft_label": False}),
    ("cross_entropy_soft", "cross_entropy",
     {"X": [("pos", (5, 6))], "Label": [("pos", (5, 6))]},
     {"soft_label": True}),
    ("accuracy", "accuracy",
     {"Out": [_f(6, 3)], "Indices": [_i(5, 6, 3)], "Label": [_i(5, 6, 1)]},
     {}),
    # the LSTM over pre-projected gates [B, T, 4H] (H = 4), with the
    # lengths companion: peepholes or not, reversed, lengths 1, T, mixed
    ("lstm_peepholes_mixed", "lstm",
     {"Input": [_f(3, 5, 16)], "Weight": [_f(4, 16)], "Bias": [_f(1, 28)],
      "Input@LOD_LEN": [_len(2, 5, 1)]},
     {"use_peepholes": True, "is_reverse": False}),
    ("lstm_no_peepholes", "lstm",
     {"Input": [_f(3, 5, 16)], "Weight": [_f(4, 16)], "Bias": [_f(1, 16)],
      "Input@LOD_LEN": [_len(5, 3, 4)]},
     {"use_peepholes": False, "is_reverse": False}),
    ("lstm_reverse", "lstm",
     {"Input": [_f(3, 5, 16)], "Weight": [_f(4, 16)], "Bias": [_f(1, 28)],
      "Input@LOD_LEN": [_len(3, 5, 1)]},
     {"use_peepholes": True, "is_reverse": True}),
    ("lstm_lengths_1", "lstm",
     {"Input": [_f(3, 4, 16)], "Weight": [_f(4, 16)], "Bias": [_f(1, 28)],
      "Input@LOD_LEN": [_len(1, 1, 1)]},
     {"use_peepholes": True, "is_reverse": True}),
    ("lstm_lengths_T", "lstm",
     {"Input": [_f(2, 6, 16)], "Weight": [_f(4, 16)], "Bias": [_f(1, 28)],
      "Input@LOD_LEN": [_len(6, 6)]},
     {"use_peepholes": True, "is_reverse": False}),
    ("lstm_h0_c0", "lstm",
     {"Input": [_f(3, 5, 16)], "Weight": [_f(4, 16)], "Bias": [_f(1, 28)],
      "H0": [_f(3, 4)], "C0": [_f(3, 4)], "Input@LOD_LEN": [_len(4, 2, 5)]},
     {"use_peepholes": True, "is_reverse": False}),
    ("lstm_dense", "lstm",
     {"Input": [_f(2, 4, 16)], "Weight": [_f(4, 16)], "Bias": [_f(1, 16)]},
     {"use_peepholes": True, "is_reverse": False}),
    # every pool type over [B, T, 3] with an empty sequence among them
    ] + [
    ("sequence_pool_" + ptype.lower(), "sequence_pool",
     {"X": [_f(4, 6, 3)], "X@LOD_LEN": [_len(3, 0, 6, 1)]},
     {"pooltype": ptype})
    for ptype in ("AVERAGE", "SUM", "SQRT", "MAX", "LAST", "FIRST")] + [
    ("sequence_pool_max_ties", "sequence_pool",
     {"X": [("ties", (4, 6, 3))], "X@LOD_LEN": [_len(3, 2, 6, 4)]},
     {"pooltype": "MAX"}),
    ("sequence_pool_dense_average", "sequence_pool", {"X": [_f(2, 5, 3)]},
     {"pooltype": "AVERAGE"}),
    ("sigmoid", "sigmoid", {"X": [_f(3, 4)]}, {}),
    ("tanh", "tanh", {"X": [_f(3, 4)]}, {}),
    ("elementwise_mul", "elementwise_mul",
     {"X": [_f(2, 3, 4)], "Y": [_f(2, 3, 4)]}, {"axis": -1}),
    ("elementwise_mul_axis", "elementwise_mul",
     {"X": [_f(2, 3, 4)], "Y": [_f(3)]}, {"axis": 1}),
    # SE-ResNeXt's excitation: [N, H, W, C] times [N, 1, 1, C]
    ("elementwise_mul_excitation", "elementwise_mul",
     {"X": [_f(2, 3, 3, 4)], "Y": [_f(2, 1, 1, 4)]}, {"axis": -1}),
    # a ragged X: axis 1 of the packed [rows, 4] is axis 2 of [B, T, 4]
    ("elementwise_mul_ragged_axis", "elementwise_mul",
     {"X": [_f(3, 5, 4)], "Y": [_f(4)], "X@LOD_LEN": [_len(2, 5, 3)]},
     {"axis": 1}),
    ("elementwise_add_ragged_axis", "elementwise_add",
     {"X": [_f(3, 5, 4)], "Y": [_f(4)], "X@LOD_LEN": [_len(2, 5, 3)]},
     {"axis": 1}),
    ("increment", "increment", {"X": [_f(1)]}, {"step": 1.0}),
    ("increment_step", "increment", {"X": [_f(2, 3)]}, {"step": -2.5}),
    ("less_than", "less_than", {"X": [_f(1)], "Y": [_f(1)]}, {"axis": -1}),
    ("less_than_broadcast", "less_than", {"X": [_f(3, 4)], "Y": [_f(4)]},
     {"axis": -1}),
    ("where", "where", {"Condition": [("bool", (3, 4))], "X": [_f(3, 4)],
                        "Y": [_f(3, 4)]}, {}),
    ("mul_ragged", "mul",
     {"X": [_f(3, 5, 6)], "Y": [_f(6, 7)], "X@LOD_LEN": [_len(2, 5, 1)]},
     {"x_num_col_dims": 1, "y_num_col_dims": 1}),
    ("mean_ragged", "mean",
     {"X": [_f(3, 5, 2)], "X@LOD_LEN": [_len(2, 5, 0)]}, {}),
    ("reshape2_ragged", "reshape2",
     {"X": [_f(3, 5, 6)], "X@LOD_LEN": [_len(2, 5, 1)]},
     {"shape": [-1, 2, 3]}),
    ("cross_entropy_ragged", "cross_entropy",
     {"X": [("pos", (3, 5, 6))], "Label": [_i(6, 3, 5, 1)],
      "X@LOD_LEN": [_len(2, 5, 1)], "Label@LOD_LEN": [_len(2, 5, 1)]},
     {"soft_label": False}),
    ("lookup_table_ragged", "lookup_table",
     {"W": [_f(10, 4)], "Ids": [_i(10, 3, 5, 1)],
      "Ids@LOD_LEN": [_len(2, 5, 1)]}, {"padding_idx": -1}),
    # the ops of control flow and machine translation
    ("elementwise_sub", "elementwise_sub",
     {"X": [_f(2, 3, 4)], "Y": [_f(3)]}, {"axis": 1}),
    ("elementwise_min", "elementwise_min",
     {"X": [("ties", (3, 4))], "Y": [_f(4)]}, {"axis": -1}),
    ("equal", "equal", {"X": [_i(3, 3, 4)], "Y": [_i(3, 3, 4)]}, {}),
    ("floor", "floor", {"X": [_f(3, 4)]}, {}),
    ("log", "log", {"X": [("pos", (3, 4))]}, {}),
    ("square", "square", {"X": [_f(3, 4)]}, {}),
    ("logical_not", "logical_not", {"X": [("bool", (3, 4))]}, {}),
    ("cast_to_int", "cast", {"X": [_f(3, 4)]},
     {"in_dtype": FP32, "out_dtype": INT64}),
    ("cast_to_float", "cast", {"X": [_i(9, 3, 4)]},
     {"in_dtype": INT64, "out_dtype": FP32}),
    ("reduce_sum_dim", "reduce_sum", {"X": [_f(2, 3, 4)]},
     {"dim": [1], "keep_dim": False, "reduce_all": False}),
    ("reduce_sum_all", "reduce_sum", {"X": [_f(2, 3, 4)]},
     {"dim": [0], "keep_dim": True, "reduce_all": True}),
    ("fill_constant_batch_size_like", "fill_constant_batch_size_like",
     {"Input": [_f(5, 3)]}, {"shape": [-1, 2], "dtype": FP32, "value": 0.5}),
    ("fill_zeros_like", "fill_zeros_like", {"X": [_f(3, 4)]}, {}),
    ("concat", "concat", {"X": [_f(2, 3), _f(2, 5)]}, {"axis": 1}),
    ("concat_ragged", "concat",
     {"X": [_f(3, 5, 2), _f(3, 5, 4)], "X@LOD_LEN": [_len(2, 5, 1),
                                                      _len(2, 5, 1)]},
     {"axis": 1}),
    ("gather", "gather", {"X": [_f(5, 3)], "Index": [_i(5, 4)]}, {}),
    ("gather_column", "gather", {"X": [_f(5, 2, 3)], "Index": [_i(5, 4, 1)]},
     {}),
    ("stack", "stack", {"X": [_f(2, 3), _f(2, 3), _f(2, 3)]}, {"axis": 1}),
    ("unsqueeze", "unsqueeze", {"X": [_f(2, 3)]}, {"axes": [0, 2]}),
    ("unsqueeze2", "unsqueeze2", {"X": [_f(2, 3)]}, {"axes": [1]}),
    ("squeeze", "squeeze", {"X": [_f(2, 1, 3, 1)]}, {"axes": [1, -1]}),
    ("squeeze2", "squeeze2", {"X": [_f(2, 1, 3)]}, {"axes": [1]}),
    ("expand", "expand", {"X": [_f(2, 1, 3)]}, {"expand_times": [1, 3, 2]}),
    ("is_empty", "is_empty", {"X": [_f(2, 3)]}, {}),
    ("print", "print", {"In": [_f(2, 3)]},
     {"message": "parity", "print_phase": "forward"}),
    ("sequence_first_step", "sequence_first_step",
     {"X": [_f(3, 4, 2)], "X@LOD_LEN": [_len(2, 4, 1)]}, {}),
    ("sequence_last_step", "sequence_last_step",
     {"X": [_f(3, 4, 2)], "X@LOD_LEN": [_len(2, 4, 1)]}, {}),
    ("sequence_softmax", "sequence_softmax",
     {"X": [_f(3, 5, 1)], "X@LOD_LEN": [_len(2, 5, 1)]}, {}),
    ("sequence_softmax_2d", "sequence_softmax",
     {"X": [_f(3, 5)], "X@LOD_LEN": [_len(4, 1, 5)]}, {}),
    ("sequence_expand_dense_x", "sequence_expand",
     {"X": [_f(3, 4)], "Y": [_f(3, 5, 4)], "Y@LOD_LEN": [_len(2, 5, 1)]},
     {"ref_level": -1}),
    ("sequence_expand_ragged_x", "sequence_expand",
     {"X": [_f(2, 3, 4)], "Y": [_f(4, 5, 4)],
      "X@LOD_LEN": [_len(3, 1)], "Y@LOD_LEN": [_len(2, 5, 1, 3)]},
     {"ref_level": -1}),
    ("sequence_pad", "sequence_pad",
     {"X": [_f(3, 5, 2)], "PadValue": [_f(1)],
      "X@LOD_LEN": [_len(2, 5, 0)]}, {"padded_length": -1}),
    ("lod_rank_table", "lod_rank_table",
     {"X": [_f(5, 3, 2)], "X@LOD_LEN": [_len(2, 3, 1, 3, 3)]},
     {"level": 0}),
    ("reorder_lod_tensor_by_rank", "reorder_lod_tensor_by_rank",
     {"X": [_f(4, 3, 2)], "RankTable": [_i(4, 4)],
      "X@LOD_LEN": [_len(2, 3, 1, 3)]}, {}),
    ("split_lod_tensor", "split_lod_tensor",
     {"X": [_f(4, 3)], "Mask": [("bool", (4, 1))]}, {}),
    ("merge_lod_tensor", "merge_lod_tensor",
     {"InTrue": [_f(4, 3)], "InFalse": [_f(4, 3)],
      "Mask": [("bool", (4, 1))], "X": [_f(4, 3)]}, {}),
    ("beam_search", "beam_search",
     {"pre_ids": [_i(4, 6, 1)], "pre_scores": [_f(6, 1)],
      "scores": [_f(6, 5)]},
     {"beam_size": 3, "end_id": 1, "level": 0, "is_accumulated": True}),
    ("beam_search_decode", "beam_search_decode",
     {"Ids": [_i(4, 5, 6)], "Scores": [_f(5, 6)],
      "ParentIdx": [_i(6, 5, 6)]}, {"beam_size": 3, "end_id": 1}),
    # the math that gradient clipping, the LR schedules and the Variable
    # operators append
    ("exp", "exp", {"X": [_f(3, 4)]}, {}),
    ("cos", "cos", {"X": [_f(3, 4)]}, {}),
    ("sin", "sin", {"X": [_f(3, 4)]}, {}),
    ("sqrt", "sqrt", {"X": [("pos", (3, 4))]}, {}),
    ("ceil", "ceil", {"X": [_f(3, 4)]}, {}),
    ("abs", "abs", {"X": [_f(3, 4)]}, {}),
    ("pow", "pow", {"X": [("pos", (3, 4))]}, {"factor": -0.5}),
    ("elementwise_div", "elementwise_div",
     {"X": [_f(2, 3, 4)], "Y": [("pos", (4,))]}, {"axis": -1}),
    ("elementwise_max", "elementwise_max",
     {"X": [_f(2, 3, 4)], "Y": [_f(2, 3, 4)]}, {"axis": -1}),
    ("elementwise_pow", "elementwise_pow",
     {"X": [("pos", (3, 4))], "Y": [_f(3, 4)]}, {"axis": -1}),
    ("elementwise_mod", "elementwise_mod",
     {"X": [_f(3, 4)], "Y": [("pos", (3, 4))]}, {"axis": -1}),
    ("less_equal", "less_equal", {"X": [("ties", (3, 4))],
                                  "Y": [("ties", (3, 4))]}, {"axis": -1}),
    ("greater_than", "greater_than", {"X": [("ties", (3, 4))],
                                      "Y": [("ties", (3, 4))]},
     {"axis": -1}),
    ("greater_equal", "greater_equal", {"X": [("ties", (3, 4))],
                                        "Y": [("ties", (4,))]},
     {"axis": -1}),
    ("clip", "clip", {"X": [_f(4, 5)]}, {"min": -0.5, "max": 0.7}),
    ("clip_by_norm", "clip_by_norm", {"X": [_f(4, 5)]}, {"max_norm": 1.5}),
    ("clip_by_norm_under", "clip_by_norm", {"X": [_f(4, 5)]},
     {"max_norm": 100.0}),
    ("squared_l2_norm", "squared_l2_norm", {"X": [_f(4, 5)]}, {}),
    # the other optimizers' updates
    ("lars_momentum", "lars_momentum",
     {"Param": [_f(4, 3)], "Grad": [_f(4, 3)], "Velocity": [_f(4, 3)],
      "LearningRate": [("lr", (1,))]},
     {"mu": 0.9, "lars_coeff": 0.001, "lars_weight_decay": 0.0005}),
    ("adamax", "adamax",
     {"Param": [_f(4, 3)], "Grad": [_f(4, 3)], "Moment": [_f(4, 3)],
      "InfNorm": [("pos", (4, 3))], "LearningRate": [("lr", (1,))],
      "Beta1Pow": [("b1p", (1,))]},
     {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    ("adagrad", "adagrad",
     {"Param": [_f(4, 3)], "Grad": [_f(4, 3)], "Moment": [("pos", (4, 3))],
      "LearningRate": [("lr", (1,))]}, {"epsilon": 1e-6}),
    ("decayed_adagrad", "decayed_adagrad",
     {"Param": [_f(4, 3)], "Grad": [_f(4, 3)], "Moment": [("pos", (4, 3))],
      "LearningRate": [("lr", (1,))]}, {"decay": 0.95, "epsilon": 1e-6}),
    ("adadelta", "adadelta",
     {"Param": [_f(4, 3)], "Grad": [_f(4, 3)],
      "AvgSquaredGrad": [("pos", (4, 3))],
      "AvgSquaredUpdate": [("pos", (4, 3))]}, {"rho": 0.95,
                                               "epsilon": 1e-6}),
    ("rmsprop", "rmsprop",
     {"Param": [_f(4, 3)], "Grad": [_f(4, 3)],
      "MeanSquare": [("pos", (4, 3))], "Moment": [_f(4, 3)],
      "MeanGrad": [_f(4, 3)], "LearningRate": [("lr", (1,))]},
     {"decay": 0.95, "epsilon": 1e-6, "momentum": 0.9, "centered": False}),
    ("rmsprop_centered", "rmsprop",
     {"Param": [_f(4, 3)], "Grad": [_f(4, 3)],
      "MeanSquare": [("pos", (4, 3))], "Moment": [_f(4, 3)],
      "MeanGrad": [("pos", (4, 3))], "LearningRate": [("lr", (1,))]},
     {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.0, "centered": True}),
    ("ftrl", "ftrl",
     {"Param": [_f(4, 3)], "Grad": [_f(4, 3)],
      "SquaredAccumulator": [("pos", (4, 3))],
      "LinearAccumulator": [_f(4, 3)], "LearningRate": [("lr", (1,))]},
     {"l1": 0.1, "l2": 0.2, "lr_power": -0.5}),
    ("ftrl_power", "ftrl",
     {"Param": [_f(4, 3)], "Grad": [_f(4, 3)],
      "SquaredAccumulator": [("pos", (4, 3))],
      "LinearAccumulator": [_f(4, 3)], "LearningRate": [("lr", (1,))]},
     {"l1": 0.0, "l2": 0.1, "lr_power": -0.7}),
    ("proximal_gd", "proximal_gd",
     {"Param": [_f(4, 3)], "Grad": [_f(4, 3)],
      "LearningRate": [("lr", (1,))]}, {"l1": 0.5, "l2": 0.1}),
    ("average_accumulates", "average_accumulates",
     {"param": [_f(4, 3)], "in_sum_1": [_f(4, 3)], "in_sum_2": [_f(4, 3)],
      "in_sum_3": [_f(4, 3)], "in_num_accumulates": [_i(4, 1)],
      "in_old_num_accumulates": [_i(4, 1)], "in_num_updates": [_i(9, 1)]},
     {"average_window": 0.5, "min_average_window": 2,
      "max_average_window": 4}),
    # the repairs of queue 3's faults: gather outside [0, N), casts that
    # saturate, and JAX's gradients at ties, zeros and NaNs
] + torch_op_cases.REPAIR_CASES

# the cases above again with their float inputs in bf16 ("X" slots), or
# only the listed slots (the LSTM under AMP: its gates arrive in bf16 from
# the white-listed fc, its weights stay fp32 masters): the JAX lowering's
# dtypes, and its values to one bf16 ulp
_BF16_CASES = {
    "lstm_peepholes_mixed": ("Input",),
    "lstm_reverse": ("Input",),
    "lstm_no_peepholes": ("Input",),
    "sequence_pool_average": None, "sequence_pool_sum": None,
    "sequence_pool_sqrt": None, "sequence_pool_max": None,
    "sequence_pool_last": None, "sequence_pool_first": None,
    "sequence_pool_max_ties": None,
    "sigmoid": None, "tanh": None,
    "elementwise_mul": None, "elementwise_mul_axis": None,
    "elementwise_mul_excitation": ("X",),
    "elementwise_mul_ragged_axis": None,
    "elementwise_add_ragged_axis": None,
    "increment": None, "less_than": None, "where": None,
    "mul_ragged": None, "mean_ragged": None, "reshape2_ragged": None,
    # the AMP path's bf16 average pools (SE-ResNeXt's squeeze is a global
    # one): summed one element at a time in bf16, the window sum's grad
    "pool2d_global_avg_nhwc": None, "pool2d_avg_exclusive_ceil": None,
}

# registered ops whose parity with the JAX package runs outside _CASES:
# the random ops (test_*_random below), and the inference-only ops, which
# read their output dtype from a program block and run in whole programs
# (test_torch_fused_bottleneck, test_torch_resnet_inference,
# test_torch_dequant_matmul)
_ELSEWHERE = {"uniform_random", "gaussian_random", "fused_bottleneck",
              "dequant_mul", "dequant_conv2d", "dequant_lookup_table",
              # ops over sub-blocks and tensor arrays (the env and the
              # interpreter), held in whole programs and on the arrays
              # in test_torch_control_flow.py, test_torch_contrib_
              # decoder.py and test_torch_machine_translation.py
              "while", "conditional_block", "recurrent", "write_to_array",
              "read_from_array", "array_length", "array_to_lod_tensor",
              "lod_tensor_to_array", "max_sequence_len",
              # a SelectedRows grad, held with the sparse optimizer paths
              # in test_torch_sparse_embedding.py
              "lookup_table_sparse_grad"}


def _op(op_type, attrs, inputs):
    return types.SimpleNamespace(
        type=op_type, attrs=dict(attrs), uid=1,
        inputs={s: ["%s%d" % (s, i) for i in range(len(v))]
                for s, v in inputs.items()}, outputs={})


def _jax_cotangent(value, ct):
    if ct is not None:
        return jnp.asarray(ct)
    return np.zeros(np.shape(value), dtype=jax.dtypes.float0)


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_lowering_matches_jax_forward_and_vjp(case):
    name, op_type, specs, attrs = case
    rng = np.random.RandomState(sum(map(ord, name)))
    inputs = {s: [_make(sp, rng) for sp in v] for s, v in specs.items()}
    _assert_parity(op_type, attrs, inputs, rng)


def _assert_parity(op_type, attrs, inputs, rng):
    """The op's forward outputs and input gradients (seeded cotangents on
    every float output) agree between the two lowerings; NaN where the
    JAX lowering gives NaN."""
    op = _op(op_type, attrs, inputs)

    jctx = jreg.ExecContext(op, {s: [jnp.asarray(a) for a in v]
                                 for s, v in inputs.items()})
    jouts, jvjp = jreg.make_forward_and_vjp(op, jreg.get_op_def(op_type),
                                           jctx)
    tctx = treg.ExecContext(op, {s: [torch.from_numpy(a) for a in v]
                                 for s, v in inputs.items()}, device="cpu")
    touts, tvjp = treg.make_forward_and_vjp(op, treg.get_op_def(op_type),
                                           tctx)
    assert sorted(jouts) == sorted(touts)
    cts = {}
    for slot in jouts:
        cts[slot] = []
        for jv, tv in zip(jouts[slot], touts[slot]):
            jv = np.asarray(jv)
            assert tuple(tv.shape) == jv.shape, slot
            # the JAX package runs with x64 off: int64 comes back int32
            np.testing.assert_allclose(tv.numpy().astype(jv.dtype), jv,
                                       rtol=RTOL, atol=ATOL, err_msg=slot)
            cts[slot].append(np.asarray(rng.randn(*jv.shape), np.float32)
                             if tv.is_floating_point() else None)

    jgrads = jvjp({s: [_jax_cotangent(v, c) for v, c in zip(jouts[s], cs)]
                   for s, cs in cts.items()})
    tgrads = tvjp({s: [None if c is None else torch.from_numpy(c)
                       for c in cs] for s, cs in cts.items()})
    for slot, vals in inputs.items():
        for i, a in enumerate(vals):
            jg, tg = jgrads[slot][i], tgrads[slot][i]
            if a.dtype.kind != "f":
                assert tg is None, slot
                continue
            np.testing.assert_allclose(tg.numpy(), np.asarray(jg),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg="grad " + slot)


_CASE_BY_ID = {c[0]: c for c in _CASES}
BF16 = jnp.bfloat16
# one bf16 ulp, relative to each array's largest magnitude (both sides
# round once from fp32 values summed in other orders)
ULP = 2.0 ** -7


def _to_torch(a):
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.detach().view(torch.int16).numpy().view(BF16)
    return t.detach().numpy()


def _ulp_close(got, want, what):
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    g, w = got.astype(np.float64), want.astype(np.float64)
    scale = float(np.abs(w).max()) if w.size else 0.0
    np.testing.assert_allclose(g, w, rtol=ULP, atol=ULP * scale,
                               err_msg=what)


@pytest.mark.parametrize("case", sorted(_BF16_CASES))
def test_lowering_matches_jax_bf16(case):
    """The bf16 form of a case: its float inputs (or the listed slots) in
    bf16, the forward outputs and the input grads (bf16 cotangents on
    bf16 outputs) against the JAX lowering's, dtype for dtype, to one
    bf16 ulp."""
    name, op_type, specs, attrs = _CASE_BY_ID[case]
    rng = np.random.RandomState(sum(map(ord, name)))
    inputs = {s: [_make(sp, rng) for sp in v] for s, v in specs.items()}
    cast = _BF16_CASES[case]
    for slot, vals in inputs.items():
        if cast is None or slot in cast:
            inputs[slot] = [a.astype(BF16) if a.dtype.kind == "f" else a
                            for a in vals]
    op = _op(op_type, attrs, inputs)
    jouts, jvjp = jreg.make_forward_and_vjp(
        op, jreg.get_op_def(op_type), jreg.ExecContext(
            op, {s: [jnp.asarray(a) for a in v] for s, v in inputs.items()}))
    touts, tvjp = treg.make_forward_and_vjp(
        op, treg.get_op_def(op_type), treg.ExecContext(
            op, {s: [_to_torch(a) for a in v] for s, v in inputs.items()},
            device="cpu"))
    assert sorted(jouts) == sorted(touts)
    cts = {}
    for slot in jouts:
        cts[slot] = []
        for jv, tv in zip(jouts[slot], touts[slot]):
            jv = np.asarray(jv)
            got = _to_numpy(tv)
            if jv.dtype.kind in "iu":   # x64 off: int64 comes back int32
                got = got.astype(jv.dtype)
            _ulp_close(got, jv, slot)
            cts[slot].append(np.asarray(rng.randn(*jv.shape)).astype(
                jv.dtype) if jv.dtype.kind == "f" or jv.dtype == BF16
                else None)
    jgrads = jvjp({s: [_jax_cotangent(v, c) for v, c in zip(jouts[s], cs)]
                   for s, cs in cts.items()})
    tgrads = tvjp({s: [None if c is None else _to_torch(c) for c in cs]
                   for s, cs in cts.items()})
    for slot, vals in inputs.items():
        for i, a in enumerate(vals):
            if a.dtype.kind != "f" and a.dtype != BF16:
                assert tgrads[slot][i] is None, slot
                continue
            _ulp_close(_to_numpy(tgrads[slot][i]),
                       np.asarray(jgrads[slot][i]), "grad " + slot)


_SEQUENCE_CASES = sorted(c[0] for c in _CASES
                         if c[1] in ("lstm", "sequence_pool"))


@pytest.mark.cuda
@pytest.mark.parametrize("case", _SEQUENCE_CASES)
def test_cuda_sequence_lowerings_match_cpu(case):
    """lstm and sequence_pool on the card against the CPU, forward and
    vjp, fp32 at the fp32 tolerances (TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    name, op_type, specs, attrs = _CASE_BY_ID[case]
    rng = np.random.RandomState(sum(map(ord, name)))
    inputs = {s: [_make(sp, rng) for sp in v] for s, v in specs.items()}
    op = _op(op_type, attrs, inputs)
    res = {}
    for dev in ("cpu", "cuda"):
        outs, vjp = treg.make_forward_and_vjp(
            op, treg.get_op_def(op_type), treg.ExecContext(
                op, {s: [torch.from_numpy(a).to(dev) for a in v]
                     for s, v in inputs.items()}, device=dev))
        crng = np.random.RandomState(1)
        cts = {s: [torch.from_numpy(crng.randn(*v.shape).astype(
            np.float32)).to(dev) if v.is_floating_point() else None
            for v in vals] for s, vals in outs.items()}
        res[dev] = (outs, vjp(cts))
    for part in (0, 1):
        for slot, vals in res["cpu"][part].items():
            for a, b in zip(vals, res["cuda"][part][slot]):
                if a is None:
                    assert b is None, slot
                    continue
                np.testing.assert_allclose(b.cpu().numpy(), a.numpy(),
                                           rtol=RTOL, atol=ATOL,
                                           err_msg="%s %s" % (part, slot))


def _top_k_both(x, k, dtype, device):
    """top_k through both packages' lowerings on the same bits: x (fp32)
    rounded to `dtype` once, in numpy.  Returns (JAX values, JAX indices,
    the port's values, the port's indices), the values as fp32."""
    xj = jnp.asarray(x).astype(dtype)
    bits = np.asarray(xj).view(np.int16 if dtype == jnp.bfloat16
                                else np.int32)
    xt = torch.from_numpy(bits.copy()).view(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    op = _op("top_k", {"k": k}, {"X": [x]})
    jouts = jreg.get_op_def("top_k").lower(
        jreg.ExecContext(op, {"X": [xj]}))
    touts = treg.get_op_def("top_k").lower(
        treg.ExecContext(op, {"X": [xt.to(device)]}, device=device))
    return (np.asarray(jouts["Out"]).astype(np.float32),
            np.asarray(jouts["Indices"]),
            touts["Out"].float().cpu().numpy(),
            touts["Indices"].cpu().numpy())


def _assert_same_top_k(got, want, msg=""):
    """Indices equal; values equal with NaN where JAX has NaN, and zeros
    of JAX's sign (a NaN's payload is not compared)."""
    jv, ji, tv, ti = want + got
    np.testing.assert_array_equal(ti, ji, err_msg=msg)
    np.testing.assert_array_equal(tv, jv, err_msg=msg)
    np.testing.assert_array_equal(np.signbit(tv[~np.isnan(jv)]),
                                  np.signbit(jv[~np.isnan(jv)]), err_msg=msg)


def _top_k_input(kind):
    rng = np.random.RandomState(sum(map(ord, kind)))
    if kind == "softmax":   # the bf16 ResNet lanes' output: many ties
        return np.asarray(jax.nn.softmax(jnp.asarray(
            rng.randn(16, 1000).astype(np.float32) * 0.1)))
    return _make((kind, (8, 64)), rng)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["ties", "nans", "softmax"])
def test_top_k_orders_ties_and_nans_as_jax(kind, dtype):
    """jax.lax.top_k's indices and values, bit for bit, on equal values,
    NaNs and infinities of both signs, signed zeros, and a softmax over
    1000 classes, in fp32 and bf16."""
    jv, ji, tv, ti = _top_k_both(_top_k_input(kind), 5 if kind ==
                                 "softmax" else 40, getattr(jnp, dtype),
                                 "cpu")
    _assert_same_top_k((tv, ti), (jv, ji))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_top_k_orders_ties_and_nans_as_jax(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for kind in ("ties", "nans", "softmax"):
        jv, ji, tv, ti = _top_k_both(_top_k_input(kind), 5, getattr(
            jnp, dtype), "cuda")
        _assert_same_top_k((tv, ti), (jv, ji), kind)


# hard labels outside [0, C) at C = 4: in range, wrapped (-1 -> C - 1),
# the padding label C, past it, and below -C
_ODD_LABELS = np.array([[1], [-1], [4], [7], [-5]], np.int64)


@pytest.mark.parametrize("op_type,attrs", [
    ("softmax_with_cross_entropy", {"soft_label": False,
                                    "ignore_index": -100}),
    ("softmax_with_cross_entropy", {"soft_label": False, "ignore_index": 4}),
    ("cross_entropy", {"soft_label": False}),
], ids=["swce_no_ignore", "swce_ignore_C", "cross_entropy"])
def test_out_of_range_labels_match_jax(op_type, attrs):
    """`jnp.take_along_axis` semantics: a label in [-C, 0) wraps, any
    other out-of-range label gives a NaN loss and a zero gradient row,
    and ignore_index then zeroes its rows — on the CPU, with no raise."""
    rng = np.random.RandomState(11)
    x = rng.randn(5, 4).astype(np.float32) if op_type != "cross_entropy" \
        else rng.rand(5, 4).astype(np.float32) + 0.1
    slot = "Logits" if op_type != "cross_entropy" else "X"
    _assert_parity(op_type, attrs, {slot: [x], "Label": [_ODD_LABELS]},
                   rng)


def _ce_program(fluid, C):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[6])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        logits = fluid.layers.fc(x, size=C)
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            logits, label, ignore_index=C))
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, loss


def test_padding_labels_train_through_the_executor_as_in_jax():
    """Labels padded with ignore_index = C: the port's Executor gives the
    JAX package's loss and gradients from the same startup scope."""
    import paddle_tpu.fluid as jfluid
    import paddle_tpu_torch.fluid as tfluid
    C = 5
    jm, js, jloss = _ce_program(jfluid, C)
    tm, _, tloss = _ce_program(tfluid, C)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), \
        jfluid.executor.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(js)
    init = {n: np.asarray(jscope.get(n)) for n in jscope.keys()}
    tscope = tfluid.scope_from_jax(init, tfluid.Scope(), tfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    rng = np.random.RandomState(3)
    label = rng.randint(0, C, size=(8, 1))
    label[5:] = C
    feed = {"x": rng.randn(8, 6).astype(np.float32), "label": label}
    fetch = [jloss.name, "fc_0.w_0@GRAD", "fc_0.b_0@GRAD"]
    for _ in range(2):
        with jfluid.scope_guard(jscope):
            jr = [np.asarray(a) for a in jexe.run(jm, feed=feed,
                                                  fetch_list=fetch)]
        with tfluid.scope_guard(tscope):
            tr = [np.asarray(a) for a in texe.run(tm, feed=feed,
                                                  fetch_list=fetch)]
        assert np.isfinite(tr[0]).all()
        for name, j, t in zip(fetch, jr, tr):
            np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL,
                                       err_msg=name)


def test_every_registered_op_has_a_parity_case():
    """Each registered op has a case here, in a family file
    (tests/torch_op_cases.py: test_torch_ops_{math,tensor,nn}.py and
    test_torch_nets.py) or a parity test elsewhere."""
    cases = _CASES + torch_op_cases.CORE_CASES
    assert sorted(treg.registered_ops()) == sorted(
        {c[1] for c in cases} | _ELSEWHERE
        | set(torch_op_cases.RANDOM_OPS))


def _rng_op(op_type, attrs, inputs, seed=0, step=0, uid=3):
    op = _op(op_type, attrs, inputs)
    op.uid = uid
    ctx = treg.ExecContext(op, {s: [torch.from_numpy(a) for a in v]
                                for s, v in inputs.items()},
                           step=step, seed=seed, device="cpu")
    return treg.get_op_def(op_type).lower(ctx)


def test_uniform_random_matches_jax_shape_dtype_and_range():
    """The RNG streams differ (threefry vs torch's Philox/MT): the same
    shape, dtype and bounds, a uniform histogram, and determinism per
    (seed attr, program seed, op uid, step)."""
    attrs = {"shape": [64, 128], "dtype": FP32, "min": -0.5, "max": 0.25,
             "seed": 0}
    op = _op("uniform_random", attrs, {})
    jout = np.asarray(jreg.get_op_def("uniform_random").lower(
        jreg.ExecContext(op, {}))["Out"])
    out = _rng_op("uniform_random", attrs, {})["Out"]
    assert tuple(out.shape) == jout.shape and out.dtype == torch.float32
    assert float(out.min()) >= -0.5 and float(out.max()) < 0.25
    hist = np.histogram(out.numpy(), bins=8, range=(-0.5, 0.25))[0]
    assert hist.min() > 0.8 * hist.mean()
    again = _rng_op("uniform_random", attrs, {})["Out"]
    assert torch.equal(out, again)
    for kw in ({"seed": 1}, {"step": 1}, {"uid": 4}):
        assert not torch.equal(out, _rng_op("uniform_random", attrs, {},
                                            **kw)["Out"])
    assert not torch.equal(out, _rng_op("uniform_random",
                                        dict(attrs, seed=5), {})["Out"])


def test_gaussian_random_matches_jax_shape_dtype_and_moments():
    """conv2d's default filter init: the same shape, dtype, mean and std
    as the JAX lowering (other values), deterministic per seed and step."""
    attrs = {"shape": [64, 3, 8, 8], "dtype": FP32, "mean": 0.5, "std": 0.2,
             "seed": 0}
    op = _op("gaussian_random", attrs, {})
    jout = np.asarray(jreg.get_op_def("gaussian_random").lower(
        jreg.ExecContext(op, {}))["Out"])
    out = _rng_op("gaussian_random", attrs, {})["Out"]
    assert tuple(out.shape) == jout.shape and out.dtype == torch.float32
    for a in (out.numpy(), jout):
        assert abs(float(a.mean()) - 0.5) < 0.01
        assert abs(float(a.std()) - 0.2) < 0.01
    assert torch.equal(out, _rng_op("gaussian_random", attrs, {})["Out"])
    assert not torch.equal(out, _rng_op("gaussian_random", attrs, {},
                                        step=1)["Out"])


@pytest.mark.parametrize("imp", ["downgrade_in_infer", "upscale_in_train"])
def test_dropout_mask_statistics_and_output(imp):
    x = np.random.RandomState(0).randn(200, 100).astype(np.float32)
    attrs = {"dropout_prob": 0.3, "is_test": False, "seed": 0,
             "dropout_implementation": imp}
    outs = _rng_op("dropout", attrs, {"X": [x]})
    mask, out = outs["Mask"].numpy(), outs["Out"].numpy()
    assert set(np.unique(mask)) <= {0.0, 1.0}
    assert abs(mask.mean() - 0.7) < 0.01
    want = x * mask / (0.7 if imp == "upscale_in_train" else 1.0)
    np.testing.assert_allclose(out, want, rtol=1e-6)
    other = _rng_op("dropout", attrs, {"X": [x]}, step=1)["Mask"].numpy()
    assert not np.array_equal(mask, other)


def test_lookup_table_rejects_out_of_range_ids():
    """An id outside [-rows, rows) reads a NaN row, as the JAX lowering's
    jnp.take reads it (an id in [-rows, 0) wraps), decided on the device
    with no host sync, and passes no gradient to any row; the gather
    never reads out of bounds."""
    w = np.random.RandomState(0).randn(5, 2).astype(np.float32)
    ids = np.array([[1, 5, -1, -6, 4]], np.int64)
    op = _op("lookup_table", {"padding_idx": -1}, {"W": [0], "Ids": [0]})
    want = np.asarray(jreg.get_op_def("lookup_table").lower(
        jreg.ExecContext(op, {"W": [jnp.asarray(w)],
                              "Ids": [jnp.asarray(ids)]}))["Out"])
    wt = torch.from_numpy(w).requires_grad_()
    ctx = treg.ExecContext(op, {"W": [wt], "Ids": [torch.from_numpy(ids)]},
                           device="cpu")
    out = treg.get_op_def("lookup_table").lower(ctx)["Out"]
    np.testing.assert_array_equal(out.detach().numpy(), want)
    assert np.isnan(want[0, [1, 3]]).all() and \
        np.array_equal(want[0, 2], w[4])
    torch.nan_to_num(out).sum().backward()
    np.testing.assert_array_equal(wt.grad.numpy()[:, 0], [0, 1, 0, 0, 2])


def test_meta_shape_inference_runs_the_lowerings():
    op = _op("mul", {"x_num_col_dims": 2, "y_num_col_dims": 1},
             {"X": [0], "Y": [0]})
    ctx = treg.ExecContext(op, {"X": [torch.empty(97, 3, 4, device="meta")],
                                "Y": [torch.empty(4, 5, device="meta")]},
                           device="meta")
    out = treg.get_op_def("mul").lower(ctx)["Out"]
    assert out.device.type == "meta" and tuple(out.shape) == (97, 3, 5)
