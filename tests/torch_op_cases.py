"""Op parity cases of paddle_tpu_torch's lowerings, shared by the CPU
parity tests (held against the JAX lowerings) and chip_smoke.py's
`phase_core_ops` (the card against the CPU).  Numpy and the port only:
no JAX, so the card's script can read them.

A case is (case id, op type, {slot: [input spec]}, attrs); `case_inputs`
makes its inputs from a RandomState seeded by the id."""

import types

import numpy as np

from paddle_tpu_torch.fluid.core import VarDesc

_T = VarDesc.VarType
FP32, INT64, INT32, INT16, INT8, UINT8 = (_T.FP32, _T.INT64, _T.INT32,
                                          _T.INT16, _T.INT8, _T.UINT8)


def _f(*shape):
    return ("f", shape)


def _i(high, *shape):
    return ("i", high, shape)


def _len(*lengths):
    """A ragged input's `<slot>@LOD_LEN` companion: int32 [B]."""
    return ("len", lengths)


def _arr(values, dtype=np.float32):
    """Fixed values (the edge cases a random draw would miss)."""
    return ("arr", np.asarray(values, dtype))


def make_input(spec, rng):
    kind = spec[0]
    if kind == "f":
        return rng.randn(*spec[1]).astype(np.float32)
    if kind == "i":
        return rng.randint(0, spec[1], size=spec[2]).astype(np.int64)
    if kind == "arr":
        return spec[1].copy()
    if kind == "pos":
        return rng.rand(*spec[1]).astype(np.float32) + 0.1
    if kind == "unit":   # inside (0, 1), for log_loss's probabilities
        return rng.rand(*spec[1]).astype(np.float32) * 0.8 + 0.1
    if kind == "len":
        return np.asarray(spec[1], np.int32)
    if kind == "bool":
        return rng.rand(*spec[1]) < 0.5
    if kind == "ties":   # few distinct values, zeros of both signs
        x = rng.randint(-2, 3, size=spec[1]).astype(np.float32)
        return np.where(x == 0, np.copysign(x, rng.randn(*spec[1])), x)
    if kind == "nans":   # NaNs and infinities of both signs, signed zeros
        x = rng.randn(*spec[1]).astype(np.float32)
        pick = rng.randint(0, 8, size=spec[1])
        sign = np.sign(rng.randn(*spec[1])).astype(np.float32)
        for code, val in ((0, np.nan), (1, np.inf), (2, 0.0)):
            x = np.where(pick == code, np.copysign(np.float32(val), sign), x)
        return x.astype(np.float32)
    return np.full(spec[1], {"lr": 1e-2, "b1p": 0.9 ** 3,
                             "b2p": 0.999 ** 3}[kind], np.float32)


def case_inputs(case):
    """(inputs {slot: [arrays]}, the RandomState after them) of a case."""
    name, _, specs, _ = case
    rng = np.random.RandomState(sum(map(ord, name)))
    return {s: [make_input(sp, rng) for sp in v]
            for s, v in specs.items()}, rng


def case_op(op_type, attrs, inputs):
    """A stand-in Operator for a lowering called outside a program."""
    return types.SimpleNamespace(
        type=op_type, attrs=dict(attrs), uid=1,
        inputs={s: ["%s%d" % (s, i) for i in range(len(v))]
                for s, v in inputs.items()}, outputs={})


def run_case(case, device):
    """The port's lowering of a case on `device` (a torch device name):
    its forward outputs and its input grads for cotangents drawn from
    RandomState(1) on every float output, as numpy arrays, each
    {slot: [array or None]}."""
    import torch
    from paddle_tpu_torch.ops import registry
    _, op_type, _, attrs = case
    inputs, _ = case_inputs(case)
    op = case_op(op_type, attrs, inputs)
    outs, vjp = registry.make_forward_and_vjp(
        op, registry.get_op_def(op_type), registry.ExecContext(
            op, {s: [torch.from_numpy(a).to(device) for a in v]
                 for s, v in inputs.items()}, device=device))
    crng = np.random.RandomState(1)
    cts = {s: [torch.from_numpy(np.asarray(crng.randn(*v.shape),
                                           np.float32)).to(device)
               if v.is_floating_point() else None for v in vals]
           for s, vals in outs.items()}
    grads = vjp(cts)

    def host(vals):
        return [None if v is None else v.detach().cpu().numpy()
                for v in vals]
    return ({s: host(v) for s, v in outs.items()},
            {s: host(v) for s, v in grads.items()})


def max_mismatch(got, want, rtol, atol):
    """The worst |got - want| - (atol + rtol |want|) over two run_case
    results (<= 0 where they agree; NaN only where both are NaN, integer
    and bool arrays exactly), and where it is."""
    worst, where = -np.inf, None
    for part, (g, w) in enumerate(zip(got, want)):
        for slot in w:
            for i, (a, b) in enumerate(zip(g[slot], w[slot])):
                if b is None:
                    if a is not None:
                        return np.inf, (part, slot, i)
                    continue
                if a.shape != b.shape or a.dtype != b.dtype:
                    return np.inf, (part, slot, i)
                if b.dtype.kind != "f":
                    bad = float(np.any(a != b)) or -np.inf
                else:
                    a64, b64 = a.astype(np.float64), b.astype(np.float64)
                    nan = np.isnan(b64)
                    inf = np.isinf(b64)
                    if np.any(np.isnan(a64) != nan) or np.any(
                            a64[inf] != b64[inf]):
                        return np.inf, (part, slot, i)
                    fin = ~nan & ~inf
                    diff = np.abs(a64[fin] - b64[fin]) - (
                        atol + rtol * np.abs(b64[fin]))
                    bad = float(diff.max()) if diff.size else -np.inf
                if bad > worst:
                    worst, where = bad, (part, slot, i)
    return worst, where


_NAN = float("nan")
# float values whose conversion to an integer type saturates or is NaN
_CAST_EDGES = [3e10, -3e10, _NAN, float("inf"), float("-inf"), 1e3, -1e3,
               200.7, -129.5, 255.9, -1.5, 7e4, 2.5e9, 0.5, -0.0]

# the repaired lowerings: JAX's out-of-range gather, saturating casts,
# and its gradients at ties, zeros and NaNs
REPAIR_CASES = [
    ("gather_out_of_range", "gather",
     {"X": [_f(5, 3)], "Index": [_arr([-1, 0, 5, 7, -5, -6], np.int64)]},
     {}),
    ("gather_out_of_range_column", "gather",
     {"X": [_f(4, 2, 3)], "Index": [_arr([[3], [-4], [4], [-9]],
                                         np.int64)]}, {}),
] + [
    ("cast_saturates_" + name, "cast", {"X": [_arr(_CAST_EDGES)]},
     {"in_dtype": FP32, "out_dtype": code})
    for name, code in (("int8", INT8), ("int16", INT16), ("int32", INT32),
                       ("uint8", UINT8))] + [
    ("abs_zeros_grad", "abs", {"X": [_arr([0.0, -0.0, 1.5, -2.0, _NAN])]},
     {}),
    ("clip_at_bounds_grad", "clip",
     {"X": [_arr([-0.5, 0.7, 0.0, 1.0, -1.0, _NAN])]},
     {"min": -0.5, "max": 0.7}),
    ("elementwise_max_nan_grad", "elementwise_max",
     {"X": [_arr([_NAN, 1.0, 2.0, 2.0, 3.0, _NAN])],
      "Y": [_arr([1.0, _NAN, 2.0, _NAN, 1.0, _NAN])]}, {"axis": -1}),
    ("elementwise_min_nan_grad", "elementwise_min",
     {"X": [_arr([_NAN, 1.0, 2.0, 2.0, 3.0, _NAN])],
      "Y": [_arr([1.0, _NAN, 2.0, _NAN, 1.0, _NAN])]}, {"axis": -1}),
    ("sign_nan_grad", "sign", {"X": [_arr([_NAN, 0.0, -0.0, 1.0, -3.0])]},
     {}),
]

# activations at their kinks: 0, the thresholds and the clip bounds
_KINKS = _arr([[-7.0, -6.0, -1.0, -0.5, -0.0, 0.0],
               [0.5, 1.0, 2.5, 6.0, 24.0, 30.0]])

MATH_CASES = [
    ("relu6", "relu6", {"X": [_f(3, 4)]}, {"threshold": 6.0}),
    ("relu6_kinks", "relu6", {"X": [_KINKS]}, {"threshold": 6.0}),
    ("leaky_relu", "leaky_relu", {"X": [_KINKS]}, {"alpha": 0.1}),
    ("elu", "elu", {"X": [_KINKS]}, {"alpha": 0.7}),
    ("softplus", "softplus", {"X": [_KINKS]}, {}),
    ("softsign", "softsign", {"X": [_KINKS]}, {}),
    ("swish", "swish", {"X": [_f(3, 4)]}, {"beta": 1.5}),
    ("brelu", "brelu", {"X": [_KINKS]}, {"t_min": 1.0, "t_max": 24.0}),
    ("hard_sigmoid", "hard_sigmoid", {"X": [_KINKS]},
     {"slope": 0.2, "offset": 0.5}),
    ("logsigmoid", "logsigmoid", {"X": [_KINKS]}, {}),
    ("soft_relu", "soft_relu", {"X": [_KINKS]}, {"threshold": 2.5}),
    ("stanh", "stanh", {"X": [_f(3, 4)]}, {"scale_a": 0.5, "scale_b": 1.5}),
    ("thresholded_relu", "thresholded_relu", {"X": [_KINKS]},
     {"threshold": 1.0}),
    ("softshrink", "softshrink", {"X": [_KINKS]}, {"lambda": 0.5}),
    ("hard_shrink", "hard_shrink", {"X": [_KINKS]}, {"threshold": 0.5}),
    ("tanh_shrink", "tanh_shrink", {"X": [_f(3, 4)]}, {}),
    ("reciprocal", "reciprocal", {"X": [("pos", (3, 4))]}, {}),
    ("rsqrt", "rsqrt", {"X": [("pos", (3, 4))]}, {}),
    ("round_half_even", "round",
     {"X": [_arr([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 0.49, 3.7])]}, {}),
    ("erf", "erf", {"X": [_f(3, 4)]}, {}),
    ("reduce_mean_dim", "reduce_mean", {"X": [_f(2, 3, 4)]},
     {"dim": [1, -1], "keep_dim": False, "reduce_all": False}),
    ("reduce_mean_all", "reduce_mean", {"X": [_f(2, 3, 4)]},
     {"dim": [0], "keep_dim": True, "reduce_all": True}),
    ("reduce_max_ties", "reduce_max", {"X": [("ties", (3, 4, 5))]},
     {"dim": [1], "keep_dim": True, "reduce_all": False}),
    ("reduce_max_all_ties", "reduce_max", {"X": [("ties", (3, 4))]},
     {"dim": [0], "keep_dim": False, "reduce_all": True}),
    ("reduce_min_ties", "reduce_min", {"X": [("ties", (3, 4, 5))]},
     {"dim": [0, 2], "keep_dim": False, "reduce_all": False}),
    ("reduce_prod", "reduce_prod", {"X": [_f(2, 3, 4)]},
     {"dim": [0, 2], "keep_dim": False, "reduce_all": False}),
    ("reduce_prod_zeros", "reduce_prod",
     {"X": [_arr([[0.0, 2.0, 3.0], [0.0, 0.0, 4.0], [1.5, -2.0, 0.5]])]},
     {"dim": [1], "keep_dim": True, "reduce_all": False}),
    ("reduce_all", "reduce_all", {"X": [("bool", (3, 4, 2))]},
     {"dim": [1], "keep_dim": False, "reduce_all": False}),
    ("reduce_any_all", "reduce_any", {"X": [("bool", (3, 4))]},
     {"dim": [0], "keep_dim": True, "reduce_all": True}),
    ("arg_max_ties_nans", "arg_max", {"X": [("nans", (6, 9))]},
     {"axis": -1}),
    ("arg_max_ties_axis0", "arg_max", {"X": [("ties", (5, 4, 3))]},
     {"axis": 0}),
    ("arg_min_ties_nans", "arg_min", {"X": [("nans", (6, 9))]},
     {"axis": 1}),
    ("arg_min_int", "arg_min", {"X": [_i(3, 4, 6)]}, {"axis": -1}),
    ("argsort_ties", "argsort", {"X": [("ties", (4, 9))]}, {"axis": -1}),
    ("argsort_axis0", "argsort", {"X": [_f(5, 3)]}, {"axis": 0}),
    ("argsort_nans", "argsort", {"X": [("nans", (3, 8))]}, {"axis": -1}),
    ("log_softmax", "log_softmax", {"X": [_f(3, 7)]}, {}),
    ("l2_normalize", "l2_normalize", {"X": [_f(3, 4, 2)]},
     {"axis": 1, "epsilon": 1e-10}),
    ("l2_normalize_eps", "l2_normalize",
     {"X": [_arr([[1e-7, -2e-7], [3.0, 4.0]])]},
     {"axis": -1, "epsilon": 1e-3}),
    ("isfinite", "isfinite", {"X": [_f(3, 4)]}, {}),
    ("isfinite_nans", "isfinite", {"X": [("nans", (3, 4))]}, {}),
    ("isinf", "isinf", {"X": [("nans", (3, 4))]}, {}),
    ("isnan", "isnan", {"X": [_f(3, 4)]}, {}),
    ("elementwise_floordiv", "elementwise_floordiv",
     {"X": [_arr([7.0, -7.0, 7.0, -7.5, 5.5, 0.0, 6.0])],
      "Y": [_arr([2.0, 2.0, -2.0, -2.0, 0.0, 3.0, 1.5])]}, {"axis": -1}),
    ("elementwise_floordiv_int", "elementwise_floordiv",
     {"X": [_arr([7, -7, 7, -8, 0], np.int64)],
      "Y": [_arr([2, 2, -2, -3, 5], np.int64)]}, {"axis": -1}),
    ("not_equal", "not_equal", {"X": [("ties", (3, 4))],
                                "Y": [("ties", (4,))]}, {"axis": -1}),
    ("logical_and", "logical_and", {"X": [("bool", (3, 4))],
                                    "Y": [("bool", (3, 4))]}, {}),
    ("logical_or", "logical_or", {"X": [("bool", (3, 4))],
                                  "Y": [("bool", (3, 4))]}, {}),
    ("logical_xor", "logical_xor", {"X": [("bool", (3, 4))],
                                    "Y": [("bool", (3, 4))]}, {}),
]

TENSOR_CASES = [
    ("split_num", "split", {"X": [_f(2, 6, 3)]},
     {"axis": 1, "num": 3, "sections": []}),
    ("split_sections", "split", {"X": [_f(5, 4)]},
     {"axis": 0, "num": 0, "sections": [2, 1, 2]}),
    ("reshape", "reshape", {"X": [_f(2, 3, 4)]}, {"shape": [4, -1]}),
    ("reshape_shape_input", "reshape",
     {"X": [_f(2, 3, 4)], "Shape": [_arr([4, 0, 2], np.int32)]},
     {"shape": [1]}),
    ("transpose", "transpose", {"X": [_f(2, 3, 4)]}, {"axis": [2, 0, 1]}),
    ("transpose2", "transpose2", {"X": [_f(2, 3, 4, 5)]},
     {"axis": [0, 2, 1, 3]}),
    ("shape", "shape", {"Input": [_f(2, 3, 4)]}, {}),
    ("tile", "tile", {"X": [_f(2, 3)]}, {"repeat_times": [2, 1, 3]}),
    ("tile_short", "tile", {"X": [_f(2, 3, 2)]}, {"repeat_times": [2, 2]}),
    ("flatten", "flatten", {"X": [_f(2, 3, 4)]}, {"axis": 2}),
    ("flatten2", "flatten2", {"X": [_f(2, 3, 4)]}, {"axis": 1}),
    ("flatten2_axis0", "flatten2", {"X": [_f(2, 3)]}, {"axis": 0}),
    ("expand_as", "expand_as",
     {"X": [_f(2, 1, 3)], "target_tensor": [_f(4, 5, 3)]}, {}),
    ("gather_nd", "gather_nd",
     {"X": [_f(4, 5, 3)], "Index": [_i(4, 6, 2)]}, {}),
    # a negative component wraps once, then every component clamps
    ("gather_nd_out_of_range", "gather_nd",
     {"X": [_f(5, 3)],
      "Index": [_arr([[0, 1], [-1, 2], [5, 0], [2, -4], [-6, 0], [1, 3]],
                     np.int64)]}, {}),
    ("gather_nd_prefix", "gather_nd",
     {"X": [_f(2, 3, 4)], "Index": [_arr([[1], [-1], [2], [-3]],
                                         np.int64)]}, {}),
    # unique ids (a duplicate's winner is undefined in both frameworks),
    # one wrapped, two dropped
    ("scatter_overwrite", "scatter",
     {"X": [_f(5, 3)], "Ids": [_arr([1, -1, 5, -6, 0], np.int64)],
      "Updates": [_f(5, 3)]}, {"overwrite": True}),
    ("scatter_add_duplicates", "scatter",
     {"X": [_f(5, 3)], "Ids": [_arr([[1], [3], [1], [-2], [9]], np.int64)],
      "Updates": [_f(5, 3)]}, {"overwrite": False}),
    ("strided_slice", "strided_slice", {"Input": [_f(6, 7, 3)]},
     {"axes": [0, 1], "starts": [1, -6], "ends": [6, 7],
      "strides": [2, 3]}),
    ("strided_slice_negative", "strided_slice", {"Input": [_f(6, 7)]},
     {"axes": [1, 0], "starts": [5, -1], "ends": [0, -7],
      "strides": [-2, -1]}),
    ("unstack", "unstack", {"X": [_f(2, 3, 4)]}, {"axis": 1, "num": 3}),
    ("reverse", "reverse", {"X": [_f(2, 3, 4)]}, {"axis": [0, 2]}),
    # 0-dim bounds: the JAX lowering takes float() of them
    ("range", "range",
     {"Start": [_arr(1, np.int64)], "End": [_arr(11, np.int64)],
      "Step": [_arr(3, np.int64)]}, {}),
    ("linspace", "linspace",
     {"Start": [_arr(-2, np.int64)], "Stop": [_arr(5, np.int64)],
      "Num": [_arr(9, np.int32)]}, {}),
    ("assign_value_fp32", "assign_value", {},
     {"dtype": FP32, "shape": [2, 3],
      "fp32_values": [0.5, -1.0, 2.25, 3.0, 0.0, -7.5]}),
    ("assign_value_int64", "assign_value", {},
     {"dtype": INT64, "shape": [3], "int64_values": [4, -2, 9]}),
]

NN_CASES = [
    ("one_hot_out_of_range", "one_hot",
     {"X": [_arr([[0], [3], [4], [-1], [7], [2]], np.int64)]},
     {"depth": 4}),
    ("one_hot", "one_hot", {"X": [_i(6, 2, 5)]}, {"depth": 6}),
    ("pad", "pad", {"X": [_f(2, 3, 4)]},
     {"paddings": [0, 1, 2, 0, 1, 1], "pad_value": 0.5}),
    ("pad2d_constant", "pad2d", {"X": [_f(2, 3, 4, 5)]},
     {"paddings": [1, 0, 2, 1], "mode": "constant", "pad_value": -1.0}),
    ("pad2d_reflect", "pad2d", {"X": [_f(2, 3, 4, 5)]},
     {"paddings": [2, 1, 0, 3], "mode": "reflect"}),
    ("pad2d_edge_nhwc", "pad2d", {"X": [_f(2, 4, 5, 3)]},
     {"paddings": [1, 2, 3, 0], "mode": "edge", "data_format": "NHWC"}),
    ("conv2d_transpose", "conv2d_transpose",
     {"Input": [_f(2, 4, 5, 5)], "Filter": [_f(4, 3, 3, 3)]},
     {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1],
      "groups": 1}),
    ("conv2d_transpose_groups_dilation", "conv2d_transpose",
     {"Input": [_f(2, 4, 4, 6)], "Filter": [_f(4, 3, 3, 2)]},
     {"strides": [1, 2], "paddings": [2, 0], "dilations": [2, 1],
      "groups": 2}),
    ("depthwise_conv2d", "depthwise_conv2d",
     {"Input": [_f(2, 4, 6, 6)], "Filter": [_f(4, 1, 3, 3)]},
     {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
      "groups": 4, "data_format": "NCHW"}),
    ("group_norm", "group_norm",
     {"X": [_f(2, 6, 3, 4)], "Scale": [_f(6)], "Bias": [_f(6)]},
     {"groups": 3, "epsilon": 1e-5}),
    ("group_norm_no_affine", "group_norm", {"X": [_f(3, 4, 5)]},
     {"groups": 2, "epsilon": 1e-3}),
    ("sigmoid_cross_entropy_with_logits", "sigmoid_cross_entropy_with_logits",
     {"X": [_f(4, 5)], "Label": [("unit", (4, 5))]},
     {"ignore_index": -100}),
    ("sigmoid_cross_entropy_ignore", "sigmoid_cross_entropy_with_logits",
     {"X": [_arr([[0.0, 1.5, -2.0], [3.0, 0.0, -0.5]])],
      "Label": [_arr([[1.0, 0.0, 2.0], [2.0, 1.0, 0.0]])]},
     {"ignore_index": 2}),
    ("smooth_l1_loss", "smooth_l1_loss",
     {"X": [_f(4, 3, 2)], "Y": [_f(4, 3, 2)],
      "InsideWeight": [("pos", (4, 3, 2))],
      "OutsideWeight": [("pos", (4, 3, 2))]}, {"sigma": 2.0}),
    ("smooth_l1_loss_plain", "smooth_l1_loss",
     {"X": [_f(5, 3)], "Y": [_f(5, 3)]}, {"sigma": 1.0}),
    ("huber_loss", "huber_loss", {"X": [_f(6, 1)], "Y": [_f(6, 1)]},
     {"delta": 0.8}),
    ("log_loss", "log_loss",
     {"Predicted": [("unit", (6, 1))], "Labels": [_i(2, 6, 1)]},
     {"epsilon": 1e-4}),
    ("log_loss_float_labels", "log_loss",
     {"Predicted": [("unit", (6, 1))], "Labels": [("unit", (6, 1))]},
     {"epsilon": 1e-4}),
    ("hinge_loss", "hinge_loss",
     {"Logits": [_arr([[0.5], [-2.0], [1.0], [0.0], [3.0]])],
      "Labels": [_arr([[1.0], [0.0], [1.0], [0.0], [0.0]])]}, {}),
    ("margin_rank_loss", "margin_rank_loss",
     {"X1": [_f(6, 1)], "X2": [_f(6, 1)],
      "Label": [_arr([[1.0], [-1.0], [1.0], [-1.0], [1.0], [-1.0]])]},
     {"margin": 0.1}),
    ("bilinear_interp_align_corners", "bilinear_interp",
     {"X": [_f(2, 3, 4, 5)]}, {"out_h": 7, "out_w": 3}),
    ("bilinear_interp_half_pixel", "bilinear_interp",
     {"X": [_f(2, 3, 4, 5)]},
     {"out_h": 8, "out_w": 9, "align_corners": False, "align_mode": 0}),
    ("bilinear_interp_mode1", "bilinear_interp", {"X": [_f(1, 2, 5, 4)]},
     {"out_h": 3, "out_w": 6, "align_corners": False, "align_mode": 1}),
    ("nearest_interp_align_corners", "nearest_interp",
     {"X": [_f(2, 3, 4, 5)]}, {"out_h": 7, "out_w": 3}),
    ("nearest_interp_half_pixel", "nearest_interp", {"X": [_f(2, 3, 4, 5)]},
     {"out_h": 8, "out_w": 10, "align_corners": False, "align_mode": 0}),
]

SEQUENCE_CASES = [
    ("sequence_conv_centred", "sequence_conv",
     {"X": [_f(3, 6, 4)], "Filter": [_f(12, 5)],
      "X@LOD_LEN": [_len(4, 6, 1)]},
     {"contextLength": 3, "contextStart": -1, "contextStride": 1}),
    ("sequence_conv_forward", "sequence_conv",
     {"X": [_f(2, 5, 3)], "Filter": [_f(12, 2)],
      "X@LOD_LEN": [_len(5, 2)]},
     {"contextLength": 4, "contextStart": -2, "contextStride": 1}),
    ("sequence_conv_start0_dense", "sequence_conv",
     {"X": [_f(2, 4, 3)], "Filter": [_f(6, 3)]},
     {"contextLength": 2, "contextStart": 0, "contextStride": 1}),
]

# the flat sequence ops and misc_ops' sequence ops, lod_reset and lrn:
# ragged inputs with lengths 0 and T, ids out of range, dense forms
SEQ_FLAT_CASES = [
    ("sequence_mask_maxlen", "sequence_mask",
     {"X": [_arr([3, 1, 6, 0], np.int64)]},
     {"maxlen": 6, "out_dtype": INT64}),
    ("sequence_mask_dynamic_fp32", "sequence_mask",
     {"X": [_arr([[2, 5], [3, 0]], np.int64)]},
     {"maxlen": -1, "out_dtype": FP32}),
    ("sequence_length", "sequence_length",
     {"X": [_f(3, 5, 2)], "X@LOD_LEN": [_len(2, 5, 0)]}, {}),
    ("sequence_length_dense", "sequence_length", {"X": [_f(2, 4)]}, {}),
    ("sequence_reverse", "sequence_reverse",
     {"X": [_f(3, 5, 2)], "X@LOD_LEN": [_len(2, 5, 1)]}, {}),
    ("sequence_reverse_ids_dense", "sequence_reverse",
     {"X": [_i(9, 2, 4, 1)]}, {}),
    ("sequence_concat", "sequence_concat",
     {"X": [_f(3, 4, 2), _f(3, 5, 2)],
      "X@LOD_LEN": [_len(2, 4, 0), _len(5, 1, 3)]}, {}),
    ("sequence_unpad", "sequence_unpad",
     {"X": [_f(3, 5, 2)], "Length": [_arr([[2], [5], [0]], np.int64)]},
     {}),
    ("sequence_enumerate", "sequence_enumerate",
     {"X": [_i(20, 3, 5, 1)], "X@LOD_LEN": [_len(5, 2, 3)]},
     {"win_size": 3, "pad_value": 0}),
    ("sequence_enumerate_2d_pad", "sequence_enumerate",
     {"X": [_i(20, 2, 4)], "X@LOD_LEN": [_len(4, 1)]},
     {"win_size": 2, "pad_value": 7}),
    ("sequence_slice", "sequence_slice",
     {"X": [_f(3, 6, 2)], "Offset": [_arr([[1], [0], [3]], np.int64)],
      "Length": [_arr([[3], [2], [2]], np.int64)],
      "X@LOD_LEN": [_len(5, 6, 5)]}, {}),
    ("sequence_erase", "sequence_erase",
     {"X": [_i(5, 3, 7, 1)], "X@LOD_LEN": [_len(7, 4, 6)]},
     {"tokens": [2, 0]}),
    ("sequence_erase_dense_repeats", "sequence_erase",
     {"X": [_arr([[3, 3, 1, 3, 2, 3], [1, 1, 1, 1, 1, 1],
                  [2, 2, 0, 4, 4, 2]], np.int64)]}, {"tokens": [3, 1]}),
    ("sequence_reshape_ragged", "sequence_reshape",
     {"X": [_f(3, 4, 6)], "X@LOD_LEN": [_len(4, 2, 0)]}, {"new_dim": 4}),
    ("sequence_reshape_dense", "sequence_reshape",
     {"X": [_f(2, 3, 4)]}, {"new_dim": 6}),
    ("sequence_reshape_same_width", "sequence_reshape",
     {"X": [_f(2, 3, 4)], "X@LOD_LEN": [_len(3, 1)]}, {"new_dim": 4}),
    # a negative id wraps once; one past the width and beyond are dropped
    ("sequence_scatter", "sequence_scatter",
     {"X": [_f(3, 6)],
      "Ids": [_arr([[0, 5, -1, 2], [6, 1, 1, -7], [3, 3, 9, 0]],
                   np.int64)],
      "Updates": [_f(3, 4)], "Ids@LOD_LEN": [_len(4, 2, 3)]}, {}),
    ("sequence_expand_as", "sequence_expand_as",
     {"X": [_f(3, 4)], "Y": [_f(3, 5, 2)], "Y@LOD_LEN": [_len(2, 5, 0)]},
     {}),
    ("sequence_expand_as_dense", "sequence_expand_as",
     {"X": [_f(2, 3)], "Y": [_f(2, 4)]}, {}),
    ("row_conv", "row_conv",
     {"X": [_f(3, 6, 4)], "Filter": [_f(3, 4)],
      "X@LOD_LEN": [_len(6, 2, 4)]}, {}),
    ("row_conv_dense", "row_conv", {"X": [_f(2, 5, 3)], "Filter": [_f(2, 3)]},
     {}),
    ("lod_reset_by_y", "lod_reset",
     {"X": [_f(3, 4, 2)], "Y": [_f(2, 5, 1)],
      "X@LOD_LEN": [_len(4, 1, 3)], "Y@LOD_LEN": [_len(5, 3)]}, {}),
    ("lod_reset_target_lod", "lod_reset",
     {"X": [_f(2, 3, 2)], "X@LOD_LEN": [_len(3, 2)]},
     {"target_lod": [0, 2, 5]}),
    ("lod_reset_flat_x", "lod_reset",
     {"X": [_f(6, 3)], "Y": [_f(2, 4, 1)], "Y@LOD_LEN": [_len(4, 2)]}, {}),
    ("lrn", "lrn", {"X": [_f(2, 6, 3, 3)]},
     {"n": 5, "k": 2.0, "alpha": 0.1, "beta": 0.75}),
    ("lrn_even_window", "lrn", {"X": [_f(2, 5, 2, 3)]},
     {"n": 4, "k": 1.0, "alpha": 0.2, "beta": 0.5}),
]

# the recurrent family: ragged and dense, is_reverse, peepholes on and
# off, initial states given and absent, lengths 0 and T
RECURRENT_CASES = [
    ("gru", "gru",
     {"Input": [_f(3, 5, 12)], "Weight": [_f(4, 12)], "Bias": [_f(1, 12)],
      "Input@LOD_LEN": [_len(5, 2, 3)]},
     {"is_reverse": False, "gate_activation": "sigmoid",
      "activation": "tanh"}),
    ("gru_reverse_h0", "gru",
     {"Input": [_f(3, 5, 12)], "Weight": [_f(4, 12)], "Bias": [_f(1, 12)],
      "H0": [_f(3, 4)], "Input@LOD_LEN": [_len(4, 5, 0)]},
     {"is_reverse": True}),
    ("gru_dense_no_bias", "gru",
     {"Input": [_f(2, 4, 6)], "Weight": [_f(2, 6)]}, {}),
    # the JAX lowering reads neither activation attr: always sigmoid, tanh
    ("gru_activation_attrs_ignored", "gru",
     {"Input": [_f(3, 5, 12)], "Weight": [_f(4, 12)], "Bias": [_f(1, 12)],
      "Input@LOD_LEN": [_len(5, 2, 3)]},
     {"gate_activation": "relu", "activation": "identity"}),
    ("gru_unit", "gru_unit",
     {"Input": [_f(3, 9)], "HiddenPrev": [_f(3, 3)], "Weight": [_f(3, 9)],
      "Bias": [_f(1, 9)]}, {"activation": "tanh",
                            "gate_activation": "sigmoid"}),
    ("gru_unit_relu_identity", "gru_unit",
     {"Input": [_f(2, 6)], "HiddenPrev": [_f(2, 2)], "Weight": [_f(2, 6)]},
     {"activation": "relu", "gate_activation": "identity"}),
    ("lstm_unit", "lstm_unit", {"X": [_f(3, 12)], "C_prev": [_f(3, 3)]},
     {"forget_bias": 0.0}),
    ("lstm_unit_forget_bias", "lstm_unit",
     {"X": [_f(2, 8)], "C_prev": [_f(2, 2)]}, {"forget_bias": 1.0}),
    ("lstmp_peepholes", "lstmp",
     {"Input": [_f(3, 5, 12)], "Weight": [_f(2, 12)],
      "ProjWeight": [_f(3, 2)], "Bias": [_f(1, 21)],
      "Input@LOD_LEN": [_len(5, 1, 3)]},
     {"use_peepholes": True, "is_reverse": False,
      "proj_activation": "tanh"}),
    ("lstmp_reverse_h0_c0", "lstmp",
     {"Input": [_f(3, 5, 12)], "Weight": [_f(2, 12)],
      "ProjWeight": [_f(3, 2)], "Bias": [_f(1, 12)], "H0": [_f(3, 2)],
      "C0": [_f(3, 3)], "Input@LOD_LEN": [_len(3, 5, 0)]},
     {"use_peepholes": False, "is_reverse": True,
      "proj_activation": "identity"}),
    ("lstmp_sigmoid_dense", "lstmp",
     {"Input": [_f(2, 4, 8)], "Weight": [_f(3, 8)],
      "ProjWeight": [_f(2, 3)], "Bias": [_f(1, 14)]},
     {"use_peepholes": True, "proj_activation": "sigmoid"}),
    ("simple_rnn", "simple_rnn",
     {"Input": [_f(3, 5, 4)], "Weight": [_f(4, 4)], "Bias": [_f(1, 4)],
      "Input@LOD_LEN": [_len(5, 3, 1)]}, {"activation": "tanh"}),
    ("simple_rnn_relu_reverse", "simple_rnn",
     {"Input": [_f(3, 5, 4)], "Weight": [_f(4, 4)],
      "Input@LOD_LEN": [_len(2, 5, 0)]},
     {"activation": "relu", "is_reverse": True}),
    ("simple_rnn_softsign_dense", "simple_rnn",
     {"Input": [_f(2, 4, 3)], "Weight": [_f(3, 3)]},
     {"activation": "softsign"}),
    ("attention_lstm", "attention_lstm",
     {"X": [_f(3, 5, 4)], "C0": [_f(3, 3)], "AttentionWeight": [_f(7, 1)],
      "AttentionBias": [_f(1, 1)], "AttentionScalar": [_f(1, 1)],
      "AttentionScalarBias": [_f(1, 1)], "LSTMWeight": [_f(7, 12)],
      "LSTMBias": [_f(1, 12)], "X@LOD_LEN": [_len(5, 2, 3)]}, {}),
    ("attention_lstm_h0_plain", "attention_lstm",
     {"X": [_f(3, 4, 2)], "C0": [_f(3, 2)], "H0": [_f(3, 2)],
      "AttentionWeight": [_f(4, 1)], "LSTMWeight": [_f(4, 8)],
      "LSTMBias": [_f(1, 8)], "X@LOD_LEN": [_len(4, 0, 2)]}, {}),
]

# the fused recurrent ops
FUSED_CASES = [
    ("fusion_lstm", "fusion_lstm",
     {"X": [_f(3, 5, 4)], "WeightX": [_f(4, 12)], "WeightH": [_f(3, 12)],
      "Bias": [_f(1, 21)], "X@LOD_LEN": [_len(5, 2, 4)]},
     {"use_peepholes": True, "is_reverse": False}),
    ("fusion_lstm_bias_x_reverse", "fusion_lstm",
     {"X": [_f(3, 5, 4)], "WeightX": [_f(4, 12)], "WeightH": [_f(3, 12)],
      "Bias": [_f(1, 12)], "BiasX": [_f(1, 12)], "H0": [_f(3, 3)],
      "C0": [_f(3, 3)], "X@LOD_LEN": [_len(1, 5, 3)]},
     {"use_peepholes": False, "is_reverse": True}),
    ("fusion_gru", "fusion_gru",
     {"X": [_f(3, 5, 4)], "WeightX": [_f(4, 9)], "WeightH": [_f(3, 9)],
      "Bias": [_f(1, 9)], "X@LOD_LEN": [_len(5, 2, 4)]},
     {"is_reverse": False}),
    ("fusion_gru_reverse_h0", "fusion_gru",
     {"X": [_f(2, 4, 3)], "WeightX": [_f(3, 6)], "WeightH": [_f(2, 6)],
      "H0": [_f(2, 2)], "X@LOD_LEN": [_len(4, 2)]}, {"is_reverse": True}),
    ("fusion_seqconv_eltadd_relu", "fusion_seqconv_eltadd_relu",
     {"X": [_f(3, 6, 4)], "Filter": [_f(12, 5)], "Bias": [_f(1, 5)],
      "X@LOD_LEN": [_len(6, 3, 1)]},
     {"contextLength": 3, "contextStart": -1, "contextStride": 1}),
    ("fusion_seqexpand_concat_fc", "fusion_seqexpand_concat_fc",
     {"X": [_f(3, 5, 4), _f(3, 2), _f(3, 3)], "FCWeight": [_f(9, 6)],
      "FCBias": [_f(1, 6)], "X@LOD_LEN": [_len(5, 2, 3)]},
     {"fc_activation": "tanh"}),
    ("fusion_seqexpand_concat_fc_relu", "fusion_seqexpand_concat_fc",
     {"X": [_f(2, 4, 3), _f(2, 2)], "FCWeight": [_f(5, 4)],
      "X@LOD_LEN": [_len(4, 1)]}, {"fc_activation": "relu"}),
    # ids below 0 and past the table clip into it
    ("fused_embedding_fc_lstm", "fused_embedding_fc_lstm",
     {"Ids": [_arr([[[0], [6], [-1], [7], [3]], [[9], [2], [2], [1], [0]],
                    [[5], [4], [-3], [0], [0]]], np.int64)],
      "Embeddings": [_f(7, 12)], "WeightH": [_f(3, 12)],
      "Bias": [_f(1, 21)], "Ids@LOD_LEN": [_len(5, 3, 2)]},
     {"use_peepholes": True, "is_reverse": False}),
    ("fused_embedding_fc_lstm_reverse", "fused_embedding_fc_lstm",
     {"Ids": [_i(7, 2, 4, 1)], "Embeddings": [_f(7, 8)],
      "WeightH": [_f(2, 8)], "Bias": [_f(1, 8)], "H0": [_f(2, 2)],
      "Ids@LOD_LEN": [_len(4, 2)]},
     {"use_peepholes": False, "is_reverse": True}),
]

# every case of the sequence and recurrent families
SEQ_OP_CASES = SEQ_FLAT_CASES + RECURRENT_CASES + FUSED_CASES

# the random ops of these families, held on shape, dtype, range and
# moments
RANDOM_OPS = ("randint", "truncated_gaussian_random",
              "uniform_random_batch_size_like")

# every case above: chip_smoke.py's phase_core_ops runs those of the
# families before SEQ_OP_CASES, its phase_seq_ops those
CORE_CASES = (REPAIR_CASES + MATH_CASES + TENSOR_CASES + NN_CASES
              + SEQUENCE_CASES + SEQ_OP_CASES)
