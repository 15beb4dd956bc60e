"""Quantized-inference op lowerings, after paddle_tpu/ops/quant_ops.py.

The PTQ pass (inference/quantize.py) rewrites an inference artifact's
`mul`, `conv2d` and `lookup_table` ops to the `dequant_*` ops here, the
weight vars become int8 and a per-output-channel fp32 scale var rides
beside each.

Numerics contract (the JAX package's): float activations round to the
artifact's activation dtype (bf16, round to nearest even, as `x.to(
torch.bfloat16)` does), the int8 weight dequantizes through that dtype
(exact: every int8 value is a bf16 value), products and sums are fp32,
the per-channel scale multiplies the fp32 accumulator, and the result
casts to the op's recorded output dtype.  `dequant_mul` runs K5
(`pallas_kernels.dequant_matmul`); `dequant_conv2d` is an fp32
convolution of the bf16-rounded operands — exact per product, since a
bf16 x bf16 product fits in fp32 — where a bf16 `conv2d` would return
bf16 and lose the fp32 accumulator.
"""

import math

import torch

from .nn_ops import (_from_nchw, _img_layout, _pads, _pair, _to_nchw,
                     conv2d_nchw)
from .pallas_kernels import dequant_matmul
from .registry import register_op

__all__ = ["QUANT_OP_TYPES", "quantized_op_for"]

# forward op type -> quantized op type (the PTQ pass's rewrite table)
QUANT_OP_TYPES = {
    "mul": "dequant_mul",
    "conv2d": "dequant_conv2d",
    "lookup_table": "dequant_lookup_table",
}


def quantized_op_for(op_type):
    """The quantized twin of a forward op type, or None."""
    return QUANT_OP_TYPES.get(op_type)


def _act(x, ctx):
    """A float activation in the artifact's activation dtype (bf16 unless
    the PTQ pass recorded another)."""
    act = getattr(torch, ctx.attr("act_dtype", "bfloat16"))
    if x.is_floating_point() and x.dtype != act:
        return x.to(act)
    return x


def _out_dtype(ctx, slot):
    """The recorded dtype of the op's output var: the graph downstream
    sees what it saw before quantization."""
    names = ctx.op.outputs.get(slot, [])
    if names:
        v = ctx.op.block._find_var_recursive(names[0])
        if v is not None and v.dtype is not None:
            return v.torch_dtype
    return torch.float32


@register_op("dequant_mul")
def _dequant_mul(ctx):
    """Quantized `mul`: X [.., K] float, Y [K, N] int8, Scale [N] fp32,
    with mul's flattening; the contraction is K5."""
    x, w = ctx.input("X"), ctx.input("Y")
    xd = ctx.attr("x_num_col_dims", 1)
    lead = math.prod(x.shape[:xd]) if xd > 0 else 1
    x2 = _act(x.reshape(lead, -1), ctx).contiguous()
    out = dequant_matmul(x2, w, ctx.input("Scale"),
                         out_dtype=_out_dtype(ctx, "Out"))
    return {"Out": out.reshape(tuple(x.shape[:xd]) + (w.shape[1],))}


@register_op("dequant_conv2d")
def _dequant_conv2d(ctx):
    """Quantized conv2d: Filter [O, I, kh, kw] int8, Scale [O] fp32 per
    output channel, applied to the fp32 accumulator (the scale
    distributes over the whole I x kh x kw reduction)."""
    x, w = ctx.input("Input"), ctx.input("Filter")
    layout = _img_layout(ctx)
    xq = _act(x, ctx)
    out = conv2d_nchw(
        _to_nchw(xq.float(), layout), w.to(xq.dtype).float(),
        _pair(ctx.attr("strides", [1, 1])),
        _pads(ctx),
        _pair(ctx.attr("dilations", [1, 1])),
        int(ctx.attr("groups", 1) or 1))
    out = _from_nchw(out, layout)
    sshape = (1, 1, 1, -1) if layout == "NHWC" else (1, -1, 1, 1)
    out = out * ctx.input("Scale").float().reshape(sshape)
    if ctx.has_input("Bias"):
        out = out + ctx.input("Bias").float().reshape(sshape)
    return {"Output": out.to(_out_dtype(ctx, "Output"))}


@register_op("dequant_lookup_table")
def _dequant_lookup_table(ctx):
    """Quantized embedding gather: W [V, D] int8, Scale [V] fp32 per row;
    only the gathered rows dequantize (bf16 row x fp32 scale -> fp32, as
    jnp promotes).  Ids outside [0, V) raise, as in lookup_table."""
    ids = ctx.input("Ids")
    w, scale = ctx.input("W"), ctx.input("Scale")
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    ids = ids.long()
    if ids.device.type != "meta" and ids.numel() and bool(
            ((ids < 0) | (ids >= w.shape[0])).any()):
        raise ValueError("dequant_lookup_table: ids outside [0, %d)"
                         % w.shape[0])
    rows = w[ids].to(torch.bfloat16) * scale.float()[ids][..., None]
    padding_idx = ctx.attr("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        rows = rows * (ids != padding_idx)[..., None].to(rows.dtype)
    return {"Out": rows.to(_out_dtype(ctx, "Out"))}
