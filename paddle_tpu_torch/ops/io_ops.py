"""In-graph checkpoint IO ops, after paddle_tpu/ops/io_ops.py (reference
operators/save_op.cc, load_op.cc, save_combine_op.cc,
load_combine_op.cc): save, load, save_combine and load_combine, run as
ordinary ops of a program.

They are host ops: a tensor on the card is copied to the host once for
each save, and a load reads on the host and copies its result to the
op's device.  The files are the JAX package's: numpy .npy for save/load
and .npz (keys are the var names with "/" written "__") for the combined
forms, so a file saved by either package loads in the other, and
through `numpy.load`.
"""

import os

import numpy as np
import torch

from .registry import register_op


def _no_shape(op, block):
    """Shape inference would read or write the files at build time."""


def _host(t):
    """A tensor's host numpy array (bf16 as an ml_dtypes array)."""
    from ..fluid.executor import as_numpy
    return as_numpy(t)


def _open_for_write(path, op_type, overwrite):
    if not overwrite and os.path.exists(path):
        raise RuntimeError("%s: %s exists and overwrite=False"
                           % (op_type, path))
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    return open(path, "wb")


def _to_device(arr, device):
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


@register_op("save", infer_shape=_no_shape)
def _save(ctx):
    x = _host(ctx.input("X"))
    with _open_for_write(ctx.attr("file_path"), "save",
                         ctx.attr("overwrite", True)) as f:
        np.save(f, x)
    return {}


@register_op("load", infer_shape=_no_shape)
def _load(ctx):
    with open(ctx.attr("file_path"), "rb") as f:
        arr = np.load(f)
    if ctx.attr("load_as_fp16", False):
        arr = arr.astype(np.float16)
    return {"Out": _to_device(arr, ctx.device)}


@register_op("save_combine", infer_shape=_no_shape)
def _save_combine(ctx):
    names = ctx.op.inputs.get("X", [])
    arrays = {n.replace("/", "__"): _host(v)
              for n, v in zip(names, ctx.inputs("X"))}
    with _open_for_write(ctx.attr("file_path"), "save_combine",
                         ctx.attr("overwrite", True)) as f:
        np.savez(f, **arrays)
    return {}


@register_op("load_combine", infer_shape=_no_shape)
def _load_combine(ctx):
    names = ctx.op.outputs.get("Out", [])
    with np.load(ctx.attr("file_path")) as z:
        return {"Out": [_to_device(z[n.replace("/", "__")], ctx.device)
                        for n in names]}
