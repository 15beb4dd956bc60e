"""Places and dtype tables, after paddle_tpu/fluid/core.py.

A Place names a torch.device: `CUDAPlace(i)` is `cuda:i` and `CPUPlace()`
the CPU.  In a data-parallel rank (parallel/mesh.py) `CUDAPlace(i)` is the
rank's i-th selected card, as Fluid's `FLAGS_selected_gpus` makes it: the
launcher sets that variable, or parallel/mesh.py init_collective picks
the card from the rank when the process joins its world, so
`Executor(CUDAPlace(0))` in every rank lands on that rank's own card
while every card stays visible.  The VarType enum values are the JAX
package's (and the reference's framework.proto), so programs and
persistables carry across by name and dtype tag.
"""

import os

import numpy as np
import torch

__all__ = ["CPUPlace", "CUDAPlace", "VarDesc", "selected_gpus",
           "select_gpus", "convert_np_dtype_to_dtype_",
           "convert_dtype_to_np", "convert_dtype_to_torch",
           "convert_torch_dtype_to_dtype_"]


class Place:
    """Base device designator; `torch_device()` resolves it."""

    _type = None  # subclass override

    def __init__(self, device_id=0):
        self.device_id = int(device_id)

    def torch_device(self):
        if self._type == "cpu":
            return torch.device("cpu")
        sel = selected_gpus()
        if not sel:
            return torch.device(self._type, self.device_id)
        if self.device_id >= len(sel):
            raise ValueError("CUDAPlace(%d): this process has the selected "
                             "cards %s" % (self.device_id, sel))
        return torch.device(self._type, sel[self.device_id])

    def __eq__(self, other):
        return type(self) is type(other) and self.device_id == other.device_id

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (type(self).__name__, self.device_id)


_SELECTED = []


def selected_gpus():
    """The cards CUDAPlace(0), CUDAPlace(1), ... name in this process:
    `select_gpus`'s pick, else `FLAGS_selected_gpus` ("0,1"),
    else [] (CUDAPlace(i) is cuda:i)."""
    if _SELECTED:
        return list(_SELECTED)
    env = os.environ.get("FLAGS_selected_gpus", "").strip()
    return [int(i) for i in env.split(",")] if env else []


def select_gpus(cards):
    """Make CUDAPlace(i) name `cards[i]` in this process (a rank's card,
    chosen by parallel/mesh.py init_collective)."""
    _SELECTED[:] = [int(c) for c in cards]


class CPUPlace(Place):
    _type = "cpu"


class CUDAPlace(Place):
    _type = "cuda"


class VarDesc:
    """Mirror of framework.proto's VarType enum (dtype/var-kind tags)."""

    class VarType:
        # var kinds
        LOD_TENSOR = 7
        SELECTED_ROWS = 8
        FEED_MINIBATCH = 9
        FETCH_LIST = 10
        STEP_SCOPES = 11
        LOD_RANK_TABLE = 12
        LOD_TENSOR_ARRAY = 13
        READER = 15
        RAW = 17
        # dtypes
        BOOL = 0
        INT16 = 1
        INT32 = 2
        INT64 = 3
        FP16 = 4
        FP32 = 5
        FP64 = 6
        UINT8 = 20
        INT8 = 21
        BF16 = 22


_T = VarDesc.VarType

_DTYPE_TO_NP = {
    _T.BOOL: np.bool_, _T.INT16: np.int16, _T.INT32: np.int32,
    _T.INT64: np.int64, _T.FP16: np.float16, _T.FP32: np.float32,
    _T.FP64: np.float64, _T.UINT8: np.uint8, _T.INT8: np.int8,
}

_DTYPE_TO_TORCH = {
    _T.BOOL: torch.bool, _T.INT16: torch.int16, _T.INT32: torch.int32,
    _T.INT64: torch.int64, _T.FP16: torch.float16, _T.FP32: torch.float32,
    _T.FP64: torch.float64, _T.UINT8: torch.uint8, _T.INT8: torch.int8,
    _T.BF16: torch.bfloat16,
}
_TORCH_TO_DTYPE = {v: k for k, v in _DTYPE_TO_TORCH.items()}


def convert_np_dtype_to_dtype_(np_dtype):
    """numpy dtype / string / torch dtype -> VarType enum."""
    if isinstance(np_dtype, int):
        return np_dtype
    if isinstance(np_dtype, torch.dtype):
        return convert_torch_dtype_to_dtype_(np_dtype)
    if str(np_dtype) == "bfloat16":
        return _T.BF16
    dtype = np.dtype(np_dtype)
    for enum, nd in _DTYPE_TO_NP.items():
        if np.dtype(nd) == dtype:
            return enum
    raise ValueError("Not supported numpy dtype %s" % dtype)


def convert_dtype_to_np(dtype):
    """VarType enum / string -> numpy dtype (bf16 has none in numpy)."""
    enum = convert_np_dtype_to_dtype_(dtype)
    if enum == _T.BF16:
        raise ValueError("bfloat16 has no numpy dtype here; use "
                         "convert_dtype_to_torch")
    return np.dtype(_DTYPE_TO_NP[enum])


def convert_dtype_to_torch(dtype):
    """VarType enum / numpy dtype / string -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPE_TO_TORCH[convert_np_dtype_to_dtype_(dtype)]


def convert_torch_dtype_to_dtype_(dtype):
    """torch dtype -> VarType enum."""
    try:
        return _TORCH_TO_DTYPE[dtype]
    except KeyError:
        raise ValueError("Not supported torch dtype %s" % dtype) from None

