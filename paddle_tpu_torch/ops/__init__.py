"""The port's op layer: the registry (registry.py), the op lowerings on
torch tensors (tensor_ops, math_ops, nn_ops, optimizer_ops, quant_ops,
sequence_ops, misc_ops, distributed_ops, control_flow_ops, compat_ops,
beam_ops, named after their paddle_tpu
counterparts), and the kernels — each TPU kernel of
paddle_tpu/ops/pallas_kernels.py on the port's path becomes a
hand-written CUDA kernel (csrc/, built by _build.py) with a plain PyTorch
version beside it (pallas_kernels.py)."""

from . import registry  # noqa: F401
from . import tensor_ops, math_ops, nn_ops, optimizer_ops  # noqa: F401
from . import pallas_kernels  # noqa: F401
from . import quant_ops  # noqa: F401
from . import sequence_ops, misc_ops  # noqa: F401
from . import distributed_ops  # noqa: F401
from . import control_flow_ops, compat_ops, beam_ops  # noqa: F401
from .registry import get_op_def, has_op, registered_ops  # noqa: F401
