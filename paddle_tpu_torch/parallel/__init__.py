"""Multi-device execution, after paddle_tpu/parallel/: so far the
data-parallel part of mesh.py (one process per card over
torch.distributed)."""

from . import mesh  # noqa: F401
