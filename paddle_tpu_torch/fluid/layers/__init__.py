"""fluid.layers — the layer functions the port's training slice calls,
after paddle_tpu/fluid/layers/."""

from . import io, nn, tensor
from .io import data
from .nn import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403

__all__ = ["data"] + nn.__all__ + tensor.__all__
