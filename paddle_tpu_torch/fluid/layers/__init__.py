"""fluid.layers — the layer functions the port's models call, after
paddle_tpu/fluid/layers/."""

from . import (control_flow, io, learning_rate_scheduler, loss, nn, ops,
               sequence, tensor)
from .control_flow import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
from .learning_rate_scheduler import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .sequence import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
from . import math_op_patch
from .math_op_patch import monkey_patch_variable

monkey_patch_variable()

__all__ = (io.__all__ + nn.__all__ + tensor.__all__ + control_flow.__all__
           + ops.__all__ + sequence.__all__ + loss.__all__
           + learning_rate_scheduler.__all__)
