"""Program-to-program rewrites, after paddle_tpu/fluid/transpiler/: the
InferenceTranspiler that the Predictor runs, and the
DistributeTranspiler in collective mode (its pserver mode and the memory
transpiler are not ported)."""

from .distribute_transpiler import (DistributeTranspiler,
                                    DistributeTranspilerConfig)
from .inference_transpiler import InferenceTranspiler

__all__ = ["InferenceTranspiler", "DistributeTranspiler",
           "DistributeTranspilerConfig"]
