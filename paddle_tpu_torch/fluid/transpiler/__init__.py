"""Program-to-program rewrites, after paddle_tpu/fluid/transpiler/: so far
the InferenceTranspiler that the Predictor runs (the distributed and
memory transpilers are not ported)."""

from .inference_transpiler import InferenceTranspiler

__all__ = ["InferenceTranspiler"]
