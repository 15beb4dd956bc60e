"""Inference engines of the port: the decode engine (decode.py), the
program Predictor over `save_inference_model` artifacts (predictor.py)
and post-training int8 quantization of those artifacts (quantize.py)."""

from .predictor import (AnalysisConfig, NativeConfig, PaddleTensor,
                        Predictor, create_paddle_predictor)
from .quantize import (QuantizedArtifactError, artifact_precision,
                       check_quantized_dir, is_quantized_dir,
                       quantize_inference_model, read_quant_meta,
                       verify_quantized_dir)

__all__ = [
    "NativeConfig", "AnalysisConfig", "PaddleTensor", "Predictor",
    "create_paddle_predictor", "quantize_inference_model",
    "read_quant_meta", "is_quantized_dir", "verify_quantized_dir",
    "check_quantized_dir", "artifact_precision", "QuantizedArtifactError",
]
