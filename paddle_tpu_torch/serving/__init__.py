"""Serving layer of the port, after paddle_tpu/serving: the batchers
(batcher.py), per-model metrics (metrics.py), the versioned model
registry (model_registry.py) and the wire server and client
(server.py)."""

from .batcher import (BatcherClosed, DeadlineExceeded, DecodeBatcher,
                      DecodeStream, DynamicBatcher, ServerOverloaded,
                      set_dispatch_delay, set_draft_delay, set_host_delay)
from .metrics import ModelMetrics, ServingMetrics
from .model_registry import (ModelEntry, ModelRegistry, open_predictor,
                             resolve_placement)
from .server import (InferenceServer, ServingClient, ServingError,
                     StreamBroken)

__all__ = ["DynamicBatcher", "DecodeBatcher", "DecodeStream",
           "ServerOverloaded", "DeadlineExceeded", "BatcherClosed",
           "set_dispatch_delay", "set_draft_delay", "set_host_delay",
           "ModelMetrics", "ServingMetrics", "ModelRegistry",
           "ModelEntry", "open_predictor", "resolve_placement",
           "InferenceServer", "ServingClient", "ServingError",
           "StreamBroken"]
