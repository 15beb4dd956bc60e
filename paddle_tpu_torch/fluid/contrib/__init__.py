"""fluid.contrib, after paddle_tpu/fluid/contrib (reference
python/paddle/fluid/contrib/): the high-level Trainer with its events
and CheckpointConfig, and the Inferencer that loads what
`Trainer.save_params` writes, and the decoder helpers (`decoder`:
InitState, StateCell, TrainingDecoder, BeamSearchDecoder).  The quantize
transpiler, the HDFS utilities and the op-frequency and memory-usage
tools are not ported (ROADMAP.md, queue 1)."""

from .trainer import (Trainer, CheckpointConfig, BeginEpochEvent,
                      EndEpochEvent, BeginStepEvent, EndStepEvent)
from .inferencer import Inferencer
from . import decoder
from .decoder import (InitState, StateCell, TrainingDecoder,
                      BeamSearchDecoder)

__all__ = ["Trainer", "CheckpointConfig", "BeginEpochEvent", "EndEpochEvent",
           "BeginStepEvent", "EndStepEvent", "Inferencer", "decoder",
           "InitState", "StateCell", "TrainingDecoder", "BeamSearchDecoder"]
