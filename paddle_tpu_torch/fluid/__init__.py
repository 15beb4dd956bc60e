"""paddle_tpu_torch.fluid — the port's Fluid core, after paddle_tpu.fluid:
`fluid.layers` build a Program, `append_backward` differentiates it with
generic `<type>_grad` ops, an optimizer appends its update ops, and the
Executor runs the program eagerly, op by op, on a torch device.
`save_inference_model` writes an inference artifact that
`inference.create_paddle_predictor` serves.

    import paddle_tpu_torch.fluid as fluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ...layers..., fluid.optimizer.Adam(1e-3).minimize(loss)
    exe = fluid.Executor(fluid.CUDAPlace(0))     # or fluid.CPUPlace()
    exe.run(startup)
    exe.run(main, feed={...}, fetch_list=[loss])

With `FLAGS.whole_graph_ad` the Executor serves the backward section
with one `torch.autograd.grad` over the forward region
(`functionalizer.build_whole_graph_step_fn`), under `FLAGS.remat_policy`
if one is set.  `fluid.set_amp(True)` runs the following programs in
bf16 mixed precision (ops/registry.py's AMP lists), as the JAX
package's does.  Ragged sequences go in as `fluid.LoDTensor` feeds
(`fluid.create_lod_tensor`) of `layers.data(..., lod_level=1)` vars.
`fluid.ParallelExecutor` trains data-parallel over torch.distributed,
one process per card, computing the single-device step of the global
batch (fluid/parallel_executor.py; the collective-mode
`DistributeTranspiler` bootstraps the world).  `fluid.contrib.Trainer`
is the training entry point: events, checkpoints in the vault
(fluid/checkpoint.py), the anomaly sentinel (fluid/sentinel.py), and the
async pipeline of in-flight dispatch (`Executor.run(as_future=True)`,
fluid/pipeline.py) fed by the device prefetch queue
(`reader.prefetch_to_device`).
"""

from . import (backward, checkpoint, clip, core, data_feeder, executor,
               framework, functionalizer, initializer, io, ir_passes, layers,
               lod, nets, optimizer, parallel_executor, pipeline, regularizer,
               selected_rows, sentinel, transpiler, unique_name)
from .backward import append_backward, gradients
from .clip import (ErrorClipByValue, GradientClipByGlobalNorm,
                   GradientClipByNorm, GradientClipByValue,
                   set_gradient_clip)
from .selected_rows import SelectedRowsValue
from .core import CPUPlace, CUDAPlace
from .data_feeder import DataFeeder
from .lod import LoDTensor, create_lod_tensor, create_random_int_lodtensor
from .executor import (Executor, FetchFuture, Scope, StepWatchdogTimeout,
                       as_numpy, global_scope, scope_guard)
from .framework import (Operator, Parameter, Program, Variable,
                        default_main_program, default_startup_program,
                        name_scope, program_guard)
from .initializer import MSRA, Constant, Normal, Uniform, Xavier
from .pipeline import DispatchPipeline
from .io import (load_inference_model, load_params, load_persistables,
                 load_vars, load_checkpoint, save_checkpoint,
                 save_inference_model, save_params, save_persistables,
                 save_vars, scope_from_jax, scope_to_jax)
from .parallel_executor import (BuildStrategy, ExecutionStrategy,
                                ParallelExecutor)
from .layer_helper import LayerHelper
from .param_attr import ParamAttr
from .transpiler import (DistributeTranspiler, DistributeTranspilerConfig,
                         InferenceTranspiler)
from ..ops.registry import amp_enabled, set_amp
from .. import flags
from ..flags import FLAGS, get_flags, set_flags
from . import contrib  # noqa: E402  (the Trainer needs the whole package)
from .contrib import Inferencer, Trainer  # noqa: E402

__all__ = [
    "backward", "checkpoint", "clip", "contrib", "core", "data_feeder",
    "executor", "framework", "functionalizer", "initializer", "io",
    "ir_passes", "layers", "lod", "nets", "optimizer", "parallel_executor",
    "pipeline", "regularizer", "selected_rows", "sentinel", "transpiler",
    "unique_name", "ErrorClipByValue", "GradientClipByValue",
    "GradientClipByNorm", "GradientClipByGlobalNorm", "set_gradient_clip",
    "SelectedRowsValue",
    "FetchFuture", "StepWatchdogTimeout", "save_checkpoint",
    "load_checkpoint",
    "append_backward", "CPUPlace", "DataFeeder", "LoDTensor",
    "create_lod_tensor", "create_random_int_lodtensor",
    "CUDAPlace", "Executor", "Scope", "as_numpy", "global_scope",
    "scope_guard", "Operator", "Parameter", "Program", "Variable",
    "default_main_program", "default_startup_program", "program_guard",
    "scope_from_jax", "scope_to_jax", "ParamAttr", "save_vars",
    "save_params", "save_persistables", "load_vars", "load_params",
    "load_persistables", "save_inference_model", "load_inference_model",
    "InferenceTranspiler", "set_amp", "amp_enabled", "ParallelExecutor",
    "ExecutionStrategy", "BuildStrategy", "DistributeTranspiler",
    "DistributeTranspilerConfig", "LayerHelper", "gradients",
    "name_scope", "Constant", "Normal", "Uniform", "Xavier", "MSRA",
    "DispatchPipeline", "Trainer", "Inferencer", "flags", "FLAGS",
    "set_flags", "get_flags",
]
