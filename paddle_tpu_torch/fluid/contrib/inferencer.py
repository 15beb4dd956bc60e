"""High-level Inferencer, after paddle_tpu/fluid/contrib/inferencer.py
(reference contrib/inferencer.py:31), the companion of contrib.Trainer:
it rebuilds the inference topology from the user's infer_func, loads
the parameters that `Trainer.save_params` wrote, and serves
`infer(feed_dict)`.  `place=None` means the card."""

import numpy as np

from .. import core
from .. import executor
from .. import framework
from .. import io as fluid_io
from .. import unique_name

__all__ = ["Inferencer"]


class Inferencer(object):
    def __init__(self, infer_func, param_path, place=None,
                 parallel=False):
        self.param_path = param_path
        self.scope = executor.Scope()
        self.inference_program = framework.Program()
        startup = framework.Program()
        with framework.program_guard(self.inference_program, startup):
            # a fresh name stream (reference inferencer.py:63): the same
            # topology regenerates the trained parameters' names
            with unique_name.guard():
                self.predict_var = infer_func()
        with executor.scope_guard(self.scope):
            self.exe = executor.Executor(place or core.CUDAPlace(0))
            self.exe.run(startup)
            fluid_io.load_params(self.exe, param_path,
                                 main_program=self.inference_program)
        self.inference_program = self.inference_program.clone(
            for_test=True)

    def infer(self, inputs, return_numpy=True):
        """inputs: {feed_name: ndarray} (reference inferencer.py infer)."""
        if not isinstance(inputs, dict):
            raise ValueError(
                "inputs should be a map of {'input_name': input_var}")
        with executor.scope_guard(self.scope):
            results = self.exe.run(self.inference_program, feed=inputs,
                                   fetch_list=[self.predict_var],
                                   return_numpy=return_numpy)
        return [np.asarray(r) for r in results] if return_numpy \
            else results
