"""Helpers shared by the port's parity tests of the optimizer update
region (clipping, LR schedules, sparse embeddings, optimizers): build a
program in both packages, carry the JAX startup scope across, run both
step by step and compare."""

import numpy as np

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid.executor import as_numpy


def build_both(fn, seed=5):
    """fn(pkg) under fresh Programs, program_guard and unique_name.guard
    in each package -> {"jax": (main, startup, out), "torch": (...)}."""
    built = {}
    for key, pkg in (("jax", jfluid), ("torch", tfluid)):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = seed
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            out = fn(pkg, main)
        built[key] = (main, startup, out)
    return built


def program_ops(program):
    """(type, inputs, outputs, attrs) of each op of the global block; the
    forward op's uid that a generic grad op carries is not compared."""
    return [(op.type, op.inputs, op.outputs,
             {k: v for k, v in op.attrs.items() if k != "fwd_uid"})
            for op in program.global_block().ops]


class Pair:
    """Both packages' executors and scopes, the torch one from the JAX
    startup scope."""

    def __init__(self, built):
        self.jmain, jstart, _ = built["jax"]
        self.tmain, _, _ = built["torch"]
        self.jexe = jfluid.Executor(jfluid.CPUPlace())
        self.jscope = jfluid.Scope()
        with jfluid.scope_guard(self.jscope):
            self.jexe.run(jstart)
        self.init = {n: np.asarray(self.jscope.get(n))
                     for n in self.jscope.keys()}
        self.tscope = tfluid.scope_from_jax(self.init, tfluid.Scope(),
                                            tfluid.CPUPlace())
        self.texe = tfluid.Executor(tfluid.CPUPlace())

    def step(self, feed, fetch):
        """One run of each main program -> (jax fetches, torch fetches),
        numpy arrays."""
        names = [f if isinstance(f, str) else f.name for f in fetch]
        with jfluid.scope_guard(self.jscope):
            jr = self.jexe.run(self.jmain, feed=feed, fetch_list=names)
        with tfluid.scope_guard(self.tscope):
            tr = self.texe.run(self.tmain, feed=feed, fetch_list=names)
        return [np.asarray(a) for a in jr], [np.asarray(b) for b in tr]

    def assert_state_close(self, rtol=1e-5, names=None):
        """Every float persistable of the JAX scope against the port's, to
        rtol of the array's largest magnitude."""
        for n in names or self.init:
            want = np.asarray(self.jscope.get(n))
            if want.dtype.kind != "f":
                continue
            assert_scaled_close(as_numpy(self.tscope.get(n)), want, rtol, n)


def assert_scaled_close(got, want, rtol, what=""):
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=rtol * scale, err_msg=str(what))
