"""Initializers emitted as startup-program ops, after
paddle_tpu/fluid/initializer.py: Constant (fill_constant), Uniform
(uniform_random), Normal (gaussian_random, conv2d's default) and the
Xavier default that `fc` and `embedding` reach.
The random ops draw from a torch.Generator seeded per op and step (see
ops/registry.py ExecContext.generator), so their values are not the JAX
package's: carry a startup scope across (fluid/io.py) for equal
weights."""

import numpy as np

__all__ = ["Constant", "Uniform", "Normal", "Xavier", "ConstantInitializer",
           "UniformInitializer", "NormalInitializer", "XavierInitializer"]


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0):
        self._value = value

    def __call__(self, var, block):
        return block.append_op(
            type="fill_constant", outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "value": float(self._value)},
            infer_shape=False)


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self._low, self._high, self._seed = low, high, seed

    def __call__(self, var, block):
        return block.append_op(
            type="uniform_random", outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "min": self._low, "max": self._high, "seed": self._seed},
            infer_shape=False)


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self._mean, self._std, self._seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            type="gaussian_random", outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "mean": self._mean, "std": self._std, "seed": self._seed},
            infer_shape=False)


def _fan_in_out(var):
    shape = var.shape
    if not shape:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class XavierInitializer(Initializer):
    """Glorot, uniform form: U(-limit, limit), limit = sqrt(6 / (fan_in +
    fan_out)) (the Gaussian form needs gaussian_random, not ported)."""

    def __call__(self, var, block):
        fan_in, fan_out = _fan_in_out(var)
        limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
        return UniformInitializer(-limit, limit)(var, block)


# fluid aliases
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
