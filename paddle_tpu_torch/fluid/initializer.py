"""Initializers emitted as startup-program ops, after
paddle_tpu/fluid/initializer.py: Constant (fill_constant), Uniform
(uniform_random), Normal (gaussian_random, conv2d's default),
TruncatedNormal (truncated_gaussian_random), Xavier (the default that
`fc` and `embedding` reach) and MSRA (uniform or normal), Bilinear and
NumpyArrayInitializer (assign_value).
The random ops draw from a torch.Generator seeded per op and step (see
ops/registry.py ExecContext.generator), so their values are not the JAX
package's: carry a startup scope across (fluid/io.py) for equal
weights."""

import numpy as np

__all__ = [
    "Constant", "Uniform", "Normal", "TruncatedNormal", "Xavier", "MSRA",
    "Bilinear", "NumpyArrayInitializer", "force_init_on_cpu",
    "init_on_cpu", "ConstantInitializer", "UniformInitializer",
    "NormalInitializer", "TruncatedNormalInitializer",
    "XavierInitializer", "MSRAInitializer", "BilinearInitializer",
]


def force_init_on_cpu():
    """False: a startup program runs on the Executor's device, as the
    JAX package's does."""
    return False


class init_on_cpu:
    """A context the reference uses to place initializers on the CPU;
    here it changes nothing (force_init_on_cpu)."""

    def __enter__(self):
        return self

    def __exit__(self, *args):
        return False


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
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


class TruncatedNormalInitializer(Initializer):
    """N(loc, scale) truncated at two standard deviations."""

    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self._mean, self._std, self._seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            type="truncated_gaussian_random", outputs={"Out": var},
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
    """Glorot: U(-limit, limit), limit = sqrt(6 / (fan_in + fan_out)), or
    with uniform=False N(0, sqrt(2 / (fan_in + fan_out)))."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self._uniform, self._seed = uniform, seed
        self._fan_in, self._fan_out = fan_in, fan_out

    def __call__(self, var, block):
        f_in, f_out = _fan_in_out(var)
        fan_in = f_in if self._fan_in is None else self._fan_in
        fan_out = f_out if self._fan_out is None else self._fan_out
        if self._uniform:
            limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
            return UniformInitializer(-limit, limit, self._seed)(var, block)
        std = float(np.sqrt(2.0 / (fan_in + fan_out)))
        return NormalInitializer(0.0, std, self._seed)(var, block)


class MSRAInitializer(Initializer):
    """He (Kaiming): U(-sqrt(6 / fan_in), sqrt(6 / fan_in)), or with
    uniform=False N(0, sqrt(2 / fan_in))."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self._uniform, self._seed, self._fan_in = uniform, seed, fan_in

    def __call__(self, var, block):
        f_in, _ = _fan_in_out(var)
        fan_in = f_in if self._fan_in is None else self._fan_in
        if self._uniform:
            limit = float(np.sqrt(6.0 / fan_in))
            return UniformInitializer(-limit, limit, self._seed)(var, block)
        std = float(np.sqrt(2.0 / fan_in))
        return NormalInitializer(0.0, std, self._seed)(var, block)


class BilinearInitializer(Initializer):
    """The bilinear upsampling kernel for a conv2d_transpose filter
    [C, C, k, k]: each channel's own k x k tent, zero across channels."""

    def __call__(self, var, block):
        shape = var.shape
        if len(shape) != 4:
            raise ValueError("bilinear init needs rank-4 var")
        weight = np.zeros(shape, dtype=np.float32)
        size = shape[3]
        factor = (size + 1) // 2
        center = factor - 1 if size % 2 == 1 else factor - 0.5
        og = np.ogrid[:size, :size]
        filt = (1 - abs(og[0] - center) / factor) * \
            (1 - abs(og[1] - center) / factor)
        weight[range(shape[0]), range(shape[1]), :, :] = filt
        return NumpyArrayInitializer(weight)(var, block)


class NumpyArrayInitializer(Initializer):
    """The given array's values, as fp32 (an assign_value op)."""

    def __init__(self, value):
        self._value = np.asarray(value)

    def __call__(self, var, block):
        v = self._value.astype(np.float32)
        return block.append_op(
            type="assign_value", outputs={"Out": var},
            attrs={"shape": list(v.shape), "dtype": var.dtype,
                   "fp32_values": [float(x) for x in v.flatten()]},
            infer_shape=False)


# fluid aliases
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
Bilinear = BilinearInitializer
