"""Carrying persistables across packages: a scope of the JAX package, read
out as {persistable name: numpy array}, loads into the port's Scope, and
back.  Names are the contract (the port builds its programs with the JAX
package's unique names), so both packages start from the same state."""

import numpy as np
import torch

from .. import resolve_device
from .executor import global_scope

__all__ = ["scope_from_jax", "scope_to_jax"]


def scope_from_jax(np_dict, scope=None, place=None):
    """Load {name: numpy array} into `scope` (the global scope by default)
    as torch tensors on `place` (the card by default; `CPUPlace()` for the
    CPU).  Returns the scope."""
    scope = global_scope() if scope is None else scope
    dev = resolve_device(None if place is None else place.torch_device())
    for name, value in np_dict.items():
        scope.set(name, torch.from_numpy(np.array(value)).to(dev))
    return scope


def scope_to_jax(scope=None):
    """{name: numpy array} of every tensor in `scope`, on the host."""
    scope = global_scope() if scope is None else scope
    return {name: scope.get(name).detach().cpu().numpy()
            for name in scope.keys() if scope.get(name) is not None}
