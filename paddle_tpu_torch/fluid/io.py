"""Model save/load, after paddle_tpu/fluid/io.py: save/load_vars, _params
and _persistables (one .npy per var with "/" -> "__", or one .npz when
`filename` is given), save/load_inference_model, and carrying a scope
across packages.

The inference artifact is the contract between the two packages: a JSON
`__model__` ({"program", "feed_names", "fetch_names"}, the program in
the JAX package's serialized form) beside the pruned program's
persistables as .npy files.  A directory saved by either package loads
in the other.  The JAX package also runs its static verifier on the
program at save and at load; the port has no analysis layer yet and
skips it.
"""

import json
import os

import numpy as np
import torch

from .. import resolve_device
from .executor import as_numpy, as_tensor, global_scope
from .framework import Parameter, Program, Variable, default_main_program

__all__ = [
    "save_vars", "save_params", "save_persistables", "load_vars",
    "load_params", "load_persistables", "save_inference_model",
    "load_inference_model", "scope_from_jax", "scope_to_jax",
]


def is_persistable(var):
    return bool(var.persistable)


def is_parameter(var):
    return isinstance(var, Parameter)


def _var_list(main_program, predicate):
    return [v for v in main_program.global_block().vars.values()
            if predicate(v)]


def _name(v):
    return v.name if isinstance(v, Variable) else v


def _var_file(dirname, name):
    return os.path.join(dirname, name.replace("/", "__") + ".npy")


def _host(value):
    return value.detach().cpu().numpy() if isinstance(value, torch.Tensor) \
        else np.asarray(value)


def _load_device(executor):
    return executor.device if executor is not None else resolve_device()


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """One .npy per var, or a single .npz named `filename`."""
    if main_program is None:
        main_program = default_main_program()
    if vars is None:
        vars = _var_list(main_program, predicate or is_persistable)
    scope = global_scope()
    os.makedirs(dirname, exist_ok=True)
    if filename is not None:
        arrays = {}
        for v in vars:
            val = scope.get(_name(v))
            if val is not None:
                arrays[_name(v)] = _host(val)
        # through a file handle, so np.savez cannot append '.npz'
        with open(os.path.join(dirname, filename), "wb") as f:
            np.savez(f, **arrays)
        return
    for v in vars:
        val = scope.get(_name(v))
        if val is not None:
            np.save(_var_file(dirname, _name(v)), _host(val))


def save_params(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program,
                     predicate=is_parameter, filename=filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program,
                     predicate=is_persistable, filename=filename)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """Into the global scope as torch tensors on the executor's device
    (the card when `executor` is None); a var with no file is skipped."""
    if main_program is None:
        main_program = default_main_program()
    if vars is None:
        vars = _var_list(main_program, predicate or is_persistable)
    scope = global_scope()
    device = _load_device(executor)
    if filename is not None:
        data = np.load(os.path.join(dirname, filename))
        for v in vars:
            if _name(v) in data:
                scope.set(_name(v), torch.from_numpy(
                    np.array(data[_name(v)])).to(device))
        return
    for v in vars:
        path = _var_file(dirname, _name(v))
        if os.path.exists(path):
            scope.set(_name(v), torch.from_numpy(np.load(path)).to(device))


def load_params(executor, dirname, main_program=None, filename=None):
    return load_vars(executor, dirname, main_program,
                     predicate=is_parameter, filename=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    return load_vars(executor, dirname, main_program,
                     predicate=is_persistable, filename=filename)


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None):
    """Prune the program to what computes `target_vars` from the feeds
    (test mode), write it as `__model__` and save the pruned program's
    persistables (parameters and batch-norm statistics).  Returns the
    fetch names."""
    if main_program is None:
        main_program = default_main_program()
    if isinstance(target_vars, Variable):
        target_vars = [target_vars]
    os.makedirs(dirname, exist_ok=True)
    fetch_names = [v.name for v in target_vars]
    pruned = main_program.clone(for_test=True)._prune(feeded_var_names,
                                                      fetch_names)
    meta = {
        "program": pruned.serialize_to_string(),
        "feed_names": list(feeded_var_names),
        "fetch_names": fetch_names,
    }
    with open(os.path.join(dirname, model_filename or "__model__"),
              "w") as f:
        json.dump(meta, f)
    save_persistables(executor, dirname, pruned, filename=params_filename)
    return fetch_names


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    """(program, feed names, fetch vars), the persistables loaded into
    the global scope on the executor's device.  A quantized artifact's
    int8 payloads and scale tables are CRC-checked against its
    quant_meta.bin before any weight loads."""
    with open(os.path.join(dirname, model_filename or "__model__")) as f:
        meta = json.load(f)
    program = Program.parse_from_string(meta["program"])
    from ..inference import quantize
    if quantize.is_quantized_dir(dirname):
        quantize.check_quantized_dir(dirname)
    vars = [v for v in program.global_block().vars.values()
            if isinstance(v, Parameter) or v.persistable]
    load_vars(executor, dirname, program, vars=vars,
              filename=params_filename)
    fetch_vars = [program.global_block().var(n)
                  for n in meta["fetch_names"]]
    return program, meta["feed_names"], fetch_vars


def scope_from_jax(np_dict, scope=None, place=None):
    """Load {name: numpy array} into `scope` (the global scope by default)
    as torch tensors on `place` (the card by default; `CPUPlace()` for the
    CPU).  Returns the scope.  Names are the contract: the port builds
    its programs with the JAX package's unique names."""
    scope = global_scope() if scope is None else scope
    dev = resolve_device(None if place is None else place.torch_device())
    for name, value in np_dict.items():
        scope.set(name, as_tensor(np.array(value)).to(dev))
    return scope


def scope_to_jax(scope=None):
    """{name: numpy array} of every tensor in `scope`, on the host."""
    scope = global_scope() if scope is None else scope
    return {name: as_numpy(scope.get(name))
            for name in scope.keys() if scope.get(name) is not None}
