"""Model save/load, after paddle_tpu/fluid/io.py: save/load_vars, _params
and _persistables (one .npy per var with "/" -> "__", or one .npz when
`filename` is given), save/load_inference_model, save/load_checkpoint
over the checkpoint vault (fluid/checkpoint.py: its layout is the JAX
package's, so a checkpoint of either package loads in the other), and
carrying a scope across packages.

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
    "load_inference_model", "save_checkpoint", "load_checkpoint",
    "scope_from_jax", "scope_to_jax",
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


def _persistable_arrays(main_program, scope):
    if main_program is None:
        main_program = default_main_program()
    arrays = {}
    for v in _var_list(main_program, is_persistable):
        val = scope.get(v.name)
        if val is not None:
            arrays[v.name] = val
    return arrays


def save_checkpoint(executor, dirname, main_program=None, step=None,
                    epoch=None, epoch_step=None, max_num_checkpoints=None,
                    async_save=False):
    """Commit the program's persistables as `checkpoint_<step>/` under the
    vault root `dirname`, with the `latest` pointer and keep-N rotation
    (fluid/checkpoint.py).  `step` is the int global step or a legacy
    {"epoch", "step"} dict; `epoch`/`epoch_step` extend the meta.  With
    `async_save` the commit happens on the background saver
    (checkpoint.wait_for_async_saves joins).  Returns the meta written."""
    from . import checkpoint as ckpt
    meta = ckpt.normalize_meta(step)
    if epoch is not None:
        meta["epoch"] = int(epoch)
    if epoch_step is not None:
        meta["epoch_step"] = int(epoch_step)
    arrays = _persistable_arrays(main_program, global_scope())
    if async_save:
        ckpt.async_saver().submit(dirname, arrays, meta,
                                  max_num_checkpoints=max_num_checkpoints)
    else:
        ckpt.save_checkpoint_dir(dirname, arrays, meta,
                                 max_num_checkpoints=max_num_checkpoints)
    return meta


def load_checkpoint(executor, dirname, main_program=None):
    """Load the newest committed checkpoint under `dirname` (or `dirname`
    itself when it is one checkpoint_<n> dir, or a legacy flat
    `__checkpoint__.npz` layout) into the global scope on the executor's
    device, CRC-verifying every array.  Returns the {"epoch", "step",
    ...} meta.  Raises FileNotFoundError when nothing is there and
    CheckpointCorruptionError when an array fails verification."""
    from . import checkpoint as ckpt
    if main_program is None:
        main_program = default_main_program()
    if os.path.exists(os.path.join(dirname, ckpt.MANIFEST_NAME)):
        target = dirname
    else:
        target = ckpt.latest_checkpoint(dirname)
    if target is None:
        legacy = os.path.join(dirname, "__checkpoint__.npz")
        if not os.path.exists(legacy):
            raise FileNotFoundError(
                "no checkpoint under %s (no 'latest' pointer, no "
                "checkpoint_<step>/ dir, no legacy __checkpoint__.npz)"
                % dirname)
        load_persistables(executor, dirname, main_program,
                          filename="__checkpoint__.npz")
        meta_path = os.path.join(dirname, "__meta__.json")
        raw = None
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                raw = json.load(f).get("step")
        return ckpt.normalize_meta(raw)
    scope = global_scope()
    wanted = frozenset(
        v.name for v in _var_list(main_program, is_persistable))
    arrays, meta = ckpt.load_checkpoint_dir(target, names=wanted)
    device = _load_device(executor)
    for name, arr in arrays.items():
        scope.set(name, as_tensor(arr).to(device))
    return meta


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
