"""Scope and Executor, after paddle_tpu/fluid/executor.py.

The JAX Executor traces a whole block into one jitted step
(functionalizer.build_step_fn).  The port's Executor interprets the block
eagerly, op by op, in program order (functionalizer._interpret_ops):
  * a forward op whose `<type>_grad` appears later in the block runs
    under autograd and stashes its vjp closure (ops/registry.py
    make_forward_and_vjp); the grad op consumes and drops it;
  * every other op runs its lowering under `torch.no_grad()`.
Persistables (params, optimizer state, the learning rate) live in the
Scope as torch tensors on the Executor's device and are written back
after each run.

bfloat16 crosses the host boundary as `ml_dtypes.bfloat16` numpy arrays,
as in the JAX package: a feed may be one (or a torch bf16 tensor), and a
bf16 fetch comes back as one.
"""

import threading

import numpy as np
import torch

from .. import resolve_device
from ..ops import registry
from . import core
from .framework import Variable, default_main_program

try:
    from ml_dtypes import bfloat16 as _NP_BF16
except ImportError:  # pragma: no cover
    _NP_BF16 = None

__all__ = ["Executor", "Scope", "global_scope", "scope_guard", "as_numpy",
           "as_tensor"]

class Scope:
    """name -> torch tensor map."""

    def __init__(self):
        self._vars = {}

    def get(self, name):
        return self._vars.get(name)

    def set(self, name, value):
        self._vars[name] = value

    def keys(self):
        return self._vars.keys()


_global_scope = Scope()


class _ScopeStack(threading.local):
    """Per-thread scope stack rooted at the process-wide global scope."""

    def __init__(self):
        self.stack = [_global_scope]


_scope_stack_tls = _ScopeStack()


def global_scope():
    return _scope_stack_tls.stack[-1]


class scope_guard:
    def __init__(self, scope):
        self._scope = scope

    def __enter__(self):
        _scope_stack_tls.stack.append(self._scope)
        return self._scope

    def __exit__(self, *args):
        _scope_stack_tls.stack.pop()


def as_numpy(tensor):
    """Host numpy array(s) of a tensor (or a list of them); bf16 comes
    back as an `ml_dtypes.bfloat16` array (numpy has no bfloat16)."""
    if isinstance(tensor, (list, tuple)):
        return [as_numpy(t) for t in tensor]
    t = tensor.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    if _NP_BF16 is None:
        raise TypeError("as_numpy: a bfloat16 tensor needs the ml_dtypes "
                        "package (numpy has no bfloat16)")
    return t.view(torch.int16).numpy().view(_NP_BF16)


def as_tensor(value):
    """A CPU torch tensor of an array-like; an `ml_dtypes.bfloat16` array
    becomes a torch bf16 tensor bit for bit."""
    arr = np.asarray(value)
    if _NP_BF16 is not None and arr.dtype == _NP_BF16:
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.as_tensor(arr)


def _fetch_name(f):
    if isinstance(f, Variable):
        return f.name
    if isinstance(f, str):
        return f
    raise TypeError("bad fetch entry: %r" % (f,))


def persistable_names(program):
    return [v.name for blk in program.blocks for v in blk.vars.values()
            if v.persistable]


def _is_generic_grad(op):
    return (op.type.endswith("_grad") and "fwd_uid" in op.attrs
            and not registry.has_op(op.type))


def _gather_inputs(op, env):
    return {slot: [env.get(n) if n else None for n in names]
            for slot, names in op.inputs.items()}


def _write_outputs(op, outs, env):
    for slot, vals in outs.items():
        if not isinstance(vals, (list, tuple)):
            vals = [vals]
        for name, val in zip(op.outputs.get(slot, []), vals):
            if name and val is not None:
                env[name] = val


def _run_grad_op(op, env, vjp_cache):
    fwd_uid = op.attrs["fwd_uid"]
    entry = vjp_cache.pop(fwd_uid, None)
    if entry is None:
        raise RuntimeError(
            "%s: the forward op (uid %d) did not run in this block before "
            "its grad op" % (op.type, fwd_uid))
    vjp_fn, outs = entry
    cotangents = {}
    for slot, vals in outs.items():
        gnames = op.inputs.get("GRAD:" + slot, [])
        cs = []
        for i, y in enumerate(vals):
            g = env.get(gnames[i]) if i < len(gnames) and gnames[i] \
                else None
            if g is not None and isinstance(y, torch.Tensor):
                g = g.to(y.dtype).reshape(y.shape)
            cs.append(g)
        cotangents[slot] = cs
    grads = vjp_fn(cotangents)
    for slot, gvals in grads.items():
        for name, g in zip(op.outputs.get("GRAD:" + slot, []), gvals):
            if name and g is not None:
                env[name] = g


def run_block(block, env, step=0, seed=0, device=None):
    """Interpret `block` eagerly, op by op, mutating env."""
    needed_vjp = {op.attrs["fwd_uid"] for op in block.ops
                  if _is_generic_grad(op)}
    vjp_cache = {}
    for op in block.ops:
        if _is_generic_grad(op):
            with torch.no_grad():
                _run_grad_op(op, env, vjp_cache)
            continue
        od = registry.get_op_def(op.type)
        ctx = registry.ExecContext(op, _gather_inputs(op, env), step=step,
                                   seed=seed, device=device)
        if op.uid in needed_vjp:
            outs, vjp_fn = registry.make_forward_and_vjp(op, od, ctx)
            vjp_cache[op.uid] = (vjp_fn, outs)
        else:
            with torch.no_grad():
                outs = registry.call_lower(od, ctx)
        _write_outputs(op, outs, env)
    return env


class Executor:
    """Runs programs eagerly on one device.  `place=None` means the card
    (`cuda`), and a host without CUDA raises; `fluid.CPUPlace()` runs on
    the CPU, where each kernel's wrapper runs its plain version."""

    def __init__(self, place=None):
        self.place = place
        self.device = resolve_device(
            None if place is None else place.torch_device())
        self._step_counters = {}  # id(program) -> steps run

    def _prepare_feeds(self, program, feed):
        gb = program.global_block()
        feeds = {}
        for name, value in feed.items():
            v = gb._find_var_recursive(name)
            t = value if isinstance(value, torch.Tensor) \
                else as_tensor(value)
            if v is not None and v.dtype is not None:
                want = core.convert_dtype_to_torch(v.dtype)
                both_int = not t.is_floating_point() and \
                    not want.is_floating_point
                if t.dtype != want and not both_int:
                    t = t.to(want)
            feeds[name] = t.to(self.device)
        return feeds

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        """One step: feeds in, every op of block 0 in order, persistables
        back to the scope, fetches out (numpy arrays unless
        return_numpy=False)."""
        if program is None:
            program = default_main_program()
        if scope is None:
            scope = global_scope()
        fetch_names = [_fetch_name(f) for f in (fetch_list or [])]
        if len(program.blocks) != 1:
            raise NotImplementedError(
                "Executor.run: programs with sub-blocks (control flow) are "
                "not ported to paddle_tpu_torch yet")

        persistables = persistable_names(program)
        env = {}
        for n in persistables:
            val = scope.get(n)
            if val is not None:
                env[n] = val if val.device == self.device \
                    else val.to(self.device)
        env.update(self._prepare_feeds(program, feed or {}))
        step = self._step_counters.get(id(program), 0)
        run_block(program.global_block(), env, step=step,
                  seed=program.random_seed, device=self.device)
        self._step_counters[id(program)] = step + 1

        for n in persistables:
            if n in env:
                scope.set(n, env[n])
        fetches = []
        for n in fetch_names:
            if n not in env:
                raise KeyError("fetch %r: no op of the program wrote it"
                               % n)
            fetches.append(env[n])
        if return_numpy:
            return [as_numpy(f) for f in fetches]
        return fetches
