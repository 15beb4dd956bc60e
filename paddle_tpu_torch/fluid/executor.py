"""Scope and Executor, after paddle_tpu/fluid/executor.py.

The JAX Executor traces a whole block into one jitted step
(functionalizer.build_step_fn).  The port's Executor builds the same
step function, cached per (program, version, feeds, fetches, AMP, AD
flags), and calls it eagerly (fluid/functionalizer.py):
  * per op, by default: a forward op whose `<type>_grad` appears later
    in the block runs under autograd and stashes its vjp closure
    (ops/registry.py make_forward_and_vjp); the grad op consumes and
    drops it; every other op runs its lowering under `torch.no_grad()`;
  * with FLAGS.whole_graph_ad (or a FLAGS.remat_policy): one
    torch.autograd.grad over the forward region serves the backward.
Persistables (params, optimizer state, the learning rate) live in the
Scope as torch tensors on the Executor's device and are written back
after each run.  `run_loop` runs K steps on one feed and returns the
last step's fetches.

bfloat16 crosses the host boundary as `ml_dtypes.bfloat16` numpy arrays,
as in the JAX package: a feed may be one (or a torch bf16 tensor), and a
bf16 fetch comes back as one.

A `LoDTensor` feed (fluid/lod.py) becomes the padded [B, T, ...] tensor
on the Executor's device plus its `<name>@LOD_LEN` int32 lengths; a
fetched var with lengths comes back as a packed `LoDTensor`, whatever
`return_numpy` says, as the JAX Executor returns it.
"""

import threading

import numpy as np
import torch

from .. import resolve_device
from ..ops import registry
from . import core, functionalizer
from .framework import Variable, default_main_program
from .functionalizer import LOD_LEN_SUFFIX
from .lod import LoDTensor, pad_lod_feed, unpad_to_lod_tensor
# the per-op interpreter and the state set live in functionalizer.py;
# importable from here as before
from .functionalizer import persistable_names, run_block  # noqa: F401

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


class Executor:
    """Runs programs eagerly on one device.  `place=None` means the card
    (`cuda`), and a host without CUDA raises; `fluid.CPUPlace()` runs on
    the CPU, where each kernel's wrapper runs its plain version."""

    # the data-parallel group (parallel/mesh.py) the step reduces over:
    # set by the ParallelExecutor's rank executor, None for the whole step
    _group = None

    def __init__(self, place=None):
        self.place = place
        # a host without CUDA raises here already
        resolve_device(None if place is None else place.torch_device())
        self._step_counters = {}  # id(program) -> steps run
        self._cache = {}  # step-fn key -> step fn

    @property
    def device(self):
        """The place's torch.device, resolved at each use: in a
        data-parallel rank CUDAPlace(0) names the rank's card once the
        rank has chosen it (fluid/core.py selected_gpus)."""
        return resolve_device(
            None if self.place is None else self.place.torch_device())

    def _prepare_feeds(self, program, feed):
        gb = program.global_block()
        device = self.device
        feeds = {}
        for name, value in feed.items():
            v = gb._find_var_recursive(name)
            if isinstance(value, LoDTensor) and value.lod():
                value, lens, seg = pad_lod_feed(value)
                if seg is not None:
                    raise NotImplementedError(
                        "feed %r: nested (lod_level 2) LoD feeds are not "
                        "ported to paddle_tpu_torch yet (ROADMAP.md, queue "
                        "1 item 13)" % name)
                feeds[name + LOD_LEN_SUFFIX] = torch.from_numpy(lens).to(
                    device)
            t = value if isinstance(value, torch.Tensor) \
                else as_tensor(value)
            if v is not None and v.dtype is not None:
                want = core.convert_dtype_to_torch(v.dtype)
                both_int = not t.is_floating_point() and \
                    not want.is_floating_point
                if t.dtype != want and not both_int:
                    t = t.to(want)
            feeds[name] = t.to(device)
        return feeds

    def _step_fn(self, program, feed_names, fetch_names, state_names):
        """The program's step function, built once per (program, its
        version, feeds, fetches, state, AMP, AD flags), as the JAX
        Executor's _get_jitted."""
        wga, remat = functionalizer.flags_ad_config()
        device = self.device
        key = (id(program), program._version, feed_names, fetch_names,
               state_names, registry.amp_enabled(), wga, remat, device)
        fn = self._cache.get(key)
        if fn is None:
            fn = functionalizer.build_step_fn(
                program, feed_names, fetch_names, state_names,
                whole_graph_ad=wga, remat_policy=remat, device=device,
                group=self._group)
            self._cache[key] = fn
        return fn

    def _prepare_step(self, program, feed, fetch_list, scope):
        """(step fn, state, feeds, fetch names); the step fn also fetches
        each fetch's lengths companion (None for a dense var)."""
        if len(program.blocks) != 1:
            raise NotImplementedError(
                "Executor.run: programs with sub-blocks (control flow) are "
                "not ported to paddle_tpu_torch yet")
        fetch_names = tuple(_fetch_name(f) for f in (fetch_list or []))
        fetch_ext = fetch_names + tuple(n + LOD_LEN_SUFFIX
                                        for n in fetch_names)
        feeds = self._prepare_feeds(program, feed or {})
        state_names = tuple(persistable_names(program))
        device = self.device
        state = {}
        for n in state_names:
            val = scope.get(n)
            if val is not None:
                state[n] = val if val.device == device else val.to(device)
        fn = self._step_fn(program, tuple(sorted(feeds)), fetch_ext,
                           state_names)
        return fn, state, feeds, fetch_names

    def _finish(self, scope, new_state, fetch_names, fetches, return_numpy):
        """Persistables to the scope; fetches out (`_fetch_out`)."""
        for n, val in new_state.items():
            scope.set(n, val)
        n_names = len(fetch_names)
        out = []
        for n, val, lens in zip(fetch_names, fetches[:n_names],
                                fetches[n_names:]):
            if val is None:
                raise KeyError("fetch %r: no op of the program wrote it"
                               % n)
            out.append(self._fetch_out(n, val, lens, return_numpy))
        return out

    def _fetch_out(self, name, val, lens, return_numpy):
        """One fetch as the caller gets it: a ragged one as a packed
        LoDTensor of its real rows."""
        if lens is not None:
            return unpad_to_lod_tensor(as_numpy(val), as_numpy(lens))
        return as_numpy(val) if return_numpy else val

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        """One step: feeds in, the program's step function, persistables
        back to the scope, fetches out (numpy arrays unless
        return_numpy=False)."""
        if program is None:
            program = default_main_program()
        if scope is None:
            scope = global_scope()
        fn, state, feeds, fetch_names = self._prepare_step(
            program, feed, fetch_list, scope)
        step = self._step_counters.get(id(program), 0)
        fetches, new_state = fn(state, feeds, step)
        self._step_counters[id(program)] = step + 1
        return self._finish(scope, new_state, fetch_names, fetches,
                            return_numpy)

    def run_loop(self, program=None, feed=None, fetch_list=None, steps=1,
                 scope=None, return_numpy=True):
        """`steps` training steps on one feed, the step counter folded per
        iteration so random ops draw as under `steps` calls of run();
        returns the LAST step's fetches.  The counter advances only when
        every step succeeded (the JAX package's run_loop runs them as one
        device loop; here a plain loop of the step function)."""
        if program is None:
            program = default_main_program()
        if scope is None:
            scope = global_scope()
        steps = int(steps)
        if steps < 1:
            raise ValueError("run_loop: steps must be >= 1")
        fn, state, feeds, fetch_names = self._prepare_step(
            program, feed, fetch_list, scope)
        step0 = self._step_counters.get(id(program), 0)
        fetches, new_state = functionalizer.run_loop(fn, state, feeds,
                                                     step0, steps)
        self._step_counters[id(program)] = step0 + steps
        return self._finish(scope, new_state, fetch_names, fetches,
                            return_numpy)
