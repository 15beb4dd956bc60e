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
`return_numpy` says, as the JAX Executor returns it.  `prepare_feeds`
is that conversion as a function, so a prefetch thread can run it; a
feed already on the Executor's device (a prefetched batch) is taken as
it is.

In-flight dispatch (fluid/pipeline.py): `run(..., as_future=True)`
queues the step on the card and returns a `FetchFuture` without a host
sync; the step counter that seeds the random ops advances at dispatch,
as the JAX Executor's does, so an async run draws the sync run's masks.
`FLAGS.step_watchdog_secs` bounds a synchronous step's wall clock (or,
in flight, the future's drain): the step runs on a helper thread and a
step past its budget raises `StepWatchdogTimeout` (and fires the flight
recorder) instead of blocking forever.  `FLAGS.check_nan_inf` checks
every fetch and persistable for NaN/Inf after each step (one host read
for all of them) and raises `FloatingPointError` naming the bad ones;
`FLAGS.benchmark` synchronizes the card after each step.  Both make the
step synchronous, so under `as_future` they return a resolved future.
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
from .pipeline import FetchFuture
from .selected_rows import SelectedRowsValue
# the per-op interpreter and the state set live in functionalizer.py;
# importable from here as before
from .functionalizer import persistable_names, run_block  # noqa: F401

try:
    from ml_dtypes import bfloat16 as _NP_BF16
except ImportError:  # pragma: no cover
    _NP_BF16 = None

__all__ = ["Executor", "Scope", "global_scope", "scope_guard", "as_numpy",
           "as_tensor", "prepare_feeds", "StepWatchdogTimeout",
           "FetchFuture"]


class StepWatchdogTimeout(TimeoutError):
    """An executor step (or the drain of one in flight) exceeded
    FLAGS.step_watchdog_secs of wall clock.  The card or a collective
    may be wedged: the waiting helper thread is abandoned and the train
    loop gets an exception it can act on."""


def _watchdog_call(call, timeout, what="executor step", device=None):
    """Run `call` on a helper thread (on `device`'s card when that is a
    CUDA device: a new thread starts on card 0) and give up after
    `timeout` seconds: a wait on the card cannot be interrupted from
    Python, but it can be abandoned.  CUDA has no timed wait, so the
    bounded wait is this thread's, on an Event."""
    box = {}
    done = threading.Event()
    if device is not None and device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())

    def _worker():
        try:
            if device is not None and device.type == "cuda":
                torch.cuda.set_device(device)
            box["value"] = call()
        except BaseException as e:
            box["error"] = e
        finally:
            done.set()

    t = threading.Thread(target=_worker, daemon=True,
                         name="paddle-tpu-torch-step-watchdog")
    t.start()
    if not done.wait(timeout):
        from ..obs import events as obs_events
        from ..obs import flightrec
        obs_events.emit("watchdog_fire", what=str(what),
                        budget_s=round(float(timeout), 3))
        # the bundle's thread stacks show where the abandoned thread is
        # stuck (no-op while FLAGS.flight_dir is unset)
        flightrec.trigger("watchdog_fire", what=str(what),
                          budget_s=round(float(timeout), 3))
        raise StepWatchdogTimeout(
            "%s still running after %.1fs (FLAGS.step_watchdog_secs): the "
            "card is wedged or the step pathologically slow; the waiting "
            "thread is abandoned" % (what, timeout))
    if "error" in box:
        raise box["error"]
    return box.get("value")


def _check_nan_inf(fetch_names, fetches, new_state):
    """FLAGS.check_nan_inf at the step boundary: every floating fetch
    and persistable is tested on its device and the flags come to the
    host in one read; raises FloatingPointError naming the bad ones."""
    named = [(n, v) for n, v in list(zip(fetch_names, fetches))
             + sorted(new_state.items())
             if isinstance(v, torch.Tensor) and v.is_floating_point()]
    if not named:
        return
    flags = torch.stack([torch.isfinite(v).all().to(named[0][1].device)
                         for _, v in named]).cpu()
    bad = [n for (n, _), ok in zip(named, flags.tolist()) if not ok]
    if bad:
        raise FloatingPointError(
            "check_nan_inf: non-finite values in: %s" % ", ".join(bad))


class Scope:
    """name -> torch tensor map."""

    def __init__(self):
        self._vars = {}

    def get(self, name):
        return self._vars.get(name)

    def has(self, name):
        return name in self._vars

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
    back as an `ml_dtypes.bfloat16` array (numpy has no bfloat16), a
    SelectedRows value as one of numpy rows and values."""
    if isinstance(tensor, (list, tuple)):
        return [as_numpy(t) for t in tensor]
    if isinstance(tensor, SelectedRowsValue):
        return SelectedRowsValue(as_numpy(tensor.rows),
                                 as_numpy(tensor.values), tensor.height)
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


def prepare_feeds(program, feed, device=None):
    """A feed dict as the step takes it: every value a torch tensor in
    its var's dtype (ints keep their width), a ragged LoDTensor padded to
    [B, T, ...] with its `<name>@LOD_LEN` lengths beside it; on `device`
    when given (a tensor already there is taken as it is), else left on
    the host for a prefetch thread to copy."""
    gb = program.global_block()
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
            lens = torch.from_numpy(lens)
            feeds[name + LOD_LEN_SUFFIX] = lens if device is None \
                else lens.to(device)
        t = value if isinstance(value, torch.Tensor) \
            else as_tensor(value)
        if v is not None and v.dtype is not None:
            want = core.convert_dtype_to_torch(v.dtype)
            both_int = not t.is_floating_point() and \
                not want.is_floating_point
            if t.dtype != want and not both_int:
                t = t.to(want)
        feeds[name] = t if device is None else t.to(device)
    return feeds


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
        return prepare_feeds(program, feed, self.device)

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
        """Persistables to the scope; fetches out (`_finish_fetches`)."""
        for n, val in new_state.items():
            scope.set(n, val)
        return self._finish_fetches(fetch_names, fetches, return_numpy)

    def _finish_fetches(self, fetch_names, fetches, return_numpy):
        """The caller's fetches (`_fetch_out` each) from the step's
        values and their lengths companions."""
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

    def _call_step(self, fn, state, feeds, step, what, scale=1):
        """The step, under the wall-clock watchdog when
        FLAGS.step_watchdog_secs is set (the step then runs on a helper
        thread and is waited for on the card, so a hang is bounded;
        `scale` steps get `scale` times the budget)."""
        from ..flags import FLAGS
        wd = FLAGS.step_watchdog_secs * scale
        if not (wd and wd > 0):
            return fn(state, feeds, step)
        device = self.device

        def synced():
            out = fn(state, feeds, step)
            if device.type == "cuda":
                torch.cuda.current_stream(device).synchronize()
            return out

        return _watchdog_call(synced, wd, what, device)

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True, as_future=False):
        """One step: feeds in, the program's step function, persistables
        back to the scope, fetches out (numpy arrays unless
        return_numpy=False).  With `as_future=True` the step is queued
        on the card and a FetchFuture comes back at once: no host sync,
        the scope already holds the step's (not yet computed) state, so
        back-to-back dispatches chain on the card; `.result()` gives the
        fetches as run() would."""
        from ..flags import FLAGS
        if program is None:
            program = default_main_program()
        if scope is None:
            scope = global_scope()
        fn, state, feeds, fetch_names = self._prepare_step(
            program, feed, fetch_list, scope)
        step = self._step_counters.get(id(program), 0)
        if as_future:
            # the RNG step fold advances at dispatch
            self._step_counters[id(program)] = step + 1
            fetches, new_state = fn(state, feeds, step)
        else:
            fetches, new_state = self._call_step(fn, state, feeds, step,
                                                 "executor step")
            self._step_counters[id(program)] = step + 1
        device = self.device
        if FLAGS.benchmark and device.type == "cuda":
            torch.cuda.synchronize(device)
        if FLAGS.check_nan_inf:
            _check_nan_inf(fetch_names, fetches, new_state)
        if not as_future:
            return self._finish(scope, new_state, fetch_names, fetches,
                                return_numpy)
        for n, val in new_state.items():
            scope.set(n, val)
        event = None
        if device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
        fut = FetchFuture(
            fetches, post=lambda vals, rn: self._finish_fetches(
                fetch_names, vals, rn),
            return_numpy=return_numpy, what="executor step drain",
            event=event)
        if FLAGS.benchmark or FLAGS.check_nan_inf:
            # these modes already synchronized the step: the caller's
            # drain is a no-op, not a second conversion site
            fut.result()
        return fut

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
        from ..flags import FLAGS
        if FLAGS.check_nan_inf:
            raise RuntimeError(
                "run_loop: FLAGS.check_nan_inf checks every step's values, "
                "which needs per-step execution; use Executor.run")
        fn, state, feeds, fetch_names = self._prepare_step(
            program, feed, fetch_list, scope)
        step0 = self._step_counters.get(id(program), 0)
        loop = lambda st, fd, s0: functionalizer.run_loop(  # noqa: E731
            fn, st, fd, s0, steps)
        # the watchdog's budget scales with the loop: its secs per step
        fetches, new_state = self._call_step(
            loop, state, feeds, step0, "run_loop (%d steps)" % steps,
            scale=steps)
        self._step_counters[id(program)] = step0 + steps
        if FLAGS.benchmark and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self._finish(scope, new_state, fetch_names, fetches,
                            return_numpy)
