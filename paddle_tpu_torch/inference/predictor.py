"""The inference Predictor, after paddle_tpu/inference/predictor.py.

`create_paddle_predictor(AnalysisConfig(model_dir))` loads a
`save_inference_model` artifact (saved by either package), runs the
InferenceTranspiler when `ir_optim` is on (dropout removed, batch norm
folded into the convs, FuseBottleneckPass), and serves `run(inputs)`.
Where the JAX Predictor jits and AOT-compiles one executable per batch
bucket, the port interprets the program eagerly through the Executor's
`run_block` on its device; batch buckets still pad every batch up to the
next configured size, so a serving card sees a few fixed shapes, and
only batch-major fetches are un-padded.

`device` defaults to the card (`NativeConfig.device` 0 is `cuda:0`);
`device="cpu"` runs every kernel's plain version.  The serving front end
reads the same introspection as from the JAX Predictor (`batch_buckets`,
`feed_specs`, `batched_feed_names`, `fetch_batched_flags`) and places
replicas with `clone_to(device)`.  Not ported yet: AOT artifacts
(`save_aot`, `AotPredictor`, ROADMAP.md queue 1 item 11), mesh replicas
and the resource report.
"""

import threading
import warnings

import numpy as np
import torch

from .. import resolve_device
from .. import fluid
from ..fluid.executor import persistable_names, run_block

__all__ = ["NativeConfig", "AnalysisConfig", "PaddleTensor", "Predictor",
           "create_paddle_predictor"]


class PaddleTensor:
    """A named input array (the reference's PaddleTensor)."""

    def __init__(self, data, name=None, lod=None):
        self.data = np.asarray(data)
        self.name = name
        self.lod = lod or []

    @property
    def shape(self):
        return self.data.shape


class NativeConfig:
    """Artifact location and device.  `device`: a CUDA index (0 is
    `cuda:0`, the default), a device string such as "cpu", or a
    torch.device."""

    def __init__(self, model_dir=None, prog_file=None, param_file=None,
                 device=0):
        self.model_dir = model_dir
        self.prog_file = prog_file
        self.param_file = param_file
        self.device = device


class AnalysisConfig(NativeConfig):
    """Adds the inference rewrites (`ir_optim`) and batch buckets."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.ir_optim = True
        self.batch_size_buckets = (1, 2, 4, 8, 16, 32, 64, 128)


def _torch_device(device):
    if isinstance(device, int):
        return resolve_device(torch.device("cuda", device))
    return resolve_device(device)


def _device_label(device):
    """Stable wire-encodable device id ('cuda:0', 'cpu:0') for metrics and
    the per-replica stats of the serving layer; 'default' for None."""
    if device is None:
        return "default"
    device = torch.device(device)
    return "%s:%d" % (device.type, device.index or 0)


def _place(device):
    if device.type == "cpu":
        return fluid.CPUPlace()
    return fluid.CUDAPlace(device.index or 0)


def _var_is_batch_major(gb, name):
    """True when the program var's recorded shape leads with -1."""
    v = gb._find_var_recursive(name)
    return bool(v is not None and v.shape is not None
                and len(v.shape) >= 1 and int(v.shape[0]) == -1)


class Predictor:
    """Serves one artifact on one device; `device` overrides the
    config's."""

    def __init__(self, config, device=None):
        self._config = config
        self._device = _torch_device(config.device if device is None
                                     else device)
        self._scope = fluid.Scope()
        exe = fluid.Executor(_place(self._device))
        with fluid.scope_guard(self._scope):
            program, feed_names, fetch_vars = fluid.load_inference_model(
                config.model_dir, exe, model_filename=config.prog_file,
                params_filename=config.param_file)
            if isinstance(config, AnalysisConfig) and config.ir_optim:
                fluid.InferenceTranspiler().transpile(program,
                                                      scope=self._scope)
        self._program = program
        # the numerics lane: 'int8' when the PTQ pass rewrote the
        # contractions to dequant_* ops, else 'fp32'
        self._precision = "int8" if any(
            op.type.startswith("dequant_")
            for op in program.global_block().ops) else "fp32"
        self._feed_names = list(feed_names)
        self._fetch_names = [v.name for v in fetch_vars]
        self._state = {n: self._scope.get(n)
                       for n in persistable_names(program)
                       if self._scope.get(n) is not None}
        gb = program.global_block()
        self._batched_feed = {n: _var_is_batch_major(gb, n)
                              for n in self._feed_names}
        self._fetch_batched = [_var_is_batch_major(gb, n)
                               for n in self._fetch_names]
        self._lock = threading.Lock()
        self._overflow_warned = set()

    def _bucket_cap(self, b):
        """Smallest configured bucket >= b; None when bucketing is off
        (NativeConfig) or b overflows every bucket (warned once per
        size: every oversize batch is then a shape of its own)."""
        if not isinstance(self._config, AnalysisConfig):
            return None
        buckets = sorted(self._config.batch_size_buckets)
        for cap in buckets:
            if b <= cap:
                return cap
        with self._lock:
            if b in self._overflow_warned:
                return None
            self._overflow_warned.add(b)
        warnings.warn(
            "batch %d exceeds every configured bucket %s on %s — running "
            "it unpadded; raise batch_size_buckets or split the request"
            % (b, tuple(buckets), self._device), RuntimeWarning,
            stacklevel=3)
        return None

    def _named_inputs(self, inputs):
        if isinstance(inputs, dict):
            return {k: np.asarray(v) for k, v in inputs.items()}
        named = {}
        for i, t in enumerate(inputs):
            if isinstance(t, PaddleTensor):
                named[t.name or self._feed_names[i]] = t.data
            else:
                named[self._feed_names[i]] = np.asarray(t)
        return named

    def run(self, inputs):
        """inputs: {name: array}, a list of PaddleTensor, or a list of
        arrays in the saved feed order.  Returns numpy arrays in fetch
        order."""
        named = self._named_inputs(inputs)
        real_batch = next((arr.shape[0] for name, arr in named.items()
                           if arr.ndim >= 1
                           and self._batched_feed.get(name, False)), None)
        cap = self._bucket_cap(real_batch) if real_batch is not None \
            else None
        gb = self._program.global_block()
        env = dict(self._state)
        for name, arr in named.items():
            v = gb._find_var_recursive(name)
            if v is not None and v.dtype is not None:
                want = v.np_dtype
                if arr.dtype != want:
                    arr = arr.astype(want)
            if cap is not None and cap > real_batch and \
                    self._batched_feed.get(name, False):
                pad = np.zeros((cap - real_batch,) + arr.shape[1:],
                               arr.dtype)
                arr = np.concatenate([arr, pad], axis=0)
            env[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(
                self._device)
        with torch.no_grad():
            run_block(gb, env, seed=self._program.random_seed,
                      device=self._device)
        out = []
        for name, batched in zip(self._fetch_names, self._fetch_batched):
            a = env[name].detach().cpu().numpy()
            if cap is not None and cap > real_batch and batched and \
                    a.ndim >= 1 and a.shape[0] == cap:
                a = a[:real_batch]
            out.append(a)
        return out

    Run = run

    def clone_to(self, device):
        """A replica on `device`: it shares this predictor's loaded and
        rewritten program and holds its own copy of the parameters there
        (how the serving registry places N replicas from one load)."""
        p = object.__new__(Predictor)
        p.__dict__.update(self.__dict__)
        p._device = _torch_device(device)
        p._state = {n: t.to(p._device) for n, t in self._state.items()}
        p._lock = threading.Lock()
        p._overflow_warned = set()
        return p

    @property
    def device(self):
        """The torch.device this predictor computes on."""
        return self._device

    @property
    def program(self):
        """The program it runs (after the inference rewrites)."""
        return self._program

    @property
    def precision(self):
        """The numerics lane: 'fp32' or 'int8'."""
        return self._precision

    def batch_buckets(self):
        """Sorted batch buckets requests are padded into; () when
        bucketing is off (NativeConfig)."""
        if isinstance(self._config, AnalysisConfig):
            return tuple(sorted(self._config.batch_size_buckets))
        return ()

    def feed_specs(self):
        """name -> (shape list with -1 dynamic dims, dtype str)."""
        gb = self._program.global_block()
        out = {}
        for name in self._feed_names:
            v = gb._find_var_recursive(name)
            out[name] = ([int(d) for d in v.shape],
                         str(np.dtype(v.np_dtype)))
        return out

    def batched_feed_names(self):
        """The feeds whose leading dim is the batch axis."""
        return frozenset(n for n in self._feed_names
                         if self._batched_feed.get(n, False))

    def fetch_batched_flags(self):
        """Per fetch, in fetch order: does it lead with the batch axis."""
        return list(self._fetch_batched)


def create_paddle_predictor(config):
    return Predictor(config)
