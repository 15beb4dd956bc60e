"""The flags the port reads, with paddle_tpu/flags.py's names and
defaults.  A plain module-level object: set an attribute to override
(`FLAGS.serving_decode_slots = 4`).  At import an environment variable
`FLAGS_<name>` overrides a default, parsed to the default's type (a bool
from 1/true/yes/on or 0/false/no/off/"").  Setting `use_bf16_amp` calls
`ops.registry.set_amp`, and the tracing and event-log flags reconfigure
`obs/`, as the JAX flags' on_change hooks do."""

import os
import types

__all__ = ["FLAGS", "parse_flag"]

_TRUE = frozenset(["1", "true", "yes", "on"])
_FALSE = frozenset(["0", "false", "no", "off", ""])


def _on_change(name, value):
    if name == "use_bf16_amp":
        from .ops import registry
        registry.set_amp(value)
    elif name == "trace":
        from .obs import tracing
        tracing.configure(enabled=value)
    elif name == "trace_buffer_events":
        from .obs import tracing
        tracing.configure(capacity=value)
    elif name == "event_log":
        from .obs import events
        events.configure(path=value)
    elif name == "event_log_max_kb":
        from .obs import events
        events.configure(max_kb=value)
    elif name in ("flight_dir", "flight_keep", "flight_cooldown_s"):
        from .obs import flightrec
        flightrec.configure()


class _Flags(types.SimpleNamespace):
    def __setattr__(self, name, value):
        super().__setattr__(name, value)
        _on_change(name, value)


def parse_flag(name, raw, default):
    """`raw` (an environment string) as the type of `default`."""
    if isinstance(default, bool):
        v = str(raw).strip().lower()
        if v in _TRUE:
            return True
        if v in _FALSE:
            return False
        raise ValueError("flag %s: cannot parse %r as bool" % (name, raw))
    return type(default)(raw)


_DEFAULTS = dict(
    # slot-table size of each replica's decode lane: the per-replica cap
    # on concurrently generating requests
    serving_decode_slots=8,
    # admission bound per model: a submit past it is shed
    # (ServerOverloaded), never parked on an unbounded backlog
    serving_max_queue=256,
    # the DynamicBatcher's coalescing window: the router holds the head
    # request this long for compatible stragglers
    serving_batch_deadline_ms=5.0,
    # dispatch worker threads per replica lane
    serving_workers=1,
    # coalesced groups a replica lane may queue before the router holds
    # back (sticky back-pressure: overload sheds at admission)
    serving_lane_depth=1,
    # default placement spec of a load: N replicas, 'auto' (one per
    # card) or a device list ('cuda:0,cuda:1')
    serving_replicas="1",
    # default and ceiling of a streaming request's generation budget
    serving_max_new_tokens=128,
    # a stream flushes a token chunk every this many generated tokens
    serving_stream_chunk_tokens=1,
    # decode steps per lane dispatch: above 1 a DecodeBatcher runs fused
    # windows of up to this many steps (a fused round on a speculative
    # lane), one CUDA-graph replay each on the card
    serving_decode_fuse_steps=1,
    # default KV-cache numerics ('' = float32, or 'int8')
    serving_kv_cache_dtype="",
    # speculative-decoding draft depth: with a draft predictor each round
    # the draft proposes this many tokens and the target verifies all
    # k + 1 positions in one step; < 1 disables speculation
    serving_spec_k=4,
    # default draft artifact of a decode load ('' = none)
    serving_spec_draft="",
    # span tracing of the serving path (obs/tracing.py); off makes the
    # tracer a no-op, counters keep working
    trace=True,
    # capacity of the span ring
    trace_buffer_events=4096,
    # a request slower than this many ms also lands a 'slow' event
    # (0 disables the slow log)
    trace_slow_ms=0.0,
    # JSONL path of the structured event log ('' = memory ring only)
    event_log="",
    # rotation threshold of the event log file, KiB
    event_log_max_kb=1024,
    # run the SLO monitor thread on every InferenceServer
    slo_monitor=True,
    # SLO monitor sampling interval, ms
    slo_eval_interval_ms=1000.0,
    # declared SLOs: '[model:]key=val,...;...' (obs/slo.py)
    serving_slo="",
    # the client's socket timeout, seconds
    rpc_deadline=180.0,
    # attempts and base delay of the jittered-backoff retry policy
    rpc_retry_times=5,
    rpc_retry_backoff=0.05,
    # the fleet controller and federation are not ported (ROADMAP.md
    # queue 1): a server started with either set raises
    fleet_controller=False,
    federation_frontend="",
    # FuseBottleneckPass fuses only bottlenecks whose width F (the 3x3
    # conv's channel count) is <= this; 0 disables the pass (opt-in, as
    # in the JAX package)
    fuse_bottleneck_max_width=0,
    # PTQ size floor: a weight with fewer elements stays fp32
    quantize_min_weight_elems=1024,
    # calibration batches the PTQ pass consumes at most
    quantize_calib_batches=4,
    # bf16 automatic mixed precision: bf16 matmuls/convs/attention with
    # fp32 master weights (setting it switches ops.registry's AMP)
    use_bf16_amp=False,
    # serve a program's backward section with ONE torch.autograd.grad over
    # the whole forward region instead of per-op stashed vjps, when the
    # program shape allows it (straight-line forward, generic grads only);
    # what makes FLAGS.remat_policy real
    whole_graph_ad=False,
    # rematerialization policy of the whole-graph step: '' (save what
    # autograd saves), 'conv_out' (keep conv outputs, recompute the batch
    # norm and activation tails), 'block_out' (keep the residual blocks'
    # outputs, recompute their interiors), 'dots' or 'nothing'
    remat_policy="",
    # re-check every fetch and persistable for NaN/Inf after each
    # Executor step and name the non-finite ones (a debugging mode: the
    # check is a per-step host sync)
    check_nan_inf=False,
    # synchronize the card after every Executor step, so wall-clock
    # timing around run() is honest
    benchmark=False,
    # the Trainer's anomaly sentinel: screen each step's fetched losses
    # (and every persistable with sentinel_check_params) for NaN/Inf; a
    # bad step is reverted, and after sentinel_max_bad_steps consecutive
    # bad steps the policy decides: 'skip' raises SentinelError,
    # 'rollback' reloads the last-good checkpoint
    sentinel_nan_check=False,
    sentinel_policy="skip",
    sentinel_max_bad_steps=3,
    sentinel_check_params=False,
    # wall-clock watchdog on each Executor step (the drain of an
    # in-flight one): a step past this many seconds raises
    # StepWatchdogTimeout instead of blocking forever; 0 disables
    step_watchdog_secs=0.0,
    # in-flight dispatch: the Trainer keeps up to this many steps'
    # fetches on the card (Executor.run(as_future=True)) and resolves
    # each at the pipeline tail; 0 resolves every step before the next
    async_dispatch_depth=0,
    # the Trainer's device prefetch queue (reader.prefetch_to_device):
    # a background thread prepares and copies the next batches to the
    # card while the current step computes; 0 feeds on the main thread
    reader_prefetch_depth=0,
    # flight-recorder bundle root (obs/flightrec.py): a trigger
    # (watchdog_fire, sentinel giveup/rollback, slo_breach, the server's
    # `flight` verb) commits a post-mortem bundle there; '' disables it
    flight_dir="",
    # keep-N rotation of the flight-recorder bundles
    flight_keep=8,
    # per-trigger-reason cooldown of the flight recorder, seconds
    flight_cooldown_s=30.0,
)

FLAGS = _Flags(**{
    name: (parse_flag(name, os.environ["FLAGS_" + name], default)
           if "FLAGS_" + name in os.environ else default)
    for name, default in _DEFAULTS.items()})
if FLAGS.use_bf16_amp:
    # an environment override takes effect as a set attribute would
    _on_change("use_bf16_amp", True)
