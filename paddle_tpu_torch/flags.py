"""The flags the port reads, with paddle_tpu/flags.py's names and
defaults.  A plain module-level object: set an attribute to override
(`FLAGS.serving_decode_slots = 4`); environment parsing comes with the
serving front end.  Setting `use_bf16_amp` calls `ops.registry.set_amp`,
as the JAX flag's on_change hook does."""

import types

__all__ = ["FLAGS"]


class _Flags(types.SimpleNamespace):
    def __setattr__(self, name, value):
        super().__setattr__(name, value)
        if name == "use_bf16_amp":
            from .ops import registry
            registry.set_amp(value)


FLAGS = _Flags(
    # slot-table size of each replica's decode lane: the per-replica cap
    # on concurrently generating requests
    serving_decode_slots=8,
    # admission bound per model: a submit past it is shed
    # (ServerOverloaded), never parked on an unbounded backlog
    serving_max_queue=256,
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
)
