"""The benchmark/fluid runner of paddle_tpu_torch, the counterpart of the
JAX package's tools/fluid_benchmark.py: pick a model of the zoo, train it
for a fixed number of iterations on synthetic batches (made on the host
each step, as the reference's --use_fake_data), and print one JSON
record with examples/s.

    python -m paddle_tpu_torch.fluid_benchmark --model vgg --batch_size 128
    python -m paddle_tpu_torch.fluid_benchmark --model se_resnext \\
        --batch_size 64 --layout NHWC --whole_graph_ad
    python -m paddle_tpu_torch.fluid_benchmark --model stacked_dynamic_lstm
    python -m paddle_tpu_torch.fluid_benchmark --model mnist --device CPU \\
        --batch_size 4 --iterations 2

It runs on the card unless `--device CPU` asks for the CPU (where AMP
stays off, as the JAX tool keeps it off off its accelerator); a host
without CUDA raises.  A ragged feed (stacked_dynamic_lstm's `words`) is
a LoDTensor with lengths drawn from randint(3, 12), or from
randint(S // 4, S + 1) with `--seq_len S`.  The flags that need parts
not ported yet (--parallel, --update_method other than local,
--prefetch_depth, --async_depth, --staged_feed, --profile) and the model
machine_translation raise NotImplementedError.

The record has the JAX tool's keys (model, batch_size, iterations,
examples_per_sec, last_loss, device, parallel, update_method,
whole_graph_ad, remat_policy; device_loop and layout where the JAX
tool writes them) plus ms_per_step, amp and,
on the card, its name and power limit as nvidia-smi gives them.
"""

import argparse
import json
import sys
import time

import numpy as np

from .bench import card_info

MODELS = ["mnist", "resnet", "vgg", "stacked_dynamic_lstm",
          "machine_translation", "se_resnext", "transformer"]

# what an unported option waits for (ROADMAP.md, queue 1)
_WAITS = {
    "parallel": "the ParallelExecutor (ROADMAP.md, queue 1 item 12)",
    "update_method": "multi-device training (ROADMAP.md, queue 1 item 12)",
    "prefetch_depth": "reader.prefetch_to_device (ROADMAP.md, queue 1 "
                      "item 9)",
    "async_depth": "in-flight step dispatch, run(as_future=True) "
                   "(ROADMAP.md, queue 1 item 9)",
    "staged_feed": "staged device feeds (ROADMAP.md, queue 1 item 9)",
    "profile": "fluid.profiler (ROADMAP.md, queue 1 item 13)",
    "machine_translation": "control-flow sub-blocks and the beam-search "
                           "ops (ROADMAP.md, queue 1 item 13)",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser("paddle_tpu_torch.fluid_benchmark")
    p.add_argument("--model", default="mnist", choices=MODELS)
    p.add_argument("--batch_size", type=int, default=0,
                   help="0 = 32, as the JAX tool")
    p.add_argument("--iterations", type=int, default=20)
    p.add_argument("--skip_batch_num", type=int, default=2,
                   help="warm-up batches excluded from timing")
    p.add_argument("--pass_num", type=int, default=1,
                   help="timed passes of --iterations steps each")
    p.add_argument("--device", default="GPU", choices=["CPU", "GPU"],
                   help="GPU (the card, the default) or CPU")
    p.add_argument("--data_set", default=None,
                   help="imagenet|cifar10|flowers for resnet and vgg")
    p.add_argument("--layout", default="NCHW", choices=["NCHW", "NHWC"])
    p.add_argument("--seq_len", type=int, default=0,
                   help="transformer: its sequence length; "
                        "stacked_dynamic_lstm: lengths from "
                        "randint(S // 4, S + 1) (0 = the model default, "
                        "randint(3, 12) for the LSTM)")
    p.add_argument("--learning_rate", type=float, default=0.0)
    p.add_argument("--parallel", action="store_true")
    p.add_argument("--update_method", default="local",
                   choices=["local", "pserver", "nccl2"])
    p.add_argument("--no_amp", action="store_true",
                   help="disable bf16 AMP (on by default on the card)")
    p.add_argument("--device_loop", type=int, default=0,
                   help="run N steps per Executor.run_loop call on one "
                        "batch; 0 = one Executor.run per step")
    p.add_argument("--prefetch_depth", type=int, default=0)
    p.add_argument("--async_depth", type=int, default=0)
    p.add_argument("--staged_feed", type=int, default=0)
    p.add_argument("--profile", action="store_true")
    p.add_argument("--use_fake_data", action="store_true", default=True)
    p.add_argument("--whole_graph_ad", action="store_true",
                   help="serve the backward with one torch.autograd.grad "
                        "over the forward region (enables --remat_policy)")
    p.add_argument("--remat_policy", default="",
                   help="under --whole_graph_ad: 'block_out', 'conv_out', "
                        "'dots' or 'nothing'")
    return p.parse_args(argv)


def check_ported(args):
    """Raise NotImplementedError for an option or model that needs parts
    not ported yet: none is ignored quietly."""
    unported = [("parallel", args.parallel),
                ("update_method", args.update_method != "local"),
                ("prefetch_depth", args.prefetch_depth > 0),
                ("async_depth", args.async_depth > 0),
                ("staged_feed", args.staged_feed > 0),
                ("profile", args.profile),
                ("machine_translation",
                 args.model == "machine_translation")]
    for name, used in unported:
        if used:
            raise NotImplementedError(
                "fluid_benchmark: %s needs %s, not ported to "
                "paddle_tpu_torch yet" % (name, _WAITS[name]))


def build_model(args):
    """The model's (main, startup, feeds, loss, acc, predict), built with
    the JAX tool's keyword arguments."""
    import importlib
    mod = importlib.import_module("paddle_tpu_torch.models.%s" % args.model)
    kwargs = {}
    if args.batch_size:
        kwargs["batch_size"] = args.batch_size
    if args.learning_rate:
        kwargs["lr"] = args.learning_rate
    if args.model in ("resnet", "vgg") and args.data_set:
        kwargs["dataset"] = args.data_set
    if args.model in ("resnet", "se_resnext"):
        kwargs["layout"] = args.layout
    if args.model == "transformer" and args.seq_len:
        kwargs["seq_len"] = args.seq_len
    return mod.get_model(**kwargs)


def lod_lengths(args):
    """(low, high) of randint for a ragged feed's sequence lengths."""
    if args.model == "stacked_dynamic_lstm" and args.seq_len:
        return args.seq_len // 4, args.seq_len + 1
    return 3, 12


def synth_feed(feeds, batch, rng, program=None, lengths=(3, 12)):
    """A synthetic batch for the model's feed vars: a LoDTensor with
    lengths from randint(*lengths) for a ragged var, else an array of
    [batch] + the var's static dims (the JAX tool's synth_feed)."""
    from .fluid import core
    from .fluid.lod import LoDTensor
    out = {}
    for v in feeds:
        if isinstance(v, str):
            v = program.global_block().var(v)
        dtype = core.convert_dtype_to_np(v.dtype)
        sample_shape = [d for d in v.shape[1:]
                        if isinstance(d, int) and d > 0]
        if v.lod_level and v.lod_level > 0:
            lens = rng.randint(lengths[0], lengths[1], size=batch)
            flat = np.concatenate(
                [_sample(dtype, [n] + sample_shape, rng) for n in lens])
            t = LoDTensor(flat)
            t.set_recursive_sequence_lengths([lens.tolist()])
            out[v.name] = t
        else:
            out[v.name] = _sample(dtype, [batch] + sample_shape, rng)
    return out


def _sample(dtype, shape, rng):
    if np.issubdtype(dtype, np.integer):
        # ids and labels in {0, 1}: within any vocabulary or class count
        return rng.randint(0, 2, size=shape).astype(dtype)
    return rng.uniform(-0.5, 0.5, size=shape).astype(dtype)


def benchmark(args, after=None):
    """Train args.model for skip_batch_num + pass_num * iterations steps,
    each on a fresh synthetic batch with its loss fetched, and return
    (record, detail).  `after(detail)` runs after the timed steps with
    the run's AMP and AD flags still set.  detail holds the losses, the
    per-step host seconds, the program, the Executor, the scope, the
    fetch list and the batch maker."""
    check_ported(args)
    import torch

    from . import fluid
    from .flags import FLAGS
    on_card = args.device == "GPU"
    place = fluid.CUDAPlace(0) if on_card else fluid.CPUPlace()
    amp = on_card and not args.no_amp
    wga = bool(args.whole_graph_ad or args.remat_policy)
    saved = (fluid.amp_enabled(), FLAGS.whole_graph_ad, FLAGS.remat_policy)
    fluid.set_amp(amp)
    FLAGS.whole_graph_ad = wga
    FLAGS.remat_policy = args.remat_policy
    try:
        # one set of var names for every build in a process, as a fresh
        # process gets, so a state carries between two runs by name
        with fluid.unique_name.guard():
            main_prog, startup, feeds, loss, acc, _ = build_model(args)
        feeds = [main_prog.global_block().var(f) if isinstance(f, str)
                 else f for f in feeds]
        batch = args.batch_size if args.batch_size > 0 else 32
        rng = np.random.RandomState(0)
        exe = fluid.Executor(place)
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
        fetch = [loss.name] + ([acc.name] if acc is not None else [])
        lengths = lod_lengths(args)

        def make_batch():
            return synth_feed(feeds, batch, rng, program=main_prog,
                              lengths=lengths)

        n_warm = args.skip_batch_num
        n_timed = args.iterations * max(args.pass_num, 1)
        per_call = max(args.device_loop, 1)
        losses, step_s = [], []
        examples = 0
        last = None
        t0 = time.perf_counter()
        with fluid.scope_guard(scope):
            for i in range(n_warm + n_timed):
                if i == n_warm:
                    if on_card:
                        torch.cuda.synchronize()
                    t0 = time.perf_counter()
                t_step = time.perf_counter()
                feed = make_batch()
                if args.device_loop > 0:
                    outs = exe.run_loop(main_prog, feed=feed,
                                        fetch_list=fetch,
                                        steps=args.device_loop)
                else:
                    outs = exe.run(main_prog, feed=feed, fetch_list=fetch)
                # the loss read back is the step's host sync
                last = float(np.asarray(outs[0]).ravel()[0])
                losses.append(last)
                if i >= n_warm:
                    examples += batch * per_call
                    step_s.append(time.perf_counter() - t_step)
        dt = time.perf_counter() - t0
        detail = {"losses": losses, "step_s": step_s, "main": main_prog,
                  "startup": startup, "exe": exe, "scope": scope,
                  "fetch": fetch, "make_batch": make_batch,
                  "feeds": feeds, "batch": batch, "amp": amp}
        if after is not None:
            after(detail)
    finally:
        fluid.set_amp(saved[0])
        FLAGS.whole_graph_ad, FLAGS.remat_policy = saved[1], saved[2]
    if last is None or not np.isfinite(last):
        raise FloatingPointError("fluid_benchmark: loss diverged: %r"
                                 % (last,))
    card, limit = card_info("cuda" if on_card else "cpu")
    record = {
        "model": args.model,
        "batch_size": batch,
        "iterations": n_timed,
        "examples_per_sec": examples / dt if dt else None,
        "ms_per_step": dt * 1e3 / (n_timed * per_call),
        "last_loss": last,
        "device": "gpu" if on_card else "cpu",
        "card": card,
        "power_limit": limit,
        "amp": amp,
        "parallel": False,
        "update_method": args.update_method,
        "whole_graph_ad": wga,
        "remat_policy": args.remat_policy,
    }
    if args.device_loop > 0:
        record["device_loop"] = args.device_loop
    if args.model in ("resnet", "se_resnext"):
        record["layout"] = args.layout
    return record, detail


def main(argv=None):
    args = parse_args(argv)
    record, _ = benchmark(args)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
