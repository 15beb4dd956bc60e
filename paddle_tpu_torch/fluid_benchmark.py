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
    python -m paddle_tpu_torch.fluid_benchmark --model resnet --parallel \\
        --batch_size 1024 --layout NHWC --whole_graph_ad
    CPU_NUM=2 python -m paddle_tpu_torch.fluid_benchmark --model mnist \\
        --device CPU --parallel --batch_size 8 --iterations 2

It runs on the card unless `--device CPU` asks for the CPU (where AMP
stays off, as the JAX tool keeps it off off its accelerator); a host
without CUDA raises.  A ragged feed (stacked_dynamic_lstm's `words`) is
a LoDTensor with lengths drawn from randint(3, 12), or from
randint(S // 4, S + 1) with `--seq_len S`.  The flags that need parts
not ported yet (--update_method pserver, --prefetch_depth,
--async_depth, --staged_feed, --profile) and the model
machine_translation raise NotImplementedError.

Data parallelism (fluid/parallel_executor.py): `--parallel` without the
launcher's environment starts one trainer process per local device
(`torch.cuda.device_count()` cards, or `CPU_NUM` on `--device CPU`;
parallel/mesh.py launch) and exits non-zero, every trainer ended, if one
fails.  In a trainer — a process with PADDLE_TRAINER_ID, PADDLE_TRAINERS
and PADDLE_COORDINATOR set, which `--update_method nccl2` requires — the
collective-mode DistributeTranspiler bootstraps the world, each trainer
synthesizes its share of the global `--batch_size` (the JAX tool's
meaning) and a ParallelExecutor runs the steps; trainer 0 prints the
record.  `--trace_steps N` (the port's own) runs N more steps on one
batch moved to the device before them (so without the tool's host
synthesis), timed (`staged`: step ms, examples/s over the world), then N
under torch.profiler on trainer 0 (`trace`: device busy share, and the
device and host ms a step of the collectives' ranges, the host side
alone on the CPU; the profiler's own cost is in its step ms).

The record has the JAX tool's keys (model, batch_size, iterations,
examples_per_sec, last_loss, device, parallel, update_method,
whole_graph_ad, remat_policy; device_loop and layout where the JAX
tool writes them) plus ms_per_step, amp and,
on the card, its name and power limit as nvidia-smi gives them.  A
data-parallel record adds `world` (trainers), examples_per_sec over the
whole world, `collectives` (all-reduces and bytes a step, by kind) and
`grad_allreduce` (the gradient buckets all-reduced alone: median ms and
bus bandwidth).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

from .bench import card_info

MODELS = ["mnist", "resnet", "vgg", "stacked_dynamic_lstm",
          "machine_translation", "se_resnext", "transformer"]

# what an unported option waits for (ROADMAP.md, queue 1)
_WAITS = {
    "update_method": "pserver mode and the RPC layer (ROADMAP.md, queue 1 "
                     "item 12)",
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
    p.add_argument("--trace_steps", type=int, default=0,
                   help="profile this many more steps on trainer 0 "
                        "(torch.profiler): busy share, collectives' time")
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
    unported = [("update_method", args.update_method == "pserver"),
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


def trainer_env():
    """(trainer_id, trainers) from a launcher's environment
    (PADDLE_TRAINER_ID, PADDLE_TRAINERS, PADDLE_COORDINATOR), or None."""
    keys = ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS", "PADDLE_COORDINATOR")
    if not all(os.environ.get(k) for k in keys):
        return None
    return int(os.environ[keys[0]]), int(os.environ[keys[1]])


def data_parallel(args):
    return args.parallel or args.update_method == "nccl2"


def _trainer(args):
    """(trainer_id, trainers) of a data-parallel run; raises outside a
    trainer's environment."""
    env = trainer_env()
    if env is None:
        raise RuntimeError(
            "fluid_benchmark: %s runs in a trainer process: set "
            "PADDLE_TRAINER_ID, PADDLE_TRAINERS and PADDLE_COORDINATOR (a "
            "launcher's environment), or run `python -m "
            "paddle_tpu_torch.fluid_benchmark --parallel`, which starts one "
            "trainer per local device"
            % ("--update_method nccl2" if args.update_method == "nccl2"
               else "--parallel"))
    return env


def launch_trainers(args, argv):
    """`--parallel` without a launcher: one trainer process per local
    device (cards, or CPU_NUM on the CPU), each this module with `argv`;
    returns 0, or 1 when a trainer failed (the others are ended)."""
    from .parallel import mesh
    on_card = args.device == "GPU"
    n = mesh.local_device_count(use_cuda=on_card)
    print("fluid_benchmark: --parallel starts %d trainer%s, one per %s"
          % (n, "" if n == 1 else "s", "card" if on_card
             else "CPU_NUM slot"), file=sys.stderr, flush=True)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.environ.get("PYTHONPATH")
    env = {"PYTHONPATH": root + (os.pathsep + path if path else "")}
    results = mesh.launch(["-m", "paddle_tpu_torch.fluid_benchmark"]
                          + list(argv), n, use_cuda=on_card, env=env)
    failed = [(r, rc) for r, (rc, _, _) in enumerate(results) if rc != 0]
    if failed:
        print("fluid_benchmark: trainers failed (rank, exit code): %s"
              % failed, file=sys.stderr, flush=True)
        return 1
    return 0


def _grad_allreduce_timing(torch, main_prog, scope, group, on_card, reps=10):
    """The step's gradient buckets all-reduced alone (no backward
    around them): median ms over `reps`, bytes, buckets and the bus
    bandwidth 2 (R - 1) / R x bytes / time in GB/s."""
    from .fluid import functionalizer
    grads = {}
    for p in main_prog.global_block().all_parameters():
        val = scope.get(p.name)
        if val is not None and val.is_floating_point():
            grads[p.name] = torch.zeros_like(val)
    n_buckets = len(functionalizer._grad_buckets(
        [grads[n] for n in sorted(grads)], functionalizer.GRAD_BUCKET_BYTES))
    nbytes = sum(g.numel() * 4 for g in grads.values())
    times = []
    for i in range(reps + 2):
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        functionalizer.all_reduce_grads(grads, group)
        if on_card:
            torch.cuda.synchronize()
        if i >= 2:
            times.append(time.perf_counter() - t0)
    group.reset_counts()
    ms = float(np.median(times)) * 1e3
    R = group.world_size
    return {"ms": ms, "bytes": nbytes, "buckets": n_buckets,
            "bus_gb_per_s": (2.0 * (R - 1) / R * nbytes / (ms / 1e3) / 1e9
                             if R > 1 else None)}


def _on_device(torch, feed, device):
    """A feed with its dense arrays moved to `device` once (a LoDTensor
    stays on the host: the Executor pads it)."""
    from .fluid.lod import LoDTensor
    return {k: v if isinstance(v, LoDTensor)
            else torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in feed.items()}


def _trace(torch, run_step, steps, on_card):
    """`steps` steps under torch.profiler: wall ms and device ms a step,
    the busy share, device ms a step by group (the collectives'
    `grp:allreduce <kind>` ranges and the gradient buckets' `grp:grad
    buckets`, the rest as compute), and the host ms a step spent inside
    each kind of range (a range's time includes the ranges inside it).
    On the CPU only the host side is recorded (busy_share is None)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run_step()
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups, host = {}, {}
    for e in prof.events():
        if e.name.startswith("grp:") and \
                e.device_type == torch.autograd.DeviceType.CPU:
            host[e.name[4:]] = host.get(e.name[4:], 0.0) + \
                e.cpu_time_total / 1e3 / steps
        kernels = getattr(e, "kernels", None) or []
        if not kernels or e.device_type != torch.autograd.DeviceType.CPU:
            continue
        group, p = "compute", e
        while p is not None:
            if p.name.startswith("grp:"):
                group = p.name[4:]
                break
            p = p.cpu_parent
        groups[group] = groups.get(group, 0.0) + sum(
            k.duration for k in kernels) / 1e3 / steps
    step_ms = wall * 1e3 / steps
    device_ms = sum(groups.values())
    return {"steps": steps, "step_ms": step_ms, "device_ms": device_ms,
            "busy_share": device_ms / step_ms if on_card else None,
            "groups_ms": groups, "host_ms": host}


def benchmark(args, after=None):
    """Train args.model for skip_batch_num + pass_num * iterations steps,
    each on a fresh synthetic batch with its loss fetched, and return
    (record, detail).  `after(detail)` runs after the timed steps with
    the run's AMP and AD flags still set.  detail holds the losses, the
    per-step host seconds, the program, the Executor (the
    ParallelExecutor of a data-parallel run), the scope, the fetch list
    and the batch maker.  A data-parallel run is one trainer's part: it
    needs a trainer's environment (`trainer_env`)."""
    check_ported(args)
    import torch

    from . import fluid
    from .flags import FLAGS
    dp = _trainer(args) if data_parallel(args) else None
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
        local = batch
        if dp is not None:
            tid, world = dp
            if batch % world:
                raise ValueError("fluid_benchmark: the global batch %d does "
                                 "not split over %d trainers"
                                 % (batch, world))
            local = batch // world
            cfg = fluid.DistributeTranspilerConfig()
            cfg.mode = "collective"
            fluid.DistributeTranspiler(cfg).transpile(
                tid, program=main_prog, trainers=world,
                startup_program=startup)
        # each trainer draws its own share of the global batch
        rng = np.random.RandomState(0 if dp is None else dp[0])
        exe = fluid.Executor(place)
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
        fetch = [loss.name] + ([acc.name] if acc is not None else [])
        pe = None
        if dp is not None:
            pe = fluid.ParallelExecutor(
                use_cuda=on_card, loss_name=loss.name,
                main_program=main_prog, num_trainers=dp[1],
                trainer_id=dp[0], scope=scope)
        lengths = lod_lengths(args)

        def make_batch():
            return synth_feed(feeds, local, rng, program=main_prog,
                              lengths=lengths)

        def run_step(feed):
            if pe is not None:
                if args.device_loop > 0:
                    return pe.run_loop(fetch, feed=feed,
                                       steps=args.device_loop)
                return pe.run(fetch, feed=feed)
            if args.device_loop > 0:
                return exe.run_loop(main_prog, feed=feed, fetch_list=fetch,
                                    steps=args.device_loop)
            return exe.run(main_prog, feed=feed, fetch_list=fetch)

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
                    if pe is not None:
                        pe.group.reset_counts()
                    t0 = time.perf_counter()
                t_step = time.perf_counter()
                outs = run_step(make_batch())
                # the loss read back is the step's host sync
                last = float(np.asarray(outs[0]).ravel()[0])
                losses.append(last)
                if i >= n_warm:
                    examples += batch * per_call
                    step_s.append(time.perf_counter() - t_step)
        dt = time.perf_counter() - t0
        collectives = None
        extra = {}
        if pe is not None:
            g = pe.group
            collectives = {k: {"calls": g.counts[k] / (n_timed * per_call),
                               "bytes": g.nbytes[k] / (n_timed * per_call)}
                           for k in sorted(g.counts)}
            extra["grad_allreduce"] = _grad_allreduce_timing(
                torch, main_prog, scope, g, on_card)
        if args.trace_steps > 0:
            # one batch, on the device before the window: the steps
            # alone, timed, then again under the profiler (trainer 0)
            feed = _on_device(torch, make_batch(), place.torch_device())
            step = lambda: run_step(feed)  # noqa: E731
            n = args.trace_steps
            with fluid.scope_guard(scope):
                step()
                if on_card:
                    torch.cuda.synchronize()
                t1 = time.perf_counter()
                for _ in range(n):
                    step()
                if on_card:
                    torch.cuda.synchronize()
                ms = (time.perf_counter() - t1) * 1e3 / (n * per_call)
                extra["staged"] = {"steps": n, "step_ms": ms,
                                   "examples_per_sec": batch / (ms / 1e3)}
                if dp is None or dp[0] == 0:
                    extra["trace"] = _trace(torch, step, n, on_card)
                else:
                    for _ in range(n):
                        step()
        detail = {"losses": losses, "step_s": step_s, "main": main_prog,
                  "startup": startup, "exe": pe if pe is not None else exe,
                  "scope": scope, "fetch": fetch, "make_batch": make_batch,
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
        "parallel": dp is not None,
        "update_method": args.update_method,
        "whole_graph_ad": wga,
        "remat_policy": args.remat_policy,
    }
    if dp is not None:
        record["world"] = dp[1]
        record["collectives"] = collectives
    record.update(extra)
    if args.device_loop > 0:
        record["device_loop"] = args.device_loop
    if args.model in ("resnet", "se_resnext"):
        record["layout"] = args.layout
    return record, detail


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    check_ported(args)
    if data_parallel(args) and trainer_env() is None:
        if args.update_method == "nccl2":
            _trainer(args)  # raises: nccl2 needs a launcher's environment
        return launch_trainers(args, argv)
    record, _ = benchmark(args)
    env = trainer_env()
    if env is None or env[0] == 0:
        print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
