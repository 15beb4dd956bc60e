"""ResNet-50 training throughput of paddle_tpu_torch on one NVIDIA GPU, the
counterpart of the JAX package's bench.py: the same program
(`models.resnet.get_model(is_train=True)`: ImageNet shapes, 1000
classes, Momentum 0.9 with L2Decay(1e-4), lr 0.1), the same four rotating
seeded batches staged on the device, 2 warm-up steps and 20 timed ones
fenced by a host read of the loss.

    python -m paddle_tpu_torch.bench                          # the card
    BENCH_DEVICE=cpu BENCH_BATCH=2 python -m paddle_tpu_torch.bench

Environment (the JAX bench's knobs and defaults):
  BENCH_BATCH        images per step (256; required with BENCH_DEVICE=cpu)
  BENCH_AMP          1: bf16 AMP over fp32 master weights (default), 0: fp32
  BENCH_LAYOUT       NHWC (default) or NCHW activations
  BENCH_WHOLEGRAPH   1: one torch.autograd.grad over the forward region
                     (default), 0: the per-op generic grads
  BENCH_REMAT        1: rematerialize under BENCH_REMAT_POLICY (conv_out)
  BENCH_DEVICE       unset: the card, and no card is an error; cpu: the
                     plain PyTorch path, 5 timed steps, at BENCH_BATCH
  BENCH_PREFETCH     <depth>: feed the loop through the device prefetch
                     queue (reader.prefetch_to_device): every batch is
                     freshly made on the host and copied to the card by
                     the background thread, so the number includes the
                     per-step feed path with the pipeline hiding it
                     (default 0: the four batches staged on the card)

Prints ONE JSON line: {"metric": "resnet50_train_images_per_sec", "value",
"unit": "images/sec", "card", "power_limit", "device", "amp", "layout",
"batch", "whole_graph"} (+ "remat_policy" under BENCH_REMAT, + "feed":
"prefetch(depth=N)" under BENCH_PREFETCH: staged and prefetched numbers
are never compared unlabelled).  There is no
`vs_baseline`: the JAX bench divides by a per-TPU-chip share of a GPU
cluster, which says nothing about one H100.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

N_BATCHES = 4
WARMUP = 2
ITERS = 20
CPU_ITERS = 5
IMAGE_HW = 224
CLASSES = 1000


def card_info(device):
    """(name, power limit) of the card as nvidia-smi gives them; on the
    CPU ("cpu", None)."""
    if device == "cpu":
        return "cpu", None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name, limit = [s.strip() for s in out.rsplit(",", 1)]
    return name, limit


def build(batch, layout, device, seed=None):
    """The training program, its startup run on an Executor on `device`:
    (main, loss, executor, scope)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models import resnet
    main, startup, _, loss, _, _ = resnet.get_model(
        batch_size=batch, class_dim=CLASSES, depth=50, dataset="imagenet",
        lr=0.1, is_train=True, layout=layout)
    if seed is not None:
        startup.random_seed = seed
    place = fluid.CPUPlace() if device == "cpu" else fluid.CUDAPlace(0)
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
    return main, loss, exe, scope


def make_step(main, loss, whole_graph, remat_policy, device):
    """(step, whole_graph): the step fn(state, feeds, step) -> ([loss],
    state) that the bench times, built as the JAX bench builds it, and
    whether it is the whole-graph one; a remat policy on a program
    whole-graph AD cannot serve raises (never a mislabelled run)."""
    import torch
    from paddle_tpu_torch.fluid import functionalizer
    from paddle_tpu_torch.fluid.functionalizer import persistable_names
    dev = torch.device(device)
    state_names = tuple(persistable_names(main))
    args = (main, ("data", "label"), (loss.name,), state_names)
    if whole_graph or remat_policy:
        step = functionalizer.build_whole_graph_step_fn(
            *args, remat_policy=remat_policy, device=dev)
        if step is not None:
            return step, True
        if remat_policy:
            raise RuntimeError(
                "BENCH_REMAT=1 but the program is ineligible for "
                "whole-graph AD (remat would silently not engage)")
    return functionalizer.build_step_fn(*args, device=dev), False


def staged_batches(batch, layout, device, n=N_BATCHES, seed=0):
    """`n` seeded (image, label) feeds, made on the host as the JAX bench
    makes them and staged on the device once."""
    import torch
    rng = np.random.RandomState(seed)
    shape = (batch, 3, IMAGE_HW, IMAGE_HW) if layout == "NCHW" \
        else (batch, IMAGE_HW, IMAGE_HW, 3)
    images = [torch.from_numpy(rng.randn(*shape).astype(np.float32))
              .to(device) for _ in range(n)]
    labels = [torch.from_numpy(rng.randint(0, CLASSES, (batch, 1))
                               .astype(np.int64)).to(device)
              for _ in range(n)]
    return [{"data": x, "label": y} for x, y in zip(images, labels)]


def prefetched_batches(batch, layout, device, depth, n, seed=0):
    """`n` seeded (image, label) feeds made on the host one at a time and
    staged by `reader.prefetch_to_device` at queue depth `depth`: a
    function i -> the next feed."""
    from paddle_tpu_torch import reader
    rng = np.random.RandomState(seed)
    shape = (batch, 3, IMAGE_HW, IMAGE_HW) if layout == "NCHW" \
        else (batch, IMAGE_HW, IMAGE_HW, 3)

    def host_batches():
        for _ in range(n):
            yield {"data": rng.randn(*shape).astype(np.float32),
                   "label": rng.randint(0, CLASSES, (batch, 1))
                   .astype(np.int64)}

    it = reader.prefetch_to_device(host_batches, depth, device=device)()
    return lambda i: next(it)


def run_steps(step, state, batches, step0, n):
    """`n` steps on the rotating batches (a list, or a function i -> the
    feed of step i) from step `step0`, fenced at the end by a host read
    of the last loss: (state, the n losses as device scalars, seconds,
    host seconds between step returns)."""
    t0 = last = time.perf_counter()
    gaps, losses = [], []
    for i in range(step0, step0 + n):
        feed = batches(i) if callable(batches) \
            else batches[i % len(batches)]
        fetches, state = step(state, feed, i)
        losses.append(fetches[0].reshape(-1)[0])
        now = time.perf_counter()
        gaps.append(now - last)
        last = now
    float(losses[-1])
    end = time.perf_counter()
    gaps[-1] += end - last
    return state, losses, end - t0, gaps


def _env_flag(name, default):
    return os.environ.get(name, default) == "1"


def main():
    import torch
    prefetch = os.environ.get("BENCH_PREFETCH", "0")
    if not prefetch.isdigit():
        print("bench: BENCH_PREFETCH must be a queue depth (an integer "
              ">= 0), got %r" % prefetch, file=sys.stderr)
        return 2
    prefetch = int(prefetch)
    device = os.environ.get("BENCH_DEVICE", "cuda")
    if device not in ("cuda", "cpu"):
        print("bench: BENCH_DEVICE must be unset (the card) or 'cpu', got %r"
              % device, file=sys.stderr)
        return 2
    if device == "cuda" and not torch.cuda.is_available():
        print("bench: CUDA is not available on this host; set "
              "BENCH_DEVICE=cpu (with BENCH_BATCH) to run the plain "
              "PyTorch path", file=sys.stderr)
        return 2
    if device == "cpu" and "BENCH_BATCH" not in os.environ:
        print("bench: BENCH_DEVICE=cpu needs BENCH_BATCH (a full-size "
              "batch does not fit a CPU run)", file=sys.stderr)
        return 2
    batch = int(os.environ.get("BENCH_BATCH", 256))
    amp = _env_flag("BENCH_AMP", "1")
    layout = os.environ.get("BENCH_LAYOUT", "NHWC")
    whole_graph = _env_flag("BENCH_WHOLEGRAPH", "1")
    remat_policy = os.environ.get("BENCH_REMAT_POLICY", "conv_out") \
        if _env_flag("BENCH_REMAT", "0") else None
    iters = ITERS if device == "cuda" else CPU_ITERS

    import paddle_tpu_torch.fluid as fluid
    fluid.set_amp(amp)
    try:
        main_prog, loss, exe, scope = build(batch, layout, device)
        step, whole_graph = make_step(main_prog, loss, whole_graph,
                                      remat_policy, device)
        state = {n: scope.get(n) for n in scope.keys()}
        if prefetch > 0:
            batches = prefetched_batches(batch, layout, exe.device, prefetch,
                                         WARMUP + iters)
        else:
            batches = staged_batches(batch, layout, exe.device)
        state, losses, _, _ = run_steps(step, state, batches, 0, WARMUP)
        if not np.isfinite(float(losses[-1])):
            raise FloatingPointError("bench: warm-up loss %r"
                                     % float(losses[-1]))
        state, losses, seconds, _ = run_steps(step, state, batches,
                                              WARMUP, iters)
        if not np.isfinite(float(losses[-1])):
            raise FloatingPointError("bench: final loss %r"
                                     % float(losses[-1]))
    finally:
        fluid.set_amp(False)
    card, limit = card_info(device)
    result = {"metric": "resnet50_train_images_per_sec",
              "value": batch * iters / seconds, "unit": "images/sec",
              "card": card, "power_limit": limit, "device": device,
              "amp": amp, "layout": layout, "batch": batch,
              "whole_graph": whole_graph}
    if remat_policy:
        result["remat_policy"] = remat_policy
    if prefetch > 0:
        result["feed"] = "prefetch(depth=%d)" % prefetch
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
