"""Open-loop load generator for the port's inference server, after the
core of paddle_tpu's tools/bench_serving.py (mirrored as
fluid_benchmark.py was).

Arrivals are a Poisson process at a target QPS, fired on schedule
whether or not earlier requests returned, and latency is measured from
the SCHEDULED arrival: an overloaded server shows up as latency blowup
and sheds, never as a flattered throughput number.  Per point it prints
ONE JSON line with the JAX tool's keys:

  images  {"metric": "serving_qps", "target_qps", "achieved_qps",
           "p50_ms", "p95_ms", "p99_ms", "shed_rate", "errors",
           "bit_exact", "batch_fill", "bucket_fill_ratio", ...}
          plus "served_qps" (see run_point)
  decode  {"metric": "serving_decode", "tokens_per_sec",
           "ttft_p50_ms", "ttft_p95_ms", "ttft_p99_ms",
           "completion_rate", "bit_exact", ...}

The server runs in-process on a model exported fresh from a seed:
`--model fc` (tiny) or `--model resnet` (ResNet-50, NHWC, 224 x 224);
`--decode` serves a decode artifact (the JAX tool's tiny random LM)
through `infer_stream` with `--kv_dtype`, `--fuse_steps` and
`--spec_k` sweeps; `--precision` PTQs the image model and drives its
fp32 and int8 lanes behind one name.  `bit_exact` replays requests
against a direct Predictor (a direct greedy decode) on the same device:
serving must not change one bit.

    python -m paddle_tpu_torch.bench_serving --smoke --device cpu
    python -m paddle_tpu_torch.bench_serving --model resnet --qps 50,200

The card is the default device; `--device cpu` runs the plain path.  The
mesh, fleet, topology, chaos and compile-cache lanes of the JAX tool
raise NotImplementedError naming the ROADMAP.md items that port them.
"""

import argparse
import json
import os
import random
import tempfile
import threading
import time

import numpy as np

__all__ = ["build_model", "build_decode_model", "run_point",
           "run_decode_point", "verify_bit_exact",
           "verify_decode_bit_exact", "decode_request", "main"]

# the JAX tool's decode length mix: mostly short, a tail of long
DECODE_LEN_MIX = ((6, 0.5), (12, 0.3), (48, 0.2))

_WAITING_LANES = {
    "mesh": "mesh replicas (ROADMAP.md queue 1, item 12)",
    "fleet": "the fleet controller (ROADMAP.md queue 1)",
    "topology": "federation (ROADMAP.md queue 1)",
    "chaos_proxy": "the chaos tools (tools/chaos.py is not ported)",
    "chaos_slow_ms": "the chaos tools (tools/chaos.py is not ported)",
    "compile_cache_dir": "the compile cache (ROADMAP.md queue 1, item 11)",
}


def build_model(kind, model_dir, seed=17):
    """Export a random-weight inference artifact with the port's fluid;
    returns (model_dir, feed_name, sample_shape, dtype)."""
    from . import fluid
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        if kind == "fc":
            x = fluid.layers.data(name="x", shape=[16], dtype="float32")
            h = fluid.layers.fc(input=x, size=32, act="relu")
            pred = fluid.layers.fc(input=h, size=10, act="softmax")
            shape = (16,)
        elif kind == "resnet":
            from .models.resnet import resnet_imagenet
            x = fluid.layers.data(name="x", shape=[224, 224, 3],
                                  dtype="float32")
            pred = resnet_imagenet(x, class_dim=1000, depth=50,
                                   is_train=False, layout="NHWC")
            shape = (224, 224, 3)
        else:
            raise ValueError("unknown model kind %r" % kind)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(model_dir, ["x"], [pred], exe, main)
    return model_dir, "x", shape, "float32"


def build_decode_model(model_dir, seed=7):
    """The JAX tool's tiny random-weight causal LM; eos_id=-1 keeps
    streams running to their budget, so the length mix (not the random
    weights) sets the output lengths."""
    from .inference.decode import build_tiny_decode_model
    return build_tiny_decode_model(
        model_dir, vocab_size=64, d_model=32, n_heads=4, n_layers=2,
        max_seq_len=64, eos_id=-1, seed=seed)


def _pct(vals, q):
    """The JAX tool's percentile: the sorted sample at floor(n q / 100)."""
    if not vals:
        return None
    return round(vals[min(int(len(vals) * q / 100.0), len(vals) - 1)], 3)


def _open_loop(target_qps, duration, seed, fire, join_s, n_requests=None):
    """Fire `fire(i, scheduled)` on a Poisson schedule for `duration` s
    (or for exactly `n_requests` arrivals), one thread per arrival;
    returns the wall seconds until all joined."""
    rng = random.Random(seed)
    threads = []
    t_start = time.monotonic()
    t_end = t_start + duration
    next_t = t_start
    i = 0
    while (next_t < t_end) if n_requests is None else (i < n_requests):
        now = time.monotonic()
        if next_t > now:
            time.sleep(next_t - now)
        th = threading.Thread(target=fire, args=(i, next_t), daemon=True)
        th.start()
        threads.append(th)
        i += 1
        next_t += rng.expovariate(target_qps)
    for th in threads:
        th.join(timeout=join_s)
    return time.monotonic() - t_start


def run_point(endpoint, model, feed_name, sample_shape, dtype,
              target_qps, duration, req_batch, deadline_ms, seed=0,
              precision=None, data=None):
    """One open-loop point at `target_qps` for `duration` s of requests
    of `req_batch` rows (`data`, or seeded normal rows).  `precision`
    pins every request to one numerics lane.

    `achieved_qps` is the JAX tool's: replies over the arrival window, so
    it follows the offered load and falls below the target only through
    sheds and failures.  `served_qps` is replies over the wall from the
    first scheduled arrival to the last reply: the rate the server kept
    up."""
    from .serving import DeadlineExceeded, ServerOverloaded, ServingClient
    if data is None:
        data = np.asarray(
            np.random.RandomState(seed).randn(req_batch, *sample_shape),
            dtype=dtype)
    lock = threading.Lock()
    latencies = []
    counters = {"ok": 0, "shed": 0, "deadline": 0, "error": 0}
    span = [float("inf"), float("-inf")]  # first arrival, last reply

    def fire(i, scheduled):
        # one connection per arrival: connecting counts against the
        # server, as in the JAX tool
        cli = ServingClient(endpoint)
        try:
            cli.infer(model, {feed_name: data}, deadline_ms=deadline_ms,
                      retry_sheds=False, precision=precision)
            key = "ok"
        except ServerOverloaded:
            key = "shed"
        except DeadlineExceeded:
            key = "deadline"
        except Exception:
            key = "error"
        finally:
            done = time.monotonic()
            cli.close()
        with lock:
            counters[key] += 1
            span[0] = min(span[0], scheduled)
            if key == "ok":
                latencies.append((done - scheduled) * 1000.0)
                span[1] = max(span[1], done)

    _open_loop(target_qps, duration, seed, fire,
               max(deadline_ms / 1000.0, 1.0) + 10.0)
    sent = sum(counters.values())
    with lock:
        ls = sorted(latencies)
    return {
        "metric": "serving_qps",
        "target_qps": target_qps,
        "sent": sent,
        "ok": counters["ok"],
        "achieved_qps": round(counters["ok"] / duration, 2),
        "served_qps": round(counters["ok"] / (span[1] - span[0]), 2)
        if counters["ok"] else 0.0,
        "shed_rate": round(counters["shed"] / sent, 4) if sent else 0.0,
        "deadline_rate": round(counters["deadline"] / sent, 4)
        if sent else 0.0,
        "errors": counters["error"],
        "p50_ms": _pct(ls, 50), "p95_ms": _pct(ls, 95),
        "p99_ms": _pct(ls, 99),
        "req_batch": int(data.shape[0]),
    }


def decode_request(seed, i, vocab, max_prompt=7):
    """Deterministic (prompt, max_new_tokens) for request `i`: the same
    workload in every lane, so lanes compare scheduling, not work."""
    rng = random.Random((seed << 20) ^ i)
    plen = rng.randint(2, max_prompt)
    prompt = [rng.randrange(1, vocab) for _ in range(plen)]
    r = rng.random()
    acc = 0.0
    max_new = DECODE_LEN_MIX[-1][0]
    for n, p in DECODE_LEN_MIX:
        acc += p
        if r <= acc:
            max_new = n
            break
    return prompt, max_new


def run_decode_point(endpoint, model, vocab, target_qps, duration,
                     deadline_ms, seed=0, requests=None, n_requests=None,
                     streams=None):
    """One open-loop streaming point: Poisson arrivals of generation
    requests (`requests(i)` -> (prompt, max_new), by default
    `decode_request`) for `duration` s, or exactly `n_requests` of them;
    reports streamed tokens/s, the completion rate and TTFT percentiles
    from the SCHEDULED arrival.  `streams`, a dict, receives each
    request's tokens under its index."""
    from .serving import DeadlineExceeded, ServerOverloaded, ServingClient
    if requests is None:
        def requests(i):
            return decode_request(seed, i, vocab)
    lock = threading.Lock()
    ttfts = []
    counters = {"ok": 0, "shed": 0, "deadline": 0, "error": 0}
    tokens_out = [0]

    def fire(i, scheduled):
        cli = ServingClient(endpoint)
        prompt, max_new = requests(i)
        first = None
        toks = []
        try:
            for chunk in cli.infer_stream(model, prompt,
                                          max_new_tokens=max_new,
                                          deadline_ms=deadline_ms):
                if first is None:
                    first = (time.monotonic() - scheduled) * 1000.0
                toks += chunk
            key = "ok"
        except ServerOverloaded:
            key = "shed"
        except DeadlineExceeded:
            key = "deadline"
        except Exception:
            key = "error"
        finally:
            cli.close()
        with lock:
            counters[key] += 1
            tokens_out[0] += len(toks)
            if first is not None:
                ttfts.append(first)
            if streams is not None:
                streams[i] = toks

    wall = _open_loop(target_qps, duration, seed, fire,
                      max(deadline_ms / 1000.0, 1.0) + 30.0,
                      n_requests=n_requests)
    sent = sum(counters.values())
    with lock:
        ts = sorted(ttfts)
    return {
        "metric": "serving_decode",
        "target_qps": target_qps,
        "sent": sent,
        "ok": counters["ok"],
        "shed": counters["shed"],
        "deadline": counters["deadline"],
        "errors": counters["error"],
        "completion_rate": round(counters["ok"] / sent, 4)
        if sent else 0.0,
        "achieved_qps": round(counters["ok"] / wall, 2),
        "tokens_per_sec": round(tokens_out[0] / wall, 2),
        "tokens_total": tokens_out[0],
        "ttft_p50_ms": _pct(ts, 50),
        "ttft_p95_ms": _pct(ts, 95),
        "ttft_p99_ms": _pct(ts, 99),
    }


def verify_bit_exact(endpoint, model, direct, feed_name, shape, dtype,
                     n=3, seed=123, precision=None):
    """Replay `n` seeded requests of 1..n rows through the server and
    through `direct` (a Predictor on the same artifact, device and
    buckets): every reply must be bit-equal."""
    from .serving import ServingClient
    rng = np.random.RandomState(seed)
    cli = ServingClient(endpoint)
    try:
        for i in range(n):
            x = rng.randn(1 + i, *shape).astype(dtype)
            served = cli.infer(model, {feed_name: x}, deadline_ms=60000.0,
                               precision=precision)
            ref = direct.run({feed_name: x})
            if len(served) != len(ref) or any(
                    not np.array_equal(a, b) for a, b in zip(served, ref)):
                return False
        return True
    finally:
        cli.close()


def verify_decode_bit_exact(endpoint, model, pred, seed, vocab, n=3):
    """Replay `n` prompts through the served continuous batch and a
    direct single-slot greedy decode on `pred` (the same artifact, device
    and cache dtype): joining a running batch must not move one token."""
    from .inference.decode import greedy_decode
    from .serving import ServingClient
    cli = ServingClient(endpoint)
    try:
        for i in range(n):
            prompt, max_new = decode_request(seed + 7000, i, vocab)
            served = [t for c in cli.infer_stream(
                model, prompt, max_new_tokens=max_new,
                deadline_ms=120000.0) for t in c]
            if served != greedy_decode(pred, prompt, max_new)[0]:
                return False
        return True
    finally:
        cli.close()


def _backend(device):
    import torch
    if device == "cpu":
        return "cpu"
    return torch.cuda.get_device_name(0)


def _points(spec):
    return [s.strip() for s in str(spec).split(",") if s.strip()]


def run_image_lane(args, kind, qps_points, duration, buckets):
    """--model fc|resnet: one server, one model, an open-loop point per
    QPS, each record with the bit-exact replay and the server's stats."""
    from .inference import AnalysisConfig, Predictor
    from .serving import InferenceServer, ServingClient
    workdir = tempfile.mkdtemp(prefix="bench_serving_")
    model_dir, feed_name, shape, dtype = build_model(
        kind, os.path.join(workdir, kind))
    t_boot = time.monotonic()
    server = InferenceServer(max_queue=args.max_queue,
                             deadline_ms=args.deadline_batch_ms,
                             buckets=buckets, replicas=args.device).start()
    boot = ServingClient(server.endpoint)
    try:
        loaded = boot.load_model(kind, model_dir, buckets=buckets)
        boot.infer(kind, {feed_name: np.zeros((1,) + shape, dtype)},
                   deadline_ms=60000.0)
        cold_start_ms = round((time.monotonic() - t_boot) * 1e3, 1)
        t_flip = time.monotonic()
        boot.load_model(kind, model_dir, buckets=buckets)
        swap_flip_ms = round((time.monotonic() - t_flip) * 1e3, 1)
        cfg = AnalysisConfig(model_dir, device=args.device)
        cfg.batch_size_buckets = tuple(buckets)
        bit_exact = verify_bit_exact(server.endpoint, kind,
                                     Predictor(cfg), feed_name, shape,
                                     dtype)
        for q in qps_points:
            rec = run_point(server.endpoint, kind, feed_name, shape,
                            dtype, target_qps=q, duration=duration,
                            req_batch=args.req_batch,
                            deadline_ms=args.deadline_ms)
            stats = boot.stats()["stats"]["models"].get(kind, {})
            rec.update({
                "model": kind, "buckets": buckets,
                "replicas": int(loaded.get("replicas", 1)),
                "devices": loaded.get("devices", []),
                "bit_exact": bool(bit_exact),
                "cold_start_ms": cold_start_ms,
                "swap_flip_ms": swap_flip_ms,
                "batch_fill": stats.get("batch_fill"),
                "bucket_fill_ratio": stats.get("bucket_fill_ratio"),
                "shed_total": stats.get("shed"),
                "replica_stats": stats.get("replicas"),
                "backend": _backend(args.device),
            })
            print(json.dumps(rec), flush=True)
    finally:
        boot.close()
        server.shutdown(drain=True)


def run_precision_lanes(args, kind, qps_points, duration, buckets):
    """--precision: PTQ the exported model into its int8 twin, load both
    lanes behind ONE model name, and drive the same seeded points
    through each requested lane (the per-request precision field)."""
    from . import fluid
    from .inference import (AnalysisConfig, Predictor,
                            quantize_inference_model)
    from .serving import InferenceServer, ServingClient
    lanes = {"fp32": ["fp32"], "int8": ["int8"],
             "both": ["fp32", "int8"]}[args.precision]
    workdir = tempfile.mkdtemp(prefix="bench_serving_quant_")
    model_dir, feed_name, shape, dtype = build_model(
        kind, os.path.join(workdir, kind))
    rng = np.random.RandomState(17)
    calib = [{feed_name: rng.randn(buckets[0], *shape).astype(dtype)}
             for _ in range(4)]
    summary = quantize_inference_model(
        model_dir, calib_feeds=calib,
        place=fluid.CPUPlace() if args.device == "cpu" else None)
    server = InferenceServer(max_queue=args.max_queue,
                             deadline_ms=args.deadline_batch_ms,
                             buckets=buckets, replicas=args.device).start()
    boot = ServingClient(server.endpoint)
    try:
        paths = {"fp32": model_dir, "int8": summary["dst"]}
        for lane in ("fp32", "int8"):
            boot.load_model(kind, paths[lane], buckets=buckets)
        for lane in lanes:
            cfg = AnalysisConfig(paths[lane], device=args.device)
            cfg.batch_size_buckets = tuple(buckets)
            bit_exact = verify_bit_exact(server.endpoint, kind,
                                         Predictor(cfg), feed_name,
                                         shape, dtype, precision=lane)
            for q in qps_points:
                rec = run_point(server.endpoint, kind, feed_name, shape,
                                dtype, target_qps=q, duration=duration,
                                req_batch=args.req_batch,
                                deadline_ms=args.deadline_ms,
                                precision=lane)
                key = kind if lane == "fp32" else "%s@%s" % (kind, lane)
                st = boot.stats()["stats"]["models"].get(key, {})
                rec.update({
                    "model": kind, "precision": lane, "buckets": buckets,
                    "bit_exact": bool(bit_exact),
                    "quant_bytes": dict(summary.get("bytes", {})),
                    "lane_requests": st.get("requests"),
                    "lane_latency_p95":
                        (st.get("latency_ms") or {}).get("p95"),
                    "backend": _backend(args.device),
                })
                print(json.dumps(rec), flush=True)
    finally:
        boot.close()
        server.shutdown(drain=True)


def run_decode_lane(args, qps_points, duration):
    """--decode: a fresh server per (spec_k, kv dtype, fuse_steps) point
    of the sweeps, the same seeded arrivals and prompts in each; every
    point first replays prompts against a direct greedy decode."""
    from .inference.decode import GenerativePredictor
    from .serving import InferenceServer, ServingClient
    vocab = 64
    workdir = tempfile.mkdtemp(prefix="bench_serving_decode_")
    model_dir = build_decode_model(os.path.join(workdir, "lm"))
    spec_points = [int(s) for s in _points(args.spec_k)] \
        if args.spec_k else [0]
    fuse_points = [int(s) for s in _points(args.fuse_steps)] \
        if args.fuse_steps else [1]
    kv_points = {"fp32": ["float32"], "int8": ["int8"],
                 "both": ["float32", "int8"]}[args.kv_dtype]
    for spec_k, kv_dtype, fuse in [(s, kv, f) for s in spec_points
                                   for kv in kv_points
                                   for f in fuse_points]:
        server = InferenceServer(max_queue=args.max_queue,
                                 replicas=args.device).start()
        boot = ServingClient(server.endpoint)
        try:
            t_boot = time.monotonic()
            loaded = boot.load_model(
                "lm", model_dir, decode_slots=args.decode_slots,
                draft=model_dir if spec_k > 0 else None,
                spec_k=spec_k, kv_cache_dtype=kv_dtype, fuse_steps=fuse)
            cold_start_ms = round((time.monotonic() - t_boot) * 1e3, 1)
            direct = GenerativePredictor(model_dir, device=args.device,
                                         kv_cache_dtype=kv_dtype)
            bit_exact = verify_decode_bit_exact(server.endpoint, "lm",
                                                direct, seed=11,
                                                vocab=vocab)
            for q in qps_points:
                rec = run_decode_point(server.endpoint, "lm", vocab,
                                       target_qps=q, duration=duration,
                                       deadline_ms=args.deadline_ms,
                                       seed=3)
                st = boot.stats()["stats"]["models"].get("lm", {})
                slots = int(loaded.get("decode_slots", 0)) * \
                    int(loaded.get("replicas", 1))
                rec.update({
                    "model": "tiny_lm",
                    "decode_slots": int(loaded.get("decode_slots", 0)),
                    "replicas": int(loaded.get("replicas", 1)),
                    "bit_exact": bool(bit_exact),
                    "cold_start_ms": cold_start_ms,
                    "slot_occupancy": st.get("slot_occupancy"),
                    "decode_steps": st.get("decode_steps"),
                    "fuse_steps": int(loaded.get("fuse_steps", 1)),
                    "decode_dispatches": st.get("decode_dispatches"),
                    "tokens_per_dispatch": round(
                        st.get("decode_tokens", 0)
                        / float(st["decode_dispatches"]), 3)
                    if st.get("decode_dispatches") else None,
                    "server_tokens_per_sec": st.get("tokens_per_sec"),
                    "len_mix": [list(m) for m in DECODE_LEN_MIX],
                    "spec_k": spec_k,
                    "accept_rate": st.get("spec_accept_rate"),
                    "kv_cache_dtype": loaded.get("kv_cache_dtype"),
                    "kv_cache_bytes": st.get("kv_cache_bytes"),
                    "tokens_per_sec_per_slot": round(
                        rec["tokens_per_sec"] / slots, 3)
                    if slots else None,
                    "backend": _backend(args.device),
                })
                print(json.dumps(rec), flush=True)
        finally:
            boot.close()
            server.shutdown(drain=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="fc", choices=["fc", "resnet"])
    ap.add_argument("--device", default="cuda",
                    help="where the server's models run: 'cuda' (the "
                         "card, default) or 'cpu' (the plain path)")
    ap.add_argument("--qps", default=None,
                    help="comma-separated target-QPS sweep (default "
                         "50,200; smoke 100; decode 8)")
    ap.add_argument("--duration", type=float, default=None,
                    help="seconds per point (default 10, smoke 2, "
                         "decode 6)")
    ap.add_argument("--req_batch", type=int, default=1,
                    help="rows per client request")
    ap.add_argument("--max_bucket", type=int, default=None,
                    help="largest batch bucket; the set is {max/4, "
                         "max/2, max} (default 32, smoke 8)")
    ap.add_argument("--deadline_ms", type=float, default=None,
                    help="per-request deadline (default 2000; decode "
                         "60000, covering the whole stream)")
    ap.add_argument("--deadline_batch_ms", type=float, default=None,
                    help="the batcher's coalescing window (default "
                         "FLAGS.serving_batch_deadline_ms)")
    ap.add_argument("--max_queue", type=int, default=None)
    ap.add_argument("--precision", choices=["fp32", "int8", "both"],
                    default=None,
                    help="PTQ the model into its int8 twin, load both "
                         "lanes behind one name, drive the named lanes")
    ap.add_argument("--decode", action="store_true",
                    help="the streaming-generation lane (infer_stream)")
    ap.add_argument("--decode_slots", type=int, default=4)
    ap.add_argument("--kv_dtype", choices=["fp32", "int8", "both"],
                    default="fp32", help="the decode lanes' KV cache")
    ap.add_argument("--fuse_steps", default=None,
                    help="fused-decode sweep, e.g. '1,8'")
    ap.add_argument("--spec_k", default=None,
                    help="speculative sweep of draft depths, e.g. '0,4' "
                         "(the draft is the same artifact)")
    ap.add_argument("--smoke", action="store_true",
                    help="the tiny fc model, one short point")
    for flag in ("--mesh", "--fleet", "--topology", "--compile_cache_dir"):
        ap.add_argument(flag, default=None, help="not ported (raises)")
    ap.add_argument("--chaos_proxy", action="store_true",
                    help="not ported (raises)")
    ap.add_argument("--chaos_slow_ms", type=float, default=0.0,
                    help="not ported (raises)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    for name, what in _WAITING_LANES.items():
        if getattr(args, name):
            raise NotImplementedError(
                "bench_serving --%s: %s is not ported to paddle_tpu_torch "
                "yet" % (name, what))
    if args.decode:
        if args.deadline_ms is None:
            args.deadline_ms = 60000.0
        qps = [float(q) for q in _points(args.qps)] if args.qps else [8.0]
        run_decode_lane(args, qps, 6.0 if args.duration is None
                        else args.duration)
        return
    if args.deadline_ms is None:
        args.deadline_ms = 2000.0
    kind = args.model
    qps = [float(q) for q in _points(args.qps)] if args.qps \
        else [50.0, 200.0]
    duration = 10.0 if args.duration is None else args.duration
    max_bucket = 32 if args.max_bucket is None else args.max_bucket
    if args.smoke:
        kind = "fc"
        if args.qps is None:
            qps = [100.0]
        if args.duration is None:
            duration = 2.0
        if args.max_bucket is None:
            max_bucket = 8
    buckets = sorted({max(max_bucket // 4, 1), max(max_bucket // 2, 1),
                      max_bucket})
    if args.precision:
        run_precision_lanes(args, kind, qps, duration, buckets)
    else:
        run_image_lane(args, kind, qps, duration, buckets)


if __name__ == "__main__":
    main()
