#!/usr/bin/env python3
"""Chip smoke for paddle_tpu_torch, the PyTorch/CUDA port: the quickest
proof that the port builds, agrees with itself, serves and trains on a
GPU.

    python3 chip_smoke.py          # from the repo root, one NVIDIA GPU

Phases, in order; any failure exits non-zero:
  1. build   — nvcc builds every CUDA kernel from paddle_tpu_torch/ops/
               csrc into paddle_tpu_torch/build/ (one nvcc per source, all
               at once); prints the build time and the card's name and
               power limit (nvidia-smi).
  2. kernels — each kernel against its plain PyTorch version on the card
               at its path's shapes (K3 at the decode shapes; K1 and the
               two K2 kernels at the training slice's shape, a non-causal
               and a ragged shape); times kernel, plain version and the
               PyTorch library yardstick with CUDA events, beside the
               kernel's bound.
  3. slice   — the decode-serving path at the full width of the repo's
               transformer (vocab 32000, d_model 512, 8 heads, 6 layers,
               max_seq_len 512; random weights from seed 7): a
               DecodeBatcher with 8 slots answers 16 concurrent requests;
               every stream must equal single-request greedy decode
               bit-exactly, the kernel's launch count must equal decode
               steps x layers, and freed slots must be zero; then a
               torch.profiler window over decode steps with all 8 slots
               live splits a step's time by kernel.
  4. gpu/cpu — one 64-token prompt, prefill + 8 steps on the card and on
               the CPU: KV caches agree, tokens are identical.
  5. train   — the training path at the transformer's full width
               (`models.transformer.get_model()` defaults: batch 8 x seq
               512, vocab 32000, d_model 512, 8 heads, 6 layers, d_ff
               2048, Adam lr 1e-3; startup seed 7): fluid.Executor on
               CUDAPlace(0) runs the startup program, then 10 Adam steps
               on one seeded batch; the loss must be finite and fall, and
               K1, K2-dq and K2-dkv must launch 6 times each per step.
               Prints tokens/s, step ms, peak memory and a torch.profiler
               breakdown of one step.
  6. train gpu/cpu — a small transformer (2 layers, d_model 128, 2 heads
               of 64, seq 96, dropout 0) from one startup scope carried
               across: 2 steps on the card and on the CPU, losses agree.
Prints a {"kernels": [...]} line and, last, the device line
{"ok": true, "device": {...}}.  Without CUDA, or without the repo around
it, it exits non-zero and prints no result.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM published peaks: HBM3 bandwidth and fp32 (non-tensor-core) rate
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
FULL_WIDTH = dict(vocab_size=32000, d_model=512, n_heads=8, n_layers=6,
                  max_seq_len=512, eos_id=-1, seed=7)
N_SLOTS = 8
N_REQUESTS = 16
# ~1 ms at the H100's ~1.98 GHz boost clock: longer than the host takes
# to enqueue any timed function here
SPIN_CYCLES = 2_000_000


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise SystemExit("chip_smoke FAILED: %s" % msg)


def median_ms(torch, fn, flush, reps=60, warmup=5):
    """Median device time of fn() in ms over `reps` launches, CUDA
    events around each; the L2 cache is flushed before every launch, as
    the decode step finds it (six layers' caches and the weights exceed
    L2).  A spin kernel holds the stream while the host enqueues the
    events and fn's kernels, so host dispatch gaps inside a multi-kernel
    fn are not counted as device time."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in times]))


def decode_attention_bound(lengths, S, H, D):
    """Least time for the function on these inputs: every byte it must
    move once (q, the live K/V rows — all S V rows for a length-0 slot —
    lengths, out) over HBM bandwidth, or its flops over the fp32 peak,
    whichever is larger."""
    nbytes = 2 * len(lengths) * H * D * 4 + 4 * len(lengths)
    flops = 0
    for n in lengths:
        live = min(max(int(n), 0), S)
        nbytes += (2 * live if live else S) * H * D * 4
        flops += 4 * (live or S) * H * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes


def phase_kernels(torch, pk):
    import torch.nn.functional as F
    rng = np.random.RandomState(0)
    N, S, H, D = N_SLOTS, 512, 8, 64
    cases = [
        ("main mixed", N, S, H, D,
         [0, 1, 511, 512] + list(rng.randint(2, 511, size=N - 4))),
        ("main full", N, S, H, D, [S] * N),
        ("ragged", 3, 80, 2, 64, [0, 80, 41]),
    ]
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.float32,
                        device="cuda")
    max_err = 0.0
    entry = None
    for name, n, s, h, d, lens in cases:
        q = torch.randn(n, h, d, device="cuda")
        k = torch.randn(n, s, h, d, device="cuda")
        v = torch.randn(n, s, h, d, device="cuda")
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        scale = 1.0 / np.sqrt(d)
        out = pk.decode_attention(q, k, v, lengths, scale=scale)
        ref = pk.decode_attention_reference(q, k, v, lengths, scale=scale)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), "%s: non-finite" % name)
        err = float((out - ref).abs().max())
        ok = bool(((out - ref).abs() <= 1e-5 + 1e-5 * ref.abs()).all())
        check(ok, "decode_attention %s disagrees with the plain version "
              "(max abs err %.3g, rtol 1e-5 atol 1e-5)" % (name, err))
        max_err = max(max_err, err)
        ms = median_ms(torch, lambda: pk.decode_attention(
            q, k, v, lengths, scale=scale), flush)
        plain_ms = median_ms(torch, lambda: pk.decode_attention_reference(
            q, k, v, lengths, scale=scale), flush)
        # the library yardstick: SDPA over the same cache with a length
        # mask (timed here only; the port never calls it)
        q4, k4, v4 = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
        mask = (torch.arange(s, device="cuda")[None, :]
                < lengths[:, None])[:, None, None, :]
        lib_ms = median_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask, scale=scale), flush)
        bound_ms, bound_by, nbytes = decode_attention_bound(lens, s, h, d)
        log("kernel decode_attention [%s] N=%d S=%d H=%d D=%d: max abs "
            "err %.3g; kernel %.4f ms, plain %.4f ms, SDPA %.4f ms, "
            "bound %.4f ms (%s, %d bytes) -> %.1f%% of bound"
            % (name, n, s, h, d, err, ms, plain_ms, lib_ms, bound_ms,
               bound_by, nbytes, 100.0 * bound_ms / ms))
        if name == "main full":
            entry = {"name": "decode_attention", "route": "cuda",
                     "source":
                         "paddle_tpu_torch/ops/csrc/decode_attention.cu",
                     "replaces": "paddle_tpu/ops/pallas_kernels.py:570",
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_ms}
    del flush
    entry["max_abs_err"] = max_err
    return entry


def flash_bound(kind, B, S, H, D, causal):
    """Least time for one K1 / K2-dq / K2-dkv call: every byte it must move
    once (its [B, S, H, D] operands and [B, H, S] row statistics) over HBM
    bandwidth, or its flops over the fp32 peak, whichever is larger.  The
    flops are 2 D per live (query, key) pair for each D-long product the
    function needs: 2 for the forward (q.k, p.v), 3 for dq (q.k, do.v,
    ds.k), 4 for dk/dv (q.k, do.v, p.do, ds.q)."""
    pairs = S * (S + 1) // 2 if causal else S * S
    heads, elems = B * H, B * S * H * D
    products, tensors, rowstats = {"fwd": (2, 4, 1), "dq": (3, 5, 2),
                                   "dkv": (4, 6, 2)}[kind]
    flops = 2 * D * pairs * heads * products
    nbytes = 4 * (tensors * elems + rowstats * heads * S)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, flops


def phase_flash_kernels(torch, pk):
    """K1 and both K2 kernels against their plain versions at the training
    slice's shape (q/k/v as column slices of one fused qkv tensor, as the
    program hands them over), a non-causal and a ragged shape; then
    device times at the slice's shape."""
    import torch.nn.functional as F
    cases = [("slice", 8, 512, 8, 64, True),
             ("non-causal", 4, 256, 4, 64, False),
             ("ragged", 2, 200, 2, 128, True)]
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.float32,
                        device="cuda")
    errs = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    entries = {}
    g = torch.Generator(device="cuda").manual_seed(5)
    for name, B, S, H, D, causal in cases:
        qkv = torch.randn(B, S, 3 * H * D, device="cuda", generator=g)
        q, k, v = (qkv[..., i * H * D:(i + 1) * H * D].reshape(B, S, H, D)
                   for i in range(3))
        o, lse = pk.flash_attention_fwd(q, k, v, causal)
        ro, rlse = pk.flash_attention_fwd_reference(q, k, v, causal)
        do = torch.randn(B, S, H, D, device="cuda", generator=g)
        di = pk._flash_di(ro, do)
        dq = pk.flash_attention_bwd_dq(q, k, v, do, rlse, di, causal)
        dk, dv = pk.flash_attention_bwd_dkv(q, k, v, do, rlse, di, causal)
        rdq = pk.flash_attention_bwd_dq_reference(q, k, v, do, rlse, di,
                                                  causal)
        rdk, rdv = pk.flash_attention_bwd_dkv_reference(q, k, v, do, rlse,
                                                        di, causal)
        torch.cuda.synchronize()
        for what, got, want in (("o", o, ro), ("lse", lse, rlse)):
            err = float((got - want).abs().max())
            check(bool(((got - want).abs()
                        <= 1e-5 + 1e-5 * want.abs()).all()),
                  "flash %s %s disagrees with the plain version (max abs "
                  "err %.3g, rtol 1e-5 atol 1e-5)" % (name, what, err))
            errs["fwd"] = max(errs["fwd"], err)
        # the gradients sum over S in another order: atol scaled by size
        for kind, what, got, want in (("dq", "dq", dq, rdq),
                                      ("dkv", "dk", dk, rdk),
                                      ("dkv", "dv", dv, rdv)):
            err = float((got - want).abs().max())
            atol = 1e-4 * float(want.abs().max())
            check(bool(((got - want).abs()
                        <= atol + 1e-4 * want.abs()).all()),
                  "flash %s %s disagrees with the plain version (max abs "
                  "err %.3g, atol %.3g = 1e-4 max|%s|, rtol 1e-4)"
                  % (name, what, err, atol, what))
            errs[kind] = max(errs[kind], err)
        # end to end: autograd through K1 + K2 against autograd through
        # the plain forward, on the same cotangent
        kin = [t.detach().requires_grad_(True) for t in (q, k, v)]
        rin = [t.detach().requires_grad_(True) for t in (q, k, v)]
        kgrads = torch.autograd.grad(
            pk.flash_attention(*kin, causal=causal), kin, do)
        rgrads = torch.autograd.grad(
            pk.flash_attention_reference(*rin, causal=causal), rin, do)
        auto_err = 0.0
        for what, got, want in zip(("dq", "dk", "dv"), kgrads, rgrads):
            err = float((got - want).abs().max())
            atol = 1e-4 * float(want.abs().max())
            check(bool(((got - want).abs()
                        <= atol + 1e-4 * want.abs()).all()),
                  "flash %s autograd %s disagrees with the plain version's "
                  "autograd (max abs err %.3g, atol %.3g, rtol 1e-4)"
                  % (name, what, err, atol))
            auto_err = max(auto_err, err)
        log("kernel flash_attention [%s] B=%d S=%d H=%d D=%d causal=%s: "
            "max abs err o %.3g lse %.3g dq %.3g dk %.3g dv %.3g; "
            "autograd K1+K2 vs plain autograd %.3g"
            % (name, B, S, H, D, causal, float((o - ro).abs().max()),
               float((lse - rlse).abs().max()),
               float((dq - rdq).abs().max()), float((dk - rdk).abs().max()),
               float((dv - rdv).abs().max()), auto_err))
        if name != "slice":
            continue
        # timings at the slice's shape; the yardstick is SDPA in fp32
        # (timed here only; the port never calls it)
        ms = {"fwd": median_ms(torch, lambda: pk.flash_attention_fwd(
                  q, k, v, causal), flush),
              "dq": median_ms(torch, lambda: pk.flash_attention_bwd_dq(
                  q, k, v, do, rlse, di, causal), flush),
              "dkv": median_ms(torch, lambda: pk.flash_attention_bwd_dkv(
                  q, k, v, do, rlse, di, causal), flush)}
        plain = {"fwd": median_ms(torch, lambda: pk.
                                  flash_attention_fwd_reference(
                                      q, k, v, causal), flush),
                 "dq": median_ms(torch, lambda: pk.
                                 flash_attention_bwd_dq_reference(
                                     q, k, v, do, rlse, di, causal), flush),
                 "dkv": median_ms(torch, lambda: pk.
                                  flash_attention_bwd_dkv_reference(
                                      q, k, v, do, rlse, di, causal),
                                  flush)}
        qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        sdpa_fwd = median_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=causal), flush)
        so = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
        sdo = do.transpose(1, 2)
        sdpa_bwd = median_ms(torch, lambda: torch.autograd.grad(
            so, (qs, ks, vs), sdo, retain_graph=True), flush)
        sdpa_err = float((so.detach().transpose(1, 2) - ro).abs().max())
        log("kernel flash_attention [slice]: SDPA fp32 forward %.4f ms, "
            "backward %.4f ms (dq, dk, dv in one call), forward+backward "
            "%.4f ms; SDPA vs plain o max abs err %.3g"
            % (sdpa_fwd, sdpa_bwd, sdpa_fwd + sdpa_bwd, sdpa_err))
        names = {"fwd": ("flash_attention_fwd",
                         "paddle_tpu_torch/ops/csrc/flash_attention_fwd.cu",
                         "paddle_tpu/ops/pallas_kernels.py:243", sdpa_fwd),
                 "dq": ("flash_attention_bwd_dq",
                        "paddle_tpu_torch/ops/csrc/flash_attention_bwd.cu",
                        "paddle_tpu/ops/pallas_kernels.py:362", sdpa_bwd),
                 "dkv": ("flash_attention_bwd_dkv",
                         "paddle_tpu_torch/ops/csrc/flash_attention_bwd.cu",
                         "paddle_tpu/ops/pallas_kernels.py:414", sdpa_bwd)}
        for kind, (kname, src, rep, lib_ms) in names.items():
            bound_ms, bound_by, nbytes, flops = flash_bound(
                kind, B, S, H, D, causal)
            log("kernel %s [slice] B=%d S=%d H=%d D=%d causal: kernel "
                "%.4f ms, plain %.4f ms, SDPA %.4f ms, bound %.4f ms (%s; "
                "%d bytes, %d flops) -> %.1f%% of bound, %.1f TFLOP/s"
                % (kname, B, S, H, D, ms[kind], plain[kind], lib_ms,
                   bound_ms, bound_by, nbytes, flops,
                   100.0 * bound_ms / ms[kind], flops / ms[kind] / 1e9))
            entries[kind] = {"name": kname, "route": "cuda", "source": src,
                             "replaces": rep, "ms": ms[kind],
                             "plain_ms": plain[kind], "bound_ms": bound_ms,
                             "bound_by": bound_by, "library_ms": lib_ms}
    del flush
    for kind, e in entries.items():
        e["max_abs_err"] = errs[kind]
    return [entries["fwd"], entries["dq"], entries["dkv"]]


def profile_rows(torch, prof, steps):
    """(device ms per step, [(us per step, launches per step, name)]) from
    a torch.profiler window of `steps` steps, largest first."""
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((us / steps, e.count / steps, e.key))
    rows.sort(reverse=True)
    return sum(r[0] for r in rows) / 1e3, rows


def phase_slice(torch, pk, decode, batcher, art):
    t0 = time.time()
    pred = decode.load_decode_predictor(art)
    log("slice: loaded predictor on %s in %.2f s (%d param bytes, KV "
        "cache %d bytes at %d slots)" % (pred.device, time.time() - t0,
                                         pred.param_bytes(),
                                         pred.kv_cache_bytes(N_SLOTS),
                                         N_SLOTS))
    check(pred.device.type == "cuda", "predictor not on the card")
    rng = np.random.RandomState(1234)
    V = pred.vocab_size
    prompts = [[int(t) for t in rng.randint(0, V, size=rng.randint(8, 201))]
               for _ in range(N_REQUESTS)]
    budgets = [int(rng.randint(16, 65)) for _ in range(N_REQUESTS)]
    # warm-up: cuBLAS handles, allocator, the prefill buckets' shapes
    for n in sorted({pred.prompt_bucket(len(p)) for p in prompts}):
        decode.greedy_decode(pred, [1] * n, 2, n_slots=N_SLOTS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    pk.reset_launch_counts()
    b = batcher.DecodeBatcher(pred, n_slots=N_SLOTS)
    t0 = time.perf_counter()
    streams = [b.submit(p, max_new_tokens=m)
               for p, m in zip(prompts, budgets)]
    outs = [s.result(timeout=600)[0].tolist() for s in streams]
    wall = time.perf_counter() - t0
    b.close()
    launches = pk.launch_counts["decode_attention"]
    lane = b.lane_stats()
    steps, step_s = lane["steps"], lane["step_s"]
    peak = torch.cuda.max_memory_allocated()
    n_layers = FULL_WIDTH["n_layers"]
    check(steps > 0, "no decode step ran")
    check(launches == steps * n_layers,
          "decode_attention launched %d times for %d steps x %d layers"
          % (launches, steps, n_layers))
    check(all(b.session.slot_is_zero(s) for s in range(N_SLOTS)),
          "a freed slot still holds K/V")
    tokens = sum(len(o) for o in outs)
    check(all(len(o) == m for o, m in zip(outs, budgets)),
          "a stream ended before its budget")
    check(all(0 <= t < V for o in outs for t in o), "token out of vocab")
    # every batched stream equals single-request greedy decode, bit-exact,
    # at the same slot-table size
    for i, (p, m, o) in enumerate(zip(prompts, budgets, outs)):
        ref, _ = decode.greedy_decode(pred, p, m, n_slots=N_SLOTS)
        if o != ref:
            first = next((j for j, (a, r) in enumerate(zip(o, ref))
                          if a != r), min(len(o), len(ref)))
            check(False, "request %d: batched stream diverged from "
                  "single-request decode at token %d" % (i, first))
    stats = {"requests": N_REQUESTS, "slots": N_SLOTS,
             "generated_tokens": tokens, "wall_s": wall,
             "tokens_per_s": tokens / wall, "decode_steps": steps,
             "step_ms": step_s / steps * 1e3,
             "decode_attention_launches": launches,
             "peak_mem_bytes": peak,
             "prompt_lens": [len(p) for p in prompts],
             "max_new_tokens": budgets}
    log("slice: %d requests, %d tokens in %.3f s: %.1f tokens/s, %d "
        "decode steps at %.3f ms/step, %d decode_attention launches, "
        "peak memory %.1f MiB; all streams bit-exact vs single-request "
        "decode" % (N_REQUESTS, tokens, wall, stats["tokens_per_s"],
                    steps, stats["step_ms"], launches, peak / 2 ** 20))
    log(json.dumps({"slice": stats}))
    return pred, launches


def phase_profile(torch, pred, steps=20):
    """Where a decode step's time goes with all 8 slots live (128-token
    prompts): host wall per step without the profiler, then the device
    time per step by kernel under torch.profiler over the same steps."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.RandomState(7)
    sess = pred.new_session(N_SLOTS)
    for s in range(N_SLOTS):
        sess.prefill(s, [int(t) for t in rng.randint(
            0, pred.vocab_size, size=128)])
    for _ in range(3):
        sess.decode()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        sess.decode()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            sess.decode()
        torch.cuda.synchronize()
    device_ms, rows = profile_rows(torch, prof, steps)
    if not rows:
        log("profile: torch.profiler saw no device time; device busy "
            "share not measured (host %.3f ms/step)" % step_ms)
        return
    log("profile: %d decode steps at 8 live slots: host %.3f ms/step, "
        "device busy %.3f ms/step (%.1f%% of the step; idle %.1f%%)"
        % (steps, step_ms, device_ms, 100 * device_ms / step_ms,
           100 - 100 * device_ms / step_ms))
    for us, count, key in rows[:10]:
        log("profile:   %9.2f us/step  %5.1f launches/step  %s"
            % (us, count, key[:110]))
    log(json.dumps({"profile": {
        "steps": steps, "host_step_ms": step_ms,
        "device_busy_ms_per_step": device_ms,
        "top": [{"kernel": k[:160], "us_per_step": us,
                 "launches_per_step": c} for us, c, k in rows[:10]]}}))


def phase_gpu_vs_cpu(torch, decode, art, gpu_pred):
    prompt = [int(t) for t in np.random.RandomState(99).randint(
        0, gpu_pred.vocab_size, size=64)]
    cpu_pred = decode.GenerativePredictor(art, device="cpu")
    runs = {}
    for name, pred in (("gpu", gpu_pred), ("cpu", cpu_pred)):
        sess = pred.new_session(1)
        toks = [sess.prefill(0, prompt)]
        for _ in range(8):
            toks.append(int(sess.decode()[0]))
        runs[name] = (toks, sess._kc.cpu(), sess._vc.cpu())
    (gt, gk, gv), (ct, ck, cv) = runs["gpu"], runs["cpu"]
    # the CPU's top-2 logit margin at each generated position
    seq = torch.tensor([prompt + ct], dtype=torch.int64)
    x, _, _ = cpu_pred.model(seq)
    logits = cpu_pred.model.lnf(x[0]) @ cpu_pred.model.lm_head
    top2 = torch.topk(logits, 2, dim=-1).values
    margins = (top2[:, 0] - top2[:, 1]).numpy()
    live = len(prompt) + len(ct) - 1
    for j, (a, c) in enumerate(zip(gt, ct)):
        if a != c:
            margin = float(margins[len(prompt) - 1 + j])
            check(margin < 1e-4, "gpu/cpu token %d differs (%d vs %d) at "
                  "a CPU top-2 margin of %.3g" % (j, a, c, margin))
            log("gpu/cpu: token %d differs (%d vs %d) at a CPU top-2 "
                "logit margin of %.3g < 1e-4 — a near tie, not a fault"
                % (j, a, c, margin))
            live = len(prompt) + j
            break
    for name, a, c in (("K", gk, ck), ("V", gv, cv)):
        a, c = a[:, :, :live], c[:, :, :live]
        err = float((a - c).abs().max())
        check(bool(((a - c).abs() <= 1e-4 + 1e-4 * c.abs()).all()),
              "gpu/cpu %s caches disagree (max abs err %.3g, rtol 1e-4 "
              "atol 1e-4)" % (name, err))
        log("gpu/cpu: %s cache max abs err %.3g over %d positions"
            % (name, err, live))
    log("gpu/cpu: tokens gpu %s cpu %s" % (gt, ct))


TRAIN_STEPS = 10
TRAIN_SEED = 7


def _batch(rng, batch, seq, vocab):
    """One seeded next-token batch: labels are the tokens shifted by one."""
    tokens = rng.randint(0, vocab, size=(batch, seq + 1)).astype(np.int64)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def _kernel_group(key):
    """Which part of the step a device kernel belongs to, by its name."""
    if "paddle_flash" in key:
        return "K1/K2 flash attention"
    for tag in ("gemm", "gemv", "splitKreduce"):
        if tag in key:
            return "matmul (cuBLAS/CUTLASS, fp32)"
    for tag, group in (("SoftMax", "log_softmax"),
                       ("reduce_kernel", "reductions"),
                       ("index", "gather/scatter"),
                       ("embedding", "gather/scatter"),
                       ("elementwise", "elementwise"),
                       ("Memset", "memset/copy"), ("Memcpy", "memset/copy"),
                       ("copy", "memset/copy")):
        if tag in key:
            return group
    return "other"


def phase_train(torch, pk, fluid, transformer):
    """The training path at full width: startup, then TRAIN_STEPS Adam
    steps on one repeated seeded batch (the loss has to fall).  Launch
    counts are zeroed just before the steps and read just after."""
    from torch.profiler import ProfilerActivity, profile
    main, startup, _, avg_loss, _, _ = transformer.get_model()
    startup.random_seed = TRAIN_SEED
    B, S = 8, 512
    n_layers = 6
    exe = fluid.Executor(fluid.CUDAPlace(0))
    check(exe.device.type == "cuda", "executor not on the card")
    scope = fluid.Scope()
    feed = _batch(np.random.RandomState(TRAIN_SEED), B, S, 32000)
    with fluid.scope_guard(scope):
        t0 = time.time()
        exe.run(startup)
        torch.cuda.synchronize()
        n_params = sum(int(np.prod(p.shape))
                       for p in main.all_parameters())
        log("train: startup on %s in %.2f s (%d parameters, %d persistable "
            "tensors)" % (exe.device, time.time() - t0, n_params,
                          len(list(scope.keys()))))
        torch.cuda.reset_peak_memory_stats()
        pk.reset_launch_counts()
        losses, step_s = [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            loss, = exe.run(main, feed=feed, fetch_list=[avg_loss])
            step_s.append(time.perf_counter() - t0)
            losses.append(float(loss))
        counts = dict(pk.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        log("train: losses %s" % ["%.5f" % x for x in losses])
        check(all(np.isfinite(losses)), "non-finite training loss")
        check(losses[-1] < losses[0] - 0.1 and min(losses[-3:]) < losses[0],
              "the loss did not fall over %d steps on one batch: %s"
              % (TRAIN_STEPS, losses))
        for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv"):
            check(counts[name] == n_layers * TRAIN_STEPS,
                  "%s launched %d times in %d steps x %d layers"
                  % (name, counts[name], TRAIN_STEPS, n_layers))
        check(counts["decode_attention"] == 0,
              "decode_attention launched on the training path")
        steady = sorted(step_s[1:])
        step_ms = float(np.median(steady)) * 1e3
        stats = {"batch": B, "seq": S, "steps": TRAIN_STEPS,
                 "losses": losses, "step_ms": [x * 1e3 for x in step_s],
                 "median_step_ms": step_ms,
                 "tokens_per_s": B * S / (step_ms / 1e3),
                 "first_step_ms": step_s[0] * 1e3,
                 "launches": counts, "peak_mem_bytes": peak}
        log("train: %d steps of %d tokens: median step %.3f ms (first "
            "%.1f ms) -> %.1f tokens/s; launches per step: K1 %g, K2-dq "
            "%g, K2-dkv %g; peak memory %.1f MiB"
            % (TRAIN_STEPS, B * S, step_ms, step_s[0] * 1e3,
               stats["tokens_per_s"],
               counts["flash_attention_fwd"] / TRAIN_STEPS,
               counts["flash_attention_bwd_dq"] / TRAIN_STEPS,
               counts["flash_attention_bwd_dkv"] / TRAIN_STEPS,
               peak / 2 ** 20))
        log(json.dumps({"train": stats}))

        # where one step's time goes
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            exe.run(main, feed=feed, fetch_list=[avg_loss])
            prof_step_ms = (time.perf_counter() - t0) * 1e3
    device_ms, rows = profile_rows(torch, prof, 1)
    if not rows:
        log("train profile: torch.profiler saw no device time; device "
            "busy share not measured")
        return counts
    n_launches = sum(r[1] for r in rows)
    n_ops = len(main.global_block().ops)
    log("train profile: one step, host %.3f ms under the profiler (%.3f "
        "ms without): %d program ops, %d kernel launches, device busy "
        "%.3f ms = %.1f%% of the unprofiled step (idle %.1f%%)"
        % (prof_step_ms, step_ms, n_ops, n_launches, device_ms,
           100 * device_ms / step_ms, 100 - 100 * device_ms / step_ms))
    groups = {}
    for us, count, key in rows:
        g = groups.setdefault(_kernel_group(key), [0.0, 0])
        g[0] += us
        g[1] += count
    for name, (us, count) in sorted(groups.items(), key=lambda x: -x[1][0]):
        log("train profile:   %10.2f us  %5d launches  [%s]"
            % (us, count, name))
    for us, count, key in rows[:15]:
        log("train profile:   %10.2f us  %5d launches  %s"
            % (us, count, key[:110]))
    log(json.dumps({"train_profile": {
        "host_step_ms": step_ms, "device_busy_ms": device_ms,
        "program_ops": n_ops, "launches": n_launches,
        "groups": {k: {"us": v[0], "launches": v[1]}
                   for k, v in groups.items()},
        "top": [{"kernel": k[:160], "us": us, "launches": c}
                for us, c, k in rows[:15]]}}))
    return counts


def phase_train_gpu_vs_cpu(torch, fluid, transformer):
    """A small transformer from one startup scope, carried across: two
    Adam steps on the card and on the CPU give the same losses."""
    kw = dict(batch_size=2, seq_len=96, vocab_size=256, d_model=128,
              n_heads=2, n_layers=2, d_ff=256)
    main, startup, _, avg_loss, _, _ = transformer.get_model(**kw)
    for op in main.global_block().ops:
        if op.type == "dropout":
            op.attrs["dropout_prob"] = 0.0
    startup.random_seed = TRAIN_SEED
    cpu = fluid.CPUPlace()
    cpu_scope = fluid.Scope()
    with fluid.scope_guard(cpu_scope):
        fluid.Executor(cpu).run(startup)
    init = fluid.scope_to_jax(cpu_scope)
    gpu_scope = fluid.scope_from_jax(init, fluid.Scope(),
                                     fluid.CUDAPlace(0))
    feed = _batch(np.random.RandomState(3), 2, 96, 256)
    losses = {}
    for name, place, scope in (("gpu", fluid.CUDAPlace(0), gpu_scope),
                               ("cpu", cpu, cpu_scope)):
        exe = fluid.Executor(place)
        with fluid.scope_guard(scope):
            losses[name] = [float(exe.run(main, feed=feed,
                                          fetch_list=[avg_loss])[0])
                            for _ in range(2)]
    # matmuls and attention sum in other orders on the two devices
    err = max(abs(a - c) / abs(c) for a, c in zip(losses["gpu"],
                                                   losses["cpu"]))
    check(err <= 1e-4, "train gpu/cpu losses disagree: gpu %s cpu %s "
          "(max rel err %.3g > 1e-4)" % (losses["gpu"], losses["cpu"], err))
    log("train gpu/cpu: losses gpu %s cpu %s, max rel err %.3g (tolerance "
        "1e-4)" % (losses["gpu"], losses["cpu"], err))


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available on this host",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.inference import decode
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import pallas_kernels as pk
    from paddle_tpu_torch.serving import batcher

    log("torch %s, CUDA %s, python %s" % (torch.__version__,
                                         torch.version.cuda,
                                         sys.version.split()[0]))
    # 1. build
    t0 = time.time()
    libs = _build.build_all()
    log("build: %d CUDA libraries in %.2f s: %s"
        % (len(libs), time.time() - t0, sorted(libs.values())))
    for stem, out in sorted(_build.build_logs.items()):
        log("nvcc %s:\n%s" % (stem, out.strip()))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(smi)
    # 2. kernels against their plain versions
    entry = phase_kernels(torch, pk)
    flash_entries = phase_flash_kernels(torch, pk)
    # 3. the decode-serving slice at full width
    with tempfile.TemporaryDirectory() as tmp:
        art = os.path.join(tmp, "lm")
        t0 = time.time()
        decode.build_tiny_decode_model(art, **FULL_WIDTH)
        log("slice: built the full-width artifact in %.2f s"
            % (time.time() - t0))
        pred, launches = phase_slice(torch, pk, decode, batcher, art)
        entry["launches"] = launches
        phase_profile(torch, pred)
        # 4. the port on the card against the port on the CPU
        phase_gpu_vs_cpu(torch, decode, art, pred)
    del pred
    torch.cuda.empty_cache()
    # 5. the training slice at full width, 6. and on the card vs the CPU
    counts = phase_train(torch, pk, fluid, transformer)
    for e in flash_entries:
        e["launches"] = counts[e["name"]]
    phase_train_gpu_vs_cpu(torch, fluid, transformer)
    log(smi)
    log(json.dumps({"kernels": [entry] + flash_entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
