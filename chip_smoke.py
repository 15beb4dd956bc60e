#!/usr/bin/env python3
"""Chip smoke for paddle_tpu_torch, the PyTorch/CUDA port: the quickest
proof that the port builds, agrees with itself, serves and trains on a
GPU.

    python3 chip_smoke.py          # from the repo root, one NVIDIA GPU

Phases, in order; any failure exits non-zero:
  1. build   — nvcc builds every CUDA kernel from paddle_tpu_torch/ops/
               csrc into paddle_tpu_torch/build/ (one nvcc per source, all
               at once); prints the build time and the card's name and
               power limit (nvidia-smi); then cuobjdump -sass of the
               libraries, tensor-core instructions counted by input
               type: the bf16 K1/K2/K6 kernels and the bf16-x K5 kernels
               must hold bf16 HMMA/HGMMA only, fp32 K1, K2 and K6
               (3xTF32) and the fp32-x K5 (two TF32 products) TF32 HMMA
               only.
  2. kernels — each kernel against its plain PyTorch version on the card
               at its path's shapes (K3 and K4 at the decode shapes and
               at lengths around their blocks' edges (each splits a row
               over a cluster: blocks and positions per block logged),
               each row bit for bit against the row launched alone; K3
               also at every cluster size, timed, and as the verify
               step's 5 pseudo-slots per slot, bit for bit against the
               plain step; K4's head-slice entry at 1, 2 and 4 local
               heads, also bit for bit against the full-table K4; K1
               (3xTF32 tensor cores, its TFLOP/s printed) and the two
               K2 kernels at the training slice's shape, a non-causal and
               a ragged shape); times kernel, plain version and the
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
     int8    — the same 16 requests with `kv_cache_dtype="int8"`: streams
               bit-exact against int8 single-request decode, K4 launches =
               steps x layers and no K3, freed slots int8 zeros, measured
               cache bytes = the closed form, first tokens = the fp32
               lane's; tokens/s, step ms, fp32-vs-int8 agreement, profile.
     spec    — the same 16 requests, fp32 target with its int8 twin as
               draft (k = 4): committed streams bit-exact against fp32
               greedy decode, K3 launches = layers x (verify + plain
               rounds), K4 = layers x draft steps; whether a batched
               verify would round like the step (it does not: the port
               verifies per chunk position); then 4 requests with an fp32
               twin draft (accept rate exactly 1.0) and with a mismatched
               draft (2 layers, seed 101: rolls back on most rounds,
               streams still exact).
     fused   — fused N-step decode: the CUDA graph of an 8-step window
               against the eager masked loop, bit for bit, with an EOS
               mid-window and a max_trips clamp; then the fp32, int8 and
               speculative lanes unfused and fused (fuse_steps 8), three
               alternated pairs of runs of the same 16 requests each:
               fused streams equal the unfused ones, freed slots are
               zero, K3/K4 launches equal the graphs' warm-ups and
               replays (plus the eager plain rounds); tokens/s, ms per
               dispatch and step, dispatches and host round trips per
               token, masked trips, peak memory and a profile of 20 fused
               windows or rounds beside 20 unfused ones; an fp32 twin
               draft is accepted whole in fused rounds.
  4. gpu/cpu — one 64-token prompt, prefill + 8 steps on the card and on
               the CPU: KV caches agree, tokens are identical; for the
               int8 predictor the scales are equal and at most 1e-3 of
               the live int8 cache elements are one count apart.
  5. train   — the training path at the transformer's full width
               (`models.transformer.get_model()` defaults: batch 8 x seq
               512, vocab 32000, d_model 512, 8 heads, 6 layers, d_ff
               2048, Adam lr 1e-3; startup seed 7): fluid.Executor on
               CUDAPlace(0) runs the startup program, then 10 Adam steps
               on one seeded batch; the loss must be finite and fall, and
               K1, K2-dq and K2-dkv must launch 6 times each per step.
               Prints tokens/s, step ms, peak memory and a torch.profiler
               breakdown of one step.
     train amp — the same under `fluid.set_amp(True)` (bf16 AMP): the
               bf16 K1, K2-dq and K2-dkv launch 6 times each per step and
               no fp32 one; the loss falls; every parameter stays fp32.
  6. train gpu/cpu — a small transformer (2 layers, d_model 128, 2 heads
               of 64, seq 96, dropout 0) from one startup scope carried
               across: 2 steps on the card and on the CPU, losses agree.
  6b. trainer — the Fluid training runtime: fluid.contrib.Trainer trains
               the full-width transformer (the network get_model builds,
               fp32, batch 8 x 512) one epoch of 8 seeded host batches,
               sync (depth 0) and async (FLAGS.async_dispatch_depth 2,
               FLAGS.reader_prefetch_depth 2), each in a new Trainer from
               the same startup state.  Gates: bit-identical losses and
               state; fp32 K1, K2-dq and K2-dkv 6 x 8 launches each in the
               async run; every async dispatch passes under
               torch.cuda.set_sync_debug_mode("error"); a run stopped
               after 4 steps with a CheckpointConfig and resumed in a new
               Trainer gives the uninterrupted losses; the anomaly
               sentinel's skip of a NaN batch (a fed loss scale, dropout
               0) with 2 steps in flight leaves the state bit-equal to a
               run without that batch.  Prints steps/s and the device
               busy share (profiled again) of the sync and async runs.
  6d. update region — the full-width transformer (models.transformer.
               build, fp32, batch 8 x 512, dropout 0) trained 5 steps on
               one batch with noam_decay(512, 4000), Adam (0.9, 0.98,
               1e-9) and set_gradient_clip(GradientClipByGlobalNorm(1.0),
               program=main), then the same under AMP.  Gates: finite,
               falling losses, the LR read back each step equal to the closed
               form (1e-6), the clipped gradients' global norm at most
               1 + 1e-5, K1/K2 6 x 5 launches each in the lane's dtype.
               Prints steps/s, median step ms and the busy share.  Then
               a bag-of-words classifier over a sparse 32000 x 512 table
               (embedding(is_sparse=True): a SelectedRows grad), batch 8
               x 512 ids, mean-pooled, fc, softmax cross entropy, 3 steps
               under SGD, Momentum, Adam, Adam lazy, Adagrad, RMSProp,
               Adamax, Adadelta, DecayedAdagrad, Ftrl and LarsMomentum on
               the card and on the CPU from one startup state: losses
               within 1e-5, every persistable within 1e-5 of its array's
               largest magnitude; the sparse SGD program's state equal to
               the dense program's on the card (1e-5).
  7. resnet  — ResNet-50 inference through the user's entry points
               (models.resnet.get_model(is_train=False, layout="NHWC"),
               224 x 224, 1000 classes; startup seed 7, seeded batch-norm
               statistics): Executor.run(startup) on the card,
               save_inference_model, then create_paddle_predictor at
               batches 1, 8 and 64 — fp32 with
               FLAGS.fuse_bottleneck_max_width = 128 (7 K6 launches per
               run) and unfused (gate 0, no K6), which must agree; then
               quantize_inference_model with 4 seeded calibration batches
               and the int8 Predictor (1 K5 launch per run).  Prints
               images/s, ms per run, launches, device busy share and
               profiler groups per lane and batch.
     resnet bf16 — the same artifact on the JAX package's bf16 serving
               route (tools/bench_infer.py): load, InferenceTranspiler
               (fold in fp32), every fp32 persistable cast to bf16, the
               feed retyped to bfloat16, fluid.Executor on the card at
               batches 1, 8 and 64 — fused at gate 128 (7 K6-bf16
               launches per run, no fp32 K6) and unfused (gate 0), which
               must agree; images/s, ms per run, busy share, peak memory,
               and agreement with the fp32 lane as numbers.
  8. resnet gpu/cpu — a ResNet-50 artifact at 32 x 32 input: the fused
               Predictor on the card and on the CPU agree; and its bf16
               route on the card and on the CPU agree.
     serving — the serving front end over the wire: the port's
               InferenceServer on 127.0.0.1:0 with its models on cuda:0,
               driven by its ServingClient through bench_serving's
               open-loop functions.  Models: `resnet50`, the phase-7
               artifact loaded at FLAGS.fuse_bottleneck_max_width = 128
               with buckets (1, 8, 32), and its int8 PTQ twin as the
               `precision` lane; `lm` (fp32 KV) and `lm8` (int8 KV), the
               decode artifact rebuilt at the slice's full width, 8
               slots, fuse_steps 8.  Open-loop Poisson image points at
               25, 100 and 200 QPS (3 s each) and an int8-lane point at
               25 QPS, driven by a load generator in a process of its
               own (no client thread shares the server's interpreter
               lock), then the slice's 16 seeded streams on each of `lm`
               and `lm8`, then a 100-QPS image point under
               torch.profiler.  Gates: no error and no expired deadline
               at any image point, no shed either at the 25-QPS points;
               K6, K5, K3 and K4 each launched through the server; every
               stream token-identical to the earlier phases' streams;
               image replies bit-equal to a direct Predictor.run at the
               same bucket (fp32 and int8).  Prints served and offered
               QPS, p50/p95/p99 ms and the server's mean stage ms per point,
               decode tokens/s and TTFT, the device busy share of the
               profiled point, the phase's seconds.
  9. resnet train — ResNet-50 training through the user's entry points
               at the bench's shapes (paddle_tpu_torch/bench.py:
               get_model(is_train=True, layout="NHWC"), 224 x 224, batch
               256, 1000 classes, Momentum 0.9 + L2Decay(1e-4), lr 0.1;
               startup seed 7; 4 rotating seeded batches): four lanes
               from one startup state, per-op and whole-graph AD, fp32
               and AMP, each 2 warm-up and 10 timed steps, then whole-
               graph AMP under block_out remat.  Every loss finite; the
               first 3 losses of the per-op and whole-graph lanes agree
               (fp32 1e-4, AMP 2e-2); every state stays fp32 and the
               moving statistics move; no hand kernel launches (K5, K6);
               remat keeps the first loss and lowers the peak memory; 10
               per-op fp32 steps on one batch lower the loss.  Prints
               images/s, median step ms, ops and launches per step, busy
               share, peak memory, a profile split by group and the
               bench JSON line per lane.
 10. resnet train gpu/cpu — a small bottleneck ResNet-50 (32 x 32, batch
               16, 10 classes): two Momentum steps on the card and on the
               CPU, the first losses within 1e-4, and every op of both
               steps on the CPU's inputs within a Frobenius error of 1e-4.
 11. zoo     — the benchmark/fluid zoo through the port's fluid_benchmark
               (paddle_tpu_torch/fluid_benchmark.py) at its published
               cells: VGG-16 CIFAR-10 (batch 128, NCHW), SE-ResNeXt-50
               32x4d (batch 64, 224 x 224, NHWC; Momentum, piecewise
               decay, L2Decay) and stacked_dynamic_lstm (batch 64, dict
               5147, 512 wide, 3 layers; ragged LoDTensor feeds, lengths
               3-11 and 64-256).  Lanes per op fp32 and AMP (and
               whole-graph AMP for SE-ResNeXt), 2 + 20 steps each:
               examples/s, median step ms, busy share, peak memory, ops
               and launches a step, the largest device groups.  Gates:
               finite losses; no hand kernel launches; the LR counter
               advances once a step (also under block_out remat); the
               fetched LSTM hidden is a LoDTensor with the feed's
               lengths; 10 steps on one batch lower the loss; per-op and
               whole-graph agree bit for bit over 3 steps (fp32,
               deterministic cuDNN).
 12. zoo gpu/cpu — the three models at a small size from one startup
               state: first losses on the card and on the CPU within
               1e-4; the small LSTM's 3 losses and persistables within
               1e-5.
 12b. pipeline — python -m paddle_tpu_torch.fluid_benchmark --model
               resnet (whole-graph AMP, NHWC, batch 32, 20 iterations)
               with --host_stall_ms 20, once with --prefetch_depth 2
               --async_depth 2 and once without: finite losses; prints
               images/s, the busy share and whether the stall was
               hidden.
 13. parallel — data-parallel ResNet-50 training (full width, 224 x 224,
               32 images a card, fp32, Momentum 0.01 + L2Decay; startup
               seed 7) through the collective DistributeTranspiler and the
               ParallelExecutor: one NCCL rank per visible card (this
               script re-run as `--parallel-rank DIR` by
               paddle_tpu_torch.parallel.mesh.launch; a world of one on a
               one-card machine, said on its first line), 3 steps.  Gates:
               every rank exits 0 on its own card; finite losses, equal
               on every rank; every rank's moving statistics equal; 53
               sync-BN all-reduces a step each way; the losses within
               1e-5 (first step) and 2e-2 (all three) of the single-card
               Executor's on the same global batch (deterministic cuDNN).
               Prints the world, the gradient buckets and bytes, the
               gradient all-reduce's ms a step and the collectives a step
               by kind.  A failed rank fails the script.
 14. control flow — small programs with sub-blocks (a while running an
               fc through 3 trips, a StaticRNN, a ragged DynamicRNN and
               an IfElse, each with its backward) from one startup state
               on the card and on the CPU: the loss within 1e-5 and every
               parameter's gradient within 1e-4 of its largest magnitude.
 15. mt train — fluid_benchmark --model machine_translation at the JAX
               tool's cell (embedding, encoder and decoder 512, dict
               30000, Adam 2e-4, batch 32, lengths 3-11: T 16), per-op
               fp32 and AMP, 2 + 10 steps each: examples/s, median step
               ms, ops and launches a step, busy share, peak memory.
               Gates: finite losses; 8 steps on one batch lower the loss;
               one step dispatched under set_sync_debug_mode("warn")
               syncs nowhere inside `recurrent` (the decoder's step loop)
               or its grad; the small model (widths 32) 3 Adam steps on
               the card and on the CPU: losses within 1e-4, every
               parameter within 1e-5 of its array's largest magnitude
               (the spread one embedding ulp makes on the CPU logged
               beside it).
     mt generate — beam search from that trained scope at batch 32 x
               beam 3, max length 8, full width: ids in range, beams
               ranked, each source alone equal to the batched run (or a
               tie of scores within 1e-5); the small model's generation
               on the card equal to the CPU's (ids; scores within 1e-5).
 16. text conv — the book's sentiment conv net (06.understand_sentiment
               convolution_net) through fluid.layers and fluid.nets at its
               published widths: embedding [5147, 128] (is_sparse), two
               sequence_conv_pool (512 filters, widths 3 and 4, tanh,
               sqrt pool), fc(2, softmax), cross entropy, Adagrad(0.002);
               batch 128, lengths in [8, 120] drawn as the imdb reader
               draws them (synthesized here).  The first step on the card
               and on the CPU from one startup state: the loss within
               1e-5 and every dense gradient within 1e-5 of its largest
               magnitude; then 10 steps on the card: finite, falling
               losses; examples/s, median step ms, launches a step, busy
               share.
     mha     — nets.scaled_dot_product_attention at the transformer's
               widths (B 8, T 512, d 512, 8 heads), forward and its
               gradients to q, k and v: card against CPU (1e-5 of each
               array's largest magnitude); ms a call.
     core ops — every op case of tests/torch_op_cases.py's CORE_CASES (
               the repaired gather, saturating casts and tie gradients,
               the math, tensor, nn and sequence_conv ops; the families
               of 17 run there) forward and vjp on the card against the
               CPU from the same inputs (1e-5), with no device-side
               assert.
 17. text gru — the text-classification GRU net (PaddlePaddle/models
               text_classification nets.py gru_net) through fluid.layers
               at its widths: embedding [5147, 128] at 30x the rate, fc to
               384, dynamic_gru(128), max pool, tanh, fc(96, tanh),
               fc(2, softmax), cross entropy, Adagrad(0.002); text conv's
               batches (128, lengths in [8, 120]).  The first step on the
               card and on the CPU from one startup state (the loss within
               1e-5, every dense gradient, the table's too, within 1e-5 of
               its largest magnitude), then 10 steps on the card: finite,
               falling losses, no hand-kernel launch; examples/s, median
               step ms, launches a step, busy share.
     seq ops — every case of tests/torch_op_cases.py's SEQ_OP_CASES (the
               flat sequence ops, sequence_scatter, sequence_expand_as,
               row_conv, lod_reset, lrn, the recurrent family and the
               fused recurrent ops) forward and vjp on the card against
               the CPU (1e-5); then a mid-size lstmp (B 32, T 64, D 1024,
               P 512) and a reverse gru (B 64, T 128, H 128), ragged,
               forward and vjp within 1e-5 of each array's largest
               magnitude, and their ms a call on the card.
     reader  — ResNet-50 training (bench.build, batch 256, NHWC,
               whole-graph AMP, deterministic cuDNN) from one startup
               state over bench.staged_batches' 4 seeded batches in four
               passes, through four feed lanes: (a) host feeds to
               exe.run, twice, (b) create_py_reader_by_data with the
               double buffer staging on the card, (c) open_files over a
               RecordIO file of the same batches (the model built on
               read_file's vars), (d) the batches staged on the card
               beforehand; images/s, median step, busy share a lane; the
               losses of (b), (c), (d) within (a)'s own run-to-run
               spread.  Every persistable through an in-graph
               save_combine and back through load_combine, bit for bit,
               the file read by numpy.load too.  The fused fp32
               Predictor on 64 images read back through
               reader.creator.recordio: K6 launches, probabilities equal
               to the in-memory feed's.
     nested  — a hierarchical document encoder (32000 words at width
               256, fc, nested_to_outer, a DynamicRNN over the sentences,
               fc(2)) trains a few steps on 32 documents of 2-16
               sentences of 4-40 words; its first step card vs CPU (loss
               and every gradient within 1e-6 of its largest magnitude,
               the embedding's through nested_to_outer_grad); then the
               kmax_seq_score -> sub_nested_seq selection and
               sequence_expand with a nested Y, card vs CPU.
     profiler— `python -m paddle_tpu_torch.fluid_benchmark --model resnet
               --profile` in a temporary directory: the printed table
               holds the host events and CUDA kernel rows, and the
               exported trace is JSON with traceEvents.
Phase 2 also holds the coverage cases against their plain versions,
at the shapes the coverage paths of 6c give the kernels: K1/K2 at head
dims 32, 96, 192 and 256 (fp32 and bf16, zero-padded along D to 64 /
128 / 256, 256 as it is in the 32-row-tile instantiation; batch 4 x seq
256, 16, 8, 4 and 4 heads, q/k/v sliced from one fused qkv), K3/K4 at
head dims 48, 50, 96, 192 and 256 (a runtime D in the 64 / 128 / 256
template, caches read in place; 4 slots x 128 positions, 8 heads, 4 at
192 and 256), K6-bf16 at C/F/C4 60/20/84 (padded to multiples of 8);
each is a kernels-line row of its own.  6c drives the user paths at
those head dims — the transformer's training (fp32 and AMP) at head
dims 32, 96, 192 and 256 and decode serving (fp32 and int8 KV, tokens
equal to the CPU's) at 48, 50, 96, 192 and 256 — and their launches
are the coverage rows'.
Phase 2 also holds K5 (dequant_matmul) and K6 (fused_bottleneck) against
their plain versions: K5 at the int8 lane's fc shape (bf16 x and fp32 x)
and four others, K6
at ResNet-50's four stage geometries (batch 32), two odd shapes and the
fused path's four geometries at batch 64; and the bf16 variants of K1,
K2 and K6 against their bf16 plain versions at the same shapes, timed
beside SDPA in bf16 and the cuDNN bf16 convolution chain.
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

# H100 SXM published peaks: HBM3 bandwidth; fp32 on the SIMT units; and
# fp32-accurate products on the TF32 tensor cores, 495 TFLOP/s over the
# three products of 3xTF32 — the least time fp32 work can take on the
# card, so every fp32 operation bound is taken at that rate (the SIMT
# bound is printed beside it)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
FP32_ACCURATE_FLOP_PER_S = TF32_FLOP_PER_S / 3
FULL_WIDTH = dict(vocab_size=32000, d_model=512, n_heads=8, n_layers=6,
                  max_seq_len=512, eos_id=-1, seed=7)
N_SLOTS = 8
N_REQUESTS = 16
SPEC_K = 4
# the fused lanes' window (steps per dispatch), and the fused/unfused
# pairs of runs per lane, alternated
FUSE_STEPS = 8
FUSED_PAIRS = 3
# ~1 ms at the H100's ~1.98 GHz boost clock: longer than the host takes
# to enqueue any timed function here
SPIN_CYCLES = 2_000_000
# The coverage shapes: head dims and channel edges off the kernels'
# instantiated widths, as the user paths of phase 6c hand them over.  The
# transformer's training at batch x seq COVER_TRAIN_BS, (D, d_model,
# heads): K1/K2 run zero-padded along D to 64 / 128 / 256, scaled by the
# original D (256 runs the 32-row-tile instantiation as it is)
COVER_TRAIN_BS = (4, 256)
COVER_TRAIN = ((32, 512, 16), (96, 768, 8), (192, 768, 4), (256, 1024, 4))
# decode serving on COVER_SLOTS slots of COVER_SEQ positions, (D,
# d_model, heads): K3/K4 take a runtime D beside the template's and read
# the caches in place (D 50 is not a multiple of their 4- and 16-element
# loads; 192 runs in the 256 template, whose lanes load 8 elements)
COVER_SLOTS, COVER_SEQ = 4, 128
COVER_SERVE = ((48, 384, 8), (50, 400, 8), (96, 768, 8), (192, 768, 4),
               (256, 1024, 4))
# The update region's slice (phase 6d): the full-width transformer
# trained NOAM_STEPS steps with noam_decay(512, NOAM_WARMUP), Adam (0.9,
# 0.98, 1e-9) and GradientClipByGlobalNorm(CLIP_NORM), fp32 then AMP;
# then a bag-of-words classifier over a sparse SPARSE_VOCAB x SPARSE_DIM
# table (the transformer's), batch SPARSE_BATCH x SPARSE_T ids, trained
# SPARSE_STEPS steps under each optimizer of SPARSE_OPTIMIZERS
NOAM_STEPS = 5
NOAM_WARMUP = 4000
CLIP_NORM = 1.0
SPARSE_VOCAB, SPARSE_DIM = 32000, 512
SPARSE_BATCH, SPARSE_T, SPARSE_CLASSES = 8, 512, 10
SPARSE_STEPS = 3
SPARSE_SEED = 13
SPARSE_OPTIMIZERS = (
    ("SGD", lambda o: o.SGD(0.5)),
    ("Momentum", lambda o: o.Momentum(0.2, 0.9)),
    # The epsilons that divide a step (Adam's, Adamax's, Adagrad's and
    # DecayedAdagrad's) are set so that lr / epsilon is 1e4 or less: an
    # element whose gradient is below epsilon steps by ~lr * g /
    # epsilon, which turns the card's and the CPU's fp32 summation-order
    # differences in g into differences of the table's elements.  At
    # the defaults (Adam 0.01 / 1e-8, Adagrad 0.1 / 1e-6) those reached
    # 1.06e-5 and 4.78e-5 of the table's largest magnitude, on the H100
    ("Adam", lambda o: o.Adam(0.01, epsilon=1e-6)),
    ("Adam lazy", lambda o: o.Adam(0.01, epsilon=1e-6, lazy_mode=True)),
    ("Adagrad", lambda o: o.Adagrad(0.1, epsilon=1e-4)),
    ("RMSProp", lambda o: o.RMSProp(0.01, momentum=0.5)),
    ("Adamax", lambda o: o.Adamax(0.01, epsilon=1e-6)),
    ("Adadelta", lambda o: o.Adadelta(1.0)),
    ("DecayedAdagrad", lambda o: o.DecayedAdagrad(0.1, epsilon=1e-4)),
    ("Ftrl", lambda o: o.Ftrl(0.1, l1=1e-4, l2=1e-4)),
    ("LarsMomentum", lambda o: o.LarsMomentum(0.5, 0.9)),
)
# K6-bf16 at a channel edge that is not a multiple of 8 (C, F and C4
# zero-padded to 64, 24 and 88): N, H, W, C, F, C4, stride, branch
COVER_K6 = (8, 28, 28, 60, 20, 84, 2, True)


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


def decode_attention_bound(lengths, S, H, D, elem=4, q_per_slot=1,
                           scale_heads=0):
    """Least time for the function on these inputs: every byte it must
    move once (q, the live K/V rows at `elem` bytes an element — all S V
    rows for a length-0 row — lengths, out, and the `scale_heads` heads'
    int8 scales) over HBM bandwidth, or its flops over the fp32 peak,
    whichever is larger.  With `q_per_slot` > 1 the rows of one cache
    slot's pseudo-slots are counted once, at the longest of them."""
    P = len(lengths)
    nbytes = 2 * P * H * D * 4 + 4 * P + 2 * scale_heads * 4
    flops = 0
    lives = [min(max(int(n), 0), S) for n in lengths]
    for p in range(0, P, q_per_slot):
        group = lives[p:p + q_per_slot]
        k_rows = max(group)
        v_rows = S if 0 in group else k_rows
        nbytes += (k_rows + v_rows) * H * D * elem
    for live in lives:
        flops += 4 * (live or S) * H * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_ACCURATE_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes


def _cover_row(entry, row, count, path, err):
    """`entry` as a coverage row of the kernels line: its name suffixed
    by `row`, its own max abs error; `count` (its launch counter) and
    `path` (the coverage path of phase 6c that launches it, or None)
    fill in its `launches` once the paths have run."""
    entry.update(name=count + row, max_abs_err=err, count=count, path=path)
    return entry


def _cover_decode_cases():
    """K3/K4 cases at the coverage serving path's shapes: (name, N, S, H,
    D, lengths, the kernels-line row's suffix)."""
    S = COVER_SEQ
    return [("cover D %d" % D, COVER_SLOTS, S, heads, D,
             [0, 1, S // 2 + 13, S], " [D %d]" % D)
            for D, _, heads in COVER_SERVE]


def phase_kernels(torch, pk, cover):
    """K3 against its plain version at the decode shapes and at lengths
    around the edges of its blocks' shares (K3 splits each row's
    positions over a cluster of blocks: the plan is logged per case),
    each row bit for bit against the same row launched alone, each case
    timed; then the verify step's pseudo-slots.  The coverage cases (the
    serving path's slots, positions and heads at COVER_SERVE's head dims)
    append their kernels-line rows to `cover`."""
    import torch.nn.functional as F
    rng = np.random.RandomState(0)
    N, S, H, D = N_SLOTS, 512, 8, 64
    share = pk.decode_attention_f32_plan(S, D)["share"]
    # the last field: None, a check; "", the kernels line's row; else a
    # coverage row's suffix
    cases = [
        ("main mixed", N, S, H, D,
         [0, 1, 511, 512] + list(rng.randint(2, 511, size=N - 4)), None),
        ("main full", N, S, H, D, [S] * N, ""),
        ("ragged", 3, 80, 2, 64, [0, 80, 41], None),
        ("boundaries", N, S, H, D,
         [0, 1, share - 1, share, share + 1, S - 1, S, S // 2 + 1], None),
    ] + _cover_decode_cases()
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.float32,
                        device="cuda")
    # the floor of every kernel time below: one launch that does nothing
    # (a one-element fill), timed the same way
    one = torch.empty(1, device="cuda")
    log("timing floor: an empty launch takes %.4f ms under median_ms"
        % median_ms(torch, one.zero_, flush))
    max_err = 0.0
    entry = None
    for name, n, s, h, d, lens, row in cases:
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
        if not row:
            max_err = max(max_err, err)
        plan = pk.decode_attention_f32_plan(s, d)
        alone = all(torch.equal(pk.decode_attention(
            q[i:i + 1].clone(), k[i:i + 1].clone(), v[i:i + 1].clone(),
            lengths[i:i + 1].clone(), scale=scale)[0], out[i])
            for i in range(n))
        check(alone, "K3 %s: a row of the batched call differs from the "
              "row launched alone" % name)
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
            "bound %.4f ms (%s, %d bytes) -> %.1f%% of bound; split over "
            "a cluster of %d blocks, %d positions each; rows bit-exact vs "
            "alone %s"
            % (name, n, s, h, d, err, ms, plain_ms, lib_ms, bound_ms,
               bound_by, nbytes, 100.0 * bound_ms / ms, plan["cluster"],
               plan["share"], alone))
        if row is None:
            continue
        e = {"name": "decode_attention", "route": "cuda",
             "source": "paddle_tpu_torch/ops/csrc/decode_attention.cu",
             "replaces": "paddle_tpu/ops/pallas_kernels.py:570",
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": lib_ms}
        if row:
            cover.append(_cover_row(e, row, "decode_attention",
                                    ("serve", d), err))
        else:
            entry = e
    # the speculative verify step: C = SPEC_K + 1 chunk positions of each
    # slot attend as pseudo-slots over that slot's cache, read in place
    C = SPEC_K + 1
    base = [0, 1, S - C, 250] + list(rng.randint(2, S - C, size=N - 4))
    lens = [b + j + 1 for b in base for j in range(C)]
    q = torch.randn(N * C, H, D, device="cuda")
    k = torch.randn(N, S, H, D, device="cuda")
    v = torch.randn(N, S, H, D, device="cuda")
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    scale = 1.0 / np.sqrt(D)
    out = pk.decode_attention(q, k, v, lengths, scale=scale, q_per_slot=C)
    ref = pk.decode_attention_reference(q, k, v, lengths, scale=scale,
                                        q_per_slot=C)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    check(bool(((out - ref).abs() <= 1e-5 + 1e-5 * ref.abs()).all()),
          "decode_attention q_per_slot=%d disagrees with the plain version "
          "(max abs err %.3g, rtol 1e-5 atol 1e-5)" % (C, err))
    max_err = max(max_err, err)
    ms = median_ms(torch, lambda: pk.decode_attention(
        q, k, v, lengths, scale=scale, q_per_slot=C), flush)
    plain_ms = median_ms(torch, lambda: pk.decode_attention_reference(
        q, k, v, lengths, scale=scale, q_per_slot=C), flush)
    bound_ms, bound_by, nbytes = decode_attention_bound(lens, S, H, D,
                                                        q_per_slot=C)
    plain_step = pk.decode_attention(q, k.repeat_interleave(C, 0),
                                     v.repeat_interleave(C, 0), lengths,
                                     scale=scale)
    exact = bool(torch.equal(out, plain_step))
    check(exact, "K3 q_per_slot=%d: the pseudo-slots differ from the plain "
          "step at the same lengths" % C)
    log("kernel decode_attention [verify, q_per_slot=%d] N=%d S=%d H=%d "
        "D=%d (%d pseudo-slots): max abs err %.3g; kernel %.4f ms, plain "
        "%.4f ms, bound %.4f ms (%s, %d bytes) -> %.1f%% of bound; "
        "bit-exact vs the plain step %s"
        % (C, N, S, H, D, N * C, err, ms, plain_ms, bound_ms, bound_by,
           nbytes, 100.0 * bound_ms / ms, exact))
    del flush
    entry["max_abs_err"] = max_err
    return entry


def _int8_caches(torch, g, n, s, h, d):
    """Int8 K/V caches from seeded fp32 ones, with their per-head scales
    [2, H] taken as the predictor calibrates them (amax x 1.25 / 127)."""
    kf, vf = (torch.randn(n, s, h, d, device="cuda", generator=g)
              for _ in range(2))
    sc = torch.stack([x.abs().amax((0, 1, 3)) * 1.25 / 127.0
                      for x in (kf, vf)]).contiguous()
    k8, v8 = (torch.clamp(torch.round(x / c[:, None]), -127, 127).to(
        torch.int8) for x, c in ((kf, sc[0]), (vf, sc[1])))
    return k8, v8, sc


def phase_int8_kernels(torch, pk, cover):
    """K4 against its plain version at the decode shapes and at lengths
    around the edges of its blocks' shares (K4 splits each row's
    positions over a cluster of blocks: the plan is logged per case),
    each row bit for bit against the same row launched alone; and K4's
    head-slice entry at 1, 2 and 4 local heads against its plain version
    and, bit for bit, against the full-table K4 (head blocks at every
    offset, concatenated).  The library yardstick is SDPA over an fp32
    cache holding the same dequantized values (no PyTorch call computes
    attention over an int8 cache).  The coverage cases (as phase_kernels
    has them) append their K4 rows to `cover`."""
    import torch.nn.functional as F
    rng = np.random.RandomState(1)
    g = torch.Generator(device="cuda").manual_seed(13)
    N, S, H, D = N_SLOTS, 512, 8, 64
    share = pk.decode_attention_int8_plan(S, D)["share"]
    cases = [
        ("main mixed", N, S, H, D,
         [0, 1, 511, 512] + list(rng.randint(2, 511, size=N - 4)), None),
        ("main full", N, S, H, D, [S] * N, ""),
        ("ragged", 3, 80, 2, 64, [0, 80, 41], None),
        ("boundaries", N, S, H, D,
         [0, 1, share - 1, share, share + 1, S - 1, S, S // 2 + 1], None),
    ] + _cover_decode_cases()
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.float32,
                        device="cuda")
    errs = {"k4": 0.0, "hs": 0.0}
    entries = {}
    for name, n, s, h, d, lens, row in cases:
        q = torch.randn(n, h, d, device="cuda", generator=g)
        k8, v8, sc = _int8_caches(torch, g, n, s, h, d)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        scale = 1.0 / np.sqrt(d)
        out = pk.decode_attention(q, k8, v8, lengths, scale=scale,
                                  kv_scales=sc)
        ref = pk.decode_attention_reference(q, k8, v8, lengths, scale=scale,
                                            kv_scales=sc)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), "K4 %s: non-finite" % name)
        err = float((out - ref).abs().max())
        atol = 1e-5 * float(ref.abs().max())
        check(bool(((out - ref).abs() <= atol + 1e-5 * ref.abs()).all()),
              "decode_attention int8 %s disagrees with the plain version "
              "(max abs err %.3g, rtol 1e-5, atol 1e-5 max|ref| = %.3g)"
              % (name, err, atol))
        if not row:
            errs["k4"] = max(errs["k4"], err)
        plan = pk.decode_attention_int8_plan(s, d)
        alone = all(torch.equal(pk.decode_attention(
            q[i:i + 1].clone(), k8[i:i + 1].clone(), v8[i:i + 1].clone(),
            lengths[i:i + 1].clone(), scale=scale, kv_scales=sc)[0], out[i])
            for i in range(n))
        check(alone, "K4 %s: a row of the batched call differs from the "
              "row launched alone" % name)
        exact = {}
        for n_local in (1, 2, 4):
            if n_local > h:
                continue
            blocks = []
            for off in range(0, h, n_local):
                hb = slice(off, off + n_local)
                ql = q[:, hb].contiguous()
                kl, vl = k8[:, :, hb].contiguous(), v8[:, :, hb].contiguous()
                hs = pk.decode_attention_head_slice(
                    ql, kl, vl, lengths, off, n_local, scale=scale,
                    kv_scales=sc)
                hs_ref = pk.decode_attention_reference(
                    ql, kl, vl, lengths, scale=scale, kv_scales=sc[:, hb])
                torch.cuda.synchronize()
                e = float((hs - hs_ref).abs().max())
                check(bool(((hs - hs_ref).abs()
                            <= atol + 1e-5 * hs_ref.abs()).all()),
                      "head slice %s Hl=%d offset %d disagrees with the "
                      "plain version (max abs err %.3g)"
                      % (name, n_local, off, e))
                errs["hs"] = max(errs["hs"], e)
                blocks.append(hs)
            exact[n_local] = bool(torch.equal(torch.cat(blocks, dim=1),
                                              out))
            check(exact[n_local], "head slice %s Hl=%d: the head blocks "
                  "concatenated differ from the full-table K4" % (name,
                                                                  n_local))
        ms = median_ms(torch, lambda: pk.decode_attention(
            q, k8, v8, lengths, scale=scale, kv_scales=sc), flush)
        plain_ms = median_ms(torch, lambda: pk.decode_attention_reference(
            q, k8, v8, lengths, scale=scale, kv_scales=sc), flush)
        kd = k8.float() * sc[0][:, None]
        vd = v8.float() * sc[1][:, None]
        mask = (torch.arange(s, device="cuda")[None, :]
                < lengths[:, None])[:, None, None, :]
        lib_ms = median_ms(torch, lambda: F.scaled_dot_product_attention(
            q[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2),
            attn_mask=mask, scale=scale), flush)
        bound_ms, bound_by, nbytes = decode_attention_bound(
            lens, s, h, d, elem=1, scale_heads=h)
        log("kernel decode_attention int8 [%s] N=%d S=%d H=%d D=%d: max "
            "abs err %.3g; kernel %.4f ms, plain %.4f ms, SDPA over the "
            "dequantized fp32 cache %.4f ms, bound %.4f ms (%s, %d bytes) "
            "-> %.1f%% of bound; split over a cluster of %d blocks, %d "
            "positions each; rows bit-exact vs alone %s; head slice "
            "bit-exact vs full table at Hl %s"
            % (name, n, s, h, d, err, ms, plain_ms, lib_ms, bound_ms,
               bound_by, nbytes, 100.0 * bound_ms / ms, plan["cluster"],
               plan["share"], alone, exact))
        if row is None:
            continue
        e = {"name": "decode_attention_int8", "route": "cuda",
             "source": "paddle_tpu_torch/ops/csrc/decode_attention.cu",
             "replaces": "paddle_tpu/ops/pallas_kernels.py:570",
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": lib_ms}
        if row:
            cover.append(_cover_row(e, row, "decode_attention_int8",
                                    ("serve", d), err))
            continue
        entries["k4"] = e
        # the head-slice entry at one TP member's shape: 4 of 8 heads at
        # offset 4, the whole [2, 8] scale table passed in
        n_local, off = 4, 4
        hb = slice(off, off + n_local)
        ql = q[:, hb].contiguous()
        kl, vl = k8[:, :, hb].contiguous(), v8[:, :, hb].contiguous()
        ms = median_ms(torch, lambda: pk.decode_attention_head_slice(
            ql, kl, vl, lengths, off, n_local, scale=scale, kv_scales=sc),
            flush)
        plain_ms = median_ms(torch, lambda: pk.decode_attention_reference(
            ql, kl, vl, lengths, scale=scale, kv_scales=sc[:, hb]), flush)
        kdl, vdl = kd[:, :, hb], vd[:, :, hb]
        lib_ms = median_ms(torch, lambda: F.scaled_dot_product_attention(
            ql[:, :, None], kdl.transpose(1, 2), vdl.transpose(1, 2),
            attn_mask=mask, scale=scale), flush)
        bound_ms, bound_by, nbytes = decode_attention_bound(
            lens, s, n_local, d, elem=1, scale_heads=n_local)
        log("kernel decode_attention_head_slice [main full, Hl=%d at "
            "offset %d of %d] N=%d S=%d D=%d: kernel %.4f ms, plain %.4f "
            "ms, SDPA over the dequantized block %.4f ms, bound %.4f ms "
            "(%s, %d bytes) -> %.1f%% of bound"
            % (n_local, off, h, n, s, d, ms, plain_ms, lib_ms, bound_ms,
               bound_by, nbytes, 100.0 * bound_ms / ms))
        entries["hs"] = {
            "name": "decode_attention_head_slice", "route": "cuda",
            "source": "paddle_tpu_torch/ops/csrc/decode_attention.cu",
            "replaces": "paddle_tpu/ops/pallas_kernels.py:673",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms}
    del flush
    entries["k4"]["max_abs_err"] = errs["k4"]
    entries["hs"]["max_abs_err"] = errs["hs"]
    return entries["k4"], entries["hs"]


def flash_bound(kind, B, S, H, D, causal, elem=4, rate=None):
    """Least time for one K1 / K2-dq / K2-dkv call: every byte it must move
    once (its [B, S, H, D] operands at `elem` bytes an element and its
    fp32 [B, H, S] row statistics) over HBM bandwidth, or its flops over
    the peak `rate` (fp32-accurate by default; bf16's tensor-core peak for
    the bf16 variants), whichever is larger.  The flops are 2 D per live
    (query, key) pair for each D-long product the function needs: 2 for
    the forward (q.k, p.v), 3 for dq (q.k, do.v, ds.k), 4 for dk/dv (q.k,
    do.v, p.do, ds.q)."""
    pairs = S * (S + 1) // 2 if causal else S * S
    heads, elems = B * H, B * S * H * D
    products, tensors, rowstats = {"fwd": (2, 4, 1), "dq": (3, 5, 2),
                                   "dkv": (4, 6, 2)}[kind]
    flops = 2 * D * pairs * heads * products
    nbytes = elem * tensors * elems + 4 * rowstats * heads * S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (rate or FP32_ACCURATE_FLOP_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, flops


def _close(got, want, rtol, atol):
    """(max abs error, whether |got - want| <= atol + rtol |want|
    everywhere), in fp32."""
    d = (got.float() - want.float()).abs()
    return float(d.max()), bool((d <= atol + rtol * want.float().abs())
                                .all())


# bf16 against its bf16 plain version: both sum in fp32 in other orders
# (the forward also rounds each tile's p against its running max, the
# plain version against the row's final max), so an element may sit one
# bf16 ulp (2^-7 relative) apart, with a floor of 2^-7 of the array's
# largest magnitude for the sums of rounded terms; lse stays fp32
BF16_RTOL = 2.0 ** -7


# (library stem, kernel tag, instances, the tensor-core input type its
# machine code must hold: "bf16" or "tf32").  K1/K2 have a D = 64, a
# D = 128 and a D = 256 instance; fp32 K6 one per tile height; K5 one per output dtype.
# The bf16 kernels run bf16 mma.sync, fp32 K1, K2 and K6 tf32 mma.sync
# (3xTF32), fp32-x K5 tf32 mma.sync (two products)
SASS_KERNELS = [("flash_attention_fwd", "flash_fwd_tc_kernel", 3, "bf16"),
                ("flash_attention_fwd", "flash_fwd_kernel", 3, "tf32"),
                ("flash_attention_bwd", "flash_bwd_dq_tc_kernel", 3, "bf16"),
                ("flash_attention_bwd", "flash_bwd_dq_kernel", 3, "tf32"),
                ("flash_attention_bwd", "flash_bwd_dkv_tc_kernel", 3,
                 "bf16"),
                ("flash_attention_bwd", "flash_bwd_dkv_kernel", 3, "tf32"),
                ("fused_bottleneck", "bottleneck_tc_kernel", 1, "bf16"),
                ("fused_bottleneck", "bottleneck_kernel", 2, "tf32"),
                ("dequant_matmul", "dequant_matmul_tc_kernel", 2, "bf16"),
                ("dequant_matmul", "dequant_matmul_kernel", 2, "tf32")]


def phase_sass(build):
    """Which tensor cores each kernel runs on, counted by input type in
    the machine code of the built libraries: the bf16 K1/K2/K6 kernels
    and the bf16-x K5 kernels hold bf16 HMMA/HGMMA and no other; fp32 K1,
    K2 and K6 and the fp32-x K5 kernels hold TF32 HMMA and no other."""
    counts, mnemonics = {}, {}
    for stem, tag, n, want in SASS_KERNELS:
        if stem not in counts:
            counts[stem] = build.tensor_core_counts(stem)
            mnemonics[stem] = build.sass_opcode_counts(stem,
                                                       build.TC_OPCODES)
        fns = {f: c for f, c in counts[stem].items() if tag in f}
        check(len(fns) == n, "sass %s: expected %d instances of %s, "
              "found %s" % (stem, n, tag, sorted(fns)))
        for fn, c in sorted(fns.items()):
            log("sass %s %s [%s]: %s; mnemonics %s" % (
                stem, fn, want or "simt", ", ".join(
                    "%s %d" % kv for kv in sorted(c.items())),
                json.dumps(mnemonics[stem][fn], sort_keys=True)))
            others = sum(v for k, v in c.items() if k != want)
            check(others == 0 and (want is None or c[want] > 0),
                  "sass %s: %s holds tensor-core instructions %s, expected "
                  "%s only" % (stem, fn, c, want or "none"))


_FLASH_SOURCES = {
    "fwd": ("flash_attention_fwd",
            "paddle_tpu_torch/ops/csrc/flash_attention_fwd.cu",
            "paddle_tpu/ops/pallas_kernels.py:243"),
    "dq": ("flash_attention_bwd_dq",
           "paddle_tpu_torch/ops/csrc/flash_attention_bwd.cu",
           "paddle_tpu/ops/pallas_kernels.py:362"),
    "dkv": ("flash_attention_bwd_dkv",
            "paddle_tpu_torch/ops/csrc/flash_attention_bwd.cu",
            "paddle_tpu/ops/pallas_kernels.py:414")}


def phase_flash_kernels(torch, pk, cover, dtype=None):
    """K1 and both K2 kernels against their plain versions at the training
    slice's shape (q/k/v as column slices of one fused qkv tensor, as the
    program hands them over), a non-causal and a ragged shape, and the
    coverage training path's shapes (COVER_TRAIN: head dims 32, 96, 192
    and 256, zero-padded to 64 / 128 / 256); then device times at the slice's shape and
    the coverage shapes, whose kernels-line rows are appended to `cover`.
    `dtype` torch.bfloat16 runs the bf16 variants (AMP training) against
    the bf16 plain versions."""
    import torch.nn.functional as F
    dtype = dtype or torch.float32
    bf16 = dtype == torch.bfloat16
    tag = " bf16" if bf16 else ""
    # the last field: None, a check; "", the kernels line's rows; else
    # coverage rows' suffix
    cases = [("slice", 8, 512, 8, 64, True, ""),
             ("non-causal", 4, 256, 4, 64, False, None),
             ("ragged", 2, 200, 2, 128, True, None)]
    cases += [("cover D %d" % D, *COVER_TRAIN_BS, heads, D, True,
               " [D %d]" % D) for D, _, heads in COVER_TRAIN]
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.float32,
                        device="cuda")
    errs = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    entries = {}
    g = torch.Generator(device="cuda").manual_seed(5)
    for name, B, S, H, D, causal, row in cases:
        case_errs = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
        qkv = torch.randn(B, S, 3 * H * D, device="cuda",
                          generator=g).to(dtype)
        q, k, v = (qkv[..., i * H * D:(i + 1) * H * D].reshape(B, S, H, D)
                   for i in range(3))
        o, lse = pk.flash_attention_fwd(q, k, v, causal)
        ro, rlse = pk.flash_attention_fwd_reference(q, k, v, causal)
        do = torch.randn(B, S, H, D, device="cuda", generator=g).to(dtype)
        di = pk._flash_di(ro, do)
        dq = pk.flash_attention_bwd_dq(q, k, v, do, rlse, di, causal)
        dk, dv = pk.flash_attention_bwd_dkv(q, k, v, do, rlse, di, causal)
        rdq = pk.flash_attention_bwd_dq_reference(q, k, v, do, rlse, di,
                                                  causal)
        rdk, rdv = pk.flash_attention_bwd_dkv_reference(q, k, v, do, rlse,
                                                        di, causal)
        torch.cuda.synchronize()
        check(o.dtype == dtype and dq.dtype == dtype and dk.dtype == dtype
              and dv.dtype == dtype and lse.dtype == torch.float32,
              "flash%s: outputs o %s, lse %s, dq %s, dk %s, dv %s"
              % (tag, o.dtype, lse.dtype, dq.dtype, dk.dtype, dv.dtype))
        for what, got, want in (("o", o, ro), ("lse", lse, rlse)):
            rtol = BF16_RTOL if bf16 and what == "o" else 1e-5
            atol = BF16_RTOL * float(want.float().abs().max()) \
                if bf16 and what == "o" else 1e-5
            err, ok = _close(got, want, rtol, atol)
            check(ok, "flash%s %s %s disagrees with the plain version (max "
                  "abs err %.3g, rtol %.3g atol %.3g)"
                  % (tag, name, what, err, rtol, atol))
            case_errs["fwd"] = max(case_errs["fwd"], err)
        # the gradients sum over S in another order: atol scaled by size
        # (bf16: one ulp, as above)
        gtol = BF16_RTOL if bf16 else 1e-4
        for kind, what, got, want in (("dq", "dq", dq, rdq),
                                      ("dkv", "dk", dk, rdk),
                                      ("dkv", "dv", dv, rdv)):
            atol = gtol * float(want.float().abs().max())
            err, ok = _close(got, want, gtol, atol)
            check(ok, "flash%s %s %s disagrees with the plain version (max "
                  "abs err %.3g, atol %.3g = %.3g max|%s|, rtol %.3g)"
                  % (tag, name, what, err, atol, gtol, what, gtol))
            case_errs[kind] = max(case_errs[kind], err)
        # end to end: autograd through K1 + K2 against autograd through
        # the plain forward (fp32), or against the plain K2 versions
        # (bf16: autograd would treat p's and ds's roundings as the
        # identity), on the same cotangent
        kin = [t.detach().requires_grad_(True) for t in (q, k, v)]
        kgrads = torch.autograd.grad(
            pk.flash_attention(*kin, causal=causal), kin, do)
        if bf16:
            rgrads = pk.flash_attention_bwd_reference(q, k, v, ro, rlse, do,
                                                      causal)
        else:
            rin = [t.detach().requires_grad_(True) for t in (q, k, v)]
            rgrads = torch.autograd.grad(
                pk.flash_attention_reference(*rin, causal=causal), rin, do)
        auto_err = 0.0
        for what, got, want in zip(("dq", "dk", "dv"), kgrads, rgrads):
            atol = gtol * float(want.float().abs().max())
            err, ok = _close(got, want, gtol, atol)
            check(ok, "flash%s %s autograd %s disagrees with the plain "
                  "version (max abs err %.3g, atol %.3g, rtol %.3g)"
                  % (tag, name, what, err, atol, gtol))
            auto_err = max(auto_err, err)
        log("kernel flash_attention%s [%s] B=%d S=%d H=%d D=%d (run at "
            "%d) causal=%s: max abs err o %.3g lse %.3g dq %.3g dk %.3g dv "
            "%.3g; autograd K1+K2 vs plain %.3g"
            % (tag, name, B, S, H, D, pk._flash_width(D), causal,
               _close(o, ro, 0, 0)[0], _close(lse, rlse, 0, 0)[0],
               _close(dq, rdq, 0, 0)[0], _close(dk, rdk, 0, 0)[0],
               _close(dv, rdv, 0, 0)[0], auto_err))
        if not row:
            errs = {k: max(v, case_errs[k]) for k, v in errs.items()}
        if row is None:
            continue
        # timings at the slice's and the coverage shapes; the yardstick
        # is SDPA in the same dtype (timed here only; the port never
        # calls it)
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
        sdpa_err = _close(so.detach().transpose(1, 2), ro, 0, 0)[0]
        log("kernel flash_attention%s [%s]: SDPA %s forward %.4f ms, "
            "backward %.4f ms (dq, dk, dv in one call), forward+backward "
            "%.4f ms; SDPA vs plain o max abs err %.3g"
            % (tag, name, str(dtype)[6:], sdpa_fwd, sdpa_bwd,
               sdpa_fwd + sdpa_bwd, sdpa_err))
        for kind, (kname, src, rep) in _FLASH_SOURCES.items():
            kname = pk._count_name(kname, dtype)
            lib_ms = sdpa_fwd if kind == "fwd" else sdpa_bwd
            bound_ms, bound_by, nbytes, flops = flash_bound(
                kind, B, S, H, D, causal, elem=q.element_size(),
                rate=BF16_FLOP_PER_S if bf16 else FP32_ACCURATE_FLOP_PER_S)
            log("kernel %s [%s] B=%d S=%d H=%d D=%d (run at %d) causal "
                "(%s): kernel %.4f ms, plain %.4f ms, SDPA %.4f ms, bound "
                "%.4f ms (%s; %d bytes, %d flops at D %d) -> %.1f%% of "
                "bound, %.1f TFLOP/s%s"
                % (kname, name, B, S, H, D, pk._flash_width(D),
                   "tensor cores (bf16)" if bf16
                   else "tensor cores (tf32 x3)", ms[kind], plain[kind],
                   lib_ms, bound_ms, bound_by, nbytes, flops, D,
                   100.0 * bound_ms / ms[kind], flops / ms[kind] / 1e9,
                   "" if bf16 else simt_bound_note(flops, nbytes)))
            e = {"name": kname, "route": "cuda", "source": src,
                 "replaces": rep, "ms": ms[kind], "plain_ms": plain[kind],
                 "bound_ms": bound_ms, "bound_by": bound_by,
                 "library_ms": lib_ms}
            if row:
                cover.append(_cover_row(e, row, kname, ("train", D),
                                        case_errs[kind]))
            else:
                entries[kind] = e
    del flush
    for kind, e in entries.items():
        e["max_abs_err"] = errs[kind]
    return [entries["fwd"], entries["dq"], entries["dkv"]]


# ResNet-50's bottleneck geometries (stage: input H = W, C, F, C4, stride
# of the first block); each stage runs one projection block, then
# identity blocks at the output size
RESNET_STAGES = [(1, 56, 64, 64, 256, 1), (2, 56, 256, 128, 512, 2),
                 (3, 28, 512, 256, 1024, 2), (4, 14, 1024, 512, 2048, 2)]
# a fused ResNet-50 run at gate 128: the stage-1 and stage-2 blocks, with
# how many times each geometry runs: (H, C, F, C4, stride, branch, count)
FUSED_PATH_BLOCKS = [(56, 64, 64, 256, 1, True, 1),
                     (56, 256, 64, 256, 1, False, 2),
                     (56, 256, 128, 512, 2, True, 1),
                     (28, 512, 128, 512, 1, False, 3)]
BF16_FLOP_PER_S = 989e12   # H100 SXM dense bf16 tensor-core peak


def _bound(flops, nbytes, flop_rate=FP32_ACCURATE_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def simt_bound_note(flops, nbytes):
    """The fp32 bound at the SIMT units' rate, printed beside the
    fp32-accurate tensor-core bound of an fp32 row."""
    return "; SIMT bound %.4f ms" % _bound(flops, nbytes, FP32_FLOP_PER_S)[0]


def bottleneck_bound(N, H, W, C, F, C4, s, branch, elem=4,
                     rate=FP32_ACCURATE_FLOP_PER_S):
    """Least time for one K6 call: 2 C F flops per input pixel (conv0 runs
    before the stride; at stride 2 the 3x3 taps read every input row and
    column) and 2 (9 F^2 + F C4 [+ C C4]) per output pixel, over the peak
    `rate` (fp32-accurate, or bf16's tensor-core peak for the bf16
    variant),
    against x, the filters, the biases and out moved once over HBM
    bandwidth at `elem` bytes an element."""
    Ho, Wo = (H - 1) // s + 1, (W - 1) // s + 1
    out_macs = 9 * F * F + F * C4 + (C * C4 if branch else 0)
    macs = C * F + out_macs
    flops = 2 * N * (C * F * H * W + out_macs * Ho * Wo)
    weights = macs + 2 * F + C4 + (C4 if branch else 0)
    nbytes = elem * (N * H * W * C + weights + N * Ho * Wo * C4)
    return _bound(flops, nbytes, rate) + (flops, nbytes)


def bottleneck_cudnn_chain(x, w0, b0, w1, b1, w2, b2, ws, bs, s):
    """The unfused block as cuDNN convolutions in the inputs' dtype, with
    their biases, relus and the shortcut add: K6-bf16's library yardstick
    (timed in chip_smoke only; the port never calls it)."""
    import torch.nn.functional as F
    xc = x.permute(0, 3, 1, 2)
    a = F.relu(F.conv2d(xc, w0, b0))
    h = F.relu(F.conv2d(a, w1, b1, stride=s, padding=1))
    y = F.conv2d(h, w2, b2)
    short = F.conv2d(xc, ws, bs, stride=s) if ws is not None else xc
    return F.relu(y + short)


def _bottleneck_inputs(torch, g, N, H, W, C, F, C4, branch):
    """x and He-scaled OIHW filters, small biases, on the card."""
    def t(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=g) * scale
    p = {"x": t(N, H, W, C), "w0": t(F, C, 1, 1, scale=(2.0 / C) ** 0.5),
         "b0": t(F, scale=0.1), "w1": t(F, F, 3, 3, scale=(2.0 / (9 * F))
                                        ** 0.5),
         "b1": t(F, scale=0.1), "w2": t(C4, F, 1, 1, scale=(1.0 / F) ** 0.5),
         "b2": t(C4, scale=0.1), "ws": None, "bs": None}
    if branch:
        p["ws"] = t(C4, C, 1, 1, scale=(1.0 / C) ** 0.5)
        p["bs"] = t(C4, scale=0.1)
    return p


def phase_bottleneck_kernel(torch, pk, cover, dtype=None):
    """K6 against its plain version (cuDNN convolutions, which are also
    the fp32 library yardstick): ResNet-50's four stage geometries at
    batch 32, projection (stride 2 where the stage has it) and identity,
    two odd-size shapes, and the fused path's four geometries at batch
    64, whose times summed with their multiplicities are K6's device time
    per fused run; each case launches the kernel once.  `dtype`
    torch.bfloat16 runs K6-bf16 against the bf16 plain version (fp32
    convolutions of the bf16 values, rounded where the TPU kernel
    rounds); its yardstick is the cuDNN bf16 chain.  K6-bf16 also runs
    COVER_K6's ragged channel edge (zero-padded to multiples of 8), whose
    kernels-line row is appended to `cover`."""
    dtype = dtype or torch.float32
    bf16 = dtype == torch.bfloat16
    name_of = pk._count_name("fused_bottleneck", dtype)
    g = torch.Generator(device="cuda").manual_seed(11)
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.float32,
                        device="cuda")
    cases = []
    for stage, H, C, F, C4, s in RESNET_STAGES:
        Ho = (H - 1) // s + 1
        cases.append(("stage%d proj" % stage, 32, H, H, C, F, C4, s, True,
                      1))
        cases.append(("stage%d identity" % stage, 32, Ho, Ho, C4, F, C4, 1,
                      False, 1))
    cases.append(("odd", 3, 9, 7, 48, 24, 96, 2, True, 1))
    cases.append(("odd identity", 2, 7, 5, 40, 16, 40, 1, False, 1))
    for H, C, F, C4, s, branch, count in FUSED_PATH_BLOCKS:
        cases.append(("path b64 H%d C%d F%d s%d" % (H, C, F, s), 64, H, H,
                      C, F, C4, s, branch, count))
    if bf16:
        cases.append(("ragged edge", *COVER_K6, 1))
    rate = BF16_FLOP_PER_S if bf16 else FP32_ACCURATE_FLOP_PER_S
    plan = pk.fused_bottleneck_bf16_plan if bf16 \
        else pk.fused_bottleneck_fp32_plan
    max_err = 0.0
    run = {"ms": 0.0, "plain_ms": 0.0, "lib_ms": 0.0, "bound_ms": 0.0,
           "flops": 0, "bytes": 0}
    for name, N, H, W, C, F, C4, s, branch, count in cases:
        p = {k: None if t is None else t.to(dtype) for k, t in
             _bottleneck_inputs(torch, g, N, H, W, C, F, C4, branch).items()}
        args = (p["x"], p["w0"], p["b0"], p["w1"], p["b1"], p["w2"],
                p["b2"], p["ws"], p["bs"], s)
        before = pk.launch_counts[name_of]
        out = pk.fused_bottleneck(*args)
        ref = pk.bottleneck_reference(*args)
        torch.cuda.synchronize()
        check(pk.launch_counts[name_of] == before + 1,
              "%s %s: the kernel did not launch" % (name_of, name))
        check(tuple(out.shape) == tuple(ref.shape) and out.dtype == dtype,
              "%s %s: %s %s vs %s" % (name_of, name, out.dtype, out.shape,
                                      ref.shape))
        check(bool(torch.isfinite(out).all()),
              "%s %s: non-finite" % (name_of, name))
        # bf16: the fp32 sums run in other orders, so an a or h element
        # may round to the neighbouring bf16 value (up to 2^-8 of max
        # |out| downstream) and an output sit one ulp (2^-7) apart
        rtol, atol = (BF16_RTOL, 2.0 ** -8 * float(ref.float().abs().max())) \
            if bf16 else (1e-4, 1e-4)
        err, ok = _close(out, ref, rtol, atol)
        check(ok, "%s %s disagrees with the plain version (max abs err "
              "%.3g, rtol %.3g atol %.3g)" % (name_of, name, err, rtol,
                                             atol))
        ms = median_ms(torch, lambda: pk.fused_bottleneck(*args), flush,
                       reps=30)
        plain_ms = median_ms(torch, lambda: pk.bottleneck_reference(*args),
                             flush, reps=30)
        lib_ms = median_ms(torch, lambda: bottleneck_cudnn_chain(*args),
                           flush, reps=30) if bf16 else plain_ms
        bound_ms, bound_by, flops, nbytes = bottleneck_bound(
            N, H, W, C, F, C4, s, branch, elem=out.element_size(),
            rate=rate)
        # the kernel's launch geometry for this shape (bf16: at the
        # widths it runs padded to)
        up = pk._up8 if bf16 else int
        geom = ("; R %(R)d, %(tile_rows)d-row tiles, %(blocks)d blocks, "
                "%(smem_bytes)d B dynamic smem, %(blocks_per_sm)d blocks/SM, "
                "%(regs)d registers" % plan(N, H, W, up(C), up(F), up(C4), s,
                                            branch))
        if not bf16:
            geom += simt_bound_note(flops, nbytes)
        log("kernel %s [%s] N=%d H=%d W=%d C=%d F=%d C4=%d s=%d %s: max abs "
            "err %.3g (max |ref| %.3g); kernel %.4f ms, plain %.4f ms, cuDNN "
            "%s chain %.4f ms, bound %.4f ms (%s; %d flops, %d bytes) -> "
            "%.1f%% of bound, %.2f TFLOP/s%s"
            % (name_of, name, N, H, W, C, F, C4, s,
               "projection" if branch else "identity", err,
               float(ref.float().abs().max()), ms, plain_ms,
               str(dtype)[6:], lib_ms, bound_ms, bound_by, flops, nbytes,
               100.0 * bound_ms / ms, flops / ms / 1e9, geom))
        if name == "ragged edge":
            cover.append(_cover_row(
                {"name": name_of, "route": "cuda",
                 "source": "paddle_tpu_torch/ops/csrc/fused_bottleneck.cu",
                 "replaces": "paddle_tpu/ops/pallas_kernels.py:1010",
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": lib_ms},
                " [C %d F %d C4 %d]" % (C, F, C4), name_of, None, err))
            continue
        max_err = max(max_err, err)
        if name.startswith("path"):
            run["ms"] += count * ms
            run["plain_ms"] += count * plain_ms
            run["lib_ms"] += count * lib_ms
            run["bound_ms"] += count * bound_ms
            run["flops"] += count * flops
            run["bytes"] += count * nbytes
        del p, args, out, ref
    del flush
    _, run_by = _bound(run["flops"], run["bytes"], rate)
    log("kernel %s [one fused run at batch 64, 7 launches]: kernel %.4f ms, "
        "plain %.4f ms, cuDNN chain %.4f ms, bound %.4f ms (%s) -> %.1f%% "
        "of bound, %.2f TFLOP/s%s"
        % (name_of, run["ms"], run["plain_ms"], run["lib_ms"],
           run["bound_ms"], run_by, 100.0 * run["bound_ms"] / run["ms"],
           run["flops"] / run["ms"] / 1e9,
           "" if bf16 else simt_bound_note(run["flops"], run["bytes"])))
    return {"name": name_of, "route": "cuda",
            "source": "paddle_tpu_torch/ops/csrc/fused_bottleneck.cu",
            "replaces": "paddle_tpu/ops/pallas_kernels.py:1010",
            "ms": run["ms"], "plain_ms": run["plain_ms"],
            "bound_ms": run["bound_ms"], "bound_by": run_by,
            "library_ms": run["lib_ms"], "max_abs_err": max_err}


def phase_dequant_kernel(torch, pk):
    """K5 against its plain version at the int8 lane's fc shape (M = 64
    bucketed images, K = 2048, N = 1000) with bf16 x and with fp32 x, a
    transformer fc shape (fp32 x), a ragged shape in both x dtypes and a
    bf16-output shape; the library yardstick is torch.matmul on the
    (bf16-rounded) x and the dequantized weight, times the scale.  fp32-x
    rows also print the bound at the two-product rate (495 / 2 TFLOP/s)
    that the kernel's arithmetic could reach."""
    g = torch.Generator(device="cuda").manual_seed(12)
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.float32,
                        device="cuda")
    cases = [("path", 64, 2048, 1000, torch.bfloat16, torch.float32),
             ("path fp32 x", 64, 2048, 1000, torch.float32, torch.float32),
             ("transformer fc", 4096, 512, 2048, torch.float32,
              torch.float32),
             ("ragged", 37, 300, 77, torch.bfloat16, torch.float32),
             ("ragged fp32 x", 37, 300, 77, torch.float32, torch.float32),
             ("bf16 out", 50, 129, 250, torch.bfloat16, torch.bfloat16)]
    entry, max_err = None, 0.0
    for name, M, K, N, xdt, odt in cases:
        x = torch.randn(M, K, device="cuda", generator=g).to(xdt)
        w = torch.randint(-127, 128, (K, N), device="cuda", generator=g,
                          dtype=torch.int8)
        scale = torch.rand(N, device="cuda", generator=g) * 0.01 + 1e-3
        out = pk.dequant_matmul(x, w, scale, out_dtype=odt)
        ref = pk.dequant_matmul_reference(x, w, scale, out_dtype=odt)
        torch.cuda.synchronize()
        check(out.dtype == odt and tuple(out.shape) == (M, N),
              "dequant_matmul %s: got %s %s" % (name, out.dtype,
                                                tuple(out.shape)))
        err = float((out.float() - ref.float()).abs().max())
        # fp32 sums in another order; a bf16 output may then round one
        # ulp (2^-8 relative) apart
        rtol = 2.0 ** -7 if odt == torch.bfloat16 else 1e-5
        atol = 1e-5 * float(ref.float().abs().max())
        check(bool(((out.float() - ref.float()).abs()
                    <= atol + rtol * ref.float().abs()).all()),
              "dequant_matmul %s disagrees with the plain version (max abs "
              "err %.3g, atol %.3g, rtol %.3g)" % (name, err, atol, rtol))
        max_err = max(max_err, err)
        ms = median_ms(torch, lambda: pk.dequant_matmul(
            x, w, scale, out_dtype=odt), flush)
        plain_ms = median_ms(torch, lambda: pk.dequant_matmul_reference(
            x, w, scale, out_dtype=odt), flush)
        xf, wf = x.float(), w.float()
        lib_ms = median_ms(torch, lambda: torch.matmul(xf, wf) * scale,
                           flush)
        flops = 2 * M * N * K
        nbytes = x.element_size() * M * K + K * N + 4 * N \
            + out.element_size() * M * N
        rate = BF16_FLOP_PER_S if xdt == torch.bfloat16 \
            else FP32_ACCURATE_FLOP_PER_S
        bound_ms, bound_by = _bound(flops, nbytes, rate)
        if xdt == torch.bfloat16:
            route, note = "tensor cores (bf16)", ""
        else:
            route = "tensor cores (tf32, 2 products)"
            note = "; two-product bound %.4f ms" % _bound(
                flops, nbytes, TF32_FLOP_PER_S / 2)[0]
        log("kernel dequant_matmul [%s] M=%d K=%d N=%d x %s -> %s (%s): max "
            "abs err %.3g; kernel %.4f ms (%.1f TFLOP/s), plain %.4f ms, "
            "torch.matmul %.4f ms, bound %.4f ms (%s; %d flops at %.0f "
            "TFLOP/s, %d bytes) -> %.1f%% of bound%s"
            % (name, M, K, N, str(xdt)[6:], str(odt)[6:], route, err, ms,
               flops / ms / 1e9, plain_ms, lib_ms, bound_ms, bound_by,
               flops, rate / 1e12, nbytes, 100.0 * bound_ms / ms, note))
        if name == "path":
            entry = {"name": "dequant_matmul", "route": "cuda",
                     "source": "paddle_tpu_torch/ops/csrc/dequant_matmul.cu",
                     "replaces": "paddle_tpu/ops/pallas_kernels.py:732",
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_ms}
    del flush
    entry["max_abs_err"] = max_err
    return entry


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
    counts = dict(pk.launch_counts)
    launches = counts["decode_attention"]
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
    return pred, counts, {"prompts": prompts, "budgets": budgets,
                          "outs": outs, "stats": stats}


def phase_profile(torch, pred, steps=20, label="profile", draft=None,
                  fused=False):
    """Where a decode step's time goes with all 8 slots live (128-token
    prompts): host wall per step without the profiler, then the device
    time per step by kernel under torch.profiler over the same steps.
    With a `draft` the steps are speculative rounds of a
    SpeculativeDecodeSession (SPEC_K drafts, one verify).  `fused` makes
    each step a fused window of FUSE_STEPS steps (`decode_fused`, one
    CUDA-graph replay), or a fused round; the kernels per token count
    every device kernel the profiler saw over the tokens committed."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.inference.decode import SpeculativeDecodeSession
    rng = np.random.RandomState(7)
    sess = pred.new_session(N_SLOTS) if draft is None else \
        SpeculativeDecodeSession(pred, draft, N_SLOTS, SPEC_K)
    if draft is not None:
        def step():
            return int(sess.step(fused=fused)[1].sum())
    elif fused:
        def step():
            return int(sess.decode_fused(FUSE_STEPS)[1].sum())
    else:
        def step():
            sess.decode()
            return N_SLOTS
    for s in range(N_SLOTS):
        sess.prefill(s, [int(t) for t in rng.randint(
            0, pred.vocab_size, size=128)])
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tokens = sum(step() for _ in range(steps))
        torch.cuda.synchronize()
    device_ms, rows = profile_rows(torch, prof, steps)
    unit = ("window" if fused else "step") if draft is None else "round"
    if not rows:
        log("%s: torch.profiler saw no device time; device busy share not "
            "measured (host %.3f ms/%s)" % (label, step_ms, unit))
        return {"host_ms": step_ms, "device_busy_ms": None}
    kernels = sum(r[1] for r in rows) * steps
    log("%s: %d decode %ss at 8 live slots: host %.3f ms/%s, device busy "
        "%.3f ms/%s (%.1f%% of the %s; idle %.1f%%); %d tokens, %.2f "
        "device kernels per token"
        % (label, steps, unit, step_ms, unit, device_ms, unit,
           100 * device_ms / step_ms, unit,
           100 - 100 * device_ms / step_ms, tokens, kernels / tokens))
    for us, count, key in rows[:10]:
        log("%s:   %9.2f us/%s  %5.1f launches/%s  %s"
            % (label, us, unit, count, unit, key[:110]))
    out = {"steps": steps, "unit": unit, "host_ms": step_ms,
           "device_busy_ms": device_ms,
           "device_busy_share": device_ms / step_ms,
           "tokens": tokens, "kernels_per_token": kernels / tokens,
           "attention_launches": sum(r[1] for r in rows
                                     if "decode_attention" in r[2]) * steps,
           "top": [{"kernel": k[:160], "us": us, "launches": c}
                   for us, c, k in rows[:10]]}
    log(json.dumps({label: out}))
    return out


def _serve(torch, pk, batcher, pred, prompts, budgets, **kw):
    """One DecodeBatcher with N_SLOTS slots answers the requests, launch
    counts zeroed just before and read just after; returns (streams,
    lane stats, launch counts, wall s, peak bytes, the batcher)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pk.reset_launch_counts()
    b = batcher.DecodeBatcher(pred, n_slots=N_SLOTS, **kw)
    t0 = time.perf_counter()
    streams = [b.submit(p, max_new_tokens=m)
               for p, m in zip(prompts, budgets)]
    outs = [st.result(timeout=600)[0].tolist() for st in streams]
    wall = time.perf_counter() - t0
    b.close()
    counts = dict(pk.launch_counts)
    return (outs, b.lane_stats(), counts, wall,
            torch.cuda.max_memory_allocated(), b)


def _first_divergence(a, b):
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def phase_int8_lane(torch, pk, decode, batcher, art, plain):
    """The int8 KV cache at full width: the same 16 requests as the fp32
    lane through a DecodeBatcher over `kv_cache_dtype="int8"`; every
    stream equals int8 single-request decode, K4 launches once per layer
    per step and K3 never, freed slots are int8 zeros, the measured cache
    bytes equal the closed form, and each first token equals the fp32
    lane's (prefill is fp32 in both)."""
    prompts, budgets = plain["prompts"], plain["budgets"]
    t0 = time.time()
    pred = decode.load_decode_predictor(art, kv_cache_dtype="int8")
    check(pred.device.type == "cuda" and pred.kv_cache_dtype == "int8",
          "int8 predictor on %s with %s caches" % (pred.device,
                                                   pred.kv_cache_dtype))
    L, H, Dh = (FULL_WIDTH["n_layers"], FULL_WIDTH["n_heads"],
                FULL_WIDTH["d_model"] // FULL_WIDTH["n_heads"])
    want = 2 * L * N_SLOTS * FULL_WIDTH["max_seq_len"] * H * Dh \
        + 2 * L * H * 4
    log("int8: opened (scales calibrated on the CPU) in %.2f s; KV cache "
        "%d bytes at %d slots (fp32: %d)"
        % (time.time() - t0, pred.kv_cache_bytes(N_SLOTS), N_SLOTS,
           4 * (want - 2 * L * H * 4)))
    check(pred.kv_cache_bytes(N_SLOTS) == want,
          "int8 kv_cache_bytes %d, want %d" % (pred.kv_cache_bytes(N_SLOTS),
                                               want))
    for n in sorted({pred.prompt_bucket(len(p)) for p in prompts}):
        decode.greedy_decode(pred, [1] * n, 2, n_slots=N_SLOTS)
    outs, lane, counts, wall, peak, b = _serve(torch, pk, batcher, pred,
                                               prompts, budgets)
    steps = lane["steps"]
    n_layers = FULL_WIDTH["n_layers"]
    check(steps > 0 and counts["decode_attention_int8"] == steps * n_layers,
          "decode_attention_int8 launched %d times for %d steps x %d layers"
          % (counts["decode_attention_int8"], steps, n_layers))
    check(counts["decode_attention"] == 0,
          "K3 launched %d times on the int8 lane" % counts["decode_attention"])
    sess = b.session
    check(sess._kc.dtype == torch.int8 and all(
        sess.slot_is_zero(s) for s in range(N_SLOTS)),
          "a freed int8 slot still holds K/V")
    check(sess.cache_bytes() == want and b.kv_cache_info() == ("int8", want),
          "measured int8 cache bytes %d, want %d" % (sess.cache_bytes(),
                                                     want))
    check(all(len(o) == m for o, m in zip(outs, budgets)),
          "an int8 stream ended before its budget")
    for i, (p, m, o) in enumerate(zip(prompts, budgets, outs)):
        ref, _ = decode.greedy_decode(pred, p, m, n_slots=N_SLOTS)
        check(o == ref, "int8 request %d: batched stream diverged from "
              "single-request int8 decode at token %d"
              % (i, _first_divergence(o, ref)))
        check(o[0] == plain["outs"][i][0], "int8 request %d: first token "
              "%d differs from the fp32 lane's %d" % (i, o[0],
                                                      plain["outs"][i][0]))
    agree = sum(_first_divergence(o, f) for o, f in zip(outs, plain["outs"]))
    total = sum(len(o) for o in outs)
    tokens = total
    stats = {"requests": len(prompts), "slots": N_SLOTS,
             "generated_tokens": tokens, "wall_s": wall,
             "tokens_per_s": tokens / wall, "decode_steps": steps,
             "step_ms": lane["step_s"] / steps * 1e3,
             "decode_attention_int8_launches":
                 counts["decode_attention_int8"],
             "peak_mem_bytes": peak, "kv_cache_bytes": want,
             "fp32_prefix_agreement": agree / total}
    log("int8: %d requests, %d tokens in %.3f s: %.1f tokens/s (fp32 lane "
        "%.1f), %d decode steps at %.3f ms/step (fp32 %.3f), %d K4 "
        "launches, 0 K3, peak memory %.1f MiB; streams bit-exact vs "
        "single-request int8 decode; fp32-vs-int8 agreement %.4f of tokens "
        "(stream prefixes up to the first difference)"
        % (len(prompts), tokens, wall, stats["tokens_per_s"],
           plain["stats"]["tokens_per_s"], steps, stats["step_ms"],
           plain["stats"]["step_ms"], counts["decode_attention_int8"],
           peak / 2 ** 20, stats["fp32_prefix_agreement"]))
    stats["profile"] = phase_profile(torch, pred, label="int8 profile")
    log(json.dumps({"int8": stats}))
    return pred, counts, outs, stats["profile"]


def phase_verify_form(torch, pred):
    """Would one batched [N * C, D] pass round like the step's [N, D]
    pass?  The verify step's dense parts on the full-width model's
    weights, batched against per chunk position (the form the port
    runs): bit-identical or not, per operation."""
    m = pred.model
    layer = m.layers[0]
    g = torch.Generator(device=pred.device).manual_seed(17)
    C = SPEC_K + 1
    x = torch.randn(N_SLOTS, C, m.d_model, device=pred.device, generator=g)
    h = torch.randn(N_SLOTS, C, 4 * m.d_model, device=pred.device,
                    generator=g)
    ops = {"ln1": (x, layer.ln1), "wq": (x, lambda t: t @ layer.wq),
           "w1": (x, lambda t: t @ layer.w1),
           "w2": (h, lambda t: t @ layer.w2),
           "lm_head": (x, lambda t: t @ m.lm_head)}
    out = {}
    for name, (inp, fn) in ops.items():
        batched = fn(inp.reshape(N_SLOTS * C, -1)).reshape(N_SLOTS, C, -1)
        per = torch.stack([fn(inp[:, j].contiguous()) for j in range(C)],
                          dim=1)
        out[name] = {"bit_identical": bool(torch.equal(batched, per)),
                     "max_abs_diff": float((batched - per).abs().max())}
    log("verify form: batched [%d, D] against per-position [%d, D] "
        "products on the card: %s; the port verifies per position"
        % (N_SLOTS * C, N_SLOTS, {k: v["bit_identical"]
                                  for k, v in out.items()}))
    return out


def phase_spec_lane(torch, pk, decode, batcher, art, pred, pred8, plain):
    """Speculative decoding at full width: the fp32 target with its int8
    twin as draft, SPEC_K = 4, the same 16 requests; every committed
    stream equals fp32 greedy decode at 8 slots, K3 launches once per
    layer per verify or plain round and K4 once per layer per draft
    step.  Then 4 requests each with an fp32 twin draft (accepted
    whole) and a mismatched draft (2 layers, seed 101: rolled back on
    nearly every round, streams still exact)."""
    prompts, budgets, refs = plain["prompts"], plain["budgets"], plain["outs"]
    form = phase_verify_form(torch, pred)
    outs, lane, counts, wall, peak, b = _serve(
        torch, pk, batcher, pred, prompts, budgets, draft=pred8,
        spec_k=SPEC_K)
    for i, (o, r) in enumerate(zip(outs, refs)):
        check(o == r, "spec request %d: committed stream diverged from fp32 "
              "greedy decode at token %d" % (i, _first_divergence(o, r)))
    n_layers = FULL_WIDTH["n_layers"]
    rounds, plain_rounds = lane["rounds"], lane["plain_steps"]
    draft_steps = b.session.draft_session.steps
    check(rounds > 0 and not lane["degraded"],
          "spec lane: %d verify rounds, degraded %s" % (rounds,
                                                        lane["degraded"]))
    check(counts["decode_attention"] == n_layers * (rounds + plain_rounds),
          "K3 launched %d times for %d verify + %d plain rounds x %d layers"
          % (counts["decode_attention"], rounds, plain_rounds, n_layers))
    check(counts["decode_attention_int8"] == n_layers * draft_steps,
          "K4 launched %d times for %d draft steps x %d layers"
          % (counts["decode_attention_int8"], draft_steps, n_layers))
    tokens = sum(len(o) for o in outs)
    decoded = tokens - len(outs)      # the first tokens come from prefill
    accept = lane["accepted"] / lane["proposed"]
    stats = {"requests": len(prompts), "slots": N_SLOTS, "spec_k": SPEC_K,
             "generated_tokens": tokens, "wall_s": wall,
             "tokens_per_s": tokens / wall,
             "plain_fp32_tokens_per_s": plain["stats"]["tokens_per_s"],
             "rounds": rounds, "plain_rounds": plain_rounds,
             "draft_steps": draft_steps, "proposed": lane["proposed"],
             "accepted": lane["accepted"], "accept_rate": accept,
             "decode_tokens_per_round": decoded / (rounds + plain_rounds),
             "round_ms": lane["step_s"] / lane["steps"] * 1e3,
             "launches": {k: counts[k] for k in ("decode_attention",
                                                 "decode_attention_int8")},
             "peak_mem_bytes": peak, "verify_form": form}
    log("spec: %d requests, %d tokens in %.3f s: %.1f tokens/s against "
        "%.1f on the plain fp32 lane; %d verify + %d plain rounds at %.3f "
        "ms/round, %.3f decode tokens per round (8 slots), accept rate "
        "%.4f (%d of %d int8-twin drafts), %d draft steps; K3 %d, K4 %d "
        "launches; peak memory %.1f MiB; streams bit-exact vs fp32 greedy "
        "decode" % (len(prompts), tokens, wall, stats["tokens_per_s"],
                    stats["plain_fp32_tokens_per_s"], rounds, plain_rounds,
                    stats["round_ms"], stats["decode_tokens_per_round"],
                    accept, lane["accepted"], lane["proposed"], draft_steps,
                    counts["decode_attention"],
                    counts["decode_attention_int8"], peak / 2 ** 20))
    stats["profile"] = phase_profile(torch, pred, steps=10,
                                     label="spec profile", draft=pred8)
    # an fp32 twin draft proposes the target's own tokens: accepted whole
    twin = decode.load_decode_predictor(art)
    outs, lane, twin_counts, wall, _, _ = _serve(
        torch, pk, batcher, pred, prompts[:4], budgets[:4], draft=twin,
        spec_k=SPEC_K)
    check(outs == refs[:4], "fp32 twin draft: a committed stream diverged")
    check(lane["proposed"] > 0 and lane["accepted"] == lane["proposed"],
          "fp32 twin draft accepted %d of %d" % (lane["accepted"],
                                                  lane["proposed"]))
    stats["fp32_twin"] = {"accept_rate": lane["accepted"] / lane["proposed"],
                          "rounds": lane["rounds"],
                          "tokens_per_s": sum(map(len, outs)) / wall}
    log("spec fp32 twin: 4 requests, accept rate exactly %.1f (%d drafts), "
        "%d rounds, %.1f tokens/s; streams bit-exact"
        % (stats["fp32_twin"]["accept_rate"], lane["proposed"],
           lane["rounds"], stats["fp32_twin"]["tokens_per_s"]))
    del twin
    # a draft with other weights: almost every round rolls back
    other = art + "_mismatched"
    decode.build_tiny_decode_model(other, **dict(FULL_WIDTH, n_layers=2,
                                                 seed=101))
    short = [min(m, 24) for m in budgets[:4]]
    draft = decode.load_decode_predictor(other)
    rollbacks = []
    real = draft.new_session

    def counting_session(n_slots):
        ds = real(n_slots)
        roll = ds.rollback

        def rollback(*a, **kw):
            rollbacks.append(1)
            return roll(*a, **kw)
        ds.rollback = rollback
        return ds
    draft.new_session = counting_session
    outs, lane, mis_counts, wall, _, _ = _serve(
        torch, pk, batcher, pred, prompts[:4], short, draft=draft,
        spec_k=SPEC_K)
    check(outs == [r[:m] for r, m in zip(refs[:4], short)],
          "mismatched draft: a committed stream diverged")
    slot_rounds = lane["proposed"] // SPEC_K
    share = len(rollbacks) / slot_rounds
    check(share >= 0.5, "mismatched draft rolled back in only %d of %d "
          "slot-rounds" % (len(rollbacks), slot_rounds))
    stats["mismatched"] = {"accept_rate": lane["accepted"] / lane["proposed"],
                           "rollback_share": share, "rounds": lane["rounds"],
                           "tokens_per_s": sum(map(len, outs)) / wall}
    log("spec mismatched draft (2 layers, seed 101): 4 requests, accept "
        "rate %.4f, rolled back in %d of %d slot-rounds (%.3f), %.1f "
        "tokens/s; streams bit-exact"
        % (stats["mismatched"]["accept_rate"], len(rollbacks), slot_rounds,
           share, stats["mismatched"]["tokens_per_s"]))
    log(json.dumps({"spec": stats}))
    hs = sum(c["decode_attention_head_slice"]
             for c in (counts, twin_counts, mis_counts))
    return (counts["decode_attention"], counts["decode_attention_int8"], hs,
            stats["profile"])


def _lane_run(torch, pk, b, prompts, budgets):
    """The requests through the open batcher `b`, launch counts zeroed
    just before and read just after; returns (streams, wall s, counts,
    lane stats before, lane stats after, graph stats before, after)."""
    torch.cuda.synchronize()
    lane0, graph0 = b.lane_stats(), b.session.graph_stats()
    pk.reset_launch_counts()
    t0 = time.perf_counter()
    streams = [b.submit(p, max_new_tokens=m)
               for p, m in zip(prompts, budgets)]
    outs = [st.result(timeout=600)[0].tolist() for st in streams]
    wall = time.perf_counter() - t0
    counts = dict(pk.launch_counts)
    return (outs, wall, counts, lane0, b.lane_stats(), graph0,
            b.session.graph_stats())


def _graph_launches(g0, g1):
    """(replays, launches) that a lane's captured graph ran between two
    of its stats (a plain lane's {n_steps: stats}, or a speculative
    lane's stats): the warm-up of a capture made in between, plus the
    replays times the launches per replay."""
    if g1 and FUSE_STEPS in g1:
        g0, g1 = (g0 or {}).get(FUSE_STEPS), g1[FUSE_STEPS]
    if not g1:
        return 0, {}
    replays = g1["replays"] - (g0["replays"] if g0 else 0)
    out = {k: n * replays for k, n in g1["launches"].items()}
    if not g0:
        for k, n in g1["warmup"].items():
            out[k] = out.get(k, 0) + n
    return replays, out


def _check_lane_launches(label, fused, counts, lane0, lane1, g0, g1, spec,
                         draft_steps, n_layers):
    """The kernel launches of one run against what the lane ran: on a
    fused lane the graphs' warm-ups and replays plus the eager plain
    rounds of a speculative lane; on an unfused lane K3 (K4 on the int8
    lane) once per layer per step, or K3 per verify or plain round and K4
    per draft step on a speculative lane.  Returns the run's (K3, K4)
    launches and the device trips of a fused plain lane."""
    k3, k4 = counts["decode_attention"], counts["decode_attention_int8"]
    d = {k: lane1[k] - lane0[k] for k in ("steps", "trips")}
    if spec:
        for k in ("rounds", "plain_steps"):
            d[k] = lane1[k] - lane0[k]
    device_trips = None
    if fused:
        replays, want = _graph_launches(g0, g1)
        if spec:
            want = {k: want.get(k, 0) + d["plain_steps"] * n_layers
                    for k in ("decode_attention", "decode_attention_int8")}
            check(replays == d["rounds"], "%s: %d graph replays for %d "
                  "fused rounds" % (label, replays, d["rounds"]))
        else:
            device_trips = (replays + (0 if g0 else 1)) * FUSE_STEPS
            check(replays == d["steps"], "%s: %d graph replays for %d "
                  "windows" % (label, replays, d["steps"]))
            check(k3 + k4 == device_trips * n_layers,
                  "%s: %d attention launches for %d device trips x %d "
                  "layers" % (label, k3 + k4, device_trips, n_layers))
        for k, n in (("decode_attention", k3),
                     ("decode_attention_int8", k4)):
            check(n == want.get(k, 0), "%s: %s launched %d times, the "
                  "graphs and eager rounds account for %d"
                  % (label, k, n, want.get(k, 0)))
    elif spec:
        check(k3 == n_layers * (d["rounds"] + d["plain_steps"])
              and k4 == n_layers * draft_steps,
              "%s: K3 %d, K4 %d for %d rounds, %d plain rounds, %d draft "
              "steps x %d layers" % (label, k3, k4, d["rounds"],
                                     d["plain_steps"], draft_steps,
                                     n_layers))
    else:
        check(k3 + k4 == d["steps"] * n_layers and min(k3, k4) == 0,
              "%s: K3 %d, K4 %d for %d steps x %d layers"
              % (label, k3, k4, d["steps"], n_layers))
    return k3, k4, device_trips, d


def _fused_session_check(torch, decode, art, streams):
    """The CUDA graph against the eager masked loop on one 8-slot table,
    bit for bit: a window in which an EOS mid-window and budgets of 1-3
    stop every slot before the last trip (trips < n_steps; the rest run
    masked), then a max_trips clamp.  The EOS is the first token at index
    3..FUSE_STEPS - 1 of an fp32 lane's stream that did not occur before
    it; that request takes slot 0."""
    rng = np.random.RandomState(1234)
    pred = decode.load_decode_predictor(art)
    V = pred.vocab_size
    prompts = [[int(t) for t in rng.randint(0, V, size=rng.randint(8, 201))]
               for _ in range(N_REQUESTS)]
    found = next(((r, j) for r, st in enumerate(streams)
                  for j in range(3, FUSE_STEPS) if st[j] not in st[:j]),
                 None)
    check(found is not None, "fused check: no EOS candidate in the streams")
    r, j = found
    pred.meta = dict(pred.meta, eos_id=int(streams[r][j]))
    prompts = [prompts[r]] + [p for i, p in enumerate(prompts)
                              if i != r][:N_SLOTS - 1]
    graph, eager = pred.new_session(N_SLOTS), pred.new_session(N_SLOTS)
    for sess in (graph, eager):
        for s, p in enumerate(prompts):
            sess.prefill(s, p)
    budget = [FUSE_STEPS] + [1 + s % 3 for s in range(1, N_SLOTS)]
    out = []
    for kw in (dict(budget=budget), dict(max_trips=3)):
        got = graph.decode_fused(FUSE_STEPS, **kw)
        want = eager.decode_fused_plain(FUSE_STEPS, **kw)
        check(all(np.array_equal(a, b) for a, b in zip(got, want))
              and np.array_equal(graph.lengths, eager.lengths)
              and torch.equal(graph._kc, eager._kc)
              and torch.equal(graph._vc, eager._vc),
              "fused check %s: the CUDA graph and the eager loop differ"
              % sorted(kw))
        out.append((got[2], got[1].tolist()))
    check(out[0][0] == j and out[0][1][0] == j,
          "fused check: EOS at trip %d, the window ran %d trips, slot 0 "
          "emitted %d" % (j, out[0][0], out[0][1][0]))
    check(out[1][0] == 3, "fused check: max_trips 3 ran %d trips"
          % out[1][0])
    log("fused check: CUDA graph == eager masked loop bit for bit (tokens, "
        "counts, trips, lengths, caches): an EOS mid-window ended a window "
        "of %d after %d trips (%d masked), a max_trips clamp after %d"
        % (FUSE_STEPS, out[0][0], FUSE_STEPS - out[0][0], out[1][0]))
    return {"eos_trips": out[0][0], "clamp_trips": out[1][0]}


def _median(xs):
    return float(np.median(xs)) if xs else None


def phase_fused(torch, pk, decode, batcher, art, pred, pred8, plain,
                int8_outs, unfused_profiles):
    """Fused N-step decode at full width (FUSE_STEPS per window, 8 slots,
    the same 16 requests): the fp32 lane (K3), the int8 lane (K4) and the
    speculative lane (int8 twin draft, SPEC_K), each unfused and fused
    in FUSED_PAIRS alternated pairs of runs on two open batchers (a first
    untimed pair of two requests captures the graphs).  Every fused
    stream equals the lane's unfused stream (fp32 and speculative: fp32
    greedy decode), freed slots are zero, and K3/K4 launches equal what
    the graphs' warm-ups and replays and the eager rounds launched; the
    session check holds the graph against the eager loop; an fp32 twin
    draft is accepted whole in fused rounds.  Prints per lane, fused
    against unfused: tokens/s, ms per dispatch and per step, dispatches
    and host round trips per token, masked trips, peak memory, and a
    profile of 20 fused windows or rounds beside the earlier phases'
    profiles of unfused steps or rounds (`unfused_profiles`)."""
    prompts, budgets = plain["prompts"], plain["budgets"]
    n_layers = FULL_WIDTH["n_layers"]
    check_stats = _fused_session_check(torch, decode, art, plain["outs"])
    lanes = [("fp32", pred, None, plain["outs"]),
             ("int8", pred8, None, int8_outs),
             ("spec", pred, pred8, plain["outs"])]
    totals = {"decode_attention": 0, "decode_attention_int8": 0}
    report = {"fuse_steps": FUSE_STEPS, "session_check": check_stats}
    for name, target, draft, refs in lanes:
        kw = dict(draft=draft, spec_k=SPEC_K) if draft is not None else {}
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        bs = {mode: batcher.DecodeBatcher(target, n_slots=N_SLOTS,
                                          fuse_steps=fuse, **kw)
              for mode, fuse in (("unfused", 1), ("fused", FUSE_STEPS))}
        runs = {"unfused": [], "fused": []}
        try:
            for i in range(FUSED_PAIRS + 1):
                order = ("fused", "unfused") if i % 2 else \
                    ("unfused", "fused")
                for mode in order:
                    b = bs[mode]
                    ds0 = b.session.draft_session.steps if draft else 0
                    n = len(prompts) if i else 2
                    (outs, wall, counts, lane0, lane1, g0,
                     g1) = _lane_run(torch, pk, b, prompts[:n], budgets[:n])
                    label = "fused %s %s run %d" % (name, mode, i)
                    for r, (o, ref) in enumerate(zip(outs, refs)):
                        check(o == ref, "%s: request %d diverged from the "
                              "unfused stream at token %d"
                              % (label, r, _first_divergence(o, ref)))
                    sessions = [b.session] + (
                        [b.session.draft_session] if draft else [])
                    check(all(sess.slot_is_zero(s) for sess in sessions
                              for s in range(N_SLOTS)),
                          "%s: a freed slot still holds K/V" % label)
                    ds = (b.session.draft_session.steps - ds0) if draft \
                        else 0
                    k3, k4, trips_dev, d = _check_lane_launches(
                        label, mode == "fused", counts, lane0, lane1, g0,
                        g1, draft is not None, ds, n_layers)
                    if mode == "fused":
                        totals["decode_attention"] += k3
                        totals["decode_attention_int8"] += k4
                    if i == 0:
                        continue
                    tokens = sum(len(o) for o in outs)
                    decoded = tokens - len(outs)
                    # host round trips: a step, a window or a fused round
                    # each; a host-driven round makes one per draft step,
                    # one for the verify (a plain round: its step and the
                    # draft's catch-up)
                    trips_host = d["steps"] if not draft else (
                        d["rounds"] + 2 * d["plain_steps"]
                        + (0 if mode == "fused" else ds))
                    run = {"tokens_per_s": tokens / wall,
                           "dispatch_ms": (lane1["step_s"] - lane0["step_s"])
                           / d["steps"] * 1e3,
                           "step_ms": (lane1["step_s"] - lane0["step_s"])
                           / d["trips"] * 1e3,
                           "dispatches_per_token": d["steps"] / decoded,
                           "round_trips_per_token": trips_host / decoded,
                           "tokens_per_dispatch": decoded / d["steps"]}
                    if trips_dev:
                        run["masked_trip_share"] = \
                            1 - d["trips"] / (d["steps"] * FUSE_STEPS)
                    runs[mode].append(run)
        finally:
            for b in bs.values():
                b.close()
        peak = torch.cuda.max_memory_allocated()
        pairs = [f["tokens_per_s"] / u["tokens_per_s"]
                 for f, u in zip(runs["fused"], runs["unfused"])]
        lane = {mode: {k: _median([r[k] for r in rs]) for k in rs[0]}
                for mode, rs in runs.items()}
        runs_s = lane["tokens_per_s_runs"] = {
            mode: [r["tokens_per_s"] for r in rs] for mode, rs in runs.items()}
        lane["fused_over_unfused_tokens_per_s"] = pairs
        lane["median_ratio"] = _median(pairs)
        lane["peak_mem_bytes"] = peak
        lane["unfused"]["profile"] = unfused_profiles[name]
        lane["fused"]["profile"] = phase_profile(
            torch, target, label="fused %s profile" % name, draft=draft,
            fused=True)
        # the launch counts against the profiler's kernel records: it may
        # lose the records of part of the replay it starts in, never more
        prof = lane["fused"]["profile"]
        if prof.get("attention_launches"):
            per = (SPEC_K + 2 if draft is not None else FUSE_STEPS) * n_layers
            want = prof["steps"] * per
            seen = round(prof["attention_launches"])
            check(want - per <= seen <= want,
                  "fused %s: the profiler saw %d attention kernels in %d "
                  "replays, the launch counts %d" % (
                      name, seen, prof["steps"], want))
            lane["profiler_attention_kernels"] = [seen, want]
        log("fused %s: tokens/s %s unfused, %s fused (runs alternated), "
            "per-pair fused/unfused %s, median %.3f; ms per dispatch %.3f "
            "unfused, %.3f fused (%.3f per step); dispatches per token %.4f "
            "-> %.4f, host round trips per token %.4f -> %.4f; masked trips "
            "%s; peak memory %.1f MiB with the graphs' pools; streams "
            "token-identical to the unfused lane"
            % (name, ["%.1f" % x for x in runs_s["unfused"]],
               ["%.1f" % x for x in runs_s["fused"]],
               ["%.3f" % x for x in pairs], lane["median_ratio"],
               lane["unfused"]["dispatch_ms"], lane["fused"]["dispatch_ms"],
               lane["fused"]["step_ms"],
               lane["unfused"]["dispatches_per_token"],
               lane["fused"]["dispatches_per_token"],
               lane["unfused"]["round_trips_per_token"],
               lane["fused"]["round_trips_per_token"],
               lane["fused"].get("masked_trip_share"), peak / 2 ** 20))
        log(json.dumps({"fused_" + name: lane}))
        report[name] = lane
    # an fp32 twin draft proposes the target's own tokens: accepted whole
    # in fused rounds too
    twin = decode.load_decode_predictor(art)
    outs, lane, twin_counts, wall, _, b = _serve(
        torch, pk, batcher, pred, prompts[:4], budgets[:4], draft=twin,
        spec_k=SPEC_K, fuse_steps=FUSE_STEPS)
    check(outs == plain["outs"][:4], "fused fp32 twin: a stream diverged")
    check(lane["proposed"] > 0 and lane["accepted"] == lane["proposed"],
          "fused fp32 twin draft accepted %d of %d" % (lane["accepted"],
                                                        lane["proposed"]))
    _check_lane_launches("fused twin", True, twin_counts,
                         dict(lane, steps=0, trips=0, rounds=0,
                              plain_steps=0), lane, None,
                         b.session.graph_stats(), True, 0, n_layers)
    for k in totals:
        totals[k] += twin_counts[k]
    log("fused fp32 twin: 4 requests, accept rate exactly %.1f (%d drafts) "
        "in %d fused rounds; streams bit-exact"
        % (lane["accepted"] / lane["proposed"], lane["proposed"],
           lane["rounds"]))
    report["fp32_twin_rounds"] = lane["rounds"]
    log(json.dumps({"fused": {"totals": totals,
                              "session_check": check_stats}}))
    return totals["decode_attention"], totals["decode_attention_int8"]


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


def phase_int8_gpu_vs_cpu(torch, decode, art, gpu_pred):
    """The int8 predictor on the card and on the CPU: equal scales (both
    calibrate on the CPU), identical tokens over prefill + 8 steps, and
    int8 caches equal but where a rounding boundary flips one count: at
    most 1e-3 of the live elements, never more than +-1."""
    prompt = [int(t) for t in np.random.RandomState(99).randint(
        0, gpu_pred.vocab_size, size=64)]
    cpu_pred = decode.GenerativePredictor(art, device="cpu",
                                          kv_cache_dtype="int8")
    check(np.array_equal(gpu_pred.kv_scales(), cpu_pred.kv_scales()),
          "int8 gpu/cpu: the calibrated scales differ")
    runs = {}
    for name, pred in (("gpu", gpu_pred), ("cpu", cpu_pred)):
        sess = pred.new_session(1)
        toks = [sess.prefill(0, prompt)]
        for _ in range(8):
            toks.append(int(sess.decode()[0]))
        runs[name] = (toks, sess._kc.cpu(), sess._vc.cpu())
    (gt, gk, gv), (ct, ck, cv) = runs["gpu"], runs["cpu"]
    check(gt == ct, "int8 gpu/cpu tokens differ: gpu %s cpu %s" % (gt, ct))
    live = len(prompt) + len(gt) - 1
    flips = {}
    for name, a, c in (("K", gk, ck), ("V", gv, cv)):
        d = (a[:, :, :live].int() - c[:, :, :live].int()).abs()
        flips[name] = int((d != 0).sum())
        check(int(d.max()) <= 1 and flips[name] <= 1e-3 * d.numel(),
              "int8 gpu/cpu %s caches: %d of %d live elements differ, max "
              "%d" % (name, flips[name], d.numel(), int(d.max())))
    log("int8 gpu/cpu: scales equal, tokens identical %s; cache elements "
        "one count apart over %d positions: K %d, V %d of %d each"
        % (gt, live, flips["K"], flips["V"], gk[:, :, :live].numel()))


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
    # nvjet: cuBLAS's bf16 GEMM kernels on Hopper
    for tag in ("gemm", "gemv", "splitKreduce", "nvjet"):
        if tag in key:
            return "matmul (cuBLAS/CUTLASS)"
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


FLASH_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")


def phase_train(torch, pk, fluid, transformer, amp=False):
    """The training path at full width: startup, then TRAIN_STEPS Adam
    steps on one repeated seeded batch (the loss has to fall).  Launch
    counts are zeroed just before the steps and read just after.  With
    `amp`, `fluid.set_amp(True)` first: the bf16 K1/K2 variants must
    carry every attention launch, and every parameter stays fp32."""
    from torch.profiler import ProfilerActivity, profile
    label = "train amp" if amp else "train"
    main, startup, _, avg_loss, _, _ = transformer.get_model()
    startup.random_seed = TRAIN_SEED
    B, S = 8, 512
    n_layers = 6
    exe = fluid.Executor(fluid.CUDAPlace(0))
    check(exe.device.type == "cuda", "executor not on the card")
    scope = fluid.Scope()
    feed = _batch(np.random.RandomState(TRAIN_SEED), B, S, 32000)
    dtype, other = ((torch.bfloat16, torch.float32) if amp
                    else (torch.float32, torch.bfloat16))
    names = [pk._count_name(n, dtype) for n in FLASH_KERNELS]
    fluid.set_amp(amp)
    try:
        with fluid.scope_guard(scope):
            t0 = time.time()
            exe.run(startup)
            torch.cuda.synchronize()
            n_params = sum(int(np.prod(p.shape))
                           for p in main.all_parameters())
            log("%s: startup on %s in %.2f s (%d parameters, %d persistable"
                " tensors)" % (label, exe.device, time.time() - t0,
                               n_params, len(list(scope.keys()))))
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
            log("%s: losses %s" % (label, ["%.5f" % x for x in losses]))
            check(all(np.isfinite(losses)), "%s: non-finite loss" % label)
            check(losses[-1] < losses[0] - 0.1
                  and min(losses[-3:]) < losses[0],
                  "%s: the loss did not fall over %d steps on one batch: %s"
                  % (label, TRAIN_STEPS, losses))
            for name in names:
                check(counts[name] == n_layers * TRAIN_STEPS,
                      "%s: %s launched %d times in %d steps x %d layers"
                      % (label, name, counts[name], TRAIN_STEPS, n_layers))
            for name in FLASH_KERNELS:
                name = pk._count_name(name, other)
                check(counts[name] == 0, "%s: %s launched %d times"
                      % (label, name, counts[name]))
            check(counts["decode_attention"] == 0,
                  "decode_attention launched on the training path")
            masters = {p.name: scope.get(p.name).dtype
                       for p in main.all_parameters()}
            check(all(d == torch.float32 for d in masters.values()),
                  "%s: parameters not fp32: %s" % (label, {
                      k: str(d) for k, d in masters.items()
                      if d != torch.float32}))
            steady = sorted(step_s[1:])
            step_ms = float(np.median(steady)) * 1e3
            stats = {"batch": B, "seq": S, "steps": TRAIN_STEPS,
                     "losses": losses, "step_ms": [x * 1e3 for x in step_s],
                     "median_step_ms": step_ms,
                     "tokens_per_s": B * S / (step_ms / 1e3),
                     "first_step_ms": step_s[0] * 1e3,
                     "launches": counts, "peak_mem_bytes": peak}
            log("%s: %d steps of %d tokens: median step %.3f ms (first "
                "%.1f ms) -> %.1f tokens/s; launches per step: %s; all %d "
                "parameters fp32; peak memory %.1f MiB"
                % (label, TRAIN_STEPS, B * S, step_ms, step_s[0] * 1e3,
                   stats["tokens_per_s"],
                   ", ".join("%s %g" % (n, counts[n] / TRAIN_STEPS)
                             for n in names), len(masters), peak / 2 ** 20))
            log(json.dumps({label.replace(" ", "_"): stats}))

            # where one step's time goes
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                exe.run(main, feed=feed, fetch_list=[avg_loss])
                prof_step_ms = (time.perf_counter() - t0) * 1e3
    finally:
        fluid.set_amp(False)
    device_ms, rows = profile_rows(torch, prof, 1)
    if not rows:
        log("%s profile: torch.profiler saw no device time; device busy "
            "share not measured" % label)
        return counts
    n_launches = sum(r[1] for r in rows)
    n_ops = len(main.global_block().ops)
    log("%s profile: one step, host %.3f ms under the profiler (%.3f "
        "ms without): %d program ops, %d kernel launches, device busy "
        "%.3f ms = %.1f%% of the unprofiled step (idle %.1f%%)"
        % (label, prof_step_ms, step_ms, n_ops, n_launches, device_ms,
           100 * device_ms / step_ms, 100 - 100 * device_ms / step_ms))
    groups = {}
    for us, count, key in rows:
        g = groups.setdefault(_kernel_group(key), [0.0, 0])
        g[0] += us
        g[1] += count
    for name, (us, count) in sorted(groups.items(), key=lambda x: -x[1][0]):
        log("%s profile:   %10.2f us  %5d launches  [%s]"
            % (label, us, count, name))
    for us, count, key in rows[:15]:
        log("%s profile:   %10.2f us  %5d launches  %s"
            % (label, us, count, key[:110]))
    log(json.dumps({label.replace(" ", "_") + "_profile": {
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



# the training width of phase_train (transformer.get_model's defaults)
TR_WIDTH = dict(vocab_size=32000, d_model=512, n_heads=8, n_layers=6,
                d_ff=2048)
TR_STEPS = 8
TR_RESUME_AT = 4
TR_POISON = 2
TR_SEED = 11
TR_DEPTH = 2
TR_PREFETCH = 2


def _trainer_funcs(fluid, transformer, width, loss_scale=False):
    """(train_func, optimizer_func) of the network `get_model` builds at
    `width` (batch 8 x seq 512); with `loss_scale`, the mean loss is
    multiplied by a fed [1] float (1.0 leaves every value as it is; NaN
    poisons the step)."""
    seq = 512

    def train_func():
        tokens = fluid.layers.data("tokens", shape=[seq], dtype="int64")
        labels = fluid.layers.data("labels", shape=[seq], dtype="int64")
        logits = transformer.build(tokens, width["vocab_size"], seq,
                                   width["d_model"], width["n_heads"],
                                   width["n_layers"], width["d_ff"])
        flat = fluid.layers.reshape(logits, [-1, width["vocab_size"]])
        flat_l = fluid.layers.reshape(labels, [-1, 1])
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(flat, flat_l))
        if loss_scale:
            scale = fluid.layers.data("loss_scale", shape=[1],
                                      dtype="float32",
                                      append_batch_size=False)
            loss = fluid.layers.elementwise_mul(loss, scale)
        return loss

    return train_func, (lambda: fluid.optimizer.Adam(learning_rate=1e-3))


def _train_once(torch, fluid, FLAGS, tf, of, reader, depth=0, prefetch=0,
                cfg=None, stop_after=None, dropout=True, sentinel=False,
                on_dispatch=None, profiler=None):
    """One Trainer on the card in a fresh scope, trained one epoch of
    `reader`: (losses in EndStepEvent order, wall stamps of the events,
    final persistables, the Trainer, warnings)."""
    import warnings
    FLAGS.async_dispatch_depth = depth
    FLAGS.reader_prefetch_depth = prefetch
    FLAGS.sentinel_nan_check = sentinel
    FLAGS.sentinel_policy = "skip"
    FLAGS.sentinel_max_bad_steps = 3
    try:
        with fluid.scope_guard(fluid.Scope()) as scope:
            tr = fluid.contrib.Trainer(tf, of, place=fluid.CUDAPlace(0),
                                       checkpoint_config=cfg)
            if not dropout:
                for op in tr.train_program.global_block().ops:
                    if op.type == "dropout":
                        op.attrs["dropout_prob"] = 0.0
            if on_dispatch is not None:
                run = tr.exe.run
                tr.exe.run = lambda *a, **kw: on_dispatch(run, *a, **kw)
            losses, stamps = [], []

            def handler(ev):
                if isinstance(ev, fluid.contrib.EndStepEvent):
                    losses.append(np.asarray(ev.metrics[0]).copy())
                    stamps.append(time.perf_counter())
                    if stop_after is not None and len(losses) >= stop_after:
                        tr.stop()

            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t0 = time.perf_counter()
                if profiler is not None:
                    with profiler:
                        tr.train(1, handler, reader=reader)
                        torch.cuda.synchronize()
                else:
                    tr.train(1, handler, reader=reader)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            state = {n: scope.get(n) for n in scope.keys()
                     if scope.get(n) is not None}
            return {"losses": losses, "stamps": stamps, "state": state,
                    "trainer": tr, "wall": wall,
                    "warnings": [str(w.message) for w in caught]}
    finally:
        FLAGS.async_dispatch_depth = 0
        FLAGS.reader_prefetch_depth = 0
        FLAGS.sentinel_nan_check = False


def _steps_per_s(run):
    """Steps a second over the run's EndStepEvents after the first."""
    st = run["stamps"]
    return (len(st) - 1) / (st[-1] - st[0]) if len(st) > 1 else None


def phase_trainer(torch, pk, fluid, transformer):
    """The Fluid training runtime on the card: `fluid.contrib.Trainer`
    training the full-width transformer (the network `get_model` builds:
    vocab 32000, d_model 512, 8 heads, 6 layers, d_ff 2048, batch 8 x
    512, fp32, Adam 1e-3) from a host reader of TR_STEPS seeded batches.
    Gates: a sync run (depth 0) and an async run (async depth 2, prefetch
    depth 2) from the same startup state give bit-identical losses; the
    async run launches K1, K2-dq and K2-dkv 6 x TR_STEPS times each; its
    every dispatch passes under torch.cuda.set_sync_debug_mode("error");
    a run stopped after TR_RESUME_AT steps with a CheckpointConfig and
    resumed in a new Trainer gives the uninterrupted losses; a sentinel
    skip of a NaN batch at depth 2 (dropout 0) leaves the state bit-equal
    to a run that never saw the batch.  Prints steps/s and the device
    busy share of the sync and async runs."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.flags import FLAGS
    from paddle_tpu_torch.fluid import checkpoint as ckpt
    rng = np.random.RandomState(TR_SEED)
    data = [_batch(rng, 8, 512, TR_WIDTH["vocab_size"])
            for _ in range(TR_STEPS)]

    def reader():
        for d in data:
            yield d

    tf, of = _trainer_funcs(fluid, transformer, TR_WIDTH)
    names = [pk._count_name(n, torch.float32) for n in FLASH_KERNELS]
    n_layers = TR_WIDTH["n_layers"]

    # 1. sync and async from the same startup state
    t0 = time.time()
    sync = _train_once(torch, fluid, FLAGS, tf, of, reader)
    log("trainer: sync run, %d steps: losses %s (%.1f s with the Trainer's "
        "build and startup)" % (TR_STEPS, ["%.5f" % float(x) for x in
                                          sync["losses"]], time.time() - t0))
    dispatches = {"n": 0, "error": None}

    def no_sync_dispatch(run, *a, **kw):
        if not kw.get("as_future"):
            return run(*a, **kw)
        dispatches["n"] += 1
        torch.cuda.set_sync_debug_mode("error")
        try:
            return run(*a, **kw)
        except RuntimeError as e:
            import traceback
            dispatches["error"] = traceback.format_exc()
            raise
        finally:
            torch.cuda.set_sync_debug_mode(0)

    pk.reset_launch_counts()
    t0 = time.time()
    try:
        asy = _train_once(torch, fluid, FLAGS, tf, of, reader,
                          depth=TR_DEPTH, prefetch=TR_PREFETCH,
                          on_dispatch=no_sync_dispatch)
    except Exception:
        if dispatches["error"]:
            log("trainer: a dispatch synchronized the host:\n%s"
                % dispatches["error"])
        raise
    counts = dict(pk.launch_counts)
    log("trainer: async run (depth %d, prefetch %d), %d steps: losses %s "
        "(%.1f s)" % (TR_DEPTH, TR_PREFETCH, TR_STEPS,
                      ["%.5f" % float(x) for x in asy["losses"]],
                      time.time() - t0))
    check(len(sync["losses"]) == len(asy["losses"]) == TR_STEPS,
          "trainer: %d sync and %d async steps" % (len(sync["losses"]),
                                                   len(asy["losses"])))
    check(all(np.isfinite(float(x)) for x in sync["losses"]),
          "trainer: non-finite sync loss")
    check(all(np.array_equal(a, b) for a, b in zip(sync["losses"],
                                                    asy["losses"])),
          "trainer: async losses are not the sync ones bit for bit")
    check(all(torch.equal(sync["state"][n], asy["state"][n])
              for n in sync["state"]),
          "trainer: the async run's state differs from the sync run's")
    for name in names:
        check(counts[name] == n_layers * TR_STEPS,
              "trainer: %s launched %d times in %d async steps x %d layers"
              % (name, counts[name], TR_STEPS, n_layers))
    check(dispatches["n"] == TR_STEPS,
          "trainer: %d dispatches under sync debug mode, %d steps"
          % (dispatches["n"], TR_STEPS))
    log("trainer: async = sync bit for bit (losses and all %d persistables); "
        "launches %s; %d dispatches passed set_sync_debug_mode('error')"
        % (len(sync["state"]), {n: counts[n] for n in names},
           dispatches["n"]))

    # 2. busy share: the same two runs under torch.profiler
    stats = {}
    for label, run, kw in (("sync", sync, {}),
                           ("async", asy, {"depth": TR_DEPTH,
                                           "prefetch": TR_PREFETCH})):
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        _train_once(torch, fluid, FLAGS, tf, of, reader, profiler=prof,
                    **kw)
        device_ms, rows = profile_rows(torch, prof, TR_STEPS)
        sps = _steps_per_s(run)
        step_ms = 1e3 / sps
        busy = device_ms / step_ms if rows else None
        stats[label] = {"steps_per_s": sps, "step_ms": step_ms,
                        "device_ms_per_step": device_ms if rows else None,
                        "busy_share": busy}
        log("trainer %s: %.3f steps/s (%.3f ms a step over EndStepEvents "
            "2..%d, unprofiled); device %s ms a step (profiled run) -> "
            "busy share %s" % (label, sps, step_ms, TR_STEPS,
                               "%.3f" % device_ms if rows else "not measured",
                               "%.1f%%" % (100 * busy) if rows
                               else "not measured"))
    del sync["trainer"], asy["trainer"]
    sync_losses = sync["losses"]
    del sync, asy
    torch.cuda.empty_cache()

    # 3. stopped after TR_RESUME_AT steps, resumed in a new Trainer
    with tempfile.TemporaryDirectory() as tmp:
        vault = os.path.join(tmp, "vault")
        t0 = time.time()
        first = _train_once(
            torch, fluid, FLAGS, tf, of, reader, stop_after=TR_RESUME_AT,
            cfg=fluid.contrib.CheckpointConfig(
                checkpoint_dir=vault, step_interval=TR_RESUME_AT))
        latest = ckpt.latest_checkpoint(vault)
        check(latest is not None, "trainer: no checkpoint committed")
        manifest = ckpt.verify_checkpoint_dir(latest)
        nbytes = sum(e["nbytes"] for e in manifest["arrays"].values())
        t_save = time.time() - t0
        t0 = time.time()
        rest = _train_once(
            torch, fluid, FLAGS, tf, of, reader,
            cfg=fluid.contrib.CheckpointConfig(
                checkpoint_dir=vault, step_interval=10 ** 6))
        t_resume = time.time() - t0
        del first["trainer"], rest["trainer"]
    resumed = first["losses"] + rest["losses"]
    log("trainer resume: stopped after %d steps, checkpoint %s (%d arrays, "
        "%.1f MB, CRC-verified, meta %s) in %.1f s; resumed %d steps in %.1f "
        "s: losses %s" % (TR_RESUME_AT, os.path.basename(latest),
                          len(manifest["arrays"]), nbytes / 1e6,
                          manifest["meta"], t_save, len(rest["losses"]),
                          t_resume, ["%.5f" % float(x) for x in resumed]))
    check(len(resumed) == TR_STEPS and all(
        np.array_equal(a, b) for a, b in zip(resumed, sync_losses)),
          "trainer: the resumed run's losses differ from the "
          "uninterrupted run's")
    del first, rest
    torch.cuda.empty_cache()

    # 4. the sentinel skips a NaN batch with two steps in flight
    tfs, ofs = _trainer_funcs(fluid, transformer, TR_WIDTH,
                              loss_scale=True)
    one = np.ones(1, np.float32)
    nan = np.full(1, np.nan, np.float32)
    poisoned = [dict(d, loss_scale=nan if i == TR_POISON else one)
                for i, d in enumerate(data)]
    clean = [dict(d, loss_scale=one) for i, d in enumerate(data)
             if i != TR_POISON]
    t0 = time.time()
    hit = _train_once(torch, fluid, FLAGS, tfs, ofs,
                      lambda: iter(poisoned), depth=TR_DEPTH,
                      prefetch=TR_PREFETCH, dropout=False, sentinel=True)
    ref = _train_once(torch, fluid, FLAGS, tfs, ofs, lambda: iter(clean),
                      dropout=False)
    reverted = [w for w in hit["warnings"] if "reverted" in w]
    log("trainer sentinel: NaN batch at step %d, depth %d: %s; %d steps "
        "observed, losses %s; clean run of %d batches: %s (%.1f s)"
        % (TR_POISON, TR_DEPTH, reverted, len(hit["losses"]),
           ["%.5f" % float(x) for x in hit["losses"]], len(clean),
           ["%.5f" % float(x) for x in ref["losses"]], time.time() - t0))
    check(reverted and any("re-dispatched" in w for w in reverted),
          "trainer: the sentinel did not revert and redispatch: %s"
          % hit["warnings"])
    check(sorted(hit["state"]) == sorted(ref["state"]) and all(
        torch.equal(hit["state"][n], ref["state"][n]) for n in ref["state"]),
          "trainer: the state after the sentinel's skip differs from the "
          "run that never saw the batch: %s" % [
              n for n in ref["state"]
              if not torch.equal(hit["state"][n], ref["state"][n])][:5])
    log("trainer sentinel: state bit-equal to the clean run (%d "
        "persistables)" % len(ref["state"]))
    del hit, ref
    torch.cuda.empty_cache()
    log(json.dumps({"trainer": stats}))
    return stats


PIPE_STALL_MS = 20.0
PIPE_ITERS = 20


def phase_pipeline_bench(torch, fluid):
    """`fluid_benchmark --model resnet` on the card, whole-graph AMP,
    NHWC, batch 32, with `--host_stall_ms 20` on the feed path: once with
    `--prefetch_depth 2 --async_depth 2`, once with neither.  Gate: both
    finish with finite losses (benchmark raises otherwise).  Prints
    images/s and the busy share (device ms a step from the trace of
    staged steps over the pipelined loop's ms a step), and whether the
    stall was hidden."""
    from paddle_tpu_torch import fluid_benchmark as fb
    out = {}
    for label, extra in (("pipelined", ["--prefetch_depth", "2",
                                        "--async_depth", "2"]),
                         ("serial", [])):
        argv = ["--model", "resnet", "--layout", "NHWC", "--whole_graph_ad",
                "--batch_size", "32", "--iterations", str(PIPE_ITERS),
                "--host_stall_ms", str(PIPE_STALL_MS), "--trace_steps",
                "3"] + extra
        t0 = time.time()
        rec, _ = fb.benchmark(fb.parse_args(argv))
        torch.cuda.empty_cache()
        check(np.isfinite(rec["last_loss"]),
              "pipeline %s: loss %r" % (label, rec["last_loss"]))
        dev = rec["trace"]["device_ms"]
        busy = dev / rec["ms_per_step"] if rec["trace"]["busy_share"] \
            is not None else None
        out[label] = {"examples_per_sec": rec["examples_per_sec"],
                      "ms_per_step": rec["ms_per_step"],
                      "device_ms_per_step": dev, "busy_share": busy,
                      "last_loss": rec["last_loss"]}
        log("pipeline %s (%s): %.1f images/s, %.3f ms a step, device %.3f "
            "ms a step -> busy share %.1f%%, last loss %.5f (%.1f s)"
            % (label, " ".join(extra) or "no prefetch, no async",
               rec["examples_per_sec"], rec["ms_per_step"], dev,
               100 * busy, rec["last_loss"], time.time() - t0))
    saved = out["serial"]["ms_per_step"] - out["pipelined"]["ms_per_step"]
    log("pipeline: the %.0f ms host stall was %s (the pipelined step is "
        "%.3f ms shorter)" % (PIPE_STALL_MS, "hidden" if saved >=
                              0.5 * PIPE_STALL_MS else "not hidden", saved))
    log(json.dumps({"pipeline": out}))
    return out

RESNET_SEED = 7
RESNET_BATCHES = (1, 8, 64)
RESNET_RUNS = {1: 200, 8: 100, 64: 20}
# pairs of fused and unfused runs, alternated: where the host decides
# (batches 1, 8) and where K6-bf16 decides the bf16 lane (batch 64)
RESNET_AB_RUNS = {1: 300, 8: 200, 64: 40}
FUSE_GATE = 128


def _bn_statistics(torch, fluid, program, scope, rng):
    """Seeded, non-trivial batch-norm parameters and moving statistics (the
    startup program's are gamma 1, beta 0, mean 0, var 1): scales in [0.5,
    1), variances in [1, 3), shifts and means N(0, 0.1) — so each block
    damps its branch and the softmax is not saturated."""
    for v in program.global_block().vars.values():
        kind = v.name.split(".")[-1]
        if not v.persistable or not v.name.startswith("batch_norm"):
            continue
        shape = tuple(v.shape)
        if kind.startswith("w_"):
            a = 0.5 + 0.5 * rng.rand(*shape)
        elif kind.startswith("var"):
            a = 1.0 + 2.0 * rng.rand(*shape)
        else:
            a = 0.1 * rng.randn(*shape)
        scope.set(v.name, torch.from_numpy(a.astype(np.float32)).to(
            scope.get(v.name).device))


def build_resnet_artifact(torch, fluid, resnet, dirname, place, hw=None):
    """ResNet-50 (NHWC) from the startup program on `place`, with seeded
    batch-norm statistics, saved with save_inference_model.  `hw`
    replaces the 224 x 224 input by a smaller one (same widths)."""
    if hw is None:
        main, startup, _, _, _, predict = resnet.get_model(
            batch_size=64, depth=50, dataset="imagenet", is_train=False,
            layout="NHWC")
    else:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            img = fluid.layers.data(name="data", shape=[hw, hw, 3],
                                    dtype="float32")
            predict = resnet.resnet_imagenet(img, class_dim=1000, depth=50,
                                             is_train=False, layout="NHWC")
    startup.random_seed = RESNET_SEED
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        _bn_statistics(torch, fluid, main, scope,
                       np.random.RandomState(RESNET_SEED))
        fluid.save_inference_model(dirname, ["data"], [predict], exe,
                                   main_program=main)
    return main


def _images(batch, seed, hw=224):
    return np.random.RandomState(seed).randn(batch, hw, hw, 3).astype(
        np.float32)


def _profile_run(torch, run, images):
    """Device busy ms and kernel launches of one run(images), from
    torch.profiler; (None, None) when it sees no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(images)
        torch.cuda.synchronize()
    device_ms, rows = profile_rows(torch, prof, 1)
    if not rows:
        return None, None, []
    return device_ms, sum(r[1] for r in rows), rows


def _resnet_group(key):
    if "paddle_bottleneck" in key:
        return "K6 fused_bottleneck"
    if "paddle_dequant" in key:
        return "K5 dequant_matmul"
    for tag, group in (("conv", "convolution (cuDNN)"),
                       ("implicit", "convolution (cuDNN)"),
                       ("xmma", "convolution (cuDNN)"),
                       ("gemm", "matmul"), ("gemv", "matmul"),
                       ("nvjet", "matmul"),
                       ("pool", "pooling"), ("reduce", "reduction"),
                       ("elementwise", "elementwise"),
                       ("Memcpy", "memcpy"), ("Memset", "memset"),
                       ("copy", "copy")):
        if tag in key:
            return group
    return "other"


def serve_resnet(torch, pk, run, lane, kernel, per_run, stage=None,
                 sum_atol=1e-4):
    """run(images) -> host probabilities (a Predictor.run, or an
    Executor.run and its fetch's host copy) at each batch of
    RESNET_BATCHES, on seeded images (`stage` makes the feed from them
    once, outside the timed runs): the first run of a batch warms it,
    then RESNET_RUNS[batch] runs with the launch counts zeroed just before
    and read just after; `kernel` must launch exactly `per_run` times per
    run.  Returns {batch: (stats, the outputs)}."""
    out = {}
    for b in RESNET_BATCHES:
        images = _images(b, 100 + b)
        if stage is not None:
            images = stage(images)
        run(images)
        torch.cuda.synchronize()
        runs = RESNET_RUNS[b]
        torch.cuda.reset_peak_memory_stats()
        pk.reset_launch_counts()
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            probs = run(images)   # host arrays: synced
            times.append(time.perf_counter() - t0)
        counts = dict(pk.launch_counts)
        # the median run: the host is shared, and a mean takes its stalls
        wall = float(np.median(times))
        p10, p90 = np.percentile(times, [10, 90]) * 1e3
        peak = torch.cuda.max_memory_allocated()
        check(probs.shape == (b, 1000) and bool(np.isfinite(probs).all()),
              "%s b=%d: predictions of shape %s, finite %s"
              % (lane, b, probs.shape, np.isfinite(probs).all()))
        check(bool(np.allclose(probs.sum(1), 1.0, atol=sum_atol)),
              "%s b=%d: softmax rows do not sum to 1 within %g"
              % (lane, b, sum_atol))
        if kernel is not None:
            check(counts[kernel] == per_run * runs,
                  "%s b=%d: %s launched %d times in %d runs (want %d per "
                  "run)" % (lane, b, kernel, counts[kernel], runs, per_run))
        others = {k: v for k, v in counts.items() if k != kernel and v}
        check(not others, "%s b=%d: other kernels launched: %s"
              % (lane, b, others))
        device_ms, launches, rows = _profile_run(torch, run, images)
        stats = {"batch": b, "runs": runs, "ms_per_run": wall * 1e3,
                 "ms_p10": float(p10), "ms_p90": float(p90),
                 "ms_mean": float(np.mean(times)) * 1e3,
                 "images_per_s": b / wall,
                 "kernel_launches_per_run": (counts[kernel] / runs
                                             if kernel else 0),
                 "device_busy_ms": device_ms,
                 "device_busy_share": (device_ms / (wall * 1e3)
                                       if device_ms else None),
                 "launches_per_run": launches, "peak_mem_bytes": peak}
        groups = {}
        for us, count, key in rows:
            gr = groups.setdefault(_resnet_group(key), [0.0, 0])
            gr[0] += us
            gr[1] += count
        stats["groups"] = {k: {"us": v[0], "launches": v[1]}
                           for k, v in groups.items()}
        busy = ("device busy %.3f ms (%.1f%% of the run), %d kernel "
                "launches/run" % (device_ms, 100 * device_ms / (wall * 1e3),
                                  launches) if device_ms else
                "device busy not measured (the profiler saw no device time)")
        log("%s b=%d: median %.3f ms/run (p10 %.3f, p90 %.3f, mean %.3f over "
            "%d runs) -> %.1f images/s; %s %g launches/run; %s; peak memory "
            "%.1f MiB"
            % (lane, b, wall * 1e3, p10, p90, stats["ms_mean"], runs,
               b / wall, kernel or "no hand kernel",
               stats["kernel_launches_per_run"], busy, peak / 2 ** 20))
        for name, (us, count) in sorted(groups.items(),
                                        key=lambda x: -x[1][0]):
            log("%s b=%d profile:   %10.2f us  %5d launches  [%s]"
                % (lane, b, us, count, name))
        out[b] = (stats, probs)
    return out


def interleaved_ab(runs, label="resnet fp32", stage=None):
    """The fused and unfused lanes ({"fused": run, "unfused": run}, each
    run(images) -> host outputs) alternated run by run (the order flips
    every pair) on one image batch at each batch of RESNET_AB_RUNS, so
    both see the same host: median ms of each and the median of the
    per-pair ratio fused / unfused."""
    out = {}
    for b, pairs in RESNET_AB_RUNS.items():
        images = _images(b, 100 + b)
        if stage is not None:
            images = stage(images)
        times = {"fused": [], "unfused": []}
        for i in range(pairs):
            for name in (("fused", "unfused") if i % 2 == 0
                         else ("unfused", "fused")):
                t0 = time.perf_counter()
                runs[name](images)
                times[name].append(time.perf_counter() - t0)
        fused, unfused = (np.array(times[k]) for k in ("fused", "unfused"))
        out[b] = {"pairs": pairs, "fused_ms": float(np.median(fused)) * 1e3,
                  "unfused_ms": float(np.median(unfused)) * 1e3,
                  "ratio": float(np.median(fused / unfused)),
                  "ratio_p10_p90": [float(r) for r in
                                    np.percentile(fused / unfused, [10, 90])]}
        log("%s A/B b=%d, %d alternated pairs: fused median %.3f ms, "
            "unfused median %.3f ms, fused/unfused per pair median %.3f "
            "(p10 %.3f, p90 %.3f)" % (label, b, pairs, out[b]["fused_ms"],
                                      out[b]["unfused_ms"], out[b]["ratio"],
                                      *out[b]["ratio_p10_p90"]))
    return out


def _agreement(ref, got):
    d = np.abs(ref.astype(np.float64) - got.astype(np.float64))
    return {"max_abs": float(d.max()), "mean_abs": float(d.mean()),
            "top1_agreement": float((ref.argmax(1) == got.argmax(1)).mean())}


def phase_resnet(torch, pk, fluid, resnet, inference, tmp):
    """ResNet-50 through the user's entry points on the card: startup and
    save_inference_model, then the fp32 Predictor at FUSE_GATE (7 K6
    launches per run) and unfused (gate 0, the default; no K6), the two
    alternated at batches 1, 8 and 64, then the PTQ artifact's int8 Predictor
    (1 K5 launch per run)."""
    from paddle_tpu_torch.flags import FLAGS
    art = os.path.join(tmp, "resnet50")
    t0 = time.time()
    main = build_resnet_artifact(torch, fluid, resnet, art,
                                 fluid.CUDAPlace(0))
    n_bytes = sum(os.path.getsize(os.path.join(art, f))
                  for f in os.listdir(art))
    log("resnet: built and saved ResNet-50 (224x224, 1000 classes, NHWC) "
        "in %.2f s: %d program ops, %d artifact bytes"
        % (time.time() - t0, len(main.global_block().ops), n_bytes))
    lanes, preds = {}, {}
    for name, gate, kernel, per_run in (("fused", FUSE_GATE,
                                         "fused_bottleneck", 7),
                                        ("unfused", 0, None, 0)):
        FLAGS.fuse_bottleneck_max_width = gate
        try:
            t0 = time.time()
            pred = inference.create_paddle_predictor(
                inference.AnalysisConfig(model_dir=art))
        finally:
            FLAGS.fuse_bottleneck_max_width = 0
        ops = [op.type for op in pred.program.global_block().ops]
        check(pred.device.type == "cuda", "predictor not on the card")
        check(ops.count("fused_bottleneck") == per_run,
              "%s: %d fused_bottleneck ops, want %d"
              % (name, ops.count("fused_bottleneck"), per_run))
        log("resnet fp32 %s (gate %d): predictor in %.2f s, %d program ops"
            % (name, gate, time.time() - t0, len(ops)))
        lanes[name] = serve_resnet(torch, pk, lambda im: pred.run([im])[0],
                                   "resnet fp32 " + name, kernel, per_run)
        lanes[name + "_ops"] = len(ops)
        del pred
        torch.cuda.empty_cache()
    # both fp32 Predictors at once (after the lanes, so that each lane's
    # peak memory is its own), alternated run by run
    for name, gate in (("fused", FUSE_GATE), ("unfused", 0)):
        FLAGS.fuse_bottleneck_max_width = gate
        try:
            preds[name] = inference.create_paddle_predictor(
                inference.AnalysisConfig(model_dir=art))
        finally:
            FLAGS.fuse_bottleneck_max_width = 0
    ab = interleaved_ab({name: (lambda im, p=p: p.run([im]))
                         for name, p in preds.items()})
    del preds
    torch.cuda.empty_cache()
    for b in RESNET_BATCHES:
        ref, got = lanes["unfused"][b][1], lanes["fused"][b][1]
        agree = _agreement(ref, got)
        # K6 and cuDNN sum in other orders: probabilities agree to a
        # tolerance scaled by the largest
        atol = 1e-4 * float(np.abs(ref).max())
        check(bool((np.abs(ref - got) <= atol + 1e-4 * np.abs(ref)).all()),
              "resnet b=%d: fused and unfused predictions disagree (%s, "
              "atol %.3g, rtol 1e-4)" % (b, agree, atol))
        check(agree["top1_agreement"] == 1.0,
              "resnet b=%d: fused and unfused top-1 differ" % b)
        log("resnet fp32 b=%d: fused vs unfused max |d| %.3g, mean |d| "
            "%.3g, top-1 identical; max prob %.3g"
            % (b, agree["max_abs"], agree["mean_abs"], float(ref.max())))

    # the int8 lane: PTQ of the same artifact, 4 seeded calibration batches
    dst = art + "_int8"
    calib = [{"data": _images(8, 200 + i)} for i in range(4)]
    t0 = time.time()
    summary = inference.quantize_inference_model(art, dst,
                                                 calib_feeds=calib)
    log("resnet int8: PTQ in %.2f s: %d weights quantized, bytes ratio %s, "
        "calibration %s" % (time.time() - t0, summary["n_quantized"],
                            summary["bytes"]["ratio"],
                            summary["calibration"]))
    pred = inference.create_paddle_predictor(
        inference.AnalysisConfig(model_dir=dst))
    check(pred.precision == "int8", "the PTQ artifact serves %s"
          % pred.precision)
    ops = [op.type for op in pred.program.global_block().ops]
    check(ops.count("dequant_mul") == 1 and "fused_bottleneck" not in ops,
          "int8 program: %d dequant_mul, %d fused_bottleneck"
          % (ops.count("dequant_mul"), ops.count("fused_bottleneck")))
    lanes["int8"] = serve_resnet(torch, pk, lambda im: pred.run([im])[0],
                                 "resnet int8", "dequant_matmul", 1)
    lanes["int8_ops"] = len(ops)
    del pred
    torch.cuda.empty_cache()
    deltas = {}
    for b in RESNET_BATCHES:
        deltas[b] = _agreement(lanes["unfused"][b][1], lanes["int8"][b][1])
        log("resnet int8 b=%d vs fp32: max |d| %.3g, mean |d| %.3g, top-1 "
            "agreement %.3f" % (b, deltas[b]["max_abs"],
                                deltas[b]["mean_abs"],
                                deltas[b]["top1_agreement"]))
    log(json.dumps({"resnet": {
        "fp32_fused": {b: lanes["fused"][b][0] for b in RESNET_BATCHES},
        "fp32_unfused": {b: lanes["unfused"][b][0] for b in RESNET_BATCHES},
        "fp32_ab": ab,
        "int8": {b: lanes["int8"][b][0] for b in RESNET_BATCHES},
        "program_ops": {"fused": lanes["fused_ops"],
                        "unfused": lanes["unfused_ops"],
                        "int8": lanes["int8_ops"]},
        "int8_vs_fp32": deltas, "bytes_ratio": summary["bytes"]["ratio"],
        "calibration": summary["calibration"]}}))
    # launches over every counted run of the lane, all batches; the fp32
    # unfused lane's outputs, for the bf16 lane's agreement
    return (_lane_launches(lanes["fused"]), _lane_launches(lanes["int8"]),
            {b: lanes["unfused"][b][1] for b in RESNET_BATCHES})


# the serving phase's image points, (target QPS, seconds) open-loop: the
# fp32 points, the int8 lane's point and the profiled point.  A load
# generator in a process of its own drives them, so that no client thread
# shares the server's interpreter lock; it runs one point per line of its
# standard input (run_point's keywords as JSON) and prints its record.
SERVE_BUCKETS = (1, 8, 32)
SERVE_POINTS = ((25.0, 3.0), (100.0, 3.0), (200.0, 3.0))
SERVE_INT8_POINT = (25.0, 2.0)
SERVE_PROFILE_POINT = (100.0, 1.5)
_SERVE_CLIENT = """
import json, sys
from paddle_tpu_torch import bench_serving
for line in iter(sys.stdin.readline, ""):
    rec = bench_serving.run_point(sys.argv[1], **json.loads(line))
    print(json.dumps(rec), flush=True)
"""
SERVE_DEADLINE_MS = 5000.0
SERVE_HW = 224


def phase_serving(torch, pk, inference, decode, tmp, plain, int8_outs):
    """The serving front end through the wire on the card (the docstring's
    `serving` phase).  Returns the hand kernels' launches through the
    server: {kernel name: launches}, counted from zero just before the
    points are driven and read just after."""
    from paddle_tpu_torch import bench_serving
    from paddle_tpu_torch.flags import FLAGS
    from paddle_tpu_torch.obs import registry as obs_registry
    from paddle_tpu_torch.serving import InferenceServer, ServingClient
    t_phase = time.time()
    art = os.path.join(tmp, "resnet50")
    art8 = art + "_int8"
    lm = os.path.join(tmp, "lm_serve")
    decode.build_tiny_decode_model(lm, **FULL_WIDTH)
    prompts, budgets = plain["prompts"], plain["budgets"]
    srv = InferenceServer("127.0.0.1:0", replicas="cuda:0").start()
    cli = ServingClient(srv.endpoint)
    client = None
    try:
        t0 = time.time()
        FLAGS.fuse_bottleneck_max_width = FUSE_GATE
        try:
            rep = cli.load_model("resnet50", art, buckets=SERVE_BUCKETS)
        finally:
            FLAGS.fuse_bottleneck_max_width = 0
        rep8 = cli.load_model("resnet50", art8, buckets=SERVE_BUCKETS)
        loads = {"resnet50": rep, "resnet50@int8": rep8}
        for name, kv in (("lm", "float32"), ("lm8", "int8")):
            loads[name] = cli.load_model(name, lm, decode_slots=N_SLOTS,
                                         fuse_steps=FUSE_STEPS,
                                         kv_cache_dtype=kv)
        check(all(r["devices"] == ["cuda:0"] for r in loads.values()),
              "a served model is not on cuda:0: %s"
              % {k: r["devices"] for k, r in loads.items()})
        check((rep["precision"], rep8["precision"]) == ("fp32", "int8"),
              "resnet50 lanes %s / %s" % (rep["precision"],
                                          rep8["precision"]))
        log("serving: server on %s; 4 loads (each replica warmed) in "
            "%.2f s" % (srv.endpoint, time.time() - t0))

        client = subprocess.Popen(
            [sys.executable, "-c", _SERVE_CLIENT, srv.endpoint],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            env=dict(os.environ, PYTHONPATH=os.path.dirname(
                os.path.abspath(__file__))))

        def image_point(qps, secs, seed, precision=None):
            """One open-loop resnet50 point from the client process, and
            the server's mean stage ms over it."""
            before = obs_registry.default().span_totals(kind="serving")
            client.stdin.write(json.dumps(dict(
                model="resnet50", feed_name="data",
                sample_shape=[SERVE_HW, SERVE_HW, 3], dtype="float32",
                target_qps=qps, duration=secs, req_batch=1,
                deadline_ms=SERVE_DEADLINE_MS, seed=seed,
                precision=precision)) + "\n")
            client.stdin.flush()
            line = client.stdout.readline()
            check(line, "serving: the load generator process died (exit "
                  "%s)" % client.poll())
            return json.loads(line), _stage_means(
                obs_registry.default().span_totals(kind="serving"), before)

        pk.reset_launch_counts()
        points, stages = [], []
        for i, (qps, secs) in enumerate(SERVE_POINTS):
            rec, st = image_point(qps, secs, seed=i)
            points.append(rec)
            stages.append(st)
        int8_point, int8_stages = image_point(*SERVE_INT8_POINT, seed=7,
                                              precision="int8")
        decode_points = {}
        for name, want in (("lm", plain["outs"]), ("lm8", int8_outs)):
            got = {}
            decode_points[name] = bench_serving.run_decode_point(
                srv.endpoint, name, FULL_WIDTH["vocab_size"],
                target_qps=16.0, duration=0.0, deadline_ms=120000.0,
                requests=lambda i: (prompts[i], budgets[i]),
                n_requests=N_REQUESTS, streams=got)
            for i in range(N_REQUESTS):
                check(got.get(i) == want[i],
                      "serving %s: stream %d differs from the earlier "
                      "phase's direct stream" % (name, i))
        counts = dict(pk.launch_counts)
        served = {k: counts[k] for k in ("fused_bottleneck",
                                         "dequant_matmul",
                                         "decode_attention",
                                         "decode_attention_int8")}
        check(all(n > 0 for n in served.values()),
              "a hand kernel did not launch through the server: %s"
              % served)
        for name, rec in decode_points.items():
            check(rec["ok"] == N_REQUESTS and rec["errors"] == 0,
                  "serving %s: %s" % (name, rec))

        # one more point under torch.profiler: the device's busy share
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            prof_point, prof_stages = image_point(*SERVE_PROFILE_POINT,
                                                  seed=11)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        device_ms, rows = profile_rows(torch, prof, 1)
        busy = device_ms / wall_ms if rows else None
        client.stdin.close()
        check(client.wait(timeout=60) == 0, "serving: the load generator "
              "process exited %s" % client.returncode)

        # every image point: no error and no expired deadline; no shed
        # either at the lowest rate (the first fp32 point, the int8 point)
        for rec, lowest in [(r, i == 0) for i, r in enumerate(points)] + [
                (int8_point, True), (prof_point, False)]:
            check(rec["sent"] > 0 and rec["errors"] == 0
                  and rec["deadline_rate"] == 0.0
                  and (not lowest or (rec["shed_rate"] == 0.0
                                      and rec["ok"] == rec["sent"])),
                  "serving: failures at a point: %s" % rec)

        # image replies bit-equal to a direct Predictor.run at the same
        # bucket: one request at a time, so each dispatch is that request
        # alone, padded to its bucket as the direct run pads it
        directs = {}
        FLAGS.fuse_bottleneck_max_width = FUSE_GATE
        try:
            for lane, path in (("fp32", art), ("int8", art8)):
                cfg = inference.AnalysisConfig(model_dir=path)
                cfg.batch_size_buckets = SERVE_BUCKETS
                directs[lane] = inference.create_paddle_predictor(cfg)
        finally:
            FLAGS.fuse_bottleneck_max_width = 0
        for lane, pred in directs.items():
            for b in (1, 5, 8, 20):
                images = _images(b, 300 + b, hw=SERVE_HW)
                got = cli.infer("resnet50", {"data": images},
                                precision=lane)[0]
                check(np.array_equal(got, pred.run([images])[0]),
                      "serving resnet50 %s b=%d: the reply is not "
                      "bit-equal to a direct Predictor.run" % (lane, b))
        del directs
        stats = cli.stats()["stats"]["models"]
        health = cli.health()
    finally:
        if client is not None and client.poll() is None:
            client.kill()
            client.wait()
        cli.close()
        srv.shutdown()
        torch.cuda.empty_cache()
    for lane, (qps, _), rec, st in (
            [("fp32", p, r, st) for p, r, st in zip(SERVE_POINTS, points,
                                                    stages)]
            + [("int8", SERVE_INT8_POINT, int8_point, int8_stages),
               ("fp32, profiled", SERVE_PROFILE_POINT, prof_point,
                prof_stages)]):
        log("serving resnet50 %s @ %.0f QPS: served %.2f QPS (offered "
            "%.2f), p50 %s p95 %s p99 %s ms, sheds %.4f, errors %d; server "
            "stages, mean ms: %s"
            % (lane, qps, rec["served_qps"], rec["achieved_qps"],
               rec["p50_ms"], rec["p95_ms"], rec["p99_ms"],
               rec["shed_rate"], rec["errors"], st))
    for name, rec in decode_points.items():
        log("serving %s: %d streams, %.1f tokens/s, TTFT p50 %s p95 %s p99 "
            "%s ms; streams identical to the direct ones"
            % (name, rec["ok"], rec["tokens_per_sec"], rec["ttft_p50_ms"],
               rec["ttft_p95_ms"], rec["ttft_p99_ms"]))
    if busy is None:
        log("serving: torch.profiler saw no device time; busy share not "
            "measured")
    else:
        log("serving: a %.0f-QPS point under torch.profiler: device busy "
            "%.1f ms of %.1f ms wall = %.1f%% (%d ok)"
            % (SERVE_PROFILE_POINT[0], device_ms, wall_ms, 100 * busy,
               prof_point["ok"]))
    log("serving: launches through the server: %s; phase %.1f s"
        % (served, time.time() - t_phase))
    log(json.dumps({"serving": {
        "points": points, "stages_ms": stages, "int8_point": int8_point,
        "int8_stages_ms": int8_stages,
        "decode": decode_points, "profiled_point": prof_point,
        "profiled_stages_ms": prof_stages,
        "device_busy_share": busy, "launches": served,
        "batch_fill": stats.get("resnet50", {}).get("batch_fill"),
        "slo_monitor": bool(health.get("slo_monitor")),
        "phase_s": time.time() - t_phase}}))
    return served


def _stage_means(after, before):
    """Mean ms of each serving span between two span_totals() readings
    (queue_wait, coalesce, lane_wait, dispatch, compute, scatter and the
    whole request, server side; rpc is the handler's span)."""
    out = {}
    for (kind, name), v in sorted(after.items()):
        b = before.get((kind, name), {"count": 0, "total_ms": 0.0})
        n = v["count"] - b["count"]
        if n > 0 and name.split("/")[-1] in (
                "queue_wait", "coalesce", "lane_wait", "dispatch",
                "compute", "scatter", "request", "rpc"):
            out[name.split("/")[-1]] = round(
                (v["total_ms"] - b["total_ms"]) / n, 3)
    return out


def _lane_launches(lane):
    return int(sum(lane[b][0]["kernel_launches_per_run"] * lane[b][0]["runs"]
                   for b in RESNET_BATCHES))


def bf16_inference_program(torch, fluid, art, exe, scope, gate):
    """The JAX package's bf16 serving route (tools/bench_infer.py) on the
    port: load the artifact into `scope` on `exe`'s device, run the
    InferenceTranspiler at `gate` (batch norm folds in fp32), then cast
    every fp32 persistable to bf16 and retype the feed var to bfloat16.
    Returns (program, feed name, fetch name)."""
    from paddle_tpu_torch.flags import FLAGS
    FLAGS.fuse_bottleneck_max_width = gate
    try:
        with fluid.scope_guard(scope):
            program, feeds, fetches = fluid.load_inference_model(art, exe)
            fluid.InferenceTranspiler().transpile(program, scope=scope)
    finally:
        FLAGS.fuse_bottleneck_max_width = 0
    for v in program.global_block().vars.values():
        val = scope.get(v.name)
        if v.persistable and val is not None and val.dtype == torch.float32:
            scope.set(v.name, val.to(torch.bfloat16))
    program.global_block().var(feeds[0]).dtype = "bfloat16"
    return program, feeds[0], fetches[0].name


def _bf16_runner(torch, exe, scope, program, feed, fetch):
    """run(images) for a bf16 program: one Executor.run, then the bf16
    fetch (checked bf16) as host fp32 numbers — a synchronising copy, as
    Predictor.run's."""
    def run(images):
        out, = exe.run(program, feed={feed: images}, fetch_list=[fetch],
                       scope=scope, return_numpy=False)
        check(out.dtype == torch.bfloat16, "bf16 lane fetched %s"
              % out.dtype)
        return out.float().cpu().numpy()
    return run


# bf16 probabilities against another bf16 or fp32 lane of the same model:
# the lanes round at other points (fused K6-bf16 rounds a1 once after bias
# + relu, the unfused program rounds the conv output and again after the
# bias add; cuDNN and oneDNN sum in other orders), so a logit sits a few
# bf16 ulps (2^-8 relative each) apart and moves its probability by about
# that many ulps times the logit's size: 2^-4 of the largest probability
BF16_PROB_ATOL = 2.0 ** -4


def phase_resnet_bf16(torch, pk, fluid, art, fp32_probs):
    """bf16 ResNet-50 serving through the Executor on the card, as the JAX
    package's bench_infer.py serves it: the artifact transpiled at
    FUSE_GATE (7 K6-bf16 launches per run, no fp32 K6) and at gate 0
    (cuDNN bf16 convolutions, no hand kernel), every persistable and the
    feed in bf16.  The two lanes must agree (BF16_PROB_ATOL); their
    agreement with the fp32 lane is reported."""
    def lane(name, gate):
        exe = fluid.Executor()
        check(exe.device.type == "cuda", "executor not on the card")
        scope = fluid.Scope()
        t0 = time.time()
        program, feed, fetch = bf16_inference_program(torch, fluid, art,
                                                      exe, scope, gate)
        ops = [op.type for op in program.global_block().ops]
        n_fused = ops.count("fused_bottleneck")
        check(n_fused == (7 if gate else 0),
              "bf16 %s: %d fused_bottleneck ops" % (name, n_fused))
        log("resnet bf16 %s (gate %d): program in %.2f s, %d ops"
            % (name, gate, time.time() - t0, len(ops)))
        return _bf16_runner(torch, exe, scope, program, feed, fetch), \
            len(ops)

    stage = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    lanes = {}
    for name, gate, kernel, per_run in (("fused", FUSE_GATE,
                                         "fused_bottleneck_bf16", 7),
                                        ("unfused", 0, None, 0)):
        run, lanes[name + "_ops"] = lane(name, gate)
        lanes[name] = serve_resnet(torch, pk, run, "resnet bf16 " + name,
                                   kernel, per_run, stage=stage,
                                   sum_atol=1e-2)
        del run
        torch.cuda.empty_cache()
    # both bf16 lanes at once (after the lanes, so that each lane's peak
    # memory is its own), alternated run by run
    runs = {name: lane(name, gate)[0]
            for name, gate in (("fused", FUSE_GATE), ("unfused", 0))}
    ab = interleaved_ab(runs, "resnet bf16", stage)
    del runs
    torch.cuda.empty_cache()
    agree = {}
    for b in RESNET_BATCHES:
        f, u = lanes["fused"][b][1], lanes["unfused"][b][1]
        fu = _agreement(u, f)
        atol = BF16_PROB_ATOL * float(np.abs(u).max())
        check(bool((np.abs(f - u) <= atol).all()),
              "resnet bf16 b=%d: fused and unfused bf16 disagree (%s, atol "
              "%.3g)" % (b, fu, atol))
        agree[b] = {"fused_vs_unfused": fu,
                    "fused_vs_fp32": _agreement(fp32_probs[b], f),
                    "unfused_vs_fp32": _agreement(fp32_probs[b], u)}
        log("resnet bf16 b=%d: fused vs unfused bf16 max |d| %.3g (atol "
            "%.3g), top-1 %.3f; vs the fp32 lane: fused max |d| %.3g, top-1"
            " %.3f, unfused max |d| %.3g, top-1 %.3f; max prob %.3g"
            % (b, fu["max_abs"], atol, fu["top1_agreement"],
               agree[b]["fused_vs_fp32"]["max_abs"],
               agree[b]["fused_vs_fp32"]["top1_agreement"],
               agree[b]["unfused_vs_fp32"]["max_abs"],
               agree[b]["unfused_vs_fp32"]["top1_agreement"],
               float(u.max())))
    log(json.dumps({"resnet_bf16": {
        "fused": {b: lanes["fused"][b][0] for b in RESNET_BATCHES},
        "unfused": {b: lanes["unfused"][b][0] for b in RESNET_BATCHES},
        "program_ops": {"fused": lanes["fused_ops"],
                        "unfused": lanes["unfused_ops"]},
        "ab": ab, "agreement": agree}}))
    return _lane_launches(lanes["fused"])


def phase_resnet_gpu_vs_cpu(torch, fluid, resnet, inference, tmp):
    """One small ResNet-50 artifact (32 x 32 input, full widths), the
    fused Predictor on the card and on the CPU: predictions agree."""
    from paddle_tpu_torch.flags import FLAGS
    art = os.path.join(tmp, "resnet50_32")
    build_resnet_artifact(torch, fluid, resnet, art, fluid.CPUPlace(),
                          hw=32)
    images = _images(4, 300, hw=32)
    FLAGS.fuse_bottleneck_max_width = FUSE_GATE
    try:
        outs = {}
        for dev in ("cuda", "cpu"):
            pred = inference.create_paddle_predictor(
                inference.AnalysisConfig(model_dir=art, device=dev))
            check(sum(op.type == "fused_bottleneck"
                      for op in pred.program.global_block().ops) == 7,
                  "gpu/cpu: the small artifact did not fuse 7 blocks")
            outs[dev], = pred.run([images])
    finally:
        FLAGS.fuse_bottleneck_max_width = 0
    ref, got = outs["cpu"], outs["cuda"]
    atol = 1e-4 * float(np.abs(ref).max())
    agree = _agreement(ref, got)
    check(bool((np.abs(ref - got) <= atol + 1e-4 * np.abs(ref)).all()),
          "resnet gpu/cpu predictions disagree (%s, atol %.3g, rtol 1e-4)"
          % (agree, atol))
    log("resnet gpu/cpu (fused, 32x32, batch 4): max |d| %.3g, mean |d| "
        "%.3g, top-1 agreement %.3f (atol %.3g, rtol 1e-4)"
        % (agree["max_abs"], agree["mean_abs"], agree["top1_agreement"],
           atol))


def phase_resnet_bf16_gpu_vs_cpu(torch, fluid, tmp):
    """The 32 x 32 ResNet-50 artifact of phase_resnet_gpu_vs_cpu on the
    bf16 route (fused at FUSE_GATE): K6-bf16 and cuDNN on the card, the
    plain versions and oneDNN on the CPU, agree within BF16_PROB_ATOL."""
    art = os.path.join(tmp, "resnet50_32")
    images = torch.from_numpy(_images(4, 300, hw=32)).to(torch.bfloat16)
    outs = {}
    for dev, place in (("cuda", fluid.CUDAPlace(0)),
                       ("cpu", fluid.CPUPlace())):
        exe = fluid.Executor(place)
        scope = fluid.Scope()
        program, feed, fetch = bf16_inference_program(
            torch, fluid, art, exe, scope, FUSE_GATE)
        check(sum(op.type == "fused_bottleneck"
                  for op in program.global_block().ops) == 7,
              "bf16 gpu/cpu: the small artifact did not fuse 7 blocks")
        outs[dev] = _bf16_runner(torch, exe, scope, program, feed,
                                 fetch)(images)
    ref, got = outs["cpu"], outs["cuda"]
    atol = BF16_PROB_ATOL * float(np.abs(ref).max())
    agree = _agreement(ref, got)
    check(bool((np.abs(ref - got) <= atol).all()),
          "resnet bf16 gpu/cpu predictions disagree (%s, atol %.3g)"
          % (agree, atol))
    log("resnet bf16 gpu/cpu (fused, 32x32, batch 4): max |d| %.3g, mean "
        "|d| %.3g, top-1 agreement %.3f (atol %.3g)"
        % (agree["max_abs"], agree["mean_abs"], agree["top1_agreement"],
           atol))


# 9. ResNet-50 training at the bench's shapes (paddle_tpu_torch/bench.py)
RT_BATCH = 256
RT_WARMUP = 2
RT_STEPS = 10
RT_SEED = 7
# (label, whole-graph AD, AMP); the remat lane is whole-graph AMP again
RT_LANES = (("per-op fp32", False, False), ("per-op amp", False, True),
            ("whole-graph fp32", True, False),
            ("whole-graph amp", True, True))
RT_REMAT = "block_out"
# the first 3 losses of the per-op and whole-graph lanes: fp32 sums the
# fan-in grads in another order (autograd vs the `sum` ops); under AMP
# the whole-graph backward accumulates bf16 cotangents in bf16, where
# the per-op `sum` ops add them in fp32
RT_FP32_RTOL = 1e-4
RT_AMP_RTOL = 2e-2
# gpu/cpu: a small bottleneck ResNet-50 (resnet_imagenet at 32 x 32, 10
# classes); at batch 16 its last stage normalises 16 values per channel
RT_SMALL_BATCH = 16
RT_SMALL_HW = 32


def _is_update_op(op):
    """An op of the update region: the optimizer's, or the regularizer's
    (the JAX package's var names: l2_decay, l1_decay, regularized)."""
    if op.type in ("momentum", "sgd", "adam"):
        return True
    return op.type in ("scale", "sum", "sign") and any(
        n.startswith(("l2_decay", "l1_decay", "regularized"))
        for n in op.output_arg_names)


def _resnet_label(op):
    if op.type == "batch_norm":
        return "batch norm fwd"
    if _is_update_op(op):
        return "optimizer+regularizer"
    return None


class _op_ranges:
    """While active, each forward lowering that `label(op)` names runs
    inside a torch.profiler range "grp:<label>" (by default the batch
    norms' and the update region's), so a profile can split their kernels
    from the rest (the backward runs on autograd's own thread and is
    split by aten op instead)."""

    def __init__(self, registry, label=_resnet_label):
        self.registry = registry
        self.orig = registry.call_lower
        self.label = label

    def __enter__(self):
        from torch.profiler import record_function
        orig, label_of = self.orig, self.label

        def ranged(od, ctx):
            label = label_of(ctx.op)
            if label is None:
                return orig(od, ctx)
            with record_function("grp:" + label):
                return orig(od, ctx)
        self.registry.call_lower = ranged

    def __exit__(self, *exc):
        self.registry.call_lower = self.orig


def _aten_group(name):
    if "convolution_backward" in name:
        return "conv backward"
    if "convolution" in name:
        return "conv forward"
    if name in ("aten::_to_copy", "aten::copy_", "aten::to", "aten::clone",
                "aten::contiguous"):
        return "casts and copies (AMP casts, layout)"
    if "pool" in name:
        return "pooling"
    if name in ("aten::sum", "aten::mean", "aten::var"):
        return "reductions (batch-norm statistics and grads)"
    if name.startswith("aten::"):
        return "elementwise (batch-norm, relu, adds, grads)"
    return "other"


def _train_profile_groups(torch, prof, aten_group=_aten_group):
    """{group: device us} of a profile: each kernel goes to the innermost
    'grp:' range above the CPU op that launched it, else to that op's
    aten group.  Empty when the profile links no kernel to a CPU op."""
    groups = {}
    for e in prof.events():
        kernels = getattr(e, "kernels", None) or []
        if not kernels or e.device_type != torch.autograd.DeviceType.CPU:
            continue
        group, p = None, e
        while p is not None:
            if p.name.startswith("grp:"):
                group = p.name[4:]
                break
            p = p.cpu_parent
        group = group or aten_group(e.name)
        groups[group] = groups.get(group, 0.0) + sum(
            k.duration for k in kernels)
    return groups


def _train_ops_per_step(functionalizer, main, whole_graph):
    if not whole_graph:
        return len(main.global_block().ops)
    fwd, update, _ = functionalizer._partition_whole_graph(
        main.global_block())
    return len(fwd) + len(update)


def _rt_lane(torch, pk, fluid, bench, registry, functionalizer, main, loss,
             init, batches, label, whole_graph, amp, remat=None):
    """One training lane from the startup state `init`: RT_WARMUP +
    RT_STEPS steps on the rotating batches, then one profiled step.
    Launch counts are zeroed just before the steps and read just after."""
    from torch.profiler import ProfilerActivity, profile
    fluid.set_amp(amp)
    try:
        step, whole = bench.make_step(main, loss, whole_graph, remat,
                                      "cuda")
        check(whole == whole_graph, "%s: built the %s step" % (
            label, "whole-graph" if whole else "per-op"))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        pk.reset_launch_counts()
        t0 = time.time()
        state, warm, _, _ = bench.run_steps(step, dict(init), batches, 0,
                                            RT_WARMUP)
        warm_s = time.time() - t0
        state, timed, seconds, gaps = bench.run_steps(
            step, state, batches, RT_WARMUP, RT_STEPS)
        counts = dict(pk.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        losses = [float(x) for x in warm + timed]
        n = RT_WARMUP + RT_STEPS
        with _op_ranges(registry), profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fetches, state = step(state, batches[n % len(batches)], n)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
    finally:
        fluid.set_amp(False)
    check(all(np.isfinite(losses)), "%s: non-finite loss %s"
          % (label, losses))
    launched = {k: v for k, v in counts.items() if v}
    check(not launched, "%s: hand kernels launched on the training path "
          "(K5 and K6 must not): %s" % (label, launched))
    floats = {k: v.dtype for k, v in state.items() if v.is_floating_point()}
    check(all(d == torch.float32 for d in floats.values()),
          "%s: state not fp32: %s" % (label, {
              k: str(d) for k, d in floats.items() if d != torch.float32}))
    stats_names = [k for k in state if k.endswith((".mean_0", ".var_0"))]
    check(len(stats_names) == 106 and all(
        not torch.equal(state[k], init[k]) for k in stats_names),
          "%s: the moving statistics did not all move" % label)
    step_ms = float(np.median(gaps)) * 1e3
    images_s = RT_BATCH * RT_STEPS / seconds
    # the 'grp:' ranges show up on the device timeline too: kernels only
    rows = [r for r in profile_rows(torch, prof, 1)[1]
            if not r[2].startswith("grp:")]
    device_ms = sum(r[0] for r in rows) / 1e3
    card, limit = bench.card_info("cuda")
    line = {"metric": "resnet50_train_images_per_sec", "value": images_s,
            "unit": "images/sec", "card": card, "power_limit": limit,
            "device": "cuda", "amp": amp, "layout": "NHWC",
            "batch": RT_BATCH, "whole_graph": whole_graph}
    if remat:
        line["remat_policy"] = remat
    out = {"label": label, "losses": losses, "images_per_s": images_s,
           "median_step_ms": step_ms, "step_ms": [g * 1e3 for g in gaps],
           "warmup_s": warm_s, "peak_mem_bytes": peak,
           "ops_per_step": _train_ops_per_step(functionalizer, main,
                                               whole_graph),
           "profiled_step_ms": prof_ms}
    log("resnet train %s: losses %s" % (label, ["%.4f" % x
                                                for x in losses]))
    if rows:
        groups = _train_profile_groups(torch, prof)
        out.update({"launches_per_step": sum(r[1] for r in rows),
                    "device_busy_ms": device_ms,
                    "busy_share": device_ms / step_ms,
                    "groups_us": groups,
                    "top": [{"kernel": k[:160], "us": us, "launches": c}
                            for us, c, k in rows[:12]]})
        log("resnet train %s: %.1f images/s, median step %.2f ms (%d "
            "timed steps, warm-up %.1f s), %d ops and %.0f launches a step, "
            "device busy %.2f ms = %.1f%% of the step, peak memory %.1f "
            "GiB" % (label, images_s, step_ms, RT_STEPS, warm_s,
                     out["ops_per_step"], out["launches_per_step"],
                     device_ms, 100 * device_ms / step_ms, peak / 2 ** 30))
        for g, us in sorted(groups.items(), key=lambda x: -x[1]):
            log("resnet train %s profile:   %10.1f us  [%s]"
                % (label, us, g))
        for us, c, k in rows[:8]:
            log("resnet train %s profile:   %10.1f us  %4d launches  %s"
                % (label, us, c, k[:100]))
    else:
        log("resnet train %s: %.1f images/s, median step %.2f ms, peak "
            "%.1f GiB; torch.profiler saw no device time: busy share not "
            "measured" % (label, images_s, step_ms, peak / 2 ** 30))
    log(json.dumps(line))
    log(json.dumps({"resnet_train_lane": out}))
    return out, state


def _rt_agreement(torch, fluid, bench, main, loss, init, batches, lanes):
    """The first 3 losses of the per-op and whole-graph paths from one
    startup state.  The timed lanes run cuDNN's default algorithms, whose
    fp32 weight and data grads add with atomics (a run does not repeat
    itself bit for bit), and three steps of ResNet-50 from its initial
    weights amplify that; so the gate reruns both paths for 3 steps with
    deterministic cuDNN algorithms, where only the paths differ."""
    for kind, amp, rtol in (("fp32", False, RT_FP32_RTOL),
                            ("amp", True, RT_AMP_RTOL)):
        timed = [lanes[p + kind]["losses"][:3]
                 for p in ("per-op ", "whole-graph ")]
        runs = []
        torch.backends.cudnn.deterministic = True
        fluid.set_amp(amp)
        try:
            for whole in (False, True):
                step, _ = bench.make_step(main, loss, whole, None, "cuda")
                _, losses, _, _ = bench.run_steps(step, dict(init), batches,
                                                  0, 3)
                runs.append([float(x) for x in losses])
        finally:
            torch.backends.cudnn.deterministic = False
            fluid.set_amp(False)
        err = max(abs(x - y) / abs(x) for x, y in zip(*runs))
        timed_err = max(abs(x - y) / abs(x) for x, y in zip(*timed))
        check(err <= rtol, "resnet train %s: per-op %s and whole-graph %s "
              "disagree (deterministic cuDNN; max rel err %.3g > %g)"
              % (kind, runs[0], runs[1], err, rtol))
        log("resnet train %s: first 3 losses, deterministic cuDNN, per-op "
            "%s, whole-graph %s: max rel err %.3g (tolerance %g); the timed "
            "lanes (default cuDNN) %s and %s: %.3g" % (
                kind, runs[0], runs[1], err, rtol, timed[0], timed[1],
                timed_err))
        torch.cuda.empty_cache()


def phase_resnet_train(torch, pk, fluid):
    """ResNet-50 training at the bench's shapes through the user's entry
    points: models.resnet.get_model(is_train=True, layout="NHWC") at 224
    x 224, batch 256, 1000 classes, Momentum 0.9 with L2Decay(1e-4), lr
    0.1; startup seed 7 on the card; bench.py's 4 rotating seeded
    batches.  Four lanes (per-op / whole-graph, fp32 / AMP) from the one
    startup state, then whole-graph AMP under block_out remat, then 10
    per-op fp32 steps on one fixed batch."""
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.fluid import functionalizer
    from paddle_tpu_torch.ops import registry
    t0 = time.time()
    main, loss, exe, scope = bench.build(RT_BATCH, "NHWC", "cuda",
                                         seed=RT_SEED)
    init = {n: scope.get(n) for n in scope.keys()}
    check(all(v.device.type == "cuda" for v in init.values()),
          "resnet train: startup state not on the card")
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    log("resnet train: built ResNet-50 (%d program ops, %d parameters, %d "
        "persistables) and ran startup in %.1f s"
        % (len(main.global_block().ops), n_params, len(init),
           time.time() - t0))
    t0 = time.time()
    batches = bench.staged_batches(RT_BATCH, "NHWC", exe.device)
    log("resnet train: staged %d seeded batches of %d images in %.1f s"
        % (len(batches), RT_BATCH, time.time() - t0))
    lanes = {}
    for label, whole_graph, amp in RT_LANES:
        lanes[label], _ = _rt_lane(torch, pk, fluid, bench, registry,
                                   functionalizer, main, loss, init,
                                   batches, label, whole_graph, amp)
        torch.cuda.empty_cache()
    _rt_agreement(torch, fluid, bench, main, loss, init, batches, lanes)
    remat, _ = _rt_lane(torch, pk, fluid, bench, registry, functionalizer,
                        main, loss, init, batches,
                        "whole-graph amp remat " + RT_REMAT, True, True,
                        remat=RT_REMAT)
    base = lanes["whole-graph amp"]
    err = abs(remat["losses"][0] - base["losses"][0]) / abs(
        base["losses"][0])
    # the same forward: equal unless cuDNN picks another algorithm, which
    # may move a bf16 product by an ulp
    check(err <= 2.0 ** -7, "resnet train remat: first loss %.6f against "
          "%.6f without remat" % (remat["losses"][0], base["losses"][0]))
    check(remat["peak_mem_bytes"] < base["peak_mem_bytes"],
          "resnet train remat: peak memory %d not below %d without remat"
          % (remat["peak_mem_bytes"], base["peak_mem_bytes"]))
    log("resnet train remat %s: first loss %.6f (without: %.6f, rel err "
        "%.3g), peak memory %.2f GiB against %.2f GiB, %.1f images/s "
        "against %.1f" % (RT_REMAT, remat["losses"][0], base["losses"][0],
                          err, remat["peak_mem_bytes"] / 2 ** 30,
                          base["peak_mem_bytes"] / 2 ** 30,
                          remat["images_per_s"], base["images_per_s"]))
    torch.cuda.empty_cache()
    # the loss falls on one fixed batch, per-op fp32
    step, _ = bench.make_step(main, loss, False, None, "cuda")
    _, losses, _, _ = bench.run_steps(step, dict(init), batches[:1], 0, 10)
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)) and min(losses[5:]) < losses[0],
          "resnet train: 10 per-op fp32 steps on one batch did not lower "
          "the loss below step 1's: %s" % losses)
    log("resnet train: one fixed batch, per-op fp32: losses %s"
        % ["%.4f" % x for x in losses])
    del init, batches
    torch.cuda.empty_cache()


def _forced_device_step(torch, fluid, functionalizer, registry, main, env0,
                        values, device, step):
    """Every op of `main` on `device`, each on the CPU run's values of its
    inputs (`values`: everything the CPU step wrote); the worst Frobenius
    error, relative to the CPU's value, over every value an op writes
    last: (error, name, op type)."""
    ops = main.global_block().ops
    last = {}
    for i, op in enumerate(ops):
        for n in op.output_arg_names:
            if n:
                last[n] = i
    env = {n: v.to(device) for n, v in env0.items()}
    needed = {op.attrs["fwd_uid"] for op in ops
              if functionalizer._is_generic_grad(op)}
    cache = {}
    worst = (0.0, "", "")
    with torch.no_grad():
        for i, op in enumerate(ops):
            if functionalizer._is_generic_grad(op):
                functionalizer._run_grad_op(op, env, cache)
            else:
                od = registry.get_op_def(op.type)
                ctx = registry.ExecContext(
                    op, functionalizer._gather_inputs(op, env), step=step,
                    seed=main.random_seed, device=device)
                if op.uid in needed:
                    outs, vjp = registry.make_forward_and_vjp(op, od, ctx)
                    cache[op.uid] = (vjp, outs)
                else:
                    outs = registry.call_lower(od, ctx)
                functionalizer._write_outputs(op, outs, env)
                functionalizer._propagate_lod(op, env)
            for n in op.output_arg_names:
                if not n or last[n] != i:
                    continue
                if n not in values:
                    # a declared output no lowering writes (the lstm's
                    # BatchGate): the card must not write it either
                    check(n not in env, "train gpu/cpu: %s (%s) written "
                          "on the card only" % (n, op.type))
                    continue
                want = values[n]
                got = env[n].cpu()
                if want.is_floating_point():
                    want64, got64 = want.double(), got.double()
                    err = float(torch.linalg.vector_norm(got64 - want64) /
                                max(float(torch.linalg.vector_norm(want64)),
                                    1e-30))
                    worst = max(worst, (err, n, op.type))
                else:
                    check(torch.equal(got, want), "train gpu/cpu: "
                          "%s (%s) differs" % (n, op.type))
                env[n] = want.to(device)
    return worst


def phase_resnet_train_gpu_vs_cpu(torch, fluid):
    """A small bottleneck ResNet-50 (resnet_imagenet at 32 x 32, 10
    classes, NHWC, batch RT_SMALL_BATCH) from one startup scope: two
    Momentum + L2Decay steps on the card and on the CPU.  The first
    losses agree within 1e-4 relative; the second is printed (one ulp of
    input moves it ~10% at these sizes: ResNet-50 from its initial
    weights on a few images is chaotic); and both steps are held op by op:
    every op on the card, on the CPU step's values of its inputs, within
    a Frobenius error of 1e-4 of the CPU's outputs."""
    from paddle_tpu_torch.fluid import functionalizer
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.ops import registry
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        image = fluid.layers.data(name="data", shape=[RT_SMALL_HW,
                                                      RT_SMALL_HW, 3],
                                  dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        predict = resnet.resnet_imagenet(image, class_dim=10, depth=50,
                                         layout="NHWC")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(predict, label))
        fluid.optimizer.Momentum(
            learning_rate=0.1, momentum=0.9,
            regularization=fluid.regularizer.L2Decay(1e-4)).minimize(loss)
    startup.random_seed = RT_SEED
    cpu = fluid.CPUPlace()
    cpu_scope = fluid.Scope()
    with fluid.scope_guard(cpu_scope):
        fluid.Executor(cpu).run(startup)
    init = {n: cpu_scope.get(n).clone() for n in cpu_scope.keys()}
    rng = np.random.RandomState(5)
    feeds = [{"data": rng.randn(RT_SMALL_BATCH, RT_SMALL_HW, RT_SMALL_HW,
                                3).astype(np.float32),
              "label": rng.randint(0, 10, (RT_SMALL_BATCH, 1))}
             for _ in range(2)]
    # free running on each device
    losses = {}
    for name, place in (("gpu", fluid.CUDAPlace(0)), ("cpu", cpu)):
        scope = fluid.scope_from_jax(
            {n: v.numpy() for n, v in init.items()}, fluid.Scope(), place)
        exe = fluid.Executor(place)
        with fluid.scope_guard(scope):
            losses[name] = [float(exe.run(main, feed=f,
                                          fetch_list=[loss])[0])
                            for f in feeds]
    err = abs(losses["gpu"][0] - losses["cpu"][0]) / abs(losses["cpu"][0])
    check(err <= 1e-4, "resnet train gpu/cpu: first losses gpu %.6f cpu "
          "%.6f (rel err %.3g > 1e-4)" % (losses["gpu"][0],
                                          losses["cpu"][0], err))
    # op by op: the CPU step keeps every value it writes
    state = dict(init)
    exe = fluid.Executor(cpu)
    worst = (0.0, "", "")
    for step, feed in enumerate(feeds):
        env0 = dict(state)
        env0.update(exe._prepare_feeds(main, feed))
        values = functionalizer.run_block(main.global_block(), dict(env0),
                                          step=step, seed=main.random_seed,
                                          device=torch.device("cpu"))
        worst = max(worst, _forced_device_step(
            torch, fluid, functionalizer, registry, main, env0, values,
            fluid.CUDAPlace(0).torch_device(), step))
        state = {n: values[n] for n in state}
    check(worst[0] <= 1e-4, "resnet train gpu/cpu: %s (%s) on the card "
          "lies %.3g (Frobenius, relative) from the CPU's" % (
              worst[1], worst[2], worst[0]))
    log("resnet train gpu/cpu (resnet_imagenet 32x32, batch %d, 10 "
        "classes, fp32): losses gpu %s cpu %s (first: rel err %.3g, "
        "tolerance 1e-4); op by op over 2 steps, worst %s (%s) at %.3g "
        "(tolerance 1e-4)" % (RT_SMALL_BATCH, losses["gpu"], losses["cpu"],
                               err, worst[1], worst[2], worst[0]))


ZOO_ITERS = 20
ZOO_SKIP = 2
# (model, the fluid_benchmark flags of its published cell, whole-graph AMP
# lane too); the LSTM runs twice, at the JAX tool's lengths 3-11 (T 16)
# and at 64-256 (T 256), the IMDB reviews' range
ZOO_MODELS = (
    ("vgg", ["--model", "vgg", "--batch_size", "128"], False),
    ("se_resnext", ["--model", "se_resnext", "--batch_size", "64",
                    "--layout", "NHWC"], True),
    ("lstm T16", ["--model", "stacked_dynamic_lstm", "--batch_size", "64"],
     False),
    ("lstm T256", ["--model", "stacked_dynamic_lstm", "--batch_size", "64",
                   "--seq_len", "256"], False),
)
ZOO_REMAT = "block_out"
ZOO_COUNTER = "@LR_DECAY_COUNTER@"


def _zoo_label(op):
    """The profile group of a forward lowering, or None (its aten ops'
    group): batch norm, the LSTM's step loop, the update region (the
    optimizer, its regularizer and beta-pow scales, the LR schedule)."""
    if op.type == "batch_norm":
        return "batch norm fwd"
    if op.type == "lstm":
        return "lstm step loop fwd"
    if op.type in ("adam", "increment", "less_than", "where") or \
            _is_update_op(op) or any(
                n.endswith("_pow_acc_0") for n in op.output_arg_names):
        return "update (optimizer, regularizer, LR schedule)"
    return None


def _zoo_aten_group(name):
    if name in ("aten::mm", "aten::addmm", "aten::bmm", "aten::matmul",
                "aten::linear"):
        return "matmul (fc, LSTM gates)"
    return _aten_group(name)


def _zoo_args(fb, argv, amp, whole_graph, iters=ZOO_ITERS, skip=ZOO_SKIP,
              remat=None):
    extra = ["--iterations", str(iters), "--skip_batch_num", str(skip)]
    if not amp:
        extra.append("--no_amp")
    if whole_graph:
        extra.append("--whole_graph_ad")
    if remat:
        extra += ["--remat_policy", remat]
    return fb.parse_args(argv + extra)


def _zoo_lane(torch, pk, registry, functionalizer, fb, model, argv, amp,
              whole_graph, iters=ZOO_ITERS, skip=ZOO_SKIP,
              label_fn=_zoo_label):
    """One lane of phase_zoo_train through fluid_benchmark.benchmark:
    `skip` + `iters` steps on fresh synthetic batches, then (with the
    lane's flags still set) one profiled step and the lane's checks.
    Launch counts are zeroed just before and read just after."""
    from torch.profiler import ProfilerActivity, profile
    label = "%s %s %s" % (model, "whole-graph" if whole_graph else "per-op",
                          "amp" if amp else "fp32")
    args = _zoo_args(fb, argv, amp, whole_graph, iters=iters, skip=skip)
    seen = {}

    def after(d):
        feed = d["make_batch"]()
        with _op_ranges(registry, label_fn), profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            outs = d["exe"].run(d["main"], feed=feed, fetch_list=d["fetch"],
                                scope=d["scope"])
            torch.cuda.synchronize()
            seen["prof_ms"] = (time.perf_counter() - t0) * 1e3
        seen["prof"] = prof
        seen["losses"] = list(d["losses"]) + [float(np.asarray(
            outs[0]).ravel()[0])]
        seen["ops"] = _train_ops_per_step(functionalizer, d["main"],
                                          whole_graph)
        if model.startswith("lstm"):
            feed = d["make_batch"]()
            loss, hidden = d["exe"].run(
                d["main"], feed=feed, fetch_list=[d["fetch"][0],
                                                  "lstm_0.tmp_0"],
                scope=d["scope"])
            seen["hidden"] = (type(hidden).__name__,
                              hidden.recursive_sequence_lengths()
                              if hasattr(hidden, "lod") else None,
                              feed["words"].recursive_sequence_lengths(),
                              np.asarray(hidden).shape)
            seen["losses"].append(float(np.asarray(loss).ravel()[0]))
        seen["steps_run"] = d["exe"]._step_counters[id(d["main"])]
        counter = d["scope"].get(ZOO_COUNTER)
        seen["counter"] = None if counter is None else float(counter[0])

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pk.reset_launch_counts()
    t0 = time.time()
    record, detail = fb.benchmark(args, after=after)
    counts = dict(pk.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    wall = time.time() - t0
    losses = seen["losses"]
    check(all(np.isfinite(losses)), "zoo %s: non-finite loss %s"
          % (label, losses))
    launched = {k: v for k, v in counts.items() if v}
    check(not launched, "zoo %s: hand kernels launched on a training lane "
          "(none is on this path): %s" % (label, launched))
    if seen["counter"] is not None:
        # the counter starts at -1 and reads the completed steps - 1
        check(seen["counter"] == seen["steps_run"] - 1,
              "zoo %s: the LR counter reads %s after %d steps (want %d)"
              % (label, seen["counter"], seen["steps_run"],
                 seen["steps_run"] - 1))
    if "hidden" in seen:
        kind, got, want, shape = seen["hidden"]
        check(kind == "LoDTensor" and got == want,
              "zoo %s: the fetched LSTM hidden is %s with lengths %s, not a "
              "LoDTensor with the feed's %s" % (label, kind, got, want))
    step_ms = float(np.median(detail["step_s"])) * 1e3
    prof = seen["prof"]
    rows = [r for r in profile_rows(torch, prof, 1)[1]
            if not r[2].startswith("grp:")]
    device_ms = sum(r[0] for r in rows) / 1e3
    out = {"label": label, "record": record, "losses": losses,
           "examples_per_s": record["examples_per_sec"],
           "median_step_ms": step_ms,
           "step_ms": [s * 1e3 for s in detail["step_s"]],
           "peak_mem_bytes": peak, "ops_per_step": seen["ops"],
           "profiled_step_ms": seen["prof_ms"], "wall_s": wall,
           "counter": seen["counter"], "steps_run": seen["steps_run"]}
    if "hidden" in seen:
        out["hidden"] = {"lengths": seen["hidden"][1][0][:8],
                         "rows": seen["hidden"][3][0]}
    log("zoo %s: losses %s" % (label, ["%.4f" % x for x in losses]))
    if rows:
        groups = _train_profile_groups(torch, prof, _zoo_aten_group)
        out.update({"launches_per_step": sum(r[1] for r in rows),
                    "device_busy_ms": device_ms,
                    "busy_share": device_ms / step_ms,
                    "groups_us": groups,
                    "top": [{"kernel": k[:160], "us": us, "launches": c}
                            for us, c, k in rows[:10]]})
        log("zoo %s: %.1f examples/s, median step %.2f ms (%d timed steps), "
            "%d ops and %.0f launches a step, device busy %.2f ms = %.1f%% "
            "of the step, peak memory %.2f GiB, %.1f s in all"
            % (label, record["examples_per_sec"], step_ms, iters,
               seen["ops"], out["launches_per_step"], device_ms,
               100 * device_ms / step_ms, peak / 2 ** 30, wall))
        for g, us in sorted(groups.items(), key=lambda x: -x[1])[:6]:
            log("zoo %s profile:   %10.1f us  [%s]" % (label, us, g))
        for us, c, k in rows[:5]:
            log("zoo %s profile:   %10.1f us  %5d launches  %s"
                % (label, us, c, k[:90]))
    else:
        log("zoo %s: %.1f examples/s, median step %.2f ms, peak %.2f GiB; "
            "torch.profiler saw no device time: busy share not measured"
            % (label, record["examples_per_sec"], step_ms, peak / 2 ** 30))
    log(json.dumps(record))
    log(json.dumps({"zoo_lane": out}))
    return out


def zoo_program_stats(fluid, fb, argv, T=None):
    """(ops per op, ops whole-graph, forward multiply-adds, training FLOP,
    fp32 forward activation bytes) of a cell's program at its batch; a
    ragged var counts B x T rows (T: the padded length)."""
    from paddle_tpu_torch.fluid import functionalizer
    args = fb.parse_args(argv)
    B = args.batch_size
    with fluid.unique_name.guard():
        main = fb.build_model(args)[0]
    gb = main.global_block()
    fwd, update, _ = functionalizer._partition_whole_graph(gb)

    def shape(n):
        v = gb._find_var_recursive(n)
        lead = [B, T] if v.lod_level and T else [B]
        return lead + [d for d in v.shape[1:]]
    macs = act = 0
    for op in fwd:
        if op.type == "conv2d":
            w = gb._find_var_recursive(op.input("Filter")[0]).shape
            macs += np.prod(shape(op.output("Output")[0])) * np.prod(w[1:])
        elif op.type == "mul":
            x = gb._find_var_recursive(op.input("X")[0])
            y = gb._find_var_recursive(op.input("Y")[0]).shape
            rows = B * (T if x.lod_level and T else 1)
            macs += rows * y[0] * y[1]
        elif op.type == "lstm":
            w = gb._find_var_recursive(op.input("Weight")[0]).shape
            macs += B * T * w[0] * w[1]
        for n in op.output_arg_names:
            v = gb._find_var_recursive(n)
            if v is not None and not v.persistable and v.shape and \
                    v.dtype == fluid.core.VarDesc.VarType.FP32:
                act += int(np.prod(shape(n))) * 4
    return (len(gb.ops), len(fwd) + len(update), float(macs),
            6.0 * float(macs), float(act))


def _zoo_one_batch(torch, fluid, fb, model, argv):
    """10 per-op fp32 steps of the cell's program on one of the tool's
    synthetic batches from its startup state: the loss must fall below
    the first step's.  The tool's labels lie in {0, 1}; at SE-ResNeXt's
    lr 0.1 its softmax saturates on that two-class prior within 3 steps
    and cross_entropy's 1e-8 floor stops the gradient (in the JAX package
    too), so its batch draws labels over all 1000 classes."""
    args = _zoo_args(fb, argv, False, False)
    with fluid.unique_name.guard():
        main, startup, feeds, loss, _, predict = fb.build_model(args)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(1)
    feed = fb.synth_feed(feeds, args.batch_size, rng, program=main,
                         lengths=fb.lod_lengths(args))
    if args.model == "se_resnext":
        feed["label"] = rng.randint(0, predict.shape[-1],
                                    (args.batch_size, 1)).astype(np.int64)
    losses = [float(np.asarray(exe.run(main, feed=feed, fetch_list=[loss],
                                       scope=scope)[0]).ravel()[0])
              for _ in range(10)]
    check(all(np.isfinite(losses)) and min(losses[5:]) < losses[0],
          "zoo %s: 10 per-op fp32 steps on one batch did not lower the "
          "loss below the first step's: %s" % (model, losses))
    log("zoo %s: one batch, per-op fp32: losses %s"
        % (model, ["%.4f" % x for x in losses]))
    del exe, scope
    torch.cuda.empty_cache()


def _zoo_paths_agree(torch, fb, model, argv):
    """3 steps per op and whole graph from one startup state (the same
    seed on the card) on the same 3 batches, deterministic cuDNN: fp32
    bit for bit; SE-ResNeXt also under AMP (within 2e-2, as the ResNet
    training gate) and under block_out remat (the counter reads 2, the first
    loss equals the unremat whole-graph one within one bf16 ulp)."""
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        kinds = [("fp32", False, None)]
        if model == "se_resnext":
            kinds += [("amp", True, None), ("amp", True, ZOO_REMAT)]
        for kind, amp, remat in kinds:
            for whole in ((False, True) if remat is None else (True,)):
                _, d = fb.benchmark(_zoo_args(fb, argv, amp, whole, iters=3,
                                              skip=0, remat=remat))
                counter = d["scope"].get(ZOO_COUNTER)
                runs[(kind, whole, remat)] = (
                    d["losses"], None if counter is None
                    else float(counter[0]))
                del d
                torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    per_op, whole = runs[("fp32", False, None)], runs[("fp32", True, None)]
    check(per_op == whole, "zoo %s fp32: per-op %s and whole-graph %s "
          "(losses, counter) are not bit for bit equal over 3 steps"
          % (model, per_op, whole))
    log("zoo %s fp32: 3 steps per-op %s, whole-graph %s (deterministic "
        "cuDNN): bit for bit %s" % (model, per_op[0], whole[0],
                                    per_op == whole))
    if model != "se_resnext":
        return
    a, b = runs[("amp", False, None)], runs[("amp", True, None)]
    err = max(abs(x - y) / max(abs(x), 1e-30) for x, y in zip(a[0], b[0]))
    check(err <= 2e-2 and a[1] == b[1] == 2.0,
          "zoo se_resnext amp: per-op %s and whole-graph %s disagree (max "
          "rel err %.3g > 2e-2) or the counters %s, %s are not 2"
          % (a[0], b[0], err, a[1], b[1]))
    r = runs[("amp", True, ZOO_REMAT)]
    rerr = abs(r[0][0] - b[0][0]) / max(abs(b[0][0]), 1e-30)
    check(r[1] == 2.0 and rerr <= 2.0 ** -7,
          "zoo se_resnext amp remat %s: counter %s (want 2.0), first loss "
          "%.6f against %.6f without remat" % (ZOO_REMAT, r[1], r[0][0],
                                               b[0][0]))
    log("zoo se_resnext amp: per-op %s, whole-graph %s: max rel err %.3g "
        "(bit for bit %s); %s remat %s, counter %s, first loss rel err %.3g"
        % (a[0], b[0], err, a[0] == b[0], ZOO_REMAT, r[0], r[1], rerr))


def phase_zoo_train(torch, pk, fluid):
    """The benchmark/fluid zoo at its published cells through the port's
    fluid_benchmark (python -m paddle_tpu_torch.fluid_benchmark): VGG-16
    CIFAR-10 (batch 128, 32 x 32, NCHW), SE-ResNeXt-50 32x4d (batch 64,
    224 x 224, NHWC) and stacked_dynamic_lstm (batch 64, dict 5147, emb
    and hid 512, 3 layers) at lengths 3-11 (T 16) and 64-256 (T 256).
    Lanes per op in fp32 and in the tool's AMP default, SE-ResNeXt also
    whole-graph AMP; ZOO_SKIP + ZOO_ITERS steps on fresh synthetic
    batches each, a profiled step, and the gates: finite losses, no hand
    kernel launches, the LR counter, the LSTM's LoDTensor fetch, and per
    model (the T 16 LSTM for both) the loss falling on one batch and
    per-op against whole-graph."""
    from paddle_tpu_torch import fluid_benchmark as fb
    from paddle_tpu_torch.fluid import functionalizer
    from paddle_tpu_torch.ops import registry
    lanes = []
    for model, argv, whole_amp in ZOO_MODELS:
        t0 = time.time()
        T = {"lstm T16": 16, "lstm T256": 256}.get(model)
        ops, wg_ops, macs, flop, act = zoo_program_stats(fluid, fb, argv, T)
        log("zoo %s: %d ops per op, %d whole-graph; %.4g forward "
            "multiply-adds, %.4g FLOP a training step, %.4g bytes of fp32 "
            "forward activations" % (model, ops, wg_ops, macs, flop, act))
        for amp, whole in ((False, False), (True, False)) + (
                ((True, True),) if whole_amp else ()):
            lanes.append(_zoo_lane(torch, pk, registry, functionalizer, fb,
                                   model, argv, amp, whole))
            torch.cuda.empty_cache()
        if model != "lstm T256":
            _zoo_one_batch(torch, fluid, fb, model, argv)
            _zoo_paths_agree(torch, fb, model, argv)
        log("zoo %s: %.1f s" % (model, time.time() - t0))
    return lanes


def _zoo_small_programs(fluid):
    """The three models at a small size, dropout off (the card's and the
    CPU's generators draw other masks): (name, main, startup, loss, feed
    maker, steps)."""
    from paddle_tpu_torch.models import se_resnext, stacked_dynamic_lstm, vgg

    def no_dropout(main):
        for op in main.global_block().ops:
            if op.type == "dropout":
                op.attrs["dropout_prob"] = 0.0
            if op.type == "dropout_grad":
                op.attrs["fwd_attrs"]["dropout_prob"] = 0.0
        main._bump_version()

    def image_feed(shape):
        def make(step):
            rng = np.random.RandomState(step)
            return {"data": rng.randn(*shape).astype(np.float32),
                    "label": rng.randint(0, 10, (shape[0], 1))}
        return make

    def lstm_feed(step):
        rng = np.random.RandomState(step)
        lens = [3, 7, 1, 5]
        words = fluid.create_lod_tensor(
            rng.randint(0, 50, (sum(lens), 1)).astype(np.int64), [lens],
            None)
        return {"words": words, "label": rng.randint(0, 2, (4, 1))}

    out = []
    with fluid.unique_name.guard():
        m, s, _, loss, _, _ = vgg.get_model(batch_size=4)
    no_dropout(m)
    out.append(("vgg (batch 4, 32x32)", m, s, loss,
                image_feed((4, 3, 32, 32)), 1))
    with fluid.unique_name.guard():
        m, s, _, loss, _, _ = se_resnext.get_model(
            batch_size=8, class_dim=10, img_size=32, layout="NHWC")
    no_dropout(m)
    out.append(("se_resnext (batch 8, 32x32, 10 classes)", m, s, loss,
                image_feed((8, 32, 32, 3)), 1))
    with fluid.unique_name.guard():
        m, s, _, loss, _, _ = stacked_dynamic_lstm.get_model(
            dict_dim=50, emb_dim=16, hid_dim=16, stacked_num=2)
    out.append(("stacked_dynamic_lstm (2 layers, 16 wide, batch 4)", m, s,
                loss, lstm_feed, 3))
    return out


def _worst_spread(a, b):
    """The largest max|a - b| over arrays, relative to b's largest
    magnitude: (spread, name)."""
    worst = (0.0, "")
    for n in b:
        scale = max(float(np.abs(b[n]).max()), 1e-30)
        worst = max(worst, (float(np.abs(a[n] - b[n]).max()) / scale, n))
    return worst


def phase_zoo_gpu_vs_cpu(torch, fluid):
    """Each zoo model at a small size from one startup state (run on the
    CPU, carried to the card), deterministic cuDNN: the first loss on the
    card and on the CPU within 1e-4 relative.  The small LSTM trains 3
    Adam steps free running, its losses within 1e-5; and each of those
    steps is held op by op, every op on the card on the CPU step's values
    of its inputs, every value it writes (the updated parameters and
    moments included) within a Frobenius error of 1e-5 of the CPU's.
    The free-running parameters are printed beside the CPU's own spread
    when one embedding ulp moves: Adam turns a bias grad summed with
    cancellation into a parameter step, so a free-running parameter of
    this model is no better conditioned than that spread."""
    from paddle_tpu_torch.fluid import functionalizer
    from paddle_tpu_torch.ops import registry
    cpu, gpu = fluid.CPUPlace(), fluid.CUDAPlace(0)
    torch.backends.cudnn.deterministic = True
    try:
        for name, main, startup, loss, make, steps in \
                _zoo_small_programs(fluid):
            scope0 = fluid.Scope()
            fluid.Executor(cpu).run(startup, scope=scope0)
            init = {n: scope0.get(n).numpy() for n in scope0.keys()}
            nudged = dict(init)
            if steps > 1:
                emb = "embedding_0.w_0"
                nudged[emb] = np.nextafter(init[emb], np.float32(np.inf))
            res = {}
            for dev, place, state in (("gpu", gpu, init), ("cpu", cpu, init),
                                      ("cpu nudged", cpu, nudged)):
                if dev == "cpu nudged" and steps == 1:
                    continue
                scope = fluid.scope_from_jax(state, fluid.Scope(), place)
                exe = fluid.Executor(place)
                losses = [float(np.asarray(exe.run(
                    main, feed=make(s), fetch_list=[loss],
                    scope=scope)[0]).ravel()[0]) for s in range(steps)]
                res[dev] = (losses, {n: scope.get(n).cpu().numpy()
                                     for n in init})
            (lg, sg), (lc, sc) = res["gpu"], res["cpu"]
            err = abs(lg[0] - lc[0]) / abs(lc[0])
            check(err <= 1e-4, "zoo gpu/cpu %s: first losses gpu %.6f cpu "
                  "%.6f (rel err %.3g > 1e-4)" % (name, lg[0], lc[0], err))
            if steps == 1:
                log("zoo gpu/cpu %s (fp32): first losses gpu %s cpu %s, rel "
                    "err %.3g (tolerance 1e-4)" % (name, lg, lc, err))
                continue
            check(all(abs(x - y) <= 1e-5 * abs(y) for x, y in zip(lg, lc)),
                  "zoo gpu/cpu %s: losses gpu %s cpu %s (tolerance 1e-5)"
                  % (name, lg, lc))
            # op by op: the CPU step keeps every value it writes
            state = {n: torch.from_numpy(v) for n, v in init.items()}
            exe = fluid.Executor(cpu)
            worst_op = (0.0, "", "")
            for step in range(steps):
                env0 = dict(state)
                env0.update(exe._prepare_feeds(main, make(step)))
                values = functionalizer.run_block(
                    main.global_block(), dict(env0), step=step,
                    seed=main.random_seed, device=torch.device("cpu"))
                worst_op = max(worst_op, _forced_device_step(
                    torch, fluid, functionalizer, registry, main, env0,
                    values, gpu.torch_device(), step))
                state = {n: values[n] for n in state}
            check(worst_op[0] <= 1e-5, "zoo gpu/cpu %s: %s (%s) on the card "
                  "lies %.3g (Frobenius, relative) from the CPU's" % (
                      name, worst_op[1], worst_op[2], worst_op[0]))
            free = _worst_spread(sg, sc)
            nudge = _worst_spread(res["cpu nudged"][1], sc)
            log("zoo gpu/cpu %s (fp32): losses gpu %s cpu %s (tolerance "
                "1e-5); op by op over %d steps, worst %s (%s) at %.3g "
                "(tolerance 1e-5); free running, the worst persistable %s "
                "at %.3g of its largest magnitude, against %s at %.3g on "
                "the CPU when one embedding ulp moves" % (
                    name, lg, lc, steps, worst_op[1], worst_op[2],
                    worst_op[0], free[1], free[0], nudge[1], nudge[0]))
    finally:
        torch.backends.cudnn.deterministic = False


# ---------------------------------------------------------------------------
# 13. data parallelism: one NCCL rank per visible card
# ---------------------------------------------------------------------------

# ResNet-50 at full width (every block, 224 x 224, 1000 classes, NHWC,
# fp32, per op, Momentum + L2Decay): images per card, steps, and a
# learning rate below the bench's 0.1 (tuned for batch 256), which
# saturates the softmax within two steps at a few images
PAR_BATCH = 32
PAR_STEPS = 3
PAR_SEED = 7
PAR_LR = 0.01
# the losses of the ranks' global step against the single-card Executor
# on the same global batch: the first step's at PAR_RTOL0, which a
# per-rank-statistics step misses by far; all at PAR_RTOL, since the
# later steps carry the batch-norm sums' other order through the updates
# of a 50-layer net, which is chaotic at a few images (on the CPU at 4
# images, one ulp of the first batch moved the second loss by 0.14% and
# the third by 0.94%)
PAR_RTOL0 = 1e-5
PAR_RTOL = 2e-2
PAR_BN = 53  # ResNet-50's batch norms
PAR_TIMEOUT_S = 600


def _par_shard(step, rank):
    """Rank `rank`'s images and labels of step `step` (the global batch
    is the ranks' shards in rank order)."""
    rng = np.random.RandomState(1000 * step + rank)
    images = rng.uniform(-1, 1, (PAR_BATCH, 224, 224, 3)).astype(np.float32)
    labels = rng.randint(0, 1000, (PAR_BATCH, 1)).astype(np.int64)
    return images, labels


def _par_model(fluid, world):
    from paddle_tpu_torch.models import resnet
    with fluid.unique_name.guard():
        main, startup, _, loss, _, _ = resnet.get_model(
            batch_size=PAR_BATCH * world, lr=PAR_LR, is_train=True,
            layout="NHWC")
    startup.random_seed = PAR_SEED
    return main, startup, loss


def parallel_rank(outdir):
    """One rank of phase_parallel (`chip_smoke.py --parallel-rank DIR`,
    started by parallel.mesh.launch): the collective transpiler, the
    startup program (joins the NCCL world on the rank's card), a
    ParallelExecutor and PAR_STEPS steps on the rank's shards, the
    gradient all-reduce timed; writes rank<id>.json and rank<id>.npz
    (the moving statistics), and rank 0 init.npz (the broadcast state)."""
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import functionalizer
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    tid = int(os.environ["PADDLE_TRAINER_ID"])
    world = int(os.environ["PADDLE_TRAINERS"])
    main, startup, loss = _par_model(fluid, world)
    cfg = fluid.DistributeTranspilerConfig()
    cfg.mode = "collective"
    fluid.DistributeTranspiler(cfg).transpile(
        tid, program=main, trainers=world, startup_program=startup)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
    pe = fluid.ParallelExecutor(True, loss.name, main_program=main,
                                num_trainers=world, trainer_id=tid,
                                scope=scope)
    names = functionalizer.persistable_names(main)
    if tid == 0:
        np.savez(os.path.join(outdir, "init.npz"),
                 **{n: fluid.as_numpy(scope.get(n)) for n in names
                    if scope.get(n) is not None})
    group = pe.group
    group.reset_counts()
    group.time_grads = True
    losses = []
    for step in range(PAR_STEPS):
        images, labels = _par_shard(step, tid)
        out, = pe.run([loss.name], feed={"data": images, "label": labels})
        losses.append(float(np.asarray(out).ravel()[0]))
    grads = [scope.get(p.name) for p in main.global_block().all_parameters()]
    buckets = functionalizer._grad_buckets(
        grads, functionalizer.GRAD_BUCKET_BYTES)
    stats = {n: fluid.as_numpy(scope.get(n)) for n in names
             if n.endswith(("mean_0", "var_0"))}
    np.savez(os.path.join(outdir, "rank%d.npz" % tid), **stats)
    with open(os.path.join(outdir, "rank%d.json" % tid), "w") as f:
        json.dump({"rank": tid, "world": world, "losses": losses,
                   "card": torch.cuda.current_device(),
                   "backend": torch.distributed.get_backend(),
                   "counts": dict(group.counts),
                   "nbytes": dict(group.nbytes), "grad_ms": group.grad_ms,
                   "buckets": len(buckets),
                   "grad_bytes": sum(g.numel() * 4 for g in grads)}, f)
    torch.distributed.destroy_process_group()
    return 0


def phase_parallel(torch, fluid):
    """Data-parallel ResNet-50 training through the collective transpiler
    and the ParallelExecutor, one NCCL rank per visible card (a world of
    one on a one-card machine: its collectives still run through NCCL).
    Gates: every rank exits 0 on its own card; finite losses, the same on
    every rank; every rank's moving statistics equal; 53 sync-BN
    all-reduces a step forward and 53 backward; the losses against the
    single-card Executor on the same global batch (deterministic cuDNN)."""
    from paddle_tpu_torch.parallel import mesh
    n = torch.cuda.device_count()
    log("parallel: one NCCL rank per visible card: a world of %d%s" % (
        n, " (one card on this machine: the phase runs a world of one, "
        "whose collectives still go through NCCL)" if n == 1 else ""))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        results = mesh.launch([os.path.abspath(__file__), "--parallel-rank",
                               tmp], n, use_cuda=True, capture=True,
                              timeout=PAR_TIMEOUT_S)
        for rank, (rc, out, err) in enumerate(results):
            if rc != 0:
                log("parallel: rank %d stderr:\n%s" % (rank, err[-4000:]))
            check(rc == 0, "parallel: rank %d exited %d" % (rank, rc))
        log("parallel: %d rank(s) trained %d steps in %.1f s (processes "
            "included)" % (n, PAR_STEPS, time.time() - t0))
        recs, stats = [], []
        for rank in range(n):
            with open(os.path.join(tmp, "rank%d.json" % rank)) as f:
                recs.append(json.load(f))
            with np.load(os.path.join(tmp, "rank%d.npz" % rank)) as z:
                stats.append({k: z[k] for k in z.files})
        with np.load(os.path.join(tmp, "init.npz")) as z:
            init = {k: z[k] for k in z.files}
    losses = recs[0]["losses"]
    check(all(np.isfinite(losses)), "parallel: losses %s" % losses)
    check([r["card"] for r in recs] == list(range(n)),
          "parallel: the ranks ran on cards %s" % [r["card"] for r in recs])
    check(all(r["backend"] == "nccl" for r in recs),
          "parallel: backends %s" % [r["backend"] for r in recs])
    for r, st in zip(recs[1:], stats[1:]):
        check(r["losses"] == losses, "parallel: rank %d's losses %s differ "
              "from rank 0's %s" % (r["rank"], r["losses"], losses))
        check(sorted(st) == sorted(stats[0]) and all(
            np.array_equal(st[k], stats[0][k]) for k in st),
              "parallel: rank %d's moving statistics differ from rank 0's"
              % r["rank"])
    check(len(stats[0]) == 2 * PAR_BN, "parallel: %d moving statistics"
          % len(stats[0]))
    counts = recs[0]["counts"]
    bn = counts.get("batch_norm", 0) / PAR_STEPS
    bn_grad = counts.get("batch_norm_grad", 0) / PAR_STEPS
    check(bn == PAR_BN and bn_grad == PAR_BN,
          "parallel: %s sync-BN all-reduces a step forward, %s backward"
          % (bn, bn_grad))
    # the single-card Executor on the same global batch, from the state
    # the ranks started from
    fluid.set_amp(False)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        main, _, loss = _par_model(fluid, n)
        scope = fluid.scope_from_jax(init, fluid.Scope(),
                                     fluid.CUDAPlace(0))
        exe = fluid.Executor(fluid.CUDAPlace(0))
        ref = []
        with fluid.scope_guard(scope):
            for step in range(PAR_STEPS):
                shards = [_par_shard(step, r) for r in range(n)]
                feed = {"data": np.concatenate([s[0] for s in shards]),
                        "label": np.concatenate([s[1] for s in shards])}
                out, = exe.run(main, feed=feed, fetch_list=[loss])
                ref.append(float(np.asarray(out).ravel()[0]))
        del scope, exe
    finally:
        torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
    log("parallel: losses %s, the single-card Executor's on the global "
        "batch %s, relative differences %s"
        % (losses, ref, ["%.3g" % x for x in rel]))
    check(rel[0] <= PAR_RTOL0 and max(rel) <= PAR_RTOL,
          "parallel: the global step left the Executor's trajectory: %s"
          % rel)
    grad_ms = [float(np.median([r["grad_ms"][s] for r in recs]))
               for s in range(PAR_STEPS)]
    per_step = {k: v / PAR_STEPS for k, v in sorted(counts.items())}
    log("parallel: world %d, gradient buckets %d holding %d bytes (%.1f MB) "
        "a step; gradient all-reduce %s ms a step (median over the ranks, "
        "the card synchronized around it); sync-BN all-reduces a step: %d "
        "forward + %d backward; collectives a step by kind: %s"
        % (n, recs[0]["buckets"], recs[0]["grad_bytes"],
           recs[0]["grad_bytes"] / 1e6, ["%.3f" % x for x in grad_ms],
           bn, bn_grad, per_step))
    return {"world": n, "losses": losses, "executor_losses": ref,
            "grad_ms": grad_ms, "buckets": recs[0]["buckets"],
            "grad_bytes": recs[0]["grad_bytes"], "collectives": per_step}


# ---------------------------------------------------------------------------
# 6c. coverage: the user paths at head dims and channel edges off the
# kernels' instantiated widths (their kernel cases are in phase 2)
# ---------------------------------------------------------------------------

def phase_coverage_paths(torch, pk, fluid, transformer, decode, tmp):
    """The user paths that reach the coverage shapes (phase 2 holds their
    kernels against the plain versions at these shapes), each with the
    launch counts zeroed just before and read just after:
      * the transformer's training program (models.transformer.get_model,
        2 layers, batch x seq COVER_TRAIN_BS) at COVER_TRAIN's head dims
        (32: d_model 512, 16 heads; 96: d_model 768, 8 heads; 192: 768,
        4; 256: 1024, 4), 3 Adam steps fp32 and 3 under AMP: the losses
        finite, K1, K2-dq and K2-dkv 2 x 3 launches each in the lane's
        dtype;
      * decode serving on models of COVER_SERVE's head dims (48, 50, 96,
        192 and 256), 2 layers, COVER_SEQ positions: greedy decode of 4 prompts on
        COVER_SLOTS slots, up to 8 tokens each, with fp32 and int8 KV
        caches, K3 / K4 2 launches a decode step; the tokens equal the
        CPU predictor's with the same KV cache type.
    Returns {(path, D): {counter: launches}}."""
    out = {}
    feed_rng = np.random.RandomState(5)
    B, S = COVER_TRAIN_BS
    for D, width, heads in COVER_TRAIN:
        counts = {}
        for amp in (False, True):
            main, startup, _, avg_loss, _, _ = transformer.get_model(
                batch_size=B, seq_len=S, d_model=width, n_heads=heads,
                n_layers=2)
            startup.random_seed = TRAIN_SEED
            feed = _batch(feed_rng, B, S, 32000)
            exe = fluid.Executor(fluid.CUDAPlace(0))
            scope = fluid.Scope()
            fluid.set_amp(amp)
            try:
                with fluid.scope_guard(scope):
                    exe.run(startup)
                    pk.reset_launch_counts()
                    losses = [float(exe.run(main, feed=feed,
                                            fetch_list=[avg_loss])[0])
                              for _ in range(3)]
                    torch.cuda.synchronize()
            finally:
                fluid.set_amp(False)
            check(all(np.isfinite(losses)), "coverage train D %d amp %s: "
                  "losses %s" % (D, amp, losses))
            dtype = torch.bfloat16 if amp else torch.float32
            for name in FLASH_KERNELS:
                c = pk.launch_counts[pk._count_name(name, dtype)]
                check(c == 2 * 3, "coverage train D %d amp %s: %s launched "
                      "%d times in 3 steps x 2 layers" % (D, amp, name, c))
            counts.update({k: v for k, v in pk.launch_counts.items() if v})
            log("coverage path train D %d (d_model %d, %d heads) %s: losses "
                "%s; launches %s" % (D, width, heads,
                                     "amp" if amp else "fp32",
                                     ["%.4f" % x for x in losses],
                                     {k: v for k, v in
                                      pk.launch_counts.items() if v}))
        out[("train", D)] = counts
        torch.cuda.empty_cache()
    for D, width, heads in COVER_SERVE:
        art = os.path.join(tmp, "cover_lm_%d" % D)
        decode.build_tiny_decode_model(art, vocab_size=1000, d_model=width,
                                       n_heads=heads, n_layers=2,
                                       max_seq_len=COVER_SEQ)
        rng = np.random.RandomState(D)
        prompts = [[int(t) for t in rng.randint(0, 1000, size=n)]
                   for n in (5, 17, 40, 64)]
        counts = {}
        for kv in (None, "int8"):
            pred = decode.load_decode_predictor(art, kv_cache_dtype=kv)
            check(pred.device.type == "cuda", "coverage predictor not on "
                  "the card")
            pk.reset_launch_counts()
            toks = [decode.greedy_decode(pred, p, 8, n_slots=COVER_SLOTS)[0]
                    for p in prompts]
            torch.cuda.synchronize()
            name = "decode_attention_int8" if kv else "decode_attention"
            c = pk.launch_counts[name]
            # the prefill gives each first token, each later one a step
            steps = sum(len(t) - 1 for t in toks)
            check(steps > 0 and c == 2 * steps,
                  "coverage serve D %d %s: %s launched %d times for %d "
                  "decode steps x 2 layers" % (D, kv or "fp32", name, c,
                                               steps))
            check(all(1 <= len(t) <= 8 and all(0 <= x < 1000 for x in t)
                      for t in toks), "coverage serve D %d: bad tokens %s"
                  % (D, toks))
            cpu = decode.load_decode_predictor(art, device="cpu",
                                               kv_cache_dtype=kv)
            want = [decode.greedy_decode(cpu, p, 8, n_slots=COVER_SLOTS)[0]
                    for p in prompts]
            check(toks == want, "coverage serve D %d %s KV: card tokens %s, "
                  "CPU %s" % (D, kv or "fp32", toks, want))
            counts[name] = c
            log("coverage path serve D %d (d_model %d, %d heads) %s KV: "
                "%d launches of %s; tokens %s (= the CPU predictor's)"
                % (D, width, heads, kv or "fp32", c, name, toks[0]))
            del pred
        out[("serve", D)] = counts
    return out


# ---------------------------------------------------------------------------
# 6d. the update region: noam + global-norm clipping at full width, and
# sparse (SelectedRows) embedding gradients under every optimizer
# ---------------------------------------------------------------------------

def _noam_clip_program(fluid, transformer, B, S):
    """The full-width transformer (models.transformer.build) with
    noam_decay(512, NOAM_WARMUP), Adam (0.9, 0.98, 1e-9) and
    GradientClipByGlobalNorm(CLIP_NORM) given to its program; dropout at
    0 so one repeated batch sees one forward.  Returns (main, startup,
    loss, lr, the gradients' global norm the clip computes, the clipped
    gradients' global norm)."""
    w = FULL_WIDTH
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = TRAIN_SEED
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        layers = fluid.layers
        tokens = layers.data("tokens", shape=[S], dtype="int64")
        labels = layers.data("labels", shape=[S], dtype="int64")
        logits = transformer.build(tokens, w["vocab_size"], S, w["d_model"],
                                   w["n_heads"], w["n_layers"],
                                   4 * w["d_model"])
        loss = layers.mean(layers.softmax_with_cross_entropy(
            layers.reshape(logits, [-1, w["vocab_size"]]),
            layers.reshape(labels, [-1, 1])))
        lr = layers.noam_decay(w["d_model"], NOAM_WARMUP)
        fluid.clip.set_gradient_clip(
            fluid.clip.GradientClipByGlobalNorm(CLIP_NORM), program=main)
        _, params_grads = fluid.optimizer.Adam(
            lr, beta1=0.9, beta2=0.98, epsilon=1e-9).minimize(loss)
        norm = layers.sqrt(layers.sums(
            [layers.reduce_sum(layers.square(g)) for _, g in params_grads]))
    # the clip's own global norm: the first sqrt of the program
    pre = next(op for op in main.global_block().ops
               if op.type == "sqrt").output("Out")[0]
    for op in main.global_block().ops:
        if op.type == "dropout":
            op.attrs["dropout_prob"] = 0.0
    return main, startup, loss, lr, pre, norm


def phase_noam_clip_train(torch, pk, fluid, transformer, amp=False):
    """NOAM_STEPS steps of the noam-and-clip transformer on one repeated
    batch at full width (batch 8 x 512), the launch counts zeroed just
    before the steps and read just after: finite, falling losses, the LR
    read back each step equal to the closed form, the
    clipped gradients' global norm at most CLIP_NORM, K1 and K2 launched
    layers x steps times each in the lane's dtype; steps/s, median step
    ms and the device's busy share over one profiled step."""
    from torch.profiler import ProfilerActivity, profile
    label = "noam clip train" + (" amp" if amp else "")
    B, S = 8, 512
    n_layers, d_model = FULL_WIDTH["n_layers"], FULL_WIDTH["d_model"]
    main, startup, loss, lr, pre, norm = _noam_clip_program(
        fluid, transformer, B, S)
    types_ = [op.type for op in main.global_block().ops]
    check(types_[0] == "increment" and types_.count("squared_l2_norm")
          == len(main.all_parameters()),
          "%s: the program lacks the counter or the clip" % label)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    feed = _batch(np.random.RandomState(TRAIN_SEED), B, S,
                  FULL_WIDTH["vocab_size"])
    dtype = torch.bfloat16 if amp else torch.float32
    fluid.set_amp(amp)
    try:
        with fluid.scope_guard(scope):
            exe.run(startup)
            torch.cuda.synchronize()
            pk.reset_launch_counts()
            losses, lrs, pres, norms, step_s = [], [], [], [], []
            for _ in range(NOAM_STEPS):
                t0 = time.perf_counter()
                got = exe.run(main, feed=feed,
                              fetch_list=[loss, lr, pre, norm])
                step_s.append(time.perf_counter() - t0)
                got = [float(np.asarray(g).ravel()[0]) for g in got]
                for out, g in zip((losses, lrs, pres, norms), got):
                    out.append(g)
            counts = dict(pk.launch_counts)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                exe.run(main, feed=feed, fetch_list=[loss])
                prof_ms = (time.perf_counter() - t0) * 1e3
    finally:
        fluid.set_amp(False)
    want_lrs = [d_model ** -0.5 * min(t ** -0.5, NOAM_WARMUP ** -1.5 * t)
                for t in range(1, NOAM_STEPS + 1)]
    log("%s: losses %s; lr read back %s (closed form %s); gradients' "
        "global norm %s, clipped %s" % (
            label, ["%.6f" % x for x in losses], ["%.6g" % x for x in lrs],
            ["%.6g" % x for x in want_lrs], ["%.6g" % x for x in pres],
            ["%.6g" % x for x in norms]))
    check(all(np.isfinite(losses)), "%s: non-finite loss %s"
          % (label, losses))
    check(losses[-1] < losses[0], "%s: the loss did not fall over %d "
          "steps on one batch: %s" % (label, NOAM_STEPS, losses))
    check(all(abs(a - b) <= 1e-6 * b for a, b in zip(lrs, want_lrs)),
          "%s: lr %s, closed form %s" % (label, lrs, want_lrs))
    check(all(n <= CLIP_NORM + 1e-5 for n in norms),
          "%s: clipped global norm %s above %g" % (label, norms, CLIP_NORM))
    # the clip scales by CLIP_NORM / max(norm, CLIP_NORM)
    check(all(abs(n - min(p, CLIP_NORM)) <= 1e-4 * min(p, CLIP_NORM)
              for p, n in zip(pres, norms)),
          "%s: clipped norms %s for gradient norms %s" % (label, norms,
                                                          pres))
    for name in FLASH_KERNELS:
        c = counts[pk._count_name(name, dtype)]
        check(c == n_layers * NOAM_STEPS, "%s: %s launched %d times in %d "
              "steps x %d layers" % (label, name, c, NOAM_STEPS, n_layers))
    step_ms = float(np.median(step_s[1:])) * 1e3
    device_ms, rows = profile_rows(torch, prof, 1)
    busy = 100.0 * device_ms / step_ms if rows else None
    log("%s: %d steps of %d tokens: median step %.3f ms (first %.1f ms) -> "
        "%.3f steps/s; device busy %s of the step (one profiled step, host "
        "%.3f ms under the profiler); K1/K2 launches %s"
        % (label, NOAM_STEPS, B * S, step_ms, step_s[0] * 1e3,
           1e3 / step_ms, "%.1f%%" % busy if rows else "not measured",
           prof_ms, {pk._count_name(n, dtype): counts[pk._count_name(
               n, dtype)] for n in FLASH_KERNELS}))
    log(json.dumps({label.replace(" ", "_"): {
        "losses": losses, "lr": lrs, "grad_norm": pres,
        "clipped_norm": norms,
        "step_ms": [x * 1e3 for x in step_s], "median_step_ms": step_ms,
        "steps_per_s": 1e3 / step_ms, "device_busy_ms": device_ms,
        "busy_pct": busy, "launches": {k: v for k, v in counts.items()
                                       if v}}}))
    return counts


def _bow_program(fluid, make_opt, sparse=True):
    """A bag-of-words classifier: a SPARSE_VOCAB x SPARSE_DIM table with
    is_sparse, mean-pooled over SPARSE_T ids, fc to SPARSE_CLASSES,
    softmax cross entropy, `make_opt(fluid.optimizer)`'s update."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = SPARSE_SEED
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        layers = fluid.layers
        ids = layers.data("ids", shape=[SPARSE_T, 1], dtype="int64")
        label = layers.data("label", shape=[1], dtype="int64")
        emb = layers.embedding(ids, size=[SPARSE_VOCAB, SPARSE_DIM],
                               is_sparse=sparse,
                               param_attr=fluid.ParamAttr(name="bow_table"))
        pooled = layers.scale(layers.reduce_sum(emb, dim=1),
                              scale=1.0 / SPARSE_T)
        logits = layers.fc(pooled, size=SPARSE_CLASSES)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
        make_opt(fluid.optimizer).minimize(loss)
    return main, startup, loss


def _bow_feeds():
    rng = np.random.RandomState(SPARSE_SEED)
    feeds = []
    for _ in range(SPARSE_STEPS):
        ids = rng.randint(0, SPARSE_VOCAB,
                          size=(SPARSE_BATCH, SPARSE_T, 1)).astype(np.int64)
        ids[0, :16] = 7  # a row looked up many times
        feeds.append({"ids": ids, "label": rng.randint(
            0, SPARSE_CLASSES, size=(SPARSE_BATCH, 1)).astype(np.int64)})
    return feeds


def _bow_run(fluid, exe, scope, main, loss, feeds):
    """The steps on `exe` in `scope` -> (losses, step seconds)."""
    losses, step_s = [], []
    with fluid.scope_guard(scope):
        for feed in feeds:
            t0 = time.perf_counter()
            out, = exe.run(main, feed=feed, fetch_list=[loss])
            step_s.append(time.perf_counter() - t0)
            losses.append(float(np.asarray(out).ravel()[0]))
    return losses, step_s


def _worst_scaled(a_scope, b_scope, names):
    """max over `names` of max |a - b| / max |b| (0 for an all-zero b)."""
    from paddle_tpu_torch.fluid.executor import as_numpy
    worst, where = 0.0, None
    for n in names:
        a = as_numpy(a_scope.get(n)).astype(np.float64)
        b = as_numpy(b_scope.get(n)).astype(np.float64)
        scale = float(np.abs(b).max()) or 1.0
        err = float(np.abs(a - b).max()) / scale
        if err > worst:
            worst, where = err, n
    return worst, where


def phase_sparse_embedding(torch, fluid):
    """The bag-of-words classifier at the transformer's table width, its
    table's gradient a SelectedRows value (lookup_table_sparse_grad),
    SPARSE_STEPS steps under each optimizer of SPARSE_OPTIMIZERS on the
    card and on the CPU from one startup state: the losses within 1e-5
    and every persistable within 1e-5 of its array's largest magnitude;
    and the sparse SGD program's against the dense program's on the
    card."""
    feeds = _bow_feeds()
    gpu = fluid.Executor(fluid.CUDAPlace(0))
    cpu = fluid.Executor(fluid.CPUPlace())
    results = {}
    for name, make_opt in SPARSE_OPTIMIZERS:
        main, startup, loss = _bow_program(fluid, make_opt)
        types_ = [op.type for op in main.global_block().ops]
        check("lookup_table_sparse_grad" in types_
              and "lookup_table_grad" not in types_,
              "sparse %s: no sparse table grad in the program" % name)
        gscope = fluid.Scope()
        with fluid.scope_guard(gscope):
            gpu.run(startup)
        cscope = fluid.scope_from_jax(fluid.scope_to_jax(gscope),
                                      fluid.Scope(), fluid.CPUPlace())
        names = sorted(n for n, v in main.global_block().vars.items()
                       if v.persistable and gscope.has(n)
                       and gscope.get(n).is_floating_point())
        glosses, gstep = _bow_run(fluid, gpu, gscope, main, loss, feeds)
        torch.cuda.synchronize()
        check(gscope.get("bow_table").device.type == "cuda",
              "sparse %s: the table is not on the card" % name)
        closses, _ = _bow_run(fluid, cpu, cscope, main, loss, feeds)
        check(all(np.isfinite(glosses)), "sparse %s: losses %s"
              % (name, glosses))
        check(all(abs(a - b) <= 1e-5 * abs(b)
                  for a, b in zip(glosses, closses)),
              "sparse %s: card losses %s, CPU %s" % (name, glosses, closses))
        worst, where = _worst_scaled(gscope, cscope, names)
        check(worst <= 1e-5, "sparse %s: %s on the card differs from the "
              "CPU by %.3g of its largest magnitude" % (name, where, worst))
        results[name] = {"losses": glosses, "step_ms": [
            x * 1e3 for x in gstep], "worst_vs_cpu": worst}
        log("sparse %s: losses %s (CPU %s); card vs CPU worst %.3g of the "
            "largest magnitude (%s, %d persistables); card step ms %s"
            % (name, ["%.6f" % x for x in glosses],
               ["%.6f" % x for x in closses], worst, where, len(names),
               ["%.2f" % (x * 1e3) for x in gstep]))
        if name == "SGD":
            sgd = (gscope, names)
        del gscope, cscope
    # the sparse SGD step against the dense program's on the card
    dmain, dstartup, dloss = _bow_program(fluid, SPARSE_OPTIMIZERS[0][1],
                                          sparse=False)
    check("lookup_table_sparse_grad" not in
          [op.type for op in dmain.global_block().ops],
          "dense SGD: a sparse grad in the dense program")
    dscope = fluid.Scope()
    with fluid.scope_guard(dscope):
        gpu.run(dstartup)
    dlosses, _ = _bow_run(fluid, gpu, dscope, dmain, dloss, feeds)
    worst, where = _worst_scaled(sgd[0], dscope, sgd[1])
    check(worst <= 1e-5, "sparse SGD vs dense SGD on the card: %s differs "
          "by %.3g of its largest magnitude" % (where, worst))
    log("sparse SGD vs the dense program on the card: losses %s vs %s, "
        "worst state %.3g of the largest magnitude (%s)"
        % (["%.6f" % x for x in results["SGD"]["losses"]],
           ["%.6f" % x for x in dlosses], worst, where))
    log(json.dumps({"sparse_embedding": results}))
    return results


# ---------------------------------------------------------------------------
# 14. control flow (sub-blocks): while, StaticRNN, DynamicRNN, IfElse
# ---------------------------------------------------------------------------

def _cf_programs(fluid):
    """The small control-flow programs, each with its backward: (name,
    main, startup, loss, params, feed)."""
    L = fluid.layers
    out = []
    rng = np.random.RandomState(3)

    def build(name, body):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            loss, feed = body()
            pg = fluid.backward.append_backward(loss)
        out.append((name, main, startup, loss, pg, feed))

    def while_net():
        x = L.data("x", shape=[16], dtype="float32")
        h = L.assign(x)
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 3)
        cond = L.less_than(i, n)
        w = L.While(cond)
        with w.block():
            L.assign(L.fc(h, size=16, act="tanh", bias_attr=False,
                          param_attr=fluid.ParamAttr(name="loop_w")), h)
            L.increment(i, 1.0, in_place=True)
            L.less_than(i, n, cond=cond)
        return L.mean(L.square(h)), {
            "x": rng.randn(8, 16).astype(np.float32)}

    def static_rnn_net():
        T, B, D, H = 6, 8, 12, 16
        x = L.data("x", shape=[T, B, D], dtype="float32",
                   append_batch_size=False)
        label = L.data("label", shape=[B, 1], dtype="int64",
                       append_batch_size=False)
        rnn = L.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            mem = rnn.memory(shape=[B, H], batch_ref=x)
            h = L.fc(input=[xt, mem], size=H, act="tanh")
            rnn.update_memory(mem, h)
            rnn.step_output(h)
        last = L.squeeze(L.slice(rnn(), axes=[0], starts=[T - 1], ends=[T]),
                         axes=[0])
        loss = L.mean(L.cross_entropy(L.fc(last, size=3, act="softmax"),
                                      label))
        return loss, {"x": rng.randn(T, B, D).astype(np.float32),
                      "label": rng.randint(0, 3, (B, 1)).astype(np.int64)}

    def dynamic_rnn_net():
        x = L.data("x", shape=[12], dtype="float32", lod_level=1)
        init = L.data("init", shape=[16], dtype="float32")
        label = L.data("label", shape=[1], dtype="int64")
        rnn = L.DynamicRNN()
        with rnn.block():
            xt = rnn.step_input(x)
            mem = rnn.memory(init=init)
            h = L.fc(input=[xt, mem], size=16, act="tanh")
            rnn.update_memory(mem, h)
            rnn.output(h)
        pred = L.fc(L.sequence_pool(rnn(), "last"), size=2, act="softmax")
        lens = [2, 7, 1, 5, 4, 3]
        return L.mean(L.cross_entropy(pred, label)), {
            "x": fluid.create_lod_tensor(
                rng.randn(sum(lens), 12).astype(np.float32), [lens], None),
            "init": rng.randn(len(lens), 16).astype(np.float32),
            "label": rng.randint(0, 2, (len(lens), 1)).astype(np.int64)}

    def ifelse_net():
        x = L.data("x", shape=[8], dtype="float32")
        cond = L.less_than(L.slice(x, axes=[1], starts=[0], ends=[1]),
                           L.fill_constant([1], "float32", 0.0))
        ie = L.IfElse(cond)
        with ie.true_block():
            ie.output(L.fc(ie.input(x), size=4,
                           param_attr=fluid.ParamAttr(name="t_w")))
        with ie.false_block():
            ie.output(L.fc(ie.input(x), size=4,
                           param_attr=fluid.ParamAttr(name="f_w")))
        return L.mean(L.square(ie()[0])), {
            "x": rng.randn(10, 8).astype(np.float32)}

    build("while", while_net)
    build("static_rnn", static_rnn_net)
    build("dynamic_rnn", dynamic_rnn_net)
    build("ifelse", ifelse_net)
    return out


def phase_control_flow(torch, fluid):
    """The small while (an fc through 3 trips), StaticRNN, DynamicRNN
    (ragged) and IfElse programs from one startup state (run on the CPU,
    carried to the card): the loss and every parameter's gradient on the
    card against the CPU, within 1e-5 relative (the loss) and 1e-4 of
    each gradient's largest magnitude."""
    cpu, gpu = fluid.CPUPlace(), fluid.CUDAPlace(0)
    for name, main, startup, loss, pg, feed in _cf_programs(fluid):
        scope0 = fluid.Scope()
        fluid.Executor(cpu).run(startup, scope=scope0)
        init = {n: scope0.get(n).numpy() for n in scope0.keys()}
        fetch = [loss] + [g for _, g in pg]
        res = {}
        for dev, place in (("gpu", gpu), ("cpu", cpu)):
            scope = fluid.scope_from_jax(init, fluid.Scope(), place)
            exe = fluid.Executor(place)
            check(exe.device.type == ("cuda" if dev == "gpu" else "cpu"),
                  "control flow %s: executor on %s" % (name, exe.device))
            res[dev] = [np.asarray(v) for v in exe.run(
                main, feed=feed, fetch_list=fetch, scope=scope)]
        (lg, *gg), (lc, *gc) = res["gpu"], res["cpu"]
        lerr = float(abs(lg.ravel()[0] - lc.ravel()[0]) / abs(lc.ravel()[0]))
        check(lerr <= 1e-5, "control flow %s: loss card %s CPU %s (rel err "
              "%.3g > 1e-5)" % (name, lg.ravel(), lc.ravel(), lerr))
        worst = (0.0, "")
        for (p, _), a, b in zip(pg, gg, gc):
            e = float(np.abs(a - b).max()) / max(float(np.abs(b).max()),
                                                 1e-30)
            worst = max(worst, (e, p.name))
        check(worst[0] <= 1e-4, "control flow %s: grad of %s on the card "
              "lies %.3g of its largest magnitude from the CPU's"
              % (name, worst[1], worst[0]))
        subs = [op.type for op in main.global_block().ops
                if op.attrs.get("sub_block") is not None]
        log("control flow %s: %d blocks, sub-block ops %s; loss card %.6f "
            "CPU %.6f (rel err %.3g); %d parameter grads, worst %s at %.3g "
            "of its largest magnitude (tolerance 1e-4)"
            % (name, len(main.blocks), subs, float(lg.ravel()[0]),
               float(lc.ravel()[0]), lerr, len(pg), worst[1], worst[0]))


# ---------------------------------------------------------------------------
# 15. the seq2seq machine-translation model: training, then generation
# ---------------------------------------------------------------------------

MT_ITERS = 10
MT_SKIP = 2
MT_ARGV = ["--model", "machine_translation", "--batch_size", "32"]
MT_FALL_STEPS = 8
MT_BEAM = 3
MT_MAX_LEN = 8
MT_DICT = 30000


def _mt_label(op):
    if op.type == "recurrent":
        return "recurrent decoder step loop fwd"
    if op.type == "lstm":
        return "lstm encoder step loop fwd"
    return _zoo_label(op)


def _sync_watch(torch, registry, functionalizer):
    """A context that records, under torch.cuda.set_sync_debug_mode
    ("warn"), every host sync and the outermost op (forward lowering or
    grad op) it happened in: {op type: [messages]}."""
    import contextlib
    import warnings

    @contextlib.contextmanager
    def watch():
        stack, seen = [], {}
        orig_lower, orig_grad = registry.call_lower, \
            functionalizer._run_grad_op

        def note(w):
            where = stack[0] if stack else "(between ops)"
            seen.setdefault(where, []).append(str(w.message)[:120])

        def lower(od, ctx):
            stack.append(od.type)
            try:
                with warnings.catch_warnings(record=True) as ws:
                    warnings.simplefilter("always")
                    r = orig_lower(od, ctx)
                for w in ws:
                    note(w)
                return r
            finally:
                stack.pop()

        def grad(op, env, cache):
            stack.append(op.type)
            try:
                with warnings.catch_warnings(record=True) as ws:
                    warnings.simplefilter("always")
                    orig_grad(op, env, cache)
                for w in ws:
                    note(w)
            finally:
                stack.pop()

        registry.call_lower = lower
        functionalizer._run_grad_op = grad
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as outer:
                warnings.simplefilter("always")
                yield seen
            for w in outer:
                if "synchroniz" in str(w.message):
                    note(w)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            registry.call_lower = orig_lower
            functionalizer._run_grad_op = orig_grad
    return watch()


def _mt_small(fluid, mt, generating):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = mt.seq_to_seq_net(32, 32, 32, 100, 100,
                                is_generating=generating, beam_size=3,
                                max_length=6)
        if not generating:
            fluid.optimizer.Adam(learning_rate=1e-3).minimize(out[0])
    return main, startup, out


def _mt_small_feed(fluid, step, lens=(3, 9, 5, 7)):
    rng = np.random.RandomState(100 + step)
    out = {}
    for name, ln in (("source_sequence", lens),
                     ("target_sequence", lens[::-1]),
                     ("label_sequence", lens[::-1])):
        out[name] = fluid.create_lod_tensor(
            rng.randint(2, 100, (sum(ln), 1)).astype(np.int64), [list(ln)],
            None)
    return out


def _mt_gpu_vs_cpu(torch, fluid, mt):
    """The small model (widths 32, dict 100, batch 4) 3 Adam steps on the
    card and on the CPU from one startup state: the losses within 1e-4
    relative; every parameter within 1e-5 of its array's largest
    magnitude.  Beside it, the spread that one ulp of the source
    embedding makes on the CPU: how far rounding alone carries the
    parameters in 3 steps."""
    main, startup, (loss, _, _) = _mt_small(fluid, mt, False)
    cpu, gpu = fluid.CPUPlace(), fluid.CUDAPlace(0)
    scope0 = fluid.Scope()
    fluid.Executor(cpu).run(startup, scope=scope0)
    init = {n: scope0.get(n).numpy() for n in scope0.keys()}
    nudged = dict(init)
    nudged["embedding_0.w_0"] = np.nextafter(init["embedding_0.w_0"],
                                             np.float32(np.inf))
    params = [p.name for p in main.all_parameters()]
    res = {}
    for dev, place, state in (("gpu", gpu, init), ("cpu", cpu, init),
                              ("cpu nudged", cpu, nudged)):
        scope = fluid.scope_from_jax(state, fluid.Scope(), place)
        exe = fluid.Executor(place)
        losses = [float(np.asarray(exe.run(
            main, feed=_mt_small_feed(fluid, s), fetch_list=[loss],
            scope=scope)[0]).ravel()[0]) for s in range(3)]
        res[dev] = (losses, {n: scope.get(n).cpu().numpy() for n in params})
    (lg, pg), (lc, pc) = res["gpu"], res["cpu"]
    check(all(abs(a - b) <= 1e-4 * abs(b) for a, b in zip(lg, lc)),
          "mt gpu/cpu: losses card %s CPU %s (tolerance 1e-4)" % (lg, lc))
    free = _worst_spread(pg, pc)
    nudge = _worst_spread(res["cpu nudged"][1], pc)
    check(free[0] <= 1e-5,
          "mt gpu/cpu: %s on the card lies %.3g of its largest magnitude "
          "from the CPU's after 3 steps (tolerance 1e-5); one embedding ulp "
          "moves the CPU's %s by %.3g" % (free[1], free[0], nudge[1],
                                          nudge[0]))
    log("mt gpu/cpu (widths 32, dict 100, batch 4, 3 Adam steps): losses "
        "card %s CPU %s (tolerance 1e-4); parameters: worst %s at %.3g of "
        "its largest magnitude (tolerance 1e-5); one embedding ulp moves "
        "the CPU's %s by %.3g"
        % (lg, lc, free[1], free[0], nudge[1], nudge[0]))
    return init


def phase_mt_train(torch, pk, fluid):
    """fluid_benchmark --model machine_translation at the JAX tool's cell
    (get_model's defaults: embedding, encoder and decoder 512, dict
    30000, Adam 2e-4; batch 32; lengths 3-11, T 16 padded): per-op fp32
    and the tool's AMP lane, 2 warm-up and 10 timed steps each (examples/s,
    median step, ops and launches a step, busy share, peak memory; the
    card's name and power limit are in the record); then the loss on one
    repeated batch at full width (it must fall), one full-width step
    dispatched under torch.cuda.set_sync_debug_mode with no host sync
    inside `recurrent` (its forward or its grad), and the small model
    on the card against the CPU.  Returns the trained scope and its
    program, for generation."""
    from paddle_tpu_torch import fluid_benchmark as fb
    from paddle_tpu_torch.fluid import functionalizer
    from paddle_tpu_torch.models import machine_translation as mt
    from paddle_tpu_torch.ops import registry
    lanes = {}
    for amp in (False, True):
        lanes[amp] = _zoo_lane(torch, pk, registry, functionalizer, fb,
                               "mt", MT_ARGV, amp, False, iters=MT_ITERS,
                               skip=MT_SKIP, label_fn=_mt_label)
    args = fb.parse_args(MT_ARGV + ["--no_amp"])
    with fluid.unique_name.guard():
        main, startup, feeds, loss, _, _ = fb.build_model(args)
    rec = next(op for op in main.global_block().ops
               if op.type == "recurrent")
    sub_ops = len(rec.attrs["sub_block"].ops)
    for amp in (False, True):
        o = lanes[amp]
        log("mt %s: %.1f examples/s, median step %.2f ms; %d block-0 ops a "
            "step + %d decoder-step ops x T trips; %s launches a step, busy "
            "%s; peak %.2f GiB; %s, %s"
            % ("amp" if amp else "fp32", o["examples_per_s"],
               o["median_step_ms"], o["ops_per_step"], sub_ops,
               "%.0f" % o["launches_per_step"] if "launches_per_step" in o
               else "not measured",
               "%.1f%%" % (100 * o["busy_share"]) if "busy_share" in o
               else "not measured", o["peak_mem_bytes"] / 2 ** 30,
               o["record"]["card"], o["record"]["power_limit"]))
    # the loss on one repeated batch, fp32, full width
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    rng = np.random.RandomState(3)
    batch = fb.synth_feed(feeds, 32, rng, program=main,
                          lengths=fb.lod_lengths(args),
                          same_lengths=fb._SAME_LENGTHS[args.model])
    check(batch["label_sequence"].recursive_sequence_lengths()
          == batch["target_sequence"].recursive_sequence_lengths(),
          "mt: the label's lengths are not the target's")
    with fluid.scope_guard(scope):
        exe.run(startup)
        losses = [float(np.asarray(exe.run(main, feed=batch,
                                           fetch_list=[loss])[0]).ravel()[0])
                  for _ in range(MT_FALL_STEPS)]
        check(all(np.isfinite(losses)), "mt: non-finite loss %s" % losses)
        check(losses[-1] < losses[0] and min(losses[-3:]) < losses[0],
              "mt: the loss did not fall over %d steps on one batch: %s"
              % (MT_FALL_STEPS, losses))
        log("mt one batch, %d steps: losses %s"
            % (MT_FALL_STEPS, ["%.4f" % x for x in losses]))
        # one step dispatched under the sync debug mode, its feeds on the
        # card before it
        staged = exe._prepare_feeds(main, batch)
        torch.cuda.synchronize()
        with _sync_watch(torch, registry, functionalizer) as seen:
            fut = exe.run(main, feed=staged, fetch_list=[loss],
                          as_future=True)
            # the positive control: a read back between ops is seen
            torch.zeros(1, device="cuda").item()
        last = float(np.asarray(fut.result()[0]).ravel()[0])
    check(np.isfinite(last), "mt: the watched step's loss is %s" % last)
    check(seen.pop("(between ops)", None) is not None,
          "mt: the sync watch missed the control's read back")
    in_rec = {k: v for k, v in seen.items() if k.startswith("recurrent")}
    check(not in_rec, "mt: host syncs inside recurrent: %s" % in_rec)
    log("mt sync watch: one full-width step dispatched under "
        "set_sync_debug_mode('warn') (the control's read back after it "
        "seen): no host sync inside recurrent or recurrent_grad (T %d "
        "trips from the feed's padded shape); syncs elsewhere in the "
        "step, by op: %s"
        % (int(staged["target_sequence"].shape[1]),
           {k: len(v) for k, v in seen.items()} or "none"))
    for k, v in seen.items():
        log("mt sync watch:   %s: %s" % (k, v[0]))
    _mt_gpu_vs_cpu(torch, fluid, mt)
    return scope


def _hyps(ids, scores):
    """Per hypothesis (token tuple, score)."""
    lens = ids.recursive_sequence_lengths()[0]
    flat = np.asarray(ids).ravel()
    offs = np.concatenate([[0], np.cumsum(lens)])
    sc = (scores.detach().float().cpu().numpy() if hasattr(scores, "detach")
          else np.asarray(scores)).ravel()
    return [(tuple(int(t) for t in flat[offs[i]:offs[i + 1]]), float(sc[i]))
            for i in range(len(lens))]


def phase_mt_generate(torch, fluid, scope):
    """Beam search from the trained scope at batch 32 x beam 3, max
    length 8, full width (the generation program shares the training
    parameters by name): ids in range, lengths 1-8, each source's beams
    ranked, and each source's hypotheses run alone equal to the batched
    run's (ids equal; where they differ, the scores tie to 1e-5: a tie
    of candidates broken by rounding); then the small model's generation
    on the card against the CPU from one seeded scope: ids identical,
    scores within 1e-5."""
    from paddle_tpu_torch.models import machine_translation as mt
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids_v, scores_v, _ = mt.seq_to_seq_net(
            512, 512, 512, MT_DICT, MT_DICT, is_generating=True,
            beam_size=MT_BEAM, max_length=MT_MAX_LEN)
    missing = [p.name for p in main.all_parameters()
               if scope.get(p.name) is None]
    check(not missing, "mt generate: parameters not in the trained scope: "
          "%s" % missing)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    rng = np.random.RandomState(17)
    lens = [int(n) for n in rng.randint(3, 12, size=32)]
    rows = rng.randint(2, MT_DICT, (sum(lens), 1)).astype(np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)])

    def generate(r, ln):
        ids, scores = exe.run(main, feed={
            "source_sequence": fluid.create_lod_tensor(r, [ln], None)},
            fetch_list=[ids_v, scores_v], scope=scope, return_numpy=False)
        return _hyps(ids, scores)

    generate(rows, lens)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batched = generate(rows, lens)
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - t0) * 1e3
    check(len(batched) == 32 * MT_BEAM, "mt generate: %d hypotheses"
          % len(batched))
    for i, (toks, sc) in enumerate(batched):
        check(1 <= len(toks) <= MT_MAX_LEN and all(0 <= t < MT_DICT
                                                   for t in toks)
              and np.isfinite(sc), "mt generate: hypothesis %d %s %s"
              % (i, toks, sc))
    for b in range(32):
        sc = [batched[MT_BEAM * b + j][1] for j in range(MT_BEAM)]
        check(all(x >= y for x, y in zip(sc, sc[1:])),
              "mt generate: source %d beams not ranked: %s" % (b, sc))
    exact, tied = 0, 0
    for b in range(32):
        alone = generate(rows[offs[b]:offs[b + 1]], [lens[b]])
        mine = batched[MT_BEAM * b:MT_BEAM * (b + 1)]
        if alone == mine or [t for t, _ in alone] == [t for t, _ in mine]:
            exact += 1
            check(all(abs(x - y) <= 1e-5 * abs(y) for (_, x), (_, y) in
                      zip(alone, mine)),
                  "mt generate: source %d scores alone %s, batched %s"
                  % (b, alone, mine))
            continue
        sa = sorted(s for _, s in alone)
        sm = sorted(s for _, s in mine)
        check(all(abs(x - y) <= 1e-5 * abs(y) for x, y in zip(sa, sm)),
              "mt generate: source %d alone %s differs from batched %s "
              "beyond a tie" % (b, alone, mine))
        tied += 1
    log("mt generate: batch 32 x beam %d, max length %d, full width: %.1f "
        "ms a batch (%d program ops); %d hypotheses, lengths %s...; %d of "
        "32 sources alone equal the batched run, %d differ only by a tie "
        "of scores (within 1e-5)"
        % (MT_BEAM, MT_MAX_LEN, gen_ms, len(main.global_block().ops),
           len(batched), [len(t) for t, _ in batched[:9]], exact, tied))
    # the small model on the card against the CPU
    gmain, gstart, (gids, gscores, _) = _mt_small(fluid, mt, True)
    scope0 = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(gstart, scope=scope0)
    srng = np.random.RandomState(5)
    state = {n: (srng.randn(*scope0.get(n).shape) * 0.5).astype(np.float32)
             for n in scope0.keys()}
    feed = _mt_small_feed(fluid, 0)["source_sequence"]
    res = {}
    for dev, place in (("gpu", fluid.CUDAPlace(0)), ("cpu", fluid.CPUPlace())):
        sc = fluid.scope_from_jax(state, fluid.Scope(), place)
        ids, scores = fluid.Executor(place).run(
            gmain, feed={"source_sequence": feed},
            fetch_list=[gids, gscores], scope=sc, return_numpy=False)
        res[dev] = _hyps(ids, scores)
    check([t for t, _ in res["gpu"]] == [t for t, _ in res["cpu"]],
          "mt generate small: card ids %s, CPU %s" % (res["gpu"], res["cpu"]))
    check(all(abs(a - b) <= 1e-5 * abs(b) for (_, a), (_, b) in
              zip(res["gpu"], res["cpu"])),
          "mt generate small: scores card %s CPU %s" % (res["gpu"],
                                                        res["cpu"]))
    log("mt generate small (widths 32, dict 100, beam 3, max length 6): "
        "card ids equal the CPU's for all %d hypotheses, scores within "
        "1e-5" % len(res["gpu"]))


# ---------------------------------------------------------------------------
# 16. the book's text conv net, multi-head attention, the core ops
# ---------------------------------------------------------------------------

# convolution_net at the book's widths (06.understand_sentiment): dict,
# embedding, filters, classes; batch and the imdb reader's lengths
TEXT_CONV = dict(dict_dim=5147, emb_dim=128, hid_dim=512, class_dim=2)
TEXT_BATCH = 128
TEXT_LENS = (8, 120)
TEXT_STEPS = 10
TEXT_LR = 0.002
TEXT_SEED = 17
# nets.scaled_dot_product_attention at the transformer's widths
MHA_SHAPE = (8, 512, 512, 8)   # B, T, d, heads
MHA_RUNS = 10
OP_RTOL = OP_ATOL = 1e-5


def text_conv_program(fluid):
    """The book's convolution_net -> (main, startup, loss)."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = TEXT_SEED
    w = TEXT_CONV
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        words = L.data("words", shape=[1], dtype="int64", lod_level=1)
        label = L.data("label", shape=[1], dtype="int64")
        emb = L.embedding(words, size=[w["dict_dim"], w["emb_dim"]],
                          is_sparse=True)
        convs = [fluid.nets.sequence_conv_pool(
            emb, num_filters=w["hid_dim"], filter_size=k, act="tanh",
            pool_type="sqrt") for k in (3, 4)]
        prediction = L.fc(input=convs, size=w["class_dim"], act="softmax")
        loss = L.mean(L.cross_entropy(input=prediction, label=label))
        fluid.optimizer.Adagrad(learning_rate=TEXT_LR).minimize(loss)
    return main, startup, loss


def text_conv_batches(fluid, n):
    """`n` batches as the imdb reader draws them: lengths uniform in
    TEXT_LENS, a label, and 70% of the words from the label's third of
    the dictionary (the rest from the neutral third)."""
    rng = np.random.RandomState(TEXT_SEED)
    V = TEXT_CONV["dict_dim"]
    out = []
    for _ in range(n):
        labels = rng.randint(0, 2, size=(TEXT_BATCH, 1)).astype(np.int64)
        lens = [int(x) for x in rng.randint(TEXT_LENS[0], TEXT_LENS[1] + 1,
                                            size=TEXT_BATCH)]
        rows = []
        for lab, n_words in zip(labels[:, 0], lens):
            bank = rng.randint(0, V // 3, n_words) + (0 if lab else V // 3)
            neutral = rng.randint(2 * V // 3, V, n_words)
            rows.append(np.where(rng.rand(n_words) < 0.7, bank, neutral))
        words = np.concatenate(rows).astype(np.int64).reshape(-1, 1)
        out.append({"words": fluid.create_lod_tensor(words, [lens], None),
                    "label": labels})
    return out


def phase_text_conv(torch, pk, fluid):
    """The book's text conv net at its widths (_text_train).  No hand
    kernel is on this path."""
    main, startup, loss = text_conv_program(fluid)
    types_ = [op.type for op in main.global_block().ops]
    check(types_.count("sequence_conv") == 2
          and "lookup_table_sparse_grad" in types_,
          "text conv: the program lacks its sequence convs or sparse grad")
    # the table's gradient is a SelectedRows value, held by its update
    grads = [p.name + "@GRAD" for p in main.all_parameters()
             if not p.name.startswith("embedding")]
    return _text_train(torch, pk, fluid, "text conv", main, startup, loss,
                       grads)


def _text_train(torch, pk, fluid, tag, main, startup, loss, grads):
    """A text classifier at its widths on TEXT_STEPS + 1 of
    text_conv_batches: the first step's loss and dense gradients
    (`grads`) on the card against the CPU from one startup state, then
    TEXT_STEPS steps on the card (finite, falling losses, no hand-kernel
    launch), their examples/s and median step, and one profiled step
    (launches, busy share).  `tag` names the log lines and the JSON
    key."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.fluid.executor import as_numpy
    batches = text_conv_batches(fluid, TEXT_STEPS + 1)
    scope0 = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope0)
    init = {n: as_numpy(scope0.get(n)) for n in scope0.keys()}
    gpu = fluid.Executor(fluid.CUDAPlace(0))
    gscope = fluid.scope_from_jax(init, fluid.Scope(), fluid.CUDAPlace(0))
    cscope = fluid.scope_from_jax(init, fluid.Scope(), fluid.CPUPlace())
    t0 = time.perf_counter()
    cout = fluid.Executor(fluid.CPUPlace()).run(
        main, feed=batches[0], fetch_list=[loss] + grads, scope=cscope)
    cpu_s = time.perf_counter() - t0
    pk.reset_launch_counts()
    losses, step_s = [], []
    for i in range(TEXT_STEPS):
        t0 = time.perf_counter()
        out = gpu.run(main, feed=batches[i],
                      fetch_list=[loss] + (grads if i == 0 else []),
                      scope=gscope)
        step_s.append(time.perf_counter() - t0)
        losses.append(float(np.asarray(out[0]).ravel()[0]))
        if i == 0:
            gout = out
    counts = {k: v for k, v in pk.launch_counts.items() if v}
    check(not counts, tag + ": hand kernels launched on a path that has "
          "none: %s" % counts)
    closs = float(np.asarray(cout[0]).ravel()[0])
    check(abs(losses[0] - closs) <= 1e-5 * abs(closs),
          tag + ": first loss card %r, CPU %r" % (losses[0], closs))
    worst, where = _worst_spread(
        {n: np.asarray(v, np.float64) for n, v in zip(grads, gout[1:])},
        {n: np.asarray(v, np.float64) for n, v in zip(grads, cout[1:])})
    check(worst <= 1e-5, tag + ": %s on the card lies %.3g of its "
          "largest magnitude from the CPU's" % (where, worst))
    check(all(np.isfinite(losses)), tag + ": losses %s" % losses)
    check(np.mean(losses[-3:]) < losses[0],
          tag + ": the loss did not fall over %d steps: %s"
          % (TEXT_STEPS, losses))
    # one profiled step
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gpu.run(main, feed=batches[-1], fetch_list=[loss], scope=gscope)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    device_ms, rows = profile_rows(torch, prof, 1)
    med_ms = float(np.median(step_s[1:])) * 1e3
    out = {"losses": losses, "first_loss_cpu": closs,
           "grads_worst_vs_cpu": worst, "grads_worst_at": where,
           "cpu_step_s": cpu_s, "step_ms": [x * 1e3 for x in step_s],
           "median_step_ms": med_ms,
           "examples_per_s": TEXT_BATCH / (med_ms / 1e3),
           "profiled_step_ms": prof_ms}
    if rows:
        out.update({"launches_per_step": sum(r[1] for r in rows),
                    "device_busy_ms": device_ms,
                    "busy_share": device_ms / med_ms})
    log(tag + ": losses %s (first on the CPU %.6f); first step's dense "
        "grads card vs CPU worst %.3g of the largest magnitude (%s)"
        % (["%.4f" % x for x in losses], closs, worst, where))
    log(tag + ": %.1f examples/s, median step %.2f ms over %d steps "
        "(first %.2f ms), %s launches a step, device busy %s; the CPU step "
        "%.2f s"
        % (out["examples_per_s"], med_ms, TEXT_STEPS - 1, step_s[0] * 1e3,
           "%.0f" % out["launches_per_step"] if rows else "not measured",
           "%.2f ms = %.1f%% of the step" % (device_ms, 100 * device_ms
                                             / med_ms)
           if rows else "not measured", cpu_s))
    for us, c, k in rows[:6]:
        log(tag + " profile:   %10.1f us  %5d launches  %s"
            % (us, c, k[:90]))
    log(json.dumps({tag.replace(" ", "_"): out}))
    return out


def _mha_program(fluid):
    """q, k, v data [B, T, d] (gradients wanted), the attention, and
    sum(out * cot) with its gradients to q, k and v."""
    B, T, d, heads = MHA_SHAPE
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        qkv = []
        for name in ("q", "k", "v"):
            x = L.data(name, shape=[T, d], dtype="float32")
            x.stop_gradient = False
            qkv.append(x)
        cot = L.data("cot", shape=[T, d], dtype="float32")
        out = fluid.nets.scaled_dot_product_attention(*qkv, num_heads=heads)
        total = L.reduce_sum(L.elementwise_mul(out, cot))
        grads = fluid.gradients([total], qkv)
    return main, [out] + list(grads)


def phase_mha(torch, fluid):
    """nets.scaled_dot_product_attention forward and backward at MHA_SHAPE
    on the card against the CPU; the median ms of a call (forward and
    the three gradients, fetched) over MHA_RUNS."""
    main, fetch = _mha_program(fluid)
    B, T, d, _ = MHA_SHAPE
    rng = np.random.RandomState(23)
    feed = {n: rng.randn(B, T, d).astype(np.float32)
            for n in ("q", "k", "v", "cot")}
    cpu = [np.asarray(a) for a in fluid.Executor(fluid.CPUPlace()).run(
        main, feed=feed, fetch_list=fetch)]
    gpu = fluid.Executor(fluid.CUDAPlace(0))
    card = [np.asarray(a) for a in gpu.run(main, feed=feed,
                                           fetch_list=fetch)]
    names = ["out", "q@GRAD", "k@GRAD", "v@GRAD"]
    worst, where = _worst_spread(
        {n: np.asarray(v, np.float64) for n, v in zip(names, card)},
        {n: np.asarray(v, np.float64) for n, v in zip(names, cpu)})
    check(worst <= OP_RTOL, "mha: %s on the card lies %.3g of its largest "
          "magnitude from the CPU's" % (where, worst))
    staged = gpu._prepare_feeds(main, feed)
    times = []
    for _ in range(MHA_RUNS + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gpu.run(main, feed=staged, fetch_list=fetch, return_numpy=False)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = float(np.median(times[2:]))
    log("mha (B %d, T %d, d %d, %d heads): forward and gradients card vs "
        "CPU worst %.3g of the largest magnitude (%s); %.2f ms a call "
        "(median of %d, the feeds already on the card)"
        % (B, T, d, MHA_SHAPE[3], worst, where, ms, MHA_RUNS))
    log(json.dumps({"mha": {"shape": MHA_SHAPE, "worst_vs_cpu": worst,
                            "ms": ms, "ms_runs": times[2:]}}))
    return ms


def phase_core_ops(torch):
    """Every op case of tests/torch_op_cases.py's CORE_CASES but the
    sequence and recurrent families (phase_seq_ops runs those), forward
    and vjp, on the card against the CPU from the same inputs, then a
    sync that a device-side assert would fail."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    import torch_op_cases as cases
    worst, where, n = -np.inf, None, 0
    # the sequence and recurrent families are phase_seq_ops'
    seq = {c[0] for c in cases.SEQ_OP_CASES}
    core = [c for c in cases.CORE_CASES if c[0] not in seq]
    for case in core:
        bad, at = cases.max_mismatch(cases.run_case(case, "cuda"),
                                     cases.run_case(case, "cpu"),
                                     OP_RTOL, OP_ATOL)
        check(bad <= 0, "core ops: %s differs card vs CPU at %s (by %.3g "
              "past the tolerance)" % (case[0], at, bad))
        if bad > worst:
            worst, where = bad, case[0]
        n += 1
    torch.cuda.synchronize()
    log("core ops: %d cases (%d op types) forward and vjp equal card vs CPU "
        "within %g (closest to the limit: %s, %.3g under it); no "
        "device-side assert"
        % (n, len({c[1] for c in core}), OP_RTOL, where, -worst))
    return n


# ---------------------------------------------------------------------------
# 17. the text-classification GRU net, the sequence and recurrent ops
# ---------------------------------------------------------------------------

# gru_net at its widths (PaddlePaddle/models fluid/PaddleNLP/
# text_classification nets.py): dict, embedding, GRU hidden, second fc,
# classes; text conv's batches
TEXT_GRU = dict(dict_dim=5147, emb_dim=128, hid_dim=128, hid_dim2=96,
                class_dim=2)
TEXT_GRU_EMB_LR = 30.0
# the mid-size recurrent calls: lstmp (B, T, D, P), reverse gru (B, T, H)
SEQ_LSTMP = (32, 64, 1024, 512)
SEQ_GRU = (64, 128, 128)
SEQ_RUNS = 5


def text_gru_program(fluid):
    """gru_net -> (main, startup, loss)."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = TEXT_SEED
    w = TEXT_GRU
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        words = L.data("words", shape=[1], dtype="int64", lod_level=1)
        label = L.data("label", shape=[1], dtype="int64")
        emb = L.embedding(input=words, size=[w["dict_dim"], w["emb_dim"]],
                          param_attr=fluid.ParamAttr(
                              learning_rate=TEXT_GRU_EMB_LR))
        fc0 = L.fc(input=emb, size=w["hid_dim"] * 3)
        gru_h = L.dynamic_gru(input=fc0, size=w["hid_dim"])
        gru_max = L.sequence_pool(input=gru_h, pool_type="max")
        fc1 = L.fc(input=L.tanh(gru_max), size=w["hid_dim2"], act="tanh")
        prediction = L.fc(input=fc1, size=w["class_dim"], act="softmax")
        loss = L.mean(L.cross_entropy(input=prediction, label=label))
        fluid.optimizer.Adagrad(learning_rate=TEXT_LR).minimize(loss)
    return main, startup, loss


def phase_text_gru(torch, pk, fluid):
    """The GRU net at its widths (_text_train), every gradient dense (the
    table's too).  No hand kernel is on this path."""
    main, startup, loss = text_gru_program(fluid)
    types_ = [op.type for op in main.global_block().ops]
    check("gru" in types_ and "gru_grad" in types_,
          "text gru: the program lacks its gru or the gru's gradient")
    grads = [p.name + "@GRAD" for p in main.all_parameters()]
    return _text_train(torch, pk, fluid, "text gru", main, startup, loss,
                       grads)


def _seq_mid_cases():
    """The mid-size lstmp and reverse gru as op cases of
    tests/torch_op_cases.py, their inputs fixed arrays from a seed:
    weights at 1/sqrt(fan in), ragged lengths with one full row."""
    rng = np.random.RandomState(29)

    def arr(*shape, scale=1.0):
        return ("arr", (rng.randn(*shape) * scale).astype(np.float32))

    def lens(B, T):
        ln = rng.randint(1, T + 1, size=B).astype(np.int32)
        ln[0] = T
        return ("arr", ln)
    B, T, D, P = SEQ_LSTMP
    lstmp = ("lstmp_mid", "lstmp",
             {"Input": [arr(B, T, 4 * D)],
              "Weight": [arr(P, 4 * D, scale=P ** -0.5)],
              "ProjWeight": [arr(D, P, scale=D ** -0.5)],
              "Bias": [arr(1, 7 * D, scale=0.1)],
              "Input@LOD_LEN": [lens(B, T)]},
             {"use_peepholes": True, "is_reverse": False,
              "proj_activation": "tanh"})
    B, T, H = SEQ_GRU
    gru = ("gru_reverse_mid", "gru",
           {"Input": [arr(B, T, 3 * H)],
            "Weight": [arr(H, 3 * H, scale=H ** -0.5)],
            "Bias": [arr(1, 3 * H, scale=0.1)],
            "Input@LOD_LEN": [lens(B, T)]},
           {"is_reverse": True})
    return [lstmp, gru]


def _seq_call_ms(torch, cases, case, reps=SEQ_RUNS):
    """The median ms of the case's forward and vjp on the card (inputs
    already there, cotangents of ones), over `reps` calls."""
    from paddle_tpu_torch.ops import registry
    _, op_type, _, attrs = case
    inputs, _ = cases.case_inputs(case)
    op = cases.case_op(op_type, attrs, inputs)
    od = registry.get_op_def(op_type)
    dev = {s: [torch.from_numpy(a).cuda() for a in v]
           for s, v in inputs.items()}
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs, vjp = registry.make_forward_and_vjp(
            op, od, registry.ExecContext(op, dev, device="cuda"))
        vjp({s: [torch.ones_like(v) if v.is_floating_point() else None
                 for v in vals] for s, vals in outs.items()})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times[1:]))


def phase_seq_ops(torch):
    """Every case of SEQ_OP_CASES, forward and vjp, on the card against
    the CPU from the same inputs; then the mid-size lstmp and reverse
    gru within 1e-5 of each array's largest magnitude, and their ms a
    call."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    import torch_op_cases as cases
    worst, where = -np.inf, None
    for case in cases.SEQ_OP_CASES:
        bad, at = cases.max_mismatch(cases.run_case(case, "cuda"),
                                     cases.run_case(case, "cpu"),
                                     OP_RTOL, OP_ATOL)
        check(bad <= 0, "seq ops: %s differs card vs CPU at %s (by %.3g "
              "past the tolerance)" % (case[0], at, bad))
        if bad > worst:
            worst, where = bad, case[0]
    torch.cuda.synchronize()
    log("seq ops: %d cases (%d op types) forward and vjp equal card vs CPU "
        "within %g (closest to the limit: %s, %.3g under it)"
        % (len(cases.SEQ_OP_CASES),
           len({c[1] for c in cases.SEQ_OP_CASES}), OP_RTOL, where, -worst))
    out = {}
    for case in _seq_mid_cases():
        card, cpu = cases.run_case(case, "cuda"), cases.run_case(case, "cpu")
        spread, at = 0.0, None
        for part in (0, 1):
            for slot, vals in cpu[part].items():
                for i, want in enumerate(vals):
                    if want is None or want.dtype.kind != "f":
                        continue
                    got = np.asarray(card[part][slot][i], np.float64)
                    sp, _ = _worst_spread({"a": got},
                                          {"a": np.asarray(want,
                                                           np.float64)})
                    if at is None or sp > spread:
                        spread, at = sp, ("grad " if part else "") + slot
        check(spread <= OP_RTOL, "seq ops: %s's %s on the card lies %.3g of "
              "its largest magnitude from the CPU's" % (case[0], at, spread))
        ms = _seq_call_ms(torch, cases, case)
        out[case[0]] = {"worst_vs_cpu": spread, "worst_at": at, "ms": ms}
        log("seq ops: %s forward and vjp card vs CPU worst %.3g of the "
            "largest magnitude (%s); %.2f ms a call on the card (median of "
            "%d, the inputs already there)"
            % (case[0], spread, at, ms, SEQ_RUNS))
    log(json.dumps({"seq_ops": out}))
    return out


# the Fluid input and I/O surface: ResNet-50 training fed through the
# reader (bench.build's model at RT_BATCH), the nested encoder, the
# profiler
# passes over the 4 batches: a warm-up, then timed passes whose last
# step runs under torch.profiler
RR_PASSES = 3
RR_SPREAD_FACTOR = 4.0
RR_PREDICT_IMAGES = 64
NL_WIDTH = dict(vocab=32000, emb_dim=256, hid=256)
NL_BATCH = 32
NL_SENTS = (2, 16)
NL_WORDS = (4, 40)
NL_STEPS = 3
NL_LR = 0.01
NL_SEED = 19
NL_BEAM = 3
NL_TOL = 1e-6
PROF_ARGV = ["--model", "resnet", "--profile", "--batch_size", "32",
             "--layout", "NHWC", "--iterations", "2", "--skip_batch_num",
             "1"]
PROF_TIMEOUT_S = 300


def _rel_spread(a, b):
    """max |a - b| / |a| over two loss trajectories."""
    return max(abs(x - y) / abs(x) for x, y in zip(a, b))


def _resnet_on_reader(fluid, bench, resnet, path):
    """bench.build's ResNet-50 (get_model at RT_BATCH, NHWC, lr 0.1,
    Momentum 0.9, L2Decay 1e-4) built on the vars of an open_files
    reader over the RecordIO file `path`, with the double buffer on the
    card: (main, loss, reader).  Built under a fresh unique_name guard,
    so its parameters and optimizer state have the names of a guarded
    bench.build."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        hw = bench.IMAGE_HW
        reader = fluid.layers.double_buffer(fluid.layers.open_files(
            [path], shapes=[[-1, hw, hw, 3], [-1, 1]], lod_levels=[0, 0],
            dtypes=["float32", "int64"]), place=fluid.CUDAPlace(0))
        image, label = fluid.layers.read_file(reader)
        predict = resnet.resnet_imagenet(image, class_dim=1000, depth=50,
                                         is_train=True, layout="NHWC")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(
            input=predict, label=label))
        fluid.layers.accuracy(input=predict, label=label)
        fluid.optimizer.Momentum(
            learning_rate=0.1, momentum=0.9,
            regularization=fluid.regularizer.L2Decay(1e-4)).minimize(loss)
    return main, loss, reader


def _rr_lane(torch, fluid, exe, main, loss, init, label, passes,
             n_batches):
    """RR_PASSES passes of `passes(p)` (n_batches feeds each) through
    exe.run on a copy of the startup state: losses, images/s and the
    median step over the passes after the first but for the last step,
    which runs under torch.profiler and gives the device busy share (its
    kernels' device time over its wall time), and the final scope."""
    from torch.profiler import ProfilerActivity, profile
    scope = fluid.Scope()
    for n, v in init.items():
        scope.set(n, v.clone())
    losses, gaps = [], []
    busy = None
    t_lane = time.time()
    torch.cuda.synchronize()
    for p in range(RR_PASSES):
        feeds = passes(p)
        t = time.perf_counter()
        for i in range(n_batches):
            prof = None
            if p == RR_PASSES - 1 and i == n_batches - 1:
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.__enter__()
                t = time.perf_counter()
            feed = next(feeds)
            out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            losses.append(float(np.asarray(out).ravel()[0]))
            now = time.perf_counter()
            if prof is not None:
                prof.__exit__(None, None, None)
                device_ms, rows = profile_rows(torch, prof, 1)
                busy = device_ms / ((now - t) * 1e3) if rows else None
            elif p > 0:
                gaps.append(now - t)
            t = time.perf_counter()
        feeds.close()
    seconds = sum(gaps)
    out = {"label": label, "losses": losses,
           "images_per_s": RT_BATCH * len(gaps) / seconds,
           "median_step_ms": float(np.median(gaps)) * 1e3,
           "busy_share": busy, "seconds": time.time() - t_lane}
    log("reader resnet %s: %.1f images/s, median step %.2f ms (%d timed "
        "steps), device busy %s; %.1f s; losses %s" % (
            label, out["images_per_s"], out["median_step_ms"], len(gaps),
            "not measured (no device time seen)" if busy is None
            else "%.1f%% of the last step" % (100 * busy), out["seconds"],
            ["%.5f" % x for x in losses]))
    check(all(np.isfinite(losses)), "reader resnet %s: non-finite loss"
          % label)
    return out, scope


def _reader_pass(reader):
    """One pass of a PyReader as a Fluid user runs it."""
    def passes(_):
        reader.start()
        try:
            yield from reader
        finally:
            reader.reset()
    return passes


def _host_pass(batches):
    def passes(_):
        yield from batches
    return passes


def _rr_save_load(torch, fluid, exe, main, scope, tmp):
    """Every persistable of `main` from `scope` through an in-graph
    save_combine program, then back through load_combine into a fresh
    scope: bit for bit, and the file through numpy.load."""
    from paddle_tpu_torch.fluid.functionalizer import persistable_names
    names = sorted(n for n in persistable_names(main)
                   if scope.get(n) is not None)
    path = os.path.join(tmp, "persistables.npz")
    progs = []
    for op_type in ("save_combine", "load_combine"):
        prog = fluid.Program()
        gb = prog.global_block()
        for n in names:
            v = main.global_block().var(n)
            gb.create_var(name=n, shape=v.shape, dtype=v.dtype,
                          persistable=True)
        slots = ({"inputs": {"X": names}, "outputs": {}}
                 if op_type == "save_combine" else
                 {"inputs": {}, "outputs": {"Out": names}})
        gb.append_op(type=op_type, attrs={"file_path": path}, **slots)
        progs.append(prog)
    t0 = time.time()
    exe.run(progs[0], scope=scope)
    save_s = time.time() - t0
    fresh = fluid.Scope()
    t0 = time.time()
    exe.run(progs[1], scope=fresh)
    load_s = time.time() - t0
    nbytes = os.path.getsize(path)
    with np.load(path) as z:
        check(sorted(z.files) == sorted(n.replace("/", "__")
                                        for n in names),
              "save_combine: the file's keys are not the persistables")
        for n in names:
            a, b = scope.get(n), fresh.get(n)
            check(b is not None and b.device == a.device
                  and torch.equal(a, b),
                  "load_combine: %s differs from the saved value" % n)
            check(np.array_equal(z[n.replace("/", "__")],
                                 a.detach().cpu().numpy()),
                  "numpy.load: %s differs from the saved value" % n)
    log("reader resnet: save_combine of %d persistables (%.1f MB) in %.2f "
        "s, load_combine into a fresh scope in %.2f s: equal bit for bit, "
        "and through numpy.load" % (len(names), nbytes / 1e6, save_s,
                                    load_s))
    return len(names)


def _rr_predictor(torch, pk, fluid, tmp):
    """The fused fp32 Predictor (FUSE_GATE) on RR_PREDICT_IMAGES images
    written to a RecordIO file and read back through
    reader.creator.recordio, against the same images fed from memory:
    equal; K6's launches on the recordio-fed run."""
    from paddle_tpu_torch import inference, native, reader
    from paddle_tpu_torch.flags import FLAGS
    from paddle_tpu_torch.models import resnet
    art = os.path.join(tmp, "resnet50")
    t0 = time.time()
    build_resnet_artifact(torch, fluid, resnet, art, fluid.CUDAPlace(0))
    build_s = time.time() - t0
    images = _images(RR_PREDICT_IMAGES, RESNET_SEED + 1)
    path = os.path.join(tmp, "images.rio")
    with native.RecordIOWriter(path) as w:
        for im in images:
            w.write(native.serialize_tensor(im))
    t0 = time.time()
    batch = np.stack([native.deserialize_tensor(r)[0]
                      for r in reader.creator.recordio(path)()])
    read_s = time.time() - t0
    check(batch.shape == images.shape and np.array_equal(batch, images),
          "recordio: the images read back differ")
    t0 = time.time()
    FLAGS.fuse_bottleneck_max_width = FUSE_GATE
    try:
        pred = inference.create_paddle_predictor(
            inference.AnalysisConfig(model_dir=art))
    finally:
        FLAGS.fuse_bottleneck_max_width = 0
    want = pred.run([images])[0]
    first_s = time.time() - t0
    torch.cuda.synchronize()
    pk.reset_launch_counts()
    got = pred.run([batch])[0]
    torch.cuda.synchronize()
    launches = pk.launch_counts["fused_bottleneck"]
    check(launches > 0, "reader predictor: K6 did not launch")
    check(np.isfinite(got).all() and got.shape == (RR_PREDICT_IMAGES, 1000),
          "reader predictor: bad probabilities %s" % (got.shape,))
    check(np.array_equal(got, want), "reader predictor: the recordio-fed "
          "probabilities differ from the in-memory feed's by %.3g"
          % np.abs(got - want).max())
    log("reader predictor: the artifact saved in %.1f s, the Predictor "
        "made and run on the in-memory feed in %.1f s; %d images read back "
        "through reader.creator.recordio in %.2f s (%.1f MB); the fused "
        "fp32 Predictor launched K6 %d times and equals the in-memory feed "
        "bit for bit" % (build_s, first_s, RR_PREDICT_IMAGES, read_s,
                         os.path.getsize(path) / 1e6, launches))
    del pred
    return launches


def phase_reader_resnet(torch, pk, fluid):
    """ResNet-50 training fed through the reader lanes (module docstring,
    `reader`), the save/load round trip and the recordio-fed Predictor.
    Returns K6's launches on the recordio-fed Predictor."""
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.flags import FLAGS
    from paddle_tpu_torch.fluid import functionalizer
    from paddle_tpu_torch.models import resnet
    t0 = time.time()
    with fluid.unique_name.guard():
        main, loss, exe, scope0 = bench.build(RT_BATCH, "NHWC", "cuda",
                                              seed=RT_SEED)
    init = {n: scope0.get(n) for n in scope0.keys()}
    host = bench.staged_batches(RT_BATCH, "NHWC", "cpu")
    host = [{k: v.numpy() for k, v in b.items()} for b in host]
    staged = [{k: torch.from_numpy(v).cuda() for k, v in b.items()}
              for b in host]
    log("reader resnet: built ResNet-50 and ran startup, %d batches of %d "
        "in %.1f s" % (len(host), RT_BATCH, time.time() - t0))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "batches.rio")
        t0 = time.time()
        n = fluid.recordio_writer.convert_reader_to_recordio_file(
            path, lambda: ((b["data"], b["label"]) for b in host))
        write_s = time.time() - t0
        log("reader resnet: %d batches written to RecordIO in %.2f s (%.1f "
            "MB)" % (n, write_s, os.path.getsize(path) / 1e6))
        t0 = time.time()
        main_c, loss_c, reader_c = _resnet_on_reader(fluid, bench, resnet,
                                                     path)
        log("reader resnet: built the model on open_files' vars in %.1f s"
            % (time.time() - t0))
        check(set(functionalizer.persistable_names(main_c))
              == set(functionalizer.persistable_names(main)),
              "reader resnet: the open_files program's state differs from "
              "bench.build's")
        reader_b = fluid.layers.double_buffer(
            fluid.layers.create_py_reader_by_data(
                capacity=4, feed_list=[main.global_block().var("data"),
                                       main.global_block().var("label")]),
            place=fluid.CUDAPlace(0))
        reader_b.decorate_paddle_reader(
            lambda: ((b["data"], b["label"]) for b in host))
        lanes = [("(a) host feeds", main, loss, _host_pass(host)),
                 ("(a) host feeds again", main, loss, _host_pass(host)),
                 ("(b) py_reader double buffer", main, loss,
                  _reader_pass(reader_b)),
                 ("(c) open_files recordio", main_c, loss_c,
                  _reader_pass(reader_c)),
                 ("(d) staged on the card", main, loss,
                  _host_pass(staged))]
        fluid.set_amp(True)
        FLAGS.whole_graph_ad = True
        torch.backends.cudnn.deterministic = True
        try:
            for label, prog, lss, passes in lanes:
                out[label], scope = _rr_lane(torch, fluid, exe, prog, lss,
                                             init, label, passes, len(host))
                if label.startswith("(a) host feeds again"):
                    n_saved = _rr_save_load(torch, fluid, exe, main, scope,
                                            tmp)
                del scope
                torch.cuda.empty_cache()
        finally:
            torch.backends.cudnn.deterministic = False
            FLAGS.whole_graph_ad = False
            fluid.set_amp(False)
        a1 = out["(a) host feeds"]["losses"]
        spread_aa = _rel_spread(a1, out["(a) host feeds again"]["losses"])
        spreads = {k: _rel_spread(a1, v["losses"]) for k, v in out.items()
                   if not k.startswith("(a)")}
        for k, sp in spreads.items():
            check(sp <= RR_SPREAD_FACTOR * spread_aa,
                  "reader resnet %s: losses %.3g from (a)'s, beyond %g x "
                  "(a)'s own run-to-run spread %.3g"
                  % (k, sp, RR_SPREAD_FACTOR, spread_aa))
        timings = {"(b)": reader_b.timings, "(c)": reader_c.timings}
        for k, tm in timings.items():
            log("reader resnet %s: the reader thread read (decode, convert) "
                "a batch in %.2f ms and staged it in %.2f ms (medians of the "
                "last pass's %d batches)"
                % (k, float(np.median([r for r, _ in tm])),
                   float(np.median([s for _, s in tm])), len(tm)))
        log("reader resnet: (a)'s run-to-run loss spread %.3g; (b), (c), "
            "(d) against (a): %s" % (spread_aa, {k: "%.3g" % v for k, v
                                                 in spreads.items()}))
        del init, staged, scope0
        torch.cuda.empty_cache()
        k6 = _rr_predictor(torch, pk, fluid, tmp)
    log(json.dumps({"reader_resnet": {
        "lanes": {k: {kk: v[kk] for kk in ("images_per_s", "median_step_ms",
                                           "busy_share", "seconds")}
                  for k, v in out.items()},
        "spread_aa": spread_aa, "spreads": spreads,
        "reader_ms": {k: [float(np.median([r for r, _ in tm])),
                          float(np.median([s for _, s in tm]))]
                      for k, tm in timings.items()},
        "persistables_saved": n_saved, "k6_launches": k6}}))
    torch.cuda.empty_cache()
    return k6


def _nested_run(fluid, main, fetch, init, feeds, place):
    """The fetches of each feed on `place` from the startup state."""
    scope = fluid.scope_from_jax(init, fluid.Scope(), place)
    exe = fluid.Executor(place)
    return [exe.run(main, feed=f, fetch_list=fetch, scope=scope)
            for f in feeds]


def _nested_agree(what, cpu, card):
    """The worst spread of the card's fetches from the CPU's, as a share
    of each array's largest magnitude; a LoDTensor's LoD must be
    equal."""
    worst, at = 0.0, None
    for name, (a, b) in enumerate(zip(cpu, card)):
        if hasattr(a, "lod"):
            check(hasattr(b, "lod") and a.lod() == b.lod(),
                  "%s: fetch %d's LoD differs card vs CPU" % (what, name))
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        check(a.shape == b.shape, "%s: fetch %d's shape differs"
              % (what, name))
        sp = float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)) \
            if a.size else 0.0
        check(sp <= NL_TOL, "%s: fetch %d on the card lies %.3g of its "
              "largest magnitude from the CPU's" % (what, name, sp))
        if sp >= worst:
            worst, at = sp, name
    return worst, at


def phase_nested_lod(torch, fluid):
    """The hierarchical document encoder and the nested selection at
    NL_WIDTH (module docstring, `nested`)."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    import torch_nested_cases as nc
    main, startup, loss = nc.doc_encoder_program(fluid, lr=NL_LR,
                                                 **NL_WIDTH)
    grads = [p.name + "@GRAD" for p in main.all_parameters()]
    init_scope = fluid.Scope()
    with fluid.scope_guard(init_scope):
        fluid.Executor(fluid.CPUPlace()).run(startup)
    init = {n: init_scope.get(n).numpy() for n in init_scope.keys()}
    rng = np.random.RandomState(NL_SEED)
    feeds = [nc.doc_batch(fluid, rng, NL_BATCH, NL_SENTS, NL_WORDS,
                          NL_WIDTH["vocab"]) for _ in range(NL_STEPS)]
    lod = feeds[0]["words"].recursive_sequence_lengths()
    t0 = time.time()
    cpu = _nested_run(fluid, main, [loss] + grads, init, feeds[:1],
                      fluid.CPUPlace())[0]
    cpu_s = time.time() - t0
    torch.cuda.synchronize()
    t0 = time.time()
    card = _nested_run(fluid, main, [loss] + grads, init, feeds,
                       fluid.CUDAPlace(0))
    torch.cuda.synchronize()
    card_s = time.time() - t0
    worst, at = _nested_agree("nested encoder", cpu, card[0])
    losses = [float(np.asarray(c[0]).ravel()[0]) for c in card]
    check(all(np.isfinite(losses)), "nested encoder: non-finite loss %s"
          % losses)
    emb = np.asarray(card[0][1 + grads.index("embedding_0.w_0@GRAD")])
    check(np.abs(emb).max() > 0, "nested encoder: no embedding gradient")
    log("nested encoder: %d documents, %d sentences of %d-%d words; %d "
        "steps on the card in %.2f s (the first step on the CPU %.2f s), "
        "losses %s; first step card vs CPU: the loss and %d gradients (the "
        "embedding's through nested_to_outer_grad) within %.3g of each "
        "one's largest magnitude (tolerance %g; the closest: %s)"
        % (NL_BATCH, len(lod[1]), min(lod[1]), max(lod[1]), NL_STEPS,
           card_s, cpu_s, ["%.5f" % x for x in losses], len(grads), worst,
           NL_TOL, (["loss"] + grads)[at]))
    main, startup, fetch = nc.selection_program(
        fluid, NL_WIDTH["vocab"], NL_WIDTH["emb_dim"], NL_BEAM)
    init_scope = fluid.Scope()
    with fluid.scope_guard(init_scope):
        fluid.Executor(fluid.CPUPlace()).run(startup)
    init = {n: init_scope.get(n).numpy() for n in init_scope.keys()}
    feed = nc.doc_batch(fluid, np.random.RandomState(NL_SEED + 1),
                        NL_BATCH, NL_SENTS, NL_WORDS, NL_WIDTH["vocab"],
                        titled=True)
    feed.pop("label")
    n_sents = len(feed["words"].recursive_sequence_lengths()[1])
    cpu = _nested_run(fluid, main, fetch, init, [feed], fluid.CPUPlace())[0]
    card = _nested_run(fluid, main, fetch, init, [feed],
                       fluid.CUDAPlace(0))[0]
    worst_sel, _ = _nested_agree("nested selection", cpu, card)
    sel, exp = card
    log("nested selection: kmax_seq_score (beam %d) -> sub_nested_seq kept "
        "%d of %d sentences, sequence_expand repeated %d titles to %d rows "
        "by the nested counts; card = CPU (LoDs equal, values within "
        "%.3g)" % (NL_BEAM, len(sel.recursive_sequence_lengths()[1]),
                   n_sents, NL_BATCH,
                   len(exp.recursive_sequence_lengths()[0]), worst_sel))
    log(json.dumps({"nested_lod": {"losses": losses, "worst_vs_cpu": worst,
                                   "selection_worst_vs_cpu": worst_sel,
                                   "card_s": card_s}}))


def phase_profiler(torch):
    """`fluid_benchmark --model resnet --profile` in a temporary
    directory (module docstring, `profiler`)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.fluid_benchmark"]
            + PROF_ARGV, cwd=tmp, env=env, capture_output=True, text=True,
            timeout=PROF_TIMEOUT_S)
        secs = time.time() - t0
        check(proc.returncode == 0, "profiler: fluid_benchmark --profile "
              "failed:\n%s" % proc.stderr[-3000:])
        lines = proc.stdout.strip().splitlines()
        record = json.loads(lines[-1])
        prof = record["profile"]
        table = open(os.path.join(tmp, prof["table"])).read().splitlines()
        host = [ln for ln in table if ln.startswith("fluid_benchmark/")]
        kernels = [ln for ln in table if ln.startswith("cuda::")]
        check(len(host) == 2 and kernels,
              "profiler: the table lacks the host events or the CUDA "
              "kernel rows:\n%s" % "\n".join(table[:20]))
        with open(os.path.join(tmp, prof["trace"])) as f:
            trace = json.load(f)
        check(isinstance(trace.get("traceEvents"), list)
              and trace["traceEvents"],
              "profiler: the exported trace has no traceEvents")
    log("profiler: fluid_benchmark %s ran in %.1f s: %.1f images/s; the "
        "table has %d host and %d CUDA rows, the trace %d events; top "
        "rows:\n%s" % (" ".join(PROF_ARGV), secs,
                       record["examples_per_sec"], len(host),
                       len(kernels), len(trace["traceEvents"]),
                       "\n".join(table[3:10])))
    return record


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available on this host",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.inference import decode
    from paddle_tpu_torch.models import resnet, transformer
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import pallas_kernels as pk
    from paddle_tpu_torch.serving import batcher

    log("torch %s, CUDA %s, python %s" % (torch.__version__,
                                         torch.version.cuda,
                                         sys.version.split()[0]))
    # 1. build
    t0 = t_main = time.time()
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
    phase_sass(_build)
    # 2. kernels against their plain versions, with the coverage cases
    # (head dims and channel edges off the instantiated widths, each a
    # row of its own)
    t_phase = time.time()
    cover_entries = []
    entry = phase_kernels(torch, pk, cover_entries)
    k4_entry, k4hs_entry = phase_int8_kernels(torch, pk, cover_entries)
    flash_entries = phase_flash_kernels(torch, pk, cover_entries)
    flash_bf16_entries = phase_flash_kernels(torch, pk, cover_entries,
                                             torch.bfloat16)
    k5_entry = phase_dequant_kernel(torch, pk)
    k6_entry = phase_bottleneck_kernel(torch, pk, cover_entries)
    k6_bf16_entry = phase_bottleneck_kernel(torch, pk, cover_entries,
                                            torch.bfloat16)
    torch.cuda.empty_cache()
    log("kernel phases: %.1f s" % (time.time() - t_phase))
    # 3. the decode-serving slice at full width
    t_phase = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        art = os.path.join(tmp, "lm")
        t0 = time.time()
        decode.build_tiny_decode_model(art, **FULL_WIDTH)
        log("slice: built the full-width artifact in %.2f s"
            % (time.time() - t0))
        pred, plain_counts, plain = phase_slice(torch, pk, decode, batcher,
                                                art)
        profiles = {"fp32": phase_profile(torch, pred)}
        # 3b. the int8 KV cache, 3c. speculative decoding with its twin
        pred8, int8_counts, int8_outs, profiles["int8"] = phase_int8_lane(
            torch, pk, decode, batcher, art, plain)
        k3_spec, k4_spec, hs_spec, profiles["spec"] = phase_spec_lane(
            torch, pk, decode, batcher, art, pred, pred8, plain)
        log("decode phases before fused: %.1f s" % (time.time() - t_phase))
        # 3d. fused N-step decode: the three lanes again, in CUDA graphs
        t_phase = time.time()
        k3_fused, k4_fused = phase_fused(torch, pk, decode, batcher, art,
                                         pred, pred8, plain, int8_outs,
                                         profiles)
        log("fused phase: %.1f s" % (time.time() - t_phase))
        t_phase = time.time()
        launches = plain_counts["decode_attention"]
        k4_launches = int8_counts["decode_attention_int8"]
        entry["launches"] = launches + k3_spec + k3_fused
        k4_entry["launches"] = k4_launches + k4_spec + k4_fused
        # no one-card path runs the head-slice entry (its caller is the
        # tensor-parallel lane): the serving runs above must count none
        k4hs_entry["launches"] = (
            plain_counts["decode_attention_head_slice"]
            + int8_counts["decode_attention_head_slice"] + hs_spec)
        check(k4hs_entry["launches"] == 0,
              "the head-slice entry launched %d times on a one-card path"
              % k4hs_entry["launches"])
        log("launches on the main paths: K3 %d (fp32 lane %d, spec verify "
            "%d, fused lanes %d), K4 %d (int8 lane %d, spec drafts %d, fused "
            "lanes %d), K4 head slice %d"
            % (entry["launches"], launches, k3_spec, k3_fused,
               k4_entry["launches"], k4_launches, k4_spec, k4_fused,
               k4hs_entry["launches"]))
        # 4. the port on the card against the port on the CPU
        phase_gpu_vs_cpu(torch, decode, art, pred)
        phase_int8_gpu_vs_cpu(torch, decode, art, pred8)
    del pred, pred8
    torch.cuda.empty_cache()
    log("decode phases after fused: %.1f s" % (time.time() - t_phase))
    # 5. the training slice at full width, 5b. under bf16 AMP, 6. on the
    # card vs the CPU
    t_phase = time.time()
    counts = phase_train(torch, pk, fluid, transformer)
    for e in flash_entries:
        e["launches"] = counts[e["name"]]
    torch.cuda.empty_cache()
    counts = phase_train(torch, pk, fluid, transformer, amp=True)
    for e in flash_bf16_entries:
        e["launches"] = counts[e["name"]]
    phase_train_gpu_vs_cpu(torch, fluid, transformer)
    torch.cuda.empty_cache()
    log("training phases: %.1f s" % (time.time() - t_phase))
    # 6b. the Fluid training runtime: the Trainer, sync and in flight
    t_phase = time.time()
    phase_trainer(torch, pk, fluid, transformer)
    torch.cuda.empty_cache()
    log("trainer phase: %.1f s" % (time.time() - t_phase))
    # 6c. the user paths at the coverage head dims
    t_phase = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        cover_launches = phase_coverage_paths(torch, pk, fluid, transformer,
                                              decode, tmp)
    torch.cuda.empty_cache()
    log("coverage paths phase: %.1f s" % (time.time() - t_phase))
    # 6d. the update region: noam + global-norm clipping at full width
    # (fp32, AMP), then sparse embedding grads under every optimizer
    t_phase = time.time()
    phase_noam_clip_train(torch, pk, fluid, transformer)
    torch.cuda.empty_cache()
    phase_noam_clip_train(torch, pk, fluid, transformer, amp=True)
    torch.cuda.empty_cache()
    log("noam clip phases: %.1f s" % (time.time() - t_phase))
    t_phase = time.time()
    phase_sparse_embedding(torch, fluid)
    torch.cuda.empty_cache()
    log("sparse embedding phase: %.1f s" % (time.time() - t_phase))
    t_phase = time.time()
    # 7. ResNet-50 inference: fp32 fused / unfused and int8, 7b. bf16
    # fused / unfused, 8. gpu vs cpu in fp32 and bf16
    with tempfile.TemporaryDirectory() as tmp:
        k6_entry["launches"], k5_entry["launches"], fp32_probs = \
            phase_resnet(torch, pk, fluid, resnet, inference, tmp)
        torch.cuda.empty_cache()
        k6_bf16_entry["launches"] = phase_resnet_bf16(
            torch, pk, fluid, os.path.join(tmp, "resnet50"), fp32_probs)
        torch.cuda.empty_cache()
        phase_resnet_gpu_vs_cpu(torch, fluid, resnet, inference, tmp)
        phase_resnet_bf16_gpu_vs_cpu(torch, fluid, tmp)
        log("resnet phases: %.1f s" % (time.time() - t_phase))
        # 8b. the serving front end over the wire, on this phase's
        # artifacts
        served = phase_serving(torch, pk, inference, decode, tmp, plain,
                               int8_outs)
    for e in ([entry] + flash_entries + flash_bf16_entries
              + [k5_entry, k6_entry, k6_bf16_entry, k4_entry, k4hs_entry]):
        e["server_launches"] = 0
    entry["server_launches"] = served["decode_attention"]
    k4_entry["server_launches"] = served["decode_attention_int8"]
    k5_entry["server_launches"] = served["dequant_matmul"]
    k6_entry["server_launches"] = served["fused_bottleneck"]
    # 9. ResNet-50 training at the bench's shapes, four lanes and remat;
    # 10. a small bottleneck ResNet's training steps on the card vs the CPU
    t_phase = time.time()
    phase_resnet_train(torch, pk, fluid)
    phase_resnet_train_gpu_vs_cpu(torch, fluid)
    log("resnet train phases: %.1f s" % (time.time() - t_phase))
    # 11. the benchmark/fluid zoo at its published cells, 12. small zoo
    # models on the card vs the CPU
    t_phase = time.time()
    phase_zoo_train(torch, pk, fluid)
    torch.cuda.empty_cache()
    phase_zoo_gpu_vs_cpu(torch, fluid)
    log("zoo phases: %.1f s" % (time.time() - t_phase))
    # 12b. fluid_benchmark's ResNet-50 with a host stall, pipelined or not
    t_phase = time.time()
    phase_pipeline_bench(torch, fluid)
    torch.cuda.empty_cache()
    log("pipeline phase: %.1f s" % (time.time() - t_phase))
    # 14. control flow on the card against the CPU
    t_phase = time.time()
    phase_control_flow(torch, fluid)
    log("control flow phase: %.1f s" % (time.time() - t_phase))
    # 15. machine translation: training at the tool's cell, generation
    t_phase = time.time()
    mt_scope = phase_mt_train(torch, pk, fluid)
    log("mt train phase: %.1f s" % (time.time() - t_phase))
    t_phase = time.time()
    phase_mt_generate(torch, fluid, mt_scope)
    del mt_scope
    torch.cuda.empty_cache()
    log("mt generate phase: %.1f s" % (time.time() - t_phase))
    # 13. data-parallel ResNet-50 training, one NCCL rank per card
    t_phase = time.time()
    phase_parallel(torch, fluid)
    log("parallel phase: %.1f s" % (time.time() - t_phase))
    # 16. the book's text conv net, multi-head attention, the core ops
    t_phase = time.time()
    phase_text_conv(torch, pk, fluid)
    torch.cuda.empty_cache()
    log("text conv phase: %.1f s" % (time.time() - t_phase))
    t_phase = time.time()
    phase_mha(torch, fluid)
    torch.cuda.empty_cache()
    log("mha phase: %.1f s" % (time.time() - t_phase))
    t_phase = time.time()
    phase_core_ops(torch)
    log("core ops phase: %.1f s" % (time.time() - t_phase))
    # 17. the text-classification GRU net, the sequence and recurrent ops
    t_phase = time.time()
    phase_text_gru(torch, pk, fluid)
    torch.cuda.empty_cache()
    log("text gru phase: %.1f s" % (time.time() - t_phase))
    t_phase = time.time()
    phase_seq_ops(torch)
    torch.cuda.empty_cache()
    log("seq ops phase: %.1f s" % (time.time() - t_phase))
    # 18. the Fluid input and I/O surface: ResNet-50 through the reader,
    # the nested encoder, the profiler
    t_phase = time.time()
    k6_entry["reader_launches"] = phase_reader_resnet(torch, pk, fluid)
    k6_entry["launches"] += k6_entry["reader_launches"]
    log("reader resnet phase: %.1f s" % (time.time() - t_phase))
    t_phase = time.time()
    phase_nested_lod(torch, fluid)
    torch.cuda.empty_cache()
    log("nested lod phase: %.1f s" % (time.time() - t_phase))
    t_phase = time.time()
    phase_profiler(torch)
    log("profiler phase: %.1f s; the whole script %.1f s"
        % (time.time() - t_phase, time.time() - t_main))
    # the coverage cases' launches: the count of its kernel on the path
    # at its head dim (no path runs K6-bf16 at a ragged channel edge)
    for e in cover_entries:
        path, count = e.pop("path"), e.pop("count")
        e["launches"] = cover_launches.get(path, {}).get(count, 0)
        e["server_launches"] = 0
    log(smi)
    log(json.dumps({"kernels": [entry] + flash_entries + flash_bf16_entries
                    + [k5_entry, k6_entry, k6_bf16_entry, k4_entry,
                       k4hs_entry] + cover_entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        sys.exit(parallel_rank(sys.argv[2]))
    sys.exit(main())
