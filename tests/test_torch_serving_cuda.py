"""The port's serving front end on the card: a server on cuda:0 answers
ResNet replies bit-equal to a direct Predictor.run at the same bucket
(K6 through the server), and fp32 (K3) and int8 (K4) KV streams equal to
direct decode there.  Card-only: every test is marked `cuda` and skips
without a GPU; the comparisons are within the port (its direct paths),
so this file imports no JAX."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import fluid
from paddle_tpu_torch import serving
from paddle_tpu_torch.flags import FLAGS
from paddle_tpu_torch.inference import AnalysisConfig, Predictor
from paddle_tpu_torch.inference import decode

PROMPTS = [[3, 1, 4], [1, 5, 9, 2, 6], [5, 3], [5, 8, 9, 7, 9, 3],
           [2, 3, 8, 4]]
MAX_NEW = [7, 12, 3, 9, 12]


@pytest.fixture
def card():
    """The kernels built and a long socket timeout: a load warms every
    bucket, and on a fresh machine the first kernel call builds them
    with nvcc, longer than a client waits by default."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import pallas_kernels as pk
    _build.build_all()
    old = FLAGS.rpc_deadline
    FLAGS.rpc_deadline = 300.0
    srv = serving.InferenceServer("127.0.0.1:0", replicas="cuda:0").start()
    cli = serving.ServingClient(srv.endpoint)
    yield cli, pk
    cli.close()
    srv.shutdown()
    FLAGS.rpc_deadline = old


@pytest.mark.cuda
def test_cuda_server_k6_replies_bit_equal_to_direct(card, tmp_path):
    cli, pk = card
    from paddle_tpu_torch.models import resnet
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[32, 32, 3], dtype="float32")
        pred = resnet.resnet_imagenet(x, class_dim=10, depth=50,
                                      is_train=False, layout="NHWC")
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(str(tmp_path / "r"), ["x"], [pred],
                                      exe, main)
    old = FLAGS.fuse_bottleneck_max_width
    FLAGS.fuse_bottleneck_max_width = 128
    try:
        cli.load_model("r", str(tmp_path / "r"), buckets=[1, 8])
        cfg = AnalysisConfig(str(tmp_path / "r"), device="cuda:0")
        cfg.batch_size_buckets = (1, 8)
        direct = Predictor(cfg)
    finally:
        FLAGS.fuse_bottleneck_max_width = old
    imgs = np.random.RandomState(0).randn(3, 32, 32, 3).astype(np.float32)
    pk.reset_launch_counts()
    served = cli.infer("r", {"x": imgs})[0]
    assert pk.launch_counts["fused_bottleneck"] > 0
    np.testing.assert_array_equal(served, direct.run({"x": imgs})[0])


@pytest.mark.cuda
def test_cuda_server_streams_equal_direct_decode(card, tmp_path):
    cli, pk = card
    art = str(tmp_path / "lm")
    decode.build_tiny_decode_model(art, vocab_size=32, d_model=16,
                                   n_heads=2, n_layers=2, max_seq_len=64,
                                   eos_id=-1, seed=7)
    for kv, key in (("float32", "decode_attention"),
                    ("int8", "decode_attention_int8")):
        cli.load_model("lm-" + kv, art, decode_slots=4, fuse_steps=4,
                       kv_cache_dtype=kv)
        direct = decode.GenerativePredictor(art, device="cuda:0",
                                            kv_cache_dtype=kv)
        pk.reset_launch_counts()
        streams = [[t for c in cli.infer_stream("lm-" + kv, p,
                                                max_new_tokens=n)
                    for t in c] for p, n in zip(PROMPTS, MAX_NEW)]
        assert streams == [decode.greedy_decode(direct, p, n)[0]
                           for p, n in zip(PROMPTS, MAX_NEW)]
        assert pk.launch_counts[key] > 0
