"""Head-dim and channel coverage of the card's kernels: every shape the
JAX kernel functions take runs a hand kernel on the card.

K1/K2 take any head dim D <= 256 by zero-padding q, k, v (and do) to the
next instantiated width (64, 128 or 256) with the original D's scale, then
slicing o, dq, dk and dv back (`pad_head_dim_call`); K6-bf16 takes any C,
F and C4 by zero-padding the channel edge to a multiple of 8
(`pad_channels_call`).  On the CPU those paths are held against the
unpadded plain versions (pad -> plain -> slice equals plain), and the
plain versions against the JAX package at the new shapes; K3/K4 read a
head dim between the template widths in place (csrc/decode_attention.cu,
kRagged), held against the plain version on the card.  Tests marked
`cuda` hold each new shape's kernel against its plain version there."""

import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_kernels as jkernels
from paddle_tpu_torch.ops import pallas_kernels as tkernels

RTOL, ATOL = 1e-5, 1e-6


def _qkv(B, S, H, D, seed, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(B, S, H, D).astype(np.float32))
            .to(dtype) for _ in range(4)]


@pytest.mark.parametrize("D", [32, 96])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_fwd_pad_and_slice_equals_plain(D, causal):
    q, k, v, _ = _qkv(2, 24, 2, D, seed=D + causal)
    scale = 1.0 / np.sqrt(D)
    width = tkernels._flash_width(D)
    assert width == (64 if D <= 64 else 128)
    o, lse = tkernels.pad_head_dim_call(
        tkernels.flash_attention_fwd_reference, width, (q, k, v), causal,
        scale)
    o_ref, lse_ref = tkernels.flash_attention_fwd_reference(
        q, k, v, causal, scale)
    assert o.shape == q.shape and lse.shape == lse_ref.shape
    torch.testing.assert_close(o, o_ref, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(lse, lse_ref, rtol=RTOL, atol=ATOL)
    # and the plain version against the JAX kernel at this head dim
    jo = np.asarray(jkernels.flash_attention(
        q.numpy(), k.numpy(), v.numpy(), causal=causal, interpret=True))
    np.testing.assert_allclose(o_ref.numpy(), jo, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("D", [32, 96])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_pad_and_slice_equals_plain(D, dtype):
    q, k, v, do = _qkv(1, 20, 2, D, seed=3 * D, dtype=dtype)
    scale = 1.0 / np.sqrt(D)
    width = tkernels._flash_width(D)
    o, lse = tkernels.flash_attention_fwd_reference(q, k, v, True, scale)
    di = tkernels._flash_di(o, do)
    dq = tkernels.pad_head_dim_call(
        tkernels.flash_attention_bwd_dq_reference, width, (q, k, v, do),
        lse, di, True, scale)
    dk, dv = tkernels.pad_head_dim_call(
        tkernels.flash_attention_bwd_dkv_reference, width, (q, k, v, do),
        lse, di, True, scale)
    want_dq = tkernels.flash_attention_bwd_dq_reference(
        q, k, v, do, lse, di, True, scale)
    want_dk, want_dv = tkernels.flash_attention_bwd_dkv_reference(
        q, k, v, do, lse, di, True, scale)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.shape == q.shape and got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), rtol=RTOL,
                                   atol=ATOL)


def test_flash_width_refuses_past_128_naming_the_roadmap():
    """Up to 128 a head dim runs at 64 or 128; from 129 to 256 at the 256
    instantiation (32-row tiles); past 256 the width is refused, naming
    the ROADMAP item that keeps it."""
    assert tkernels._flash_width(1) == 64
    assert tkernels._flash_width(128) == 128
    assert tkernels._flash_width(160) == 256
    with pytest.raises(ValueError, match="ROADMAP.md queue 2"):
        tkernels._flash_width(257)


def _bottleneck(rng, C, F, C4, branch, dtype):
    t = lambda *s: torch.from_numpy(
        rng.randn(*s).astype(np.float32) * 0.1).to(dtype)
    x = torch.from_numpy(rng.randn(2, 7, 7, C).astype(np.float32)).to(dtype)
    args = [t(F, C, 1, 1), t(F), t(F, F, 3, 3), t(F), t(C4, F, 1, 1), t(C4)]
    args += [t(C4, C, 1, 1), t(C4)] if branch else [None, None]
    return x, args


@pytest.mark.parametrize("C,F,C4,stride,branch", [
    (60, 20, 84, 2, True), (12, 12, 12, 1, False), (20, 9, 36, 1, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bottleneck_pad_and_slice_equals_plain(C, F, C4, stride, branch,
                                               dtype):
    x, args = _bottleneck(np.random.RandomState(C + F), C, F, C4, branch,
                          dtype)
    got = tkernels.pad_channels_call(tkernels.bottleneck_reference, x,
                                     *args, stride)
    want = tkernels.bottleneck_reference(x, *args, stride)
    assert got.shape == want.shape and got.dtype == dtype
    assert got.is_contiguous()
    torch.testing.assert_close(got.float(), want.float(), rtol=RTOL,
                               atol=ATOL)


def test_bottleneck_weights_pad_once_per_tensor():
    """A weight is padded once and reused until it changes in place."""
    w = torch.randn(20, 12, 1, 1)
    a = tkernels._padded_once(w, (24, 16, 1, 1))
    assert tkernels._padded_once(w, (24, 16, 1, 1)) is a
    assert torch.equal(a[:20, :12], w) and not a[20:].any() \
        and not a[:, 12:].any()
    w.add_(1.0)
    b = tkernels._padded_once(w, (24, 16, 1, 1))
    assert b is not a and torch.equal(b[:20, :12], w)
    assert tkernels._padded_once(w, tuple(w.shape)) is w


@pytest.mark.parametrize("D", [48, 96, 6, 50, 126])
def test_decode_plain_version_matches_jax_at_new_head_dims(D):
    rng = np.random.RandomState(D)
    N, S, H = 3, 40, 2
    q = rng.randn(N, H, D).astype(np.float32)
    k = rng.randn(N, S, H, D).astype(np.float32)
    v = rng.randn(N, S, H, D).astype(np.float32)
    lengths = np.array([0, 17, S], np.int32)
    want = np.asarray(jkernels.decode_attention_reference(q, k, v,
                                                          lengths))
    got = tkernels.decode_attention(*[torch.from_numpy(a) for a in
                                      (q, k, v, lengths)]).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 96])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_at_new_head_dims_matches_plain(D, dtype):
    _need_cuda()
    q, k, v, do = [t.cuda() for t in _qkv(2, 130, 2, D, seed=D,
                                          dtype=dtype)]
    before = dict(tkernels.launch_counts)
    o, lse = tkernels.flash_attention_fwd(q, k, v, causal=True)
    di = tkernels._flash_di(o, do)
    dq = tkernels.flash_attention_bwd_dq(q, k, v, do, lse, di, True)
    dk, dv = tkernels.flash_attention_bwd_dkv(q, k, v, do, lse, di, True)
    suffix = "" if dtype == torch.float32 else "_bf16"
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert tkernels.launch_counts[name + suffix] == \
            before[name + suffix] + 1
    cpu = [t.cpu() for t in (q, k, v, do)]
    o_ref, lse_ref = tkernels.flash_attention_fwd_reference(*cpu[:3], True)
    di_ref = tkernels._flash_di(o_ref, cpu[3])
    dq_ref = tkernels.flash_attention_bwd_dq_reference(
        *cpu, lse_ref, di_ref, True)
    dk_ref, dv_ref = tkernels.flash_attention_bwd_dkv_reference(
        *cpu, lse_ref, di_ref, True)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 \
        else dict(rtol=2e-2, atol=2e-2)
    for got, want in ((o, o_ref), (dq, dq_ref), (dk, dk_ref),
                      (dv, dv_ref)):
        assert got.shape == q.shape
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   **tol)


@pytest.mark.cuda
# 6, 50 and 126 are not multiples of the 4- (fp32) and 16-element (int8)
# loads: a lane straddles the head dim's end and rows are read element by
# element
@pytest.mark.parametrize("D", [48, 96, 20, 6, 50, 126])
@pytest.mark.parametrize("quant", [False, True])
def test_cuda_decode_at_new_head_dims_matches_plain(D, quant):
    _need_cuda()
    rng = np.random.RandomState(D + quant)
    N, S, H = 4, 300, 3
    q = torch.from_numpy(rng.randn(N, H, D).astype(np.float32))
    if quant:
        k = torch.from_numpy(rng.randint(-127, 128, (N, S, H, D))
                             .astype(np.int8))
        v = torch.from_numpy(rng.randint(-127, 128, (N, S, H, D))
                             .astype(np.int8))
        sc = torch.from_numpy(rng.rand(2, H).astype(np.float32) * 0.02)
    else:
        k = torch.from_numpy(rng.randn(N, S, H, D).astype(np.float32))
        v = torch.from_numpy(rng.randn(N, S, H, D).astype(np.float32))
        sc = None
    lengths = torch.tensor([0, 1, 150, S], dtype=torch.int32)
    name = "decode_attention_int8" if quant else "decode_attention"
    before = tkernels.launch_counts[name]
    got = tkernels.decode_attention(
        q.cuda(), k.cuda(), v.cuda(), lengths.cuda(),
        kv_scales=None if sc is None else sc.cuda())
    assert tkernels.launch_counts[name] == before + 1
    want = tkernels.decode_attention_reference(q, k, v, lengths,
                                               kv_scales=sc)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("C,F,C4,stride,branch", [
    (60, 20, 84, 2, True), (12, 12, 12, 1, False)])
def test_cuda_bf16_bottleneck_at_ragged_channels_matches_plain(
        C, F, C4, stride, branch):
    _need_cuda()
    x, args = _bottleneck(np.random.RandomState(C), C, F, C4, branch,
                          torch.bfloat16)
    before = tkernels.launch_counts["fused_bottleneck_bf16"]
    got = tkernels.fused_bottleneck(
        x.cuda(), *[None if a is None else a.cuda() for a in args],
        stride=stride)
    assert tkernels.launch_counts["fused_bottleneck_bf16"] == before + 1
    want = tkernels.bottleneck_reference(x, *args, stride)
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=2e-2,
                               atol=2e-2)
