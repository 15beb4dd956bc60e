"""Head dims above 128 on the card's attention kernels: K1/K2 take any D up
to 256 (a 32-row tile instantiation at 256, its warps in pairs over the
columns; D between 128 and 256 runs zero-padded to it), K3/K4 any D up to
256 (VEC 8 at the 256 template, a runtime D below it read in place).

On the CPU the plain versions are held against the JAX package at D 192
and 256 (the JAX flash kernel in interpret mode), and the pad-and-slice
path against the unpadded plain version.  Tests marked `cuda` hold each
new instantiation against its plain version on the card."""

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


def test_flash_width_takes_up_to_256():
    assert tkernels._FLASH_HEAD_DIMS == (64, 128, 256)
    assert [tkernels._flash_width(d) for d in (129, 192, 255, 256)] \
        == [256] * 4
    with pytest.raises(ValueError, match="ROADMAP.md queue 2"):
        tkernels._flash_width(257)


@pytest.mark.parametrize("D", [192, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_matches_jax_above_128(D, causal):
    q, k, v, do = _qkv(1, 20, 2, D, seed=D + causal)
    o, lse = tkernels.flash_attention_fwd_reference(q, k, v, causal)
    jo = np.asarray(jkernels.flash_attention(
        q.numpy(), k.numpy(), v.numpy(), causal=causal, interpret=True))
    np.testing.assert_allclose(o.numpy(), jo, rtol=1e-4, atol=1e-5)
    # the gradients of a sum of o * do, through the JAX kernel's vjp and
    # through the port's plain backward
    import jax

    def jloss(q, k, v):
        return (jkernels.flash_attention(q, k, v, causal=causal,
                                         interpret=True)
                * do.numpy()).sum()

    jg = jax.grad(jloss, argnums=(0, 1, 2))(q.numpy(), k.numpy(), v.numpy())
    di = tkernels._flash_di(o, do)
    dq = tkernels.flash_attention_bwd_dq_reference(q, k, v, do, lse, di,
                                                   causal)
    dk, dv = tkernels.flash_attention_bwd_dkv_reference(q, k, v, do, lse,
                                                        di, causal)
    for got, want in zip((dq, dk, dv), jg):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_pad_to_256_and_slice_equals_plain(dtype):
    D = 192
    q, k, v, do = _qkv(1, 18, 2, D, seed=5, dtype=dtype)
    scale = 1.0 / np.sqrt(D)
    o, lse = tkernels.pad_head_dim_call(
        tkernels.flash_attention_fwd_reference, 256, (q, k, v), True, scale)
    o_ref, lse_ref = tkernels.flash_attention_fwd_reference(q, k, v, True,
                                                            scale)
    di = tkernels._flash_di(o_ref, do)
    dk, dv = tkernels.pad_head_dim_call(
        tkernels.flash_attention_bwd_dkv_reference, 256, (q, k, v, do),
        lse_ref, di, True, scale)
    want_dk, want_dv = tkernels.flash_attention_bwd_dkv_reference(
        q, k, v, do, lse_ref, di, True, scale)
    for got, want in ((o, o_ref), (lse, lse_ref), (dk, want_dk),
                      (dv, want_dv)):
        assert got.shape == want.shape and got.dtype == want.dtype
        torch.testing.assert_close(got.float(), want.float(), rtol=RTOL,
                                   atol=ATOL)


def _decode_inputs(rng, N, S, H, D, quant):
    q = rng.randn(N, H, D).astype(np.float32)
    if quant:
        k = rng.randint(-127, 128, (N, S, H, D)).astype(np.int8)
        v = rng.randint(-127, 128, (N, S, H, D)).astype(np.int8)
        sc = (rng.rand(2, H) * 0.02).astype(np.float32)
    else:
        k = rng.randn(N, S, H, D).astype(np.float32)
        v = rng.randn(N, S, H, D).astype(np.float32)
        sc = None
    return q, k, v, sc


@pytest.mark.parametrize("D", [192, 256, 200])
@pytest.mark.parametrize("quant", [False, True])
def test_decode_plain_matches_jax_above_128(D, quant):
    rng = np.random.RandomState(D + quant)
    N, S, H = 3, 40, 2
    q, k, v, sc = _decode_inputs(rng, N, S, H, D, quant)
    lengths = np.array([0, 17, S], np.int32)
    want = np.asarray(jkernels.decode_attention_reference(
        q, k, v, lengths, kv_scales=sc))
    got = tkernels.decode_attention(
        *[torch.from_numpy(a) for a in (q, k, v, lengths)],
        kv_scales=None if sc is None else torch.from_numpy(sc)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("D", [160, 192, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,causal", [(130, True), (97, False), (1, True)])
def test_cuda_flash_above_128_matches_plain(D, dtype, S, causal):
    _need_cuda()
    q, k, v, do = [t.cuda() for t in _qkv(2, S, 2, D, seed=D + S,
                                          dtype=dtype)]
    before = dict(tkernels.launch_counts)
    o, lse = tkernels.flash_attention_fwd(q, k, v, causal=causal)
    di = tkernels._flash_di(o, do)
    dq = tkernels.flash_attention_bwd_dq(q, k, v, do, lse, di, causal)
    dk, dv = tkernels.flash_attention_bwd_dkv(q, k, v, do, lse, di, causal)
    suffix = "" if dtype == torch.float32 else "_bf16"
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert tkernels.launch_counts[name + suffix] == \
            before[name + suffix] + 1
    cpu = [t.cpu() for t in (q, k, v, do)]
    o_ref, lse_ref = tkernels.flash_attention_fwd_reference(*cpu[:3],
                                                            causal)
    di_ref = tkernels._flash_di(o_ref, cpu[3])
    dq_ref = tkernels.flash_attention_bwd_dq_reference(
        *cpu, lse_ref, di_ref, causal)
    dk_ref, dv_ref = tkernels.flash_attention_bwd_dkv_reference(
        *cpu, lse_ref, di_ref, causal)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 \
        else dict(rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(lse.cpu(), lse_ref, **tol)
    for got, want in ((o, o_ref), (dq, dq_ref), (dk, dk_ref),
                      (dv, dv_ref)):
        assert got.shape == q.shape
        scale = max(float(want.float().abs().max()), 1.0)
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   rtol=tol["rtol"],
                                   atol=tol["atol"] * scale)


@pytest.mark.cuda
# 200 and 250 are not multiples of the 8-element (fp32, narrow int8) and
# 16-element (int8) loads of the 256 template
@pytest.mark.parametrize("D", [192, 256, 200, 250])
@pytest.mark.parametrize("quant", [False, True])
def test_cuda_decode_above_128_matches_plain(D, quant):
    _need_cuda()
    rng = np.random.RandomState(D + quant)
    N, S, H = 4, 300, 3
    q, k, v, sc = _decode_inputs(rng, N, S, H, D, quant)
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    sc = None if sc is None else torch.from_numpy(sc)
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
def test_cuda_int8_decode_at_256_on_4_byte_aligned_caches():
    """K4's narrow path at D 256 (two 4-byte loads a lane) on caches whose
    base is 4- but not 16-byte aligned."""
    _need_cuda()
    rng = np.random.RandomState(3)
    N, S, H, D = 2, 70, 2, 256
    q, k, v, sc = _decode_inputs(rng, N, S, H, D, True)
    kb = torch.zeros(k.size + 4, dtype=torch.int8, device="cuda")
    vb = torch.zeros(v.size + 4, dtype=torch.int8, device="cuda")
    kc = kb[4:].view(N, S, H, D)
    vc = vb[4:].view(N, S, H, D)
    kc.copy_(torch.from_numpy(k))
    vc.copy_(torch.from_numpy(v))
    lengths = torch.tensor([33, S], dtype=torch.int32)
    got = tkernels.decode_attention(torch.from_numpy(q).cuda(), kc, vc,
                                    lengths.cuda(),
                                    kv_scales=torch.from_numpy(sc).cuda())
    want = tkernels.decode_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        lengths, kv_scales=torch.from_numpy(sc))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)
