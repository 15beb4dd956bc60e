"""K4, decode attention over int8 caches with per-head dequant scales, and
its head-slice entry: paddle_tpu_torch's plain version against
paddle_tpu's Pallas kernel (interpret mode) and its reference on the CPU;
the CUDA kernels against the plain version on the card.  Also K3's
`q_per_slot` pseudo-slots, which the speculative verify step runs."""

import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_kernels as jax_kernels
from paddle_tpu_torch.ops import pallas_kernels as torch_kernels

# fp32 on both sides; the two sum in different orders over S and D
RTOL, ATOL = 1e-5, 1e-6


def _int8_inputs(N, S, H, D, seed):
    """(q, k8, v8, lengths, kv_scales [2, H]) as the JAX package's
    kernel-substrate tests make them, with length 0, 1 and S among the
    lengths."""
    rng = np.random.RandomState(seed)
    q = rng.randn(N, H, D).astype(np.float32)
    kf = rng.randn(N, S, H, D).astype(np.float32)
    vf = rng.randn(N, S, H, D).astype(np.float32)
    ks = np.abs(kf).max(axis=(0, 1, 3)) * 1.25 / 127.0
    vs = np.abs(vf).max(axis=(0, 1, 3)) * 1.25 / 127.0
    k8 = np.clip(np.round(kf / ks[None, None, :, None]), -127,
                 127).astype(np.int8)
    v8 = np.clip(np.round(vf / vs[None, None, :, None]), -127,
                 127).astype(np.int8)
    base = [0, S, 1]
    lengths = np.array((base + list(rng.randint(0, S + 1, size=N)))[:N],
                       np.int32)
    return q, k8, v8, lengths, np.stack([ks, vs]).astype(np.float32)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("N,S,bkv", [(3, 32, 8), (1, 32, 32), (3, 31, None),
                                     (4, 64, 16)])
def test_int8_reference_matches_jax_kernel_and_reference(N, S, bkv):
    q, k8, v8, lengths, sc = _int8_inputs(N, S, 2, 8, seed=N * S)
    jax_ref = np.asarray(jax_kernels.decode_attention_reference(
        q, k8, v8, lengths, kv_scales=sc))
    jax_kern = np.asarray(jax_kernels.decode_attention(
        q, k8, v8, lengths, block_kv=bkv, interpret=True, kv_scales=sc))
    ours = torch_kernels.decode_attention_reference(
        *_torch(q, k8, v8, lengths), kv_scales=torch.from_numpy(sc)).numpy()
    assert ours.dtype == np.float32 and ours.shape == (N, 2, 8)
    np.testing.assert_allclose(ours, jax_ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ours, jax_kern, rtol=RTOL, atol=ATOL)
    # the CPU wrapper runs exactly the plain version and counts nothing
    torch_kernels.reset_launch_counts()
    out = torch_kernels.decode_attention(*_torch(q, k8, v8, lengths),
                                         kv_scales=torch.from_numpy(sc))
    assert np.array_equal(out.numpy(), ours)
    assert not any(torch_kernels.launch_counts.values())


def test_int8_algebra_is_the_dequantized_fp32_attention():
    """K scale on the scaled scores and V scale after the divide compute
    fp32 attention over the dequantized cache."""
    q, k8, v8, lengths, sc = _int8_inputs(3, 32, 2, 8, seed=3)
    deq = [(c.astype(np.float32) * s[None, None, :, None])
           for c, s in ((k8, sc[0]), (v8, sc[1]))]
    want = torch_kernels.decode_attention_reference(
        *_torch(q, deq[0], deq[1], lengths))
    got = torch_kernels.decode_attention_reference(
        *_torch(q, k8, v8, lengths), kv_scales=torch.from_numpy(sc))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_int8_caches_need_scales_and_fp32_caches_take_none():
    q, k8, v8, lengths, sc = _torch(*_int8_inputs(2, 16, 2, 8, seed=7))
    with pytest.raises(ValueError, match="kv_scales"):
        torch_kernels.decode_attention(q, k8, v8, lengths)
    with pytest.raises(ValueError, match="kv_scales"):
        torch_kernels.decode_attention(q, k8.float(), v8.float(), lengths,
                                       kv_scales=sc)
    with pytest.raises(ValueError, match="int8"):
        torch_kernels.decode_attention_head_slice(
            q, k8.float(), v8.float(), lengths, 0, 2, kv_scales=sc)
    with pytest.raises(ValueError, match="outside"):
        torch_kernels.decode_attention_head_slice(q, k8, v8, lengths, 1, 2,
                                                  kv_scales=sc)


@pytest.mark.parametrize("n_local", [1, 2])
def test_head_slice_matches_jax_at_every_offset(n_local):
    """The local head block against the full [2, H_total] table at each
    member's offset: equal to JAX's head-slice entry and to the full
    table's heads."""
    H = 4
    q, k8, v8, lengths, sc = _int8_inputs(3, 32, H, 8, seed=11)
    full = torch_kernels.decode_attention_reference(
        *_torch(q, k8, v8, lengths), kv_scales=torch.from_numpy(sc)).numpy()
    for off in range(0, H, n_local):
        blk = slice(off, off + n_local)
        ql, kl, vl = q[:, blk], k8[:, :, blk], v8[:, :, blk]
        jax_out = np.asarray(jax_kernels.decode_attention_head_slice(
            ql, kl, vl, lengths, off, n_local, block_kv=8, interpret=True,
            kv_scales=sc))
        ours = torch_kernels.decode_attention_head_slice(
            *_torch(ql, kl, vl, lengths), off, n_local,
            kv_scales=torch.from_numpy(sc[:, :, None])).numpy()
        np.testing.assert_allclose(ours, jax_out, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(ours, full[:, blk], rtol=RTOL,
                                   atol=ATOL)


def test_head_slice_with_fp32_caches_is_k3_on_the_block():
    rng = np.random.RandomState(5)
    q = rng.randn(2, 2, 8).astype(np.float32)
    k = rng.randn(2, 16, 2, 8).astype(np.float32)
    v = rng.randn(2, 16, 2, 8).astype(np.float32)
    lengths = np.array([16, 5], np.int32)
    jax_out = np.asarray(jax_kernels.decode_attention_head_slice(
        q, k, v, lengths, 2, 2, block_kv=8, interpret=True))
    ours = torch_kernels.decode_attention_head_slice(
        *_torch(q, k, v, lengths), 2, 2).numpy()
    np.testing.assert_allclose(ours, jax_out, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("quant", [False, True])
def test_q_per_slot_reads_each_slot_in_place(quant):
    """Pseudo-slot p reads cache slot p // q_per_slot with its own length:
    exactly the plain version over explicitly repeated caches, and the
    JAX reference over the broadcast caches the JAX verify step builds."""
    N, C, S, H, D = 3, 4, 32, 2, 8
    q, k8, v8, lengths, sc = _int8_inputs(N, S, H, D, seed=13)
    rng = np.random.RandomState(14)
    qs = rng.randn(N * C, H, D).astype(np.float32)
    base = np.array([0, 9, S - C])
    qlens = (base[:, None] + np.arange(C)[None] + 1).reshape(-1).astype(
        np.int32)
    if quant:
        k, v, kw = k8, v8, dict(kv_scales=torch.from_numpy(sc))
        jkw = dict(kv_scales=sc)
    else:
        # fp32 caches: the dequantized values
        k = k8.astype(np.float32) * sc[0][None, None, :, None]
        v = v8.astype(np.float32) * sc[1][None, None, :, None]
        kw, jkw = {}, {}
    ours = torch_kernels.decode_attention(*_torch(qs, k, v, qlens),
                                          q_per_slot=C, **kw).numpy()
    rep = torch_kernels.decode_attention(
        *_torch(qs, np.repeat(k, C, axis=0), np.repeat(v, C, axis=0),
                qlens), **kw).numpy()
    assert np.array_equal(ours, rep)
    jax_ref = np.asarray(jax_kernels.decode_attention_reference(
        qs, np.repeat(k, C, axis=0), np.repeat(v, C, axis=0), qlens, **jkw))
    np.testing.assert_allclose(ours, jax_ref, rtol=RTOL, atol=ATOL)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("N,S,H,D,lengths", [
    (8, 512, 8, 64, [0, 1, 511, 512, 37, 256, 300, 129]),
    (3, 80, 2, 64, [0, 80, 41]),
])
def test_cuda_int8_kernel_and_head_slice(N, S, H, D, lengths):
    _need_cuda()
    q, k8, v8, _, sc = _int8_inputs(N, S, H, D, seed=8)
    args = [t.cuda() for t in _torch(q, k8, v8,
                                     np.array(lengths, np.int32))]
    scales = torch.from_numpy(sc).cuda()
    torch_kernels.reset_launch_counts()
    out = torch_kernels.decode_attention(*args, kv_scales=scales)
    torch.cuda.synchronize()
    assert torch_kernels.launch_counts["decode_attention_int8"] == 1
    ref = torch_kernels.decode_attention_reference(*args,
                                                   kv_scales=scales)
    torch.testing.assert_close(out, ref, rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))
    # the head blocks at every offset, concatenated, equal the full
    # table's output bit for bit (each (slot, head) row is its own cluster)
    qd, kd, vd, ld = args
    for n_local in (1, 2):
        parts = [torch_kernels.decode_attention_head_slice(
            qd[:, o:o + n_local].contiguous(),
            kd[:, :, o:o + n_local].contiguous(),
            vd[:, :, o:o + n_local].contiguous(), ld, o, n_local,
            kv_scales=scales) for o in range(0, H, n_local)]
        assert torch.equal(torch.cat(parts, dim=1), out)
    torch.cuda.synchronize()
    assert torch_kernels.launch_counts["decode_attention_head_slice"] > 0


@pytest.mark.cuda
def test_cuda_q_per_slot_matches_reference():
    _need_cuda()
    N, C, S, H, D = 8, 5, 512, 8, 64
    rng = np.random.RandomState(9)
    q = torch.from_numpy(rng.randn(N * C, H, D).astype(np.float32)).cuda()
    k = torch.from_numpy(rng.randn(N, S, H, D).astype(np.float32)).cuda()
    v = torch.from_numpy(rng.randn(N, S, H, D).astype(np.float32)).cuda()
    base = np.array([0, 1, 100, 200, 300, 400, 500, S - C])
    lengths = torch.from_numpy((base[:, None] + np.arange(C)[None] + 1)
                               .reshape(-1).astype(np.int32)).cuda()
    out = torch_kernels.decode_attention(q, k, v, lengths, q_per_slot=C)
    ref = torch_kernels.decode_attention_reference(q, k, v, lengths,
                                                   q_per_slot=C)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    rep = torch_kernels.decode_attention(
        q, k.repeat_interleave(C, 0), v.repeat_interleave(C, 0), lengths)
    assert torch.equal(out, rep)


def _shifted(t):
    """t's values in a contiguous tensor that starts 4 bytes past a
    16-byte boundary (K4 then loads 4 bytes a lane)."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    out = buf[4:4 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("S,D,shifted", [
    (512, 64, False), (80, 64, False), (513, 64, False),
    (512, 4, False), (512, 8, False), (512, 16, False), (512, 32, False),
    (512, 128, False), (513, 128, False), (512, 64, True), (80, 8, True)])
def test_cuda_int8_split_boundaries_and_bit_exact_rows(S, D, shifted):
    """K4 splits each row's positions over a cluster of blocks, `share`
    each, fixed by S and D.  At lengths around a block's edge (0, 1,
    share - 1, share, share + 1, S - 1, S) it matches the plain version;
    and bit for bit: each row of a batched call equals the row launched
    alone, 4 pseudo-slots per slot equal the plain step at the same
    lengths, and the head blocks at every offset equal the full table."""
    _need_cuda()
    plan = torch_kernels.decode_attention_int8_plan(S, D)
    cs, share = plan["cluster"], plan["share"]
    assert 1 <= cs <= 8 and cs * share >= S > (cs - 1) * share
    lens = sorted({min(max(n, 0), S)
                   for n in (0, 1, share - 1, share, share + 1, S - 1, S)})
    N, H = len(lens), 4
    q, k8, v8, _, sc = _int8_inputs(N, S, H, D, seed=S + D)
    q, k8, v8, scales = (t.cuda() for t in _torch(q, k8, v8, sc))
    if shifted:
        k8, v8 = _shifted(k8), _shifted(v8)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    torch_kernels.reset_launch_counts()
    out = torch_kernels.decode_attention(q, k8, v8, lengths,
                                         kv_scales=scales)
    torch.cuda.synchronize()
    assert torch_kernels.launch_counts["decode_attention_int8"] == 1
    ref = torch_kernels.decode_attention_reference(q, k8, v8, lengths,
                                                   kv_scales=scales)
    torch.testing.assert_close(out, ref, rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))
    if shifted:
        return
    for i in range(N):
        alone = torch_kernels.decode_attention(
            q[i:i + 1].clone(), k8[i:i + 1].clone(), v8[i:i + 1].clone(),
            lengths[i:i + 1].clone(), kv_scales=scales)
        assert torch.equal(alone[0], out[i]), lens[i]
    C = 4
    qc = torch.from_numpy(np.random.RandomState(S).randn(
        N * C, H, D).astype(np.float32)).cuda()
    lc = torch.tensor([min(n + j, S) for n in lens for j in range(C)],
                      dtype=torch.int32, device="cuda")
    verify = torch_kernels.decode_attention(qc, k8, v8, lc, kv_scales=scales,
                                            q_per_slot=C)
    plain = torch_kernels.decode_attention(
        qc, k8.repeat_interleave(C, 0), v8.repeat_interleave(C, 0), lc,
        kv_scales=scales)
    assert torch.equal(verify, plain)
    for n_local in (1, 2):
        parts = [torch_kernels.decode_attention_head_slice(
            q[:, o:o + n_local].contiguous(),
            k8[:, :, o:o + n_local].contiguous(),
            v8[:, :, o:o + n_local].contiguous(), lengths, o, n_local,
            kv_scales=scales) for o in range(0, H, n_local)]
        assert torch.equal(torch.cat(parts, dim=1), out)
