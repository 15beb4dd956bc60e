"""K3, decode attention with fp32 caches: paddle_tpu_torch's plain version
against paddle_tpu's Pallas kernel (interpret mode) and its reference, on
the CPU; the CUDA kernel against the plain version on the card.  The
int8 branch (K4) and the head-slice entry are held in
test_torch_decode_attention_int8.py."""

import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_kernels as jax_kernels
from paddle_tpu_torch.ops import pallas_kernels as torch_kernels

# fp32 on both sides; the two sum in different orders over S and D
RTOL, ATOL = 1e-5, 1e-6

# (N, S, H, D, block_kv for the Pallas kernel: a divisor of S)
_SHAPES = [(5, 32, 2, 8, 8), (4, 64, 4, 16, 16), (3, 80, 2, 64, 16)]


def _inputs(N, S, H, D, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(N, H, D).astype(np.float32)
    k = rng.randn(N, S, H, D).astype(np.float32)
    v = rng.randn(N, S, H, D).astype(np.float32)
    # length 0, 1, a middle one and S, then seeded lengths
    base = [0, 1, S // 2 + 3, S]
    lengths = np.array((base + list(rng.randint(0, S + 1, size=N)))[:N],
                       np.int32)
    return q, k, v, lengths


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("N,S,H,D,bkv", _SHAPES)
def test_reference_matches_jax_kernel_and_reference(N, S, H, D, bkv):
    q, k, v, lengths = _inputs(N, S, H, D, seed=N * S + D)
    jax_ref = np.asarray(jax_kernels.decode_attention_reference(
        q, k, v, lengths))
    jax_kern = np.asarray(jax_kernels.decode_attention(
        q, k, v, lengths, block_kv=bkv, interpret=True))
    ours = torch_kernels.decode_attention_reference(
        *_torch(q, k, v, lengths)).numpy()
    assert ours.dtype == np.float32 and ours.shape == (N, H, D)
    np.testing.assert_allclose(ours, jax_ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ours, jax_kern, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("scale", [None, 0.3])
def test_explicit_scale_matches_jax(scale):
    q, k, v, lengths = _inputs(4, 32, 2, 16, seed=5)
    jax_ref = np.asarray(jax_kernels.decode_attention_reference(
        q, k, v, lengths, scale=scale))
    ours = torch_kernels.decode_attention_reference(
        *_torch(q, k, v, lengths), scale=scale).numpy()
    np.testing.assert_allclose(ours, jax_ref, rtol=RTOL, atol=ATOL)


def test_length_zero_is_mean_of_values_and_isolated():
    q, k, v, _ = _inputs(3, 16, 2, 8, seed=4)
    live = torch_kernels.decode_attention_reference(
        *_torch(q, k, v, np.array([5, 9, 16], np.int32))).numpy()
    mixed = torch_kernels.decode_attention_reference(
        *_torch(q, k, v, np.array([5, 0, 16], np.int32))).numpy()
    assert np.array_equal(live[0], mixed[0])
    assert np.array_equal(live[2], mixed[2])
    np.testing.assert_allclose(mixed[1], v[1].mean(axis=0), rtol=RTOL,
                               atol=ATOL)


def test_cpu_wrapper_runs_plain_version_without_counting():
    torch_kernels.reset_launch_counts()
    q, k, v, lengths = _torch(*_inputs(4, 32, 2, 16, seed=6))
    out = torch_kernels.decode_attention(q, k, v, lengths, scale=0.25)
    ref = torch_kernels.decode_attention_reference(q, k, v, lengths,
                                                   scale=0.25)
    assert torch.equal(out, ref)
    assert torch_kernels.launch_counts["decode_attention"] == 0


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("N,S,H,D,lengths", [
    (8, 512, 8, 64, [0, 1, 511, 512, 37, 256, 300, 129]),
    (3, 80, 2, 64, [0, 80, 41]),
])
def test_cuda_kernel_matches_reference(N, S, H, D, lengths):
    _need_cuda()
    q, k, v, _ = _inputs(N, S, H, D, seed=8)
    args = [t.cuda() for t in _torch(q, k, v,
                                     np.array(lengths, np.int32))]
    torch_kernels.reset_launch_counts()
    out = torch_kernels.decode_attention(*args)
    torch.cuda.synchronize()
    assert torch_kernels.launch_counts["decode_attention"] == 1
    ref = torch_kernels.decode_attention_reference(*args)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("S,D", [
    (512, 64), (80, 64), (513, 64), (512, 4), (512, 8), (512, 16),
    (512, 32), (512, 128), (513, 128), (80, 4)])
def test_cuda_split_boundaries_and_bit_exact_rows(S, D):
    """K3 splits each row's positions over a cluster of blocks, `share`
    each, fixed by S and D.  At lengths around a block's edge (0, 1,
    share - 1, share, share + 1, S - 1, S) it matches the plain version;
    and bit for bit: each row of a batched call equals the row launched
    alone, and 4 pseudo-slots per slot equal the plain step at the same
    lengths."""
    _need_cuda()
    plan = torch_kernels.decode_attention_f32_plan(S, D)
    cs, share = plan["cluster"], plan["share"]
    assert 1 <= cs <= 8 and cs * share >= S > (cs - 1) * share
    lens = sorted({min(max(n, 0), S)
                   for n in (0, 1, share - 1, share, share + 1, S - 1, S)})
    N, H = len(lens), 4
    q, k, v, _ = _inputs(N, S, H, D, seed=S + D)
    q, k, v = (t.cuda() for t in _torch(q, k, v))
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    torch_kernels.reset_launch_counts()
    out = torch_kernels.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert torch_kernels.launch_counts["decode_attention"] == 1
    ref = torch_kernels.decode_attention_reference(q, k, v, lengths)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    for i in range(N):
        alone = torch_kernels.decode_attention(
            q[i:i + 1].clone(), k[i:i + 1].clone(), v[i:i + 1].clone(),
            lengths[i:i + 1].clone())
        assert torch.equal(alone[0], out[i]), lens[i]
    C = 4
    qc = torch.from_numpy(np.random.RandomState(S).randn(
        N * C, H, D).astype(np.float32)).cuda()
    lc = torch.tensor([min(n + j, S) for n in lens for j in range(C)],
                      dtype=torch.int32, device="cuda")
    verify = torch_kernels.decode_attention(qc, k, v, lc, q_per_slot=C)
    plain = torch_kernels.decode_attention(
        qc, k.repeat_interleave(C, 0), v.repeat_interleave(C, 0), lc)
    assert torch.equal(verify, plain)
    torch.testing.assert_close(verify, torch_kernels.
                               decode_attention_reference(
                                   qc, k, v, lc, q_per_slot=C),
                               rtol=1e-5, atol=1e-5)
