"""K1/K2, flash attention forward and backward: paddle_tpu_torch's plain
versions against paddle_tpu's Pallas kernel pair (interpret mode) on the
CPU; the CUDA kernels against the plain versions on the card."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import pallas_kernels as jax_kernels
from paddle_tpu_torch.ops import pallas_kernels as torch_kernels

# the JAX package's own tolerances for its kernel pair against plain
# attention (tests/test_flash_attention.py): fp32 sums over S in another
# order, and the gradients accumulate three products deep
FWD_ATOL = 2e-5
GRAD_ATOL = 5e-4

# (B, S, H, D): the Pallas blocks (32, 16, 16, 32) divide S = 64; no tile
# divides S = 40, where the JAX op takes its plain-attention fallback
_SHAPES = [(2, 64, 2, 16), (1, 40, 2, 16)]
_BLOCKS = dict(block_q=32, block_kv=16, block_q_bwd=16, block_kv_bwd=32)


def _qkv(B, S, H, D, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, S, H, D).astype(np.float32) for _ in range(3)]


def _jax_flash(q, k, v, causal):
    return jax_kernels.flash_attention(q, k, v, causal=causal,
                                       return_lse=True, interpret=True,
                                       **_BLOCKS)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,S,H,D", _SHAPES)
def test_forward_and_lse_match_jax_kernel(B, S, H, D, causal):
    q, k, v = _qkv(B, S, H, D, seed=S + D)
    jo, jlse = (np.asarray(a) for a in _jax_flash(q, k, v, causal))
    to, tlse = torch_kernels.flash_attention_reference(
        *map(torch.from_numpy, (q, k, v)), causal=causal, return_lse=True)
    assert to.shape == (B, S, H, D) and tlse.shape == (B, S, H)
    np.testing.assert_allclose(to.numpy(), jo, atol=FWD_ATOL)
    np.testing.assert_allclose(tlse.numpy(), jlse, atol=FWD_ATOL)


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,S,H,D", _SHAPES)
def test_grads_match_jax_kernel(B, S, H, D, causal, with_lse):
    """jax.grad through the fused backward (custom_vjp) against autograd
    through the port's plain version; with_lse also sends a cotangent
    into the lse output (the dlse term of di)."""
    q, k, v = _qkv(B, S, H, D, seed=3 * S + D)

    def jloss(q, k, v):
        o, lse = _jax_flash(q, k, v, causal)
        return jnp.sum(o * o) + (jnp.sum(jnp.sin(lse)) if with_lse else 0.)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    o, lse = torch_kernels.flash_attention(tq, tk, tv, causal=causal,
                                           return_lse=True)
    loss = (o * o).sum() + (torch.sin(lse).sum() if with_lse else 0.)
    tgrads = torch.autograd.grad(loss, (tq, tk, tv))
    for name, jg, tg in zip("qkv", jgrads, tgrads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg),
                                   atol=GRAD_ATOL, err_msg="d" + name)


@pytest.mark.parametrize("causal", [False, True])
def test_bwd_kernels_plain_versions_equal_autograd(causal):
    """The dq and dkv plain versions (the K2 kernels' formulas, p =
    exp(s - lse), ds = p (dp - di) scale) equal autograd of the plain
    forward, including a cotangent on lse."""
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _qkv(2, 24, 2, 8, seed=11))
    rng = np.random.RandomState(12)
    do = torch.from_numpy(rng.randn(2, 24, 2, 8).astype(np.float32))
    dlse = torch.from_numpy(rng.randn(2, 2, 24).astype(np.float32))
    o, lse = torch_kernels.flash_attention_fwd_reference(q, k, v, causal)
    auto = torch.autograd.grad((o, lse), (q, k, v), (do, dlse))
    plain = torch_kernels.flash_attention_bwd_reference(
        q.detach(), k.detach(), v.detach(), o.detach(), lse.detach(), do,
        causal, dlse=dlse)
    for name, a, p in zip("qkv", auto, plain):
        torch.testing.assert_close(p, a, rtol=1e-5, atol=1e-5,
                                   msg=lambda m: "d%s: %s" % (name, m))


def test_cpu_wrappers_run_plain_versions_without_counting():
    torch_kernels.reset_launch_counts()
    q, k, v = map(torch.from_numpy, _qkv(1, 16, 2, 8, seed=5))
    o, lse = torch_kernels.flash_attention_fwd(q, k, v, causal=True)
    ro, rlse = torch_kernels.flash_attention_fwd_reference(q, k, v, True)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    di = torch_kernels._flash_di(o, q)
    assert torch.equal(
        torch_kernels.flash_attention_bwd_dq(q, k, v, q, lse, di, True),
        torch_kernels.flash_attention_bwd_dq_reference(q, k, v, q, lse, di,
                                                       True))
    assert all(n == 0 for n in torch_kernels.launch_counts.values())


def test_op_lowering_shape_inference_on_meta():
    q = torch.empty(3, 10, 32, device="meta")
    out = torch_kernels.flash_attention(q.reshape(3, 10, 2, 16),
                                        q.reshape(3, 10, 2, 16),
                                        q.reshape(3, 10, 2, 16), True)
    assert out.device.type == "meta" and out.shape == (3, 10, 2, 16)


# ---------------------------------------------------------------------------
# on the card: the CUDA kernels against the plain versions
# ---------------------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _card_inputs(B, S, H, D, seed, fused_qkv):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if fused_qkv:   # q, k, v as column slices of one [B, S, 3 H D] tensor
        qkv = torch.randn(B, S, 3 * H * D, device="cuda", generator=g)
        return [qkv[..., i * H * D:(i + 1) * H * D].reshape(B, S, H, D)
                for i in range(3)]
    return [torch.randn(B, S, H, D, device="cuda", generator=g)
            for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,D,causal,fused", [
    (8, 512, 8, 64, True, True),      # the training slice's shape
    (2, 256, 4, 64, False, False),
    (1, 200, 2, 128, True, False),    # ragged: no 64-row tile divides S
    (2, 70, 3, 128, False, True),
])
def test_cuda_kernels_match_plain_versions(B, S, H, D, causal, fused):
    _need_cuda()
    q, k, v = _card_inputs(B, S, H, D, seed=S + D, fused_qkv=fused)
    torch_kernels.reset_launch_counts()
    o, lse = torch_kernels.flash_attention_fwd(q, k, v, causal)
    ro, rlse = torch_kernels.flash_attention_fwd_reference(q, k, v, causal)
    torch.testing.assert_close(o, ro, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-5)
    do = torch.randn_like(o)
    dlse = torch.randn_like(lse)
    di = torch_kernels._flash_di(ro, do, dlse)
    dq = torch_kernels.flash_attention_bwd_dq(q, k, v, do, rlse, di, causal)
    dk, dv = torch_kernels.flash_attention_bwd_dkv(q, k, v, do, rlse, di,
                                                   causal)
    torch.cuda.synchronize()
    assert torch_kernels.launch_counts["flash_attention_fwd"] == 1
    assert torch_kernels.launch_counts["flash_attention_bwd_dq"] == 1
    assert torch_kernels.launch_counts["flash_attention_bwd_dkv"] == 1
    ref = torch_kernels.flash_attention_bwd_reference(q, k, v, ro, rlse, do,
                                                      causal, dlse=dlse)
    # sums over S run in another order: atol scaled by the gradient's size
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        atol = 1e-4 * float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=atol,
                                   msg=lambda m: "%s: %s" % (name, m))


@pytest.mark.cuda
def test_cuda_autograd_and_torch_func_run_the_kernels():
    _need_cuda()
    q, k, v = _card_inputs(2, 128, 2, 64, seed=1, fused_qkv=False)

    def loss(q, k, v):
        return (torch_kernels.flash_attention(q, k, v, True) ** 2).sum()

    def ref_loss(q, k, v):
        return (torch_kernels.flash_attention_reference(q, k, v, True)
                ** 2).sum()

    torch_kernels.reset_launch_counts()
    got = torch.func.grad(loss, argnums=(0, 1, 2))(q, k, v)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    auto = torch.autograd.grad(loss(*leaves), leaves)
    want = torch.func.grad(ref_loss, argnums=(0, 1, 2))(q, k, v)
    torch.cuda.synchronize()
    assert torch_kernels.launch_counts["flash_attention_fwd"] == 2
    assert torch_kernels.launch_counts["flash_attention_bwd_dq"] == 2
    assert torch_kernels.launch_counts["flash_attention_bwd_dkv"] == 2
    for a, b, w in zip(got, auto, want):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, w, rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()))


@pytest.mark.cuda
def test_cuda_wrapper_raises_on_what_the_kernel_does_not_take():
    _need_cuda()
    q, k, v = _card_inputs(1, 64, 2, 64, seed=2, fused_qkv=False)
    with pytest.raises(ValueError, match="head dim"):
        torch_kernels.flash_attention_fwd(q[..., :32], k[..., :32],
                                          v[..., :32])
    with pytest.raises(TypeError, match="float32"):
        torch_kernels.flash_attention_fwd(q.double(), k.double(),
                                          v.double())
    with pytest.raises(ValueError, match="contiguous"):
        torch_kernels.flash_attention_fwd(q.transpose(1, 3).contiguous()
                                          .transpose(1, 3), k, v)
