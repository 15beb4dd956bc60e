"""K1/K2, flash attention forward and backward: paddle_tpu_torch's plain
versions against paddle_tpu's Pallas kernel pair (interpret mode) on the
CPU, in fp32 and in bf16; the CUDA kernels against the plain versions on
the card."""

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
# bf16 (K1/K2 under AMP): the plain versions round where the TPU kernels
# cast — p before p . v, ds before ds . k, p and ds before the dk/dv
# products — against the JAX kernel pair run on bf16 inputs
# ---------------------------------------------------------------------------

# both sides sum in fp32 in other orders (and the JAX kernel rounds each
# tile's p against its running max), so an element may land on a
# neighbouring bf16 value: 2^-7 relative, with a floor of 2^-7 of the
# array's largest magnitude; lse is fp32 on both sides
_BF16_TOL = 2.0 ** -7
_BF16_SHAPES = [(2, 64, 2, 16), (1, 128, 2, 32)]


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


def _assert_bf16_close(got, want, what):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got, want, rtol=_BF16_TOL,
        atol=_BF16_TOL * float(np.abs(want).max()), err_msg=what)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,S,H,D", _BF16_SHAPES)
def test_bf16_forward_and_grads_match_jax_kernel(B, S, H, D, causal):
    """o, lse and (via jax.vjp, cotangents on o and lse) dq, dk, dv."""
    rng = np.random.RandomState(S + D + causal)
    q, k, v, do = (rng.randn(B, S, H, D).astype(np.float32)
                   for _ in range(4))
    dlse = rng.randn(B, S, H).astype(np.float32)
    (jo, jlse), jvjp = jax.vjp(
        lambda a, b, c: _jax_flash(a, b, c, causal),
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    jgrads = jvjp((jnp.asarray(do, jnp.bfloat16), jnp.asarray(dlse)))
    assert jo.dtype == jnp.bfloat16 and jlse.dtype == jnp.float32
    tq, tk, tv = (_bf16(a).requires_grad_(True) for a in (q, k, v))
    to, tlse = torch_kernels.flash_attention(tq, tk, tv, causal=causal,
                                             return_lse=True)
    assert to.dtype == torch.bfloat16 and tlse.dtype == torch.float32
    _assert_bf16_close(to, jo, "o")
    np.testing.assert_allclose(tlse.detach().numpy(), np.asarray(jlse),
                               atol=FWD_ATOL)
    tgrads = torch.autograd.grad((to, tlse), (tq, tk, tv),
                                 (_bf16(do), torch.from_numpy(dlse)))
    for name, jg, tg in zip("qkv", jgrads, tgrads):
        assert tg.dtype == torch.bfloat16
        _assert_bf16_close(tg, jg, "d" + name)


def test_bf16_cpu_route_is_the_plain_k2_versions():
    """On the CPU a bf16 `flash_attention` differentiates through the
    plain K2 versions (which round ds and p), not by autograd of the
    plain forward (which would treat those casts as the identity)."""
    rng = np.random.RandomState(21)
    q, k, v, do = (_bf16(rng.randn(2, 48, 2, 16).astype(np.float32))
                   for _ in range(4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    torch_kernels.reset_launch_counts()
    o = torch_kernels.flash_attention(*leaves, causal=True)
    got = torch.autograd.grad(o, leaves, do)
    ro, rlse = torch_kernels.flash_attention_fwd_reference(q, k, v, True)
    assert torch.equal(o, ro)
    want = torch_kernels.flash_attention_bwd_reference(q, k, v, ro, rlse,
                                                       do, True)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    auto_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    auto = torch.autograd.grad(torch_kernels.flash_attention_reference(
        *auto_leaves, causal=True), auto_leaves, do)
    assert not torch.equal(auto[0], got[0])
    assert all(n == 0 for n in torch_kernels.launch_counts.values())


def test_bf16_plain_versions_round_like_the_kernels():
    """The bf16 plain versions equal the fp32 formulas with p and ds
    rounded to bf16 where the TPU kernels cast them."""
    rng = np.random.RandomState(22)
    q, k, v, do = (_bf16(rng.randn(1, 32, 2, 16).astype(np.float32))
                   for _ in range(4))
    o, lse = torch_kernels.flash_attention_fwd_reference(q, k, v)
    di = torch_kernels._flash_di(o, do)
    s = torch_kernels._scores(q, k, 0.25, False)
    p = torch.exp(s - lse[..., None])
    rnd = lambda t: t.to(torch.bfloat16).float()
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - di[..., None]) * 0.25
    dq = torch.einsum("bhqk,bkhd->bqhd", rnd(ds), k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", rnd(ds), q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", rnd(p), do.float())
    got_dq = torch_kernels.flash_attention_bwd_dq_reference(q, k, v, do, lse,
                                                            di)
    got_dk, got_dv = torch_kernels.flash_attention_bwd_dkv_reference(
        q, k, v, do, lse, di)
    for want, got in ((dq, got_dq), (dk, got_dk), (dv, got_dv)):
        assert torch.equal(got, want.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# on the card: the CUDA kernels against the plain versions
# ---------------------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _card_inputs(B, S, H, D, seed, fused_qkv, dtype=torch.float32):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if fused_qkv:   # q, k, v as column slices of one [B, S, 3 H D] tensor
        qkv = torch.randn(B, S, 3 * H * D, device="cuda",
                          generator=g).to(dtype)
        return [qkv[..., i * H * D:(i + 1) * H * D].reshape(B, S, H, D)
                for i in range(3)]
    return [torch.randn(B, S, H, D, device="cuda", generator=g).to(dtype)
            for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,D,causal,fused", [
    (8, 512, 8, 64, True, True),      # the training slice's shape
    (2, 256, 4, 64, False, False),
    (1, 200, 2, 128, True, False),    # ragged: no 64-row tile divides S
    (2, 70, 3, 128, False, True),
    # long rows (the JAX package's S 1024 / 4096 lanes): K1 folds S / 64
    # tiles into o, K2 sums S / 64 tiles into each gradient row
    (1, 2048, 2, 64, True, True),
    (1, 4096, 2, 64, True, False),
    (1, 2048, 2, 128, False, False),
    (1, 4096, 1, 128, True, True),
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
    # a head dim below 128 runs zero-padded; past 128 it raises
    wide = torch.randn(1, 64, 2, 160, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        torch_kernels.flash_attention_fwd(wide, wide, wide)
    with pytest.raises(TypeError, match="float32"):
        torch_kernels.flash_attention_fwd(q.double(), k.double(),
                                          v.double())
    with pytest.raises(ValueError, match="contiguous"):
        torch_kernels.flash_attention_fwd(q.transpose(1, 3).contiguous()
                                          .transpose(1, 3), k, v)


# below, at and around one 64-row tile, and ragged: D = 128 non-causal on
# strided slices of a fused qkv, and D = 64 causal on plain tensors
_BF16_EDGE_CASES = [(2, S, 2, 128, False, True) for S in (1, 63, 64, 65, 200)
                    ] + [(2, S, 3, 64, True, False)
                         for S in (1, 63, 64, 65, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,D,causal,fused", [
    (8, 512, 8, 64, True, True),      # the training slice's shape
    (2, 256, 4, 64, False, False),
    (1, 200, 2, 128, True, False),    # ragged: no 64-row tile divides S
    (2, 70, 3, 128, False, True),
] + _BF16_EDGE_CASES)
def test_cuda_bf16_kernels_match_plain_versions(B, S, H, D, causal, fused):
    """K1/K2-bf16 (tensor-core kernels) against the bf16 plain versions
    (strided q/k/v read in place); the CPU comparison's bf16 tolerance
    (both sum in fp32 in other orders, and the forward rounds each tile's
    p against its running max, the plain version against the row's final
    max).  The edge cases give lse a cotangent too (di's dlse term): with
    only o's, a row over one key (S = 1) has ds = p (do . v - do . o) = 0
    exactly, and dq, dk would be rounding noise on both sides."""
    _need_cuda()
    q, k, v = _card_inputs(B, S, H, D, seed=S + D, fused_qkv=fused,
                           dtype=torch.bfloat16)
    torch_kernels.reset_launch_counts()
    o, lse = torch_kernels.flash_attention_fwd(q, k, v, causal)
    ro, rlse = torch_kernels.flash_attention_fwd_reference(q, k, v, causal)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-5)
    do = torch.randn_like(o)
    edge = (B, S, H, D, causal, fused) in _BF16_EDGE_CASES
    di = torch_kernels._flash_di(ro, do,
                                 torch.randn_like(rlse) if edge else None)
    dq = torch_kernels.flash_attention_bwd_dq(q, k, v, do, rlse, di, causal)
    dk, dv = torch_kernels.flash_attention_bwd_dkv(q, k, v, do, rlse, di,
                                                   causal)
    torch.cuda.synchronize()
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert torch_kernels.launch_counts[name + "_bf16"] == 1
        assert torch_kernels.launch_counts[name] == 0
    rdq = torch_kernels.flash_attention_bwd_dq_reference(q, k, v, do, rlse,
                                                         di, causal)
    rdk, rdv = torch_kernels.flash_attention_bwd_dkv_reference(
        q, k, v, do, rlse, di, causal)
    for name, got, want in (("o", o, ro), ("dq", dq, rdq), ("dk", dk, rdk),
                            ("dv", dv, rdv)):
        assert got.dtype == torch.bfloat16
        _assert_bf16_close(got.cpu(), want.float().cpu().numpy(), name)


@pytest.mark.cuda
def test_cuda_bf16_kernels_run_on_tensor_cores():
    """The machine code of the bf16 K1/K2 kernels holds bf16 tensor-core
    instructions (HMMA for mma.sync, HGMMA for wgmma) and no other; the
    fp32 K1 and K2 kernels (3xTF32) hold TF32 HMMA and no other."""
    _need_cuda()
    from paddle_tpu_torch.ops import _build
    counts = {**_build.tensor_core_counts("flash_attention_fwd"),
              **_build.tensor_core_counts("flash_attention_bwd")}
    for kind, fp32 in (("flash_fwd", "tf32"), ("flash_bwd_dq", "tf32"),
                       ("flash_bwd_dkv", "tf32")):
        tc = [c for n, c in counts.items() if kind + "_tc_kernel" in n]
        f32 = [c for n, c in counts.items() if kind + "_kernel" in n]
        assert len(tc) == len(f32) == 2, kind   # D = 64 and D = 128
        for want, found in (("bf16", tc), (fp32, f32)):
            for c in found:
                others = sum(v for k, v in c.items() if k != want)
                assert others == 0, (kind, want, c)
                assert want is None or c[want] > 0, (kind, want, c)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,D,causal,fused", [
    (8, 512, 8, 64, True, True),      # the training slice's shape
    (2, 1, 3, 64, True, False),       # one key, one query
    (2, 1, 2, 128, False, True),
])
def test_cuda_fp32_bwd_kernels_match_and_rerun_bit_identically(
        B, S, H, D, causal, fused):
    """fp32 K2 (3xTF32 tensor-core kernels) against the plain versions at
    the fp32 tolerance of test_cuda_kernels_match_plain_versions, lse's
    cotangent in di (at S = 1, ds = p (do . v - do . o) is exactly 0
    without it); a second launch on the same inputs is bit-identical."""
    _need_cuda()
    q, k, v = _card_inputs(B, S, H, D, seed=3 * S + D, fused_qkv=fused)
    ro, rlse = torch_kernels.flash_attention_fwd_reference(q, k, v, causal)
    g = torch.Generator(device="cuda").manual_seed(S)
    do = torch.randn(ro.shape, device="cuda", generator=g)
    dlse = torch.randn(rlse.shape, device="cuda", generator=g)
    di = torch_kernels._flash_di(ro, do, dlse)
    torch_kernels.reset_launch_counts()
    runs = [(torch_kernels.flash_attention_bwd_dq(q, k, v, do, rlse, di,
                                                  causal),)
            + tuple(torch_kernels.flash_attention_bwd_dkv(q, k, v, do, rlse,
                                                          di, causal))
            for _ in range(2)]
    torch.cuda.synchronize()
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert torch_kernels.launch_counts[name] == 2
        assert torch_kernels.launch_counts[name + "_bf16"] == 0
    ref = torch_kernels.flash_attention_bwd_reference(q, k, v, ro, rlse, do,
                                                      causal, dlse=dlse)
    for name, got, again, want in zip(("dq", "dk", "dv"), runs[0], runs[1],
                                      ref):
        assert torch.equal(got, again), name
        atol = 1e-4 * float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=atol,
                                   msg=lambda m: "%s: %s" % (name, m))


@pytest.mark.cuda
def test_cuda_bf16_wrapper_checks_16_byte_strides():
    """bf16 rows are read 8 elements at a time: a stride of 4 elements
    (fine for fp32) raises, and so does a bf16 k beside an fp32 q."""
    _need_cuda()
    wide = torch.randn(1, 64, 2 * 64 + 4, device="cuda").to(torch.bfloat16)
    q = wide[..., :128].reshape(1, 64, 2, 64)
    with pytest.raises(ValueError, match="multiples of 8"):
        torch_kernels.flash_attention_fwd(q, q, q)
    qf = torch.randn(1, 64, 2, 64, device="cuda")
    with pytest.raises(TypeError, match="bfloat16"):
        torch_kernels.flash_attention_fwd(q.contiguous(), qf, qf)
