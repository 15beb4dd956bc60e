"""The 3xTF32 split (`split_tf32`, paddle_tpu_torch/ops/csrc/tc_common.cuh)
on infinite, NaN and near-FLT_MAX operands.

On the CPU: a bit-level emulation of the split in numpy, and of one
3xTF32 product as the tensor core takes it (each operand's TF32 top 19
bits, small.big + big.small + big.big summed in fp32), checked against
float64 and against the plain fp32 product.  The emulation's statements
are held against the source text, so an edit of the split shows here.

On the card (marked `cuda`): every kernel that splits fp32 operands —
fp32 K1 and K2 (flash attention), fp32 K6 (the fused bottleneck) and K5
with fp32 x (the dequant-matmul) — against its plain version on inputs
that hold +-inf and values within one TF32 ulp of FLT_MAX: +-inf where
the plain version gives +-inf, NaN only where it gives NaN, and the
finite rest at the kernel's usual tolerance."""

import os
import re

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import pallas_kernels as tk

FLT_MAX_BITS = 0x7F7FFFFF
TF32_MASK = np.uint32(0xFFFFE000)


def _f32(bits):
    return np.array(bits, np.uint32).view(np.float32)


def split_tf32(x, clamp=True):
    """(big, small) as uint32 bit patterns: csrc/tc_common.cuh's
    split_tf32<clamp>, statement by statement."""
    u = np.asarray(x, np.float32).view(np.uint32)
    with np.errstate(over="ignore"):
        t = u + np.uint32(0x1000)
    if clamp:
        bound = (u & np.uint32(0x80000000)) | np.uint32(0x7F7FFFFF)
        t = np.minimum(t.view(np.int32), bound.view(np.int32)).view(
            np.uint32)
    big = t & TF32_MASK
    with np.errstate(invalid="ignore"):
        small = (np.asarray(x, np.float32)
                 - big.view(np.float32)).astype(np.float32)
    return big, small.view(np.uint32)


def tf32(bits):
    """What the tensor core reads of an operand register: its top 19
    bits."""
    return (np.asarray(bits, np.uint32) & TF32_MASK).view(np.float32)


def product_3xtf32(x, y, clamp=True):
    """x . y as one 3xTF32 product: small.big, big.small, big.big (the
    passes' order), each exact in fp32 unless it overflows, summed in
    fp32."""
    xb, xs = split_tf32(x, clamp)
    yb, ys = split_tf32(y, clamp)
    with np.errstate(over="ignore", invalid="ignore"):
        acc = tf32(xs) * tf32(yb)
        acc = acc + tf32(xb) * tf32(ys)
        return (acc + tf32(xb) * tf32(yb)).astype(np.float32)


# +-inf, NaNs of both signs and with payloads only in the bits TF32
# drops, FLT_MAX and values within one TF32 ulp (2^13 fp32 ulps) of it —
# below, at and above the half-ulp point where big's rounding would
# overflow — both signs
_NEAR_MAX = [FLT_MAX_BITS - d for d in
             (0, 1, 0xFFF, 0x1000, 0x1001, 0x1FFF, 0x2000)]
_SPECIAL_BITS = ([0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000,
                  0x7F800001, 0xFFFFFFFF, 0x7FFFFFFF]
                 + _NEAR_MAX + [b | 0x80000000 for b in _NEAR_MAX])
# partners: exact in TF32 (their small is 0), not exact, zero, huge,
# infinite
_PARTNERS = np.array([1.0, -2.0, 0.5, 3.0, 0.0, -0.0, 1.0000001,
                      -0.3333333, 7.123456, -4095.3, 3001.7,
                      np.float32(3e38), np.inf, -np.inf], np.float32)


def test_split_is_exact_and_finite_where_x_is_finite():
    rng = np.random.RandomState(0)
    x = np.concatenate([_f32(_SPECIAL_BITS),
                        rng.randn(256).astype(np.float32),
                        np.float32([0.0, -0.0, 1e-40, -1e-38, 65504.0])])
    big, small = split_tf32(x)
    bf, sf = big.view(np.float32), small.view(np.float32)
    finite = np.isfinite(x)
    assert np.all(np.isfinite(bf[finite])) and np.all(
        np.isfinite(sf[finite]))
    np.testing.assert_array_equal(
        bf[finite].astype(np.float64) + sf[finite].astype(np.float64),
        x[finite].astype(np.float64))
    assert np.all(big & ~TF32_MASK == 0)   # big is a TF32 value
    # +-inf: big the largest finite TF32 of x's sign, small x itself
    inf = np.isinf(x)
    np.testing.assert_array_equal(np.abs(bf[inf]), _f32(0x7F7FE000))
    np.testing.assert_array_equal(np.signbit(bf[inf]), np.signbit(x[inf]))
    np.testing.assert_array_equal(sf[inf], x[inf])
    # no NaN from a non-NaN x; a NaN x stays NaN in small
    nan = np.isnan(x)
    assert not np.isnan(bf[~nan]).any() and not np.isnan(sf[~nan]).any()
    assert np.isnan(sf[nan]).all()


def test_3xtf32_product_is_inf_or_nan_where_fp32_is():
    """Every pair in which one operand is below 2^12 in magnitude (or both
    are infinite or NaN): there the split's cross terms cannot overflow
    on their own.  (A product of two operands of 2^12 or more — an
    infinite one against a large finite one, or two finite ones whose
    product overflows by 2^11 or more — may sum its overflowing terms to
    NaN.)"""
    x = np.concatenate([_f32(_SPECIAL_BITS), np.float32([1.5, -0.75])])
    xx, yy = np.meshgrid(x, _PARTNERS, indexing="ij")
    with np.errstate(invalid="ignore"):
        small = np.minimum(np.abs(xx), np.abs(yy)) < 2.0 ** 12
    keep = small | (~np.isfinite(xx) & ~np.isfinite(yy))
    xx, yy = xx[keep], yy[keep]
    with np.errstate(over="ignore", invalid="ignore"):
        plain = (xx * yy).astype(np.float32)
        exact = xx.astype(np.float64) * yy.astype(np.float64)
    # a finite product that rounds to +-inf only within 3xTF32's error of
    # FLT_MAX may land on either side
    edge = np.isfinite(exact) & (np.abs(exact) < np.float64(
        _f32(FLT_MAX_BITS)) * (1 + 2.0 ** -19))
    for a, b in ((xx, yy), (yy, xx)):   # the split operand as A and as B
        got = product_3xtf32(a, b)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(plain))
        inf = np.isinf(plain) & ~edge
        np.testing.assert_array_equal(got[inf], plain[inf])
        fin = np.isfinite(plain) | edge
        assert np.isfinite(got[np.isfinite(plain)]).all()
        np.testing.assert_allclose(got[fin], exact[fin], rtol=2.0 ** -19,
                                   atol=0)


def test_unclamped_split_marks_every_product_it_cannot_take_with_nan():
    """The kernels that split streamed operands run a block with the
    three-instruction split first and again clamped when its results hold
    a NaN.  That is sound because the unclamped split equals the clamped
    one below |x| = 0x1.ffep127, and every product with an operand at or
    above it (or infinite) is NaN, whatever the other operand."""
    rng = np.random.RandomState(1)
    x = np.concatenate([_f32(_SPECIAL_BITS),
                        rng.randn(64).astype(np.float32) * 1e3])
    cut = _f32(0x7F7FF000)
    ok = np.abs(x) < cut
    for clamp in (True, False):
        b, sm = split_tf32(x[ok], clamp)
        if clamp:
            want = (b, sm)
        else:
            np.testing.assert_array_equal(b, want[0])
            np.testing.assert_array_equal(sm, want[1])
    special = x[~np.isnan(x) & ~ok]
    assert len(special) > 0
    xx, yy = np.meshgrid(special, _PARTNERS, indexing="ij")
    for a, b in ((xx, yy), (yy, xx)):
        assert np.isnan(product_3xtf32(a, b, clamp=False)).all()


def test_emulation_mirrors_the_source():
    """The body of split_tf32 in tc_common.cuh is the statements the
    emulation above runs, clamped and not."""
    with open(os.path.join(_build.CSRC_DIR, "tc_common.cuh")) as f:
        src = f.read()
    body = re.search(r"void split_tf32\([^)]*\)\s*\{(.*?)\n\}", src,
                     re.S).group(1)
    stmts = [re.sub(r"\s+", " ", s).strip() for s in
             re.sub(r"//[^\n]*", "", body).split(";")]
    assert [s for s in stmts if s] == [
        "const uint32_t u = __float_as_uint(x)",
        "if constexpr (kClamp) big = (uint32_t)min((int)(u + 0x1000u), "
        "(int)((u & 0x80000000u) | 0x7f7fffffu)) & 0xffffe000u",
        "else big = (u + 0x1000u) & 0xffffe000u",
        "small = __float_as_uint(x - __uint_as_float(big))"]


# ---------------------------------------------------------------------------
# on the card: the kernels that split fp32 operands, on such inputs
# ---------------------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _special_like(t, spots):
    """t with the values of `spots` ({flat index: fp32 bits}) written in."""
    flat = t.reshape(-1).clone()
    for i, bits in spots.items():
        flat[i] = float(_f32(bits))
    return flat.view(t.shape)


def _assert_special_close(got, want, rtol, atol_scale, what):
    """NaN only where `want` is NaN; +-inf wherever `want` is; the rest
    finite and within rtol |want| + atol_scale max|finite want|."""
    got, want = got.float(), want.float()
    bad = torch.isnan(got) & ~torch.isnan(want)
    assert not bad.any(), "%s: %d NaN where the plain version has none" % (
        what, int(bad.sum()))
    inf = torch.isinf(want)
    assert torch.equal(got[inf], want[inf]), "%s: infinities differ" % what
    fin = torch.isfinite(want)
    assert torch.isfinite(got[fin]).all(), "%s: inf where finite" % what
    atol = atol_scale * float(want[fin].abs().max())
    torch.testing.assert_close(got[fin], want[fin], rtol=rtol, atol=atol,
                               msg=lambda m: "%s: %s" % (what, m))
    return int(inf.sum())


_INF, _NINF = 0x7F800000, 0xFF800000
_NEAR = FLT_MAX_BITS - 0x800   # within half a TF32 ulp: big would overflow


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_cuda_flash_fwd_with_infinite_and_near_max_values(causal):
    """K1: v holds +-inf and near-FLT_MAX values (o = sum p v / l is then
    +-inf, or finite; 0 . inf = NaN where a masked p meets an infinite v
    in the plain version)."""
    _need_cuda()
    B, S, H, D = 2, 192, 2, 64
    g = torch.Generator(device="cuda").manual_seed(17)
    q, k, v = (torch.randn(B, S, H, D, device="cuda", generator=g)
               for _ in range(3))
    row = S * H * D
    v = _special_like(v, {5 * H * D + 3: _INF, row + 100 * H * D + 7: _NINF,
                          150 * H * D + 64 + 9: _NEAR,
                          row + 70 * H * D + 11: _NEAR | 0x80000000})
    o, lse = tk.flash_attention_fwd(q, k, v, causal)
    ro, rlse = tk.flash_attention_fwd_reference(q, k, v, causal)
    torch.cuda.synchronize()
    assert _assert_special_close(o, ro, 1e-5, 1e-5, "o") > 0
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_cuda_flash_bwd_with_infinite_values(causal):
    """K2 (dq and dk/dv): dO holds +-inf and a near-FLT_MAX value; dv =
    sum p dO and dk, dq through ds = p (dO . v - di) carry them."""
    _need_cuda()
    B, S, H, D = 2, 192, 2, 64
    g = torch.Generator(device="cuda").manual_seed(19)
    q, k, v, do = (torch.randn(B, S, H, D, device="cuda", generator=g)
                   for _ in range(4))
    row = S * H * D
    do = _special_like(do, {9 * H * D + 2: _INF,
                            row + 130 * H * D + 5: _NINF,
                            60 * H * D + 64 + 1: _NEAR})
    ro, rlse = tk.flash_attention_fwd_reference(q, k, v, causal)
    di = tk._flash_di(ro, do)
    dq = tk.flash_attention_bwd_dq(q, k, v, do, rlse, di, causal)
    dk, dv = tk.flash_attention_bwd_dkv(q, k, v, do, rlse, di, causal)
    rdq = tk.flash_attention_bwd_dq_reference(q, k, v, do, rlse, di, causal)
    rdk, rdv = tk.flash_attention_bwd_dkv_reference(q, k, v, do, rlse, di,
                                                    causal)
    torch.cuda.synchronize()
    infs = 0
    for what, got, want in (("dq", dq, rdq), ("dk", dk, rdk),
                            ("dv", dv, rdv)):
        infs += _assert_special_close(got, want, 1e-4, 1e-4, what)
    assert infs > 0


@pytest.mark.cuda
@pytest.mark.parametrize("stride,branch", [(1, False), (2, True)])
def test_cuda_fp32_bottleneck_with_infinite_and_near_max_values(stride,
                                                                branch):
    """fp32 K6: x holds +inf, -inf and near-FLT_MAX pixels.  The filters
    are nonnegative, so a +inf pixel stays +inf through the three
    convolutions (a mix of signs would sum +inf and -inf to NaN in both
    versions) and a -inf one is cut to 0 by the relus."""
    _need_cuda()
    N, H, W, C, F = 2, 12, 10, 16, 8
    C4 = 4 * F if branch else C
    g = torch.Generator(device="cuda").manual_seed(23)

    def t(*shape):
        return torch.randn(*shape, device="cuda", generator=g) * 0.1

    def w_(*shape):
        return t(*shape).abs()

    w = [w_(F, C, 1, 1), t(F), w_(F, F, 3, 3), t(F), w_(C4, F, 1, 1),
         t(C4)]
    ws = [w_(C4, C, 1, 1), t(C4)] if branch else [None, None]
    x = torch.randn(N, H, W, C, device="cuda", generator=g)
    pix = W * C
    x = _special_like(x, {2 * pix + 4 * C + 1: _INF,
                          H * pix + 8 * pix + 6 * C + 4: _NINF,
                          H * pix + 4 * pix + 2 * C + 3: _INF,
                          8 * pix + 8 * C + 2: _NEAR})
    out = tk.fused_bottleneck(x, *w, *ws, stride=stride)
    ref = tk.bottleneck_reference(x, *w, *ws, stride)
    torch.cuda.synchronize()
    assert _assert_special_close(out, ref, 1e-4, 1e-4, "out") > 0


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(64, 2048, 1000), (256, 512, 384)])
def test_cuda_fp32_x_dequant_matmul_with_infinite_and_near_max_values(M, K,
                                                                      N):
    """K5 with fp32 x: rows of x hold +-inf, NaN and near-FLT_MAX values;
    the int8 weight rows they meet are +-1 (no zero: inf . 0 would be NaN
    in both)."""
    _need_cuda()
    rng = np.random.RandomState(M + K)
    x = torch.from_numpy(rng.randn(M, K).astype(np.float32)).cuda()
    w = rng.randint(-127, 128, size=(K, N)).astype(np.int8)
    for r in (5, 9, 13):
        w[r] = np.where(rng.rand(N) < 0.5, -1, 1)
    w = torch.from_numpy(w).cuda()
    s = torch.from_numpy((rng.rand(N) * 0.01 + 1e-3).astype(np.float32)
                         ).cuda()
    x = _special_like(x, {3 * K + 5: _INF, 7 * K + 9: _NINF,
                          11 * K + 13: _NEAR, 20 * K + 13: 0x7FC00000})
    out = tk.dequant_matmul(x, w, s)
    ref = tk.dequant_matmul_reference(x, w, s)
    torch.cuda.synchronize()
    assert _assert_special_close(out, ref, 1e-5, 1e-5, "out") > 0
