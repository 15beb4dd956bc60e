"""K6 and FuseBottleneckPass: paddle_tpu_torch against paddle_tpu on the CPU.

The port's plain version of the fused bottleneck is held against the JAX
kernel run in interpret mode at the JAX package's own five test shapes
(atol/rtol 1e-4, as that package's test holds its kernel against its
reference); the port's inference rewrites (BN fold + FuseBottleneckPass)
produce the JAX package's program op for op at gates 0, 4 and 8, with the
same folded weights and the same outputs; the CUDA kernel is held
against the plain version on the card (marked `cuda`).  K6's bf16
variant: the plain version against the JAX kernel run in bf16 at the same
five shapes, and the fp32 plain version unchanged bit for bit."""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.flags import get_flags, set_flags
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.ops import pallas_kernels as jkernels
from paddle_tpu_torch.flags import FLAGS as TFLAGS
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.ops import pallas_kernels as tkernels

SHAPES = [(2, 8, 8, 32, 16, 1, False),      # identity shortcut
          (2, 8, 8, 32, 16, 1, True),       # projection, stride 1
          (2, 8, 8, 32, 16, 2, True),       # projection, stride 2
          (1, 14, 14, 64, 32, 2, True),     # odd output rows (Ho=7)
          (1, 7, 7, 128, 32, 1, False)]     # odd everything


def _params(rng, C, F, C4, branch):
    t = lambda *s: rng.randn(*s).astype(np.float32) * 0.1
    p = dict(w0=t(C, F), b0=t(F), w1=t(3, 3, F, F), b1=t(F),
             w2=t(F, C4), b2=t(C4))
    p["ws"], p["bs"] = (t(C, C4), t(C4)) if branch else (None, None)
    return p


_ORDER = ("w0", "b0", "w1", "b1", "w2", "b2", "ws", "bs")


def _as_torch(p):
    """The JAX layouts (w0 [C, F], w1 [3, 3, F, F] HWIO, w2 [F, C4], ws
    [C, C4]) as the port's OIHW filters, in _ORDER."""
    oihw = {"w1": lambda w: w.transpose(3, 2, 0, 1)}
    mat = lambda w: w.T[:, :, None, None]
    out = []
    for k in _ORDER:
        if p[k] is None:
            out.append(None)
            continue
        w = p[k] if k.startswith("b") else oihw.get(k, mat)(p[k])
        out.append(torch.from_numpy(np.ascontiguousarray(w)))
    return out


@pytest.mark.parametrize("N,H,W,C,F,stride,branch", SHAPES)
def test_reference_matches_jax_kernel(N, H, W, C, F, stride, branch):
    rng = np.random.RandomState(0)
    C4 = F * 4 if branch else C
    p = _params(rng, C, F, C4, branch)
    x = rng.randn(N, H, W, C).astype(np.float32)
    want = np.asarray(jkernels.fused_bottleneck(
        x, *(p[k] for k in _ORDER[:6]), p["ws"], p["bs"], stride=stride,
        interpret=True))
    got = tkernels.bottleneck_reference(torch.from_numpy(x), *_as_torch(p),
                                        stride).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    # the wrapper on a CPU tensor is the plain version
    entry = tkernels.fused_bottleneck(torch.from_numpy(x), *_as_torch(p),
                                      stride=stride).numpy()
    np.testing.assert_array_equal(entry, got)


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


# K6-bf16 against JAX: both sum in fp32, in other orders, so an
# intermediate a or h element may round to the neighbouring bf16 value (up
# to 2^-8 of max |out| downstream) and an output element sit one bf16 ulp
# (2^-7 relative) apart
def _assert_bf16_close(got, want):
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7,
                               atol=2.0 ** -8 * float(np.abs(want).max()))


@pytest.mark.parametrize("N,H,W,C,F,stride,branch", SHAPES)
def test_bf16_reference_matches_jax_kernel(N, H, W, C, F, stride, branch):
    """K6-bf16: the JAX kernel (interpret mode, as the JAX package's
    test_kernel_bf16 runs it) on bf16 x, filters and biases against the
    port's plain version on the same bf16 values."""
    import jax.numpy as jnp
    rng = np.random.RandomState(0)
    C4 = F * 4 if branch else C
    p = _params(rng, C, F, C4, branch)
    x = rng.randn(N, H, W, C).astype(np.float32)
    cast = lambda a: None if a is None else jnp.asarray(a, jnp.bfloat16)
    out = jkernels.fused_bottleneck(
        cast(x), *(cast(p[k]) for k in _ORDER), stride=stride,
        interpret=True)
    assert out.dtype == jnp.bfloat16
    want = np.asarray(out, np.float32)
    args = [None if t is None else t.to(torch.bfloat16)
            for t in _as_torch(p)]
    got = tkernels.bottleneck_reference(_bf16(x), *args, stride)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    _assert_bf16_close(got.float().numpy(), want)
    # the wrapper on a CPU tensor is the plain version
    entry = tkernels.fused_bottleneck(_bf16(x), *args, stride=stride)
    assert torch.equal(entry, got)


def test_bf16_mixed_call_casts_filters_like_jax():
    """bf16 x with fp32 filters and biases: the JAX reference casts each
    filter to x's dtype (`w.astype(v.dtype)`) and adds the fp32 biases in
    fp32, and so does the port's."""
    import jax.numpy as jnp
    rng = np.random.RandomState(5)
    p = _params(rng, 32, 16, 64, True)
    x = rng.randn(2, 8, 8, 32).astype(np.float32)
    want = np.asarray(jkernels.bottleneck_reference(
        jnp.asarray(x, jnp.bfloat16), *(p[k] for k in _ORDER), 2),
        np.float32)
    got = tkernels.bottleneck_reference(_bf16(x), *_as_torch(p), 2)
    assert got.dtype == torch.bfloat16
    _assert_bf16_close(got.float().numpy(), want)


@pytest.mark.parametrize("branch", [False, True])
def test_fp32_reference_is_unchanged_bit_for_bit(branch):
    """The rounding points are the identity in fp32: the plain version
    equals the three (four) convolutions written out."""
    import torch.nn.functional as F
    rng = np.random.RandomState(6)
    C, C4 = (32, 32) if not branch else (16, 32)
    p = _params(rng, C, 8, C4, branch)
    x = torch.from_numpy(rng.randn(2, 6, 6, C).astype(np.float32))
    w0, b0, w1, b1, w2, b2, ws, bs = _as_torch(p)
    s = 2 if branch else 1
    xc = x.permute(0, 3, 1, 2)
    a = torch.relu(F.conv2d(xc, w0) + b0.reshape(1, -1, 1, 1))
    h = torch.relu(F.conv2d(a, w1, stride=s, padding=1)
                   + b1.reshape(1, -1, 1, 1))
    y = F.conv2d(h, w2) + b2.reshape(1, -1, 1, 1)
    short = (F.conv2d(xc, ws, stride=s) + bs.reshape(1, -1, 1, 1)
             if branch else xc)
    want = torch.relu(y + short).permute(0, 2, 3, 1)
    got = tkernels.bottleneck_reference(x, w0, b0, w1, b1, w2, b2, ws, bs,
                                        s)
    assert torch.equal(got, want)


def test_wrapper_counts_no_launch_on_cpu():
    rng = np.random.RandomState(1)
    p = _params(rng, 16, 8, 32, True)
    x = torch.from_numpy(rng.randn(1, 6, 6, 16).astype(np.float32))
    tkernels.reset_launch_counts()
    tkernels.fused_bottleneck(x, *_as_torch(p), stride=2)
    tkernels.fused_bottleneck(x.to(torch.bfloat16),
                              *[t.to(torch.bfloat16) for t in _as_torch(p)],
                              stride=2)
    assert tkernels.launch_counts["fused_bottleneck"] == 0
    assert tkernels.launch_counts["fused_bottleneck_bf16"] == 0


def _tail(pkg, models, layout):
    """data -> bottleneck(stride 2, projection) -> bottleneck(identity),
    the JAX package's _build_resnet_tail."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        shape = [8, 8, 16] if layout == "NHWC" else [16, 8, 8]
        img = pkg.layers.data(name="img", shape=shape, dtype="float32")
        out = models.bottleneck_block(img, 8, 2, is_train=False,
                                      layout=layout)
        out = models.bottleneck_block(out, 8, 1, is_train=False,
                                      layout=layout)
    return main, startup, out


def _randomize_bn(program, jscope, rng):
    """Non-trivial batch-norm statistics, the same in both packages."""
    import jax.numpy as jnp
    for v in program.global_block().vars.values():
        if not v.persistable or not v.name.startswith("batch_norm"):
            continue
        kind = v.name.split(".")[-1]
        shape = np.asarray(jscope.get(v.name)).shape
        if kind.startswith("var"):
            a = 0.5 + rng.rand(*shape)
        elif kind.startswith("w_"):
            a = 0.5 + rng.rand(*shape)
        else:
            a = 0.3 * rng.randn(*shape)
        jscope.set(v.name, jnp.asarray(a.astype(np.float32)))


@pytest.fixture
def gate():
    old = get_flags("fuse_bottleneck_max_width")
    old_t = TFLAGS.fuse_bottleneck_max_width

    def set_gate(width):
        set_flags({"fuse_bottleneck_max_width": width})
        TFLAGS.fuse_bottleneck_max_width = width
    yield set_gate
    set_flags(old)
    TFLAGS.fuse_bottleneck_max_width = old_t


@pytest.mark.parametrize("layout,width,n_fused", [
    ("NHWC", 0, 0), ("NHWC", 4, 0), ("NHWC", 8, 2), ("NCHW", 8, 0)])
def test_pass_rewrites_what_the_jax_pass_rewrites(layout, width, n_fused,
                                                  gate):
    jm, js, jout = _tail(jfluid, jresnet, layout)
    tm, _, tout = _tail(tfluid, tresnet, layout)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    rng = np.random.RandomState(3)
    with jfluid.scope_guard(jscope):
        jexe.run(js)
    _randomize_bn(jm, jscope, rng)
    init = {n: np.asarray(jscope.get(n)) for n in jscope.keys()}
    tscope = tfluid.scope_from_jax(init, tfluid.Scope(), tfluid.CPUPlace())
    gate(width)
    jinfer, tinfer = jm.clone(for_test=True), tm.clone(for_test=True)
    jfluid.transpiler.InferenceTranspiler().transpile(jinfer, scope=jscope)
    tfluid.InferenceTranspiler().transpile(tinfer, scope=tscope)
    jops = [(o.type, o.inputs, o.outputs, o.attrs)
            for o in jinfer.global_block().ops]
    tops = [(o.type, o.inputs, o.outputs, o.attrs)
            for o in tinfer.global_block().ops]
    assert tops == jops
    assert [o[0] for o in tops].count("fused_bottleneck") == n_fused
    assert list(tinfer.global_block().vars) == \
        list(jinfer.global_block().vars)
    # the BN fold rewrote the same filters and biases in both scopes
    for name in tscope.keys():
        if name.endswith("@bn_folded_bias") or ".w_" in name:
            np.testing.assert_allclose(
                tscope.get(name).numpy(), np.asarray(jscope.get(name)),
                rtol=1e-6, atol=1e-7, err_msg=name)
    shape = (4, 8, 8, 16) if layout == "NHWC" else (4, 16, 8, 8)
    x = rng.randn(*shape).astype(np.float32)
    with jfluid.scope_guard(jscope):
        want, = jexe.run(jinfer, feed={"img": x}, fetch_list=[jout.name])
    with tfluid.scope_guard(tscope):
        got, = tfluid.Executor(tfluid.CPUPlace()).run(
            tinfer, feed={"img": x}, fetch_list=[tout.name])
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


def test_pass_declines_an_inline_conv_bias(gate):
    """The fused op has no slot for a conv's own Bias: in a BN-folded
    program where one conv carries one, that block stays unfused and the
    clean block fuses, in both packages alike."""
    jm, js, _ = _tail(jfluid, jresnet, "NHWC")
    tm, _, _ = _tail(tfluid, tresnet, "NHWC")
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jfluid.Executor(jfluid.CPUPlace()).run(js)
    init = {n: np.asarray(jscope.get(n)) for n in jscope.keys()}
    tscope = tfluid.scope_from_jax(init, tfluid.Scope(), tfluid.CPUPlace())
    gate(8)
    progs = []
    for pkg, main, scope in ((jfluid, jm, jscope), (tfluid, tm, tscope)):
        infer = main.clone(for_test=True)
        it = pkg.transpiler.InferenceTranspiler()
        it._remove_dropout(infer)
        it._fuse_batch_norm(infer, scope)
        blk = infer.global_block()
        conv = next(op for op in blk.ops if op.type == "conv2d")
        blk.create_var(name="inline_bias", shape=(8,), dtype="float32",
                       persistable=True)
        conv.inputs["Bias"] = ["inline_bias"]
        pkg.ir_passes.apply_passes(infer, ["fuse_bottleneck_pass"])
        progs.append([(o.type, o.inputs, o.outputs) for o in blk.ops])
    assert progs[1] == progs[0]
    types = [o[0] for o in progs[1]]
    assert types.count("fused_bottleneck") == 1 and "conv2d" in types


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,W,C,F,stride,branch",
                         SHAPES + [(4, 56, 56, 64, 64, 1, True),
                                   (2, 28, 28, 512, 128, 1, False),
                                   (2, 56, 56, 256, 128, 2, True)])
def test_cuda_kernel_matches_plain_version(N, H, W, C, F, stride, branch):
    _need_cuda()
    rng = np.random.RandomState(2)
    C4 = F * 4 if branch else C
    p = _params(rng, C, F, C4, branch)
    x = torch.from_numpy(rng.randn(N, H, W, C).astype(np.float32)).cuda()
    args = [None if t is None else t.cuda() for t in _as_torch(p)]
    tkernels.reset_launch_counts()
    out = tkernels.fused_bottleneck(x, *args, stride=stride)
    torch.cuda.synchronize()
    assert tkernels.launch_counts["fused_bottleneck"] == 1
    ref = tkernels.bottleneck_reference(x, *args, stride)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


# the fused ResNet-50 path's four block geometries (H, C, F, stride,
# branch; C4 = 4 F), at batch 2
PATH_SHAPES = [(2, 56, 56, 64, 64, 1, True), (2, 56, 56, 256, 64, 1, False),
               (2, 56, 56, 256, 128, 2, True),
               (2, 28, 28, 512, 128, 1, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,W,C,F,stride,branch",
                         SHAPES + [(4, 56, 56, 64, 64, 1, True),
                                   (2, 28, 28, 512, 128, 1, False),
                                   (2, 56, 56, 256, 128, 2, True),
                                   (3, 9, 7, 24, 8, 2, True),
                                   (2, 7, 5, 40, 24, 1, False)]
                         + PATH_SHAPES)
def test_cuda_bf16_kernel_matches_plain_version(N, H, W, C, F, stride,
                                                branch):
    """K6-bf16 against the bf16 plain version on the same bf16 inputs, at
    the tolerance of the comparison with the JAX kernel (fp32 sums in
    other orders); an fp32 filter beside a bf16 x raises."""
    _need_cuda()
    rng = np.random.RandomState(2)
    C4 = F * 4 if branch else C
    p = _params(rng, C, F, C4, branch)
    x = _bf16(rng.randn(N, H, W, C).astype(np.float32)).cuda()
    args = [None if t is None else t.to(torch.bfloat16).cuda()
            for t in _as_torch(p)]
    tkernels.reset_launch_counts()
    out = tkernels.fused_bottleneck(x, *args, stride=stride)
    torch.cuda.synchronize()
    assert tkernels.launch_counts["fused_bottleneck_bf16"] == 1
    assert tkernels.launch_counts["fused_bottleneck"] == 0
    ref = tkernels.bottleneck_reference(x, *args, stride)
    assert out.dtype == torch.bfloat16
    _assert_bf16_close(out.float().cpu().numpy(), ref.float().cpu().numpy())
    with pytest.raises(TypeError, match="bfloat16"):
        tkernels.fused_bottleneck(x, args[0].float(), *args[1:],
                                  stride=stride)


@pytest.mark.cuda
def test_cuda_bf16_kernel_raises_on_channels_not_multiple_of_8():
    """The tensor-core K6-bf16 reads rows of 8 channels: a C, F or C4 that
    is not a multiple of 8 raises ValueError naming the constraint (fp32
    takes it)."""
    _need_cuda()
    rng = np.random.RandomState(3)
    for C, F, C4, branch in ((12, 8, 32, True), (16, 12, 48, True),
                             (20, 8, 20, False)):
        p = _params(rng, C, F, C4, branch)
        x = torch.from_numpy(rng.randn(1, 6, 6, C).astype(np.float32)).cuda()
        args = [None if t is None else t.cuda() for t in _as_torch(p)]
        s = 2 if branch else 1
        tkernels.fused_bottleneck(x, *args, stride=s)   # fp32: any width
        xb = x.to(torch.bfloat16)
        argsb = [None if t is None else t.to(torch.bfloat16) for t in args]
        with pytest.raises(ValueError, match="multiples of 8"):
            tkernels.fused_bottleneck(xb, *argsb, stride=s)


@pytest.mark.cuda
def test_cuda_k6_k5_bf16_run_on_tensor_cores():
    """The machine code of the bf16 K6 kernel and the bf16-x K5 kernels
    holds bf16 tensor-core instructions (HMMA for mma.sync, HGMMA for
    wgmma) and no other; the fp32 K6 kernel (3xTF32) and the fp32-x K5
    kernels (two TF32 products) hold TF32 HMMA and no other."""
    _need_cuda()
    from paddle_tpu_torch.ops import _build
    for stem, tc_tag, f32_tag, n_tc, n_f32, fp32 in (
            # fp32 K6: 128- and 64-row tiles
            ("fused_bottleneck", "bottleneck_tc_kernel", "bottleneck_kernel",
             1, 2, "tf32"),
            ("dequant_matmul", "dequant_matmul_tc_kernel",
             "dequant_matmul_kernel", 2, 2, "tf32")):  # fp32, bf16 outputs
        counts = _build.tensor_core_counts(stem)
        tc = [c for name, c in counts.items() if tc_tag in name]
        f32 = [c for name, c in counts.items() if f32_tag in name]
        assert (len(tc), len(f32)) == (n_tc, n_f32), (stem, sorted(counts))
        for want, found in (("bf16", tc), (fp32, f32)):
            for c in found:
                others = sum(v for k, v in c.items() if k != want)
                assert others == 0, (stem, want, c)
                assert want is None or c[want] > 0, (stem, want, c)


def _misaligned(t):
    """t's values in a contiguous tensor that starts 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,W,C,F,C4,stride,branch,shifted", [
    (2, 9, 7, 36, 20, 52, 2, True, False),
    (2, 9, 7, 44, 12, 44, 1, False, False),
    (1, 6, 5, 13, 7, 9, 2, True, False),     # odd widths: 4-byte staging
    (2, 8, 6, 32, 16, 64, 1, True, True),    # x and w0 4 bytes off 16
])
def test_cuda_fp32_kernel_takes_any_width_and_reruns_bit_identically(
        N, H, W, C, F, C4, stride, branch, shifted):
    """fp32 K6 (3xTF32 tensor-core tiles) at widths that are not multiples
    of 4 or 8, and on operands that are not 16-byte aligned, against the
    plain version at the fp32 tolerance (rtol/atol 1e-4); a second launch
    on the same inputs is bit-identical."""
    _need_cuda()
    rng = np.random.RandomState(4)
    p = _params(rng, C, F, C4, branch)
    x = torch.from_numpy(rng.randn(N, H, W, C).astype(np.float32)).cuda()
    args = [None if t is None else t.cuda() for t in _as_torch(p)]
    if shifted:
        x, args[0] = _misaligned(x), _misaligned(args[0])
    tkernels.reset_launch_counts()
    out = tkernels.fused_bottleneck(x, *args, stride=stride)
    again = tkernels.fused_bottleneck(x, *args, stride=stride)
    torch.cuda.synchronize()
    assert tkernels.launch_counts["fused_bottleneck"] == 2
    assert tkernels.launch_counts["fused_bottleneck_bf16"] == 0
    assert torch.equal(out, again)
    ref = tkernels.bottleneck_reference(x, *args, stride)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


# non-finite inputs: K6's relus keep a NaN, as the plain version's
# torch.relu and the JAX kernel's jnp.maximum do.  Two pixels of x hold
# the non-finite value; what they reach is the 3x3 neighbourhood (in
# output rows and columns, |s * o - h| <= 1), every output channel.
NAN_SHAPES = [(2, 9, 7, 32, 16, 1, False),   # identity shortcut
              (2, 9, 7, 32, 16, 1, True),    # projection, stride 1
              (2, 9, 7, 32, 16, 2, True)]    # projection, stride 2
NAN_PIXELS = [(0, 0, 0), (1, 4, 3)]


def _nonfinite_inputs(case, N, H, W, C, F, branch, dtype):
    """x and the OIHW filters with x non-finite at NAN_PIXELS, channel 5:
    "nan_x" puts a NaN there; "inside" puts +inf there, with w0's column
    for that channel positive (conv0 gives +inf, relu keeps it) and w1's
    input channels 0 and 1 of opposite signs at every tap, so the 3x3
    meets +inf - inf and makes the NaN inside the block."""
    rng = np.random.RandomState(6)
    C4 = F * 4 if branch else C
    args = _as_torch(_params(rng, C, F, C4, branch))
    x = torch.from_numpy(rng.randn(N, H, W, C).astype(np.float32))
    for n, h, w in NAN_PIXELS:
        x[n, h, w, 5] = float("nan") if case == "nan_x" else float("inf")
    if case == "inside":
        args[0][:, 5] = args[0][:, 5].abs()
        args[2][:, 0] = args[2][:, 0].abs()
        args[2][:, 1] = -args[2][:, 1].abs()
    return x.to(dtype), [None if t is None else t.to(dtype) for t in args]


def _neighbourhood(N, H, W, C4, s):
    Ho, Wo = (H - 1) // s + 1, (W - 1) // s + 1
    mask = np.zeros((N, Ho, Wo, C4), bool)
    for n, h, w in NAN_PIXELS:
        for o in range(Ho):
            for p in range(Wo):
                if abs(s * o - h) <= 1 and abs(s * p - w) <= 1:
                    mask[n, o, p] = True
    return mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["nan_x", "inside"])
@pytest.mark.parametrize("N,H,W,C,F,stride,branch", NAN_SHAPES)
def test_plain_version_keeps_nan_in_its_neighbourhood(
        N, H, W, C, F, stride, branch, case, dtype):
    """The plain version (what the card's K6 is held against) puts NaN
    at exactly the non-finite pixels' 3x3 neighbourhood, all channels,
    and finite values elsewhere."""
    x, args = _nonfinite_inputs(case, N, H, W, C, F, branch, dtype)
    ref = tkernels.bottleneck_reference(x, *args, stride).float().numpy()
    C4 = ref.shape[-1]
    mask = _neighbourhood(N, H, W, C4, stride)
    assert np.array_equal(np.isnan(ref), mask)
    assert np.isfinite(ref[~mask]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["nan_x", "inside"])
@pytest.mark.parametrize("N,H,W,C,F,stride,branch", NAN_SHAPES)
def test_cuda_kernel_keeps_nan_where_the_plain_version_does(
        N, H, W, C, F, stride, branch, case, dtype):
    """fp32 and bf16 K6 on a NaN in x (identity and projection
    shortcuts) and on a NaN made inside the block: NaN in the same output
    positions as the plain version (on the CPU), the other positions at
    the tolerances of the tests above; fp32 K6 reruns the blocks that
    met the NaN clamped (tc_common.cuh), once."""
    _need_cuda()
    x, args = _nonfinite_inputs(case, N, H, W, C, F, branch, dtype)
    ref = tkernels.bottleneck_reference(x, *args, stride).float().numpy()
    tkernels.reset_launch_counts()
    out = tkernels.fused_bottleneck(
        x.cuda(), *[None if t is None else t.cuda() for t in args],
        stride=stride)
    torch.cuda.synchronize()
    assert tkernels.launch_counts[_count_name(dtype)] == 1
    out = out.float().cpu().numpy()
    assert np.array_equal(np.isnan(out), np.isnan(ref))
    keep = ~np.isnan(ref)
    if dtype == torch.bfloat16:
        _assert_bf16_close(out[keep], ref[keep])
    else:
        np.testing.assert_allclose(out[keep], ref[keep], rtol=1e-4,
                                   atol=1e-4)


def _count_name(dtype):
    return "fused_bottleneck_bf16" if dtype == torch.bfloat16 \
        else "fused_bottleneck"
