"""K5 and the dequant_* op lowerings: paddle_tpu_torch against paddle_tpu
on the CPU.

The port's plain dequant-matmul is held against the JAX kernel (Pallas in
interpret mode, at tileable shapes with explicit blocks) and against the
JAX reference (N = 1000, which no block edge divides), for fp32 and bf16
activations: bf16 x int8 products are exact in fp32 in both, so the two
agree up to the order of fp32 sums (rtol 1e-5, atol 1e-5 x max |ref|).
The three quantized op lowerings run in one-op programs of each package
on the same inputs.  The CUDA kernel is held against the plain version on
the card (marked `cuda`)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.ops import pallas_kernels as jkernels
from paddle_tpu_torch.ops import pallas_kernels as tkernels


def _inputs(rng, M, K, N):
    x = rng.randn(M, K).astype(np.float32)
    w = rng.randint(-127, 128, size=(K, N)).astype(np.int8)
    s = (rng.rand(N) * 0.01 + 1e-3).astype(np.float32)
    return x, w, s


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def _port(x, w, s, dtype, out_dtype=None):
    xt = torch.from_numpy(x).to(dtype)
    return tkernels.dequant_matmul(xt, torch.from_numpy(w),
                                   torch.from_numpy(s), out_dtype=out_dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,blocks", [(16, 64, 128, (8, 32, 128)),
                                          (32, 128, 256, (16, 64, 128))])
def test_plain_version_matches_jax_kernel(dtype, M, K, N, blocks):
    x, w, s = _inputs(np.random.RandomState(M + K), M, K, N)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = jkernels.dequant_matmul(jx, w, s, out_dtype=jnp.float32,
                                   block_m=blocks[0], block_k=blocks[1],
                                   block_n=blocks[2], interpret=True)
    got = _port(x, w, s, getattr(torch, dtype), torch.float32)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    _close(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_jax_reference_at_n1000(dtype):
    """The ResNet fc's shape: x [M, 2048], N = 1000."""
    x, w, s = _inputs(np.random.RandomState(5), 8, 2048, 1000)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = jkernels.dequant_matmul_reference(jx, w, s,
                                             out_dtype=jnp.float32)
    got = _port(x, w, s, getattr(torch, dtype), torch.float32)
    _close(got.numpy(), want)
    # the default output dtype is x's
    assert _port(x, w, s, getattr(torch, dtype)).dtype == \
        getattr(torch, dtype)


def test_bf16_output_rounds_like_jax():
    x, w, s = _inputs(np.random.RandomState(6), 4, 96, 40)
    want = np.asarray(jkernels.dequant_matmul_reference(
        jnp.asarray(x, jnp.bfloat16), w, s,
        out_dtype=jnp.bfloat16)).astype(np.float32)
    got = _port(x, w, s, torch.bfloat16, torch.bfloat16).float().numpy()
    # one bf16 ulp where the fp32 sums, in another order, straddle a
    # rounding boundary
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-6)


def test_every_int8_value_is_exact_in_tf32():
    """TF32 keeps 10 of fp32's 23 mantissa bits: an int8 weight's fp32
    bit pattern has its low 13 bits clear, so the fp32-x kernel feeds it
    to the TF32 tensor cores unsplit."""
    bits = np.arange(-128, 128, dtype=np.float32).view(np.uint32)
    assert not (bits & np.uint32(0x1fff)).any()


def _tf32(bits):
    return (bits & np.uint32(0xffffe000)).view(np.float32)


@pytest.mark.parametrize("K", [512, 2048])
def test_two_tf32_products_hold_fp32_x_to_the_kernel_tolerance(K):
    """The fp32-x kernel's arithmetic, emulated exactly in float64: x =
    big + small, big rounded to nearest TF32 (add 0x1000, clear the low
    13 bits), small the fp32 remainder of which the tensor core reads the
    top 19 bits; out = (small . w + big . w) * scale.  It holds the plain
    version at the kernel's tolerance, and big . w alone does not."""
    x, w, s = _inputs(np.random.RandomState(K), 16, K, 48)
    bits = x.view(np.uint32)
    big = _tf32(bits + np.uint32(0x1000))
    small = _tf32((x - big).view(np.uint32))
    wd = w.astype(np.float64)
    ref = tkernels.dequant_matmul_reference(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(s))
    two = (small.astype(np.float64) @ wd + big.astype(np.float64) @ wd) * s
    _close(two, ref.numpy())
    with pytest.raises(AssertionError):
        _close((big.astype(np.float64) @ wd) * s, ref.numpy())


def test_wrapper_rejects_nothing_on_cpu_and_counts_no_launch():
    x, w, s = _inputs(np.random.RandomState(7), 3, 17, 5)
    tkernels.reset_launch_counts()
    _port(x, w, s, torch.float32)
    assert tkernels.launch_counts["dequant_matmul"] == 0


# ---------------------------------------------------------------------------
# the dequant_* op lowerings, one op per program in each package
# ---------------------------------------------------------------------------

def _run_op(pkg, op_type, feeds, params, inputs, out_slot, attrs):
    """One-op program: `feeds` fed, `params` persistable in the scope;
    returns the op's output as numpy."""
    main = pkg.Program()
    gb = main.global_block()
    for name, arr in list(feeds.items()) + list(params.items()):
        gb.create_var(name=name, shape=list(arr.shape), dtype=str(arr.dtype),
                      persistable=name in params)
    gb.create_var(name="out", dtype="float32")
    gb.append_op(type=op_type,
                 inputs={slot: [name] for slot, name in inputs.items()},
                 outputs={out_slot: ["out"]}, attrs=attrs)
    scope = pkg.Scope()
    if pkg is jfluid:
        for name, arr in params.items():
            scope.set(name, jnp.asarray(arr))
        exe = pkg.Executor(pkg.CPUPlace())
    else:
        for name, arr in params.items():
            scope.set(name, torch.from_numpy(arr))
        exe = pkg.Executor(pkg.CPUPlace())
    with pkg.scope_guard(scope):
        out, = exe.run(main, feed=feeds, fetch_list=["out"])
    return np.asarray(out)


def _both(op_type, feeds, params, inputs, out_slot, attrs):
    want = _run_op(jfluid, op_type, feeds, params, inputs, out_slot, attrs)
    got = _run_op(tfluid, op_type, feeds, params, inputs, out_slot, attrs)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    return got, want


def test_dequant_mul_op_matches_jax():
    rng = np.random.RandomState(8)
    x = rng.randn(3, 2, 24).astype(np.float32)
    _, w, s = _inputs(rng, 1, 48, 10)
    got, want = _both("dequant_mul", {"x": x}, {"w": w, "s": s},
                      {"X": "x", "Y": "w", "Scale": "s"}, "Out",
                      {"x_num_col_dims": 1, "act_dtype": "bfloat16"})
    assert got.shape == (3, 10)
    _close(got, want)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_dequant_conv2d_op_matches_jax(layout, with_bias):
    rng = np.random.RandomState(9)
    shape = (2, 6, 7, 7) if layout == "NCHW" else (2, 7, 7, 6)
    x = rng.randn(*shape).astype(np.float32)
    w = rng.randint(-127, 128, size=(5, 6, 3, 3)).astype(np.int8)
    s = (rng.rand(5) * 0.02).astype(np.float32)
    params = {"w": w, "s": s}
    inputs = {"Input": "x", "Filter": "w", "Scale": "s"}
    if with_bias:
        params["b"] = rng.randn(5).astype(np.float32)
        inputs["Bias"] = "b"
    got, want = _both("dequant_conv2d", {"x": x}, params, inputs, "Output",
                      {"strides": [2, 2], "paddings": [1, 1],
                       "dilations": [1, 1], "groups": 1,
                       "data_format": layout, "act_dtype": "bfloat16"})
    _close(got, want)


def test_dequant_lookup_table_op_matches_jax():
    rng = np.random.RandomState(10)
    ids = rng.randint(0, 20, size=(6, 1)).astype(np.int64)
    ids[2, 0] = 3
    w = rng.randint(-127, 128, size=(20, 8)).astype(np.int8)
    s = (rng.rand(20) * 0.05).astype(np.float32)
    got, want = _both("dequant_lookup_table", {"ids": ids}, {"w": w, "s": s},
                      {"Ids": "ids", "W": "w", "Scale": "s"}, "Out",
                      {"padding_idx": 3})
    assert got.shape == (6, 8)
    assert not got[2].any()
    np.testing.assert_array_equal(got, want)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,dtype", [(64, 2048, 1000, torch.bfloat16),
                                         (128, 512, 2048, torch.float32),
                                         (37, 300, 77, torch.bfloat16)])
def test_cuda_kernel_matches_plain_version(M, K, N, dtype):
    _need_cuda()
    x, w, s = _inputs(np.random.RandomState(11), M, K, N)
    xt = torch.from_numpy(x).to(dtype).cuda()
    wt, st = torch.from_numpy(w).cuda(), torch.from_numpy(s).cuda()
    tkernels.reset_launch_counts()
    out = tkernels.dequant_matmul(xt, wt, st, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert tkernels.launch_counts["dequant_matmul"] == 1
    ref = tkernels.dequant_matmul_reference(xt, wt, st,
                                            out_dtype=torch.float32)
    torch.testing.assert_close(out, ref, rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(64, 2048, 1000),   # the int8 lane's fc
                                   (1, 2048, 1000), (37, 300, 77),
                                   (65, 129, 250), (100, 24, 65),
                                   (130, 1000, 130), (8, 4096, 16)])
def test_cuda_bf16_x_kernel_matches_plain_version(M, K, N, out_dtype):
    """K5 with bf16 x on the tensor cores at the path's shape and ragged
    M, K and N (rows copied 16, 8, 4, 2 or 1 bytes at a time, split K or
    not): fp32 sums in another order, and a bf16 output one ulp apart."""
    _need_cuda()
    x, w, s = _inputs(np.random.RandomState(M + K + N), M, K, N)
    xt = torch.from_numpy(x).to(torch.bfloat16).cuda()
    wt, st = torch.from_numpy(w).cuda(), torch.from_numpy(s).cuda()
    tkernels.reset_launch_counts()
    out = tkernels.dequant_matmul(xt, wt, st, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert tkernels.launch_counts["dequant_matmul"] == 1
    assert out.dtype == out_dtype and tuple(out.shape) == (M, N)
    ref = tkernels.dequant_matmul_reference(xt, wt, st, out_dtype=out_dtype)
    rtol = 2.0 ** -7 if out_dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                               atol=1e-5 * float(ref.float().abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,out_dtype", [
    (64, 2048, 1000, torch.float32),    # the ResNet fc, split K
    (4096, 512, 2048, torch.float32),   # a transformer fc
    (37, 300, 77, torch.float32),       # ragged M, K, N
    (65, 129, 250, torch.float32),      # K % 4 != 0: 4-byte x pieces
    (50, 129, 250, torch.bfloat16)])
def test_cuda_fp32_x_kernel_matches_plain_version(M, K, N, out_dtype):
    """K5 with fp32 x on the TF32 tensor cores (two products, partial sums
    promoted per K chunk) at the fp32 tolerance, and a bf16 output one ulp
    apart."""
    _need_cuda()
    x, w, s = _inputs(np.random.RandomState(M + K + N), M, K, N)
    xt, wt, st = (torch.from_numpy(a).cuda() for a in (x, w, s))
    tkernels.reset_launch_counts()
    out = tkernels.dequant_matmul(xt, wt, st, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert tkernels.launch_counts["dequant_matmul"] == 1
    assert out.dtype == out_dtype and tuple(out.shape) == (M, N)
    ref = tkernels.dequant_matmul_reference(xt, wt, st, out_dtype=out_dtype)
    rtol = 2.0 ** -7 if out_dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                               atol=1e-5 * float(ref.float().abs().max()))
