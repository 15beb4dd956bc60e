"""The core tensor ops of paddle_tpu_torch (split, reshape, transpose(2),
shape, tile, flatten(2), expand_as, gather_nd, scatter, strided_slice,
unstack, reverse, range, linspace, assign_value) held against the JAX
lowerings on the CPU, forward and vjp, out-of-range and negative
indices included; the random ops (randint, truncated_gaussian_random,
uniform_random_batch_size_like) on shape, dtype, range and moments; the
layers against the JAX layers; the card twins against the CPU."""

import math

import numpy as np
import pytest
import torch

import torch_op_cases as cases
from test_torch_ops import RTOL, ATOL, _assert_parity, _rng_op
from torch_train_parity import Pair, build_both, program_ops

from paddle_tpu.ops import registry as jreg

_IDS = [c[0] for c in cases.TENSOR_CASES]


@pytest.mark.parametrize("case", cases.TENSOR_CASES, ids=_IDS)
def test_tensor_lowering_matches_jax_forward_and_vjp(case):
    inputs, rng = cases.case_inputs(case)
    _assert_parity(case[1], case[3], inputs, rng)


@pytest.mark.cuda
@pytest.mark.parametrize("case", cases.TENSOR_CASES, ids=_IDS)
def test_cuda_tensor_lowering_matches_cpu(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    worst, where = cases.max_mismatch(cases.run_case(case, "cuda"),
                                      cases.run_case(case, "cpu"),
                                      RTOL, ATOL)
    assert worst <= 0, (case[0], where, worst)


def _jax_draw(op_type, attrs, inputs):
    import jax.numpy as jnp
    op = cases.case_op(op_type, attrs, inputs)
    return np.asarray(jreg.get_op_def(op_type).lower(jreg.ExecContext(
        op, {s: [jnp.asarray(a) for a in v]
             for s, v in inputs.items()}))["Out"])


def _redraws_differ(op_type, attrs, inputs, out):
    assert torch.equal(out, _rng_op(op_type, attrs, inputs)["Out"])
    for kw in ({"step": 1}, {"uid": 4}, {"seed": 2}):
        assert not torch.equal(out, _rng_op(op_type, attrs, inputs,
                                            **kw)["Out"])


def test_randint_matches_jax_shape_dtype_range_and_moments():
    attrs = {"shape": [200, 50], "low": -3, "high": 7, "seed": 0}
    want = _jax_draw("randint", attrs, {})
    out = _rng_op("randint", attrs, {})["Out"]
    assert tuple(out.shape) == want.shape and out.dtype == torch.int64
    for a in (out.numpy(), want):
        assert a.min() == -3 and a.max() == 6
        assert abs(float(a.mean()) - 1.5) < 0.1
        counts = np.bincount(a.ravel() + 3, minlength=10)
        assert counts.min() > 0.85 * counts.mean()
    _redraws_differ("randint", attrs, {}, out)


def test_truncated_gaussian_random_matches_jax_bounds_and_moments():
    """N(0, 1) cut at +-2 (JAX's bounds), times std plus mean: the same
    range and the truncated normal's mean and std
    (std of N(0, 1) on [-2, 2]: 0.8796)."""
    attrs = {"shape": [256, 128], "dtype": cases.FP32, "mean": 0.5,
             "std": 0.3, "seed": 0}
    want = _jax_draw("truncated_gaussian_random", attrs, {})
    out = _rng_op("truncated_gaussian_random", attrs, {})["Out"]
    assert tuple(out.shape) == want.shape and out.dtype == torch.float32
    phi = math.exp(-2.0) / math.sqrt(2 * math.pi)
    tstd = math.sqrt(1 - 4 * phi / math.erf(2 / math.sqrt(2)))
    for a in (out.numpy(), want):
        assert a.min() >= 0.5 - 0.6 and a.max() <= 0.5 + 0.6
        assert a.min() < 0.5 - 0.59 and a.max() > 0.5 + 0.59
        assert abs(float(a.mean()) - 0.5) < 0.005
        assert abs(float(a.std()) - 0.3 * tstd) < 0.005
    _redraws_differ("truncated_gaussian_random", attrs, {}, out)


def test_uniform_random_batch_size_like_matches_jax():
    """The batch extent from Input's input_dim_idx into output_dim_idx,
    U[min, max) as the JAX lowering's."""
    ref = np.zeros((3, 37), np.float32)
    attrs = {"shape": [64, -1, 8], "input_dim_idx": 1, "output_dim_idx": 1,
             "min": -0.25, "max": 0.75, "dtype": cases.FP32, "seed": 0}
    want = _jax_draw("uniform_random_batch_size_like", attrs,
                     {"Input": [ref]})
    out = _rng_op("uniform_random_batch_size_like", attrs,
                  {"Input": [ref]})["Out"]
    assert tuple(out.shape) == want.shape == (64, 37, 8)
    assert out.dtype == torch.float32
    for a in (out.numpy(), want):
        assert a.min() >= -0.25 and a.max() < 0.75
        hist = np.histogram(a, bins=8, range=(-0.25, 0.75))[0]
        assert hist.min() > 0.85 * hist.mean()
    _redraws_differ("uniform_random_batch_size_like", attrs,
                    {"Input": [ref]}, out)


def _tensor_layers(pkg, main):
    L = pkg.layers
    x = L.data("x", shape=[4, 6], dtype="float32")
    idx = L.data("idx", shape=[2], dtype="int64")
    ids = L.data("ids", shape=[1], dtype="int64", append_batch_size=False)
    a, b, c = L.split(x, num_or_sections=[1, 2, 3], dim=-1)
    h, w = L.split(x, num_or_sections=2, dim=1)
    outs = [a, b, c, h, w, L.transpose(x, perm=[0, 2, 1]), L.flatten(x),
            L.flatten(x, axis=2), L.reverse(x, axis=[1]),
            L.gather_nd(x, idx), L.sum([x, x]),
            L.scatter(L.fill_constant([5, 6], "float32", 0.5), ids,
                      L.fill_constant([1, 6], "float32", 2.0))]
    outs += L.unstack(x, axis=1)
    ints = [L.shape(x), L.assign(np.arange(6, dtype=np.int64).reshape(2, 3))]
    floats = [L.ones([2, 3], "float32"),
              L.assign(np.array([[1.5, -2.0]], np.float32))]
    return outs + ints + floats


def test_tensor_layers_build_the_jax_ops_and_agree():
    built = build_both(_tensor_layers)
    assert program_ops(built["torch"][0]) == program_ops(built["jax"][0])
    rng = np.random.RandomState(1)
    feed = {"x": rng.randn(3, 4, 6).astype(np.float32),
            "idx": np.array([[0, 1], [2, 5], [-1, 3]], np.int64),
            "ids": np.array([3], np.int64)}
    jr, tr = Pair(built).step(feed, built["torch"][2])
    for i, (j, t) in enumerate(zip(jr, tr)):
        if j.dtype.kind in "iu":   # x64 off: int64 comes back int32
            t = t.astype(j.dtype)
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL,
                                   err_msg="fetch %d" % i)


def test_create_tensor_random_and_range_layers_build_the_jax_ops():
    """create_tensor, range, linspace and the random layers append the
    JAX layers' ops.  The random values differ by design (threefry vs
    torch's generators); range and linspace run on the port only, as
    the JAX lowerings fail on their own layers' [1] bounds (float() of
    a 1-element array)."""
    def fn(pkg, main):
        L = pkg.layers
        x = L.data("x", shape=[3], dtype="float32")
        t = L.create_tensor("float32", name="made")
        L.assign(x, t)
        return [t, L.range(1, 10, 2, "int64"),
                L.linspace(-1.0, 2.0, 7, "float32"),
                L.uniform_random([2, 3], min=-2.0, max=2.0, seed=3),
                L.gaussian_random([4], mean=1.0, std=0.5),
                L.uniform_random_batch_size_like(x, [-1, 5]),
                L.gaussian_random_batch_size_like(x, [-1, 2], std=0.1)]
    built = build_both(fn)
    assert program_ops(built["torch"][0]) == program_ops(built["jax"][0])
    main, startup, outs = built["torch"]
    assert outs[0].name == "made"
    import paddle_tpu_torch.fluid as tfluid
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    made, rng_, lin, uni, gau, ubl, gbl = exe.run(
        main, feed={"x": x}, fetch_list=outs, scope=scope)
    np.testing.assert_array_equal(made, x)
    np.testing.assert_array_equal(rng_, np.arange(1, 10, 2))
    np.testing.assert_allclose(lin, np.linspace(-1.0, 2.0, 7), rtol=1e-6)
    assert uni.shape == (2, 3) and np.abs(uni).max() <= 2.0
    assert gau.shape == (4,) and ubl.shape == (2, 5) and gbl.shape == (2, 2)
    # gaussian_random_batch_size_like appends JAX's uniform op: U[-1, 1)
    assert np.abs(gbl).max() < 1.0
