"""The core math ops of paddle_tpu_torch (reductions, arg and sort ops,
log_softmax, l2_normalize, the finiteness checks, floordiv, the logical
ops and the activations) held against the JAX lowerings on the CPU,
forward and vjp, on seeded inputs and on their edge values (ties, NaNs,
kinks); their layers build the JAX package's ops and agree when run;
the card twins hold the card against the CPU."""

import numpy as np
import pytest
import torch

import torch_op_cases as cases
from test_torch_ops import RTOL, ATOL, _assert_parity
from torch_train_parity import Pair, build_both, program_ops

from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.ops import registry as treg

_IDS = [c[0] for c in cases.MATH_CASES]


@pytest.mark.parametrize("case", cases.MATH_CASES, ids=_IDS)
def test_math_lowering_matches_jax_forward_and_vjp(case):
    inputs, rng = cases.case_inputs(case)
    _assert_parity(case[1], case[3], inputs, rng)


@pytest.mark.cuda
@pytest.mark.parametrize("case", cases.MATH_CASES, ids=_IDS)
def test_cuda_math_lowering_matches_cpu(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    worst, where = cases.max_mismatch(cases.run_case(case, "cuda"),
                                      cases.run_case(case, "cpu"),
                                      RTOL, ATOL)
    assert worst <= 0, (case[0], where, worst)


def test_cast_to_int64_keeps_the_ports_int64():
    """The deliberate int64 difference: the JAX package (x64 off) casts to
    int32 and saturates at int32's limits, the port keeps int64 and
    saturates at int64's.  They agree wherever the value fits in int32;
    NaN is 0 in both."""
    x = np.array([3e10, -3e10, np.nan, np.inf, -np.inf, 1e3, -2.5, 7e4,
                  2.1e9, -2.1e9], np.float32)
    op = cases.case_op("cast", {"in_dtype": cases.FP32,
                                "out_dtype": cases.INT64}, {"X": [x]})
    import jax.numpy as jnp
    want = np.asarray(jreg.get_op_def("cast").lower(
        jreg.ExecContext(op, {"X": [jnp.asarray(x)]}))["Out"])
    got = treg.get_op_def("cast").lower(treg.ExecContext(
        op, {"X": [torch.from_numpy(x)]}, device="cpu"))["Out"]
    assert got.dtype == torch.int64 and want.dtype == np.int32
    got = got.numpy()
    fits = np.abs(np.nan_to_num(x)) < 2 ** 31
    np.testing.assert_array_equal(got[fits], want[fits])
    i64 = np.iinfo(np.int64)
    big = int(np.float32(3e10))   # 30000001024
    np.testing.assert_array_equal(got[~fits], [big, -big, i64.max, i64.min])
    np.testing.assert_array_equal(want[~fits], [2 ** 31 - 1, -2 ** 31,
                                                2 ** 31 - 1, -2 ** 31])


def _math_layers(pkg, main):
    L = pkg.layers
    x = L.data("x", shape=[4, 6], dtype="float32")
    b = L.data("b", shape=[6], dtype="bool")
    outs = [L.reduce_mean(x, dim=1), L.reduce_max(x, dim=[1, 2]),
            L.reduce_min(x), L.reduce_prod(x, dim=-1, keep_dim=True),
            L.l2_normalize(x, axis=2), L.relu6(x), L.leaky_relu(x, 0.1),
            L.elu(x, 0.5), L.brelu(x, 0.1, 1.0), L.soft_relu(x, 2.0),
            L.hard_sigmoid(x), L.swish(x, 2.0), L.stanh(x, 0.5, 1.2),
            L.logsigmoid(x), L.softplus(x), L.softsign(x),
            L.tanh_shrink(x), L.softshrink(x, **{"lambda": 0.3}),
            L.hard_shrink(x, threshold=0.4), L.thresholded_relu(x, 0.2),
            L.erf(x), L.round(x), L.reciprocal(L.exp(x)),
            L.rsqrt(L.exp(x)), L.sign(x), L.gelu(x)]
    ints = [L.argmax(x, axis=1), L.argmin(x, axis=-1),
            L.argsort(x, axis=1)[1]]
    bools = [L.isfinite(x), L.has_inf(x), L.has_nan(x),
             L.logical_and(b, L.logical_not(b)), L.logical_or(b, b),
             L.logical_xor(b, L.logical_not(b))]
    loss = L.mean(L.sums([L.reduce_sum(o) for o in outs]))
    return outs + ints + bools + [loss]


def test_math_layers_build_the_jax_ops_and_agree():
    """Each layer appends the JAX layer's ops (types, var names, attrs),
    and the forward of the whole program agrees with the JAX Executor's
    on one seeded feed."""
    built = build_both(_math_layers)
    assert program_ops(built["torch"][0]) == program_ops(built["jax"][0])
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(3, 4, 6).astype(np.float32),
            "b": rng.rand(3, 6) < 0.5}
    pair = Pair(built)
    jr, tr = pair.step(feed, built["torch"][2])
    for i, (j, t) in enumerate(zip(jr, tr)):
        if j.dtype.kind in "iu":   # x64 off: int64 comes back int32
            t = t.astype(j.dtype)
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL,
                                   err_msg="fetch %d" % i)
