"""bf16 serving of the fused ResNet (K6's bf16 variant) through the
Executor: paddle_tpu_torch against paddle_tpu on the CPU.

The JAX package's bf16 route (tools/bench_infer.py): fold batch norm and
fuse the bottlenecks in fp32, cast every fp32 persistable of the scope to
bf16, retype the `data` feed to bfloat16 and run the Executor.  A small
NHWC ResNet — conv + BN stem, 3x3/2 max pool, three bottlenecks of width
8 (projection, projection at stride 2, identity), global average pool
over a 4 x 4 window, fc and softmax — goes that route in both packages
from one startup scope, fused (gate 8) and unfused (gate 0).  Under AMP
alone the same fused program hands `fused_bottleneck` fp32 in both
packages: the folded stem's bf16 conv output meets its fp32 bias and
promotes, and `fused_bottleneck` is not on the AMP white list."""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.flags import get_flags, set_flags
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.ops import pallas_kernels as jkernels
from paddle_tpu_torch.flags import FLAGS as TFLAGS
from paddle_tpu_torch.fluid.executor import as_numpy
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.ops import pallas_kernels as tkernels

BF16 = ml_dtypes.bfloat16


def _small_resnet(pkg, models):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        img = pkg.layers.data(name="data", shape=[16, 16, 3],
                              dtype="float32")
        x = models.conv_bn_layer(img, 16, 3, 1, 1, is_train=False,
                                 layout="NHWC")
        x = pkg.layers.pool2d(input=x, pool_size=3, pool_stride=2,
                              pool_padding=1, pool_type="max",
                              data_format="NHWC")
        for stride in (1, 2, 1):
            x = models.bottleneck_block(x, 8, stride, is_train=False,
                                        layout="NHWC")
        pool = pkg.layers.pool2d(input=x, pool_type="avg",
                                 global_pooling=True, data_format="NHWC")
        out = pkg.layers.fc(input=pool, size=10, act="softmax")
    return main, startup, out


def _randomize_bn(program, jscope, rng):
    """Non-trivial batch-norm statistics, the same in both packages."""
    for v in program.global_block().vars.values():
        if not v.persistable or not v.name.startswith("batch_norm"):
            continue
        kind = v.name.split(".")[-1]
        shape = np.asarray(jscope.get(v.name)).shape
        a = 0.5 + rng.rand(*shape) if kind.startswith(("var", "w_")) \
            else 0.3 * rng.randn(*shape)
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
    jfluid.set_amp(False)
    tfluid.set_amp(False)


@pytest.fixture
def spies(monkeypatch):
    """The (x, w0) dtypes every fused_bottleneck call receives, per
    package (the JAX op is traced: its dtypes are the tracers')."""
    seen = {"jax": [], "torch": []}
    for key, mod in (("jax", jkernels), ("torch", tkernels)):
        real = mod.fused_bottleneck

        def spy(x, w0, *args, _real=real, _key=key, **kw):
            seen[_key].append((str(x.dtype), str(w0.dtype)))
            return _real(x, w0, *args, **kw)
        monkeypatch.setattr(mod, "fused_bottleneck", spy)
    return seen


def _inference_programs(width, gate):
    """Both packages' inference programs, transpiled at `width` in fp32
    from one JAX startup scope with seeded batch-norm statistics."""
    jm, js, jout = _small_resnet(jfluid, jresnet)
    tm, _, tout = _small_resnet(tfluid, tresnet)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(js)
    _randomize_bn(jm, jscope, np.random.RandomState(3))
    init = {n: np.asarray(jscope.get(n)) for n in jscope.keys()}
    tscope = tfluid.scope_from_jax(init, tfluid.Scope(), tfluid.CPUPlace())
    gate(width)
    jinfer, tinfer = jm.clone(for_test=True), tm.clone(for_test=True)
    jfluid.transpiler.InferenceTranspiler().transpile(jinfer, scope=jscope)
    tfluid.InferenceTranspiler().transpile(tinfer, scope=tscope)
    n_fused = [[op.type for op in p.global_block().ops].count(
        "fused_bottleneck") for p in (jinfer, tinfer)]
    assert n_fused == [3 if width >= 8 else 0] * 2
    return (jexe, jscope, jinfer, jout), (tscope, tinfer, tout)


def _cast_bf16(program, jscope, tscope):
    """bench_infer.py's cast: every fp32 persistable to bf16 (in both
    scopes), and the feed var retyped."""
    for v in program.global_block().vars.values():
        if not v.persistable:
            continue
        jval = jscope.get(v.name)
        if jval is not None and np.asarray(jval).dtype == np.float32:
            jscope.set(v.name, jnp.asarray(jval, jnp.bfloat16))
        tval = tscope.get(v.name)
        if tval is not None and tval.dtype == torch.float32:
            tscope.set(v.name, tval.to(torch.bfloat16))


def _retype(programs):
    for p in programs:
        p.global_block().var("data").dtype = "bfloat16"


def _images(seed=4):
    return np.random.RandomState(seed).randn(4, 16, 16, 3).astype(
        np.float32)


@pytest.mark.parametrize("width", [8, 0])
def test_bf16_serving_route_matches_jax(width, gate, spies):
    (jexe, jscope, jinfer, jout), (tscope, tinfer, tout) = \
        _inference_programs(width, gate)
    _cast_bf16(jinfer, jscope, tscope)
    _retype([jinfer, tinfer])
    x = _images()
    with jfluid.scope_guard(jscope):
        want, = jexe.run(jinfer, feed={"data": x}, fetch_list=[jout.name])
    with tfluid.scope_guard(tscope):
        got, = tfluid.Executor(tfluid.CPUPlace()).run(
            tinfer, feed={"data": x}, fetch_list=[tout.name])
    want = np.asarray(want)
    assert want.dtype == BF16 and got.dtype == BF16
    assert got.shape == want.shape == (4, 10)
    if width:
        assert spies["jax"] == [("bfloat16", "bfloat16")] * 3
        assert spies["torch"] == [("torch.bfloat16", "torch.bfloat16")] * 3
    # bf16 probabilities: the convolutions (XLA vs oneDNN) and the fused
    # blocks sum in fp32 in other orders, so an activation may round one
    # bf16 ulp apart and carry that through the later layers: 2^-6 of the
    # largest probability, and the same top-1
    g, w = got.astype(np.float32), want.astype(np.float32)
    np.testing.assert_allclose(g, w, rtol=2.0 ** -6,
                               atol=2.0 ** -6 * float(np.abs(w).max()))
    assert (g.argmax(1) == w.argmax(1)).all()
    # and it is a bf16 result: the fp32 lane of the same program differs
    # by more than the fp32 tolerance
    assert not np.allclose(g, _fp32_lane(width, gate), rtol=1e-5,
                           atol=1e-6)


def _fp32_lane(width, gate):
    _, (tscope, tinfer, tout) = _inference_programs(width, gate)
    with tfluid.scope_guard(tscope):
        out, = tfluid.Executor(tfluid.CPUPlace()).run(
            tinfer, feed={"data": _images()}, fetch_list=[tout.name])
    return out


def test_fused_and_unfused_bf16_agree(gate):
    """K6-bf16 rounds a1 once after bias + relu where the unfused program
    rounds the conv output and again after the bias add: fused and
    unfused bf16 differ by design.  A logit a few bf16 ulps (2^-8
    relative each) apart moves its probability by about that many ulps
    times the logit's size, and logits here reach ~8: the probabilities
    agree to 2^-4 of the largest, with the same top-1."""
    outs = {}
    for width in (8, 0):
        (_, jscope, jinfer, _), (tscope, tinfer, tout) = \
            _inference_programs(width, gate)
        _cast_bf16(jinfer, jscope, tscope)
        _retype([tinfer])
        with tfluid.scope_guard(tscope):
            outs[width], = tfluid.Executor(tfluid.CPUPlace()).run(
                tinfer, feed={"data": _images()}, fetch_list=[tout.name])
    f, u = (outs[w].astype(np.float32) for w in (8, 0))
    np.testing.assert_allclose(f, u, rtol=0,
                               atol=2.0 ** -4 * float(np.abs(u).max()))
    assert (f.argmax(1) == u.argmax(1)).all()


def test_bf16_feeds_and_fetches(gate):
    """A bf16 feed var takes an fp32 array (cast), an ml_dtypes bf16 array
    and a torch bf16 tensor alike; the fetch is an ml_dtypes array."""
    _, (tscope, tinfer, tout) = _inference_programs(8, gate)
    for v in tinfer.global_block().vars.values():
        val = tscope.get(v.name)
        if v.persistable and val is not None \
                and val.dtype == torch.float32:
            tscope.set(v.name, val.to(torch.bfloat16))
    _retype([tinfer])
    x = _images()
    exe = tfluid.Executor(tfluid.CPUPlace())
    outs = []
    with tfluid.scope_guard(tscope):
        for feed in (x, x.astype(BF16),
                     torch.from_numpy(x).to(torch.bfloat16)):
            outs.append(exe.run(tinfer, feed={"data": feed},
                                fetch_list=[tout.name])[0])
        raw, = exe.run(tinfer, feed={"data": x}, fetch_list=[tout.name],
                       return_numpy=False)
    assert all(o.dtype == BF16 for o in outs)
    assert all(np.array_equal(o.view(np.uint16), outs[0].view(np.uint16))
               for o in outs)
    assert raw.dtype == torch.bfloat16
    assert np.array_equal(as_numpy(raw).view(np.uint16),
                          outs[0].view(np.uint16))


def test_amp_alone_sends_fp32_to_fused_bottleneck(gate, spies):
    """`set_amp(True)` on the fused fp32 program: the stem's conv runs in
    bf16, but its folded fp32 bias add promotes back to fp32, and the
    fused op (not on the white list) gets fp32 x and filters — in both
    packages.  AMP never reaches K6's bf16 variant; the bf16 cast does."""
    (jexe, jscope, jinfer, jout), (tscope, tinfer, tout) = \
        _inference_programs(8, gate)
    jfluid.set_amp(True)
    tfluid.set_amp(True)
    x = _images()
    with jfluid.scope_guard(jscope):
        want, = jexe.run(jinfer, feed={"data": x}, fetch_list=[jout.name])
    with tfluid.scope_guard(tscope):
        got, = tfluid.Executor(tfluid.CPUPlace()).run(
            tinfer, feed={"data": x}, fetch_list=[tout.name])
    assert spies["jax"] == [("float32", "float32")] * 3
    assert spies["torch"] == [("torch.float32", "torch.float32")] * 3
    assert got.dtype == np.asarray(want).dtype == np.float32
