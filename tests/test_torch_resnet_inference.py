"""ResNet-50 inference: paddle_tpu_torch against paddle_tpu on the CPU.

The port builds the JAX package's program op for op and serializes it to
the same JSON; an artifact saved by either package serves in the other's
Predictor, unfused and with FuseBottleneckPass at gate 128 (the JAX
Predictor runs its Pallas kernel in interpret mode); bucket padding and
un-padding give what an unpadded run gives.  The network runs at full
width on a 32 x 32 input, batch 2, with non-trivial batch-norm
statistics and a small fc so the softmax is not saturated.  Predictions
agree to rtol 1e-4 with an absolute floor of 1e-4 x the largest
probability (XLA and PyTorch sum the convolutions in other orders)."""

import inspect
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
import paddle_tpu.inference as jinference
import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.inference as tinference
from paddle_tpu.flags import get_flags, set_flags
from paddle_tpu.models import resnet as jresnet
from paddle_tpu_torch.flags import FLAGS as TFLAGS
from paddle_tpu_torch.models import resnet as tresnet

HW = 32


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


@pytest.fixture
def jax_no_cache():
    """The JAX Predictor's persistent compile cache stays off (no writes
    outside the test's directories)."""
    old = get_flags(["compile_cache"])
    set_flags({"compile_cache": False})
    yield
    set_flags(old)


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


def test_get_model_program_equals_jax():
    assert inspect.signature(tresnet.get_model) == \
        inspect.signature(jresnet.get_model)
    for layout in ("NHWC", "NCHW"):
        kw = dict(batch_size=2, is_train=False, layout=layout)
        with jfluid.unique_name.guard():
            jm, js, _, jloss, jacc, jpred = jresnet.get_model(**kw)
        with tfluid.unique_name.guard():
            tm, ts, tfeeds, tloss, tacc, tpred = tresnet.get_model(**kw)
        assert [v.name for v in tfeeds] == ["data", "label"]
        assert (tloss.name, tacc.name, tpred.name) == \
            (jloss.name, jacc.name, jpred.name)
        for jp, tp in ((jm, tm), (js, ts)):
            assert [(o.type, o.inputs, o.outputs, o.attrs)
                    for o in tp.global_block().ops] == \
                [(o.type, o.inputs, o.outputs, o.attrs)
                 for o in jp.global_block().ops]
        types = {o.type for o in tm.global_block().ops}
        assert {"conv2d", "batch_norm", "pool2d", "relu", "elementwise_add",
                "mul", "softmax", "cross_entropy", "mean", "top_k",
                "accuracy"} <= types
        # the inference program serializes to the same JSON, byte for byte
        jpr = jm.clone(for_test=True)._prune(["data"], [jpred.name])
        tpr = tm.clone(for_test=True)._prune(["data"], [tpred.name])
        assert tpr.serialize_to_string() == jpr.serialize_to_string()
        again = tfluid.Program.parse_from_string(tpr.serialize_to_string())
        assert again.serialize_to_string() == tpr.serialize_to_string()


def test_training_is_not_ported():
    """ResNet training is ported now (tests/test_torch_resnet_train.py):
    is_train=True builds Momentum with L2Decay, where it used to raise;
    is_train=False still builds no optimizer op."""
    main = tresnet.get_model(is_train=True)[0]
    types = [op.type for op in main.global_block().ops]
    assert "momentum" in types and "scale" in types
    infer = tresnet.get_model(is_train=False)[0]
    assert not any(op.type in ("momentum", "remat_tag") or
                   op.type.endswith("_grad")
                   for op in infer.global_block().ops)


def _build(pkg, models):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        img = pkg.layers.data(name="data", shape=[HW, HW, 3],
                              dtype="float32")
        pred = models.resnet_imagenet(img, class_dim=1000, depth=50,
                                      is_train=False, layout="NHWC")
    return main, startup, pred


def _state(program, init, rng):
    """Startup values with seeded batch-norm parameters and statistics
    and an fc weight scaled down to 1e-2 (an unsaturated softmax)."""
    state = dict(init)
    for v in program.global_block().vars.values():
        if not v.persistable or v.name not in state:
            continue
        shape = state[v.name].shape
        kind = v.name.split(".")[-1]
        if v.name.startswith("batch_norm"):
            if kind.startswith("var"):
                a = 1.0 + 2.0 * rng.rand(*shape)
            elif kind.startswith("w_"):
                a = 0.5 + 0.5 * rng.rand(*shape)
            else:
                a = 0.1 * rng.randn(*shape)
            state[v.name] = a.astype(np.float32)
        elif v.name.startswith("fc"):
            state[v.name] = state[v.name] * np.float32(1e-2)
    return state


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """One artifact saved by each package: the JAX one from the JAX
    startup program, the port's from its own startup program (other
    random values), both with the seeded statistics."""
    root = tmp_path_factory.mktemp("resnet")
    out = {}
    jm, js, jpred = _build(jfluid, jresnet)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(js)
        init = {n: np.asarray(jscope.get(n)) for n in jscope.keys()}
        for n, a in _state(jm, init, np.random.RandomState(1)).items():
            jscope.set(n, jnp.asarray(a))
        out["jax"] = str(root / "jax")
        jfluid.save_inference_model(out["jax"], ["data"], [jpred], jexe,
                                    main_program=jm)
    tm, ts, tpred = _build(tfluid, tresnet)
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    with tfluid.scope_guard(tscope):
        texe.run(ts)
        init = tfluid.scope_to_jax(tscope)
        tfluid.scope_from_jax(_state(tm, init, np.random.RandomState(2)),
                              tscope, tfluid.CPUPlace())
        out["torch"] = str(root / "torch")
        tfluid.save_inference_model(out["torch"], ["data"], [tpred], texe,
                                    main_program=tm)
    return out


def _images(batch, seed=0):
    return np.random.RandomState(seed).randn(batch, HW, HW, 3).astype(
        np.float32)


def _port_predictor(model_dir, cls=None):
    cls = cls or tinference.AnalysisConfig
    return tinference.create_paddle_predictor(cls(model_dir=model_dir,
                                                  device="cpu"))


def test_artifacts_are_the_same_files(artifacts):
    """Both packages write the same __model__ (the programs are equal)
    and the same set of .npy files."""
    files = {k: sorted(os.listdir(d)) for k, d in artifacts.items()}
    assert files["torch"] == files["jax"]
    with open(os.path.join(artifacts["jax"], "__model__")) as f:
        jmeta = json.load(f)
    with open(os.path.join(artifacts["torch"], "__model__")) as f:
        tmeta = json.load(f)
    assert tmeta == jmeta


@pytest.mark.parametrize("width,n_fused", [(0, 0), (128, 7)])
def test_jax_artifact_serves_in_the_port(artifacts, width, n_fused, gate,
                                         jax_no_cache):
    gate(width)
    x = _images(2)
    jpred = jinference.create_paddle_predictor(
        jinference.AnalysisConfig(model_dir=artifacts["jax"]))
    want, = jpred.run([x])
    tpred = _port_predictor(artifacts["jax"])
    assert tpred.device.type == "cpu" and tpred.precision == "fp32"
    got, = tpred.run([x])
    jops = [o.type for o in jpred._program.global_block().ops]
    tops = [o.type for o in tpred.program.global_block().ops]
    assert tops == jops and tops.count("fused_bottleneck") == n_fused
    assert float(want.max()) < 0.5  # not saturated
    _close(got, want)


def test_port_artifact_serves_in_jax(artifacts, jax_no_cache):
    x = _images(2, seed=3)
    want, = jinference.create_paddle_predictor(
        jinference.AnalysisConfig(model_dir=artifacts["torch"])).run([x])
    got, = _port_predictor(artifacts["torch"]).run([x])
    _close(got, want)
    # and through load_inference_model + Executor, without the rewrites
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        prog, feeds, fetches = jfluid.load_inference_model(
            artifacts["torch"], exe)
        plain, = exe.run(prog, feed={feeds[0]: x},
                         fetch_list=[fetches[0].name])
    _close(got, plain)


def test_bucket_padding_and_unpadding(artifacts, jax_no_cache):
    """Batch 3 pads to the bucket of 4 and comes back as 3 rows, equal to
    an unbucketed run and to the JAX Predictor's; a batch past every
    bucket runs unpadded and warns once."""
    x = _images(3, seed=4)
    pred = _port_predictor(artifacts["jax"])
    assert pred.batch_buckets() == (1, 2, 4, 8, 16, 32, 64, 128)
    got, = pred.run({"data": x})
    assert got.shape == (3, 1000)
    native = _port_predictor(artifacts["jax"], tinference.NativeConfig)
    assert native.batch_buckets() == ()
    plain, = native.run([tinference.PaddleTensor(x, name="data")])
    # NativeConfig skips the inference rewrites: the same math, unfolded
    _close(got, plain)
    want, = jinference.create_paddle_predictor(
        jinference.AnalysisConfig(model_dir=artifacts["jax"])).run([x])
    _close(got, want)
    pred._config.batch_size_buckets = (1, 2)
    with pytest.warns(RuntimeWarning, match="exceeds every configured"):
        over, = pred.run([x])
    _close(over, got)


def test_save_and_load_vars_round_trip(tmp_path):
    """save_persistables / load_persistables, per-var files and one .npz,
    across the two packages."""
    def build(pkg):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            img = pkg.layers.data(name="img", shape=[6, 6, 4],
                                  dtype="float32")
            conv = pkg.layers.conv2d(img, num_filters=5, filter_size=3,
                                     data_format="NHWC")
            pkg.layers.batch_norm(conv, data_layout="NHWC", is_test=True)
        return main, startup

    main, startup = build(tfluid)
    jmain, _ = build(jfluid)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe.run(startup)
        tfluid.save_persistables(exe, str(tmp_path / "vars"), main)
        tfluid.save_persistables(exe, str(tmp_path / "npz"), main,
                                 filename="all.npz")
    names = sorted(scope.keys())
    assert sorted(f[:-4] for f in os.listdir(tmp_path / "vars")) == names
    for kw in ({}, {"filename": "all.npz"}):
        where = str(tmp_path / ("npz" if kw else "vars"))
        back = tfluid.Scope()
        with tfluid.scope_guard(back):
            tfluid.load_persistables(exe, where, main, **kw)
        jback = jfluid.Scope()
        with jfluid.scope_guard(jback):
            jfluid.load_persistables(None, where, jmain, **kw)
        for n in names:
            np.testing.assert_array_equal(back.get(n).numpy(),
                                          scope.get(n).numpy())
            np.testing.assert_array_equal(np.asarray(jback.get(n)),
                                          scope.get(n).numpy())


def test_predictor_defaults_to_the_card(artifacts, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tinference.create_paddle_predictor(
            tinference.AnalysisConfig(model_dir=artifacts["jax"]))
    # loading without an executor loads onto the card too
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with tfluid.scope_guard(tfluid.Scope()):
            tfluid.load_inference_model(artifacts["jax"], None)
