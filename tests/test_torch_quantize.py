"""Post-training quantization: paddle_tpu_torch against paddle_tpu on the
CPU.

One fp32 artifact (a small NHWC CNN — conv, batch norm, relu, pool, two
fc layers — saved by the JAX package) and the same seeded calibration
feeds go through both packages' `quantize_inference_model`.  The int8
payloads must be equal byte for byte and the scales within rtol 1e-6,
unless an fc layer's clip-ratio search flips between two near-equal
candidates on the order of fp32 sums; then the test says so and holds
that layer's output errors (the search's criterion) to rtol 1e-3 of each
other instead.  Each package's Predictor serves each package's int8
artifact; predictions agree to rtol 1e-3 with a floor of 1e-3 x the
largest probability (activations round to bf16 in both, and an fp32 sum
in another order can land one bf16 ulp, 2^-8, apart before the next
layer).  A tampered payload is refused at the load boundary."""

import json
import os

import numpy as np
import pytest

import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
import paddle_tpu.inference as jinference
import paddle_tpu.inference.quantize as jquant
import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.inference as tinference
import paddle_tpu_torch.inference.quantize as tquant
from paddle_tpu.flags import get_flags, set_flags

HW = 12


def _calib(n=4, batch=4, seed=0):
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(batch, HW, HW, 3).astype(np.float32)}
            for _ in range(n)]


@pytest.fixture(scope="module")
def fp32_dir(tmp_path_factory):
    main, startup = jfluid.Program(), jfluid.Program()
    main.random_seed = startup.random_seed = 11
    with jfluid.unique_name.guard(), jfluid.program_guard(main, startup):
        x = jfluid.layers.data(name="x", shape=[HW, HW, 3], dtype="float32")
        conv = jfluid.layers.conv2d(x, num_filters=16, filter_size=3,
                                    padding=1, data_format="NHWC")
        bn = jfluid.layers.batch_norm(conv, act="relu", is_test=True,
                                      data_layout="NHWC")
        conv2 = jfluid.layers.conv2d(bn, num_filters=16, filter_size=3,
                                     padding=1, act="relu",
                                     data_format="NHWC")
        pool = jfluid.layers.pool2d(conv2, pool_size=2, pool_stride=2,
                                    data_format="NHWC")
        h = jfluid.layers.fc(pool, size=64, act="relu")
        pred = jfluid.layers.fc(h, size=32, act="softmax")
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    rng = np.random.RandomState(1)
    with jfluid.scope_guard(scope):
        exe.run(startup)
        for name in scope.keys():
            a = np.asarray(scope.get(name))
            if name.startswith("batch_norm") and "var" in name.split(".")[-1]:
                scope.set(name, jnp.asarray(
                    (1 + rng.rand(*a.shape)).astype(np.float32)))
            elif name.startswith("batch_norm"):
                scope.set(name, jnp.asarray(
                    (0.2 * rng.randn(*a.shape)).astype(np.float32)))
        out = str(tmp_path_factory.mktemp("ptq") / "cnn")
        jfluid.save_inference_model(out, ["x"], [pred], exe,
                                    main_program=main)
    return out


@pytest.fixture(scope="module")
def quantized(fp32_dir):
    """The same artifact quantized by each package."""
    old = get_flags(["compile_cache"])
    set_flags({"compile_cache": False})
    try:
        jsum = jquant.quantize_inference_model(fp32_dir, fp32_dir + "_jax",
                                               calib_feeds=_calib())
    finally:
        set_flags(old)
    tsum = tquant.quantize_inference_model(fp32_dir, fp32_dir + "_torch",
                                           calib_feeds=_calib(),
                                           place=tfluid.CPUPlace())
    return {"jax": (fp32_dir + "_jax", jsum),
            "torch": (fp32_dir + "_torch", tsum)}


def _npy(d, name):
    return np.load(os.path.join(d, name.replace("/", "__") + ".npy"))


def test_payloads_and_scales_agree(quantized):
    jdir, jsum = quantized["jax"]
    tdir, tsum = quantized["torch"]
    # the first conv (432 elements) stays under the 1024-element floor
    assert tsum["n_quantized"] == jsum["n_quantized"] == 3
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    flipped = []
    for jl, tl in zip(jsum["layers"], tsum["layers"]):
        assert {k: tl[k] for k in ("op_index", "op_type", "weight", "scale",
                                   "shape", "calibrated")} == \
            {k: jl[k] for k in ("op_index", "op_type", "weight", "scale",
                                "shape", "calibrated")}
        if tl["clip_ratio"] != jl["clip_ratio"]:
            # a near tie in the output-error search, decided by the order
            # of fp32 sums: both choices must be (almost) equally good
            assert tl["op_type"] == "mul" and tl["calibrated"]
            np.testing.assert_allclose(tl["mse"], jl["mse"], rtol=1e-3)
            flipped.append(tl["weight"])
            continue
        np.testing.assert_allclose(tl["mse"], jl["mse"], rtol=1e-4)
        jq, tq = _npy(jdir, jl["weight"]), _npy(tdir, tl["weight"])
        assert tq.dtype == jq.dtype == np.int8
        np.testing.assert_array_equal(tq, jq)
        np.testing.assert_allclose(_npy(tdir, tl["scale"]),
                                   _npy(jdir, jl["scale"]), rtol=1e-6)
        for stem in (jl["weight"], jl["scale"]):
            fname = stem.replace("/", "__") + ".npy"
            with open(os.path.join(jdir, fname), "rb") as f:
                jbytes = f.read()
            with open(os.path.join(tdir, fname), "rb") as f:
                assert f.read() == jbytes, fname
    if flipped:
        print("clip ratio flipped on fp32 summation order: %s" % flipped)
    # the rewritten programs are the same JSON
    with open(os.path.join(jdir, "__model__")) as f:
        jmodel = json.load(f)
    with open(os.path.join(tdir, "__model__")) as f:
        assert json.load(f) == jmodel


def test_quant_meta_fields_agree(quantized):
    jdir, _ = quantized["jax"]
    tdir, _ = quantized["torch"]
    jm, tm = jquant.read_quant_meta(jdir), tquant.read_quant_meta(tdir)
    assert sorted(tm) == sorted(jm)
    for key in ("schema", "precision", "act_dtype", "bytes",
                "min_weight_elems", "clip_ratios"):
        assert tm[key] == jm[key], key
    assert sorted(tm["crc32"]) == sorted(jm["crc32"])
    assert tm["source"]["program_sha256"] == jm["source"]["program_sha256"]
    assert tm["calibration"]["batches"] == jm["calibration"]["batches"] == 4
    assert tm["calibration"]["top1_agreement"] == \
        jm["calibration"]["top1_agreement"]
    # each package reads the other's meta the same way
    assert jquant.read_quant_meta(tdir) == tm
    assert tquant.artifact_precision(jdir) == "int8"
    assert tquant.artifact_precision(os.path.dirname(jdir)) == "fp32"
    assert tquant.is_quantized_dir(jdir) and jquant.is_quantized_dir(tdir)
    assert all(err is None for _, err in tquant.verify_quantized_dir(jdir))


@pytest.mark.parametrize("which", ["jax", "torch"])
def test_predictions_agree_on_either_artifact(quantized, fp32_dir, which):
    qdir, _ = quantized[which]
    x = np.random.RandomState(5).randn(3, HW, HW, 3).astype(np.float32)
    old = get_flags(["compile_cache"])
    set_flags({"compile_cache": False})
    try:
        want, = jinference.create_paddle_predictor(
            jinference.AnalysisConfig(model_dir=qdir)).run([x])
    finally:
        set_flags(old)
    pred = tinference.create_paddle_predictor(
        tinference.AnalysisConfig(model_dir=qdir, device="cpu"))
    assert pred.precision == "int8"
    assert {o.type for o in pred.program.global_block().ops} >= \
        {"dequant_conv2d", "dequant_mul"}
    got, = pred.run([x])
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-3 * float(np.abs(want).max()))
    assert (got.argmax(1) == want.argmax(1)).all()
    # and close to the fp32 artifact
    fp32, = tinference.create_paddle_predictor(
        tinference.AnalysisConfig(model_dir=fp32_dir, device="cpu")).run([x])
    assert np.abs(got - fp32).max() < 0.05


def test_failed_calibration_raises_and_writes_nothing(fp32_dir, tmp_path,
                                                      monkeypatch):
    """A calibration run that fails (the activation capture, the first
    run, as a device fault would fail it) raises out of the PTQ pass
    instead of degrading to weight-only scales, and leaves no artifact
    behind."""
    real_run = tfluid.Executor.run
    calls = []

    def failing_run(self, *args, **kwargs):
        calls.append(kwargs.get("fetch_list"))
        if len(calls) == 1:
            raise RuntimeError("simulated device fault")
        return real_run(self, *args, **kwargs)

    monkeypatch.setattr(tfluid.Executor, "run", failing_run)
    dst = str(tmp_path / "int8")
    with pytest.raises(RuntimeError, match="simulated device fault"):
        tquant.quantize_inference_model(fp32_dir, dst, calib_feeds=_calib(),
                                        place=tfluid.CPUPlace())
    assert len(calls) == 1 and os.listdir(str(tmp_path)) == []


def test_tampered_payload_is_rejected(quantized, tmp_path):
    import shutil
    src, summary = quantized["torch"]
    bad = str(tmp_path / "tampered")
    shutil.copytree(src, bad)
    layer = summary["layers"][0]
    fname = layer["weight"].replace("/", "__") + ".npy"
    path = os.path.join(bad, fname)
    with open(path, "rb") as f:
        data = bytearray(f.read())
    data[-1] ^= 0x01
    with open(path, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(tquant.QuantizedArtifactError, match=fname):
        tquant.check_quantized_dir(bad)
    with pytest.raises(tquant.QuantizedArtifactError, match=fname):
        tinference.create_paddle_predictor(
            tinference.AnalysisConfig(model_dir=bad, device="cpu"))
    errs = dict(tquant.verify_quantized_dir(bad))
    assert errs[fname] is not None and "CRC32" in errs[fname]
    # the JAX package refuses it too
    with pytest.raises(jquant.QuantizedArtifactError):
        jquant.check_quantized_dir(bad)
