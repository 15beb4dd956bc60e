"""The in-graph IO ops of paddle_tpu_torch (ops/io_ops.py: save, load,
save_combine, load_combine) against paddle_tpu's on the CPU: a file
saved by either package loads in the other and through numpy.load,
bit for bit, in both directions; load_as_fp16 casts as the JAX op does;
overwrite=False refuses an existing file in both; layers.load appends
the load op."""

import os

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid

PKGS = {"jax": jfluid, "torch": tfluid}
DIRECTIONS = [("jax", "torch"), ("torch", "jax")]


def _values():
    """float32 and int32 vars (the JAX package runs int64 vars as int32,
    its x64 mode off, so an int64 one would not cross bit for bit)."""
    rng = np.random.RandomState(0)
    return {"w": rng.randn(3, 4).astype(np.float32),
            "ids": rng.randint(0, 9, size=(5,)).astype(np.int32),
            "scope/b": rng.randn(2).astype(np.float32)}


def _var(fluid, name, value):
    return fluid.layers.data(name, shape=list(value.shape),
                             dtype=str(value.dtype),
                             append_batch_size=False)


def _save(pkg, values, path, combine, overwrite=True):
    """Run a program whose save (or save_combine) op writes `values`."""
    fluid = PKGS[pkg]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        xs = [_var(fluid, n, v) for n, v in values.items()]
        gb = main.global_block()
        attrs = {"file_path": path, "overwrite": overwrite}
        if combine:
            gb.append_op(type="save_combine",
                         inputs={"X": [x.name for x in xs]}, outputs={},
                         attrs=attrs, infer_shape=False)
        else:
            for x in xs:
                gb.append_op(type="save", inputs={"X": [x.name]},
                             outputs={},
                             attrs=dict(attrs, file_path=os.path.join(
                                 path, x.name.replace("/", "__"))),
                             infer_shape=False)
    fluid.Executor(fluid.CPUPlace()).run(main, feed=values,
                                         scope=fluid.Scope())


def _load(pkg, values, path, combine, fp16=False):
    """{name: array} read back by a program of load (or load_combine)
    ops into fresh vars."""
    fluid = PKGS[pkg]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        gb = main.global_block()
        outs = [gb.create_var(name=n, dtype=str(v.dtype), shape=v.shape)
                for n, v in values.items()]
        if combine:
            gb.append_op(type="load_combine", inputs={},
                         outputs={"Out": [o.name for o in outs]},
                         attrs={"file_path": path}, infer_shape=False)
        else:
            for o in outs:
                attrs = {"file_path": os.path.join(
                    path, o.name.replace("/", "__"))}
                if fp16:
                    attrs["load_as_fp16"] = True
                gb.append_op(type="load", inputs={},
                             outputs={"Out": [o.name]}, attrs=attrs,
                             infer_shape=False)
    got = fluid.Executor(fluid.CPUPlace()).run(
        main, fetch_list=[o.name for o in outs], scope=fluid.Scope())
    return dict(zip(values, [np.asarray(g) for g in got]))


@pytest.mark.parametrize("writer,reader", DIRECTIONS,
                         ids=["jax_to_torch", "torch_to_jax"])
def test_save_then_load_crosses(tmp_path, writer, reader):
    values = _values()
    _save(writer, values, str(tmp_path), combine=False)
    got = _load(reader, values, str(tmp_path), combine=False)
    for n, v in values.items():
        assert got[n].dtype == v.dtype
        np.testing.assert_array_equal(got[n], v)
        np.testing.assert_array_equal(
            np.load(os.path.join(str(tmp_path), n.replace("/", "__"))), v)


@pytest.mark.parametrize("writer,reader", DIRECTIONS,
                         ids=["jax_to_torch", "torch_to_jax"])
def test_save_combine_then_load_combine_crosses(tmp_path, writer, reader):
    values = _values()
    path = str(tmp_path / "all.npz")
    _save(writer, values, path, combine=True)
    got = _load(reader, values, path, combine=True)
    with np.load(path) as z:
        assert sorted(z.files) == sorted(n.replace("/", "__")
                                         for n in values)
        for n, v in values.items():
            np.testing.assert_array_equal(z[n.replace("/", "__")], v)
            np.testing.assert_array_equal(got[n], v)


def test_files_are_the_jax_packages(tmp_path):
    """The same values saved by both packages give the same .npy bytes."""
    values = _values()
    for pkg in PKGS:
        os.makedirs(tmp_path / pkg)
        _save(pkg, values, str(tmp_path / pkg), combine=False)
    for n in values:
        f = n.replace("/", "__")
        assert (tmp_path / "jax" / f).read_bytes() == \
            (tmp_path / "torch" / f).read_bytes()


@pytest.mark.parametrize("combine", [False, True],
                         ids=["save", "save_combine"])
def test_overwrite_false_refuses_an_existing_file(tmp_path, combine):
    values = {"w": _values()["w"]}
    for pkg in PKGS:
        path = str(tmp_path / pkg / ("all.npz" if combine else ""))
        os.makedirs(str(tmp_path / pkg), exist_ok=True)
        _save(pkg, values, path, combine)
        with pytest.raises(Exception, match="overwrite=False"):
            _save(pkg, values, path, combine, overwrite=False)


def test_load_as_fp16_matches_jax(tmp_path):
    values = {"w": _values()["w"]}
    _save("torch", values, str(tmp_path), combine=False)
    want = _load("jax", values, str(tmp_path), combine=False, fp16=True)
    got = _load("torch", values, str(tmp_path), combine=False, fp16=True)
    assert got["w"].dtype == want["w"].dtype == np.float16
    np.testing.assert_array_equal(got["w"], want["w"])


def test_layers_load_appends_the_load_op(tmp_path):
    w = _values()["w"]
    path = str(tmp_path / "w.npy")
    np.save(path, w)
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        out = main.global_block().create_var(name="w", dtype="float32",
                                             shape=w.shape)
        assert tfluid.layers.load(out, path) is out
        y = tfluid.layers.scale(out, scale=2.0)
    assert [op.type for op in main.global_block().ops] == ["load", "scale"]
    got, = tfluid.Executor(tfluid.CPUPlace()).run(
        main, fetch_list=[y], scope=tfluid.Scope())
    np.testing.assert_array_equal(got, 2 * w)
