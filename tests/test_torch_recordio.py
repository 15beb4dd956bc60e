"""RecordIO and the tensor serialization of paddle_tpu_torch (pure Python:
native/pyrio.py, native/__init__.py) against paddle_tpu's, on the CPU:
files and tensor records are byte-identical to the JAX package's writer
as it stands (its C++ library, or its Python fallback where the library
is missing) and to its Python fallback, for several chunk sizes; each
package reads the other's files; a flipped payload byte fails the CRC
in both; fluid.recordio_writer's files (one and sharded) and readers
cross both ways; reader.creator.recordio reads the JAX package's file."""

import os

import numpy as np
import pytest

from paddle_tpu import native as jnative
from paddle_tpu.fluid import recordio_writer as jrw
from paddle_tpu.native import pyrio as jpyrio
from paddle_tpu_torch import native as tnative
from paddle_tpu_torch import reader as treader
from paddle_tpu_torch.fluid import recordio_writer as trw

RECORDS = [b"hello", b"", b"x" * 10000, b"tail", bytes(range(256)) * 3]


def _write(writer_cls, path, records, **kw):
    w = writer_cls(path, **kw)
    for r in records:
        w.write(r)
    w.close()
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("chunk", [1, 2, 1000])
def test_files_are_the_jax_writers_byte_for_byte(tmp_path, chunk):
    mine = _write(tnative.RecordIOWriter, str(tmp_path / "t.rio"), RECORDS,
                  max_chunk_records=chunk)
    jax_native = _write(jnative.RecordIOWriter, str(tmp_path / "j.rio"),
                        RECORDS, max_chunk_records=chunk)
    jax_py = _write(jpyrio.PyWriter, str(tmp_path / "p.rio"), RECORDS,
                    max_chunk_records=chunk)
    assert mine == jax_native == jax_py


def test_byte_budget_flushes_as_jax(tmp_path):
    recs = [bytes([i]) * 700 for i in range(10)]
    mine = _write(tnative.RecordIOWriter, str(tmp_path / "t.rio"), recs,
                  max_chunk_bytes=2000)
    theirs = _write(jnative.RecordIOWriter, str(tmp_path / "j.rio"), recs,
                    max_chunk_bytes=2000)
    assert mine == theirs


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_files_read_across(tmp_path, direction):
    path = str(tmp_path / "x.rio")
    writer, scanner = (jnative.RecordIOWriter, tnative.RecordIOScanner) \
        if direction == "jax_to_torch" else \
        (tnative.RecordIOWriter, jnative.RecordIOScanner)
    _write(writer, path, RECORDS, max_chunk_records=2)
    with scanner(path) as s:
        assert list(s) == RECORDS


@pytest.mark.parametrize("scanner", ["torch", "jax"])
def test_crc_detects_corruption(tmp_path, scanner):
    path = str(tmp_path / "bad.rio")
    _write(tnative.RecordIOWriter, path, [b"a" * 1000])
    raw = bytearray(open(path, "rb").read())
    raw[-10] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    cls = tnative.RecordIOScanner if scanner == "torch" \
        else jnative.RecordIOScanner
    with pytest.raises((IOError, StopIteration)):
        with cls(path) as s:
            list(s)
    if scanner == "torch":
        with pytest.raises(IOError, match="crc"):
            with cls(path) as s:
                list(s)


def test_bad_magic_raises(tmp_path):
    path = str(tmp_path / "notrio")
    open(path, "wb").write(b"NOTRIO00" + b"\0" * 16)
    with pytest.raises(IOError, match="magic"):
        tnative.RecordIOScanner(path)


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "int64",
                                   "float16", "uint8", "int8", "bool"])
@pytest.mark.parametrize("lod", [None, [[0, 2, 3]], [[0, 1, 3], [0, 2, 3,
                                                                  5]]],
                         ids=["dense", "lod1", "lod2"])
def test_tensor_records_are_the_jax_packages(dtype, lod):
    rng = np.random.RandomState(0)
    arr = (rng.randn(3, 4, 2) * 10).astype(dtype)
    mine = tnative.serialize_tensor(arr, lod)
    assert mine == jnative.serialize_tensor(arr, lod)
    for decode in (tnative.deserialize_tensor, jnative.deserialize_tensor):
        back, back_lod = decode(mine)
        assert back.dtype == arr.dtype
        np.testing.assert_array_equal(back, arr)
        assert back_lod == (lod or [])


def test_scalar_and_empty_tensors(tmp_path):
    """Records of a 0-d and an empty tensor are the JAX package's, and
    read back as it reads them (a 0-d tensor as shape (1,), as both
    packages' decoders give it)."""
    for arr in (np.float32(2.5), np.zeros((0, 3), np.int64)):
        arr = np.asarray(arr)
        rec = tnative.serialize_tensor(arr)
        assert rec == jnative.serialize_tensor(arr)
        back, _ = tnative.deserialize_tensor(rec)
        want, _ = jnative.deserialize_tensor(rec)
        assert back.shape == want.shape and back.size == arr.size
        np.testing.assert_array_equal(back, want)


def _samples():
    rng = np.random.RandomState(3)
    for i in range(7):
        yield (rng.randn(2, 3).astype(np.float32),
               np.array([i], np.int64))


def test_convert_reader_file_is_the_jax_packages(tmp_path):
    t, j = str(tmp_path / "t.rio"), str(tmp_path / "j.rio")
    assert trw.convert_reader_to_recordio_file(t, _samples,
                                               max_num_records=3) == 7
    assert jrw.convert_reader_to_recordio_file(j, _samples,
                                               max_num_records=3) == 7
    assert open(t, "rb").read() == open(j, "rb").read()
    for reader in (trw.recordio_reader(j), jrw.recordio_reader(t)):
        got = list(reader())
        want = list(_samples())
        assert len(got) == len(want)
        for (ga, gb), (wa, wb) in zip(got, want):
            np.testing.assert_array_equal(ga, wa)
            np.testing.assert_array_equal(gb, wb)


def test_sharded_files_are_the_jax_packages(tmp_path):
    os.makedirs(tmp_path / "t")
    os.makedirs(tmp_path / "j")
    tf = trw.convert_reader_to_recordio_files(
        str(tmp_path / "t" / "d.rio"), 3, _samples)
    jf = jrw.convert_reader_to_recordio_files(
        str(tmp_path / "j" / "d.rio"), 3, _samples)
    assert [os.path.basename(p) for p in tf] == \
        [os.path.basename(p) for p in jf] == \
        ["d-00000.rio", "d-00001.rio", "d-00002.rio"]
    for a, b in zip(tf, jf):
        assert open(a, "rb").read() == open(b, "rb").read()


def test_single_field_samples_read_back_as_arrays(tmp_path):
    path = str(tmp_path / "s.rio")
    trw.convert_reader_to_recordio_file(
        path, lambda: iter([np.arange(3, dtype=np.int32)] * 2))
    got = list(jrw.recordio_reader(path)())
    assert all(isinstance(g, np.ndarray) for g in got)
    got = list(trw.recordio_reader(path)())
    assert all(isinstance(g, np.ndarray) and g.tolist() == [0, 1, 2]
               for g in got)


def test_creator_recordio_reads_the_jax_file(tmp_path):
    a, b = str(tmp_path / "a.rio"), str(tmp_path / "b.rio")
    _write(jnative.RecordIOWriter, a, RECORDS[:2])
    _write(jnative.RecordIOWriter, b, RECORDS[2:])
    assert list(treader.creator.recordio([a, b])()) == RECORDS
    assert list(treader.creator.recordio(a + "," + b)()) == RECORDS
