"""Host-side formats shared with paddle_tpu, in pure Python (the port
loads no native library): the save/load-op tensor serialization
(`serialize_tensor` / `deserialize_tensor`, the format of
native/tensor_serde.cc) and RecordIO (`RecordIOWriter` /
`RecordIOScanner` over native/pyrio.py, the format of
native/recordio.cc).  Both are byte-compatible with the JAX package's
native library and with its Python fallbacks, in both directions."""

import struct

import numpy as np

from . import pyrio

__all__ = ["RecordIOWriter", "RecordIOScanner", "serialize_tensor",
           "deserialize_tensor"]

# Tensor dtype codes of the save/load-op format, copied from
# paddle_tpu/native/__init__.py so artifacts written by either package
# read in the other.  The wire codec extends this table from code 8 up.
_DTYPE_CODES = {
    np.dtype(np.float32): 0, np.dtype(np.float64): 1,
    np.dtype(np.int32): 2, np.dtype(np.int64): 3,
    np.dtype(np.float16): 4, np.dtype(np.uint8): 5,
    np.dtype(np.int8): 6, np.dtype(np.bool_): 7,
}
_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}
_VERSION = 1


class RecordIOWriter:
    """Writes records (bytes) to a RecordIO file (reference
    recordio/writer.h); a context manager."""

    def __init__(self, path, max_chunk_records=1000,
                 max_chunk_bytes=32 << 20):
        self._w = pyrio.PyWriter(path, max_chunk_records, max_chunk_bytes)

    def write(self, record):
        self._w.write(record)

    def close(self):
        self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class RecordIOScanner:
    """Iterates a RecordIO file's records (reference recordio/
    scanner.h:26); IOError on a bad magic or a chunk whose CRC does not
    match."""

    def __init__(self, path):
        self._s = pyrio.PyScanner(path)

    def __iter__(self):
        return self

    def __next__(self):
        return self._s.next()

    def close(self):
        self._s.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def serialize_tensor(arr, lod=None):
    """The save-op tensor record (native/tensor_serde.cc ts_serialize):
    u32 version 1, u32 dtype code, u32 ndim, u64 dims[ndim], u64 nbytes,
    the C-order data, u32 LoD levels, then per level u64 n and u64
    offsets[n]."""
    arr = np.ascontiguousarray(arr)
    code = _DTYPE_CODES[np.dtype(arr.dtype)]
    lod = lod or []
    raw = arr.tobytes()
    parts = [struct.pack("<III", _VERSION, code, arr.ndim),
             struct.pack("<%dQ" % arr.ndim, *arr.shape),
             struct.pack("<Q", len(raw)), raw,
             struct.pack("<I", len(lod))]
    for level in lod:
        parts.append(struct.pack("<Q", len(level)))
        parts.append(struct.pack("<%dQ" % len(level), *level))
    return b"".join(parts)


def deserialize_tensor(buf):
    """(ndarray, lod) from a record of serialize_tensor."""
    version, code, ndim = struct.unpack_from("<III", buf, 0)
    if version != _VERSION:
        raise ValueError("bad tensor record version %d" % version)
    off = 12
    dims = struct.unpack_from("<%dQ" % ndim, buf, off)
    off += 8 * ndim
    (nbytes,) = struct.unpack_from("<Q", buf, off)
    off += 8
    dtype = _CODE_DTYPES[code]
    arr = np.frombuffer(buf, dtype=dtype, count=nbytes // dtype.itemsize,
                        offset=off).reshape(dims).copy()
    off += nbytes
    lod = []
    if off < len(buf):
        (levels,) = struct.unpack_from("<I", buf, off)
        off += 4
        for _ in range(levels):
            (n,) = struct.unpack_from("<Q", buf, off)
            off += 8
            lod.append(list(struct.unpack_from("<%dQ" % n, buf, off)))
            off += 8 * n
    return arr, lod
