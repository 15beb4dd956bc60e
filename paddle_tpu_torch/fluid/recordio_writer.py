"""RecordIO dataset conversion, after paddle_tpu/fluid/recordio_writer.py
(reference python/paddle/fluid/recordio_writer.py): a reader's samples
written to RecordIO files, one record a sample, over the port's
pure-Python RecordIO and tensor serialization (native/__init__.py), so
the files are the JAX package's byte for byte.

A record is a sample: u32 field count, then per field a u64 length and
the field's `serialize_tensor` bytes.  `recordio_reader` inverts it.
"""

import os
import struct

import numpy as np

from ..native import (RecordIOScanner, RecordIOWriter, deserialize_tensor,
                      serialize_tensor)

__all__ = ["convert_reader_to_recordio_file",
           "convert_reader_to_recordio_files", "recordio_reader"]


def _serialize_sample(sample):
    """One sample (a tuple of arrays, or one array) -> its record."""
    if not isinstance(sample, (tuple, list)):
        sample = (sample,)
    parts = [struct.pack("<I", len(sample))]
    for field in sample:
        t = serialize_tensor(np.asarray(field))
        parts.append(struct.pack("<Q", len(t)))
        parts.append(t)
    return b"".join(parts)


def _deserialize_sample(rec):
    """A record -> the sample's tuple of arrays (one array for a sample
    of one field)."""
    rec = memoryview(rec)    # the fields are read in place, not copied
    (n,) = struct.unpack_from("<I", rec, 0)
    off = 4
    fields = []
    for _ in range(n):
        (ln,) = struct.unpack_from("<Q", rec, off)
        off += 8
        arr, _lod = deserialize_tensor(rec[off:off + ln])
        off += ln
        fields.append(arr)
    return tuple(fields) if len(fields) > 1 else fields[0]


def convert_reader_to_recordio_file(filename, reader_creator, feeder=None,
                                    compressor=None, max_num_records=1000,
                                    feed_order=None):
    """Every sample of the reader into one RecordIO file; returns the
    number of records written."""
    count = 0
    with RecordIOWriter(filename, max_chunk_records=max_num_records) as w:
        for sample in reader_creator():
            w.write(_serialize_sample(sample))
            count += 1
    return count


def convert_reader_to_recordio_files(filename, batch_per_file,
                                     reader_creator, feeder=None,
                                     compressor=None, max_num_records=1000,
                                     feed_order=None):
    """The reader's samples sharded over RecordIO files of at most
    `batch_per_file` records each, named '<stem>-00000<ext>',
    '<stem>-00001<ext>', ... (reference recordio_writer.py:91); returns
    the files written."""
    stem, ext = os.path.splitext(filename)
    files = []
    writer = None
    in_file = 0
    try:
        for sample in reader_creator():
            if writer is None or in_file >= batch_per_file:
                if writer is not None:
                    writer.close()
                path = "%s-%05d%s" % (stem, len(files), ext)
                writer = RecordIOWriter(path,
                                        max_chunk_records=max_num_records)
                files.append(path)
                in_file = 0
            writer.write(_serialize_sample(sample))
            in_file += 1
    finally:
        if writer is not None:
            writer.close()
    return files


def recordio_reader(filename):
    """A reader creator over a RecordIO file of samples: each record
    back as its tuple of arrays."""

    def reader():
        with RecordIOScanner(filename) as s:
            for rec in s:
                yield _deserialize_sample(rec)

    return reader
