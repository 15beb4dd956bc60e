"""Reader composition toolkit, after paddle_tpu/reader (reference
python/paddle/reader/).

A *reader creator* is a zero-argument callable returning an iterator
over samples; the decorators compose reader creators functionally
(map_readers, shuffle, chain, compose, buffered, firstn, cache,
xmap_readers, multiprocess_reader, retry_reader), `batch` groups
samples, and `prefetch_to_device` stages the next batches on the card
from a background thread (the Trainer's `FLAGS.reader_prefetch_depth`).
"""

from .decorator import (
    map_readers, buffered, compose, chain, shuffle, firstn, xmap_readers,
    cache, ComposeNotAligned, multiprocess_reader, PipeReader, Fake,
    retry_reader, prefetch_to_device, ReaderWorkerFailed,
)
from . import creator

__all__ = [
    "map_readers", "buffered", "compose", "chain", "shuffle", "firstn",
    "xmap_readers", "cache", "batch", "ComposeNotAligned", "creator",
    "multiprocess_reader", "PipeReader", "Fake", "retry_reader",
    "prefetch_to_device", "ReaderWorkerFailed",
]


def batch(reader, batch_size, drop_last=False):
    """Group samples into lists of `batch_size` (reference
    python/paddle/batch.py)."""

    def batch_reader():
        b = []
        for sample in reader():
            b.append(sample)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader
