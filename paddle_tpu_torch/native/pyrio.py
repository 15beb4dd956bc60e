"""RecordIO in pure Python, a copy of paddle_tpu/native/pyrio.py: the
file format of native/recordio.cc, byte for byte, so a file written by
either package (or by the C++ writer) reads in the other.

    [8-byte magic "PTRIO001"]
    per chunk: u32 num_records | u32 payload_len | u32 crc32(payload) |
               u32 reserved (0) | u32 record lengths[num_records] |
               payload (the records back to back)

A chunk is flushed when it holds `max_chunk_records` records or
`max_chunk_bytes` bytes, and at close.  The scanner checks each chunk's
CRC and raises IOError on a mismatch.
"""

import struct
import zlib

__all__ = ["PyWriter", "PyScanner", "MAGIC"]

MAGIC = b"PTRIO001"
_HDR = struct.Struct("<IIII")


def _crc(payload):
    return zlib.crc32(payload) & 0xFFFFFFFF


class PyWriter:
    def __init__(self, path, max_chunk_records=1000,
                 max_chunk_bytes=32 << 20):
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        self._pending = []
        self._pending_bytes = 0
        self._max_records = max_chunk_records if max_chunk_records > 0 \
            else 1000
        self._max_bytes = max_chunk_bytes if max_chunk_bytes > 0 \
            else 32 << 20

    def write(self, record):
        self._pending.append(bytes(record))
        self._pending_bytes += len(record)
        if len(self._pending) >= self._max_records or \
                self._pending_bytes >= self._max_bytes:
            self._flush()

    def _flush(self):
        if not self._pending:
            return
        payload = b"".join(self._pending)
        self._f.write(_HDR.pack(len(self._pending), len(payload),
                                _crc(payload), 0))
        self._f.write(struct.pack("<%dI" % len(self._pending),
                                  *[len(r) for r in self._pending]))
        self._f.write(payload)
        self._pending = []
        self._pending_bytes = 0

    def close(self):
        if self._f is None:
            return
        self._flush()
        self._f.close()
        self._f = None


class PyScanner:
    def __init__(self, path):
        self._path = path
        self._f = open(path, "rb")
        if self._f.read(len(MAGIC)) != MAGIC:
            self._f.close()
            raise IOError("bad recordio magic in %s" % path)
        self._chunk = []
        self._idx = 0

    def next(self):
        """The next record (bytes); StopIteration at the end."""
        if self._idx >= len(self._chunk):
            hdr = self._f.read(_HDR.size)
            if len(hdr) < _HDR.size:
                raise StopIteration
            n, payload_len, crc, _ = _HDR.unpack(hdr)
            raw = self._f.read(4 * n)
            payload = self._f.read(payload_len)
            if len(raw) < 4 * n or len(payload) < payload_len:
                raise IOError("recordio: truncated chunk in %s"
                              % self._path)
            if _crc(payload) != crc:
                raise IOError("recordio crc mismatch in %s" % self._path)
            self._chunk = []
            off = 0
            for ln in struct.unpack("<%dI" % n, raw):
                self._chunk.append(payload[off:off + ln])
                off += ln
            self._idx = 0
        rec = self._chunk[self._idx]
        self._idx += 1
        return rec

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None
