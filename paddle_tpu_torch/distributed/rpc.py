"""Length-prefixed typed-wire framing, after the framing half of
paddle_tpu/distributed/rpc.py (`_send_msg`, `_recv_exact`, `_recv_msg`,
`_MAX_FRAME`), over the port's own codec (native/wire.py).

A frame is a u64 little-endian length followed by one `wire.encode`d
message; every protocol message is a dict.  Frames are byte-equal to the
JAX package's, so either package's client talks to either server.  The
parameter-server RPC (VariableServer, RPCClient) waits (ROADMAP.md
queue 1, item 12).
"""

import os
import struct

from ..native.wire import WireError, decode as _wire_decode, \
    encode as _wire_encode

__all__ = ["WireError"]

_HDR = struct.Struct("<Q")
# frame cap: a garbled length prefix must not become an OOM; raise it
# with PADDLE_TPU_MAX_RPC_FRAME (bytes) on both ends, as in paddle_tpu
_MAX_FRAME = int(os.environ.get("PADDLE_TPU_MAX_RPC_FRAME", 1 << 28))


def _send_msg(sock, obj):
    """Encode `obj` and send it as one length-prefixed frame."""
    payload = _wire_encode(obj)
    if len(payload) > _MAX_FRAME:
        raise WireError(
            "outgoing frame is %d bytes, above the %d-byte cap; export "
            "PADDLE_TPU_MAX_RPC_FRAME on both ends to raise it"
            % (len(payload), _MAX_FRAME))
    sock.sendall(_HDR.pack(len(payload)) + payload)


def _recv_exact(sock, n):
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("socket closed mid-message")
        buf.extend(chunk)
    return bytes(buf)


def _recv_msg(sock):
    """One frame's message; WireError on an oversize or malformed frame
    or a message that is not a dict."""
    (n,) = _HDR.unpack(_recv_exact(sock, _HDR.size))
    if n > _MAX_FRAME:
        raise WireError("wire frame length %d exceeds cap" % n)
    msg = _wire_decode(_recv_exact(sock, n))
    if not isinstance(msg, dict):
        raise WireError("protocol message must be a dict, got %s"
                        % type(msg).__name__)
    return msg
