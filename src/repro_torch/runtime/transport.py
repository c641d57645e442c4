"""Shard transport: length-prefixed message framing over stream sockets
(port of ``repro/runtime/transport.py``).

The serving layer's process boundary.  ``repro_torch.core.shard`` routes
every shard op through a shard client; the subprocess backend
(``repro_torch.core.shard_rpc``) carries those ops over a unix-domain socket
with the frame codec here, and so does the standby coordinator's
replication stream (``repro_torch.core.replication``).

1. **Array payloads out of band.**  Messages are pickled with protocol 5
   and out-of-band buffers, so row batches, sketch bit vectors and partial
   aggregates travel as raw buffers after a small pickle header.  A
   ``torch.Tensor`` is lowered at pickling time to one contiguous host
   ``numpy`` buffer plus its dtype and shape (never through torch's own
   storage pickling, which copies in band); the ``.cpu()`` of a CUDA tensor
   is the boundary's one host sync.  The far side rebuilds it as a **CPU**
   tensor: a receiver moves what it keeps onto its own device itself.  A
   dtype numpy lacks (``bfloat16``) is refused, not cast.
2. **Per-op deadlines.**  Every send and receive takes a deadline in
   seconds and raises ``RpcTimeout`` when the peer does not finish the
   transfer in time.
3. **Bounded frames.**  A frame larger than ``MAX_FRAME_BYTES`` is refused
   before allocation on the receive side and before sending on the send
   side, so a corrupt length prefix cannot exhaust memory.  The limits are
   read when a message is sent or received (a test may lower them; a
   server process takes the frame limit from ``REPRO_RPC_MAX_FRAME_BYTES``
   through :func:`limits_from_env`).

Framing (all integers big-endian)::

    magic  4s   b"RPS1"
    seq    u64  request/response correlation id
    nbufs  u32  number of out-of-band buffers
    crc    u32  crc32 over the length table and every payload part
    lens   u64 * (nbufs + 1)   pickle byte-length, then each buffer's
    pickle bytes
    buffer bytes ...

A message whose encoding fits in one frame is sent as exactly that frame.
A larger one (a whole table at the size users hold: 6.7M rows of 9 int32
columns is 241 MB against the 64 MiB frame limit) crosses as a sequence of
frames, each within the limit and each crc-checked:

    manifest  b"RPSM", seq, nbufs, crc32(lens), lens   (no body)
    chunk i   b"RPSC", seq, i, crc32(len + bytes), len (one u64), bytes

The chunks carry the parts' bytes back to back.  The receiver checks the
manifest's declared total against ``MAX_MESSAGE_BYTES`` before it
allocates anything, and every chunk's length against the frame limit.

The crc pins frame integrity: a flipped bit anywhere in the lengths or the
payload surfaces as ``FrameError`` at the boundary, which the RPC layer maps
to ``ShardUnavailableError``, instead of a corrupt pickle failing deep in
the op loop.  The codec is symmetric: servers and clients share
``send_msg``/``recv_msg``.
"""
from __future__ import annotations

import io
import os
import pickle
import socket
import struct
import time
import zlib
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

MAGIC = b"RPS1"
MAGIC_SPLIT = b"RPSM"  # the manifest of a message carried as several frames
MAGIC_CHUNK = b"RPSC"  # one frame of such a message
_HDR = struct.Struct("!4sQII")  # magic, seq, nbufs, crc32
_LEN = struct.Struct("!Q")

#: Refuse frames beyond this size (64 MiB): a corrupted length prefix must
#: not turn into an unbounded allocation.
MAX_FRAME_BYTES = 64 << 20
#: Refuse messages beyond this size, whatever the number of frames they
#: would take.
MAX_MESSAGE_BYTES = 16 << 30
#: Refuse frames that declare more out-of-band buffers than this.
MAX_BUFFERS = 4096


class TransportError(RuntimeError):
    """Base class for transport failures."""


class RpcTimeout(TransportError):
    """The peer did not complete the transfer inside the deadline."""


class RpcClosed(TransportError):
    """The connection was closed (EOF / reset / broken pipe) mid-message."""


class FrameError(TransportError):
    """Malformed or oversized frame: a protocol violation, not a fault."""


class RemoteError(TransportError):
    """An exception raised on the server whose type could not be mapped
    back to a local class; carries the remote type name and message."""

    def __init__(self, remote_type: str, message: str):
        super().__init__(f"{remote_type}: {message}")
        self.remote_type = remote_type
        self.remote_message = message


def limits_from_env() -> None:
    """Take the frame limit from ``REPRO_RPC_MAX_FRAME_BYTES`` when set (a
    server process calls this at start, so it holds the limit of the
    process that spawned it)."""
    global MAX_FRAME_BYTES
    frame = os.environ.get("REPRO_RPC_MAX_FRAME_BYTES")
    if frame:
        MAX_FRAME_BYTES = int(frame)


# ---------------------------------------------------------------------------
# Codec: pickle protocol 5 with out-of-band buffers, torch -> numpy lowering
# ---------------------------------------------------------------------------

# Tensor dtypes that have a numpy dtype (and so a buffer numpy can carry).
_NUMPY_DTYPES = (torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64,
                 torch.float16, torch.float32, torch.float64, torch.complex64, torch.complex128)


def _tensor_from_numpy(host: np.ndarray) -> torch.Tensor:
    """The receiving side of a lowered tensor: a CPU tensor over the
    received buffer (copied only when the buffer is read-only)."""
    return torch.from_numpy(np.require(host, requirements=["W"]))


class _Pickler(pickle.Pickler):
    """Protocol-5 pickler that lowers ``torch.Tensor`` to host ``numpy``.

    A device tensor is not picklable across processes (the peer has its own
    devices), and torch's own reducer copies the storage in band.  Lowering
    at the boundary makes the host sync explicit and single-sited; the
    buffer then rides out of band like any numpy array.
    """

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            if obj.dtype not in _NUMPY_DTYPES:
                raise TypeError(
                    f"a {obj.dtype} tensor cannot cross the transport: numpy has no such "
                    f"dtype (cast it explicitly before sending)")
            host = np.ascontiguousarray(obj.detach().cpu().resolve_conj().resolve_neg().numpy())
            return _tensor_from_numpy, (host,)
        return NotImplemented


def encode_message(obj: Any) -> List[memoryview]:
    """Encode one message into [pickle bytes, buffer, buffer, ...]."""
    buffers: List[pickle.PickleBuffer] = []
    bio = io.BytesIO()
    _Pickler(bio, protocol=5, buffer_callback=buffers.append).dump(obj)
    out: List[memoryview] = [bio.getbuffer()]
    for b in buffers:
        out.append(b.raw())
    return out


def decode_message(parts: List) -> Any:
    """Inverse of ``encode_message`` (parts are any bytes-like objects; a
    writable part gives arrays and tensors that share its memory)."""
    return pickle.loads(parts[0], buffers=[pickle.PickleBuffer(p) for p in parts[1:]])


# ---------------------------------------------------------------------------
# Socket send/recv with deadlines
# ---------------------------------------------------------------------------


def _remaining(deadline_at: Optional[float]) -> Optional[float]:
    if deadline_at is None:
        return None
    rem = deadline_at - time.perf_counter()
    if rem <= 0:
        raise RpcTimeout("deadline exhausted")
    return rem


def _sendall(sock: socket.socket, view: memoryview, deadline_at: Optional[float]) -> None:
    sent = 0
    try:
        while sent < len(view):
            sock.settimeout(_remaining(deadline_at))
            sent += sock.send(view[sent:])
    except socket.timeout as e:
        raise RpcTimeout("send timed out") from e
    except (BrokenPipeError, ConnectionResetError, OSError) as e:
        raise RpcClosed(f"send failed: {e}") from e


def _recv_into(sock: socket.socket, view: memoryview, deadline_at: Optional[float]) -> None:
    got, n = 0, len(view)
    try:
        while got < n:
            sock.settimeout(_remaining(deadline_at))
            k = sock.recv_into(view[got:], n - got)
            if k == 0:
                raise RpcClosed("peer closed mid-message")
            got += k
    except socket.timeout as e:
        raise RpcTimeout("recv timed out") from e
    except (ConnectionResetError, OSError) as e:
        raise RpcClosed(f"recv failed: {e}") from e


def _recv_exact(sock: socket.socket, n: int, deadline_at: Optional[float]) -> bytearray:
    buf = bytearray(n)
    _recv_into(sock, memoryview(buf), deadline_at)
    return buf


def _deadline(deadline_s: Optional[float]) -> Optional[float]:
    return time.perf_counter() + deadline_s if deadline_s is not None else None


def send_msg(sock: socket.socket, obj: Any, seq: int, deadline_s: Optional[float] = None,
             max_frame_bytes: Optional[int] = None) -> None:
    """Frame and send one message (several frames when its encoding is
    over the frame limit); raises RpcTimeout/RpcClosed/FrameError."""
    frame_cap = MAX_FRAME_BYTES if max_frame_bytes is None else max_frame_bytes
    message_cap = MAX_MESSAGE_BYTES
    deadline_at = _deadline(deadline_s)
    parts = encode_message(obj)
    total = sum(len(p) for p in parts)
    if total > message_cap or (total > frame_cap and len(parts) - 1 > MAX_BUFFERS):
        raise FrameError(
            f"refusing to send a {total}-byte message of {len(parts) - 1} buffers "
            f"(frame cap {frame_cap}, message cap {message_cap})")
    lens = struct.pack(f"!{len(parts)}Q", *(len(p) for p in parts))
    if total <= frame_cap:
        crc = zlib.crc32(lens)
        for p in parts:
            crc = zlib.crc32(p, crc)
        _sendall(sock, memoryview(_HDR.pack(MAGIC, seq, len(parts) - 1, crc) + lens),
                 deadline_at)
        for p in parts:
            _sendall(sock, p, deadline_at)
        return
    _send_split(sock, parts, lens, seq, max(frame_cap, 1), deadline_at)


def _send_split(sock: socket.socket, parts: List[memoryview], lens: bytes, seq: int,
                chunk_cap: int, deadline_at: Optional[float]) -> None:
    """The manifest, then the parts' bytes in chunks of at most
    ``chunk_cap`` bytes, each its own crc-checked frame."""
    _sendall(sock, memoryview(_HDR.pack(MAGIC_SPLIT, seq, len(parts) - 1, zlib.crc32(lens))
                              + lens), deadline_at)
    index, pieces, size = 0, [], 0

    def flush():
        nonlocal index, pieces, size
        head = _LEN.pack(size)
        crc = zlib.crc32(head)
        for piece in pieces:
            crc = zlib.crc32(piece, crc)
        _sendall(sock, memoryview(_HDR.pack(MAGIC_CHUNK, seq, index, crc) + head), deadline_at)
        for piece in pieces:
            _sendall(sock, piece, deadline_at)
        index, pieces, size = index + 1, [], 0

    for p in parts:
        off = 0
        while off < len(p):
            take = min(chunk_cap - size, len(p) - off)
            pieces.append(p[off:off + take])
            size += take
            off += take
            if size == chunk_cap:
                flush()
    if size:
        flush()


def recv_msg(sock: socket.socket, deadline_s: Optional[float] = None,
             max_frame_bytes: Optional[int] = None) -> Tuple[int, Any]:
    """Receive and decode one message; returns ``(seq, obj)``."""
    frame_cap = MAX_FRAME_BYTES if max_frame_bytes is None else max_frame_bytes
    message_cap = MAX_MESSAGE_BYTES
    deadline_at = _deadline(deadline_s)
    magic, seq, nbufs, want_crc = _HDR.unpack(bytes(_recv_exact(sock, _HDR.size, deadline_at)))
    if magic not in (MAGIC, MAGIC_SPLIT):
        raise FrameError(f"bad magic {magic!r}")
    if nbufs > MAX_BUFFERS:
        raise FrameError(f"implausible buffer count {nbufs}")
    lens_raw = bytes(_recv_exact(sock, 8 * (nbufs + 1), deadline_at))
    lens = struct.unpack(f"!{nbufs + 1}Q", lens_raw)
    if magic == MAGIC:
        if sum(lens) > frame_cap:
            raise FrameError(f"refusing {sum(lens)}-byte frame (cap {frame_cap})")
        parts = [_recv_exact(sock, n, deadline_at) for n in lens]
        crc = zlib.crc32(lens_raw)
        for p in parts:
            crc = zlib.crc32(p, crc)
        if crc != want_crc:
            # Verified BEFORE unpickling: corruption must fail at the frame
            # boundary, never as an arbitrary error inside pickle.loads.
            raise FrameError(f"crc mismatch (frame {want_crc:#010x}, computed {crc:#010x})")
        return seq, decode_message(parts)
    if zlib.crc32(lens_raw) != want_crc:
        raise FrameError("crc mismatch in a message manifest")
    total = sum(lens)
    if total > message_cap:
        raise FrameError(f"refusing a {total}-byte message (cap {message_cap})")
    body = bytearray(total)
    view = memoryview(body)
    got, index = 0, 0
    while got < total:
        cmagic, cseq, cindex, ccrc = _HDR.unpack(
            bytes(_recv_exact(sock, _HDR.size, deadline_at)))
        if cmagic != MAGIC_CHUNK or cseq != seq or cindex != index:
            raise FrameError(f"expected chunk {index} of message {seq}, got "
                             f"{cmagic!r} chunk {cindex} of {cseq}")
        head = bytes(_recv_exact(sock, _LEN.size, deadline_at))
        (n,) = _LEN.unpack(head)
        if n == 0 or n > frame_cap or got + n > total:
            raise FrameError(f"refusing a {n}-byte chunk (cap {frame_cap}, "
                             f"{total - got} bytes left of the message)")
        _recv_into(sock, view[got:got + n], deadline_at)
        if zlib.crc32(view[got:got + n], zlib.crc32(head)) != ccrc:
            raise FrameError(f"crc mismatch in chunk {index} of message {seq}")
        got += n
        index += 1
    parts, off = [], 0
    for n in lens:
        parts.append(view[off:off + n])
        off += n
    return seq, decode_message(parts)
