"""The port's frame codec and socket transport against the reference's.

Twins of ``tests/test_transport.py``, each run on both packages over
``socketpair`` (no subprocesses); and the port's own surface: a message
over the frame limit crosses as several crc-checked frames, each within the
limit, while one under it is the reference's frame byte for byte; a tensor
crosses as a CPU tensor of its dtype, and a dtype numpy lacks is refused.
"""
import itertools
import socket
import struct
import threading
import zlib

import numpy as np
import pytest
import torch

from repro.runtime import transport as rtransport
from repro_torch.runtime import transport as ttransport

BOTH = pytest.mark.parametrize("tr", [rtransport, ttransport], ids=["reference", "port"])


def _roundtrip_codec(tr, obj):
    return tr.decode_message([bytes(p) for p in tr.encode_message(obj)])


def _wire(tr, obj, seq=3, **kw):
    """Every byte ``tr.send_msg`` writes for ``obj``."""
    a, b = socket.socketpair()
    chunks = []
    reader = threading.Thread(target=lambda: chunks.extend(iter(lambda: b.recv(1 << 16), b"")))
    reader.start()
    try:
        tr.send_msg(a, obj, seq, deadline_s=5.0, **kw)
    finally:
        a.close()
        reader.join(timeout=5.0)
        b.close()
    return b"".join(chunks)


def _send_recv(obj, seq=7, send_kw=None, recv_kw=None):
    """``obj`` through the port's send and receive, the sender threaded."""
    a, b = socket.socketpair()
    t = threading.Thread(target=ttransport.send_msg,
                         args=(a, obj, seq), kwargs=dict(deadline_s=5.0, **(send_kw or {})))
    t.start()
    try:
        return ttransport.recv_msg(b, deadline_s=5.0, **(recv_kw or {}))
    finally:
        t.join(timeout=5.0)
        a.close()
        b.close()


@BOTH
def test_codec_roundtrips_plain_and_array_payloads(tr):
    obj = {
        "op": "ship",
        "args": (3, "append", {"a": np.arange(7, dtype=np.int64),
                               "b": np.linspace(0, 1, 7, dtype=np.float32)}),
        "mask": np.array([True, False, True]),
    }
    out = _roundtrip_codec(tr, obj)
    assert out["op"] == "ship" and out["args"][0] == 3
    np.testing.assert_array_equal(out["args"][2]["a"], obj["args"][2]["a"])
    np.testing.assert_array_equal(out["args"][2]["b"], obj["args"][2]["b"])
    assert out["args"][2]["b"].dtype == np.float32
    np.testing.assert_array_equal(out["mask"], obj["mask"])


def test_codec_lowers_device_arrays_to_host_buffers():
    """The reference lowers a ``jax.Array`` to numpy; the port lowers a
    ``torch.Tensor`` (a strided view included) to one contiguous buffer and
    rebuilds a CPU tensor with the same values and dtype."""
    import jax.numpy as jnp

    arr = jnp.arange(12, dtype=jnp.float32).reshape(3, 4)
    ref = _roundtrip_codec(rtransport, {"x": arr, "nested": [arr * 2]})
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    out = _roundtrip_codec(ttransport, {"x": t, "nested": [t * 2], "view": t.t()})
    assert isinstance(out["x"], torch.Tensor) and out["x"].device.type == "cpu"
    np.testing.assert_array_equal(out["x"].numpy(), ref["x"])
    np.testing.assert_array_equal(out["nested"][0].numpy(), ref["nested"][0])
    assert torch.equal(out["view"], t.t()) and out["view"].is_contiguous()
    # One out-of-band buffer per tensor, none in band: the pickle header is
    # small whatever the tensor's size.
    big = torch.zeros(1 << 16, dtype=torch.int32)
    parts = ttransport.encode_message({"x": big})
    assert len(parts) == 2 and len(parts[1]) == big.numel() * 4 and len(parts[0]) < 512


@BOTH
def test_send_recv_roundtrip_over_socketpair(tr):
    a, b = socket.socketpair()
    try:
        payload = {"v": np.arange(1000), "s": "hello"}
        tr.send_msg(a, payload, seq=42, deadline_s=5.0)
        seq, out = tr.recv_msg(b, deadline_s=5.0)
        assert seq == 42
        np.testing.assert_array_equal(out["v"], payload["v"])
        assert out["s"] == "hello"
        for i in range(5):
            tr.send_msg(a, {"i": i}, seq=i)
        for i in range(5):
            seq, out = tr.recv_msg(b, deadline_s=5.0)
            assert (seq, out["i"]) == (i, i)
    finally:
        a.close()
        b.close()


@BOTH
def test_recv_deadline_raises_timeout(tr):
    a, b = socket.socketpair()
    try:
        with pytest.raises(tr.RpcTimeout):
            tr.recv_msg(b, deadline_s=0.05)
    finally:
        a.close()
        b.close()


@BOTH
def test_recv_partial_frame_then_close_raises_closed(tr):
    a, b = socket.socketpair()
    try:
        a.sendall(tr.MAGIC)  # header cut short
        a.close()
        with pytest.raises(tr.RpcClosed):
            tr.recv_msg(b, deadline_s=5.0)
    finally:
        b.close()


@BOTH
def test_bad_magic_is_a_frame_error(tr):
    a, b = socket.socketpair()
    try:
        a.sendall(b"XXXX" + b"\x00" * (tr._HDR.size - 4))
        with pytest.raises(tr.FrameError):
            tr.recv_msg(b, deadline_s=5.0)
    finally:
        a.close()
        b.close()


@BOTH
def test_bit_flip_in_payload_is_a_frame_error_not_a_pickle_error(tr):
    payload = {"op": "partial", "bits": np.arange(256, dtype=np.int64)}
    parts = tr.encode_message(payload)
    lens = b"".join(len(p).to_bytes(8, "big") for p in parts)
    crc = zlib.crc32(lens)
    for p in parts:
        crc = zlib.crc32(bytes(p), crc)
    frame = bytearray(tr._HDR.pack(tr.MAGIC, 9, len(parts) - 1, crc) + lens
                      + b"".join(bytes(p) for p in parts))
    body_start = tr._HDR.size + len(lens)
    for flip_at in (body_start + 2, len(frame) - 16):
        corrupt = bytearray(frame)
        corrupt[flip_at] ^= 0x10
        a, b = socket.socketpair()
        try:
            a.sendall(corrupt)
            with pytest.raises(tr.FrameError, match="crc mismatch"):
                tr.recv_msg(b, deadline_s=5.0)
        finally:
            a.close()
            b.close()
    a, b = socket.socketpair()
    try:
        a.sendall(frame)
        seq, out = tr.recv_msg(b, deadline_s=5.0)
        assert seq == 9
        np.testing.assert_array_equal(out["bits"], payload["bits"])
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_corrupt_frame_surfaces_as_shard_unavailable_in_rpc_client(pkg):
    if pkg == "reference":
        from repro.core.shard import ShardUnavailableError
        from repro.core.shard_rpc import _ServerProc
        tr = rtransport
    else:
        from repro_torch.core.shard import ShardUnavailableError
        from repro_torch.core.shard_rpc import _ServerProc
        tr = ttransport

    class _FakeProc:
        pid = 0

        def poll(self):
            return None

    a, b = socket.socketpair()
    try:
        sp = _ServerProc.__new__(_ServerProc)
        sp.proc = _FakeProc()
        sp.path = "<socketpair>"
        sp.conn = a
        sp._seq = itertools.count(1)

        def corrupt_responder():
            try:
                tr.recv_msg(b, deadline_s=5.0)
                parts = tr.encode_message({"ok": True, "value": None})
                lens = b"".join(len(p).to_bytes(8, "big") for p in parts)
                body = b"".join(bytes(p) for p in parts)
                b.sendall(tr._HDR.pack(tr.MAGIC, 1, len(parts) - 1, 0xDEADBEEF) + lens + body)
            except tr.TransportError:
                pass

        t = threading.Thread(target=corrupt_responder, daemon=True)
        t.start()
        with pytest.raises(ShardUnavailableError):
            sp.request({"op": "ping", "args": (), "ctl": True}, deadline_s=5.0)
        t.join(timeout=5.0)
    finally:
        a.close()
        b.close()


@BOTH
def test_oversized_frame_refused_on_both_sides(tr, monkeypatch):
    """One frame over the limit is refused by the sender (the port carries
    a message over the frame limit in several frames, so its sender refuses
    when the message limit is the frame limit too) and by the receiver from
    its length prefix, before allocation."""
    big = np.zeros(1 << 20, dtype=np.uint8)
    a, b = socket.socketpair()
    t = None
    try:
        with monkeypatch.context() as m:
            if tr is ttransport:
                m.setattr(ttransport, "MAX_MESSAGE_BYTES", 1024)
            with pytest.raises(tr.FrameError):
                tr.send_msg(a, {"x": big}, seq=1, max_frame_bytes=1024)

        def send_big():
            try:
                tr.send_msg(a, {"x": big}, seq=1, deadline_s=5.0)
            except tr.TransportError:
                pass  # the receiver bailed and closed: expected

        t = threading.Thread(target=send_big, daemon=True)
        t.start()
        with pytest.raises(tr.FrameError):
            tr.recv_msg(b, deadline_s=5.0, max_frame_bytes=1024)
    finally:
        a.close()
        b.close()
        if t is not None:
            t.join(timeout=5.0)


@BOTH
def test_deadline_bounds_a_stalled_peer_mid_message(tr):
    a, b = socket.socketpair()
    done = threading.Event()

    def slow_sender():
        parts = tr.encode_message({"x": np.arange(100)})
        lens = b"".join(len(p).to_bytes(8, "big") for p in parts)
        a.sendall(tr._HDR.pack(tr.MAGIC, 7, len(parts) - 1, 0))
        a.sendall(lens)
        done.wait(2.0)

    t = threading.Thread(target=slow_sender, daemon=True)
    t.start()
    try:
        with pytest.raises(tr.RpcTimeout):
            tr.recv_msg(b, deadline_s=0.2)
    finally:
        done.set()
        t.join(timeout=2.0)
        a.close()
        b.close()


@pytest.mark.parametrize("payload", [
    {"op": "ship", "args": (3, "append", {"a": np.arange(7, dtype=np.int64),
                                          "b": np.linspace(0, 1, 7, dtype=np.float32)})},
    ("partial", np.arange(300, dtype=np.int32), {"k": (1, 2.5, None)}),
    {"bits": np.array([True, False] * 50), "nested": [{"x": np.eye(3)}, (b"raw", "s")]},
    np.arange(1 << 16, dtype=np.float64),
], ids=["dict", "tuple", "nested", "array"])
def test_frames_equal_the_reference_byte_for_byte(payload):
    """Under the frame limit the port's frame is the reference's."""
    assert _wire(ttransport, payload) == _wire(rtransport, payload)


@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32,
                                   torch.int64, torch.float16, torch.float32, torch.float64])
def test_cpu_tensor_round_trip_keeps_its_dtype(dtype):
    t = (torch.arange(-50, 50) % 7).to(dtype).reshape(4, 25)
    seq, out = _send_recv({"t": t, "view": t[:, ::3]})
    assert seq == 7
    for got, want in ((out["t"], t), (out["view"], t[:, ::3])):
        assert got.dtype == dtype and got.device.type == "cpu" and torch.equal(got, want)
    # The rebuilt tensor is writable memory of its own.
    out["t"].view(-1)[0] = out["t"].view(-1)[1]


def test_dtype_numpy_lacks_is_refused():
    with pytest.raises(TypeError, match="bfloat16"):
        ttransport.encode_message({"w": torch.ones(4, dtype=torch.bfloat16)})


def _frames(raw: bytes):
    """Parse a raw byte stream of frames: ``[(magic, seq, nbufs, lens)]``."""
    out, off = [], 0
    hdr = ttransport._HDR
    while off < len(raw):
        magic, seq, nbufs, _ = hdr.unpack_from(raw, off)
        off += hdr.size
        n_lens = 1 if magic == ttransport.MAGIC_CHUNK else nbufs + 1
        lens = struct.unpack_from(f"!{n_lens}Q", raw, off)
        off += 8 * n_lens
        if magic != ttransport.MAGIC_SPLIT:
            off += sum(lens)
        out.append((magic, seq, nbufs, lens))
    return out


def test_message_over_the_frame_limit_crosses_in_frames_within_it():
    cap = 4096
    payload = {"a": np.arange(20_000, dtype=np.int64), "t": torch.arange(5_000, dtype=torch.int32),
               "s": "x" * 3000}
    raw = _wire(ttransport, payload, seq=11, max_frame_bytes=cap)
    frames = _frames(raw)
    assert frames[0][0] == ttransport.MAGIC_SPLIT and len(frames) > 40
    chunks = frames[1:]
    assert [f[2] for f in chunks] == list(range(len(chunks)))  # numbered in order
    assert all(f[0] == ttransport.MAGIC_CHUNK and f[1] == 11 and f[3][0] <= cap for f in chunks)
    assert sum(f[3][0] for f in chunks) == sum(frames[0][3])
    seq, out = _send_recv(payload, seq=11, send_kw=dict(max_frame_bytes=cap),
                          recv_kw=dict(max_frame_bytes=cap))
    assert seq == 11 and out["s"] == payload["s"]
    np.testing.assert_array_equal(out["a"], payload["a"])
    assert torch.equal(out["t"], payload["t"])
    # Split, the message still obeys the frame limit at the receiver: a
    # chunk over its cap is refused.
    a, b = socket.socketpair()
    try:
        a.sendall(raw)
        with pytest.raises(ttransport.FrameError, match="chunk"):
            ttransport.recv_msg(b, deadline_s=5.0, max_frame_bytes=cap // 2)
    finally:
        a.close()
        b.close()


def test_split_message_checks_every_chunk_and_the_declared_total(monkeypatch):
    payload = {"a": np.arange(4_000, dtype=np.int64)}
    raw = bytearray(_wire(ttransport, payload, seq=5, max_frame_bytes=1000))
    a, b = socket.socketpair()
    try:
        corrupt = bytearray(raw)
        corrupt[-10] ^= 0x01  # a bit in the last chunk
        a.sendall(corrupt)
        with pytest.raises(ttransport.FrameError, match="crc mismatch in chunk"):
            ttransport.recv_msg(b, deadline_s=5.0, max_frame_bytes=1000)
    finally:
        a.close()
        b.close()
    # The manifest's declared total is checked before anything is allocated
    # or read: only the manifest is on the wire here.
    manifest_len = ttransport._HDR.size + 8 * (_frames(bytes(raw))[0][2] + 1)
    monkeypatch.setattr(ttransport, "MAX_MESSAGE_BYTES", 16_000)
    a, b = socket.socketpair()
    try:
        a.sendall(bytes(raw[:manifest_len]))
        with pytest.raises(ttransport.FrameError, match="refusing a"):
            ttransport.recv_msg(b, deadline_s=5.0, max_frame_bytes=1000)
    finally:
        a.close()
        b.close()
    with pytest.raises(ttransport.FrameError):
        _wire(ttransport, payload, max_frame_bytes=1000)


def test_limits_are_read_at_call_time(monkeypatch):
    payload = {"a": np.arange(2_000, dtype=np.int64)}
    assert _frames(_wire(ttransport, payload))[0][0] == ttransport.MAGIC
    monkeypatch.setattr(ttransport, "MAX_FRAME_BYTES", 2048)
    frames = _frames(_wire(ttransport, payload))
    assert frames[0][0] == ttransport.MAGIC_SPLIT and all(f[3][0] <= 2048 for f in frames[1:])
    monkeypatch.setenv("REPRO_RPC_MAX_FRAME_BYTES", "1024")
    ttransport.limits_from_env()
    assert ttransport.MAX_FRAME_BYTES == 1024
