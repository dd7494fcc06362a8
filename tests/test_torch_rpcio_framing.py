"""The port's counterpart of ``tests/test_rpcio_framing.py`` (21 cases),
through ``ray_tpu_torch`` with the reference's expected values: every case
is carried under its own name.

Beside them, ``test_same_frame_same_bytes_as_the_reference`` and
``test_corrupted_frame_is_refused_by_both_packages`` hold the codec to the
reference's on numpy-seeded frames: the same bytes, each package decoding
the other's, the same typed corruption error.

The reference's description:

v2 wire-frame codec: out-of-band buffer table round-trips, size
enforcement (both directions), truncation rejection, v1<->v2 preamble
negotiation, and the zero-copy send guarantee (payload buffers reach the
transport by reference, never through the pickle stream).

Pure rpcio/serialization unit tests — no cluster.
"""

import asyncio
import pickle

import numpy as np
import pytest

from ray_tpu_torch._private import rpcio, serialization
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.rpcio import (
    KIND_NOTIFY,
    KIND_REQ,
    Connection,
    Finalized,
    RpcError,
    RpcServer,
    _decode_v2,
    connect,
)


class FakeWriter:
    """Captures every part handed to the transport, by reference."""

    def __init__(self):
        self.writes = []
        self.closed = False

    def write(self, data):
        self.writes.append(data)

    async def drain(self):
        pass

    def close(self):
        self.closed = True


def _conn(version=2):
    return Connection(None, FakeWriter(), name="test", version=version)


def _roundtrip(payload, version=2):
    """Encode one frame, then decode it the way the recv loop would."""
    conn = _conn(version)
    parts = conn._encode_frame(7, KIND_REQ, "m", payload)
    wire = b"".join(bytes(p) for p in parts)
    total = int.from_bytes(wire[:4], "little")
    body = wire[4: 4 + total]
    assert len(body) == total, "frame length header must cover the body"
    if version >= 3:
        return rpcio._decode_v3(body)
    if version == 2:
        return _decode_v2(body)
    return pickle.loads(body)


# ---------------------------------------------------------------- codec --


def test_roundtrip_no_buffers():
    msg_id, kind, method, payload = _roundtrip({"a": 1, "b": "x"})
    assert (msg_id, kind, method) == (7, KIND_REQ, "m")
    assert payload == {"a": 1, "b": "x"}


@pytest.mark.parametrize("nbufs", [1, 2, 7, 32])
def test_roundtrip_buffer_counts(nbufs):
    arrs = [np.arange(i + 1, dtype=np.int64).repeat(200) for i in range(nbufs)]
    _, _, _, payload = _roundtrip({"arrs": arrs})
    assert len(payload["arrs"]) == nbufs
    for got, want in zip(payload["arrs"], arrs):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("size", [0, 1, 511, 512, 513, 1 << 20])
def test_roundtrip_buffer_sizes(size):
    arr = np.full(size, 7, dtype=np.uint8)
    _, _, _, payload = _roundtrip({"arr": arr, "tag": "t"})
    assert payload["tag"] == "t"
    assert np.array_equal(payload["arr"], arr)


def test_roundtrip_fuzz_mixed():
    rng = np.random.RandomState(0)
    for trial in range(25):
        n = int(rng.randint(0, 6))
        sizes = [int(rng.randint(0, 5000)) for _ in range(n)]
        value = {
            "bufs": [np.arange(s, dtype=np.uint8) for s in sizes],
            "blob": bytes(rng.bytes(int(rng.randint(0, 2000)))),
            "n": trial,
        }
        _, _, _, got = _roundtrip(value)
        assert got["n"] == trial
        assert got["blob"] == value["blob"]
        assert len(got["bufs"]) == n
        for g, w in zip(got["bufs"], value["bufs"]):
            assert np.array_equal(g, w)


@pytest.mark.parametrize("nbufs", [0, 1, 3, 32])
def test_v3_crc_roundtrip(nbufs):
    arrs = [np.arange(1000 * (i + 1), dtype=np.int32) for i in range(nbufs)]
    msg_id, kind, method, payload = _roundtrip(
        {"arrs": arrs, "tag": "t"}, version=3)
    assert (msg_id, kind, method) == (7, KIND_REQ, "m")
    assert payload["tag"] == "t"
    for got, want in zip(payload["arrs"], arrs):
        assert np.array_equal(got, want)


def test_v3_crc_detects_head_corruption():
    """Any flipped byte in the CRC-covered head (count byte, table,
    envelope) must raise the typed corruption error."""
    parts = _conn(3)._encode_frame(1, KIND_NOTIFY, "m",
                                   {"arr": np.zeros(4096, dtype=np.uint8)})
    wire = b"".join(bytes(p) for p in parts)
    body = bytearray(wire[4:])
    head_len = len(bytes(parts[0])) - 4  # head part minus the 4B length
    for off in (0, 5, head_len - 5, head_len - 1):
        mutated = bytearray(body)
        mutated[off] ^= 0x01
        with pytest.raises(rpcio.FrameCorruptError):
            rpcio._decode_v3(bytes(mutated))
    # untouched body still decodes
    _, _, _, payload = rpcio._decode_v3(bytes(body))
    assert payload["arr"].nbytes == 4096


def test_frame_exactly_at_max_message_passes():
    GLOBAL_CONFIG.update({"rpc_max_message_bytes": 1 << 20})
    try:
        conn = _conn()
        # binary-search a buffer size whose frame lands exactly on the cap
        lo, hi = 0, 1 << 20
        while lo < hi:
            mid = (lo + hi + 1) // 2
            try:
                conn._encode_frame(1, KIND_REQ, "m",
                                   {"a": np.zeros(mid, dtype=np.uint8)})
                lo = mid
            except RpcError:
                hi = mid - 1
        parts = conn._encode_frame(1, KIND_REQ, "m",
                                   {"a": np.zeros(lo, dtype=np.uint8)})
        wire = b"".join(bytes(p) for p in parts)
        assert int.from_bytes(wire[:4], "little") == (1 << 20)
        _, _, _, payload = _decode_v2(wire[4:])
        assert payload["a"].nbytes == lo
    finally:
        GLOBAL_CONFIG.reset()


# ----------------------------------------------------- size enforcement --


@pytest.mark.parametrize("version", [1, 2])
def test_send_side_oversize_raises_with_method_and_size(version):
    GLOBAL_CONFIG.update({"rpc_max_message_bytes": 10_000})
    try:
        conn = _conn(version)
        with pytest.raises(RpcError) as ei:
            conn._encode_frame(1, KIND_REQ, "push_chunks",
                               {"data": np.zeros(50_000, dtype=np.uint8)})
        msg = str(ei.value)
        assert "push_chunks" in msg and "10000" in msg
        assert not conn.writer.writes, "nothing may reach the wire"
    finally:
        GLOBAL_CONFIG.reset()


def test_request_nowait_oversize_leaves_no_pending_entry():
    async def main():
        GLOBAL_CONFIG.update({"rpc_max_message_bytes": 10_000})
        try:
            conn = _conn()
            with pytest.raises(RpcError):
                conn.request_nowait(
                    "m", {"data": np.zeros(50_000, dtype=np.uint8)})
            assert not conn._pending
            assert not conn.writer.writes
        finally:
            GLOBAL_CONFIG.reset()

    asyncio.run(main())


# ---------------------------------------------------------- truncation --


def _v2_body(payload):
    parts = _conn()._encode_frame(1, KIND_NOTIFY, "m", payload)
    return b"".join(bytes(p) for p in parts)[4:]


def test_truncated_buffer_table_rejected():
    body = _v2_body({"arr": np.zeros(4096, dtype=np.uint8)})
    # claim 200 table entries in a 5-byte body
    with pytest.raises(RpcError):
        _decode_v2(bytes([200]) + body[1:5])


def test_buffers_exceeding_frame_rejected():
    body = bytearray(_v2_body({"arr": np.zeros(4096, dtype=np.uint8)}))
    assert body[0] == 1
    # inflate the recorded buffer length past the frame end
    body[1:5] = (1 << 30).to_bytes(4, "little")
    with pytest.raises(RpcError):
        _decode_v2(bytes(body))


def test_empty_body_rejected():
    with pytest.raises(RpcError):
        _decode_v2(b"")


# ---------------------------------------------------------- negotiation --


class EchoHandler:
    def rpc_echo(self, conn, p):
        return p

    def rpc_finalized(self, conn, p):
        self.released = False

        def _rel():
            self.released = True

        return Finalized({"ok": True}, _rel)


def test_v3_negotiation_and_echo():
    async def main():
        handler = EchoHandler()
        srv = RpcServer(handler)
        port = await srv.start()
        conn = await connect("127.0.0.1", port, name="c", retries=3)
        try:
            assert conn.version == 3  # default: v2 framing + CRC trailer
            (sconn,) = srv.connections
            assert sconn.version == 3
            arr = np.arange(65536, dtype=np.uint8)
            reply = await conn.request("echo", {"arr": arr})
            assert np.array_equal(reply["arr"], arr)
            reply = await conn.request("finalized", {})
            assert reply == {"ok": True}
            # release ran after the response frame was handed off
            for _ in range(10):
                if getattr(handler, "released", False):
                    break
                await asyncio.sleep(0.01)
            assert handler.released
        finally:
            await conn.close()
            await srv.stop()

    asyncio.run(main())


def test_v1_client_against_v2_server():
    async def main():
        srv = RpcServer(EchoHandler())
        port = await srv.start()
        conn = await connect("127.0.0.1", port, name="c", retries=3,
                             version=1)
        try:
            assert conn.version == 1
            for _ in range(100):  # no ack on v1: wait for server accept
                if srv.connections:
                    break
                await asyncio.sleep(0.01)
            (sconn,) = srv.connections
            assert sconn.version == 1
            arr = np.arange(4096, dtype=np.uint8)
            reply = await conn.request("echo", {"arr": arr})
            assert np.array_equal(reply["arr"], arr)
        finally:
            await conn.close()
            await srv.stop()

    asyncio.run(main())


def test_frame_version_flag_pins_v2():
    async def main():
        GLOBAL_CONFIG.update({"rpc_frame_version": 2})
        try:
            srv = RpcServer(EchoHandler())
            port = await srv.start()
            conn = await connect("127.0.0.1", port, name="c", retries=3)
            assert conn.version == 2
            arr = np.arange(65536, dtype=np.uint8)
            reply = await conn.request("echo", {"arr": arr})
            assert np.array_equal(reply["arr"], arr)
            await conn.close()
            await srv.stop()
        finally:
            GLOBAL_CONFIG.reset()

    asyncio.run(main())


def test_frame_version_flag_pins_v1():
    async def main():
        GLOBAL_CONFIG.update({"rpc_frame_version": 1})
        try:
            srv = RpcServer(EchoHandler())
            port = await srv.start()
            conn = await connect("127.0.0.1", port, name="c", retries=3)
            assert conn.version == 1
            reply = await conn.request("echo", {"x": 1})
            assert reply == {"x": 1}
            await conn.close()
            await srv.stop()
        finally:
            GLOBAL_CONFIG.reset()

    asyncio.run(main())


def test_fallback_to_v1_against_legacy_server():
    """A pre-v2 server closes an RTPU2 preamble at the digest compare; the
    client must redial with the v1 preamble and interoperate."""

    async def main():
        handler = EchoHandler()
        legacy_expected = rpcio._auth_preamble(rpcio.cluster_token(), 1)

        async def legacy_accept(reader, writer):
            preamble = await reader.readexactly(rpcio._AUTH_LEN)
            if preamble != legacy_expected:  # unknown magic: close, no ack
                writer.close()
                return
            Connection(reader, writer, handler, name="legacy",
                       version=1).start()

        server = await asyncio.start_server(legacy_accept, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        conn = await connect("127.0.0.1", port, name="c", retries=5,
                             retry_delay=0.05)
        try:
            assert conn.version == 1
            reply = await conn.request("echo", {"x": 42})
            assert reply == {"x": 42}
        finally:
            await conn.close()
            server.close()
            await server.wait_closed()

    asyncio.run(main())


# ------------------------------------------------------------ zero-copy --


def test_1mb_numpy_send_is_zero_copy():
    """The acceptance check: a 1MB array payload crosses _send with a tiny
    pickle envelope and the array's memory handed to the transport BY
    REFERENCE (a memoryview aliasing the array), never copied."""

    async def main():
        conn = _conn()
        arr = np.arange(1 << 20, dtype=np.uint8)
        await conn._send(1, KIND_NOTIFY, "m", {"arr": arr})
        writes = conn.writer.writes
        assert writes, "flush must have run"
        head = bytes(writes[0])
        total = int.from_bytes(head[:4], "little")
        nbufs = head[4]
        assert nbufs == 1
        buf_len = int.from_bytes(head[5:9], "little")
        assert buf_len == arr.nbytes
        # envelope = head minus 4B total, 1B nbufs, 4B table entry
        envelope_len = len(head) - 9
        assert envelope_len < 1024, (
            f"envelope carries payload bytes: {envelope_len}"
        )
        assert total == 1 + 4 + envelope_len + arr.nbytes
        views = [w for w in writes[1:] if isinstance(w, memoryview)]
        assert views, "buffer must be written as its own part"
        assert any(
            v.nbytes == arr.nbytes
            and np.shares_memory(np.frombuffer(v, dtype=np.uint8), arr)
            for v in views
        ), "buffer must alias the array's memory (zero-copy)"

    asyncio.run(main())


def test_serialized_value_slot_is_zero_copy_on_send():
    """The worker inline-arg shape: ('v', metadata, sv.to_wire()) must ship
    the value's array buffer by reference through a v2 connection."""

    async def main():
        arr = np.arange(1 << 20, dtype=np.uint8)
        sv = serialization.serialize({"weights": arr})
        slot = ("v", sv.metadata, sv.to_wire())
        conn = _conn()
        await conn._send(2, KIND_NOTIFY, "execute", {"args": [slot]})
        writes = conn.writer.writes
        views = [w for w in writes if isinstance(w, memoryview)]
        assert any(
            v.nbytes == arr.nbytes
            and np.shares_memory(np.frombuffer(v, dtype=np.uint8), arr)
            for v in views
        ), "inline arg buffer must alias the caller's array"
        head = bytes(writes[0])
        envelope_len = len(head) - 5 - 4 * head[4]
        assert envelope_len < 4096

    asyncio.run(main())


def test_bufferlist_roundtrip_v2_and_v1():
    arr = np.arange(100_000, dtype=np.float32)
    sv = serialization.serialize({"x": arr, "y": "small"})
    for version in (2, 1):
        _, _, _, payload = _roundtrip(
            {"slot": ("v", sv.metadata, sv.to_wire())}, version=version)
        kind, meta, data = payload["slot"]
        assert kind == "v"
        assert isinstance(data, serialization.BufferList)
        value = serialization.deserialize(meta, data)
        assert value["y"] == "small"
        assert np.array_equal(value["x"], arr)


def test_bufferlist_concat_matches_to_bytes():
    arr = np.arange(5000, dtype=np.uint8)
    sv = serialization.serialize([arr, b"tail"])
    assert sv.to_wire().concat() == sv.to_bytes()
    # raw-bytes fast path: to_bytes returns the buffer itself, no copy
    raw = b"z" * 4096
    sv2 = serialization.serialize(raw)
    assert sv2.to_bytes() is raw


# ---------------------------------------------- held against the reference --


def _seeded_payloads(seed):
    """numpy-seeded frames: arrays of mixed dtypes and sizes (0, the
    512-byte out-of-band cut and either side of it, larger), bytes and
    scalars."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(6):
        n = int(rng.integers(0, 5))
        arrs = [rng.standard_normal(int(rng.choice([0, 1, 511, 512, 513,
                                                    4099]))).astype(dt)
                for dt in rng.choice(["float32", "int64", "uint8"], n)]
        out.append({"arrs": arrs, "blob": rng.bytes(int(rng.integers(0, 900))),
                    "n": int(rng.integers(0, 1 << 30)), "tag": "t"})
    return out


def _ref_conn(version):
    from ray_tpu._private import rpcio as ref_rpcio

    return ref_rpcio.Connection(None, FakeWriter(), name="test",
                                version=version)


def _wire(parts):
    return b"".join(bytes(p) for p in parts)


def _decoder(mod, version):
    if version >= 3:
        return mod._decode_v3
    if version == 2:
        return mod._decode_v2
    return pickle.loads


def _equal(got, want):
    assert got["n"] == want["n"] and got["blob"] == want["blob"]
    assert got["tag"] == want["tag"]
    assert len(got["arrs"]) == len(want["arrs"])
    for g, w in zip(got["arrs"], want["arrs"]):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("version", [1, 2, 3])
def test_same_frame_same_bytes_as_the_reference(version):
    """Each seeded frame encodes to the reference's bytes, and each
    package decodes the other's frame back to the payload."""
    from ray_tpu._private import rpcio as ref_rpcio

    for seed in range(4):
        for i, payload in enumerate(_seeded_payloads(seed)):
            port = _wire(_conn(version)._encode_frame(
                7 + i, KIND_REQ, "m", payload))
            ref = _wire(_ref_conn(version)._encode_frame(
                7 + i, KIND_REQ, "m", payload))
            assert port == ref, (seed, i)
            body = port[4:]
            for mod in (rpcio, ref_rpcio):
                msg_id, kind, method, got = _decoder(mod, version)(body)
                assert (msg_id, kind, method) == (7 + i, KIND_REQ, "m")
                _equal(got, payload)


def test_corrupted_frame_is_refused_by_both_packages():
    """The same flipped head byte of a v3 frame raises each package's
    typed corruption error."""
    from ray_tpu._private import rpcio as ref_rpcio

    payload = _seeded_payloads(5)[1]
    body = bytearray(_wire(_conn(3)._encode_frame(1, KIND_NOTIFY, "m",
                                                  payload))[4:])
    body[5] ^= 0x01
    with pytest.raises(rpcio.FrameCorruptError):
        rpcio._decode_v3(bytes(body))
    with pytest.raises(ref_rpcio.FrameCorruptError):
        ref_rpcio._decode_v3(bytes(body))
