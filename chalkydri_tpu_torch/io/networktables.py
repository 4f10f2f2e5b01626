"""MiniNT: a from-scratch NetworkTables 4 client (and a loopback server).

The reference had an in-house NT4 client ("MiniNT",
``book/src/maintenance/subprojects.md:5-10``) later replaced
by the external ``nt_client`` crate (``Cargo.toml:40``), used to publish
custom-subsystem outputs to ``/chalkydri/subsystems/{name}`` topics
(``crates/chalkydri/src/subsystems/python/mod.rs:113-120``) and the robot
state schema ``Chalkydri/Robot/...`` (``book/src/networktables.md:1-30``).

This module implements the NT4 wire protocol with the standard library only:

- WebSocket client (RFC 6455 handshake + framing, client-masked),
- NT4 text frames: JSON arrays of {method, params} (publish/announce/...),
- NT4 binary frames: MessagePack-encoded [topic_uid, timestamp_us, type, value]
  (a minimal msgpack codec for the types NT uses is included),
- client API: ``NT4Client.publish(topic, value)`` for double/boolean/string
  plus ``set_many`` batching; ``subscribe(prefixes, callback)`` with a
  reader thread handling announce/value frames; NT4 RTT time sync (pubuid
  -1 ping/echo) so published timestamps ride the SERVER clock
  (``server_time_us()``) like the wpilib client,
- ``MiniNTServer``: a loopback server accepting announces + value frames,
  answering RTT pings, and fanning values out to subscribers — the test
  double standing in for the robot-side NT server (the reference's
  ``tools/ntserver.py`` plays this role with pyntcore).
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import socket
import struct
import threading
import time
from typing import Any, Optional

NT_PORT = 5810  # standard NT4 port
_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
NT_PROTOCOL = "v4.1.networktables.first.wpilib.org"

NT_TYPES = {"boolean": 0, "double": 1, "int": 2, "float": 3, "string": 4}


# ---------------------------------------------------------------------------
# Minimal MessagePack (just what NT4 value frames need)
# ---------------------------------------------------------------------------


def msgpack_encode(obj) -> bytes:
    out = bytearray()

    def enc(v):
        if v is None:
            out.append(0xC0)
        elif isinstance(v, bool):
            out.append(0xC3 if v else 0xC2)
        elif isinstance(v, int):
            if 0 <= v < 128:
                out.append(v)
            elif -32 <= v < 0:
                out.append(v & 0xFF)
            else:
                out.append(0xD3)
                out.extend(struct.pack(">q", v))
        elif isinstance(v, float):
            out.append(0xCB)
            out.extend(struct.pack(">d", v))
        elif isinstance(v, str):
            b = v.encode()
            if len(b) < 32:
                out.append(0xA0 | len(b))
            else:
                out.append(0xDB)
                out.extend(struct.pack(">I", len(b)))
            out.extend(b)
        elif isinstance(v, (list, tuple)):
            if len(v) < 16:
                out.append(0x90 | len(v))
            else:
                out.append(0xDD)
                out.extend(struct.pack(">I", len(v)))
            for x in v:
                enc(x)
        else:
            raise TypeError(f"msgpack: unsupported {type(v)}")

    enc(obj)
    return bytes(out)


def msgpack_decode(data: bytes, offset: int = 0):
    """Decode ONE object; returns (obj, next_offset)."""
    b = data[offset]
    offset += 1
    if b < 0x80:
        return b, offset
    if b >= 0xE0:
        return b - 256, offset
    if 0xA0 <= b <= 0xBF:
        ln = b & 0x1F
        return data[offset : offset + ln].decode(), offset + ln
    if 0x90 <= b <= 0x9F:
        ln = b & 0x0F
        out = []
        for _ in range(ln):
            v, offset = msgpack_decode(data, offset)
            out.append(v)
        return out, offset
    if b == 0xC0:
        return None, offset
    if b == 0xC2:
        return False, offset
    if b == 0xC3:
        return True, offset
    if b == 0xCB:
        return struct.unpack_from(">d", data, offset)[0], offset + 8
    if b == 0xD3:
        return struct.unpack_from(">q", data, offset)[0], offset + 8
    if b == 0xCC:
        return data[offset], offset + 1
    if b == 0xCD:
        return struct.unpack_from(">H", data, offset)[0], offset + 2
    if b == 0xCE:
        return struct.unpack_from(">I", data, offset)[0], offset + 4
    if b == 0xDB:
        ln = struct.unpack_from(">I", data, offset)[0]
        offset += 4
        return data[offset : offset + ln].decode(), offset + ln
    if b == 0xDD:
        ln = struct.unpack_from(">I", data, offset)[0]
        offset += 4
        out = []
        for _ in range(ln):
            v, offset = msgpack_decode(data, offset)
            out.append(v)
        return out, offset
    raise ValueError(f"msgpack: unsupported byte 0x{b:02x}")


# ---------------------------------------------------------------------------
# Minimal WebSocket framing
# ---------------------------------------------------------------------------


def _ws_send(sock: socket.socket, payload: bytes, opcode: int, mask: bool) -> None:
    hdr = bytearray([0x80 | opcode])
    n = len(payload)
    mbit = 0x80 if mask else 0
    if n < 126:
        hdr.append(mbit | n)
    elif n < 1 << 16:
        hdr.append(mbit | 126)
        hdr += struct.pack(">H", n)
    else:
        hdr.append(mbit | 127)
        hdr += struct.pack(">Q", n)
    if mask:
        key = os.urandom(4)
        hdr += key
        payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    sock.sendall(bytes(hdr) + payload)


def _read_exact(sock: socket.socket, n: int, stop=None,
                mid_frame: bool = False) -> bytes:
    """Read exactly n bytes.

    With a polling socket timeout, a timeout MID-FRAME must not discard the
    partial bytes (the next parse would treat payload bytes as a frame
    header and desynchronize the stream — a real hazard on congested WiFi,
    where frames split across TCP segments). mid_frame=True (or any bytes
    already buffered) keeps waiting; an idle timeout at a frame boundary
    propagates so the caller's poll loop can check its stop flag.
    """
    buf = b""
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except socket.timeout:
            if not buf and not mid_frame:
                raise  # idle at frame boundary: caller polls
            if stop is not None and stop.is_set():
                raise ConnectionError("closing mid-frame")
            continue  # mid-frame: the rest of the frame is coming
        if not chunk:
            raise ConnectionError("socket closed")
        buf += chunk
    return buf


def _ws_recv(sock: socket.socket, stop=None):
    """Returns (opcode, payload) of the next frame. Only the FIRST header
    byte read may time out idle; everything after is mid-frame."""
    h = _read_exact(sock, 2, stop=stop)
    opcode = h[0] & 0x0F
    masked = h[1] & 0x80
    n = h[1] & 0x7F
    if n == 126:
        n = struct.unpack(">H", _read_exact(sock, 2, stop=stop, mid_frame=True))[0]
    elif n == 127:
        n = struct.unpack(">Q", _read_exact(sock, 8, stop=stop, mid_frame=True))[0]
    key = _read_exact(sock, 4, stop=stop, mid_frame=True) if masked else None
    payload = _read_exact(sock, n, stop=stop, mid_frame=True)
    if key:
        payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    return opcode, payload


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------


class NT4Client:
    """NT4 client: publish, subscribe, and RTT time sync.

    Usage: ``NT4Client(server_ip).connect(); client.publish("/topic", 1.0)``.
    A reader thread (started by connect) handles announce/value frames and
    RTT echoes. Published values are stamped with ``server_time_us()`` —
    the local monotonic clock corrected by the NT4 RTT handshake (pubuid
    -1 ping, offset = server_ts + rtt/2 - local), matching the wpilib
    nt_client the reference links (Cargo.toml:40)."""

    def __init__(self, host: str, port: int = NT_PORT,
                 identity: str = "chalkydri-tpu", reconnect: bool = True,
                 backoff_initial: float = 0.25, backoff_max: float = 5.0):
        self.host, self.port = host, port
        self.identity = identity
        self._sock: Optional[socket.socket] = None
        self._pubs: dict[str, tuple[int, str]] = {}  # topic -> (pubuid, type)
        self._next_uid = 1
        # Reconnect policy: FRC reality is that the robot-side NT server
        # boots AFTER the coprocessor, and match WiFi drops connections
        # mid-run. With reconnect=True the client retries with exponential
        # backoff, re-announces its publishers and re-sends its
        # subscriptions on every new connection; publishes while
        # disconnected are dropped (the pose stream is high-rate — stale
        # values are worthless by reconnect time).
        self._reconnect = reconnect
        self._backoff_initial = backoff_initial
        self._backoff_max = backoff_max
        # Topics published with retained=True re-send their latest value on
        # every (re)connection (device metadata like .../Version must be
        # visible to a server that boots after us).
        self._retained: dict[str, Any] = {}
        self._lock = threading.Lock()
        self._t0 = time.monotonic_ns()
        # subscribe state
        self._subs: dict[int, tuple] = {}  # subuid -> (prefixes, callback)
        self._announced: dict[int, tuple[str, str]] = {}  # id -> (name, type)
        self.values: dict[str, tuple[Any, int]] = {}  # name -> (value, ts)
        self._values_lock = threading.Lock()
        # RTT sync state
        self._offset_us = 0
        self._rtt_us: Optional[int] = None
        self._rtt_event = threading.Event()
        self._reader: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def _now_us(self) -> int:
        return (time.monotonic_ns() - self._t0) // 1000

    def server_time_us(self) -> int:
        """Local monotonic clock shifted onto the server's timebase (0 until
        the first successful rtt_sync)."""
        return self._now_us() + self._offset_us

    @property
    def connected(self) -> bool:
        return self._sock is not None

    def _connect_once(self, timeout: float = 3.0) -> None:
        """One synchronous handshake attempt; raises on failure."""
        sock = socket.create_connection((self.host, self.port), timeout=timeout)
        key = base64.b64encode(os.urandom(16)).decode()
        req = (
            f"GET /nt/{self.identity} HTTP/1.1\r\n"
            f"Host: {self.host}:{self.port}\r\n"
            "Upgrade: websocket\r\nConnection: Upgrade\r\n"
            f"Sec-WebSocket-Key: {key}\r\n"
            f"Sec-WebSocket-Protocol: {NT_PROTOCOL}\r\n"
            "Sec-WebSocket-Version: 13\r\n\r\n"
        )
        sock.sendall(req.encode())
        resp = b""
        while b"\r\n\r\n" not in resp:
            chunk = sock.recv(4096)
            if not chunk:
                raise ConnectionError("handshake failed")
            resp += chunk
        if b"101" not in resp.split(b"\r\n", 1)[0]:
            sock.close()
            raise ConnectionError(f"handshake rejected: {resp[:100]!r}")
        sock.settimeout(0.2)
        # Server-assigned topic ids do not survive a reconnect.
        self._announced.clear()
        self._sock = sock

    def _on_connected(self, sync: bool) -> None:
        """Restore session state on a (re)connection: re-announce every
        publisher with its recorded type/uid and re-send every
        subscription, then re-sync the server clock."""
        with self._lock:
            for topic, (uid, nt_type) in list(self._pubs.items()):
                msg = [{"method": "publish",
                        "params": {"name": topic, "pubuid": uid,
                                   "type": nt_type, "properties": {}}}]
                _ws_send(self._sock, json.dumps(msg).encode(), opcode=0x1,
                         mask=True)
            for subuid, (prefixes, _cb) in list(self._subs.items()):
                msg = [{"method": "subscribe",
                        "params": {"topics": list(prefixes),
                                   "subuid": subuid,
                                   "options": {"prefix": True}}}]
                _ws_send(self._sock, json.dumps(msg).encode(), opcode=0x1,
                         mask=True)
        if sync:
            try:
                # Fire-and-forget: _on_connected runs on the manager thread
                # BEFORE it enters _reader_loop, and the reader is what
                # consumes the RTT echo — waiting here would always burn the
                # full timeout and then skew the clock offset by ~timeout/2
                # when the stale echo is finally drained (offset math uses
                # consumption time as the arrival time). The reader computes
                # the offset correctly whenever the echo lands.
                self.rtt_sync(wait=False)
            except (OSError, ConnectionError):
                pass
        for topic, value in list(self._retained.items()):
            try:
                self.publish(topic, value)
            except (OSError, ConnectionError, TypeError):
                pass

    def _teardown_sock(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None

    def _manager_loop(self, sync: bool) -> None:
        """Connect -> run the reader inline -> on disconnect, back off and
        retry. Runs until close()."""
        backoff = self._backoff_initial
        while not self._stop.is_set():
            if self._sock is None:
                try:
                    self._connect_once()
                except (OSError, ConnectionError):
                    if self._stop.wait(backoff):
                        return
                    backoff = min(backoff * 2, self._backoff_max)
                    continue
                backoff = self._backoff_initial
                self._on_connected(sync)
            self._reader_loop()  # returns on disconnect or stop
            self._teardown_sock()

    def start(self, sync: bool = True) -> "NT4Client":
        """Begin connecting in the background; never raises. The manager
        thread retries with backoff until a server appears and reconnects
        whenever the link drops."""
        self._stop.clear()
        self._reader = threading.Thread(
            target=self._manager_loop, args=(sync,), daemon=True,
            name="nt4-manager",
        )
        self._reader.start()
        return self

    def connect(self, timeout: float = 3.0, sync: bool = True) -> None:
        """Synchronous connect: raises if the server is unreachable NOW.
        With reconnect enabled, later drops are still healed in the
        background (the reader thread becomes the reconnect manager)."""
        self._connect_once(timeout=timeout)
        self._stop.clear()
        if self._reconnect:
            target, args = self._manager_loop, (sync,)
        else:
            target, args = self._reader_loop, ()
        self._reader = threading.Thread(
            target=target, args=args, daemon=True, name="nt4-reader"
        )
        self._reader.start()
        if sync:
            self.rtt_sync()

    # -- reader -------------------------------------------------------------

    def _reader_loop(self) -> None:
        while not self._stop.is_set():
            # Snapshot: a failed publish may tear the socket down
            # concurrently to signal a reconnect.
            sock = self._sock
            if sock is None:
                return
            try:
                opcode, payload = _ws_recv(sock, stop=self._stop)
            except socket.timeout:
                continue
            except (ConnectionError, OSError):
                return
            if opcode == 0x8:
                return
            if opcode == 0x9:  # ping -> pong
                try:
                    with self._lock:
                        if self._sock is not None:
                            _ws_send(self._sock, payload, opcode=0xA, mask=True)
                except (OSError, ConnectionError):
                    return
            elif opcode == 0x1:
                # Malformed control frames (bad UTF-8/JSON, non-list JSON,
                # missing params) must not kill the reader — a desynced or
                # hostile peer costs us a reconnect at worst, never the
                # telemetry thread (fuzzed in tests/test_io.py).
                try:
                    msgs = json.loads(payload.decode(errors="replace"))
                    if not isinstance(msgs, list):
                        continue
                    for msg in msgs:
                        if not isinstance(msg, dict):
                            continue
                        p = msg.get("params")
                        if not isinstance(p, dict):
                            continue
                        if msg.get("method") == "announce":
                            self._announced[p["id"]] = (
                                p["name"], p.get("type", ""),
                            )
                        elif msg.get("method") == "unannounce":
                            self._announced.pop(p.get("id"), None)
                except (ValueError, KeyError, TypeError):
                    continue
            elif opcode == 0x2:
                off = 0
                while off < len(payload):
                    try:
                        obj, off = msgpack_decode(payload, off)
                        tid, ts, _vt, value = obj
                    except (ValueError, IndexError, TypeError, struct.error):
                        # struct.error: a truncated fixed-width value
                        # (e.g. a float64 tag with fewer than 8 bytes)
                        break
                    if tid == -1:  # RTT echo: value = our original send time
                        now = self._now_us()
                        rtt = now - int(value)
                        self._rtt_us = rtt
                        self._offset_us = int(ts) + rtt // 2 - now
                        self._rtt_event.set()
                        continue
                    name = self._announced.get(tid, (f"id{tid}", ""))[0]
                    with self._values_lock:
                        self.values[name] = (value, int(ts))
                    for prefixes, cb in list(self._subs.values()):
                        if cb and any(name.startswith(p) for p in prefixes):
                            try:
                                cb(name, value, int(ts))
                            except Exception:
                                # A throwing user callback must not kill the
                                # reader thread (no more values, no RTT, no
                                # pongs -> the server drops the connection).
                                import logging

                                logging.getLogger(__name__).warning(
                                    "NT subscribe callback raised for %s",
                                    name, exc_info=True,
                                )

    # -- RTT time sync --------------------------------------------------------

    def rtt_sync(self, timeout: float = 1.0, wait: bool = True
                 ) -> Optional[int]:
        """One NT4 RTT ping (binary frame to topic -1). Returns the measured
        round trip in microseconds (None on timeout) and updates the server
        clock offset used by server_time_us().

        ``wait=False`` sends the ping and returns immediately — required
        when called from the thread that will itself become the reader
        (reconnect path), which could never observe the echo it is waiting
        for; the offset updates when the reader drains the echo."""
        self._rtt_event.clear()
        with self._lock:
            if self._sock is None:
                raise ConnectionError("not connected")
            payload = msgpack_encode([-1, 0, NT_TYPES["double"],
                                      float(self._now_us())])
            _ws_send(self._sock, payload, opcode=0x2, mask=True)
        if not wait:
            return None
        if self._rtt_event.wait(timeout):
            return self._rtt_us
        return None

    # -- subscribe ------------------------------------------------------------

    def subscribe(self, prefixes: list[str], callback=None,
                  options: Optional[dict] = None) -> int:
        """Subscribe to topic prefixes; values land in ``self.values`` and
        (optionally) fire ``callback(name, value, server_ts_us)``. While
        disconnected the subscription is recorded and sent on (re)connect."""
        if self._sock is None and not self._reconnect:
            raise ConnectionError("not connected")
        subuid = self._next_uid
        self._next_uid += 1
        opts = {"prefix": True}
        if options:
            opts.update(options)
        msg = [{"method": "subscribe",
                "params": {"topics": list(prefixes), "subuid": subuid,
                           "options": opts}}]
        self._subs[subuid] = (list(prefixes), callback)
        try:
            with self._lock:
                if self._sock is not None:
                    _ws_send(self._sock, json.dumps(msg).encode(), opcode=0x1,
                             mask=True)
        except (OSError, ConnectionError):
            if not self._reconnect:
                raise
            self._teardown_sock()
        return subuid

    def unsubscribe(self, subuid: int) -> None:
        self._subs.pop(subuid, None)
        try:
            with self._lock:
                if self._sock is not None:
                    msg = [{"method": "unsubscribe",
                            "params": {"subuid": subuid}}]
                    _ws_send(self._sock, json.dumps(msg).encode(), opcode=0x1,
                             mask=True)
        except (OSError, ConnectionError):
            if not self._reconnect:
                raise
            self._teardown_sock()

    def get(self, topic: str, default=None):
        """Latest subscribed value for a topic (or default)."""
        with self._values_lock:
            v = self.values.get(topic)
        return v[0] if v is not None else default

    def _announce_pub(self, topic: str, nt_type: str) -> int:
        uid = self._next_uid
        self._next_uid += 1
        msg = [{"method": "publish",
                "params": {"name": topic, "pubuid": uid, "type": nt_type,
                           "properties": {}}}]
        _ws_send(self._sock, json.dumps(msg).encode(), opcode=0x1, mask=True)
        self._pubs[topic] = (uid, nt_type)
        return uid

    def publish(self, topic: str, value: Any, retained: bool = False) -> None:
        """Publish a double/bool/string value to a topic. While
        disconnected (reconnect pending) the value is dropped silently —
        callers never see transport state. ``retained=True`` re-sends the
        latest value on every (re)connection."""
        if isinstance(value, bool):
            nt_type = "boolean"
        elif isinstance(value, (int, float)):
            nt_type, value = "double", float(value)
        elif isinstance(value, str):
            nt_type = "string"
        else:
            raise TypeError(f"unsupported NT value {type(value)}")
        # Record AFTER type validation: a rejected value must not be
        # re-published (and re-raise) on every reconnect forever.
        if retained:
            self._retained[topic] = value
        try:
            with self._lock:
                if self._sock is None:
                    if self._reconnect:
                        return
                    raise ConnectionError("not connected")
                entry = self._pubs.get(topic)
                uid = entry[0] if entry else self._announce_pub(topic, nt_type)
                payload = msgpack_encode(
                    [uid, self.server_time_us(), NT_TYPES[nt_type], value]
                )
                _ws_send(self._sock, payload, opcode=0x2, mask=True)
        except (OSError, ConnectionError):
            if not self._reconnect:
                raise
            # Kick the reader out of recv so the manager reconnects.
            self._teardown_sock()

    def set_many(self, values: dict[str, Any]) -> None:
        for k, v in values.items():
            self.publish(k, v)

    def close(self) -> None:
        self._stop.set()
        try:
            with self._lock:
                if self._sock is not None:
                    _ws_send(self._sock, b"", opcode=0x8, mask=True)
        except OSError:
            pass
        if self._reader is not None and self._reader.is_alive():
            self._reader.join(timeout=1.0)
        self._teardown_sock()


# ---------------------------------------------------------------------------
# Loopback server (test double; reference: tools/ntserver.py)
# ---------------------------------------------------------------------------


class _ServerConn:
    """One connected client: socket + send lock + subscriptions."""

    def __init__(self, conn: socket.socket):
        self.conn = conn
        self.send_lock = threading.Lock()
        self.pub_names: dict[int, str] = {}  # client pubuid -> topic name
        self.sub_prefixes: dict[int, list[str]] = {}  # subuid -> prefixes
        self.announced_ids: set[int] = set()

    def send(self, payload: bytes, opcode: int) -> None:
        with self.send_lock:
            _ws_send(self.conn, payload, opcode=opcode, mask=False)

    def wants(self, name: str) -> bool:
        return any(
            name.startswith(p)
            for prefixes in self.sub_prefixes.values()
            for p in prefixes
        )


class MiniNTServer:
    """Accepts NT4 clients, records published values, answers RTT pings,
    and fans values out to subscribers (announce + binary value frames)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(4)
        self.port = self._srv.getsockname()[1]
        self.topics: dict[int, str] = {}
        self.values: dict[str, Any] = {}
        # server-assigned topic ids + full topic records for subscriptions
        self._topic_ids: dict[str, int] = {}
        self._topic_meta: dict[str, tuple[int, Any, int]] = {}  # name -> (type, value, ts)
        self._next_topic_id = 1
        self._conns: list[_ServerConn] = []
        self._t0 = time.monotonic_ns()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)

    def _now_us(self) -> int:
        return (time.monotonic_ns() - self._t0) // 1000

    def _topic_id(self, name: str) -> int:
        # Called from multiple per-client handler threads: the
        # check-then-assign must be atomic or two topics can get one id.
        with self._lock:
            tid = self._topic_ids.get(name)
            if tid is None:
                tid = self._next_topic_id
                self._next_topic_id += 1
                self._topic_ids[name] = tid
            return tid

    @staticmethod
    def _type_name(vtype: int) -> str:
        for k, v in NT_TYPES.items():
            if v == vtype:
                return k
        return "double"

    def _announce_to(self, c: _ServerConn, name: str, vtype: int) -> None:
        tid = self._topic_id(name)
        if tid in c.announced_ids:
            return
        c.announced_ids.add(tid)
        msg = [{"method": "announce",
                "params": {"name": name, "id": tid,
                           "type": self._type_name(vtype), "properties": {}}}]
        c.send(json.dumps(msg).encode(), opcode=0x1)

    def _fan_out(self, name: str, vtype: int, value, ts: int,
                 origin: _ServerConn) -> None:
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            if c is origin or not c.wants(name):
                continue
            try:
                self._announce_to(c, name, vtype)
                payload = msgpack_encode([self._topic_id(name), ts, vtype, value])
                c.send(payload, opcode=0x2)
            except (OSError, ConnectionError):
                continue

    def start(self):
        self._thread.start()
        return self

    def _accept_loop(self):
        self._srv.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            threading.Thread(
                target=self._client_loop, args=(conn,), daemon=True
            ).start()
        self._srv.close()

    def _client_loop(self, conn: socket.socket):
        try:
            req = b""
            while b"\r\n\r\n" not in req:
                chunk = conn.recv(4096)
                if not chunk:
                    return
                req += chunk
            key = ""
            for line in req.decode(errors="replace").split("\r\n"):
                if line.lower().startswith("sec-websocket-key:"):
                    key = line.split(":", 1)[1].strip()
            accept = base64.b64encode(
                hashlib.sha1((key + _WS_GUID).encode()).digest()
            ).decode()
            conn.sendall(
                (
                    "HTTP/1.1 101 Switching Protocols\r\n"
                    "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                    f"Sec-WebSocket-Accept: {accept}\r\n"
                    f"Sec-WebSocket-Protocol: {NT_PROTOCOL}\r\n\r\n"
                ).encode()
            )
            conn.settimeout(0.2)
            c = _ServerConn(conn)
            with self._lock:
                self._conns.append(c)
            while not self._stop.is_set():
                try:
                    opcode, payload = _ws_recv(conn, stop=self._stop)
                except socket.timeout:
                    continue
                except (ConnectionError, OSError):
                    return
                if opcode == 0x8:  # close
                    return
                if opcode == 0x1:  # text: publish/subscribe control
                    for msg in json.loads(payload.decode()):
                        method = msg.get("method")
                        p = msg.get("params", {})
                        if method == "publish":
                            with self._lock:
                                self.topics[p["pubuid"]] = p["name"]
                            c.pub_names[p["pubuid"]] = p["name"]
                        elif method == "subscribe":
                            c.sub_prefixes[p["subuid"]] = list(p["topics"])
                            # immediately replay matching cached topics
                            with self._lock:
                                cached = list(self._topic_meta.items())
                            for name, (vtype, value, ts) in cached:
                                if c.wants(name):
                                    self._announce_to(c, name, vtype)
                                    c.send(
                                        msgpack_encode(
                                            [self._topic_id(name), ts, vtype,
                                             value]
                                        ),
                                        opcode=0x2,
                                    )
                        elif method == "unsubscribe":
                            c.sub_prefixes.pop(p.get("subuid"), None)
                elif opcode == 0x2:  # binary: value or RTT ping
                    uid, ts, vtype, value = msgpack_decode(payload)[0]
                    if uid == -1:  # RTT ping: echo with server receipt time
                        c.send(
                            msgpack_encode(
                                [-1, self._now_us(), NT_TYPES["double"], value]
                            ),
                            opcode=0x2,
                        )
                        continue
                    name = c.pub_names.get(uid) or self.topics.get(
                        uid, f"uid{uid}"
                    )
                    with self._lock:
                        self.values[name] = value
                        self._topic_meta[name] = (vtype, value, int(ts))
                    self._fan_out(name, vtype, value, int(ts), origin=c)
        finally:
            with self._lock:
                self._conns = [x for x in self._conns if x.conn is not conn]
            conn.close()

    def stop(self):
        self._stop.set()


def _server_cli():
    """Dev tool: run a loopback NT4 server and print /chalkydri topics —
    parity with the reference's ``tools/ntserver.py`` (a fake robot-side NT
    server for hardware-free testing, SURVEY.md section 4)."""
    import argparse
    import time as _time

    p = argparse.ArgumentParser(prog="minint-server")
    p.add_argument("--port", type=int, default=NT_PORT)
    args = p.parse_args()
    srv = MiniNTServer(host="0.0.0.0", port=args.port).start()
    print(f"MiniNT server on :{srv.port}; printing topic updates (Ctrl-C to stop)")
    seen: dict[str, Any] = {}
    try:
        while True:
            _time.sleep(0.25)
            for k, v in list(srv.values.items()):
                if seen.get(k) != v:
                    seen[k] = v
                    print(f"{k} = {v}")
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":
    _server_cli()
