"""The roboRIO stand-in: a process of its own that receives the App's
64-byte pose packets on a loopback UDP port and stamps each on arrival
on the monotonic clock (``time.monotonic_ns()``), which every process on
the machine shares. It runs apart from the App so that its timing never
waits for the App's interpreter lock.

Each packet's arrival is the kernel's receive stamp (``SO_TIMESTAMPNS``,
the realtime clock, moved onto the monotonic one by their offset read at
start), so a moment the receiver itself waits to be scheduled does not
count; where the kernel gives no stamp, ``time.monotonic_ns()`` at
``recvmsg``'s return.

Run as ``python -m benchmark.receiver``: it binds ``127.0.0.1`` on a free
port and prints the port on a line of its own; it ends on the stop packet
(a 64-byte packet whose camera id and tag count are both 255, sent
through the App's own sender after the last pose, so every pose before it
has been sent) or on a 1-byte datagram, and then writes every packet to
standard output as 8 bytes of little-endian arrival time and the 64
bytes. It also ends, writing what it has, once ``IDLE_S`` seconds pass
without a datagram or its parent is gone.
"""

from __future__ import annotations

import os
import socket
import struct
import sys
import time

PACKET = 64
STOP_ID = 255  # camera id and tag count of the stop packet
IDLE_S = 600.0
_STAMP = struct.Struct("<q")


def is_stop(data: bytes) -> bool:
    return len(data) == 1 or (len(data) == PACKET
                              and data[56] == STOP_ID and data[57] == STOP_ID)


_TIMESPEC = struct.Struct("qq")
# Linux's SO_TIMESTAMPNS (and SCM_TIMESTAMPNS), which ``socket`` may lack
SO_TIMESTAMPNS = getattr(socket, "SO_TIMESTAMPNS", 35)


def clock_offset_ns() -> int:
    """realtime - monotonic, read between two monotonic reads."""
    a = time.monotonic_ns()
    r = time.time_ns()
    b = time.monotonic_ns()
    return r - (a + b) // 2


def arrival_ns(ancdata, offset: int) -> int:
    for level, kind, data in ancdata:
        if (level == socket.SOL_SOCKET and kind == SO_TIMESTAMPNS
                and len(data) >= _TIMESPEC.size):
            sec, nsec = _TIMESPEC.unpack_from(data)
            return sec * 1_000_000_000 + nsec - offset
    return time.monotonic_ns()


def serve(sock: socket.socket, out) -> None:
    parent = os.getppid()
    sock.settimeout(1.0)
    sock.setsockopt(socket.SOL_SOCKET, SO_TIMESTAMPNS, 1)
    offset = clock_offset_ns()
    records = []
    last = time.monotonic()
    while True:
        try:
            data, ancdata, _, _ = sock.recvmsg(256, socket.CMSG_SPACE(
                _TIMESPEC.size))
        except socket.timeout:
            if time.monotonic() - last > IDLE_S or os.getppid() != parent:
                break
            continue
        now = arrival_ns(ancdata, offset)
        last = time.monotonic()
        if is_stop(data):
            break
        if len(data) == PACKET:
            records.append(_STAMP.pack(now) + data)
    out.write(b"".join(records))
    out.flush()


def decode(blob: bytes) -> list:
    """[(arrival ns, 64 packet bytes)] from what ``serve`` wrote."""
    size = _STAMP.size + PACKET
    return [(_STAMP.unpack_from(blob, i)[0], blob[i + _STAMP.size:i + size])
            for i in range(0, len(blob) - size + 1, size)]


def main() -> int:
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 23)
    sock.bind(("127.0.0.1", 0))
    sys.stdout.write(f"{sock.getsockname()[1]}\n")
    sys.stdout.flush()
    try:
        serve(sock, sys.stdout.buffer)
    finally:
        sock.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
