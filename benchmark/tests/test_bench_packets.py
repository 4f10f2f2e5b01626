"""Packets: decoding, the receiver's framing, and matching each pose packet
to the frame it answers."""

import struct

from benchmark import harness, receiver
from benchmark.harness import PACKET, Observed, Polled, StandInCamera


def _packet(cam, n_tags, ts_us, x=1.0, y=2.0, yaw=0.1):
    return PACKET.pack(x, y, yaw, 0.01, 0.01, 0.05, ts_us, cam, n_tags)


def test_packet_layout_is_whacknets():
    from chalkydri_tpu_torch.io.whacknet import (
        RobotPose,
        VisionUncertainty,
        encode_measurement,
    )

    wire = encode_measurement(RobotPose(1.5, -2.0, 0.25),
                              VisionUncertainty(0.1, 0.2, 0.3), 12345, 1, 3)
    assert PACKET.size == 64 and len(wire) == 64
    assert PACKET.unpack(wire) == (1.5, -2.0, 0.25, 0.1, 0.2, 0.3, 12345, 1,
                                   3)


def test_receiver_framing_and_stop():
    recs = [(10 ** 12 + i, _packet(i % 2, 2, i)) for i in range(5)]
    blob = b"".join(struct.pack("<q", t) + d for t, d in recs)
    assert receiver.decode(blob) == recs
    assert receiver.is_stop(b"S")
    assert receiver.is_stop(_packet(255, 255, 0))
    assert not receiver.is_stop(_packet(0, 255, 0))


def _cams(dues_by_cam):
    cams = []
    for dues in dues_by_cam:
        cam = StandInCamera([None], 8, 8)
        cam.arm("every_poll", 0, 10 ** 12)
        cam.polled = [Polled(n, 0, d, d) for n, d in enumerate(dues)]
        cams.append(cam)
    return cams


def _sent(cam, n, latency_us, x):
    """The step's output for a frame as ``Recorder.frames`` gives it, and
    the packet the App sent for it."""
    pose = (x, 2.0, 0.1, 0.01, 0.01, 0.05, 3)
    return ([], [], pose), _packet(cam, 3, latency_us, x=x)


def test_each_frame_takes_the_packet_that_carries_its_pose():
    ms = 1_000_000
    cams = _cams([[100 * ms, 125 * ms, 150 * ms], [112 * ms, 137 * ms]])
    detections, packets = [{}, {}], []
    for c, cam in enumerate(cams):
        for p in cam.polled:
            out, data = _sent(c, p.n, 9_000, x=float(p.n + 10 * c))
            detections[c][p.n] = out
            sent = p.due_ns + 9 * ms
            # the receiver stalls from 105 to 140 ms: what was sent then
            # arrives at 140 ms, in order, and the first frame's arrival
            # less its latency lands past the second frame's due time,
            # which a match by time alone would take for that frame's
            arrival = 140 * ms if 105 * ms <= sent < 140 * ms else sent
            packets.append((arrival, sent, data))
    # a heartbeat carries no pose; a set-up frame's packet is before t0
    packets.append((126 * ms, 126 * ms, _packet(0, 0, 26_000)))
    packets.append((95 * ms, 95 * ms, _packet(1, 3, 6_000)))
    packets = [(a, d) for a, _, d in sorted(packets)]
    obs = Observed(cams=cams, packets=packets, detections=detections,
                   t0=90 * ms, t_end=160 * ms, drain_end=200 * ms)
    m = harness.match_packets(obs)
    assert m["unmatched"] == 0
    assert sorted(m["matched"]) == [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1)]
    for (c, n), got in m["matched"].items():
        assert got[0] == float(n + 10 * c)


def test_packets_without_their_frame_are_unmatched():
    ms = 1_000_000
    cams = _cams([[100 * ms, 125 * ms]])
    out0, data0 = _sent(0, 0, 10_000, x=1.0)
    _, stray = _sent(0, 0, 11_000, x=5.0)  # a pose no frame was sent with
    out1, _ = _sent(0, 1, 10_000, x=2.0)  # its packet never came
    obs = Observed(cams=cams, packets=[(110 * ms, data0), (111 * ms, stray),
                                       (112 * ms, _packet(3, 2, 12_000))],
                   detections=[{0: out0, 1: out1}],
                   t0=90 * ms, t_end=130 * ms, drain_end=140 * ms)
    m = harness.match_packets(obs)
    assert list(m["matched"]) == [(0, 0)] and m["unmatched"] == 2


def test_free_running_camera_skips_replaced_frames():
    ms = 1_000_000
    frames = ["f0", "f1", "f2"]
    cam = StandInCamera(frames, 8, 8)
    cam.arm("free_running", 10 ** 9, 10 ** 9 + 100 * ms, rate=40.0,
            offset_periods=0.5)
    assert cam.offset_ns == 12_500_000
    dues = [cam.due_ns(n) for n, _, _ in cam.offered()]
    assert dues == [10 ** 9 + 12_500_000 + 25 * ms * n for n in range(4)]
    assert cam.last_due() == 3
