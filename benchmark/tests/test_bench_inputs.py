"""The run's inputs come from its seed alone."""

import json
import os

import numpy as np

from benchmark.harness import BENCH_DIR, ROOT, load_json, load_traffic
from benchmark.scene import Rig, make_scene

CONFIG = "comp2-1600x1304-qd2"


def _cfg():
    return load_json(os.path.join(BENCH_DIR, "configs", f"{CONFIG}.json"))


def test_same_seed_same_frames_and_path():
    cfg, traffic = _cfg(), load_traffic("live", CONFIG)
    layout = os.path.join(ROOT, cfg["field"])
    seed = 2 ** 31 + 12345  # seeds run past 32 signed bits
    a = make_scene(cfg, traffic, layout, seed)
    b = make_scene(cfg, traffic, layout, seed)
    c = make_scene(cfg, traffic, layout, seed + 1)
    assert a.heading == b.heading and a.poses == b.poses and a.tags == b.tags
    for fa, fb in zip(a.frames, b.frames):
        for x, y in zip(fa, fb):
            assert np.array_equal(x, y)
    assert a.poses != c.poses


def test_every_seed_gets_the_same_spread_of_distances_and_tags():
    cfg, traffic = _cfg(), load_traffic("live", CONFIG)
    scene = traffic["scene"]
    rig = Rig(cfg, os.path.join(ROOT, cfg["field"]))
    lo, hi = scene["tags_per_camera"]
    d0, d1 = scene["distance_m"]
    n = scene["poses"]
    for seed in (1, 99, 2 ** 31 + 7):
        s = make_scene(cfg, traffic, os.path.join(ROOT, cfg["field"]), seed)
        dist = sorted(scene["wall_x_m"] - x for x, _ in s.poses)
        for k, d in enumerate(dist):  # one pose in each slice
            assert d0 + (d1 - d0) * k / n <= d <= d0 + (d1 - d0) * (k + 1) / n
        for k, (x, y) in enumerate(s.poses):
            for c in range(len(cfg["mounts"])):
                whole, drawn = rig.visible(c, x, y, s.heading,
                                           scene["margin_px"])
                assert lo <= len(whole) <= hi
                assert sorted(drawn) == sorted(s.tags[c][k])
                frame = s.frames[c][k]
                assert frame.shape == (cfg["height"], cfg["width"])
                assert frame.dtype == np.uint8 and frame.min() == 0


def test_traffic_rate_comes_from_the_configurations_file():
    live = load_traffic("live", CONFIG)
    with open(os.path.join(BENCH_DIR, "traffic", "live", f"{CONFIG}.json")) as f:
        assert live["rate_fps"] == json.load(f)["rate_fps"] > 0
    assert load_traffic("saturate", CONFIG)["arrivals"] == "every_poll"
