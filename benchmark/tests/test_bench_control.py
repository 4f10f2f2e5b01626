"""On a card: the control (the plain reference with TF32 on, the precision
below the float32 the configuration states) fails the limits the program
passes, at a size a test run holds (4 poses of the deployed rig)."""

import os

import pytest

from benchmark import compare
from benchmark.harness import BENCH_DIR, ROOT, load_json, load_traffic
from benchmark.scene import make_scene


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["comp2-1600x1304-qd2",
                                    "comp2-1600x1304-qd1"])
def test_tf32_control_fails_the_limits(cuda_device, config):
    cfg = load_json(os.path.join(BENCH_DIR, "configs", f"{config}.json"))
    limits = load_json(os.path.join(BENCH_DIR, "limits", f"{config}.json"))
    traffic = load_traffic("live", config)
    traffic["scene"] = dict(traffic["scene"], poses=4)
    layout = os.path.join(ROOT, cfg["field"])
    failed = 0
    for seed in (31, 32, 33):
        scene = make_scene(cfg, traffic, layout, seed)
        ref = compare.reference_outputs(cfg, scene, layout, cuda_device)
        ctl = compare.reference_outputs(cfg, scene, layout, cuda_device,
                                        precision="tf32")
        same = compare.control_gaps(ref, ref, scene).v
        assert compare.judge(same, limits)[0]
        ok, _ = compare.judge(compare.control_gaps(ctl, ref, scene).v, limits)
        failed += not ok
    assert failed == 3
