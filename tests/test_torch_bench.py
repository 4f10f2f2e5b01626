"""``bench.py``'s twin, ``chalkydri_tpu_torch/bench.py``, on the CPU.

The twin reads ``bench.py``'s frame and the JAX package's outputs of
``bench.py``'s step from ``chalkydri_tpu_torch/tools/bench_scene.npz``,
because the card machine has neither OpenCV nor JAX. Here:

- the stored frame is ``bench.build_scene()`` bit for bit, and the stored
  outputs are a fresh run of JAX's ``make_vision_pipeline`` on
  ``bench.py``'s rig (4 copies of the frame, gyro 0);
- the twin's ``build_rig(device="cpu")`` and its step give both JAX
  outputs: integers equal, floats within ``tests/test_torch_pipeline.py``'s
  ``CORNER_TOL`` / ``POSE_TOL`` / ``YAW_TOL`` (decision margins 1e-3
  relative, std-devs 1e-2 relative);
- ``bench_gpu``'s loop runs at ``iters=2, reps=1``, and ``main`` prints
  one JSON line with ``bench.py``'s keys and the twin's own.

``write_bench_scene`` writes the ``.npz``; run it where cv2 and JAX are
installed, under this suite's JAX settings:

    JAX_PLATFORMS=cpu python -c "import tests.conftest, tests.test_torch_bench as t; t.write_bench_scene()"
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from chalkydri_tpu.geometry import parse_field_layout as jax_parse_layout
from chalkydri_tpu.pipeline import build_rig_from_config as jax_build_rig
from chalkydri_tpu.pipeline import make_vision_pipeline as jax_pipeline
from chalkydri_tpu_torch import bench as twin
from chalkydri_tpu_torch.detector.pipeline import Detections
from chalkydri_tpu_torch.pipeline import VisionOutput, make_vision_pipeline
from tests.test_torch_pipeline import CORNER_TOL, POSE_TOL, YAW_TOL

torch.set_num_threads(1)

FLOAT_FIELDS = ("corners", "decision_margins", "pose_x", "pose_y",
                "pose_yaw", "std_devs")
OUTPUT_FIELDS = twin.INT_FIELDS + FLOAT_FIELDS
NEW_KEYS = {"cpu_ref", "step_ms_median", "step_ms_max", "card"}


def _as_dict(out) -> dict:
    """The output leaves of a VisionOutput (JAX's or the port's) by name,
    as numpy arrays."""
    return {name: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for name, v in (*zip(out._fields[:-1], out[:-1]),
                            *zip(out.detections._fields, out.detections))}


def jax_bench_rig():
    """``bench.py``'s rig in JAX (``bench.py:68-95``)."""
    calib = {"fx": 1100.0, "fy": 1100.0, "cx": bench.W / 2,
             "cy": bench.H / 2, "k1": 0.0, "k2": 0.0, "p1": 0.0, "p2": 0.0,
             "k3": 0.0, "width": bench.W, "height": bench.H}
    tags = [{"ID": t, "pose": {
        "translation": {"x": 10.0 + 0.5 * t, "y": 4.0, "z": 1.0},
        "rotation": {"quaternion": {"W": 0.0, "X": 0.0, "Y": 0.0, "Z": 1.0}}}}
        for t in (1, 5, 9, 13)]
    layout = jax_parse_layout(
        {"tags": tags, "field": {"length": 16.5, "width": 8.0}},
        dtype=jnp.float32)
    cams = [{"calib": json.dumps({"OpenCVModel5": calib}),
             "robot_to_cam": json.dumps({"roll": 0, "pitch": 0, "yaw": 0,
                                         "x": 0, "y": 0, "z": 1.0})}
            ] * bench.BATCH
    return (layout, *jax_build_rig(cams, layout))


def jax_bench_outputs(frame: np.ndarray) -> dict:
    """JAX's step on ``bench.py``'s rig, 4 copies of ``frame``, gyro 0."""
    frames = np.broadcast_to(frame, (bench.BATCH, bench.H, bench.W)).copy()
    out = jax_pipeline(*jax_bench_rig())(
        jnp.asarray(frames), jnp.zeros(bench.BATCH, jnp.float32))
    return _as_dict(out)


def write_bench_scene(path: str = twin.SCENE) -> None:
    """Write ``bench.build_scene()``'s frame and JAX's outputs on it."""
    frame = bench.build_scene()
    outs = jax_bench_outputs(frame)
    np.savez_compressed(path, frame=frame,
                        **{k: outs[k] for k in OUTPUT_FIELDS})


def _assert_same(got: dict, want: dict) -> None:
    for name in twin.INT_FIELDS:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    valid = want["valid"]
    np.testing.assert_allclose(got["corners"][valid], want["corners"][valid],
                               atol=CORNER_TOL, rtol=0)
    for name, tol in (("pose_x", POSE_TOL), ("pose_y", POSE_TOL),
                      ("pose_yaw", YAW_TOL)):
        np.testing.assert_allclose(got[name], want[name], atol=tol, rtol=0,
                                   err_msg=name)
    for name, rtol, keep in (("decision_margins", 1e-3, valid),
                             ("std_devs", 1e-2, np.s_[:])):
        g, w = got[name][keep], want[name][keep]
        assert (np.abs(g - w) <= rtol * np.maximum(1.0, np.abs(w))).all(), name


@pytest.fixture(scope="module")
def ref():
    return twin.load_reference()


@pytest.fixture(scope="module")
def frames(ref):
    return np.broadcast_to(ref["frame"], (bench.BATCH, bench.H, bench.W)).copy()


@pytest.fixture(scope="module")
def jax_out(ref):
    return jax_bench_outputs(ref["frame"])


@pytest.fixture(scope="module")
def port_out(frames):
    layout, params, rc = twin.build_rig("cpu")
    step = make_vision_pipeline(layout, params, rc, device="cpu")
    return _as_dict(step(torch.from_numpy(frames),
                         torch.zeros(bench.BATCH, dtype=torch.float32)))


def test_stored_frame_is_bench_scene(ref):
    want = bench.build_scene()
    assert ref["frame"].dtype == np.uint8 and ref["frame"].shape == (800, 1280)
    np.testing.assert_array_equal(ref["frame"], want)
    np.testing.assert_array_equal(twin.build_scene(), want)


def test_stored_arrays_are_the_named_outputs(ref):
    assert set(ref) == {"frame", *OUTPUT_FIELDS}


def test_stored_outputs_equal_a_fresh_jax_run(ref, jax_out):
    _assert_same(ref, jax_out)
    # bench.py's scene: all four tags in every frame, one pose for all.
    assert (ref["valid"].sum(axis=1) == 4).all()
    assert ref["pose_valid"].all() and (ref["tag_count"] == 4).all()


@pytest.mark.parametrize("against", ["jax", "stored"])
def test_port_step_equals_jax(ref, jax_out, port_out, against):
    _assert_same(port_out, jax_out if against == "jax" else ref)


def test_port_rig_is_bench_rig():
    layout_j, params_j, rc_j = jax_bench_rig()
    layout, params, rc = twin.build_rig("cpu")
    assert params.device.type == "cpu"
    np.testing.assert_array_equal(params.numpy(), np.asarray(params_j))
    for got, want in ((layout.rotations, layout_j.rotations),
                      (layout.translations, layout_j.translations),
                      (rc.rotation, rc_j.rotation),
                      (rc.translation, rc_j.translation)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_array_equal(layout.present.numpy(),
                                  np.asarray(layout_j.present))
    assert layout.field_size == layout_j.field_size


@pytest.mark.parametrize("field,delta", [("ids", 1), ("pose_valid", True),
                                         ("pose_x", 2e-3), ("corners", 2e-3),
                                         ("decision_margins", 0.2)])
def test_check_outputs_refuses_a_different_result(ref, field, delta):
    """The gate ``main`` applies before it prints: one field moved past
    its tolerance raises."""
    def t(name):
        return torch.from_numpy(ref[name].copy())

    dets = Detections(**{n: t(n) for n in Detections._fields})
    out = VisionOutput(*(t(n) for n in VisionOutput._fields[:-1]),
                       detections=dets)
    twin.check_outputs(out, ref, "stored")
    moved = ref[field].copy()
    if moved.dtype == bool:
        moved[0] = ~moved[0]
    else:
        moved.reshape(-1)[0] += delta
    with pytest.raises(AssertionError, match=field):
        twin.check_outputs(out, dict(ref, **{field: moved}), "moved")


def test_bench_gpu_loop_on_cpu(ref, frames):
    res = twin.bench_gpu(frames, iters=2, reps=1, device="cpu")
    assert len(res.step_ms) == 1 and res.step_ms[0] > 0
    assert res.fps == pytest.approx(bench.BATCH / res.step_ms[0] * 1e3)
    assert res.n_det == 4 and res.card == "cpu"
    twin.check_outputs(res.out, ref, "cpu step")


def test_main_prints_bench_keys_and_its_own(monkeypatch, capsys):
    # bench.py's own line, its measurements stubbed, gives its keys.
    monkeypatch.setattr(bench, "build_scene",
                        lambda: np.zeros((bench.H, bench.W), np.uint8))
    monkeypatch.setattr(bench, "bench_cpu_reference", lambda f: (1.0, [1.0]))
    monkeypatch.setattr(bench, "_wait_device_reachable", lambda: None)
    monkeypatch.setattr(bench, "_enable_persistent_cache", lambda: None)
    monkeypatch.setattr(bench, "bench_tpu", lambda f: (2.0, 4, "stub"))
    bench.main()
    bench_keys = set(json.loads(capsys.readouterr().out.strip()))

    monkeypatch.setattr(twin, "ITERS", 1)
    monkeypatch.setattr(twin, "WARMUP", 1)
    monkeypatch.setattr(twin, "CPU_REF_RUNS", 2)
    twin.main(device="cpu")
    captured = capsys.readouterr()
    lines = captured.out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == bench_keys | NEW_KEYS
    assert line["metric"] == "fps_per_gpu_1280x800_batch4_detect_pose"
    assert line["unit"] == "frames/sec" and line["value"] > 0
    assert line["cpu_ref"].startswith("chalkydri_tpu_torch step, device=cpu, "
                                      f"torch {torch.__version__}, ")
    assert line["step_ms_median"] == line["step_ms_max"] > 0
    assert line["card"] == "cpu"
    assert captured.err.startswith("# device=cpu cpu_ref=")


def test_main_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(twin, "bench_cpu_reference", lambda *a: pytest.fail(
        "the denominator ran without a card"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        twin.main()
