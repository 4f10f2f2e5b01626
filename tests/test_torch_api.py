"""The port's public surface against the JAX package's:

- every name each JAX package ``__init__`` re-exports (and its
  ``__all__``) exists in the port's counterpart, with one documented
  substitute (``utils.highest_precision``, a JAX matmul-precision
  decorator, is the port's ``utils.full_fp32`` policy);
- ``SqPnP``, ``solve_robot_pose_batched``, ``stack_models``,
  ``matrix_to_quat`` and ``OpenCVModel5.to_dict``/``to_json`` equal JAX's
  on seeded inputs (float64: the pose within ``POSE_TOL`` m and
  ``ROT_TOL``, the tolerances of ``tests/test_torch_pipeline.py``;
  quaternions within 1e-12; the JSON string equal);
- the per-frame ``cluster_candidates``, ``gradient_clusters`` and
  ``fit_quad`` equal the batched functions' [0];
- import hygiene: the new modules import neither JAX, nor the JAX
  package, nor cv2, and no file of the port imports the JAX package."""

import ast
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chalkydri_tpu_torch
from tests.test_solver import make_scene
from tests.test_torch_pipeline import POSE_TOL

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROT_TOL = 1e-3
PACKAGES = ("", "clients", "detector", "geometry", "io", "parallel",
            "runtime", "solver", "subsystems", "utils")
SUBSTITUTES = {("utils", "highest_precision"): "full_fp32"}


def _jax_exports(sub: str) -> set:
    """The names the JAX package's ``__init__`` of ``sub`` imports from its
    submodules, plus its ``__all__``."""
    path = os.path.join(ROOT, "chalkydri_tpu", sub, "__init__.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            names |= {e.value for e in node.value.elts}
    return names


@pytest.mark.parametrize("sub", PACKAGES)
def test_reexports_exist_in_the_port(sub):
    import importlib

    mod = importlib.import_module(
        "chalkydri_tpu_torch" + (f".{sub}" if sub else ""))
    names = _jax_exports(sub)
    assert names
    missing = [n for n in sorted(names)
               if not hasattr(mod, SUBSTITUTES.get((sub, n), n))]
    assert not missing, f"chalkydri_tpu_torch.{sub} lacks {missing}"
    if sub == "":
        assert chalkydri_tpu_torch.__all__ == __import__("chalkydri_tpu").__all__


def test_named_functions_exist():
    from chalkydri_tpu_torch.detector import cluster, quad
    from chalkydri_tpu_torch.geometry.camera import OpenCVModel5
    from chalkydri_tpu_torch.solver import sqpnp

    assert sqpnp.NUM_CANDIDATES == 6
    for name in ("cluster_candidates", "gradient_clusters"):
        assert callable(getattr(cluster, name))
    assert callable(quad.fit_quad)
    for name in ("to_dict", "to_json", "fx", "fy", "cx", "cy", "dist"):
        assert hasattr(OpenCVModel5, name)


def _rotations(rng, n):
    """Rotation matrices from random unit quaternions, with rotations of
    about a half turn so every branch of Shepperd's method is taken."""
    q = rng.normal(size=(n, 4))
    q[: n // 4, 0] = 1e-4  # half turns about random axes
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    r = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                  2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                  2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                 axis=-1)
    return r.reshape(n, 3, 3)


def test_matrix_to_quat_matches_jax():
    from chalkydri_tpu.geometry import matrix_to_quat as jax_m2q
    from chalkydri_tpu_torch.geometry import matrix_to_quat, quat_to_matrix

    rots = _rotations(np.random.default_rng(0), 64)
    got = matrix_to_quat(torch.from_numpy(rots)).numpy()
    want = np.asarray(jax_m2q(jnp.asarray(rots)))
    tr = np.trace(rots, axis1=1, axis2=2)
    diag = np.stack([tr, rots[:, 0, 0], rots[:, 1, 1], rots[:, 2, 2]], 1)
    assert set(np.argmax(diag, 1)) == {0, 1, 2, 3}
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    assert (got[:, 0] >= 0).all()
    np.testing.assert_allclose(quat_to_matrix(torch.from_numpy(got)).numpy(),
                               rots, atol=1e-12, rtol=0)


def test_camera_model_surface_matches_jax():
    from chalkydri_tpu.geometry import stack_models as jax_stack
    from chalkydri_tpu.geometry.camera import OpenCVModel5 as JCam
    from chalkydri_tpu_torch.geometry import OpenCVModel5, stack_models

    rng = np.random.default_rng(1)
    params = [rng.normal(size=9) * [500, 500, 300, 200, .1, .1, .01, .01, .01]
              for _ in range(3)]
    dims = ((640, 480), (1280, 800), (320, 240))
    ports = [OpenCVModel5(torch.from_numpy(p), *d) for p, d in zip(params, dims)]
    jaxes = [JCam(jnp.asarray(p), *d) for p, d in zip(params, dims)]
    for m, j in zip(ports, jaxes):
        assert m.to_dict() == j.to_dict()
        assert m.to_json() == j.to_json()
        f32 = OpenCVModel5(m.params.float(), m.width, m.height)
        assert f32.to_json() == JCam(j.params.astype(jnp.float32), j.width,
                                     j.height).to_json()
        for k in ("fx", "fy", "cx", "cy", "dist"):
            np.testing.assert_array_equal(getattr(m, k).numpy(),
                                          np.asarray(getattr(j, k)))
    s, js = stack_models(ports), jax_stack(jaxes)
    assert (s.width, s.height) == (js.width, js.height) == (1280, 800)
    np.testing.assert_array_equal(s.params.numpy(), np.asarray(js.params))


def _scenes(n):
    """n frames of 2 tags each (``tests/test_solver.py::make_scene``),
    padded to 8 tags, float64."""
    rng = np.random.default_rng(14)
    rots, ts, mask, cam, rcr, rct, gyro = [], [], [], [], [], [], []
    for _ in range(n):
        isos, rays, rc = make_scene(rng, n_tags=2)
        r = np.stack([np.eye(3)] * 8)
        t = np.zeros((8, 3))
        m = np.zeros(8, bool)
        c = np.zeros((8, 4, 3))
        for i, (ri, ti) in enumerate(isos):
            r[i], t[i], m[i] = ri, ti, True
            c[i] = rays[4 * i:4 * i + 4]
        for lst, v in zip((rots, ts, mask, cam, rcr, rct),
                          (r, t, m, c, rc[0], rc[1])):
            lst.append(v)
        gyro.append(rng.uniform(-1, 1))
    return [np.stack(x) for x in (rots, ts, mask, cam, rcr, rct)] + [np.array(gyro)]


def test_solve_robot_pose_batched_and_sqpnp_match_jax():
    from chalkydri_tpu.geometry import SE3 as JSE3
    from chalkydri_tpu.solver import SqPnP as JSqPnP
    from chalkydri_tpu.solver import solve_robot_pose_batched as jax_batched
    from chalkydri_tpu_torch import SqPnP
    from chalkydri_tpu_torch.geometry import SE3
    from chalkydri_tpu_torch.solver import solve_robot_pose_batched

    args = _scenes(4)
    got = solve_robot_pose_batched(*(torch.from_numpy(a) for a in args))
    want = jax_batched(*(jnp.asarray(a) for a in args))
    for g, w in ((got.position, want.position), (got.rotation, want.rotation)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=POSE_TOL, rtol=0)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid.all()

    solver, jsolver = SqPnP().max_iter(10).tolerance(1e-9), JSqPnP().max_iter(10)
    assert (solver._max_iter, solver._tol) == (10, 1e-9)
    t = [torch.from_numpy(a) for a in args]
    one = solver.solve_robot_pose(t[0], t[1], t[2], t[3], SE3(t[4], t[5]), t[6])
    for b in range(2):
        j = jsolver.solve_robot_pose(*(jnp.asarray(a[b]) for a in args[:4]),
                                     JSE3(jnp.asarray(args[4][b]),
                                          jnp.asarray(args[5][b])),
                                     jnp.asarray(args[6][b]))
        np.testing.assert_allclose(one.position[b].numpy(), np.asarray(j.position),
                                   atol=POSE_TOL, rtol=0)
        np.testing.assert_allclose(one.rotation[b].numpy(), np.asarray(j.rotation),
                                   atol=ROT_TOL, rtol=0)


def test_sharded_adaptive_threshold_and_placements():
    """``sharded_adaptive_threshold`` over 2 data groups x 4 row bands
    equals the whole-frame threshold and JAX's sharded threshold; the
    placement helpers equal ``place_frames`` / ``place_batch``."""
    from chalkydri_tpu.parallel import make_mesh as jax_make_mesh
    from chalkydri_tpu.parallel import sharded_adaptive_threshold as jax_sat
    from chalkydri_tpu_torch.detector.threshold import adaptive_threshold
    from chalkydri_tpu_torch.parallel import (
        batch_sharding,
        frame_sharding,
        make_mesh,
        replicated,
        sharded_adaptive_threshold,
    )
    from chalkydri_tpu_torch.parallel.mesh import (
        gather_frames,
        place_batch,
        place_frames,
    )
    from tests.reference_impl.corpus import build_parity_corpus

    gray = torch.from_numpy(np.stack([c[:96, :160] for c, _ in
                                      build_parity_corpus(2)]))
    mesh = make_mesh(["cpu"] * 8, space=4)
    bands = frame_sharding(mesh, spatial=True)(gray)
    for a, b in zip(bands, place_frames(mesh, gray, spatial=True)):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    got = gather_frames(sharded_adaptive_threshold(bands))
    assert torch.equal(got, adaptive_threshold(gray))
    want = jax_sat(jnp.asarray(gray.numpy()), jax_make_mesh(8, space=4))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    gyro = torch.arange(2.0)
    assert all(torch.equal(x, y) for x, y in zip(batch_sharding(mesh)(gyro),
                                                 place_batch(mesh, gyro)))
    assert [x.tolist() for x in replicated(mesh)(gyro)] == [[0.0, 1.0]] * 2


@pytest.fixture(scope="module")
def tern_labels():
    """Ternary and label images [1, H, W] of a corpus scene at half
    resolution."""
    from chalkydri_tpu_torch.detector.pipeline import decimate2
    from chalkydri_tpu_torch.detector.segment import label_components
    from chalkydri_tpu_torch.detector.threshold import adaptive_threshold
    from tests.reference_impl.corpus import build_parity_corpus

    canvas, _ = build_parity_corpus(1)[0]
    tern = adaptive_threshold(decimate2(torch.from_numpy(canvas)[None]))
    return tern, label_components(tern, iters=12)


def _assert_same(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_per_frame_clusters_equal_batched(tern_labels):
    from chalkydri_tpu_torch.detector import cluster

    tern, labels = tern_labels
    got = cluster.gradient_clusters(tern[0], labels[0])
    want = cluster.gradient_clusters_batched(tern, labels)
    assert got.points.dim() == 3 and int(got.valid.sum()) >= 1
    _assert_same(got, [x[0] for x in want])
    black, white, payload, dropped = cluster.extract_and_compact(tern, labels)
    got = cluster.cluster_candidates(black[0], white[0], payload[0],
                                     dropped=dropped[0])
    want = cluster.cluster_candidates_batched(black, white, payload,
                                              dropped=dropped)
    _assert_same(got, [x[0] for x in want])


def test_fit_quad_equals_batched(tern_labels):
    from chalkydri_tpu_torch.detector import cluster, quad

    cl = cluster.gradient_clusters(*(x[0] for x in tern_labels))
    want = quad.fit_quads(cl.points, cl.mask, torch.ones_like(cl.valid))
    for k in torch.nonzero(cl.valid)[:, 0].tolist():
        corners, valid = quad.fit_quad(cl.points[:, k], cl.mask[k])
        np.testing.assert_allclose(corners.numpy(), want.corners[k].numpy(),
                                   atol=1e-4, rtol=0)
        assert bool(valid) == bool(want.valid[k])


NEW_MODULES = ("chalkydri_tpu_torch.tools.calibration",
               "chalkydri_tpu_torch.tools.configurator",
               "chalkydri_tpu_torch.tools.logread",
               "chalkydri_tpu_torch.tools.soak",
               "chalkydri_tpu_torch.tools.gen_families",
               "chalkydri_tpu_torch.clients.python_client",
               "chalkydri_tpu_torch.utils.update",
               "chalkydri_tpu_torch.subsystems.calib_viz",
               "chalkydri_tpu_torch.examples.demo",
               "chalkydri_tpu_torch.examples.ml_subsystem")


def test_new_modules_import_no_jax_nor_cv2():
    code = (
        "import sys\n"
        "import chalkydri_tpu_torch, chalkydri_tpu_torch.detector\n"
        "assert 'torch' in sys.modules\n"
        "for n in ('triton', 'jax', 'cv2'):\n"
        "    assert n not in sys.modules, n\n"
        + "".join(f"import {m}\n" for m in NEW_MODULES)
        + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'cv2', 'chalkydri_tpu', 'triton'))\n"
        "assert not bad, bad\n"
        "print('CLEAN')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert "CLEAN" in out.stdout


def test_port_files_import_no_jax_package():
    pattern = re.compile(r"^\s*(from|import)\s+(chalkydri_tpu|jax|jaxlib)(\.|\s|$)",
                         re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, dirs, names in os.walk(os.path.join(ROOT, "chalkydri_tpu_torch")):
        dirs[:] = [x for x in dirs if x != "_build"]  # build outputs, ignored by git
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    offenders = []
    for path in files:
        with open(path) as f:
            offenders += [f"{os.path.relpath(path, ROOT)}: {m.group(0).strip()}"
                          for m in pattern.finditer(f.read())]
    assert len(files) > 60 and not offenders, offenders
