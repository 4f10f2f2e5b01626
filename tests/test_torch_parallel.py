"""The row-banded (``parallel/``) detect -> pose path of the port against
the JAX package's, on the same numpy inputs, with JAX on the suite's eight
virtual CPU devices and the port on CPU "bands".

- Kernel B6's plain twins against ``label_components_blocked_pallas`` and
  ``propagate_components_blocked`` in interpret mode, bit for bit, wherever
  the JAX side returns its convergence certificate (B6 computes the fixed
  point that certificate stands for).
- Kernel B7's plain twin against ``extract_candidates_blocked_pallas`` in
  interpret mode and against JAX's ``extract_boundary_points`` with halos,
  bit for bit.
- The banded threshold and CCL stages and the kernel-path band CCL against
  JAX's over a mesh, bit for bit.
- The spatial step against JAX's spatial step with the same ``ccl_impl``:
  integer outputs equal; corners and margins within 1e-3 (float32
  reductions run in another order in XLA-CPU and in torch; the tolerance of
  ``tests/test_sharding.py``); poses within the tolerances of
  ``tests/test_torch_pipeline.py``.

The CUDA kernels are compared with the same twins on the GPU by
``chip_smoke.py``."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import __graft_entry__ as ge
from chalkydri_tpu.detector import load_family as jax_load_family
from chalkydri_tpu.detector.cluster import (
    extract_boundary_points as jax_extract,
)
from chalkydri_tpu.detector.threshold import adaptive_threshold as jax_threshold
from chalkydri_tpu.ops.pallas.ccl_kernel import (
    extract_candidates_blocked_pallas,
    label_components_blocked_pallas,
    propagate_components_blocked as jax_propagate,
)
from chalkydri_tpu.parallel.mesh import frame_sharding
from chalkydri_tpu.parallel.mesh import make_mesh as jax_make_mesh
from chalkydri_tpu.parallel.pipeline import (
    make_sharded_vision_pipeline as jax_sharded_pipeline,
)
from chalkydri_tpu.parallel.sharded_stages import (
    label_components_block_pallas,
    sharded_adaptive_threshold as jax_sharded_threshold,
    sharded_label_components as jax_sharded_ccl,
)
from chalkydri_tpu.pipeline import build_rig_from_config as jax_build_rig
from chalkydri_tpu_torch.detector import cluster as tcluster
from chalkydri_tpu_torch.detector.segment import INVALID, padded_width
from chalkydri_tpu_torch.detector.threshold import adaptive_threshold
from chalkydri_tpu_torch.ops.extract_blocked import (
    extract_candidates_band,
    extract_candidates_blocked,
)
from chalkydri_tpu_torch.ops.propagate import (
    label_components_blocked,
    propagate_components_blocked,
)
from chalkydri_tpu_torch.parallel import collectives
from chalkydri_tpu_torch.parallel.mesh import (
    gather_frames,
    make_mesh,
    place_batch,
    place_frames,
)
from chalkydri_tpu_torch.parallel.pipeline import (
    _compact_over_bands,
    make_sharded_vision_pipeline,
)
from chalkydri_tpu_torch.parallel.sharded_stages import (
    label_components_block_kernel,
    sharded_adaptive_threshold,
    sharded_label_components,
)
from chalkydri_tpu_torch.pipeline import make_vision_pipeline, rig_from_numpy
from chalkydri_tpu_torch.tools.dryrun import dryrun_multichip
from tests.reference_impl.render import axis_aligned_corners, simple_scene

torch.set_num_threads(1)

FAM = jax_load_family("tag36h11")
CORNER_TOL = 1e-3  # px, and decision margins (tests/test_sharding.py)
POSE_TOL = 1e-3  # m (tests/test_torch_pipeline.py)
YAW_TOL = 1e-3  # rad


@pytest.fixture(scope="module")
def devices8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


def _serpentine_tern(h, w, stripes):
    """A white snake on black that zig-zags between the top and bottom row:
    its minimum label crosses every row seam once per stripe."""
    t = np.zeros((h, w), np.uint8)
    cols = np.linspace(2, w - 3, stripes).astype(int)
    t[:, cols] = 255
    for i in range(len(cols) - 1):
        t[0 if i % 2 == 0 else h - 1, cols[i]:cols[i + 1] + 1] = 255
    return t[None]


def _blob_tern(seed, shape):
    """Random ternary blobs: smoothed noise cut into black, skip, white."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape)
    for axis in (1, 2):
        x = sum(np.roll(x, s, axis) for s in range(-2, 3))
    t = np.full(shape, 127, np.uint8)
    t[x > 2.0] = 255
    t[x < -2.0] = 0
    return t


def _seam_tag_tern():
    """A tag across the middle of a 48x128 frame (rows cross every seam of
    8-row blocks), thresholded."""
    canvas, _ = simple_scene(FAM, [(2, axis_aligned_corners(64, 24, 40))],
                             size=(48, 128), noise=4.0)
    return np.array(jax_threshold(jnp.asarray(canvas[None])))


TERNS = {
    "blobs": lambda: _blob_tern(3, (2, 48, 200)),
    "seam_tag": _seam_tag_tern,
    "serpentine": lambda: _serpentine_tern(48, 128, 16),
}


@pytest.mark.parametrize("kind", sorted(TERNS))
def test_b6_twins_equal_blocked_pallas_where_certified(kind):
    """``label_components_blocked`` against the blocked Pallas labeling, and
    ``propagate_components_blocked`` from labels offset as the band CCL
    offsets them (``+ idx * hl * wp``), with some rows lowered as a seam
    exchange lowers them."""
    tern = TERNS[kind]()
    b, h, w = tern.shape
    want, conv = label_components_blocked_pallas(
        jnp.asarray(tern), iters=16, block_rows=8, interpret=True,
        want_converged=True)
    assert bool(conv)
    got, cert = label_components_blocked(torch.from_numpy(tern),
                                         want_converged=True)
    assert got.dtype == torch.int32 and bool(cert)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    offset = 3 * h * padded_width(w)
    labels0 = np.where(tern != 127, np.asarray(want).astype(np.int64) + offset,
                       INVALID)
    rng = np.random.default_rng(5)
    lowered = rng.integers(0, offset, size=labels0[:, :1].shape)
    labels0[:, :1] = np.where(tern[:, :1] != 127, lowered, INVALID)
    labels0 = labels0.astype(np.int32)
    want_p, conv_p = jax_propagate(
        jnp.asarray(tern), jnp.asarray(labels0), iters=16, block_rows=8,
        merge_rounds=64, interpret=True, want_converged=True)
    assert bool(conv_p)
    got_p, cert_p = propagate_components_blocked(
        torch.from_numpy(tern), torch.from_numpy(labels0), want_converged=True)
    assert got_p.dtype == torch.int32 and bool(cert_p)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    assert not np.array_equal(np.asarray(want_p), labels0)


@pytest.mark.parametrize("kind", ["blobs", "seam_tag"])
def test_b7_twin_equals_blocked_pallas_and_halo_extraction(kind):
    tern = TERNS[kind]()
    b, h, w = tern.shape
    labels = label_components_blocked(torch.from_numpy(tern))
    want = extract_candidates_blocked_pallas(
        jnp.asarray(tern), jnp.asarray(labels.numpy()), block_rows=8,
        interpret=True)
    got = extract_candidates_blocked(torch.from_numpy(tern), labels)
    for g, wnt in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))

    # A band of the frame: rows 16..32 with one halo row above, two below.
    top, hc = 16, 16
    t_ext = tern[:, top - 1:top + hc + 2]
    l_ext = labels.numpy()[:, top - 1:top + hc + 2]
    want_band = jax.vmap(lambda t, lab: jax_extract(
        t, lab, halo_top=1, halo_bottom=2, y_offset=top))(
            jnp.asarray(t_ext), jnp.asarray(l_ext))
    got_band = extract_candidates_band(
        torch.from_numpy(t_ext.copy()), torch.from_numpy(l_ext.copy()),
        halo_top=1, halo_bottom=2, y_offset=top)
    for g, wnt, whole in zip(got_band, want_band, got):
        core = np.asarray(wnt).reshape(b, 2, hc + 3, w)[:, :, 1:1 + hc]
        np.testing.assert_array_equal(g.numpy().reshape(b, 2, hc, w), core)
        # ... which are the whole-frame run's slots of those rows
        np.testing.assert_array_equal(
            g.numpy().reshape(b, 2, hc, w),
            whole.numpy().reshape(b, 2, h, w)[:, :, top:top + hc])


def test_port_extraction_with_halos_equals_jax():
    """The plain ``extract_boundary_points`` with JAX's halo signature,
    every slot (halo rows' included)."""
    tern = TERNS["blobs"]()
    labels = label_components_blocked(torch.from_numpy(tern)).numpy()
    want = jax.vmap(lambda t, lab: jax_extract(
        t, lab, halo_top=2, halo_bottom=3, y_offset=40))(
            jnp.asarray(tern), jnp.asarray(labels))
    got = tcluster.extract_boundary_points(
        torch.from_numpy(tern), torch.from_numpy(labels), halo_top=2,
        halo_bottom=3, y_offset=40)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


@pytest.fixture(scope="module")
def seam_scene(devices8):
    """The 480x640 scene of the JAX package's sharded-CCL tests: tag 3
    straddles the seam at row 240 of two bands. Two frames over a
    (data = 2, space = 2) mesh on either side."""
    canvas, _ = simple_scene(
        FAM, [(3, axis_aligned_corners(320, 240, 100)),
              (9, axis_aligned_corners(520, 120, 60))])
    return np.stack([canvas, np.roll(canvas, (8, -24), axis=(0, 1))])


def _meshes(n_devices, space=2):
    """The same (data, space) grid on either side."""
    return (jax_make_mesh(n_devices, space=space),
            make_mesh(["cpu"] * n_devices, space=space))


def test_sharded_threshold_and_ccl_equal_jax(seam_scene):
    batch = seam_scene
    jmesh, tmesh = _meshes(4)  # data = 2, space = 2
    fs = frame_sharding(jmesh, spatial=True)
    want_tern = np.asarray(jax_sharded_threshold(jax.device_put(batch, fs),
                                                 jmesh))
    tern_bands = sharded_adaptive_threshold(
        place_frames(tmesh, batch, spatial=True))
    got_tern = gather_frames(tern_bands)
    np.testing.assert_array_equal(got_tern.numpy(), want_tern)
    assert torch.equal(got_tern, adaptive_threshold(torch.from_numpy(batch)))

    want_lab = np.asarray(jax_sharded_ccl(jax.device_put(want_tern, fs),
                                          jmesh, iters=24))
    got_lab = gather_frames(sharded_label_components(tern_bands, iters=24))
    assert got_lab.dtype == torch.int32
    np.testing.assert_array_equal(got_lab.numpy(), want_lab)


def test_band_kernel_ccl_equals_jax_block_pallas(seam_scene):
    """Both frames in ONE data group: the JAX loop's trip count depends on
    the data, and XLA's CPU collectives stall when two data groups of one
    program leave it after different rounds."""
    batch = seam_scene
    jmesh, tmesh = _meshes(2)  # data = 1, space = 2
    tern = np.asarray(jax_threshold(jnp.asarray(batch)))
    _, h, w = tern.shape
    spec = P("data", "space", None)

    @partial(jax.shard_map, mesh=jmesh, in_specs=spec, out_specs=spec,
             check_vma=False)
    def run(block):
        return label_components_block_pallas(block, h // 2, w, "space",
                                             iters=12, interpret=True)

    want = np.asarray(run(jax.device_put(
        tern, frame_sharding(jmesh, spatial=True))))
    reads = label_components_block_kernel.host_reads
    bands = place_frames(tmesh, tern, spatial=True)
    got = gather_frames([label_components_block_kernel(g) for g in bands])
    np.testing.assert_array_equal(got.numpy(), want)
    # the tag crosses the seam, so the second band's labels were lowered
    assert label_components_block_kernel.host_reads - reads >= 2


def test_band_kernel_ccl_follows_a_snake_across_every_seam():
    """A snake that crosses all three seams of four 16-row bands once per
    stripe: band labels offset by ``j * hl * wp`` are the whole frame's
    padded-flat indices, so the band loop must end on the whole-frame
    labeling, which JAX's blocked labeling certifies."""
    tern = _serpentine_tern(64, 128, 6)
    bands = place_frames(make_mesh(["cpu"] * 4, space=4), tern,
                         spatial=True)[0]
    reads = label_components_block_kernel.host_reads
    got = gather_frames([label_components_block_kernel(bands,
                                                       outer_rounds=100)])
    # one seam per round: far more rounds than a tag across a seam needs
    assert label_components_block_kernel.host_reads - reads > 2 * 4 + 2
    assert len(torch.unique(got[torch.from_numpy(tern) == 255])) == 1
    assert torch.equal(got, label_components_blocked(torch.from_numpy(tern)))
    want, conv = label_components_blocked_pallas(
        jnp.asarray(tern), iters=16, block_rows=16, interpret=True,
        want_converged=True)
    assert bool(conv)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the default round budget (2 * bands + 2) stops short of it
    capped = gather_frames([label_components_block_kernel(bands)])
    assert not torch.equal(capped, got)


# -- the spatial step against JAX's ------------------------------------------

SMALL_DK = dict(max_edge_points=4096, max_clusters=16, cluster_points=128)
# 2 * max_edge_points / 128 / 2 = 8 blocks a direction: the cap drops blocks
CAPPED_DK = dict(max_edge_points=1024, max_clusters=16, cluster_points=128)
# case -> (devices of the (data, space = 2) grid, detector_kwargs). The
# kernel-path cases keep both frames in one data group (see
# test_band_kernel_ccl_equals_jax_block_pallas).
SPATIAL_CASES = {
    "jnp-qd2": (4, dict(SMALL_DK, ccl_impl="jnp", quad_decimate=2)),
    "jnp-qd1": (4, dict(SMALL_DK, ccl_impl="jnp", quad_decimate=1)),
    "pallas_interpret-qd2": (2, dict(SMALL_DK, ccl_impl="pallas_interpret",
                                     quad_decimate=2)),
    "pallas_interpret-qd1": (2, dict(SMALL_DK, ccl_impl="pallas_interpret",
                                     quad_decimate=1)),
    "jnp-qd2-capped": (4, dict(CAPPED_DK, ccl_impl="jnp", quad_decimate=2)),
}


@pytest.fixture(scope="module")
def rig(devices8):
    """The 128x256 rig scene of the JAX package's dry run, two cameras, the
    rig built in JAX and carried across to the port."""
    layout_j, cams = ge._tiny_rig(jnp.float32)
    params_j, rc_j = jax_build_rig(cams * 2, layout_j)
    frames = ge._render_scene(layout_j, 2)
    frames[1] = np.roll(frames[1], (2, -6), axis=(0, 1))
    gyro = np.zeros(2, np.float32)
    rig_t = rig_from_numpy(
        np.asarray(layout_j.rotations), np.asarray(layout_j.translations),
        np.asarray(layout_j.present), np.asarray(params_j),
        np.asarray(rc_j.rotation), np.asarray(rc_j.translation), device="cpu")
    return (layout_j, params_j, rc_j), rig_t, frames, gyro


@pytest.fixture(scope="module")
def spatial_outputs(rig):
    return {}


def _spatial_pair(rig, cache, case):
    if case not in cache:
        rig_j, rig_t, frames, gyro = rig
        n_devices, dk = SPATIAL_CASES[case]
        jmesh, tmesh = _meshes(n_devices)
        step_j, place_j = jax_sharded_pipeline(
            *rig_j, jmesh, spatial=True, detector_kwargs=dk)
        want = step_j(*place_j(frames, gyro))
        step_t, place_t = make_sharded_vision_pipeline(
            *rig_t, tmesh, spatial=True, detector_kwargs=dk)
        cache[case] = want, step_t(*place_t(frames, gyro))
    return cache[case]


@pytest.mark.parametrize("case", sorted(SPATIAL_CASES))
def test_spatial_step_integers_equal_jax(rig, spatial_outputs, case):
    want, got = _spatial_pair(rig, spatial_outputs, case)
    for name in ("ids", "hammings", "valid", "dropped_points"):
        np.testing.assert_array_equal(
            getattr(got.detections, name).numpy(),
            np.asarray(getattr(want.detections, name)), err_msg=name)
    for name in ("tag_count", "pose_valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    dropped = got.detections.dropped_points
    if case.endswith("capped"):
        assert (dropped > 0).all()
    else:
        assert (dropped == 0).all()
        assert 1 in got.detections.ids[0].tolist() and got.pose_valid.all()


@pytest.mark.parametrize("case", sorted(SPATIAL_CASES))
def test_spatial_step_floats_close_to_jax(rig, spatial_outputs, case):
    want, got = _spatial_pair(rig, spatial_outputs, case)
    valid = np.asarray(want.detections.valid)
    for name in ("corners", "decision_margins"):
        np.testing.assert_allclose(
            getattr(got.detections, name).numpy()[valid],
            np.asarray(getattr(want.detections, name))[valid],
            atol=CORNER_TOL, rtol=0, err_msg=name)
    ok = np.asarray(want.pose_valid)
    for name, tol in (("pose_x", POSE_TOL), ("pose_y", POSE_TOL),
                      ("pose_yaw", YAW_TOL)):
        np.testing.assert_allclose(getattr(got, name).numpy()[ok],
                                   np.asarray(getattr(want, name))[ok],
                                   atol=tol, rtol=0, err_msg=name)


@pytest.mark.parametrize("impl", ["jnp", "pallas", "pallas_interpret", "auto"])
def test_spatial_step_equals_single_device_step(rig, impl):
    """Every ``ccl_impl`` of the port (on CPU bands "pallas" runs B6's and
    B7's wrappers, which take their twins there) gives the single-device
    step's integers, at four bands of 32 rows."""
    _, rig_t, frames, gyro = rig
    ref = make_vision_pipeline(*rig_t, detector_kwargs=SMALL_DK, device="cpu")(
        torch.from_numpy(frames), torch.from_numpy(gyro))
    step, place = make_sharded_vision_pipeline(
        *rig_t, make_mesh(["cpu"] * 4, space=4), spatial=True,
        detector_kwargs=dict(SMALL_DK, ccl_impl=impl))
    out = step(*place(frames, gyro))
    for name in ("ids", "hammings", "valid", "dropped_points"):
        assert torch.equal(getattr(out.detections, name),
                           getattr(ref.detections, name)), name
    assert torch.equal(out.tag_count, ref.tag_count)
    valid = ref.detections.valid
    assert float((out.detections.corners[valid]
                  - ref.detections.corners[valid]).abs().max()) <= CORNER_TOL
    assert float((out.pose_x - ref.pose_x).abs().max()) <= POSE_TOL


def test_data_parallel_step_equals_single_device_step(rig):
    _, rig_t, frames, gyro = rig
    ref = make_vision_pipeline(*rig_t, detector_kwargs=SMALL_DK, device="cpu")(
        torch.from_numpy(frames), torch.from_numpy(gyro))
    step, place = make_sharded_vision_pipeline(
        *rig_t, make_mesh(["cpu"] * 2, space=1), spatial=False,
        detector_kwargs=SMALL_DK)
    out = step(*place(frames, gyro))
    for name in out._fields:
        if name != "detections":
            assert torch.equal(getattr(out, name), getattr(ref, name)), name
    for name in out.detections._fields:
        assert torch.equal(getattr(out.detections, name),
                           getattr(ref.detections, name)), name


def test_port_dryrun_passes_on_cpu(capsys):
    dryrun_multichip(2, device="cpu", batch=2)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("dryrun OK")]
    assert len(lines) == 2 and "deployed-1280x800-qd2" in lines[1]


# -- the pieces ---------------------------------------------------------------

@pytest.mark.parametrize("n_bands,cap", [(4, 4096), (3, 1024), (2, 1 << 20)])
def test_compaction_over_bands_equals_whole_frame_compaction(n_bands, cap):
    """Random candidates on a 96 x 192 frame (bands of 24, 32 and 48 rows
    cut the 128-row chunks of the column blocks; 192 columns leave a
    ragged last row block), under budgets that drop blocks and one that
    keeps everything."""
    rng = np.random.default_rng(n_bands)
    b, h, w = 2, 96, 192
    is_cand = rng.random((b, 2, h, w)) < 0.05
    is_cand[:, :, 40:44, 30:90] = True  # a dense patch across a seam
    black = np.where(is_cand, rng.integers(0, 1 << 20, is_cand.shape),
                     INVALID).astype(np.int32)
    white = np.where(is_cand, rng.integers(0, 1 << 20, is_cand.shape),
                     INVALID).astype(np.int32)
    payload = rng.integers(0, 1 << 29, is_cand.shape).astype(np.int32)
    whole = [torch.from_numpy(x.reshape(b, -1)) for x in (black, white, payload)]
    want = tcluster.compact_candidates(*whole, width=w, max_points=cap)
    hl = h // n_bands
    pages = [tuple(torch.from_numpy(np.ascontiguousarray(
        x[:, :, j * hl:(j + 1) * hl]).reshape(b, -1))
        for x in (black, white, payload)) for j in range(n_bands)]
    got = _compact_over_bands(pages, hl, w, cap, torch.device("cpu"))
    for g, wnt, name in zip(got, want, ("black", "white", "payload",
                                        "dropped")):
        assert g.dtype == torch.int32
        assert torch.equal(g, wnt), name
    assert bool((got[3] > 0).all()) == (cap < 1 << 20)


def test_mesh_places_frames_and_batches():
    mesh = make_mesh(["cpu"] * 8, space=2)
    assert mesh.shape == {"data": 4, "space": 2}
    frames = torch.arange(4 * 64 * 16, dtype=torch.int32).reshape(4, 64, 16)
    bands = place_frames(mesh, frames, spatial=True)
    assert {tuple(b.shape) for g in bands for b in g} == {(1, 32, 16)}
    assert len(bands) == 4 and len(bands[0]) == 2
    assert torch.equal(gather_frames(bands), frames)
    whole = place_frames(mesh, frames)
    assert [len(g) for g in whole] == [1] * 4 and whole[2][0].shape == (1, 64, 16)
    assert [x.tolist() for x in place_batch(mesh, np.arange(4))] == [
        [0], [1], [2], [3]]
    with pytest.raises(ValueError, match="multiple of the data axis"):
        place_batch(mesh, np.arange(6))
    with pytest.raises(ValueError, match="do not split"):
        make_mesh(["cpu"] * 3, space=2)
    if not torch.cuda.is_available():  # the default grid is the CUDA cards
        with pytest.raises(ValueError, match="no CUDA card"):
            make_mesh()


def test_collectives_shift_gather_and_sum_without_aliasing():
    rows = [torch.full((1, 1, 4), j) for j in range(3)]
    from_above = collectives.fetch_rows(rows, +1)
    from_below = collectives.fetch_rows(rows, -1)
    assert [int(r[0, 0, 0]) for r in from_above] == [2, 0, 1]
    assert [int(r[0, 0, 0]) for r in from_below] == [1, 2, 0]
    rows[0].fill_(9)  # a received row is a copy
    assert int(from_above[1][0, 0, 0]) == 0
    assert collectives.all_gather_rows(rows, 1).shape == (1, 3, 4)
    assert int(collectives.sum_over_bands(rows)[0, 0, 0]) == 9 + 1 + 2


def test_spatial_step_refuses_rows_that_do_not_tile(rig):
    _, rig_t, frames, gyro = rig
    step, place = make_sharded_vision_pipeline(
        *rig_t, make_mesh(["cpu"] * 2, space=2), spatial=True,
        detector_kwargs=SMALL_DK)
    with pytest.raises(ValueError, match="pad frame rows to a multiple of "
                                         "space\\*8"):
        step(*place(frames[:, :120], gyro))  # bands of 60 rows
    with pytest.raises(ValueError, match="ccl_impl must be"):
        make_sharded_vision_pipeline(
            *rig_t, make_mesh(["cpu"] * 2, space=2), spatial=True,
            detector_kwargs=dict(ccl_impl="union_find"))


def test_wrappers_count_only_kernel_launches():
    tern = torch.from_numpy(_serpentine_tern(16, 128, 8))
    fns = (label_components_blocked, propagate_components_blocked,
           extract_candidates_band)
    before = [fn.launches for fn in fns]
    labels = label_components_blocked(tern)
    propagate_components_blocked(tern, labels)
    extract_candidates_blocked(tern, labels)
    assert [fn.launches for fn in fns] == before  # CPU: plain twins


@pytest.mark.parametrize("fn", [
    label_components_blocked,
    lambda t: propagate_components_blocked(t, t.to(torch.int32)),
    lambda t: extract_candidates_band(t, t.to(torch.int32)),
])
def test_wrappers_reject_other_devices(fn):
    with pytest.raises(ValueError, match="unsupported device"):
        fn(torch.zeros((1, 8, 8), dtype=torch.uint8, device="meta"))
