"""The detect -> pose step over a device grid (port of
``chalkydri_tpu/parallel/pipeline.py``).

- cameras/frames ride the ``data`` axis: the batch is split over the data
  groups, each runs the single-device step on its first device with its
  cameras' parameters, and the outputs are concatenated;
- with ``spatial=True`` the ``space`` axis also cuts each frame's ROWS
  into bands that go through the whole front end band by band:
  decimation, adaptive threshold (halo exchange) and CCL (seam exchange,
  ``sharded_stages``) per band, boundary extraction per band through
  kernel B7's band entry (one halo row above, two below), and a
  compaction that reconstructs the single-device block selection exactly:
  per-block candidate counts and the boost vectors are gathered, the
  blocks are ranked once (``cluster.rank_blocks``, tie-breaks included),
  and every band contributes the slice it owns of every selected block.
  The compacted arrays equal the single-device ones bit for bit, so the
  tail (cluster -> quad -> refine -> decode -> solve) runs once per data
  group, on the group's first device and the reassembled frame.

Usage:

    mesh = make_mesh(["cuda:0"] * 4, space=4)
    step, place = make_sharded_vision_pipeline(layout, params, rc, mesh,
                                               spatial=True)
    out = step(*place(frames, gyro))
"""

from __future__ import annotations

from typing import Sequence

import torch

from chalkydri_tpu_torch.detector.cluster import (
    _INT_MAX,
    COMPACT_SLACK,
    MAX_CLUSTER_POINTS,
    MAX_CLUSTERS,
    MAX_EDGE_POINTS,
    MIN_CLUSTER_POINTS,
    _ceil128,
    _dilate_vec,
    cluster_candidates_batched,
    rank_blocks,
)
from chalkydri_tpu_torch.detector.decode import make_decoder
from chalkydri_tpu_torch.detector.families import (
    DEFAULT_BITS_CORRECTED,
    DEFAULT_FAMILY,
    load_family,
)
from chalkydri_tpu_torch.detector.pipeline import decimate2, make_post_cluster
from chalkydri_tpu_torch.detector.segment import INVALID
from chalkydri_tpu_torch.detector.threshold import MIN_WHITE_BLACK_DIFF, TILE
from chalkydri_tpu_torch.geometry.field_layout import FieldLayout
from chalkydri_tpu_torch.geometry.tags import TAG_SIZE
from chalkydri_tpu_torch.geometry.transforms import SE3, matrix_to_yaw
from chalkydri_tpu_torch.ops.extract_blocked import extract_candidates_band
from chalkydri_tpu_torch.parallel.collectives import (
    all_gather_rows,
    fetch_rows,
    sum_over_bands,
)
from chalkydri_tpu_torch.parallel.mesh import Mesh, place_batch, place_frames
from chalkydri_tpu_torch.parallel.sharded_stages import (
    _exchange_halo,
    _fetch_facing,
    _threshold_block,
    label_components_block,
    label_components_block_kernel,
)
from chalkydri_tpu_torch.pipeline import (
    VisionOutput,
    make_frame_solver,
    make_vision_pipeline,
)
from chalkydri_tpu_torch.solver.robot_pose import SIGN_FLIP_CONST

CCL_IMPLS = ("auto", "jnp", "pallas", "pallas_interpret")


def _concat(outs: Sequence, device):
    """Concatenate per-group outputs (nested NamedTuples of [B/data, ...]
    tensors) along the batch on ``device``."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([o.to(device) for o in outs], dim=0)
    return type(first)(*(_concat(field, device) for field in zip(*outs)))


def make_sharded_vision_pipeline(
    layout: FieldLayout,
    camera_params: torch.Tensor,  # [B, 9]
    robot_to_cam: SE3,  # batched [B, 3, 3] / [B, 3]
    mesh: Mesh,
    spatial: bool = False,
    **pipeline_kwargs,
):
    """Build ``(step, place)`` for a camera rig over ``mesh``.

    ``place(frames, gyro)`` puts one iteration's frames [B, H, W] uint8 and
    gyro [B] on the grid (``mesh.place_frames`` / ``place_batch``);
    ``step(*place(...))`` returns the ``VisionOutput`` of the whole batch
    on the grid's first device. B must be a multiple of the 'data' axis.
    The rig lives on the grid's devices: CUDA cards unless the caller built
    the mesh from CPU devices.

    ``spatial=False``: every data group runs ``make_vision_pipeline``'s
    step on its frames. ``spatial=True``: frame rows are banded over
    'space' through the front end (module docstring); frame height must
    divide into ``space * 8`` (``space * 4`` at ``quad_decimate=1``).
    ``pipeline_kwargs`` are ``make_vision_pipeline``'s (GREY frames only
    with ``spatial``); ``detector_kwargs["ccl_impl"]`` picks the band CCL:
    ``"jnp"`` the per-round plain path, ``"pallas"`` the kernel path
    (kernel B6 on CUDA bands, its plain twin on CPU bands, as the wrappers
    route by device), ``"pallas_interpret"`` a second name of the kernel
    path so that a JAX config carries over, ``"auto"`` the kernel path on
    CUDA devices and the per-round path on the CPU.
    """
    n_data = mesh.shape["data"]
    b = camera_params.shape[0]
    if b % n_data:
        raise ValueError(f"camera batch {b} must be a multiple of the data "
                         f"axis {n_data}")
    leads = [row[0] for row in mesh.grid]
    params = place_batch(mesh, camera_params)
    rc_rot = place_batch(mesh, robot_to_cam.rotation)
    rc_t = place_batch(mesh, robot_to_cam.translation)

    if spatial:
        groups = [_make_spatial_step(layout.to(dev), p, SE3(r, t),
                                     **pipeline_kwargs)
                  for dev, p, r, t in zip(leads, params, rc_rot, rc_t)]
    else:
        pipes = [make_vision_pipeline(layout.to(dev), p, SE3(r, t), device=dev,
                                      **pipeline_kwargs)
                 for dev, p, r, t in zip(leads, params, rc_rot, rc_t)]
        groups = [lambda bands, gyro, pipe=pipe: pipe(bands[0], gyro)
                  for pipe in pipes]

    def step(frames, gyro) -> VisionOutput:
        outs = [run(bands, g) for run, bands, g in zip(groups, frames, gyro)]
        return outs[0] if len(outs) == 1 else _concat(outs, leads[0])

    def place(frames, gyro):
        return (place_frames(mesh, frames, spatial=spatial),
                place_batch(mesh, gyro))

    return step, place


def _band_candidates(terns, labels):
    """Per band, the dense candidates of its core rows through kernel B7's
    band entry: the tern band extended by the last row of the band above
    and the first two of the band below (skip where the frame ends), the
    label band by the first row of the band below."""
    hl = terns[0].shape[1]
    t_above, t_below = _fetch_facing(
        [t[:, :2] for t in terns], [t[:, -1:] for t in terns],
        lambda rows: torch.full_like(rows, 127))
    l_below = fetch_rows([lab[:, :1] for lab in labels], -1)
    l_below[-1] = torch.full_like(l_below[-1], INVALID)
    pages = []
    for j, (t, lab) in enumerate(zip(terns, labels)):
        l_pad = torch.full_like(lab[:, :1], INVALID)
        pages.append(extract_candidates_band(
            torch.cat([t_above[j], t, t_below[j]], dim=1),
            torch.cat([l_pad, lab, l_below[j], l_pad], dim=1),
            halo_top=1, halo_bottom=2, y_offset=j * hl))
    return pages


def _compact_over_bands(pages, hl: int, w: int, edge_cap: int, lead):
    """The single-device compaction (``cluster._compact_blocks``)
    reconstructed from per-band candidate pages ``pages[j] = (black, white,
    payload)``, each [B, 2 * hl * w] on band ``j``'s device. Returns
    (black, white, payload, dropped [B]) on ``lead``, bit-identical to
    ``cluster.compact_candidates`` of the whole frame's candidates.

    Within the budget the pages are gathered into the whole frame's
    direction-major order. Beyond it, per-block candidate counts and the
    per-axis both-direction boost vectors are gathered, the blocks are
    ranked once, and each band contributes its owned slice of every
    selected block: dir-1 blocks are row-aligned and wholly owned by one
    band, dir-0 column blocks span bands, so their contribution is taken
    element by element. Only counts, boosts, ranks and 3 x 2 * max_points
    int32 cross between devices."""
    n_space = len(pages)
    bl = pages[0][0].shape[0]
    n_seg = hl * w
    if n_seg % 128:
        raise ValueError("per-shard candidate segment must block-align")
    if 2 * n_space * n_seg <= edge_cap:
        def whole(k):
            return all_gather_rows(
                [p[k].reshape(bl, 2, 1, n_seg) for p in pages], dim=2,
                device=lead).reshape(bl, -1)

        return (whole(0), whole(1), whole(2),
                torch.zeros(bl, dtype=torch.int32, device=lead))

    h2 = n_space * hl
    hp, wp = _ceil128(h2), _ceil128(w)
    n_rb, nbw = hp // 128, wp // 128
    cap = int(COMPACT_SLACK * edge_cap)

    rows0, rows1, cols0, cols1, counts0, counts1 = [], [], [], [], [], []
    for j, (black, _, _) in enumerate(pages):
        dev = black.device
        has0 = (black[:, :n_seg] != _INT_MAX).reshape(bl, hl, w)
        has1 = (black[:, n_seg:] != _INT_MAX).reshape(bl, hl, w)
        rows0.append(has0.any(dim=2))
        rows1.append(has1.any(dim=2))
        cols0.append(has0.any(dim=1).to(torch.int32))
        cols1.append(has1.any(dim=1).to(torch.int32))
        # dir 1: row-aligned blocks, in the band's own row-major order
        counts1.append(torch.nn.functional.pad(has1, (0, wp - w))
                       .reshape(bl, hl * nbw, 128).sum(dim=2))
        # dir 0: column blocks (x, 128-row chunk of the frame) span bands;
        # the band bins its rows into the frame's chunks
        chunk = (j * hl + torch.arange(hl, device=dev)) // 128
        counts0.append(torch.zeros((bl, w, n_rb), dtype=torch.int64, device=dev)
                       .index_add_(2, chunk, has0.transpose(1, 2).to(torch.int64)))

    both_row = (_dilate_vec(all_gather_rows(rows0, 1, lead))
                & _dilate_vec(all_gather_rows(rows1, 1, lead)))  # [bl, h2]
    both_col = (_dilate_vec(sum_over_bands(cols0, lead) > 0)
                & _dilate_vec(sum_over_bands(cols1, lead) > 0))  # [bl, w]
    boost0 = both_col[:, :, None].expand(bl, w, n_rb).reshape(bl, -1)
    boost1 = both_row[:, :, None].expand(bl, h2, nbw).reshape(bl, -1)
    counts0 = sum_over_bands(counts0, lead).reshape(bl, w * n_rb)
    counts1 = all_gather_rows(counts1, 1, lead)  # [bl, h2 * nbw]
    idx0 = rank_blocks(counts0, boost0, cap)  # [bl, k0]
    idx1 = rank_blocks(counts1, boost1, cap)  # [bl, k1]
    dropped = (counts0.sum(1) + counts1.sum(1) - counts0.gather(1, idx0).sum(1)
               - counts1.gather(1, idx1).sum(1)).to(torch.int32)

    def owned(j, dev):
        """Band j's (mask, local index) of the selected blocks' elements,
        per direction, and the elements that exist at all."""
        lanes = torch.arange(128, device=dev)
        i0, i1 = idx0.to(dev), idx1.to(dev)
        r0 = (i0 % n_rb)[..., None] * 128 + lanes  # frame row [bl, k0, 128]
        real0 = r0 < h2
        mine0 = (r0 // hl == j) & real0
        loc0 = ((r0 - j * hl) * w + (i0 // n_rb)[..., None]).clamp(0, n_seg - 1)
        r1 = (i1 // nbw)[..., None]  # frame row [bl, k1, 1]
        c1 = (i1 % nbw)[..., None] * 128 + lanes  # column [bl, k1, 128]
        real1 = c1 < w
        mine1 = (r1 // hl == j) & real1
        loc1 = ((r1 % hl) * w + c1).clamp(0, n_seg - 1)
        return (mine0, loc0.reshape(bl, -1), real0,
                mine1, loc1.reshape(bl, -1), real1)

    own = [owned(j, p[0].device) for j, p in enumerate(pages)]

    def compacted(k, fill):
        part0, part1 = [], []
        for (mine0, loc0, _, mine1, loc1, _), p in zip(own, pages):
            x = p[k]
            part0.append(torch.where(
                mine0, x[:, :n_seg].gather(1, loc0).reshape(mine0.shape), 0))
            part1.append(torch.where(
                mine1, x[:, n_seg:].gather(1, loc1).reshape(mine1.shape), 0))
        real0, real1 = own[0][2].to(lead), own[0][5].to(lead)
        c0 = torch.where(real0, sum_over_bands(part0, lead), fill)
        c1 = torch.where(real1, sum_over_bands(part1, lead), fill)
        return torch.cat([c0.reshape(bl, -1), c1.reshape(bl, -1)], dim=1)

    return (compacted(0, _INT_MAX), compacted(1, _INT_MAX), compacted(2, 0),
            dropped)


def _make_spatial_step(
    layout: FieldLayout,
    camera_params: torch.Tensor,  # [B / data, 9], on the group's device
    robot_to_cam: SE3,
    family: str | None = None,
    bits_corrected: int | None = None,
    tag_size: float | None = None,
    sign_flip: float | None = None,
    decision_margin_min: float = 0.0,
    refine: bool = True,
    detector_kwargs: dict | None = None,
):
    """One data group's row-banded step ``run(bands, gyro) -> VisionOutput``:
    decimate -> threshold -> CCL -> boundary extraction per band, the
    compaction over bands, then cluster -> quad -> refine -> decode ->
    SQPnP once, on the device of ``layout`` and ``camera_params``."""
    lead = camera_params.device
    dk = dict(detector_kwargs or {})
    qd = int(dk.get("quad_decimate", 2))
    if qd not in (1, 2):
        raise ValueError("quad_decimate must be 1 or 2")
    ccl_iters = int(dk.get("ccl_iters", 12))
    ccl_impl = str(dk.get("ccl_impl", "auto"))
    if ccl_impl not in CCL_IMPLS:
        raise ValueError(f"ccl_impl must be auto/jnp/pallas/pallas_interpret, "
                         f"got {ccl_impl!r}")
    edge_cap = int(dk.get("max_edge_points", MAX_EDGE_POINTS))
    decode = make_decoder(
        load_family(family or DEFAULT_FAMILY),
        bits_corrected=(DEFAULT_BITS_CORRECTED if bits_corrected is None
                        else bits_corrected), device=lead)
    finish = make_post_cluster(
        decode, refine=refine, quad_decimate=qd,
        max_detections=int(dk.get("max_detections", 16)),
        max_quad_candidates=int(dk.get("max_quad_candidates", 32)))
    solver = make_frame_solver(
        layout, tag_size=TAG_SIZE if tag_size is None else tag_size,
        sign_flip=SIGN_FLIP_CONST if sign_flip is None else sign_flip,
        decision_margin_min=decision_margin_min).to(lead)
    camera_params = camera_params.to(torch.float32)
    rc_rot = robot_to_cam.rotation.to(torch.float32)
    rc_t = robot_to_cam.translation.to(torch.float32)

    @torch.no_grad()
    def run(bands: Sequence[torch.Tensor], gyro: torch.Tensor) -> VisionOutput:
        # 1. decimation, local to the band
        hl = bands[0].shape[1]
        if hl % (TILE * qd):
            raise ValueError(
                f"per-shard decimated rows {hl // qd} must tile by {TILE}; "
                f"pad frame rows to a multiple of space*{TILE * qd}")
        small = [decimate2(b) if qd == 2 else b.contiguous() for b in bands]
        hl2, w2 = small[0].shape[1:]
        # 2. adaptive threshold with halo exchange
        terns = [_threshold_block(ext, MIN_WHITE_BLACK_DIFF)
                 for ext in _exchange_halo(small)]
        # 3. CCL with seam exchange
        impl = ccl_impl
        if impl == "auto":
            impl = "pallas" if terns[0].device.type == "cuda" else "jnp"
        if impl == "jnp":
            labels = label_components_block(terns, ccl_iters)
        else:
            labels = label_components_block_kernel(terns)
        # 4. boundary extraction per band (kernel B7), 5. compaction
        black, white, payload, dropped = _compact_over_bands(
            _band_candidates(terns, labels), hl2, w2, edge_cap, lead)
        # 6. cluster -> quad -> refine -> decode on the reassembled frame
        clusters = cluster_candidates_batched(
            black, white, payload, max_points=edge_cap,
            max_clusters=int(dk.get("max_clusters", MAX_CLUSTERS)),
            cluster_points=int(dk.get("cluster_points", MAX_CLUSTER_POINTS)),
            min_points=MIN_CLUSTER_POINTS, dropped=dropped)
        dets = finish(all_gather_rows(bands, 1, lead), clusters)
        # 7. SQPnP + gyro fusion
        res, n_tags = solver(dets, camera_params, rc_rot, rc_t,
                             gyro.to(lead, torch.float32))
        return VisionOutput(
            pose_x=res.position[:, 0],
            pose_y=res.position[:, 1],
            pose_yaw=matrix_to_yaw(res.rotation),
            std_devs=res.std_devs,
            pose_valid=res.valid & (n_tags > 0),
            tag_count=n_tags,
            detections=dets,
        )

    return run
