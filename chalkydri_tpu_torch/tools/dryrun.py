"""Dry run of the row-banded detect -> pose step (the port's counterpart of
the JAX package's ``dryrun_multichip``).

    python3 -m chalkydri_tpu_torch.tools.dryrun [--bands N] [--cpu]

Builds a (data = 1, space = N) device grid, on the first CUDA card unless
``--cpu`` (with several cards, band ``j`` goes to card ``j`` modulo their
count), and runs one step of the row-banded program (``spatial=True``) and
one of the whole-frame program on real rendered tag36h11 scenes
(``tools/scenes.tiny_rig``), in two geometries: ``tiny`` (128x256) and
``deployed-1280x800-qd2`` (the same scene through a 1280x800 lens, tag 1
straddling the seam at row 400 of two bands). Each case asserts equal ids
and corners between the two programs, a valid pose for every frame, tag 1
decoded, and the pose within 0.25 m of the truth; it prints one ``dryrun OK``
line per case. Fails without CUDA unless ``--cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from chalkydri_tpu_torch.parallel.mesh import make_mesh
from chalkydri_tpu_torch.parallel.pipeline import make_sharded_vision_pipeline
from chalkydri_tpu_torch.pipeline import build_rig_from_config
from chalkydri_tpu_torch.tools.scenes import (
    PROD_CALIB,
    TINY_CALIB,
    TINY_ROBOT,
    render_tiny,
    tiny_rig,
)

CASES = (
    ("tiny", TINY_CALIB, 16,
     dict(max_edge_points=4096, max_clusters=16, cluster_points=128)),
    ("deployed-1280x800-qd2", PROD_CALIB, 32,
     dict(max_edge_points=16384, max_clusters=32, cluster_points=256,
          quad_decimate=2)),
)


def dryrun_multichip(n_bands: int = 2, device: str | None = None,
                     batch: int = 4) -> None:
    """Run both cases over ``n_bands`` row bands; raises on any failed
    assertion. ``device``: where every band lives (default: the visible
    CUDA cards in turn; pass ``"cpu"`` for a run without a card)."""
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("dryrun: CUDA is not available (use --cpu)")
        n_cards = torch.cuda.device_count()
        devices = [f"cuda:{j % n_cards}" for j in range(n_bands)]
    else:
        devices = [device] * n_bands
    mesh = make_mesh(devices, space=n_bands)
    lead = mesh.grid[0][0]
    for desc, calib, cell_px, detector_kwargs in CASES:
        layout, cams = tiny_rig(calib)
        params, rc = build_rig_from_config(cams * batch, layout, device=lead)
        frames = render_tiny(layout, rc, batch, calib, cell_px=cell_px)
        gyro = np.zeros(batch, np.float32)
        kw = dict(detector_kwargs=detector_kwargs)

        # 1. the row-banded program: frame rows span the 'space' axis
        # through decimate/threshold/CCL/extraction/compaction.
        step_sp, place_sp = make_sharded_vision_pipeline(
            layout, params, rc, mesh, spatial=n_bands > 1, **kw)
        out = step_sp(*place_sp(frames, gyro))
        # 2. the whole-frame program must agree on the detections.
        step_dp, place_dp = make_sharded_vision_pipeline(
            layout, params, rc, mesh, spatial=False, **kw)
        out_dp = step_dp(*place_dp(frames, gyro))
        if lead.type == "cuda":
            torch.cuda.synchronize()
        if not torch.equal(out.detections.ids, out_dp.detections.ids):
            raise AssertionError(f"[{desc}] ids differ between the programs")
        if not torch.equal(out.detections.corners, out_dp.detections.corners):
            raise AssertionError(f"[{desc}] corners differ between the programs")

        if out.pose_x.shape != (batch,):
            raise AssertionError(f"[{desc}] pose shape {out.pose_x.shape}")
        valid = out.pose_valid.cpu().numpy()
        counts = out.tag_count.cpu().numpy()
        ids = {int(i) for i in out.detections.ids.cpu().numpy().ravel()
               if i >= 0}
        if not valid.all():
            raise AssertionError(f"[{desc}] no pose: valid={valid.tolist()}")
        if not (counts >= 1).all():
            raise AssertionError(f"[{desc}] no tags: {counts.tolist()}")
        if 1 not in ids:
            raise AssertionError(f"[{desc}] tag 1 not decoded; ids={sorted(ids)}")
        pose = torch.stack([out.pose_x, out.pose_y], -1).cpu().numpy()
        err = float(np.abs(pose - np.asarray(TINY_ROBOT[:2])).max())
        if not err < 0.25:
            raise AssertionError(f"[{desc}] pose err {err:.3f} m vs "
                                 f"{TINY_ROBOT[:2]}")
        print(f"dryrun OK [{desc}]: mesh={mesh.shape} devices="
              f"{sorted({str(d) for d in devices})} batch={batch} "
              f"frame={calib['height']}x{calib['width']} "
              f"spatial={n_bands > 1} ids={sorted(ids)} "
              f"counts={counts.tolist()} pose_err={err:.4f} m", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--bands", type=int, default=2)
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args()
    dryrun_multichip(args.bands, device="cpu" if args.cpu else None)


if __name__ == "__main__":
    main()
