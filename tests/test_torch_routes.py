"""The one rule for a hand kernel or its plain twin (``ops/build.py``).

``build.on_card`` is true when every tensor it is given is on a CUDA
device and the calling thread is outside ``build.plain_chain()``; each
kernel wrapper in ``ops/`` launches its kernel then, and returns its
plain twin's result otherwise. Here: the predicate and the context (the
device decides outside it, the answer is false inside it, the state is
per thread, nests and comes back after an exception), and each of the
fifteen wrapper entries on CPU tensors, inside and outside the context,
against its twin bit for bit, with the kernel library made to raise.
"""

from __future__ import annotations

import threading
from types import SimpleNamespace

import pytest
import torch

from chalkydri_tpu_torch.detector.cluster import (
    MAX_EDGE_POINTS,
    cluster_candidates_batched,
    compact_candidates,
    extract_and_compact,
    sort_candidates,
)
from chalkydri_tpu_torch.detector.decode import decode_rank_plain
from chalkydri_tpu_torch.detector.pipeline import Detector, decimate2
from chalkydri_tpu_torch.detector.quad import fit_select_plain
from chalkydri_tpu_torch.detector.refine import refine_quads
from chalkydri_tpu_torch.detector.segment import (
    label_components,
    rounds_needed,
)
from chalkydri_tpu_torch.detector.threshold import adaptive_threshold
from chalkydri_tpu_torch.ops import build, front, tail
from chalkydri_tpu_torch.ops.ccl_extract import (
    threshold_ccl_extract,
    threshold_ccl_extract_plain,
    threshold_ccl_extract_rounds,
)
from chalkydri_tpu_torch.ops.extract_blocked import (
    extract_candidates_band,
    extract_candidates_band_plain,
)
from chalkydri_tpu_torch.ops.propagate import (
    label_components_blocked,
    label_components_blocked_plain,
    propagate_components_blocked,
    propagate_components_blocked_plain,
)
from chalkydri_tpu_torch.ops.segment_stats import (
    segment_stats,
    segment_stats_plain,
)
from chalkydri_tpu_torch.ops.solve import solve_frames
from chalkydri_tpu_torch.ops.threshold_ccl import (
    label_components_ccl,
    label_components_ccl_rounds,
    threshold_ccl,
    threshold_ccl_exact,
    threshold_ccl_exact_plain,
    threshold_ccl_plain,
)
from chalkydri_tpu_torch.pipeline import build_rig_from_config
from chalkydri_tpu_torch.solver.robot_pose import solve_frames_plain
from chalkydri_tpu_torch.solver.sqpnp import MAX_ITER
from chalkydri_tpu_torch.tools.scenes import render_tiny, tiny_rig

CARD = SimpleNamespace(device=torch.device("cuda", 0))  # on_card reads .device
HOST = torch.zeros(1)


def test_on_card_follows_the_device_outside_the_context():
    assert build.on_card(CARD)
    assert build.on_card(CARD, CARD)
    assert not build.on_card(HOST)
    assert not build.on_card(CARD, HOST)
    with pytest.raises(ValueError, match="unsupported device"):
        build.on_card(torch.zeros(1, device="meta"))


def test_plain_chain_is_false_inside_nests_and_restores():
    assert build.on_card(CARD)
    with build.plain_chain():
        assert not build.on_card(CARD)
        with build.plain_chain():
            assert not build.on_card(CARD)
        assert not build.on_card(CARD)  # the inner exit keeps the outer's
    assert build.on_card(CARD)
    with pytest.raises(RuntimeError, match="inside"):
        with build.plain_chain():
            raise RuntimeError("inside")
    assert build.on_card(CARD)


def test_plain_chain_is_per_thread():
    seen = {}
    entered, checked = threading.Event(), threading.Event()

    def other():
        entered.wait()
        seen["other"] = build.on_card(CARD)
        with build.plain_chain():
            seen["other inside"] = build.on_card(CARD)
        checked.set()

    t = threading.Thread(target=other)
    t.start()
    with build.plain_chain():
        entered.set()
        checked.wait()
        seen["this inside"] = build.on_card(CARD)
    t.join()
    seen["this after"] = build.on_card(CARD)
    assert seen == {"other": True, "other inside": False,
                    "this inside": False, "this after": True}


@pytest.fixture(scope="module")
def scene():
    """Two tiny frames of tags 1 and 2 on the CPU, the detector's
    intermediate tensors and the solve's inputs."""
    layout, cams = tiny_rig()
    params, rc = build_rig_from_config(cams * 2, layout, device="cpu")
    gray = torch.from_numpy(render_tiny(layout, rc, 2))
    det = Detector(family="tag36h11", bits_corrected=3)
    small = decimate2(gray)
    tern = adaptive_threshold(small)
    labels = label_components_blocked_plain(tern)
    pages = threshold_ccl_extract_plain(small)
    keys = sort_candidates(*compact_candidates(
        *pages, width=small.shape[2], max_points=MAX_EDGE_POINTS)[:3],
        MAX_EDGE_POINTS)
    with torch.no_grad():
        out = det(gray)
        black, white, payload, dropped = det.candidates(small)
    cl = cluster_candidates_batched(black, white, payload,
                                    max_points=det.edge_cap,
                                    max_clusters=det.max_clusters,
                                    cluster_points=det.cluster_points,
                                    dropped=dropped)
    _, corners, valid = fit_select_plain(cl.points, cl.mask, cl.valid,
                                         cl.count, 32, 2)
    solve = ((out.ids, out.corners, out.valid, out.decision_margins,
              layout.rotations, layout.translations, layout.present, params,
              rc.rotation, rc.translation, torch.zeros(2)),
             dict(tag_size=0.1651, sign_flip=600.0, decision_margin_min=0.0,
                  max_iter=MAX_ITER))
    assert int(out.valid.sum()) == 4  # two tags in each frame
    return SimpleNamespace(gray=gray, small=small, tern=tern, labels=labels,
                           keys=keys, cl=cl, corners=corners, valid=valid,
                           decode=det.decode, solve=solve)


def _rounds(tern, iters):
    return (rounds_needed(tern, iters) + 1).clamp(max=iters).to(torch.int32)


# entry -> (the wrapper's call, its twin's call) on the scene
ENTRIES = {
    "B1 threshold_ccl_extract": (
        lambda s: threshold_ccl_extract(s.small, iters=4),
        lambda s: threshold_ccl_extract_plain(s.small, iters=4)),
    "B1 threshold_ccl_extract_rounds": (
        lambda s: threshold_ccl_extract_rounds(s.small, iters=4),
        lambda s: (threshold_ccl_extract_plain(s.small, iters=4),
                   _rounds(s.tern, 4))),
    "B2 segment_stats": (
        lambda s: segment_stats(*s.keys),
        lambda s: segment_stats_plain(*s.keys)),
    "B3 threshold_ccl": (
        lambda s: threshold_ccl(s.small, iters=4),
        lambda s: threshold_ccl_plain(s.small, iters=4)),
    "B4 label_components_ccl": (
        lambda s: label_components_ccl(s.tern, iters=4),
        lambda s: label_components(s.tern, iters=4)),
    "B4 label_components_ccl_rounds": (
        lambda s: label_components_ccl_rounds(s.tern, iters=4),
        lambda s: (label_components(s.tern, iters=4), _rounds(s.tern, 4))),
    "B5 threshold_ccl_exact": (
        lambda s: threshold_ccl_exact(s.small),
        lambda s: threshold_ccl_exact_plain(s.small)),
    "B6 label_components_blocked": (
        lambda s: label_components_blocked(s.tern, want_converged=True),
        lambda s: label_components_blocked_plain(s.tern, want_converged=True)),
    "B6 propagate_components_blocked": (
        lambda s: propagate_components_blocked(
            s.tern, s.labels, active=torch.tensor([1, 0], dtype=torch.int32)),
        lambda s: propagate_components_blocked_plain(
            s.tern, s.labels, active=torch.tensor([1, 0], dtype=torch.int32))),
    "B7 extract_candidates_band": (
        lambda s: extract_candidates_band(s.tern, s.labels, 1, 2, 7),
        lambda s: extract_candidates_band_plain(s.tern, s.labels, 1, 2, 7)),
    "X1-X3 extract_compact": (
        lambda s: front.extract_compact(s.tern, s.labels, 1024),
        lambda s: extract_and_compact(s.tern, s.labels, 1024)),
    "S1 solve_frames": (
        lambda s: solve_frames(*s.solve[0], **s.solve[1]),
        lambda s: solve_frames_plain(*s.solve[0], **s.solve[1])),
    "T1 fit_select": (
        lambda s: tail.fit_select(s.cl.points, s.cl.mask, s.cl.valid,
                                  s.cl.count, 32, 2),
        lambda s: fit_select_plain(s.cl.points, s.cl.mask, s.cl.valid,
                                   s.cl.count, 32, 2)),
    "T2 refine_corners": (
        lambda s: tail.refine_corners(s.gray, s.corners, s.valid),
        lambda s: refine_quads(s.gray, s.corners, s.valid)),
    "T3 decode_rank": (
        lambda s: tail.decode_rank(s.decode, s.gray, s.corners, s.valid, 16),
        lambda s: decode_rank_plain(s.decode, s.gray, s.corners, s.valid,
                                    16)),
}


def _refuse(*args, **kwargs):
    raise AssertionError("a plain route reached the kernel library")


@pytest.mark.parametrize("inside", [False, True],
                         ids=["outside plain_chain", "inside plain_chain"])
@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_cpu_inputs_take_the_twin(scene, entry, inside, monkeypatch):
    """Each wrapper entry on CPU tensors, outside and inside
    ``plain_chain()``, returns its twin's result bit for bit, in the
    twin's structure, and never reaches the kernel library."""
    wrapper, twin = ENTRIES[entry]
    monkeypatch.setattr(build, "kernel_library", _refuse)
    with torch.no_grad():
        want = twin(scene)
        if inside:
            with build.plain_chain():
                got = wrapper(scene)
        else:
            got = wrapper(scene)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
