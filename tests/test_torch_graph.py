"""The captured step (``chalkydri_tpu_torch/utils/graph.py``): a CUDA graph
of ``VisionPipeline`` replayed once per iteration, the port's counterpart
of the JAX package's jitted step.

On the CPU:
- the step stays capturable: the eager CPU step on ``tools/scenes.py``'s
  tiny rig (2 x 128x256), at ``quad_decimate`` 2 and 1 and through the B3
  branch of the full-resolution dispatch, makes no aten op that reads
  the host, and once its caches are warm no tensor of more than one
  element from host data; its output shapes do not depend on the
  frames' contents; and the scan catches an added ``.item()``, an
  added ``torch.tensor(list)`` and an added boolean-mask assignment;
- the builders return the eager modules on the CPU, and the wrapper
  refuses a module there;
- the launch tally of a capture and its replays (``ops/build.py``), and
  the fresh copies of nested outputs.

The row-banded step (``parallel.make_sharded_vision_pipeline(...,
spatial=True)``) on a CPU grid of four bands of the tiny rig, whose tags
straddle the middle seam: a data group's step makes no host read and no
host-made tensor either (with kernel B6 stood in for by plain rounds
without the twin's per-round host check, and on the per-round CCL path),
its output shapes do not depend on the frames, and ``step.pipes`` holds
the eager group steps on the CPU.

On a card (marked ``cuda``, skipped without one): replayed outputs equal
eager outputs bit for bit over alternating inputs, an output stays as it
was after later calls, and a new frame shape captures a second graph;
the row-banded step over four bands of the card replays equal to its
eager step too.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from chalkydri_tpu_torch.detector import pipeline as tdet
from chalkydri_tpu_torch.detector.pipeline import Detector, make_detector
from chalkydri_tpu_torch.detector.segment import label_components, padded_width
from chalkydri_tpu_torch.ops import build
from chalkydri_tpu_torch.parallel import pipeline as tpar
from chalkydri_tpu_torch.parallel import sharded_stages
from chalkydri_tpu_torch.parallel.mesh import make_mesh
from chalkydri_tpu_torch.pipeline import (
    FrameSolver,
    VisionOutput,
    VisionPipeline,
    build_rig_from_config,
    make_vision_pipeline,
)
from chalkydri_tpu_torch.tools.scenes import render_tiny, tiny_rig
from chalkydri_tpu_torch.utils import graph

torch.set_num_threads(1)

# aten ops that wait for the device and read a value on the host: a CUDA
# graph cannot hold them. Indexing with a boolean mask counts its
# elements first (OpLog names it "<op>[bool]").
HOST_READS = {"_local_scalar_dense", "nonzero", "equal", "is_nonzero",
              "masked_select", "_unique2", "unique_dim",
              "_linalg_check_errors", "index[bool]", "index_put_[bool]",
              "index_put[bool]"}
BATCH = 2
BANDS = 4  # row bands of the row-banded step, on one device
# dispatch branches of the quad search at the tiny rig's 128x256 frames:
# (quad_decimate, EXTRACT_BLOCK_MAX_PIXELS patched to)
BRANCHES = {"qd2": (2, None), "qd1": (1, None), "qd1 B3": (1, 0)}


class OpLog(TorchDispatchMode):
    """Records (op name, elements of its first tensor argument)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in ("index", "index_put_", "index_put") and any(
                i is not None and i.dtype == torch.bool for i in args[1]):
            name += "[bool]"
        first = next((a for a in args if isinstance(a, torch.Tensor)), None)
        self.ops.append((name, -1 if first is None else first.numel()))
        return func(*args, **(kwargs or {}))


def tiny_step(qd: int, device="cpu"):
    layout, cams = tiny_rig()
    params, rc = build_rig_from_config(cams * BATCH, layout, device=device)
    step = make_vision_pipeline(layout.to(device), params, rc, device=device,
                                detector_kwargs={"quad_decimate": qd})
    frames = torch.from_numpy(render_tiny(layout, rc, BATCH)).to(device)
    gyro = torch.zeros(BATCH, dtype=torch.float32, device=device)
    return step, frames, gyro


def banded_step(qd: int, impl: str = "pallas", device="cpu"):
    """The row-banded step over four bands of one device on the tiny rig:
    (step, placed bands and gyro of the one data group, frames, gyro);
    ``step.place`` is its placement."""
    layout, cams = tiny_rig()
    params, rc = build_rig_from_config(cams * BATCH, layout, device=device)
    step, place = tpar.make_sharded_vision_pipeline(
        layout, params, rc, make_mesh([device] * BANDS, space=BANDS),
        spatial=True, detector_kwargs={"quad_decimate": qd, "ccl_impl": impl})
    frames = torch.from_numpy(render_tiny(layout, rc, BATCH)).to(device)
    gyro = torch.zeros(BATCH, dtype=torch.float32, device=device)
    bands, gyros = place(frames, gyro)
    step.place = place
    return step, (*bands[0], gyros[0]), frames, gyro


def b6_plain_rounds(monkeypatch, rounds: int = 4) -> None:
    """Stand ``rounds`` plain CCL rounds in for kernel B6 in the band CCL.
    On the card B6 is one launch an entry; its CPU twin checks for its
    fixed point on the host every round (``torch.equal``), which no graph
    of the card's step holds. At the tiny rig's bands ``rounds`` reach the
    fixed point, so the step's outputs stay the twin's."""
    def label(tern):
        _, h, w = tern.shape
        flat = (torch.arange(h)[:, None] * padded_width(w)
                + torch.arange(w)[None, :])
        return label_components(tern, rounds, labels0=flat)

    def propagate(tern, labels, active=None):
        out = label_components(tern, rounds, labels0=labels)
        return torch.where(active.to(torch.bool)[:, None, None], out, labels)

    monkeypatch.setattr(sharded_stages, "label_components_blocked", label)
    monkeypatch.setattr(sharded_stages, "propagate_components_blocked",
                        propagate)


def leaves(out: VisionOutput) -> list:
    return [*out[:-1], *out.detections]


def scan(step, frames, gyro):
    """(host-reading ops of the first call, of the second call, sizes of
    the second call's ``lift_fresh`` tensors of more than one element,
    ops a call)."""
    logs = []
    for _ in range(2):
        with OpLog() as log:
            step(frames, gyro)
        logs.append(log.ops)
    reads = [sorted({n for n, _ in ops if n in HOST_READS}) for ops in logs]
    fresh = [k for n, k in logs[1] if n == "lift_fresh" and k > 1]
    return reads[0], reads[1], fresh, len(logs[1])


@pytest.fixture(params=list(BRANCHES))
def branch(request, monkeypatch):
    qd, extract_max = BRANCHES[request.param]
    if extract_max is not None:
        monkeypatch.setattr(tdet, "EXTRACT_BLOCK_MAX_PIXELS", extract_max)
    return qd


def test_step_makes_no_host_read(branch):
    step, frames, gyro = tiny_step(branch)
    assert isinstance(step, VisionPipeline)
    first, second, fresh, n_ops = scan(step, frames, gyro)
    assert n_ops > 1000  # the scan saw the whole step
    assert first == [] and second == []
    assert fresh == []


def test_output_shapes_do_not_depend_on_the_frames(branch):
    step, frames, gyro = tiny_step(branch)
    out = step(frames, gyro)
    assert bool(out.detections.valid.any())
    blank = step(torch.full_like(frames, 127), gyro)
    noise = step(torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, frames.shape, dtype=np.uint8)), gyro)
    for other in (blank, noise):
        assert [x.shape for x in leaves(other)] == [x.shape
                                                    for x in leaves(out)]
        assert [x.dtype for x in leaves(other)] == [x.dtype
                                                    for x in leaves(out)]


def test_scan_catches_a_host_read_and_host_data(monkeypatch):
    forward = FrameSolver.forward

    def item_read(self, dets, *args):
        int(dets.ids.max())  # a host read
        return forward(self, dets, *args)

    def host_data(self, dets, *args):
        res, n = forward(self, dets, *args)
        return res, n + torch.tensor([0, 0], dtype=torch.int32)

    def mask_index(self, dets, *args):
        res, n = forward(self, dets, *args)
        n[n < 0] = 0  # a boolean mask, not a where
        return res, n

    step, frames, gyro = tiny_step(2)
    monkeypatch.setattr(FrameSolver, "forward", item_read)
    first, second, fresh, _ = scan(step, frames, gyro)
    assert first == second == ["_local_scalar_dense"] and fresh == []
    monkeypatch.setattr(FrameSolver, "forward", host_data)
    first, second, fresh, _ = scan(step, frames, gyro)
    assert first == second == [] and fresh == [BATCH]
    monkeypatch.setattr(FrameSolver, "forward", mask_index)
    first, second, fresh, _ = scan(step, frames, gyro)
    assert first == second == ["index_put_[bool]"] and fresh == []


def test_builders_are_eager_on_the_cpu():
    step, _, _ = tiny_step(2)
    assert type(step) is VisionPipeline
    assert type(make_detector(device="cpu")) is Detector
    det = make_detector(capacity_fallback=True, device="cpu")
    assert type(det) is Detector and det._captured_detect is None


def test_wrapper_refuses_a_cpu_module():
    step, _, _ = tiny_step(2)
    with pytest.raises(ValueError, match="CUDA card"):
        graph.CapturedStep(step)
    with pytest.raises(ValueError, match="CUDA card"):
        graph.CapturedStep(step.detector.detect, device="cpu")


@pytest.mark.parametrize("qd,impl", [(2, "pallas"), (1, "pallas"),
                                     (2, "jnp")])
def test_row_banded_step_makes_no_host_read(qd, impl, monkeypatch):
    step, args, _, _ = banded_step(qd, impl)
    (pipe,) = step.pipes
    want = pipe(*args)
    assert int(want.tag_count.min()) >= 1
    b6_plain_rounds(monkeypatch)
    first, second, fresh, n_ops = scan(lambda *_: pipe(*args), None, None)
    assert n_ops > 1000
    assert first == [] and second == []
    assert fresh == []
    got = pipe(*args)
    for a, b in zip(leaves(got), leaves(want)):
        assert torch.equal(a, b)
    # the tags straddle the middle seam: every frame ran seam rounds
    expect = [12] * BATCH if impl == "jnp" else [3] * BATCH
    assert step.ccl_rounds().tolist() == expect


def test_row_banded_output_shapes_do_not_depend_on_the_frames():
    step, args, frames, gyro = banded_step(2)
    (pipe,) = step.pipes
    *bands, g = args
    out = pipe(*args)
    assert bool(out.detections.valid.any())
    rng = np.random.default_rng(0)
    for other in ([torch.full_like(b, 127) for b in bands],
                  [torch.from_numpy(rng.integers(0, 256, b.shape,
                                                 dtype=np.uint8))
                   for b in bands]):
        res = pipe(*other, g)
        assert [x.shape for x in leaves(res)] == [x.shape for x in leaves(out)]
        assert [x.dtype for x in leaves(res)] == [x.dtype for x in leaves(out)]
        assert step.ccl_rounds().shape == (BATCH,)


def test_row_banded_pipes_are_eager_on_the_cpu():
    step, args, frames, gyro = banded_step(2)
    (pipe,) = step.pipes
    assert callable(pipe) and not isinstance(pipe, graph.CapturedStep)
    assert pipe.ccl_rounds.dtype == torch.int32
    one = [torch.device("cuda", 0)] * BANDS
    assert tpar._one_card(one)
    assert not tpar._one_card(one[:3] + [torch.device("cuda", 1)])
    assert not tpar._one_card([torch.device("cpu")] * BANDS)


def test_launch_tally_counts_each_replay():
    def kernel():
        build.count(kernel)
        build.count(kernel, "chain_launches")

    kernel.launches = kernel.chain_launches = 0
    kernel()
    with build.capture_tally() as tally:
        kernel()
        kernel()
    assert (kernel.launches, kernel.chain_launches) == (1, 1)
    assert tally == {(kernel, "launches"): 2, (kernel, "chain_launches"): 2}
    for _ in range(3):
        build.add_tally(tally)
    assert (kernel.launches, kernel.chain_launches) == (7, 7)
    kernel()  # the tally ended with its context
    assert kernel.launches == 8


def test_outputs_are_fresh_copies_of_nested_tuples():
    step, frames, gyro = tiny_step(2)
    out = step(frames, gyro)
    copy = graph._map(torch.clone, out)
    assert type(copy) is VisionOutput
    assert type(copy.detections) is type(out.detections)
    for a, b in zip(leaves(copy), leaves(out)):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    assert graph._map(torch.clone, (frames, (gyro,)))[1][0].shape == (BATCH,)


# -- on a card ----------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def equal(a: VisionOutput, b: VisionOutput) -> bool:
    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


@pytest.mark.cuda
@pytest.mark.parametrize("qd", [2, 1])
def test_replay_equals_eager_bit_for_bit(card, qd):
    step, frames, gyro = tiny_step(qd, card)
    assert isinstance(step, graph.CapturedStep)
    inputs = [(frames, gyro), (frames ^ 1, gyro + 0.01)]
    eager = [step.module(*x) for x in inputs]
    assert equal(step.module(*inputs[0]), eager[0])
    first = step(*inputs[0])
    for i in range(6):
        assert equal(step(*inputs[i % 2]), eager[i % 2]), i
    assert equal(first, eager[0])  # not overwritten by the later replays
    assert len(step.graphs) == 1 and step.replays == 7


@pytest.mark.cuda
def test_outputs_do_not_alias_the_graph(card):
    step, frames, gyro = tiny_step(2, card)
    a = step(frames, gyro)
    b = step(torch.full_like(frames, 127), gyro)
    assert bool(a.detections.valid.any())
    assert not bool(b.detections.valid.any())
    static = {x.data_ptr() for x in leaves(next(iter(
        step.graphs.values())).outputs)}
    assert not static & {x.data_ptr() for x in leaves(a) + leaves(b)}
    assert equal(a, step.module(frames, gyro))


@pytest.mark.cuda
def test_new_frame_shape_captures_again(card):
    from chalkydri_tpu_torch.ops.ccl_extract import threshold_ccl_extract

    step, frames, gyro = tiny_step(2, card)
    step(frames, gyro)
    threshold_ccl_extract.launches = 0
    top = frames[:, :64].contiguous()  # the tags' rows, half the frame
    out = step(top, gyro)
    assert len(step.graphs) == 2 and out.pose_x.shape == (BATCH,)
    assert equal(out, step.module(top, gyro))
    # the second graph's warm-up calls, then its replay
    assert threshold_ccl_extract.launches == graph.WARMUP_STEPS + 2


@pytest.mark.cuda
@pytest.mark.parametrize("qd", [2, 1])
def test_row_banded_replay_equals_eager_bit_for_bit(card, qd):
    from chalkydri_tpu_torch.ops.propagate import propagate_components_blocked

    step, args, frames, gyro = banded_step(qd, device=card)
    (pipe,) = step.pipes
    assert isinstance(pipe, graph.CapturedStep)
    other = (*(b ^ 1 for b in args[:-1]), args[-1] + 0.01)
    inputs = [args, other]
    eager, rounds = [], []
    for x in inputs:
        eager.append(pipe.module(*x))
        rounds.append(pipe.module.ccl_rounds.clone())
    first = pipe(*inputs[0])
    propagate_components_blocked.launches = 0
    for i in range(6):
        assert equal(pipe(*inputs[i % 2]), eager[i % 2]), i
        assert torch.equal(pipe.module.ccl_rounds, rounds[i % 2]), i
    assert equal(first, eager[0])
    assert len(pipe.graphs) == 1 and pipe.replays == 7
    # a fixed number of gated seam rounds: 2 * bands + 2 B6 calls a band
    assert propagate_components_blocked.launches == 6 * BANDS * (2 * BANDS + 2)
    assert equal(step(*step.place(frames, gyro)), eager[0])
