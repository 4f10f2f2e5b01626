"""Kernel B6's per-frame gate and the gated band CCL, on the CPU.

- ``propagate_components_blocked``'s plain version with ``active`` all
  ones, all zeros and mixed, against the plain version without it: the
  propagation where a frame's flag is set, the caller's labels where not.
- The band CCL (``label_components_block_kernel_rounds``, a fixed number
  of seam rounds gated on the device) on a batch of two frames, one with
  a tag across the seam and one where nothing crosses it, against JAX's
  ``label_components_block_pallas`` in interpret mode under ``shard_map``
  (whose ``psum`` gate is per data group), bit for bit, with the rounds
  each frame ran.

The gate on the card is checked, both routes, by ``chip_smoke.py``.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from chalkydri_tpu.detector import load_family as jax_load_family
from chalkydri_tpu.detector.threshold import adaptive_threshold as jax_threshold
from chalkydri_tpu.parallel.mesh import frame_sharding
from chalkydri_tpu.parallel.mesh import make_mesh as jax_make_mesh
from chalkydri_tpu.parallel.sharded_stages import label_components_block_pallas
from chalkydri_tpu_torch.detector.segment import INVALID
from chalkydri_tpu_torch.ops.propagate import (
    propagate_components_blocked,
    propagate_components_blocked_plain,
)
from chalkydri_tpu_torch.parallel.mesh import (
    gather_frames,
    make_mesh,
    place_frames,
)
from chalkydri_tpu_torch.parallel.sharded_stages import (
    label_components_block_kernel_rounds,
)
from chalkydri_tpu_torch.tools.scenes import blob_tern
from tests.reference_impl.render import axis_aligned_corners, simple_scene

torch.set_num_threads(1)

H, W = 48, 128  # two bands of 24 rows


@pytest.mark.parametrize("active", [[1, 1, 1], [0, 0, 0], [1, 0, 1]])
def test_b6_plain_gate_takes_labels_where_inactive(active):
    tern = torch.from_numpy(blob_tern((3, 40, 200), 7))
    rng = np.random.default_rng(1)
    labels = torch.from_numpy(rng.integers(0, 1 << 30, tern.shape,
                                           dtype=np.int32))
    labels = torch.where(tern == 127, INVALID, labels)
    want = propagate_components_blocked_plain(tern, labels)
    assert not torch.equal(want, labels)
    flags = torch.tensor(active, dtype=torch.int32)
    got = propagate_components_blocked_plain(tern, labels, active=flags)
    assert got.dtype == torch.int32
    for b, on in enumerate(active):
        assert torch.equal(got[b], want[b] if on else labels[b]), b
    # the wrapper takes the plain version on CPU tensors
    assert torch.equal(propagate_components_blocked(tern, labels,
                                                    active=flags), got)


@pytest.fixture(scope="module")
def mixed_tern():
    """Frame 0: a tag across the seam at row 24. Frame 1: the same frame
    with the two rows that face each other across the seam set to skip,
    so that no component crosses it."""
    canvas, _ = simple_scene(jax_load_family("tag36h11"),
                             [(2, axis_aligned_corners(64, 24, 40))],
                             size=(H, W), noise=4.0)
    tern = np.array(jax_threshold(jnp.asarray(canvas[None])))
    cut = tern.copy()
    cut[:, H // 2 - 1:H // 2 + 1] = 127
    return np.concatenate([tern, cut])


def test_gated_band_ccl_on_a_mixed_batch_equals_jax(mixed_tern):
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    jmesh = jax_make_mesh(2, space=2)  # data = 1: both frames in one group
    spec = P("data", "space", None)

    @jax.jit  # one program: the eager shard_map dispatches op by op
    @partial(jax.shard_map, mesh=jmesh, in_specs=spec, out_specs=spec,
             check_vma=False)
    def run(block):
        return label_components_block_pallas(block, H // 2, W, "space",
                                             iters=12, interpret=True)

    want = np.asarray(run(jax.device_put(
        mixed_tern, frame_sharding(jmesh, spatial=True))))
    bands = place_frames(make_mesh(["cpu"] * 2, space=2), mixed_tern,
                         spatial=True)[0]
    labels, rounds = label_components_block_kernel_rounds(bands)
    np.testing.assert_array_equal(gather_frames([labels]).numpy(), want)
    # the tag's frame ran seam rounds; the cut frame none
    assert rounds.dtype == torch.int32
    assert int(rounds[0]) >= 1 and int(rounds[1]) == 0
