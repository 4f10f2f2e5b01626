"""Kernel B1's plain twin (threshold -> CCL -> candidate extraction) against
the JAX package's Pallas kernel in interpret mode, bit for bit.

The CUDA kernel itself is compared with the same twin on the GPU by
``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chalkydri_tpu.detector import adaptive_threshold as jax_threshold
from chalkydri_tpu.detector import label_components as jax_label
from chalkydri_tpu.detector import load_family as jax_load_family
from chalkydri_tpu.detector.segment import labels_converged as jax_converged
from chalkydri_tpu.ops.pallas.ccl_kernel import threshold_ccl_extract_pallas
from chalkydri_tpu_torch.detector.segment import label_components, labels_converged
from chalkydri_tpu_torch.detector.threshold import adaptive_threshold
from chalkydri_tpu_torch.ops.ccl_extract import threshold_ccl_extract
from tests.reference_impl.render import axis_aligned_corners, simple_scene

torch.set_num_threads(1)


def _tag_scene(noise):
    canvas, _ = simple_scene(jax_load_family("tag36h11"),
                             [(5, axis_aligned_corners(160, 120, 70))],
                             size=(240, 320), noise=noise)
    return canvas[None]


def _serpentine_gray(h=64, w=128, stripes=20):
    """A white snake on black: vertical 1-px stripes joined alternately at
    the top and bottom row, close enough that every tile neighborhood has
    contrast, so it thresholds to exactly this 0/255 pattern. The minimum
    label moves about one stripe per round, so 12 rounds do not converge."""
    g = np.zeros((h, w), np.uint8)
    cols = np.linspace(2, w - 3, stripes).astype(int)
    g[:, cols] = 255
    for i in range(len(cols) - 1):
        row = 0 if i % 2 == 0 else h - 1
        g[row, cols[i]:cols[i + 1] + 1] = 255
    return g[None]


def _assert_extract_equal(gray):
    want = threshold_ccl_extract_pallas(jnp.asarray(gray), iters=12,
                                        interpret=True)
    got = threshold_ccl_extract(torch.from_numpy(gray), iters=12)
    for name, w, g in zip(("black", "white", "payload"), want, got):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("noise", [0.0, 8.0])
def test_extract_matches_pallas_on_tag_scene(noise):
    _assert_extract_equal(_tag_scene(noise))


def test_extract_matches_pallas_where_round_cap_binds():
    gray = _serpentine_gray()
    tern = jax_threshold(jnp.asarray(gray))
    np.testing.assert_array_equal(np.asarray(tern), gray)  # same pattern
    labels = jax_label(tern, iters=12)
    assert not jax_converged(tern, labels)  # the 12-round cap binds
    _assert_extract_equal(gray)


def test_threshold_matches_jax():
    gray = _tag_scene(8.0)
    want = np.asarray(jax_threshold(jnp.asarray(gray)))
    got = adaptive_threshold(torch.from_numpy(gray)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("iters", [1, 2, 3])
def test_label_components_matches_jax(iters):
    gray = np.concatenate([_tag_scene(8.0)[:, :64, :128], _serpentine_gray()])
    tern = np.array(jax_threshold(jnp.asarray(gray)))
    want = np.asarray(jax_label(jnp.asarray(tern), iters=iters))
    got = label_components(torch.from_numpy(tern), iters=iters)
    np.testing.assert_array_equal(got.numpy(), want)
    assert labels_converged(torch.from_numpy(tern), got) == jax_converged(
        jnp.asarray(tern), jnp.asarray(want))


def test_wrapper_counts_only_kernel_launches():
    before = threshold_ccl_extract.launches
    threshold_ccl_extract(torch.from_numpy(_serpentine_gray()), iters=2)
    assert threshold_ccl_extract.launches == before  # CPU: plain twin


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        threshold_ccl_extract(torch.zeros((1, 8, 8), dtype=torch.uint8,
                                          device="meta"))
