"""Kernel B2's plain twin (run-length segment statistics) against the JAX
package's Pallas kernel in interpret mode, bit for bit, on the adversarial
layouts of the JAX package's own kernel test; at row counts under 1024 or
off the 128-row chunk, against the JAX clustering's plain path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chalkydri_tpu.detector import cluster as jc
from chalkydri_tpu.ops.pallas.segment_kernel import segment_stats_pallas
from chalkydri_tpu_torch.detector import cluster as tc
from chalkydri_tpu_torch.ops.segment_stats import (
    pad_to_chunks,
    segment_stats,
    segment_stats_plain,
)

torch.set_num_threads(1)

_INT_MAX = np.iinfo(np.int32).max


def _layouts(n, rng):
    """One run over the whole array, all invalid, single-element runs, and
    sorted random runs crossing 128-chunks with an invalid tail."""
    runs = []
    while sum(len(r) for r in runs) < n - min(300, n // 3):
        runs.append(np.full(int(rng.integers(1, min(400, n))),
                            int(rng.integers(0, 1 << 30))))
    flat = np.sort(np.concatenate(runs)[: n - min(100, n // 8)]
                   .astype(np.int32))
    return {
        "one_run": np.full(n, 7, np.int32),
        "all_invalid": np.full(n, _INT_MAX, np.int32),
        "single_element_runs": np.arange(n, dtype=np.int32),
        "random_runs_invalid_tail": np.concatenate(
            [flat, np.full(n - len(flat), _INT_MAX, np.int32)]),
    }


@pytest.mark.parametrize("n", [256, 1024, 2048])
def test_segment_stats_matches_pallas(n):
    rng = np.random.default_rng(5)
    layouts = _layouts(n, rng)
    keys = np.stack(list(layouts.values()))
    payloads = rng.integers(0, 1 << 29, keys.shape).astype(np.int32)
    got = segment_stats(torch.from_numpy(keys), torch.from_numpy(payloads))
    for row, name in enumerate(layouts):
        want = segment_stats_pallas(jnp.asarray(keys[row]),
                                    jnp.asarray(payloads[row]), interpret=True)
        for field, w, g in zip(("t", "cand_len", "cand_pos"), want, got):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g[row].numpy(), np.asarray(w),
                                          err_msg=f"{name}: {field}")


@pytest.mark.parametrize("n", [200, 256, 1000])
def test_padding_to_chunks_keeps_the_statistics(n):
    """The kernel's input padding (INT_MAX keys up to a multiple of 128)
    leaves t, cand_len and cand_pos as the unpadded rows give them."""
    rng = np.random.default_rng(n)
    layouts = _layouts(n, rng)
    keys = torch.from_numpy(np.stack(list(layouts.values())))
    payloads = torch.from_numpy(
        rng.integers(0, 1 << 29, keys.shape).astype(np.int32))
    want = segment_stats_plain(keys, payloads)
    pk, pp = pad_to_chunks(keys, payloads)
    assert pk.shape[1] % 128 == 0 and pk.shape[1] - n < 128
    got = segment_stats_plain(pk, pp)
    t = got[0][:, :n]
    for field, w, g in zip(("t", "cand_len", "cand_pos"), want,
                           (t, got[1], got[2])):
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=field)


@pytest.mark.parametrize("n", [200, 256, 1000])
def test_small_row_counts_match_jax_clusters(n):
    """Below 1024 rows the JAX package takes its plain segment path;
    the port's clusters (through the B2 wrapper) match it bitwise."""
    rng = np.random.default_rng(11)
    b, m = 2, 1500
    black = rng.integers(0, 12, (b, m)).astype(np.int32)
    white = rng.integers(100, 103, (b, m)).astype(np.int32)
    black[rng.random((b, m)) < 0.4] = _INT_MAX
    xs = rng.integers(0, 8000, (b, m))
    ys = rng.integers(0, 8000, (b, m))
    payload = (xs | (ys << 13) | (rng.integers(0, 2, (b, m)) << 26)
               | (rng.integers(0, 2, (b, m)) << 28)).astype(np.int32)
    kw = dict(max_points=n, max_clusters=4, cluster_points=32, min_points=4)
    want = jc.cluster_candidates_batched(black, white, payload, **kw)
    got = tc.cluster_candidates_batched(*(torch.from_numpy(x) for x in
                                          (black, white, payload)), **kw)
    assert int(got.valid.sum()) > 0
    for name in jc.Clusters._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_wrapper_rejects_other_devices():
    key = torch.zeros((1, 1024), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        segment_stats(key, key)
