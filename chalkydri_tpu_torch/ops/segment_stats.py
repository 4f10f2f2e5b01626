"""Kernel B2: run-length segment statistics over sorted cluster keys.

``segment_stats`` launches the CUDA kernel (``csrc/segment_stats.cu``)
where ``build.on_card`` says so and returns the plain twin
``segment_stats_plain``'s result elsewhere; it replaces
``chalkydri_tpu/ops/pallas/segment_kernel.py::segment_stats_pallas``
(whose plain twin is ``_segment_jnp`` in
``chalkydri_tpu/detector/cluster.py``).

For [B, n] int32 keys sorted per row (INT_MAX = invalid) and payloads:
``t`` [B, n] is the inclusive count of valid direction-0 candidates;
``cand_len``/``cand_pos`` [B, 2 * ceil(n/128)] are each 128-row chunk's
top-2 runs (a run start scored by its run length, the lowest lane on ties;
the first-place winners of all chunks, then the second-place ones).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from chalkydri_tpu_torch.ops import build

CHUNK = 128
_INT_MAX = 2 ** 31 - 1
_TILE = 1024  # rows per CUDA block

# The kernel's tile status words, kept per (card, stream) between calls
# and zero when made: [1 + tiles] int64, the first word the call counter
# and the count of a call's finished blocks (two 32-bit halves). A call
# finds its tiles' words by the sequence number the counter gives it, so
# nothing is cleared between calls. A call recorded into a CUDA graph
# gets words of the graph's own instead, zeroed by each replay: a replay
# runs on whichever stream its caller is on, and a graph must not hold a
# buffer that a later call on the capture stream could replace.
_STATUS: dict[tuple[torch.device, int], torch.Tensor] = {}


def _status_words(like: torch.Tensor, tiles: int) -> torch.Tensor:
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(1 + tiles, dtype=torch.int64, device=like.device)
    key = (like.device, build.stream_of(like))
    buf = _STATUS.get(key)
    if buf is None or buf.numel() < 1 + tiles:
        buf = torch.zeros(1 + max(tiles, 2 * (buf.numel() if buf is not None
                                               else 0)),
                          dtype=torch.int64, device=like.device)
        _STATUS[key] = buf
    return buf


def _chunk_top(grid: torch.Tensor):
    """Max of each row of [B, nc, 128] and the lowest lane holding it."""
    m = grid.amax(dim=-1)
    lanes = torch.arange(CHUNK, dtype=torch.int32, device=grid.device)
    a = torch.where(grid == m[..., None], lanes, CHUNK).amin(dim=-1)
    return m, a


def segment_stats_plain(s_key: torch.Tensor, s_payload: torch.Tensor):
    """Plain PyTorch version: (t, cand_len, cand_pos), all int32."""
    b, n = s_key.shape
    dev = s_key.device
    s_valid = s_key != _INT_MAX
    prev = torch.cat([torch.full((b, 1), -1, dtype=s_key.dtype, device=dev),
                      s_key[:, :-1]], dim=1)
    new_seg = s_key != prev
    idx = torch.arange(n, dtype=torch.int32, device=dev).expand(b, n)
    start_pos = torch.cummax(torch.where(new_seg, idx, -1), dim=1).values
    nxt = torch.where(new_seg, idx, _INT_MAX)
    next_start = torch.cummin(nxt.flip(1), dim=1).values.flip(1)
    next_start = torch.cat([next_start[:, 1:],
                            torch.full((b, 1), n, dtype=torch.int32, device=dev)],
                           dim=1)
    next_start = torch.clamp(next_start, max=n)
    score = torch.where(new_seg & s_valid, next_start - start_pos, 0)
    d0 = ((((s_payload >> 26) & 0x3) == 0) & s_valid).to(torch.int32)
    t = torch.cumsum(d0, dim=1, dtype=torch.int32)

    grid = F.pad(score, (0, (-n) % CHUNK)).reshape(b, -1, CHUNK)
    m1, a1 = _chunk_top(grid)
    lanes = torch.arange(CHUNK, dtype=torch.int32, device=dev)
    m2, a2 = _chunk_top(torch.where(lanes == a1[..., None], 0, grid))
    base = torch.arange(grid.shape[1], dtype=torch.int32, device=dev) * CHUNK
    cand_len = torch.cat([m1, m2], dim=1).to(torch.int32)
    cand_pos = torch.cat([base + a1, base + a2], dim=1).to(torch.int32)
    return t, cand_len, cand_pos


def pad_to_chunks(s_key: torch.Tensor, s_payload: torch.Tensor):
    """Pad [B, n] sorted rows to a multiple of 128 with invalid keys
    (INT_MAX) and zero payloads. The rows' statistics do not change: the
    padding starts no valid run and ends none early, and its chunk scores
    are the zeros the plain twin pads its chunk grid with."""
    pad = (-s_key.shape[1]) % CHUNK
    return (F.pad(s_key, (0, pad), value=_INT_MAX),
            F.pad(s_payload, (0, pad), value=0))


def segment_stats(s_key: torch.Tensor, s_payload: torch.Tensor):
    """(t, cand_len, cand_pos) for [B, n] int32 sorted keys and payloads.
    The kernel on the card (rows padded to a multiple of 128 for it), else
    the plain twin."""
    if not build.on_card(s_key):
        return segment_stats_plain(s_key, s_payload)
    for x in (s_key, s_payload):
        if x.dtype != torch.int32 or x.dim() != 2 or not x.is_contiguous():
            raise ValueError("segment_stats: expected contiguous [B, n] int32")
    if s_payload.shape != s_key.shape or s_payload.device != s_key.device:
        raise ValueError("segment_stats: key/payload shape or device mismatch")
    b, n = s_key.shape
    if not 0 < n < (1 << 24) - CHUNK:
        raise ValueError(f"segment_stats: n={n} must be in (0, 2^24 - 128)")
    if n % CHUNK:
        s_key, s_payload = pad_to_chunks(s_key, s_payload)
    if s_key.data_ptr() % 16:  # the kernel loads 16 bytes a thread
        s_key = s_key.clone()
    if s_payload.data_ptr() % 16:
        s_payload = s_payload.clone()
    n_pad = s_key.shape[1]
    nc2 = 2 * n_pad // CHUNK
    out = torch.empty(b * (n_pad + 2 * nc2), dtype=torch.int32,
                      device=s_key.device)
    t, cand_len, cand_pos = (
        x.view(b, -1) for x in out.split([b * n_pad, b * nc2, b * nc2]))
    status = _status_words(s_key, b * -(-n_pad // _TILE)).data_ptr()
    build.launch("chalkydri_segment_stats", s_key, s_key.data_ptr(),
                 s_payload.data_ptr(), b, n_pad, status + 8, status,
                 t.data_ptr(), cand_len.data_ptr(), cand_pos.data_ptr())
    build.count(segment_stats)
    if n_pad != n:
        t = t[:, :n].contiguous()
    return t, cand_len, cand_pos


segment_stats.launches = 0
