// Device code shared by the CCL kernels B1 (ccl_extract.cu), B3-B5
// (threshold_ccl.cu) and B7 (extract_blocked.cu): the adaptive tile
// threshold, the round-invariant connectivity bits, the capped
// label-propagation rounds and the boundary-candidate extraction of one
// pixel. Every page lives in device memory; the stages run as launches on
// the caller's stream, with no host synchronisation.
//
// Semantics (bit-identical to chalkydri_tpu's jnp and Pallas versions):
//   threshold  4x4-tile min/max, dilated over the 3x3 tile neighborhood
//              (out-of-frame tiles contribute nothing); skip (127) where
//              the contrast is under min_diff, else 255 above
//              min + (max - min) / 2 and 0 at or below it;
//   CCL        flat-index labels y * W + x (kInvalid on skip pixels), then
//              exactly `iters` rounds of neighbor-min (4-connectivity for
//              every value, diagonals between white pixels only), row-run
//              min, column-run min and remask. The Pallas kernels stop
//              early at a fixed point, where more rounds change nothing;
//   extraction an edge is a black/white pair of right or down neighbors
//              whose pixels both have at least kMinSame same-valued
//              8-neighbors (the speckle gate); it emits its black label,
//              its white label and x2 | y2 << 13 | dir << 26 | white << 28.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

// Everything has internal linkage: each .cu file that includes this header
// gets its own copy, so the files link into one library without clashes.
namespace ccl {
namespace {

constexpr int32_t kInvalid = 0x7FFFFFFF;
constexpr int kTile = 4;
constexpr int kThreads = 256;

constexpr int kRowStartBit = 8;
constexpr int kColStartBit = 9;
constexpr int kValidBit = 10;

// Neighbor offsets (dy, dx): 4-connectivity first, then the diagonals,
// which connect white pixels only.
__constant__ int kOffDy[8] = {0, 0, 1, -1, 1, 1, -1, -1};
__constant__ int kOffDx[8] = {1, -1, 0, 0, 1, -1, 1, -1};

__global__ void tile_minmax_kernel(const uint8_t* __restrict__ gray, int B,
                                   int H, int W, uint8_t* __restrict__ tmin,
                                   uint8_t* __restrict__ tmax) {
  const int th = H / kTile, tw = W / kTile;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * th * tw) return;
  const int tx = i % tw, ty = (i / tw) % th, b = i / (tw * th);
  const uint8_t* g = gray + ((size_t)b * H + ty * kTile) * W + tx * kTile;
  int mn = 255, mx = 0;
  for (int dy = 0; dy < kTile; ++dy) {
    for (int dx = 0; dx < kTile; ++dx) {
      const int v = g[dy * W + dx];
      mn = min(mn, v);
      mx = max(mx, v);
    }
  }
  tmin[i] = (uint8_t)mn;
  tmax[i] = (uint8_t)mx;
}

__global__ void classify_kernel(const uint8_t* __restrict__ gray,
                                const uint8_t* __restrict__ tmin,
                                const uint8_t* __restrict__ tmax, int B, int H,
                                int W, int min_diff,
                                uint8_t* __restrict__ tern) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * H * W) return;
  const int x = i % W, y = (i / W) % H, b = i / (H * W);
  const int th = H / kTile, tw = W / kTile;
  const int ty = y / kTile, tx = x / kTile;
  int mn = 255, mx = 0;  // out-of-frame tiles contribute nothing
  for (int dy = -1; dy <= 1; ++dy) {
    const int ny = ty + dy;
    if (ny < 0 || ny >= th) continue;
    for (int dx = -1; dx <= 1; ++dx) {
      const int nx = tx + dx;
      if (nx < 0 || nx >= tw) continue;
      const int t = (b * th + ny) * tw + nx;
      mn = min(mn, (int)tmin[t]);
      mx = max(mx, (int)tmax[t]);
    }
  }
  const int contrast = mx - mn;
  const int thresh = mn + contrast / 2;
  uint8_t v = gray[i] > thresh ? 255 : 0;
  if (contrast < min_diff) v = 127;
  tern[i] = v;
}

__global__ void connectivity_kernel(const uint8_t* __restrict__ tern, int B,
                                    int H, int W,
                                    uint16_t* __restrict__ bits,
                                    int32_t* __restrict__ labels) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * H * W) return;
  const int x = i % W, y = (i / W) % H, b = i / (H * W);
  const uint8_t* f = tern + (size_t)b * H * W;
  const int v = f[y * W + x];
  const bool valid = v != 127;
  const bool white = v == 255;
  unsigned bb = 0;
  for (int k = 0; k < 8; ++k) {
    const int ny = y + kOffDy[k], nx = x + kOffDx[k];
    const bool in = ny >= 0 && ny < H && nx >= 0 && nx < W;
    const int nv = in ? f[ny * W + nx] : 127;
    const bool same = valid && nv == v && (k < 4 || white);
    bb |= (unsigned)same << k;
  }
  if (x == 0 || f[y * W + x - 1] != v) bb |= 1u << kRowStartBit;
  if (y == 0 || f[(y - 1) * W + x] != v) bb |= 1u << kColStartBit;
  if (valid) bb |= 1u << kValidBit;
  bits[i] = (uint16_t)bb;
  labels[i] = valid ? y * W + x : kInvalid;
}

// Min over the pixel's own label and its connected neighbors' labels. A
// set connectivity bit implies the neighbor is inside the frame.
__global__ void neighbor_min_kernel(const int32_t* __restrict__ src,
                                    const uint16_t* __restrict__ bits, int B,
                                    int H, int W, int32_t* __restrict__ dst) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * H * W) return;
  const unsigned bb = bits[i];
  int32_t m = src[i];
  for (int k = 0; k < 8; ++k) {
    if ((bb >> k) & 1u) m = min(m, src[i + kOffDy[k] * W + kOffDx[k]]);
  }
  dst[i] = m;
}

// One block per line (a row when along_rows, else a column): every run of
// equal ternary value takes its minimum label, in place. Run ids come from
// a block-wide prefix count of the run-start bits (warp ballots), the run
// minima from shared-memory atomics. With remask, skip pixels leave as
// kInvalid. Dynamic shared memory: 2 * line length ints.
__global__ void line_min_kernel(int32_t* __restrict__ labels,
                                const uint16_t* __restrict__ bits, int H,
                                int W, int along_rows, int remask) {
  extern __shared__ int smem[];
  __shared__ int warp_sum[32];
  __shared__ int carry;
  const int len = along_rows ? W : H;
  const int lines = along_rows ? H : W;
  const int b = blockIdx.x / lines, l = blockIdx.x % lines;
  const size_t base =
      (size_t)b * H * W + (along_rows ? (size_t)l * W : (size_t)l);
  const size_t stride = along_rows ? 1 : (size_t)W;
  const unsigned start_mask = 1u << (along_rows ? kRowStartBit : kColStartBit);
  int* ids = smem;
  int* runmin = smem + len;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int s0 = 0; s0 < len; s0 += blockDim.x) {
    const int j = s0 + threadIdx.x;
    const bool flag = j < len && (bits[base + j * stride] & start_mask);
    const unsigned ballot = __ballot_sync(0xffffffffu, flag);
    const int upto = __popc(ballot & (0xffffffffu >> (31 - lane)));
    if (lane == 31) warp_sum[warp] = __popc(ballot);
    __syncthreads();
    if (warp == 0) {
      int ws = lane < nwarps ? warp_sum[lane] : 0;
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, ws, o);
        if (lane >= o) ws += t;
      }
      if (lane < nwarps) warp_sum[lane] = ws;  // inclusive over warps
    }
    __syncthreads();
    if (j < len) {
      ids[j] = carry + (warp > 0 ? warp_sum[warp - 1] : 0) + upto - 1;
      runmin[j] = kInvalid;
    }
    __syncthreads();
    if (threadIdx.x == 0) carry += warp_sum[nwarps - 1];
    __syncthreads();
  }
  for (int j = threadIdx.x; j < len; j += blockDim.x) {
    atomicMin(&runmin[ids[j]], labels[base + j * stride]);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < len; j += blockDim.x) {
    int32_t v = runmin[ids[j]];
    if (remask && !(bits[base + j * stride] & (1u << kValidBit))) v = kInvalid;
    labels[base + j * stride] = v;
  }
}

constexpr int kMinSame = 2;  // speckle gate: same-valued 8-neighbors

// Same-valued 8-neighbors of (y, x) on an [H, W] page; neighbors outside
// the page read as 127.
__device__ __forceinline__ int same_count(const uint8_t* f, int H, int W,
                                          int y, int x) {
  const int v = f[y * W + x];
  int c = 0;
  for (int dy = -1; dy <= 1; ++dy) {
    for (int dx = -1; dx <= 1; ++dx) {
      if (!dy && !dx) continue;
      const int ny = y + dy, nx = x + dx;
      const bool in = ny >= 0 && ny < H && nx >= 0 && nx < W;
      c += (in ? f[ny * W + nx] : 127) == v;
    }
  }
  return c;
}

// The two candidates (dir 0: right pair, dir 1: down pair) of the pixel at
// row y, column x of one frame's [H, W] ternary page f and label page lab.
// They land in slot (out_y, x) of the frame's dir-major [2, out_h, W]
// pages black/white/payload, with row y_global in the payload. Rows of the
// page outside the emitted ones are neighbor context only.
__device__ __forceinline__ void emit_candidates(
    const uint8_t* f, const int32_t* lab, int H, int W, int y, int x,
    int out_y, int out_h, int y_global, int32_t* black, int32_t* white,
    int32_t* payload) {
  const int v = f[y * W + x];
  const int32_t l = lab[y * W + x];
  const bool solid = same_count(f, H, W, y, x) >= kMinSame;
  const bool p_white = v == 255;
  for (int di = 0; di < 2; ++di) {
    const int dy = di, dx = 1 - di;
    const int ny = y + dy, nx = x + dx;
    const bool in = ny < H && nx < W;
    const int nv = in ? f[ny * W + nx] : 127;
    const int32_t nl = in ? lab[ny * W + nx] : 0;
    const bool nsolid = in && same_count(f, H, W, ny, nx) >= kMinSame;
    const bool edge = (v + nv == 255) && solid && nsolid;
    const size_t o = ((size_t)di * out_h + out_y) * W + x;
    black[o] = edge ? (p_white ? nl : l) : kInvalid;
    white[o] = edge ? (p_white ? l : nl) : kInvalid;
    payload[o] = ((2 * x + dx) & 0x1FFF) |
                 (((2 * y_global + dy) & 0x1FFF) << 13) | (di << 26) |
                 ((int)p_white << 28);
  }
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

inline int round_up32(int n) { return (n + 31) / 32 * 32; }

}  // namespace
}  // namespace ccl

#define CCL_CHECK_LAUNCH()                      \
  do {                                          \
    const cudaError_t e = cudaGetLastError();   \
    if (e != cudaSuccess) return (int)e;        \
  } while (0)

namespace ccl {
namespace {

// gray [B, H, W] u8 -> tern [B, H, W] u8 through tile_min/tile_max
// scratch [B, H/4, W/4]. Returns the launch error code (0 on success).
inline int threshold(const uint8_t* gray, int B, int H, int W, int min_diff,
                     uint8_t* tile_min, uint8_t* tile_max, uint8_t* tern,
                     cudaStream_t s) {
  const int ntiles = B * (H / kTile) * (W / kTile);
  tile_minmax_kernel<<<blocks_for(ntiles), kThreads, 0, s>>>(
      gray, B, H, W, tile_min, tile_max);
  CCL_CHECK_LAUNCH();
  classify_kernel<<<blocks_for(B * H * W), kThreads, 0, s>>>(
      gray, tile_min, tile_max, B, H, W, min_diff, tern);
  CCL_CHECK_LAUNCH();
  return 0;
}

// tern [B, H, W] u8 -> exactly `iters` propagation rounds into `labels`
// [B, H, W] int32, with bits [B, H, W] u16 and one more label page
// `scratch` as work space. The rounds ping-pong between the two label
// pages; the first page is picked so that the last round lands in
// `labels`.
inline int label(const uint8_t* tern, int B, int H, int W, int iters,
                 uint16_t* bits, int32_t* labels, int32_t* scratch,
                 cudaStream_t s) {
  const int grid = blocks_for(B * H * W);
  int32_t* cur = iters % 2 == 0 ? labels : scratch;
  int32_t* nxt = iters % 2 == 0 ? scratch : labels;
  connectivity_kernel<<<grid, kThreads, 0, s>>>(tern, B, H, W, bits, cur);
  CCL_CHECK_LAUNCH();
  const int row_threads = std::min(1024, round_up32(W));
  const int col_threads = std::min(1024, round_up32(H));
  for (int r = 0; r < iters; ++r) {
    neighbor_min_kernel<<<grid, kThreads, 0, s>>>(cur, bits, B, H, W, nxt);
    CCL_CHECK_LAUNCH();
    line_min_kernel<<<B * H, row_threads, 2 * W * sizeof(int), s>>>(
        nxt, bits, H, W, 1, 0);
    CCL_CHECK_LAUNCH();
    line_min_kernel<<<B * W, col_threads, 2 * H * sizeof(int), s>>>(
        nxt, bits, H, W, 0, 1);
    CCL_CHECK_LAUNCH();
    int32_t* t = cur;
    cur = nxt;
    nxt = t;
  }
  return 0;
}

}  // namespace
}  // namespace ccl
