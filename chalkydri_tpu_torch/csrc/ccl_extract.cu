// Kernel B1: adaptive threshold -> connected-component labeling ->
// boundary-candidate extraction, for a batch of decimated grayscale frames.
//
// Replaces chalkydri_tpu/ops/pallas/ccl_kernel.py::threshold_ccl_extract_pallas
// and gives bit-identical output: dir-major [B, 2, H, W] int32 pages of
// black label, white label and packed payload
// (x2 | y2 << 13 | dir << 26 | white << 28).
//
// The TPU kernel keeps a whole frame in VMEM. Here one 400x640 int32 label
// page is 1 MB, far over the 227 KB of shared memory a block can use, so
// this first version keeps every page in device memory: four frames of
// labels are 4 MB and stay in the 50 MB L2. The stages run as launches on
// the caller's stream from one C entry point:
//   1. tile min/max (4x4 tiles), then per-pixel classification against
//      the 3x3-tile dilated extrema;
//   2. the round-invariant connectivity bits (8 offsets, run starts along
//      rows and columns, validity) and the initial flat-index labels;
//   3. exactly `iters` rounds of neighbor-min, row-run min, column-run min
//      (with the remask of skip pixels). The Pallas kernel stops early at
//      a fixed point, where further rounds change nothing, so the labels
//      agree. There is no host synchronisation anywhere;
//   4. the extraction epilogue (speckle gate + right/down edge pairs).
//
// What bounds it: the 24 B/px of candidate pages written, and about
// 12 rounds x ~26 B/px of label/bit traffic, served mostly from L2. Fusing
// the rounds into shared-memory tiles, and fusing block compaction into the
// epilogue, is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int32_t kInvalid = 0x7FFFFFFF;
constexpr int kTile = 4;
constexpr int kThreads = 256;
constexpr int kMinSame = 2;  // speckle gate: same-valued 8-neighbors

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

// Same-valued 8-neighbors of (y, x); out-of-frame neighbors read as 127.
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

__global__ void extract_kernel(const uint8_t* __restrict__ tern,
                               const int32_t* __restrict__ labels, int B,
                               int H, int W, int32_t* __restrict__ black,
                               int32_t* __restrict__ white,
                               int32_t* __restrict__ payload) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * H * W) return;
  const int x = i % W, y = (i / W) % H, b = i / (H * W);
  const uint8_t* f = tern + (size_t)b * H * W;
  const int32_t* lab = labels + (size_t)b * H * W;
  const int v = f[y * W + x];
  const int32_t l = lab[y * W + x];
  const bool solid = same_count(f, H, W, y, x) >= kMinSame;
  const bool p_white = v == 255;
  for (int di = 0; di < 2; ++di) {  // dir 0: right pair, dir 1: down pair
    const int dy = di, dx = 1 - di;
    const int ny = y + dy, nx = x + dx;
    const bool in = ny < H && nx < W;
    const int nv = in ? f[ny * W + nx] : 127;
    const int32_t nl = in ? lab[ny * W + nx] : 0;
    const bool nsolid = in && same_count(f, H, W, ny, nx) >= kMinSame;
    const bool edge = (v + nv == 255) && solid && nsolid;
    const size_t o = ((size_t)b * 2 + di) * H * W + (size_t)y * W + x;
    black[o] = edge ? (p_white ? nl : l) : kInvalid;
    white[o] = edge ? (p_white ? l : nl) : kInvalid;
    payload[o] = ((2 * x + dx) & 0x1FFF) | (((2 * y + dy) & 0x1FFF) << 13) |
                 (di << 26) | ((int)p_white << 28);
  }
}

int round_up32(int n) { return (n + 31) / 32 * 32; }

}  // namespace

#define CHECK_LAUNCH()                          \
  do {                                          \
    const cudaError_t e = cudaGetLastError();   \
    if (e != cudaSuccess) return (int)e;        \
  } while (0)

// gray [B, H, W] u8 (H, W multiples of 4, at most 4096) -> black, white,
// payload [B, 2, H, W] int32. Scratch: tile_min, tile_max [B, H/4, W/4] u8,
// tern [B, H, W] u8, bits [B, H, W] u16, lab_a, lab_b [B, H, W] int32.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int chalkydri_ccl_extract(const uint8_t* gray, int B, int H, int W,
                                     int iters, int min_diff,
                                     uint8_t* tile_min, uint8_t* tile_max,
                                     uint8_t* tern, uint16_t* bits,
                                     int32_t* lab_a, int32_t* lab_b,
                                     int32_t* black, int32_t* white,
                                     int32_t* payload, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int n = B * H * W;
  const int grid = (n + kThreads - 1) / kThreads;
  const int ntiles = B * (H / kTile) * (W / kTile);
  tile_minmax_kernel<<<(ntiles + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      gray, B, H, W, tile_min, tile_max);
  CHECK_LAUNCH();
  classify_kernel<<<grid, kThreads, 0, s>>>(gray, tile_min, tile_max, B, H, W,
                                            min_diff, tern);
  CHECK_LAUNCH();
  connectivity_kernel<<<grid, kThreads, 0, s>>>(tern, B, H, W, bits, lab_a);
  CHECK_LAUNCH();
  int32_t* cur = lab_a;
  int32_t* nxt = lab_b;
  const int row_threads = std::min(1024, round_up32(W));
  const int col_threads = std::min(1024, round_up32(H));
  for (int r = 0; r < iters; ++r) {
    neighbor_min_kernel<<<grid, kThreads, 0, s>>>(cur, bits, B, H, W, nxt);
    CHECK_LAUNCH();
    line_min_kernel<<<B * H, row_threads, 2 * W * sizeof(int), s>>>(
        nxt, bits, H, W, 1, 0);
    CHECK_LAUNCH();
    line_min_kernel<<<B * W, col_threads, 2 * H * sizeof(int), s>>>(
        nxt, bits, H, W, 0, 1);
    CHECK_LAUNCH();
    int32_t* t = cur;
    cur = nxt;
    nxt = t;
  }
  extract_kernel<<<grid, kThreads, 0, s>>>(tern, cur, B, H, W, black, white,
                                           payload);
  CHECK_LAUNCH();
  return 0;
}
