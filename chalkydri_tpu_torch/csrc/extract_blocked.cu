// Kernel B7: boundary-candidate extraction over a row band with halo rows.
//
// Replaces chalkydri_tpu/ops/pallas/ccl_kernel.py::
// extract_candidates_blocked_pallas and gives bit-identical output:
// dir-major [B, 2, Hc, W] int32 pages of black label, white label and
// packed payload (x2 | y2 << 13 | dir << 26 | white << 28) for the band's
// Hc core rows, exactly the rows a whole-frame extraction would emit for
// them.
//
// The band arrives EXTENDED: halo_top rows of the band above come first
// and halo_bottom rows of the band below last (the speckle gate reaches one
// row, and a down-edge of the last core row needs the gate of the row
// below it, which reaches two rows down). Halo rows are neighbor context
// only; y_offset, the global row of the first core row, goes into the
// payload. With no halo and y_offset = 0 this is the whole-frame
// extraction.
//
// The TPU kernel cuts the frame into row blocks of at most 500,000 px so
// that a block's stencils fit VMEM, and has the host assemble each block's
// three halo rows. Here a CTA takes a tile of kTileRows core rows x
// kTileCols columns and stages what its stencils read in shared memory:
// the tile's tern bytes with one row above, two below, one column left and
// two right, and its labels with one row below and one column right (with
// 16-byte loads where W % 16 == 0; what lies outside the extended page
// reads as 127, as ccl::emit_candidates reads it). Each thread then takes
// four adjacent pixels of a row, and writes each of the six outputs (three
// pages, two directions) as one 16-byte store where W % 4 == 0, as scalars
// otherwise. The arithmetic is ccl::emit_candidates' (B1 keeps using that
// helper), on the staged tile.
//
// Bound at a [2, 331, 1600] extended band (328 core rows): 5 B/px in, 24
// B/px out, 30.5 MB or about 9.1 us at 3.35 TB/s: bound by the stores. The
// kernel before the tiles (one thread a pixel, up to 27 tern bytes through
// L1, six 4-byte stores) took 17.73 us of device time. Prediction for the
// tiles: 10-15 us; measured: 12.0 us, 76 % of the bound (chip_smoke.py's
// B7 line on an NVIDIA H100 80GB HBM3 at 700 W).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ccl_common.cuh"

namespace {

using ccl::kInvalid;

constexpr int kTileRows = 8;
constexpr int kTileCols = 128;
constexpr int kGroups = kTileCols / 4;  // threads of a row, 4 pixels each
constexpr int kThreads = kTileRows * kGroups;
// Staged tern: rows y - 1 .. y + kTileRows + 1 of the tile's first core
// row y, columns x0 - 1 .. x0 + kTileCols + 1 at [kApron + c].
constexpr int kTernRows = kTileRows + 3;
constexpr int kApron = 16;  // keeps column x0 16-byte aligned
constexpr int kTernPitch = kTileCols + 2 * kApron;
// Staged labels: rows y .. y + kTileRows, columns x0 .. x0 + kTileCols.
constexpr int kLabelRows = kTileRows + 1;
constexpr int kLabelPitch = kTileCols + 4;

// Same-valued 8-neighbors of staged tern position (r, c): ccl::same_count
// on the staged tile, whose positions outside the page hold 127.
__device__ __forceinline__ int same_count(const uint8_t (*st)[kTernPitch],
                                          int r, int c) {
  const int v = st[r][kApron + c];
  int n = 0;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      if (dy || dx) n += st[r + dy][kApron + c + dx] == v;
    }
  }
  return n;
}

// Grid (ceil(W / kTileCols), ceil(Hc / kTileRows), B). kVecLoad: W % 16
// == 0 and the inputs 16-byte aligned; kVecStore: W % 4 == 0 and the
// outputs 16-byte aligned.
template <bool kVecLoad, bool kVecStore>
__global__ void __launch_bounds__(kThreads)
    extract_tile_kernel(const uint8_t* __restrict__ tern,
                        const int32_t* __restrict__ labels, int Hext, int W,
                        int halo_top, int Hc, int y_offset,
                        int32_t* __restrict__ black,
                        int32_t* __restrict__ white,
                        int32_t* __restrict__ payload) {
  __shared__ __align__(16) uint8_t st[kTernRows][kTernPitch];
  __shared__ __align__(16) int32_t sl[kLabelRows][kLabelPitch];
  const int b = blockIdx.z;
  const int yc0 = blockIdx.y * kTileRows;
  const int x0 = blockIdx.x * kTileCols;
  const int ys = halo_top + yc0;  // page row of the tile's first core row
  const uint8_t* f = tern + (size_t)b * Hext * W;
  const int32_t* lab = labels + (size_t)b * Hext * W;

  // -- stage the tile --
  if constexpr (kVecLoad) {
    constexpr int chunks = kTileCols / 16;
    for (int i = threadIdx.x; i < kTernRows * chunks; i += kThreads) {
      const int r = i / chunks, c = 16 * (i % chunks);
      const int y = ys - 1 + r, x = x0 + c;
      uint4 v = make_uint4(0x7F7F7F7Fu, 0x7F7F7F7Fu, 0x7F7F7F7Fu, 0x7F7F7F7Fu);
      if (y >= 0 && y < Hext && x < W)
        v = __ldg((const uint4*)(f + (size_t)y * W + x));
      *(uint4*)&st[r][kApron + c] = v;
    }
    for (int i = threadIdx.x; i < kTernRows * 3; i += kThreads) {
      const int r = i / 3, c = i % 3 == 0 ? -1 : kTileCols + i % 3 - 1;
      const int y = ys - 1 + r, x = x0 + c;
      st[r][kApron + c] = y >= 0 && y < Hext && x >= 0 && x < W
                              ? __ldg(f + (size_t)y * W + x)
                              : (uint8_t)127;
    }
    constexpr int quads = kTileCols / 4;
    for (int i = threadIdx.x; i < kLabelRows * quads; i += kThreads) {
      const int r = i / quads, c = 4 * (i % quads);
      const int y = ys + r, x = x0 + c;
      int4 v = make_int4(0, 0, 0, 0);
      if (y < Hext && x < W) v = __ldg((const int4*)(lab + (size_t)y * W + x));
      *(int4*)&sl[r][c] = v;
    }
    for (int r = threadIdx.x; r < kLabelRows; r += kThreads) {
      const int y = ys + r, x = x0 + kTileCols;
      sl[r][kTileCols] =
          y < Hext && x < W ? __ldg(lab + (size_t)y * W + x) : 0;
    }
  } else {
    constexpr int cols = kTileCols + 3;
    for (int i = threadIdx.x; i < kTernRows * cols; i += kThreads) {
      const int r = i / cols, c = i % cols - 1;
      const int y = ys - 1 + r, x = x0 + c;
      st[r][kApron + c] = y >= 0 && y < Hext && x >= 0 && x < W
                              ? __ldg(f + (size_t)y * W + x)
                              : (uint8_t)127;
    }
    constexpr int lcols = kTileCols + 1;
    for (int i = threadIdx.x; i < kLabelRows * lcols; i += kThreads) {
      const int r = i / lcols, c = i % lcols;
      const int y = ys + r, x = x0 + c;
      sl[r][c] = y < Hext && x < W ? __ldg(lab + (size_t)y * W + x) : 0;
    }
  }
  __syncthreads();

  // -- four adjacent pixels of one core row --
  const int tr = threadIdx.x / kGroups, c0 = 4 * (threadIdx.x % kGroups);
  const int yc = yc0 + tr, x = x0 + c0;
  if (yc >= Hc || x >= W) return;
  const int r = tr + 1;  // the row's staged tern row
  const bool down_in = ys + tr + 1 < Hext;
  const int y2 = 2 * (yc + y_offset);
  bool solid[5], solid_down[4];
#pragma unroll
  for (int j = 0; j < 5; ++j) solid[j] = same_count(st, r, c0 + j) >= ccl::kMinSame;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    solid_down[j] = same_count(st, r + 1, c0 + j) >= ccl::kMinSame;
  int32_t bk[2][4], wh[2][4], pl[2][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = c0 + j;
    const int v = st[r][kApron + c];
    const int32_t l = sl[tr][c];
    const bool p_white = v == 255;
#pragma unroll
    for (int di = 0; di < 2; ++di) {
      const int dy = di, dx = 1 - di;
      const bool in = di ? down_in : x + j + 1 < W;
      const int nv = in ? st[r + dy][kApron + c + dx] : 127;
      const int32_t nl = in ? sl[tr + dy][c + dx] : 0;
      const bool nsolid = in && (di ? solid_down[j] : solid[j + 1]);
      const bool edge = (v + nv == 255) && solid[j] && nsolid;
      bk[di][j] = edge ? (p_white ? nl : l) : kInvalid;
      wh[di][j] = edge ? (p_white ? l : nl) : kInvalid;
      pl[di][j] = ((2 * (x + j) + dx) & 0x1FFF) | (((y2 + dy) & 0x1FFF) << 13) |
                  (di << 26) | ((int)p_white << 28);
    }
  }
  const size_t page = (size_t)b * 2 * Hc * W;
#pragma unroll
  for (int di = 0; di < 2; ++di) {
    const size_t o = page + ((size_t)di * Hc + yc) * W + x;
    if constexpr (kVecStore) {
      *(int4*)(black + o) = make_int4(bk[di][0], bk[di][1], bk[di][2], bk[di][3]);
      *(int4*)(white + o) = make_int4(wh[di][0], wh[di][1], wh[di][2], wh[di][3]);
      *(int4*)(payload + o) =
          make_int4(pl[di][0], pl[di][1], pl[di][2], pl[di][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (x + j < W) {
          black[o + j] = bk[di][j];
          white[o + j] = wh[di][j];
          payload[o + j] = pl[di][j];
        }
      }
    }
  }
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

template <bool kVecLoad, bool kVecStore>
void launch_tiles(const uint8_t* tern, const int32_t* labels, int B, int Hext,
                  int W, int halo_top, int Hc, int y_offset, int32_t* black,
                  int32_t* white, int32_t* payload, cudaStream_t s) {
  const dim3 grid((W + kTileCols - 1) / kTileCols,
                  (Hc + kTileRows - 1) / kTileRows, B);
  extract_tile_kernel<kVecLoad, kVecStore><<<grid, kThreads, 0, s>>>(
      tern, labels, Hext, W, halo_top, Hc, y_offset, black, white, payload);
}

}  // namespace

// tern [B, Hext, W] u8 and labels [B, Hext, W] int32, Hext = halo_top + Hc
// + halo_bottom -> black, white, payload [B, 2, Hc, W] int32, in one
// launch. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int chalkydri_extract_band(const uint8_t* tern,
                                      const int32_t* labels, int B, int Hext,
                                      int W, int halo_top, int halo_bottom,
                                      int y_offset, int32_t* black,
                                      int32_t* white, int32_t* payload,
                                      void* stream) {
  const int Hc = Hext - halo_top - halo_bottom;
  if (B < 1 || Hc < 1 || W < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // The wrapper's pages are 16-byte aligned wherever W % 4 == 0.
  const bool vec_store = W % 4 == 0 && aligned16(black) && aligned16(white) &&
                         aligned16(payload);
  const bool vec_load =
      vec_store && W % 16 == 0 && aligned16(tern) && aligned16(labels);
  if (vec_load)
    launch_tiles<true, true>(tern, labels, B, Hext, W, halo_top, Hc, y_offset,
                             black, white, payload, s);
  else if (vec_store)
    launch_tiles<false, true>(tern, labels, B, Hext, W, halo_top, Hc,
                              y_offset, black, white, payload, s);
  else
    launch_tiles<false, false>(tern, labels, B, Hext, W, halo_top, Hc,
                               y_offset, black, white, payload, s);
  CCL_CHECK_LAUNCH();
  return 0;
}
