// Kernel B1: adaptive threshold -> connected-component labeling ->
// boundary-candidate extraction, for a batch of decimated grayscale frames.
//
// Replaces chalkydri_tpu/ops/pallas/ccl_kernel.py::threshold_ccl_extract_pallas
// and gives bit-identical output: dir-major [B, 2, H, W] int32 pages of
// black label, white label and packed payload
// (x2 | y2 << 13 | dir << 26 | white << 28).
//
// Two routes, picked by the wrapper from (B, H, W) alone
// (ops/ccl_extract.py::cluster_size):
//
// The cluster route (every frame the detector sends here, up to 540,000
// px): ONE launch. The TPU kernel keeps a whole frame in VMEM and loops its
// rounds inside one call; on Hopper the on-chip counterpart is a thread
// block cluster: one frame per cluster of C CTAs (the most the frame's
// tile rows allow, up to 16, each CTA alone on its SM), CTA k owning a
// band of whole 4-row tile rows and keeping it in shared memory from the
// threshold to the extraction. What bounds it: the rounds are short
// dependent passes over every pixel, so once the labels live in shared
// memory the instructions and latency a pixel costs on the cluster's SMs
// bound them (4 frames x 16 CTAs use 64 of the 132 SMs), the band that
// holds the most non-skip pixels sets every round's pace, and the 24 B/px
// of candidate pages written at the end are the only large traffic. What
// the design does about it:
//   - one 32-bit word a pixel, 4 B/px: label << 11 | solid << 10 |
//     code << 8 | links. The 8 link bits (ccl_common's connectivity byte)
//     and the speckle-gate bit are computed once, after the threshold, so
//     a pass tests bits instead of comparing codes; a separate ternary and
//     connectivity byte (6 B/px) would not fit 16 CTAs for every frame the
//     detector sends (132 x 4088 needs 49,056 px a CTA). The label is the
//     word's top field, so a min over words is a min over labels; a pass
//     keeps a pixel's own low bits;
//   - threshold: tile min/max of the band and of the tile rows just above
//     and below it (read again from the gray frame: 2 tile rows of L2
//     reads and no cluster barrier), 3x3-tile dilation into registers,
//     then classification straight into the words with the initial labels;
//     the link and solid bits after one cluster barrier, with the
//     neighboring bands' rows read through distributed shared memory
//     (DSMEM);
//   - skip pixels link to nothing and keep their words, so a warp whose
//     128 pixels are all skip skips the neighbor-min and the scans, the
//     connect pass skips them, and a band column of skip pixels only takes
//     no part in the column pass (most of a frame's background);
//   - a round, in place: the neighbor-min fused with the row-run min, in
//     waves of rows (a row a group of warps, a thread 4 pixels, run minima
//     by warp shuffles; the left and right neighbors need no term, since
//     they are in the pixel's row run). It reads only the previous round's
//     labels (Jacobi, so the labels stay equal where the 12-round cap
//     binds): each wave stores its last row one wave late, after the next
//     wave, the one that reads it, has read it; the band's top and bottom
//     rows, which the neighboring bands read through DSMEM, are stored only
//     after a cluster barrier. Then the column-run min: each band scans
//     its columns with the chunk logic of ccl_common.cuh::column_min_kernel
//     and publishes per-column head and tail summaries; after a cluster
//     barrier every band reads the other bands' summaries through DSMEM,
//     out to the nearest band where the run that crosses its edge starts
//     (above) or ends (below), most often the next one. Three cluster
//     barriers a round;
//   - a per-band changed flag (double-buffered by round parity) read by
//     every CTA after the next round's first barrier: the loop really
//     exits at the fixed point (rounds run = needed + 1, at most iters);
//   - the extraction epilogue (ccl::emit_candidates' rule) on the band,
//     the row below through DSMEM, 16-byte stores of the three pages; a
//     last cluster barrier keeps every CTA's shared memory alive until its
//     neighbors are done reading it.
// Shared memory: 4 * rows * W + 8 * W + 1024 bytes a CTA, at most 227 KB
// for every frame of the route; the host checks at first use that the card
// can schedule such a cluster.
//
// The chain route (larger frames, only direct callers): launches on the
// caller's stream, the pages in device memory (ccl_common.cuh: threshold,
// connectivity, two launches a round with exit at the fixed point,
// extraction).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ccl_common.cuh"

namespace cg = cooperative_groups;

namespace {

__global__ void extract_kernel(const uint8_t* __restrict__ tern,
                               const int32_t* __restrict__ labels, int B,
                               int H, int W, int32_t* __restrict__ black,
                               int32_t* __restrict__ white,
                               int32_t* __restrict__ payload) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * H * W) return;
  const int x = i % W, y = (i / W) % H, b = i / (H * W);
  const size_t in = (size_t)b * H * W, out = 2 * in;
  ccl::emit_candidates(tern + in, labels + in, H, W, y, x, y, H, y,
                       black + out, white + out, payload + out);
}

// ---- the cluster route ----------------------------------------------------

constexpr int kThreads = 1024;         // a CTA
constexpr int kMaxTilesPerThread = 4;  // 4 * 1024 tiles = 256 KB of words
// A pixel's word: label << 11 | solid << 10 | code << 8 | links. The links
// are ccl_common's connectivity bits (bit k: linked to the neighbor at
// offset k); solid: the speckle gate holds (at least kMinSame same-valued
// 8-neighbors), on a skip pixel in a band's top row instead: its column
// of the band holds only skip pixels; code: 0 black, 1 skip, 2 white. The
// label field holds the flat index (0xFFFFF on skip pixels), so a min over
// words is a min over labels first; a pass keeps its own low bits and
// takes only the label part of a minimum.
constexpr int kLabelShift = 11;
constexpr int32_t kLow = (1 << kLabelShift) - 1;
constexpr int32_t kNoLabel = (1 << 20) - 1;
constexpr int kCodeShift = 8;
constexpr int32_t kSolid = 1 << 10;
constexpr int kBlack = 0, kSkip = 1, kWhite = 2;
// outside the frame: a skip pixel that links to nothing
constexpr int32_t kOutside = (kNoLabel << kLabelShift) | (kSkip << kCodeShift);
constexpr int32_t kNone = 0x7FFFFFFF;  // above every word: min identity
constexpr int32_t kRight = 1, kLeft = 2, kDown = 4, kUp = 8;
constexpr unsigned kFull = 0xffffffffu;
// column summaries and the row pass's warp exchange: a label part, flags
// in the low bits
constexpr int32_t kHasStart = 1, kTopStarts = 2, kHasEnd = 1;
constexpr int kFixedInts = 256;  // 1024 bytes after the words and summaries

__device__ __forceinline__ int code(int32_t w) {
  return (w >> kCodeShift) & 3;
}
__device__ __forceinline__ int32_t label_part(int32_t w) { return w & ~kLow; }

// One band of a frame: rows [y0, y0 + rows) in this CTA's shared memory
// (`words`, [rows][W]), the row above it (the band above's last row) and
// the rows below it (the band below's) through DSMEM; null outside the
// frame.
struct Band {
  int32_t* words;
  const int32_t* above;
  const int32_t* below;
  int rows, W;

  // Row rr of the band, -1 .. rows + 1; null outside the frame.
  __device__ __forceinline__ const int32_t* row(int rr) const {
    if (rr < 0) return above;
    if (rr < rows) return words + (size_t)rr * W;
    return below ? below + (size_t)(rr - rows) * W : nullptr;
  }
};

// The four words at columns x0 .. x0 + 3 of a row, and one word (kOutside
// past the frame or for a null row).
__device__ __forceinline__ int4 load4(const int32_t* p, int x0, int W) {
  if (!p || x0 >= W) return make_int4(kOutside, kOutside, kOutside, kOutside);
  return *reinterpret_cast<const int4*>(p + x0);
}
__device__ __forceinline__ int32_t load1(const int32_t* p, int x, int W) {
  return p && x >= 0 && x < W ? p[x] : kOutside;
}

// Band k of C over th tile rows: tile rows [k * th / C, (k + 1) * th / C).
__device__ __forceinline__ int band_tile0(int k, int th, int C) {
  return (int)((long long)k * th / C);
}

// Phase 1: the band's codes and initial labels, from the gray frame g
// [H, W]. Tile min/max of the band's tile rows and of the one above and
// below it (255 / 0 outside the frame: they contribute nothing) into
// shared memory over the start of `words`, the 3x3-tile dilation into
// registers, a barrier, then every tile's 16 pixels classified into words.
__device__ __forceinline__ void threshold_band(const uint8_t* __restrict__ g,
                                               int H, int W, int tr0,
                                               int tiles_rows, int min_diff,
                                               int32_t* words) {
  const int tw = W / ccl::kTile, th = H / ccl::kTile;
  uint8_t* smin = reinterpret_cast<uint8_t*>(words);
  uint8_t* smax = smin + (tiles_rows + 2) * tw;
  for (int i = threadIdx.x; i < (tiles_rows + 2) * tw; i += kThreads) {
    const int ty = tr0 - 1 + i / tw, tx = i % tw;
    int mn = 255, mx = 0;
    if (ty >= 0 && ty < th) {
      const uint8_t* p = g + (size_t)ty * ccl::kTile * W + tx * ccl::kTile;
#pragma unroll
      for (int dy = 0; dy < ccl::kTile; ++dy) {
        const uint32_t q = *reinterpret_cast<const uint32_t*>(p + dy * W);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int v = (q >> (8 * j)) & 0xff;
          mn = min(mn, v);
          mx = max(mx, v);
        }
      }
    }
    smin[i] = (uint8_t)mn;
    smax[i] = (uint8_t)mx;
  }
  __syncthreads();
  const int ntiles = tiles_rows * tw;
  int dmin[kMaxTilesPerThread], dmax[kMaxTilesPerThread];
#pragma unroll
  for (int s = 0; s < kMaxTilesPerThread; ++s) {
    const int i = threadIdx.x + s * kThreads;
    int mn = 255, mx = 0;
    if (i < ntiles) {
      const int ty = i / tw, tx = i % tw;  // halo tile rows ty .. ty + 2
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
          const int nx = tx + dx;
          if (nx < 0 || nx >= tw) continue;
          mn = min(mn, (int)smin[(ty + dy) * tw + nx]);
          mx = max(mx, (int)smax[(ty + dy) * tw + nx]);
        }
      }
    }
    dmin[s] = mn;
    dmax[s] = mx;
  }
  __syncthreads();  // the tile statistics are overwritten below
#pragma unroll
  for (int s = 0; s < kMaxTilesPerThread; ++s) {
    const int i = threadIdx.x + s * kThreads;
    if (i >= ntiles) break;
    const int ty = i / tw, x0 = (i % tw) * ccl::kTile;
    const int contrast = dmax[s] - dmin[s];
    const int thresh = dmin[s] + contrast / 2;
#pragma unroll
    for (int dy = 0; dy < ccl::kTile; ++dy) {
      const int y = (tr0 + ty) * ccl::kTile + dy;  // frame row
      const uint32_t q =
          *reinterpret_cast<const uint32_t*>(g + (size_t)y * W + x0);
      int32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int v = (q >> (8 * j)) & 0xff;
        const int c = contrast < min_diff ? kSkip : v > thresh ? kWhite : kBlack;
        const int32_t label = c == kSkip ? kNoLabel : y * W + x0 + j;
        w[j] = (label << kLabelShift) | (c << kCodeShift);
      }
      *reinterpret_cast<int4*>(words + (size_t)(ty * ccl::kTile + dy) * W +
                               x0) = make_int4(w[0], w[1], w[2], w[3]);
    }
  }
}

// Volatile (relaxed, race-free) loads and stores of shared words, local or
// through DSMEM: the connect pass rewrites words that other threads read
// at the same time.
__device__ __forceinline__ int32_t load_volatile(const int32_t* p) {
  int32_t v;
  asm volatile("ld.volatile.b32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ int4 load4_volatile(const int32_t* p) {
  int4 v;
  asm volatile("ld.volatile.v4.b32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void store4_volatile(int32_t* p, const int32_t* v) {
  asm volatile("st.volatile.v4.b32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}

// Phase 2, once: every word's links and solid bit, from the codes of its
// 8-neighbors (the neighboring bands' rows through DSMEM). Words are
// updated in place while others read them; only the low bits change, and
// the accesses are volatile, so every read sees the same code.
__device__ __forceinline__ void connect_band(const Band& band) {
  const int W = band.W, quads = W / 4;
  for (int i = threadIdx.x; i < band.rows * quads; i += kThreads) {
    const int rr = i / quads, x0 = (i - rr * quads) * 4;
    // skip pixels keep their words: no links, and no gate is asked of them
    const int4 mine = load4_volatile(band.words + (size_t)rr * W + x0);
    if (code(mine.x) == kSkip && code(mine.y) == kSkip &&
        code(mine.z) == kSkip && code(mine.w) == kSkip)
      continue;
    int cd[3][6];  // codes of rows rr - 1 .. rr + 1, columns x0 - 1 .. x0 + 4
    int32_t own[4];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int32_t* p = band.row(rr - 1 + d);
      int32_t w[6];
      w[0] = p && x0 > 0 ? load_volatile(p + x0 - 1) : kOutside;
      const int4 q = p ? load4_volatile(p + x0)
                       : make_int4(kOutside, kOutside, kOutside, kOutside);
      w[1] = q.x, w[2] = q.y, w[3] = q.z, w[4] = q.w;
      w[5] = p && x0 + 4 < W ? load_volatile(p + x0 + 4) : kOutside;
#pragma unroll
      for (int j = 0; j < 6; ++j) cd[d][j] = code(w[j]);
      if (d == 1) own[0] = q.x, own[1] = q.y, own[2] = q.z, own[3] = q.w;
    }
    int32_t out[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = cd[1][1 + j];
      const bool valid = c != kSkip, white = c == kWhite;
      int bits = 0;
      bits |= (cd[1][2 + j] == c) << 0;           // ( 0, +1)
      bits |= (cd[1][j] == c) << 1;               // ( 0, -1)
      bits |= (cd[2][1 + j] == c) << 2;           // (+1,  0)
      bits |= (cd[0][1 + j] == c) << 3;           // (-1,  0)
      bits |= (white && cd[2][2 + j] == c) << 4;  // (+1, +1)
      bits |= (white && cd[2][j] == c) << 5;      // (+1, -1)
      bits |= (white && cd[0][2 + j] == c) << 6;  // (-1, +1)
      bits |= (white && cd[0][j] == c) << 7;      // (-1, -1)
      if (!valid) bits = 0;
      int same = 0;
#pragma unroll
      for (int d = 0; d < 3; ++d)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          if (d != 1 || dx != 1) same += cd[d][j + dx] == c;
      out[j] = label_part(own[j]) | (same >= ccl::kMinSame ? kSolid : 0) |
               (c << kCodeShift) | bits;
    }
    store4_volatile(band.words + (size_t)rr * W + x0, out);
  }
}

// The extraction epilogue of one band: for every pixel its right and down
// candidates (ccl::emit_candidates' rule, its speckle gate precomputed in
// the solid bits), 4 pixels a thread, 16-byte stores into the frame's
// dir-major [2, H, W] pages.
__device__ __forceinline__ void extract_band(const Band& band, int H, int y0,
                                             int32_t* __restrict__ black,
                                             int32_t* __restrict__ white,
                                             int32_t* __restrict__ payload) {
  const int W = band.W, quads = W / 4;
  for (int i = threadIdx.x; i < band.rows * quads; i += kThreads) {
    const int rr = i / quads, x0 = (i - rr * quads) * 4, y = y0 + rr;
    const int32_t* p = band.row(rr);
    const int4 a = load4(p, x0, W), d = load4(band.row(rr + 1), x0, W);
    const int32_t me[5] = {a.x, a.y, a.z, a.w, load1(p, x0 + 4, W)};
    const int32_t down[4] = {d.x, d.y, d.z, d.w};
    int32_t bl[2][4], wh[2][4], pl[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int x = x0 + j;
      const int32_t w = me[j];
      const bool p_white = code(w) == kWhite;
#pragma unroll
      for (int di = 0; di < 2; ++di) {
        const int dy = di, dx = 1 - di;
        // past the frame the neighbor is kOutside: never an edge
        const int32_t nb = di ? down[j] : me[j + 1];
        const bool edge = (code(w) ^ code(nb)) == (kBlack ^ kWhite) &&
                          (w & nb & kSolid);
        const int32_t l = w >> kLabelShift, nl = nb >> kLabelShift;
        bl[di][j] = edge ? (p_white ? nl : l) : ccl::kInvalid;
        wh[di][j] = edge ? (p_white ? l : nl) : ccl::kInvalid;
        pl[di][j] = ((2 * x + dx) & 0x1FFF) | (((2 * y + dy) & 0x1FFF) << 13) |
                    (di << 26) | ((int)p_white << 28);
      }
    }
#pragma unroll
    for (int di = 0; di < 2; ++di) {
      const size_t o = ((size_t)di * H + y) * W + x0;
      *reinterpret_cast<int4*>(black + o) =
          make_int4(bl[di][0], bl[di][1], bl[di][2], bl[di][3]);
      *reinterpret_cast<int4*>(white + o) =
          make_int4(wh[di][0], wh[di][1], wh[di][2], wh[di][3]);
      *reinterpret_cast<int4*>(payload + o) =
          make_int4(pl[di][0], pl[di][1], pl[di][2], pl[di][3]);
    }
  }
}

// Whether the band's column whose top word is w0 holds only skip pixels.
__device__ __forceinline__ bool quiet_column(int32_t w0) {
  return code(w0) == kSkip && (w0 & kSolid);
}

// The run of column summaries, folded top to bottom: the minimum of the
// run open at the bottom of the bands folded so far.
__device__ __forceinline__ int32_t fold(int32_t carry, int32_t tail) {
  return tail & kHasStart ? label_part(tail) : min(carry, label_part(tail));
}

// One frame per cluster of C = gridDim.x / B CTAs, kThreads each. Dynamic
// shared memory (the same layout in every CTA): words [rows_max][W], the
// column summaries col_tail[W] and col_head[W], then kFixedInts ints: the
// row pass's warp exchange [2 parities][2][32] and the changed flags [2].
__global__ void __launch_bounds__(kThreads, 1)
    cluster_kernel(const uint8_t* __restrict__ gray, int H, int W,
                   int rows_max, int iters, int min_diff,
                   int32_t* __restrict__ black, int32_t* __restrict__ white,
                   int32_t* __restrict__ payload,
                   int32_t* __restrict__ rounds) {
  extern __shared__ __align__(16) int32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), k = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int th = H / ccl::kTile;
  const int tr0 = band_tile0(k, th, C), tr1 = band_tile0(k + 1, th, C);
  const int R = ccl::kTile * (tr1 - tr0), y0 = ccl::kTile * tr0;
  int32_t* words = smem;
  int32_t* col_tail = smem + (size_t)rows_max * W;
  int32_t* col_head = col_tail + W;
  int32_t* xch = col_head + W;  // [2][2][32]
  int32_t* flags = xch + 128;   // [2]

  Band band;
  band.words = words;
  band.rows = R;
  band.W = W;
  band.above = nullptr;
  band.below = nullptr;
  if (k > 0) {
    const int above_rows = tr0 - band_tile0(k - 1, th, C);
    band.above = cluster.map_shared_rank(words, k - 1) +
                 (size_t)(ccl::kTile * above_rows - 1) * W;
  }
  if (k < C - 1) band.below = cluster.map_shared_rank(words, k + 1);

  threshold_band(gray + (size_t)b * H * W, H, W, tr0, tr1 - tr0, min_diff,
                 words);
  cluster.sync();  // every band's codes are out
  connect_band(band);
  __syncthreads();
  // A column of the band that holds only skip pixels takes no part in
  // the column pass: the solid bit of its top word (a skip pixel's is
  // never asked for) marks it.
  for (int c = threadIdx.x; c < W; c += kThreads) {
    bool quiet = true;
    for (int y = 0; y < R && quiet; ++y)
      quiet = code(words[(size_t)y * W + c]) == kSkip;
    volatile int32_t* top_word = words + c;  // the band above reads it
    const int32_t w0 = *top_word;
    if (code(w0) == kSkip) *top_word = (w0 & ~kSolid) | (quiet ? kSolid : 0);
  }

  // The row pass's layout: a row is `rt` threads (whole warps, 4 pixels a
  // thread), a wave G rows.
  const int rt = (W / 4 + 31) / 32 * 32, nw = rt / 32, G = kThreads / rt;
  const int grp = threadIdx.x / rt, x0 = (threadIdx.x - grp * rt) * 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wrow0 = grp * nw;  // the row's first warp

  int r = 0;
  for (;; ++r) {
    cluster.sync();  // the round before is done in every band
    if (r == iters) break;
    if (r > 0) {
      const int any = threadIdx.x < C
          ? *cluster.map_shared_rank(flags + ((r - 1) & 1), (int)threadIdx.x)
          : 0;
      if (!__syncthreads_or(any)) break;  // the fixed point
    }
    bool changed = false;

    // -- neighbor-min + row-run min, in place, in waves ------------------
    int4 top = make_int4(0, 0, 0, 0), bot = top, def = top;
    int def_row = -1;
    for (int a = 0, wave = 0; a < R; a += G, ++wave) {
      const int rr = a + grp;
      const bool active = grp < G && rr < R;  // the same for a whole warp
      int32_t* x_tail = xch + (wave & 1) * 64;
      int32_t* x_head = x_tail + 32;
      int32_t own[4], f[4], g[4];
      bool start[4], end[4];
      unsigned smask = 0, emask = 0;
      int32_t tail = kNone, head = kNone;
      if (active) {
        const int4 q = load4(band.row(rr), x0, W);
        own[0] = q.x, own[1] = q.y, own[2] = q.z, own[3] = q.w;
        bool quiet = true;  // all four are skip pixels (or past the row)
#pragma unroll
        for (int j = 0; j < 4; ++j) quiet &= code(own[j]) == kSkip;
        if (__all_sync(kFull, quiet)) {
          // a skip pixel links to nothing: a run of its own, unchanged
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            f[j] = g[j] = own[j];
            start[j] = end[j] = true;
          }
          smask = emask = kFull;
          tail = own[3];
          head = own[0];
        } else {
          int32_t v[3][6];  // rows rr - 1 .. rr + 1, columns x0 - 1 .. x0 + 4
#pragma unroll
          for (int d = 0; d < 3; d += 2) {
            const int32_t* p = band.row(rr + d - 1);
            const int4 e = load4(p, x0, W);
            v[d][1] = e.x, v[d][2] = e.y, v[d][3] = e.z, v[d][4] = e.w;
            // only the diagonals need columns -1 and 4
            int32_t left = __shfl_up_sync(kFull, v[d][4], 1);
            int32_t right = __shfl_down_sync(kFull, v[d][1], 1);
            if (lane == 0) left = load1(p, x0 - 1, W);
            if (lane == 31) right = load1(p, x0 + 4, W);
            v[d][0] = left;
            v[d][5] = right;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            // the left and right neighbors a pixel links to are in its row
            // run, whose minimum the row pass takes next: they need no term
            const int32_t w = own[j];
            int32_t m = w;
            if (w & 4) m = min(m, v[2][1 + j]);    // (+1,  0)
            if (w & 8) m = min(m, v[0][1 + j]);    // (-1,  0)
            if (w & 16) m = min(m, v[2][2 + j]);   // (+1, +1)
            if (w & 32) m = min(m, v[2][j]);       // (+1, -1)
            if (w & 64) m = min(m, v[0][2 + j]);   // (-1, +1)
            if (w & 128) m = min(m, v[0][j]);      // (-1, -1)
            f[j] = g[j] = m;
            start[j] = !(w & kLeft);
            end[j] = !(w & kRight);
          }
#pragma unroll
          for (int j = 1; j < 4; ++j)
            if (!start[j]) f[j] = min(f[j], f[j - 1]);
#pragma unroll
          for (int j = 2; j >= 0; --j)
            if (!end[j]) g[j] = min(g[j], g[j + 1]);
          smask =
              __ballot_sync(kFull, start[0] | start[1] | start[2] | start[3]);
          emask = __ballot_sync(kFull, end[0] | end[1] | end[2] | end[3]);
          tail = ccl::warp_run_min_up(f[3], smask, lane);
          head = ccl::warp_run_min_down(g[0], emask, lane);
        }
        if (nw > 1) {  // a run open at the warp's edge goes on in the next
          if (lane == 31) x_tail[warp] = label_part(tail) | (smask != 0);
          if (lane == 0) x_head[warp] = label_part(head) | (emask != 0);
        }
      }
      __syncthreads();  // every read of this wave is done
      if (def_row >= 0) {  // the last row of the wave before
        *reinterpret_cast<int4*>(words + (size_t)def_row * W + x0) = def;
        def_row = -1;
      }
      if (active) {
        int32_t from_left = __shfl_up_sync(kFull, tail, 1);
        int32_t from_right = __shfl_down_sync(kFull, head, 1);
        if (lane == 0) from_left = kNone;
        if (lane == 31) from_right = kNone;
        if (nw > 1) {
          if (!(smask & ((1u << lane) - 1u))) {
            for (int w = warp - 1; w >= wrow0; --w) {
              const int32_t t = x_tail[w];
              from_left = min(from_left, label_part(t));
              if (t & 1) break;
            }
          }
          if (!(lane < 31 && (emask >> (lane + 1)))) {
            for (int w = warp + 1; w < wrow0 + nw; ++w) {
              const int32_t h = x_head[w];
              from_right = min(from_right, label_part(h));
              if (h & 1) break;
            }
          }
        }
        int32_t out[4];
        bool open = true;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          open &= !start[j];
          if (open) f[j] = min(f[j], from_left);
        }
        open = true;
#pragma unroll
        for (int j = 3; j >= 0; --j) {
          open &= !end[j];
          if (open) g[j] = min(g[j], from_right);
          out[j] = label_part(min(f[j], g[j])) | (own[j] & kLow);
          changed |= out[j] != own[j];
        }
        const int4 o = make_int4(out[0], out[1], out[2], out[3]);
        if (x0 < W) {
          if (rr == 0) top = o;  // stored after the neighbors read the row
          if (rr == R - 1) bot = o;
          if (rr != 0 && rr != R - 1) {
            if (grp == G - 1) {
              def = o;  // the next wave reads this row
              def_row = rr;
            } else {
              *reinterpret_cast<int4*>(words + (size_t)rr * W + x0) = o;
            }
          }
        }
      }
    }
    cluster.sync();  // the neighbors have read this band's top and bottom
    if (x0 < W && grp < G) {
      if (grp == 0) *reinterpret_cast<int4*>(words + x0) = top;
      if (grp == (R - 1) % G)
        *reinterpret_cast<int4*>(words + (size_t)(R - 1) * W + x0) = bot;
    }
    __syncthreads();

    // -- column-run min: in-band scan, summaries, carries ----------------
#pragma unroll 1
    for (int c = threadIdx.x; c < W; c += kThreads) {
      if (quiet_column(words[c])) {  // skip pixels: each a run of its own
        col_tail[c] = label_part(kOutside) | kHasStart | kTopStarts;
        col_head[c] = label_part(kOutside) | kHasEnd;
        continue;
      }
      int32_t run = kNone, first_end = kNone, w = 0;
      bool starts = false, ends = false, top_starts = false;
      for (int y = 0; y < R; ++y) {
        int32_t* p = words + (size_t)y * W + c;
        w = *p;
        if (!(w & kUp)) {  // a run starts here
          if (y > 0 && !ends) {
            ends = true;
            first_end = run;
          }
          top_starts |= y == 0;
          starts = true;
          run = w;
        } else {
          // a run that holds two labels inside the band will change
          changed |= y > 0 && label_part(w ^ run) != 0;
          run = min(run, w);
        }
        *p = label_part(run) | (w & kLow);
      }
      if (!ends && !(w & kDown)) {
        ends = true;
        first_end = run;
      }
      col_tail[c] = label_part(run) | (starts ? kHasStart : 0) |
                    (top_starts ? kTopStarts : 0);
      col_head[c] = ends ? label_part(first_end) | kHasEnd : 0;
    }
    cluster.sync();  // every band's summaries are out

#pragma unroll 1
    for (int c = threadIdx.x; c < W; c += kThreads) {
      if (quiet_column(words[c])) continue;
      // the minimum of the run that enters from above: back through the
      // bands above up to the nearest that holds a run start (most often
      // the next one)
      int32_t carry_in = kNone;
      for (int j = k - 1; j >= 0; --j) {
        const int32_t t = cluster.map_shared_rank(col_tail, j)[c];
        carry_in = min(carry_in, label_part(t));
        if (t & kHasStart) break;
      }
      // the minimum of the run that leaves below: that of the first band
      // below that holds a run end (most often the next one), with the
      // carry that reaches it
      const int32_t last = words[(size_t)(R - 1) * W + c];
      int32_t out = kNone;
      if (last & kDown) {
        int32_t carry = fold(carry_in, col_tail[c]);
        for (int j = k + 1; j < C; ++j) {
          const int32_t t = cluster.map_shared_rank(col_tail, j)[c];
          const int32_t h = cluster.map_shared_rank(col_head, j)[c];
          if (h & kHasEnd) {
            out = label_part(h);
            if (!(t & kTopStarts)) out = min(out, carry);
            break;
          }
          carry = fold(carry, t);
        }
      }
      // rows above the band's first run start belong to the entering run
      int first_start = 0;
      while (first_start < R &&
             (words[(size_t)first_start * W + c] & kUp))
        ++first_start;
      // backward: every row takes the minimum at its run's end
      int32_t below = 0;
      for (int y = R - 1; y >= 0; --y) {
        int32_t* p = words + (size_t)y * W + c;
        const int32_t in_band = *p;
        int32_t fv = label_part(in_band);
        if (y < first_start) fv = min(fv, carry_in);
        if (!(y == R - 1 ? in_band & kDown : below & kUp)) out = fv;
        // the band's part of the run held one label: did the run?
        changed |= out != label_part(in_band);
        below = in_band;
        *p = out | (in_band & kLow);
      }
    }
    const int any = __syncthreads_or(changed);
    if (threadIdx.x == 0) flags[r & 1] = any;
  }
  if (k == 0 && threadIdx.x == 0) rounds[b] = r;

  const size_t page = (size_t)b * 2 * H * W;
  extract_band(band, H, y0, black + page, white + page, payload + page);
  cluster.sync();  // the neighbors are done reading this band
}

ccl::ClusterCheck g_checks[64];  // the cluster kernel's, per card

}  // namespace

// Shared memory of a CTA of the cluster route (the wrapper's
// ops/ccl_extract.py::cluster_bytes computes the same).
static size_t cluster_bytes(int H, int W, int C) {
  const int th = H / ccl::kTile;
  const int rows_max = ccl::kTile * ((th + C - 1) / C);
  return (size_t)rows_max * W * 4 + (size_t)W * 8 + kFixedInts * 4;
}

// gray [B, H, W] u8 (H, W multiples of 4, H * W < 2^20) -> black, white,
// payload [B, 2, H, W] int32, rounds [B] int32 (the rounds each frame
// ran), in one launch of B clusters of C CTAs (a band of whole tile rows
// each, shared memory at most 227 KB). Returns cudaGetLastError() after
// the launch (0 on success), cudaErrorInvalidValue for a shape the route
// does not take, or -2 when the card cannot schedule such a cluster.
extern "C" int chalkydri_ccl_extract_cluster(
    const uint8_t* gray, int B, int H, int W, int C, int iters, int min_diff,
    int32_t* black, int32_t* white, int32_t* payload, int32_t* rounds,
    void* stream) {
  const int th = H / ccl::kTile, tw = W / ccl::kTile;
  const size_t bytes = cluster_bytes(H, W, C);
  if (C < 1 || C > 16 || C > th || H % 4 || W % 4 || H * W >= kNoLabel ||
      bytes > ccl::kMaxSharedBytes ||
      ((th + C - 1) / C) * tw > kMaxTilesPerThread * kThreads)
    return (int)cudaErrorInvalidValue;
  return ccl::launch_cluster(cluster_kernel, B * C, C, kThreads, bytes,
                             (cudaStream_t)stream, g_checks, gray, H, W,
                             ccl::kTile * ((th + C - 1) / C), iters,
                             min_diff, black, white, payload, rounds);
}

// The chain route: gray [B, H, W] u8 (H, W multiples of 4, at most 4096)
// -> black, white, payload [B, 2, H, W] int32. Scratch: tile_min, tile_max
// [B, H/4, W/4] u8, tern [B, H, W] u8, bits [B, H, W] u8, lab_a, lab_b
// [B, H, W] int32 (the labels end in lab_a), flags [(iters + 1) * B] int32
// (flags[b]: the rounds frame b ran). Returns cudaGetLastError() after the
// launches (0 on success).
extern "C" int chalkydri_ccl_extract(const uint8_t* gray, int B, int H, int W,
                                     int iters, int min_diff,
                                     uint8_t* tile_min, uint8_t* tile_max,
                                     uint8_t* tern, uint8_t* bits,
                                     int32_t* lab_a, int32_t* lab_b,
                                     int32_t* flags, int32_t* black, int32_t* white,
                                     int32_t* payload, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int rc = ccl::threshold(gray, B, H, W, min_diff, tile_min, tile_max, tern, s);
  if (rc) return rc;
  rc = ccl::label(tern, B, H, W, iters, bits, lab_a, lab_b, flags, s);
  if (rc) return rc;
  extract_kernel<<<ccl::blocks_for(B * H * W), ccl::kThreads, 0, s>>>(
      tern, lab_a, B, H, W, black, white, payload);
  CCL_CHECK_LAUNCH();
  return 0;
}
