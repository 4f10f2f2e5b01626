// Kernels B3, B4 and B5: adaptive threshold and connected-component
// labeling, for the full-resolution quad search (quad_decimate = 1).
//
// B3 (chalkydri_threshold, then B4) replaces
//    chalkydri_tpu/ops/pallas/ccl_kernel.py::threshold_ccl_pallas:
//    gray -> (tern, labels after `iters` propagation rounds).
// B4 chalkydri_label_components replaces
//    chalkydri_tpu/ops/pallas/ccl_kernel.py::label_components_pallas:
//    the same rounds from a given tern.
//    Both are the stages of B1 (ccl_common.cuh) without its extraction
//    epilogue, bit-identical to the Pallas kernels; the wrapper of B3
//    launches the threshold stage and then B4. The function's bound at
//    [4, 800, 1280]: 4.1 MB in and 20.5 MB out (B3), 4.1 MB in and 16.4 MB
//    out (B4), at 3.35 TB/s about 7.3 and 6.1 us. What holds the kernels
//    back is the rounds: one int32 label page is 16 MB there, two of them
//    and the connectivity bytes are 37 MB, which neither a block's shared
//    memory nor (together with the caller's pages) the 50 MB L2 holds, so
//    each of a round's two passes streams 37 MB. ccl::label keeps that to
//    the 18 B/px a round needs (fused neighbor-min + row pass, column pass
//    on shared-memory strips, one connectivity byte a pixel) and, like the
//    Pallas loop, ends a frame's rounds at its fixed point: the bench scene
//    runs 6 of its 12.
//
// B5 chalkydri_threshold_ccl_exact replaces
//    chalkydri_tpu/ops/pallas/ccl_kernel.py::threshold_ccl_blocked:
//    threshold + labels at the GLOBAL fixed point, each component labelled
//    ry * wp + rx, where (ry, rx) is its first pixel in raster order and
//    wp = ceil(W / 128) * 128 (a flat index in the lane-padded frame).
//    The TPU splits a 2 M-px frame into row blocks only because its live
//    set exceeds VMEM, then merges the seams until a certified fixed
//    point. Here the fixed point is computed directly, by a union-find in
//    three launches with no host synchronisation, exact for any topology:
//    1. tile_kernel: a CTA of 512 threads a rectangle of 32 x 128 pixels
//       (whole 4x4 threshold tiles; smaller at the frame's right and
//       bottom edges).
//       It stages its gray bytes and a ring of one tile around them in
//       shared memory (cp.async), computes the tile min/max and their 3x3
//       dilation (tiles outside the frame contribute nothing) and
//       classifies into a tern tile in shared memory, stored to the frame
//       with 16-byte stores. A rectangle of skip pixels only stores
//       kInvalid labels. Otherwise a union-find in shared memory over the
//       rectangle, in local indices ly * 128 + lx, whose order is the
//       frame's raster order: row runs from ballots (no atomics), unions
//       with the row above only where a pair of runs first meets, queued
//       per warp and run 32 at a time with path halving, a flatten by path
//       halving (union_find.cuh's pieces, shared with B6). A component that touches no side facing another
//       rectangle is final: its label is stored at once. Every other
//       pixel stores -1 - its local root, and each such root starts the
//       frame's union-find in `parent` (frame-flat indices) as its own
//       parent;
//    2. border_kernel: a thread per pixel of each rectangle's top row and
//       left column; the links that cross the border (up, up-left,
//       up-right and, from the left column, the up-right link of the
//       pixel below-left; the diagonals between whites), only where a
//       pair of runs first meets, join the local roots by the lock-free
//       atomicMin union-find (the larger root under the smaller, so
//       every root is its component's minimum frame-flat index in any
//       order), with path halving;
//    3. resolve_kernel: a CTA a rectangle; each local root named on its
//       open sides walks once to its root (path halving), its label goes
//       to shared memory, and the rectangle's pixels that hold -1 - root
//       take it, with 16-byte loads and stores. A rectangle with nothing
//       on its open sides returns at once.
//    Inside a rectangle a local root is its tile component's minimum
//    frame-flat index, so every final root is the component's minimum:
//    the labels of segment.label_components_exact, bit for bit. The TPU
//    result is the same fixed point wherever its hybrid merge certifies
//    convergence; it can differ only where the TPU stops at its
//    merge_rounds cap on adversarial input.
//    Bound at [2, 1304, 1600]: 4.2 MB in, 20.9 MB out, about 25 MB moved,
//    ~7.5 us at 3.35 TB/s. This design moves those bytes plus, for the
//    rectangles that hold components crossing their sides, one more read
//    and write of their labels and a few scattered parent entries. What
//    holds it back is latency, not bytes: on the deployed scene 36 of the
//    1066 rectangles hold tags, and the kernel lasts as long as one such
//    CTA's chain of dependent shared-memory steps (unions, the flatten's
//    walks, the marks), started behind the waves of skip-only CTAs
//    (clock64 per phase). 32-row rectangles and 512
//    threads a CTA gave the shortest such chain of the shapes tried.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ccl_common.cuh"
#include "union_find.cuh"

// B3's threshold stage. gray [B, H, W] u8 (H, W multiples of 4) -> tern
// [B, H, W] u8 in {0, 127, 255}. Scratch: tile_min, tile_max [B, H/4, W/4]
// u8. Returns cudaGetLastError() after the launches (0 on success).
extern "C" int chalkydri_threshold(const uint8_t* gray, int B, int H, int W,
                                   int min_diff, uint8_t* tile_min,
                                   uint8_t* tile_max, uint8_t* tern,
                                   void* stream) {
  return ccl::threshold(gray, B, H, W, min_diff, tile_min, tile_max, tern,
                        (cudaStream_t)stream);
}

// B4. tern [B, H, W] u8 in {0, 127, 255} (H, W at most 4096) -> labels
// [B, H, W] int32 after `iters` rounds, and in flags[0 .. B) the rounds
// each frame ran before its fixed point stopped it. Scratch: bits
// [B, H, W] u8, scratch [B, H, W] int32, flags [(iters + 1) * B] int32.
extern "C" int chalkydri_label_components(const uint8_t* tern, int B, int H,
                                          int W, int iters, uint8_t* bits,
                                          int32_t* labels, int32_t* scratch,
                                          int32_t* flags, void* stream) {
  return ccl::label(tern, B, H, W, iters, bits, labels, scratch, flags,
                    (cudaStream_t)stream);
}

// ---- B5 --------------------------------------------------------------------

namespace {

using ccl::kInvalid;

// tests/test_torch_b5_tiles.py reads the next two lines.
constexpr int kRows = 32;             // a rectangle's rows (whole tiles)
constexpr int kColShift = 7;          // its columns, 128: the row pitch of
constexpr int kCols = 1 << kColShift;  // its local indices
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPixels = kRows * kCols;
constexpr int kRowChunks = kCols / 32;  // 32-pixel chunks a row
constexpr int kChunks = kPixels / 32;
constexpr int kHalo = ccl::kTile;  // one threshold tile around the rectangle
constexpr int kGrayRows = kRows + 2 * kHalo, kGrayCols = kCols + 2 * kHalo;
constexpr int kTileRows = kRows / ccl::kTile, kTileCols = kCols / ccl::kTile;
constexpr unsigned kFull = 0xffffffffu;

// Rectangle `id` of the batch: frame b, origin (y0, x0), h x w pixels.
struct Rect {
  int b, y0, x0, h, w;
  __device__ Rect(int id, int H, int W) {
    const int nx = (W + kCols - 1) / kCols, ny = (H + kRows - 1) / kRows;
    x0 = id % nx * kCols;
    y0 = id / nx % ny * kRows;
    b = id / (nx * ny);
    h = min(kRows, H - y0);
    w = min(kCols, W - x0);
  }
  // The frame-flat index of local index l = ly * kCols + lx.
  __device__ int flat(int l, int W) const {
    return (y0 + (l >> kColShift)) * W + x0 + (l & (kCols - 1));
  }
  // Pixel k of the sides that face another rectangle (top row, bottom
  // row, left column, right column, k < 2 * (w + h)): false when k's side
  // faces the frame's edge.
  __device__ bool open_side(int k, int H, int W, int& ly, int& lx) const {
    if (k < w) {
      ly = 0, lx = k;
      return y0 > 0;
    }
    if ((k -= w) < w) {
      ly = h - 1, lx = k;
      return y0 + h < H;
    }
    if ((k -= w) < h) {
      ly = k, lx = 0;
      return x0 > 0;
    }
    ly = k - h, lx = w - 1;
    return x0 + w < W;
  }
};

struct TileSmem {
  union {
    int32_t par[kPixels];  // union-find entries, local indices
    uint8_t gray[kGrayRows][kGrayCols];  // until the tern is classified
  };
  uint8_t tern[kPixels];     // pitch kCols; 127 past the rectangle's width
  uint32_t skip[kChunks];    // a chunk's skip pixels
  uint32_t touch[kChunks];   // the roots of components on an open side
  union {
    struct {
      uint8_t mn[kTileRows + 2][kTileCols + 2];  // with the ring around
      uint8_t mx[kTileRows + 2][kTileCols + 2];
      int16_t thr[kTileRows][kTileCols];  // -1: skip
    } t;
    int32_t queue[kWarps][2 * ccl::kUnionQueue];
  };
};

// Launch 1: a CTA a rectangle. kVecTern: 16-byte tern stores (W % 16 == 0,
// tern 16-byte aligned); kWordGray: 4-byte gray loads (gray 4-byte
// aligned). The union-find runs in local indices ly * kCols + lx over the
// shared entries (ccl::SharedPage from 0).
template <bool kVecTern, bool kWordGray>
__global__ void __launch_bounds__(kThreads)
    tile_kernel(const uint8_t* __restrict__ gray, int H, int W, int wp,
                int min_diff, uint8_t* __restrict__ tern,
                int32_t* __restrict__ parent, int32_t* __restrict__ labels) {
  __shared__ __align__(16) TileSmem s;
  const Rect r(blockIdx.x, H, W);
  const size_t frame = (size_t)r.b * H * W;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 0. stage the gray rows y0 - 4 .. y0 + h + 4 and columns x0 - 4 ..
  //    x0 + w + 4 that lie in the frame (all multiples of 4), a word a
  //    thread and step, with asynchronous copies (cp.async) where gray is
  //    4-byte aligned, so that every copy is in flight at once
  {
    const int gy0 = max(r.y0 - kHalo, 0), gy1 = min(r.y0 + r.h + kHalo, H);
    const int gx0 = max(r.x0 - kHalo, 0), gx1 = min(r.x0 + r.w + kHalo, W);
    const int words = (gx1 - gx0) / 4;
    const uint8_t* g = gray + frame;
    for (int k = tid; k < (gy1 - gy0) * words; k += kThreads) {
      const int y = gy0 + k / words, x = gx0 + 4 * (k % words);
      const uint8_t* src = g + (size_t)y * W + x;
      uint8_t* dst = &s.gray[y - r.y0 + kHalo][x - r.x0 + kHalo];
      if constexpr (kWordGray) {
        __pipeline_memcpy_async(dst, src, 4);
      } else {
        *(uint32_t*)dst = __ldg(src) | __ldg(src + 1) << 8 |
                          __ldg(src + 2) << 16 |
                          (uint32_t)__ldg(src + 3) << 24;
      }
    }
    for (int k = tid; k < kChunks; k += kThreads) s.touch[k] = 0;
    if constexpr (kWordGray) {
      __pipeline_commit();
      __pipeline_wait_prior(0);
    }
  }
  __syncthreads();
  // 1. the min and max of the rectangle's tiles and of the ring around
  //    them; a tile outside the frame contributes nothing
  const int th = r.h / ccl::kTile, tw = r.w / ccl::kTile;
  for (int k = tid; k < (th + 2) * (tw + 2); k += kThreads) {
    const int i = k / (tw + 2), j = k % (tw + 2);
    const int ty = r.y0 / ccl::kTile - 1 + i, tx = r.x0 / ccl::kTile - 1 + j;
    unsigned mn = 255, mx = 0;
    if (ty >= 0 && ty < H / ccl::kTile && tx >= 0 && tx < W / ccl::kTile) {
      unsigned lo = 0xffffffffu, hi = 0;
      for (int dy = 0; dy < ccl::kTile; ++dy) {
        const uint32_t v = *(const uint32_t*)&s.gray[4 * i + dy][4 * j];
        lo = __vminu4(lo, v);
        hi = __vmaxu4(hi, v);
      }
      lo = __vminu4(lo, lo >> 16);
      hi = __vmaxu4(hi, hi >> 16);
      mn = min(lo & 0xff, lo >> 8 & 0xff);
      mx = max(hi & 0xff, hi >> 8 & 0xff);
    }
    s.t.mn[i][j] = (uint8_t)mn;
    s.t.mx[i][j] = (uint8_t)mx;
  }
  __syncthreads();
  // 2. each tile's threshold from its 3x3 neighborhood (-1: skip)
  for (int k = tid; k < th * tw; k += kThreads) {
    const int i = k / tw, j = k % tw;
    int mn = 255, mx = 0;
    for (int dy = 0; dy < 3; ++dy) {
      for (int dx = 0; dx < 3; ++dx) {
        mn = min(mn, (int)s.t.mn[i + dy][j + dx]);
        mx = max(mx, (int)s.t.mx[i + dy][j + dx]);
      }
    }
    const int contrast = mx - mn;
    s.t.thr[i][j] = (int16_t)(contrast < min_diff ? -1 : mn + contrast / 2);
  }
  __syncthreads();
  // 3. classify: a thread 16 pixels of a row, into the shared tern tile
  //    (127 past the width) and the frame
  bool busy = false;  // a pixel of this thread's is not skip
  for (int k = tid; k < r.h * (kCols / 16); k += kThreads) {
    const int ly = k / (kCols / 16), lx = 16 * (k % (kCols / 16));
    constexpr uint32_t kSkip4 = 0x7f7f7f7fu;  // four skip pixels
    uint32_t out[4];
    for (int q = 0; q < 4; ++q) {
      const int x = lx + 4 * q;
      out[q] = kSkip4;
      if (x < r.w) {
        const int thr = s.t.thr[ly / ccl::kTile][x / ccl::kTile];
        if (thr >= 0) {
          const uint32_t v = *(const uint32_t*)&s.gray[ly + kHalo][x + kHalo];
          uint32_t o = 0;
          for (int j = 0; j < 4; ++j)
            if ((int)(v >> 8 * j & 0xff) > thr) o |= 0xffu << 8 * j;
          out[q] = o;
        }
      }
    }
    *(uint4*)&s.tern[ly * kCols + lx] = make_uint4(out[0], out[1], out[2],
                                                   out[3]);
    busy |= ((out[0] ^ kSkip4) | (out[1] ^ kSkip4) | (out[2] ^ kSkip4) |
             (out[3] ^ kSkip4)) != 0;
    if (lx < r.w) {
      uint8_t* dst = tern + frame + (size_t)(r.y0 + ly) * W + r.x0 + lx;
      if constexpr (kVecTern) {
        *(uint4*)dst = make_uint4(out[0], out[1], out[2], out[3]);
      } else {
        for (int q = 0; q < 4 && lx + 4 * q < r.w; ++q)
          *(uint32_t*)(dst + 4 * q) = out[q];
      }
    }
  }
  int32_t* lab = labels + frame + (size_t)r.y0 * W + r.x0;
  if (!__syncthreads_or(busy)) {  // all skip: kInvalid, and done
    for (int k = tid; k < r.h * (kCols / 4); k += kThreads) {
      const int ly = k / (kCols / 4), lx = 4 * (k % (kCols / 4));
      if (lx < r.w)
        *(int4*)(lab + (size_t)ly * W + lx) =
            make_int4(kInvalid, kInvalid, kInvalid, kInvalid);
    }
    return;
  }
  // 4. row runs, a warp a row chunk by chunk: every non-skip pixel's entry
  //    is its run's start; skip pixels are runs of their own that nothing
  //    links, and no phase reads their entries
  for (int ly = warp; ly < r.h; ly += kWarps) {
    int carry = 0;
    for (int c = 0; c < kRowChunks; ++c) {
      const int x = 32 * c + lane, i = ly * kCols + x;
      const int v = s.tern[i];
      const bool start = v == 127 || x == 0 || s.tern[i - 1] != v;
      const uint32_t m = __ballot_sync(kFull, start);
      const uint32_t sk = __ballot_sync(kFull, v == 127);
      const uint32_t upto = m & (kFull >> (31 - lane));
      if (v != 127)
        s.par[i] = ly * kCols + (upto ? 32 * c + 31 - __clz(upto) : carry);
      if (m) carry = 32 * c + 31 - __clz(m);
      if (lane == 0) s.skip[ly * kRowChunks + c] = sk;
    }
  }
  __syncthreads();
  // 5. unions with the row above, queued by each warp and run 32 at a
  //    time, one a lane; links that leave the rectangle are
  //    border_kernel's
  const ccl::SharedPage local{s.par, 0};
  {
    ccl::UnionQueue<ccl::SharedPage> unions(local, s.queue[warp]);
    for (int c = kRowChunks + warp; c < r.h * kRowChunks; c += kWarps) {
      if (s.skip[c] == kFull) continue;
      const int i = 32 * c + lane;
      const unsigned links =
          ccl::links_up(s.tern + i, kCols, i & (kCols - 1), r.w);
      unions.push(links & 2u, i, i - kCols);
      unions.push(links & 1u, i, i - kCols - 1);
      unions.push(links & 4u, i, i - kCols + 1);
    }
    unions.drain();
  }
  __syncthreads();
  // 6. flatten: every non-skip entry becomes its root (no halving lowers
  //    it further: the root is the least ancestor)
  for (int c = warp; c < r.h * kRowChunks; c += kWarps) {
    if (!(s.skip[c] >> lane & 1)) {
      const int i = 32 * c + lane;
      s.par[i] = ccl::find_halving(local, i);
    }
  }
  __syncthreads();
  // 7. mark the roots of the components on a side that faces another
  //    rectangle: of the lanes that name one root, one sets its bit (the
  //    pixels of a side mostly name few roots, and atomics on one word
  //    run one after another)
  for (int k0 = 32 * warp; k0 < 2 * (r.w + r.h); k0 += kThreads) {
    int ly, lx, root = -1;
    if (k0 + lane < 2 * (r.w + r.h) && r.open_side(k0 + lane, H, W, ly, lx) &&
        s.tern[ly * kCols + lx] != 127)
      root = s.par[ly * kCols + lx];
    const uint32_t same = __match_any_sync(kFull, root);
    if (root >= 0 && lane == __ffs(same) - 1)
      atomicOr(&s.touch[root >> 5], 1u << (root & 31));
  }
  __syncthreads();
  // 8. labels, 4 pixels a thread (a warp a row): the padded-flat index of
  //    the root for a component inside the rectangle, -1 - root for the
  //    others, whose roots start the frame's union-find as their own
  //    parents
  int32_t* par = parent + frame;
  for (int k = tid; k < r.h * (kCols / 4); k += kThreads) {
    const int ly = k / (kCols / 4), lx = 4 * (k % (kCols / 4));
    if (lx >= r.w) continue;
    int out[4];
    for (int j = 0; j < 4; ++j) {
      const int i = ly * kCols + lx + j;
      out[j] = kInvalid;
      if (s.tern[i] == 127) continue;
      const int root = s.par[i];
      if (s.touch[root >> 5] >> (root & 31) & 1) {
        out[j] = -1 - root;
        if (root == i) {
          const int p = r.flat(i, W);
          par[p] = p;
        }
      } else {
        out[j] = (r.y0 + (root >> kColShift)) * wp + r.x0 +
                 (root & (kCols - 1));
      }
    }
    *(int4*)(lab + (size_t)ly * W + lx) =
        make_int4(out[0], out[1], out[2], out[3]);
  }
}

// Launch 2: a thread per pixel of each rectangle's top row (k < kCols)
// and left column (the rest), where they face another rectangle. Each
// makes the links that cross the border, once a pair of runs (the rules
// of ccl::links_up, with the neighbors inside the rectangle): from the top
// row up, up-left and up-right (always at the last column); from the left
// column left, up-left (below the top row) and the up-right link of the
// pixel below-left (down-left here), which the pixel's left-column left
// link and that pixel's up link imply when the pixel left is white. Each
// link joins the two pixels' local roots, named by their -1 - root labels.
__global__ void border_kernel(const uint8_t* __restrict__ tern,
                              const int32_t* __restrict__ labels, int H,
                              int W, int rects, int32_t* parent) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rects * (kCols + kRows)) return;
  const Rect r(t / (kCols + kRows), H, W);
  int k = t % (kCols + kRows), y, x;
  const bool top = k < kCols;
  if (top) {
    if (k >= r.w || r.y0 == 0) return;
    y = r.y0, x = r.x0 + k;
  } else {
    k -= kCols;
    if (k >= r.h || r.x0 == 0) return;
    y = r.y0 + k, x = r.x0;
  }
  const size_t frame = (size_t)r.b * H * W;
  const uint8_t* f = tern + frame;
  const int32_t* lab = labels + frame;
  const ccl::GlobalPage par{parent + frame};
  const int p = y * W + x;
  const int v = f[p];
  if (v == 127) return;
  // the local root of frame-flat index q: its label holds -1 - (local
  // index in its rectangle)
  auto root = [&](int q) {
    const int l = -1 - lab[q], qy = q / W, qx = q - qy * W;
    return (qy - qy % kRows + (l >> kColShift)) * W + qx - qx % kCols +
           (l & (kCols - 1));
  };
  auto link = [&](int a, int b) { ccl::unite(par, root(a), root(b)); };
  if (top) {
    const bool left = x > r.x0 && f[p - 1] == v;
    const int up_left = x > 0 ? f[p - W - 1] : 127;
    const bool up = f[p - W] == v;
    if (up && !(left && up_left == v)) link(p, p - W);
    if (v == 255) {
      if (!left && up_left == 255) link(p, p - W - 1);
      if (x + 1 < W && f[p - W + 1] == 255 && !(up && x + 1 < r.x0 + r.w))
        link(p, p - W + 1);
    }
  } else {
    const bool left = f[p - 1] == v;
    const bool up = y > r.y0 && f[p - W] == v;
    if (left && !(up && f[p - W - 1] == v)) link(p, p - 1);
    if (v == 255) {
      if (y > r.y0 && !left && f[p - W - 1] == 255) link(p, p - W - 1);
      if (y + 1 < r.y0 + r.h && f[p + W - 1] == 255 && f[p - 1] != 255)
        link(p + W - 1, p);
    }
  }
}

// Launch 3: a CTA a rectangle. Each local root named on its open sides
// walks once to its root, whose padded-flat index goes to shared memory;
// then every pixel that holds -1 - root takes it.
__global__ void __launch_bounds__(kThreads)
    resolve_kernel(int H, int W, int wp, int32_t* parent,
                   int32_t* __restrict__ labels) {
  __shared__ int32_t label_of[kPixels];
  __shared__ uint32_t claimed[kChunks];
  const Rect r(blockIdx.x, H, W);
  const size_t frame = (size_t)r.b * H * W;
  int32_t* lab = labels + frame;
  const ccl::GlobalPage par{parent + frame};
  for (int k = threadIdx.x; k < kChunks; k += kThreads) claimed[k] = 0;
  __syncthreads();
  bool any = false;
  for (int k = threadIdx.x; k < 2 * (r.w + r.h); k += kThreads) {
    int ly, lx;
    if (!r.open_side(k, H, W, ly, lx)) continue;
    const int v = lab[(r.y0 + ly) * W + r.x0 + lx];
    if (v >= 0) continue;  // a skip pixel (kInvalid)
    any = true;
    const int l = -1 - v;
    const uint32_t bit = 1u << (l & 31);
    if (atomicOr(&claimed[l >> 5], bit) & bit) continue;
    const int root = ccl::find_halving(par, r.flat(l, W));
    label_of[l] = root / W * wp + root % W;
  }
  if (!__syncthreads_or(any)) return;
  for (int k = threadIdx.x; k < r.h * (kCols / 4); k += kThreads) {
    const int ly = k / (kCols / 4), lx = 4 * (k % (kCols / 4));
    if (lx >= r.w) continue;
    int4* dst = (int4*)(lab + (r.y0 + ly) * W + r.x0 + lx);
    int4 q = *dst;
    if ((q.x | q.y | q.z | q.w) >= 0) continue;  // nothing to resolve
    if (q.x < 0) q.x = label_of[-1 - q.x];
    if (q.y < 0) q.y = label_of[-1 - q.y];
    if (q.z < 0) q.z = label_of[-1 - q.z];
    if (q.w < 0) q.w = label_of[-1 - q.w];
    *dst = q;
  }
}

template <bool kVecTern>
void launch_tiles(bool word_gray, int rects, const uint8_t* gray, int H,
                  int W, int wp, int min_diff, uint8_t* tern,
                  int32_t* parent, int32_t* labels, cudaStream_t s) {
  if (word_gray)
    tile_kernel<kVecTern, true><<<rects, kThreads, 0, s>>>(
        gray, H, W, wp, min_diff, tern, parent, labels);
  else
    tile_kernel<kVecTern, false><<<rects, kThreads, 0, s>>>(
        gray, H, W, wp, min_diff, tern, parent, labels);
}

}  // namespace

// B5. gray [B, H, W] u8 (H, W multiples of 4, at most 4096) -> tern
// [B, H, W] u8 and labels [B, H, W] int32 (16-byte aligned) at the global
// fixed point, padded-flat with row pitch wp, in three launches. Scratch:
// parent [B, H, W] int32 (only the entries of roots of components that
// cross a rectangle's side are written and read). Returns
// cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue for a shape or alignment the kernels do not take.
extern "C" int chalkydri_threshold_ccl_exact(const uint8_t* gray, int B,
                                             int H, int W, int wp,
                                             int min_diff, uint8_t* tern,
                                             int32_t* parent, int32_t* labels,
                                             void* stream) {
  if (B < 1 || H < ccl::kTile || W < ccl::kTile || H % ccl::kTile ||
      W % ccl::kTile || H > 4096 || W > 4096 || wp < W ||
      (size_t)B * H * W >= (1u << 31) || (uintptr_t)labels % 16 ||
      (uintptr_t)tern % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int rects =
      B * ((H + kRows - 1) / kRows) * ((W + kCols - 1) / kCols);
  const bool word_gray = (uintptr_t)gray % 4 == 0;
  if (W % 16 == 0 && (uintptr_t)tern % 16 == 0)
    launch_tiles<true>(word_gray, rects, gray, H, W, wp, min_diff, tern,
                       parent, labels, s);
  else
    launch_tiles<false>(word_gray, rects, gray, H, W, wp, min_diff, tern,
                        parent, labels, s);
  CCL_CHECK_LAUNCH();
  const int border = rects * (kCols + kRows);
  border_kernel<<<(border + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      tern, labels, H, W, rects, parent);
  CCL_CHECK_LAUNCH();
  resolve_kernel<<<rects, kThreads, 0, s>>>(H, W, wp, parent, labels);
  CCL_CHECK_LAUNCH();
  return 0;
}
