// Device code shared by the CCL kernels B1 (ccl_extract.cu) and B3-B5
// (threshold_ccl.cu): the adaptive tile threshold, the round-invariant
// connectivity bytes, the capped label-propagation rounds and the
// boundary-candidate extraction of one pixel (whose rule B7,
// extract_blocked.cu, applies to a tile staged in shared memory). The
// stages run as launches on the caller's stream, with no host
// synchronisation.
//
// The rounds (ccl::label) replace the loop of _ccl_from_val in
// chalkydri_tpu/ops/pallas/ccl_kernel.py, which the Pallas kernels
// threshold_ccl_extract_pallas (B1), threshold_ccl_pallas (B3) and
// label_components_pallas (B4) run on a whole frame held in VMEM. Here a
// frame's int32 label page (1 MB at 400x640, 4 MB at 800x1280) is far over
// the 227 KB of shared memory a block can use, so the two ping-pong pages
// and the connectivity bytes live in device memory and the rounds are
// bound by bytes: each pass reads a label page and the bytes and writes a
// page, 9 B/px, twice a round. What the design does about it:
//   - one byte of connectivity a pixel (its bits also mark the run starts
//     and ends, and make the remask needless);
//   - the neighbor-min fused into the row pass: one launch, one page read
//     and one written, run minima by warp shuffles;
//   - the column pass on strips of 8-32 neighboring columns staged in
//     shared memory, so every access to device memory is a whole sector or
//     line of a row, run minima by a chunked scan with carries;
//   - each frame stops at its fixed point, as the Pallas loop does, by
//     round flags on the card: a round's kernels return at once for a
//     frame that the round before left unchanged.
//
// Semantics (bit-identical to chalkydri_tpu's jnp and Pallas versions):
//   threshold  4x4-tile min/max, dilated over the 3x3 tile neighborhood
//              (out-of-frame tiles contribute nothing); skip (127) where
//              the contrast is under min_diff, else 255 above
//              min + (max - min) / 2 and 0 at or below it;
//   CCL        flat-index labels y * W + x (kInvalid on skip pixels), then
//              up to `iters` rounds of neighbor-min over the whole page
//              from the previous round's labels (4-connectivity for every
//              value, diagonals between white pixels only), row-run min,
//              column-run min and remask, ended early only at a fixed
//              point, where more rounds change nothing;
//   extraction an edge is a black/white pair of right or down neighbors
//              whose pixels both have at least kMinSame same-valued
//              8-neighbors (the speckle gate); it emits its black label,
//              its white label and x2 | y2 << 13 | dir << 26 | white << 28.

#pragma once

#include <cuda_pipeline.h>
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

// The connectivity byte of a pixel has bit k set when its neighbor at
// offset k (dy, dx) = (0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1),
// (-1, 1), (-1, -1) has its value; the diagonals connect white pixels
// only. Three of the bits also mark the runs: a pixel starts a row run
// unless it connects to its left neighbor, ends one unless it connects to
// its right neighbor, and starts a column run unless it connects to the
// pixel above. A skip pixel connects to nothing, so it is a run of its own
// and keeps kInvalid through every pass: the remask of the plain version
// needs no bit and no work here.
constexpr unsigned kRightBit = 1u << 0;
constexpr unsigned kLeftBit = 1u << 1;
constexpr unsigned kUpBit = 1u << 3;
constexpr int kColThreads = 256;

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

// The round-invariant connectivity byte of every pixel (bit k: the neighbor
// at offset k has the pixel's value, for the diagonals only between white
// pixels; never set on a skip pixel), the initial flat-index labels, and
// the round flags zeroed. A thread takes 4 neighboring pixels of a row,
// with 4-byte loads of tern and 4- and 16-byte stores when W is a multiple
// of 4 (kVec). Launch with at least B * H * ceil(W / 4) threads.
template <bool kVec>
__global__ void connectivity_kernel(const uint8_t* __restrict__ tern, int B,
                                    int H, int W,
                                    uint8_t* __restrict__ bits,
                                    int32_t* __restrict__ labels,
                                    int32_t* __restrict__ flags, int nflags) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  for (int j = i; j < nflags; j += gridDim.x * blockDim.x) flags[j] = 0;
  const int quads = (W + 3) / 4;
  if (i >= B * H * quads) return;
  const int x0 = (i % quads) * 4, y = (i / quads) % H, b = i / (quads * H);
  const size_t row = ((size_t)b * H + y) * W;

  // t[d][1 + j]: tern at row y + d - 1, column x0 + j, for j = -1 .. 4;
  // 127 outside the frame
  int t[3][6];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const bool in_y = y + d - 1 >= 0 && y + d - 1 < H;
    const uint8_t* p = tern + (in_y ? row + (size_t)((d - 1) * W) : row);
    if (kVec) {
      const uint32_t q =
          in_y ? *reinterpret_cast<const uint32_t*>(p + x0) : 0x7f7f7f7fu;
#pragma unroll
      for (int j = 0; j < 4; ++j) t[d][1 + j] = (q >> (8 * j)) & 0xffu;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        t[d][1 + j] = in_y && x0 + j < W ? p[x0 + j] : 127;
    }
    t[d][0] = in_y && x0 > 0 ? p[x0 - 1] : 127;
    t[d][5] = in_y && x0 + 4 < W ? p[x0 + 4] : 127;
  }
  uint32_t con = 0;
  int32_t lab[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int v = t[1][1 + j];
    const bool valid = v != 127, white = v == 255;
    unsigned bb = 0;
    bb |= (unsigned)(t[1][2 + j] == v) << 0;           // ( 0, +1)
    bb |= (unsigned)(t[1][j] == v) << 1;               // ( 0, -1)
    bb |= (unsigned)(t[2][1 + j] == v) << 2;           // (+1,  0)
    bb |= (unsigned)(t[0][1 + j] == v) << 3;           // (-1,  0)
    bb |= (unsigned)(white && t[2][2 + j] == v) << 4;  // (+1, +1)
    bb |= (unsigned)(white && t[2][j] == v) << 5;      // (+1, -1)
    bb |= (unsigned)(white && t[0][2 + j] == v) << 6;  // (-1, +1)
    bb |= (unsigned)(white && t[0][j] == v) << 7;      // (-1, -1)
    if (!valid) bb = 0;
    con |= bb << (8 * j);
    lab[j] = valid ? y * W + x0 + j : kInvalid;
  }
  if (kVec) {
    *reinterpret_cast<uint32_t*>(bits + row + x0) = con;
    *reinterpret_cast<int4*>(labels + row + x0) =
        make_int4(lab[0], lab[1], lab[2], lab[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (x0 + j < W) {
        bits[row + x0 + j] = (uint8_t)(con >> (8 * j));
        labels[row + x0 + j] = lab[j];
      }
    }
  }
}

constexpr unsigned kFullWarp = 0xffffffffu;

// The round flags, (iters + 1) * B ints zeroed by connectivity_kernel:
// flags[b] counts the rounds frame b ran, and the entry below is set by
// round r's two passes when they change any label of frame b. Every pass
// changes labels only downward, so a round changed nothing exactly when
// neither of its passes did.
__device__ __forceinline__ int32_t& changed_flag(int32_t* flags, int B,
                                                 int round, int b) {
  return flags[B + round * B + b];
}

// Inclusive segmented min-scan over the lanes of a warp, upward: `val`
// is the lane's minimum since its last run start (or over all it holds),
// `starts` the ballot of lanes that hold a run start. Returns the minimum
// since the last run start at or below the lane.
__device__ __forceinline__ int32_t warp_run_min_up(int32_t val,
                                                   unsigned starts, int lane) {
  const unsigned below = starts & (kFullWarp >> (31 - lane));
  const int bound = below ? 31 - __clz(below) : 0;
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t t = __shfl_up_sync(kFullWarp, val, o);
    if (lane - o >= bound) val = min(val, t);
  }
  return val;
}

// The mirror image: `val` is the lane's minimum up to its first run end,
// `ends` the ballot of lanes that hold a run end.
__device__ __forceinline__ int32_t warp_run_min_down(int32_t val,
                                                     unsigned ends, int lane) {
  const unsigned above = ends & (kFullWarp << lane);
  const int bound = above ? __ffs(above) - 1 : 31;
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t t = __shfl_down_sync(kFullWarp, val, o);
    if (lane + o <= bound) val = min(val, t);
  }
  return val;
}

// The neighbor-min and the row pass of one round, fused. One block takes
// one row of one frame, a thread 4 neighboring pixels (16-byte loads and
// stores when W is a multiple of 4, kVec), so blockDim.x =
// round_up32(ceil(W / 4)). It reads rows y - 1, y, y + 1 of the previous
// round's page `src` (the rows above and below are also some other
// block's row, so they come from L2), takes each pixel's minimum over
// itself and its connected neighbors in registers, gives every row run its
// minimum with a forward and a backward segmented min-scan (in the thread,
// then over the warp by shuffles, then over the warps through one
// shared-memory exchange and one __syncthreads; no atomics), and writes the
// row of `dst` once. `src` is only read, so every pixel sees the previous
// round's labels. It returns at once for a frame that the round before
// left unchanged, and sets the round's flag if a label changed.
template <bool kVec>
__global__ void __launch_bounds__(1024)
    neighbor_row_kernel(const int32_t* __restrict__ src,
                        const uint8_t* __restrict__ bits, int B, int H, int W,
                        int round, int32_t* __restrict__ dst,
                        int32_t* __restrict__ flags) {
  // each warp's minimum since its last run start and up to its first run
  // end, and whether it holds one
  __shared__ int32_t warp_tail[32], warp_head[32];
  __shared__ uint8_t warp_starts[32], warp_ends[32];
  const int b = blockIdx.x / H, y = blockIdx.x % H;
  if (round > 0 && !changed_flag(flags, B, round - 1, b)) return;
  if (y == 0 && threadIdx.x == 0) flags[b] = round + 1;
  const size_t row = (size_t)blockIdx.x * W;  // blockIdx.x = b * H + y
  const int x0 = threadIdx.x * 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  // v[d][1 + j]: label at row y + d - 1, column x0 + j, for j = -1 .. 4;
  // kInvalid outside the frame
  int32_t v[3][6];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const bool in_y = y + d - 1 >= 0 && y + d - 1 < H;  // same for the block
    const int32_t* p = src + (in_y ? row + (size_t)((d - 1) * W) : row);
    if (kVec) {
      int4 q = make_int4(kInvalid, kInvalid, kInvalid, kInvalid);
      if (in_y && x0 < W) q = *reinterpret_cast<const int4*>(p + x0);
      v[d][1] = q.x, v[d][2] = q.y, v[d][3] = q.z, v[d][4] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[d][1 + j] = in_y && x0 + j < W ? p[x0 + j] : kInvalid;
    }
    int32_t left = __shfl_up_sync(kFullWarp, v[d][4], 1);
    int32_t right = __shfl_down_sync(kFullWarp, v[d][1], 1);
    if (lane == 0) left = in_y && x0 > 0 && x0 <= W ? p[x0 - 1] : kInvalid;
    if (lane == 31) right = in_y && x0 + 4 < W ? p[x0 + 4] : kInvalid;
    v[d][0] = left;
    v[d][5] = right;
  }
  uint32_t con = 0;  // four connectivity bytes; 0 past the row's end
  if (kVec) {
    if (x0 < W) con = *reinterpret_cast<const uint32_t*>(bits + row + x0);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (x0 + j < W) con |= (uint32_t)bits[row + x0 + j] << (8 * j);
  }

  // Neighbor-min (a set bit implies the neighbor is inside the frame),
  // then the scans inside the thread: f forward from the run start, g
  // backward from the run end.
  int32_t f[4], g[4];
  bool start[4], end[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned bb = con >> (8 * j);
    int32_t m = v[1][1 + j];
    if (bb & 1u) m = min(m, v[1][2 + j]);   // ( 0, +1)
    if (bb & 2u) m = min(m, v[1][j]);       // ( 0, -1)
    if (bb & 4u) m = min(m, v[2][1 + j]);   // (+1,  0)
    if (bb & 8u) m = min(m, v[0][1 + j]);   // (-1,  0)
    if (bb & 16u) m = min(m, v[2][2 + j]);  // (+1, +1)
    if (bb & 32u) m = min(m, v[2][j]);      // (+1, -1)
    if (bb & 64u) m = min(m, v[0][2 + j]);  // (-1, +1)
    if (bb & 128u) m = min(m, v[0][j]);     // (-1, -1)
    f[j] = g[j] = m;
    start[j] = !(bb & kLeftBit);
    end[j] = !(bb & kRightBit);
  }
#pragma unroll
  for (int j = 1; j < 4; ++j)
    if (!start[j]) f[j] = min(f[j], f[j - 1]);
#pragma unroll
  for (int j = 2; j >= 0; --j)
    if (!end[j]) g[j] = min(g[j], g[j + 1]);
  const bool starts = start[0] | start[1] | start[2] | start[3];
  const bool ends = end[0] | end[1] | end[2] | end[3];

  // Over the warp: tail = minimum since the last start at or below this
  // lane, head = minimum up to the first end at or above it.
  const unsigned smask = __ballot_sync(kFullWarp, starts);
  const unsigned emask = __ballot_sync(kFullWarp, ends);
  const int32_t tail = warp_run_min_up(f[3], smask, lane);
  const int32_t head = warp_run_min_down(g[0], emask, lane);
  int32_t from_left = __shfl_up_sync(kFullWarp, tail, 1);
  int32_t from_right = __shfl_down_sync(kFullWarp, head, 1);
  if (lane == 0) from_left = kInvalid;
  if (lane == 31) from_right = kInvalid;

  // Over the warps: a run open at the warp's edge goes on through the
  // neighboring warps up to the first that holds a start (an end).
  if (nwarps > 1) {
    if (lane == 31) warp_tail[warp] = tail, warp_starts[warp] = smask != 0;
    if (lane == 0) warp_head[warp] = head, warp_ends[warp] = emask != 0;
    __syncthreads();
    if (!(smask & ((1u << lane) - 1u))) {
      for (int w = warp - 1; w >= 0; --w) {
        from_left = min(from_left, warp_tail[w]);
        if (warp_starts[w]) break;
      }
    }
    if (!(lane < 31 && (emask >> (lane + 1)))) {
      for (int w = warp + 1; w < nwarps; ++w) {
        from_right = min(from_right, warp_head[w]);
        if (warp_ends[w]) break;
      }
    }
  }

  int32_t out[4];
  bool changed = false;
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
    out[j] = min(f[j], g[j]);
    changed |= out[j] != v[1][1 + j];
  }
  if (kVec) {
    if (x0 < W)
      *reinterpret_cast<int4*>(dst + row + x0) =
          make_int4(out[0], out[1], out[2], out[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (x0 + j < W) dst[row + x0 + j] = out[j];
  }
  if (__any_sync(kFullWarp, changed) && lane == 0)
    changed_flag(flags, B, round, b) = 1;
}

// The column pass, in place. One block takes a strip of C neighboring
// columns of one frame and all H rows: it loads the strip's labels and
// connectivity bytes into shared memory row by row (16 bytes of labels a
// thread with cp.async when W is a multiple of 4, so every row of a
// 32-column strip is one 128-byte line), gives every column run its
// minimum label there, and stores row by row. A column is split into
// kColThreads / C chunks of L rows, one thread each, lanes on neighboring
// columns:
//   1. forward over the chunk: the running minimum since the run start,
//      written in place, and the chunk's summary (has it a run start, the
//      minimum of its open last run);
//   2. the summaries of the chunks above give the minimum that the run
//      entering the chunk carries in;
//   3. the prefix minimum at a run's last row is the run's minimum:
//      backward over the chunk, every row takes the value at its run's end
//      (from the first run end in the chunks below where its run leaves
//      the chunk) and goes to device memory.
// No atomics. Dynamic shared memory: 5 * H * C bytes. It returns at once
// for a frame that the round before left unchanged, and sets the round's
// flag if a label changed.
template <int C>
__global__ void __launch_bounds__(kColThreads)
    column_min_kernel(int32_t* __restrict__ labels,
                      const uint8_t* __restrict__ bits, int B, int H, int W,
                      int L, int round, int32_t* __restrict__ flags) {
  extern __shared__ __align__(16) unsigned char strip[];
  int32_t* lab = reinterpret_cast<int32_t*>(strip);        // [H][C]
  uint8_t* con = strip + (size_t)H * C * sizeof(int32_t);  // [H][C]
  constexpr int K = kColThreads / C;
  // by thread: the minimum of the chunk's open last run and whether the
  // chunk holds a run start; the value at its first run end and whether
  // it holds one
  __shared__ int32_t open_min[kColThreads], end_min[kColThreads];
  __shared__ uint8_t has_start[kColThreads], has_end[kColThreads];

  const int strips = (W + C - 1) / C;
  const int b = blockIdx.x / strips, x0 = (blockIdx.x % strips) * C;
  if (round > 0 && !changed_flag(flags, B, round - 1, b)) return;
  const size_t base = (size_t)b * H * W + x0;
  const int tid = threadIdx.x;

  if (W % 4 == 0) {  // rows and strips start on 16-byte boundaries
    constexpr int Q = C / 4;
    for (int q = tid; q < H * Q; q += kColThreads) {
      const int r = q / Q, c = (q % Q) * 4;
      if (x0 + c < W) {
        const size_t g = base + (size_t)r * W + c;
        __pipeline_memcpy_async(lab + r * C + c, labels + g, 16);
        __pipeline_memcpy_async(con + r * C + c, bits + g, 4);
      } else {  // past the frame's last column: runs of their own
        for (int j = 0; j < 4; ++j) lab[r * C + c + j] = kInvalid;
        *reinterpret_cast<uint32_t*>(con + r * C + c) = 0;
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
  } else {
    for (int q = tid; q < H * C; q += kColThreads) {
      const int r = q / C, c = q % C;
      const bool in = x0 + c < W;
      const size_t g = base + (size_t)r * W + c;
      lab[q] = in ? labels[g] : kInvalid;
      con[q] = in ? bits[g] : 0;
    }
  }
  __syncthreads();

  const int c = tid % C, k = tid / C;
  const int r0 = min(k * L, H), r1 = min(r0 + L, H);
  int32_t run = kInvalid, first_end = kInvalid;
  bool starts = false, ends = false, changed = false;
  int first_start = r1;
  for (int r = r0; r < r1; ++r) {
    const int32_t v = lab[r * C + c];
    if (!(con[r * C + c] & kUpBit)) {  // a run starts here
      if (r > r0 && !ends) {
        ends = true;
        first_end = run;
      }
      if (!starts) {
        starts = true;
        first_start = r;
      }
      run = v;
    } else {
      // a run that holds two values inside the chunk will change
      changed |= r > r0 && v != run;
      run = min(run, v);
    }
    lab[r * C + c] = run;
  }
  if (r1 > r0 && !ends && (r1 == H || !(con[r1 * C + c] & kUpBit))) {
    ends = true;
    first_end = run;
  }
  open_min[tid] = run;
  has_start[tid] = starts;
  __syncthreads();

  int32_t carry_in = kInvalid;  // minimum of the run that enters from above
  for (int j = 0; j < k; ++j) {
    const int32_t t = open_min[j * C + c];
    carry_in = has_start[j * C + c] ? t : min(carry_in, t);
  }
  // the first run end lies in the entering run unless row r0 starts a run
  if (ends && first_start != r0) first_end = min(first_end, carry_in);
  end_min[tid] = first_end;
  has_end[tid] = ends;
  __syncthreads();

  int32_t out = kInvalid;  // minimum of the run that leaves the chunk below
  for (int j = k + 1; j < K; ++j) {
    if (has_end[j * C + c]) {
      out = end_min[j * C + c];
      break;
    }
  }
  if (x0 + c < W) {
    for (int r = r1 - 1; r >= r0; --r) {
      const int32_t in_chunk = lab[r * C + c];
      int32_t f = in_chunk;
      if (r < first_start) f = min(f, carry_in);
      if (r == H - 1 || !(con[(r + 1) * C + c] & kUpBit)) out = f;
      // the chunk's part of the run held one value: did the run?
      changed |= out != in_chunk;
      labels[base + (size_t)r * W + c] = out;
    }
  }
  if (__any_sync(kFullWarp, changed) && (tid & 31) == 0)
    changed_flag(flags, B, round, b) = 1;
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

// Shared memory a block may ask for on sm_90 (227 KB).
constexpr size_t kMaxSharedBytes = 232448;

// A cluster kernel's record on one card: its attributes set, and for each
// cluster size the most shared memory a CTA already checked to schedule.
struct ClusterCheck {
  bool attributes = false;
  int checked_bytes[17] = {};
};

// Launches `kernel` on `grid` CTAs of `threads` threads, in clusters of C
// (1-16) CTAs with `bytes` of dynamic shared memory each, on stream s. At
// its first use on a card the kernel may ask for kMaxSharedBytes and for
// clusters over the portable 8; the first use of a larger `bytes` at a C
// asks cudaOccupancyMaxActiveClusters whether one such cluster can be
// scheduled. `checks` is the kernel's record for each of 64 cards. Returns
// cudaGetLastError() after the launch (0 on success), the occupancy
// query's error, or -2 when the card cannot schedule such a cluster.
template <typename... Params, typename... Args>
inline int launch_cluster(void (*kernel)(Params...), int grid, int C,
                          int threads, size_t bytes, cudaStream_t s,
                          ClusterCheck* checks, Args... args) {
  if (C < 1 || C > 16 || bytes > kMaxSharedBytes)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaGetDevice(&dev);
  ClusterCheck& check = checks[dev % 64];
  if (!check.attributes) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)kMaxSharedBytes);
    cudaFuncSetAttribute(kernel,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    CCL_CHECK_LAUNCH();
    check.attributes = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((int)bytes > check.checked_bytes[C]) {
    int clusters = 0;
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (clusters < 1) return -2;
    check.checked_bytes[C] = (int)bytes;
  }
  cudaLaunchKernelEx(&cfg, kernel, args...);
  return (int)cudaGetLastError();
}

// Bytes of the column pass's strip of C columns.
inline size_t strip_bytes(int H, int C) { return (size_t)H * C * 5; }

// The widest strip (32 columns: a 128-byte line per row) that fits shared
// memory (beside the kernel's 2.5 KB of chunk summaries) and still gives
// every SM two blocks; 8 columns (one 32-byte sector per row) otherwise:
// 16 at [4, 800, 1280], 8 at [4, 400, 640], 8 for 4096 rows (160 KB).
inline int strip_columns(int B, int H, int W) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  for (int c = 32; c > 8; c /= 2) {
    if (strip_bytes(H, c) <= kMaxSharedBytes - 4096 &&
        B * ((W + c - 1) / c) >= 2 * sms)
      return c;
  }
  return 8;
}

template <int C>
inline int column_pass(int32_t* labels, const uint8_t* bits, int B, int H,
                       int W, int round, int32_t* flags, cudaStream_t s) {
  const size_t bytes = strip_bytes(H, C);
  if (round == 0 && bytes > 48 * 1024) {
    // above 48 KB shared memory is asked for per kernel and card; an H
    // that does not fit comes back as the error code
    const cudaError_t e = cudaFuncSetAttribute(
        column_min_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  // Rows per thread; with C < 32 a warp spans 32 / C chunks of a column,
  // which fall on distinct shared-memory banks when L * C = C (mod 32).
  constexpr int K = kColThreads / C;
  int L = (H + K - 1) / K;
  while (C < 32 && L % (32 / C) != 1) ++L;
  const int strips = (W + C - 1) / C;
  column_min_kernel<C><<<B * strips, kColThreads, bytes, s>>>(
      labels, bits, B, H, W, L, round, flags);
  CCL_CHECK_LAUNCH();
  return 0;
}

// tern [B, H, W] u8 -> labels [B, H, W] int32 after `iters` propagation
// rounds, with bits [B, H, W] u8, one more label page `scratch` and
// flags [(iters + 1) * B] int32 as work space; flags[b] leaves as the
// number of rounds frame b ran.
//
// A round is two launches: the fused neighbor-min + row pass reads one
// page and writes the other, the column pass works on that one in place.
// The first page is picked so that round `iters` lands in `labels`. A
// frame stops at its fixed point without a host read: the kernels of round
// r return at once for a frame whose round r - 1 changed nothing. That
// confirming round read one page and wrote the same labels into the other,
// so from then on both pages hold the result and `labels` is right
// whichever page the frame stopped on.
inline int label(const uint8_t* tern, int B, int H, int W, int iters,
                 uint8_t* bits, int32_t* labels, int32_t* scratch,
                 int32_t* flags, cudaStream_t s) {
  int32_t* cur = iters % 2 == 0 ? labels : scratch;
  int32_t* nxt = iters % 2 == 0 ? scratch : labels;
  const bool vec = W % 4 == 0;
  const int quads = B * H * ((W + 3) / 4);
  if (vec) {
    connectivity_kernel<true><<<blocks_for(quads), kThreads, 0, s>>>(
        tern, B, H, W, bits, cur, flags, (iters + 1) * B);
  } else {
    connectivity_kernel<false><<<blocks_for(quads), kThreads, 0, s>>>(
        tern, B, H, W, bits, cur, flags, (iters + 1) * B);
  }
  CCL_CHECK_LAUNCH();
  const int row_threads = round_up32((W + 3) / 4);
  const int cols = strip_columns(B, H, W);
  for (int r = 0; r < iters; ++r) {
    if (vec) {
      neighbor_row_kernel<true><<<B * H, row_threads, 0, s>>>(
          cur, bits, B, H, W, r, nxt, flags);
    } else {
      neighbor_row_kernel<false><<<B * H, row_threads, 0, s>>>(
          cur, bits, B, H, W, r, nxt, flags);
    }
    CCL_CHECK_LAUNCH();
    const int rc =
        cols == 32   ? column_pass<32>(nxt, bits, B, H, W, r, flags, s)
        : cols == 16 ? column_pass<16>(nxt, bits, B, H, W, r, flags, s)
                     : column_pass<8>(nxt, bits, B, H, W, r, flags, s);
    if (rc) return rc;
    int32_t* t = cur;
    cur = nxt;
    nxt = t;
  }
  return 0;
}

}  // namespace
}  // namespace ccl
