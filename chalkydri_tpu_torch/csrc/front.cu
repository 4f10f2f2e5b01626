// Kernels X1-X3: the full-resolution front end's boundary extraction and
// block compaction, detector/cluster.py::extract_and_compact
// (extract_boundary_points, then _compact_blocks) for frames whose 2 * H * W
// candidates exceed the budget, without the dense candidate pages.
//
// They replace no TPU kernel: the JAX package extracts densely (Pallas
// extract_candidates_blocked_pallas, or jnp) and compacts with jnp under
// jit. On this card the plain chain writes three dense [B, 2 * H * W] int32
// pages, copies them into transposed and padded 128-slot pages, and runs
// some seventy full-frame elementwise passes (the speckle gate, both
// directions, the block counts, the boosts), to keep 2 x 512 blocks of 128
// slots a frame. At [2, 1304, 1600] that is ~200 MB moved for 3.1 MB kept.
//
//   X1 front_count_kernel: a CTA a 128 x 128 pixel tile (rows 128 r..,
//      columns 128 c..). It stages the tile's ternary bytes with one row
//      and column before it and two after (127 outside the frame, as the
//      plain neighbor reads do), turns each row into bit masks of its black
//      and of its white pixels (32 pixels a word), works out the speckle
//      gate ("two of eight same-class neighbors" as a carry over the eight
//      shifted masks) and the two pair tests on the masks, and writes the
//      tile's 128 whole direction-1 blocks (row y, column chunk c of the
//      [H, ceil128(W)] page) and 128 whole direction-0 blocks (column x,
//      row chunk r of the transposed [W, ceil128(H)] page) as counts, with
//      plain stores, beside a flag byte for each of its rows and columns
//      (bit d: an edge of direction d in that row or column of the tile).
//      It reads no labels.
//   X2 front_select_kernel: a CTA a (direction, frame). It copies the
//      counts to shared memory, ORs the tiles' flags of each line (column
//      for direction 0, row for direction 1), dilates them by
//      BOOST_DILATE, scores each block count + BOOST_SCORE when the line is
//      boosted and the block occupied, and keeps the top k blocks in the
//      order of rank_blocks' stable descending sort (score descending,
//      then the lower block index). Scores lie in 0..384, so a histogram
//      gives the score T of the last kept block and how many blocks of
//      score T are kept (the first ones by index); a CTA-wide scan over
//      contiguous runs lists the kept blocks in index order; one warp then
//      places each at (blocks of a higher score) + (earlier list entries of
//      its score), a counting sort by score that keeps index order inside
//      a score. No atomics decide an order. It also writes the counts that
//      the kept blocks leave out. X2 takes its counts and flags from any
//      producer that writes them in this layout (see SelectDir).
//   X3 front_emit_kernel: a warp a kept block. It stages the block's strip
//      (its line and the lines on either side, one position beyond each
//      end and two past the last) in shared memory, recomputes the 128
//      slots with ccl::emit_candidates' rule and writes them in kept order
//      into the compacted [B, (k0 + k1) * 128] pages, four slots a lane: an
//      edge gets its black and white labels, a non-edge INT_MAX twice and
//      its position payload, a pad slot (past H in direction 0, past W in
//      direction 1) INT_MAX, INT_MAX and payload 0.
//
// Counts are the plain chain's (black != INT_MAX) where no label of a 0 or
// 255 pixel is INT_MAX, which holds for every CCL labelling of the port
// (INT_MAX marks skip pixels only).
//
// Bound at [2, 1304, 1600] (k = 512 a direction): the ternary image read
// once (4.17 MB), the labels of the kept slots (1.05 MB) and the compacted
// pages written (3.15 MB): ~8.4 MB, ~2.5 us at 3.35 TB/s. Everything else
// (counts, flags, the kept list: ~0.2 MB) stays in L2. Measured there on
// an NVIDIA H100 80GB HBM3 at 700 W: X1 7.9, X2 13.0, X3 4.7 us of device
// time, 26 us in all against 1.72 ms for the plain chain replayed. X2, one
// CTA a (direction, frame), is bound by its chain of dependent phases,
// not by bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ccl_common.cuh"

namespace {

using ccl::kInvalid;
using ccl::kMinSame;

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kBlock = 128;        // slots a block, pixels a tile side
constexpr int kBoostScore = 256;   // cluster.py: BOOST_SCORE
constexpr int kBoostDilate = 2;    // cluster.py: BOOST_DILATE
constexpr int kScoreBins = 416;    // scores 0..384, 13 bins a lane of a warp
constexpr int kBinsPerLane = kScoreBins / 32;
// A line's flag bytes, one a tile it crosses (at most 4096 / 128).
constexpr int kFlagParts = 32;

// Bytes of a frame's block counts: the blocks, rounded up to 16.
__host__ __device__ __forceinline__ int count_pitch(int blocks) {
  return (blocks + 15) / 16 * 16;
}

// ---- X1 --------------------------------------------------------------------

constexpr int kCountThreads = 512;  // 16 warps
constexpr int kApron = 16;          // keeps column x0 16-byte aligned
constexpr int kTernRows = kBlock + 3;            // rows y0 - 1 .. y0 + 129
constexpr int kTernPitch = kBlock + 2 * kApron;  // columns x0 - 16 ..
// Bit masks of a staged row: word w holds columns x0 - 32 + 32 w .. + 31,
// bit i column x0 - 32 + 32 w + i (words 1-4 the tile; of words 0 and 5
// only the bits of columns x0 - 1, x0 + 128 and x0 + 129 are set).
constexpr int kWords = kBlock / 32 + 2;
static_assert(kMinSame == 2, "gate() finds two same-class neighbors");

// Neighbor masks of word w of a row: the left neighbor's bit at each
// column (x - 1), the right neighbor's (x + 1).
__device__ __forceinline__ uint32_t from_left(const uint32_t* row, int w) {
  return (row[w] << 1) | (row[w - 1] >> 31);
}
__device__ __forceinline__ uint32_t from_right(const uint32_t* row, int w) {
  return (row[w] >> 1) | (w + 1 < kWords ? row[w + 1] << 31 : 0u);
}

// Bits 0, 8, 16 and 24 of x (the rest clear) packed into bits 0-3.
__device__ __forceinline__ uint32_t byte_bits(uint32_t x) {
  return (x * 0x01020408u) >> 24;
}

// The bits of word w of staged row r whose pixel of class m has at least
// kMinSame (2) same-class 8-neighbors.
__device__ __forceinline__ uint32_t gate(const uint32_t (*m)[kWords], int r,
                                         int w) {
  const uint32_t n[8] = {m[r - 1][w],          from_left(m[r - 1], w),
                         from_right(m[r - 1], w), from_left(m[r], w),
                         from_right(m[r], w),     m[r + 1][w],
                         from_left(m[r + 1], w), from_right(m[r + 1], w)};
  uint32_t one = 0, two = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    two |= one & n[i];
    one |= n[i];
  }
  return m[r][w] & two;
}

// tern [B, H, W] -> counts0 (block x * R + r of a frame) and counts1
// (block y * C + c), each frame count_pitch(blocks) bytes; flags0
// [B, W, kFlagParts] (byte r of column x) and flags1 [B, H, kFlagParts]
// (byte c of row y); R = ceil(H / 128), C = ceil(W / 128). Grid (C, R,
// B). kVecLoad: W % 16 == 0 and tern 16-byte aligned. The speckle gate
// and the edge tests run on bit masks, 32 pixels an operation: a row's
// black pixels, its white ones (skip pixels and positions outside the
// frame in neither), then the gate's "two of eight neighbors" as a
// carry, then the pair tests.
template <bool kVecLoad>
__global__ void __launch_bounds__(kCountThreads)
    front_count_kernel(const uint8_t* __restrict__ tern, int H, int W,
                       uint8_t* __restrict__ counts0,
                       uint8_t* __restrict__ counts1,
                       uint8_t* __restrict__ flags0,
                       uint8_t* __restrict__ flags1) {
  __shared__ __align__(16) uint8_t st[kTernRows][kTernPitch];
  __shared__ uint32_t black[kTernRows][kWords], white[kTernRows][kWords];
  __shared__ uint32_t solid[kBlock + 1][kWords];  // rows y0 .. y0 + 128
  __shared__ uint32_t right[kBlock][kWords], down[kBlock][kWords];
  __shared__ uint8_t col_edges[4][kBlock], col_down[4][kBlock];
  const int c = blockIdx.x, r = blockIdx.y, b = blockIdx.z;
  const int R = gridDim.y, C = gridDim.x;
  const int x0 = c * kBlock, y0 = r * kBlock;
  const int t = threadIdx.x;
  const uint8_t* f = tern + (size_t)b * H * W;

  // -- stage rows y0 - 1 .. y0 + 129, columns x0 - 1 .. x0 + 129 --
  if constexpr (kVecLoad) {
    constexpr int chunks = kBlock / 16;
    for (int i = t; i < kTernRows * chunks; i += kCountThreads) {
      const int rr = i / chunks, cc = 16 * (i % chunks);
      const int y = y0 - 1 + rr, x = x0 + cc;
      uint4 v = make_uint4(0x7F7F7F7Fu, 0x7F7F7F7Fu, 0x7F7F7F7Fu, 0x7F7F7F7Fu);
      if (y >= 0 && y < H && x < W)
        v = __ldg((const uint4*)(f + (size_t)y * W + x));
      *(uint4*)&st[rr][kApron + cc] = v;
    }
    for (int i = t; i < kTernRows * 3; i += kCountThreads) {
      const int rr = i / 3, cc = i % 3 == 0 ? -1 : kBlock + i % 3 - 1;
      const int y = y0 - 1 + rr, x = x0 + cc;
      st[rr][kApron + cc] = y >= 0 && y < H && x >= 0 && x < W
                                ? __ldg(f + (size_t)y * W + x)
                                : (uint8_t)127;
    }
  } else {
    constexpr int cols = kBlock + 3;
    for (int i = t; i < kTernRows * cols; i += kCountThreads) {
      const int rr = i / cols, cc = i % cols - 1;
      const int y = y0 - 1 + rr, x = x0 + cc;
      st[rr][kApron + cc] = y >= 0 && y < H && x >= 0 && x < W
                                ? __ldg(f + (size_t)y * W + x)
                                : (uint8_t)127;
    }
  }
  __syncthreads();

  // -- class masks: a thread a (row, word) of the tile, from eight 4-byte
  //    words of the staged row (in {0, 127, 255}: black is bit 0 clear,
  //    white bit 7 set) --
  for (int i = t; i < kTernRows * (kWords - 2); i += kCountThreads) {
    const int rr = i / (kWords - 2), w = 1 + i % (kWords - 2);
    const uint4* src = (const uint4*)&st[rr][kApron + 32 * (w - 1)];
    const uint4 lo = src[0], hi = src[1];
    const uint32_t v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    uint32_t k = 0, wh = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      k |= byte_bits(~v[q] & 0x01010101u) << (4 * q);
      wh |= byte_bits((v[q] >> 7) & 0x01010101u) << (4 * q);
    }
    black[rr][w] = k;
    white[rr][w] = wh;
  }
  for (int rr = t; rr < kTernRows; rr += kCountThreads) {
    const int left = st[rr][kApron - 1];
    const int next = st[rr][kApron + kBlock];
    const int next2 = st[rr][kApron + kBlock + 1];
    black[rr][0] = (uint32_t)(left == 0) << 31;
    white[rr][0] = (uint32_t)(left == 255) << 31;
    black[rr][kWords - 1] = (next == 0) | (next2 == 0) << 1;
    white[rr][kWords - 1] = (next == 255) | (next2 == 255) << 1;
  }
  __syncthreads();

  // -- the speckle gate of rows y0 .. y0 + 128, words 1 .. 5 --
  for (int i = t; i < (kBlock + 1) * (kWords - 1); i += kCountThreads) {
    const int rr = i / (kWords - 1), w = 1 + i % (kWords - 1);
    solid[rr][w] = gate(black, rr + 1, w) | gate(white, rr + 1, w);
  }
  __syncthreads();

  // -- edges of rows y0 .. y0 + 127: a black/white pair, both solid --
  // Outside the frame neither mask has a bit, so pad positions count
  // nothing.
  {
    const int rr = t >> 2, w = 1 + (t & 3);
    const uint32_t k = black[rr + 1][w], wh = white[rr + 1][w];
    const uint32_t s = solid[rr][w];
    right[rr][w] = ((k & from_right(white[rr + 1], w)) |
                    (wh & from_right(black[rr + 1], w))) &
                   s & ((solid[rr][w] >> 1) | (solid[rr][w + 1] << 31));
    down[rr][w] = ((k & white[rr + 2][w]) | (wh & black[rr + 2][w])) & s &
                  solid[rr + 1][w];
  }
  __syncthreads();

  // -- column sums: a thread a (column, quarter of the rows) --
  {
    const int cc = t & (kBlock - 1), q = t >> 7, w = 1 + (cc >> 5);
    const int bit = cc & 31;
    int n = 0;
    uint32_t any = 0;
#pragma unroll 8
    for (int rr = 32 * q; rr < 32 * q + 32; ++rr) {
      n += (right[rr][w] >> bit) & 1;
      any |= down[rr][w];
    }
    col_edges[q][cc] = n;
    col_down[q][cc] = (any >> bit) & 1;
  }
  __syncthreads();

  // -- the tile's 128 blocks and flag bytes of each direction --
  if (t < kBlock) {
    const int x = x0 + t;
    if (x < W) {
      const int n = col_edges[0][t] + col_edges[1][t] + col_edges[2][t] +
                    col_edges[3][t];
      const bool d =
          col_down[0][t] | col_down[1][t] | col_down[2][t] | col_down[3][t];
      counts0[(size_t)b * count_pitch(W * R) + x * R + r] = n;
      flags0[((size_t)b * W + x) * kFlagParts + r] = (n > 0) | (d << 1);
    }
  } else if (t < 2 * kBlock) {
    const int rr = t - kBlock, y = y0 + rr;
    if (y < H) {
      int n = 0;
      uint32_t any = 0;
#pragma unroll
      for (int w = 1; w < kWords - 1; ++w) {
        n += __popc(down[rr][w]);
        any |= right[rr][w];
      }
      counts1[(size_t)b * count_pitch(H * C) + y * C + c] = n;
      flags1[((size_t)b * H + y) * kFlagParts + c] =
          (any != 0) | ((n > 0) << 1);
    }
  }
}

// ---- X2 --------------------------------------------------------------------

constexpr int kSelectThreads = 1024;
constexpr int kSelectWarps = kSelectThreads / 32;

// One direction's blocks as a producer leaves them: `lines` lines of
// `per_line` blocks each, block j of line j / per_line; counts u8 (at most
// 128), a frame's count_pitch(lines * per_line) bytes from a 16-byte
// aligned start; flags [B, lines, kFlagParts] u8, of which the first
// `per_line` bytes of a line are read, one a block of the line: bit 0 an
// edge of direction 0 in it, bit 1 one of direction 1. The kept blocks go
// to sel[b, offset ..  offset + keep).
struct SelectDir {
  const uint8_t* counts;
  const uint8_t* flags;
  int lines, per_line, keep, offset;
};

struct SelectArgs {
  SelectDir dir[2];
  int keep_total;          // k0 + k1: sel's row
  int32_t* sel;            // [B, keep_total] block indices, kept order
  int32_t* dropped_part;   // [B, 2] counts left out, by direction
};

// Loads a thread keeps in flight.
constexpr int kLoads = 8;

// Of a word of 4 bytes, those below byte `bytes` (all for 4 or more).
__device__ __forceinline__ uint32_t byte_mask(int bytes) {
  return bytes >= 4 ? ~0u : bytes <= 0 ? 0u : (1u << 8 * bytes) - 1;
}

// The line of block 4 wi + u, where block 4 wi is block at0 of line line0.
__device__ __forceinline__ int line_of(int line0, int at0, int u,
                                       int per_line) {
  return per_line >= 4 ? line0 + (at0 + u >= per_line)
                       : line0 + (at0 + u) / per_line;
}

// (line0, at0) of the next word: 4 blocks on.
__device__ __forceinline__ void next_word(int& line0, int& at0,
                                          int per_line) {
  for (at0 += 4; at0 >= per_line; at0 -= per_line) ++line0;
}

// How many of a word's 4 bytes are not 0.
__device__ __forceinline__ int nonzero_bytes(uint32_t w) {
  return __popc(__vcmpne4(w, 0u)) / 8;
}

// rank_blocks' score of a block: its count, plus BOOST_SCORE where its
// line is boosted and the block occupied.
__device__ __forceinline__ int score(int cnt, bool boosted) {
  return cnt + (cnt > 0 && boosted ? kBoostScore : 0);
}

// Exclusive prefix of v over the CTA's threads in order, and the total.
// Every thread of the CTA calls it.
__device__ __forceinline__ int cta_exclusive_scan(int v, int* warp_sums,
                                                  int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  const int before = (warp ? warp_sums[warp - 1] : 0) + x - v;
  *total = warp_sums[kSelectWarps - 1];
  __syncthreads();  // warp_sums is free again
  return before;
}

// Dynamic shared memory: the counts [count_pitch(n)] u8 (4 a word), then
// hist and above [kScoreBins] int, the kept list (index, score) [keep] int
// each, raw and boost [lines] u8. Most counts are 0 on a frame of tags, so
// every pass takes a word of four counts at once and looks at its bytes
// only where the word is not 0.
__global__ void __launch_bounds__(kSelectThreads)
    front_select_kernel(SelectArgs a) {
  extern __shared__ __align__(16) int32_t sm[];
  __shared__ int warp_sums[kSelectWarps];
  __shared__ int cut_score, cut_take;
  const int d = blockIdx.x, b = blockIdx.y;
  // field by field: a.dir[d] would copy the array to local memory
  const SelectDir& p0 = a.dir[0];
  const SelectDir& p1 = a.dir[1];
  const int lines = d ? p1.lines : p0.lines;
  const int per_line = d ? p1.per_line : p0.per_line;
  const int keep = d ? p1.keep : p0.keep;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned lower = (1u << lane) - 1;
  const int n = lines * per_line, pitch = count_pitch(n);
  const int words = (n + 3) / 4;
  uint32_t* cw = (uint32_t*)sm;
  int* hist = sm + pitch / 4;
  int* above = hist + kScoreBins;  // blocks of a higher score
  int* list_j = above + kScoreBins;
  int* list_s = list_j + keep;
  uint8_t* raw = (uint8_t*)(list_s + keep);
  uint8_t* boost = raw + lines;
  const uint4* counts =
      (const uint4*)((d ? p1.counts : p0.counts) + (size_t)b * pitch);
  const uint8_t* flags =
      (d ? p1.flags : p0.flags) + (size_t)b * lines * kFlagParts;

  // -- the counts to shared memory, 16 a load (the bytes past n cleared),
  //    and each line's first `per_line` flag bytes ORed, in two loads --
  for (int i = t; i < kScoreBins; i += kSelectThreads) hist[i] = 0;
  int total_counts = 0;
#pragma unroll 2
  for (int i = t; i < pitch / 16; i += kSelectThreads) {
    const uint4 v = __ldg(counts + i);
    uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      w[k] &= byte_mask(n - (16 * i + 4 * k));
      total_counts += __dp4a(w[k], 0x01010101u, 0u);
    }
    *(uint4*)&cw[4 * i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  for (int i = t; i < lines; i += kSelectThreads) {
    const uint4* f = (const uint4*)(flags + (size_t)i * kFlagParts);
    const uint4 lo = __ldg(f), hi = __ldg(f + 1);
    const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    uint32_t v = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) v |= w[k] & byte_mask(per_line - 4 * k);
    v |= v >> 16;
    v |= v >> 8;
    raw[i] = v & 3;
  }
  __syncthreads();
  // direction_boosts: the line within BOOST_DILATE of an edge of each
  // direction (lines outside contribute nothing)
  for (int i = t; i < lines; i += kSelectThreads) {
    uint8_t v = 0;
    for (int o = -kBoostDilate; o <= kBoostDilate; ++o) {
      const int j = i + o;
      if (j >= 0 && j < lines) v |= raw[j];
    }
    boost[i] = v == 3;
  }
  __syncthreads();

  // -- the score histogram --
  int zeros = 0;
  for (int wi = t; wi < words; wi += kSelectThreads) {
    const uint32_t w = cw[wi];
    zeros += min(4, n - 4 * wi) - nonzero_bytes(w);  // past n: 0, not valid
    if (w == 0) continue;
    const int line0 = 4 * wi / per_line, at0 = 4 * wi - line0 * per_line;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int cnt = (w >> 8 * u) & 0xFF;
      if (cnt)
        atomicAdd(&hist[score(cnt, boost[line_of(line0, at0, u, per_line)])],
                  1);
    }
  }
  zeros = __reduce_add_sync(kFull, zeros);
  if (lane == 0 && zeros) atomicAdd(&hist[0], zeros);  // counts: no order
  int total = 0;
  cta_exclusive_scan(total_counts, warp_sums, &total);  // also syncs hist

  // -- warp 0: above[s], the cut score T and how many of score T are kept --
  if (warp == 0) {
    int sum = 0;
#pragma unroll
    for (int i = 0; i < kBinsPerLane; ++i) sum += hist[lane * kBinsPerLane + i];
    int suffix = sum;  // this lane's bins and every higher lane's
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_down_sync(kFull, suffix, o);
      if (lane + o < 32) suffix += y;
    }
    int acc = suffix - sum, cut = -1;
    for (int i = kBinsPerLane - 1; i >= 0; --i) {
      const int s = lane * kBinsPerLane + i, h = hist[s];
      above[s] = acc;
      if (cut < 0 && acc + h >= keep) cut = s;  // the highest such score
      acc += h;
    }
    cut = __reduce_max_sync(kFull, cut);
    __syncwarp();
    if (lane == 0) {
      cut_score = cut;
      cut_take = keep - above[cut];
    }
  }
  __syncthreads();
  const int T = cut_score, take = cut_take;

  // -- the kept blocks in index order: every score above T, the first
  //    `take` of score T; a thread a contiguous run of words. A count of
  //    0 scores 0, a tie where T is 0. --
  const int per = (words + kSelectThreads - 1) / kSelectThreads;
  const int w0 = min(words, t * per), w1 = min(words, w0 + per);
  const int line_w0 = 4 * w0 / per_line, at_w0 = 4 * w0 - line_w0 * per_line;
  int ties = 0, higher = 0;
  for (int wi = w0, line0 = line_w0, at0 = at_w0; wi < w1;
       ++wi, next_word(line0, at0, per_line)) {
    const uint32_t w = cw[wi];
    if (T == 0) ties += min(4, n - 4 * wi) - nonzero_bytes(w);
    if (w == 0) continue;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int cnt = (w >> 8 * u) & 0xFF;
      if (!cnt) continue;
      const int s = score(cnt, boost[line_of(line0, at0, u, per_line)]);
      ties += s == T;
      higher += s > T;
    }
  }
  int unused;
  const int ties_before = cta_exclusive_scan(ties, warp_sums, &unused);
  const int kept = higher + max(0, min(ties, take - ties_before));
  int next = cta_exclusive_scan(kept, warp_sums, &unused);
  int kept_counts = 0, tie = ties_before;
  for (int wi = w0, line0 = line_w0, at0 = at_w0; wi < w1;
       ++wi, next_word(line0, at0, per_line)) {
    const uint32_t w = cw[wi];
    if (w == 0 && T > 0) continue;
    const int valid = min(4, n - 4 * wi);
    if (w == 0) {  // T is 0: the first `take` ties of the frame are kept
      for (int u = 0; u < min(valid, take - tie); ++u) {
        list_j[next] = 4 * wi + u;
        list_s[next] = 0;
        ++next;
      }
      tie += valid;
      continue;
    }
    for (int u = 0; u < valid; ++u) {
      const int cnt = (w >> 8 * u) & 0xFF, j = 4 * wi + u;
      const int s =
          cnt ? score(cnt, boost[line_of(line0, at0, u, per_line)]) : 0;
      bool in = s > T;
      if (s == T) in = tie++ < take;
      if (in) {
        list_j[next] = j;
        list_s[next] = s;
        ++next;
        kept_counts += cnt;
      }
    }
  }
  int kept_total = 0;
  cta_exclusive_scan(kept_counts, warp_sums, &kept_total);  // also syncs

  // -- warp 0: counting sort of the list by score, descending; within a
  //    score the list's (index) order --
  if (warp == 0) {
    int32_t* sel =
        a.sel + (size_t)b * a.keep_total + (d ? p1.offset : p0.offset);
    for (int base = 0; base < keep; base += 32) {
      const int i = base + lane;
      const bool valid = i < keep;
      const int s = valid ? list_s[i] : -1;
      const unsigned same = __match_any_sync(kFull, s);
      const int rank = __popc(same & lower);
      if (valid) sel[above[s] + rank] = list_j[i];
      __syncwarp();
      if (valid && rank == 0) above[s] += __popc(same);
      __syncwarp();
    }
    if (lane == 0) a.dropped_part[2 * b + d] = total - kept_total;
  }
}

// ---- X3 --------------------------------------------------------------------

constexpr int kEmitWarps = 8;

struct EmitArgs {
  const uint8_t* tern;      // [B, H, W]
  const int32_t* labels;    // [B, H, W]
  const int32_t* sel;       // [B, k0 + k1]
  const int32_t* dropped_part;  // [B, 2]
  int H, W, R, C, k0, k1;
  int32_t* black;           // [B, (k0 + k1) * 128], each
  int32_t* white;
  int32_t* payload;
  int32_t* dropped;         // [B]
};

// A warp's staged strip: 4 lines of kStrip bytes along its block. Line k,
// position i holds the pixel at along = 128 * chunk - 1 + i, across =
// line0 - 1 + k, where along runs down a column for direction 0 and along
// a row for direction 1: in these coordinates a slot's pair partner is
// always line 2 of its position, and its 8-neighbors a 3 x 3 square.
constexpr int kStrip = kBlock + 3;
constexpr int kStripPitch = kBlock + 4;

// Same-class neighbors of staged position (k, i) of a strip: the 8-neighbor
// count of ccl::same_count, transposed for direction 0.
__device__ __forceinline__ int strip_same(const uint8_t (*st)[kStripPitch],
                                          int k, int i) {
  const int v = st[k][i];
  int n = 0;
#pragma unroll
  for (int dk = -1; dk <= 1; ++dk) {
#pragma unroll
    for (int di = -1; di <= 1; ++di) {
      if (dk || di) n += st[k + dk][i + di] == v;
    }
  }
  return n;
}

// Grid (ceil((k0 + k1) / kEmitWarps), B). Each warp stages its block's
// strip (127 outside the frame, as the plain neighbor reads), then a lane
// takes slots lane, lane + 32, lane + 64, lane + 96: coalesced stores.
__global__ void __launch_bounds__(32 * kEmitWarps)
    front_emit_kernel(EmitArgs a) {
  __shared__ uint8_t strips[kEmitWarps][4][kStripPitch];
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  const int q = blockIdx.x * kEmitWarps + wi;
  const int b = blockIdx.y, K = a.k0 + a.k1, H = a.H, W = a.W;
  if (q >= K) return;
  if (q == 0 && lane == 0)
    a.dropped[b] = a.dropped_part[2 * b] + a.dropped_part[2 * b + 1];
  const int j = __ldg(a.sel + (size_t)b * K + q);
  const int d = q >= a.k0;
  // the block's line (column x for direction 0, row y for 1) and chunk
  const int line = d ? j / a.C : j / a.R, chunk = d ? j % a.C : j % a.R;
  const int along0 = chunk * kBlock, along_n = d ? W : H;
  const int across_n = d ? H : W;
  const uint8_t* f = a.tern + (size_t)b * H * W;
  uint8_t (*st)[kStripPitch] = strips[wi];
  // direction 1: a line's positions side by side; direction 0: the 4
  // lines of a position side by side (one row's 4 bytes). Every load of
  // a lane is issued before the first store.
  constexpr int kPerLane = (4 * kStrip + 31) / 32;
  uint8_t v[kPerLane];
#pragma unroll
  for (int u = 0; u < kPerLane; ++u) {
    const int e = lane + 32 * u;
    const int k = d ? e / kStrip : e % 4, i = d ? e % kStrip : e / 4;
    const int al = along0 - 1 + i, ac = line - 1 + k;
    v[u] = e < 4 * kStrip && al >= 0 && al < along_n && ac >= 0 &&
                   ac < across_n
               ? __ldg(f + (d ? (size_t)ac * W + al : (size_t)al * W + ac))
               : (uint8_t)127;
  }
#pragma unroll
  for (int u = 0; u < kPerLane; ++u) {
    const int e = lane + 32 * u;
    if (e < 4 * kStrip)
      st[d ? e / kStrip : e % 4][d ? e % kStrip : e / 4] = v[u];
  }
  __syncwarp();
  const int32_t* lab = a.labels + (size_t)b * H * W;
  const int dy = d, dx = 1 - d;
  const size_t o = ((size_t)b * K + q) * kBlock;
#pragma unroll
  for (int u = 0; u < kBlock / 32; ++u) {
    const int s = lane + 32 * u, al = along0 + s;
    int32_t bk = kInvalid, wh = kInvalid, pl = 0;
    if (al < along_n) {
      const int x = d ? al : line, y = d ? line : al;
      const int v = st[1][s + 1];
      const bool p_white = v == 255;
      if (v + st[2][s + 1] == 255 && strip_same(st, 1, s + 1) >= kMinSame &&
          strip_same(st, 2, s + 1) >= kMinSame) {
        const int32_t l = __ldg(lab + (size_t)y * W + x);
        const int32_t nl = __ldg(lab + (size_t)(y + dy) * W + x + dx);
        bk = p_white ? nl : l;
        wh = p_white ? l : nl;
      }
      pl = ((2 * x + dx) & 0x1FFF) | (((2 * y + dy) & 0x1FFF) << 13) |
           (d << 26) | ((int)p_white << 28);
    }
    a.black[o + s] = bk;
    a.white[o + s] = wh;
    a.payload[o + s] = pl;
  }
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

size_t select_shared_bytes(const SelectArgs& a) {
  size_t most = 0;
  for (const SelectDir& p : a.dir) {
    const size_t bytes = count_pitch(p.lines * p.per_line) +
                         4 * (2 * (size_t)kScoreBins + 2 * (size_t)p.keep) +
                         2 * (size_t)p.lines;
    most = bytes > most ? bytes : most;
  }
  return most;
}

}  // namespace

// tern [B, H, W] u8 in {0, 127, 255} and labels [B, H, W] int32 ->
// black, white, payload [B, (keep0 + keep1) * 128] int32 and dropped [B]
// int32, in three launches. keep0 and keep1 (each 1 .. its blocks, at most
// 4096): the blocks kept of direction 0 (W * ceil(H / 128) of them) and of
// direction 1 (H * ceil(W / 128)). Scratch, each 16-byte aligned: counts0
// B * count_pitch(W * R) and counts1 B * count_pitch(H * C) bytes, flags0
// [B, W, 32] and flags1 [B, H, 32] u8; sel [B, keep0 + keep1], part [B, 2]
// int32. Returns cudaGetLastError() after the launches (0 on success).
extern "C" int chalkydri_front_extract(
    const uint8_t* tern, const int32_t* labels, int B, int H, int W,
    int keep0, int keep1, uint8_t* counts0, uint8_t* counts1,
    uint8_t* flags0, uint8_t* flags1, int32_t* sel, int32_t* part,
    int32_t* black, int32_t* white, int32_t* payload, int32_t* dropped,
    void* stream) {
  const int R = (H + kBlock - 1) / kBlock, C = (W + kBlock - 1) / kBlock;
  if (B < 1 || B > 65535 || H < 1 || W < 1 || H > 4096 || W > 4096 ||
      keep0 < 1 || keep1 < 1 || keep0 > W * R || keep1 > H * C ||
      keep0 > 4096 || keep1 > 4096)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 tiles(C, R, B);
  if (W % 16 == 0 && aligned16(tern))
    front_count_kernel<true><<<tiles, kCountThreads, 0, s>>>(
        tern, H, W, counts0, counts1, flags0, flags1);
  else
    front_count_kernel<false><<<tiles, kCountThreads, 0, s>>>(
        tern, H, W, counts0, counts1, flags0, flags1);
  CCL_CHECK_LAUNCH();
  SelectArgs sa;
  sa.dir[0] = SelectDir{counts0, flags0, W, R, keep0, 0};
  sa.dir[1] = SelectDir{counts1, flags1, H, C, keep1, keep0};
  sa.keep_total = keep0 + keep1;
  sa.sel = sel;
  sa.dropped_part = part;
  const size_t bytes = select_shared_bytes(sa);  // at most ~175 KB
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        front_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  front_select_kernel<<<dim3(2, B), kSelectThreads, bytes, s>>>(sa);
  CCL_CHECK_LAUNCH();
  EmitArgs ea{tern, labels, sel, part, H, W, R, C, keep0, keep1,
              black, white, payload, dropped};
  front_emit_kernel<<<dim3((keep0 + keep1 + kEmitWarps - 1) / kEmitWarps, B),
                      32 * kEmitWarps, 0, s>>>(ea);
  CCL_CHECK_LAUNCH();
  return 0;
}
