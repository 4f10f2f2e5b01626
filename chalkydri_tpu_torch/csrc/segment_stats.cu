// Kernel B2: run-length segment statistics over a sorted cluster key.
//
// Replaces chalkydri_tpu/ops/pallas/segment_kernel.py::segment_stats_pallas
// and gives bit-identical output. For each frame's sorted (key, payload)
// rows of length n (n % 128 == 0):
//   t[i]        inclusive count of valid direction-0 candidates in [0, i];
//   cand_len/cand_pos  the top-2 runs of every 128-row chunk, a run start
//               scored by its run length (ties to the lowest lane; an
//               all-zero chunk gives lane 0 twice), m1.. then m2.. halves.
// The chunk of 128 is part of the semantics: it decides which runs are
// pre-selected.
//
// Two scans cross chunk and tile boundaries (the prefix count, and the
// next run start after each row), so the work is two launches over tiles
// of 1024 rows, one block per (frame, tile):
//   1. per tile: its direction-0 count and its first run start;
//   2. per tile: the carries from the other tiles' aggregates, the
//      in-tile prefix count and next-start scans, and the chunk top-2.
// What bounds it: it reads 8 B and writes 4 B per row once, plus the tiny
// aggregates; at the main path's 4 x 65536 rows it is launch-latency bound.
// A single persistent pass with decoupled look-back is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kIntMax = 0x7FFFFFFF;
constexpr int kTileN = 1024;  // rows per block = threads per block
constexpr int kWarps = kTileN / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool is_dir0(int32_t payload) {
  return ((payload >> 26) & 0x3) == 0;
}

// Block-wide sum and min of one value per thread, broadcast to all.
__device__ int block_sum(int v, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int r = 0;
  for (int w = 0; w < kWarps; ++w) r += scratch[w];
  __syncthreads();
  return r;
}

__device__ int block_min(int v, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int r = scratch[0];
  for (int w = 1; w < kWarps; ++w) r = min(r, scratch[w]);
  __syncthreads();
  return r;
}

// Inclusive prefix sum over the block's threads in order.
__device__ int block_inclusive_sum(int v, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += t;
  }
  if (lane == 31) scratch[warp] = v;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += scratch[w];
  __syncthreads();
  return before + v;
}

// Min over the threads AFTER this one (ident for the last thread).
__device__ int block_exclusive_suffix_min(int v, int ident, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_down_sync(kFull, v, o);
    if (lane + o < 32) v = min(v, t);
  }
  int after = __shfl_down_sync(kFull, v, 1);
  if (lane == 31) after = ident;
  if (lane == 0) scratch[warp] = v;  // the warp's minimum
  __syncthreads();
  for (int w = warp + 1; w < kWarps; ++w) after = min(after, scratch[w]);
  __syncthreads();
  return after;
}

// Max over the 128 threads of this thread's chunk (4 consecutive warps).
__device__ int chunk_max(int v, int* scratch) {
  const int warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  if ((threadIdx.x & 31) == 0) scratch[warp] = v;
  __syncthreads();
  const int w0 = warp & ~3;
  const int r = max(max(scratch[w0], scratch[w0 + 1]),
                    max(scratch[w0 + 2], scratch[w0 + 3]));
  __syncthreads();
  return r;
}

__global__ void tile_aggregate_kernel(const int32_t* __restrict__ key,
                                      const int32_t* __restrict__ payload,
                                      int n, int ntiles,
                                      int32_t* __restrict__ tile_count,
                                      int32_t* __restrict__ tile_first) {
  __shared__ int scratch[kWarps];
  const int b = blockIdx.x / ntiles, k = blockIdx.x % ntiles;
  const int i = k * kTileN + threadIdx.x;
  const int32_t* kf = key + (size_t)b * n;
  const int32_t* pf = payload + (size_t)b * n;
  int d0 = 0, first = n;
  if (i < n) {
    const int32_t kv = kf[i];
    const int32_t prev = i > 0 ? kf[i - 1] : -1;
    d0 = kv != kIntMax && is_dir0(pf[i]);
    if (kv != prev) first = i;
  }
  const int count = block_sum(d0, scratch);
  const int first_start = block_min(first, scratch);
  if (threadIdx.x == 0) {
    tile_count[blockIdx.x] = count;
    tile_first[blockIdx.x] = first_start;
  }
}

__global__ void segment_stats_kernel(const int32_t* __restrict__ key,
                                     const int32_t* __restrict__ payload,
                                     int n, int ntiles,
                                     const int32_t* __restrict__ tile_count,
                                     const int32_t* __restrict__ tile_first,
                                     int32_t* __restrict__ t,
                                     int32_t* __restrict__ cand_len,
                                     int32_t* __restrict__ cand_pos) {
  __shared__ int scratch[kWarps];
  const int b = blockIdx.x / ntiles, k = blockIdx.x % ntiles;
  const int i = k * kTileN + threadIdx.x;
  const int32_t* kf = key + (size_t)b * n;
  const int32_t* pf = payload + (size_t)b * n;

  // Carries: direction-0 rows before this tile, first run start after it.
  int before = 0, later_start = n;
  for (int q = threadIdx.x; q < ntiles; q += blockDim.x) {
    if (q < k) before += tile_count[b * ntiles + q];
    if (q > k) later_start = min(later_start, tile_first[b * ntiles + q]);
  }
  before = block_sum(before, scratch);
  later_start = block_min(later_start, scratch);

  const bool in = i < n;
  const int32_t kv = in ? kf[i] : kIntMax;
  const int32_t prev = in ? (i > 0 ? kf[i - 1] : -1) : kIntMax;
  const bool start = in && kv != prev;
  const bool valid = in && kv != kIntMax;
  const int d0 = valid && is_dir0(pf[i]);

  const int count = block_inclusive_sum(d0, scratch);
  if (in) t[(size_t)b * n + i] = before + count;

  // Next run start strictly after i, else n; a run start's score is its
  // run length.
  int next_after = block_exclusive_suffix_min(start ? i : n, n, scratch);
  next_after = min(min(next_after, later_start), n);
  const int score = (start && valid) ? next_after - i : 0;

  // Chunk top-2 with ties to the lowest lane: pack (score, 127 - lane).
  const int lane_c = threadIdx.x & 127;
  const int best1 = chunk_max((score << 7) | (127 - lane_c), scratch);
  const int a1 = 127 - (best1 & 127);
  const int score2 = lane_c == a1 ? 0 : score;
  const int best2 = chunk_max((score2 << 7) | (127 - lane_c), scratch);
  const int a2 = 127 - (best2 & 127);
  if (lane_c == 0 && in) {
    const int nc = n / 128, c = i / 128;
    const size_t o = (size_t)b * 2 * nc;
    cand_len[o + c] = best1 >> 7;
    cand_len[o + nc + c] = best2 >> 7;
    cand_pos[o + c] = c * 128 + a1;
    cand_pos[o + nc + c] = c * 128 + a2;
  }
}

}  // namespace

#define CHECK_LAUNCH()                          \
  do {                                          \
    const cudaError_t e = cudaGetLastError();   \
    if (e != cudaSuccess) return (int)e;        \
  } while (0)

// key, payload [B, n] int32 (n % 128 == 0, n < 2^24) -> t [B, n],
// cand_len, cand_pos [B, 2 * n / 128]. Scratch: tile_count, tile_first
// [B, ceil(n / 1024)] int32. Returns cudaGetLastError() (0 on success).
extern "C" int chalkydri_segment_stats(const int32_t* key,
                                       const int32_t* payload, int B, int n,
                                       int32_t* tile_count,
                                       int32_t* tile_first, int32_t* t,
                                       int32_t* cand_len, int32_t* cand_pos,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int ntiles = (n + kTileN - 1) / kTileN;
  tile_aggregate_kernel<<<B * ntiles, kTileN, 0, s>>>(key, payload, n, ntiles,
                                                       tile_count, tile_first);
  CHECK_LAUNCH();
  segment_stats_kernel<<<B * ntiles, kTileN, 0, s>>>(
      key, payload, n, ntiles, tile_count, tile_first, t, cand_len, cand_pos);
  CHECK_LAUNCH();
  return 0;
}
