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
// What bounds it: by bytes it reads 8 B and writes 4 B a row once, plus
// 16 B a chunk; at the main path's 4 x 65536 rows that is 3.2 MB, about
// 1 us of memory time, so a launch, a barrier and a round trip to L2 each
// weigh as much as the work. The design takes one launch and as few block
// barriers as it can:
//   - a block of 256 threads takes a tile of 1024 rows, a thread 4 rows
//     with 16-byte loads of key and payload and a 16-byte store of t;
//   - a warp owns one 128-row chunk, so the chunk top-2 is two warp
//     max-reductions by shuffles (score << 7 | 127 - row: ties to the
//     lowest row), no block barrier;
//   - t is the tile's block scan plus the count before the tile, found by
//     a decoupled look-back over the tiles' status words (one warp reads
//     32 predecessors at a time);
//   - a run's length needs the next run start after it: inside the tile
//     by ballots over the warp and one exchange through shared memory;
//     for the tile's last run a forward scan from the tile's end, 128 keys
//     a step with ballots, bounded by that run's length. Only a valid run
//     that starts in the tile is scanned (invalid runs score 0), so the
//     INT_MAX tail is never read twice.
// Two block barriers in all. The status words need no memset launch: each
// carries the call's sequence number in its top bits, and a word of an
// older call reads as "not ready". The sequence number is an epoch counter
// on the card that the last block of a call advances, so a replay of a
// captured CUDA graph gets a fresh one too.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kIntMax = 0x7FFFFFFF;
constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr int kTileN = kThreads * kRowsPerThread;  // 1024 rows a block
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Status word of a tile: seq (30 bits) << 34 | state (2 bits) << 32 |
// value (32 bits). State 1: the tile's own count; state 2: the inclusive
// count up to the tile's end. Any other sequence number reads as state 0.
constexpr unsigned long long kAggregate = 1ull, kPrefix = 2ull;
constexpr unsigned kSeqMask = (1u << 30) - 1u;

__device__ __forceinline__ unsigned long long load_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long status_word(
    unsigned seq, unsigned long long state, int value) {
  return ((unsigned long long)seq << 34) | (state << 32) | (unsigned)value;
}

__device__ __forceinline__ bool is_dir0(int32_t payload) {
  return ((payload >> 26) & 0x3) == 0;
}

// The first row index >= from whose key differs from `key` (a run start,
// for rows sorted or not, since every row between equals `key`), else n.
// The whole warp calls it; 128 rows a step.
__device__ int next_start_from(const int32_t* __restrict__ kf, int from,
                               int n, int32_t key, int lane) {
  for (int base = from; base < n; base += 32 * kRowsPerThread) {
    const int r = base + lane * kRowsPerThread;
    int hit = kRowsPerThread;
    if (r < n) {
      const int4 k = *reinterpret_cast<const int4*>(kf + r);
      hit = k.x != key ? 0 : k.y != key ? 1 : k.z != key ? 2
            : k.w != key ? 3 : kRowsPerThread;
    }
    const unsigned found = __ballot_sync(kFull, hit < kRowsPerThread);
    if (found) {
      const int l = __ffs(found) - 1;
      return base + l * kRowsPerThread + __shfl_sync(kFull, hit, l);
    }
  }
  return n;
}

// Count of direction-0 rows before tile `k` of a frame, by decoupled
// look-back over the status words of tiles k - 1, k - 2, ..., 32 at a time:
// sums aggregates up to the nearest tile that holds its inclusive prefix.
// Warp 0 calls it after tile k published its own aggregate.
__device__ int look_back(const unsigned long long* status, int k,
                         unsigned seq, int lane) {
  int before = 0;
  for (int j = k - 1;; j -= 32) {
    const int idx = j - lane;
    unsigned long long w;
    unsigned state;
    do {
      w = idx >= 0 ? load_relaxed(status + idx)
                   : status_word(seq, kPrefix, 0);
      state = (unsigned)(w >> 34) == seq ? (unsigned)(w >> 32) & 3u : 0u;
    } while (__any_sync(kFull, state == 0));
    const unsigned prefix = __ballot_sync(kFull, state == kPrefix);
    const int stop = prefix ? __ffs(prefix) - 1 : 31;
    int v = lane <= stop ? (int)(unsigned)w : 0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    before += v;
    if (prefix) return before;
  }
}

// Max over the 32 lanes of a warp.
__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// One block per (frame, tile of 1024 rows); grid B * ntiles, kThreads each.
// status: B * ntiles words; epoch[0] counts the calls, epoch[1] the
// finished blocks of this call; all zero before the first call.
__global__ void __launch_bounds__(kThreads)
    segment_stats_kernel(const int32_t* __restrict__ key,
                         const int32_t* __restrict__ payload, int n,
                         int ntiles, unsigned long long* status,
                         unsigned* epoch, int32_t* __restrict__ t,
                         int32_t* __restrict__ cand_len,
                         int32_t* __restrict__ cand_pos) {
  __shared__ int warp_count[kWarps];  // direction-0 rows of each warp
  __shared__ int warp_first[kWarps];  // first run start in each warp, or n
  __shared__ int tile_before, tile_next;
  __shared__ unsigned tile_seq;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x / ntiles, k = blockIdx.x % ntiles;
  const int tile0 = k * kTileN, tile_end = min(tile0 + kTileN, n);
  const int r0 = tile0 + threadIdx.x * kRowsPerThread;
  const int32_t* kf = key + (size_t)b * n;
  const int32_t* pf = payload + (size_t)b * n;
  if (threadIdx.x == 0) tile_seq = (__ldcg(epoch) + 1u) & kSeqMask;

  // n % 128 == 0, so a warp's 128 rows (one chunk) are all inside the
  // frame or none is
  const bool in = r0 < n;
  int kv[4] = {kIntMax, kIntMax, kIntMax, kIntMax}, pv[4] = {0, 0, 0, 0};
  if (in) {
    const int4 k4 = *reinterpret_cast<const int4*>(kf + r0);
    const int4 p4 = *reinterpret_cast<const int4*>(pf + r0);
    kv[0] = k4.x, kv[1] = k4.y, kv[2] = k4.z, kv[3] = k4.w;
    pv[0] = p4.x, pv[1] = p4.y, pv[2] = p4.z, pv[3] = p4.w;
  }
  int32_t prev = __shfl_up_sync(kFull, kv[3], 1);
  if (lane == 0) prev = in && r0 > 0 ? kf[r0 - 1] : -1;
  bool start[4];
  int d0[4], count = 0, first = n;  // first: the thread's first run start
#pragma unroll
  for (int j = 3; j >= 0; --j) {
    start[j] = in && kv[j] != (j ? kv[j - 1] : prev);
    d0[j] = in && kv[j] != kIntMax && is_dir0(pv[j]);
    count += d0[j];
    if (start[j]) first = r0 + j;
  }

  // The warp's inclusive scan of the threads' counts, and its first start.
  int incl = count;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  const unsigned starts = __ballot_sync(kFull, first < n);
  const int wfirst = __shfl_sync(kFull, first, starts ? __ffs(starts) - 1 : 0);
  if (lane == 31) warp_count[warp] = incl;
  if (lane == 0) warp_first[warp] = starts ? wfirst : n;
  __syncthreads();

  const unsigned seq = tile_seq;
  if (warp == 0) {
    // The tile's count, published at once; then the count before it.
    int agg = lane < kWarps ? warp_count[lane] : 0;
    for (int o = 16; o > 0; o >>= 1) agg += __shfl_xor_sync(kFull, agg, o);
    unsigned long long* st = status + (size_t)b * ntiles;
    int before = 0;
    if (k == 0) {
      if (lane == 0) store_relaxed(st, status_word(seq, kPrefix, agg));
    } else {
      if (lane == 0) store_relaxed(st + k, status_word(seq, kAggregate, agg));
      before = look_back(st, k, seq, lane);
      if (lane == 0)
        store_relaxed(st + k, status_word(seq, kPrefix, before + agg));
    }
    if (lane == 0) tile_before = before;
  } else if (warp == kWarps - 1) {
    // The run start after the tile's last run, where that run is valid
    // and starts in the tile (no other run's score needs it).
    bool any = false;
    for (int w = 0; w < kWarps; ++w) any |= warp_first[w] < n;
    const int32_t last_key = kf[tile_end - 1];
    int next = n;
    if (any && last_key != kIntMax && tile_end < n)
      next = next_start_from(kf, tile_end, n, last_key, lane);
    if (lane == 0) tile_next = next;
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    // this block is done with the epoch: the call's last block advances it
    __threadfence();
    if (atomicAdd(epoch + 1, 1u) == gridDim.x - 1) {
      epoch[1] = 0;
      epoch[0] += 1;
    }
  }
  if (!in) return;

  // t: the four inclusive counts, one 16-byte store
  int run = tile_before + incl - count;
  for (int w = 0; w < warp; ++w) run += warp_count[w];
  int tv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) tv[j] = run += d0[j];
  *reinterpret_cast<int4*>(t + (size_t)b * n + r0) =
      make_int4(tv[0], tv[1], tv[2], tv[3]);

  // The next run start after the thread's rows: in the next lane that
  // holds one, else in the next warp of the tile that does, else past the
  // tile; then backward over the thread's rows.
  const unsigned above = starts & ~(kFull >> (31 - lane));  // lanes > lane
  int after = __shfl_sync(kFull, first, above ? __ffs(above) - 1 : lane);
  if (!above) {
    after = tile_next;
    for (int w = kWarps - 1; w > warp; --w)
      if (warp_first[w] < n) after = warp_first[w];
  }
  int score[4];
#pragma unroll
  for (int j = 3; j >= 0; --j) {
    score[j] = start[j] && kv[j] != kIntMax ? after - (r0 + j) : 0;
    if (start[j]) after = r0 + j;
  }

  // The chunk's top-2 over the warp's 128 rows: (score << 7) | (127 - row)
  // puts ties on the lowest row.
  const int row_c = lane * kRowsPerThread;  // row in the chunk of j = 0
  int best = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    best = max(best, (score[j] << 7) | (127 - row_c - j));
  const int best1 = warp_max(best);
  const int a1 = 127 - (best1 & 127);
  best = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int s = row_c + j == a1 ? 0 : score[j];
    best = max(best, (s << 7) | (127 - row_c - j));
  }
  const int best2 = warp_max(best);
  const int a2 = 127 - (best2 & 127);
  if (lane == 0) {
    const int nc = n / 128, c = r0 / 128;
    const size_t o = (size_t)b * 2 * nc;
    cand_len[o + c] = best1 >> 7;
    cand_len[o + nc + c] = best2 >> 7;
    cand_pos[o + c] = c * 128 + a1;
    cand_pos[o + nc + c] = c * 128 + a2;
  }
}

}  // namespace

// key, payload [B, n] int32 (n % 128 == 0, n < 2^24, 16-byte aligned) ->
// t [B, n], cand_len, cand_pos [B, 2 * n / 128]. status: at least
// B * ceil(n / 1024) words and epoch: 2 words, both kept by the caller
// between calls on one stream and zero before the first. One launch;
// returns cudaGetLastError() (0 on success).
extern "C" int chalkydri_segment_stats(const int32_t* key,
                                       const int32_t* payload, int B, int n,
                                       unsigned long long* status,
                                       unsigned* epoch, int32_t* t,
                                       int32_t* cand_len, int32_t* cand_pos,
                                       void* stream) {
  const int ntiles = (n + kTileN - 1) / kTileN;
  segment_stats_kernel<<<B * ntiles, kThreads, 0, (cudaStream_t)stream>>>(
      key, payload, n, ntiles, status, epoch, t, cand_len, cand_pos);
  return (int)cudaGetLastError();
}
