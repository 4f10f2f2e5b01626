// Kernel B6: connected-component labels of a row band at its frame-local
// fixed point, from flat indices or from labels the caller provides.
//
// Replaces chalkydri_tpu/ops/pallas/ccl_kernel.py::_blocked_propagate, the
// Pallas kernel behind label_components_blocked_pallas and
// propagate_components_blocked. The row-banded (multi-card) detector runs
// it on each band between the seam exchanges: once from flat indices, then
// from the globally offset labels that the neighbours' seam rows lowered.
//
// The TPU splits the band into row blocks that fit VMEM, propagates each
// block for `iters` rounds and merges the block seams round by round until
// a certificate says nothing moved. Here both entries compute that fixed
// point directly with a lock-free union-find (Playne and Hawick 2018):
// every non-skip pixel unions with its connected backward neighbors
// (left and up for every value, up-left and up-right between two whites),
// linking the larger root under the smaller with atomicMin, so every root
// is its component's minimum frame-flat index whatever order the unions
// run in. That is what makes the result bit-identical to the plain twin.
// The union-find's pieces (find_halving, unite, links_up, the warps' union
// queues) are union_find.cuh's, shared with B5.
//
//   label      the component's raster-first pixel, as its padded-flat
//              index ry * wp + rx (kInvalid on skip pixels);
//   propagate  the MINIMUM caller label over the component, for the
//              frames whose `active` flag is set (all when `active` is
//              null); an inactive frame's `out` is a copy of its
//              `labels`. The row-banded step runs a fixed number of seam
//              rounds, all on the card, each gated by a per-frame flag
//              that says whether the frame's seam rows changed (the JAX
//              package's psum-gated while_loop, without a host read): a
//              frame whose seams stopped changing is at its fixed point,
//              and its later rounds only copy.
//
// Two routes, picked by the wrapper from (B, H, W) alone
// (ops/propagate.py::band_cluster_size):
//
// The cluster route (every band the row-banded step sends: 524,800 px a
// frame at qd1, 131,200 at qd2): ONE launch an entry. A frame's parents
// (4 B/px, 2.1 MB at [328, 1600]) do not fit one SM, but they fit a thread
// block cluster: one frame per cluster of C CTAs (up to 16), CTA k owning
// rows [k * R, (k + 1) * R), R = ceil(H / C), with their parent entries and
// their tern bytes (and the row above's) in its shared memory: 198,720 B
// a CTA at qd1 (21 rows, C = 16). A frame then gets only 16 of the 132 SMs, so what
// bounds the kernel is the latency of each warp's chain of dependent
// shared-memory steps, and the output stores of those 16 SMs. What the
// design does about it:
//   0. the tern bytes staged once, with 16-byte loads;
//   1. row runs first: per 32-pixel chunk, ballots of the run-start and
//      skip bits, a block-wide max-scan of each chunk's last start, and
//      every non-skip pixel's entry set to its run's start (depth 1, no
//      atomics). Skip pixels are runs of their own that nothing links,
//      so no later phase touches their entries, and a chunk of skip
//      pixels only has its output (kInvalid in both entries) stored right
//      here;
//   2. unions with the row above only where a pair of runs first meets
//      (the pixel whose left neighbour is in its run and whose up-left
//      neighbour is in its up neighbour's run has nothing to add), linking
//      the larger root under the smaller with shared-memory atomicMin.
//      They are rare and scattered, so each warp queues them and runs them
//      32 at a time, one a lane (ccl::UnionQueue). Then each CTA flattens its own trees
//      with path halving and marks its non-skip local roots: no union
//      runs in the cluster until the barrier below (the CTAs' unions so
//      far touch their own shared memory only), a halved entry is still
//      an ancestor, and the halving lowers entries with atomicMin, so a
//      walk that read an entry before its own thread stored the root
//      there cannot put an ancestor back over it (ccl::find_halving);
//   3. cluster.sync(); unions across each CTA's top row and the row above
//      it: the roots may live in any CTA of the cluster, so the walks read
//      and the atomicMin links write their shared memory through DSMEM
//      (cluster.map_shared_rank). A stale entry read during the unions is
//      still an ancestor (entries only decrease and stay <= their index),
//      and unite() retries with the value the atomic returns, so no link
//      is lost. The unions start from the two pixels' local roots, so
//      their halving lowers only local roots' entries: every other pixel's
//      entry still names its local root, in its own CTA;
//   4. cluster.sync(); each local root walks to its root over the cluster,
//      halving, and keeps it; propagate: a root's slot of `out` is set to
//      kInvalid. cluster.sync(): no CTA reads another's entries again;
//   5. label: each local root's entry becomes its root's padded-flat index
//      ry * wp + rx, then every pixel takes its local root's, with 16-byte
//      stores where W % 4 == 0. Propagate: the lanes of a chunk with one
//      root reduce their labels (__match_any_sync, __reduce_min_sync) and
//      one atomicMin a group folds them into the root's slot of `out`;
//      cluster.sync(); every pixel takes its root's slot (a root rewrites
//      its own value), 16-byte stores. `out` serves as the fold's scratch:
//      a non-root slot is never read.
// The global stores and atomics into `out` are ordered by the cluster
// barriers: barrier.cluster.arrive has release and barrier.cluster.wait
// acquire semantics at cluster scope by default, over all of the thread's
// memory operations (global ones included), and every CTA that reads
// `out` belongs to the cluster. The reads of a root's slot go through L2
// (__ldcg), where the atomics were performed, so no stale L1 line serves
// them.
//
// The large-frame route (over SHARED_BYTES a CTA at C = 16; only direct
// callers send such frames): the union-find with its parents in a device
// page (ccl::GlobalPage): three launches (label: init, merge, root walk)
// and five (propagate: init, merge, fill, atomicMin fold, root walk), with
// the parents and the fold's values in device scratch.
//
// Bound at a [2, 328, 1600] band: 1 B/px of tern and (propagate) 4 B/px of
// labels in, 4 B/px out: 5.2 and 9.4 MB, 1.6 and 2.8 us at 3.35 TB/s. The
// large-frame route's launches took 78.3 us (label, 3 launches) and 97.7
// us (propagate, 5) of device time on this band, 70 % of it in the
// merge's global atomics and walks over scattered parents. Prediction for
// the cluster route: 1 launch, 10-30 us (label) and 15-40 us (propagate);
// measured: 1 launch, 35.4 and 40.9 us (chip_smoke.py's B6 lines on an
// NVIDIA H100 80GB HBM3 at 700 W). A propagate call with no frame active
// (its CTAs copy 4.2 MB): 5.0-5.4 us of device time on the same card.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "union_find.cuh"

namespace cg = cooperative_groups;

namespace {

using ccl::kInvalid;

// ---- the large-frame route ------------------------------------------------
// The union-find with its parents in a device page: every non-skip pixel
// unions with its connected backward neighbors, then each pixel walks to
// its root. Walks and unions halve the paths they pass.

// Whether frame b is to be propagated (`active` null: every frame).
__device__ __forceinline__ bool frame_active(const int32_t* active, int b) {
  return active == nullptr || __ldg(active + b) != 0;
}

__global__ void init_parent_kernel(int B, int H, int W,
                                   const int32_t* __restrict__ active,
                                   int32_t* __restrict__ parent) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * H * W || !frame_active(active, i / (H * W))) return;
  parent[i] = i % (H * W);
}

// Unions over the backward neighbors: left, and the row above by
// ccl::links_up.
__global__ void merge_kernel(const uint8_t* __restrict__ tern, int B, int H,
                             int W, const int32_t* __restrict__ active,
                             int32_t* parent) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * H * W) return;
  const int hw = H * W;
  const int b = i / hw, p = i % hw;
  if (!frame_active(active, b)) return;
  const int x = p % W;
  const uint8_t* f = tern + (size_t)b * hw;
  const ccl::GlobalPage pg{parent + (size_t)b * hw};
  const int v = f[p];
  if (v == 127) return;
  if (x > 0 && f[p - 1] == v) ccl::unite(pg, p, p - 1);
  if (p < W) return;
  const unsigned links = ccl::links_up(f + p, W, x, W);
  for (int j = 0; j < 3; ++j)
    if (links >> j & 1) ccl::unite(pg, p, p - W - 1 + j);
}

// tern [B, H, W] u8 -> parent [B, H, W] int32 with every component's
// pixels under its minimum-index root, in the frames that `active` sets
// (null: all). Returns the launch error code.
int union_find(const uint8_t* tern, int B, int H, int W,
               const int32_t* active, int32_t* parent, cudaStream_t s) {
  const int grid = ccl::blocks_for(B * H * W);
  init_parent_kernel<<<grid, ccl::kThreads, 0, s>>>(B, H, W, active, parent);
  CCL_CHECK_LAUNCH();
  merge_kernel<<<grid, ccl::kThreads, 0, s>>>(tern, B, H, W, active, parent);
  CCL_CHECK_LAUNCH();
  return 0;
}

// labels[p] = the padded-flat index (ry * wp + rx) of p's root, kInvalid on
// skip pixels.
__global__ void root_label_kernel(const uint8_t* __restrict__ tern,
                                  int32_t* parent, int B, int H, int W,
                                  int wp, int32_t* __restrict__ labels) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * H * W) return;
  const int hw = H * W;
  const int b = i / hw, p = i % hw;
  if (tern[i] == 127) {
    labels[i] = kInvalid;
    return;
  }
  const int r =
      ccl::find_halving(ccl::GlobalPage{parent + (size_t)b * hw}, p);
  labels[i] = (r / W) * wp + r % W;
}

// dst[i] = value over the active frames' [B, H, W] entries.
__global__ void fill_kernel(int B, int H, int W,
                            const int32_t* __restrict__ active,
                            int32_t value, int32_t* __restrict__ dst) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B * H * W && frame_active(active, i / (H * W))) dst[i] = value;
}

// rootval[root(p)] = min over the component of labels[p].
__global__ void root_min_kernel(const uint8_t* __restrict__ tern,
                                int32_t* parent,
                                const int32_t* __restrict__ labels, int B,
                                int H, int W,
                                const int32_t* __restrict__ active,
                                int32_t* rootval) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * H * W) return;
  const int hw = H * W;
  const int b = i / hw, p = i % hw;
  if (!frame_active(active, b) || tern[i] == 127) return;
  const int r =
      ccl::find_halving(ccl::GlobalPage{parent + (size_t)b * hw}, p);
  atomicMin(rootval + (size_t)b * hw + r, labels[i]);
}

// out[p] = rootval[root(p)]; an inactive frame's out[p] = labels[p].
__global__ void root_value_kernel(const uint8_t* __restrict__ tern,
                                  int32_t* parent,
                                  const int32_t* __restrict__ rootval,
                                  const int32_t* __restrict__ labels, int B,
                                  int H, int W,
                                  const int32_t* __restrict__ active,
                                  int32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * H * W) return;
  const int hw = H * W;
  const int b = i / hw, p = i % hw;
  if (!frame_active(active, b)) {
    out[i] = __ldg(labels + i);
    return;
  }
  if (tern[i] == 127) {
    out[i] = kInvalid;
    return;
  }
  out[i] = rootval[(size_t)b * hw +
                   ccl::find_halving(ccl::GlobalPage{parent + (size_t)b * hw},
                                     p)];
}

// ---- the cluster route ----------------------------------------------------

constexpr int kThreads = 1024;  // a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
constexpr unsigned kFull = 0xffffffffu;

// Shared memory of a CTA that holds R rows of W pixels (the wrapper's
// ops/propagate.py::band_cluster_bytes computes the same): the parent
// entries, three words a 32-pixel chunk (run-start bits, then the bits of
// the non-skip local roots; skip-pixel bits; the chunk's last run start),
// the scan's warp totals and the warps' union queues, then the tern bytes
// of the rows and of the row above.
__host__ __device__ inline size_t cluster_ints(int R, int W) {
  const size_t n = (size_t)R * W;
  return n + 3 * ((n + 31) / 32) + kWarps * (1 + 2 * ccl::kUnionQueue);
}

__host__ __device__ inline size_t cluster_bytes(int R, int W) {
  return (4 * cluster_ints(R, W) + 15) / 16 * 16 + (size_t)(R + 1) * W;
}

// Column and row of frame-flat index p (< 2^24) of rows of W pixels.
struct Cols {
  int W;
  float inv;
  __device__ __forceinline__ int2 of(int p) const {
    int q = __float2int_rz(__int2float_rn(p) * inv);
    int r = p - q * W;
    while (r < 0) {
      --q;
      r += W;
    }
    while (r >= W) {
      ++q;
      r -= W;
    }
    return make_int2(r, q);
  }
};

// The frame's parents, spread over the cluster: CTA k holds the entries of
// frame-flat indices [k * per_cta, (k + 1) * per_cta) in `par`, at the
// same offset of every CTA's shared memory, reached through DSMEM
// (cluster.map_shared_rank); volatile reads.
struct ClusterPage {
  int32_t* par;  // this CTA's entries
  int per_cta;   // R * W
  __device__ __forceinline__ int32_t* at(int q) const {
    const int rank = q / per_cta;
    return cg::this_cluster().map_shared_rank(par, rank) +
           (q - rank * per_cta);
  }
  __device__ __forceinline__ int load(int q) const {
    return *(volatile int32_t*)at(q);
  }
};

// One frame per cluster of C = gridDim.x / B CTAs, kThreads each, R rows a
// CTA (the last CTAs may hold fewer, or none); dynamic shared memory as
// cluster_bytes. kPropagate: the propagate entry (labels -> out, in the
// frames `active` sets; null: all); else the label entry (out =
// padded-flat root index, row pitch wp). kVec: 16-byte stores of `out`
// (W % 4 == 0, `out` 16-byte aligned).
template <bool kPropagate, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
    cluster_kernel(const uint8_t* __restrict__ tern,
                   const int32_t* __restrict__ labels,
                   const int32_t* __restrict__ active, int H, int W, int wp,
                   int R, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) int32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int k = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int y0 = min(k * R, H), y1 = min(y0 + R, H);
  const int n = (y1 - y0) * W;
  const int base = y0 * W;
  const size_t frame = (size_t)b * H * W;
  int32_t* o = out + frame;

  // An inactive frame: each CTA copies its rows of `labels` into `out`
  // and leaves. Every CTA of the cluster reads the same flag, so none
  // waits at a cluster barrier that another skips, and no CTA touches
  // another's shared memory. `out` never aliases `labels`, and a CUDA
  // graph replays into the same buffers, so the copy is what keeps the
  // next round's input current.
  if (kPropagate && active != nullptr && __ldg(active + b) == 0) {
    const int32_t* src = labels + frame + base;
    int done = 0;
    if (kVec && (uintptr_t)src % 16 == 0) {
      for (int j = threadIdx.x; j < n / 4; j += kThreads)
        ((int4*)(o + base))[j] = __ldg((const int4*)src + j);
      done = n / 4 * 4;
    }
    for (int j = done + threadIdx.x; j < n; j += kThreads)
      o[base + j] = __ldg(src + j);
    return;
  }

  const int per_cta = R * W, chunks_max = (per_cta + 31) / 32;
  int32_t* par = smem;
  uint32_t* bits = (uint32_t*)(smem + per_cta);  // a word a chunk
  uint32_t* skip = bits + chunks_max;            // a word a chunk
  int32_t* last = (int32_t*)(skip + chunks_max);  // a word a chunk
  int32_t* warp_max = last + chunks_max;         // [kWarps]
  int32_t* queue = warp_max + kWarps;  // [kWarps][2][ccl::kUnionQueue]
  // the tern bytes: the row above, then the CTA's rows
  uint8_t* tsm = (uint8_t*)smem + (4 * cluster_ints(R, W) + 15) / 16 * 16;
  const int chunks = (n + 31) / 32;
  const ccl::SharedPage local{par, base};
  const ClusterPage all{par, per_cta};
  const Cols cols{W, 1.0f / (float)W};
  const uint8_t* t = tsm + W;  // t[i]: pixel base + i
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // 0. stage the tern bytes (16-byte loads where the rows are aligned)
  {
    const int above = y0 > 0 ? W : 0;
    const uint8_t* src = tern + frame + base - above;
    uint8_t* dst = tsm + W - above;
    const int len = n + above;
    int done = 0;
    if ((uintptr_t)src % 16 == 0 && (uintptr_t)dst % 16 == 0) {
      for (int j = threadIdx.x; j < len / 16; j += kThreads)
        ((uint4*)dst)[j] = __ldg((const uint4*)src + j);
      done = len / 16 * 16;
    }
    for (int j = done + threadIdx.x; j < len; j += kThreads)
      dst[j] = __ldg(src + j);
  }
  __syncthreads();

  // 1. row runs: bits[c] marks the pixels of chunk c that start one, and
  //    skip[c] its skip pixels (each a run of its own, never linked, so
  //    no phase reads or writes their entries; lanes past the CTA's rows
  //    count as skip). A chunk of skip pixels only has its output,
  //    kInvalid in both entries, stored now; the last phase writes only
  //    the chunks that hold labels.
  for (int c = warp; c < chunks; c += kWarps) {
    const int i = 32 * c + lane;
    const int v = i < n ? t[i] : 127;
    const bool start = v == 127 || t[i - 1] != v;  // rows: see below
    const uint32_t m = __ballot_sync(kFull, start);
    const uint32_t sk = __ballot_sync(kFull, v == 127);
    if (lane == 0) {
      bits[c] = m;
      skip[c] = sk;
    }
    if (sk == kFull && i < n) o[base + i] = kInvalid;
  }
  __syncthreads();
  for (int y = threadIdx.x; y < y1 - y0; y += kThreads)  // rows start runs
    atomicOr(bits + (y * W >> 5), 1u << (y * W & 31));
  __syncthreads();
  //    last[c]: the last run start up to the end of chunk c, by a max-scan
  //    over the chunks (each thread a few consecutive ones)
  const int per = (chunks + kThreads - 1) / kThreads;
  const int c_end = min(chunks, ((int)threadIdx.x + 1) * per);
  int run = -1;
  for (int c = threadIdx.x * per; c < c_end; ++c) {
    if (bits[c]) run = 32 * c + 31 - __clz(bits[c]);
    last[c] = run;
  }
  int scan = run;
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, scan, d);
    if (lane >= d) scan = max(scan, u);
  }
  if (lane == 31) warp_max[warp] = scan;
  __syncthreads();
  if (warp == 0) {
    int u = warp_max[lane];
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, u, d);
      if (lane >= d) u = max(u, v);
    }
    warp_max[lane] = u;
  }
  __syncthreads();
  int before = __shfl_up_sync(kFull, scan, 1);
  if (lane == 0) before = -1;
  if (warp > 0) before = max(before, warp_max[warp - 1]);
  for (int c = threadIdx.x * per; c < c_end; ++c)
    last[c] = max(last[c], before);
  __syncthreads();
  //    every non-skip pixel under its run's start (a row's first pixel
  //    starts one, so chunk 0 holds a start)
  for (int c = warp; c < chunks; c += kWarps) {
    if (skip[c] == kFull) continue;
    const int i = 32 * c + lane;
    const uint32_t m = bits[c] & (kFull >> (31 - lane));
    if (i < n) par[i] = base + (m ? 32 * c + 31 - __clz(m) : last[c - 1]);
  }
  __syncthreads();
  // 2. unions with the row above inside the CTA. A pixel's unions are
  //    few and far between (one a pair of runs), so a warp queues them and
  //    runs them 32 at a time, one a lane, instead of one lane at a time
  //    in a warp that waits. Then the CTA's trees are flattened (no union
  //    runs in the cluster until the barrier below, and a flattened or
  //    halved entry is still an ancestor, lowered only by atomicMin);
  //    bits[c] now marks the chunk's non-skip local roots
  {
    ccl::UnionQueue<ccl::SharedPage> unions(
        local, queue + warp * 2 * ccl::kUnionQueue);
    for (int c = W / 32 + warp; c < chunks; c += kWarps) {
      if (skip[c] == kFull) continue;
      const int i = 32 * c + lane, p = base + i;
      const unsigned links =
          i >= W && !(skip[c] >> lane & 1)
              ? ccl::links_up(t + i, W, cols.of(p).x, W)
              : 0u;
      unions.push(links & 2u, p, p - W);
      unions.push(links & 1u, p, p - W - 1);
      unions.push(links & 4u, p, p - W + 1);
    }
    unions.drain();
  }
  __syncthreads();
  for (int c = warp; c < chunks; c += kWarps) {
    bool root = false;
    if (skip[c] != kFull && !(skip[c] >> lane & 1)) {
      const int i = 32 * c + lane;
      const int r = ccl::find_halving(local, base + i);
      par[i] = r;  // no halving lowers it further: r is the least ancestor
      root = r == base + i;
    }
    const uint32_t m = __ballot_sync(kFull, root);
    if (lane == 0) bits[c] = m;
  }
  cluster.sync();  // every CTA's own unions are done
  // 3. unions across the CTA's top row and the row above it, started from
  //    the two pixels' local roots: the walks then halve only local
  //    roots' entries, and every other pixel's still names its local root
  if (n > 0 && y0 > 0) {
    for (int x = threadIdx.x; x < W; x += kThreads) {
      const unsigned links = ccl::links_up(t + x, W, x, W);
      for (int j = 0; j < 3; ++j)
        if (links >> j & 1)
          ccl::unite(all, local.load(base + x),
                     all.load(base + x - W - 1 + j));
    }
  }
  cluster.sync();  // the last union is done
  // 4. the local roots onto their roots (halving the paths over the
  //    cluster); a root's slot starts the fold
  for (int c = warp; c < chunks; c += kWarps) {
    if (bits[c] >> lane & 1) {
      const int i = 32 * c + lane, p = base + i;
      const int v = par[i];
      const int r = v == p ? p : ccl::find_halving(all, v);
      par[i] = r;
      if (kPropagate && r == p) o[p] = kInvalid;
    }
  }
  cluster.sync();  // every entry is final; no CTA reads another's again
  // The root of non-skip pixel i: a local root's entry, or its local
  // root's.
  auto root_of = [&](int i) {
    const int r = par[i];
    return bits[i >> 5] >> (i & 31) & 1 ? r : par[r - base];
  };
  auto is_skip = [&](int i) { return skip[i >> 5] >> (i & 31) & 1; };

  if constexpr (!kPropagate) {
    // 5. the local roots' entries become their labels, then every pixel's
    for (int c = warp; c < chunks; c += kWarps) {
      if (bits[c] >> lane & 1) {
        const int i = 32 * c + lane;
        const int2 xy = cols.of(par[i]);
        par[i] = xy.y * wp + xy.x;
      }
    }
    __syncthreads();
    auto label_of = [&](int i) { return is_skip(i) ? kInvalid : root_of(i); };
    if constexpr (kVec) {
      for (int i = 4 * threadIdx.x; i < n; i += 4 * kThreads) {
        if (skip[i >> 5] == kFull) continue;  // written in phase 1
        *(int4*)(o + base + i) = make_int4(label_of(i), label_of(i + 1),
                                           label_of(i + 2), label_of(i + 3));
      }
    } else {
      for (int i = threadIdx.x; i < n; i += kThreads)
        if (skip[i >> 5] != kFull) o[base + i] = label_of(i);
    }
  } else {
    // 5. the fold: a warp's lanes of one root reduce first, one atomicMin
    //    a root and warp
    for (int c = warp; c < chunks; c += kWarps) {
      if (skip[c] == kFull) continue;
      const int i = 32 * c + lane;
      int key = -1;
      int32_t value = kInvalid;
      if (!(skip[c] >> lane & 1)) {
        key = root_of(i);
        value = __ldg(labels + frame + base + i);
      }
      const uint32_t group = __match_any_sync(kFull, key);
      const int32_t lowest = __reduce_min_sync(group, value);
      if (key >= 0 && lane == __ffs(group) - 1) atomicMin(o + key, lowest);
    }
    cluster.sync();  // every fold is in its root's slot
    // 6. every pixel its root's value (a root rewrites its own)
    auto value_of = [&](int i) {
      return is_skip(i) ? kInvalid : __ldcg(o + root_of(i));
    };
    if constexpr (kVec) {
      for (int i = 4 * threadIdx.x; i < n; i += 4 * kThreads) {
        if (skip[i >> 5] == kFull) continue;  // written in phase 1
        *(int4*)(o + base + i) = make_int4(value_of(i), value_of(i + 1),
                                           value_of(i + 2), value_of(i + 3));
      }
    } else {
      for (int i = threadIdx.x; i < n; i += kThreads)
        if (skip[i >> 5] != kFull) o[base + i] = value_of(i);
    }
  }
}

template <bool kPropagate, bool kVec>
int launch_band(const uint8_t* tern, const int32_t* labels,
                const int32_t* active, int B, int H, int W, int wp, int C,
                int32_t* out, cudaStream_t stream) {
  if (B < 1 || C < 1 || C > kMaxCluster || W < 1 || H < 1 ||
      (size_t)H * W > (1u << 24) || (size_t)B * H * W >= (1u << 31))
    return (int)cudaErrorInvalidValue;
  const int R = (H + C - 1) / C;
  static ccl::ClusterCheck checks[64];  // this instantiation's, per card
  return ccl::launch_cluster(cluster_kernel<kPropagate, kVec>, B * C, C,
                             kThreads, cluster_bytes(R, W), stream, checks,
                             tern, labels, active, H, W, wp, R, out);
}

bool vec_stores(int W, const int32_t* out) {
  return W % 4 == 0 && (uintptr_t)out % 16 == 0;
}

}  // namespace

// The cluster route, label entry: tern [B, H, W] u8 in {0, 127, 255} ->
// labels [B, H, W] int32 at the frame-local fixed point, padded-flat with
// row pitch wp (kInvalid on skip pixels), in one launch of B clusters of C
// CTAs (ceil(H / C) rows each, their parents in at most 227 KB of shared
// memory). Returns cudaGetLastError() after the launch (0 on success),
// cudaErrorInvalidValue for a shape the route does not take, or -2 when
// the card cannot schedule such a cluster.
extern "C" int chalkydri_label_components_cluster(const uint8_t* tern, int B,
                                                  int H, int W, int wp, int C,
                                                  int32_t* labels,
                                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return vec_stores(W, labels)
             ? launch_band<false, true>(tern, nullptr, nullptr, B, H, W, wp,
                                           C, labels, s)
             : launch_band<false, false>(tern, nullptr, nullptr, B, H, W, wp,
                                            C, labels, s);
}

// The cluster route, propagate entry: tern [B, H, W] u8 and labels
// [B, H, W] int32 (kInvalid on skip pixels) -> out [B, H, W] int32: every
// pixel of a frame whose active[b] is non-zero gets the minimum label of
// its component, every pixel of another frame its own label (`active`
// [B] int32 on the card, or null: every frame active), in one launch; no
// scratch. `out` may not alias `labels`. Returns as the label entry.
extern "C" int chalkydri_propagate_components_cluster(const uint8_t* tern,
                                                      const int32_t* labels,
                                                      const int32_t* active,
                                                      int B, int H, int W,
                                                      int C, int32_t* out,
                                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return vec_stores(W, out)
             ? launch_band<true, true>(tern, labels, active, B, H, W, 0, C,
                                          out, s)
             : launch_band<true, false>(tern, labels, active, B, H, W, 0, C,
                                           out, s);
}

// The large-frame route, label entry: as the cluster route, with scratch
// parent [B, H, W] int32, in three launches. Returns cudaGetLastError()
// after the launches (0 on success).
extern "C" int chalkydri_label_components_exact(const uint8_t* tern, int B,
                                                int H, int W, int wp,
                                                int32_t* parent,
                                                int32_t* labels,
                                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int rc = union_find(tern, B, H, W, nullptr, parent, s);
  if (rc) return rc;
  root_label_kernel<<<ccl::blocks_for(B * H * W), ccl::kThreads, 0, s>>>(
      tern, parent, B, H, W, wp, labels);
  CCL_CHECK_LAUNCH();
  return 0;
}

// The large-frame route, propagate entry: as the cluster route (`active`
// included), with scratch parent, rootval [B, H, W] int32, in five
// launches; for an inactive frame the first four return at once and the
// last copies its labels into `out`.
extern "C" int chalkydri_propagate_components(const uint8_t* tern,
                                              const int32_t* labels,
                                              const int32_t* active, int B,
                                              int H, int W, int32_t* parent,
                                              int32_t* rootval, int32_t* out,
                                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int rc = union_find(tern, B, H, W, active, parent, s);
  if (rc) return rc;
  const int grid = ccl::blocks_for(B * H * W);
  fill_kernel<<<grid, ccl::kThreads, 0, s>>>(B, H, W, active, kInvalid,
                                             rootval);
  CCL_CHECK_LAUNCH();
  root_min_kernel<<<grid, ccl::kThreads, 0, s>>>(tern, parent, labels, B, H,
                                                 W, active, rootval);
  CCL_CHECK_LAUNCH();
  root_value_kernel<<<grid, ccl::kThreads, 0, s>>>(tern, parent, rootval,
                                                   labels, B, H, W, active,
                                                   out);
  CCL_CHECK_LAUNCH();
  return 0;
}
