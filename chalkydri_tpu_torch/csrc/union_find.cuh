// The lock-free union-find that kernels B5 (threshold_ccl.cu) and B6
// (propagate.cu) build their labels on, after Playne and Hawick 2018: the
// component structure at the GLOBAL fixed point of the label propagation
// (4-connectivity between equal values, diagonals between whites only).
//
// Every link puts the larger root under the smaller with atomicMin, so
// every root is its component's minimum index whatever order the unions
// run in, and every ancestor has a smaller index than its descendants.
// Entries only decrease and stay in their set. The pieces here:
//   - the pages the entries live in (global memory, a CTA's shared memory;
//     B6 adds the shared memory of a thread block cluster): how a walk
//     reads an entry that other threads lower meanwhile, and where the
//     atomics go;
//   - find_halving and unite over any such page;
//   - links_up, the links a pixel needs with the row above once a pair of
//     row runs;
//   - UnionQueue, a warp's queue of those rare, scattered unions, run 32
//     at a time, one a lane.

#pragma once

#include "ccl_common.cuh"

namespace ccl {
namespace {

constexpr int kUnionQueue = 64;  // a warp's queued unions

// A parent page in global memory, indexed from par: reads through L2
// (__ldcg), where the other CTAs' atomics land.
struct GlobalPage {
  int32_t* par;
  __device__ __forceinline__ int load(int q) const { return __ldcg(par + q); }
  __device__ __forceinline__ int32_t* at(int q) const { return par + q; }
};

// The entries of indices base, base + 1, ... in this CTA's shared memory
// (volatile reads).
struct SharedPage {
  int32_t* par;
  int base;
  __device__ __forceinline__ int load(int q) const {
    return ((const volatile int32_t*)par)[q - base];
  }
  __device__ __forceinline__ int32_t* at(int q) const {
    return par + (q - base);
  }
};

// Root of q, halving the path (every entry read is pointed two steps up).
// A halved entry is still an ancestor and a root is never halved, so this
// is safe while unions run. The halving lowers the entry with atomicMin:
// a walk may read q's parent and grandparent g, then q's own thread store
// q's root into q's entry (a flatten), and only then the walk halve q; a
// plain store would put g, a mere ancestor, back over the root.
template <class Page>
__device__ __forceinline__ int find_halving(const Page& pg, int q) {
  while (true) {
    const int v = pg.load(q);
    if (v == q) return q;
    const int g = pg.load(v);
    if (g == v) return v;
    atomicMin(pg.at(q), g);
    q = g;
  }
}

// Union of the sets of a and b: the larger root goes under the smaller.
// When the atomicMin finds that b stopped being a root, the set b had
// joined is united with a in turn, so no link is lost.
template <class Page>
__device__ __forceinline__ void unite(const Page& pg, int a, int b) {
  while (true) {
    a = find_halving(pg, a);
    b = find_halving(pg, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(pg.at(b), a);
    if (old == b) return;
    b = old;
  }
}

// The unions pixel t[0] (column x of rows w pixels wide, not in the first
// row; the row above `pitch` bytes before it) needs with the row above,
// once a pair of row runs: the up link is implied when the left pixel is
// in t[0]'s run and the up-left pixel in the up pixel's run (the leftmost
// pixel of the overlap makes it); between whites an up-left link is
// implied when the left pixel is white too, an up-right link when the up
// pixel is. Returns bit k for the link to the pixel pitch + 1 - k before
// t[0]; none for a skip pixel.
__device__ __forceinline__ unsigned links_up(const uint8_t* t, int pitch,
                                             int x, int w) {
  const int v = t[0];
  if (v == 127) return 0;
  const bool left = x > 0 && t[-1] == v;
  const int up_left = x > 0 ? t[-pitch - 1] : 127;
  const bool up = t[-pitch] == v;
  unsigned links = up && !(left && up_left == v) ? 2u : 0u;
  if (v == 255) {
    if (!left && up_left == 255) links |= 1u;
    if (!up && x < w - 1 && t[-pitch + 1] == 255) links |= 4u;
  }
  return links;
}

// A warp's unions, queued: they are few and far between (one a pair of
// runs), so the warp runs them 32 at a time, one a lane, instead of one
// lane at a time in a warp that waits. Every lane of the warp makes the
// same calls; q points at the warp's 2 * kUnionQueue words of shared
// memory.
template <class Page>
struct UnionQueue {
  Page pg;
  int32_t* qa;
  int32_t* qb;
  int lane;
  int count;  // queued, the same in every lane

  __device__ UnionQueue(const Page& page, int32_t* q)
      : pg(page), qa(q), qb(q + kUnionQueue), lane(threadIdx.x & 31),
        count(0) {}

  // Queues the union of a and b in the lanes where `has` holds.
  __device__ __forceinline__ void push(bool has, int a, int b) {
    const uint32_t m = __ballot_sync(kFullWarp, has);
    if (has) {
      const int slot = count + __popc(m & ((1u << lane) - 1));
      qa[slot] = a;
      qb[slot] = b;
    }
    count += __popc(m);
    if (count >= 32) {
      __syncwarp();
      unite(pg, qa[lane], qb[lane]);
      const int rest = count - 32;
      int a2 = 0, b2 = 0;
      if (lane < rest) {
        a2 = qa[32 + lane];
        b2 = qb[32 + lane];
      }
      __syncwarp();
      if (lane < rest) {
        qa[lane] = a2;
        qb[lane] = b2;
      }
      __syncwarp();
      count = rest;
    }
  }

  // Runs what is left in the queue.
  __device__ __forceinline__ void drain() {
    __syncwarp();
    if (lane < count) unite(pg, qa[lane], qb[lane]);
  }
};

}  // namespace
}  // namespace ccl
