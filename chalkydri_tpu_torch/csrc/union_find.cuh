// Lock-free union-find over the pixels of a batch of ternary frames, shared
// by kernel B5 (threshold_ccl.cu) and kernel B6 (propagate.cu): the
// component structure at the GLOBAL fixed point of the label propagation
// (4-connectivity between equal values, diagonals between whites only),
// after Playne and Hawick 2018.
//
//   1. parent[p] = p, the flat index within the frame;
//   2. each non-skip pixel unions with its connected backward neighbors
//      (left and up for every value, up-left and up-right between two
//      whites), linking the larger root under the smaller with atomicMin,
//      so every root is its component's minimum index;
//   3. a root walk per pixel then reads whatever the caller keeps at the
//      root: its padded-flat index (root_label_kernel) or a value reduced
//      over the component (propagate.cu).
// A fixed number of launches, no host synchronisation, exact on any
// topology.

#pragma once

#include "ccl_common.cuh"

namespace ccl {
namespace {

// Root of p. During the merge other threads lower parent entries; reading
// through L2 (__ldcg) sees their atomics, and a stale entry is still an
// ancestor of p, so the walk stays correct either way.
__device__ __forceinline__ int find_root(const int32_t* parent, int p) {
  int q = __ldcg(parent + p);
  while (q != p) {
    p = q;
    q = __ldcg(parent + p);
  }
  return p;
}

// Union of the sets of a and b: the larger root goes under the smaller.
// When the atomicMin finds that b stopped being a root, the set b had
// joined is united with a in turn, so no link is lost.
__device__ void unite(int32_t* parent, int a, int b) {
  while (true) {
    a = find_root(parent, a);
    b = find_root(parent, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(parent + b, a);
    if (old == b) return;
    b = old;
  }
}

__global__ void init_parent_kernel(int B, int H, int W,
                                   int32_t* __restrict__ parent) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * H * W) return;
  parent[i] = i % (H * W);
}

// Unions over the backward neighbors. An up-left link is implied when the
// left pixel is white too (left and up-left are vertical neighbors), and an
// up-right link when the up pixel is white, so those two are skipped.
__global__ void merge_kernel(const uint8_t* __restrict__ tern, int B, int H,
                             int W, int32_t* parent) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * H * W) return;
  const int hw = H * W;
  const int b = i / hw, p = i % hw;
  const int x = p % W, y = p / W;
  const uint8_t* f = tern + (size_t)b * hw;
  int32_t* par = parent + (size_t)b * hw;
  const int v = f[p];
  if (v == 127) return;
  const bool left = x > 0 && f[p - 1] == v;
  const bool up = y > 0 && f[p - W] == v;
  if (left) unite(par, p, p - 1);
  if (up) unite(par, p, p - W);
  if (v == 255 && y > 0) {
    if (!left && x > 0 && f[p - W - 1] == 255) unite(par, p, p - W - 1);
    if (!up && x < W - 1 && f[p - W + 1] == 255) unite(par, p, p - W + 1);
  }
}

// labels[p] = the padded-flat index (ry * wp + rx) of p's root, kInvalid on
// skip pixels.
__global__ void root_label_kernel(const uint8_t* __restrict__ tern,
                                  const int32_t* __restrict__ parent, int B,
                                  int H, int W, int wp,
                                  int32_t* __restrict__ labels) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * H * W) return;
  const int hw = H * W;
  const int b = i / hw, p = i % hw;
  if (tern[i] == 127) {
    labels[i] = kInvalid;
    return;
  }
  const int r = find_root(parent + (size_t)b * hw, p);
  labels[i] = (r / W) * wp + r % W;
}

// tern [B, H, W] u8 -> parent [B, H, W] int32 with every component's
// pixels under its minimum-index root. Returns the launch error code.
inline int union_find(const uint8_t* tern, int B, int H, int W,
                      int32_t* parent, cudaStream_t s) {
  const int grid = blocks_for(B * H * W);
  init_parent_kernel<<<grid, kThreads, 0, s>>>(B, H, W, parent);
  CCL_CHECK_LAUNCH();
  merge_kernel<<<grid, kThreads, 0, s>>>(tern, B, H, W, parent);
  CCL_CHECK_LAUNCH();
  return 0;
}

// tern -> labels [B, H, W] int32 at the global fixed point, padded-flat
// with row pitch wp. Scratch: parent [B, H, W] int32.
inline int label_exact(const uint8_t* tern, int B, int H, int W, int wp,
                       int32_t* parent, int32_t* labels, cudaStream_t s) {
  const int rc = union_find(tern, B, H, W, parent, s);
  if (rc) return rc;
  root_label_kernel<<<blocks_for(B * H * W), kThreads, 0, s>>>(
      tern, parent, B, H, W, wp, labels);
  CCL_CHECK_LAUNCH();
  return 0;
}

}  // namespace
}  // namespace ccl
