// Kernels B3, B4 and B5: adaptive threshold and connected-component
// labeling, for the full-resolution quad search (quad_decimate = 1).
//
// B3 (chalkydri_threshold, then B4) replaces
//    chalkydri_tpu/ops/pallas/ccl_kernel.py::threshold_ccl_pallas:
//    gray -> (tern, labels after exactly `iters` propagation rounds).
// B4 chalkydri_label_components replaces
//    chalkydri_tpu/ops/pallas/ccl_kernel.py::label_components_pallas:
//    the same rounds from a given tern.
//    Both are the stages of B1 (ccl_common.cuh) without its extraction
//    epilogue, bit-identical to the Pallas kernels; the wrapper of B3
//    launches the threshold stage and then B4. At [4, 800, 1280] one int32
//    label page is 16 MB, so the two ping-pong pages no longer sit in L2
//    as B1's 4 MB do. Bound at that shape: 4.1 MB in and 20.5 MB out (B3),
//    4.1 MB in and 16.4 MB out (B4), at 3.35 TB/s about 7.3 and 6.1 us;
//    the 12 rounds of label traffic (~26 B/px each) are what hold them
//    back.
//
// B5 chalkydri_threshold_ccl_exact replaces
//    chalkydri_tpu/ops/pallas/ccl_kernel.py::threshold_ccl_blocked:
//    threshold + labels at the GLOBAL fixed point, each component labelled
//    ry * wp + rx, where (ry, rx) is its first pixel in raster order and
//    wp = ceil(W / 128) * 128 (a flat index in the lane-padded frame).
//    The TPU splits a 2 M-px frame into row blocks only because its live
//    set exceeds VMEM, then merges the seams until a certified fixed
//    point. Here every page is device memory, so this computes the fixed
//    point directly with a lock-free union-find (Playne and Hawick 2018):
//      1. threshold with the shared tile kernels;
//      2. parent[p] = p, the flat index within the frame;
//      3. each non-skip pixel unions with its connected backward
//         neighbors (left and up for every value, up-left and up-right
//         between two whites), linking the larger root under the smaller
//         with atomicMin, so every root is its component's minimum index;
//      4. each pixel walks to its root r and writes (r / W) * wp + r % W
//         (kInvalid on skip pixels).
//    A fixed number of launches, no host synchronisation, exact for any
//    topology. The TPU result is the same fixed point wherever its hybrid
//    merge certifies convergence; it can differ only where the TPU stops
//    at its merge_rounds cap on adversarial input.
//    Bound at [2, 1304, 1600]: 4.2 MB in, 20.9 MB out, about 25 MB moved,
//    ~7.5 us at 3.35 TB/s. What holds it back is the parent chasing: the
//    root walks read scattered, non-coalesced parent entries, and a long
//    run of one value can chain its pixels into a deep tree.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ccl_common.cuh"

namespace {

using ccl::kInvalid;

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

}  // namespace

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
// [B, H, W] int32 after exactly `iters` rounds. Scratch: bits [B, H, W]
// u16, scratch [B, H, W] int32.
extern "C" int chalkydri_label_components(const uint8_t* tern, int B, int H,
                                          int W, int iters, uint16_t* bits,
                                          int32_t* labels, int32_t* scratch,
                                          void* stream) {
  return ccl::label(tern, B, H, W, iters, bits, labels, scratch,
                    (cudaStream_t)stream);
}

// B5. gray [B, H, W] u8 (H, W multiples of 4) -> tern [B, H, W] u8 and
// labels [B, H, W] int32 at the global fixed point, padded-flat with row
// pitch wp. Scratch: tile_min, tile_max [B, H/4, W/4] u8, parent
// [B, H, W] int32.
extern "C" int chalkydri_threshold_ccl_exact(const uint8_t* gray, int B,
                                             int H, int W, int wp,
                                             int min_diff, uint8_t* tile_min,
                                             uint8_t* tile_max, uint8_t* tern,
                                             int32_t* parent, int32_t* labels,
                                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int rc =
      ccl::threshold(gray, B, H, W, min_diff, tile_min, tile_max, tern, s);
  if (rc) return rc;
  const int grid = ccl::blocks_for(B * H * W);
  init_parent_kernel<<<grid, ccl::kThreads, 0, s>>>(B, H, W, parent);
  CCL_CHECK_LAUNCH();
  merge_kernel<<<grid, ccl::kThreads, 0, s>>>(tern, B, H, W, parent);
  CCL_CHECK_LAUNCH();
  root_label_kernel<<<grid, ccl::kThreads, 0, s>>>(tern, parent, B, H, W, wp,
                                                   labels);
  CCL_CHECK_LAUNCH();
  return 0;
}
