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
// a certificate says nothing moved. Here every page is device memory, so
// both entries compute the fixed point directly with the union-find of
// union_find.cuh (shared with B5):
//
//   chalkydri_label_components_exact  the component's raster-first pixel,
//       as its padded-flat index ry * wp + rx;
//   chalkydri_propagate_components    the MINIMUM caller label over the
//       component: after the unions every root is its component's minimum
//       index, one pass folds labels[p] into rootval[root(p)] with
//       atomicMin (labels are non-negative, rootval starts at kInvalid),
//       and one pass writes rootval[root(p)] back to every pixel.
//
// Four and five launches, no host synchronisation, exact on any topology,
// so the wrapper's convergence certificate is constant true. The TPU
// result is the same fixed point wherever its merge certifies one.
//
// Bound at a [2, 328, 1600] band: 1 B/px of tern and (propagate) 4 B/px of
// labels in, 4 B/px out, 9.4 MB or about 2.8 us at 3.35 TB/s. What holds it
// back is what holds B5 back: root walks over scattered parent entries,
// done twice here, and the atomics on rootval.

#include <cuda_runtime.h>
#include <stdint.h>

#include "union_find.cuh"

namespace {

using ccl::kInvalid;

__global__ void fill_kernel(int n, int32_t value, int32_t* __restrict__ dst) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) dst[i] = value;
}

// rootval[root(p)] = min over the component of labels[p].
__global__ void root_min_kernel(const uint8_t* __restrict__ tern,
                                const int32_t* __restrict__ parent,
                                const int32_t* __restrict__ labels, int B,
                                int H, int W, int32_t* rootval) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * H * W) return;
  if (tern[i] == 127) return;
  const int hw = H * W;
  const int b = i / hw, p = i % hw;
  const int r = ccl::find_root(parent + (size_t)b * hw, p);
  atomicMin(rootval + (size_t)b * hw + r, labels[i]);
}

__global__ void root_value_kernel(const uint8_t* __restrict__ tern,
                                  const int32_t* __restrict__ parent,
                                  const int32_t* __restrict__ rootval, int B,
                                  int H, int W, int32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * H * W) return;
  if (tern[i] == 127) {
    out[i] = kInvalid;
    return;
  }
  const int hw = H * W;
  const int b = i / hw, p = i % hw;
  out[i] = rootval[(size_t)b * hw + ccl::find_root(parent + (size_t)b * hw, p)];
}

}  // namespace

// tern [B, H, W] u8 in {0, 127, 255} -> labels [B, H, W] int32 at the
// frame-local fixed point, padded-flat with row pitch wp (kInvalid on skip
// pixels). Scratch: parent [B, H, W] int32. Returns cudaGetLastError()
// after the launches (0 on success).
extern "C" int chalkydri_label_components_exact(const uint8_t* tern, int B,
                                                int H, int W, int wp,
                                                int32_t* parent,
                                                int32_t* labels,
                                                void* stream) {
  return ccl::label_exact(tern, B, H, W, wp, parent, labels,
                          (cudaStream_t)stream);
}

// tern [B, H, W] u8 and labels [B, H, W] int32 (non-negative, kInvalid on
// skip pixels) -> out [B, H, W] int32: every pixel gets the minimum label
// of its component. Scratch: parent, rootval [B, H, W] int32. `out` may not
// alias `labels`.
extern "C" int chalkydri_propagate_components(const uint8_t* tern,
                                              const int32_t* labels, int B,
                                              int H, int W, int32_t* parent,
                                              int32_t* rootval, int32_t* out,
                                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int rc = ccl::union_find(tern, B, H, W, parent, s);
  if (rc) return rc;
  const int n = B * H * W;
  const int grid = ccl::blocks_for(n);
  fill_kernel<<<grid, ccl::kThreads, 0, s>>>(n, kInvalid, rootval);
  CCL_CHECK_LAUNCH();
  root_min_kernel<<<grid, ccl::kThreads, 0, s>>>(tern, parent, labels, B, H,
                                                 W, rootval);
  CCL_CHECK_LAUNCH();
  root_value_kernel<<<grid, ccl::kThreads, 0, s>>>(tern, parent, rootval, B,
                                                   H, W, out);
  CCL_CHECK_LAUNCH();
  return 0;
}
