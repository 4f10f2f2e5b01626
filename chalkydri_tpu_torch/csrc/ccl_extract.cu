// Kernel B1: adaptive threshold -> connected-component labeling ->
// boundary-candidate extraction, for a batch of decimated grayscale frames.
//
// Replaces chalkydri_tpu/ops/pallas/ccl_kernel.py::threshold_ccl_extract_pallas
// and gives bit-identical output: dir-major [B, 2, H, W] int32 pages of
// black label, white label and packed payload
// (x2 | y2 << 13 | dir << 26 | white << 28).
//
// The TPU kernel keeps a whole frame in VMEM. Here one 400x640 int32 label
// page is 1 MB, far over the 227 KB of shared memory a block can use, so
// this first version keeps every page in device memory: four frames of
// labels are 4 MB and stay in the 50 MB L2. The stages run as launches on
// the caller's stream from one C entry point (stages 1-3 are the device
// code in ccl_common.cuh, which B3-B5 share):
//   1. tile min/max (4x4 tiles), then per-pixel classification against
//      the 3x3-tile dilated extrema;
//   2. the round-invariant connectivity bits (8 offsets, run starts along
//      rows and columns, validity) and the initial flat-index labels;
//   3. exactly `iters` rounds of neighbor-min, row-run min, column-run min
//      (with the remask of skip pixels). The Pallas kernel stops early at
//      a fixed point, where further rounds change nothing, so the labels
//      agree. There is no host synchronisation anywhere;
//   4. the extraction epilogue (speckle gate + right/down edge pairs,
//      ccl::emit_candidates, shared with B7).
//
// What bounds it: the 24 B/px of candidate pages written, and about
// 12 rounds x ~26 B/px of label/bit traffic, served mostly from L2. Fusing
// the rounds into shared-memory tiles, and fusing block compaction into the
// epilogue, is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ccl_common.cuh"

namespace {

__global__ void extract_kernel(const uint8_t* __restrict__ tern,
                               const int32_t* __restrict__ labels, int B,
                               int H, int W, int32_t* __restrict__ black,
                               int32_t* __restrict__ white,
                               int32_t* __restrict__ payload) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * H * W) return;
  const int x = i % W, y = (i / W) % H, b = i / (H * W);
  const size_t in = (size_t)b * H * W, out = 2 * in;
  ccl::emit_candidates(tern + in, labels + in, H, W, y, x, y, H, y,
                       black + out, white + out, payload + out);
}

}  // namespace

// gray [B, H, W] u8 (H, W multiples of 4, at most 4096) -> black, white,
// payload [B, 2, H, W] int32. Scratch: tile_min, tile_max [B, H/4, W/4] u8,
// tern [B, H, W] u8, bits [B, H, W] u16, lab_a, lab_b [B, H, W] int32
// (the labels end in lab_a). Returns cudaGetLastError() after the launches
// (0 on success).
extern "C" int chalkydri_ccl_extract(const uint8_t* gray, int B, int H, int W,
                                     int iters, int min_diff,
                                     uint8_t* tile_min, uint8_t* tile_max,
                                     uint8_t* tern, uint16_t* bits,
                                     int32_t* lab_a, int32_t* lab_b,
                                     int32_t* black, int32_t* white,
                                     int32_t* payload, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int rc = ccl::threshold(gray, B, H, W, min_diff, tile_min, tile_max, tern, s);
  if (rc) return rc;
  rc = ccl::label(tern, B, H, W, iters, bits, lab_a, lab_b, s);
  if (rc) return rc;
  extract_kernel<<<ccl::blocks_for(B * H * W), ccl::kThreads, 0, s>>>(
      tern, lab_a, B, H, W, black, white, payload);
  CCL_CHECK_LAUNCH();
  return 0;
}
