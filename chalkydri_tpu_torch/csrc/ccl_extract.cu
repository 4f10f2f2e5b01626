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
// the pages live in device memory: four frames of labels are 4 MB a page
// and stay in the 50 MB L2. The stages run as launches on the caller's
// stream from one C entry point (stages 1-3 are the device code in
// ccl_common.cuh, which B3-B5 share):
//   1. tile min/max (4x4 tiles), then per-pixel classification against
//      the 3x3-tile dilated extrema;
//   2. the round-invariant connectivity byte of every pixel (8 offsets;
//      its bits also mark the run starts and ends) and the initial
//      flat-index labels;
//   3. up to `iters` rounds, two launches each: neighbor-min fused with
//      the row-run min, then the column-run min on shared-memory strips.
//      Like the Pallas kernel a frame stops at its fixed point, where
//      further rounds change nothing, by round flags on the card. There
//      is no host synchronisation anywhere;
//   4. the extraction epilogue (speckle gate + right/down edge pairs,
//      ccl::emit_candidates, shared with B7).
//
// What bounds it: by bytes, the 24 B/px of candidate pages written. At
// 400x640 the passes of stage 3 are short (4-5 us each) and the launches
// themselves weigh as much: 28 launches, 12 of them returning at once on
// the bench scene. The threshold prologue, the extraction epilogue and
// fusing block compaction into it are later work.

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
// tern [B, H, W] u8, bits [B, H, W] u8, lab_a, lab_b [B, H, W] int32
// (the labels end in lab_a), flags [(iters + 1) * B] int32. Returns cudaGetLastError() after the launches
// (0 on success).
extern "C" int chalkydri_ccl_extract(const uint8_t* gray, int B, int H, int W,
                                     int iters, int min_diff,
                                     uint8_t* tile_min, uint8_t* tile_max,
                                     uint8_t* tern, uint8_t* bits,
                                     int32_t* lab_a, int32_t* lab_b,
                                     int32_t* flags, int32_t* black, int32_t* white,
                                     int32_t* payload, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int rc = ccl::threshold(gray, B, H, W, min_diff, tile_min, tile_max, tern, s);
  if (rc) return rc;
  rc = ccl::label(tern, B, H, W, iters, bits, lab_a, lab_b, flags, s);
  if (rc) return rc;
  extract_kernel<<<ccl::blocks_for(B * H * W), ccl::kThreads, 0, s>>>(
      tern, lab_a, B, H, W, black, white, payload);
  CCL_CHECK_LAUNCH();
  return 0;
}
