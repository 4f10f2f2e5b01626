// Kernel B7: boundary-candidate extraction over a row band with halo rows.
//
// Replaces chalkydri_tpu/ops/pallas/ccl_kernel.py::
// extract_candidates_blocked_pallas and gives bit-identical output:
// dir-major [B, 2, Hc, W] int32 pages of black label, white label and
// packed payload (x2 | y2 << 13 | dir << 26 | white << 28) for the band's
// Hc core rows, exactly the rows a whole-frame extraction would emit for
// them.
//
// The band arrives EXTENDED: halo_top rows of the band above come first
// and halo_bottom rows of the band below last (the speckle gate reaches one
// row, and a down-edge of the last core row needs the gate of the row
// below it, which reaches two rows down). Halo rows are neighbor context
// only; y_offset, the global row of the first core row, goes into the
// payload. With no halo and y_offset = 0 this is the whole-frame
// extraction.
//
// The TPU kernel cuts the frame into row blocks of at most 500,000 px so
// that a block's stencils fit VMEM, and has the host assemble each block's
// three halo rows. Here the pages are device memory: one thread per core
// pixel reads its 3x3 neighborhoods straight from the extended page
// (ccl::emit_candidates, shared with B1), so there are no blocks.
//
// Bound at a [2, 328, 1600] band: 5 B/px in, 24 B/px out, 30.4 MB or about
// 9.1 us at 3.35 TB/s. What holds it back: each thread reads up to 27 tern
// bytes, served by L1/L2, and writes six strided int32 values.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ccl_common.cuh"

namespace {

__global__ void extract_band_kernel(const uint8_t* __restrict__ tern,
                                    const int32_t* __restrict__ labels, int B,
                                    int Hext, int W, int halo_top, int Hc,
                                    int y_offset, int32_t* __restrict__ black,
                                    int32_t* __restrict__ white,
                                    int32_t* __restrict__ payload) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * Hc * W) return;
  const int x = i % W, yc = (i / W) % Hc, b = i / (Hc * W);
  const size_t in = (size_t)b * Hext * W, out = (size_t)b * 2 * Hc * W;
  ccl::emit_candidates(tern + in, labels + in, Hext, W, yc + halo_top, x, yc,
                       Hc, yc + y_offset, black + out, white + out,
                       payload + out);
}

}  // namespace

// tern [B, Hext, W] u8 and labels [B, Hext, W] int32, Hext = halo_top + Hc
// + halo_bottom -> black, white, payload [B, 2, Hc, W] int32. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int chalkydri_extract_band(const uint8_t* tern,
                                      const int32_t* labels, int B, int Hext,
                                      int W, int halo_top, int halo_bottom,
                                      int y_offset, int32_t* black,
                                      int32_t* white, int32_t* payload,
                                      void* stream) {
  const int Hc = Hext - halo_top - halo_bottom;
  extract_band_kernel<<<ccl::blocks_for(B * Hc * W), ccl::kThreads, 0,
                        (cudaStream_t)stream>>>(
      tern, labels, B, Hext, W, halo_top, Hc, y_offset, black, white, payload);
  CCL_CHECK_LAUNCH();
  return 0;
}
