// Kernels B3, B4 and B5: adaptive threshold and connected-component
// labeling, for the full-resolution quad search (quad_decimate = 1).
//
// B3 (chalkydri_threshold, then B4) replaces
//    chalkydri_tpu/ops/pallas/ccl_kernel.py::threshold_ccl_pallas:
//    gray -> (tern, labels after `iters` propagation rounds).
// B4 chalkydri_label_components replaces
//    chalkydri_tpu/ops/pallas/ccl_kernel.py::label_components_pallas:
//    the same rounds from a given tern.
//    Both are the stages of B1 (ccl_common.cuh) without its extraction
//    epilogue, bit-identical to the Pallas kernels; the wrapper of B3
//    launches the threshold stage and then B4. The function's bound at
//    [4, 800, 1280]: 4.1 MB in and 20.5 MB out (B3), 4.1 MB in and 16.4 MB
//    out (B4), at 3.35 TB/s about 7.3 and 6.1 us. What holds the kernels
//    back is the rounds: one int32 label page is 16 MB there, two of them
//    and the connectivity bytes are 37 MB, which neither a block's shared
//    memory nor (together with the caller's pages) the 50 MB L2 holds, so
//    each of a round's two passes streams 37 MB. ccl::label keeps that to
//    the 18 B/px a round needs (fused neighbor-min + row pass, column pass
//    on shared-memory strips, one connectivity byte a pixel) and, like the
//    Pallas loop, ends a frame's rounds at its fixed point: the bench scene
//    runs 6 of its 12.
//
// B5 chalkydri_threshold_ccl_exact replaces
//    chalkydri_tpu/ops/pallas/ccl_kernel.py::threshold_ccl_blocked:
//    threshold + labels at the GLOBAL fixed point, each component labelled
//    ry * wp + rx, where (ry, rx) is its first pixel in raster order and
//    wp = ceil(W / 128) * 128 (a flat index in the lane-padded frame).
//    The TPU splits a 2 M-px frame into row blocks only because its live
//    set exceeds VMEM, then merges the seams until a certified fixed
//    point. Here every page is device memory, so this computes the fixed
//    point directly: threshold with the shared tile kernels, then the
//    lock-free union-find of union_find.cuh (shared with B6), whose root
//    walk writes (r / W) * wp + r % W for root r (kInvalid on skip pixels).
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

#include "union_find.cuh"

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
// [B, H, W] int32 after `iters` rounds, and in flags[0 .. B) the rounds
// each frame ran before its fixed point stopped it. Scratch: bits
// [B, H, W] u8, scratch [B, H, W] int32, flags [(iters + 1) * B] int32.
extern "C" int chalkydri_label_components(const uint8_t* tern, int B, int H,
                                          int W, int iters, uint8_t* bits,
                                          int32_t* labels, int32_t* scratch,
                                          int32_t* flags, void* stream) {
  return ccl::label(tern, B, H, W, iters, bits, labels, scratch, flags,
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
  return ccl::label_exact(tern, B, H, W, wp, parent, labels, s);
}
