// The card's nanosecond clock into one slot of a buffer: the stage stamps
// of the vision step (chalkydri_tpu_torch/utils/tracing.py).
//
// One thread reads %globaltimer and stores it. In stream order it runs once
// every kernel before it has ended, so slot i - slot i-1 is the device time
// of the stage between two stamps; inside a captured CUDA graph each
// replay writes its own times. The kernel is named so that no roofline
// reader's pattern (benchmark/rooflines/) matches it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void stage_stamp_kernel(int64_t* out, int slot) {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  out[slot] = (int64_t)t;
}

}  // namespace

extern "C" int chalkydri_stage_stamp(int64_t* out, int slot, void* stream) {
  stage_stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(out, slot);
  return (int)cudaGetLastError();
}
