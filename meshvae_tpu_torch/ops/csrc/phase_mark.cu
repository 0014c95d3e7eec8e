// Phase marks of the scanned epoch's steps (train/phases.py).
//
// One thread writes the device's %globaltimer (nanoseconds) into
// stamps[*step * slots + slot]. The step index is read on the device, so a
// CUDA graph that captured the launch writes row `step` of the staged
// [S, slots] buffer at each replay, where a CUDA event recorded in the
// graph would only keep the last replay's time. Replaces no TPU kernel:
// the JAX package's scanned epoch has no phase split inside its lax.scan.
// Bound by the launch itself (one thread, one 8-byte store).
#include <cuda_runtime.h>

__global__ void phase_mark_kernel(long long* stamps, const long long* step,
                                  int slots, int slot) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  stamps[*step * slots + slot] = static_cast<long long>(now);
}

extern "C" int phase_mark(void* stamps, const void* step, int slots,
                          int slot, void* stream) {
  phase_mark_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(stamps), static_cast<const long long*>(step),
      slots, slot);
  return static_cast<int>(cudaGetLastError());
}
