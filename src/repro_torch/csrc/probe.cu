// A minimal kernel for measuring the card's fixed costs: chip_smoke.py's
// cost phase launches it back to back, eagerly (the host's dispatch cost
// a launch) and replayed in a CUDA graph (the device's cost of one more
// launch), and writes the medians into hardware.H100_SXM's launch_s and
// host_dispatch_s. It replaces no TPU kernel and no serving path runs it.
#include "common.cuh"

__global__ void probe_noop_kernel(int* out) {
  if (out != nullptr && threadIdx.x == 0 && blockIdx.x == 0) out[0] = 1;
}

REPRO_ERROR_STRING_FN

// Launches `n` one-block noop kernels on `stream`, back to back; `out`
// (may be null) gets one int written by each.
REPRO_EXPORT int probe_noop(void* out, int n, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < n; ++i) {
    probe_noop_kernel<<<1, 32, 0, s>>>(static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
