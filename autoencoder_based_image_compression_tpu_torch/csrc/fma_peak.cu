// The fp32 FMA rate the card sustains: 16 independent chains a thread, one
// fresh register operand an FMA, no memory traffic. A yardstick for the fp32
// GDN kernels of gdn.cu (eval/kernel_probe.py), used by no path.

#include <cuda_runtime.h>

namespace {

constexpr int kChains = 16;
constexpr int kRounds = 8;

__global__ void fma_peak_kernel(float* out, int iters) {
  float a[kChains];
  const float s = threadIdx.x * 1e-9f;
  const float g = 1.0001f;
#pragma unroll
  for (int i = 0; i < kChains; ++i) a[i] = static_cast<float>(i);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
#pragma unroll
      for (int i = 0; i < kChains; ++i) a[i] = fmaf(a[i], g, s);
    }
  }
  float total = 0.0f;
#pragma unroll
  for (int i = 0; i < kChains; ++i) total += a[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = total;
}

}  // namespace

extern "C" {

// Launches blocks x threads threads, each doing iters * 128 FMAs; `out` holds
// blocks * threads floats. Returns the cudaError_t of the launch.
int aeic_fma_peak(float* out, int blocks, int threads, int iters, void* stream) {
  fma_peak_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}

int aeic_fma_peak_fmas_per_iter() { return kChains * kRounds; }

}  // extern "C"
