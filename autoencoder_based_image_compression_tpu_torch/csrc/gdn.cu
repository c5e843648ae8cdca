// GDN / IGDN and fused GDN + per-channel quantisation for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the reference package,
// autoencoder_based_image_compression_tpu/ops/pallas/gdn_kernel.py:
//   _gdn_kernel           (entry gdn_pallas_2d)          -> gdn_kernel<T, inverse, false>
//   _gdn_quantize_kernel  (entry gdn_quantize_pallas_2d) -> gdn_kernel<float, inverse, true>
//
// Per row of a (rows, 128) channels-last matrix:
//   pool_c = sum_k (x_k * x_k) * gamma[k, c] + beta_c
//   y_c    = x_c / sqrt(pool_c)  (GDN)   or   x_c * sqrt(pool_c)  (IGDN)
//   out_c  = y_c, or bw_c * rint(y_c / bw_c) with the quantiser.
// fp32 input: exact fp32 products, fp32 accumulation.
// bf16 input: the square and gamma are rounded to bf16 (their products are
// exact in fp32), the pool accumulates in fp32, sqrt and scaling run in fp32
// and the result is rounded to bf16: the reference's gdn_lowp semantics.
//
// What bounds it on the card: the 128-deep channel contraction is
// 2 * 128^2 flops per row against 2 * 128 * sizeof(T) bytes moved, i.e.
// 128 flops/byte in fp32. That contraction must stay exact fp32 on the fp32
// path, so it runs as CUDA-core FMAs (67 TFLOP/s on an H100 SXM) and the
// fp32 kernels are bound by operations, not by the 3.35 TB/s of HBM.
//
// Design: one block of 128 threads, thread c owns output channel c. gamma
// (64 KB fp32) is loaded once per block into shared memory; blocks stride
// over 32-row tiles so that load is amortised. Each tile's squares sit in
// shared memory, read back as float4 broadcasts: every shared load feeds
// four FMAs per row. Loads and stores are coalesced (consecutive threads,
// consecutive channels). The ragged row tail is masked; there is no padding
// copy. The quantiser divides with IEEE '/' and rounds half to even with
// rintf, matching jnp.round; build without --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kChannels = 128;
constexpr int kTileRows = 32;
constexpr int kThreads = kChannels;
constexpr int kSmemBytes =
    (kChannels * kChannels + kTileRows * kChannels) * static_cast<int>(sizeof(float));

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Rounds an fp32 value to the precision of T (identity for fp32).
template <typename T>
__device__ __forceinline__ float round_to(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T, bool kInverse, bool kQuantize>
__global__ void __launch_bounds__(kThreads)
gdn_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
           const float* __restrict__ beta, const float* __restrict__ bin_widths,
           T* __restrict__ out, int64_t rows) {
  extern __shared__ float4 smem[];
  float* gam = reinterpret_cast<float*>(smem);  // [k][c]
  float* sq = gam + kChannels * kChannels;      // [r][k]
  const int c = threadIdx.x;

  for (int i = c; i < kChannels * kChannels; i += kThreads) {
    gam[i] = round_to<T>(gamma[i]);
  }
  const float beta_c = beta[c];
  const float bw_c = kQuantize ? bin_widths[c] : 1.0f;

  const int64_t num_tiles = (rows + kTileRows - 1) / kTileRows;
  for (int64_t tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int64_t row0 = tile * kTileRows;
    float xv[kTileRows];
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      const int64_t row = row0 + r;
      const float v = row < rows ? to_float(x[row * kChannels + c]) : 0.0f;
      xv[r] = v;
      sq[r * kChannels + c] = round_to<T>(v * v);
    }
    __syncthreads();  // squares (and, on the first tile, gamma) visible

    float acc[kTileRows];
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) acc[r] = 0.0f;
#pragma unroll 2
    for (int k = 0; k < kChannels; k += 4) {
      const float g0 = gam[(k + 0) * kChannels + c];
      const float g1 = gam[(k + 1) * kChannels + c];
      const float g2 = gam[(k + 2) * kChannels + c];
      const float g3 = gam[(k + 3) * kChannels + c];
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) {
        const float4 s = *reinterpret_cast<const float4*>(sq + r * kChannels + k);
        acc[r] = fmaf(s.x, g0, acc[r]);
        acc[r] = fmaf(s.y, g1, acc[r]);
        acc[r] = fmaf(s.z, g2, acc[r]);
        acc[r] = fmaf(s.w, g3, acc[r]);
      }
    }

#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      const int64_t row = row0 + r;
      if (row < rows) {
        const float root = sqrtf(acc[r] + beta_c);
        float y = kInverse ? xv[r] * root : xv[r] * (1.0f / root);
        if (kQuantize) y = bw_c * rintf(y / bw_c);
        store(out + row * kChannels + c, y);
      }
    }
    __syncthreads();  // the next tile overwrites the squares
  }
}

template <typename T, bool kInverse, bool kQuantize>
int launch(const void* x, const void* gamma, const void* beta, const void* bin_widths,
           void* out, int64_t rows, void* stream) {
  auto kernel = gdn_kernel<T, kInverse, kQuantize>;
  static int max_grid = 0;  // resident blocks on the whole card
  if (max_grid == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    int device = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                        kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    max_grid = sms * std::max(per_sm, 1);
  }
  if (rows <= 0) return 0;
  const int64_t num_tiles = (rows + kTileRows - 1) / kTileRows;
  const int grid = static_cast<int>(std::min<int64_t>(num_tiles, max_grid));
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const float*>(bin_widths),
      static_cast<T*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry launches on `stream` (a cudaStream_t) and returns the
// cudaError_t of the launch (0 on success). Pointers are device pointers to
// C-contiguous buffers: x and out (rows, 128), gamma (128, 128) fp32 indexed
// [k][c], beta and bin_widths (128,) fp32.

int aeic_gdn_f32(const void* x, const void* gamma, const void* beta, void* out,
                 int64_t rows, int inverse, void* stream) {
  return inverse ? launch<float, true, false>(x, gamma, beta, nullptr, out, rows, stream)
                 : launch<float, false, false>(x, gamma, beta, nullptr, out, rows, stream);
}

int aeic_gdn_bf16(const void* x, const void* gamma, const void* beta, void* out,
                  int64_t rows, int inverse, void* stream) {
  return inverse
             ? launch<__nv_bfloat16, true, false>(x, gamma, beta, nullptr, out, rows, stream)
             : launch<__nv_bfloat16, false, false>(x, gamma, beta, nullptr, out, rows, stream);
}

int aeic_gdn_quantize_f32(const void* x, const void* gamma, const void* beta,
                          const void* bin_widths, void* out, int64_t rows, int inverse,
                          void* stream) {
  return inverse
             ? launch<float, true, true>(x, gamma, beta, bin_widths, out, rows, stream)
             : launch<float, false, true>(x, gamma, beta, bin_widths, out, rows, stream);
}

const char* aeic_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
