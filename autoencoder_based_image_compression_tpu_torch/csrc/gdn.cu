// GDN / IGDN and fused GDN + per-channel quantisation for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the reference package,
// autoencoder_based_image_compression_tpu/ops/pallas/gdn_kernel.py:
//   _gdn_kernel           (entry gdn_pallas_2d)          -> gdn_f32_kernel<RM, inverse, false>
//                                                           gdn_bf16_kernel<inverse>
//       with a model axis (the JAX ladder's vmap of it)     -> gdn_f32_kernel<RM, inverse, false, true>
//   _gdn_quantize_kernel  (entry gdn_quantize_pallas_2d) -> gdn_f32_kernel<RM, inverse, true>
//
// Per row of a (rows, 128) channels-last matrix:
//   pool_c = sum_k (x_k * x_k) * gamma[k, c] + beta_c
//   y_c    = x_c / sqrt(pool_c)  (GDN)   or   x_c * sqrt(pool_c)  (IGDN)
//   out_c  = y_c, or bw_c * rint(y_c / bw_c) with the quantiser.
// fp32 input: exact fp32 products, fp32 accumulation in order of k.
// bf16 input: the square and gamma are rounded to bf16 (their products are
// exact in fp32), the pool accumulates in fp32, sqrt and scaling run in fp32
// and the result is rounded to bf16: the reference's gdn_lowp semantics.
//
// What bounds each variant on the card. The work is a (rows x 128) by
// (128 x 128) product, 2 * 128^2 flops a row, against 2 * 128 * sizeof(T)
// bytes a row.
// - fp32: the contraction must stay exact fp32, so it runs as CUDA-core FMAs
//   (67 TFLOP/s on an H100 SXM): 0.49 ns a row against 0.31 ns for its bytes
//   at 3.35 TB/s. Bound by operations, with the bytes close behind: the two
//   must overlap.
// - bf16: the operands are what the tensor cores take (989 TFLOP/s), so the
//   contraction is cheap and the 512 bytes a row bound it.
// - fused quantiser: same as fp32; at the bottleneck's row count (6,144 for a
//   4 x 512 x 768 batch) its bound is below the cost of a launch, and the
//   prologue (64 KB of gamma a block) decides its time.
//
// Design, fp32 (gdn_f32_kernel): a register-tiled SGEMM with the square as
// its prologue and beta, sqrt, the scaling (and the quantiser) as its
// epilogue. gamma (64 KB) is loaded once a block by cp.async. Each of the 8
// warps of a block then walks its own tiles of 2 * RM rows by 128 channels and
// waits on nobody else: lane (ty, tx) owns rows ty + 2 * i and channels
// 4 * tx .. + 3 and 64 + 4 * tx .. + 3, RM x 8 accumulators. Per 4 steps of k
// it makes RM float4 loads of x (squared in registers) and 8 of gamma for
// 32 * RM FMAs, fetched one step ahead. The staged rows are padded to 132
// words, so the two rows a warp reads fall into different banks. Warps are
// persistent: the next tile's raw x arrives by cp.async (16 bytes a lane, a
// row a step) in a second buffer while the current one is contracted, and the
// epilogue reads x back from the staged tile and stores 16 bytes a lane.
// Every accumulator sums its 128 terms in order of k with fmaf. The wrapper
// picks RM (block tiles of 128, 64 or 32 rows) from the row count so that the
// busiest SM gets the fewest rows. What is left: the FMA stream of the
// compiled loop runs at about 72 % of the card's measured FMA rate even with
// no load in it (eval/kernel_probe.py), and the IEEE sqrt and division of the
// epilogue take scheduler slots from it.
//
// Design, bf16 (gdn_bf16_kernel): the contraction runs on the tensor cores,
// mma.sync.m16n8k16 (bf16 x bf16 -> fp32). gamma sits in shared memory once a
// block, rounded to bf16 ([k][c], rows padded to 272 bytes so ldmatrix is free
// of bank conflicts; ldmatrix.trans turns it into the B fragments). Each of
// the 8 warps of a block walks its own 16-row tiles: cp.async stages the raw
// tile (double-buffered, a warp waits only on itself), ldmatrix gives the A
// fragments, __hmul2 squares them (one rounding to bf16, as the plain
// version's x * x), and the raw A fragments are kept: they are x in the
// accumulator's layout, which is what the epilogue needs. The epilogue takes sqrt / rsqrt from the special
// function unit (the result is rounded to bf16 right after; the reference
// takes rsqrt too); with the IEEE sequences it, not the bytes, set the time.
// Results go back through the warp's staged tile and leave as 16-byte stores.
//
// Design, fp32 with a model axis (gdn_f32_kernel<..., kStacked = true>): the
// gamma ladder's M models share a batch, so a grouped conv leaves their
// activations side by side, (rows, M, 128) channels-last. blockIdx.y is the
// model: a block loads that model's gamma and beta once and walks that
// model's row tiles with a row stride of M * 128 floats; gridDim.x blocks
// serve each model. Every row's arithmetic is that of the single-model
// kernel, so one model of a stacked call equals the single-model kernel on
// the same rows bit for bit.
//
// The ragged row tail is zero-filled on load and masked on store; there is no
// padding copy. The quantiser divides with IEEE '/' and rounds half to even
// with rintf, matching jnp.round; build without --use_fast_math.
//
// The same library holds the phase marks of a graphed training step
// (aeic_mark_*, section "marks" below). They replace no TPU kernel: a
// replayed CUDA graph replays no host range, so a phase boundary that a
// device trace is to show has to be a kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kChannels = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  // Copies 16 bytes; src_bytes == 0 reads nothing and fills zeros.
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// ---------------------------------------------------------------- fp32 ----

constexpr int kXStride = kChannels + 4;  // words a staged fp32 row takes
// A lane owns kQuads groups of 4 channels, kQuadStep apart, in RM rows.
constexpr int kQuads = 2;
constexpr int kQuadStep = kChannels / kQuads;
constexpr int kLanesX = kQuadStep / 4;  // lanes across the channels
constexpr int kLanesY = 32 / kLanesX;   // lanes across the rows

constexpr int f32_smem_bytes(int warp_rows) {
  return (kChannels * kChannels + kWarps * 2 * warp_rows * kXStride) *
         static_cast<int>(sizeof(float));
}

__device__ __forceinline__ void fma_row(float (&acc)[4 * kQuads], float s,
                                        const float4 (&g)[kQuads]) {
#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
    acc[4 * q + 0] = fmaf(s, g[q].x, acc[4 * q + 0]);
    acc[4 * q + 1] = fmaf(s, g[q].y, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(s, g[q].z, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(s, g[q].w, acc[4 * q + 3]);
  }
}

__device__ __forceinline__ void load_gamma(float4 (&g)[kQuads], const float* row) {
#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
    g[q] = *reinterpret_cast<const float4*>(row + q * kQuadStep);
  }
}

// GDN_PROBE_* take one part out of the fp32 kernel each, for timing only
// (eval/kernel_probe.py); a library built with any of them computes nonsense.

// The k whose operands a step of the contraction fetches. The probe fetches
// those of k = 0 every time, so that the loads leave the loop.
__device__ __forceinline__ int operand_k(int k) {
#ifdef GDN_PROBE_NO_SHARED_LOADS
  return 0;
#else
  return k;
#endif
}

template <bool kInverse, bool kQuantize>
__device__ __forceinline__ float finish(float x, float pool, float bw) {
#ifdef GDN_PROBE_NO_EPILOGUE
  return x + pool;
#endif
  const float root = sqrtf(pool);
  float y = kInverse ? x * root : x * (1.0f / root);
  if (kQuantize) y = bw * rintf(y / bw);
  return y;
}

template <int RM, bool kInverse, bool kQuantize, bool kStacked = false>
__global__ void __launch_bounds__(kThreads, RM <= 2 ? 2 : 1)
gdn_f32_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, const float* __restrict__ bin_widths,
               float* __restrict__ out, int64_t rows) {
  constexpr int kWarpRows = kLanesY * RM;  // rows of one warp's tile
  // Floats between two rows: one model's 128 channels, or all M models'.
  const int64_t row_stride = kStacked ? static_cast<int64_t>(gridDim.y) * kChannels : kChannels;
  if (kStacked) {  // this block's model
    x += static_cast<int64_t>(blockIdx.y) * kChannels;
    out += static_cast<int64_t>(blockIdx.y) * kChannels;
    gamma += static_cast<int64_t>(blockIdx.y) * kChannels * kChannels;
    beta += static_cast<int64_t>(blockIdx.y) * kChannels;
  }
  extern __shared__ float4 smem[];
  float* gam = reinterpret_cast<float*>(smem);  // [k][c]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = lane % kLanesX;  // channels 4 * tx + kQuadStep * q .. + 3
  const int ty = lane / kLanesX;  // rows ty + kLanesY * i of the warp's tile
  // This warp's two staged tiles: [2][kWarpRows][kXStride].
  float* xw = gam + kChannels * kChannels + warp * 2 * kWarpRows * kXStride;

  for (int i = tid; i < kChannels * kChannels / 4; i += kThreads) {
    cp_async16(gam + 4 * i, gamma + 4 * i, 16);
  }
  auto load_tile = [&](int buf, int64_t tile) {
    float* dst = xw + buf * kWarpRows * kXStride;
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r) {  // one row of 512 bytes a step
      const int64_t row = tile * kWarpRows + r;
      const bool valid = row < rows;
      cp_async16(dst + r * kXStride + 4 * lane, valid ? x + row * row_stride + 4 * lane : x,
                 valid ? 16 : 0);
    }
  };
  const int64_t num_tiles = (rows + kWarpRows - 1) / kWarpRows;
  const int64_t tile_stride = static_cast<int64_t>(gridDim.x) * kWarps;
  int64_t tile = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (tile < num_tiles) load_tile(0, tile);
  cp_async_commit();

  float4 beta_q[kQuads];
  float4 bw_q[kQuads];
#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
    beta_q[q] = *reinterpret_cast<const float4*>(beta + 4 * tx + kQuadStep * q);
    bw_q[q] = kQuantize
                  ? *reinterpret_cast<const float4*>(bin_widths + 4 * tx + kQuadStep * q)
                  : make_float4(1.0f, 1.0f, 1.0f, 1.0f);
  }
  cp_async_wait<0>();
  __syncthreads();  // gamma is in place; from here on a warp waits only on itself

  const float* g_base = gam + 4 * tx;
  for (int buf = 0; tile < num_tiles; tile += tile_stride, buf ^= 1) {
    const int64_t next = tile + tile_stride;
#ifndef GDN_PROBE_NO_PREFETCH
    if (next < num_tiles) load_tile(buf ^ 1, next);
#endif
    cp_async_commit();   // possibly empty, so that one group is always pending
    cp_async_wait<1>();  // this tile has landed
    __syncwarp();

    const float* xs = xw + buf * kWarpRows * kXStride + ty * kXStride;
    float acc[RM][4 * kQuads];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int j = 0; j < 4 * kQuads; ++j) acc[i][j] = 0.0f;
    }
    // Operands are fetched one step ahead of the FMAs that use them; the
    // last step's fetches wrap round to k = 0 and are dropped.
    float4 s[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      s[i] = *reinterpret_cast<const float4*>(xs + kLanesY * i * kXStride);
    }
    float4 g[kQuads];
    float4 h[kQuads];
    load_gamma(g, g_base);
#pragma unroll 2
    for (int k = 0; k < kChannels; k += 4) {
      const int kn = operand_k((k + 4) & (kChannels - 1));
      float4 sn[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        sn[i] = *reinterpret_cast<const float4*>(xs + kLanesY * i * kXStride + kn);
#ifndef GDN_PROBE_NO_SQUARE
        s[i].x *= s[i].x;
        s[i].y *= s[i].y;
        s[i].z *= s[i].z;
        s[i].w *= s[i].w;
#endif
      }
      load_gamma(h, g_base + operand_k(k + 1) * kChannels);
#pragma unroll
      for (int i = 0; i < RM; ++i) fma_row(acc[i], s[i].x, g);
      load_gamma(g, g_base + operand_k(k + 2) * kChannels);
#pragma unroll
      for (int i = 0; i < RM; ++i) fma_row(acc[i], s[i].y, h);
      load_gamma(h, g_base + operand_k(k + 3) * kChannels);
#pragma unroll
      for (int i = 0; i < RM; ++i) fma_row(acc[i], s[i].z, g);
      load_gamma(g, g_base + kn * kChannels);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        fma_row(acc[i], s[i].w, h);
        s[i] = sn[i];
      }
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int64_t row = tile * kWarpRows + ty + kLanesY * i;
      if (row < rows) {
#pragma unroll
        for (int q = 0; q < kQuads; ++q) {
          const int c = 4 * tx + kQuadStep * q;
          const float4 xv = *reinterpret_cast<const float4*>(xs + kLanesY * i * kXStride + c);
          float4 y;
          y.x = finish<kInverse, kQuantize>(xv.x, acc[i][4 * q + 0] + beta_q[q].x, bw_q[q].x);
          y.y = finish<kInverse, kQuantize>(xv.y, acc[i][4 * q + 1] + beta_q[q].y, bw_q[q].y);
          y.z = finish<kInverse, kQuantize>(xv.z, acc[i][4 * q + 2] + beta_q[q].z, bw_q[q].z);
          y.w = finish<kInverse, kQuantize>(xv.w, acc[i][4 * q + 3] + beta_q[q].w, bw_q[q].w);
          *reinterpret_cast<float4*>(out + row * row_stride + c) = y;
        }
      }
    }
    __syncwarp();  // the next iteration's loads overwrite this buffer
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------- bf16 ----

constexpr int kMmaRows = 16;            // rows of one mma tile
constexpr int kHStride = kChannels + 8;  // bf16 elements a staged row takes (272 bytes)
constexpr int kBf16SmemBytes =
    kChannels * kHStride * 2 + kChannels * 4 + kWarps * 2 * kMmaRows * kHStride * 2;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t square_bf16x2(uint32_t v) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  h = __hmul2(h, h);
  return *reinterpret_cast<uint32_t*>(&h);
}

// sqrt or rsqrt of the pool by the special-function unit (relative error
// about 2^-22): the result is rounded to bf16 (2^-9) right after, and the
// IEEE sequences would be most of what this variant executes.
template <bool kInverse>
__device__ __forceinline__ float scale_approx(float pool) {
  float scale;
  if (kInverse) {
    asm("sqrt.approx.f32 %0, %1;\n" : "=f"(scale) : "f"(pool));
  } else {
    asm("rsqrt.approx.f32 %0, %1;\n" : "=f"(scale) : "f"(pool));
  }
  return scale;
}

template <bool kInverse>
__device__ __forceinline__ uint32_t finish_bf16x2(uint32_t x, float pool0, float pool1) {
  const float2 xf = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
  __nv_bfloat162 y = __floats2bfloat162_rn(xf.x * scale_approx<kInverse>(pool0),
                                           xf.y * scale_approx<kInverse>(pool1));
  return *reinterpret_cast<uint32_t*>(&y);
}

template <bool kInverse>
__global__ void __launch_bounds__(kThreads, 2)
gdn_bf16_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta, __nv_bfloat16* __restrict__ out,
                int64_t rows) {
  extern __shared__ float4 smem[];
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(smem);  // gamma: [k][c]
  float* beta_s = reinterpret_cast<float*>(gs + kChannels * kHStride);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // This warp's two staged tiles: [2][kMmaRows][kHStride].
  __nv_bfloat16* xw = reinterpret_cast<__nv_bfloat16*>(beta_s + kChannels) +
                      warp * 2 * kMmaRows * kHStride;

  auto load_tile = [&](int buf, int64_t tile) {
    __nv_bfloat16* dst = xw + buf * kMmaRows * kHStride;
    for (int i = lane; i < kMmaRows * (kChannels / 8); i += 32) {
      const int r = i >> 4;
      const int q = i & 15;
      const int64_t row = tile * kMmaRows + r;
      const bool valid = row < rows;
      cp_async16(dst + r * kHStride + 8 * q, valid ? x + row * kChannels + 8 * q : x,
                 valid ? 16 : 0);
    }
  };
  const int64_t num_tiles = (rows + kMmaRows - 1) / kMmaRows;
  const int64_t tile_stride = static_cast<int64_t>(gridDim.x) * kWarps;
  int64_t tile = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (tile < num_tiles) load_tile(0, tile);
  cp_async_commit();

  // gamma rounded to bf16, [k][c] as in device memory: 16 bytes in, 8 out.
  for (int i = tid; i < kChannels * kChannels / 4; i += kThreads) {
    const int k = i >> 5;
    const int c = 4 * (i & 31);
    const float4 g = *reinterpret_cast<const float4*>(gamma + k * kChannels + c);
    __nv_bfloat162 lo = __floats2bfloat162_rn(g.x, g.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(g.z, g.w);
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&lo);
    packed.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(gs + k * kHStride + c) = packed;
  }
  if (tid < kChannels) beta_s[tid] = beta[tid];
  __syncthreads();

  const int group = lane >> 2;  // the accumulator's rows: group and group + 8
  const int tig = lane & 3;     // its columns: 8 * j + 2 * tig, + 1
  for (int buf = 0; tile < num_tiles; tile += tile_stride, buf ^= 1) {
    const int64_t next = tile + tile_stride;
    if (next < num_tiles) load_tile(buf ^ 1, next);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();

    __nv_bfloat16* xs = xw + buf * kMmaRows * kHStride;
    float acc[16][4];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
    }
    uint32_t xa[8][4];  // raw x as A fragments: x in the accumulator's layout
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      ldmatrix_x4(xa[ks], xs + (lane & 15) * kHStride + 16 * ks + 8 * (lane >> 4));
      uint32_t a[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = square_bf16x2(xa[ks][e]);
#pragma unroll
      for (int jp = 0; jp < 8; ++jp) {
        // Four 8x8 pieces of gamma, transposed on the way: channel tiles
        // 2 * jp and 2 * jp + 1, each with the low and the high half of
        // this step's 16 k.
        uint32_t b[4];
        ldmatrix_x4_trans(b, gs + (16 * ks + 8 * ((lane >> 3) & 1) + (lane & 7)) * kHStride +
                                 8 * (2 * jp + (lane >> 4)));
        mma_bf16(acc[2 * jp], a, b[0], b[1]);
        mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
      }
    }
    __syncwarp();  // every lane has read the raw tile; results overwrite it

#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * tig;
      const float2 b = *reinterpret_cast<const float2*>(beta_s + col);
      const uint32_t lo = finish_bf16x2<kInverse>(xa[j >> 1][2 * (j & 1)], acc[j][0] + b.x,
                                                  acc[j][1] + b.y);
      const uint32_t hi = finish_bf16x2<kInverse>(xa[j >> 1][2 * (j & 1) + 1],
                                                  acc[j][2] + b.x, acc[j][3] + b.y);
      *reinterpret_cast<uint32_t*>(xs + group * kHStride + col) = lo;
      *reinterpret_cast<uint32_t*>(xs + (group + 8) * kHStride + col) = hi;
    }
    __syncwarp();
    for (int i = lane; i < kMmaRows * (kChannels / 8); i += 32) {
      const int r = i >> 4;
      const int q = i & 15;
      const int64_t row = tile * kMmaRows + r;
      if (row < rows) {
        *reinterpret_cast<uint4*>(out + row * kChannels + 8 * q) =
            *reinterpret_cast<const uint4*>(xs + r * kHStride + 8 * q);
      }
    }
    __syncwarp();  // the next iteration's loads overwrite this buffer
  }
  cp_async_wait<0>();
}

// -------------------------------------------------------------- launch ----

// Launches `kernel` over `num_blocks_wanted` blocks at most for each of
// `models` models (gridDim.y), capped at the blocks resident on the whole
// card (the kernels are persistent).
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int smem_bytes, int* max_grid, int64_t num_blocks_wanted,
           int models, void* stream, Args... args) {
  if (*max_grid == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    int device = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                        smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    *max_grid = sms * std::max(per_sm, 1);
  }
  if (num_blocks_wanted <= 0 || models <= 0) return 0;
  if (models > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(
                      std::min<int64_t>(num_blocks_wanted, std::max(*max_grid / models, 1))),
                  static_cast<unsigned>(models));
  kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// A block tile of kTileRows rows: each warp's tile is an eighth of it.
// `rows` counts the rows of one model.
template <int kTileRows, bool kInverse, bool kQuantize, bool kStacked>
int launch_f32(const void* x, const void* gamma, const void* beta, const void* bin_widths,
               void* out, int64_t rows, int models, void* stream) {
  static int max_grid = 0;  // resident blocks on the whole card
  constexpr int RM = kTileRows / kWarps / kLanesY;
  return launch(gdn_f32_kernel<RM, kInverse, kQuantize, kStacked>,
                f32_smem_bytes(kTileRows / kWarps), &max_grid,
                (rows + kTileRows - 1) / kTileRows, models, stream,
                static_cast<const float*>(x), static_cast<const float*>(gamma),
                static_cast<const float*>(beta), static_cast<const float*>(bin_widths),
                static_cast<float*>(out), rows);
}

template <bool kInverse, bool kQuantize, bool kStacked = false>
int launch_f32_tiled(const void* x, const void* gamma, const void* beta,
                     const void* bin_widths, void* out, int64_t rows, int tile_rows,
                     void* stream, int models = 1) {
  switch (tile_rows) {
    case 128:
      return launch_f32<128, kInverse, kQuantize, kStacked>(x, gamma, beta, bin_widths, out,
                                                            rows, models, stream);
    case 64:
      return launch_f32<64, kInverse, kQuantize, kStacked>(x, gamma, beta, bin_widths, out,
                                                           rows, models, stream);
    case 32:
      return launch_f32<32, kInverse, kQuantize, kStacked>(x, gamma, beta, bin_widths, out,
                                                           rows, models, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kInverse>
int launch_bf16(const void* x, const void* gamma, const void* beta, void* out, int64_t rows,
                void* stream) {
  static int max_grid = 0;
  constexpr int kBlockRows = kWarps * kMmaRows;
  return launch(gdn_bf16_kernel<kInverse>, kBf16SmemBytes, &max_grid,
                (rows + kBlockRows - 1) / kBlockRows, 1, stream,
                static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
                static_cast<const float*>(beta), static_cast<__nv_bfloat16*>(out), rows);
}

// ---------------------------------------------------------------- marks ----
//
// Phase marks of a training step captured in a CUDA graph. A range the host
// opens while the step is captured is never replayed, so each phase boundary
// is a kernel of its own, in every replay: one thread that writes the card's
// %globaltimer (ns) into stamps[step * slots + slot], `step` read from the
// epoch's device step counter. Each mark has its own kernel name, so that a
// device trace shows where every phase of every replayed step begins without
// the program's help. A counter outside [0, rows) writes nothing.

__device__ __forceinline__ void stamp(long long* stamps, const long long* counter,
                                      long long rows, int slots, int slot) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const long long step = *counter;
  if (step >= 0 && step < rows) stamps[step * slots + slot] = static_cast<long long>(now);
}

}  // namespace

#define AEIC_MARK_KERNEL(name)                                                   \
  extern "C" __global__ void name(long long* stamps, const long long* counter,   \
                                  long long rows, int slots, int slot) {         \
    stamp(stamps, counter, rows, slots, slot);                                   \
  }

AEIC_MARK_KERNEL(aeic_mark_step)
AEIC_MARK_KERNEL(aeic_mark_density)
AEIC_MARK_KERNEL(aeic_mark_forward)
AEIC_MARK_KERNEL(aeic_mark_backward)
AEIC_MARK_KERNEL(aeic_mark_optimizer)
AEIC_MARK_KERNEL(aeic_mark_step_end)
AEIC_MARK_KERNEL(aeic_mark_gdn_backward_begin)
AEIC_MARK_KERNEL(aeic_mark_gdn_backward_end)
AEIC_MARK_KERNEL(aeic_mark_entropy)
AEIC_MARK_KERNEL(aeic_mark_synthesis)

namespace {

using MarkKernel = void (*)(long long*, const long long*, long long, int, int);

struct Mark {
  const char* name;
  MarkKernel kernel;
};

const Mark kMarks[] = {
    {"aeic_mark_step", aeic_mark_step},
    {"aeic_mark_density", aeic_mark_density},
    {"aeic_mark_forward", aeic_mark_forward},
    {"aeic_mark_backward", aeic_mark_backward},
    {"aeic_mark_optimizer", aeic_mark_optimizer},
    {"aeic_mark_step_end", aeic_mark_step_end},
    {"aeic_mark_gdn_backward_begin", aeic_mark_gdn_backward_begin},
    {"aeic_mark_gdn_backward_end", aeic_mark_gdn_backward_end},
    {"aeic_mark_entropy", aeic_mark_entropy},
    {"aeic_mark_synthesis", aeic_mark_synthesis},
};
constexpr int kNumMarks = sizeof(kMarks) / sizeof(kMarks[0]);

}  // namespace

extern "C" {

// Each entry launches on `stream` (a cudaStream_t) and returns the
// cudaError_t of the launch (0 on success). Pointers are device pointers to
// C-contiguous, 16-byte aligned buffers: x and out (rows, 128), gamma
// (128, 128) fp32 indexed [k][c], beta and bin_widths (128,) fp32.
// `tile_rows` is the fp32 kernels' tile height: 128, 64 or 32.
// aeic_gdn_f32_stacked takes `models` models at once: x and out are
// (rows, models, 128), gamma (models, 128, 128) and beta (models, 128).

int aeic_gdn_f32(const void* x, const void* gamma, const void* beta, void* out,
                 int64_t rows, int inverse, int tile_rows, void* stream) {
  return inverse ? launch_f32_tiled<true, false>(x, gamma, beta, nullptr, out, rows,
                                                 tile_rows, stream)
                 : launch_f32_tiled<false, false>(x, gamma, beta, nullptr, out, rows,
                                                  tile_rows, stream);
}

int aeic_gdn_f32_stacked(const void* x, const void* gamma, const void* beta, void* out,
                         int64_t rows, int models, int inverse, int tile_rows, void* stream) {
  return inverse ? launch_f32_tiled<true, false, true>(x, gamma, beta, nullptr, out, rows,
                                                       tile_rows, stream, models)
                 : launch_f32_tiled<false, false, true>(x, gamma, beta, nullptr, out, rows,
                                                        tile_rows, stream, models);
}

int aeic_gdn_bf16(const void* x, const void* gamma, const void* beta, void* out,
                  int64_t rows, int inverse, void* stream) {
  return inverse ? launch_bf16<true>(x, gamma, beta, out, rows, stream)
                 : launch_bf16<false>(x, gamma, beta, out, rows, stream);
}

int aeic_gdn_quantize_f32(const void* x, const void* gamma, const void* beta,
                          const void* bin_widths, void* out, int64_t rows, int inverse,
                          int tile_rows, void* stream) {
  return inverse ? launch_f32_tiled<true, true>(x, gamma, beta, bin_widths, out, rows,
                                                tile_rows, stream)
                 : launch_f32_tiled<false, true>(x, gamma, beta, bin_widths, out, rows,
                                                 tile_rows, stream);
}

// The phase marks: aeic_mark_count() kernels, mark `which` named
// aeic_mark_name(which). aeic_mark launches one on `stream`: stamps is a
// (rows, slots) int64 device buffer, counter one int64 on the device.
int aeic_mark_count() { return kNumMarks; }

const char* aeic_mark_name(int which) {
  return which >= 0 && which < kNumMarks ? kMarks[which].name : nullptr;
}

int aeic_mark(int which, void* stamps, const void* counter, int64_t rows, int slots, int slot,
              void* stream) {
  if (which < 0 || which >= kNumMarks || slot < 0 || slot >= slots) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long* stamps_arg = static_cast<long long*>(stamps);
  const long long* counter_arg = static_cast<const long long*>(counter);
  long long rows_arg = rows;
  void* args[] = {&stamps_arg, &counter_arg, &rows_arg, &slots, &slot};
  return static_cast<int>(cudaLaunchKernel(reinterpret_cast<const void*>(kMarks[which].kernel),
                                           dim3(1), dim3(1), args, 0,
                                           static_cast<cudaStream_t>(stream)));
}

const char* aeic_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
