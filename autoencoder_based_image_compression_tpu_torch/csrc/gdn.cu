// GDN / IGDN and fused GDN + per-channel quantisation for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the reference package,
// autoencoder_based_image_compression_tpu/ops/pallas/gdn_kernel.py:
//   _gdn_kernel           (entry gdn_pallas_2d)          -> gdn_f32_kernel<C, RM, inverse, false>
//                                                           gdn_bf16_kernel<inverse>
//       with a model axis (the JAX ladder's vmap of it)     -> gdn_f32_kernel<128, RM, inverse, false, true>
//   _gdn_quantize_kernel  (entry gdn_quantize_pallas_2d) -> gdn_f32_kernel<128, RM, inverse, true>
// and adds the fp32 gradient, which replaces no TPU kernel (below):
//                                                        gdn_bwd_f32_kernel<C, RM, inverse>
//                                                        gdn_bwd_reduce_kernel<C>
//
// Per row of a (rows, C) channels-last matrix, C = 128 (every kernel) or
// 192 (the fp32 forward and its gradient, single model only):
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
// The channel count C is the first template argument of the fp32 forward
// and of the gradient pair. Every design below was laid out in quads of 64
// channels (a lane owns 4 channels in each), so C = 192 is three quads
// where 128 is two, and only the tile heights change with it: gamma takes
// C^2 floats of shared memory (64 KB at 128, 144 KB at 192), and the
// staged tiles have to fit beside it in the 227 KB of a block (see
// launch_f32_tiled and bwd_launcher). The 128-channel code is what it was:
// where the arithmetic of an index needs C to be a power of two, C = 128
// keeps its shift and mask and 192 takes a division (if constexpr).
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
// The fp32 gradient (gdn_bwd_f32_kernel<RM, inverse>, gdn_bwd_reduce_kernel)
// replaces no TPU kernel: the reference package differentiates the plain
// einsum, and so did the port's GdnFunction in PyTorch, a chain of three
// GEMMs and a dozen elementwise passes, each a round trip of a (rows, 128)
// tensor, 15-25 % of a training step. Per row, with g the incoming gradient:
//   pool = x^2 @ gamma + beta
//   t    = -0.5 * g * x * pool^-1.5  (GDN)   or   0.5 * g * x * pool^-0.5  (IGDN)
//   grad_x     = g * scale + 2 * x * (t @ gamma^T),  scale = pool^-0.5 or pool^0.5
//   grad_gamma = (x^2)^T @ t,   grad_beta = sum of t over the rows.
// What bounds it: three contractions of 2 * 128^2 flops a row (98,304 a row)
// in exact fp32 on the CUDA cores, against 1.5 KB a row (x and g read,
// grad_x written): 1.47 ns a row against 0.46 ns for its bytes. Bound by
// operations with the bytes close behind, as the forward is.
//
// Design, gradient: one pass over a tile of rows (64, or 32 for small
// sites), its three contractions register-tiled as the forward's, gamma
// (64 KB) loaded once a block. Each warp contracts its own rows: the pool
// (the forward's loop), then in registers t and g * scale, t staged in shared
// memory; then t @ gamma^T against the same copy of gamma, whose 16-byte
// chunks are XOR-swizzled so that a lane reading its four k's column-wise is
// as free of bank conflicts as one reading a row; grad_x is written once.
// x and g arrive by cp.async, double-buffered, and are read from device
// memory once; pool, scale and t never leave the SM. Then the whole block
// adds (x^2)^T t of the tile into grad_gamma, an 8 x 8 block a thread held
// in registers across the tiles the block walks, and t into grad_beta.
// There are no float atomics: each block writes its partial to scratch
// (the tile pass's grid is sized where the forward's is, persistent_grid,
// and aeic_gdn_backward_blocks tells the caller how many partials to hold),
// and gdn_bwd_reduce_kernel sums the partials in a fixed order, so two runs
// (a graph's replay and an eager call) give the same bits. Every sum is
// fmaf in a fixed order; sqrt and division are IEEE. With a model axis
// (blockIdx.y, row stride M * 128) one launch serves the ladder's models;
// one model is a stack of one.
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

constexpr int kChannels = 128;  // the bf16 kernel's, and the default
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

// A lane owns Quads<C> groups of 4 channels, kQuadStep apart, in RM rows.
constexpr int kQuadStep = 64;
constexpr int kLanesX = kQuadStep / 4;  // lanes across the channels
constexpr int kLanesY = 32 / kLanesX;   // lanes across the rows
template <int C>
constexpr int Quads = C / kQuadStep;
template <int C>
constexpr int XStride = C + 4;  // words a staged fp32 row takes

template <int C>
constexpr int f32_smem_bytes(int warp_rows) {
  return (C * C + kWarps * 2 * warp_rows * XStride<C>) * static_cast<int>(sizeof(float));
}

// The k four steps after k, wrapping round to 0 at C.
template <int C>
__device__ __forceinline__ int next_k(int k) {
  if constexpr ((C & (C - 1)) == 0) {
    return (k + 4) & (C - 1);
  } else {
    return k + 4 < C ? k + 4 : 0;
  }
}

template <int Q>
__device__ __forceinline__ void fma_row(float (&acc)[4 * Q], float s, const float4 (&g)[Q]) {
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    acc[4 * q + 0] = fmaf(s, g[q].x, acc[4 * q + 0]);
    acc[4 * q + 1] = fmaf(s, g[q].y, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(s, g[q].z, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(s, g[q].w, acc[4 * q + 3]);
  }
}

template <int Q>
__device__ __forceinline__ void load_gamma(float4 (&g)[Q], const float* row) {
#pragma unroll
  for (int q = 0; q < Q; ++q) {
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

template <int C, int RM, bool kInverse, bool kQuantize, bool kStacked = false>
__global__ void __launch_bounds__(kThreads, RM <= 2 ? 2 : 1)
gdn_f32_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, const float* __restrict__ bin_widths,
               float* __restrict__ out, int64_t rows) {
  constexpr int kQuads = Quads<C>;
  constexpr int kXStride = XStride<C>;
  constexpr int kWarpRows = kLanesY * RM;  // rows of one warp's tile
  // Floats between two rows: one model's C channels, or all M models'.
  const int64_t row_stride = kStacked ? static_cast<int64_t>(gridDim.y) * C : C;
  if (kStacked) {  // this block's model
    x += static_cast<int64_t>(blockIdx.y) * C;
    out += static_cast<int64_t>(blockIdx.y) * C;
    gamma += static_cast<int64_t>(blockIdx.y) * C * C;
    beta += static_cast<int64_t>(blockIdx.y) * C;
  }
  extern __shared__ float4 smem[];
  float* gam = reinterpret_cast<float*>(smem);  // [k][c]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = lane % kLanesX;  // channels 4 * tx + kQuadStep * q .. + 3
  const int ty = lane / kLanesX;  // rows ty + kLanesY * i of the warp's tile
  // This warp's two staged tiles: [2][kWarpRows][kXStride].
  float* xw = gam + C * C + warp * 2 * kWarpRows * kXStride;

  for (int i = tid; i < C * C / 4; i += kThreads) {
    cp_async16(gam + 4 * i, gamma + 4 * i, 16);
  }
  auto load_tile = [&](int buf, int64_t tile) {
    float* dst = xw + buf * kWarpRows * kXStride;
    if constexpr (C == 128) {
#pragma unroll
      for (int r = 0; r < kWarpRows; ++r) {  // one row of 512 bytes a step
        const int64_t row = tile * kWarpRows + r;
        const bool valid = row < rows;
        cp_async16(dst + r * kXStride + 4 * lane, valid ? x + row * row_stride + 4 * lane : x,
                   valid ? 16 : 0);
      }
    } else {
      // 16 bytes a lane a step across the tile's rows of C / 4 chunks.
#pragma unroll
      for (int step = 0; step < kWarpRows * C / 128; ++step) {
        const int chunk = 32 * step + lane;
        const int r = chunk / (C / 4);
        const int q = chunk % (C / 4);
        const int64_t row = tile * kWarpRows + r;
        const bool valid = row < rows;
        cp_async16(dst + r * kXStride + 4 * q, valid ? x + row * row_stride + 4 * q : x,
                   valid ? 16 : 0);
      }
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
    for (int k = 0; k < C; k += 4) {
      const int kn = operand_k(next_k<C>(k));
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
      load_gamma(h, g_base + operand_k(k + 1) * C);
#pragma unroll
      for (int i = 0; i < RM; ++i) fma_row(acc[i], s[i].x, g);
      load_gamma(g, g_base + operand_k(k + 2) * C);
#pragma unroll
      for (int i = 0; i < RM; ++i) fma_row(acc[i], s[i].y, h);
      load_gamma(h, g_base + operand_k(k + 3) * C);
#pragma unroll
      for (int i = 0; i < RM; ++i) fma_row(acc[i], s[i].z, g);
      load_gamma(g, g_base + kn * C);
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

// ------------------------------------------------------------ backward ----

// A block's share of grad_gamma ([k][c]) and grad_beta, summed over the tiles it walks.
template <int C>
constexpr int PartialFloats = C * C + C;

template <int C>
constexpr int bwd_smem_bytes(int tile_rows) {
  // gamma, x and g of the tile double-buffered, t of the tile.
  return (C * C + 5 * tile_rows * C) * static_cast<int>(sizeof(float));
}

// Where gamma[k][4 * chunk .. + 3] sits in shared memory: the 16-byte chunk
// is XORed with (k / 4) % 8, so that a row of gamma (the pool) and the same
// four channels of the rows k = 4 * tx + j of 8 lanes (t @ gamma^T) both
// fall into distinct banks. A row is C / 4 chunks, a multiple of 8, so
// the XOR stays in the row; at C = 192 a row is 768 bytes, a multiple of
// 128 as at 128, and the same swizzle serves.
template <int C>
__device__ __forceinline__ int gamma_at(int k, int chunk) {
  return k * C + 4 * (chunk ^ ((k >> 2) & 7));
}

__device__ __forceinline__ void fma4(float& acc, const float4& a, const float4& b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
}

// t = dL/dpool of one element, and the gradient's direct term's factor
// `scale`: pool^-0.5 (GDN) or pool^0.5 (IGDN). The plain version's
// arithmetic, in its order.
template <bool kInverse>
__device__ __forceinline__ float grad_pool(float g, float x, float pool, float& scale) {
  const float root = sqrtf(pool);
  if (kInverse) {
    scale = root;
    return 0.5f * g * x / root;
  }
  scale = 1.0f / root;
  return -0.5f * g * x * scale / pool;
}

template <int C, int RM, bool kInverse>
__global__ void __launch_bounds__(kThreads, 1)
gdn_bwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ grad_out,
                   const float* __restrict__ gamma, const float* __restrict__ beta,
                   float* __restrict__ grad_x, float* __restrict__ partials, int64_t rows,
                   int want_x, int want_params) {
  constexpr int kQuads = Quads<C>;
  constexpr int kWarpRows = kLanesY * RM;
  constexpr int kTileRows = kWarps * kWarpRows;
  const int64_t row_stride = static_cast<int64_t>(gridDim.y) * C;
  x += static_cast<int64_t>(blockIdx.y) * C;
  grad_out += static_cast<int64_t>(blockIdx.y) * C;
  if (want_x) grad_x += static_cast<int64_t>(blockIdx.y) * C;
  gamma += static_cast<int64_t>(blockIdx.y) * C * C;
  beta += static_cast<int64_t>(blockIdx.y) * C;
  if (want_params) {
    partials += (static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x) * PartialFloats<C>;
  }
  extern __shared__ float4 smem[];
  float* gam = reinterpret_cast<float*>(smem);  // [k][c], chunks swizzled (gamma_at)
  float* xs_all = gam + C * C;                  // [2][kTileRows][C]: x, then x^2
  float* gs_all = xs_all + 2 * kTileRows * C;   // [2][kTileRows][C]: g, then g * scale
  float* ts = gs_all + 2 * kTileRows * C;       // [kTileRows][C]: t
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = lane % kLanesX;  // channels 4 * tx + kQuadStep * q .. + 3
  const int ty = lane / kLanesX;  // rows ty + kLanesY * i of the warp's rows
  const int wrow = warp * kWarpRows;  // the warp's first row in the tile
  // In the grad_gamma pass the thread owns k = 4 * a + 64 * p + j and
  // c = 4 * tx + 64 * p + j: a 4 kQuads x 4 kQuads block of the C x C
  // (8 x 8 of 128 x 128, 12 x 12 of 192 x 192).
  const int a = kLanesY * warp + ty;

  for (int i = tid; i < C * C / 4; i += kThreads) {
    if constexpr (C == 128) {
      cp_async16(gam + gamma_at<C>(i >> 5, i & 31), gamma + 4 * i, 16);
    } else {
      cp_async16(gam + gamma_at<C>(i / (C / 4), i % (C / 4)), gamma + 4 * i, 16);
    }
  }
  // Each warp stages its own rows of x and g.
  auto load_tile = [&](int buf, int64_t tile) {
    float* xd = xs_all + (buf * kTileRows + wrow) * C;
    float* gd = gs_all + (buf * kTileRows + wrow) * C;
    if constexpr (C == 128) {
#pragma unroll
      for (int r = 0; r < kWarpRows; ++r) {
        const int64_t row = tile * kTileRows + wrow + r;
        const bool valid = row < rows;
        const int64_t at = valid ? row * row_stride + 4 * lane : 0;
        cp_async16(xd + r * C + 4 * lane, x + at, valid ? 16 : 0);
        cp_async16(gd + r * C + 4 * lane, grad_out + at, valid ? 16 : 0);
      }
    } else {
      // 16 bytes a lane a step across the warp's rows of C / 4 chunks.
#pragma unroll
      for (int step = 0; step < kWarpRows * C / 128; ++step) {
        const int chunk = 32 * step + lane;
        const int r = chunk / (C / 4);
        const int q = chunk % (C / 4);
        const int64_t row = tile * kTileRows + wrow + r;
        const bool valid = row < rows;
        const int64_t at = valid ? row * row_stride + 4 * q : 0;
        cp_async16(xd + r * C + 4 * q, x + at, valid ? 16 : 0);
        cp_async16(gd + r * C + 4 * q, grad_out + at, valid ? 16 : 0);
      }
    }
  };
  const int64_t num_tiles = (rows + kTileRows - 1) / kTileRows;
  int64_t tile = blockIdx.x;
  if (tile < num_tiles) load_tile(0, tile);
  cp_async_commit();

  float4 beta_q[kQuads];
#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
    beta_q[q] = *reinterpret_cast<const float4*>(beta + 4 * tx + kQuadStep * q);
  }
  float part[4 * kQuads][4 * kQuads];  // [4 * p + j of k][4 * p + j of c]
  float part_beta[4 * kQuads];
#pragma unroll
  for (int i = 0; i < 4 * kQuads; ++i) {
    part_beta[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4 * kQuads; ++j) part[i][j] = 0.0f;
  }
  cp_async_wait<0>();
  __syncthreads();

  for (int buf = 0; tile < num_tiles; tile += gridDim.x, buf ^= 1) {
    const int64_t next = tile + gridDim.x;
    if (next < num_tiles) load_tile(buf ^ 1, next);
    cp_async_commit();   // possibly empty, so that one group is always pending
    cp_async_wait<1>();  // this tile's rows of this warp have landed
    __syncwarp();

    float* xs = xs_all + buf * kTileRows * C;
    float* gs = gs_all + buf * kTileRows * C;
    const float* xw = xs + (wrow + ty) * C;

    // The pool of the warp's rows: the forward kernel's contraction, x
    // squared on the way, gamma's rows read through the swizzle.
    float acc[RM][4 * kQuads];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int j = 0; j < 4 * kQuads; ++j) acc[i][j] = 0.0f;
    }
    {
      float4 s[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        s[i] = *reinterpret_cast<const float4*>(xw + kLanesY * i * C);
      }
      float4 g[kQuads];
      float4 h[kQuads];
      load_gamma(g, gam + 4 * tx);
#pragma unroll 2
      for (int k = 0; k < C; k += 4) {
        const int kn = next_k<C>(k);
        const float* row_k = gam + 4 * (tx ^ ((k >> 2) & 7));
        float4 sn[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          sn[i] = *reinterpret_cast<const float4*>(xw + kLanesY * i * C + kn);
          s[i].x *= s[i].x;
          s[i].y *= s[i].y;
          s[i].z *= s[i].z;
          s[i].w *= s[i].w;
        }
        load_gamma(h, row_k + (k + 1) * C);
#pragma unroll
        for (int i = 0; i < RM; ++i) fma_row(acc[i], s[i].x, g);
        load_gamma(g, row_k + (k + 2) * C);
#pragma unroll
        for (int i = 0; i < RM; ++i) fma_row(acc[i], s[i].y, h);
        load_gamma(h, row_k + (k + 3) * C);
#pragma unroll
        for (int i = 0; i < RM; ++i) fma_row(acc[i], s[i].z, g);
        load_gamma(g, gam + 4 * (tx ^ ((kn >> 2) & 7)) + kn * C);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          fma_row(acc[i], s[i].w, h);
          s[i] = sn[i];
        }
      }
    }
    __syncwarp();  // every lane has read the warp's rows of x

    // t and g * scale of the lane's elements; t of a row past the end is 0.
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = wrow + ty + kLanesY * i;
      const bool valid = tile * kTileRows + r < rows;
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        const int at = r * C + 4 * tx + kQuadStep * q;
        const float4 xv = *reinterpret_cast<const float4*>(xs + at);
        const float4 gv = *reinterpret_cast<const float4*>(gs + at);
        float4 t, d;
        t.x = grad_pool<kInverse>(gv.x, xv.x, acc[i][4 * q + 0] + beta_q[q].x, d.x);
        t.y = grad_pool<kInverse>(gv.y, xv.y, acc[i][4 * q + 1] + beta_q[q].y, d.y);
        t.z = grad_pool<kInverse>(gv.z, xv.z, acc[i][4 * q + 2] + beta_q[q].z, d.z);
        t.w = grad_pool<kInverse>(gv.w, xv.w, acc[i][4 * q + 3] + beta_q[q].w, d.w);
        if (!valid) t = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        *reinterpret_cast<float4*>(ts + at) = t;
        if (want_x) {
          *reinterpret_cast<float4*>(gs + at) =
              make_float4(gv.x * d.x, gv.y * d.y, gv.z * d.z, gv.w * d.w);
        }
      }
    }
    __syncwarp();  // the warp's rows of t are in place

    if (want_x) {
      // u = t @ gamma^T of the warp's rows: the lane's k are 4 * tx + 64 * q + j,
      // whose swizzle is tx % 8 whatever q and j.
#pragma unroll
      for (int i = 0; i < RM; ++i) {
#pragma unroll
        for (int j = 0; j < 4 * kQuads; ++j) acc[i][j] = 0.0f;
      }
      const float* tw = ts + (wrow + ty) * C;
      const float* g_rows = gam + 4 * tx * C;
#pragma unroll 2
      for (int cc = 0; cc < C / 4; ++cc) {
        const int off = 4 * (cc ^ (tx & 7));
        float4 t4[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          t4[i] = *reinterpret_cast<const float4*>(tw + kLanesY * i * C + 4 * cc);
        }
#pragma unroll
        for (int q = 0; q < kQuads; ++q) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 gv = *reinterpret_cast<const float4*>(
                g_rows + (kQuadStep * q + j) * C + off);
#pragma unroll
            for (int i = 0; i < RM; ++i) fma4(acc[i][4 * q + j], t4[i], gv);
          }
        }
      }
      // grad_x = g * scale + 2 * x * u, written once.
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = wrow + ty + kLanesY * i;
        const int64_t row = tile * kTileRows + r;
        if (row >= rows) continue;
#pragma unroll
        for (int q = 0; q < kQuads; ++q) {
          const int c = 4 * tx + kQuadStep * q;
          const float4 xv = *reinterpret_cast<const float4*>(xs + r * C + c);
          const float4 dv = *reinterpret_cast<const float4*>(gs + r * C + c);
          float4 y;
          y.x = dv.x + 2.0f * xv.x * acc[i][4 * q + 0];
          y.y = dv.y + 2.0f * xv.y * acc[i][4 * q + 1];
          y.z = dv.z + 2.0f * xv.z * acc[i][4 * q + 2];
          y.w = dv.w + 2.0f * xv.w * acc[i][4 * q + 3];
          *reinterpret_cast<float4*>(grad_x + row * row_stride + c) = y;
        }
      }
    }

    if (want_params) {
      // x^2 of the lane's own elements (those of its t), for grad_gamma.
#pragma unroll
      for (int i = 0; i < RM; ++i) {
#pragma unroll
        for (int q = 0; q < kQuads; ++q) {
          float4* xv = reinterpret_cast<float4*>(
              xs + (wrow + ty + kLanesY * i) * C + 4 * tx + kQuadStep * q);
          const float4 v = *xv;
          *xv = make_float4(v.x * v.x, v.y * v.y, v.z * v.z, v.w * v.w);
        }
      }
      __syncthreads();  // every warp's rows of t and x^2 are in place
      // grad_gamma += (x^2)^T t over the tile's rows, in order of rows.
#pragma unroll 2
      for (int r = 0; r < kTileRows; ++r) {
        const float* sr = xs + r * C + 4 * a;
        const float* tr = ts + r * C + 4 * tx;
        float4 s[kQuads], t[kQuads];
#pragma unroll
        for (int p = 0; p < kQuads; ++p) {
          s[p] = *reinterpret_cast<const float4*>(sr + kQuadStep * p);
          t[p] = *reinterpret_cast<const float4*>(tr + kQuadStep * p);
        }
#pragma unroll
        for (int pk = 0; pk < kQuads; ++pk) {
          const float sk[4] = {s[pk].x, s[pk].y, s[pk].z, s[pk].w};
#pragma unroll
          for (int jk = 0; jk < 4; ++jk) {
#pragma unroll
            for (int pc = 0; pc < kQuads; ++pc) {
              float* out = part[4 * pk + jk] + 4 * pc;
              out[0] = fmaf(sk[jk], t[pc].x, out[0]);
              out[1] = fmaf(sk[jk], t[pc].y, out[1]);
              out[2] = fmaf(sk[jk], t[pc].z, out[2]);
              out[3] = fmaf(sk[jk], t[pc].w, out[3]);
            }
          }
        }
      }
      // grad_beta: this thread sums rows a, a + 16, ... of its channels.
#pragma unroll
      for (int r = a; r < kTileRows; r += kLanesY * kWarps) {
#pragma unroll
        for (int p = 0; p < kQuads; ++p) {
          const float4 t = *reinterpret_cast<const float4*>(ts + r * C + 4 * tx +
                                                           kQuadStep * p);
          part_beta[4 * p + 0] += t.x;
          part_beta[4 * p + 1] += t.y;
          part_beta[4 * p + 2] += t.z;
          part_beta[4 * p + 3] += t.w;
        }
      }
    }
    __syncthreads();  // the next tile's loads and t overwrite what was read here
  }
  cp_async_wait<0>();
  if (!want_params) return;

  // The block's partial: grad_gamma's 8 x 8 of each thread as it stands, then
  // grad_beta, its 16 sums of rows a mod 16 added in order of a.
#pragma unroll
  for (int pk = 0; pk < kQuads; ++pk) {
#pragma unroll
    for (int jk = 0; jk < 4; ++jk) {
      const int k = 4 * a + kQuadStep * pk + jk;
#pragma unroll
      for (int pc = 0; pc < kQuads; ++pc) {
        const float* v = part[4 * pk + jk] + 4 * pc;
        *reinterpret_cast<float4*>(partials + k * C + 4 * tx + kQuadStep * pc) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
#pragma unroll
  for (int p = 0; p < kQuads; ++p) {
    *reinterpret_cast<float4*>(ts + a * C + 4 * tx + kQuadStep * p) =
        make_float4(part_beta[4 * p], part_beta[4 * p + 1], part_beta[4 * p + 2],
                    part_beta[4 * p + 3]);
  }
  __syncthreads();
  if (tid < C) {
    float sum = 0.0f;
    for (int r = 0; r < kLanesY * kWarps; ++r) sum += ts[r * C + tid];
    partials[C * C + tid] = sum;
  }
}

// grad_gamma and grad_beta of model blockIdx.y: the sum of its `parts` blocks'
// partials, in a fixed order (parts p = group mod 16 in order, then the 16
// groups in order), with no atomics. A block sums 64 floats of the partial.
template <int C>
__global__ void __launch_bounds__(kThreads)
gdn_bwd_reduce_kernel(const float* __restrict__ partials, int parts,
                      float* __restrict__ grad_gamma, float* __restrict__ grad_beta) {
  constexpr int kPartialFloats = PartialFloats<C>;
  constexpr int kGroups = kThreads / 16;
  __shared__ float4 sums[kGroups][16];
  const int col = threadIdx.x & 15;
  const int group = threadIdx.x >> 4;
  const int e = blockIdx.x * 64 + 4 * col;
  const float* base = partials + static_cast<int64_t>(blockIdx.y) * parts * kPartialFloats + e;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int p = group; p < parts; p += kGroups) {
    const float4 v = *reinterpret_cast<const float4*>(base + static_cast<int64_t>(p) *
                                                                 kPartialFloats);
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  sums[group][col] = acc;
  __syncthreads();
  if (group != 0) return;
  for (int g = 1; g < kGroups; ++g) {
    const float4 v = sums[g][col];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  if (e < C * C) {
    if (grad_gamma != nullptr) {
      *reinterpret_cast<float4*>(grad_gamma + static_cast<int64_t>(blockIdx.y) * C * C + e) =
          acc;
    }
  } else if (grad_beta != nullptr) {
    *reinterpret_cast<float4*>(grad_beta + static_cast<int64_t>(blockIdx.y) * C + e - C * C) =
        acc;
  }
}

// -------------------------------------------------------------- launch ----

// The grid of a persistent launch of `kernel`: gridDim.y the `models`
// models, gridDim.x the blocks of each, one for each of `num_blocks_wanted`
// and at most the blocks resident on the whole card shared among the
// models. The first call sets the kernel's shared memory and reads the
// card into `max_grid` (the kernel's own static).
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int smem_bytes, int* max_grid,
                            int64_t num_blocks_wanted, int models, dim3* grid) {
  if (*max_grid == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
    int device = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                        smem_bytes);
    if (err != cudaSuccess) return err;
    *max_grid = sms * std::max(per_sm, 1);
  }
  if (models > 65535) return cudaErrorInvalidValue;
  const int64_t per_model = std::max(*max_grid / std::max(models, 1), 1);
  *grid = dim3(static_cast<unsigned>(std::clamp<int64_t>(num_blocks_wanted, 0, per_model)),
               static_cast<unsigned>(std::max(models, 0)));
  return cudaSuccess;
}

// Launches `kernel` on the grid persistent_grid gives; nothing for no
// blocks or no models.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int smem_bytes, int* max_grid, int64_t num_blocks_wanted,
           int models, void* stream, Args... args) {
  dim3 grid;
  const cudaError_t err =
      persistent_grid(kernel, smem_bytes, max_grid, num_blocks_wanted, models, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (grid.x == 0 || grid.y == 0) return 0;
  kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// A block tile of kTileRows rows: each warp's tile is an eighth of it.
// `rows` counts the rows of one model.
template <int C, int kTileRows, bool kInverse, bool kQuantize, bool kStacked>
int launch_f32(const void* x, const void* gamma, const void* beta, const void* bin_widths,
               void* out, int64_t rows, int models, void* stream) {
  static int max_grid = 0;  // resident blocks on the whole card
  constexpr int RM = kTileRows / kWarps / kLanesY;
  static_assert(f32_smem_bytes<C>(kTileRows / kWarps) <= 227 * 1024, "a block's shared memory");
  return launch(gdn_f32_kernel<C, RM, kInverse, kQuantize, kStacked>,
                f32_smem_bytes<C>(kTileRows / kWarps), &max_grid,
                (rows + kTileRows - 1) / kTileRows, models, stream,
                static_cast<const float*>(x), static_cast<const float*>(gamma),
                static_cast<const float*>(beta), static_cast<const float*>(bin_widths),
                static_cast<float*>(out), rows);
}

// The tile heights of each width: at 128 channels 128, 64 or 32 rows; at
// 192, where gamma alone takes 144 KB, 48 or 32 (two staged tiles of 6 or 4
// rows a warp beside it: 217.5 or 193 KB; 64 rows would need 242 KB).
template <int C, bool kInverse, bool kQuantize, bool kStacked = false>
int launch_f32_tiled(const void* x, const void* gamma, const void* beta,
                     const void* bin_widths, void* out, int64_t rows, int tile_rows,
                     void* stream, int models = 1) {
  if constexpr (C == 192) {
    switch (tile_rows) {
      case 48:
        return launch_f32<C, 48, kInverse, kQuantize, kStacked>(x, gamma, beta, bin_widths, out,
                                                                rows, models, stream);
      case 32:
        return launch_f32<C, 32, kInverse, kQuantize, kStacked>(x, gamma, beta, bin_widths, out,
                                                                rows, models, stream);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    switch (tile_rows) {
      case 128:
        return launch_f32<C, 128, kInverse, kQuantize, kStacked>(x, gamma, beta, bin_widths,
                                                                 out, rows, models, stream);
      case 64:
        return launch_f32<C, 64, kInverse, kQuantize, kStacked>(x, gamma, beta, bin_widths, out,
                                                                rows, models, stream);
      case 32:
        return launch_f32<C, 32, kInverse, kQuantize, kStacked>(x, gamma, beta, bin_widths, out,
                                                                rows, models, stream);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
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

// The backward's tile pass, one persistent block at least (so that grad_gamma
// and grad_beta of no rows come out zero), then, when grad_gamma or grad_beta
// is asked for, the reduction of the partials (`blocks` a model, the size
// the caller gave them, which must be the tile pass's grid). Without `run`
// it launches nothing and puts the tile pass's blocks a model into `blocks`.
template <int C, int kTileRows, bool kInverse>
int launch_bwd(bool run, const void* x, const void* grad_out, const void* gamma,
               const void* beta, void* grad_x, void* partials, void* grad_gamma,
               void* grad_beta, int64_t rows, int models, int* blocks, void* stream) {
  static int max_grid = 0;  // resident blocks on the whole card
  constexpr int RM = kTileRows / kWarps / kLanesY;
  static_assert(bwd_smem_bytes<C>(kTileRows) <= 227 * 1024, "a block's shared memory");
  const auto kernel = gdn_bwd_f32_kernel<C, RM, kInverse>;
  const int64_t tiles = std::max<int64_t>((rows + kTileRows - 1) / kTileRows, 1);
  dim3 grid;
  cudaError_t err = persistent_grid(kernel, bwd_smem_bytes<C>(kTileRows), &max_grid, tiles,
                                    models, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!run) {
    *blocks = static_cast<int>(grid.x);
    return 0;
  }
  const int want_params = partials != nullptr;
  if (want_params && static_cast<int>(grid.x) != *blocks) {
    return static_cast<int>(cudaErrorInvalidValue);  // partials sized for another grid
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<grid, kThreads, bwd_smem_bytes<C>(kTileRows), s>>>(
      static_cast<const float*>(x), static_cast<const float*>(grad_out),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<float*>(grad_x), static_cast<float*>(partials), rows, grad_x != nullptr,
      want_params);
  err = cudaGetLastError();
  if (err != cudaSuccess || !want_params) return static_cast<int>(err);
  gdn_bwd_reduce_kernel<C><<<dim3(PartialFloats<C> / 64, models), kThreads, 0, s>>>(
      static_cast<const float*>(partials), static_cast<int>(grid.x),
      static_cast<float*>(grad_gamma), static_cast<float*>(grad_beta));
  return static_cast<int>(cudaGetLastError());
}

using BwdLauncher = decltype(&launch_bwd<128, 64, false>);

// The launcher of a width, a tile height and GDN or IGDN; null for another
// width or height. At 128 channels tiles of 64 or 32 rows; at 192 of 16
// (gamma 144 KB and five tiles of 16 rows, 204 KB: 32 rows would need 264).
BwdLauncher bwd_launcher(int channels, int tile_rows, int inverse) {
  if (channels == 128 && tile_rows == 64) {
    return inverse ? launch_bwd<128, 64, true> : launch_bwd<128, 64, false>;
  }
  if (channels == 128 && tile_rows == 32) {
    return inverse ? launch_bwd<128, 32, true> : launch_bwd<128, 32, false>;
  }
  if (channels == 192 && tile_rows == 16) {
    return inverse ? launch_bwd<192, 16, true> : launch_bwd<192, 16, false>;
  }
  return nullptr;
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
AEIC_MARK_KERNEL(aeic_mark_context)
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
    {"aeic_mark_context", aeic_mark_context},
    {"aeic_mark_synthesis", aeic_mark_synthesis},
};
constexpr int kNumMarks = sizeof(kMarks) / sizeof(kMarks[0]);

}  // namespace

extern "C" {

// Each entry launches on `stream` (a cudaStream_t) and returns the
// cudaError_t of the launch (0 on success). Pointers are device pointers to
// C-contiguous, 16-byte aligned buffers: x and out (rows, C), gamma (C, C)
// fp32 indexed [k][c], beta and bin_widths (C,) fp32. C is 128 but where
// an entry takes `channels` (128 or 192). `tile_rows` is the fp32 kernels'
// tile height: 128, 64 or 32 at 128 channels, 48 or 32 at 192.
// aeic_gdn_f32_stacked takes `models` models at once: x and out are
// (rows, models, 128), gamma (models, 128, 128) and beta (models, 128).

int aeic_gdn_f32(const void* x, const void* gamma, const void* beta, void* out,
                 int64_t rows, int channels, int inverse, int tile_rows, void* stream) {
  if (channels == 192) {
    return inverse ? launch_f32_tiled<192, true, false>(x, gamma, beta, nullptr, out, rows,
                                                        tile_rows, stream)
                   : launch_f32_tiled<192, false, false>(x, gamma, beta, nullptr, out, rows,
                                                         tile_rows, stream);
  }
  if (channels != 128) return static_cast<int>(cudaErrorInvalidValue);
  return inverse ? launch_f32_tiled<128, true, false>(x, gamma, beta, nullptr, out, rows,
                                                      tile_rows, stream)
                 : launch_f32_tiled<128, false, false>(x, gamma, beta, nullptr, out, rows,
                                                       tile_rows, stream);
}

int aeic_gdn_f32_stacked(const void* x, const void* gamma, const void* beta, void* out,
                         int64_t rows, int models, int inverse, int tile_rows, void* stream) {
  return inverse ? launch_f32_tiled<128, true, false, true>(x, gamma, beta, nullptr, out, rows,
                                                            tile_rows, stream, models)
                 : launch_f32_tiled<128, false, false, true>(x, gamma, beta, nullptr, out, rows,
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
  return inverse ? launch_f32_tiled<128, true, true>(x, gamma, beta, bin_widths, out, rows,
                                                     tile_rows, stream)
                 : launch_f32_tiled<128, false, true>(x, gamma, beta, bin_widths, out, rows,
                                                      tile_rows, stream);
}

// The gradient of aeic_gdn_f32_stacked (one model: models = 1), or at 192
// channels of aeic_gdn_f32 (models = 1 only): x and grad_out (rows, models,
// C); grad_x of their shape or null; partials (models, blocks, C * C + C)
// fp32 scratch, or null when neither grad_gamma (models, C, C) nor
// grad_beta (models, C) is asked for (either may be null). `blocks` is what
// aeic_gdn_backward_blocks gives for the same rows, models, channels,
// inverse and `tile_rows` (64 or 32 at 128 channels, 16 at 192).
int aeic_gdn_backward_f32(const void* x, const void* grad_out, const void* gamma,
                          const void* beta, void* grad_x, void* partials, void* grad_gamma,
                          void* grad_beta, int64_t rows, int models, int blocks, int channels,
                          int inverse, int tile_rows, void* stream) {
  const BwdLauncher launcher = bwd_launcher(channels, tile_rows, inverse);
  if (launcher == nullptr || models <= 0 || rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launcher(true, x, grad_out, gamma, beta, grad_x, partials, grad_gamma, grad_beta, rows,
                  models, &blocks, stream);
}

// The blocks a model of aeic_gdn_backward_f32's tile pass (its grid, sized
// from the card's occupancy), the partials' second axis; minus a cudaError_t
// when the arguments or the card's query fail.
int aeic_gdn_backward_blocks(int64_t rows, int models, int channels, int inverse,
                             int tile_rows) {
  const BwdLauncher launcher = bwd_launcher(channels, tile_rows, inverse);
  if (launcher == nullptr || models <= 0 || rows < 0) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  int blocks = 0;
  const int err = launcher(false, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                           nullptr, rows, models, &blocks, nullptr);
  return err != 0 ? -err : blocks;
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
