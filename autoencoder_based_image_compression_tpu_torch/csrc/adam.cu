// Adam's update of every leaf of every model in one launch, fp32, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package writes Adam as jnp arithmetic
// (train/state.py there) and XLA fuses each leaf's chain under jit. The port
// ran the same arithmetic eagerly, 14 elementwise kernels a leaf; this kernel
// is that chain as one pass (adam_f32_kernel), entry aeic_adam_f32. Its plain
// twin is ops/kernels/adam_kernel.py::adam_leaves_plain.
//
// Per element of a leaf whose model m has the rate lr[m] and the bias
// corrections c1[m], c2[m] (train/state.py::adam_apply, in its order):
//   mu_out = (1 - b1) * g + b1 * mu
//   nu_out = (1 - b2) * (g * g) + b2 * nu
//   p_out  = p - lr * ((mu_out / c1) / (sqrt(nu_out / c2) + eps))
// Every operation is one IEEE round-to-nearest fp32 operation written as its
// intrinsic (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn), so nvcc
// contracts nothing into an FMA and the result equals PyTorch's chain of
// elementwise kernels bit for bit. The constants b1, 1 - b1, b2, 1 - b2 and
// eps come from the caller, rounded to fp32 as PyTorch rounds a Python scalar.
//
// What bounds it on the card: 28 bytes an element (read p, g, mu, nu; write
// p, mu, nu) and 10 flops, so bytes: 1.73 M parameters of one model are
// 48.3 MB, 14.4 us at 3.35 TB/s; the seven-model ladder's 12.3 M, 0.103 ms.
// At one model the launch and the tail of the grid are a large part of that.
//
// Design: up to kMaxLeaves leaves a launch, passed by value in one parameter
// struct (a CUDA graph keeps the struct as captured; nothing is copied to
// the device). Each leaf is C-contiguous with a leading model axis of M
// slices of `size` elements (M = 1 without one). A block handles one chunk
// of kChunk elements inside one model's slice of one leaf, so its rate and
// corrections are constants of the chunk: the launch plan
// (ops/kernels/adam_kernel.py::launch_plan) gives a leaf `blocks_per_model`
// blocks a model, M models in a row from its first block. A block finds its
// leaf by a scan of the leaves' first blocks. Where the chunk's seven
// addresses are 16-byte aligned, each thread loads kVecs float4 of each
// input before it computes and stores (16 loads in flight a thread), then a
// scalar tail; elsewhere (a slice that starts off a 16-byte boundary) the
// chunk runs scalar.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxLeaves = 32;
constexpr int kThreads = 256;
constexpr int kVecs = 4;  // float4 a thread and input
constexpr int kChunk = kThreads * kVecs * 4;

struct AdamLeaf {
  const float* p;
  const float* g;
  const float* mu;
  const float* nu;
  float* p_out;
  float* mu_out;
  float* nu_out;
  int64_t size;          // elements of one model's slice
  int blocks_per_model;  // ceil(size / kChunk)
  int first_block;       // the leaf's first block in the grid
};

// A per-model value: values[m * step] when `values` is a device array
// (step 1 for an (M,) array, 0 for one element), else `value`.
struct PerModel {
  const float* values;
  int step;
  float value;
};

struct AdamArgs {
  AdamLeaf leaf[kMaxLeaves];
  int leaves;
  PerModel lr;
  PerModel c1;
  PerModel c2;
  float b1;
  float one_minus_b1;
  float b2;
  float one_minus_b2;
  float eps;
};

__device__ __forceinline__ float read(const PerModel& v, int m) {
  return v.values != nullptr ? v.values[m * v.step] : v.value;
}

struct Step {
  float b1, one_minus_b1, b2, one_minus_b2, eps, lr, c1, c2;

  __device__ __forceinline__ void operator()(float p, float g, float mu, float nu, float& p_out,
                                             float& mu_out, float& nu_out) const {
    mu_out = __fadd_rn(__fmul_rn(one_minus_b1, g), __fmul_rn(b1, mu));
    nu_out = __fadd_rn(__fmul_rn(one_minus_b2, __fmul_rn(g, g)), __fmul_rn(b2, nu));
    const float update =
        __fdiv_rn(__fdiv_rn(mu_out, c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(nu_out, c2)), eps));
    p_out = __fsub_rn(p, __fmul_rn(lr, update));
  }
};

__global__ void __launch_bounds__(kThreads) adam_f32_kernel(const AdamArgs args) {
  const int block = static_cast<int>(blockIdx.x);
  int i = 0;
  while (i + 1 < args.leaves && args.leaf[i + 1].first_block <= block) ++i;
  const AdamLeaf& leaf = args.leaf[i];
  const int local = block - leaf.first_block;
  const int m = local / leaf.blocks_per_model;
  const int64_t start = static_cast<int64_t>(local % leaf.blocks_per_model) * kChunk;
  const int64_t left = leaf.size - start;
  const int n = left < kChunk ? static_cast<int>(left) : kChunk;
  const int64_t offset = m * leaf.size + start;
  const Step step{args.b1, args.one_minus_b1, args.b2, args.one_minus_b2, args.eps,
                  read(args.lr, m), read(args.c1, m), read(args.c2, m)};
  const float* p = leaf.p + offset;
  const float* g = leaf.g + offset;
  const float* mu = leaf.mu + offset;
  const float* nu = leaf.nu + offset;
  float* p_out = leaf.p_out + offset;
  float* mu_out = leaf.mu_out + offset;
  float* nu_out = leaf.nu_out + offset;
  const uintptr_t addresses =
      reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
      reinterpret_cast<uintptr_t>(mu) | reinterpret_cast<uintptr_t>(nu) |
      reinterpret_cast<uintptr_t>(p_out) | reinterpret_cast<uintptr_t>(mu_out) |
      reinterpret_cast<uintptr_t>(nu_out);
  int done = 0;
  if ((addresses & 15) == 0) {
    const int vectors = n / 4;
    float4 vp[kVecs], vg[kVecs], vmu[kVecs], vnu[kVecs];
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int v = threadIdx.x + k * kThreads;
      if (v < vectors) {
        vp[k] = reinterpret_cast<const float4*>(p)[v];
        vg[k] = reinterpret_cast<const float4*>(g)[v];
        vmu[k] = reinterpret_cast<const float4*>(mu)[v];
        vnu[k] = reinterpret_cast<const float4*>(nu)[v];
      }
    }
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int v = threadIdx.x + k * kThreads;
      if (v < vectors) {
        float4 op, omu, onu;
        step(vp[k].x, vg[k].x, vmu[k].x, vnu[k].x, op.x, omu.x, onu.x);
        step(vp[k].y, vg[k].y, vmu[k].y, vnu[k].y, op.y, omu.y, onu.y);
        step(vp[k].z, vg[k].z, vmu[k].z, vnu[k].z, op.z, omu.z, onu.z);
        step(vp[k].w, vg[k].w, vmu[k].w, vnu[k].w, op.w, omu.w, onu.w);
        reinterpret_cast<float4*>(p_out)[v] = op;
        reinterpret_cast<float4*>(mu_out)[v] = omu;
        reinterpret_cast<float4*>(nu_out)[v] = onu;
      }
    }
    done = 4 * vectors;
  }
  for (int e = done + static_cast<int>(threadIdx.x); e < n; e += kThreads) {
    step(p[e], g[e], mu[e], nu[e], p_out[e], mu_out[e], nu_out[e]);
  }
}

}  // namespace

extern "C" {

// Sizes the Python side checks its mirror of the structs against.
int aeic_adam_max_leaves() { return kMaxLeaves; }
int aeic_adam_chunk() { return kChunk; }
int aeic_adam_args_bytes() { return static_cast<int>(sizeof(AdamArgs)); }

// One launch of adam_f32_kernel over `blocks` blocks on `stream` (a
// cudaStream_t): `args` is the host copy of the parameter struct, read
// before the call returns. Returns the cudaError_t of the launch.
int aeic_adam_f32(const void* args, int blocks, void* stream) {
  const AdamArgs& launch = *static_cast<const AdamArgs*>(args);
  if (blocks <= 0 || launch.leaves <= 0 || launch.leaves > kMaxLeaves) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  adam_f32_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(launch);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
