// AdamW's update on Hopper (sm_90a): the squared gradient norm, and the
// per-element update of the first and second moments, the fp32 master and
// the parameter, for the port's optimizer (src/repro_torch/optim/adamw.py).
//
// Replaces: no TPU kernel. The JAX package's optim/adamw.py is plain jnp that
// XLA fuses under jit; the port runs eagerly, where the same update took
// about twenty elementwise fp32 passes a leaf (~182 bytes a parameter).
//
// What bounds it on this card: bytes. A parameter costs ~10 flops against,
// at the least, one read of the gradient for the norm, then one read of
// gradient, mu, nu and master and one write of mu, nu, master and the
// parameter: 34 bytes with an fp32 gradient and a bf16 parameter. That is
// far below the ~295 flops a byte where the tensor cores would bound it, so
// HBM's 3.35 TB/s sets the floor.
//
// What the design does about it: two streaming passes and nothing else.
// Each thread owns groups of 8 neighbouring elements, so every stream moves
// in 16-byte accesses with neighbouring threads on neighbouring addresses
// (an fp32 stream as two float4, a bf16 one as one uint4), with evict-first
// cache hints: every byte is touched once and a step's ~60 GB does not fit
// the 50 MB L2. A leaf's ragged tail (and a leaf whose pointers are not all
// 16-byte aligned) takes a scalar loop over the same arithmetic.
//
// adamw_sumsq: each block sums the rounded squares g*g of one tile of
// kSumTile elements in fp32 (each thread its 32 in order, then the warps'
// butterflies and the 8 warps in order) into its own slot of a partials
// buffer; adamw_finish, one block, sums every slot in double in a fixed
// order and writes gnorm = sqrt(sum + 1e-16) and clip = min(grad_clip /
// max(gnorm, 1e-12), 1). No atomics: the norm is bitwise the same from run
// to run.
//
// adamw_apply: the eager update's operations in its order, each rounded as
// PyTorch's elementwise kernel rounds it (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn, __fsqrt_rn: no FMA contraction), the Python-float constants as
// fp32 (PyTorch's opmath for a float tensor), the parameter written as
// master rounded to nearest even. Given the same clip the update is bitwise
// the eager one. clip, lr and the bias corrections are read from device
// memory, so the host never waits for the device.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                    // threads per block
constexpr int kVec = 8;                          // elements a thread per group
constexpr int kSumGroups = 4;                    // groups a thread sums
constexpr int64_t kSumTile = int64_t(kThreads) * kVec * kSumGroups;  // elements a partial
constexpr int kFinishThreads = 1024;

// The update's Python-float constants, as fp32.
struct Consts {
  float b1, c1, b2, c2, eps, wd;  // c1 = 1 - b1, c2 = 1 - b2 (computed in double, then rounded)
};

__device__ __forceinline__ float bf16_to_float(uint32_t bits) { return __uint_as_float(bits << 16); }

__device__ __forceinline__ uint32_t float_to_bf16(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void load8(const float* p, float (&x)[kVec]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[kVec]) {
  const uint4 a = __ldcs(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = bf16_to_float(w[i] & 0xffffu);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float load1(const float* p) { return __ldcs(p); }

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return bf16_to_float(__ldcs(reinterpret_cast<const unsigned short*>(p)));
}

__device__ __forceinline__ void store8(float* p, const float (&x)[kVec]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
  __stcs(reinterpret_cast<float4*>(p) + 1, make_float4(x[4], x[5], x[6], x[7]));
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&x)[kVec]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = float_to_bf16(x[2 * i]) | (float_to_bf16(x[2 * i + 1]) << 16);
  __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
}

__device__ __forceinline__ void store1(float* p, float x) { __stcs(p, x); }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  __stcs(reinterpret_cast<unsigned short*>(p), static_cast<unsigned short>(float_to_bf16(x)));
}

// One element of the eager update, in its order:
//   g = g * clip
//   m = m * b1 + (1 - b1) * g
//   v = v * b2 + ((1 - b2) * g) * g
//   w = w - lr * ((m / b1c) / (sqrt(v / b2c) + eps) + wd * w)
__device__ __forceinline__ void adamw_element(float g, float& m, float& v, float& w, const Consts& k,
                                              float clip, float lr, float b1c, float b2c) {
  g = __fmul_rn(g, clip);
  m = __fadd_rn(__fmul_rn(m, k.b1), __fmul_rn(k.c1, g));
  v = __fadd_rn(__fmul_rn(v, k.b2), __fmul_rn(__fmul_rn(k.c2, g), g));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, b2c)), k.eps);
  const float u = __fadd_rn(__fdiv_rn(__fdiv_rn(m, b1c), den), __fmul_rn(k.wd, w));
  w = __fsub_rn(w, __fmul_rn(lr, u));
}

// grid = ceil(n / kSumTile): block b writes partials[b].
template <typename G>
__global__ void __launch_bounds__(kThreads)
adamw_sumsq(const G* __restrict__ grad, int64_t n, int vec, float* __restrict__ partials) {
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * kSumTile;
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < kSumGroups; ++j) {
    const int64_t base = tile + (static_cast<int64_t>(j) * kThreads + threadIdx.x) * kVec;
    if (vec && base + kVec <= n) {
      float x[kVec];
      load8(grad + base, x);
#pragma unroll
      for (int i = 0; i < kVec; ++i) s = __fadd_rn(s, __fmul_rn(x[i], x[i]));
    } else {
      for (int64_t i = base; i < n && i < base + kVec; ++i) {
        const float x = load1(grad + i);
        s = __fadd_rn(s, __fmul_rn(x, x));
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  __shared__ float part[kThreads / 32];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) t = __fadd_rn(t, part[w]);
    partials[blockIdx.x] = t;
  }
}

// One block: out[0] = gnorm, out[1] = clip, as the eager path computes them
// from the sum (clamp keeps a NaN, as the comparisons below do).
__global__ void __launch_bounds__(kFinishThreads)
adamw_finish(const float* __restrict__ partials, int64_t n, float grad_clip, float* __restrict__ out) {
  __shared__ double red[kFinishThreads];
  double s = 0.0;
  for (int64_t i = threadIdx.x; i < n; i += kFinishThreads) s += static_cast<double>(partials[i]);
  red[threadIdx.x] = s;
  __syncthreads();
  for (unsigned w = kFinishThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float gnorm = __fsqrt_rn(__fadd_rn(__double2float_rn(red[0]), 1e-16f));
    const float den = gnorm < 1e-12f ? 1e-12f : gnorm;  // clamp(gnorm, min=1e-12)
    float clip = __fmul_rn(__frcp_rn(den), grad_clip);  // grad_clip / t is t.reciprocal() * grad_clip
    clip = clip > 1.0f ? 1.0f : clip;                   // clamp(max=1)
    out[0] = gnorm;
    out[1] = clip;
  }
}

// grid = ceil(n / (kThreads * kVec)): one group of 8 elements a thread.
template <typename G, typename P>
__global__ void __launch_bounds__(kThreads)
adamw_apply(P* __restrict__ param, const G* __restrict__ grad, float* __restrict__ mu,
            float* __restrict__ nu, float* __restrict__ master, int64_t n, int vec,
            const float* __restrict__ clip_p, const float* __restrict__ lr_p,
            const float* __restrict__ b1c_p, const float* __restrict__ b2c_p, Consts k) {
  const int64_t base = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kVec;
  if (base >= n) return;
  const float clip = __ldg(clip_p), lr = __ldg(lr_p), b1c = __ldg(b1c_p), b2c = __ldg(b2c_p);
  if (vec && base + kVec <= n) {
    float g[kVec], m[kVec], v[kVec], w[kVec];
    load8(grad + base, g);
    load8(mu + base, m);
    load8(nu + base, v);
    load8(master + base, w);
#pragma unroll
    for (int i = 0; i < kVec; ++i) adamw_element(g[i], m[i], v[i], w[i], k, clip, lr, b1c, b2c);
    store8(mu + base, m);
    store8(nu + base, v);
    store8(master + base, w);
    store8(param + base, w);
  } else {
    for (int64_t i = base; i < n && i < base + kVec; ++i) {
      float m = load1(mu + i), v = load1(nu + i), w = load1(master + i);
      adamw_element(load1(grad + i), m, v, w, k, clip, lr, b1c, b2c);
      store1(mu + i, m);
      store1(nu + i, v);
      store1(master + i, w);
      store1(param + i, w);
    }
  }
}

template <typename G, typename P>
void launch_apply(void* param, const void* grad, void* mu, void* nu, void* master, int64_t n, int vec,
                  const void* clip, const void* lr, const void* b1c, const void* b2c, Consts k,
                  cudaStream_t s) {
  const int64_t per_block = int64_t(kThreads) * kVec;
  adamw_apply<G, P><<<static_cast<unsigned>((n + per_block - 1) / per_block), kThreads, 0, s>>>(
      static_cast<P*>(param), static_cast<const G*>(grad), static_cast<float*>(mu),
      static_cast<float*>(nu), static_cast<float*>(master), n, vec, static_cast<const float*>(clip),
      static_cast<const float*>(lr), static_cast<const float*>(b1c), static_cast<const float*>(b2c), k);
}

}  // namespace

// grad: n elements (fp32, or bf16 if grad_bf16), contiguous; partials: the
// ceil(n / kSumTile) slots this leaf owns. vec: every pointer 16-byte
// aligned. Launches on `stream`; returns cudaGetLastError() as an int.
extern "C" int adamw_sumsq_launch(const void* grad, int64_t n, int grad_bf16, int vec, void* partials,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((n + kSumTile - 1) / kSumTile);
  float* out = static_cast<float*>(partials);
  if (grad_bf16) {
    adamw_sumsq<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(grad), n, vec, out);
  } else {
    adamw_sumsq<float><<<blocks, kThreads, 0, s>>>(static_cast<const float*>(grad), n, vec, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// partials: n_partials fp32 slots; out: 2 fp32 (gnorm, clip).
extern "C" int adamw_finish_launch(const void* partials, int64_t n_partials, float grad_clip, void* out,
                                   void* stream) {
  adamw_finish<<<1, kFinishThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partials), n_partials, grad_clip, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// param (bf16 if param_bf16, else fp32), grad (bf16 if grad_bf16, else
// fp32), mu, nu, master (fp32): n elements each, contiguous, updated in
// place but grad. clip, lr, b1c, b2c: one fp32 each on the device.
extern "C" int adamw_apply_launch(void* param, const void* grad, void* mu, void* nu, void* master, int64_t n,
                                  int param_bf16, int grad_bf16, int vec, const void* clip, const void* lr,
                                  const void* b1c, const void* b2c, float b1, float c1, float b2, float c2,
                                  float eps, float wd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Consts k{b1, c1, b2, c2, eps, wd};
  if (grad_bf16 && param_bf16) {
    launch_apply<__nv_bfloat16, __nv_bfloat16>(param, grad, mu, nu, master, n, vec, clip, lr, b1c, b2c, k, s);
  } else if (grad_bf16) {
    launch_apply<__nv_bfloat16, float>(param, grad, mu, nu, master, n, vec, clip, lr, b1c, b2c, k, s);
  } else if (param_bf16) {
    launch_apply<float, __nv_bfloat16>(param, grad, mu, nu, master, n, vec, clip, lr, b1c, b2c, k, s);
  } else {
    launch_apply<float, float>(param, grad, mu, nu, master, n, vec, clip, lr, b1c, b2c, k, s);
  }
  return static_cast<int>(cudaGetLastError());
}
