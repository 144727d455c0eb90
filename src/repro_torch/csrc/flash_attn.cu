// Forward flash attention for Hopper (sm_90a): q (B, Sq, H, hd) against
// k, v (B, Skv, K, hd), GQA, causal and sliding-window masks, fp32 online
// softmax, output (B, Sq, H, hd) in q's dtype.
//
// Replaces: src/repro/kernels/flash_attn.py::_flash_kernel (the Pallas TPU
// kernel behind flash_attention_pallas). Same function: query head h reads
// kv head h / (H / K); causal keeps kpos <= qpos (no offset); window > 0
// also keeps kpos > qpos - window; out = acc / max(l, 1e-30), so a row
// with no visible key writes 0; the m_safe / corr guards keep
// exp(-inf - -inf) out of the sums.
//
// What bounds it on this card: operations. Per (query, visible key) pair
// it does 4 * hd FLOP (q.k and p.v) and reads each q, k, v element once
// from device memory; at the prefill's shape (Sq = Skv = 8192, H 40, K 8,
// hd 128, causal) that is ~6.9e11 FLOP against ~0.2 GB, i.e. ~0.69 ms at
// the 989 TFLOP/s bf16 tensor-core peak against ~0.06 ms of HBM traffic.
//
// What the design does about it. The TPU kernel held all of K/V of a head
// in VMEM (hence its Skv <= 24k cap); here each block owns 64 query rows of
// one (batch, head) and streams K/V tiles of 64 rows through shared memory,
// so any Skv works and the (Sq, Skv) scores never reach device memory.
// Tiles wholly above the causal diagonal or wholly before the window are
// skipped; heavy (late) query tiles are scheduled first. Ragged Sq and Skv
// are masked, not required to divide the tile.
//  - bf16: flash_fwd_mma, 4 warps x 16 query rows, QK^T and PV on the
//    tensor cores with mma.sync m16n8k16 (bf16 in, fp32 accumulate). The
//    score accumulators are re-packed in registers as the A operand of PV
//    (no shared-memory round trip for P). Loads are synchronous and the
//    MMA is the Ampere-style warp-level one; wgmma + TMA with a pipelined
//    ring of tiles is the next speed step (ROADMAP queue B).
//  - fp32: flash_fwd_simt, scalar fp32 FMA (the tensor cores' TF32 would
//    not hold the fp32 tolerance). 4 threads per query row, each owning a
//    quarter of the head dim; partial dot products meet by warp shuffles.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBM = 64;  // query rows per block
constexpr int kBN = 64;  // key/value rows per streamed tile
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t B, Sq, Skv, H, KH;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;  // element strides
  float scale;
  int causal;
  int64_t window;
  int vec;  // q/k/v pointers 16-byte aligned and strides multiples of 8 elements
};

// The half-open range of kv tiles a query tile [q0, q0 + BM) can see.
__device__ __forceinline__ void tile_range(const Args& a, int64_t q0, int64_t* t_lo, int64_t* t_hi) {
  const int64_t q_last = min(q0 + kBM, a.Sq) - 1;
  const int64_t kv_end = a.causal ? min(a.Skv, q_last + 1) : a.Skv;
  const int64_t kv_begin = a.window > 0 ? max(int64_t(0), q0 - a.window + 1) : 0;
  *t_lo = kv_begin / kBN;
  *t_hi = (kv_end + kBN - 1) / kBN;
}

__device__ __forceinline__ bool visible(const Args& a, int64_t qpos, int64_t kpos) {
  return kpos < a.Skv && (!a.causal || kpos <= qpos) && (a.window <= 0 || kpos > qpos - a.window);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// ------------------------------------------------------------ fp32: SIMT --
template <typename T, int HD>
__global__ void __launch_bounds__(256) flash_fwd_simt(Args a) {
  constexpr int kThreads = 256, kParts = 4, kDpt = HD / kParts;
  extern __shared__ float smem_f[];
  float* Ks = smem_f;              // [kBN][HD]
  float* Vs = smem_f + kBN * HD;   // [kBN][HD]
  const int tid = threadIdx.x, r = tid >> 2, part = tid & 3;
  const int64_t qt = int64_t(gridDim.x) - 1 - blockIdx.x;  // heavy tiles first
  const int64_t b = blockIdx.y / a.H, h = blockIdx.y % a.H, kvh = h / (a.H / a.KH);
  const int64_t q0 = qt * kBM, qpos = q0 + r;
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  float qr[kDpt], acc[kDpt];
#pragma unroll
  for (int i = 0; i < kDpt; ++i) {
    qr[i] = qpos < a.Sq ? to_f(qp[qpos * a.q_ss + part + kParts * i]) * a.scale : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  int64_t t_lo, t_hi;
  tile_range(a, q0, &t_lo, &t_hi);
  for (int64_t t = t_lo; t < t_hi; ++t) {
    const int64_t kv0 = t * kBN;
    __syncthreads();
    for (int e = tid; e < kBN * HD; e += kThreads) {
      const int c = e / HD, d = e % HD;
      const int64_t kpos = kv0 + c;
      float kx = 0.f, vx = 0.f;
      if (kpos < a.Skv) {
        kx = to_f(kp[kpos * a.k_ss + d]);
        vx = to_f(vp[kpos * a.v_ss + d]);
      }
      Ks[e] = kx;
      Vs[e] = vx;
    }
    __syncthreads();
    float s[kBN];
#pragma unroll
    for (int c = 0; c < kBN; ++c) {
      float x = 0.f;
#pragma unroll
      for (int i = 0; i < kDpt; ++i) x = fmaf(qr[i], Ks[c * HD + part + kParts * i], x);
      s[c] = x;
    }
    float mx = m;
#pragma unroll
    for (int c = 0; c < kBN; ++c) {
      s[c] += __shfl_xor_sync(kFull, s[c], 1);
      s[c] += __shfl_xor_sync(kFull, s[c], 2);
      s[c] = visible(a, qpos, kv0 + c) ? s[c] : -INFINITY;
      mx = fmaxf(mx, s[c]);
    }
    const float m_safe = mx == -INFINITY ? 0.f : mx;
    const float corr = m == -INFINITY ? 0.f : expf(m - m_safe);
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < kBN; ++c) {
      s[c] = expf(s[c] - m_safe);
      psum += s[c];
    }
    l = l * corr + psum;
#pragma unroll
    for (int i = 0; i < kDpt; ++i) acc[i] *= corr;
#pragma unroll
    for (int c = 0; c < kBN; ++c) {
#pragma unroll
      for (int i = 0; i < kDpt; ++i) acc[i] = fmaf(s[c], Vs[c * HD + part + kParts * i], acc[i]);
    }
    m = mx;
  }
  if (qpos < a.Sq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* op = static_cast<T*>(a.o) + ((b * a.Sq + qpos) * a.H + h) * HD;
#pragma unroll
    for (int i = 0; i < kDpt; ++i) op[part + kParts * i] = from_f<T>(acc[i] * inv);
  }
}

// ------------------------------------------------- bf16: tensor cores -----
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_f(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_h(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return uint32_t(__bfloat16_as_ushort(lo)) | (uint32_t(__bfloat16_as_ushort(hi)) << 16);
}

// Copy rows [row0, row0 + 64) of one head (row stride `ss` elements) into
// shared memory with row stride LD; rows at or past `n` are zero.
template <int HD, int LD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int64_t ss,
                                          int64_t row0, int64_t n, int vec) {
  constexpr int kThreads = 128;
  if (vec) {
    constexpr int kVecs = HD / 8;
    for (int e = threadIdx.x; e < kBN * kVecs; e += kThreads) {
      const int r = e / kVecs, cv = e % kVecs;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (row0 + r < n) x = *reinterpret_cast<const uint4*>(src + (row0 + r) * ss + cv * 8);
      *reinterpret_cast<uint4*>(dst + r * LD + cv * 8) = x;
    }
  } else {
    for (int e = threadIdx.x; e < kBN * HD; e += kThreads) {
      const int r = e / HD, d = e % HD;
      dst[r * LD + d] = row0 + r < n ? src[(row0 + r) * ss + d] : __float2bfloat16_rn(0.f);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(128) flash_fwd_mma(Args a) {
  constexpr int LD = HD + 8;      // padded smem row: fragment loads hit 32 distinct banks
  constexpr int kKs = HD / 16;    // k-steps of Q K^T
  constexpr int kNs = kBN / 8;    // n-tiles of S
  constexpr int kNd = HD / 8;     // n-tiles of O
  static_assert(kBM == 64 && kBN % 16 == 0, "4 warps x 16 rows");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kBM][LD]
  __nv_bfloat16* Ks = Qs + kBM * LD;                                // [kBN][LD]
  __nv_bfloat16* Vs = Ks + kBN * LD;                                // [kBN][LD]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int64_t qt = int64_t(gridDim.x) - 1 - blockIdx.x;  // heavy tiles first
  const int64_t b = blockIdx.y / a.H, h = blockIdx.y % a.H, kvh = h / (a.H / a.KH);
  const int64_t q0 = qt * kBM;
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  load_tile<HD, LD>(Qs, qp, a.q_ss, q0, a.Sq, a.vec);
  __syncthreads();
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  uint32_t qa[kKs][4];
#pragma unroll
  for (int kk = 0; kk < kKs; ++kk) {
    qa[kk][0] = ld32(Qs + r0 * LD + kk * 16 + tq * 2);
    qa[kk][1] = ld32(Qs + (r0 + 8) * LD + kk * 16 + tq * 2);
    qa[kk][2] = ld32(Qs + r0 * LD + kk * 16 + 8 + tq * 2);
    qa[kk][3] = ld32(Qs + (r0 + 8) * LD + kk * 16 + 8 + tq * 2);
  }
  const int64_t qpos[2] = {q0 + r0, q0 + r0 + 8};
  float o[kNd][4];
#pragma unroll
  for (int dn = 0; dn < kNd; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  int64_t t_lo, t_hi;
  tile_range(a, q0, &t_lo, &t_hi);
  for (int64_t t = t_lo; t < t_hi; ++t) {
    const int64_t kv0 = t * kBN;
    __syncthreads();  // every warp is done with the previous tile
    load_tile<HD, LD>(Ks, kp, a.k_ss, kv0, a.Skv, a.vec);
    load_tile<HD, LD>(Vs, vp, a.v_ss, kv0, a.Skv, a.vec);
    __syncthreads();

    float s[kNs][4];
#pragma unroll
    for (int j = 0; j < kNs; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kr = Ks + (j * 8 + g) * LD + tq * 2;
#pragma unroll
      for (int kk = 0; kk < kKs; ++kk) mma16816(s[j], qa[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
    }
    // Scale, mask, row max. Element e of tile j: row qpos[e >> 1], key
    // kv0 + j*8 + tq*2 + (e & 1); a row is spread over the 4 lanes of a quad.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kNs; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = visible(a, qpos[e >> 1], kv0 + j * 8 + tq * 2 + (e & 1)) ? s[j][e] * a.scale : -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2], m_safe[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
      m_safe[i] = mx[i] == -INFINITY ? 0.f : mx[i];
      corr[i] = m[i] == -INFINITY ? 0.f : __expf(m[i] - m_safe[i]);
      l[i] *= corr[i];  // l is this lane's partial row sum; lanes meet at the end
      m[i] = mx[i];
    }
#pragma unroll
    for (int dn = 0; dn < kNd; ++dn) {
      o[dn][0] *= corr[0];
      o[dn][1] *= corr[0];
      o[dn][2] *= corr[1];
      o[dn][3] *= corr[1];
    }
#pragma unroll
    for (int j = 0; j < kNs; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[j][e] - m_safe[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }
    }
    // O += P V: two adjacent 16x8 score tiles are one 16x16 A operand.
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_f(s[2 * kk][0], s[2 * kk][1]), pack_f(s[2 * kk][2], s[2 * kk][3]),
          pack_f(s[2 * kk + 1][0], s[2 * kk + 1][1]), pack_f(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vr = Vs + (kk * 16 + tq * 2) * LD + g;
#pragma unroll
      for (int dn = 0; dn < kNd; ++dn) {
        const __nv_bfloat16* vb = vr + dn * 8;
        mma16816(o[dn], pa, pack_h(vb[0], vb[LD]), pack_h(vb[8 * LD], vb[9 * LD]));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
    if (qpos[i] >= a.Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.o) + ((b * a.Sq + qpos[i]) * a.H + h) * HD + tq * 2;
#pragma unroll
    for (int dn = 0; dn < kNd; ++dn) {
      *reinterpret_cast<__nv_bfloat162*>(op + dn * 8) =
          __floats2bfloat162_rn(o[dn][2 * i] * inv, o[dn][2 * i + 1] * inv);
    }
  }
}

template <typename K>
cudaError_t launch(K kernel, dim3 grid, int threads, size_t smem, cudaStream_t s, const Args& a) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, s>>>(a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch(int dtype, dim3 grid, cudaStream_t s, const Args& a) {
  if (dtype == 1) return launch(flash_fwd_mma<HD>, grid, 128, size_t(3) * kBM * (HD + 8) * 2, s, a);
  return launch(flash_fwd_simt<float, HD>, grid, 256, size_t(2) * kBN * HD * sizeof(float), s, a);
}

}  // namespace

// q (B, Sq, H, hd), k and v (B, Skv, K, hd) on the device, last dim
// contiguous, element strides in `strides` (host array: q's b, s, h, then
// k's, then v's). o: contiguous (B, Sq, H, hd) of q's dtype. dtype 0 is
// float32, 1 is bfloat16; hd is 32, 64 or 128. Launches on `stream`;
// returns cudaGetLastError() as an int (cudaErrorInvalidValue, 1, for an
// unsupported dtype or head dim).
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v, void* o, int64_t B,
                                 int64_t Sq, int64_t Skv, int64_t H, int64_t KH, int64_t hd,
                                 const int64_t* strides, float scale, int causal, int64_t window,
                                 int dtype, void* stream) {
  Args a{q, k, v, o, B, Sq, Skv, H, KH,
         strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
         strides[6], strides[7], strides[8], scale, causal, window, 0};
  bool vec = (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
              reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  for (int i = 0; i < 9; ++i) vec = vec && strides[i] % 8 == 0;
  a.vec = vec ? 1 : 0;
  const dim3 grid(static_cast<unsigned>((Sq + kBM - 1) / kBM), static_cast<unsigned>(B * H));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 32: return static_cast<int>(dispatch<32>(dtype, grid, s, a));
    case 64: return static_cast<int>(dispatch<64>(dtype, grid, s, a));
    case 128: return static_cast<int>(dispatch<128>(dtype, grid, s, a));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
