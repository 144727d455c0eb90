// Backward of the flash-attention kernel (csrc/flash_attn.cu) for Hopper
// (sm_90a): from q (B, Sq, H, dqk), k (B, Skv, K, dqk), v (B, Skv, K, dv),
// the forward's output o (B, Sq, H, dv), its log-sum-exp lse (B, H, Sq)
// and the output's gradient dO (B, Sq, H, dv), the gradients dq, dk, dv in
// q's dtype. The same masks as the forward (causal with no offset, window,
// ragged Sq != Skv, GQA with H a multiple of K), the same scale, and the
// same (dqk, dv) pairs: (32, 32), (64, 64), (128, 128), (256, 256) and
// MLA's (96, 64).
//
// Replaces: no TPU kernel. The Pallas kernel behind flash_attention_pallas
// (src/repro/kernels/flash_attn.py::_flash_kernel) has no backward; the
// JAX package trains with attn_impl="chunked" by letting XLA differentiate
// the blockwise loop of models/layers.py::chunked_attention. On the card
// the port's chunked route is the forward kernel, so its gradient needs
// this one, bound to autograd in kernels/flash_attn.py.
//
// The math, per visible (query i, key j) pair of a query head and its kv
// head (scores scaled, softmax in fp32, natural log):
//   P = exp(scale q_i.k_j - lse_i),  delta_i = sum_d dO_id O_id,
//   dV_j += P dO_i,  dP = dO_i.v_j,  dS = P (dP - delta_i),
//   dQ_i += scale dS k_j,  dK_j += scale dS q_i;
// dK and dV sum over the H / K query heads of their kv head. A row with
// no visible key (lse = -inf) gets no P: every pair is masked before exp.
//
// What bounds it on this card: operations. Per visible pair and query head
// it does 2 (3 dqk + 2 dv) FLOP that are needed (q.k, dO.v, and the three
// products into dq, dk, dv) and reads q, k, v, o, dO once; at LLaVA-NeXT's
// train shape (Sq = Skv = 4096, H 32, K 8, hd 128, causal) that is 3.4e11
// FLOP, ~0.35 ms at the 989 TFLOP/s bf16 peak against ~0.03 ms of HBM.
// This design recomputes q.k and dO.v in the dQ pass (2 (dqk + dv) FLOP a
// pair more) to need no atomics.
//
// What the design does about it: nothing yet for speed. It is simple and
// deterministic, so a gradient repeats bit for bit from run to run: three
// kernels, no atomics, each output element written by one thread.
//  1. flash_bwd_delta: delta = rowsum(dO * O) in fp32, one warp a row.
//  2. dK, dV: one block per (batch, kv head, 64-key tile) walks the query
//     tiles that can see its keys (the forward's tile range transposed:
//     under causal the queries from the tile's first key on, with a window
//     those before its last key + window) of every query head of its
//     group, and keeps dK and dV in fp32 registers. At hd 256 the
//     accumulators would not fit beside the scores, so each block owns a
//     half of the head dims (blockIdx.z) and recomputes the scores.
//  3. dQ: one block per (batch, head, 64-query tile) walks its kv tiles
//     (the forward's range), dQ in fp32 registers.
//  - bf16: mma.sync m16n8k16 with fp32 accumulators (flash_bwd_dkdv_mma,
//    flash_bwd_dq_mma), 4 warps of 16 rows each. Tiles are loaded with
//    16-byte loads into shared memory rows padded by 8 elements (no bank
//    conflicts in the fragment loads) and synchronously: no ring, no TMA,
//    no wgmma (later work). The dK / dV pass computes S^T = K Q^T and dP^T
//    = V dO^T, so P^T and dS^T are already the A fragments of dV += P^T dO
//    and dK += dS^T Q; the dQ pass computes S = Q K^T, so dS is the A
//    fragment of dQ += dS K. P and dS are rounded to bf16 for those
//    products, as the forward rounds P.
//  - fp32: flash_bwd_dkdv_simt, flash_bwd_dq_simt, scalar fp32 FMA (TF32
//    would not hold the fp32 tolerance), in the shape of flash_fwd_simt:
//    4 threads a row (8 at hd 256), each holding a slice of the row's
//    head dims; partial dot products meet by warp shuffles.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
using bf16 = __nv_bfloat16;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;     // contiguous (B, Sq, H, dv)
  const void* dout;  // contiguous (B, Sq, H, dv)
  const float* lse;  // (B, H, Sq)
  float* delta;      // (B, H, Sq), written by flash_bwd_delta
  void* dq;          // contiguous (B, Sq, H, dqk)
  void* dk;          // contiguous (B, Skv, K, dqk)
  void* dv;          // contiguous (B, Skv, K, dv)
  int64_t B, Sq, Skv, H, KH;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;  // element strides
  float scale;
  int causal;
  int64_t window;  // 0: none; clamped to Sq + Skv by the launcher
};

__device__ __forceinline__ bool visible(const BwdArgs& a, int64_t qpos, int64_t kpos) {
  return qpos < a.Sq && kpos < a.Skv && (!a.causal || kpos <= qpos) && (a.window <= 0 || kpos > qpos - a.window);
}

// The half-open range of query tiles of bm rows that can see a key of the
// tile [k0, k0 + bn): the forward's tile_range transposed.
__device__ __forceinline__ void query_tile_range(const BwdArgs& a, int64_t k0, int64_t bn, int64_t bm, int64_t* lo,
                                                 int64_t* hi) {
  const int64_t k_last = min(k0 + bn, a.Skv) - 1;
  const int64_t q_begin = a.causal ? k0 : 0;
  const int64_t q_end = a.window > 0 ? min(a.Sq, k_last + a.window) : a.Sq;
  *lo = q_begin / bm;
  *hi = q_end > q_begin ? (q_end + bm - 1) / bm : *lo;
}

// The half-open range of kv tiles of bn rows that the query tile [q0, q0 +
// rows) can see (the forward's tile_range).
__device__ __forceinline__ void kv_tile_range(const BwdArgs& a, int64_t q0, int64_t rows, int64_t bn, int64_t* lo,
                                              int64_t* hi) {
  const int64_t q_last = min(q0 + rows, a.Sq) - 1;
  const int64_t kv_end = a.causal ? min(a.Skv, q_last + 1) : a.Skv;
  const int64_t kv_begin = a.window > 0 ? max(int64_t(0), q0 - a.window + 1) : 0;
  *lo = kv_begin / bn;
  *hi = kv_end > kv_begin ? (kv_end + bn - 1) / bn : *lo;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// ------------------------------------------------------------- delta pass --
// delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d] in fp32: one warp a
// row of o's (B, Sq, H) rows, 8 rows a block.
template <typename T, int DV>
__global__ void __launch_bounds__(256) flash_bwd_delta(BwdArgs a) {
  const int64_t row = int64_t(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= a.B * a.Sq * a.H) return;
  const T* op = static_cast<const T*>(a.o) + row * DV;
  const T* dp = static_cast<const T*>(a.dout) + row * DV;
  float s = 0.f;
#pragma unroll
  for (int i = lane; i < DV; i += 32) s = fmaf(to_f(op[i]), to_f(dp[i]), s);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(kFull, s, m);
  if (lane == 0) {
    const int64_t h = row % a.H, bq = row / a.H, qpos = bq % a.Sq, b = bq / a.Sq;
    a.delta[(b * a.H + h) * a.Sq + qpos] = s;
  }
}

// ------------------------------------------------------------- fp32: SIMT --
// kParts threads a row (a thread holds at most 32 of a row's elements of
// each operand), kRows rows a block of 256 threads, tiles of kTile rows of
// the other side in shared memory.
template <int DQK>
struct SimtB {
  static constexpr int kParts = DQK > 128 ? 8 : 4;
  static constexpr int kRows = 256 / kParts;
  static constexpr int kTile = 32;
};

// dK, dV of kRows keys of one (batch, kv head): every query head of the
// group, every query tile that can see them.
template <int DQK, int DV>
__global__ void __launch_bounds__(256) flash_bwd_dkdv_simt(BwdArgs a) {
  using G = SimtB<DQK>;
  constexpr int kP = G::kParts, kT = G::kTile, kD = DQK / kP, kDv = DV / kP;
  static_assert(DQK % kP == 0 && DV % kP == 0, "head dims split over kParts threads");
  extern __shared__ float smem_f[];
  float* Qs = smem_f;          // [kT][DQK]
  float* Os = Qs + kT * DQK;   // dO: [kT][DV]
  float* Ls = Os + kT * DV;    // lse: [kT]
  float* Ds = Ls + kT;         // delta: [kT]
  const int tid = threadIdx.x, r = tid / kP, part = tid % kP;
  const int64_t b = blockIdx.y / a.KH, kvh = blockIdx.y % a.KH, rep = a.H / a.KH;
  const int64_t k0 = int64_t(blockIdx.x) * G::kRows, kpos = k0 + r;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh + kpos * a.k_ss;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh + kpos * a.v_ss;
  float kr[kD], vr[kDv], dk[kD], dv[kDv];
#pragma unroll
  for (int i = 0; i < kD; ++i) {
    kr[i] = kpos < a.Skv ? kp[part + kP * i] : 0.f;
    dk[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kDv; ++i) {
    vr[i] = kpos < a.Skv ? vp[part + kP * i] : 0.f;
    dv[i] = 0.f;
  }
  int64_t qt_lo, qt_hi;
  query_tile_range(a, k0, G::kRows, kT, &qt_lo, &qt_hi);
  for (int64_t hr = 0; hr < rep; ++hr) {
    const int64_t h = kvh * rep + hr;
    const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
    const float* dop = static_cast<const float*>(a.dout) + (b * a.Sq * a.H + h) * DV;
    const float* lp = a.lse + (b * a.H + h) * a.Sq;
    const float* dlp = a.delta + (b * a.H + h) * a.Sq;
    for (int64_t qt = qt_lo; qt < qt_hi; ++qt) {
      const int64_t q0 = qt * kT;
      __syncthreads();
      for (int e = tid; e < kT * DQK; e += 256) {
        const int64_t qpos = q0 + e / DQK;
        Qs[e] = qpos < a.Sq ? qp[qpos * a.q_ss + e % DQK] : 0.f;
      }
      for (int e = tid; e < kT * DV; e += 256) {
        const int64_t qpos = q0 + e / DV;
        Os[e] = qpos < a.Sq ? dop[qpos * a.H * DV + e % DV] : 0.f;
      }
      if (tid < kT) {
        const int64_t qpos = q0 + tid;
        Ls[tid] = qpos < a.Sq ? lp[qpos] : 0.f;
        Ds[tid] = qpos < a.Sq ? dlp[qpos] : 0.f;
      }
      __syncthreads();
#pragma unroll 2
      for (int c = 0; c < kT; ++c) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int i = 0; i < kD; ++i) s = fmaf(kr[i], Qs[c * DQK + part + kP * i], s);
#pragma unroll
        for (int i = 0; i < kDv; ++i) dp = fmaf(vr[i], Os[c * DV + part + kP * i], dp);
#pragma unroll
        for (int m = 1; m < kP; m <<= 1) {
          s += __shfl_xor_sync(kFull, s, m);
          dp += __shfl_xor_sync(kFull, dp, m);
        }
        const float p = visible(a, q0 + c, kpos) ? expf(s * a.scale - Ls[c]) : 0.f;
        const float ds = p * (dp - Ds[c]);
#pragma unroll
        for (int i = 0; i < kDv; ++i) dv[i] = fmaf(p, Os[c * DV + part + kP * i], dv[i]);
#pragma unroll
        for (int i = 0; i < kD; ++i) dk[i] = fmaf(ds, Qs[c * DQK + part + kP * i], dk[i]);
      }
    }
  }
  if (kpos < a.Skv) {
    float* dkp = static_cast<float*>(a.dk) + ((b * a.Skv + kpos) * a.KH + kvh) * DQK;
    float* dvp = static_cast<float*>(a.dv) + ((b * a.Skv + kpos) * a.KH + kvh) * DV;
#pragma unroll
    for (int i = 0; i < kD; ++i) dkp[part + kP * i] = dk[i] * a.scale;
#pragma unroll
    for (int i = 0; i < kDv; ++i) dvp[part + kP * i] = dv[i];
  }
}

// dQ of kRows queries of one (batch, head): every kv tile they can see.
template <int DQK, int DV>
__global__ void __launch_bounds__(256) flash_bwd_dq_simt(BwdArgs a) {
  using G = SimtB<DQK>;
  constexpr int kP = G::kParts, kT = G::kTile, kD = DQK / kP, kDv = DV / kP;
  extern __shared__ float smem_f[];
  float* Ks = smem_f;         // [kT][DQK]
  float* Vs = Ks + kT * DQK;  // [kT][DV]
  const int tid = threadIdx.x, r = tid / kP, part = tid % kP;
  const int64_t qtile = int64_t(gridDim.x) - 1 - blockIdx.x;  // heavy tiles first
  const int64_t b = blockIdx.y / a.H, h = blockIdx.y % a.H, kvh = h / (a.H / a.KH);
  const int64_t q0 = qtile * G::kRows, qpos = q0 + r;
  const bool row_ok = qpos < a.Sq;
  const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh + qpos * a.q_ss;
  const float* dop = static_cast<const float*>(a.dout) + ((b * a.Sq + qpos) * a.H + h) * DV;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  float qr[kD], dor[kDv], acc[kD];
#pragma unroll
  for (int i = 0; i < kD; ++i) {
    qr[i] = row_ok ? qp[part + kP * i] : 0.f;
    acc[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kDv; ++i) dor[i] = row_ok ? dop[part + kP * i] : 0.f;
  const float lse = row_ok ? a.lse[(b * a.H + h) * a.Sq + qpos] : 0.f;
  const float delta = row_ok ? a.delta[(b * a.H + h) * a.Sq + qpos] : 0.f;
  int64_t kt_lo, kt_hi;
  kv_tile_range(a, q0, G::kRows, kT, &kt_lo, &kt_hi);
  for (int64_t kt = kt_lo; kt < kt_hi; ++kt) {
    const int64_t kv0 = kt * kT;
    __syncthreads();
    for (int e = tid; e < kT * DQK; e += 256) {
      const int64_t kpos = kv0 + e / DQK;
      Ks[e] = kpos < a.Skv ? kp[kpos * a.k_ss + e % DQK] : 0.f;
    }
    for (int e = tid; e < kT * DV; e += 256) {
      const int64_t kpos = kv0 + e / DV;
      Vs[e] = kpos < a.Skv ? vp[kpos * a.v_ss + e % DV] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < kT; ++c) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < kD; ++i) s = fmaf(qr[i], Ks[c * DQK + part + kP * i], s);
#pragma unroll
      for (int i = 0; i < kDv; ++i) dp = fmaf(dor[i], Vs[c * DV + part + kP * i], dp);
#pragma unroll
      for (int m = 1; m < kP; m <<= 1) {
        s += __shfl_xor_sync(kFull, s, m);
        dp += __shfl_xor_sync(kFull, dp, m);
      }
      const float p = visible(a, qpos, kv0 + c) ? expf(s * a.scale - lse) : 0.f;
      const float ds = p * (dp - delta);
#pragma unroll
      for (int i = 0; i < kD; ++i) acc[i] = fmaf(ds, Ks[c * DQK + part + kP * i], acc[i]);
    }
  }
  if (row_ok) {
    float* dqp = static_cast<float*>(a.dq) + ((b * a.Sq + qpos) * a.H + h) * DQK;
#pragma unroll
    for (int i = 0; i < kD; ++i) dqp[part + kP * i] = acc[i] * a.scale;
  }
}

// ------------------------------------------------------ bf16: mma.sync --
// kBN keys a dK / dV block (4 warps x 16 rows) against kBM queries a step;
// kBMq queries a dQ block (4 warps x 16 rows) against kBNq keys a step.
// At hd >= 128 a step is half as wide, and at hd 256 a dK / dV block owns
// half of the head dims (kSplit), so that the fp32 accumulators (per
// thread: the 16-row slice's dK and dV over 32 lanes, the scores and dP)
// stay in registers. Shared rows are padded by 8 elements (16 bytes).
template <int DQK, int DV>
struct MmaB {
  static_assert(DQK % 16 == 0 && DV % 16 == 0, "head dims are whole k-steps");
  static constexpr int kBN = 64;
  static constexpr int kBM = DQK >= 128 ? 32 : 64;
  static constexpr int kSplit = DQK > 128 ? 2 : 1;
  static constexpr int kBMq = 64;
  static constexpr int kBNq = DQK > 128 ? 32 : 64;
  static constexpr int kLdQ = DQK + 8, kLdV = DV + 8;
  static constexpr int kSmemDkdv = (kBN + kBM) * (kLdQ + kLdV) * 2 + 2 * kBM * 4;
  static constexpr int kSmemDq = (kBMq + kBNq) * (kLdQ + kLdV) * 2;
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// The m16n8k16 fragments (g = lane / 4, t = lane % 4). A (16 x 16) from a
// row-major tile, k along the row: a0 (g, 2t..2t+1), a1 (g + 8, ..), a2 (g,
// 2t + 8..), a3 (g + 8, 2t + 8..).
__device__ __forceinline__ void frag_a(const bf16* s, int ld, int r0, int k0, uint32_t (&a)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* p = s + (r0 + g) * ld + k0 + 2 * t;
  a[0] = ld_u32(p);
  a[1] = ld_u32(p + 8 * ld);
  a[2] = ld_u32(p + 8);
  a[3] = ld_u32(p + 8 * ld + 8);
}

// B (16 x 8) from a tile stored n-major, k along the row (K or V for S =
// Q K^T, dP = dO V^T; Q or dO for S^T, dP^T): b0 (k 2t..2t+1, n g), b1 (k
// 2t + 8..).
__device__ __forceinline__ void frag_b(const bf16* s, int ld, int n0, int k0, uint32_t (&b)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* p = s + (n0 + g) * ld + k0 + 2 * t;
  b[0] = ld_u32(p);
  b[1] = ld_u32(p + 8);
}

// B (16 x 8) from a tile stored k-major, n along the row (dO, Q, K as the
// right operand of P^T dO, dS^T Q, dS K): two 16-bit loads a register.
__device__ __forceinline__ void frag_b_kmajor(const bf16* s, int ld, int k0, int n0, uint32_t (&b)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const unsigned short* p = reinterpret_cast<const unsigned short*>(s) + (k0 + 2 * t) * ld + n0 + g;
  b[0] = uint32_t(p[0]) | (uint32_t(p[ld]) << 16);
  b[1] = uint32_t(p[8 * ld]) | (uint32_t(p[9 * ld]) << 16);
}

// Rows [row0, row0 + rows) of a bf16 matrix (row i at src + i * stride, COLS
// contiguous elements) into shared memory at row pitch ld; rows at or past
// n_valid read as zeros. 16-byte loads: src and stride are 16-byte aligned.
template <int COLS>
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src, int64_t stride, int64_t row0,
                                          int rows, int64_t n_valid) {
  constexpr int kVec = COLS / 8;
  for (int e = threadIdx.x; e < rows * kVec; e += blockDim.x) {
    const int r = e / kVec, c = (e % kVec) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_valid) val = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// dK, dV of kBN keys of one (batch, kv head), columns [z kNQ, (z + 1) kNQ)
// of dK and [z kNV, ..) of dV (z = blockIdx.z). Warp w owns keys 16w..16w +
// 15 of the tile; its accumulator element (n, e) sits at key row g + 8 (e /
// 2) and column 8n + 2t + e % 2 of its slice.
template <int DQK, int DV>
__global__ void __launch_bounds__(128) flash_bwd_dkdv_mma(BwdArgs a) {
  using M = MmaB<DQK, DV>;
  constexpr int kNQ = DQK / M::kSplit, kNV = DV / M::kSplit, kBM = M::kBM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [kBN][kLdQ]
  bf16* Vs = Ks + M::kBN * M::kLdQ;               // [kBN][kLdV]
  bf16* Qs = Vs + M::kBN * M::kLdV;               // [kBM][kLdQ]
  bf16* Os = Qs + kBM * M::kLdQ;                  // dO: [kBM][kLdV]
  float* Ls = reinterpret_cast<float*>(Os + kBM * M::kLdV);  // lse: [kBM]
  float* Ds = Ls + kBM;                                      // delta: [kBM]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int64_t b = blockIdx.y / a.KH, kvh = blockIdx.y % a.KH, rep = a.H / a.KH;
  const int z = blockIdx.z;
  const int64_t k0 = int64_t(blockIdx.x) * M::kBN;
  const int kr0 = 16 * warp;
  const int64_t kpos_lo = k0 + kr0 + g, kpos_hi = kpos_lo + 8;  // the key rows of e < 2 and e >= 2

  load_rows<DQK>(Ks, M::kLdQ, static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh, a.k_ss, k0, M::kBN, a.Skv);
  load_rows<DV>(Vs, M::kLdV, static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh, a.v_ss, k0, M::kBN, a.Skv);
  float dk[kNQ / 8][4], dv[kNV / 8][4];
#pragma unroll
  for (int n = 0; n < kNQ / 8; ++n) dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < kNV / 8; ++n) dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;

  int64_t qt_lo, qt_hi;
  query_tile_range(a, k0, M::kBN, kBM, &qt_lo, &qt_hi);
  for (int64_t hr = 0; hr < rep; ++hr) {
    const int64_t h = kvh * rep + hr;
    const bf16* qp = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
    const bf16* dop = static_cast<const bf16*>(a.dout) + (b * a.Sq * a.H + h) * DV;
    const float* lp = a.lse + (b * a.H + h) * a.Sq;
    const float* dlp = a.delta + (b * a.H + h) * a.Sq;
    for (int64_t qt = qt_lo; qt < qt_hi; ++qt) {
      const int64_t q0 = qt * kBM;
      __syncthreads();
      load_rows<DQK>(Qs, M::kLdQ, qp, a.q_ss, q0, kBM, a.Sq);
      load_rows<DV>(Os, M::kLdV, dop, a.H * DV, q0, kBM, a.Sq);
      for (int i = threadIdx.x; i < kBM; i += 128) {
        const int64_t qpos = q0 + i;
        Ls[i] = qpos < a.Sq ? lp[qpos] : 0.f;
        Ds[i] = qpos < a.Sq ? dlp[qpos] : 0.f;
      }
      __syncthreads();
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x kBM queries a warp.
      float s[kBM / 8][4], dp[kBM / 8][4];
#pragma unroll
      for (int j = 0; j < kBM / 8; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk) {
        uint32_t af[4];
        frag_a(Ks, M::kLdQ, kr0, 16 * kk, af);
#pragma unroll
        for (int j = 0; j < kBM / 8; ++j) {
          uint32_t bfr[2];
          frag_b(Qs, M::kLdQ, 8 * j, 16 * kk, bfr);
          mma_bf16(s[j], af, bfr);
        }
      }
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk) {
        uint32_t af[4];
        frag_a(Vs, M::kLdV, kr0, 16 * kk, af);
#pragma unroll
        for (int j = 0; j < kBM / 8; ++j) {
          uint32_t bfr[2];
          frag_b(Os, M::kLdV, 8 * j, 16 * kk, bfr);
          mma_bf16(dp[j], af, bfr);
        }
      }
      // P^T and dS^T in place of S^T and dP^T.
#pragma unroll
      for (int j = 0; j < kBM / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * j + 2 * t + (e & 1);
          const float p = visible(a, q0 + qi, e < 2 ? kpos_lo : kpos_hi) ? expf(s[j][e] * a.scale - Ls[qi]) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - Ds[qi]);
        }
      }
      // dV += P^T dO and dK += dS^T Q, 16 queries a k-step; n-tiles 2kk
      // and 2kk + 1 of S^T are k-step kk's A fragment.
#pragma unroll
      for (int kk = 0; kk < kBM / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const uint32_t da[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]), pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                                pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                                pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
        for (int n = 0; n < kNV / 8; ++n) {
          uint32_t bfr[2];
          frag_b_kmajor(Os, M::kLdV, 16 * kk, z * kNV + 8 * n, bfr);
          mma_bf16(dv[n], pa, bfr);
        }
#pragma unroll
        for (int n = 0; n < kNQ / 8; ++n) {
          uint32_t bfr[2];
          frag_b_kmajor(Qs, M::kLdQ, 16 * kk, z * kNQ + 8 * n, bfr);
          mma_bf16(dk[n], da, bfr);
        }
      }
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int64_t kpos = half ? kpos_hi : kpos_lo;
    if (kpos >= a.Skv) continue;
    bf16* dkp = static_cast<bf16*>(a.dk) + ((b * a.Skv + kpos) * a.KH + kvh) * DQK + z * kNQ + 2 * t;
    bf16* dvp = static_cast<bf16*>(a.dv) + ((b * a.Skv + kpos) * a.KH + kvh) * DV + z * kNV + 2 * t;
#pragma unroll
    for (int n = 0; n < kNQ / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + 8 * n) =
          __floats2bfloat162_rn(dk[n][2 * half] * a.scale, dk[n][2 * half + 1] * a.scale);
    }
#pragma unroll
    for (int n = 0; n < kNV / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dvp + 8 * n) = __floats2bfloat162_rn(dv[n][2 * half], dv[n][2 * half + 1]);
    }
  }
}

// dQ of kBMq queries of one (batch, head). Warp w owns queries 16w..16w +
// 15 of the tile.
template <int DQK, int DV>
__global__ void __launch_bounds__(128) flash_bwd_dq_mma(BwdArgs a) {
  using M = MmaB<DQK, DV>;
  constexpr int kBMq = M::kBMq, kBNq = M::kBNq;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kBMq][kLdQ]
  bf16* Os = Qs + kBMq * M::kLdQ;                 // dO: [kBMq][kLdV]
  bf16* Ks = Os + kBMq * M::kLdV;                 // [kBNq][kLdQ]
  bf16* Vs = Ks + kBNq * M::kLdQ;                 // [kBNq][kLdV]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int64_t qtile = int64_t(gridDim.x) - 1 - blockIdx.x;  // heavy tiles first
  const int64_t b = blockIdx.y / a.H, h = blockIdx.y % a.H, kvh = h / (a.H / a.KH);
  const int64_t q0 = qtile * kBMq;
  const int qr0 = 16 * warp;
  const int64_t qpos_lo = q0 + qr0 + g, qpos_hi = qpos_lo + 8;  // the query rows of e < 2 and e >= 2
  const float* lp = a.lse + (b * a.H + h) * a.Sq;
  const float* dlp = a.delta + (b * a.H + h) * a.Sq;
  const float lse_lo = qpos_lo < a.Sq ? lp[qpos_lo] : 0.f, lse_hi = qpos_hi < a.Sq ? lp[qpos_hi] : 0.f;
  const float dl_lo = qpos_lo < a.Sq ? dlp[qpos_lo] : 0.f, dl_hi = qpos_hi < a.Sq ? dlp[qpos_hi] : 0.f;
  load_rows<DQK>(Qs, M::kLdQ, static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh, a.q_ss, q0, kBMq, a.Sq);
  load_rows<DV>(Os, M::kLdV, static_cast<const bf16*>(a.dout) + (b * a.Sq * a.H + h) * DV, a.H * DV, q0, kBMq,
                a.Sq);
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  float dq[DQK / 8][4];
#pragma unroll
  for (int n = 0; n < DQK / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  int64_t kt_lo, kt_hi;
  kv_tile_range(a, q0, kBMq, kBNq, &kt_lo, &kt_hi);
  for (int64_t kt = kt_lo; kt < kt_hi; ++kt) {
    const int64_t kv0 = kt * kBNq;
    __syncthreads();
    load_rows<DQK>(Ks, M::kLdQ, kp, a.k_ss, kv0, kBNq, a.Skv);
    load_rows<DV>(Vs, M::kLdV, vp, a.v_ss, kv0, kBNq, a.Skv);
    __syncthreads();
    // S = Q K^T and dP = dO V^T: 16 queries x kBNq keys a warp.
    float s[kBNq / 8][4], dp[kBNq / 8][4];
#pragma unroll
    for (int j = 0; j < kBNq / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk) {
      uint32_t af[4];
      frag_a(Qs, M::kLdQ, qr0, 16 * kk, af);
#pragma unroll
      for (int j = 0; j < kBNq / 8; ++j) {
        uint32_t bfr[2];
        frag_b(Ks, M::kLdQ, 8 * j, 16 * kk, bfr);
        mma_bf16(s[j], af, bfr);
      }
    }
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk) {
      uint32_t af[4];
      frag_a(Os, M::kLdV, qr0, 16 * kk, af);
#pragma unroll
      for (int j = 0; j < kBNq / 8; ++j) {
        uint32_t bfr[2];
        frag_b(Vs, M::kLdV, 8 * j, 16 * kk, bfr);
        mma_bf16(dp[j], af, bfr);
      }
    }
    // dS in place of dP.
#pragma unroll
    for (int j = 0; j < kBNq / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t kpos = kv0 + 8 * j + 2 * t + (e & 1);
        const bool lo = e < 2;
        const float p =
            visible(a, lo ? qpos_lo : qpos_hi, kpos) ? expf(s[j][e] * a.scale - (lo ? lse_lo : lse_hi)) : 0.f;
        dp[j][e] = p * (dp[j][e] - (lo ? dl_lo : dl_hi));
      }
    }
    // dQ += dS K, 16 keys a k-step.
#pragma unroll
    for (int kk = 0; kk < kBNq / 16; ++kk) {
      const uint32_t da[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]), pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < DQK / 8; ++n) {
        uint32_t bfr[2];
        frag_b_kmajor(Ks, M::kLdQ, 16 * kk, 8 * n, bfr);
        mma_bf16(dq[n], da, bfr);
      }
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int64_t qpos = half ? qpos_hi : qpos_lo;
    if (qpos >= a.Sq) continue;
    bf16* dqp = static_cast<bf16*>(a.dq) + ((b * a.Sq + qpos) * a.H + h) * DQK + 2 * t;
#pragma unroll
    for (int n = 0; n < DQK / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dqp + 8 * n) =
          __floats2bfloat162_rn(dq[n][2 * half] * a.scale, dq[n][2 * half + 1] * a.scale);
    }
  }
}

template <typename K>
cudaError_t launch(K kernel, dim3 grid, int threads, size_t smem, cudaStream_t s, const BwdArgs& a) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, s>>>(a);
  return cudaGetLastError();
}

inline unsigned blocks(int64_t n, int64_t per) { return static_cast<unsigned>((n + per - 1) / per); }

template <int DQK, int DV>
cudaError_t dispatch(int dtype, cudaStream_t s, const BwdArgs& a) {
  const unsigned bkh = static_cast<unsigned>(a.B * a.KH), bh = static_cast<unsigned>(a.B * a.H);
  cudaError_t err;
  if (dtype == 1) {
    using M = MmaB<DQK, DV>;
    err = launch(flash_bwd_delta<bf16, DV>, dim3(blocks(a.B * a.Sq * a.H, 8)), 256, 0, s, a);
    if (err != cudaSuccess) return err;
    err = launch(flash_bwd_dkdv_mma<DQK, DV>, dim3(blocks(a.Skv, M::kBN), bkh, M::kSplit), 128, M::kSmemDkdv, s, a);
    if (err != cudaSuccess) return err;
    return launch(flash_bwd_dq_mma<DQK, DV>, dim3(blocks(a.Sq, M::kBMq), bh), 128, M::kSmemDq, s, a);
  }
  using G = SimtB<DQK>;
  err = launch(flash_bwd_delta<float, DV>, dim3(blocks(a.B * a.Sq * a.H, 8)), 256, 0, s, a);
  if (err != cudaSuccess) return err;
  const size_t smem_dkdv = (size_t(G::kTile) * (DQK + DV) + 2 * G::kTile) * sizeof(float);
  err = launch(flash_bwd_dkdv_simt<DQK, DV>, dim3(blocks(a.Skv, G::kRows), bkh), 256, smem_dkdv, s, a);
  if (err != cudaSuccess) return err;
  const size_t smem_dq = size_t(G::kTile) * (DQK + DV) * sizeof(float);
  return launch(flash_bwd_dq_simt<DQK, DV>, dim3(blocks(a.Sq, G::kRows), bh), 256, smem_dq, s, a);
}

}  // namespace

// q (B, Sq, H, hd), k (B, Skv, K, hd), v (B, Skv, K, hd_v) on the device,
// last dim contiguous, element strides in `strides` (host array: q's b, s,
// h, then k's, then v's); o and dout contiguous (B, Sq, H, hd_v); lse
// (B, H, Sq) float32 from the forward; delta (B, H, Sq) float32 scratch;
// dq, dk, dv contiguous (B, Sq, H, hd), (B, Skv, K, hd), (B, Skv, K, hd_v)
// of q's dtype, every element written. dtype 0 is float32, 1 is bfloat16
// (q, k, v, o, dout and the bf16 tiles 16-byte aligned, every stride a
// multiple of 8 elements). (hd, hd_v) is (32, 32), (64, 64), (128, 128),
// (256, 256) or (96, 64). Launches three kernels on `stream`; returns
// cudaGetLastError() as an int (cudaErrorInvalidValue, 1, for an
// unsupported dtype or pair of head dims).
extern "C" int flash_attn_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                                     const void* dout, const float* lse, float* delta, void* dq, void* dk, void* dv,
                                     int64_t B, int64_t Sq, int64_t Skv, int64_t H, int64_t KH, int64_t hd,
                                     int64_t hd_v, const int64_t* strides, float scale, int causal, int64_t window,
                                     int dtype, void* stream) {
  const int64_t win = window > 0 ? (window < Sq + Skv ? window : Sq + Skv) : 0;
  BwdArgs a{q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, KH,
            strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
            strides[6], strides[7], strides[8], scale, causal, win};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (hd == 96 && hd_v == 64) return static_cast<int>(dispatch<96, 64>(dtype, s, a));
  if (hd != hd_v) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 32: return static_cast<int>(dispatch<32, 32>(dtype, s, a));
    case 64: return static_cast<int>(dispatch<64, 64>(dtype, s, a));
    case 128: return static_cast<int>(dispatch<128, 128>(dtype, s, a));
    case 256: return static_cast<int>(dispatch<256, 256>(dtype, s, a));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
