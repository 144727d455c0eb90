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
// The dQ kernel below recomputes q.k and dO.v, 2 (dqk + dv) FLOP a pair
// more (1.4x at hd 128: ~0.49 ms at the peak), and at hd 256 the two
// consumers of a dK / dV block both compute them as well.
//
// What the design does about it (bf16), in the shape of FlashAttention-3's
// backward: the tensor cores through wgmma only, tiles brought by TMA into
// a ring of 3 stages (2 in the dK / dV kernel at hd 256; full and empty
// mbarriers) that runs ahead of the products, no mask work on interior
// tiles. A block is two consumer warpgroups, 256 threads, and consumer
// thread 0 issues the loads (the forward's hd-256 shape): it fills the
// ring, and after each tile refills the stage of the tile before it, which
// the other consumer has long released, so the loading thread's consumer
// does not wait for the other one to finish the tile (`refill`; with 2
// stages it refills the stage just used). A producer warp or warpgroup
// beside them would put 3 warps on an SM sub-partition, and ptxas compiles
// every thread of such a block within 168 registers whatever setmaxnreg
// says: measured on an H100 build, the dK / dV kernel at hd 128 then
// spilled 684 bytes (a producer warp) and 572 (a producer warpgroup,
// setmaxnreg 40 / 232), where its consumer holds 64 + 64 fp32 registers of
// dK and dV and 32 + 32 of S^T and dP^T. At 8 warps a thread has 255.
//  1. flash_bwd_delta: delta = rowsum(dO * O) in fp32, one warp a row, and
//     lse2 = lse * log2(e), both in rows padded to a multiple of kBM: a
//     padded row has delta 0 and lse2 +inf, as has a row that sees no key,
//     so its P = exp2(s c - lse2) is 0 with no mask.
//  2. flash_bwd_dkdv_wgmma: a block owns a tile of kKB keys of one (batch,
//     kv head) and walks its share of the group's query heads, and for each
//     the query tiles of kBM = 64 rows that can see the keys (the forward's
//     tile range transposed). Thread 0 loads K and V once, then Q, dO
//     (tensor maps) and the tile's lse2 and delta rows (bulk copies) into
//     the ring. A consumer computes S^T = K Q^T and dP^T = V dO^T as SS
//     wgmma (64 keys x 64 queries) from the swizzled panels, two commit
//     groups, so that P^T = exp2(S^T c - lse2) (c = scale log2(e)) runs
//     while dP^T's product does; P^T and dS^T = P^T (dP^T - delta) are
//     packed into bf16 A fragments in registers (P and dS rounded to bf16
//     for their products, as the forward rounds P), and dV += P^T dO and
//     dK += dS^T Q run as RS wgmma with dO and Q read from the same stage
//     as MN-major B operands (the descriptor's transpose bit): no copy, no
//     transposed tile. Up to hd 128 a block owns 128 keys, 64 a consumer,
//     and dK and dV stay in fp32 registers (64 + 64 a thread at hd 128).
//     At hd 256 a block owns 64
//     keys and each consumer half of dK's and dV's head dims: 64 keys x 256
//     dims of both would need 256 registers a thread, so both consumers
//     compute the same S^T and dP^T, and the K, V, Q, dO tiles of 64 rows
//     fit in 194 KB of shared memory with the ring. Each (consumer, query
//     tile) pair is skipped, full or an edge (the diagonal, the window's
//     edge, the ragged ends: masked in int32); full tiles run no mask.
//     Scheduling: gridDim.y walks the key tiles in ascending order and the
//     card starts blocks in that order, so under causal masking, where the
//     first key tiles see the most queries, the heaviest blocks go first.
//  3. Head split: where B * K * (key tiles) is fewer blocks than the card
//     has SMs (RecurrentGemma-2B: one kv head, 64 blocks at hd 256), the
//     wrapper splits a group's query heads over head_split blocks. Each
//     writes its fp32 dK and dV to scratch (`part`, from torch.empty) and
//     flash_bwd_dkdv_sum adds the parts in split order.
//  4. flash_bwd_dq_wgmma: dQ in the forward kernel's shape. A block owns
//     128 query rows of one (batch, head), 64 a consumer, with Q and dO
//     loaded once; thread 0 brings K and V tiles of kBN rows (64, 32 at hd
//     256 where Q and dO take 128 KB) through the ring. A consumer
//     recomputes S = Q K^T and dP = dO V^T (SS wgmma), forms dS as above
//     and runs dQ += dS K as RS wgmma with K read MN-major. This is route
//     (a): dQ is not summed across the dK / dV blocks. Route (b), adding
//     each block's dQ part in a fixed order, needs blocks that wait on a
//     per-query-tile semaphore for blocks that may not yet be resident;
//     route (a) pays 2 (dqk + dv) FLOP a pair to need no ordering between
//     blocks at all.
//  Runs repeat bit for bit: each element of dq, dk, dv (and of a head
//  split's part) is one thread's wgmma accumulator, summed in the order of
//  the walk; the parts are added in split order; no atomics.
//  - fp32: flash_bwd_dkdv_simt, flash_bwd_dq_simt, scalar fp32 FMA (TF32
//    would not hold the fp32 tolerance), in the shape of flash_fwd_simt:
//    4 threads a row (8 at hd 256), each holding a slice of the row's
//    head dims; partial dot products meet by warp shuffles.

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
using bf16 = __nv_bfloat16;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;     // contiguous (B, Sq, H, dv)
  const void* dout;  // contiguous (B, Sq, H, dv)
  const float* lse;  // (B, H, Sq)
  float* delta;      // (B, H, sq_pad), written by flash_bwd_delta
  float* lse2;       // bf16: (B, H, sq_pad) lse * log2(e), written by flash_bwd_delta; fp32: null
  float* part;       // (head_split, B, Skv, K, dqk + dv) fp32 dK | dV parts when head_split > 1
  void* dq;          // contiguous (B, Sq, H, dqk)
  void* dk;          // contiguous (B, Skv, K, dqk)
  void* dv;          // contiguous (B, Skv, K, dv)
  int64_t B, Sq, Skv, H, KH;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;  // element strides
  float scale;
  int causal;
  int64_t window;   // 0: none; clamped to Sq + Skv by the launcher
  int64_t sq_pad;   // row pitch of delta and lse2: Sq (fp32), Sq rounded up to kBM (bf16)
  int head_split;   // blocks a kv head's query heads are split over (bf16)
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
// row, 8 rows a block, rows in (b, h, i) order at pitch sq_pad. With lse2
// also lse * log2(e) there (+inf for a row that sees no key); the padding
// rows i in [Sq, sq_pad) get delta 0 and lse2 +inf.
template <typename T, int DV>
__global__ void __launch_bounds__(256) flash_bwd_delta(BwdArgs a) {
  const int64_t row = int64_t(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= a.B * a.H * a.sq_pad) return;
  const int64_t qpos = row % a.sq_pad, bh = row / a.sq_pad, h = bh % a.H, b = bh / a.H;
  float s = 0.f;
  if (qpos < a.Sq) {
    const T* op = static_cast<const T*>(a.o) + ((b * a.Sq + qpos) * a.H + h) * DV;
    const T* dp = static_cast<const T*>(a.dout) + ((b * a.Sq + qpos) * a.H + h) * DV;
#pragma unroll
    for (int i = lane; i < DV; i += 32) s = fmaf(to_f(op[i]), to_f(dp[i]), s);
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(kFull, s, m);
  }
  if (lane == 0) {
    a.delta[row] = s;
    if (a.lse2 != nullptr) {
      const float l = qpos < a.Sq ? a.lse[bh * a.Sq + qpos] : -INFINITY;
      a.lse2[row] = l == -INFINITY ? INFINITY : l * kLog2e;
    }
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

// ------------------------------------ bf16: wgmma + TMA, warp-specialized --
constexpr int kBwdThreads = 256;  // two consumer warpgroups; thread 0 also issues the loads
constexpr int kBM = 64;           // query rows a ring stage of the dK / dV kernel; the lse2 / delta padding
constexpr int kBMq = 128;         // query rows a block of the dQ kernel, 64 a consumer

// Shared-memory geometry at head dims (DQK, DV). Tiles are stored as the
// forward stores them (Tiling in flash_attn.cu): panels of R rows x kSW
// bytes, 64 elements wide with the 128-byte swizzle where the head dim is
// a multiple of 64, else 32 wide with the 64-byte swizzle (hd 32, and
// MLA's qk head dim 96 in three panels). Q, K and their gradients take
// dqk's panels, V, dO and dV dv's. Every tile is a multiple of 1024 bytes,
// so each starts on a swizzle period.
template <int DQK, int DV>
struct BwdTiling {
  static_assert(DQK % 32 == 0 && DV % 32 == 0, "head dims are whole 32-element panels");
  static constexpr int kPW = DQK % 64 ? 32 : 64;   // Q, K: elements per panel row
  static constexpr int kSW = kPW * 2;              // bytes per panel row = the swizzle span
  static constexpr int kPWv = DV % 64 ? 32 : 64;   // V, dO: the same, across the v head dim
  static constexpr int kSWv = kPWv * 2;
  // dK / dV kernel: kKB keys a block; at hd 256 both consumers own the same
  // 64 keys and each a half of the head dims (kNQ of dK's, kNV of dV's).
  static constexpr bool kSplitCols = DQK > 128;
  static constexpr int kKB = kSplitCols ? 64 : 128;
  static constexpr int kNQ = kSplitCols ? DQK / 2 : DQK;
  static constexpr int kNV = kSplitCols ? DV / 2 : DV;
  static constexpr int kKBytes = kKB * DQK * 2, kVBytes = kKB * DV * 2;
  static constexpr int kQBytes = kBM * DQK * 2, kOBytes = kBM * DV * 2;
  static constexpr int kStageBytes = kQBytes + kOBytes;  // a ring stage: Q, then dO
  static constexpr int kRowBytes = 2 * kBM * 4;          // a stage's lse2, then delta
  static constexpr int kStages = kSplitCols ? 2 : 3;     // ring depth: at hd 256 two fill 194 KB
  static constexpr int kSmemDkdv = 1024 + kKBytes + kVBytes + kStages * (kStageBytes + kRowBytes);
  // dQ kernel: K / V tiles of kBN rows.
  static constexpr int kBN = DQK > 128 ? 32 : 64;
  static constexpr int kQqBytes = kBMq * DQK * 2, kOqBytes = kBMq * DV * 2;
  static constexpr int kKtBytes = kBN * DQK * 2, kVtBytes = kBN * DV * 2;
  static constexpr int kStageBytesQ = kKtBytes + kVtBytes;  // a ring stage: K, then V
  static constexpr int kStagesQ = 3;                        // 225 KB at hd 256
  static constexpr int kSmemDq = 1024 + kQqBytes + kOqBytes + kStagesQ * kStageBytesQ;
};

// d (64 x N, fp32) = A (64 x K) B^T, A and B K-major tiles in panels of PW
// elements, a_rows and b_rows rows a panel; a and b address the rows the
// product starts at.
template <int N, int K, int PW>
__device__ __forceinline__ void ss_product(float (&d)[N / 2], uint32_t a, int a_rows, uint32_t b, int b_rows) {
  static_assert(N == 64 || N == 32, "S tiles are 64 or 32 wide");
  constexpr int SW = 2 * PW;
  constexpr uint64_t layout = SW == 128 ? 1 : 2;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    // 8-row groups at 8 * SW bytes (SBO); a k-step moves 32 bytes along a
    // swizzled row, a panel at every PW elements.
    const int panel = kk * 16 / PW, off = (kk * 16 % PW) * 2;
    const uint64_t da = smem_desc(a + panel * a_rows * SW + off, 0, 8 * SW, layout);
    const uint64_t db = smem_desc(b + panel * b_rows * SW + off, 0, 8 * SW, layout);
    if constexpr (N == 64) wgmma_ss_n64(d, da, db, kk > 0);
    else wgmma_ss_n32(d, da, db, kk > 0);
  }
}

// d (64 x N, fp32) += A (64 x 16, bf16 in registers) B (16 x N), B the 16
// rows at b of an MN-major tile in panels of PW elements, `panel` bytes
// apart (LBO), 8-row groups at 8 * 2 PW bytes (SBO). N goes in products of
// 128 columns (two 128-byte-swizzled panels) where it can, else one panel
// a product; a product's columns are a contiguous run of d (element e sits
// at column 8 * (e / 4) + ...).
template <int N, int PW>
__device__ __forceinline__ void rs_product(float (&d)[N / 2], const uint32_t (&a)[4], uint32_t b, uint32_t panel) {
  constexpr int SW = 2 * PW, CW = PW == 64 && N % 128 == 0 ? 128 : PW;
  constexpr uint64_t layout = SW == 128 ? 1 : 2;
#pragma unroll
  for (int j = 0; j < N / CW; ++j) {
    const uint64_t db = smem_desc(b + j * (CW / PW) * panel, panel, 8 * SW, layout);
    auto& dj = *reinterpret_cast<float(*)[CW / 2]>(&d[j * CW / 2]);
    if constexpr (CW == 128) wgmma_rs_n128(dj, a, db);
    else if constexpr (CW == 64) wgmma_rs_n64(dj, a, db);
    else wgmma_rs_n32(dj, a, db);
  }
}

// The fp32 accumulator of a 64 x N product as the bf16 A fragments of a
// product over those N columns: elements 8kk .. 8kk + 7 are k-step kk's.
template <int N>
__device__ __forceinline__ void pack_a(const float (&x)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_f(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
  }
}

// The loading thread's refill after walk tile m: the stage of tile r = m -
// lag gets tile r + S (S stages) once both consumers have released it. With
// 3 stages the lag is 1: the other consumer finished tile m - 1 long ago,
// so the wait costs nothing and the two consumers keep their offset; with
// 2 stages it is 0 (a lag would leave nothing loaded ahead), and the
// thread waits for the other consumer to finish tile m.
template <int S, class Load>
__device__ __forceinline__ void refill(int m, int n, uint32_t empty0, Load&& load_tile) {
  constexpr int kLag = S > 2 ? 1 : 0;
  const int r = m - kLag;
  if (r >= 0 && r + S < n) {
    mbar_wait(empty0 + 8 * (r % S), (r / S) & 1);
    load_tile(r + S, r % S);
  }
}

// Whether a consumer with keys [k_lo, k_hi] needs the query tile [q0, q0 +
// kBM): kSkip (nothing visible), kFullTile (everything visible, every key
// and query in range) or kEdge (masked); tile_kind with the roles turned.
__device__ __forceinline__ int query_tile_kind(int k_lo, int k_hi, int q0, int sq, int skv, int causal, int win) {
  const int q_hi = min(q0 + kBM, sq) - 1;
  if (k_lo > k_hi || q0 > q_hi || (causal && q_hi < k_lo) || (win > 0 && q0 - k_hi >= win)) return kSkip;
  const bool full = k_lo + 64 <= skv && q0 + kBM <= sq && (!causal || q0 >= k_lo + 63) &&
                    (win <= 0 || q0 + kBM - 1 - k_lo < win);
  return full ? kFullTile : kEdge;
}

// The walk of a dK / dV block: its n = heads x nq tiles in order, tile m
// the query tile qt_lo + m % nq of query head h0 + m / nq. The query tiles
// of kBM rows are those that can see a key of [k0, k0 + kb) (the forward's
// tile range transposed); the loading thread and both consumers walk the
// same tiles, so the ring's stages and phases stay in step.
struct QueryTiles {
  int qt_lo, nq, n;
};

__device__ __forceinline__ QueryTiles query_tiles(const BwdArgs& a, int k0, int kb, int heads) {
  const int k_last = min(k0 + kb, int(a.Skv)) - 1;
  const int q_begin = a.causal ? k0 : 0;
  const int q_end = a.window > 0 ? int(min(a.Sq, int64_t(k_last) + a.window)) : int(a.Sq);
  const int qt_lo = q_begin / kBM, nq = q_end > q_begin ? (q_end + kBM - 1) / kBM - qt_lo : 0;
  return {qt_lo, nq, heads * nq};
}

// One query tile for one dK / dV consumer: S^T, dP^T, then P^T and dS^T
// into dV and dK. Element e of S^T (and of dK, dV) sits at key row krow +
// 8 * ((e % 4) >> 1) and column 8 * (e / 4) + 2 * (lane % 4) + (e % 2)
// (a query of the tile; a head dim of dK, dV). pq and pv: the first Q and
// dO panel of the consumer's dK and dV columns. rs: the stage's lse2 and
// delta rows.
template <int DQK, int DV, bool kMask>
__device__ __forceinline__ void dkdv_step(float (&dk)[BwdTiling<DQK, DV>::kNQ / 2],
                                          float (&dv)[BwdTiling<DQK, DV>::kNV / 2], uint32_t ka, uint32_t va,
                                          uint32_t q_st, uint32_t o_st, int pq, int pv, const float* rs, int krow,
                                          int q0, int sq, int skv, int causal, int win, float c) {
  using T = BwdTiling<DQK, DV>;
  float s[kBM / 2], dp[kBM / 2];
  wgmma_fence();
  ss_product<kBM, DQK, T::kPW>(s, ka, T::kKB, q_st, kBM);
  wgmma_commit();
  ss_product<kBM, DV, T::kPWv>(dp, va, T::kKB, o_st, kBM);
  wgmma_commit();
  wgmma_wait_1();  // S^T is in: P^T while dP^T runs
  fence_regs(s);
  const int col = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < kBM / 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(rs + 8 * j + col);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = 4 * j + i;
      float p = exp2f(fmaf(s[e], c, -(i & 1 ? l2.y : l2.x)));
      if (kMask) {
        const int kpos = krow + 8 * (i >> 1), qpos = q0 + 8 * j + col + (i & 1);
        const bool vis = kpos < skv && qpos < sq && (!causal || kpos <= qpos) && (win <= 0 || qpos - kpos < win);
        p = vis ? p : 0.f;
      }
      s[e] = p;
    }
  }
  wgmma_wait();
  fence_regs(dp);
#pragma unroll
  for (int j = 0; j < kBM / 8; ++j) {
    const float2 d2 = *reinterpret_cast<const float2*>(rs + kBM + 8 * j + col);
#pragma unroll
    for (int i = 0; i < 4; ++i) dp[4 * j + i] = s[4 * j + i] * (dp[4 * j + i] - (i & 1 ? d2.y : d2.x));
  }
  uint32_t pa[kBM / 16][4], da[kBM / 16][4];
  pack_a<kBM>(s, pa);
  pack_a<kBM>(dp, da);
  fence_regs(dk);
  fence_regs(dv);
  fence_regs(pa);
  fence_regs(da);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBM / 16; ++kk) {
    rs_product<T::kNV, T::kPWv>(dv, pa[kk], o_st + pv * kBM * T::kSWv + kk * 16 * T::kSWv, kBM * T::kSWv);
    rs_product<T::kNQ, T::kPW>(dk, da[kk], q_st + pq * kBM * T::kSW + kk * 16 * T::kSW, kBM * T::kSW);
  }
  wgmma_commit();
  wgmma_wait();
  fence_regs(dk);
  fence_regs(dv);
  fence_regs(pa);
  fence_regs(da);
}

// dK, dV of kKB keys of one (batch, kv head): blockIdx.x = ((b K + kvh)
// head_split + split), blockIdx.y the key tile.
template <int DQK, int DV>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                         BwdArgs a) {
  using T = BwdTiling<DQK, DV>;
  extern __shared__ unsigned char smem_raw[];
  constexpr int S = T::kStages;
  __shared__ __align__(8) uint64_t bars[1 + 2 * S];  // K/V, full[S], empty[S]
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t smem_k = (raw + 1023) & ~1023u;
  const uint32_t smem_v = smem_k + T::kKBytes;
  const uint32_t smem_st = smem_v + T::kVBytes;                      // stage s: Q at + s kStageBytes, dO after it
  const uint32_t smem_rows = smem_st + S * T::kStageBytes;  // stage s: lse2 at + s kRowBytes, delta after
  const float* rows = reinterpret_cast<const float*>(smem_raw + (smem_rows - raw));
  const uint32_t bar_kv = static_cast<uint32_t>(__cvta_generic_to_shared(bars));
  auto bar_full = [&](int s) { return bar_kv + 8 * (1 + s); };
  auto bar_empty = [&](int s) { return bar_kv + 8 * (1 + S + s); };

  const int rep = int(a.H / a.KH), hs = a.head_split, per = rep / hs;
  const int split = blockIdx.x % hs, bk = blockIdx.x / hs, b = bk / int(a.KH), kvh = bk % int(a.KH);
  const int h0 = kvh * rep + split * per;
  const int k0 = blockIdx.y * T::kKB;
  const QueryTiles w = query_tiles(a, k0, T::kKB, per);
  // TMA of walk tile m (query head h0 + m / nq, query tile qt_lo + m % nq)
  // into ring stage `stage`: Q, dO, and its lse2 and delta rows.
  auto load_tile = [&](int m, int stage) {
    const int h = h0 + m / w.nq, q0 = (w.qt_lo + m % w.nq) * kBM;
    mbar_expect_tx(bar_full(stage), T::kStageBytes + T::kRowBytes);
    const uint32_t q_dst = smem_st + stage * T::kStageBytes, o_dst = q_dst + T::kQBytes;
    for (int p = 0; p < DQK / T::kPW; ++p) {
      tma_load_4d(q_dst + p * kBM * T::kSW, &tq, bar_full(stage), p * T::kPW, h, q0, b);
    }
    for (int p = 0; p < DV / T::kPWv; ++p) {
      tma_load_4d(o_dst + p * kBM * T::kSWv, &tdo, bar_full(stage), p * T::kPWv, h, q0, b);
    }
    const int64_t row = (int64_t(b) * a.H + h) * a.sq_pad + q0;
    const uint32_t r_dst = smem_rows + stage * T::kRowBytes;
    bulk_load(r_dst, a.lse2 + row, kBM * 4, bar_full(stage));
    bulk_load(r_dst + kBM * 4, a.delta + row, kBM * 4, bar_full(stage));
  };
  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // the loading thread: K and V once, the ring's first tiles
    mbar_expect_tx(bar_kv, T::kKBytes + T::kVBytes);
    for (int p = 0; p < DQK / T::kPW; ++p) {
      tma_load_4d(smem_k + p * T::kKB * T::kSW, &tk, bar_kv, p * T::kPW, kvh, k0, b);
    }
    for (int p = 0; p < DV / T::kPWv; ++p) {
      tma_load_4d(smem_v + p * T::kKB * T::kSWv, &tv, bar_kv, p * T::kPWv, kvh, k0, b);
    }
    for (int m = 0; m < S && m < w.n; ++m) load_tile(m, m);
  }

  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int sq = int(a.Sq), skv = int(a.Skv), causal = a.causal, win = int(a.window);
  const float c = a.scale * kLog2e;
  const int k_rel = T::kSplitCols ? 0 : 64 * wg;  // the consumer's first key in the tile
  const int k_lo = k0 + k_rel, k_hi = min(k_lo + 63, skv - 1);
  const int krow = k_lo + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);  // and krow + 8
  const uint32_t ka = smem_k + k_rel * T::kSW, va = smem_v + k_rel * T::kSWv;
  const int pq = T::kSplitCols ? wg * (T::kNQ / T::kPW) : 0, pv = T::kSplitCols ? wg * (T::kNV / T::kPWv) : 0;
  float dk[T::kNQ / 2], dv[T::kNV / 2];
#pragma unroll
  for (int i = 0; i < T::kNQ / 2; ++i) dk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < T::kNV / 2; ++i) dv[i] = 0.f;
  mbar_wait(bar_kv, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int m = 0; m < w.n; ++m) {
    // Wait for the tile even when skipping it: the empty arrival below
    // must not count toward the stage's previous phase.
    mbar_wait(bar_full(stage), phase);
    const int q0 = (w.qt_lo + m % w.nq) * kBM;
    const uint32_t q_st = smem_st + stage * T::kStageBytes, o_st = q_st + T::kQBytes;
    const float* rs = rows + stage * (T::kRowBytes / 4);
    const int kind = query_tile_kind(k_lo, k_hi, q0, sq, skv, causal, win);
    if (kind == kFullTile) {
      dkdv_step<DQK, DV, false>(dk, dv, ka, va, q_st, o_st, pq, pv, rs, krow, q0, sq, skv, causal, win, c);
    } else if (kind == kEdge) {
      dkdv_step<DQK, DV, true>(dk, dv, ka, va, q_st, o_st, pq, pv, rs, krow, q0, sq, skv, causal, win, c);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty(stage));
    if (threadIdx.x == 0) refill<S>(m, w.n, bar_empty(0), load_tile);
    __syncwarp();
    if (++stage == S) {
      stage = 0;
      phase ^= 1;
    }
  }
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kpos = krow + 8 * i;
    if (kpos >= skv) continue;
    const int64_t row = (int64_t(b) * skv + kpos) * a.KH + kvh;
    if (hs == 1) {
      bf16* dkp = static_cast<bf16*>(a.dk) + row * DQK + pq * T::kPW + col;
      bf16* dvp = static_cast<bf16*>(a.dv) + row * DV + pv * T::kPWv + col;
#pragma unroll
      for (int j = 0; j < T::kNQ / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(dkp + 8 * j) =
            __floats2bfloat162_rn(dk[4 * j + 2 * i] * a.scale, dk[4 * j + 2 * i + 1] * a.scale);
      }
#pragma unroll
      for (int j = 0; j < T::kNV / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(dvp + 8 * j) =
            __floats2bfloat162_rn(dv[4 * j + 2 * i], dv[4 * j + 2 * i + 1]);
      }
    } else {
      float* pp = a.part + (split * a.B * a.Skv * a.KH + row) * (DQK + DV);
#pragma unroll
      for (int j = 0; j < T::kNQ / 8; ++j) {
        *reinterpret_cast<float2*>(pp + pq * T::kPW + col + 8 * j) =
            make_float2(dk[4 * j + 2 * i], dk[4 * j + 2 * i + 1]);
      }
#pragma unroll
      for (int j = 0; j < T::kNV / 8; ++j) {
        *reinterpret_cast<float2*>(pp + DQK + pv * T::kPWv + col + 8 * j) =
            make_float2(dv[4 * j + 2 * i], dv[4 * j + 2 * i + 1]);
      }
    }
  }
}

// dK and dV from a head split's fp32 parts: each element's head_split parts
// added in split order, dK scaled, both rounded to bf16.
template <int DQK, int DV>
__global__ void __launch_bounds__(256) flash_bwd_dkdv_sum(BwdArgs a) {
  constexpr int kW = DQK + DV;
  const int64_t rows = a.B * a.Skv * a.KH, i = int64_t(blockIdx.x) * 256 + threadIdx.x;
  if (i >= rows * kW) return;
  const int64_t row = i / kW;
  const int col = int(i % kW);
  float s = 0.f;
  for (int p = 0; p < a.head_split; ++p) s += a.part[(p * rows + row) * kW + col];
  if (col < DQK) {
    static_cast<bf16*>(a.dk)[row * DQK + col] = __float2bfloat16(s * a.scale);
  } else {
    static_cast<bf16*>(a.dv)[row * DV + col - DQK] = __float2bfloat16(s);
  }
}

// The walk of a dQ block: its n kv tiles of bn rows in order, tile m at
// t_lo + m, those that the query rows [q0, q0 + kBMq) can see (the
// forward's range).
struct KvTiles {
  int t_lo, n;
};

__device__ __forceinline__ KvTiles kv_tiles(const BwdArgs& a, int q0, int bn) {
  const int q_last = min(q0 + kBMq, int(a.Sq)) - 1;
  const int kv_end = a.causal ? min(int(a.Skv), q_last + 1) : int(a.Skv);
  const int kv_begin = a.window > 0 ? int(max(int64_t(0), q0 - a.window + 1)) : 0;
  const int t_lo = kv_begin / bn;
  return {t_lo, kv_end > kv_begin ? (kv_end + bn - 1) / bn - t_lo : 0};
}

// One kv tile for one dQ consumer: S = Q K^T and dP = dO V^T, dS, dQ +=
// dS K. Element e of S sits at query row qrow0 + 8 * ((e % 4) >> 1) and
// key kv0 + 8 * (e / 4) + 2 * (lane % 4) + (e % 2); lse2 and dl are the
// rows' lse2 and delta.
template <int DQK, int DV, bool kMask>
__device__ __forceinline__ void dq_step(float (&dq)[DQK / 2], uint32_t qa, uint32_t oa, uint32_t k_st, uint32_t v_st,
                                        const float (&lse2)[2], const float (&dl)[2], int qrow0, int kv0, int skv,
                                        int causal, int win, float c) {
  using T = BwdTiling<DQK, DV>;
  constexpr int BN = T::kBN;
  float s[BN / 2], dp[BN / 2];
  wgmma_fence();
  ss_product<BN, DQK, T::kPW>(s, qa, kBMq, k_st, BN);
  wgmma_commit();
  ss_product<BN, DV, T::kPWv>(dp, oa, kBMq, v_st, BN);
  wgmma_commit();
  wgmma_wait_1();  // S is in: P while dP runs
  fence_regs(s);
  const int col = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) {
    const int r = (e >> 1) & 1;
    float p = exp2f(fmaf(s[e], c, -lse2[r]));
    if (kMask) {
      const int kpos = kv0 + 8 * (e >> 2) + col + (e & 1), qpos = qrow0 + 8 * r;
      const bool vis = kpos < skv && (!causal || kpos <= qpos) && (win <= 0 || qpos - kpos < win);
      p = vis ? p : 0.f;
    }
    s[e] = p;
  }
  wgmma_wait();
  fence_regs(dp);
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) dp[e] = s[e] * (dp[e] - dl[(e >> 1) & 1]);
  uint32_t da[BN / 16][4];
  pack_a<BN>(dp, da);
  fence_regs(dq);
  fence_regs(da);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) rs_product<DQK, T::kPW>(dq, da[kk], k_st + kk * 16 * T::kSW, BN * T::kSW);
  wgmma_commit();
  wgmma_wait();
  fence_regs(dq);
  fence_regs(da);
}

// dQ of kBMq query rows of one (batch, head): blockIdx.x = b H + h,
// blockIdx.y the query tile, heavy (late) tiles first.
template <int DQK, int DV>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo, BwdArgs a) {
  using T = BwdTiling<DQK, DV>;
  extern __shared__ unsigned char smem_raw[];
  constexpr int S = T::kStagesQ;
  __shared__ __align__(8) uint64_t bars[1 + 2 * S];  // Q/dO, full[S], empty[S]
  const uint32_t smem_q = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  const uint32_t smem_o = smem_q + T::kQqBytes;
  const uint32_t smem_st = smem_o + T::kOqBytes;  // stage s: K at + s kStageBytesQ, V after it
  const uint32_t bar_q = static_cast<uint32_t>(__cvta_generic_to_shared(bars));
  auto bar_full = [&](int s) { return bar_q + 8 * (1 + s); };
  auto bar_empty = [&](int s) { return bar_q + 8 * (1 + S + s); };

  const int b = blockIdx.x / int(a.H), h = blockIdx.x % int(a.H), kvh = h / int(a.H / a.KH);
  const int q0 = (int(gridDim.y) - 1 - int(blockIdx.y)) * kBMq;
  const KvTiles w = kv_tiles(a, q0, T::kBN);
  // TMA of kv tile t_lo + m into ring stage `stage`: K, then V.
  auto load_tile = [&](int m, int stage) {
    const int kv0 = (w.t_lo + m) * T::kBN;
    mbar_expect_tx(bar_full(stage), T::kStageBytesQ);
    const uint32_t k_dst = smem_st + stage * T::kStageBytesQ, v_dst = k_dst + T::kKtBytes;
    for (int p = 0; p < DQK / T::kPW; ++p) {
      tma_load_4d(k_dst + p * T::kBN * T::kSW, &tk, bar_full(stage), p * T::kPW, kvh, kv0, b);
    }
    for (int p = 0; p < DV / T::kPWv; ++p) {
      tma_load_4d(v_dst + p * T::kBN * T::kSWv, &tv, bar_full(stage), p * T::kPWv, kvh, kv0, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // the loading thread: Q and dO once, the ring's first tiles
    mbar_expect_tx(bar_q, T::kQqBytes + T::kOqBytes);
    for (int p = 0; p < DQK / T::kPW; ++p) {
      tma_load_4d(smem_q + p * kBMq * T::kSW, &tq, bar_q, p * T::kPW, h, q0, b);
    }
    for (int p = 0; p < DV / T::kPWv; ++p) {
      tma_load_4d(smem_o + p * kBMq * T::kSWv, &tdo, bar_q, p * T::kPWv, h, q0, b);
    }
    for (int m = 0; m < S && m < w.n; ++m) load_tile(m, m);
  }

  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int sq = int(a.Sq), skv = int(a.Skv), causal = a.causal, win = int(a.window);
  const float c = a.scale * kLog2e;
  const int r_lo = q0 + 64 * wg, r_hi = min(r_lo + 63, sq - 1);
  const int qrow0 = r_lo + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);  // and qrow0 + 8
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = qrow0 + 8 * i;
    const int64_t row = (int64_t(b) * a.H + h) * a.sq_pad + qpos;
    lse2[i] = qpos < sq ? a.lse2[row] : INFINITY;  // rows past Sq: P = 0
    dl[i] = qpos < sq ? a.delta[row] : 0.f;
  }
  const uint32_t qa = smem_q + 64 * wg * T::kSW, oa = smem_o + 64 * wg * T::kSWv;
  float dq[DQK / 2];
#pragma unroll
  for (int i = 0; i < DQK / 2; ++i) dq[i] = 0.f;
  mbar_wait(bar_q, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int m = 0; m < w.n; ++m) {
    mbar_wait(bar_full(stage), phase);
    const int kv0 = (w.t_lo + m) * T::kBN;
    const uint32_t k_st = smem_st + stage * T::kStageBytesQ, v_st = k_st + T::kKtBytes;
    const int kind = tile_kind<T::kBN>(r_lo, r_hi, kv0, skv, causal, win);
    if (kind == kFullTile) {
      dq_step<DQK, DV, false>(dq, qa, oa, k_st, v_st, lse2, dl, qrow0, kv0, skv, causal, win, c);
    } else if (kind == kEdge) {
      dq_step<DQK, DV, true>(dq, qa, oa, k_st, v_st, lse2, dl, qrow0, kv0, skv, causal, win, c);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty(stage));
    if (threadIdx.x == 0) refill<S>(m, w.n, bar_empty(0), load_tile);
    __syncwarp();
    if (++stage == S) {
      stage = 0;
      phase ^= 1;
    }
  }
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = qrow0 + 8 * i;
    if (qpos >= sq) continue;
    bf16* dqp = static_cast<bf16*>(a.dq) + ((int64_t(b) * sq + qpos) * a.H + h) * DQK + col;
#pragma unroll
    for (int j = 0; j < DQK / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dqp + 8 * j) =
          __floats2bfloat162_rn(dq[4 * j + 2 * i] * a.scale, dq[4 * j + 2 * i + 1] * a.scale);
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

template <typename K>
cudaError_t launch_tma(K kernel, dim3 grid, int smem, cudaStream_t s, const CUtensorMap (&maps)[4],
                       const BwdArgs& a) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kBwdThreads, smem, s>>>(maps[0], maps[1], maps[2], maps[3], a);
  return cudaGetLastError();
}

template <int DQK, int DV>
cudaError_t launch_bf16(cudaStream_t s, const BwdArgs& a) {
  using T = BwdTiling<DQK, DV>;
  // q, k, v, dO maps with the dK / dV kernel's boxes, then the dQ kernel's.
  CUtensorMap dkdv[4], dq[4];
  const int64_t o_sh = DV, o_ss = a.H * DV, o_sb = a.Sq * a.H * DV;  // dO is contiguous
  const bool ok =
      tensor_map(&dkdv[0], a.q, DQK, a.H, a.Sq, a.B, a.q_sh, a.q_ss, a.q_sb, T::kPW, kBM) &&
      tensor_map(&dkdv[1], a.k, DQK, a.KH, a.Skv, a.B, a.k_sh, a.k_ss, a.k_sb, T::kPW, T::kKB) &&
      tensor_map(&dkdv[2], a.v, DV, a.KH, a.Skv, a.B, a.v_sh, a.v_ss, a.v_sb, T::kPWv, T::kKB) &&
      tensor_map(&dkdv[3], a.dout, DV, a.H, a.Sq, a.B, o_sh, o_ss, o_sb, T::kPWv, kBM) &&
      tensor_map(&dq[0], a.q, DQK, a.H, a.Sq, a.B, a.q_sh, a.q_ss, a.q_sb, T::kPW, kBMq) &&
      tensor_map(&dq[1], a.k, DQK, a.KH, a.Skv, a.B, a.k_sh, a.k_ss, a.k_sb, T::kPW, T::kBN) &&
      tensor_map(&dq[2], a.v, DV, a.KH, a.Skv, a.B, a.v_sh, a.v_ss, a.v_sb, T::kPWv, T::kBN) &&
      tensor_map(&dq[3], a.dout, DV, a.H, a.Sq, a.B, o_sh, o_ss, o_sb, T::kPWv, kBMq);
  if (!ok) return cudaErrorInvalidValue;
  cudaError_t err = launch(flash_bwd_delta<bf16, DV>, dim3(blocks(a.B * a.H * a.sq_pad, 8)), 256, 0, s, a);
  if (err != cudaSuccess) return err;
  err = launch_tma(flash_bwd_dkdv_wgmma<DQK, DV>, dim3(unsigned(a.B * a.KH * a.head_split), blocks(a.Skv, T::kKB)),
                   T::kSmemDkdv, s, dkdv, a);
  if (err != cudaSuccess) return err;
  if (a.head_split > 1) {
    err = launch(flash_bwd_dkdv_sum<DQK, DV>, dim3(blocks(a.B * a.Skv * a.KH * (DQK + DV), 256)), 256, 0, s, a);
    if (err != cudaSuccess) return err;
  }
  return launch_tma(flash_bwd_dq_wgmma<DQK, DV>, dim3(unsigned(a.B * a.H), blocks(a.Sq, kBMq)), T::kSmemDq, s, dq,
                    a);
}

template <int DQK, int DV>
cudaError_t dispatch(int dtype, cudaStream_t s, const BwdArgs& a) {
  if (dtype == 1) return launch_bf16<DQK, DV>(s, a);
  const unsigned bkh = static_cast<unsigned>(a.B * a.KH), bh = static_cast<unsigned>(a.B * a.H);
  using G = SimtB<DQK>;
  cudaError_t err = launch(flash_bwd_delta<float, DV>, dim3(blocks(a.B * a.H * a.sq_pad, 8)), 256, 0, s, a);
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
// (B, H, Sq) float32 from the forward; dq, dk, dv contiguous (B, Sq, H,
// hd), (B, Skv, K, hd), (B, Skv, K, hd_v) of q's dtype, every element
// written. dtype 0 is float32, 1 is bfloat16; (hd, hd_v) is (32, 32), (64,
// 64), (128, 128), (256, 256) or (96, 64). Scratch, float32: aux holds
// delta (B, H, sq_pad) and, for bfloat16, lse2 (B, H, sq_pad) after it;
// sq_pad is Sq for float32 and Sq rounded up to a multiple of 64 for
// bfloat16. bfloat16 goes through TMA: q, k, v, o, dout 16-byte aligned,
// every stride of a dim longer than 1 a multiple of 8 elements, aux 16-byte
// aligned; head_split (1 for float32) divides H / K, and above 1 part
// holds (head_split, B, Skv, K, hd + hd_v) float32. Launches its kernels
// on `stream`; returns cudaGetLastError() as an int (cudaErrorInvalidValue,
// 1, for an unsupported dtype, pair of head dims, layout or scratch).
extern "C" int flash_attn_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                                     const void* dout, const float* lse, float* aux, float* part, void* dq, void* dk,
                                     void* dv, int64_t B, int64_t Sq, int64_t Skv, int64_t H, int64_t KH, int64_t hd,
                                     int64_t hd_v, const int64_t* strides, float scale, int causal, int64_t window,
                                     int64_t sq_pad, int head_split, int dtype, void* stream) {
  const int64_t win = window > 0 ? (window < Sq + Skv ? window : Sq + Skv) : 0;
  const bool bf = dtype == 1;
  BwdArgs a{q, k, v, o, dout, lse, aux, bf ? aux + B * H * sq_pad : nullptr, part, dq, dk, dv, B, Sq, Skv, H, KH,
            strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
            strides[6], strides[7], strides[8], scale, causal, win, sq_pad, head_split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool scratch_ok =
      bf ? sq_pad >= Sq && sq_pad % kBM == 0 && reinterpret_cast<uintptr_t>(aux) % 16 == 0 && head_split >= 1 &&
               (H / KH) % head_split == 0 && (head_split == 1 || part != nullptr)
         : sq_pad == Sq && head_split == 1;
  if (!scratch_ok) return static_cast<int>(cudaErrorInvalidValue);
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
