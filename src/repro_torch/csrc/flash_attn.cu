// Forward flash attention for Hopper (sm_90a): q (B, Sq, H, dqk) against
// k (B, Skv, K, dqk) and v (B, Skv, K, dv), GQA, causal and sliding-window
// masks, fp32 online softmax, output (B, Sq, H, dv) in q's dtype. The head
// dims come in the pairs (dqk, dv) it is built for: (32, 32), (64, 64),
// (128, 128), (256, 256) and MLA's (96, 64) (MiniCPM3: 64 nope + 32 rope
// dims of q and k, 64 of v).
//
// Replaces: src/repro/kernels/flash_attn.py::_flash_kernel (the Pallas TPU
// kernel behind flash_attention_pallas). Same function: query head h reads
// kv head h / (H / K); causal keeps kpos <= qpos (no offset); window > 0
// also keeps kpos > qpos - window; out = acc / max(l, 1e-30), so a row
// with no visible key writes 0; the m_safe / corr guards keep
// exp(-inf - -inf) out of the sums. When asked (a non-null lse) it also
// stores each row's log-sum-exp of its scaled scores, from which the
// backward (csrc/flash_attn_bwd.cu) recomputes P; the output is the same
// bits either way.
//
// What bounds it on this card: operations. Per (query, visible key) pair
// it does 2 * (dqk + dv) FLOP (q.k and p.v) and reads each q, k, v element once
// from device memory; at the prefill's shape (Sq = Skv = 8192, H 40, K 8,
// hd 128, causal) that is ~6.9e11 FLOP against ~0.2 GB, i.e. ~0.69 ms at
// the 989 TFLOP/s bf16 tensor-core peak against ~0.06 ms of HBM traffic.
//
// What the design does about it. The TPU kernel held all of K/V of a head
// in VMEM (hence its Skv <= 24k cap); here K/V tiles stream through shared
// memory, so any Skv works and the (Sq, Skv) scores never reach device
// memory. Tiles wholly above the causal diagonal or wholly before the
// window are skipped; heavy (late) query tiles are scheduled first. Ragged
// Sq and Skv are masked, not required to divide the tile.
//  - bf16: flash_fwd_wgmma, warp-specialized in the shape of
//    FlashAttention-3. A block owns 128 query rows of one (batch, head) and
//    has two consumer warpgroups and, up to hd 128, a producer warpgroup (at
//    hd 256 consumer thread 0 loads: see Tiling). One thread loads Q once
//    and then K/V tiles of BN rows with TMA
//    (cp.async.bulk.tensor) into a ring of kStages stages, each with a full
//    and an empty mbarrier. Each consumer owns 64 query rows: S = Q K^T is
//    wgmma m64nBNk16 with Q and K read from shared memory through
//    descriptors; O += P V is wgmma m64nHDk16 (two n128 halves at hd 256)
//    with P re-packed from the fp32 S accumulators into bf16 A-register
//    fragments (P never touches shared memory) and V read in its natural
//    (Skv, hd) layout as an MN-major B operand (the transpose bit). Shared
//    tiles are stored in panels 64 elements wide with the 128-byte swizzle
//    (head dims that are multiples of 64) or 32 wide with the 64-byte
//    swizzle (hd 32, whose rows are 64 bytes, and MLA's qk head dim 96,
//    whose 192-byte rows are three such panels); the TMA maps and the
//    wgmma descriptors agree on it. Q and K take the panels of dqk, V of dv. Each
//    (consumer, KV tile) pair is skipped, full (no mask) or an edge (masked
//    in int32: the diagonal, the window edge, the ragged end, where TMA's
//    zero rows must not count), and exp2f takes scale * log2(e) folded in.
//    Query heads of one KV group are adjacent in the grid, so their K/V
//    tiles are read from L2. BN is 128 up to hd 128 and 64 at hd 256
//    (Gemma3, RecurrentGemma): there 128 rows would need 64 KB (Q) + 256 KB
//    (the K/V ring) of shared memory and 128 (O) + 64 (S) + 32 (P) registers
//    a consumer thread; 64 rows take 1 + 64 + 128 KB and 128 + 32 + 16.
//  - fp32: flash_fwd_simt, scalar fp32 FMA (the tensor cores' TF32 would
//    not hold the fp32 tolerance). 4 threads per query row (8 at hd 256),
//    each owning a slice of 32 or fewer of q's and of the output's
//    head-dim elements; partial dot products meet by warp shuffles.

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

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
  float* lse;  // (B, H, Sq) fp32 log-sum-exp of each row's scaled scores, or null: nothing stored
};

// The fp32 kernel's geometry at qk head dim HD: kParts threads per query
// row (so a thread holds at most 32 of q's and of the output's elements),
// kRows query rows per block of 256 threads, K/V tiles of kBN rows (32 at
// hd 256, where a thread's 64 scores of a 64-row tile would not fit in
// registers beside its 64 elements of q and of the output).
template <int HD>
struct Simt {
  static constexpr int kParts = HD > 128 ? 8 : 4;
  static constexpr int kRows = 256 / kParts;
  static constexpr int kBN = HD > 128 ? 32 : 64;
};

// The half-open range of kv tiles of bn rows that a query tile [q0, q0 +
// rows) can see.
__device__ __forceinline__ void tile_range(const Args& a, int64_t q0, int64_t rows, int64_t bn, int64_t* t_lo,
                                           int64_t* t_hi) {
  const int64_t q_last = min(q0 + rows, a.Sq) - 1;
  const int64_t kv_end = a.causal ? min(a.Skv, q_last + 1) : a.Skv;
  const int64_t kv_begin = a.window > 0 ? max(int64_t(0), q0 - a.window + 1) : 0;
  *t_lo = kv_begin / bn;
  *t_hi = (kv_end + bn - 1) / bn;
}

__device__ __forceinline__ bool visible(const Args& a, int64_t qpos, int64_t kpos) {
  return kpos < a.Skv && (!a.causal || kpos <= qpos) && (a.window <= 0 || kpos > qpos - a.window);
}

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

// ------------------------------------------------------------ fp32: SIMT --
template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(256) flash_fwd_simt(Args a) {
  constexpr int kThreads = 256, kParts = Simt<DQK>::kParts, kBN = Simt<DQK>::kBN;
  constexpr int kDpt = DQK / kParts, kDptV = DV / kParts;  // q's and the output's elements a thread holds
  static_assert(DQK % kParts == 0 && DV % kParts == 0, "head dims split over kParts threads");
  extern __shared__ float smem_f[];
  float* Ks = smem_f;               // [kBN][DQK]
  float* Vs = smem_f + kBN * DQK;   // [kBN][DV]
  const int tid = threadIdx.x, r = tid / kParts, part = tid % kParts;
  const int64_t qt = int64_t(gridDim.x) - 1 - blockIdx.x;  // heavy tiles first
  const int64_t b = blockIdx.y / a.H, h = blockIdx.y % a.H, kvh = h / (a.H / a.KH);
  const int64_t q0 = qt * Simt<DQK>::kRows, qpos = q0 + r;
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  float qr[kDpt], acc[kDptV];
#pragma unroll
  for (int i = 0; i < kDpt; ++i) qr[i] = qpos < a.Sq ? to_f(qp[qpos * a.q_ss + part + kParts * i]) * a.scale : 0.f;
#pragma unroll
  for (int i = 0; i < kDptV; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;
  int64_t t_lo, t_hi;
  tile_range(a, q0, Simt<DQK>::kRows, kBN, &t_lo, &t_hi);
  for (int64_t t = t_lo; t < t_hi; ++t) {
    const int64_t kv0 = t * kBN;
    __syncthreads();
    for (int e = tid; e < kBN * DQK; e += kThreads) {
      const int64_t kpos = kv0 + e / DQK;
      Ks[e] = kpos < a.Skv ? to_f(kp[kpos * a.k_ss + e % DQK]) : 0.f;
    }
    for (int e = tid; e < kBN * DV; e += kThreads) {
      const int64_t kpos = kv0 + e / DV;
      Vs[e] = kpos < a.Skv ? to_f(vp[kpos * a.v_ss + e % DV]) : 0.f;
    }
    __syncthreads();
    float s[kBN];
#pragma unroll
    for (int c = 0; c < kBN; ++c) {
      float x = 0.f;
#pragma unroll
      for (int i = 0; i < kDpt; ++i) x = fmaf(qr[i], Ks[c * DQK + part + kParts * i], x);
      s[c] = x;
    }
    float mx = m;
#pragma unroll
    for (int c = 0; c < kBN; ++c) {
#pragma unroll
      for (int lane_mask = 1; lane_mask < kParts; lane_mask <<= 1) s[c] += __shfl_xor_sync(kFull, s[c], lane_mask);
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
    for (int i = 0; i < kDptV; ++i) acc[i] *= corr;
#pragma unroll
    for (int c = 0; c < kBN; ++c) {
#pragma unroll
      for (int i = 0; i < kDptV; ++i) acc[i] = fmaf(s[c], Vs[c * DV + part + kParts * i], acc[i]);
    }
    m = mx;
  }
  if (qpos < a.Sq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* op = static_cast<T*>(a.o) + ((b * a.Sq + qpos) * a.H + h) * DV;
#pragma unroll
    for (int i = 0; i < kDptV; ++i) op[part + kParts * i] = from_f<T>(acc[i] * inv);
    // m is the max of the scaled scores: lse = m + ln(l); -inf for a row that sees no key
    if (a.lse != nullptr && part == 0) a.lse[(b * a.H + h) * a.Sq + qpos] = m == -INFINITY ? -INFINITY : m + logf(l);
  }
}


// ---------------------------------------- bf16: wgmma + TMA, warp-specialized --
constexpr int kBMw = 128;        // query rows per block: two consumer warpgroups x 64
constexpr int kStages = 2;       // K/V ring depth
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 128 x 40 + 256 x 232 = 384 x 168
enum { kSkip, kFullTile, kEdge };

// Block and shared-memory geometry at head dims (DQK, DV). A Q or K tile of
// R rows is kNP panels of R rows x kSW bytes, each panel swizzled over its
// kSW-byte rows; a V tile is kNPv panels of kSWv bytes. Panels are 64
// elements wide (128-byte swizzle) where the head dim is a multiple of 64,
// else 32 (64-byte swizzle): hd 32, and MLA's qk head dim 96, whose
// 192-byte rows are wider than the 128-byte swizzle span. At (96, 64) the
// QK^T product walks 2 k-steps in each of 3 panels, and V and O are the
// hd-64 instance's.
// Up to hd 128 a block is three warpgroups: warpgroup 0 produces and hands
// registers to the consumers (setmaxnreg). ptxas compiles every part of the
// kernel within the launch's share, 168 registers a thread for 12 warps (3
// warps on each SM sub-partition's 16,384 registers), whatever setmaxnreg
// says; at hd 256 a consumer holds 128 (O) + 32 (S) + 16 (P) registers and
// spilled there. So at hd 256 the block is the two consumer warpgroups
// alone (8 warps: 255 registers a thread), and consumer thread 0 issues
// the loads: the first kStages tiles up front, then each next tile into a
// stage as soon as both consumers have released it.
template <int DQK, int DV>
struct Tiling {
  static_assert(DQK % 32 == 0 && DV % 32 == 0, "head dims are whole 32-element panels");
  static constexpr bool kSelfLoad = DQK > 128;               // no producer warpgroup
  static constexpr int kThreads = kSelfLoad ? 256 : 384;
  static constexpr int kBN = DQK <= 128 ? 128 : 64;          // key/value rows per ring stage
  static constexpr int kPW = DQK % 64 ? 32 : 64;             // Q, K: elements per panel row
  static constexpr int kSW = kPW * 2;                        // bytes per panel row = the swizzle span
  static constexpr int kNP = DQK / kPW;                      // panels across the qk head dim
  static constexpr uint64_t kLayout = kSW == 128 ? 1 : 2;   // wgmma descriptor: 128B / 64B swizzle
  static constexpr int kPWv = DV % 64 ? 32 : 64;             // V: the same, across the v head dim
  static constexpr int kSWv = kPWv * 2;
  static constexpr int kNPv = DV / kPWv;
  static constexpr uint64_t kLayoutV = kSWv == 128 ? 1 : 2;
  static constexpr int kQBytes = kBMw * DQK * 2;
  static constexpr int kKBytes = kBN * DQK * 2;              // one K tile
  static constexpr int kVBytes = kBN * DV * 2;               // one V tile
  static constexpr int kStageBytes = kKBytes + kVBytes;      // a ring stage: K, then V
  static constexpr int kSmem = 1024 + kQBytes + kStages * kStageBytes;  // + 1024 to align
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(bar) : "memory");
}

// Arrive and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` of `bar` has completed. A wait
// that outlasts 2^32 cycles (~2 s) traps: a broken ring fails the launch
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (n == 1024) start = clock64();
    if (n > 1024 && clock64() - start > (1ll << 32)) __trap();
  }
}

// TMA: the box at coordinates (c0, c1, c2, c3) of `map` into shared memory
// at `dst`, completing `bytes` of the transactions of `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint64_t layout) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across its issue or its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

// d (64 x 128, fp32) = (scale_d ? d : 0) + A (64 x 16) * B (16 x 128); A and B in shared
// memory behind descriptors, both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, fp32) = (scale_d ? d : 0) + A (64 x 16) * B (16 x 64); A and B in shared
// memory behind descriptors, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 32, fp32) += A (64 x 16, bf16 in registers) * B (16 x 32); B in shared
// memory behind a descriptor, MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 in registers) * B (16 x 64); B in shared
// memory behind a descriptor, MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, fp32) += A (64 x 16, bf16 in registers) * B (16 x 128); B in shared
// memory behind a descriptor, MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_f(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// O += P V for one 64-row consumer: the P fragments pa against the V tile
// at v_base, 16 kv rows per wgmma. At dv 256 each k-step is two n128
// products: columns 128..255 of O are its elements 64..127 (element e sits
// at column 8 * (e / 4) + ...), so each half is a contiguous half of o.
template <int DQK, int DV>
__device__ __forceinline__ void pv_product(float (&o)[DV / 2], uint32_t (&pa)[Tiling<DQK, DV>::kBN / 16][4],
                                           uint32_t v_base) {
  using T = Tiling<DQK, DV>;
  fence_regs(o);
  fence_regs(pa);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < T::kBN / 16; ++kk) {
    // MN-major B: 8-row groups along kv at 8 * kSWv bytes (SBO), panels of
    // 64 head-dim columns at kBN * kSWv bytes (LBO).
    const uint64_t db = smem_desc(v_base + kk * 16 * T::kSWv, T::kBN * T::kSWv, 8 * T::kSWv, T::kLayoutV);
    if constexpr (DV == 256) {
      const uint64_t db_hi =
          smem_desc(v_base + 2 * T::kBN * T::kSWv + kk * 16 * T::kSWv, T::kBN * T::kSWv, 8 * T::kSWv, T::kLayoutV);
      wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&o[0]), pa[kk], db);
      wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&o[64]), pa[kk], db_hi);
    } else if constexpr (DV == 128) wgmma_rs_n128(o, pa[kk], db);
    else if constexpr (DV == 64) wgmma_rs_n64(o, pa[kk], db);
    else wgmma_rs_n32(o, pa[kk], db);
  }
  wgmma_commit();
  wgmma_wait();
  fence_regs(o);
  fence_regs(pa);
}

// One KV tile for one consumer: S = Q K^T, online softmax, O += P V.
// Element e of S (and of O) sits at row r0 + 8 * ((e % 4) >> 1) of the
// consumer and column 8 * (e / 4) + 2 * (lane % 4) + (e % 2), r0 =
// 16 * warp + lane / 4. kMask masks positions in int32: kv0 is the tile's
// first key, qrow0 the thread's first query row.
template <int DQK, int DV, bool kMask>
__device__ __forceinline__ void tile_step(float (&o)[DV / 2], float (&m)[2], float (&l)[2], uint32_t q_base,
                                          uint32_t k_base, uint32_t v_base, int kv0, int qrow0, int skv,
                                          int causal, int win, float c) {
  using T = Tiling<DQK, DV>;
  float s[T::kBN / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DQK / 16; ++kk) {
    // K-major A and B: 8-row groups at 8 * kSW bytes (SBO); a k-step moves
    // 32 bytes along a swizzled row, a panel at every kPW elements.
    const int panel = kk * 16 / T::kPW, off = (kk * 16 % T::kPW) * 2;
    const uint64_t da = smem_desc(q_base + panel * kBMw * T::kSW + off, 0, 8 * T::kSW, T::kLayout);
    const uint64_t db = smem_desc(k_base + panel * T::kBN * T::kSW + off, 0, 8 * T::kSW, T::kLayout);
    if constexpr (T::kBN == 128) wgmma_ss_n128(s, da, db, kk > 0);
    else wgmma_ss_n64(s, da, db, kk > 0);
  }
  wgmma_commit();
  wgmma_wait();
  fence_regs(s);

  const int col = 2 * (threadIdx.x & 3);
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int e = 0; e < T::kBN / 2; ++e) {
    if (kMask) {
      const int kpos = kv0 + 8 * (e >> 2) + col + (e & 1);
      const int qpos = qrow0 + 8 * ((e >> 1) & 1);
      const bool vis = kpos < skv && (!causal || kpos <= qpos) && (win <= 0 || kpos > qpos - win);
      s[e] = vis ? s[e] : -INFINITY;
    }
    mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
  }
  float mc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
    const float m_safe = mx[i] == -INFINITY ? 0.f : mx[i];
    const float corr = m[i] == -INFINITY ? 0.f : exp2f((m[i] - m_safe) * c);
    mc[i] = m_safe * c;
    l[i] *= corr;  // l is this lane's partial row sum; lanes meet at the end
    m[i] = mx[i];
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      o[4 * j + 2 * i] *= corr;
      o[4 * j + 2 * i + 1] *= corr;
    }
  }
  // P = exp2(s * c - m * c), re-packed as the A fragments of P V: elements
  // 8kk .. 8kk + 7 of S are exactly the 64 x 16 A operand of k-step kk.
  uint32_t pa[T::kBN / 16][4];
#pragma unroll
  for (int kk = 0; kk < T::kBN / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = 8 * kk + 2 * i, row = i & 1;
      const float p0 = exp2f(fmaf(s[e], c, -mc[row])), p1 = exp2f(fmaf(s[e + 1], c, -mc[row]));
      l[row] += p0 + p1;
      pa[kk][i] = pack_f(p0, p1);
    }
  }
  pv_product<DQK, DV>(o, pa, v_base);
}

// Whether a consumer with query rows [r_lo, r_hi] needs KV tile [kv0,
// kv0 + BN): kSkip (nothing visible), kFullTile (everything visible) or
// kEdge (masked).
template <int BN>
__device__ __forceinline__ int tile_kind(int r_lo, int r_hi, int kv0, int skv, int causal, int win) {
  if (r_lo > r_hi || (causal && kv0 > r_hi) || (win > 0 && kv0 + BN - 1 <= r_lo - win)) return kSkip;
  const bool full = kv0 + BN <= skv && (!causal || kv0 + BN - 1 <= r_lo) && (win <= 0 || kv0 > r_hi - win);
  return full ? kFullTile : kEdge;
}

// The KV tiles of BN rows, [t_lo, t_hi), that the block of query rows
// [q0, q0 + kBMw) needs.
template <int BN>
__device__ __forceinline__ void kv_tile_range(const Args& a, int q0, int* t_lo, int* t_hi) {
  const int q_last = min(q0 + kBMw, int(a.Sq)) - 1;
  const int kv_end = a.causal ? min(int(a.Skv), q_last + 1) : int(a.Skv);
  const int kv_begin = a.window > 0 ? int(max(int64_t(0), q0 - a.window + 1)) : 0;
  *t_lo = kv_begin / BN;
  *t_hi = (kv_end + BN - 1) / BN;
}

// Those tiles, in order. The producer and both consumers walk them through
// this one function, so the ring's stages and phases stay in step.
template <int BN, class Visit>
__device__ __forceinline__ void walk_kv_tiles(const Args& a, int q0, Visit&& visit) {
  int t_lo, t_hi;
  kv_tile_range<BN>(a, q0, &t_lo, &t_hi);
  for (int t = t_lo; t < t_hi; ++t) {
    visit(t);
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(Tiling<DQK, DV>::kThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, Args a) {
  using T = Tiling<DQK, DV>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];  // q, full[kStages], empty[kStages]
  const uint32_t smem_q = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  const uint32_t smem_kv = smem_q + T::kQBytes;  // stage s: K at + s kStageBytes, V after it
  const uint32_t bar_q = static_cast<uint32_t>(__cvta_generic_to_shared(bars));
  auto bar_full = [&](int s) { return bar_q + 8 * (1 + s); };
  auto bar_empty = [&](int s) { return bar_q + 8 * (1 + kStages + s); };

  const int b = blockIdx.x / int(a.H), h = blockIdx.x % int(a.H), kvh = h / int(a.H / a.KH);
  const int q0 = (int(gridDim.y) - 1 - int(blockIdx.y)) * kBMw;  // heavy tiles first
  const int wg = threadIdx.x / 128;
  int t_lo, t_hi;
  kv_tile_range<T::kBN>(a, q0, &t_lo, &t_hi);
  // TMA of K/V tile t into ring stage `stage`, completing its full barrier.
  auto load_tile = [&](int t, int stage) {
    mbar_expect_tx(bar_full(stage), T::kStageBytes);
    const uint32_t k_dst = smem_kv + stage * T::kStageBytes, v_dst = k_dst + T::kKBytes;
    for (int p = 0; p < T::kNP; ++p) {
      tma_load_4d(k_dst + p * T::kBN * T::kSW, &tk, bar_full(stage), p * T::kPW, kvh, t * T::kBN, b);
    }
    for (int p = 0; p < T::kNPv; ++p) {
      tma_load_4d(v_dst + p * T::kBN * T::kSWv, &tv, bar_full(stage), p * T::kPWv, kvh, t * T::kBN, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // the producer's thread, or the loading consumer's
    mbar_expect_tx(bar_q, T::kQBytes);
    for (int p = 0; p < T::kNP; ++p) tma_load_4d(smem_q + p * kBMw * T::kSW, &tq, bar_q, p * T::kPW, h, q0, b);
    if constexpr (T::kSelfLoad) {
      for (int i = 0; i < kStages && t_lo + i < t_hi; ++i) load_tile(t_lo + i, i);
    }
  }

  if (!T::kSelfLoad && wg == 0) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      walk_kv_tiles<T::kBN>(a, q0, [&](int t) {
        mbar_wait(bar_empty(stage), phase ^ 1);
        load_tile(t, stage);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      });
    }
  } else {
    // ----------------------------------------------------------- consumers
    if constexpr (!T::kSelfLoad) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int c = T::kSelfLoad ? wg : wg - 1, lane = threadIdx.x & 31;
    const int sq = int(a.Sq), skv = int(a.Skv), causal = a.causal;
    const int win = a.window > 0 ? int(min(a.window, a.Sq + a.Skv)) : 0;
    const float scale_log2 = a.scale * 1.4426950408889634f;
    const int r_lo = q0 + 64 * c, r_hi = min(r_lo + 63, sq - 1);
    const int qrow0 = r_lo + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);  // and qrow0 + 8
    const uint32_t q_base = smem_q + 64 * c * T::kSW;
    float o[DV / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
    mbar_wait(bar_q, 0);
    int stage = 0;
    uint32_t phase = 0;
    walk_kv_tiles<T::kBN>(a, q0, [&](int t) {
      // Wait for the tile even when skipping it: the empty arrival below
      // must not count toward the stage's previous phase.
      mbar_wait(bar_full(stage), phase);
      const int kv0 = t * T::kBN, kind = tile_kind<T::kBN>(r_lo, r_hi, kv0, skv, causal, win);
      const uint32_t k_base = smem_kv + stage * T::kStageBytes, v_base = k_base + T::kKBytes;
      if (kind == kFullTile) {
        tile_step<DQK, DV, false>(o, m, l, q_base, k_base, v_base, kv0, qrow0, skv, causal, win, scale_log2);
      } else if (kind == kEdge) {
        tile_step<DQK, DV, true>(o, m, l, q_base, k_base, v_base, kv0, qrow0, skv, causal, win, scale_log2);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty(stage));
      if constexpr (T::kSelfLoad) {
        if (threadIdx.x == 0 && t + kStages < t_hi) {
          mbar_wait(bar_empty(stage), phase);  // both consumers are done with this stage
          load_tile(t + kStages, stage);
        }
        __syncwarp();
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    });
    const int col = 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(kFull, l[i], 1);
      l[i] += __shfl_xor_sync(kFull, l[i], 2);
      const int qpos = qrow0 + 8 * i;
      if (qpos >= sq) continue;  // rows past Sq came from TMA's zero fill
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      // m is the max of the unscaled scores and l sums exp2((s - m) * scale * log2(e)) =
      // exp(scale * (s - m)), so in natural-log units lse = scale * m + ln(l)
      if (a.lse != nullptr && (lane & 3) == 0) {
        a.lse[(int64_t(b) * a.H + h) * sq + qpos] = m[i] == -INFINITY ? -INFINITY : m[i] * a.scale + logf(l[i]);
      }
      __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.o) + ((int64_t(b) * sq + qpos) * a.H + h) * DV + col;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found at run time, so the library
// links against the runtime only.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A 4-D bf16 map over (hd, heads, S, B) with element strides (1, sh, ss, sb)
// and a box of (pw, 1, rows, 1); out-of-bounds rows read as zeros. A dim of
// size 1 is never stepped, so its stride is replaced by a valid one.
bool tensor_map(CUtensorMap* map, const void* base, int64_t hd, int64_t heads, int64_t S, int64_t B, int64_t sh,
                int64_t ss, int64_t sb, int pw, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(base) % 16) return false;
  const cuuint64_t dims[4] = {cuuint64_t(hd), cuuint64_t(heads), cuuint64_t(S), cuuint64_t(B)};
  const int64_t elem_strides[3] = {sh, ss, sb};
  cuuint64_t strides[3];
  cuuint64_t packed = cuuint64_t(hd) * 2;
  for (int i = 0; i < 3; ++i) {
    strides[i] = dims[i + 1] == 1 ? packed : cuuint64_t(elem_strides[i]) * 2;
    if (strides[i] % 16) return false;
    packed = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {cuuint32_t(pw), 1, cuuint32_t(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, pw * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DQK, int DV>
cudaError_t launch_wgmma(cudaStream_t s, const Args& a) {
  using T = Tiling<DQK, DV>;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, a.q, DQK, a.H, a.Sq, a.B, a.q_sh, a.q_ss, a.q_sb, T::kPW, kBMw) ||
      !tensor_map(&tk, a.k, DQK, a.KH, a.Skv, a.B, a.k_sh, a.k_ss, a.k_sb, T::kPW, T::kBN) ||
      !tensor_map(&tv, a.v, DV, a.KH, a.Skv, a.B, a.v_sh, a.v_ss, a.v_sb, T::kPWv, T::kBN)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err =
      cudaFuncSetAttribute(flash_fwd_wgmma<DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(a.B * a.H), static_cast<unsigned>((a.Sq + kBMw - 1) / kBMw));
  flash_fwd_wgmma<DQK, DV><<<grid, T::kThreads, T::kSmem, s>>>(tq, tk, tv, a);
  return cudaGetLastError();
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

template <int DQK, int DV>
cudaError_t dispatch(int dtype, cudaStream_t s, const Args& a) {
  if (dtype == 1) return launch_wgmma<DQK, DV>(s, a);
  const dim3 grid(static_cast<unsigned>((a.Sq + Simt<DQK>::kRows - 1) / Simt<DQK>::kRows),
                  static_cast<unsigned>(a.B * a.H));
  return launch(flash_fwd_simt<float, DQK, DV>, grid, 256, size_t(Simt<DQK>::kBN) * (DQK + DV) * sizeof(float), s,
                a);
}

}  // namespace

// q (B, Sq, H, hd), k (B, Skv, K, hd) and v (B, Skv, K, hd_v) on the
// device, last dim contiguous, element strides in `strides` (host array:
// q's b, s, h, then k's, then v's). o: contiguous (B, Sq, H, hd_v) of q's
// dtype. dtype 0 is float32, 1 is bfloat16; (hd, hd_v) is (32, 32), (64,
// 64), (128, 128), (256, 256) or (96, 64). bfloat16 goes through TMA: q,
// k, v 16-byte aligned and every stride of a dim longer than 1 a multiple
// of 8 elements. Launches on `stream`; returns cudaGetLastError() as an
// int (cudaErrorInvalidValue, 1, for an unsupported dtype, pair of head
// dims or layout). lse: null, or (B, H, Sq) float32 that takes each row's
// log-sum-exp of its scaled scores (natural log; -inf where no key is
// visible), what the backward (csrc/flash_attn_bwd.cu) recomputes P from.
// The output does not depend on it.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v, void* o, float* lse, int64_t B,
                                 int64_t Sq, int64_t Skv, int64_t H, int64_t KH, int64_t hd, int64_t hd_v,
                                 const int64_t* strides, float scale, int causal, int64_t window,
                                 int dtype, void* stream) {
  Args a{q, k, v, o, B, Sq, Skv, H, KH,
         strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
         strides[6], strides[7], strides[8], scale, causal, window, lse};
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
