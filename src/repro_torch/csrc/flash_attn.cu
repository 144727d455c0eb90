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
// in VMEM (hence its Skv <= 24k cap); here K/V tiles stream through shared
// memory, so any Skv works and the (Sq, Skv) scores never reach device
// memory. Tiles wholly above the causal diagonal or wholly before the
// window are skipped; heavy (late) query tiles are scheduled first. Ragged
// Sq and Skv are masked, not required to divide the tile.
//  - bf16: flash_fwd_wgmma, warp-specialized in the shape of
//    FlashAttention-3. A block owns 128 query rows of one (batch, head) and
//    has three warpgroups. Warpgroup 0 is the producer: one thread loads Q
//    once and then K/V tiles of 128 rows with TMA (cp.async.bulk.tensor)
//    into a ring of kStages stages, each with a full and an empty mbarrier.
//    Warpgroups 1 and 2 are consumers of 64 query rows each: S = Q K^T is
//    wgmma m64n128k16 with Q and K read from shared memory through
//    descriptors; O += P V is wgmma m64nHDk16 with P re-packed from the
//    fp32 S accumulators into bf16 A-register fragments (P never touches
//    shared memory) and V read in its natural (Skv, hd) layout as an
//    MN-major B operand (the transpose bit). setmaxnreg moves registers
//    from the producer to the consumers. Shared tiles are stored in panels
//    64 elements wide with the 128-byte swizzle (hd 64 and 128; hd 32, whose
//    rows are 64 bytes, takes the 64-byte swizzle); the TMA maps and the
//    wgmma descriptors agree on it. Each (consumer, KV tile) pair is skipped,
//    full (no mask) or an edge (masked in int32: the diagonal, the window
//    edge, the ragged end, where TMA's zero rows must not count), and
//    exp2f takes scale * log2(e) folded in. Query heads of one KV group are
//    adjacent in the grid, so their K/V tiles are read from L2.
//  - fp32: flash_fwd_simt, scalar fp32 FMA (the tensor cores' TF32 would
//    not hold the fp32 tolerance). 4 threads per query row, each owning a
//    quarter of the head dim; partial dot products meet by warp shuffles.

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBM = 64;  // query rows per block (fp32)
constexpr int kBN = 64;  // key/value rows per streamed tile (fp32)
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
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

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


// ---------------------------------------- bf16: wgmma + TMA, warp-specialized --
constexpr int kBMw = 128;        // query rows per block: two consumer warpgroups x 64
constexpr int kBNw = 128;        // key/value rows per ring stage
constexpr int kStages = 2;       // K/V ring depth
constexpr int kThreadsW = 384;   // warpgroup 0 produces, 1 and 2 consume
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 128 x 40 + 256 x 232 = 384 x 168
enum { kSkip, kFullTile, kEdge };

// Shared-memory geometry at head dim HD. A tile of R rows is kNP panels of
// R rows x kSW bytes, each panel swizzled over its kSW-byte rows.
template <int HD>
struct Tiling {
  static constexpr int kPW = HD < 64 ? HD : 64;              // elements per panel row
  static constexpr int kSW = kPW * 2;                        // bytes per panel row = the swizzle span
  static constexpr int kNP = HD / kPW;                       // panels across the head dim
  static constexpr uint64_t kLayout = kSW == 128 ? 1 : 2;   // wgmma descriptor: 128B / 64B swizzle
  static constexpr int kQBytes = kBMw * HD * 2;
  static constexpr int kTileBytes = kBNw * HD * 2;           // one K or one V tile
  static constexpr int kSmem = 1024 + kQBytes + kStages * 2 * kTileBytes;  // + 1024 to align
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
// at v_base, 16 kv rows per wgmma.
template <int HD>
__device__ __forceinline__ void pv_product(float (&o)[HD / 2], uint32_t (&pa)[kBNw / 16][4], uint32_t v_base) {
  using T = Tiling<HD>;
  fence_regs(o);
  fence_regs(pa);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBNw / 16; ++kk) {
    // MN-major B: 8-row groups along kv at 8 * kSW bytes (SBO), panels of
    // 64 head-dim columns at kBNw * kSW bytes (LBO).
    const uint64_t db = smem_desc(v_base + kk * 16 * T::kSW, kBNw * T::kSW, 8 * T::kSW, T::kLayout);
    if constexpr (HD == 128) wgmma_rs_n128(o, pa[kk], db);
    else if constexpr (HD == 64) wgmma_rs_n64(o, pa[kk], db);
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
template <int HD, bool kMask>
__device__ __forceinline__ void tile_step(float (&o)[HD / 2], float (&m)[2], float (&l)[2], uint32_t q_base,
                                          uint32_t k_base, uint32_t v_base, int kv0, int qrow0, int skv,
                                          int causal, int win, float c) {
  using T = Tiling<HD>;
  float s[kBNw / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    // K-major A and B: 8-row groups at 8 * kSW bytes (SBO); a k-step moves
    // 32 bytes along a swizzled row, a panel at every 64 elements.
    const int panel = kk * 16 / T::kPW, off = (kk * 16 % T::kPW) * 2;
    wgmma_ss_n128(s, smem_desc(q_base + panel * kBMw * T::kSW + off, 0, 8 * T::kSW, T::kLayout),
                  smem_desc(k_base + panel * kBNw * T::kSW + off, 0, 8 * T::kSW, T::kLayout), kk > 0);
  }
  wgmma_commit();
  wgmma_wait();
  fence_regs(s);

  const int col = 2 * (threadIdx.x & 3);
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int e = 0; e < kBNw / 2; ++e) {
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
    for (int j = 0; j < HD / 8; ++j) {
      o[4 * j + 2 * i] *= corr;
      o[4 * j + 2 * i + 1] *= corr;
    }
  }
  // P = exp2(s * c - m * c), re-packed as the A fragments of P V: elements
  // 8kk .. 8kk + 7 of S are exactly the 64 x 16 A operand of k-step kk.
  uint32_t pa[kBNw / 16][4];
#pragma unroll
  for (int kk = 0; kk < kBNw / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = 8 * kk + 2 * i, row = i & 1;
      const float p0 = exp2f(fmaf(s[e], c, -mc[row])), p1 = exp2f(fmaf(s[e + 1], c, -mc[row]));
      l[row] += p0 + p1;
      pa[kk][i] = pack_f(p0, p1);
    }
  }
  pv_product<HD>(o, pa, v_base);
}

// Whether a consumer with query rows [r_lo, r_hi] needs KV tile [kv0,
// kv0 + kBNw): kSkip (nothing visible), kFullTile (everything visible) or
// kEdge (masked).
__device__ __forceinline__ int tile_kind(int r_lo, int r_hi, int kv0, int skv, int causal, int win) {
  if (r_lo > r_hi || (causal && kv0 > r_hi) || (win > 0 && kv0 + kBNw - 1 <= r_lo - win)) return kSkip;
  const bool full = kv0 + kBNw <= skv && (!causal || kv0 + kBNw - 1 <= r_lo) && (win <= 0 || kv0 > r_hi - win);
  return full ? kFullTile : kEdge;
}

// The KV tiles that the block of query rows [q0, q0 + kBMw) walks, in
// order. The producer and both consumers walk them through this one
// function, so the ring's stages and phases stay in step.
template <class Visit>
__device__ __forceinline__ void walk_kv_tiles(const Args& a, int q0, Visit&& visit) {
  const int q_last = min(q0 + kBMw, int(a.Sq)) - 1;
  const int kv_end = a.causal ? min(int(a.Skv), q_last + 1) : int(a.Skv);
  const int kv_begin = a.window > 0 ? int(max(int64_t(0), q0 - a.window + 1)) : 0;
  const int t_lo = kv_begin / kBNw, t_hi = (kv_end + kBNw - 1) / kBNw;
  for (int t = t_lo; t < t_hi; ++t) {
    visit(t);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreadsW, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, Args a) {
  using T = Tiling<HD>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];  // q, full[kStages], empty[kStages]
  const uint32_t smem_q = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  const uint32_t smem_kv = smem_q + T::kQBytes;  // stage s: K at + 2 s kTileBytes, V after it
  const uint32_t bar_q = static_cast<uint32_t>(__cvta_generic_to_shared(bars));
  auto bar_full = [&](int s) { return bar_q + 8 * (1 + s); };
  auto bar_empty = [&](int s) { return bar_q + 8 * (1 + kStages + s); };

  const int b = blockIdx.x / int(a.H), h = blockIdx.x % int(a.H), kvh = h / int(a.H / a.KH);
  const int q0 = (int(gridDim.y) - 1 - int(blockIdx.y)) * kBMw;  // heavy tiles first
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, T::kQBytes);
      for (int p = 0; p < T::kNP; ++p) tma_load_4d(smem_q + p * kBMw * T::kSW, &tq, bar_q, p * T::kPW, h, q0, b);
      int stage = 0;
      uint32_t phase = 0;
      walk_kv_tiles(a, q0, [&](int t) {
        mbar_wait(bar_empty(stage), phase ^ 1);
        mbar_expect_tx(bar_full(stage), 2 * T::kTileBytes);
        const uint32_t k_dst = smem_kv + stage * 2 * T::kTileBytes;
        for (int p = 0; p < T::kNP; ++p) {
          tma_load_4d(k_dst + p * kBNw * T::kSW, &tk, bar_full(stage), p * T::kPW, kvh, t * kBNw, b);
          tma_load_4d(k_dst + T::kTileBytes + p * kBNw * T::kSW, &tv, bar_full(stage), p * T::kPW, kvh,
                      t * kBNw, b);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      });
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int c = wg - 1, lane = threadIdx.x & 31;
    const int sq = int(a.Sq), skv = int(a.Skv), causal = a.causal;
    const int win = a.window > 0 ? int(min(a.window, a.Sq + a.Skv)) : 0;
    const float scale_log2 = a.scale * 1.4426950408889634f;
    const int r_lo = q0 + 64 * c, r_hi = min(r_lo + 63, sq - 1);
    const int qrow0 = r_lo + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);  // and qrow0 + 8
    const uint32_t q_base = smem_q + 64 * c * T::kSW;
    float o[HD / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    mbar_wait(bar_q, 0);
    int stage = 0;
    uint32_t phase = 0;
    walk_kv_tiles(a, q0, [&](int t) {
      // Wait for the tile even when skipping it: the empty arrival below
      // must not count toward the stage's previous phase.
      mbar_wait(bar_full(stage), phase);
      const int kv0 = t * kBNw, kind = tile_kind(r_lo, r_hi, kv0, skv, causal, win);
      const uint32_t k_base = smem_kv + stage * 2 * T::kTileBytes, v_base = k_base + T::kTileBytes;
      if (kind == kFullTile) {
        tile_step<HD, false>(o, m, l, q_base, k_base, v_base, kv0, qrow0, skv, causal, win, scale_log2);
      } else if (kind == kEdge) {
        tile_step<HD, true>(o, m, l, q_base, k_base, v_base, kv0, qrow0, skv, causal, win, scale_log2);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty(stage));
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
      __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.o) + ((int64_t(b) * sq + qpos) * a.H + h) * HD + col;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
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

template <int HD>
cudaError_t launch_wgmma(cudaStream_t s, const Args& a) {
  using T = Tiling<HD>;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, a.q, HD, a.H, a.Sq, a.B, a.q_sh, a.q_ss, a.q_sb, T::kPW, kBMw) ||
      !tensor_map(&tk, a.k, HD, a.KH, a.Skv, a.B, a.k_sh, a.k_ss, a.k_sb, T::kPW, kBNw) ||
      !tensor_map(&tv, a.v, HD, a.KH, a.Skv, a.B, a.v_sh, a.v_ss, a.v_sb, T::kPW, kBNw)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(a.B * a.H), static_cast<unsigned>((a.Sq + kBMw - 1) / kBMw));
  flash_fwd_wgmma<HD><<<grid, kThreadsW, T::kSmem, s>>>(tq, tk, tv, a);
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

template <int HD>
cudaError_t dispatch(int dtype, dim3 grid, cudaStream_t s, const Args& a) {
  if (dtype == 1) return launch_wgmma<HD>(s, a);
  return launch(flash_fwd_simt<float, HD>, grid, 256, size_t(2) * kBN * HD * sizeof(float), s, a);
}

}  // namespace

// q (B, Sq, H, hd), k and v (B, Skv, K, hd) on the device, last dim
// contiguous, element strides in `strides` (host array: q's b, s, h, then
// k's, then v's). o: contiguous (B, Sq, H, hd) of q's dtype. dtype 0 is
// float32, 1 is bfloat16; hd is 32, 64 or 128. bfloat16 goes through TMA:
// q, k, v 16-byte aligned and every stride of a dim longer than 1 a
// multiple of 8 elements. Launches on `stream`; returns cudaGetLastError()
// as an int (cudaErrorInvalidValue, 1, for an unsupported dtype, head dim
// or layout).
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v, void* o, int64_t B,
                                 int64_t Sq, int64_t Skv, int64_t H, int64_t KH, int64_t hd,
                                 const int64_t* strides, float scale, int causal, int64_t window,
                                 int dtype, void* stream) {
  Args a{q, k, v, o, B, Sq, Skv, H, KH,
         strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
         strides[6], strides[7], strides[8], scale, causal, window};
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
