// 128-bit content fingerprints of fixed-width uint32 rows, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fingerprint.py::_fingerprint_kernel (the Pallas
// TPU kernel behind fingerprint_chunks_pallas).
//
// Computes, per row r of a (C, W) uint32 matrix and lane l in 0..3:
//     fp[r, l] = fmix32( sum_i fmix32(w[r,i]*A_l + (i+1)*B_l) + W*C_l )   mod 2^32
// Every word up to the row width W counts, zero words included: a zero word
// still adds fmix32((i+1)*B_l). Only the grid's own tiling beyond W is masked.
//
// What bounds it on this card: integer operations. Each word costs 4 lanes x
// (2 multiply-adds + 8 fmix32 shift/xor/multiply steps + 1 accumulate) = 44
// 32-bit integer operations for 4 bytes read, i.e. 11 operations per byte.
// An H100 SXM issues at most ~33.5 T such operations/s (132 SMs x 128 lanes x
// 1.98 GHz; multiply-adds go to the FMA lanes, shifts and xors to the INT32
// units) against 3.35 TB/s of HBM, so it breaks even at ~10 operations per
// byte: the ALUs and not HBM set the floor, by a little.
//
// What the design does about it: the lane constants are compile-time
// immediates, the four lane sums live in registers for the whole slab, and
// the position salt is the loop's own index. Each block owns one (row, slab)
// pair so the grid is ~33 slabs x C rows, enough to fill all SMs at the
// checkpoint's shapes. Addition mod 2^32 is commutative, so the per-slab
// partial sums meet in one unsigned atomicAdd per lane per block and the
// result is deterministic; a finalize pass adds the length salt and mixes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                  // threads per block
constexpr int kWordsPerThread = 32;            // words each thread folds in
constexpr int kSlab = kThreads * kWordsPerThread;  // words per block

constexpr uint32_t kA0 = 0x9E3779B1u, kA1 = 0x85EBCA77u, kA2 = 0xC2B2AE3Du, kA3 = 0x27D4EB2Fu;
constexpr uint32_t kB0 = 0x165667B1u, kB1 = 0xD3A2646Du, kB2 = 0xFD7046C5u, kB3 = 0xB55A4F09u;

__constant__ uint32_t kC[4] = {0x94D049BBu, 0xBF58476Du, 0x2545F491u, 0x9E3779B9u};

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// grid = (C rows, ceil(W / kSlab) slabs); acc (C, 4) must be zero on entry.
__global__ void __launch_bounds__(kThreads)
fp_accumulate(const uint32_t* __restrict__ words, int64_t n_words,
              uint32_t* __restrict__ acc) {
  const int64_t row = blockIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * kSlab;
  const uint32_t* rowp = words + row * n_words;
  uint32_t s0 = 0, s1 = 0, s2 = 0, s3 = 0;
#pragma unroll 8
  for (int j = 0; j < kWordsPerThread; ++j) {
    const int64_t i = base + j * kThreads + threadIdx.x;
    if (i < n_words) {
      const uint32_t w = __ldg(rowp + i);
      const uint32_t pos = static_cast<uint32_t>(i + 1);
      s0 += fmix32(w * kA0 + pos * kB0);
      s1 += fmix32(w * kA1 + pos * kB1);
      s2 += fmix32(w * kA2 + pos * kB2);
      s3 += fmix32(w * kA3 + pos * kB3);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, off);
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    s3 += __shfl_xor_sync(0xffffffffu, s3, off);
  }
  __shared__ uint32_t part[kThreads / 32][4];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    part[warp][0] = s0;
    part[warp][1] = s1;
    part[warp][2] = s2;
    part[warp][3] = s3;
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    uint32_t t = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) t += part[w][threadIdx.x];
    atomicAdd(acc + row * 4 + threadIdx.x, t);
  }
}

__global__ void fp_finalize(uint32_t* __restrict__ acc, int64_t n_vals, uint32_t n_words) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n_vals) acc[i] = fmix32(acc[i] + n_words * kC[i & 3]);
}

}  // namespace

// words: (n_rows, n_words) uint32, contiguous, on the device; out: (n_rows, 4)
// uint32. Launches on `stream`; returns cudaGetLastError() as an int.
extern "C" int fp_chunks_launch(const void* words, int64_t n_rows, int64_t n_words,
                                void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* acc = static_cast<uint32_t*>(out);
  cudaError_t err = cudaMemsetAsync(acc, 0, n_rows * 4 * sizeof(uint32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(n_rows),
                  static_cast<unsigned>((n_words + kSlab - 1) / kSlab));
  fp_accumulate<<<grid, kThreads, 0, s>>>(static_cast<const uint32_t*>(words), n_words, acc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_vals = n_rows * 4;
  fp_finalize<<<static_cast<unsigned>((n_vals + 255) / 256), 256, 0, s>>>(
      acc, n_vals, static_cast<uint32_t>(n_words));
  return static_cast<int>(cudaGetLastError());
}
