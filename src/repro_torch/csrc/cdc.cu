// Windowed gear-hash content-defined chunking for Hopper (sm_90a): window
// hashes, and the fused hash + min/max-size cut selection over a wave of
// byte streams.
//
// Replaces:
//   * src/repro/kernels/cdc.py::_cdc_cut_kernel (cdc_cut_masks_pallas) with
//     phase A (bitmap mode) + phase B below;
//   * src/repro/kernels/cdc.py::_cdc_kernel (cdc_hashes_pallas,
//     cdc_boundaries_pallas) with phase A in hash mode (the same template).
//
// Semantics, per stream of n bytes b_0..b_{n-1} (T = the 256-entry gear table):
//   h_i   = sum_{k=0}^{31} T[b_{i-k}] << k  (mod 2^32; b_j for j < 0 adds 0)
//   cand_i = (h_i & mask) == 0
//   cuts: sp = 0; loop { lo = sp + min; stop if lo >= n;
//                        hard = max(lo, sp + max - 1);
//                        cut = first cand >= lo if it is <= hard, else hard;
//                        stop if cut >= n; emit cut; sp = cut + 1 }
//
// What bounds it on this card: bytes. Phase A reads each stream byte once
// and does ~4 integer operations per byte (gear lookup, shift-add, mask,
// compare), well under the ~10 operations per byte at which an H100's
// integer issue rate meets its 3.35 TB/s; the function's output (one bool
// per byte) is as large as its input. Phase B is a serial walk per stream
// whose cost is the latency of a few dependent loads per cut, not bandwidth.
//
// What the design does about it:
//   * Phase A runs over every tile of every stream at once (a GPU grid has no
//     order, so nothing is carried between blocks). It reads the bytes
//     themselves, 16 bytes per load, and keeps the gear table in shared
//     memory, where the TPU path first materialized 4-byte gear values.
//     Each thread owns 32 consecutive positions and rolls the hash over the
//     31 bytes before them (from the previous tile of the same stream, zeros
//     at the stream head): h_q = (h_{q-1} << 1) + T[b_q] equals the 32-term
//     window sum because a term leaves the 32-bit word after 32 shifts. So
//     the 32 shifted adds cost one shift-add per byte. The thread writes one
//     32-bit candidate word (level 0); a __ballot_sync of "word != 0" gives a
//     level-1 word with one bit per level-0 word.
//   * Phase B gives each stream one warp and carries "last cut + 1" in a
//     register. The warp finds the next candidate >= lo from the level-0
//     word at lo, then 128 level-1 words (131,072 positions) per step, so a
//     cut costs a handful of dependent loads instead of a scan of the bytes.
//     It sees the whole stream, so no drained-tile argument is needed.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;           // phase-A threads per block; x 32 positions each
constexpr int kTileL1 = kThreads / 32;  // level-1 words per tile
constexpr unsigned kFull = 0xffffffffu;

struct Wave {
  const uint64_t* ptrs;     // (S,) stream base addresses, 16-byte aligned
  const int64_t* lens;      // (S,) byte lengths, all >= 1
  const int64_t* tile_off;  // (S+1,) prefix sums of ceil(len / (kThreads * 32))
  const int64_t* pos_off;   // (S+1,) prefix sums of len
  int n_streams;
};

// The stream s with tile_off[s] <= tile < tile_off[s+1].
__device__ __forceinline__ int stream_of_tile(const int64_t* tile_off, int n_streams,
                                              int64_t tile) {
  int lo = 0, hi = n_streams;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (tile_off[mid] <= tile) lo = mid; else hi = mid;
  }
  return lo;
}

// Phase A. kHashes: write the u32 window hash of every position to `hashes`
// (at pos_off[s] + position). Otherwise write the candidate bitmap: level 0
// (`l0`, one bit per position, tile_off[s] * kThreads words per stream start)
// and level 1 (`l1`, one bit per level-0 word).
template <bool kHashes>
__global__ void __launch_bounds__(kThreads)
cdc_phase_a(Wave wave, const uint32_t* __restrict__ gear, uint32_t mask,
            uint32_t* __restrict__ l0, uint32_t* __restrict__ l1,
            uint32_t* __restrict__ hashes) {
  __shared__ uint32_t table[256];
  table[threadIdx.x] = gear[threadIdx.x];
  __syncthreads();

  const int64_t tile = blockIdx.x;
  const int s = stream_of_tile(wave.tile_off, wave.n_streams, tile);
  const int64_t n = wave.lens[s];
  const uint8_t* p = reinterpret_cast<const uint8_t*>(wave.ptrs[s]);
  const int64_t wi = (tile - wave.tile_off[s]) * kThreads + threadIdx.x;
  const int64_t p0 = wi * 32;  // first position this thread owns

  // Bytes [p0 - 32, p0 + 32) as 16 little-endian words; bytes outside [0, n)
  // read as 0 (and are never hashed in below).
  uint32_t buf[16];
  if (p0 >= 32 && p0 + 32 <= n) {
    const uint4* v = reinterpret_cast<const uint4*>(p + p0 - 32);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 x = __ldg(v + i);
      buf[4 * i] = x.x;
      buf[4 * i + 1] = x.y;
      buf[4 * i + 2] = x.z;
      buf[4 * i + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      uint32_t w = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int64_t q = p0 - 32 + 4 * i + b;
        if (q >= 0 && q < n) w |= static_cast<uint32_t>(p[q]) << (8 * b);
      }
      buf[i] = w;
    }
  }

  // Warm up over the 31 bytes before p0; before the stream head h stays 0.
  uint32_t h = 0;
#pragma unroll
  for (int i = 1; i < 32; ++i) {
    const uint32_t byte = (buf[i >> 2] >> (8 * (i & 3))) & 0xffu;
    if (p0 - 32 + i >= 0) h = (h << 1) + table[byte];
  }
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int i = 32 + j;
    const uint32_t byte = (buf[i >> 2] >> (8 * (i & 3))) & 0xffu;
    h = (h << 1) + table[byte];
    if (p0 + j < n) {
      if constexpr (kHashes) {
        hashes[wave.pos_off[s] + p0 + j] = h;
      } else {
        word |= static_cast<uint32_t>((h & mask) == 0u) << j;
      }
    }
  }
  if constexpr (!kHashes) {
    const int64_t g = wave.tile_off[s] * kThreads + wi;  // global level-0 word
    l0[g] = word;
    const uint32_t any = __ballot_sync(kFull, word != 0u);
    if ((threadIdx.x & 31) == 0) l1[g >> 5] = any;
  }
}

// First candidate position in [lo, limit] of one stream's bitmap, or -1.
// Called by a whole warp with uniform arguments; every lane gets the answer.
__device__ int64_t next_candidate(const uint32_t* __restrict__ L0,
                                  const uint32_t* __restrict__ L1, int64_t n_l0,
                                  int64_t lo, int64_t limit) {
  const int lane = threadIdx.x & 31;
  const int64_t w0 = lo >> 5;
  if (w0 >= n_l0) return -1;
  const uint32_t first = __ldg(L0 + w0) & (kFull << (lo & 31));
  if (first) {
    const int64_t c = (w0 << 5) + __ffs(first) - 1;
    return c <= limit ? c : -1;
  }
  const int64_t n_l1 = n_l0 >> 5;
  int64_t b = w0 + 1;  // next level-0 word to look at
  while (b < n_l0 && (b << 5) <= limit) {
    const int64_t g = b >> 5;  // first level-1 word of this step
    bool found = false;
    int which = 0;
    uint32_t val = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int64_t idx = g + lane * 4 + k;
      uint32_t v = idx < n_l1 ? __ldg(L1 + idx) : 0u;
      if (idx == g) v &= kFull << (b & 31);
      if (!found && v) {
        found = true;
        which = k;
        val = v;
      }
    }
    const unsigned nz = __ballot_sync(kFull, found);
    if (nz) {
      const int src = __ffs(nz) - 1;
      const int k = __shfl_sync(kFull, which, src);
      const uint32_t v = __shfl_sync(kFull, val, src);
      const int64_t wj = ((g + src * 4 + k) << 5) + __ffs(v) - 1;  // level-0 word
      const int64_t c = (wj << 5) + __ffs(__ldg(L0 + wj)) - 1;
      return c <= limit ? c : -1;
    }
    b = (g + 128) << 5;
  }
  return -1;
}

// Phase B: one warp per stream walks its bitmap with the carry in a register
// and sets cut_mask[pos_off[s] + cut] (cut_mask is zero on entry).
__global__ void cdc_phase_b(Wave wave, const uint32_t* __restrict__ l0,
                            const uint32_t* __restrict__ l1, int64_t min_size,
                            int64_t max_size, bool* __restrict__ cut_mask) {
  const int s = blockIdx.x;
  const int64_t n = wave.lens[s];
  const int64_t t0 = wave.tile_off[s];
  const int64_t n_l0 = (wave.tile_off[s + 1] - t0) * kThreads;
  const uint32_t* L0 = l0 + t0 * kThreads;
  const uint32_t* L1 = l1 + t0 * kTileL1;
  bool* out = cut_mask + wave.pos_off[s];
  int64_t sp = 0;
  for (;;) {
    const int64_t lo = sp + min_size;
    if (lo >= n) break;
    const int64_t hard = lo > sp + max_size - 1 ? lo : sp + max_size - 1;
    const int64_t c = next_candidate(L0, L1, n_l0, lo, hard);
    const int64_t cut = c >= 0 ? c : hard;
    if (cut >= n) break;
    if (threadIdx.x == 0) out[cut] = true;
    sp = cut + 1;
  }
}

Wave make_wave(const void* ptrs, const void* lens, const void* tile_off,
               const void* pos_off, int n_streams) {
  return Wave{static_cast<const uint64_t*>(ptrs), static_cast<const int64_t*>(lens),
              static_cast<const int64_t*>(tile_off), static_cast<const int64_t*>(pos_off),
              n_streams};
}

}  // namespace

// All pointers are device pointers. ptrs/lens/tile_off/pos_off describe the
// wave (see Wave); n_tiles = tile_off[n_streams]; gear is the (256,) uint32
// table. Each entry launches on `stream` and returns cudaGetLastError().

// hashes: (pos_off[n_streams],) uint32, the window hash of every position.
extern "C" int cdc_window_hashes_launch(const void* ptrs, const void* lens,
                                        const void* tile_off, const void* pos_off,
                                        int n_streams, int64_t n_tiles, const void* gear,
                                        void* hashes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cdc_phase_a<true><<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(
      make_wave(ptrs, lens, tile_off, pos_off, n_streams),
      static_cast<const uint32_t*>(gear), 0u, nullptr, nullptr,
      static_cast<uint32_t*>(hashes));
  return static_cast<int>(cudaGetLastError());
}

// l0: (n_tiles * 256,) uint32 scratch; l1: (n_tiles * 8,) uint32 scratch;
// cut_mask: (pos_off[n_streams],) bool, zero on entry.
extern "C" int cdc_cut_masks_launch(const void* ptrs, const void* lens, const void* tile_off,
                                    const void* pos_off, int n_streams, int64_t n_tiles,
                                    const void* gear, uint32_t mask, int64_t min_size,
                                    int64_t max_size, void* l0, void* l1, void* cut_mask,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Wave wave = make_wave(ptrs, lens, tile_off, pos_off, n_streams);
  cdc_phase_a<false><<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(
      wave, static_cast<const uint32_t*>(gear), mask, static_cast<uint32_t*>(l0),
      static_cast<uint32_t*>(l1), nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cdc_phase_b<<<static_cast<unsigned>(n_streams), 32, 0, s>>>(
      wave, static_cast<const uint32_t*>(l0), static_cast<const uint32_t*>(l1), min_size,
      max_size, static_cast<bool*>(cut_mask));
  return static_cast<int>(cudaGetLastError());
}
