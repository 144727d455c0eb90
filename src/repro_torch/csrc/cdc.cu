// Windowed gear-hash content-defined chunking for Hopper (sm_90a): window
// hashes, and the fused hash + min/max-size cut selection over a wave of
// byte streams, which writes each stream's cut positions.
//
// Replaces:
//   * src/repro/kernels/cdc.py::_cdc_cut_kernel (cdc_cut_masks_pallas) with
//     cdc_phase_a + cdc_phase_b below (cdc_cut_positions_launch);
//   * src/repro/kernels/cdc.py::_cdc_kernel (cdc_hashes_pallas,
//     cdc_boundaries_pallas) with cdc_hashes (cdc_window_hashes_launch).
//
// Semantics, per stream of n bytes b_0..b_{n-1} (T = the 256-entry gear table):
//   h_i   = sum_{k=0}^{31} T[b_{i-k}] << k  (mod 2^32; b_j for j < 0 adds 0)
//   cand_i = (h_i & mask) == 0
//   cuts: sp = 0; loop { lo = sp + min; stop if lo >= n;
//                        hard = max(lo, sp + max - 1);
//                        cut = first cand >= lo if it is <= hard, else hard;
//                        stop if cut >= n; emit cut; sp = cut + 1 }
// The TPU kernel wrote a bool mask with a bit per cut; the caller only needs
// the cut positions, so this kernel writes those: per stream, m_cut int32
// slots (the first n_cuts hold the cuts in order, the rest n) and one row
// (n_cuts, n_chunks, route).
//
// What bounds it on this card: bytes. The cuts read each stream byte once
// and write a few KB; their ~4 integer operations per byte (gear lookup,
// shift-add, mask, compare) are under the ~10 per byte at which an H100's
// integer issue rate meets its 3.35 TB/s. The cut selection itself is a
// serial walk per stream, bound by the latency of its steps.
//
// The window hashes read 1 byte and write 4 per position, so they are
// bound by bytes too: 5 B per position over 3.35 TB/s.
//
// What the design does about it:
//   * Both hashing kernels walk tiles of 8,192 positions (256 threads x 32)
//     over every stream of the wave at once, as many blocks as are resident,
//     each taking tiles blockIdx.x, blockIdx.x + gridDim.x, ... (a GPU grid
//     has no order, so nothing is carried between blocks). They share one
//     hashing routine, hash_word: it reads the bytes themselves, 16 bytes
//     per load, and keeps the gear table in shared memory, one copy per lane
//     so that a warp's 32 random lookups take one pass (a single copy queued
//     them ~3.5 deep on its banks); the block fills the 32 KB once. The
//     hash is linear: h_q = (h_{q-1} << 1) + T[b_q] equals the 32-term
//     window sum because a term leaves the 32-bit word after 32 shifts, and
//     h_{p0+j} = (h_{p0-1} << (j + 1)) + (the hash of b_p0..b_{p0+j} alone).
//     So each thread hashes its own 32 positions from 0 and takes h_{p0-1}
//     from the lane before it (a shuffle): one lookup per byte and no
//     warm-up over the bytes before.
//   * cdc_hashes stages each warp's 32 x 32 hashes in shared memory (4 KB)
//     and writes them out as 16-byte stores, so one warp store instruction
//     writes 512 contiguous bytes (a thread storing its own 32 words wrote 4
//     bytes into each of 32 lines per instruction). Lane l puts its chunk i
//     (4 hashes) at chunk i ^ (l & 7) of row l: each 8-lane phase of the
//     staging stores, and of the read-out of contiguous 128-byte rows,
//     touches 8 distinct 16-byte bank groups, so neither waits on a bank.
//     The stores are evict-first (__stcs): the hashes stream past the L2
//     (1.13 GB for the largest checkpoint leaf); on an H100 they took ~2 %
//     off the kernel's device time against plain stores (PERF.md,
//     tools/cut_quick.py).
//   * cdc_phase_a writes one 32-bit candidate word per thread
//     (level 0); a __ballot_sync of "word != 0" gives a level-1 word with
//     one bit per level-0 word. A warp with a candidate also appends the
//     positions to its stream's list (one atomicAdd per warp on the
//     stream's count, a prefix over the lanes' popcounts for the slots); the
//     count goes on past the list's kListCap slots, and no store lands past
//     them.
//   * cdc_phase_b gives each stream one block. Where the stream's candidates
//     fit the list (the checkpoint's case: ~1 per 512 KiB), the block sorts
//     the list in shared memory (bitonic; the append order is arbitrary) and
//     one thread walks it once, the chunk start in a register: a few
//     register operations per candidate or cut, no search. Otherwise (dense
//     candidates) warp 0 walks the bitmap: the level-0 word at lo, then 128
//     level-1 words (131,072 positions) per step, a handful of dependent
//     loads per cut. Both are exact; the block then fills the positions'
//     tail with n.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;           // hashing threads per block; x 32 positions each
constexpr int kTile = kThreads * 32;    // positions per tile
constexpr int kTileL1 = kThreads / 32;  // level-1 words per tile
constexpr int kTableBytes = 256 * 32 * 4;  // the gear table, one copy per lane
// cdc_hashes' dynamic shared memory: the tables, then 4 KB of staging per warp.
constexpr int kHashSmem = kTableBytes + kThreads * 32 * 4;
constexpr int kListCap = 8192;          // candidate slots per stream (32 KiB)
constexpr int kWalkThreads = 512;       // phase-B threads per block (one block per stream)
constexpr unsigned kFull = 0xffffffffu;
// Routes of phase B, the third int of a stream's counts row.
constexpr int kRouteList = 0;
constexpr int kRouteBitmap = 1;

struct Wave {
  const uint64_t* ptrs;     // (S,) stream base addresses, 16-byte aligned
  const int64_t* lens;      // (S,) byte lengths, all >= 1 (< 2^31 for cuts)
  const int64_t* tile_off;  // (S+1,) prefix sums of ceil(len / kTile)
  const int64_t* pos_off;   // (S+1,) prefix sums of len
  const int64_t* cut_off;   // (S+1,) prefix sums of m_cut = len / (min + 1) + 1
  int n_streams;
};

// Fills table (kTableBytes of shared memory) with one copy of the gear table
// per lane: entry v of lane l at byte offset v * 128 + l * 4, in bank l, so a
// warp's 32 lookups of random bytes never wait on each other. Ends with
// __syncthreads().
__device__ __forceinline__ void fill_lane_tables(uint32_t* table, const uint32_t* __restrict__ gear) {
  for (int i = threadIdx.x; i < 256 * 32; i += blockDim.x) table[i] = gear[i >> 5];
  __syncthreads();
}

// Gear value of byte k of w (k a constant) from this lane's table copy
// (lane_table = table + 4 * lane bytes): a byte permute and a shift-add give
// the address.
__device__ __forceinline__ uint32_t gear_of(const char* lane_table, uint32_t w, int k) {
  return *reinterpret_cast<const uint32_t*>(lane_table + (__byte_perm(w, 0u, 0x4440u | k) << 7));
}

// The hashing routine of both kernels. A thread owns positions off ..
// off + 31 of a tile whose first byte is `base` (off a multiple of 32,
// consecutive lanes on consecutive 32-position words); `left` is the count
// of stream bytes from base on, capped at kTile (bytes at or past it read
// as 0), and `at_head` says base is the stream's first byte. Fills tv with
// the 32 gear values and returns h_{off-1}, the window hash of the 32 bytes
// before the thread's first position: the previous lane's local hash, and
// for lane 0 one byte per lane of the 32 before the warp, summed by a
// shuffle reduction (0 before the stream head). Then
// h_{off+j} = (h_{off-1} << (j + 1)) + (tv[0] << j) + ... + tv[j].
// Called by a whole warp. Offsets are int: a tile holds 8,192 positions.
__device__ __forceinline__ uint32_t hash_word(const uint8_t* base, int off, int left, bool at_head,
                                              const char* lane_table, uint32_t (&tv)[32]) {
  const int lane = threadIdx.x & 31;
  // The thread's bytes as 8 little-endian words; 0 past left.
  uint32_t buf[8];
  if (off + 32 <= left) {
    const uint4* v = reinterpret_cast<const uint4*>(base + off);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint4 x = __ldg(v + i);
      buf[4 * i] = x.x;
      buf[4 * i + 1] = x.y;
      buf[4 * i + 2] = x.z;
      buf[4 * i + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      uint32_t w = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (off + 4 * i + b < left) w |= static_cast<uint32_t>(base[off + 4 * i + b]) << (8 * b);
      }
      buf[i] = w;
    }
  }
  uint32_t local = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    tv[j] = gear_of(lane_table, buf[j >> 2], j & 3);
    local = (local << 1) + tv[j];
  }
  const int q = off - 32 * lane - 32 + lane;  // byte `lane` of the 32 before the warp
  uint32_t head = (q >= 0 || !at_head) && q < left ? gear_of(lane_table, base[q], 0) << (31 - lane) : 0u;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) head += __shfl_xor_sync(kFull, head, d);
  const uint32_t before = __shfl_up_sync(kFull, local, 1);
  return lane == 0 ? head : before;
}

// The window-hash kernel: the u32 window hash of every position of every
// stream, to hashes[pos_off[s] + position]. A block takes tiles blockIdx.x,
// blockIdx.x + gridDim.x, ... below n_tiles; streams may be 2^31 bytes or
// longer (int64 once per tile, int inside it). Dynamic shared memory:
// kHashSmem bytes.
//
// Each warp writes its 1,024 hashes of a tile through its 4 KB of staging.
// Where they all lie inside the stream and their destination is 16-byte
// aligned (always so for the wave's first stream, since hashes comes from
// the allocator and pos_off[0] = 0), the warp stores 16 bytes a lane; a
// later stream of a multi-stream wave whose pos_off[s] is not a multiple of
// 4, and the partial last rows of a stream, take 4-byte stores masked by the
// stream's length, still 128 contiguous bytes per warp instruction.
__global__ void __launch_bounds__(kThreads, 3)  // 3 blocks of kHashSmem fill an SM's shared memory
cdc_hashes(Wave wave, int64_t n_tiles, const uint32_t* __restrict__ gear,
           uint32_t* __restrict__ hashes) {
  extern __shared__ uint4 smem[];
  uint32_t* table = reinterpret_cast<uint32_t*>(smem);
  fill_lane_tables(table, gear);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const char* lane_table = reinterpret_cast<const char*>(table) + 4 * lane;
  uint4* stage = smem + kTableBytes / 16 + warp * 256;  // 32 rows of 8 chunks
  const uint32_t* stage_words = reinterpret_cast<const uint32_t*>(stage);
  const int swz = lane & 7;
  const int off = threadIdx.x * 32;  // first position of this thread in the tile
  const int warp_off = warp * 1024;  // first position of this warp in the tile

  int s = -1;  // the stream of the current tile (tiles only grow below)
  int64_t t_begin = 0, t_end = 0, n = 0;
  const uint8_t* p = nullptr;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    while (tile >= t_end) {
      ++s;
      t_begin = wave.tile_off[s];
      t_end = wave.tile_off[s + 1];
      n = wave.lens[s];
      p = reinterpret_cast<const uint8_t*>(wave.ptrs[s]);
    }
    const int64_t start = (tile - t_begin) * kTile;  // the tile's first position
    const int64_t rest = n - start;
    const int left = rest < kTile ? static_cast<int>(rest) : kTile;
    uint32_t tv[32];
    uint32_t h = hash_word(p + start, off, left, start == 0, lane_table, tv);

    // Stage: chunk i (hashes 4i .. 4i+3) of lane l at chunk i ^ (l & 7) of row l.
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      uint4 c;
      c.x = h = (h << 1) + tv[4 * i];
      c.y = h = (h << 1) + tv[4 * i + 1];
      c.z = h = (h << 1) + tv[4 * i + 2];
      c.w = h = (h << 1) + tv[4 * i + 3];
      stage[lane * 8 + (i ^ swz)] = c;
    }
    __syncwarp();
    uint32_t* dst = hashes + wave.pos_off[s] + start + warp_off;
    const int valid = left - warp_off;  // this warp's positions inside the stream
    if (valid >= 1024 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      // Chunk c = 32 r + lane of the warp's 256: row c >> 3, chunk c & 7.
      uint4* out = reinterpret_cast<uint4*>(dst);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int row = 4 * r + (lane >> 3);
        __stcs(out + 32 * r + lane, stage[row * 8 + ((lane & 7) ^ (row & 7))]);
      }
    } else {
      // Position k = 32 r + lane of the warp's 1,024: row r, word lane.
#pragma unroll 4
      for (int r = 0; r < 32; ++r) {
        const int k = 32 * r + lane;
        if (k < valid) __stcs(dst + k, stage_words[r * 32 + (((lane >> 2) ^ (r & 7)) << 2) + (lane & 3)]);
      }
    }
    __syncwarp();  // the staging is read out before the next tile overwrites it
  }
}

// Phase A of the cuts: the candidate bitmap, level 0 (`l0`, one bit per
// position, tile_off[s] * kThreads words per stream start) and level 1
// (`l1`, one bit per level-0 word); each stream's candidate count in
// `count[s]` (zero on entry) and its first kListCap candidates, in no order,
// at list[s * kListCap + slot]. A block takes tiles blockIdx.x,
// blockIdx.x + gridDim.x, ... below n_tiles. Streams are < 2^31 bytes.
__global__ void __launch_bounds__(kThreads)
cdc_phase_a(Wave wave, int64_t n_tiles, const uint32_t* __restrict__ gear, uint32_t mask,
            uint32_t* __restrict__ l0, uint32_t* __restrict__ l1,
            unsigned* __restrict__ count, int* __restrict__ list) {
  __shared__ uint32_t table[256 * 32];
  fill_lane_tables(table, gear);
  const int lane = threadIdx.x & 31;
  const char* lane_table = reinterpret_cast<const char*>(table) + 4 * lane;
  const int off = threadIdx.x * 32;  // first position of this thread in the tile

  int s = -1;  // the stream of the current tile (tiles only grow below)
  int64_t t_begin = 0, t_end = 0;
  int n = 0;
  const uint8_t* p = nullptr;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    while (tile >= t_end) {
      ++s;
      t_begin = wave.tile_off[s];
      t_end = wave.tile_off[s + 1];
      n = static_cast<int>(wave.lens[s]);
      p = reinterpret_cast<const uint8_t*>(wave.ptrs[s]);
    }
    const int start = static_cast<int>(tile - t_begin) * kTile;  // the tile's first position
    const int rest = n - start;
    const int left = rest < kTile ? rest : kTile;
    const int p0 = start + off;  // first position this thread owns
    const int wi = p0 >> 5;      // its level-0 word in the stream
    uint32_t tv[32];
    const uint32_t h0 = hash_word(p + start, off, left, start == 0, lane_table, tv);
    // Candidates are rare: find whether the word has one (the least masked
    // hash is 0) first, and build the word only then.
    uint32_t h = h0, least = kFull;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      h = (h << 1) + tv[j];
      least = min(least, h & mask);
    }
    uint32_t word = 0;
    if (least == 0u) {
      h = h0;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        h = (h << 1) + tv[j];
        word |= static_cast<uint32_t>((h & mask) == 0u) << j;
      }
      const int inside = left - off;  // positions of this word inside the stream
      if (inside < 32) word &= inside > 0 ? (1u << inside) - 1u : 0u;
    }

    const int64_t g = t_begin * kThreads + wi;  // global level-0 word
    l0[g] = word;
    const uint32_t any = __ballot_sync(kFull, word != 0u);
    if (lane == 0) l1[g >> 5] = any;
    if (any) {  // warp-uniform: the whole warp takes the shuffles
      const unsigned mine = __popc(word);
      unsigned incl = mine;  // inclusive prefix over the lanes
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned up = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += up;
      }
      unsigned base = 0;
      if (lane == 31) base = atomicAdd(count + s, incl);
      unsigned slot = __shfl_sync(kFull, base, 31) + incl - mine;
      int* out = list + static_cast<int64_t>(s) * kListCap;
      for (uint32_t w = word; w != 0u && slot < kListCap; w &= w - 1u, ++slot) {
        out[slot] = p0 + __ffs(w) - 1;
      }
    }
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

// The next power of two >= x (x >= 1).
__device__ __forceinline__ int pow2_at_least(int x) {
  return x <= 1 ? 1 : 1 << (32 - __clz(x - 1));
}

// Phase B: one block per stream selects the cuts with the carry in a
// register. positions[cut_off[s] + k] = k-th cut, then n up to m_cut; row s
// of `rows` = (n_cuts, n_chunks, route).
__global__ void __launch_bounds__(kWalkThreads)
cdc_phase_b(Wave wave, const uint32_t* __restrict__ l0, const uint32_t* __restrict__ l1,
            const unsigned* __restrict__ count, const int* __restrict__ list,
            int64_t min_size, int64_t max_size, int* __restrict__ positions,
            int* __restrict__ rows) {
  __shared__ int cand[kListCap];
  __shared__ int walked[2];  // n_cuts, last cut (-1 without one)
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int64_t n = wave.lens[s];
  const int64_t m_cut = wave.cut_off[s + 1] - wave.cut_off[s];
  int* out = positions + wave.cut_off[s];
  const unsigned c = count[s];
  const bool listed = c <= static_cast<unsigned>(kListCap);  // block-uniform

  if (listed) {
    // Sort the stream's candidates ascending: bitonic over a power-of-two
    // span padded with INT_MAX, which is above every position.
    const int span = pow2_at_least(static_cast<int>(c));
    const int* in = list + static_cast<int64_t>(s) * kListCap;
    for (int i = tid; i < span; i += kWalkThreads) cand[i] = i < static_cast<int>(c) ? in[i] : 0x7fffffff;
    __syncthreads();
    for (int k = 2; k <= span; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = tid; i < span; i += kWalkThreads) {
          const int p = i ^ j;
          if (p > i) {
            const int a = cand[i], b = cand[p];
            if ((a > b) == ((i & k) == 0)) {
              cand[i] = b;
              cand[p] = a;
            }
          }
        }
        __syncthreads();
      }
    }
    if (tid == 0) {
      // One thread walks the sorted candidates once, with the chunk start in
      // a register. A chunk starting at sp ends at its first candidate in
      // [sp + min, sp + hard_len], else at sp + hard_len (the hard cut). So
      // candidates beyond the window only add hard cuts, one per
      // hard_len + 1 bytes, and a candidate closer than min to the chunk
      // start is passed over. Every candidate costs a few register
      // operations and no search.
      const int64_t hard_len = min_size > max_size - 1 ? min_size : max_size - 1;
      int nc = 0;
      int64_t sp = 0, last = -1;
      for (int j = 0; j < static_cast<int>(c); ++j) {
        const int64_t cand_j = cand[j];
        while (cand_j > sp + hard_len) {  // no candidate in this chunk's window
          last = sp + hard_len;
          out[nc++] = static_cast<int>(last);
          sp = last + 1;
        }
        if (cand_j - sp >= min_size) {
          last = cand_j;
          out[nc++] = static_cast<int>(last);
          sp = last + 1;
        }
      }
      while (sp + hard_len < n) {  // hard cuts after the last candidate
        last = sp + hard_len;
        out[nc++] = static_cast<int>(last);
        sp = last + 1;
      }
      walked[0] = nc;
      walked[1] = static_cast<int>(last);
    }
  } else if (tid < 32) {
    // Dense candidates: warp 0 walks the stream's two-level bitmap.
    const int64_t t0 = wave.tile_off[s];
    const int64_t n_l0 = (wave.tile_off[s + 1] - t0) * kThreads;
    const uint32_t* L0 = l0 + t0 * kThreads;
    const uint32_t* L1 = l1 + t0 * kTileL1;
    int nc = 0;
    int64_t sp = 0, last = -1;
    for (;;) {
      const int64_t lo = sp + min_size;
      if (lo >= n) break;
      const int64_t hard = lo > sp + max_size - 1 ? lo : sp + max_size - 1;
      const int64_t next = next_candidate(L0, L1, n_l0, lo, hard);
      const int64_t cut = next >= 0 ? next : hard;
      if (cut >= n) break;
      if (tid == 0) out[nc] = static_cast<int>(cut);
      ++nc;
      last = cut;
      sp = cut + 1;
    }
    if (tid == 0) {
      walked[0] = nc;
      walked[1] = static_cast<int>(last);
    }
  }
  __syncthreads();
  const int nc = walked[0];
  for (int64_t i = nc + tid; i < m_cut; i += kWalkThreads) out[i] = static_cast<int>(n);
  if (tid == 0) {
    rows[3 * s] = nc;
    rows[3 * s + 1] = nc + (walked[1] + 1 < n ? 1 : 0);  // a tail chunk after the last cut
    rows[3 * s + 2] = listed ? kRouteList : kRouteBitmap;
  }
}

// Blocks of kThreads that the card holds at once, with smem_bytes of dynamic
// shared memory each, or the error that asking gave.
struct Resident {
  int64_t blocks;
  cudaError_t err;
};

template <typename Kernel>
Resident resident_blocks(Kernel kernel, int smem_bytes) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem_bytes);
  return Resident{static_cast<int64_t>(sms) * per_sm, err};
}

Wave make_wave(const void* ptrs, const void* lens, const void* tile_off,
               const void* pos_off, const void* cut_off, int n_streams) {
  return Wave{static_cast<const uint64_t*>(ptrs), static_cast<const int64_t*>(lens),
              static_cast<const int64_t*>(tile_off), static_cast<const int64_t*>(pos_off),
              static_cast<const int64_t*>(cut_off), n_streams};
}

}  // namespace

// All pointers are device pointers. ptrs/lens/tile_off/pos_off describe the
// wave (see Wave); n_tiles = tile_off[n_streams]; gear is the (256,) uint32
// table. Each entry launches on `stream` and returns cudaGetLastError().

// hashes: (pos_off[n_streams],) uint32, the window hash of every position.
// Any stream length; a stream's hashes land at any word offset pos_off[s]
// (a 16-byte-aligned one takes the vector stores).
extern "C" int cdc_window_hashes_launch(const void* ptrs, const void* lens,
                                        const void* tile_off, const void* pos_off,
                                        int n_streams, int64_t n_tiles, const void* gear,
                                        void* hashes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // As many blocks as the card holds at once with kHashSmem each, each
  // walking tiles; the shared-memory limit is raised once.
  static const Resident resident = [] {
    cudaError_t err = cudaFuncSetAttribute(cdc_hashes, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kHashSmem);
    return err == cudaSuccess ? resident_blocks(cdc_hashes, kHashSmem) : Resident{0, err};
  }();
  if (resident.err != cudaSuccess) return static_cast<int>(resident.err);
  if (resident.blocks <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t grid = n_tiles < resident.blocks ? n_tiles : resident.blocks;
  cdc_hashes<<<static_cast<unsigned>(grid), kThreads, kHashSmem, s>>>(
      make_wave(ptrs, lens, tile_off, pos_off, nullptr, n_streams), n_tiles,
      static_cast<const uint32_t*>(gear), static_cast<uint32_t*>(hashes));
  return static_cast<int>(cudaGetLastError());
}

// cut_off: (n_streams + 1,) prefix sums of m_cut (see Wave). Scratch: l0
// (n_tiles * 256,) uint32, l1 (n_tiles * 8,) uint32, count (n_streams,)
// uint32 (zeroed here), list (n_streams * 8192,) int32. Out: positions
// (cut_off[n_streams],) int32; rows (n_streams, 3) int32 = n_cuts, n_chunks,
// route (0 the sorted candidate list, 1 the bitmap walk).
extern "C" int cdc_cut_positions_launch(const void* ptrs, const void* lens, const void* tile_off,
                                        const void* pos_off, const void* cut_off, int n_streams,
                                        int64_t n_tiles, const void* gear, uint32_t mask,
                                        int64_t min_size, int64_t max_size, void* l0, void* l1,
                                        void* count, void* list, void* positions, void* rows,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Wave wave = make_wave(ptrs, lens, tile_off, pos_off, cut_off, n_streams);
  // Phase A as many blocks as the card holds at once, each walking tiles.
  static const Resident resident = resident_blocks(cdc_phase_a, 0);
  if (resident.err != cudaSuccess) return static_cast<int>(resident.err);
  if (resident.blocks <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(unsigned) * n_streams, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t grid = n_tiles < resident.blocks ? n_tiles : resident.blocks;
  cdc_phase_a<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
      wave, n_tiles, static_cast<const uint32_t*>(gear), mask, static_cast<uint32_t*>(l0),
      static_cast<uint32_t*>(l1), static_cast<unsigned*>(count), static_cast<int*>(list));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cdc_phase_b<<<static_cast<unsigned>(n_streams), kWalkThreads, 0, s>>>(
      wave, static_cast<const uint32_t*>(l0), static_cast<const uint32_t*>(l1),
      static_cast<const unsigned*>(count), static_cast<const int*>(list), min_size, max_size,
      static_cast<int*>(positions), static_cast<int*>(rows));
  return static_cast<int>(cudaGetLastError());
}
