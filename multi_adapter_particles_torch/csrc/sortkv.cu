// Stable ascending sort of an int32 key with 32-bit payloads: a bitonic
// network over packed (key, index) words.
//
// Replaces the TPU kernel `multi_adapter_particles_tpu/ops/sortkv.py`
// (`_make_kernel`, launched by `_vmem_pass`; public `sort_kv_stable`). That
// design sorts each VMEM block fully on chip, then merges blocks with one
// XLA pass per exchange distance >= the block and one VMEM pass for the
// distances below it; the original index rides along as an operand so that
// every comparator is strict and the network's output is the stable sort,
// and all payloads ride every pass (random access is slow on the TPU).
//
// On the H100:
// - Strict order in one compare. Entry i becomes the 64-bit word
//   ((u32)key ^ 0x80000000) << 32 | i: the sign flip orders negative keys
//   first, and an unsigned compare of two words is the lexicographic
//   (key, index) order. All words differ, so the bitonic network (not
//   stable itself) yields exactly the stable sort.
// - Length. E pads to the next power of two with key = INT32_MAX; a pad
//   word's index is >= E, so it sorts after every real entry, a real
//   INT32_MAX key included, and the unpack pass writes only the first E.
// - Phase A: one block of 1,024 threads sorts each tile of 2^13 words
//   (64 KB of shared memory) through the whole k = 2..tile cascade. The
//   direction of every merge comes from the entry's GLOBAL index, bit k
//   clear = ascending (Batcher's rule; odd tiles end phase A descending).
// - Phase B, for each merge length k = 2 * tile .. E: the distances >= tile
//   are global compare-exchange passes, two distances a pass (four words a
//   thread in registers) while two remain, then one shared-memory pass per
//   tile finishes the distances below the tile.
// - Payloads do not ride the network: the last pass unpacks the key and
//   gathers each payload by the index half of the word. One random 4-byte
//   read per payload costs less here than carrying 16 more bytes a word
//   through every pass.
//
// Bound: bytes. The function must read the key and every payload once and
// write them once: 8 + 8 * payloads bytes an entry (168 MB at E = 2^22 with
// the renderer's 4 payloads: 0.050 ms at 3.35 TB/s). The network moves each
// 8-byte word through ~25 global passes (E = 2^22) and 10 tile passes, so
// it is far from that bound; a radix sort over the key bits would be
// nearer. All distances below the tile run in shared memory; the
// warp-shuffle form for distances below 32 is not used.
//
// Deterministic: a fixed network, no atomics.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kTileLog2 = 13;          // words per shared-memory tile
constexpr int kThreads = 1024;         // threads of a tile block
constexpr int kPassThreads = 256;      // threads of a global pass block
constexpr int kMaxPayloads = 8;
constexpr long long kMaxBlocks = 1LL << 24;

struct Payloads {
  const uint32_t* in[kMaxPayloads];
  uint32_t* out[kMaxPayloads];
};

__device__ __forceinline__ void exchange(u64& a, u64& b, bool asc) {
  if ((a > b) == asc) {
    const u64 t = a;
    a = b;
    b = t;
  }
}

// The position of pair p at distance j: p's bit log2(j) moved up one, a 0
// put in its place.
__device__ __forceinline__ long long pair_lo(long long p, long long j) {
  return ((p & ~(j - 1)) << 1) | (p & (j - 1));
}

__global__ void pack_kernel(const int* __restrict__ key, u64* __restrict__ w,
                            long long e, long long ep) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < ep; i += stride) {
    const uint32_t k = i < e ? ((uint32_t)key[i] ^ 0x80000000u) : 0xFFFFFFFFu;
    w[i] = ((u64)k << 32) | (u64)(uint32_t)i;
  }
}

// One compare-exchange distance j over a shared tile whose first word has
// global index `base`; merge length k (a power of two > j).
__device__ __forceinline__ void tile_stage(u64* s, int tile, long long base,
                                           long long k, int j) {
  for (int p = threadIdx.x; p < (tile >> 1); p += kThreads) {
    const int i = (int)pair_lo(p, j);
    const bool asc = ((base + i) & k) == 0;
    u64 a = s[i], b = s[i + j];
    exchange(a, b, asc);
    s[i] = a;
    s[i + j] = b;
  }
}

// kFull: sort the tile through k = 2..tile (phase A). Otherwise finish
// merge k (>= 2 * tile): the distances tile/2 .. 1.
template <bool kFull>
__global__ void __launch_bounds__(kThreads)
    tile_kernel(u64* __restrict__ w, int tile_log2, long long k_finish) {
  extern __shared__ u64 s[];
  const int tile = 1 << tile_log2;
  const long long base = (long long)blockIdx.x << tile_log2;
  for (int t = threadIdx.x; t < tile; t += kThreads) s[t] = w[base + t];
  __syncthreads();
  if (kFull) {
    for (int k = 2; k <= tile; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        tile_stage(s, tile, base, k, j);
        __syncthreads();
      }
    }
  } else {
    for (int j = tile >> 1; j > 0; j >>= 1) {
      tile_stage(s, tile, base, k_finish, j);
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < tile; t += kThreads) w[base + t] = s[t];
}

// One global distance j of merge k: ep / 2 pairs.
__global__ void __launch_bounds__(kPassThreads)
    pass1_kernel(u64* __restrict__ w, long long pairs, long long k,
                 long long j) {
  const long long stride = (long long)gridDim.x * kPassThreads;
  for (long long p = (long long)blockIdx.x * kPassThreads + threadIdx.x;
       p < pairs; p += stride) {
    const long long i = pair_lo(p, j);
    u64 a = w[i], b = w[i + j];
    if ((a > b) == ((i & k) == 0)) {
      w[i] = b;
      w[i + j] = a;
    }
  }
}

// Distances j and j/2 of merge k in one pass: each thread holds the four
// words i, i + j/2, i + j, i + 3j/2 (bits j and j/2 of i clear).
__global__ void __launch_bounds__(kPassThreads)
    pass2_kernel(u64* __restrict__ w, long long quads, long long k,
                 long long j) {
  const long long h = j >> 1;
  const long long stride = (long long)gridDim.x * kPassThreads;
  for (long long q = (long long)blockIdx.x * kPassThreads + threadIdx.x;
       q < quads; q += stride) {
    const long long i = pair_lo(pair_lo(q, h), j);
    const bool asc = (i & k) == 0;
    u64 a = w[i], b = w[i + h], c = w[i + j], d = w[i + j + h];
    exchange(a, c, asc);
    exchange(b, d, asc);
    exchange(a, b, asc);
    exchange(c, d, asc);
    w[i] = a;
    w[i + h] = b;
    w[i + j] = c;
    w[i + j + h] = d;
  }
}

__global__ void unpack_kernel(const u64* __restrict__ w, int* __restrict__ key,
                              Payloads pay, int n_pay, long long e) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < e;
       i += stride) {
    const u64 x = w[i];
    key[i] = (int)((uint32_t)(x >> 32) ^ 0x80000000u);
    const uint32_t src = (uint32_t)x;
    for (int c = 0; c < n_pay; ++c) pay.out[c][i] = __ldg(pay.in[c] + src);
  }
}

unsigned grid_for(long long n, int threads) {
  long long blocks = (n + threads - 1) / threads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

int log2_exact(long long x) {
  int l = 0;
  while ((1LL << l) < x) ++l;
  return l;
}

}  // namespace

// The tile the kernel sorts in shared memory (log2 of its words).
extern "C" int sortkv_tile_log2() { return kTileLog2; }

// key [e] int32; words: scratch of ep 64-bit words (ep = the power of two
// >= e, ep <= 2^31); key_out [e]; pay_in / pay_out: n_pay (<= 8) pointers
// to [e] 32-bit payloads. Returns cudaGetLastError() (cudaErrorInvalidValue
// for arguments out of range).
extern "C" int sortkv_stable(const void* key, long long e, long long ep,
                             void* words, void* key_out,
                             void* const* pay_in, void* const* pay_out,
                             int n_pay, void* stream) {
  if (e <= 0) return 0;
  if (ep < e || (ep & (ep - 1)) || ep > (1LL << 31) || n_pay < 0 ||
      n_pay > kMaxPayloads)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attrs_set = false;
  if (!attrs_set) {
    const int bytes = (int)(sizeof(u64) << kTileLog2);
    cudaFuncSetAttribute(tile_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    cudaFuncSetAttribute(tile_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    attrs_set = true;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  u64* w = static_cast<u64*>(words);
  pack_kernel<<<grid_for(ep, 256), 256, 0, st>>>(static_cast<const int*>(key),
                                                 w, e, ep);
  const int ep_log2 = log2_exact(ep);
  const int tile_log2 = ep_log2 < kTileLog2 ? ep_log2 : kTileLog2;
  const long long tile = 1LL << tile_log2;
  const size_t smem = sizeof(u64) << tile_log2;
  const unsigned tiles = (unsigned)(ep >> tile_log2);
  if (ep >= 2) {
    tile_kernel<true><<<tiles, kThreads, smem, st>>>(w, tile_log2, 0);
    for (long long k = 2 * tile; k <= ep; k <<= 1) {
      long long j = k >> 1;
      for (; j >= 2 * tile; j >>= 2)
        pass2_kernel<<<grid_for(ep >> 2, kPassThreads), kPassThreads, 0, st>>>(
            w, ep >> 2, k, j);
      if (j == tile)
        pass1_kernel<<<grid_for(ep >> 1, kPassThreads), kPassThreads, 0, st>>>(
            w, ep >> 1, k, j);
      tile_kernel<false><<<tiles, kThreads, smem, st>>>(w, tile_log2, k);
    }
  }
  Payloads pay = {};
  for (int c = 0; c < n_pay; ++c) {
    pay.in[c] = static_cast<const uint32_t*>(pay_in[c]);
    pay.out[c] = static_cast<uint32_t*>(pay_out[c]);
  }
  unpack_kernel<<<grid_for(e, 256), 256, 0, st>>>(w, static_cast<int*>(key_out),
                                                  pay, n_pay, e);
  return static_cast<int>(cudaGetLastError());
}
