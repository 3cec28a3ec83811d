// Stable ascending sort of an int32 key with 32-bit payloads: a least
// significant digit radix sort over 8-bit digits that skips the digits all
// keys share (Onesweep's single histogram pass and decoupled look-back,
// Adinets & Merrill 2022).
//
// Replaces the TPU kernel `multi_adapter_particles_tpu/ops/sortkv.py`
// (`_make_kernel`, launched by `_vmem_pass`; public `sort_kv_stable`): a
// bitonic network over VMEM blocks with the original index as a second
// operand, which makes every comparator strict and the network's output
// the stable sort. Nothing of its block structure carries over.
//
// Bound: bytes. The function must read the key and every payload once and
// write them once: 8 + 8 * payloads bytes an entry (168 MB at E = 2^22 with
// the renderer's 4 payloads, 0.050 ms at 3.35 TB/s). A comparison network
// moves every entry O(log^2 E) times; here the traffic is one read of the
// key plus one read and one write of (key, payloads) a live digit:
// - Ordering key u = (u32)key ^ 2^31 (negative keys first), cut into four
//   8-bit digits. Each digit pass is stable, so ties keep their original
//   order and no index is carried or compared.
// - One histogram pass reads the key once and counts all four digits
//   (shared-memory counts, one add where the whole warp shares a digit,
//   merged with integer atomicAdd: the same result in any order). Its last
//   CTA turns the counts into each digit's exclusive bin offsets and a live
//   flag: a digit is dead when one bin holds all E entries, and its pass
//   then returns at once. The renderer's tile keys lie in [0, 8192] at
//   1024x1024, so only digits 0 and 1 run.
// - A caller may give `live`, a device count of leading entries, and
//   promise that the entries past it are already in order and hold keys
//   >= every key before it (the renderer's sentinel tail). The histogram
//   and the passes then stop at it (a digit is dead when one bin holds all
//   `live` entries; a pass's CTA given a tile past it returns at once), so
//   the tail is neither read nor moved, and the sort is in place: the
//   result is the caller's arrays. `live` is read on the device, clamped to
//   [0, E], so a graph captures the call with its grids fixed by E.
// - Four digit passes, always launched, so a call is a fixed sequence (a
//   memset and five kernels) that a CUDA graph captures. A live pass takes
//   tiles of 6,144 entries in order from an atomic counter and ranks each
//   tile stably: warp w of 16 holds entries [384w, 384w + 384) in 12 rounds
//   of 32, a round is matched by one ballot a digit bit (CUB's MatchAny)
//   and per-warp bin counters carry the rounds. It stages the tile in
//   shared memory in bin order, so that each bin's run is written
//   contiguously, and gets each bin's global base by decoupled look-back
//   over (tile, bin) status words, 16 relaxed reads at a time; the staging
//   and the first payload's loads go before the look-back, which waits on
//   slower earlier tiles.
// - The payloads ride each live pass through a second shared-memory stage,
//   one at a time, read and written in coalesced runs: no random gather.
//   A hop is a live pass, or a dead digit's launch that copies the sorted
//   prefix across. The first hop reads the caller's arrays; the hops then
//   alternate between a scratch set and the outputs (in place: the
//   caller's arrays) so that the last hop writes the outputs. Out of place
//   with no live digit (all keys equal, or E = 1) one copy moves the input
//   to the outputs; in place an odd number of live digits takes one copy,
//   in the first dead digit's launch, so that the hops end where they
//   began, and with none there is nothing to do.
// - What is left between it and the bound (measured, PERF.md): a tile's
//   load, rank and look-back are latency the CTAs of a wave spend together
//   while memory idles, and a bin's run in a tile is ~24 entries, so
//   writes land in short runs.
//
// A look-back status word is a 30-bit count under 2 flag bits, so E is at
// most 2^30 - 1. Deterministic: integer atomics only (the histogram counts,
// the tile counters), no float atomics, bitwise the same run to run.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kRadixBits = 8;
constexpr int kRadix = 1 << kRadixBits;    // bins a digit
constexpr int kDigits = 4;
constexpr int kThreads = 512;              // a digit pass's CTA
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 12;                 // entries a thread a tile
constexpr int kTile = kThreads * kItems;   // 6,144 entries a tile
constexpr int kWarpSpan = 32 * kItems;     // entries a warp a tile
constexpr int kMaxPayloads = 8;
constexpr long long kMaxLength = (1LL << 30) - 1;
constexpr int kHistThreads = kRadix;       // the histogram's CTA
constexpr int kHistBlocks = 1056;          // 8 a streaming multiprocessor
constexpr int kHistItems = 16;             // keys a thread a round
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kFlagAggregate = 1u << 30;  // the tile's own count
constexpr uint32_t kFlagPrefix = 2u << 30;     // count of all tiles <= it
constexpr uint32_t kValueMask = (1u << 30) - 1;
constexpr int kWindow = 16;                // status words a look-back read
// dynamic shared memory of a digit pass: the tile's keys and one payload
// in bin order, and each warp's bin counts
constexpr int kPassSmem = (2 * kTile + kWarps * kRadix) * sizeof(uint32_t);

static_assert(kThreads >= kRadix, "a thread for every bin");

// The control block at the head of the wrapper's int32 scratch, zeroed by
// the memset that starts a call; the look-back status words follow it,
// [kDigits][tiles][kRadix].
struct Control {
  uint32_t count[kDigits][kRadix];   // histogram of each digit
  uint32_t offset[kDigits][kRadix];  // exclusive bin offsets
  int live[kDigits];
  int hop[kDigits];                  // hops before this digit's launch
  int n_hops;                        // live passes, and the copy if any
  int copy_at;                       // the dead digit that copies, or -1
  int length;                        // the entries sorted: live, or E
  uint32_t hist_done;                // histogram CTAs finished
  uint32_t next_tile[kDigits];       // a pass's tile counter
};
constexpr long long kControlWords = sizeof(Control) / sizeof(uint32_t);

struct Set {
  int* key;
  uint32_t* pay[kMaxPayloads];
};

struct Buffers {
  Set in;        // the caller's key and payloads (read only out of place)
  Set scratch;
  Set out;       // in place: the same arrays as `in`
};

__device__ __forceinline__ uint32_t digit_of(int key, int shift) {
  return (((uint32_t)key ^ 0x80000000u) >> shift) & (kRadix - 1);
}

// Status words carry their whole meaning in the word, so the look-back
// needs no ordering beyond the word itself: relaxed accesses, which let a
// window of reads be in flight at once.
__device__ __forceinline__ void store_relaxed(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ uint32_t load_relaxed(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ uint32_t lanemask_lt() {
  uint32_t m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// The lanes of the warp whose `dig` (< 2 * kRadix) equals this lane's; all
// 32 lanes call it. One ballot a digit bit, as CUB's MatchAny.
__device__ __forceinline__ uint32_t match_digit(uint32_t dig) {
  uint32_t peers = kFull;
#pragma unroll
  for (int bit = 0; bit <= kRadixBits; ++bit) {   // bit kRadixBits: past end
    const bool set = (dig >> bit) & 1;
    const uint32_t ones = __ballot_sync(kFull, set);
    peers &= set ? ones : ~ones;
  }
  return peers;
}

// Exclusive prefix sum of one value a thread over the block;
// `warp_total` is shared scratch of a word a warp. Ends with the block in
// step.
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v,
                                                         uint32_t* warp_total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_total[w] = x;
  __syncthreads();
  uint32_t before = 0;
  for (int i = 0; i < w; ++i) before += warp_total[i];
  __syncthreads();
  return before + x - v;
}

// Counts of all four digits of the first `length` keys (`*live` clamped
// to [0, e], or e when live is null); the last CTA to finish turns them
// into the bin offsets, the live flags and each launch's hop.
__global__ void __launch_bounds__(kHistThreads)
    histogram_kernel(const int* __restrict__ key, long long e,
                     const int* __restrict__ live,
                     Control* __restrict__ ctl) {
  constexpr int kHistWarps = kHistThreads / 32;
  __shared__ uint32_t hist[kDigits][kRadix];
  __shared__ uint32_t warp_total[kHistWarps];
  __shared__ int last;
  for (int i = threadIdx.x; i < kDigits * kRadix; i += kHistThreads)
    (&hist[0][0])[i] = 0;
  __syncthreads();
  const long long length = live ? min(max((long long)*live, 0LL), e) : e;
  const int lane = threadIdx.x & 31;
  const long long warp =
      (long long)blockIdx.x * kHistWarps + (threadIdx.x >> 5);
  const long long step = (long long)gridDim.x * kHistWarps * 32 * kHistItems;
  // warp-uniform loop: every lane reaches the warp vote below
  for (long long base = warp * 32 * kHistItems; base < length;
       base += step) {
    int k[kHistItems];
#pragma unroll
    for (int r = 0; r < kHistItems; ++r) {
      const long long i = base + r * 32 + lane;
      k[r] = i < length ? key[i] : 0;
    }
#pragma unroll
    for (int r = 0; r < kHistItems; ++r) {
      const bool valid = base + r * 32 + lane < length;
#pragma unroll
      for (int d = 0; d < kDigits; ++d) {
        // kRadix marks an entry past the end: it matches no real bin
        const uint32_t dig =
            valid ? digit_of(k[r], kRadixBits * d) : (uint32_t)kRadix;
        // a digit the whole warp shares (the dead digits' case) is one
        // add; otherwise one add a lane
        if (__all_sync(kFull, dig == __shfl_sync(kFull, dig, 0))) {
          if (lane == 0 && valid) atomicAdd(&hist[d][dig], 32u);
        } else if (valid) {
          atomicAdd(&hist[d][dig], 1u);
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kDigits * kRadix; i += kHistThreads) {
    const uint32_t v = (&hist[0][0])[i];
    if (v) atomicAdd(&ctl->count[0][0] + i, v);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&ctl->hist_done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int b = threadIdx.x;
  int live_mask = 0;
  for (int d = 0; d < kDigits; ++d) {
    const uint32_t c = __ldcg(&ctl->count[d][b]);
    const int dead = __syncthreads_or(c == (uint32_t)length);
    ctl->offset[d][b] = block_exclusive_scan(c, warp_total);
    live_mask |= !dead << d;
  }
  if (b == 0) {
    const int n_live = __popc(live_mask);
    // out of place with no live digit the copy moves the input to the
    // outputs; in place with an odd count it makes the hops even
    const bool copy = live ? (n_live & 1) : n_live == 0;
    const int copy_at = copy ? __ffs(~live_mask) - 1 : -1;  // first dead
    int hops = 0;
    for (int d = 0; d < kDigits; ++d) {
      const int pass = (live_mask >> d) & 1;
      ctl->live[d] = pass;
      ctl->hop[d] = hops;
      hops += pass || d == copy_at;
    }
    ctl->n_hops = hops;
    ctl->copy_at = copy_at;
    ctl->length = (int)length;
  }
}

// The count of bin b in all tiles before `tile` (thread b): decoupled
// look-back over the status words, kWindow tiles a read, back to the first
// tile that has published its inclusive prefix.
__device__ __forceinline__ uint32_t look_back(const uint32_t* mine, int tile) {
  uint32_t before = 0;
  for (int t = tile - 1;; t -= kWindow) {
    uint32_t s[kWindow];
#pragma unroll
    for (int i = 0; i < kWindow; ++i)
      s[i] = t - i >= 0 ? load_relaxed(mine - (tile - t + i) * kRadix)
                        : kFlagPrefix;   // before tile 0: nothing
#pragma unroll
    for (int i = 0; i < kWindow; ++i) {
      while ((s[i] & ~kValueMask) == 0)
        s[i] = load_relaxed(mine - (tile - t + i) * kRadix);
      before += s[i] & kValueMask;
      if (s[i] & kFlagPrefix) return before;
    }
  }
}

// One digit's stable scatter of the first `length` (key, payloads); a
// dead digit's launch copies them when it is the copy, else does nothing.
__global__ void __launch_bounds__(kThreads)
    digit_pass_kernel(Buffers buf, int n_pay, int digit, Control* ctl,
                      uint32_t* status, int tiles) {
  extern __shared__ uint32_t smem[];
  uint32_t* skey = smem;                   // the tile's keys in bin order
  uint32_t* sval = smem + kTile;           // a payload in bin order
  uint32_t(*whist)[kRadix] =               // a warp's bin counts
      reinterpret_cast<uint32_t(*)[kRadix]>(smem + 2 * kTile);
  __shared__ uint32_t tile_start[kRadix];  // a bin's first stage slot
  __shared__ int delta[kRadix];            // stage slot -> output index
  __shared__ uint32_t warp_total[kWarps];
  __shared__ int tile_sh;

  const bool pass = ctl->live[digit];
  if (!pass && digit != ctl->copy_at) return;
  // Hop `hop` of n_hops reads the input (the first) or what the hop before
  // it wrote; hops alternate scratch and out, ending at out.
  const int hop = ctl->hop[digit], n_hops = ctl->n_hops;
  const long long length = ctl->length;
  const Set& src = hop == 0 ? buf.in
                   : ((n_hops - hop) & 1) == 0 ? buf.out
                                               : buf.scratch;
  const Set& dst = ((n_hops - 1 - hop) & 1) == 0 ? buf.out : buf.scratch;
  if (!pass) {   // the copy: this CTA's tile of the first `length` entries
    const long long base = (long long)blockIdx.x * kTile;
    for (int s = threadIdx.x; s < kTile; s += kThreads) {
      const long long i = base + s;
      if (i >= length) break;
      dst.key[i] = src.key[i];
      for (int q = 0; q < n_pay; ++q) dst.pay[q][i] = src.pay[q][i];
    }
    return;
  }

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (threadIdx.x == 0) tile_sh = (int)atomicAdd(&ctl->next_tile[digit], 1u);
  for (int i = threadIdx.x; i < kWarps * kRadix; i += kThreads)
    (&whist[0][0])[i] = 0;
  __syncthreads();
  const int tile = tile_sh;
  const long long tile_base = (long long)tile * kTile;
  if (tile_base >= length) return;   // past the entries sorted
  const int n_valid = (int)min((long long)kTile, length - tile_base);
  const int shift = kRadixBits * digit;
  const int first = w * kWarpSpan + lane;   // entry of round 0

  int keys[kItems];
  uint32_t slot[kItems];   // rank within the warp's bin, then stage slot
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int j = first + r * 32;
    keys[r] = j < n_valid ? src.key[tile_base + j] : 0;
  }
  const int b = threadIdx.x;   // b < kRadix: the thread that owns bin b
  uint32_t* mine = status + ((long long)digit * tiles + tile) * kRadix + b;
  const uint32_t lt = lanemask_lt();
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const bool valid = first + r * 32 < n_valid;
    const uint32_t dig = valid ? digit_of(keys[r], shift) : (uint32_t)kRadix;
    const uint32_t peers = match_digit(dig);
    const uint32_t seen = valid ? whist[w][dig] : 0;
    __syncwarp();
    if (valid && lane == 31 - __clz(peers))
      whist[w][dig] = seen + __popc(peers);
    __syncwarp();
    slot[r] = seen + __popc(peers & lt);
  }
  __syncthreads();

  // Bin owners: the warps' exclusive offsets and the tile's count.
  uint32_t count = 0;
  if (b < kRadix) {
    for (int v = 0; v < kWarps; ++v) {
      const uint32_t c = whist[v][b];
      whist[v][b] = count;
      count += c;
    }
    store_relaxed(mine, (tile == 0 ? kFlagPrefix : kFlagAggregate) | count);
  }
  const uint32_t start = block_exclusive_scan(count, warp_total);
  if (b < kRadix) tile_start[b] = start;
  __syncthreads();
  // The tile in bin order in shared memory, and the first payload's loads
  // in flight, before the look-back waits on earlier tiles.
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    if (first + r * 32 < n_valid) {
      const uint32_t dig = digit_of(keys[r], shift);
      slot[r] += tile_start[dig] + whist[w][dig];
      skey[slot[r]] = (uint32_t)keys[r];
    }
  }
  uint32_t v[kItems];
  if (n_pay > 0) {
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const int j = first + r * 32;
      v[r] = j < n_valid ? src.pay[0][tile_base + j] : 0u;
    }
  }
  if (b < kRadix) {
    uint32_t before = 0;
    if (tile > 0) {
      before = look_back(mine, tile);
      store_relaxed(mine, kFlagPrefix | (before + count));
    }
    delta[b] = (int)(ctl->offset[digit][b] + before) - (int)start;
  }
  __syncthreads();
  // Stage slot s goes to delta[its bin] + s: each bin's run is contiguous.
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int s = threadIdx.x + k * kThreads;
    if (s < n_valid) {
      const int key = (int)skey[s];
      dst.key[delta[digit_of(key, shift)] + s] = key;
    }
  }
  for (int q = 0; q < n_pay; ++q) {
    if (q > 0) {
      const uint32_t* __restrict__ in = src.pay[q];
#pragma unroll
      for (int r = 0; r < kItems; ++r) {
        const int j = first + r * 32;
        v[r] = j < n_valid ? in[tile_base + j] : 0u;
      }
      __syncthreads();   // the stage's last readers are done
    }
#pragma unroll
    for (int r = 0; r < kItems; ++r)
      if (first + r * 32 < n_valid) sval[slot[r]] = v[r];
    __syncthreads();
    uint32_t* __restrict__ out = dst.pay[q];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int s = threadIdx.x + k * kThreads;
      if (s < n_valid)
        out[delta[digit_of((int)skey[s], shift)] + s] = sval[s];
    }
  }
}

long long tiles_for(long long e) { return (e + kTile - 1) / kTile; }

Set make_set(void* key, void* const* pay, int n_pay) {
  Set s = {};
  s.key = static_cast<int*>(key);
  for (int q = 0; q < n_pay; ++q) s.pay[q] = static_cast<uint32_t*>(pay[q]);
  return s;
}

}  // namespace

// 32-bit words of the control scratch `sortkv_stable` takes for E entries.
extern "C" long long sortkv_control_words(long long e) {
  return kControlWords + (long long)kDigits * tiles_for(e) * kRadix;
}

// key [e] int32; key_out [e]; pay_in / pay_out: n_pay (<= 8) pointers to
// [e] 32-bit payloads; scratch: (1 + n_pay) * e words; control:
// sortkv_control_words(e) words (no initial value); live: null, or a
// device int32 count of leading entries to sort, in place (key and pay_in
// are then the outputs, and key_out and pay_out are not used). Returns
// cudaGetLastError() (cudaErrorInvalidValue for arguments out of range).
extern "C" int sortkv_stable(void* key, long long e, void* key_out,
                             void* const* pay_in, void* const* pay_out,
                             int n_pay, void* scratch, void* control,
                             const void* live, void* stream) {
  if (e <= 0) return 0;
  if (e > kMaxLength || n_pay < 0 || n_pay > kMaxPayloads)
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      digit_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kPassSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tiles = tiles_for(e);
  const cudaError_t rc = cudaMemsetAsync(
      control, 0, (size_t)sortkv_control_words(e) * sizeof(uint32_t), st);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  Control* ctl = static_cast<Control*>(control);
  uint32_t* status = static_cast<uint32_t*>(control) + kControlWords;
  const long long hist_tiles =
      (e + kHistThreads * kHistItems - 1) / (kHistThreads * kHistItems);
  histogram_kernel<<<(unsigned)(hist_tiles < kHistBlocks ? hist_tiles
                                                         : kHistBlocks),
                     kHistThreads, 0, st>>>(static_cast<const int*>(key), e,
                                            static_cast<const int*>(live),
                                            ctl);
  Buffers buf;
  buf.in = make_set(key, pay_in, n_pay);
  uint32_t* s = static_cast<uint32_t*>(scratch);
  buf.scratch = {};
  buf.scratch.key = reinterpret_cast<int*>(s);
  for (int q = 0; q < n_pay; ++q) buf.scratch.pay[q] = s + (q + 1) * e;
  buf.out = live ? buf.in : make_set(key_out, pay_out, n_pay);
  for (int d = 0; d < kDigits; ++d)
    digit_pass_kernel<<<(unsigned)tiles, kThreads, kPassSmem, st>>>(
        buf, n_pay, d, ctl, status, (int)tiles);
  return static_cast<int>(cudaGetLastError());
}
