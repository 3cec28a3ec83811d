// Row gather: out[n, :] = table[clamp(idx[n], 0, R - 1), :].
//
// Replaces the TPU kernel `experiments/rowgather_pallas.py` `pallas_gather`
// (kernel `_gather_kernel`), which scalar-prefetches a tile of indices and
// keeps a DEPTH-deep ring of single-row DMAs from HBM into VMEM in flight.
// The render path does not launch it: `composite_tiles` reads each virtual
// row's slots from the sorted streams itself. The eager composite's packed
// payload gather (the sorted (cx, cy, w, cgb) stream cut into Q-aligned
// data rows of 4Q words, gathered once per virtual row) is its twin's
// shape (`ops/composite.composite_rows_inputs`).
//
// Bound on the H100: bytes. Each output word is read once from the table
// and written once, so the least time is 2 * N * W * 4 bytes over 3.35
// TB/s: 0.060 ms at the eager render's per-chunk shape (24,576 rows of
// 1,024 words). The design keeps those bytes moving with few instructions
// each: a warp (wide rows) or a group of lanes (narrow rows) owns an output
// row, reads its index once and computes its two row addresses once (no
// divide anywhere: group and lane come from shifts), and every thread
// issues up to kUnroll independent 16-byte loads before it stores any, so
// a thread keeps kUnroll loads in flight where a thread per vector kept
// one. Rows of 32 vectors or more (the render's 256) take a warp each, its
// lanes striding the row; narrower rows (the TPU prototype's 8 vectors)
// take a power-of-two group of lanes each, kUnroll rows a thread. Stores
// are streaming (`__stcs`): the output is not read back here, so it should
// not push the table's rows out of L2 (neighbouring virtual rows read the
// same data row). A scalar path (4-byte words) takes tables whose width
// is not a multiple of 4 words or whose rows are not 16-byte aligned.
//
// Out-of-range indices clamp to [0, R - 1], as XLA's gather does and the
// JAX renderer relies on for dead virtual rows. Pure copy: bitwise equal to
// `table[idx.clamp(0, R - 1)]` for any 32-bit payload.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;
constexpr long long kMaxBlocks = 1LL << 20;

__device__ __forceinline__ long long clamp_row(const int* idx, long long r,
                                               long long rows) {
  const long long src = __ldg(idx + r);
  return src < 0 ? 0 : (src >= rows ? rows - 1 : src);
}

// Rows of row_len >= 32 vectors: a warp a row, each lane kUnroll loads in
// flight along it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gather_wide_kernel(const T* __restrict__ table,
                       const int* __restrict__ idx, T* __restrict__ out,
                       long long n, long long rows, int row_len) {
  const int lane = threadIdx.x & 31;
  const long long warps = ((long long)gridDim.x * kThreads) >> 5;
  for (long long r = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
       r < n; r += warps) {
    const T* __restrict__ src = table + clamp_row(idx, r, rows) * row_len;
    T* __restrict__ dst = out + r * row_len;
    int c = lane;
    for (; c + (kUnroll - 1) * 32 < row_len; c += kUnroll * 32) {
      T v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(src + c + 32 * u);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) __stcs(dst + c + 32 * u, v[u]);
    }
    for (; c < row_len; c += 32) __stcs(dst + c, __ldg(src + c));
  }
}

// Rows of row_len < 32 vectors: 2^shift lanes a row (the least power of
// two >= row_len), kUnroll rows a thread per step, all loads first.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gather_narrow_kernel(const T* __restrict__ table,
                         const int* __restrict__ idx, T* __restrict__ out,
                         long long n, long long rows, int row_len,
                         int shift) {
  const int col = threadIdx.x & ((1 << shift) - 1);
  if (col >= row_len) return;
  const long long groups = ((long long)gridDim.x * kThreads) >> shift;
  for (long long r0 = ((long long)blockIdx.x * kThreads + threadIdx.x) >>
                      shift;
       r0 < n; r0 += kUnroll * groups) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = r0 + u * groups;
      if (r < n) v[u] = __ldg(table + clamp_row(idx, r, rows) * row_len + col);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = r0 + u * groups;
      if (r < n) __stcs(out + r * row_len + col, v[u]);
    }
  }
}

template <typename T>
void launch(const void* table, long long rows, long long row_len,
            const int* idx, long long n, void* out, cudaStream_t st) {
  const T* t = static_cast<const T*>(table);
  T* o = static_cast<T*>(out);
  if (row_len >= 32) {
    long long blocks = (n * 32 + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    gather_wide_kernel<T><<<(unsigned)blocks, kThreads, 0, st>>>(
        t, idx, o, n, rows, (int)row_len);
    return;
  }
  int shift = 0;
  while ((1LL << shift) < row_len) ++shift;
  const long long per_block = (kThreads >> shift) * (long long)kUnroll;
  long long blocks = (n + per_block - 1) / per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  gather_narrow_kernel<T><<<(unsigned)blocks, kThreads, 0, st>>>(
      t, idx, o, n, rows, (int)row_len, shift);
}

}  // namespace

// table [rows, width] 32-bit words, idx [n] int32, out [n, width].
// vec != 0: width % 4 == 0 and table/out 16-byte aligned (the caller
// checks), copied as 16-byte vectors. Returns cudaGetLastError().
extern "C" int gather_rows(const void* table, long long rows, long long width,
                           const void* idx, long long n, void* out, int vec,
                           void* stream) {
  if (n <= 0 || width <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* idx_i = static_cast<const int*>(idx);
  if (vec) {
    launch<int4>(table, rows, width / 4, idx_i, n, out, st);
  } else {
    launch<uint32_t>(table, rows, width, idx_i, n, out, st);
  }
  return static_cast<int>(cudaGetLastError());
}
