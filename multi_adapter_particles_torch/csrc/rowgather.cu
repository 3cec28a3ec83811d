// Row gather: out[n, :] = table[clamp(idx[n], 0, R - 1), :].
//
// Replaces the TPU kernel `experiments/rowgather_pallas.py` `pallas_gather`
// (kernel `_gather_kernel`), which scalar-prefetches a tile of indices and
// keeps a DEPTH-deep ring of single-row DMAs from HBM into VMEM in flight.
// The renderer uses this function for its ONE packed payload gather: the
// sorted (cx, cy, w, cgb) stream, cut into Q-aligned data rows of 4Q words,
// is gathered once per virtual row (`render/renderer.py`).
//
// Bound on the H100: bytes. Each output word is read once from the table
// and written once (the index is read by every thread of its row, from L1),
// so the least time is 2 * N * W * 4 bytes over 3.35 TB/s: 0.060 ms at the
// render's per-chunk shape (24,576 rows of 1,024 words). The design keeps
// that many bytes in flight without a ring: one thread per 16-byte vector of
// the output (a row of 1,024 words is 256 threads, a row of 32 words 8), so
// neighbouring threads read neighbouring addresses of one source row and
// write neighbouring addresses of one output row, and a full card holds
// ~270k threads, each with one 16-byte load outstanding, well above what
// the memory latency needs. The TPU prototype's ring of DMAs is what the
// warp scheduler does here by itself. A scalar path (one thread per word)
// takes tables whose width is not a multiple of 4 words or whose rows are
// not 16-byte aligned.
//
// Out-of-range indices clamp to [0, R - 1], as XLA's gather does and the
// JAX renderer relies on for dead virtual rows. Pure copy: bitwise equal to
// `table[idx.clamp(0, R - 1)]` for any 32-bit payload.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 24;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gather_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                  T* __restrict__ out, long long n_elems, long long rows,
                  long long row_len) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
       e < n_elems; e += stride) {
    const long long r = e / row_len;
    const long long c = e - r * row_len;
    long long src = __ldg(idx + r);
    src = src < 0 ? 0 : (src >= rows ? rows - 1 : src);
    out[e] = __ldg(table + src * row_len + c);
  }
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
  const long long row_len = vec ? width / 4 : width;
  const long long n_elems = n * row_len;
  long long blocks = (n_elems + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const int* idx_i = static_cast<const int*>(idx);
  if (vec) {
    gather_kernel<int4><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const int4*>(table), idx_i, static_cast<int4*>(out),
        n_elems, rows, row_len);
  } else {
    gather_kernel<uint32_t><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const uint32_t*>(table), idx_i,
        static_cast<uint32_t*>(out), n_elems, rows, row_len);
  }
  return static_cast<int>(cudaGetLastError());
}
