// All-pairs softened gravity: the directed rectangle kernel and the
// Newton-3rd half-pair schedule.
//
// Replaces two TPU kernels of `multi_adapter_particles_tpu/ops/allpairs.py`:
// `_allpairs_kernel` (launcher `all_pairs_accel_pallas`) and
// `_halfpair_kernel` (:269, launcher `all_pairs_accel_halfpair` :338).
//
// Both compute, for each target i,
//   a_i = mass_scale * sum_j d_ij / (|d_ij|^2 + eps2)^{3/2},  d_ij = p_j - p_i,
// then |a_i|, into out [4, N] (ax, ay, az, |a|). The per-pair arithmetic is
// the Pallas kernels': d2 = dx*dx + dy*dy + dz*dz + eps2, inv = rsqrt(d2),
// s = inv*inv*inv, sums of d*s; mass_scale is applied once after the sum.
// No padding mask: padding is parked at 1e9, so pad-pad pairs have d = 0
// and contribute 0, real-to-pad pairs contribute ~1e-18, and self pairs
// contribute 0 through eps2.
//
// Bound on the H100: arithmetic, the FP32 issue slot (an SM issues one warp
// instruction a clock on each of its four schedulers, and its 128 FP32
// lanes need every slot). A pair costs 12 FP32 instructions in the
// rectangle (3 FADD for d, FMUL + 2 FFMA + FADD for d2, 2 FMUL for s, 3
// FFMA into the sums) and 15 in the half-pair kernel (3 more FFMA for the
// j-side; 12 on diagonal tiles), plus one MUFU rsqrt, which takes an issue
// slot too. The inner loops read nothing from device memory. At 1,980 MHz
// the half-pair schedule's 1M call is bound at 246.6 ms by FP32 issue and
// 131.5 ms by the MUFU pipe (16 lanes an SM).
//
// Rectangle: one thread per target; 256-source tiles of (x, y, z) are
// staged through shared memory as float4 (coalesced plane loads, then every
// thread reads each source as a broadcast). `src` may differ from `pos`
// (the split form of the multi-device ring).
//
// Float32 error of a 1M-term sum: a plain running sum loses ~sqrt(N) ulps
// where torch's blocked tree sum loses a few. So each rectangle tile is
// summed in four interleaved chains of 64 terms (which also gives the
// scheduler four independent FMA chains), and the tile sums go into the
// running sum with Kahan compensation; the half-pair kernel sums each
// 512-source tile in registers and folds its per-item sums with Kahan.
//
// Half-pair: the TPU schedule's pair set on tiles of T = 512 (each
// unordered pair of tiles once, the i-side taking row sums and the j-side
// negated column sums; a diagonal tile takes the i-side over the whole
// tile, self pairs included). The TPU kernel carries the j-side sums in
// VMEM across a sequential grid; Hopper blocks run in parallel and in no
// order, and the port promises results that are the same from run to run,
// so there are no atomics.
//
// What the round schedule it replaces lost at 1M (tools/halfpair_profile.py
// on an H100 at 700 W: 490.9 ms against the 246.6 ms bound): 2,047
// dependent launches of 1,024 CTAs, one partial wave each at 8 CTAs an
// SM; an inner loop of 21.25 issue slots a pair (FP32 17: the non-ftz
// rsqrtf wraps MUFU.RSQ in an FSETP and two predicated FMULs; SHFL 1.5:
// the source and its three j-side sums moved one lane a ring step of 4
// pairs); and a Kahan read-modify-write of [3, N] sums and compensations
// at the end of every CTA. The issue mix alone costs 103 ms; tails, gaps
// and the read-modify-write about 49 ms.
//
// The design, against each of those:
// - One pass over the triangle of super-tiles of G = 4 tiles (2,048
//   targets; the last one short when nt % 4 != 0): a work item is a
//   super-tile pair (A, B >= A) from the wrapper's i-major item table, one
//   CTA each, launched in chunks of whole waves (2 CTAs an SM) whose slots
//   fit the wrapper's 1 GiB (at 1M: 7 chunks, 14 launches); no chain of
//   rounds, no grid barrier.
// - Each item writes its i-side sums [3, 2048] and j-side sums [3, 2048]
//   into slots of its own. A fold kernel after each chunk Kahan-adds every
//   column's slots in item-table order into out and comp; the last one
//   applies the mass and writes |a|. Every sum has a fixed order, so the
//   result is bitwise the same from run to run. A chunk's slots are
//   written once and read once (12 floats a column an item, 48 KB).
// - Inside an item, 8 warps hold the 2,048 targets of A, R = 8 a lane in
//   registers (strided by 32: warp loads are 128-byte rows). B's sources
//   are staged a 512-tile at a time in shared memory, each 32-source chunk
//   stored twice in a row, so that ring step s reads lane + s as one
//   LDS.128 at an immediate offset. Only the three j-side sums travel, one
//   lane a step: 3 SHFL and 1 LDS a step of 8 pairs (0.5 a pair, against
//   1.5). After 32 steps each source's sums are back in its lane; the
//   warps' column sums of the tile are added in warp order in shared
//   memory, and written as the item's j-side slot.
// - The i-side sums run in registers over one 512-source tile and are
//   then added into a per-target item sum in shared memory.
// - rsqrt.approx.ftz (inline PTX): d2 >= eps2 > 0 is never denormal, so
//   the result is the non-ftz rsqrtf's bit for bit, without its guard.
// - The ring's branches are warp-uniform; __all_sync votes say so, or the
//   compiler adds a divergent-shuffle fallback around the loop.
// - 8 ring steps a loop body. The j-side loop's SASS: 15 FP32, 1 MUFU, 0.375 SHFL, 0.125 LDS and
//   0.19 others, 16.69 issue slots a pair (the i-side loop 13.20; chip_smoke
//   phase 2 holds them at 15 / 12 FP32 and at most 17 slots): 274 ms of
//   issue at 1M. 120 registers, 2 CTAs (16 warps) an SM.
// - On a diagonal item, warps of tile a take source tiles b >= a (the
//   i-side alone on b == a), and idle on b < a: 6 of 16 tile pairs, on
//   512 of the 131,328 items at 1M.

#include <cuda_runtime.h>

namespace {

constexpr int RECT_THREADS = 256;  // targets per block, one per thread
constexpr int RECT_TJ = 256;       // sources per shared-memory tile

__device__ __forceinline__ void pair_acc(float xi, float yi, float zi,
                                         float xj, float yj, float zj,
                                         float eps2, float& ax, float& ay,
                                         float& az) {
  const float dx = xj - xi;
  const float dy = yj - yi;
  const float dz = zj - zi;
  const float d2 = dx * dx + dy * dy + dz * dz + eps2;
  const float inv = rsqrtf(d2);
  const float s = inv * inv * inv;
  ax += dx * s;
  ay += dy * s;
  az += dz * s;
}

// s + x with Kahan compensation c (the true sum is s - c).
__device__ __forceinline__ void kahan_add(float& s, float& c, float x) {
  const float y = x - c;
  const float t = s + y;
  c = (t - s) - y;
  s = t;
}

__global__ void __launch_bounds__(RECT_THREADS)
rect_kernel(const float* __restrict__ pos, long long ni,
            const float* __restrict__ src, long long nj,
            float* __restrict__ out, float mass_scale, float eps2) {
  __shared__ float4 tile[RECT_TJ];
  const long long i = (long long)blockIdx.x * RECT_THREADS + threadIdx.x;
  const bool live = i < ni;
  const float xi = live ? pos[i] : 0.f;
  const float yi = live ? pos[ni + i] : 0.f;
  const float zi = live ? pos[2 * ni + i] : 0.f;
  float ax = 0.f, ay = 0.f, az = 0.f;  // Kahan sums of the tile sums
  float cx = 0.f, cy = 0.f, cz = 0.f;
  for (long long j0 = 0; j0 < nj; j0 += RECT_TJ) {
    const long long j = j0 + threadIdx.x;
    __syncthreads();  // the previous tile is consumed
    if (j < nj) {
      tile[threadIdx.x] =
          make_float4(src[j], src[nj + j], src[2 * nj + j], 0.f);
    }
    __syncthreads();
    float tx[4] = {0.f, 0.f, 0.f, 0.f};  // chain u takes sources k % 4 == u
    float ty[4] = {0.f, 0.f, 0.f, 0.f};
    float tz[4] = {0.f, 0.f, 0.f, 0.f};
    if (nj - j0 >= RECT_TJ) {
#pragma unroll 4
      for (int k = 0; k < RECT_TJ; k += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 p = tile[k + u];
          pair_acc(xi, yi, zi, p.x, p.y, p.z, eps2, tx[u], ty[u], tz[u]);
        }
      }
    } else {  // the ragged last tile, one chain
      const int cnt = (int)(nj - j0);
      for (int k = 0; k < cnt; ++k) {
        const float4 p = tile[k];
        pair_acc(xi, yi, zi, p.x, p.y, p.z, eps2, tx[0], ty[0], tz[0]);
      }
    }
    kahan_add(ax, cx, (tx[0] + tx[1]) + (tx[2] + tx[3]));
    kahan_add(ay, cy, (ty[0] + ty[1]) + (ty[2] + ty[3]));
    kahan_add(az, cz, (tz[0] + tz[1]) + (tz[2] + tz[3]));
  }
  if (live) {
    ax = (ax - cx) * mass_scale;
    ay = (ay - cy) * mass_scale;
    az = (az - cz) * mass_scale;
    out[i] = ax;
    out[ni + i] = ay;
    out[2 * ni + i] = az;
    out[3 * ni + i] = sqrtf(ax * ax + ay * ay + az * az);
  }
}

// The half-pair schedule. Target q of a super-tile lives in warp q / 256,
// lane q % 32, register (q / 32) % 8; warp w holds 512-tile w / 2.
constexpr int HALF_T = 512;                      // tile width
constexpr int HALF_G = 4;                        // tiles a super-tile
constexpr int HALF_SUPER = HALF_T * HALF_G;      // targets a super-tile
constexpr int HALF_R = 8;                        // targets a lane
constexpr int HALF_WARPS = HALF_SUPER / (32 * HALF_R);
constexpr int HALF_THREADS = HALF_WARPS * 32;
constexpr int HALF_CHUNKS = HALF_T / 32;         // ring chunks a tile
constexpr int HALF_UNROLL = 8;                   // ring steps a loop body
constexpr int HALF_SLOT = 2 * 3 * HALF_SUPER;    // floats of an item's slots
// dynamic shared memory: the staged tile (each chunk twice), the warps'
// column sums of a tile, the item's i-side sums
constexpr int HALF_SMEM = 2 * HALF_T * 16 + HALF_WARPS * 3 * HALF_T * 4 +
                          3 * HALF_SUPER * 4;
constexpr int HALF_FOLD_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One warp against one staged 512-source tile: the row sums of its R
// targets a lane into (ax, ay, az), set here; with kJ, the warp's negated
// column sums into jp[3][T]. `src` holds chunk c at [64 c, 64 c + 64): its
// 32 sources, twice.
template <bool kJ>
__device__ __forceinline__ void half_ring(
    const float4* __restrict__ src, float* __restrict__ jp,
    const float (&xi)[HALF_R], const float (&yi)[HALF_R],
    const float (&zi)[HALF_R], float (&ax)[HALF_R], float (&ay)[HALF_R],
    float (&az)[HALF_R], float eps2, int lane) {
  const int next = (lane + 1) & 31;
#pragma unroll
  for (int r = 0; r < HALF_R; ++r) ax[r] = ay[r] = az[r] = 0.f;
  for (int c = 0; c < HALF_CHUNKS; ++c) {
    // step s: this lane meets source (lane + s) % 32 and holds its sums
    const float4* sp = src + c * 64 + lane;
    float jx = 0.f, jy = 0.f, jz = 0.f;
    for (int s0 = 0; s0 < 32; s0 += HALF_UNROLL) {
#pragma unroll
      for (int u = 0; u < HALF_UNROLL; ++u) {
        const float4 p = sp[s0 + u];
#pragma unroll
        for (int r = 0; r < HALF_R; ++r) {
          const float dx = p.x - xi[r];
          const float dy = p.y - yi[r];
          const float dz = p.z - zi[r];
          const float d2 = dx * dx + dy * dy + dz * dz + eps2;
          const float inv = rsqrt_ftz(d2);
          const float w = inv * inv * inv;
          ax[r] += dx * w;
          ay[r] += dy * w;
          az[r] += dz * w;
          if (kJ) {
            jx -= dx * w;
            jy -= dy * w;
            jz -= dz * w;
          }
        }
        if (kJ) {  // the sums move on with their source, one lane down
          jx = __shfl_sync(FULL, jx, next);
          jy = __shfl_sync(FULL, jy, next);
          jz = __shfl_sync(FULL, jz, next);
        }
      }
    }
    if (kJ) {  // 32 moves later each source's sums are in its own lane
      jp[c * 32 + lane] = jx;
      jp[HALF_T + c * 32 + lane] = jy;
      jp[2 * HALF_T + c * 32 + lane] = jz;
    }
  }
}

// Item k0 + blockIdx.x of the table: super-tiles (A, B) = (ia[k], ib[k]),
// B >= A. Writes slot[blockIdx.x] = [i-side [3][SUPER], j-side [3][SUPER]]
// (unscaled; columns of missing tiles of a short super-tile untouched).
__global__ void __launch_bounds__(HALF_THREADS, 2)
half_item_kernel(const float* __restrict__ pos, long long n, int nt,
                 const int* __restrict__ ia, const int* __restrict__ ib,
                 long long k0, float* __restrict__ slot, float eps2) {
  extern __shared__ float4 smem[];
  float4* src = smem;                                   // [2 T]
  float* jpart = reinterpret_cast<float*>(smem + 2 * HALF_T);  // [W][3][T]
  float* isum = jpart + HALF_WARPS * 3 * HALF_T;        // [3][SUPER]
  const long long k = k0 + blockIdx.x;
  const int A = ia[k], B = ib[k];
  const bool diag = A == B;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wt = warp / 2;  // this warp's tile in A
  const bool live = A * HALF_G + wt < nt;
  const long long ibase = (long long)A * HALF_SUPER;
  float xi[HALF_R], yi[HALF_R], zi[HALF_R];
#pragma unroll
  for (int r = 0; r < HALF_R; ++r) {
    const int q = warp * 32 * HALF_R + r * 32 + lane;
    const long long i = ibase + q;
    xi[r] = live ? pos[i] : 0.f;
    yi[r] = live ? pos[n + i] : 0.f;
    zi[r] = live ? pos[2 * n + i] : 0.f;
    isum[q] = isum[HALF_SUPER + q] = isum[2 * HALF_SUPER + q] = 0.f;
  }
  float* si = slot + (long long)blockIdx.x * HALF_SLOT;
  float* sj = si + 3 * HALF_SUPER;
  const int tiles_b = min(HALF_G, nt - B * HALF_G);
  for (int bt = 0; bt < tiles_b; ++bt) {
    const long long jbase = ((long long)B * HALF_G + bt) * HALF_T;
    __syncthreads();  // the previous tile's sources and sums are consumed
    for (int s = threadIdx.x; s < HALF_T; s += HALF_THREADS) {
      const float4 p = make_float4(pos[jbase + s], pos[n + jbase + s],
                                   pos[2 * n + jbase + s], 0.f);
      const int at = (s >> 5) * 64 + (s & 31);
      src[at] = p;
      src[at + 32] = p;
    }
    __syncthreads();
    // a diagonal item pairs tile wt with tiles bt >= wt only (both tests
    // are the same for the whole warp: the votes tell the compiler so,
    // and it drops its divergent-shuffle fallback)
    if (__all_sync(FULL, live && (!diag || wt <= bt))) {
      float ax[HALF_R], ay[HALF_R], az[HALF_R];
      if (__all_sync(FULL, !diag || wt < bt)) {
        half_ring<true>(src, jpart + warp * 3 * HALF_T, xi, yi, zi, ax, ay,
                        az, eps2, lane);
      } else {
        half_ring<false>(src, jpart, xi, yi, zi, ax, ay, az, eps2, lane);
      }
#pragma unroll
      for (int r = 0; r < HALF_R; ++r) {
        const int q = warp * 32 * HALF_R + r * 32 + lane;
        isum[q] += ax[r];
        isum[HALF_SUPER + q] += ay[r];
        isum[2 * HALF_SUPER + q] += az[r];
      }
    }
    __syncthreads();
    // the tile's column sums: the j-side warps' sums in warp order
    const int w_end = diag ? 2 * bt : HALF_WARPS;
    const int w_live = 2 * (nt - A * HALF_G);
    const int w_last = min(w_end, w_live);
    for (int s = threadIdx.x; s < HALF_T; s += HALF_THREADS) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        float v = 0.f;
        for (int w = 0; w < w_last; ++w) v += jpart[(w * 3 + d) * HALF_T + s];
        sj[d * HALF_SUPER + bt * HALF_T + s] = v;
      }
    }
  }
  if (live) {
#pragma unroll
    for (int r = 0; r < HALF_R; ++r) {
      const int q = warp * 32 * HALF_R + r * 32 + lane;
      si[q] = isum[q];
      si[HALF_SUPER + q] = isum[HALF_SUPER + q];
      si[2 * HALF_SUPER + q] = isum[2 * HALF_SUPER + q];
    }
  }
}

// First item of row a in the i-major table of ns super-tiles.
__host__ __device__ inline long long half_row_start(long long a,
                                                    long long ns) {
  return a * ns - a * (a - 1) / 2;
}

// Fold the slots of items [k0, k1) (rows a0 .. a1 of the table) into out
// [0:3] (sums) and comp [3, n] (their Kahan compensation), column g of
// super-tile S in table order: the j-sides of items (A, S), A < S; then
// item (S, S), i-side then j-side; then the i-sides of items (S, B > S).
// `first` starts from 0; `last` writes out = (sum - comp) * mass and |a|.
__global__ void __launch_bounds__(HALF_FOLD_THREADS)
half_fold_kernel(const float* __restrict__ slot, long long k0, long long k1,
                 int a0, int a1, int ns, long long n, float* __restrict__ out,
                 float* __restrict__ comp, float mass_scale, int first,
                 int last) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  const int S = (int)(g / HALF_SUPER);
  const int c = (int)(g - (long long)S * HALF_SUPER);
  float s[3], e[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    s[d] = first ? 0.f : out[d * n + g];
    e[d] = first ? 0.f : comp[d * n + g];
  }
  const int a_hi = min(a1, S);
  for (int a = a0; a <= a_hi; ++a) {
    const long long k = half_row_start(a, ns) + (S - a);
    if (k < k0 || k >= k1) continue;
    const float* p = slot + (k - k0) * HALF_SLOT + c;
    if (a == S) {
#pragma unroll
      for (int d = 0; d < 3; ++d) kahan_add(s[d], e[d], p[d * HALF_SUPER]);
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      kahan_add(s[d], e[d], p[(3 + d) * HALF_SUPER]);
    }
  }
  if (S >= a0 && S <= a1) {
    const long long kb = max(half_row_start(S, ns) + 1, k0);
    const long long ke = min(half_row_start(S + 1, ns), k1);
    for (long long k = kb; k < ke; ++k) {
      const float* p = slot + (k - k0) * HALF_SLOT + c;
#pragma unroll
      for (int d = 0; d < 3; ++d) kahan_add(s[d], e[d], p[d * HALF_SUPER]);
    }
  }
  if (last) {
    const float ax = (s[0] - e[0]) * mass_scale;
    const float ay = (s[1] - e[1]) * mass_scale;
    const float az = (s[2] - e[2]) * mass_scale;
    out[g] = ax;
    out[n + g] = ay;
    out[2 * n + g] = az;
    out[3 * n + g] = sqrtf(ax * ax + ay * ay + az * az);
  } else {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      out[d * n + g] = s[d];
      comp[d * n + g] = e[d];
    }
  }
}

}  // namespace

// pos [4, ni] targets, src [4, nj] sources -> out [4, ni]; all float32,
// contiguous, on the current device; out must not alias pos or src.
// Returns cudaGetLastError().
extern "C" int allpairs_rect(const void* pos, long long ni, const void* src,
                             long long nj, void* out, float mass_scale,
                             float eps2, void* stream) {
  if (ni <= 0) return 0;
  const long long blocks = (ni + RECT_THREADS - 1) / RECT_THREADS;
  rect_kernel<<<(unsigned)blocks, RECT_THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), ni, static_cast<const float*>(src), nj,
      static_cast<float*>(out), mass_scale, eps2);
  return static_cast<int>(cudaGetLastError());
}

// The tile width and the super-tile width of the half-pair schedule (the
// wrapper's fallback rule and item table).
extern "C" int allpairs_half_tile() { return HALF_T; }
extern "C" int allpairs_half_super() { return HALF_SUPER; }

// Sets the item kernel's shared memory limit and writes the CTAs of the
// item kernel the current device runs at once (SMs x CTAs an SM) to *wave.
extern "C" int allpairs_half_wave(int* wave) {
  cudaError_t err = cudaFuncSetAttribute(
      half_item_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      HALF_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, half_item_kernel, HALF_THREADS, HALF_SMEM);
  }
  *wave = sms * per_sm;
  return static_cast<int>(err);
}

// pos [4, n] -> out [4, n] by the half-pair schedule; n a multiple of 512
// with at least two tiles. (ia, ib): the item table, the `items` =
// ns (ns + 1) / 2 super-tile pairs (A, B >= A) in i-major order, ns =
// ceil(n / 2048). slot: scratch for `chunk` items' slots, comp: scratch
// [3, n]. Launches the item kernel and a fold a chunk: 2 ceil(items /
// chunk) kernels. allpairs_half_wave must have run on the device.
extern "C" int allpairs_half(const void* pos, long long n, const void* ia,
                             const void* ib, long long items, long long chunk,
                             void* slot, void* out, void* comp,
                             float mass_scale, float eps2, void* stream) {
  const long long nt = n / HALF_T;
  const long long ns = (nt + HALF_G - 1) / HALF_G;
  if (n % HALF_T != 0 || nt < 2 || items != ns * (ns + 1) / 2 ||
      chunk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pos);
  float* sl = static_cast<float*>(slot);
  float* o = static_cast<float*>(out);
  float* cm = static_cast<float*>(comp);
  const unsigned fold_blocks =
      (unsigned)((n + HALF_FOLD_THREADS - 1) / HALF_FOLD_THREADS);
  int a0 = 0;
  for (long long k0 = 0; k0 < items; k0 += chunk) {
    const long long k1 = k0 + chunk < items ? k0 + chunk : items;
    half_item_kernel<<<(unsigned)(k1 - k0), HALF_THREADS, HALF_SMEM, st>>>(
        p, n, (int)nt, static_cast<const int*>(ia),
        static_cast<const int*>(ib), k0, sl, eps2);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    // rows a0 .. a1 of the table hold items k0 .. k1 - 1
    while (half_row_start(a0 + 1, ns) <= k0) ++a0;
    int a1 = a0;
    while (half_row_start(a1 + 1, ns) <= k1 - 1) ++a1;
    half_fold_kernel<<<fold_blocks, HALF_FOLD_THREADS, 0, st>>>(
        sl, k0, k1, a0, a1, (int)ns, n, o, cm, mass_scale, k0 == 0,
        k1 == items);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
