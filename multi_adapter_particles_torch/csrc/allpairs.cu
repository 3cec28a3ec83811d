// All-pairs softened gravity: the directed rectangle kernel and the
// Newton-3rd half-pair schedule.
//
// Replaces two TPU kernels of `multi_adapter_particles_tpu/ops/allpairs.py`:
// `_allpairs_kernel` (launcher `all_pairs_accel_pallas`) and
// `_halfpair_kernel` (launcher `all_pairs_accel_halfpair`).
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
// Bound on the H100: arithmetic. A pair costs 11 fp32 instructions in the
// rectangle (3 sub, 3 FMA for d2, 2 mul, 3 FMA into the sums) and 14 in the
// half-pair kernel (3 more FMA for the j-side) plus one MUFU rsqrt, and
// reads nothing from device memory in the inner loop. At 132 SMs x 128
// fp32 lanes that caps the rectangle near 3e12 pairs/s at boost clock.
//
// Rectangle: one thread per target; 256-source tiles of (x, y, z) are
// staged through shared memory as float4 (coalesced plane loads, then every
// thread reads each source as a broadcast). `src` may differ from `pos`
// (the split form of the multi-device ring).
//
// Float32 error of a 1M-term sum: a plain running sum loses ~sqrt(N) ulps
// where torch's blocked tree sum loses a few. So each tile is summed in
// four interleaved chains of 64 terms (which also gives the scheduler four
// independent FMA chains), and the tile sums go into the running sum with
// Kahan compensation; the half-pair kernel keeps a compensation plane
// beside its accumulators in device memory for the same reason.
//
// Half-pair: the same tile pairs as the TPU schedule (tiles of T = 512; each
// unordered pair of tiles once, the i-side taking row sums and the j-side
// negated column sums; diagonal tiles take the i-side over the whole tile).
// The TPU kernel carries the j-side sums in VMEM across a sequential grid;
// Hopper blocks run in parallel and in no order, and the port promises
// results that are the same from run to run, so there are no float atomics.
// Instead a round-robin ("circle method") schedule: nt tiles (one idle
// tile added when nt is odd) meet in nt-1 rounds, one launch each, in which
// every tile is in exactly one pair. The block of a pair (p, q) is then the
// only writer of both accumulators in its round, and adds its i-side sums
// to tile p and its j-side sums to tile q with plain read-modify-writes.
// A first launch writes the diagonal tiles' sums; a last one scales and
// takes |a|. The order of every sum is fixed by the round, the block and
// the lane, so the result is bitwise the same from run to run.
//
// Inside a round block (4 warps, 4 targets per lane held in registers): the
// j-side column sums need a sum across lanes for every j. A warp takes 32
// sources at a time, one per lane, with a j-side accumulator beside each;
// at each of 32 steps every lane pairs its 4 targets with the source it
// holds, and then the source and its accumulator move one lane down
// (6 shuffles). After 32 steps each source has met the warp's 128 targets
// and is back in its own lane, and the accumulator goes to the warp's slot
// in shared memory. The 4 warps' slots are then summed in warp order. The
// shuffles run beside the fp32 pipe (6 per 128 pairs).

#include <cuda_runtime.h>

namespace {

constexpr int RECT_THREADS = 256;  // targets per block, one per thread
constexpr int RECT_TJ = 256;       // sources per shared-memory tile

constexpr int HALF_T = 512;  // tile width of the half-pair schedule
constexpr int HALF_WARPS = 4;
constexpr int HALF_THREADS = HALF_WARPS * 32;
constexpr int HALF_R = HALF_T / HALF_THREADS;  // targets per lane
constexpr unsigned FULL = 0xffffffffu;

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

// Target k of lane `lane` in warp `warp` of a tile: strided by 32 so each
// load and store of the warp is one contiguous 128-byte row.
__device__ __forceinline__ int half_target(int warp, int lane, int r) {
  return warp * 32 * HALF_R + r * 32 + lane;
}

// Diagonal tiles: every target of tile blockIdx.x against the whole tile
// (the i-side only), written to acc [3, n] (unscaled), with comp [3, n],
// the Kahan compensation of acc, set to 0.
__global__ void __launch_bounds__(HALF_THREADS)
half_diag_kernel(const float* __restrict__ pos, long long n,
                 float* __restrict__ acc, float* __restrict__ comp,
                 float eps2) {
  __shared__ float4 tile[HALF_T];
  const long long base = (long long)blockIdx.x * HALF_T;
  for (int k = threadIdx.x; k < HALF_T; k += HALF_THREADS) {
    tile[k] = make_float4(pos[base + k], pos[n + base + k],
                          pos[2 * n + base + k], 0.f);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float xi[HALF_R], yi[HALF_R], zi[HALF_R];
  float ax[2][HALF_R], ay[2][HALF_R], az[2][HALF_R];  // chains: k even / odd
#pragma unroll
  for (int r = 0; r < HALF_R; ++r) {
    const long long i = base + half_target(warp, lane, r);
    xi[r] = pos[i];
    yi[r] = pos[n + i];
    zi[r] = pos[2 * n + i];
    ax[0][r] = ay[0][r] = az[0][r] = 0.f;
    ax[1][r] = ay[1][r] = az[1][r] = 0.f;
  }
  __syncthreads();
#pragma unroll 2
  for (int k = 0; k < HALF_T; k += 2) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float4 p = tile[k + u];
#pragma unroll
      for (int r = 0; r < HALF_R; ++r) {
        pair_acc(xi[r], yi[r], zi[r], p.x, p.y, p.z, eps2, ax[u][r],
                 ay[u][r], az[u][r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < HALF_R; ++r) {
    const long long i = base + half_target(warp, lane, r);
    acc[i] = ax[0][r] + ax[1][r];
    acc[n + i] = ay[0][r] + ay[1][r];
    acc[2 * n + i] = az[0][r] + az[1][r];
    comp[i] = comp[n + i] = comp[2 * n + i] = 0.f;
  }
}

// acc[k] += x with the Kahan compensation kept in comp[k].
__device__ __forceinline__ void kahan_add_global(float* acc, float* comp,
                                                 long long k, float x) {
  float s = acc[k], c = comp[k];
  kahan_add(s, c, x);
  acc[k] = s;
  comp[k] = c;
}

// One round of the circle method over nt_even tiles (tile nt_even-1 stays
// put, the others rotate): block 0 pairs (round, nt_even-1), block b > 0
// pairs ((round+b) % m, (round-b) % m) with m = nt_even-1. Tiles >= nt are
// the idle tile of an odd count: that pair is skipped.
__global__ void __launch_bounds__(HALF_THREADS, 8)
half_round_kernel(const float* __restrict__ pos, long long n, int nt,
                  int nt_even, int round, float* __restrict__ acc,
                  float* __restrict__ comp, float eps2) {
  const int m = nt_even - 1;
  const int b = blockIdx.x;
  const int p = b == 0 ? round : (round + b) % m;
  const int q = b == 0 ? m : (round - b + m) % m;  // b < m
  if (p >= nt || q >= nt) return;  // uniform across the block

  __shared__ float jpart[HALF_WARPS][3][HALF_T];
  const long long ibase = (long long)p * HALF_T;
  const long long jbase = (long long)q * HALF_T;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int next = (lane + 1) & 31;
  float xi[HALF_R], yi[HALF_R], zi[HALF_R];
  float ax[HALF_R], ay[HALF_R], az[HALF_R];
#pragma unroll
  for (int r = 0; r < HALF_R; ++r) {
    const long long i = ibase + half_target(warp, lane, r);
    xi[r] = pos[i];
    yi[r] = pos[n + i];
    zi[r] = pos[2 * n + i];
    ax[r] = ay[r] = az[r] = 0.f;
  }
  for (int c = 0; c < HALF_T / 32; ++c) {
    const long long j = jbase + c * 32 + lane;
    float xj = pos[j], yj = pos[n + j], zj = pos[2 * n + j];
    float jx = 0.f, jy = 0.f, jz = 0.f;
#pragma unroll 2
    for (int step = 0; step < 32; ++step) {
#pragma unroll
      for (int r = 0; r < HALF_R; ++r) {
        const float dx = xj - xi[r];
        const float dy = yj - yi[r];
        const float dz = zj - zi[r];
        const float d2 = dx * dx + dy * dy + dz * dz + eps2;
        const float inv = rsqrtf(d2);
        const float s = inv * inv * inv;
        ax[r] += dx * s;
        ay[r] += dy * s;
        az[r] += dz * s;
        jx -= dx * s;
        jy -= dy * s;
        jz -= dz * s;
      }
      // the source and its j-side sums move one lane down
      xj = __shfl_sync(FULL, xj, next);
      yj = __shfl_sync(FULL, yj, next);
      zj = __shfl_sync(FULL, zj, next);
      jx = __shfl_sync(FULL, jx, next);
      jy = __shfl_sync(FULL, jy, next);
      jz = __shfl_sync(FULL, jz, next);
    }
    // 32 moves later each source is back in its own lane
    jpart[warp][0][c * 32 + lane] = jx;
    jpart[warp][1][c * 32 + lane] = jy;
    jpart[warp][2][c * 32 + lane] = jz;
  }
#pragma unroll
  for (int r = 0; r < HALF_R; ++r) {
    const long long i = ibase + half_target(warp, lane, r);
    kahan_add_global(acc, comp, i, ax[r]);
    kahan_add_global(acc, comp, n + i, ay[r]);
    kahan_add_global(acc, comp, 2 * n + i, az[r]);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < HALF_T; k += HALF_THREADS) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      float s = jpart[0][d][k];
#pragma unroll
      for (int w = 1; w < HALF_WARPS; ++w) s += jpart[w][d][k];
      kahan_add_global(acc, comp, d * n + jbase + k, s);
    }
  }
}

// out[0:3] = (out[0:3] - comp) * mass_scale; out[3] = |out[0:3]|.
__global__ void finish_kernel(float* __restrict__ out,
                              const float* __restrict__ comp, long long n,
                              float mass_scale) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float ax = (out[i] - comp[i]) * mass_scale;
    const float ay = (out[n + i] - comp[n + i]) * mass_scale;
    const float az = (out[2 * n + i] - comp[2 * n + i]) * mass_scale;
    out[i] = ax;
    out[n + i] = ay;
    out[2 * n + i] = az;
    out[3 * n + i] = sqrtf(ax * ax + ay * ay + az * az);
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

// The tile width of the half-pair schedule (the wrapper's fallback rule).
extern "C" int allpairs_half_tile() { return HALF_T; }

// pos [4, n] -> out [4, n] by the half-pair schedule, with scratch comp
// [3, n]; n must be a multiple of 512 with at least two tiles. Launches
// 1 + (nt-1 or nt) + 1 kernels.
extern "C" int allpairs_half(const void* pos, long long n, void* out,
                             void* comp, float mass_scale, float eps2,
                             void* stream) {
  if (n % HALF_T != 0 || n / HALF_T < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pos);
  float* acc = static_cast<float*>(out);
  float* cmp = static_cast<float*>(comp);
  const int nt = (int)(n / HALF_T);
  const int nt_even = nt + (nt & 1);
  half_diag_kernel<<<nt, HALF_THREADS, 0, st>>>(p, n, acc, cmp, eps2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int round = 0; round < nt_even - 1; ++round) {
    half_round_kernel<<<nt_even / 2, HALF_THREADS, 0, st>>>(
        p, n, nt, nt_even, round, acc, cmp, eps2);
    if (round == 0) {
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  long long blocks = (n + 255) / 256;
  if (blocks > 132LL * 16) blocks = 132LL * 16;
  finish_kernel<<<(unsigned)blocks, 256, 0, st>>>(acc, cmp, n, mass_scale);
  return static_cast<int>(cudaGetLastError());
}
