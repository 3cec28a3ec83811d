// Cloud-in-cell deposit of sorted particles onto the [G, G, G] count grid.
// Two kernels, one launch each per deposit.
//
// Replaces no TPU kernel. The JAX package deposits with XLA ops and
// `gather_rows` (`ops/pm.py` there): a cumsum of the 8 corner weights over
// the sorted particles, read at each cell's segment bounds. ops/pm.py holds
// that as the plain torch version (`deposit_sorted_plain`). On the H100
// torch's scan walks each of the 8 rows of 4,194,304 weights at ~21 GB/s
// (6.4 ms), and differencing a float32 running sum that climbs to ~5e5
// loses the small cells' counts to cancellation. Here no prefix sum is
// taken: each cell's run of sorted particles is summed on its own, in a
// fixed order, from its first particle.
//
// Inputs: sbase [n] int64, the particles' base cell ids sorted ascending
// (ids at or past ncell = G^3 are off the mesh and deposit nothing);
// sfrac [3, n] float32, their (x, y, z) fractions in the same order;
// bounds [ncell + 1] int64, bounds[k] = #{i : sbase[i] < k}, so cell k's
// run is [bounds[k], bounds[k + 1]).
//
// cic_tile_kernel: a CTA a tile of kTile = 2,048 consecutive sorted
//   particles, 8 a thread, whatever cells they fall in. Each thread weights
//   its particles (the twin's (wx * wy) * wz in (dz, dy, dx) binary order,
//   0 off the mesh) and sums its runs left to right; a segmented inclusive
//   scan over the threads (warp shuffles, then the warps in order) carries
//   a run across threads. Each run that lies wholly inside the tile goes
//   straight to hist [8, ncell]; the partial sum of a run that enters the
//   tile from the one before goes to head [8, tiles], that of a run that
//   leaves it for the next to tail [8, tiles]. A tile that starts off the
//   mesh returns at once (the sorted tail of parked particles).
// cic_grid_kernel: a thread a node. For each corner c in the twin's order it
//   reads the corner's cell k = node - (dz, dy, dx) from bounds: an empty
//   run adds exact 0 (as csum[b] - csum[b] did), a run inside one tile its
//   hist entry, and a run over tiles ts..te the sum of tail[ts], head[ts+1],
//   ..., head[te], which the warp takes together: lane j adds the partials
//   j, j + 32, ... in tile order, then a shuffle tree adds the lanes. rho =
//   (((0 + h0) + h1) + ...) over the corners the twin's slices reach.
//
// Balance: work is split over sorted particles, not cells, so a tile costs
// the same whether its 2,048 particles fill two cells or a thousand. At most
// one run crosses each tile boundary, so the grid kernel resolves at most
// n / kTile crossing runs, each by up to 8 warps (the nodes that read it),
// in ceil(tiles spanned / 32) loads a lane: all n in one cell is 2,048
// tiles at 4M, 64 loads a lane.
//
// Bound on the H100: bytes. sbase (8 B) and sfrac (12 B) a particle read
// once, bounds (8 B a cell) read once, rho (4 B a node) written once, and
// the histogram's round trip for the cells that hold particles (8 corners x
// 4 B written and read): 0.033 ms at 4,194,304 particles on ~24K occupied
// cells of G = 128, 0.073 ms with every cell occupied, at 3.35 TB/s. Empty
// cells read no histogram entry, so nothing clears it.
//
// No atomics: every output has one writer and every sum a fixed order, so
// the result is the same run to run. Build with -fmad=false (ops/pm.py
// does), so each weight rounds after each multiply as the twin's does.

#include <cuda_runtime.h>

#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kCorners = 8;
constexpr unsigned kFull = 0xffffffffu;
// one pad word every 32: a thread's 8 consecutive items sit in 8 banks no
// other lane of its warp reads at the same time
constexpr int kPadded = kTile + kTile / 32;

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// The twin's `_corner_weights`: corner c = dz * 4 + dy * 2 + dx weighs
// (wx * wy) * wz; 0 for a particle off the mesh.
__device__ __forceinline__ void corner_weights(float fx, float fy, float fz,
                                               bool live, float w[kCorners]) {
  const float wx[2] = {1.0f - fx, fx};
  const float wy[2] = {1.0f - fy, fy};
  const float wz[2] = {1.0f - fz, fz};
#pragma unroll
  for (int c = 0; c < kCorners; ++c)
    w[c] = live ? (wx[c & 1] * wy[(c >> 1) & 1]) * wz[c >> 2] : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
    cic_tile_kernel(const long long* __restrict__ sbase,
                    const float* __restrict__ sfrac, long long n, int ncell,
                    int tiles, float* __restrict__ hist,
                    float* __restrict__ head, float* __restrict__ tail) {
  __shared__ int s_key[kPadded];
  __shared__ float s_frac[3][kPadded];
  __shared__ float s_agg[kWarps][kCorners];
  __shared__ int s_agg_reset[kWarps];
  __shared__ float s_scan[kThreads][kCorners];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long t0 = (long long)blockIdx.x * kTile;
  if (sbase[t0] >= ncell) return;  // sorted: the whole tile is off the mesh
  const long long t1 = t0 + kTile < n ? t0 + kTile : n;
  const int prev_key = t0 > 0 ? (int)sbase[t0 - 1] : -1;
  const int next_key = t1 < n ? (int)sbase[t1] : -1;

#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int p = tid + r * kThreads;
    const long long i = t0 + p;
    const bool ok = i < n;
    s_key[pad(p)] = ok ? (int)sbase[i] : INT_MAX;
    s_frac[0][pad(p)] = ok ? sfrac[i] : 0.0f;
    s_frac[1][pad(p)] = ok ? sfrac[n + i] : 0.0f;
    s_frac[2][pad(p)] = ok ? sfrac[2 * n + i] : 0.0f;
  }
  __syncthreads();

  const int first_key = s_key[0];
  const int last_key = s_key[pad((int)(t1 - t0) - 1)];
  // a finished run's sum: a run entering from the tile before -> head, one
  // leaving for the tile after -> tail, any other -> its cell's entry
  auto emit = [&](int key, const float* sum) {
    if (key >= ncell) return;
    float* out;
    long long stride;
    if (key == first_key && key == prev_key) {
      out = head + blockIdx.x;
      stride = tiles;
    } else if (key == last_key && key == next_key) {
      out = tail + blockIdx.x;
      stride = tiles;
    } else {
      out = hist + key;
      stride = ncell;
    }
#pragma unroll
    for (int c = 0; c < kCorners; ++c) out[c * stride] = sum[c];
  };

  // the thread's runs, left to right: the first (it may continue from the
  // thread before), those strictly inside (emitted here), the last (it may
  // continue into the thread after)
  const int base = tid * kItems;
  const int key0 = s_key[pad(base)];
  float acc[kCorners], first[kCorners];
  corner_weights(s_frac[0][pad(base)], s_frac[1][pad(base)],
                 s_frac[2][pad(base)], key0 < ncell, acc);
  int cur = key0;
  bool split = false;  // the first run ended inside the thread
#pragma unroll
  for (int j = 1; j < kItems; ++j) {
    const int p = pad(base + j);
    const int key = s_key[p];
    float w[kCorners];
    corner_weights(s_frac[0][p], s_frac[1][p], s_frac[2][p], key < ncell, w);
    if (key == cur) {
#pragma unroll
      for (int c = 0; c < kCorners; ++c) acc[c] = acc[c] + w[c];
    } else {
      if (split) {
        emit(cur, acc);
      } else {
#pragma unroll
        for (int c = 0; c < kCorners; ++c) first[c] = acc[c];
        split = true;
      }
      cur = key;
#pragma unroll
      for (int c = 0; c < kCorners; ++c) acc[c] = w[c];
    }
  }

  // segmented inclusive scan of the last run's partial over the threads:
  // a thread resets the sum where its last run starts inside it
  const bool joins = tid > 0 && key0 == s_key[pad(base - 1)];
  float v[kCorners];
#pragma unroll
  for (int c = 0; c < kCorners; ++c) v[c] = acc[c];
  int reset = split || !joins;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    float up[kCorners];
#pragma unroll
    for (int c = 0; c < kCorners; ++c) up[c] = __shfl_up_sync(kFull, v[c], d);
    const int up_reset = __shfl_up_sync(kFull, reset, d);
    if (lane >= d) {
      if (!reset) {
#pragma unroll
        for (int c = 0; c < kCorners; ++c) v[c] = up[c] + v[c];
      }
      reset |= up_reset;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int c = 0; c < kCorners; ++c) s_agg[warp][c] = v[c];
    s_agg_reset[warp] = reset;
  }
  __syncthreads();
  if (warp > 0 && !reset) {
    // the warps before, in order
    float pre[kCorners];
#pragma unroll
    for (int c = 0; c < kCorners; ++c) pre[c] = s_agg[0][c];
    for (int u = 1; u < warp; ++u) {
      const bool r = s_agg_reset[u];
#pragma unroll
      for (int c = 0; c < kCorners; ++c)
        pre[c] = r ? s_agg[u][c] : pre[c] + s_agg[u][c];
    }
#pragma unroll
    for (int c = 0; c < kCorners; ++c) v[c] = pre[c] + v[c];
  }
#pragma unroll
  for (int c = 0; c < kCorners; ++c) s_scan[tid][c] = v[c];
  __syncthreads();

  if (split) {
    // the first run ends in this thread: the threads before carry its start
    if (joins) {
#pragma unroll
      for (int c = 0; c < kCorners; ++c)
        first[c] = s_scan[tid - 1][c] + first[c];
    }
    emit(key0, first);
  }
  if (tid == kThreads - 1 || s_key[pad(base + kItems)] != cur) emit(cur, v);
}

// Sum of a run over tiles ts..te (te > ts) for corner c, taken by the whole
// warp: tail[ts], then head[ts + 1..te], lane j adding the partials j, j +
// 32, ... in tile order, then a shuffle tree. Every lane returns it.
__device__ __forceinline__ float crossing_sum(const float* __restrict__ head,
                                              const float* __restrict__ tail,
                                              long long tiles, int c,
                                              long long ts, long long te,
                                              int lane) {
  const long long len = te - ts + 1;
  const long long row = (long long)c * tiles + ts;
  float acc = 0.0f;
  for (long long j = lane; j < len; j += 32)
    acc = acc + (j == 0 ? tail[row] : head[row + j]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = acc + __shfl_down_sync(kFull, acc, off);
  return __shfl_sync(kFull, acc, 0);
}

__global__ void __launch_bounds__(kThreads)
    cic_grid_kernel(const long long* __restrict__ bounds,
                    const float* __restrict__ hist,
                    const float* __restrict__ head,
                    const float* __restrict__ tail, int g, int tiles,
                    float* __restrict__ rho) {
  const long long ncell = (long long)g * g * g;
  const long long gg = (long long)g * g;
  const long long m = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool active = m < ncell;
  const long long x = m % g;
  const long long y = (m / g) % g;
  const long long z = m / gg;

  float v[kCorners];
  unsigned cross = 0;  // corners whose run crosses a tile boundary
#pragma unroll
  for (int c = 0; c < kCorners; ++c) {
    const int dz = c >> 2, dy = (c >> 1) & 1, dx = c & 1;
    v[c] = 0.0f;
    if (active && z >= dz && y >= dy && x >= dx) {
      const long long k = m - (dz * gg + dy * g + dx);
      const long long s = bounds[k], e = bounds[k + 1];
      if (s < e) {
        if (s / kTile == (e - 1) / kTile)
          v[c] = hist[c * ncell + k];
        else
          cross |= 1u << c;
      }
    }
  }
  // crossing runs, one (lane, corner) at a time, by the whole warp
  unsigned lanes = __ballot_sync(kFull, cross != 0);
  while (lanes) {
    const int src = __ffs(lanes) - 1;
    const int c = __ffs(__shfl_sync(kFull, cross, src)) - 1;
    const long long ms = __shfl_sync(kFull, m, src);
    const long long k = ms - ((c >> 2) * gg + ((c >> 1) & 1) * g + (c & 1));
    const long long s = bounds[k], e = bounds[k + 1];
    const float sum =
        crossing_sum(head, tail, tiles, c, s / kTile, (e - 1) / kTile, lane);
    if (lane == src) {
#pragma unroll
      for (int cc = 0; cc < kCorners; ++cc)
        if (cc == c) v[cc] = sum;
      cross &= ~(1u << c);
    }
    lanes = __ballot_sync(kFull, cross != 0);
  }
  if (active) {
    float r = 0.0f;
#pragma unroll
    for (int c = 0; c < kCorners; ++c) r = r + v[c];
    rho[m] = r;
  }
}

}  // namespace

extern "C" int cic_tile() { return kTile; }

// sbase [n] int64 sorted, sfrac [3, n] f32, bounds [G^3 + 1] int64; scratch
// hist [8, G^3], head and tail [8, ceil(n / cic_tile())] f32; out rho
// [G, G, G] f32. G^3 < 2^31 (the caller checks). Returns cudaGetLastError().
extern "C" int cic_deposit(const void* sbase, const void* sfrac, long long n,
                           int g, const void* bounds, void* hist, void* head,
                           void* tail, void* rho, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long ncell = (long long)g * g * g;
  const long long tiles = (n + kTile - 1) / kTile;
  float* h = static_cast<float*>(head);
  float* t = static_cast<float*>(tail);
  if (n > 0) {
    cic_tile_kernel<<<(unsigned)tiles, kThreads, 0, st>>>(
        static_cast<const long long*>(sbase), static_cast<const float*>(sfrac),
        n, (int)ncell, (int)tiles, static_cast<float*>(hist), h, t);
  }
  cic_grid_kernel<<<(unsigned)((ncell + kThreads - 1) / kThreads), kThreads,
                    0, st>>>(static_cast<const long long*>(bounds),
                             static_cast<const float*>(hist), h, t, g,
                             (int)tiles, static_cast<float*>(rho));
  return static_cast<int>(cudaGetLastError());
}
