// Newton-3rd half-pair generations: v5 (and its modes), v5s, v6 and v7.
//
// Replaces the four TPU kernels of `experiments/allpairs_halfpair.py`:
// `_v5_kernel` (:45, launcher `v5_accel`), `_v5s_kernel` (:120,
// `v5s_accel`), `_v6_kernel` (:268, `v6_accel`) and `_v7_kernel` (:459,
// `v7_accel`).
//
// Each walks the JAX triangle of tile pairs (i, j >= i) over tiles of t
// targets: the i-side takes the row sums of every pair (the diagonal tile
// whole); the j-side takes the negated column sums of the pairs j > i
// ("full"), or v5's attribution modes: "reduce_only" sums colsum(tx) +
// colsum(ty) + colsum(tz) of every pair j >= i into the x row of tile 0,
// "tri_only" has no j-side. out [4, N] = ((i-side) + (j-side)) * mass and
// |a|. The per-pair arithmetic is the Pallas bodies': d = p_j - p_i,
// d2 = dx*dx + dy*dy + dz*dz + eps2, inv = rsqrt(d2), s = inv*inv*inv,
// t = d*s; the mass is applied once after the sum.
//
// Determinism. The TPU kernels carry the j-side sums in VMEM across a
// sequential grid; Hopper blocks run in parallel and in no order. There
// are no float atomics here, and no integer ones either. The j-side
// mechanism all four share is scratch slots folded in a fixed order: a CTA
// writes the column sums of each tile pair it computes into a slot of its
// own, and a fold kernel then adds each column's slots in increasing i (v6:
// in pair-table order), the order of the JAX sequential grid, with Kahan
// compensation, into an accumulator plane that only the fold writes. The
// i-side of a tile is summed by the one CTA that owns it (v6: folded from
// slots in table order). So every sum has a fixed order, and the result is
// bitwise the same from run to run. The alternative, an ordered
// read-modify-write into one [3, N] accumulator behind integer flags, was
// not taken: at 1M the fold kernels take 5.0 ms of v5's 385.7 ms (t =
// 512), 17.8 of v6's 366.2 and 4.7-10.5 of v7's 357.4-372.2, 73-83% of
// v7's byte bound (`tools/allpairs_halfpair.py --profile`; NVIDIA H100
// 80GB HBM3, 700.00 W). Before the fold kept its loads in flight, one
// thread a column walked the band's rows one dependent load at a time:
// 11.6-42.3 ms of v7's call, 9-33% of its bound.
//
// Schedules, each the Hopper reading of its JAX body:
// - v5: one CTA per i-tile walking j = i .. nt-1 (the dynamic lower
//   bound), launched in chunks of C i-tiles (the wrapper's V5_CHUNK =
//   128); each chunk's j-side goes to [C, 3, N] slots (1.61 GB at 1M), one
//   fold launch a chunk: 2 nt / C launches. reduce_only: each CTA keeps its
//   summed column sums for [:t] in a carry and writes one [t] row; the rows
//   are folded in i order. tri_only: the i-side only.
// - v5s: the same CTA with a static loop over all nt tiles and a
//   team-uniform skip of j < i (the predicated body).
// - v6: one tile pair per CTA from the device pair table (i-major,
//   `torch.triu_indices` order), in launches of E entries (V6_ENTRIES =
//   65,536: [2, E, 3, t] slots, 0.81 GB at t = 512); a fold launch after
//   each adds the entries' i-side and j-side slots in table order.
// - v7: one launch per band of kb j-tiles over i-tiles 0 .. band end, the
//   static predicated loop over the band; the band's j-side goes to
//   [ni, 3, kb t] slots (1.61 GB at 1M, kb = 128; 3.22 GB at kb = 256) and
//   is folded after it; the i-partials are Kahan-added across bands in band
//   order.
//
// Inside a CTA: a team of t/128 warps holds the tile's t targets, 4 to a
// lane (strided by 32 so each warp load is one 128-byte row), and stages
// its j-tile in shared memory, each 32-source chunk stored twice, so that
// ring step s reads source lane + s of the chunk as one LDS.128 at an
// immediate offset (`ring`, the one ring of the file: every tri_kernel
// mode and pair_kernel). Only the three j-side sums travel, one lane down
// a step; after 32 steps each source's sums are back in its lane. The
// team's warps' column sums are then added in warp order in shared memory
// (named barrier per team). The ring's branches are warp-uniform, and
// __all_sync votes say so (the j-side choice, the static loop's skip), or
// the compiler keeps a divergent-shuffle copy of the loop.
// rsqrt.approx.ftz: d2 >= eps2 > 0 is never denormal, so it is the non-ftz
// rsqrtf bit for bit, without the guard (an FSETP and two predicated
// FMULs a pair). v5, v5s and v7 run S = min(8, 2048/t) teams a CTA (512
// threads at t = 256 and 512), within the 227 KB of shared memory a CTA
// may take (`teams_for`: one team at t = 1024), each on every S-th
// j-tile; their i-side tile sums go into Kahan-compensated running sums
// and the teams' totals are added in team order at the end. v6 runs one
// team a CTA.
//
// Tally per unique pair (bound on the H100: arithmetic; the inner loop
// reads nothing from device memory): one MUFU rsqrt per computed pair;
// FP32 (FADD/FMUL/FFMA) 15 on pairs that take both sides (3 subtractions,
// 4 for d2, 2 for s, 3 i-side and 3 j-side FFMA) and 12 on pairs that take
// the i-side only (the diagonal tile in "full"; every pair in "tri_only").
// Plus 0.75 SHFL a pair (3 a ring step of R = 4 pairs; none without a
// j-side) and 0.25 LDS (one LDS.128 a step).
// Fold bytes: v5 / v5s each slot written and read once, 3 floats a column
// of every pair j > i: 2 x 12 B x nt(nt-1)/2 x t (25.8 GB at 1M, t = 512);
// v7 the same; v6 the i-side slots too (12 B x t a pair: 51.6 GB at 1M).
// The slot fold (`fold_kernel`, v5 and v7) runs a thread a (component,
// column) and knows its row count up front, so it keeps FOLD_AHEAD slot
// loads in flight ahead of the dependent Kahan adds, which take the rows in
// increasing i as before: the same bits.
//
// wgmma, TMA and clusters are later work: this is the simple kernel.

#include <cuda_runtime.h>

namespace {

constexpr int R = 4;               // targets per lane
constexpr int WARP_T = 32 * R;     // targets per warp
constexpr int MAX_T = 1024;        // widest tile (shared memory)
constexpr int MAX_THREADS = 512;   // threads a CTA
constexpr int MAX_TEAMS = 8;       // named barriers 1 .. 8
constexpr int SMEM_LIMIT = 232448; // shared memory a CTA may take (227 KB)
constexpr int UNROLL = 8;          // ring steps a loop body
constexpr int FOLD_AHEAD = 16;     // slot loads in flight a fold thread
constexpr unsigned FULL = 0xffffffffu;

enum Mode { kFull = 0, kReduceOnly = 1, kTriOnly = 2 };

// s + x with Kahan compensation c (the true sum is s - c).
__device__ __forceinline__ void kahan_add(float& s, float& c, float x) {
  const float y = x - c;
  const float t = s + y;
  c = (t - s) - y;
  s = t;
}

// acc[k] += x with the Kahan compensation kept in comp[k].
__device__ __forceinline__ void kahan_add_global(float* acc, float* comp,
                                                 long long k, float x) {
  float s = acc[k], c = comp[k];
  kahan_add(s, c, x);
  acc[k] = s;
  comp[k] = c;
}

// Barrier of one team's `count` threads (id 0 is __syncthreads').
__device__ __forceinline__ void team_sync(int team, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(team + 1), "r"(count) : "memory");
}

// Shared memory of one team at tile width t: its staged j-tile (each
// 32-source chunk twice, float4) and its warps' column sums [t/128][3][t].
__host__ __device__ inline int team_smem(int t) {
  return 2 * t * (int)sizeof(float4) +
         (t / WARP_T) * 3 * t * (int)sizeof(float);
}

// Teams a CTA of v5 / v5s / v7 for tile width t: up to 512 threads and
// MAX_TEAMS, within SMEM_LIMIT (one team at t = 1024).
__host__ __device__ inline int teams_for(int t) {
  int s = 2048 / t;
  s = s > MAX_TEAMS ? MAX_TEAMS : s;
  const int fit = SMEM_LIMIT / team_smem(t);
  s = s > fit ? fit : s;
  return s < 1 ? 1 : s;
}

// rsqrt.approx.ftz: d2 >= eps2 > 0 is never denormal, so this is the
// non-ftz rsqrtf bit for bit, without its guard.
__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The team's targets of tile `ibase`: warp tw, lane, r -> tw*128 + r*32 + lane.
__device__ __forceinline__ void load_targets(const float* __restrict__ pos,
                                             long long n, long long ibase,
                                             int tw, int lane, float (&x)[R],
                                             float (&y)[R], float (&z)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long i = ibase + tw * WARP_T + r * 32 + lane;
    x[r] = pos[i];
    y[r] = pos[n + i];
    z[r] = pos[2 * n + i];
  }
}

// Thread k of `threads` stages its t / threads sources of the tile at
// jbase: source q of chunk c goes to src[64 c + q] and src[64 c + 32 + q].
__device__ __forceinline__ void stage_tile(const float* __restrict__ pos,
                                           long long n, int t,
                                           long long jbase, int k,
                                           int threads,
                                           float4* __restrict__ src) {
  for (int q = k; q < t; q += threads) {
    const long long j = jbase + q;
    const float4 p = make_float4(pos[j], pos[n + j], pos[2 * n + j], 0.f);
    const int at = (q >> 5) * 64 + (q & 31);
    src[at] = p;
    src[at + 32] = p;
  }
}

// One warp against a staged tile of t sources: the row sums of its R
// targets a lane into (ax, ay, az), set here; with kJ, the warp's negated
// column sums into jp[3][t] (x, y, z). Ring step s of chunk c: this lane
// meets source (lane + s) % 32 of the chunk, read from src[64 c + lane + s]
// as one LDS.128, and holds that source's j-side sums; only the sums move,
// one lane down a step, so after 32 steps each is back in its own lane.
template <bool kJ>
__device__ __forceinline__ void ring(const float4* __restrict__ src, int t,
                                     const float (&xi)[R],
                                     const float (&yi)[R],
                                     const float (&zi)[R], float (&ax)[R],
                                     float (&ay)[R], float (&az)[R],
                                     float eps2, float* __restrict__ jp,
                                     int lane) {
  const int next = (lane + 1) & 31;
#pragma unroll
  for (int r = 0; r < R; ++r) ax[r] = ay[r] = az[r] = 0.f;
  for (int c = 0; c < t / 32; ++c) {
    const float4* sp = src + c * 64 + lane;
    float jx = 0.f, jy = 0.f, jz = 0.f;
    for (int s0 = 0; s0 < 32; s0 += UNROLL) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const float4 p = sp[s0 + u];
#pragma unroll
        for (int r = 0; r < R; ++r) {
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
        if (kJ) {
          jx = __shfl_sync(FULL, jx, next);
          jy = __shfl_sync(FULL, jy, next);
          jz = __shfl_sync(FULL, jz, next);
        }
      }
    }
    if (kJ) {
      jp[c * 32 + lane] = jx;
      jp[t + c * 32 + lane] = jy;
      jp[2 * t + c * 32 + lane] = jz;
    }
  }
}

// v5 / v5s / v7: CTA b takes i-tile i_first + b and walks the j-tiles
// [j_lo, j_hi) from max(i, j_lo) (kStatic: all of them, skipping j < i),
// team `team` every teams-th one. The i-side is Kahan-added into
// (iacc, icomp) [3, n]. The j-side: kFull writes each pair j > i's negated
// column sums to slot + b*slot_row + d*slot_w + (j - slot_j0)*t;
// kReduceOnly writes the CTA's carry of colsum(tx)+colsum(ty)+colsum(tz)
// (negated) over its pairs j >= i to slot + b*slot_row. Shared memory:
// [teams][2t] float4 staged tiles, then [teams][t/128][3][t] column sums.
template <int kMode, bool kStatic>
__global__ void __launch_bounds__(MAX_THREADS)
tri_kernel(const float* __restrict__ pos, long long n, int t, int teams,
           int i_first, int j_lo, int j_hi, float* __restrict__ iacc,
           float* __restrict__ icomp, float* __restrict__ slot,
           long long slot_row, long long slot_w, int slot_j0, float eps2) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tw_n = t / WARP_T;  // warps a team
  const int team_threads = tw_n * 32;
  const int team = threadIdx.x / team_threads;
  const int lt = threadIdx.x - team * team_threads;  // thread in team
  const int tw = lt >> 5, lane = lt & 31;
  const int i = i_first + blockIdx.x;
  const long long ibase = (long long)i * t;
  float4* src = smem4 + (long long)team * 2 * t;
  float* jp = reinterpret_cast<float*>(smem4 + (long long)teams * 2 * t) +
              (long long)team * tw_n * 3 * t;

  float xi[R], yi[R], zi[R];
  load_targets(pos, n, ibase, tw, lane, xi, yi, zi);
  float sx[R], sy[R], sz[R], cx[R], cy[R], cz[R];  // Kahan running sums
  float carry[R];  // reduce_only: columns lt + q*team_threads
#pragma unroll
  for (int r = 0; r < R; ++r) {
    sx[r] = sy[r] = sz[r] = cx[r] = cy[r] = cz[r] = 0.f;
    carry[r] = 0.f;
  }

  const int first = (kStatic ? j_lo : (i > j_lo ? i : j_lo)) + team;
  for (int jj = first; jj < j_hi; jj += teams) {
    // the tests below are the same for the whole team: the votes tell the
    // compiler so, and it drops its divergent-shuffle copy of the ring
    if (kStatic && __all_sync(FULL, jj < i)) continue;
    team_sync(team, team_threads);  // the last tile and sums are consumed
    stage_tile(pos, n, t, (long long)jj * t, lt, team_threads, src);
    team_sync(team, team_threads);
    const bool jside = kMode == kReduceOnly ||
                       (kMode == kFull && __all_sync(FULL, jj > i));
    float ax[R], ay[R], az[R];
    if (jside) {
      ring<true>(src, t, xi, yi, zi, ax, ay, az, eps2, jp + tw * 3 * t, lane);
    } else {
      ring<false>(src, t, xi, yi, zi, ax, ay, az, eps2, jp, lane);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      kahan_add(sx[r], cx[r], ax[r]);
      kahan_add(sy[r], cy[r], ay[r]);
      kahan_add(sz[r], cz[r], az[r]);
    }
    if (jside) {
      team_sync(team, team_threads);
#pragma unroll
      for (int q = 0; q < R; ++q) {  // t / team_threads == R columns
        const int c = lt + q * team_threads;
        float vx = jp[c], vy = jp[t + c], vz = jp[2 * t + c];
        for (int w = 1; w < tw_n; ++w) {
          vx += jp[w * 3 * t + c];
          vy += jp[w * 3 * t + t + c];
          vz += jp[w * 3 * t + 2 * t + c];
        }
        if (kMode == kFull) {
          float* dst = slot + blockIdx.x * slot_row +
                       (long long)(jj - slot_j0) * t + c;
          dst[0] = vx;
          dst[slot_w] = vy;
          dst[2 * slot_w] = vz;
        } else {
          carry[q] += (vx + vy) + vz;
        }
      }
    }
  }

  // the teams' i-side totals, added in team order
  __syncthreads();
  float* part = smem;  // [teams][3][t]
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = tw * WARP_T + r * 32 + lane;
    part[(team * 3 + 0) * t + k] = sx[r] - cx[r];
    part[(team * 3 + 1) * t + k] = sy[r] - cy[r];
    part[(team * 3 + 2) * t + k] = sz[r] - cz[r];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < t; k += blockDim.x) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      float v = part[d * t + k];
      for (int s = 1; s < teams; ++s) v += part[(s * 3 + d) * t + k];
      kahan_add_global(iacc, icomp, d * n + ibase + k, v);
    }
  }
  if (kMode == kReduceOnly) {
    __syncthreads();
#pragma unroll
    for (int q = 0; q < R; ++q) part[team * t + lt + q * team_threads] = carry[q];
    __syncthreads();
    for (int k = threadIdx.x; k < t; k += blockDim.x) {
      float v = part[k];
      for (int s = 1; s < teams; ++s) v += part[s * t + k];
      slot[blockIdx.x * slot_row + k] = v;
    }
  }
}

// Fold `rows` slot rows into (jacc, jcomp): slot column c in [col_lo,
// col_hi) is global column g = col0 + c of tile b = g / t; rows r = 0, 1,
// ... (i-tile i_first + r) are Kahan-added in that order, with `triangle`
// only while i < b. Component d of row r is slot[r*slot_row + d*slot_w + c].
// One thread a (component, column): its row count is known up front, so
// FOLD_AHEAD loads are issued before the dependent adds take them in order.
__global__ void fold_kernel(const float* __restrict__ slot, int rows,
                            long long slot_row, long long slot_w, int ncomp,
                            long long col_lo, long long col_hi,
                            long long col0, int i_first, bool triangle,
                            int t, long long n, float* __restrict__ jacc,
                            float* __restrict__ jcomp) {
  const long long cols = col_hi - col_lo;
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= cols * ncomp) return;
  const int d = (int)(k / cols);
  const long long c = col_lo + (k - d * cols);
  const long long g = col0 + c;
  int nr = rows;
  if (triangle) {
    const long long lim = g / t - i_first;
    nr = lim < 0 ? 0 : (lim < rows ? (int)lim : rows);
  }
  const float* sp = slot + d * slot_w + c;
  float s = jacc[d * n + g], cmp = jcomp[d * n + g];
  for (int r0 = 0; r0 < nr; r0 += FOLD_AHEAD) {
    float v[FOLD_AHEAD];
#pragma unroll
    for (int u = 0; u < FOLD_AHEAD; ++u) {
      v[u] = r0 + u < nr ? __ldcs(sp + (long long)(r0 + u) * slot_row) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < FOLD_AHEAD; ++u) {
      if (r0 + u < nr) kahan_add(s, cmp, v[u]);
    }
  }
  jacc[d * n + g] = s;
  jcomp[d * n + g] = cmp;
}

// v6: entry k0 + blockIdx.x of the pair table, one team (t/4 threads). The
// i-side tile sums go to slot_i[b][3][t]; for j > i the negated column sums
// to slot_j[b][3][t]. Shared memory: the staged j-tile [2t] float4, then
// the warps' column sums [t/128][3][t].
__global__ void __launch_bounds__(MAX_T / 4)
pair_kernel(const float* __restrict__ pos, long long n, int t,
            const int* __restrict__ iofk, const int* __restrict__ jofk,
            long long k0, float* __restrict__ slot_i,
            float* __restrict__ slot_j, float eps2) {
  extern __shared__ float4 smem4[];
  float4* src = smem4;
  float* jp = reinterpret_cast<float*>(smem4 + 2 * t);
  const long long k = k0 + blockIdx.x;
  const int i = iofk[k], j = jofk[k];
  const int tw_n = t / WARP_T;
  const int tw = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float xi[R], yi[R], zi[R], ax[R], ay[R], az[R];
  load_targets(pos, n, (long long)i * t, tw, lane, xi, yi, zi);
  stage_tile(pos, n, t, (long long)j * t, threadIdx.x, blockDim.x, src);
  __syncthreads();
  if (__all_sync(FULL, j > i)) {
    ring<true>(src, t, xi, yi, zi, ax, ay, az, eps2, jp + tw * 3 * t, lane);
  } else {
    ring<false>(src, t, xi, yi, zi, ax, ay, az, eps2, jp, lane);
  }
  float* si = slot_i + (long long)blockIdx.x * 3 * t;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int q = tw * WARP_T + r * 32 + lane;
    si[q] = ax[r];
    si[t + q] = ay[r];
    si[2 * t + q] = az[r];
  }
  if (j > i) {
    __syncthreads();
    float* sj = slot_j + (long long)blockIdx.x * 3 * t;
    for (int c = threadIdx.x; c < t; c += blockDim.x) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        float v = jp[d * t + c];
        for (int w = 1; w < tw_n; ++w) v += jp[(w * 3 + d) * t + c];
        sj[d * t + c] = v;
      }
    }
  }
}

// First entry of i-tile row a in the i-major table of nt tiles.
__host__ __device__ inline long long row_start(long long a, long long nt) {
  return a * nt - a * (a - 1) / 2;
}

// v6: fold the entries [k0, k1) (i-tiles i_lo .. i_hi) in table order. For
// global column g of tile a: the i-side slots of entries (a, j), then the
// j-side slots of entries (i, a), i < a, each Kahan-added.
__global__ void pair_fold_kernel(const float* __restrict__ slot_i,
                                 const float* __restrict__ slot_j,
                                 long long k0, long long k1, int i_lo,
                                 int i_hi, int nt, int t, long long n,
                                 float* __restrict__ planes) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  const int a = (int)(g / t);
  const int c = (int)(g - (long long)a * t);
  float* iacc = planes;
  float* icomp = planes + 3 * n;
  float* jacc = planes + 6 * n;
  float* jcomp = planes + 9 * n;
  if (a >= i_lo && a <= i_hi) {
    long long kb = row_start(a, nt), ke = row_start(a + 1, nt);
    kb = kb > k0 ? kb : k0;
    ke = ke < k1 ? ke : k1;
    for (int d = 0; d < 3; ++d) {
      float s = iacc[d * n + g], cmp = icomp[d * n + g];
      for (long long k = kb; k < ke; ++k) {
        kahan_add(s, cmp, slot_i[((k - k0) * 3 + d) * t + c]);
      }
      iacc[d * n + g] = s;
      icomp[d * n + g] = cmp;
    }
  }
  const int last = i_hi < a - 1 ? i_hi : a - 1;
  if (i_lo > last) return;
  float s[3], cmp[3];
  for (int d = 0; d < 3; ++d) {
    s[d] = jacc[d * n + g];
    cmp[d] = jcomp[d * n + g];
  }
  for (int i = i_lo; i <= last; ++i) {
    const long long k = row_start(i, nt) + (a - i);
    if (k < k0 || k >= k1) continue;
    for (int d = 0; d < 3; ++d) {
      kahan_add(s[d], cmp[d], slot_j[((k - k0) * 3 + d) * t + c]);
    }
  }
  for (int d = 0; d < 3; ++d) {
    jacc[d * n + g] = s[d];
    jcomp[d * n + g] = cmp[d];
  }
}

// out[0:3] = ((iacc - icomp) + (jacc - jcomp)) * mass; out[3] = |out[0:3]|.
__global__ void finish_kernel(const float* __restrict__ planes, long long n,
                              float* __restrict__ out, float mass) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < n;
       g += stride) {
    float a[3];
    for (int d = 0; d < 3; ++d) {
      const float iv = planes[d * n + g] - planes[(3 + d) * n + g];
      const float jv = planes[(6 + d) * n + g] - planes[(9 + d) * n + g];
      a[d] = (iv + jv) * mass;
      out[d * n + g] = a[d];
    }
    out[3 * n + g] = sqrtf(a[0] * a[0] + a[1] * a[1] + a[2] * a[2]);
  }
}

int finish(const float* planes, long long n, float* out, float mass,
           cudaStream_t st) {
  long long blocks = (n + 255) / 256;
  if (blocks > 132LL * 16) blocks = 132LL * 16;
  finish_kernel<<<(unsigned)blocks, 256, 0, st>>>(planes, n, out, mass);
  return static_cast<int>(cudaGetLastError());
}

int fold(const float* slot, int rows, long long slot_row, long long slot_w,
         int ncomp, long long col_lo, long long col_hi, long long col0,
         int i_first, bool triangle, int t, long long n, float* planes,
         cudaStream_t st) {
  if (col_hi <= col_lo || rows <= 0) return 0;
  const long long blocks = ((col_hi - col_lo) * ncomp + 255) / 256;
  fold_kernel<<<(unsigned)blocks, 256, 0, st>>>(
      slot, rows, slot_row, slot_w, ncomp, col_lo, col_hi, col0, i_first,
      triangle, t, n, planes + 6 * n, planes + 9 * n);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode, bool kStatic>
int launch_tri(const float* pos, long long n, int t, int ctas, int i_first,
               int j_lo, int j_hi, float* planes, float* slot,
               long long slot_row, long long slot_w, int slot_j0, float eps2,
               cudaStream_t st) {
  const int teams = teams_for(t);
  const int threads = teams * t / R;
  const size_t smem = (size_t)teams * team_smem(t);
  cudaError_t err = cudaFuncSetAttribute(
      tri_kernel<kMode, kStatic>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tri_kernel<kMode, kStatic><<<ctas, threads, smem, st>>>(
      pos, n, t, teams, i_first, j_lo, j_hi, planes, planes + 3 * n, slot,
      slot_row, slot_w, slot_j0, eps2);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(long long n, int t) {
  return t <= 0 || t % WARP_T != 0 || t > MAX_T || n <= 0 || n % t != 0;
}

}  // namespace

// The targets of a warp (t must be a multiple) and the widest tile.
extern "C" int aph_tile() { return WARP_T; }
extern "C" int aph_max_tile() { return MAX_T; }
// Teams a tri_kernel CTA, and the shared-memory bytes a tri_kernel
// (kernel 0) or pair_kernel (1) launch asks for at tile width t.
extern "C" int aph_teams(int t) { return teams_for(t); }
extern "C" int aph_smem(int kernel, int t) {
  return kernel == 0 ? teams_for(t) * team_smem(t) : team_smem(t);
}

// All entry points: pos [4, n] float32 -> out [4, n]; planes [4, 3, n]
// scratch (i-side sum and compensation, j-side sum and compensation); the
// slots as the wrapper sizes them; all contiguous on the current device.
// Return the first cudaError_t of the launches.

// v5 (is_static 0) and v5s (1): chunks of `chunk` i-tiles; slot [chunk,
// 3n] (full), [chunk, t] (reduce_only) or unused (tri_only).
extern "C" int aph_v5(const void* pos, long long n, int t, int mode,
                      int is_static, int chunk, void* planes, void* slot,
                      void* out, float mass, float eps2, void* stream) {
  if (bad_shape(n, t) || mode < 0 || mode > 2 || chunk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pos);
  float* pl = static_cast<float*>(planes);
  float* sl = static_cast<float*>(slot);
  const int nt = (int)(n / t);
  cudaError_t e = cudaMemsetAsync(pl, 0, 12 * n * sizeof(float), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int ib = 0; ib < nt; ib += chunk) {
    const int rows = nt - ib < chunk ? nt - ib : chunk;
    int rc;
    if (mode == kFull) {
      rc = is_static
               ? launch_tri<kFull, true>(p, n, t, rows, ib, 0, nt, pl, sl,
                                         3 * n, n, 0, eps2, st)
               : launch_tri<kFull, false>(p, n, t, rows, ib, 0, nt, pl, sl,
                                          3 * n, n, 0, eps2, st);
      if (rc == 0) {
        rc = fold(sl, rows, 3 * n, n, 3, (long long)(ib + 1) * t, n, 0, ib,
                  true, t, n, pl, st);
      }
    } else if (mode == kReduceOnly) {
      rc = launch_tri<kReduceOnly, false>(p, n, t, rows, ib, 0, nt, pl, sl,
                                          t, t, 0, eps2, st);
      if (rc == 0) {
        rc = fold(sl, rows, t, t, 1, 0, t, 0, ib, false, t, n, pl, st);
      }
    } else {
      rc = launch_tri<kTriOnly, false>(p, n, t, rows, ib, 0, nt, pl, sl, 0,
                                       0, 0, eps2, st);
    }
    if (rc != 0) return rc;
  }
  return finish(pl, n, static_cast<float*>(out), mass, st);
}

// v6: the pair table iofk, jofk [K] (i-major), launches of `entries`;
// slot_i, slot_j [entries, 3, t].
extern "C" int aph_v6(const void* pos, long long n, int t, const void* iofk,
                      const void* jofk, long long num_pairs,
                      long long entries, void* planes, void* slot_i,
                      void* slot_j, void* out, float mass, float eps2,
                      void* stream) {
  if (bad_shape(n, t) || entries < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nt = n / t;
  if (num_pairs != nt * (nt + 1) / 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* pl = static_cast<float*>(planes);
  float* si = static_cast<float*>(slot_i);
  float* sj = static_cast<float*>(slot_j);
  const size_t smem = (size_t)team_smem(t);
  cudaError_t e = cudaFuncSetAttribute(
      pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaMemsetAsync(pl, 0, 12 * n * sizeof(float), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  long long i_lo = 0;  // the i-tile of entry k0
  for (long long k0 = 0; k0 < num_pairs; k0 += entries) {
    const long long k1 =
        k0 + entries < num_pairs ? k0 + entries : num_pairs;
    while (row_start(i_lo + 1, nt) <= k0) ++i_lo;
    long long i_hi = i_lo;  // the i-tile of entry k1 - 1
    while (row_start(i_hi + 1, nt) <= k1 - 1) ++i_hi;
    pair_kernel<<<(unsigned)(k1 - k0), t / R, smem, st>>>(
        static_cast<const float*>(pos), n, t, static_cast<const int*>(iofk),
        static_cast<const int*>(jofk), k0, si, sj, eps2);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    pair_fold_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        si, sj, k0, k1, (int)i_lo, (int)i_hi, (int)nt, t, n, pl);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return finish(pl, n, static_cast<float*>(out), mass, st);
}

// v7: bands of kb j-tiles; slot [nt, 3, kb*t].
extern "C" int aph_v7(const void* pos, long long n, int t, int kb,
                      void* planes, void* slot, void* out, float mass,
                      float eps2, void* stream) {
  if (bad_shape(n, t) || kb < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pos);
  float* pl = static_cast<float*>(planes);
  float* sl = static_cast<float*>(slot);
  const int nt = (int)(n / t);
  const long long w = (long long)kb * t;  // slot width
  cudaError_t e = cudaMemsetAsync(pl, 0, 12 * n * sizeof(float), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int j0 = 0; j0 < nt; j0 += kb) {
    const int kbb = nt - j0 < kb ? nt - j0 : kb;
    const int ni = j0 + kbb;  // i-tiles that meet the band
    int rc = launch_tri<kFull, true>(p, n, t, ni, 0, j0, j0 + kbb, pl, sl,
                                     3 * w, w, j0, eps2, st);
    if (rc == 0) {
      rc = fold(sl, ni, 3 * w, w, 3, 0, (long long)kbb * t,
                (long long)j0 * t, 0, true, t, n, pl, st);
    }
    if (rc != 0) return rc;
  }
  return finish(pl, n, static_cast<float*>(out), mass, st);
}
