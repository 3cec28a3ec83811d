// Tree-P3M near field: the directed block-pair sweep (force, and the three
// potential variants of the diagnostics gauge) and the Newton-3rd halved
// force sweep.
//
// Replaces two TPU kernels of `multi_adapter_particles_tpu/ops/treeforce.py`:
// `_sweep_kernel` (launcher `_near_sweep_pallas`: the force variant and its
// `with_potential`, `potential_only` and `half_pairs` variants) and
// `_sweep_kernel_n3` (launcher `_near_sweep_pallas_n3`).
//
// Inputs: spos [4, nb*B] float32, the Morton-sorted positions (x, y, z rows;
// the fourth row is not read; dead lanes are parked at 1e9) in nb blocks of
// B consecutive particles, and a block-pair list. For every listed (target
// block i, source block j) and every target t of i and source s of j:
//   d = p_s - p_t, d2 = |d|^2,  a_t += d * s_short(d2)
// with s_short the JAX package's `short_factor_cheb`:
//   inv = rsqrt(d2 + eps2), s_exact = inv^3, v = d2 / sigma^2,
//   x = min(v * 2/VMAX - 1, 1), h = Horner(x) of degree 12,
//   s = s_exact - h / sigma^3, and 0 where v > VMAX (past the cutoff).
// (The JAX function also clamps x below at -1; v >= 0 makes that a no-op.)
// The potential variants add, in the fourth output row,
//   u_t += u_short(d2),  u_short = -inv + E(x) / sigma, 0 past the cutoff,
// the JAX package's `short_potential_cheb` (E: the degree-12 fit of
// erf(t/sqrt 2)/t). The 13 Horner coefficients of each polynomial arrive
// as kernel arguments (`Poly`, read from the constant bank), not retyped
// here. Output [4, nb*B] (ax, ay, az, u), unscaled, still in sorted order;
// a row a variant does not compute is 0. Parked lanes contribute no force:
// their d2 is past the cutoff. u_short(0) is not 0, so each live target
// picks up its own self pair once (co-parked dead lanes pick it up from
// each other); the caller subtracts the constant `tree_potential_at`
// evaluates with the same device function, and zeroes dead lanes.
//
// Bound on the H100: arithmetic, the FP32 issue slot. FADD/FMUL/FFMA a
// pair, as the SASS of the loops has them (tools/sass.py; chip_smoke phase
// 2 holds them there):
//   force (directed):  27 = 3 FADD for d, 1 FMUL + 2 FFMA for d2, 1 FADD
//     for +eps2, 2 FMUL for inv^3, 1 FMUL for v, 1 FFMA for x, 12 FFMA of
//     Horner, 1 FFMA for s, 3 FFMA into the sums;
//   force + potential: 41 = those 27, then 12 FFMA of the second Horner
//     chain over the same x, 1 FFMA for u (-inv is a negated operand),
//     1 FADD into the sum;
//   potential only (directed or halved): 23 = the 9 before the force's
//     inv^3 (d, d2, +eps2, v, x), 12 FFMA of Horner, 1 FFMA for u, 1 FADD;
//   halved force, a pair j > i: 30 = the 24 before the sums, then 3 FFMA
//     to the i-side and 3 to the j-side (d * s is not formed on its own);
//     a diagonal pair (j == i), i-side only: 27.
// Besides those, each pair takes one MUFU rsqrt, a min, a compare and a
// select; the directed loop one LDS.128 a source for its R = 2 targets,
// the halved j-side loop one LDS.128 and 3 SHFL a ring step of R = 8
// pairs. At B = 512 the loops take 32.0 (force), 47.25 (force +
// potential), 27.875 (potential) and 34.78 / 31.28 (halved, j > i /
// diagonal) issue slots a pair. The listed pairs' positions come from
// device memory once per (pair, block), 12 B a source, so bytes never
// bound it.
//
// The schedule: balanced work items. The i-major list is cut into items of
// at most kItemLen (L = 16) consecutive listed source blocks of one target
// block's segment; the wrapper builds the item table on the device from
// the segment bounds (`sweep_items`: target block, list range, and the
// launch order, longest items first), its size the static nb +
// ceil(list length / L), so that the host never waits for the count. One
// CTA an item: it sums its targets over its source blocks and writes the
// sums to a slot of its own; a fold kernel then adds each target's slots
// in item (list) order. Dense cluster blocks list up to 13-18x the mean
// segment (712 source blocks at 1M directed, 56 on average): with one CTA
// a target block, that CTA ran alone on its SM for most of the call; an
// item takes at most L. Items run `chunk` at a time, each chunk's slots folded
// before the next (one chunk unless the slots would pass the wrapper's
// scratch bytes), the fold continuing each target's sum where the last
// chunk left it: the result is the same bits whatever the chunking. Item
// slots past the table's live count (padding) exit at once.
//
// Directed sweep (tree_sweep): an item's CTA holds its B targets, R = 2 a
// thread (one LDS.128 of a source feeds two pairs), and streams each listed
// source block's x, y, z through shared memory as float4 (double-buffered
// with cp.async: the copy of the next source block overlaps the pair math
// of this one; one barrier a source block). Each source block's sums are
// kept apart in registers (lane order), then added to the item's sums in
// list order. One template, `sweep_item_kernel<kForce, kPot, kHalf, R>`,
// makes the four variants; the force code is the same source in every
// instance and the items and the fold are the same, so the fused
// variant's force rows are the force-only kernel's bit for bit, and its
// potential row the potential-only kernel's. `kHalf` sweeps the Newton-3rd
// halved list (j >= i) of the potential gauge: a source block equal to the
// target block (a diagonal pair, whose plane holds both orders of its
// pairs and the self pairs) adds its sum weighted 1/2; the item's CTA sees
// that from its own list entry, the same for the whole CTA.
//
// Halved force sweep (tree_sweep_n3). The TPU kernel carries the j-side
// sums in VMEM across its sequential grid; Hopper blocks run in no order,
// so, besides the item slots of the i-side:
//   1. An item's CTA computes each listed pair's plane once: lane sums to
//      the i-side, and for j > i the negated column sums to a scratch row
//      [3, B] of the pair's list position. 8 warps: a warp holds 32 x R
//      targets (R = 8 at B >= 256, targets strided by 32 so warp loads are
//      128-byte rows) and takes a share of the source block's 32-source
//      chunks; each chunk sits twice in shared memory, so that ring step s
//      reads the source at lane + s as one LDS.128 at an immediate offset,
//      and only the three j-side sums move, one lane a step (after 32
//      steps each source's sums are back in its own lane). The warps'
//      column sums of a pair are added in warp order through shared memory
//      into its row; each warp adds its i-side sums of a pair into its own
//      shared-memory partial, and the item's slot is the partials added in
//      warp order. Diagonal pairs (j == i) take the i-side only (a ring
//      without sums to move): their dense plane holds both in-block
//      orders. The ring's branches are warp-uniform; __all_sync votes tell
//      the compiler so, which drops its divergent-shuffle fallback.
//   2. Each target's i-side slots folded in item order (the fold above).
//   3. The j-fold: for each source block j, its scratch rows in the order
//      of a j-major index (a stable sort of the halved list by j, built by
//      the wrapper), summed from 0, then the i-side sum of 2 added.
// No float atomics anywhere: every sum has a fixed order, so both sweeps
// are bitwise the same from run to run.
//
// rsqrt.approx.ftz (inline PTX) in place of rsqrtf: d2 + eps2 >= eps2 > 0
// is never denormal, so its result is rsqrtf's bit for bit, without the
// denormal guard (an FSETP and two predicated FMULs a pair).

#include <cuda_runtime.h>

namespace {

constexpr int kPolyTerms = 13;
constexpr int kMaxBlock = 512;     // widest block either sweep takes
constexpr int kItemLen = 16;       // listed source blocks an item takes (L)
constexpr int kDirThreads = 256;   // threads of a directed CTA (B / R)
constexpr int kN3Warps = 8;        // warps of a halved CTA (fewer at B < 256)
constexpr int kRingUnroll = 4;     // ring steps a loop body
constexpr int kFoldThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

struct Poly {
  float c[kPolyTerms];  // Horner coefficients, c[0] the constant term
};

struct Consts {
  float eps2, inv_s2, two_over_vmax, inv_s3, vmax, inv_s;
};

__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float short_factor(float d2, const Poly& p,
                                              const Consts& k) {
  const float inv = rsqrt_ftz(d2 + k.eps2);
  const float s_exact = inv * inv * inv;
  const float v = d2 * k.inv_s2;
  const float x = fminf(v * k.two_over_vmax - 1.0f, 1.0f);
  float h = p.c[kPolyTerms - 1];
#pragma unroll
  for (int m = kPolyTerms - 2; m >= 0; --m) h = h * x + p.c[m];
  const float s = s_exact - h * k.inv_s3;
  return v <= k.vmax ? s : 0.0f;
}

// The short-range pair potential: inv, v and x are the force's expressions,
// so a kernel computing both evaluates them once.
__device__ __forceinline__ float short_potential(float d2, const Poly& e,
                                                 const Consts& k) {
  const float inv = rsqrt_ftz(d2 + k.eps2);
  const float v = d2 * k.inv_s2;
  const float x = fminf(v * k.two_over_vmax - 1.0f, 1.0f);
  float h = e.c[kPolyTerms - 1];
#pragma unroll
  for (int m = kPolyTerms - 2; m >= 0; --m) h = h * x + e.c[m];
  const float u = h * k.inv_s - inv;
  return v <= k.vmax ? u : 0.0f;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Threads t, t + stride, ... of the CTA copy source block j's x, y, z
// into tile (float4; w is never read): source m at tile[m], or, `twice`,
// chunk c = m / 32 at tile[64 c, 64 c + 64), its 32 sources twice.
template <bool kTwice>
__device__ __forceinline__ void load_tile(float4* tile,
                                          const float* __restrict__ spos,
                                          long long nbB, int j, int B, int t,
                                          int stride) {
  for (int m = t; m < B; m += stride) {
    const long long g = (long long)j * B + m;
    const int at = kTwice ? (m >> 5) * 64 + (m & 31) : m;
#pragma unroll
    for (int copy = 0; copy < (kTwice ? 2 : 1); ++copy) {
      float* dst = reinterpret_cast<float*>(tile + at + 32 * copy);
      cp_async4(dst, spos + g);
      cp_async4(dst + 1, spos + nbB + g);
      cp_async4(dst + 2, spos + 2 * nbB + g);
    }
  }
}

// The item table (int32 [4][kall], from the wrapper): row 0 the target
// block (nb on padding items), rows 1-2 the list range [q0, q1), row 3 the
// launch order (the table index of launch position b).
struct Item {
  long long k;  // table index
  int i, q0, q1;
};

__device__ __forceinline__ Item item_at(const int* __restrict__ items,
                                        long long kall, long long b) {
  Item it;
  it.k = items[3 * kall + b];
  it.i = items[it.k];
  it.q0 = items[kall + it.k];
  it.q1 = items[2 * kall + it.k];
  return it;
}

// Directed sweep: one CTA an item of the chunk starting at table index k0;
// thread t holds targets t, t + T, ... (R of them, B = T * R). Writes the
// item's sums to slot[k - k0] = [rows][B]: ax, ay, az (kForce), u (kPot).
template <bool kForce, bool kPot, bool kHalf, int R>
__global__ void __launch_bounds__(kDirThreads)
sweep_item_kernel(const float* __restrict__ spos, long long nbB, int nb,
                  const int* __restrict__ items, long long kall,
                  long long k0, const int* __restrict__ jidx,
                  float* __restrict__ slot, Poly poly, Poly epoly,
                  Consts k) {
  extern __shared__ float4 tiles[];  // [2][B]
  const int T = blockDim.x, B = T * R;
  const Item it = item_at(items, kall, k0 + blockIdx.x);
  if (it.i >= nb) return;  // padding past the table's live items
  const int i = it.i, t = threadIdx.x;
  const long long base = (long long)i * B;
  float xi[R], yi[R], zi[R], ax[R], ay[R], az[R], au[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long g = base + r * T + t;
    xi[r] = spos[g];
    yi[r] = spos[nbB + g];
    zi[r] = spos[2 * nbB + g];
    ax[r] = ay[r] = az[r] = au[r] = 0.f;
  }
  load_tile<false>(tiles, spos, nbB, jidx[it.q0], B, t, T);
  cp_async_commit();
  for (int q = it.q0; q < it.q1; ++q) {
    const int buf = (q - it.q0) & 1;
    const int j = jidx[q];
    cp_async_wait_all();
    __syncthreads();  // tile q is in; every thread is done with q - 1's
    if (q + 1 < it.q1) {
      load_tile<false>(tiles + (buf ^ 1) * B, spos, nbB, jidx[q + 1], B, t,
                       T);
      cp_async_commit();
    }
    const float4* tl = tiles + buf * B;
    float tx[R], ty[R], tz[R], tu[R];  // this source block's
#pragma unroll
    for (int r = 0; r < R; ++r) tx[r] = ty[r] = tz[r] = tu[r] = 0.f;
#pragma unroll 8
    for (int m = 0; m < B; ++m) {
      const float4 p = tl[m];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float dx = p.x - xi[r];
        const float dy = p.y - yi[r];
        const float dz = p.z - zi[r];
        const float d2 = dx * dx + dy * dy + dz * dz;
        if constexpr (kForce) {
          const float f = short_factor(d2, poly, k);
          tx[r] += dx * f;
          ty[r] += dy * f;
          tz[r] += dz * f;
        }
        if constexpr (kPot) tu[r] += short_potential(d2, epoly, k);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if constexpr (kForce) {
        ax[r] += tx[r];
        ay[r] += ty[r];
        az[r] += tz[r];
      }
      if constexpr (kPot) {
        if constexpr (kHalf) {
          if (j == i) tu[r] *= 0.5f;  // the same for the whole CTA
        }
        au[r] += tu[r];
      }
    }
  }
  constexpr int kRows = (kForce ? 3 : 0) + (kPot ? 1 : 0);
  float* sl = slot + (it.k - k0) * kRows * B;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int c = r * T + t;
    if constexpr (kForce) {
      sl[c] = ax[r];
      sl[B + c] = ay[r];
      sl[2 * B + c] = az[r];
    }
    if constexpr (kPot) sl[(kForce ? 3 : 0) * B + c] = au[r];
  }
}

// u_short(d2[0]) -> out[0]: the self-pair constant, by the sweep's own
// device function (d2 is read from memory so nothing folds it).
__global__ void potential_at_kernel(const float* __restrict__ d2,
                                    float* __restrict__ out, Poly epoly,
                                    Consts k) {
  out[0] = short_potential(d2[0], epoly, k);
}

// One warp of the halved sweep against one staged source block, chunks
// [c0, c0 + CPW): the row sums of its R targets a lane into (px, py, pz), set
// here; with kJ, its negated column sums into jp[3][B] at those chunks.
// `src` holds chunk c at [64 c, 64 c + 64): its 32 sources, twice.
template <bool kJ, int R, int CPW>
__device__ __forceinline__ void n3_ring(
    const float4* __restrict__ src, int c0, float* __restrict__ jp,
    int B, const float (&xi)[R], const float (&yi)[R], const float (&zi)[R],
    float (&px)[R], float (&py)[R], float (&pz)[R], const Poly& poly,
    const Consts& k, int lane) {
  const int next = (lane + 1) & 31;
#pragma unroll
  for (int r = 0; r < R; ++r) px[r] = py[r] = pz[r] = 0.f;
  for (int cc = 0; cc < CPW; ++cc) {
    const int c = c0 + cc;
    // step s: this lane meets source (lane + s) % 32 and holds its sums
    const float4* sp = src + c * 64 + lane;
    float jx = 0.f, jy = 0.f, jz = 0.f;
    for (int s0 = 0; s0 < 32; s0 += kRingUnroll) {
#pragma unroll
      for (int u = 0; u < kRingUnroll; ++u) {
        const float4 p = sp[s0 + u];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float dx = p.x - xi[r];
          const float dy = p.y - yi[r];
          const float dz = p.z - zi[r];
          const float f = short_factor(dx * dx + dy * dy + dz * dz, poly, k);
          px[r] += dx * f;
          py[r] += dy * f;
          pz[r] += dz * f;
          if (kJ) {
            jx -= dx * f;
            jy -= dy * f;
            jz -= dz * f;
          }
        }
        if (kJ) {  // the sums move on with their source, one lane down
          jx = __shfl_sync(kFull, jx, next);
          jy = __shfl_sync(kFull, jy, next);
          jz = __shfl_sync(kFull, jz, next);
        }
      }
    }
    if (kJ) {  // 32 moves later each source's sums are in its own lane
      jp[c * 32 + lane] = jx;
      jp[B + c * 32 + lane] = jy;
      jp[2 * B + c * 32 + lane] = jz;
    }
  }
}

// The halved CTA's shape at block B: R targets a lane, TG warps of targets
// (each 32 R of them), SG warps sharing the source chunks (CPW each).
struct N3Shape {
  int R, TG, SG, CPW, warps;
  size_t smem;  // the staged tiles (twice each chunk, double-buffered),
                // the warps' column sums, the warps' i-side partials
};

__host__ __device__ inline N3Shape n3_shape(int B) {
  N3Shape s;
  s.R = B >= 256 ? 8 : B / 32;
  s.TG = B / (32 * s.R);
  s.SG = (B / 32) < (kN3Warps / s.TG) ? (B / 32) : (kN3Warps / s.TG);
  s.CPW = B / 32 / s.SG;
  s.warps = s.TG * s.SG;
  s.smem = (size_t)4 * B * sizeof(float4) + (size_t)s.TG * 3 * B * 4 +
           (size_t)s.SG * 3 * B * 4;
  return s;
}

// Halved sweep, pass 1: one CTA an item. Warp w holds target group
// tg = w % TG (target tg*32*R + r*32 + lane) and source chunks
// [sg * CPW, (sg + 1) * CPW), sg = w / TG. Writes rows[q] (the j-side,
// j > i) for each of its list positions and islot[k - k0] = [3][B] (the
// i-side). Every branch and loop around the ring is warp-uniform; the
// ones the compiler cannot see as such go through votes, or it keeps a
// divergent-shuffle fallback copy of the ring.
template <int R, int CPW>
__global__ void __launch_bounds__(kN3Warps * 32, 2)
sweep_n3_item_kernel(const float* __restrict__ spos, long long nbB, int nb,
                     int B, const int* __restrict__ items, long long kall,
                     long long k0, const int* __restrict__ jidx,
                     float* __restrict__ islot, float* __restrict__ rows,
                     Poly poly, Consts k) {
  extern __shared__ float4 smem[];
  const int TG = B / (32 * R), SG = (blockDim.x >> 5) / TG;
  float4* src = smem;                                      // [2][2B]
  float* jpart = reinterpret_cast<float*>(smem + 4 * B);   // [TG][3][B]
  float* isum = jpart + TG * 3 * B;                        // [SG][3][B]
  const Item it = item_at(items, kall, k0 + blockIdx.x);
  if (__all_sync(kFull, it.i >= nb)) return;  // padding past the live items
  const int i = it.i;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tg = warp % TG, sg = warp / TG;
  const long long base = (long long)i * B;
  float xi[R], yi[R], zi[R];
  float* mine = isum + sg * 3 * B + tg * 32 * R + lane;  // this warp's own
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long g = base + tg * 32 * R + r * 32 + lane;
    xi[r] = spos[g];
    yi[r] = spos[nbB + g];
    zi[r] = spos[2 * nbB + g];
    mine[r * 32] = mine[B + r * 32] = mine[2 * B + r * 32] = 0.f;
  }
  load_tile<true>(src, spos, nbB, jidx[it.q0], B, threadIdx.x, blockDim.x);
  cp_async_commit();
  for (int q = it.q0; __all_sync(kFull, q < it.q1); ++q) {
    const int buf = (q - it.q0) & 1;
    const int j = jidx[q];
    cp_async_wait_all();
    __syncthreads();  // tile q is in; q - 1's tile and rows are done
    if (q + 1 < it.q1) {
      load_tile<true>(src + (buf ^ 1) * 2 * B, spos, nbB, jidx[q + 1], B,
                      threadIdx.x, blockDim.x);
      cp_async_commit();
    }
    const float4* tl = src + buf * 2 * B;
    float px[R], py[R], pz[R];
    // j != i is the same for the whole CTA: the vote tells the compiler
    if (__all_sync(kFull, j != i)) {
      n3_ring<true, R, CPW>(tl, sg * CPW, jpart + tg * 3 * B, B, xi, yi,
                            zi, px, py, pz, poly, k, lane);
    } else {
      n3_ring<false, R, CPW>(tl, sg * CPW, jpart, B, xi, yi, zi, px, py,
                             pz, poly, k, lane);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      mine[r * 32] += px[r];
      mine[B + r * 32] += py[r];
      mine[2 * B + r * 32] += pz[r];
    }
    __syncthreads();  // the warps' column sums are in
    if (j != i) {
      float* row = rows + (long long)q * 3 * B;
      for (int m = threadIdx.x; m < 3 * B; m += blockDim.x) {
        float v = jpart[m];
        for (int w = 1; w < TG; ++w) v += jpart[w * 3 * B + m];
        row[m] = v;
      }
    }
  }
  __syncthreads();
  float* sl = islot + (it.k - k0) * 3 * B;
  for (int m = threadIdx.x; m < 3 * B; m += blockDim.x) {
    float v = isum[m];
    for (int w = 1; w < SG; ++w) v += isum[w * 3 * B + m];
    sl[m] = v;
  }
}

// Column g of out (target block i = g / B): rows row0 .. row0 + nrows - 1
// add the slots of i's items in [k0, k1) in table order, continuing the
// sum out holds (from 0 when `first`, which also zeroes the other rows).
// istart [nb+1]: the first table index of each target block's items.
__global__ void __launch_bounds__(kFoldThreads)
item_fold_kernel(float* __restrict__ out, long long nbB, int B,
                 const float* __restrict__ slot, int nrows, int row0,
                 const int* __restrict__ istart, long long k0, long long k1,
                 int first) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= nbB) return;
  const int i = (int)(g / B), c = (int)(g - (long long)i * B);
  const long long ks = max((long long)istart[i], k0);
  const long long ke = min((long long)istart[i + 1], k1);
  for (int d = 0; d < 4; ++d) {
    float* o = out + d * nbB + g;
    if (d < row0 || d >= row0 + nrows) {
      if (first) *o = 0.f;
      continue;
    }
    float acc = first ? 0.f : *o;
    for (long long kx = ks; kx < ke; ++kx) {
      acc += slot[((kx - k0) * nrows + (d - row0)) * B + c];
    }
    *o = acc;
  }
}

// Halved sweep, the j-fold: block j (B threads) adds its scratch rows
// jorder[jbounds[j] .. jbounds[j+1]) in that order, then the i-side sum in
// `out`.
__global__ void __launch_bounds__(kMaxBlock)
sweep_n3_fold_kernel(float* __restrict__ out, long long nbB, int B,
                     const float* __restrict__ rows,
                     const int* __restrict__ jorder,
                     const int* __restrict__ jbounds) {
  const int j = blockIdx.x;
  const int s = jbounds[j], e = jbounds[j + 1];
  const int m = threadIdx.x;
  float acc[3] = {0.f, 0.f, 0.f};
  for (int q = s; q < e; ++q) {
    const float* row = rows + (long long)jorder[q] * 3 * B;
#pragma unroll
    for (int d = 0; d < 3; ++d) acc[d] += row[d * B + m];
  }
  const long long g = (long long)j * B + m;
#pragma unroll
  for (int d = 0; d < 3; ++d) out[d * nbB + g] = acc[d] + out[d * nbB + g];
}

bool bad_block(int B) { return B < 32 || B > kMaxBlock || B % 32 != 0; }

Poly make_poly(const float* coef) {
  Poly p;
  for (int m = 0; m < kPolyTerms; ++m) p.c[m] = coef[m];
  return p;
}

// The directed variant's item kernel at block B, its threads and shared
// memory; rows and the first output row its slots hold.
struct DirLaunch {
  const void* kernel;
  int threads, rows, row0;
  size_t smem;
};

template <bool kForce, bool kPot, bool kHalf>
DirLaunch dir_launch(int B) {
  DirLaunch d;
  d.kernel = B >= 64
      ? reinterpret_cast<const void*>(sweep_item_kernel<kForce, kPot, kHalf, 2>)
      : reinterpret_cast<const void*>(sweep_item_kernel<kForce, kPot, kHalf, 1>);
  d.threads = B >= 64 ? B / 2 : B;
  d.rows = (kForce ? 3 : 0) + (kPot ? 1 : 0);
  d.row0 = kForce ? 0 : 3;
  d.smem = 2 * B * sizeof(float4);
  return d;
}

DirLaunch dir_launch(int variant, int B) {
  switch (variant) {
    case 0: return dir_launch<true, false, false>(B);
    case 1: return dir_launch<true, true, false>(B);
    case 2: return dir_launch<false, true, false>(B);
    default: return dir_launch<false, true, true>(B);
  }
}

// The halved item kernel of a shape: B = 32, 64, 128, 256, 512.
const void* n3_kernel(const N3Shape& sh) {
  switch (sh.R * 8 + sh.CPW) {
    case 9: return reinterpret_cast<const void*>(sweep_n3_item_kernel<1, 1>);
    case 17: return reinterpret_cast<const void*>(sweep_n3_item_kernel<2, 1>);
    case 33: return reinterpret_cast<const void*>(sweep_n3_item_kernel<4, 1>);
    case 65: return reinterpret_cast<const void*>(sweep_n3_item_kernel<8, 1>);
    default: return reinterpret_cast<const void*>(sweep_n3_item_kernel<8, 4>);
  }
}

cudaError_t fold_chunk(float* out, long long nbB, int B, const float* slot,
                       int rows, int row0, const int* istart, long long k0,
                       long long k1, cudaStream_t st) {
  const unsigned blocks = (unsigned)((nbB + kFoldThreads - 1) / kFoldThreads);
  item_fold_kernel<<<blocks, kFoldThreads, 0, st>>>(
      out, nbB, B, slot, rows, row0, istart, k0, k1, k0 == 0);
  return cudaGetLastError();
}

}  // namespace

// The sweep's limits, for the wrapper's checks: widest block, coefficient
// count of each polynomial (force and potential), listed source blocks an
// item takes at most.
extern "C" int tree_sweep_max_block() { return kMaxBlock; }
extern "C" int tree_sweep_poly_terms() { return kPolyTerms; }
extern "C" int tree_sweep_item_len() { return kItemLen; }

// The CTAs of the sweep's item kernel an SM of the current device holds at
// once, and its threads, at block B: variant 0-3 the directed ones, 4 the
// halved one (setting its shared-memory limit).
extern "C" int tree_sweep_occupancy(int variant, int B, int* per_sm,
                                    int* threads) {
  if (bad_block(B) || variant < 0 || variant > 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (variant == 4) {
    const N3Shape sh = n3_shape(B);
    const void* kern = n3_kernel(sh);
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    *threads = sh.warps * 32;
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, kern, *threads, sh.smem));
  }
  const DirLaunch d = dir_launch(variant, B);
  *threads = d.threads;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, d.kernel, d.threads, d.smem));
}

// Directed sweep. spos [4, nb*B] float32; jidx: the i-major list of source
// blocks; items [4, kall], istart [nb+1] int32: the item table of the list's
// segment bounds (`sweep_items`); slot: scratch for `chunk` items of the
// variant's rows (3, 4, 1, 1) x B floats; out [4, nb*B] float32; hcoef,
// ecoef: 13 host floats each (force, potential). variant: 0 force, 1 force
// + potential, 2 potential only, 3 potential only over the halved list. B
// a multiple of 32 up to 512. Launches an item kernel and a fold a chunk.
// Returns cudaGetLastError().
extern "C" int tree_sweep(const void* spos, int nb, int B, const void* jidx,
                          const void* items, long long kall,
                          const void* istart, long long chunk, void* slot,
                          void* out, const float* hcoef, const float* ecoef,
                          float eps2, float inv_s2, float two_over_vmax,
                          float inv_s3, float vmax, float inv_s, int variant,
                          void* stream) {
  if (bad_block(B) || variant < 0 || variant > 3 || chunk < 1 ||
      kall < nb) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nb <= 0) return 0;
  // the kernel's arguments, by address for cudaLaunchKernel
  long long nbB = (long long)nb * B;
  Consts k{eps2, inv_s2, two_over_vmax, inv_s3, vmax, inv_s};
  Poly h = make_poly(hcoef), e = make_poly(ecoef);
  const float* sp = static_cast<const float*>(spos);
  const int* ji = static_cast<const int*>(jidx);
  const int* it = static_cast<const int*>(items);
  float* sl = static_cast<float*>(slot);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DirLaunch d = dir_launch(variant, B);
  for (long long k0 = 0; k0 < kall; k0 += chunk) {
    const long long k1 = k0 + chunk < kall ? k0 + chunk : kall;
    void* args[] = {&sp, &nbB, &nb, &it, &kall, &k0, &ji, &sl, &h, &e, &k};
    cudaError_t err = cudaLaunchKernel(d.kernel, dim3((unsigned)(k1 - k0)),
                                       dim3(d.threads), args, d.smem, st);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err == cudaSuccess) {
      err = fold_chunk(static_cast<float*>(out), nbB, B, sl, d.rows, d.row0,
                       static_cast<const int*>(istart), k0, k1, st);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// u_short(d2[0]) -> out[0] (device pointers, one float each): the constant
// every live target of a potential sweep picks up from its own self pair.
extern "C" int tree_potential_at(const void* d2, void* out,
                                 const float* ecoef, float eps2,
                                 float inv_s2, float two_over_vmax,
                                 float vmax, float inv_s, void* stream) {
  const Consts k{eps2, inv_s2, two_over_vmax, 0.f, vmax, inv_s};
  potential_at_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d2), static_cast<float*>(out),
      make_poly(ecoef), k);
  return static_cast<int>(cudaGetLastError());
}

// Halved sweep. jidx: the halved i-major list (j >= i); items [4, kall],
// istart [nb+1]: its item table; islot: scratch for `chunk` items' [3, B]
// i-side sums; rows: scratch [>= list length, 3, B] float32 (rows of
// diagonal pairs are not written); jorder [>= jbounds[nb]], jbounds [nb+1]:
// the off-diagonal list positions grouped by j. B one of 32, 64, 128, 256,
// 512. Launches an item kernel and a fold a chunk, then the j-fold.
extern "C" int tree_sweep_n3(const void* spos, int nb, int B,
                             const void* jidx, const void* items,
                             long long kall, const void* istart,
                             long long chunk, void* islot, void* rows,
                             const void* jorder, const void* jbounds,
                             void* out, const float* coef, float eps2,
                             float inv_s2, float two_over_vmax, float inv_s3,
                             float vmax, void* stream) {
  if (bad_block(B) || (B & (B - 1)) != 0 || chunk < 1 || kall < nb) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nb <= 0) return 0;
  // the kernel's arguments, by address for cudaLaunchKernel
  long long nbB = (long long)nb * B;
  Consts k{eps2, inv_s2, two_over_vmax, inv_s3, vmax, 0.f};
  Poly p = make_poly(coef);
  const float* sp = static_cast<const float*>(spos);
  const int* ji = static_cast<const int*>(jidx);
  const int* it = static_cast<const int*>(items);
  float* isl = static_cast<float*>(islot);
  float* rw = static_cast<float*>(rows);
  float* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const N3Shape sh = n3_shape(B);
  const void* kern = n3_kernel(sh);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (long long k0 = 0; k0 < kall; k0 += chunk) {
    const long long k1 = k0 + chunk < kall ? k0 + chunk : kall;
    void* args[] = {&sp, &nbB, &nb, &B, &it, &kall, &k0, &ji, &isl, &rw,
                    &p, &k};
    err = cudaLaunchKernel(kern, dim3((unsigned)(k1 - k0)),
                           dim3(sh.warps * 32), args, sh.smem, st);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err == cudaSuccess) {
      err = fold_chunk(o, nbB, B, isl, 3, 0,
                       static_cast<const int*>(istart), k0, k1, st);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sweep_n3_fold_kernel<<<nb, B, 0, st>>>(o, nbB, B, rw,
                                         static_cast<const int*>(jorder),
                                         static_cast<const int*>(jbounds));
  return static_cast<int>(cudaGetLastError());
}
