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
// Bound on the H100: arithmetic. Counting the FADD/FMUL/FFMA of a pair
// (the bound counts only those; besides them each pair takes one MUFU
// rsqrt, a min, a compare and a select, and reads one LDS.128):
//   force (directed):  27 = 3 FADD for d, 1 FMUL + 2 FFMA for d2, 1 FADD
//     for +eps2, 2 FMUL for inv^3, 1 FMUL for v, 1 FFMA for x, 12 FFMA of
//     Horner, 1 FFMA for s, 3 FFMA into the sums;
//   force + potential: 41 = those 27, then 12 FFMA of the second Horner
//     chain over the same x, 1 FFMA for u (-inv is a negated operand),
//     1 FADD into the sum;
//   potential only (directed or halved): 23 = the 9 before the force's
//     inv^3 (d, d2, +eps2, v, x), 12 FFMA of Horner, 1 FFMA for u, 1 FADD.
// The listed pairs' positions come from device memory once per (pair,
// block), 12 B per source, so bytes never bound it. The halved force sweep
// computes each unordered block pair's plane once: 33 FADD/FMUL/FFMA a pair
// (the 24 before the sums, then 3 FMUL for d*s, 3 FADD to the i-side, 3
// FADD to the j-side) for about half the pairs, plus 6 shuffles per R
// pairs for the j-side ring.
//
// Directed sweep (tree_sweep): one CUDA block per target block, one thread
// per target. The block walks its own segment bounds[i]..bounds[i+1] of
// the i-major list and streams each listed source block's x, y, z through
// shared memory as float4 (double-buffered with cp.async: the copy of the
// next source block overlaps the pair math of this one). The sums stay in
// registers: each source block's sums in lane order, added to the
// target's in list order (the twin's order; one float32 chain over a whole
// segment, ~28K terms at 1M, drifts further from it). Deterministic, no
// atomics. One template, `sweep_kernel<kForce, kPot, kHalf>`, makes the
// four variants; the force code is the same source in every instance, so
// the fused variant's force rows are the force-only kernel's bit for bit,
// and its potential row the potential-only kernel's. `kHalf` sweeps the
// Newton-3rd halved list (j >= i) of the potential gauge: a source block
// equal to the target block (a diagonal pair, whose plane holds both
// orders of its pairs and the self pairs) adds its sum weighted 1/2.
//
// Halved force sweep (tree_sweep_n3), two launches. The TPU kernel carries
// the j-side sums in VMEM across its sequential grid; Hopper blocks run in
// no order, so:
//   1. One CUDA block per target block walks its halved segment (pairs
//      (i, j), j >= i). Each pair's plane is computed once: its lane sums
//      are added to the target's register accumulators in list order; for
//      j > i the negated column sums over the B targets go to a scratch row
//      [3, B] indexed by the pair's list position. The column sums use a
//      warp lane-rotation ring (a warp holds 32 sources, one per lane,
//      with a j-side sum beside each, and shifts both one lane down after
//      each step) and then add the warps' partials through shared memory
//      in warp order. Diagonal pairs
//      (j == i) take the lane sums only: their dense plane already holds
//      both in-block orders.
//   2. A fold: for each source block j, its scratch rows in the order of a
//      j-major index (a stable sort of the halved list by j, built once per
//      step by the wrapper), then the i-side of pass 1.
// No float atomics anywhere: every sum has a fixed order, so both sweeps
// are bitwise the same from run to run.
//
// Left for later work: load balance. A block's work is its segment length,
// and dense cluster blocks list many more source blocks than the rest; a
// scheduler that splits long segments (or a persistent kernel with a work
// queue) would even it out.

#include <cuda_runtime.h>

namespace {

constexpr int kPolyTerms = 13;
constexpr int kMaxBlock = 512;     // widest block either sweep takes
constexpr int kN3Threads = 128;    // threads of a halved-sweep block (<= B)
constexpr unsigned kFull = 0xffffffffu;

struct Poly {
  float c[kPolyTerms];  // Horner coefficients, c[0] the constant term
};

struct Consts {
  float eps2, inv_s2, two_over_vmax, inv_s3, vmax, inv_s;
};

__device__ __forceinline__ float short_factor(float d2, const Poly& p,
                                              const Consts& k) {
  const float inv = rsqrtf(d2 + k.eps2);
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
  const float inv = rsqrtf(d2 + k.eps2);
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Threads t, t + stride, ... of the block copy source block j's x, y, z
// into tile[0..B) (float4; w is never read).
__device__ __forceinline__ void load_tile(float4* tile,
                                          const float* __restrict__ spos,
                                          long long nbB, int j, int B, int t,
                                          int stride) {
  for (int m = t; m < B; m += stride) {
    const long long g = (long long)j * B + m;
    float* dst = reinterpret_cast<float*>(tile + m);
    cp_async4(dst, spos + g);
    cp_async4(dst + 1, spos + nbB + g);
    cp_async4(dst + 2, spos + 2 * nbB + g);
  }
}

// Directed sweep: block i = target block, thread t = target i*B + t.
// kForce: rows 0-2 (else 0); kPot: row 3 (else 0); kHalf: diagonal pairs
// of the halved list weighted 1/2 in row 3.
template <bool kForce, bool kPot, bool kHalf>
__global__ void __launch_bounds__(kMaxBlock)
sweep_kernel(const float* __restrict__ spos, long long nbB,
             const int* __restrict__ bounds, const int* __restrict__ jidx,
             float* __restrict__ out, Poly poly, Poly epoly, Consts k) {
  extern __shared__ float4 tiles[];  // [2][B]
  const int B = blockDim.x;
  const int i = blockIdx.x, t = threadIdx.x;
  const long long gi = (long long)i * B + t;
  const float xi = spos[gi], yi = spos[nbB + gi], zi = spos[2 * nbB + gi];
  const int s = bounds[i], e = bounds[i + 1];
  float ax = 0.f, ay = 0.f, az = 0.f, au = 0.f;
  if (s < e) {
    load_tile(tiles, spos, nbB, jidx[s], B, t, B);
    cp_async_commit();
  }
  for (int q = s; q < e; ++q) {
    const int buf = (q - s) & 1;
    const int j = jidx[q];
    if (q + 1 < e) {  // the other buffer was consumed last iteration
      load_tile(tiles + (buf ^ 1) * B, spos, nbB, jidx[q + 1], B, t, B);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float4* tl = tiles + buf * B;
    float tx = 0.f, ty = 0.f, tz = 0.f, tu = 0.f;  // this source block's
#pragma unroll 4
    for (int m = 0; m < B; ++m) {
      const float4 p = tl[m];
      const float dx = p.x - xi;
      const float dy = p.y - yi;
      const float dz = p.z - zi;
      const float d2 = dx * dx + dy * dy + dz * dz;
      if constexpr (kForce) {
        const float f = short_factor(d2, poly, k);
        tx += dx * f;
        ty += dy * f;
        tz += dz * f;
      }
      if constexpr (kPot) tu += short_potential(d2, epoly, k);
    }
    if constexpr (kForce) {
      ax += tx;
      ay += ty;
      az += tz;
    }
    if constexpr (kPot) {
      if constexpr (kHalf) {
        if (j == i) tu *= 0.5f;  // uniform over the block
      }
      au += tu;
    }
    __syncthreads();  // this buffer is refilled two iterations on
  }
  out[gi] = ax;
  out[nbB + gi] = ay;
  out[2 * nbB + gi] = az;
  out[3 * nbB + gi] = au;
}

// u_short(d2[0]) -> out[0]: the self-pair constant, by the sweep's own
// device function (d2 is read from memory so nothing folds it).
__global__ void potential_at_kernel(const float* __restrict__ d2,
                                    float* __restrict__ out, Poly epoly,
                                    Consts k) {
  out[0] = short_potential(d2[0], epoly, k);
}

// Halved sweep, pass 1. R targets per thread (B = kN3Threads * R, or B
// threads with R = 1 for B < kN3Threads). Target r of lane `lane` in warp
// `warp` is warp*32*R + r*32 + lane: each warp load is one 128-byte row.
template <int R>
__global__ void __launch_bounds__(kN3Threads)
sweep_n3_pair_kernel(const float* __restrict__ spos, long long nbB, int B,
                     const int* __restrict__ bounds,
                     const int* __restrict__ jidx, float* __restrict__ out,
                     float* __restrict__ rows, Poly poly, Consts k) {
  extern __shared__ float4 smem[];
  const int T = blockDim.x, W = T / 32;
  float4* tiles = smem;                                   // [2][B]
  float* jpart = reinterpret_cast<float*>(smem + 2 * B);  // [W][3][B]
  const int i = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int next = (lane + 1) & 31;
  const long long base = (long long)i * B;
  float xi[R], yi[R], zi[R], ax[R], ay[R], az[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long g = base + warp * 32 * R + r * 32 + lane;
    xi[r] = spos[g];
    yi[r] = spos[nbB + g];
    zi[r] = spos[2 * nbB + g];
    ax[r] = ay[r] = az[r] = 0.f;
  }
  const int s = bounds[i], e = bounds[i + 1];
  if (s < e) {
    load_tile(tiles, spos, nbB, jidx[s], B, threadIdx.x, T);
    cp_async_commit();
  }
  for (int q = s; q < e; ++q) {
    const int buf = (q - s) & 1;
    const int j = jidx[q];
    if (q + 1 < e) {
      load_tile(tiles + (buf ^ 1) * B, spos, nbB, jidx[q + 1], B,
                threadIdx.x, T);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float4* tl = tiles + buf * B;
    float px[R], py[R], pz[R];  // this pair's lane sums
#pragma unroll
    for (int r = 0; r < R; ++r) px[r] = py[r] = pz[r] = 0.f;
    for (int c = 0; c < B / 32; ++c) {
      const float4 p = tl[c * 32 + lane];
      float xj = p.x, yj = p.y, zj = p.z;
      float jx = 0.f, jy = 0.f, jz = 0.f;
#pragma unroll 2
      for (int step = 0; step < 32; ++step) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float dx = xj - xi[r];
          const float dy = yj - yi[r];
          const float dz = zj - zi[r];
          const float f = short_factor(dx * dx + dy * dy + dz * dz, poly, k);
          const float tx = dx * f, ty = dy * f, tz = dz * f;
          px[r] += tx;
          py[r] += ty;
          pz[r] += tz;
          jx -= tx;
          jy -= ty;
          jz -= tz;
        }
        // the source and its j-side sums move one lane down
        xj = __shfl_sync(kFull, xj, next);
        yj = __shfl_sync(kFull, yj, next);
        zj = __shfl_sync(kFull, zj, next);
        jx = __shfl_sync(kFull, jx, next);
        jy = __shfl_sync(kFull, jy, next);
        jz = __shfl_sync(kFull, jz, next);
      }
      // 32 moves later each source is back in its own lane
      float* wp = jpart + (long long)warp * 3 * B + c * 32 + lane;
      wp[0] = jx;
      wp[B] = jy;
      wp[2 * B] = jz;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      ax[r] += px[r];
      ay[r] += py[r];
      az[r] += pz[r];
    }
    __syncthreads();
    if (j != i) {  // uniform over the block
      float* row = rows + (long long)q * 3 * B;
      for (int m = threadIdx.x; m < B; m += T) {
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          float sum = jpart[d * B + m];
          for (int w = 1; w < W; ++w) sum += jpart[(w * 3 + d) * B + m];
          row[d * B + m] = sum;
        }
      }
    }
    __syncthreads();  // jpart and this tile buffer are reused
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long g = base + warp * 32 * R + r * 32 + lane;
    out[g] = ax[r];
    out[nbB + g] = ay[r];
    out[2 * nbB + g] = az[r];
    out[3 * nbB + g] = 0.f;
  }
}

// Halved sweep, pass 2: block j adds its scratch rows jorder[jbounds[j]..
// jbounds[j+1]) in that order, then the i-side pass 1 left in `out`.
__global__ void __launch_bounds__(kN3Threads)
sweep_n3_fold_kernel(float* __restrict__ out, long long nbB, int B,
                     const float* __restrict__ rows,
                     const int* __restrict__ jorder,
                     const int* __restrict__ jbounds) {
  const int j = blockIdx.x;
  const int s = jbounds[j], e = jbounds[j + 1];
  for (int m = threadIdx.x; m < B; m += blockDim.x) {
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
}

bool bad_block(int B) { return B < 32 || B > kMaxBlock || B % 32 != 0; }

Poly make_poly(const float* coef) {
  Poly p;
  for (int m = 0; m < kPolyTerms; ++m) p.c[m] = coef[m];
  return p;
}

template <bool kForce, bool kPot, bool kHalf>
void launch_sweep(int nb, int B, cudaStream_t st, const float* spos,
                  long long nbB, const int* bounds, const int* jidx,
                  float* out, const Poly& h, const Poly& e, const Consts& k) {
  sweep_kernel<kForce, kPot, kHalf><<<nb, B, 2 * B * sizeof(float4), st>>>(
      spos, nbB, bounds, jidx, out, h, e, k);
}

}  // namespace

// The sweep's limits, for the wrapper's checks: widest block, coefficient
// count of each polynomial (force and potential).
extern "C" int tree_sweep_max_block() { return kMaxBlock; }
extern "C" int tree_sweep_poly_terms() { return kPolyTerms; }

// Directed sweep. spos [4, nb*B] float32; bounds [nb+1], jidx [>= bounds[nb]]
// int32; out [4, nb*B] float32; hcoef, ecoef: 13 host floats each (force,
// potential). variant: 0 force, 1 force + potential, 2 potential only,
// 3 potential only over the halved list. B a multiple of 32 up to 512.
// Returns cudaGetLastError().
extern "C" int tree_sweep(const void* spos, int nb, int B, const void* bounds,
                          const void* jidx, void* out, const float* hcoef,
                          const float* ecoef, float eps2, float inv_s2,
                          float two_over_vmax, float inv_s3, float vmax,
                          float inv_s, int variant, void* stream) {
  if (bad_block(B) || variant < 0 || variant > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nb <= 0) return 0;
  const long long nbB = (long long)nb * B;
  const Consts k{eps2, inv_s2, two_over_vmax, inv_s3, vmax, inv_s};
  const Poly h = make_poly(hcoef), e = make_poly(ecoef);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(spos);
  const int* bd = static_cast<const int*>(bounds);
  const int* ji = static_cast<const int*>(jidx);
  float* o = static_cast<float*>(out);
  switch (variant) {
    case 0:
      launch_sweep<true, false, false>(nb, B, st, sp, nbB, bd, ji, o, h, e, k);
      break;
    case 1:
      launch_sweep<true, true, false>(nb, B, st, sp, nbB, bd, ji, o, h, e, k);
      break;
    case 2:
      launch_sweep<false, true, false>(nb, B, st, sp, nbB, bd, ji, o, h, e,
                                       k);
      break;
    default:
      launch_sweep<false, true, true>(nb, B, st, sp, nbB, bd, ji, o, h, e, k);
      break;
  }
  return static_cast<int>(cudaGetLastError());
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

// Halved sweep. bounds [nb+1] over the halved i-major list jidx (j >= i);
// rows: scratch [>= bounds[nb], 3, B] float32 (rows of diagonal pairs are
// not written); jorder [>= jbounds[nb]], jbounds [nb+1]: the off-diagonal
// list positions grouped by j. B one of 32, 64, 128, 256, 512.
extern "C" int tree_sweep_n3(const void* spos, int nb, int B,
                             const void* bounds, const void* jidx, void* out,
                             void* rows, const void* jorder,
                             const void* jbounds, const float* coef,
                             float eps2, float inv_s2, float two_over_vmax,
                             float inv_s3, float vmax, void* stream) {
  if (bad_block(B) || (B & (B - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nb <= 0) return 0;
  const long long nbB = (long long)nb * B;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Consts k{eps2, inv_s2, two_over_vmax, inv_s3, vmax, 0.f};
  const Poly p = make_poly(coef);
  const float* sp = static_cast<const float*>(spos);
  const int* bd = static_cast<const int*>(bounds);
  const int* ji = static_cast<const int*>(jidx);
  float* o = static_cast<float*>(out);
  float* rw = static_cast<float*>(rows);
  const int T = B < kN3Threads ? B : kN3Threads;
  const size_t shm = 2 * B * sizeof(float4) + (size_t)(T / 32) * 3 * B * 4;
  switch (B / T) {
    case 1:
      sweep_n3_pair_kernel<1><<<nb, T, shm, st>>>(sp, nbB, B, bd, ji, o, rw,
                                                   p, k);
      break;
    case 2:
      sweep_n3_pair_kernel<2><<<nb, T, shm, st>>>(sp, nbB, B, bd, ji, o, rw,
                                                   p, k);
      break;
    default:
      sweep_n3_pair_kernel<4><<<nb, T, shm, st>>>(sp, nbB, B, bd, ji, o, rw,
                                                   p, k);
      break;
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sweep_n3_fold_kernel<<<nb, T, 0, st>>>(o, nbB, B, rw,
                                          static_cast<const int*>(jorder),
                                          static_cast<const int*>(jbounds));
  return static_cast<int>(cudaGetLastError());
}
