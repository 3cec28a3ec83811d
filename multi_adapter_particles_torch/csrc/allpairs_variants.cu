// All-pairs A/B variants of the directed rectangle: elementwise forms, and
// the port's tensor-core expansion forms (mma.sync, BF16 in, FP32 sums).
//
// Replaces the TPU kernels of the JAX package's `experiments/`:
//   attr_accel   allpairs_v2.py:37        _attr_kernel        -> elem_kernel<0..2>
//   v1b_accel    allpairs_v2.py:112       _v1b_kernel         -> expand_kernel<1,*>
//   unroll_accel allpairs_unroll.py:29    _kernel             -> elem_kernel<3>
//   v1_accel     allpairs_variants.py:35  _v1_kernel          -> expand_kernel<0,*>
//   v3_accel     allpairs_v3.py:53        _v3_kernel          -> v3_kernel<path>
//   hybrid_accel allpairs_hybrid.py:42    _hybrid_kernel      -> hybrid_kernel
//   v4_accel     allpairs_planeacc.py:35  _v4_kernel          -> plane_kernel
// The plain torch twins and the semantics of each are in
// `ops/allpairs_variants.py`. Every block owns its targets and sums its
// sources in a fixed order: no atomics, each result bitwise the same from
// run to run. N is a multiple of TILE = 128 (no masks, as in the JAX
// kernels; the port's state pads to 128).
//
// Issue tally per pair, by pipe (what bounds each on the H100: the FP32
// pipe retires 128 lanes a clock per SM, MUFU 16, the tensor cores 4,096
// dense BF16 flops, i.e. one m16n8k16 mma a clock per SM), as the SASS of
// each kernel's rsqrt loop shows it (chip_smoke phase 2; attr's, unroll's
// and v4's loops beside the rsqrtf guard's FSETP and two predicated FMULs,
// not counted here; v1, v1b, v3 and hybrid have no guard):
//   elementwise (attr full, unroll, v4, hybrid's tiles 0-1): 12 FP32
//     (3 sub, 4 for d² = dx·dx + dy·dy + dz·dz + eps2, 2 mul for s = inv³,
//     3 FMA into the sums), 1 MUFU (rsqrt); attr norsqrt 11 FP32 and no
//     MUFU (s = d² · 1e-9); attr noaccum 9 FP32 (inv² · inv goes into the
//     one sum as an FMA), 1 MUFU.
//   v1b: 3 FP32 (d² = dot + r_i², 2 mul) at "default"; 4 at "highest"
//     (r_i² enters as the first mma's C; 2 mul, 2 sub for the mid and lo
//     pieces of s) and 14 FP32 a row tile a fold (every 64 of its pairs a
//     lane: 0.22 a pair); 1 MUFU; "highest" also 1.5 F2FP packs and 2
//     shift / mask unpacks of s's pieces, "default" 0.5 F2FP; mma a 16x16
//     block of pairs (8 warp slots of 32 pairs): 2 k8 + 1 k16 at
//     "default", 2 k16 + 2 k8 + 4 k16 at "highest" (1 HMMA slot a pair),
//     i.e. 32 or 112 tensor flops a pair; LDS 0.19 ("default") or 0.31
//     ("highest"; v1 + 0.125 for r_j²). Their loops take 5.21 and 10.24
//     issue slots a pair (v1: 6.37, 11.38; PERF.md's kernel table).
//   v1: 4 FP32 at "default" (r_j² enters as an FP32 FMA, then + r_i²); 5
//     at "highest" (the first mma, on -2 times the target pieces, takes
//     r_j² as its C; then + r_i²).
//   v3: 4 FP32 (d² = (r_i² - 2 dot) + r_j², 2 mul), 1 MUFU, mma 2 a block
//     (K = 12 padded to 16: 32 flops a pair); + 4 FMA (vpu), or + 1 sub and
//     2 mma (mm_split, 64 flops), or + 1 mma (mm_bf16, 48 flops). Its loops
//     take 10.13 (vpu), 9.52 (mm_split) and 6.64 (mm_bf16) issue slots a
//     pair; each mma.sync takes one slot but 4.6-7.7 slots' time on an
//     H100 (PERF.md, v3's attribution), which the slots do not show.
//   hybrid: two thirds elementwise, one third v1b "highest": 28/3 = 9.33
//     FP32 (its folds, every 8 loop bodies, lie outside the loop), 1 MUFU,
//     112/3 = 37.3 tensor flops a pair; a loop body is 16 expansion and 32
//     elementwise pairs a lane; LDS 0.75 an elementwise pair (three
//     LDS.128 a 4 sources) and the expansion's 0.31.
// At 1,048,576 and 1,980 MHz one MUFU a pair alone takes 263 ms and 12
// FP32 394.4 ms: the expansion forms move FP32 work onto the tensor cores
// and should end MUFU-bound.
//
// Expansion layout (v1, v1b, hybrid, v3): a warp owns 32 targets as two
// m16 row tiles; sources come in chunks of 16 (two n8 column halves).
// The first mma gives dot(i, j) in the accumulator layout (rows g, g+8;
// columns 2t, 2t+1 of each half; g = lane / 4, t = lane % 4), which is
// exactly the A layout of an m16n8k16 with K = the 16 sources: s stays in
// registers from the first mma to the second, packed to bf16 pairs (the
// flash-attention trick). The second mma's B holds the sources' (x, y, z,
// 1) pieces in its 8 columns.
//
// "highest" is the TPU's HIGHEST algorithm on BF16 tensor cores: every
// float32 operand is split into three bf16 pieces hi + mid + lo (exact:
// 8 + 8 + 8 significant bits), and the six products hi·hi, hi·mid,
// mid·hi, hi·lo, lo·hi, mid·mid are taken. In the first mma they are
// packed along K (6 groups of 4 coordinates, K = 24: a k16 and a k8 step);
// in the second the source pieces sit in the columns ([hi | mid], [hi |
// 0], [lo | 0]) and s's pieces in three A operands (4 mma). "default" is
// one bf16 pass, as DEFAULT is on the TPU (one k8 step, one force mma).
//
// v1 / v1b (`expand_kernel`): a CTA is 8 warps (256 targets) and the
// launch bounds ask for two CTAs, 16 warps an SM (at most 128 registers).
// Sources are staged 512 at a time (256 or 128 when that does not divide
// N; a last CTA past N computes on a clamped target and writes nothing)
// into two buffers of dynamic shared memory: while the CTA computes on
// one, every thread has loaded the next stage's positions (two sources a
// thread) and builds their records into the other after its chunks; one
// barrier a stage, so each source's pieces serve 256 targets. A source's
// record is the first mma's B in load order: "highest" the K words w0 w4
// w1 w5 w2 w6 w3 w7 (lane (g, t) reads w_t, w_t+4 as one 64-bit load; the
// k8 step's words 8-11 are 0-3 again, so its B is the first register),
// "default" w0 w1 (lanes t >= 2 meet a zero A); v1 "highest" stores r_j²
// as the first mma's C quad. The column table holds 8
// source-pair words a column in the order w0 w4 w1 w5 ... (`tcol_slot`), so
// every second-mma B is one 64-bit load whose column each lane fixes once
// ([hi | 0] and [lo | 0] read the zero column on lanes g >= 4); the 1 and 0
// columns are written once. All loads are free of bank conflicts. The
// chunk loop is unrolled (eight chunks a body, each chunk's first mma just
// before its forces: on an H100 the compiler's interleaving beat a
// look-ahead by hand, and one accumulator a row tile beat two; PERF.md).
// The rsqrt is `rsqrt.approx.ftz` (`inv3_ftz`). The sums are folded in a
// fixed order (columns c + 4 onto c) into Kahan-compensated totals, each
// lane keeping one row: every 128 sources at "highest" (512 in one
// accumulator measured 10% further from the float64 sum) and once a stage
// at "default"; bitwise the same from run to run.
//
// hybrid (`hybrid_kernel`) runs that CTA and that chunk, fold and finish
// (`ExpRows<true, true>`: v1b "highest"), and beside each chunk, in the same
// loop body, 32 elementwise sources against the lane's own target: a stage
// is S = 512 sources of a group's tile 2 (256 or 128 when that does not
// divide tj) and the 2 S sources of its tiles 0-1, in two buffers of
// dynamic shared memory, the elementwise x, y, z planes staged by 16-byte
// cp.async copies (no registers held) and read as float4 broadcasts; one
// barrier a stage; `rsqrt.approx.ftz` in both forms (d² >= eps2 > 0 in the
// elementwise terms: bitwise rsqrtf). The elementwise sums run in one chain
// a coordinate and fold into Kahan totals with the expansion's, every 8
// bodies (128 expansion and 256 elementwise sources).
//
// Float32 sums over 1M sources: each stage is summed in the mma
// accumulator or in 4 chains, and the stage sums go into the running sums
// with Kahan compensation, as `allpairs.cu`'s rectangle does. v4 keeps its
// per-(target, lane) partials plain for 16 stages at a time and folds them
// into compensated totals; v3 adds each j-tile's sums plainly, as the JAX
// kernel does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;   // targets a block, sources a stage
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float inv3(float d2) {
  const float inv = rsqrtf(d2);
  return inv * inv * inv;
}

// inv3 with rsqrt.approx.ftz: no FSETP and predicated FMULs around the MUFU.
// Where d² can cancel below ε² it can be denormal: for a positive denormal
// rsqrtf gives at least 2^63 and its cube overflows to +inf, as ftz's
// rsqrt(+0) = +inf does; zero gives inf and a negative normal NaN in both.
// Only a negative denormal differs (-inf against NaN): non-finite either way.
__device__ __forceinline__ float inv3_ftz(float d2) {
  float inv;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(inv) : "f"(d2));
  return inv * inv * inv;
}

// x² + y² + z² rounded as the twins round it: ((x² + y²) + z²)
__device__ __forceinline__ float r2(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

__device__ __forceinline__ float amag(float ax, float ay, float az) {
  return sqrtf(r2(ax, ay, az));
}

// s + x with Kahan compensation c (the true sum is s - c).
__device__ __forceinline__ void kahan_add(float& s, float& c, float x) {
  const float y = x - c;
  const float t = s + y;
  c = (t - s) - y;
  s = t;
}

// ---------------------------------------------------------------------------
// Elementwise: v0's pair terms, one thread a target, sources staged through
// shared memory as float4.
// ---------------------------------------------------------------------------

enum ElemMode { kFull = 0, kNoRsqrt = 1, kNoAccum = 2, kUnroll = 3 };

// The stage's sums for one target over tile[0:TILE], in 4 chains.
template <int MODE>
__device__ __forceinline__ void tile_sums(float xi, float yi, float zi,
                                          const float4* tile, float eps2,
                                          float& sx, float& sy, float& sz) {
  float tx[4] = {0.f, 0.f, 0.f, 0.f};
  float ty[4] = {0.f, 0.f, 0.f, 0.f};
  float tz[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int k = 0; k < TILE; k += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 p = tile[k + u];
      const float dx = p.x - xi;
      const float dy = p.y - yi;
      const float dz = p.z - zi;
      const float d2 = dx * dx + dy * dy + dz * dz + eps2;
      const float s = MODE == kNoRsqrt ? d2 * 1e-9f : inv3(d2);
      if (MODE == kNoAccum) {
        tx[u] += s;
      } else {
        tx[u] += dx * s;
        ty[u] += dy * s;
        tz[u] += dz * s;
      }
    }
  }
  sx = (tx[0] + tx[1]) + (tx[2] + tx[3]);
  sy = (ty[0] + ty[1]) + (ty[2] + ty[3]);
  sz = (tz[0] + tz[1]) + (tz[2] + tz[3]);
}

__device__ __forceinline__ void stage_float4(const float* pos, long long n,
                                             long long j0, float4* tile) {
  const long long j = j0 + threadIdx.x;
  tile[threadIdx.x] = make_float4(pos[j], pos[n + j], pos[2 * n + j], 0.f);
}

// attr (MODE 0-2, unscaled, out [n, 4]) and unroll (MODE 3: stage t's sums
// into chain t % 2, a = (a0 + a1) * mass, out [4, n]).
template <int MODE>
__global__ void __launch_bounds__(TILE)
elem_kernel(const float* __restrict__ pos, long long n,
            float* __restrict__ out, float mass, float eps2) {
  __shared__ float4 tile[TILE];
  const long long i = (long long)blockIdx.x * TILE + threadIdx.x;
  const float xi = pos[i], yi = pos[n + i], zi = pos[2 * n + i];
  float a[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};  // chains
  float c[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};  // compensation
  for (long long j0 = 0; j0 < n; j0 += TILE) {
    __syncthreads();
    stage_float4(pos, n, j0, tile);
    __syncthreads();
    float s[3];
    tile_sums<MODE>(xi, yi, zi, tile, eps2, s[0], s[1], s[2]);
    const int ch = MODE == kUnroll ? (int)((j0 / TILE) & 1) : 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) kahan_add(a[ch][k], c[ch][k], s[k]);
  }
  float r[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r[k] = a[0][k] - c[0][k];
    if (MODE == kUnroll) r[k] = (r[k] + (a[1][k] - c[1][k])) * mass;
  }
  const float m = amag(r[0], r[1], r[2]);
  if (MODE == kUnroll) {
    out[i] = r[0];
    out[n + i] = r[1];
    out[2 * n + i] = r[2];
    out[3 * n + i] = m;
  } else {
    reinterpret_cast<float4*>(out)[i] = make_float4(r[0], r[1], r[2], m);
  }
}

// ---------------------------------------------------------------------------
// v4: per-(target, j-lane) partial sums. A warp holds PLANE_R targets in
// every lane; lane l takes sources l, l + 32, ... of each stage. After the
// last stage one butterfly across the 32 lanes gives each target its sum.
// ---------------------------------------------------------------------------

constexpr int PLANE_WARPS = 4;
constexpr int PLANE_R = 8;                        // targets a warp
constexpr int PLANE_TARGETS = PLANE_WARPS * PLANE_R;
constexpr int PLANE_TJ = 256;                     // sources a stage
constexpr int PLANE_FOLD = 16;                    // stages a plain partial

__global__ void __launch_bounds__(PLANE_WARPS * 32)
plane_kernel(const float* __restrict__ pos, long long n,
             float* __restrict__ out, float mass, float eps2) {
  __shared__ float4 tile[PLANE_TJ];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long ibase =
      (long long)blockIdx.x * PLANE_TARGETS + warp * PLANE_R;
  float xi[PLANE_R], yi[PLANE_R], zi[PLANE_R];
  float px[PLANE_R], py[PLANE_R], pz[PLANE_R];  // plain partials
  float sx[PLANE_R], sy[PLANE_R], sz[PLANE_R];  // compensated totals
  float cx[PLANE_R], cy[PLANE_R], cz[PLANE_R];
#pragma unroll
  for (int r = 0; r < PLANE_R; ++r) {
    xi[r] = pos[ibase + r];
    yi[r] = pos[n + ibase + r];
    zi[r] = pos[2 * n + ibase + r];
    px[r] = py[r] = pz[r] = sx[r] = sy[r] = sz[r] = 0.f;
    cx[r] = cy[r] = cz[r] = 0.f;
  }
  int stage = 0;
  for (long long j0 = 0; j0 < n; j0 += PLANE_TJ, ++stage) {
    __syncthreads();
    for (int k = threadIdx.x; k < PLANE_TJ; k += PLANE_WARPS * 32) {
      const long long j = j0 + k;   // n % 128 == 0: a stage may be half
      tile[k] = j < n ? make_float4(pos[j], pos[n + j], pos[2 * n + j], 0.f)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    const int cnt = (int)min((long long)PLANE_TJ, n - j0) / 32;
    for (int k = 0; k < cnt; ++k) {
      const float4 p = tile[k * 32 + lane];
#pragma unroll
      for (int r = 0; r < PLANE_R; ++r) {
        const float dx = p.x - xi[r];
        const float dy = p.y - yi[r];
        const float dz = p.z - zi[r];
        const float d2 = dx * dx + dy * dy + dz * dz + eps2;
        const float s = inv3(d2);
        px[r] += dx * s;
        py[r] += dy * s;
        pz[r] += dz * s;
      }
    }
    if ((stage + 1) % PLANE_FOLD == 0 || j0 + PLANE_TJ >= n) {
#pragma unroll
      for (int r = 0; r < PLANE_R; ++r) {
        kahan_add(sx[r], cx[r], px[r]);
        kahan_add(sy[r], cy[r], py[r]);
        kahan_add(sz[r], cz[r], pz[r]);
        px[r] = py[r] = pz[r] = 0.f;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < PLANE_R; ++r) {
    float ax = sx[r] - cx[r], ay = sy[r] - cy[r], az = sz[r] - cz[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {  // every lane gets the sum
      ax += __shfl_xor_sync(FULL, ax, off);
      ay += __shfl_xor_sync(FULL, ay, off);
      az += __shfl_xor_sync(FULL, az, off);
    }
    if (lane == r) {
      ax *= mass;
      ay *= mass;
      az *= mass;
      reinterpret_cast<float4*>(out)[ibase + r] =
          make_float4(ax, ay, az, amag(ax, ay, az));
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core helpers
// ---------------------------------------------------------------------------

// D += A (16x16 bf16, row) * B (16x8 bf16, col), FP32 accumulators.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D = A (16x16 bf16, row) * B (16x8 bf16, col) + C, FP32.
__device__ __forceinline__ void mma16816_c(float (&d)[4],
                                           const uint32_t (&a)[4], uint32_t b0,
                                           uint32_t b1, const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// D += A (16x8 bf16, row) * B (8x8 bf16, col), FP32 accumulators.
__device__ __forceinline__ void mma1688(float (&d)[4], const uint32_t (&a)[2],
                                        uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// two bf16 values in one register, `lo` in the low half (the smaller
// K or column index)
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return as_u32(__halves2bfloat162(lo, hi));
}

// the two bf16 halves of a word as floats (a shift and a mask)
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// v ~ hi + mid + lo, each bf16 (exact for float32 v)
struct Pieces {
  __nv_bfloat16 p[3];
};

__device__ __forceinline__ Pieces split3(float v) {
  Pieces out;
  out.p[0] = __float2bfloat16_rn(v);
  const float r = __fsub_rn(v, __bfloat162float(out.p[0]));
  out.p[1] = __float2bfloat16_rn(r);
  out.p[2] = __float2bfloat16_rn(__fsub_rn(r, __bfloat162float(out.p[1])));
  return out;
}

// s's A operands for the second mma from the first mma's accumulators
// c[h][e] (h: source half; e: (row g | g+8) x (col 2t | 2t+1)): the hi
// pieces, and with `three` also mid and lo (split3's pieces, each level a
// pack, a shift and a mask, two subtractions).
template <bool kThree>
__device__ __forceinline__ void split_s(const float (&s)[2][4],
                                        uint32_t (&hi)[4], uint32_t (&mid)[4],
                                        uint32_t (&lo)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {  // register q: half q / 2, row (q & 1)
    const float s0 = s[q >> 1][(q & 1) * 2];
    const float s1 = s[q >> 1][(q & 1) * 2 + 1];
    hi[q] = as_u32(__floats2bfloat162_rn(s0, s1));
    if (kThree) {
      const float r0 = __fsub_rn(s0, bf16_lo(hi[q]));
      const float r1 = __fsub_rn(s1, bf16_hi(hi[q]));
      mid[q] = as_u32(__floats2bfloat162_rn(r0, r1));
      lo[q] = as_u32(__floats2bfloat162_rn(__fsub_rn(r0, bf16_lo(mid[q])),
                                           __fsub_rn(r1, bf16_hi(mid[q]))));
    }
  }
}

// The slot of source-pair word m (0-7) in a column of a chunk's column
// table (sources 2m, 2m + 1 of the chunk): w0 w4 w1 w5 w2 w6 w3 w7, so lane
// (g, t) reads the second mma's B (w_t, w_t+4) of column g as one 64-bit
// load at 8 g + 2 t.
__host__ __device__ constexpr int tcol_slot(int m) {
  return 2 * (m & 3) + (m >> 2);
}

constexpr uint32_t BF16_ONES = 0x3f803f80u;   // bf16 (1, 1)

// K groups of 4 coordinates: "highest" takes the six piece products
// (A piece x B piece) hi·hi, hi·mid, mid·hi, hi·lo, lo·hi, mid·mid in
// groups 0-5 (6-7 zero, K = 32); "default" hi·hi in group 0 (K = 16).
// piece index (0 hi, 1 mid, 2 lo; -1 zero) of group g on the A (target)
// and B (source) side
__host__ __device__ constexpr int a_piece(bool three, int g) {
  return three ? (g == 0 || g == 1 || g == 3 ? 0 : g == 2 || g == 5 ? 1
                  : g == 4 ? 2 : -1)
               : (g == 0 ? 0 : -1);
}
__host__ __device__ constexpr int b_piece(bool three, int g) {
  return three ? (g == 0 || g == 2 || g == 4 ? 0 : g == 1 || g == 5 ? 1
                  : g == 3 ? 2 : -1)
               : (g == 0 ? 0 : -1);
}

// word w (K slots 2w, 2w+1) of a K vector whose 4 coordinates have pieces
// pc[coord]; `a_side` picks the group table
template <bool kThree>
__device__ __forceinline__ uint32_t k_word(const Pieces (&pc)[4], int w,
                                           bool a_side) {
  const int grp = w >> 1, c0 = (w & 1) * 2;
  const int pi = a_side ? a_piece(kThree, grp) : b_piece(kThree, grp);
  if (pi < 0) return 0u;
  return pack2(pc[c0].p[pi], pc[c0 + 1].p[pi]);
}

// ---------------------------------------------------------------------------
// v1 / v1b: the expansion (layout in the header). A CTA is EXP_WARPS warps
// of EXP_MT m16 row tiles (EXP_TARGETS targets); sources are staged
// EXP_STAGE at a time (256 or 128 when that does not divide n) into two
// buffers in dynamic shared memory, one barrier a stage.
// ---------------------------------------------------------------------------

constexpr int EXP_MT = 2;                         // m16 row tiles a warp
constexpr int EXP_WARPS = 8;                      // warps a CTA
constexpr int EXP_NT = EXP_WARPS * 32;            // threads a CTA
constexpr int EXP_TARGETS = EXP_WARPS * EXP_MT * 16;
constexpr int EXP_SM_WARPS = 16;                  // warps an SM the bounds ask
constexpr int EXP_STAGE = 512;                    // sources a stage (at most)
constexpr int EXP_CHUNKS = EXP_STAGE / 16;        // 16-source chunks a stage
constexpr int EXP_RB = EXP_STAGE / EXP_NT;        // sources a thread stages
constexpr int EXP_FOLD = 8;                       // "highest": chunks a fold

// The layout as the kernel indexes it; the `apv_expand_*` exports give it
// to the library, which checks `ops/allpairs_variants.py`'s mirror against
// it when it loads.
// Sources a stage: EXP_STAGE, or its half or quarter, whichever divides n.
__host__ __device__ constexpr int exp_stage(long long n) {
  return n % EXP_STAGE == 0         ? EXP_STAGE
         : n % (EXP_STAGE / 2) == 0 ? EXP_STAGE / 2
                                    : EXP_STAGE / 4;
}
// First-mma record words a source: "highest" the K words in the order w0
// w4 w1 w5 w2 w6 w3 w7 (K slots 0-15; words 8-11 repeat 0-3 and 12-15 are
// zero); "default" w0 w1 (group 0: hi of (x, y), (z, w)).
__host__ __device__ constexpr int exp_rec(bool three) { return three ? 8 : 2; }
// Columns of a chunk's column table: [hi x y z | 1 | mid x y z | 0 | lo x y
// z] ("highest"), [hi x y z | 1 | 0] ("default"); 8 words a column.
__host__ __device__ constexpr int exp_cols(bool three) {
  return three ? 11 : 5;
}
__host__ __device__ constexpr int exp_zero_col(bool three) {
  return three ? 7 : 4;
}
// The first word of lane (g, t)'s first-mma B load of chunk c, half h:
// source c 16 + h 8 + g, a 64-bit load of words 2 t, 2 t + 1 ("highest":
// K words t and t + 4), or word t & 1 ("default": lanes t >= 2 meet a zero
// A, so any finite word will do).
__host__ __device__ constexpr int exp_rec_word(bool three, int c, int h,
                                               int g, int t) {
  return (c * 16 + h * 8 + g) * exp_rec(three) + (three ? 2 * t : (t & 1));
}
// The column lane g reads for the second mma's B `which`: 0 [hi | mid]
// (column g), 1 [hi | 0] (g < 4: hi, else the zero column), 2 [lo | 0]
// (g < 3: lo; lo of 1 and g >= 4: the zero column).
__host__ __device__ constexpr int exp_col(bool three, int which, int g) {
  return which == 0   ? g
         : which == 1 ? (g < 4 ? g : exp_zero_col(three))
                      : (g < 3 ? 8 + g : exp_zero_col(three));
}
// The first word of that 64-bit load in chunk c: slots 2 t, 2 t + 1 hold
// source-pair words t and t + 4 (tcol_slot).
__host__ __device__ constexpr int exp_tcol_word(bool three, int which, int c,
                                                int g, int t) {
  return (c * exp_cols(three) + exp_col(three, which, g)) * 8 + 2 * t;
}
// v1: the first word of lane t's r_j² load in chunk c's half h, the pair
// of its accumulator columns 2 t, 2 t + 1: "highest" stores each source
// pair as (r_2m, r_2m+1, r_2m, r_2m+1), the first mma's C quad, read as
// one 128-bit load; "default" stores r_j² once a source, a 64-bit load.
__host__ __device__ constexpr int exp_rj2_word(bool three, int c, int h,
                                               int t) {
  return three ? 4 * (c * 8 + h * 4 + t) : c * 16 + h * 8 + 2 * t;
}

// One staged buffer: records, column table, and (v1) r_j².
template <bool kV1b, bool kThree>
struct alignas(16) ExpBuf {
  uint32_t rec[EXP_STAGE * exp_rec(kThree)];
  uint32_t tcol[EXP_CHUNKS * exp_cols(kThree) * 8];
  float rj2[kV1b ? 4 : (kThree ? 2 : 1) * EXP_STAGE];
};

// bf16 pair w times (sa, sb), exact for powers of two
__device__ __forceinline__ uint32_t scale2(uint32_t w, float sa, float sb) {
  return as_u32(__hmul2(*reinterpret_cast<const __nv_bfloat162*>(&w),
                        __floats2bfloat162_rn(sa, sb)));
}

// Build source j's records of a stage in B from its position (x, y, z).
// The record holds the pieces of w = (-2x, -2y, -2z, r_j²) (v1b; -2 times
// a piece of x is the piece of -2x, exactly) or (x, y, z, 0) (v1); the
// column table the pieces of (x, y, z), each thread storing its own bf16
// halves (no shuffle).
template <bool kV1b, bool kThree>
__device__ __forceinline__ void exp_build(ExpBuf<kV1b, kThree>& B, int j,
                                          float x, float y, float z) {
  const float rj2 = r2(x, y, z);
  const Pieces p[3] = {split3(x), split3(y), split3(z)};
  const Pieces pw = split3(kV1b ? rj2 : 0.f);
  uint32_t xy[3], zw[3];
#pragma unroll
  for (int pi = 0; pi < 3; ++pi) {
    xy[pi] = pack2(p[0].p[pi], p[1].p[pi]);
    zw[pi] = pack2(p[2].p[pi], pw.p[pi]);
    if (kV1b) {
      xy[pi] = scale2(xy[pi], -2.f, -2.f);
      zw[pi] = scale2(zw[pi], -2.f, 1.f);
    }
  }
  if constexpr (kThree) {
    uint4* r = reinterpret_cast<uint4*>(B.rec + j * exp_rec(true));
    r[0] = make_uint4(xy[0], xy[0], zw[0], zw[0]);   // w0 w4 w1 w5
    r[1] = make_uint4(xy[1], xy[2], zw[1], zw[2]);   // w2 w6 w3 w7
  } else {
    reinterpret_cast<uint2*>(B.rec)[j] = make_uint2(xy[0], zw[0]);
  }
  if constexpr (!kV1b && kThree) {   // pair m = j / 2: (r, r', r, r')
    B.rj2[4 * (j >> 1) + (j & 1)] = rj2;
    B.rj2[4 * (j >> 1) + 2 + (j & 1)] = rj2;
  } else if constexpr (!kV1b) {
    B.rj2[j] = rj2;
  }
  // piece pi of coordinate k at column 4 pi + k, this source's half of its
  // pair's word
  __nv_bfloat16* col = reinterpret_cast<__nv_bfloat16*>(
                           B.tcol + (j >> 4) * exp_cols(kThree) * 8) +
                       2 * tcol_slot((j & 15) >> 1) + (j & 1);
#pragma unroll
  for (int pi = 0; pi < (kThree ? 3 : 1); ++pi) {
#pragma unroll
    for (int k = 0; k < 3; ++k) col[(4 * pi + k) * 16] = p[k].p[pi];
  }
}

// The columns 1 and 0 of both stage buffers' column tables, written once.
template <bool kV1b, bool kThree>
__device__ __forceinline__ void exp_const_cols(ExpBuf<kV1b, kThree>& b0,
                                               ExpBuf<kV1b, kThree>& b1) {
  constexpr int TCOL = exp_cols(kThree) * 8;   // column-table words a chunk
  for (int k = threadIdx.x; k < 2 * EXP_CHUNKS * 16; k += EXP_NT) {
    const int ch = (k >> 4) % EXP_CHUNKS, w = k & 15;
    (k < EXP_CHUNKS * 16 ? b0 : b1)
        .tcol[ch * TCOL + (w < 8 ? 3 : exp_zero_col(kThree)) * 8 + (w & 7)] =
        w < 8 ? BF16_ONES : 0u;
  }
}

// One thread's share of a stage's expansion sources: the raw positions of
// sources j = threadIdx.x + r EXP_NT, loaded a stage ahead and built into
// the other buffer's records after the current stage's chunks.
struct ExpFetch {
  float rx[EXP_RB], ry[EXP_RB], rz[EXP_RB];

  // sources src0 + j of a stage of `stage` sources
  __device__ __forceinline__ void fetch(const float* pos, long long n,
                                        long long src0, int stage) {
#pragma unroll
    for (int r = 0; r < EXP_RB; ++r) {
      const int j = threadIdx.x + r * EXP_NT;
      if (j < stage) {
        const long long src = src0 + j;
        rx[r] = pos[src];
        ry[r] = pos[n + src];
        rz[r] = pos[2 * n + src];
      }
    }
  }

  template <bool kV1b, bool kThree>
  __device__ __forceinline__ void build(ExpBuf<kV1b, kThree>& B,
                                        int stage) const {
#pragma unroll
    for (int r = 0; r < EXP_RB; ++r) {
      const int j = threadIdx.x + r * EXP_NT;
      if (j < stage) exp_build<kV1b, kThree>(B, j, rx[r], ry[r], rz[r]);
    }
  }
};

// A warp's 32 targets in the expansion (two m16 row tiles; lane (g, t)):
// their A fragments and the lane's force sums. expand_kernel and
// hybrid_kernel run the same chunk, fold and finish.
template <bool kV1b, bool kThree>
struct ExpRows {
  using Buf = ExpBuf<kV1b, kThree>;
  int g, t;
  uint32_t ak16[EXP_MT][4];   // "highest": K slots 0-15 (words t, t + 4)
  uint32_t ak8[EXP_MT][2];    // "highest": K 16-23 (word 8 + t); "default" 0-7
  float ri2[EXP_MT][2];       // r_i² + eps2
  // v1b "highest": the first mma's C, r_i² + eps2 of rows g, g, g + 8,
  // g + 8; the copies are OR-ed with a zero the compiler cannot see (n <
  // 2^62), so the quad keeps registers of its own
  float cq[EXP_MT][4];
  // the force sums since the last fold, in the accumulator layout; run /
  // comp: the compensated totals of this lane's row g + 8 (t >> 1), F
  // columns 2 (t & 1) and 2 (t & 1) + 1
  float f[EXP_MT][4];
  float run[EXP_MT][2], comp[EXP_MT][2];

  // row (mt, hr) is target wbase + mt 16 + g + 8 hr; a warp past n (the
  // last CTA when n / 128 is odd) computes on target n - 1 and writes
  // nothing
  __device__ __forceinline__ ExpRows(const float* pos, long long n,
                                     long long wbase, float eps2) {
    g = (threadIdx.x & 31) >> 2;
    t = threadIdx.x & 3;
#pragma unroll
    for (int mt = 0; mt < EXP_MT; ++mt) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const long long row = wbase + mt * 16 + g + 8 * hr;
        const long long i = row < n ? row : n - 1;
        const float x = pos[i], y = pos[n + i], z = pos[2 * n + i];
        ri2[mt][hr] = __fadd_rn(r2(x, y, z), eps2);
        if constexpr (kV1b && kThree) {
          cq[mt][2 * hr] = ri2[mt][hr];
          cq[mt][2 * hr + 1] = __uint_as_float(
              __float_as_uint(ri2[mt][hr]) | (uint32_t)(n >> 62));
        }
        // v1 "highest": the pieces of -2 p_i (exactly -2 times p_i's), so
        // the first mma gives r_j² - 2 dot with r_j² as its C
        const float sc = !kV1b && kThree ? -2.f : 1.f;
        const Pieces v[4] = {split3(sc * x), split3(sc * y), split3(sc * z),
                             split3(kV1b ? 1.f : 0.f)};
        if constexpr (kThree) {
          ak16[mt][hr] = k_word<true>(v, t, true);
          ak16[mt][2 + hr] = k_word<true>(v, 4 + t, true);
          ak8[mt][hr] = k_word<true>(v, 8 + t, true);
        } else {
          ak8[mt][hr] = k_word<false>(v, t, true);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < EXP_MT; ++mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) f[mt][e] = 0.f;
      run[mt][0] = run[mt][1] = comp[mt][0] = comp[mt][1] = 0.f;
    }
  }

  // one chunk's first mma: d[mt][h] = A(mt) x B(chunk c, half h)
  __device__ __forceinline__ void first_mma(const Buf& B, int c,
                                            float (&d)[EXP_MT][2][4]) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float cj[4] = {};   // v1 "highest": r_j² of columns 2 t, 2 t + 1, twice
      if constexpr (!kV1b && kThree) {
        const float4 r = *reinterpret_cast<const float4*>(
            B.rj2 + exp_rj2_word(true, c, h, t));
        cj[0] = r.x;
        cj[1] = r.y;
        cj[2] = r.z;
        cj[3] = r.w;
      }
      uint2 b = make_uint2(0u, 0u);
      if constexpr (kThree) {
        b = *reinterpret_cast<const uint2*>(
            B.rec + exp_rec_word(true, c, h, g, t));
      } else {
        b.x = B.rec[exp_rec_word(false, c, h, g, t)];
      }
#pragma unroll
      for (int mt = 0; mt < EXP_MT; ++mt) {
        if constexpr (kThree && kV1b) {
          mma16816_c(d[mt][h], ak16[mt], b.x, b.y, cq[mt]);
        } else if constexpr (kThree) {
          mma16816_c(d[mt][h], ak16[mt], b.x, b.y, cj);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) d[mt][h][e] = 0.f;
        }
        mma1688(d[mt][h], ak8[mt], b.x);   // K words 8-11 repeat 0-3
      }
    }
  }

  // one chunk's rsqrt and force work on its first mma's d
  __device__ __forceinline__ void forces(const Buf& B, int c,
                                         const float (&d)[EXP_MT][2][4]) {
    float2 rj[2] = {};
    if constexpr (!kV1b && !kThree) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rj[h] = *reinterpret_cast<const float2*>(
            B.rj2 + exp_rj2_word(false, c, h, t));
      }
    }
    const uint2 bh = *reinterpret_cast<const uint2*>(
        B.tcol + exp_tcol_word(kThree, 1, c, g, t));
    uint2 bhm = bh, bl = bh;
    if constexpr (kThree) {
      bhm = *reinterpret_cast<const uint2*>(
          B.tcol + exp_tcol_word(true, 0, c, g, t));
      bl = *reinterpret_cast<const uint2*>(
          B.tcol + exp_tcol_word(true, 2, c, g, t));
    }
#pragma unroll
    for (int mt = 0; mt < EXP_MT; ++mt) {
      float s[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float r = ri2[mt][e >> 1];
          // v1b: dot + r_i² ("highest": the first mma's C adds r_i²);
          // v1: r_i² + (r_j² - 2 dot) ("highest": the first mma gives
          // r_j² - 2 dot)
          const float d2 =
              kV1b ? (kThree ? d[mt][h][e] : __fadd_rn(d[mt][h][e], r))
              : kThree ? __fadd_rn(r, d[mt][h][e])
                       : __fadd_rn(r, __fmaf_rn(-2.f, d[mt][h][e],
                                                (e & 1) ? rj[h].y : rj[h].x));
          s[h][e] = inv3_ftz(d2);
        }
      }
      uint32_t shi[4], smid[4], slo[4];
      split_s<kThree>(s, shi, smid, slo);
      if constexpr (kThree) {
        mma16816(f[mt], shi, bhm.x, bhm.y);    // hi·hi | hi·mid
        mma16816(f[mt], shi, bl.x, bl.y);      // hi·lo
        mma16816(f[mt], smid, bhm.x, bhm.y);   // mid·hi | mid·mid
        mma16816(f[mt], slo, bh.x, bh.y);      // lo·hi
      } else {
        mma16816(f[mt], shi, bh.x, bh.y);
      }
    }
  }

  // one 16-source chunk: its first mma just before its forces
  __device__ __forceinline__ void chunk(const Buf& B, int c) {
    float d[EXP_MT][2][4];
    first_mma(B, c, d);
    forces(B, c, d);
  }

  // the sums since the last fold into the totals: columns c + 4 of lane
  // t ^ 2 onto c, each lane adding the pair of the row it keeps
  __device__ __forceinline__ void fold() {
    const bool up = t & 2;   // this lane keeps row g + 8 (else row g)
#pragma unroll
    for (int mt = 0; mt < EXP_MT; ++mt) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float keep = up ? f[mt][2 + k] : f[mt][k];
        const float got =
            __shfl_xor_sync(FULL, up ? f[mt][k] : f[mt][2 + k], 2);
        kahan_add(run[mt][k], comp[mt][k], __fadd_rn(keep, got));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) f[mt][e] = 0.f;
    }
  }

  // a = m((e + F0..2) - p_i F3) into out [4, n]: lane t holds (Fx, Fy) (t
  // even) or (Fz, F3) (t odd) of row g + 8 (t >> 1); the even lane takes
  // the odd lane's pair and writes the target. With kElem, lane l's e is
  // the elementwise sum of target wbase + l (hybrid); else e is unused.
  template <bool kElem>
  __device__ __forceinline__ void finish(const float* pos, long long n,
                                         long long wbase, float* out,
                                         float mass,
                                         const float (&e)[3]) const {
#pragma unroll
    for (int mt = 0; mt < EXP_MT; ++mt) {
      const float f0 = run[mt][0] - comp[mt][0];
      const float f1 = run[mt][1] - comp[mt][1];
      const float o0 = __shfl_xor_sync(FULL, f0, 1);
      const float o1 = __shfl_xor_sync(FULL, f1, 1);
      const int row = mt * 16 + g + 8 * (t >> 1);
      float F[4] = {f0, f1, o0, o1};
      if constexpr (kElem) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          F[k] = __fadd_rn(__shfl_sync(FULL, e[k], row), F[k]);
        }
      }
      const long long i = wbase + row;
      if ((t & 1) == 0 && i < n) {
        const float p[3] = {pos[i], pos[n + i], pos[2 * n + i]};
        float a[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          a[k] = mass * __fsub_rn(F[k], __fmul_rn(p[k], F[3]));
        }
        out[i] = a[0];
        out[n + i] = a[1];
        out[2 * n + i] = a[2];
        out[3 * n + i] = amag(a[0], a[1], a[2]);
      }
    }
  }
};

template <bool kV1b, bool kThree>
__global__ void __launch_bounds__(EXP_NT, EXP_SM_WARPS / EXP_WARPS)
expand_kernel(const float* __restrict__ pos, long long n,
              float* __restrict__ out, float mass, float eps2) {
  using Buf = ExpBuf<kV1b, kThree>;
  extern __shared__ uint4 exp_smem[];
  Buf* const buf = reinterpret_cast<Buf*>(exp_smem);
  const int warp = threadIdx.x >> 5;
  const long long wbase =
      (long long)blockIdx.x * EXP_TARGETS + warp * (EXP_MT * 16);
  const int stage = exp_stage(n);
  const int nch = stage / 16;                  // chunks a stage (32, 16, 8)
  const long long nst = n / stage;

  exp_const_cols(buf[0], buf[1]);
  ExpFetch fx;
  fx.fetch(pos, n, 0, stage);
  fx.build(buf[0], stage);
  if (nst > 1) fx.fetch(pos, n, stage, stage);
  ExpRows<kV1b, kThree> rows(pos, n, wbase, eps2);
  __syncthreads();

  // chunks between folds: "highest" 8 (128 sources, whose sums in one
  // accumulator stay near float32's accuracy), "default" a stage
  const int per_fold = kThree ? EXP_FOLD : nch;
  for (long long st = 0; st < nst; ++st) {
    const Buf& B = buf[st & 1];
    for (int c0 = 0; c0 < nch; c0 += per_fold) {
      // eight chunks a body: the compiler interleaves one chunk's first
      // mma with the last one's force work
#pragma unroll 8
      for (int c = c0; c < c0 + per_fold; ++c) rows.chunk(B, c);
      rows.fold();
    }
    if (st + 1 < nst) {
      fx.build(buf[(st + 1) & 1], stage);
      if (st + 2 < nst) fx.fetch(pos, n, (st + 2) * stage, stage);
    }
    __syncthreads();
  }
  const float unused[3] = {};
  rows.template finish<false>(pos, n, wbase, out, mass, unused);
}

// ---------------------------------------------------------------------------
// hybrid: of each group of three tj-tiles, tiles 0-1 elementwise (v0's
// pair terms, the lane's own target) and tile 2 through v1b's "highest"
// expansion (ExpRows<true, true>), both in one loop body. The CTA is the
// expansion's (EXP_WARPS warps of 32 targets, EXP_SM_WARPS an SM); a stage
// holds S = hyb_stage(tj) sources of tile 2 and the 2 S sources of tiles
// 0-1 beside them, and each loop body takes one 16-source expansion chunk
// (512 pairs a warp) and 32 elementwise sources (1,024 pairs a warp), so
// the FP32 and MUFU pipes work while the chunk's mma results are in flight.
// ---------------------------------------------------------------------------

constexpr int HYB_STAGE = EXP_STAGE;   // expansion sources a stage (at most)
constexpr int HYB_ELEM = 32;           // elementwise sources a loop body

// Expansion sources a stage: HYB_STAGE, or its half or quarter, whichever
// divides tj (a stage never straddles two groups).
__host__ __device__ constexpr int hyb_stage(int tj) {
  return tj % HYB_STAGE == 0         ? HYB_STAGE
         : tj % (HYB_STAGE / 2) == 0 ? HYB_STAGE / 2
                                     : HYB_STAGE / 4;
}
// The global index of stage s's source j (of 3 S): j < 2 S the elementwise
// sources, the (s mod tj / S)-th 2 S of the group's tiles 0-1; then the S
// expansion sources, the (s mod tj / S)-th S of its tile 2. The group is
// s / (tj / S).
__host__ __device__ constexpr long long hyb_source(int tj, long long s,
                                                   int j) {
  const int S = hyb_stage(tj);
  const long long spt = tj / S;   // stages a tile
  const long long g0 = s / spt * 3 * (long long)tj, k = s % spt;
  return j < 2 * S ? g0 + k * 2 * S + j : g0 + 2LL * tj + k * S + (j - 2 * S);
}
// The first word of the u-th float4 (u < HYB_ELEM / 4) a lane reads of each
// elementwise plane in loop body c: every lane the same (a broadcast).
__host__ __device__ constexpr int hyb_elem_word(int c, int u) {
  return c * HYB_ELEM + 4 * u;
}

// One staged buffer: the expansion's records and column table, then the
// elementwise sources' x, y and z planes.
struct alignas(16) HybBuf {
  ExpBuf<true, true> x;
  float e[3][2 * HYB_STAGE];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// Stage s's 2 S elementwise positions into B's planes: 16-byte copies that
// hold no registers while they fly (pos 16-byte aligned, n % 128 == 0).
__device__ __forceinline__ void hyb_stage_elem(HybBuf& B, const float* pos,
                                               long long n, int tj,
                                               long long s) {
  const int S = hyb_stage(tj);
  const int q = S / 2;   // float4 a plane
  const long long e0 = hyb_source(tj, s, 0);
  for (int k = threadIdx.x; k < 3 * q; k += EXP_NT) {
    const int c = k / q, w = 4 * (k - c * q);
    cp_async16(B.e[c] + w, pos + c * n + e0 + w);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The 32 elementwise sources of loop body c against (xi, yi, zi): v0's
// pair terms, the rsqrt without a guard (d² >= eps2 > 0: bitwise rsqrtf).
__device__ __forceinline__ void hyb_elem(const HybBuf& B, int c, float xi,
                                         float yi, float zi, float eps2,
                                         float (&acc)[3]) {
#pragma unroll
  for (int u = 0; u < HYB_ELEM / 4; ++u) {
    const int w = hyb_elem_word(c, u);
    const float4 x4 = *reinterpret_cast<const float4*>(B.e[0] + w);
    const float4 y4 = *reinterpret_cast<const float4*>(B.e[1] + w);
    const float4 z4 = *reinterpret_cast<const float4*>(B.e[2] + w);
    const float px[4] = {x4.x, x4.y, x4.z, x4.w};
    const float py[4] = {y4.x, y4.y, y4.z, y4.w};
    const float pz[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float dx = px[k] - xi;
      const float dy = py[k] - yi;
      const float dz = pz[k] - zi;
      const float d2 = dx * dx + dy * dy + dz * dz + eps2;
      const float s = inv3_ftz(d2);
      acc[0] += dx * s;
      acc[1] += dy * s;
      acc[2] += dz * s;
    }
  }
}

__global__ void __launch_bounds__(EXP_NT, EXP_SM_WARPS / EXP_WARPS)
hybrid_kernel(const float* __restrict__ pos, long long n, int tj,
              float* __restrict__ out, float mass, float eps2) {
  extern __shared__ uint4 hyb_smem[];
  HybBuf* const buf = reinterpret_cast<HybBuf*>(hyb_smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long wbase =
      (long long)blockIdx.x * EXP_TARGETS + warp * (EXP_MT * 16);
  const int S = hyb_stage(tj);
  const int nch = S / 16;                  // bodies (and chunks) a stage
  const long long nst = n / (3 * S);

  exp_const_cols(buf[0].x, buf[1].x);
  hyb_stage_elem(buf[0], pos, n, tj, 0);
  ExpFetch fx;
  fx.fetch(pos, n, hyb_source(tj, 0, 2 * S), S);
  fx.build(buf[0].x, S);
  if (nst > 1) fx.fetch(pos, n, hyb_source(tj, 1, 2 * S), S);
  ExpRows<true, true> rows(pos, n, wbase, eps2);
  // the lane's own target in the elementwise tiles (clamped past n): the
  // sums since the last fold, and their compensated totals
  const long long ie = wbase + lane < n ? wbase + lane : n - 1;
  const float xi = pos[ie], yi = pos[n + ie], zi = pos[2 * n + ie];
  float ep[3] = {0.f, 0.f, 0.f}, es[3] = {0.f, 0.f, 0.f},
        ec[3] = {0.f, 0.f, 0.f};
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  for (long long st = 0; st < nst; ++st) {
    const HybBuf& B = buf[st & 1];
    if (st + 1 < nst) hyb_stage_elem(buf[(st + 1) & 1], pos, n, tj, st + 1);
    for (int c0 = 0; c0 < nch; c0 += EXP_FOLD) {
#pragma unroll 1
      for (int c = c0; c < c0 + EXP_FOLD; ++c) {
        rows.chunk(B.x, c);
        hyb_elem(B, c, xi, yi, zi, eps2, ep);
      }
      // every 128 expansion and 256 elementwise sources
      rows.fold();
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        kahan_add(es[k], ec[k], ep[k]);
        ep[k] = 0.f;
      }
    }
    if (st + 1 < nst) {
      fx.build(buf[(st + 1) & 1].x, S);
      if (st + 2 < nst) fx.fetch(pos, n, hyb_source(tj, st + 2, 2 * S), S);
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
  }
  const float e[3] = {es[0] - ec[0], es[1] - ec[1], es[2] - ec[2]};
  rows.finish<true>(pos, n, wbase, out, mass, e);
}

// ---------------------------------------------------------------------------
// v3: each (ti-block, tj-tile) pair centred on c = (c_i + c_j) / 2; q split
// into bf16 hi + lo; dot = the four split products in one K = 16 mma
// (groups [hi_i | lo_i | hi_i | lo_i] x [hi_j | hi_j | lo_j | lo_j]);
// d² = (r_i² - 2 dot) + r_j²; each tj-tile's force sums are added to the
// targets' float32 sums after the tile, as the JAX kernel's carry.
//
// - A CTA is 4 warps (128 targets, within one ti-block since ti % 128 ==
//   0); a warp owns 32 targets as two m16 tiles. The launch bounds ask for
//   five CTAs, 20 warps an SM (at most 102 registers a thread): on an H100
//   that beat two 8-warp CTAs (16 warps) and three (24), whose wider CTAs
//   halve the staging a pair.
// - Sources are staged V3_STAGE = 512 at a time (256 or 128 when that
//   does not divide tj, so that a stage never straddles two j-tiles), into
//   two buffers: while the CTA computes on one, every thread has already
//   loaded the next stage's raw positions (one source a thread a round)
//   and builds their records into the other after its chunks; one barrier
//   a stage.
// - The staged records are read as 64-bit words with no bank conflicts:
//   a source's first-mma B is the 4 words [H01 L01 H2 L2] (H01 = (hi x,
//   hi y), H2 = (hi z, 0), L the lo pieces), since K words t and t + 4 of
//   the record are H01 L01 (t even) or H2 L2 (t odd); the second mma's B
//   is 8 columns [hi x y z | 1 | lo x y z | 0] of 8 source-pair words a
//   chunk, stored w0 w4 w1 w5 w2 w6 w3 w7 so lane (g, t) reads (w_t,
//   w_t+4) at 8 g + 2 t. The columns 1 and 0 are written once. mm_split's
//   B_l = [hi x y z | 1] twice is the table's columns g & 3.
// - The chunk loop is software-pipelined: the next chunk's B words are
//   loaded and its first mma issued before this chunk's rsqrt and force
//   work (two chunks a step, unrolled twice: four a loop body; a stage's
//   last look-ahead re-reads chunk 0 and is dropped). Each force
//   accumulator takes one mma a chunk, a chunk's work apart, so the chain
//   is not split.
// - rsqrt.approx.ftz (`inv3_ftz`): d² can cancel below ε² here.
// - At a tile's end each quad folds its lanes' partial sums (xor 1, then
//   xor 2: the pairs' order), ending with lane t holding target (t >> 1,
//   t & 1)'s (f3, fs) and carry. The fold order is fixed: bitwise the same
//   from run to run, and the same bits as one lane a quad summing them.
// ---------------------------------------------------------------------------

enum ForcePath { kVpu = 0, kMmSplit = 1, kMmBf16 = 2 };

constexpr int V3_STAGE = 512;              // sources a stage (less if tj % 512)
constexpr int V3_CHUNKS = V3_STAGE / 16;   // 16-source chunks a full stage
constexpr int V3_REC = 4;                  // record words a source
constexpr int V3_TCOL = 64;                // column-table words a chunk
constexpr int V3_WARPS = 4;                // warps a CTA
constexpr int V3_MT = 2;                   // m16 row tiles a warp
constexpr int V3_NT = V3_WARPS * 32;       // targets (threads) a CTA
constexpr int V3_SM_WARPS = 20;            // warps an SM the bounds ask for

// One staged buffer; `c` is its stage's centre (x, y, z, 0).
template <int PATH>
struct V3Buf {                              // the mm paths
  uint32_t rec[V3_STAGE * V3_REC];
  uint32_t tcol[V3_CHUNKS * V3_TCOL];
  float rj2[V3_STAGE];
  float4 c;
};
template <>
struct V3Buf<kVpu> {
  uint32_t rec[V3_STAGE * V3_REC];
  float4 q[V3_STAGE];                       // (qx, qy, qz, r_j²)
  float4 c;
};

template <int PATH>
struct V3Smem {
  V3Buf<PATH> buf[2];
  float4 tp[V3_NT];                         // the CTA's targets (x, y, z, 0)
};

// v3's shared-memory layout as the kernel indexes it; the `apv_v3_*`
// exports give it to the library, which checks `ops/allpairs_variants.py`'s
// mirror against it when it loads.
// Sources a stage: V3_STAGE, or its half or quarter when that divides tj.
__host__ __device__ constexpr int v3_stage(int tj) {
  return tj % V3_STAGE == 0         ? V3_STAGE
         : tj % (V3_STAGE / 2) == 0 ? V3_STAGE / 2
                                    : V3_STAGE / 4;
}
// The first record word of lane (g, t)'s 64-bit first-mma B load (chunk c,
// half h): source g's words t and t + 4 of K, at 2 (t & 1) of its record.
__host__ __device__ constexpr int v3_rec_word(int c, int h, int g, int t) {
  return (c * 16 + h * 8 + g) * V3_REC + 2 * (t & 1);
}
// Word `slot` of column `col` of chunk c's column table.
__host__ __device__ constexpr int v3_tcol_at(int c, int col, int slot) {
  return c * V3_TCOL + col * 8 + slot;
}
// The first word of lane (g, t)'s 64-bit second-mma B load: column g
// (mm_split's B_l, `low`: column g & 3), slots 2 t and 2 t + 1, which hold
// source-pair words t and t + 4.
__host__ __device__ constexpr int v3_tcol_word(int c, bool low, int g,
                                               int t) {
  return v3_tcol_at(c, low ? g & 3 : g, 2 * t);
}
// vpu: the source whose (q, r_j²) lane t loads for its half h and column
// parity u of chunk c.
__host__ __device__ constexpr int v3_q_source(int c, int h, int t, int u) {
  return c * 16 + h * 8 + 2 * t + u;
}

// (hi, lo) words of a pair of coordinates: hi = bf16(a, b), lo = bf16 of
// the remainders
__device__ __forceinline__ uint2 split_word(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  return make_uint2(as_u32(h), as_u32(__floats2bfloat162_rn(
                                   __fsub_rn(a, hf.x), __fsub_rn(b, hf.y))));
}

// Build source j's records of a stage in B, centred on c, from its raw
// position (x, y, z). Called by whole warps on consecutive j: the column
// table's words hold a source pair (j even, j + 1), so the even lane writes
// the pair's hi columns and the odd lane its lo columns, each taking its
// partner's half over one shuffle.
template <int PATH>
__device__ __forceinline__ void v3_build(V3Buf<PATH>& B, int j, float4 c,
                                         float x, float y, float z) {
  const float q[3] = {__fsub_rn(x, c.x), __fsub_rn(y, c.y),
                      __fsub_rn(z, c.z)};
  const uint2 w01 = split_word(q[0], q[1]);   // (hi, lo) of (x, y)
  const uint2 w2 = split_word(q[2], 0.f);     // (hi, lo) of (z, 0)
  const float rj2 = r2(q[0], q[1], q[2]);
  reinterpret_cast<uint4*>(B.rec)[j] = make_uint4(w01.x, w01.y, w2.x, w2.y);
  if constexpr (PATH == kVpu) {
    B.q[j] = make_float4(q[0], q[1], q[2], rj2);
  } else {
    B.rj2[j] = rj2;
    const bool odd = j & 1;
    const uint32_t p01 = __shfl_xor_sync(FULL, odd ? w01.x : w01.y, 1);
    const uint32_t p2 = __shfl_xor_sync(FULL, odd ? w2.x : w2.y, 1);
    // (source j & ~1, source j | 1) halves of this lane's columns
    const uint32_t e01 = odd ? p01 : w01.x, o01 = odd ? w01.y : p01;
    const uint32_t e2 = odd ? p2 : w2.x, o2 = odd ? w2.y : p2;
    // pair m = (j & 15) / 2 of chunk j / 16 sits at slot tcol_slot(m)
    const int m = (j & 15) >> 1;
    uint32_t* col =
        B.tcol + v3_tcol_at(j >> 4, odd ? 4 : 0, tcol_slot(m));
    col[0] = __byte_perm(e01, o01, 0x5410);    // x
    col[8] = __byte_perm(e01, o01, 0x7632);    // y
    col[16] = __byte_perm(e2, o2, 0x5410);     // z
  }
}

template <int PATH>
__global__ void __launch_bounds__(V3_NT, V3_SM_WARPS / V3_WARPS)
v3_kernel(const float* __restrict__ pos, long long n,
          const float* __restrict__ ci, int ti, const float* __restrict__ cj,
          int tj, float* __restrict__ out, float mass, float eps2) {
  constexpr int NT = V3_NT;
  __shared__ V3Smem<PATH> sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mo = t >> 1, ho = t & 1;       // the target this lane ends with
  const long long cbase = (long long)blockIdx.x * NT;
  const long long nti = n / ti, ntj = n / tj;
  const long long blk = cbase / ti;
  const float3 c_i = make_float3(ci[blk], ci[nti + blk], ci[2 * nti + blk]);
  const int stage = v3_stage(tj);
  const int nch = stage / 16;                // chunks a stage (32, 16, 8)
  const long long nst = n / stage, per_tile = tj / stage;
  // a thread stages sources threadIdx.x + r NT, r < rounds (the stage is a
  // multiple of NT)
  constexpr int RB = V3_STAGE / NT;
  const int rounds = stage / NT;

  {
    const long long i = cbase + threadIdx.x;
    sm.tp[threadIdx.x] = make_float4(pos[i], pos[n + i], pos[2 * n + i], 0.f);
  }
  if constexpr (PATH != kVpu) {   // the columns 1 (3) and 0 (7), once
    for (int k = threadIdx.x; k < 2 * V3_CHUNKS * 16; k += NT) {
      const int b = k / (V3_CHUNKS * 16), ch = (k >> 4) % V3_CHUNKS,
                w = k & 15;
      sm.buf[b].tcol[v3_tcol_at(ch, w < 8 ? 3 : 7, w & 7)] =
          w < 8 ? BF16_ONES : 0u;
    }
  }
  // this thread's raw sources and the j-centroid of the next stage
  float rx[RB], ry[RB], rz[RB];
  float3 c_j = {};
  auto fetch = [&](long long s) {
    const long long j0 = s * stage + threadIdx.x, b = s * stage / tj;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < rounds) {
        rx[r] = pos[j0 + r * NT];
        ry[r] = pos[n + j0 + r * NT];
        rz[r] = pos[2 * n + j0 + r * NT];
      }
    }
    c_j = make_float3(cj[b], cj[ntj + b], cj[2 * ntj + b]);
  };
  auto build = [&](V3Buf<PATH>& B) {
    const float4 c = make_float4(0.5f * (c_i.x + c_j.x),
                                 0.5f * (c_i.y + c_j.y),
                                 0.5f * (c_i.z + c_j.z), 0.f);
    if (threadIdx.x == 0) B.c = c;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < rounds) {
        v3_build<PATH>(B, threadIdx.x + r * NT, c, rx[r], ry[r], rz[r]);
      }
    }
  };
  fetch(0);
  build(sm.buf[0]);
  if (nst > 1) fetch(1);
  __syncthreads();

  float ri2[V3_MT][2];      // r_i² + eps2 of rows (mt, g + 8 hr)
  // the first mma's A quad of each m-tile: words of rows g, g + 8, then
  // the same again (K slots 8-15 repeat 0-7). The copies are OR-ed with a
  // zero the compiler cannot see (n < 2^62), so they keep registers of
  // their own and the quad stays in place; else the compiler re-copies two
  // of its registers before every mma.
  uint32_t aq[V3_MT][4];
  const uint32_t opaque0 = (uint32_t)(n >> 62);
  float qo[3] = {0.f, 0.f, 0.f}, acc[3] = {0.f, 0.f, 0.f};
  float fv[V3_MT][2][4];    // vpu: (f3, fs) partials of rows (mt, hr)
  float fh[V3_MT][4], fl[V3_MT][4];   // mm: accumulators
  const float4* tp = sm.tp + warp * 32;

  // one chunk's first mma: d[mt][h] = A(mt) x B(chunk c, half h)
  auto first_mma = [&](const V3Buf<PATH>& B, int c, float (&d)[V3_MT][2][4]) {
    uint2 b[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      b[h] = *reinterpret_cast<const uint2*>(B.rec + v3_rec_word(c, h, g, t));
    }
#pragma unroll
    for (int mt = 0; mt < V3_MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 4; ++e) d[mt][h][e] = 0.f;
        mma16816(d[mt][h], aq[mt], b[h].x, b[h].y);
      }
    }
  };
  // one chunk's rsqrt and force work on its first mma's d
  auto forces = [&](const V3Buf<PATH>& B, int c,
                    const float (&d)[V3_MT][2][4]) {
    if constexpr (PATH == kVpu) {
      float4 q[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        q[h][0] = B.q[v3_q_source(c, h, t, 0)];
        q[h][1] = B.q[v3_q_source(c, h, t, 1)];
      }
#pragma unroll
      for (int mt = 0; mt < V3_MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4 qj = q[h][e & 1];
            const float s = inv3_ftz(__fadd_rn(
                __fmaf_rn(-2.f, d[mt][h][e], ri2[mt][e >> 1]), qj.w));
            float* f = fv[mt][e >> 1];
            f[0] = __fmaf_rn(qj.x, s, f[0]);
            f[1] = __fmaf_rn(qj.y, s, f[1]);
            f[2] = __fmaf_rn(qj.z, s, f[2]);
            f[3] = __fadd_rn(f[3], s);
          }
        }
      }
    } else {
      float2 rj[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rj[h] = *reinterpret_cast<const float2*>(B.rj2 +
                                                 v3_q_source(c, h, t, 0));
      }
      const uint2 bh = *reinterpret_cast<const uint2*>(
          B.tcol + v3_tcol_word(c, false, g, t));
      uint2 bl = make_uint2(0u, 0u);
      if constexpr (PATH == kMmSplit) {
        bl = *reinterpret_cast<const uint2*>(B.tcol +
                                             v3_tcol_word(c, true, g, t));
      }
#pragma unroll
      for (int mt = 0; mt < V3_MT; ++mt) {
        float s[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float r = (e & 1) ? rj[h].y : rj[h].x;
            s[h][e] = inv3_ftz(__fadd_rn(
                __fmaf_rn(-2.f, d[mt][h][e], ri2[mt][e >> 1]), r));
          }
        }
        uint32_t shi[4], sunused[4], slo[4];
        split_s<false>(s, shi, sunused, slo);
        mma16816(fh[mt], shi, bh.x, bh.y);
        if constexpr (PATH == kMmSplit) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {  // s - bf16(s), to bf16
            // the bf16 halves as floats: one shift, one mask
            const float h0 = __uint_as_float(shi[k] << 16);
            const float h1 = __uint_as_float(shi[k] & 0xffff0000u);
            slo[k] = as_u32(__floats2bfloat162_rn(
                __fsub_rn(s[k >> 1][(k & 1) * 2], h0),
                __fsub_rn(s[k >> 1][(k & 1) * 2 + 1], h1)));
          }
          mma16816(fl[mt], slo, bl.x, bl.y);
        }
      }
    }
  };

  for (long long st = 0; st < nst; ++st) {
    const V3Buf<PATH>& B = sm.buf[st & 1];
    if (st % per_tile == 0) {  // a new j-tile: re-centre the targets
      const float4 c = B.c;
#pragma unroll
      for (int mt = 0; mt < V3_MT; ++mt) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float4 p = tp[mt * 16 + g + 8 * hr];
          const float q[3] = {__fsub_rn(p.x, c.x), __fsub_rn(p.y, c.y),
                              __fsub_rn(p.z, c.z)};
          ri2[mt][hr] = __fadd_rn(r2(q[0], q[1], q[2]), eps2);
          // A word t: (hi x, hi y), (hi z, 0), (lo x, lo y), (lo z, 0)
          const uint2 w = split_word((t & 1) ? q[2] : q[0],
                                     (t & 1) ? 0.f : q[1]);
          aq[mt][hr] = (t & 2) ? w.y : w.x;
          aq[mt][2 + hr] = aq[mt][hr] | opaque0;
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            qo[k] = mt == mo && hr == ho ? q[k] : qo[k];
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) fv[mt][hr][e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) fh[mt][e] = fl[mt][e] = 0.f;
      }
    }
    float d0[V3_MT][2][4], d1[V3_MT][2][4];
    first_mma(B, 0, d0);
#pragma unroll 2
    for (int c = 0; c < nch; c += 2) {
      first_mma(B, c + 1, d1);
      forces(B, c, d0);
      first_mma(B, (c + 2) & (nch - 1), d0);   // the last body's is dropped
      forces(B, c + 1, d1);
    }
    if (st + 1 < nst) {
      build(sm.buf[(st + 1) & 1]);
      if (st + 2 < nst) fetch(st + 2);
    }
    if ((st + 1) % per_tile == 0) {  // the tile's end: acc += f3 - q_i fs
      float f3[3], fs;
      if constexpr (PATH == kVpu) {
        // xor 1 keeps row hr = ho, xor 2 m-tile mo
        float k8[V3_MT][4];
#pragma unroll
        for (int mt = 0; mt < V3_MT; ++mt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float keep = ho ? fv[mt][1][e] : fv[mt][0][e];
            const float send = ho ? fv[mt][0][e] : fv[mt][1][e];
            k8[mt][e] = __fadd_rn(keep, __shfl_xor_sync(FULL, send, 1));
          }
        }
        float k4[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float keep = mo ? k8[1][e] : k8[0][e];
          const float send = mo ? k8[0][e] : k8[1][e];
          k4[e] = __fadd_rn(keep, __shfl_xor_sync(FULL, send, 2));
        }
        f3[0] = k4[0];
        f3[1] = k4[1];
        f3[2] = k4[2];
        fs = k4[3];
      } else {
        // columns c + 4 of lane t ^ 2 onto c: lanes t = 0, 2 hold (fx, fy),
        // t = 1, 3 (fz, fs) of rows g (e 0, 1) and g + 8 (e 2, 3)
        float v[V3_MT][4];
#pragma unroll
        for (int mt = 0; mt < V3_MT; ++mt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            v[mt][e] = __fadd_rn(fh[mt][e],
                                 __shfl_xor_sync(FULL, fh[mt][e], 2));
            if (PATH == kMmSplit) v[mt][e] = __fadd_rn(v[mt][e], fl[mt][e]);
          }
        }
        // this lane's pair for its target, and the other pair from t ^ 1
        float own[2], got[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float lo = mo ? v[1][k] : v[0][k];
          const float hi = mo ? v[1][2 + k] : v[0][2 + k];
          own[k] = ho ? hi : lo;
          got[k] = __shfl_xor_sync(FULL, ho ? lo : hi, 1);
        }
        const bool xy = (t & 1) == 0;
        f3[0] = xy ? own[0] : got[0];
        f3[1] = xy ? own[1] : got[1];
        f3[2] = xy ? got[0] : own[0];
        fs = xy ? got[1] : own[1];
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        acc[k] = __fadd_rn(acc[k], __fsub_rn(f3[k], __fmul_rn(qo[k], fs)));
      }
    }
    __syncthreads();
  }
  const long long i = cbase + warp * 32 + mo * 16 + g + 8 * ho;
  const float a[3] = {mass * acc[0], mass * acc[1], mass * acc[2]};
  out[i] = a[0];
  out[n + i] = a[1];
  out[2 * n + i] = a[2];
  out[3 * n + i] = amag(a[0], a[1], a[2]);
}

bool bad_n(long long n) { return n <= 0 || n % TILE != 0; }

int launched() { return static_cast<int>(cudaGetLastError()); }

template <bool kV1b, bool kThree>
int launch_expand(const float* p, long long n, float* o, float mass,
                  float eps2, cudaStream_t st) {
  constexpr int smem = 2 * (int)sizeof(ExpBuf<kV1b, kThree>);
  const cudaError_t e = cudaFuncSetAttribute(
      expand_kernel<kV1b, kThree>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  expand_kernel<kV1b, kThree>
      <<<(unsigned)((n + EXP_TARGETS - 1) / EXP_TARGETS), EXP_NT, smem, st>>>(
          p, n, o, mass, eps2);
  return launched();
}

}  // namespace

// The tile N must be a multiple of (the wrappers' rule).
extern "C" int apv_tile() { return TILE; }

// attr (mode 0 full, 1 norsqrt, 2 noaccum; out [n, 4], unscaled) and unroll
// (mode 3; out [4, n], times mass). pos [4, n] float32.
extern "C" int apv_elem(const void* pos, long long n, void* out, int mode,
                        float mass, float eps2, void* stream) {
  if (bad_n(n) || mode < 0 || mode > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pos);
  float* o = static_cast<float*>(out);
  const unsigned blocks = (unsigned)(n / TILE);
  switch (mode) {
    case kFull: elem_kernel<kFull><<<blocks, TILE, 0, st>>>(p, n, o, mass, eps2); break;
    case kNoRsqrt: elem_kernel<kNoRsqrt><<<blocks, TILE, 0, st>>>(p, n, o, mass, eps2); break;
    case kNoAccum: elem_kernel<kNoAccum><<<blocks, TILE, 0, st>>>(p, n, o, mass, eps2); break;
    default: elem_kernel<kUnroll><<<blocks, TILE, 0, st>>>(p, n, o, mass, eps2); break;
  }
  return launched();
}

// v4: out [n, 4].
extern "C" int apv_plane(const void* pos, long long n, void* out, float mass,
                         float eps2, void* stream) {
  if (bad_n(n)) return static_cast<int>(cudaErrorInvalidValue);
  plane_kernel<<<(unsigned)(n / PLANE_TARGETS), PLANE_WARPS * 32, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), n, static_cast<float*>(out), mass,
      eps2);
  return launched();
}

// v1b (v1b = 1) or v1 (0), at "highest" (1) or "default" (0): out [4, n].
extern "C" int apv_expand(const void* pos, long long n, void* out, int v1b,
                          int highest, float mass, float eps2, void* stream) {
  if (bad_n(n)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pos);
  float* o = static_cast<float*>(out);
  if (v1b && highest) return launch_expand<true, true>(p, n, o, mass, eps2, st);
  if (v1b) return launch_expand<true, false>(p, n, o, mass, eps2, st);
  if (highest) return launch_expand<false, true>(p, n, o, mass, eps2, st);
  return launch_expand<false, false>(p, n, o, mass, eps2, st);
}

// The expansion's warps a CTA (sm = 0) and an SM (sm = 1, its launch
// bounds' ask) and m16 row tiles a warp (sm = 2); `ops/allpairs_variants.py`'s
// EXPAND_WARPS / EXPAND_SM_WARPS / EXPAND_MT mirror them.
extern "C" int apv_expand_warps(int sm) {
  return sm == 0 ? EXP_WARPS : sm == 1 ? EXP_SM_WARPS : EXP_MT;
}

// Dynamic shared memory of an expansion CTA: its two stage buffers
// (`expand_smem_bytes` mirrors it).
extern "C" int apv_expand_smem(int v1b, int highest) {
  if (v1b) {
    return 2 * (highest ? (int)sizeof(ExpBuf<true, true>)
                        : (int)sizeof(ExpBuf<true, false>));
  }
  return 2 * (highest ? (int)sizeof(ExpBuf<false, true>)
                      : (int)sizeof(ExpBuf<false, false>));
}

// The layout (the functions above), for the check of its host mirror
// (`expand_stage`, `expand_rec_words`, `expand_tcol_words`,
// `expand_rj2_words`); lane = 4 g + t.
extern "C" int apv_expand_stage(long long n) { return exp_stage(n); }
extern "C" int apv_expand_rec_word(int highest, int c, int h, int lane) {
  return exp_rec_word(highest != 0, c, h, lane >> 2, lane & 3);
}
extern "C" int apv_expand_tcol_word(int highest, int which, int c, int lane) {
  return exp_tcol_word(highest != 0, which, c, lane >> 2, lane & 3);
}
extern "C" int apv_expand_rj2_word(int highest, int c, int h, int lane) {
  return exp_rj2_word(highest != 0, c, h, lane & 3);
}

// hybrid: tj-tiles (tj a multiple of TILE, n / tj a multiple of 3); of
// each group of three, tiles 0-1 elementwise, tile 2 v1b "highest". pos
// 16-byte aligned (the elementwise sources are staged by 16-byte copies).
extern "C" int apv_hybrid(const void* pos, long long n, int tj, void* out,
                          float mass, float eps2, void* stream) {
  if (bad_n(n) || tj <= 0 || tj % TILE || n % tj || (n / tj) % 3 ||
      reinterpret_cast<uintptr_t>(pos) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int smem = 2 * (int)sizeof(HybBuf);
  const cudaError_t e = cudaFuncSetAttribute(
      hybrid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  hybrid_kernel<<<(unsigned)((n + EXP_TARGETS - 1) / EXP_TARGETS), EXP_NT,
                  smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), n, tj, static_cast<float*>(out), mass,
      eps2);
  return launched();
}

// hybrid's warps a CTA (sm = 0), an SM (sm = 1, its launch bounds' ask) and
// m16 row tiles a warp (sm = 2): the expansion's (`EXPAND_WARPS`,
// `EXPAND_SM_WARPS`, `EXPAND_MT` mirror them).
extern "C" int apv_hybrid_warps(int sm) {
  return sm == 0 ? EXP_WARPS : sm == 1 ? EXP_SM_WARPS : EXP_MT;
}

// Dynamic shared memory of a hybrid CTA: its two stage buffers
// (`ops/allpairs_variants.py::hybrid_smem_bytes` mirrors it).
extern "C" int apv_hybrid_smem() { return 2 * (int)sizeof(HybBuf); }

// hybrid's stages and elementwise loads (the functions above), for the
// check of its host mirror (`hybrid_stage`, `hybrid_source`,
// `hybrid_elem_words`).
extern "C" int apv_hybrid_stage(int tj) { return hyb_stage(tj); }
extern "C" long long apv_hybrid_source(int tj, long long s, int j) {
  return hyb_source(tj, s, j);
}
extern "C" int apv_hybrid_elem_word(int c, int u) {
  return hyb_elem_word(c, u);
}

// v3's warps a CTA (sm = 0) and an SM (sm = 1, its launch bounds' ask);
// `ops/allpairs_variants.py::V3_WARPS` / `V3_SM_WARPS` mirror them.
extern "C" int apv_v3_warps(int sm) { return sm ? V3_SM_WARPS : V3_WARPS; }

// Static shared memory of a v3 CTA on force path `path` (`v3_smem_bytes`
// mirrors it; its stage buffers do not depend on tj).
extern "C" int apv_v3_smem(int path) {
  return path == kVpu ? (int)sizeof(V3Smem<kVpu>)
                      : (int)sizeof(V3Smem<kMmSplit>);
}

// v3's layout (the functions above), for the check of its host mirror
// (`ops/allpairs_variants.py::v3_stage`, `v3_rec_words`, `v3_tcol_words`,
// `v3_tcol_slot`, `v3_q_sources`); lane = 4 g + t.
extern "C" int apv_v3_stage(int tj) { return v3_stage(tj); }
extern "C" int apv_v3_rec_word(int c, int h, int lane) {
  return v3_rec_word(c, h, lane >> 2, lane & 3);
}
extern "C" int apv_v3_tcol_word(int c, int low, int lane) {
  return v3_tcol_word(c, low != 0, lane >> 2, lane & 3);
}
extern "C" int apv_v3_tcol_slot(int m) { return tcol_slot(m); }
extern "C" int apv_v3_q_source(int c, int h, int lane, int u) {
  return v3_q_source(c, h, lane & 3, u);
}

// v3: ci [3, n / ti] and cj [3, n / tj] tile centroids; path 0 vpu,
// 1 mm_split, 2 mm_bf16; out [4, n].
extern "C" int apv_v3(const void* pos, long long n, const void* ci, int ti,
                      const void* cj, int tj, void* out, int path, float mass,
                      float eps2, void* stream) {
  if (bad_n(n) || ti <= 0 || tj <= 0 || ti % TILE || tj % TILE || n % ti ||
      n % tj || path < 0 || path > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pos);
  const float* a = static_cast<const float*>(ci);
  const float* b = static_cast<const float*>(cj);
  float* o = static_cast<float*>(out);
  const unsigned blocks = (unsigned)(n / V3_NT);
  switch (path) {
    case kVpu: v3_kernel<kVpu><<<blocks, V3_NT, 0, st>>>(p, n, a, ti, b, tj, o, mass, eps2); break;
    case kMmSplit: v3_kernel<kMmSplit><<<blocks, V3_NT, 0, st>>>(p, n, a, ti, b, tj, o, mass, eps2); break;
    default: v3_kernel<kMmBf16><<<blocks, V3_NT, 0, st>>>(p, n, a, ti, b, tj, o, mass, eps2); break;
  }
  return launched();
}
