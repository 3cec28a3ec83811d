// All-pairs A/B variants of the directed rectangle: elementwise forms, and
// the port's tensor-core expansion forms (mma.sync, BF16 in, FP32 sums).
//
// Replaces the TPU kernels of the JAX package's `experiments/`:
//   attr_accel   allpairs_v2.py:37        _attr_kernel        -> elem_kernel<0..2>
//   v1b_accel    allpairs_v2.py:112       _v1b_kernel         -> expand_kernel<1,*,0>
//   unroll_accel allpairs_unroll.py:29    _kernel             -> elem_kernel<3>
//   v1_accel     allpairs_variants.py:35  _v1_kernel          -> expand_kernel<0,*,0>
//   v3_accel     allpairs_v3.py:53        _v3_kernel          -> v3_kernel<path>
//   hybrid_accel allpairs_hybrid.py:42    _hybrid_kernel      -> expand_kernel<1,1,1>
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
// each kernel's rsqrt loop shows it (chip_smoke phase 2, beside the
// rsqrtf guard's FSETP and two predicated FMULs, not counted here):
//   elementwise (attr full, unroll, v4, hybrid's tiles 0-1): 12 FP32
//     (3 sub, 4 for d² = dx·dx + dy·dy + dz·dz + eps2, 2 mul for s = inv³,
//     3 FMA into the sums), 1 MUFU (rsqrt); attr norsqrt 11 FP32 and no
//     MUFU (s = d² · 1e-9); attr noaccum 9 FP32 (inv² · inv goes into the
//     one sum as an FMA), 1 MUFU.
//   v1b: 3 FP32 (d² = dot + r_i², 2 mul) at "default", 5 at "highest"
//     (+2 sub for the mid and lo pieces of s), 1 MUFU; mma a 16x16 block
//     of pairs: 2 + 1 at "default", 4 + 4 at "highest", i.e. 48 or 128
//     padded tensor flops a pair. F2FP packs (0.5 or 1.5 a pair) and the
//     bf16 -> f32 unpacks (ALU) are not counted.
//   v1: as v1b plus 1 FP32 (r_j² enters as an FP32 FMA, then + r_i²).
//   v3: 4 FP32 (d² = (r_i² - 2 dot) + r_j², 2 mul), 1 MUFU, mma 2 a block
//     (K = 12 padded to 16: 32 flops a pair); + 4 FMA (vpu), or + 1 sub and
//     2 mma (mm_split, 64 flops), or + 1 mma (mm_bf16, 48 flops).
//   hybrid: two thirds elementwise, one third v1b "highest": 9.67 FP32,
//     1 MUFU, 42.7 tensor flops a pair.
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
// packed along K (6 groups of 4 coordinates, K = 32: two k16 steps); in
// the second the source pieces sit in the columns ([hi | mid] and
// [lo | 0]) and s's pieces in three A operands (4 mma). "default" is one
// bf16 pass, as DEFAULT is on the TPU. The source side of every operand
// is built once per block and stage in shared memory in fragment order
// (one 32-bit load per fragment register, no bank conflicts: record
// strides of 20 and 12 words and column strides of 12 words).
//
// Float32 sums over 1M sources: each stage (128 sources) is summed in the
// mma accumulator or in 4 chains, and the stage sums go into the running
// sums with Kahan compensation, as `allpairs.cu`'s rectangle does. v4
// keeps its per-(target, lane) partials plain for 16 stages at a time and
// folds them into compensated totals; v3 adds each j-tile's sums plainly,
// as the JAX kernel does.

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

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// two bf16 values in one register, `lo` in the low half (the smaller
// K or column index)
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return as_u32(__halves2bfloat162(lo, hi));
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
// pieces, and with `three` also mid and lo.
template <bool kThree>
__device__ __forceinline__ void split_s(const float (&s)[2][4],
                                        uint32_t (&hi)[4], uint32_t (&mid)[4],
                                        uint32_t (&lo)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {  // register q: half q / 2, row (q & 1)
    const float s0 = s[q >> 1][(q & 1) * 2];
    const float s1 = s[q >> 1][(q & 1) * 2 + 1];
    const __nv_bfloat162 h = __floats2bfloat162_rn(s0, s1);
    hi[q] = as_u32(h);
    if (kThree) {
      const float2 hf = __bfloat1622float2(h);
      const float r0 = __fsub_rn(s0, hf.x), r1 = __fsub_rn(s1, hf.y);
      const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
      mid[q] = as_u32(m);
      const float2 mf = __bfloat1622float2(m);
      lo[q] = as_u32(__floats2bfloat162_rn(__fsub_rn(r0, mf.x),
                                           __fsub_rn(r1, mf.y)));
    }
  }
}

// ---------------------------------------------------------------------------
// v1 / v1b / hybrid: the expansion, 4 warps x 32 targets a block.
// K groups of 4 coordinates: "highest" takes the six piece products
// (A piece x B piece) hi·hi, hi·mid, mid·hi, hi·lo, lo·hi, mid·mid in
// groups 0-5 (6-7 zero, K = 32); "default" hi·hi in group 0 (K = 16).
// ---------------------------------------------------------------------------

constexpr int EXP_WARPS = 4;
constexpr int EXP_MT = 2;              // m16 row tiles a warp
constexpr int CHUNKS = TILE / 16;      // 16-source chunks a stage
constexpr int TCOL_WORDS = 12;         // words a column of the T table
constexpr int TCHUNK_WORDS = 12 * TCOL_WORDS;

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

template <bool kThree>
struct ExpandSmem {
  static constexpr int kRecWords = kThree ? 16 : 8;    // K / 2
  static constexpr int kRecStride = kThree ? 20 : 12;  // conflict-free
  uint32_t rec[TILE * kRecStride];                     // first mma's B
  uint32_t tcol[CHUNKS * TCHUNK_WORDS];                // second mma's B
  float rj2[TILE];
  float4 elem[TILE];                                   // hybrid's tiles
};

// Stage sources j0..j0+TILE for the expansion: thread j builds source j's
// K record and its column entries ([hi x, y, z, 1 | mid | lo]).
template <bool kV1b, bool kThree>
__device__ __forceinline__ void stage_expand(const float* pos, long long n,
                                             long long j0,
                                             ExpandSmem<kThree>& sm) {
  const int j = threadIdx.x;
  const float x = pos[j0 + j], y = pos[n + j0 + j], z = pos[2 * n + j0 + j];
  const float rj2 = r2(x, y, z);
  Pieces w[4];
  if (kV1b) {
    w[0] = split3(-2.f * x);
    w[1] = split3(-2.f * y);
    w[2] = split3(-2.f * z);
    w[3] = split3(rj2);
  } else {
    w[0] = split3(x);
    w[1] = split3(y);
    w[2] = split3(z);
    w[3] = split3(0.f);
  }
#pragma unroll
  for (int k = 0; k < ExpandSmem<kThree>::kRecWords; ++k) {
    sm.rec[j * ExpandSmem<kThree>::kRecStride + k] = k_word<kThree>(w, k,
                                                                     false);
  }
  sm.rj2[j] = rj2;
  // columns: piece pi of coordinate c at column 4 * pi + c
  __nv_bfloat16* col = reinterpret_cast<__nv_bfloat16*>(
      sm.tcol + (j >> 4) * TCHUNK_WORDS);
  const Pieces t[4] = {kV1b ? split3(x) : w[0], kV1b ? split3(y) : w[1],
                       kV1b ? split3(z) : w[2], split3(1.f)};
#pragma unroll
  for (int pi = 0; pi < 3; ++pi) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      col[(4 * pi + c) * (2 * TCOL_WORDS) + (j & 15)] = t[c].p[pi];
    }
  }
}

template <bool kV1b, bool kThree, bool kHybrid>
__global__ void __launch_bounds__(EXP_WARPS * 32)
expand_kernel(const float* __restrict__ pos, long long n, int tj,
              float* __restrict__ out, float mass, float eps2) {
  using Smem = ExpandSmem<kThree>;
  constexpr int KSTEPS = kThree ? 2 : 1;
  __shared__ Smem sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long wbase = (long long)blockIdx.x * TILE + warp * 32;

  // targets of this lane's rows: row (mt, hr) is target mt*16 + g + 8*hr
  uint32_t afr[EXP_MT][KSTEPS][4];
  float ri2[EXP_MT][2];
#pragma unroll
  for (int mt = 0; mt < EXP_MT; ++mt) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const long long i = wbase + mt * 16 + g + 8 * hr;
      const float x = pos[i], y = pos[n + i], z = pos[2 * n + i];
      ri2[mt][hr] = __fadd_rn(r2(x, y, z), eps2);
      const Pieces v[4] = {split3(x), split3(y), split3(z),
                           split3(kV1b ? 1.f : 0.f)};
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        afr[mt][ks][hr] = k_word<kThree>(v, ks * 8 + t, true);
        afr[mt][ks][2 + hr] = k_word<kThree>(v, ks * 8 + 4 + t, true);
      }
    }
  }
  // hybrid: this lane's own target for the elementwise tiles
  float exi = 0.f, eyi = 0.f, ezi = 0.f;
  float es[3] = {0.f, 0.f, 0.f}, ec[3] = {0.f, 0.f, 0.f};
  if (kHybrid) {
    exi = pos[wbase + lane];
    eyi = pos[n + wbase + lane];
    ezi = pos[2 * n + wbase + lane];
  }
  float run[EXP_MT][4], comp[EXP_MT][4];
#pragma unroll
  for (int mt = 0; mt < EXP_MT; ++mt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) run[mt][e] = comp[mt][e] = 0.f;
  }

  for (long long j0 = 0; j0 < n; j0 += TILE) {
    const bool expand = !kHybrid || (j0 / tj) % 3 == 2;
    __syncthreads();
    if (expand) {
      stage_expand<kV1b, kThree>(pos, n, j0, sm);
    } else {
      stage_float4(pos, n, j0, sm.elem);
    }
    __syncthreads();
    if (!expand) {
      float s[3];
      tile_sums<kFull>(exi, eyi, ezi, sm.elem, eps2, s[0], s[1], s[2]);
#pragma unroll
      for (int k = 0; k < 3; ++k) kahan_add(es[k], ec[k], s[k]);
      continue;
    }
    float acc[EXP_MT][4];
#pragma unroll
    for (int mt = 0; mt < EXP_MT; ++mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;
    }
#pragma unroll 1
    for (int c = 0; c < CHUNKS; ++c) {
      uint32_t b1[2][KSTEPS][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t* rec =
            sm.rec + (c * 16 + h * 8 + g) * Smem::kRecStride;
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) {
          b1[h][ks][0] = rec[ks * 8 + t];
          b1[h][ks][1] = rec[ks * 8 + 4 + t];
        }
      }
      // second mma's B: [hi | mid] (columns 0-7) and [lo | 0], [hi | 0]
      const uint32_t* tc = sm.tcol + c * TCHUNK_WORDS;
      const uint32_t bhm0 = tc[g * TCOL_WORDS + t];
      const uint32_t bhm1 = tc[g * TCOL_WORDS + 4 + t];
      const uint32_t bh0 = g < 4 ? bhm0 : 0u, bh1 = g < 4 ? bhm1 : 0u;
      uint32_t bl0 = 0u, bl1 = 0u;
      if (kThree && g < 4) {
        bl0 = tc[(8 + g) * TCOL_WORDS + t];
        bl1 = tc[(8 + g) * TCOL_WORDS + 4 + t];
      }
      float rj2[2][2];
      if (!kV1b) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 r = *reinterpret_cast<const float2*>(
              sm.rj2 + c * 16 + h * 8 + 2 * t);
          rj2[h][0] = r.x;
          rj2[h][1] = r.y;
        }
      }
#pragma unroll
      for (int mt = 0; mt < EXP_MT; ++mt) {
        float s[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int ks = 0; ks < KSTEPS; ++ks) {
            mma16816(d, afr[mt][ks], b1[h][ks][0], b1[h][ks][1]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float r = ri2[mt][e >> 1];
            // v1b: dot + r_i²; v1: r_i² + (r_j² - 2 dot)
            const float d2 = kV1b ? __fadd_rn(d[e], r)
                                  : __fadd_rn(r, __fmaf_rn(-2.f, d[e],
                                                           rj2[h][e & 1]));
            s[h][e] = inv3(d2);
          }
        }
        uint32_t shi[4], smid[4], slo[4];
        split_s<kThree>(s, shi, smid, slo);
        if (kThree) {
          mma16816(acc[mt], shi, bhm0, bhm1);   // hi·hi | hi·mid
          mma16816(acc[mt], smid, bhm0, bhm1);  // mid·hi | mid·mid
          mma16816(acc[mt], slo, bh0, bh1);     // lo·hi
          mma16816(acc[mt], shi, bl0, bl1);     // hi·lo
        } else {
          mma16816(acc[mt], shi, bh0, bh1);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < EXP_MT; ++mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) kahan_add(run[mt][e], comp[mt][e],
                                            acc[mt][e]);
    }
  }

  // F = columns c + c+4 (lanes t, t^2); lane t = 0 writes row g, t = 1 row
  // g + 8: (Fx, Fy) sit in t = 0, (Fz, F3) in t = 1
  float es_final[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) es_final[k] = es[k] - ec[k];
#pragma unroll
  for (int mt = 0; mt < EXP_MT; ++mt) {
    float v[4], o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = run[mt][e] - comp[mt][e];
      v[e] += __shfl_xor_sync(FULL, v[e], 2);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = __shfl_xor_sync(FULL, v[e], 1);
    const int hr = t;  // lanes t = 0, 1 write rows g, g + 8
    const int row = mt * 16 + g + 8 * (hr & 1);
    float e3[3] = {0.f, 0.f, 0.f};
    if (kHybrid) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        e3[k] = __shfl_sync(FULL, es_final[k], row);
      }
    }
    if (hr < 2) {
      const float f[4] = {hr == 0 ? v[0] : o[2], hr == 0 ? v[1] : o[3],
                          hr == 0 ? o[0] : v[2], hr == 0 ? o[1] : v[3]};
      const long long i = wbase + row;
      const float p[3] = {pos[i], pos[n + i], pos[2 * n + i]};
      float a[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float fk = kHybrid ? __fadd_rn(e3[k], f[k]) : f[k];
        a[k] = mass * __fsub_rn(fk, __fmul_rn(p[k], f[3]));
      }
      out[i] = a[0];
      out[n + i] = a[1];
      out[2 * n + i] = a[2];
      out[3 * n + i] = amag(a[0], a[1], a[2]);
    }
  }
}

// ---------------------------------------------------------------------------
// v3: each (ti-block, tj-tile) pair centred on c = (c_i + c_j) / 2; q split
// into bf16 hi + lo; dot = the four split products in one K = 16 mma
// (groups [hi_i | lo_i | hi_i | lo_i] x [hi_j | hi_j | lo_j | lo_j]);
// d² = (r_i² - 2 dot) + r_j²; each tj-tile's force sums are added to the
// targets' float32 sums after the tile, as the JAX kernel's carry.
// ---------------------------------------------------------------------------

enum ForcePath { kVpu = 0, kMmSplit = 1, kMmBf16 = 2 };

struct V3Smem {
  uint32_t rec[TILE * 12];                // 8 words a source, stride 12
  uint32_t tcol[CHUNKS * TCHUNK_WORDS];   // [hi x y z | lo x y z | 1 | 0]
  float4 q[TILE];                         // (qx, qy, qz, r_j²)
};

__device__ __forceinline__ uint32_t v3_word(const __nv_bfloat16 (&hi)[3],
                                            const __nv_bfloat16 (&lo)[3],
                                            int w, bool a_side) {
  // word w: group w >> 1 (A: hi lo hi lo; B: hi hi lo lo), coordinates
  // (0, 1) or (2, pad)
  const int grp = w >> 1;
  const bool use_lo = a_side ? (grp & 1) : (grp >> 1);
  const __nv_bfloat16* v = use_lo ? lo : hi;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  return (w & 1) ? pack2(v[2], zero) : pack2(v[0], v[1]);
}

template <int PATH>
__global__ void __launch_bounds__(EXP_WARPS * 32)
v3_kernel(const float* __restrict__ pos, long long n,
          const float* __restrict__ ci, int ti, const float* __restrict__ cj,
          int tj, float* __restrict__ out, float mass, float eps2) {
  __shared__ V3Smem sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long wbase = (long long)blockIdx.x * TILE + warp * 32;
  const long long nti = n / ti, ntj = n / tj;
  const long long blk = ((long long)blockIdx.x * TILE) / ti;
  const float cix = ci[blk], ciy = ci[nti + blk], ciz = ci[2 * nti + blk];

  float p[EXP_MT][2][3];     // this lane's rows' positions
#pragma unroll
  for (int mt = 0; mt < EXP_MT; ++mt) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const long long i = wbase + mt * 16 + g + 8 * hr;
      p[mt][hr][0] = pos[i];
      p[mt][hr][1] = pos[n + i];
      p[mt][hr][2] = pos[2 * n + i];
    }
  }
  float acc3[EXP_MT][2][3] = {};   // the JAX carry, per row
  float qi[EXP_MT][2][3], ri2[EXP_MT][2];
  uint32_t afr[EXP_MT][4];
  // one tile's force sums: vpu (f3, fs) per row; mm: accumulators
  float fv[EXP_MT][2][4];
  float fh[EXP_MT][4], fl[EXP_MT][4];

  for (long long j0 = 0; j0 < n; j0 += TILE) {
    const long long b = j0 / tj;
    const float c[3] = {0.5f * (cix + cj[b]), 0.5f * (ciy + cj[ntj + b]),
                        0.5f * (ciz + cj[2 * ntj + b])};
    if (j0 % tj == 0) {  // a new j-tile: re-centre the targets
#pragma unroll
      for (int mt = 0; mt < EXP_MT; ++mt) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          __nv_bfloat16 hi[3], lo[3];
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            qi[mt][hr][k] = __fsub_rn(p[mt][hr][k], c[k]);
            hi[k] = __float2bfloat16_rn(qi[mt][hr][k]);
            lo[k] = __float2bfloat16_rn(
                __fsub_rn(qi[mt][hr][k], __bfloat162float(hi[k])));
          }
          ri2[mt][hr] = __fadd_rn(r2(qi[mt][hr][0], qi[mt][hr][1],
                                     qi[mt][hr][2]), eps2);
          afr[mt][hr] = v3_word(hi, lo, t, true);   // a2 = a0, a3 = a1
          afr[mt][2 + hr] = afr[mt][hr];
#pragma unroll
          for (int e = 0; e < 4; ++e) fv[mt][hr][e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) fh[mt][e] = fl[mt][e] = 0.f;
      }
    }
    __syncthreads();
    {  // stage: source j's centred pieces
      const int j = threadIdx.x;
      const long long js = j0 + j;
      const float q[3] = {__fsub_rn(pos[js], c[0]),
                          __fsub_rn(pos[n + js], c[1]),
                          __fsub_rn(pos[2 * n + js], c[2])};
      __nv_bfloat16 hi[3], lo[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        hi[k] = __float2bfloat16_rn(q[k]);
        lo[k] = __float2bfloat16_rn(__fsub_rn(q[k], __bfloat162float(hi[k])));
      }
#pragma unroll
      for (int w = 0; w < 8; ++w) sm.rec[j * 12 + w] = v3_word(hi, lo, w,
                                                               false);
      sm.q[j] = make_float4(q[0], q[1], q[2], r2(q[0], q[1], q[2]));
      __nv_bfloat16* col = reinterpret_cast<__nv_bfloat16*>(
          sm.tcol + (j >> 4) * TCHUNK_WORDS);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        col[k * (2 * TCOL_WORDS) + (j & 15)] = hi[k];
        col[(3 + k) * (2 * TCOL_WORDS) + (j & 15)] = lo[k];
      }
      col[6 * (2 * TCOL_WORDS) + (j & 15)] = __float2bfloat16_rn(1.f);
      col[7 * (2 * TCOL_WORDS) + (j & 15)] = __float2bfloat16_rn(0.f);
    }
    __syncthreads();
#pragma unroll 1
    for (int ch = 0; ch < CHUNKS; ++ch) {
      uint32_t b1[2][2];
      float4 qs[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t* rec = sm.rec + (ch * 16 + h * 8 + g) * 12;
        b1[h][0] = rec[t];
        b1[h][1] = rec[4 + t];
        qs[h][0] = sm.q[ch * 16 + h * 8 + 2 * t];
        qs[h][1] = sm.q[ch * 16 + h * 8 + 2 * t + 1];
      }
      const uint32_t* tc = sm.tcol + ch * TCHUNK_WORDS;
      const uint32_t bh0 = tc[g * TCOL_WORDS + t];
      const uint32_t bh1 = tc[g * TCOL_WORDS + 4 + t];
      // B_l = (hi x, y, z, 1, 0...): columns 0, 1, 2, 6 of B_h
      const int lcol = g < 3 ? g : 6;
      const uint32_t bl0 = g < 4 ? tc[lcol * TCOL_WORDS + t] : 0u;
      const uint32_t bl1 = g < 4 ? tc[lcol * TCOL_WORDS + 4 + t] : 0u;
#pragma unroll
      for (int mt = 0; mt < EXP_MT; ++mt) {
        float s[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          mma16816(d, afr[mt], b1[h][0], b1[h][1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4 q = qs[h][e & 1];
            const float d2 = __fadd_rn(__fmaf_rn(-2.f, d[e], ri2[mt][e >> 1]),
                                       q.w);
            s[h][e] = inv3(d2);
            if (PATH == kVpu) {
              float* f = fv[mt][e >> 1];
              f[0] += q.x * s[h][e];
              f[1] += q.y * s[h][e];
              f[2] += q.z * s[h][e];
              f[3] += s[h][e];
            }
          }
        }
        if (PATH != kVpu) {
          uint32_t shi[4], sunused[4], slo[4];
          split_s<false>(s, shi, sunused, slo);
          mma16816(fh[mt], shi, bh0, bh1);
          if (PATH == kMmSplit) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {  // s - bf16(s), to bf16
              const float s0 = s[q >> 1][(q & 1) * 2];
              const float s1 = s[q >> 1][(q & 1) * 2 + 1];
              const float2 hf = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(&shi[q]));
              slo[q] = as_u32(__floats2bfloat162_rn(__fsub_rn(s0, hf.x),
                                                    __fsub_rn(s1, hf.y)));
            }
            mma16816(fl[mt], slo, bl0, bl1);
          }
        }
      }
    }
    if ((j0 + TILE) % tj != 0) continue;
    // the tile's end: acc3 += f3 - q_i * fs, per row
#pragma unroll
    for (int mt = 0; mt < EXP_MT; ++mt) {
      float f[2][4];
      if (PATH == kVpu) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float v = fv[mt][hr][e];
            v += __shfl_xor_sync(FULL, v, 1);
            v += __shfl_xor_sync(FULL, v, 2);
            f[hr][e] = v;
          }
        }
      } else {
        // column k of row hr sits in lane 4g + k/2, element 2hr + k%2
        const int quad = lane & ~3;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float h8[8], l4[4];
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            h8[k] = __shfl_sync(FULL, fh[mt][2 * hr + (k & 1)],
                                quad + (k >> 1));
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            l4[k] = __shfl_sync(FULL, fl[mt][2 * hr + (k & 1)],
                                quad + (k >> 1));
          }
          // f3 = (f_h[0:3] + f_h[3:6]) + f_l[0:3]; fs = f_h[6] + f_l[3]
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            f[hr][k] = __fadd_rn(h8[k], h8[3 + k]);
            if (PATH == kMmSplit) f[hr][k] = __fadd_rn(f[hr][k], l4[k]);
          }
          f[hr][3] = PATH == kMmSplit ? __fadd_rn(h8[6], l4[3]) : h8[6];
        }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          acc3[mt][hr][k] = __fadd_rn(
              acc3[mt][hr][k],
              __fsub_rn(f[hr][k], __fmul_rn(qi[mt][hr][k], f[hr][3])));
        }
      }
    }
  }
  if (t >= 2) return;
#pragma unroll
  for (int mt = 0; mt < EXP_MT; ++mt) {
    const int hr = t;
    const long long i = wbase + mt * 16 + g + 8 * hr;
    const float a[3] = {mass * acc3[mt][hr][0], mass * acc3[mt][hr][1],
                        mass * acc3[mt][hr][2]};
    out[i] = a[0];
    out[n + i] = a[1];
    out[2 * n + i] = a[2];
    out[3 * n + i] = amag(a[0], a[1], a[2]);
  }
}

bool bad_n(long long n) { return n <= 0 || n % TILE != 0; }

int launched() { return static_cast<int>(cudaGetLastError()); }

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
  const unsigned blocks = (unsigned)(n / TILE);
  const int th = EXP_WARPS * 32;
  if (v1b && highest) {
    expand_kernel<true, true, false><<<blocks, th, 0, st>>>(p, n, TILE, o, mass, eps2);
  } else if (v1b) {
    expand_kernel<true, false, false><<<blocks, th, 0, st>>>(p, n, TILE, o, mass, eps2);
  } else if (highest) {
    expand_kernel<false, true, false><<<blocks, th, 0, st>>>(p, n, TILE, o, mass, eps2);
  } else {
    expand_kernel<false, false, false><<<blocks, th, 0, st>>>(p, n, TILE, o, mass, eps2);
  }
  return launched();
}

// hybrid: tj-tiles (tj a multiple of TILE, n / tj a multiple of 3); of
// each group of three, tiles 0-1 elementwise, tile 2 v1b "highest".
extern "C" int apv_hybrid(const void* pos, long long n, int tj, void* out,
                          float mass, float eps2, void* stream) {
  if (bad_n(n) || tj <= 0 || tj % TILE || n % tj || (n / tj) % 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  expand_kernel<true, true, true><<<(unsigned)(n / TILE), EXP_WARPS * 32, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), n, tj, static_cast<float*>(out), mass,
      eps2);
  return launched();
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
  const unsigned blocks = (unsigned)(n / TILE);
  const int th = EXP_WARPS * 32;
  switch (path) {
    case kVpu: v3_kernel<kVpu><<<blocks, th, 0, st>>>(p, n, a, ti, b, tj, o, mass, eps2); break;
    case kMmSplit: v3_kernel<kMmSplit><<<blocks, th, 0, st>>>(p, n, a, ti, b, tj, o, mass, eps2); break;
    default: v3_kernel<kMmBf16><<<blocks, th, 0, st>>>(p, n, a, ti, b, tj, o, mass, eps2); break;
  }
  return launched();
}
