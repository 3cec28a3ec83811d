// Depth-Q sprite composite over virtual rows (the renderer's hot loop).
//
// Replaces the TPU kernel `multi_adapter_particles_tpu/ops/composite.py`
// `_kernel` (launcher `composite_rows_pallas`), which holds a 256-row block
// of [128 px, VB] carry planes in VMEM for the whole Q loop.
//
// What it computes: each virtual row v is one (tile_h x tile_w)-pixel tile
// slice of the sorted sprite stream; for q < row_hi[v], in draw order,
//   du = (px - cx) * 1/(2hx), dv = (py - cy) * 1/(2hy)
//   alpha = clamp(0.5 - sqrt(du^2 + dv^2), 0, 0.5) * alpha_scale
//   over:     C = C * (1 - alpha) + clamp(rgb * alpha, 0, 1); T *= 1 - alpha
//   additive: C = C + clamp(rgb * alpha, 0, 1)
// Output [4, px, V]: premultiplied r, g, b and transmittance.
//
// Bound on the H100: per (row, pixel, live slot) 28 FP32-pipe instructions in
// 'over' mode (2 + 2 for du, dv; 3 for du^2 + dv^2; 1 for 0.5 - dist; 2
// for the clamp; 1 for * sa; 1 for keep; 5 per colour channel; 1 for T;
// no FMA under -fmad=false) and a sqrt, against 32 bytes of sprite
// parameters shared by all px pixels of the row: FP32 issue, not bytes.
// The design (csrc/composite_tiles.cu's row kernel on this layout): a CTA
// takes kRows = 8 consecutive virtual rows, one warp a row, and stages
// their slots kQBlock = 32 at a time from [8, Q, V] into shared memory,
// two buffers and one barrier a q-block, by 4-byte cp.async copies with v
// fastest (a (channel, slot) of the 8 rows is one 32-byte sector), so each
// slot is read from device memory once. Each lane blends 4 pixels of its
// warp's row (kPix = 128 a CTA pass; a tile of more pixels takes more
// passes, grid.y), reading a slot's 8 parameters as two 16-byte shared
// broadcasts. A row blends from its first slot of nonzero alpha scale (a
// ballot over the staged q-block finds it; the renderer's rows start with
// dead slots, and a dead slot blends as the identity) to its row_hi; the
// block stages to the largest row_hi of its rows, and a warp whose row is
// done still takes part in the barriers. The results turn through shared
// memory (the staging buffers) so the [4, px, V] stores keep v fastest: 8
// consecutive v, a 32-byte sector, a (channel, pixel). On an H100 this
// runs at 58-66% of its SASS issue rate; a pixel a lane at 64 warps an SM,
// 4-row CTAs, rows balanced over the warps and a sqrt skipped outside the
// sprite each measured slower on at least one of chip_smoke's two scenes
// (PERF.md).
//
// The trip count is per row: slots at or past row_hi[v], and the dead
// slots before a row's first live one, carry alpha scale 0, and zero alpha
// blends as an exact identity (x * 1 == x, x + 0 == x), so skipping them
// equals the full loop bit for bit. No atomics: each output element has
// one writer, so the kernel is deterministic. No constraint on Q or V (the
// TPU kernel needed Q % 8 == 0 and V padding).
//
// Build with -fmad=false (ops/composite.py does): the blend then rounds
// after every multiply and add exactly like the torch twin's separate ops,
// so kernel and twin agree bit for bit rather than to FMA's ~1 ulp per step.
// Clamps are fminf(fmaxf(x, lo), hi): equal to torch.clamp for every
// non-NaN input (the renderer sanitizes NaN out of the parameters).

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;                   // virtual rows (warps) a CTA
constexpr int kThreads = kRows * 32;
constexpr int kQBlock = 32;                // slots a staged q-block
constexpr int kPix = 128;                  // pixels a CTA pass (4 a lane)
constexpr int kLanePix = kPix / 32;
static_assert(kQBlock == 32, "a ballot covers a q-block");

// a q-block's slots of the CTA's rows: (cx, cy, 1/(2hx), 1/(2hy)) and
// (r, g, b, alpha scale) of slot q of row r at [q][r]
struct alignas(16) Slot {
  float4 geo;
  float4 col;
};
struct alignas(16) Stage {
  Slot s[kQBlock][kRows];
};
// shared memory: the two staging buffers, which then hold a pass's
// results [channel][pixel][row]
constexpr int kResultFloats = 4 * kPix * kRows;
static_assert(2 * sizeof(Stage) == kResultFloats * sizeof(float),
              "the results fill the two staging buffers");

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ int clamped_hi(const int* row_hi, long long v,
                                          long long v_len, int q_len) {
  if (v >= v_len) return 0;
  return row_hi == nullptr ? q_len : min(max(__ldg(row_hi + v), 0), q_len);
}

// Slots q0 .. q0 + kQBlock of rows v0 .. v0 + kRows into B: one 4-byte
// copy an element, v fastest; slots past Q and rows past V are not
// copied (no warp reads them).
__device__ __forceinline__ void stage_block(Stage& B,
                                            const float* __restrict__ sp,
                                            int q_len, long long v_len,
                                            long long v0, int q0) {
  for (int k = threadIdx.x; k < 8 * kQBlock * kRows; k += kThreads) {
    const int r = k % kRows, q = (k / kRows) % kQBlock,
              c = k / (kRows * kQBlock);
    if (q0 + q < q_len && v0 + r < v_len) {
      float* dst = (c < 4 ? &B.s[q][r].geo.x : &B.s[q][r].col.x) + (c & 3);
      const float* src =
          sp + ((long long)c * q_len + q0 + q) * v_len + v0 + r;
      const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                   "l"(src));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <bool kOver>
__global__ void __launch_bounds__(kThreads)
    composite_kernel(const float* __restrict__ sp,
                     const float* __restrict__ bases,
                     const int* __restrict__ row_hi,
                     float* __restrict__ out, int q_len, long long v_len,
                     int tile_w, int px) {
  __shared__ alignas(16) float smem[kResultFloats];
  Stage* const stage = reinterpret_cast<Stage*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long v0 = (long long)blockIdx.x * kRows;
  const long long v = v0 + warp;
  const int p0 = blockIdx.y * kPix;

  // this warp's row and the largest trip count of the block's rows
  const int hi = clamped_hi(row_hi, v, v_len, q_len);
  int block_hi = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    block_hi = max(block_hi, clamped_hi(row_hi, v0 + r, v_len, q_len));
  }

  const long long vc = v < v_len ? v : v_len - 1;
  const float bx = __ldg(bases + vc);
  const float by = __ldg(bases + v_len + vc);
  float pxc[kLanePix], pyc[kLanePix];
  float cr[kLanePix], cg[kLanePix], cb[kLanePix], tt[kLanePix];
#pragma unroll
  for (int k = 0; k < kLanePix; ++k) {
    const int p = p0 + 32 * k + lane;
    pxc[k] = bx + (float)(p % tile_w) + 0.5f;
    pyc[k] = by + (float)(p / tile_w) + 0.5f;
    cr[k] = 0.0f;
    cg[k] = 0.0f;
    cb[k] = 0.0f;
    tt[k] = 1.0f;
  }

  const int blocks = (block_hi + kQBlock - 1) / kQBlock;
  bool dead_head = true;   // no live slot of the row seen yet (warp-uniform)
  if (blocks > 0) stage_block(stage[0], sp, q_len, v_len, v0, 0);
  for (int b = 0; b < blocks; ++b) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();   // q-block b landed; q-block b - 1 is consumed
    if (b + 1 < blocks) {
      stage_block(stage[(b + 1) & 1], sp, q_len, v_len, v0,
                  (b + 1) * kQBlock);
    }
    const Stage& B = stage[b & 1];
    const int q1 = min(kQBlock, hi - b * kQBlock);
    int q0 = 0;
    if (dead_head) {   // the row's first live slot: one ballot a q-block
      const unsigned m = __ballot_sync(
          0xffffffffu, lane < q1 && B.s[lane][warp].col.w != 0.0f);
      q0 = m ? __ffs(m) - 1 : q1;
      dead_head = m == 0;
    }
    for (int q = q0; q < q1; ++q) {
      const float4 g = B.s[q][warp].geo;
      const float4 c = B.s[q][warp].col;
#pragma unroll
      for (int k = 0; k < kLanePix; ++k) {
        const float du = (pxc[k] - g.x) * g.z;
        const float dv = (pyc[k] - g.y) * g.w;
        const float dist = sqrtf(du * du + dv * dv);
        const float alpha = clampf(0.5f - dist, 0.0f, 0.5f) * c.w;
        if (kOver) {
          const float keep = 1.0f - alpha;
          cr[k] = cr[k] * keep + clampf(c.x * alpha, 0.0f, 1.0f);
          cg[k] = cg[k] * keep + clampf(c.y * alpha, 0.0f, 1.0f);
          cb[k] = cb[k] * keep + clampf(c.z * alpha, 0.0f, 1.0f);
          tt[k] = tt[k] * keep;
        } else {
          cr[k] = cr[k] + clampf(c.x * alpha, 0.0f, 1.0f);
          cg[k] = cg[k] + clampf(c.y * alpha, 0.0f, 1.0f);
          cb[k] = cb[k] + clampf(c.z * alpha, 0.0f, 1.0f);
        }
      }
    }
  }

  // the pass's results [channel][pixel][row] through the staging buffers,
  // then stored with v fastest
  __syncthreads();   // every warp is done with the staged slots
  float* const res = smem;
#pragma unroll
  for (int k = 0; k < kLanePix; ++k) {
    const int p = 32 * k + lane;
    res[(0 * kPix + p) * kRows + warp] = cr[k];
    res[(1 * kPix + p) * kRows + warp] = cg[k];
    res[(2 * kPix + p) * kRows + warp] = cb[k];
    res[(3 * kPix + p) * kRows + warp] = tt[k];
  }
  __syncthreads();
  const long long oplane = (long long)px * v_len;
  for (int k = threadIdx.x; k < kResultFloats; k += kThreads) {
    const int r = k % kRows, p = (k / kRows) % kPix, c = k / (kRows * kPix);
    if (p0 + p < px && v0 + r < v_len) {
      out[c * oplane + (long long)(p0 + p) * v_len + v0 + r] = res[k];
    }
  }
}

}  // namespace

// sp [8, q_len, v_len], bases [2, v_len] float32; row_hi [v_len] int32 or
// null (= every row loops the full q_len); out [4, tile_h*tile_w, v_len]
// float32. blend: 0 = over, 1 = additive. Returns cudaGetLastError().
extern "C" int composite_rows(const void* sp, const void* bases,
                              const void* row_hi, void* out, int q_len,
                              long long v_len, int tile_h, int tile_w,
                              int blend, void* stream) {
  const int px = tile_h * tile_w;
  if (v_len <= 0 || px <= 0) return 0;
  const dim3 grid((unsigned)((v_len + kRows - 1) / kRows),
                  (px + kPix - 1) / kPix);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sp_f = static_cast<const float*>(sp);
  const float* bases_f = static_cast<const float*>(bases);
  const int* hi_i = static_cast<const int*>(row_hi);
  float* out_f = static_cast<float*>(out);
  if (blend == 0) {
    composite_kernel<true><<<grid, kThreads, 0, st>>>(
        sp_f, bases_f, hi_i, out_f, q_len, v_len, tile_w, px);
  } else {
    composite_kernel<false><<<grid, kThreads, 0, st>>>(
        sp_f, bases_f, hi_i, out_f, q_len, v_len, tile_w, px);
  }
  return static_cast<int>(cudaGetLastError());
}
