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
// Bound on the H100: per (row, pixel, slot) 28 FP32-pipe instructions in
// 'over' mode (2 + 2 for du, dv; 3 for du^2 + dv^2; 1 for 0.5 - dist; 2
// for the clamp; 1 for * sa; 1 for keep; 5 per colour channel; 1 for T;
// no FMA under -fmad=false) and a sqrt, against 32 bytes of sprite
// parameters shared by all px pixels of the row. Read
// once per pixel that is ~25 GB of L1/L2 traffic per 1M-particle chunk at
// Q=256, so loads, not flops, bound a one-pixel-per-thread kernel. The
// design: v is the fastest index across threads (sp[c, q, v] loads and
// out[c, p, v] stores coalesce in the JAX layout) and each thread keeps
// PIX_PER_THREAD pixels of its row in registers, so one load of a slot's
// 8 parameters feeds 8 pixels. The px/PIX_PER_THREAD blocks that share a
// v-range are adjacent in the grid, so their loads of the same sp columns
// hit L2. The carries stay in registers for the whole loop: the only
// device-memory traffic is sp read about once and the output written once.
//
// The trip count is per row: slots at or past row_hi[v] carry alpha scale
// 0, and zero alpha blends as an exact identity (x * 1 == x, x + 0 == x),
// so stopping there equals the full loop bit for bit. No atomics: each
// output element has one writer, so the kernel is deterministic. No
// constraint on Q or V (the TPU kernel needed Q % 8 == 0 and V padding).
//
// Build with -fmad=false (ops/composite.py does): the blend then rounds
// after every multiply and add exactly like the torch twin's separate ops,
// so kernel and twin agree bit for bit rather than to FMA's ~1 ulp per step.
// Clamps are fminf(fmaxf(x, lo), hi): equal to torch.clamp for every
// non-NaN input (the renderer sanitizes NaN out of the parameters).

#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 128;  // virtual rows (threads) per block
constexpr int kPixPerThread = 8;    // pixels of one row per thread

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

template <bool kOver>
__global__ void __launch_bounds__(kRowsPerBlock)
    composite_kernel(const float* __restrict__ sp,
                     const float* __restrict__ bases,
                     const int* __restrict__ row_hi,
                     float* __restrict__ out, int q_len, long long v_len,
                     int tile_w, int px) {
  const long long v = (long long)blockIdx.y * kRowsPerBlock + threadIdx.x;
  if (v >= v_len) return;
  const int p0 = blockIdx.x * kPixPerThread;

  const float bx = bases[v];
  const float by = bases[v_len + v];
  float pxc[kPixPerThread], pyc[kPixPerThread];
  float cr[kPixPerThread], cg[kPixPerThread], cb[kPixPerThread],
      tt[kPixPerThread];
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = p0 + k;
    pxc[k] = bx + (float)(p % tile_w) + 0.5f;
    pyc[k] = by + (float)(p / tile_w) + 0.5f;
    cr[k] = 0.0f;
    cg[k] = 0.0f;
    cb[k] = 0.0f;
    tt[k] = 1.0f;
  }

  int hi = q_len;
  if (row_hi != nullptr) hi = min(max(row_hi[v], 0), q_len);
  const long long plane = (long long)q_len * v_len;
  for (int q = 0; q < hi; ++q) {
    const float* s = sp + (long long)q * v_len + v;
    const float scx = s[0];
    const float scy = s[plane];
    const float ihx = s[2 * plane];
    const float ihy = s[3 * plane];
    const float sr = s[4 * plane];
    const float sg = s[5 * plane];
    const float sb = s[6 * plane];
    const float sa = s[7 * plane];
#pragma unroll
    for (int k = 0; k < kPixPerThread; ++k) {
      const float du = (pxc[k] - scx) * ihx;
      const float dv = (pyc[k] - scy) * ihy;
      const float dist = sqrtf(du * du + dv * dv);
      const float alpha = clampf(0.5f - dist, 0.0f, 0.5f) * sa;
      if (kOver) {
        const float keep = 1.0f - alpha;
        cr[k] = cr[k] * keep + clampf(sr * alpha, 0.0f, 1.0f);
        cg[k] = cg[k] * keep + clampf(sg * alpha, 0.0f, 1.0f);
        cb[k] = cb[k] * keep + clampf(sb * alpha, 0.0f, 1.0f);
        tt[k] = tt[k] * keep;
      } else {
        cr[k] = cr[k] + clampf(sr * alpha, 0.0f, 1.0f);
        cg[k] = cg[k] + clampf(sg * alpha, 0.0f, 1.0f);
        cb[k] = cb[k] + clampf(sb * alpha, 0.0f, 1.0f);
      }
    }
  }

  const long long oplane = (long long)px * v_len;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = p0 + k;
    if (p < px) {
      float* o = out + (long long)p * v_len + v;
      o[0] = cr[k];
      o[oplane] = cg[k];
      o[2 * oplane] = cb[k];
      o[3 * oplane] = tt[k];
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
  const dim3 grid((px + kPixPerThread - 1) / kPixPerThread,
                  (unsigned)((v_len + kRowsPerBlock - 1) / kRowsPerBlock));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sp_f = static_cast<const float*>(sp);
  const float* bases_f = static_cast<const float*>(bases);
  const int* hi_i = static_cast<const int*>(row_hi);
  float* out_f = static_cast<float*>(out);
  if (blend == 0) {
    composite_kernel<true><<<grid, kRowsPerBlock, 0, st>>>(
        sp_f, bases_f, hi_i, out_f, q_len, v_len, tile_w, px);
  } else {
    composite_kernel<false><<<grid, kRowsPerBlock, 0, st>>>(
        sp_f, bases_f, hi_i, out_f, q_len, v_len, tile_w, px);
  }
  return static_cast<int>(cudaGetLastError());
}
