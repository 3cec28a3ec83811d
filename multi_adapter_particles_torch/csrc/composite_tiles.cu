// The render composite from the sorted sprite stream to the frame planes:
// two kernels, one launch each per render (chunk).
//
// Replaces the TPU kernel `multi_adapter_particles_tpu/ops/composite.py`
// `_kernel` (launcher `composite_rows_pallas`) together with the XLA code
// around it in the JAX renderer (`render/renderer.py` there: the packed
// payload row gather, the [8, Q, V] parameter planes, the segment
// tree-combine and the tile assembly). Nothing of the TPU kernel's VMEM
// block layout is kept.
//
// What it computes (bit for bit what ops/composite.composite_tiles_plain
// computes with torch ops). The stable sort orders the sprite entries by
// tile; the stream is cut into Q-aligned data rows, and each (data row,
// tile) intersection is a virtual row v, whose live slots k in
// [lo_k[v], hi_k[v]) are the stream entries j_v[v] * Q + k, in draw order.
//
// tile_rows_kernel: one CTA per virtual row, one thread per pixel of its
//   (tile_h x tile_w) tile; each warp owns a compact block of 32 pixels
//   (block_h x block_w, 8 x 4 in the renderer's 8 x 16 tiles), whatever
//   the tile's row-major pixel index p it writes. The CTA stages the row's
//   live entries from the four sorted payload streams (cx, cy, w, the
//   packed f16 pair cg|cb), coalesced, deriving each slot's parameters on
//   the way into shared memory as the renderer's torch ops do (1/(2h) =
//   nan_to_num(w * inv_s), cr = 1 - cb, alpha scale = intensity): 8 floats
//   a slot, two 16-byte broadcast reads. The staging thread also works out
//   which blocks the slot's disc reaches (`reach_mask`); each warp then
//   lists, in slot order, the staged slots that reach its block, and each
//   thread blends its pixel over its warp's list:
//     du = (px - cx) * 1/(2hx), dv = (py - cy) * 1/(2hy)
//     alpha = clamp(0.5 - sqrt(du^2 + dv^2), 0, 0.5) * alpha_scale
//     over:     C = C * (1 - alpha) + clamp(rgb * alpha, 0, 1); T *= 1 - alpha
//     additive: C = C + clamp(rgb * alpha, 0, 1)
//   and writes (C, T) to rows[v, 4, p], and the row's (slot, block) blends
//   to row_blend[v]. Rows at or past row_end[T - 1] (the static grid's dead
//   tail) exit: the grid depends on shapes only, so a CUDA graph captures
//   the launch.
// tile_fold_kernel: one CTA per tile, one thread per pixel. It walks the
//   tile's rows [row_start, row_end) in order and folds them with a
//   binary-counter stack (two entries merge when they cover equal counts;
//   the rest merge right to left at the end), which is the pairwise order
//   of the eager tree passes (`take = seg % 2s == 0 & seg + s < segs`):
//     over:     C = C_e * T_l + C_l, T = T_e * T_l   (e earlier, l later)
//     additive: C = C_e + C_l,       T = T_e
//   and writes the tile's pixels into the assembled [H, W, 3] and [H, W]
//   planes. Its first warp adds the tile's rows' blend counts to the
//   call's count (one integer atomicAdd a tile; the row kernel's CTA 0
//   zeroed it).
//
// Bound on the H100: FP32 issue. Per blended slot and pixel, 28 FP32-pipe
// instructions in 'over' mode and a sqrt (the tally in csrc/composite.cu's
// header); per combine and pixel 7 (3 multiplies, 3 adds, 1 multiply). The
// bytes: 16 per sorted entry read once, the row results written and read
// (16 per row and pixel) and the frame planes (16 per pixel): ~143 MB per
// 1M-particle chunk at 1024x1024, 0.043 ms. Every live slot over its whole
// tile is ~0.17 ms of FP32 issue; the (slot, block) pairs a disc reaches,
// ~35% of them in the 4M scene, ~0.06 ms. The old kernel
// (csrc/composite.cu) re-read each slot's 32 bytes from L1/L2 once per 8
// pixels; here a slot is loaded from device memory once per row and read
// from shared memory by broadcast, so the blend loop issues the FP32 work,
// a list read and two shared loads a slot.
//
// The dead slots the eager path blends (before lo_k, at or past hi_k) carry
// alpha scale 0, and a zero alpha blends as an exact identity (x * 1 == x,
// x + 0 == x), so skipping them changes no bit. The same holds for a live
// slot at a pixel its disc does not reach, which is what the per-warp lists
// skip. Why the skip is exact (`reach_mask`): along x, du = (pxc - cx) * ih
// with pxc = (float)x0 + (float)c + 0.5f exact (a half-integer below 2^23),
// and every rounded operation on the way to s = du * du + dv * dv is
// monotone in |pxc - cx| and |pyc - cy| (rounding is monotone and odd, ih
// is one factor for every pixel). So s over a block is least at the block's
// pixel centre nearest (cx, cy) on each axis: column clamp(k) with k =
// floor(cx - x0), which `near_d` finds among two candidates (fl(cx - x0) is
// k or k + 1 when |k| < 2^24, and an end of the block beyond that), and
// likewise the row. If s >= 0.25 there, every pixel of the block has s >=
// 0.25, so sqrtf(s) >= 0.5 (correctly rounded and monotone, 0.5 exact),
// 0.5 - dist <= 0 and the clamp gives +0: alpha = +0 * alpha_scale = +0
// for a scale in [0, 2], and with it keep = 1 exactly, clamp(rgb * 0) is a
// zero, and neither C nor T changes by a bit (C is never -0, to which +0
// would add: alpha <= 1 keeps keep >= +0, and C starts at +0). s >= 0.25
// is that test without the sqrt: for a float s, sqrtf(s) >= 0.5 exactly
// when s >= 0.25. A NaN compares false and counts as reached, a 1/(2h)
// zeroed from a non-finite w * inv_s makes that axis's du 0, and a scale
// outside [0, 2] (or NaN) turns the skip off for the call: each slot then
// reaches every block, as before. The only atomics add integers, so both
// kernels are deterministic run to run: each float output has one writer.
//
// Build with -fmad=false (ops/composite.py does): every multiply and add
// rounds on its own, as the torch ops do, so the kernels match the plain
// version bit for bit. Clamps are fminf(fmaxf(x, lo), hi): torch.clamp for
// every non-NaN input (the renderer sanitizes NaN out of the geometry).

#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kStage = 256;     // slots staged in shared memory at a time
constexpr int kMaxDepth = 32;   // fold stack: popcount(rows) <= 31
constexpr int kWarp = 32;       // pixels a block, one warp each
constexpr unsigned kAll = 0xFFFFFFFFu;

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// torch.nan_to_num(x, nan=0, posinf=0, neginf=0)
__device__ __forceinline__ float finite_or_zero(float x) {
  return isfinite(x) ? x : 0.0f;
}

// the f16 in the low 16 bits, widened exactly (`unpack_cgb`)
__device__ __forceinline__ float half_lo(unsigned int bits) {
  return __half2float(__ushort_as_half((unsigned short)(bits & 0xFFFFu)));
}

// |du| at the pixel centre nearest c among n columns [lo, lo + n) of a tile
// at base: the least over two candidates that hold the true nearest (see
// the header), each computed as the blend loop computes du.
__device__ __forceinline__ float near_d(float c, float base, int lo, int n,
                                        float ih) {
  const float c1 = clampf(floorf(c - base), (float)lo, (float)(lo + n - 1));
  const float c0 = fmaxf(c1 - 1.0f, (float)lo);
  const float d1 = (base + c1 + 0.5f - c) * ih;
  const float d0 = (base + c0 + 0.5f - c) * ih;
  return fminf(fabsf(d0), fabsf(d1));
}

// Bit b (block b = by * blocks_x + bx, row-major) set when the slot's disc
// can give a pixel of block b a nonzero alpha: clear only if s >= 0.25 at
// the block's nearest pixel centre, where every pixel of it blends alpha 0.
__device__ __forceinline__ unsigned reach_mask(float cx, float cy, float ihx,
                                               float ihy, float x0, float y0,
                                               int blocks_x, int blocks_y,
                                               int block_w, int block_h) {
  unsigned m = 0u;
  for (int by = 0; by < blocks_y; ++by) {
    const float dv = near_d(cy, y0, by * block_h, block_h, ihy);
    const float dv2 = dv * dv;
    for (int bx = 0; bx < blocks_x; ++bx) {
      const float du = near_d(cx, x0, bx * block_w, block_w, ihx);
      if (!(du * du + dv2 >= 0.25f)) m |= 1u << (by * blocks_x + bx);
    }
  }
  return m;
}

template <bool kOver>
__global__ void tile_rows_kernel(
    const float* __restrict__ s_cx, const float* __restrict__ s_cy,
    const float* __restrict__ s_w, const unsigned int* __restrict__ s_cgb,
    long long e_total, const int* __restrict__ tile_v,
    const int* __restrict__ j_v, const int* __restrict__ lo_k,
    const int* __restrict__ hi_k, const int* __restrict__ row_end,
    int num_tiles, const float* __restrict__ inv_sx,
    const float* __restrict__ inv_sy, const float* __restrict__ intensity,
    int q, int grid_w, int tile_h, int tile_w, int block_w,
    float* __restrict__ rows, int* __restrict__ row_blend,
    unsigned long long* __restrict__ blended) {
  const int v = blockIdx.x;
  const int p = threadIdx.x;
  if (v == 0 && p == 0) *blended = 0ull;   // tile_fold_kernel adds to it
  if (v >= __ldg(row_end + num_tiles - 1)) return;
  const int px = blockDim.x;
  const int warps = px / kWarp;
  const int warp = p / kWarp, lane = p % kWarp;
  __shared__ float4 slot[kStage][2];
  __shared__ unsigned int reach[kStage];
  __shared__ int warp_blends[kWarp];
  extern __shared__ unsigned char lists[];   // [warps][kStage] slot indices
  unsigned char* list = lists + warp * kStage;

  // this thread's pixel: lane (lane / block_w, lane % block_w) of its
  // warp's block, blocks row-major over the tile
  const int block_h = kWarp / block_w;
  const int blocks_x = tile_w / block_w;
  const int x_in = (warp % blocks_x) * block_w + lane % block_w;
  const int y_in = (warp / blocks_x) * block_h + lane / block_w;
  const int tile = min(max(__ldg(tile_v + v), 0), num_tiles - 1);
  const float x0 = (float)((tile % grid_w) * tile_w);
  const float y0 = (float)((tile / grid_w) * tile_h);
  const float pxc = x0 + (float)x_in + 0.5f;
  const float pyc = y0 + (float)y_in + 0.5f;
  const long long base = (long long)__ldg(j_v + v) * q;
  const int lo = max(__ldg(lo_k + v), 0);
  const int hi = (int)min((long long)__ldg(hi_k + v), e_total - base);
  const float isx = *inv_sx, isy = *inv_sy, sa = *intensity;
  const bool skip = sa >= 0.0f && sa <= 2.0f;   // the header's proof holds
  const unsigned every = warps == kWarp ? kAll : (1u << warps) - 1u;

  float cr = 0.0f, cg = 0.0f, cb = 0.0f, tt = 1.0f;
  int blends = 0;
  for (int k0 = lo; k0 < hi; k0 += kStage) {
    const int n = min(kStage, hi - k0);
    __syncthreads();   // the previous stage is consumed
    for (int i = p; i < n; i += px) {
      const long long e = base + k0 + i;
      const float x = __ldg(s_cx + e), y = __ldg(s_cy + e);
      const float w = __ldg(s_w + e);
      const float ihx = finite_or_zero(w * isx), ihy = finite_or_zero(w * isy);
      const unsigned int u = __ldg(s_cgb + e);
      const float b = half_lo(u);
      slot[i][0] = make_float4(x, y, ihx, ihy);
      slot[i][1] = make_float4(1.0f - b, half_lo(u >> 16), b, sa);
      reach[i] = skip ? reach_mask(x, y, ihx, ihy, x0, y0, blocks_x,
                                   tile_h / block_h, block_w, block_h)
                      : every;
    }
    __syncthreads();
    // this warp's slots of the stage, in draw order
    int m = 0;
    for (int i0 = 0; i0 < n; i0 += kWarp) {
      const int i = i0 + lane;
      const bool hit = i < n && ((reach[i] >> warp) & 1u);
      const unsigned hits = __ballot_sync(kAll, hit);
      if (hit) list[m + __popc(hits & ((1u << lane) - 1u))] = (unsigned char)i;
      m += __popc(hits);
    }
    __syncwarp();
    blends += m;
    for (int j = 0; j < m; ++j) {
      const int i = list[j];
      const float4 g = slot[i][0];
      const float4 c = slot[i][1];
      const float du = (pxc - g.x) * g.z;
      const float dv = (pyc - g.y) * g.w;
      const float dist = sqrtf(du * du + dv * dv);
      const float alpha = clampf(0.5f - dist, 0.0f, 0.5f) * c.w;
      if (kOver) {
        const float keep = 1.0f - alpha;
        cr = cr * keep + clampf(c.x * alpha, 0.0f, 1.0f);
        cg = cg * keep + clampf(c.y * alpha, 0.0f, 1.0f);
        cb = cb * keep + clampf(c.z * alpha, 0.0f, 1.0f);
        tt = tt * keep;
      } else {
        cr = cr + clampf(c.x * alpha, 0.0f, 1.0f);
        cg = cg + clampf(c.y * alpha, 0.0f, 1.0f);
        cb = cb + clampf(c.z * alpha, 0.0f, 1.0f);
      }
    }
  }
  if (lane == 0) warp_blends[warp] = blends;
  const int pix = y_in * tile_w + x_in;
  float* o = rows + (long long)v * 4 * px;
  o[pix] = cr;
  o[px + pix] = cg;
  o[2 * px + pix] = cb;
  o[3 * px + pix] = tt;
  __syncthreads();
  if (p == 0) {
    int total = 0;
    for (int w = 0; w < warps; ++w) total += warp_blends[w];
    row_blend[v] = total;
  }
}

// e (earlier rows) <- e then l (later rows) on top
template <bool kOver>
__device__ __forceinline__ void combine(float& e0, float& e1, float& e2,
                                        float& et, float l0, float l1,
                                        float l2, float lt) {
  if (kOver) {
    e0 = e0 * lt + l0;
    e1 = e1 * lt + l1;
    e2 = e2 * lt + l2;
    et = et * lt;
  } else {
    e0 = e0 + l0;
    e1 = e1 + l1;
    e2 = e2 + l2;
  }
}

template <bool kOver>
__global__ void tile_fold_kernel(const float* __restrict__ rows,
                                 const int* __restrict__ row_start,
                                 const int* __restrict__ row_end, int grid_w,
                                 int tile_h, int tile_w, int width,
                                 float* __restrict__ color,
                                 float* __restrict__ trans,
                                 const int* __restrict__ row_blend,
                                 unsigned long long* __restrict__ blended) {
  const int t = blockIdx.x;
  const int px = blockDim.x;
  const int p = threadIdx.x;
  const int rs = __ldg(row_start + t);
  const int segs = __ldg(row_end + t) - rs;
  if (p < kWarp) {
    unsigned long long n = 0ull;
    for (int i = p; i < segs; i += kWarp) n += (unsigned)__ldg(row_blend + rs + i);
    for (int s = kWarp / 2; s > 0; s /= 2) n += __shfl_down_sync(kAll, n, s);
    if (p == 0 && n) atomicAdd(blended, n);
  }
  float s0[kMaxDepth], s1[kMaxDepth], s2[kMaxDepth], st[kMaxDepth];
  int top = 0;
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, ct = 1.0f;
  for (int i = 0; i < segs; ++i) {
    const float* r = rows + (long long)(rs + i) * 4 * px + p;
    c0 = r[0];
    c1 = r[px];
    c2 = r[2 * px];
    ct = r[3 * px];
    // row i completes one block of each size 2^m that ends at it
    for (int m = __ffs(i + 1) - 1; m > 0; --m) {
      --top;
      combine<kOver>(s0[top], s1[top], s2[top], st[top], c0, c1, c2, ct);
      c0 = s0[top];
      c1 = s1[top];
      c2 = s2[top];
      ct = st[top];
    }
    s0[top] = c0;
    s1[top] = c1;
    s2[top] = c2;
    st[top] = ct;
    ++top;
  }
  // the blocks left (sizes falling bottom to top) merge right to left
  for (int j = top - 2; j >= 0; --j) {
    combine<kOver>(s0[j], s1[j], s2[j], st[j], c0, c1, c2, ct);
    c0 = s0[j];
    c1 = s1[j];
    c2 = s2[j];
    ct = st[j];
  }
  const int y = (t / grid_w) * tile_h + p / tile_w;
  const int x = (t % grid_w) * tile_w + p % tile_w;
  const long long pix = (long long)y * width + x;
  color[3 * pix] = c0;
  color[3 * pix + 1] = c1;
  color[3 * pix + 2] = c2;
  trans[pix] = ct;
}

}  // namespace

// Sorted streams s_cx, s_cy, s_w float32 and s_cgb int32 [e_total]; the
// virtual-row map tile_v, j_v, lo_k, hi_k int32 [num_rows] and row_start,
// row_end int32 [num_tiles]; inv_sx, inv_sy, intensity float32 scalars on
// the device; rows float32 [num_rows, 4, tile_h * tile_w] and row_blend
// int32 [num_rows] scratch; color float32 [grid_h * tile_h, grid_w *
// tile_w, 3] and trans float32 [H, W]; blended int64 [1], the (slot,
// block) blends of the call. blend: 0 = over, 1 = additive. tile_h *
// tile_w threads a CTA (a multiple of 32, at most 1024), in blocks of
// (32 / block_w) x block_w pixels that tile the tile. Returns
// cudaGetLastError() after the two launches (cudaErrorInvalidValue for a
// block that does not tile the tile).
extern "C" int composite_tiles(
    const void* s_cx, const void* s_cy, const void* s_w, const void* s_cgb,
    long long e_total, const void* tile_v, const void* j_v, const void* lo_k,
    const void* hi_k, const void* row_start, const void* row_end,
    long long num_rows, int grid_h, int grid_w, const void* inv_sx,
    const void* inv_sy, const void* intensity, int q, int tile_h,
    int tile_w, int block_w, int blend, void* rows, void* row_blend,
    void* blended, void* color, void* trans, void* stream) {
  const int num_tiles = grid_h * grid_w;
  const int px = tile_h * tile_w;
  if (block_w < 1 || kWarp % block_w || tile_w % block_w
      || tile_h % (kWarp / block_w) || px % kWarp || px > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_tiles <= 0 || num_rows <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* cx = static_cast<const float*>(s_cx);
  const auto* cy = static_cast<const float*>(s_cy);
  const auto* w = static_cast<const float*>(s_w);
  const auto* cgb = static_cast<const unsigned int*>(s_cgb);
  const auto* tv = static_cast<const int*>(tile_v);
  const auto* jv = static_cast<const int*>(j_v);
  const auto* lo = static_cast<const int*>(lo_k);
  const auto* hi = static_cast<const int*>(hi_k);
  const auto* rs = static_cast<const int*>(row_start);
  const auto* re = static_cast<const int*>(row_end);
  const auto* isx = static_cast<const float*>(inv_sx);
  const auto* isy = static_cast<const float*>(inv_sy);
  const auto* sa = static_cast<const float*>(intensity);
  auto* r = static_cast<float*>(rows);
  auto* rb = static_cast<int*>(row_blend);
  auto* n = static_cast<unsigned long long*>(blended);
  auto* c = static_cast<float*>(color);
  auto* tr = static_cast<float*>(trans);
  const int width = grid_w * tile_w;
  const size_t lists = static_cast<size_t>(px / kWarp) * kStage;
  if (blend == 0) {
    tile_rows_kernel<true><<<(unsigned)num_rows, px, lists, st>>>(
        cx, cy, w, cgb, e_total, tv, jv, lo, hi, re, num_tiles, isx, isy, sa,
        q, grid_w, tile_h, tile_w, block_w, r, rb, n);
    tile_fold_kernel<true><<<num_tiles, px, 0, st>>>(
        r, rs, re, grid_w, tile_h, tile_w, width, c, tr, rb, n);
  } else {
    tile_rows_kernel<false><<<(unsigned)num_rows, px, lists, st>>>(
        cx, cy, w, cgb, e_total, tv, jv, lo, hi, re, num_tiles, isx, isy, sa,
        q, grid_w, tile_h, tile_w, block_w, r, rb, n);
    tile_fold_kernel<false><<<num_tiles, px, 0, st>>>(
        r, rs, re, grid_w, tile_h, tile_w, width, c, tr, rb, n);
  }
  return static_cast<int>(cudaGetLastError());
}
