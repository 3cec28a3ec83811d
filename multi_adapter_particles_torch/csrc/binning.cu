// Exact sprite binning: every drawn sprite's tile entries, in particle order.
// Two kernels, one launch each per render (chunk).
//
// Replaces no TPU kernel. The JAX renderer (`render/renderer.py` there)
// bins each sprite into a fixed dup_y x dup_x window of tiles as XLA ops and
// drops the tiles outside it (`truncated`); only a host read in `present()`
// grows the window. Here each sprite emits exactly the tiles its pixel
// rectangle covers, with no host read and no shape that depends on data, so
// a CUDA graph captures the launches. ops/binning.py holds the plain torch
// version (`bin_sprites_plain`), which computes the same entries with torch
// ops.
//
// What it computes, for the particles p of a render (chunk), column p of
// position [4, n], global id p + id_offset:
//   projection: clip = [x y z 1] @ WVP; cx, cy the pixel centre, hx, hy the
//     half-extents (radius * proj / w), w = clip.w; the pixel rectangle
//     [ceil(cx - hx - 0.5), ceil(cx + hx - 0.5)) x (the same in y), clamped
//     to the frame; drawn when p < num_draw, w > near and the rectangle
//     holds a pixel;
//   colour: (cg, cb) from |a| and the id (`ParticleDraw.hlsl:104-109`),
//     packed as two f16 halves in one word (`pack_cgb`);
//   count: span_h x span_w tiles (tile_h x tile_w pixels) for a drawn
//     sprite, else 0;
//   emit: at offset off_p = the exclusive scan of the counts in particle
//     order, entry off_p + j is tile (ty0 + j / span_w, tx0 + j % span_w)
//     with key = tile row * grid_w + tile column and the payloads (cx, cy,
//     w, cgb). Offsets at or past the capacity are not written; they are the
//     frame's `truncated` count. Slots [entries, capacity) get the sentinel
//     key num_tiles, and those below the next multiple of `row` (the
//     composite's data-row width) zero payloads: a composite that blends a
//     whole data row reads finite values there. Later tail slots keep
//     whatever the buffer held; the stable sort carries them after every
//     tile and nothing reads them.
//
// bin_count_kernel: a CTA a tile of 2,048 particles, 8 a thread; projects,
//   counts, and writes each tile's count sum and largest spans.
// bin_emit_kernel: a CTA a tile. Each CTA first sums the tile sums before
//   its own (its offset) and all of them (the frame's total and spans:
//   512 words a 1M chunk, read from L2 by every CTA, which costs less than
//   a third launch for a scan); CTA 0 writes the stats: entries (min(total,
//   capacity)), truncated (the entries past the capacity, at most
//   INT32_MAX), span_y, span_x. Then it projects its particles again, 256
//   at a time in particle order, scans their counts inside the CTA, and
//   writes each sprite's entries; last the grid writes the tail.
//
// Bound on the H100: bytes. The least the binning needs is the position
// read once (16 B a particle) and one 20 B entry (key and four payload
// words) a particle: 36 MB a 1M chunk, 10.7 us at 3.35 TB/s
// (benchmark/metrics/bin_bytes_pct.py). The kernels read the position twice
// (count and emit: recomputing the projection costs less than storing it)
// and write the sentinel keys of the tail. Neighbouring threads write
// their sprites' entries at neighbouring offsets. No atomics: every output
// has one writer, so the result is the same run to run.
//
// Build with -fmad=false (ops/binning.py does): every multiply and add
// rounds on its own, as the torch ops of the plain version do, so the
// entries match it bit for bit. 1.0f / w is IEEE division, as torch's
// reciprocal. Clamps are fminf(fmaxf(x, lo), hi): torch.clamp for every
// non-NaN input.

#include <climits>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;           // threads a CTA
constexpr int kPer = 8;                 // particles a thread
constexpr int kTile = kThreads * kPer;  // particles a CTA: a tile

struct View {
  const float* wvp;       // [4, 4] row-vector world-view-projection
  const float* p00;       // proj[0, 0], proj[1, 1], the sprite radius
  const float* p11;
  const float* radius;
  const int* num_draw;    // 0-dim device draw count, or null: num_draw_host
  long long num_draw_host;
  long long n;            // particles (columns of position)
  long long ld;           // position's row stride (a chunk's view: N)
  long long id_offset;    // global id of column 0
  float width, height, near_clip;
  float inv_color_scale, g_cold, g_span, inv_id_mask;
  int id_mask, grid_w, tile_h, tile_w;
};

struct Sprite {
  float cx, cy, w;
  unsigned int cgb;
  int tx0, ty0, span_h, span_w;
  int count;              // span_h * span_w when drawn, else 0
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// ceil(edge - 0.5) clamped to [0, limit], as an int (`_pixel_bound`)
__device__ __forceinline__ int pixel_bound(float edge, float limit) {
  return (int)clampf(ceilf(edge - 0.5f), 0.0f, limit);
}

// torch.nan_to_num(x, nan=0, posinf=0, neginf=0)
__device__ __forceinline__ float finite_or_zero(float x) {
  return isfinite(x) ? x : 0.0f;
}

__device__ __forceinline__ unsigned int half_bits(float x) {
  return (unsigned int)__half_as_ushort(__float2half_rn(x));
}

__device__ Sprite project(const float* __restrict__ pos, long long p,
                          const View& v, long long draw) {
  const long long ld = v.ld;
  const float x = pos[p], y = pos[ld + p], z = pos[2 * ld + p];
  const float a = pos[3 * ld + p];
  const float* m = v.wvp;
  const float cxc = x * m[0] + y * m[4] + z * m[8] + m[12];
  const float cyc = x * m[1] + y * m[5] + z * m[9] + m[13];
  const float w = x * m[3] + y * m[7] + z * m[11] + m[15];
  const float inv_w = 1.0f / w;
  const float hw = 0.5f * v.width, hh = 0.5f * v.height;
  Sprite s;
  const float cx = (cxc * inv_w + 1.0f) * hw;
  const float cy = (1.0f - cyc * inv_w) * hh;
  const float hx = (*v.radius * *v.p00) * inv_w * hw;
  const float hy = (*v.radius * *v.p11) * inv_w * hh;
  const int px0 = pixel_bound(cx - hx, v.width);
  const int px1 = pixel_bound(cx + hx, v.width);
  const int py0 = pixel_bound(cy - hy, v.height);
  const int py1 = pixel_bound(cy + hy, v.height);
  const bool drawn = p < draw && w > v.near_clip && px0 < px1 && py0 < py1;
  s.tx0 = px0 / v.tile_w;
  s.ty0 = py0 / v.tile_h;
  s.span_w = drawn ? (px1 - 1) / v.tile_w - s.tx0 + 1 : 0;
  s.span_h = drawn ? (py1 - 1) / v.tile_h - s.ty0 + 1 : 0;
  s.count = s.span_h * s.span_w;
  s.cx = finite_or_zero(cx);
  s.cy = finite_or_zero(cy);
  s.w = w;
  const float mag = a * v.inv_color_scale;
  const float g = v.g_cold + mag * v.g_span;
  const int id = (int)(p + v.id_offset);
  const float b = (float)(id & v.id_mask) * v.inv_id_mask;
  s.cgb = (half_bits(clampf(g, 0.0f, 6.0e4f)) << 16) | half_bits(b);
  return s;
}

__device__ __forceinline__ long long draw_count(const View& v) {
  return v.num_draw != nullptr ? (long long)*v.num_draw : v.num_draw_host;
}

// the sum and the largest spans of one value a thread over the CTA (every
// thread gets them)
struct Reduced {
  long long sum;
  int span_h, span_w;
};

__device__ Reduced block_reduce(long long sum, int sh, int sw) {
  __shared__ long long s_sum[kThreads / 32];
  __shared__ int s_h[kThreads / 32], s_w[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
    sh = max(sh, __shfl_xor_sync(0xffffffffu, sh, o));
    sw = max(sw, __shfl_xor_sync(0xffffffffu, sw, o));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();   // the previous call's reads are done
  if (lane == 0) {
    s_sum[warp] = sum;
    s_h[warp] = sh;
    s_w[warp] = sw;
  }
  __syncthreads();
  Reduced r{0, 0, 0};
  for (int i = 0; i < kThreads / 32; ++i) {   // the same order everywhere
    r.sum += s_sum[i];
    r.span_h = max(r.span_h, s_h[i]);
    r.span_w = max(r.span_w, s_w[i]);
  }
  return r;
}

// the exclusive scan of one count a thread over the CTA, in thread order;
// `total` gets the CTA's sum
__device__ long long block_exclusive_scan(int x, long long* total) {
  __shared__ long long s_warp[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long incl = x;
  for (int o = 1; o < 32; o <<= 1) {
    const long long up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  __syncthreads();   // the previous call's reads are done
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  long long before = 0, sum = 0;
  for (int i = 0; i < kThreads / 32; ++i) {
    if (i < warp) before += s_warp[i];
    sum += s_warp[i];
  }
  *total = sum;
  return before + incl - x;
}

__global__ void bin_count_kernel(const float* __restrict__ pos, View v,
                                 long long* __restrict__ tile_sum,
                                 int2* __restrict__ tile_span) {
  const long long base = (long long)blockIdx.x * kTile + threadIdx.x;
  const long long draw = draw_count(v);
  long long sum = 0;
  int sh = 0, sw = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const long long p = base + k * kThreads;
    if (p < v.n) {
      const Sprite s = project(pos, p, v, draw);
      sum += s.count;
      sh = max(sh, s.span_h);
      sw = max(sw, s.span_w);
    }
  }
  const Reduced r = block_reduce(sum, sh, sw);
  if (threadIdx.x == 0) {
    tile_sum[blockIdx.x] = r.sum;
    tile_span[blockIdx.x] = make_int2(r.span_h, r.span_w);
  }
}

__global__ void bin_emit_kernel(const float* __restrict__ pos, View v,
                                const long long* __restrict__ tile_sum,
                                const int2* __restrict__ tile_span,
                                long long capacity, int row, int num_tiles,
                                int* __restrict__ key, float* __restrict__ cx,
                                float* __restrict__ cy, float* __restrict__ w,
                                unsigned int* __restrict__ cgb,
                                int* __restrict__ stats) {
  // this tile's offset (the earlier tiles' counts) and the frame's totals,
  // each CTA from the count kernel's tile sums
  long long before = 0, all = 0;
  int sh = 0, sw = 0;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kThreads) {
    const long long t = tile_sum[i];
    all += t;
    if (i < (int)blockIdx.x) before += t;
    const int2 span = tile_span[i];
    sh = max(sh, span.x);
    sw = max(sw, span.y);
  }
  const Reduced frame = block_reduce(all, sh, sw);
  long long off = block_reduce(before, 0, 0).sum;
  const long long total = frame.sum;
  const long long entries = total < capacity ? total : capacity;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const long long over = total - entries;
    stats[0] = (int)entries;
    stats[1] = (int)(over < (long long)INT_MAX ? over : (long long)INT_MAX);
    stats[2] = frame.span_h;
    stats[3] = frame.span_w;
  }

  const long long base = (long long)blockIdx.x * kTile + threadIdx.x;
  const long long draw = draw_count(v);
  for (int k = 0; k < kPer; ++k) {
    const long long p = base + k * kThreads;
    Sprite s;
    s.count = 0;
    if (p < v.n) s = project(pos, p, v, draw);
    long long round;
    const long long at = off + block_exclusive_scan(s.count, &round);
    off += round;
    const int stop = (int)min((long long)s.count, max(capacity - at, 0LL));
    for (int j = 0; j < stop; ++j) {
      const long long e = at + j;
      const int dy = j / s.span_w, dx = j - dy * s.span_w;
      key[e] = (s.ty0 + dy) * v.grid_w + s.tx0 + dx;
      cx[e] = s.cx;
      cy[e] = s.cy;
      w[e] = s.w;
      cgb[e] = s.cgb;
    }
  }
  // the tail: sentinel keys; zero payloads up to the data row's end
  const long long zero_end = min(capacity, (entries + row - 1) / row * row);
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long e = entries + (long long)blockIdx.x * kThreads
                     + threadIdx.x;
       e < capacity; e += stride) {
    key[e] = num_tiles;
    if (e < zero_end) {
      cx[e] = 0.0f;
      cy[e] = 0.0f;
      w[e] = 0.0f;
      cgb[e] = 0u;
    }
  }
}

}  // namespace

extern "C" {

int bin_tile() { return kTile; }

// position [4, n] f32 with row stride ld; wvp [4, 4], p00, p11, radius
// 0-dim f32 on the device; num_draw a 0-dim int32 device count or null
// (then num_draw_host); outputs key, cx, cy, w, cgb [capacity]; stats int32
// [4] (entries, truncated, span_y, span_x); scratch: tile_sum int64
// [tiles], tile_span int32 [tiles, 2], tiles = ceil(n / bin_tile()).
int bin_sprites(const float* pos, long long n, long long ld,
                const float* wvp, const float* p00, const float* p11,
                const float* radius, const int* num_draw,
                long long num_draw_host, long long id_offset, int width,
                int height, float near_clip, float inv_color_scale,
                float g_cold, float g_span, int id_mask, float inv_id_mask,
                int tile_h, int tile_w, long long capacity, int row, int* key,
                float* cx, float* cy, float* w, unsigned int* cgb, int* stats,
                long long* tile_sum, int* tile_span, void* stream) {
  if (n <= 0 || ld < n || capacity < 0 || capacity > INT_MAX || row < 1 ||
      tile_h < 1 || tile_w < 1)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (n + kTile - 1) / kTile;
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  View v;
  v.wvp = wvp;
  v.p00 = p00;
  v.p11 = p11;
  v.radius = radius;
  v.num_draw = num_draw;
  v.num_draw_host = num_draw_host;
  v.n = n;
  v.ld = ld;
  v.id_offset = id_offset;
  v.width = (float)width;
  v.height = (float)height;
  v.near_clip = near_clip;
  v.inv_color_scale = inv_color_scale;
  v.g_cold = g_cold;
  v.g_span = g_span;
  v.inv_id_mask = inv_id_mask;
  v.id_mask = id_mask;
  v.grid_w = width / tile_w;
  v.tile_h = tile_h;
  v.tile_w = tile_w;
  const int num_tiles = (height / tile_h) * v.grid_w;
  int2* span = reinterpret_cast<int2*>(tile_span);
  bin_count_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(pos, v, tile_sum,
                                                        span);
  bin_emit_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
      pos, v, tile_sum, span, capacity, row, num_tiles, key, cx, cy, w, cgb,
      stats);
  return (int)cudaGetLastError();
}

}  // extern "C"
