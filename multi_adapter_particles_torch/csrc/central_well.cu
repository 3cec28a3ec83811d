// Fused central-well integrator: force + semi-implicit Euler + |a| in one pass.
//
// Replaces the TPU kernel `multi_adapter_particles_tpu/ops/central_well.py`
// `_kernel` (launcher `central_well_step_pallas`), which tiles the SoA lane
// dimension through VMEM 16384 lanes at a time.
//
// Bound on the H100: device memory bandwidth. Per live particle the step
// reads pos x,y,z and vel x,y,z and writes pos x,y,z,|a| and vel x,y,z:
// 28 B in + 28 B out, ~20 flops -> about 235 MB per step at 4M particles,
// ~70 us at 3.35 TB/s. Nothing is reused, so no shared memory: the design
// is one thread per particle in a grid-stride loop over the [4, Np] /
// [3, Np] planes, so each warp reads and writes 128 contiguous bytes per
// plane (fully coalesced). float4 loads can come later.
//
// `num_live` (num_sim rounded up to 64 by the caller) freezes the tail:
// particles at or past it are copied through unchanged (w included), so
// the output buffer -- the other half of the engine's swapped pair -- holds
// the frozen tail bit for bit.
//
// Arithmetic follows `_kernel`'s order: d2 = x*x + y*y + z*z + eps2,
// inv = rsqrt(d2), s = -mass * inv^3, v = (v + a*dt) * damping,
// p = p + v*dt, w = sqrt(ax^2 + ay^2 + az^2). rsqrtf and FMA contraction
// differ from torch's separate ops by a few ulp.

#include <cuda_runtime.h>

namespace {

__global__ void central_well_kernel(const float* __restrict__ pos,
                                    const float* __restrict__ vel,
                                    float* __restrict__ out_pos,
                                    float* __restrict__ out_vel,
                                    long long n, long long num_live,
                                    float dt, float damping, float neg_mass,
                                    float eps2) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float x = pos[i];
    const float y = pos[n + i];
    const float z = pos[2 * n + i];
    const float vx0 = vel[i];
    const float vy0 = vel[n + i];
    const float vz0 = vel[2 * n + i];
    if (i < num_live) {
      const float d2 = x * x + y * y + z * z + eps2;
      const float inv = rsqrtf(d2);
      const float s = neg_mass * (inv * inv * inv);
      const float ax = x * s;
      const float ay = y * s;
      const float az = z * s;
      const float vx = (vx0 + ax * dt) * damping;
      const float vy = (vy0 + ay * dt) * damping;
      const float vz = (vz0 + az * dt) * damping;
      out_pos[i] = x + vx * dt;
      out_pos[n + i] = y + vy * dt;
      out_pos[2 * n + i] = z + vz * dt;
      out_pos[3 * n + i] = sqrtf(ax * ax + ay * ay + az * az);
      out_vel[i] = vx;
      out_vel[n + i] = vy;
      out_vel[2 * n + i] = vz;
    } else {
      out_pos[i] = x;
      out_pos[n + i] = y;
      out_pos[2 * n + i] = z;
      out_pos[3 * n + i] = pos[3 * n + i];
      out_vel[i] = vx0;
      out_vel[n + i] = vy0;
      out_vel[2 * n + i] = vz0;
    }
  }
}

}  // namespace

// pos [4, n], vel [3, n] -> out_pos [4, n], out_vel [3, n]; all float32,
// contiguous, on the current device. Returns cudaGetLastError().
extern "C" int central_well_step(const void* pos, const void* vel,
                                 void* out_pos, void* out_vel, long long n,
                                 long long num_live, float dt, float damping,
                                 float mass, float eps2, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  // a few waves of resident blocks; the grid-stride loop covers the rest
  const long long max_blocks = 132LL * 16;
  if (blocks > max_blocks) blocks = max_blocks;
  central_well_kernel<<<(unsigned)blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<const float*>(vel),
      static_cast<float*>(out_pos), static_cast<float*>(out_vel), n, num_live,
      dt, damping, -mass, eps2);
  return static_cast<int>(cudaGetLastError());
}
