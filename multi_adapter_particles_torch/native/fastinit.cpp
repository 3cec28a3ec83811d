// Native particle initializer — the LoadParticles performance tier.
//
// The reference initializes up to 4M particles on the CPU with three
// selectable implementations (std::mt19937 / scalar LCG fast_rand / SSE2
// 4-wide LCG rand_sse) parallelized with concurrency::parallel_for
// (Particles/Compute.cpp:580-812). This is the same capability, C++17 +
// std::thread, exposed through a C ABI for ctypes.
//
// Bit-exactness contract: variants "scalar" and "simd" reproduce the NumPy
// oracle (models/oracle.py FastRand / RandSse) bit-for-bit when chunks == 1,
// because the LCG streams and the float32 math are identical. Compile with
// -ffp-contract=off so the compiler cannot fuse a*b+c into FMA and change
// roundings vs. the oracle.
//
// Parallel mode (chunks > 1): the RNG consumption per particle is data-
// dependent (rejection loop), so a single stream cannot be split; instead
// each chunk gets its own derived seed — deterministic for a given
// (seed, chunks), mirroring the reference's per-thread thread_local seeds
// (Compute.cpp:596,619) but reproducibly.
//
// The port's own copy of the JAX package's native/fastinit.cpp, the same C
// ABI; native/fastinit.py builds it with g++ at first use
// (ops/_build.build_host).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

namespace {

constexpr float kDeltaLenSqMin = 10.0f;  // Compute.cpp:690-695
constexpr int kRandMax = 0x7FFF;

// ---------------------------------------------------------------------------
// RNG tiers
// ---------------------------------------------------------------------------
struct FastRand {  // Compute.cpp:602-609
  uint32_t state;
  explicit FastRand(uint32_t seed) : state(seed) {}
  inline int next() {
    state = 214013u * state + 2531011u;
    return static_cast<int>((state >> 16) & 0x7FFF);
  }
};

struct RandSse {  // Compute.cpp:625-661, compat mode
  uint32_t state[4];
  explicit RandSse(uint32_t seed) {
    state[0] = seed + 1u;
    state[1] = seed;
    state[2] = seed + 1u;
    state[3] = seed;
  }
  static constexpr uint32_t kMult[4] = {214013u, 17405u, 214013u, 69069u};
  static constexpr uint32_t kAdd[4] = {2531011u, 10395331u, 13737667u, 1u};
  inline void next4(int out[4]) {
    for (int i = 0; i < 4; ++i) {
      state[i] = kMult[i] * state[i] + kAdd[i];
      out[i] = static_cast<int>((state[i] >> 16) & 0x7FFF);
    }
  }
};

inline float kscale() {
  return static_cast<float>((1.0 / kRandMax) * 2.0);
}

// ---------------------------------------------------------------------------
// Shared finalize tail (Compute.cpp:697-708; oracle _finalize)
// ---------------------------------------------------------------------------
inline void finalize(const float delta_in[3], const float center[3],
                     float speed, float spread, float* pos, float* vel) {
  float d[3] = {delta_in[0], delta_in[1], delta_in[2]};
  float len = std::sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
  d[0] /= len;
  d[1] /= len;
  d[2] /= len;
  float p[3] = {center[0] + d[0] * spread, center[1] + d[1] * spread,
                center[2] + d[2] * spread};
  float plen = std::sqrt(p[0] * p[0] + p[1] * p[1] + p[2] * p[2]);
  float dir[3] = {p[0] / plen, p[1] / plen, p[2] / plen};
  float perp[3] = {1.0f - dir[0], 1.0f - dir[1], 1.0f - dir[2]};
  float qlen =
      std::sqrt(perp[0] * perp[0] + perp[1] * perp[1] + perp[2] * perp[2]);
  perp[0] /= qlen;
  perp[1] /= qlen;
  perp[2] /= qlen;
  // vel = cross(dir, perp) * speed
  vel[0] = (dir[1] * perp[2] - dir[2] * perp[1]) * speed;
  vel[1] = (dir[2] * perp[0] - dir[0] * perp[2]) * speed;
  vel[2] = (dir[0] * perp[1] - dir[1] * perp[0]) * speed;
  pos[0] = p[0];
  pos[1] = p[1];
  pos[2] = p[2];
  pos[3] = 0.0f;  // pos.w (|accel|) starts 0, Compute.cpp:825-829
}

// ---------------------------------------------------------------------------
// Per-variant particle loops (oracle load_particles)
// ---------------------------------------------------------------------------
void load_scalar(int64_t n, uint32_t seed, const float center[3], float speed,
                 float spread, float* pos, float* vel) {
  FastRand rng(seed);
  const float ks = kscale();
  for (int64_t i = 0; i < n; ++i) {
    float d[3];
    for (int c = 0; c < 3; ++c)
      d[c] = static_cast<float>(rng.next()) * ks - 1.0f;
    while (d[0] * d[0] + d[1] * d[1] + d[2] * d[2] < kDeltaLenSqMin) {
      for (int c = 0; c < 3; ++c)
        d[c] += static_cast<float>(rng.next()) * ks - 1.0f;
    }
    finalize(d, center, speed, spread, pos + 4 * i, vel + 3 * i);
  }
}

void load_simd(int64_t n, uint32_t seed, const float center[3], float speed,
               float spread, float* pos, float* vel) {
  RandSse rng(seed);
  const float ks = kscale();
  for (int64_t i = 0; i < n; ++i) {
    float d[4] = {0, 0, 0, 0};
    for (;;) {
      int r[4];
      rng.next4(r);
      for (int c = 0; c < 4; ++c)
        d[c] += static_cast<float>(r[c]) * ks - 1.0f;
      if (d[0] * d[0] + d[1] * d[1] + d[2] * d[2] >= kDeltaLenSqMin) break;
    }
    finalize(d, center, speed, spread, pos + 4 * i, vel + 3 * i);
  }
}

void load_orig(int64_t n, uint32_t seed, const float center[3], float speed,
               float spread, float* pos, float* vel) {
  // USE_ORIG tier: Mersenne Twister uniforms. Deterministic for a given
  // seed but NOT bit-identical to the NumPy oracle (different MT usage).
  std::mt19937 gen(seed);
  std::uniform_real_distribution<float> uni(-1.0f, 1.0f);
  for (int64_t i = 0; i < n; ++i) {
    float d[3] = {uni(gen), uni(gen), uni(gen)};
    while (d[0] * d[0] + d[1] * d[1] + d[2] * d[2] < kDeltaLenSqMin) {
      for (int c = 0; c < 3; ++c) d[c] += uni(gen);
    }
    finalize(d, center, speed, spread, pos + 4 * i, vel + 3 * i);
  }
}

using LoadFn = void (*)(int64_t, uint32_t, const float[3], float, float,
                        float*, float*);

LoadFn pick(const char* variant) {
  if (std::strcmp(variant, "scalar") == 0) return load_scalar;
  if (std::strcmp(variant, "simd") == 0) return load_simd;
  if (std::strcmp(variant, "orig") == 0) return load_orig;
  return nullptr;
}

}  // namespace

extern "C" {

// Fill one cluster. chunks > 1 splits into `chunks` independent streams run
// on worker threads (seed_c = seed + 0x9E3779B9 * c). Returns 0 on success.
int map_load_particles(int64_t n, const char* variant, uint32_t seed,
                       float cx, float cy, float cz, float speed,
                       float spread, int32_t chunks, float* pos, float* vel) {
  LoadFn fn = pick(variant);
  if (fn == nullptr || n < 0) return 1;
  const float center[3] = {cx, cy, cz};
  if (chunks <= 1 || n < chunks) {
    fn(n, seed, center, speed, spread, pos, vel);
    return 0;
  }
  std::vector<std::thread> workers;
  int64_t per = n / chunks;
  for (int32_t c = 0; c < chunks; ++c) {
    int64_t lo = per * c;
    int64_t cnt = (c == chunks - 1) ? (n - lo) : per;
    uint32_t s = seed + 0x9E3779B9u * static_cast<uint32_t>(c);
    workers.emplace_back(fn, cnt, s, center, speed, spread, pos + 4 * lo,
                         vel + 3 * lo);
  }
  for (auto& w : workers) w.join();
  return 0;
}

// ABI version stamp so the Python loader can detect stale builds.
int map_fastinit_abi_version() { return 1; }

}  // extern "C"
