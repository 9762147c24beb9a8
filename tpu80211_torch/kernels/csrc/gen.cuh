// The counter-based generator of the generative kernels (gen_chain.cu,
// raw_gen_chain.cu): Philox4x32-10 (Salmon et al., SC'11; the Random123
// constants), 24-bit uniforms and Box-Muller normals, and the per-frame
// channel draw.
//
// A draw is one Philox call.  The key holds the seed; the counter holds
// (frame index, draw index, purpose, sub-index), so a frame's numbers depend
// only on (seed, frame): not on the batch size, the block size or the order
// in which blocks run.  The purposes, with the words each call feeds:
//   TAPS     (f, l, 0, 0):  words 0,1 -> channel tap l
//   PREAMBLE (f, k, 1, 0):  words 0,1 -> repeat-1 noise at bin k; 2,3 -> repeat 2
//   BLOCK    (f, k, 2, b):  words 0,1 -> block-b noise at bin k
//   OFFSET   (f, 0, 3, 0):  word 0 -> the frame's offset; word 1 -> its CFO
//   NOISE    (f, r, 4, 0):  words 0,1 -> the noise of stream row r
// Words 2,3 of the other purposes are not used.
//
// Normals agree bit for bit with the plain PyTorch version
// (kernels/gen_chain.py::philox, normal_pair): the uniforms are exact f32
// values, u1 = (w >> 8) 2^-24 + 2^-25 and u2 = (w >> 8) 2^-24 (the TPU
// kernel's, gen_chain.py:143-147); sqrt(-2 ln u1), the angle 2 pi u2, its
// cos and sin, and the two products are taken in f64 and rounded to f32
// once.  The TPU kernel's bitcast polynomial ln is a Mosaic workaround and
// is not ported.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace gen {

enum Purpose : uint32_t { TAPS = 0, PREAMBLE = 1, BLOCK = 2, OFFSET = 3, NOISE = 4 };

constexpr int MAX_TAPS = 16;  // ops/channel.py::n_taps_for clips to [8, 16]
constexpr double TWO_PI = 6.28318530717958647692528676655900577;

__device__ __forceinline__ uint4 philox(uint4 c, uint2 k) {
  constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k.x += W0;
      k.y += W1;
    }
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ uint2 key_of(int seed) {
  return make_uint2(static_cast<uint32_t>(seed), 0u);
}

__device__ __forceinline__ uint4 draw(uint2 key, long long frame, int index, Purpose what,
                                      int sub = 0) {
  return philox(make_uint4(static_cast<uint32_t>(frame), static_cast<uint32_t>(index), what,
                           static_cast<uint32_t>(sub)),
                key);
}

// (0, 1]: never 0, so its log is finite
__device__ __forceinline__ float uniform_open(uint32_t w) {
  return __fadd_rn(__fmul_rn(__uint2float_rn(w >> 8), 0x1p-24f), 0x1p-25f);
}

// [0, 1)
__device__ __forceinline__ float uniform(uint32_t w) {
  return __fmul_rn(__uint2float_rn(w >> 8), 0x1p-24f);
}

// Two standard normals from two words (Box-Muller).
__device__ __forceinline__ float2 normal_pair(uint32_t a, uint32_t b) {
  const double r = sqrt(-2.0 * log(static_cast<double>(uniform_open(a))));
  double sn, cs;
  sincos(TWO_PI * static_cast<double>(uniform(b)), &sn, &cs);
  return make_float2(static_cast<float>(r * cs), static_cast<float>(r * sn));
}

__device__ __forceinline__ float2 cmul_rn(float2 a, float2 b) {
  return make_float2(__fsub_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                     __fadd_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x)));
}

// The frame's channel at this thread's bins k = g + GROUPS*j: n_taps taps
// t_l = z_l * tscale[l] (f32), then H[k] = sum_l W[k][l] t_l in f64, rounded
// to f32 once.  wc: (N_SC, MAX_TAPS) in shared memory.
template <int BINS, int GROUPS, int N_SC>
__device__ __forceinline__ void channel_bins(uint2 key, long long f, int n_taps,
                                             const float* tscale, const float2 (*wc)[MAX_TAPS],
                                             int g, float2 (&h)[BINS]) {
  double hr[BINS], hi[BINS];
#pragma unroll
  for (int j = 0; j < BINS; ++j) hr[j] = hi[j] = 0.0;
  for (int l = 0; l < n_taps; ++l) {
    const uint4 w = draw(key, f, l, TAPS);
    const float2 z = normal_pair(w.x, w.y);
    const double tr = __fmul_rn(z.x, tscale[l]), ti = __fmul_rn(z.y, tscale[l]);
#pragma unroll
    for (int j = 0; j < BINS; ++j) {
      const int k = g + GROUPS * j;
      if (k < N_SC) {
        const float2 c = wc[k][l];
        hr[j] += static_cast<double>(c.x) * tr - static_cast<double>(c.y) * ti;
        hi[j] += static_cast<double>(c.x) * ti + static_cast<double>(c.y) * tr;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < BINS; ++j) h[j] = make_float2(static_cast<float>(hr[j]), static_cast<float>(hi[j]));
}

}  // namespace gen
