// The counter-based generator of the generative kernels (gen_chain.cu,
// raw_gen_chain.cu): Philox4x32-10 (Salmon et al., SC'11; the Random123
// constants), 24-bit uniforms and Box-Muller normals, and the per-frame
// channel draw (each tap drawn once, by one warp, then summed from shared
// memory by every thread).
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
// kernel's, gen_chain.py:143-147); sqrt(-2 ln u1), the angle fl(2 pi u2),
// its cos and sin, and the two products are taken in f64 and rounded to f32
// once.  ln, sin and cos are this header's own (a table and series, each
// within an f64 ulp of the plain version's on all 2^24 values); the TPU
// kernel's f32 bitcast polynomial ln is a Mosaic workaround and is not
// ported.

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

// -- Box-Muller in f64, from the uniforms' bits -----------------------------------
// r = sqrt(-2 ln u1) and the cos and sin of theta = fl(2 pi u2), the plain
// version's terms, by short polynomials in place of the library's log and
// sincos: ln from a table (ln_uniform), the angle reduced by the multiple of
// pi/2 that u2's top bits give (sincos_turn).  Both are faithful: within an
// f64 ulp of the exact value, though not always its correct rounding (about
// one sin or cos in six is an ulp off, as torch's log is for one u1 in
// eight), and within an ulp of torch's log, sin and cos on the CPU.  The
// normals are rounded to f32 once.  The fused multiply-adds are written out,
// so the arithmetic is the same wherever the source is compiled.

// One interval of ln_uniform's table (gen_tables.py): R close to 1 over its
// centre, -ln R = hi + lo.
struct LnEntry {
  float r;
  float lo;
  double hi;
};
constexpr int LN_ENTRIES = 256;  // the top 8 bits of the mantissa
constexpr double LN2_HI = 0x1.62e42fefa3ap-1;  // a multiple of 2^-45
constexpr double LN2_LO = -0x1.0ca86c3898dp-49;

// The table in device memory; a kernel stages it in shared memory
// (stage_ln) for its hot draws.
__device__ const LnEntry LN_TABLE[LN_ENTRIES] = {
    {0x1p+0f, 0x0p+0f, 0x0p+0},
    {0x1.fd047ap-1f, 0x1.7cca4cp-47f, 0x1.7ee0c33d8p-8},
    {0x1.fb0c62p-1f, -0x1.73c8fp-47f, 0x1.3e7258925cp-7},
    {0x1.f9182cp-1f, -0x1.d5e6b4p-49f, 0x1.bcf6ec4744p-7},
    {0x1.f727ccp-1f, 0x1.8a36fp-47f, 0x1.1d7f9bf9eep-6},
    {0x1.f53b3ap-1f, -0x1.8de578p-47f, 0x1.5c45ad3b8ep-6},
    {0x1.f35268p-1f, 0x1.49354p-48f, 0x1.9ace80d1ccp-6},
    {0x1.f16d4cp-1f, -0x1.99459ap-49f, 0x1.d91a6f8544p-6},
    {0x1.ef8bdcp-1f, 0x1.9fe79p-49f, 0x1.0b94eae196p-5},
    {0x1.edae0ap-1f, -0x1.dce5cep-47f, 0x1.2a7ecc314fp-5},
    {0x1.ebd3dp-1f, 0x1.1c88a6p-49f, 0x1.494acbb4d9p-5},
    {0x1.e9fd22p-1f, -0x1.121aa2p-48f, 0x1.67f93e994cp-5},
    {0x1.e829f4p-1f, 0x1.b676fep-47f, 0x1.868a7c683fp-5},
    {0x1.e65a3ep-1f, 0x1.1cce8p-48f, 0x1.a4fe9baa3dp-5},
    {0x1.e48df6p-1f, -0x1.8e564ap-50f, 0x1.c355d61922p-5},
    {0x1.e2c512p-1f, 0x1.5feedcp-52f, 0x1.e190675276p-5},
    {0x1.e0ff88p-1f, 0x1.83dda2p-48f, 0x1.ffae8cd9b9p-5},
    {0x1.df3d5p-1f, -0x1.c7d8dap-49f, 0x1.0ed831f5528p-4},
    {0x1.dd7e5ep-1f, 0x1.45ae7ep-48f, 0x1.1dcb27e5b18p-4},
    {0x1.dbc2acp-1f, -0x1.e0c8b6p-48f, 0x1.2cb0276f5ep-4},
    {0x1.da0a3p-1f, -0x1.f68594p-49f, 0x1.3b8752cb1b8p-4},
    {0x1.d854ep-1f, 0x1.54bd9ep-50f, 0x1.4a50cd2a1bp-4},
    {0x1.d6a2b4p-1f, -0x1.e11414p-47f, 0x1.590ca94f02p-4},
    {0x1.d4f3a2p-1f, 0x1.083a7cp-48f, 0x1.67bb0c2eecp-4},
    {0x1.d347a4p-1f, -0x1.d80384p-48f, 0x1.765bf8aa6cp-4},
    {0x1.d19eb2p-1f, 0x1.da2fdcp-51f, 0x1.84ef83b6828p-4},
    {0x1.cff8cp-1f, -0x1.21bc8cp-48f, 0x1.9375e65596p-4},
    {0x1.ce55c8p-1f, -0x1.857348p-47f, 0x1.a1ef25a062p-4},
    {0x1.ccb5c4p-1f, -0x1.ff38fep-47f, 0x1.b05b472ee48p-4},
    {0x1.cb18a8p-1f, -0x1.1cad6ep-49f, 0x1.beba86a1468p-4},
    {0x1.c97e7p-1f, 0x1.f28adap-47f, 0x1.cd0cd938c1p-4},
    {0x1.c7e712p-1f, 0x1.37d276p-48f, 0x1.db526a607d8p-4},
    {0x1.c65286p-1f, -0x1.cc452cp-47f, 0x1.e98b547e718p-4},
    {0x1.c4c0c6p-1f, -0x1.10776ep-47f, 0x1.f7b7a0a438p-4},
    {0x1.c331cap-1f, 0x1.4c1bc4p-47f, 0x1.02ebb547f3cp-3},
    {0x1.c1a58cp-1f, 0x1.d09ce4p-47f, 0x1.09f55e46718p-3},
    {0x1.c01c02p-1f, 0x1.b27fp-47f, 0x1.10f8e2fe538p-3},
    {0x1.be9526p-1f, -0x1.e10f3cp-47f, 0x1.17f6494bca8p-3},
    {0x1.bd10f4p-1f, -0x1.359752p-47f, 0x1.1eed8e1adc4p-3},
    {0x1.bb8f6p-1f, -0x1.26ad58p-47f, 0x1.25ded36bc6cp-3},
    {0x1.ba1068p-1f, -0x1.ac2fc8p-47f, 0x1.2cca0d8f5f4p-3},
    {0x1.b89402p-1f, -0x1.aeeb1ep-47f, 0x1.33af560b71p-3},
    {0x1.b71a28p-1f, -0x1.0ff02p-48f, 0x1.3a8eb4431a4p-3},
    {0x1.b5a2d4p-1f, -0x1.867c1p-50f, 0x1.41682fdf27cp-3},
    {0x1.b42ep-1f, -0x1.2b5b1cp-51f, 0x1.483bd0ce6e4p-3},
    {0x1.b2bba6p-1f, 0x1.640d26p-48f, 0x1.4f099f4623p-3},
    {0x1.b14bbep-1f, 0x1.6ecafep-47f, 0x1.55d1ad3632cp-3},
    {0x1.afde42p-1f, -0x1.3db236p-47f, 0x1.5c940379974p-3},
    {0x1.ae732ep-1f, -0x1.4f258ap-48f, 0x1.6350a1aeaa8p-3},
    {0x1.ad0a7ap-1f, -0x1.2872cep-47f, 0x1.6a079ab37acp-3},
    {0x1.aba42p-1f, -0x1.893d84p-47f, 0x1.70b8f83a1acp-3},
    {0x1.aa401ap-1f, 0x1.30c294p-47f, 0x1.7764c43cf2p-3},
    {0x1.a8de64p-1f, -0x1.88503cp-47f, 0x1.7e0aff5b0c4p-3},
    {0x1.a77ef8p-1f, 0x1.44239p-47f, 0x1.84abb40865p-3},
    {0x1.a621cep-1f, -0x1.a2bc2ep-47f, 0x1.8b46f6b6364p-3},
    {0x1.a4c6e2p-1f, -0x1.0e5488p-50f, 0x1.91dcc8c740cp-3},
    {0x1.a36e2ep-1f, 0x1.aab384p-48f, 0x1.986d358c18p-3},
    {0x1.a217aep-1f, -0x1.c9625cp-47f, 0x1.9ef83ed369cp-3},
    {0x1.a0c35cp-1f, 0x1.d146a6p-47f, 0x1.a57df06a44cp-3},
    {0x1.9f7132p-1f, -0x1.a05e8cp-47f, 0x1.abfe5668614p-3},
    {0x1.9e212ap-1f, -0x1.f15eb8p-47f, 0x1.b2797d30634p-3},
    {0x1.9cd34p-1f, 0x1.d6ccc8p-50f, 0x1.b8ef678420cp-3},
    {0x1.9b877p-1f, 0x1.da1ca4p-48f, 0x1.bf601850e44p-3},
    {0x1.9a3db2p-1f, 0x1.34b45ap-50f, 0x1.c5cba6a7ae4p-3},
    {0x1.98f604p-1f, 0x1.024126p-47f, 0x1.cc320bf9764p-3},
    {0x1.97b06p-1f, -0x1.428094p-51f, 0x1.d29355db6b4p-3},
    {0x1.966ccp-1f, 0x1.5e3408p-47f, 0x1.d8ef922f31cp-3},
    {0x1.952b2p-1f, 0x1.415158p-47f, 0x1.df46c50722cp-3},
    {0x1.93eb7ep-1f, -0x1.b997acp-47f, 0x1.e598e87e88p-3},
    {0x1.92addp-1f, -0x1.ea2198p-48f, 0x1.ebe61f6dd7cp-3},
    {0x1.917216p-1f, 0x1.bd1a18p-49f, 0x1.f22e5a36f1p-3},
    {0x1.903848p-1f, 0x1.14c92cp-49f, 0x1.f871b21955p-3},
    {0x1.8f0064p-1f, -0x1.90019ap-50f, 0x1.feb021f6608p-3},
    {0x1.8dca64p-1f, -0x1.a02f98p-47f, 0x1.0274dcaac24p-2},
    {0x1.8c9644p-1f, -0x1.72f47ap-49f, 0x1.058f3edc3ecp-2},
    {0x1.8b6402p-1f, -0x1.38c0ap-48f, 0x1.08a73539c58p-2},
    {0x1.8a3396p-1f, 0x1.7b44f6p-47f, 0x1.0bbccd0ad24p-2},
    {0x1.8904fep-1f, -0x1.549f74p-48f, 0x1.0ed0042c57ep-2},
    {0x1.87d834p-1f, 0x1.6e0e1cp-47f, 0x1.11e0e2f6d9cp-2},
    {0x1.86ad36p-1f, 0x1.6aacc2p-48f, 0x1.14ef676e868p-2},
    {0x1.8583fep-1f, -0x1.3ef1c4p-47f, 0x1.17fb9a2350ap-2},
    {0x1.845c8ap-1f, -0x1.6e9126p-47f, 0x1.1b05794107cp-2},
    {0x1.8336d4p-1f, 0x1.83dd94p-47f, 0x1.1e0d0d8f716p-2},
    {0x1.8212dap-1f, 0x1.769ed2p-51f, 0x1.21125562616p-2},
    {0x1.80f096p-1f, 0x1.7a0522p-52f, 0x1.241559b9d14p-2},
    {0x1.7fd006p-1f, -0x1.8586f4p-47f, 0x1.27161911f86p-2},
    {0x1.7eb124p-1f, -0x1.4545a4p-49f, 0x1.2a149ca362cp-2},
    {0x1.7d93fp-1f, -0x1.ea9608p-48f, 0x1.2d10ddb5086p-2},
    {0x1.7c7862p-1f, -0x1.e818aap-47f, 0x1.300aeb0e636p-2},
    {0x1.7b5e78p-1f, -0x1.bb703ep-48f, 0x1.3302c37d866p-2},
    {0x1.7a463p-1f, -0x1.83eb28p-47f, 0x1.35f865d932ap-2},
    {0x1.792f84p-1f, -0x1.bcfb06p-47f, 0x1.38ebdbdced4p-2},
    {0x1.781a72p-1f, -0x1.2b443cp-47f, 0x1.3bdd248914cp-2},
    {0x1.7706f6p-1f, -0x1.54a952p-47f, 0x1.3ecc445cf6p-2},
    {0x1.75f50cp-1f, -0x1.573cap-51f, 0x1.41b93ff0e0cp-2},
    {0x1.74e4bp-1f, 0x1.f1f0f4p-48f, 0x1.44a41bf63c4p-2},
    {0x1.73d5ep-1f, -0x1.de481ep-50f, 0x1.478cd7b59b4p-2},
    {0x1.72c89ap-1f, -0x1.9496ccp-48f, 0x1.4a737280cfap-2},
    {0x1.71bcd8p-1f, 0x1.11faap-47f, 0x1.4d57f6c6fe2p-2},
    {0x1.70b296p-1f, 0x1.6da054p-47f, 0x1.503a6992b1cp-2},
    {0x1.6fa9d4p-1f, -0x1.02b002p-47f, 0x1.531ac4e3ee8p-2},
    {0x1.6ea28ep-1f, 0x1.de49ap-47f, 0x1.55f90de043ep-2},
    {0x1.6d9cbep-1f, 0x1.e49352p-47f, 0x1.58d54f60e02p-2},
    {0x1.6c9864p-1f, -0x1.ca803cp-47f, 0x1.5baf838ea1cp-2},
    {0x1.6b957cp-1f, -0x1.581ef8p-47f, 0x1.5e87afd0296p-2},
    {0x1.6a9402p-1f, -0x1.7c281ep-47f, 0x1.615dd9a5ec2p-2},
    {0x1.6993f4p-1f, -0x1.c2fa0cp-49f, 0x1.64320100448p-2},
    {0x1.68954ep-1f, 0x1.8943bp-49f, 0x1.67042b8783ep-2},
    {0x1.67980ep-1f, 0x1.63c3cp-49f, 0x1.69d4594c036p-2},
    {0x1.669c32p-1f, -0x1.acd56ep-48f, 0x1.6ca28a6834ap-2},
    {0x1.65a1b4p-1f, 0x1.24b28p-47f, 0x1.6f6eca74b22p-2},
    {0x1.64a894p-1f, 0x1.c53b6cp-47f, 0x1.723913fa5p-2},
    {0x1.63b0cep-1f, 0x1.90fd68p-48f, 0x1.75016d002bap-2},
    {0x1.62ba5ep-1f, -0x1.bbd23ap-47f, 0x1.77c7dba7bbap-2},
    {0x1.61c544p-1f, -0x1.64e30ap-47f, 0x1.7a8c5a98df6p-2},
    {0x1.60d17cp-1f, 0x1.c1cc04p-48f, 0x1.7d4ef011eecp-2},
    {0x1.5fdf04p-1f, 0x1.b1cc34p-47f, 0x1.800f9c99c94p-2},
    {0x1.5eedd6p-1f, -0x1.8a2226p-48f, 0x1.82ce6c6de4ep-2},
    {0x1.5dfdf4p-1f, 0x1.4d8ed6p-48f, 0x1.858b548e5ccp-2},
    {0x1.5d0f56p-1f, 0x1.9569fep-49f, 0x1.8846673c006p-2},
    {0x1.5c22p-1f, -0x1.e05c58p-48f, 0x1.8aff93a6618p-2},
    {0x1.5b35eap-1f, -0x1.a1b2e6p-47f, 0x1.8db6ec3be28p-2},
    {0x1.5a4b14p-1f, -0x1.466ef8p-47f, 0x1.906c6bfdc48p-2},
    {0x1.59617ap-1f, -0x1.90b70cp-47f, 0x1.932019c4354p-2},
    {0x1.58791ap-1f, 0x1.ff49fp-51f, 0x1.95d1f6905cap-2},
    {0x1.5791f4p-1f, 0x1.f4119cp-47f, 0x1.9881fd786a6p-2},
    {0x1.56ac02p-1f, 0x1.37682ap-49f, 0x1.9b303b7ba36p-2},
    {0x1.55c742p-1f, -0x1.76740ap-47f, 0x1.9ddcb1c86e8p-2},
    {0x1.54e3b4p+0f, -0x1.8e632p-47f, -0x1.25410448e56p-2},
    {0x1.540154p+0f, 0x1.0a10fp-47f, -0x1.22981fbaf7ap-2},
    {0x1.53202p+0f, 0x1.65c4aep-48f, -0x1.1ff0ff1cf48p-2},
    {0x1.524016p+0f, -0x1.be1c3cp-49f, -0x1.1d4ba1136c2p-2},
    {0x1.516132p+0f, 0x1.84c96ap-47f, -0x1.1aa7fe258d4p-2},
    {0x1.508374p+0f, -0x1.aebfdcp-47f, -0x1.18061aeb18ap-2},
    {0x1.4fa6d8p+0f, 0x1.f65eep-49f, -0x1.1565efcc56p-2},
    {0x1.4ecb5cp+0f, 0x1.9409aep-47f, -0x1.12c77b34072p-2},
    {0x1.4df1p+0f, -0x1.a0844p-50f, -0x1.102ac1a35ccp-2},
    {0x1.4d17bep+0f, 0x1.1205fcp-49f, -0x1.0d8fb52deb2p-2},
    {0x1.4c3f98p+0f, -0x1.e19ffap-48f, -0x1.0af660639e2p-2},
    {0x1.4b688ap+0f, 0x1.d0b3ep-48f, -0x1.085ebb5eae8p-2},
    {0x1.4a929p+0f, 0x1.4bc78ep-47f, -0x1.05c8be1d964p-2},
    {0x1.49bdaap+0f, -0x1.80d56ap-48f, -0x1.03346cef06p-2},
    {0x1.48e9d6p+0f, -0x1.c8f548p-48f, -0x1.00a1c5ebda4p-2},
    {0x1.481712p+0f, 0x1.a7bed8p-47f, -0x1.fc218e4220cp-3},
    {0x1.47455ap+0f, -0x1.e7facep-47f, -0x1.f702d09b77cp-3},
    {0x1.4674aep+0f, 0x1.a8c2ccp-50f, -0x1.f1e75b41f9cp-3},
    {0x1.45a50cp+0f, 0x1.fc9a12p-47f, -0x1.eccf2a07e94p-3},
    {0x1.44d672p+0f, 0x1.dd68f2p-47f, -0x1.e7ba38a778p-3},
    {0x1.4408dcp+0f, -0x1.ed0f78p-52f, -0x1.e2a8761eb2cp-3},
    {0x1.433c4ap+0f, 0x1.0a0228p-50f, -0x1.dd99ea8b6d8p-3},
    {0x1.4270bap+0f, -0x1.2673bcp-49f, -0x1.d88e915f2f4p-3},
    {0x1.41a62ap+0f, -0x1.920858p-49f, -0x1.d38665f31f4p-3},
    {0x1.40dc98p+0f, -0x1.830c18p-47f, -0x1.ce816387f18p-3},
    {0x1.401402p+0f, -0x1.aaabb4p-48f, -0x1.c97f8545d44p-3},
    {0x1.3f4c66p+0f, -0x1.54d8b6p-48f, -0x1.c480c63c5ccp-3},
    {0x1.3e85c2p+0f, -0x1.423fcap-47f, -0x1.bf852162754p-3},
    {0x1.3dc014p+0f, -0x1.18a1bap-47f, -0x1.ba8c91964acp-3},
    {0x1.3cfb5cp+0f, -0x1.8e3a04p-48f, -0x1.b5971e893acp-3},
    {0x1.3c3796p+0f, 0x1.77fecep-48f, -0x1.b0a4b60bc1cp-3},
    {0x1.3b74c2p+0f, 0x1.7d45d6p-49f, -0x1.abb55fad694p-3},
    {0x1.3ab2dcp+0f, -0x1.de7e3ep-50f, -0x1.a6c908fcb7p-3},
    {0x1.39f1e6p+0f, 0x1.4be902p-51f, -0x1.a1dfc6731b8p-3},
    {0x1.3931dap+0f, 0x1.510488p-47f, -0x1.9cf97860e1p-3},
    {0x1.3872bap+0f, 0x1.8b40cp-47f, -0x1.9816332d1acp-3},
    {0x1.37b482p+0f, -0x1.85390ep-47f, -0x1.9335e3f9948p-3},
    {0x1.36f732p+0f, -0x1.b3cfc6p-47f, -0x1.8e589206c2cp-3},
    {0x1.363ac6p+0f, -0x1.a46722p-47f, -0x1.897e2a33b18p-3},
    {0x1.357f3ep+0f, -0x1.20cddap-47f, -0x1.84a6b39df5p-3},
    {0x1.34c49ap+0f, -0x1.30c5f2p-47f, -0x1.7fd2356999cp-3},
    {0x1.340ad4p+0f, 0x1.7a1826p-47f, -0x1.7b008edd154p-3},
    {0x1.3351eep+0f, 0x1.898002p-47f, -0x1.7631d43535cp-3},
    {0x1.3299e6p+0f, -0x1.468318p-49f, -0x1.7165ff1d14p-3},
    {0x1.31e2bap+0f, 0x1.d55c3p-50f, -0x1.6c9d092604p-3},
    {0x1.312c68p+0f, 0x1.260a3p-48f, -0x1.67d6ebc7858p-3},
    {0x1.3076eep+0f, -0x1.6cc7c6p-47f, -0x1.6313a05f35cp-3},
    {0x1.2fc24cp+0f, 0x1.e7e074p-48f, -0x1.5e532dacc18p-3},
    {0x1.2f0e8p+0f, 0x1.1782ccp-47f, -0x1.59958cf1d54p-3},
    {0x1.2e5b88p+0f, -0x1.ba96bap-47f, -0x1.54dab756104p-3},
    {0x1.2da964p+0f, 0x1.bbcf4p-47f, -0x1.5022b37af6cp-3},
    {0x1.2cf81p+0f, 0x1.656662p-47f, -0x1.4b6d6ccfe24p-3},
    {0x1.2c478ep+0f, -0x1.8cba5p-47f, -0x1.46baf775f5cp-3},
    {0x1.2b97d8p+0f, -0x1.d19ea6p-47f, -0x1.420b31040fcp-3},
    {0x1.2ae8fp+0f, 0x1.8dbe1p-47f, -0x1.3d5e2d86bc4p-3},
    {0x1.2a3ad4p+0f, -0x1.9d0658p-49f, -0x1.38b3e5b8274p-3},
    {0x1.298d84p+0f, -0x1.b4a216p-54f, -0x1.340c5ffc114p-3},
    {0x1.28e0fap+0f, 0x1.75e7p-47f, -0x1.2f677957c0cp-3},
    {0x1.28353ap+0f, -0x1.416c58p-49f, -0x1.2ac55399f5cp-3},
    {0x1.278a3ep+0f, 0x1.a3785p-48f, -0x1.2625cb8adep-3},
    {0x1.26e00ap+0f, 0x1.bacbdp-47f, -0x1.2189030c074p-3},
    {0x1.263698p+0f, 0x1.a59e38p-48f, -0x1.1ceed6a8538p-3},
    {0x1.258de8p+0f, 0x1.c25dbap-48f, -0x1.18574c6bedp-3},
    {0x1.24e5f8p+0f, -0x1.65ff14p-48f, -0x1.13c25c6c398p-3},
    {0x1.243ecap+0f, -0x1.dcb09ep-48f, -0x1.0f301aabcfp-3},
    {0x1.239858p+0f, -0x1.b23214p-47f, -0x1.0aa06322674p-3},
    {0x1.22f2a6p+0f, 0x1.f7f1f8p-48f, -0x1.061357d0d4cp-3},
    {0x1.224daep+0f, -0x1.3d4a42p-47f, -0x1.0188d470f6p-3},
    {0x1.21a97p+0f, 0x1.b4b92p-47f, -0x1.fa01bd9b58p-4},
    {0x1.2105eep+0f, -0x1.5dbb26p-47f, -0x1.f0f715c599p-4},
    {0x1.206322p+0f, 0x1.612f5ep-47f, -0x1.e7f1680233p-4},
    {0x1.1fc10ep+0f, 0x1.26593p-47f, -0x1.def0dc1c67p-4},
    {0x1.1f1fbp+0f, -0x1.50e398p-49f, -0x1.d5f5611921p-4},
    {0x1.1e7f06p+0f, -0x1.bc2688p-47f, -0x1.ccfee5c6e1p-4},
    {0x1.1ddf0ep+0f, 0x1.c7fd82p-47f, -0x1.c40d58bda6p-4},
    {0x1.1d3fcap+0f, -0x1.58eaaap-48f, -0x1.bb20e1ced68p-4},
    {0x1.1ca138p+0f, 0x1.307478p-48f, -0x1.b2396f853p-4},
    {0x1.1c0354p+0f, 0x1.9caf34p-48f, -0x1.a956d35caep-4},
    {0x1.1b662p+0f, 0x1.b45e6cp-47f, -0x1.a079351278p-4},
    {0x1.1ac998p+0f, 0x1.c19e18p-48f, -0x1.97a065c4ccp-4},
    {0x1.1a2dbep+0f, 0x1.29cdp-48f, -0x1.8ecc8d32eb8p-4},
    {0x1.19929p+0f, -0x1.188ff4p-47f, -0x1.85fd9935068p-4},
    {0x1.18f80ap+0f, -0x1.b1bb1p-47f, -0x1.7d335a4429p-4},
    {0x1.185e3p+0f, 0x1.34996ep-48f, -0x1.746e154227p-4},
    {0x1.17c4fcp+0f, -0x1.d02f8cp-47f, -0x1.6bad7d3188p-4},
    {0x1.172c7p+0f, 0x1.90257ep-49f, -0x1.62f1b9bd778p-4},
    {0x1.16948ap+0f, 0x1.def382p-48f, -0x1.5a3ab809aep-4},
    {0x1.15fd4ap+0f, -0x1.519f3cp-47f, -0x1.5188827a61p-4},
    {0x1.1566acp+0f, -0x1.18ea08p-52f, -0x1.48dae86c31p-4},
    {0x1.14d0b2p+0f, -0x1.a7279ap-47f, -0x1.4032118c148p-4},
    {0x1.143b58p+0f, 0x1.29d0d8p-48f, -0x1.378dccd7498p-4},
    {0x1.13a6ap+0f, -0x1.4bf1eep-47f, -0x1.2eee41fb4p-4},
    {0x1.131288p+0f, -0x1.7d69cp-47f, -0x1.26535d5d8cp-4},
    {0x1.127f1p+0f, -0x1.075cdap-48f, -0x1.1dbd2903d18p-4},
    {0x1.11ec34p+0f, 0x1.a60edp-47f, -0x1.152b732bb4p-4},
    {0x1.1159f6p+0f, 0x1.eb7f1cp-48f, -0x1.0c9e6382c5p-4},
    {0x1.10c854p+0f, -0x1.f5e9ccp-47f, -0x1.0415e5ee74p-4},
    {0x1.10374cp+0f, -0x1.273b52p-47f, -0x1.f723cc37fcp-5},
    {0x1.0fa6dep+0f, 0x1.32b394p-48f, -0x1.e624db50b6p-5},
    {0x1.0f1708p+0f, 0x1.e69f96p-47f, -0x1.d52ed0005ep-5},
    {0x1.0e87ccp+0f, 0x1.80ae9cp-47f, -0x1.c441f9cf73p-5},
    {0x1.0df926p+0f, 0x1.7c07a4p-47f, -0x1.b35df2c58cp-5},
    {0x1.0d6b16p+0f, -0x1.030e4p-49f, -0x1.a282cd9936p-5},
    {0x1.0cdd9ap+0f, -0x1.58fd9p-48f, -0x1.91b0601fd7p-5},
    {0x1.0c50b4p+0f, 0x1.a685fp-48f, -0x1.80e6f9dd8dp-5},
    {0x1.0bc462p+0f, -0x1.bf03acp-47f, -0x1.702670850ep-5},
    {0x1.0b38ap+0f, 0x1.9935p-50f, -0x1.5f6e5c078fp-5},
    {0x1.0aad72p+0f, -0x1.32ef64p-48f, -0x1.4ebf49249ep-5},
    {0x1.0a22d4p+0f, 0x1.9c8e82p-49f, -0x1.3e18cf6a0bp-5},
    {0x1.0998c6p+0f, 0x1.4262b2p-47f, -0x1.2d7b00d3c6p-5},
    {0x1.090f46p+0f, -0x1.4636b6p-47f, -0x1.1ce5b19bc3p-5},
    {0x1.088654p+0f, 0x1.585b56p-47f, -0x1.0c58f379ep-5},
    {0x1.07fdfp+0f, -0x1.0ab24ap-47f, -0x1.f7a9b06782p-6},
    {0x1.077618p+0f, 0x1.01cea8p-47f, -0x1.d6b266d97ap-6},
    {0x1.06eeccp+0f, 0x1.c85c12p-48f, -0x1.b5cc2d4b72p-6},
    {0x1.06680ap+0f, -0x1.15bddap-48f, -0x1.94f6a9fa24p-6},
    {0x1.05e1d2p+0f, -0x1.98c27p-48f, -0x1.7431ff5dp-6},
    {0x1.055c24p+0f, 0x1.57cbccp-47f, -0x1.537e5005f4p-6},
    {0x1.04d6fep+0f, -0x1.9c8c34p-47f, -0x1.32db410132p-6},
    {0x1.04525ep+0f, 0x1.24910ap-51f, -0x1.1248767508p-6},
    {0x1.03ce46p+0f, 0x1.fb5dc4p-48f, -0x1.e38d1fc334p-7},
    {0x1.034ab2p+0f, -0x1.09824ap-50f, -0x1.a2a965817p-7},
    {0x1.02c7a6p+0f, 0x1.fb8c2ap-50f, -0x1.61e7fa4b54p-7},
    {0x1.02451cp+0f, 0x1.e36e48p-48f, -0x1.214629b9fp-7},
    {0x1.01c316p+0f, -0x1.28d2e6p-47f, -0x1.c18a6530ep-8},
    {0x1.014192p+0f, 0x1.c842ap-50f, -0x1.40c8b0c788p-8},
    {0x1.00c09p+0f, 0x1.f4625ap-47f, -0x1.808f7028ap-9},
    {0x1p+0f, 0x0p+0f, 0x0p+0},
};

__device__ __forceinline__ void stage_ln(LnEntry* dst, int tid, int threads) {
  for (int i = tid; i < LN_ENTRIES; i += threads) dst[i] = LN_TABLE[i];
}

// ln u for an f32 u in (0, 1]: u = 2^e y, y in [0.75, 1.5); the entry of y's
// interval gives t = y R - 1 (exact: y and R have 24 bits; |t| <= 2^-8) and
// ln y = -ln R + ln(1 + t), ln(1 + t) to t^7.  e ln2_hi + hi is exact; hi + t
// by Fast2Sum (|hi| >= |t| or hi = 0); the small terms are added last.
__device__ __forceinline__ double ln_uniform(float u, const LnEntry* tab) {
  const uint32_t bits = __float_as_uint(u);
  const uint32_t m = bits & 0x7FFFFFu;
  const uint32_t up = m >= 0x400000u;  // mantissa 1.5 or more: y is half of it
  const double y = __longlong_as_double(static_cast<long long>(0x3FFu - up) << 52 |
                                        static_cast<long long>(m) << 29);
  const double e = static_cast<double>(static_cast<int>(bits >> 23) - 127 + static_cast<int>(up));
  const LnEntry ent = tab[m >> 15];
  const double t = fma(y, static_cast<double>(ent.r), -1.0);
  double p = 1.0 / 7;
  p = fma(p, t, -1.0 / 6);
  p = fma(p, t, 1.0 / 5);
  p = fma(p, t, -1.0 / 4);
  p = fma(p, t, 1.0 / 3);
  p = fma(p, t, -1.0 / 2);
  const double hi = fma(e, LN2_HI, ent.hi);
  const double tail = fma(__dmul_rn(t, t), p, fma(e, LN2_LO, static_cast<double>(ent.lo)));
  const double s = __dadd_rn(hi, t);
  const double err = __dsub_rn(t, __dsub_rn(s, hi));
  return __dadd_rn(s, __dadd_rn(err, tail));
}

// pi/2 in three parts: n PIO2_1 and n PIO2_2 are exact for n <= 4
constexpr double PIO2_1 = 0x1.921fb54442dp+0;
constexpr double PIO2_2 = 0x1.8469898cc51p-48;
constexpr double PIO2_3 = 0x1.c06e0e6894812p-94;

// cos and sin of theta = fl(2 pi u2), u2 = uniform(w) = m 2^-24: theta =
// n pi/2 + d with n = round(4 u2) from m's top bits (0..4), d by Cody-Waite
// (exact but for the last part), |d| <= pi/4; sin d and cos d by their
// Taylor series to d^17 and d^16 (the next terms are below 2^-58 of them).
__device__ __forceinline__ void sincos_turn(uint32_t w, double* sn, double* cs) {
  const uint32_t n = ((w >> 8) + (1u << 21)) >> 22;
  const double dn = static_cast<double>(n);
  const double th = __dmul_rn(TWO_PI, static_cast<double>(uniform(w)));
  double d = fma(-dn, PIO2_1, th);
  d = fma(-dn, PIO2_2, d);
  d = fma(-dn, PIO2_3, d);
  const double d2 = __dmul_rn(d, d);
  double ps = 1.0 / 355687428096000;
  ps = fma(ps, d2, -1.0 / 1307674368000);
  ps = fma(ps, d2, 1.0 / 6227020800);
  ps = fma(ps, d2, -1.0 / 39916800);
  ps = fma(ps, d2, 1.0 / 362880);
  ps = fma(ps, d2, -1.0 / 5040);
  ps = fma(ps, d2, 1.0 / 120);
  ps = fma(ps, d2, -1.0 / 6);
  const double s = fma(__dmul_rn(d2, d), ps, d);
  double pc = 1.0 / 20922789888000;
  pc = fma(pc, d2, -1.0 / 87178291200);
  pc = fma(pc, d2, 1.0 / 479001600);
  pc = fma(pc, d2, -1.0 / 3628800);
  pc = fma(pc, d2, 1.0 / 40320);
  pc = fma(pc, d2, -1.0 / 720);
  pc = fma(pc, d2, 1.0 / 24);
  pc = fma(pc, d2, -1.0 / 2);
  const double c = fma(d2, pc, 1.0);
  switch (n & 3) {
    case 0: *sn = s; *cs = c; break;
    case 1: *sn = c; *cs = -s; break;
    case 2: *sn = -s; *cs = -c; break;
    default: *sn = -c; *cs = s;
  }
}

// Two standard normals from two words (Box-Muller); ln: the table, in shared
// or device memory.
__device__ __forceinline__ float2 normal_pair(uint32_t a, uint32_t b, const LnEntry* ln) {
  const double r = sqrt(-2.0 * ln_uniform(uniform_open(a), ln));
  double sn, cs;
  sincos_turn(b, &sn, &cs);
  return make_float2(static_cast<float>(r * cs), static_cast<float>(r * sn));
}

__device__ __forceinline__ float2 cmul_rn(float2 a, float2 b) {
  return make_float2(__fsub_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                     __fadd_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x)));
}

// The frame's taps, each drawn once: warp g draws taps l = g, g + GROUPS, ...
// of its lane's frame, t_l = z_l * tscale[l] in f32, into taps[l][lane].
// The block reads them after a barrier (channel_bins).  A kernel draws them
// before its first barrier, so they read LN_TABLE in device memory.
template <int GROUPS, int FRAMES>
__device__ __forceinline__ void draw_taps(uint2 key, long long f, int n_taps, const float* tscale,
                                          int g, int lane, float2 (*taps)[FRAMES]) {
  for (int l = g; l < n_taps; l += GROUPS) {
    const uint4 w = draw(key, f, l, TAPS);
    const float2 z = normal_pair(w.x, w.y, LN_TABLE);
    const float sc = tscale[l];
    taps[l][lane] = make_float2(__fmul_rn(z.x, sc), __fmul_rn(z.y, sc));
  }
}

// One tap's term of a bin's channel sum in f64: channel_bins and channel_bin
// add it in the same order, so a bin comes out with the same bits from both.
__device__ __forceinline__ void cfr_term(double& hr, double& hi, float2 c, float2 t) {
  const double tr = t.x, ti = t.y;
  hr += static_cast<double>(c.x) * tr - static_cast<double>(c.y) * ti;
  hi += static_cast<double>(c.x) * ti + static_cast<double>(c.y) * tr;
}

// The frame's channel at this thread's bins k = g + GROUPS*j from the taps
// of draw_taps: H[k] = sum_l W[k][l] t_l in f64, l = 0..n_taps-1 in order,
// rounded to f32 once.  wc: (N_SC, MAX_TAPS), taps: (MAX_TAPS, FRAMES), both
// in shared memory.
template <int BINS, int GROUPS, int N_SC, int FRAMES>
__device__ __forceinline__ void channel_bins(int n_taps, const float2 (*taps)[FRAMES],
                                             const float2 (*wc)[MAX_TAPS], int g, int lane,
                                             float2 (&h)[BINS]) {
  double hr[BINS], hi[BINS];
#pragma unroll
  for (int j = 0; j < BINS; ++j) hr[j] = hi[j] = 0.0;
  for (int l = 0; l < n_taps; ++l) {
    const float2 t = taps[l][lane];
#pragma unroll
    for (int j = 0; j < BINS; ++j) {
      const int k = g + GROUPS * j;
      if (k < N_SC) cfr_term(hr[j], hi[j], wc[k][l], t);
    }
  }
#pragma unroll
  for (int j = 0; j < BINS; ++j) h[j] = make_float2(static_cast<float>(hr[j]), static_cast<float>(hi[j]));
}

// The channel at one bin k, as channel_bins gives it.
template <int FRAMES>
__device__ __forceinline__ float2 channel_bin(int n_taps, const float2 (*taps)[FRAMES],
                                              const float2 (*wc)[MAX_TAPS], int k, int lane) {
  double hr = 0.0, hi = 0.0;
  for (int l = 0; l < n_taps; ++l) cfr_term(hr, hi, wc[k][l], taps[l][lane]);
  return make_float2(static_cast<float>(hr), static_cast<float>(hi));
}

}  // namespace gen
