// Generative fused chain for Hopper (sm_90a): a seed in; per frame a fresh
// channel and noise drawn in the kernel, the seven channel estimates, the
// equalized blocks, sigma^2, the true channel and a checksum out (or, in
// stream mode, per-frame error sums and only the last 128 frames' planes).
//
// Replaces tpu80211/kernels/gen_chain.py::_gen_kernel (pallas_call site
// _gen_call).  Semantics follow that kernel: per frame
//   * channel: n_taps exponential-PDP taps, CFR = W @ taps (gen.cuh);
//   * rx block spectra tx_b H + nsc N_b, nsc = sqrt(64 sigma_t^2 / 2) per
//     plane (the DFT of white time noise of variance sigma_t^2);
//   * two preamble repeats tpre H + nsc N_1,2, averaged; sigma^2 from their
//     difference with the 64/53 factor of noise on 53 bins only;
//   * the chain's math in frequency (LT-LS, pilot ratios of blocks 0..3,
//     five interpolators, rank-1 MMSE, the PS-Linear blend), as
//     chain.cuh computes it after its DFTs;
//   * checksum: sigma^2 and every element of every h plane and of eq, eq
//     added in f32 before its cast to the eq type (the TPU kernel's order).
// The draws are the Philox counters of gen.cuh: a frame's numbers depend on
// (seed, frame) only.  The seed is read from device memory, so a stream step
// can derive it on the card from the previous batch.
//
// Stream mode (the TPU kernel's stream_sums): every plane but the checksum
// holds frames [B - 128, B) only, written by the blocks that own them; the
// TPU's in-kernel accumulation over sequential grid steps becomes a per-frame
// (8, B) row of sums (7 x sum_k |h_est - h|^2, then sum_k |h|^2) that the
// wrapper folds to (8, 128) lanes.
//
// Layout: chain.cuh's, 256 threads = 32 frames (lane) x 8 bin groups; group
// g owns bins k = g, g+8, ...  Each Philox word and each Box-Muller pair of a
// frame is drawn once: 894 pairs and 841 Philox calls a frame at 8 taps (the
// 909 pairs of its spectra but DC's 15 block pairs, which nothing uses: the
// equalizer zeroes DC and LT-LS's zero there makes its MMSE terms 0), where
// the design before drew 1,162 pairs and 1,109 calls.
//   * taps: warp g draws taps l = g, g+8 into shared memory; after one
//     barrier every thread sums its bins' CFR from them in f64, in the order
//     l = 0..n_taps-1 as before, so h keeps its bits (gen.cuh);
//   * the 16 pilot pairs of blocks 0..3, two per warp, before the rest: the
//     pilot ratios feed the interpolators, and the rx spectra stay in shared
//     memory for the equalizer;
//   * then one pass over the 15 blocks draws every other bin once, adds
//     blocks 0..3's MMSE dots on the way and equalizes every block by the
//     PS-Linear blend (which needs LT-LS and the linear interpolator only);
//     h_mmse follows that pass.
// The per-frame sums cross threads through shared memory.
//
// What bounds it on this card.  The f64 work of Box-Muller: the FP64 pipe
// runs at half the f32 rate, and the library's log and sincos cost 0.16 and
// 0.12 ms of the 0.60 the design before took (H100 80GB HBM3 at 700 W;
// PERF.md, section 6).  So gen.cuh takes ln from a 256-entry table and a
// degree-7 series (half the library log's time or less) and sin and cos
// from its own reduction and series (as dear as the library's, but with no
// local array); the normals stay the plain version's.  Box-Muller still
// takes ~0.24 ms of ~0.49.  Then Philox's integer rounds (~0.1 ms), the
// chain's f32 math and divisions, and the stores in full-output mode (~6.6
// KB a frame, 0.22 GB at B = 32,768).  Two blocks of 8 warps an SM: 3 would
// need <= 85 registers and spill (probe blocks3).  The log table (4 KB)
// takes the shared memory above 48 KB, so it is dynamic.

#include "chain.cuh"
#include "ffi.cuh"
#include "gen.cuh"

namespace {

using chain::BINS;
using chain::DC;
using chain::FRAMES;
using chain::GROUPS;
using chain::N_AVG;
using chain::N_BLOCKS;
using chain::N_H;
using chain::N_KINDS;
using chain::N_PILOTS;
using chain::N_SC;
using chain::NB_PAD;
using chain::THREADS;

constexpr int N_SUMS = N_H + 1;  // 7 estimator error sums, then sum |h|^2
constexpr int LANES = 128;       // the stream record's frames

struct GenParams {
  const float* txs_re;  // (53, 16) tx block spectra
  const float* txs_im;
  const float* tpre_re;  // (53, 1) preamble spectrum
  const float* tpre_im;
  const float* wc_re;  // (53, n_taps) taps -> CFR
  const float* wc_im;
  const float* tscale;  // (n_taps,) per-tap normal scale
  const float* wi_re;   // (5, 53, 4) interpolators
  const float* wi_im;
  const int* seed;      // device scalar
  float* h[2 * N_H];    // (53, cols) each
  void* eq_re;          // (15, 53, cols), f32 or bf16
  void* eq_im;
  float* ow2;    // (cols,)
  float* ht_re;  // (53, cols) the true channel
  float* ht_im;
  float* chk;   // (B,)
  float* sums;  // (8, B) per-frame sums; null unless stream mode
  long long batch;
  int n_taps;
  float nsc;  // per-plane noise scale of a bin
};

constexpr int N_RED = 3 * N_AVG + 1;  // per-frame partial sums: MMSE dots of blocks 0..3, then
constexpr int OW2 = 3 * N_AVG;        // the repeat difference's power

struct GenSmem {
  gen::LnEntry ln[gen::LN_ENTRIES];     // Box-Muller's log table
  float2 wi[N_KINDS][N_SC][N_PILOTS];
  float2 txs[N_BLOCKS][N_SC];
  float2 tpre[N_SC];
  float2 wc[N_SC][gen::MAX_TAPS];
  float2 taps[gen::MAX_TAPS][FRAMES];   // each frame's taps, drawn once (gen::draw_taps)
  float2 hp[N_AVG][N_PILOTS][FRAMES];   // pilot ratios of blocks 0..3
  float2 prx[N_AVG][N_PILOTS][FRAMES];  // their rx spectra, kept for the equalizer
  float red[GROUPS][N_RED][FRAMES];
};

template <typename EqT>
__global__ void __launch_bounds__(THREADS, 2) gen_chain_kernel(GenParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  GenSmem& s = *reinterpret_cast<GenSmem*>(smem_raw);
  const int lane = threadIdx.x % FRAMES;
  const int g = threadIdx.x / FRAMES;
  const long long f = static_cast<long long>(blockIdx.x) * FRAMES + lane;
  const long long batch = p.batch;
  const bool live = f < batch;
  // stream mode keeps frames [B - 128, B); full mode all of them
  const bool stream = p.sums != nullptr;
  const long long col = stream ? f - (batch - LANES) : f;
  const long long cols = stream ? LANES : batch;
  const bool keep = live && col >= 0;

  gen::stage_ln(s.ln, threadIdx.x, THREADS);
  for (int i = threadIdx.x; i < N_KINDS * N_SC * N_PILOTS; i += THREADS)
    (&s.wi[0][0][0])[i] = make_float2(p.wi_re[i], p.wi_im[i]);
  for (int i = threadIdx.x; i < N_BLOCKS * N_SC; i += THREADS) {
    const int b = i / N_SC, k = i % N_SC;
    s.txs[b][k] = make_float2(p.txs_re[k * NB_PAD + b], p.txs_im[k * NB_PAD + b]);
  }
  for (int k = threadIdx.x; k < N_SC; k += THREADS) s.tpre[k] = make_float2(p.tpre_re[k], p.tpre_im[k]);
  for (int i = threadIdx.x; i < N_SC * p.n_taps; i += THREADS) {
    const int k = i / p.n_taps, l = i % p.n_taps;
    s.wc[k][l] = make_float2(p.wc_re[i], p.wc_im[i]);
  }
  const uint2 key = gen::key_of(*p.seed);
  gen::draw_taps<GROUPS, FRAMES>(key, f, p.n_taps, p.tscale, g, lane, s.taps);
  __syncthreads();

  const float nsc = p.nsc;
  const float half = nsc * 0.5f;
  auto store_plane = [&](float* re, float* im, int k, float2 v) {
    if (keep && re != nullptr) {
      re[k * cols + col] = v.x;
      im[k * cols + col] = v.y;
    }
  };

  // -- channel -----------------------------------------------------------------
  float2 h[BINS];
  gen::channel_bins<BINS, GROUPS, N_SC, FRAMES>(p.n_taps, s.taps, s.wc, g, lane, h);
  float hsq = 0.f;
#pragma unroll
  for (int j = 0; j < BINS; ++j) {
    const int k = g + GROUPS * j;
    if (k < N_SC) {
      store_plane(p.ht_re, p.ht_im, k, h[j]);
      hsq += h[j].x * h[j].x + h[j].y * h[j].y;
    }
  }

  // the rx spectrum of block b at bin k, channel hk: tx_b H + nsc N
  auto rx_bin = [&](int b, int k, float2 hk) {
    const uint4 w = gen::draw(key, f, k, gen::BLOCK, b);
    const float2 n = gen::normal_pair(w.x, w.y, s.ln);
    const float2 c = gen::cmul_rn(s.txs[b][k], hk);
    return make_float2(__fadd_rn(c.x, __fmul_rn(nsc, n.x)), __fadd_rn(c.y, __fmul_rn(nsc, n.y)));
  };

  // -- preamble: two noisy repeats, averaged; sigma^2; LT-LS --------------------
  float2 hlt[BINS];
  float chk = 0.f;  // this thread's share (ow2 is added once, at the end)
  float err[N_H];   // this thread's share of sum |h_est - h|^2, per estimator
#pragma unroll
  for (int e = 0; e < N_H; ++e) err[e] = 0.f;
  {
    float ow2_part = 0.f;
#pragma unroll
    for (int j = 0; j < BINS; ++j) {
      const int k = g + GROUPS * j;
      hlt[j] = make_float2(0.f, 0.f);
      if (k >= N_SC) continue;
      const uint4 w = gen::draw(key, f, k, gen::PREAMBLE);
      const float2 n1 = gen::normal_pair(w.x, w.y, s.ln), n2 = gen::normal_pair(w.z, w.w, s.ln);
      const float2 tp = s.tpre[k];
      const float2 cl = gen::cmul_rn(tp, h[j]);
      const float2 r = make_float2(__fadd_rn(cl.x, __fmul_rn(half, __fadd_rn(n1.x, n2.x))),
                                   __fadd_rn(cl.y, __fmul_rn(half, __fadd_rn(n1.y, n2.y))));
      const float dr = __fmul_rn(nsc, __fsub_rn(n2.x, n1.x));
      const float di = __fmul_rn(nsc, __fsub_rn(n2.y, n1.y));
      ow2_part += dr * dr + di * di;
      if (k != DC) {
        const float d = tp.x * tp.x + tp.y * tp.y;
        hlt[j] = make_float2((tp.x * r.x + tp.y * r.y) / d, (tp.x * r.y - tp.y * r.x) / d);
      }
      chk += hlt[j].x + hlt[j].y;
      store_plane(p.h[0], p.h[1], k, hlt[j]);
      const float ex = hlt[j].x - h[j].x, ey = hlt[j].y - h[j].y;
      err[chain::H_LT] += ex * ex + ey * ey;
    }
    s.red[g][OW2][lane] = ow2_part;
  }

  // -- the pilots of blocks 0..3, drawn once and spread over the warps: warp g
  // draws (block, pilot) pairs g and g + 8 of the 16, with the channel at the
  // pilot's bin summed as channel_bins sums it; the ratios are for the
  // interpolators, the rx spectra are kept for the equalizer
  for (int i = g; i < N_AVG * N_PILOTS; i += GROUPS) {
    const int b = i / N_PILOTS, q = i % N_PILOTS;
    const int k = chain::PILOT0 + chain::PILOT_DELTA * q;
    const float2 rb = rx_bin(b, k, gen::channel_bin<FRAMES>(p.n_taps, s.taps, s.wc, k, lane));
    s.prx[b][q][lane] = rb;
    s.hp[b][q][lane] = chain::cdiv(rb, s.txs[b][k]);
  }
  __syncthreads();
  float ow2 = 0.f;
#pragma unroll
  for (int gg = 0; gg < GROUPS; ++gg) ow2 += s.red[gg][OW2][lane];
  ow2 = ow2 / (2.f * chain::N_FFT * N_SC);

  // -- interpolators ---------------------------------------------------------------
  float2 hlin[BINS];
  {
    float2 hsum[N_PILOTS];
#pragma unroll
    for (int q = 0; q < N_PILOTS; ++q) {
      hsum[q] = make_float2(0.f, 0.f);
#pragma unroll
      for (int b = 0; b < N_AVG; ++b) {
        hsum[q].x += s.hp[b][q][lane].x;
        hsum[q].y += s.hp[b][q][lane].y;
      }
    }
#pragma unroll
    for (int j = 0; j < BINS; ++j) {
      const int k = g + GROUPS * j;
      hlin[j] = make_float2(0.f, 0.f);
      if (k >= N_SC) continue;
#pragma unroll
      for (int kind = 0; kind < N_KINDS; ++kind) {
        float hr = 0.f, hi = 0.f;
#pragma unroll
        for (int q = 0; q < N_PILOTS; ++q) {
          const float2 w = s.wi[kind][k][q];
          hr += w.x * hsum[q].x;
          hi += w.x * hsum[q].y;
          if (kind == N_KINDS - 1) {  // complex Wiener weights
            hr -= w.y * hsum[q].y;
            hi += w.y * hsum[q].x;
          }
        }
        const float2 e = make_float2(hr / N_AVG, hi / N_AVG);
        chk += e.x + e.y;
        store_plane(p.h[2 * (chain::H_LINEAR + kind)], p.h[2 * (chain::H_LINEAR + kind) + 1], k, e);
        const float ex = e.x - h[j].x, ey = e.y - h[j].y;
        err[chain::H_LINEAR + kind] += ex * ex + ey * ey;
        if (kind == 0) hlin[j] = e;
      }
    }
  }

  // -- one pass over the 15 blocks: each bin drawn once (blocks 0..3's pilots
  // from prx), blocks 0..3's MMSE dots on the way, every block equalized by
  // the PS-Linear blend, DC to zero (its draw is never used: LT-LS is 0 there)
  EqT* eq_re = static_cast<EqT*>(p.eq_re);
  EqT* eq_im = static_cast<EqT*>(p.eq_im);
#pragma unroll 1
  for (int b = 0; b < N_BLOCKS; ++b) {
    const bool est = b < N_AVG;
    const float w_ps = static_cast<float>(b + 1) / N_BLOCKS;
    const float w_lt = static_cast<float>(N_BLOCKS - 1 - b) / N_BLOCKS;
    float su2 = 0.f, sr = 0.f, si = 0.f;
#pragma unroll
    for (int j = 0; j < BINS; ++j) {
      const int k = g + GROUPS * j;
      if (k >= N_SC) continue;
      float2 e = make_float2(0.f, 0.f);
      if (k != DC) {
        const int q = chain::pilot_of(k);
        const float2 rb = est && q >= 0 ? s.prx[b][q][lane] : rx_bin(b, k, h[j]);
        if (est) {
          const float2 u = chain::cmul(s.txs[b][k], hlt[j]);
          su2 += u.x * u.x + u.y * u.y;
          sr += u.x * rb.x + u.y * rb.y;
          si += u.x * rb.y - u.y * rb.x;
        }
        const float2 hu = make_float2(w_lt * hlt[j].x + w_ps * hlin[j].x,
                                      w_lt * hlt[j].y + w_ps * hlin[j].y);
        e = chain::cdiv(rb, hu);
      }
      chk += e.x + e.y;
      if (keep) {
        const long long idx = (static_cast<long long>(b) * N_SC + k) * cols + col;
        chain::store(eq_re + idx, e.x);
        chain::store(eq_im + idx, e.y);
      }
    }
    if (est) {
      s.red[g][3 * b + 0][lane] = su2;
      s.red[g][3 * b + 1][lane] = sr;
      s.red[g][3 * b + 2][lane] = si;
    }
  }
  __syncthreads();

  // -- MMSE, rank-1 closed form ---------------------------------------------------
  {
    float s_re[N_AVG], s_im[N_AVG];
#pragma unroll
    for (int b = 0; b < N_AVG; ++b) {
      float su2 = 0.f, sr = 0.f, si = 0.f;
#pragma unroll
      for (int gg = 0; gg < GROUPS; ++gg) {
        su2 += s.red[gg][3 * b + 0][lane];
        sr += s.red[gg][3 * b + 1][lane];
        si += s.red[gg][3 * b + 2][lane];
      }
      const float den = ow2 + su2;
      s_re[b] = sr / den;
      s_im[b] = si / den;
    }
#pragma unroll
    for (int j = 0; j < BINS; ++j) {
      const int k = g + GROUPS * j;
      if (k >= N_SC) continue;
      float ar = 0.f, ai = 0.f;
#pragma unroll
      for (int b = 0; b < N_AVG; ++b) {
        ar += hlt[j].x * s_re[b] - hlt[j].y * s_im[b];
        ai += hlt[j].x * s_im[b] + hlt[j].y * s_re[b];
      }
      const float2 e = make_float2(ar / N_AVG, ai / N_AVG);
      chk += e.x + e.y;
      store_plane(p.h[2 * chain::H_MMSE], p.h[2 * chain::H_MMSE + 1], k, e);
      const float ex = e.x - h[j].x, ey = e.y - h[j].y;
      err[chain::H_MMSE] += ex * ex + ey * ey;
    }
  }

  // -- per-frame sums across the bin groups ------------------------------------------
  __syncthreads();  // the MMSE dots in red are read
  s.red[g][0][lane] = chk;
  s.red[g][1][lane] = hsq;
#pragma unroll
  for (int e = 0; e < N_H; ++e) s.red[g][2 + e][lane] = err[e];
  __syncthreads();
  if (g == 0 && live) {
    float total = ow2;
#pragma unroll
    for (int gg = 0; gg < GROUPS; ++gg) total += s.red[gg][0][lane];
    p.chk[f] = total;
    if (keep) p.ow2[col] = ow2;
    if (stream) {
#pragma unroll
      for (int e = 0; e < N_SUMS; ++e) {
        const int row = e < N_H ? 2 + e : 1;
        float v = 0.f;
#pragma unroll
        for (int gg = 0; gg < GROUPS; ++gg) v += s.red[gg][row][lane];
        p.sums[e * batch + f] = v;
      }
    }
  }
}

constexpr size_t SMEM = sizeof(GenSmem);  // above the 48 KB of static shared memory

template <typename EqT>
cudaError_t launch(const GenParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(gen_chain_kernel<EqT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((p.batch + FRAMES - 1) / FRAMES);
  gen_chain_kernel<EqT><<<grid, THREADS, SMEM, stream>>>(p);
  return cudaGetLastError();
}

template <typename EqT>
cudaError_t attributes(int* out) {
  return ffi::occupancy(gen_chain_kernel<EqT>, THREADS, SMEM, out);
}

// gen::normal_pair's terms for word pairs (a[i], b[i]): the radius, the
// angle's sin and cos (f64), and the two normals.
__global__ void normals_kernel(const uint32_t* a, const uint32_t* b, double* r, double* sn,
                               double* cs, float2* z, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  r[i] = sqrt(-2.0 * gen::ln_uniform(gen::uniform_open(a[i]), gen::LN_TABLE));
  gen::sincos_turn(b[i], &sn[i], &cs[i]);
  z[i] = gen::normal_pair(a[i], b[i], gen::LN_TABLE);
}

}  // namespace

// ptrs: txs re/im, tpre re/im, wc re/im, tscale, wi re/im, seed (int32),
// then the outputs: 7 h planes re/im, eq re/im, ow2, h_true re/im, chk,
// sums (null = full mode).  eq_bf16: eq stored as bf16 (else f32).  Returns
// cudaGetLastError() after the launch.
extern "C" int gen_chain_launch(const void* const* ptrs, int n_ptrs, int batch, int n_taps,
                                float nsc, int eq_bf16, void* stream) {
  constexpr int N_IN = 10;
  if (n_ptrs != N_IN + 2 * N_H + 7 || batch <= 0 || n_taps < 1 || n_taps > gen::MAX_TAPS)
    return cudaErrorInvalidValue;
  GenParams p;
  p.txs_re = static_cast<const float*>(ptrs[0]);
  p.txs_im = static_cast<const float*>(ptrs[1]);
  p.tpre_re = static_cast<const float*>(ptrs[2]);
  p.tpre_im = static_cast<const float*>(ptrs[3]);
  p.wc_re = static_cast<const float*>(ptrs[4]);
  p.wc_im = static_cast<const float*>(ptrs[5]);
  p.tscale = static_cast<const float*>(ptrs[6]);
  p.wi_re = static_cast<const float*>(ptrs[7]);
  p.wi_im = static_cast<const float*>(ptrs[8]);
  p.seed = static_cast<const int*>(ptrs[9]);
  const void* const* out = ptrs + N_IN;
  for (int i = 0; i < 2 * N_H; ++i) p.h[i] = static_cast<float*>(const_cast<void*>(out[i]));
  p.eq_re = const_cast<void*>(out[2 * N_H]);
  p.eq_im = const_cast<void*>(out[2 * N_H + 1]);
  p.ow2 = static_cast<float*>(const_cast<void*>(out[2 * N_H + 2]));
  p.ht_re = static_cast<float*>(const_cast<void*>(out[2 * N_H + 3]));
  p.ht_im = static_cast<float*>(const_cast<void*>(out[2 * N_H + 4]));
  p.chk = static_cast<float*>(const_cast<void*>(out[2 * N_H + 5]));
  p.sums = static_cast<float*>(const_cast<void*>(out[2 * N_H + 6]));
  if (p.sums != nullptr && batch < LANES) return cudaErrorInvalidValue;
  p.batch = batch;
  p.n_taps = n_taps;
  p.nsc = nsc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return eq_bf16 ? launch<__nv_bfloat16>(p, st) : launch<float>(p, st);
}

// The Box-Muller terms of n word pairs: ptrs = a, b (uint32), then r, sin,
// cos (f64) and the normals (n float2).  Returns cudaGetLastError().
extern "C" int gen_normals_launch(const void* const* ptrs, int n_ptrs, long long n,
                                  void* stream) {
  if (n_ptrs != 6 || n <= 0) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>((n + THREADS - 1) / THREADS);
  normals_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ptrs[0]), static_cast<const uint32_t*>(ptrs[1]),
      static_cast<double*>(const_cast<void*>(ptrs[2])),
      static_cast<double*>(const_cast<void*>(ptrs[3])),
      static_cast<double*>(const_cast<void*>(ptrs[4])),
      static_cast<float2*>(const_cast<void*>(ptrs[5])), n);
  return cudaGetLastError();
}

// The kernel's instantiation for eq in bf16 (eq_bf16) or f32 on the current
// card: out = registers and local (spill) bytes a thread, shared bytes a
// block, resident blocks per SM.
extern "C" int gen_chain_attributes(int eq_bf16, int* out) {
  return eq_bf16 ? attributes<__nv_bfloat16>(out) : attributes<float>(out);
}
