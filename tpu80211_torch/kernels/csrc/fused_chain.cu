// Fused 802.11 receive chain for Hopper (sm_90a): time-domain samples in,
// seven channel estimates, the equalized blocks, sigma^2 and a per-frame
// checksum out, in one pass over device memory.
//
// Replaces the TPU kernel tpu80211/kernels/fused_chain.py::_kernel, in both
// of its pallas_call sites: _fused_call_txconst (tx-constant mode, the
// template flag TX_CONST) and _fused_call (per-frame tx).  Semantics are
// tpu80211/pipeline/sc.py::rx_chain_freq, MATH mode, without sync and
// evm_sums.  Layout is the TPU kernel's lane-major one: sample or bin row,
// frame column, so a warp's load of one row is 32 neighbouring frames.
//
// What bounds it on this card.  Per frame the chain takes 16 DFTs (15 data
// blocks + the LTS average; per-frame-tx mode adds 5 for the tx side),
// each 53 bins x 64 samples of complex multiply-add: ~1.36e4 FP32 FMAs, so
// ~2.2e5 FMAs per frame and ~2.8e10 FLOP at B = 65536 on the CUDA cores
// (~0.4 ms at the H100 SXM's ~67 TFLOP/s FP32).  Device-memory traffic is
// ~0.76 GB per step in bf16 (~0.23 ms at 3.35 TB/s).  So this kernel is
// bound by the DFT arithmetic (and, as written, by the shared-memory loads
// that feed it).  Moving the DFTs onto the tensor cores as a
// (53x64)·(64xframes) product is later work.
//
// Design.  A block of 256 threads covers 32 frames x 8 bin groups: the
// lane is the frame, warp g owns bins k = g, g+8, ... (at most 7).  One
// thread per frame would have to keep the window, h_lt and the estimates
// live, several hundred floats, far past the register limit.  Each
// 64-sample window (the LTS average, then blocks 0..14) is staged for the
// block's 32 frames in shared memory, and every thread forms the DFT of
// its own bins; all lanes of a warp read the same twiddle (a broadcast).
// Per-frame sums over bins (sigma^2, the MMSE dots, the checksum) and the
// four pilot ratios cross the 8 groups through shared memory.  Blocks 0..3
// stay in registers after their DFT: the pilot ratios and the MMSE need
// all four before the equalizer can run.  The grid is ceil(B/32) blocks;
// the ragged tail is masked on every load and store (a dead lane computes
// on zeros and never stores, and no sum runs across lanes).
//
// Rounding points follow the TPU kernel: with bf16 (or int8, upcast
// exactly) storage the DFT operands are bf16 — the twiddles are rounded to
// bf16, the LTS average is formed in f32 and rounded to bf16 — and the
// products accumulate in f32 (a bf16 x bf16 product is exact in f32).
// scale = (1+eps)*lsb multiplies the rx preamble before averaging and the
// rx block spectra after the DFT; the tx side is scaled only in
// per-frame-tx mode.  The checksum sums ow2, every h plane and every eq
// element in f32 before eq is cast to its storage type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int N_SC = 53;
constexpr int N_FFT = 64;
constexpr int N_CP = 16;
constexpr int SAMP_PER_BLOCK = 80;
constexpr int N_BLOCKS = 15;
constexpr int N_AVG = 4;           // blocks averaged into the PS estimates
constexpr int DC = 26;
constexpr int PILOT0 = 5;          // pilots at 5, 19, 33, 47
constexpr int PILOT_DELTA = 14;
constexpr int N_PILOTS = 4;
constexpr int N_KINDS = 5;         // linear, cubic, sinc, spline, wiener
constexpr int NB_PAD = 16;         // columns of the tx-constant spectra
constexpr int LTS0 = 32;           // first LTS repeat: preamble rows 32..95
constexpr int LTS1 = 96;           // second repeat: rows 96..159

constexpr int FRAMES = 32;         // frames per block, one per lane
constexpr int GROUPS = 8;          // bin groups, one per warp
constexpr int THREADS = FRAMES * GROUPS;
constexpr int BINS = (N_SC + GROUPS - 1) / GROUPS;  // bins per thread, <= 7

// h planes in output order; the pointer table passes re, im for each
enum { H_LT, H_LINEAR, H_CUBIC, H_SINC, H_SPLINE, H_WIENER, H_MMSE, N_H };
enum { EQ_LINEAR, EQ_WIENER, EQ_MMSE };
enum { STORE_F32, STORE_BF16, STORE_I8 };
constexpr int N_PTRS = 12 + 2 * N_H + 4;

struct Params {
  const void* rxp_re;   // (1200, B) rx packet, storage type
  const void* rxp_im;
  const void* rxl_re;   // (160, B) rx long preamble
  const void* rxl_im;
  const void* txa_re;   // tx-const: (53, 16) f32 spectra; else (1200, B)
  const void* txa_im;
  const void* txb_re;   // tx-const: (53, 1) f32 preamble spectrum; else (160, B)
  const void* txb_im;
  const float* w_re;    // (64, 53) block DFT
  const float* w_im;
  const float* wi_re;   // (5, 53, 4) interpolators
  const float* wi_im;
  float* h[2 * N_H];    // (53, B) each; null = not written (serve mode)
  void* eq_re;          // (15, 53, B), f32 or bf16
  void* eq_im;
  float* ow2;           // (B,)
  float* chk;           // (B,)
  long long batch;
  int eq_sel;
  float scale;
};

struct Smem {
  float2 w[N_FFT][N_SC];                 // twiddles, rounded to the operand type
  float2 wi[N_KINDS][N_SC][N_PILOTS];    // interpolator weights
  float2 txs[N_BLOCKS][N_SC];            // tx-constant block spectra
  float2 tpre[N_SC];                     // tx-constant preamble spectrum
  float2 xr[N_FFT][FRAMES];              // staged rx window
  float2 xt[N_FFT][FRAMES];              // staged tx window (per-frame tx)
  float2 hp[N_AVG][N_PILOTS][FRAMES];    // pilot ratios
  float red[GROUPS][3 * N_AVG][FRAMES];  // partial sums across bin groups
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// the DFT operand rounding point
template <bool BF16_OPS>
__device__ __forceinline__ float op(float v) {
  return BF16_OPS ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ float2 cdiv(float2 a, float2 b) {
  const float d = b.x * b.x + b.y * b.y;
  return make_float2((a.x * b.x + a.y * b.y) / d, (a.y * b.x - a.x * b.y) / d);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Stage rows row0..row0+63 of a (rows, B) plane pair for this block's frames.
template <typename T>
__device__ __forceinline__ void stage(float2* x, const void* re, const void* im,
                                      long long row0, long long batch, long long f,
                                      bool live, int g, int lane) {
  const T* pr = static_cast<const T*>(re);
  const T* pi = static_cast<const T*>(im);
  for (int n = g; n < N_FFT; n += GROUPS) {
    float2 v = make_float2(0.f, 0.f);
    if (live) {
      const long long idx = (row0 + n) * batch + f;
      v = make_float2(to_f32(pr[idx]), to_f32(pi[idx]));
    }
    x[n * FRAMES + lane] = v;
  }
}

// y[j] = sum_n W[n][g + 8j] * x[n] for this thread's bins.  Four real
// accumulators, as the TPU kernel's four real products: yr = Wr.xr - Wi.xi,
// yi = Wr.xi + Wi.xr.
__device__ __forceinline__ void dft_bins(const float2* x, const Smem& s, int g, int lane,
                                         float out_scale, float2 (&y)[BINS]) {
  float rr[BINS], ii[BINS], ri[BINS], ir[BINS];
#pragma unroll
  for (int j = 0; j < BINS; ++j) rr[j] = ii[j] = ri[j] = ir[j] = 0.f;
#pragma unroll 4
  for (int n = 0; n < N_FFT; ++n) {
    const float2 xv = x[n * FRAMES + lane];
#pragma unroll
    for (int j = 0; j < BINS; ++j) {
      const int k = g + GROUPS * j;
      if (k < N_SC) {
        const float2 w = s.w[n][k];
        rr[j] = fmaf(w.x, xv.x, rr[j]);
        ii[j] = fmaf(w.y, xv.y, ii[j]);
        ri[j] = fmaf(w.x, xv.y, ri[j]);
        ir[j] = fmaf(w.y, xv.x, ir[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < BINS; ++j)
    y[j] = make_float2((rr[j] - ii[j]) * out_scale, (ri[j] + ir[j]) * out_scale);
}

__device__ __forceinline__ void store_h(const Params& p, int which, int k, long long f,
                                        bool live, float2 v) {
  if (live && p.h[2 * which] != nullptr) {
    const long long idx = k * p.batch + f;
    p.h[2 * which][idx] = v.x;
    p.h[2 * which + 1][idx] = v.y;
  }
}

template <typename T, bool TX_CONST>
__global__ void __launch_bounds__(THREADS, 2) fused_chain_kernel(Params p) {
  constexpr bool BF16_OPS = !std::is_same<T, float>::value;
  using EqT = typename std::conditional<BF16_OPS, __nv_bfloat16, float>::type;
  extern __shared__ float4 smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);

  const int lane = threadIdx.x % FRAMES;
  const int g = threadIdx.x / FRAMES;
  const long long batch = p.batch;
  const long long f = static_cast<long long>(blockIdx.x) * FRAMES + lane;
  const bool live = f < batch;

  // -- constants ------------------------------------------------------------
  for (int i = threadIdx.x; i < N_FFT * N_SC; i += THREADS)
    (&s.w[0][0])[i] = make_float2(op<BF16_OPS>(p.w_re[i]), op<BF16_OPS>(p.w_im[i]));
  for (int i = threadIdx.x; i < N_KINDS * N_SC * N_PILOTS; i += THREADS)
    (&s.wi[0][0][0])[i] = make_float2(p.wi_re[i], p.wi_im[i]);
  if constexpr (TX_CONST) {
    const float* txs_re = static_cast<const float*>(p.txa_re);
    const float* txs_im = static_cast<const float*>(p.txa_im);
    for (int i = threadIdx.x; i < N_BLOCKS * N_SC; i += THREADS) {
      const int b = i / N_SC, k = i % N_SC;
      s.txs[b][k] = make_float2(txs_re[k * NB_PAD + b], txs_im[k * NB_PAD + b]);
    }
    for (int k = threadIdx.x; k < N_SC; k += THREADS)
      s.tpre[k] = make_float2(static_cast<const float*>(p.txb_re)[k],
                              static_cast<const float*>(p.txb_im)[k]);
  }

  // -- preamble: scale, average the LTS repeats, sigma^2 ---------------------
  {
    const T* lr = static_cast<const T*>(p.rxl_re);
    const T* li = static_cast<const T*>(p.rxl_im);
    float ow2_part = 0.f;
    for (int n = g; n < N_FFT; n += GROUPS) {
      float ar = 0.f, ai = 0.f, br = 0.f, bi = 0.f;
      if (live) {
        const long long i1 = (LTS0 + n) * batch + f, i2 = (LTS1 + n) * batch + f;
        ar = to_f32(lr[i1]) * p.scale;
        ai = to_f32(li[i1]) * p.scale;
        br = to_f32(lr[i2]) * p.scale;
        bi = to_f32(li[i2]) * p.scale;
      }
      const float dr = ar - br, di = ai - bi;
      ow2_part += dr * dr + di * di;
      s.xr[n][lane] = make_float2(op<BF16_OPS>((ar + br) * 0.5f), op<BF16_OPS>((ai + bi) * 0.5f));
      if constexpr (!TX_CONST) {
        const T* tr = static_cast<const T*>(p.txb_re);
        const T* ti = static_cast<const T*>(p.txb_im);
        float cr = 0.f, ci = 0.f, dr2 = 0.f, di2 = 0.f;
        if (live) {
          const long long i1 = (LTS0 + n) * batch + f, i2 = (LTS1 + n) * batch + f;
          cr = to_f32(tr[i1]) * p.scale;
          ci = to_f32(ti[i1]) * p.scale;
          dr2 = to_f32(tr[i2]) * p.scale;
          di2 = to_f32(ti[i2]) * p.scale;
        }
        s.xt[n][lane] = make_float2(op<BF16_OPS>((cr + dr2) * 0.5f), op<BF16_OPS>((ci + di2) * 0.5f));
      }
    }
    s.red[g][0][lane] = ow2_part;
  }
  __syncthreads();
  float ow2 = 0.f;
#pragma unroll
  for (int gg = 0; gg < GROUPS; ++gg) ow2 += s.red[gg][0][lane];
  ow2 = ow2 / (2.f * N_FFT);

  // -- LT-LS -------------------------------------------------------------------
  float2 hlt[BINS];
  float chk = 0.f;  // this thread's share of the checksum (ow2 is added once, at the end)
  {
    float2 rpre[BINS], tpre[BINS];
    dft_bins(&s.xr[0][0], s, g, lane, 1.f, rpre);
    if constexpr (TX_CONST) {
#pragma unroll
      for (int j = 0; j < BINS; ++j) {
        const int k = g + GROUPS * j;
        tpre[j] = k < N_SC ? s.tpre[k] : make_float2(1.f, 0.f);
      }
    } else {
      dft_bins(&s.xt[0][0], s, g, lane, 1.f, tpre);
    }
#pragma unroll
    for (int j = 0; j < BINS; ++j) {
      const int k = g + GROUPS * j;
      hlt[j] = make_float2(0.f, 0.f);
      if (k < N_SC) {
        if (k != DC) {
          const float2 t = tpre[j], r = rpre[j];
          const float d = t.x * t.x + t.y * t.y;
          hlt[j] = make_float2((t.x * r.x + t.y * r.y) / d, (t.x * r.y - t.y * r.x) / d);
        }
        chk += hlt[j].x + hlt[j].y;
        store_h(p, H_LT, k, f, live, hlt[j]);
      }
    }
  }

  // -- blocks 0..3: spectra kept, pilot ratios, MMSE partial dots --------------
  float2 rkeep[N_AVG][BINS];
#pragma unroll
  for (int b = 0; b < N_AVG; ++b) {
    const long long row0 = b * SAMP_PER_BLOCK + N_CP;
    __syncthreads();  // every reader of the previous window is done
    stage<T>(&s.xr[0][0], p.rxp_re, p.rxp_im, row0, batch, f, live, g, lane);
    if constexpr (!TX_CONST) stage<T>(&s.xt[0][0], p.txa_re, p.txa_im, row0, batch, f, live, g, lane);
    __syncthreads();
    float2 tb[BINS];
    dft_bins(&s.xr[0][0], s, g, lane, p.scale, rkeep[b]);
    if constexpr (TX_CONST) {
#pragma unroll
      for (int j = 0; j < BINS; ++j) {
        const int k = g + GROUPS * j;
        tb[j] = k < N_SC ? s.txs[b][k] : make_float2(1.f, 0.f);
      }
    } else {
      dft_bins(&s.xt[0][0], s, g, lane, p.scale, tb);
    }
    float su2 = 0.f, sr = 0.f, si = 0.f;
#pragma unroll
    for (int j = 0; j < BINS; ++j) {
      const int k = g + GROUPS * j;
      if (k < N_SC) {
        const float2 rb = rkeep[b][j];
        if (k >= PILOT0 && (k - PILOT0) % PILOT_DELTA == 0 && k < PILOT0 + N_PILOTS * PILOT_DELTA)
          s.hp[b][(k - PILOT0) / PILOT_DELTA][lane] = cdiv(rb, tb[j]);
        const float2 u = cmul(tb[j], hlt[j]);
        su2 += u.x * u.x + u.y * u.y;
        sr += u.x * rb.x + u.y * rb.y;  // Re(conj(u) rx)
        si += u.x * rb.y - u.y * rb.x;  // Im(conj(u) rx)
      }
    }
    s.red[g][3 * b + 0][lane] = su2;
    s.red[g][3 * b + 1][lane] = sr;
    s.red[g][3 * b + 2][lane] = si;
  }
  __syncthreads();

  // -- interpolators: H = W (53x4) . mean_b hp_b; Wiener's W is complex --------
  float2 hps[BINS];  // the PS estimate the equalizer blends in
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
      hps[j] = make_float2(0.f, 0.f);
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
        const float2 h = make_float2(hr / N_AVG, hi / N_AVG);
        chk += h.x + h.y;
        store_h(p, H_LINEAR + kind, k, f, live, h);
        if ((kind == 0 && p.eq_sel == EQ_LINEAR) || (kind == N_KINDS - 1 && p.eq_sel == EQ_WIENER))
          hps[j] = h;
      }
    }
  }

  // -- MMSE, rank-1 closed form: s_b = u_b^H rx_b / (sigma^2 + |u_b|^2) -------
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
      const float2 h = make_float2(ar / N_AVG, ai / N_AVG);
      chk += h.x + h.y;
      store_h(p, H_MMSE, k, f, live, h);
      if (p.eq_sel == EQ_MMSE) hps[j] = h;
    }
  }

  // -- equalize: blend h_lt with the PS estimate, divide, DC to zero ----------
  EqT* eq_re = static_cast<EqT*>(p.eq_re);
  EqT* eq_im = static_cast<EqT*>(p.eq_im);
  auto equalize = [&](int b, const float2 (&rb)[BINS]) {
    const float w_ps = static_cast<float>(b + 1) / N_BLOCKS;
    const float w_lt = static_cast<float>(N_BLOCKS - 1 - b) / N_BLOCKS;
#pragma unroll
    for (int j = 0; j < BINS; ++j) {
      const int k = g + GROUPS * j;
      if (k >= N_SC) continue;
      float2 e = make_float2(0.f, 0.f);
      if (k != DC) {
        const float2 hu = make_float2(w_lt * hlt[j].x + w_ps * hps[j].x,
                                      w_lt * hlt[j].y + w_ps * hps[j].y);
        e = cdiv(rb[j], hu);  // no zero guard, as the TPU kernel
      }
      chk += e.x + e.y;
      if (live) {
        const long long idx = (static_cast<long long>(b) * N_SC + k) * batch + f;
        store(eq_re + idx, e.x);
        store(eq_im + idx, e.y);
      }
    }
  };
#pragma unroll
  for (int b = 0; b < N_AVG; ++b) equalize(b, rkeep[b]);
  for (int b = N_AVG; b < N_BLOCKS; ++b) {
    __syncthreads();
    stage<T>(&s.xr[0][0], p.rxp_re, p.rxp_im, b * SAMP_PER_BLOCK + N_CP, batch, f, live, g, lane);
    __syncthreads();
    float2 rb[BINS];
    dft_bins(&s.xr[0][0], s, g, lane, p.scale, rb);
    equalize(b, rb);
  }

  // -- checksum: ow2 + every h plane + every eq element, summed across groups -
  __syncthreads();
  s.red[g][0][lane] = chk;
  __syncthreads();
  if (g == 0 && live) {
    float total = ow2;
#pragma unroll
    for (int gg = 0; gg < GROUPS; ++gg) total += s.red[gg][0][lane];
    p.ow2[f] = ow2;
    p.chk[f] = total;
  }
}

template <typename T, bool TX_CONST>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kernel = fused_chain_kernel<T, TX_CONST>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(sizeof(Smem)));
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((p.batch + FRAMES - 1) / FRAMES);
  kernel<<<grid, THREADS, sizeof(Smem), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// ptrs: rxp re/im, rxl re/im, tx_a re/im, tx_b re/im, w re/im, wi re/im,
// 7 h planes re/im (null = not written), eq re/im, ow2, chk.
// storage: 0 f32, 1 bf16, 2 int8 (tx-constant only).  eq_sel: 0 h_linear,
// 1 h_wiener, 2 h_mmse.  Returns cudaGetLastError() after the launch.
extern "C" int fused_chain_launch(const void* const* ptrs, int n_ptrs, int storage,
                                  int tx_const, int eq_sel, int batch, float eps,
                                  float lsb, void* stream) {
  if (n_ptrs != N_PTRS || batch <= 0 || eq_sel < EQ_LINEAR || eq_sel > EQ_MMSE)
    return cudaErrorInvalidValue;
  Params p;
  p.rxp_re = ptrs[0];
  p.rxp_im = ptrs[1];
  p.rxl_re = ptrs[2];
  p.rxl_im = ptrs[3];
  p.txa_re = ptrs[4];
  p.txa_im = ptrs[5];
  p.txb_re = ptrs[6];
  p.txb_im = ptrs[7];
  p.w_re = static_cast<const float*>(ptrs[8]);
  p.w_im = static_cast<const float*>(ptrs[9]);
  p.wi_re = static_cast<const float*>(ptrs[10]);
  p.wi_im = static_cast<const float*>(ptrs[11]);
  for (int i = 0; i < 2 * N_H; ++i) p.h[i] = static_cast<float*>(const_cast<void*>(ptrs[12 + i]));
  p.eq_re = const_cast<void*>(ptrs[12 + 2 * N_H]);
  p.eq_im = const_cast<void*>(ptrs[13 + 2 * N_H]);
  p.ow2 = static_cast<float*>(const_cast<void*>(ptrs[14 + 2 * N_H]));
  p.chk = static_cast<float*>(const_cast<void*>(ptrs[15 + 2 * N_H]));
  p.batch = batch;
  p.eq_sel = eq_sel;
  p.scale = (1.0f + eps) * lsb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tx_const) {
    switch (storage) {
      case STORE_F32: return launch<float, true>(p, st);
      case STORE_BF16: return launch<__nv_bfloat16, true>(p, st);
      case STORE_I8: return launch<int8_t, true>(p, st);
    }
  } else {
    switch (storage) {
      case STORE_F32: return launch<float, false>(p, st);
      case STORE_BF16: return launch<__nv_bfloat16, false>(p, st);
    }
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* fused_chain_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
