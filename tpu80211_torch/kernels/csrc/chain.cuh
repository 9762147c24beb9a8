// The fused 802.11 receive chain as a __device__ function: a block's 32
// frames of time-domain samples in, seven channel estimates, the equalized
// blocks, sigma^2, the CFO, a per-frame checksum and (optionally) the
// per-frame EVM sum out.
//
// Semantics are tpu80211/kernels/fused_chain.py::_kernel (equal to
// tpu80211/pipeline/sc.py::rx_chain, MATH mode), with its options:
// tx-constant or per-frame tx (the template flag TX_CONST), eps/lsb load
// scaling, serve (null h pointers are not written), equalize_with, and the
// template flags SYNC (Moose CFO + derotation + pilot CPE) and EVM
// (evm_sums): compiled apart, so the plain chain keeps its registers.  Two kernels run it:
// fused_chain.cu reads packets and preambles from their own (rows, B)
// buffers (row base 0); raw_chain.cu reads both from the raw (NS, B)
// stream at each stream's detected start.  Every (rows, B) buffer is
// lane-major with row stride B, so a warp's load of one row is 32
// neighbouring frames when the row bases agree.
//
// Layout of a block: 256 threads = 32 frames (the lane) x 8 bin groups
// (the warp); group g owns bins k = g, g+8, ... (at most 7).  Each 64-sample
// window is staged in shared memory for the block's 32 frames, and every
// thread forms the DFT of its own bins; per-frame sums over bins (sigma^2,
// the MMSE dots, the CFO correlation, the CPE, the EVM, the checksum) cross
// the groups through shared memory.  A dead lane (frame >= B) computes on
// zeros and never stores.
//
// Rounding points follow the TPU kernel: with bf16 (or int8, exact in bf16)
// storage the DFT operands are bf16 -- the twiddles, the LTS average formed
// in f32, and with sync each block's samples after their f32 derotation --
// and the products accumulate in f32 (bf16 x bf16 is exact in f32).
// scale = (1+eps)*lsb multiplies the rx preamble before the CFO estimate
// and the rx block spectra after the DFT; the tx side is scaled only in
// per-frame-tx mode and is never derotated.
//
// The derotated samples agree bit for bit with the plain PyTorch version's,
// so that their bf16 rounding does too: the Moose correlation is summed in
// f64 (products of f32 values are exact there) and the CFO is
// atan2/(2pi*64) in f64 rounded to f32; the angle is ((-2pi)*cfo)*t in f32
// (t = 0..159 on the preamble, t = 160 + 80b + 16 + n in block b); cos and
// sin are taken in f64 and rounded to f32 (correctly rounded on both
// sides); and the rotation's products and sums are rounded one by one (no
// FMA contraction).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace chain {

constexpr int N_SC = 53;
constexpr int N_FFT = 64;
constexpr int N_CP = 16;
constexpr int SAMP_PER_BLOCK = 80;
constexpr int N_BLOCKS = 15;
constexpr int PREAMBLE = 160;      // long preamble rows; the packet follows
constexpr int N_AVG = 4;           // blocks averaged into the PS estimates
constexpr int DC = 26;
constexpr int PILOT0 = 5;          // pilots at 5, 19, 33, 47
constexpr int PILOT_DELTA = 14;
constexpr int N_PILOTS = 4;
constexpr int N_KINDS = 5;         // linear, cubic, sinc, spline, wiener
constexpr int NB_PAD = 16;         // columns of the tx-constant spectra
constexpr int LTS0 = 32;           // first LTS repeat: preamble rows 32..95
constexpr int LTS1 = 96;           // second repeat: rows 96..159
constexpr float NEG_TWO_PI = -6.28318530717958647692f;
constexpr double TWO_PI_64 = 402.123859659493534523;  // 2pi * N_FFT

constexpr int FRAMES = 32;         // frames per block, one per lane
constexpr int GROUPS = 8;          // bin groups, one per warp
constexpr int THREADS = FRAMES * GROUPS;
constexpr int BINS = (N_SC + GROUPS - 1) / GROUPS;  // bins per thread, <= 7

// h planes in output order; the pointer tables pass re, im for each
enum { H_LT, H_LINEAR, H_CUBIC, H_SINC, H_SPLINE, H_WIENER, H_MMSE, N_H };
enum { EQ_LINEAR, EQ_WIENER, EQ_MMSE };
enum { STORE_F32, STORE_BF16, STORE_I8 };
// output pointers, in order: 7 h planes re/im, eq re/im, ow2, cfo, chk, evm
constexpr int N_OUT_PTRS = 2 * N_H + 6;

struct Params {
  const void* rxp_re;   // rx packet rows, storage type (row base pkt_base)
  const void* rxp_im;
  const void* rxl_re;   // rx long preamble rows (row base lp_base)
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
  void* eq_re;          // (15, 53, B), f32 or bf16; null = not written
  void* eq_im;
  float* ow2;           // (B,)
  float* cfo;           // (B,) the CFO estimate (0 without sync)
  float* chk;           // (B,)
  float* evm;           // (B,) sum |eq - tx|^2; null = not computed
  long long batch;      // frames, and the row stride of every (rows, B) buffer
  int eq_sel;
  float scale;
};

// Unpack the output pointers of a launch's pointer table.
inline void set_outputs(Params& p, const void* const* out) {
  for (int i = 0; i < 2 * N_H; ++i) p.h[i] = static_cast<float*>(const_cast<void*>(out[i]));
  p.eq_re = const_cast<void*>(out[2 * N_H]);
  p.eq_im = const_cast<void*>(out[2 * N_H + 1]);
  p.ow2 = static_cast<float*>(const_cast<void*>(out[2 * N_H + 2]));
  p.cfo = static_cast<float*>(const_cast<void*>(out[2 * N_H + 3]));
  p.chk = static_cast<float*>(const_cast<void*>(out[2 * N_H + 4]));
  p.evm = static_cast<float*>(const_cast<void*>(out[2 * N_H + 5]));
}

struct Smem {
  float2 w[N_FFT][N_SC];                 // twiddles, rounded to the operand type
  float2 wi[N_KINDS][N_SC][N_PILOTS];    // interpolator weights
  float2 txs[N_BLOCKS][N_SC];            // tx-constant block spectra
  float2 tpre[N_SC];                     // tx-constant preamble spectrum
  float2 xr[N_FFT][FRAMES];              // staged rx window
  float2 xt[N_FFT][FRAMES];              // staged tx window (per-frame tx)
  float2 hp[N_AVG][N_PILOTS][FRAMES];    // pilot ratios
  float2 cpe[2][N_PILOTS][FRAMES];       // pilot CPE terms, double-buffered
  double cred[GROUPS][2][FRAMES];        // Moose correlation partial sums
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

// v * exp(-2pi i cfo t): the f32 angle's cos and sin correctly rounded to
// f32, the rotation rounded as separate f32 products and sums
__device__ __forceinline__ float2 derotate(float2 v, float cfo, int t) {
  const float ang = __fmul_rn(__fmul_rn(NEG_TWO_PI, cfo), static_cast<float>(t));
  double sd, cd;
  sincos(static_cast<double>(ang), &sd, &cd);
  const float sn = static_cast<float>(sd), cs = static_cast<float>(cd);
  return make_float2(__fsub_rn(__fmul_rn(v.x, cs), __fmul_rn(v.y, sn)),
                     __fadd_rn(__fmul_rn(v.x, sn), __fmul_rn(v.y, cs)));
}

// Stage rows row0..row0+63 of a plane pair (row stride batch, this lane's
// rows from ``base``) for the block's frames, rounded to the operand type;
// with ``derot`` each sample is first derotated at t = t0 + n.
template <typename T, bool BF16_OPS>
__device__ __forceinline__ void stage(float2* x, const void* re, const void* im,
                                      long long base, long long row0, long long batch,
                                      long long f, bool live, int g, int lane,
                                      bool derot, float cfo, int t0) {
  const T* pr = static_cast<const T*>(re);
  const T* pi = static_cast<const T*>(im);
  for (int n = g; n < N_FFT; n += GROUPS) {
    float2 v = make_float2(0.f, 0.f);
    if (live) {
      const long long idx = (base + row0 + n) * batch + f;
      v = make_float2(to_f32(pr[idx]), to_f32(pi[idx]));
    }
    if (derot) v = derotate(v, cfo, t0 + n);
    x[n * FRAMES + lane] = make_float2(op<BF16_OPS>(v.x), op<BF16_OPS>(v.y));
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

__device__ __forceinline__ int pilot_of(int k) {
  return (k >= PILOT0 && (k - PILOT0) % PILOT_DELTA == 0 && k < PILOT0 + N_PILOTS * PILOT_DELTA)
             ? (k - PILOT0) / PILOT_DELTA : -1;
}

// The whole chain for frame f (column f of every buffer) in lane ``lane``
// of group ``g``.  lp_base, pkt_base: this lane's first row of the rx
// preamble and packet.  EVM needs p.evm.  Every thread of the block calls
// it (it holds __syncthreads); a dead lane passes live = false.
template <typename T, bool TX_CONST, bool SYNC, bool EVM>
__device__ void run(const Params& p, Smem& s, long long f, bool live, int lane, int g,
                    long long lp_base, long long pkt_base) {
  constexpr bool BF16_OPS = !std::is_same<T, float>::value;
  using EqT = typename std::conditional<BF16_OPS, __nv_bfloat16, float>::type;
  const long long batch = p.batch;
  // per-frame tx with CPE or EVM needs the tx spectra of every block
  constexpr bool tx_all = !TX_CONST && (SYNC || EVM);

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

  const T* lr = static_cast<const T*>(p.rxl_re);
  const T* li = static_cast<const T*>(p.rxl_im);
  // the two LTS repeats of this lane, scaled, at preamble row n
  auto lts_pair = [&](int n, float2& a, float2& b) {
    a = b = make_float2(0.f, 0.f);
    if (live) {
      const long long i1 = (lp_base + LTS0 + n) * batch + f;
      const long long i2 = (lp_base + LTS1 + n) * batch + f;
      a = make_float2(to_f32(lr[i1]) * p.scale, to_f32(li[i1]) * p.scale);
      b = make_float2(to_f32(lr[i2]) * p.scale, to_f32(li[i2]) * p.scale);
    }
  };

  // -- CFO (Moose): c = sum conj(r1) r2 over the scaled repeats, in f64 ------
  float cfo = 0.f;
  if constexpr (SYNC) {
    double cr = 0.0, ci = 0.0;
    for (int n = g; n < N_FFT; n += GROUPS) {
      float2 a, b;
      lts_pair(n, a, b);
      cr += static_cast<double>(a.x) * b.x + static_cast<double>(a.y) * b.y;
      ci += static_cast<double>(a.x) * b.y - static_cast<double>(a.y) * b.x;
    }
    s.cred[g][0][lane] = cr;
    s.cred[g][1][lane] = ci;
    __syncthreads();
    cr = ci = 0.0;
#pragma unroll
    for (int gg = 0; gg < GROUPS; ++gg) {
      cr += s.cred[gg][0][lane];
      ci += s.cred[gg][1][lane];
    }
    cfo = static_cast<float>(atan2(ci, cr) / TWO_PI_64);
  }

  // -- preamble: derotate, average the LTS repeats, sigma^2 -------------------
  {
    float ow2_part = 0.f;
    for (int n = g; n < N_FFT; n += GROUPS) {
      float2 a, b;
      lts_pair(n, a, b);
      if constexpr (SYNC) {
        a = derotate(a, cfo, LTS0 + n);
        b = derotate(b, cfo, LTS1 + n);
      }
      const float dr = a.x - b.x, di = a.y - b.y;
      ow2_part += dr * dr + di * di;
      s.xr[n][lane] = make_float2(op<BF16_OPS>((a.x + b.x) * 0.5f), op<BF16_OPS>((a.y + b.y) * 0.5f));
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

  // the tx spectrum of block b at this thread's bins (per-frame tx: its DFT
  // from the staged window in s.xt)
  auto tx_block = [&](int b, float2 (&tb)[BINS]) {
    if constexpr (TX_CONST) {
#pragma unroll
      for (int j = 0; j < BINS; ++j) {
        const int k = g + GROUPS * j;
        tb[j] = k < N_SC ? s.txs[b][k] : make_float2(1.f, 0.f);
      }
    } else {
      dft_bins(&s.xt[0][0], s, g, lane, p.scale, tb);
    }
  };
  auto stage_rx = [&](int b) {
    const int row0 = b * SAMP_PER_BLOCK + N_CP;
    stage<T, BF16_OPS>(&s.xr[0][0], p.rxp_re, p.rxp_im, pkt_base, row0, batch, f, live, g,
                       lane, SYNC, cfo, PREAMBLE + row0);
  };
  auto stage_tx = [&](int b) {
    stage<T, BF16_OPS>(&s.xt[0][0], p.txa_re, p.txa_im, 0, b * SAMP_PER_BLOCK + N_CP, batch, f,
                       live, g, lane, false, 0.f, 0);
  };

  // -- blocks 0..3: spectra kept, pilot ratios, MMSE partial dots --------------
  float2 rkeep[N_AVG][BINS];
#pragma unroll
  for (int b = 0; b < N_AVG; ++b) {
    __syncthreads();  // every reader of the previous window is done
    stage_rx(b);
    if constexpr (!TX_CONST) stage_tx(b);
    __syncthreads();
    float2 tb[BINS];
    dft_bins(&s.xr[0][0], s, g, lane, p.scale, rkeep[b]);
    tx_block(b, tb);
    float su2 = 0.f, sr = 0.f, si = 0.f;
#pragma unroll
    for (int j = 0; j < BINS; ++j) {
      const int k = g + GROUPS * j;
      if (k < N_SC) {
        const float2 rb = rkeep[b][j];
        const int q = pilot_of(k);
        if (q >= 0) s.hp[b][q][lane] = cdiv(rb, tb[j]);
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

  // -- equalize: blend h_lt with the PS estimate, divide, DC to zero; then
  //    the pilot CPE (sync), the EVM sum, the checksum and the store ----------
  EqT* eq_re = static_cast<EqT*>(p.eq_re);
  EqT* eq_im = static_cast<EqT*>(p.eq_im);
  float evm = 0.f;
  auto equalize = [&](int b, const float2 (&rb)[BINS], const float2 (&tb)[BINS]) {
    const float w_ps = static_cast<float>(b + 1) / N_BLOCKS;
    const float w_lt = static_cast<float>(N_BLOCKS - 1 - b) / N_BLOCKS;
    float2 e[BINS];
#pragma unroll
    for (int j = 0; j < BINS; ++j) {
      const int k = g + GROUPS * j;
      e[j] = make_float2(0.f, 0.f);
      if (k < N_SC && k != DC) {
        const float2 hu = make_float2(w_lt * hlt[j].x + w_ps * hps[j].x,
                                      w_lt * hlt[j].y + w_ps * hps[j].y);
        e[j] = cdiv(rb[j], hu);  // no zero guard, as the TPU kernel
      }
    }
    if constexpr (SYNC) {
      // g_b = sum_p eq[p] conj(tx[p]) in pilot order; eq *= conj(g)/|g|
      float2(*cpe)[FRAMES] = s.cpe[b & 1];
#pragma unroll
      for (int j = 0; j < BINS; ++j) {
        const int q = pilot_of(g + GROUPS * j);
        if (q >= 0)
          cpe[q][lane] = make_float2(e[j].x * tb[j].x + e[j].y * tb[j].y,
                                     e[j].y * tb[j].x - e[j].x * tb[j].y);
      }
      __syncthreads();
      float gr = cpe[0][lane].x, gi = cpe[0][lane].y;
#pragma unroll
      for (int q = 1; q < N_PILOTS; ++q) {
        gr += cpe[q][lane].x;
        gi += cpe[q][lane].y;
      }
      float mag = sqrtf(gr * gr + gi * gi);
      if (mag == 0.f) mag = 1.f;
      const float rr = gr / mag, ri = -gi / mag;
#pragma unroll
      for (int j = 0; j < BINS; ++j)
        e[j] = make_float2(e[j].x * rr - e[j].y * ri, e[j].x * ri + e[j].y * rr);
    }
#pragma unroll
    for (int j = 0; j < BINS; ++j) {
      const int k = g + GROUPS * j;
      if (k >= N_SC) continue;
      if constexpr (EVM) {
        const float dr = e[j].x - tb[j].x, di = e[j].y - tb[j].y;
        evm += dr * dr + di * di;
      }
      chk += e[j].x + e[j].y;
      if (live && eq_re != nullptr) {
        const long long idx = (static_cast<long long>(b) * N_SC + k) * batch + f;
        store(eq_re + idx, e[j].x);
        store(eq_im + idx, e[j].y);
      }
    }
  };
#pragma unroll
  for (int b = 0; b < N_AVG; ++b) {
    float2 tb[BINS];
    if constexpr (tx_all) {  // the tx window of block b again, for its full spectrum
      __syncthreads();
      stage_tx(b);
      __syncthreads();
    }
    tx_block(b, tb);
    equalize(b, rkeep[b], tb);
  }
  for (int b = N_AVG; b < N_BLOCKS; ++b) {
    __syncthreads();
    stage_rx(b);
    if constexpr (tx_all) stage_tx(b);
    __syncthreads();
    float2 rb[BINS], tb[BINS];
    dft_bins(&s.xr[0][0], s, g, lane, p.scale, rb);
    if constexpr (TX_CONST || tx_all) tx_block(b, tb);
    equalize(b, rb, tb);
  }

  // -- checksum and EVM: summed across groups ----------------------------------
  __syncthreads();
  s.red[g][0][lane] = chk;
  s.red[g][1][lane] = evm;
  __syncthreads();
  if (g == 0 && live) {
    float total = ow2, evm_total = 0.f;
#pragma unroll
    for (int gg = 0; gg < GROUPS; ++gg) {
      total += s.red[gg][0][lane];
      evm_total += s.red[gg][1][lane];
    }
    p.ow2[f] = ow2;
    p.cfo[f] = cfo;
    p.chk[f] = total;
    if constexpr (EVM) p.evm[f] = evm_total;
  }
}

}  // namespace chain
