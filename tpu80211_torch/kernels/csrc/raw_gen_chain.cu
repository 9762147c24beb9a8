// The generative raw system for Hopper (sm_90a): a seed in; per stream a
// channel, a time-domain frame at a random offset in NS samples of AWGN
// (with an optional CFO), then detection, timing and the tx-constant chain
// on it, in one launch.  Out: detection rows, the true offsets, CFR and CFO,
// h_wiener, h_mmse, the per-stream EVM sums, sigma^2, the CFO estimate and
// the checksum.
//
// Replaces tpu80211/kernels/raw_gen_chain.py::_gen_raw_kernel (pallas_call
// site _gen_raw_call), point by point:
//   * the channel draw of gen_chain.cu (gen.cuh: each tap drawn once, by
//     one warp, into shared memory where the symbols' spectra go later);
//   * the frame: 16 IDFTs (64 x 53) of tx_s H in f64, rounded to f32 and
//     then to bf16 (the TPU kernel's bf16 placement), laid out as the long
//     preamble [last 32 | LTS | LTS] and 15 blocks [CP 16 | 64];
//   * offset 40 + (bits & 0x7fffffff) % span, span = NS - 1360 - 40;
//   * with cfo_khz > 0 a per-stream eps = (2u - 1) cfo_khz 1e3 / 20e6 as a
//     phase ramp over the stream's rows (f32 angle, f64 sincos rounded to
//     f32, no FMA in the rotation);
//   * AWGN nsc N on every row, nsc = sqrt(sigma_t^2 / 2) per plane;
//   * detect.cuh on the f32 field, decimated (stride 16); start = -1 where
//     nothing was detected;
//   * chain.cuh (tx-constant, serve, no eq, EVM sums, sync iff cfo_khz > 0)
//     on the aligned rows rounded to bf16: the field is read through
//     gen::Bf16Sample, whose loads round to bf16, so the chain computes on
//     exactly the bf16 rows the TPU kernel hands it.
// The additions and products of the synthesis are rounded one by one, as
// the plain PyTorch version rounds them, and the draws are gen.cuh's: the
// field agrees bit for bit with kernels/raw_gen_chain.py::gen_raw_plain's,
// so detection does too.
//
// Design: one block holds 32 streams x 8 groups.  Like the TPU kernel it
// builds each frame first and then puts it in place, but the frame's home is
// not the field.  A frame has 1,024 distinct samples (16 symbols x 64); the
// cyclic prefixes and the preamble's [last 32 | LTS | LTS] are copies.  Each
// thread computes 8 consecutive samples of a symbol and stores them, as bf16
// pairs, in one 32-B sector of its stream's 4 KB row of a compact (B, 1024)
// scratch (the wrapper's).  Then the (NS, B) f32 field is written once, half
// the block's streams at a time: the half's 16 compact rows (64 KB) are
// copied into shared memory, and a warp takes two rows with 16 lanes on
// each, so every store of the field covers 64 contiguous bytes of one row in
// each plane and a frame row reads its sample from shared memory.  Shared
// memory cannot hold all 32 frames with the IDFT's matrices (128 KB more
// would leave one block per SM for the whole kernel, detection and chain
// included); half of them fit in the union the chain already needs.  After
// a barrier the block runs detect::run and chain::run on its own columns
// exactly as raw_chain.cu does.
//
// What bounds it on this card.  Before this design each frame row was stored
// at its stream's own offset, 4 bytes a lane into 32 different rows, and
// those stores took 3.6 of 8.4 ms (PERF.md).  Now: per stream 2,056
// Box-Muller pairs (8 taps) and a Philox call each, in f64, 16 IDFTs (2.2e5 f64
// FMAs), the field written once (16 KB) and read by detection, then
// raw_chain's detection (f64 matched filter on staged windows) and chain (its
// DFTs on the tensor cores, its rows loaded per lane), which take most of
// the time.  The field alone is >= 0.16 ms of HBM writes at B = 32,768,
// NS = 2,048.

#include "chain.cuh"
#include "detect.cuh"
#include "ffi.cuh"
#include "gen.cuh"

#include <cstddef>
#include <initializer_list>

namespace gen {

// An f32 scratch sample that the chain reads as a bf16 sample word: rounded
// to bf16 on load (found by argument-dependent lookup from chain.cuh).
struct Bf16Sample {
  float v;
};
__device__ __forceinline__ float to_f32(Bf16Sample x) {
  return __bfloat162float(__float2bfloat16_rn(x.v));
}

}  // namespace gen

static_assert(sizeof(gen::Bf16Sample) == sizeof(float), "the scratch is read in place");
static_assert(chain::FRAMES == detect::LANES && chain::GROUPS == detect::WARPS,
              "the chain and the detector share one block layout");

namespace {

using chain::BINS;
using chain::FRAMES;
using chain::GROUPS;
using chain::N_FFT;
using chain::N_SC;
using chain::THREADS;

constexpr int N_SYMBOLS = 1 + chain::N_BLOCKS;  // the LTS, then the data blocks
constexpr int PER_THREAD = N_FFT / GROUPS;       // samples of a symbol per thread
constexpr int N_DISTINCT = N_SYMBOLS * N_FFT;    // distinct samples of a frame
constexpr int MIN_OFFSET = 40;
constexpr float TWO_PI_F = 6.28318530717958647692f;

// Frame row rel (0 <= rel < 1360) as an index into the 1024 distinct
// samples, symbol-major: the long preamble [last 32 | LTS | LTS] is symbol 0
// from its sample 32 on; data block b's [CP 16 | 64] is symbol 1 + b from its
// sample 48 on.
__device__ __forceinline__ int frame_sample(int rel) {
  if (rel < chain::PREAMBLE) return (rel + N_FFT / 2) & (N_FFT - 1);
  const int q = rel - chain::PREAMBLE;
  const int b = q / chain::SAMP_PER_BLOCK, c = q - b * chain::SAMP_PER_BLOCK;
  return (1 + b) * N_FFT + ((c + N_FFT - chain::N_CP) & (N_FFT - 1));
}

// A sample rounded to bf16 in each plane, as one word: re in the low half.
__device__ __forceinline__ uint32_t bf16_pair(double re, double im) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(static_cast<float>(re)))) |
         static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(static_cast<float>(im))))
             << 16;
}

struct SynthSmem {
  gen::LnEntry ln[gen::LN_ENTRIES];  // Box-Muller's log table, kept for the field pass
  double2 v[N_FFT][N_SC];            // the IDFT
  union {
    double2 x[N_SC][FRAMES];              // one symbol's spectrum per stream
    float2 taps[gen::MAX_TAPS][FRAMES];  // before the symbols: the streams' taps
  };
  float2 txs[chain::N_BLOCKS][N_SC];
  float2 tpre[N_SC];
  float2 wc[N_SC][gen::MAX_TAPS];
};

constexpr int HALF = FRAMES / 2;  // streams whose frames the field pass holds at once

// The field pass's shared memory, in place of SynthSmem once the frames are
// built: half the block's compact frames, and every stream's offset and CFO.
struct FieldSmem {
  gen::LnEntry ln[gen::LN_ENTRIES];  // SynthSmem's
  uint32_t frame[HALF][N_DISTINCT];
  int off[FRAMES];
  float eps[FRAMES];
};

static_assert(offsetof(SynthSmem, ln) == 0 && offsetof(FieldSmem, ln) == 0,
              "the field pass finds the staged log table where the synthesis left it");

struct RawGenParams {
  detect::Config det_cfg;
  chain::Params chain;
  const float* v_re;  // (64, 53) IDFT
  const float* v_im;
  const float* wc_re;  // (53, n_taps)
  const float* wc_im;
  const float* tscale;
  const int* seed;
  float* x_re;  // (ns, B) scratch field
  float* x_im;
  uint32_t* frame;  // (B, 1024) scratch: each stream's distinct frame samples, bf16 pairs
  int* det;
  int* coarse;
  int* start;
  float* metric;
  int* offs;
  float* ht_re;  // (53, B)
  float* ht_im;
  float* cfo_true;
  int n_taps;
  int span;
  float nsc;        // per-plane time-domain noise scale
  float cfo_scale;  // cfo_khz * 1e3 / 20e6 (0: no CFO)
};

__device__ void synthesize(const RawGenParams& p, SynthSmem& s, FieldSmem& fs, long long f,
                           bool live, int lane, int g) {
  const long long batch = p.chain.batch;
  const int ns = p.det_cfg.ns;
  gen::stage_ln(s.ln, threadIdx.x, THREADS);
  for (int i = threadIdx.x; i < N_FFT * N_SC; i += THREADS)
    (&s.v[0][0])[i] = make_double2(p.v_re[i], p.v_im[i]);
  for (int i = threadIdx.x; i < chain::N_BLOCKS * N_SC; i += THREADS) {
    const int b = i / N_SC, k = i % N_SC;
    const float* txs_re = static_cast<const float*>(p.chain.txa_re);
    const float* txs_im = static_cast<const float*>(p.chain.txa_im);
    s.txs[b][k] = make_float2(txs_re[k * chain::NB_PAD + b], txs_im[k * chain::NB_PAD + b]);
  }
  for (int k = threadIdx.x; k < N_SC; k += THREADS)
    s.tpre[k] = make_float2(static_cast<const float*>(p.chain.txb_re)[k],
                            static_cast<const float*>(p.chain.txb_im)[k]);
  for (int i = threadIdx.x; i < N_SC * p.n_taps; i += THREADS)
    s.wc[i / p.n_taps][i % p.n_taps] = make_float2(p.wc_re[i], p.wc_im[i]);
  const uint2 key = gen::key_of(*p.seed);
  gen::draw_taps<GROUPS, FRAMES>(key, f, p.n_taps, p.tscale, g, lane, s.taps);
  __syncthreads();

  float2 h[BINS];
  gen::channel_bins<BINS, GROUPS, N_SC, FRAMES>(p.n_taps, s.taps, s.wc, g, lane, h);
  if (live) {
#pragma unroll
    for (int j = 0; j < BINS; ++j) {
      const int k = g + GROUPS * j;
      if (k < N_SC) {
        p.ht_re[k * batch + f] = h[j].x;
        p.ht_im[k * batch + f] = h[j].y;
      }
    }
  }

  const uint4 wo = gen::draw(key, f, 0, gen::OFFSET);
  const int off = MIN_OFFSET + static_cast<int>((wo.x & 0x7FFFFFFFu) % static_cast<uint32_t>(p.span));
  const bool cfo = p.cfo_scale != 0.f;
  const float eps =
      cfo ? __fmul_rn(__fsub_rn(__fmul_rn(2.f, gen::uniform(wo.y)), 1.f), p.cfo_scale) : 0.f;
  if (live && g == 0) {
    p.offs[f] = off;
    p.cfo_true[f] = eps;
  }

  auto noise = [&](long long stream, int r) {
    const uint4 w = gen::draw(key, stream, r, gen::NOISE);
    return gen::normal_pair(w.x, w.y, fs.ln);
  };

  // the frame's 1024 distinct samples, one symbol at a time: its spectrum
  // tx_s H (f32) to shared memory, then each thread's 8 consecutive samples
  // by the IDFT in f64, rounded to f32 and to bf16, into the stream's row of
  // the compact scratch (one 32-B sector a thread)
  uint32_t* frame = p.frame + f * N_DISTINCT;
  for (int sym = 0; sym < N_SYMBOLS; ++sym) {
    __syncthreads();  // the previous symbol's spectrum is read
#pragma unroll
    for (int j = 0; j < BINS; ++j) {
      const int k = g + GROUPS * j;
      if (k < N_SC) {
        const float2 c = gen::cmul_rn(sym == 0 ? s.tpre[k] : s.txs[sym - 1][k], h[j]);
        s.x[k][lane] = make_double2(c.x, c.y);
      }
    }
    __syncthreads();
    double ar[PER_THREAD], ai[PER_THREAD];
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) ar[i] = ai[i] = 0.0;
    for (int k = 0; k < N_SC; ++k) {
      const double2 xk = s.x[k][lane];
#pragma unroll
      for (int i = 0; i < PER_THREAD; ++i) {
        const double2 v = s.v[PER_THREAD * g + i][k];
        ar[i] += v.x * xk.x - v.y * xk.y;
        ai[i] += v.x * xk.y + v.y * xk.x;
      }
    }
    if (!live) continue;
    uint32_t w[PER_THREAD];
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) w[i] = bf16_pair(ar[i], ai[i]);
    uint4* dst = reinterpret_cast<uint4*>(frame + sym * N_FFT + PER_THREAD * g);
    dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
    dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
  __syncthreads();  // the compact frames are written and visible to the block; SynthSmem is free
  if (g == 0) {
    fs.off[lane] = off;
    fs.eps[lane] = eps;
  }

  // the field, half the block's streams at a time: the half's compact frames
  // (16 rows of 4 KB, contiguous) to shared memory, then one pass over the
  // rows.  Thread t takes stream t % 16 of the half and the rows r = t / 16
  // (mod 16): a warp covers two rows, each store 64 contiguous bytes of a row
  // in each plane.  Each row's noise is drawn once; a frame row adds its
  // sample, read from shared memory, rotated by the CFO.
  const int lh = threadIdx.x % HALF;
  for (int half = 0; half < 2; ++half) {
    const long long f0 = static_cast<long long>(blockIdx.x) * FRAMES + half * HALF;
    const long long n_live = batch - f0 < HALF ? batch - f0 : HALF;
    const uint4* src = reinterpret_cast<const uint4*>(p.frame + f0 * N_DISTINCT);
    uint4* dst = reinterpret_cast<uint4*>(&fs.frame[0][0]);
    for (int i = threadIdx.x; i < n_live * (N_DISTINCT / 4); i += THREADS) dst[i] = src[i];
    __syncthreads();
    const long long fh = f0 + lh;
    if (fh < batch) {
      const int off_h = fs.off[half * HALF + lh];
      const float eps_h = fs.eps[half * HALF + lh];
      const uint32_t* frame_h = fs.frame[lh];
      for (int r = threadIdx.x / HALF; r < ns; r += THREADS / HALF) {
        const float2 z = noise(fh, r);
        float2 x = make_float2(__fmul_rn(p.nsc, z.x), __fmul_rn(p.nsc, z.y));
        const int rel = r - off_h;
        if (rel >= 0 && rel < detect::FRAME) {
          const uint32_t b = frame_h[frame_sample(rel)];
          float2 v = make_float2(__uint_as_float(b << 16), __uint_as_float(b & 0xFFFF0000u));
          if (cfo) {
            const float ang = __fmul_rn(__fmul_rn(TWO_PI_F, eps_h), static_cast<float>(r));
            double sd, cd;
            sincos(static_cast<double>(ang), &sd, &cd);
            const float sn = static_cast<float>(sd), cs = static_cast<float>(cd);
            v = make_float2(__fsub_rn(__fmul_rn(v.x, cs), __fmul_rn(v.y, sn)),
                            __fadd_rn(__fmul_rn(v.x, sn), __fmul_rn(v.y, cs)));
          }
          x = make_float2(__fadd_rn(v.x, x.x), __fadd_rn(v.y, x.y));
        }
        const long long i = static_cast<long long>(r) * batch + fh;
        p.x_re[i] = x.x;
        p.x_im[i] = x.y;
      }
    }
    __syncthreads();  // the half's frames are read
  }
}

template <bool SYNC>
__global__ void __launch_bounds__(THREADS, 2) raw_gen_kernel(RawGenParams p) {
  extern __shared__ double2 smem_raw[];
  const int lane = threadIdx.x % FRAMES;
  const int g = threadIdx.x / FRAMES;
  const long long f = static_cast<long long>(blockIdx.x) * FRAMES + lane;
  const bool live = f < p.chain.batch;
  synthesize(p, *reinterpret_cast<SynthSmem*>(smem_raw), *reinterpret_cast<FieldSmem*>(smem_raw),
             f, live, lane, g);
  __syncthreads();  // the block's columns of the field are written; shared memory is free
  const detect::Result r = detect::run<float>(
      p.det_cfg, *reinterpret_cast<detect::Smem*>(smem_raw), f, live, lane, g);
  if (live && g == 0) {
    p.det[f] = r.det;
    p.coarse[f] = r.coarse;
    p.start[f] = r.start;
    p.metric[f] = r.metric;
  }
  // detect::run ends on a barrier: the shared memory is the chain's now
  const long long row0 = detect::frame_row(r, p.det_cfg.ns);
  using ChainSmem = chain::SmemFor<gen::Bf16Sample, true>;
  chain::run<gen::Bf16Sample, true, SYNC, true>(p.chain, *reinterpret_cast<ChainSmem*>(smem_raw),
                                                f, live, lane, g, row0, row0 + chain::PREAMBLE);
}

// the shared memory of a block: one union for the synthesis, detection and
// the chain
size_t smem_of(int search, int stride) {
  size_t smem = detect::smem_bytes<float>(search, stride, 1);
  for (const size_t part : {sizeof(chain::SmemFor<gen::Bf16Sample, true>), sizeof(SynthSmem),
                            sizeof(FieldSmem)})
    if (smem < part) smem = part;
  return smem;
}

template <bool SYNC>
cudaError_t launch(const RawGenParams& p, cudaStream_t stream) {
  auto kernel = raw_gen_kernel<SYNC>;
  const size_t smem = smem_of(p.det_cfg.search, p.det_cfg.stride);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((p.chain.batch + FRAMES - 1) / FRAMES);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool SYNC>
cudaError_t attributes(int search, int stride, int* out) {
  return ffi::occupancy(raw_gen_kernel<SYNC>, THREADS, smem_of(search, stride), out);
}

}  // namespace

// ptrs: txs re/im (53, 16), tpre re/im (53, 1), w re/im (64, 53), wi re/im
// (5, 53, 4), LTS taps re/im (64), IDFT re/im (64, 53), wc re/im (53,
// n_taps), tscale (n_taps), seed (int32), the scratch field re/im (ns, B),
// the compact frame scratch (B, 1024) int32, then the chain's outputs (7 h planes re/im, the first five null; eq
// re/im, null; ow2, cfo, chk, evm), then det, coarse, start (int32), metric
// (f32), offsets (int32), h_true re/im (53, B) and cfo_true (B).  Returns
// cudaGetLastError() after the launch.
extern "C" int raw_gen_launch(const void* const* ptrs, int n_ptrs, int batch, int ns, int n_taps,
                              float nsc, float cfo_scale, int eq_sel, double threshold,
                              int search, int advance, int stride, void* stream) {
  constexpr int N_IN = 19;
  const int span = ns - detect::FRAME - MIN_OFFSET;
  if (n_ptrs != N_IN + chain::N_OUT_PTRS + 8 || batch <= 0 || span <= 0 ||
      ns % detect::LAG != 0 || n_taps < 1 || n_taps > gen::MAX_TAPS || search < 1 ||
      stride < 1 || detect::LAG % stride != 0 || eq_sel < chain::EQ_LINEAR ||
      eq_sel > chain::EQ_MMSE)
    return cudaErrorInvalidValue;
  RawGenParams p;
  float* x_re = static_cast<float*>(const_cast<void*>(ptrs[16]));
  float* x_im = static_cast<float*>(const_cast<void*>(ptrs[17]));
  p.det_cfg = detect::Config{x_re, x_im, static_cast<const float*>(ptrs[8]),
                             static_cast<const float*>(ptrs[9]), batch, ns, stride, 1,
                             search, advance, threshold};
  chain::Params& c = p.chain;
  c.rxp_re = c.rxl_re = x_re;
  c.rxp_im = c.rxl_im = x_im;
  c.txa_re = ptrs[0];
  c.txa_im = ptrs[1];
  c.txb_re = ptrs[2];
  c.txb_im = ptrs[3];
  c.w_re = static_cast<const float*>(ptrs[4]);
  c.w_im = static_cast<const float*>(ptrs[5]);
  c.wi_re = static_cast<const float*>(ptrs[6]);
  c.wi_im = static_cast<const float*>(ptrs[7]);
  chain::set_outputs(c, ptrs + N_IN);
  if (c.eq_re != nullptr || c.evm == nullptr) return cudaErrorInvalidValue;
  c.batch = batch;
  c.eq_sel = eq_sel;
  c.scale = 1.f;
  p.v_re = static_cast<const float*>(ptrs[10]);
  p.v_im = static_cast<const float*>(ptrs[11]);
  p.wc_re = static_cast<const float*>(ptrs[12]);
  p.wc_im = static_cast<const float*>(ptrs[13]);
  p.tscale = static_cast<const float*>(ptrs[14]);
  p.seed = static_cast<const int*>(ptrs[15]);
  p.x_re = x_re;
  p.x_im = x_im;
  p.frame = static_cast<uint32_t*>(const_cast<void*>(ptrs[18]));
  const void* const* rows = ptrs + N_IN + chain::N_OUT_PTRS;
  p.det = static_cast<int*>(const_cast<void*>(rows[0]));
  p.coarse = static_cast<int*>(const_cast<void*>(rows[1]));
  p.start = static_cast<int*>(const_cast<void*>(rows[2]));
  p.metric = static_cast<float*>(const_cast<void*>(rows[3]));
  p.offs = static_cast<int*>(const_cast<void*>(rows[4]));
  p.ht_re = static_cast<float*>(const_cast<void*>(rows[5]));
  p.ht_im = static_cast<float*>(const_cast<void*>(rows[6]));
  p.cfo_true = static_cast<float*>(const_cast<void*>(rows[7]));
  p.n_taps = n_taps;
  p.span = span;
  p.nsc = nsc;
  p.cfo_scale = cfo_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return cfo_scale != 0.f ? launch<true>(p, st) : launch<false>(p, st);
}

// The kernel's instantiation without (sync 0) or with a CFO on the current
// card, for the detector's search and stride: out = registers and local
// (spill) bytes a thread, shared bytes a block, resident blocks per SM.
extern "C" int raw_gen_attributes(int sync, int search, int stride, int* out) {
  if (search < 1 || stride < 1 || detect::LAG % stride != 0) return cudaErrorInvalidValue;
  return sync ? attributes<true>(search, stride, out) : attributes<false>(search, stride, out);
}
