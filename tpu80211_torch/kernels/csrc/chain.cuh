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
// (evm_sums): compiled apart, so the plain chain keeps its registers.
// Three kernels run it: fused_chain.cu reads packets and preambles from
// their own (rows, B) buffers (row base 0); raw_chain.cu and
// raw_gen_chain.cu read both from the raw (NS, B) stream at each stream's
// detected start.  Every (rows, B) buffer is
// lane-major with row stride B, so a warp's load of one row is 32
// neighbouring frames when the row bases agree.
//
// Layout of a block: 256 threads = 32 frames (the lane) x 8 bin groups
// (the warp); group g owns bins k = g, g+8, ... (at most 7).  Each 64-sample
// window is staged in shared memory for the block's 32 frames and
// transformed; every thread then reads the spectrum at its own bins.
// Per-frame sums over bins (sigma^2, the MMSE dots, the CFO correlation,
// the CPE, the EVM, the checksum) cross the groups through shared memory.
// A dead lane (frame >= B) computes on zeros and never stores.
//
// The windows, in order: the LTS average, blocks 0..3 (pilot ratios and the
// MMSE dots), then blocks 0..14 (the equalizer).  Blocks 0..3 are
// transformed twice, from the same operands in the same order, so both
// passes see the same spectra bit for bit and no register keeps them.
//
// The DFT.  With bf16 (or int8, exact in bf16) storage the operands are
// bf16, as the TPU kernel feeds its MXU: the twiddles, the samples, the LTS
// average formed in f32, and with sync each block's samples after their
// f32 derotation.  The block multiplies them on the tensor cores (mma.sync
// m16n8k16, bf16 x bf16 exact, f32 sums): Y = W^T X for the 53 bins
// (padded to 64 with zero twiddles) and the block's 32 frames (64 columns
// when a per-frame tx window rides beside the rx one).  As in the TPU
// kernel, yr = Wr^T xr - Wi^T xi and yi = Wr^T xi + Wi^T xr are each two
// separately accumulated K = 64 products, subtracted or added in f32.
// Warp w computes plane w / 4 (re, im) of bins 16 (w % 4) .. +15: 32
// MMAs a warp per 32 columns, operands read with ldmatrix from a
// swizzled bf16 twiddle image and from the staged window, the result
// written to shared memory as f32 Y[plane][bin][column].  With f32
// storage the operands stay f32 and each thread forms its own bins on the
// CUDA cores (dft_bins).
//
// Staging.  Each window goes into one of two buffers while the block
// computes on the other.  In fused_chain.cu every lane's rows share their
// base, and where B is a multiple of 8 and the packet planes are 16-byte
// aligned (the template flag SHARED_ROWS) the block moves each window in
// runs of 8 frames: bf16 samples without sync by cp.async, straight into
// the buffer; int8 samples, and bf16 ones to be derotated, through
// registers (a thread loads its runs before the current window's product,
// and converts, derotates and stores them after the epilogue).  Where the
// rows differ per lane (raw_chain.cu, raw_gen_chain.cu) or B is ragged,
// each thread loads its own rows n = g + 8r of its frame in the same places.
// Staged through registers, a window is stored only after the last product
// that read its buffer, so with sync in runs every window uses buffer 0 and
// buffer 1 holds the derotation's phase factors.
// scale = (1+eps)*lsb multiplies the rx preamble before the CFO estimate
// and the rx block spectra after the DFT; the tx side is scaled only in
// per-frame-tx mode and is never derotated.
//
// The derotated samples agree bit for bit with the plain PyTorch version's,
// so that their bf16 rounding does too: the Moose correlation is summed in
// f64 (products of f32 values are exact there) and the CFO is
// atan2/(2pi*64) in f64 rounded to f32; the angle is ang = (w = (-2pi)*cfo)*t
// in f32 (t = 32..159 on the preamble, t = 160 + 80b + 16 + n in block b);
// cos and sin are the library's f64 sincos(ang) rounded to f32 (correctly
// rounded on both sides); and the rotation's products and sums are rounded
// one by one (no FMA contraction).  Where the windows move in runs of 8
// frames (SHARED_ROWS) the library is called for a few phase factors a
// frame, not for each sample (Phases, cis): e^{i w t} is a product of two
// f64 factors (angle addition), turned by the f32 angle's rounding error,
// and a guard hands the rare value that lies too near an f32 rounding
// midpoint to the library itself, so every cos and sin is the library's bit
// for bit.  Rows of each lane's own frame (raw_chain.cu, raw_gen_chain.cu,
// f32 samples, a ragged B) call the library for each sample (derotate):
// there the guard's out-of-line pass costs more registers than it saves.

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
constexpr int ROWS = N_FFT / GROUPS;                 // window rows a thread stages
constexpr int N_WINDOWS = N_AVG + N_BLOCKS;          // packet windows: blocks 0..3, then 0..14
constexpr int BIN_TILE = 16;                         // bins of a warp's product tile
constexpr int Y_BINS = 56;                           // rows of Y kept: bins 0..52 and padding

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

// tx-constant block and preamble spectra (tx-constant mode only)
struct TxSpectra {
  float2 txs[N_BLOCKS][N_SC];
  float2 tpre[N_SC];
};
struct NoTxSpectra {};

// What every layout holds: interpolators, tx spectra, and the sums across
// bin groups.
template <bool TX_CONST>
struct SmemCommon {
  float2 wi[N_KINDS][N_SC][N_PILOTS];    // interpolator weights
  typename std::conditional<TX_CONST, TxSpectra, NoTxSpectra>::type tx;
  float2 hp[N_AVG][N_PILOTS][FRAMES];    // pilot ratios
  float2 cpe[2][N_PILOTS][FRAMES];       // pilot CPE terms, double-buffered
  float red[GROUPS][3 * N_AVG][FRAMES];  // partial sums across bin groups
  float cfo[FRAMES];                     // each frame's CFO estimate (sync)
};

// The derotation's phase factors (sync), in f64, for each frame's w: sample
// t = T + 8j + r of the window staged next (T its first row) turns by
// e^{i w t} = x[j] y[r]; step = e^{i w 80} carries x from one block's
// window to the next.  Frame f's x[j] sits at column f + f / 8 and its y[r]
// at 8f + (r + f + 2 (f / 8)) % 8, so that each quarter warp's 16-byte reads
// (the runs' 2 rows by 4 frames, or 8 frames) fall on distinct banks.
struct Phases {
  double2 x[GROUPS][FRAMES + FRAMES / GROUPS];
  double2 y[FRAMES * GROUPS];
  double2 step[FRAMES];
};

__device__ __forceinline__ int x_col(int f) { return f + f / GROUPS; }
__device__ __forceinline__ int y_at(int f, int r) {
  return GROUPS * f + (r + f + 2 * (f / GROUPS)) % GROUPS;
}

template <bool MMA, bool TX_CONST>
struct Smem;

// f32 operands, the CUDA-core DFT: f32 twiddles and one f32 window
template <bool TX_CONST>
struct Smem<false, TX_CONST> : SmemCommon<TX_CONST> {
  float2 w[N_FFT][N_SC];                 // twiddles
  float2 xr[N_FFT][FRAMES];              // staged rx window
  float2 xt[N_FFT][FRAMES];              // staged tx window (per-frame tx)
  double cred[GROUPS][2][FRAMES];        // Moose correlation partial sums
};

// bf16 operands, the tensor-core DFT.  Rows are padded by 16 bytes so that
// the 8 rows an ldmatrix reads, and the 4 rows a half-warp's stores of Y
// write, fall on distinct banks.
template <bool TX_CONST>
struct Smem<true, TX_CONST> : SmemCommon<TX_CONST> {
  static constexpr int COLS = TX_CONST ? FRAMES : 2 * FRAMES;  // rx, then tx
  static constexpr int WROW = COLS + 8;  // bf16 per window row
  static constexpr int YROW = COLS + 8;  // f32 per row of Y
  // W^T as bf16, [plane][bin][sample], bins 53..63 zero; the 16-byte chunk c
  // of bin m's row sits at c ^ (m & 7)
  alignas(16) __nv_bfloat16 tw[2][N_FFT][N_FFT];
  alignas(16) __nv_bfloat16 win[2][2][N_FFT][WROW];  // [buffer][plane][sample][column]
  union {
    float y[2][Y_BINS][YROW];            // the spectra, [plane][bin][column]
    double cred[GROUPS][2][FRAMES];      // Moose partial sums, before the first product
  };
  // with sync and runs every window is staged in buffer 0 (through
  // registers, after the last product that read the buffer), and buffer 1
  // holds the phases
  static_assert(sizeof(Phases) <= sizeof(win[1]), "the phases fit the second window buffer");
  __device__ Phases& phases() { return *reinterpret_cast<Phases*>(&win[1][0][0][0]); }
};

// the layout that run<T, TX_CONST, ...> takes
template <typename T, bool TX_CONST>
using SmemFor = Smem<!std::is_same<T, float>::value, TX_CONST>;

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

// -- the derotation (sync) ----------------------------------------------------

// v * exp(-2pi i cfo t): the f32 angle's cos and sin correctly rounded to
// f32 by the library, the rotation rounded as separate f32 products and sums
// (the staging of rows n = g + 8r, where the guard's rare pass costs more
// registers than the phases save)
__device__ __forceinline__ float2 derotate(float2 v, float cfo, int t) {
  const float ang = __fmul_rn(__fmul_rn(NEG_TWO_PI, cfo), static_cast<float>(t));
  double sd, cd;
  sincos(static_cast<double>(ang), &sd, &cd);
  const float sn = static_cast<float>(sd), cs = static_cast<float>(cd);
  return make_float2(__fsub_rn(__fmul_rn(v.x, cs), __fmul_rn(v.y, sn)),
                     __fadd_rn(__fmul_rn(v.x, sn), __fmul_rn(v.y, cs)));
}

// (cos, sin) of the f32 angle: the library's f64 sincos, each rounded to f32.
// Called only where the guard cannot tell, so kept out of line: the
// library's code (its slow path for large angles too) stays out of the
// loops' instruction stream.
__device__ __noinline__ float2 library_cis(float ang) {
  double sd, cd;
  sincos(static_cast<double>(ang), &sd, &cd);
  const float sn = static_cast<float>(sd), cs = static_cast<float>(cd);
  return make_float2(cs, sn);
}

// e^{i x} from the library's f64 sincos, for a phase factor (x exact: an
// f32 w times an integer of at most 11 bits); out of line as library_cis
__device__ __noinline__ double2 factor(double x) {
  double2 e;
  sincos(x, &e.y, &e.x);
  return e;
}

__device__ __forceinline__ double2 cmul64(double2 a, double2 b) {
  return make_double2(fma(a.x, b.x, -(a.y * b.y)), fma(a.y, b.x, a.x * b.y));
}

// The guard.  K bounds |(c, s) - library sincos(ang)| in units of 2^-53 m,
// m = 1 for cos and min(1, |ang|) for sin (every sub-angle has w's sign,
// so the sines' errors stay relative):
//  - each library value is within 2 ulp (CUDA's bound), 4 units;
//  - a factor after k <= 3 steps by `step` (a library value) is within
//    (4 + 6k) sqrt(2) units, the product with y adds 4 sqrt(2) + 2 sqrt(2)
//    for its roundings: <= 40 units at k = 3;
//  - the turn by the angle's rounding error d (|d| <= 2^-18, |ang| < 68)
//    rounds once more and drops d^3/6, under 1.2 units;
//  - the reference, the library's own sincos(ang), 4 more.
// That is under 46, and K = 64.  A value x passes if every value within
// 2 K units of it rounds to x's f32 (twice K for the tests' own
// roundings).  In x's own ulps, 2^(ex - 1075) for the biased exponent ex,
// 2 K 2^-53 m is at most 2 K << (em - ex) when m <= 2^(em - 1022); so x
// passes when em - ex is 0..20 and its low 29 bits (those that f32 drops)
// lie further than that from the rounding midpoint 2^28 (the exact test).
// The samples' loop takes a cheaper test first: x at least 2^(em - 1032)
// in size (so em - ex <= 10) and its low bits further than 2 K << 10 from
// the midpoint; the few in a thousand that it cannot vouch for take the
// exact test, and the few in a million that fail that are the library's.
constexpr uint32_t GUARD_2K = 128;
constexpr uint32_t GUARD_CHEAP = GUARD_2K << 10;
constexpr uint32_t GUARD_MID = 1u << 28, GUARD_LOW = (1u << 29) - 1;
constexpr uint32_t GUARD_SHIFTS = 20;
constexpr uint32_t COS_EM = 1022;        // m = 1 = 2^(1022 - 1022)
constexpr uint32_t F32_TO_F64_EXP = 896;  // the f32 exponent bias 127 to f64's 1023
constexpr float SMALL_ANGLE = 0x1p-13f;  // cos rounds to 1 and sin to the angle below it

// the cheap test: |xf| >= floor (floor >= 2^(em - 1032)), and x's low bits
// further than 2 K << 10 from the midpoint
__device__ __forceinline__ bool far_from_midpoint(double x, float xf, float floor) {
  const uint32_t low = (static_cast<uint32_t>(__double2loint(x)) + GUARD_CHEAP - GUARD_MID) &
                       GUARD_LOW;
  return fabsf(xf) >= floor && low > 2u * GUARD_CHEAP;
}

// the exact test
__device__ __forceinline__ bool clear_of_midpoint(double x, uint32_t em) {
  const uint32_t ex = (static_cast<uint32_t>(__double2hiint(x)) >> 20) & 0x7ffu;
  const uint32_t shift = em - ex;  // wraps to large where |x| exceeds 2^(em - 1022)
  const uint32_t ulps = GUARD_2K << (shift & 31u);
  const uint32_t low = (static_cast<uint32_t>(__double2loint(x)) + ulps - GUARD_MID) & GUARD_LOW;
  return shift <= GUARD_SHIFTS && low > 2u * ulps;
}

// cos and sin of ang = fl(w tf) in f64 from e = e^{i w tf} (the exact
// angle): e turned by d = ang - w tf (exact in f32), to second order in d
__device__ __forceinline__ double2 turn(float w, float tf, float ang, double2 e) {
  const double a = __fmaf_rn(w, tf, -ang);  // -d
  const double ah = 0.5 * a;
  return make_double2(fma(a, fma(-ah, e.x, e.y), e.x), fma(-a, fma(ah, e.y, e.x), e.y));
}

// the sine's m, min(1, |ang|) with room
__device__ __forceinline__ float sine_scale(float ang) { return fminf(fabsf(ang) * 1.0001f, 1.f); }

// (cos, sin) of ang = fl(w tf) rounded to f32, equal to library_cis(ang) bit
// for bit where `sure` stays set, from e = e^{i w tf}; where the cheap test
// cannot vouch for them it clears `sure`, and the caller asks `vouched`
// (and for the few that fails, library_cis) out of its loop.
__device__ __forceinline__ float2 cis(float w, float tf, double2 e, bool& sure) {
  const float ang = __fmul_rn(w, tf);
  const double2 cs = turn(w, tf, ang, e);
  float2 r = make_float2(static_cast<float>(cs.x), static_cast<float>(cs.y));
  // floors 2^-10 (cos: em = 1022) and m 2^-9 (sin: m >= 2^(em - 1023))
  if (fabsf(ang) < SMALL_ANGLE)
    r = make_float2(1.f, ang);
  else if (!(far_from_midpoint(cs.x, r.x, 0x1p-10f) &&
             far_from_midpoint(cs.y, r.y, sine_scale(ang) * 0x1p-9f)))
    sure = false;
  return r;
}

// whether cis's values for ang = fl(w tf) are the library's, by the exact test
__device__ __forceinline__ bool vouched(float w, float tf, double2 e) {
  const float ang = __fmul_rn(w, tf);
  if (fabsf(ang) < SMALL_ANGLE) return true;
  const double2 cs = turn(w, tf, ang, e);
  const uint32_t sine_em = (__float_as_uint(sine_scale(ang)) >> 23) + F32_TO_F64_EXP;
  return clear_of_midpoint(cs.x, COS_EM) && clear_of_midpoint(cs.y, sine_em);
}

// v * (cos, sin), rounded as separate f32 products and sums
__device__ __forceinline__ float2 rotate(float2 v, float2 cs) {
  return make_float2(__fsub_rn(__fmul_rn(v.x, cs.x), __fmul_rn(v.y, cs.y)),
                     __fadd_rn(__fmul_rn(v.x, cs.y), __fmul_rn(v.y, cs.x)));
}

// sample k of a run of 8 bf16 (uint4) or int8 (uint2) samples, as f32
template <typename T, typename Run>
__device__ __forceinline__ float run_element(const Run& v, int k) {
  const uint32_t w = (&v.x)[k * sizeof(T) / 4];
  if constexpr (sizeof(T) == 1) return static_cast<float>(static_cast<int8_t>(w >> (8 * (k % 4))));
  return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(w >> (16 * (k % 2)))));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// -- the tensor cores' operands and products (PTX, sm_80 and later) ----------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 bf16 matrices; thread t gives the address of row t % 8 of matrix t / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16, row-major) . b (16x8, column-major), bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from device memory into shared memory, the bytes past
// ``src_bytes`` zero-filled (none read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Y[plane][bin][col0 + 0..31] = W^T X for the window x ([plane][sample][WROW]
// bf16): warp ``warp`` computes plane warp / 4 of bins 16 (warp % 4) .. +15,
// as two K = 64 products (Wr^T x_p and Wi^T x_(1-p)) accumulated apart and
// then subtracted (re) or added (im).
template <int WROW, int YROW>
__device__ __forceinline__ void mma_dft(const __nv_bfloat16 (*tw)[N_FFT][N_FFT],
                                        const __nv_bfloat16* x, float* y, int col0, int warp,
                                        int lane) {
  const int plane = warp >> 2;
  const int m0 = BIN_TILE * (warp & 3);
  const int sub = (lane >> 3) & 1;  // ldmatrix: rows 8..15 of the tile
  const int hi = lane >> 4;         // ldmatrix: the second k chunk, or the second n tile
  float acc1[4][4], acc2[4][4];     // [n tile][fragment]: Wr^T x_p, Wi^T x_(1-p)
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc1[nt][e] = acc2[nt][e] = 0.f;
  const int m = m0 + 8 * sub + (lane & 7);
  const __nv_bfloat16* xa = x + plane * (N_FFT * WROW);        // x_p
  const __nv_bfloat16* xb = x + (1 - plane) * (N_FFT * WROW);  // x_(1-p)
#pragma unroll
  for (int kk = 0; kk < N_FFT / 16; ++kk) {
    uint32_t wr[4], wi[4];
    const int chunk = (2 * kk + hi) ^ (m & 7);
    ldsm_x4(wr, &tw[0][m][8 * chunk]);
    ldsm_x4(wi, &tw[1][m][8 * chunk]);
    const int k = 16 * kk + 8 * sub + (lane & 7);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      const int n = col0 + 8 * (2 * np + hi);
      uint32_t ba[4], bb[4];
      ldsm_x4_trans(ba, xa + k * WROW + n);
      ldsm_x4_trans(bb, xb + k * WROW + n);
      mma_bf16(acc1[2 * np], wr, ba[0], ba[1]);
      mma_bf16(acc1[2 * np + 1], wr, ba[2], ba[3]);
      mma_bf16(acc2[2 * np], wi, bb[0], bb[1]);
      mma_bf16(acc2[2 * np + 1], wi, bb[2], bb[3]);
    }
  }
  const int r = m0 + (lane >> 2);
  float* yp = y + plane * (Y_BINS * YROW);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = col0 + 8 * nt + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (r + 8 * h >= Y_BINS) continue;
      const float a0 = acc1[nt][2 * h], a1 = acc1[nt][2 * h + 1];
      const float b0 = acc2[nt][2 * h], b1 = acc2[nt][2 * h + 1];
      *reinterpret_cast<float2*>(yp + (r + 8 * h) * YROW + c) =
          plane ? make_float2(a0 + b0, a1 + b1) : make_float2(a0 - b0, a1 - b1);
    }
  }
}

// y[j] = sum_n W[n][g + 8j] * x[n] for this thread's bins, on the CUDA cores
// (f32 operands).  Four real accumulators, as the TPU kernel's four real
// products: yr = Wr.xr - Wi.xi, yi = Wr.xi + Wi.xr.
template <bool TX_CONST>
__device__ __forceinline__ void dft_bins(const float2* x, const Smem<false, TX_CONST>& s, int g,
                                         int lane, float out_scale, float2 (&y)[BINS]) {
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

// With sync, thread t's run of 8 frames (as load_runs reads it: sample k at
// xr/xi[k], none if null) at time tf, just staged in buffer 0 (`win`,
// [plane][sample][WROW]): the samples whose cos or sin the cheap test could
// not vouch for (bits of `unsure`; a few in a thousand) take the exact
// test, and those it fails too (a few in a million) are staged again with
// the library's cos and sin, loaded anew, turned and rounded to bf16.  Out
// of line, with plain arguments, so that the staging loop keeps its
// registers.
template <typename T, int WROW>
__device__ __noinline__ void restage_run(unsigned unsure, float tf, const T* xr, const T* xi,
                                         const float* cfo, const Phases* ph, __nv_bfloat16* win) {
  const int run_row = threadIdx.x / 4, run_col = 8 * (threadIdx.x % 4);
  for (; unsure; unsure &= unsure - 1) {
    const int k = __ffs(unsure) - 1;
    const float w = __fmul_rn(NEG_TWO_PI, cfo[run_col + k]);
    if (vouched(w, tf, cmul64(ph->x[run_row / GROUPS][x_col(run_col + k)],
                              ph->y[y_at(run_col + k, run_row % GROUPS)])))
      continue;
    const float2 x = xr ? make_float2(to_f32(xr[k]), to_f32(xi[k])) : make_float2(0.f, 0.f);
    const float2 v = rotate(x, library_cis(__fmul_rn(w, tf)));
    win[run_row * WROW + run_col + k] = __float2bfloat16_rn(v.x);
    win[(N_FFT + run_row) * WROW + run_col + k] = __float2bfloat16_rn(v.y);
  }
}

// The whole chain for frame f (column f of every buffer) in lane ``lane``
// of group ``g``.  lp_base, pkt_base: this lane's first row of the rx
// preamble and packet.  EVM needs p.evm.  SHARED_ROWS (bf16 or int8
// samples): every lane's rows share their base, B is a multiple of 8, and
// the rx (and per-frame tx) packet planes are 16-byte aligned, so the
// windows move in runs of 8 frames.  Every thread of the block calls it (it
// holds __syncthreads); a dead lane passes live = false.
template <typename T, bool TX_CONST, bool SYNC, bool EVM, bool SHARED_ROWS = false>
__device__ void run(const Params& p, SmemFor<T, TX_CONST>& s, long long f, bool live, int lane,
                    int g, long long lp_base, long long pkt_base) {
  constexpr bool BF16_OPS = !std::is_same<T, float>::value;
  constexpr bool MMA = BF16_OPS;
  static_assert(!SHARED_ROWS || std::is_same<T, __nv_bfloat16>::value ||
                    std::is_same<T, int8_t>::value,
                "runs of 8 bf16 or int8 samples");
  // bf16 rows copied as they are: cp.async; else through registers
  constexpr bool ASYNC = SHARED_ROWS && std::is_same<T, __nv_bfloat16>::value && !SYNC;
  constexpr bool RUN_REGS = SHARED_ROWS && !ASYNC;
  // the derotation by phase factors (runs of 8 frames); rows of each lane's
  // own frame take the library's sincos a sample
  constexpr bool PHASES = SYNC && RUN_REGS;
  using EqT = typename std::conditional<BF16_OPS, __nv_bfloat16, float>::type;
  const long long batch = p.batch;
  // per-frame tx with CPE or EVM needs the tx spectra of every block
  constexpr bool tx_all = !TX_CONST && (SYNC || EVM);
  // window i < N_AVG is block i of the estimators' pass, then blocks 0..14
  auto block_of = [](int i) { return i < N_AVG ? i : i - N_AVG; };
  auto with_tx = [](int i) { return !TX_CONST && (i < N_AVG || tx_all); };
  // the buffer of window i (-1: the preamble): a ring of two, but with the
  // phases every window goes to buffer 0 and buffer 1 holds them
  auto buf = [](int i) { return PHASES ? 0 : i < 0 ? 1 : i & 1; };

  // -- the block's first window on its way (ASYNC) ------------------------------
  auto issue = [&](int i) {  // cp.async of window i into buffer i & 1
    if constexpr (ASYNC) {
      const long long row0 = block_of(i) * SAMP_PER_BLOCK + N_CP;
      const long long f0 = f - lane;  // the block's first frame
      const int n_copies = (with_tx(i) ? 2 : 1) * 2 * N_FFT * (FRAMES / 8);
      for (int c = threadIdx.x; c < n_copies; c += THREADS) {
        const int side = c / (2 * N_FFT * (FRAMES / 8));  // 0 rx, 1 tx
        const int plane = (c / (N_FFT * (FRAMES / 8))) & 1;
        const int n = (c / (FRAMES / 8)) % N_FFT;
        const int part = c % (FRAMES / 8);
        const void* base = side ? (plane ? p.txa_im : p.txa_re) : (plane ? p.rxp_im : p.rxp_re);
        const long long fc = f0 + 8 * part;
        const int bytes = fc < batch ? 16 : 0;  // B is a multiple of 8: all 8 frames or none
        const long long row = (side ? 0 : pkt_base) + row0 + n;
        const __nv_bfloat16* src =
            static_cast<const __nv_bfloat16*>(base) + (bytes ? row * batch + fc : 0);
        cp_async16(&s.win[buf(i)][plane][n][FRAMES * side + 8 * part], src, bytes);
      }
      cp_async_commit();
    }
  };
  issue(0);

  // -- constants ------------------------------------------------------------
  if constexpr (MMA) {
    for (int i = threadIdx.x; i < 2 * N_FFT * N_FFT; i += THREADS) {
      const int plane = i / (N_FFT * N_FFT), n = (i / N_FFT) % N_FFT, m = i % N_FFT;
      const float w = m < N_SC ? (plane ? p.w_im : p.w_re)[n * N_SC + m] : 0.f;
      s.tw[plane][m][8 * ((n >> 3) ^ (m & 7)) + (n & 7)] = __float2bfloat16_rn(w);
    }
  } else {
    for (int i = threadIdx.x; i < N_FFT * N_SC; i += THREADS)
      (&s.w[0][0])[i] = make_float2(p.w_re[i], p.w_im[i]);
  }
  for (int i = threadIdx.x; i < N_KINDS * N_SC * N_PILOTS; i += THREADS)
    (&s.wi[0][0][0])[i] = make_float2(p.wi_re[i], p.wi_im[i]);
  if constexpr (TX_CONST) {
    const float* txs_re = static_cast<const float*>(p.txa_re);
    const float* txs_im = static_cast<const float*>(p.txa_im);
    for (int i = threadIdx.x; i < N_BLOCKS * N_SC; i += THREADS) {
      const int b = i / N_SC, k = i % N_SC;
      s.tx.txs[b][k] = make_float2(txs_re[k * NB_PAD + b], txs_im[k * NB_PAD + b]);
    }
    for (int k = threadIdx.x; k < N_SC; k += THREADS)
      s.tx.tpre[k] = make_float2(static_cast<const float*>(p.txb_re)[k],
                                 static_cast<const float*>(p.txb_im)[k]);
  }

  // a sample of window column ``col`` (0..31 rx, 32..63 tx) at row n of
  // buffer ``buf``, rounded to the operand type
  auto put = [&](int buf, int col, int n, float2 v) {
    if constexpr (MMA) {
      s.win[buf][0][n][col] = __float2bfloat16_rn(v.x);
      s.win[buf][1][n][col] = __float2bfloat16_rn(v.y);
    } else {
      (col < FRAMES ? s.xr : s.xt)[n][col % FRAMES] = v;
    }
  };

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
  double2 lts_turn = make_double2(1.0, 0.0);
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
    if (g == 0) s.cfo[lane] = cfo;
  }
  if constexpr (PHASES) {
    // this lane's phase factors: y[g], x[g] of the first LTS repeat, the
    // step (g = 0), and e^{i w 64}, which turns the first repeat's phases
    // into the second's
    Phases& ph = s.phases();
    const double wd = __fmul_rn(NEG_TWO_PI, cfo);
    ph.y[y_at(lane, g)] = g ? factor(wd * g) : make_double2(1.0, 0.0);
    if (g == 0) ph.step[lane] = factor(wd * SAMP_PER_BLOCK);
    ph.x[g][x_col(lane)] = factor(wd * (LTS0 + GROUPS * g));
    lts_turn = factor(wd * (LTS1 - LTS0));
    __syncthreads();
  }

  // -- preamble: derotate, average the LTS repeats, sigma^2; its window is
  //    the preamble's buffer ----------------------------------------------------
  {
    float ow2_part = 0.f;
    const float w = __fmul_rn(NEG_TWO_PI, cfo);
    for (int n = g; n < N_FFT; n += GROUPS) {
      float2 a, b;
      lts_pair(n, a, b);
      if constexpr (PHASES) {
        const Phases& ph = s.phases();
        const double2 e = cmul64(ph.x[n / GROUPS][x_col(lane)], ph.y[y_at(lane, g)]);
        const float t0 = LTS0 + n, t1 = LTS1 + n;
        bool sure = true;
        float2 ca = cis(w, t0, e, sure), cb = cis(w, t1, cmul64(e, lts_turn), sure);
        if (!sure && !(vouched(w, t0, e) && vouched(w, t1, cmul64(e, lts_turn)))) {
          ca = library_cis(__fmul_rn(w, t0));
          cb = library_cis(__fmul_rn(w, t1));
        }
        a = rotate(a, ca);
        b = rotate(b, cb);
      } else if constexpr (SYNC) {
        a = derotate(a, cfo, LTS0 + n);
        b = derotate(b, cfo, LTS1 + n);
      }
      const float dr = a.x - b.x, di = a.y - b.y;
      ow2_part += dr * dr + di * di;
      put(buf(-1), lane, n,
          make_float2(op<BF16_OPS>((a.x + b.x) * 0.5f), op<BF16_OPS>((a.y + b.y) * 0.5f)));
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
        put(buf(-1), FRAMES + lane, n,
            make_float2(op<BF16_OPS>((cr + dr2) * 0.5f), op<BF16_OPS>((ci + di2) * 0.5f)));
      }
    }
    s.red[g][0][lane] = ow2_part;
  }

  // -- the packet windows through registers: loaded (load), then converted,
  //    derotated, rounded and stored (put_window).  RUN_REGS: thread t takes
  //    row t / 4 of both planes, frames 8 (t % 4) .. +7 (a run of 8 samples:
  //    16 bytes of bf16, 8 of int8), and the tx window's.  Otherwise its
  //    rows n = g + 8r of its own frame. ---------------------------------------
  static_assert(THREADS == N_FFT * FRAMES / 8, "one run of each plane a thread");
  using Run = typename std::conditional<sizeof(T) == 1, uint2, uint4>::type;
  const int run_row = threadIdx.x / 4, run_col = 8 * (threadIdx.x % 4);
  Run vq[2], vqt[TX_CONST ? 1 : 2];
  auto load_runs = [&](int i) {
    if constexpr (RUN_REGS) {
      const long long row = block_of(i) * SAMP_PER_BLOCK + N_CP + run_row;
      const long long fc = f - lane + run_col;
      auto one = [&](const void* plane, long long r) {  // B is a multiple of 8: all or none
        const T* src = static_cast<const T*>(plane) + r * batch + fc;
        return fc < batch ? *reinterpret_cast<const Run*>(src) : Run{};
      };
      vq[0] = one(p.rxp_re, pkt_base + row);
      vq[1] = one(p.rxp_im, pkt_base + row);
      if constexpr (!TX_CONST) {
        if (with_tx(i)) {
          vqt[0] = one(p.txa_re, row);
          vqt[1] = one(p.txa_im, row);
        }
      }
    }
  };
  auto put_runs = [&](int i) {
    if constexpr (RUN_REGS) {
      const int row = block_of(i) * SAMP_PER_BLOCK + N_CP + run_row;
      const float tf = PREAMBLE + row;
      const long long fc = f - lane + run_col;  // the run's first frame
      // (cos, sin) at sample k; bit k of `unsure` set where cis was not sure
      auto run_cis = [&](int k, unsigned& unsure) {
        const Phases& ph = s.phases();
        bool sure = true;
        const float2 cs = cis(__fmul_rn(NEG_TWO_PI, s.cfo[run_col + k]), tf,
                              cmul64(ph.x[run_row / GROUPS][x_col(run_col + k)],
                                     ph.y[y_at(run_col + k, run_row % GROUPS)]), sure);
        if (!sure) unsure |= 1u << k;
        return cs;
      };
      auto put8 = [&](const Run (&v)[2], int col, bool derot) {
        uint32_t wr[4], wi[4];
        unsigned unsure = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float2 a = make_float2(run_element<T>(v[0], 2 * k), run_element<T>(v[1], 2 * k));
          float2 b = make_float2(run_element<T>(v[0], 2 * k + 1), run_element<T>(v[1], 2 * k + 1));
          if (SYNC && derot) {
            a = rotate(a, run_cis(2 * k, unsure));
            b = rotate(b, run_cis(2 * k + 1, unsure));
          }
          wr[k] = pack_bf16(a.x, b.x);
          wi[k] = pack_bf16(a.y, b.y);
        }
        __nv_bfloat16* re = &s.win[buf(i)][0][run_row][col + run_col];
        __nv_bfloat16* im = re + N_FFT * Smem<true, TX_CONST>::WROW;
        *reinterpret_cast<uint4*>(re) = make_uint4(wr[0], wr[1], wr[2], wr[3]);
        *reinterpret_cast<uint4*>(im) = make_uint4(wi[0], wi[1], wi[2], wi[3]);
        if (unsure) {  // B is a multiple of 8: the run is all loaded or none
          const long long at = (pkt_base + row) * batch + fc;
          const bool loaded = fc < batch;
          restage_run<T, Smem<true, TX_CONST>::WROW>(
              unsure, tf, loaded ? static_cast<const T*>(p.rxp_re) + at : nullptr,
              loaded ? static_cast<const T*>(p.rxp_im) + at : nullptr, s.cfo, &s.phases(),
              &s.win[0][0][0][0]);
        }
      };
      put8(vq, 0, true);
      if constexpr (!TX_CONST) {
        if (with_tx(i)) put8(vqt, FRAMES, false);  // the tx side is never derotated
      }
    }
  };
  float2 vr[ROWS], vt[TX_CONST ? 1 : ROWS];
  auto load_rows = [&](int i) {
    const long long row0 = block_of(i) * SAMP_PER_BLOCK + N_CP;
    const T* pr = static_cast<const T*>(p.rxp_re);
    const T* pi = static_cast<const T*>(p.rxp_im);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      vr[r] = make_float2(0.f, 0.f);
      if (live) {
        const long long idx = (pkt_base + row0 + g + GROUPS * r) * batch + f;
        vr[r] = make_float2(to_f32(pr[idx]), to_f32(pi[idx]));
      }
    }
    if constexpr (!TX_CONST) {
      if (with_tx(i)) {
        const T* tr = static_cast<const T*>(p.txa_re);
        const T* ti = static_cast<const T*>(p.txa_im);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          vt[r] = make_float2(0.f, 0.f);
          if (live) {
            const long long idx = (row0 + g + GROUPS * r) * batch + f;
            vt[r] = make_float2(to_f32(tr[idx]), to_f32(ti[idx]));
          }
        }
      }
    }
  };
  auto put_rows = [&](int i) {
    const int t0 = PREAMBLE + block_of(i) * SAMP_PER_BLOCK + N_CP;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int n = g + GROUPS * r;
      float2 v = vr[r];
      if constexpr (SYNC) v = derotate(v, cfo, t0 + n);
      put(buf(i), lane, n, make_float2(op<BF16_OPS>(v.x), op<BF16_OPS>(v.y)));
      if constexpr (!TX_CONST) {
        if (with_tx(i))
          put(buf(i), FRAMES + lane, n, make_float2(op<BF16_OPS>(vt[r].x), op<BF16_OPS>(vt[r].y)));
      }
    }
  };
  // this thread's x (frame lane, j = g) for window i's rows (phases): from
  // the library in every fourth window, else one step of 80 samples on from
  // the window before (window 4, block 0 again, is a fourth)
  auto advance = [&](int i) {
    if constexpr (PHASES) {
      Phases& ph = s.phases();
      double2& x = ph.x[g][x_col(lane)];
      if (i % 4 == 0)
        x = factor(static_cast<double>(__fmul_rn(NEG_TWO_PI, cfo)) *
                   (PREAMBLE + block_of(i) * SAMP_PER_BLOCK + N_CP + GROUPS * g));
      else
        x = cmul64(x, ph.step[lane]);
    }
  };
  auto load = [&](int i) {
    if constexpr (RUN_REGS) load_runs(i); else load_rows(i);
  };
  auto put_window = [&](int i) {
    if constexpr (RUN_REGS) put_runs(i); else put_rows(i);
  };

  // Window i (-1: the preamble) up to its spectra in shared memory: the
  // window staged and visible, the next one on its way, the product formed.
  auto transform = [&](int i) {
    if constexpr (MMA) {
      if constexpr (ASYNC) {
        if (i >= 0) cp_async_wait_all();
      }
      __syncthreads();  // window i staged; every reader of the other buffer and of Y done
      if (i + 1 < N_WINDOWS) {
        if constexpr (ASYNC) {
          if (i >= 0) issue(i + 1);
        } else {
          load(i + 1);
        }
      }
      const __nv_bfloat16* x = &s.win[buf(i)][0][0][0];
      using S = Smem<true, TX_CONST>;
      mma_dft<S::WROW, S::YROW>(s.tw, x, &s.y[0][0][0], 0, g, lane);
      if (i < 0 ? !TX_CONST : with_tx(i))
        mma_dft<S::WROW, S::YROW>(s.tw, x, &s.y[0][0][0], FRAMES, g, lane);
      if (i + 1 < N_WINDOWS) advance(i + 1);
      __syncthreads();  // Y written (and the phases of window i + 1)
    } else {
      if (i >= 0) advance(i);
      __syncthreads();  // the preamble staged, or every reader of the last window done
      if (i >= 0) {
        load(i);
        put_window(i);
        __syncthreads();
      }
    }
  };
  // after window i's epilogue: window i + 1 into its buffer (the product
  // that last read that buffer ended before window i's epilogue)
  auto finish = [&](int i) {
    if constexpr (MMA && !ASYNC) {
      if (i + 1 < N_WINDOWS) put_window(i + 1);
    }
  };
  // this thread's bins of the rx (col 0) or tx (col 32) spectrum of the
  // window just transformed, times out_scale
  auto spectrum = [&](int col, float out_scale, float2 (&y)[BINS]) {
    if constexpr (MMA) {
#pragma unroll
      for (int j = 0; j < BINS; ++j) {
        const int k = g + GROUPS * j;
        y[j] = make_float2(0.f, 0.f);
        if (k < N_SC)
          y[j] = make_float2(s.y[0][k][col + lane] * out_scale, s.y[1][k][col + lane] * out_scale);
      }
    } else {
      dft_bins(col ? &s.xt[0][0] : &s.xr[0][0], s, g, lane, out_scale, y);
    }
  };

  // -- LT-LS -------------------------------------------------------------------
  transform(-1);
  float ow2 = 0.f;
#pragma unroll
  for (int gg = 0; gg < GROUPS; ++gg) ow2 += s.red[gg][0][lane];
  ow2 = ow2 / (2.f * N_FFT);
  float2 hlt[BINS];
  float chk = 0.f;  // this thread's share of the checksum (ow2 is added once, at the end)
  {
    float2 rpre[BINS], tpre[BINS];
    spectrum(0, 1.f, rpre);
    if constexpr (TX_CONST) {
#pragma unroll
      for (int j = 0; j < BINS; ++j) {
        const int k = g + GROUPS * j;
        tpre[j] = k < N_SC ? s.tx.tpre[k] : make_float2(1.f, 0.f);
      }
    } else {
      spectrum(FRAMES, 1.f, tpre);
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
  finish(-1);

  // the rx and tx spectra of window i at this thread's bins (tx: the
  // tx-constant spectra, or the per-frame tx window's where it was staged)
  auto spectra = [&](int i, float2 (&rb)[BINS], float2 (&tb)[BINS]) {
    spectrum(0, p.scale, rb);
    if constexpr (TX_CONST) {
#pragma unroll
      for (int j = 0; j < BINS; ++j) {
        const int k = g + GROUPS * j;
        tb[j] = k < N_SC ? s.tx.txs[block_of(i)][k] : make_float2(1.f, 0.f);
      }
    } else if (with_tx(i)) {
      spectrum(FRAMES, p.scale, tb);
    } else {
#pragma unroll
      for (int j = 0; j < BINS; ++j) tb[j] = make_float2(0.f, 0.f);
    }
  };

  // -- blocks 0..3: pilot ratios, MMSE partial dots ----------------------------
#pragma unroll 1
  for (int b = 0; b < N_AVG; ++b) {
    transform(b);
    float2 rb[BINS], tb[BINS];
    spectra(b, rb, tb);
    float su2 = 0.f, sr = 0.f, si = 0.f;
#pragma unroll
    for (int j = 0; j < BINS; ++j) {
      const int k = g + GROUPS * j;
      if (k < N_SC) {
        const int q = pilot_of(k);
        if (q >= 0) s.hp[b][q][lane] = cdiv(rb[j], tb[j]);
        const float2 u = cmul(tb[j], hlt[j]);
        su2 += u.x * u.x + u.y * u.y;
        sr += u.x * rb[j].x + u.y * rb[j].y;  // Re(conj(u) rx)
        si += u.x * rb[j].y - u.y * rb[j].x;  // Im(conj(u) rx)
      }
    }
    s.red[g][3 * b + 0][lane] = su2;
    s.red[g][3 * b + 1][lane] = sr;
    s.red[g][3 * b + 2][lane] = si;
    finish(b);
  }
  __syncthreads();  // every group's pilot ratios and partial dots are in

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
  //    the pilot CPE (sync), the EVM sum, the checksum and the store; the
  //    spectra of blocks 0..3 are formed again ------------------------------
  EqT* eq_re = static_cast<EqT*>(p.eq_re);
  EqT* eq_im = static_cast<EqT*>(p.eq_im);
  float evm = 0.f;
#pragma unroll 1
  for (int i = N_AVG; i < N_WINDOWS; ++i) {
    const int b = block_of(i);
    transform(i);
    float2 rb[BINS], tb[BINS];
    spectra(i, rb, tb);
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
    finish(i);
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
