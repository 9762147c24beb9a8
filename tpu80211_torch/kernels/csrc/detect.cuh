// Packet detection and timing of one raw stream per lane, as a __device__
// function shared by detect.cu (detection, and alignment), raw_chain.cu and
// raw_gen_chain.cu (detection feeding the chain).
//
// Semantics are tpu80211/kernels/detect_kernel.py::_detect_core on samples
// upcast to f32 (bf16 and int8 exactly):
//   * Schmidl & Cox lag-64 metric M(d) = |P|^2 / max(E1 E2, 1e-30) with
//     P = sum_{k<64} x[d+k] conj(x[d+64+k]), E1, E2 the two window
//     energies, on the grid d = i*stride (stride 1 = full resolution,
//     d = 0 .. NS-128; decimated stride s = 16/32/64: i < (NS-64)/s - 64/s + 1);
//     detected = any M > threshold; coarse = the first crossing (decimated:
//     max(i*s - s, 0), and the fine window widens to search + s);
//   * matched filter |sum_t x[d+t] conj(h[t])| against the 64 LTS taps,
//     5-sample sums, pair[i] = mf5[i] + mf5[i+64], the first argmax of pair
//     over [coarse, coarse + 2*search) (0 if its max is 0), rep1 = argmax + 2,
//     start = rep1 - 32 - advance;
//   * metric = max(0, M) over [coarse, coarse + 2*search) (samples), or over
//     [0, 2*search0) for an undetected stream.
// The window sums and the matched filter are taken in f64 (products of f32
// values are exact there), so no summation order can move a threshold
// crossing or a near-tie of the argmax; the matched filter is rounded to
// f32 once, as the plain version rounds it.
//
// Layout: a block holds 32 streams (the lane) x 8 warps.
//   1. The sweep: the metric grid in grid order, a tile of points at a
//      time taken by the whole block; lane l reads stream l, so a warp's
//      load is one row of 32 neighbouring streams (coalesced).  On a grid
//      of stride 16 and up a window is the sum of its 64/stride blocks of
//      products: warp g sums the tile's block g once, into a ring in shared
//      memory that carries the last blocks to the next tile, and after a
//      barrier forms point g of the tile from its blocks, added in order.
//      Finer grids give each warp a part of 64/stride points and a running
//      window restarted at the part's first.  After each tile the warps
//      publish which lanes crossed; a lane with a crossing stops reading,
//      and the block stops once every live lane has one.  That is exact:
//      the first crossing is the least crossing index, every point before
//      it lies in a tile already taken, and nothing past it moves det,
//      coarse, start or metric (phases 2-4 read windows from coarse on).
//      A block with an undetected stream sweeps to the end, and the
//      stream's peak metric over points 0 .. 2*search/stride is kept as
//      the sweep passes them.
//   2. Every detected stream has a window of rows [coarse, coarse + 2*sf +
//      131) (sf the fine search): the matched filter's 2*sf + 68 offsets of
//      64 taps and the peak scan's grid points.  The block stages these
//      windows in shared memory, G streams at a time (G = 32, 16, 8, ...:
//      the most whose windows and matched filter fit SMEM_TARGET), stream-
//      major, each row a pair of samples in the storage type (odd stride).
//      The copy walks the group's union of windows row by row: a warp's load
//      is 32/G rows of G neighbouring streams, one 32-byte sector each
//      (bf16: G = 16 at the default search; f32: G = 8), and a lane whose
//      window does not hold its row does not load.  Rows past a window, up
//      to the last item's, are zeroed.
//   3. From shared memory, with all 256 threads: the peak metric in items of
//      (stream, one of 8 chunks of its window's grid points), then the
//      matched filter on the FP64 tensor cores in warp items of (stream, run
//      of MF_ITEM offsets), a Toeplitz product (mf_item).  Items of streams
//      without a window skip.  The |MF| values go to shared memory, stream-
//      major.
//   4. The first argmax of pair, split over 256/G slices of each window and
//      reduced across them, the smallest index winning a tie.
// Windows start at each stream's own row: read in place, a warp's load
// would touch 32 rows (32 sectors), which is why they are staged.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace detect {

constexpr int LAG = 64;            // LTS repeat period and window
constexpr int LANES = 32;          // streams per block
constexpr int WARPS = 8;
constexpr int THREADS = LANES * WARPS;
constexpr int FRAME = 160 + 1200;  // long preamble + packet rows
constexpr int MF_EXTRA = 68;       // matched-filter offsets past the last pair index
constexpr int WIN_EXTRA = 2 * LAG + 3;  // staged rows past the fine window: 68 + 63
constexpr int MF_ROWS = 16;        // rows of 8 offsets a matched-filter item (m16n8k4's M)
constexpr int MF_ITEM = 8 * MF_ROWS;  // matched-filter offsets an item
constexpr int MF_K = LAG + 8;      // the Toeplitz block's depth: 64 taps shifted by 0..7
constexpr int H_PAD = 8;           // zero taps before tap 0 in Smem::h
constexpr int COPY_UNROLL = 4;     // rows in flight a thread in the copy
constexpr int RING = 16;           // block sums the sweep keeps: a tile's 8 and the 3 before, rounded up
constexpr int SWEEP_UNROLL = 8;    // products in flight a thread in a sweep's block sum
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM_TARGET = 96 * 1024;  // a group's stage and |MF|: two blocks per SM

struct Config {
  const void* x_re;   // (ns, batch) raw streams, storage type
  const void* x_im;
  const float* h_re;  // (64,) LTS taps
  const float* h_im;
  long long batch;    // streams, and the row stride
  int ns;
  int stride;         // metric grid step: 1, or the decimation stride
  int decimated;
  int search;
  int advance;
  double threshold;
};

struct Result {
  int det;
  int coarse;    // -1 when undetected
  int start;     // -1 when undetected
  float metric;
};

// A staged sample: both planes side by side in the storage type
template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
};
template <>
struct Pair<int8_t> {
  using type = char2;
};

__device__ __forceinline__ float2 pair_of(float re, float im) { return make_float2(re, im); }
__device__ __forceinline__ __nv_bfloat162 pair_of(__nv_bfloat16 re, __nv_bfloat16 im) {
  return __halves2bfloat162(re, im);
}
__device__ __forceinline__ char2 pair_of(int8_t re, int8_t im) { return make_char2(re, im); }

__device__ __forceinline__ double2 unpack(float2 v) { return make_double2(v.x, v.y); }
__device__ __forceinline__ double2 unpack(__nv_bfloat162 v) {
  return make_double2(__low2float(v), __high2float(v));
}
__device__ __forceinline__ double2 unpack(char2 v) { return make_double2(v.x, v.y); }

struct Smem {
  double2 h[H_PAD + MF_K];  // the taps at [H_PAD, H_PAD + 64), zero around them
  double dred[THREADS];  // per-thread partials
  double pk[THREADS];
  int ired[THREADS];
  int lo[LANES];         // a stream's window: rows [lo, hi), lo = -1 without one
  int hi[LANES];
  int n_mf[LANES];       // its matched-filter offsets
  float peak[LANES];     // per stream: the peak metric and the argmax of pair
  int best[LANES];
  double2 rest[1];       // the sweep (phase 1); then a group's stage and |MF| values; sized at launch
};

// Smem::rest in phase 1: at every search and stride the stage and |MF|
// values that follow need more room
struct Sweep {
  double sums[RING][4][LANES];  // block b of products in slot b mod RING: pr, pi, e1, e2
  unsigned int hit[2][WARPS];   // lanes each warp has seen cross, by the parity of the tile
};

// Where a group's staged windows and |MF| values lie in Smem::rest, for
// samples of type T at this search and stride
struct Layout {
  int log2_group;  // streams staged at once: 1 << log2_group
  int row_stride;  // staged rows a stream (odd, in pairs)
  int n_mf;        // matched-filter offsets of a full window
  int mf_stride;   // |MF| values a stream
  size_t mf_at;    // byte offset of the |MF| values in Smem
  size_t bytes;    // the block's shared memory
};

template <typename T>
__host__ __device__ inline Layout layout(int search, int stride, int decimated) {
  using P = typename Pair<T>::type;
  const int sf = search + (decimated ? stride : 0);
  const int n_mf = 2 * sf + MF_EXTRA;
  // the last item's rows reach LAG - 1 past its offsets
  const int sp = ((n_mf + MF_ITEM - 1) / MF_ITEM * MF_ITEM + LAG) | 1;
  // 2 mod 4 (n_mf is even): step 4's reads of 16 streams at two neighbouring
  // offsets fall on 32 distinct banks
  const int ms = n_mf | 2;
  for (int lg = 5;; --lg) {
    const size_t stage = (sizeof(P) * (static_cast<size_t>(sp) << lg) + 15) / 16 * 16;
    const size_t mf_at = offsetof(Smem, rest) + stage;
    const size_t bytes = mf_at + sizeof(float) * (static_cast<size_t>(ms) << lg);
    if (bytes <= SMEM_TARGET || lg == 0) return Layout{lg, sp, n_mf, ms, mf_at, bytes};
  }
}

template <typename T>
__host__ __device__ inline size_t smem_bytes(int search, int stride, int decimated) {
  return layout<T>(search, stride, decimated).bytes;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

template <typename T>
struct Stream {
  const T* re;
  const T* im;
  long long batch;
  long long f;
  __device__ __forceinline__ double2 at(int row) const {
    const long long i = row * batch + f;
    return make_double2(to_f32(re[i]), to_f32(im[i]));
  }
};

// A stream's staged rows, from `lo` on
template <typename P>
struct Staged {
  const P* rows;
  int lo;
  __device__ __forceinline__ double2 at(int row) const { return unpack(rows[row - lo]); }
};

// S&C window sums over the products j of a window
struct Win {
  double pr = 0.0, pi = 0.0, e1 = 0.0, e2 = 0.0;
  template <typename X>
  __device__ __forceinline__ void add(const X& x, int j, double sign) {
    const double2 a = x.at(j), b = x.at(j + LAG);
    pr += sign * (a.x * b.x + a.y * b.y);
    pi += sign * (a.y * b.x - a.x * b.y);
    e1 += sign * (a.x * a.x + a.y * a.y);
    e2 += sign * (b.x * b.x + b.y * b.y);
  }
  __device__ __forceinline__ void add(const Win& o) {
    pr += o.pr;
    pi += o.pi;
    e1 += o.e1;
    e2 += o.e2;
  }
  __device__ __forceinline__ double metric() const {
    return (pr * pr + pi * pi) / fmax(e1 * e2, 1e-30);
  }
};

// The sums of the products j in [d, d + N), U products a turn
template <int N, int U = 4, typename X>
__device__ __forceinline__ Win block_sums(const X& x, int d) {
  Win w;
#pragma unroll(U)
  for (int j = d; j < d + N; ++j) w.add(x, j, 1.0);
  return w;
}

// M at grid points i0 .. i1-1 of a grid of stride LAG / NB: point i's
// window is the NB blocks of products from row i*stride on.  Each block is
// summed once and kept in a ring of registers (block i0 + b in slot b % NB;
// the loop steps NB points, so every slot index is known at compile time),
// and a window adds its blocks in order: each product is taken once, not
// twice as in a running window, and no sum drifts.
template <int NB, typename X, typename Fn>
__device__ __forceinline__ void scan_blocks(const X& x, int i0, int i1, Fn&& fn) {
  constexpr int S = LAG / NB;
  Win ring[NB];
#pragma unroll
  for (int k = 0; k < NB - 1; ++k) ring[k] = block_sums<S>(x, (i0 + k) * S);
  for (int i = i0; i < i1; i += NB) {
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      if (i + u >= i1) return;
      ring[(u + NB - 1) % NB] = block_sums<S>(x, (i + u + NB - 1) * S);
      Win w = ring[u];
#pragma unroll
      for (int k = 1; k < NB; ++k) w.add(ring[(u + k) % NB]);
      if (fn(i + u, w.metric())) return;
    }
  }
}

// M at grid points i0 .. i1-1 of a finer grid by a running window, whose
// step adds and takes away `stride` products
template <typename X, typename Fn>
__device__ __forceinline__ void scan_running(const X& x, int stride, int i0, int i1, Fn&& fn) {
  if (i0 >= i1) return;
  Win w;
  for (int j = i0 * stride; j < i0 * stride + LAG; ++j) w.add(x, j, 1.0);
  for (int i = i0;;) {
    if (fn(i, w.metric())) return;
    if (++i >= i1) return;
    const int d = (i - 1) * stride;
    for (int j = 0; j < stride; ++j) {
      w.add(x, d + j, -1.0);
      w.add(x, d + LAG + j, 1.0);
    }
  }
}

// Visit M at grid points i0 .. i1-1 (window start d = i*stride); fn(i, M)
// returns true to stop.  Strides of 16 and up take block sums; finer grids
// a running window.
template <typename X, typename Fn>
__device__ __forceinline__ void scan_metric(const X& x, int stride, int i0, int i1, Fn&& fn) {
  if (i0 >= i1) return;
  switch (stride) {
    case 16: return scan_blocks<4>(x, i0, i1, fn);
    case 32: return scan_blocks<2>(x, i0, i1, fn);
    case 64: return scan_blocks<1>(x, i0, i1, fn);
  }
  scan_running(x, stride, i0, i1, fn);
}

__device__ __forceinline__ void put(Sweep& sw, int b, int lane, const Win& w) {
  double(&v)[4][LANES] = sw.sums[b & (RING - 1)];
  v[0][lane] = w.pr;
  v[1][lane] = w.pi;
  v[2][lane] = w.e1;
  v[3][lane] = w.e2;
}

__device__ __forceinline__ Win get(const Sweep& sw, int b, int lane) {
  const double(&v)[4][LANES] = sw.sums[b & (RING - 1)];
  Win w;
  w.pr = v[0][lane];
  w.pi = v[1][lane];
  w.e1 = v[2][lane];
  w.e2 = v[3][lane];
  return w;
}

// What phase 1 leaves a thread: the first crossing among the grid points
// it formed (nm without one), and the peak metric over those before i_pk
struct Scan {
  int first;
  double peak;
};

// Phase 1: M at the grid points 0 .. nm-1 in grid order, a tile of WARPS
// parts at a time, taken by the whole block.  Lane l's points are formed in
// increasing i for as long as no tile before has found lane l a crossing.
// NB > 0 (strides LAG / NB of 16 and up), a part is one point: warp g sums
// block i + NB - 1 of the tile's point i = i0 + g into the ring (the first
// tile also block g < NB - 1), then after a barrier forms point i's window
// from blocks i .. i + NB - 1, added in that order as scan_blocks adds them.
// NB == 0 (finer grids), a part is LAG / stride points of a running window.
// After each tile the warps publish the lanes they saw cross (hit[parity],
// so no warp writes a word another may still read), and the block stops
// once every live lane has crossed: every thread reads the same words after
// the same barrier.
template <int NB, typename X>
__device__ __forceinline__ Scan sweep(const X& x, int stride, int nm, int i_pk, double threshold,
                                      bool live, int lane, int g, Sweep& sw) {
  constexpr int S = NB ? LAG / NB : 1;  // products a block
  const int part = NB ? 1 : LAG / stride;
  Scan r{nm, 0.0};
  auto visit = [&](int i, double m) {
    if (i < i_pk) r.peak = fmax(r.peak, m);
    const bool hit = m > threshold;
    if (hit && r.first == nm) r.first = i;
    return hit;
  };
  const unsigned dead = ~__ballot_sync(FULL, live);
  bool active = live;
  unsigned seen = 0;  // lanes this warp has seen cross
  if (NB > 1 && g < NB - 1 && active) put(sw, g, lane, block_sums<S, SWEEP_UNROLL>(x, g * S));
  for (int i0 = 0, k = 0; i0 < nm; i0 += WARPS * part, k ^= 1) {
    bool hit = false;
    if (NB) {
      const int i = i0 + g;
      if (active && i < nm)
        put(sw, i + NB - 1, lane, block_sums<S, SWEEP_UNROLL>(x, (i + NB - 1) * S));
      __syncthreads();  // the tile's block sums are in the ring
      if (active && i < nm) {
        Win w = get(sw, i, lane);
#pragma unroll
        for (int b = 1; b < NB; ++b) w.add(get(sw, i + b, lane));
        hit = visit(i, w.metric());
      }
    } else if (active) {
      scan_running(x, stride, i0 + g * part, min(nm, i0 + (g + 1) * part), [&](int i, double m) {
        hit = visit(i, m);
        return hit;
      });
    }
    seen |= __ballot_sync(FULL, hit);
    if (lane == 0) sw.hit[k][g] = seen;
    __syncthreads();  // the tile's crossings are published
    unsigned hits = dead;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) hits |= sw.hit[k][w];
    if (hits == FULL) break;
    active = live && !(hits >> lane & 1u);
  }
  return r;
}

// The peak metric over grid points [i_lo, i_hi), chunk `ch` of WARPS
template <typename X>
__device__ __forceinline__ double peak_chunk(const X& x, int stride, int i_lo, int i_hi, int ch) {
  const int chunk = (max(i_hi - i_lo, 0) + WARPS - 1) / WARPS;
  double peak = 0.0;
  scan_metric(x, stride, i_lo + ch * chunk, min(i_hi, i_lo + (ch + 1) * chunk), [&](int, double m) {
    peak = fmax(peak, m);
    return false;
  });
  return peak;
}

__device__ __forceinline__ void clear(float2& v) { v = make_float2(0.f, 0.f); }
__device__ __forceinline__ void clear(__nv_bfloat162& v) { v = __floats2bfloat162_rn(0.f, 0.f); }
__device__ __forceinline__ void clear(char2& v) { v = make_char2(0, 0); }

// d += A B on the FP64 tensor cores, A 16x4 (row-major), B 4x8, f64 sums.
// Lane (g, t) = (lane / 4, lane % 4) holds A[g][t] and A[g + 8][t] in a0, a1,
// B[t][g] in b, and C[g][2t], C[g][2t + 1], C[g + 8][2t], C[g + 8][2t + 1] in d.
__device__ __forceinline__ void mma_f64(double (&d)[4], double a0, double a1, double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// |MF| at the MF_ITEM offsets q = 8a + b (a < MF_ROWS, b < 8) from staged
// rows x, by one warp: y[q] = sum_u x[8a + u] conj(h[u - b]) over u < MF_K,
// the Hankel rows A[a][u] = x[8a + u] times the Toeplitz taps H[u][b] =
// h[u - b] (zero outside [0, 64)), as yr = Xr Hr + Xi Hi and yi = Xi Hr +
// Xr (-Hi) in K-steps of 4.  Products of f32 values are exact in f64; the
// sums are rounded to f32 once.  Rows a and a + 8 are 64 rows apart, so
// lane (g, t) reads rows 8g + t + 4k and 64 on; offsets q >= n are not
// stored.
template <typename P>
__device__ __forceinline__ void mf_item(const P* x, const double2* h, int lane, int n,
                                        float* mag) {
  using Acc = double;
  const int g = lane >> 2, t = lane & 3;
  const P* xa = x + 8 * g + t;
  const double2* hb = h + H_PAD + t - g;
  Acc yr[4] = {0.0, 0.0, 0.0, 0.0}, yi[4] = {0.0, 0.0, 0.0, 0.0};
  // two K-steps a turn: unrolled whole, the steps' loads in flight spill
  // (f32 detect) and run no faster
#pragma unroll 2
  for (int k = 0; k < MF_K; k += 4) {
    const double2 a0 = unpack(xa[k]), a1 = unpack(xa[k + LAG]);
    const double2 b = hb[k];
    mma_f64(yr, a0.x, a1.x, b.x);
    mma_f64(yr, a0.y, a1.y, b.y);
    mma_f64(yi, a0.y, a1.y, b.x);
    mma_f64(yi, a0.x, a1.x, -b.y);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int q = 8 * (g + 8 * (j >> 1)) + 2 * t + (j & 1);
    if (q < n) mag[q] = static_cast<float>(sqrt(yr[j] * yr[j] + yi[j] * yi[j]));
  }
}

// Detection of stream f (live lanes only load).  Every thread of the block
// calls it (it holds __syncthreads) and gets its lane's result.
template <typename T>
__device__ Result run(const Config& c, Smem& s, long long f, bool live, int lane, int g) {
  using P = typename Pair<T>::type;
  const T* xr = static_cast<const T*>(c.x_re);
  const T* xi = static_cast<const T*>(c.x_im);
  const Stream<T> x{xr, xi, c.batch, f};
  const int st = c.stride;
  const int nm = c.decimated ? (c.ns - LAG) / st - LAG / st + 1 : c.ns - 2 * LAG + 1;
  for (int t = threadIdx.x; t < H_PAD + MF_K; t += THREADS)
    s.h[t] = t >= H_PAD && t < H_PAD + LAG ? make_double2(c.h_re[t - H_PAD], c.h_im[t - H_PAD])
                                            : make_double2(0.0, 0.0);

  // -- 1. the sweep: the first threshold crossing, and the peak metric over
  // [0, 2*search) that an undetected stream reports ---------------------------
  {
    const int i_pk = min(nm, (2 * c.search + st - 1) / st);
    Sweep& sw = *reinterpret_cast<Sweep*>(s.rest);
    Scan r;
    switch (st) {
      case 16: r = sweep<4>(x, st, nm, i_pk, c.threshold, live, lane, g, sw); break;
      case 32: r = sweep<2>(x, st, nm, i_pk, c.threshold, live, lane, g, sw); break;
      case 64: r = sweep<1>(x, st, nm, i_pk, c.threshold, live, lane, g, sw); break;
      default: r = sweep<0>(x, st, nm, i_pk, c.threshold, live, lane, g, sw);
    }
    s.ired[g * LANES + lane] = r.first;
    s.dred[g * LANES + lane] = r.peak;
  }
  __syncthreads();
  int cross = nm;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) cross = min(cross, s.ired[w * LANES + lane]);
  const bool det = live && cross < nm;
  const int coarse = c.decimated ? max(cross * st - st, 0) : cross;
  const int sf = c.search + (c.decimated ? st : 0);
  const int n_pair = c.ns - 2 * LAG - 4;  // pair entries, NS-132

  // -- the peak metric of an undetected stream; the windows of the others ----
  if (g == 0) {
    const int i_end = det ? min(coarse + 2 * sf, n_pair) : coarse;
    s.lo[lane] = det ? coarse : -1;
    s.hi[lane] = det ? min(c.ns, coarse + 2 * sf + WIN_EXTRA) : 0;
    s.n_mf[lane] = i_end > coarse ? i_end - coarse + MF_EXTRA : 0;
    double peak = 0.0;
    if (live && !det) {
#pragma unroll
      for (int w = 0; w < WARPS; ++w) peak = fmax(peak, s.dred[w * LANES + lane]);
    }
    s.peak[lane] = static_cast<float>(peak);
    s.best[lane] = 0;
  }
  __syncthreads();

  // -- 2-4. the detected streams' windows, G streams at a time ----------------
  const Layout lay = layout<T>(c.search, st, c.decimated);
  const int lg = lay.log2_group, gs = 1 << lg, sp = lay.row_stride;
  P* stage = reinterpret_cast<P*>(s.rest);
  float* mf = reinterpret_cast<float*>(reinterpret_cast<char*>(&s) + lay.mf_at);
  const int t = threadIdx.x;
  const int js = t & (gs - 1);  // the thread's stream in the group, in every item below
  const long long f0 = f - lane;
  for (int g0 = 0; g0 < LANES; g0 += gs) {
    int r_lo = c.ns, r_hi = 0;  // the group's union of windows (the same in every thread)
    for (int j = 0; j < gs; ++j)
      if (s.lo[g0 + j] >= 0) {
        r_lo = min(r_lo, s.lo[g0 + j]);
        r_hi = max(r_hi, s.hi[g0 + j]);
      }
    if (r_lo >= r_hi) continue;
    const int lo = s.lo[g0 + js], hi = s.hi[g0 + js];

    // 2. the copy: rows r_lo + t / G, then every THREADS / G rows
    {
      const int step = THREADS >> lg;
      const long long col = f0 + g0 + js;
      P* dst = stage + js * sp - lo;
      for (int r0 = r_lo + (t >> lg); r0 < r_hi; r0 += COPY_UNROLL * step) {
        T re[COPY_UNROLL], im[COPY_UNROLL];
#pragma unroll
        for (int u = 0; u < COPY_UNROLL; ++u) {
          const int r = r0 + u * step;
          if (r >= lo && r < hi) {
            re[u] = xr[r * c.batch + col];
            im[u] = xi[r * c.batch + col];
          }
        }
#pragma unroll
        for (int u = 0; u < COPY_UNROLL; ++u) {
          const int r = r0 + u * step;
          if (r >= lo && r < hi) dst[r] = pair_of(re[u], im[u]);
        }
      }
      // rows past the window meet only zero taps in the offsets kept, but a
      // NaN there would still reach them
      if (lo >= 0)
        for (int r = hi + (t >> lg); r < lo + sp; r += step) clear(dst[r]);
    }
    __syncthreads();

    // 3. the peak metric in items (stream, chunk), then the matched filter in
    // warp items (stream, run of MF_ITEM offsets)
    if (t < gs * WARPS)
      s.pk[t] = lo >= 0 ? peak_chunk(Staged<P>{stage + js * sp, lo}, st, (lo + st - 1) / st,
                                     min(nm, (lo + 2 * sf + st - 1) / st), t >> lg)
                        : 0.0;
    {
      const int n_items = (lay.n_mf + MF_ITEM - 1) / MF_ITEM;
      for (int item = t >> 5; item < n_items << lg; item += WARPS) {
        const int j = item & (gs - 1), q0 = (item >> lg) * MF_ITEM;
        const int n = s.n_mf[g0 + j];
        if (q0 >= n) continue;
        mf_item(stage + j * sp + q0, s.h, t & 31, n - q0, mf + j * lay.mf_stride + q0);
      }
    }
    __syncthreads();

    // 4. the first argmax of pair over [lo, i_end), slice t / G of each window
    {
      double best = 0.0;
      int best_i = 0;
      const float* mfj = mf + js * lay.mf_stride;
      auto at = [&](int q) { return static_cast<double>(mfj[q]); };
      auto mf5 = [&](int q) { return ((at(q) + at(q + 1)) + (at(q + 2) + at(q + 3))) + at(q + 4); };
      const int n_q = s.n_mf[g0 + js] - MF_EXTRA;
      for (int q = t >> lg; q < n_q; q += THREADS >> lg) {
        const double pair = mf5(q) + mf5(q + LAG);
        if (pair > best) {
          best = pair;
          best_i = lo + q;
        }
      }
      s.dred[t] = best;
      s.ired[t] = best_i;
    }
    __syncthreads();
    if (t < gs && lo >= 0) {
      double peak = 0.0, best = 0.0;
      int best_i = 0;
      for (int ch = 0; ch < WARPS; ++ch) peak = fmax(peak, s.pk[(ch << lg) + t]);
      for (int sl = 0; sl < THREADS >> lg; ++sl) {
        const double v = s.dred[(sl << lg) + t];
        const int i = s.ired[(sl << lg) + t];
        if (v > best || (v == best && v > 0.0 && i < best_i)) {
          best = v;
          best_i = i;
        }
      }
      s.peak[g0 + t] = static_cast<float>(peak);
      s.best[g0 + t] = best_i;
    }
    __syncthreads();  // the stage, the |MF| values and the partials are free
  }
  __syncthreads();
  const float peak = s.peak[lane];
  const int start = s.best[lane] + 2 - 32 - c.advance;
  __syncthreads();  // shared memory is free for the caller
  return Result{det ? 1 : 0, det ? coarse : -1, det ? start : -1, peak};
}

// The row the aligned frame starts at: start, or 0 when undetected, clipped
// to [0, ns - 1360].
__device__ __forceinline__ int frame_row(const Result& r, int ns) {
  return min(max(r.det ? r.start : 0, 0), ns - FRAME);
}

}  // namespace detect
