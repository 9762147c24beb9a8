// Packet detection and timing of one raw stream per lane, as a __device__
// function shared by detect.cu (detection, and alignment) and raw_chain.cu
// (detection feeding the chain).
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
// Layout: a block holds 32 streams (the lane) x 8 warps.  The metric grid
// is split into 8 contiguous ranges, one per warp, each a running window
// sum restarted at its first point; the matched filter is evaluated only
// over [coarse, coarse + 2*search + 68), where the argmax can look (the TPU
// computes all ~NS offsets because its shapes are static), each warp taking
// runs of 16 consecutive offsets from one pass over their 79 rows; its
// values go to shared memory, and the argmax and the minima cross the warps
// there, the smallest index winning a tie.  Lanes load their own rows, so
// in the matched filter (rows from each stream's coarse on) a warp's load
// touches 32 rows: the load is not coalesced.

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
constexpr int MF_EXTRA = 68;       // matched-filter rows past the last pair index
constexpr int MF_RUN = 16;         // consecutive matched-filter offsets per warp pass

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

struct Smem {
  double2 h[LAG];
  double dred[WARPS][LANES];
  int ired[WARPS][LANES];
  float mf[1];  // [mf_rows][LANES], sized at launch
};

// rows of the matched filter kept per stream
__host__ __device__ inline int mf_rows(int search, int stride, int decimated) {
  return 2 * (search + (decimated ? stride : 0)) + MF_EXTRA;
}

__host__ __device__ inline size_t smem_bytes(int search, int stride, int decimated) {
  return offsetof(Smem, mf) + sizeof(float) * LANES * mf_rows(search, stride, decimated);
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

// S&C window sums over the products j of a window
struct Win {
  double pr = 0.0, pi = 0.0, e1 = 0.0, e2 = 0.0;
  template <typename T>
  __device__ __forceinline__ void add(const Stream<T>& x, int j, double sign) {
    const double2 a = x.at(j), b = x.at(j + LAG);
    pr += sign * (a.x * b.x + a.y * b.y);
    pi += sign * (a.y * b.x - a.x * b.y);
    e1 += sign * (a.x * a.x + a.y * a.y);
    e2 += sign * (b.x * b.x + b.y * b.y);
  }
  __device__ __forceinline__ double metric() const {
    return (pr * pr + pi * pi) / fmax(e1 * e2, 1e-30);
  }
};

// Visit M at grid points i0 .. i1-1 (window start d = i*stride) with a
// running window; fn(i, M) returns true to stop.
template <typename T, typename Fn>
__device__ __forceinline__ void scan_metric(const Stream<T>& x, int stride, int i0, int i1,
                                            Fn&& fn) {
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

// Detection of stream f (live lanes only load).  Every thread of the block
// calls it (it holds __syncthreads) and gets its lane's result.
template <typename T>
__device__ Result run(const Config& c, Smem& s, long long f, bool live, int lane, int g) {
  const Stream<T> x{static_cast<const T*>(c.x_re), static_cast<const T*>(c.x_im), c.batch, f};
  const int st = c.stride;
  const int nm = c.decimated ? (c.ns - LAG) / st - LAG / st + 1 : c.ns - 2 * LAG + 1;
  for (int t = threadIdx.x; t < LAG; t += THREADS) s.h[t] = make_double2(c.h_re[t], c.h_im[t]);

  // -- 1. first threshold crossing: warp g scans one contiguous range ---------
  {
    const int chunk = (nm + WARPS - 1) / WARPS;
    int first = nm;
    if (live)
      scan_metric(x, st, g * chunk, min(nm, (g + 1) * chunk), [&](int i, double m) {
        if (m > c.threshold) {
          first = i;
          return true;
        }
        return false;
      });
    s.ired[g][lane] = first;
  }
  __syncthreads();
  int cross = nm;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) cross = min(cross, s.ired[w][lane]);
  const bool det = live && cross < nm;
  const int coarse = c.decimated ? max(cross * st - st, 0) : cross;
  const int search = c.search + (c.decimated ? st : 0);

  // -- 2. peak metric over the window (samples; grid points inside it) --------
  {
    const int lo_m = det ? coarse : 0;
    const int hi_m = lo_m + (det ? 2 * search : 2 * c.search);
    const int i_lo = (lo_m + st - 1) / st;
    const int i_hi = min(nm, (hi_m + st - 1) / st);
    const int chunk = (max(i_hi - i_lo, 0) + WARPS - 1) / WARPS;
    double peak = 0.0;
    if (live)
      scan_metric(x, st, i_lo + g * chunk, min(i_hi, i_lo + (g + 1) * chunk),
                  [&](int, double m) {
                    peak = fmax(peak, m);
                    return false;
                  });
    s.dred[g][lane] = peak;
  }
  __syncthreads();
  double peak = 0.0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) peak = fmax(peak, s.dred[w][lane]);
  __syncthreads();  // dred and ired are free again

  // -- 3. matched filter over the rows the pair window reads -------------------
  const int n_pair = c.ns - 2 * LAG - 4;              // pair entries, NS-132
  const int i_end = det ? min(coarse + 2 * search, n_pair) : coarse;
  const int n_mf = i_end > coarse ? i_end - coarse + MF_EXTRA : 0;
  // warp g takes runs of MF_RUN consecutive offsets; one pass over the
  // run's MF_RUN + 63 rows feeds all of them (a row is loaded once per run,
  // not once per tap)
  float(*mf)[LANES] = reinterpret_cast<float(*)[LANES]>(s.mf);
  for (int q0 = g * MF_RUN; q0 < n_mf; q0 += WARPS * MF_RUN) {
    double yr[MF_RUN], yi[MF_RUN];
#pragma unroll
    for (int k = 0; k < MF_RUN; ++k) yr[k] = yi[k] = 0.0;
    for (int r = 0; r < MF_RUN + LAG - 1; ++r) {
      const int row = coarse + q0 + r;
      if (row >= c.ns) break;
      const double2 v = x.at(row);
#pragma unroll
      for (int k = 0; k < MF_RUN; ++k) {
        const int t = r - k;  // the tap this row meets in output q0 + k
        if (t >= 0 && t < LAG) {
          const double2 h = s.h[t];
          yr[k] += v.x * h.x + v.y * h.y;
          yi[k] += v.y * h.x - v.x * h.y;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < MF_RUN; ++k)
      if (q0 + k < n_mf) mf[q0 + k][lane] = static_cast<float>(sqrt(yr[k] * yr[k] + yi[k] * yi[k]));
  }
  __syncthreads();

  // -- 4. first argmax of pair over [coarse, i_end) ----------------------------
  {
    double best = 0.0;
    int best_i = 0;
    auto mf5 = [&](int q) {
      return ((static_cast<double>(mf[q][lane]) + mf[q + 1][lane]) +
              (static_cast<double>(mf[q + 2][lane]) + mf[q + 3][lane])) + mf[q + 4][lane];
    };
    for (int q = g; q < i_end - coarse; q += WARPS) {
      const double pair = mf5(q) + mf5(q + LAG);
      if (pair > best) {
        best = pair;
        best_i = coarse + q;
      }
    }
    s.dred[g][lane] = best;
    s.ired[g][lane] = best_i;
  }
  __syncthreads();
  double best = 0.0;
  int best_i = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const double v = s.dred[w][lane];
    const int i = s.ired[w][lane];
    if (v > best || (v == best && v > 0.0 && i < best_i)) {
      best = v;
      best_i = i;
    }
  }
  __syncthreads();  // shared memory is free for the caller
  const int start = best_i + 2 - 32 - c.advance;
  return Result{det ? 1 : 0, det ? coarse : -1, det ? start : -1, static_cast<float>(peak)};
}

// The row the aligned frame starts at: start, or 0 when undetected, clipped
// to [0, ns - 1360].
__device__ __forceinline__ int frame_row(const Result& r, int ns) {
  return min(max(r.det ? r.start : 0, 0), ns - FRAME);
}

}  // namespace detect
