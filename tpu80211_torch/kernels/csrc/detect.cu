// Packet detection (with optional alignment) and stream placement for
// Hopper (sm_90a), on lane-major (NS, B) raw streams.
//
// detect_kernel replaces tpu80211/kernels/detect_kernel.py::_kernel
// (pallas_call site _detect_call): Schmidl & Cox metric, LTS matched
// filter, timing, and with `align` the 160 + 1200 rows of each stream's
// frame copied out at its start.  The detection math is detect::run
// (detect.cuh), which raw_chain.cu shares.  The TPU's barrel shifters
// (_barrel_align, _barrel_align_packed) exist only because a TPU has no
// per-lane slice; here alignment is an indexed load, bit-exact in the
// storage type.
//
// place_kernel replaces detect_kernel.py::_place_kernel (pallas_call site
// _place_call): x[r, l] = sig[(r - offs[l]) mod NS, l] + noise[r, l], added
// in f32 and rounded to sig's type; the TPU's roll chain is an indexed load.
//
// What bounds them on this card.  Detection reads NS rows per stream once
// into the metric scan (~2 x NS x 2 planes loads, coalesced) and evaluates
// the matched filter at ~2*search + 68 offsets of 64 taps in f64: ~1.2e5
// f64 FMAs per stream at the default search of 192, ~4e9 at B = 32768
// (~0.25 ms at the H100 SXM's ~34 TFLOP/s f64 without tensor cores).  The
// filter's loads start at each stream's own coarse row, so a warp's load
// is 32 rows, not one, and these uncoalesced loads are the limit: on an
// H100, halving them (runs of 16 offsets instead of 8) halved detection's
// time.  Placement moves 3 x NS x B x 2 planes of the storage type (~0.8 GB
// at B = 32768 bf16, ~0.25 ms at 3.35 TB/s): memory-bound, and its sig
// loads are uncoalesced the same way.

#include "detect.cuh"

namespace {

enum { STORE_F32, STORE_BF16, STORE_I8 };

struct DetectParams {
  detect::Config cfg;
  int* det;       // (B,) int32
  int* coarse;
  int* start;
  float* metric;
  void* lp_re;    // (160, B) aligned preamble, storage type; null = no alignment
  void* lp_im;
  void* pkt_re;   // (1200, B) aligned packet
  void* pkt_im;
};

template <typename T>
__global__ void __launch_bounds__(detect::THREADS) detect_kernel(DetectParams p) {
  extern __shared__ double2 smem_raw[];
  detect::Smem& s = *reinterpret_cast<detect::Smem*>(smem_raw);
  const int lane = threadIdx.x % detect::LANES;
  const int g = threadIdx.x / detect::LANES;
  const long long batch = p.cfg.batch;
  const long long f = static_cast<long long>(blockIdx.x) * detect::LANES + lane;
  const bool live = f < batch;
  const detect::Result r = detect::run<T>(p.cfg, s, f, live, lane, g);
  if (!live) return;
  if (g == 0) {
    p.det[f] = r.det;
    p.coarse[f] = r.coarse;
    p.start[f] = r.start;
    p.metric[f] = r.metric;
  }
  if (p.lp_re == nullptr) return;
  const long long row0 = detect::frame_row(r, p.cfg.ns);
  const T* xr = static_cast<const T*>(p.cfg.x_re);
  const T* xi = static_cast<const T*>(p.cfg.x_im);
  for (int n = g; n < detect::FRAME; n += detect::WARPS) {
    const long long src = (row0 + n) * batch + f;
    T* dr = static_cast<T*>(n < 160 ? p.lp_re : p.pkt_re);
    T* di = static_cast<T*>(n < 160 ? p.lp_im : p.pkt_im);
    const long long dst = (n < 160 ? n : n - 160) * batch + f;
    dr[dst] = xr[src];
    di[dst] = xi[src];
  }
}

template <typename T>
cudaError_t launch_detect(const DetectParams& p, cudaStream_t stream) {
  auto kernel = detect_kernel<T>;
  const size_t smem = detect::smem_bytes(p.cfg.search, p.cfg.stride, p.cfg.decimated);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((p.cfg.batch + detect::LANES - 1) / detect::LANES);
  kernel<<<grid, detect::THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// one thread per (row, stream); the stream index runs fastest
template <typename TS, typename TN>
__global__ void place_kernel(const TS* sr, const TS* si, const TN* nr, const TN* ni,
                             const int* offs, TS* xr, TS* xi, int ns, long long batch) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= ns * batch) return;
  const long long r = i / batch, l = i % batch;
  const long long src = ((r - offs[l] + ns) % ns) * batch + l;
  store(xr + i, to_f32(sr[src]) + to_f32(nr[i]));
  store(xi + i, to_f32(si[src]) + to_f32(ni[i]));
}

template <typename TS, typename TN>
cudaError_t launch_place(const void* const* ptrs, int ns, long long batch, cudaStream_t stream) {
  const long long n = ns * batch;
  const unsigned threads = 256;
  const unsigned grid = static_cast<unsigned>((n + threads - 1) / threads);
  place_kernel<TS, TN><<<grid, threads, 0, stream>>>(
      static_cast<const TS*>(ptrs[0]), static_cast<const TS*>(ptrs[1]),
      static_cast<const TN*>(ptrs[2]), static_cast<const TN*>(ptrs[3]),
      static_cast<const int*>(ptrs[4]), static_cast<TS*>(const_cast<void*>(ptrs[5])),
      static_cast<TS*>(const_cast<void*>(ptrs[6])), ns, batch);
  return cudaGetLastError();
}

}  // namespace

// ptrs: x re/im, LTS taps re/im (64 f32 each), det, coarse, start, metric,
// then lp re/im, pkt re/im (all four null = no alignment).  storage: 0 f32,
// 1 bf16, 2 int8.  stride: the metric grid step (1 at full resolution).
extern "C" int detect_launch(const void* const* ptrs, int n_ptrs, int storage, int batch,
                             int ns, double threshold, int search, int advance, int stride,
                             int decimated, void* stream) {
  if (n_ptrs != 12 || batch <= 0 || ns % detect::LAG != 0 || ns < detect::FRAME ||
      search < 1 || stride < 1 || detect::LAG % stride != 0)
    return cudaErrorInvalidValue;
  DetectParams p;
  p.cfg = detect::Config{ptrs[0], ptrs[1], static_cast<const float*>(ptrs[2]),
                         static_cast<const float*>(ptrs[3]), batch, ns, stride, decimated,
                         search, advance, threshold};
  p.det = static_cast<int*>(const_cast<void*>(ptrs[4]));
  p.coarse = static_cast<int*>(const_cast<void*>(ptrs[5]));
  p.start = static_cast<int*>(const_cast<void*>(ptrs[6]));
  p.metric = static_cast<float*>(const_cast<void*>(ptrs[7]));
  p.lp_re = const_cast<void*>(ptrs[8]);
  p.lp_im = const_cast<void*>(ptrs[9]);
  p.pkt_re = const_cast<void*>(ptrs[10]);
  p.pkt_im = const_cast<void*>(ptrs[11]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (storage) {
    case STORE_F32: return launch_detect<float>(p, st);
    case STORE_BF16: return launch_detect<__nv_bfloat16>(p, st);
    case STORE_I8: return launch_detect<int8_t>(p, st);
  }
  return cudaErrorInvalidValue;
}

// ptrs: sig re/im (ns, B), noise re/im (ns, B), offs (B,) int32 in [0, ns),
// out re/im (ns, B) in sig's type.  sig_type, noise_type: 0 f32, 1 bf16.
extern "C" int place_launch(const void* const* ptrs, int n_ptrs, int sig_type, int noise_type,
                            int ns, int batch, void* stream) {
  if (n_ptrs != 7 || ns <= 0 || batch <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sig_type == STORE_F32 && noise_type == STORE_F32)
    return launch_place<float, float>(ptrs, ns, batch, st);
  if (sig_type == STORE_F32 && noise_type == STORE_BF16)
    return launch_place<float, __nv_bfloat16>(ptrs, ns, batch, st);
  if (sig_type == STORE_BF16 && noise_type == STORE_F32)
    return launch_place<__nv_bfloat16, float>(ptrs, ns, batch, st);
  if (sig_type == STORE_BF16 && noise_type == STORE_BF16)
    return launch_place<__nv_bfloat16, __nv_bfloat16>(ptrs, ns, batch, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* detect_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
