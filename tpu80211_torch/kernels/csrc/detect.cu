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
// in f32 and rounded to sig's type; the TPU's roll chain is a shifted read
// of shared memory.  A block owns a strip of streams in one plane, 32 bytes
// of each row (16 bf16 or 8 f32 streams), and copies the strip's NS rows
// into shared memory with coalesced 16-B loads; then it writes every output
// row of the strip whole, each stream reading its own shifted row from
// shared memory and the noise in place.  A strip longer than 96 KB halves
// its width; a stream longer than that is read in place.  Indices are
// 32-bit from a 2D grid (strip, plane).
//
// What bounds them on this card.  Detection's sweep reads a stream's rows
// up to the tile of its block's last first crossing, all NS where a stream
// of the block goes undetected (2 loads a row and plane, coalesced), and
// evaluates the matched filter at ~2*search + 68 offsets of 64 taps in f64: ~1.5e5
// f64 FMAs per stream at the default search of 192 as the tensor cores
// take them (72 taps, 512 offsets), ~4.8e9 at B = 32768 (~0.14 ms at the
// H100 SXM's 67 TFLOP/s of f64 on the tensor cores, twice its CUDA cores').
// The filter's windows start at each stream's own coarse row; read in place,
// a warp's load touched 32 rows, and those loads set detection's time.  Now
// each block stages its windows in shared memory by coalesced row loads
// (detect.cuh).  Placement moves sig, noise and the output once each, NS x B x 2
// planes of each type (1.07 GB at B = 32768 with bf16 sig and f32 noise,
// 0.32 ms at 3.35 TB/s): memory-bound.  A thread per (row, stream) reading
// sig at its stream's own row took 3.4 ms (a sector a sample, and 64-bit
// divisions); the strips read and write whole sectors.

#include <type_traits>

#include "detect.cuh"
#include "ffi.cuh"

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
  const size_t smem = detect::smem_bytes<T>(p.cfg.search, p.cfg.stride, p.cfg.decimated);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((p.cfg.batch + detect::LANES - 1) / detect::LANES);
  kernel<<<grid, detect::THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t attributes(int search, int stride, int decimated, int* out) {
  return ffi::occupancy(detect_kernel<T>, detect::THREADS,
                           detect::smem_bytes<T>(search, stride, decimated), out);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

constexpr int PLACE_THREADS = 256;
constexpr int STRIP_BYTES = 32;           // a strip's row in one plane: one 32-B sector
constexpr int PLACE_SMEM_MAX = 96 * 1024;  // a staged strip: at least 2 blocks per SM

struct PlaceParams {
  const void* sig[2];  // re, im (ns, batch), sig's type
  const void* noise[2];
  const int* offs;     // (batch,) in [0, ns)
  void* out[2];
  int ns;
  int batch;
  int strip_log2;      // streams per strip: 1 << strip_log2
};

// Block (s, plane) owns streams [s W, s W + W) of one plane.  STAGED: it
// first copies the strip's ns rows of sig into shared memory, each row's W
// samples side by side (VEC samples, 16 B, per load when VEC > 1), then
// writes every output row of the strip: out[r][l] = sig[(r - off_l) mod
// ns][l] + noise[r][l], a warp covering 32 / W whole rows.  Unstaged (a
// strip of one stream does not fit): the same row pass reads sig from
// device memory.  A thread keeps one stream for the whole pass.  Loads go
// out in batches before their stores, so that enough bytes are in
// flight to keep device memory busy.
template <typename TS, typename TN, int VEC, bool STAGED>
__global__ void __launch_bounds__(PLACE_THREADS) place_kernel(PlaceParams p) {
  // loads in flight a thread, from a sweep on an H100 (PERF.md): deeper
  // batches made the kernel up to 4x slower
  constexpr int LOAD_UNROLL = 4, ROW_UNROLL = sizeof(TS) == 2 ? 4 : 16;
  using Vec = typename std::conditional<(VEC > 1), uint4, TS>::type;
  extern __shared__ uint4 place_smem[];
  TS* strip = reinterpret_cast<TS*>(place_smem);  // [ns][W]
  const bool im = blockIdx.y != 0;
  const TS* __restrict__ sig = static_cast<const TS*>(im ? p.sig[1] : p.sig[0]);
  const TN* __restrict__ noise = static_cast<const TN*>(im ? p.noise[1] : p.noise[0]);
  TS* __restrict__ out = static_cast<TS*>(im ? p.out[1] : p.out[0]);
  const int w_log2 = p.strip_log2, w = 1 << w_log2;
  const int l0 = blockIdx.x << w_log2;
  const size_t batch = static_cast<size_t>(p.batch);
  if (STAGED) {
    const int per_row = w / VEC;  // vectors a row; a power of two
    const int v_log2 = __ffs(per_row) - 1;
    const int n_vec = p.ns << v_log2;
    for (int v0 = threadIdx.x; v0 < n_vec; v0 += LOAD_UNROLL * PLACE_THREADS) {
      Vec buf[LOAD_UNROLL];
#pragma unroll
      for (int u = 0; u < LOAD_UNROLL; ++u) {
        const int v = v0 + u * PLACE_THREADS, r = v >> v_log2, j = (v & (per_row - 1)) * VEC;
        // VEC > 1: batch % VEC == 0, so a vector lies wholly inside or outside
        if (v < n_vec && l0 + j < p.batch)
          buf[u] = *reinterpret_cast<const Vec*>(sig + r * batch + l0 + j);
      }
#pragma unroll
      for (int u = 0; u < LOAD_UNROLL; ++u) {
        const int v = v0 + u * PLACE_THREADS, r = v >> v_log2, j = (v & (per_row - 1)) * VEC;
        if (v < n_vec && l0 + j < p.batch)
          *reinterpret_cast<Vec*>(strip + (r << w_log2) + j) = buf[u];
      }
    }
    __syncthreads();
  }
  const int j = threadIdx.x & (w - 1);  // PLACE_THREADS is a multiple of w
  const int l = l0 + j;
  if (l >= p.batch) return;
  const int off = p.offs[l];
  const int step = PLACE_THREADS >> w_log2;  // rows a pass of the block covers
  for (int r0 = threadIdx.x >> w_log2; r0 < p.ns; r0 += ROW_UNROLL * step) {
    TS sv[ROW_UNROLL];
    TN nv[ROW_UNROLL];
#pragma unroll
    for (int u = 0; u < ROW_UNROLL; ++u) {
      const int r = r0 + u * step;
      if (r < p.ns) {
        int src = r - off;
        if (src < 0) src += p.ns;
        sv[u] = STAGED ? strip[(src << w_log2) + j] : sig[src * batch + l];
        nv[u] = noise[r * batch + l];
      }
    }
#pragma unroll
    for (int u = 0; u < ROW_UNROLL; ++u) {
      const int r = r0 + u * step;
      if (r < p.ns) store(out + r * batch + l, to_f32(sv[u]) + to_f32(nv[u]));
    }
  }
}

// The strip width for sig samples of `size` bytes: one sector a row, halved
// until ns rows fit PLACE_SMEM_MAX; -1 when not even one stream fits.
inline int strip_log2(int ns, int size) {
  for (int k = __builtin_ctz(STRIP_BYTES / size); k >= 0; --k)
    if ((static_cast<size_t>(ns) * size << k) <= static_cast<size_t>(PLACE_SMEM_MAX)) return k;
  return -1;
}

// Which instantiation places these streams, its strip width and its shared
// memory.  `aligned`: both sig planes start on 16 bytes.
struct PlacePlan {
  void (*kernel)(PlaceParams);
  int strip_log2;
  size_t smem;
};

template <typename TS, typename TN>
PlacePlan place_plan(int ns, int batch, bool aligned) {
  constexpr int VEC = 16 / sizeof(TS);
  const int k = strip_log2(ns, sizeof(TS));
  if (k < 0)  // unstaged: sig read in place, strips one sector wide
    return {place_kernel<TS, TN, 1, false>, __builtin_ctz(STRIP_BYTES / sizeof(TS)), 0};
  const size_t smem = static_cast<size_t>(ns) * sizeof(TS) << k;
  if ((1 << k) >= VEC && batch % VEC == 0 && aligned)
    return {place_kernel<TS, TN, VEC, true>, k, smem};
  return {place_kernel<TS, TN, 1, true>, k, smem};
}

PlacePlan place_plan(int sig_type, int noise_type, int ns, int batch, bool aligned) {
  if (sig_type == STORE_F32 && noise_type == STORE_F32)
    return place_plan<float, float>(ns, batch, aligned);
  if (sig_type == STORE_F32 && noise_type == STORE_BF16)
    return place_plan<float, __nv_bfloat16>(ns, batch, aligned);
  if (sig_type == STORE_BF16 && noise_type == STORE_F32)
    return place_plan<__nv_bfloat16, float>(ns, batch, aligned);
  if (sig_type == STORE_BF16 && noise_type == STORE_BF16)
    return place_plan<__nv_bfloat16, __nv_bfloat16>(ns, batch, aligned);
  return {nullptr, 0, 0};
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
  const bool aligned = reinterpret_cast<uintptr_t>(ptrs[0]) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(ptrs[1]) % 16 == 0;
  const PlacePlan plan = place_plan(sig_type, noise_type, ns, batch, aligned);
  if (plan.kernel == nullptr) return cudaErrorInvalidValue;
  const PlaceParams p{{ptrs[0], ptrs[1]}, {ptrs[2], ptrs[3]}, static_cast<const int*>(ptrs[4]),
                      {const_cast<void*>(ptrs[5]), const_cast<void*>(ptrs[6])}, ns, batch,
                      plan.strip_log2};
  cudaError_t err = cudaFuncSetAttribute(plan.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(plan.smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((batch + (1 << plan.strip_log2) - 1) >> plan.strip_log2), 2);
  plan.kernel<<<grid, PLACE_THREADS, plan.smem, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

// The placement kernel that place_launch runs for these types and shapes
// (sig planes on 16 bytes, as PyTorch allocates them): out = registers and
// local (spill) bytes a thread, shared bytes a block, resident blocks per
// SM, streams per strip (0 when unstaged).
extern "C" int place_attributes(int sig_type, int noise_type, int ns, int batch, int* out) {
  const PlacePlan plan = place_plan(sig_type, noise_type, ns, batch, true);
  if (plan.kernel == nullptr || ns <= 0 || batch <= 0) return cudaErrorInvalidValue;
  const cudaError_t err = ffi::occupancy(plan.kernel, PLACE_THREADS, plan.smem, out);
  out[4] = plan.smem ? 1 << plan.strip_log2 : 0;
  return err;
}

// The detection kernel for this storage (0 f32, 1 bf16, 2 int8), search
// and metric stride, with or without alignment (the same kernel), on the
// current card: out = registers and local (spill) bytes a thread, shared
// bytes a block, resident blocks per SM.
extern "C" int detect_attributes(int storage, int search, int stride, int decimated, int* out) {
  if (search < 1 || stride < 1 || detect::LAG % stride != 0) return cudaErrorInvalidValue;
  switch (storage) {
    case STORE_F32: return attributes<float>(search, stride, decimated, out);
    case STORE_BF16: return attributes<__nv_bfloat16>(search, stride, decimated, out);
    case STORE_I8: return attributes<int8_t>(search, stride, decimated, out);
  }
  return cudaErrorInvalidValue;
}
