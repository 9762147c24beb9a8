// One-kernel raw-stream receiver for Hopper (sm_90a): lane-major (NS, B)
// raw streams in; detection rows, the seven channel estimates, the
// equalized blocks (or, with stream_sums, only their per-stream EVM sums),
// sigma^2, the CFO and the checksum out, in one launch.
//
// Replaces tpu80211/kernels/raw_chain.py::_raw_kernel (pallas_call site
// _raw_call).  Per block of 32 streams it runs detect::run (detect.cuh,
// without writing aligned planes), then chain::run (chain.cuh, tx-constant
// mode) reading each stream's preamble and packet straight from the raw
// buffer at rows s and s + 160, where s is the detected start clipped to
// [0, NS - 1360] (0 when undetected).  No aligned copy goes through device
// memory.  Storage: f32 streams run the chain in f32; bf16 streams feed it
// bf16; int8 ADC words feed it as exact bf16 with lsb in the scale, and eq
// comes out bf16.  stream_sums turns on the EVM sums and passes a null eq.
//
// What bounds it on this card.  The detection stage (detect.cuh: the f64
// matched filter over ~2*search + 68 offsets from windows staged in shared
// memory, on the FP64 tensor cores; the metric scan) and the chain's loads.  The chain's DFTs run on
// the tensor cores (chain.cuh; bf16 and int8 streams), so its arithmetic no
// longer bounds it.  Its loads start at a different row in every lane, so a
// warp's row load touches up to 32 rows instead of one 64-byte (bf16) span:
// up to 16x the sectors of the fused chain's loads, served mostly by L1/L2.
// Each thread loads its rows of the next window into registers before the
// current window's product, so the loads overlap the product and the
// epilogue; staging the rows as detection does is later work.

#include "chain.cuh"
#include "detect.cuh"
#include "ffi.cuh"

static_assert(chain::FRAMES == detect::LANES && chain::GROUPS == detect::WARPS,
              "the chain and the detector share one block layout");

namespace {

struct RawParams {
  detect::Config det_cfg;
  chain::Params chain;
  int* det;
  int* coarse;
  int* start;
  float* metric;
};

template <typename T, bool SYNC, bool EVM>
__global__ void __launch_bounds__(chain::THREADS, 2) raw_chain_kernel(RawParams p) {
  extern __shared__ double2 smem_raw[];
  const int lane = threadIdx.x % chain::FRAMES;
  const int g = threadIdx.x / chain::FRAMES;
  const long long f = static_cast<long long>(blockIdx.x) * chain::FRAMES + lane;
  const bool live = f < p.chain.batch;
  const detect::Result r = detect::run<T>(
      p.det_cfg, *reinterpret_cast<detect::Smem*>(smem_raw), f, live, lane, g);
  if (live && g == 0) {
    p.det[f] = r.det;
    p.coarse[f] = r.coarse;
    p.start[f] = r.start;
    p.metric[f] = r.metric;
  }
  // detect::run ends on a barrier: the shared memory is the chain's now
  const long long row0 = detect::frame_row(r, p.det_cfg.ns);
  chain::run<T, true, SYNC, EVM>(p.chain, *reinterpret_cast<chain::SmemFor<T, true>*>(smem_raw),
                                 f, live, lane, g, row0, row0 + chain::PREAMBLE);
}

// the shared memory of a block: one union for detection and the chain
template <typename T>
size_t smem_of(int search, int stride, int decimated) {
  const size_t det_smem = detect::smem_bytes<T>(search, stride, decimated);
  const size_t chain_smem = sizeof(chain::SmemFor<T, true>);
  return det_smem > chain_smem ? det_smem : chain_smem;
}

template <typename T, bool SYNC, bool EVM>
cudaError_t launch_one(const RawParams& p, cudaStream_t stream) {
  auto kernel = raw_chain_kernel<T, SYNC, EVM>;
  const size_t smem = smem_of<T>(p.det_cfg.search, p.det_cfg.stride, p.det_cfg.decimated);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((p.chain.batch + chain::FRAMES - 1) / chain::FRAMES);
  kernel<<<grid, chain::THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const RawParams& p, bool sync, bool evm, cudaStream_t stream) {
  if (sync) return evm ? launch_one<T, true, true>(p, stream)
                       : launch_one<T, true, false>(p, stream);
  return evm ? launch_one<T, false, true>(p, stream)
             : launch_one<T, false, false>(p, stream);
}

template <typename T>
cudaError_t attributes(bool sync, bool evm, int search, int stride, int decimated, int* out) {
  constexpr int n = chain::THREADS;
  const size_t smem = smem_of<T>(search, stride, decimated);
  if (sync) return evm ? ffi::occupancy(raw_chain_kernel<T, true, true>, n, smem, out)
                       : ffi::occupancy(raw_chain_kernel<T, true, false>, n, smem, out);
  return evm ? ffi::occupancy(raw_chain_kernel<T, false, true>, n, smem, out)
             : ffi::occupancy(raw_chain_kernel<T, false, false>, n, smem, out);
}

}  // namespace

// ptrs: x re/im (ns, B), LTS taps re/im (64 f32), txs re/im (53, 16),
// tpre re/im (53, 1), w re/im, wi re/im, then chain's outputs (7 h planes
// re/im, eq re/im, ow2, cfo, chk, evm; eq null iff stream_sums, evm null
// otherwise), then det, coarse, start (int32) and metric (f32).  storage:
// 0 f32, 1 bf16, 2 int8.  stride: the metric grid step (1 at full
// resolution).
extern "C" int raw_chain_launch(const void* const* ptrs, int n_ptrs, int storage, int eq_sel,
                                int batch, int ns, float eps, float lsb, int sync,
                                int stream_sums, double threshold, int search, int advance,
                                int stride, int decimated, void* stream) {
  constexpr int N_IN = 12;
  if (n_ptrs != N_IN + chain::N_OUT_PTRS + 4 || batch <= 0 || ns % detect::LAG != 0 ||
      ns < detect::FRAME || search < 1 || stride < 1 || detect::LAG % stride != 0 ||
      eq_sel < chain::EQ_LINEAR || eq_sel > chain::EQ_MMSE)
    return cudaErrorInvalidValue;
  RawParams p;
  p.det_cfg = detect::Config{ptrs[0], ptrs[1], static_cast<const float*>(ptrs[2]),
                             static_cast<const float*>(ptrs[3]), batch, ns, stride, decimated,
                             search, advance, threshold};
  chain::Params& c = p.chain;
  c.rxp_re = c.rxl_re = ptrs[0];
  c.rxp_im = c.rxl_im = ptrs[1];
  c.txa_re = ptrs[4];
  c.txa_im = ptrs[5];
  c.txb_re = ptrs[6];
  c.txb_im = ptrs[7];
  c.w_re = static_cast<const float*>(ptrs[8]);
  c.w_im = static_cast<const float*>(ptrs[9]);
  c.wi_re = static_cast<const float*>(ptrs[10]);
  c.wi_im = static_cast<const float*>(ptrs[11]);
  chain::set_outputs(c, ptrs + N_IN);
  if ((stream_sums != 0) != (c.eq_re == nullptr) || (stream_sums != 0) != (c.evm != nullptr))
    return cudaErrorInvalidValue;
  c.batch = batch;
  c.eq_sel = eq_sel;
  c.scale = (1.0f + eps) * lsb;
  const void* const* rows = ptrs + N_IN + chain::N_OUT_PTRS;
  p.det = static_cast<int*>(const_cast<void*>(rows[0]));
  p.coarse = static_cast<int*>(const_cast<void*>(rows[1]));
  p.start = static_cast<int*>(const_cast<void*>(rows[2]));
  p.metric = static_cast<float*>(const_cast<void*>(rows[3]));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (storage) {
    case chain::STORE_F32: return launch<float>(p, sync != 0, stream_sums != 0, st);
    case chain::STORE_BF16: return launch<__nv_bfloat16>(p, sync != 0, stream_sums != 0, st);
    case chain::STORE_I8: return launch<int8_t>(p, sync != 0, stream_sums != 0, st);
  }
  return cudaErrorInvalidValue;
}

// The kernel that raw_chain_launch runs for this storage, sync and
// stream_sums, search and metric stride, on the current card: out =
// registers and local (spill) bytes a thread, shared bytes a block,
// resident blocks per SM.
extern "C" int raw_chain_attributes(int storage, int sync, int stream_sums, int search,
                                    int stride, int decimated, int* out) {
  if (search < 1 || stride < 1 || detect::LAG % stride != 0) return cudaErrorInvalidValue;
  const bool sy = sync != 0, evm = stream_sums != 0;
  switch (storage) {
    case chain::STORE_F32: return attributes<float>(sy, evm, search, stride, decimated, out);
    case chain::STORE_BF16:
      return attributes<__nv_bfloat16>(sy, evm, search, stride, decimated, out);
    case chain::STORE_I8: return attributes<int8_t>(sy, evm, search, stride, decimated, out);
  }
  return cudaErrorInvalidValue;
}
