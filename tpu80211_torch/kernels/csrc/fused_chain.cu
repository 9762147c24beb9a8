// Fused 802.11 receive chain for Hopper (sm_90a): time-domain packets and
// preambles in, seven channel estimates, the equalized blocks, sigma^2, the
// CFO, a per-frame checksum and (optionally) the EVM sums out, in one pass
// over device memory.  The chain body is chain::run (chain.cuh); this
// kernel feeds it packets (1200, B) and preambles (160, B) from their own
// buffers, row base 0.
//
// Replaces the TPU kernel tpu80211/kernels/fused_chain.py::_kernel, in both
// of its pallas_call sites: _fused_call_txconst (tx-constant mode, the
// template flag TX_CONST) and _fused_call (per-frame tx), with the sync and
// evm_sums branches (the template flags SYNC and EVM).
//
// What bounds it on this card.  Per frame the chain takes 16 DFTs (15 data
// blocks + the LTS average; per-frame-tx mode adds 5 for the tx side, and
// 15 more with sync or evm_sums), each 53 bins x 64 samples of complex
// multiply-add: ~1.36e4 FP32 FMAs, so ~2.2e5 FMAs per frame and ~2.8e10
// FLOP at B = 65536 on the CUDA cores (~0.4 ms at the H100 SXM's ~67
// TFLOP/s FP32).  Device-memory traffic is ~0.76 GB per step in bf16
// (~0.23 ms at 3.35 TB/s).  So this kernel is bound by the DFT arithmetic
// (and, as written, by the shared-memory loads that feed it); sync adds one
// f64 sincos per sample (~1,400 per frame).  Moving the
// DFTs onto the tensor cores as a (53x64).(64xframes) product is later work.

#include "chain.cuh"

namespace {

using chain::Params;
using chain::Smem;

template <typename T, bool TX_CONST, bool SYNC, bool EVM>
__global__ void __launch_bounds__(chain::THREADS, 2) fused_chain_kernel(Params p) {
  extern __shared__ float4 smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int lane = threadIdx.x % chain::FRAMES;
  const int g = threadIdx.x / chain::FRAMES;
  const long long f = static_cast<long long>(blockIdx.x) * chain::FRAMES + lane;
  chain::run<T, TX_CONST, SYNC, EVM>(p, s, f, f < p.batch, lane, g, 0, 0);
}

template <typename T, bool TX_CONST, bool SYNC, bool EVM>
cudaError_t launch_one(const Params& p, cudaStream_t stream) {
  auto kernel = fused_chain_kernel<T, TX_CONST, SYNC, EVM>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(sizeof(Smem)));
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((p.batch + chain::FRAMES - 1) / chain::FRAMES);
  kernel<<<grid, chain::THREADS, sizeof(Smem), stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool TX_CONST>
cudaError_t launch(const Params& p, bool sync, bool evm, cudaStream_t stream) {
  if (sync) return evm ? launch_one<T, TX_CONST, true, true>(p, stream)
                       : launch_one<T, TX_CONST, true, false>(p, stream);
  return evm ? launch_one<T, TX_CONST, false, true>(p, stream)
             : launch_one<T, TX_CONST, false, false>(p, stream);
}

}  // namespace

// ptrs: rxp re/im, rxl re/im, tx_a re/im, tx_b re/im, w re/im, wi re/im,
// then chain's outputs: 7 h planes re/im (null = not written), eq re/im,
// ow2, cfo, chk, evm (null = evm_sums off).  storage: 0 f32, 1 bf16, 2 int8
// (tx-constant only).  eq_sel: 0 h_linear, 1 h_wiener, 2 h_mmse.  Returns
// cudaGetLastError() after the launch.
extern "C" int fused_chain_launch(const void* const* ptrs, int n_ptrs, int storage,
                                  int tx_const, int eq_sel, int batch, float eps,
                                  float lsb, int sync, int evm_sums, void* stream) {
  if (n_ptrs != 12 + chain::N_OUT_PTRS || batch <= 0 || eq_sel < chain::EQ_LINEAR ||
      eq_sel > chain::EQ_MMSE)
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
  chain::set_outputs(p, ptrs + 12);
  if (p.eq_re == nullptr || (evm_sums != 0) != (p.evm != nullptr)) return cudaErrorInvalidValue;
  p.batch = batch;
  p.eq_sel = eq_sel;
  p.scale = (1.0f + eps) * lsb;
  const bool s = sync != 0, e = evm_sums != 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tx_const) {
    switch (storage) {
      case chain::STORE_F32: return launch<float, true>(p, s, e, st);
      case chain::STORE_BF16: return launch<__nv_bfloat16, true>(p, s, e, st);
      case chain::STORE_I8: return launch<int8_t, true>(p, s, e, st);
    }
  } else {
    switch (storage) {
      case chain::STORE_F32: return launch<float, false>(p, s, e, st);
      case chain::STORE_BF16: return launch<__nv_bfloat16, false>(p, s, e, st);
    }
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* fused_chain_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
