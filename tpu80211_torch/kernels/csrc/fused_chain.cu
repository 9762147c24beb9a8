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
// multiply-add, and the equalizer transforms blocks 0..3 again.  With bf16
// or int8 samples the DFTs run on the tensor cores (bf16 mma.sync, f32
// sums): at the H100 SXM's 989 TFLOP/s the 16 DFTs of B = 65,536 frames
// take 0.029 ms and the rest of the chain (~29,000 f32 operations a frame)
// 0.028 ms at 67 TFLOP/s, under the bytes' 0.227 ms at 3.35 TB/s (bf16).
// Measured on an H100 80GB HBM3 at 700 W (PERF.md): 0.60 ms, 2.6x that
// bound.  The copies are hidden (the windows ring through two buffers, and
// a probe that reads cached rows saves nothing); the CUDA-core epilogue
// sets the pace with 16 warps an SM: the eq stores (0.09 ms), the
// equalizer's divisions (0.08) and forming blocks 0..3 again (0.09).  sync
// adds the Moose sums, the CPE and the derotation of ~1,340 samples a frame
// in the staging: in runs of 8 frames by phase factors (64 library sincos a
// frame), else one f64 library sincos a sample, which cost 0.32 ms of the
// 1.03 ms sync kernel before the phases.  f32 samples keep the CUDA-core
// DFT (~2.2e5 FMAs per frame).

#include "chain.cuh"
#include "ffi.cuh"

#include <cstdint>

namespace {

using chain::Params;

template <typename T, bool TX_CONST, bool SYNC, bool EVM, bool SHARED_ROWS>
__global__ void __launch_bounds__(chain::THREADS, 2) fused_chain_kernel(Params p) {
  extern __shared__ float4 smem_raw[];
  auto& s = *reinterpret_cast<chain::SmemFor<T, TX_CONST>*>(smem_raw);
  const int lane = threadIdx.x % chain::FRAMES;
  const int g = threadIdx.x / chain::FRAMES;
  const long long f = static_cast<long long>(blockIdx.x) * chain::FRAMES + lane;
  chain::run<T, TX_CONST, SYNC, EVM, SHARED_ROWS>(p, s, f, f < p.batch, lane, g, 0, 0);
}

// bf16 and int8 windows move in runs of 8 frames where B is a multiple of 8
// and the packet planes are 16-byte aligned
template <typename T>
constexpr bool has_runs() {
  return std::is_same<T, __nv_bfloat16>::value || std::is_same<T, int8_t>::value;
}

bool rows_aligned(const Params& p, bool tx_const) {
  const void* planes[] = {p.rxp_re, p.rxp_im, p.txa_re, p.txa_im};
  for (int i = 0; i < (tx_const ? 2 : 4); ++i)
    if (reinterpret_cast<uintptr_t>(planes[i]) % 16 != 0) return false;
  return p.batch % 8 == 0;
}

template <typename T, bool TX_CONST, bool SYNC, bool EVM, bool SHARED_ROWS>
cudaError_t launch_one(const Params& p, cudaStream_t stream) {
  auto kernel = fused_chain_kernel<T, TX_CONST, SYNC, EVM, SHARED_ROWS>;
  constexpr int smem = static_cast<int>(sizeof(chain::SmemFor<T, TX_CONST>));
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((p.batch + chain::FRAMES - 1) / chain::FRAMES);
  kernel<<<grid, chain::THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool TX_CONST, bool SYNC, bool EVM>
cudaError_t launch_staged(const Params& p, cudaStream_t stream) {
  if constexpr (has_runs<T>()) {
    if (rows_aligned(p, TX_CONST)) return launch_one<T, TX_CONST, SYNC, EVM, true>(p, stream);
  }
  return launch_one<T, TX_CONST, SYNC, EVM, false>(p, stream);
}

template <typename T, bool TX_CONST>
cudaError_t launch(const Params& p, bool sync, bool evm, cudaStream_t stream) {
  if (sync) return evm ? launch_staged<T, TX_CONST, true, true>(p, stream)
                       : launch_staged<T, TX_CONST, true, false>(p, stream);
  return evm ? launch_staged<T, TX_CONST, false, true>(p, stream)
             : launch_staged<T, TX_CONST, false, false>(p, stream);
}

template <typename T, bool TX_CONST, bool SYNC, bool EVM, bool SHARED_ROWS>
cudaError_t occupancy_one(int* out) {
  return ffi::occupancy(fused_chain_kernel<T, TX_CONST, SYNC, EVM, SHARED_ROWS>, chain::THREADS,
                        sizeof(chain::SmemFor<T, TX_CONST>), out);
}

template <typename T, bool TX_CONST, bool SYNC, bool EVM>
cudaError_t occupancy_staged(bool aligned, int* out) {
  if constexpr (has_runs<T>()) {
    if (aligned) return occupancy_one<T, TX_CONST, SYNC, EVM, true>(out);
  }
  return occupancy_one<T, TX_CONST, SYNC, EVM, false>(out);
}

template <typename T, bool TX_CONST>
cudaError_t occupancy(bool sync, bool evm, bool aligned, int* out) {
  if (sync) return evm ? occupancy_staged<T, TX_CONST, true, true>(aligned, out)
                       : occupancy_staged<T, TX_CONST, true, false>(aligned, out);
  return evm ? occupancy_staged<T, TX_CONST, false, true>(aligned, out)
             : occupancy_staged<T, TX_CONST, false, false>(aligned, out);
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

// The kernel that fused_chain_launch runs for this storage, mode, sync and
// evm_sums, on the current card, where B is a multiple of 8 and the
// packet planes are 16-byte aligned (aligned != 0) or not: out = registers
// and local (spill) bytes a thread, shared bytes a block, resident blocks
// per SM.
extern "C" int fused_chain_attributes(int storage, int tx_const, int sync, int evm_sums,
                                      int aligned, int* out) {
  const bool s = sync != 0, e = evm_sums != 0, a = aligned != 0;
  if (tx_const) {
    switch (storage) {
      case chain::STORE_F32: return occupancy<float, true>(s, e, a, out);
      case chain::STORE_BF16: return occupancy<__nv_bfloat16, true>(s, e, a, out);
      case chain::STORE_I8: return occupancy<int8_t, true>(s, e, a, out);
    }
  } else {
    switch (storage) {
      case chain::STORE_F32: return occupancy<float, false>(s, e, a, out);
      case chain::STORE_BF16: return occupancy<__nv_bfloat16, false>(s, e, a, out);
    }
  }
  return cudaErrorInvalidValue;
}
