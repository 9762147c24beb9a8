// Batched 53x53 complex Hermitian positive definite solves for Hopper
// (sm_90a): z = A^-1 rx per system, by LU without pivoting ("gauss") or by
// LL^H ("chol"), in complex f32.
//
// Replaces the two TPU kernels of tpu80211/kernels/mmse_solve.py:
//   * _fused_kernel (pallas_call in _fused_call): A = sigma^2 I + u u^H is
//     built in shared memory from u and sigma^2 (the template flag FUSED),
//     so the 22.5 KB system never touches device memory: a system reads
//     ~0.85 KB (u, rx, sigma^2) and writes 0.42 KB (z);
//   * _dense_kernel (pallas_call in _dense_call): the same factor and solve
//     on a materialized (S, 53, 53) system, 22.5 KB read per system.
// The TPU kernels pad 53 to 64 and put 128 systems across the vector
// lanes; here one block of 64 threads owns one system, thread t owns row
// t (t < 53), and the system sits in shared memory with a row pitch of 53
// complex values: the rows of one column then fall on distinct banks
// (53 float2 = 106 words, 106 mod 32 = 10, distinct over a half-warp's 16
// rows), so the column sweeps below are conflict-free.
//
// What bounds it on this card.  Per system LU takes ~5.2e4 complex
// multiply-adds (n^3/3 + the two triangular solves), LL^H ~2.9e4 (n^3/6 +
// the solves), i.e. 4.2e5 and 2.3e5 f32 operations.  At 8,192 systems
// that is ~0.05 ms (LU) and ~0.03 ms (LL^H) at the H100 SXM's ~67 TFLOP/s
// of FP32 outside the tensor cores; the dense kernel's 191 MB of systems
// take ~0.057 ms at 3.35 TB/s, so it is bound by bytes, the fused one by
// operations.  As written neither is near its bound: each step of the
// column loop ends in a block barrier (53 or 106 of them per system), a
// thread's multiply-adds each need two shared loads and a store, and 24 KB
// of shared memory per system caps an SM at 9 systems in flight, so the
// kernel is bound by shared-memory latency.  Several systems per block,
// registers for the owned rows and the tensor cores for the trailing
// updates are later work.

#include <cuda_runtime.h>

namespace {

constexpr int N = 53;        // system size
constexpr int THREADS = 64;  // one block per system; thread t < N owns row t

struct Smem {
  float2 a[N * N];  // the system, row-major; LL^H keeps L in the lower triangle
  float2 y[N];      // the right-hand side, forward-substituted in place
  float2 col[N];    // LL^H: column j of L during step j
  float2 u[N];      // FUSED: the vector u
  float dinv[N];    // LL^H: 1 / L[j][j]
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// 1/p as conj(p)/|p|^2, the TPU kernel's form of the pivot inverse
__device__ __forceinline__ float2 recip(float2 p) {
  const float d = p.x * p.x + p.y * p.y;
  return make_float2(p.x / d, -p.y / d);
}

// a -= m * b
__device__ __forceinline__ void sub_mul(float2& a, float2 m, float2 b) {
  a.x -= m.x * b.x - m.y * b.y;
  a.y -= m.x * b.y + m.y * b.x;
}

// a -= m * conj(b)
__device__ __forceinline__ void sub_mul_conj(float2& a, float2 m, float2 b) {
  a.x -= m.x * b.x + m.y * b.y;
  a.y -= m.y * b.x - m.x * b.y;
}

// Right-looking LU without pivoting (exact-stable on Hermitian positive
// definite systems, as the TPU kernel assumes), the forward solve of y
// riding along; then back substitution column by column.  Returns row t
// of the solution (threads t >= N return 0).
__device__ float2 gauss_solve(Smem& s, int t) {
  for (int j = 0; j < N - 1; ++j) {
    if (t > j && t < N) {
      float2* row = s.a + t * N;
      const float2* piv = s.a + j * N;
      const float2 m = cmul(row[j], recip(piv[j]));
      for (int k = j + 1; k < N; ++k) sub_mul(row[k], m, piv[k]);
      sub_mul(s.y[t], m, s.y[j]);
    }
    __syncthreads();
  }
  float2 x = make_float2(0.f, 0.f);
  for (int j = N - 1; j >= 0; --j) {
    const float2 xj = cmul(s.y[j], recip(s.a[j * N + j]));
    if (t == j) x = xj;
    if (t < j) sub_mul(s.y[t], s.a[t * N + j], xj);
    __syncthreads();
  }
  return x;
}

// Right-looking LL^H on the lower triangle, the forward solve L y = b
// riding along; then L^H x = y column by column.  Step j reads the
// diagonal and y[j], publishes column j of L in s.col, barrier, then every
// row below updates its part of the trailing lower triangle.
__device__ float2 chol_solve(Smem& s, int t) {
  for (int j = 0; j < N; ++j) {
    const float d = rsqrtf(s.a[j * N + j].x);  // real and positive
    const float2 yj = make_float2(s.y[j].x * d, s.y[j].y * d);
    float2 l = make_float2(0.f, 0.f);
    if (t > j && t < N) {
      l = make_float2(s.a[t * N + j].x * d, s.a[t * N + j].y * d);
      s.col[t] = l;
    }
    __syncthreads();
    if (t == j) {
      s.y[j] = yj;
      s.dinv[j] = d;
    }
    if (t > j && t < N) {
      float2* row = s.a + t * N;
      for (int k = j + 1; k <= t; ++k) sub_mul_conj(row[k], l, s.col[k]);
      row[j] = l;
      sub_mul(s.y[t], l, yj);
    }
    __syncthreads();
  }
  float2 x = make_float2(0.f, 0.f);
  for (int j = N - 1; j >= 0; --j) {
    const float2 xj = make_float2(s.y[j].x * s.dinv[j], s.y[j].y * s.dinv[j]);
    if (t == j) x = xj;
    // y[t] -= conj(L[j][t]) * x_j
    if (t < j) {
      const float2 l = s.a[j * N + t];
      s.y[t].x -= l.x * xj.x + l.y * xj.y;
      s.y[t].y -= l.x * xj.y - l.y * xj.x;
    }
    __syncthreads();
  }
  return x;
}

// mat: u (S, N) when FUSED, else the systems (S, N, N); rhs (S, N); ow2
// (S,) when FUSED; z (S, N).  Complex values are interleaved float2.
template <bool FUSED, bool CHOL>
__global__ void __launch_bounds__(THREADS) mmse_solve_kernel(const float2* __restrict__ mat,
                                                             const float2* __restrict__ rhs,
                                                             const float* __restrict__ ow2,
                                                             float2* __restrict__ z) {
  __shared__ Smem s;
  const long long sys = blockIdx.x;
  const int t = threadIdx.x;
  if (FUSED) {
    if (t < N) {
      s.u[t] = mat[sys * N + t];
      s.y[t] = rhs[sys * N + t];
    }
    __syncthreads();
    if (t < N) {
      // row t of sigma^2 I + u u^H (the lower triangle is all LL^H reads)
      const float sigma2 = ow2[sys];
      const float2 ut = s.u[t];
      const int last = CHOL ? t : N - 1;
      for (int k = 0; k <= last; ++k) {
        const float2 uk = s.u[k];
        float2 v = make_float2(ut.x * uk.x + ut.y * uk.y, ut.y * uk.x - ut.x * uk.y);
        if (k == t) v.x += sigma2;
        s.a[t * N + k] = v;
      }
    }
  } else {
    const float2* a = mat + sys * (N * N);
    for (int i = t; i < N * N; i += THREADS) s.a[i] = a[i];
    if (t < N) s.y[t] = rhs[sys * N + t];
  }
  __syncthreads();
  const float2 x = CHOL ? chol_solve(s, t) : gauss_solve(s, t);
  if (t < N) z[sys * N + t] = x;
}

template <bool FUSED, bool CHOL>
cudaError_t launch(const void* mat, const void* rhs, const void* ow2, void* z, int batch,
                   cudaStream_t stream) {
  mmse_solve_kernel<FUSED, CHOL><<<batch, THREADS, 0, stream>>>(
      static_cast<const float2*>(mat), static_cast<const float2*>(rhs),
      static_cast<const float*>(ow2), static_cast<float2*>(z));
  return cudaGetLastError();
}

}  // namespace

// One launch solves `batch` systems.  ow2 non-null selects the fused
// kernel (mat = u, (batch, 53)); ow2 null the dense one (mat = the systems,
// (batch, 53, 53)).  method: 0 gauss, 1 chol.  Returns cudaGetLastError()
// after the launch.
extern "C" int mmse_solve_launch(const void* mat, const void* rhs, const void* ow2, void* z,
                                 int batch, int method, void* stream) {
  if (batch <= 0 || mat == nullptr || rhs == nullptr || z == nullptr ||
      (method != 0 && method != 1))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ow2 != nullptr)
    return method ? launch<true, true>(mat, rhs, ow2, z, batch, st)
                  : launch<true, false>(mat, rhs, ow2, z, batch, st);
  return method ? launch<false, true>(mat, rhs, nullptr, z, batch, st)
                : launch<false, false>(mat, rhs, nullptr, z, batch, st);
}

extern "C" const char* mmse_solve_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
