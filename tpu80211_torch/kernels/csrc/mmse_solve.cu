// Batched 53x53 complex Hermitian positive definite solves for Hopper
// (sm_90a): z = A^-1 rx per system, by LU without pivoting ("gauss") or by
// LL^H ("chol"), in complex f32.
//
// Replaces the two TPU kernels of tpu80211/kernels/mmse_solve.py:
//   * _fused_kernel (pallas_call in _fused_call): A = sigma^2 I + u u^H is
//     built in registers from u and sigma^2 (the template flag FUSED), so
//     the 22.5 KB system never touches device memory: a system reads ~0.85
//     KB (u, rx, sigma^2) and writes 0.42 KB (z);
//   * _dense_kernel (pallas_call in _dense_call): the same solves on a
//     materialized (S, 53, 53) system, 22.5 KB per system (LL^H reads only
//     the tiles on and below the diagonal).
//
// What bounds it on this card.  LU takes ~5.2e4 complex multiply-adds per
// system, LL^H ~2.9e4 (n^3/3 and n^3/6 plus the two triangular solves):
// for 262,144 systems 0.95 ms of f32 operations at the H100 SXM's 67
// TFLOP/s outside the tensor cores (the LL^H count), against 1.82 ms for
// the dense kernel's 5.9 GB at 3.35 TB/s.  So the fused kernel is bound by
// operations, the dense one by bytes.  A design that keeps the system in
// shared memory and updates it there pays two shared loads and a store per
// multiply-add (row[k], pivot[k], row[k] again): the shared-memory pipe,
// not the FP32 units, then sets the time, at ~15x the bound.
//
// The design: the factor lives in registers.  One block of 64 threads per
// system, an 8 x 8 grid: thread (r, c) = (tid % 8, tid / 8) owns the
// entries (i, k) with i = 8a + r, k = 8b + c for a, b < 7, a 7 x 7 tile of
// complex values (rows 53..55 and columns 54..55 are zero padding).  The
// right-hand side rides along as column 53, so the forward solve is part of
// the trailing update.  Step j of the right-looking factorization:
//   * the owners of column j (c = j % 8, all in one warp) take the pivot
//     from thread (j % 8, j % 8) by a warp shuffle and publish column j to
//     shared memory, scaled (LU: the multipliers A[i][j] / A[j][j]; LL^H:
//     L[i][j]) and zero for i <= j; for LU the owners of row j (r = j % 8)
//     publish U[j][k], zero for k <= j;
//   * one barrier;
//   * every thread reads its <= 7 multipliers and <= 7 row values and does
//     its <= 49 multiply-adds in registers.  The steps run in 7 blocks of 8
//     whose tile bounds are compile-time constants, so the register tiles
//     are indexed statically and the tiles wholly above or left of the
//     pivot cost nothing.
// LL^H publishes column j only (row j is its conjugate) and updates only
// the tiles on and below the diagonal, plus, in the warp that holds it, the
// right-hand side's column.  LU's multipliers are double-buffered; every
// other published value has its own slot, so one barrier per step
// suffices for both methods.  A warp skips the pivot's tile column once its
// four columns there all lie at or left of the pivot.
//
// Per system (chip_smoke.py's issued_per_system counts them), LU's
// factorization issues 66,240 complex multiply-adds for 27,072 shared
// loads and LL^H 43,008 for 27,136: 2.4 and 1.6 multiply-adds per load,
// each load a broadcast of at most 8 distinct values to a warp (one
// wavefront), ~850 wavefronts a system where updating the system in
// shared memory, a row per thread, takes ~12.6k.  A complex multiply-add is four FMAs (sub_mul), so LU's
// are 8,280 warp-wide FMA instructions a system,
// 1.26x the 52k multiply-adds that LU needs: the tiles on the pivot's row
// and column are updated whole, and the padding too.  The publishes, loads,
// barriers and loop control add about as many instructions again: the
// FP32 issue slots, not shared memory, now set the time.  The published
// rows (LU) and columns (LL^H) stay in shared memory, where one warp then
// runs the back substitution (a shuffle of the current y_j per column,
// 1,431 multiply-adds).  27 KB of shared memory a system and 128 registers
// a thread (the launch bound; LU needs all of them) allow 8 systems per SM.

#include <cuda_runtime.h>

#include "ffi.cuh"

namespace {

constexpr int N = 53;          // system size; column N holds the right-hand side
constexpr int G = 8;           // the thread grid is G x G
constexpr int THREADS = G * G;
constexpr int TILES = 7;       // a thread's rows (and columns): ceil((N + 1) / G)
constexpr int W = G * TILES;   // 56: rows and columns, padding included
constexpr int P = W + 1;       // pitch of the published rows and columns: 57
                               // float2 = 114 words, so the back substitution's
                               // column reads fall on distinct banks
constexpr int RHS_C = N % G;   // the grid column that holds the right-hand side
constexpr int LAST = TILES - 1;
constexpr int MIN_BLOCKS = 8;  // systems per SM: 65,536 / (64 x 8) = 128 registers a
                               // thread, and 8 x 27 KB of shared memory

struct Smem {
  float2 f[N][P];     // row j of U (LU) or column j of L (LL^H), as published at step j
  float2 col[2][W];   // LU: the multipliers of step j, in buffer j & 1
  float2 piv[N];      // LU: 1 / U[j][j]
  float d[N];         // LL^H: 1 / L[j][j]
  float2 b[N];        // LL^H: the right-hand side's b_j at step j (y_j = b_j d_j)
  float2 u[W];        // FUSED: u, zero-padded
  float2 rx[W];       // FUSED: the right-hand side, zero-padded
};

__device__ __forceinline__ float2 zero2() { return make_float2(0.f, 0.f); }

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 scale(float2 a, float s) { return make_float2(a.x * s, a.y * s); }

__device__ __forceinline__ float2 conj2(float2 a) { return make_float2(a.x, -a.y); }

// 1/p as conj(p)/|p|^2, the TPU kernel's form of the pivot inverse
__device__ __forceinline__ float2 recip(float2 p) {
  const float d = __frcp_rn(p.x * p.x + p.y * p.y);  // 1 / |p|^2, rounded as 1.f / x is
  return make_float2(p.x * d, -p.y * d);
}

// a -= m * b, as four FMAs (written as a -= (m.x b.x - m.y b.y), the
// compiler keeps the product's rounding and issues six instructions)
__device__ __forceinline__ void sub_mul(float2& a, float2 m, float2 b) {
  a.x = fmaf(-m.x, b.x, a.x);
  a.x = fmaf(m.y, b.y, a.x);
  a.y = fmaf(-m.x, b.y, a.y);
  a.y = fmaf(-m.y, b.x, a.y);
}

// a -= m * conj(b)
__device__ __forceinline__ void sub_mul_conj(float2& a, float2 m, float2 b) {
  a.x = fmaf(-m.x, b.x, a.x);
  a.x = fmaf(-m.y, b.y, a.x);
  a.y = fmaf(m.x, b.y, a.y);
  a.y = fmaf(-m.y, b.x, a.y);
}

__device__ __forceinline__ float2 shfl(float2 v, int lane) {
  return make_float2(__shfl_sync(0xffffffffu, v.x, lane), __shfl_sync(0xffffffffu, v.y, lane));
}

// The tiles a thread keeps: LU all of them; LL^H those on and below the
// diagonal, and the last column of tiles (the right-hand side's).
template <bool CHOL>
__host__ __device__ constexpr bool kept(int a, int b) {
  return !CHOL || b <= a || b == LAST;
}

// Step j = G * JB + jj of LU.
template <int JB>
__device__ __forceinline__ void lu_step(float2 (&A)[TILES][TILES], Smem& s, int j, int jj, int r,
                                        int c) {
  // the pivot A[j][j] is thread (jj, jj)'s tile (JB, JB); shuffled in every warp,
  // used in warp jj / 4, which holds column j
  const float2 p = shfl(A[JB][JB], (G + 1) * jj % 32);
  float2* col = s.col[j & 1];
  // what the update reads: tiles JB on; in tile JB the entries up to the
  // pivot are zero
  if (c == jj) {
    const float2 inv = recip(p);
    if (r == 0) s.piv[j] = inv;
    col[G * JB + r] = r > jj ? cmul(A[JB][JB], inv) : zero2();
#pragma unroll
    for (int a = JB + 1; a < TILES; ++a) col[G * a + r] = cmul(A[a][JB], inv);
  }
  if (r == jj) {
    s.f[j][G * JB + c] = c > jj ? A[JB][JB] : zero2();
#pragma unroll
    for (int b = JB + 1; b < TILES; ++b) s.f[j][G * b + c] = A[JB][b];
  }
  __syncthreads();
  float2 l[TILES];
#pragma unroll
  for (int a = JB; a < TILES; ++a) l[a] = col[G * a + r];
#pragma unroll
  for (int b = JB; b < TILES; ++b) {
    if (b == JB && jj >= (c | 3)) continue;  // the warp's columns of tile JB: all <= j
    const float2 u = s.f[j][G * b + c];
#pragma unroll
    for (int a = JB; a < TILES; ++a) sub_mul(A[a][b], l[a], u);
  }
}

// Step j = G * JB + jj of LL^H.
template <int JB>
__device__ __forceinline__ void chol_step(float2 (&A)[TILES][TILES], Smem& s, int j, int jj, int r,
                                          int c) {
  const float2 p = shfl(A[JB][JB], (G + 1) * jj % 32);
  float2* col = s.f[j];
  if (c == jj) {
    const float d = rsqrtf(p.x);  // the pivot is real and positive
    if (r == 0) s.d[j] = d;
    col[G * JB + r] = r > jj ? scale(A[JB][JB], d) : zero2();
#pragma unroll
    for (int a = JB + 1; a < TILES; ++a) col[G * a + r] = scale(A[a][JB], d);
  }
  if (r == jj && c == RHS_C) s.b[j] = A[JB][LAST];
  __syncthreads();
  float2 l[TILES];
#pragma unroll
  for (int a = JB; a < TILES; ++a) l[a] = col[G * a + r];
#pragma unroll
  for (int b = JB; b < LAST; ++b) {
    if (b == JB && jj >= (c | 3)) continue;  // the warp's columns of tile JB: all <= j
    const float2 lk = col[G * b + c];
#pragma unroll
    for (int a = b; a < TILES; ++a) sub_mul_conj(A[a][b], l[a], lk);
  }
  if (c >= G / 2) {
    // warp 1 holds columns 52..55 of the last tile column: the right-hand
    // side (c = RHS_C) takes b_i -= L[i][j] y_j on every row
    const float2 v = c == RHS_C ? scale(s.b[j], s.d[j]) : conj2(col[G * LAST + c]);
#pragma unroll
    for (int a = JB; a < TILES; ++a) sub_mul(A[a][LAST], l[a], v);
  } else {
    sub_mul_conj(A[LAST][LAST], l[LAST], col[G * LAST + c]);
  }
}

// The factorization, one block of G steps (JB) at a time.
template <bool CHOL, int JB>
__device__ __forceinline__ void factor(float2 (&A)[TILES][TILES], Smem& s, int r, int c) {
  constexpr int steps = JB < LAST ? G : N - G * LAST;
#pragma unroll 1
  for (int jj = 0; jj < steps; ++jj) {
    if (CHOL)
      chol_step<JB>(A, s, G * JB + jj, jj, r, c);
    else
      lu_step<JB>(A, s, G * JB + jj, jj, r, c);
  }
  if constexpr (JB < LAST) factor<CHOL, JB + 1>(A, s, r, c);
}

// mat: u (S, N) when FUSED, else the systems (S, N, N); rhs (S, N); ow2
// (S,) when FUSED; z (S, N).  Complex values are interleaved float2, read
// and written 8 bytes at a time, so any 8-byte-aligned base will do.
template <bool FUSED, bool CHOL>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) mmse_solve_kernel(const float2* __restrict__ mat,
                                                             const float2* __restrict__ rhs,
                                                             const float* __restrict__ ow2,
                                                             float2* __restrict__ z) {
  __shared__ Smem s;
  const long long sys = blockIdx.x;
  const int tid = threadIdx.x, r = tid % G, c = tid / G;
  float2 A[TILES][TILES];
  if (FUSED) {
    if (tid < W) {
      s.u[tid] = tid < N ? mat[sys * N + tid] : zero2();
      s.rx[tid] = tid < N ? rhs[sys * N + tid] : zero2();
    }
    __syncthreads();
    const float sigma2 = ow2[sys];
#pragma unroll
    for (int a = 0; a < TILES; ++a) {
      const int i = G * a + r;
      const float2 ui = s.u[i];
#pragma unroll
      for (int b = 0; b < TILES; ++b) {
        if (!kept<CHOL>(a, b)) continue;
        const int k = G * b + c;
        if (k == N) {
          A[a][b] = s.rx[i];
        } else {
          // u_i conj(u_k), plus sigma^2 on the diagonal (zero past the padding)
          A[a][b] = cmul(ui, conj2(s.u[k]));
          if (i == k && i < N) A[a][b].x += sigma2;
        }
      }
    }
  } else {
    const float2* sys_a = mat + sys * (N * N);
#pragma unroll
    for (int a = 0; a < TILES; ++a) {
      const int i = G * a + r;
#pragma unroll
      for (int b = 0; b < TILES; ++b) {
        if (!kept<CHOL>(a, b)) continue;
        const int k = G * b + c;
        // LL^H's right-hand-side tiles above the diagonal hold only column N
        const bool load = i < N && k < N && (!CHOL || b <= a);
        A[a][b] = load ? sys_a[i * N + k] : (i < N && k == N) ? rhs[sys * N + i] : zero2();
      }
    }
  }
  factor<CHOL, 0>(A, s, r, c);
  __syncthreads();
  if (tid >= 32) return;
  // back substitution, one warp: lane t holds rows t and t + 32 of y; at
  // column j the owner of y_j shuffles it to every lane, which computes x_j
  // and takes U[i][j] x_j (LU) or conj(L[j][i]) x_j (LL^H) from its rows
  // above j.  s.f[i][j], j > i, is U[i][j] (row i of U) or L[j][i] (column
  // i of L).
  const int t = tid;
  auto y_of = [&](int i) {
    return CHOL ? scale(s.b[i], s.d[i]) : s.f[i][N];
  };
  auto x_of = [&](float2 yj, int j) { return CHOL ? scale(yj, s.d[j]) : cmul(yj, s.piv[j]); };
  // y -= (U[i][j] or conj(L[j][i])) x_j
  auto take = [&](float2& y, int i, int j, float2 xj) {
    sub_mul(y, CHOL ? conj2(s.f[i][j]) : s.f[i][j], xj);
  };
  float2 y0 = y_of(t), y1 = t + 32 < N ? y_of(t + 32) : zero2();
  float2 x0 = zero2(), x1 = zero2();
  // columns 52..32: y_j is lane j - 32's y1, and every lane's row t < j
#pragma unroll 1
  for (int j = N - 1; j >= 32; --j) {
    const float2 xj = x_of(shfl(y1, j - 32), j);
    if (t == j - 32) x1 = xj;
    take(y0, t, j, xj);
    if (t + 32 < j) take(y1, t + 32, j, xj);
  }
#pragma unroll 1
  for (int j = 31; j >= 0; --j) {
    const float2 xj = x_of(shfl(y0, j), j);
    if (t == j) x0 = xj;
    if (t < j) take(y0, t, j, xj);
  }
  z[sys * N + t] = x0;
  if (t + 32 < N) z[sys * N + t + 32] = x1;
}

template <bool FUSED, bool CHOL>
cudaError_t launch(const void* mat, const void* rhs, const void* ow2, void* z, int batch,
                   cudaStream_t stream) {
  mmse_solve_kernel<FUSED, CHOL><<<batch, THREADS, 0, stream>>>(
      static_cast<const float2*>(mat), static_cast<const float2*>(rhs),
      static_cast<const float*>(ow2), static_cast<float2*>(z));
  return cudaGetLastError();
}

template <bool FUSED, bool CHOL>
cudaError_t attributes(int* out) {
  return ffi::occupancy(mmse_solve_kernel<FUSED, CHOL>, THREADS, 0, out);
}

}  // namespace

// One launch solves `batch` systems.  ptrs: mat, rhs, ow2, z.  ow2
// non-null selects the fused kernel (mat = u, (batch, 53)); ow2 null the
// dense one (mat = the systems, (batch, 53, 53)).  method: 0 gauss, 1 chol.
// Returns cudaGetLastError() after the launch.
extern "C" int mmse_solve_launch(const void* const* ptrs, int n_ptrs, int batch, int method,
                                 void* stream) {
  if (n_ptrs != 4 || batch <= 0 || ptrs[0] == nullptr || ptrs[1] == nullptr ||
      ptrs[3] == nullptr || (method != 0 && method != 1))
    return cudaErrorInvalidValue;
  const void *mat = ptrs[0], *rhs = ptrs[1], *ow2 = ptrs[2];
  void* z = const_cast<void*>(ptrs[3]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ow2 != nullptr)
    return method ? launch<true, true>(mat, rhs, ow2, z, batch, st)
                  : launch<true, false>(mat, rhs, ow2, z, batch, st);
  return method ? launch<false, true>(mat, rhs, nullptr, z, batch, st)
                : launch<false, false>(mat, rhs, nullptr, z, batch, st);
}

// The compiled kernel of one instantiation (fused 0/1, method 0 gauss / 1
// chol): out = {registers a thread, local (spill) bytes a thread, static
// shared bytes a block, resident blocks (= systems) per SM}.
extern "C" int mmse_solve_attributes(int fused, int method, int* out) {
  if (out == nullptr || (method != 0 && method != 1)) return cudaErrorInvalidValue;
  if (fused) return method ? attributes<true, true>(out) : attributes<true, false>(out);
  return method ? attributes<false, true>(out) : attributes<false, false>(out);
}
