// Batched tridiagonal (Thomas) solve along z (T1): for every column of a
// (ncol, nz) right-hand side d, with z the fastest axis,
//
//   denom = b[k] - a[k] cp[k-1],  cp[k] = c[k] / denom,
//   dp[k] = (d[k] - a[k] dp[k-1]) / denom,  phi[k] = dp[k] - cp[k] phi[k+1]
//
// (cp[-1] = dp[-1] = phi[nz] = 0), in the expression trees of the port's
// plain version (solvers/tridiagonal.py::solve_batched_tridiagonal_reference)
// and of the JAX function it follows,
// clima_oceananigans_jl_tpu/solvers/tridiagonal.py::solve_batched_tridiagonal,
// which runs the two sweeps as lax.scans over (Nx, Ny) planes (the TPU has no
// Pallas kernel for it). Each band is 1D (nz values, shared by every column)
// or 3D (ncol x nz). A complex right-hand side comes as interleaved (re, im)
// pairs (NV = 2): both parts share denom and cp, as the plain version's two
// real solves compute them.
//
// The Fourier mode (FOURIER) forms the bands of the Fourier-tridiagonal
// pressure solve (solvers/fourier_tridiagonal.py) in the kernel, in the plain
// version's trees: for mode (i, j) of a (nx', ny') spectrum, lam_h =
// (lam_x[i] + lam_y[j]) - m, a = lower[k], c = upper[k], b = -(lower[k] +
// upper[k]) - lam_h dzc[k] and d = rhs dzc[k]; with `pin`, the first row of
// mode (0, 0) becomes phi = 0 (b = 1, c = 0, d = 0).
//
// Every division is ieee_div (weno5_advection.cuh): IEEE's own quotient,
// off the slow path. Build with --fmad=false so that b - a cp stays two
// roundings, as eager PyTorch computes it.
//
// What bounds it on an H100: at 256 x 129 x 256 complex64 (the 256^3
// pressure solve after a real FFT on x) it must read d (67.6 MB) and write
// phi (67.6 MB): 0.04 ms at 3.35 TB/s; ~8 operations a point and part are
// far below the card's rate. In practice it is bound by latency: one thread
// a column carries a serial chain of two dependent divisions a level, and
// the forward sweep writes cp (scratch) and dp (into phi), which the back
// sweep reads again. With z fastest, the 32 lanes of a warp read 32
// different columns, so every load of a level touches 32 cache lines; the
// next levels of a column come from the same lines while they stay in L1.
// Staging a warp's columns in shared memory is left for a later change.
#include <cuda_runtime.h>
#include <stdint.h>

#include "weno5_advection.cuh"

template <typename T>
struct TriArgs {
  const T* a;    // lower band (Fourier mode: `lower`, 1D)
  const T* b;    // diagonal (unused in the Fourier mode)
  const T* c;    // upper band (Fourier mode: `upper`, 1D)
  int a3, b3, c3;  // band is 3D (ncol x nz) rather than 1D (nz)
  const T* d;    // right-hand side, ncol x nz x NV
  T* out;        // phi, ncol x nz x NV (dp after the forward sweep)
  T* cp;         // scratch, ncol x nz
  int64_t ncol;
  int nz;
  // the Fourier mode
  const T* lx;   // lam_x, nx' values
  const T* ly;   // lam_y, ny' values
  const T* dzc;  // cell widths, nz values
  T m;
  int ny, pin;
};

constexpr int T1_THREADS = 128;

template <typename T, int NV, bool FOURIER>
__global__ void __launch_bounds__(T1_THREADS)
batched_tridiagonal_kernel(const __grid_constant__ TriArgs<T> A) {
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= A.ncol) return;
  const int nz = A.nz;
  const int64_t base = col * nz;
  T lh = T(0);
  bool pin0 = false;
  if (FOURIER) {
    const int64_t i = col / A.ny, j = col - i * A.ny;
    lh = (A.lx[i] + A.ly[j]) - A.m;
    pin0 = A.pin && i == 0 && j == 0;
  }
  T cpp = T(0), dpp[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) dpp[v] = T(0);
  for (int k = 0; k < nz; ++k) {
    const int64_t p = base + k;
    T a, b, c, d[NV];
    if (FOURIER) {
      const T lo = A.a[k], up = A.c[k], dz = A.dzc[k];
      const bool pinned = pin0 && k == 0;
      a = lo;
      b = pinned ? T(1) : -(lo + up) - lh * dz;
      c = pinned ? T(0) : up;
#pragma unroll
      for (int v = 0; v < NV; ++v) d[v] = pinned ? T(0) : A.d[p * NV + v] * dz;
    } else {
      a = A.a[A.a3 ? p : k];
      b = A.b[A.b3 ? p : k];
      c = A.c[A.c3 ? p : k];
#pragma unroll
      for (int v = 0; v < NV; ++v) d[v] = A.d[p * NV + v];
    }
    const T denom = b - a * cpp;
    cpp = ieee_div(c, denom);
    A.cp[p] = cpp;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      dpp[v] = ieee_div(d[v] - a * dpp[v], denom);
      A.out[p * NV + v] = dpp[v];
    }
  }
  T phi[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) phi[v] = T(0);
  for (int k = nz - 1; k >= 0; --k) {
    const int64_t p = base + k;
    const T cpk = A.cp[p];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      phi[v] = A.out[p * NV + v] - cpk * phi[v];
      A.out[p * NV + v] = phi[v];
    }
  }
}

template <typename T, int NV, bool FOURIER>
static int launch_nv(const TriArgs<T>& A, void* stream) {
  if (A.ncol <= 0 || A.nz <= 0) return 0;
  const unsigned blocks = (unsigned)((A.ncol + T1_THREADS - 1) / T1_THREADS);
  batched_tridiagonal_kernel<T, NV, FOURIER>
      <<<blocks, T1_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(A);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* a, const void* b, const void* c, int a3, int b3,
                  int c3, const void* d, void* out, void* cp, long long ncol,
                  int nz, int nv, void* stream) {
  if (nv != 1 && nv != 2) return (int)cudaErrorInvalidValue;
  TriArgs<T> A{};
  A.a = static_cast<const T*>(a);
  A.b = static_cast<const T*>(b);
  A.c = static_cast<const T*>(c);
  A.a3 = a3; A.b3 = b3; A.c3 = c3;
  A.d = static_cast<const T*>(d);
  A.out = static_cast<T*>(out);
  A.cp = static_cast<T*>(cp);
  A.ncol = ncol;
  A.nz = nz;
  return nv == 1 ? launch_nv<T, 1, false>(A, stream) : launch_nv<T, 2, false>(A, stream);
}

template <typename T>
static int launch_fourier(const void* lx, const void* ly, double m,
                          const void* lower, const void* upper,
                          const void* dzc, int pin, const void* d, void* out,
                          void* cp, int nx, int ny, int nz, int nv,
                          void* stream) {
  if (nv != 1 && nv != 2) return (int)cudaErrorInvalidValue;
  TriArgs<T> A{};
  A.a = static_cast<const T*>(lower);
  A.c = static_cast<const T*>(upper);
  A.d = static_cast<const T*>(d);
  A.out = static_cast<T*>(out);
  A.cp = static_cast<T*>(cp);
  A.ncol = (int64_t)nx * ny;
  A.nz = nz;
  A.lx = static_cast<const T*>(lx);
  A.ly = static_cast<const T*>(ly);
  A.dzc = static_cast<const T*>(dzc);
  A.m = T(m);
  A.ny = ny;
  A.pin = pin;
  return nv == 1 ? launch_nv<T, 1, true>(A, stream) : launch_nv<T, 2, true>(A, stream);
}

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). Device
// pointers: bands a, b, c (1D of nz, or 3D of ncol x nz where a3/b3/c3),
// d and out (ncol x nz x nv, nv = 2 for interleaved complex pairs), cp
// (scratch, ncol x nz).
#define BATCHED_TRIDIAGONAL(NAME, T)                                           \
  int NAME(const void* a, const void* b, const void* c, int a3, int b3,        \
           int c3, const void* d, void* out, void* cp, long long ncol, int nz, \
           int nv, void* stream) {                                             \
    return launch<T>(a, b, c, a3, b3, c3, d, out, cp, ncol, nz, nv, stream);   \
  }

BATCHED_TRIDIAGONAL(batched_tridiagonal_f32, float)
BATCHED_TRIDIAGONAL(batched_tridiagonal_f64, double)

// The Fourier mode: lx (nx), ly (ny), lower, upper, dzc (nz) on the card,
// d and out (nx x ny x nz x nv), cp (nx x ny x nz).
#define FOURIER_TRIDIAGONAL(NAME, T)                                          \
  int NAME(const void* lx, const void* ly, double m, const void* lower,       \
           const void* upper, const void* dzc, int pin, const void* d,        \
           void* out, void* cp, int nx, int ny, int nz, int nv,               \
           void* stream) {                                                    \
    return launch_fourier<T>(lx, ly, m, lower, upper, dzc, pin, d, out, cp,   \
                             nx, ny, nz, nv, stream);                         \
  }

FOURIER_TRIDIAGONAL(fourier_tridiagonal_f32, float)
FOURIER_TRIDIAGONAL(fourier_tridiagonal_f64, double)

}  // extern "C"
