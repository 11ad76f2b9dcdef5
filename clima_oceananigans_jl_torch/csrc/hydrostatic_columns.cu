// w from continuity and the hydrostatic pressure anomaly pHY', column by
// column, for the hydrostatic model (K4a):
//
//   w(k+1) = -sum_{k' <= k} dz_c(k') * div_xy(u, v)(k')        (bottom-up)
//   pHY'(k) = -sum_{faces above k} izf(b) * dz_f                 (top-down)
//
// with div_xy = (dxc(Ax u) + dyc(Ay v)) / V, Ax = dy * dz, Ay = dx * dz,
// V = Az * dz: ops/operators.py::div_xy_ccc on x-constant metric rows
// (ops/metric_rows.py). Writes w on the interior faces above the bottom
// and pHY' on the interior centres of every interior (x, y) column into
// zeroed with-halo outputs; the caller fills the halos.
//
// Replaces the in-kernel w and pHY' of the TPU kernel
// clima_oceananigans_jl_tpu/ops/fused_hydrostatic.py::
// fused_hydrostatic_tendencies (_w_block l.346, _ph_block l.394), whose
// Hillis-Steele scans over a VMEM block become one serial loop per column
// here: each thread owns a column and sums level by level, in the order of
// the plain version (ops/fused_hydrostatic.py::
// hydrostatic_columns_reference), so the two are bitwise equal. Build with
// --fmad=false so the compiler forms no FMA that eager PyTorch does not.
//
// What bounds it on an H100: memory. At the 1/4 degree flagship
// (1446 x 606 x 30 with halos, fp32) it reads u, v and b (3 x 105 MB) and
// writes w and pHY' (2 x 105 MB): about 0.5 GB, 0.16 ms at 3.35 TB/s. The
// arithmetic is ~15 flops and a division per level. Consecutive threads
// take consecutive y columns, so a warp's loads of one level are strided by
// the column length (Z values apart): each 32-byte sector serves one value.
// Staging the columns of a block through shared memory would make the loads
// dense; that is later work.
#include <cuda_runtime.h>
#include <stdint.h>

// rows of ops/metric_rows.py: Y_ROWS and Z_ROWS
enum { DX_CF = 1, AZ_CC = 4, DY_C = 8 };
enum { DZ_C = 0, DZ_F = 1 };

template <typename T>
__global__ void __launch_bounds__(128)
hydrostatic_columns_kernel(const T* __restrict__ u, const T* __restrict__ v,
                           const T* __restrict__ b, const T* __restrict__ ys,
                           const T* __restrict__ zs, T* __restrict__ w,
                           T* __restrict__ ph, int nx, int ny, int nz, int hx,
                           int hy, int hz) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (int64_t)nx * ny) return;
  const int I = (int)(p / ny) + hx, J = (int)(p % ny) + hy;
  const int Y = ny + 2 * hy, Z = nz + 2 * hz;
  const int64_t sy = Z, sx = (int64_t)Y * Z;
  const int64_t col = I * sx + J * sy;
  const T* dx_cf = ys + DX_CF * Y;
  const T* az_cc = ys + AZ_CC * Y;
  const T* dy_c = ys + DY_C * Y;
  const T* dz_c = zs + DZ_C * Z;
  const T* dz_f = zs + DZ_F * Z;
  T acc = T(0);
  for (int K = hz; K < hz + nz; ++K) {
    const int64_t o = col + K;
    const T dz = dz_c[K];
    const T Ax = dy_c[J] * dz;
    const T AyR = dx_cf[J + 1] * dz, AyL = dx_cf[J] * dz;
    const T d = ((Ax * u[o + sx] - Ax * u[o]) + (AyR * v[o + sy] - AyL * v[o]))
                / (az_cc[J] * dz);
    const T incr = dz * d;
    acc = K == hz ? incr : acc + incr;
    w[o + 1] = -acc;
  }
  if (b == nullptr) return;
  for (int K = hz + nz - 1; K >= hz; --K) {
    const int64_t f = col + K + 1;  // the face above centre K
    const T S = (T(0.5) * (b[f] + b[f - 1])) * dz_f[K + 1];
    acc = K == hz + nz - 1 ? S : acc + S;
    ph[col + K] = -acc;
  }
}

template <typename T>
static int launch(const void* u, const void* v, const void* b, const void* ys,
                  const void* zs, void* w, void* ph, int nx, int ny, int nz,
                  int hx, int hy, int hz, void* stream) {
  if ((b == nullptr) != (ph == nullptr)) return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)nx * ny;
  if (n == 0) return 0;
  const int threads = 128;
  const int64_t blocks = (n + threads - 1) / threads;
  hydrostatic_columns_kernel<T><<<(unsigned int)blocks, threads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(v),
      static_cast<const T*>(b), static_cast<const T*>(ys),
      static_cast<const T*>(zs), static_cast<T*>(w), static_cast<T*>(ph), nx,
      ny, nz, hx, hy, hz);
  return (int)cudaGetLastError();
}

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). `b` and `ph`
// are both device pointers (pHY' too) or both null (w only).
#define HYDROSTATIC_COLUMNS(NAME, T)                                        \
  int NAME(const void* u, const void* v, const void* b, const void* ys,     \
           const void* zs, void* w, void* ph, int nx, int ny, int nz,       \
           int hx, int hy, int hz, void* stream) {                          \
    return launch<T>(u, v, b, ys, zs, w, ph, nx, ny, nz, hx, hy, hz,        \
                     stream);                                               \
  }

HYDROSTATIC_COLUMNS(hydrostatic_columns_f32, float)
HYDROSTATIC_COLUMNS(hydrostatic_columns_f64, double)

}  // extern "C"
