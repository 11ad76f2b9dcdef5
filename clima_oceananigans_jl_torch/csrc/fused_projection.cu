// The general pressure projection's two stencils (the projection the
// nonhydrostatic model takes when its w walls are not imposed values):
//
//   fused_divergence (K3b): div_ccc(u, v, w) at every interior cell centre,
//     ((dxc(Ax u) + dyc(Ay v)) + dzc(Az w)) / V, into an (nx, ny, nz)
//     output;
//   fused_pressure_gradient (K3c): (dxf(p)/dx, dyf(p)/dy, dzf(p)/dz) on
//     the u, v, w faces of every interior point, into three with-halo
//     outputs (the caller allocates them zeroed). The wall-face gz reads
//     the halo that the pressure fill mirrors, so p's halos must be filled.
//
// Replace the TPU kernel clima_oceananigans_jl_tpu/ops/fused_tendencies.py::
// pallas_fuse as the nonhydrostatic model's _project_velocities_general calls
// it (models/nonhydrostatic.py:583 and :597), in the expression trees of the
// port's plain versions (ops/fused_tendencies.py::fused_divergence_reference,
// fused_pressure_gradient_reference): the metric products dy*dz, dx*dz,
// dx*dy and (dx*dy)*dz in the field's type, IEEE division.
//
// What bounds them on an H100: memory, and nothing else. At 256^3 fp32 K3b
// reads three with-halo fields (3 x 72 MB) and writes one interior (67 MB),
// ~0.28 GB, 0.08 ms at 3.35 TB/s; K3c reads one and writes three with-halo
// fields (with their zero fill), ~0.5 GB, 0.15 ms. A few flops a point.
//
// One thread per interior point, k (the contiguous axis) across a warp;
// the neighbour reads hit L1/L2.
#include <cuda_runtime.h>
#include <stdint.h>

struct Shape3 {
  int nx, ny, nz, hx, hy, hz;
};

// Interior point p (k contiguous) → with-halo offset, and the strides.
__device__ __forceinline__ bool interior_offset(const Shape3& S, int64_t& o,
                                                int64_t& sx, int64_t& sy,
                                                int64_t& p) {
  const int64_t n = (int64_t)S.nx * S.ny * S.nz;
  p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return false;
  const int k = (int)(p % S.nz);
  const int j = (int)((p / S.nz) % S.ny);
  const int i = (int)(p / ((int64_t)S.nz * S.ny));
  sy = S.nz + 2 * S.hz;
  sx = (int64_t)(S.ny + 2 * S.hy) * sy;
  o = (i + S.hx) * sx + (j + S.hy) * sy + (k + S.hz);
  return true;
}

template <typename T>
__global__ void __launch_bounds__(256)
divergence_kernel(const T* __restrict__ u, const T* __restrict__ v,
                  const T* __restrict__ w, T* __restrict__ out, const Shape3 S,
                  const T dx, const T dy, const T dz) {
  int64_t o, sx, sy, p;
  if (!interior_offset(S, o, sx, sy, p)) return;
  const T Ax = dy * dz, Ay = dx * dz, Az = dx * dy, V = dx * dy * dz;
  out[p] = (((Ax * u[o + sx] - Ax * u[o]) + (Ay * v[o + sy] - Ay * v[o]))
            + (Az * w[o + 1] - Az * w[o])) / V;
}

template <typename T>
__global__ void __launch_bounds__(256)
pressure_gradient_kernel(const T* __restrict__ pr, T* __restrict__ gx,
                         T* __restrict__ gy, T* __restrict__ gz,
                         const Shape3 S, const T dx, const T dy, const T dz) {
  int64_t o, sx, sy, p;
  if (!interior_offset(S, o, sx, sy, p)) return;
  const T c = pr[o];
  gx[o] = (c - pr[o - sx]) / dx;
  gy[o] = (c - pr[o - sy]) / dy;
  gz[o] = (c - pr[o - 1]) / dz;
}

static bool blocks_for(const Shape3& S, int64_t& blocks) {
  const int64_t n = (int64_t)S.nx * S.ny * S.nz;
  blocks = (n + 255) / 256;
  return n > 0;
}

template <typename T>
static int divergence(const void* u, const void* v, const void* w, void* out,
                      int nx, int ny, int nz, int hx, int hy, int hz,
                      double dx, double dy, double dz, void* stream) {
  const Shape3 S{nx, ny, nz, hx, hy, hz};
  int64_t blocks;
  if (!blocks_for(S, blocks)) return 0;
  divergence_kernel<T><<<(unsigned int)blocks, 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(v),
      static_cast<const T*>(w), static_cast<T*>(out), S, T(dx), T(dy), T(dz));
  return (int)cudaGetLastError();
}

template <typename T>
static int pressure_gradient(const void* pr, void* gx, void* gy, void* gz,
                             int nx, int ny, int nz, int hx, int hy, int hz,
                             double dx, double dy, double dz, void* stream) {
  const Shape3 S{nx, ny, nz, hx, hy, hz};
  int64_t blocks;
  if (!blocks_for(S, blocks)) return 0;
  pressure_gradient_kernel<T><<<(unsigned int)blocks, 256, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(pr), static_cast<T*>(gx), static_cast<T*>(gy),
      static_cast<T*>(gz), S, T(dx), T(dy), T(dz));
  return (int)cudaGetLastError();
}

extern "C" {

// Each returns cudaGetLastError() after the launch (0 on success); all
// pointers are device pointers.
int fused_divergence_f32(const void* u, const void* v, const void* w,
                         void* out, int nx, int ny, int nz, int hx, int hy,
                         int hz, double dx, double dy, double dz,
                         void* stream) {
  return divergence<float>(u, v, w, out, nx, ny, nz, hx, hy, hz, dx, dy, dz,
                           stream);
}

int fused_divergence_f64(const void* u, const void* v, const void* w,
                         void* out, int nx, int ny, int nz, int hx, int hy,
                         int hz, double dx, double dy, double dz,
                         void* stream) {
  return divergence<double>(u, v, w, out, nx, ny, nz, hx, hy, hz, dx, dy, dz,
                            stream);
}

int fused_pressure_gradient_f32(const void* pr, void* gx, void* gy, void* gz,
                                int nx, int ny, int nz, int hx, int hy,
                                int hz, double dx, double dy, double dz,
                                void* stream) {
  return pressure_gradient<float>(pr, gx, gy, gz, nx, ny, nz, hx, hy, hz, dx,
                                  dy, dz, stream);
}

int fused_pressure_gradient_f64(const void* pr, void* gx, void* gy, void* gz,
                                int nx, int ny, int nz, int hx, int hy,
                                int hz, double dx, double dy, double dz,
                                void* stream) {
  return pressure_gradient<double>(pr, gx, gy, gz, nx, ny, nz, hx, hy, hz, dx,
                                   dy, dz, stream);
}

}  // extern "C"
