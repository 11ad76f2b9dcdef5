// The general pressure projection's two stencils (the projection the
// nonhydrostatic model takes when its w walls are not imposed values):
//
//   fused_divergence (K3b): div_ccc(u, v, w) at every interior cell centre,
//     ((dxc(Ax u) + dyc(Ay v)) + dzc(Az w)) / V, into an (nx, ny, nz)
//     output;
//   fused_pressure_gradient (K3c): (dxf(p)/dx, dyf(p)/dy, dzf(p)/dz) on
//     the u, v, w faces of every interior point, into three with-halo
//     outputs whose halo points it sets to zero. The wall-face gz reads
//     the halo that the pressure fill mirrors, so p's halos must be filled.
//
// Replace the TPU kernel clima_oceananigans_jl_tpu/ops/fused_tendencies.py::
// pallas_fuse as the nonhydrostatic model's _project_velocities_general calls
// it (models/nonhydrostatic.py:583 and :597), in the expression trees of the
// port's plain versions (ops/fused_tendencies.py::fused_divergence_reference,
// fused_pressure_gradient_reference): the metric products dy*dz, dx*dz,
// dx*dy and (dx*dy)*dz in the field's type, IEEE division. Bounded axes
// need nothing of their own: the stencils read the filled halos and wall
// faces as the whole-array ones do. A Flat axis (extent 1, no halo) has
// neighbour stride 0, so its difference reads the cell itself, as
// torch.roll does on an axis of length 1 (+0 for a finite field); the host
// moves it to y (ops/fused_tendencies.py::kernel_order), which keeps the
// offsets of every point, so that the columns of K3c run along an axis
// that is not Flat, and the divergence's sum in that order has the plain
// version's bits (weno5_advection.cuh).
//
// What bounds them on an H100: memory, and nothing else. At 256^3 fp32 K3b
// reads three with-halo fields (3 x 72 MB) and writes one interior (67 MB),
// ~0.28 GB, 0.08 ms at 3.35 TB/s; K3c reads one with-halo field and writes
// three, halos included, ~0.29 GB, 0.086 ms. A few flops a point.
//
// K3b: one thread per interior point, k (the contiguous axis) across a
// warp; the neighbour reads hit L1/L2.
//
// K3c: a block of 4 warps owns 4 consecutive with-halo y columns of one x
// index (blockIdx.x the columns, blockIdx.y the x index), a warp a column
// with its lanes on consecutive k (8 chunks of 32 levels in flight at
// once), and writes the whole with-halo columns of gx, gy and gz: zeros on
// the halo points, (c - p[-s]) / d on the interior. Index math is 32-bit
// from the launch grid; the offsets are 64-bit. p's neighbours at j - 1
// and i - 1 were read by the warp beside it or by the blocks just before
// it, so they come from L1 or L2 and p is read from memory about once. At
// 256^3 fp32 it takes ~0.12 ms, where zeroing the three outputs alone takes
// 0.067 and copying p 0.050 (chip_breakdown.py k6-k3c). The earlier kernel
// (a flat 64-bit index, three 64-bit divisions a thread, and outputs
// zero-filled by the wrapper with torch.zeros before it ran: 216 MB more
// writes) took 0.22 ms. Of the block shapes timed (4 to 16 columns, 1 to 8
// chunks), 4 columns at 8 chunks was the fastest (PERF.md).
// Division goes through ieee_div_by: a zero numerator (every gz on the
// bottom wall face, whose halo mirrors it) returns before dividing, which
// is IEEE's own +-0 for the positive spacings.
#include <cuda_runtime.h>
#include <stdint.h>

#include "weno5_advection.cuh"

struct Shape3 {
  int nx, ny, nz, hx, hy, hz;
  int64_t sx, sy, sz;  // K3b's neighbour strides: 0 along a Flat axis
};

static Shape3 shape3(int nx, int ny, int nz, int hx, int hy, int hz) {
  const int64_t ry = nz + 2 * hz, rx = (int64_t)(ny + 2 * hy) * ry;
  return Shape3{nx, ny, nz, hx, hy, hz, nx + 2 * hx == 1 ? 0 : rx,
                ny + 2 * hy == 1 ? 0 : ry, nz + 2 * hz == 1 ? 0 : 1};
}

// Interior point p (k contiguous) → with-halo offset.
__device__ __forceinline__ bool interior_offset(const Shape3& S, int64_t& o,
                                                int64_t& p) {
  const int64_t n = (int64_t)S.nx * S.ny * S.nz;
  p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return false;
  const int k = (int)(p % S.nz);
  const int j = (int)((p / S.nz) % S.ny);
  const int i = (int)(p / ((int64_t)S.nz * S.ny));
  const int64_t ry = S.nz + 2 * S.hz, rx = (int64_t)(S.ny + 2 * S.hy) * ry;
  o = (i + S.hx) * rx + (j + S.hy) * ry + (k + S.hz);
  return true;
}

template <typename T>
__global__ void __launch_bounds__(256)
divergence_kernel(const T* __restrict__ u, const T* __restrict__ v,
                  const T* __restrict__ w, T* __restrict__ out, const Shape3 S,
                  const T dx, const T dy, const T dz) {
  int64_t o, p;
  if (!interior_offset(S, o, p)) return;
  const T Ax = dy * dz, Ay = dx * dz, Az = dx * dy, V = dx * dy * dz;
  out[p] = (((Ax * u[o + S.sx] - Ax * u[o]) + (Ay * v[o + S.sy] - Ay * v[o]))
            + (Az * w[o + S.sz] - Az * w[o])) / V;
}

// K3c's block: GRADIENT_ROWS columns, a warp each; a warp takes
// GRADIENT_CHUNKS chunks of 32 levels of its column at once, the loads of
// all of them before their stores.
constexpr int GRADIENT_ROWS = 4, GRADIENT_CHUNKS = 8;

template <typename T>
__global__ void __launch_bounds__(32 * GRADIENT_ROWS)
pressure_gradient_kernel(const T* __restrict__ pr, T* __restrict__ gx,
                         T* __restrict__ gy, T* __restrict__ gz,
                         const Shape3 S, const T dx, const T dy, const T dz) {
  const int X = S.nx + 2 * S.hx, Y = S.ny + 2 * S.hy, Z = S.nz + 2 * S.hz;
  const int j = blockIdx.x * blockDim.y + threadIdx.y;
  if (j >= Y) return;
  const int64_t ry = Z, rx = (int64_t)Y * Z;
  // neighbour strides, 0 along a Flat axis
  const int64_t sx = X == 1 ? 0 : rx, sy = Y == 1 ? 0 : ry, sz = Z == 1 ? 0 : 1;
  const bool jin = j >= S.hy && j < S.hy + S.ny;
  for (int i = blockIdx.y; i < X; i += gridDim.y) {
    const bool in = jin && i >= S.hx && i < S.hx + S.nx;
    const int64_t col = i * rx + j * ry;
    for (int k0 = threadIdx.x; k0 < Z; k0 += 32 * GRADIENT_CHUNKS) {
      // p at x - 1 and at x on the whole column, outside the interior
      // test, so that the loads of all chunks go out together
      T prev[GRADIENT_CHUNKS], a[GRADIENT_CHUNKS], b[GRADIENT_CHUNKS],
          c[GRADIENT_CHUNKS];
#pragma unroll
      for (int u = 0; u < GRADIENT_CHUNKS; ++u) {
        const int k = k0 + 32 * u;
        prev[u] = jin && (i > 0 || X == 1) && k < Z ? pr[col + k - sx] : T(0);
      }
#pragma unroll
      for (int u = 0; u < GRADIENT_CHUNKS; ++u) {
        const int k = k0 + 32 * u;
        const T p = jin && k < Z ? pr[col + k] : T(0);
        a[u] = b[u] = c[u] = T(0);
        if (in && k >= S.hz && k < S.hz + S.nz) {
          a[u] = ieee_div_by(p - prev[u], dx);
          b[u] = ieee_div_by(p - pr[col + k - sy], dy);
          c[u] = ieee_div_by(p - pr[col + k - sz], dz);
        }
      }
#pragma unroll
      for (int u = 0; u < GRADIENT_CHUNKS; ++u) {
        const int k = k0 + 32 * u;
        if (k < Z) {
          gx[col + k] = a[u];
          gy[col + k] = b[u];
          gz[col + k] = c[u];
        }
      }
    }
  }
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
  const Shape3 S = shape3(nx, ny, nz, hx, hy, hz);
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
  const Shape3 S = shape3(nx, ny, nz, hx, hy, hz);
  const int X = nx + 2 * hx, Y = ny + 2 * hy;
  if ((int64_t)X * Y * (nz + 2 * hz) == 0) return 0;
  const dim3 grid((Y + GRADIENT_ROWS - 1) / GRADIENT_ROWS, X < 65535 ? X : 65535),
      block(32, GRADIENT_ROWS);
  pressure_gradient_kernel<T><<<grid, block, 0,
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
