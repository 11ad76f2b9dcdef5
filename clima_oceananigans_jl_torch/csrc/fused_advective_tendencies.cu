// Fused advective tendencies of the nonhydrostatic model: for every
// prognostic field psi in {u, v, w, tracers}, G = -div(v psi), written into
// the interior of a with-halo output (the caller allocates it zeroed).
//
// Replaces the TPU kernel clima_oceananigans_jl_tpu/ops/fused_tendencies.py::
// fused_advective_tendencies. It computes what that kernel computes, in the
// expression trees of the port's plain version
// (ops/fused_tendencies.py::fused_advective_tendencies_reference, the
// div_vu / div_vv / div_vw / div_Uc of advection/fluxes.py); the flux code
// is weno5_advection.cuh, shared with the fused AB2 advance. Momentum and
// tracers each take WENO5 or CenteredSecondOrder; bounded z reduces WENO5's
// order near the walls through the with-halo bounds of reduced_order_masks.
//
// On a bounded z axis the kernel also writes G_w at w's top wall face
// (with-halo z index hz+nz), which lies in the z halo. A w wall that is not
// an imposed value (FluxBC) leaves that face to the time step, so G_w there
// must be what the whole-array stencil of the plain version gives, as the
// JAX kernel keeps it when its blocks carry z halos. One extra thread per
// (i, j) column, past the interior's threads, computes it, so no warp of
// the interior carries the extra work.
//
// What bounds it on an H100: memory. At 256^3 fp32 with u, v, w, b it reads
// four with-halo fields (4 x 72 MB) and writes four interiors (4 x 67 MB):
// about 0.56 GB, at least 0.17 ms at 3.35 TB/s if each byte moves once.
// The function needs 12 WENO5 transports of ~64 flops per point (three faces
// for each of four fields) and the divergences, ~800 flops: 0.20 ms at the
// 67 TFLOP/s fp32 peak, which bounds it; the kernel computes each face in
// both cells beside it, 24 per point.
//
// The design is the simple one, as in K1: one thread per interior point,
// k (the contiguous axis) across the threads of a warp, neighbours read
// from global memory through L1/L2, each face flux computed by both cells
// beside it. Shared-memory or TMA tiling and flux reuse are later work.
#include <cuda_runtime.h>

#include "weno5_advection.cuh"

template <typename T>
struct TendencyArgs {
  Advection<T> adv;
  T* out[MAX_FIELDS];  // with-halo G, interior written
  int w_top;           // bounded z: also G_w at the top wall face
};

// div_vw at the top wall face P (with-halo z index hz+nz). Both z fluxes
// are centred there: WENO5's near-wall reduction falls back to the centred
// mean, as does the centred scheme. The centre above the face is z index
// hz+nz+1, which wraps to 0 when hz == 1, as torch.roll wraps it in the
// plain version.
template <typename T>
__device__ __forceinline__ T div_vw_top(const Advection<T>& A, const Point& P) {
  const T* __restrict__ u = A.psi[0];
  const T* __restrict__ v = A.psi[1];
  const T* __restrict__ w = A.psi[2];
  const int64_t o = P.o, sx = P.sx, sy = P.sy, sz = 1;
  const int64_t up = P.K + 1 < A.nz + 2 * A.hz ? sz : -(int64_t)P.K;
  const bool we = A.weno_m != 0;
  const T eps = A.eps_m, half = T(0.5);
  const T Ax = A.dy * A.dz, Ay = A.dx * A.dz, Az = A.dx * A.dy;
  const T fxR = Ax * transport(w, o + sx, sx, half * (u[o + sx] + u[o + sx - sz]), we, eps, false, 0, A);
  const T fxL = Ax * transport(w, o, sx, half * (u[o] + u[o - sz]), we, eps, false, 0, A);
  const T fyR = Ay * transport(w, o + sy, sy, half * (v[o + sy] + v[o + sy - sz]), we, eps, false, 0, A);
  const T fyL = Ay * transport(w, o, sy, half * (v[o] + v[o - sz]), we, eps, false, 0, A);
  const T wR = half * (w[o + up] + w[o]), wL = half * (w[o] + w[o - sz]);
  const T fzR = Az * (wR * wR);
  const T fzL = Az * (wL * wL);
  return flux_divergence(fxR, fxL, fyR, fyL, fzR, fzL, A);
}

// Thread P.p past the interior's nx*ny*nz threads: the point of w's top
// wall face in column P.p - nx*ny*nz; false past the last column.
template <typename T>
__device__ __forceinline__ bool top_face_point(const Advection<T>& A, Point& P) {
  const int64_t q = P.p - (int64_t)A.nx * A.ny * A.nz;
  if (q >= (int64_t)A.nx * A.ny) return false;
  const int j = (int)(q % A.ny), i = (int)(q / A.ny);
  const int Y = A.ny + 2 * A.hy, Z = A.nz + 2 * A.hz;
  P.sy = Z;
  P.sx = (int64_t)Y * Z;
  P.J = j + A.hy;
  P.K = A.hz + A.nz;
  P.o = (i + A.hx) * P.sx + P.J * P.sy + P.K;
  return true;
}

template <typename T>
__global__ void __launch_bounds__(256)
fused_advective_tendencies_kernel(const TendencyArgs<T> A) {
  Point P;
  if (interior_point(A.adv, P)) {
    A.out[0][P.o] = -div_vu(A.adv, P);
    A.out[1][P.o] = -div_vv(A.adv, P);
    A.out[2][P.o] = -div_vw(A.adv, P);
    for (int f = 3; f < A.adv.nf; ++f) A.out[f][P.o] = -div_Uc(A.adv, P, f);
  } else if (A.w_top && top_face_point(A.adv, P)) {
    A.out[2][P.o] = -div_vw_top(A.adv, P);
  }
}

template <typename T>
static int launch(const void* const* psi, void* const* out, int nf, int nx,
                  int ny, int nz, int hx, int hy, int hz, int weno_m,
                  int weno_t, int z_masks, int lo_l, int hi_l, int lo_r,
                  int hi_r, double eps_m, double eps_t, double dx, double dy,
                  double dz, int w_top, void* stream) {
  TendencyArgs<T> A;
  if (!set_advection(A.adv, psi, nf, nx, ny, nz, hx, hy, hz, weno_m, weno_t,
                     z_masks, lo_l, hi_l, lo_r, hi_r, eps_m, eps_t, dx, dy, dz))
    return (int)cudaErrorInvalidValue;
  for (int f = 0; f < MAX_FIELDS; ++f)
    A.out[f] = f < nf ? static_cast<T*>(out[f]) : nullptr;
  A.w_top = w_top;
  const int64_t n = (int64_t)nx * ny * nz;
  if (n == 0) return 0;
  const int64_t total = n + (w_top ? (int64_t)nx * ny : 0);
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  fused_advective_tendencies_kernel<T><<<(unsigned int)blocks, threads, 0,
                                         static_cast<cudaStream_t>(stream)>>>(A);
  return (int)cudaGetLastError();
}

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). `psi` and
// `out` are host arrays of nf device pointers; `w_top` (bounded z) also
// writes G_w at w's top wall face.
int fused_advective_tendencies_f32(const void* const* psi, void* const* out,
                                   int nf, int nx, int ny, int nz, int hx,
                                   int hy, int hz, int weno_m, int weno_t,
                                   int z_masks, int lo_l, int hi_l, int lo_r,
                                   int hi_r, double eps_m, double eps_t,
                                   double dx, double dy, double dz,
                                   int w_top, void* stream) {
  return launch<float>(psi, out, nf, nx, ny, nz, hx, hy, hz, weno_m, weno_t,
                       z_masks, lo_l, hi_l, lo_r, hi_r, eps_m, eps_t, dx, dy,
                       dz, w_top, stream);
}

int fused_advective_tendencies_f64(const void* const* psi, void* const* out,
                                   int nf, int nx, int ny, int nz, int hx,
                                   int hy, int hz, int weno_m, int weno_t,
                                   int z_masks, int lo_l, int hi_l, int lo_r,
                                   int hi_r, double eps_m, double eps_t,
                                   double dx, double dy, double dz,
                                   int w_top, void* stream) {
  return launch<double>(psi, out, nf, nx, ny, nz, hx, hy, hz, weno_m, weno_t,
                        z_masks, lo_l, hi_l, lo_r, hi_r, eps_m, eps_t, dx, dy,
                        dz, w_top, stream);
}

}  // extern "C"
