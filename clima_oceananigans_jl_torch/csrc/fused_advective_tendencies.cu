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
// What bounds it on an H100: memory. At 256^3 fp32 with u, v, w, b it reads
// four with-halo fields (4 x 72 MB) and writes four interiors (4 x 67 MB):
// about 0.56 GB, at least 0.17 ms at 3.35 TB/s if each byte moves once.
// The arithmetic is ~24 WENO5 reconstructions of ~50 flops per point.
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
};

template <typename T>
__global__ void __launch_bounds__(256)
fused_advective_tendencies_kernel(const TendencyArgs<T> A) {
  Point P;
  if (!interior_point(A.adv, P)) return;
  A.out[0][P.o] = -div_vu(A.adv, P);
  A.out[1][P.o] = -div_vv(A.adv, P);
  A.out[2][P.o] = -div_vw(A.adv, P);
  for (int f = 3; f < A.adv.nf; ++f) A.out[f][P.o] = -div_Uc(A.adv, P, f);
}

template <typename T>
static int launch(const void* const* psi, void* const* out, int nf, int nx,
                  int ny, int nz, int hx, int hy, int hz, int weno_m,
                  int weno_t, int z_masks, int lo_l, int hi_l, int lo_r,
                  int hi_r, double eps_m, double eps_t, double dx, double dy,
                  double dz, void* stream) {
  TendencyArgs<T> A;
  if (!set_advection(A.adv, psi, nf, nx, ny, nz, hx, hy, hz, weno_m, weno_t,
                     z_masks, lo_l, hi_l, lo_r, hi_r, eps_m, eps_t, dx, dy, dz))
    return (int)cudaErrorInvalidValue;
  for (int f = 0; f < MAX_FIELDS; ++f)
    A.out[f] = f < nf ? static_cast<T*>(out[f]) : nullptr;
  const int64_t n = (int64_t)nx * ny * nz;
  if (n == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  fused_advective_tendencies_kernel<T><<<(unsigned int)blocks, threads, 0,
                                         static_cast<cudaStream_t>(stream)>>>(A);
  return (int)cudaGetLastError();
}

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). `psi` and
// `out` are host arrays of nf device pointers.
int fused_advective_tendencies_f32(const void* const* psi, void* const* out,
                                   int nf, int nx, int ny, int nz, int hx,
                                   int hy, int hz, int weno_m, int weno_t,
                                   int z_masks, int lo_l, int hi_l, int lo_r,
                                   int hi_r, double eps_m, double eps_t,
                                   double dx, double dy, double dz,
                                   void* stream) {
  return launch<float>(psi, out, nf, nx, ny, nz, hx, hy, hz, weno_m, weno_t,
                       z_masks, lo_l, hi_l, lo_r, hi_r, eps_m, eps_t, dx, dy,
                       dz, stream);
}

int fused_advective_tendencies_f64(const void* const* psi, void* const* out,
                                   int nf, int nx, int ny, int nz, int hx,
                                   int hy, int hz, int weno_m, int weno_t,
                                   int z_masks, int lo_l, int hi_l, int lo_r,
                                   int hi_r, double eps_m, double eps_t,
                                   double dx, double dy, double dz,
                                   void* stream) {
  return launch<double>(psi, out, nf, nx, ny, nz, hx, hy, hz, weno_m, weno_t,
                        z_masks, lo_l, hi_l, lo_r, hi_r, eps_m, eps_t, dx, dy,
                        dz, stream);
}

}  // extern "C"
