// Fused AB2 advance of the nonhydrostatic model: for every prognostic field
// psi in {u, v, w, tracers},
//
//   G    = -div(v psi)                       (WENO5 or centred, weno5_advection.cuh)
//          - f x u                            (f- or beta-plane; u and v only)
//          - d(pHY')/dx, -d(pHY')/dy         (u and v only)
//          + div(kappa grad psi)              (constant nu/kappa, optional)
//   psi' = psi + dt (c1 G - c2 G_prev)
//
// and writes psi' halo-free (nx, ny, nz) and G in the model's G_prev layout:
// halo-free, or the interior of a zeroed with-halo array (`g_halo`).
//
// Replaces the TPU kernel clima_oceananigans_jl_tpu/ops/fused_step.py::
// fused_ab2_advance, its options included. It computes what that kernel
// computes, in the term order it states (advection -> Coriolis -> pHY' ->
// diffusion) and in the expression trees of the port's plain version
// (ops/fused_step.py::fused_ab2_advance_reference): the Coriolis terms of
// coriolis/coriolis.py (f at U_LOC and V_LOC arrives as a device row over
// with-halo y, built from grid.nodes), div_kappa_grad of
// closures/scalar_diffusivity.py. The diffusion reads real z halos: the
// mirror fill of a zero-gradient wall gives the zero wall flux that the
// TPU kernel imposes on its z-halo-free blocks. Build with --fmad=false so
// the compiler forms no FMA that eager PyTorch does not.
//
// What bounds it on an H100: memory. At 256^3 fp32 it reads about 0.63 GB
// (five with-halo fields u, v, w, b, pHY' at 72 MB, four halo-free G_prev
// at 67 MB) and writes about 0.54 GB (eight halo-free outputs): at least
// 0.35 ms at 3.35 TB/s if each byte moves once. The function needs ~820
// flops per point (12 WENO5 transports of ~64 flops, three faces for each
// of four fields, then the divergences, -d(pHY')/dx and the epilogue), some
// 14 GFLOP, about 0.2 ms at the 67 TFLOP/s fp32 peak; the kernel computes
// each face in both cells beside it, 24 per point. The options add a few
// loads and ~30 flops per field.
//
// The design is the simple one: one thread per interior point (i, j, k),
// k (the contiguous axis) across the threads of a warp, neighbours read
// straight from global memory through L1/L2. Each face flux is computed
// twice (once by each cell beside it) and each stencil value is loaded by
// several threads; nothing is staged in shared memory yet. Tiling through
// shared memory (or TMA) and sharing fluxes between neighbours are later
// work: first the kernel has to agree with the plain version.
#include <cuda_runtime.h>

#include "weno5_advection.cuh"

template <typename T>
struct AdvanceArgs {
  Advection<T> adv;
  const T* gp[MAX_FIELDS];   // G_prev, halo-free or with-halo (g_halo)
  T* out_psi[MAX_FIELDS];    // halo-free psi'
  T* out_g[MAX_FIELDS];      // G, in G_prev's layout
  const T* ph;               // with-halo pHY', or nullptr
  const T* fu;               // f at U_LOC over with-halo y, or nullptr (no Coriolis)
  const T* fv;               // f at V_LOC over with-halo y
  int diffuse;               // add div(kappa grad psi) with kh/kz
  T kh[MAX_FIELDS], kz[MAX_FIELDS];  // horizontal / vertical diffusivity per field
  int g_halo;
  T c1, c2, dt;
};

// div_kappa_grad for constant kappa: the flux is A*(kappa*(delta c / spacing))
// on both faces of every axis, whichever of centre or face the field sits on.
template <typename T>
__device__ __forceinline__ T diffusion(const T* __restrict__ c, const Point& P,
                                       T kh, T kz, const Advection<T>& A) {
  const int64_t o = P.o, sx = P.sx, sy = P.sy, sz = 1;
  const T Ax = A.dy * A.dz, Ay = A.dx * A.dz, Az = A.dx * A.dy;
  const T fxR = Ax * (kh * ((c[o + sx] - c[o]) / A.dx));
  const T fxL = Ax * (kh * ((c[o] - c[o - sx]) / A.dx));
  const T fyR = Ay * (kh * ((c[o + sy] - c[o]) / A.dy));
  const T fyL = Ay * (kh * ((c[o] - c[o - sy]) / A.dy));
  const T fzR = Az * (kz * ((c[o + sz] - c[o]) / A.dz));
  const T fzL = Az * (kz * ((c[o] - c[o - sz]) / A.dz));
  T out = (fxR - fxL) + (fyR - fyL);
  out = out + (fzR - fzL);
  return out / (A.dx * A.dy * A.dz);
}

template <typename T>
__device__ __forceinline__ void advance(const AdvanceArgs<T>& A,
                                        const Point& P, int f, T g) {
  const int64_t q = A.g_halo ? P.o : P.p;
  A.out_psi[f][P.p] = A.adv.psi[f][P.o] + A.dt * (A.c1 * g - A.c2 * A.gp[f][q]);
  A.out_g[f][q] = g;
}

template <typename T>
__global__ void __launch_bounds__(256)
fused_ab2_advance_kernel(const AdvanceArgs<T> A) {
  const Advection<T>& D = A.adv;
  Point P;
  if (!interior_point(D, P)) return;
  const int64_t o = P.o, sx = P.sx, sy = P.sy;
  const T* __restrict__ u = D.psi[0];
  const T* __restrict__ v = D.psi[1];
  const T* __restrict__ ph = A.ph;
  const T half = T(0.5);

  T g = -div_vu(D, P);
  if (A.fu != nullptr)  // - x_f_cross_U = - (-f * ixf(iyc(v)))
    g = g - ((-A.fu[P.J]) * (half * (half * (v[o + sy] + v[o])
                                     + half * (v[o - sx + sy] + v[o - sx]))));
  if (ph != nullptr) g = g - (ph[o] - ph[o - sx]) / D.dx;
  if (A.diffuse) g = g + diffusion(u, P, A.kh[0], A.kz[0], D);
  advance(A, P, 0, g);

  g = -div_vv(D, P);
  if (A.fv != nullptr)  // - y_f_cross_U = - (f * iyf(ixc(u)))
    g = g - (A.fv[P.J] * (half * (half * (u[o + sx] + u[o])
                                  + half * (u[o + sx - sy] + u[o - sy]))));
  if (ph != nullptr) g = g - (ph[o] - ph[o - sy]) / D.dy;
  if (A.diffuse) g = g + diffusion(v, P, A.kh[1], A.kz[1], D);
  advance(A, P, 1, g);

  g = -div_vw(D, P);  // z_f_cross_U is zero on f- and beta-planes
  if (A.diffuse) g = g + diffusion(D.psi[2], P, A.kh[2], A.kz[2], D);
  advance(A, P, 2, g);

  for (int f = 3; f < D.nf; ++f) {
    g = -div_Uc(D, P, f);
    if (A.diffuse) g = g + diffusion(D.psi[f], P, A.kh[f], A.kz[f], D);
    advance(A, P, f, g);
  }
}

template <typename T>
static int launch(const void* const* psi, const void* const* gp,
                  void* const* out_psi, void* const* out_g, const void* ph,
                  const void* fu, const void* fv, const double* kh,
                  const double* kz, int g_halo, int nf, int nx, int ny,
                  int nz, int hx, int hy, int hz, int weno_m, int weno_t,
                  int z_masks, int lo_l, int hi_l, int lo_r, int hi_r,
                  double eps_m, double eps_t, double dx, double dy, double dz,
                  double c1, double c2, double dt, void* stream) {
  AdvanceArgs<T> A;
  if (!set_advection(A.adv, psi, nf, nx, ny, nz, hx, hy, hz, weno_m, weno_t,
                     z_masks, lo_l, hi_l, lo_r, hi_r, eps_m, eps_t, dx, dy, dz))
    return (int)cudaErrorInvalidValue;
  if ((fu == nullptr) != (fv == nullptr) || (kh == nullptr) != (kz == nullptr))
    return (int)cudaErrorInvalidValue;
  for (int f = 0; f < MAX_FIELDS; ++f) {
    const bool on = f < nf;
    A.gp[f] = on ? static_cast<const T*>(gp[f]) : nullptr;
    A.out_psi[f] = on ? static_cast<T*>(out_psi[f]) : nullptr;
    A.out_g[f] = on ? static_cast<T*>(out_g[f]) : nullptr;
    A.kh[f] = on && kh != nullptr ? T(kh[f]) : T(0);
    A.kz[f] = on && kz != nullptr ? T(kz[f]) : T(0);
  }
  A.ph = static_cast<const T*>(ph);
  A.fu = static_cast<const T*>(fu);
  A.fv = static_cast<const T*>(fv);
  A.diffuse = kh != nullptr;
  A.g_halo = g_halo;
  A.c1 = T(c1); A.c2 = T(c2); A.dt = T(dt);
  const int64_t n = (int64_t)nx * ny * nz;
  if (n == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  fused_ab2_advance_kernel<T><<<(unsigned int)blocks, threads, 0,
                                static_cast<cudaStream_t>(stream)>>>(A);
  return (int)cudaGetLastError();
}

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). Pointer
// arrays are host arrays of nf device pointers; `ph`, `fu`/`fv` (both or
// neither) and `kh`/`kz` (host arrays of nf diffusivities, both or
// neither) may be null.
#define FUSED_AB2_ADVANCE(NAME, T)                                            \
  int NAME(const void* const* psi, const void* const* gp,                     \
           void* const* out_psi, void* const* out_g, const void* ph,          \
           const void* fu, const void* fv, const double* kh,                  \
           const double* kz, int g_halo, int nf, int nx, int ny, int nz,      \
           int hx, int hy, int hz, int weno_m, int weno_t, int z_masks,       \
           int lo_l, int hi_l, int lo_r, int hi_r, double eps_m,              \
           double eps_t, double dx, double dy, double dz, double c1,          \
           double c2, double dt, void* stream) {                              \
    return launch<T>(psi, gp, out_psi, out_g, ph, fu, fv, kh, kz, g_halo, nf, \
                     nx, ny, nz, hx, hy, hz, weno_m, weno_t, z_masks, lo_l,   \
                     hi_l, lo_r, hi_r, eps_m, eps_t, dx, dy, dz, c1, c2, dt,  \
                     stream);                                                 \
  }

FUSED_AB2_ADVANCE(fused_ab2_advance_f32, float)
FUSED_AB2_ADVANCE(fused_ab2_advance_f64, double)

}  // extern "C"
