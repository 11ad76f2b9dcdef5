// Fused AB2 advance of the nonhydrostatic model: for every prognostic field
// psi in {u, v, w, tracers},
//
//   G    = -div(v psi)                       (any scheme, weno5_advection.cuh)
//          - f x u                            (f- or beta-plane; u and v only)
//          - d(pHY')/dx, -d(pHY')/dy         (u and v only)
//          + div(kappa grad psi)              (constant nu/kappa, optional)
//   psi' = psi + dt (c1 G - c2 G_prev)
//
// and writes psi' halo-free (nx, ny, nz) and G in the model's G_prev layout:
// halo-free, or with-halo (`g_halo`) with the halos written as zeros.
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
// TPU kernel imposes on its z-halo-free blocks. Every division is ieee_div
// (IEEE's own quotient); build with --fmad=false so the compiler forms no
// FMA that eager PyTorch does not.
//
// What bounds it on an H100: memory. At 256^3 fp32 it reads about 0.63 GB
// (five with-halo fields u, v, w, b, pHY' at 72 MB, four halo-free G_prev
// at 67 MB) and writes about 0.54 GB (eight halo-free outputs): at least
// 0.35 ms at 3.35 TB/s if each byte moves once. The function needs ~820
// flops per point (12 WENO5 transports of ~64 flops, three faces for each
// of four fields, then the divergences, -d(pHY')/dx and the epilogue), some
// 14 GFLOP, about 0.2 ms at the 67 TFLOP/s fp32 peak. The options add a few
// loads and ~30 flops per field. In practice, as K2, its exact divisions
// and dependent WENO5 chains bound it by instruction issue.
//
// The design is K2's (advect_tile of weno5_advection.cuh: 8 x 12 columns
// and up to 32 levels a block of 1024 threads, tiles staged in shared
// memory with cp.async, each face flux once, tracers through a double
// buffer) with this epilogue at each point: the Coriolis terms read the
// staged u and v boxes, the diffusion the field's own box, psi the box's
// centre; G_prev and the two pHY' values of a point come from global
// memory, loaded before the face fluxes so that their latency hides behind
// them. The prologue writes G's halo zeros in the with-halo layout, so the
// wrapper allocates with torch.empty.
//
// The general instantiation (GEN, ops/fused_step.py::general_route: a
// stretched z, a vertically implicit closure, w walls the roll-based
// projection cannot impose, or a Flat axis) reads per-level Dz rows and,
// on a stretched z with WENO5, the tables (advect_tile's stretched form);
// takes `vertical` = 0, the horizontal-only diffusion of a vertically
// implicit closure (the JAX kernel's vert = not vertically_implicit);
// writes psi' with halos (zeros, as the JAX kernel pads it) for the
// implicit step and the general projection; and under `w_top` also G_w and
// psi'_w at w's top wall face. The regular instantiation carries none of
// this, so the regular-z paths pay for no branch. On a grid with a Flat
// axis (FL, GEN only) the kernel's axes are the grid's with that axis
// moved to y (weno5_advection.cuh): the Coriolis, pHY' and row terms then
// find the grid's x and y through Advection::kx, and the host hands the z
// rows and diffusivities of the kernel's z. C4, UB1, UB3 and
// BoundsPreservingWENO5 run the ANY instantiations (weno5_advection.cuh),
// which the other schemes' leave out.
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
  // the general instantiation (GEN): psi' with halos, the vertical
  // diffusion optional, w's top wall face
  int vertical;              // the diffusion's z fluxes (0: a vertically implicit closure)
  int w_top;                 // bounded z, with-halo G: also G_w and psi'_w at the top wall face
};

// div_kappa_grad for constant kappa at the box offset q: the flux is
// A*(kappa*(delta c / spacing)) on both faces of every axis, whichever of
// centre or face the field sits on.
template <typename T>
__device__ __forceinline__ T diffusion(const T* __restrict__ c, int q, int sx, int sy,
                                       T kh, T kz, const Advection<T>& A) {
  const T Ax = A.dy * A.dz, Ay = A.dx * A.dz, Az = A.dx * A.dy;
  const T fxR = Ax * (kh * ieee_div(c[q + sx] - c[q], A.dx));
  const T fxL = Ax * (kh * ieee_div(c[q] - c[q - sx], A.dx));
  const T fyR = Ay * (kh * ieee_div(c[q + sy] - c[q], A.dy));
  const T fyL = Ay * (kh * ieee_div(c[q] - c[q - sy], A.dy));
  const T fzR = Az * (kz * ieee_div(c[q + 1] - c[q], A.dz));
  const T fzL = Az * (kz * ieee_div(c[q] - c[q - 1], A.dz));
  T out = (fxR - fxL) + (fyR - fyL);
  out = out + (fzR - fzL);
  return ieee_div(out, A.dx * A.dy * A.dz);
}

// div_kappa_grad for constant kappa on a z axis with per-level spacing (the
// general instantiation): the field's own Dz (Dz[C] for u, v and the
// tracers, Dz[F] for w) in the x and y face areas and the volume, and the
// distances of the z faces above and below (Dz[F] at K+1 and K of a centred
// field, Dz[C] at K and K-1 of w), as grid.Ax/Ay/Az/V and the spacings of
// the field's location give them to the plain version; c[q + up] is the
// point above. `vertical` false leaves the z fluxes to the implicit solve.
template <typename T, typename I>
__device__ __forceinline__ T diffusion_rows(const T* __restrict__ c, I q, I sx, I sy,
                                            I up, T kh, T kz, T dx, T dy, T dz,
                                            T dz_up, T dz_dn, bool vertical) {
  const T Ax = dy * dz, Ay = dx * dz, Az = dx * dy;
  const T fxR = Ax * (kh * ieee_div(c[q + sx] - c[q], dx));
  const T fxL = Ax * (kh * ieee_div(c[q] - c[q - sx], dx));
  const T fyR = Ay * (kh * ieee_div(c[q + sy] - c[q], dy));
  const T fyL = Ay * (kh * ieee_div(c[q] - c[q - sy], dy));
  T out = (fxR - fxL) + (fyR - fyL);
  if (vertical) {
    const T fzR = Az * (kz * ieee_div(c[q + up] - c[q], dz_up));
    const T fzL = Az * (kz * ieee_div(c[q] - c[q - 1], dz_dn));
    out = out + (fzR - fzL);
  }
  return ieee_div(out, dx * dy * dz);
}

// diffusion_rows of field f at with-halo level K from the z rows
template <typename T, typename I>
__device__ __forceinline__ T diffusion_at(const AdvanceArgs<T>& A, int f, const T* c,
                                          I q, I sx, I sy, I up, int K) {
  const Advection<T>& D = A.adv;
  const int Z = D.nz + 2 * D.hz;
  const T* dzc = D.zs + Z_DZ_C * Z;
  const T* dzf = D.zs + Z_DZ_F * Z;
  const bool w = f == 2;
  return diffusion_rows(c, q, sx, sy, up, A.kh[f], A.kz[f], D.dx, D.dy,
                        w ? dzf[K] : dzc[K], w ? dzc[K] : dzf[K + 1],
                        w ? dzc[K - 1] : dzf[K], A.vertical != 0);
}

// K1's use of advect_tile: G's terms and the AB2 advance at each point. The
// general instantiation (GEN) runs advect_tile's stretched form (on a
// regular z its rows hold the one spacing), writes psi' with halos (zeros,
// but for w's top wall face under `w_top`), takes `vertical`, and under
// `w_top` computes G_w and psi'_w at w's top wall face (with-halo z index
// hz+nz) from global memory in the last chunk's blocks, as K2 does: a w
// wall that the fill does not impose (FluxBC) leaves that face to the step,
// and the general projection after the advance reads it.
template <typename T, bool GEN, bool FL, bool ANY, bool BF = false>
struct AdvanceOut {
  const AdvanceArgs<T>& A;

  // of the kernel's x, y or z (a), the value among three
  template <typename V>
  __device__ __forceinline__ static V pick(int a, V x, V y, V z) {
    return a == 0 ? x : (a == 1 ? y : z);
  }

  __device__ __forceinline__ void prologue(const AdvTile<T>& t) const {
    using S = Tile<FL>;
    if constexpr (GEN) {
      const Advection<T>& D = A.adv;
      const int top = D.hz + D.nz;
      for_halo_points<FL>(D, t, [&](int i, int j, int k) {
        const int64_t p = t.g(i, j, k);
        const bool face = A.w_top && k == top && i >= D.hx && i < D.hx + D.nx
                          && j >= D.hy && j < D.hy + D.ny;
        for (int f = 0; f < D.nf; ++f) {
          if (f == 2 && face) continue;
          A.out_psi[f][p] = T(0);
          if (A.g_halo) A.out_g[f][p] = T(0);
        }
      });
      if (A.w_top && blockIdx.z == gridDim.z - 1)
        for (int s = threadIdx.x; s < S::COLS; s += blockDim.x) {
          const int i = t.I0 + s / S::Y, j = t.J0 + s % S::Y;
          if (i >= t.I1 || j >= t.J1) continue;
          const int64_t o = t.g(i, j, top);
          const int Z = D.nz + 2 * D.hz;
          T g = -div_wall<true, false, ANY, BF>(D, 2, i, j, top, t.gsx, t.gsy);
          if (A.diffuse) {
            const int64_t up = top + 1 < Z ? 1 : -(int64_t)top;
            g = g + diffusion_at(A, 2, D.psi[2], o, t.gsx, t.gsy, up, top);
          }
          A.out_psi[2][o] = D.psi[2][o] + A.dt * (A.c1 * g - A.c2 * A.gp[2][o]);
          A.out_g[2][o] = g;
        }
    } else if (A.g_halo) {
      for_halo_points<FL>(A.adv, t, [&](int i, int j, int k) {
        const int64_t p = t.g(i, j, k);
        for (int f = 0; f < A.adv.nf; ++f) A.out_g[f][p] = T(0);
      });
    }
  }

  // the point's global loads, issued before the face fluxes: G_prev and
  // the two pHY' values of the u or v gradient
  struct Pre {
    T gp, ph0, ph1;
  };

  __device__ __forceinline__ int64_t halo_free(int I, int J, int K) const {
    const Advection<T>& D = A.adv;
    return ((int64_t)(I - D.hx) * D.ny + (J - D.hy)) * D.nz + (K - D.hz);
  }

  // the grid's field of kernel field f (u, v, w, then the tracers)
  __device__ __forceinline__ int grid_field(int f) const {
    if constexpr (FL) return f < 3 ? A.adv.ax[f] : f;
    return f;
  }

  // the array stride of the grid's axis g
  __device__ __forceinline__ int64_t grid_stride(const AdvTile<T>& t, int g) const {
    if constexpr (FL) return pick<int64_t>(A.adv.kx[g], t.gsx, t.gsy, 1);
    return g == 0 ? t.gsx : t.gsy;
  }

  __device__ __forceinline__ Pre prefetch(int f, const AdvTile<T>& t, int I, int J,
                                          int K) const {
    const int64_t o = t.g(I, J, K);
    const int gf = grid_field(f);
    Pre p;
    p.gp = A.gp[f][A.g_halo ? o : halo_free(I, J, K)];
    if (A.ph != nullptr && gf < 2) {
      p.ph0 = A.ph[o];
      p.ph1 = A.ph[o - grid_stride(t, gf)];
    }
    return p;
  }

  __device__ __forceinline__ void point(int f, const AdvTile<T>& t, const T* c, int q,
                                        int I, int J, int K, T div, const Pre& pre) const {
    const Advection<T>& D = A.adv;
    const int gf = grid_field(f);
    // the grid's x and y: box strides, u and v boxes, y index, spacings
    int sx = t.bsx, sy = t.bsy, Jy = J;
    const T* __restrict__ u = t.su;
    const T* __restrict__ v = t.sv;
    T dx = D.dx, dy = D.dy;
    if constexpr (FL) {
      const int kx = D.kx[0], ky = D.kx[1];
      sx = pick(kx, t.bsx, t.bsy, 1);
      sy = pick(ky, t.bsx, t.bsy, 1);
      u = pick(kx, t.su, t.sv, t.sw);
      v = pick(ky, t.su, t.sv, t.sw);
      Jy = pick(ky, I, J, K);
      dx = pick(kx, D.dx, D.dy, D.dz);
      dy = pick(ky, D.dx, D.dy, D.dz);
    }
    const T half = T(0.5);
    T g = -div;
    if (gf == 0) {
      if (A.fu != nullptr)  // - x_f_cross_U = - (-f * ixf(iyc(v)))
        g = g - ((-A.fu[Jy]) * (half * (half * (v[q + sy] + v[q])
                                        + half * (v[q - sx + sy] + v[q - sx]))));
      if (A.ph != nullptr) g = g - ieee_div(pre.ph0 - pre.ph1, dx);
    } else if (gf == 1) {
      if (A.fv != nullptr)  // - y_f_cross_U = - (f * iyf(ixc(u)))
        g = g - (A.fv[Jy] * (half * (half * (u[q + sx] + u[q])
                                     + half * (u[q + sx - sy] + u[q - sy]))));
      if (A.ph != nullptr) g = g - ieee_div(pre.ph0 - pre.ph1, dy);
    }  // z_f_cross_U is zero on f- and beta-planes
    if (A.diffuse) {
      if constexpr (GEN)
        g = g + diffusion_at(A, f, c, q, t.bsx, t.bsy, 1, K);
      else
        g = g + diffusion(c, q, t.bsx, t.bsy, A.kh[f], A.kz[f], D);
    }
    const int64_t p = halo_free(I, J, K);
    A.out_psi[f][GEN ? t.g(I, J, K) : p] = c[q] + A.dt * (A.c1 * g - A.c2 * pre.gp);
    A.out_g[f][A.g_halo ? t.g(I, J, K) : p] = g;
  }
};

template <typename T, bool GEN, bool FL, bool ANY, bool BF = false>
__global__ void __launch_bounds__(AT_THREADS, 1)
fused_ab2_advance_kernel(const __grid_constant__ AdvanceArgs<T> A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  advect_tile<GEN, FL, false, false, ANY, BF>(A.adv, reinterpret_cast<T*>(smem_raw),
                                              AdvanceOut<T, GEN, FL, ANY, BF>{A});
}

template <typename T, bool GEN, bool FL, bool ANY, bool BF = false>
static int launch_kernel(AdvanceArgs<T>& A, void* stream) {
  int smem;
  const dim3 blocks = plan_tiles<FL>(A.adv, smem);
  auto kernel = fused_ab2_advance_kernel<T, GEN, FL, ANY, BF>;
  const int rc = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != 0) return rc;
  kernel<<<blocks, AT_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(A);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* const* psi, const void* const* gp,
                  void* const* out_psi, void* const* out_g, const void* ph,
                  const void* fu, const void* fv, const double* kh,
                  const double* kz, int g_halo, const int* ia, const double* da,
                  double c1, double c2, double dt, const void* zs, int tables,
                  int vertical, int w_top, void* stream) {
  AdvanceArgs<T> A;
  if (!set_advection(A.adv, psi, ia, da)) return (int)cudaErrorInvalidValue;
  if ((fu == nullptr) != (fv == nullptr) || (kh == nullptr) != (kz == nullptr))
    return (int)cudaErrorInvalidValue;
  const int nf = A.adv.nf;
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
  A.adv.zs = static_cast<const T*>(zs);
  A.adv.tables = tables;
  A.vertical = vertical;
  A.w_top = w_top;
  const bool flat = advection_flat(ia);
  if (zs == nullptr && (tables || !vertical || w_top || flat))
    return (int)cudaErrorInvalidValue;
  if (w_top && !g_halo) return (int)cudaErrorInvalidValue;
  if (A.adv.nx <= 0 || A.adv.ny <= 0 || A.adv.nz <= 0) return 0;
  // ANY: a scheme of needs_any (weno5_advection.cuh); its bf16 sub-form
  // for WENO5's bf16 options
  if (advection_bf16(A.adv)) {
    if (zs == nullptr) return launch_kernel<T, false, false, true, true>(A, stream);
    return flat ? launch_kernel<T, true, true, true, true>(A, stream)
                : launch_kernel<T, true, false, true, true>(A, stream);
  }
  if (advection_any(A.adv)) {
    if (zs == nullptr) return launch_kernel<T, false, false, true>(A, stream);
    return flat ? launch_kernel<T, true, true, true>(A, stream)
                : launch_kernel<T, true, false, true>(A, stream);
  }
  if (zs == nullptr) return launch_kernel<T, false, false, false>(A, stream);
  return flat ? launch_kernel<T, true, true, false>(A, stream)
              : launch_kernel<T, true, false, false>(A, stream);
}

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). Pointer
// arrays are host arrays of nf device pointers in the kernel's axis order;
// `ph`, `fu`/`fv` (both or neither) and `kh`/`kz` (host arrays of nf
// diffusivities, both or neither) may be null; `ia` and `da` are the
// shared arguments (set_advection). `zs` (the z rows of
// ops/metric_rows.py, with WENO5's to-faces and to-centres tables where
// `tables`) selects the general instantiation: psi' with halos, `vertical`
// and `w_top`, and the one a Flat axis needs; null selects the regular
// one, whose psi' is halo-free.
#define FUSED_AB2_ADVANCE(NAME, T)                                            \
  int NAME(const void* const* psi, const void* const* gp,                     \
           void* const* out_psi, void* const* out_g, const void* ph,          \
           const void* fu, const void* fv, const double* kh,                  \
           const double* kz, int g_halo, const int* ia, const double* da,     \
           double c1, double c2, double dt, const void* zs, int tables,       \
           int vertical, int w_top, void* stream) {                           \
    return launch<T>(psi, gp, out_psi, out_g, ph, fu, fv, kh, kz, g_halo, ia, \
                     da, c1, c2, dt, zs, tables, vertical, w_top, stream);    \
  }

FUSED_AB2_ADVANCE(fused_ab2_advance_f32, float)
FUSED_AB2_ADVANCE(fused_ab2_advance_f64, double)

}  // extern "C"
