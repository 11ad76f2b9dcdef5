// Fused shallow-water tendencies (conservative form): Guh, Gvh, Gh and
// every tracer's G, written into the interiors of with-halo outputs (the
// caller allocates them zeroed).
//
// Replaces the TPU kernel clima_oceananigans_jl_tpu/ops/fused_tendencies.py::
// pallas_fuse as the shallow-water model calls it
// (models/shallow_water.py:325, body _core_tendencies). It computes what
// that kernel computes, in the expression trees of the port's plain version
// (ops/fused_tendencies.py::fused_shallow_water_tendencies_reference):
//   Guh = -(dxf((Ax T(u_cc; uh))/h) + dyc((Ay T(v_ff; uh))/h_ff))/V
//         - dxf(((g/2) h) h)/dx  [+ ((g ixf(h)) dxf(hB))/dx]
//   Gvh = the y analogue,  Gh = -(dxc(Ax uh) + dyc(Ay vh))/V
//   Gc  = -(dxc(Ax T(u; c)) + dyc(Ay T(v; c)))/V + c div(u, v),
//         u = uh/ixf(h), v = vh/iyf(h)
// with T the select-first WENO5 or centred transport of weno5_advection.cuh
// (transport_axis) and WENO5's near-wall order reduction on a bounded x or
// y axis. One thread knows its absolute index, so both axes take the
// bounds, where the TPU's tiled windows could carry them only along y.
// The grid is 2D: with-halo arrays (nx+2hx, ny+2hy, 1), y contiguous, and
// the flat z axis has dz = 1, so Ax = dy, Ay = dx, V = dx*dy exactly.
//
// What bounds it on an H100: memory. At 16384^2 fp32 with uh, vh, h it
// reads three with-halo fields (3 x 1.07 GB) and writes three (the zero
// fill and the interior stores): about 6.4 GB, 1.9 ms at 3.35 TB/s if each
// byte moves once. The arithmetic is 4 WENO5 reconstructions of ~50 flops
// and a few divisions per point.
//
// The design is the simple one of K1 and K2: one thread per interior point,
// j (the contiguous axis) across the threads of a warp, neighbours read from
// global memory through L1/L2, each face flux computed by both cells beside
// it. Shared-memory tiling and flux reuse are later work.
#include <cuda_runtime.h>

#include "weno5_advection.cuh"

template <typename T>
struct ShallowWaterArgs {
  const T* psi[MAX_FIELDS];  // with-halo uh, vh, h, tracers
  const T* hB;               // with-halo bathymetry or nullptr
  T* out[MAX_FIELDS];        // with-halo G, interior written
  int nf;                    // 3 + number of tracers
  int nx, ny, hx, hy;
  int weno_m, weno_t;        // momentum / tracers: 1 WENO5, 0 centred 2nd order
  int x_masks, y_masks;      // bounded axis: near-wall order reduction
  Bounds xb, yb;
  T eps_m, eps_t, dx, dy;
  T g, half_g;               // g and 0.5*g, each rounded once to T
};

template <typename T>
__global__ void __launch_bounds__(256)
fused_shallow_water_tendencies_kernel(const ShallowWaterArgs<T> A) {
  const int64_t n = (int64_t)A.nx * A.ny;
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int I = (int)(p / A.ny) + A.hx;   // with-halo indices
  const int J = (int)(p % A.ny) + A.hy;
  const int64_t sx = A.ny + 2 * A.hy, sy = 1;
  const int64_t o = I * sx + J;
  const T* __restrict__ uh = A.psi[0];
  const T* __restrict__ vh = A.psi[1];
  const T* __restrict__ h = A.psi[2];
  const T half = T(0.5);
  const T Ax = A.dy, Ay = A.dx, V = A.dx * A.dy;
  const bool wm = A.weno_m != 0, wt = A.weno_t != 0;
  const bool xm = wm && A.x_masks != 0, ym = wm && A.y_masks != 0;
  // ixf(iyf(h)) at the (F, F) point of offset f
  auto h_ff = [&](int64_t f) {
    return half * (half * (h[f] + h[f - sy]) + half * (h[f - sx] + h[f - sx - sy]));
  };
  auto pressure = [&](int64_t c) { return (A.half_g * h[c]) * h[c]; };

  // Guh at (F, C): x fluxes at centres I-1, I; y fluxes at faces J, J+1
  {
    auto huu = [&](int64_t c, int q) {  // centre c, x index q
      const T vel = half * (uh[c + sx] + uh[c]);
      return (Ax * transport_axis(uh, c + sx, sx, vel, wm, A.eps_m, xm, A.xb, q)) / h[c];
    };
    auto hvu = [&](int64_t f, int q) {  // y face f, y index q
      const T vel = half * (vh[f] + vh[f - sx]);
      return (Ay * transport_axis(uh, f, sy, vel, wm, A.eps_m, ym, A.yb, q)) / h_ff(f);
    };
    const T div = ((huu(o, I) - huu(o - sx, I - 1))
                   + (hvu(o + sy, J + 1) - hvu(o, J))) / V;
    T G = -div - (pressure(o) - pressure(o - sx)) / A.dx;
    if (A.hB != nullptr)
      G = G + ((A.g * (half * (h[o] + h[o - sx]))) * (A.hB[o] - A.hB[o - sx])) / A.dx;
    A.out[0][o] = G;
  }
  // Gvh at (C, F): x fluxes at faces I, I+1; y fluxes at centres J-1, J
  {
    auto huv = [&](int64_t f, int q) {  // x face f, x index q
      const T vel = half * (uh[f] + uh[f - sy]);
      return (Ax * transport_axis(vh, f, sx, vel, wm, A.eps_m, xm, A.xb, q)) / h_ff(f);
    };
    auto hvv = [&](int64_t c, int q) {  // centre c, y index q
      const T vel = half * (vh[c + sy] + vh[c]);
      return (Ay * transport_axis(vh, c + sy, sy, vel, wm, A.eps_m, ym, A.yb, q)) / h[c];
    };
    const T div = ((huv(o + sx, I + 1) - huv(o, I))
                   + (hvv(o, J) - hvv(o - sy, J - 1))) / V;
    T G = -div - (pressure(o) - pressure(o - sy)) / A.dy;
    if (A.hB != nullptr)
      G = G + ((A.g * (half * (h[o] + h[o - sy]))) * (A.hB[o] - A.hB[o - sy])) / A.dy;
    A.out[1][o] = G;
  }
  // Gh at (C, C)
  A.out[2][o] = -((Ax * uh[o + sx] - Ax * uh[o]) + (Ay * vh[o + sy] - Ay * vh[o])) / V;
  if (A.nf == 3) return;
  // tracers at (C, C), advected by the velocities at the four faces
  const bool xt = wt && A.x_masks != 0, yt = wt && A.y_masks != 0;
  const T uL = uh[o] / (half * (h[o] + h[o - sx]));
  const T uR = uh[o + sx] / (half * (h[o + sx] + h[o]));
  const T vL = vh[o] / (half * (h[o] + h[o - sy]));
  const T vR = vh[o + sy] / (half * (h[o + sy] + h[o]));
  const T div_U = ((Ax * uR - Ax * uL) + (Ay * vR - Ay * vL)) / V;
  for (int f = 3; f < A.nf; ++f) {
    const T* __restrict__ c = A.psi[f];
    const T fxR = Ax * transport_axis(c, o + sx, sx, uR, wt, A.eps_t, xt, A.xb, I + 1);
    const T fxL = Ax * transport_axis(c, o, sx, uL, wt, A.eps_t, xt, A.xb, I);
    const T fyR = Ay * transport_axis(c, o + sy, sy, vR, wt, A.eps_t, yt, A.yb, J + 1);
    const T fyL = Ay * transport_axis(c, o, sy, vL, wt, A.eps_t, yt, A.yb, J);
    const T div_Uc = ((fxR - fxL) + (fyR - fyL)) / V;
    A.out[f][o] = -div_Uc + c[o] * div_U;
  }
}

template <typename T>
static int launch(const void* const* psi, const void* hB, void* const* out,
                  int nf, int nx, int ny, int hx, int hy, int weno_m,
                  int weno_t, int x_masks, int xlo_l, int xhi_l, int xlo_r,
                  int xhi_r, int y_masks, int ylo_l, int yhi_l, int ylo_r,
                  int yhi_r, double eps_m, double eps_t, double dx, double dy,
                  double g, void* stream) {
  if (nf < 3 || nf > MAX_FIELDS) return (int)cudaErrorInvalidValue;
  ShallowWaterArgs<T> A;
  for (int f = 0; f < MAX_FIELDS; ++f) {
    A.psi[f] = f < nf ? static_cast<const T*>(psi[f]) : nullptr;
    A.out[f] = f < nf ? static_cast<T*>(out[f]) : nullptr;
  }
  A.hB = static_cast<const T*>(hB);
  A.nf = nf;
  A.nx = nx; A.ny = ny; A.hx = hx; A.hy = hy;
  A.weno_m = weno_m; A.weno_t = weno_t;
  A.x_masks = x_masks; A.y_masks = y_masks;
  A.xb = Bounds{xlo_l, xhi_l, xlo_r, xhi_r};
  A.yb = Bounds{ylo_l, yhi_l, ylo_r, yhi_r};
  A.eps_m = T(eps_m); A.eps_t = T(eps_t);
  A.dx = T(dx); A.dy = T(dy);
  A.g = T(g); A.half_g = T(0.5 * g);
  const int64_t n = (int64_t)nx * ny;
  if (n == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  fused_shallow_water_tendencies_kernel<T><<<(unsigned int)blocks, threads, 0,
                                             static_cast<cudaStream_t>(stream)>>>(A);
  return (int)cudaGetLastError();
}

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). `psi` and
// `out` are host arrays of nf device pointers; `hB` is a device pointer or
// null.
int fused_shallow_water_tendencies_f32(
    const void* const* psi, const void* hB, void* const* out, int nf, int nx,
    int ny, int hx, int hy, int weno_m, int weno_t, int x_masks, int xlo_l,
    int xhi_l, int xlo_r, int xhi_r, int y_masks, int ylo_l, int yhi_l,
    int ylo_r, int yhi_r, double eps_m, double eps_t, double dx, double dy,
    double g, void* stream) {
  return launch<float>(psi, hB, out, nf, nx, ny, hx, hy, weno_m, weno_t,
                       x_masks, xlo_l, xhi_l, xlo_r, xhi_r, y_masks, ylo_l,
                       yhi_l, ylo_r, yhi_r, eps_m, eps_t, dx, dy, g, stream);
}

int fused_shallow_water_tendencies_f64(
    const void* const* psi, const void* hB, void* const* out, int nf, int nx,
    int ny, int hx, int hy, int weno_m, int weno_t, int x_masks, int xlo_l,
    int xhi_l, int xlo_r, int xhi_r, int y_masks, int ylo_l, int yhi_l,
    int ylo_r, int yhi_r, double eps_m, double eps_t, double dx, double dy,
    double g, void* stream) {
  return launch<double>(psi, hB, out, nf, nx, ny, hx, hy, weno_m, weno_t,
                        x_masks, xlo_l, xhi_l, xlo_r, xhi_r, y_masks, ylo_l,
                        yhi_l, ylo_r, yhi_r, eps_m, eps_t, dx, dy, g, stream);
}

}  // extern "C"
