// Fused hydrostatic tendencies (K4b): for the hydrostatic model's u, v and
// tracers,
//
//   G_u = -U.grad(u) [vector invariant] or -div(v u) [flux form]
//         - (f x u)_x - d(pHY')/dx,      G_v likewise,
//   G_c = -div(U c),
//
// optionally with the AB2 advance psi' = psi + dt (c1 G - c2 G_prev), on
// lat-lon or rectilinear grids whose metrics are constant along x (rows over
// with-halo y and z, ops/metric_rows.py), a stretched z axis included. One
// thread per with-halo point: interior points compute, halo points write 0.
//
// Replaces the TPU kernel clima_oceananigans_jl_tpu/ops/fused_hydrostatic.py::
// fused_hydrostatic_tendencies (its tendency core hydrostatic_advective_core,
// l.45, and the AB2 epilogue, l.764-773; w and pHY' come from K4a,
// hydrostatic_columns.cu). It computes what that kernel computes, in the
// expression trees of the port's plain version
// (ops/fused_hydrostatic.py::hydrostatic_advective_core):
//   - advection/vector_invariant.py: the four vorticity schemes (enstrophy,
//     energy, and select-first WENO5 of zeta with its own smoothness or the
//     mean smoothness of iyf(u) and ixf(v)), the vertical term
//     izc(ixf(Az w) dzf(u)/dz) / Az and the Bernoulli head;
//   - advection/fluxes.py div_vu, div_vv and div_Uc with the metric products
//     Ax = dy*dz, Ay = dx*dz, V = Az*dz, WENO5's near-wall order reduction
//     on bounded x, y and z (the vorticity reconstruction has none), and on
//     a stretched z the two-sided reconstruction with the table rows of
//     advection/reconstruction_tables.py and the upwind product;
//   - coriolis/coriolis.py: f- and beta-plane (rows of f at U_LOC, V_LOC)
//     and HydrostaticSphericalCoriolis (row of f at (F, F)), energy or
//     enstrophy.
// IEEE division throughout (no approximate reciprocal) and --fmad=false, so
// the compiler forms no FMA that eager PyTorch does not.
//
// What bounds it on an H100: at the 1/4 degree flagship (1446 x 606 x 30 with
// halos, fp32, u, v, T, S, b) in advance mode it reads 7 with-halo fields
// (u, v, w, pHY', three tracers; 105 MB each) and five G_prev and writes five
// psi' and five G: about 2.3 GB, 0.69 ms at 3.35 TB/s. The function needs
// about 1,300 flops a point (two WENO5 vorticity reconstructions with
// velocity smoothness, three WENO5 fluxes for each of three tracers, the z
// one two-sided with the tables, the divergences and the epilogue), about
// 27 GFLOP: 0.40 ms at the 67 TFLOP/s fp32 peak, so memory bounds it. The
// design is the simple one of K1-K3: neighbours read from global memory
// through L1/L2, each face flux computed by both cells beside it (about
// 2,100 flops a point as executed), nothing staged in shared memory; that
// is later work. On smooth fields the WENO5 weights'
// denominator falls to ~1e-24 and IEEE fp32 division takes its slow path.
#include <cuda_runtime.h>

#include "weno5_advection.cuh"

// rows of ops/metric_rows.py: Y_ROWS and Z_ROWS (then the 24 table rows)
enum { DX_CC = 0, DX_CF, DX_FC, DX_FF, AZ_CC, AZ_CF, AZ_FC, AZ_FF, DY_C, DY_F,
       F_U, F_V };
enum { DZ_C = 0, DZ_F = 1, TABLES = 2 };
// momentum: the vector-invariant schemes in advection/vector_invariant.py's
// SCHEMES order, then the flux form and none
enum { VI_ENSTROPHY = 0, VI_ENERGY, VI_WENO, VI_WENO_VELOCITY, FLUX_FORM, NO_MOMENTUM };
enum { NO_CORIOLIS = 0, PLANE, SPHERICAL_ENERGY, SPHERICAL_ENSTROPHY };

template <typename T>
struct HydroArgs {
  const T* psi[MAX_FIELDS];   // with-halo u, v, tracers
  const T* w;                 // with-halo w
  const T* ph;                // with-halo pHY', or nullptr
  const T* ys;                // y rows (12, Y)
  const T* zs;                // z rows (2 or 26, Z)
  const T* gp[MAX_FIELDS];    // with-halo G_prev (advance)
  T* out_g[MAX_FIELDS];       // with-halo G
  T* out_psi[MAX_FIELDS];     // with-halo psi' (advance)
  int nf, nx, ny, nz, hx, hy, hz;
  int mom, mom_weno, tr, cor, tables, advance;
  int xm, ym, zm;             // near-wall order reduction on that axis
  Bounds xb, yb, zb;
  T eps_m, eps_t, c1, c2, dt;
};

// Offsets and rows around one point.
template <typename T>
struct Here {
  const HydroArgs<T>* A;
  int64_t o, sx, sy;
  int I, J, K, Y, Z;
  __device__ __forceinline__ const T* yr(int r) const { return A->ys + r * Y; }
  __device__ __forceinline__ const T* zr(int r) const { return A->zs + r * Z; }
};

// ---- WENO5 pieces beyond weno5_advection.cuh --------------------------------

// WENO5.stream_reconstruct_smooth: the candidates of stream a, the weights
// from the mean Jiang-Shu smoothness of streams s and q.
template <typename T>
__device__ __forceinline__ T smoothness(T v0, T v1, T v2, T v3, T v4, int k) {
  const T e10 = v1 - v0, e11 = v2 - v1, e12 = v3 - v2, e13 = v4 - v3;
  const T k1312 = T(13.0 / 12.0);
  if (k == 0) {
    const T e20 = e11 - e10, s0 = e20 + T(2.0) * e11;
    return k1312 * e20 * e20 + T(0.25) * (s0 * s0);
  }
  if (k == 1) {
    const T e21 = e12 - e11, s1 = e11 + e12;
    return k1312 * e21 * e21 + T(0.25) * (s1 * s1);
  }
  const T e22 = e13 - e12, s2 = e22 - T(2.0) * e12;
  return k1312 * e22 * e22 + T(0.25) * (s2 * s2);
}

template <typename T>
__device__ __forceinline__ T combine(T p0, T p1, T p2, T b0, T b1, T b2, T d0,
                                     T d1, T d2, T eps) {
  const T e0 = b0 + eps, e1 = b1 + eps, e2 = b2 + eps;
  const T t0 = e0 * e0, t1 = e1 * e1, t2 = e2 * e2;
  const T g0 = d0 * (t1 * t2), g1 = d1 * (t0 * t2), g2 = d2 * (t0 * t1);
  return (g0 * p0 + g1 * p1 + g2 * p2) / (g0 + g1 + g2);
}

template <typename T>
__device__ __forceinline__ T weno_stream_smooth(const T* a, const T* s, const T* q, T eps) {
  const T d10 = a[1] - a[0], d11 = a[2] - a[1], d12 = a[3] - a[2], d13 = a[4] - a[3];
  const T p0 = a[2] + (T(5.0) * d11 - T(2.0) * d10) / T(6.0);
  const T p1 = a[2] + (T(2.0) * d12 + d11) / T(6.0);
  const T p2 = a[2] + (T(4.0) * d12 - d13) / T(6.0);
  T b[3];
  for (int k = 0; k < 3; ++k)
    b[k] = (smoothness(s[0], s[1], s[2], s[3], s[4], k)
            + smoothness(q[0], q[1], q[2], q[3], q[4], k)) / T(2.0);
  return combine(p0, p1, p2, b[0], b[1], b[2], T(0.1), T(0.6), T(0.3), eps);
}

// WENO5.table_reconstruct at a z face (to faces): side 0 left, 1 right; o is
// the offset of the cell above the face, K the face's with-halo index.
template <typename T>
__device__ __forceinline__ T table_side(const T* __restrict__ c, int64_t o,
                                        const Here<T>& H, int K, int side, T eps) {
  T p[3], b[3], d[3];
  for (int r = 0; r < 3; ++r) {
    const int base = TABLES + side * 12 + r * 4;
    d[r] = H.zr(base)[K];
    const T c0 = H.zr(base + 1)[K], c1 = H.zr(base + 2)[K], c2 = H.zr(base + 3)[K];
    const int off = side == 0 ? r - 3 : -r;
    const T w0 = c[o + off], w1 = c[o + off + 1], w2 = c[o + off + 2];
    p[r] = c0 * w0 + c1 * w1 + c2 * w2;
    const int kind = side == 0 ? r : 2 - r;
    const T t2 = kind == 0 ? w0 - T(4.0) * w1 + T(3.0) * w2
                           : (kind == 1 ? w0 - w2 : T(3.0) * w0 - T(4.0) * w1 + w2);
    const T q = w0 - T(2.0) * w1 + w2;
    b[r] = T(13.0 / 12.0) * (q * q) + T(0.25) * t2 * t2;
  }
  return combine(p[0], p[1], p[2], b[0], b[1], b[2], d[0], d[1], d[2], eps);
}

// transport() along z at face K (offset o of the cell above it): centred,
// select-first WENO5, or on a stretched axis the table form.
template <typename T>
__device__ __forceinline__ T z_transport(const T* __restrict__ c, int64_t o, T vel,
                                         bool weno, T eps, const Here<T>& H, int K) {
  const HydroArgs<T>& A = *H.A;
  const bool masked = weno && A.zm;
  if (!(weno && A.tables))
    return transport_axis(c, o, (int64_t)1, vel, weno, eps, masked, A.zb, K);
  T L = table_side(c, o, H, K, 0, eps);
  T R = table_side(c, o, H, K, 1, eps);
  if (masked) {
    const T lo = T(0.5) * (c[o] + c[o - 1]);
    if (!(K >= A.zb.lo_l && K <= A.zb.hi_l)) L = lo;
    if (!(K >= A.zb.lo_r && K <= A.zb.hi_r)) R = lo;
  }
  const T a = fabs(vel);
  return T(0.5) * ((vel + a) * L + (vel - a) * R);
}

// ---- vector-invariant momentum ----------------------------------------------

// zeta3 at the (F, F) point of offset q, y index j
template <typename T>
__device__ __forceinline__ T zeta(const Here<T>& H, int64_t q, int j) {
  const T* u = H.A->psi[0];
  const T* v = H.A->psi[1];
  const T* dy_f = H.yr(DY_F);
  const T* dx_fc = H.yr(DX_FC);
  return ((dy_f[j] * v[q] - dy_f[j] * v[q - H.sx])
          - (dx_fc[j] * u[q] - dx_fc[j - 1] * u[q - H.sy])) / H.yr(AZ_FF)[j];
}

// Bernoulli head K at the (C, C) point of offset q
template <typename T>
__device__ __forceinline__ T bernoulli(const Here<T>& H, int64_t q) {
  const T* u = H.A->psi[0];
  const T* v = H.A->psi[1];
  const T half = T(0.5);
  return half * (half * (u[q + H.sx] * u[q + H.sx] + u[q] * u[q])
                 + half * (v[q + H.sy] * v[q + H.sy] + v[q] * v[q]));
}

// select-first WENO5 of zeta onto a centre along an axis of stride s (in
// cells), the stream from the face pair nearest the centre: vel * rec
template <typename T>
__device__ __forceinline__ T weno_vorticity(const Here<T>& H, int64_t o, int64_t s,
                                            bool along_y, T vel) {
  const HydroArgs<T>& A = *H.A;
  const T* u = A.psi[0];
  const T* v = A.psi[1];
  const bool sel = vel >= T(0);
  // stream cell n = -2..3 relative to the centre's lower face (offset o)
  T z[5], su[5], sv[5];
  for (int m = 0; m < 5; ++m) {
    const int n = sel ? m - 2 : 3 - m;
    const int64_t q = o + n * s;
    const int j = along_y ? H.J + n : H.J;
    z[m] = zeta(H, q, j);
    if (A.mom == VI_WENO_VELOCITY) {
      su[m] = T(0.5) * (u[q] + u[q - H.sy]);   // iyf(u) at (F, F)
      sv[m] = T(0.5) * (v[q] + v[q - H.sx]);   // ixf(v) at (F, F)
    }
  }
  const T rec = A.mom == VI_WENO_VELOCITY
                    ? weno_stream_smooth(z, su, sv, T(1e-6))
                    : weno_stream(z[0], z[1], z[2], z[3], z[4], T(1e-6));
  return vel * rec;
}

// U.grad(u) at the u point
template <typename T>
__device__ T vi_u(const Here<T>& H) {
  const HydroArgs<T>& A = *H.A;
  const T* u = A.psi[0];
  const T* v = A.psi[1];
  const T* w = A.w;
  const int64_t o = H.o, sx = H.sx, sy = H.sy;
  const int J = H.J, K = H.K;
  const T half = T(0.5);
  const T* dx_cf = H.yr(DX_CF);
  const T dxu = H.yr(DX_FC)[J];
  auto dxv = [&](int64_t q, int j) { return dx_cf[j] * v[q]; };
  // iyc(dx_v) at the (C, C) point of offset q (y index J)
  auto iyc_dxv = [&](int64_t q) { return half * (dxv(q + sy, J + 1) + dxv(q, J)); };
  T vort;
  if (A.mom == VI_ENERGY) {
    auto qf = [&](int64_t q, int j) { return zeta(H, q, j) * (half * (dxv(q, j) + dxv(q - sx, j))); };
    vort = -(half * (qf(o + sy, J + 1) + qf(o, J))) / dxu;
  } else if (A.mom == VI_ENSTROPHY) {
    const T iyc_zeta = half * (zeta(H, o + sy, J + 1) + zeta(H, o, J));
    vort = (-iyc_zeta * (half * (iyc_dxv(o) + iyc_dxv(o - sx)))) / dxu;
  } else {
    const T v_hat = (half * (iyc_dxv(o) + iyc_dxv(o - sx))) / dxu;
    vort = -weno_vorticity(H, o, sy, true, v_hat);
  }
  // vertical advection izc(ixf(Az w) dzf(u) / dz_f) / Az
  const T az = H.yr(AZ_CC)[J];
  const T* dz_f = H.zr(DZ_F);
  auto qz = [&](int64_t q, int k) {
    return (half * (az * w[q] + az * w[q - sx])) * ((u[q] - u[q - 1]) / dz_f[k]);
  };
  const T vadv = (half * (qz(o + 1, K + 1) + qz(o, K))) / H.yr(AZ_FC)[J];
  const T bern = (bernoulli(H, o) - bernoulli(H, o - sx)) / dxu;
  return vort + vadv + bern;
}

// U.grad(v) at the v point
template <typename T>
__device__ T vi_v(const Here<T>& H) {
  const HydroArgs<T>& A = *H.A;
  const T* u = A.psi[0];
  const T* v = A.psi[1];
  const T* w = A.w;
  const int64_t o = H.o, sx = H.sx, sy = H.sy;
  const int J = H.J, K = H.K;
  const T half = T(0.5);
  const T* dy_c = H.yr(DY_C);
  const T dyv = H.yr(DY_F)[J];
  auto dyu = [&](int64_t q, int j) { return dy_c[j] * u[q]; };
  // ixc(dy_u) at the (C, C) point of offset q, y index j
  auto ixc_dyu = [&](int64_t q, int j) { return half * (dyu(q + sx, j) + dyu(q, j)); };
  T vort;
  if (A.mom == VI_ENERGY) {
    auto qf = [&](int64_t q) { return zeta(H, q, J) * (half * (dyu(q, J) + dyu(q - sy, J - 1))); };
    vort = (half * (qf(o + sx) + qf(o))) / dyv;
  } else if (A.mom == VI_ENSTROPHY) {
    const T ixc_zeta = half * (zeta(H, o + sx, J) + zeta(H, o, J));
    vort = (ixc_zeta * (half * (ixc_dyu(o, J) + ixc_dyu(o - sy, J - 1)))) / dyv;
  } else {
    const T u_hat = (half * (ixc_dyu(o, J) + ixc_dyu(o - sy, J - 1))) / dyv;
    vort = weno_vorticity(H, o, sx, false, u_hat);
  }
  const T* az_cc = H.yr(AZ_CC);
  const T* dz_f = H.zr(DZ_F);
  auto qz = [&](int64_t q, int k) {
    return (half * (az_cc[J] * w[q] + az_cc[J - 1] * w[q - sy])) * ((v[q] - v[q - 1]) / dz_f[k]);
  };
  const T vadv = (half * (qz(o + 1, K + 1) + qz(o, K))) / H.yr(AZ_CF)[J];
  const T bern = (bernoulli(H, o) - bernoulli(H, o - sy)) / dyv;
  return vort + vadv + bern;
}

// ---- flux-form momentum ----------------------------------------------------------

template <typename T>
__device__ T div_vu(const Here<T>& H) {
  const HydroArgs<T>& A = *H.A;
  const T* u = A.psi[0];
  const T* v = A.psi[1];
  const T* w = A.w;
  const int64_t o = H.o, sx = H.sx, sy = H.sy;
  const int I = H.I, J = H.J, K = H.K;
  const bool we = A.mom_weno != 0;
  const T eps = A.eps_m, half = T(0.5);
  const T dz = H.zr(DZ_C)[K];
  const T Ax = H.yr(DY_C)[J] * dz;
  // x fluxes at centres I-1, I (to centres: the stream of face q+1)
  auto fx = [&](int64_t q, int i) {
    return Ax * transport_axis(u, q + sx, sx, half * (u[q + sx] + u[q]), we, eps,
                               we && A.xm, A.xb, i);
  };
  auto fy = [&](int64_t q, int j) {
    return (H.yr(DX_FF)[j] * dz) * transport_axis(u, q, sy, half * (v[q] + v[q - sx]),
                                                  we, eps, we && A.ym, A.yb, j);
  };
  const T az = H.yr(AZ_FC)[J];
  auto fz = [&](int64_t q, int k) {
    return az * z_transport(u, q, half * (w[q] + w[q - sx]), we, eps, H, k);
  };
  return ((fx(o, I) - fx(o - sx, I - 1)) + (fy(o + sy, J + 1) - fy(o, J))
          + (fz(o + 1, K + 1) - fz(o, K))) / (az * dz);
}

template <typename T>
__device__ T div_vv(const Here<T>& H) {
  const HydroArgs<T>& A = *H.A;
  const T* u = A.psi[0];
  const T* v = A.psi[1];
  const T* w = A.w;
  const int64_t o = H.o, sx = H.sx, sy = H.sy;
  const int I = H.I, J = H.J, K = H.K;
  const bool we = A.mom_weno != 0;
  const T eps = A.eps_m, half = T(0.5);
  const T dz = H.zr(DZ_C)[K];
  const T Ax = H.yr(DY_F)[J] * dz;
  auto fx = [&](int64_t q, int i) {
    return Ax * transport_axis(v, q, sx, half * (u[q] + u[q - sy]), we, eps,
                               we && A.xm, A.xb, i);
  };
  // y fluxes at centres J-1, J (to centres)
  auto fy = [&](int64_t q, int j) {
    return (H.yr(DX_CC)[j] * dz) * transport_axis(v, q + sy, sy, half * (v[q + sy] + v[q]),
                                                  we, eps, we && A.ym, A.yb, j);
  };
  const T az = H.yr(AZ_CF)[J];
  auto fz = [&](int64_t q, int k) {
    return az * z_transport(v, q, half * (w[q] + w[q - sy]), we, eps, H, k);
  };
  return ((fx(o + sx, I + 1) - fx(o, I)) + (fy(o, J) - fy(o - sy, J - 1))
          + (fz(o + 1, K + 1) - fz(o, K))) / (az * dz);
}

// ---- tracers ------------------------------------------------------------------

template <typename T>
__device__ T div_Uc(const Here<T>& H, const T* __restrict__ c) {
  const HydroArgs<T>& A = *H.A;
  const T* u = A.psi[0];
  const T* v = A.psi[1];
  const T* w = A.w;
  const int64_t o = H.o, sx = H.sx, sy = H.sy;
  const int I = H.I, J = H.J, K = H.K;
  const bool we = A.tr == 1;
  const T eps = A.eps_t;
  const T dz = H.zr(DZ_C)[K];
  const T Ax = H.yr(DY_C)[J] * dz;
  const T* dx_cf = H.yr(DX_CF);
  const T az = H.yr(AZ_CC)[J];
  const T fxR = Ax * transport_axis(c, o + sx, sx, u[o + sx], we, eps, we && A.xm, A.xb, I + 1);
  const T fxL = Ax * transport_axis(c, o, sx, u[o], we, eps, we && A.xm, A.xb, I);
  const T fyR = (dx_cf[J + 1] * dz) * transport_axis(c, o + sy, sy, v[o + sy], we, eps,
                                                     we && A.ym, A.yb, J + 1);
  const T fyL = (dx_cf[J] * dz) * transport_axis(c, o, sy, v[o], we, eps, we && A.ym, A.yb, J);
  const T fzR = az * z_transport(c, o + 1, w[o + 1], we, eps, H, K + 1);
  const T fzL = az * z_transport(c, o, w[o], we, eps, H, K);
  return (((fxR - fxL) + (fyR - fyL)) + (fzR - fzL)) / (az * dz);
}

// ---- Coriolis ---------------------------------------------------------------------

// (f x u)_x at the u point
template <typename T>
__device__ T f_cross_x(const Here<T>& H) {
  const HydroArgs<T>& A = *H.A;
  const T* v = A.psi[1];
  const int64_t o = H.o, sx = H.sx, sy = H.sy;
  const int J = H.J;
  const T half = T(0.5);
  if (A.cor == PLANE)  // -f ixf(iyc(v))
    return (-H.yr(F_U)[J]) * (half * (half * (v[o + sy] + v[o])
                                      + half * (v[o - sx + sy] + v[o - sx])));
  const T* f = H.yr(F_U);
  const T* dx_cf = H.yr(DX_CF);
  const T dxu = H.yr(DX_FC)[J];
  auto dxv = [&](int64_t q, int j) { return dx_cf[j] * v[q]; };
  if (A.cor == SPHERICAL_ENERGY) {  // -iyc(f ixf(dx v)) / dx
    auto qf = [&](int64_t q, int j) { return f[j] * (half * (dxv(q, j) + dxv(q - sx, j))); };
    return -(half * (qf(o + sy, J + 1) + qf(o, J))) / dxu;
  }
  // enstrophy: -iyc(f) ixf(iyc(dx v)) / dx
  auto iyc_dxv = [&](int64_t q) { return half * (dxv(q + sy, J + 1) + dxv(q, J)); };
  return (-(half * (f[J + 1] + f[J])) * (half * (iyc_dxv(o) + iyc_dxv(o - sx)))) / dxu;
}

// (f x u)_y at the v point
template <typename T>
__device__ T f_cross_y(const Here<T>& H) {
  const HydroArgs<T>& A = *H.A;
  const T* u = A.psi[0];
  const int64_t o = H.o, sx = H.sx, sy = H.sy;
  const int J = H.J;
  const T half = T(0.5);
  if (A.cor == PLANE)  // f iyf(ixc(u))
    return H.yr(F_V)[J] * (half * (half * (u[o + sx] + u[o])
                                   + half * (u[o + sx - sy] + u[o - sy])));
  const T fJ = H.yr(F_U)[J];  // f at (F, F), constant along x
  const T* dy_c = H.yr(DY_C);
  const T dyv = H.yr(DY_F)[J];
  auto dyu = [&](int64_t q, int j) { return dy_c[j] * u[q]; };
  if (A.cor == SPHERICAL_ENERGY) {  // ixc(f iyf(dy u)) / dy
    auto qf = [&](int64_t q) { return fJ * (half * (dyu(q, J) + dyu(q - sy, J - 1))); };
    return (half * (qf(o + sx) + qf(o))) / dyv;
  }
  // enstrophy: ixc(f) iyf(ixc(dy u)) / dy
  auto ixc_dyu = [&](int64_t q, int j) { return half * (dyu(q + sx, j) + dyu(q, j)); };
  return ((half * (fJ + fJ)) * (half * (ixc_dyu(o, J) + ixc_dyu(o - sy, J - 1)))) / dyv;
}

// ---- the kernel ---------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void store(const HydroArgs<T>& A, int f, int64_t p, T g) {
  A.out_g[f][p] = g;
  if (A.advance) A.out_psi[f][p] = A.psi[f][p] + A.dt * (A.c1 * g - A.c2 * A.gp[f][p]);
}

template <typename T>
__global__ void __launch_bounds__(128)
fused_hydrostatic_tendencies_kernel(const HydroArgs<T> A) {
  const int X = A.nx + 2 * A.hx, Y = A.ny + 2 * A.hy, Z = A.nz + 2 * A.hz;
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (int64_t)X * Y * Z) return;
  const int K = (int)(p % Z);
  const int J = (int)((p / Z) % Y);
  const int I = (int)(p / ((int64_t)Y * Z));
  if (I < A.hx || I >= A.hx + A.nx || J < A.hy || J >= A.hy + A.ny ||
      K < A.hz || K >= A.hz + A.nz) {
    for (int f = 0; f < A.nf; ++f) {
      A.out_g[f][p] = T(0);
      if (A.advance) A.out_psi[f][p] = T(0);
    }
    return;
  }
  const Here<T> H{&A, p, (int64_t)Y * Z, (int64_t)Z, I, J, K, Y, Z};
  // u
  T g = T(0);
  if (A.mom == FLUX_FORM) g = -div_vu(H);
  else if (A.mom != NO_MOMENTUM) g = -vi_u(H);
  if (A.cor != NO_CORIOLIS) g = g - f_cross_x(H);
  if (A.ph != nullptr) g = g - (A.ph[p] - A.ph[p - H.sx]) / H.yr(DX_FC)[J];
  store(A, 0, p, g);
  // v
  g = T(0);
  if (A.mom == FLUX_FORM) g = -div_vv(H);
  else if (A.mom != NO_MOMENTUM) g = -vi_v(H);
  if (A.cor != NO_CORIOLIS) g = g - f_cross_y(H);
  if (A.ph != nullptr) g = g - (A.ph[p] - A.ph[p - H.sy]) / H.yr(DY_F)[J];
  store(A, 1, p, g);
  // tracers
  for (int f = 2; f < A.nf; ++f)
    store(A, f, p, A.tr < 0 ? T(0) : -div_Uc(H, A.psi[f]));
}

template <typename T>
static int launch(const void* const* psi, const void* w, const void* ph,
                  const void* ys, const void* zs, const void* const* gp,
                  void* const* out_g, void* const* out_psi, int nf, int nx,
                  int ny, int nz, int hx, int hy, int hz, int mom, int mom_weno,
                  int tr, int cor, int tables, int advance, const int* b,
                  double eps_m, double eps_t, double c1, double c2, double dt,
                  void* stream) {
  if (nf < 2 || nf > MAX_FIELDS) return (int)cudaErrorInvalidValue;
  if (advance && (gp == nullptr || out_psi == nullptr)) return (int)cudaErrorInvalidValue;
  HydroArgs<T> A;
  for (int f = 0; f < MAX_FIELDS; ++f) {
    const bool on = f < nf;
    A.psi[f] = on ? static_cast<const T*>(psi[f]) : nullptr;
    A.out_g[f] = on ? static_cast<T*>(out_g[f]) : nullptr;
    A.gp[f] = on && advance ? static_cast<const T*>(gp[f]) : nullptr;
    A.out_psi[f] = on && advance ? static_cast<T*>(out_psi[f]) : nullptr;
  }
  A.w = static_cast<const T*>(w);
  A.ph = static_cast<const T*>(ph);
  A.ys = static_cast<const T*>(ys);
  A.zs = static_cast<const T*>(zs);
  A.nf = nf; A.nx = nx; A.ny = ny; A.nz = nz; A.hx = hx; A.hy = hy; A.hz = hz;
  A.mom = mom; A.mom_weno = mom_weno; A.tr = tr; A.cor = cor;
  A.tables = tables; A.advance = advance;
  A.xm = b[0]; A.xb = Bounds{b[1], b[2], b[3], b[4]};
  A.ym = b[5]; A.yb = Bounds{b[6], b[7], b[8], b[9]};
  A.zm = b[10]; A.zb = Bounds{b[11], b[12], b[13], b[14]};
  A.eps_m = T(eps_m); A.eps_t = T(eps_t);
  A.c1 = T(c1); A.c2 = T(c2); A.dt = T(dt);
  const int64_t n = (int64_t)(nx + 2 * hx) * (ny + 2 * hy) * (nz + 2 * hz);
  if (n == 0) return 0;
  const int threads = 128;
  const int64_t blocks = (n + threads - 1) / threads;
  fused_hydrostatic_tendencies_kernel<T><<<(unsigned int)blocks, threads, 0,
                                           static_cast<cudaStream_t>(stream)>>>(A);
  return (int)cudaGetLastError();
}

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). Pointer arrays
// are host arrays of nf device pointers; `ph` may be null, `gp` and
// `out_psi` are null unless `advance`. The 15 bound ints are, for x, y and
// z: masked, lo_l, hi_l, lo_r, hi_r.
#define FUSED_HYDROSTATIC_TENDENCIES(NAME, T)                                  \
  int NAME(const void* const* psi, const void* w, const void* ph,              \
           const void* ys, const void* zs, const void* const* gp,              \
           void* const* out_g, void* const* out_psi, int nf, int nx, int ny,   \
           int nz, int hx, int hy, int hz, int mom, int mom_weno, int tr,      \
           int cor, int tables, int advance, int b0, int b1, int b2, int b3,   \
           int b4, int b5, int b6, int b7, int b8, int b9, int b10, int b11,   \
           int b12, int b13, int b14, double eps_m, double eps_t, double c1,   \
           double c2, double dt, void* stream) {                               \
    const int b[15] = {b0, b1, b2, b3, b4, b5, b6, b7,                         \
                       b8, b9, b10, b11, b12, b13, b14};                       \
    return launch<T>(psi, w, ph, ys, zs, gp, out_g, out_psi, nf, nx, ny, nz,   \
                     hx, hy, hz, mom, mom_weno, tr, cor, tables, advance, b,   \
                     eps_m, eps_t, c1, c2, dt, stream);                        \
  }

FUSED_HYDROSTATIC_TENDENCIES(fused_hydrostatic_tendencies_f32, float)
FUSED_HYDROSTATIC_TENDENCIES(fused_hydrostatic_tendencies_f64, double)

}  // extern "C"
