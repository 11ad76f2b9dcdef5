// Fused hydrostatic tendencies (K4b): for the hydrostatic model's u, v and
// tracers,
//
//   G_u = -U.grad(u) [vector invariant] or -div(v u) [flux form]
//         - (f x u)_x - d(pHY')/dx [+ div(nu grad u)],      G_v likewise,
//   G_c = -div(U c) [+ div(kappa_c grad c)],
//
// optionally with the AB2 advance psi' = psi + dt (c1 G - c2 G_prev), on
// lat-lon or rectilinear grids whose metrics are constant along x (rows over
// with-halo y and z, ops/metric_rows.py), stretched y and z axes included.
// The outputs are with-halo: the interior computed, the halos zero.
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
//     on bounded x, y and z (the vorticity reconstruction has none), on a
//     stretched y or z the two-sided reconstruction with the table rows of
//     advection/reconstruction_tables.py and the upwind product, and next to
//     an immersed boundary the conditional fluxes (first-order upwind where
//     a WENO5 stencil reaches a solid cell), read from one uint8 of clear
//     flags a point and location (ops/fused_hydrostatic.py::clear_flags,
//     built once per grid by the plain version's own rolls, so they wrap at
//     the array edges as the plain version does);
//   - closures/scalar_diffusivity.py div_kappa_grad of a constant-coefficient
//     ScalarDiffusivity (kernel_closure): the x and y fluxes Ax kh d/dx and
//     Ay kh d/dy and, unless the closure is vertically implicit, Az kv d/dz,
//     differenced and over V, in that tree, a kh and kv per field (per-tracer
//     kappa included); it reads the staged boxes at +-1;
//   - coriolis/coriolis.py: f- and beta-plane (rows of f at U_LOC, V_LOC)
//     and HydrostaticSphericalCoriolis (row of f at (F, F)), energy or
//     enstrophy.
// Every division is ieee_div or ieee_div_by (weno5_advection.cuh): IEEE's
// own quotient, bit for bit, kept off the hardware's slow path, which the
// 1/4 degree path's zero tracers (T = S = 0) and z-only buoyancy would
// otherwise take at most of their WENO5 weights and candidate stencils. --fmad=false, so the compiler forms no FMA that
// eager PyTorch does not.
//
// What bounds it on an H100: at the 1/4 degree flagship (1446 x 606 x 30 with
// halos, fp32, u, v, T, S, b) in advance mode it reads 7 with-halo fields
// (u, v, w, pHY', three tracers; 105 MB each) and five G_prev and writes five
// psi' and five G: about 2.3 GB, 0.69 ms at 3.35 TB/s. The function needs
// about 1,300 flops a point (two WENO5 vorticity reconstructions with
// velocity smoothness, three WENO5 fluxes for each of three tracers, the z
// one two-sided with the tables, the divergences and the epilogue), about
// 27 GFLOP: 0.40 ms at the 67 TFLOP/s fp32 peak, so memory bounds it.
// In practice the kernel is bound by latency: one 512-thread block an SM
// (16 warps), long dependent chains of WENO5 arithmetic and divisions, and
// the block's first copies, which nothing overlaps (PERF.md has its times
// and the share of each phase).
// Tensor cores (wgmma) have no part: the stencils hold no matrix product.
//
// The design. A block of 512 threads owns a 16 x 8 tile of interior (x, y)
// columns and a chunk of KZ interior levels (the whole column, 24 levels,
// at 1/4 degree in fp32; the host picks KZ so that shared memory fits):
//   1. It copies u and v over the tile, its 3-cell x/y halo and 3 levels
//      either side, and w over the tile plus one column below in x and y,
//      into shared memory with cp.async (tiles.cuh); they stay
//      resident. The first tracer's copy is issued at once as well.
//   2. Momentum: zeta, iyf(u) and ixf(v) once per (F, F) point of the tile
//      and its 2-point halo (the vorticity streams of u along y and of v
//      along x), and the Bernoulli head once per (C, C) point, all levels
//      at once, into shared memory; then G_u and G_v per point. (Flux-form
//      momentum reads the staged fields and computes each face in both
//      cells beside it.)
//   3. Tracers, one at a time through a double buffer: while tracer f's
//      face fluxes are computed, tracer f+1's copy is in flight. Each x, y
//      and z face flux is computed once into shared memory (cell I's fxR
//      is cell I+1's fxL, the same expression on the same operands; level
//      k's fzR is level k+1's fzL) and the divergence differences them.
//      The z fluxes sit in shared memory rather than in a register carried
//      up the column, so that the 32 lanes of a warp take 32 consecutive
//      levels and every global load and store of a point coalesces.
//   4. Blocks of the first and last level chunk write the z-halo zeros of
//      their columns; blocks on the domain's x or y edge write the zeros of
//      the halo columns next to their tile: every halo point once, in the
//      same launch.
// The kernel is a template on the momentum scheme, the Coriolis form, the
// z tables, the advance (-1: read at run time), XTRA (the closure, the
// clear flags and the y tables read at run time, or none of them) and ANY;
// the 1/4 degree flagship has its own instantiations with no dead branches,
// every other configuration takes the run-time one. The flagship's and the
// run-time one take WENO5 or the centred scheme (flux-form momentum,
// tracers); a configuration with another of the eight schemes takes the
// run-time ANY instantiation: each scheme by its code with its own
// near-wall bounds (weno5_advection.cuh's transport_any: PositiveWENO5's
// to-faces transports limited, with the y and z tables on stretched axes,
// each face its own row; UB1, UB3, UB5 and C4 their uniform stencils even
// there, as JAX's transport takes tables only for the WENO5 family); with
// WENO5's bf16 options its bf16 sub-form (BF), which alone carries the
// bf16 forms of the reconstructions.
// Beyond the TPU kernel (whose gate leaves them to jnp): a Flat x, a Flat y
// or both, and the Cartesian Coriolis forms (ConstantCartesianCoriolis and
// NonTraditionalBetaPlane: fy ixf(izc(w)) - fz ixf(iyc(v)) and
// fz iyf(ixc(u)) [- fx iyf(izc(w))], rows of fz, fy, fx; their w terms read
// the staged w box). These take the run-time form with every scheme (ANY
// with BF) in layouts of their own (HTile): a line of 128 columns along the
// axis that is not Flat (one column when both are), so that no thread idles
// on an axis of extent 1, strides 0 along the Flat axis, and the Cartesian
// forms in the 16 x 8 tile. Their kernels call their own instantiations of
// the out-of-line device functions (NEW), and every earlier instantiation
// compiles as it did.
// On partial bottom cells (PartialCellBottom: a 3D dz at z-centres and one
// at z-faces, in the fields' layout) the run-time form takes one more flag,
// D3, in the 16 x 8 tile with every scheme, option and Coriolis form (ANY,
// BF, CART; launched through the _dz3 entries): each face area and volume
// reads dz at its own point, as the port's ImmersedGrid gives Ax, Ay and V
// (an x face of index i the dz_ccc of cell i, a y face of index j that of
// cell j), and the vertical advection of the vector-invariant form reads
// dz_ccf there; the dz values come from global memory through the cache, one
// a face, beside the staged fields. The JAX kernel's gate refuses these
// grids (JAX runs them in jnp). The closure never takes this form: the model
// adds an immersed grid's diffusion as torch ops.
// __launch_bounds__(512, 1) keeps a thread at 128 registers or fewer, so
// 16 warps fit on an SM.
#include <cuda_runtime.h>

#include "tiles.cuh"
#include "weno5_advection.cuh"

// rows of ops/metric_rows.py: Y_ROWS; the z rows' layout (Z_DZ_C, Z_DZ_F,
// then the 24 table rows) is weno5_advection.cuh's
enum { DX_CC = 0, DX_CF, DX_FC, DX_FF, AZ_CC, AZ_CF, AZ_FC, AZ_FF, DY_C, DY_F,
       F_U, F_V, F2_U, F2_V };
// momentum: the vector-invariant schemes in advection/vector_invariant.py's
// SCHEMES order, then the flux form and none
enum { VI_ENSTROPHY = 0, VI_ENERGY, VI_WENO, VI_WENO_VELOCITY, FLUX_FORM, NO_MOMENTUM };
// CARTESIAN: ConstantCartesianCoriolis (rows fz, fz, fy, fx); NON_TRADITIONAL:
// NonTraditionalBetaPlane (rows fz at u, fz at v, fy at u)
enum { NO_CORIOLIS = 0, PLANE, SPHERICAL_ENERGY, SPHERICAL_ENSTROPHY, CARTESIAN,
       NON_TRADITIONAL };

// the diffusing field's location: u (F, C, C), v (C, F, C), a tracer (C, C, C)
enum { AT_U = 0, AT_V, AT_C };
// the closure: none, its horizontal part only (vertically implicit), or all
enum { NO_CLOSURE = 0, CLOSURE_H, CLOSURE_HZ };

template <typename T>
struct HydroArgs {
  const T* psi[MAX_FIELDS];   // with-halo u, v, tracers
  const T* w;                 // with-halo w
  const T* ph;                // with-halo pHY', or nullptr
  const T* ys;                // y rows (12, Y)
  const T* zs;                // z rows (2 or 26, Z)
  const T* yt;                // a stretched y's WENO5 tables (48, Y), or nullptr
  const uint8_t* clr[3];      // clear flags of C, U and V (bit a: axis a), or nullptr
  const T* gp[MAX_FIELDS];    // with-halo G_prev (advance)
  T* out_g[MAX_FIELDS];       // with-halo G
  T* out_psi[MAX_FIELDS];     // with-halo psi' (advance)
  T kh[MAX_FIELDS], kv[MAX_FIELDS];  // the closure's horizontal and vertical coefficient by field
  int nf, nx, ny, nz, hx, hy, hz;
  // momentum form (VI_*, FLUX_FORM, NO_MOMENTUM), the flux form's scheme
  // and the tracers' (SCHEME_*, -1: no tracer advection)
  int mom, sm, tr, cor, tables, ytables, closure, advance;
  // near-wall order reduction on that axis: the flux-form momentum
  // scheme's or, in the first-code forms where it reduces nowhere, the
  // tracers' (one set serves both there: WENO5's)
  int xm, ym, zm;
  Bounds xb, yb, zb;
  T eps_m, eps_t, c1, c2, dt;
  int kz, nty;                // levels per chunk, tiles along y
  FastDiv kzd, kz1d, h2d;     // division by kz, kz + 1 and 2 hz
  // ANY: the tracer scheme's near-wall reduction, and PositiveWENO5's
  // bounds, momentum / tracers (last, so that the first-code forms read
  // every other field where they did before these came)
  int xm_t, ym_t, zm_t;
  Bounds xb_t, yb_t, zb_t;
  T lo_m, hi_m, lo_t, hi_t;
  int bf_m, bf_t;  // BF: WENO5's bf16 option, flux-form momentum / tracers
  // D3 (partial cells): the 3D with-halo dz at z-centres and at z-faces,
  // in the fields' layout (the z rows' dz entries are not read)
  const T* dzc3;
  const T* dzf3;
};

// the tile and its shared-memory boxes, all with z (levels) fastest
constexpr int HT_THREADS = 512, HT_R = 3;

// The block's tile of columns by layout: 16 x 8 (x by y) where neither x nor
// y is Flat; on a Flat x a line of 128 columns along y, on a Flat y a line
// of 128 along x, on both one column. A Flat axis has extent 1 and halo 0,
// and every neighbour along it is the cell itself, as the plain version's
// roll of an axis of extent 1 makes it: its strides are 0 in every staged
// box and in the arrays, so each stencil reads the cell's own value in the
// plain version's expression, and each box has extent 1 along it.
enum { LAYOUT_TILE = 0, LAYOUT_FLAT_X, LAYOUT_FLAT_Y, LAYOUT_FLAT_XY };
template <int L>
struct HTile {
  static constexpr bool FX = L == LAYOUT_FLAT_X || L == LAYOUT_FLAT_XY;
  static constexpr bool FY = L == LAYOUT_FLAT_Y || L == LAYOUT_FLAT_XY;
  static constexpr int X = L == LAYOUT_TILE ? 16 : (FX ? 1 : 128);
  static constexpr int Y = L == LAYOUT_TILE ? 8 : (FY ? 1 : 128);
  static constexpr int COLS = X * Y;
  // a box's extent along x and y reaching lo cells below the tile and hi above
  static constexpr int ex(int lo, int hi) { return FX ? 1 : X + lo + hi; }
  static constexpr int ey(int lo, int hi) { return FY ? 1 : Y + lo + hi; }
  // the y extents of the boxes: u, v, tracers (3-cell halo); w and the
  // Bernoulli head (1 below); the zeta streams (2 below, 3 above); the y
  // faces
  static constexpr int BY = ey(HT_R, HT_R), WY = ey(1, 0), FFY = ey(2, 3), YFY = ey(0, 1);
  static constexpr int BOX = ex(HT_R, HT_R) * BY;
  static constexpr int WBOX = ex(1, 0) * WY;
  static constexpr int FFBOX = ex(2, 3) * FFY;
  static constexpr int XF = ex(0, 1) * Y, YF = X * YFY;  // x and y face fluxes
};

// elements of T in shared memory for a chunk of kz levels: u, v, w, tracer
// buffer 0, then one region used first by the momentum arrays (zeta, iyf(u),
// ixf(v), Bernoulli) and then by tracer buffer 1 and the face fluxes
template <int L>
static long hydro_smem_elems(int kz) {
  using TL = HTile<L>;
  const long zs = kz + 2 * HT_R;
  const long uv = 2L * TL::BOX * zs, w = (long)TL::WBOX * (kz + 1), tb = (long)TL::BOX * zs;
  const long mom = (3L * TL::FFBOX + TL::WBOX) * kz;
  const long tra = tb + (long)(TL::XF + TL::YF) * kz + (long)TL::COLS * (kz + 1);
  return uv + w + tb + (mom > tra ? mom : tra);
}

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
__device__ __forceinline__ T weno_stream_smooth(const T* a, const T* s, const T* q, T eps) {
  const T d10 = a[1] - a[0], d11 = a[2] - a[1], d12 = a[3] - a[2], d13 = a[4] - a[3];
  const T p0 = a[2] + ieee_div_by(T(5.0) * d11 - T(2.0) * d10, T(6.0));
  const T p1 = a[2] + ieee_div_by(T(2.0) * d12 + d11, T(6.0));
  const T p2 = a[2] + ieee_div_by(T(4.0) * d12 - d13, T(6.0));
  T b[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    b[k] = ieee_div_by(smoothness(s[0], s[1], s[2], s[3], s[4], k)
                       + smoothness(q[0], q[1], q[2], q[3], q[4], k), T(2.0));
  return combine(p0, p1, p2, b[0], b[1], b[2], T(0.1), T(0.6), T(0.3), eps);
}

// ---- the conditional fluxes ----------------------------------------------------

// the clear flag of the transport along `axis` at with-halo point p of a
// field whose flags are f (nullptr: no immersed boundary)
__device__ __forceinline__ bool clear_at(const uint8_t* f, int64_t p, int axis) {
  return f == nullptr || ((__ldg(f + p) >> axis) & 1) != 0;
}

// ---- the closure -----------------------------------------------------------------

// scalar_diffusivity.py::div_kappa_grad at one point (I=J row index J,
// level K) of a field at location `at` in c (offset o, strides sx, sy and
// 1): the fluxes Ax kh dc/dx at the point's x faces, Ay kh dc/dy at its y
// faces and, with `vertical`, Az kv dc/dz at its z faces, differenced, over
// V. The rows are the y and z rows of ops/metric_rows.py.
template <typename T, typename I>
__device__ __forceinline__ T diffusion(const T* __restrict__ c, I o, I sx, I sy, const T* ys,
                                       const T* zs, int Y, int Z, int J, int K, int at,
                                       T kh, T kv, bool vertical) {
  const T dzc = zs[Z_DZ_C * Z + K];
  // x: dx at the x faces' location, dy of the x faces' area
  const int rdx = at == AT_U ? DX_CC : (at == AT_V ? DX_FF : DX_FC);
  const int rdy = at == AT_V ? DY_F : DY_C;
  const T ax = ys[rdy * Y + J] * dzc, dx = ys[rdx * Y + J];
  const T xr = ax * (kh * ieee_div(c[o + sx] - c[o], dx));
  const T xl = ax * (kh * ieee_div(c[o] - c[o - sx], dx));
  // y: the faces above and below are rows jt and jb (centres J and J-1 for
  // v, faces J+1 and J otherwise)
  const int ray = at == AT_U ? DX_FF : (at == AT_V ? DX_CC : DX_CF);
  const int rsy = at == AT_V ? DY_C : DY_F;
  const int jt = at == AT_V ? J : J + 1, jb = jt - 1;
  const T ytop = (ys[ray * Y + jt] * dzc) * (kh * ieee_div(c[o + sy] - c[o], ys[rsy * Y + jt]));
  const T ybot = (ys[ray * Y + jb] * dzc) * (kh * ieee_div(c[o] - c[o - sy], ys[rsy * Y + jb]));
  const T az = ys[(at == AT_U ? AZ_FC : (at == AT_V ? AZ_CF : AZ_CC)) * Y + J];
  T out = (xr - xl) + (ytop - ybot);
  if (vertical) {
    const T* dzf = zs + Z_DZ_F * Z;
    const T zt = az * (kv * ieee_div(c[o + 1] - c[o], dzf[K + 1]));
    const T zb = az * (kv * ieee_div(c[o] - c[o - 1], dzf[K]));
    out = out + (zt - zb);
  }
  return ieee_div(out, az * dzc);
}

// ---- one output point --------------------------------------------------------

// The point (I, J, K) in the staged boxes: o in the u/v/tracer box (strides
// sx, sy, 1), ow in the w box (strides wsx, wsy, 1); rows by with-halo y
// (stride Y) and z (stride Z).
template <typename T>
struct Pt {
  const HydroArgs<T>* A;
  const T* u;
  const T* v;
  const T* w;
  int o, sx, sy, ow, wsx, wsy;
  int I, J, K, Y, Z;
  __device__ __forceinline__ const T* yr(int r) const { return A->ys + r * Y; }
  __device__ __forceinline__ const T* zr(int r) const { return A->zs + r * Z; }
};

// Bernoulli head K at the (C, C) point of staged offset q
template <typename T>
__device__ __forceinline__ T bernoulli(const T* u, const T* v, int q, int sx, int sy) {
  const T half = T(0.5);
  return half * (half * (u[q + sx] * u[q + sx] + u[q] * u[q])
                 + half * (v[q + sy] * v[q + sy] + v[q] * v[q]));
}

// the shared-memory momentum arrays of a chunk: zeta, iyf(u), ixf(v) at the
// (F, F) points from (I0-2, J0-2), the Bernoulli head at the (C, C) points
// from (I0-1, J0-1); level index k - K0 fastest
template <typename T, int L>
struct MomArrays {
  const T* zeta;
  const T* su;
  const T* sv;
  const T* bern;
  int I0, J0, K0, kz;
  __device__ __forceinline__ int ff(int i, int j, int k) const {
    using TL = HTile<L>;
    if constexpr (L == LAYOUT_TILE)
      return ((i - I0 + 2) * (TL::Y + 5) + (j - J0 + 2)) * kz + (k - K0);
    else
      return ((TL::FX ? 0 : i - I0 + 2) * TL::FFY + (TL::FY ? 0 : j - J0 + 2)) * kz + (k - K0);
  }
  __device__ __forceinline__ int cc(int i, int j, int k) const {
    using TL = HTile<L>;
    if constexpr (L == LAYOUT_TILE)
      return ((i - I0 + 1) * (TL::Y + 1) + (j - J0 + 1)) * kz + (k - K0);
    else
      return ((TL::FX ? 0 : i - I0 + 1) * TL::WY + (TL::FY ? 0 : j - J0 + 1)) * kz + (k - K0);
  }
};

// select-first WENO5 of zeta onto a centre along y (u) or x (v), the stream
// from the face pair nearest the centre: vel * rec
template <typename T, int L>
__device__ __forceinline__ T weno_vorticity(const Pt<T>& P, const MomArrays<T, L>& M,
                                            bool along_y, T vel, int mom) {
  const bool sel = vel >= T(0);
  T z[5], su[5], sv[5];
#pragma unroll
  for (int m = 0; m < 5; ++m) {
    const int n = sel ? m - 2 : 3 - m;
    const int q = along_y ? M.ff(P.I, P.J + n, P.K) : M.ff(P.I + n, P.J, P.K);
    z[m] = M.zeta[q];
    if (mom == VI_WENO_VELOCITY) {
      su[m] = M.su[q];
      sv[m] = M.sv[q];
    }
  }
  const T rec = mom == VI_WENO_VELOCITY
                    ? weno_stream_smooth(z, su, sv, T(1e-6))
                    : weno_stream(z[0], z[1], z[2], z[3], z[4], T(1e-6));
  return vel * rec;
}

// U.grad(u) at the u point; D3: dz_f from the 3D array at (I, J, k)
template <typename T, int L, bool D3 = false>
__device__ __forceinline__ T vi_u(const Pt<T>& P, const MomArrays<T, L>& M, int mom) {
  const T* u = P.u;
  const T* v = P.v;
  const T* w = P.w;
  const int o = P.o, sx = P.sx, sy = P.sy, J = P.J, K = P.K;
  const T half = T(0.5);
  const T* dx_cf = P.yr(DX_CF);
  const T dxu = P.yr(DX_FC)[J];
  auto dxv = [&](int q, int j) { return dx_cf[j] * v[q]; };
  // iyc(dx_v) at the (C, C) point of offset q (y index J)
  auto iyc_dxv = [&](int q) { return half * (dxv(q + sy, J + 1) + dxv(q, J)); };
  auto zeta = [&](int i, int j) { return M.zeta[M.ff(i, j, K)]; };
  T vort;
  if (mom == VI_ENERGY) {
    auto qf = [&](int q, int j) { return zeta(P.I, j) * (half * (dxv(q, j) + dxv(q - sx, j))); };
    vort = ieee_div(-(half * (qf(o + sy, J + 1) + qf(o, J))), dxu);
  } else if (mom == VI_ENSTROPHY) {
    const T iyc_zeta = half * (zeta(P.I, J + 1) + zeta(P.I, J));
    vort = ieee_div(-iyc_zeta * (half * (iyc_dxv(o) + iyc_dxv(o - sx))), dxu);
  } else {
    const T v_hat = ieee_div(half * (iyc_dxv(o) + iyc_dxv(o - sx)), dxu);
    vort = -weno_vorticity(P, M, true, v_hat, mom);
  }
  // vertical advection izc(ixf(Az w) dzf(u) / dz_f) / Az
  const T az = P.yr(AZ_CC)[J];
  const T* dz_f = P.zr(Z_DZ_F);
  if constexpr (D3) dz_f = P.A->dzf3 + ((int64_t)P.I * P.Y + J) * P.Z;
  auto qz = [&](int q, int qw, int k) {
    return (half * (az * w[qw] + az * w[qw - P.wsx])) * ieee_div(u[q] - u[q - 1], dz_f[k]);
  };
  const T vadv = ieee_div(half * (qz(o + 1, P.ow + 1, K + 1) + qz(o, P.ow, K)), P.yr(AZ_FC)[J]);
  const T bern = ieee_div(M.bern[M.cc(P.I, J, K)] - M.bern[M.cc(P.I - 1, J, K)], dxu);
  return vort + vadv + bern;
}

// U.grad(v) at the v point; D3: dz_f from the 3D array at (I, J, k)
template <typename T, int L, bool D3 = false>
__device__ __forceinline__ T vi_v(const Pt<T>& P, const MomArrays<T, L>& M, int mom) {
  const T* u = P.u;
  const T* v = P.v;
  const T* w = P.w;
  const int o = P.o, sx = P.sx, sy = P.sy, J = P.J, K = P.K;
  const T half = T(0.5);
  const T* dy_c = P.yr(DY_C);
  const T dyv = P.yr(DY_F)[J];
  auto dyu = [&](int q, int j) { return dy_c[j] * u[q]; };
  // ixc(dy_u) at the (C, C) point of offset q, y index j
  auto ixc_dyu = [&](int q, int j) { return half * (dyu(q + sx, j) + dyu(q, j)); };
  auto zeta = [&](int i) { return M.zeta[M.ff(i, J, K)]; };
  T vort;
  if (mom == VI_ENERGY) {
    auto qf = [&](int q, int i) { return zeta(i) * (half * (dyu(q, J) + dyu(q - sy, J - 1))); };
    vort = ieee_div(half * (qf(o + sx, P.I + 1) + qf(o, P.I)), dyv);
  } else if (mom == VI_ENSTROPHY) {
    const T ixc_zeta = half * (zeta(P.I + 1) + zeta(P.I));
    vort = ieee_div(ixc_zeta * (half * (ixc_dyu(o, J) + ixc_dyu(o - sy, J - 1))), dyv);
  } else {
    const T u_hat = ieee_div(half * (ixc_dyu(o, J) + ixc_dyu(o - sy, J - 1)), dyv);
    vort = weno_vorticity(P, M, false, u_hat, mom);
  }
  const T* az_cc = P.yr(AZ_CC);
  const T* dz_f = P.zr(Z_DZ_F);
  if constexpr (D3) dz_f = P.A->dzf3 + ((int64_t)P.I * P.Y + J) * P.Z;
  auto qz = [&](int q, int qw, int k) {
    return (half * (az_cc[J] * w[qw] + az_cc[J - 1] * w[qw - P.wsy]))
           * ieee_div(v[q] - v[q - 1], dz_f[k]);
  };
  const T vadv = ieee_div(half * (qz(o + 1, P.ow + 1, K + 1) + qz(o, P.ow, K)), P.yr(AZ_CF)[J]);
  const T bern = ieee_div(M.bern[M.cc(P.I, J, K)] - M.bern[M.cc(P.I, J - 1, K)], dyv);
  return vort + vadv + bern;
}

// ---- flux-form momentum: each face computed in both cells beside it ---------

// the z and y table rows of a point's transports (row 0 of each set); the
// flags of the conditional fluxes are read only with an immersed boundary
template <typename T>
struct Tabs {
  ZRows<T> z, yf, yc;  // z to faces; y to faces, to centres
  bool zon, yon;
};

// The ANY instantiation's transports are weno5_advection.cuh's transport_any
// (every scheme by its code, PositiveWENO5's to-faces transports limited);
// the first-code forms call transport_tables with WENO5 or centred, in the
// expressions they had before the other schemes came, so that they compile
// as they did.

// D3: each face's area and the cell's volume from the 3D dz at the
// centres beside the point (dz_ccc at the centre I or I - 1 of an x flux,
// at (I, j) of a y flux), as ImmersedGrid's Ax, Ay and V read it
template <bool ANY, bool BF, bool NEW, typename T, bool D3 = false>
__device__ T div_vu(const Pt<T>& P, const Tabs<T>& tb, const uint8_t* clr, int64_t gsx,
                    int64_t gsy) {
  const HydroArgs<T>& A = *P.A;
  const T* u = P.u;
  const T* v = P.v;
  const T* w = P.w;
  const int o = P.o, sx = P.sx, sy = P.sy, I = P.I, J = P.J, K = P.K;
  const bool we = A.sm != 0;
  const T eps = A.eps_m, half = T(0.5);
  const T dz = P.zr(Z_DZ_C)[K];
  const T Ax = P.yr(DY_C)[J] * dz;
  const int64_t g = I * gsx + J * gsy + K;
  // x fluxes at centres I-1, I (to centres: the stream of face q+1)
  auto fx = [&](int q, int i) {
    if constexpr (D3)
      return (P.yr(DY_C)[J] * A.dzc3[g + (i - I) * gsx])
             * transport_any<true, BF>(u, q + sx, sx, half * (u[q + sx] + u[q]), A.sm, eps,
                                   A.xm != 0, A.xb, i, false, tb.z, false, clr,
                                   g + (i - I) * gsx, gsx, 1, A.lo_m, A.hi_m, A.bf_m);
    else if constexpr (ANY)
      return Ax * transport_any<true, BF>(u, q + sx, sx, half * (u[q + sx] + u[q]), A.sm, eps,
                                      A.xm != 0, A.xb, i, false, tb.z, false, clr,
                                      g + (i - I) * gsx, gsx, 1, A.lo_m, A.hi_m, A.bf_m);
    else
      return Ax * transport_tables(u, q + sx, sx, half * (u[q + sx] + u[q]), we, eps,
                                   we && A.xm, A.xb, i, false, tb.z,
                                   clear_at(clr, g + (i - I) * gsx, 0));
  };
  auto fy = [&](int q, int j) {
    if constexpr (D3)
      return (P.yr(DX_FF)[j] * A.dzc3[g + (j - J) * gsy])
             * transport_any<true, BF>(u, q, sy, half * (v[q] + v[q - sx]), A.sm, eps, A.ym != 0,
                                   A.yb, j, tb.yon, tb.yf, true, clr, g + (j - J) * gsy, gsy,
                                   2, A.lo_m, A.hi_m, A.bf_m);
    else if constexpr (ANY)
      return (P.yr(DX_FF)[j] * dz)
             * transport_any<true, BF>(u, q, sy, half * (v[q] + v[q - sx]), A.sm, eps, A.ym != 0,
                                   A.yb, j, tb.yon, tb.yf, true, clr, g + (j - J) * gsy, gsy,
                                   2, A.lo_m, A.hi_m, A.bf_m);
    else
      return (P.yr(DX_FF)[j] * dz) * transport_tables(u, q, sy, half * (v[q] + v[q - sx]), we,
                                                      eps, we && A.ym, A.yb, j, we && tb.yon,
                                                      tb.yf, clear_at(clr, g + (j - J) * gsy, 1));
  };
  const T az = P.yr(AZ_FC)[J];
  auto fz = [&](int q, int qw, int k) {
    if constexpr (ANY)
      return az * transport_any<true, BF>(u, q, 1, half * (w[qw] + w[qw - P.wsx]), A.sm, eps,
                                      A.zm != 0, A.zb, k, tb.zon, tb.z, true, clr, g + (k - K),
                                      1, 4, A.lo_m, A.hi_m, A.bf_m);
    else
      return az * transport_tables(u, q, 1, half * (w[qw] + w[qw - P.wsx]), we, eps,
                                   we && A.zm != 0, A.zb, k, we && tb.zon, tb.z,
                                   clear_at(clr, g + (k - K), 2));
  };
  if constexpr (D3)
    return ieee_div((fx(o, I) - fx(o - sx, I - 1)) + (fy(o + sy, J + 1) - fy(o, J))
                    + (fz(o + 1, P.ow + 1, K + 1) - fz(o, P.ow, K)), az * A.dzc3[g]);
  else
    return ieee_div((fx(o, I) - fx(o - sx, I - 1)) + (fy(o + sy, J + 1) - fy(o, J))
                    + (fz(o + 1, P.ow + 1, K + 1) - fz(o, P.ow, K)), az * dz);
}

template <bool ANY, bool BF, bool NEW, typename T, bool D3 = false>
__device__ T div_vv(const Pt<T>& P, const Tabs<T>& tb, const uint8_t* clr, int64_t gsx,
                    int64_t gsy) {
  const HydroArgs<T>& A = *P.A;
  const T* u = P.u;
  const T* v = P.v;
  const T* w = P.w;
  const int o = P.o, sx = P.sx, sy = P.sy, I = P.I, J = P.J, K = P.K;
  const bool we = A.sm != 0;
  const T eps = A.eps_m, half = T(0.5);
  const T dz = P.zr(Z_DZ_C)[K];
  const T Ax = P.yr(DY_F)[J] * dz;
  const int64_t g = I * gsx + J * gsy + K;
  auto fx = [&](int q, int i) {
    if constexpr (D3)
      return (P.yr(DY_F)[J] * A.dzc3[g + (i - I) * gsx])
             * transport_any<true, BF>(v, q, sx, half * (u[q] + u[q - sy]), A.sm, eps,
                                   A.xm != 0, A.xb, i, false, tb.z, true, clr,
                                   g + (i - I) * gsx, gsx, 1, A.lo_m, A.hi_m, A.bf_m);
    else if constexpr (ANY)
      return Ax * transport_any<true, BF>(v, q, sx, half * (u[q] + u[q - sy]), A.sm, eps,
                                      A.xm != 0, A.xb, i, false, tb.z, true, clr,
                                      g + (i - I) * gsx, gsx, 1, A.lo_m, A.hi_m, A.bf_m);
    else
      return Ax * transport_tables(v, q, sx, half * (u[q] + u[q - sy]), we, eps, we && A.xm,
                                   A.xb, i, false, tb.z, clear_at(clr, g + (i - I) * gsx, 0));
  };
  // y fluxes at centres J-1, J (to centres)
  auto fy = [&](int q, int j) {
    if constexpr (D3)
      return (P.yr(DX_CC)[j] * A.dzc3[g + (j - J) * gsy])
             * transport_any<true, BF>(v, q + sy, sy, half * (v[q + sy] + v[q]), A.sm, eps,
                                   A.ym != 0, A.yb, j, tb.yon, tb.yc, false, clr,
                                   g + (j - J) * gsy, gsy, 2, A.lo_m, A.hi_m, A.bf_m);
    else if constexpr (ANY)
      return (P.yr(DX_CC)[j] * dz)
             * transport_any<true, BF>(v, q + sy, sy, half * (v[q + sy] + v[q]), A.sm, eps,
                                   A.ym != 0, A.yb, j, tb.yon, tb.yc, false, clr,
                                   g + (j - J) * gsy, gsy, 2, A.lo_m, A.hi_m, A.bf_m);
    else
      return (P.yr(DX_CC)[j] * dz) * transport_tables(v, q + sy, sy, half * (v[q + sy] + v[q]),
                                                      we, eps, we && A.ym, A.yb, j,
                                                      we && tb.yon, tb.yc,
                                                      clear_at(clr, g + (j - J) * gsy, 1));
  };
  const T az = P.yr(AZ_CF)[J];
  auto fz = [&](int q, int qw, int k) {
    if constexpr (ANY)
      return az * transport_any<true, BF>(v, q, 1, half * (w[qw] + w[qw - P.wsy]), A.sm, eps,
                                      A.zm != 0, A.zb, k, tb.zon, tb.z, true, clr, g + (k - K),
                                      1, 4, A.lo_m, A.hi_m, A.bf_m);
    else
      return az * transport_tables(v, q, 1, half * (w[qw] + w[qw - P.wsy]), we, eps,
                                   we && A.zm != 0, A.zb, k, we && tb.zon, tb.z,
                                   clear_at(clr, g + (k - K), 2));
  };
  if constexpr (D3)
    return ieee_div((fx(o + sx, I + 1) - fx(o, I)) + (fy(o, J) - fy(o - sy, J - 1))
                    + (fz(o + 1, P.ow + 1, K + 1) - fz(o, P.ow, K)), az * A.dzc3[g]);
  else
    return ieee_div((fx(o + sx, I + 1) - fx(o, I)) + (fy(o, J) - fy(o - sy, J - 1))
                    + (fz(o + 1, P.ow + 1, K + 1) - fz(o, P.ow, K)), az * dz);
}

// ---- Coriolis ---------------------------------------------------------------------

// (f x u)_x at the u point; CART: the Cartesian forms are read at run time
template <bool CART, typename T>
__device__ T f_cross_x(const Pt<T>& P, int cor) {
  const T* v = P.v;
  const int o = P.o, sx = P.sx, sy = P.sy, J = P.J;
  const T half = T(0.5);
  if constexpr (CART) {
    if (cor == CARTESIAN || cor == NON_TRADITIONAL) {
      // fy ixf(izc(w)) - fz ixf(iyc(v)), fy and fz at the u point
      const T* w = P.w;
      const int q = P.ow, s = P.wsx;
      const T wf = half * (half * (w[q + 1] + w[q]) + half * (w[q - s + 1] + w[q - s]));
      const T vf = half * (half * (v[o + sy] + v[o]) + half * (v[o - sx + sy] + v[o - sx]));
      return P.yr(F2_U)[J] * wf - P.yr(F_U)[J] * vf;
    }
  }
  if (cor == PLANE)  // -f ixf(iyc(v))
    return (-P.yr(F_U)[J]) * (half * (half * (v[o + sy] + v[o])
                                      + half * (v[o - sx + sy] + v[o - sx])));
  const T* f = P.yr(F_U);
  const T* dx_cf = P.yr(DX_CF);
  const T dxu = P.yr(DX_FC)[J];
  auto dxv = [&](int q, int j) { return dx_cf[j] * v[q]; };
  if (cor == SPHERICAL_ENERGY) {  // -iyc(f ixf(dx v)) / dx
    auto qf = [&](int q, int j) { return f[j] * (half * (dxv(q, j) + dxv(q - sx, j))); };
    return ieee_div(-(half * (qf(o + sy, J + 1) + qf(o, J))), dxu);
  }
  // enstrophy: -iyc(f) ixf(iyc(dx v)) / dx
  auto iyc_dxv = [&](int q) { return half * (dxv(q + sy, J + 1) + dxv(q, J)); };
  return ieee_div(-(half * (f[J + 1] + f[J])) * (half * (iyc_dxv(o) + iyc_dxv(o - sx))), dxu);
}

// (f x u)_y at the v point; CART: the Cartesian forms are read at run time
template <bool CART, typename T>
__device__ T f_cross_y(const Pt<T>& P, int cor) {
  const T* u = P.u;
  const int o = P.o, sx = P.sx, sy = P.sy, J = P.J;
  const T half = T(0.5);
  if constexpr (CART) {
    if (cor == CARTESIAN || cor == NON_TRADITIONAL) {
      // fz iyf(ixc(u)) [- fx iyf(izc(w)): constant Cartesian], fz and fx at the v point
      const T uf = half * (half * (u[o + sx] + u[o]) + half * (u[o + sx - sy] + u[o - sy]));
      const T fu = P.yr(F_V)[J] * uf;
      if (cor == NON_TRADITIONAL) return fu;
      const T* w = P.w;
      const int q = P.ow, s = P.wsy;
      const T wf = half * (half * (w[q + 1] + w[q]) + half * (w[q - s + 1] + w[q - s]));
      return fu - P.yr(F2_V)[J] * wf;
    }
  }
  if (cor == PLANE)  // f iyf(ixc(u))
    return P.yr(F_V)[J] * (half * (half * (u[o + sx] + u[o])
                                   + half * (u[o + sx - sy] + u[o - sy])));
  const T fJ = P.yr(F_U)[J];  // f at (F, F), constant along x
  const T* dy_c = P.yr(DY_C);
  const T dyv = P.yr(DY_F)[J];
  auto dyu = [&](int q, int j) { return dy_c[j] * u[q]; };
  if (cor == SPHERICAL_ENERGY) {  // ixc(f iyf(dy u)) / dy
    auto qf = [&](int q) { return fJ * (half * (dyu(q, J) + dyu(q - sy, J - 1))); };
    return ieee_div(half * (qf(o + sx) + qf(o)), dyv);
  }
  // enstrophy: ixc(f) iyf(ixc(dy u)) / dy
  auto ixc_dyu = [&](int q, int j) { return half * (dyu(q + sx, j) + dyu(q, j)); };
  return ieee_div((half * (fJ + fJ)) * (half * (ixc_dyu(o, J) + ixc_dyu(o - sy, J - 1))), dyv);
}

// ---- the kernel ---------------------------------------------------------------------

template <typename T, int ADV>
__device__ __forceinline__ void store(const HydroArgs<T>& A, int f, int64_t p, T psi, T g) {
  A.out_g[f][p] = g;
  if (ADV > 0 || (ADV < 0 && A.advance))
    A.out_psi[f][p] = psi + A.dt * (A.c1 * g - A.c2 * A.gp[f][p]);
}

template <typename T, int ADV>
__device__ __forceinline__ void store_zero(const HydroArgs<T>& A, int64_t p) {
  for (int f = 0; f < A.nf; ++f) {
    A.out_g[f][p] = T(0);
    if (ADV > 0 || (ADV < 0 && A.advance)) A.out_psi[f][p] = T(0);
  }
}

template <typename T, int MOM, int COR, int TABLES_ON, int ADV, int XTRA, bool ANY,
          bool BF = false, int L = LAYOUT_TILE, bool CART = false, bool D3 = false>
__global__ void __launch_bounds__(HT_THREADS, 1)
fused_hydrostatic_tendencies_kernel(const __grid_constant__ HydroArgs<T> A) {
  using TL = HTile<L>;
  // a new form's kernel (a Flat layout or the Cartesian Coriolis forms)
  // calls its own instantiations of the out-of-line device functions, so
  // that the earlier kernels' callees keep their callers (and their SASS)
  constexpr bool NEW = L != LAYOUT_TILE || CART;
  // a Flat y: ny = 1 and, for the rows alone, hy = HT_R (the y rows repeat
  // their one value). Where a Flat layout needs another expression, an `if
  // constexpr` gives the 16 x 8 tile the very statements it had before the
  // Flat layouts came: a conditional expression, even on a constant, moved
  // the earlier instantiations' SASS
  constexpr bool fx = TL::FX, fy = TL::FY;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  const int mom = MOM >= 0 ? MOM : A.mom;
  const int cor = COR >= 0 ? COR : A.cor;
  const bool tables = TABLES_ON >= 0 ? TABLES_ON != 0 : A.tables != 0;
  const int X = A.nx + 2 * A.hx, Y = A.ny + 2 * A.hy, Z = A.nz + 2 * A.hz;
  // the arrays' strides (0 along a Flat axis; a Flat y's Y counts the rows' halo)
  int64_t gsx, gsy;
  if constexpr (L == LAYOUT_TILE) {
    gsx = (int64_t)Y * Z, gsy = Z;
  } else {
    gsx = fx ? 0 : (int64_t)(fy ? 1 : Y) * Z, gsy = fy ? 0 : Z;
  }
  // XTRA 0: no closure, no immersed boundary, no y tables (not read)
  const int closure = XTRA ? A.closure : NO_CLOSURE;
  const uint8_t* const clr_c = XTRA ? A.clr[0] : nullptr;
  const uint8_t* const clr_u = XTRA ? A.clr[1] : nullptr;
  const uint8_t* const clr_v = XTRA ? A.clr[2] : nullptr;
  const bool ytab = XTRA && A.ytables != 0;
  const Tabs<T> tb{ZRows<T>{A.zs + Z_TABLES * Z, Z}, ZRows<T>{A.yt, Y},
                   ZRows<T>{ytab ? A.yt + Z_TABLE_ROWS * Y : nullptr, Y}, tables, ytab};
  const int kz = A.kz;
  // the tile [I0, I1) x [J0, J1) and the chunk [K0, K1) of interior levels
  const int I0 = A.hx + (int)(blockIdx.x / A.nty) * TL::X, I1 = min(I0 + TL::X, A.hx + A.nx);
  const int J0 = A.hy + (int)(blockIdx.x % A.nty) * TL::Y, J1 = min(J0 + TL::Y, A.hy + A.ny);
  const int K0 = A.hz + (int)blockIdx.y * kz, K1 = min(K0 + kz, A.hz + A.nz);
  const int tid = threadIdx.x;

  // shared memory: u, v, w, tracer buffer 0, then the momentum arrays or
  // (later) tracer buffer 1 and the face fluxes
  const int zs = kz + 2 * HT_R;
  int sy, sx, wsy, wsx;  // u, v, tracer boxes; w box from (I0-1, J0-1, K0)
  if constexpr (L == LAYOUT_TILE) {
    sy = zs, sx = TL::BY * zs;
  } else {
    sy = fy ? 0 : zs, sx = fx ? 0 : TL::BY * zs;
  }
  const int BI = I0 - HT_R, BJ = J0 - HT_R, BK = K0 - HT_R;
  if constexpr (L == LAYOUT_TILE) {
    wsy = kz + 1, wsx = TL::WY * wsy;
  } else {
    wsy = fy ? 0 : kz + 1, wsx = fx ? 0 : TL::WY * (kz + 1);
  }
  T* const su = sm;
  T* const sv = su + TL::BOX * zs;
  T* const sw = sv + TL::BOX * zs;
  T* const tb0 = sw + TL::WBOX * (kz + 1);
  T* const region = tb0 + TL::BOX * zs;
  T* const mzeta = region;                                 // momentum phase
  T* const msu = mzeta + TL::FFBOX * kz;
  T* const msv = msu + TL::FFBOX * kz;
  T* const mbern = msv + TL::FFBOX * kz;
  T* const tb1 = region;                                   // tracer phase
  T* const FX = tb1 + TL::BOX * zs;                        // x faces: (X+1) x Y x kz
  T* const FY = FX + TL::XF * kz;                          // y faces: X x (Y+1) x kz
  T* const FZ = FY + TL::YF * kz;                          // z faces: X x Y x (kz+1)

  // 1. copies: u, v and w, then the first tracer (clipped to the array)
  const int ci0 = max(BI, 0), ci1 = min(I1 + HT_R, X);  // a Flat x: [0, 1)
  int cj0, cj1;  // (a Flat y: its one row)
  if constexpr (L == LAYOUT_TILE) {
    cj0 = max(BJ, 0), cj1 = min(J1 + HT_R, Y);
  } else {
    cj0 = fy ? J0 : max(BJ, 0), cj1 = fy ? J0 + 1 : min(J1 + HT_R, Y);
  }
  const int ck0 = max(BK, 0), ck1 = min(K1 + HT_R, Z);
  copy_box_async(su, A.psi[0], gsx, gsy, ci0, ci1, cj0, cj1, ck0, ck1, BI, BJ, BK, sx, sy);
  copy_box_async(sv, A.psi[1], gsx, gsy, ci0, ci1, cj0, cj1, ck0, ck1, BI, BJ, BK, sx, sy);
  if constexpr (L == LAYOUT_TILE)
    copy_box_async(sw, A.w, gsx, gsy, max(I0 - 1, 0), I1, max(J0 - 1, 0), J1, K0, K1 + 1,
                   I0 - 1, J0 - 1, K0, wsx, wsy);
  else
    copy_box_async(sw, A.w, gsx, gsy, max(I0 - 1, 0), I1, fy ? J0 : max(J0 - 1, 0), J1, K0,
                   K1 + 1, I0 - 1, J0 - 1, K0, wsx, wsy);
  copy_async_commit();
  const bool advect = A.tr >= 0 && A.nf > 2;
  if (advect) {
    copy_box_async(tb0, A.psi[2], gsx, gsy, ci0, ci1, cj0, cj1, ck0, ck1, BI, BJ, BK, sx, sy);
    copy_async_commit();
  }

  // 4. halo zeros: the chunk's first and last blocks take their columns' z
  // halos; a block on the x or y edge takes the halo columns next to its
  // tile (whole columns, in the first chunk)
  {
    const bool first = blockIdx.y == 0, last = blockIdx.y == gridDim.y - 1;
    const int h2 = 2 * A.hz;
    if ((first || last) && h2 > 0) {
      for (int t = tid; t < TL::COLS * h2; t += HT_THREADS) {
        const int c = A.h2d.div(t), m = t - c * h2;
        const int i = I0 + c / TL::Y, j = J0 + c % TL::Y;
        const int k = m < A.hz ? m : A.hz + A.nz + (m - A.hz);
        if (i < I1 && j < J1 && (m < A.hz ? first : last))
          store_zero<T, ADV>(A, i * gsx + j * gsy + k);
      }
    }
    const int ri0 = I0 == A.hx ? 0 : I0, ri1 = I1 == A.hx + A.nx ? X : I1;
    // (a Flat y has no halo columns: its rows' halo is not the arrays')
    int rj0, rj1;
    if constexpr (L == LAYOUT_TILE)
      rj0 = J0 == A.hy ? 0 : J0, rj1 = J1 == A.hy + A.ny ? Y : J1;
    else
      rj0 = !fy && J0 == A.hy ? 0 : J0, rj1 = !fy && J1 == A.hy + A.ny ? Y : J1;
    if (first && (ri0 != I0 || ri1 != I1 || rj0 != J0 || rj1 != J1)) {
      const int mj = rj1 - rj0, n = (ri1 - ri0) * mj * Z;
      for (int t = tid; t < n; t += HT_THREADS) {
        const int k = t % Z, c = t / Z, i = ri0 + c / mj, j = rj0 + c % mj;
        if (i >= I0 && i < I1 && j >= J0 && j < J1) continue;
        store_zero<T, ADV>(A, i * gsx + j * gsy + k);
      }
    }
  }

  if (advect) copy_async_wait<1>(); else copy_async_wait<0>();
  __syncthreads();

  // the block's tasks run over the whole tile and chunk, level fastest
  // (TL::COLS x kz points; edge tiles and a short last chunk skip the
  // points outside), so every index division is by a compile-time width or
  // by kz through FastDiv
  const int npts = TL::COLS * kz;
  auto point = [&](int t, int& I, int& J, int& K) {  // false outside the domain
    const int c = A.kzd.div(t);
    K = K0 + (t - c * kz);
    I = I0 + c / TL::Y;
    J = J0 + c % TL::Y;
    return I < I1 && J < J1 && K < K1;
  };
  auto at = [&](int i, int j, int k) { return (i - BI) * sx + (j - BJ) * sy + (k - BK); };
  auto wat = [&](int i, int j, int k) { return (i - I0 + 1) * wsx + (j - J0 + 1) * wsy + (k - K0); };
  const T half = T(0.5);
  auto make_pt = [&](int I, int J, int K) {
    return Pt<T>{&A, su, sv, sw, at(I, J, K), sx, sy, wat(I, J, K), wsx, wsy, I, J, K, Y, Z};
  };

  // 2. momentum
  const bool vi = mom <= VI_WENO_VELOCITY;
  const MomArrays<T, L> M{mzeta, msu, msv, mbern, I0, J0, K0, kz};
  if (vi) {
    // zeta (and the smoothness streams) at the (F, F) points
    // [I0-2, I1+2] x [J0-2, J1+2], the Bernoulli head at the (C, C) points
    // [I0-1, I1) x [J0-1, J1), every level of the chunk
    const int nff = TL::FFBOX * kz, ncc = TL::WBOX * kz;
    const T* dy_f = A.ys + DY_F * Y;
    const T* dx_fc = A.ys + DX_FC * Y;
    const T* az_ff = A.ys + AZ_FF * Y;
    for (int t = tid; t < nff + ncc; t += HT_THREADS) {
      if (t < nff) {  // t is M.ff(i, j, k)
        const int c = A.kzd.div(t), k = K0 + (t - c * kz);
        int i, j;
        if constexpr (L == LAYOUT_TILE)
          i = I0 - 2 + c / TL::FFY, j = J0 - 2 + c % TL::FFY;
        else
          i = fx ? I0 : I0 - 2 + c / TL::FFY, j = fy ? J0 : J0 - 2 + c % TL::FFY;
        if (i > I1 + 2 || j > J1 + 2 || k >= K1) continue;
        const int q = at(i, j, k), m = t;
        mzeta[m] = ieee_div((dy_f[j] * sv[q] - dy_f[j] * sv[q - sx])
                            - (dx_fc[j] * su[q] - dx_fc[j - 1] * su[q - sy]), az_ff[j]);
        if (mom == VI_WENO_VELOCITY) {
          msu[m] = half * (su[q] + su[q - sy]);   // iyf(u) at (F, F)
          msv[m] = half * (sv[q] + sv[q - sx]);   // ixf(v) at (F, F)
        }
      } else {  // t - nff is M.cc(i, j, k)
        const int s = t - nff, c = A.kzd.div(s), k = K0 + (s - c * kz);
        int i, j;
        if constexpr (L == LAYOUT_TILE)
          i = I0 - 1 + c / TL::WY, j = J0 - 1 + c % TL::WY;
        else
          i = fx ? I0 : I0 - 1 + c / TL::WY, j = fy ? J0 : J0 - 1 + c % TL::WY;
        if (i >= I1 || j >= J1 || k >= K1) continue;
        mbern[s] = bernoulli(su, sv, at(i, j, k), sx, sy);
      }
    }
    __syncthreads();
  }
  for (int t = tid; t < npts; t += HT_THREADS) {
    int I, J, K;
    if (!point(t, I, J, K)) continue;
    const Pt<T> P = make_pt(I, J, K);
    const int64_t p = I * gsx + J * gsy + K;
    // u
    T g = T(0);
    if (mom == FLUX_FORM) g = -div_vu<ANY, BF, NEW, T, D3>(P, tb, clr_u, gsx, gsy);
    else if (mom != NO_MOMENTUM) g = -vi_u<T, L, D3>(P, M, mom);
    if (cor != NO_CORIOLIS) g = g - f_cross_x<CART>(P, cor);
    if (A.ph != nullptr) g = g - ieee_div(A.ph[p] - A.ph[p - gsx], P.yr(DX_FC)[J]);
    if (closure != NO_CLOSURE)
      g = g + diffusion(su, P.o, sx, sy, A.ys, A.zs, Y, Z, J, K, AT_U, A.kh[0], A.kv[0],
                        closure == CLOSURE_HZ);
    store<T, ADV>(A, 0, p, su[P.o], g);
    // v
    g = T(0);
    if (mom == FLUX_FORM) g = -div_vv<ANY, BF, NEW, T, D3>(P, tb, clr_v, gsx, gsy);
    else if (mom != NO_MOMENTUM) g = -vi_v<T, L, D3>(P, M, mom);
    if (cor != NO_CORIOLIS) g = g - f_cross_y<CART>(P, cor);
    if (A.ph != nullptr) g = g - ieee_div(A.ph[p] - A.ph[p - gsy], P.yr(DY_F)[J]);
    if (closure != NO_CLOSURE)
      g = g + diffusion(sv, P.o, sx, sy, A.ys, A.zs, Y, Z, J, K, AT_V, A.kh[1], A.kv[1],
                        closure == CLOSURE_HZ);
    store<T, ADV>(A, 1, p, sv[P.o], g);
  }

  // 3. tracers
  if (!advect) {  // no tracer advection: G = 0 (and the closure's diffusion)
    for (int f = 2; f < A.nf; ++f)
      for (int t = tid; t < npts; t += HT_THREADS) {
        int I, J, K;
        if (!point(t, I, J, K)) continue;
        const int64_t p = I * gsx + J * gsy + K;
        T g = T(0);
        if (closure != NO_CLOSURE)
          g = g + diffusion(A.psi[f], p, gsx, gsy, A.ys, A.zs, Y, Z, J, K, AT_C, A.kh[f],
                            A.kv[f], closure == CLOSURE_HZ);
        store<T, ADV>(A, f, p, A.psi[f][p], g);
      }
    return;
  }
  // the tracer scheme: the first-code forms WENO5 (we) or centred, WENO5's
  // near-wall bounds in the one set; ANY its code and its own bounds (the
  // first-code forms' expressions below are those they had before ANY came,
  // so that they compile as they did)
  const bool we = A.tr == 1;
  const T eps = A.eps_t;
  const bool xmask = we && A.xm, ymask = we && A.ym;
  const int nfx = TL::XF * kz, nfy = TL::YF * kz, nfz = TL::COLS * (kz + 1);
  // face-flux array offsets: level fastest, kz (or kz+1) levels per face
  // (on the layout's Flat axis one face slot serves both faces of a cell)
  auto fxi = [&](int i, int j, int k) { return ((i - I0) * TL::Y + (j - J0)) * kz + (k - K0); };
  auto fyi = [&](int i, int j, int k) {
    if constexpr (L == LAYOUT_TILE)
      return ((i - I0) * TL::YFY + (j - J0)) * kz + (k - K0);
    else
      return ((i - I0) * TL::YFY + (fy ? 0 : j - J0)) * kz + (k - K0);
  };
  auto fzi = [&](int i, int j, int k) { return ((i - I0) * TL::Y + (j - J0)) * (kz + 1) + (k - K0); };
  for (int f = 2; f < A.nf; ++f) {
    T* const sc = (f - 2) % 2 == 0 ? tb0 : tb1;
    copy_async_wait<0>();
    __syncthreads();  // tracer f staged; the momentum arrays, or tracer f-1's buffer and fluxes, free
    if (f + 1 < A.nf) {
      copy_box_async((f - 2) % 2 == 0 ? tb1 : tb0, A.psi[f + 1], gsx, gsy, ci0, ci1, cj0, cj1,
                     ck0, ck1, BI, BJ, BK, sx, sy);
      copy_async_commit();
    }
    // each face flux once: x faces [I0, I1], y faces [J0, J1], z faces [K0, K1]
    for (int t = tid; t < nfx + nfy + nfz; t += HT_THREADS) {
      if (t < nfx) {  // t is fxi(i, j, k)
        const int c = A.kzd.div(t), k = K0 + (t - c * kz);
        const int i = I0 + c / TL::Y, j = J0 + c % TL::Y;
        if (i > I1 || j >= J1 || k >= K1) continue;
        const int q = at(i, j, k);
        if constexpr (D3)
          FX[t] = (A.ys[DY_C * Y + j] * A.dzc3[i * gsx + j * gsy + k])
                  * transport_any<true, BF>(sc, q, sx, su[q], A.tr, eps, A.xm_t != 0, A.xb_t, i,
                                        false, tb.z, true, clr_c, i * gsx + j * gsy + k, gsx,
                                        1, A.lo_t, A.hi_t, A.bf_t);
        else if constexpr (ANY)
          FX[t] = (A.ys[DY_C * Y + j] * A.zs[Z_DZ_C * Z + k])
                  * transport_any<true, BF>(sc, q, sx, su[q], A.tr, eps, A.xm_t != 0, A.xb_t, i,
                                        false, tb.z, true, clr_c, i * gsx + j * gsy + k, gsx,
                                        1, A.lo_t, A.hi_t, A.bf_t);
        else
          FX[t] = (A.ys[DY_C * Y + j] * A.zs[Z_DZ_C * Z + k])
                  * transport_tables(sc, q, sx, su[q], we, eps, xmask, A.xb, i, false, tb.z,
                                     clear_at(clr_c, i * gsx + j * gsy + k, 0));
      } else if (t < nfx + nfy) {  // t - nfx is fyi(i, j, k)
        const int s = t - nfx, c = A.kzd.div(s), k = K0 + (s - c * kz);
        int i, j;
        if constexpr (L == LAYOUT_TILE)
          i = I0 + c / TL::YFY, j = J0 + c % TL::YFY;
        else
          i = I0 + c / TL::YFY, j = fy ? J0 : J0 + c % TL::YFY;
        if (i >= I1 || j > J1 || k >= K1) continue;
        const int q = at(i, j, k);
        if constexpr (D3)
          FY[s] = (A.ys[DX_CF * Y + j] * A.dzc3[i * gsx + j * gsy + k])
                  * transport_any<true, BF>(sc, q, sy, sv[q], A.tr, eps, A.ym_t != 0, A.yb_t, j,
                                        tb.yon, tb.yf, true, clr_c, i * gsx + j * gsy + k, gsy,
                                        2, A.lo_t, A.hi_t, A.bf_t);
        else if constexpr (ANY)
          FY[s] = (A.ys[DX_CF * Y + j] * A.zs[Z_DZ_C * Z + k])
                  * transport_any<true, BF>(sc, q, sy, sv[q], A.tr, eps, A.ym_t != 0, A.yb_t, j,
                                        tb.yon, tb.yf, true, clr_c, i * gsx + j * gsy + k, gsy,
                                        2, A.lo_t, A.hi_t, A.bf_t);
        else
          FY[s] = (A.ys[DX_CF * Y + j] * A.zs[Z_DZ_C * Z + k])
                  * transport_tables(sc, q, sy, sv[q], we, eps, ymask, A.yb, j, we && tb.yon,
                                     tb.yf, clear_at(clr_c, i * gsx + j * gsy + k, 1));
      } else {  // t - nfx - nfy is fzi(i, j, k)
        const int s = t - nfx - nfy, c = A.kz1d.div(s), k = K0 + (s - c * (kz + 1));
        const int i = I0 + c / TL::Y, j = J0 + c % TL::Y;
        if (i >= I1 || j >= J1 || k > K1) continue;
        if constexpr (ANY)
          FZ[s] = A.ys[AZ_CC * Y + j]
                  * transport_any<true, BF>(sc, at(i, j, k), 1, sw[wat(i, j, k)], A.tr, eps,
                                        A.zm_t != 0, A.zb_t, k, tables, tb.z, true, clr_c,
                                        i * gsx + j * gsy + k, 1, 4, A.lo_t, A.hi_t, A.bf_t);
        else
          FZ[s] = A.ys[AZ_CC * Y + j]
                  * transport_tables(sc, at(i, j, k), 1, sw[wat(i, j, k)], we, eps,
                                     we && A.zm != 0, A.zb, k, we && tables, tb.z,
                                     clear_at(clr_c, i * gsx + j * gsy + k, 2));
      }
    }
    __syncthreads();
    for (int t = tid; t < npts; t += HT_THREADS) {
      int I, J, K;
      if (!point(t, I, J, K)) continue;
      const int64_t p = I * gsx + J * gsy + K;
      const T dz = A.zs[Z_DZ_C * Z + K], az = A.ys[AZ_CC * Y + J];
      const int x0 = fxi(I, J, K), y0 = fyi(I, J, K), z0 = fzi(I, J, K);
      T div;  // (on a Flat axis the far face's slot is the near one's)
      if constexpr (D3)
        div = ieee_div(((FX[x0 + TL::Y * kz] - FX[x0]) + (FY[y0 + kz] - FY[y0]))
                       + (FZ[z0 + 1] - FZ[z0]), az * A.dzc3[p]);
      else if constexpr (L == LAYOUT_TILE)
        div = ieee_div(((FX[x0 + TL::Y * kz] - FX[x0]) + (FY[y0 + kz] - FY[y0]))
                       + (FZ[z0 + 1] - FZ[z0]), az * dz);
      else
        div = ieee_div(((FX[x0 + (fx ? 0 : TL::Y * kz)] - FX[x0])
                        + (FY[y0 + (fy ? 0 : kz)] - FY[y0])) + (FZ[z0 + 1] - FZ[z0]), az * dz);
      T g = -div;
      if (closure != NO_CLOSURE)
        g = g + diffusion(sc, at(I, J, K), sx, sy, A.ys, A.zs, Y, Z, J, K, AT_C, A.kh[f],
                          A.kv[f], closure == CLOSURE_HZ);
      store<T, ADV>(A, f, p, sc[at(I, J, K)], g);
    }
  }
}

template <typename T, int MOM, int COR, int TABLES_ON, int ADV, int XTRA, bool ANY = false,
          bool BF = false, int L = LAYOUT_TILE, bool CART = false, bool D3 = false>
static int run(const HydroArgs<T>& A, dim3 blocks, int smem, cudaStream_t stream) {
  auto kernel =
      fused_hydrostatic_tendencies_kernel<T, MOM, COR, TABLES_ON, ADV, XTRA, ANY, BF, L, CART,
                                          D3>;
  if (smem > 48 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != 0) return rc;
  }
  kernel<<<blocks, HT_THREADS, smem, stream>>>(A);
  return (int)cudaGetLastError();
}

// the most shared memory a block may have on sm_90 (227 KB)
constexpr int HT_SMEM_MAX = 232448;

// The launch's chunks of levels and blocks in layout L: the largest chunk
// whose boxes fit, then chunks of equal size.
template <typename T, int L>
static void shape(HydroArgs<T>& A, dim3* blocks, int* smem) {
  using TL = HTile<L>;
  int kz = A.nz;
  while (kz > 1 && hydro_smem_elems<L>(kz) * (long)sizeof(T) > HT_SMEM_MAX) --kz;
  const int chunks = (A.nz + kz - 1) / kz;
  A.kz = (A.nz + chunks - 1) / chunks;
  A.nty = (A.ny + TL::Y - 1) / TL::Y;
  A.kzd = fast_div(A.kz);
  A.kz1d = fast_div(A.kz + 1);
  *blocks = dim3((unsigned)(((A.nx + TL::X - 1) / TL::X) * A.nty), (unsigned)chunks);
  *smem = (int)(hydro_smem_elems<L>(A.kz) * (long)sizeof(T));
}

// the layout and Coriolis form of a launch that takes a new form
template <typename T, int L>
static int run_new_form(HydroArgs<T>& A, cudaStream_t st) {
  dim3 blocks;
  int smem;
  shape<T, L>(A, &blocks, &smem);
  return run<T, -1, -1, -1, -1, 1, true, true, L, true>(A, blocks, smem, st);
}

// a launch on partial cells (3D dz): the run-time form with every scheme,
// option and Coriolis form (ANY with BF, CART) in the 16 x 8 tile, reading
// dz per point from the two 3D arrays (D3)
template <typename T>
static int run_dz3(HydroArgs<T>& A, cudaStream_t st) {
  dim3 blocks;
  int smem;
  shape<T, LAYOUT_TILE>(A, &blocks, &smem);
  return run<T, -1, -1, -1, -1, 1, true, true, LAYOUT_TILE, true, true>(A, blocks, smem, st);
}

template <typename T>
static int launch(const void* const* psi, const void* w, const void* ph,
                  const void* ys, const void* zs, const void* yt, const void* clr_c,
                  const void* clr_u, const void* clr_v, const void* const* gp,
                  void* const* out_g, void* const* out_psi, const double* kh,
                  const double* kv, int nf, int nx, int ny, int nz, int hx, int hy,
                  int hz, int mom, int sm, int tr, int cor, int tables,
                  int ytables, int closure, int advance, const int* b, double eps_m,
                  double eps_t, double c1, double c2, double dt, const int* bt,
                  const double* pw, int fx, int fy, const void* dz3, void* stream) {
  if (nf < 2 || nf > MAX_FIELDS) return (int)cudaErrorInvalidValue;
  // partial cells: a tile of both horizontal axes, and no in-kernel closure
  // (the model adds an immersed grid's diffusion as torch ops)
  if (dz3 != nullptr && (fx || fy || closure != NO_CLOSURE)) return (int)cudaErrorInvalidValue;
  // a Flat axis: one cell, no halo
  if ((fx && (nx != 1 || hx != 0)) || (fy && (ny != 1 || hy != 0)))
    return (int)cudaErrorInvalidValue;
  if (advance && (gp == nullptr || out_psi == nullptr)) return (int)cudaErrorInvalidValue;
  if (ytables && yt == nullptr) return (int)cudaErrorInvalidValue;
  HydroArgs<T> A;
  for (int f = 0; f < MAX_FIELDS; ++f) {
    const bool on = f < nf;
    A.psi[f] = on ? static_cast<const T*>(psi[f]) : nullptr;
    A.out_g[f] = on ? static_cast<T*>(out_g[f]) : nullptr;
    A.gp[f] = on && advance ? static_cast<const T*>(gp[f]) : nullptr;
    A.out_psi[f] = on && advance ? static_cast<T*>(out_psi[f]) : nullptr;
    A.kh[f] = on ? T(kh[f]) : T(0);
    A.kv[f] = on ? T(kv[f]) : T(0);
  }
  A.yt = static_cast<const T*>(yt);
  A.clr[0] = static_cast<const uint8_t*>(clr_c);
  A.clr[1] = static_cast<const uint8_t*>(clr_u);
  A.clr[2] = static_cast<const uint8_t*>(clr_v);
  A.ytables = ytables;
  A.closure = closure;
  A.w = static_cast<const T*>(w);
  A.ph = static_cast<const T*>(ph);
  A.ys = static_cast<const T*>(ys);
  A.zs = static_cast<const T*>(zs);
  // a Flat y's rows hold 1 + 2 HT_R copies of its one value, read as halo rows
  A.nf = nf; A.nx = nx; A.ny = ny; A.nz = nz; A.hx = hx; A.hy = fy ? HT_R : hy; A.hz = hz;
  A.mom = mom; A.cor = cor;
  split_scheme<T>(sm, A.sm, A.bf_m);
  split_scheme<T>(tr, A.tr, A.bf_t);
  sm = A.sm;
  tr = A.tr;
  if (mom != FLUX_FORM) A.bf_m = BF16_NONE;
  A.tables = tables; A.advance = advance;
  // ANY: a flux-form momentum scheme or a tracer scheme beyond WENO5 and
  // centred (the first-code forms take those two alone), or a bf16 option
  const bool any = (mom == FLUX_FORM && sm != SCHEME_CENTRED && sm != SCHEME_WENO5)
                   || (tr >= 0 && tr != SCHEME_CENTRED && tr != SCHEME_WENO5)
                   || A.bf_m != BF16_NONE || A.bf_t != BF16_NONE;
  // the first-code forms read one set of near-wall bounds, WENO5's: the
  // tracers' where the momentum scheme is not a flux-form WENO5
  // the Flat layouts and the Cartesian Coriolis forms take the run-time
  // form with every scheme and option (ANY with BF), whatever the schemes
  const bool cart = cor == CARTESIAN || cor == NON_TRADITIONAL;
  const bool new_form = fx || fy || cart || dz3 != nullptr;
  const int* m = any || new_form || (mom == FLUX_FORM && sm == SCHEME_WENO5) ? b : bt;
  A.xm = m[0]; A.xb = Bounds{m[1], m[2], m[3], m[4]};
  A.ym = m[5]; A.yb = Bounds{m[6], m[7], m[8], m[9]};
  A.zm = m[10]; A.zb = Bounds{m[11], m[12], m[13], m[14]};
  A.xm_t = bt[0]; A.xb_t = Bounds{bt[1], bt[2], bt[3], bt[4]};
  A.ym_t = bt[5]; A.yb_t = Bounds{bt[6], bt[7], bt[8], bt[9]};
  A.zm_t = bt[10]; A.zb_t = Bounds{bt[11], bt[12], bt[13], bt[14]};
  A.lo_m = T(pw[0]); A.hi_m = T(pw[1]); A.lo_t = T(pw[2]); A.hi_t = T(pw[3]);
  A.eps_m = T(eps_m); A.eps_t = T(eps_t);
  A.c1 = T(c1); A.c2 = T(c2); A.dt = T(dt);
  if (nx <= 0 || ny <= 0 || nz <= 0) return 0;
  A.h2d = fast_div(2 * hz);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  A.dzc3 = static_cast<const T*>(dz3);
  A.dzf3 = A.dzc3 == nullptr ? nullptr
                             : A.dzc3 + (int64_t)(nx + 2 * hx) * (ny + 2 * hy) * (nz + 2 * hz);
  if (dz3 != nullptr) return run_dz3<T>(A, st);
  if (fx && fy) return run_new_form<T, LAYOUT_FLAT_XY>(A, st);
  if (fx) return run_new_form<T, LAYOUT_FLAT_X>(A, st);
  if (fy) return run_new_form<T, LAYOUT_FLAT_Y>(A, st);
  if (cart) return run_new_form<T, LAYOUT_TILE>(A, st);
  dim3 blocks;
  int smem;
  shape<T, LAYOUT_TILE>(A, &blocks, &smem);
  // the 1/4 degree flagship's forms have their own instantiations, with
  // and without the closure, masks and y tables: reading those at run time
  // made the flagship's forms 5-8% slower on an H100 (chip_breakdown.py
  // hydrostatic, hydrostatic-wind)
  const bool xtra = closure != NO_CLOSURE || ytables || clr_c || clr_u || clr_v;
  if (!any && mom == VI_WENO_VELOCITY && cor == SPHERICAL_ENERGY && tables) {
    if (xtra) {
      if (advance) return run<T, VI_WENO_VELOCITY, SPHERICAL_ENERGY, 1, 1, 1>(A, blocks, smem, st);
      return run<T, VI_WENO_VELOCITY, SPHERICAL_ENERGY, 1, 0, 1>(A, blocks, smem, st);
    }
    if (advance) return run<T, VI_WENO_VELOCITY, SPHERICAL_ENERGY, 1, 1, 0>(A, blocks, smem, st);
    return run<T, VI_WENO_VELOCITY, SPHERICAL_ENERGY, 1, 0, 0>(A, blocks, smem, st);
  }
  // WENO5's bf16 options: the bf16 sub-form of the run-time ANY form
  if (A.bf_m != BF16_NONE || A.bf_t != BF16_NONE)
    return run<T, -1, -1, -1, -1, 1, true, true>(A, blocks, smem, st);
  if (any) return run<T, -1, -1, -1, -1, 1, true>(A, blocks, smem, st);
  return run<T, -1, -1, -1, -1, 1>(A, blocks, smem, st);
}

#define COMMA_DZ3_PARAM , const void* dz3

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). Pointer arrays
// are host arrays of nf device pointers; `ph`, `yt` (unless `ytables`) and
// the clear flags `clr_c`, `clr_u`, `clr_v` may be null, `gp` and
// `out_psi` are null unless `advance`; kh and kv are host arrays of
// MAX_FIELDS coefficients (read with `closure` 1 or 2). `mom` is the
// momentum form, `sm` the flux form's scheme and `tr` the tracers'
// (SCHEME_* plus 16 times the bf16 option, split_scheme; -1 none). The 15 bound ints are the flux-form momentum
// scheme's near-wall reduction, for x, y and z: masked, lo_l, hi_l, lo_r,
// hi_r; `bt` a host array of the tracer scheme's 15, `pw` one of
// PositiveWENO5's (lo, hi) of the momentum and of the tracer scheme. `fx`
// and `fy` mark a Flat x and y (extent 1, halo 0); with a Flat y `ys` holds
// 1 + 2 HT_R copies of each row's one value. The _dz3 entries take one more
// pointer, `dz3`: a partial-cell grid's 3D dz at z-centres then at z-faces
// (2 x X x Y x Z, the fields' layout); `zs` then holds the z tables alone
// in its rows (its dz rows are not read).
#define FUSED_HYDROSTATIC_TENDENCIES(NAME, T, DZ3_ARG, DZ3)                    \
  int NAME(const void* const* psi, const void* w, const void* ph,              \
           const void* ys, const void* zs, const void* yt, const void* clr_c,  \
           const void* clr_u, const void* clr_v, const void* const* gp,        \
           void* const* out_g, void* const* out_psi, const double* kh,         \
           const double* kv, int nf, int nx, int ny, int nz, int hx, int hy,   \
           int hz, int mom, int sm, int tr, int cor, int tables,               \
           int ytables, int closure, int advance, int b0, int b1, int b2,      \
           int b3, int b4, int b5, int b6, int b7, int b8, int b9, int b10,    \
           int b11, int b12, int b13, int b14, double eps_m, double eps_t,     \
           double c1, double c2, double dt, const int* bt, const double* pw,   \
           int fx, int fy DZ3_ARG, void* stream) {                             \
    const int b[15] = {b0, b1, b2, b3, b4, b5, b6, b7,                         \
                       b8, b9, b10, b11, b12, b13, b14};                       \
    return launch<T>(psi, w, ph, ys, zs, yt, clr_c, clr_u, clr_v, gp, out_g,   \
                     out_psi, kh, kv, nf, nx, ny, nz, hx, hy, hz, mom, sm, tr, \
                     cor, tables, ytables, closure, advance, b, eps_m, eps_t,  \
                     c1, c2, dt, bt, pw, fx, fy, DZ3, stream);                 \
  }

FUSED_HYDROSTATIC_TENDENCIES(fused_hydrostatic_tendencies_f32, float, , nullptr)
FUSED_HYDROSTATIC_TENDENCIES(fused_hydrostatic_tendencies_f64, double, , nullptr)
FUSED_HYDROSTATIC_TENDENCIES(fused_hydrostatic_tendencies_dz3_f32, float,
                             COMMA_DZ3_PARAM, dz3)
FUSED_HYDROSTATIC_TENDENCIES(fused_hydrostatic_tendencies_dz3_f64, double,
                             COMMA_DZ3_PARAM, dz3)

}  // extern "C"
