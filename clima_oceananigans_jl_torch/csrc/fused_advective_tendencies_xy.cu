// K2's stretched-x/y form: the fused advective tendencies of the
// nonhydrostatic model on a grid stretched in x or y (the grids whose
// pressure the multigrid solver takes). For every prognostic field psi in
// {u, v, w, tracers}, G = -div(v psi), written into the interior of a
// with-halo output whose halos the kernel writes as zeros, and G of each
// velocity at its far wall face on a bounded axis (with-halo index h + n),
// as fused_advective_tendencies.cu does on the grids regular in x and y.
//
// Replaces the TPU kernel clima_oceananigans_jl_tpu/ops/fused_tendencies.py::
// fused_advective_tendencies where its gate (supports_fused_advection) leaves
// a stretched x or y to jnp. It computes what the port's plain version
// computes (ops/fused_tendencies.py::fused_advective_tendencies_reference,
// the div_vu / div_vv / div_vw / div_Uc of advection/fluxes.py), term by
// term in its expression trees: each flux along axis b is the face area
// (the product of the other two axes' spacings at the field's location:
// Δᶠ along a velocity's own axis, Δᶜ elsewhere, in grid.Ax/Ay/Az's order)
// times transport_any of weno5_advection.cuh (every scheme with its own
// near-wall bounds, the two-sided table form of the WENO5 family along a
// stretched axis, each face with its own table row, to centres along a
// velocity's own axis; PositiveWENO5's limiter on its to-faces transports;
// the immersed clear flags; WENO5's bf16 options), and the divergence
// ((δx + δy) + δz) / ((Δx Δy) Δz) through ieee_div. The rows are
// ops/metric_rows.py::axis_rows of each kernel axis (a regular axis holds
// its one spacing in every entry, a Flat one a single 1), so every product
// rounds as the plain version's does. Build with --fmad=false.
//
// What bounds it on an H100: memory, if each byte moved once. On the
// stretched channel (256 x 256 x 128 fp64, u, v, w and a tracer) it reads
// four with-halo fields and writes four with-halo outputs, ~0.59 GB: 0.176
// ms at 3.35 TB/s. Its work, 12 fp64 transports a point (the x and z ones
// in the two-sided table form, two reconstructions and two exact
// divisions each) and four divergences, is bound in practice by the
// latency of those dependent chains and divisions, as K2's is.
//
// The design: advect_tile's (weno5_advection.cuh) with every axis' rows.
// A block of XY_THREADS threads (768 in fp32, 512 in fp64) owns a tile of
// 8 x 12 interior (x, y) columns (96 x 1 in the Flat layout) and a chunk of
// levels, the largest that fits its shared memory (227 KB) in fp64 too,
// shorter on a grid of so few columns that the card's SMs would otherwise
// not all have a block:
//   1. it stages u, v and w over the tile and its 3-cell halo with cp.async
//      (tiles.cuh), where they stay, and the tile's slice of every axis'
//      rows (R_DC and R_DF, and on a stretched axis of a WENO5-family
//      scheme its 24 to-faces and 24 to-centres table rows) over the same
//      3-cell box, so that every area, volume and table entry is read from
//      shared memory; the first tracer's copy goes out after them;
//   2. while they arrive, it writes the halo zeros of its part of the
//      outputs and, on the last tile along a bounded axis, G of the
//      velocity normal to it at its wall face, from global memory
//      (div_wall_rows below);
//   3. field by field (u, v, w, then the tracers through a double buffer),
//      it computes each x, y and z face flux of the tile once into shared
//      memory, then each point's divergence from its two faces on each
//      axis. A face flux is shared by the two cells beside it: both
//      evaluate the same expression on the same operands (the face's
//      area depends only on the other two axes' indices, its table row is
//      the face's own, and its velocity and masks are those of the face),
//      as advect_tile shares them. So a point takes 3 + 1/8 + 1/12 + 1/kz
//      transports a field instead of 6.
// The first codes (centred, WENO5, UB5) without clear flags compile apart
// from the ANY instantiations (every scheme, the clear flags read where
// their pointer is not null) and the bf16 sub-form BF, each in the regular
// and the Flat layout: the channel's WENO5 form carries no branch of the
// other schemes.
#include <cuda_runtime.h>

#include "weno5_advection.cuh"

// Threads a block, fp32 and fp64 (a build may set them, as chip_breakdown.py's
// k2xy part does for its variants): a thread needs more registers than 64,
// and 512 threads in fp64 ran the channel 5% faster than 1024, 768 in fp32
// most fp32 holds faster than 1024 or 512 (PERF.md §6).
#ifndef XY_THREADS_F32
#define XY_THREADS_F32 768
#endif
#ifndef XY_THREADS_F64
#define XY_THREADS_F64 512
#endif

#define XY_THREADS(T) (sizeof(T) == sizeof(float) ? XY_THREADS_F32 : XY_THREADS_F64)

// ---- each axis' rows -------------------------------------------------------------
//
// ops/metric_rows.py::axis_rows of a kernel axis over its with-halo indices:
// R_DC (the spacing at centres), R_DF (at faces), then, where the axis is
// stretched and a scheme is of the WENO5 family, WENO5's to-faces tables
// (24 rows, as the z rows hold them) and its to-centres tables (24 more).
constexpr int R_DC = 0, R_DF = 1, R_TABLES = 2;
constexpr int ROWS_PLAIN = 2, ROWS_TABLES = R_TABLES + 2 * Z_TABLE_ROWS;

template <typename T>
struct AxisRows {
  const T* r[3];   // each kernel axis' rows, (2 or 50) x its with-halo extent
  int tables[3];   // the rows carry the WENO5 family's tables
};

// div of velocity a's advection at a point (i, j, k) of its wall face along
// bounded axis a (with-halo index h_a + n_a) from global memory, each flux
// with its own per-index metrics, as div_wall of weno5_advection.cuh
// computes it on a grid regular in x and y: the two fluxes along a sit at
// the centres beside the face, where every scheme's near-wall reduction
// falls back to the centred mean (transport_wall_centre); the centre above
// the face is h_a + n_a + 1, which wraps to 0 when h_a == 1, as torch.roll
// wraps it. The fluxes across a are transport_any's (the momentum scheme
// with its near-wall bounds, the to-faces tables of a stretched axis,
// PositiveWENO5's limiter, the clear flags of the velocity where its
// pointer is not null, the bf16 options of BF). The face area of a flux
// along axis b is the product of the other two axes' spacings at the
// velocity's location (R_DF along a, R_DC elsewhere) in the plain version's
// order, the volume (Δx Δy) Δz. A Flat axis (extent 1) has stride 0: each
// stencil along it reads the cell itself, as torch.roll does on an axis of
// length 1, and δ of its two equal fluxes is the plain version's x - x. The
// wall faces are a prologue's few points: one generic function, out of
// line, serves every form.
template <bool BF, typename T>
__device__ __noinline__ T div_wall_rows(const Advection<T>& A, const AxisRows<T>& R, int a,
                                        int i, int j, int k) {
  const int idx[3] = {i, j, k};
  const int ext[3] = {A.nx + 2 * A.hx, A.ny + 2 * A.hy, A.nz + 2 * A.hz};
  const int64_t s[3] = {ext[0] == 1 ? 0 : (int64_t)ext[1] * ext[2],
                        ext[1] == 1 ? 0 : (int64_t)ext[2], ext[2] == 1 ? 0 : (int64_t)1};
  const int64_t o = i * s[0] + j * s[1] + k * s[2];
  const T* __restrict__ c = A.psi[a];
  const int sch = BF ? A.scheme_m & 15 : A.scheme_m;
  const int bf = BF ? A.scheme_m >> 4 : BF16_NONE;
  const T eps = A.eps_m, half = T(0.5);
  const uint8_t* const fl = A.clear[a];
  auto clear = [&](int b, int64_t g) { return fl == nullptr || (fl[g] & A.cbit[b]) != 0; };
  // the velocity's spacing along kernel axis b at index x
  auto sp = [&](int b, int x) { return R.r[b][(b == a ? R_DF : R_DC) * ext[b] + x]; };
  T diff[3];
#pragma unroll 1
  for (int b = 0; b < 3; ++b) {
    const T area = b == 0 ? sp(1, j) * sp(2, k) : (b == 1 ? sp(0, i) * sp(2, k) : sp(0, i) * sp(1, j));
    T fR, fL;
    if (b == a) {
      const int64_t up = idx[b] + 1 < ext[b] ? s[b] : -(int64_t)idx[b] * s[b];
      const T vR = half * (c[o + up] + c[o]), vL = half * (c[o] + c[o - s[b]]);
      fR = area * transport_wall_centre<true>(vR, vR, c[o], c[o + up], sch, clear(b, o));
      fL = area * transport_wall_centre<true>(vL, vL, c[o - s[b]], c[o], sch,
                                              clear(b, o - s[b]));
    } else {  // at the faces idx and idx + 1 (to faces)
      const bool m = A.masked[b] != 0, tab = R.tables[b] != 0;
      const ZRows<T> tr{R.r[b] + R_TABLES * ext[b], ext[b]};
      const T* __restrict__ vb = A.psi[b];
      const T velR = half * (vb[o + s[b]] + vb[o + s[b] - s[a]]);
      const T velL = half * (vb[o] + vb[o - s[a]]);
      fR = area * transport_any<true, BF>(c, o + s[b], s[b], velR, sch, eps, m, A.mb[b],
                                          idx[b] + 1, tab, tr, true, fl, o + s[b], s[b],
                                          A.cbit[b], A.lo_m, A.hi_m, bf);
      fL = area * transport_any<true, BF>(c, o, s[b], velL, sch, eps, m, A.mb[b], idx[b], tab,
                                          tr, true, fl, o, s[b], A.cbit[b], A.lo_m, A.hi_m, bf);
    }
    diff[b] = fR - fL;
  }
  const T V = (sp(0, i) * sp(1, j)) * sp(2, k);
  return ieee_div((diff[0] + diff[1]) + diff[2], V);
}

// ---- the tiled kernel ------------------------------------------------------------

template <typename T>
struct XYArgs {
  Advection<T> adv;
  T* out[MAX_FIELDS];  // with-halo G: interior written, halos zero
  int walls;           // bit a: axis a is bounded, G of velocity a at its wall face
  AxisRows<T> rows;
  int nrows[3];        // rows of each axis that the blocks stage: 2, or 50 with tables
};

// the staged rows' extent along each axis: the tile's box, 3 cells either side
template <bool FL>
__host__ __device__ constexpr int row_span(int a, int kz) {
  using S = Tile<FL>;
  return a == 0 ? S::X + 2 * AT_R : (a == 1 ? S::Y + 2 * S::RY : kz + 2 * AT_R);
}

// elements of shared memory for chunks of kz levels and nf fields: advect_tile's
// boxes and face fluxes, then each axis' staged rows
template <bool FL>
static long xy_smem_elems(int kz, int nf, const int* nrows) {
  long n = advection_smem_elems<FL>(kz, nf);
  for (int a = 0; a < 3; ++a) n += (long)nrows[a] * row_span<FL>(a, kz);
  return n;
}

// Host side: the chunk of levels (the largest that fits, shortened on a
// grid of few columns until each of the card's `sms` SMs has a block, then
// chunks of equal size) and the divisors; returns the launch's grid and
// shared-memory bytes.
template <bool FL, typename T>
static dim3 plan_xy(XYArgs<T>& P, int sms, int& smem) {
  Advection<T>& A = P.adv;
  const long cols = (long)((A.nx + Tile<FL>::X - 1) / Tile<FL>::X)
                    * ((A.ny + Tile<FL>::Y - 1) / Tile<FL>::Y);
  int kz = A.nz < AT_KZ_MAX ? A.nz : AT_KZ_MAX;
  while (kz > 1 && xy_smem_elems<FL>(kz, A.nf, P.nrows) * (long)sizeof(T) > AT_SMEM_MAX) --kz;
  while (kz > 1 && cols * ((A.nz + kz - 1) / kz) < sms) --kz;
  const int chunks = (A.nz + kz - 1) / kz;
  A.kz = (A.nz + chunks - 1) / chunks;
  A.kzd = fast_div(A.kz);
  A.h2d = fast_div(2 * A.hz);
  smem = (int)(xy_smem_elems<FL>(A.kz, A.nf, P.nrows) * (long)sizeof(T));
  return dim3((unsigned)((A.nx + Tile<FL>::X - 1) / Tile<FL>::X),
              (unsigned)((A.ny + Tile<FL>::Y - 1) / Tile<FL>::Y), (unsigned)chunks);
}

// the velocity whose wall face (i, j, k) is, or -1
template <typename T>
__device__ __forceinline__ int wall_of(const XYArgs<T>& P, int i, int j, int k) {
  const Advection<T>& D = P.adv;
  const bool x = i >= D.hx && i < D.hx + D.nx, y = j >= D.hy && j < D.hy + D.ny,
             z = k >= D.hz && k < D.hz + D.nz;
  if ((P.walls & 1) && i == D.hx + D.nx && y && z) return 0;
  if ((P.walls & 2) && j == D.hy + D.ny && x && z) return 1;
  if ((P.walls & 4) && k == D.hz + D.nz && x && y) return 2;
  return -1;
}

// FL: the Flat layout (a Flat kernel y, advect_tile's 96 x 1 columns); ANY:
// every scheme and the clear flags; BF: WENO5's bf16 options (with ANY).
template <typename T, bool FL, bool ANY, bool BF>
__global__ void __launch_bounds__(XY_THREADS(T), 1)
stretched_xy_kernel(const __grid_constant__ XYArgs<T> P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using S = Tile<FL>;
  const Advection<T>& A = P.adv;
  const int X = A.nx + 2 * A.hx, Y = A.ny + 2 * A.hy, Z = A.nz + 2 * A.hz;
  const int kz = A.kz, tid = threadIdx.x, nt = blockDim.x;
  AdvTile<T> t;
  t.I0 = A.hx + (int)blockIdx.x * S::X;
  t.I1 = min(t.I0 + S::X, A.hx + A.nx);
  t.J0 = A.hy + (int)blockIdx.y * S::Y;
  t.J1 = min(t.J0 + S::Y, A.hy + A.ny);
  t.K0 = A.hz + (int)blockIdx.z * kz;
  t.K1 = min(t.K0 + kz, A.hz + A.nz);
  const int zs = kz + 2 * AT_R, box = S::BOX * zs;
  const bool flat_x = FL && X == 1;
  t.bsy = FL ? 0 : zs;
  t.bsx = flat_x ? 0 : (S::Y + 2 * S::RY) * zs;
  t.BI = t.I0 - AT_R;
  t.BJ = t.J0 - S::RY;
  t.BK = t.K0 - AT_R;
  t.gsy = FL ? 0 : Z;
  t.gsx = flat_x ? 0 : (int64_t)Y * Z;
  T* const su = reinterpret_cast<T*>(smem_raw);
  T* const sv = su + box;
  T* const sw = sv + box;
  T* const tb0 = sw + box;  // tracer buffers
  T* const tb1 = tb0 + box;
  T* const FX = tb0 + (A.nf - 3 < 2 ? A.nf - 3 : 2) * box;  // x faces: (X+1) x Y x kz
  T* const FY = FX + S::XF * kz;                            // y faces: X x (Y+1) x kz
  T* const FZ = FY + S::YF * kz;                            // z faces: X x Y x (kz+1)
  // each axis' rows over the box: row r at index x is rs[a][r * span + x - org]
  const int ext[3] = {X, Y, Z}, org[3] = {t.BI, t.BJ, t.BK};
  const int span[3] = {row_span<FL>(0, kz), row_span<FL>(1, kz), row_span<FL>(2, kz)};
  T* rs[3];
  rs[0] = FZ + S::COLS * (kz + 1);
  rs[1] = rs[0] + P.nrows[0] * span[0];
  rs[2] = rs[1] + P.nrows[1] * span[1];
  t.su = su;
  t.sv = sv;
  t.sw = sw;

  // 1. copies (clipped to the array): u, v, w and the rows, then the first tracer
  const int ci0 = max(t.BI, 0), ci1 = min(t.I1 + AT_R, X);
  const int cj0 = max(t.BJ, 0), cj1 = min(t.J1 + S::RY, Y);
  const int ck0 = max(t.BK, 0), ck1 = min(t.K1 + AT_R, Z);
  auto stage = [&](T* dst, const T* src) {
    copy_box_async(dst, src, t.gsx, t.gsy, ci0, ci1, cj0, cj1, ck0, ck1, t.BI, t.BJ,
                   t.BK, t.bsx, t.bsy);
  };
  stage(su, A.psi[0]);
  stage(sv, A.psi[1]);
  stage(sw, A.psi[2]);
#pragma unroll
  for (int a = 0; a < 3; ++a)
    for (int s = tid; s < P.nrows[a] * span[a]; s += nt) {
      const int r = s / span[a], x = org[a] + (s - r * span[a]);
      if (x >= 0 && x < ext[a]) copy_async(rs[a] + s, P.rows.r[a] + (int64_t)r * ext[a] + x);
    }
  copy_async_commit();
  if (A.nf > 3) {
    stage(tb0, A.psi[3]);
    copy_async_commit();
  }

  // 2. while they arrive: the halo zeros and the wall faces
  for_halo_points<FL>(A, t, [&](int i, int j, int k) {
    const int64_t p = t.g(i, j, k);
    const int wall = wall_of(P, i, j, k);
    for (int f = 0; f < A.nf; ++f)
      if (f != wall) P.out[f][p] = T(0);
  });
  const int nk = t.K1 - t.K0;
  if ((P.walls & 1) && blockIdx.x == gridDim.x - 1)  // u's east face
    for (int s = tid; s < S::Y * nk; s += nt) {
      const int j = t.J0 + s / nk, k = t.K0 + s % nk, i = A.hx + A.nx;
      if (j < t.J1) P.out[0][t.g(i, j, k)] = -div_wall_rows<BF>(A, P.rows, 0, i, j, k);
    }
  if ((P.walls & 2) && blockIdx.y == gridDim.y - 1)  // v's north face
    for (int s = tid; s < S::X * nk; s += nt) {
      const int i = t.I0 + s / nk, k = t.K0 + s % nk, j = A.hy + A.ny;
      if (i < t.I1) P.out[1][t.g(i, j, k)] = -div_wall_rows<BF>(A, P.rows, 1, i, j, k);
    }
  if ((P.walls & 4) && blockIdx.z == gridDim.z - 1)  // w's top face
    for (int s = tid; s < S::COLS; s += nt) {
      const int i = t.I0 + s / S::Y, j = t.J0 + s % S::Y, k = A.hz + A.nz;
      if (i < t.I1 && j < t.J1)
        P.out[2][t.g(i, j, k)] = -div_wall_rows<BF>(A, P.rows, 2, i, j, k);
    }

  // 3. field by field: the face fluxes, then the divergences
  const T half = T(0.5);
  // point s of the tile's kz levels (level fastest); false outside it
  auto point = [&](int s, int& i, int& j, int& k) {
    if (s >= S::COLS * kz) return false;
    const int cc = A.kzd.div(s);
    k = t.K0 + (s - cc * kz);
    i = t.I0 + cc / S::Y;
    j = t.J0 + cc % S::Y;
    return i < t.I1 && j < t.J1 && k < t.K1;
  };
  // the face arrays' offsets, by the cell whose left (bottom) face it is
  auto fxi = [&](int i, int j, int k) { return ((i - t.I0) * S::Y + (j - t.J0)) * kz + (k - t.K0); };
  auto fyi = [&](int i, int j, int k) { return ((i - t.I0) * (S::Y + 1) + (j - t.J0)) * kz + (k - t.K0); };
  auto fzi = [&](int i, int j, int k) { return ((i - t.I0) * S::Y + (j - t.J0)) * (kz + 1) + (k - t.K0); };
  for (int f = 0; f < A.nf; ++f) {
    const T* const c = f == 0 ? su : f == 1 ? sv : f == 2 ? sw : (f - 3) % 2 == 0 ? tb0 : tb1;
    if (f == 0) {
      if (A.nf > 3) copy_async_wait<1>();
      else copy_async_wait<0>();
    } else if (f >= 3) {
      copy_async_wait<0>();
    }
    __syncthreads();  // field f staged; field f-1's fluxes and points done
    if (f >= 3 && f + 1 < A.nf) {
      stage((f - 3) % 2 == 0 ? tb1 : tb0, A.psi[f + 1]);
      copy_async_commit();
    }
    const bool mom = f < 3;
    const int packed = mom ? A.scheme_m : A.scheme_t;
    const int sch = BF ? packed & 15 : packed;
    const int bf = BF ? packed >> 4 : BF16_NONE;  // the field's bf16 option
    const T eps = mom ? A.eps_m : A.eps_t;
    const int sa = f == 0 ? t.bsx : (f == 1 ? t.bsy : 1);
    // a momentum field's fluxes along its own axis sit at the centre below
    // the face (to centres)
    const int xq = f == 0 ? -1 : 0, yq = f == 1 ? -1 : 0, zq = f == 2 ? -1 : 0;
    // the face velocities: of a momentum field, the mean of the velocity at
    // the face's two points along the field's own stagger (stride sa); of a
    // tracer, the velocity at the face
    auto vel = [&](const T* s, int q) { return mom ? half * (s[q] + s[q - sa]) : s[q]; };
    // the field's spacings (Δᶠ along a velocity's own axis, Δᶜ elsewhere) and
    // the tables of each axis (to centres along a velocity's own axis), by
    // with-halo index
    auto row = [&](int a, int r) { return rs[a] + r * span[a] - org[a]; };
    const T* const dx = row(0, f == 0 ? R_DF : R_DC);
    const T* const dy = row(1, f == 1 ? R_DF : R_DC);
    const T* const dz = row(2, f == 2 ? R_DF : R_DC);
    // ANY: the field's clear flags and PositiveWENO5's bounds
    const uint8_t* const fl = ANY ? A.clear[mom ? f : 3] : nullptr;
    const T plo = mom ? A.lo_m : A.lo_t, phi = mom ? A.hi_m : A.hi_t;
    // the transport along kernel axis a (stride s_, global stride gs) at box
    // offset q and flux location qi (global offset g); to faces unless a
    // velocity's own axis; the field's own scheme's near-wall bounds
    auto trans = [&](int a, int q, int s_, T v, int qi, int64_t g, int64_t gs) {
      const ZRows<T> tr{row(a, R_TABLES + (a == f ? Z_TABLE_ROWS : 0)), span[a]};
      return transport_any<ANY, BF>(c, q, s_, v, sch, eps,
                                    (mom ? A.masked[a] : A.masked_t[a]) != 0,
                                    mom ? A.mb[a] : A.mb_t[a], qi, P.rows.tables[a] != 0, tr,
                                    a != f, fl, g, gs, A.cbit[a], plo, phi, bf);
    };
    // the fluxes, each its area (grid.Ax = Δy Δz, Ay = Δx Δz, Az = Δx Δy)
    // times its transport
    auto xflux = [&](int q, int i, int j, int k) {
      return (dy[j] * dz[k])
             * trans(0, q, t.bsx, vel(su, q), i + xq, ANY ? t.g(i + xq, j, k) : 0, t.gsx);
    };
    auto yflux = [&](int q, int i, int j, int k) {
      return (dx[i] * dz[k])
             * trans(1, q, t.bsy, vel(sv, q), j + yq, ANY ? t.g(i, j + yq, k) : 0, t.gsy);
    };
    auto zflux = [&](int q, int i, int j, int k) {
      return (dx[i] * dy[j])
             * trans(2, q, 1, vel(sw, q), k + zq, ANY ? t.g(i, j, k + zq) : 0, (int64_t)1);
    };
    // the left x, y and bottom z face of each cell: three independent
    // transports a task
    for (int s = tid; s < S::COLS * kz; s += nt) {
      int i, j, k;
      if (!point(s, i, j, k)) continue;
      const int q = t.at(i, j, k);
      const T fx = xflux(q, i, j, k);
      if constexpr (!FL) FY[fyi(i, j, k)] = yflux(q, i, j, k);
      const T fz = zflux(q, i, j, k);
      FX[fxi(i, j, k)] = fx;
      FZ[fzi(i, j, k)] = fz;
    }
    // the far faces: x at I1, y at J1 (none where y is Flat), z at K1
    const int nyf = FL ? 0 : S::X * kz;
    for (int s = tid; s < S::Y * kz + nyf + S::COLS; s += nt) {
      int i, j, k, axis;
      if (s < S::Y * kz) {
        const int cc = A.kzd.div(s);
        i = t.I1, j = t.J0 + cc, k = t.K0 + (s - cc * kz), axis = 0;
      } else if (s < S::Y * kz + nyf) {
        const int r = s - S::Y * kz, cc = A.kzd.div(r);
        i = t.I0 + cc, j = t.J1, k = t.K0 + (r - cc * kz), axis = 1;
      } else {
        const int r = s - S::Y * kz - nyf;
        i = t.I0 + r / S::Y, j = t.J0 + r % S::Y, k = t.K1, axis = 2;
      }
      if ((axis != 0 && i >= t.I1) || (axis != 1 && j >= t.J1) || (axis != 2 && k >= t.K1))
        continue;
      const int q = t.at(i, j, k);
      if (axis == 0)
        FX[fxi(i, j, k)] = xflux(q, i, j, k);
      else if (axis == 1)
        FY[fyi(i, j, k)] = yflux(q, i, j, k);
      else
        FZ[fzi(i, j, k)] = zflux(q, i, j, k);
    }
    __syncthreads();
    // each point's divergence from its two faces on each axis (a Flat y's δ
    // is +0, the plain version's x - x of its two equal fluxes)
    for (int s = tid; s < S::COLS * kz; s += nt) {
      int i, j, k;
      if (!point(s, i, j, k)) continue;
      const int x0 = fxi(i, j, k), y0 = fyi(i, j, k), z0 = fzi(i, j, k);
      const T fyR = FL ? T(0) : FY[y0 + kz], fyL = FL ? T(0) : FY[y0];
      const T div = flux_divergence_v(FX[x0 + S::Y * kz], FX[x0], fyR, fyL, FZ[z0 + 1],
                                      FZ[z0], (dx[i] * dy[j]) * dz[k]);
      P.out[f][t.g(i, j, k)] = -div;
    }
  }
}

template <typename T, bool FL, bool ANY, bool BF>
static int launch_form(XYArgs<T>& P, void* stream) {
  int dev = 0, sms = 0, smem;
  int rc = (int)cudaGetDevice(&dev);
  if (rc == 0) rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != 0) return rc;
  const dim3 blocks = plan_xy<FL>(P, sms, smem);
  auto kernel = stretched_xy_kernel<T, FL, ANY, BF>;
  rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != 0) return rc;
  kernel<<<blocks, XY_THREADS(T), smem, static_cast<cudaStream_t>(stream)>>>(P);
  return (int)cudaGetLastError();
}

// the first-code, ANY or bf16 form in the regular or the Flat layout
template <typename T, bool ANY, bool BF>
static int launch_layout(XYArgs<T>& P, bool flat, void* stream) {
  return flat ? launch_form<T, true, ANY, BF>(P, stream)
              : launch_form<T, false, ANY, BF>(P, stream);
}

template <typename T>
static int launch(const void* const* psi, void* const* out, const int* ia, const double* da,
                  int walls, const void* const* rows, const int* tables,
                  const void* const* clear, void* stream) {
  XYArgs<T> P;
  Advection<T>& A = P.adv;
  if (!set_advection(A, psi, ia, da)) return (int)cudaErrorInvalidValue;
  for (int f = 0; f < MAX_FIELDS; ++f)
    P.out[f] = f < A.nf ? static_cast<T*>(out[f]) : nullptr;
  P.walls = walls;
  for (int f = 0; f < 4; ++f)
    A.clear[f] = clear != nullptr ? static_cast<const uint8_t*>(clear[f]) : nullptr;
  for (int a = 0; a < 3; ++a) {
    P.rows.r[a] = static_cast<const T*>(rows[a]);
    P.rows.tables[a] = tables[a];
    P.nrows[a] = tables[a] ? ROWS_TABLES : ROWS_PLAIN;
  }
  if (A.nx <= 0 || A.ny <= 0 || A.nz <= 0) return 0;
  // the form, by configuration: WENO5's bf16 options the BF sub-form; a
  // scheme beyond the first codes, or an immersed grid's clear flags, ANY
  const bool flat = advection_flat(ia);
  if (advection_bf16(A)) return launch_layout<T, true, true>(P, flat, stream);
  if (clear != nullptr || needs_any(A.scheme_m) || needs_any(A.scheme_t))
    return launch_layout<T, true, false>(P, flat, stream);
  return launch_layout<T, false, false>(P, flat, stream);
}

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). `psi` and
// `out` are host arrays of nf device pointers in the kernel's axis order;
// `ia` and `da` the shared arguments (weno5_advection.cuh::set_advection;
// PositiveWENO5's bounds in `da`); bit a of `walls` writes G of velocity a
// at its wall face on bounded axis a; `rows` a host array of the three
// kernel axes' row tensors (ops/metric_rows.py::axis_rows, in the kernel's
// axis order) and `tables` whether each carries WENO5's tables; `clear` (an
// immersed grid, else null) a host array of the four clear-flag tensors'
// device pointers (u, v, w in the kernel's order, then the tracers'; a null
// entry: that field reads none).
int fused_advective_tendencies_stretched_f32(const void* const* psi, void* const* out,
                                             const int* ia, const double* da, int walls,
                                             const void* const* rows, const int* tables,
                                             const void* const* clear, void* stream) {
  return launch<float>(psi, out, ia, da, walls, rows, tables, clear, stream);
}

int fused_advective_tendencies_stretched_f64(const void* const* psi, void* const* out,
                                             const int* ia, const double* da, int walls,
                                             const void* const* rows, const int* tables,
                                             const void* const* clear, void* stream) {
  return launch<double>(psi, out, ia, da, walls, rows, tables, clear, stream);
}

}  // extern "C"
