// Fused shallow-water tendencies (conservative form), K3a: Guh, Gvh, Gh and
// every tracer's G, written into with-halo outputs: the interior computed,
// the halos zero (the kernel writes both; the caller allocates with
// torch.empty).
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
// with T the transport of weno5_advection.cuh (transport_axis: any of the
// JAX package's eight schemes, momentum and tracers each their own;
// PositiveWENO5's to-faces transports, those of uh along y, vh along x and
// the tracers, limited by transport_any's Zhang-Shu limiter) and the
// scheme's near-wall order reduction on a bounded x or y axis, one set of
// bounds for each scheme (each face knows its absolute index, so both axes
// take the bounds, where the TPU's tiled windows could carry them only
// along y).
// The grid is 2D: with-halo arrays (nx+2hx, ny+2hy, 1), y contiguous, and
// the flat z axis has dz = 1, so Ax = dy, Ay = dx, V = dx*dy exactly.
// Every division is ieee_div or ieee_div_by: IEEE's own quotient, bit for
// bit, kept off the hardware's slow path where the operands allow it
// (weno5_advection.cuh).
//
// What bounds it on an H100: memory. At 16384^2 fp32 with uh, vh, h it
// reads three with-halo fields (3 x 1.07 GB) and writes three: about
// 6.4 GB, 1.9 ms at 3.35 TB/s. The function needs four WENO5 transports
// of ~64 flops and a few divisions per point, ~300 flops: 80 GFLOP for
// 268 M points, 1.2 ms at the 67 TFLOP/s fp32 peak. In practice the
// kernel is bound by instruction issue: 26 correctly rounded divisions a
// point (each a reciprocal, Newton steps and ieee_div's checks) beside the
// WENO5 arithmetic, some 1,000 instructions a point by a count of this
// source (PERF.md has its times).
// Tensor cores (wgmma) have no part: the stencil holds no matrix product.
//
// The design: a block of 256 threads owns a TX x TY tile of the interior
// (16 x 64, y contiguous). It stages uh, vh and h over the tile and its
// 3-cell halo in shared memory with cp.async (tiles.cuh), then
// computes each face flux of the tile once, into shared memory (huu at the
// x centres I0-1 .. I1-1, hvu at the y faces J0 .. J1, huv at the x faces
// I0 .. I1, hvv at the y centres J0-1 .. J1-1: cell I's huu(I) is cell
// I+1's left one, the same expression on the same operands), and
// differences them. Tracers go through a second buffer pair: tracer f+1 is
// copied while tracer f's face fluxes (at the x and y faces, with the face
// velocities uh/ixf(h), vh/iyf(h) computed once) are computed. Blocks on
// the domain's edge also write the halo zeros next to their tile.
#include <cuda_runtime.h>

#include "tiles.cuh"
#include "weno5_advection.cuh"

template <typename T>
struct ShallowWaterArgs {
  const T* psi[MAX_FIELDS];  // with-halo uh, vh, h, tracers
  const T* hB;               // with-halo bathymetry or nullptr
  T* out[MAX_FIELDS];        // with-halo G: interior computed, halos zero
  int nf;                    // 3 + number of tracers
  int nx, ny, hx, hy;
  int scheme_m, scheme_t;    // momentum / tracers: SCHEME_*
  // per scheme (0 momentum, 1 tracers) and axis (x, y): its near-wall
  // order reduction on a bounded axis and the reduction's bounds
  int masked[2][2];
  Bounds mb[2][2];
  T eps_m, eps_t, dx, dy;
  T g, half_g;               // g and 0.5*g, each rounded once to T
  T lo_m, hi_m, lo_t, hi_t;  // PositiveWENO5's bounds, momentum / tracers (ANY)
  int bf_m, bf_t;            // WENO5's bf16 option, momentum / tracers (BF)
};

constexpr int SW_TX = 16, SW_TY = 64, SW_THREADS = 256, SW_R = 3;
// shared-memory layout, in elements of T: the staged box (TX+6) x (TY+6)
// per field, then the flux arrays
constexpr int SW_BW = SW_TY + 2 * SW_R;                 // staged row length
constexpr int SW_BOX = (SW_TX + 2 * SW_R) * SW_BW;
constexpr int SW_XF = (SW_TX + 1) * SW_TY;              // x faces (or centres) x TY
constexpr int SW_YF = SW_TX * (SW_TY + 1);              // TX x y faces (or centres)

// elements of T: uh, vh, h, huu, hvu, huv, hvv; with tracers two tracer
// buffers, the face velocities, one tracer's face fluxes and div(u, v)
static int shallow_water_smem_elems(int nf) {
  int n = 3 * SW_BOX + 2 * (SW_XF + SW_YF);
  if (nf > 3) n += 2 * SW_BOX + 2 * (SW_XF + SW_YF) + SW_TX * SW_TY;
  return n;
}

// ANY: a scheme of needs_any (weno5_advection.cuh); without it the
// transports compile to the four first codes' branches alone. BF: ANY's
// bf16 sub-form, for WENO5's bf16 options
template <typename T, bool ANY, bool BF = false>
__global__ void __launch_bounds__(SW_THREADS)
fused_shallow_water_tendencies_kernel(const __grid_constant__ ShallowWaterArgs<T> A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  const int X = A.nx + 2 * A.hx, Y = A.ny + 2 * A.hy;
  const int64_t gsx = Y;                     // global x stride (y is contiguous)
  // the tile: interior with-halo indices [I0, I1) x [J0, J1)
  const int I0 = A.hx + (int)blockIdx.y * SW_TX, I1 = min(I0 + SW_TX, A.hx + A.nx);
  const int J0 = A.hy + (int)blockIdx.x * SW_TY, J1 = min(J0 + SW_TY, A.hy + A.ny);
  const int BI = I0 - SW_R, BJ = J0 - SW_R;  // staged box origin
  const int tid = threadIdx.x;

  T* const suh = sm;
  T* const svh = sm + SW_BOX;
  T* const sh = sm + 2 * SW_BOX;
  T* const HUU = sm + 3 * SW_BOX;            // (TX+1) x TY, x centres from I0-1
  T* const HVU = HUU + SW_XF;                // TX x (TY+1), y faces from J0
  T* const HUV = HVU + SW_YF;                // (TX+1) x TY, x faces from I0
  T* const HVV = HUV + SW_XF;                // TX x (TY+1), y centres from J0-1
  T* const tbuf0 = HVV + SW_YF;              // with tracers only
  T* const tbuf1 = tbuf0 + SW_BOX;
  T* const UF = tbuf1 + SW_BOX;              // (TX+1) x TY, x faces from I0
  T* const VF = UF + SW_XF;                  // TX x (TY+1), y faces from J0
  T* const FX = VF + SW_YF;
  T* const FY = FX + SW_XF;
  T* const DIVU = FY + SW_YF;                // TX x TY

  // stage uh, vh, h over the box clipped to the array (every read below
  // stays inside the array, as the plain version's does)
  const int ci0 = max(BI, 0), ci1 = min(I1 + SW_R, X);
  const int cj0 = max(BJ, 0), cj1 = min(J1 + SW_R, Y);
  // (a copy's rows run along x; y, the contiguous axis, is its k)
  auto stage = [&](T* dst, const T* src) {
    copy_box_async(dst, src, gsx, (int64_t)0, ci0, ci1, 0, 1, cj0, cj1, BI, 0, BJ,
                   SW_BW, 0);
  };
  for (int f = 0; f < 3; ++f) stage(sm + f * SW_BOX, A.psi[f]);
  copy_async_commit();
  if (A.nf > 3) {
    stage(tbuf0, A.psi[3]);
    copy_async_commit();
  }

  // halo zeros: a block on the domain's edge owns the halo rows and columns
  // next to its tile (corners included), so every halo point is written once
  {
    const int ri0 = I0 == A.hx ? 0 : I0, ri1 = I1 == A.hx + A.nx ? X : I1;
    const int rj0 = J0 == A.hy ? 0 : J0, rj1 = J1 == A.hy + A.ny ? Y : J1;
    if (ri0 != I0 || ri1 != I1 || rj0 != J0 || rj1 != J1) {
      const int nj = rj1 - rj0, n = (ri1 - ri0) * nj;
      for (int t = tid; t < n; t += SW_THREADS) {
        const int i = ri0 + t / nj, j = rj0 + t % nj;
        if (i >= I0 && i < I1 && j >= J0 && j < J1) continue;
        for (int f = 0; f < A.nf; ++f) A.out[f][i * gsx + j] = T(0);
      }
    }
  }

  if (A.nf > 3) copy_async_wait<1>(); else copy_async_wait<0>();
  __syncthreads();

  const T half = T(0.5);
  const T Ax = A.dy, Ay = A.dx, V = A.dx * A.dy;
  const int sm_ = A.scheme_m, st_ = A.scheme_t;
  const bool xm = A.masked[0][0] != 0, ym = A.masked[0][1] != 0;
  const int sx = SW_BW;                      // shared-memory x stride
  auto at = [&](int i, int j) { return (i - BI) * sx + (j - BJ); };
  // ixf(iyf(h)) at the (F, F) point of shared offset f
  auto h_ff = [&](int f) {
    return half * (half * (sh[f] + sh[f - 1]) + half * (sh[f - sx] + sh[f - sx - 1]));
  };
  auto pressure = [&](int c) { return (A.half_g * sh[c]) * sh[c]; };
  // transport() of scheme sch at shared offset o (to faces: `to_f`); ANY
  // also takes PositiveWENO5's limiter with the bounds (lo, hi), and its
  // bf16 sub-form BF the bf16 option bf
  auto trans = [&](const T* c, int o, int s, T vel, int sch, T eps, bool m, const Bounds& b,
                   int q, bool to_f, T lo, T hi, int bf) {
    if constexpr (ANY)
      return transport_any<ANY, BF>(c, (int64_t)o, (int64_t)s, vel, sch, eps, m, b, q, false,
                                    ZRows<T>{}, to_f, nullptr, 0, 0, 0, lo, hi, bf);
    else
      return transport_axis<ANY>(c, (int64_t)o, (int64_t)s, vel, sch, eps, m, b, q);
  };

  // each face flux of the tile, once: the x-face arrays, then the y-face
  // arrays, in one loop so that the block's threads stay evenly loaded
  for (int u = tid; u < SW_XF + SW_YF; u += SW_THREADS) {
    if (u < SW_XF) {
      const int t = u, a = t / SW_TY, j = J0 + t % SW_TY;
      if (j >= J1) continue;
      const int i = I0 - 1 + a;  // huu at centre i: the to-centres x flux of uh over h
      if (i < I1) {
        const int c = at(i, j);
        const T vel = half * (suh[c + sx] + suh[c]);
        HUU[t] = ieee_div(Ax * trans(suh, c + sx, sx, vel, sm_, A.eps_m, xm, A.mb[0][0], i,
                                     false, A.lo_m, A.hi_m, A.bf_m), sh[c]);
      }
      const int f = at(i + 1, j);  // huv at x face i+1: the x flux of vh over h_ff
      const T vel = half * (suh[f] + suh[f - 1]);
      HUV[t] = ieee_div(Ax * trans(svh, f, sx, vel, sm_, A.eps_m, xm, A.mb[0][0], i + 1,
                                   true, A.lo_m, A.hi_m, A.bf_m), h_ff(f));
    } else {
      const int t = u - SW_XF, i = I0 + t / (SW_TY + 1), b = t % (SW_TY + 1);
      if (i >= I1) continue;
      const int j = J0 + b;  // hvu at y face j: the y flux of uh over h_ff
      if (j <= J1) {
        const int f = at(i, j);
        const T vel = half * (svh[f] + svh[f - sx]);
        HVU[t] = ieee_div(Ay * trans(suh, f, 1, vel, sm_, A.eps_m, ym, A.mb[0][1], j, true,
                                     A.lo_m, A.hi_m, A.bf_m), h_ff(f));
      }
      if (j - 1 < J1) {  // hvv at centre j-1: the to-centres y flux of vh over h
        const int c = at(i, j - 1);
        const T vel = half * (svh[c + 1] + svh[c]);
        HVV[t] = ieee_div(Ay * trans(svh, c + 1, 1, vel, sm_, A.eps_m, ym, A.mb[0][1], j - 1,
                                     false, A.lo_m, A.hi_m, A.bf_m), sh[c]);
      }
    }
  }
  if (A.nf > 3) {  // the tracers' face velocities
    for (int t = tid; t < SW_XF; t += SW_THREADS) {
      const int i = I0 + t / SW_TY, j = J0 + t % SW_TY;
      if (i > I1 || j >= J1) continue;
      const int f = at(i, j);
      UF[t] = ieee_div(suh[f], half * (sh[f] + sh[f - sx]));
    }
    for (int t = tid; t < SW_YF; t += SW_THREADS) {
      const int i = I0 + t / (SW_TY + 1), j = J0 + t % (SW_TY + 1);
      if (i >= I1 || j > J1) continue;
      const int f = at(i, j);
      VF[t] = ieee_div(svh[f], half * (sh[f] + sh[f - 1]));
    }
  }
  __syncthreads();

  // Guh, Gvh, Gh at the tile's points
  for (int t = tid; t < SW_TX * SW_TY; t += SW_THREADS) {
    const int a = t / SW_TY, b = t % SW_TY;
    const int i = I0 + a, j = J0 + b;
    if (i >= I1 || j >= J1) continue;
    const int o = at(i, j);
    const int64_t go = i * gsx + j;
    const int xf = a * SW_TY + b;            // (TX+1) x TY arrays at x index I0+a
    const int yf = a * (SW_TY + 1) + b;      // TX x (TY+1) arrays at y index J0+b
    {  // Guh at (F, C): x fluxes at centres i-1, i; y fluxes at faces j, j+1
      const T div = ieee_div((HUU[xf + SW_TY] - HUU[xf]) + (HVU[yf + 1] - HVU[yf]), V);
      T G = -div - ieee_div(pressure(o) - pressure(o - sx), A.dx);
      if (A.hB != nullptr)
        G = G + ieee_div((A.g * (half * (sh[o] + sh[o - sx]))) * (A.hB[go] - A.hB[go - gsx]),
                         A.dx);
      A.out[0][go] = G;
    }
    {  // Gvh at (C, F): x fluxes at faces i, i+1; y fluxes at centres j-1, j
      const T div = ieee_div((HUV[xf + SW_TY] - HUV[xf]) + (HVV[yf + 1] - HVV[yf]), V);
      T G = -div - ieee_div(pressure(o) - pressure(o - 1), A.dy);
      if (A.hB != nullptr)
        G = G + ieee_div((A.g * (half * (sh[o] + sh[o - 1]))) * (A.hB[go] - A.hB[go - 1]),
                         A.dy);
      A.out[1][go] = G;
    }
    A.out[2][go] = ieee_div(-((Ax * suh[o + sx] - Ax * suh[o]) + (Ay * svh[o + 1] - Ay * svh[o])),
                            V);
    if (A.nf > 3)
      DIVU[t] = ieee_div((Ax * UF[xf + SW_TY] - Ax * UF[xf]) + (Ay * VF[yf + 1] - Ay * VF[yf]),
                         V);
  }

  // tracers at (C, C), advected by the face velocities; tracer f+1 is
  // copied into the other buffer while tracer f is computed
  const bool xt = A.masked[1][0] != 0, yt = A.masked[1][1] != 0;
  for (int f = 3; f < A.nf; ++f) {
    T* const sc = (f - 3) % 2 == 0 ? tbuf0 : tbuf1;
    copy_async_wait<0>();
    __syncthreads();  // tracer f staged; tracer f-1's buffer and fluxes free
    if (f + 1 < A.nf) {
      stage((f - 3) % 2 == 0 ? tbuf1 : tbuf0, A.psi[f + 1]);
      copy_async_commit();
    }
    for (int t = tid; t < SW_XF; t += SW_THREADS) {
      const int i = I0 + t / SW_TY, j = J0 + t % SW_TY;
      if (i > I1 || j >= J1) continue;
      FX[t] = Ax * trans(sc, at(i, j), sx, UF[t], st_, A.eps_t, xt, A.mb[1][0], i, true,
                         A.lo_t, A.hi_t, A.bf_t);
    }
    for (int t = tid; t < SW_YF; t += SW_THREADS) {
      const int i = I0 + t / (SW_TY + 1), j = J0 + t % (SW_TY + 1);
      if (i >= I1 || j > J1) continue;
      FY[t] = Ay * trans(sc, at(i, j), 1, VF[t], st_, A.eps_t, yt, A.mb[1][1], j, true,
                         A.lo_t, A.hi_t, A.bf_t);
    }
    __syncthreads();
    for (int t = tid; t < SW_TX * SW_TY; t += SW_THREADS) {
      const int a = t / SW_TY, b = t % SW_TY;
      const int i = I0 + a, j = J0 + b;
      if (i >= I1 || j >= J1) continue;
      const int xf = a * SW_TY + b, yf = a * (SW_TY + 1) + b;
      const T div_Uc = ieee_div((FX[xf + SW_TY] - FX[xf]) + (FY[yf + 1] - FY[yf]), V);
      A.out[f][i * gsx + j] = -div_Uc + sc[at(i, j)] * DIVU[t];
    }
  }
}

// `ia` (27 ints): nf, nx, ny, hx, hy, the two scheme codes, then for the
// momentum scheme and then the tracer scheme, for x and then y, (masked,
// lo_l, hi_l, lo_r, hi_r) (ops/fused_tendencies.py::shallow_water_args);
// `da`: eps_m, eps_t, dx, dy, g, PositiveWENO5's (lo, hi) of the momentum
// and of the tracer scheme.
template <typename T>
static int launch(const void* const* psi, const void* hB, void* const* out, const int* ia,
                  const double* da, void* stream) {
  const int nf = ia[0], nx = ia[1], ny = ia[2];
  if (nf < 3 || nf > MAX_FIELDS) return (int)cudaErrorInvalidValue;
  ShallowWaterArgs<T> A;
  for (int f = 0; f < MAX_FIELDS; ++f) {
    A.psi[f] = f < nf ? static_cast<const T*>(psi[f]) : nullptr;
    A.out[f] = f < nf ? static_cast<T*>(out[f]) : nullptr;
  }
  A.hB = static_cast<const T*>(hB);
  A.nf = nf;
  A.nx = nx; A.ny = ny; A.hx = ia[3]; A.hy = ia[4];
  split_scheme<T>(ia[5], A.scheme_m, A.bf_m);
  split_scheme<T>(ia[6], A.scheme_t, A.bf_t);
  for (int set = 0; set < 2; ++set)
    for (int a = 0; a < 2; ++a) {
      const int* b = ia + 7 + 10 * set + 5 * a;
      A.masked[set][a] = b[0];
      A.mb[set][a] = Bounds{b[1], b[2], b[3], b[4]};
    }
  A.eps_m = T(da[0]); A.eps_t = T(da[1]);
  A.dx = T(da[2]); A.dy = T(da[3]);
  A.g = T(da[4]); A.half_g = T(0.5 * da[4]);
  A.lo_m = T(da[5]); A.hi_m = T(da[6]);
  A.lo_t = T(da[7]); A.hi_t = T(da[8]);
  if (nx <= 0 || ny <= 0) return 0;
  const dim3 blocks((ny + SW_TY - 1) / SW_TY, (nx + SW_TX - 1) / SW_TX);
  const int smem = shallow_water_smem_elems(nf) * (int)sizeof(T);
  // the bf16 sub-form of ANY for WENO5's bf16 options
  const bool bf = A.bf_m != BF16_NONE || A.bf_t != BF16_NONE;
  const bool any = bf || needs_any(A.scheme_m) || needs_any(A.scheme_t);
  auto kernel = bf ? fused_shallow_water_tendencies_kernel<T, true, true>
                   : any ? fused_shallow_water_tendencies_kernel<T, true>
                         : fused_shallow_water_tendencies_kernel<T, false>;
  if (smem > 48 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != 0) return rc;
  }
  kernel<<<blocks, SW_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(A);
  return (int)cudaGetLastError();
}

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). `psi` and
// `out` are host arrays of nf device pointers; `hB` is a device pointer or
// null; `ia` and `da` host arrays (launch above).
int fused_shallow_water_tendencies_f32(const void* const* psi, const void* hB,
                                       void* const* out, const int* ia, const double* da,
                                       void* stream) {
  return launch<float>(psi, hB, out, ia, da, stream);
}

int fused_shallow_water_tendencies_f64(const void* const* psi, const void* hB,
                                       void* const* out, const int* ia, const double* da,
                                       void* stream) {
  return launch<double>(psi, hB, out, ia, da, stream);
}

}  // extern "C"
