// Fused advective tendencies of the nonhydrostatic model: for every
// prognostic field psi in {u, v, w, tracers}, G = -div(v psi), written into
// the interior of a with-halo output whose halos the kernel writes as zeros.
//
// Replaces the TPU kernel clima_oceananigans_jl_tpu/ops/fused_tendencies.py::
// fused_advective_tendencies. It computes what that kernel computes, in the
// expression trees of the port's plain version
// (ops/fused_tendencies.py::fused_advective_tendencies_reference, the
// div_vu / div_vv / div_vw / div_Uc of advection/fluxes.py); the flux code
// is advect_tile of weno5_advection.cuh, shared with the fused AB2 advance.
// Momentum and tracers each take any of the JAX package's eight schemes; a
// bounded axis reduces a scheme's order near its walls through the
// with-halo bounds of reduced_order_masks for that scheme (required_halo 2
// or 3), one set for momentum and one for the tracers. A Flat
// axis is the kernel's y (ops/fused_tendencies.py::kernel_order), which
// advect_tile's Flat layout maps away (weno5_advection.cuh).
//
// On each bounded axis the kernel also writes the tendency of the velocity
// normal to it at its far wall face (with-halo index h + n: u's east face,
// v's north face, w's top face), which lies in the halo. A wall that is not
// an imposed value (FluxBC) leaves that face to the time step, so G there
// must be what the whole-array stencil of the plain version gives, as the
// JAX kernel keeps w's when its blocks carry z halos. The blocks of the
// last tile along the axis compute it for their part of the face from
// global memory (div_wall) while their tiles are being copied.
//
// What bounds it on an H100: at 256^3 fp32 with u, v, w, b it reads four
// with-halo fields (4 x 72 MB) and writes four with-halo outputs (4 x 72
// MB): about 0.58 GB, 0.17 ms at 3.35 TB/s. The function needs 12 WENO5
// transports of ~64 flops per point (three faces for each of four fields)
// and the divergences, ~800 flops: 0.20 ms at the 67 TFLOP/s fp32 peak,
// which bounds it. In practice its exact divisions and dependent WENO5
// chains bound it by instruction issue.
//
// The design: advect_tile (weno5_advection.cuh), 8 x 12 columns and up to
// 32 levels a block of 1024 threads, tiles staged in shared memory with
// cp.async, each face flux computed once (3.24 transports a point and field
// at 256^3 instead of 6), tracers through a double buffer; the prologue
// writes the halo zeros of the outputs (so the wrapper allocates with
// torch.empty) and the top w face.
//
// A stretched z runs a second instantiation (ZS): the z rows of
// ops/metric_rows.py (per-level Dz[C] and Dz[F], WENO5's to-faces and
// to-centres tables) give each level its face areas and volume and the z
// fluxes their two-sided table form, as the JAX kernel reads them from its
// metric pack; the regular instantiation carries none of it. So do a grid
// with a Flat axis (FL, the Flat layout), one whose x or y has near-wall
// bounds (XY, the x and y fluxes' masks), and C4, UB1, UB3,
// BoundsPreservingWENO5 or PositiveWENO5 for either field kind (ANY: every
// scheme, each with its own near-wall bounds; the other instantiations
// compile centred, WENO5 and UB5 alone, as they did before those schemes
// came).
//
// A grid stretched in x or y runs K2's stretched-x/y form, a source of its
// own (fused_advective_tendencies_xy.cu), which the JAX kernel leaves to jnp.
//
// An immersed grid runs the IM instantiations: each flux reads the clear
// flag of its flux location (the uint8 tensors of
// immersed/immersed.py::clear_flags: u, v, w and the tracers' CENTER) and
// drops to first-order upwind where its stencil reaches a solid cell (the
// conditional fluxes of advection/schemes.py::transport), the wall faces
// too (div_wall). PositiveWENO5, for momentum or tracers, on a regular or
// stretched z, runs the ANY instantiations: its to-faces transports take
// the two-sided form with the Zhang-Shu limiter (transport_positive,
// weno5_advection.cuh; on a stretched z the z flux's table form, each face
// with its own row). The regular instantiations compile both out.
//
// PositiveWENO5's work: a limited face reconstructs four times (L and R at
// the face, L above, R below) and computes two thetas, ~300 operations as
// written against WENO5's stream's ~64, where the function needs ~150
// (each face's L and R once, with shared differences; the count
// chip_smoke.py's bound takes); over an immersed bottom each flux adds a
// byte load and a select.
//
// K2's instantiations build as two libraries from two sources, both
// including this header, at once: fused_advective_tendencies.cu the first
// codes (centred, WENO5, UB5; 32 kernels) and
// fused_advective_tendencies_any.cu the ANY ones and the bf16 sub-form BF
// (40 kernels); ops/fused_tendencies.py::k2_library picks the one a launch
// needs, and each entry refuses a launch that belongs to the other.
#pragma once

#include <cuda_runtime.h>

#include "weno5_advection.cuh"

template <typename T>
struct TendencyArgs {
  Advection<T> adv;
  T* out[MAX_FIELDS];  // with-halo G: interior written, halos zero
  int walls;           // bit a: axis a is bounded, G of velocity a at its wall face
};

// K2's use of advect_tile: G = -div into the with-halo outputs (ZS: on a
// stretched z; FL: the Flat layout; IM: the clear flags at the wall faces)
template <typename T, bool ZS, bool FL, bool IM, bool ANY, bool BF = false>
struct TendencyOut {
  const TendencyArgs<T>& A;

  // the velocity whose wall face (i, j, k) is, or -1
  __device__ __forceinline__ int wall_of(int i, int j, int k) const {
    const Advection<T>& D = A.adv;
    const bool x = i >= D.hx && i < D.hx + D.nx, y = j >= D.hy && j < D.hy + D.ny,
               z = k >= D.hz && k < D.hz + D.nz;
    if ((A.walls & 1) && i == D.hx + D.nx && y && z) return 0;
    if ((A.walls & 2) && j == D.hy + D.ny && x && z) return 1;
    if ((A.walls & 4) && k == D.hz + D.nz && x && y) return 2;
    return -1;
  }

  __device__ __forceinline__ void prologue(const AdvTile<T>& t) const {
    using S = Tile<FL>;
    const Advection<T>& D = A.adv;
    for_halo_points<FL>(D, t, [&](int i, int j, int k) {
      const int64_t p = t.g(i, j, k);
      const int wall = wall_of(i, j, k);
      for (int f = 0; f < D.nf; ++f)
        if (f != wall) A.out[f][p] = T(0);
    });
    const int kz = t.K1 - t.K0;
    if ((A.walls & 1) && blockIdx.x == gridDim.x - 1)  // u's east face
      for (int s = threadIdx.x; s < S::Y * kz; s += blockDim.x) {
        const int j = t.J0 + s / kz, k = t.K0 + s % kz, i = D.hx + D.nx;
        if (j < t.J1)
          A.out[0][t.g(i, j, k)] = -div_wall<ZS, IM, ANY, BF>(D, 0, i, j, k, t.gsx, t.gsy);
      }
    if ((A.walls & 2) && blockIdx.y == gridDim.y - 1)  // v's north face
      for (int s = threadIdx.x; s < S::X * kz; s += blockDim.x) {
        const int i = t.I0 + s / kz, k = t.K0 + s % kz, j = D.hy + D.ny;
        if (i < t.I1)
          A.out[1][t.g(i, j, k)] = -div_wall<ZS, IM, ANY, BF>(D, 1, i, j, k, t.gsx, t.gsy);
      }
    if ((A.walls & 4) && blockIdx.z == gridDim.z - 1)  // w's top face
      for (int s = threadIdx.x; s < S::COLS; s += blockDim.x) {
        const int i = t.I0 + s / S::Y, j = t.J0 + s % S::Y, k = D.hz + D.nz;
        if (i < t.I1 && j < t.J1)
          A.out[2][t.g(i, j, k)] = -div_wall<ZS, IM, ANY, BF>(D, 2, i, j, k, t.gsx, t.gsy);
      }
  }

  struct Pre {};  // nothing to load ahead

  __device__ __forceinline__ Pre prefetch(int f, const AdvTile<T>& t, int I, int J,
                                          int K) const {
    return Pre{};
  }

  __device__ __forceinline__ void point(int f, const AdvTile<T>& t, const T* c, int q,
                                        int I, int J, int K, T div, Pre) const {
    A.out[f][t.g(I, J, K)] = -div;
  }
};

template <typename T, bool ZS, bool FL, bool XY, bool IM, bool ANY, bool BF = false>
__global__ void __launch_bounds__(AT_THREADS, 1)
fused_advective_tendencies_kernel(const __grid_constant__ TendencyArgs<T> A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  advect_tile<ZS, FL, XY, IM, ANY, BF>(A.adv, reinterpret_cast<T*>(smem_raw),
                                       TendencyOut<T, ZS, FL, IM, ANY, BF>{A});
}

template <typename T, bool ZS, bool FL, bool XY, bool IM, bool ANY, bool BF = false>
static int launch_kernel(TendencyArgs<T>& A, void* stream) {
  int smem;
  const dim3 blocks = plan_tiles<FL>(A.adv, smem);
  auto kernel = fused_advective_tendencies_kernel<T, ZS, FL, XY, IM, ANY, BF>;
  const int rc = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != 0) return rc;
  kernel<<<blocks, AT_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(A);
  return (int)cudaGetLastError();
}

// the IM or regular instantiation of one (ZS, FL, XY, ANY)
template <typename T, bool ZS, bool FL, bool XY, bool ANY>
static int launch_im(TendencyArgs<T>& A, bool im, void* stream) {
  return im ? launch_kernel<T, ZS, FL, XY, true, ANY>(A, stream)
            : launch_kernel<T, ZS, FL, XY, false, ANY>(A, stream);
}

// The shared arguments of a launch, set from the entry's; false on a bad
// argument. `flat` and `xy` name the (FL, XY) instantiation.
template <typename T>
static bool set_tendency_args(TendencyArgs<T>& A, const void* const* psi, void* const* out,
                              const int* ia, const double* da, int walls, const void* zs,
                              int tables, const void* const* clear, bool& flat, bool& xy) {
  if (!set_advection(A.adv, psi, ia, da)) return false;
  for (int f = 0; f < MAX_FIELDS; ++f)
    A.out[f] = f < A.adv.nf ? static_cast<T*>(out[f]) : nullptr;
  A.walls = walls;
  A.adv.zs = static_cast<const T*>(zs);
  A.adv.tables = tables;
  for (int f = 0; f < 4; ++f)
    A.adv.clear[f] = clear != nullptr ? static_cast<const uint8_t*>(clear[f]) : nullptr;
  flat = advection_flat(ia);
  const auto &m = A.adv.masked, &mt = A.adv.masked_t;
  xy = m[0] || m[1] || mt[0] || mt[1];
  return true;
}

// One of the eight (ZS, FL, XY) forms of the IM or regular instantiation
// with ANY as given.
template <typename T, bool ANY>
static int launch_form(TendencyArgs<T>& A, bool zs, bool flat, bool xy, bool im,
                       void* stream) {
  if (zs) {
    if (flat) return xy ? launch_im<T, true, true, true, ANY>(A, im, stream)
                        : launch_im<T, true, true, false, ANY>(A, im, stream);
    return xy ? launch_im<T, true, false, true, ANY>(A, im, stream)
              : launch_im<T, true, false, false, ANY>(A, im, stream);
  }
  if (flat) return xy ? launch_im<T, false, true, true, ANY>(A, im, stream)
                      : launch_im<T, false, true, false, ANY>(A, im, stream);
  return xy ? launch_im<T, false, false, true, ANY>(A, im, stream)
            : launch_im<T, false, false, false, ANY>(A, im, stream);
}

