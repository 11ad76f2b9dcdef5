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
// Momentum and tracers each take WENO5 or CenteredSecondOrder; bounded z
// reduces WENO5's order near the walls through the with-halo bounds of
// reduced_order_masks.
//
// On a bounded z axis the kernel also writes G_w at w's top wall face
// (with-halo z index hz+nz), which lies in the z halo. A w wall that is not
// an imposed value (FluxBC) leaves that face to the time step, so G_w there
// must be what the whole-array stencil of the plain version gives, as the
// JAX kernel keeps it when its blocks carry z halos. The blocks of the last
// chunk compute it for their columns from global memory while their tiles
// are being copied (the centre above the face wraps to z index 0 when
// hz == 1, which a box of the top chunk does not hold).
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
// metric pack; the regular instantiation carries none of it.
#include <cuda_runtime.h>

#include "weno5_advection.cuh"

template <typename T>
struct TendencyArgs {
  Advection<T> adv;
  T* out[MAX_FIELDS];  // with-halo G: interior written, halos zero
  int w_top;           // bounded z: also G_w at the top wall face
};

// K2's use of advect_tile: G = -div into the with-halo outputs (ZS: on a
// stretched z)
template <typename T, bool ZS>
struct TendencyOut {
  const TendencyArgs<T>& A;

  __device__ __forceinline__ void prologue(const AdvTile<T>& t) const {
    const Advection<T>& D = A.adv;
    const int top = D.hz + D.nz;
    for_halo_points(D, t, [&](int i, int j, int k) {
      const int64_t p = t.g(i, j, k);
      // the top w face of an interior column is the one halo point written
      const bool face = A.w_top && k == top && i >= D.hx && i < D.hx + D.nx
                        && j >= D.hy && j < D.hy + D.ny;
      for (int f = 0; f < D.nf; ++f)
        if (!(f == 2 && face)) A.out[f][p] = T(0);
    });
    if (A.w_top && blockIdx.z == gridDim.z - 1)
      for (int s = threadIdx.x; s < AT_COLS; s += blockDim.x) {
        const int i = t.I0 + s / AT_Y, j = t.J0 + s % AT_Y;
        if (i >= t.I1 || j >= t.J1) continue;
        const int64_t o = t.g(i, j, top);
        const T dz = ZS ? D.zs[Z_DZ_F * (D.nz + 2 * D.hz) + top] : D.dz;
        A.out[2][o] = -div_vw_top(D, o, t.gsx, t.gsy, top, dz);
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

template <typename T, bool ZS>
__global__ void __launch_bounds__(AT_THREADS, 1)
fused_advective_tendencies_kernel(const __grid_constant__ TendencyArgs<T> A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  advect_tile<ZS>(A.adv, reinterpret_cast<T*>(smem_raw), TendencyOut<T, ZS>{A});
}

template <typename T, bool ZS>
static int launch_kernel(const TendencyArgs<T>& A, dim3 blocks, int smem, void* stream) {
  auto kernel = fused_advective_tendencies_kernel<T, ZS>;
  const int rc = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != 0) return rc;
  kernel<<<blocks, AT_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(A);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* const* psi, void* const* out, int nf, int nx,
                  int ny, int nz, int hx, int hy, int hz, int weno_m,
                  int weno_t, int z_masks, int lo_l, int hi_l, int lo_r,
                  int hi_r, double eps_m, double eps_t, double dx, double dy,
                  double dz, int w_top, const void* zs, int tables,
                  void* stream) {
  TendencyArgs<T> A;
  if (!set_advection(A.adv, psi, nf, nx, ny, nz, hx, hy, hz, weno_m, weno_t,
                     z_masks, lo_l, hi_l, lo_r, hi_r, eps_m, eps_t, dx, dy, dz))
    return (int)cudaErrorInvalidValue;
  for (int f = 0; f < MAX_FIELDS; ++f)
    A.out[f] = f < nf ? static_cast<T*>(out[f]) : nullptr;
  A.w_top = w_top;
  A.adv.zs = static_cast<const T*>(zs);
  A.adv.tables = tables;
  if (nx <= 0 || ny <= 0 || nz <= 0) return 0;
  int smem;
  const dim3 blocks = plan_tiles(A.adv, smem);
  return zs != nullptr ? launch_kernel<T, true>(A, blocks, smem, stream)
                       : launch_kernel<T, false>(A, blocks, smem, stream);
}

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). `psi` and
// `out` are host arrays of nf device pointers; `w_top` (bounded z) also
// writes G_w at w's top wall face; `zs` (a stretched z, else null) are the
// z rows of ops/metric_rows.py, with WENO5's to-faces and to-centres tables
// where `tables`.
int fused_advective_tendencies_f32(const void* const* psi, void* const* out,
                                   int nf, int nx, int ny, int nz, int hx,
                                   int hy, int hz, int weno_m, int weno_t,
                                   int z_masks, int lo_l, int hi_l, int lo_r,
                                   int hi_r, double eps_m, double eps_t,
                                   double dx, double dy, double dz,
                                   int w_top, const void* zs, int tables,
                                   void* stream) {
  return launch<float>(psi, out, nf, nx, ny, nz, hx, hy, hz, weno_m, weno_t,
                       z_masks, lo_l, hi_l, lo_r, hi_r, eps_m, eps_t, dx, dy,
                       dz, w_top, zs, tables, stream);
}

int fused_advective_tendencies_f64(const void* const* psi, void* const* out,
                                   int nf, int nx, int ny, int nz, int hx,
                                   int hy, int hz, int weno_m, int weno_t,
                                   int z_masks, int lo_l, int hi_l, int lo_r,
                                   int hi_r, double eps_m, double eps_t,
                                   double dx, double dy, double dz,
                                   int w_top, const void* zs, int tables,
                                   void* stream) {
  return launch<double>(psi, out, nf, nx, ny, nz, hx, hy, hz, weno_m, weno_t,
                        z_masks, lo_l, hi_l, lo_r, hi_r, eps_m, eps_t, dx, dy,
                        dz, w_top, zs, tables, stream);
}

}  // extern "C"
