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
#include <cuda_runtime.h>

#include "weno5_advection.cuh"

template <typename T>
struct TendencyArgs {
  Advection<T> adv;
  T* out[MAX_FIELDS];  // with-halo G: interior written, halos zero
  int w_top;           // bounded z: also G_w at the top wall face
};

// div_vw at w's top wall face, offset o (with-halo z index K = hz+nz),
// from global memory. Both z fluxes are centred there: WENO5's near-wall
// reduction falls back to the centred mean, as does the centred scheme.
// The centre above the face is z index hz+nz+1, which wraps to 0 when
// hz == 1, as torch.roll wraps it in the plain version.
template <typename T>
__device__ __forceinline__ T div_vw_top(const Advection<T>& A, int64_t o,
                                        int64_t sx, int64_t sy, int K) {
  const T* __restrict__ u = A.psi[0];
  const T* __restrict__ v = A.psi[1];
  const T* __restrict__ w = A.psi[2];
  const int64_t sz = 1;
  const int64_t up = K + 1 < A.nz + 2 * A.hz ? sz : -(int64_t)K;
  const bool we = A.weno_m != 0;
  const T eps = A.eps_m, half = T(0.5);
  const T Ax = A.dy * A.dz, Ay = A.dx * A.dz, Az = A.dx * A.dy;
  const Bounds nb{0, -1, 0, -1};
  const T fxR = Ax * transport_axis(w, o + sx, sx, half * (u[o + sx] + u[o + sx - sz]), we, eps, false, nb, 0);
  const T fxL = Ax * transport_axis(w, o, sx, half * (u[o] + u[o - sz]), we, eps, false, nb, 0);
  const T fyR = Ay * transport_axis(w, o + sy, sy, half * (v[o + sy] + v[o + sy - sz]), we, eps, false, nb, 0);
  const T fyL = Ay * transport_axis(w, o, sy, half * (v[o] + v[o - sz]), we, eps, false, nb, 0);
  const T wR = half * (w[o + up] + w[o]), wL = half * (w[o] + w[o - sz]);
  const T fzR = Az * (wR * wR);
  const T fzL = Az * (wL * wL);
  return flux_divergence(fxR, fxL, fyR, fyL, fzR, fzL, A);
}

// K2's use of advect_tile: G = -div into the with-halo outputs
template <typename T>
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
        A.out[2][o] = -div_vw_top(D, o, t.gsx, t.gsy, top);
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

template <typename T>
__global__ void __launch_bounds__(AT_THREADS, 1)
fused_advective_tendencies_kernel(const __grid_constant__ TendencyArgs<T> A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  advect_tile(A.adv, reinterpret_cast<T*>(smem_raw), TendencyOut<T>{A});
}

template <typename T>
static int launch(const void* const* psi, void* const* out, int nf, int nx,
                  int ny, int nz, int hx, int hy, int hz, int weno_m,
                  int weno_t, int z_masks, int lo_l, int hi_l, int lo_r,
                  int hi_r, double eps_m, double eps_t, double dx, double dy,
                  double dz, int w_top, void* stream) {
  TendencyArgs<T> A;
  if (!set_advection(A.adv, psi, nf, nx, ny, nz, hx, hy, hz, weno_m, weno_t,
                     z_masks, lo_l, hi_l, lo_r, hi_r, eps_m, eps_t, dx, dy, dz))
    return (int)cudaErrorInvalidValue;
  for (int f = 0; f < MAX_FIELDS; ++f)
    A.out[f] = f < nf ? static_cast<T*>(out[f]) : nullptr;
  A.w_top = w_top;
  if (nx <= 0 || ny <= 0 || nz <= 0) return 0;
  int smem;
  const dim3 blocks = plan_tiles(A.adv, smem);
  auto kernel = fused_advective_tendencies_kernel<T>;
  const int rc = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != 0) return rc;
  kernel<<<blocks, AT_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(A);
  return (int)cudaGetLastError();
}

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). `psi` and
// `out` are host arrays of nf device pointers; `w_top` (bounded z) also
// writes G_w at w's top wall face.
int fused_advective_tendencies_f32(const void* const* psi, void* const* out,
                                   int nf, int nx, int ny, int nz, int hx,
                                   int hy, int hz, int weno_m, int weno_t,
                                   int z_masks, int lo_l, int hi_l, int lo_r,
                                   int hi_r, double eps_m, double eps_t,
                                   double dx, double dy, double dz,
                                   int w_top, void* stream) {
  return launch<float>(psi, out, nf, nx, ny, nz, hx, hy, hz, weno_m, weno_t,
                       z_masks, lo_l, hi_l, lo_r, hi_r, eps_m, eps_t, dx, dy,
                       dz, w_top, stream);
}

int fused_advective_tendencies_f64(const void* const* psi, void* const* out,
                                   int nf, int nx, int ny, int nz, int hx,
                                   int hy, int hz, int weno_m, int weno_t,
                                   int z_masks, int lo_l, int hi_l, int lo_r,
                                   int hi_r, double eps_m, double eps_t,
                                   double dx, double dy, double dz,
                                   int w_top, void* stream) {
  return launch<double>(psi, out, nf, nx, ny, nz, hx, hy, hz, weno_m, weno_t,
                        z_masks, lo_l, hi_l, lo_r, hi_r, eps_m, eps_t, dx, dy,
                        dz, w_top, stream);
}

}  // extern "C"
