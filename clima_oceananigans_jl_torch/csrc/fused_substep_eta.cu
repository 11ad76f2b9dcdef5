// The split-explicit barotropic substeps (K5), one launch per half-substep.
// Substep i of ops/fused_barotropic.py::fused_substep_eta_reference:
//
//   half 0:  U' = fill(U + dtau (((-g) Hfc) dxf(eta) / dxu + GU)), V' likewise;
//            U_av += wv[i] U',  V_av += wv[i] V'
//   half 1:  eta' = eta - (dtau (dxc(dyu U') + dyc(dxv V'))) / az;
//            eta_av += wf[i] eta'
//
// on with-halo (X, Y) arrays, y contiguous. One thread per with-halo point:
// a halo point takes its value through the fill rule of its location (the
// periodic wrap, the zero-gradient mirror of a centred field, or the
// impenetrable wall of a face field: zero on the wall face, the negated
// mirror beyond it) applied to the update at its source point, so no
// separate fill runs and the outputs are the plain version's filled arrays.
// eta's halos (and eta_av's) hold the values at their mirror points, which
// is what the plain version's fills write there. Metrics are x-constant rows
// over with-halo y (ops/metric_rows.py::y_row): dxu, dyv, dyu, dxv, az, Hfc,
// Hcf. Build with --fmad=false so the compiler forms no FMA that eager
// PyTorch does not.
//
// Replaces the TPU kernel clima_oceananigans_jl_tpu/ops/fused_barotropic.py::
// fused_substep_eta, which keeps all N substeps VMEM-resident in one call.
// Blocks of a CUDA kernel cannot wait for one another, so each half-substep
// is a launch of its own (2N launches); the halo rule makes each launch
// complete on its own.
//
// What bounds it on an H100: memory, and launch latency at small sizes. At
// the 1/4 degree flagship (1446 x 606, fp32, 3.5 MB an array) one substep
// reads eta, U, V, GU, GV and the three averages and writes U, V, eta and
// the averages: about 14 arrays, 49 MB, so 30 substeps move about 1.5 GB
// if nothing stays in the 50 MB L2 (0.44 ms at 3.35 TB/s); most of it can.
// A persistent kernel with a grid-wide barrier between the halves would save
// the launches; that is later work.
#include <cuda_runtime.h>
#include <stdint.h>

enum { DXU = 0, DYV = 1, DYU = 2, DXV = 3, AZ = 4, HFC = 5, HCF = 6 };

// The fill rule along one axis: the source index of a point and its factor
// (1 a copy, -1 the negated mirror of an impenetrable wall, 0 the wall face).
struct Src {
  int i, f;
};

__device__ __forceinline__ int clampi(int i, int lo, int hi) {
  return i < lo ? lo : (i > hi ? hi : i);
}

__device__ __forceinline__ Src source(int I, int N, int H, int bounded, bool face) {
  if (!bounded) {  // periodic
    if (I < H) return {I + N, 1};
    if (I >= H + N) return {I - N, 1};
    return {I, 1};
  }
  if (!face) {  // zero-gradient mirror
    if (I < H) return {clampi(2 * H - 1 - I, H, H + N - 1), 1};
    if (I >= H + N) return {clampi(2 * (H + N) - 1 - I, H, H + N - 1), 1};
    return {I, 1};
  }
  if (I == H || I == H + N) return {I, 0};  // impenetrable wall face
  if (I < H) return {clampi(2 * H - I, H, H + N), -1};
  if (I > H + N) return {clampi(2 * (H + N) - I, H, H + N), -1};
  return {I, 1};
}

template <typename T>
struct SubstepArgs {
  const T* rows;
  const T* eta_in;
  T* eta_out;
  const T* U_in;
  T* U_out;
  const T* V_in;
  T* V_out;
  const T* GU;
  const T* GV;
  T* eta_av;
  T* U_av;
  T* V_av;
  const T* wv;
  const T* wf;
  int half, i, nx, ny, hx, hy, xb, yb;
  T neg_g, dtau;
};

// 2.0*0 - x of the plain version's wall fill
template <typename T>
__device__ __forceinline__ T apply(T x, int f) {
  return f == 0 ? T(0) : (f < 0 ? T(0) - x : x);
}

template <typename T>
__global__ void __launch_bounds__(256) fused_substep_eta_kernel(const SubstepArgs<T> A) {
  const int X = A.nx + 2 * A.hx, Y = A.ny + 2 * A.hy;
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (int64_t)X * Y) return;
  const int I = (int)(p / Y), J = (int)(p % Y);
  const int64_t sx = Y;
  const T* r = A.rows;
  if (A.half == 0) {
    // U at (F, C)
    const Src ux = source(I, A.nx, A.hx, A.xb, true), uy = source(J, A.ny, A.hy, A.yb, false);
    T U = T(0);
    if (ux.f != 0 && uy.f != 0) {
      const int64_t o = ux.i * sx + uy.i;
      const T* Hfc = r + HFC * Y;
      const T* dxu = r + DXU * Y;
      U = A.U_in[o] + A.dtau * ((A.neg_g * Hfc[uy.i] * (A.eta_in[o] - A.eta_in[o - sx]))
                                / dxu[uy.i] + A.GU[o]);
      U = apply(apply(U, ux.f), uy.f);
    }
    // V at (C, F)
    const Src vx = source(I, A.nx, A.hx, A.xb, false), vy = source(J, A.ny, A.hy, A.yb, true);
    T V = T(0);
    if (vx.f != 0 && vy.f != 0) {
      const int64_t o = vx.i * sx + vy.i;
      const T* Hcf = r + HCF * Y;
      const T* dyv = r + DYV * Y;
      V = A.V_in[o] + A.dtau * ((A.neg_g * Hcf[vy.i] * (A.eta_in[o] - A.eta_in[o - 1]))
                                / dyv[vy.i] + A.GV[o]);
      V = apply(apply(V, vx.f), vy.f);
    }
    A.U_out[p] = U;
    A.V_out[p] = V;
    A.U_av[p] = A.U_av[p] + A.wv[A.i] * U;
    A.V_av[p] = A.V_av[p] + A.wv[A.i] * V;
    return;
  }
  // eta at (C, C), from the filled U' and V' (U_out, V_out)
  const Src ex = source(I, A.nx, A.hx, A.xb, false), ey = source(J, A.ny, A.hy, A.yb, false);
  const int64_t o = ex.i * sx + ey.i;
  const int j = ey.i;
  const T* dyu = r + DYU * Y;
  const T* dxv = r + DXV * Y;
  const T* az = r + AZ * Y;
  const T* U = A.U_out;
  const T* V = A.V_out;
  const T div = (dyu[j] * U[o + sx] - dyu[j] * U[o]) + (dxv[j + 1] * V[o + 1] - dxv[j] * V[o]);
  const T eta = A.eta_in[o] - (A.dtau * div) / az[j];
  A.eta_out[p] = eta;
  A.eta_av[p] = A.eta_av[p] + A.wf[A.i] * eta;
}

template <typename T>
static int launch(const void* rows, const void* eta_in, void* eta_out,
                  const void* U_in, void* U_out, const void* V_in, void* V_out,
                  const void* GU, const void* GV, void* eta_av, void* U_av,
                  void* V_av, const void* wv, const void* wf, int half, int i,
                  int nx, int ny, int hx, int hy, int xb, int yb, double g,
                  double dtau, void* stream) {
  SubstepArgs<T> A;
  A.rows = static_cast<const T*>(rows);
  A.eta_in = static_cast<const T*>(eta_in);
  A.eta_out = static_cast<T*>(eta_out);
  A.U_in = static_cast<const T*>(U_in);
  A.U_out = static_cast<T*>(U_out);
  A.V_in = static_cast<const T*>(V_in);
  A.V_out = static_cast<T*>(V_out);
  A.GU = static_cast<const T*>(GU);
  A.GV = static_cast<const T*>(GV);
  A.eta_av = static_cast<T*>(eta_av);
  A.U_av = static_cast<T*>(U_av);
  A.V_av = static_cast<T*>(V_av);
  A.wv = static_cast<const T*>(wv);
  A.wf = static_cast<const T*>(wf);
  A.half = half; A.i = i;
  A.nx = nx; A.ny = ny; A.hx = hx; A.hy = hy; A.xb = xb; A.yb = yb;
  A.neg_g = T(-g);
  A.dtau = T(dtau);
  const int64_t n = (int64_t)(nx + 2 * hx) * (ny + 2 * hy);
  if (n == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  fused_substep_eta_kernel<T><<<(unsigned int)blocks, threads, 0,
                                static_cast<cudaStream_t>(stream)>>>(A);
  return (int)cudaGetLastError();
}

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). All pointers
// are device pointers: `rows` the (7, Y) metric rows, the rest with-halo
// (X, Y) arrays and the (n,) weight vectors wv, wf. `half` 0 updates U, V
// (and U_av, V_av), 1 updates eta (and eta_av) from U_out, V_out.
#define FUSED_SUBSTEP_ETA(NAME, T)                                            \
  int NAME(const void* rows, const void* eta_in, void* eta_out,               \
           const void* U_in, void* U_out, const void* V_in, void* V_out,      \
           const void* GU, const void* GV, void* eta_av, void* U_av,          \
           void* V_av, const void* wv, const void* wf, int half, int i,       \
           int nx, int ny, int hx, int hy, int xb, int yb, double g,          \
           double dtau, void* stream) {                                       \
    return launch<T>(rows, eta_in, eta_out, U_in, U_out, V_in, V_out, GU, GV, \
                     eta_av, U_av, V_av, wv, wf, half, i, nx, ny, hx, hy, xb, \
                     yb, g, dtau, stream);                                    \
  }

FUSED_SUBSTEP_ETA(fused_substep_eta_f32, float)
FUSED_SUBSTEP_ETA(fused_substep_eta_f64, double)

}  // extern "C"
