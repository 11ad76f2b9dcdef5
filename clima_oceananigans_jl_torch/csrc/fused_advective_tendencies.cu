// K2, the fused advective tendencies of the nonhydrostatic model: its
// first-code instantiations (centred, WENO5 and UB5 for momentum and
// tracers; regular or stretched z, the Flat layout, x/y near-wall bounds,
// immersed or not; 32 kernels). The kernel, its design and its bound are
// in fused_advective_tendencies.cuh; the ANY instantiations (every scheme)
// and the bf16 sub-form build from fused_advective_tendencies_any.cu, a
// library of their own, at the same time as this one.
//
// Replaces the TPU kernel clima_oceananigans_jl_tpu/ops/fused_tendencies.py::
// fused_advective_tendencies (with fused_advective_tendencies_any.cu).
#include "fused_advective_tendencies.cuh"

template <typename T>
static int launch(const void* const* psi, void* const* out, const int* ia,
                                   const double* da, int walls, const void* zs, int tables,
                                   const void* const* clear, void* stream) {
  TendencyArgs<T> A;
  bool flat, xy;
  if (!set_tendency_args(A, psi, out, ia, da, walls, zs, tables, clear, flat, xy))
    return (int)cudaErrorInvalidValue;
  if (A.adv.nx <= 0 || A.adv.ny <= 0 || A.adv.nz <= 0) return 0;
  // a scheme of needs_any or a bf16 option: the ANY library's launch
  if (advection_bf16(A.adv) || advection_any(A.adv)) return (int)cudaErrorInvalidValue;
  return launch_form<T, false>(A, zs != nullptr, flat, xy, clear != nullptr, stream);
}

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). `psi` and
// `out` are host arrays of nf device pointers in the kernel's axis order;
// `ia` and `da` the shared arguments (set_advection; PositiveWENO5's bounds
// in `da`); bit a of `walls` writes G of velocity a at its wall face on
// bounded axis a; `zs` (a stretched z, else null) are the z rows of
// ops/metric_rows.py, with the WENO5 family's to-faces and to-centres
// tables where `tables`; `clear` (an immersed grid, else null) a host array
// of the four clear-flag tensors' device pointers (u, v, w in the kernel's
// order, then the tracers'; a null entry: that field reads none).
// A launch that needs the ANY instantiations returns cudaErrorInvalidValue.
int fused_advective_tendencies_f32(const void* const* psi, void* const* out, const int* ia,
                                   const double* da, int walls, const void* zs, int tables,
                                   const void* const* clear, void* stream) {
  return launch<float>(psi, out, ia, da, walls, zs, tables, clear, stream);
}

int fused_advective_tendencies_f64(const void* const* psi, void* const* out, const int* ia,
                                   const double* da, int walls, const void* zs, int tables,
                                   const void* const* clear, void* stream) {
  return launch<double>(psi, out, ia, da, walls, zs, tables, clear, stream);
}

}  // extern "C"
