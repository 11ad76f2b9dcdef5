// Halo fills of several fields in one launch (K6): for each with-halo field
// the values that boundary_conditions/bcs.py::fill_halos writes, axis after
// axis (periodic axes first), into its halo points, in place:
//
//   periodic side:              copy of the wrapped interior point;
//   bounded side, centred:      zero-gradient mirror (flux, open) or
//                               2b - mirror (value b);
//   bounded side, face-located: mirror about the wall face (flux), or b on
//                               the wall face and 2b - mirror beyond it
//                               (open, value b).
//
// Each axis' fill reads only points that the axes before it have filled, so
// the value a sequence of fills leaves at a halo point is the value at one
// source point (each axis' index wrapped or mirrored into the interior),
// passed through the operations of the axes whose halo holds the point, in
// the fill order: a copy, 2b - x, or the constant b. One thread per written
// point computes that; it reads the source from the field as it was, since
// with at least H + 1 cells on a bounded axis (H on a periodic one) no
// source is a written point. The arithmetic is the plain version's (2b - x
// in the field's type), so the two are bitwise equal.
//
// Replaces the TPU kernel clima_oceananigans_jl_tpu/ops/fused_fill.py::
// fill_periodic_axis_inplace, the in-place strip copy of one periodic axis
// of one field, which the JAX hydrostatic model runs for the periodic x
// axis of its (x, z, y) state (its bounded axes stay XLA slab updates).
// Here one launch fills every axis of every field given: the hydrostatic
// model's u, v, tracers and eta before K4a, then w and pHY' after it.
//
// What bounds it on an H100: memory. At the 1/4 degree flagship
// (1446 x 606 x 30 with halos, fp32) a 3D field has about 5.5 M halo points,
// 5.2 M of them in its z halos; u, v, T, S, b and eta (27.8 M halo points)
// move 0.22 GB (each halo point written once, each source read once),
// 0.065 ms at 3.35 TB/s. The z halos are three values at each end of a
// 30-value column, so a 32-byte sector carries few useful bytes.
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_FILL_FIELDS 16

// how one side of an axis is filled
enum { KEEP = 0, WRAP, MIRROR_C, MIRROR_F };
// what an axis does to the value of one point: keep it, 2b - x, or b
enum { COPY = 0, REFLECT, WALL };

// One axis of one field: written indices are [0, lo) and [hi, S).
struct FillAxis {
  int S, N, H, lo, hi;
  int kind[2], value[2];  // per side: KEEP..MIRROR_F; 1 for a value b
};

template <typename T>
struct FillArgs {
  T* data[MAX_FILL_FIELDS];
  FillAxis ax[MAX_FILL_FIELDS][3];
  T b[MAX_FILL_FIELDS][3][2];
  int order[MAX_FILL_FIELDS][3];       // the axes in fill order
  int64_t start[MAX_FILL_FIELDS + 1];  // first thread of each field
  int nf;
};

__device__ __forceinline__ int clampi(int i, int lo, int hi) {
  return i < lo ? lo : (i > hi ? hi : i);
}

// The n-th written index of an axis.
__device__ __forceinline__ int written(const FillAxis& a, int64_t n) {
  return n < a.lo ? (int)n : a.hi + (int)(n - a.lo);
}

// Index i's source index along axis a, its operation and its side.
__device__ __forceinline__ void rule(const FillAxis& a, int i, int& s, int& op,
                                     int& side) {
  s = i;
  op = COPY;
  side = i < a.lo ? 0 : 1;
  if (i >= a.lo && i < a.hi) return;
  const int N = a.N, H = a.H, kind = a.kind[side];
  if (kind == WRAP) {
    s = side == 0 ? i + N : i - N;
    return;
  }
  if (kind == MIRROR_C) {
    s = clampi(side == 0 ? 2 * H - 1 - i : 2 * (H + N) - 1 - i, H, H + N - 1);
  } else {  // MIRROR_F, about the wall face
    const int face = side == 0 ? H : H + N;
    if (i == face) {
      op = WALL;
      return;
    }
    s = clampi(2 * face - i, H, H + N);
  }
  if (a.value[side]) op = REFLECT;
}

template <typename T>
__global__ void __launch_bounds__(256) fill_halos_kernel(const FillArgs<T> A) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= A.start[A.nf]) return;
  int f = 0;
  while (t >= A.start[f + 1]) ++f;
  const FillAxis* ax = A.ax[f];
  const FillAxis &X = ax[0], &Y = ax[1], &Z = ax[2];
  // the written points: x halos (any y, z), then y halos (x kept, any z),
  // then z halos (x and y kept)
  const int64_t wx = X.lo + (X.S - X.hi), wy = Y.lo + (Y.S - Y.hi);
  const int64_t wz = Z.lo + (Z.S - Z.hi);
  const int64_t cx = X.hi - X.lo, cy = Y.hi - Y.lo;
  const int64_t yz = (int64_t)Y.S * Z.S;
  int64_t r = t - A.start[f];
  int c[3];
  if (r < wx * yz) {
    c[0] = written(X, r / yz);
    c[1] = (int)((r % yz) / Z.S);
    c[2] = (int)(r % Z.S);
  } else if ((r -= wx * yz) < cx * wy * Z.S) {
    c[0] = X.lo + (int)(r / (wy * Z.S));
    r %= wy * Z.S;
    c[1] = written(Y, r / Z.S);
    c[2] = (int)(r % Z.S);
  } else {
    r -= cx * wy * Z.S;
    c[0] = X.lo + (int)(r / (cy * wz));
    r %= cy * wz;
    c[1] = Y.lo + (int)(r / wz);
    c[2] = written(Z, r % wz);
  }
  int s[3], op[3], side[3];
  for (int a = 0; a < 3; ++a) rule(ax[a], c[a], s[a], op[a], side[a]);
  // a wall face's b replaces what the axes before it in the fill order did
  int first = 0;
  for (int n = 0; n < 3; ++n)
    if (op[A.order[f][n]] == WALL) first = n;
  const int a0 = A.order[f][first];
  T x = op[a0] == WALL ? A.b[f][a0][side[a0]]
                       : A.data[f][((int64_t)s[0] * Y.S + s[1]) * Z.S + s[2]];
  for (int n = op[a0] == WALL ? first + 1 : 0; n < 3; ++n) {
    const int a = A.order[f][n];
    if (op[a] == REFLECT) x = T(2) * A.b[f][a][side[a]] - x;
  }
  A.data[f][((int64_t)c[0] * Y.S + c[1]) * Z.S + c[2]] = x;
}

template <typename T>
static int launch(void* const* data, const int* ints, const double* bs, int nf,
                  void* stream) {
  static_assert(sizeof(FillArgs<T>) <= 4096, "kernel parameters over 4 KB");
  if (nf < 1 || nf > MAX_FILL_FIELDS) return (int)cudaErrorInvalidValue;
  FillArgs<T> A = {};
  A.nf = nf;
  A.start[0] = 0;
  for (int f = 0; f < nf; ++f) {
    A.data[f] = static_cast<T*>(data[f]);
    const int* q = ints + 30 * f;  // per axis S, N, H, lo, hi, kinds, values
    for (int a = 0; a < 3; ++a, q += 9) {
      A.ax[f][a] = FillAxis{q[0], q[1], q[2], q[3], q[4], {q[5], q[6]}, {q[7], q[8]}};
      A.b[f][a][0] = T(bs[6 * f + 2 * a]);
      A.b[f][a][1] = T(bs[6 * f + 2 * a + 1]);
    }
    for (int n = 0; n < 3; ++n) A.order[f][n] = q[n];
    const FillAxis &X = A.ax[f][0], &Y = A.ax[f][1], &Z = A.ax[f][2];
    const int64_t wx = X.lo + (X.S - X.hi), wy = Y.lo + (Y.S - Y.hi);
    const int64_t wz = Z.lo + (Z.S - Z.hi);
    const int64_t cx = X.hi - X.lo, cy = Y.hi - Y.lo;
    A.start[f + 1] = A.start[f] + wx * Y.S * Z.S + cx * wy * Z.S + cx * cy * wz;
  }
  const int64_t n = A.start[nf];
  if (n == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  fill_halos_kernel<T><<<(unsigned int)blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(A);
  return (int)cudaGetLastError();
}

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). `data` is a
// host array of nf distinct device pointers, each a contiguous (X, Y, Z)
// field; `ints` holds 30 ints per field (for x, y, z: S, N, H, lo, hi,
// kind of side 0 and 1, value flag of side 0 and 1; then the fill order),
// `bs` 6 doubles per field (b of side 0 and 1 for x, y, z).
#define FILL_HALOS(NAME, T)                                              \
  int NAME(void* const* data, const int* ints, const double* bs, int nf, \
           void* stream) {                                               \
    return launch<T>(data, ints, bs, nf, stream);                        \
  }

FILL_HALOS(fill_halos_f32, float)
FILL_HALOS(fill_halos_f64, double)

}  // extern "C"
