// Halo fills of several fields in one launch (K6): for each with-halo field
// the values that boundary_conditions/bcs.py::fill_halos writes, axis after
// axis (periodic axes first), into its halo points, in place:
//
//   periodic side:              copy of the wrapped interior point;
//   bounded side, centred:      zero-gradient mirror (flux, open),
//                               2b - mirror (value b) or mirror - b*d
//                               (gradient b, d = cc[mirror] - cc[ghost]);
//   bounded side, face-located: mirror about the wall face (flux,
//                               gradient), or b on the wall face and
//                               2b - mirror beyond it (open, value b).
//
// A value b is a scalar of the launch's arguments or, for a plane array or
// a callable BC value, a with-halo plane that the wrapper evaluated on the
// card (a FillSide of the side table, with its strides); a gradient side's
// distances d, one per ghost, are in the side table too, computed on the
// host in the field's type from the grid's centre coordinates.
//
// Each axis' fill reads only points that the axes before it have filled, so
// the value a sequence of fills leaves at a halo point is the value at one
// source point (each axis' index wrapped or mirrored into the interior),
// passed through the operations of the axes whose halo holds the point, in
// the fill order: a copy, 2b - x, or the constant b. Each thread computes
// that for its points, reading the sources from the field as it was: with
// at least H + 1 cells on a bounded axis (H on a periodic one) no source is
// a written point, so the threads may run in any order. The arithmetic is
// the plain version's (2b - x and x - b*d in the field's type, the product
// rounded before the difference under --fmad=false), so the two are
// bitwise equal. When axis a's operation runs in fill_halos, the value it
// reads was written by the axes filled before a and not yet touched by
// those filled after it, and its plane b is indexed by that point's other
// coordinates: so K6 reads a plane at the destination's index on the axes
// filled before a and at the source's index on the axes filled after it
// (at a corner that decides whether b comes from the plane's halo).
//
// Replaces the TPU kernel clima_oceananigans_jl_tpu/ops/fused_fill.py::
// fill_periodic_axis_inplace, the in-place strip copy of one periodic axis
// of one field, which the JAX hydrostatic model runs for the periodic x
// axis of its (x, z, y) state (its bounded axes stay XLA slab updates).
// Here one launch fills every axis of every field given: the hydrostatic
// model's u, v, tracers and eta, then w and pHY'; the nonhydrostatic
// model's u, v, w and tracers, then pHY' or pNHS.
//
// The launch: blockIdx.y is the field, and its blocks along x run three
// passes shaped by the halo's geometry, each pass' points numbered in
// memory order:
//
//   x slabs  [0, bx):        the written x indices, every y and z: slabs
//                            of Y*Z contiguous values;
//   y runs   [bx, bx+by):    interior x, the written y indices, every z:
//                            runs of (written y) * Z contiguous values;
//   z halos  [bx+by, ...):   interior x and y, each column's written z
//                            indices, so a column's top halo and the next
//                            column's bottom halo (2H values) are
//                            consecutive points.
//
// A block of FILL_THREADS threads takes FILL_ITEMS * FILL_THREADS
// consecutive points of one pass, a thread every FILL_THREADS-th of them: a
// warp's loads and stores cover consecutive points, and a thread's
// FILL_ITEMS loads go out before its stores. Of the shapes timed (128 to
// 512 threads, 1 to 8 points a thread), 256 x 4 was among the fastest at
// 1/4 degree and at 256^3 (PERF.md). Index math is
// 32-bit from blockIdx/threadIdx, the divisions by a run-time extent a
// multiply and a shift (FastDiv); a pass holds fewer than 2^31 points (the
// launcher refuses more).
//
// What bounds it on an H100: memory, at the granularity the memory moves.
// At the 1/4 degree flagship (1446 x 606 x 30 with halos, fp32) a 3D field
// has about 5.5 M halo points, 5.2 M of them in its z halos; u, v, T, S, b
// and eta (27.8 M halo points) need 0.22 GB (each halo point written once,
// each source read once), 0.065 ms at 3.35 TB/s. But the z halos are three
// values at each end of a 30-value column: the fill reads 47% and writes
// 59% of the fields' 32-byte L2 sectors (0.56 GB, 0.17 ms), and 73% and 85%
// of their 64-byte DRAM blocks (0.84 GB, 0.25 ms; chip_smoke.py prints the
// counts). This kernel takes ~0.29 ms there. What the card charges beyond
// that is sector transactions: a thread per column (its 2H loads, then its
// stores) made each warp instruction touch 32 sectors and took 0.60 ms; the
// earlier kernel, a thread per halo point from a flat 64-bit index (a
// search of the fields and 64-bit divisions a thread), 0.38 ms.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tiles.cuh"

#define MAX_FILL_FIELDS 16
// the most halo cells of a gradient side
#define MAX_FILL_HALO 8

// K6's block: threads, and points a thread
constexpr int FILL_THREADS = 256, FILL_ITEMS = 4;

// how one side of an axis is filled
enum { KEEP = 0, WRAP, MIRROR_C, MIRROR_F };
// what a side's value does: nothing, a value BC's b, a gradient BC's b
enum { NO_VALUE = 0, VALUE, GRADIENT };
// what an axis does to the value of one point: keep it, 2b - x, b, x - b*d
enum { COPY = 0, REFLECT, WALL, SHIFT };

// One axis of one field: written indices are [0, lo) and [hi, S).
struct FillAxis {
  int S, N, H, lo, hi;
  int kind[2], value[2];  // per side: KEEP..MIRROR_F; NO_VALUE..GRADIENT
};

// One (field, axis, side) of a group's side table, in device memory: a
// plane of b (0: the scalar of FillArgs::b) with its strides over (x, y,
// z), the one along the filled axis 0, and a gradient side's distances,
// one per ghost in index order.
struct FillSide {
  long long plane;
  long long st[3];
  double dist[MAX_FILL_HALO];
};

// One field: its axes, fill order and the blocks of its three passes, with
// the divisors of their index math.
struct FillField {
  FillAxis ax[3];
  int order[3];  // the axes in fill order
  int bx, by, bz;
  FastDiv yz, z, wyz, cy, wz;  // Y*Z, Z, (written y)*Z, interior y, written z
};

template <typename T>
struct FillArgs {
  T* data[MAX_FILL_FIELDS];
  FillField f[MAX_FILL_FIELDS];
  T b[MAX_FILL_FIELDS][3][2];
  int nf;
  const FillSide* side;  // [nf][3][2], or null: scalar values, no gradients
};

__device__ __forceinline__ int clampi(int i, int lo, int hi) {
  return i < lo ? lo : (i > hi ? hi : i);
}

__device__ __forceinline__ int pick(int a, int v0, int v1, int v2) {
  return a == 0 ? v0 : (a == 1 ? v1 : v2);
}

// The n-th written index of an axis.
__device__ __forceinline__ int written(const FillAxis& a, int n) {
  return n < a.lo ? n : a.hi + (n - a.lo);
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
  if (a.value[side] == VALUE) op = REFLECT;
  else if (a.value[side] == GRADIENT) op = SHIFT;
}

// Index i's rule along an axis that pass PASS may find in its halo (the x
// slabs any axis, the y runs y and z, the z halos only z); on the others
// the index is kept.
template <int PASS>
__device__ __forceinline__ void rule_in(const FillAxis& a, int axis, int i,
                                        int& s, int& op, int& side) {
  if (axis < PASS) {
    s = i;
    op = COPY;
    side = 0;
  } else {
    rule(a, i, s, op, side);
  }
}

// The b of side `side` of axis a of field f at the plane coordinates
// (c0, c1, c2) (the filled axis' one has stride 0); the side table is
// there.
template <typename T>
__device__ __forceinline__ T side_value(const FillArgs<T>& A, int f, int a,
                                        int side, int c0, int c1, int c2) {
  const FillSide& q = A.side[(f * 3 + a) * 2 + side];
  if (q.plane != 0)
    return reinterpret_cast<const T*>(q.plane)[c0 * q.st[0] + c1 * q.st[1] +
                                               c2 * q.st[2]];
  return A.b[f][a][side];
}

// A gradient side's distance for halo index i along axis a of field f.
template <typename T>
__device__ __forceinline__ T side_distance(const FillArgs<T>& A, int f, int a,
                                           int side, int i) {
  const FillAxis& X = A.f[f].ax[a];
  return T(A.side[(f * 3 + a) * 2 + side].dist[side == 0 ? i : i - (X.H + X.N)]);
}

// One halo point (x, y, z) of field f of pass PASS, through every axis'
// rule in fill order: with LOAD, v becomes its source value (or the b of
// the wall face that replaces it); without, v goes through the remaining
// operations and is stored. The rules are cheap, so the two halves compute
// them each. Without a side table (SIDE false) every b is a scalar and no
// side is a gradient; with one, (c0, c1, c2) are the coordinates at which
// the axis in hand reads its plane: the destination's on the axes filled
// before it, the source's on the others.
template <bool SIDE, int PASS, bool LOAD, typename T>
__device__ __forceinline__ void fill_point(const FillArgs<T>& A, int f, int x,
                                           int y, int z, T& v) {
  const FillField& F = A.f[f];
  const int Y = F.ax[1].S, Z = F.ax[2].S;
  int s0, s1, s2, o0, o1, o2, e0, e1, e2;
  rule_in<PASS>(F.ax[0], 0, x, s0, o0, e0);
  rule_in<PASS>(F.ax[1], 1, y, s1, o1, e1);
  rule_in<PASS>(F.ax[2], 2, z, s2, o2, e2);
  // a wall face's b replaces what the axes before it in the fill order did
  int first = 0;
#pragma unroll
  for (int n = 0; n < 3; ++n)
    if (pick(F.order[n], o0, o1, o2) == WALL) first = n;
  const int a0 = F.order[first];
  const bool wall = pick(a0, o0, o1, o2) == WALL;
  T* const d = A.data[f];
  if (!SIDE) {
    if (LOAD) {
      v = wall ? A.b[f][a0][pick(a0, e0, e1, e2)]
               : d[((int64_t)s0 * Y + s1) * Z + s2];
      return;
    }
#pragma unroll
    for (int n = 0; n < 3; ++n) {
      const int a = F.order[n];
      if ((!wall || n > first) && pick(a, o0, o1, o2) == REFLECT)
        v = T(2) * A.b[f][a][pick(a, e0, e1, e2)] - v;
    }
    d[((int64_t)x * Y + y) * Z + z] = v;
    return;
  }
  if (LOAD && !wall) {
    v = d[((int64_t)s0 * Y + s1) * Z + s2];
    return;
  }
  int c0 = s0, c1 = s1, c2 = s2;
#pragma unroll
  for (int n = 0; n < 3; ++n) {
    const int a = F.order[n];
    if (LOAD) {
      if (n == first) {
        v = side_value(A, f, a, pick(a, e0, e1, e2), c0, c1, c2);
        return;
      }
    } else if (!wall || n > first) {
      const int op = pick(a, o0, o1, o2), side = pick(a, e0, e1, e2);
      if (op == REFLECT)
        v = T(2) * side_value(A, f, a, side, c0, c1, c2) - v;
      else if (op == SHIFT)
        v = v - side_value(A, f, a, side, c0, c1, c2) *
                    side_distance(A, f, a, side, pick(a, x, y, z));
    }
    // the axes after this one read its destination coordinate
    if (a == 0) c0 = x;
    else if (a == 1) c1 = y;
    else c2 = z;
  }
  if (!LOAD) d[((int64_t)x * Y + y) * Z + z] = v;
}

// The r-th point of pass PASS of field F (0: x slabs, 1: y runs, 2: z
// halos), each pass' points numbered in memory order; false past its end.
template <int PASS>
__device__ __forceinline__ bool pass_point(const FillField& F, int r, int& x,
                                           int& y, int& z) {
  const FillAxis &X = F.ax[0], &Y = F.ax[1], &Z = F.ax[2];
  if (PASS == 0) {  // a written x index, every y and z
    const int n = F.yz.div(r);
    if (n >= X.lo + (X.S - X.hi)) return false;
    const int q = r - n * (int)F.yz.d;
    y = F.z.div(q);
    z = q - y * Z.S;
    x = written(X, n);
  } else if (PASS == 1) {  // interior x, the written y indices, every z
    const int i = F.wyz.div(r);
    if (i >= X.hi - X.lo) return false;
    const int q = r - i * (int)F.wyz.d;
    const int n = F.z.div(q);
    x = X.lo + i;
    y = written(Y, n);
    z = q - n * Z.S;
  } else {  // interior x and y, each column's written z indices
    const int c = F.wz.div(r);
    const int i = F.cy.div(c);
    if (i >= X.hi - X.lo) return false;
    x = X.lo + i;
    y = Y.lo + (c - i * (int)F.cy.d);
    z = written(Z, r - c * (int)F.wz.d);
  }
  return true;
}

// A thread's FILL_ITEMS points of pass PASS, every FILL_THREADS-th from r0:
// the loads of all of them before any store.
template <bool SIDE, int PASS, typename T>
__device__ __forceinline__ void fill_items(const FillArgs<T>& A, int f, int r0) {
  const FillField& F = A.f[f];
  T v[FILL_ITEMS];
#pragma unroll
  for (int j = 0; j < FILL_ITEMS; ++j) {
    int x, y, z;
    if (pass_point<PASS>(F, r0 + j * FILL_THREADS, x, y, z))
      fill_point<SIDE, PASS, true>(A, f, x, y, z, v[j]);
  }
#pragma unroll
  for (int j = 0; j < FILL_ITEMS; ++j) {
    int x, y, z;
    if (pass_point<PASS>(F, r0 + j * FILL_THREADS, x, y, z))
      fill_point<SIDE, PASS, false>(A, f, x, y, z, v[j]);
  }
}

// A block fills FILL_ITEMS * FILL_THREADS consecutive points of one pass of
// one field; its thread takes every FILL_THREADS-th of them, so each load
// and store instruction of a warp covers consecutive points. SIDE: the
// group has a side table (planes or gradients); a group of scalar values
// runs the instantiation without it, whose code is that of the scalar
// fills alone.
template <typename T, bool SIDE>
__global__ void __launch_bounds__(FILL_THREADS)
    fill_halos_kernel(const __grid_constant__ FillArgs<T> A) {
  const int f = blockIdx.y;
  const FillField& F = A.f[f];
  const int r0 = (int)threadIdx.x;
  int b = blockIdx.x;
  if (b < F.bx) {
    fill_items<SIDE, 0>(A, f, b * FILL_ITEMS * FILL_THREADS + r0);
  } else if ((b -= F.bx) < F.by) {
    fill_items<SIDE, 1>(A, f, b * FILL_ITEMS * FILL_THREADS + r0);
  } else if ((b -= F.by) < F.bz) {
    fill_items<SIDE, 2>(A, f, b * FILL_ITEMS * FILL_THREADS + r0);
  }
}

template <typename T>
static int launch(void* const* data, const int* ints, const double* bs,
                  const void* side, int nf, void* stream) {
  static_assert(sizeof(FillArgs<T>) <= 4096, "kernel parameters over 4 KB");
  if (nf < 1 || nf > MAX_FILL_FIELDS) return (int)cudaErrorInvalidValue;
  FillArgs<T> A = {};
  A.nf = nf;
  A.side = static_cast<const FillSide*>(side);
  long long blocks = 0;
  for (int f = 0; f < nf; ++f) {
    A.data[f] = static_cast<T*>(data[f]);
    FillField& F = A.f[f];
    const int* q = ints + 30 * f;  // per axis S, N, H, lo, hi, kinds, values
    for (int a = 0; a < 3; ++a, q += 9) {
      F.ax[a] = FillAxis{q[0], q[1], q[2], q[3], q[4], {q[5], q[6]}, {q[7], q[8]}};
      for (int e = 0; e < 2; ++e)  // a gradient needs the table and its H
        if (q[7 + e] == GRADIENT && (side == nullptr || q[2] > MAX_FILL_HALO))
          return (int)cudaErrorInvalidValue;
      A.b[f][a][0] = T(bs[6 * f + 2 * a]);
      A.b[f][a][1] = T(bs[6 * f + 2 * a + 1]);
    }
    for (int n = 0; n < 3; ++n) F.order[n] = q[n];
    const FillAxis &X = F.ax[0], &Y = F.ax[1], &Z = F.ax[2];
    const long long wx = X.lo + (X.S - X.hi), wy = Y.lo + (Y.S - Y.hi),
                    wz = Z.lo + (Z.S - Z.hi), yz = (long long)Y.S * Z.S;
    // the points of the x slabs, the y runs and the z halos
    const long long points[3] = {wx * yz, (X.hi - X.lo) * wy * Z.S,
                                 (X.hi - X.lo) * (Y.hi - Y.lo) * wz};
    int* const pass_blocks[3] = {&F.bx, &F.by, &F.bz};
    // every pass's point index and divisor must stay below 2^31
    for (int n = 0; n < 3; ++n) {
      const long long per = FILL_THREADS * FILL_ITEMS,
                      b = (points[n] + per - 1) / per;
      if (b * per >= (1ll << 31)) return (int)cudaErrorInvalidValue;
      *pass_blocks[n] = (int)b;
    }
    if (yz >= (1ll << 31)) return (int)cudaErrorInvalidValue;
    F.yz = fast_div((unsigned)yz);
    F.z = fast_div((unsigned)Z.S);
    F.wyz = fast_div((unsigned)(wy * Z.S));
    F.cy = fast_div((unsigned)(Y.hi - Y.lo));
    F.wz = fast_div((unsigned)wz);
    const long long n = (long long)F.bx + F.by + F.bz;
    if (n > blocks) blocks = n;
  }
  if (blocks == 0) return 0;
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, nf);
  if (A.side != nullptr)
    fill_halos_kernel<T, true><<<grid, FILL_THREADS, 0,
                                 static_cast<cudaStream_t>(stream)>>>(A);
  else
    fill_halos_kernel<T, false><<<grid, FILL_THREADS, 0,
                                  static_cast<cudaStream_t>(stream)>>>(A);
  return (int)cudaGetLastError();
}

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). `data` is a
// host array of nf distinct device pointers, each a contiguous (X, Y, Z)
// field; `ints` holds 30 ints per field (for x, y, z: S, N, H, lo, hi,
// kind of side 0 and 1, value flag of side 0 and 1; then the fill order),
// `bs` 6 doubles per field (the scalar b of side 0 and 1 for x, y, z);
// `side` is null or the device address of the group's side table,
// nf x 3 x 2 FillSide records.
#define FILL_HALOS(NAME, T)                                               \
  int NAME(void* const* data, const int* ints, const double* bs,          \
           const void* side, int nf, void* stream) {                      \
    return launch<T>(data, ints, bs, side, nf, stream);                   \
  }

FILL_HALOS(fill_halos_f32, float)
FILL_HALOS(fill_halos_f64, double)

}  // extern "C"
