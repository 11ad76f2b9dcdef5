// w from continuity and the hydrostatic pressure anomaly pHY', column by
// column, for the hydrostatic model (K4a):
//
//   w(k+1) = -sum_{k' <= k} dz_c(k') * div_xy(u, v)(k')        (bottom-up)
//   pHY'(k) = -sum_{faces above k} izf(b) * dz_f                 (top-down)
//
// with div_xy = (dxc(Ax u) + dyc(Ay v)) / V, Ax = dy * dz, Ay = dx * dz,
// V = Az * dz: ops/operators.py::div_xy_ccc on x-constant metric rows
// (ops/metric_rows.py). Writes every with-halo point of w and pHY', as the
// plain version computes them: the sums on every (x, y) column, halo
// columns included (there the plain version's stencils wrap around the
// array's far edges, and so do the kernel's), and zeros on the z halos and
// w's bottom face. The values on the halo columns mean nothing; the
// caller's fill overwrites them.
//
// Replaces the in-kernel w and pHY' of the TPU kernel
// clima_oceananigans_jl_tpu/ops/fused_hydrostatic.py::
// fused_hydrostatic_tendencies (_w_block l.346, _ph_block l.394), whose
// Hillis-Steele scans over a VMEM block become one serial sum per column
// here, in the order of the plain version (ops/fused_hydrostatic.py::
// hydrostatic_columns_reference), so the two are bitwise equal. Build with
// --fmad=false so the compiler forms no FMA that eager PyTorch does not.
//
// What bounds it on an H100: memory. At the 1/4 degree flagship
// (1446 x 606 x 30 with halos, fp32) it reads u, v and b (3 x 105 MB) and
// writes w and pHY' (2 x 105 MB): about 0.5 GB, 0.16 ms at 3.35 TB/s. The
// arithmetic is ~15 flops and a division per level. The sums are serial in
// z, and z is the contiguous axis, so a thread per column reads and writes
// with a stride of a column (a 32-byte sector per value). Here a block owns
// one x index and a run of up to 32 consecutive y columns, which for a
// fixed x is one contiguous stretch of run x Z values in every array:
//   1. u at x and x+1, v over the run and one column more, and b are copied
//      into shared memory, a thread per element, with cp.async (tiles.cuh).
//      Element copies, not 16-byte ones: a stretch starts on a 16-byte
//      boundary only at some offsets (a column is 120 bytes at 1/4 degree),
//      and a warp's 32 consecutive element copies coalesce into whole
//      128-byte lines anyway;
//   2. every thread computes increments and b face sums point by point;
//   3. one thread a column runs each serial sum over shared memory (w on
//      the first warps, pHY' on the next), the columns padded to an odd
//      stride so that a warp's 32 columns fall in 32 banks;
//   4. the block writes its whole stretch of w and pHY' back, a thread per
//      element, zeros included, so the outputs need no zero fill.
// The run is cut at run time so that a block's tiles fit 48 KB of shared
// memory (deep or fp64 columns), or one column in the 227 KB an SM has.
//
// On a Flat x (X = 1) the same layout holds: x+1 wraps to x itself. On a
// Flat y (Y = 1, so consecutive x indices are consecutive columns in
// memory) a block owns a run of up to 32 x indices instead (FLAT_Y): u over
// the run and one column more, so that u at x+1 is the next staged column,
// and v over the run, whose y+1 neighbour is the column itself, as the
// plain version's roll of an axis of extent 1 makes it.
//
// On partial bottom cells (D3, ops/fused_hydrostatic.py's 3D-dz form) dz is
// a 3D array in the fields' layout, and the factoring above no longer
// holds: the grid's Ax at a u face of index i reads dz_ccc of cell i (the
// cell east of the face), its Ay at a v face of index j dz_ccc of cell j
// (north of it), and V and the increment's own dz that of the cell itself,
// so a cell's east and west faces read different dz (immersed/immersed.py,
// as the JAX ImmersedGrid.spacing gives them); pHY' reads dz_ccf. Each
// thread of step 2 reads its point's three dz_ccc values and its dz_ccf
// from global memory (consecutive threads, consecutive addresses, as the
// staged copies are), and the rest of the kernel is as above.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tiles.cuh"

// rows of ops/metric_rows.py: Y_ROWS and Z_ROWS
enum { DX_CF = 1, AZ_CC = 4, DY_C = 8 };
enum { DZ_C = 0, DZ_F = 1 };

constexpr int HC_THREADS = 128;
// the most y columns a block owns, and the shared memory the run is cut to
constexpr int HC_RUN = 32;
constexpr int HC_SMEM = 48 * 1024;
constexpr int HC_SMEM_MAX = 232448;

template <typename T>
struct ColumnArgs {
  const T* u;
  const T* v;
  const T* b;  // null: w only
  const T* ys;
  const T* zs;
  T* w;
  T* ph;
  int nx, ny, nz, hx, hy, hz;
  int run, nruns, zp;  // columns a block, blocks an x row, padded column stride
  FastDiv zd;          // division by the column length Z
  // D3: the 3D dz at z-centres and at z-faces (the z rows are not read)
  const T* dzc3;
  const T* dzf3;
};

// shared-memory elements of a block owning `run` columns: u at x and x+1, v
// (run + 1 columns) and b at stride Z, then the staged w and pHY' at stride zp
static long long column_smem_elems(int run, int Z, int zp, bool with_b) {
  return (long long)run * Z * (with_b ? 3 : 2) + (long long)(run + 1) * Z +
         (long long)run * zp * (with_b ? 2 : 1);
}

template <typename T, bool FLAT_Y, bool D3 = false>
__global__ void __launch_bounds__(HC_THREADS)
hydrostatic_columns_kernel(const ColumnArgs<T> A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int X = A.nx + 2 * A.hx, Y = A.ny + 2 * A.hy, Z = A.nz + 2 * A.hz;
  const int zp = A.zp;
  const int I = FLAT_Y ? 0 : (int)blockIdx.x / A.nruns;
  const int r = FLAT_Y ? (int)blockIdx.x : (int)blockIdx.x % A.nruns;
  // columns [J0, J1) of x index I (FLAT_Y: the x indices [J0, J1) of the one
  // y index); the neighbours x+1 and y+1 of the last row and column wrap,
  // as the plain version's rolls do
  const int L = FLAT_Y ? X : Y;
  const int J0 = r * A.run, J1 = min(J0 + A.run, L), nc = J1 - J0, n = nc * Z;
  const int In = I + 1 < X ? I + 1 : 0, Jn = J1 < L ? J1 : 0;
  const bool with_b = A.b != nullptr;
  const int64_t row = (int64_t)I * Y * Z, g0 = row + (int64_t)J0 * Z;
  const int64_t gn = (int64_t)In * Y * Z + (int64_t)J0 * Z;
  T* const su0 = reinterpret_cast<T*>(smem_raw);
  T* const su1 = su0 + A.run * Z;  // FLAT_Y: su0's column after the run
  T* const sv = su1 + A.run * Z;
  T* const sb = sv + (A.run + 1) * Z;
  T* const sw = sb + (with_b ? A.run * Z : 0);
  T* const sph = sw + A.run * zp;
  for (int e = threadIdx.x; e < n + Z; e += HC_THREADS) {
    if (e < n) {
      copy_async(sv + e, A.v + g0 + e);
      copy_async(su0 + e, A.u + g0 + e);
      if (!FLAT_Y) copy_async(su1 + e, A.u + gn + e);
      if (with_b) copy_async(sb + e, A.b + g0 + e);
    } else if (FLAT_Y) {
      copy_async(su0 + e, A.u + (int64_t)Jn * Z + (e - n));
    } else {
      copy_async(sv + e, A.v + row + (int64_t)Jn * Z + (e - n));
    }
  }
  copy_async_commit();
  copy_async_wait<0>();
  __syncthreads();
  // slot k of a staged w column holds the increment of level k - 1, slot k
  // of a staged pHY' column the b face sum of face k + 1; zero elsewhere
  const T* dx_cf = A.ys + DX_CF * Y;
  const T* az_cc = A.ys + AZ_CC * Y;
  const T* dy_c = A.ys + DY_C * Y;
  const T* dz_c = A.zs + DZ_C * Z;
  const T* dz_f = A.zs + DZ_F * Z;
  for (int e = threadIdx.x; e < n; e += HC_THREADS) {
    const int j = A.zd.div(e), k = e - j * Z, J = FLAT_Y ? 0 : J0 + j;
    T incr = T(0);
    if constexpr (D3) {
      if (k > A.hz && k <= A.hz + A.nz) {
        const int c = e - 1;  // level k - 1 of column j
        // dz_ccc of the cell, of the cell east of it (x+1) and north (y+1)
        const T dz = __ldg(A.dzc3 + g0 + c);
        const T dze = __ldg(A.dzc3 + gn + c);
        const T dzn = __ldg(A.dzc3 + (j + 1 < nc ? g0 + c + Z : row + (int64_t)Jn * Z + (k - 1)));
        const T AxR = dy_c[J] * dze, AxL = dy_c[J] * dz;
        const T AyR = dx_cf[J + 1 < Y ? J + 1 : 0] * dzn, AyL = dx_cf[J] * dz;
        const T d = ((AxR * su1[c] - AxL * su0[c]) + (AyR * sv[c + Z] - AyL * sv[c]))
                    / (az_cc[J] * dz);
        incr = dz * d;
      }
      sw[j * zp + k] = incr;
      if (with_b)
        sph[j * zp + k] = k >= A.hz && k < A.hz + A.nz
                              ? (T(0.5) * (sb[e + 1] + sb[e])) * __ldg(A.dzf3 + g0 + e + 1)
                              : T(0);
      continue;
    }
    if (k > A.hz && k <= A.hz + A.nz) {
      const int c = e - 1;  // level k - 1 of column j
      const T dz = dz_c[k - 1];
      const T Ax = dy_c[J] * dz;
      const T AyR = dx_cf[J + 1 < Y ? J + 1 : 0] * dz, AyL = dx_cf[J] * dz;
      // u at x+1 and v at y+1: FLAT_Y the next staged u column and v itself
      const T ue = FLAT_Y ? su0[c + Z] : su1[c], vn = FLAT_Y ? sv[c] : sv[c + Z];
      const T d = ((Ax * ue - Ax * su0[c]) + (AyR * vn - AyL * sv[c]))
                  / (az_cc[J] * dz);
      incr = dz * d;
    }
    sw[j * zp + k] = incr;
    if (with_b)
      sph[j * zp + k] = k >= A.hz && k < A.hz + A.nz
                            ? (T(0.5) * (sb[e + 1] + sb[e])) * dz_f[k + 1]
                            : T(0);
  }
  __syncthreads();
  // one thread a column and sum: w on columns [0, R), pHY' on [R, 2R)
  const int R = (nc + 31) & ~31;
  for (int t = threadIdx.x; t < (with_b ? 2 * R : R); t += HC_THREADS) {
    const int j = t < R ? t : t - R;
    if (j >= nc) continue;
    T acc = T(0);
    if (t < R) {
      T* const c = sw + j * zp;
      for (int K = A.hz; K < A.hz + A.nz; ++K) {
        acc = K == A.hz ? c[K + 1] : acc + c[K + 1];
        c[K + 1] = -acc;
      }
    } else {
      T* const c = sph + j * zp;
      for (int K = A.hz + A.nz - 1; K >= A.hz; --K) {
        acc = K == A.hz + A.nz - 1 ? c[K] : acc + c[K];
        c[K] = -acc;
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n; e += HC_THREADS) {
    const int j = A.zd.div(e), k = e - j * Z;
    A.w[g0 + e] = sw[j * zp + k];
    if (with_b) A.ph[g0 + e] = sph[j * zp + k];
  }
}

// The launch's shape: the run (columns a block), its blocks an x row and its
// shared memory in bytes; false if one column does not fit an SM.
template <typename T>
static bool column_shape(int Y, int nz, int hz, bool with_b, int* run,
                         int* nruns, int* zp, int* smem) {
  const int Z = nz + 2 * hz;
  *zp = Z | 1;
  int r = HC_RUN;
  while (r > 1 && column_smem_elems(r, Z, *zp, with_b) * (long long)sizeof(T) > HC_SMEM)
    --r;
  const long long bytes = column_smem_elems(r, Z, *zp, with_b) * (long long)sizeof(T);
  if (bytes > HC_SMEM_MAX) return false;
  *run = r;
  *nruns = (Y + r - 1) / r;
  *smem = (int)bytes;
  return true;
}

template <typename T, bool FLAT_Y, bool D3 = false>
static int run(ColumnArgs<T>& A, int smem, cudaStream_t st) {
  auto kernel = hydrostatic_columns_kernel<T, FLAT_Y, D3>;
  if (smem > HC_SMEM) {
    const int rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != 0) return rc;
  }
  const long long blocks =
      FLAT_Y ? (long long)A.nruns : (long long)(A.nx + 2 * A.hx) * A.nruns;
  kernel<<<(unsigned)blocks, HC_THREADS, smem, st>>>(A);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* u, const void* v, const void* b, const void* ys,
                  const void* zs, void* w, void* ph, int nx, int ny, int nz,
                  int hx, int hy, int hz, bool d3, void* stream) {
  if ((b == nullptr) != (ph == nullptr)) return (int)cudaErrorInvalidValue;
  if (nx <= 0 || ny <= 0 || nz <= 0 || hz < 1)  // b's top face is a halo level
    return (int)cudaErrorInvalidValue;
  ColumnArgs<T> A;
  A.u = static_cast<const T*>(u);
  A.v = static_cast<const T*>(v);
  A.b = static_cast<const T*>(b);
  A.ys = static_cast<const T*>(ys);
  A.zs = d3 ? nullptr : static_cast<const T*>(zs);
  A.dzc3 = d3 ? static_cast<const T*>(zs) : nullptr;
  A.dzf3 = d3 ? A.dzc3 + (int64_t)(nx + 2 * hx) * (ny + 2 * hy) * (nz + 2 * hz) : nullptr;
  A.w = static_cast<T*>(w);
  A.ph = static_cast<T*>(ph);
  A.nx = nx; A.ny = ny; A.nz = nz; A.hx = hx; A.hy = hy; A.hz = hz;
  // a Flat y (one y index): runs along x
  const bool flat_y = ny + 2 * hy == 1;
  if (d3 && (flat_y || nx + 2 * hx == 1)) return (int)cudaErrorInvalidValue;
  int smem;
  if (!column_shape<T>(flat_y ? nx + 2 * hx : ny + 2 * hy, nz, hz, b != nullptr, &A.run,
                       &A.nruns, &A.zp, &smem))
    return (int)cudaErrorInvalidConfiguration;
  A.zd = fast_div((unsigned)(nz + 2 * hz));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d3) return run<T, false, true>(A, smem, st);
  return flat_y ? run<T, true>(A, smem, st) : run<T, false>(A, smem, st);
}

template <typename T>
static int config(int ny, int hy, int nz, int hz, int with_b, int* out) {
  int run, nruns, zp, smem;
  if (!column_shape<T>(ny + 2 * hy, nz, hz, with_b != 0, &run, &nruns, &zp, &smem))
    return (int)cudaErrorInvalidConfiguration;
  cudaFuncAttributes attr;
  const int rc = (int)cudaFuncGetAttributes(&attr, hydrostatic_columns_kernel<T, false>);
  if (rc != 0) return rc;
  out[0] = run; out[1] = nruns; out[2] = smem; out[3] = HC_THREADS;
  out[4] = attr.numRegs;
  return 0;
}

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). `b` and `ph`
// are both device pointers (pHY' too) or both null (w only). The _dz3
// entries take a partial-cell grid's 3D dz at z-centres then at z-faces
// (2 x X x Y x Z, the fields' layout) in place of the z rows `zs`.
#define HYDROSTATIC_COLUMNS(NAME, T, D3)                                    \
  int NAME(const void* u, const void* v, const void* b, const void* ys,     \
           const void* zs, void* w, void* ph, int nx, int ny, int nz,       \
           int hx, int hy, int hz, void* stream) {                          \
    return launch<T>(u, v, b, ys, zs, w, ph, nx, ny, nz, hx, hy, hz, D3,    \
                     stream);                                               \
  }

HYDROSTATIC_COLUMNS(hydrostatic_columns_f32, float, false)
HYDROSTATIC_COLUMNS(hydrostatic_columns_f64, double, false)
HYDROSTATIC_COLUMNS(hydrostatic_columns_dz3_f32, float, true)
HYDROSTATIC_COLUMNS(hydrostatic_columns_dz3_f64, double, true)

// The launch's shape for ny, hy, nz, hz (with b or not): out[0..4] =
// columns a block, blocks an x row, shared memory bytes, threads a block,
// registers a thread (as ptxas allocated them). Returns a CUDA error code.
#define HYDROSTATIC_COLUMNS_CONFIG(NAME, T)                                 \
  int NAME(int ny, int hy, int nz, int hz, int with_b, int* out) {          \
    return config<T>(ny, hy, nz, hz, with_b, out);                          \
  }

HYDROSTATIC_COLUMNS_CONFIG(hydrostatic_columns_config_f32, float)
HYDROSTATIC_COLUMNS_CONFIG(hydrostatic_columns_config_f64, double)

}  // extern "C"
