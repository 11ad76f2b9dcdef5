// The split-explicit barotropic substeps (K5), all of them in one
// cooperative launch. Substep i of ops/fused_barotropic.py::
// fused_substep_eta_reference:
//
//   half 0:  U' = fill(U + dtau (((-g) Hfc) dxf(eta) / dxu + GU)), V' likewise;
//            U_av += wv[i] U',  V_av += wv[i] V'
//   half 1:  eta' = eta - (dtau (dxc(dyu U') + dyc(dxv V'))) / az;
//            eta_av += wf[i] eta'
//
// on with-halo (X, Y) arrays, y contiguous. Every with-halo point takes its
// value through the fill rule of its location (the periodic wrap, the
// zero-gradient mirror of a centred field, or the impenetrable wall of a
// face field: zero on the wall face, the negated mirror beyond it) applied
// to the update at its source point, so no separate fill runs and the
// outputs are the plain version's filled arrays. eta's halos (and eta_av's)
// hold the values at their mirror points, which is what the plain
// version's fills write there. Metrics are x-constant rows over with-halo y
// (ops/metric_rows.py::y_row): dxu, dyv, dyu, dxv, az. The column depths
// Hfc, Hcf vary in x and y over an immersed bottom, so they are with-halo
// (X, Y) planes, read at each point's source. Build with --fmad=false so
// the compiler forms no FMA that eager PyTorch does not.
//
// Replaces the TPU kernel clima_oceananigans_jl_tpu/ops/fused_barotropic.py::
// fused_substep_eta, which keeps all N substeps VMEM-resident in one call.
// Its counterpart here is one persistent launch over co-resident blocks
// (cudaLaunchCooperativeKernel, the grid sized by the occupancy calculator
// and the SM count): a prologue fills eta from eta0 by the same rule, then
// each half-substep is a grid-stride pass over the with-halo points, the
// passes separated by grid-wide barriers (cooperative_groups grid sync), 2N
// in all. Ping-pong buffers keep the rule's reads of the old values: a halo
// point reads its mirror's value from before the pass.
//
// What bounds it on an H100: the barriers and L2 latency. At the 1/4
// degree flagship (1446 x 606, fp32, 3.5 MB an array) a substep reads eta,
// U and V twice and writes them once, about 32 MB, all of it L2-resident
// (50 MB): some 5-10 us a substep at L2 rates, beside two barriers of a few
// us each. The host launches once a call instead of 2N times. The grid
// stride is a multiple of Y, so a thread keeps one y index: its fill-rule y
// sources and metric values, read once, stay in registers. Its points' Gu,
// Gv and three running averages stay in shared memory (in registers they
// would cost the occupancy that hides L2 latency), sized at launch so that all of
// them fit with as many blocks an SM as the registers allow; the averages
// are written once, at the end. Points past what 227 KB holds keep their
// averages in the output arrays. A thread issues the loads of a chunk of
// points before any store: the buffers may alias as far as the compiler
// knows. Arrays that other blocks write during the launch are read through
// plain loads, never the non-coherent read-only path.
//
// On a Flat x or y (extent 1, halo 0; FLAT) the neighbour along that axis is
// the point itself, as the plain version's roll of an axis of extent 1 makes
// it: its offset is 0 (A.sxo, A.syo), so dxf(eta) and dxc(dyu U) come out as
// the plain version's differences of a value with itself. On a Flat x every
// y index is one thread's; on a Flat y the grid stride runs along x.
//
// The cut form (a shard of a grid cut over a mesh): a cut axis' halos are
// the neighbouring shards' strips, which no launch on one shard can read
// between substeps. So each substep is two ordinary launches, and the
// halo fills between them (ops/fused_barotropic.py::cut_sequence: K6 and
// the neighbour exchange, in the plain version's x-then-y order, corners
// included) write every halo point:
//
//   substep_uv_kernel:  U' = U + dtau (((-g) Hfc) dxf(eta) / dxu + GU) and
//                       V' likewise, on the interior points only (in place
//                       from the second substep on: a point reads only
//                       itself of U and V);
//   (fill U', V')
//   substep_eta_kernel: U_av += wv[i] U', V_av += wv[i] V' on every
//                       with-halo point (the filled values, as the plain
//                       version adds them), and on the interior points
//                       eta' = eta - (dtau (dxc(dyu U') + dyc(dxv V'))) / az
//                       in place and eta_av += wf[i] eta'.
//
// eta_av's halos are left to the final fill, which writes every one of
// them. One thread a point, y fastest; a Flat axis' offset is 0 as above.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

enum { DXU = 0, DYV = 1, DYU = 2, DXV = 3, AZ = 4 };

// 256 threads a block, registers capped so that 3 blocks fit an SM (80 a
// thread: fp32 does not spill); a thread issues the loads of SE_CHUNK
// points at once. Of the shapes timed at 1/4 degree fp32 (chunks of 1, 2
// and 4 points; 2 to 8 blocks an SM) this was the fastest, if narrowly.
constexpr int SE_THREADS = 256;
constexpr int SE_MIN_BLOCKS = 3;
constexpr int SE_CHUNK = 2;
constexpr int SE_SMEM_MAX = 232448;
constexpr int SE_MAX_DEVICES = 64;

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

// 2.0*0 - x of the plain version's wall fill
template <typename T>
__device__ __forceinline__ T apply(T x, int f) {
  return f == 0 ? T(0) : (f < 0 ? T(0) - x : x);
}

template <typename T>
struct SubstepArgs {
  const T* rows;  // (5, Y)
  const T* eta0;  // unfilled
  const T* U0;
  const T* V0;
  const T* GU;
  const T* GV;
  const T* wv;  // (n,)
  const T* wf;
  const T* hfc;  // the depth planes (X, Y)
  const T* hcf;
  T* buf;  // 6 with-halo arrays: eta at 0 and XY, U at 2 XY and 3 XY, V at 4 XY and 5 XY
  T* eta_av;
  T* U_av;
  T* V_av;
  int n, nx, ny, hx, hy, xb, yb;
  int rows_t;  // rows of threads: the grid stride is rows_t * Y points
  int kept;    // points a thread keeps in shared memory
  T neg_g, dtau;
  int sxo, syo;  // FLAT: the offsets of the x and y neighbours (0 on a Flat axis)
};

// What a thread keeps of its y index: the fill-rule sources of U (and eta:
// both centred in y) and V, and the metric values there.
template <typename T>
struct YCol {
  Src c, f;
  T dxu, dyv, dyu, dxv0, dxv1, az;
};

// the kept values of a point, [value][point][thread] in shared memory
enum { KEEP_GU = 0, KEEP_GV, KEEP_UAV, KEEP_VAV, KEEP_EAV, KEEP_VALUES };

template <typename T, bool FLAT>
__global__ void __launch_bounds__(SE_THREADS, SE_MIN_BLOCKS)
fused_substep_eta_kernel(const SubstepArgs<T> A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const keep = reinterpret_cast<T*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  const int X = A.nx + 2 * A.hx, Y = A.ny + 2 * A.hy, XY = X * Y;
  const int SX = FLAT ? A.sxo : Y, SY = FLAT ? A.syo : 1;  // x and y neighbours
  const int tid = threadIdx.x;
  const int t = (int)blockIdx.x * SE_THREADS + tid;
  const int rows = A.rows_t, J = t % Y, I0 = t / Y;
  // this thread's points: (I0 + k rows, J) for k < count
  const int count = t < rows * Y && I0 < X ? (X - 1 - I0) / rows + 1 : 0;
  auto kept = [&](int v, int k) -> T& {
    return keep[(v * A.kept + k) * SE_THREADS + tid];
  };
  YCol<T> y;
  y.c = source(J, A.ny, A.hy, A.yb, false);
  y.f = source(J, A.ny, A.hy, A.yb, true);
  const T* r = A.rows;
  y.dxu = __ldg(r + DXU * Y + y.c.i);
  y.dyu = __ldg(r + DYU * Y + y.c.i);
  y.dxv0 = __ldg(r + DXV * Y + y.c.i);
  y.dxv1 = __ldg(r + DXV * Y + y.c.i + SY);
  y.az = __ldg(r + AZ * Y + y.c.i);
  y.dyv = __ldg(r + DYV * Y + y.f.i);
  const bool u_row = y.c.f != 0, v_row = y.f.f != 0;  // not a y wall face
  // prologue: eta filled from eta0; Gu, Gv at the U and V sources (zero on
  // a wall face) and the averages at zero, kept or in the outputs
  for (int k = 0; k < count; ++k) {
    const int I = I0 + k * rows, p = I * Y + J;
    const Src ux = source(I, A.nx, A.hx, A.xb, true);
    const Src vx = source(I, A.nx, A.hx, A.xb, false);
    A.buf[p] = __ldg(A.eta0 + vx.i * Y + y.c.i);
    if (k < A.kept) {
      kept(KEEP_GU, k) = ux.f != 0 && u_row ? __ldg(A.GU + ux.i * Y + y.c.i) : T(0);
      kept(KEEP_GV, k) = vx.f != 0 && v_row ? __ldg(A.GV + vx.i * Y + y.f.i) : T(0);
      kept(KEEP_UAV, k) = kept(KEEP_VAV, k) = kept(KEEP_EAV, k) = T(0);
    } else {
      A.U_av[p] = A.V_av[p] = A.eta_av[p] = T(0);
    }
  }
  grid.sync();
  for (int i = 0; i < A.n; ++i) {
    // substep i reads the copies (i & 1) and writes the others (U0, V0 at i = 0)
    const int in = (i & 1) * XY, out = ((i + 1) & 1) * XY;
    const T* const eta = A.buf + in;
    T* const eta_out = A.buf + out;
    const T* const U = i == 0 ? A.U0 : A.buf + 2 * XY + in;
    const T* const V = i == 0 ? A.V0 : A.buf + 4 * XY + in;
    T* const U_out = A.buf + 2 * XY + out;
    T* const V_out = A.buf + 4 * XY + out;
    const T wv = __ldg(A.wv + i), wf = __ldg(A.wf + i);
    // half 0: U', V' and their averages. A chunk of points' loads go out
    // before any of its stores (the compiler cannot move a load past a
    // store to a buffer that might alias it); the loads of a point past the
    // last repeat the last, and its results are dropped.
    for (int k0 = 0; k0 < count; k0 += SE_CHUNK) {
      Src ux[SE_CHUNK], vx[SE_CHUNK];
      T u[SE_CHUNK], e1[SE_CHUNK], e0[SE_CHUNK], gu[SE_CHUNK], hf[SE_CHUNK];
      T v[SE_CHUNK], f1[SE_CHUNK], f0[SE_CHUNK], gv[SE_CHUNK], hc[SE_CHUNK];
#pragma unroll
      for (int c = 0; c < SE_CHUNK; ++c) {
        const int k = min(k0 + c, count - 1), I = I0 + k * rows;
        ux[c] = source(I, A.nx, A.hx, A.xb, true);
        vx[c] = source(I, A.nx, A.hx, A.xb, false);
        const int o = ux[c].i * Y + y.c.i, q = vx[c].i * Y + y.f.i;
        u[c] = U[o];
        e1[c] = eta[o];
        e0[c] = eta[o - SX];
        v[c] = V[q];
        f1[c] = eta[q];
        f0[c] = eta[q - SY];
        gu[c] = k < A.kept ? kept(KEEP_GU, k) : __ldg(A.GU + o);
        gv[c] = k < A.kept ? kept(KEEP_GV, k) : __ldg(A.GV + q);
        hf[c] = __ldg(A.hfc + o);
        hc[c] = __ldg(A.hcf + q);
      }
#pragma unroll
      for (int c = 0; c < SE_CHUNK; ++c) {
        const int k = k0 + c;
        if (k >= count) break;
        T Un = T(0), Vn = T(0);
        if (ux[c].f != 0 && u_row) {
          Un = u[c] + A.dtau * ((A.neg_g * hf[c] * (e1[c] - e0[c])) / y.dxu + gu[c]);
          Un = apply(apply(Un, ux[c].f), y.c.f);
        }
        if (vx[c].f != 0 && v_row) {
          Vn = v[c] + A.dtau * ((A.neg_g * hc[c] * (f1[c] - f0[c])) / y.dyv + gv[c]);
          Vn = apply(apply(Vn, vx[c].f), y.f.f);
        }
        const int p = (I0 + k * rows) * Y + J;
        U_out[p] = Un;
        V_out[p] = Vn;
        T& ua = k < A.kept ? kept(KEEP_UAV, k) : A.U_av[p];
        T& va = k < A.kept ? kept(KEEP_VAV, k) : A.V_av[p];
        ua = ua + wv * Un;
        va = va + wv * Vn;
      }
    }
    grid.sync();
    // half 1: eta' from eta and the filled U', V'; its average
    for (int k0 = 0; k0 < count; k0 += SE_CHUNK) {
      T ur[SE_CHUNK], ul[SE_CHUNK], vr[SE_CHUNK], vl[SE_CHUNK], e[SE_CHUNK];
#pragma unroll
      for (int c = 0; c < SE_CHUNK; ++c) {
        const int k = min(k0 + c, count - 1), I = I0 + k * rows;
        const int o = source(I, A.nx, A.hx, A.xb, false).i * Y + y.c.i;
        ur[c] = U_out[o + SX];
        ul[c] = U_out[o];
        vr[c] = V_out[o + SY];
        vl[c] = V_out[o];
        e[c] = eta[o];
      }
#pragma unroll
      for (int c = 0; c < SE_CHUNK; ++c) {
        const int k = k0 + c;
        if (k >= count) break;
        const T div = (y.dyu * ur[c] - y.dyu * ul[c]) + (y.dxv1 * vr[c] - y.dxv0 * vl[c]);
        const T en = e[c] - (A.dtau * div) / y.az;
        const int p = (I0 + k * rows) * Y + J;
        eta_out[p] = en;
        T& ea = k < A.kept ? kept(KEEP_EAV, k) : A.eta_av[p];
        ea = ea + wf * en;
      }
    }
    if (i + 1 < A.n) grid.sync();
  }
  for (int k = 0; k < count && k < A.kept; ++k) {
    const int p = (I0 + k * rows) * Y + J;
    A.U_av[p] = kept(KEEP_UAV, k);
    A.V_av[p] = kept(KEEP_VAV, k);
    A.eta_av[p] = kept(KEEP_EAV, k);
  }
}

// The cooperative grid of a launch: blocks, blocks an SM, rows of threads,
// points a thread keeps in shared memory and the shared memory a block has.
struct Shape {
  int blocks, per_sm, rows, kept, smem;
};

// Per device: the most blocks an SM takes by registers alone, the SM
// count (0: not asked yet), and the last grid's shape.
struct DeviceCache {
  int regs_per_sm, sms, X, Y;
  Shape last;
};

// The shape for X x Y points: the most blocks an SM whose threads' points
// all fit in shared memory (the grid stride is a multiple of Y, so more
// blocks, fewer points a thread); if none fit, one block an SM keeping as
// many points as 227 KB holds (the rest keep their averages in the outputs).
template <typename T, bool FLAT>
static int pick(int X, int Y, Shape* s) {
  static DeviceCache cache[SE_MAX_DEVICES];
  auto kernel = fused_substep_eta_kernel<T, FLAT>;
  int dev;
  int rc = (int)cudaGetDevice(&dev);
  if (rc != 0) return rc;
  if (dev < 0 || dev >= SE_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  DeviceCache& d = cache[dev];
  if (d.sms == 0) {
    int coop = 0, sms = 0, nb = 0;
    if ((rc = (int)cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != 0)
      return rc;
    if (!coop) return (int)cudaErrorNotSupported;
    if ((rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        SE_SMEM_MAX)) != 0)
      return rc;
    if ((rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != 0)
      return rc;
    if ((rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kernel, SE_THREADS, 0)) != 0)
      return rc;
    if (nb < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    d.regs_per_sm = nb;
    d.sms = sms;
  }
  if (d.X == X && d.Y == Y) {
    *s = d.last;
    return 0;
  }
  const long long point_bytes = (long long)SE_THREADS * KEEP_VALUES * sizeof(T);
  for (int b = d.regs_per_sm; b >= 1; --b) {
    const long long most = (long long)b * d.sms;
    const long long rows_most = most * SE_THREADS / Y;
    if (rows_most < 1) return (int)cudaErrorInvalidConfiguration;  // Y > threads
    const long long pts = (X + rows_most - 1) / rows_most;
    const long long need = ((X + pts - 1) / pts * Y + SE_THREADS - 1) / SE_THREADS;
    const long long smem = pts * point_bytes;
    if (smem > SE_SMEM_MAX && b > 1) continue;
    int fits = 0;
    const int kept = (int)(smem > SE_SMEM_MAX ? SE_SMEM_MAX / point_bytes : pts);
    if ((rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &fits, kernel, SE_THREADS, (size_t)(kept * point_bytes))) != 0)
      return rc;
    if (fits < b) continue;
    s->blocks = (int)(need < most ? need : most);
    s->per_sm = b;
    s->rows = (int)((long long)s->blocks * SE_THREADS / Y);
    s->kept = kept;
    s->smem = (int)(kept * point_bytes);
    d.X = X;
    d.Y = Y;
    d.last = *s;
    return 0;
  }
  return (int)cudaErrorCooperativeLaunchTooLarge;
}

template <typename T, bool FLAT>
static int run(SubstepArgs<T>& A, int X, int Y, void* stream) {
  Shape s;
  int rc = pick<T, FLAT>(X, Y, &s);
  if (rc != 0) return rc;
  A.rows_t = s.rows;
  A.kept = s.kept;
  void* args[] = {&A};
  rc = (int)cudaLaunchCooperativeKernel((const void*)fused_substep_eta_kernel<T, FLAT>,
                                        dim3((unsigned)s.blocks), dim3(SE_THREADS), args,
                                        (size_t)s.smem, static_cast<cudaStream_t>(stream));
  return rc != 0 ? rc : (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* rows, const void* hfc, const void* hcf, const void* eta0,
                  const void* U0, const void* V0, const void* GU, const void* GV,
                  const void* wv, const void* wf, void* buf, void* eta_av, void* U_av,
                  void* V_av, int n, int nx, int ny, int hx, int hy, int xb, int yb,
                  double g, double dtau, void* stream) {
  if (hfc == nullptr || hcf == nullptr) return (int)cudaErrorInvalidValue;
  if (n < 0 || nx <= 0 || ny <= 0 || hx < 0 || hy < 0) return (int)cudaErrorInvalidValue;
  // a Flat axis (halo 0) has extent 1 and is not bounded
  const bool fx = hx == 0, fy = hy == 0;
  if ((fx && (nx != 1 || xb)) || (fy && (ny != 1 || yb))) return (int)cudaErrorInvalidValue;
  const long long X = nx + 2LL * hx, Y = ny + 2LL * hy;
  if (X * Y > INT32_MAX) return (int)cudaErrorInvalidValue;  // 32-bit point indices
  SubstepArgs<T> A;
  A.rows = static_cast<const T*>(rows);
  A.eta0 = static_cast<const T*>(eta0);
  A.U0 = static_cast<const T*>(U0);
  A.V0 = static_cast<const T*>(V0);
  A.GU = static_cast<const T*>(GU);
  A.GV = static_cast<const T*>(GV);
  A.wv = static_cast<const T*>(wv);
  A.wf = static_cast<const T*>(wf);
  A.hfc = static_cast<const T*>(hfc);
  A.hcf = static_cast<const T*>(hcf);
  A.buf = static_cast<T*>(buf);
  A.eta_av = static_cast<T*>(eta_av);
  A.U_av = static_cast<T*>(U_av);
  A.V_av = static_cast<T*>(V_av);
  A.n = n; A.nx = nx; A.ny = ny; A.hx = hx; A.hy = hy; A.xb = xb; A.yb = yb;
  A.neg_g = T(-g);
  A.dtau = T(dtau);
  A.sxo = fx ? 0 : (int)Y;
  A.syo = fy ? 0 : 1;
  return fx || fy ? run<T, true>(A, (int)X, (int)Y, stream)
                  : run<T, false>(A, (int)X, (int)Y, stream);
}

template <typename T>
static int config(int nx, int ny, int hx, int hy, int* out) {
  Shape s;
  const bool flat = hx == 0 || hy == 0;
  int rc = flat ? pick<T, true>(nx + 2 * hx, ny + 2 * hy, &s)
                : pick<T, false>(nx + 2 * hx, ny + 2 * hy, &s);
  if (rc != 0) return rc;
  cudaFuncAttributes attr;
  rc = (int)cudaFuncGetAttributes(&attr, flat ? (const void*)fused_substep_eta_kernel<T, true>
                                              : (const void*)fused_substep_eta_kernel<T, false>);
  if (rc != 0) return rc;
  out[0] = s.blocks; out[1] = SE_THREADS; out[2] = s.per_sm; out[3] = s.kept;
  out[4] = s.rows; out[5] = s.smem; out[6] = attr.numRegs;
  out[7] = (int)attr.localSizeBytes;
  return 0;
}

// -- the cut form: one launch a half-substep, the fills between them --------

constexpr int CUT_THREADS = 256;

template <typename T>
struct CutArgs {
  const T* rows;  // (5, Y)
  const T* hfc;   // the depth planes (X, Y)
  const T* hcf;
  const T* GU;
  const T* GV;
  const T* U_in;  // the half's U and V before it (U0, V0 at substep 0)
  const T* V_in;
  const T* wv;  // (n,)
  const T* wf;
  T* eta;  // filled by the caller before the U, V half
  T* U;    // filled by the caller before the eta half
  T* V;
  T* eta_av;
  T* U_av;
  T* V_av;
  int nx, ny, hx, hy, i;
  int first;  // substep 0: the averages start from zero
  int sxo, syo;  // the x and y neighbours' offsets (0 on a Flat axis)
  T neg_g, dtau;
};

// U', V' on the interior points
template <typename T>
__global__ void __launch_bounds__(CUT_THREADS)
substep_uv_kernel(const CutArgs<T> A) {
  const int Y = A.ny + 2 * A.hy;
  const int t = (int)blockIdx.x * CUT_THREADS + threadIdx.x;
  if (t >= A.nx * A.ny) return;
  const int I = A.hx + t / A.ny, J = A.hy + t % A.ny;
  const int p = I * Y + J;
  const T* r = A.rows;
  const T e = A.eta[p], ex = A.eta[p - A.sxo], ey = A.eta[p - A.syo];
  const T u = A.U_in[p], v = A.V_in[p];
  const T dxu = __ldg(r + DXU * Y + J), dyv = __ldg(r + DYV * Y + J);
  const T Un = u + A.dtau * ((A.neg_g * __ldg(A.hfc + p) * (e - ex)) / dxu + __ldg(A.GU + p));
  const T Vn = v + A.dtau * ((A.neg_g * __ldg(A.hcf + p) * (e - ey)) / dyv + __ldg(A.GV + p));
  A.U[p] = Un;
  A.V[p] = Vn;
}

// the averages of the filled U', V' on every with-halo point; eta' and its
// average on the interior points
template <typename T>
__global__ void __launch_bounds__(CUT_THREADS)
substep_eta_kernel(const CutArgs<T> A) {
  const int X = A.nx + 2 * A.hx, Y = A.ny + 2 * A.hy;
  const int t = (int)blockIdx.x * CUT_THREADS + threadIdx.x;
  if (t >= X * Y) return;
  const int I = t / Y, J = t - I * Y;
  const T wv = __ldg(A.wv + A.i);
  const T u = A.U[t], v = A.V[t];
  const T ua = A.first ? T(0) : A.U_av[t], va = A.first ? T(0) : A.V_av[t];
  A.U_av[t] = ua + wv * u;
  A.V_av[t] = va + wv * v;
  if (I < A.hx || I >= A.hx + A.nx || J < A.hy || J >= A.hy + A.ny) return;
  const T* r = A.rows;
  const T dyu = __ldg(r + DYU * Y + J);
  const T div = (dyu * A.U[t + A.sxo] - dyu * u)
                + (__ldg(r + DXV * Y + J + (A.syo != 0)) * A.V[t + A.syo]
                   - __ldg(r + DXV * Y + J) * v);
  const T en = A.eta[t] - (A.dtau * div) / __ldg(r + AZ * Y + J);
  A.eta[t] = en;
  const T ea = A.first ? T(0) : A.eta_av[t];
  A.eta_av[t] = ea + __ldg(A.wf + A.i) * en;
}

template <typename T>
static int cut_half(int half, const void* rows, const void* hfc, const void* hcf,
                    const void* GU, const void* GV, const void* U_in, const void* V_in,
                    const void* wv, const void* wf, void* eta, void* U, void* V,
                    void* eta_av, void* U_av, void* V_av, int i, int nx, int ny, int hx,
                    int hy, double g, double dtau, void* stream) {
  if (nx <= 0 || ny <= 0 || hx < 0 || hy < 0 || i < 0) return (int)cudaErrorInvalidValue;
  // a Flat axis (halo 0) has extent 1
  const bool fx = hx == 0, fy = hy == 0;
  if ((fx && nx != 1) || (fy && ny != 1)) return (int)cudaErrorInvalidValue;
  const long long X = nx + 2LL * hx, Y = ny + 2LL * hy;
  if (X * Y > INT32_MAX) return (int)cudaErrorInvalidValue;  // 32-bit point indices
  CutArgs<T> A;
  A.rows = static_cast<const T*>(rows);
  A.hfc = static_cast<const T*>(hfc);
  A.hcf = static_cast<const T*>(hcf);
  A.GU = static_cast<const T*>(GU);
  A.GV = static_cast<const T*>(GV);
  A.U_in = static_cast<const T*>(U_in);
  A.V_in = static_cast<const T*>(V_in);
  A.wv = static_cast<const T*>(wv);
  A.wf = static_cast<const T*>(wf);
  A.eta = static_cast<T*>(eta);
  A.U = static_cast<T*>(U);
  A.V = static_cast<T*>(V);
  A.eta_av = static_cast<T*>(eta_av);
  A.U_av = static_cast<T*>(U_av);
  A.V_av = static_cast<T*>(V_av);
  A.nx = nx; A.ny = ny; A.hx = hx; A.hy = hy; A.i = i;
  A.first = i == 0;
  A.sxo = fx ? 0 : (int)Y;
  A.syo = fy ? 0 : 1;
  A.neg_g = T(-g);
  A.dtau = T(dtau);
  const long long points = half == 0 ? (long long)nx * ny : X * Y;
  const unsigned blocks = (unsigned)((points + CUT_THREADS - 1) / CUT_THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (half == 0) {
    if (U_in == nullptr || V_in == nullptr || GU == nullptr || GV == nullptr ||
        hfc == nullptr || hcf == nullptr)
      return (int)cudaErrorInvalidValue;
    substep_uv_kernel<T><<<blocks, CUT_THREADS, 0, s>>>(A);
  } else {
    if (wv == nullptr || wf == nullptr || eta_av == nullptr || U_av == nullptr ||
        V_av == nullptr)
      return (int)cudaErrorInvalidValue;
    substep_eta_kernel<T><<<blocks, CUT_THREADS, 0, s>>>(A);
  }
  return (int)cudaGetLastError();
}

extern "C" {

// Returns the CUDA error of the cooperative launch (0 on success). All
// pointers are device pointers: `rows` the (5, Y) metric rows, hfc and hcf
// the with-halo (X, Y) depth planes, eta0 (its halos need not be filled),
// U0, V0, GU, GV, eta_av, U_av, V_av with-halo (X, Y) arrays, `buf` six of
// them (scratch), wv, wf the (n,) weights. Runs all n substeps; eta_av
// comes out filled.
#define FUSED_SUBSTEP_ETA(NAME, T)                                            \
  int NAME(const void* rows, const void* hfc, const void* hcf,                \
           const void* eta0, const void* U0, const void* V0, const void* GU,  \
           const void* GV, const void* wv, const void* wf, void* buf,         \
           void* eta_av, void* U_av, void* V_av, int n, int nx, int ny,       \
           int hx, int hy, int xb, int yb, double g, double dtau,             \
           void* stream) {                                                    \
    return launch<T>(rows, hfc, hcf, eta0, U0, V0, GU, GV, wv, wf, buf,       \
                     eta_av, U_av, V_av, n, nx, ny, hx, hy, xb, yb, g, dtau,  \
                     stream);                                                 \
  }

FUSED_SUBSTEP_ETA(fused_substep_eta_f32, float)
FUSED_SUBSTEP_ETA(fused_substep_eta_f64, double)

// The cooperative grid a launch on the current device takes for nx x ny
// with halos hx, hy: out[0..7] = blocks, threads a block, blocks an SM,
// points a thread keeps in shared memory, rows of threads, shared memory a
// block, and the registers and local (spilled) bytes a thread has, as
// ptxas allocated them. Returns a CUDA error code.
#define FUSED_SUBSTEP_ETA_CONFIG(NAME, T)                                     \
  int NAME(int nx, int ny, int hx, int hy, int* out) {                        \
    return config<T>(nx, ny, hx, hy, out);                                    \
  }

FUSED_SUBSTEP_ETA_CONFIG(fused_substep_eta_config_f32, float)
FUSED_SUBSTEP_ETA_CONFIG(fused_substep_eta_config_f64, double)

// The cut form's half `half` of substep i (0: U', V' on the interior
// points; 1: the averages and eta'), one launch on `stream`; returns the
// CUDA error. Device pointers: `rows` the (5, Y) metric rows, hfc and hcf
// the (X, Y) depth planes, GU, GV, U_in, V_in, eta, U, V, eta_av, U_av,
// V_av with-halo (X, Y) arrays, wv and wf the (n,) weights; half 0 reads
// rows, hfc, hcf, GU, GV, U_in, V_in and eta and writes U and V (U_in may
// be U), half 1 reads rows, wv, wf, U and V and writes eta, eta_av, U_av
// and V_av (from zero at i = 0). The caller fills eta before half 0 and
// U, V between the halves.
#define FUSED_SUBSTEP_CUT(NAME, T)                                            \
  int NAME(int half, const void* rows, const void* hfc, const void* hcf,      \
           const void* GU, const void* GV, const void* U_in,                  \
           const void* V_in, const void* wv, const void* wf, void* eta,       \
           void* U, void* V, void* eta_av, void* U_av, void* V_av, int i,     \
           int nx, int ny, int hx, int hy, double g, double dtau,             \
           void* stream) {                                                    \
    return cut_half<T>(half, rows, hfc, hcf, GU, GV, U_in, V_in, wv, wf, eta, \
                       U, V, eta_av, U_av, V_av, i, nx, ny, hx, hy, g, dtau,  \
                       stream);                                               \
  }

FUSED_SUBSTEP_CUT(fused_substep_cut_f32, float)
FUSED_SUBSTEP_CUT(fused_substep_cut_f64, double)

}  // extern "C"
