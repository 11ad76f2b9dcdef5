// Batched tridiagonal (Thomas) solve along z (T1): for every column of a
// right-hand side d with z the fastest axis,
//
//   denom = b[k] - a[k] cp[k-1],  cp[k] = c[k] / denom,
//   dp[k] = (d[k] - a[k] dp[k-1]) / denom,  phi[k] = dp[k] - cp[k] phi[k+1]
//
// (cp[-1] = dp[-1] = phi[nz] = 0), in the expression trees of the port's
// plain version (solvers/tridiagonal.py::solve_batched_tridiagonal_reference)
// and of the JAX function it follows,
// clima_oceananigans_jl_tpu/solvers/tridiagonal.py::solve_batched_tridiagonal,
// which runs the two sweeps as lax.scans over (Nx, Ny) planes (the TPU has no
// Pallas kernel for it). Each band is 1D (nz values, shared by every column)
// or 3D (a value a point). A complex right-hand side comes as interleaved
// (re, im) pairs (NV = 2): both parts share denom and cp, as the plain
// version's two real solves compute them. d, phi and the 3D bands are
// (nx, ny, nz) arrays of any (x, y) strides with z contiguous, so a view of
// the interior levels of a with-halo field is read and written in place.
//
// The Fourier mode (T1_FOURIER) forms the bands of the Fourier-tridiagonal
// pressure solve (solvers/fourier_tridiagonal.py) in the kernel, in the plain
// version's trees: for mode (i, j) of a (nx', ny') spectrum, lam_h =
// (lam_x[i] + lam_y[j]) - m, a = lower[k], c = upper[k], b = -(lower[k] +
// upper[k]) - lam_h dzc[k] and d = rhs dzc[k]; with `pin`, the first row of
// mode (0, 0) becomes phi = 0 (b = 1, c = 0, d = 0).
//
// Every division is ieee_div (weno5_advection.cuh): IEEE's own quotient,
// off the slow path. Build with --fmad=false so that b - a cp stays two
// roundings, as eager PyTorch computes it.
//
// What bounds it on an H100: at 256 x 129 x 256 complex64 (the 256^3
// pressure solve after a real FFT on x) it must read d (67.6 MB) and write
// phi (67.6 MB): 0.04 ms at 3.35 TB/s; ~8 operations a point and part are
// far below the card's rate. One column is a serial chain of dependent
// divisions, so the card needs many columns in flight, and with z fastest
// the columns of a warp lie nz elements apart. The design:
//
// - A warp owns 32 consecutive columns (a tile). It stages a chunk of KC
//   levels of each column in shared memory (T1_ROW_BYTES, one 128-byte run
//   of d a column: KC = 32 fp32 levels, 16 complex64 or fp64, 8
//   complex128) with element cp.async copies (tiles.cuh: the column pitch
//   of a with-halo view is not 16-byte aligned, so no TMA), lanes on
//   consecutive elements of a column so the copies coalesce (two or four
//   columns an instruction where a row is shorter than 32 elements), each
//   lane finding its column's offset itself so that the copies pipeline;
//   then each lane sweeps its own column in the tile (row stride KC NV + 1:
//   no bank conflicts), the level loops unrolled so that the loads of the
//   next levels overlap the chain of divisions. T1_STAGES buffers: the
//   next chunk loads while one is swept. The chunk of each 1D band (the
//   Fourier mode's lower, upper and dzc) rides along in a row every lane
//   reads.
// - dp overwrites d in the tile; the forward sweep writes dp (and, where cp
//   differs between columns, cp) back chunk by chunk, coalesced, except the
//   last chunk, which stays in the tile for the back sweep; the back sweep
//   reads the chunks again in reverse order and writes phi over them.
//   Every copy in or out gives an element of a tile to the same lane, so a
//   lane reads back only what it wrote itself.
// - Where the column fits in one chunk (nz <= KC, the 1/4 deg grid's 24
//   levels in fp32), that chunk is the last: it stays in the tile through
//   both sweeps, so d is read once and phi written once.
// - With three 1D bands (T1_TABLE), denom and cp are the same in every
//   column. A warp's first tile computes them lane by lane as the other
//   modes do and writes them (the same values from every lane) to a table
//   in the warp's own shared memory; its later tiles read denom from the
//   table (no cp division) and every back sweep reads cp there, so no cp
//   leaves the SM. The same operands and operations give the same bits. (A
//   table made once a block before any sweep would put nz dependent
//   divisions in front of every block.) Blocks are persistent (as many as
//   fit on the card at once) so that a warp walks several tiles where
//   there are many.
// - With a 3D band (T1_COLUMN) or in the Fourier mode, cp is a column's own:
//   it goes through the tile to a scratch array (ncol x nz) between the
//   sweeps; 3D bands are staged beside d, and cp overwrites c in its tile.
//
// The launcher picks the mode from the shapes, once a call (t1_plan).
#include <cuda_runtime.h>
#include <stdint.h>

#include "tiles.cuh"
#include "weno5_advection.cuh"

constexpr int T1_ROW_BYTES = 128;   // bytes of d a column's chunk holds
constexpr int T1_WARPS = 4;         // warps a block, each with its own tiles
constexpr int T1_STAGES = 2;        // chunk buffers a warp
constexpr int T1_TABLE_BYTES = 8192;  // a warp's table of denom and cp at most

enum { T1_TABLE = 0, T1_COLUMN = 1, T1_FOURIER = 2 };

template <typename T, int NV, int MODE>
struct T1Shape {
  static constexpr int KC = T1_ROW_BYTES / (int)(sizeof(T) * NV);  // levels a chunk
  static constexpr int RS = KC * NV + 1;  // row stride of the d tile
  static constexpr int RB = KC + 1;       // row stride of a band or cp tile
  // band tiles a stage: a, b, c (cp over c) in the column mode, cp in the
  // Fourier mode, none with the table
  static constexpr int NB = MODE == T1_COLUMN ? 3 : MODE == T1_FOURIER ? 1 : 0;
  static constexpr int CP = MODE == T1_COLUMN ? 2 : 0;  // the tile cp goes to
  // then three rows of KC: the chunk of each 1D band (a, b, c; in the
  // Fourier mode lower, upper, dzc), read by every lane
  static constexpr int STAGE = 32 * RS + NB * 32 * RB + 3 * KC;  // elements a stage
  // levels a sweep's loop unrolls: fp64 keeps fewer values live across the
  // call of its division's slow path, or ptxas spills around it
  static constexpr int UNROLL = sizeof(T) == 4 ? 4 : 1;
};

template <typename T>
struct TriArgs {
  const T* a;    // lower band (Fourier mode: `lower`, 1D)
  const T* b;    // diagonal (unused in the Fourier mode)
  const T* c;    // upper band (Fourier mode: `upper`, 1D)
  int a3, b3, c3;  // band is 3D (nx x ny x nz) rather than 1D (nz)
  int64_t sa[2], sb[2], sc[2];  // (x, y) strides of the 3D bands, in elements
  const T* d;    // right-hand side, (x, y) strides sd, then nz x NV contiguous
  int64_t sd[2];
  T* out;        // phi, (x, y) strides so (dp between the sweeps)
  int64_t so[2];
  T* cp;         // scratch, ncol x nz (column and Fourier modes, chunked)
  int64_t sp[2];  // its (x, y) strides: ny nz, nz
  int ncol, nz, ntiles;
  FastDiv ny;    // column -> (i, j)
  // the Fourier mode
  const T* lx;   // lam_x, nx' values
  const T* ly;   // lam_y, ny' values
  const T* dzc;  // cell widths, nz values
  T m;
  int pin;
};

// A warp's tile: its first column, how many of its 32 columns exist, and
// in the Fourier mode the lane's lam_h and whether it holds the pinned row.
template <typename T>
struct T1Col {
  int col0, n;
  T lh;
  bool pin0;
};

template <typename T, int MODE>
__device__ __forceinline__ T1Col<T> t1_column(const TriArgs<T>& A, int t, int lane) {
  T1Col<T> C;
  C.col0 = t * 32;
  C.n = min(32, A.ncol - C.col0);
  C.lh = T(0);
  C.pin0 = false;
  if constexpr (MODE == T1_FOURIER) {
    const int col = min(C.col0 + lane, A.ncol - 1);
    const int i = A.ny.div(col), j = col - i * (int)A.ny.d;
    C.lh = (A.lx[i] + A.ly[j]) - A.m;
    C.pin0 = A.pin && i == 0 && j == 0;
  }
  return C;
}

// The warp copies `len` consecutive elements of each of the tile's n
// columns between g (an array of (x, y) strides st) and the rows of a tile
// (row stride rs, RW elements a row at most): 32 / RW columns an
// instruction, element e of column cc by lane (cc % (32 / RW)) RW + e, in
// both directions; each lane finds its column's offset itself (no
// shuffles), so the columns' copies are independent and pipeline.
template <int RW, typename T>
__device__ __forceinline__ void t1_rows_in(T* tile, int rs, const T* g, const int64_t* st,
                                           const FastDiv& ny, const T1Col<T>& C,
                                           int len, int lane) {
  constexpr int PER = 32 / RW;
  const int e = lane % RW;
  if (e >= len) return;
#pragma unroll 4
  for (int cc = lane / RW; cc < C.n; cc += PER) {
    const int col = C.col0 + cc, i = ny.div(col), j = col - i * (int)ny.d;
    copy_async(tile + cc * rs + e, g + (i * st[0] + j * st[1]) + e);
  }
}

template <int RW, typename T>
__device__ __forceinline__ void t1_rows_out(T* g, const int64_t* st, const FastDiv& ny,
                                            const T1Col<T>& C, const T* tile, int rs,
                                            int len, int lane) {
  constexpr int PER = 32 / RW;
  const int e = lane % RW;
  if (e >= len) return;
#pragma unroll 4
  for (int cc = lane / RW; cc < C.n; cc += PER) {
    const int col = C.col0 + cc, i = ny.div(col), j = col - i * (int)ny.d;
    g[(i * st[0] + j * st[1]) + e] = tile[cc * rs + e];
  }
}

template <typename T, int NV, int MODE>
__global__ void __launch_bounds__(T1_WARPS * 32)
batched_tridiagonal_kernel(const __grid_constant__ TriArgs<T> A) {
  using S = T1Shape<T, NV, MODE>;
  constexpr int KC = S::KC;
  extern __shared__ __align__(16) unsigned char t1_smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nz = A.nz, nch = (nz + KC - 1) / KC;
  const int table = MODE == T1_TABLE ? 2 * nz : 0;
  T* const mine = reinterpret_cast<T*>(t1_smem) +
                  (size_t)warp * (table + T1_STAGES * S::STAGE);
  T* const tab_den = mine;
  T* const tab_cp = mine + nz;
  T* const stages = mine + table;
  auto dtile = [&](int s) { return stages + s * S::STAGE; };
  auto btile = [&](int s, int q) { return stages + s * S::STAGE + 32 * S::RS + q * 32 * S::RB; };
  auto brow = [&](int s, int q) {
    return stages + s * S::STAGE + 32 * S::RS + S::NB * 32 * S::RB + q * KC;
  };
  auto levels = [&](int ch) { return min(KC, nz - ch * KC); };

  constexpr int RD = KC * NV;  // elements of d a column's chunk
  // d, the 3D bands' tiles and the 1D bands' rows of chunk ch into stage s
  auto load_forward = [&](const T1Col<T>& C, int ch, int s) {
    const int k0 = ch * KC, L = levels(ch);
    t1_rows_in<RD>(dtile(s), S::RS, A.d + (int64_t)k0 * NV, A.sd, A.ny, C, L * NV, lane);
    const T* const band[3] = {A.a, MODE == T1_FOURIER ? A.dzc : A.b, A.c};
    const int in3d[3] = {A.a3, A.b3, A.c3};
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      if (MODE == T1_COLUMN && in3d[q])
        t1_rows_in<KC>(btile(s, q), S::RB, band[q] + k0, q == 0 ? A.sa : q == 1 ? A.sb : A.sc,
                       A.ny, C, L, lane);
      else if (lane < L)
        copy_async(brow(s, q) + lane, band[q] + k0 + lane);
    }
    copy_async_commit();
  };
  // dp (and cp) of chunk ch into stage s, as the forward sweep stored them
  auto load_back = [&](const T1Col<T>& C, int ch, int s) {
    const int k0 = ch * KC, L = levels(ch);
    t1_rows_in<RD>(dtile(s), S::RS, A.out + (int64_t)k0 * NV, A.so, A.ny, C, L * NV, lane);
    if constexpr (MODE != T1_TABLE)
      t1_rows_in<KC>(btile(s, S::CP), S::RB, A.cp + k0, A.sp, A.ny, C, L, lane);
    copy_async_commit();
  };
  auto store_forward = [&](const T1Col<T>& C, int ch, int s) {
    const int k0 = ch * KC, L = levels(ch);
    t1_rows_out<RD>(A.out + (int64_t)k0 * NV, A.so, A.ny, C, dtile(s), S::RS, L * NV, lane);
    if constexpr (MODE != T1_TABLE)
      t1_rows_out<KC>(A.cp + k0, A.sp, A.ny, C, btile(s, S::CP), S::RB, L, lane);
  };
  auto store_phi = [&](const T1Col<T>& C, int ch, int s) {
    t1_rows_out<RD>(A.out + (int64_t)ch * KC * NV, A.so, A.ny, C, dtile(s), S::RS,
                    levels(ch) * NV, lane);
  };

  // the forward sweep of chunk ch in stage s, the lane's own column; with
  // `tabled` (T1_TABLE, after the warp's first tile) denom comes from the
  // table. A band is read through a pointer to its tile row (3D) or to the
  // stage's row of its chunk (1D).
  auto forward = [&](const T1Col<T>& C, int ch, int s, bool tabled, T& cpp, T* dpp) {
    if (lane >= C.n) return;
    const int k0 = ch * KC, L = levels(ch);
    T* const row = dtile(s) + lane * S::RS;
    T* const rcp = btile(s, S::CP) + lane * S::RB;
    const T* const pa = MODE == T1_COLUMN && A.a3 ? btile(s, 0) + lane * S::RB : brow(s, 0);
    const T* const pb = MODE == T1_COLUMN && A.b3 ? btile(s, 1) + lane * S::RB : brow(s, 1);
    const T* const pc = MODE == T1_COLUMN && A.c3 ? btile(s, 2) + lane * S::RB : brow(s, 2);
#pragma unroll (S::UNROLL)
    for (int kk = 0; kk < L; ++kk) {
      const int k = k0 + kk;
      const T a = pa[kk];
      T denom, d[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) d[v] = row[kk * NV + v];
      if constexpr (MODE == T1_TABLE) {
        if (tabled) {
          denom = tab_den[k];
        } else {
          denom = pb[kk] - a * cpp;
          cpp = ieee_div(pc[kk], denom);
          tab_den[k] = denom;  // every lane writes the same values
          tab_cp[k] = cpp;
        }
      } else if constexpr (MODE == T1_COLUMN) {
        denom = pb[kk] - a * cpp;
        cpp = ieee_div(pc[kk], denom);
        rcp[kk] = cpp;
      } else {
        const T up = pc[kk], dz = pb[kk];
        const bool pinned = C.pin0 && k == 0;
        const T b = pinned ? T(1) : -(a + up) - C.lh * dz;
        const T c = pinned ? T(0) : up;
#pragma unroll
        for (int v = 0; v < NV; ++v) d[v] = pinned ? T(0) : d[v] * dz;
        denom = b - a * cpp;
        cpp = ieee_div(c, denom);
        rcp[kk] = cpp;
      }
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        dpp[v] = ieee_div(d[v] - a * dpp[v], denom);
        row[kk * NV + v] = dpp[v];
      }
    }
  };
  // the back sweep of chunk ch in stage s: phi over dp
  auto back = [&](const T1Col<T>& C, int ch, int s, T* phi) {
    if (lane >= C.n) return;
    T* const row = dtile(s) + lane * S::RS;
    const T* const rcp = MODE == T1_TABLE ? tab_cp + ch * KC : btile(s, S::CP) + lane * S::RB;
#pragma unroll (S::UNROLL)
    for (int kk = levels(ch) - 1; kk >= 0; --kk) {
      const T cpk = rcp[kk];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        phi[v] = row[kk * NV + v] - cpk * phi[v];
        row[kk * NV + v] = phi[v];
      }
    }
  };

  bool tabled = false;
  for (int t = blockIdx.x * T1_WARPS + warp; t < A.ntiles; t += gridDim.x * T1_WARPS) {
    const T1Col<T> C = t1_column<T, MODE>(A, t, lane);
    T cpp = T(0), dpp[NV], phi[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) dpp[v] = phi[v] = T(0);
    load_forward(C, 0, 0);
    for (int ch = 0; ch < nch; ++ch) {
      const int s = ch % T1_STAGES;
      if (ch + 1 < nch) {
        load_forward(C, ch + 1, (ch + 1) % T1_STAGES);
        copy_async_wait<1>();
      } else {
        copy_async_wait<0>();
      }
      __syncwarp();
      forward(C, ch, s, tabled, cpp, dpp);
      __syncwarp();
      if (ch + 1 < nch) store_forward(C, ch, s);
    }
    // the last chunk is still in its stage
    for (int ch = nch - 1; ch >= 0; --ch) {
      const int s = ch % T1_STAGES;
      if (ch > 0) {
        load_back(C, ch - 1, (ch - 1) % T1_STAGES);
        copy_async_wait<1>();
      } else {
        copy_async_wait<0>();
      }
      __syncwarp();
      back(C, ch, s, phi);
      __syncwarp();
      store_phi(C, ch, s);
    }
    tabled = true;
  }
}

// The launch plan: mode, levels a chunk, dynamic shared memory a block.
struct T1Plan {
  int mode, kc;
  long long smem;
};

template <typename T, int NV>
static int t1_plan(int nz, int any3d, int fourier, T1Plan* P) {
  constexpr int KC = T1_ROW_BYTES / (int)(sizeof(T) * NV);
  if (nz <= 0) return (int)cudaErrorInvalidValue;
  const bool table_fits = 2LL * nz * (long long)sizeof(T) <= T1_TABLE_BYTES;
  P->mode = fourier ? T1_FOURIER : (any3d || !table_fits) ? T1_COLUMN : T1_TABLE;
  P->kc = KC;
  const int nb = P->mode == T1_COLUMN ? 3 : P->mode == T1_FOURIER ? 1 : 0;
  const long long stage = 32LL * (KC * NV + 1) + nb * 32LL * (KC + 1) + 3LL * KC;
  const long long table = P->mode == T1_TABLE ? 2LL * nz : 0;
  P->smem = T1_WARPS * (table + T1_STAGES * stage) * (long long)sizeof(T);
  return 0;
}

constexpr int T1_MAX_DEVICES = 64;

// Per device and instantiation: the SM count (0: not asked yet), the
// dynamic shared memory the kernel is allowed so far, and the blocks an SM
// takes at the last launch's shared memory (smem 0: not asked yet).
struct T1Cache {
  int sms, per_sm;
  long long allowed, smem;
};

template <typename T, int NV, int MODE>
static int launch_mode(const TriArgs<T>& A, long long smem, void* stream) {
  static T1Cache cache[T1_MAX_DEVICES];
  auto kernel = batched_tridiagonal_kernel<T, NV, MODE>;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  if (dev < 0 || dev >= T1_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  T1Cache& c = cache[dev];
  if (c.sms == 0) {
    int sms = 0;
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return (int)rc;
    c.sms = sms;
  }
  if (smem > c.allowed) {
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
    c.allowed = smem;
  }
  if (smem != c.smem) {
    int per_sm = 0;
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, T1_WARPS * 32,
                                                       (size_t)smem);
    if (rc != cudaSuccess) return (int)rc;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    c.per_sm = per_sm;
    c.smem = smem;
  }
  const long long most = (long long)c.sms * c.per_sm;
  const long long need = (A.ntiles + T1_WARPS - 1) / T1_WARPS;
  const long long blocks = need < most ? need : most;
  kernel<<<(unsigned)blocks, T1_WARPS * 32, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(A);
  return (int)cudaGetLastError();
}

template <typename T, int NV>
static int launch_nv(TriArgs<T>& A, int fourier, void* stream) {
  if (A.ncol <= 0 || A.nz <= 0) return 0;
  T1Plan P;
  const int rc = t1_plan<T, NV>(A.nz, A.a3 | A.b3 | A.c3, fourier, &P);
  if (rc != 0) return rc;
  A.ntiles = (A.ncol + 31) / 32;
  if (P.mode == T1_FOURIER) return launch_mode<T, NV, T1_FOURIER>(A, P.smem, stream);
  if (P.mode == T1_COLUMN) return launch_mode<T, NV, T1_COLUMN>(A, P.smem, stream);
  return launch_mode<T, NV, T1_TABLE>(A, P.smem, stream);
}

static bool t1_columns_fit(long long nx, long long ny) {
  return nx > 0 && ny > 0 && nx * ny < (1LL << 31) - 32;
}

template <typename T>
static int launch(const void* a, const void* b, const void* c, int a3, int b3,
                  int c3, const long long* st, const void* d, void* out,
                  void* cp, int nx, int ny, int nz, int nv,
                  void* stream) {
  if ((nv != 1 && nv != 2) || !t1_columns_fit(nx, ny)) return (int)cudaErrorInvalidValue;
  TriArgs<T> A{};
  A.a = static_cast<const T*>(a);
  A.b = static_cast<const T*>(b);
  A.c = static_cast<const T*>(c);
  A.a3 = a3; A.b3 = b3; A.c3 = c3;
  for (int q = 0; q < 2; ++q) {
    A.sa[q] = st[q];
    A.sb[q] = st[2 + q];
    A.sc[q] = st[4 + q];
    A.sd[q] = st[6 + q];
    A.so[q] = st[8 + q];
  }
  A.d = static_cast<const T*>(d);
  A.out = static_cast<T*>(out);
  A.cp = static_cast<T*>(cp);
  A.sp[0] = (int64_t)ny * nz;
  A.sp[1] = nz;
  A.ncol = nx * ny;
  A.nz = nz;
  A.ny = fast_div((unsigned)ny);
  return nv == 1 ? launch_nv<T, 1>(A, 0, stream) : launch_nv<T, 2>(A, 0, stream);
}

template <typename T>
static int launch_fourier(const void* lx, const void* ly, double m,
                          const void* lower, const void* upper,
                          const void* dzc, int pin, const void* d, void* out,
                          void* cp, int nx, int ny, int nz, int nv,
                          void* stream) {
  if ((nv != 1 && nv != 2) || !t1_columns_fit(nx, ny)) return (int)cudaErrorInvalidValue;
  TriArgs<T> A{};
  A.a = static_cast<const T*>(lower);
  A.c = static_cast<const T*>(upper);
  A.d = static_cast<const T*>(d);
  A.out = static_cast<T*>(out);
  A.cp = static_cast<T*>(cp);
  A.sd[0] = A.so[0] = (int64_t)ny * nz * nv;
  A.sd[1] = A.so[1] = (int64_t)nz * nv;
  A.sp[0] = (int64_t)ny * nz;
  A.sp[1] = nz;
  A.ncol = nx * ny;
  A.nz = nz;
  A.ny = fast_div((unsigned)ny);
  A.lx = static_cast<const T*>(lx);
  A.ly = static_cast<const T*>(ly);
  A.dzc = static_cast<const T*>(dzc);
  A.m = T(m);
  A.pin = pin;
  return nv == 1 ? launch_nv<T, 1>(A, 1, stream) : launch_nv<T, 2>(A, 1, stream);
}

extern "C" {

// The plan of a call: out[0] the mode (0 table, 1 column, 2 Fourier),
// out[1] levels a chunk, out[2] dynamic shared memory a block in bytes.
// Returns 0, or a CUDA error code for an impossible request.
int batched_tridiagonal_plan(int nz, int nv, int elem_size, int any3d,
                             int fourier, long long* out) {
  T1Plan P{};
  int rc = (int)cudaErrorInvalidValue;
  if (elem_size == 4 && nv == 1) rc = t1_plan<float, 1>(nz, any3d, fourier, &P);
  if (elem_size == 4 && nv == 2) rc = t1_plan<float, 2>(nz, any3d, fourier, &P);
  if (elem_size == 8 && nv == 1) rc = t1_plan<double, 1>(nz, any3d, fourier, &P);
  if (elem_size == 8 && nv == 2) rc = t1_plan<double, 2>(nz, any3d, fourier, &P);
  if (rc == 0) {
    out[0] = P.mode;
    out[1] = P.kc;
    out[2] = P.smem;
  }
  return rc;
}

// Returns cudaGetLastError() after the launch (0 on success). Device
// pointers: bands a, b, c (1D of nz, or 3D where a3/b3/c3), d and out
// ((nx, ny, nz) x nv, nv = 2 for interleaved complex pairs), cp (scratch,
// nx x ny x nz, or null where the plan keeps cp on the SM); st: host array
// of the (x, y) strides, in elements, of a, b, c, d and out (10 values).
#define BATCHED_TRIDIAGONAL(NAME, T)                                           \
  int NAME(const void* a, const void* b, const void* c, int a3, int b3,        \
           int c3, const long long* st, const void* d, void* out, void* cp,    \
           int nx, int ny, int nz, int nv, void* stream) {                     \
    return launch<T>(a, b, c, a3, b3, c3, st, d, out, cp, nx, ny, nz, nv,      \
                     stream);                                                  \
  }

BATCHED_TRIDIAGONAL(batched_tridiagonal_f32, float)
BATCHED_TRIDIAGONAL(batched_tridiagonal_f64, double)

// The Fourier mode: lx (nx), ly (ny), lower, upper, dzc (nz) on the card,
// d and out (nx x ny x nz x nv, contiguous), cp (nx x ny x nz, or null
// where the plan keeps cp on the SM).
#define FOURIER_TRIDIAGONAL(NAME, T)                                          \
  int NAME(const void* lx, const void* ly, double m, const void* lower,       \
           const void* upper, const void* dzc, int pin, const void* d,        \
           void* out, void* cp, int nx, int ny, int nz, int nv,               \
           void* stream) {                                                    \
    return launch_fourier<T>(lx, ly, m, lower, upper, dzc, pin, d, out, cp,   \
                             nx, ny, nz, nv, stream);                         \
  }

FOURIER_TRIDIAGONAL(fourier_tridiagonal_f32, float)
FOURIER_TRIDIAGONAL(fourier_tridiagonal_f64, double)

}  // extern "C"
