// Shared-memory tiles, shared by the tiled kernels K3a
// (fused_shallow_water_tendencies.cu) and K4b (fused_hydrostatic_tendencies.cu):
// asynchronous copies from global to shared memory and division by a
// run-time extent without an integer divide.
//
// copy_async issues one element's copy (cp.async, sm_80 and later) without
// passing it through registers; copy_async_commit closes the group of
// copies this thread has issued since the last commit; copy_async_wait<N>
// waits until at most N of this thread's groups are still in flight. A
// __syncthreads() after the wait makes every thread's copies visible to the
// whole block.
//
// Why cp.async and not TMA: TMA tensor maps need every global stride to be
// a multiple of 16 bytes, and neither kernel's arrays have one (K3a's fp32
// rows are (16384 + 6) x 4 = 65,560 bytes; K4b's z rows 30 x 4 = 120
// bytes). Element copies take any stride, and a warp's 32 copies of
// consecutive elements coalesce as ordinary loads do.
//
// Without __CUDA_ARCH__ (a host compiler rehearsing the kernels) the copy
// is a plain assignment and the group calls do nothing.
#pragma once

template <typename T>
__device__ __forceinline__ void copy_async(T* dst_shared, const T* src_global) {
#if defined(__CUDA_ARCH__)
  const unsigned dst = (unsigned)__cvta_generic_to_shared(dst_shared);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(src_global), "n"(sizeof(T))
               : "memory");
#else
  *dst_shared = *src_global;
#endif
}

__device__ __forceinline__ void copy_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

template <int N>
__device__ __forceinline__ void copy_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// Copy the box [i0, i1) x [j0, j1) x [k0, k1) of an array of strides (sx,
// sy, 1) into shared memory laid out with strides (bsx, bsy, 1) from (bi0,
// bj0, bk0); the caller clips the box to the array. Each warp copies whole
// rows along k (its lanes on consecutive elements, so the copies coalesce),
// and the block's warps share the rows: one index division per row.
template <typename T>
__device__ __forceinline__ void copy_box_async(T* dst, const T* __restrict__ src,
                                               long long sx, long long sy,
                                               int i0, int i1, int j0, int j1,
                                               int k0, int k1, int bi0, int bj0,
                                               int bk0, int bsx, int bsy) {
  const int nj = j1 - j0, rows = (i1 - i0) * nj;
  const int lane = threadIdx.x % 32, warps = blockDim.x / 32;
  for (int r = threadIdx.x / 32; r < rows; r += warps) {
    const int i = i0 + r / nj, j = j0 + r % nj;
    T* const d = dst + (i - bi0) * bsx + (j - bj0) * bsy - bk0;
    const T* const s = src + i * sx + j * sy;
    for (int k = k0 + lane; k < k1; k += 32) copy_async(d + k, s + k);
  }
}

// n / d for 0 <= n < 2^31 by a multiply and a shift (Granlund and
// Montgomery's method, as CUTLASS's FastDivmod): m = ceil(2^p / d) with
// p = 31 + ceil(log2 d), n / d = umulhi(n, m) >> (p - 32). The host makes
// it once per launch for a divisor that is the same in every block.
struct FastDiv {
  unsigned d, m, s;
  __device__ __forceinline__ int div(int n) const {
    return d == 1 ? n : (int)(__umulhi((unsigned)n, m) >> s);
  }
};

static inline FastDiv fast_div(unsigned d) {
  if (d <= 1) return FastDiv{1u, 0u, 0u};
  unsigned l = 0;
  while ((1u << l) < d) ++l;  // ceil(log2 d)
  const unsigned long long m = ((1ull << (31 + l)) + d - 1) / d;
  return FastDiv{d, (unsigned)m, l - 1};
}
