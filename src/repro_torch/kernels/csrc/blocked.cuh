// What the row-sorting kernels on the BlockPlan layout share (csrc/ttmc.cu,
// csrc/ttcore.cu): the CTA shape, the CTA-wide scan of the counting sort,
// the shared-memory budget, and the launch over ranges of plan blocks with
// `slices` CTAs each; for the TTMc kernel also the column slice and the
// tile's flush (the TT-core kernel splits its tile its own way).  Each kernel
// library is one translation unit that includes this header once, so
// everything here has internal linkage.
//
// launch_ranges needs Args with nblocks and slices; flush_tile also out,
// tile_i, ldo and slice.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = kThreads;   // most slots compacted per step, one per thread
constexpr int kMaxSlice = 64;      // columns per CTA
constexpr int kMinSlice = 8;       // at most 32 segments per step
constexpr int kBlocksPerCta = 64;  // bounds a tile element's float32 sum chain
constexpr int kWarps = kThreads / 32;

// Add the slice's non-zero partial sums to the output and zero the tile.
// Each thread reads and clears only its own elements.
template <class Args>
__device__ __forceinline__ void flush_tile(const Args& a, float* s_tile, int tile) {
  const int elems = a.tile_i * a.slice;
  float* dst = a.out + static_cast<int64_t>(tile) * a.tile_i * a.ldo +
               static_cast<int64_t>(blockIdx.x % a.slices) * a.slice;
  for (int i = threadIdx.x; i < elems; i += kThreads) {
    const float x = s_tile[i];
    s_tile[i] = 0.0f;
    if (x != 0.0f) {  // columns past ncols are never added to, so stay 0
      const int r = i / a.slice;
      atomicAdd(dst + static_cast<int64_t>(r) * a.ldo + (i - r * a.slice), x);
    }
  }
}

// Exclusive prefix sum of s[0..n) in place, by all threads of the CTA; returns
// the total.  Each thread scans a contiguous run of entries; the runs' sums
// are scanned across the CTA with warp shuffles.
__device__ int exclusive_scan(int* s, int n, int* s_warp) {
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = static_cast<int>(threadIdx.x) * per;
  const int hi = lo + per < n ? lo + per : n;
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += s[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = sum;  // inclusive scan within the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  int run = x - sum, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int t = s_warp[w];
    if (w < warp) run += t;
    total += t;
  }
  for (int i = lo; i < hi; ++i) {
    const int c = s[i];
    s[i] = run;
    run += c;
  }
  __syncthreads();
  return total;
}

// The column slice for `ncols` output columns: the least power of two in
// [kMinSlice, kMaxSlice] that holds them, else kMaxSlice.  A launch halves
// it (down to kMinSlice) only where a tile_i x slice tile would leave no
// room for the slots of a step.
inline int slice_for(long long ncols) {
  int slice = kMinSlice;
  while (slice < kMaxSlice && slice < ncols) slice *= 2;
  return slice;
}

// Bytes of dynamic shared memory a CTA of `kernel` may take on `device`:
// the opt-in limit per block less the kernel's static arrays.  Returns 0 or
// a cudaError_t.
template <class Kernel>
int dynamic_budget(Kernel kernel, int device, size_t* bytes) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *bytes = static_cast<size_t>(optin) > attr.sharedSizeBytes
               ? static_cast<size_t>(optin) - attr.sharedSizeBytes : 0;
  return 0;
}

// Launch `kernel` with `smem` bytes of dynamic shared memory on `stream`:
// at least one wave of CTAs over all slices, and ranges of at most
// kBlocksPerCta blocks; one CTA per (range, slice).  Returns 0, -1 when the
// shared memory does not fit in a CTA, else a cudaError_t.
template <class Kernel, class Args>
int launch_ranges(Kernel kernel, const Args& a, size_t smem, int device, cudaStream_t stream) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int optin = 0, sms = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem + attr.sharedSizeBytes > static_cast<size_t>(optin)) return -1;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return -1;
  long long ranges = static_cast<long long>(sms) * per_sm / a.slices;
  const long long short_ranges = (a.nblocks + kBlocksPerCta - 1) / kBlocksPerCta;
  if (ranges < short_ranges) ranges = short_ranges;
  if (ranges < 1) ranges = 1;
  if (ranges > a.nblocks) ranges = a.nblocks;
  if (ranges * a.slices > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(ranges * a.slices), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
