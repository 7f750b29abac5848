// What the row-sorting kernels on the BlockPlan layout share (csrc/mttkrp.cu,
// csrc/ttmc.cu, csrc/ttcore.cu): the CTA shape, the counting sort of a
// chunk's real slots by tile row (two passes with warp-aggregated counts,
// 16-bit offsets) and its CTA-wide scan, the shared-memory budget, and the
// launch over ranges of plan blocks with `slices` CTAs each.  Each kernel
// library is one translation unit that includes this header once, so
// everything here has internal linkage.
//
// sort_pass needs Args with vals and iloc; launch_ranges with nblocks and
// slices.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = kThreads;   // most slots compacted per step, one per thread
constexpr int kMinSlice = 8;       // the narrowest column slice
constexpr int kBlocksPerCta = 64;  // bounds a tile element's float32 sum chain
constexpr int kWarps = kThreads / 32;
constexpr int kSortUnroll = 8;     // rounds of a sort pass whose fields are read at once, by default

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

// Count (and place) slot `row` of this lane in s_count: lanes of a warp
// with the same row add with one atomic.  Every lane of the warp calls it;
// row < 0 takes no place.  Returns the lane's place in its row.
__device__ __forceinline__ int warp_add(int* s_count, int row) {
  const unsigned peers = __match_any_sync(0xffffffffu, row);
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (lane == leader && row >= 0) base = atomicAdd(&s_count[row], __popc(peers));
  base = __shfl_sync(0xffffffffu, base, leader);
  return base + __popc(peers & ((1u << lane) - 1u));
}

// What a sort pass fetches of a slot besides its value and row: nothing
// (a kernel that keeps only the permutation).
struct NoFields {};

// One pass of the counting sort over the chunk's n slots from s0: count
// each real slot of this CTA's rows (row0.., rows_here of them) in s_count
// (with AGGREGATE, one shared-memory atomic per row and warp, else one per
// slot), and with PLACE, hand each real slot its place: place(pos, o, row, v, x),
// with o its offset in the chunk, row its row less row0, v its value and
// x = fetch(o) (NoFields where the kernel needs nothing more).  The fields
// of UNROLL rounds of kThreads slots, fetch's included, are read before any
// is counted.
template <bool PLACE, int UNROLL = kSortUnroll, bool AGGREGATE = true, class Args, class Fetch, class Place>
__device__ __forceinline__ void sort_pass(const Args& a, int* s_count, int64_t s0, int n, int row0,
                                          int rows_here, Fetch fetch, Place place) {
  using Slot = decltype(fetch(0));
  const int rounds = (n + kThreads - 1) / kThreads;
  for (int r0 = 0; r0 < rounds; r0 += UNROLL) {
    int row[UNROLL];
    float val[UNROLL];
    Slot x[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int o = (r0 + u) * kThreads + static_cast<int>(threadIdx.x);
      float v = 0.0f;
      int r = 0;
      if (o < n) {
        v = a.vals[s0 + o];
        r = a.iloc[s0 + o] - row0;
      }
      row[u] = v != 0.0f && r >= 0 && r < rows_here ? r : -1;
      val[u] = v;
      if (PLACE && row[u] >= 0) x[u] = fetch(o);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (r0 + u < rounds) {  // the same for every thread
        const int pos = AGGREGATE ? warp_add(s_count, row[u])
                                  : row[u] >= 0 ? atomicAdd(&s_count[row[u]], 1) : 0;
        if (PLACE && row[u] >= 0) {
          place(pos, (r0 + u) * kThreads + static_cast<int>(threadIdx.x), row[u], val[u], x[u]);
        }
      }
    }
  }
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
// kBlocksPerCta blocks, but of at least min_blocks (<= kBlocksPerCta) where
// that makes less than a wave; one CTA per (range, slice).  Returns 0, -1
// when the shared memory does not fit in a CTA, else a cudaError_t.
template <class Kernel, class Args>
int launch_ranges(Kernel kernel, const Args& a, size_t smem, int device, cudaStream_t stream,
                  long long min_blocks = 1) {
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
  const long long long_ranges = (a.nblocks + min_blocks - 1) / min_blocks;
  if (ranges > long_ranges) ranges = long_ranges;
  if (ranges < 1) ranges = 1;
  if (ranges > a.nblocks) ranges = a.nblocks;
  if (ranges * a.slices > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(ranges * a.slices), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
