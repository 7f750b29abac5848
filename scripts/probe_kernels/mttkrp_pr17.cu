// Blocked sorted-COO MTTKRP for Hopper (sm_90a), fp32 throughout.
//
// Replaces the TPU kernel src/repro/kernels/mttkrp_pallas.py::_kernel
// (launched by mttkrp_pallas_call).  It computes the same function on the
// same BlockPlan layout:
//
//     out[block_it[b]*tile_i + iloc[s], :] +=
//         vals[s] * prod_n F_n[block_in[n][b]*in_tiles[n] + in_locs[n][s], :]
//
// for every slot s of every plan block b, with 2, 3 or 4 input modes
// (3-, 4- and 5-mode tensors; the template parameter N_IN plays the part of
// the Pallas template unroll).
//
// Design, and how it differs from the TPU kernel:
//   * The Pallas grid walks blocks in order on one core and keeps the output
//     tile resident across its run.  Blocks here run in parallel on 132 SMs,
//     so the kernel parallelises over plan blocks (hundreds of thousands at
//     NELL-2 size), not over output-tile runs (36-113 per mode, too few to
//     fill the card): each CTA takes one contiguous range of plan blocks.
//   * The output tile being summed lives in shared memory, as the Pallas
//     kernel keeps its accumulator in VMEM: tile_i x ld floats, 16 KB at
//     the default tile_i = 256 and rank 16.  Where that does not fit in a
//     CTA (rank above about 200 at tile_i = 256, or a tile_i above about
//     3,500 at rank 16), a grid dimension splits the tile into `parts` of
//     `rows` rows, chosen at launch from the shared-memory budget: each CTA
//     keeps only the slots whose row falls in its part, so every product
//     is still taken once.  Only where not even one row of ld floats fits
//     are the columns split too, into `col_slices` of `slice` columns (a
//     multiple of 4).  The CTAs of one block range run side by side, so
//     they re-read the same stream from L2.  At rank 16 and the default
//     tile_i there is one part and one slice.  Contributions go to the tile with
//     shared-memory atomics; when the range moves to the next output tile,
//     and at its end, the non-zero partial sums are added to the output in
//     device memory with one global atomic each.  Blocks are sorted by
//     output tile, so a CTA flushes about once per range: the hot rows of a
//     skewed tensor see one global atomic per CTA instead of one per
//     non-zero (which serialised on a few addresses in L2).
//   * Factor rows are gathered straight from global memory through L2
//     instead of staging input tiles in shared memory: the factors of a
//     rank-16 NELL-2 decomposition (~3 MB) fit in the 50 MB L2.
//   * Threads map to (non-zero, rank column), so neighbouring threads touch
//     neighbouring columns of one row: gathers are coalesced row segments
//     and shared atomics fall in distinct banks.
//   * Slots whose value is exactly 0 are skipped: they contribute exactly 0,
//     and plans are 28-99% padding.  Each chunk of a block is first compacted
//     in shared memory, so the compute phase only walks real non-zeros.
//
// Bound: memory bytes, not operations.  Each non-zero moves its value and
// N indices (16 B for 3 modes) and gathers N-1 factor rows, and does only
// N flops per rank column, far below the card's fp32 rate per byte.
//
// Sum order: the atomics make the order in which contributions reach an
// output element vary from run to run, so results differ from the plain
// version (and from one run to the next) in the last bits of float32.
//
// Offsets into the stream and into the factors are computed in 64 bits.
// The kernel allocates nothing and does not synchronise; the wrapper
// (kernels/mttkrp.py) zeroes the output, checks every argument, and raises
// on a non-zero return code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxIn = 4;
constexpr int kThreads = 256;
constexpr int kMinSlice = 8;  // the narrowest column slice the launch chooses

struct Args {
  const float* vals;
  const int* iloc;
  const int* block_it;
  const int* in_locs[kMaxIn];
  const int* block_in[kMaxIn];
  const float* factors[kMaxIn];
  int in_tiles[kMaxIn];
  float* out;
  int64_t nblocks;
  int blk;
  int tile_i;
  int ld;          // row stride of every factor and of out: the padded rank
  int rows;        // tile rows per CTA: ceil(tile_i / parts)
  int parts;       // row parts of an output tile
  int slice;       // columns per CTA: ld, or a multiple of 4 below it
  int col_slices;  // column slices: ceil(ld / slice)
  int slices;      // CTAs per block range: parts * col_slices
};

// Add the tile's non-zero partial sums to the output rows row0.. of output
// tile `tile` (rows_here of them), columns c_lo.., and zero the tile.  Each
// thread reads and clears only its own elements.
__device__ __forceinline__ void flush_tile(const Args& a, float* s_tile, int tile, int row0, int rows_here,
                                           int c_lo, int width) {
  const int elems = rows_here * width;
  float* dst = a.out + (static_cast<int64_t>(tile) * a.tile_i + row0) * a.ld + c_lo;
  for (int i = threadIdx.x; i < elems; i += kThreads) {
    const float x = s_tile[i];
    s_tile[i] = 0.0f;
    if (x != 0.0f) {
      const int r = i / width;
      atomicAdd(dst + static_cast<int64_t>(r) * a.ld + (i - r * width), x);
    }
  }
}

// PARTS: the tile is split into row parts (else the CTA takes every row, and
// the kernel keeps no part bounds live: the single-part case stays as lean
// as before parts existed).
template <int N_IN, bool PARTS>
__global__ void __launch_bounds__(kThreads) mttkrp_blocked_kernel(const Args a) {
  extern __shared__ float s_tile[];  // rows x width partial sums
  // The current chunk's non-zeros, compacted: value, row offset within the
  // tile and one input row offset per input mode (offsets times ld).
  __shared__ float s_val[kThreads];
  __shared__ int s_row[kThreads];
  __shared__ int64_t s_in[N_IN][kThreads];
  __shared__ int s_count;

  // CTA b takes (row part, column slice) b % slices of block range
  // b / slices.
  const int64_t range = blockIdx.x / a.slices;
  const int64_t ranges = gridDim.x / a.slices;
  const int sub = static_cast<int>(blockIdx.x % a.slices);
  const int row0 = PARTS ? (sub / a.col_slices) * a.rows : 0;  // first tile row of this CTA
  const int rows_here = !PARTS ? a.tile_i : a.tile_i - row0 < a.rows ? a.tile_i - row0 : a.rows;
  const int c_lo = (PARTS ? sub % a.col_slices : sub) * a.slice;
  const int width = a.ld - c_lo < a.slice ? a.ld - c_lo : a.slice;  // this CTA's columns
  for (int i = threadIdx.x; i < rows_here * width; i += kThreads) s_tile[i] = 0.0f;

  const int64_t per = (a.nblocks + ranges - 1) / ranges;
  const int64_t b_begin = range * per;
  const int64_t b_end = b_begin + per < a.nblocks ? b_begin + per : a.nblocks;
  int cur_tile = -1;
  for (int64_t b = b_begin; b < b_end; ++b) {
    const int tile = a.block_it[b];
    if (tile != cur_tile) {
      // Every thread passed the previous chunk's closing barrier, so the
      // tile holds all of the previous run's contributions.
      if (cur_tile >= 0) {
        flush_tile(a, s_tile, cur_tile, row0, rows_here, c_lo, width);
      }
      cur_tile = tile;
    }
    int64_t in_base[N_IN];
#pragma unroll
    for (int n = 0; n < N_IN; ++n) {
      in_base[n] = static_cast<int64_t>(a.block_in[n][b]) * a.in_tiles[n];
    }
    for (int c0 = 0; c0 < a.blk; c0 += kThreads) {
      if (threadIdx.x == 0) s_count = 0;
      __syncthreads();  // tile cleared and count reset before anyone adds
      const int z = c0 + static_cast<int>(threadIdx.x);
      if (z < a.blk) {
        const int64_t slot = b * a.blk + z;
        const float v = a.vals[slot];
        const int row = PARTS && v != 0.0f ? a.iloc[slot] - row0 : 0;  // this CTA's rows only
        if (v != 0.0f && (!PARTS || (row >= 0 && row < rows_here))) {
          const int k = atomicAdd(&s_count, 1);
          s_val[k] = v;
          s_row[k] = (PARTS ? row : a.iloc[slot]) * width;
#pragma unroll
          for (int n = 0; n < N_IN; ++n) {
            s_in[n][k] = (in_base[n] + a.in_locs[n][slot]) * a.ld + c_lo;
          }
        }
      }
      __syncthreads();
      const int items = s_count * width;
      for (int e = threadIdx.x; e < items; e += kThreads) {
        const int k = e / width;
        const int c = e - k * width;
        float p = s_val[k];
#pragma unroll
        for (int n = 0; n < N_IN; ++n) {
          p *= __ldg(a.factors[n] + s_in[n][k] + c);
        }
        atomicAdd(&s_tile[s_row[k] + c], p);
      }
      __syncthreads();  // the compacted list and the tile are complete
    }
  }
  if (cur_tile >= 0) {
    flush_tile(a, s_tile, cur_tile, row0, rows_here, c_lo, width);
  }
}

// Shape the tile and launch: the whole tile_i x ld tile when it fits beside
// the kernel's static arrays, else the fewest row parts (a power of two)
// whose rows of ld floats fit, and only where not one row fits, single rows
// in the fewest column slices of a multiple of 4 columns that fit; one CTA
// per (block range, part, slice), at most one wave of block ranges.
// Returns 0, -1 when not even one row of the narrowest slice fits, else a
// cudaError_t.
template <int N_IN>
int launch(Args a, int device, cudaStream_t stream) {
  cudaFuncAttributes attr;  // the static arrays, the same with or without parts
  cudaError_t err = cudaFuncGetAttributes(&attr, mttkrp_blocked_kernel<N_IN, false>);
  if (err != cudaSuccess) return static_cast<int>(err);
  int optin = 0, sms = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long avail = (static_cast<long long>(optin) - static_cast<long long>(attr.sharedSizeBytes)) /
                          static_cast<long long>(sizeof(float));  // floats that fit
  a.parts = 1;
  while (a.parts < a.tile_i && static_cast<long long>((a.tile_i + a.parts - 1) / a.parts) * a.ld > avail) {
    a.parts *= 2;
  }
  if (a.parts > a.tile_i) a.parts = a.tile_i;
  a.rows = (a.tile_i + a.parts - 1) / a.parts;
  a.parts = (a.tile_i + a.rows - 1) / a.rows;
  if (static_cast<long long>(a.rows) * a.ld <= avail) {
    a.slice = a.ld;
  } else {  // one row per part, and not even that fits: column slices
    const int narrowest = a.ld < kMinSlice ? a.ld : kMinSlice;
    if (avail < narrowest) return -1;
    const int widest = static_cast<int>(avail) / 4 * 4;
    const int slices = (a.ld + widest - 1) / widest;
    a.slice = ((a.ld + slices - 1) / slices + 3) / 4 * 4;
  }
  a.col_slices = (a.ld + a.slice - 1) / a.slice;
  if (static_cast<long long>(a.parts) * a.col_slices > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.slices = a.parts * a.col_slices;
  const auto kernel = a.parts > 1 ? mttkrp_blocked_kernel<N_IN, true> : mttkrp_blocked_kernel<N_IN, false>;
  const size_t smem = static_cast<size_t>(a.rows) * a.slice * sizeof(float);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return -1;
  long long ranges = static_cast<long long>(sms) * per_sm / a.slices;
  if (ranges < 1) ranges = 1;
  if (ranges > a.nblocks) ranges = a.nblocks;
  if (ranges * a.slices > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(ranges * a.slices), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`.  The pointer arrays hold n_in device pointers each,
// in plan.in_modes order.  Any tile_i and ld run.  Returns 0 on success,
// -1 when not even one row of min(ld, kMinSlice) floats fits in a CTA's
// shared memory (it always does on sm_90), else a cudaError_t.
extern "C" int mttkrp_blocked_launch(
    const float* vals, const int* iloc, const int* block_it,
    const int* const* in_locs, const int* const* block_in,
    const float* const* factors, const int* in_tiles, int n_in,
    long long nblocks, int blk, int tile_i, int ld, float* out,
    int device, void* stream) {
  if (n_in < 2 || n_in > kMaxIn || blk < 1 || tile_i < 1 || ld < 1 || nblocks < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nblocks == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);

  Args a{};
  a.vals = vals;
  a.iloc = iloc;
  a.block_it = block_it;
  for (int n = 0; n < n_in; ++n) {
    a.in_locs[n] = in_locs[n];
    a.block_in[n] = block_in[n];
    a.factors[n] = factors[n];
    a.in_tiles[n] = in_tiles[n];
  }
  a.out = out;
  a.nblocks = nblocks;
  a.blk = blk;
  a.tile_i = tile_i;
  a.ld = ld;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_in) {
    case 2: return launch<2>(a, device, s);
    case 3: return launch<3>(a, device, s);
    default: return launch<4>(a, device, s);
  }
}
