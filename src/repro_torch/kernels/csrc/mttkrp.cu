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
//   * The output tile being summed lives in shared memory (tile_i x ld
//     floats, 16 KB at the default tile_i = 256 and rank 16), as the Pallas
//     kernel keeps its accumulator in VMEM.  Contributions go to it with
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
  int ld;  // row stride of every factor and of out: the padded rank
};

// Add the tile's non-zero partial sums to the output and zero the tile.
// Each thread reads and clears only its own elements.
__device__ __forceinline__ void flush_tile(const Args& a, float* s_tile, int tile) {
  const int elems = a.tile_i * a.ld;
  float* dst = a.out + static_cast<int64_t>(tile) * a.tile_i * a.ld;
  for (int i = threadIdx.x; i < elems; i += kThreads) {
    const float x = s_tile[i];
    s_tile[i] = 0.0f;
    if (x != 0.0f) atomicAdd(dst + i, x);
  }
}

template <int N_IN>
__global__ void __launch_bounds__(kThreads) mttkrp_blocked_kernel(const Args a) {
  extern __shared__ float s_tile[];  // tile_i x ld partial sums
  // The current chunk's non-zeros, compacted: value, row offset within the
  // tile and one input row offset per input mode (offsets times ld).
  __shared__ float s_val[kThreads];
  __shared__ int s_row[kThreads];
  __shared__ int64_t s_in[N_IN][kThreads];
  __shared__ int s_count;

  for (int i = threadIdx.x; i < a.tile_i * a.ld; i += kThreads) s_tile[i] = 0.0f;

  const int64_t per = (a.nblocks + gridDim.x - 1) / gridDim.x;
  const int64_t b_begin = static_cast<int64_t>(blockIdx.x) * per;
  const int64_t b_end = b_begin + per < a.nblocks ? b_begin + per : a.nblocks;
  int cur_tile = -1;
  for (int64_t b = b_begin; b < b_end; ++b) {
    const int tile = a.block_it[b];
    if (tile != cur_tile) {
      // Every thread passed the previous chunk's closing barrier, so the
      // tile holds all of the previous run's contributions.
      if (cur_tile >= 0) flush_tile(a, s_tile, cur_tile);
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
        if (v != 0.0f) {
          const int k = atomicAdd(&s_count, 1);
          s_val[k] = v;
          s_row[k] = a.iloc[slot] * a.ld;
#pragma unroll
          for (int n = 0; n < N_IN; ++n) {
            s_in[n][k] = (in_base[n] + a.in_locs[n][slot]) * a.ld;
          }
        }
      }
      __syncthreads();
      const int items = s_count * a.ld;
      for (int e = threadIdx.x; e < items; e += kThreads) {
        const int k = e / a.ld;
        const int c = e - k * a.ld;
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
  if (cur_tile >= 0) flush_tile(a, s_tile, cur_tile);
}

template <int N_IN>
cudaError_t launch(const Args& a, int sms, size_t smem, cudaStream_t stream) {
  auto kernel = mttkrp_blocked_kernel<N_IN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long cap = static_cast<long long>(sms) * per_sm;
  const unsigned grid = static_cast<unsigned>(a.nblocks < cap ? a.nblocks : cap);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Largest tile_i * ld the kernel takes: the output tile in shared memory
// plus the static staging arrays must fit in one CTA's 227 KB.
extern "C" int mttkrp_blocked_max_tile_elems() { return 50 * 1024; }

// Launch on `stream`.  The pointer arrays hold n_in device pointers each,
// in plan.in_modes order.  Returns a cudaError_t (0 on success).
extern "C" int mttkrp_blocked_launch(
    const float* vals, const int* iloc, const int* block_it,
    const int* const* in_locs, const int* const* block_in,
    const float* const* factors, const int* in_tiles, int n_in,
    long long nblocks, int blk, int tile_i, int ld, float* out,
    int device, void* stream) {
  if (n_in < 2 || n_in > kMaxIn || blk < 1 || tile_i < 1 || ld < 1 || nblocks < 0 ||
      static_cast<long long>(tile_i) * ld > mttkrp_blocked_max_tile_elems()) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nblocks == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
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

  const size_t smem = static_cast<size_t>(tile_i) * ld * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_in) {
    case 2: err = launch<2>(a, sms, smem, s); break;
    case 3: err = launch<3>(a, sms, smem, s); break;
    default: err = launch<4>(a, sms, smem, s); break;
  }
  return static_cast<int>(err);
}
