// Blocked sorted-COO TTM chain (TTMc) for Hopper (sm_90a), fp32 throughout.
//
// Replaces the TPU kernel src/repro/kernels/ttm_pallas.py::_kernel
// (launched by ttmc_pallas_call).  It computes the same function on the
// same BlockPlan layout as the MTTKRP kernel (csrc/mttkrp.cu):
//
//     Y[block_it[b]*tile_i + iloc[s], c] +=
//         vals[s] * prod_n U_n[block_in[n][b]*in_tiles[n] + in_locs[n][s], d_n(c)]
//
// for every slot s of every plan block b, where d_n(c) is the mixed-radix
// digit of column c over the true input ranks (the last input mode varies
// fastest), with 2, 3 or 4 input modes (template parameter N_IN).  Each
// factor has its own row stride ld[n] and its own true rank r_n; only the
// r_n true lanes are read, so padded lanes never enter a product.  Y has
// ncols = prod r_n true columns in rows of ldo floats.
//
// Design, and how it differs from the TPU kernel:
//   * The Pallas grid walks blocks in order on one core and keeps the output
//     tile resident across its run.  A mode has only 36-113 output-tile runs
//     at NELL-2 size, too few to fill 132 SMs, so, as in the MTTKRP kernel,
//     CTAs take contiguous ranges of plan blocks and sum into an output tile
//     kept in shared memory.  The tile's non-zero partial sums go to device
//     memory with one global atomic each when the range moves to another
//     output tile and at its end (neighbouring CTAs may share a tile).
//   * A range holds at most kBlocksPerCta blocks, so the grid may take
//     several waves.  This bounds the float32 sum that one tile element
//     carries between flushes: a hot row of the zipf-skewed tensor collects
//     millions of terms per mode, and one CTA's share of a mode at one wave
//     would sum too many of them in one float32 chain.
//   * The output row is wide: 256 columns at core ranks (16, 16, 16), so a
//     256-row tile would take 256 KB, more than a CTA's 227 KB.  The grid
//     splits the columns into slices of at most 64 (a 64 KB tile), so any
//     product of ranks fits; each slice re-reads its blocks' indices and
//     values (16 B per slot for 3 modes, little beside 64 outputs per slot),
//     and the slices of one block range run side by side, so the re-reads
//     hit L2.
//   * Hot rows.  Each step takes up to `chunk` slots of a block (256, or
//     fewer where wide factor rows fill the shared memory: chosen at
//     launch, so input ranks summing to 200 still run), keeps those
//     whose value is non-zero (plans are 28-99% padding), and sorts them by
//     row in shared memory (a counting sort over the tile's rows).  A thread
//     owns one column of the slice; the threads of a column split the
//     sorted list into equal segments (`groups` of them), whatever the
//     rows, and sum each run of one row in a register before adding it to
//     the tile.  Only a segment's first and last runs can share their row
//     with another segment; only those add with an atomic, because a float
//     atomicAdd on shared memory compiles to a compare-and-swap loop
//     (ATOMS.CAST.SPIN) on sm_90a, which spins when many threads hit one row.
//   * The sorted slots' true factor lanes (the value folded into the first
//     input's) are staged in shared memory, gathered once from L2 by warps
//     that each take a slot and lanes that each take a staged lane, so the
//     products read shared memory only.  The factors of a rank-16 NELL-2
//     decomposition (~3 MB) stay in the 50 MB L2.  The products are taken
//     in the plain version's order, ((v * U_0) * U_1) * ..., so only the
//     order of the sums differs.
//
// Bound: operations, not bytes.  Each non-zero reads 16 B (3 modes) but does
// about 2 * ncols flops (a multiply per Kronecker lane and an add per output
// column): 528 per non-zero at ranks (16, 16, 16), against 16 B.  What holds
// this design back instead is shared memory: at NELL-2 size the rows of a
// step are mostly distinct, so nearly every product is a read-modify-write
// of a tile element, and the gather, the products and the per-step sort and
// barriers run one after another.
//
// Sum order: the atomics make the order in which contributions reach an
// output element vary from run to run, so results differ from the plain
// version (and from one run to the next) in the last bits of float32.
//
// Offsets into the stream, the factors and the output are computed in 64
// bits.  The kernel allocates nothing and does not synchronise; the wrapper
// (kernels/ttm.py) zeroes the output, checks every argument, and raises on
// a non-zero return code.

#include <cuda_runtime.h>
#include <stdint.h>

#include "blocked.cuh"

namespace {

constexpr int kMaxIn = 4;
constexpr int kGather = 8;         // staging loads in flight per thread

struct Args {
  const float* vals;
  const int* iloc;
  const int* block_it;
  const int* in_locs[kMaxIn];
  const int* block_in[kMaxIn];
  const float* factors[kMaxIn];
  int in_tiles[kMaxIn];
  int ld[kMaxIn];    // row stride of each factor
  int rank[kMaxIn];  // true rank of each factor: the lanes read
  int off[kMaxIn];   // first lane of input n in a staged slot: sum of earlier ranks
  int sum_r;         // lanes of a staged slot: the sum of the ranks
  int chunk;         // slots per step, at most kChunk: what the shared memory holds
  float* out;
  int64_t nblocks;
  int blk;
  int tile_i;
  int ldo;     // row stride of out
  int ncols;   // true output columns: the product of the ranks
  int slice;   // columns per CTA, a power of two in [kMinSlice, kMaxSlice]
  int slices;  // column slices: ceil(ncols / slice)
  int groups;  // threads per column, each taking a segment of a step: kThreads / slice
};

template <int N_IN>
__global__ void __launch_bounds__(kThreads) ttmc_blocked_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_tile = reinterpret_cast<float*>(smem);  // tile_i x slice partial sums
  float* s_fac = s_tile + a.tile_i * a.slice;      // chunk x sum_r staged lanes
  int* s_start = reinterpret_cast<int*>(s_fac + a.chunk * a.sum_r);  // tile_i row counts, then starts
  // The step's non-zero slots in row order: factor row offsets (row * ld),
  // value, tile row offset (iloc * slice).
  __shared__ int64_t s_in[N_IN][kChunk];
  __shared__ float s_val[kChunk];
  __shared__ int s_row[kChunk];
  __shared__ int s_warp[kWarps];

  // CTA b takes column slice b % slices of block range b / slices: the
  // slices of one range run side by side, so the stream and the factor rows
  // they read are in L2 for all but the first.
  const int64_t range = blockIdx.x / a.slices;
  const int64_t ranges = gridDim.x / a.slices;
  const int col = threadIdx.x & (a.slice - 1);
  const int group = threadIdx.x / a.slice;
  const int lane_id = threadIdx.x & 31;
  const int warp_id = threadIdx.x >> 5;
  const int c = static_cast<int>(blockIdx.x % a.slices) * a.slice + col;
  const bool active = c < a.ncols;
  // The staged lane of each input this column reads: its digits, last fastest.
  int q[N_IN];
  int rest = active ? c : 0;
#pragma unroll
  for (int n = N_IN - 1; n >= 0; --n) {
    q[n] = a.off[n] + rest % a.rank[n];
    rest /= a.rank[n];
  }

  for (int i = threadIdx.x; i < a.tile_i * a.slice; i += kThreads) s_tile[i] = 0.0f;
  for (int i = threadIdx.x; i < a.tile_i; i += kThreads) s_start[i] = 0;
  __syncthreads();

  const int64_t per = (a.nblocks + ranges - 1) / ranges;
  const int64_t b_begin = range * per;
  const int64_t b_end = b_begin + per < a.nblocks ? b_begin + per : a.nblocks;
  int cur_tile = -1;
  for (int64_t b = b_begin; b < b_end; ++b) {
    const int tile = a.block_it[b];
    if (tile != cur_tile) {
      // Every thread passed the previous step's closing barrier, so the
      // tile holds all of the previous run's contributions.
      if (cur_tile >= 0) flush_tile(a, s_tile, cur_tile);
      cur_tile = tile;
    }
    for (int c0 = 0; c0 < a.blk; c0 += a.chunk) {
      // This thread's slot (threads past `chunk` take none), its fields read
      // in one round: count it in its row; `pos` is its place there.
      const int z = c0 + static_cast<int>(threadIdx.x);
      const int64_t slot = b * a.blk + z;
      float v = 0.0f;
      int row = 0;
      int64_t in_row[N_IN] = {};
      if (static_cast<int>(threadIdx.x) < a.chunk && z < a.blk) {
        v = a.vals[slot];
        row = a.iloc[slot];
#pragma unroll
        for (int n = 0; n < N_IN; ++n) {
          in_row[n] = (static_cast<int64_t>(a.block_in[n][b]) * a.in_tiles[n] +
                       a.in_locs[n][slot]) * a.ld[n];
        }
      }
      const int pos = v != 0.0f ? atomicAdd(&s_start[row], 1) : -1;
      __syncthreads();  // row counts complete
      const int count = exclusive_scan(s_start, a.tile_i, s_warp);
      if (pos >= 0) {
        const int j = s_start[row] + pos;
        s_val[j] = v;
        s_row[j] = row * a.slice;
#pragma unroll
        for (int n = 0; n < N_IN; ++n) s_in[n][j] = in_row[n];
      }
      __syncthreads();  // sorted slots complete; row starts read

      for (int i = threadIdx.x; i < a.tile_i; i += kThreads) s_start[i] = 0;
      // Gather the staged lanes: warp w takes sorted slots w, w + kWarps,
      // ...; lane l takes staged lanes l, l + 32, ... of each, so which
      // input and digit a lane reads is worked out once, not per element;
      // kGather loads in flight per thread.
      for (int l = lane_id; l < a.sum_r; l += 32) {
        int src = 0;
#pragma unroll
        for (int n = 1; n < N_IN; ++n) src = l >= a.off[n] ? n : src;
        const float* fac = a.factors[0];
#pragma unroll
        for (int n = 1; n < N_IN; ++n) fac = src == n ? a.factors[n] : fac;
        fac += l - a.off[src];
        const int64_t* rows = s_in[src];
        for (int j0 = warp_id; j0 < count; j0 += kWarps * kGather) {
          float x[kGather];
#pragma unroll
          for (int u = 0; u < kGather; ++u) {
            const int j = j0 + u * kWarps;
            x[u] = j < count ? __ldg(fac + rows[j]) : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < kGather; ++u) {
            const int j = j0 + u * kWarps;
            if (j < count) s_fac[j * a.sum_r + l] = src == 0 ? s_val[j] * x[u] : x[u];
          }
        }
      }
      __syncthreads();  // staged lanes complete

      if (active) {
        // Only a segment's first and last runs can share their row with a
        // neighbouring segment: those add with an atomic, the rest without.
        const int lo = group * count / a.groups;
        const int hi = (group + 1) * count / a.groups;
        int cur = -1;
        bool first_run = true;
        float acc = 0.0f;
        for (int j = lo; j < hi; ++j) {
          const int r = s_row[j];
          if (r != cur) {
            if (cur >= 0) {
              if (first_run) {
                atomicAdd(&s_tile[cur + col], acc);
              } else {
                s_tile[cur + col] += acc;
              }
              first_run = false;
            }
            cur = r;
            acc = 0.0f;
          }
          const float* f = s_fac + j * a.sum_r;
          float p = f[q[0]];
#pragma unroll
          for (int n = 1; n < N_IN; ++n) p *= f[q[n]];
          acc += p;
        }
        if (cur >= 0) atomicAdd(&s_tile[cur + col], acc);
      }
      __syncthreads();  // the step's sums are in the tile; staging is free
    }
  }
  if (cur_tile >= 0) flush_tile(a, s_tile, cur_tile);
}

size_t dynamic_smem(const Args& a) {
  return static_cast<size_t>(a.tile_i) * a.slice * sizeof(float) +
         static_cast<size_t>(a.chunk) * a.sum_r * sizeof(float) +
         static_cast<size_t>(a.tile_i) * sizeof(int);
}

// Size the step from the shared-memory budget and launch: the slice stays
// slice_for(ncols) unless a tile_i x slice tile leaves no room for one
// staged slot (then it halves, down to kMinSlice); the step takes as many
// slots as fit beside the tile, at most kChunk.  Returns 0, -1 when not even
// one slot fits beside a tile_i x kMinSlice tile, else a cudaError_t.
template <int N_IN>
int launch(Args a, int device, cudaStream_t stream) {
  auto kernel = ttmc_blocked_kernel<N_IN>;
  size_t budget = 0;
  const int err = dynamic_budget(kernel, device, &budget);
  if (err != 0) return err;
  const size_t fixed_per_col = static_cast<size_t>(a.tile_i) * sizeof(float);
  const size_t fixed = static_cast<size_t>(a.tile_i) * sizeof(int);
  const size_t per_slot = static_cast<size_t>(a.sum_r) * sizeof(float);
  while (a.slice > kMinSlice && fixed_per_col * a.slice + fixed + per_slot > budget) a.slice /= 2;
  const size_t used = fixed_per_col * a.slice + fixed;
  if (used + per_slot > budget) return -1;
  const size_t fit = (budget - used) / per_slot;
  a.chunk = fit < static_cast<size_t>(kChunk) ? static_cast<int>(fit) : kChunk;
  a.slices = (a.ncols + a.slice - 1) / a.slice;
  a.groups = kThreads / a.slice;
  return launch_ranges(kernel, a, dynamic_smem(a), device, stream);
}

}  // namespace

// Launch on `stream`.  The pointer arrays hold n_in device pointers each,
// and in_tiles / ld / ranks n_in ints, in plan.in_modes order.  Returns 0 on
// success, -1 when not even one staged slot fits beside a tile_i x kMinSlice
// tile in a CTA's shared memory, else a cudaError_t.
extern "C" int ttmc_blocked_launch(
    const float* vals, const int* iloc, const int* block_it,
    const int* const* in_locs, const int* const* block_in,
    const float* const* factors, const int* in_tiles, const int* ld, const int* ranks,
    int n_in, long long nblocks, int blk, int tile_i, int ldo, float* out,
    int device, void* stream) {
  if (n_in < 2 || n_in > kMaxIn || blk < 1 || tile_i < 1 || nblocks < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
  long long ncols = 1;
  int sum_r = 0;
  for (int n = 0; n < n_in; ++n) {
    if (ranks[n] < 1 || ld[n] < ranks[n]) return static_cast<int>(cudaErrorInvalidValue);
    a.in_locs[n] = in_locs[n];
    a.block_in[n] = block_in[n];
    a.factors[n] = factors[n];
    a.in_tiles[n] = in_tiles[n];
    a.ld[n] = ld[n];
    a.rank[n] = ranks[n];
    a.off[n] = sum_r;
    sum_r += ranks[n];
    ncols *= ranks[n];
    if (ncols > ldo) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nblocks == 0) return 0;
  a.vals = vals;
  a.iloc = iloc;
  a.block_it = block_it;
  a.sum_r = sum_r;
  a.out = out;
  a.nblocks = nblocks;
  a.blk = blk;
  a.tile_i = tile_i;
  a.ldo = ldo;
  a.ncols = static_cast<int>(ncols);
  a.slice = slice_for(ncols);

  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_in) {
    case 2: return launch<2>(a, device, s);
    case 3: return launch<3>(a, device, s);
    default: return launch<4>(a, device, s);
  }
}
