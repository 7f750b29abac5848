// Blocked sorted-COO TT-core update (the TT-ALS right-hand side) for Hopper
// (sm_90a), fp32 throughout.
//
// Replaces the TPU kernel src/repro/kernels/tt_pallas.py::_kernel
// (launched by ttcore_pallas_call).  It computes the same function on the
// same BlockPlan layout as the MTTKRP and TTMc kernels (csrc/mttkrp.cu,
// csrc/ttmc.cu):
//
//     B[block_it[b]*tile_i + iloc[s], a*rr_m + c] += vals[s] * left[a] * right[c]
//
// for every slot s of every plan block b.  Input n is an interface matrix
// W_n (rows of ld[n] floats, element (p, q) of its (rl_n, rr_n) block at
// lane p*rr_n + q), gathered at row block_in[n][b]*in_tiles[n] +
// in_locs[n][s].  `left` chains the first n_left inputs, ascending, from the
// 1-vector: left'[q] = sum_p left[p] * W_n[p*rr_n + q].  `right` chains the
// others, descending from the last, from the 1-vector: right'[p] = sum_q
// W_n[p*rr_n + q] * right[q].  left has rl_m entries, right rr_m, and B has
// ncols = rl_m * rr_m true columns in rows of ldo floats.  2, 3 or 4 inputs
// (template parameter N_IN); n_left, the pairs and the strides are taken at
// run time.  Only the rl_n * rr_n true lanes of a row are read, so padded
// lanes never enter a product.
//
// Design, and how it differs from the TPU kernel:
//   * As in the TTMc kernel, CTAs take ranges of at most kBlocksPerCta plan
//     blocks (418,578 per mode at NELL-2 size; a mode has only 36-113
//     output-tile runs, too few for 132 SMs), and a grid dimension splits
//     the output columns into slices of at most 64, so a tile_i x slice tile
//     of partial sums fits in shared memory (mode 1 of a rank-(16, 16) TT
//     has 256 columns).  The tile goes to device memory with one global
//     atomic per non-zero element when the range moves to another output
//     tile and at its end.
//   * Each 256-slot step keeps its non-zero slots (plans are 28-99%
//     padding) and counting-sorts them by row in shared memory.
//   * The chains.  The Pallas kernel runs both chains as (blk, rl, rr)
//     vector products on whole blocks.  Here a group of `lanes` threads
//     (the widest bond rounded up to a power of two, at most a warp) takes
//     one sorted slot at a time: each thread computes entries of the next
//     vector from the gathered row, read from device memory through L1 and
//     L2, and the group passes the vector on through shared memory.  The
//     value is folded into `left`; `left` and `right` (rl_m + rr_m floats)
//     are staged per slot in shared memory.  Groups narrower than a warp
//     run several slots of one warp at once.
//   * Output column c = a*rr_m + q is left[a] * right[q]: each thread owns a
//     column of the slice, the threads of a column split the sorted list
//     into equal segments, and each run of one row is summed in a register
//     before it is added to the tile; only a segment's first and last runs
//     can share their row with another segment, and only those add with a
//     shared-memory atomic (a compare-and-swap loop on sm_90a).
//
// Bound: operations, not bytes.  The stream is 16 B per non-zero (3 modes);
// the work is 2 * ncols flops for the product and sum per non-zero, plus
// 2 * rl * rr for each chain step after a chain's first (a multiply-add per
// matrix element): about 530-545 flops per non-zero at TT ranks (16, 16).
// What holds this design back is the chains (PERF.md has the times): at
// modes 0 and 2 of a 3-mode tensor each non-zero takes a 16 x 16
// matrix-vector step through the middle core, gathering 1 KB of W_1 (9.4 MB
// at NELL-2 size, resident in the 50 MB L2), with one group of 16 threads
// per slot and the gathers of a slot's two chain steps one after the
// other.  A right step (mode 0) reads the row at a stride of rr floats per
// thread, a left step (mode 2) reads it coalesced.  At mode 1 the chains are
// row copies, but each of the 4 column slices redoes them for every slot.
//
// Sum order: the atomics make the order in which contributions reach an
// output element vary from run to run, so results differ from the plain
// version (and from one run to the next) in the last bits of float32.
//
// Offsets into the stream, the matrices and the output are computed in 64
// bits.  The kernel allocates nothing and does not synchronise; the wrapper
// (kernels/tt.py) zeroes the output, checks every argument, and raises on a
// non-zero return code.

#include <cuda_runtime.h>
#include <stdint.h>

#include "blocked.cuh"

namespace {

constexpr int kMaxIn = 4;

struct Args {
  const float* vals;
  const int* iloc;
  const int* block_it;
  const int* in_locs[kMaxIn];
  const int* block_in[kMaxIn];
  const float* factors[kMaxIn];
  int in_tiles[kMaxIn];
  int ld[kMaxIn];  // row stride of each interface matrix
  int rl[kMaxIn];  // left bond of each input
  int rr[kMaxIn];  // right bond of each input
  int n_left;      // inputs chained from the left
  int rl_m;        // entries of `left`
  int rr_m;        // entries of `right`
  int stage;       // floats of a staged slot: rl_m + rr_m
  int maxw;        // widest chain vector: the largest bond of any input
  int lanes;       // threads per chain group: a power of two >= maxw, at most 32
  float* out;
  int64_t nblocks;
  int blk;
  int tile_i;
  int ldo;     // row stride of out
  int ncols;   // true output columns: rl_m * rr_m
  int slice;   // columns per CTA, a power of two in [kMinSlice, kMaxSlice]
  int slices;  // column slices: ceil(ncols / slice)
  int groups;  // threads per column, each taking a segment of a step: kThreads / slice
};

template <int N_IN>
__global__ void __launch_bounds__(kThreads) ttcore_blocked_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_tile = reinterpret_cast<float*>(smem);      // tile_i x slice partial sums
  float* s_stage = s_tile + a.tile_i * a.slice;        // kChunk x (rl_m + rr_m): v*left, right
  float* s_chain = s_stage + kChunk * a.stage;         // two vectors of maxw per chain group
  int* s_start = reinterpret_cast<int*>(s_chain + (kThreads / a.lanes) * 2 * a.maxw);
  // The step's non-zero slots in row order: interface row offsets
  // (row * ld), value, tile row offset (iloc * slice).
  __shared__ int64_t s_in[N_IN][kChunk];
  __shared__ float s_val[kChunk];
  __shared__ int s_row[kChunk];
  __shared__ int s_warp[kWarps];

  // CTA b takes column slice b % slices of block range b / slices: the
  // slices of one range run side by side, so the stream and the rows they
  // read are in L2 for all but the first.
  const int64_t range = blockIdx.x / a.slices;
  const int64_t ranges = gridDim.x / a.slices;
  const int col = threadIdx.x & (a.slice - 1);
  const int group = threadIdx.x / a.slice;
  const int c = static_cast<int>(blockIdx.x % a.slices) * a.slice + col;
  const bool active = c < a.ncols;
  // The staged entries this column multiplies: left[c / rr_m], right[c % rr_m].
  const int q_left = active ? c / a.rr_m : 0;
  const int q_right = active ? a.rl_m + c % a.rr_m : 0;
  // This thread's chain group, and its place in it.
  const int chains = kThreads / a.lanes;
  const int chain = threadIdx.x / a.lanes;
  const int sub = threadIdx.x & (a.lanes - 1);
  float* const vec0 = s_chain + chain * 2 * a.maxw;
  float* const vec1 = vec0 + a.maxw;

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
    for (int c0 = 0; c0 < a.blk; c0 += kChunk) {
      // This thread's slot, its fields read in one round: count it in its
      // row; `pos` is its place there.
      const int z = c0 + static_cast<int>(threadIdx.x);
      const int64_t slot = b * a.blk + z;
      float v = 0.0f;
      int row = 0;
      int64_t in_row[N_IN] = {};
      if (z < a.blk) {
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
      // The chains: chain group g takes sorted slots g, g + chains, ...  The
      // loop bounds are the same for every thread of a warp, so every lane
      // reaches each __syncwarp.
      for (int j0 = 0; j0 < count; j0 += chains) {
        const int j = j0 + chain;
        const bool ok = j < count;
        float* cur = vec0;
        float* nxt = vec1;
        if (sub == 0) cur[0] = 1.0f;
        __syncwarp();
#pragma unroll
        for (int n = 0; n < N_IN; ++n) {
          if (n < a.n_left) {
            const int rl = a.rl[n], rr = a.rr[n];
            if (ok) {
              const float* w = a.factors[n] + s_in[n][j];
              for (int o = sub; o < rr; o += a.lanes) {
                float acc = 0.0f;
#pragma unroll 4
                for (int p = 0; p < rl; ++p) acc = fmaf(cur[p], __ldg(w + p * rr + o), acc);
                nxt[o] = acc;
              }
            }
            __syncwarp();
            float* t = cur;
            cur = nxt;
            nxt = t;
          }
        }
        if (ok) {
          for (int o = sub; o < a.rl_m; o += a.lanes) s_stage[j * a.stage + o] = s_val[j] * cur[o];
        }
        __syncwarp();
        if (sub == 0) cur[0] = 1.0f;
        __syncwarp();
#pragma unroll
        for (int n = N_IN - 1; n >= 0; --n) {
          if (n >= a.n_left) {
            const int rl = a.rl[n], rr = a.rr[n];
            if (ok) {
              const float* w = a.factors[n] + s_in[n][j];
              for (int o = sub; o < rl; o += a.lanes) {
                float acc = 0.0f;
#pragma unroll 4
                for (int q = 0; q < rr; ++q) acc = fmaf(__ldg(w + o * rr + q), cur[q], acc);
                nxt[o] = acc;
              }
            }
            __syncwarp();
            float* t = cur;
            cur = nxt;
            nxt = t;
          }
        }
        if (ok) {
          for (int o = sub; o < a.rr_m; o += a.lanes) s_stage[j * a.stage + a.rl_m + o] = cur[o];
        }
        __syncwarp();
      }
      __syncthreads();  // staged vectors complete

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
          const float* f = s_stage + j * a.stage;
          acc += f[q_left] * f[q_right];
        }
        if (cur >= 0) atomicAdd(&s_tile[cur + col], acc);
      }
      __syncthreads();  // the step's sums are in the tile; staging is free
    }
  }
  if (cur_tile >= 0) flush_tile(a, s_tile, cur_tile);
}

size_t dynamic_smem(const Args& a) {
  return (static_cast<size_t>(a.tile_i) * a.slice +
          static_cast<size_t>(kChunk) * a.stage +
          static_cast<size_t>(kThreads / a.lanes) * 2 * a.maxw) * sizeof(float) +
         static_cast<size_t>(a.tile_i) * sizeof(int);
}

}  // namespace

// Launch on `stream`.  The pointer arrays hold n_in device pointers each,
// and in_tiles / ld / rl / rr n_in ints, in plan.in_modes order; the pairs
// must chain (the wrapper checks it).  Returns 0 on success, -1 when the
// tile, the staged vectors and the chain scratch do not fit in a CTA's
// shared memory, else a cudaError_t.
extern "C" int ttcore_blocked_launch(
    const float* vals, const int* iloc, const int* block_it,
    const int* const* in_locs, const int* const* block_in,
    const float* const* factors, const int* in_tiles, const int* ld, const int* rl,
    const int* rr, int n_in, int n_left, long long nblocks, int blk, int tile_i, int ldo,
    float* out, int device, void* stream) {
  if (n_in < 2 || n_in > kMaxIn || n_left < 0 || n_left > n_in || blk < 1 || tile_i < 1 ||
      nblocks < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
  int maxw = 1;
  for (int n = 0; n < n_in; ++n) {
    if (rl[n] < 1 || rr[n] < 1 || static_cast<long long>(rl[n]) * rr[n] > ld[n]) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    a.in_locs[n] = in_locs[n];
    a.block_in[n] = block_in[n];
    a.factors[n] = factors[n];
    a.in_tiles[n] = in_tiles[n];
    a.ld[n] = ld[n];
    a.rl[n] = rl[n];
    a.rr[n] = rr[n];
    if (rl[n] > maxw) maxw = rl[n];
    if (rr[n] > maxw) maxw = rr[n];
  }
  const int rl_m = n_left > 0 ? rr[n_left - 1] : 1;
  const int rr_m = n_left < n_in ? rl[n_left] : 1;
  const long long ncols = static_cast<long long>(rl_m) * rr_m;
  if (ncols > ldo) return static_cast<int>(cudaErrorInvalidValue);
  if (nblocks == 0) return 0;
  const int slice = slice_for(ncols);
  int lanes = 1;
  while (lanes < 32 && lanes < maxw) lanes *= 2;
  a.vals = vals;
  a.iloc = iloc;
  a.block_it = block_it;
  a.n_left = n_left;
  a.rl_m = rl_m;
  a.rr_m = rr_m;
  a.stage = rl_m + rr_m;
  a.maxw = maxw;
  a.lanes = lanes;
  a.out = out;
  a.nblocks = nblocks;
  a.blk = blk;
  a.tile_i = tile_i;
  a.ldo = ldo;
  a.ncols = static_cast<int>(ncols);
  a.slice = slice;
  a.slices = static_cast<int>((ncols + slice - 1) / slice);
  a.groups = kThreads / slice;

  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_in) {
    case 2: return launch_ranges(ttcore_blocked_kernel<2>, a, dynamic_smem(a), device, s);
    case 3: return launch_ranges(ttcore_blocked_kernel<3>, a, dynamic_smem(a), device, s);
    default: return launch_ranges(ttcore_blocked_kernel<4>, a, dynamic_smem(a), device, s);
  }
}
