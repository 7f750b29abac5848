// The kernel as it was before its wide path (plans of more than 4 input
// modes) was added to src/repro_torch/kernels/csrc/ttmc.cu, kept to be timed
// in turns beside the current source (chip_smoke.py phase k): the 2-4-input
// templates must run as fast as they did.  It includes
// blocked_before_wide.cuh, the copy of csrc/blocked.cuh it was written
// against.
//
// Blocked sorted-COO TTM chain (TTMc) for Hopper (sm_90a), fp32 throughout.
//
// Replaces the TPU kernel src/repro/kernels/ttm_pallas.py:60 _kernel
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
// The TPU kernel builds each block's (blk, P) Kronecker contributions and
// sums them into the output tile with a one-hot (tile_i, blk) @ (blk, P)
// product on the MXU.  On Hopper that would be some 256 times the tensor-core
// work the sum needs, in TF32, which cannot meet a 1e-5 bar; this kernel
// keeps the function, not the shape.
//
// Bound: operations.  Each non-zero reads 16 B (3 modes) but does about
// 2 * ncols flops: 528 per non-zero at core ranks (16, 16, 16).  So the
// design keeps the multiply-adds on the CUDA cores with as little beside
// them as it can: no shared-memory traffic per product, and output adds per
// row run rather than per slot.
//
// Design:
//   * Ranges.  A mode has only 36-113 output-tile runs at NELL-2 size, too
//     few for 132 SMs, so CTAs take contiguous ranges of plan blocks
//     (launch_ranges in blocked.cuh, at most kBlocksPerCta blocks each).
//   * One sort per range.  A CTA counting-sorts the real (non-zero-value)
//     slots of each output tile's part of its range by tile row, once, in
//     chunks of at most kSortSlots slots: two passes over the value and row
//     fields (counts, a CTA-wide scan, then places), each reading
//     kSortUnroll rounds of fields before counting any, with
//     warp-aggregated shared-memory atomics (__match_any_sync), so a hot
//     row costs one atomic per warp (sort_pass, blocked.cuh, shared with
//     the MTTKRP kernel).  The permutation is kept as 16-bit
//     slot offsets in shared memory (16 KB).  Sorting a range rather than a
//     256-slot step makes row runs about 10 times longer at NELL-2 size (49
//     against 4.6 slots on average per 16,384-slot range; a slot's run,
//     weighted by slots, holds some 5,000 against 90).  Chunks of 8,192
//     slots, not a whole range's 16,384, leave more of the SM's 256 KB to
//     L1, which holds the hot factor rows (PERF.md, Findings).
//   * Rows in registers.  Each warp takes an equal, contiguous part of the
//     sorted slots (so the warps stay balanced, and a hot row's run is
//     split over at most the 8 warps of the CTA), and walks it slot by slot,
//     holding the current row's output columns in registers.  Each lane owns
//     NQ quads of 4 columns that share every digit but the last (at 256
//     columns, two quads: columns 4l.. and 128 + 4l.. of lane l), so the
//     warp's k-th quads are 128 consecutive output columns.  For each slot a
//     lane reads one value of each leading factor per quad and 4 lanes of
//     the last factor (one 16-byte load, shared by its quads where their
//     last digits agree) straight from L2, folds the value into the leading
//     product in the plain version's order, ((v * U_0) * U_1) * ..., and
//     issues fp32 FMAs.  The slot fields (row, value, factor rows) are read
//     through the permutation by the lanes in batches of 32, the next
//     batch's during this batch's work, and passed on by shuffles.
//   * Many warps rather than deep batches.  At 64 registers a thread (two
//     quads a lane) 4 CTAs, 32 warps, share an SM, each with one slot's
//     loads in flight; this beat 2 CTAs with 4 slots' loads in flight, and
//     staging the factor rows of 32 slots in shared memory with cp.async
//     gained nothing over reading them straight from L2 (PERF.md, Findings).
//   * Output.  When the row changes the lanes add their register sums to
//     the output with float4 global reductions, 512 consecutive bytes per
//     warp instruction (scalar ones where the columns are not 16-byte
//     aligned).  A warp's first and last runs, whose rows its neighbours
//     may share, are kept in shared memory instead, and once every warp is
//     done one warp adds them up row by row: a hot row that spans all 8
//     warps reaches the output with one reduction per chunk, as it did
//     from the replaced kernel's shared-memory tile.  There is no tile and
//     no flush.  Reductions at L2 are cheap: that tile's flushes
//     (scripts/probe_kernels/ttmc_pr16.cu), some 428 M scalar global
//     atomics per mode at NELL-2 size, took 0.8 ms.
//   * Any tile_i.  The row counts take tile_i ints of shared memory; past
//     kMaxRows rows the tile splits into row parts, one CTA each, and a CTA
//     keeps only the slots of its rows.  At tile_i 256 there is one part.
//   * Any width.  Quads past what a warp holds in registers (32 * kMaxQuads
//     quads, 1,024 columns) go to column slices, one CTA each, which re-read
//     the stream fields and redo the sort, but copy nothing.
//   * Sum order.  A float32 chain per output element within one CTA holds at
//     most one chunk's slots of one row (kSortSlots), as the replaced
//     kernel's tile held a range's: each warp's part in registers, then the
//     parts of a row shared by warps added in warp order.  The reductions
//     and the atomic counting sort make the order in which contributions
//     reach an output element vary from run to run, so results differ from
//     the plain version (and between runs) in the last bits of float32.
//
// Offsets into the stream, the factors and the output are computed in 64
// bits.  The kernel allocates nothing and does not synchronise; the wrapper
// (kernels/ttm.py) zeroes the output, checks every argument, and raises on
// a non-zero return code.

#include <cuda_runtime.h>
#include <stdint.h>

#include "blocked_before_wide.cuh"

namespace {

constexpr int kMaxIn = 4;
constexpr int kSortSlots = 8192;   // slots sorted at once: 16-bit offsets, 16 KB
constexpr int kQ = 4;              // columns per quad: 4 lanes of the last factor
constexpr int kMaxQuads = 8;       // quads per lane (32 columns); more make column slices
constexpr int kMaxRows = 4096;     // tile rows per CTA (16 KB of counts); more make row parts
// CTAs per SM the compiler keeps registers for (64 registers a thread)
// where a lane holds at most 2 quads; 2 CTAs for wider rows.
constexpr int kMinCtasPerSm = 4;

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
  float* out;
  int64_t nblocks;
  int blk;
  int tile_i;
  int ldo;         // row stride of out
  int qpl;         // quads per leading index: ceil(rank[last] / kQ)
  int nquads;      // quads of a row: (ncols / rank[last]) * qpl
  int vec;         // the last factor's and the output's quads are float4-aligned
  int same_d;      // a lane's quads share their last-factor lanes (32 % qpl == 0)
  int rows;        // tile rows per CTA: ceil(tile_i / parts)
  int parts;       // row parts of an output tile
  int col_slices;  // column slices: ceil(nquads / (32 * NQ))
  int slices;      // CTAs per block range: parts * col_slices
};

// This lane's quads (quad k is quad lane + 32 k of the CTA's column slice):
// the digit of each leading input, the first lane of the last factor (d),
// the true columns in the quad (0: no quad), and the output column of its
// first lane.  A warp's k-th quads are 128 consecutive output columns.
template <int N_IN, int NQ>
struct Quads {
  int dig[NQ][N_IN];  // [N_IN - 1] is d
  int nv[NQ];
  int col[NQ];
};

// One batch of up to 32 sorted slots, one per lane: output row within the
// tile, value, and each input's factor row.
template <int N_IN>
struct Fields {
  int row;
  float val;
  int in[N_IN];
};

// The fields of sorted slot p (none past lim), read through the permutation.
template <int N_IN>
__device__ __forceinline__ Fields<N_IN> read_fields(const Args& a, const uint16_t* s_perm, int p,
                                                    int lim, int64_t s0) {
  Fields<N_IN> f{};
  f.row = -1;
  if (p < lim) {
    const int64_t s = s0 + s_perm[p];
    const int64_t b = s / a.blk;
    f.row = a.iloc[s];
    f.val = a.vals[s];
#pragma unroll
    for (int n = 0; n < N_IN; ++n) f.in[n] = a.block_in[n][b] * a.in_tiles[n] + a.in_locs[n][s];
  }
  return f;
}

// A slot's factor values for this lane's quads, read from L2 for the factor
// rows `in` (one per input): the leading factors' digits, and the last
// factor's 4 lanes (one 16-byte load where the quad is aligned; the first
// quad's where the quads share them), zero for no quad.
template <int N_IN, int NQ>
__device__ __forceinline__ void fetch(const Args& a, const Quads<N_IN, NQ>& g, const int (&in)[N_IN],
                                      float (&lead)[NQ][N_IN - 1], float4 (&x)[NQ]) {
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int k = 0; k < NQ; ++k) {
    const bool here = g.nv[k] > 0;
#pragma unroll
    for (int n = 0; n < N_IN - 1; ++n) {
      lead[k][n] = here ? __ldg(a.factors[n] + static_cast<int64_t>(in[n]) * a.ld[n] + g.dig[k][n]) : 0.0f;
    }
    const float* src = a.factors[N_IN - 1] + static_cast<int64_t>(in[N_IN - 1]) * a.ld[N_IN - 1] +
                       g.dig[k][N_IN - 1];
    if (k > 0 && a.same_d) {
      x[k] = x[0];
    } else if (!here) {
      x[k] = zero;
    } else if (a.vec) {
      x[k] = __ldg(reinterpret_cast<const float4*>(src));
    } else {
      const int nv = g.nv[k];
      x[k] = make_float4(__ldg(src), nv > 1 ? __ldg(src + 1) : 0.0f, nv > 2 ? __ldg(src + 2) : 0.0f,
                         nv > 3 ? __ldg(src + 3) : 0.0f);
    }
  }
}

// Add this lane's sums for output row `row` (global) and clear them.
template <int N_IN, int NQ>
__device__ __forceinline__ void reduce_row(const Args& a, const Quads<N_IN, NQ>& g,
                                           float4 (&acc)[NQ], int64_t row) {
#pragma unroll
  for (int k = 0; k < NQ; ++k) {
    if (g.nv[k] > 0) {
      float* dst = a.out + row * a.ldo + g.col[k];
      if (a.vec) {
        atomicAdd(reinterpret_cast<float4*>(dst), acc[k]);
      } else {
        const float x[kQ] = {acc[k].x, acc[k].y, acc[k].z, acc[k].w};
#pragma unroll
        for (int c = 0; c < kQ; ++c) {
          if (c < g.nv[k]) atomicAdd(dst + c, x[c]);
        }
      }
    }
    acc[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// Keep this lane's sums of row `row` as edge e (0: the warp's first run, 1:
// its last) in shared memory, and clear them; the CTA adds the edges once
// all warps are done, so a row that runs across warps reaches the output
// with one reduction.
template <int NQ>
__device__ __forceinline__ void keep_edge(float4* s_edge, int* s_edge_row, int e, int row, float4 (&acc)[NQ]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NQ; ++k) {
    s_edge[((warp * 2 + e) * NQ + k) * 32 + lane] = acc[k];
    acc[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  if (lane == 0) s_edge_row[warp * 2 + e] = row;
}

// One warp's share of a sorted chunk: an equal, contiguous part of the
// sorted slots, walked slot by slot with the current row's sums in
// registers, in batches of 32 slots whose fields are read one batch ahead.
// A run's sums reach the output at each row change, but those of the
// warp's first and last runs (rows it may share with its neighbours) are
// kept as its edges.
template <int N_IN, int NQ>
__device__ __forceinline__ void warp_rows(const Args& a, const uint16_t* s_perm, int total, int64_t s0,
                                          int64_t out_row0, const Quads<N_IN, NQ>& g, float4* s_edge,
                                          int* s_edge_row) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float4 acc[NQ];
#pragma unroll
  for (int k = 0; k < NQ; ++k) acc[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  const int p_end = (warp + 1) * total / kWarps;
  int p = warp * total / kWarps;
  int cur = -1;  // an empty part keeps no edge: row -1
  bool first = true;
  Fields<N_IN> f = read_fields<N_IN>(a, s_perm, p + lane, p_end, s0);
  for (; p < p_end; p += 32) {
    const int cnt = p_end - p < 32 ? p_end - p : 32;
    const Fields<N_IN> nf = read_fields<N_IN>(a, s_perm, p + 32 + lane, p_end, s0);
    for (int j = 0; j < cnt; ++j) {  // the same for every lane
      const int row = __shfl_sync(0xffffffffu, f.row, j);
      const float v = __shfl_sync(0xffffffffu, f.val, j);
      int in[N_IN];
#pragma unroll
      for (int n = 0; n < N_IN; ++n) in[n] = __shfl_sync(0xffffffffu, f.in[n], j);
      float lead[NQ][N_IN - 1];
      float4 x[NQ];
      fetch<N_IN, NQ>(a, g, in, lead, x);
      if (row != cur) {
        if (cur >= 0) {
          if (first) {
            keep_edge<NQ>(s_edge, s_edge_row, 0, cur, acc);
            first = false;
          } else {
            reduce_row<N_IN, NQ>(a, g, acc, out_row0 + cur);
          }
        }
        cur = row;
      }
#pragma unroll
      for (int k = 0; k < NQ; ++k) {
        float l = v;
#pragma unroll
        for (int n = 0; n < N_IN - 1; ++n) l *= lead[k][n];
        acc[k].x = fmaf(l, x[k].x, acc[k].x);
        acc[k].y = fmaf(l, x[k].y, acc[k].y);
        acc[k].z = fmaf(l, x[k].z, acc[k].z);
        acc[k].w = fmaf(l, x[k].w, acc[k].w);
      }
    }
    f = nf;
  }
  // The last run is edge 1; a part of one run keeps it as edge 0.
  keep_edge<NQ>(s_edge, s_edge_row, first ? 0 : 1, cur, acc);
  if (first && lane == 0) s_edge_row[warp * 2 + 1] = -1;
}

// After every warp's rows (a barrier between): add the warps' edges to the
// output, in warp order, one reduction per row; by warp 0.
template <int N_IN, int NQ>
__device__ __forceinline__ void add_edges(const Args& a, const Quads<N_IN, NQ>& g, const float4* s_edge,
                                          const int* s_edge_row, int64_t out_row0) {
  const int lane = threadIdx.x & 31;
  float4 acc[NQ];
#pragma unroll
  for (int k = 0; k < NQ; ++k) acc[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int cur = -1;
  for (int e = 0; e < 2 * kWarps; ++e) {
    const int row = s_edge_row[e];
    if (row < 0) continue;
    if (row != cur) {
      if (cur >= 0) reduce_row<N_IN, NQ>(a, g, acc, out_row0 + cur);
      cur = row;
    }
#pragma unroll
    for (int k = 0; k < NQ; ++k) {
      const float4 x = s_edge[(e * NQ + k) * 32 + lane];
      acc[k].x += x.x;
      acc[k].y += x.y;
      acc[k].z += x.z;
      acc[k].w += x.w;
    }
  }
  if (cur >= 0) reduce_row<N_IN, NQ>(a, g, acc, out_row0 + cur);
}

template <int N_IN, int NQ>
__global__ void __launch_bounds__(kThreads, NQ <= 2 ? kMinCtasPerSm : 2) ttmc_blocked_kernel(const Args a) {
  // The warps' edges (kWarps x 2 x NQ x 32 float4s), then the row counts
  // (rows ints: counts, then places).
  extern __shared__ float4 s_edge[];
  int* s_count = reinterpret_cast<int*>(s_edge + kWarps * 2 * NQ * 32);
  __shared__ uint16_t s_perm[kSortSlots];
  __shared__ int s_edge_row[kWarps * 2];
  __shared__ int s_warp[kWarps];

  // CTA b takes (row part, column slice) b % slices of block range
  // b / slices: those of one range run side by side, so the stream they
  // read is in L2 for all but the first.
  const int64_t range = blockIdx.x / a.slices;
  const int64_t ranges = gridDim.x / a.slices;
  const int sub = static_cast<int>(blockIdx.x % a.slices);
  const int row0 = (sub / a.col_slices) * a.rows;  // first tile row of this CTA
  const int rows_here = a.tile_i - row0 < a.rows ? a.tile_i - row0 : a.rows;
  const int lane = threadIdx.x & 31;

  Quads<N_IN, NQ> g;
  const int r_last = a.rank[N_IN - 1];
#pragma unroll
  for (int k = 0; k < NQ; ++k) {
    const int quad = (sub % a.col_slices) * 32 * NQ + k * 32 + lane;
    int lead = 0, d = 0;
    g.nv[k] = 0;
    if (quad < a.nquads) {
      lead = quad / a.qpl;
      d = (quad - lead * a.qpl) * kQ;
      g.nv[k] = r_last - d < kQ ? r_last - d : kQ;
    }
    g.col[k] = lead * r_last + d;
    g.dig[k][N_IN - 1] = d;
#pragma unroll
    for (int n = N_IN - 2; n >= 0; --n) {
      g.dig[k][n] = lead % a.rank[n];
      lead /= a.rank[n];
    }
  }

  for (int i = threadIdx.x; i < rows_here; i += kThreads) s_count[i] = 0;
  __syncthreads();
  // The sort keeps each slot's offset in the chunk, at its place.
  const auto no_fetch = [](int) { return NoFields{}; };
  const auto keep_offset = [&](int pos, int o, int, float, NoFields) {
    s_perm[pos] = static_cast<uint16_t>(o);
  };

  const int64_t per = (a.nblocks + ranges - 1) / ranges;
  const int64_t b_begin = range * per;
  const int64_t b_end = b_begin + per < a.nblocks ? b_begin + per : a.nblocks;
  int64_t b = b_begin;
  while (b < b_end) {
    // This output tile's blocks in the range: [b, e).
    const int tile = a.block_it[b];
    int64_t e = b;
    for (;;) {
      const int64_t x = e + lane;
      const unsigned other = __ballot_sync(0xffffffffu, x >= b_end || a.block_it[x] != tile);
      if (other != 0u) {
        e += __ffs(other) - 1;
        break;
      }
      e += 32;
    }
    const int64_t s_end = e * a.blk;
    for (int64_t s0 = b * a.blk; s0 < s_end; s0 += kSortSlots) {
      const int n = s_end - s0 < kSortSlots ? static_cast<int>(s_end - s0) : kSortSlots;
      sort_pass<false>(a, s_count, s0, n, row0, rows_here, no_fetch, keep_offset);  // counts
      __syncthreads();  // row counts complete
      const int total = exclusive_scan(s_count, rows_here, s_warp);
      sort_pass<true>(a, s_count, s0, n, row0, rows_here, no_fetch, keep_offset);  // places
      __syncthreads();  // the permutation is complete
      for (int i = threadIdx.x; i < rows_here; i += kThreads) s_count[i] = 0;
      const int64_t out_row0 = static_cast<int64_t>(tile) * a.tile_i;
      warp_rows<N_IN, NQ>(a, s_perm, total, s0, out_row0, g, s_edge, s_edge_row);
      __syncthreads();  // the chunk's rows are done; the permutation is free; the edges are kept
      if (threadIdx.x < 32) add_edges<N_IN, NQ>(a, g, s_edge, s_edge_row, out_row0);
      __syncthreads();  // the edges are free
    }
    b = e;
  }
}

// Shape the grid and launch: row parts of at most kMaxRows rows, column
// slices of 32 * NQ quads.  Returns 0, else a cudaError_t.
template <int N_IN, int NQ>
int launch(Args a, int device, cudaStream_t stream) {
  a.parts = (a.tile_i + kMaxRows - 1) / kMaxRows;
  a.rows = (a.tile_i + a.parts - 1) / a.parts;
  a.col_slices = (a.nquads + 32 * NQ - 1) / (32 * NQ);
  if (static_cast<long long>(a.parts) * a.col_slices > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.slices = a.parts * a.col_slices;
  const size_t smem = kWarps * 2 * NQ * 32 * sizeof(float4) + static_cast<size_t>(a.rows) * sizeof(int);
  const int err = launch_ranges(ttmc_blocked_kernel<N_IN, NQ>, a, smem, device, stream);
  return err == -1 ? static_cast<int>(cudaErrorInvalidConfiguration) : err;
}

// The quads a lane holds: the fewest of 1, 2, 4, kMaxQuads that hold a
// row, else kMaxQuads in column slices.
template <int N_IN>
int launch_quads(const Args& a, int device, cudaStream_t stream) {
  if (a.nquads <= 32) return launch<N_IN, 1>(a, device, stream);
  if (a.nquads <= 64) return launch<N_IN, 2>(a, device, stream);
  if (a.nquads <= 128) return launch<N_IN, 4>(a, device, stream);
  return launch<N_IN, kMaxQuads>(a, device, stream);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// Launch on `stream`.  The pointer arrays hold n_in device pointers each,
// and in_tiles / ld / ranks n_in ints, in plan.in_modes order.  Any tile_i
// and ranks run.  Returns 0 on success, else a cudaError_t.
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
  for (int n = 0; n < n_in; ++n) {
    if (ranks[n] < 1 || ld[n] < ranks[n]) return static_cast<int>(cudaErrorInvalidValue);
    a.in_locs[n] = in_locs[n];
    a.block_in[n] = block_in[n];
    a.factors[n] = factors[n];
    a.in_tiles[n] = in_tiles[n];
    a.ld[n] = ld[n];
    a.rank[n] = ranks[n];
    ncols *= ranks[n];
    if (ncols > ldo) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nblocks == 0) return 0;
  const int r_last = ranks[n_in - 1];
  a.vals = vals;
  a.iloc = iloc;
  a.block_it = block_it;
  a.out = out;
  a.nblocks = nblocks;
  a.blk = blk;
  a.tile_i = tile_i;
  a.ldo = ldo;
  a.qpl = (r_last + kQ - 1) / kQ;
  a.nquads = static_cast<int>(ncols / r_last) * a.qpl;
  a.vec = r_last % 4 == 0 && ld[n_in - 1] % 4 == 0 && ldo % 4 == 0 && aligned16(factors[n_in - 1]) &&
          aligned16(out);
  a.same_d = 32 % a.qpl == 0;

  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_in) {
    case 2: return launch_quads<2>(a, device, s);
    case 3: return launch_quads<3>(a, device, s);
    default: return launch_quads<4>(a, device, s);
  }
}
