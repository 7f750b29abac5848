// The kernel as it was before its wide path (plans of more than 4 input
// modes) was added to src/repro_torch/kernels/csrc/mttkrp.cu, kept to be timed
// in turns beside the current source (chip_smoke.py phase k): the 2-4-input
// templates must run as fast as they did.  It includes
// blocked_before_wide.cuh, the copy of csrc/blocked.cuh it was written
// against.
//
// Blocked sorted-COO MTTKRP for Hopper (sm_90a), fp32 throughout.
//
// Replaces the TPU kernel src/repro/kernels/mttkrp_pallas.py:53 _kernel
// (launched by mttkrp_pallas_call).  It computes the same function on the
// same BlockPlan layout:
//
//     out[block_it[b]*tile_i + iloc[s], :] +=
//         vals[s] * prod_n F_n[block_in[n][b]*in_tiles[n] + in_locs[n][s], :]
//
// for every slot s of every plan block b, with 2, 3 or 4 input modes
// (3-, 4- and 5-mode tensors; the template parameter N_IN plays the part of
// the Pallas template unroll).  Every factor and the output have rows of ld
// floats (the padded rank).
//
// Bound: memory bytes, not operations.  Each non-zero moves its value and
// N indices (16 B for 3 modes) and gathers N-1 factor rows, and does only
// N flops per rank column.  At rank 16 the factors (3 MB at NELL-2 size)
// stay in L2, so what a slot costs is its stream fields, two 64-byte
// gathers from L2, and the instructions around them.
//
// The kernel this design replaced (scripts/probe_kernels/mttkrp_pr17.cu)
// summed each output tile in shared memory: every 256-slot chunk was
// compacted behind three barriers, then one thread per (slot, column) did a
// 4-byte gather and a shared-memory atomic.  Its probe
// (scripts/torch_mttkrp_probe.py, PERF.md Findings) put 2.9 ms of its
// 5.2-6.0 ms per mode at NELL-2 size in that loop and 2.0-2.7 ms in the tile
// atomics, and 1.2-1.9 ms in the tail of its one wave of long ranges.
//
// Design:
//   * Ranges.  A mode has only 36-113 output-tile runs at NELL-2 size, too
//     few for 132 SMs, so CTAs take contiguous ranges of plan blocks, at
//     most kBlocksPerCta (64) each (launch_ranges in blocked.cuh): many
//     short ranges, so no CTA holds a long tail.  A plan too small for a
//     wave of 64-block ranges still gets ranges of at least
//     kMinBlocksPerCta (8) blocks (see "Sum order").
//   * Sorted fields in shared memory.  A CTA counting-sorts the real
//     (non-zero-value) slots of each output tile's part of its range by
//     tile row, kSortSlots slots at a time (sort_pass in blocked.cuh, shared
//     with the TTMc kernel: two passes over the value and row fields and a
//     CTA-wide scan; here one shared-memory atomic per slot, which beat one
//     per row and warp).  The second pass also reads each real slot's
//     factor-row fields in stream order (coalesced) and stores row, value
//     and factor rows at the slot's sorted place as one 16-byte struct
//     (3-mode tensors), so the row phase reads them in order with one
//     vector load.  A first version kept only a permutation of 16-bit
//     offsets, as the TTMc kernel does, and read the fields from L2 through
//     it: 1.2-1.8 ms of 3.0-3.6 per mode went to those scattered reads.
//   * Rows in registers, a group of lanes per slot.  A row of ld floats is
//     ceil(ld / 4) quads; a group of G lanes (4 at rank 16) holds one row,
//     NQ quads a lane (a lane holds quads gl, gl + G, ...), so a warp walks
//     32 / G slots at once.  Each group takes an equal, contiguous part of
//     the sorted slots and walks it slot by slot: one float4 load of each
//     factor row straight from L2 (16-byte aligned: rank_padded makes ld a
//     multiple of 4), the value folded in the plain version's order,
//     ((v * F_0) * F_1) ..., and fp32 FMAs into its register sums.  More
//     slots in flight per group, more CTAs per SM at fewer registers, and
//     fewer CTAs at more all ran slower (PERF.md, Findings).
//   * Output.  When its row changes a group adds its sums to the output
//     with float4 global reductions (scalar ones where ld is not a multiple
//     of 4 or a pointer is not 16-byte aligned).  A group's first and last
//     runs, whose rows its neighbours may share, stay in registers: a tree
//     of shuffles joins the groups' runs in order within each warp, adding
//     each run that ends inside to the output; the warps' first and last
//     runs go to shared memory, and warp 0 joins them the same way while
//     the other warps count the next chunk (walking the edges in turn
//     instead cost 0.5 ms a mode; PERF.md, Findings).  Warp 0 keeps the
//     chunk's last run as the CTA's carry (in shared memory) and joins the
//     next chunk's runs onto it, so a hot row that fills whole chunks
//     reaches the output once per block range.  There is no tile, no
//     shared-memory atomic per product, and no flush.
//   * Any tile_i.  The row counts take tile_i ints of shared memory; past
//     kMaxRows rows the tile splits into row parts, one CTA each, and a CTA
//     keeps only the slots of its rows.  At tile_i 256 there is one part.
//   * Any width.  Groups grow to 32 lanes (128 columns), then a lane holds
//     2, 4 or kMaxQuads quads; past 32 * kMaxQuads quads (1,024 columns) the
//     row splits into column slices, one CTA each, which re-read the stream
//     fields and redo the sort, but copy nothing.
//   * Sum order.  No float32 chain per output element is longer than
//     kChain (32) slots.  A group's part of a chunk is kSortSlots / (kThreads
//     / G) slots: 32 at rank 16 (G = 4), but 256 from rank 113 on (G = 32),
//     where a hot row that fills the part would otherwise be one 256-slot
//     chain.  Groups wider than 4 lanes therefore sum a run in sub-chains of
//     kChain slots, each folded into a second register sum when it is full
//     (a two-level sum: at most 8 folds a part).  A compensated (two-sum)
//     fold would also have bounded the error, but costs 3 more adds a
//     column and slot on every width; the sub-chains cost one add a column
//     per kChain slots, and none at all on the rank-16 path, whose parts are
//     never longer than kChain.  The runs of one row then join in group and
//     warp order (a tree), and across the chunks of a block range in the
//     carry.  What is left in float32 is the sum of the ranges' partial
//     sums, which float atomics take in an order that varies from launch to
//     launch.  scripts/torch_hot_rows_probe.py measures it on a tensor
//     whose hottest row holds 41,700 of 50,000 non-zeros, 100 launches per
//     case: with sub-chains alone, launches at rank 16 still passed 1e-5 of
//     a column's max, where a small plan's one wave of CTAs gave 1-block
//     ranges and so a hot row hundreds of partial sums; the 8-block floor
//     on a range (no NELL-2-size plan is affected: theirs are 64-block
//     ranges) brought rank 16's worst launch from 1.3e-5 to 5.9e-6, the
//     sub-chains rank 256's from 1.0e-5 to 4.5e-6, and the carry rank
//     256's from 6.9e-6 to 4.5e-6 (PERF.md, Findings).  The reductions and the atomic
//     counting sort still make the order in which contributions reach an
//     output element vary from run to run, so results differ from the
//     plain version (and between runs) in the last bits of float32.
//
// Offsets into the stream, the factors and the output are computed in 64
// bits.  The kernel allocates nothing and does not synchronise; the wrapper
// (kernels/mttkrp.py) zeroes the output, checks every argument, and raises
// on a non-zero return code.

#include <cuda_runtime.h>
#include <stdint.h>

#include "blocked_before_wide.cuh"

namespace {

constexpr int kMaxIn = 4;
constexpr int kSortSlots = 2048;    // slots sorted at once, their fields in shared memory
constexpr int kPlaceUnroll = 4;     // rounds of the placing sort pass read at once (registers)
constexpr int kQ = 4;               // columns per quad: one float4
constexpr int kMaxQuads = 8;        // quads per lane of a 32-lane group; more make column slices
constexpr int kMaxRows = 4096;      // tile rows per CTA (16 KB of counts); more make row parts
constexpr int kChain = 32;          // slots a float32 sum of a run takes before it is folded
constexpr int kMinBlocksPerCta = 8; // fewest plan blocks in a CTA's range (see "Sum order")
// CTAs per SM the compiler keeps registers for (64 registers a thread)
// where a lane holds one quad of a 3-mode tensor's row; 2 otherwise.
constexpr int kMinCtasPerSm = 4;

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
  int nquads;      // quads of a row: ceil(ld / kQ)
  int vec;         // ld % kQ == 0 and every factor and out 16-byte aligned
  int rows;        // tile rows per CTA: ceil(tile_i / parts)
  int parts;       // row parts of an output tile
  int col_slices;  // column slices: ceil(nquads / (G * NQ))
  int slices;      // CTAs per block range: parts * col_slices
};

// This lane's quads (quad k is quad gl + G k of the CTA's column slice, gl
// the lane's place in its group): the first column of each, and the columns
// in it (0: no quad).
template <int NQ>
struct Quads {
  int col[NQ];
  int nv[NQ];
};

// A slot's factor row in each input.
template <int N_IN>
struct Ins {
  int in[N_IN];
};

// A sorted slot in shared memory: its row (less the CTA's first), value and
// factor rows, 16 bytes for 3-mode tensors, so one vector store places it
// and one vector load reads it.
template <int N_IN>
struct alignas(N_IN == 2 ? 16 : 8) Sorted {
  int row;
  float val;
  int in[N_IN];
};

// Bytes of dynamic shared memory: the warps' first and last runs and the
// carry ((2 x kWarps + 1) x G x NQ float4s), the sorted chunk (kSortSlots
// Sorted), and the row counts (rows ints).
template <int N_IN, int G, int NQ>
size_t smem_bytes(int rows) {
  return (2 * kWarps + 1) * G * NQ * sizeof(float4) + kSortSlots * sizeof(Sorted<N_IN>) +
         static_cast<size_t>(rows) * sizeof(int);
}

// Issue the loads of one slot's factor values for this lane's quads (factor
// rows `in`, one per input): one 16-byte load per quad where aligned, zero
// for no quad.
template <int N_IN, int NQ>
__device__ __forceinline__ void fetch_slot(const Args& a, const Quads<NQ>& g, const int (&in)[N_IN],
                                           float4 (&x)[N_IN][NQ]) {
#pragma unroll
  for (int n = 0; n < N_IN; ++n) {
#pragma unroll
    for (int k = 0; k < NQ; ++k) {
      const float* src = a.factors[n] + static_cast<int64_t>(in[n]) * a.ld + g.col[k];
      const int nv = g.nv[k];
      if (nv == 0) {
        x[n][k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      } else if (a.vec) {
        x[n][k] = __ldg(reinterpret_cast<const float4*>(src));
      } else {
        x[n][k] = make_float4(__ldg(src), nv > 1 ? __ldg(src + 1) : 0.0f, nv > 2 ? __ldg(src + 2) : 0.0f,
                              nv > 3 ? __ldg(src + 3) : 0.0f);
      }
    }
  }
}

// Add one slot (value v, factor values x) to this lane's sums, in the plain
// version's order: ((v * F_0) * F_1) ...
template <int N_IN, int NQ>
__device__ __forceinline__ void fold_slot(float v, const float4 (&x)[N_IN][NQ], float4 (&acc)[NQ]) {
#pragma unroll
  for (int k = 0; k < NQ; ++k) {
    float4 l = make_float4(v * x[0][k].x, v * x[0][k].y, v * x[0][k].z, v * x[0][k].w);
#pragma unroll
    for (int n = 1; n < N_IN - 1; ++n) {
      l.x *= x[n][k].x;
      l.y *= x[n][k].y;
      l.z *= x[n][k].z;
      l.w *= x[n][k].w;
    }
    acc[k].x = fmaf(l.x, x[N_IN - 1][k].x, acc[k].x);
    acc[k].y = fmaf(l.y, x[N_IN - 1][k].y, acc[k].y);
    acc[k].z = fmaf(l.z, x[N_IN - 1][k].z, acc[k].z);
    acc[k].w = fmaf(l.w, x[N_IN - 1][k].w, acc[k].w);
  }
}

// Add sums v to this lane's quad k of output row `row` (global).
template <int NQ>
__device__ __forceinline__ void add_quad(const Args& a, const Quads<NQ>& g, int k, const float4& v, int64_t row) {
  if (g.nv[k] > 0) {
    float* dst = a.out + row * a.ld + g.col[k];
    if (a.vec) {
      atomicAdd(reinterpret_cast<float4*>(dst), v);
    } else {
      const float x[kQ] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int c = 0; c < kQ; ++c) {
        if (c < g.nv[k]) atomicAdd(dst + c, x[c]);
      }
    }
  }
}

// Add this lane's sums for output row `row` (global) and clear them.
template <int NQ>
__device__ __forceinline__ void reduce_row(const Args& a, const Quads<NQ>& g, float4 (&acc)[NQ], int64_t row) {
#pragma unroll
  for (int k = 0; k < NQ; ++k) {
    add_quad<NQ>(a, g, k, acc[k], row);
    acc[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// The runs of a contiguous part of the sorted slots, in this lane's
// columns: the first (row f, sums af) and, where the part holds more than
// one, the last (row l, sums al; else l = -1).  f = -1: no run.  The runs
// between them are already in the output.
template <int NQ>
struct Runs {
  int f, l;
  float4 af[NQ], al[NQ];
};

template <int NQ>
__device__ __forceinline__ void add4(float4 (&acc)[NQ], const float4 (&x)[NQ]) {
#pragma unroll
  for (int k = 0; k < NQ; ++k) {
    acc[k].x += x[k].x;
    acc[k].y += x[k].y;
    acc[k].z += x[k].z;
    acc[k].w += x[k].w;
  }
}

template <int NQ>
__device__ __forceinline__ void copy4(float4 (&dst)[NQ], const float4 (&src)[NQ]) {
#pragma unroll
  for (int k = 0; k < NQ; ++k) dst[k] = src[k];
}

// One group's share of a sorted chunk of `total` slots: an equal,
// contiguous part, walked slot by slot with the current row's sums in
// registers.  A run's sums reach the output at each row change (rows are
// relative to out_row0), but the part's first and last runs (rows it may
// share with its neighbours) are returned.  Where a part can hold more
// than kChain slots, a run is summed in sub-chains of kChain slots, each
// folded into `done` when full (the design notes' "Sum order").
template <int N_IN, int G, int NQ>
__device__ __forceinline__ Runs<NQ> group_rows(const Args& a, const Sorted<N_IN>* s_sorted, int total,
                                               int64_t out_row0, const Quads<NQ>& g) {
  constexpr int kGroups = kThreads / G;
  constexpr bool kTwoLevel = kSortSlots / kGroups > kChain;
  const int grp = threadIdx.x / G;
  float4 done[NQ];  // the run's full sub-chains (unused where !kTwoLevel)
  int chain = 0;    // slots in the current sub-chain
  if constexpr (kTwoLevel) {
#pragma unroll
    for (int k = 0; k < NQ; ++k) done[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  Runs<NQ> r;
  r.f = -1;
  r.l = -1;
  float4 acc[NQ];
#pragma unroll
  for (int k = 0; k < NQ; ++k) {
    acc[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    r.al[k] = acc[k];
  }

  const int p_end = (grp + 1) * total / kGroups;
  int cur = -1;
  for (int p = grp * total / kGroups; p < p_end; ++p) {
    const Sorted<N_IN> f = s_sorted[p];
    float4 x[N_IN][NQ];
    fetch_slot<N_IN, NQ>(a, g, f.in, x);
    if (f.row != cur) {
      if constexpr (kTwoLevel) {  // the run's sum: its full sub-chains and the current one
        add4<NQ>(acc, done);
#pragma unroll
        for (int k = 0; k < NQ; ++k) done[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        chain = 0;
      }
      if (cur >= 0) {
        if (r.f < 0) {
          r.f = cur;
#pragma unroll
          for (int k = 0; k < NQ; ++k) {
            r.af[k] = acc[k];
            acc[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          }
        } else {
          reduce_row<NQ>(a, g, acc, out_row0 + cur);
        }
      }
      cur = f.row;
    }
    fold_slot<N_IN, NQ>(f.val, x, acc);
    if constexpr (kTwoLevel) {
      if (++chain == kChain) {
        add4<NQ>(done, acc);
#pragma unroll
        for (int k = 0; k < NQ; ++k) acc[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        chain = 0;
      }
    }
  }
  if constexpr (kTwoLevel) add4<NQ>(acc, done);
  if (r.f < 0) {  // one run, or none: it is the first
    r.f = cur;
    copy4<NQ>(r.af, acc);
  } else {
    r.l = cur;
    copy4<NQ>(r.al, acc);
  }
  return r;
}

// Join the runs of the part that follows (r) onto those of part A: a run
// that ends inside the joined part reaches the output, one reduction each.
template <int NQ>
__device__ __forceinline__ void join(const Args& a, const Quads<NQ>& g, Runs<NQ>& A, Runs<NQ>& r,
                                     int64_t out_row0) {
  if (r.f < 0) return;
  if (A.f < 0) {
    A.f = r.f;
    A.l = r.l;
    copy4<NQ>(A.af, r.af);
    copy4<NQ>(A.al, r.al);
    return;
  }
  if ((A.l >= 0 ? A.l : A.f) == r.f) {  // r's first run goes on with A's last
    if (A.l >= 0) {
      add4<NQ>(A.al, r.af);
    } else {
      add4<NQ>(A.af, r.af);
    }
    if (r.l < 0) return;
    if (A.l >= 0) reduce_row<NQ>(a, g, A.al, out_row0 + A.l);
  } else {
    if (A.l >= 0) reduce_row<NQ>(a, g, A.al, out_row0 + A.l);
    if (r.l < 0) {  // r's only run is the joined part's last
      A.l = r.f;
      copy4<NQ>(A.al, r.af);
      return;
    }
    reduce_row<NQ>(a, g, r.af, out_row0 + r.f);
  }
  A.l = r.l;
  copy4<NQ>(A.al, r.al);
}

// The runs held by the lane `delta` lanes up (every lane of the warp calls).
template <int NQ>
__device__ __forceinline__ Runs<NQ> shfl_down_runs(const Runs<NQ>& r, int delta) {
  constexpr unsigned kFull = 0xffffffffu;
  Runs<NQ> o;
  o.f = __shfl_down_sync(kFull, r.f, delta);
  o.l = __shfl_down_sync(kFull, r.l, delta);
#pragma unroll
  for (int k = 0; k < NQ; ++k) {
    o.af[k] = make_float4(__shfl_down_sync(kFull, r.af[k].x, delta), __shfl_down_sync(kFull, r.af[k].y, delta),
                          __shfl_down_sync(kFull, r.af[k].z, delta), __shfl_down_sync(kFull, r.af[k].w, delta));
    o.al[k] = make_float4(__shfl_down_sync(kFull, r.al[k].x, delta), __shfl_down_sync(kFull, r.al[k].y, delta),
                          __shfl_down_sync(kFull, r.al[k].z, delta), __shfl_down_sync(kFull, r.al[k].w, delta));
  }
  return o;
}

// Join the runs of a warp's 32 / G groups in group order, by a tree of
// shuffles; the warp's first group ends with the warp's runs.
template <int G, int NQ>
__device__ __forceinline__ void join_warp(const Args& a, const Quads<NQ>& g, Runs<NQ>& r, int64_t out_row0) {
  const int gi = (threadIdx.x & 31) / G;
#pragma unroll
  for (int s = 1; s < 32 / G; s <<= 1) {
    Runs<NQ> o = shfl_down_runs<NQ>(r, s * G);
    if (gi % (2 * s) == 0) join<NQ>(a, g, r, o, out_row0);
  }
}

// After a chunk's rows: join each warp's groups' runs and keep the warp's
// runs in shared memory (slots 2w and 2w + 1 for warp w).
template <int G, int NQ>
__device__ __forceinline__ void keep_warp_runs(const Args& a, const Quads<NQ>& g, Runs<NQ>& r,
                                               int64_t out_row0, float4* s_runs, int* s_run_row) {
  join_warp<G, NQ>(a, g, r, out_row0);
  if ((threadIdx.x & 31) >= G) return;
  const int w = threadIdx.x >> 5;
  const int gl = threadIdx.x % G;
#pragma unroll
  for (int k = 0; k < NQ; ++k) {
    s_runs[((2 * w) * NQ + k) * G + gl] = r.af[k];
    s_runs[((2 * w + 1) * NQ + k) * G + gl] = r.al[k];
  }
  if (gl == 0) {
    s_run_row[2 * w] = r.f;
    s_run_row[2 * w + 1] = r.l;
  }
}

// After every warp's runs are kept (a barrier between), by warp 0: join the
// warps' runs in warp order (each group of warp 0 a share of the warps,
// then a tree), then join the result onto the carry, the last run of the
// CTA's chunks so far (its global row in s_run_row[2 * kWarps], -1: none;
// its sums in s_carry): a run that ends in the chunk reaches the output,
// and the chunk's last run becomes the carry.  So a row that fills many
// chunks of a block range reaches the output once per range.  The kernel
// does this for a chunk while the other warps count the next one, whose
// next barrier comes before any warp keeps its runs again.
template <int G, int NQ>
__device__ __forceinline__ void add_runs(const Args& a, const Quads<NQ>& g, const float4* s_runs,
                                         int* s_run_row, float4* s_carry, int64_t out_row0) {
  constexpr int kPer = kWarps / (32 / G);  // warps' runs per group of warp 0
  const int gi = threadIdx.x / G;
  const int gl = threadIdx.x % G;
  const int carry = s_run_row[2 * kWarps];
  Runs<NQ> r;
  r.f = -1;
  r.l = -1;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int w = gi * kPer + j;
    Runs<NQ> o;
    o.f = s_run_row[2 * w];
    o.l = s_run_row[2 * w + 1];
#pragma unroll
    for (int k = 0; k < NQ; ++k) {
      o.af[k] = s_runs[((2 * w) * NQ + k) * G + gl];
      o.al[k] = s_runs[((2 * w + 1) * NQ + k) * G + gl];
    }
    join<NQ>(a, g, r, o, out_row0);
  }
  join_warp<G, NQ>(a, g, r, out_row0);
  int kept = carry;
  if (gi == 0 && r.f >= 0) {  // group 0 holds the chunk's runs, each lane its quads
    const int first = static_cast<int>(out_row0) + r.f;
#pragma unroll
    for (int k = 0; k < NQ; ++k) {
      const float4 c = s_carry[k * G + gl];
      if (carry == first) {  // the carried run goes on in this chunk
        r.af[k].x += c.x;
        r.af[k].y += c.y;
        r.af[k].z += c.z;
        r.af[k].w += c.w;
      } else if (carry >= 0) {
        add_quad<NQ>(a, g, k, c, carry);
      }
    }
    if (r.l >= 0) {
      reduce_row<NQ>(a, g, r.af, out_row0 + r.f);
#pragma unroll
      for (int k = 0; k < NQ; ++k) s_carry[k * G + gl] = r.al[k];
      kept = static_cast<int>(out_row0) + r.l;
    } else {
#pragma unroll
      for (int k = 0; k < NQ; ++k) s_carry[k * G + gl] = r.af[k];
      kept = first;
    }
  }
  __syncwarp();  // every lane has read the carry's row
  if (threadIdx.x == 0) s_run_row[2 * kWarps] = kept;
}

template <int N_IN, int G, int NQ>
__global__ void __launch_bounds__(kThreads, N_IN == 2 && NQ == 1 ? kMinCtasPerSm : 2)
    mttkrp_blocked_kernel(const Args a) {
  // Laid out as smem_bytes says.
  extern __shared__ float4 s_runs[];
  float4* s_carry = s_runs + 2 * kWarps * G * NQ;
  Sorted<N_IN>* s_sorted = reinterpret_cast<Sorted<N_IN>*>(s_carry + G * NQ);
  int* s_count = reinterpret_cast<int*>(s_sorted + kSortSlots);
  __shared__ int s_run_row[2 * kWarps + 1];  // the warps' runs' rows, and the carry's global row
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
  const int gl = threadIdx.x % G;

  Quads<NQ> g;
#pragma unroll
  for (int k = 0; k < NQ; ++k) {
    const int quad = (sub % a.col_slices) * G * NQ + k * G + gl;
    const int left = a.ld - quad * kQ;
    g.nv[k] = quad < a.nquads ? (left < kQ ? left : kQ) : 0;
    g.col[k] = quad < a.nquads ? quad * kQ : 0;
  }

  for (int i = threadIdx.x; i < rows_here; i += kThreads) s_count[i] = 0;
  if (threadIdx.x == 0) s_run_row[2 * kWarps] = -1;
  __syncthreads();

  const int64_t per = (a.nblocks + ranges - 1) / ranges;
  const int64_t b_begin = range * per;
  const int64_t b_end = b_begin + per < a.nblocks ? b_begin + per : a.nblocks;
  int64_t pending = -1;  // the output row of the chunk whose warps' runs wait to be added, if any
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
    const int64_t out_row0 = static_cast<int64_t>(tile) * a.tile_i + row0;
    for (int64_t s0 = b * a.blk; s0 < s_end; s0 += kSortSlots) {
      const int n = s_end - s0 < kSortSlots ? static_cast<int>(s_end - s0) : kSortSlots;
      // A slot's factor rows, read in stream order; its block found from
      // its offset in the tile run with a 32-bit division where that fits.
      const int64_t rel0 = s0 - b * a.blk;
      const auto fetch = [&](int o) {
        const int64_t rel = rel0 + o;
        const int64_t bs = b + (rel <= 0x7fffffff ? static_cast<int64_t>(static_cast<uint32_t>(rel) /
                                                                        static_cast<uint32_t>(a.blk))
                                                  : rel / a.blk);
        Ins<N_IN> x;
#pragma unroll
        for (int m = 0; m < N_IN; ++m) x.in[m] = a.block_in[m][bs] * a.in_tiles[m] + a.in_locs[m][s0 + o];
        return x;
      };
      const auto place = [&](int pos, int, int row, float v, const Ins<N_IN>& x) {
        Sorted<N_IN> f;
        f.row = row;
        f.val = v;
#pragma unroll
        for (int m = 0; m < N_IN; ++m) f.in[m] = x.in[m];
        s_sorted[pos] = f;
      };
      if (pending >= 0 && threadIdx.x < 32) add_runs<G, NQ>(a, g, s_runs, s_run_row, s_carry, pending);
      sort_pass<false, kSortUnroll, false>(a, s_count, s0, n, row0, rows_here, fetch, place);  // counts
      __syncthreads();  // row counts complete; the last chunk's runs are added
      const int total = exclusive_scan(s_count, rows_here, s_warp);
      sort_pass<true, kPlaceUnroll, false>(a, s_count, s0, n, row0, rows_here, fetch, place);  // places
      __syncthreads();  // the sorted fields are complete
      for (int i = threadIdx.x; i < rows_here; i += kThreads) s_count[i] = 0;
      Runs<NQ> runs = group_rows<N_IN, G, NQ>(a, s_sorted, total, out_row0, g);
      keep_warp_runs<G, NQ>(a, g, runs, out_row0, s_runs, s_run_row);
      __syncthreads();  // the chunk's rows are done; the fields are free; the warps' runs are kept
      pending = out_row0;
    }
    b = e;
  }
  if (threadIdx.x < 32) {
    if (pending >= 0) add_runs<G, NQ>(a, g, s_runs, s_run_row, s_carry, pending);
    __syncwarp();  // the carry as the last chunk left it
    const int carry = s_run_row[2 * kWarps];
    if (carry >= 0 && threadIdx.x < G) {
#pragma unroll
      for (int k = 0; k < NQ; ++k) add_quad<NQ>(a, g, k, s_carry[k * G + gl], carry);
    }
  }
}

// Shape the grid and launch: row parts of at most kMaxRows rows, column
// slices of G * NQ quads.  Returns 0, else a cudaError_t.
template <int N_IN, int G, int NQ>
int launch(Args a, int device, cudaStream_t stream) {
  a.parts = (a.tile_i + kMaxRows - 1) / kMaxRows;
  a.rows = (a.tile_i + a.parts - 1) / a.parts;
  a.col_slices = (a.nquads + G * NQ - 1) / (G * NQ);
  if (static_cast<long long>(a.parts) * a.col_slices > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.slices = a.parts * a.col_slices;
  const int err = launch_ranges(mttkrp_blocked_kernel<N_IN, G, NQ>, a, smem_bytes<N_IN, G, NQ>(a.rows), device,
                                stream, kMinBlocksPerCta);
  return err == -1 ? static_cast<int>(cudaErrorInvalidConfiguration) : err;
}

// The group that holds a row: the fewest of 4, 8, 16, 32 lanes with one
// quad each, else 32 lanes with the fewest of 2, 4, kMaxQuads quads each
// (in column slices past that).
template <int N_IN>
int launch_width(const Args& a, int device, cudaStream_t stream) {
  if (a.nquads <= 4) return launch<N_IN, 4, 1>(a, device, stream);
  if (a.nquads <= 8) return launch<N_IN, 8, 1>(a, device, stream);
  if (a.nquads <= 16) return launch<N_IN, 16, 1>(a, device, stream);
  if (a.nquads <= 32) return launch<N_IN, 32, 1>(a, device, stream);
  if (a.nquads <= 64) return launch<N_IN, 32, 2>(a, device, stream);
  if (a.nquads <= 128) return launch<N_IN, 32, 4>(a, device, stream);
  return launch<N_IN, 32, kMaxQuads>(a, device, stream);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// Launch on `stream`.  The pointer arrays hold n_in device pointers each,
// in plan.in_modes order.  Any tile_i and ld run.  Returns 0 on success,
// else a cudaError_t.
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
  a.vec = ld % kQ == 0 && aligned16(out);
  for (int n = 0; n < n_in; ++n) {
    a.in_locs[n] = in_locs[n];
    a.block_in[n] = block_in[n];
    a.factors[n] = factors[n];
    a.in_tiles[n] = in_tiles[n];
    a.vec = a.vec && aligned16(factors[n]);
  }
  a.out = out;
  a.nblocks = nblocks;
  a.blk = blk;
  a.tile_i = tile_i;
  a.ld = ld;
  a.nquads = (ld + kQ - 1) / kQ;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_in) {
    case 2: return launch_width<2>(a, device, s);
    case 3: return launch_width<3>(a, device, s);
    default: return launch_width<4>(a, device, s);
  }
}
