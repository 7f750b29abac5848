// The kernel as it was before its wide path (plans of more than 4 input
// modes) was added to src/repro_torch/kernels/csrc/ttcore.cu, kept to be timed
// in turns beside the current source (chip_smoke.py phase k): the 2-4-input
// templates must run as fast as they did.  It includes
// blocked_before_wide.cuh, the copy of csrc/blocked.cuh it was written
// against.
//
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
// in_locs[n][s].  `left` chains the first n_left inputs, ascending:
// left'[q] = sum_p left[p] * W_n[p*rr_n + q], starting from the first
// input's row (its rl is 1).  `right` chains the others, descending:
// right'[p] = sum_q W_n[p*rr_n + q] * right[q], starting from the last
// input's row (its rr is 1).  left has rl_m entries, right rr_m, and B has
// ncols = rl_m * rr_m true columns in rows of ldo floats.  2, 3 or 4 inputs
// (template parameter N_IN); n_left, the pairs and the strides are taken at
// run time.  Only the rl_n * rr_n true lanes of a row enter a product.
//
// Bound: operations.  The stream is 16 B per non-zero (3 modes), and the
// work is 2 * ncols flops per non-zero for the product and sum, plus a
// multiply-add per matrix element of each chain step after a chain's first
// (about 530-560 flops per non-zero at TT ranks (16, 16)): 0.6 ms per mode
// at NELL-2 size on 67 TFLOP/s.  What a mode with a matrix step really has
// to move is the gathered rows: at modes 0 and 2 of a 3-mode tensor each
// non-zero reads a 1 KB row of W_1, 78.7 GB per mode at NELL-2 size.  W_1
// (9.4 MB) stays in L2; gathering those rows in the plans' own order runs at
// 16-20 TB/s on an H100 (scripts/torch_ttcore_probe.py), about 4 ms per mode.
//
// Design.  As in the TTMc kernel (blocked.cuh), CTAs take ranges of at most
// kBlocksPerCta plan blocks (a mode has only 36-113 output-tile runs, too
// few for 132 SMs), and each CTA sums into a tile of shared memory, flushed
// with one global atomic per non-zero element when the range moves to
// another output tile.  The tile spans every output column where it can (at
// most 1,024); where tile_i rows of them would pass 64 KB, the grid splits
// the tile's rows into parts, and only then its columns into slices: each
// CTA of a block range takes one (row part, column slice).  A row part keeps
// only the slots of its rows, so each slot's chains are computed by one CTA
// (the middle mode of a 3-mode tensor at TT ranks (16, 16) has 256 columns:
// 4 parts of 64 rows); a column slice would redo them (PERF.md, Findings,
// measured both).  Each step takes up to `chunk` slots of a block, keeps
// the non-zero ones of the CTA's rows (plans are 28-99% padding) and
// counting-sorts them by row.  Then, for the sorted slots:
//   * Chains, with many gathers in flight.  Every row address is known once
//     the step is sorted.  Where each chain is one row and at most one
//     matrix step of at most 256 floats with rr_n in {4, 8, 16, 32} (every
//     mode of a 3-mode tensor at TT ranks (16, 16)), a group of 8 lanes
//     takes a slot, 32 slots per CTA at once: each lane issues all of its
//     16-byte loads of the slot's rows (lane g reads float4s g, g + 8, ...,
//     neighbouring lanes on neighbouring addresses) before it uses any, and
//     keeps them in registers.  A staging ring in shared memory filled by
//     cp.async, one warp per slot, was measured slower (PERF.md, Findings): with
//     so few warps per SM each slot's arithmetic stood in the way.
//   * Both step directions read the row the same way.  In a left step all
//     float4s of a lane hold the same 4 output columns, so the lane sums a
//     float4 over its rows and lanes with equal g % (rr_n / 4) combine with
//     shuffles; in a right step the lanes of one matrix row combine their
//     float4 dot products with shuffles.
//   * Row copies.  Where each chain is one row (the middle mode of a 3-mode
//     tensor) the rows are gathered straight into the staged vectors, float4
//     by float4, consecutive threads on one slot, 8 loads in flight each.
//   * Any other chains (4- and 5-mode tensors, other bond widths) take a warp
//     per slot: groups of pow2(rr_n) lanes read consecutive elements of the
//     row from L2 (float4s where rr_n is 4, 8, ..., 128) and combine their
//     sums with shuffles, passing the chain vector on through shared memory.
//   * Column phase.  Each thread owns 4 consecutive columns (1 where rr_m is
//     not a multiple of 4) of a segment of the sorted slots, sums each run of
//     one row in registers and adds it to the tile with float4 reads and
//     writes.  Only a run whose row the neighbouring segment shares adds with
//     shared-memory atomics (a compare-and-swap loop on sm_90a).
//   * The step's slot fields (value, rows, input tiles) are read one step
//     ahead, while the previous step's chains and columns run.
//   * Any bond width, any tile_i.  The slots per step and the row parts are
//     chosen at launch from the shared-memory budget, so every bond the
//     reference takes runs; a launch is refused only if one slot's staged
//     vectors do not fit beside a 1-row tile.
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

#include "blocked_before_wide.cuh"

namespace {

constexpr int kMaxIn = 4;
constexpr int kGather = 8;   // row-copy loads in flight per thread
constexpr int kGroup = 8;    // lanes per slot in the register path
constexpr int kGroupK = 8;   // float4s of a matrix row per lane there: rows of <= 256 floats
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kTileBytes = 64 * 1024;  // largest tile before it splits into row parts
// CTAs per SM the compiler must leave room for (at most 64 registers a
// thread).  Left free it takes 100-128, 2 CTAs fit per SM, and modes 0 and 2
// of the NELL-2-size TT at ranks (16, 16) run 22-35% slower (PERF.md, Findings).
constexpr int kMinCtasPerSm = 4;

struct Args {
  const float* vals;
  const int* iloc;
  const int* block_it;
  const int* in_locs[kMaxIn];
  const int* block_in[kMaxIn];
  const float* factors[kMaxIn];
  int in_tiles[kMaxIn];
  int ld[kMaxIn];     // row stride of each interface matrix
  int rl[kMaxIn];     // left bond of each input
  int rr[kMaxIn];     // right bond of each input
  int quad[kMaxIn];   // 1 where rr is 4 * rr4 with rr4 dividing 32: float4 steps
  int sh[kMaxIn];     // log2(rr / 4) where quad
  int width[kMaxIn];  // lanes per matrix row otherwise: pow2(rr), at most 32
  int n_left;         // inputs chained from the left
  int rl_m;           // entries of `left`
  int rr_m;           // entries of `right`
  int rl4;            // first float of `right` in a staged slot: rl_m rounded up to 4
  int stage4;         // floats of a staged slot: rl4 + rr_m rounded up to 4
  int copy;           // 1 when each chain is one row (N_IN = 2, n_left = 1)
  int copy4;          // float4s of a staged slot where copies go by float4, else 0
  int group;          // 1 for the register path (see the design note)
  int maxw4;          // floats of a chain vector (warp path): the widest bond rounded up to 4
  int quad_cols;      // 1 when rr_m is a multiple of 4: float4 columns
  float* out;
  int64_t nblocks;
  int blk;
  int tile_i;
  int ldo;     // row stride of out
  int ncols;   // true output columns: rl_m * rr_m
  int slice;       // columns per CTA: a power of two, at least kMinSlice
  int col_slices;  // column slices: ceil(ncols / slice)
  int rows;        // tile rows per CTA: ceil(tile_i / parts)
  int parts;       // row parts of an output tile
  int slices;      // CTAs per block range: parts * col_slices
  int chunk;       // slots per step, at most kChunk
};

__device__ __forceinline__ float4 fma4(float s, float4 m, float4 acc) {
  return make_float4(fmaf(s, m.x, acc.x), fmaf(s, m.y, acc.y), fmaf(s, m.z, acc.z),
                     fmaf(s, m.w, acc.w));
}

__device__ __forceinline__ float4 shfl_xor4(float4 v, int d) {
  return make_float4(__shfl_xor_sync(kFull, v.x, d), __shfl_xor_sync(kFull, v.y, d),
                     __shfl_xor_sync(kFull, v.z, d), __shfl_xor_sync(kFull, v.w, d));
}

// One warp: y[q] = sum_p x[p] * w[p*rr + q] for q < rr, w the (rl, rr)
// matrix row-major.  x and w in shared memory or device memory, y in shared
// memory; every lane calls it.
__device__ __forceinline__ void left_step(const Args& a, int n, const float* w, const float* x,
                                          float* y, int lane) {
  const int rl = a.rl[n], rr = a.rr[n];
  if (a.quad[n]) {
    // Every float4 a lane reads holds columns 4*(lane % rr4) .. + 3.
    const int sh = a.sh[n], rr4 = 1 << sh, e4 = rl << sh;
    const float4* w4 = reinterpret_cast<const float4*>(w);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = lane; i < e4; i += 32) acc = fma4(x[i >> sh], w4[i], acc);
    for (int d = rr4; d < 32; d <<= 1) {
      const float4 o = shfl_xor4(acc, d);
      acc = make_float4(acc.x + o.x, acc.y + o.y, acc.z + o.z, acc.w + o.w);
    }
    if (lane < rr4) reinterpret_cast<float4*>(y)[lane] = acc;
  } else {
    // Groups of `width` lanes over consecutive columns, 32 / width rows at once.
    const int width = a.width[n], h = 32 / width, qs = lane & (width - 1), s = lane / width;
    for (int q0 = 0; q0 < rr; q0 += width) {
      const int q = q0 + qs;
      float acc = 0.f;
      if (q < rr) {
        for (int p = s; p < rl; p += h) acc = fmaf(x[p], w[p * rr + q], acc);
      }
      for (int d = width; d < 32; d <<= 1) acc += __shfl_xor_sync(kFull, acc, d);
      if (s == 0 && q < rr) y[q] = acc;
    }
  }
}

// One warp: y[p] = sum_q w[p*rr + q] * x[q] for p < rl.
__device__ __forceinline__ void right_step(const Args& a, int n, const float* w, const float* x,
                                           float* y, int lane) {
  const int rl = a.rl[n], rr = a.rr[n];
  if (a.quad[n]) {
    // The rr4 lanes of one matrix row combine their float4 dot products.
    const int sh = a.sh[n], rr4 = 1 << sh, e4 = rl << sh;
    const float4* w4 = reinterpret_cast<const float4*>(w);
    const float4 xv = reinterpret_cast<const float4*>(x)[lane & (rr4 - 1)];
    for (int i0 = 0; i0 < e4; i0 += 32) {
      const int i = i0 + lane;
      float acc = 0.f;
      if (i < e4) {
        const float4 m = w4[i];
        acc = fmaf(m.w, xv.w, fmaf(m.z, xv.z, fmaf(m.y, xv.y, m.x * xv.x)));
      }
      for (int d = 1; d < rr4; d <<= 1) acc += __shfl_xor_sync(kFull, acc, d);
      if (i < e4 && (lane & (rr4 - 1)) == 0) y[i >> sh] = acc;
    }
  } else {
    // Groups of `width` lanes over consecutive elements of one matrix row.
    const int width = a.width[n], g = 32 / width, qs = lane & (width - 1), s = lane / width;
    for (int p0 = 0; p0 < rl; p0 += g) {
      const int p = p0 + s;
      float acc = 0.f;
      if (p < rl) {
        for (int q = qs; q < rr; q += width) acc = fmaf(w[p * rr + q], x[q], acc);
      }
      for (int d = 1; d < width; d <<= 1) acc += __shfl_xor_sync(kFull, acc, d);
      if (qs == 0 && p < rl) y[p] = acc;
    }
  }
}

// Both chains of sorted slot j by one warp, from its rows (row(n), in device
// memory); stages v*left at s_stage[j*stage4] and right at
// s_stage[j*stage4 + rl4].
template <int N_IN, class Row>
__device__ __forceinline__ void chain_slot(const Args& a, int j, Row row, float v, float* s_stage,
                                           float* va, float* vb, int lane) {
  float* st = s_stage + j * a.stage4;
  const float* cur = row(0);
#pragma unroll
  for (int n = 1; n < N_IN; ++n) {
    if (n < a.n_left) {
      float* nxt = cur == va ? vb : va;
      left_step(a, n, row(n), cur, nxt, lane);
      __syncwarp();
      cur = nxt;
    }
  }
  if (a.n_left == 0) {
    if (lane == 0) st[0] = v;
  } else {
    for (int o = lane; o < a.rl_m; o += 32) st[o] = v * cur[o];
  }
  __syncwarp();  // the left vector is read before the right chain reuses va, vb
  cur = row(N_IN - 1);
#pragma unroll
  for (int n = N_IN - 2; n >= 0; --n) {
    if (n >= a.n_left) {
      float* nxt = cur == va ? vb : va;
      right_step(a, n, row(n), cur, nxt, lane);
      __syncwarp();
      cur = nxt;
    }
  }
  if (a.n_left == N_IN) {
    if (lane == 0) st[a.rl4] = 1.0f;
  } else {
    for (int o = lane; o < a.rr_m; o += 32) st[a.rl4 + o] = cur[o];
  }
  __syncwarp();
}

// The register path's matrix step for one slot of a group of kGroup lanes:
// left (x = the first input's row, w = input n's row) or right (x = the
// last input's row).  Stages v*left at st[0..] or right at st[rl4..]; `ok`
// is false for the lanes of a group past the step's last slot, which still
// take part in the shuffles.
template <bool LEFT>
__device__ __forceinline__ void group_step(const Args& a, int n, const float* w, const float* x,
                                           float v, float* st, bool ok, int g) {
  const int sh = a.sh[n], rr4 = 1 << sh, e4 = a.rl[n] << sh;
  const float4* w4 = reinterpret_cast<const float4*>(w);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 m[kGroupK];
#pragma unroll
  for (int k = 0; k < kGroupK; ++k) {
    const int i = g + kGroup * k;
    m[k] = ok && i < e4 ? __ldg(w4 + i) : zero;
  }
  if constexpr (LEFT) {
    // Float4 i of the row holds columns 4*(i % rr4).. of matrix row i / rr4.
    float xs[kGroupK];
#pragma unroll
    for (int k = 0; k < kGroupK; ++k) {
      const int i = g + kGroup * k;
      xs[k] = ok && i < e4 ? __ldg(x + (i >> sh)) : 0.f;
    }
    float4 acc = zero;
#pragma unroll
    for (int k = 0; k < kGroupK; ++k) acc = fma4(xs[k], m[k], acc);
    for (int d = rr4; d < kGroup; d <<= 1) {
      const float4 o = shfl_xor4(acc, d);
      acc = make_float4(acc.x + o.x, acc.y + o.y, acc.z + o.z, acc.w + o.w);
    }
    if (ok && g < rr4) {
      reinterpret_cast<float4*>(st)[g] = make_float4(v * acc.x, v * acc.y, v * acc.z, v * acc.w);
    }
  } else {
    // The rr4 lanes holding one matrix row combine their dot products.
    const float4 xv = ok ? __ldg(reinterpret_cast<const float4*>(x) + (g & (rr4 - 1))) : zero;
#pragma unroll
    for (int k = 0; k < kGroupK; ++k) {
      const int i = g + kGroup * k;
      float d = fmaf(m[k].w, xv.w, fmaf(m[k].z, xv.z, fmaf(m[k].y, xv.y, m[k].x * xv.x)));
      for (int o = 1; o < rr4; o <<= 1) d += __shfl_xor_sync(kFull, d, o);
      if (ok && i < e4 && (g & (rr4 - 1)) == 0) st[a.rl4 + (i >> sh)] = d;
    }
  }
}

// The register path (a.group): group gid of kGroup lanes takes sorted slots
// gid, gid + 32, ...; the loop bounds are the same for the whole CTA, so
// every lane reaches every shuffle.
template <int N_IN>
__device__ __forceinline__ void group_chains(const Args& a, int count, const int64_t (*s_in)[kChunk],
                                             const float* s_val, float* s_stage) {
  constexpr int kGroups = kThreads / kGroup;
  const int g = threadIdx.x & (kGroup - 1);
  const int gid = threadIdx.x / kGroup;
  for (int j0 = 0; j0 < count; j0 += kGroups) {
    const bool ok = j0 + gid < count;
    const int j = ok ? j0 + gid : 0;
    const float v = s_val[j];
    float* st = s_stage + j * a.stage4;
    const float* first = a.factors[0] + s_in[0][j];
    const float* last = a.factors[N_IN - 1] + s_in[N_IN - 1][j];
    if (a.n_left == 0) {
      if (ok && g == 0) st[0] = v;
    } else if (a.n_left == 1) {
      for (int o = g; o < a.rl_m; o += kGroup) {
        if (ok) st[o] = v * __ldg(first + o);
      }
    } else {
      group_step<true>(a, 1, a.factors[1] + s_in[1][j], first, v, st, ok, g);
    }
    const int n_right = N_IN - a.n_left;
    if (n_right == 0) {
      if (ok && g == 0) st[a.rl4] = 1.0f;
    } else if (n_right == 1) {
      for (int o = g; o < a.rr_m; o += kGroup) {
        if (ok) st[a.rl4 + o] = __ldg(last + o);
      }
    } else {
      group_step<false>(a, N_IN - 2, a.factors[N_IN - 2] + s_in[N_IN - 2][j], last, v, st, ok, g);
    }
  }
}

// Row copies (a.copy): each chain is one row, the first input's (times the
// value) and the second's.  A slot's staged items (float4s where a.copy4,
// else floats) go to `lanes` consecutive threads, so kThreads / lanes slots
// are gathered at once, kGather rounds of them in flight per thread.
__device__ __forceinline__ void copy_chains(const Args& a, int count, const int64_t (*s_in)[kChunk],
                                            const float* s_val, float* s_stage) {
  const int per = a.copy4 ? a.copy4 : a.rl_m + a.rr_m;  // items per slot
  const int lanes = per < kThreads ? per : kThreads;
  const int jstep = kThreads / lanes;
  const int j_first = static_cast<int>(threadIdx.x) / lanes;
  if (j_first >= jstep) return;
  const int fl = a.copy4 ? a.rl_m >> 2 : a.rl_m;  // left items
  for (int f = static_cast<int>(threadIdx.x) % lanes; f < per; f += lanes) {
    const bool left = f < fl;
    const int64_t* rows = s_in[left ? 0 : 1];
    const int off = left ? f : f - fl;
    for (int j0 = j_first; j0 < count; j0 += jstep * kGather) {
      float4 x[kGather];
#pragma unroll
      for (int u = 0; u < kGather; ++u) {
        const int j = j0 + u * jstep;
        x[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (j < count) {
          const float* src = a.factors[left ? 0 : 1] + rows[j];
          if (a.copy4) {
            x[u] = __ldg(reinterpret_cast<const float4*>(src) + off);
          } else {
            x[u].x = __ldg(src + off);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kGather; ++u) {
        const int j = j0 + u * jstep;
        if (j < count) {
          float* st = s_stage + j * a.stage4;
          const float v = left ? s_val[j] : 1.0f;
          if (a.copy4) {
            // rl_m is a multiple of 4, so right starts at rl4 = rl_m: float4 f at 4f.
            reinterpret_cast<float4*>(st)[f] = make_float4(v * x[u].x, v * x[u].y, v * x[u].z,
                                                           v * x[u].w);
          } else {
            st[left ? f : a.rl4 + off] = v * x[u].x;
          }
        }
      }
    }
  }
}

// Stage every sorted slot's v*left and right (phase 2 of a step).
template <int N_IN>
__device__ void stage_chains(const Args& a, int count, const int64_t (*s_in)[kChunk],
                             const float* s_val, float* s_stage, float* s_vec) {
  if (a.copy) {
    copy_chains(a, count, s_in, s_val, s_stage);
    return;
  }
  if (a.group) {
    group_chains<N_IN>(a, count, s_in, s_val, s_stage);
    return;
  }
  // Any other chains: warp w takes slots w, w + kWarps, ..., its rows read
  // from L2, its chain vectors passed on through va and vb.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* va = s_vec + warp * 2 * a.maxw4;
  float* vb = va + a.maxw4;
  for (int j = warp; j < count; j += kWarps) {
    chain_slot<N_IN>(a, j, [&](int n) { return a.factors[n] + s_in[n][j]; }, s_val[j], s_stage,
                     va, vb, lane);
  }
}

// Add a run's sums (cw columns from `col` of tile row offset r) to the tile.
template <int CW>
__device__ __forceinline__ void add_run(float* s_tile, int r, int col, const float* acc, bool shared) {
  float* t = s_tile + r + col;
  if (shared) {
#pragma unroll
    for (int k = 0; k < CW; ++k) atomicAdd(t + k, acc[k]);
  } else if constexpr (CW == 4) {
    float4 x = *reinterpret_cast<float4*>(t);
    x = make_float4(x.x + acc[0], x.y + acc[1], x.z + acc[2], x.w + acc[3]);
    *reinterpret_cast<float4*>(t) = x;
  } else {
#pragma unroll
    for (int k = 0; k < CW; ++k) t[k] += acc[k];
  }
}

// The column phase of a step: a thread owns CW consecutive columns of the
// slice and one of the equal segments of the sorted slots, whatever the rows.
// The next slot's entries are read before this slot's run is added, so the
// shared-memory reads of one slot overlap the tile update of the last.
template <int CW>
__device__ __forceinline__ void add_columns_cw(const Args& a, float* __restrict__ s_tile,
                                               const float* __restrict__ s_stage,
                                               const int* __restrict__ s_row, int count) {
  const int per_row = a.slice / CW;  // threads across one slot's columns
  const int groups = kThreads / per_row;
  const int group = threadIdx.x / per_row;
  const int col = (threadIdx.x - group * per_row) * CW;
  const int c = static_cast<int>(blockIdx.x % a.col_slices) * a.slice + col;
  if (c >= a.ncols) return;
  // The staged entries these columns multiply: left[c / rr_m], right[c % rr_m ..].
  const int q_left = c / a.rr_m;
  const int q_right = a.rl4 + c % a.rr_m;
  const int lo = group * count / groups;
  const int hi = (group + 1) * count / groups;
  if (lo >= hi) return;
  // A run shares its row with a neighbouring segment only at the ends.
  const bool first_shared = lo > 0 && s_row[lo - 1] == s_row[lo];
  const bool last_shared = hi < count && s_row[hi] == s_row[hi - 1];
  auto entries = [&](int j, float* r) {
    const float* f = s_stage + j * a.stage4;
    const float l = f[q_left];
    if constexpr (CW == 4) {
      const float4 rv = *reinterpret_cast<const float4*>(f + q_right);
      r[0] = l * rv.x;
      r[1] = l * rv.y;
      r[2] = l * rv.z;
      r[3] = l * rv.w;
    } else {
      r[0] = l * f[q_right];
    }
  };
  int cur = s_row[lo];
  float next[CW];
  entries(lo, next);
  bool first_run = true;
  float acc[CW] = {};
  for (int j = lo; j < hi; ++j) {
    float p[CW];
#pragma unroll
    for (int k = 0; k < CW; ++k) p[k] = next[k];
    const int r = j + 1 < hi ? s_row[j + 1] : -1;
    if (j + 1 < hi) entries(j + 1, next);
#pragma unroll
    for (int k = 0; k < CW; ++k) acc[k] += p[k];
    if (r != cur) {
      add_run<CW>(s_tile, cur, col, acc, (first_run && first_shared) || (r < 0 && last_shared));
      first_run = false;
      cur = r;
#pragma unroll
      for (int k = 0; k < CW; ++k) acc[k] = 0.f;
    }
  }
}

__device__ __forceinline__ void add_columns(const Args& a, float* s_tile, const float* s_stage,
                                            const int* s_row, int count) {
  if (a.quad_cols) {
    add_columns_cw<4>(a, s_tile, s_stage, s_row, count);
  } else {
    add_columns_cw<1>(a, s_tile, s_stage, s_row, count);
  }
}

// Add the tile's non-zero partial sums to output rows row0.. (at most
// `rows_here` of them), columns c0.., and zero the tile.  Each thread reads
// and clears only its own elements; columns past ncols are never added to,
// so they stay 0 and are skipped.
__device__ __forceinline__ void flush_part(const Args& a, float* s_tile, int64_t row0, int rows_here,
                                           int c0) {
  const int elems = rows_here * a.slice;
  float* dst = a.out + row0 * a.ldo + c0;
  for (int i = threadIdx.x; i < elems; i += kThreads) {
    const float x = s_tile[i];
    s_tile[i] = 0.0f;
    if (x != 0.0f) {
      const int r = i / a.slice;
      atomicAdd(dst + static_cast<int64_t>(r) * a.ldo + (i - r * a.slice), x);
    }
  }
}

template <int N_IN>
__global__ void __launch_bounds__(kThreads, kMinCtasPerSm) ttcore_blocked_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_tile = reinterpret_cast<float*>(smem);          // rows x slice partial sums
  float* s_stage = s_tile + a.rows * a.slice;              // chunk x stage4: v*left, right
  float* s_vec = s_stage + a.chunk * a.stage4;             // kWarps x 2 x maxw4 chain vectors
  int* s_start = reinterpret_cast<int*>(s_vec + kWarps * 2 * a.maxw4);  // rows row counts, then starts
  // The step's non-zero slots of this CTA's rows, in row order: interface
  // row offsets (row * ld), value, tile row offset (row * slice).
  __shared__ int64_t s_in[N_IN][kChunk];
  __shared__ float s_val[kChunk];
  __shared__ int s_row[kChunk];
  __shared__ int s_warp[kWarps];

  // CTA b takes (row part, column slice) b % slices of block range
  // b / slices: those of one range run side by side, so the stream and the
  // rows they read are in L2 for all but the first.
  const int64_t range = blockIdx.x / a.slices;
  const int64_t ranges = gridDim.x / a.slices;
  const int sub = static_cast<int>(blockIdx.x % a.slices);
  const int row0 = (sub / a.col_slices) * a.rows;  // first tile row of this CTA
  const int rows_here = a.tile_i - row0 < a.rows ? a.tile_i - row0 : a.rows;
  const int c0 = (sub % a.col_slices) * a.slice;

  for (int i = threadIdx.x; i < a.rows * a.slice; i += kThreads) s_tile[i] = 0.0f;
  for (int i = threadIdx.x; i < a.rows; i += kThreads) s_start[i] = 0;
  __syncthreads();

  const int64_t per = (a.nblocks + ranges - 1) / ranges;
  const int64_t b_begin = range * per;
  const int64_t b_end = b_begin + per < a.nblocks ? b_begin + per : a.nblocks;
  // The fields of this thread's slot in step (b, c_step), read one step
  // ahead, so the reads overlap the previous step's chains and columns:
  // value, tile row, and each input's block tile and row in that tile.
  // Threads past `chunk` (and past the block) take no slot: value 0.
  float f_val = 0.0f;
  int f_loc = 0, f_tile = 0;
  int f_blk_in[N_IN] = {}, f_in_loc[N_IN] = {};
  auto read_fields = [&](int64_t b, int c_step) {
    const int z = c_step + static_cast<int>(threadIdx.x);
    const int64_t slot = b * a.blk + z;
    const bool mine = static_cast<int>(threadIdx.x) < a.chunk && z < a.blk;
    f_tile = a.block_it[b];
    f_val = mine ? a.vals[slot] : 0.0f;
    f_loc = mine ? a.iloc[slot] : 0;
#pragma unroll
    for (int n = 0; n < N_IN; ++n) {
      f_blk_in[n] = a.block_in[n][b];
      f_in_loc[n] = mine ? a.in_locs[n][slot] : 0;
    }
  };
  int cur_tile = -1;
  int64_t b = b_begin;
  int c_step = 0;
  if (b < b_end) read_fields(b, c_step);
  while (b < b_end) {
    if (f_tile != cur_tile) {
      // Every thread passed the previous step's closing barrier, so the
      // tile holds all of the previous run's contributions.
      if (cur_tile >= 0) {
        flush_part(a, s_tile, static_cast<int64_t>(cur_tile) * a.tile_i + row0, rows_here, c0);
      }
      cur_tile = f_tile;
    }
    // Count this thread's slot in its row if the row is this CTA's; `pos`
    // is its place there.
    float v = f_val;
    const int row = f_loc - row0;
    if (row < 0 || row >= rows_here) v = 0.0f;
    const int pos = v != 0.0f ? atomicAdd(&s_start[row], 1) : -1;
    __syncthreads();  // row counts complete
    const int count = exclusive_scan(s_start, a.rows, s_warp);
    if (pos >= 0) {
      const int j = s_start[row] + pos;
      s_val[j] = v;
      s_row[j] = row * a.slice;
#pragma unroll
      for (int n = 0; n < N_IN; ++n) {
        s_in[n][j] = (static_cast<int64_t>(f_blk_in[n]) * a.in_tiles[n] + f_in_loc[n]) * a.ld[n];
      }
    }
    __syncthreads();  // sorted slots complete; row starts read

    for (int i = threadIdx.x; i < a.rows; i += kThreads) s_start[i] = 0;
    c_step += a.chunk;
    if (c_step >= a.blk) {
      c_step = 0;
      ++b;
    }
    if (b < b_end) read_fields(b, c_step);
    stage_chains<N_IN>(a, count, s_in, s_val, s_stage, s_vec);
    __syncthreads();  // staged vectors complete
    add_columns(a, s_tile, s_stage, s_row, count);
    __syncthreads();  // the step's sums are in the tile; staging is free
  }
  if (cur_tile >= 0) {
    flush_part(a, s_tile, static_cast<int64_t>(cur_tile) * a.tile_i + row0, rows_here, c0);
  }
}

size_t dynamic_smem(const Args& a) {
  return (static_cast<size_t>(a.rows) * a.slice + static_cast<size_t>(a.chunk) * a.stage4 +
          static_cast<size_t>(kWarps) * 2 * a.maxw4) * sizeof(float) +
         static_cast<size_t>(a.rows) * sizeof(int);
}

// Shape the tile and the step from the shared-memory budget, and launch.
// The slice holds every output column where it can (at most kThreads
// threads of CW columns each across a slot); where a tile_i x slice tile
// would pass kTileBytes, the tile is split into row parts instead, so each
// slot's chains are computed once, by the CTA of its row.  The step takes as
// many slots as fit, at most kChunk; the parts double further only when not
// one slot fits.  Returns 0, -1 when not even one slot fits beside a
// 1-row tile, else a cudaError_t.
template <int N_IN>
int launch(Args a, int device, cudaStream_t stream) {
  auto kernel = ttcore_blocked_kernel<N_IN>;
  size_t budget = 0;
  const int err = dynamic_budget(kernel, device, &budget);
  if (err != 0) return err;
  const int max_slice = a.quad_cols ? 4 * kThreads : kThreads;
  a.slice = kMinSlice;
  while (a.slice < a.ncols && a.slice < max_slice) a.slice *= 2;
  a.col_slices = (a.ncols + a.slice - 1) / a.slice;
  auto shape = [&](int parts) {
    a.parts = parts;
    a.rows = (a.tile_i + parts - 1) / parts;
    a.chunk = 0;
    return dynamic_smem(a);
  };
  int parts = 1;
  while (parts < a.tile_i &&
         static_cast<size_t>((a.tile_i + parts - 1) / parts) * a.slice * sizeof(float) > kTileBytes) {
    parts *= 2;
  }
  const size_t slot = static_cast<size_t>(a.stage4) * sizeof(float);
  while (parts < a.tile_i && shape(parts) + slot > budget) parts *= 2;
  const size_t used = shape(parts);
  if (used + slot > budget) return -1;
  const size_t fit = (budget - used) / slot;
  a.chunk = fit < static_cast<size_t>(kChunk) ? static_cast<int>(fit) : kChunk;
  a.slices = a.parts * a.col_slices;
  return launch_ranges(kernel, a, dynamic_smem(a), device, stream);
}

inline int round4(long long x) { return static_cast<int>((x + 3) / 4 * 4); }

}  // namespace

// Launch on `stream`.  The pointer arrays hold n_in device pointers each,
// and in_tiles / ld / rl / rr n_in ints, in plan.in_modes order; the pairs
// must chain (the wrapper checks it; the launch checks the chain ends).
// Returns 0 on success, -1 when not even one staged slot fits beside a
// tile_i x kMinSlice tile in a CTA's shared memory, else a cudaError_t.
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
  if ((n_left > 0 && rl[0] != 1) || (n_left < n_in && rr[n_in - 1] != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
  int maxw = 1;
  bool vec = true;  // every matrix 16-byte aligned with rows of a multiple of 4 floats
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
    const int rr4 = rr[n] / 4;
    a.quad[n] = rr[n] % 4 == 0 && rr4 <= 32 && 32 % rr4 == 0;
    a.sh[n] = 0;
    while (a.quad[n] && (1 << a.sh[n]) < rr4) ++a.sh[n];
    a.width[n] = 1;
    while (a.width[n] < 32 && a.width[n] < rr[n]) a.width[n] *= 2;
    if (ld[n] % 4 != 0 || reinterpret_cast<uintptr_t>(factors[n]) % 16 != 0) vec = false;
    if (rl[n] > maxw) maxw = rl[n];
    if (rr[n] > maxw) maxw = rr[n];
  }
  // Float4 steps read rows from device memory: only where they are aligned.
  for (int n = 0; n < n_in && !vec; ++n) a.quad[n] = 0;
  const int rl_m = n_left > 0 ? rr[n_left - 1] : 1;
  const int rr_m = n_left < n_in ? rl[n_left] : 1;
  const long long ncols = static_cast<long long>(rl_m) * rr_m;
  if (ncols > ldo) return static_cast<int>(cudaErrorInvalidValue);
  if (nblocks == 0) return 0;
  a.vals = vals;
  a.iloc = iloc;
  a.block_it = block_it;
  a.n_left = n_left;
  a.rl_m = rl_m;
  a.rr_m = rr_m;
  a.rl4 = round4(rl_m);
  a.stage4 = a.rl4 + round4(rr_m);
  a.copy = n_in == 2 && n_left == 1;
  a.copy4 = a.copy && vec && rl_m % 4 == 0 && rr_m % 4 == 0 ? (rl_m + rr_m) / 4 : 0;
  // The register path: each chain one row and at most one matrix step whose
  // row a group holds in kGroupK float4s per lane, rr4 dividing kGroup.
  auto group_step_ok = [&](int n) {
    return a.quad[n] && (1 << a.sh[n]) <= kGroup &&
           static_cast<long long>(rl[n]) * (rr[n] / 4) <= static_cast<long long>(kGroup) * kGroupK;
  };
  a.group = !a.copy && vec && n_left <= 2 && n_in - n_left <= 2 &&
            (n_left < 2 || group_step_ok(1)) && (n_in - n_left < 2 || group_step_ok(n_in - 2));
  a.maxw4 = a.copy || a.group ? 0 : round4(maxw);
  a.quad_cols = rr_m % 4 == 0;
  a.out = out;
  a.nblocks = nblocks;
  a.blk = blk;
  a.tile_i = tile_i;
  a.ldo = ldo;
  a.ncols = static_cast<int>(ncols);

  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_in) {
    case 2: return launch<2>(a, device, s);
    case 3: return launch<3>(a, device, s);
    default: return launch<4>(a, device, s);
  }
}
