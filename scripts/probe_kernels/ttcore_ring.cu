// A TT-core kernel design that was measured and not kept: the chains stage
// every input row of a slot into a per-warp ring of shared-memory buffers
// with cp.async, `ring - 1` slots ahead, one warp per slot.  It computes the
// same function with the same launch interface as
// src/repro_torch/kernels/csrc/ttcore.cu (whose note says what the function
// is), and is kept only as an input of scripts/torch_ttcore_probe.py:
//
//     python3 scripts/torch_ttcore_probe.py --source ring=scripts/probe_kernels/ttcore_ring.cu
//
// which times it whole, in phases, and in copies without the ring's copies,
// without its arithmetic, with 2 buffers per warp, with 128-slot steps, and
// with rows read from L2 instead (PERF.md, Findings).  It builds against the
// checkout's csrc/blocked.cuh, which the probe copies beside it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "blocked.cuh"

namespace {

constexpr int kMaxIn = 4;
constexpr int kGather = 8;     // row-copy loads in flight per thread
constexpr int kMinStep = 64;   // fewest slots per step that keep a staging ring
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* vals;
  const int* iloc;
  const int* block_it;
  const int* in_locs[kMaxIn];
  const int* block_in[kMaxIn];
  const float* factors[kMaxIn];
  int in_tiles[kMaxIn];
  int ld[kMaxIn];
  int rl[kMaxIn];
  int rr[kMaxIn];
  int quad[kMaxIn];
  int sh[kMaxIn];
  int width[kMaxIn];
  int off[kMaxIn];    // first float of input n's row in a ring buffer
  int n_left;
  int rl_m;
  int rr_m;
  int rl4;
  int stage4;
  int copy;
  int vec;
  int ring;           // ring buffers per warp (4 or 2), 0: rows read from L2
  int ring_f;         // floats of a ring buffer: every input's row, each rounded up to 4
  int maxw4;
  int quad_cols;
  float* out;
  int64_t nblocks;
  int blk;
  int tile_i;
  int ldo;
  int ncols;
  int slice;
  int slices;
  int chunk;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float4 fma4(float s, float4 m, float4 acc) {
  return make_float4(fmaf(s, m.x, acc.x), fmaf(s, m.y, acc.y), fmaf(s, m.z, acc.z),
                     fmaf(s, m.w, acc.w));
}

__device__ __forceinline__ float4 shfl_xor4(float4 v, int d) {
  return make_float4(__shfl_xor_sync(kFull, v.x, d), __shfl_xor_sync(kFull, v.y, d),
                     __shfl_xor_sync(kFull, v.z, d), __shfl_xor_sync(kFull, v.w, d));
}

__device__ __forceinline__ void left_step(const Args& a, int n, const float* w, const float* x,
                                          float* y, int lane) {
  const int rl = a.rl[n], rr = a.rr[n];
  if (a.quad[n]) {
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

__device__ __forceinline__ void right_step(const Args& a, int n, const float* w, const float* x,
                                           float* y, int lane) {
  const int rl = a.rl[n], rr = a.rr[n];
  if (a.quad[n]) {
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
  __syncwarp();
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

template <int N_IN>
__device__ void stage_chains(const Args& a, int count, const int64_t (*s_in)[kChunk],
                             const float* s_val, float* s_stage, float* s_ring, float* s_vec) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (a.copy) {
    for (int l = lane; l < a.rl_m + a.rr_m; l += 32) {
      const bool left = l < a.rl_m;
      const float* src = left ? a.factors[0] + l : a.factors[1] + (l - a.rl_m);
      const int64_t* rows = s_in[left ? 0 : 1];
      const int dst = left ? l : a.rl4 + l - a.rl_m;
      for (int j0 = warp; j0 < count; j0 += kWarps * kGather) {
        float x[kGather];
#pragma unroll
        for (int u = 0; u < kGather; ++u) {
          const int j = j0 + u * kWarps;
          x[u] = j < count ? __ldg(src + rows[j]) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kGather; ++u) {
          const int j = j0 + u * kWarps;
          if (j < count) s_stage[j * a.stage4 + dst] = left ? s_val[j] * x[u] : x[u];
        }
      }
    }
    return;
  }
  float* va = s_vec + warp * 2 * a.maxw4;
  float* vb = va + a.maxw4;
  const int mine = count > warp ? (count - warp + kWarps - 1) / kWarps : 0;
  if (a.ring == 0) {
    for (int t = 0; t < mine; ++t) {
      const int j = warp + t * kWarps;
      chain_slot<N_IN>(a, j, [&](int n) { return a.factors[n] + s_in[n][j]; }, s_val[j], s_stage,
                       va, vb, lane);
    }
    return;
  }
  float* ring = s_ring + warp * a.ring * a.ring_f;
  auto issue = [&](int t) {
    const int j = warp + t * kWarps;
    float* buf = ring + (t % a.ring) * a.ring_f;
#pragma unroll
    for (int n = 0; n < N_IN; ++n) {
      const float* src = a.factors[n] + s_in[n][j];
      float* dst = buf + a.off[n];
      const int e = a.rl[n] * a.rr[n];
      if (a.vec) {
        for (int i = 4 * lane; i < e; i += 128) cp_async16(dst + i, src + i);
      } else {
        for (int i = lane; i < e; i += 32) cp_async4(dst + i, src + i);
      }
    }
  };
  for (int t = 0; t < a.ring - 1; ++t) {
    if (t < mine) issue(t);
    cp_async_commit();
  }
  for (int t = 0; t < mine; ++t) {
    if (t + a.ring - 1 < mine) issue(t + a.ring - 1);
    cp_async_commit();
    if (a.ring == 4) {
      cp_async_wait<3>();
    } else {
      cp_async_wait<1>();
    }
    __syncwarp();
    const int j = warp + t * kWarps;
    const float* buf = ring + (t % a.ring) * a.ring_f;
    chain_slot<N_IN>(a, j, [&](int n) { return buf + a.off[n]; }, s_val[j], s_stage, va, vb, lane);
  }
  cp_async_wait<0>();
}

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

template <int CW>
__device__ __forceinline__ void add_columns_cw(const Args& a, float* s_tile, const float* s_stage,
                                               const int* s_row, int count) {
  const int per_row = a.slice / CW;
  const int groups = kThreads / per_row;
  const int group = threadIdx.x / per_row;
  const int col = (threadIdx.x - group * per_row) * CW;
  const int c = static_cast<int>(blockIdx.x % a.slices) * a.slice + col;
  if (c >= a.ncols) return;
  const int q_left = c / a.rr_m;
  const int q_right = a.rl4 + c % a.rr_m;
  const int lo = group * count / groups;
  const int hi = (group + 1) * count / groups;
  if (lo >= hi) return;
  const bool first_shared = lo > 0 && s_row[lo - 1] == s_row[lo];
  const bool last_shared = hi < count && s_row[hi] == s_row[hi - 1];
  int cur = s_row[lo];
  bool first_run = true;
  float acc[CW] = {};
  for (int j = lo; j < hi; ++j) {
    const int r = s_row[j];
    if (r != cur) {
      add_run<CW>(s_tile, cur, col, acc, first_run && first_shared);
      first_run = false;
      cur = r;
#pragma unroll
      for (int k = 0; k < CW; ++k) acc[k] = 0.f;
    }
    const float* f = s_stage + j * a.stage4;
    const float l = f[q_left];
    if constexpr (CW == 4) {
      const float4 rv = *reinterpret_cast<const float4*>(f + q_right);
      acc[0] = fmaf(l, rv.x, acc[0]);
      acc[1] = fmaf(l, rv.y, acc[1]);
      acc[2] = fmaf(l, rv.z, acc[2]);
      acc[3] = fmaf(l, rv.w, acc[3]);
    } else {
      acc[0] = fmaf(l, f[q_right], acc[0]);
    }
  }
  add_run<CW>(s_tile, cur, col, acc, (first_run && first_shared) || last_shared);
}

__device__ __forceinline__ void add_columns(const Args& a, float* s_tile, const float* s_stage,
                                            const int* s_row, int count) {
  if (a.quad_cols) {
    add_columns_cw<4>(a, s_tile, s_stage, s_row, count);
  } else {
    add_columns_cw<1>(a, s_tile, s_stage, s_row, count);
  }
}

template <int N_IN>
__global__ void __launch_bounds__(kThreads) ttcore_blocked_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_tile = reinterpret_cast<float*>(smem);
  float* s_stage = s_tile + a.tile_i * a.slice;
  float* s_ring = s_stage + a.chunk * a.stage4;
  float* s_vec = s_ring + kWarps * a.ring * a.ring_f;
  int* s_start = reinterpret_cast<int*>(s_vec + kWarps * 2 * a.maxw4);
  __shared__ int64_t s_in[N_IN][kChunk];
  __shared__ float s_val[kChunk];
  __shared__ int s_row[kChunk];
  __shared__ int s_warp[kWarps];

  const int64_t range = blockIdx.x / a.slices;
  const int64_t ranges = gridDim.x / a.slices;

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
      if (cur_tile >= 0) flush_tile(a, s_tile, cur_tile);
      cur_tile = tile;
    }
    for (int c0 = 0; c0 < a.blk; c0 += a.chunk) {
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
      __syncthreads();
      const int count = exclusive_scan(s_start, a.tile_i, s_warp);
      if (pos >= 0) {
        const int j = s_start[row] + pos;
        s_val[j] = v;
        s_row[j] = row * a.slice;
#pragma unroll
        for (int n = 0; n < N_IN; ++n) s_in[n][j] = in_row[n];
      }
      __syncthreads();

      for (int i = threadIdx.x; i < a.tile_i; i += kThreads) s_start[i] = 0;
      stage_chains<N_IN>(a, count, s_in, s_val, s_stage, s_ring, s_vec);
      __syncthreads();  // staged vectors complete
      add_columns(a, s_tile, s_stage, s_row, count);
      __syncthreads();  // the step's sums are in the tile; staging is free
    }
  }
  if (cur_tile >= 0) flush_tile(a, s_tile, cur_tile);
}

size_t dynamic_smem(const Args& a) {
  return (static_cast<size_t>(a.tile_i) * a.slice + static_cast<size_t>(a.chunk) * a.stage4 +
          static_cast<size_t>(kWarps) * a.ring * a.ring_f +
          static_cast<size_t>(kWarps) * 2 * a.maxw4) * sizeof(float) +
         static_cast<size_t>(a.tile_i) * sizeof(int);
}

template <int N_IN>
int launch(Args a, int device, cudaStream_t stream) {
  auto kernel = ttcore_blocked_kernel<N_IN>;
  size_t budget = 0;
  const int err = dynamic_budget(kernel, device, &budget);
  if (err != 0) return err;
  const size_t slot = static_cast<size_t>(a.stage4) * sizeof(float);
  auto fixed = [&]() { a.chunk = 0; return dynamic_smem(a); };
  a.ring = 0;
  if (!a.copy) {
    for (int depth = 4; depth >= 2; depth /= 2) {
      a.ring = depth;
      if (fixed() + kMinStep * slot <= budget) break;
      a.ring = 0;
    }
  }
  while (a.slice > kMinSlice && fixed() + slot > budget) a.slice /= 2;
  const size_t used = fixed();
  if (used + slot > budget) return -1;
  const size_t fit = (budget - used) / slot;
  a.chunk = fit < static_cast<size_t>(kChunk) ? static_cast<int>(fit) : kChunk;
  a.slices = (a.ncols + a.slice - 1) / a.slice;
  if (a.ring == 0 && !a.vec) {
    for (int n = 0; n < N_IN; ++n) a.quad[n] = 0;
  }
  return launch_ranges(kernel, a, dynamic_smem(a), device, stream);
}

inline int round4(long long x) { return static_cast<int>((x + 3) / 4 * 4); }

}  // namespace

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
  long long ring_f = 0;
  a.vec = 1;
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
    a.off[n] = static_cast<int>(ring_f);
    ring_f += round4(static_cast<long long>(rl[n]) * rr[n]);
    if (ring_f > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
    if (ld[n] % 4 != 0 || reinterpret_cast<uintptr_t>(factors[n]) % 16 != 0) a.vec = 0;
    if (rl[n] > maxw) maxw = rl[n];
    if (rr[n] > maxw) maxw = rr[n];
  }
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
  a.ring_f = static_cast<int>(ring_f);
  a.maxw4 = a.copy ? 0 : round4(maxw);
  a.quad_cols = rr_m % 4 == 0;
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
