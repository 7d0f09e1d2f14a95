// One pass over a row of (N, V) logits for the vocab-streaming kernels
// (grpo_logprob, fused_rl_loss_fwd): the online log-sum-exp state (m, l),
// the entropy sum t = sum_j exp(x_j - m) * x_j and the target's logit g.
//
// The Pallas kernels carry (m, l, t) across vocab blocks in grid order.
// Here a row is cut into nsplit contiguous chunks (1, 2, 4 or 8), one block
// each, and the row's blocks run as one thread block cluster. A trainer
// micro-batch has few rows (316 of 65,024 to 256,000 logits), too few to
// fill 132 SMs with one block a row; the split gives each SM several
// blocks. Each block streams its chunk through a shared-memory ring of
// STAGES tiles of 8 KB, each thread copying its own 16-byte vectors with
// cp.async, so 16 KB a block, and 32 KB or more an SM, is in flight while
// it works on a tile. (Two stages timed faster than three or four at the
// trainer shapes, and one cp.async.bulk a tile on an mbarrier no faster:
// scripts/vocab_pass_variants.py.)
//
// Each thread keeps its own state over its vectors and rescales once per
// vector that raises its max, so the pass costs about one exp per element.
// The block whose chunk holds the target reads g from the tile it already
// has. The threads' states merge in the block (warp shuffles, shared
// memory), then the blocks' (m, l, t, g) in rank 0 of the cluster through
// distributed shared memory, with weights exp(m_i - M): one launch, no
// scratch in device memory. A row that does not start on 16 bytes (V=259
// in bf16 gives rows at 518-byte offsets) peels a scalar head up to the
// next boundary in its first block, and the ragged tail is scalar in its
// last, so any V works with no padding and no fallback.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {

namespace cg = cooperative_groups;

constexpr int ROW_THREADS = 256;
constexpr int ROW_WARPS = ROW_THREADS / 32;
constexpr int STAGES = 2;                        // tiles in the ring
constexpr int TILE_VECS = 2 * ROW_THREADS;       // 16-byte vectors a tile
constexpr int MAX_SPLITS = 8;                    // the portable cluster size
// nsplit: the fewest splits that give the card SPLIT_BLOCKS blocks an SM,
// as long as each block keeps at least MIN_SPLIT_BYTES of the row
constexpr int SPLIT_BLOCKS = 4;
constexpr long long MIN_SPLIT_BYTES = 32 * 1024;

__device__ __forceinline__ float to_float_scalar(float x) { return x; }
__device__ __forceinline__ float to_float_scalar(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct RowState {
  float m, l, t;
};

__device__ __forceinline__ RowState merge(RowState a, RowState b) {
  float M = fmaxf(a.m, b.m);
  float wa = __expf(a.m - M), wb = __expf(b.m - M);
  return {M, a.l * wa + b.l * wb, a.t * wa + b.t * wb};
}

// Add n values to a thread's state: one rescale if they raise the max, then
// one exp per value.
template <int N>
__device__ __forceinline__ void accumulate(RowState& s, const float* x) {
  float cmax = x[0];
#pragma unroll
  for (int i = 1; i < N; ++i) cmax = fmaxf(cmax, x[i]);
  if (cmax > s.m) {
    float a = __expf(s.m - cmax);
    s.l *= a;
    s.t *= a;
    s.m = cmax;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float e = __expf(x[i] - s.m);
    s.l += e;
    s.t += e * x[i];
  }
}

// Elements before the first 16-byte boundary at or after ``p`` (at most
// ``n``), for a pointer to T that is at least T-aligned.
template <typename T>
__device__ __forceinline__ int head_elems(const T* p, int n) {
  int mis = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15) /
            static_cast<int>(sizeof(T));
  int head = mis ? Vec<T>::N - mis : 0;
  return head < n ? head : n;
}

// The row's (m, l, t) and target logit g, as rank 0's first warp holds them.
struct RowPart {
  RowState s;
  float g;
};

// The warp's parts merged, in every lane; only the lane that saw the
// target holds a nonzero g, so the sum is that g exactly.
__device__ __forceinline__ RowPart warp_merge(RowPart p) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    RowState o = {__shfl_xor_sync(0xffffffffu, p.s.m, off),
                  __shfl_xor_sync(0xffffffffu, p.s.l, off),
                  __shfl_xor_sync(0xffffffffu, p.s.t, off)};
    p.s = merge(p.s, o);
    p.g += __shfl_xor_sync(0xffffffffu, p.g, off);
  }
  return p;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Block `split` of `nsplit` streams its chunk of ``row`` (V logits, target
// column ``tgt``). Returns true in the first warp of the row's rank-0 block,
// whose lanes then all hold the row's merged state; false elsewhere.
template <typename T>
__device__ bool vocab_pass(const T* __restrict__ row, int V, int64_t tgt,
                           int split, int nsplit, RowPart& out) {
  constexpr int N = Vec<T>::N;
  __shared__ __align__(128) uint4 ring[STAGES * TILE_VECS];
  __shared__ RowPart warp_part[ROW_WARPS];
  __shared__ float4 split_part[MAX_SPLITS];   // rank 0 gathers the splits
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (nsplit > 1) cluster_arrive_relaxed();   // every block has started

  const int head = head_elems(row, V);
  const int nvec = (V - head) / N;
  const T* body = row + head;
  const int per = (nvec + nsplit - 1) / nsplit;
  const int v0 = min(nvec, split * per), v1 = min(nvec, v0 + per);
  const int ntiles = (v1 - v0 + TILE_VECS - 1) / TILE_VECS;
  const uint32_t ring_addr = hopper::smem_addr(ring);

  auto issue = [&](int i) {            // each thread copies its own vectors
    if (i < ntiles) {
      const int st = i % STAGES;
#pragma unroll
      for (int k = 0; k < TILE_VECS / ROW_THREADS; ++k) {
        const int j = k * ROW_THREADS + tid, v = v0 + i * TILE_VECS + j;
        const bool on = v < v1;
        hopper::cp_async16(ring_addr + (st * TILE_VECS + j) * 16,
                           body + (size_t)(on ? v : v0) * N, on ? 16 : 0);
      }
    }
    hopper::cp_async_commit();         // empty groups keep the count
  };
#pragma unroll
  for (int i = 0; i < STAGES; ++i) issue(i);

  RowPart p = {{NEG_INF, 0.f, 0.f}, 0.f};
  // the scalar head (first block) and tail (last block), off the 16-byte
  // grid, while the ring fills
  if (split == 0 && tid < head) {
    float x = to_float_scalar(row[tid]);
    accumulate<1>(p.s, &x);
    if (tid == tgt) p.g = x;
  }
  const int tail0 = head + nvec * N;
  if (split == nsplit - 1 && tail0 + tid < V) {
    float x = to_float_scalar(row[tail0 + tid]);
    accumulate<1>(p.s, &x);
    if (tail0 + tid == tgt) p.g = x;
  }

  for (int i = 0; i < ntiles; ++i) {
    const int st = i % STAGES;
    hopper::cp_async_wait<STAGES - 1>();   // tile i has landed
#pragma unroll
    for (int k = 0; k < TILE_VECS / ROW_THREADS; ++k) {
      const int j = k * ROW_THREADS + tid, v = v0 + i * TILE_VECS + j;
      if (v < v1) {
        const uint4* slot = ring + st * TILE_VECS + j;
        float x[N];
        to_float<T>(*slot, x);
        accumulate<N>(p.s, x);
        const int64_t d = tgt - (head + static_cast<int64_t>(v) * N);
        if (d >= 0 && d < N)
          p.g = to_float_scalar(reinterpret_cast<const T*>(slot)[d]);
      }
    }
    issue(i + STAGES);                 // into the stage this thread just read
  }

  // merge: within each warp, then across the block's warps in warp 0
  p = warp_merge(p);
  if (lane == 0) warp_part[warp] = p;
  __syncthreads();
  if (warp != 0 && nsplit == 1) return false;
  if (warp == 0) {
    p = lane < ROW_WARPS ? warp_part[lane]
                         : RowPart{{NEG_INF, 0.f, 0.f}, 0.f};
    p = warp_merge(p);
  }
  if (nsplit == 1) {
    out = p;
    return true;
  }
  // then across the cluster: every block's state into rank 0's shared
  // memory, one barrier, rank 0's first warp merges
  cluster_wait();
  if (tid == 0)
    *cg::this_cluster().map_shared_rank(&split_part[split], 0) =
        make_float4(p.s.m, p.s.l, p.s.t, p.g);
  cg::this_cluster().sync();
  if (split != 0 || warp != 0) return false;
  const float4 q = lane < nsplit ? split_part[lane]
                                 : make_float4(NEG_INF, 0.f, 0.f, 0.f);
  out = warp_merge(RowPart{{q.x, q.y, q.z}, q.w});
  return true;
}

// The splits a row takes at N rows of V logits of `esize` bytes on a card
// of `sms` SMs (kernels/grpo_logprob/ops.py:nsplit_for mirrors it).
inline int choose_nsplit(int N, int V, int esize, int sms) {
  const long long row_bytes = static_cast<long long>(V) * esize;
  int s = 1;
  while (s < MAX_SPLITS &&
         static_cast<long long>(N) * s < static_cast<long long>(SPLIT_BLOCKS) *
                                              sms &&
         row_bytes / (2 * s) >= MIN_SPLIT_BYTES)
    s *= 2;
  return s;
}

// SMs of the current device (0 if the runtime cannot say: one block a row)
inline int num_sms() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// The launch of `kernel` over N rows of `nsplit` blocks each (0: the
// entry's own choice), one cluster a row; returns its CUDA error.
template <typename Kernel, typename... Args>
int launch_rows(Kernel kernel, int N, int V, int esize, int nsplit,
                cudaStream_t st, Args... args) {
  if (nsplit == 0) nsplit = choose_nsplit(N, V, esize, num_sms());
  if (nsplit == 1) {          // no cluster: the cheaper launch
    kernel<<<N, ROW_THREADS, 0, st>>>(args..., 1);
    return static_cast<int>(cudaGetLastError());
  }
  if (nsplit != 2 && nsplit != 4 && nsplit != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(N) * nsplit);
  cfg.blockDim = dim3(ROW_THREADS);
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = nsplit;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, args..., nsplit));
}

// Clusters of `nsplit` blocks of `kernel` the card holds at once (the
// build report's occupancy line), or minus a CUDA error.
template <typename Kernel>
int max_clusters(Kernel kernel, int nsplit) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit * 1024);
  cfg.blockDim = dim3(ROW_THREADS);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = nsplit;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

}  // namespace repro_torch
