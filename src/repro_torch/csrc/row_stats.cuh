// One pass over a row of (N, V) logits for the vocab-streaming kernels
// (grpo_logprob, fused_rl_loss): the online log-sum-exp state (m, l) and the
// entropy sum t = sum_j exp(x_j - m) * x_j, reduced over one CTA per row.
//
// The Pallas kernels carry (m, l, t) across vocab blocks in grid order. Here
// each thread keeps its own state over a strided share of the row and the
// CTA merges them (warp shuffles, then shared memory) with weights
// exp(m_i - M). Each thread rescales once per 16-byte vector when that
// vector raises its max, so the pass costs about one exp per element. Loads
// are 16-byte vectors wherever the row allows; a row that does not start on
// 16 bytes (V=259 in bf16 gives rows at 518-byte offsets) peels a scalar
// head up to the next boundary, and the ragged tail is scalar too, so any V
// works with no padding and no fallback.
#pragma once

#include "common.cuh"

namespace repro_torch {

constexpr int ROW_THREADS = 256;

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

// The CTA's merged state over row[0, V); every thread returns the same one.
template <typename T>
__device__ RowState row_stats(const T* row, int V) {
  constexpr int N = Vec<T>::N;
  constexpr int UNROLL = 4;
  const int tid = threadIdx.x;
  RowState s = {NEG_INF, 0.f, 0.f};

  const int head = head_elems(row, V);
  if (tid < head) {
    float x = to_float_scalar(row[tid]);
    accumulate<1>(s, &x);
  }
  const T* body = row + head;
  const int nvec = (V - head) / N;
  // UNROLL vectors in flight per thread before any arithmetic
  int v = tid;
  for (; v + (UNROLL - 1) * ROW_THREADS < nvec; v += UNROLL * ROW_THREADS) {
    uint4 raw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      raw[u] = ld16(body + static_cast<size_t>(v + u * ROW_THREADS) * N);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float x[N];
      to_float<T>(raw[u], x);
      accumulate<N>(s, x);
    }
  }
  for (; v < nvec; v += ROW_THREADS) {
    float x[N];
    to_float<T>(ld16(body + static_cast<size_t>(v) * N), x);
    accumulate<N>(s, x);
  }
  const int tail0 = head + nvec * N;
  if (tail0 + tid < V) {
    float x = to_float_scalar(row[tail0 + tid]);
    accumulate<1>(s, &x);
  }

  // merge: within each warp, then across the CTA's warps
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    RowState o = {__shfl_xor_sync(0xffffffffu, s.m, off),
                  __shfl_xor_sync(0xffffffffu, s.l, off),
                  __shfl_xor_sync(0xffffffffu, s.t, off)};
    s = merge(s, o);
  }
  __shared__ RowState warp_state[ROW_THREADS / 32];
  const int warp = tid / 32, lane = tid % 32;
  if (lane == 0) warp_state[warp] = s;
  __syncthreads();
  s = warp_state[0];
#pragma unroll
  for (int w = 1; w < ROW_THREADS / 32; ++w) s = merge(s, warp_state[w]);
  return s;
}

}  // namespace repro_torch
