// Token log-prob and entropy over (N, V) logits for the reference-inference
// stage, for sm_90a.
//
// Replaces the Pallas kernel grpo_logprob_kernel (_kernel) in
// src/repro/kernels/grpo_logprob/grpo_logprob.py. One CTA per row streams
// the row once (row_stats.cuh: online log-sum-exp and the entropy sum) and
// its thread 0 reads the target logit directly, x[row, tgt], the value the
// Pallas kernel picks up as its block goes by:
//
//   lse = m + log(max(l, 1e-30)),  lp = x_t - lse,  ent = lse - t / l.
//
// Bound on this card: bytes. At N=4096, V=152,064 in bf16 the logits are
// 1.25 GB, 0.37 ms at 3.35 TB/s, against about 0.16 ms of exps at the SFU
// rate; the design keeps one exp per element and 16-byte loads so the
// stream stays near the byte bound. With few rows (N < a few hundred) one
// CTA per row leaves SMs idle; a V split across CTAs is later work.
#include "row_stats.cuh"

namespace repro_torch {

template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
    grpo_logprob_kernel(const T* __restrict__ logits,
                        const int64_t* __restrict__ targets,
                        float* __restrict__ lp, float* __restrict__ ent,
                        int V) {
  const int row = blockIdx.x;
  const T* x = logits + static_cast<size_t>(row) * V;
  RowState s = row_stats(x, V);
  if (threadIdx.x == 0) {
    const int64_t tgt = targets[row];
    // out-of-range targets pick 0, as the Pallas kernel's never-set g does
    const float g = (tgt >= 0 && tgt < V) ? to_float_scalar(x[tgt]) : 0.f;
    const float l = fmaxf(s.l, 1e-30f);
    const float lse = s.m + logf(l);
    lp[row] = g - lse;
    ent[row] = lse - s.t / l;
  }
}

}  // namespace repro_torch

using namespace repro_torch;

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch.
extern "C" int grpo_logprob(const void* logits, const void* targets,
                            void* lp, void* ent, int N, int V, int dtype,
                            void* stream) {
  if (N <= 0 || V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* tg = static_cast<const int64_t*>(targets);
  float* o_lp = static_cast<float*>(lp);
  float* o_ent = static_cast<float*>(ent);
  if (dtype == 0)
    grpo_logprob_kernel<float><<<N, ROW_THREADS, 0, st>>>(
        static_cast<const float*>(logits), tg, o_lp, o_ent, V);
  else if (dtype == 1)
    grpo_logprob_kernel<__nv_bfloat16><<<N, ROW_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(logits), tg, o_lp, o_ent, V);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
