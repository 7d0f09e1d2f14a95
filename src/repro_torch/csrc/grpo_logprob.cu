// Token log-prob and entropy over (N, V) logits for the reference-inference
// stage, for sm_90a.
//
// Replaces the Pallas kernel grpo_logprob_kernel (_kernel) in
// src/repro/kernels/grpo_logprob/grpo_logprob.py:84. The row's blocks, one
// cluster, stream it once (vocab_pass.cuh: online log-sum-exp, the entropy
// sum and the target logit, picked from the tile that holds it, as the
// Pallas kernel picks it up as its block goes by); two lanes of rank 0's
// first warp write
//
//   lse = m + log(max(l, 1e-30)),  lp = x_t - lse,  ent = lse - t / l.
//
// Bound on this card: bytes. At N=316, V=65,024 in bf16 (a trainer
// micro-batch of Falcon-Mamba-7B) the logits are 41 MB, 0.0123 ms at
// 3.35 TB/s; at N=4096, V=152,064 they are 1.25 GB, 0.37 ms, against about
// 0.16 ms of exps at the SFU rate. One exp per element and a ring of
// 16-byte copies keep the stream near the byte bound. With few rows, one
// block a row would leave SMs short of blocks and bytes in flight, so the
// entry splits each row over up to 8 blocks (vocab_pass.cuh).
#include "vocab_pass.cuh"

namespace repro_torch {
namespace {

template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
    grpo_logprob_kernel(const T* __restrict__ logits,
                        const int64_t* __restrict__ targets,
                        float* __restrict__ out, int N, int V, int nsplit) {
  const int row = blockIdx.x / nsplit, split = blockIdx.x % nsplit;
  const int64_t tgt = targets[row];
  RowPart p;
  if (!vocab_pass(logits + static_cast<size_t>(row) * V, V, tgt, split,
                  nsplit, p))
    return;
  // out-of-range targets pick 0, as the Pallas kernel's never-set g does
  const int lane = threadIdx.x;
  if (lane < 2) {
    const float l = fmaxf(p.s.l, 1e-30f);
    const float lse = p.s.m + logf(l);
    out[lane * N + row] = lane == 0 ? p.g - lse : lse - p.s.t / l;
  }
}

template <typename T>
int launch(const void* logits, const void* targets, void* out, int N, int V,
           int nsplit, cudaStream_t st) {
  return launch_rows(grpo_logprob_kernel<T>, N, V, sizeof(T), nsplit, st,
                     static_cast<const T*>(logits),
                     static_cast<const int64_t*>(targets),
                     static_cast<float*>(out), N, V);
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// out is one (2, N) float32 buffer: lp, then ent. nsplit: blocks a row (1,
// 2, 4 or 8), 0 for the entry's own choice (vocab_nsplit). dtype: 0 =
// float32, 1 = bfloat16. Returns the launch's CUDA error
// (cudaErrorInvalidValue for a shape, split or dtype it does not take).
extern "C" int grpo_logprob(const void* logits, const void* targets,
                            void* out, int N, int V, int nsplit, int dtype,
                            void* stream) {
  if (N <= 0 || V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(logits, targets, out, N, V, nsplit, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(logits, targets, out, N, V, nsplit, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The blocks a row that both vocab entries choose for N rows of V logits.
extern "C" int vocab_nsplit(int N, int V, int dtype) {
  return choose_nsplit(N, V, dtype == 0 ? 4 : 2, num_sms());
}

// Clusters of nsplit blocks the card holds at once, or minus a CUDA error.
extern "C" int grpo_logprob_clusters(int nsplit, int dtype) {
  return dtype == 0 ? max_clusters(grpo_logprob_kernel<float>, nsplit)
                    : max_clusters(grpo_logprob_kernel<__nv_bfloat16>,
                                   nsplit);
}
