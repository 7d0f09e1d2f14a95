// The GRPO/PPO actor loss over (N, V) logits, forward and backward, for
// sm_90a.
//
// Replaces the Pallas kernels fused_rl_loss_fwd_kernel (_fwd_kernel) and
// fused_rl_loss_bwd_kernel (_bwd_kernel) in
// src/repro/kernels/fused_rl_loss/fused_rl_loss.py:145 and :178.
//
// fused_rl_loss_fwd: the row's blocks, one cluster, stream it once
// (vocab_pass.cuh, shared with grpo_logprob; the target logit is picked
// from the tile that holds it) and the lanes of rank 0's first warp finish
// the per-token epilogue, one output each, from the row's old, ref and adv,
// loaded before the pass:
//
//   lse = m + log(max(l, 1e-30)), lp = x_t - lse, ent = lse - t / l,
//   ratio = exp(lp - old), pl = -min(ratio*A, clip(ratio, 1-eps, 1+eps)*A),
//   d = ref - lp, kl = exp(d) - d - 1.
//
// fused_rl_loss_bwd: elementwise given the row statistics the wrapper
// passes (lse, xbar = lse - ent, and the chain-rule scalars dlp, g_ent):
//
//   dx_j = dlp*[j == t] - p_j*(dlp + g_ent*(x_j - xbar)),  p_j = exp(x_j - lse)
//
// written in the logits' dtype with one rounding. Its grid is (rows, chunks
// of 4096 columns), so it fills the card at any N.
//
// Bound on this card: bytes. At N=316, V=65,024 in bf16 (a Falcon-Mamba-7B
// trainer micro-batch) the forward reads 41 MB, 0.0123 ms at 3.35 TB/s; at
// N=4096, V=152,064 it reads 1.25 GB (0.37 ms) and the backward reads and
// writes 2.5 GB (0.74 ms). With few rows the forward splits each row over
// up to 8 blocks of a cluster, so every SM has blocks and bytes in flight;
// at N=4096 a row is one block. Both passes use 16-byte vectors where a row
// allows and scalar heads and tails where it does not (rows of V=259 in
// bf16 start at 518-byte offsets), so any V works with no padding and no
// fallback.
#include "vocab_pass.cuh"

namespace repro_torch {
namespace {

constexpr int BWD_THREADS = 256;
constexpr int BWD_CHUNK = 4096;          // columns per CTA, a multiple of 8

template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
    fwd_kernel(const T* __restrict__ logits,
               const int64_t* __restrict__ targets,
               const float* __restrict__ old_lp,
               const float* __restrict__ ref_lp,
               const float* __restrict__ adv, float* __restrict__ out, int N,
               int V, float clip_eps, int nsplit) {
  const int row = blockIdx.x / nsplit, split = blockIdx.x % nsplit;
  const int64_t tgt = targets[row];
  float a = 0.f, old = 0.f, ref = 0.f;
  if (split == 0 && threadIdx.x < 32) {   // in flight during the pass
    a = adv[row];
    old = old_lp[row];
    ref = ref_lp[row];
  }
  RowPart p;
  if (!vocab_pass(logits + static_cast<size_t>(row) * V, V, tgt, split,
                  nsplit, p))
    return;
  // out-of-range targets pick 0, as the Pallas kernel's never-set g does
  const int lane = threadIdx.x;
  if (lane >= 6) return;
  const float l = fmaxf(p.s.l, 1e-30f);
  const float lse = p.s.m + logf(l);
  const float lp = p.g - lse;
  const float ratio = expf(lp - old);
  const float unclipped = ratio * a;
  const float clipped =
      fminf(fmaxf(ratio, 1.0f - clip_eps), 1.0f + clip_eps) * a;
  const float d = ref - lp;
  float v;                    // lane k writes output k of (lp, ent, kl, pl,
  switch (lane) {             // ratio, lse)
    case 0: v = lp; break;
    case 1: v = lse - p.s.t / l; break;
    case 2: v = expf(d) - d - 1.0f; break;
    case 3: v = -fminf(unclipped, clipped); break;
    case 4: v = ratio; break;
    default: v = lse; break;
  }
  out[lane * N + row] = v;
}

template <typename T> struct Pack;
template <> struct Pack<float> {
  static __device__ __forceinline__ uint4 from(const float* x) {
    return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]),
                      __float_as_uint(x[2]), __float_as_uint(x[3]));
  }
};
template <> struct Pack<__nv_bfloat16> {
  static __device__ __forceinline__ uint4 from(const float* x) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    return r;
  }
};

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
    bwd_kernel(const T* __restrict__ logits,
               const int64_t* __restrict__ targets,
               const float* __restrict__ lse, const float* __restrict__ xbar,
               const float* __restrict__ dlp, const float* __restrict__ g_ent,
               T* __restrict__ dx, int V) {
  constexpr int N = Vec<T>::N;
  const int row = blockIdx.x;
  const int c0 = blockIdx.y * BWD_CHUNK;
  const int n = min(BWD_CHUNK, V - c0);
  const size_t base = static_cast<size_t>(row) * V + c0;
  const T* x = logits + base;
  T* out = dx + base;
  const int64_t tgt = targets[row] - c0;   // column within this chunk
  const float r_lse = lse[row], r_xbar = xbar[row], r_dlp = dlp[row],
              r_gent = g_ent[row];
  auto grad = [&](float xj, int j) {
    const float p = __expf(xj - r_lse);
    float d = -p * (r_dlp + r_gent * (xj - r_xbar));
    return j == tgt ? d + r_dlp : d;
  };
  // dx and the logits are contiguous (N, V) arrays of one dtype on 16-byte
  // aligned bases, so their rows share one alignment.
  const int head = head_elems(x, n);
  const int tid = threadIdx.x;
  if (tid < head) out[tid] = from_float<T>(grad(to_float_scalar(x[tid]), tid));
  const int nvec = (n - head) / N;
  for (int v = tid; v < nvec; v += BWD_THREADS) {
    const int j0 = head + v * N;
    float xv[N];
    to_float<T>(ld16(x + j0), xv);
#pragma unroll
    for (int i = 0; i < N; ++i) xv[i] = grad(xv[i], j0 + i);
    *reinterpret_cast<uint4*>(out + j0) = Pack<T>::from(xv);
  }
  const int j = head + nvec * N + tid;
  if (j < n) out[j] = from_float<T>(grad(to_float_scalar(x[j]), j));
}

template <typename T>
int launch_fwd(const void* logits, const void* targets, const void* old_lp,
               const void* ref_lp, const void* adv, void* out, int N, int V,
               int nsplit, float clip_eps, cudaStream_t st) {
  return launch_rows(fwd_kernel<T>, N, V, sizeof(T), nsplit, st,
                     static_cast<const T*>(logits),
                     static_cast<const int64_t*>(targets),
                     static_cast<const float*>(old_lp),
                     static_cast<const float*>(ref_lp),
                     static_cast<const float*>(adv), static_cast<float*>(out),
                     N, V, clip_eps);
}

template <typename T>
void launch_bwd(const void* logits, const void* targets, const void* lse,
                const void* xbar, const void* dlp, const void* g_ent,
                void* dx, int N, int V, cudaStream_t st) {
  dim3 grid(N, (V + BWD_CHUNK - 1) / BWD_CHUNK);
  bwd_kernel<T><<<grid, BWD_THREADS, 0, st>>>(
      static_cast<const T*>(logits), static_cast<const int64_t*>(targets),
      static_cast<const float*>(lse), static_cast<const float*>(xbar),
      static_cast<const float*>(dlp), static_cast<const float*>(g_ent),
      static_cast<T*>(dx), V);
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// out is one (6, N) float32 buffer: lp, ent, kl, pl, ratio, lse. nsplit:
// blocks a row (1, 2, 4 or 8), 0 for the entry's own choice (vocab_nsplit
// in grpo_logprob.cu). dtype: 0 = float32, 1 = bfloat16 (the logits'; the
// (N,) vectors are float32, targets int64). Each entry returns the CUDA
// error of its launch (cudaErrorInvalidValue for a shape, split or dtype
// it does not take).
extern "C" int fused_rl_loss_fwd(const void* logits, const void* targets,
                                 const void* old_lp, const void* ref_lp,
                                 const void* adv, void* out, int N, int V,
                                 int nsplit, float clip_eps, int dtype,
                                 void* stream) {
  if (N <= 0 || V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd<float>(logits, targets, old_lp, ref_lp, adv, out, N,
                             V, nsplit, clip_eps, st);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(logits, targets, old_lp, ref_lp, adv,
                                     out, N, V, nsplit, clip_eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Clusters of nsplit forward blocks the card holds at once, or minus a
// CUDA error.
extern "C" int fused_rl_loss_fwd_clusters(int nsplit, int dtype) {
  return dtype == 0 ? max_clusters(fwd_kernel<float>, nsplit)
                    : max_clusters(fwd_kernel<__nv_bfloat16>, nsplit);
}

extern "C" int fused_rl_loss_bwd(const void* logits, const void* targets,
                                 const void* lse, const void* xbar,
                                 const void* dlp, const void* g_ent,
                                 void* dx, int N, int V, int dtype,
                                 void* stream) {
  if (N <= 0 || V <= 0 || (V + BWD_CHUNK - 1) / BWD_CHUNK > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_bwd<float>(logits, targets, lse, xbar, dlp, g_ent, dx, N, V, st);
  else if (dtype == 1)
    launch_bwd<__nv_bfloat16>(logits, targets, lse, xbar, dlp, g_ent, dx, N,
                              V, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
