// RG-LRU linear recurrence for the hybrid (Griffin) family's full-sequence
// forward, for sm_90a:
//
//   h_t = a_t * h_{t-1} + b_t,   elementwise over the width W,
//
// a, b (B,S,W) fp32 -> h (B,S,W) fp32, zero initial state.
//
// Replaces the Pallas kernel rglru_scan_kernel (_rglru_kernel) in
// src/repro/kernels/rglru_scan/rglru_scan.py. That kernel blocks time on
// the TPU's sequential grid, carries a (128,) state in VMEM from one time
// block to the next and runs a log-depth associative scan inside each
// block. Here blocks run in parallel and in no order, so time is a loop
// inside the thread instead: one thread per (batch row, channel) carries
// its state in a register and steps through S with one fmaf a step.
// Ragged S and W are masked in place.
//
// Bound on this card: bytes. The call reads a and b and writes h once,
// 12 bytes per element and 2 FLOPs: 3*B*S*W*4 bytes at 3.35 TB/s (4.7 us
// at the trainers' 4 x 80 x 4096, 30 us at B=1, S=2048). What holds a
// kernel back is latency: B*W threads (16,384 at 4 x 80, 4 warps an SM)
// each own a column of the sequence, and the bytes an SM keeps in flight
// set the rate.
//
// Two paths, one launch each; the entry picks by S (rglru_scan_path):
//
// - short (S <= RG_SHORT_MAX, every main-path call: 4 x 80 in the
//   trainers' reference inference, 1 x <=80 in the teacher-forced
//   forwards): each thread issues its channel's whole sequence of a and b
//   at its start as 4-byte cp.async copies into shared memory (any W, any
//   alignment), in RG_STAGES commit groups, so all of an SM's bytes are in
//   flight in one round; it steps through a group once that group has
//   landed (cp.async.wait_group). The data is the thread's own, so no
//   barrier is needed. Blocks of RG_SHORT_WARPS warps laid along W.
// - long: a block is one warp laid along W, each thread holds the next
//   RG_STEPS steps of a and b in registers, loaded while the current ones
//   step. A split of S with the carry spliced in afterwards (h = S_t +
//   P_t * carry, as the Pallas kernel does per time block) would add warps
//   at B=1; that is later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace repro_torch {

constexpr int RG_THREADS = 32;     // long path: one warp per block, along W
constexpr int RG_STEPS = 16;       // long path: time steps held in registers
constexpr int RG_SHORT_MAX = 128;  // longest S the short path takes
constexpr int RG_SHORT_WARPS = 1;  // short path: warps a block (of 1, 2, 4)
constexpr int RG_STAGES = 4;       // short path: copy groups a sequence
constexpr int RG_SHORT_THREADS = 32 * RG_SHORT_WARPS;

// fn(k) for k = 0 .. STAGES - 1, each once this thread's copy group k
// has landed (cp.async.wait_group takes its count as an immediate).
template <int STAGES, int K = 0, typename Fn>
__device__ __forceinline__ void each_landed_group(Fn&& fn) {
  if constexpr (K < STAGES) {
    hopper::cp_async_wait<STAGES - 1 - K>();
    fn(K);
    each_landed_group<STAGES, K + 1>(fn);
  }
}

__global__ void __launch_bounds__(RG_SHORT_THREADS)
    rglru_scan_short_kernel(const float* __restrict__ a,
                            const float* __restrict__ b,
                            float* __restrict__ h, int S, int W) {
  extern __shared__ float smem[];   // a then b, [S][RG_SHORT_THREADS] each
  const int tid = threadIdx.x;
  const int w = blockIdx.x * RG_SHORT_THREADS + tid;
  if (w >= W) return;               // no barriers below
  const size_t base = static_cast<size_t>(blockIdx.y) * S * W + w;
  float* sa = smem + tid;           // step t at sa[t * RG_SHORT_THREADS]
  float* sb = sa + S * RG_SHORT_THREADS;
  const int len = (S + RG_STAGES - 1) / RG_STAGES;
#pragma unroll
  for (int k = 0; k < RG_STAGES; ++k) {
    const int t1 = min(S, (k + 1) * len);
    for (int t = k * len; t < t1; ++t) {
      const size_t off = base + static_cast<size_t>(t) * W;
      hopper::cp_async4(hopper::smem_addr(sa + t * RG_SHORT_THREADS),
                        a + off, 4);
      hopper::cp_async4(hopper::smem_addr(sb + t * RG_SHORT_THREADS),
                        b + off, 4);
    }
    hopper::cp_async_commit();
  }
  float carry = 0.f;
  each_landed_group<RG_STAGES>([&](int k) {
    const int t1 = min(S, (k + 1) * len);
#pragma unroll 4
    for (int t = k * len; t < t1; ++t) {
      carry = fmaf(sa[t * RG_SHORT_THREADS], carry,
                   sb[t * RG_SHORT_THREADS]);
      h[base + static_cast<size_t>(t) * W] = carry;
    }
  });
}

__device__ __forceinline__ void load_steps(float (&na)[RG_STEPS],
                                           float (&nb)[RG_STEPS],
                                           const float* __restrict__ pa,
                                           const float* __restrict__ pb,
                                           int t0, int S, int W) {
#pragma unroll
  for (int u = 0; u < RG_STEPS; ++u) {
    const int t = t0 + u;
    const bool ok = t < S;
    const size_t off = static_cast<size_t>(ok ? t : 0) * W;
    na[u] = ok ? __ldg(pa + off) : 0.f;
    nb[u] = ok ? __ldg(pb + off) : 0.f;
  }
}

__global__ void __launch_bounds__(RG_THREADS)
    rglru_scan_kernel(const float* __restrict__ a,
                      const float* __restrict__ b, float* __restrict__ h,
                      int S, int W) {
  const int w = blockIdx.x * RG_THREADS + threadIdx.x;
  if (w >= W) return;                 // no shuffles or barriers below
  const size_t base = static_cast<size_t>(blockIdx.y) * S * W + w;
  const float* pa = a + base;
  const float* pb = b + base;
  float* ph = h + base;

  float na[RG_STEPS], nb[RG_STEPS];
  load_steps(na, nb, pa, pb, 0, S, W);
  float carry = 0.f;
  for (int t0 = 0; t0 < S; t0 += RG_STEPS) {
    float ca[RG_STEPS], cb[RG_STEPS];
#pragma unroll
    for (int u = 0; u < RG_STEPS; ++u) {
      ca[u] = na[u];
      cb[u] = nb[u];
    }
    // the next chunk's loads are in flight while this one steps
    if (t0 + RG_STEPS < S) load_steps(na, nb, pa, pb, t0 + RG_STEPS, S, W);
    const int tn = min(RG_STEPS, S - t0);
#pragma unroll
    for (int u = 0; u < RG_STEPS; ++u) {
      if (u < tn) {
        carry = fmaf(ca[u], carry, cb[u]);
        ph[static_cast<size_t>(t0 + u) * W] = carry;
      }
    }
  }
}

}  // namespace repro_torch

using namespace repro_torch;

// The path the entry takes for a sequence of S steps: 1 short, 2 long.
extern "C" int rglru_scan_path(int S) { return S <= RG_SHORT_MAX ? 1 : 2; }

// a, b, h contiguous (B,S,W) fp32; path 0 is the entry's choice, 1 or 2
// forces one (tests, timing). Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a shape or path it does not take).
extern "C" int rglru_scan(const void* a, const void* b, void* h, int B,
                          int S, int W, int path, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535 || path < 0 || path > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (path == 0) path = rglru_scan_path(S);
  if (path == 1 && S > RG_SHORT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pa = static_cast<const float*>(a);
  const float* pb = static_cast<const float*>(b);
  float* ph = static_cast<float*>(h);
  if (path == 1) {
    constexpr int max_bytes = 2 * RG_SHORT_MAX * RG_SHORT_THREADS * 4;
    // above 48 KB a block may use dynamic shared memory only after this
    static const cudaError_t attr =
        max_bytes <= 48 * 1024
            ? cudaSuccess
            : cudaFuncSetAttribute(rglru_scan_short_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   max_bytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 grid((W + RG_SHORT_THREADS - 1) / RG_SHORT_THREADS, B);
    rglru_scan_short_kernel<<<grid, RG_SHORT_THREADS,
                              2 * S * RG_SHORT_THREADS * sizeof(float), st>>>(
        pa, pb, ph, S, W);
  } else {
    const dim3 grid((W + RG_THREADS - 1) / RG_THREADS, B);
    rglru_scan_kernel<<<grid, RG_THREADS, 0, st>>>(pa, pb, ph, S, W);
  }
  return static_cast<int>(cudaGetLastError());
}
