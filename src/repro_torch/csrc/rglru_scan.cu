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
//
// Layout: a block is one warp laid along W, so each time step's loads of a
// and b and its store of h are 128 contiguous bytes per warp. One warp per
// block spreads a single batch row (W = 4096: 128 warps) over the card's
// 132 SMs instead of packing it onto a few. Each thread holds the next
// RG_STEPS steps of a and b in registers, loaded while the current ones
// step, so a chunk's loads overlap the previous chunk's chain of fmaf.
// Ragged S and W are masked in place.
//
// Bound on this card: bytes. The call reads a and b and writes h once,
// 12 bytes per element and 2 FLOPs: 3*B*S*W*4 bytes at 3.35 TB/s (30 us at
// B=1, S=2048, W=4096). With B*W threads in flight (4096 at B=1) the loop
// is latency-bound: each warp keeps only RG_STEPS steps of loads in
// flight. A split of S with the carry spliced in afterwards
// (h = S_t + P_t * carry, as the Pallas kernel does per time block) would
// add warps; that is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int RG_THREADS = 32;     // one warp per block, along W
constexpr int RG_STEPS = 16;       // time steps held in registers

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

// a, b, h contiguous (B,S,W) fp32. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a shape it does not take).
extern "C" int rglru_scan(const void* a, const void* b, void* h, int B,
                          int S, int W, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((W + RG_THREADS - 1) / RG_THREADS, B);
  rglru_scan_kernel<<<grid, RG_THREADS, 0, st>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(h), S, W);
  return static_cast<int>(cudaGetLastError());
}
