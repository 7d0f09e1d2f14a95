// Mamba-1 selective scan for the ssm family's full-sequence forward, for
// sm_90a:
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t,   y_t = h_t . C_t,
//
// x, dt (B,S,D), A (D,N), B, C (B,S,N) -> y (B,S,D), all fp32, zero
// initial state.
//
// Replaces the Pallas kernel mamba_scan_kernel (_mamba_kernel) in
// src/repro/kernels/mamba_scan/mamba_scan.py. That kernel blocks time on
// the TPU's sequential grid, carries the (128, N) state in VMEM and runs a
// log-depth associative scan inside each time block. Here blocks run in
// parallel and in no order, so time is a loop inside the block instead:
// every channel (b, d) owns its state in registers and steps through S.
//
// Layout: a block of 128 threads covers 64 channels of one batch row; the
// two lanes of a pair share a channel, each holding N/2 of its states, and
// add their halves of y_t with one shuffle. (Four lanes a channel, which
// gives each scheduler two warps at B=1, measured 1.3x slower: more
// instructions per state.) Time goes in chunks of TCHUNK steps: each
// thread holds its share of the next chunk's x and dt (rows coalesced
// along D) and B_t, C_t (read through their batch and time strides, shared
// by the block's 64 channels) in registers, loaded while the current chunk
// steps from shared memory, and stores them there once the current chunk
// is done. Ragged S and D are masked in place.
//
// Bound on this card: at the long-prefill shape (B=1, S=2048, D=8192,
// N=16) the inputs and y are 0.20 GB, 0.060 ms at 3.35 TB/s, and the
// B*S*D*N = 268 M exponentials take 0.064 ms on the special-function units
// (16 per SM and clock); the exponent is folded into exp2 so each state
// step costs one MUFU op (ex2.approx, relative error about 2^-22) and three
// FP32 ops. With one warp per scheduler at B=1, much of each step's
// latency chain (shared loads, exp, the state update, the y sum and its
// shuffle) is exposed; a split of S, for B*D too small to fill 132 SMs
// with more warps, is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int MS_THREADS = 128;
constexpr int MS_SPLIT = 2;                   // threads sharing a channel
constexpr int MS_CHANNELS = MS_THREADS / MS_SPLIT;
constexpr int MS_TCHUNK = 32;                 // steps staged at a time
constexpr float MS_LOG2E = 1.4426950408889634f;

// Rows of x and dt, and elements of B and C, that one thread loads for a
// chunk: 128 threads over 64 columns, and over TCHUNK * N elements.
constexpr int MS_ROWS_PT = MS_TCHUNK * MS_CHANNELS / MS_THREADS;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
struct Chunk {
  static constexpr int BC = MS_TCHUNK * N / MS_THREADS;
  float x[MS_ROWS_PT], dt[MS_ROWS_PT], b[BC], c[BC];
};

// Load the chunk starting at step t0 into registers; out of range reads
// give 0 and touch no memory.
template <int N>
__device__ __forceinline__ void load_chunk(
    Chunk<N>& k, const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ Bb, const float* __restrict__ Cb, size_t row0,
    int t0, int S, int D, int d0, long long sb_t, long long sc_t) {
  const int tid = threadIdx.x;
  const int tn = min(MS_TCHUNK, S - t0);
  const int col = tid % MS_CHANNELS;
  const bool col_ok = d0 + col < D;
#pragma unroll
  for (int i = 0; i < MS_ROWS_PT; ++i) {
    const int r = tid / MS_CHANNELS + i * (MS_THREADS / MS_CHANNELS);
    const bool ok = col_ok && r < tn;
    const size_t off = (row0 + t0 + r) * D + d0 + col;
    k.x[i] = ok ? x[off] : 0.f;
    k.dt[i] = ok ? dt[off] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < Chunk<N>::BC; ++i) {
    const int e = tid + i * MS_THREADS;
    const int r = e / N, n = e % N;
    const bool ok = r < tn;
    k.b[i] = ok ? Bb[(t0 + r) * sb_t + n] : 0.f;
    k.c[i] = ok ? Cb[(t0 + r) * sc_t + n] : 0.f;
  }
}

template <int N>
__global__ void __launch_bounds__(MS_THREADS)
    mamba_scan_kernel(const float* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm, float* __restrict__ y,
                      int S, int D, long long sb_b, long long sb_t,
                      long long sc_b, long long sc_t) {
  constexpr int NH = N / MS_SPLIT;            // states per thread
  __shared__ float s_x[MS_TCHUNK][MS_CHANNELS];
  __shared__ float s_dt[MS_TCHUNK][MS_CHANNELS];
  __shared__ float s_b[MS_TCHUNK][N];
  __shared__ float s_c[MS_TCHUNK][N];

  const int tid = threadIdx.x;
  const int bi = blockIdx.y;
  const int d0 = blockIdx.x * MS_CHANNELS;
  const int ch = tid / MS_SPLIT;              // channel within the block
  const int part = tid % MS_SPLIT;            // which states of it
  const int d = d0 + ch;
  const bool active = d < D;

  float a2[NH], h[NH];
#pragma unroll
  for (int j = 0; j < NH; ++j) {
    a2[j] = active ? A[static_cast<size_t>(d) * N + part * NH + j] * MS_LOG2E
                   : 0.f;
    h[j] = 0.f;
  }

  const size_t row0 = static_cast<size_t>(bi) * S;   // first (b, t) row
  const float* Bb = Bm + bi * sb_b;
  const float* Cb = Cm + bi * sc_b;

  Chunk<N> next;
  load_chunk<N>(next, x, dt, Bb, Cb, row0, 0, S, D, d0, sb_t, sc_t);
  for (int t0 = 0; t0 < S; t0 += MS_TCHUNK) {
    const int tn = min(MS_TCHUNK, S - t0);
    __syncthreads();                          // the last chunk is consumed
#pragma unroll
    for (int i = 0; i < MS_ROWS_PT; ++i) {
      const int r = tid / MS_CHANNELS + i * (MS_THREADS / MS_CHANNELS);
      s_x[r][tid % MS_CHANNELS] = next.x[i];
      s_dt[r][tid % MS_CHANNELS] = next.dt[i];
    }
#pragma unroll
    for (int i = 0; i < Chunk<N>::BC; ++i) {
      const int e = tid + i * MS_THREADS;
      s_b[e / N][e % N] = next.b[i];
      s_c[e / N][e % N] = next.c[i];
    }
    __syncthreads();
    // the next chunk's loads are in flight while this one steps
    if (t0 + MS_TCHUNK < S)
      load_chunk<N>(next, x, dt, Bb, Cb, row0, t0 + MS_TCHUNK, S, D, d0,
                    sb_t, sc_t);

#pragma unroll 4
    for (int r = 0; r < tn; ++r) {
      const float dtt = s_dt[r][ch];
      const float dx = dtt * s_x[r][ch];
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        const int n = part * NH + j;
        h[j] = ex2(dtt * a2[j]) * h[j] + dx * s_b[r][n];
        if (j % 2) acc1 += h[j] * s_c[r][n];
        else acc0 += h[j] * s_c[r][n];
      }
      float acc = acc0 + acc1;
#pragma unroll
      for (int o = 1; o < MS_SPLIT; o <<= 1)     // the channel's lanes
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (part == 0 && active)
        y[(row0 + t0 + r) * D + d] = acc;
    }
  }
}

}  // namespace repro_torch

using namespace repro_torch;

// B and C are read through (batch, time) strides in elements; their last
// axis is contiguous. N is 8 or 16. Returns cudaGetLastError() after the
// launch.
extern "C" int mamba_scan(const void* x, const void* dt, const void* A,
                          const void* Bm, const void* Cm, void* y, int B,
                          int S, int D, int N, long long sb_b, long long sb_t,
                          long long sc_b, long long sc_t, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((D + MS_CHANNELS - 1) / MS_CHANNELS, B);
  const float* px = static_cast<const float*>(x);
  const float* pdt = static_cast<const float*>(dt);
  const float* pa = static_cast<const float*>(A);
  const float* pb = static_cast<const float*>(Bm);
  const float* pc = static_cast<const float*>(Cm);
  float* py = static_cast<float*>(y);
  if (N == 16)
    mamba_scan_kernel<16><<<grid, MS_THREADS, 0, st>>>(
        px, pdt, pa, pb, pc, py, S, D, sb_b, sb_t, sc_b, sc_t);
  else if (N == 8)
    mamba_scan_kernel<8><<<grid, MS_THREADS, 0, st>>>(
        px, pdt, pa, pb, pc, py, S, D, sb_b, sb_t, sc_b, sc_t);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
