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
// instructions per state.) B_t and C_t are read through their batch and
// time strides and shared by the block's 64 channels. Ragged S and D are
// masked in place.
//
// Two paths, one launch each; the entry picks (mamba_scan_path):
//
// - short (S <= MS_SHORT_MAX on a grid of at most MS_SHORT_BLOCKS blocks an
//   SM: the teacher-forced forwards' 1 x <=80): the block issues every
//   step's x, dt, B and C at its start as cp.async copies into shared
//   memory (x and dt rows 16 bytes a copy where D and the bases allow; B
//   and C, whose rows need not be 16-byte aligned, 4), in MS_STAGES stages
//   that double in length, one mbarrier each; each thread's copies of a
//   stage arrive on the stage's barrier when they land
//   (cp.async.mbarrier.arrive.noinc), and the block steps through a stage
//   as soon as its barrier completes. One __syncthreads, after the
//   barriers' init; none while stepping.
// - long (everything else: the trainers' 4 x 80, the long prefill): time
//   goes in chunks of MS_TCHUNK steps; each thread holds its share of the
//   next chunk in registers, loaded while the current chunk steps from
//   shared memory, and stores them there once it is done.
//
// Bound on this card: the B*S*D*N exponentials on the special-function
// units (16 per SM and clock): 0.0100 ms at 4 x 80 x 8192 x 16, 0.064 ms at
// B=1, S=2048, beside 0.0096 and 0.060 ms of bytes at 3.35 TB/s. The
// exponent is folded into exp2, so each state step costs one MUFU op
// (ex2.approx, relative error about 2^-22) and four FP32 ops. What sets the
// time at the main path's rows is the step loop itself, not the loads: on
// an H100 the loop alone (its copies left out) takes 1.7x the SFU bound at
// 4 x 80, and leaving out the exps, the B and C reads or the stores saves
// about a tenth each. A share of the exps taken as a polynomial on the FMA
// pipes, deeper unrolling, software pipelining, and one or four lanes a
// channel were all slower (PERF.md; scripts/mamba_scan_variants.py).
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace repro_torch {

constexpr int MS_THREADS = 128;
constexpr int MS_SPLIT = 2;                   // threads sharing a channel
constexpr int MS_CHANNELS = MS_THREADS / MS_SPLIT;
constexpr int MS_TCHUNK = 32;                 // long path: steps a chunk
constexpr int MS_SHORT_MAX = 128;             // longest S the short path takes
constexpr int MS_SHORT_BLOCKS = 2;            // its grid's blocks an SM at most
constexpr int MS_STAGES = 3;                  // short path: stages of copies
constexpr float MS_LOG2E = 1.4426950408889634f;

// Rows of x and dt, and elements of B and C, that one thread loads for a
// chunk: 128 threads over 64 columns, and over TCHUNK * N elements.
constexpr int MS_ROWS_PT = MS_TCHUNK * MS_CHANNELS / MS_THREADS;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// B_t's or C_t's NH values of a thread's states from shared memory (16-
// byte aligned: read as float4 where NH allows).
template <int NH>
__device__ __forceinline__ void load_states(float (&v)[NH],
                                            const float* __restrict__ p) {
  if constexpr (NH % 4 == 0) {
#pragma unroll
    for (int q = 0; q < NH / 4; ++q) {
      const float4 w = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = w.x, v[4 * q + 1] = w.y, v[4 * q + 2] = w.z,
      v[4 * q + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < NH; ++j) v[j] = p[j];
  }
}

// One step over a thread's NH states, each state's exponential beside its
// update (so the special-function units' ops spread over the step): returns
// the thread's part of y_t, summed over the channel's lanes.
template <int NH>
__device__ __forceinline__ float step(float (&h)[NH], const float (&a2)[NH],
                                      float dtt, float xt,
                                      const float* __restrict__ b,
                                      const float* __restrict__ c) {
  float bv[NH], cv[NH];
  load_states<NH>(bv, b);
  load_states<NH>(cv, c);
  const float dx = dtt * xt;
  float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
  for (int j = 0; j < NH; ++j) {
    const float e = ex2(dtt * a2[j]);
    h[j] = e * h[j] + dx * bv[j];
    if (j % 2) acc1 += h[j] * cv[j];
    else acc0 += h[j] * cv[j];
  }
  float acc = acc0 + acc1;
#pragma unroll
  for (int o = 1; o < MS_SPLIT; o <<= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  return acc;
}

// The end of stage k of the short path's copies: the stages double in
// length (S/4, S/4, S/2 for three), so the first lands soon and the later
// ones while the block steps through the earlier.
__device__ __forceinline__ int stage_end(int k, int S) {
  return k == MS_STAGES - 1 ? S : S >> (MS_STAGES - 1 - k);
}

// VEC: x and dt rows copied 16 bytes at a time (D % 4 == 0 and 16-byte
// aligned bases, as the wrapper's inputs are), else 4.
template <int N, bool VEC>
__global__ void __launch_bounds__(MS_THREADS)
    mamba_scan_short_kernel(const float* __restrict__ x,
                            const float* __restrict__ dt,
                            const float* __restrict__ A,
                            const float* __restrict__ Bm,
                            const float* __restrict__ Cm,
                            float* __restrict__ y, int S, int D,
                            long long sb_b, long long sb_t, long long sc_b,
                            long long sc_t) {
  constexpr int NH = N / MS_SPLIT;            // states per thread
  constexpr int CW = VEC ? 4 : 1;             // floats a copy
  constexpr int CPR = MS_CHANNELS / CW;       // copies a row of a block
  constexpr int RPP = MS_THREADS / CPR;       // rows a pass of the block
  // x and dt as [S][MS_CHANNELS], then B and C as [S][N]
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t full[MS_STAGES];
  float* s_x = smem;
  float* s_dt = s_x + S * MS_CHANNELS;
  float* s_b = s_dt + S * MS_CHANNELS;
  float* s_c = s_b + S * N;

  const int tid = threadIdx.x;
  const int bi = blockIdx.y;
  const int d0 = blockIdx.x * MS_CHANNELS;
  if (tid == 0) {
    for (int k = 0; k < MS_STAGES; ++k)
      hopper::mbar_init(hopper::smem_addr(&full[k]), MS_THREADS);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  // every stage's copies, issued at once; columns past D read nothing and
  // land as 0. The thread copies CW columns at ccol of rows crow + i*RPP.
  const size_t row0 = static_cast<size_t>(bi) * S;   // first (b, t) row
  const int ccol = tid % CPR * CW, crow = tid / CPR;
  const uint32_t cbytes = d0 + ccol < D ? 4 * CW : 0;
  const size_t goff = cbytes ? (row0 + crow) * D + d0 + ccol : 0;
  const float* gx = x + goff;
  const float* gdt = dt + goff;
  const size_t gstep = cbytes ? static_cast<size_t>(RPP) * D : 0;
  uint32_t sx = hopper::smem_addr(s_x + crow * MS_CHANNELS + ccol);
  uint32_t sdt = hopper::smem_addr(s_dt + crow * MS_CHANNELS + ccol);
  constexpr uint32_t SSTEP = RPP * MS_CHANNELS * sizeof(float);
  const float* Bb = Bm + bi * sb_b;
  const float* Cb = Cm + bi * sc_b;
  int t = crow;
#pragma unroll
  for (int k = 0; k < MS_STAGES; ++k) {
    const int t0 = k ? stage_end(k - 1, S) : 0, t1 = stage_end(k, S);
    for (; t < t1; t += RPP) {
      if constexpr (VEC) {
        hopper::cp_async16(sx, gx, cbytes);
        hopper::cp_async16(sdt, gdt, cbytes);
      } else {
        hopper::cp_async4(sx, gx, cbytes);
        hopper::cp_async4(sdt, gdt, cbytes);
      }
      gx += gstep, gdt += gstep, sx += SSTEP, sdt += SSTEP;
    }
    for (int e = t0 * N + tid; e < t1 * N; e += MS_THREADS) {
      const int te = e / N, n = e % N;
      hopper::cp_async4(hopper::smem_addr(s_b + e), Bb + te * sb_t + n, 4);
      hopper::cp_async4(hopper::smem_addr(s_c + e), Cb + te * sc_t + n, 4);
    }
    hopper::cp_async_mbar_arrive(hopper::smem_addr(&full[k]));
  }

  const int ch = tid / MS_SPLIT;              // channel within the block
  const int part = tid % MS_SPLIT;            // which states of it
  const int d = d0 + ch;
  const bool store = part == 0 && d < D;
  float a2[NH], h[NH];
#pragma unroll
  for (int j = 0; j < NH; ++j) {
    a2[j] = d < D ? A[static_cast<size_t>(d) * N + part * NH + j] * MS_LOG2E
                  : 0.f;
    h[j] = 0.f;
  }

  float* yp = y + row0 * D + d;               // y_0 of the channel
#pragma unroll 1
  for (int k = 0; k < MS_STAGES; ++k) {
    hopper::mbar_wait(hopper::smem_addr(&full[k]), 0);   // stage k landed
    const int t1 = stage_end(k, S);
#pragma unroll 4
    for (int r = k ? stage_end(k - 1, S) : 0; r < t1; ++r) {
      const float acc = step<NH>(h, a2, s_dt[r * MS_CHANNELS + ch],
                                 s_x[r * MS_CHANNELS + ch],
                                 s_b + r * N + part * NH,
                                 s_c + r * N + part * NH);
      if (store) yp[static_cast<size_t>(r) * D] = acc;
    }
  }
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
  __shared__ __align__(16) float s_b[MS_TCHUNK][N];
  __shared__ __align__(16) float s_c[MS_TCHUNK][N];

  const int tid = threadIdx.x;
  const int bi = blockIdx.y;
  const int d0 = blockIdx.x * MS_CHANNELS;
  const int ch = tid / MS_SPLIT;              // channel within the block
  const int part = tid % MS_SPLIT;            // which states of it
  const int d = d0 + ch;
  const bool store = part == 0 && d < D;

  float a2[NH], h[NH];
#pragma unroll
  for (int j = 0; j < NH; ++j) {
    a2[j] = d < D ? A[static_cast<size_t>(d) * N + part * NH + j] * MS_LOG2E
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

    float* yp = y + (row0 + t0) * D + d;      // y_t0 of the channel
#pragma unroll 4
    for (int r = 0; r < tn; ++r) {
      const float acc = step<NH>(h, a2, s_dt[r][ch], s_x[r][ch],
                                 &s_b[r][part * NH], &s_c[r][part * NH]);
      if (store) yp[static_cast<size_t>(r) * D] = acc;
    }
  }
}

// Internal linkage: a template's function-local static is otherwise one
// object across every library of the process that defines it (as the
// variants script loads several builds of this source).
namespace {

// Bytes of the short path's dynamic shared memory for S steps.
constexpr size_t short_bytes(int S, int N) {
  return static_cast<size_t>(S) * (2 * MS_CHANNELS + 2 * N) * sizeof(float);
}

template <int N>
int launch(const float* x, const float* dt, const float* A, const float* Bm,
           const float* Cm, float* y, int B, int S, int D, long long sb_b,
           long long sb_t, long long sc_b, long long sc_t, int path,
           cudaStream_t st) {
  const dim3 grid((D + MS_CHANNELS - 1) / MS_CHANNELS, B);
  if (path == 2) {
    mamba_scan_kernel<N><<<grid, MS_THREADS, 0, st>>>(
        x, dt, A, Bm, Cm, y, S, D, sb_b, sb_t, sc_b, sc_t);
    return static_cast<int>(cudaGetLastError());
  }
  // above 48 KB a block may use dynamic shared memory only after this call
  const int max_bytes = static_cast<int>(short_bytes(MS_SHORT_MAX, N));
  static const cudaError_t attr = cudaFuncSetAttribute(
      mamba_scan_short_kernel<N, true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, max_bytes);
  static const cudaError_t attr4 = cudaFuncSetAttribute(
      mamba_scan_short_kernel<N, false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, max_bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (attr4 != cudaSuccess) return static_cast<int>(attr4);
  const bool vec = D % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(dt)) % 16 == 0;
  auto kernel = vec ? mamba_scan_short_kernel<N, true>
                    : mamba_scan_short_kernel<N, false>;
  kernel<<<grid, MS_THREADS, short_bytes(S, N), st>>>(
      x, dt, A, Bm, Cm, y, S, D, sb_b, sb_t, sc_b, sc_t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

}  // namespace repro_torch

using namespace repro_torch;

// The path the entry takes for B rows of S steps over D channels on a
// card of `sms` SMs: 1 short, 2 long. With more blocks an SM, the long
// path's chunk prefetch already hides the loads behind the other blocks'
// steps, and the short path's shared memory would cost occupancy.
extern "C" int mamba_scan_path(int B, int S, int D, int sms) {
  const long long blocks =
      static_cast<long long>(B) * ((D + MS_CHANNELS - 1) / MS_CHANNELS);
  return S <= MS_SHORT_MAX &&
                 blocks <= static_cast<long long>(MS_SHORT_BLOCKS) * sms
             ? 1
             : 2;
}

// B and C are read through (batch, time) strides in elements; their last
// axis is contiguous. N is 8 or 16; path 0 is the entry's choice, 1 or 2
// forces one (tests, timing). Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a shape or path it does not take).
extern "C" int mamba_scan(const void* x, const void* dt, const void* A,
                          const void* Bm, const void* Cm, void* y, int B,
                          int S, int D, int N, long long sb_b, long long sb_t,
                          long long sc_b, long long sc_t, int path,
                          void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || B > 65535 || path < 0 || path > 2 ||
      (N != 8 && N != 16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (path == 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    path = mamba_scan_path(B, S, D, sms);
  }
  if (path == 1 && S > MS_SHORT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  auto launch_n = N == 16 ? launch<16> : launch<8>;
  return launch_n(static_cast<const float*>(x), static_cast<const float*>(dt),
                  static_cast<const float*>(A), static_cast<const float*>(Bm),
                  static_cast<const float*>(Cm), static_cast<float*>(y), B, S,
                  D, sb_b, sb_t, sc_b, sc_t, path,
                  static_cast<cudaStream_t>(stream));
}
