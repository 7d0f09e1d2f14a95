// flash_attention — causal GQA attention forward for the prefill, with an
// optional sliding-window band.
//
// Replaces the Pallas TPU kernel flash_attention_kernel / _flash_kernel
// (src/repro/kernels/flash_attention/flash_attention.py:28-114).
//
// q (B,Sq,H,hd); k, v (B,Sk,KVH,hd) with Sq <= Sk; out (B,Sq,H,hd) in the
// dtype of q. Query head h reads KV head h / (H/KVH). Row qpos sees key
// kpos when kpos <= qpos and, with window > 0, kpos > qpos - window.
// Scores are fp32, scaled by hd^-0.5, masked to the finite -1e30; the
// running max, sum and output stay in fp32; out = acc / max(l, 1e-30).
//
// Bound on an H100: operations. Each (query, visible key) pair costs 4*hd
// FLOPs (QK^T and PV) while q, k, v and out cross memory once: hundreds of
// FLOPs per byte at prefill lengths, so the bf16 tensor cores (989
// TFLOP/s dense) set the floor, not the 3.35 TB/s of memory.
//
// bf16 route (flash_wgmma): the tensor cores through wgmma. One block per
// (128-row Q tile, query head, batch), the longest tiles issued first so
// the causal imbalance leaves no tail. Two consumer warpgroups own 64 rows
// each (wgmma's M); one thread of a producer warpgroup issues TMA copies:
// the Q tile once, then K and V tiles of BK keys (128; 32 at hd 256)
// through a ring of mbarriers (2 stages; 4 at hd 256), so the copies of
// the next tiles overlap the products on this one, and TMA zero-fills
// rows past Sq and Sk. Operands sit in shared memory as bf16 in the
// 128-byte swizzle (64-byte at hd 32) that wgmma's descriptors read;
// setmaxnreg moves the producer's registers to the consumers. The tensor
// maps view each tensor as (hd, heads, S, B) with the true hd innermost, so
// hd 160 runs in the hd-192 instantiation (64-key tiles): TMA fills the
// columns past 160 with zeros on the loads, which changes no score and no
// output column, and drops them on the store; the scale stays 160^-0.5. Per
// tile,
// S = Q K^T is m64nBKk16 with both operands K-major in shared memory; the
// online softmax runs on the fp32 accumulator fragment in registers (row
// max and sum over the quad, exp2 with scale*log2(e) folded in; masks only
// on tiles that cross the diagonal or the window's lower edge); O += P V
// takes P from registers and V from shared memory (MN-major, the transpose
// bit) in 64-column products; O stays in fp32 registers. One warpgroup's
// softmax runs while the other's products do. Tiles wholly above the
// diagonal or below the band are skipped: every row keeps its own key, so
// its running max is a real score by then and skipped keys would have
// weighed exactly 0. The epilogue divides by l, casts to bf16 into the
// warpgroup's own Q rows and stores with TMA, which drops the rows past
// Sq.
//
// The one numerical departure: P is rounded to bf16 before P V (wgmma
// takes bf16 operands), where the Pallas kernel and the plain version
// multiply fp32 P by V. l sums the fp32 P. The kernel is held to the plain
// version within the bf16 bar, 2e-2 + 2e-2 |ref|.
//
// fp32 route (flash_kernel): the FP32 CUDA cores, kept for fp32 inputs
// (TF32 products would miss the fp32 bar of 1e-4). One block of 8 warps
// per (64-row Q tile, query head, batch); Q and 32-key K/V tiles in
// shared memory as fp32 (row stride hd+4, so the 16-byte reads of
// different key rows hit different banks); each warp owns 8 query rows and
// each lane one key of the tile for QK^T, then one lane per 32 output
// columns for PV. At hd=256 its tiles take 140,800 bytes of shared memory,
// one block per SM. hd 160 has its own instantiation (5 columns a lane).
#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace {

constexpr int BQ = 64, BK = 32, NWARP = 8, RPW = BQ / NWARP;

template <int HD>
constexpr int smem_bytes() {
  return (BQ * (HD + 4) + BK * (HD + 4) + BK * HD + BQ * BK) * 4;
}

template <typename T, int HD>
__global__ void __launch_bounds__(NWARP * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk,
             int H, int KVH, int window, float scale) {
  constexpr int QS = HD + 4;          // padded fp32 row stride of sQ, sK
  constexpr int DPL = HD / 32;        // output columns per lane
  constexpr int EPT = Vec<T>::N;
  constexpr int VPR = HD / EPT;       // 16-byte vectors per row
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                   // [BQ][QS]
  float* sK = sQ + BQ * QS;           // [BK][QS]
  float* sV = sK + BK * QS;           // [BK][HD]
  float* sP = sV + BK * HD;           // [BQ][BK]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t qrow = (size_t)H * HD, kvrow = (size_t)KVH * HD;
  const T* qb = q + (size_t)b * Sq * qrow + (size_t)h * HD;
  const T* kb = k + (size_t)b * Sk * kvrow + (size_t)kvh * HD;
  const T* vb = v + (size_t)b * Sk * kvrow + (size_t)kvh * HD;

  for (int i = threadIdx.x; i < BQ * VPR; i += NWARP * 32) {
    const int r = i / VPR, c = (i % VPR) * EPT;
    float f[EPT];
    if (q0 + r < Sq) {
      to_float<T>(ld16(qb + (size_t)(q0 + r) * qrow + c), f);
    } else {
#pragma unroll
      for (int e = 0; e < EPT; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < EPT; e += 4)
      *reinterpret_cast<float4*>(sQ + r * QS + c + e) =
          make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
  }

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[r][j] = 0.f;
  }

  // keys any row of this tile may see: causal above, window band below
  const int k_hi = min(min(q0 + BQ, Sq) - 1, Sk - 1);
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int row0 = warp * RPW;

  for (int t = k_lo / BK; t <= k_hi / BK; ++t) {
    const int k0 = t * BK;
    __syncthreads();                  // sQ written / last tile's reads done
    for (int i = threadIdx.x; i < BK * VPR; i += NWARP * 32) {
      const int r = i / VPR, c = (i % VPR) * EPT;
      float fk[EPT], fv[EPT];
      if (k0 + r < Sk) {
        to_float<T>(ld16(kb + (size_t)(k0 + r) * kvrow + c), fk);
        to_float<T>(ld16(vb + (size_t)(k0 + r) * kvrow + c), fv);
      } else {
#pragma unroll
        for (int e = 0; e < EPT; ++e) fk[e] = fv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < EPT; e += 4) {
        *reinterpret_cast<float4*>(sK + r * QS + c + e) =
            make_float4(fk[e], fk[e + 1], fk[e + 2], fk[e + 3]);
        *reinterpret_cast<float4*>(sV + r * HD + c + e) =
            make_float4(fv[e], fv[e + 1], fv[e + 2], fv[e + 3]);
      }
    }
    __syncthreads();

    // S = Q K^T: lane owns key k0 + lane for the warp's RPW rows
    float s[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r] = 0.f;
    const float* kr = sK + lane * QS;
    const float* qr = sQ + row0 * QS;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(qr + r * QS + d);
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }

    // online softmax; l keeps this lane's share of each row's sum
    const int kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int qpos = q0 + row0 + r;
      const bool ok = kpos < Sk && kpos <= qpos &&
                      (window <= 0 || kpos > qpos - window);
      const float sc = ok ? s[r] * scale : NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(sc));
      const float alpha = __expf(m[r] - m_new);
      const float p = __expf(sc - m_new);
      l[r] = l[r] * alpha + p;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[r][j] *= alpha;
      m[r] = m_new;
      sP[(row0 + r) * BK + lane] = p;
    }
    __syncwarp();

    // O += P V: lane owns columns lane + 32*j
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float vv[4][DPL];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int j = 0; j < DPL; ++j) vv[cc][j] = sV[(c + cc) * HD + lane + 32 * j];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(sP + (row0 + r) * BK + c);
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          float a = acc[r][j];
          a = fmaf(p4.x, vv[0][j], a);
          a = fmaf(p4.y, vv[1][j], a);
          a = fmaf(p4.z, vv[2][j], a);
          a = fmaf(p4.w, vv[3][j], a);
          acc[r][j] = a;
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int qpos = q0 + row0 + r;
    const float lsum = warp_sum(l[r]);
    if (qpos < Sq) {
      T* o = out + ((size_t)b * Sq + qpos) * qrow + (size_t)h * HD;
#pragma unroll
      for (int j = 0; j < DPL; ++j)
        o[lane + 32 * j] = from_float<T>(acc[r][j] / fmaxf(lsum, 1e-30f));
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int KVH, int window, float scale,
           cudaStream_t st) {
  constexpr int bytes = smem_bytes<HD>();
  // above 48 KB a block may use dynamic shared memory only after this call
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_kernel<T, HD><<<grid, NWARP * 32, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, KVH, window,
      scale);
  return 0;
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int Sq, int Sk, int H, int KVH, int hd, int window, float scale,
             cudaStream_t st) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, out, B, Sq, Sk, H, KVH, window, scale, st);
    case 64: return launch<T, 64>(q, k, v, out, B, Sq, Sk, H, KVH, window, scale, st);
    case 128: return launch<T, 128>(q, k, v, out, B, Sq, Sk, H, KVH, window, scale, st);
    case 160: return launch<T, 160>(q, k, v, out, B, Sq, Sk, H, KVH, window, scale, st);
    case 256: return launch<T, 256>(q, k, v, out, B, Sq, Sk, H, KVH, window, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}


// ---- bf16 route: wgmma tiles fed by TMA -----------------------------------

namespace wg {

using namespace hopper;

constexpr int BM = 128;                  // query rows per block
constexpr int CONSUMERS = 256;           // two warpgroups of 64 rows
constexpr int THREADS = CONSUMERS + 128; // and a producer warpgroup
// Above half of an SM's 228 KB, so one block runs per SM: the registers
// the producer gives up (168 -> 24) are the ones the consumers claim
// (168 -> 240).
constexpr int MIN_SMEM = 120 * 1024;

template <int HD>
struct Tile {
  // keys per K/V tile and depth of the ring: at hd 256 the O accumulator
  // takes 128 registers a thread, so S gets a 32-key tile (16 more), and
  // four of them keep as many bytes in flight as two of 64 keys; hd 160
  // runs as 192 (three 64-column blocks, the last half zeros), where two
  // stages of 128 keys would not fit beside the Q tile
  static constexpr int BK = HD == 256 ? 32 : HD == 192 ? 64 : 128;
  static constexpr int STAGES = HD == 256 ? 4 : 2;
  static constexpr int ROW = HD < 64 ? 2 * HD : 128;  // bytes a swizzled row
  static constexpr int CB = ROW / 2;                  // columns a row block
  static constexpr int NCB = HD / CB;                 // row blocks across hd
  static constexpr int SWZ = ROW == 128 ? 1 : 2;      // descriptor: 128/64 B
  static constexpr int SBO = 8 * ROW / 16;            // 8-row step, 16 B units
  static constexpr int Q_BYTES = BM * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;
  // 1024 bytes to align the tiles, 1024 for the barriers
  static constexpr int NEED = Q_BYTES + 2 * STAGES * KV_BYTES + 2048;
  static constexpr int SMEM = NEED > MIN_SMEM ? NEED : MIN_SMEM;
};

// Byte offset of `off` in a tile stored with the ROW-byte swizzle: the
// 16-byte chunk index XOR the row index within the swizzle's period.
template <int ROW>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ (((off >> 7) & (ROW / 16 - 1)) << 4);
}

// Shared memory: Q tile, STAGES K tiles, STAGES V tiles, then barriers.
// A tile of R rows is hd/CB row blocks of R x ROW bytes, each as TMA
// writes one box.
template <int STAGES>
struct Smem {
  uint32_t q, k, v, bars;
  __device__ uint32_t bar_q() const { return bars; }
  __device__ uint32_t full_k(int s) const { return bars + 8 * (1 + s); }
  __device__ uint32_t full_v(int s) const {
    return bars + 8 * (1 + STAGES + s);
  }
  __device__ uint32_t empty(int s) const {
    return bars + 8 * (1 + 2 * STAGES + s);
  }
};

// The producer: one thread issues every copy of the block.
template <int HD>
__device__ __forceinline__ void produce(const Smem<Tile<HD>::STAGES>& sm,
                                        const CUtensorMap* tq,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv, int q0, int h,
                                        int kvh, int b, int t_lo, int t_hi) {
  using T = Tile<HD>;
  constexpr int STAGES = T::STAGES;
  mbar_expect_tx(sm.bar_q(), T::Q_BYTES);
#pragma unroll
  for (int cb = 0; cb < T::NCB; ++cb)
    tma_load_4d(sm.q + cb * BM * T::ROW, tq, sm.bar_q(), cb * T::CB, h, q0,
                b);
  for (int t = t_lo, i = 0; t <= t_hi; ++t, ++i) {
    const int s = i % STAGES;
    mbar_wait(sm.empty(s), ((i / STAGES) & 1) ^ 1);
    const uint32_t k = sm.k + s * T::KV_BYTES, v = sm.v + s * T::KV_BYTES;
    mbar_expect_tx(sm.full_k(s), T::KV_BYTES);
#pragma unroll
    for (int cb = 0; cb < T::NCB; ++cb)
      tma_load_4d(k + cb * T::BK * T::ROW, tk, sm.full_k(s), cb * T::CB,
                  kvh, t * T::BK, b);
    mbar_expect_tx(sm.full_v(s), T::KV_BYTES);
#pragma unroll
    for (int cb = 0; cb < T::NCB; ++cb)
      tma_load_4d(v + cb * T::BK * T::ROW, tv, sm.full_v(s), cb * T::CB,
                  kvh, t * T::BK, b);
  }
}

// Online softmax on one tile of scores in the accumulator fragment (rows
// row0 and row0 + 8, in each 8 columns the two at col0): masks edge tiles,
// moves to base 2, updates the running max m and this thread's share of
// the sum l, sets alpha to the factor that rescales O and leaves
// exp2(s - m) in sc.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool edge,
                                             int k0, int row0, int col0,
                                             int window, float scale_log2) {
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * j + e] * scale_log2;
      if (edge) {
        const int row = row0 + 4 * (e & 2);
        const int key = k0 + 8 * j + col0 + (e & 1);
        if (key > row || (window > 0 && key <= row - window)) x = NEG_INF;
      }
      sc[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]));
    alpha[r] = fast_exp2(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    sc[i] = fast_exp2(sc[i] - m[(i >> 1) & 1]);
    l[(i >> 1) & 1] += sc[i];
  }
}

// P in bf16 as wgmma's A fragment: key step kk takes column groups 2kk
// (registers 0, 1) and 2kk + 1 (registers 2, 3).
template <int BK>
__device__ __forceinline__ void to_a_fragment(const float (&p)[BK / 2],
                                              uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    pa[j / 2][2 * (j % 2)] = pack_bf16(p[4 * j], p[4 * j + 1]);
    pa[j / 2][2 * (j % 2) + 1] = pack_bf16(p[4 * j + 2], p[4 * j + 3]);
  }
}

// A consumer warpgroup (`wgi`, uniform over the warp): 64 query rows
// [qlo, qlo + 64) through the tiles [t_lo, t_hi] of the block. The tiles
// no row of it sees lie at the two ends; they are released unread once
// they have landed, so the ring's phases stay in step. On each of the
// others: S = Q K^T, the softmax on the fragment, O += P V. The other
// warpgroup's products run while this one's softmax does.
template <int HD>
__device__ __forceinline__ void consume(const Smem<Tile<HD>::STAGES>& sm,
                                        const CUtensorMap* to, int wgi,
                                        int q0, int h, int b, int t_lo,
                                        int t_hi, int Sq, int window,
                                        float scale_log2) {
  using T = Tile<HD>;
  constexpr int STAGES = T::STAGES;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int qlo = q0 + 64 * wgi, qhi = qlo + 63;
  const int row0 = qlo + 16 * warp + lane / 4, col0 = 2 * (lane % 4);
  const uint32_t q_rows = sm.q + 64 * wgi * T::ROW;

  auto stage = [&](int t) { return (t - t_lo) % STAGES; };
  auto parity = [&](int t) { return (uint32_t)((t - t_lo) / STAGES) & 1; };
  auto drain = [&](int t) {
    mbar_wait(sm.full_k(stage(t)), parity(t));
    mbar_wait(sm.full_v(stage(t)), parity(t));
    mbar_arrive(sm.empty(stage(t)));
  };
  if (qlo >= Sq) {
    for (int t = t_lo; t <= t_hi; ++t) drain(t);
    return;
  }
  const int w_lo = window > 0 ? max(t_lo, max(0, qlo - window + 1) / T::BK)
                              : t_lo;
  const int w_hi = min(t_hi, qhi / T::BK);
  for (int t = t_lo; t < w_lo; ++t) drain(t);

  float o[T::NCB][T::CB / 2];
#pragma unroll
  for (int nb = 0; nb < T::NCB; ++nb)
#pragma unroll
    for (int i = 0; i < T::CB / 2; ++i) o[nb][i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const uint64_t desc_q = smem_desc(q_rows, 1, T::SBO, T::SWZ);

  mbar_wait(sm.bar_q(), 0);
  for (int t = w_lo; t <= w_hi; ++t) {
    const int s = stage(t), k0 = t * T::BK;

    // S = Q K^T, k16 steps along hd
    float sc[T::BK / 2];
    const uint64_t dk =
        smem_desc(sm.k + s * T::KV_BYTES, 1, T::SBO, T::SWZ);
    mbar_wait(sm.full_k(s), parity(t));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int cb = kk * 16 / T::CB, off = (kk * 16 % T::CB) * 2;
      wgmma_ss<T::BK>(sc, desc_q + ((cb * BM * T::ROW + off) >> 4),
                      dk + ((cb * T::BK * T::ROW + off) >> 4), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    touch(sc);

    float alpha[2];
    const bool edge =
        k0 + T::BK - 1 > qlo || (window > 0 && k0 <= qhi - window);
    softmax_tile<T::BK>(sc, m, l, alpha, edge, k0, row0, col0, window,
                        scale_log2);
    uint32_t pa[T::BK / 16][4];
    to_a_fragment<T::BK>(sc, pa);
#pragma unroll
    for (int nb = 0; nb < T::NCB; ++nb)
#pragma unroll
      for (int i = 0; i < T::CB / 2; ++i) o[nb][i] *= alpha[(i >> 1) & 1];

    // O += P V, k16 steps along the keys, 64 output columns a product (32
    // at hd 32)
    const uint64_t dv = smem_desc(sm.v + s * T::KV_BYTES,
                                  T::BK * T::ROW / 16, T::SBO, T::SWZ);
    mbar_wait(sm.full_v(s), parity(t));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T::BK / 16; ++kk)
#pragma unroll
      for (int nb = 0; nb < T::NCB; ++nb)
        wgmma_rs<T::CB>(o[nb], pa[kk],
                        dv + ((nb * T::BK * T::ROW + kk * 16 * T::ROW) >> 4));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < T::NCB; ++nb) touch(o[nb]);
#pragma unroll
    for (int kk = 0; kk < T::BK / 16; ++kk) touch(pa[kk]);
    mbar_arrive(sm.empty(s));
  }
  for (int t = w_hi + 1; t <= t_hi; ++t) drain(t);

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.f / fmaxf(quad_sum(l[r]), 1e-30f);
  named_sync(1 + wgi, 128);   // every warp is past its last read of q_rows
#pragma unroll
  for (int nb = 0; nb < T::NCB; ++nb)
#pragma unroll
    for (int j = 0; j < T::CB / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t off = (16 * warp + lane / 4 + 8 * r) * T::ROW +
                             (8 * j + col0) * 2;
        const uint32_t val = pack_bf16(o[nb][4 * j + 2 * r] * inv[r],
                                       o[nb][4 * j + 2 * r + 1] * inv[r]);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                         q_rows + nb * BM * T::ROW + swizzle<T::ROW>(off)),
                     "r"(val)
                     : "memory");
      }
  fence_async_smem();
  named_sync(1 + wgi, 128);
  if (threadIdx.x % 128 == 0) {
#pragma unroll
    for (int nb = 0; nb < T::NCB; ++nb)
      tma_store_4d(to, q_rows + nb * BM * T::ROW, nb * T::CB, h, qlo, b);
    tma_store_wait();
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const __grid_constant__ CUtensorMap to, int Sq, int H, int KVH,
            int window, float scale_log2) {
  using T = Tile<HD>;
  extern __shared__ uint8_t smem_raw[];
  constexpr int STAGES = T::STAGES;
  Smem<STAGES> sm;
  sm.q = (smem_addr(smem_raw) + 1023) & ~1023u;
  sm.k = sm.q + T::Q_BYTES;
  sm.v = sm.k + STAGES * T::KV_BYTES;
  sm.bars = sm.v + STAGES * T::KV_BYTES;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  // keys any row of this tile may see: causal above, window band below
  const int k_hi = min(q0 + BM, Sq) - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / T::BK, t_hi = k_hi / T::BK;

  if (threadIdx.x == 0) {
    mbar_init(sm.bar_q(), 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(sm.full_k(s), 1);
      mbar_init(sm.full_v(s), 1);
      mbar_init(sm.empty(s), CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // The warpgroup index, broadcast from lane 0 so the compiler knows it
  // is uniform over each warp: wgmma under a branch it cannot prove
  // uniform is serialized. One branch per role to the end: setmaxnreg
  // needs paths that never meet.
  const int wgi = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wgi == CONSUMERS / 128) {
    regs_release<24>();
    if (threadIdx.x == CONSUMERS)
      produce<HD>(sm, &tq, &tk, &tv, q0, h, h / (H / KVH), b, t_lo, t_hi);
  } else {
    regs_claim<240>();
    consume<HD>(sm, &to, wgi, q0, h, b, t_lo, t_hi, Sq, window, scale_log2);
  }
}

}  // namespace wg

// cuTensorMapEncodeTiled, taken from the driver at run time so the library
// needs no link to libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A TMA map over a bf16 (B, S, heads, hd) tensor, dims innermost first,
// copied in boxes of `rows` positions x `cols` columns of one head. The
// inner dim is the true hd: a box that reaches past it reads zeros and
// stores nothing there.
int tile_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
             int hd, int rows, int cols, CUtensorMapSwizzle swz) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;
  const cuuint64_t row = (cuuint64_t)heads * hd;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, row * 2,
                                 (cuuint64_t)S * row * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(ptr), dims, strides, box, step,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// HD is the instantiation's width, hd <= HD the tensors' head dim.
template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int B, int Sq, int Sk, int H, int KVH, int hd, int window,
                 float scale_log2, cudaStream_t st) {
  using T = wg::Tile<HD>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      wg::flash_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const CUtensorMapSwizzle swz = T::ROW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                               : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap tq, tk, tv, to;
  int err;
  if ((err = tile_map(&tq, q, B, Sq, H, hd, wg::BM, T::CB, swz)) ||
      (err = tile_map(&tk, k, B, Sk, KVH, hd, T::BK, T::CB, swz)) ||
      (err = tile_map(&tv, v, B, Sk, KVH, hd, T::BK, T::CB, swz)) ||
      (err = tile_map(&to, out, B, Sq, H, hd, 64, T::CB, swz)))
    return err;
  const dim3 grid((Sq + wg::BM - 1) / wg::BM, H, B);
  wg::flash_wgmma<HD><<<grid, wg::THREADS, T::SMEM, st>>>(
      tq, tk, tv, to, Sq, H, KVH, window, scale_log2);
  return 0;
}

int dispatch_wgmma(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Sk, int H, int KVH, int hd, int window,
                   float scale_log2, cudaStream_t st) {
  switch (hd) {
    case 32: return launch_wgmma<32>(q, k, v, out, B, Sq, Sk, H, KVH, hd, window, scale_log2, st);
    case 64: return launch_wgmma<64>(q, k, v, out, B, Sq, Sk, H, KVH, hd, window, scale_log2, st);
    case 128: return launch_wgmma<128>(q, k, v, out, B, Sq, Sk, H, KVH, hd, window, scale_log2, st);
    case 160: return launch_wgmma<192>(q, k, v, out, B, Sq, Sk, H, KVH, hd, window, scale_log2, st);
    case 256: return launch_wgmma<256>(q, k, v, out, B, Sq, Sk, H, KVH, hd, window, scale_log2, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// dtype: 0 = float32 (FP32 cores), 1 = bfloat16 (wgmma). Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a shape or
// dtype it does not take).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int Sq, int Sk, int H,
                               int KVH, int hd, int window, int dtype,
                               void* stream) {
  using namespace repro_torch;
  if (B <= 0 || Sq <= 0 || Sq > Sk || KVH <= 0 || H % KVH)
    return (int)cudaErrorInvalidValue;
  const double scale = 1.0 / sqrt((double)hd);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0)
    err = dispatch<float>(q, k, v, out, B, Sq, Sk, H, KVH, hd, window,
                          (float)scale, st);
  else if (dtype == 1)
    err = dispatch_wgmma(q, k, v, out, B, Sq, Sk, H, KVH, hd, window,
                         (float)(scale * 1.4426950408889634), st);
  else
    err = (int)cudaErrorInvalidValue;
  if (err) return err;
  return (int)cudaGetLastError();
}
