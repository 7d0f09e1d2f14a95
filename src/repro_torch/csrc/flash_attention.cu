// flash_attention — causal GQA attention forward for the prefill, with an
// optional sliding-window band.
//
// Replaces the Pallas TPU kernel flash_attention_kernel / _flash_kernel
// (src/repro/kernels/flash_attention/flash_attention.py:28-114).
//
// q (B,Sq,H,hd); k, v (B,Sk,KVH,hd) with Sq <= Sk; out (B,Sq,H,hd) in the
// dtype of q. Row qpos sees key kpos when kpos <= qpos and, with window > 0,
// kpos > qpos - window. Scores are fp32, scaled by hd^-0.5, masked to -1e30;
// the running max, sum and output stay in fp32.
//
// Bound on an H100: operations. Each (query, visible key) pair costs 4*hd
// FLOPs while the inputs are read once, hundreds of FLOPs per byte at
// prefill lengths. Design (simple and right first; no tensor cores yet): one
// block of 8 warps per (64-row Q tile, query head, batch). The Q tile and
// 32-key K/V tiles live in shared memory as fp32 (row stride hd+4, so the
// 16-byte reads of different key rows hit different banks); each warp owns
// 8 query rows and each lane one key of the tile for QK^T, then one lane per
// 32 output columns for PV. Tiles wholly above the diagonal or below the
// window band are skipped: every row keeps its own key, so its running max
// is a real score by then and skipped keys would have weighed exactly 0.
// Ragged tails of Sq and Sk are masked in place. At hd=256 (RecurrentGemma's
// local attention) the tiles take 140,800 bytes of shared memory, so one
// block runs per SM. The next step is mma/wgmma on bf16 tiles: the FP32
// CUDA cores here cap it far below the tensor rate.
#include "common.cuh"

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
    case 256: return launch<T, 256>(q, k, v, out, B, Sq, Sk, H, KVH, window, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a shape or dtype it does not take).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int Sq, int Sk, int H,
                               int KVH, int hd, int window, int dtype,
                               void* stream) {
  using namespace repro_torch;
  if (B <= 0 || Sq <= 0 || Sq > Sk || KVH <= 0 || H % KVH)
    return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)hd));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0)
    err = dispatch<float>(q, k, v, out, B, Sq, Sk, H, KVH, hd, window, scale, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, KVH, hd, window, scale, st);
  else
    err = (int)cudaErrorInvalidValue;
  if (err) return err;
  return (int)cudaGetLastError();
}
