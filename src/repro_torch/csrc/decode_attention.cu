// decode_attention — one-query GQA attention over a masked KV cache.
//
// Replaces the Pallas TPU kernel decode_attention_kernel / _decode_kernel
// (src/repro/kernels/decode_attention/decode_attention.py:21-92).
//
// q (B,1,H,hd); k, v (B,S,KVH,hd); valid (B,S) bool; out (B,1,H,hd) in the
// dtype of q. Scores are fp32, scaled by hd^-0.5; masked scores take -1e30
// and query head h reads KV head h / (H/KVH). A row with no valid key gives
// the uniform average of its values, as the reference does.
//
// Bound on an H100: bytes. The call must read the K and V caches once
// (2*B*S*KVH*hd elements) and does 4*(H/KVH) FLOPs per cached element, a few
// FLOPs per byte against the card's ~295 FLOP/byte ridge. Design, two
// launches on one stream:
//  * decode_partial: one block per (S split, batch, KV head, group of up to
//    8 query heads). Each K/V row leaves device memory once for all the query
//    heads that share it (7 for Qwen2.5-7B), and the S splits put enough
//    blocks in flight to fill the 132 SMs (B*KVH alone is 16 at B=4, KVH=4).
//    Each lane loads 16 bytes of a row, or two adjacent 16-byte vectors
//    where a row has more than 32 of them (fp32 at hd=256); a group of
//    up to 32 lanes holds one key, so a warp walks one key or more per
//    step, with 32 bytes a lane in flight. Every lane group keeps its own
//    fp32 online softmax (m, l, acc); the states merge with warp shuffles,
//    then across warps in shared memory, into one (m, l, acc) per (batch,
//    head, split) in scratch the caller allocates. That shared buffer
//    (NW*GMAX*hd floats, 64 KB at hd=256) is dynamic shared memory, opted
//    in above 48 KB with cudaFuncSetAttribute. A GQA group larger than
//    GMAX (RecurrentGemma's 16) runs as several head groups, each reading
//    the K/V rows once.
//  * decode_combine: one block per (batch, head) merges its splits.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int NW = 8;      // warps per block
constexpr int GMAX = 8;    // query heads per block
constexpr int LANE_BYTES = 32;  // bytes of K (and of V) a lane has in flight

// Merge online-softmax state (m2, l2, a2) into (m, l, a).
template <int N>
__device__ __forceinline__ void merge(float& m, float& l, float (&a)[N],
                                      float m2, float l2,
                                      const float (&a2)[N]) {
  const float mn = fmaxf(m, m2);
  const float c1 = __expf(m - mn), c2 = __expf(m2 - mn);
  l = l * c1 + l2 * c2;
#pragma unroll
  for (int e = 0; e < N; ++e) a[e] = a[e] * c1 + a2[e] * c2;
  m = mn;
}

template <typename T, int HD>
__global__ void __launch_bounds__(NW * 32)
decode_partial(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const uint8_t* __restrict__ valid,
               float* __restrict__ part_m, float* __restrict__ part_l,
               float* __restrict__ part_acc, int S, int H, int KVH,
               int chunk, float scale) {
  constexpr int EPT = Vec<T>::N;   // elements per 16-byte vector
  // elements per lane: one vector, or more where a row has over 32 of them
  constexpr int EPL = HD / 32 > EPT ? HD / 32 : EPT;
  constexpr int VPL = EPL / EPT;   // vectors per lane
  constexpr int LPK = HD / EPL;    // lanes per key row
  constexpr int KPW = 32 / LPK;    // keys per warp step
  constexpr int UNROLL = LANE_BYTES / (16 * VPL);  // steps in flight
  static_assert(HD % EPL == 0 && LPK <= 32 && 32 % LPK == 0 && UNROLL >= 1,
                "head dim");
  __shared__ float sm_m[NW][GMAX], sm_l[NW][GMAX];
  extern __shared__ __align__(16) float sm_acc[];   // [NW][GMAX][HD]

  const int split = blockIdx.x, nsplit = gridDim.x;
  const int b = blockIdx.z;
  const int G = H / KVH, ngroups = (G + GMAX - 1) / GMAX;
  const int kvh = blockIdx.y / ngroups, grp = blockIdx.y % ngroups;
  const int h0 = kvh * G + grp * GMAX;          // first query head here
  const int ng = min(GMAX, G - grp * GMAX);
  const int lo = split * chunk, hi = min(S, lo + chunk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / LPK, e0 = (lane % LPK) * EPL;

  float qf[GMAX][EPL], acc[GMAX][EPL], m[GMAX], l[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < ng) {
#pragma unroll
      for (int c = 0; c < VPL; ++c)
        to_float<T>(ld16(q + ((size_t)b * H + h0 + g) * HD + e0 + c * EPT),
                    qf[g] + c * EPT);
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) qf[g][e] = 0.f;
    }
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  const size_t row = (size_t)KVH * HD;   // elements from one key to the next
  const T* kb = k + (size_t)b * S * row + (size_t)kvh * HD + e0;
  const T* vb = v + (size_t)b * S * row + (size_t)kvh * HD + e0;
  const uint8_t* ok_row = valid + (size_t)b * S;
  const int step = NW * KPW;

  // base is uniform across the warp, so every lane reaches the shuffles.
  for (int base = lo + warp * KPW; base < hi; base += step * UNROLL) {
    uint4 kr[UNROLL][VPL], vr[UNROLL][VPL];
    bool in[UNROLL], ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = base + u * step + sub;
      in[u] = j < hi;
#pragma unroll
      for (int c = 0; c < VPL; ++c) {
        if (in[u]) {
          kr[u][c] = ld16(kb + (size_t)j * row + c * EPT);
          vr[u][c] = ld16(vb + (size_t)j * row + c * EPT);
        } else {
          kr[u][c] = vr[u][c] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
      ok[u] = in[u] && ok_row[j] != 0;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float kf[EPL], vf[EPL];
#pragma unroll
      for (int c = 0; c < VPL; ++c) {
        to_float<T>(kr[u][c], kf + c * EPT);
        to_float<T>(vr[u][c], vf + c * EPT);
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= ng) break;                 // uniform across the block
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) s = fmaf(qf[g][e], kf[e], s);
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        s = ok[u] ? s * scale : NEG_INF;
        if (in[u]) {                        // keys past the split are no keys
          const float m_new = fmaxf(m[g], s);
          const float alpha = __expf(m[g] - m_new);
          const float p = __expf(s - m_new);
          l[g] = l[g] * alpha + p;
#pragma unroll
          for (int e = 0; e < EPL; ++e)
            acc[g][e] = fmaf(p, vf[e], acc[g][e] * alpha);
          m[g] = m_new;
        }
      }
    }
  }

  // merge the lane groups of this warp (lanes with the same slice e0)
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= ng) break;
      float ao[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        ao[e] = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lw = __shfl_xor_sync(0xffffffffu, l[g], off);
      merge(m[g], l[g], acc[g], mo, lw, ao);
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= ng) break;
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        sm_acc[(warp * GMAX + g) * HD + e0 + e] = acc[g][e];
    }
  }
  __syncthreads();

  // merge the warps; one thread per (head, column) of this split
  for (int i = threadIdx.x; i < ng * HD; i += NW * 32) {
    const int g = i / HD, d = i % HD;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = __expf(sm_m[w][g] - mx);
      lsum += sm_l[w][g] * c;
      a += sm_acc[(w * GMAX + g) * HD + d] * c;
    }
    const size_t p = ((size_t)b * H + h0 + g) * nsplit + split;
    part_acc[p * HD + d] = a;
    if (d == 0) {
      part_m[p] = mx;
      part_l[p] = lsum;
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
decode_combine(const float* __restrict__ part_m,
               const float* __restrict__ part_l,
               const float* __restrict__ part_acc, T* __restrict__ out,
               int nsplit) {
  const size_t bh = blockIdx.x;              // b * H + h
  const int d = threadIdx.x;
  const float* pm = part_m + bh * nsplit;
  const float* pl = part_l + bh * nsplit;
  float mx = NEG_INF;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, pm[s]);
  float lsum = 0.f, a = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const float c = __expf(pm[s] - mx);
    lsum += pl[s] * c;
    a += part_acc[(bh * nsplit + s) * HD + d] * c;
  }
  out[bh * HD + d] = from_float<T>(a / fmaxf(lsum, 1e-30f));
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* valid,
           float* pm, float* pl, float* pacc, void* out, int B, int S,
           int H, int KVH, int nsplit, int chunk, float scale,
           cudaStream_t st) {
  constexpr int bytes = NW * GMAX * HD * 4;
  // above 48 KB a block may use dynamic shared memory only after this call
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_partial<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != cudaSuccess) return (int)attr;
  const int ngroups = (H / KVH + GMAX - 1) / GMAX;
  const dim3 grid(nsplit, KVH * ngroups, B);
  decode_partial<T, HD><<<grid, NW * 32, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(valid), pm, pl,
      pacc, S, H, KVH, chunk, scale);
  decode_combine<T, HD><<<B * H, HD, 0, st>>>(pm, pl, pacc,
                                              static_cast<T*>(out), nsplit);
  return 0;
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* valid,
             float* pm, float* pl, float* pacc, void* out, int B, int S,
             int H, int KVH, int hd, int nsplit, int chunk, float scale,
             cudaStream_t st) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, valid, pm, pl, pacc, out, B, S, H, KVH, nsplit, chunk, scale, st);
    case 64: return launch<T, 64>(q, k, v, valid, pm, pl, pacc, out, B, S, H, KVH, nsplit, chunk, scale, st);
    case 128: return launch<T, 128>(q, k, v, valid, pm, pl, pacc, out, B, S, H, KVH, nsplit, chunk, scale, st);
    case 256: return launch<T, 256>(q, k, v, valid, pm, pl, pacc, out, B, S, H, KVH, nsplit, chunk, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// Scratch from the caller, fp32: part_m and part_l (B,H,nsplit), part_acc
// (B,H,nsplit,hd); split s covers keys [s*chunk, min(S, (s+1)*chunk)), and
// every split holds at least one key. dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the launches (cudaErrorInvalidValue for
// a shape or dtype it does not take).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* valid, void* part_m,
                                void* part_l, void* part_acc, void* out,
                                int B, int S, int H, int KVH, int hd,
                                int nsplit, int chunk, int dtype,
                                void* stream) {
  using namespace repro_torch;
  if (B <= 0 || S <= 0 || KVH <= 0 || H % KVH || nsplit <= 0 ||
      chunk <= 0 || (long long)(nsplit - 1) * chunk >= S ||
      (long long)nsplit * chunk < S)
    return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)hd));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pacc = static_cast<float*>(part_acc);
  int err;
  if (dtype == 0)
    err = dispatch<float>(q, k, v, valid, pm, pl, pacc, out, B, S, H, KVH, hd, nsplit, chunk, scale, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(q, k, v, valid, pm, pl, pacc, out, B, S, H, KVH, hd, nsplit, chunk, scale, st);
  else
    err = (int)cudaErrorInvalidValue;
  if (err) return err;
  return (int)cudaGetLastError();
}
