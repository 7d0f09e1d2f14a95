// decode_attention — one-query GQA attention over a masked KV cache.
//
// Replaces the Pallas TPU kernel decode_attention_kernel / _decode_kernel
// (src/repro/kernels/decode_attention/decode_attention.py:21-92).
//
// q (B,1,H,hd); k, v (B,S,KVH,hd), or in the paged mode one layer's page
// pools (num_pages, page_size, KVH, hd) and a page table (B, S/page_size)
// of int64 page ids; valid (B,S) bool, any pattern; out (B,1,H,hd) in the
// dtype of q. Scores are fp32, scaled by hd^-0.5; query
// head h reads KV head h / (H/KVH). A masked key weighs exactly 0, as
// exp(-1e30 - m) does in the reference; a row with no valid key at all
// gives the uniform average of its S values, as the reference's scores of
// -1e30 everywhere do.
//
// Bound on an H100: bytes. The call must read q, the K and V rows of the
// valid keys and the valid mask once and write out: 4*(H/KVH) FLOPs per
// K/V element, tens of FLOPs per byte against the tensor cores' ~295
// FLOP/byte ridge. Design, one launch:
//  * Blocks: one per (S split, batch, KV head, group of up to 16 query
//    heads). The group is the M of the tensor-core tile, so each K/V row
//    leaves device memory once for every query head that reads it (G of
//    4, 7 and 16 in the repo's models; a larger group loops over groups of
//    16). The splits of one (batch, KV head, group) form a thread block
//    cluster of at most 8 blocks, chosen by the wrapper so that the blocks
//    come to about two per SM of the 132.
//  * No reads of masked keys: a block first reads the valid bytes of its
//    split (a ballot a warp, 32 keys at a time) into a bit mask, lists the
//    tiles of BK keys that hold a valid key, and copies only those tiles,
//    and within them only the valid rows; the other rows are filled with
//    zeros in shared memory without a read. A masked key's weight is set
//    to 0 from the mask, never computed from a score.
//  * Asynchronous copies: the listed K/V tiles stream through a ring of
//    shared-memory stages with 16-byte cp.async.cg copies (rows padded by
//    16 bytes, so ldmatrix reads no bank twice), the copies of the next
//    stages in flight while the warps compute on this one. The ring is as
//    deep as leaves room for two blocks an SM (3 stages at hd 128, 2 at
//    hd 160), or else fills one block's share (3 at hd 256): at decode
//    sizes a block streams only a few tiles, so the copies' latency, not
//    the memory's rate, sets its time.
//  * bf16 route, tensor cores: each of the BK/16 warps owns 16 keys of a
//    tile. S = Q K^T is mma.m16n8k16 (bf16 in, fp32 sums) with the group's
//    query heads as the 16 rows (zeros past the group) over hd/16 steps;
//    the online softmax runs once a tile on the fp32 fragment (row max and
//    sum over the quad, exp2 with scale*log2(e) folded in); P is rounded
//    to bf16 as the A fragment of O += P V, V read with ldmatrix.trans.
//    The one numerical departure, as in flash_wgmma: P in bf16 for P V
//    (l sums the fp32 P); the plain version keeps P in fp32.
//  * fp32 route, FP32 cores: the same blocks, tiles, masks and fragment
//    ownership, with the products as FMAs (TF32 would miss the 1e-4 bar).
//  * Merge in the cluster: each block folds its warps' (m, l, O) into one
//    in shared memory; after a cluster barrier each block merges a slice
//    of the output over all the splits' states through distributed shared
//    memory and writes it. No scratch in device memory, no second launch.
//  * A row with no valid key: the blocks find it from each other's flags
//    after that barrier, and then take a pass of their own that reads only
//    V (every score 0, every weight 1) before they merge.
//  * Addressing, a compile-time mode (PAGED): dense, key j of batch row b
//    lies at row b*S + j of k and v; paged, at row page_table[b, j / ps] *
//    ps + j % ps of the layer's pool (ps the page size). A paged block
//    copies its split's page ids into shared memory once, before its
//    tiles, and only a row's address differs: the blocks, clusters,
//    splits, masks, copies, products and merge are the same code, so the
//    paged call gives bit for bit what the dense call gives on the
//    gathered per-row view at the same (nsplit, chunk). The continuous
//    engine's decode round reads its page pool so, and materialises no
//    per-slot view of the cache.
#include <cooperative_groups.h>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace {

namespace cg = cooperative_groups;
using namespace hopper;

constexpr int BK = 64;            // keys per K/V tile
constexpr int NW = BK / 16;       // warps; each owns 16 keys of a tile
constexpr int NT = NW * 32;       // threads per block
constexpr int GM = 16;            // query heads per block (the mma's M)
constexpr int MAX_STAGES = 4;     // ring depth, at most
// Shared memory for the ring: as many stages as leave room for two blocks
// an SM, or where fewer than two fit so, as many as fit one block an SM.
constexpr int PAIR_BUDGET = 105 * 1024;
constexpr int SOLO_BUDGET = 200 * 1024;
constexpr int WT = 64;            // tiles per mask window
constexpr bool SKIP_MASKED = true;   // copy only tiles and rows that hold
                                     // a valid key
constexpr int MAX_SPLITS = 8;     // blocks per cluster (portable limit)
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may have

template <typename T, int HD>
struct Cfg {
  static constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int ROW = HD * (int)sizeof(T) + 16;  // padded smem row
  static constexpr int CHUNKS = HD * (int)sizeof(T) / 16;  // 16 B a row
  static constexpr int TILE = BK * ROW;                 // one K or V tile
  static constexpr int FIT2 = PAIR_BUDGET / (2 * TILE);
  static constexpr int FIT = FIT2 >= 2 ? FIT2 : SOLO_BUDGET / (2 * TILE);
  static constexpr int STAGES = FIT < 1 ? 1 : FIT > MAX_STAGES ? MAX_STAGES
                                                                : FIT;
  static constexpr int RING = STAGES * 2 * TILE;
  static constexpr int STATE = GM * HD + 2 * GM;        // O, m, l (floats)
  static constexpr int WROW = HD + 8;   // a warp's O row in floats, padded
  static constexpr int WSTATE = GM * WROW + 2 * GM;     // a warp's state
  // after a pass the ring holds the warps' states, then the block's state
  static constexpr int MERGE = (NW * WSTATE + STATE) * 4;
  static constexpr int SCRATCH = RING > MERGE ? RING : MERGE;
  static constexpr int Q_BYTES = GM * ROW;
  static constexpr int P_BYTES = BF16 ? 0 : NW * GM * 16 * 4;
  static constexpr int WORDS = WT * BK / 32;            // mask bits a window
  static constexpr int SMEM = SCRATCH + Q_BYTES + P_BYTES + WORDS * 4 +
                              WT * 4 + 16;
  static_assert(HD % 16 == 0 && CHUNKS * 16 == HD * (int)sizeof(T),
                "head dim");
};

// Where a block's pieces sit in shared memory, and what it works on.
template <typename T, int HD, bool PAGED>
struct Ctx {
  using C = Cfg<T, HD>;
  uint8_t* ring;     // K/V stages; after a pass, the warps' states
  uint8_t* sq;       // Q rows, zeros past the group
  float* part;       // in the ring past the warps' states: the block's
                     // merged state O[GM][HD], m[GM], l[GM]
  float* sp;         // fp32 route: P of each warp, [NW][GM][16]
  uint32_t* bits;    // valid bits of the current window
  int* list;         // its tiles that hold a valid key
  int* flag;         // three ints
  const T* k;        // rows of this KV head: dense, the batch row's, key
  const T* v;        // j at k + j*kstride; paged, the pool's (row_offset)
  const uint8_t* valid;   // the batch row's mask
  const int* pages;  // paged: the split's page ids, from page p0 on
  size_t kstride;
  int lo, hi;        // the split's keys
  int ps, p0;        // paged: the page size, the split's first page,
  int ps_shift;      // and j / ps as (umulhi(j, ps_magic) + j) >> ps_shift
  unsigned ps_magic; // (Granlund-Montgomery, exact for 0 <= j < 2^31)
  float scale_log2;

  __device__ uint32_t k_stage(int s) const {
    return smem_addr(ring) + s * 2 * C::TILE;
  }
  __device__ uint32_t v_stage(int s) const {
    return k_stage(s) + C::TILE;
  }
};

// Offset of key j's row from c.k and c.v, in elements. The paged mode
// divides by the page size with a multiply and a shift: the copies wait
// on the address, and with a division the paged mode took 19% longer than
// the dense one at 256 rows of 2304 keys, with this 6%.
template <typename T, int HD, bool PAGED>
__device__ __forceinline__ size_t row_offset(const Ctx<T, HD, PAGED>& c,
                                             int j) {
  if constexpr (PAGED) {
    const int page = (__umulhi((unsigned)j, c.ps_magic) + j) >> c.ps_shift;
    return ((size_t)c.pages[page - c.p0] * c.ps + (j - page * c.ps)) *
           c.kstride;
  } else {
    return (size_t)j * c.kstride;
  }
}

// Valid bits of keys [w0, w0 + WT*BK) within the split into bits[] (all
// keys of the split when `uniform`), the tiles holding one into list[]
// (every tile without SKIP_MASKED); returns the length of the list, the
// same in every thread, and sets `hit` if a bit is set.
template <typename T, int HD, bool PAGED>
__device__ int build_window(const Ctx<T, HD, PAGED>& c, int w0, bool uniform,
                            bool& hit) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int span = min(c.hi - w0, WT * BK);      // keys of this window
  const int tiles = (span + BK - 1) / BK;
  for (int i = warp; i < tiles * (BK / 32); i += NW) {
    const int j = i * 32 + lane;
    const bool on = j < span && (uniform || c.valid[w0 + j] != 0);
    const uint32_t word = __ballot_sync(0xffffffffu, on);
    if (lane == 0) c.bits[i] = word;
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    bool seen = false;
    for (int t0 = 0; t0 < tiles; t0 += 32) {
      const int t = t0 + lane;
      uint32_t bits = 0;
      if (t < tiles)
#pragma unroll
        for (int w = 0; w < BK / 32; ++w) bits |= c.bits[t * (BK / 32) + w];
      seen |= __any_sync(0xffffffffu, bits != 0);
      const bool keep = t < tiles && (bits != 0 || !SKIP_MASKED);
      const uint32_t ball = __ballot_sync(0xffffffffu, keep);
      if (keep) c.list[n + __popc(ball & ((1u << lane) - 1))] = t;
      n += __popc(ball);
    }
    if (lane == 0) {
      c.flag[1] = n;
      c.flag[2] = seen;
    }
  }
  __syncthreads();
  hit |= c.flag[2] != 0;
  return c.flag[1];
}

// Copies of tile t of the window at w0 into stage s: the rows whose valid
// bit is set (every row of the split without SKIP_MASKED), zeros elsewhere;
// V only in the uniform pass.
template <typename T, int HD, bool PAGED>
__device__ void issue_tile(const Ctx<T, HD, PAGED>& c, int w0, int t, int s,
                           bool uniform) {
  using C = Cfg<T, HD>;
  const int key0 = w0 + t * BK;
  const uint32_t ks = c.k_stage(s), vs = c.v_stage(s);
  for (int i = threadIdx.x; i < BK * C::CHUNKS; i += NT) {
    const int r = i / C::CHUNKS, ch = i % C::CHUNKS;
    const int bit = t * BK + r;
    const bool on = SKIP_MASKED
                        ? (c.bits[bit / 32] >> (bit % 32)) & 1u
                        : key0 + r < c.hi;
    const size_t off = on ? row_offset(c, key0 + r) : 0;
    const uint32_t dst = r * C::ROW + ch * 16;
    if (!uniform)
      cp_async16(ks + dst, reinterpret_cast<const uint8_t*>(c.k + off) +
                               ch * 16, on ? 16 : 0);
    cp_async16(vs + dst, reinterpret_cast<const uint8_t*>(c.v + off) +
                             ch * 16, on ? 16 : 0);
  }
}

// One warp's 16 keys of a tile: scores into s[j][e] (rows lane/4 and
// lane/4 + 8, keys 8j + 2(lane%4) + e%2 of the warp's 16), unscaled.
template <int HD, bool PAGED>
__device__ __forceinline__ void scores(
    const Ctx<__nv_bfloat16, HD, PAGED>& c, int s, float (&sc)[2][4]) {
  using C = Cfg<__nv_bfloat16, HD>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint32_t qa = smem_addr(c.sq) +
                      ((lane % 8) + 8 * ((lane / 8) % 2)) * C::ROW +
                      16 * (lane / 16);
  const uint32_t ka = c.k_stage(s) +
                      (warp * 16 + (lane % 8) + 8 * (lane / 16)) * C::ROW +
                      16 * ((lane / 8) % 2);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4], b[4];
    ldmatrix_x4(a, qa + kk * 32);
    ldmatrix_x4(b, ka + kk * 32);
    mma_bf16_16816(sc[0], a, b[0], b[1]);
    mma_bf16_16816(sc[1], a, b[2], b[3]);
  }
}

template <int HD, bool PAGED>
__device__ __forceinline__ void scores(const Ctx<float, HD, PAGED>& c, int s,
                                       float (&sc)[2][4]) {
  using C = Cfg<float, HD>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* q0 = reinterpret_cast<const float*>(c.sq + (lane / 4) *
                                                   C::ROW);
  const float* q1 = reinterpret_cast<const float*>(c.sq + (lane / 4 + 8) *
                                                   C::ROW);
  const float* kr[2][2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      kr[j][e] = reinterpret_cast<const float*>(
          c.ring + s * 2 * C::TILE +
          (warp * 16 + 8 * j + 2 * (lane % 4) + e) * C::ROW);
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    const float4 a0 = *reinterpret_cast<const float4*>(q0 + d);
    const float4 a1 = *reinterpret_cast<const float4*>(q1 + d);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 kv = *reinterpret_cast<const float4*>(kr[j][e] + d);
        sc[j][e] += a0.x * kv.x + a0.y * kv.y + a0.z * kv.z + a0.w * kv.w;
        sc[j][2 + e] += a1.x * kv.x + a1.y * kv.y + a1.z * kv.z +
                        a1.w * kv.w;
      }
  }
}

// O += P V for one warp's 16 keys; p as the score fragment.
template <int HD, bool PAGED>
__device__ __forceinline__ void accumulate(
    const Ctx<__nv_bfloat16, HD, PAGED>& c, int s, const float (&p)[2][4],
    float (&o)[HD / 8][4]) {
  using C = Cfg<__nv_bfloat16, HD>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]),
                          pack_bf16(p[0][2], p[0][3]),
                          pack_bf16(p[1][0], p[1][1]),
                          pack_bf16(p[1][2], p[1][3])};
  const uint32_t va = c.v_stage(s) +
                      (warp * 16 + (lane % 8) + 8 * ((lane / 8) % 2)) *
                          C::ROW +
                      16 * (lane / 16);
#pragma unroll
  for (int np = 0; np < HD / 16; ++np) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, va + np * 32);
    mma_bf16_16816(o[2 * np], pa, b[0], b[1]);
    mma_bf16_16816(o[2 * np + 1], pa, b[2], b[3]);
  }
}

template <int HD, bool PAGED>
__device__ __forceinline__ void accumulate(const Ctx<float, HD, PAGED>& c,
                                           int s, const float (&p)[2][4],
                                           float (&o)[HD / 8][4]) {
  using C = Cfg<float, HD>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = lane / 4, col = 2 * (lane % 4);
  float* sp = c.sp + warp * GM * 16;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sp[(r0 + 8 * (e / 2)) * 16 + 8 * j + col + e % 2] = p[j][e];
  __syncwarp();
  const uint8_t* vs = c.ring + s * 2 * C::TILE + C::TILE +
                      warp * 16 * C::ROW;
#pragma unroll 4
  for (int kk = 0; kk < 16; ++kk) {
    const float p0 = sp[r0 * 16 + kk], p1 = sp[(r0 + 8) * 16 + kk];
    const float* vr = reinterpret_cast<const float*>(vs + kk * C::ROW);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const float2 vv = *reinterpret_cast<const float2*>(vr + 8 * n + col);
      o[n][0] = fmaf(p0, vv.x, o[n][0]);
      o[n][1] = fmaf(p0, vv.y, o[n][1]);
      o[n][2] = fmaf(p1, vv.x, o[n][2]);
      o[n][3] = fmaf(p1, vv.y, o[n][3]);
    }
  }
  __syncwarp();
}

// One pass over the split: each warp's online softmax (m, l per row of
// its fragment, l this thread's share) and O, then the warps' states
// folded into c.part. `uniform`: every key of the split weighs 1 and only
// V is read. Returns whether the split holds a valid key.
template <typename T, int HD, bool PAGED>
__device__ bool run_pass(const Ctx<T, HD, PAGED>& c, bool uniform) {
  using C = Cfg<T, HD>;
  constexpr int STAGES = C::STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  bool any = false;

  for (int w0 = c.lo; w0 < c.hi; w0 += WT * BK) {
    const int n = build_window(c, w0, uniform, any);
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
      if (i < n) issue_tile(c, w0, c.list[i], i, uniform);
      cp_async_commit();
    }
    for (int i = 0; i < n; ++i) {
      const int nxt = i + STAGES - 1;
      if (nxt < n) issue_tile(c, w0, c.list[nxt], nxt % STAGES, uniform);
      cp_async_commit();
      cp_async_wait<STAGES - 1>();
      __syncthreads();
      const int t = c.list[i], s = i % STAGES;
      const int bit0 = t * BK + warp * 16;
      const uint32_t wb = (c.bits[bit0 / 32] >> (bit0 % 32)) & 0xffffu;
      if (wb) {                               // uniform over the warp
        float sc[2][4] = {};
        if (!uniform) scores(c, s, sc);
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool on = (wb >> (8 * j + 2 * (lane % 4) + e % 2)) & 1u;
            sc[j][e] = on ? sc[j][e] * c.scale_log2 : NEG_INF;
            mx[e / 2] = fmaxf(mx[e / 2], sc[j][e]);
          }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = fmaxf(m[r], quad_max(mx[r]));
          alpha[r] = fast_exp2(m[r] - m_new);
          m[r] = m_new;
          l[r] *= alpha[r];
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // a masked key weighs 0 from its bit, whatever m is
            const float p = sc[j][e] == NEG_INF
                                ? 0.f
                                : fast_exp2(sc[j][e] - m[e / 2]);
            sc[j][e] = p;
            l[e / 2] += p;
          }
#pragma unroll
        for (int nn = 0; nn < HD / 8; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[nn][e] *= alpha[e / 2];
        accumulate(c, s, sc, o);
      }
      __syncthreads();                        // stage s is free again
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // each warp's state into the ring, then folded into c.part: a thread
  // per (row, 4 columns), the warps' m and l read once a row
  float* ws = reinterpret_cast<float*>(c.ring) + warp * C::WSTATE;
  const int r0 = lane / 4, col = 2 * (lane % 4);
#pragma unroll
  for (int nn = 0; nn < HD / 8; ++nn)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(ws + (r0 + 8 * r) * C::WROW + 8 * nn +
                                 col) = make_float2(o[nn][2 * r],
                                                    o[nn][2 * r + 1]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float ls = quad_sum(l[r]);
    if (lane % 4 == 0) {
      ws[GM * C::WROW + r0 + 8 * r] = m[r];
      ws[GM * C::WROW + GM + r0 + 8 * r] = ls;
    }
  }
  __syncthreads();
  const float* st = reinterpret_cast<const float*>(c.ring);
  for (int i = threadIdx.x; i < GM * HD / 4; i += NT) {
    const int row = i / (HD / 4), c4 = i % (HD / 4) * 4;
    float mw[NW], mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      mw[w] = st[w * C::WSTATE + GM * C::WROW + row];
      mx = fmaxf(mx, mw[w]);
    }
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    float ls = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = fast_exp2(mw[w] - mx);
      const float4 x = *reinterpret_cast<const float4*>(
          st + w * C::WSTATE + row * C::WROW + c4);
      a.x += x.x * f;
      a.y += x.y * f;
      a.z += x.z * f;
      a.w += x.w * f;
      ls += st[w * C::WSTATE + GM * C::WROW + GM + row] * f;
    }
    *reinterpret_cast<float4*>(c.part + row * HD + c4) = a;
    if (c4 == 0) {
      c.part[GM * HD + row] = mx;
      c.part[GM * HD + GM + row] = ls;
    }
  }
  return any;
}

template <typename T, int HD, bool PAGED>
__global__ void __launch_bounds__(NT)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const uint8_t* __restrict__ valid,
              const long long* __restrict__ table, T* __restrict__ out,
              int S, int H, int KVH, int chunk, int ps, float scale_log2) {
  using C = Cfg<T, HD>;
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, nsplit = gridDim.x;   // the cluster's rank
  const int b = blockIdx.z;
  const int G = H / KVH, ngroups = (G + GM - 1) / GM;
  const int kvh = blockIdx.y / ngroups, grp = blockIdx.y % ngroups;
  const int h0 = kvh * G + grp * GM, ng = min(GM, G - grp * GM);

  Ctx<T, HD, PAGED> c;
  c.ring = smem;
  c.sq = smem + C::SCRATCH;
  c.part = reinterpret_cast<float*>(smem) + NW * C::WSTATE;
  c.sp = reinterpret_cast<float*>(c.sq + C::Q_BYTES);
  c.bits = reinterpret_cast<uint32_t*>(reinterpret_cast<uint8_t*>(c.sp) +
                                       C::P_BYTES);
  c.list = reinterpret_cast<int*>(c.bits + C::WORDS);
  c.flag = c.list + WT;   // [0] the split holds a valid key, [1] [2]
                          // build_window's list length and hit
  c.kstride = (size_t)KVH * HD;
  c.valid = valid + (size_t)b * S;
  c.lo = split * chunk;
  c.hi = min(S, c.lo + chunk);
  c.scale_log2 = scale_log2;
  if constexpr (PAGED) {
    // the split's page ids past the block's other pieces; build_window's
    // barrier orders these writes before the first tile's copies
    c.k = k + (size_t)kvh * HD;
    c.v = v + (size_t)kvh * HD;
    c.ps = ps;
    c.p0 = c.lo / ps;
    c.ps_shift = 0;
    while ((1 << c.ps_shift) < ps) ++c.ps_shift;
    c.ps_magic = (unsigned)(((1ull << 32) * ((1ull << c.ps_shift) - ps)) /
                                ps + 1);
    int* pages = reinterpret_cast<int*>(smem + C::SMEM);
    const long long* row = table + (size_t)b * (S / ps);
    for (int i = threadIdx.x; i <= (c.hi - 1) / ps - c.p0; i += NT)
      pages[i] = (int)row[c.p0 + i];
    c.pages = pages;
  } else {
    c.k = k + (size_t)b * S * c.kstride + (size_t)kvh * HD;
    c.v = v + (size_t)b * S * c.kstride + (size_t)kvh * HD;
  }

  // the group's query rows, zeros past it (the oldest copy group)
  for (int i = threadIdx.x; i < GM * C::CHUNKS; i += NT) {
    const int r = i / C::CHUNKS, ch = i % C::CHUNKS;
    const bool on = r < ng;
    const T* src = q + (on ? ((size_t)b * H + h0 + r) * HD : 0);
    cp_async16(smem_addr(c.sq) + r * C::ROW + ch * 16,
               reinterpret_cast<const uint8_t*>(src) + ch * 16,
               on ? 16 : 0);
  }
  cp_async_commit();

  const bool any = run_pass(c, false);
  if (threadIdx.x == 0) c.flag[0] = any;
  cluster.sync();                 // states and flags visible to the cluster
  bool row_any = false;
  for (int r = 0; r < nsplit; ++r)
    row_any |= *cluster.map_shared_rank(c.flag, r) != 0;
  if (!row_any) {                 // the same in every block of the cluster
    run_pass(c, true);
    cluster.sync();
  }

  // this block's slice of the output, merged over the splits: a thread
  // per (row, 4 columns), every split's m, l and O loaded at once
  for (int i = split * NT + threadIdx.x; i < ng * HD / 4;
       i += nsplit * NT) {
    const int row = i / (HD / 4), c4 = i % (HD / 4) * 4;
    float mr[MAX_SPLITS], lr[MAX_SPLITS], mx = NEG_INF;
    float4 xr[MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < nsplit) {
        const float* p = cluster.map_shared_rank(c.part, r);
        mr[r] = p[GM * HD + row];
        lr[r] = p[GM * HD + GM + row];
        xr[r] = *reinterpret_cast<const float4*>(p + row * HD + c4);
      }
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < nsplit) mx = fmaxf(mx, mr[r]);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    float ls = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < nsplit) {
        const float f = fast_exp2(mr[r] - mx);
        a.x += xr[r].x * f;
        a.y += xr[r].y * f;
        a.z += xr[r].z * f;
        a.w += xr[r].w * f;
        ls += lr[r] * f;
      }
    const float inv = 1.f / fmaxf(ls, 1e-30f);
    T* o = out + ((size_t)b * H + h0 + row) * HD + c4;
    o[0] = from_float<T>(a.x * inv);
    o[1] = from_float<T>(a.y * inv);
    o[2] = from_float<T>(a.z * inv);
    o[3] = from_float<T>(a.w * inv);
  }
  cluster.sync();                 // no block leaves while others read it
}

template <typename T, int HD, bool PAGED>
int launch(const void* q, const void* k, const void* v, const void* valid,
           const void* table, void* out, int B, int S, int H, int KVH,
           int ps, int nsplit, int chunk, float scale_log2,
           cudaStream_t st) {
  using C = Cfg<T, HD>;
  // the paged mode's page ids come past the other pieces, at most
  // chunk / ps + 2 of them for a split of chunk keys; as that varies, the
  // paged mode is allowed the most a block may have, and a launch past
  // that is refused
  const int smem = C::SMEM + (PAGED ? (chunk / ps + 2) * 4 : 0);
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_kernel<T, HD, PAGED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      PAGED ? MAX_SMEM : C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const int ngroups = (H / KVH + GM - 1) / GM;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, KVH * ngroups, B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = nsplit;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(
      &cfg, decode_kernel<T, HD, PAGED>, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(valid),
      static_cast<const long long*>(table), static_cast<T*>(out), S, H, KVH,
      chunk, ps, scale_log2);
}

template <typename T, bool PAGED>
int dispatch(const void* q, const void* k, const void* v, const void* valid,
             const void* table, void* out, int B, int S, int H, int KVH,
             int hd, int ps, int nsplit, int chunk, float scale_log2,
             cudaStream_t st) {
  switch (hd) {
    case 32: return launch<T, 32, PAGED>(q, k, v, valid, table, out, B, S, H, KVH, ps, nsplit, chunk, scale_log2, st);
    case 64: return launch<T, 64, PAGED>(q, k, v, valid, table, out, B, S, H, KVH, ps, nsplit, chunk, scale_log2, st);
    case 128: return launch<T, 128, PAGED>(q, k, v, valid, table, out, B, S, H, KVH, ps, nsplit, chunk, scale_log2, st);
    case 160: return launch<T, 160, PAGED>(q, k, v, valid, table, out, B, S, H, KVH, ps, nsplit, chunk, scale_log2, st);
    case 256: return launch<T, 256, PAGED>(q, k, v, valid, table, out, B, S, H, KVH, ps, nsplit, chunk, scale_log2, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Both C entries: the checks on the split, then the launch by dtype.
template <bool PAGED>
int entry(const void* q, const void* k, const void* v, const void* valid,
          const void* table, void* out, int B, int S, int H, int KVH, int hd,
          int ps, int nsplit, int chunk, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || KVH <= 0 || H % KVH || nsplit <= 0 ||
      nsplit > MAX_SPLITS || chunk <= 0 ||
      (long long)(nsplit - 1) * chunk >= S ||
      (long long)nsplit * chunk < S || (PAGED && (ps <= 0 || S % ps)))
    return (int)cudaErrorInvalidValue;
  const float scale_log2 =
      (float)(1.4426950408889634 / sqrt((double)hd));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0)
    err = dispatch<float, PAGED>(q, k, v, valid, table, out, B, S, H, KVH, hd, ps, nsplit, chunk, scale_log2, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16, PAGED>(q, k, v, valid, table, out, B, S, H, KVH, hd, ps, nsplit, chunk, scale_log2, st);
  else
    err = (int)cudaErrorInvalidValue;
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// Split s covers keys [s*chunk, min(S, (s+1)*chunk)); every split holds at
// least one key, and the nsplit <= 8 splits of a (batch, KV head, group)
// run as one cluster. dtype: 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a shape
// or dtype it does not take).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* valid, void* out, int B, int S,
                                int H, int KVH, int hd, int nsplit,
                                int chunk, int dtype, void* stream) {
  return repro_torch::entry<false>(q, k, v, valid, nullptr, out, B, S, H,
                                   KVH, hd, 0, nsplit, chunk, dtype, stream);
}

// The same over one layer's page pools k, v (num_pages, page_size, KVH,
// hd): key j of row b at page table[b, j / page_size] (int64, B rows of
// S / page_size pages), row j % page_size. Every id in a row's table must
// name a page of the pool, masked keys' too.
extern "C" int paged_decode_attention(const void* q, const void* k,
                                      const void* v, const void* table,
                                      const void* valid, void* out, int B,
                                      int S, int H, int KVH, int hd,
                                      int page_size, int nsplit, int chunk,
                                      int dtype, void* stream) {
  return repro_torch::entry<true>(q, k, v, valid, table, out, B, S, H, KVH,
                                  hd, page_size, nsplit, chunk, dtype,
                                  stream);
}
