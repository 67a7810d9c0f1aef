// Paged attention over the KV page pool, written by hand for Hopper
// (sm_90a): the one-token decode walk and the chunked-prefill walk, over a
// bf16 pool or a quantized one (int8, or int4 packed two per byte along
// hd, with an fp32 scale per page slot and kv head).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/paged_attention.py:
//   paged_decode_bf16   <- paged_attention_fwd (_paged_kernel,
//                          _block_update)
//   paged_prefill_bf16  <- paged_prefill_fwd (_paged_prefill_kernel,
//                          _prefill_qpos)
//   paged_decode_quant  <- paged_attention_quant_fwd (_paged_quant_kernel)
//   paged_prefill_quant <- paged_prefill_quant_fwd
//                          (_paged_prefill_quant_kernel)
//
// What bounds them on this card. Decode: the bytes of the live K/V pages
// over the 3.35 TB/s of device memory (page*hd*2 bytes of K and as many of
// V per page and kv head in bf16; hd or hd/2 bytes of codes per slot, plus
// 4 bytes of scale each, in a quantized pool). It does 4*G flops per K/V
// element, far below the card's ~295 flop/byte ridge. Prefill: the
// operations, 4*hd flops per valid (query head, key) pair, about 800 flops
// per byte for a 4096-row chunk, so the tensor cores' rate.
//
// Decode: split over blocks, then combine ("flash-decoding"). A walk of
// one (sequence, kv head) pair is a few hundred KB of K/V; one CTA per pair
// (32 CTAs at B = 8 on 132 SMs) cannot keep enough bytes in flight, so
//   * paged_decode_split_kernel, grid (B, K*G/GC, n_split): CTA `split`
//     walks an equal contiguous share of its sequence's own 32-key tiles
//     [t_lo, t_hi] (the blocks [lo, hi] the query needs, from positions[b],
//     window and n_blocks, as the Pallas kernel's _block_range), for GC of
//     the kv head's G query heads (GC = 4, 2 or 1, the largest that
//     divides G; G/GC CTAs share a kv head otherwise). n_split comes from
//     the shapes alone (the wrapper's decode_splits), so the host never
//     reads positions;
//   * tiles stream through a three-stage cp.async ring, each stage 32 keys
//     of K and V (and their scales) gathered through the page table at
//     their stored width: two stages, up to 64 KB, in flight per CTA while
//     one is computed. Copies are coalesced (a warp's lanes take
//     consecutive 16-B pieces of a row) and each thread reads its rows'
//     page ids a tile ahead (TileCopy), so no table read stalls a copy.
//     Key j of the walk lies in block j / page at offset j % page, for
//     any page: a tile may hold several pages, part of one, or the end
//     of one page and the start of the next (page 48: keys 32-63 are
//     the last 16 of block 0 and the first 16 of block 1). Rows of a
//     tile whose block lies outside [lo, hi] are zero-filled, not read,
//     and their keys lie outside [k_lo, k_hi], so the key mask drops
//     them as well;
//   * each group of hd/8 lanes is a walker with its own keys of every
//     stage (256 threads; 128 at hd = 32, one 4-lane walker per key, 8 to
//     a warp, whose shuffles stay inside the walker's aligned lanes) and
//     its own fp32 online-softmax state (m, l, acc) in
//     registers: a lane holds 8 hd elements of q and of acc per query
//     head, reads 8 elements of a key with one 16-B (bf16), 8-B (int8) or
//     4-B (int4) load, dequantizes in registers (the scale multiplies the
//     reduced score and the weight p, not each element) and reduces the
//     dot product with __shfl_xor_sync. Walkers merge once, at the end of
//     the split, into fp32 partials (m, l, acc[GC, hd]);
//   * paged_decode_combine_kernel, grid (B, H), merges a head's partials
//     in split order (deterministic, no atomics):
//     out = sum_i e^{m_i - M} acc_i / max(sum_i e^{m_i - M} l_i, 1e-30),
//     rounded to bf16. An empty split leaves (-1e30, 0, 0); a walker or
//     split whose keys were all masked carries the reference's exp(0)
//     weights, which the e^{m_i - M} factor wipes as the first valid
//     block's correction does in _block_update.
//
// Prefill: tensor cores, shaped like flash_attention.cu's kernel.
//   * paged_prefill_kernel, grid (B, K, row tiles): a CTA owns a 128-row
//     tile of the chunk's position-major fused rows r = s*G + g (position
//     positions[b] + s) of one kv head, 8 warps of 16 rows, the longest
//     walks launched first (blockIdx.z reversed);
//   * K/V stream through a two-stage cp.async ring of 64-key tiles
//     (gathered row by row through page_table[b] at their stored width,
//     whatever the page), over the tiles [lo, hi] that hold the blocks
//     the rows need (rounded outward to whole tiles), hi clamped to the
//     page-table width for a padded final chunk;
//   * both products run on mma.sync m16n8k16 bf16 with fp32 accumulators,
//     the (m, l, acc) state of each warp's 16 rows in registers; only kv
//     tiles that cross the diagonal, the window edge or the table's end
//     evaluate the mask;
//   * a quantized pool's codes (int8, and sign-extended int4, are exact in
//     bf16) are converted once per landed tile into one bf16 K and V tile
//     in shared memory, shared by the 8 warps; then q.k^T = k_scale[j] *
//     (q.code_j), the K scale and hd**-0.5 applied to the fp32 score
//     columns, and P.V = sum_j (p_j * v_scale[j]) code_j, the V scale
//     folded into P before P is rounded to bf16; l sums the unscaled
//     weights. Shared memory at hd = 256: q 66 KB, a bf16 ring 132 KB
//     (flash's 198 KB in all); int8 ring 65 KB plus the converted tiles
//     66 KB.
//
// Error budget (prefill) against the plain version, which pre-scales q in
// fp32 and does every product in fp32: q.k is exact bf16 products summed
// in fp32 and scaled afterwards (an fp32 rounding of the score), and P (P
// times the V scale for a quantized pool) is rounded to bf16 once, up to
// 2**-9 of each weight, random in sign, before P.V; for a bf16 pool l sums
// the rounded weights, so the output stays a convex combination of v rows.
// These are flash_attention.cu's rounding points and stay inside the
// stated kernel tolerance, 2**-7 |ref| + 2**-7 (row max |ref|). Decode
// keeps the plain version's fp32 arithmetic (q pre-scaled in fp32) and
// differs only in summation order.
//
// Semantics kept exactly from the reference: softcap cap*tanh(s/cap)
// before the mask; masked scores -1e30 and m starting at -1e30 (never
// -inf); l clamped at 1e-30; blocks outside [lo, hi] skipped; page-table
// tails at scratch page 0 never read (they lie past hi); head h = k*G + g;
// the output rounded to bf16. Built for hd in {32, 64, 128, 256}; pages
// of any size from 1 key (a pool slot, page id * page + offset, is a
// 32-bit index: the wrapper refuses pools of 2**31 slots or more). wgmma
// and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr float kNeg = -1e30f;

// Page readers: the stored width of 8 hd elements (kBits bytes) and how
// they become numbers. load8 gives fp32 values (bf16) or codes (quantized,
// unscaled); a quantized reader's bf16x8 gives its 8 codes as bf16, which
// holds them exactly (the prefill's converted tiles).
struct Bf16Pool {
  static constexpr bool kQuant = false;
  static constexpr int kBits = 16;
  __device__ static void load8(const uint8_t* p, float* o) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

struct Int8Pool {
  static constexpr bool kQuant = true;
  static constexpr int kBits = 8;
  __device__ static void load8(const uint8_t* p, float* o) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = static_cast<float>(c[i]);
  }
  __device__ static uint4 bf16x8(const uint8_t* p) {
    float f[8];
    load8(p, f);
    return make_uint4(bf16x2(f[0], f[1]), bf16x2(f[2], f[3]),
                      bf16x2(f[4], f[5]), bf16x2(f[6], f[7]));
  }
};

// int4: element 2i is the low nibble of byte i, 2i+1 the high one, both
// sign-extended (kernels/ref.py::unpack_int4_hd).
struct Int4Pool {
  static constexpr bool kQuant = true;
  static constexpr int kBits = 4;
  __device__ static void load8(const uint8_t* p, float* o) {
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint8_t b = static_cast<uint8_t>(raw >> (8 * i));
      o[2 * i] = static_cast<float>(
          static_cast<int8_t>(static_cast<uint8_t>(b << 4)) >> 4);
      o[2 * i + 1] = static_cast<float>(static_cast<int8_t>(b) >> 4);
    }
  }
  __device__ static uint4 bf16x8(const uint8_t* p) {
    float f[8];
    load8(p, f);
    return make_uint4(bf16x2(f[0], f[1]), bf16x2(f[2], f[3]),
                      bf16x2(f[4], f[5]), bf16x2(f[6], f[7]));
  }
};

// Copies of one kv tile of kRows keys (their K and V rows of kRow stored
// bytes, kRowPitch apart in shared memory, and a quantized pool's K and V
// scales) gathered through the page table. Thread tid copies 16-B piece
// tid % kPieces of kPasses rows, kRowsPerPass apart, so the lanes of a
// warp cover consecutive pieces of a row (coalesced reads, conflict-free
// writes); it reads the page ids of its rows one tile ahead (fetch), into
// registers, so no table read stalls a copy. Rows outside the live blocks
// [lo, hi] are zero-filled and not read.
template <int kRows, int kThreads, int kRow, int kRowPitch, bool kQuant>
struct TileCopy {
  static constexpr int kPieces = kRow / 16;
  static constexpr int kRowsPerPass = kThreads / kPieces;
  static constexpr int kPasses =
      kRowsPerPass >= kRows ? 1 : kRows / kRowsPerPass;
  static_assert(kRow % 16 == 0 && kPieces <= kThreads, "tile copy");
  int row0, piece;
  bool active;
  // pool slots (page id * page + offset in the page) of the fetched tile's
  // rows, -1: not live
  int slot[kPasses];

  __device__ explicit TileCopy(int tid)
      : row0(tid / kPieces), piece(tid % kPieces),
        active(tid < kRows * kPieces) {}

  // slots of tile t's rows, keys t*kRows + row: block key / page at offset
  // key % page, so a tile may hold several pages, part of one, or the
  // ends of two (any page); any = false: none
  __device__ void fetch(const int* pt, int t, int page, int lo, int hi,
                        bool any) {
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int key = t * kRows + row0 + p * kRowsPerPass;
      const int blk = key / page;
      slot[p] = any && active && blk >= lo && blk <= hi
                    ? pt[blk] * page + key % page
                    : -1;
    }
  }

  // the fetched tile into stage (K rows, V rows, then the scales)
  __device__ void issue(uint8_t* ks, const uint8_t* pool_k,
                        const uint8_t* pool_v, const float* k_scale,
                        const float* v_scale, int K, int kh) const {
    if (!active) return;
    uint8_t* vs = ks + kRows * kRowPitch;
    float* sc = reinterpret_cast<float*>(vs + kRows * kRowPitch);
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int r = row0 + p * kRowsPerPass;
      const bool live = slot[p] >= 0;
      const size_t row = live ? (size_t)slot[p] * K + kh : 0;
      cp_async16(ks + r * kRowPitch + piece * 16,
                 pool_k + row * kRow + piece * 16, live);
      cp_async16(vs + r * kRowPitch + piece * 16,
                 pool_v + row * kRow + piece * 16, live);
      if (kQuant && piece == 0) {
        cp_async4(sc + r, k_scale + row, live);
        cp_async4(sc + kRows + r, v_scale + row, live);
      }
    }
  }
};

// ---------------------------------------------------------------- decode --
constexpr int kDecWarps = 8;
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kDecKeys = 32;     // keys per ring stage: the split's tile
constexpr int kDecStages = 3;
constexpr int kCombineThreads = 128;

template <class Pool, int HD, int GC>
struct DecodeLayout {
  static constexpr int kLanesPerKey = HD / 8;
  // one walker per key of a stage at most: 256 threads from hd = 64 up,
  // 128 (32 walkers of 4 lanes, 8 to a warp) at hd = 32
  static constexpr int kThreads =
      kDecKeys * kLanesPerKey < kDecThreads ? kDecKeys * kLanesPerKey
                                            : kDecThreads;
  static constexpr int kWalkers = kThreads / kLanesPerKey;
  static constexpr int kKeysPerWalker = kDecKeys / kWalkers;
  static constexpr int kRow = HD * Pool::kBits / 8;   // stored bytes a key
  static constexpr int kTile = kDecKeys * kRow;       // one K or V stage
  static constexpr int kStage =
      2 * kTile + (Pool::kQuant ? 2 * kDecKeys * 4 : 0);
  static constexpr int kRing = kDecStages * kStage;
  // after the walk the ring holds the walkers' acc, then their (m, l)
  static constexpr int kMerge = kWalkers * GC * (HD + 2) * 4;
  static constexpr int kBytes = kRing > kMerge ? kRing : kMerge;
  static_assert(kKeysPerWalker >= 1 && kRow % 16 == 0 && kStage % 16 == 0,
                "decode layout");
};

struct DecodeArgs {
  const __nv_bfloat16* q;   // (B, H, hd)
  const uint8_t* pool_k;    // (P, page, K, hd) bf16 or (P, page, K, hd_store)
  const uint8_t* pool_v;
  const float* k_scale;     // (P, page, K) fp32; null for a bf16 pool
  const float* v_scale;
  const int* page_table;    // (B, n_blocks)
  const int* positions;     // (B,) the query's absolute position
  float* part;              // (B, H, n_split, hd) acc, then (B, H, n_split, 2)
  __nv_bfloat16* out;       // (B, H, hd)
  int H, K, page, n_blocks, window, n_split;
  float cap, scale;
};

template <class Pool, int HD, int GC>
__global__ void __launch_bounds__(kDecThreads)
    paged_decode_split_kernel(const DecodeArgs a) {
  using L = DecodeLayout<Pool, HD, GC>;
  constexpr int LPK = L::kLanesPerKey, NW = L::kWalkers;
  constexpr int KPW = L::kKeysPerWalker, kRow = L::kRow;
  extern __shared__ __align__(16) uint8_t smem[];

  const int b = blockIdx.x, split = blockIdx.z;
  const int G = a.H / a.K, chunks = G / GC;
  const int kh = blockIdx.y / chunks;
  const int h0 = kh * G + (blockIdx.y % chunks) * GC;   // first query head
  const int tid = threadIdx.x;
  const int sl = tid % LPK;     // hd elements 8*sl .. 8*sl+7 of this lane
  const int w = tid / LPK;      // walker: LPK consecutive lanes of one warp

  // the keys the query sees, and the blocks and 32-key tiles that hold them
  const int page = a.page;
  const int pos = a.positions[b];
  const int k_hi = min(pos, a.n_blocks * page - 1);
  const int k_lo = a.window ? max(pos - a.window + 1, 0) : 0;
  const int hi = min(pos / page, a.n_blocks - 1);
  const int lo = a.window ? max((pos - a.window + 1) / page, 0) : 0;
  const int t_lo = lo * page / kDecKeys;
  const int n_t = lo <= hi ? (hi * page + page - 1) / kDecKeys - t_lo + 1 : 0;
  const int t0 = t_lo + static_cast<int>((long long)split * n_t / a.n_split);
  const int t1 =
      t_lo + static_cast<int>((long long)(split + 1) * n_t / a.n_split);
  const int* pt = a.page_table + (size_t)b * a.n_blocks;

  // one stage: 32 rows of K, 32 of V, then (quantized) their scales
  TileCopy<kDecKeys, L::kThreads, kRow, kRow, Pool::kQuant> copy(tid);
  auto issue = [&](int slot) {
    copy.issue(smem + slot * L::kStage, a.pool_k, a.pool_v, a.k_scale,
               a.v_scale, a.K, kh);
  };

  // q in fp32, pre-scaled by hd**-0.5 as the reference does
  float qr[GC][8];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    const uint4 raw = *reinterpret_cast<const uint4*>(
        a.q + ((size_t)b * a.H + h0 + g) * HD + 8 * sl);
    const __nv_bfloat162* hq = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(hq[i]);
      qr[g][2 * i] = f.x * a.scale;
      qr[g][2 * i + 1] = f.y * a.scale;
    }
  }
  float m[GC], l[GC], acc[GC][8];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = kNeg;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < kDecStages - 1; ++s) {
    if (t0 + s < t1) {
      copy.fetch(pt, t0 + s, page, lo, hi, true);
      issue(s);
    }
    cp_async_commit();
  }
  copy.fetch(pt, t0 + kDecStages - 1, page, lo, hi,
             t0 + kDecStages - 1 < t1);
  for (int t = t0; t < t1; ++t) {
    const int i = t - t0;
    cp_async_wait<kDecStages - 2>();   // tile t has landed
    __syncthreads();                   // ... and tile t-1's slot is free
    if (t + kDecStages - 1 < t1) issue((i + kDecStages - 1) % kDecStages);
    cp_async_commit();                 // possibly empty: one group per tile
    copy.fetch(pt, t + kDecStages, page, lo, hi, t + kDecStages < t1);
    const uint8_t* ks = smem + (i % kDecStages) * L::kStage;
    const uint8_t* vs = ks + L::kTile;
    const float* ksc = reinterpret_cast<const float*>(vs + L::kTile);
    const float* vsc = ksc + kDecKeys;

    // scores of this walker's KPW keys, every lane of the walker holding
    // each reduced score
    float s[KPW][GC];
#pragma unroll
    for (int u = 0; u < KPW; ++u) {
      const int j = w * KPW + u;
      float kf[8];
      Pool::load8(ks + j * kRow + sl * Pool::kBits, kf);
      const int key = t * kDecKeys + j;
      const bool valid = key >= k_lo && key <= k_hi;
      const float kscale = Pool::kQuant ? ksc[j] : 1.f;
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(qr[g][e], kf[e], d);
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, o);
        d *= kscale;
        if (a.cap > 0.f) d = a.cap * tanhf(d / a.cap);
        s[u][g] = valid ? d : kNeg;
      }
    }
    // online softmax over the batch
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < KPW; ++u) mx = fmaxf(mx, s[u][g]);
      const float corr = expf(m[g] - mx);
      m[g] = mx;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < KPW; ++u) {
        s[u][g] = expf(s[u][g] - mx);
        sum += s[u][g];
      }
      l[g] = l[g] * corr + sum;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= corr;
    }
#pragma unroll
    for (int u = 0; u < KPW; ++u) {
      const int j = w * KPW + u;
      float vf[8];
      Pool::load8(vs + j * kRow + sl * Pool::kBits, vf);
      const float vscale = Pool::kQuant ? vsc[j] : 1.f;
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        const float p = s[u][g] * vscale;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();   // the ring is free: it holds the merge now

  // merge the walkers: M = max m_w, f_w = e^{m_w - M}
  float* macc = reinterpret_cast<float*>(smem);   // [NW][GC][HD]
  float* mml = macc + NW * GC * HD;               // [NW][GC] (m, l)
  if (sl == 0) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      mml[2 * (w * GC + g)] = m[g];
      mml[2 * (w * GC + g) + 1] = l[g];
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    float M = kNeg;
    for (int v = 0; v < NW; ++v) M = fmaxf(M, mml[2 * (v * GC + g)]);
    const float f = expf(m[g] - M);
    float4* dst = reinterpret_cast<float4*>(macc + (w * GC + g) * HD + 8 * sl);
    dst[0] = make_float4(acc[g][0] * f, acc[g][1] * f, acc[g][2] * f,
                         acc[g][3] * f);
    dst[1] = make_float4(acc[g][4] * f, acc[g][5] * f, acc[g][6] * f,
                         acc[g][7] * f);
  }
  __syncthreads();
  for (int idx = tid; idx < GC * HD; idx += L::kThreads) {
    const int g = idx / HD, d = idx % HD;
    float sum = 0.f;
    for (int v = 0; v < NW; ++v) sum += macc[(v * GC + g) * HD + d];
    a.part[(((size_t)b * a.H + h0 + g) * a.n_split + split) * HD + d] = sum;
  }
  if (tid < GC) {
    const int g = tid;
    float M = kNeg, ls = 0.f;
    for (int v = 0; v < NW; ++v) M = fmaxf(M, mml[2 * (v * GC + g)]);
    for (int v = 0; v < NW; ++v)
      ls += mml[2 * (v * GC + g) + 1] * expf(mml[2 * (v * GC + g)] - M);
    float* ml = a.part + (size_t)gridDim.x * a.H * a.n_split * HD +
                (((size_t)b * a.H + h0 + g) * a.n_split + split) * 2;
    ml[0] = M;
    ml[1] = ls;
  }
}

// One CTA per (sequence, query head): merge its n_split partials in split
// order. Pool only names the kernel after the walk it finishes.
template <class Pool>
__global__ void __launch_bounds__(kCombineThreads)
    paged_decode_combine_kernel(const float* part, __nv_bfloat16* out, int H,
                                int hd, int n_split) {
  const int b = blockIdx.x, h = blockIdx.y;
  const size_t row = ((size_t)b * H + h) * n_split;
  const float* ml = part + (size_t)gridDim.x * H * n_split * hd + row * 2;
  float M = kNeg, ls = 0.f;
  for (int i = 0; i < n_split; ++i) M = fmaxf(M, ml[2 * i]);
  for (int i = 0; i < n_split; ++i) ls += ml[2 * i + 1] * expf(ml[2 * i] - M);
  const float den = fmaxf(ls, 1e-30f);
  for (int d = threadIdx.x; d < hd; d += kCombineThreads) {
    float sum = 0.f;
    for (int i = 0; i < n_split; ++i)
      sum += part[(row + i) * hd + d] * expf(ml[2 * i] - M);
    out[((size_t)b * H + h) * hd + d] = __float2bfloat16(sum / den);
  }
}

// --------------------------------------------------------------- prefill --
constexpr int kBN = 64;          // keys per kv tile
constexpr int kPWarps = 8;       // 16 query rows each
constexpr int kBM = 16 * kPWarps;
constexpr int kPThreads = 32 * kPWarps;
constexpr int kPad = 8;          // bf16 padding per shared bf16 row (16 B)

template <class Pool, int HD>
struct PrefillLayout {
  static constexpr int kPitch = HD + kPad;          // bf16 elements a row
  static constexpr int kQBytes = kBM * kPitch * 2;
  static constexpr int kRow = HD * Pool::kBits / 8;  // stored bytes a key
  // staged bytes a key: bf16 rows padded for the mma reads, codes as
  // stored (only the conversion reads them)
  static constexpr int kRowPitch = Pool::kQuant ? kRow : kPitch * 2;
  static constexpr int kTile = kBN * kRowPitch;
  static constexpr int kStage = 2 * kTile + (Pool::kQuant ? 2 * kBN * 4 : 0);
  static constexpr int kConv = Pool::kQuant ? 2 * kBN * kPitch * 2 : 0;
  static constexpr int kBytes = kQBytes + 2 * kStage + kConv;
  static_assert(kRow % 16 == 0 && kStage % 16 == 0, "prefill layout");
};

struct PrefillArgs {
  const __nv_bfloat16* q;   // (B, Sq, H, hd)
  const uint8_t* pool_k;
  const uint8_t* pool_v;
  const float* k_scale;
  const float* v_scale;
  const int* page_table;    // (B, n_blocks)
  const int* positions;     // (B,) each chunk's first position
  __nv_bfloat16* out;       // (B, Sq, H, hd)
  int Sq, H, K, page, n_blocks, window;
  float cap, scale;
};

// grid (B, K, row tiles), kPThreads threads. Fragment names follow the
// PTX m16n8k16 layouts: lane = 4*gid + tig; a C fragment holds rows gid
// and gid+8, columns 2*tig and 2*tig+1 of its 16x8 tile.
template <class Pool, int HD>
__global__ void __launch_bounds__(kPThreads, 1)
    paged_prefill_kernel(const PrefillArgs a) {
  using L = PrefillLayout<Pool, HD>;
  constexpr int P = L::kPitch;
  constexpr int kChunks = HD / 8;      // 8-element pieces of a row
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  uint8_t* ring = smem + L::kQBytes;
  __nv_bfloat16* conv =
      reinterpret_cast<__nv_bfloat16*>(ring + 2 * L::kStage);

  const int G = a.H / a.K;
  const int rows = a.Sq * G;                        // fused query rows
  const int b = blockIdx.x, kh = blockIdx.y;
  const int R0 = (gridDim.z - 1 - blockIdx.z) * kBM;  // longest walks first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;

  // blocks the rows need: the first row's window start to the last row's
  // own block, clamped to the page-table width (a padded final chunk may
  // run past it; its overflow rows are garbage by contract); then the
  // 64-key tiles that hold them
  const int page = a.page, T = a.n_blocks * page;
  const int pos0 = a.positions[b];
  const int q_first = pos0 + R0 / G;
  const int q_last = pos0 + (min(R0 + kBM, rows) - 1) / G;
  const int hi_blk = min(q_last / page, a.n_blocks - 1);
  const int lo_blk = a.window ? max((q_first - a.window + 1) / page, 0) : 0;
  const int lo = lo_blk * page / kBN;
  const int hi = lo_blk <= hi_blk ? (hi_blk * page + page - 1) / kBN : lo - 1;
  const int* pt = a.page_table + (size_t)b * a.n_blocks;

  for (int i = threadIdx.x; i < kBM * kChunks; i += kPThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const int R = R0 + r;
    const bool valid = R < rows;           // rows past Sq*G: zeros
    const size_t off =
        valid ? ((size_t)(b * a.Sq + R / G) * a.H + kh * G + R % G) * HD +
                    c * 8
              : 0;
    cp_async16(q_s + r * P + c * 8, a.q + off, valid);
  }
  // one stage: 64 rows of K, 64 of V, then (quantized) their scales
  TileCopy<kBN, kPThreads, L::kRow, L::kRowPitch, Pool::kQuant> copy(
      threadIdx.x);
  auto issue = [&](int st) {
    copy.issue(ring + st * L::kStage, a.pool_k, a.pool_v, a.k_scale,
               a.v_scale, a.K, kh);
  };

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  const int r_top = warp * 16 + gid;         // this thread's rows: r_top, +8
  const int qpos[2] = {pos0 + (R0 + r_top) / G, pos0 + (R0 + r_top + 8) / G};

  if (lo <= hi) {
    copy.fetch(pt, lo, page, lo_blk, hi_blk, true);
    issue(0);
  }
  cp_async_commit();
  copy.fetch(pt, lo + 1, page, lo_blk, hi_blk, lo + 1 <= hi);
  for (int j = lo; j <= hi; ++j) {
    const int st = (j - lo) & 1;
    cp_async_wait_all();
    __syncthreads();   // tile j landed; everyone is done with tile j-1
    if (j + 1 <= hi) {
      issue(st ^ 1);
      cp_async_commit();
    }
    copy.fetch(pt, j + 2, page, lo_blk, hi_blk, j + 2 <= hi);
    const uint8_t* kst = ring + st * L::kStage;
    const uint8_t* vst = kst + L::kTile;
    const float* ksc = reinterpret_cast<const float*>(vst + L::kTile);
    const float* vsc = ksc + kBN;
    const __nv_bfloat16* ks;
    const __nv_bfloat16* vs;
    if constexpr (Pool::kQuant) {
      // codes -> one bf16 K tile and one V tile for all 8 warps
      for (int i = threadIdx.x; i < 2 * kBN * kChunks; i += kPThreads) {
        const int t = i / (kBN * kChunks), rem = i % (kBN * kChunks);
        const int r = rem / kChunks, c = rem % kChunks;
        const uint8_t* src = (t ? vst : kst) + r * L::kRow + c * Pool::kBits;
        *reinterpret_cast<uint4*>(conv + (t * kBN + r) * P + c * 8) =
            Pool::bf16x8(src);
      }
      __syncthreads();
      ks = conv;
      vs = conv + kBN * P;
    } else {
      ks = reinterpret_cast<const __nv_bfloat16*>(kst);
      vs = reinterpret_cast<const __nv_bfloat16*>(vst);
    }

    // s = q k^T (q code^T) over hd, 16 rows x 64 keys per warp
    float s[kBN / 8][4];
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < HD; kk += 16) {
      const __nv_bfloat16* q0 = q_s + r_top * P + kk + 2 * tig;
      const uint32_t af[4] = {ld32(q0), ld32(q0 + 8 * P), ld32(q0 + 8),
                              ld32(q0 + 8 * P + 8)};
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n) {
        const __nv_bfloat16* k0 = ks + (n * 8 + gid) * P + kk + 2 * tig;
        mma_bf16(s[n], af, ld32(k0), ld32(k0 + 8));
      }
    }

    // scale (times the key's K scale), softcap, then the mask where this
    // tile crosses the diagonal, the window edge or the table's end
    const int k0 = j * kBN;
    const bool need_mask = k0 + kBN > T || k0 + kBN - 1 > q_first ||
                           (a.window && k0 <= q_last - a.window);
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = n * 8 + 2 * tig + (e & 1);
        float x = s[n][e] * (Pool::kQuant ? ksc[kc] * a.scale : a.scale);
        if (a.cap > 0.f) x = a.cap * tanhf(x / a.cap);
        if (need_mask) {
          const int key = k0 + kc;
          const int qp = qpos[e >> 1];
          bool valid = key < T && key <= qp;
          if (a.window) valid = valid && key > qp - a.window;
          if (!valid) x = kNeg;
        }
        s[n][e] = x;
      }
    }

    // online softmax: the row max over the quad that shares each row
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);
      corr[h] = expf(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= corr[h];
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // P in bf16 (times the V scale): two adjacent 8-key C fragments are one
    // A fragment
#pragma unroll
    for (int kt = 0; kt < kBN / 16; ++kt) {
      uint32_t pa[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* c = s[2 * kt + half];
        const float p0 = expf(c[0] - mx[0]), p1 = expf(c[1] - mx[0]);
        const float p2 = expf(c[2] - mx[1]), p3 = expf(c[3] - mx[1]);
        if constexpr (Pool::kQuant) {
          const int kc = kt * 16 + half * 8 + 2 * tig;
          const float v0 = vsc[kc], v1 = vsc[kc + 1];
          l[0] += p0 + p1;
          l[1] += p2 + p3;
          pa[2 * half] = bf16x2(p0 * v0, p1 * v1);
          pa[2 * half + 1] = bf16x2(p2 * v0, p3 * v1);
        } else {
          const __nv_bfloat162 p01 = __floats2bfloat162_rn(p0, p1);
          const __nv_bfloat162 p23 = __floats2bfloat162_rn(p2, p3);
          const float2 f01 = __bfloat1622float2(p01);
          const float2 f23 = __bfloat1622float2(p23);
          l[0] += f01.x + f01.y;
          l[1] += f23.x + f23.y;
          pa[2 * half] = *reinterpret_cast<const uint32_t*>(&p01);
          pa[2 * half + 1] = *reinterpret_cast<const uint32_t*>(&p23);
        }
      }
      // acc += P v over these 16 keys, 16 columns of hd per ldmatrix
      const __nv_bfloat16* v0 =
          vs + (kt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
          (lane >> 4) * 8;
#pragma unroll
      for (int dn = 0; dn < HD / 16; ++dn) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, v0 + dn * 16);
        mma_bf16(acc[2 * dn], pa, bf[0], bf[1]);
        mma_bf16(acc[2 * dn + 1], pa, bf[2], bf[3]);
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int R = R0 + r_top + 8 * h;
    const float lsum = fmaxf(quad_sum(l[h]), 1e-30f);
    if (R >= rows) continue;
    __nv_bfloat16* dst =
        a.out + ((size_t)(b * a.Sq + R / G) * a.H + kh * G + R % G) * HD +
        2 * tig;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * h] / lsum,
                                acc[n][2 * h + 1] / lsum);
  }
}

// ---------------------------------------------------------------- launch --
// The page sizes the walks take: any from 1 key, since every copy
// addresses its row's block and offset on its own (TileCopy::fetch);
// kernels/paged_attention.py states the same rule and raises on pages
// below 1.
bool page_supported(int page) { return page > 0; }

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <class Pool, int HD, int GC>
int decode_launch(const DecodeArgs& a, int B, cudaStream_t stream) {
  using L = DecodeLayout<Pool, HD, GC>;
  constexpr int smem = L::kBytes;
  auto split = paged_decode_split_kernel<Pool, HD, GC>;
  cudaError_t err = allow_smem(split, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = a.H / a.K;
  split<<<dim3(B, a.K * (G / GC), a.n_split), L::kThreads, smem, stream>>>(
      a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_decode_combine_kernel<Pool><<<dim3(B, a.H), kCombineThreads, 0,
                                      stream>>>(a.part, a.out, a.H, HD,
                                                a.n_split);
  return static_cast<int>(cudaGetLastError());
}

template <class Pool, int HD>
int decode_gc(const DecodeArgs& a, int B, cudaStream_t stream) {
  const int G = a.H / a.K;
  if (G % 4 == 0) return decode_launch<Pool, HD, 4>(a, B, stream);
  if (G % 2 == 0) return decode_launch<Pool, HD, 2>(a, B, stream);
  return decode_launch<Pool, HD, 1>(a, B, stream);
}

template <class Pool>
int decode_hd(const DecodeArgs& a, int B, int hd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || a.K <= 0 || a.H % a.K || a.n_split <= 0 ||
      !page_supported(a.page))
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd == 32) return decode_gc<Pool, 32>(a, B, st);
  if (hd == 64) return decode_gc<Pool, 64>(a, B, st);
  if (hd == 128) return decode_gc<Pool, 128>(a, B, st);
  if (hd == 256) return decode_gc<Pool, 256>(a, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <class Pool, int HD>
int prefill_launch(const PrefillArgs& a, int B, cudaStream_t stream) {
  const int tiles = (a.Sq * (a.H / a.K) + kBM - 1) / kBM;
  if (tiles > 65535 || a.K > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = PrefillLayout<Pool, HD>::kBytes;
  auto kernel = paged_prefill_kernel<Pool, HD>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(B, a.K, tiles), kPThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <class Pool>
int prefill_hd(const PrefillArgs& a, int B, int hd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || a.Sq <= 0 || a.K <= 0 || a.H % a.K ||
      !page_supported(a.page))
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd == 32) return prefill_launch<Pool, 32>(a, B, st);
  if (hd == 64) return prefill_launch<Pool, 64>(a, B, st);
  if (hd == 128) return prefill_launch<Pool, 128>(a, B, st);
  if (hd == 256) return prefill_launch<Pool, 256>(a, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <class Pool, int HD>
size_t smem_of(int prefill) {
  // decode: the largest head group (GC = 4) needs the most merge space
  return prefill ? PrefillLayout<Pool, HD>::kBytes
                 : DecodeLayout<Pool, HD, 4>::kBytes;
}

template <class Pool>
size_t smem_hd(int prefill, int hd) {
  if (hd == 32) return smem_of<Pool, 32>(prefill);
  if (hd == 64) return smem_of<Pool, 64>(prefill);
  if (hd == 128) return smem_of<Pool, 128>(prefill);
  if (hd == 256) return smem_of<Pool, 256>(prefill);
  return 0;
}

// hd**-0.5 rounded once to fp32, as the reference multiplies by it
float softmax_scale(int hd) {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
}

DecodeArgs decode_args(const void* q, const void* pool_k, const void* k_scale,
                       const void* pool_v, const void* v_scale,
                       const void* page_table, const void* positions,
                       void* part, void* out, int H, int K, int hd, int page,
                       int n_blocks, int window, float cap, int n_split) {
  DecodeArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.pool_k = static_cast<const uint8_t*>(pool_k);
  a.pool_v = static_cast<const uint8_t*>(pool_v);
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.page_table = static_cast<const int*>(page_table);
  a.positions = static_cast<const int*>(positions);
  a.part = static_cast<float*>(part);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.H = H;
  a.K = K;
  a.page = page;
  a.n_blocks = n_blocks;
  a.window = window;
  a.n_split = n_split;
  a.cap = cap;
  a.scale = softmax_scale(hd);
  return a;
}

PrefillArgs prefill_args(const void* q, const void* pool_k,
                         const void* k_scale, const void* pool_v,
                         const void* v_scale, const void* page_table,
                         const void* positions, void* out, int Sq, int H,
                         int K, int hd, int page, int n_blocks, int window,
                         float cap) {
  PrefillArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.pool_k = static_cast<const uint8_t*>(pool_k);
  a.pool_v = static_cast<const uint8_t*>(pool_v);
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.page_table = static_cast<const int*>(page_table);
  a.positions = static_cast<const int*>(positions);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.Sq = Sq;
  a.H = H;
  a.K = K;
  a.page = page;
  a.n_blocks = n_blocks;
  a.window = window;
  a.cap = cap;
  a.scale = softmax_scale(hd);
  return a;
}

}  // namespace

extern "C" {

// Shared-memory bytes one CTA of the decode split kernel (prefill = 0) or
// of the prefill kernel (prefill = 1) takes over a pool of `bits` (16:
// bf16, 8: int8, 4: packed int4) at head width hd; 0 for an unbuilt hd.
size_t paged_smem_bytes(int prefill, int hd, int bits) {
  if (bits == 16) return smem_hd<Bf16Pool>(prefill, hd);
  if (bits == 8) return smem_hd<Int8Pool>(prefill, hd);
  if (bits == 4) return smem_hd<Int4Pool>(prefill, hd);
  return 0;
}

const char* paged_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q/out (B, H, hd) bf16; pools (P, page, K, hd) bf16; page_table
// (B, n_blocks) int32; positions (B,) int32; part fp32 scratch of
// B*H*n_split*(hd+2) floats. Launches the split kernel, then the combine
// kernel, on `stream`. Returns cudaGetLastError().
int paged_decode_bf16(const void* q, const void* pool_k, const void* pool_v,
                      const void* page_table, const void* positions,
                      void* part, void* out, int B, int H, int K, int hd,
                      int page, int n_blocks, int window, float cap,
                      int n_split, void* stream) {
  const DecodeArgs a =
      decode_args(q, pool_k, nullptr, pool_v, nullptr, page_table, positions,
                  part, out, H, K, hd, page, n_blocks, window, cap, n_split);
  return decode_hd<Bf16Pool>(a, B, hd, stream);
}

// The decode walk over a quantized pool: pool_k/v (P, page, K, hd_store)
// int8 with hd_store = hd (bits 8) or hd/2 (bits 4, packed); k/v_scale
// (P, page, K) fp32; the rest as paged_decode_bf16.
int paged_decode_quant(const void* q, const void* pool_k, const void* k_scale,
                       const void* pool_v, const void* v_scale,
                       const void* page_table, const void* positions,
                       void* part, void* out, int B, int H, int K, int hd,
                       int page, int n_blocks, int window, float cap,
                       int bits, int n_split, void* stream) {
  const DecodeArgs a =
      decode_args(q, pool_k, k_scale, pool_v, v_scale, page_table, positions,
                  part, out, H, K, hd, page, n_blocks, window, cap, n_split);
  if (bits == 8) return decode_hd<Int8Pool>(a, B, hd, stream);
  if (bits == 4) return decode_hd<Int4Pool>(a, B, hd, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// q/out (B, Sq, H, hd) bf16; positions (B,) = each chunk's first position;
// pools, page_table as paged_decode_bf16.
int paged_prefill_bf16(const void* q, const void* pool_k, const void* pool_v,
                       const void* page_table, const void* positions,
                       void* out, int B, int Sq, int H, int K, int hd,
                       int page, int n_blocks, int window, float cap,
                       void* stream) {
  const PrefillArgs a =
      prefill_args(q, pool_k, nullptr, pool_v, nullptr, page_table, positions,
                   out, Sq, H, K, hd, page, n_blocks, window, cap);
  return prefill_hd<Bf16Pool>(a, B, hd, stream);
}

// The chunked-prefill walk over a quantized pool; pools as
// paged_decode_quant, the rest as paged_prefill_bf16.
int paged_prefill_quant(const void* q, const void* pool_k,
                        const void* k_scale, const void* pool_v,
                        const void* v_scale, const void* page_table,
                        const void* positions, void* out, int B, int Sq,
                        int H, int K, int hd, int page, int n_blocks,
                        int window, float cap, int bits, void* stream) {
  const PrefillArgs a =
      prefill_args(q, pool_k, k_scale, pool_v, v_scale, page_table, positions,
                   out, Sq, H, K, hd, page, n_blocks, window, cap);
  if (bits == 8) return prefill_hd<Int8Pool>(a, B, hd, stream);
  if (bits == 4) return prefill_hd<Int4Pool>(a, B, hd, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
