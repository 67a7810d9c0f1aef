// Paged attention over a bf16 KV page pool, written by hand for Hopper
// (sm_90a): the one-token decode walk and the chunked-prefill walk.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/paged_attention.py:
//   paged_decode_bf16  <- paged_attention_fwd (_paged_kernel, _block_update)
//   paged_prefill_bf16 <- paged_prefill_fwd (_paged_prefill_kernel,
//                         _prefill_qpos)
//
// What bounds them on this card: the bytes of the K/V pages a sequence
// walks (each live page is read once per kv head, page*hd*2 bytes for K and
// as much for V) over the 3.35 TB/s of device memory. Decode does 4*G
// flops per K/V element it reads, far below the card's ~295 flop/byte
// ridge, so it is bytes-bound; prefill reuses each page for every query row
// of its tile.
//
// What the design does about it:
//   * one CTA owns one (sequence, kv head) pair — or, for prefill, one
//     BM-row tile of its flattened (Sq*G) query rows — and walks the page
//     table itself, so every K/V page is loaded from device memory once
//     for all G query heads (all BM rows) that share it, and the dense
//     chronological (B, n_blocks*page, K, hd) view is never built;
//   * the block loop runs inside the CTA over the [lo, hi] range the rows
//     need (hi clamped to the page-table width, lo at the local window's
//     first block), so local layers read O(window) pages, not O(T);
//   * pages stream through a two-stage cp.async ring in shared memory:
//     the next page's copy is in flight while the current one is used;
//   * the fp32 online-softmax state (m, l, acc) stays in shared memory for
//     the whole walk and the output is written once.
// The TPU kernel kept the whole chunk's (Sq*G, hd) fp32 accumulator in
// VMEM (1 MiB at Sq=512, hd=256); a block has 227 KB here, so prefill
// tiles the rows instead. Split-K over blocks ("flash-decoding") and
// tensor-core (mma/wgmma) products are later work.
//
// Semantics kept exactly from the reference: q in fp32 pre-scaled by
// hd**-0.5; softcap cap*tanh(s/cap) before the mask; masked scores -1e30;
// l clamped at 1e-30; head h = k*G + g, prefill row r = s*G + g at
// position positions[b] + s; the output is rounded to bf16 (q.dtype).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kQPad = 4;   // fp32 padding per shared q row (keeps 16 B rows)
constexpr int kKVPad = 8;  // bf16 padding per shared K/V row (16 B)
constexpr int kDecodeThreads = 128;
constexpr int kPrefillThreads = 256;

struct WalkArgs {
  const __nv_bfloat16* q;       // (B, Sq, H, hd)
  const __nv_bfloat16* pool_k;  // (P, page, K, hd)
  const __nv_bfloat16* pool_v;  // (P, page, K, hd)
  const int* page_table;        // (B, n_blocks)
  const int* positions;         // (B,) first query's absolute position
  __nv_bfloat16* out;           // (B, Sq, H, hd)
  int Sq, H, K, hd, page, n_blocks, window;
  float cap, scale;
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Floats of shared memory before the bf16 K/V ring, rounded to 16 B.
__host__ __device__ inline size_t float_region(int rows, int hd, int page) {
  size_t f = (size_t)rows * (hd + kQPad)   // q, fp32, pre-scaled
             + (size_t)rows * hd           // acc
             + (size_t)rows * page         // scores, then probabilities
             + 3 * (size_t)rows;           // m, l, correction
  return (f + 3) & ~(size_t)3;
}

__host__ __device__ inline size_t smem_bytes(int rows, int hd, int page) {
  // two stages x (K, V) x page rows of (hd + pad) bf16
  return float_region(rows, hd, page) * 4 +
         (size_t)2 * 2 * page * (hd + kKVPad) * 2;
}

// Score one page for every (row, slot) pair. kWarpPerPair: a warp reduces
// one pair over hd (decode: G*page pairs, too few to give each thread
// one); otherwise each thread owns whole pairs (prefill tiles).
template <bool kWarpPerPair>
__device__ __forceinline__ void score_page(
    const WalkArgs& a, const float* q_s, const __nv_bfloat16* k_s,
    float* s_s, int rows, int blk, int qpos0, int r0, int G) {
  const int QS = a.hd + kQPad, KS = a.hd + kKVPad, page = a.page;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  auto finish = [&](int r, int j, float sc) {
    if (a.cap > 0.f) sc = a.cap * tanhf(sc / a.cap);
    const int kpos = blk * page + j;
    const int qp = qpos0 + (r0 + r) / G;
    bool valid = kpos <= qp;
    if (a.window) valid = valid && kpos > qp - a.window;
    s_s[r * page + j] = valid ? sc : kNeg;
  };
  if (kWarpPerPair) {
    const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
    for (int p = warp; p < rows * page; p += nwarps) {
      const int r = p / page, j = p % page;
      const float* qr = q_s + r * QS;
      const __nv_bfloat16* kr = k_s + j * KS;
      float acc = 0.f;
      for (int d = 2 * lane; d < a.hd; d += 64) {
        float2 kf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(kr + d));
        acc = fmaf(qr[d], kf.x, acc);
        acc = fmaf(qr[d + 1], kf.y, acc);
      }
      acc = warp_sum(acc);
      if (lane == 0) finish(r, j, acc);
    }
  } else {
    for (int p = tid; p < rows * page; p += nthreads) {
      const int r = p / page, j = p % page;
      const float* qr = q_s + r * QS;
      const __nv_bfloat16* kr = k_s + j * KS;
      float acc = 0.f;
      for (int d = 0; d < a.hd; d += 8) {
        uint4 raw = *reinterpret_cast<const uint4*>(kr + d);
        const __nv_bfloat162* k2 =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
        float4 qa = *reinterpret_cast<const float4*>(qr + d);
        float4 qb = *reinterpret_cast<const float4*>(qr + d + 4);
        float2 k0 = __bfloat1622float2(k2[0]);
        float2 k1 = __bfloat1622float2(k2[1]);
        float2 k2f = __bfloat1622float2(k2[2]);
        float2 k3 = __bfloat1622float2(k2[3]);
        acc = fmaf(qa.x, k0.x, acc);
        acc = fmaf(qa.y, k0.y, acc);
        acc = fmaf(qa.z, k1.x, acc);
        acc = fmaf(qa.w, k1.y, acc);
        acc = fmaf(qb.x, k2f.x, acc);
        acc = fmaf(qb.y, k2f.y, acc);
        acc = fmaf(qb.z, k3.x, acc);
        acc = fmaf(qb.w, k3.y, acc);
      }
      finish(r, j, acc);
    }
  }
}

// The page walk shared by both kernels: rows [r0, r0 + rows) of sequence
// b's flattened (Sq*G) query rows for kv head kh.
template <bool kWarpPerPair>
__device__ void walk(const WalkArgs& a, int b, int kh, int r0, int rows) {
  extern __shared__ __align__(16) float smem[];
  const int hd = a.hd, page = a.page, G = a.H / a.K;
  const int QS = hd + kQPad, KS = hd + kKVPad;
  float* q_s = smem;
  float* acc_s = q_s + (size_t)rows * QS;
  float* s_s = acc_s + (size_t)rows * hd;
  float* m_s = s_s + (size_t)rows * page;
  float* l_s = m_s + rows;
  float* c_s = l_s + rows;
  __nv_bfloat16* kv_s =
      reinterpret_cast<__nv_bfloat16*>(smem + float_region(rows, hd, page));
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;

  const int qpos0 = a.positions[b];
  for (int idx = tid; idx < rows * hd; idx += nthreads) {
    const int r = idx / hd, d = idx % hd;
    const int R = r0 + r, s = R / G, h = kh * G + R % G;
    const size_t off = ((size_t)(b * a.Sq + s) * a.H + h) * hd + d;
    q_s[r * QS + d] = __bfloat162float(a.q[off]) * a.scale;
    acc_s[idx] = 0.f;
  }
  for (int r = tid; r < rows; r += nthreads) {
    m_s[r] = kNeg;
    l_s[r] = 0.f;
  }

  // Blocks this tile needs: the first row's window start to the last
  // row's own block, clamped to the page-table width (a padded final
  // chunk may run past it; its overflow rows are garbage by contract).
  const int qfirst = qpos0 + r0 / G;
  const int qlast = qpos0 + (r0 + rows - 1) / G;
  const int hi = min(qlast / page, a.n_blocks - 1);
  const int lo = a.window ? max((qfirst - a.window + 1) / page, 0) : 0;
  const int* pt = a.page_table + (size_t)b * a.n_blocks;

  auto issue = [&](int blk, int stage) {
    const size_t pid = (size_t)pt[blk];
    __nv_bfloat16* ks = kv_s + (size_t)stage * 2 * page * KS;
    __nv_bfloat16* vs = ks + (size_t)page * KS;
    const int chunks = hd / 8;  // 16 B per cp.async
    for (int c = tid; c < page * chunks; c += nthreads) {
      const int j = c / chunks, d = (c % chunks) * 8;
      const size_t g = ((pid * page + j) * a.K + kh) * hd + d;
      cp_async16(ks + j * KS + d, a.pool_k + g);
      cp_async16(vs + j * KS + d, a.pool_v + g);
    }
  };

  if (lo <= hi) issue(lo, 0);
  cp_async_commit();
  __syncthreads();  // q_s, m_s, l_s initialised
  for (int blk = lo; blk <= hi; ++blk) {
    const int stage = (blk - lo) & 1;
    if (blk + 1 <= hi) issue(blk + 1, stage ^ 1);
    cp_async_commit();  // possibly empty: keeps one group per iteration
    cp_async_wait_1();  // this block's page has landed
    __syncthreads();
    const __nv_bfloat16* k_s = kv_s + (size_t)stage * 2 * page * KS;
    const __nv_bfloat16* v_s = k_s + (size_t)page * KS;

    score_page<kWarpPerPair>(a, q_s, k_s, s_s, rows, blk, qpos0, r0, G);
    __syncthreads();

    // online softmax, one warp per row
    for (int r = warp; r < rows; r += nwarps) {
      float mx = kNeg;
      for (int j = lane; j < page; j += 32) mx = fmaxf(mx, s_s[r * page + j]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < page; j += 32) {
        const float p = expf(s_s[r * page + j] - m_new);
        s_s[r * page + j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < rows * hd; idx += nthreads) {
      const int r = idx / hd, d = idx % hd;
      const float* pr = s_s + r * page;
      float acc = acc_s[idx] * c_s[r];
      for (int j = 0; j < page; ++j)
        acc = fmaf(pr[j], __bfloat162float(v_s[j * KS + d]), acc);
      acc_s[idx] = acc;
    }
    __syncthreads();  // the stage is refilled next iteration
  }

  for (int idx = tid; idx < rows * hd; idx += nthreads) {
    const int r = idx / hd, d = idx % hd;
    const int R = r0 + r, s = R / G, h = kh * G + R % G;
    const size_t off = ((size_t)(b * a.Sq + s) * a.H + h) * hd + d;
    a.out[off] = __float2bfloat16(acc_s[idx] / fmaxf(l_s[r], 1e-30f));
  }
}

__global__ void __launch_bounds__(kDecodeThreads)
    paged_decode_kernel(WalkArgs a) {
  // one CTA per (sequence, kv head): its G query heads are the rows
  walk<true>(a, blockIdx.x, blockIdx.y, 0, a.H / a.K);
}

__global__ void __launch_bounds__(kPrefillThreads)
    paged_prefill_kernel(WalkArgs a, int bm) {
  // one CTA per (sequence, kv head, BM-row tile of the Sq*G rows)
  const int total = a.Sq * (a.H / a.K);
  const int r0 = blockIdx.z * bm;
  walk<false>(a, blockIdx.x, blockIdx.y, r0, min(bm, total - r0));
}

WalkArgs make_args(const void* q, const void* pool_k, const void* pool_v,
                   const void* page_table, const void* positions, void* out,
                   int Sq, int H, int K, int hd, int page, int n_blocks,
                   int window, float cap) {
  WalkArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.pool_k = static_cast<const __nv_bfloat16*>(pool_k);
  a.pool_v = static_cast<const __nv_bfloat16*>(pool_v);
  a.page_table = static_cast<const int*>(page_table);
  a.positions = static_cast<const int*>(positions);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.Sq = Sq;
  a.H = H;
  a.K = K;
  a.hd = hd;
  a.page = page;
  a.n_blocks = n_blocks;
  a.window = window;
  a.cap = cap;
  // hd**-0.5 rounded once to fp32, as the reference multiplies by it
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  return a;
}

}  // namespace

extern "C" {

// Shared-memory bytes one CTA needs for `rows` query rows.
size_t paged_smem_bytes(int rows, int hd, int page) {
  return smem_bytes(rows, hd, page);
}

const char* paged_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q/out (B, H, hd) bf16; pools (P, page, K, hd) bf16; page_table
// (B, n_blocks) int32; positions (B,) int32. Returns cudaGetLastError().
int paged_decode_bf16(const void* q, const void* pool_k, const void* pool_v,
                      const void* page_table, const void* positions,
                      void* out, int B, int H, int K, int hd, int page,
                      int n_blocks, int window, float cap, void* stream) {
  WalkArgs a = make_args(q, pool_k, pool_v, page_table, positions, out, 1, H,
                         K, hd, page, n_blocks, window, cap);
  const size_t smem = smem_bytes(H / K, hd, page);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_decode_kernel<<<dim3(B, K), kDecodeThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// q/out (B, Sq, H, hd) bf16; positions (B,) = each chunk's first position.
// bm query rows (of the flattened Sq*G per kv head) per CTA.
int paged_prefill_bf16(const void* q, const void* pool_k, const void* pool_v,
                       const void* page_table, const void* positions,
                       void* out, int B, int Sq, int H, int K, int hd,
                       int page, int n_blocks, int window, float cap, int bm,
                       void* stream) {
  WalkArgs a = make_args(q, pool_k, pool_v, page_table, positions, out, Sq, H,
                         K, hd, page, n_blocks, window, cap);
  const size_t smem = smem_bytes(bm, hd, page);
  cudaError_t err = cudaFuncSetAttribute(
      paged_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (Sq * (H / K) + bm - 1) / bm;
  paged_prefill_kernel<<<dim3(B, K, tiles), kPrefillThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(a, bm);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
