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
// What bounds them on this card: the bytes of the K/V pages a sequence
// walks over the 3.35 TB/s of device memory. Each live page is read once
// per kv head: page*hd*2 bytes for K and as much for V in bf16; page*hd
// (int8) or page*hd/2 (int4) bytes of codes each, plus 4 bytes of scale
// per slot each, in a quantized pool — live code bytes plus 8*K bytes of
// scale per token and layer. Decode does 4*G flops per K/V element it
// reads, far below the card's ~295 flop/byte ridge, so it is bytes-bound;
// prefill reuses each page for every query row of its tile and is bound
// by its operations.
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
//   * pages stream through a two-stage cp.async ring in shared memory in
//     their stored width (16-B copies of bf16, int8 or packed int4 rows;
//     4-B copies of the page's K and V scale tiles in the same group), so
//     a quantized pool moves 2x or 4x fewer code bytes than bf16 and is
//     dequantized only as each element is read from shared memory;
//   * the fp32 online-softmax state (m, l, acc) stays in shared memory for
//     the whole walk and the output is written once.
// One walk serves all three pool types: a page-element reader (Bf16Pool,
// Int8Pool, Int4Pool) supplies the row width and turns stored elements
// into fp32, float(code) * scale[slot] for the quantized ones — one fp32
// multiply, as the plain version's dequantize_kv does. The TPU kernel kept
// the whole chunk's (Sq*G, hd) fp32 accumulator in VMEM (1 MiB at Sq=512,
// hd=256); a block has 227 KB here, so prefill tiles the rows instead.
// Split-K over blocks ("flash-decoding") and tensor-core (mma/wgmma)
// products are later work.
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
constexpr int kQPad = 4;      // fp32 padding per shared q row (keeps 16 B rows)
constexpr int kRowPad = 16;   // byte padding per shared K/V row
constexpr int kDecodeThreads = 128;
constexpr int kPrefillThreads = 256;

struct WalkArgs {
  const __nv_bfloat16* q;   // (B, Sq, H, hd)
  const uint8_t* pool_k;    // (P, page, K, hd) bf16 or (P, page, K, hd_store) int8
  const uint8_t* pool_v;
  const float* k_scale;     // (P, page, K) fp32; null for a bf16 pool
  const float* v_scale;
  const int* page_table;    // (B, n_blocks)
  const int* positions;     // (B,) first query's absolute position
  __nv_bfloat16* out;       // (B, Sq, H, hd)
  int Sq, H, K, hd, page, n_blocks, window;
  float cap, scale;
};

// Page-element readers. row points at one stored K/V row (one slot of one
// kv head) in shared memory; d is an element index along hd; s the slot's
// scale (unused for bf16).
struct Bf16Pool {
  static constexpr bool kQuant = false;
  __host__ __device__ static int row_bytes(int hd) { return 2 * hd; }
  __device__ static float load1(const uint8_t* row, int d, float) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(row)[d]);
  }
  __device__ static float2 load2(const uint8_t* row, int d, float) {
    return __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(row + 2 * d));
  }
  __device__ static void load8(const uint8_t* row, int d, float, float* o) {
    uint4 raw = *reinterpret_cast<const uint4*>(row + 2 * d);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

struct Int8Pool {
  static constexpr bool kQuant = true;
  __host__ __device__ static int row_bytes(int hd) { return hd; }
  __device__ static float load1(const uint8_t* row, int d, float s) {
    return static_cast<float>(reinterpret_cast<const int8_t*>(row)[d]) * s;
  }
  __device__ static float2 load2(const uint8_t* row, int d, float s) {
    char2 c = *reinterpret_cast<const char2*>(row + d);
    return make_float2(static_cast<float>(c.x) * s,
                       static_cast<float>(c.y) * s);
  }
  __device__ static void load8(const uint8_t* row, int d, float s, float* o) {
    uint2 raw = *reinterpret_cast<const uint2*>(row + d);
    const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = static_cast<float>(c[i]) * s;
  }
};

// int4: element 2i is the low nibble of byte i, 2i+1 the high one, both
// sign-extended (kernels/ref.py::unpack_int4_hd).
struct Int4Pool {
  static constexpr bool kQuant = true;
  __host__ __device__ static int row_bytes(int hd) { return hd / 2; }
  __device__ static int lo(uint8_t b) {
    return static_cast<int8_t>(static_cast<uint8_t>(b << 4)) >> 4;
  }
  __device__ static int hi(uint8_t b) { return static_cast<int8_t>(b) >> 4; }
  __device__ static float load1(const uint8_t* row, int d, float s) {
    const uint8_t b = row[d >> 1];
    return static_cast<float>((d & 1) ? hi(b) : lo(b)) * s;
  }
  __device__ static float2 load2(const uint8_t* row, int d, float s) {
    const uint8_t b = row[d >> 1];  // d is even
    return make_float2(static_cast<float>(lo(b)) * s,
                       static_cast<float>(hi(b)) * s);
  }
  __device__ static void load8(const uint8_t* row, int d, float s, float* o) {
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(row + d / 2);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint8_t b = static_cast<uint8_t>(raw >> (8 * i));
      o[2 * i] = static_cast<float>(lo(b)) * s;
      o[2 * i + 1] = static_cast<float>(hi(b)) * s;
    }
  }
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

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Bytes of one shared K/V row: the stored row plus padding.
__host__ __device__ inline int row_stride(int row_bytes) {
  return row_bytes + kRowPad;
}

// Bytes of one ring stage: K and V rows of one page, then (quantized
// pools) the page's K and V scale tiles, rounded to 16 B.
__host__ __device__ inline size_t stage_bytes(int row_bytes, int page,
                                              bool quant) {
  size_t b = (size_t)2 * page * row_stride(row_bytes) +
             (quant ? (size_t)2 * page * 4 : 0);
  return (b + 15) & ~(size_t)15;
}

// Floats of shared memory before the K/V ring, rounded to 16 B.
__host__ __device__ inline size_t float_region(int rows, int hd, int page) {
  size_t f = (size_t)rows * (hd + kQPad)   // q, fp32, pre-scaled
             + (size_t)rows * hd           // acc
             + (size_t)rows * page         // scores, then probabilities
             + 3 * (size_t)rows;           // m, l, correction
  return (f + 3) & ~(size_t)3;
}

// Shared memory one CTA needs: the fp32 state plus a two-stage ring.
__host__ __device__ inline size_t smem_bytes(int rows, int hd, int page,
                                             int row_bytes, bool quant) {
  return float_region(rows, hd, page) * 4 +
         2 * stage_bytes(row_bytes, page, quant);
}

// Score one page for every (row, slot) pair. kWarpPerPair: a warp reduces
// one pair over hd (decode: G*page pairs, too few to give each thread
// one); otherwise each thread owns whole pairs (prefill tiles).
template <class Pool, bool kWarpPerPair>
__device__ __forceinline__ void score_page(
    const WalkArgs& a, const float* q_s, const uint8_t* k_s,
    const float* ksc_s, float* s_s, int rows, int blk, int qpos0, int r0,
    int G) {
  const int QS = a.hd + kQPad, page = a.page;
  const int RS = row_stride(Pool::row_bytes(a.hd));
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
      const uint8_t* kr = k_s + j * RS;
      const float s = Pool::kQuant ? ksc_s[j] : 1.f;
      float acc = 0.f;
      for (int d = 2 * lane; d < a.hd; d += 64) {
        float2 kf = Pool::load2(kr, d, s);
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
      const uint8_t* kr = k_s + j * RS;
      const float s = Pool::kQuant ? ksc_s[j] : 1.f;
      float acc = 0.f;
      for (int d = 0; d < a.hd; d += 8) {
        float k8[8];
        Pool::load8(kr, d, s, k8);
        float4 qa = *reinterpret_cast<const float4*>(qr + d);
        float4 qb = *reinterpret_cast<const float4*>(qr + d + 4);
        acc = fmaf(qa.x, k8[0], acc);
        acc = fmaf(qa.y, k8[1], acc);
        acc = fmaf(qa.z, k8[2], acc);
        acc = fmaf(qa.w, k8[3], acc);
        acc = fmaf(qb.x, k8[4], acc);
        acc = fmaf(qb.y, k8[5], acc);
        acc = fmaf(qb.z, k8[6], acc);
        acc = fmaf(qb.w, k8[7], acc);
      }
      finish(r, j, acc);
    }
  }
}

// The page walk shared by every kernel: rows [r0, r0 + rows) of sequence
// b's flattened (Sq*G) query rows for kv head kh, over a pool of type Pool.
template <class Pool, bool kWarpPerPair>
__device__ void walk(const WalkArgs& a, int b, int kh, int r0, int rows) {
  extern __shared__ __align__(16) float smem[];
  const int hd = a.hd, page = a.page, G = a.H / a.K;
  const int QS = hd + kQPad;
  const int RB = Pool::row_bytes(hd), RS = row_stride(RB);
  const size_t SB = stage_bytes(RB, page, Pool::kQuant);
  float* q_s = smem;
  float* acc_s = q_s + (size_t)rows * QS;
  float* s_s = acc_s + (size_t)rows * hd;
  float* m_s = s_s + (size_t)rows * page;
  float* l_s = m_s + rows;
  float* c_s = l_s + rows;
  uint8_t* kv_s =
      reinterpret_cast<uint8_t*>(smem + float_region(rows, hd, page));
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

  // One stage: page rows of K, page rows of V, then the K and V scales.
  auto issue = [&](int blk, int stage) {
    const size_t pid = (size_t)pt[blk];
    uint8_t* ks = kv_s + (size_t)stage * SB;
    uint8_t* vs = ks + (size_t)page * RS;
    const int chunks = RB / 16;  // 16 B per cp.async
    for (int c = tid; c < page * chunks; c += nthreads) {
      const int j = c / chunks, off = (c % chunks) * 16;
      const size_t g = ((pid * page + j) * a.K + kh) * RB + off;
      cp_async16(ks + j * RS + off, a.pool_k + g);
      cp_async16(vs + j * RS + off, a.pool_v + g);
    }
    if (Pool::kQuant) {
      float* ksc = reinterpret_cast<float*>(vs + (size_t)page * RS);
      for (int j = tid; j < page; j += nthreads) {
        const size_t g = (pid * page + j) * a.K + kh;
        cp_async4(ksc + j, a.k_scale + g);
        cp_async4(ksc + page + j, a.v_scale + g);
      }
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
    const uint8_t* k_s = kv_s + (size_t)stage * SB;
    const uint8_t* v_s = k_s + (size_t)page * RS;
    const float* ksc_s = reinterpret_cast<const float*>(v_s + (size_t)page * RS);
    const float* vsc_s = ksc_s + page;

    score_page<Pool, kWarpPerPair>(a, q_s, k_s, ksc_s, s_s, rows, blk, qpos0,
                                   r0, G);
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
        acc = fmaf(pr[j],
                   Pool::load1(v_s + j * RS, d, Pool::kQuant ? vsc_s[j] : 1.f),
                   acc);
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
  walk<Bf16Pool, true>(a, blockIdx.x, blockIdx.y, 0, a.H / a.K);
}

__global__ void __launch_bounds__(kPrefillThreads)
    paged_prefill_kernel(WalkArgs a, int bm) {
  // one CTA per (sequence, kv head, BM-row tile of the Sq*G rows)
  const int total = a.Sq * (a.H / a.K);
  const int r0 = blockIdx.z * bm;
  walk<Bf16Pool, false>(a, blockIdx.x, blockIdx.y, r0, min(bm, total - r0));
}

template <class Pool>
__global__ void __launch_bounds__(kDecodeThreads)
    paged_decode_quant_kernel(WalkArgs a) {
  walk<Pool, true>(a, blockIdx.x, blockIdx.y, 0, a.H / a.K);
}

template <class Pool>
__global__ void __launch_bounds__(kPrefillThreads)
    paged_prefill_quant_kernel(WalkArgs a, int bm) {
  const int total = a.Sq * (a.H / a.K);
  const int r0 = blockIdx.z * bm;
  walk<Pool, false>(a, blockIdx.x, blockIdx.y, r0, min(bm, total - r0));
}

WalkArgs make_args(const void* q, const void* pool_k, const void* k_scale,
                   const void* pool_v, const void* v_scale,
                   const void* page_table, const void* positions, void* out,
                   int Sq, int H, int K, int hd, int page, int n_blocks,
                   int window, float cap) {
  WalkArgs a;
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
  a.hd = hd;
  a.page = page;
  a.n_blocks = n_blocks;
  a.window = window;
  a.cap = cap;
  // hd**-0.5 rounded once to fp32, as the reference multiplies by it
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  return a;
}

// Launch kernel over grid with the shared memory rows of query rows need.
template <class Pool, class Kernel, class... Extra>
int launch(Kernel kernel, dim3 grid, int threads, int rows,
           const WalkArgs& a, void* stream, Extra... extra) {
  const size_t smem = smem_bytes(rows, a.hd, a.page, Pool::row_bytes(a.hd),
                                 Pool::kQuant);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      a, extra...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared-memory bytes one CTA needs for `rows` query rows over a pool of
// `bits` (16: bf16, 8: int8, 4: packed int4).
size_t paged_smem_bytes(int rows, int hd, int page, int bits) {
  const int row_bytes = bits == 16 ? 2 * hd : bits == 8 ? hd : hd / 2;
  return smem_bytes(rows, hd, page, row_bytes, bits != 16);
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
  WalkArgs a = make_args(q, pool_k, nullptr, pool_v, nullptr, page_table,
                         positions, out, 1, H, K, hd, page, n_blocks, window,
                         cap);
  return launch<Bf16Pool>(paged_decode_kernel, dim3(B, K), kDecodeThreads,
                          H / K, a, stream);
}

// q/out (B, Sq, H, hd) bf16; positions (B,) = each chunk's first position.
// bm query rows (of the flattened Sq*G per kv head) per CTA.
int paged_prefill_bf16(const void* q, const void* pool_k, const void* pool_v,
                       const void* page_table, const void* positions,
                       void* out, int B, int Sq, int H, int K, int hd,
                       int page, int n_blocks, int window, float cap, int bm,
                       void* stream) {
  WalkArgs a = make_args(q, pool_k, nullptr, pool_v, nullptr, page_table,
                         positions, out, Sq, H, K, hd, page, n_blocks, window,
                         cap);
  const int tiles = (Sq * (H / K) + bm - 1) / bm;
  return launch<Bf16Pool>(paged_prefill_kernel, dim3(B, K, tiles),
                          kPrefillThreads, bm, a, stream, bm);
}

// The decode walk over a quantized pool: pool_k/v (P, page, K, hd_store)
// int8 with hd_store = hd (bits 8) or hd/2 (bits 4, packed); k/v_scale
// (P, page, K) fp32; the rest as paged_decode_bf16.
int paged_decode_quant(const void* q, const void* pool_k, const void* k_scale,
                       const void* pool_v, const void* v_scale,
                       const void* page_table, const void* positions,
                       void* out, int B, int H, int K, int hd, int page,
                       int n_blocks, int window, float cap, int bits,
                       void* stream) {
  WalkArgs a = make_args(q, pool_k, k_scale, pool_v, v_scale, page_table,
                         positions, out, 1, H, K, hd, page, n_blocks, window,
                         cap);
  const dim3 grid(B, K);
  if (bits == 8)
    return launch<Int8Pool>(paged_decode_quant_kernel<Int8Pool>, grid,
                            kDecodeThreads, H / K, a, stream);
  if (bits == 4)
    return launch<Int4Pool>(paged_decode_quant_kernel<Int4Pool>, grid,
                            kDecodeThreads, H / K, a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The chunked-prefill walk over a quantized pool; pools as
// paged_decode_quant, the rest as paged_prefill_bf16.
int paged_prefill_quant(const void* q, const void* pool_k,
                        const void* k_scale, const void* pool_v,
                        const void* v_scale, const void* page_table,
                        const void* positions, void* out, int B, int Sq,
                        int H, int K, int hd, int page, int n_blocks,
                        int window, float cap, int bm, int bits,
                        void* stream) {
  WalkArgs a = make_args(q, pool_k, k_scale, pool_v, v_scale, page_table,
                         positions, out, Sq, H, K, hd, page, n_blocks, window,
                         cap);
  const dim3 grid(B, K, (Sq * (H / K) + bm - 1) / bm);
  if (bits == 8)
    return launch<Int8Pool>(paged_prefill_quant_kernel<Int8Pool>, grid,
                            kPrefillThreads, bm, a, stream, bm);
  if (bits == 4)
    return launch<Int4Pool>(paged_prefill_quant_kernel<Int4Pool>, grid,
                            kPrefillThreads, bm, a, stream, bm);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
