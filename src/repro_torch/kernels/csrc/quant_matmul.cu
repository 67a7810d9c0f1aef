// Weight-quantized matrix products, written by hand for Hopper (sm_90a):
// HAQ's serving-time runtime.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/quant_matmul.py:
//   qmm_wa16 (bits 8) <- quant_matmul_w8a16 (_w8a16_kernel)
//   qmm_wa16 (bits 4) <- quant_matmul_w4a16 (_w4a16_kernel)
//   qmm_w8a8          <- quant_matmul_w8a8 (_w8a8_kernel)
//
// What they compute:
//   W8A16  out = cast_x((x @ float(w_q)) * scale[n]),   x bf16 or fp32
//   W4A16  the same, w stored as int4 codes packed two per byte along K:
//          byte (i, n) holds row 2i in its low nibble and 2i+1 in its high
//          nibble, each sign-extended ([-7, 7])
//   W8A8   out = cast_out((float(x_q @ w_q) * x_scale) * w_scale[n]) with
//          an exact int32 accumulator; the rescale follows the plain
//          version's order (kernels/ref.py::quant_matmul_w8a8, as
//          repro/kernels/ref.py:71), so an fp32 output is bit-identical
//          to it. The Pallas kernel multiplies x_scale * w_scale first; the
//          two orders differ by at most one fp32 rounding of the product,
//          well inside one ulp of a bf16 output.
// scale has a stride of 1 (per output channel) or 0 (one per tensor, as
// serving/quant.py stores it).
//
// What bounds them on this card: at decode (M = 8) the bytes of the stored
// codes, read once, over 3.35 TB/s — int4 halves them, which is what
// quantized decode is for; at a 4096-row prefill chunk the operations,
// 2*M*K*N, over the tensor cores' rate.
//
// What the design does about it:
//   * one tiled product, three operand readers: each CTA owns a BM x 64
//     output tile and walks K in 64-deep steps; the raw x tile and the raw
//     stored weight tile (int8, or packed int4 at half the rows) stream
//     through a two-stage ring of 16-B cp.async copies, so codes cross
//     device memory at their stored width and x rows past M are
//     zero-filled (ragged M: decode runs M = 8, a chunk M = 4096);
//   * each step converts the staged weight tile once, in shared memory,
//     into the layout the tensor cores read: bf16 codes (exact, |code| <=
//     127) for W8A16/W4A16, int8 for W8A8, transposed to (n, k) so a
//     B fragment is one 32-bit load;
//   * products run as mma.sync on the tensor cores: m16n8k16 bf16 x bf16
//     into fp32 for bf16 x; for fp32 x the tile is split once into three
//     bf16 terms (x = x0 + x1 + x2 exactly), each multiplied by the exact
//     codes, so x loses nothing to bf16 and only the tensor cores' fp32
//     accumulation (which may drop up to an ulp of the running sum per
//     step) separates the result from an fp32 product; m16n8k32 s8 x s8
//     into int32 for W8A8, which is exact;
//   * the epilogue applies the scale(s) and the cast, and guards rows
//     past M. Two tiles: 128 x 64 with 8 warps for M > 32, 16 x 64 with 4
//     warps for decode-sized M, so a decode launch spreads over N/64 CTAs.
// The TPU kernel carried its accumulator across a sequential K grid axis
// in VMEM; here the K loop runs inside the CTA. wgmma, TMA, a deeper ring
// and split-K (more CTAs at decode) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kBK = 64;       // K per step
constexpr int kBN = 64;       // output columns per CTA

enum XKind { kXBf16 = 0, kXF32 = 1, kXI8 = 2 };

template <int BM_, int WM_, int WN_>
struct Tile {
  static constexpr int BM = BM_, WM = WM_, WN = WN_;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int WTM = BM / WM, WTN = kBN / WN;  // one warp's tile
  static constexpr int MT = WTM / 16, NT = WTN / 8;     // mma tiles per warp
};
using LargeTile = Tile<128, 4, 2>;   // 256 threads, 32 x 32 per warp
using SmallTile = Tile<16, 1, 4>;    // 128 threads, 16 x 16 per warp

// The three operand readers: x kind and weight bits fix the staged tile
// sizes, the converted layouts and the product.
template <int XK, int WBITS>
struct Reader {
  static constexpr bool kS8 = XK == kXI8;
  static constexpr int kXBytes = XK == kXF32 ? 4 : (XK == kXBf16 ? 2 : 1);
  static constexpr int kXTerms = XK == kXF32 ? 3 : 0;   // split x tiles
  static constexpr int kWRows = WBITS == 4 ? kBK / 2 : kBK;  // stored rows
  static constexpr int kXPitch = kBK * kXBytes + 16;   // staged x row, bytes
  static constexpr int kWcPitch = kS8 ? kBK + 16 : (kBK + 8) * 2;  // bytes
  static constexpr int kXcPitch = (kBK + 8) * 2;       // split x row, bytes
};

template <class T, class R>
__host__ __device__ constexpr int stage_bytes() {
  return T::BM * R::kXPitch + R::kWRows * kBN;
}

template <class T, class R>
__host__ __device__ constexpr int smem_bytes() {
  return 2 * stage_bytes<T, R>() + kBN * R::kWcPitch +
         R::kXTerms * T::BM * R::kXcPitch;
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Args {
  const uint8_t* x;       // (M, K) bf16 | fp32 | int8
  const uint8_t* w;       // (K, N) int8, or (K/2, N) packed int4
  const float* scale;     // (N,) or (1,) fp32: w scale
  const float* x_scale;   // () fp32, W8A8 only
  void* out;              // (M, N) bf16 | fp32
  int M, N, K, scale_stride;
};

// Stage the raw x tile (rows m0.., cols k0..) and the stored weight tile
// into one ring stage with 16-B cp.async copies.
template <class T, class R>
__device__ __forceinline__ void load_stage(const Args& a, uint8_t* stage,
                                           int m0, int n0, int k0) {
  constexpr int kXChunks = kBK * R::kXBytes / 16;     // per x row
  for (int i = threadIdx.x; i < T::BM * kXChunks; i += T::kThreads) {
    const int r = i / kXChunks, c = i % kXChunks;
    const bool valid = m0 + r < a.M;
    const uint8_t* src =
        valid ? a.x + (static_cast<size_t>(m0 + r) * a.K + k0) * R::kXBytes +
                    c * 16
              : a.x;
    cp_async16(stage + r * R::kXPitch + c * 16, src, valid);
  }
  uint8_t* ws = stage + T::BM * R::kXPitch;
  constexpr int kWChunks = kBN / 16;                  // per stored row
  const int kr0 = R::kWRows == kBK ? k0 : k0 / 2;
  for (int i = threadIdx.x; i < R::kWRows * kWChunks; i += T::kThreads) {
    const int r = i / kWChunks, c = i % kWChunks;
    cp_async16(ws + r * kBN + c * 16,
               a.w + static_cast<size_t>(kr0 + r) * a.N + n0 + c * 16, true);
  }
}

// Convert one staged step into the tensor cores' operand layouts: the
// weight tile as (n, k) bf16 codes (W8A16/W4A16) or int8 (W8A8); for fp32
// x, the x tile split into three bf16 terms.
template <class T, class R, int WBITS>
__device__ __forceinline__ void convert_stage(const uint8_t* stage,
                                              uint8_t* wc, uint8_t* xc) {
  const uint8_t* ws = stage + T::BM * R::kXPitch;
  if constexpr (R::kS8) {
    // (k quad, 4 columns): a 4x4 byte transpose into (n, k) rows
    for (int i = threadIdx.x; i < (kBK / 4) * (kBN / 4); i += T::kThreads) {
      const int kq = i / (kBN / 4), n4 = i % (kBN / 4);
      const uint32_t r0 = ld32(ws + (4 * kq + 0) * kBN + 4 * n4);
      const uint32_t r1 = ld32(ws + (4 * kq + 1) * kBN + 4 * n4);
      const uint32_t r2 = ld32(ws + (4 * kq + 2) * kBN + 4 * n4);
      const uint32_t r3 = ld32(ws + (4 * kq + 3) * kBN + 4 * n4);
      const uint32_t lo01 = __byte_perm(r0, r1, 0x5140);  // n0,n1 of rows 0,1
      const uint32_t lo23 = __byte_perm(r2, r3, 0x5140);
      const uint32_t hi01 = __byte_perm(r0, r1, 0x7362);  // n2,n3 of rows 0,1
      const uint32_t hi23 = __byte_perm(r2, r3, 0x7362);
      uint8_t* dst = wc + (4 * n4) * R::kWcPitch + 4 * kq;
      *reinterpret_cast<uint32_t*>(dst) = __byte_perm(lo01, lo23, 0x5410);
      *reinterpret_cast<uint32_t*>(dst + R::kWcPitch) =
          __byte_perm(lo01, lo23, 0x7632);
      *reinterpret_cast<uint32_t*>(dst + 2 * R::kWcPitch) =
          __byte_perm(hi01, hi23, 0x5410);
      *reinterpret_cast<uint32_t*>(dst + 3 * R::kWcPitch) =
          __byte_perm(hi01, hi23, 0x7632);
    }
  } else {
    // (k pair, 4 columns): rows 2i and 2i+1 of a column become one bf16x2
    for (int i = threadIdx.x; i < (kBK / 2) * (kBN / 4); i += T::kThreads) {
      const int kp = i / (kBN / 4), n4 = i % (kBN / 4);
      int lo[4], hi[4];
      if constexpr (WBITS == 4) {
        const uint32_t p = ld32(ws + kp * kBN + 4 * n4);
        for (int j = 0; j < 4; ++j) {
          const uint8_t b = static_cast<uint8_t>(p >> (8 * j));
          // sign-extended nibbles: an int8 cast, then arithmetic shifts
          lo[j] = static_cast<int8_t>(b << 4) >> 4;
          hi[j] = static_cast<int8_t>(b) >> 4;
        }
      } else {
        const uint32_t r0 = ld32(ws + (2 * kp) * kBN + 4 * n4);
        const uint32_t r1 = ld32(ws + (2 * kp + 1) * kBN + 4 * n4);
        for (int j = 0; j < 4; ++j) {
          lo[j] = static_cast<int8_t>(r0 >> (8 * j));
          hi[j] = static_cast<int8_t>(r1 >> (8 * j));
        }
      }
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(wc + (4 * n4 + j) * R::kWcPitch +
                                     4 * kp) =
            bf16x2(static_cast<float>(lo[j]), static_cast<float>(hi[j]));
    }
  }
  if constexpr (R::kXTerms == 3) {
    // x = x0 + x1 + x2 exactly: each term is the bf16 rounding of what
    // the earlier terms leave, and each remainder is exact in fp32
    constexpr int kTermBytes = T::BM * R::kXcPitch;
    for (int i = threadIdx.x; i < T::BM * (kBK / 2); i += T::kThreads) {
      const int r = i / (kBK / 2), kp = i % (kBK / 2);
      const float2 v =
          *reinterpret_cast<const float2*>(stage + r * R::kXPitch + 8 * kp);
      float e0 = v.x, e1 = v.y;
      for (int t = 0; t < 3; ++t) {
        const __nv_bfloat162 b = __floats2bfloat162_rn(e0, e1);
        *reinterpret_cast<__nv_bfloat162*>(xc + t * kTermBytes +
                                           r * R::kXcPitch + 4 * kp) = b;
        e0 -= __bfloat162float(b.x);
        e1 -= __bfloat162float(b.y);
      }
    }
  }
}

template <class Out>
__device__ __forceinline__ void store2(Out* p, float v0, float v1);

template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

template <>
__device__ __forceinline__ void store2<float>(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

// The tiled product. grid (N / 64, ceil(M / BM)); T::kThreads threads.
template <class T, int XK, int WBITS, class Out>
__global__ void __launch_bounds__(T::kThreads)
    qmm_kernel(const Args a) {
  using R = Reader<XK, WBITS>;
  using Acc = std::conditional_t<R::kS8, int, float>;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* stages = smem;
  uint8_t* wc = smem + 2 * stage_bytes<T, R>();
  uint8_t* xc = wc + kBN * R::kWcPitch;

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * T::BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;          // mma group, thread in group
  const int wm = warp / T::WN, wn = warp % T::WN;
  const int wr0 = wm * T::WTM, wc0 = wn * T::WTN;  // warp tile origin

  Acc acc[T::MT][T::NT][4];
  for (int i = 0; i < T::MT; ++i)
    for (int j = 0; j < T::NT; ++j)
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nk = a.K / kBK;
  load_stage<T, R>(a, stages, m0, n0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    uint8_t* stage = stages + (kt & 1) * stage_bytes<T, R>();
    cp_async_wait_all();
    __syncthreads();   // step kt landed; everyone is done with step kt-1
    if (kt + 1 < nk) {
      load_stage<T, R>(a, stages + ((kt + 1) & 1) * stage_bytes<T, R>(), m0,
                       n0, (kt + 1) * kBK);
      cp_async_commit();
    }
    convert_stage<T, R, WBITS>(stage, wc, xc);
    __syncthreads();

    if constexpr (R::kS8) {
      for (int kk = 0; kk < kBK; kk += 32) {
        uint32_t af[T::MT][4];
        for (int i = 0; i < T::MT; ++i) {
          const uint8_t* r0 = stage + (wr0 + i * 16 + g) * R::kXPitch + kk +
                              4 * t;
          const uint8_t* r1 = r0 + 8 * R::kXPitch;
          af[i][0] = ld32(r0);
          af[i][1] = ld32(r1);
          af[i][2] = ld32(r0 + 16);
          af[i][3] = ld32(r1 + 16);
        }
        for (int j = 0; j < T::NT; ++j) {
          const uint8_t* b = wc + (wc0 + j * 8 + g) * R::kWcPitch + kk + 4 * t;
          const uint32_t b0 = ld32(b), b1 = ld32(b + 16);
          for (int i = 0; i < T::MT; ++i) mma_s8(acc[i][j], af[i], b0, b1);
        }
      }
    } else {
      for (int kk = 0; kk < kBK; kk += 16) {
        uint32_t bf[T::NT][2];
        for (int j = 0; j < T::NT; ++j) {
          const uint8_t* b =
              wc + (wc0 + j * 8 + g) * R::kWcPitch + 2 * (kk + 2 * t);
          bf[j][0] = ld32(b);
          bf[j][1] = ld32(b + 16);
        }
        constexpr int kTerms = R::kXTerms ? R::kXTerms : 1;
        for (int term = 0; term < kTerms; ++term) {
          const uint8_t* xt;
          int pitch;
          if constexpr (R::kXTerms) {
            xt = xc + term * T::BM * R::kXcPitch;
            pitch = R::kXcPitch;
          } else {
            xt = stage;
            pitch = R::kXPitch;
          }
          for (int i = 0; i < T::MT; ++i) {
            const uint8_t* r0 =
                xt + (wr0 + i * 16 + g) * pitch + 2 * (kk + 2 * t);
            const uint8_t* r1 = r0 + 8 * pitch;
            uint32_t af[4] = {ld32(r0), ld32(r1), ld32(r0 + 16),
                              ld32(r1 + 16)};
            for (int j = 0; j < T::NT; ++j)
              mma_bf16(acc[i][j], af, bf[j][0], bf[j][1]);
          }
        }
      }
    }
  }

  // epilogue: scale(s), cast, rows past M dropped
  Out* out = static_cast<Out*>(a.out);
  const float xs = R::kS8 ? *a.x_scale : 1.0f;
  for (int j = 0; j < T::NT; ++j) {
    const int n = n0 + wc0 + j * 8 + 2 * t;
    const float s0 = a.scale[n * a.scale_stride];
    const float s1 = a.scale[(n + 1) * a.scale_stride];
    for (int i = 0; i < T::MT; ++i) {
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wr0 + i * 16 + g + 8 * half;
        if (m >= a.M) continue;
        float v0, v1;
        if constexpr (R::kS8) {
          v0 = static_cast<float>(acc[i][j][2 * half]) * xs * s0;
          v1 = static_cast<float>(acc[i][j][2 * half + 1]) * xs * s1;
        } else {
          v0 = acc[i][j][2 * half] * s0;
          v1 = acc[i][j][2 * half + 1] * s1;
        }
        store2<Out>(out + static_cast<size_t>(m) * a.N + n, v0, v1);
      }
    }
  }
}

template <class T, int XK, int WBITS, class Out>
int launch_tile(const Args& a, void* stream) {
  using R = Reader<XK, WBITS>;
  auto kernel = qmm_kernel<T, XK, WBITS, Out>;
  constexpr int smem = smem_bytes<T, R>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.N / kBN, (a.M + T::BM - 1) / T::BM);
  kernel<<<grid, T::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The small tile for decode-sized M, the large one otherwise.
template <int XK, int WBITS, class Out>
int launch(const Args& a, void* stream) {
  if (a.M <= 0 || a.N % kBN || a.K % kBK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.M <= 32) return launch_tile<SmallTile, XK, WBITS, Out>(a, stream);
  return launch_tile<LargeTile, XK, WBITS, Out>(a, stream);
}

Args make_args(const void* x, const void* w, const void* scale,
               const void* x_scale, void* out, int M, int N, int K,
               int scale_stride) {
  Args a;
  a.x = static_cast<const uint8_t*>(x);
  a.w = static_cast<const uint8_t*>(w);
  a.scale = static_cast<const float*>(scale);
  a.x_scale = static_cast<const float*>(x_scale);
  a.out = out;
  a.M = M;
  a.N = N;
  a.K = K;
  a.scale_stride = scale_stride;
  return a;
}

}  // namespace

extern "C" {

const char* qmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// W8A16 (bits 8: w (K, N) int8) and W4A16 (bits 4: w (K/2, N) int8, two
// codes per byte along K). x (M, K) bf16 (x_f32 0) or fp32 (x_f32 1);
// scale fp32, (N,) with scale_stride 1 or (1,) with 0; out (M, N) of x's
// type. K and N multiples of 64. Returns cudaGetLastError().
int qmm_wa16(const void* x, const void* w, const void* scale, void* out,
             int M, int N, int K, int scale_stride, int x_f32, int bits,
             void* stream) {
  const Args a = make_args(x, w, scale, nullptr, out, M, N, K, scale_stride);
  if (bits == 8)
    return x_f32 ? launch<kXF32, 8, float>(a, stream)
                 : launch<kXBf16, 8, __nv_bfloat16>(a, stream);
  if (bits == 4)
    return x_f32 ? launch<kXF32, 4, float>(a, stream)
                 : launch<kXBf16, 4, __nv_bfloat16>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// W8A8: x_q (M, K) int8, x_scale () fp32, w_q (K, N) int8, w_scale as
// qmm_wa16's scale; out (M, N) bf16 (out_f32 0) or fp32 (out_f32 1).
int qmm_w8a8(const void* x_q, const void* x_scale, const void* w_q,
             const void* w_scale, void* out, int M, int N, int K,
             int scale_stride, int out_f32, void* stream) {
  const Args a =
      make_args(x_q, w_q, w_scale, x_scale, out, M, N, K, scale_stride);
  return out_f32 ? launch<kXI8, 8, float>(a, stream)
                 : launch<kXI8, 8, __nv_bfloat16>(a, stream);
}

}  // extern "C"
