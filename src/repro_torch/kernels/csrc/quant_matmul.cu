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
// Three kernels. The wrapper picks one by x's dtype alone.
//
// wq_kernel: bf16 x, W8A16 and W4A16 — what the engine runs. One wgmma
// product for both regimes, out^T = W^T x^T:
//   * a CTA is one warpgroup (128 threads) owning 64*MT output channels
//     (MT = 2 when N is a multiple of 128, else 1) by BT tokens. The
//     tokens sit on wgmma's N axis, so one kernel serves a decode tick
//     (BT = 8 at M <= 8) and a 4096-row chunk (BT = 128) at two widths:
//     m64nBTk16, MT products per 16-deep step;
//   * the weight tile is wgmma's A operand from registers. Each thread
//     reads its rows' codes from shared memory as stored (one 32-bit load
//     gives four channels of one k, or of one packed k pair) and converts
//     them in registers, exactly (|code| <= 127): int8 through the fp32
//     magic number 2**23 (a byte permute and a subtraction, then the top
//     halves of two floats as one bf16x2), int4 through the bf16 magic
//     number 128 (each nibble, biased by 8, is the mantissa of 136 + code,
//     then one bf16x2 subtraction). No shared-memory conversion pass and
//     no barrier for it. Thread (warp w, row group g) owns the 2*MT
//     consecutive channels 2*MT*(8w + g) + (0 .. 2*MT-1), row g of tile t
//     taking channel 2t and row g+8 channel 2t+1, so its loads are whole
//     words and its epilogue stores 2*MT outputs at once;
//   * the x tile (BT tokens x 64 k, bf16, 128-byte rows) is the B operand
//     in shared memory, K-major under the 128-byte swizzle that the TMA
//     copy writes; rows past M are the copy's zero fill;
//   * a ring of 4 stages (6 for BT <= 32, where a CTA streams codes and
//     little else) is fed by TMA (cp.async.bulk.tensor, 2-D tensor maps
//     encoded per call) on one mbarrier per stage: x at 2 bytes and codes
//     at their stored width, 1 byte or half a byte per weight, so the
//     codes cross device memory once per token tile. One thread issues a
//     stage's two copies after every thread has passed the wgmma wait of
//     the step that last read it;
//   * each 16-deep step is its own wgmma group, up to 3 in flight: a
//     step's codes are converted while the three steps before it run on
//     the tensor cores. wgmma reads A from the registers while it runs,
//     so a fragment is rewritten only after the group that read it is
//     done (a wait, and the old registers held live past it, or the
//     compiler may reuse them while the product still reads them);
//   * at M = 4096 a CTA's 128 x 128 tile re-reads x N/128 times (72 at N =
//     9216; a 128 x 64 tile would read it 144 times) and the codes M/128
//     times;
//   * split-K at decode: where (N / 64 MT) * ceil(M / BT) CTAs are fewer
//     than the card's 132 SMs, the wrapper (kernels/quant_matmul.py::
//     qmm_splits) splits the K steps into n_split equal chunks (n_split
//     divides K/64) so that the grid has at least 132 CTAs. Each writes
//     fp32 partials to a scratch (n_split, M, N) that the wrapper
//     allocates; splitk_reduce_kernel sums them in split order (no
//     atomics: deterministic), applies the scale and rounds to bf16;
//   * accumulation in fp32 in the tensor cores; the scale and the cast in
//     the epilogue (or the reduce).
// What bounds each regime: a decode tick reads 1 or 0.5 byte per weight
// and does 2*M flops on it, so the codes' bytes; the split spreads them
// over at least 132 CTAs. A 4096-row chunk does 2*4096 flops per weight,
// so the tensor cores' rate; the 128 x 128 tile, the TMA ring and the
// register-side conversion keep them fed.
//
// w8a8_kernel: int8 x, W8A8 — what HAQ's activation-quantized layers run
// (the dot hook at a_bits <= 8). wq_kernel's product carried over to
// integers, out^T = W^T x^T on one s8 wgmma, m64nBTk32 into int32:
//   * the same CTA (one warpgroup, 64*MT channels by BT tokens, BT from
//     token_tile(M)), the same TMA ring on mbarriers and the same split-K
//     plan (qmm_splits);
//   * the codes are wgmma's A operand from registers, as stored: 8-bit
//     wgmma takes K-major operands only, the codes are stored (K, N) and
//     TMA does not transpose, so each thread reads four k rows of its
//     2*MT channels (one 32-bit load a row: four channels of one k, under
//     the tile's swizzle) and turns them with a 4x4 byte transpose
//     (__byte_perm) into one register per channel holding four k — the
//     m64k32 8-bit A fragment (row gid: k 4*tig..+3 and 16+4*tig..+3; row
//     gid+8 the same). No conversion: int8 is wgmma's own type;
//   * x (BT tokens x 64 k, int8) is the B operand in shared memory,
//     K-major in 64-byte rows under the 64-byte swizzle that the TMA copy
//     writes (8-row groups 512 B apart; the second k32 product starts 32 B
//     into the rows); rows past M are the copy's zero fill;
//   * each k32 product is its own wgmma group, one in flight while the
//     next fragment is formed; a fragment is rewritten only after the
//     group that read it is done, its old registers held live past the
//     wait (as wq_kernel);
//   * the int32 accumulator is exact (|acc| <= K * 127 * 127, 1.5e8 at K =
//     9216, far below 2**31: no .satfinite). Unsplit, the epilogue rescales
//     (float(acc) * x_scale) * w_scale[n]; split, each CTA writes int32
//     partials to an (n_split, M, N) scratch and splitk_reduce_s32_kernel
//     sums them (exact in any order; split order) and rescales in the same
//     order, so an fp32 output is bit-identical to the plain version at
//     every split count.
// What bounds it: at decode the codes' bytes (as W8A16); at a 4096-row
// chunk the operations over the int8 tensor cores' rate, twice bf16's.
//
// qmm_kernel (the mma.sync template): fp32 x through W8A16/W4A16.
//   * each CTA owns a BM x 64 output tile and walks K in 64-deep steps; x
//     and the stored weight tile stream through a two-stage ring of 16-B
//     cp.async copies; each step converts the staged weight tile once, in
//     shared memory, into (n, k) bf16 codes;
//   * mma.sync on the tensor cores: the fp32 x tile is split once into
//     three bf16 terms (x = x0 + x1 + x2 exactly), each multiplied by the
//     exact codes, so x loses nothing to bf16 and only the tensor cores'
//     fp32 accumulation (which may drop up to an ulp of the running sum
//     per step) separates the result from an fp32 product;
//   * 128 x 64 tiles with 8 warps for M > 32, 16 x 64 with 4 warps below.
// The engine does not run this case (the model computes in bf16); moving
// it to wgmma is later work. The TPU kernels carried the accumulator
// across a sequential K grid axis in VMEM; here the K loop runs inside the
// CTA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBK = 64;       // K per step
constexpr int kBN = 64;       // output columns per CTA

template <int BM_, int WM_, int WN_>
struct Tile {
  static constexpr int BM = BM_, WM = WM_, WN = WN_;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int WTM = BM / WM, WTN = kBN / WN;  // one warp's tile
  static constexpr int MT = WTM / 16, NT = WTN / 8;     // mma tiles per warp
};
using LargeTile = Tile<128, 4, 2>;   // 256 threads, 32 x 32 per warp
using SmallTile = Tile<16, 1, 4>;    // 128 threads, 16 x 16 per warp

// The operand reader: the weight bits fix the staged tile sizes; x is
// fp32, split into three bf16 terms.
template <int WBITS>
struct Reader {
  static constexpr int kXBytes = 4;
  static constexpr int kXTerms = 3;                    // split x tiles
  static constexpr int kWRows = WBITS == 4 ? kBK / 2 : kBK;  // stored rows
  static constexpr int kXPitch = kBK * kXBytes + 16;   // staged x row, bytes
  static constexpr int kWcPitch = (kBK + 8) * 2;       // bytes
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

struct Args {
  const uint8_t* x;       // (M, K) fp32
  const uint8_t* w;       // (K, N) int8, or (K/2, N) packed int4
  const float* scale;     // (N,) or (1,) fp32: w scale
  float* out;             // (M, N) fp32
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
// weight tile as (n, k) bf16 codes, the x tile split into three bf16
// terms.
template <class T, class R, int WBITS>
__device__ __forceinline__ void convert_stage(const uint8_t* stage,
                                              uint8_t* wc, uint8_t* xc) {
  const uint8_t* ws = stage + T::BM * R::kXPitch;
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
  // x = x0 + x1 + x2 exactly: each term is the bf16 rounding of what the
  // earlier terms leave, and each remainder is exact in fp32
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

// The tiled product. grid (N / 64, ceil(M / BM)); T::kThreads threads.
template <class T, int WBITS>
__global__ void __launch_bounds__(T::kThreads)
    qmm_kernel(const Args a) {
  using R = Reader<WBITS>;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* stages = smem;
  uint8_t* wc = smem + 2 * stage_bytes<T, R>();
  uint8_t* xc = wc + kBN * R::kWcPitch;

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * T::BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;          // mma group, thread in group
  const int wm = warp / T::WN, wn = warp % T::WN;
  const int wr0 = wm * T::WTM, wc0 = wn * T::WTN;  // warp tile origin

  float acc[T::MT][T::NT][4];
  for (int i = 0; i < T::MT; ++i)
    for (int j = 0; j < T::NT; ++j)
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

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

    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t bf[T::NT][2];
      for (int j = 0; j < T::NT; ++j) {
        const uint8_t* b =
            wc + (wc0 + j * 8 + g) * R::kWcPitch + 2 * (kk + 2 * t);
        bf[j][0] = ld32(b);
        bf[j][1] = ld32(b + 16);
      }
      for (int term = 0; term < R::kXTerms; ++term) {
        const uint8_t* xt = xc + term * T::BM * R::kXcPitch;
        for (int i = 0; i < T::MT; ++i) {
          const uint8_t* r0 =
              xt + (wr0 + i * 16 + g) * R::kXcPitch + 2 * (kk + 2 * t);
          const uint8_t* r1 = r0 + 8 * R::kXcPitch;
          uint32_t af[4] = {ld32(r0), ld32(r1), ld32(r0 + 16),
                            ld32(r1 + 16)};
          for (int j = 0; j < T::NT; ++j)
            mma_bf16(acc[i][j], af, bf[j][0], bf[j][1]);
        }
      }
    }
  }

  // epilogue: scale, rows past M dropped
  for (int j = 0; j < T::NT; ++j) {
    const int n = n0 + wc0 + j * 8 + 2 * t;
    const float s0 = a.scale[n * a.scale_stride];
    const float s1 = a.scale[(n + 1) * a.scale_stride];
    for (int i = 0; i < T::MT; ++i) {
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wr0 + i * 16 + g + 8 * half;
        if (m >= a.M) continue;
        *reinterpret_cast<float2*>(a.out + static_cast<size_t>(m) * a.N +
                                   n) =
            make_float2(acc[i][j][2 * half] * s0,
                        acc[i][j][2 * half + 1] * s1);
      }
    }
  }
}

template <class T, int WBITS>
int launch_tile(const Args& a, void* stream) {
  using R = Reader<WBITS>;
  auto kernel = qmm_kernel<T, WBITS>;
  constexpr int smem = smem_bytes<T, R>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.N / kBN, (a.M + T::BM - 1) / T::BM);
  kernel<<<grid, T::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The small tile for decode-sized M, the large one otherwise.
template <int WBITS>
int launch(const Args& a, void* stream) {
  if (a.M <= 0 || a.N % kBN || a.K % kBK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.M <= 32) return launch_tile<SmallTile, WBITS>(a, stream);
  return launch_tile<LargeTile, WBITS>(a, stream);
}


// ------------------------------------------- wgmma path: bf16 x (wq_*) --
constexpr int kWgThreads = 128;   // one warpgroup
constexpr int kWgK = 64;          // K per ring stage (one TMA box of x)

template <int MT, int BT, int WBITS>
struct WgLayout {
  static constexpr int kBC = 64 * MT;                  // channels a CTA
  static constexpr int kXTile = BT * kWgK * 2;         // bf16, 128-B rows
  static constexpr int kWRows = WBITS == 4 ? kWgK / 2 : kWgK;  // stored
  static constexpr int kWTile = kWRows * kBC;
  static constexpr int kStage = kXTile + kWTile;
  static constexpr int kStages = BT >= 64 ? 4 : 6;
  // the ring, its barriers, and slack to align the ring to 1024 B (the
  // 128-byte swizzle's period)
  static constexpr int kBytes = kStages * kStage + 8 * kStages + 1024;
  static_assert(kXTile % 1024 == 0 && kWTile % 1024 == 0, "wq layout");
};

struct WqArgs {
  const float* scale;   // (N,) or (1,)
  __nv_bfloat16* out;   // (M, N), written when n_split == 1
  float* part;          // (n_split, M, N) fp32 partials otherwise
  int M, N, K, scale_stride, n_split;
};

// Byte offset `off` of a code tile of BC-byte rows as TMA's swizzle
// stores it: 128-byte rows (BC = 128) XOR address bits 4-6 with 7-9,
// 64-byte rows (BC = 64) bits 4-5 with 7-8.
template <int BC>
__device__ __forceinline__ uint32_t swizzled(uint32_t off) {
  return BC == 128 ? off ^ ((off >> 3) & 0x70) : off ^ ((off >> 3) & 0x30);
}

// 2*MT codes (bytes) of stored row `row` at the thread's channels `cb`.
template <int MT>
__device__ __forceinline__ uint32_t load_codes(const uint8_t* tile, int row,
                                               int cb) {
  const uint32_t off = swizzled<64 * MT>(row * 64 * MT + cb);
  if constexpr (MT == 2) return *reinterpret_cast<const uint32_t*>(tile + off);
  return *reinterpret_cast<const uint16_t*>(tile + off);
}

// Byte j of four int8 codes (pre-XORed with 0x80: c + 128) as an fp32:
// the bits 0x4B0000?? are 2**23 + c + 128, exact.
__device__ __forceinline__ float code8(uint32_t biased, int j) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7650 | j)) -
         8388736.0f;
}

// Two fp32 integers of at most 8 significant bits as one bf16x2 (lo in
// the low half): their top halves, exact.
__device__ __forceinline__ uint32_t pack_hi(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Byte j of a packed int4 word as bf16x2 (low nibble: row 2i, in the low
// half; high nibble: row 2i+1): each nibble XOR 8 is code + 8 in [0, 15],
// the mantissa of 128 + code + 8 in bf16 (0x4300 | code + 8), less 136.
__device__ __forceinline__ uint32_t code4x2(uint32_t word, int j) {
  const uint32_t t = word >> (8 * j);
  uint32_t v = ((t & 0xFu) | ((t << 12) & 0xF0000u)) ^ 0x43084308u;
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  h = __hsub2(h, __floats2bfloat162_rn(136.0f, 136.0f));
  return *reinterpret_cast<uint32_t*>(&h);
}

// grid (N / (64 MT), ceil(M / BT), n_split), kWgThreads threads.
template <int MT, int BT, int WBITS>
__global__ void __launch_bounds__(kWgThreads)
    wq_kernel(const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap wmap, const WqArgs a) {
  using L = WgLayout<MT, BT, WBITS>;
  constexpr int S = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * L::kStage);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int n0 = blockIdx.x * L::kBC, m0 = blockIdx.y * BT;
  const int steps = a.K / kWgK / a.n_split;    // this split's K steps
  const int step0 = blockIdx.z * steps;
  const int cb = 2 * MT * (8 * warp + gid);    // the thread's channels

  if (tid == 0) {
    for (int i = 0; i < S; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int i) {   // K step step0 + i into its stage
    uint8_t* st = ring + (i % S) * L::kStage;
    uint64_t* bar = &full[i % S];
    mbar_expect_tx(bar, L::kStage);
    tma_2d(st, &xmap, (step0 + i) * kWgK, m0, bar);
    tma_2d(st + L::kXTile, &wmap, n0, (step0 + i) * L::kWRows, bar);
  };
  if (tid == 0)
    for (int i = 0; i < S - 1 && i < steps; ++i) issue(i);

  float acc[MT][BT / 2];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int e = 0; e < BT / 2; ++e) acc[t][e] = 0.f;

  // Each K step is 4 16-deep steps, each its own wgmma group: convert
  // that step's codes into its A fragments af[kk] (af[kk][t] = rows gid,
  // gid+8 of tile t: channels cb+2t, cb+2t+1; k 2tig, +1 and 2tig+8, +9),
  // issue its MT products, commit. wgmma reads A from the registers while
  // it runs, so af[kk] is rewritten only after the group that last read
  // it (the previous K step's kk-th) is done: wait until at most 3 groups
  // are in flight, the old fragments held live past the wait. The
  // conversion of one 16-deep step thus overlaps the products of the
  // three before it.
  uint32_t af[4][MT][4] = {};
  for (int i = 0; i < steps; ++i) {
    mbar_wait(&full[i % S], (i / S) & 1);
    const uint8_t* xs = ring + (i % S) * L::kStage;
    const uint8_t* ws = xs + L::kXTile;
    const uint64_t desc = smem_desc<128>(xs);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t w[4];
      if constexpr (WBITS == 8) {
        const int r = 16 * kk + 2 * tig;
        w[0] = load_codes<MT>(ws, r, cb) ^ 0x80808080u;
        w[1] = load_codes<MT>(ws, r + 1, cb) ^ 0x80808080u;
        w[2] = load_codes<MT>(ws, r + 8, cb) ^ 0x80808080u;
        w[3] = load_codes<MT>(ws, r + 9, cb) ^ 0x80808080u;
      } else {
        const int p = 8 * kk + tig;    // packed rows: k pairs
        w[0] = load_codes<MT>(ws, p, cb);
        w[1] = load_codes<MT>(ws, p + 4, cb);
      }
      wgmma_wait<3>();
      hold<MT * 4>(&af[kk][0][0]);
#pragma unroll
      for (int t = 0; t < MT; ++t) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = 2 * t + h;
          if constexpr (WBITS == 8) {
            af[kk][t][h] = pack_hi(code8(w[0], j), code8(w[1], j));
            af[kk][t][2 + h] = pack_hi(code8(w[2], j), code8(w[3], j));
          } else {
            af[kk][t][h] = code4x2(w[0], j);
            af[kk][t][2 + h] = code4x2(w[1], j);
          }
        }
      }
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < MT; ++t)
        Wgmma<BT>::run(acc[t], af[kk][t], desc + 2 * kk);   // +32 B of k
      wgmma_commit();
    }
    // step i-1's groups are done (at most step i's first 3 in flight) in
    // every thread: its stage may be refilled
    __syncthreads();
    if (tid == 0 && i + S - 1 < steps) issue(i + S - 1);
  }
  wgmma_wait<0>();
  hold<4 * MT * 4>(&af[0][0][0]);
#pragma unroll
  for (int t = 0; t < MT; ++t) fence_acc<BT / 2>(acc[t]);

  // epilogue: acc[t][4j + 2h + c] is channel cb + 2t + h, token
  // m0 + 8j + 2tig + c
  const int n = n0 + cb;
  float sc[2 * MT];
#pragma unroll
  for (int c = 0; c < 2 * MT; ++c)
    sc[c] = a.n_split == 1 ? a.scale[(n + c) * a.scale_stride] : 1.f;
#pragma unroll
  for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int m = m0 + 8 * j + 2 * tig + c;
      if (m >= a.M) continue;
      float v[2 * MT];
#pragma unroll
      for (int t = 0; t < MT; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          v[2 * t + h] = acc[t][4 * j + 2 * h + c] * sc[2 * t + h];
      if (a.n_split == 1) {
        __nv_bfloat16* dst = a.out + static_cast<size_t>(m) * a.N + n;
        if constexpr (MT == 2) {
          *reinterpret_cast<uint2*>(dst) =
              make_uint2(bf16x2(v[0], v[1]), bf16x2(v[2], v[3]));
        } else {
          *reinterpret_cast<uint32_t*>(dst) = bf16x2(v[0], v[1]);
        }
      } else {
        float* dst = a.part +
                     (static_cast<size_t>(blockIdx.z) * a.M + m) * a.N + n;
        if constexpr (MT == 2) {
          *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2],
                                                        v[3]);
        } else {
          *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
        }
      }
    }
  }
}

// The split-K partials (n_split, M, N) summed in split order, times the
// scale, rounded to bf16: four outputs a thread.
__global__ void __launch_bounds__(256)
    splitk_reduce_kernel(const float* part, const float* scale,
                         int scale_stride, __nv_bfloat16* out, int M, int N,
                         int n_split) {
  const size_t e =
      (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  const size_t MN = static_cast<size_t>(M) * N;
  if (e >= MN) return;
  float4 s = *reinterpret_cast<const float4*>(part + e);
  for (int i = 1; i < n_split; ++i) {
    const float4 p = *reinterpret_cast<const float4*>(part + i * MN + e);
    s.x += p.x;
    s.y += p.y;
    s.z += p.z;
    s.w += p.w;
  }
  const int n = static_cast<int>(e % N);
  const float* sc = scale + static_cast<size_t>(n) * scale_stride;
  *reinterpret_cast<uint2*>(out + e) =
      make_uint2(bf16x2(s.x * sc[0], s.y * sc[scale_stride]),
                 bf16x2(s.z * sc[2 * scale_stride],
                        s.w * sc[3 * scale_stride]));
}

template <int MT, int BT, int WBITS>
int wq_launch(const void* x, const void* w, const WqArgs& a,
              cudaStream_t stream) {
  using L = WgLayout<MT, BT, WBITS>;
  CUtensorMap xmap, wmap;
  if (!encode_2d(&xmap, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.M, a.K,
                 BT, kWgK, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_2d(&wmap, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                 a.K / kWgK * L::kWRows, a.N, L::kWRows, L::kBC,
                 MT == 2 ? CU_TENSOR_MAP_SWIZZLE_128B
                         : CU_TENSOR_MAP_SWIZZLE_64B))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = wq_kernel<MT, BT, WBITS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.N / L::kBC, (a.M + BT - 1) / BT, a.n_split);
  kernel<<<grid, kWgThreads, L::kBytes, stream>>>(xmap, wmap, a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return static_cast<int>(err);
  const size_t quads = static_cast<size_t>(a.M) * a.N / 4;
  splitk_reduce_kernel<<<static_cast<unsigned>((quads + 255) / 256), 256, 0,
                         stream>>>(a.part, a.scale, a.scale_stride, a.out,
                                   a.M, a.N, a.n_split);
  return static_cast<int>(cudaGetLastError());
}

// The token tile: the least of 8, 16, 32, 64 that holds M, else 128
// (kernels/quant_matmul.py::token_tile).
template <int MT, int WBITS>
int wq_tokens(const void* x, const void* w, const WqArgs& a,
              cudaStream_t stream) {
  if (a.M <= 8) return wq_launch<MT, 8, WBITS>(x, w, a, stream);
  if (a.M <= 16) return wq_launch<MT, 16, WBITS>(x, w, a, stream);
  if (a.M <= 32) return wq_launch<MT, 32, WBITS>(x, w, a, stream);
  if (a.M <= 64) return wq_launch<MT, 64, WBITS>(x, w, a, stream);
  return wq_launch<MT, 128, WBITS>(x, w, a, stream);
}

template <int WBITS>
int wq_channels(const void* x, const void* w, const WqArgs& a,
                cudaStream_t stream) {
  if (a.N % 128 == 0) return wq_tokens<2, WBITS>(x, w, a, stream);
  return wq_tokens<1, WBITS>(x, w, a, stream);
}

// ----------------------------------------- wgmma path: int8 x (w8a8_*) --
// One stage: the code tile (64 k rows x 64*MT channels, at offset 0, under
// the 128- or 64-byte swizzle as wq_kernel's), then the x tile (BT tokens
// x 64 k, 64-byte rows under the 64-byte swizzle), padded to 1024 B so
// that every stage's code tile stays on the swizzle's 1024-B period.
template <int MT, int BT>
struct S8Layout {
  static constexpr int kBC = 64 * MT;                  // channels a CTA
  static constexpr int kWTile = kWgK * kBC;
  static constexpr int kXBytes = BT * kWgK;            // int8, 64-B rows
  static constexpr int kXTile = (kXBytes + 1023) / 1024 * 1024;
  static constexpr int kStage = kWTile + kXTile;
  static constexpr int kTx = kWTile + kXBytes;         // bytes a stage lands
  static constexpr int kStages = BT >= 64 ? 4 : 6;
  static constexpr int kBytes = kStages * kStage + 8 * kStages + 1024;
  static_assert(kWTile % 1024 == 0 && kStage % 1024 == 0, "s8 layout");
};

struct W8Args {
  const float* x_scale;   // () fp32
  const float* scale;     // (N,) or (1,) fp32: w scale
  void* out;              // (M, N) bf16 or fp32 (out_f32), n_split == 1
  int* part;              // (n_split, M, N) int32 partials otherwise
  int M, N, K, scale_stride, n_split, out_f32;
};

template <int N>
struct WgmmaS8;

// d (64 x N int32, the m64nN accumulator fragment) += a (64 x 32 int8,
// the thread's A fragment registers) * B (32 x N int8 at the descriptor).
template <>
struct WgmmaS8<8> {
  __device__ static void run(int* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct WgmmaS8<16> {
  __device__ static void run(int* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct WgmmaS8<32> {
  __device__ static void run(int* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct WgmmaS8<64> {
  __device__ static void run(int* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct WgmmaS8<128> {
  __device__ static void run(int* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

// The 8-bit A fragment of one k32 product from the code tile: rows
// k0 + 4*tig + i (i < 4) and 16 more give w[i] and w[4 + i], each the
// thread's 2*MT channels of one k (a 4x4 byte transpose turns them into
// one register per channel holding four k). af[t] = rows gid (channel
// cb + 2t) and gid + 8 (channel cb + 2t + 1): {row gid, k 4tig..4tig+3},
// {row gid+8, the same k}, {row gid, k 16+4tig..}, {row gid+8, k 16+..}.
template <int MT>
__device__ __forceinline__ void s8_fragment(const uint32_t* w,
                                            uint32_t (*af)[4]) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const uint32_t* r = w + 4 * q;
    // lo01 = (c0 of rows 0, 1; c1 of rows 0, 1), hi01 the same of c2, c3
    const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140);
    const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140);
    af[0][2 * q] = __byte_perm(lo01, lo23, 0x5410);       // channel cb
    af[0][2 * q + 1] = __byte_perm(lo01, lo23, 0x7632);   // cb + 1
    if constexpr (MT == 2) {
      const uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362);
      const uint32_t hi23 = __byte_perm(r[2], r[3], 0x7362);
      af[1][2 * q] = __byte_perm(hi01, hi23, 0x5410);     // cb + 2
      af[1][2 * q + 1] = __byte_perm(hi01, hi23, 0x7632); // cb + 3
    }
  }
}

// (float(acc) * x_scale) * w_scale: the plain version's order
__device__ __forceinline__ float rescale(int acc, float xs, float ws) {
  return __fmul_rn(__fmul_rn(static_cast<float>(acc), xs), ws);
}

// grid (N / (64 MT), ceil(M / BT), n_split), kWgThreads threads.
template <int MT, int BT>
__global__ void __launch_bounds__(kWgThreads)
    w8a8_kernel(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap wmap, const W8Args a) {
  using L = S8Layout<MT, BT>;
  constexpr int S = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * L::kStage);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int n0 = blockIdx.x * L::kBC, m0 = blockIdx.y * BT;
  const int steps = a.K / kWgK / a.n_split;    // this split's K steps
  const int step0 = blockIdx.z * steps;
  const int cb = 2 * MT * (8 * warp + gid);    // the thread's channels

  if (tid == 0) {
    for (int i = 0; i < S; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int i) {   // K step step0 + i into its stage
    uint8_t* st = ring + (i % S) * L::kStage;
    uint64_t* bar = &full[i % S];
    mbar_expect_tx(bar, L::kTx);
    tma_2d(st, &wmap, n0, (step0 + i) * kWgK, bar);
    tma_2d(st + L::kWTile, &xmap, (step0 + i) * kWgK, m0, bar);
  };
  if (tid == 0)
    for (int i = 0; i < S - 1 && i < steps; ++i) issue(i);

  int acc[MT][BT / 2];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int e = 0; e < BT / 2; ++e) acc[t][e] = 0;

  // Each K step is 2 k32 products, each its own wgmma group: form that
  // product's A fragments af[kk] from the codes, issue its MT products,
  // commit. af[kk] is rewritten only after the group that last read it
  // (the previous K step's kk-th) is done: wait until at most one group
  // is in flight, the old fragments held live past the wait.
  uint32_t af[2][MT][4] = {};
  for (int i = 0; i < steps; ++i) {
    mbar_wait(&full[i % S], (i / S) & 1);
    const uint8_t* ws = ring + (i % S) * L::kStage;
    const uint64_t desc = smem_desc<64>(ws + L::kWTile);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t w[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        w[r] = load_codes<MT>(ws, 32 * kk + 4 * tig + r, cb);
        w[4 + r] = load_codes<MT>(ws, 32 * kk + 16 + 4 * tig + r, cb);
      }
      wgmma_wait<1>();
      hold<MT * 4>(&af[kk][0][0]);
      s8_fragment<MT>(w, af[kk]);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < MT; ++t)
        WgmmaS8<BT>::run(acc[t], af[kk][t], desc + 2 * kk);   // +32 B of k
      wgmma_commit();
    }
    // step i-1's groups are done (at most step i's two in flight) in
    // every thread: its stage may be refilled
    __syncthreads();
    if (tid == 0 && i + S - 1 < steps) issue(i + S - 1);
  }
  wgmma_wait<0>();
  hold<2 * MT * 4>(&af[0][0][0]);
#pragma unroll
  for (int t = 0; t < MT; ++t) fence_acc<BT / 2>(acc[t]);

  // epilogue: acc[t][4j + 2h + c] is channel cb + 2t + h, token
  // m0 + 8j + 2tig + c
  const int n = n0 + cb;
  const float xs = *a.x_scale;
  float sc[2 * MT];
#pragma unroll
  for (int c = 0; c < 2 * MT; ++c) sc[c] = a.scale[(n + c) * a.scale_stride];
#pragma unroll
  for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int m = m0 + 8 * j + 2 * tig + c;
      if (m >= a.M) continue;
      const size_t row = static_cast<size_t>(m) * a.N + n;
      if (a.n_split > 1) {
        int* dst = a.part + static_cast<size_t>(blockIdx.z) * a.M * a.N + row;
        if constexpr (MT == 2) {
          *reinterpret_cast<int4*>(dst) =
              make_int4(acc[0][4 * j + c], acc[0][4 * j + 2 + c],
                        acc[1][4 * j + c], acc[1][4 * j + 2 + c]);
        } else {
          *reinterpret_cast<int2*>(dst) =
              make_int2(acc[0][4 * j + c], acc[0][4 * j + 2 + c]);
        }
        continue;
      }
      float v[2 * MT];
#pragma unroll
      for (int t = 0; t < MT; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          v[2 * t + h] = rescale(acc[t][4 * j + 2 * h + c], xs, sc[2 * t + h]);
      if (a.out_f32) {
        float* dst = static_cast<float*>(a.out) + row;
        if constexpr (MT == 2) {
          *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2],
                                                        v[3]);
        } else {
          *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
        }
      } else {
        __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(a.out) + row;
        if constexpr (MT == 2) {
          *reinterpret_cast<uint2*>(dst) =
              make_uint2(bf16x2(v[0], v[1]), bf16x2(v[2], v[3]));
        } else {
          *reinterpret_cast<uint32_t*>(dst) = bf16x2(v[0], v[1]);
        }
      }
    }
  }
}

// The int32 split-K partials (n_split, M, N) summed in split order (exact),
// rescaled as the plain version does, cast: four outputs a thread.
__global__ void __launch_bounds__(256)
    splitk_reduce_s32_kernel(const int* part, const float* x_scale,
                             const float* scale, int scale_stride, void* out,
                             int out_f32, int M, int N, int n_split) {
  const size_t e =
      (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  const size_t MN = static_cast<size_t>(M) * N;
  if (e >= MN) return;
  int4 s = *reinterpret_cast<const int4*>(part + e);
  for (int i = 1; i < n_split; ++i) {
    const int4 p = *reinterpret_cast<const int4*>(part + i * MN + e);
    s.x += p.x;
    s.y += p.y;
    s.z += p.z;
    s.w += p.w;
  }
  const int n = static_cast<int>(e % N);
  const float* sc = scale + static_cast<size_t>(n) * scale_stride;
  const float xs = *x_scale;
  const float v0 = rescale(s.x, xs, sc[0]);
  const float v1 = rescale(s.y, xs, sc[scale_stride]);
  const float v2 = rescale(s.z, xs, sc[2 * scale_stride]);
  const float v3 = rescale(s.w, xs, sc[3 * scale_stride]);
  if (out_f32) {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + e) =
        make_float4(v0, v1, v2, v3);
  } else {
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + e) =
        make_uint2(bf16x2(v0, v1), bf16x2(v2, v3));
  }
}

template <int MT, int BT>
int w8_launch(const void* x, const void* w, const W8Args& a,
              cudaStream_t stream) {
  using L = S8Layout<MT, BT>;
  CUtensorMap xmap, wmap;
  if (!encode_2d(&xmap, x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.M, a.K, BT,
                 kWgK, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !encode_2d(&wmap, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.K, a.N, kWgK,
                 L::kBC,
                 MT == 2 ? CU_TENSOR_MAP_SWIZZLE_128B
                         : CU_TENSOR_MAP_SWIZZLE_64B))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = w8a8_kernel<MT, BT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.N / L::kBC, (a.M + BT - 1) / BT, a.n_split);
  kernel<<<grid, kWgThreads, L::kBytes, stream>>>(xmap, wmap, a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return static_cast<int>(err);
  const size_t quads = static_cast<size_t>(a.M) * a.N / 4;
  splitk_reduce_s32_kernel<<<static_cast<unsigned>((quads + 255) / 256), 256,
                             0, stream>>>(a.part, a.x_scale, a.scale,
                                          a.scale_stride, a.out, a.out_f32,
                                          a.M, a.N, a.n_split);
  return static_cast<int>(cudaGetLastError());
}

// The token tile (kernels/quant_matmul.py::token_tile), then the channels.
template <int MT>
int w8_tokens(const void* x, const void* w, const W8Args& a,
              cudaStream_t stream) {
  if (a.M <= 8) return w8_launch<MT, 8>(x, w, a, stream);
  if (a.M <= 16) return w8_launch<MT, 16>(x, w, a, stream);
  if (a.M <= 32) return w8_launch<MT, 32>(x, w, a, stream);
  if (a.M <= 64) return w8_launch<MT, 64>(x, w, a, stream);
  return w8_launch<MT, 128>(x, w, a, stream);
}

}  // namespace

extern "C" {

const char* qmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// W8A16 (bits 8: w (K, N) int8) and W4A16 (bits 4: w (K/2, N) int8, two
// codes per byte along K) over bf16 x (M, K): the wgmma kernel. scale
// fp32, (N,) with scale_stride 1 or (1,) with 0; out (M, N) bf16. K and N
// multiples of 64, n_split dividing K/64; part: fp32 scratch of
// n_split*M*N floats when n_split > 1 (else unused). Launches the product
// and, split, the reduce on `stream`. Returns cudaGetLastError().
int qmm_wa16_bf16(const void* x, const void* w, const void* scale, void* out,
                  void* part, int M, int N, int K, int scale_stride, int bits,
                  int n_split, void* stream) {
  if (M <= 0 || N % 64 || K % kWgK || n_split <= 0 ||
      (K / kWgK) % n_split || (n_split > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  WqArgs a;
  a.scale = static_cast<const float*>(scale);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.part = static_cast<float*>(part);
  a.M = M;
  a.N = N;
  a.K = K;
  a.scale_stride = scale_stride;
  a.n_split = n_split;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits == 8) return wq_channels<8>(x, w, a, st);
  if (bits == 4) return wq_channels<4>(x, w, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// W8A16/W4A16 as qmm_wa16_bf16, over fp32 x (M, K) into an fp32 out: the
// mma.sync template (three bf16 terms of x).
int qmm_wa16_f32(const void* x, const void* w, const void* scale, void* out,
                 int M, int N, int K, int scale_stride, int bits,
                 void* stream) {
  Args a;
  a.x = static_cast<const uint8_t*>(x);
  a.w = static_cast<const uint8_t*>(w);
  a.scale = static_cast<const float*>(scale);
  a.out = static_cast<float*>(out);
  a.M = M;
  a.N = N;
  a.K = K;
  a.scale_stride = scale_stride;
  if (bits == 8) return launch<8>(a, stream);
  if (bits == 4) return launch<4>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// W8A8: x_q (M, K) int8, x_scale () fp32, w_q (K, N) int8, w_scale as
// qmm_wa16's scale; out (M, N) bf16 (out_f32 0) or fp32 (out_f32 1). The
// s8 wgmma kernel; K and N multiples of 64, n_split dividing K/64; part:
// int32 scratch of n_split*M*N when n_split > 1 (else unused). Launches
// the product and, split, the reduce on `stream`. Returns
// cudaGetLastError().
int qmm_w8a8(const void* x_q, const void* x_scale, const void* w_q,
             const void* w_scale, void* out, void* part, int M, int N, int K,
             int scale_stride, int out_f32, int n_split, void* stream) {
  if (M <= 0 || N % 64 || K % kWgK || n_split <= 0 ||
      (K / kWgK) % n_split || (n_split > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  W8Args a;
  a.x_scale = static_cast<const float*>(x_scale);
  a.scale = static_cast<const float*>(w_scale);
  a.out = out;
  a.part = static_cast<int*>(part);
  a.M = M;
  a.N = N;
  a.K = K;
  a.scale_stride = scale_stride;
  a.n_split = n_split;
  a.out_f32 = out_f32;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N % 128 == 0) return w8_tokens<2>(x_q, w_q, a, st);
  return w8_tokens<1>(x_q, w_q, a, st);
}

}  // extern "C"
