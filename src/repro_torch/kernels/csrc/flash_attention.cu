// Flash attention forward over dense K/V, written by hand for Hopper
// (sm_90a): the whole-prompt prefill of every sequence of 2048 tokens or
// more.
//
// Replaces the Pallas TPU kernel in src/repro/kernels/flash_attention.py:
//   flash_fwd_bf16  <- flash_attention_fwd (_flash_kernel)
//
// What it computes: q (B, S, H, hd), k and v (B, T, K, hd), all bf16, H =
// K*G (query head h = k*G + g reads kv head k); out (B, S, H, hd) bf16 =
// softmax(mask(softcap(q k^T * hd**-0.5))) v with the mask key j <= query i
// when causal and j > i - window when window > 0 (causal = 0 is full
// attention; the window applies either way, as in the Pallas kernel).
//
// What bounds it on this card: the operations. At causal S = 4096,
// hd = 256, 8 query heads it does 4*hd flops per valid (head, key) pair,
// 68.7 GFLOP, against 84 MB of q, k, v and out: ~800 flop per byte, far
// above the card's ~295 flop/byte ridge.
//
// What the design does about it:
//   * the products run on the tensor cores, mma.sync m16n8k16 bf16 x bf16
//     into fp32: S = q k^T from the bf16 inputs as they are, and P v with
//     the probabilities rounded to bf16 (the one rounding the Pallas
//     kernel's fp32 P v does not have: up to 2**-9 of each weight, and the
//     row sum l is taken over the rounded weights, so the output stays a
//     convex combination of v rows);
//   * one CTA owns one BM = 128-row tile of the fused (S*G) query rows of
//     one (sequence, kv head) pair, row r = s*G + g at position s, so each
//     K/V tile is loaded once for all G heads that share it and the rows of
//     a tile span only 128/G positions (a tighter causal range than the
//     Pallas tile's (G, bq) fusion);
//   * K/V stream through a two-stage cp.async ring of 64-key tiles; the
//     Pallas kernel kept the group's whole (T, hd) K/V stream resident in
//     VMEM (8 MiB at T = 8192, hd = 256), a block here has 227 KB: the
//     q tile (66 KB at hd = 256) and two K+V stages (132 KB) fit;
//   * each CTA loops over the kv tiles its rows need, from lo (the first
//     row's window start) to hi (the last row's diagonal), so kv tiles above
//     the diagonal or below the window are skipped; the mask is evaluated
//     only on tiles that cross the diagonal, the window edge or T;
//   * each of the 8 warps owns 16 rows and keeps their fp32 (m, l, acc)
//     online-softmax state in registers; the CTAs with the longest kv range
//     (the last row tiles) are launched first.
// wgmma, TMA and a deeper ring are later work.
//
// Semantics kept from the reference: the scale multiplies the fp32 score
// (q k^T) * hd**-0.5, which equals the Pallas kernel's (q * hd**-0.5) k^T
// exactly when hd**-0.5 is a power of two (hd = 64, 256) and within an
// fp32 rounding otherwise (hd = 32, 128); softcap cap*tanh(s/cap) before the
// mask; masked scores -1e30 and m starting at -1e30 (not -inf), so a kv
// tile wholly masked for a row that meets it first gives exp(0) weights
// that the first valid tile's correction exp(-1e30 - m) = 0 wipes, as in
// the reference; l clamped at 1e-30; the output rounded to bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kBN = 64;       // keys per kv tile
constexpr int kWarps = 8;     // 16 query rows each
constexpr int kBM = 16 * kWarps;
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;       // bf16 padding per shared row (16 B)

template <int HD>
struct Smem {
  static constexpr int kPitch = HD + kPad;          // elements per row
  static constexpr int kTile = kBN * kPitch;        // one K or V tile
  static constexpr int kBytes = (kBM * kPitch + 2 * 2 * kTile) * 2;
};

struct Args {
  const __nv_bfloat16* q;   // (B, S, H, hd)
  const __nv_bfloat16* k;   // (B, T, K, hd)
  const __nv_bfloat16* v;
  __nv_bfloat16* out;       // (B, S, H, hd)
  int S, T, H, K, causal, window;
  float cap, scale;
};

// grid (B*K, row tiles), kThreads threads. Fragment names follow the PTX
// m16n8k16 layouts: lane = 4*gid + tig; a C fragment holds rows gid and
// gid+8, columns 2*tig and 2*tig+1 of its 16x8 tile.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const Args a) {
  using L = Smem<HD>;
  constexpr int P = L::kPitch;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* kv_s = q_s + kBM * P;   // stage i: K tile, then V tile

  const int G = a.H / a.K;
  const int rows = a.S * G;                  // fused query rows
  const int tile = gridDim.y - 1 - blockIdx.y;   // longest ranges first
  const int b = blockIdx.x / a.K, kh = blockIdx.x % a.K;
  const int R0 = tile * kBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;

  // kv tiles the rows need: the first row's window start to the last
  // row's diagonal
  const int s_first = R0 / G;
  const int s_last = (min(R0 + kBM, rows) - 1) / G;
  int hi = (a.T - 1) / kBN;
  if (a.causal) hi = min(hi, s_last / kBN);
  const int lo = a.window ? max(s_first - a.window + 1, 0) / kBN : 0;

  constexpr int kChunks = HD / 8;            // 16-B copies per row
  for (int i = threadIdx.x; i < kBM * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const int R = R0 + r;
    const bool valid = R < rows;             // rows past S*G: zeros
    const size_t off =
        valid ? ((size_t)(b * a.S + R / G) * a.H + kh * G + R % G) * HD + c * 8
              : 0;
    cp_async16(q_s + r * P + c * 8, a.q + off, valid);
  }
  auto issue = [&](int j, int stage) {
    __nv_bfloat16* ks = kv_s + stage * 2 * L::kTile;
    __nv_bfloat16* vs = ks + L::kTile;
    for (int i = threadIdx.x; i < kBN * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const int key = j * kBN + r;
      const bool valid = key < a.T;          // keys past T: zeros, masked
      const size_t off =
          valid ? ((size_t)(b * a.T + key) * a.K + kh) * HD + c * 8 : 0;
      cp_async16(ks + r * P + c * 8, a.k + off, valid);
      cp_async16(vs + r * P + c * 8, a.v + off, valid);
    }
  };

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  const int r_top = warp * 16 + gid;         // this thread's rows: r_top, +8
  const int qpos[2] = {(R0 + r_top) / G, (R0 + r_top + 8) / G};

  if (lo <= hi) issue(lo, 0);
  cp_async_commit();
  for (int j = lo; j <= hi; ++j) {
    const int stage = (j - lo) & 1;
    cp_async_wait_all();
    __syncthreads();   // tile j landed; everyone is done with tile j-1
    if (j + 1 <= hi) {
      issue(j + 1, stage ^ 1);
      cp_async_commit();
    }
    const __nv_bfloat16* ks = kv_s + stage * 2 * L::kTile;
    const __nv_bfloat16* vs = ks + L::kTile;

    // s = q k^T over hd, 16 rows x 64 keys per warp
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

    // scale, softcap, then the mask where this tile crosses the diagonal,
    // the window edge or T
    const int k0 = j * kBN;
    const bool need_mask = k0 + kBN > a.T ||
                           (a.causal && k0 + kBN - 1 > s_first) ||
                           (a.window && k0 <= s_last - a.window);
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * a.scale;
        if (a.cap != 0.f) x = a.cap * tanhf(x / a.cap);
        if (need_mask) {
          const int key = k0 + n * 8 + 2 * tig + (e & 1);
          const int qp = qpos[e >> 1];
          bool valid = key < a.T;
          if (a.causal) valid = valid && key <= qp;
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

    // P in bf16: two adjacent 8-key C fragments are one A fragment
#pragma unroll
    for (int kt = 0; kt < kBN / 16; ++kt) {
      uint32_t pa[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* c = s[2 * kt + half];
        const __nv_bfloat162 p01 = __floats2bfloat162_rn(
            expf(c[0] - mx[0]), expf(c[1] - mx[0]));
        const __nv_bfloat162 p23 = __floats2bfloat162_rn(
            expf(c[2] - mx[1]), expf(c[3] - mx[1]));
        const float2 f01 = __bfloat1622float2(p01);
        const float2 f23 = __bfloat1622float2(p23);
        l[0] += f01.x + f01.y;
        l[1] += f23.x + f23.y;
        pa[2 * half] = *reinterpret_cast<const uint32_t*>(&p01);
        pa[2 * half + 1] = *reinterpret_cast<const uint32_t*>(&p23);
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
        a.out + ((size_t)(b * a.S + R / G) * a.H + kh * G + R % G) * HD +
        2 * tig;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * h] / lsum,
                                acc[n][2 * h + 1] / lsum);
  }
}

template <int HD>
int launch(const Args& a, int B, void* stream) {
  const int tiles = (a.S * (a.H / a.K) + kBM - 1) / kBM;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = Smem<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_kernel<HD><<<dim3(B * a.K, tiles), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q/out (B, S, H, hd) bf16; k/v (B, T, K, hd) bf16, all contiguous and
// 16-B aligned; hd in {32, 64, 128, 256}; H a multiple of K; causal 0 or 1;
// window 0 (none) or the local window; cap 0 (none) or the softcap.
// Returns cudaGetLastError().
int flash_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int T, int H, int K, int hd, int causal,
                   int window, float cap, void* stream) {
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.S = S;
  a.T = T;
  a.H = H;
  a.K = K;
  a.causal = causal;
  a.window = window;
  a.cap = cap;
  // hd**-0.5 rounded once to fp32, as the reference multiplies by it
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  if (B <= 0 || S <= 0 || T <= 0 || K <= 0 || H % K)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd == 32) return launch<32>(a, B, stream);
  if (hd == 64) return launch<64>(a, B, stream);
  if (hd == 128) return launch<128>(a, B, stream);
  if (hd == 256) return launch<256>(a, B, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
