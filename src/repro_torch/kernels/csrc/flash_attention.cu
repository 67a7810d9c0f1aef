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
// above the card's ~295 flop/byte ridge. The softcap's tanh and the exp
// cost about as many issue slots as the products at hd = 256, so the
// design keeps the tensor cores busy while they run.
//
// What the design does about it:
//   * one CTA owns the G query heads of one (sequence, kv head) pair over
//     P = 128 / G positions (kernels/flash_attention.py::flash_plan): 128
//     fused rows, row r = p*G + g at position s0 + p (rows past P*G idle
//     when G does not divide 128), so each K/V tile is loaded once for the
//     whole group, as in the Pallas kernel;
//   * two consumer warpgroups of 64 rows each and nothing else: 256
//     threads, so that each may hold up to 255 registers (the 64 x hd fp32
//     P V accumulator alone is 128 a thread at hd 256). One thread, the
//     first of consumer 1, issues every TMA copy. A producer warp beside
//     them did not fit: ptxas compiles the whole kernel within its launch
//     bound, 168 registers a thread at 384 threads (and at 288, whose nine
//     warps put three on one of the SM's four register files), whatever
//     setmaxnreg asks for at run time, and then spills at hd 256 and
//     serializes the products at hd 128 and 256;
//   * TMA on mbarriers: q once, one 4-D box per 64-column chunk over q
//     viewed as (hd, H, S, B), box {64, G, P, 1} at head kh*G (positions
//     past S are the copy's zero fill); K and V into separate rings of
//     BN-key tiles (BN = 80 at hd 256, else 128), as deep as the shared
//     memory beside q allows (2 stages at hd 256, 3 at 128, 4 below), one
//     box {64, 1, BN, 1} per chunk over (hd, K, T, B); keys past T are zero
//     fill that the mask drops. Chunk rows are 128 bytes under the 128-byte
//     swizzle (hd 32: 64-byte rows under the 64-byte swizzle). Each
//     consumer releases a K and a V stage once its products are done, one
//     arrival per warpgroup on the stage's "empty" barrier; nothing in the
//     kv loop waits for the whole CTA;
//   * S = q K^T on wgmma m64nBNk16, both operands in shared memory,
//     K-major, fp32 accumulation;
//   * P V on wgmma m64n(hd)k16 with P from registers: the S accumulator's
//     fragment holds, per thread, column pairs (2tig, 2tig+1) of rows gid
//     and gid+8 in each 8-key block, which is exactly the bf16 A fragment
//     of a 16-key step (two blocks), so P is the S registers rounded to
//     bf16 pairwise in place, with no trip through shared memory. V is the
//     B operand as stored, (key, hd) rows, through the descriptor's
//     transpose bit: N-major, the 64-column chunks LBO apart and 8-key
//     groups SBO apart;
//   * ping-pong: the consumers take turns at the tensor cores on two named
//     barriers. A turn issues S of the next tile and P V of the previous
//     one, hands over, and waits for both before its softmax; while one
//     warpgroup's products run, the other applies its softcap, exp and
//     rescale. Overlapping a warpgroup's softmax with its own P V as well
//     (waiting for the S group alone first) made ptxas serialize every
//     product of the kernel (C7513): it does not count wait_group 1 as
//     retiring the earlier group;
//   * each CTA visits the kv tiles its rows need, from the first position's
//     window start to the last position's diagonal (flash_plan), masking
//     only tiles that cross the diagonal, the window edge or T; the last
//     row tiles (the longest causal ranges) are launched first.
// wgmma reads its A registers and the accumulators while it runs, so each
// consumer waits for its products before it touches S, O or P again.
//
// Semantics kept from the reference: the fp32 score is (q k^T) * hd**-0.5,
// which equals the Pallas kernel's (q * hd**-0.5) k^T exactly when
// hd**-0.5 is a power of two (hd = 64, 256) and within an fp32 rounding
// otherwise (hd = 32, 128); softcap cap*tanh(s/cap) before the mask
// (softcap2: tanh through one exp2 and one reciprocal, within 5e-5 of
// the score at a cap of 50); masked scores -1e30 and m starting at -1e30
// (not -inf), so a kv tile wholly masked for a row that meets it first
// gives exp(0) weights that the first valid tile's correction
// exp(-1e30 - m) = 0 wipes, as in the reference; P rounded to bf16 for its
// product (up to 2**-9 of each weight) and l summed over the rounded
// weights, so the output stays a convex combination of v rows; l clamped
// at 1e-30; o / l taken as o * (1 / l), within an fp32 ulp; the output
// rounded once to bf16. log2(e) is folded into the scale and the
// exponentials are ex2.approx (within 2**-22 relative).
//
// For the backward (models/flash.py), a launch may also ask for each row's
// log-sum-exp, (m + log2(l)) * ln 2 in natural units, written in the
// epilogue by one lane of each row's quad into lse (B, H, S) fp32. l sums
// the bf16-rounded weights, so the lse sits within about 2**-9 (one bf16
// rounding of each weight, the same sign at worst) of the plain version's
// m + log(l) over unrounded weights. A null lse writes nothing and leaves
// out as it was.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kBM = 128;        // fused query rows a CTA
constexpr int kThreads = 256;   // two consumer warpgroups
constexpr int kSmem = 232448;   // shared memory a CTA may hold

template <int HD>
struct Layout {
  static constexpr int kBN = HD == 256 ? 80 : 128;  // keys a kv tile
  static constexpr int kSW = HD == 32 ? 64 : 128;   // bytes a chunk row
  static constexpr int kCols = kSW / 2;             // hd columns a chunk
  static constexpr int kChunks = HD / kCols;
  static constexpr int kQChunk = kBM * kSW;
  static constexpr int kKVChunk = kBN * kSW;
  static constexpr int kQ = kChunks * kQChunk;      // the q tile, bytes
  static constexpr int kKV = kChunks * kKVChunk;    // one K or V stage
  // the depth of the K ring and of the V ring: what the shared memory
  // holds beside q, at most 4 (2 at hd 256, 3 at 128, 4 below)
  static constexpr int kFree = kSmem - kQ - 1024 - 8 * (1 + 4 * 4);
  static constexpr int kStages = kFree / (2 * kKV) < 4 ? kFree / (2 * kKV)
                                                        : 4;
  static constexpr int kBars = 1 + 4 * kStages;
  // q, the two rings, the barriers, and slack to align q to 1024 B (the
  // swizzle's period; every chunk is a multiple of it)
  static constexpr int kBytes = kQ + 2 * kStages * kKV + 8 * kBars + 1024;
  static_assert(kQChunk % 1024 == 0 && kKVChunk % 1024 == 0, "layout");
  static_assert(kStages >= 2 && kBytes <= kSmem, "shared memory");
};

struct Args {
  __nv_bfloat16* out;   // (B, S, H, hd)
  float* lse;           // (B, H, S), or null: not written
  int S, T, H, K, G, P, tiles, causal, window;
  float cap, scale;
};

// x as lane 0 holds it, which ptxas knows to be warp-uniform: a wgmma
// descriptor derived from it stays in uniform registers. One held in
// vector registers is moved to uniform ones between the products of a
// group, and ptxas then serializes them (C7513).
__device__ __forceinline__ int warp_uniform(int x) {
  return __shfl_sync(0xffffffffu, x, 0);
}

// 2**x (ex2.approx: within 2**-22 relative; 0 below -126, flushed).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The softcapped score in log2 units, cap * log2(e) * tanh(s * scale /
// cap), as cap2 - 2 * cap2 / (1 + 2**(s * mul)) with mul = 2 * log2(e) *
// scale / cap and cap2 = cap * log2(e): one exp2 and one reciprocal (both
// approximate, within ~2**-22 relative), so the capped score is within
// ~cap * 2**-20 of cap * tanh, 5e-5 at a cap of 50, where tanhf costs a
// dozen more instructions a score and tanh.approx.f32 errs by up to
// cap * 2**-11. 2**(s * mul) = inf gives tanh = 1, and 0 gives -1.
__device__ __forceinline__ float softcap2(float s, float mul, float cap2) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;"
      : "=f"(r)
      : "f"(1.f + fast_exp2(s * mul)));
  return fmaf(-2.f * cap2, r, cap2);
}

// grid (B*K, row tiles), kThreads threads: two consumer warpgroups.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, const Args a) {
  using L = Layout<HD>;
  constexpr int BN = L::kBN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* k_s = q_s + L::kQ;
  uint8_t* v_s = k_s + L::kStages * L::kKV;
  uint64_t* q_full =
      reinterpret_cast<uint64_t*>(v_s + L::kStages * L::kKV);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + L::kStages;
  uint64_t* k_empty = v_full + L::kStages;
  uint64_t* v_empty = k_empty + L::kStages;

  // the plan's tile: positions s0..s_last, kv tiles lo..hi
  const int tile = a.tiles - 1 - blockIdx.y;   // longest ranges first
  const int b = blockIdx.x / a.K, kh = blockIdx.x % a.K;
  const int s0 = tile * a.P;
  const int s_last = min(s0 + a.P, a.S) - 1;
  int hi = (a.T - 1) / BN;
  if (a.causal) hi = min(hi, s_last / BN);
  const int lo = a.window ? max(s0 - a.window + 1, 0) / BN : 0;
  const int n = hi - lo + 1;                   // kv tiles (none if <= 0)

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 2);   // one arrival per consumer warpgroup
      mbar_init(&v_empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // One thread issues every copy: the first of consumer 1, which takes its
  // turns second and so frees a stage after consumer 0 has.
  const bool issuer = threadIdx.x == 128;
  auto load = [&](const CUtensorMap* map, uint8_t* ring, uint64_t* full,
                  int i) {   // kv tile lo + i into its stage
    const int s = i % L::kStages;
    mbar_expect_tx(&full[s], L::kKV);
    for (int c = 0; c < L::kChunks; ++c)
      tma_4d(ring + s * L::kKV + c * L::kKVChunk, map, c * L::kCols, kh,
             (lo + i) * BN, b, &full[s]);
  };
  if (issuer) {
    mbar_expect_tx(q_full, L::kChunks * a.G * a.P * L::kSW);
    for (int c = 0; c < L::kChunks; ++c)
      tma_4d(q_s + c * L::kQChunk, &qmap, c * L::kCols, kh * a.G, s0, b,
             q_full);
    for (int i = 0; i < L::kStages && i < n; ++i) {
      load(&kmap, k_s, k_full, i);
      load(&vmap, v_s, v_full, i);
    }
  }

  // this warpgroup's rows: 64cw..64cw+63 of the tile
  const int cw = warp_uniform(threadIdx.x / 128);
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int r_top = 64 * cw + 16 * warp + gid;   // rows r_top, r_top + 8
  const int qpos[2] = {s0 + r_top / a.G, s0 + (r_top + 8) / a.G};
  // the score in log2 units: s * scale * log2(e), or capped (softcap2)
  const bool capped = a.cap != 0.f;
  const float mul = capped ? 2.f * kLog2e * a.scale / a.cap
                           : a.scale * kLog2e;
  const float cap2 = a.cap * kLog2e;
  // ping-pong: named barrier 1 + cw is this warpgroup's turn; consumer 0
  // takes the first. Each warpgroup takes n + 1 turns; consumer 1 hands
  // over after each but its last, consumer 0 after each.
  if (n > 0 && cw == 1) bar_arrive(1, 256);

  float o[HD / 2];
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) o[e] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  uint32_t pa[BN / 16][4] = {};
  const uint64_t qd = smem_desc<L::kSW>(q_s + cw * 64 * L::kSW);
  mbar_wait(q_full, 0);

  float corr[2];         // exp2(m_old - m_new) of the thread's two rows
  // the descriptors of stage i's K and V tiles
  auto k_desc = [&](int i) {
    return smem_desc<L::kSW>(k_s + warp_uniform(i % L::kStages) * L::kKV);
  };
  auto v_desc = [&](int i) {   // N-major: chunks LBO apart
    return smem_desc<L::kSW>(v_s + warp_uniform(i % L::kStages) * L::kKV,
                             L::kKVChunk);
  };
  // S_i = q K_i^T into sc (S_i, then P_i's bf16 pairs as their bits), as
  // one wgmma group
  auto issue_s = [&](float* sc, uint64_t kd) {
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c)
#pragma unroll
      for (int kk = 0; kk < L::kCols / 16; ++kk) {   // +32 B of hd a step
        const uint64_t qo = qd + (c * L::kQChunk + 32 * kk) / 16;
        const uint64_t ko = kd + (c * L::kKVChunk + 32 * kk) / 16;
        if (c == 0 && kk == 0) {
          WgmmaSS<BN>::zero(sc, qo, ko);
        } else {
          WgmmaSS<BN>::run(sc, qo, ko);
        }
      }
    wgmma_commit();
  };
  // O += P V_i, P from the A registers pa[kt] of each 16-key step, as one
  // wgmma group
  auto issue_pv = [&](uint64_t vd) {
#pragma unroll
    for (int kt = 0; kt < BN / 16; ++kt)   // +16 key rows a step
      Wgmma<HD, 1>::run(o, pa[kt], vd + kt * L::kSW);
    wgmma_commit();
  };
  // S_i is done: free K_i's stage, and refill it once both warpgroups
  // have
  auto release_k = [&](float* sc, int i) {
    fence_acc<BN / 2>(sc);
    if (t == 0) mbar_arrive(&k_empty[i % L::kStages]);
    if (issuer && i + L::kStages < n) {
      mbar_wait(&k_empty[i % L::kStages], (i / L::kStages) & 1);
      load(&kmap, k_s, k_full, i + L::kStages);
    }
  };
  auto release_v = [&](int i) {
    fence_acc<HD / 2>(o);
    hold<BN / 4>(&pa[0][0]);
    if (t == 0) mbar_arrive(&v_empty[i % L::kStages]);
    if (issuer && i + L::kStages < n) {
      mbar_wait(&v_empty[i % L::kStages], (i / L::kStages) & 1);
      load(&vmap, v_s, v_full, i + L::kStages);
    }
  };
  // The online softmax of S_i in sc: log2-scaled, softcapped, masked where
  // tile i crosses the diagonal, the window edge or T; the new row max m
  // and corr, l rescaled and summed over P_i rounded to bf16, and P_i
  // packed pairwise into sc[2j]: A register r of 16-key step kt is the
  // pair (sc[8kt + 2r], sc[8kt + 2r + 1]), row half r & 1. Returns whether
  // a max of the warp's rows grew (else corr is 1 for every row).
  auto softmax = [&](float* sc, int i) {
    const int k0 = (lo + i) * BN;
    const bool need_mask = k0 + BN > a.T ||
                           (a.causal && k0 + BN - 1 > s0) ||
                           (a.window && k0 <= s_last - a.window);
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      float x = capped ? softcap2(sc[e], mul, cap2) : sc[e] * mul;
      if (need_mask) {
        // element e: row half (e >> 1) & 1, key 8*(e/4) + 2*tig + (e & 1)
        const int key = k0 + 8 * (e / 4) + 2 * tig + (e & 1);
        const int qp = qpos[(e >> 1) & 1];
        bool valid = key < a.T;
        if (a.causal) valid = valid && key <= qp;
        if (a.window) valid = valid && key > qp - a.window;
        if (!valid) x = kNeg;
      }
      sc[e] = x;
    }
    // the row max over the quad that shares each row
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int e = 0; e < BN / 2; ++e)
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
    bool grew = false;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);
      grew = grew || mx[h] != m[h];
      corr[h] = mx[h] == m[h] ? 1.f : fast_exp2(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= corr[h];
    }
#pragma unroll
    for (int j = 0; j < BN / 4; ++j) {
      const int h = j & 1;
      const uint32_t p = bf16x2(fast_exp2(sc[2 * j] - m[h]),
                                fast_exp2(sc[2 * j + 1] - m[h]));
      l[h] += __uint_as_float(p << 16) + __uint_as_float(p & 0xFFFF0000u);
      sc[2 * j] = __uint_as_float(p);
    }
    return __any_sync(0xffffffffu, grew);
  };
  auto pack_p = [&](const float* sc) {
#pragma unroll
    for (int j = 0; j < BN / 4; ++j)
      pa[j / 4][j % 4] = __float_as_uint(sc[2 * j]);
  };

  // Turn 0 issues S_0; turn i (1 <= i < n) O += P_(i-1) V_(i-1) and S_i,
  // then waits for both before the softmax of S_i; turn n issues the last
  // P V. While one warpgroup runs its softmax, the other's products run.
  if (n > 0) {
    float sc[BN / 2];
    const uint64_t kd = k_desc(0);
    mbar_wait(&k_full[0], 0);
    bar_sync(1 + cw, 256);
    wgmma_fence();
    issue_s(sc, kd);
    bar_arrive(2 - cw, 256);
    wgmma_wait<0>();
    release_k(sc, 0);
    softmax(sc, 0);   // O is still 0: nothing to rescale
    pack_p(sc);
  }
  for (int i = 1; i < n; ++i) {
    float sc[BN / 2];
    const uint64_t kd = k_desc(i), vd = v_desc(i - 1);
    mbar_wait(&k_full[i % L::kStages], (i / L::kStages) & 1);
    mbar_wait(&v_full[(i - 1) % L::kStages], ((i - 1) / L::kStages) & 1);
    bar_sync(1 + cw, 256);
    wgmma_fence();
    issue_s(sc, kd);
    issue_pv(vd);
    bar_arrive(2 - cw, 256);
    wgmma_wait<0>();
    release_k(sc, i);
    release_v(i - 1);
    const bool grew = softmax(sc, i);
    // the rescale is a product by 1 for a row whose max held: skipped
    // where it held for every row of the warp
    if (grew) {
#pragma unroll
      for (int e = 0; e < HD / 2; ++e) o[e] *= corr[(e >> 1) & 1];
    }
    pack_p(sc);
  }
  if (n > 0) {
    const uint64_t vd = v_desc(n - 1);
    mbar_wait(&v_full[(n - 1) % L::kStages], ((n - 1) / L::kStages) & 1);
    bar_sync(1 + cw, 256);
    wgmma_fence();
    issue_pv(vd);
    if (cw == 0) bar_arrive(2, 256);
    wgmma_wait<0>();
    fence_acc<HD / 2>(o);
    hold<BN / 4>(&pa[0][0]);
  }

  // o[4j + 2h + c] is row r_top + 8h, column 8j + 2tig + c
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r_top + 8 * h;
    const float lsum = fmaxf(quad_sum(l[h]), 1e-30f);
    // one division a row, then products: within an fp32 ulp of o / l
    const float inv = 1.f / lsum;
    if (r >= a.G * a.P || qpos[h] >= a.S) continue;
    // the row's log-sum-exp in natural units, m + log(l) of the reference
    // with m kept in log2 units here; one lane of the quad writes it
    if (a.lse != nullptr && tig == 0)
      a.lse[((size_t)b * a.H + kh * a.G + r % a.G) * a.S + qpos[h]] =
          (m[h] + log2f(lsum)) * kLn2;
    __nv_bfloat16* dst =
        a.out +
        ((size_t)(b * a.S + qpos[h]) * a.H + kh * a.G + r % a.G) * HD +
        2 * tig;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          bf16x2(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const Args& a,
           int B, cudaStream_t stream) {
  using L = Layout<HD>;
  const CUtensorMapSwizzle sw = L::kSW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                              : CU_TENSOR_MAP_SWIZZLE_64B;
  const cuuint64_t row = HD * 2;   // bytes of one (position, head) row
  const cuuint64_t qdims[4] = {HD, static_cast<cuuint64_t>(a.H),
                               static_cast<cuuint64_t>(a.S),
                               static_cast<cuuint64_t>(B)};
  const cuuint64_t qstrides[3] = {row, row * a.H, row * a.H * a.S};
  const cuuint32_t qbox[4] = {L::kCols, static_cast<cuuint32_t>(a.G),
                              static_cast<cuuint32_t>(a.P), 1};
  const cuuint64_t kdims[4] = {HD, static_cast<cuuint64_t>(a.K),
                               static_cast<cuuint64_t>(a.T),
                               static_cast<cuuint64_t>(B)};
  const cuuint64_t kstrides[3] = {row, row * a.K, row * a.K * a.T};
  const cuuint32_t kbox[4] = {L::kCols, 1, L::kBN, 1};
  CUtensorMap qmap, kmap, vmap;
  if (!encode_nd(&qmap, q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, qdims,
                 qstrides, qbox, sw) ||
      !encode_nd(&kmap, k, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, kdims,
                 kstrides, kbox, sw) ||
      !encode_nd(&vmap, v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, kdims,
                 kstrides, kbox, sw))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_kernel<HD><<<dim3(B * a.K, a.tiles), kThreads, L::kBytes,
                         stream>>>(qmap, kmap, vmap, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q/out (B, S, H, hd) bf16; k/v (B, T, K, hd) bf16, all contiguous and
// 16-B aligned; lse (B, H, S) fp32 or null (not written): each row's
// log-sum-exp of its scaled, capped and masked scores, the backward's
// input; hd in {32, 64, 128, 256}; H a multiple of K; P the
// positions a CTA takes (kernels/flash_attention.py::flash_plan; P*H/K <=
// 128); causal 0 or 1; window 0 (none) or the local window; cap 0 (none)
// or the softcap. Returns cudaGetLastError().
int flash_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int S, int T, int H, int K, int hd,
                   int P, int causal, int window, float cap, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || K <= 0 || H % K || P <= 0 ||
      P * (H / K) > kBM)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.lse = static_cast<float*>(lse);
  a.S = S;
  a.T = T;
  a.H = H;
  a.K = K;
  a.G = H / K;
  a.P = P;
  a.tiles = (S + P - 1) / P;
  a.causal = causal;
  a.window = window;
  a.cap = cap;
  // hd**-0.5 rounded once to fp32, as the reference multiplies by it
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  if (a.tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 32) return launch<32>(q, k, v, a, B, st);
  if (hd == 64) return launch<64>(q, k, v, a, B, st);
  if (hd == 128) return launch<128>(q, k, v, a, B, st);
  if (hd == 256) return launch<256>(q, k, v, a, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
