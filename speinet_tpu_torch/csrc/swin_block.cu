// K2: one whole cross-attention Swin block per group of five 5x5 windows.
//
// Replaces speinet_tpu/ops/pallas_swin.py::fused_swin_block (pallas_call at
// :420, bodies _block_kernel :246 and _attn_compact :159). For every window
// of the rolled / padded images x (the K/V stream) and y (the Q stream):
//     xn, yn = LN1(x), LN1(y)                           (f32 math, eps 1e-5)
//     q = (yn Wq + bq) * hd^-1/2,  k|v = xn Wkv + bkv    (bf16 operands, f32 sums)
//     per head: P = softmax(q k^T + relpos_bias + mask)  (f32 softmax, bf16 P)
//     x2 = x + (P v) Wp + bp                             (residual in f32)
//     out = x2 + fc2(gelu_erf(fc1(LN2(x2))))             (hidden rounded to
//                                                        bf16, output once)
// The shift / pad mask (-100 per violated rule) is computed in the kernel
// from the window's coordinates: image-region labels of shift_attn_mask
// (speinet_tpu/models/swinir.py:61-77) and the rolled pad rule (:356-365).
//
// Bound on the H100: operations (~62 GFLOP per [180, 320, 256] stream image
// against ~88 MB, 0.063 ms vs 0.026 ms). Design: a CTA takes 5 consecutive
// windows = 125 token rows (padded to 128) of one stream; warps 0-7 are two
// consumer warpgroups, each owning 64 token rows, warps 8-11 the producer
// warpgroup (one thread issues the copies), which hands its registers to
// the consumers (setmaxnreg: 40 and 232 a thread).
// - x and y arrive by TMA, a window's 64 channels a box, into the tile the
//   LayerNorm then rewrites in place; x's windows come twice (for LN1 and
//   for the residual), each time as soon as the tile's last reader is done,
//   so the copies overlap the Q epilogue and the last heads' attention.
// - Every projection (Q; K|V of two heads at a time; proj; fc1 per 128-wide
//   hidden chunk; fc2) is a wgmma (m64nNk16, bf16, f32 accumulators in registers) whose A
//   (LN'd rows, attention output, GELU'd hidden chunk) lies in shared memory
//   in the canonical 128-byte-swizzled K-major layout, and whose weights
//   (torch Linear layout, K-major) stream through a ring of 16 KB shared
//   slabs, 64 deep in K, loaded by TMA under full / empty mbarriers: the
//   producer runs ahead through the block's fixed slab order, so weight
//   copies overlap the MMAs.
// - The f32 residual stays in registers: the proj accumulators (m64 x C)
//   get x (from the tile) + bp added in place, LN2 reduces each row over the four lanes of
//   a quad, LN2's bf16 rows become fc1's A, each fc1 chunk goes through
//   bias + GELU in registers to a bf16 shared tile, fc2 accumulates onto
//   the residual registers, and the output is + b2 rounded to bf16 once
//   into the tile and stored a window box at a time by TMA.
// - The attention runs per (window, head, 16-query half) in one warp on
//   mma.sync m16n8k16: the window's 25 tokens padded to 32, S = q k^T
//   (1 x 4 tiles), bias and mask added and the f32 softmax taken on the
//   accumulator fragments (quad shuffles), the bf16 probabilities reused in
//   registers as the A fragments of O = P v, O written over Q. (Per token on CUDA
//   cores the serial dot products are latency-bound: a CTA has only eight
//   consumer warps per SM to hide them.)
// C below 256 runs at CP = 64, 128 or 256 columns: TMA fills the weights'
// missing rows and columns with zeros and the padded columns stay zero.
// Sharing weight slabs between CTAs (clusters, TMA multicast) is later work.

#include "hopper.cuh"
#include "swin_common.cuh"
#include "tensor_core.cuh"

using namespace hopper;
using swin::bf16;

namespace {

constexpr int THREADS = 384;      // two consumer warpgroups + a producer warpgroup
constexpr int WS = swin::WS;
constexpr int NT = swin::N;       // tokens per window
constexpr int G = swin::G;        // windows per CTA
constexpr int ROWS = swin::ROWS;  // 125 live token rows
constexpr int M = swin::M;        // 128 token rows
constexpr int HD = swin::HD;      // head dim
constexpr int SLAB = 16384;       // ring stage: [<= 128 rows][64 k] bf16
constexpr int BLK = M * 128;      // one 64-column block of a swizzled [128][64] tile
constexpr int HC = 128;           // MLP hidden columns per chunk
constexpr int LDKV = 136;         // K | V tile row stride (elements): 272 bytes
constexpr int KV_BYTES = M * LDKV * 2;
constexpr int MAX_STAGES = 4;
constexpr unsigned FULL = 0xffffffffu;

struct Maps {
  CUtensorMap q, kv, p, w1, w2;   // weights, [rows, K] in 64 x rows boxes
  CUtensorMap x, y, o;            // images, one window's 64 channels a box
};

struct BArgs {
  const bf16* x;
  const bf16* y;
  bf16* out;
  const float *ln1w, *ln1b, *bkv, *bq, *bp, *relbias, *ln2w, *ln2b, *b1, *b2;
  int B, Hp, Wp, C, hidden, heads, shift, h_valid, w_valid, total_win;
  float scale;
  int stages, off_q, off_ring, off_kv, off_msk, off_bias, off_bar;
};

// two consecutive f32 parameters (biases, LayerNorm weights) by the
// read-only path: such loads need not wait behind the shared-memory
// stores around them, which the compiler cannot tell apart from global ones
__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// byte offset of (row, col) in a swizzled tile of 64-column blocks
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return (uint32_t)((col >> 6) * BLK + row * 128 + ((((col >> 3) & 7) ^ (row & 7)) << 4)
                    + (col & 7) * 2);
}

// element offset of token row m's pixel, -1 for padding rows
__device__ __forceinline__ long long pix_off(const BArgs& a, int m, int win0) {
  if (m >= ROWS) return -1;
  const int win = win0 + m / NT;
  if (win >= a.total_win) return -1;
  const int n = m % NT;
  const int nww = a.Wp / WS;
  const int per_img = (a.Hp / WS) * nww;
  const int b = win / per_img;
  const int rem = win - b * per_img;
  const int i = (rem / nww) * WS + n / WS;
  const int j = (rem % nww) * WS + n % WS;
  return (((long long)b * a.Hp + i) * a.Wp + j) * a.C;
}

// the weight ring as one consumer warpgroup walks it
struct Ring {
  uint32_t buf, bar;
  int stages, st;
  uint32_t ph;
  __device__ uint32_t full(int i) const { return bar + 8 * i; }
  __device__ uint32_t empty(int i) const { return bar + 8 * (MAX_STAGES + i); }
  __device__ uint32_t acquire() {
    mbar_wait(full(st), ph);
    return buf + st * SLAB;
  }
  // once the MMAs that read the slab have completed, hand it back to the
  // producer at once: with a 3-stage ring every stage counts
  __device__ void release() {
    if ((threadIdx.x & 127) == 0) mbar_arrive(empty(st));
    if (++st == stages) {
      st = 0;
      ph ^= 1;
    }
  }
};

// acc[p] (+)= A[this warpgroup's 64 rows, 0 : 64 nkb] x W^T over nkb
// k-blocks of P slabs each (slab p: output columns p*NW .. +NW-1); A is a
// swizzled tile at a_s (shared address). fresh: the first k-step
// overwrites acc.
template <int NW, int P>
__device__ __forceinline__ void gemm(float (*acc)[NW / 2], uint32_t a_s, int nkb,
                                     Ring& ring, bool fresh) {
  const int wg = (threadIdx.x >> 7) & 1;
  for (int kb = 0; kb < nkb; ++kb) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const uint32_t slab = ring.acquire();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = make_desc(a_s + kb * BLK + wg * 64 * 128 + kk * 32, 16, 1024, 1);
        const uint64_t db = make_desc(slab + kk * 32, 16, 1024, 1);
        wgmma_ss<NW, 0>(acc[p], da, db, (fresh && kb == 0 && kk == 0) ? 0 : 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      ring.release();
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) fence_regs<NW / 2>(acc[p]);
}

// this CTA's windows of one [B, Hp, Wp, C] image by TMA into the tile at
// dst_s: token row m of window g at row g * 25 + n, each 64-column block
// unswizzled ([row][64]); issued by one thread, completion counted on bar
template <int CP>
__device__ __forceinline__ void load_windows(const BArgs& a, const void* map,
                                             uint32_t dst_s, uint32_t bar, int win0) {
  const int nv = min(G, a.total_win - win0);
  mbar_expect_tx(bar, nv * (CP / 64) * NT * 128);
  const int nww = a.Wp / WS;
  const int per_img = (a.Hp / WS) * nww;
  for (int g = 0; g < nv; ++g) {
    const int win = win0 + g;
    const int b = win / per_img;
    const int rem = win - b * per_img;
#pragma unroll
    for (int blk = 0; blk < CP / 64; ++blk)
      tma_load_4d(dst_s + blk * BLK + g * NT * 128, map, bar, blk * 64, (rem % nww) * WS,
                  (rem / nww) * WS, b);
  }
}

// LN1 of this warp's 16 token rows, in place: raw rows as load_windows left
// them in, LN'd bf16 rows out in the swizzled layout (each lane reads and
// writes 16 bytes of its row's own 128-byte rows)
__device__ __forceinline__ void ln1_rows(const BArgs& a, unsigned char* tile, int row0,
                                         int win0, int lane, int CP) {
  const bool act = lane * 8 < a.C;
  float w[8], bb[8];
#pragma unroll
  for (int e = 0; e < 8; e += 2) {
    const float2 wv = act ? ldg2(a.ln1w + lane * 8 + e) : make_float2(0.0f, 0.0f);
    const float2 bv = act ? ldg2(a.ln1b + lane * 8 + e) : make_float2(0.0f, 0.0f);
    w[e] = wv.x;
    w[e + 1] = wv.y;
    bb[e] = bv.x;
    bb[e + 1] = bv.y;
  }
  const uint32_t raw_off = (lane >> 3) * BLK + (lane & 7) * 16;
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    const int m = row0 + i;
    const bool ok = m < ROWS && win0 + m / NT < a.total_win;
    float v[8];
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (ok && act) raw = *reinterpret_cast<const uint4*>(tile + raw_off + m * 128);
    swin::unpack8(raw, v);
    // one-pass clamped variance, as the JAX block
    float s = 0.0f, ss = 0.0f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s += v[e];
      ss += v[e] * v[e];
    }
    s = swin::warp_sum(s);   // also orders every lane's read before any write
    ss = swin::warp_sum(ss);
    const float mu = s / a.C;
    const float r = rsqrtf(fmaxf(ss / a.C - mu * mu, 0.0f) + 1e-5f);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = ok && act ? (v[e] - mu) * r * w[e] + bb[e] : 0.0f;
    if (lane * 8 < CP) *reinterpret_cast<uint4*>(tile + swz(m, lane * 8)) = swin::pack8(v);
  }
}

template <int CP>
__global__ void __launch_bounds__(THREADS, 1) swin_block_kernel(
    const __grid_constant__ Maps maps, const BArgs a) {
  constexpr int NP = CP >= 128 ? 128 : 64;   // wgmma width of the C-wide GEMMs
  constexpr int NH = CP / NP;
  constexpr int NKB = CP / 64;               // 64-deep k-blocks over C
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sA = smem;                  // yn, then xn, then LN2(x2)
  unsigned char* sQ = smem + a.off_q;        // Q -> O, then the hidden chunks
  const uint32_t sA_s = smem_u32(sA);
  const uint32_t sQ_s = smem_u32(sQ);
  const uint32_t ring_s = smem_u32(smem + a.off_ring);
  bf16* sKV = reinterpret_cast<bf16*>(smem + a.off_kv);   // [M][LDKV]: K|V of two heads
  const uint32_t bar_s = smem_u32(smem + a.off_bar);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int win0 = blockIdx.x * G;
  const int C = a.C;
  const int n_chunks = (a.hidden + HC - 1) / HC;

  // image windows into sA: y at the start, x twice (LN1, then the residual)
  const uint32_t ybar = bar_s + 16 * MAX_STAGES;
  const uint32_t xbar = ybar + 8;
  if (tid == 0) {
    for (int i = 0; i < a.stages; ++i) {
      mbar_init(bar_s + 8 * i, 1);
      mbar_init(bar_s + 8 * (MAX_STAGES + i), 2);
    }
    mbar_init(ybar, 1);
    mbar_init(xbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {
    // ---------------- producer: the block's slabs in consumption order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp != 8 || lane != 0) return;
    int st = 0;
    uint32_t ph = 0;
    auto next = [&](uint32_t bytes) {
      mbar_wait(bar_s + 8 * (MAX_STAGES + st), ph ^ 1);
      mbar_expect_tx(bar_s + 8 * st, bytes);
      return ring_s + st * SLAB;
    };
    auto advance = [&]() {
      if (++st == a.stages) {
        st = 0;
        ph ^= 1;
      }
    };
    const uint32_t np_bytes = NP * 128;
    for (int kb = 0; kb < NKB; ++kb)               // Q
      for (int p = 0; p < NH; ++p) {
        tma_load_2d(next(np_bytes), &maps.q, bar_s + 8 * st, kb * 64, p * NP);
        advance();
      }
    for (int h0 = 0; h0 < a.heads; h0 += 2)        // K | V of two heads
      for (int kb = 0; kb < NKB; ++kb) {
        const uint32_t dst = next(SLAB);
        // a missing second head reads past the matrix: zeros
        const int h1k = h0 + 1 < a.heads ? (h0 + 1) * HD : 2 * C;
        const int h1v = h0 + 1 < a.heads ? C + (h0 + 1) * HD : 2 * C;
        tma_load_2d(dst, &maps.kv, bar_s + 8 * st, kb * 64, h0 * HD);
        tma_load_2d(dst + 4096, &maps.kv, bar_s + 8 * st, kb * 64, C + h0 * HD);
        tma_load_2d(dst + 8192, &maps.kv, bar_s + 8 * st, kb * 64, h1k);
        tma_load_2d(dst + 12288, &maps.kv, bar_s + 8 * st, kb * 64, h1v);
        advance();
      }
    for (int kb = 0; kb < NKB; ++kb)               // proj
      for (int p = 0; p < NH; ++p) {
        tma_load_2d(next(np_bytes), &maps.p, bar_s + 8 * st, kb * 64, p * NP);
        advance();
      }
    for (int c = 0; c < n_chunks; ++c) {           // fc1 chunk, then fc2 chunk
      for (int kb = 0; kb < NKB; ++kb) {
        tma_load_2d(next(SLAB), &maps.w1, bar_s + 8 * st, kb * 64, c * HC);
        advance();
      }
      for (int kb = 0; kb < HC / 64; ++kb)
        for (int p = 0; p < NH; ++p) {
          tma_load_2d(next(np_bytes), &maps.w2, bar_s + 8 * st, c * HC + kb * 64, p * NP);
          advance();
        }
    }
    return;
  }

  // ---------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warp >> 2;
  const int wq = warp & 3;
  const int q4 = lane & 3;
  const int r0 = wg * 64 + wq * 16 + (lane >> 2);   // accumulator rows r0, r0 + 8
  Ring ring{ring_s, bar_s, a.stages, 0, 0};
  const int wg_bar = 2 + wg;

  // ---- Q = (LN1(y) Wq^T + bq) * scale -> sQ
  if (tid == 0) load_windows<CP>(a, &maps.y, sA_s, ybar, win0);
  mbar_wait(ybar, 0);
  ln1_rows(a, sA, wg * 64 + wq * 16, win0, lane, CP);
  fence_proxy_async();
  bar_sync(wg_bar, 128);
  {
    float acc[NH][NP / 2];
    gemm<NP, NH>(acc, sA_s, NKB, ring, true);
    // both warpgroups have read yn: x's windows may overwrite it while the
    // epilogue runs
    bar_sync(1, 256);
    if (tid == 0) load_windows<CP>(a, &maps.x, sA_s, xbar, win0);
#pragma unroll
    for (int p = 0; p < NH; ++p)
#pragma unroll
      for (int j = 0; j < NP / 8; ++j) {
        const int col = p * NP + 8 * j + 2 * q4;
        const bool live = col < C;
        const float2 bq = live ? ldg2(a.bq + col) : make_float2(0.0f, 0.0f);
        const float b0 = bq.x;
        const float b1 = bq.y;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t v = live ? pack_bf16x2((acc[p][4 * j + 2 * h] + b0) * a.scale,
                                                (acc[p][4 * j + 2 * h + 1] + b1) * a.scale)
                                  : 0u;
          *reinterpret_cast<uint32_t*>(sQ + swz(r0 + 8 * h, col)) = v;
        }
      }
  }
  // ---- LN1(x) -> sA
  mbar_wait(xbar, 0);
  ln1_rows(a, sA, wg * 64 + wq * 16, win0, lane, CP);
  fence_proxy_async();
  bar_sync(wg_bar, 128);

  // the -100 terms of the mask, from window coordinates: bit j of
  // other[g][n] = key j lies in another shift region than query n, of
  // pad[g] = key j is padding after the roll
  uint32_t* other = reinterpret_cast<uint32_t*>(smem + a.off_msk);   // [G][NT]
  uint32_t* padm = other + G * NT;                                      // [G]
  float* sbias = reinterpret_cast<float*>(smem + a.off_bias);            // [2][NT][NT]
  if (tid < ROWS) {
    const int g = tid / NT;
    const int n = tid % NT;
    const int win = min(win0 + g, a.total_win - 1);
    const int nww = a.Wp / WS;
    const int rem = win % ((a.Hp / WS) * nww);
    const int wr = rem / nww;
    const int wc = rem % nww;
    const int qlab = 3 * swin::region(wr * WS + n / WS, a.Hp, a.shift)
                     + swin::region(wc * WS + n % WS, a.Wp, a.shift);
    uint32_t o = 0, pd = 0;
    for (int j = 0; j < NT; ++j) {
      const int ki = wr * WS + j / WS;
      const int kj = wc * WS + j % WS;
      if (a.shift > 0 &&
          3 * swin::region(ki, a.Hp, a.shift) + swin::region(kj, a.Wp, a.shift) != qlab)
        o |= 1u << j;
      // (ki + shift) mod Hp, ki < Hp and shift < WS <= Hp
      const int ri = ki + a.shift >= a.Hp ? ki + a.shift - a.Hp : ki + a.shift;
      const int rj = kj + a.shift >= a.Wp ? kj + a.shift - a.Wp : kj + a.shift;
      if (ri >= a.h_valid || rj >= a.w_valid) pd |= 1u << j;
    }
    other[tid] = o;
    if (n == 0) padm[g] = pd;
  }

  // fragment coordinates of mma.m16n8k16 and of ldmatrix row addresses
  const int g4 = lane >> 2;
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const uint32_t kv_s = smem_u32(sKV);
  for (int h0 = 0; h0 < a.heads; h0 += 2) {
    const int nh = min(2, a.heads - h0);
    // ---- K | V of heads h0, h0 + 1 = xn Wkv^T + bkv (one m64n128 GEMM)
    float acc[1][64];
    gemm<128, 1>(acc, sA_s, NKB, ring, true);
    if (h0 > 0) bar_sync(1, 256);   // the previous pair's attention has read sKV
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * q4;            // [K h0 | V h0 | K h1 | V h1]
      const int hs = col >> 6;
      const int c32 = col & 63;
      const int feat = (c32 < HD ? 0 : C - HD) + (h0 + hs) * HD + c32;
      const bool live = hs < nh;
      const float2 bk = live ? ldg2(a.bkv + feat) : make_float2(0.0f, 0.0f);
      const float b0 = bk.x;
      const float b1 = bk.y;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint32_t*>(sKV + (r0 + 8 * hh) * LDKV + col) =
            pack_bf16x2(acc[0][4 * j + 2 * hh] + b0, acc[0][4 * j + 2 * hh + 1] + b1);
    }
    // the two heads' relative-position bias, [2][NT][NT] f32
    for (int i = tid; i < nh * NT * NT; i += 256) sbias[i] = __ldg(a.relbias + h0 * NT * NT + i);
    bar_sync(1, 256);   // K | V of all rows (windows straddle the two halves)
    // after the last K | V GEMM nothing reads xn: x's windows come back
    // for the residual while the last heads' attention runs
    if (h0 + 2 >= a.heads && tid == 0) load_windows<CP>(a, &maps.x, sA_s, xbar, win0);

    // ---- per (window, head): S = q k^T + bias + mask, softmax, O = P v on
    // mma.sync over 32 x 32 tiles (25 tokens padded), O over Q in sQ
    // a task is one window, one head and one 16-row half of the padded
    // queries: twenty per head pair over the eight warps
    for (int task = warp; task < G * nh * 2; task += 8) {
      const int mt = task / (G * nh);
      const int g = task % G;
      const int hs = task / G % nh;
      const int head = h0 + hs;
      if (win0 + g >= a.total_win) continue;
      const int rb = g * NT;
      const int rq = rb + mt * 16;             // this task's first query row
      uint32_t qa[2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        ldmatrix_x4(qa[ks], sQ_s + swz(min(rq + a_row, M - 1), head * HD + ks * 16 + a_col));
      float sc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        uint32_t kb[4];
        ldmatrix_x4(kb, kv_s + (uint32_t)((min(rb + nt * 8 + (lane & 7), M - 1) * LDKV
                                           + hs * 64 + (lane >> 3) * 8) * 2));
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = 0.0f;
        mma_bf16(sc[nt], qa[0], kb[0], kb[1]);
        mma_bf16(sc[nt], qa[1], kb[2], kb[3]);
      }
      const uint32_t pd = padm[g];
      uint32_t pa[2][4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int n = min(mt * 16 + g4 + 8 * hh, NT - 1);
        const uint32_t ot = other[rb + n];
        const float* bias = sbias + (hs * NT + n) * NT;
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = nt * 8 + 2 * q4 + e;
            float v = -INFINITY;
            if (j < NT)
              v = sc[nt][2 * hh + e] + bias[j] + ((ot >> j) & 1u ? -100.0f : 0.0f)
                  + ((pd >> j) & 1u ? -100.0f : 0.0f);
            sc[nt][2 * hh + e] = v;
            mx = fmaxf(mx, v);
          }
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
        float sum = 0.0f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float ex = expf(sc[nt][2 * hh + e] - mx);
            sc[nt][2 * hh + e] = ex;
            sum += ex;
          }
        sum += __shfl_xor_sync(FULL, sum, 1);
        sum += __shfl_xor_sync(FULL, sum, 2);
        const float inv = 1.0f / sum;
        // bf16 probabilities as the A fragments of P v (keys 16 kt ..)
#pragma unroll
        for (int kt = 0; kt < 2; ++kt) {
          pa[kt][hh] = pack_bf16x2(sc[2 * kt][2 * hh] * inv, sc[2 * kt][2 * hh + 1] * inv);
          pa[kt][2 + hh] = pack_bf16x2(sc[2 * kt + 1][2 * hh] * inv,
                                       sc[2 * kt + 1][2 * hh + 1] * inv);
        }
      }
      float o[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] = 0.0f;
#pragma unroll
      for (int kt = 0; kt < 2; ++kt)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, kv_s + (uint32_t)((min(rb + kt * 16 + a_row, M - 1) * LDKV
                                                   + hs * 64 + HD + np * 16 + a_col) * 2));
          mma_bf16(o[2 * np], pa[kt], vb[0], vb[1]);
          mma_bf16(o[2 * np + 1], pa[kt], vb[2], vb[3]);
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int n = mt * 16 + g4 + 8 * hh;
        if (n < NT) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            *reinterpret_cast<uint32_t*>(sQ + swz(rb + n, head * HD + nt * 8 + 2 * q4)) =
                pack_bf16x2(o[nt][2 * hh], o[nt][2 * hh + 1]);
        }
      }
    }
  }
  // O rows were written by the warps of both warpgroups
  fence_proxy_async();
  bar_sync(1, 256);

  // ---- x2 = x + (O Wp^T + bp): the residual, in registers from here on
  float res[NH][NP / 2];
  gemm<NP, NH>(res, sQ_s, NKB, ring, true);
  long long off[2];
  off[0] = pix_off(a, r0, win0);
  off[1] = pix_off(a, r0 + 8, win0);
  mbar_wait(xbar, 1);
#pragma unroll
  for (int p = 0; p < NH; ++p)
#pragma unroll
    for (int j = 0; j < NP / 8; ++j) {
      const int col = p * NP + 8 * j + 2 * q4;
      if (col < C) {
        const float2 bpv = ldg2(a.bp + col);
        const float b0 = bpv.x;
        const float b1 = bpv.y;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2 xv = make_float2(0.0f, 0.0f);
          if (off[h] >= 0)
            xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                sA + (col >> 6) * BLK + (r0 + 8 * h) * 128 + (col & 63) * 2));
          res[p][4 * j + 2 * h] = xv.x + (res[p][4 * j + 2 * h] + b0);
          res[p][4 * j + 2 * h + 1] = xv.y + (res[p][4 * j + 2 * h + 1] + b1);
        }
      }
    }
  // ---- LN2(x2) -> sA, over the raw x rows this quad has just read
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float s = 0.0f, ss = 0.0f;
#pragma unroll
    for (int p = 0; p < NH; ++p)
#pragma unroll
      for (int j = 0; j < NP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = res[p][4 * j + 2 * h + e];   // padded columns are 0
          s += v;
          ss += v * v;
        }
    s += __shfl_xor_sync(FULL, s, 1);
    s += __shfl_xor_sync(FULL, s, 2);
    ss += __shfl_xor_sync(FULL, ss, 1);
    ss += __shfl_xor_sync(FULL, ss, 2);
    const float mu = s / C;
    const float rs = rsqrtf(fmaxf(ss / C - mu * mu, 0.0f) + 1e-5f);
    const bool ok = off[h] >= 0;
#pragma unroll
    for (int p = 0; p < NH; ++p)
#pragma unroll
      for (int j = 0; j < NP / 8; ++j) {
        const int col = p * NP + 8 * j + 2 * q4;
        uint32_t v = 0u;
        if (ok && col < C) {
          const float2 w2 = ldg2(a.ln2w + col);
          const float2 b2 = ldg2(a.ln2b + col);
          v = pack_bf16x2((res[p][4 * j + 2 * h] - mu) * rs * w2.x + b2.x,
                          (res[p][4 * j + 2 * h + 1] - mu) * rs * w2.y + b2.y);
        }
        *reinterpret_cast<uint32_t*>(sA + swz(r0 + 8 * h, col)) = v;
      }
  }
  fence_proxy_async();
  bar_sync(wg_bar, 128);

  // ---- MLP, 128 hidden columns at a time: x2 += gelu(LN2 W1^T + b1) W2^T
  // (a chunk past `hidden` reads zero weights and gives gelu(0) = 0)
  for (int c = 0; c < n_chunks; ++c) {
    unsigned char* hid = sQ + (c & 1) * 2 * BLK;   // [M][128] swizzled, bf16
    {
      float acc[1][64];
      gemm<128, 1>(acc, sA_s, NKB, ring, true);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 8 * j + 2 * q4;
        const bool live = c * HC + col < a.hidden;
        const float2 bh = live ? ldg2(a.b1 + c * HC + col) : make_float2(0.0f, 0.0f);
        const float b0 = bh.x;
        const float b1 = bh.y;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float t0 = acc[0][4 * j + 2 * h] + b0;
          const float t1 = acc[0][4 * j + 2 * h + 1] + b1;
          *reinterpret_cast<uint32_t*>(hid + swz(r0 + 8 * h, col)) = pack_bf16x2(
              0.5f * t0 * (1.0f + erff(t0 * 0.70710678118654752f)),
              0.5f * t1 * (1.0f + erff(t1 * 0.70710678118654752f)));
        }
      }
    }
    fence_proxy_async();
    bar_sync(wg_bar, 128);
    gemm<NP, NH>(res, smem_u32(hid), HC / 64, ring, false);
  }

  // ---- out = x2 + b2, rounded to bf16 once, into sA's rows (this
  // warpgroup's last fc1 GEMM has read LN2's), then the windows by TMA
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int p = 0; p < NH; ++p)
#pragma unroll
      for (int j = 0; j < NP / 8; ++j) {
        const int col = p * NP + 8 * j + 2 * q4;
        const float2 bo = col < C ? ldg2(a.b2 + col) : make_float2(0.0f, 0.0f);
        *reinterpret_cast<uint32_t*>(sA + (col >> 6) * BLK + (r0 + 8 * h) * 128 + (col & 63) * 2) =
            pack_bf16x2(res[p][4 * j + 2 * h] + bo.x, res[p][4 * j + 2 * h + 1] + bo.y);
      }
  fence_proxy_async();
  bar_sync(1, 256);
  if (tid == 0) {
    const int nv = min(G, a.total_win - win0);
    const int nww = a.Wp / WS;
    const int per_img = (a.Hp / WS) * nww;
    for (int g = 0; g < nv; ++g) {
      const int win = win0 + g;
      const int b = win / per_img;
      const int rem = win - b * per_img;
#pragma unroll
      for (int blk = 0; blk < CP / 64; ++blk)
        tma_store_4d(&maps.o, sA_s + blk * BLK + g * NT * 128, blk * 64, (rem % nww) * WS,
                     (rem / nww) * WS, b);
    }
    bulk_commit();
    bulk_wait_read();
  }
}

// a [rows, inner] bf16 row-major matrix read in boxes of 64 x box_rows,
// 128-byte swizzled; reads past its edge fill zeros
bool make_map(CUtensorMap* map, const void* ptr, int inner, int rows, int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr || (reinterpret_cast<uintptr_t>(ptr) & 15) != 0) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t es[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
             strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a [B, Hp, Wp, C] bf16 image read a 5x5 window's 64 channels at a time
bool make_img_map(CUtensorMap* map, const void* ptr, const BArgs& a) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr || (reinterpret_cast<uintptr_t>(ptr) & 15) != 0) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)a.C, (cuuint64_t)a.Wp, (cuuint64_t)a.Hp,
                              (cuuint64_t)a.B};
  const cuuint64_t strides[3] = {(cuuint64_t)a.C * 2, (cuuint64_t)a.Wp * a.C * 2,
                                 (cuuint64_t)a.Hp * a.Wp * a.C * 2};
  const cuuint32_t box[4] = {64, WS, WS, 1};
  const cuuint32_t es[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
             strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int CP>
cudaError_t launch(BArgs a, const void* wq, const void* wkv, const void* wp,
                   const void* w1, const void* w2, cudaStream_t stream) {
  constexpr int NP = CP >= 128 ? 128 : 64;
  Maps maps;
  if (!make_map(&maps.q, wq, a.C, a.C, NP) || !make_map(&maps.kv, wkv, a.C, 2 * a.C, HD)
      || !make_map(&maps.p, wp, a.C, a.C, NP) || !make_map(&maps.w1, w1, a.C, a.hidden, HC)
      || !make_map(&maps.w2, w2, a.hidden, a.C, NP) || !make_img_map(&maps.x, a.x, a)
      || !make_img_map(&maps.y, a.y, a) || !make_img_map(&maps.o, a.out, a))
    return cudaErrorInvalidValue;
  const int tile = M * CP * 2;
  const int msk_bytes = (G * NT + G) * 4 + 2 * NT * NT * 4;   // masks, bias of two heads
  a.off_q = tile;
  a.off_ring = tile + (tile > 4 * BLK ? tile : 4 * BLK);   // Q / O, or two hidden chunks
  const int fixed = a.off_ring + KV_BYTES + msk_bytes + 16 * MAX_STAGES + 16 + 1024;
  a.stages = (227 * 1024 - fixed) / SLAB;
  if (a.stages > MAX_STAGES) a.stages = MAX_STAGES;
  if (a.stages < 2) return cudaErrorInvalidValue;
  a.off_kv = a.off_ring + a.stages * SLAB;
  a.off_msk = a.off_kv + KV_BYTES;
  a.off_bias = a.off_msk + (G * NT + G) * 4;
  a.off_bar = (a.off_msk + msk_bytes + 7) & ~7;
  const int smem = a.off_bar + 16 * MAX_STAGES + 16 + 1024;
  cudaError_t e = cudaFuncSetAttribute(
      swin_block_kernel<CP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int blocks = (a.total_win + G - 1) / G;
  swin_block_kernel<CP><<<blocks, THREADS, smem, stream>>>(maps, a);
  return cudaGetLastError();
}

}  // namespace

// x, y, out [B, Hp, Wp, C] bf16 (rolled / padded); weights in torch Linear
// layout (bf16), biases, LayerNorm parameters and relbias [heads, 25, 25]
// in f32. h_valid / w_valid: the un-padded extent before the roll.
extern "C" int speinet_swin_block(
    const void* x, const void* y, void* out, const void* ln1w,
    const void* ln1b, const void* wkv, const void* bkv, const void* wq,
    const void* bq, const void* wp, const void* bp, const void* relbias,
    const void* ln2w, const void* ln2b, const void* w1, const void* b1,
    const void* w2, const void* b2, int B, int Hp, int Wp, int C, int hidden,
    int heads, int ws, int shift, int h_valid, int w_valid, float scale,
    void* stream) {
  if (ws != WS || Hp % WS != 0 || Wp % WS != 0 || C % HD != 0 || C > 256 ||
      heads * HD != C || hidden % 64 != 0 || hidden < 64 || shift < 0 || shift >= WS ||
      h_valid < 1 || h_valid > Hp || w_valid < 1 || w_valid > Wp)
    return cudaErrorInvalidValue;
  const long long total_win = (long long)B * (Hp / WS) * (Wp / WS);
  if (total_win < 1 || (total_win + G - 1) / G > 0x7fffffffLL) return cudaErrorInvalidValue;
  BArgs a;
  a.x = static_cast<const bf16*>(x);
  a.y = static_cast<const bf16*>(y);
  a.out = static_cast<bf16*>(out);
  a.ln1w = static_cast<const float*>(ln1w);
  a.ln1b = static_cast<const float*>(ln1b);
  a.bkv = static_cast<const float*>(bkv);
  a.bq = static_cast<const float*>(bq);
  a.bp = static_cast<const float*>(bp);
  a.relbias = static_cast<const float*>(relbias);
  a.ln2w = static_cast<const float*>(ln2w);
  a.ln2b = static_cast<const float*>(ln2b);
  a.b1 = static_cast<const float*>(b1);
  a.b2 = static_cast<const float*>(b2);
  a.B = B;
  a.Hp = Hp;
  a.Wp = Wp;
  a.C = C;
  a.hidden = hidden;
  a.heads = heads;
  a.shift = shift;
  a.h_valid = h_valid;
  a.w_valid = w_valid;
  a.total_win = (int)total_win;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 64) return launch<64>(a, wq, wkv, wp, w1, w2, s);
  if (C <= 128) return launch<128>(a, wq, wkv, wp, w1, w2, s);
  return launch<256>(a, wq, wkv, wp, w1, w2, s);
}
