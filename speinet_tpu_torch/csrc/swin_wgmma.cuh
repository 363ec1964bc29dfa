// Hopper stages of the Swin kernels, composed by K2 (swin_block.cu, the
// whole block), K8 (swin_attn.cu, LN1 + window cross-attention + proj) and
// K9 (swin_mlp.cu, x + MLP(LN2(x))).
//
// Thread layout (all three): 384 threads, warps 0-7 two consumer
// warpgroups that own 64 token rows each, warps 8-11 the producer
// warpgroup, of which one thread issues the weight copies; setmaxnreg
// hands the producer's registers to the consumers (40 and 232 a thread).
// A CTA takes M = 128 token rows: five 5x5 windows (125 rows) of one
// stream image in K2 / K8, 128 consecutive [rows, C] rows in K9.
//
// - Tiles: a [128 rows][CP] bf16 operand lies in shared memory as CP / 64
//   blocks of [128][64], each in the canonical 128-byte-swizzled K-major
//   layout (`swz`), the A operand of wgmma. CP = 64, 128 or 256 is C
//   rounded up; the padded columns stay zero.
// - Weights (torch Linear layout, K-major) stream through a `Ring` of
//   16 KB slabs, [<= 128 rows][64 k] each, loaded by TMA (SWIZZLE_128B)
//   under full / empty mbarriers. The producer walks the kernel's slabs in
//   the order the consumers' `gemm`s take them (`produce_attn`,
//   `produce_mlp`); both warpgroups read every slab, so a stage is empty
//   after two arrivals.
// - `gemm`: acc (+)= A[the warpgroup's 64 rows] x W^T on wgmma m64nNk16,
//   bf16 operands, f32 accumulators in registers.
// - `ln_rows`: LayerNorm of a warp's 16 rows in place in a tile that TMA
//   filled (raw [row][64] boxes, or swizzled ones), one-pass clamped
//   variance as in the JAX block, bf16 swizzled rows out.
// - `window_attention` (K2, K8): LN1(y) -> Q (scaled, bf16), LN1(x), then
//   per pair of heads K|V on one m64n128 GEMM and the attention per
//   (window, head, 16-query half) on mma.sync m16n8k16 (S = q k^T, bias and
//   the -100 shift / pad terms, f32 softmax, bf16 P, O = P v, O over Q),
//   then the projection GEMM.
// - `mlp_chunks` (K2, K9): per 128-wide hidden chunk fc1 on wgmma, bias +
//   erf-GELU in registers into a bf16 swizzled hidden tile (two, used in
//   turn), fc2 accumulated on wgmma.
// The shift / pad mask is computed from the window's coordinates:
// image-region labels of shift_attn_mask (speinet_tpu/models/swinir.py:
// 61-77) and the rolled pad rule (:356-365).
#pragma once

#include <math.h>

#include "hopper.cuh"
#include "tensor_core.cuh"

namespace swin {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int THREADS = 384;      // two consumer warpgroups + a producer warpgroup
constexpr int WS = 5;             // window size (the template's)
constexpr int NT = WS * WS;       // tokens per window
constexpr int G = 5;              // windows per CTA
constexpr int ROWS = G * NT;      // 125 live token rows
constexpr int M = 128;            // token rows of a CTA
constexpr int HD = 32;            // head dim
constexpr int SLAB = 16384;       // ring stage: [<= 128 rows][64 k] bf16
constexpr int BLK = M * 128;      // one 64-column block of a swizzled [128][64] tile
constexpr int HC = 128;           // MLP hidden columns per chunk
constexpr int LDKV = 136;         // K | V tile row stride (elements): 272 bytes
constexpr int KV_BYTES = M * LDKV * 2;
constexpr int MAX_STAGES = 4;
constexpr unsigned FULL = 0xffffffffu;

// GEMM shapes over C columns padded to CP
template <int CP>
struct Tile {
  static constexpr int NP = CP >= 128 ? 128 : 64;   // wgmma width of the C-wide GEMMs
  static constexpr int NH = CP / NP;
  static constexpr int NKB = CP / 64;               // 64-deep k-blocks over C
};

// arguments of the window kernels (K2 all, K8 all but LN2 / MLP)
struct WinArgs {
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

__device__ __forceinline__ int region(int i, int L, int shift) {
  return i < L - WS ? 0 : (i < L - shift ? 1 : 2);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ void unpack8(const uint4& u, float* v) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* v) {
  uint4 u;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return u;
}

// element offset of token row m's pixel, -1 for padding rows
__device__ __forceinline__ long long pix_off(const WinArgs& a, int m, int win0) {
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

// ---- warp specialisation

__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
}

// the ring's full (count 1) and empty (count 2: one arrival per consumer
// warpgroup) barriers, then `extra` single-arrival barriers after them
// (bar_s + 16 * MAX_STAGES + 8 i); one thread, before a __syncthreads
__device__ __forceinline__ void init_barriers(uint32_t bar_s, int stages, int extra) {
  for (int i = 0; i < stages; ++i) {
    mbar_init(bar_s + 8 * i, 1);
    mbar_init(bar_s + 8 * (MAX_STAGES + i), 2);
  }
  for (int i = 0; i < extra; ++i) mbar_init(bar_s + 16 * MAX_STAGES + 8 * i, 1);
  mbar_fence_init();
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

// the ring as the producer thread fills it
struct Producer {
  uint32_t buf, bar;
  int stages, st;
  uint32_t ph;
  // the next stage, once both warpgroups have released it, armed for `bytes`
  __device__ uint32_t next(uint32_t bytes) {
    mbar_wait(bar + 8 * (MAX_STAGES + st), ph ^ 1);
    mbar_expect_tx(bar + 8 * st, bytes);
    return buf + st * SLAB;
  }
  __device__ uint32_t full() const { return bar + 8 * st; }
  __device__ void advance() {
    if (++st == stages) {
      st = 0;
      ph ^= 1;
    }
  }
  // one slab: the box of `map` at (k0, row0), `bytes` long
  __device__ void slab(const CUtensorMap* map, uint32_t bytes, int k0, int row0) {
    tma_load_2d(next(bytes), map, full(), k0, row0);
    advance();
  }
};

// the attention half's slabs in consumption order: Q, K | V of two heads
// at a time, proj
template <int CP>
__device__ __forceinline__ void produce_attn(Producer& pr, const CUtensorMap* q,
                                             const CUtensorMap* kv, const CUtensorMap* p,
                                             int heads, int C) {
  constexpr int NP = Tile<CP>::NP, NH = Tile<CP>::NH, NKB = Tile<CP>::NKB;
  for (int kb = 0; kb < NKB; ++kb)
    for (int h = 0; h < NH; ++h) pr.slab(q, NP * 128, kb * 64, h * NP);
  for (int h0 = 0; h0 < heads; h0 += 2)
    for (int kb = 0; kb < NKB; ++kb) {
      const uint32_t dst = pr.next(SLAB);
      // a missing second head reads past the matrix: zeros
      const int h1k = h0 + 1 < heads ? (h0 + 1) * HD : 2 * C;
      const int h1v = h0 + 1 < heads ? C + (h0 + 1) * HD : 2 * C;
      tma_load_2d(dst, kv, pr.full(), kb * 64, h0 * HD);
      tma_load_2d(dst + 4096, kv, pr.full(), kb * 64, C + h0 * HD);
      tma_load_2d(dst + 8192, kv, pr.full(), kb * 64, h1k);
      tma_load_2d(dst + 12288, kv, pr.full(), kb * 64, h1v);
      pr.advance();
    }
  for (int kb = 0; kb < NKB; ++kb)
    for (int h = 0; h < NH; ++h) pr.slab(p, NP * 128, kb * 64, h * NP);
}

// the MLP's slabs in consumption order: per hidden chunk fc1, then fc2
template <int CP>
__device__ __forceinline__ void produce_mlp(Producer& pr, const CUtensorMap* w1,
                                            const CUtensorMap* w2, int n_chunks) {
  constexpr int NP = Tile<CP>::NP, NH = Tile<CP>::NH, NKB = Tile<CP>::NKB;
  for (int c = 0; c < n_chunks; ++c) {
    for (int kb = 0; kb < NKB; ++kb) pr.slab(w1, SLAB, kb * 64, c * HC);
    for (int kb = 0; kb < HC / 64; ++kb)
      for (int h = 0; h < NH; ++h) pr.slab(w2, NP * 128, c * HC + kb * 64, h * NP);
  }
}

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

// LayerNorm of this warp's 16 token rows row0 .. row0 + 15, in place:
// raw rows as TMA left them in (SWZ_SRC false: each 64-column block
// [row][64]; true: already swizzled), LN'd bf16 rows out in the swizzled
// layout, rows from nvalid on zeros (each lane reads and writes 16 bytes
// of its row's own 128-byte rows)
template <bool SWZ_SRC>
__device__ __forceinline__ void ln_rows(unsigned char* tile, int row0, int nvalid, int lane,
                                        int CP, int C, const float* lw, const float* lb) {
  const bool act = lane * 8 < C;
  float w[8], bb[8];
#pragma unroll
  for (int e = 0; e < 8; e += 2) {
    const float2 wv = act ? ldg2(lw + lane * 8 + e) : make_float2(0.0f, 0.0f);
    const float2 bv = act ? ldg2(lb + lane * 8 + e) : make_float2(0.0f, 0.0f);
    w[e] = wv.x;
    w[e + 1] = wv.y;
    bb[e] = bv.x;
    bb[e + 1] = bv.y;
  }
  const uint32_t raw_off = (lane >> 3) * BLK + (lane & 7) * 16;
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    const int m = row0 + i;
    const bool ok = m < nvalid;
    float v[8];
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (ok && act)
      raw = *reinterpret_cast<const uint4*>(tile + (SWZ_SRC ? swz(m, lane * 8)
                                                            : raw_off + m * 128));
    unpack8(raw, v);
    // one-pass clamped variance, as the JAX block
    float s = 0.0f, ss = 0.0f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s += v[e];
      ss += v[e] * v[e];
    }
    s = warp_sum(s);   // also orders every lane's read before any write
    ss = warp_sum(ss);
    const float mu = s / C;
    const float r = rsqrtf(fmaxf(ss / C - mu * mu, 0.0f) + 1e-5f);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = ok && act ? (v[e] - mu) * r * w[e] + bb[e] : 0.0f;
    if (lane * 8 < CP) *reinterpret_cast<uint4*>(tile + swz(m, lane * 8)) = pack8(v);
  }
}

// ---- the window kernels (K2, K8)

// this CTA's windows of one [B, Hp, Wp, C] image by TMA into the tile at
// dst_s: token row m of window g at row g * 25 + n, each 64-column block
// unswizzled ([row][64]); issued by one thread, completion counted on bar
template <int CP>
__device__ __forceinline__ void load_windows(const WinArgs& a, const CUtensorMap* map,
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

// the shared-memory regions of a window kernel
struct WinSmem {
  unsigned char* sA;    // yn, then xn (then K2's LN2 rows; the output rows)
  unsigned char* sQ;    // Q -> O (then K2's hidden chunks)
  bf16* sKV;            // [M][LDKV]: K | V of two heads
  uint32_t* other;      // [G][NT] mask bits: key in another shift region
  uint32_t* padm;       // [G] mask bits: key is padding after the roll
  float* sbias;         // [2][NT][NT] relative-position bias of two heads
  uint32_t sA_s, sQ_s, ring_s, bar_s;
};

__device__ __forceinline__ WinSmem win_smem(unsigned char* smem, const WinArgs& a) {
  WinSmem s;
  s.sA = smem;
  s.sQ = smem + a.off_q;
  s.sKV = reinterpret_cast<bf16*>(smem + a.off_kv);
  s.other = reinterpret_cast<uint32_t*>(smem + a.off_msk);
  s.padm = s.other + G * NT;
  s.sbias = reinterpret_cast<float*>(smem + a.off_bias);
  s.sA_s = smem_u32(s.sA);
  s.sQ_s = smem_u32(s.sQ);
  s.ring_s = smem_u32(smem + a.off_ring);
  s.bar_s = smem_u32(smem + a.off_bar);
  return s;
}

// the y (Q stream) and x (K / V stream) window barriers after the ring's
__device__ __forceinline__ uint32_t ybar(const WinSmem& s) { return s.bar_s + 16 * MAX_STAGES; }
__device__ __forceinline__ uint32_t xbar(const WinSmem& s) { return ybar(s) + 8; }

// the -100 terms of the mask, from window coordinates: bit j of
// other[g][n] = key j lies in another shift region than query n, of
// pad[g] = key j is padding after the roll
__device__ __forceinline__ void window_masks(const WinArgs& a, const WinSmem& s, int win0) {
  const int tid = threadIdx.x;
  if (tid >= ROWS) return;
  const int g = tid / NT;
  const int n = tid % NT;
  const int win = min(win0 + g, a.total_win - 1);
  const int nww = a.Wp / WS;
  const int rem = win % ((a.Hp / WS) * nww);
  const int wr = rem / nww;
  const int wc = rem % nww;
  const int qlab = 3 * region(wr * WS + n / WS, a.Hp, a.shift)
                   + region(wc * WS + n % WS, a.Wp, a.shift);
  uint32_t o = 0, pd = 0;
  for (int j = 0; j < NT; ++j) {
    const int ki = wr * WS + j / WS;
    const int kj = wc * WS + j % WS;
    if (a.shift > 0 && 3 * region(ki, a.Hp, a.shift) + region(kj, a.Wp, a.shift) != qlab)
      o |= 1u << j;
    // (ki + shift) mod Hp, ki < Hp and shift < WS <= Hp
    const int ri = ki + a.shift >= a.Hp ? ki + a.shift - a.Hp : ki + a.shift;
    const int rj = kj + a.shift >= a.Wp ? kj + a.shift - a.Wp : kj + a.shift;
    if (ri >= a.h_valid || rj >= a.w_valid) pd |= 1u << j;
  }
  s.other[tid] = o;
  if (n == 0) s.padm[g] = pd;
}

// per (window, head): S = q k^T + bias + mask, softmax, O = P v on
// mma.sync over 32 x 32 tiles (25 tokens padded), O over Q in sQ. A task
// is one window, one head of the pair h0, h0 + 1 and one 16-row half of
// the padded queries: twenty per head pair over the eight consumer warps.
__device__ __forceinline__ void attend_pair(const WinArgs& a, const WinSmem& s, int h0, int nh,
                                            int win0) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q4 = lane & 3;
  // fragment coordinates of mma.m16n8k16 and of ldmatrix row addresses
  const int g4 = lane >> 2;
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const uint32_t kv_s = smem_u32(s.sKV);
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
      ldmatrix_x4(qa[ks], s.sQ_s + swz(min(rq + a_row, M - 1), head * HD + ks * 16 + a_col));
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
    const uint32_t pd = s.padm[g];
    uint32_t pa[2][4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int n = min(mt * 16 + g4 + 8 * hh, NT - 1);
      const uint32_t ot = s.other[rb + n];
      const float* bias = s.sbias + (hs * NT + n) * NT;
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
          *reinterpret_cast<uint32_t*>(s.sQ + swz(rb + n, head * HD + nt * 8 + 2 * q4)) =
              pack_bf16x2(o[nt][2 * hh], o[nt][2 * hh + 1]);
      }
    }
  }
}

// The consumers' attention half of a window kernel, through the
// projection GEMM: res = O Wp^T, without bp. y's windows are loaded here
// (parity 0 of ybar), x's once the Q GEMM has read yn (parity 0 of xbar).
// reload_x: x's windows come back into sA after the last K | V GEMM, while
// the last heads' attention runs (parity 1 of xbar: K2's residual);
// otherwise sA is free from the last K | V GEMM on.
template <int CP>
__device__ __forceinline__ void window_attention(const WinArgs& a, const WinSmem& s,
                                                 const CUtensorMap* xmap,
                                                 const CUtensorMap* ymap, Ring& ring,
                                                 int win0, bool reload_x,
                                                 float (*res)[Tile<CP>::NP / 2]) {
  constexpr int NP = Tile<CP>::NP, NH = Tile<CP>::NH, NKB = Tile<CP>::NKB;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wg = warp >> 2;
  const int q4 = lane & 3;
  const int r0 = wg * 64 + (warp & 3) * 16 + (lane >> 2);   // accumulator rows r0, r0 + 8
  const int wg_bar = 2 + wg;
  const int C = a.C;
  const int nvalid = min(G, a.total_win - win0) * NT;

  // ---- Q = (LN1(y) Wq^T + bq) * scale -> sQ
  if (tid == 0) load_windows<CP>(a, ymap, s.sA_s, ybar(s), win0);
  mbar_wait(ybar(s), 0);
  ln_rows<false>(s.sA, wg * 64 + (warp & 3) * 16, nvalid, lane, CP, C, a.ln1w, a.ln1b);
  fence_proxy_async();
  bar_sync(wg_bar, 128);
  {
    float acc[NH][NP / 2];
    gemm<NP, NH>(acc, s.sA_s, NKB, ring, true);
    // both warpgroups have read yn: x's windows may overwrite it while the
    // epilogue runs
    bar_sync(1, 256);
    if (tid == 0) load_windows<CP>(a, xmap, s.sA_s, xbar(s), win0);
#pragma unroll
    for (int p = 0; p < NH; ++p)
#pragma unroll
      for (int j = 0; j < NP / 8; ++j) {
        const int col = p * NP + 8 * j + 2 * q4;
        const bool live = col < C;
        const float2 bq = live ? ldg2(a.bq + col) : make_float2(0.0f, 0.0f);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t v = live ? pack_bf16x2((acc[p][4 * j + 2 * h] + bq.x) * a.scale,
                                                (acc[p][4 * j + 2 * h + 1] + bq.y) * a.scale)
                                  : 0u;
          *reinterpret_cast<uint32_t*>(s.sQ + swz(r0 + 8 * h, col)) = v;
        }
      }
  }
  // ---- LN1(x) -> sA
  mbar_wait(xbar(s), 0);
  ln_rows<false>(s.sA, wg * 64 + (warp & 3) * 16, nvalid, lane, CP, C, a.ln1w, a.ln1b);
  fence_proxy_async();
  bar_sync(wg_bar, 128);
  window_masks(a, s, win0);

  for (int h0 = 0; h0 < a.heads; h0 += 2) {
    const int nh = min(2, a.heads - h0);
    // ---- K | V of heads h0, h0 + 1 = xn Wkv^T + bkv (one m64n128 GEMM)
    float acc[1][64];
    gemm<128, 1>(acc, s.sA_s, NKB, ring, true);
    if (h0 > 0) bar_sync(1, 256);   // the previous pair's attention has read sKV
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * q4;            // [K h0 | V h0 | K h1 | V h1]
      const int hs = col >> 6;
      const int c32 = col & 63;
      const int feat = (c32 < HD ? 0 : C - HD) + (h0 + hs) * HD + c32;
      const bool live = hs < nh;
      const float2 bk = live ? ldg2(a.bkv + feat) : make_float2(0.0f, 0.0f);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint32_t*>(s.sKV + (r0 + 8 * hh) * LDKV + col) =
            pack_bf16x2(acc[0][4 * j + 2 * hh] + bk.x, acc[0][4 * j + 2 * hh + 1] + bk.y);
    }
    // the two heads' relative-position bias, [2][NT][NT] f32
    for (int i = tid; i < nh * NT * NT; i += 256) s.sbias[i] = __ldg(a.relbias + h0 * NT * NT + i);
    bar_sync(1, 256);   // K | V of all rows (windows straddle the two halves)
    // after the last K | V GEMM nothing reads xn
    if (reload_x && h0 + 2 >= a.heads && tid == 0)
      load_windows<CP>(a, xmap, s.sA_s, xbar(s), win0);
    attend_pair(a, s, h0, nh, win0);
  }
  // O rows were written by the warps of both warpgroups
  fence_proxy_async();
  bar_sync(1, 256);
  gemm<NP, NH>(res, s.sQ_s, NKB, ring, true);
}

// res + bias rounded to bf16 into sA's rows ([row][64] blocks, as the image
// boxes lie), then this CTA's windows of the image `omap` by TMA. The
// caller's GEMMs have read this warpgroup's rows of sA; the other
// warpgroup's rows are its own.
template <int CP>
__device__ __forceinline__ void store_windows(const WinArgs& a, const WinSmem& s,
                                              const CUtensorMap* omap,
                                              float (*res)[Tile<CP>::NP / 2],
                                              const float* bias, int win0) {
  constexpr int NP = Tile<CP>::NP, NH = Tile<CP>::NH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int q4 = lane & 3;
  const int r0 = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int p = 0; p < NH; ++p)
#pragma unroll
      for (int j = 0; j < NP / 8; ++j) {
        const int col = p * NP + 8 * j + 2 * q4;
        const float2 bo = col < a.C ? ldg2(bias + col) : make_float2(0.0f, 0.0f);
        *reinterpret_cast<uint32_t*>(s.sA + (col >> 6) * BLK + (r0 + 8 * h) * 128 + (col & 63) * 2) =
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
        tma_store_4d(omap, s.sA_s + blk * BLK + g * NT * 128, blk * 64, (rem % nww) * WS,
                     (rem / nww) * WS, b);
    }
    bulk_commit();
    bulk_wait_read();
  }
}

// ---- the MLP (K2, K9)

// res (+)= gelu(A W1^T + b1) W2^T over n_chunks hidden chunks of HC, A the
// LN'd rows in the swizzled tile at a_s, the GELU'd chunk rounded to bf16
// into one of two [M][HC] swizzled tiles at hid (in turn). fresh: the first
// fc2 product overwrites res (K9) instead of adding to it (K2). A chunk past
// `hidden` reads zero weights and gives gelu(0) = 0. after_fc1() runs once
// every warp of the warpgroup is past the last fc1 GEMM, which read A.
template <int CP, class AfterFc1>
__device__ __forceinline__ void mlp_chunks(float (*res)[Tile<CP>::NP / 2], uint32_t a_s,
                                           unsigned char* hid0, Ring& ring, const float* b1,
                                           int hidden, bool fresh, AfterFc1 after_fc1) {
  constexpr int NP = Tile<CP>::NP, NH = Tile<CP>::NH, NKB = Tile<CP>::NKB;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int q4 = lane & 3;
  const int r0 = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int wg_bar = 2 + (tid >> 7);
  const int n_chunks = (hidden + HC - 1) / HC;
  for (int c = 0; c < n_chunks; ++c) {
    unsigned char* hid = hid0 + (c & 1) * 2 * BLK;   // [M][128] swizzled, bf16
    {
      float acc[1][64];
      gemm<128, 1>(acc, a_s, NKB, ring, true);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 8 * j + 2 * q4;
        const bool live = c * HC + col < hidden;
        const float2 bh = live ? ldg2(b1 + c * HC + col) : make_float2(0.0f, 0.0f);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float t0 = acc[0][4 * j + 2 * h] + bh.x;
          const float t1 = acc[0][4 * j + 2 * h + 1] + bh.y;
          *reinterpret_cast<uint32_t*>(hid + swz(r0 + 8 * h, col)) = pack_bf16x2(
              0.5f * t0 * (1.0f + erff(t0 * 0.70710678118654752f)),
              0.5f * t1 * (1.0f + erff(t1 * 0.70710678118654752f)));
        }
      }
    }
    fence_proxy_async();
    bar_sync(wg_bar, 128);
    if (c + 1 == n_chunks) after_fc1();
    gemm<NP, NH>(res, smem_u32(hid), HC / 64, ring, fresh && c == 0);
  }
}

// ---- host side

// a [rows, inner] bf16 row-major matrix read (or written) in boxes of
// 64 x box_rows, 128-byte swizzled; reads past its edge fill zeros,
// writes past it are dropped
inline bool make_map(CUtensorMap* map, const void* ptr, int inner, long long rows,
                     int box_rows) {
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
inline bool make_img_map(CUtensorMap* map, const void* ptr, const WinArgs& a) {
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

// the checks both window kernels' entry points make, and the fields of a
// they share; false for shapes they do not take
inline bool window_args(WinArgs& a, const void* x, const void* y, void* out, int B, int Hp,
                        int Wp, int C, int heads, int ws, int shift, int h_valid,
                        int w_valid, float scale) {
  if (ws != WS || Hp % WS != 0 || Wp % WS != 0 || C % HD != 0 || C > 256 ||
      heads * HD != C || shift < 0 || shift >= WS || h_valid < 1 || h_valid > Hp ||
      w_valid < 1 || w_valid > Wp)
    return false;
  const long long total_win = (long long)B * (Hp / WS) * (Wp / WS);
  if (total_win < 1 || (total_win + G - 1) / G > 0x7fffffffLL) return false;
  a.x = static_cast<const bf16*>(x);
  a.y = static_cast<const bf16*>(y);
  a.out = static_cast<bf16*>(out);
  a.B = B;
  a.Hp = Hp;
  a.Wp = Wp;
  a.C = C;
  a.heads = heads;
  a.shift = shift;
  a.h_valid = h_valid;
  a.w_valid = w_valid;
  a.total_win = (int)total_win;
  a.scale = scale;
  return true;
}

// shared-memory plan of a window kernel at CP columns: sA, sQ (room for two
// hidden chunks when mlp), the ring, K | V, masks, bias, barriers. Returns
// the dynamic shared memory to ask for, or 0 if fewer than two ring stages
// fit.
inline int window_layout(WinArgs& a, int CP, bool mlp) {
  const int tile = M * CP * 2;
  const int msk_bytes = (G * NT + G) * 4 + 2 * NT * NT * 4;   // masks, bias of two heads
  a.off_q = tile;
  a.off_ring = tile + (mlp && tile < 4 * BLK ? 4 * BLK : tile);
  const int fixed = a.off_ring + KV_BYTES + msk_bytes + 16 * MAX_STAGES + 16 + 1024;
  a.stages = (227 * 1024 - fixed) / SLAB;
  if (a.stages > MAX_STAGES) a.stages = MAX_STAGES;
  if (a.stages < 2) return 0;
  a.off_kv = a.off_ring + a.stages * SLAB;
  a.off_msk = a.off_kv + KV_BYTES;
  a.off_bias = a.off_msk + (G * NT + G) * 4;
  a.off_bar = (a.off_msk + msk_bytes + 7) & ~7;
  return a.off_bar + 16 * MAX_STAGES + 16 + 1024;
}

}  // namespace swin
