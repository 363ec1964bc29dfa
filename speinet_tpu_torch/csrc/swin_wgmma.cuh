// Hopper stages of the Swin kernels, composed by K2 (swin_block.cu, the
// whole block), K8 (swin_attn.cu, LN1 + window cross-attention + proj) and
// K9 (swin_mlp.cu, x + MLP(LN2(x))).
//
// Thread layout (all three): 384 threads, warps 0-7 two consumer
// warpgroups that own 64 token rows each, warps 8-11 the producer
// warpgroup: one thread of warp 8 issues the weight copies, warp 9 (K2,
// K8) is the loader of the window images and the masks; setmaxnreg hands
// the producer warpgroup's registers to the consumers (40 and 232 a
// thread). A window group is M = 128 token rows: five 5x5 windows (125
// rows) of one stream image in K2 / K8, 128 consecutive [rows, C] rows in
// K9.
//
// - Tiles: a [128 rows][CP] bf16 operand lies in shared memory as CP / 64
//   blocks of [128][64], each in the canonical 128-byte-swizzled K-major
//   layout (`swz`), the A operand of wgmma. CP = 64, 128 or 256 is C
//   rounded up; the padded columns stay zero.
// - Weights (torch Linear layout, K-major) stream through a `Ring` of
//   16 KB slabs, [<= 128 rows][64 k] each (fc1's [64 rows][2 x 64 k]),
//   loaded by TMA (SWIZZLE_128B) under full / empty mbarriers. The producer walks the kernel's slabs in
//   the order the consumers' `gemm`s take them (`produce_attn`,
//   `produce_mlp`); both warpgroups read every slab, so a stage is empty
//   after two arrivals.
// - `gemm`: acc (+)= A[the warpgroup's 64 rows] x W^T on wgmma m64nNk16,
//   bf16 operands, f32 accumulators in registers; one commit group a slab,
//   each slab released once the next is in flight, and optional side work
//   on the warps while the tensor cores hold a slab's MMAs (the MLP's
//   GELU); `finish` completes what a gemm left in flight.
// - Epilogues go through a shared-memory scratch (`pairs_via_scratch`),
//   32 accumulator registers at a time walked by one rolled loop, four
//   pairs' loads ahead of their stores; the biases and LayerNorm
//   parameters are staged in shared memory (`stage_params`).
// - `ln_rows`: LayerNorm of a warp's 16 rows in place in a tile that TMA
//   filled (raw [row][64] boxes, or swizzled ones), one-pass clamped
//   variance as in the JAX block, bf16 swizzled rows out.
// - `window_attention` (K2, K8): LN1(y) -> Q (scaled, bf16), LN1(x), then
//   per pair of heads K|V on one m64n128 GEMM and the attention per
//   (window, head, 16-query half) on mma.sync m16n8k16 (S = q k^T, bias and
//   the -100 shift / pad terms, f32 softmax, bf16 P, O = P v, O over Q),
//   three tasks a warp interleaved, then the projection GEMM.
// - `mlp_chunks` (K2, K9): per 64-wide hidden chunk fc1 on wgmma, then
//   its bias + erf-GELU into a bf16 swizzled hidden tile (two, used in
//   turn) while the tensor cores accumulate the chunk before's fc2.
// Why the code is shaped as it is (K2's measured phases, swin_block.cu):
// what runs once per window group is fetched again from L2 for every group
// once a kernel's code passes the SM's ~128 KB instruction cache, so the
// epilogues loop instead of unrolling over the accumulators; and ptxas
// keeps a shared-memory load behind any earlier store it cannot tell
// apart and schedules nothing across a branch, so loops load before they
// store and LayerNorm's divisions get a lane of their own.
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
constexpr int SLAB = 16384;       // ring stage: [<= 128 rows][64 k] bf16, or fc1's [64][128 k]
constexpr int BLK = M * 128;      // one 64-column block of a swizzled [128][64] tile
constexpr int HC = 64;            // MLP hidden columns per chunk
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
  static constexpr int KPS1 = NKB >= 2 ? 2 : 1;     // fc1's k-blocks a slab (16 KB)
};

// arguments of the window kernels (K2 all, K8 all but LN2 / MLP)
struct WinArgs {
  const bf16* x;
  const bf16* y;
  bf16* out;
  const float *ln1w, *ln1b, *bkv, *bq, *bp, *relbias, *ln2w, *ln2b, *b1, *b2;
  int B, Hp, Wp, C, hidden, heads, shift, h_valid, w_valid, total_win;
  float scale;
  int stages, off_ring, off_bar;
};

// two consecutive f32 parameters (biases, LayerNorm weights) by the
// read-only path: such loads need not wait behind the shared-memory
// stores around them, which the compiler cannot tell apart from global ones
__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// two consecutive f32 parameters of a vector staged in shared memory
__device__ __forceinline__ float2 lds2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// dst[0 : n_pad] = src[0 : n] and zeros after it: a parameter vector copied
// into shared memory by nt threads, t this thread's index among them. The
// epilogues read their biases and LayerNorm parameters from there: read
// from global memory inside them, each read waited on L2 with the
// accumulators holding the registers that would let the loads run ahead.
__device__ __forceinline__ void stage_vec(float* dst, const float* src, int n, int n_pad,
                                          int t, int nt) {
#pragma unroll 1
  for (int i = t; i < n_pad; i += nt) dst[i] = i < n ? __ldg(src + i) : 0.0f;
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

// the weight ring as one consumer warpgroup walks it: slabs are acquired in
// order (rd) and released in the same order (rl), up to `stages` apart
struct Ring {
  uint32_t buf, bar;
  int stages, rd, rl;
  uint32_t ph;
  bool held;   // the last slab acquired may still be read by MMAs in flight
  __device__ uint32_t full(int i) const { return bar + 8 * i; }
  __device__ uint32_t empty(int i) const { return bar + 8 * (MAX_STAGES + i); }
  __device__ uint32_t acquire() {
    mbar_wait(full(rd), ph);
    const uint32_t slab = buf + rd * SLAB;
    if (++rd == stages) {
      rd = 0;
      ph ^= 1;
    }
    return slab;
  }
  // once the MMAs that read the oldest acquired slab have completed, hand it
  // back to the producer at once: with a 3-stage ring every stage counts
  __device__ void release() {
    if ((threadIdx.x & 127) == 0) mbar_arrive(empty(rl));
    if (++rl == stages) rl = 0;
  }
  // every MMA issued has completed (on every path: ptxas serialises the
  // MMAs where it cannot see that), every slab is back with the producer
  __device__ void drain() {
    wgmma_wait<0>();
    if (held) release();
    held = false;
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
#pragma unroll 1
  for (int kb = 0; kb < NKB; ++kb)
    for (int h = 0; h < NH; ++h) pr.slab(q, NP * 128, kb * 64, h * NP);
#pragma unroll 1
  for (int h0 = 0; h0 < heads; h0 += 2)
#pragma unroll 1
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
#pragma unroll 1
  for (int kb = 0; kb < NKB; ++kb)
    for (int h = 0; h < NH; ++h) pr.slab(p, NP * 128, kb * 64, h * NP);
}

// the MLP's slabs in consumption order (mlp_chunks): fc1 of chunk 0, then
// per chunk c fc1 of chunk c + 1 and fc2 of chunk c
template <int CP>
__device__ __forceinline__ void produce_mlp(Producer& pr, const CUtensorMap* w1,
                                            const CUtensorMap* w2, int n_chunks) {
  constexpr int NP = Tile<CP>::NP, NH = Tile<CP>::NH, NKB = Tile<CP>::NKB;
#pragma unroll 1
  for (int c = -1; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      constexpr int KPS = Tile<CP>::KPS1;
#pragma unroll 1
      for (int ks = 0; ks < NKB / KPS; ++ks) {
        const uint32_t dst = pr.next(KPS * HC * 128);
        for (int kk = 0; kk < KPS; ++kk)
          tma_load_2d(dst + kk * HC * 128, w1, pr.full(), (ks * KPS + kk) * 64, (c + 1) * HC);
        pr.advance();
      }
    }
    if (c >= 0) {
      for (int h = 0; h < NH; ++h) pr.slab(w2, NP * 128, c * HC, h * NP);
    }
  }
}

// acc[p] (+)= A[this warpgroup's 64 rows, 0 : 64 NKB] x W^T over NKB
// k-blocks of P slabs each (slab p: output columns p*NW .. +NW-1); A is a
// swizzled tile at a_s (shared address). fresh: the first k-step
// overwrites acc. Each slab's MMAs are one commit group. Once slab i's
// group is issued, side(i) runs on the warps while the tensor cores work,
// and then the slab before it is released once its group has completed
// (wait<1>): the tensor cores hold the next chain while the warps do the
// side work or wait for the one before. The last slab stays held: its
// MMAs may still be in flight when gemm returns, and the caller's
// `finish` (or the next gemm's first wait) completes them. issue false:
// no MMAs and no slabs, only the side work (a uniform branch, so that a
// side work has one copy of its code). A k16 step's descriptors are the
// slab's and the tile's plus an offset: the kernels' code has to fit the
// SM's instruction cache (swin_block.cu). (A rolled k-block loop, smaller
// still, made ptxas spill and serialise the MMAs: a chain in flight across
// its back edge holds the accumulators.)
template <int NW, int P, int NKB, int KPS = 1, class Side>
__device__ __forceinline__ void gemm(float (*acc)[NW / 2], uint32_t a_s, Ring& ring, bool fresh,
                                     Side side, bool issue = true) {
  const uint64_t da = make_desc(a_s + ((threadIdx.x >> 7) & 1) * 64 * 128, 16, 1024, 1);
#pragma unroll
  for (int ks = 0; ks < NKB / KPS; ++ks) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (issue) {
        const uint64_t db = make_desc(ring.acquire(), 16, 1024, 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4 * KPS; ++kk) {
          const int kb = ks * KPS + kk / 4;
          wgmma_ss<NW, 0>(acc[p], da + (uint64_t)((kb * BLK + kk % 4 * 32) >> 4),
                          db + (((kk / 4) * NW * 128 + kk % 4 * 32) >> 4),
                          (fresh && kb == 0 && kk % 4 == 0) ? 0 : 1);
        }
        wgmma_commit();
      }
      side(ks * P + p);
      if (issue) {
        if (ring.held) {
          wgmma_wait<1>();
          ring.release();
        }
        ring.held = true;
      }
    }
  }
}

// every MMA issued has completed (acc's among them), the slabs released
template <int NW, int P>
__device__ __forceinline__ void finish(float (*acc)[NW / 2], Ring& ring) {
  ring.drain();
#pragma unroll
  for (int p = 0; p < P; ++p) fence_regs<NW / 2>(acc[p]);
}

// a GEMM with nothing beside it, completed
template <int NW, int P, int NKB, int KPS = 1>
__device__ __forceinline__ void gemm(float (*acc)[NW / 2], uint32_t a_s, Ring& ring, bool fresh) {
  gemm<NW, P, NKB, KPS>(acc, a_s, ring, fresh, [](int) {});
  finish<NW, P>(acc, ring);
}

// ---- epilogues through a scratch
//
// An epilogue written out over an accumulator fragment is one copy of its
// code per register; executed once per window group, such code is fetched
// from L2 every time. Instead 32 registers at a time go to a scratch in
// shared memory ([16][256] float2, thread-major: conflict-free), and one
// rolled loop walks their 16 pairs. Each thread reads back only what it
// wrote, so no barrier is needed.
constexpr int SCRATCH_BYTES = 16 * 256 * 8;
static_assert(SCRATCH_BYTES + 8 * 16 * 8 <= KV_BYTES,
              "the window kernels' scratch and LN statistics lie over K | V");

// two pairs of f32 values: what an epilogue loads for one pair besides it
struct Pair2 {
  float2 a, b;
};

// f(p, j, h, v, load(p, j, h)) over this thread's pairs v of r[P][NW / 2],
// the fragment of an m64nNW accumulator for each of P column parts: pair
// (p, j, h) is row r0 + 8 h, columns p NW + 8 j + 2 (lane % 4) + {0, 1}.
// With WB the pairs f returns are written back into r. One copy of the
// code serves every piece (the piece is picked by a branch), four pairs at
// a time: their loads (the scratch, and what load() reads) all come before
// f's stores, since ptxas keeps a shared-memory load behind any earlier
// store it cannot tell apart, which would run the four one after another.
template <int NW, int P, bool WB, class L, class F>
__device__ __forceinline__ void pairs_via_scratch(float (*r)[NW / 2], float2* scr, L load,
                                                  F f) {
  constexpr int PER = NW / 64;   // 32-register pieces per column part
  float2* mine = scr + (threadIdx.x & 255);
#pragma unroll 1
  for (int k = 0; k < P * PER; ++k) {
#pragma unroll
    for (int kk = 0; kk < P * PER; ++kk)
      if (kk == k) {
        const float* rk = &r[kk / PER][(kk % PER) * 32];
#pragma unroll
        for (int i = 0; i < 16; ++i) mine[i * 256] = make_float2(rk[2 * i], rk[2 * i + 1]);
      }
    const int p = k / PER, j0 = (k % PER) * 8;
#pragma unroll 1
    for (int i0 = 0; i0 < 16; i0 += 4) {
      float2 v[4];
      decltype(load(0, 0, 0)) aux[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[q] = mine[(i0 + q) * 256];
        aux[q] = load(p, j0 + (i0 >> 1) + (q >> 1), q & 1);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 o = f(p, j0 + (i0 >> 1) + (q >> 1), q & 1, v[q], aux[q]);
        if (WB) mine[(i0 + q) * 256] = o;
      }
    }
    if (WB) {
#pragma unroll
      for (int kk = 0; kk < P * PER; ++kk)
        if (kk == k) {
          float* rk = &r[kk / PER][(kk % PER) * 32];
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const float2 v = mine[i * 256];
            rk[2 * i] = v.x;
            rk[2 * i + 1] = v.y;
          }
        }
    }
  }
}

// LayerNorm of this warp's 16 token rows row0 .. row0 + 15, in place:
// raw rows as TMA left them in (SWZ_SRC false: each 64-column block
// [row][64]; true: already swizzled), LN'd bf16 rows out in the swizzled
// layout, rows from nvalid on zeros (each lane reads and writes 16 bytes
// of its row's own 128-byte rows); lw, lb staged in shared memory, stat
// 16 float2 of this warp's own. First every row's sums (four rows'
// reductions interleaved), then each row's mean and scale on a lane of its
// own (an IEEE division branches to its slow path, which no other row's
// work could be scheduled across), then the rows normalised.
template <bool SWZ_SRC>
__device__ __forceinline__ void ln_rows(unsigned char* tile, int row0, int nvalid, int lane,
                                        int CP, int C, const float* lw, const float* lb,
                                        float2* stat) {
  const bool act = lane * 8 < C;
  const uint32_t raw_off = (lane >> 3) * BLK + (lane & 7) * 16;
  auto src = [&](int m) { return tile + (SWZ_SRC ? swz(m, lane * 8) : raw_off + m * 128); };
#pragma unroll 1
  for (int i = 0; i < 16; i += 4) {
    float s[4], ss[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = row0 + i + q;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (m < nvalid && act) raw = *reinterpret_cast<const uint4*>(src(m));
      float v[8];
      unpack8(raw, v);
      // one-pass clamped variance, as the JAX block
      s[q] = 0.0f;
      ss[q] = 0.0f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s[q] += v[e];
        ss[q] += v[e] * v[e];
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      s[q] = warp_sum(s[q]);
      ss[q] = warp_sum(ss[q]);
    }
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) stat[i + q] = make_float2(s[q], ss[q]);
    }
  }
  __syncwarp();
  if (lane < 16) {
    const float2 st = stat[lane];
    const float mu = st.x / C;
    stat[lane] = make_float2(mu, rsqrtf(fmaxf(st.y / C - mu * mu, 0.0f) + 1e-5f));
  }
  __syncwarp();
  float w[8], bb[8];
#pragma unroll
  for (int e = 0; e < 8; e += 2) {
    const float2 wv = act ? lds2(lw + lane * 8 + e) : make_float2(0.0f, 0.0f);
    const float2 bv = act ? lds2(lb + lane * 8 + e) : make_float2(0.0f, 0.0f);
    w[e] = wv.x;
    w[e + 1] = wv.y;
    bb[e] = bv.x;
    bb[e + 1] = bv.y;
  }
  // two rows at a time, both read before either is written (a store ahead
  // of the next row's load would hold the load back); a row is read whole
  // by the warp before any lane writes it
#pragma unroll 1
  for (int i = 0; i < 16; i += 2) {
    uint4 raw[2];
    float2 st[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int m = row0 + i + q;
      raw[q] = make_uint4(0, 0, 0, 0);
      if (m < nvalid && act) raw[q] = *reinterpret_cast<const uint4*>(src(m));
      st[q] = stat[i + q];
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int m = row0 + i + q;
      const bool ok = m < nvalid;
      float v[8];
      unpack8(raw[q], v);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = ok && act ? (v[e] - st[q].x) * st[q].y * w[e] + bb[e] : 0.0f;
      if (lane * 8 < CP) *reinterpret_cast<uint4*>(tile + swz(m, lane * 8)) = pack8(v);
    }
  }
}

// a warp's 16 token rows row0 .. row0 + 15 of a tile moved in place
// between the raw layout that TMA reads and writes ([row][64] per 64-column
// block) and the swizzled one (`swz`; TO_SWZ: raw -> swizzled). A row's
// chunks are permuted within its own 128-byte rows, so every lane moves one
// 16-byte chunk and a row is read whole before it is written. Accumulator
// fragments (8 rows x 16 bytes) read or written in the raw layout hit the
// same four banks eight times; in the swizzled one they hit all 32.
template <bool TO_SWZ>
__device__ __forceinline__ void reswizzle_rows(unsigned char* tile, int row0, int lane, int CP) {
  const bool act = (lane >> 3) * 64 < CP;
  const uint32_t raw = (lane >> 3) * BLK + (lane & 7) * 16;
#pragma unroll 1
  for (int i = 0; i < 16; i += 4) {
    uint4 v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int m = row0 + i + k;
      if (act)
        v[k] = *reinterpret_cast<const uint4*>(tile + (TO_SWZ ? raw + m * 128 : swz(m, lane * 8)));
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int m = row0 + i + k;
      if (act)
        *reinterpret_cast<uint4*>(tile + (TO_SWZ ? swz(m, lane * 8) : raw + m * 128)) = v[k];
    }
  }
  __syncwarp();
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
#pragma unroll 1
  for (int g = 0; g < nv; ++g) {
    const int win = win0 + g;
    const int b = win / per_img;
    const int rem = win - b * per_img;
#pragma unroll 1
    for (int blk = 0; blk < CP / 64; ++blk)
      tma_load_4d(dst_s + blk * BLK + g * NT * 128, map, bar, blk * 64, (rem % nww) * WS,
                  (rem / nww) * WS, b);
  }
}

// The shared-memory plan of a window kernel. Every region but the ring and
// the barriers lies at a fixed offset, so that an address is the CTA's base
// plus a constant and nothing but the base stays live in registers:
//   [0, TILE)           sA: x -> xn (then K2's x again, its LN2 rows, the
//                       output rows)
//   [TILE, 2 TILE)      sQ: y -> yn -> Q -> O (then K2's hidden chunks)
//   K | V of two heads  [M][LDKV] bf16; else the epilogues' scratch and
//                       LN1's row statistics
//   masks               [G][NT] bits: key in another shift region, [G] bits:
//                       key is padding after the roll; two sets, by the
//                       group's parity (the loader warp fills the next one)
//   bias                [2][NT][NT] f32: relative-position bias of two heads
//   parameters          f32 vectors of 256 (stage_params): ln1 w, b, bq, bp,
//                       then K2's ln2 w, b, b2 and b1 (whole hidden chunks)
//   ring, barriers      at a.off_ring, a.off_bar (window_layout)
constexpr int TILE = 4 * BLK;   // a [128][256] bf16 tile, or two hidden chunks
constexpr int OFF_KV = 2 * TILE;
constexpr int OFF_MSK = OFF_KV + KV_BYTES;
constexpr int MSK_BYTES = (G * NT + G) * 4;
constexpr int OFF_BIAS = OFF_MSK + 2 * MSK_BYTES;
constexpr int OFF_PRM = (OFF_BIAS + 2 * NT * NT * 4 + 15) & ~15;
constexpr int PV = 256;         // floats of a staged parameter vector
static_assert(M * 256 * 2 <= TILE && OFF_PRM % 16 == 0, "window kernel plan");

struct WinSmem {
  unsigned char* base;   // the CTA's dynamic shared memory, 1024-aligned
  uint32_t mo;           // the group's set of masks: 0 or MSK_BYTES
  uint32_t ring_s, bar_s;
  __device__ unsigned char* sA() const { return base; }
  __device__ unsigned char* sQ() const { return base + TILE; }
  __device__ uint32_t sA_s() const { return smem_u32(base); }
  __device__ uint32_t sQ_s() const { return smem_u32(base) + TILE; }
  __device__ bf16* sKV() const { return reinterpret_cast<bf16*>(base + OFF_KV); }
  __device__ uint32_t* other() const {
    return reinterpret_cast<uint32_t*>(base + OFF_MSK + mo);
  }
  __device__ uint32_t* padm() const { return other() + G * NT; }
  __device__ float* sbias() const { return reinterpret_cast<float*>(base + OFF_BIAS); }
  // LN1's row statistics of a warp, past the scratch in K | V's region
  __device__ float2* lnstat(int warp) const {
    return reinterpret_cast<float2*>(base + OFF_KV + SCRATCH_BYTES) + warp * 16;
  }
  __device__ float* prm(int k) const { return reinterpret_cast<float*>(base + OFF_PRM) + k * PV; }
  __device__ float* ln1w() const { return prm(0); }
  __device__ float* ln1b() const { return prm(1); }
  __device__ float* bq() const { return prm(2); }
  __device__ float* bp() const { return prm(3); }
  __device__ float* ln2w() const { return prm(4); }
  __device__ float* ln2b() const { return prm(5); }
  __device__ float* b2() const { return prm(6); }
  __device__ float* b1() const { return prm(7); }
};

// odd: the other set of masks (K2's odd window groups)
__device__ __forceinline__ WinSmem win_smem(unsigned char* smem, const WinArgs& a,
                                            bool odd = false) {
  return WinSmem{smem, odd ? (uint32_t)MSK_BYTES : 0u, smem_u32(smem + a.off_ring),
                 smem_u32(smem + a.off_bar)};
}

// the epilogues' scratch (pairs_via_scratch), over K | V while that is dead
__device__ __forceinline__ float2* scratch(const WinSmem& s) {
  return reinterpret_cast<float2*>(s.sKV());
}

// the parameter vectors of the attention half (and, with mlp, of the MLP)
// into shared memory, by the 256 consumer threads; read after a barrier
template <int CP>
__device__ __forceinline__ void stage_params(const WinArgs& a, const WinSmem& s, bool mlp) {
  const int t = threadIdx.x;
  stage_vec(s.ln1w(), a.ln1w, a.C, CP, t, 256);
  stage_vec(s.ln1b(), a.ln1b, a.C, CP, t, 256);
  stage_vec(s.bq(), a.bq, a.C, CP, t, 256);
  stage_vec(s.bp(), a.bp, a.C, CP, t, 256);
  if (mlp) {
    stage_vec(s.ln2w(), a.ln2w, a.C, CP, t, 256);
    stage_vec(s.ln2b(), a.ln2b, a.C, CP, t, 256);
    stage_vec(s.b2(), a.b2, a.C, CP, t, 256);
    stage_vec(s.b1(), a.b1, a.hidden, a.hidden, t, 256);
  }
}

// The window kernels' barriers after the ring's: the y (Q stream) and x
// (K / V stream) windows' arrivals, and the loader warp's requests: K2's x
// may come back into sA (xreq: both warpgroups' last K | V GEMMs have read
// xn), the next group's y into sQ (yreq: both have read the hidden
// chunks), the output may leave sA (oreq); and the masks' (mready: the
// loader's lanes have written the group's set)
constexpr int WIN_BARRIERS = 6;
__device__ __forceinline__ uint32_t ybar(const WinSmem& s) { return s.bar_s + 16 * MAX_STAGES; }
__device__ __forceinline__ uint32_t xbar(const WinSmem& s) { return ybar(s) + 8; }
__device__ __forceinline__ uint32_t xreq(const WinSmem& s) { return ybar(s) + 16; }
__device__ __forceinline__ uint32_t yreq(const WinSmem& s) { return ybar(s) + 24; }
__device__ __forceinline__ uint32_t oreq(const WinSmem& s) { return ybar(s) + 32; }
__device__ __forceinline__ uint32_t mready(const WinSmem& s) { return ybar(s) + 40; }

// the window kernels' barriers: the ring's, the window arrivals (one
// arrival each, the loader's), the requests (one arrival a consumer
// warpgroup); one thread, before a __syncthreads
__device__ __forceinline__ void init_window_barriers(const WinSmem& s, int stages) {
  init_barriers(s.bar_s, stages, 0);
  mbar_init(ybar(s), 1);
  mbar_init(xbar(s), 1);
  mbar_init(xreq(s), 2);
  mbar_init(yreq(s), 2);
  mbar_init(oreq(s), 2);
  mbar_init(mready(s), 1);
  mbar_fence_init();
}

// the mask bits of query row tid (window tid / NT, token tid % NT)
__device__ __forceinline__ void window_mask_row(const WinArgs& a, const WinSmem& s, int win0,
                                                int tid) {
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
#pragma unroll 1
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
  s.other()[tid] = o;
  if (n == 0) s.padm()[g] = pd;
}

// the -100 terms of the mask, from window coordinates: bit j of
// other[g][n] = key j lies in another shift region than query n, of
// pad[g] = key j is padding after the roll; by the 32 lanes of the loader
// warp, into the set of s (the group's parity)
__device__ __forceinline__ void window_masks(const WinArgs& a, const WinSmem& s, int win0) {
#pragma unroll 1
  for (int tid = threadIdx.x & 31; tid < ROWS; tid += 32)
    window_mask_row(a, s, win0, tid);
}

// per (window, head): S = q k^T + bias + mask, softmax, O = P v on
// mma.sync over 32 x 32 tiles (25 tokens padded), O over Q in sQ. A task
// is one window, one head of the pair h0, h0 + 1 and one 16-row half of
// the padded queries: twenty per head pair over the eight consumer warps,
// warp w taking tasks w, w + 8, w + 16 as three independent chains of
// dependent steps, interleaved (a chain alone leaves the warp waiting on
// each step). A task past the pair's or the image's end computes on
// clamped rows and stores nothing.
__device__ __forceinline__ void attend_pair(const WinArgs& a, const WinSmem& s, int h0, int nh,
                                            int win0) {
  constexpr int T = 3;   // tasks a warp
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q4 = lane & 3;
  // fragment coordinates of mma.m16n8k16 and of ldmatrix row addresses
  const int g4 = lane >> 2;
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const uint32_t kv_s = smem_u32(s.sKV());
  const int ntask = G * nh * 2;
  int mt[T], g[T], hs[T];
  bool live[T];
#pragma unroll
  for (int k = 0; k < T; ++k) {
    const int task = min(warp + 8 * k, ntask - 1);
    mt[k] = task / (G * nh);
    g[k] = task % G;
    hs[k] = task / G % nh;
    live[k] = warp + 8 * k < ntask && win0 + g[k] < a.total_win;
  }
  float sc[T][4][4];
#pragma unroll
  for (int k = 0; k < T; ++k) {
    const int rb = g[k] * NT;
    uint32_t qa[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      ldmatrix_x4(qa[ks], s.sQ_s() + swz(min(rb + mt[k] * 16 + a_row, M - 1),
                                         (h0 + hs[k]) * HD + ks * 16 + a_col));
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      uint32_t kb[4];
      ldmatrix_x4(kb, kv_s + (uint32_t)((min(rb + nt * 8 + (lane & 7), M - 1) * LDKV
                                         + hs[k] * 64 + (lane >> 3) * 8) * 2));
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[k][nt][e] = 0.0f;
      mma_bf16(sc[k][nt], qa[0], kb[0], kb[1]);
      mma_bf16(sc[k][nt], qa[1], kb[2], kb[3]);
    }
  }
  uint32_t pa[T][2][4];
#pragma unroll
  for (int k = 0; k < T; ++k) {
    const uint32_t pd = s.padm()[g[k]];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int n = min(mt[k] * 16 + g4 + 8 * hh, NT - 1);
      const uint32_t ot = s.other()[g[k] * NT + n];
      const float* bias = s.sbias() + (hs[k] * NT + n) * NT;
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = nt * 8 + 2 * q4 + e;
          float v = -INFINITY;
          if (j < NT)
            v = sc[k][nt][2 * hh + e] + bias[j] + ((ot >> j) & 1u ? -100.0f : 0.0f)
                + ((pd >> j) & 1u ? -100.0f : 0.0f);
          sc[k][nt][2 * hh + e] = v;
          mx = fmaxf(mx, v);
        }
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      float sum = 0.0f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float ex = expf(sc[k][nt][2 * hh + e] - mx);
          sc[k][nt][2 * hh + e] = ex;
          sum += ex;
        }
      sum += __shfl_xor_sync(FULL, sum, 1);
      sum += __shfl_xor_sync(FULL, sum, 2);
      const float inv = 1.0f / sum;
      // bf16 probabilities as the A fragments of P v (keys 16 kt ..)
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
        pa[k][kt][hh] = pack_bf16x2(sc[k][2 * kt][2 * hh] * inv, sc[k][2 * kt][2 * hh + 1] * inv);
        pa[k][kt][2 + hh] = pack_bf16x2(sc[k][2 * kt + 1][2 * hh] * inv,
                                        sc[k][2 * kt + 1][2 * hh + 1] * inv);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < T; ++k) {
    const int rb = g[k] * NT;
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
                                                 + hs[k] * 64 + HD + np * 16 + a_col) * 2));
        mma_bf16(o[2 * np], pa[k][kt], vb[0], vb[1]);
        mma_bf16(o[2 * np + 1], pa[k][kt], vb[2], vb[3]);
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int n = mt[k] * 16 + g4 + 8 * hh;
      if (live[k] && n < NT) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          *reinterpret_cast<uint32_t*>(s.sQ() + swz(rb + n, (h0 + hs[k]) * HD + nt * 8 + 2 * q4)) =
              pack_bf16x2(o[nt][2 * hh], o[nt][2 * hh + 1]);
      }
    }
  }
}

// The consumers' attention half of a window kernel, through the
// projection GEMM: res = O Wp^T, without bp. The loader warp brings y's
// windows into sQ (phase parity ypar of ybar), the masks (the same parity
// of mready) and x's into sA (parity 0 of xbar), and, with reload_x, x's
// again once both
// warpgroups' last K | V GEMMs have read xn, while the last heads'
// attention runs (xreq; parity 1 of xbar: K2's residual). The parameters
// are staged (stage_params).
template <int CP>
__device__ __forceinline__ void window_attention(const WinArgs& a, const WinSmem& s, Ring& ring,
                                                 int win0, uint32_t ypar, bool reload_x,
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

  // ---- Q = (LN1(y) Wq^T + bq) * scale -> sQ, over yn
  mbar_wait(ybar(s), ypar);
  ln_rows<false>(s.sQ(), wg * 64 + (warp & 3) * 16, nvalid, lane, CP, C, s.ln1w(), s.ln1b(),
                 s.lnstat(warp));
  fence_proxy_async();
  bar_sync(wg_bar, 128);
  {
    float acc[NH][NP / 2];
    gemm<NP, NH, NKB>(acc, s.sQ_s(), ring, true);
    bar_sync(1, 256);   // both warpgroups' Q GEMMs have read yn
    pairs_via_scratch<NP, NH, false>(
        acc, scratch(s),
        [&](int p, int j, int) { return lds2(s.bq() + p * NP + 8 * j + 2 * q4); },
        [&](int p, int j, int h, float2 v, float2 bq) {
          const int col = p * NP + 8 * j + 2 * q4;
          *reinterpret_cast<uint32_t*>(s.sQ() + swz(r0 + 8 * h, col)) =
              col < C ? pack_bf16x2((v.x + bq.x) * a.scale, (v.y + bq.y) * a.scale) : 0u;
          return v;
        });
  }
  // ---- LN1(x) -> sA
  mbar_wait(xbar(s), 0);
  ln_rows<false>(s.sA(), wg * 64 + (warp & 3) * 16, nvalid, lane, CP, C, s.ln1w(), s.ln1b(),
                 s.lnstat(warp));
  fence_proxy_async();
  bar_sync(wg_bar, 128);
  mbar_wait(mready(s), ypar);

  for (int h0 = 0; h0 < a.heads; h0 += 2) {
    const int nh = min(2, a.heads - h0);
    // ---- K | V of heads h0, h0 + 1 = xn Wkv^T + bkv (one m64n128 GEMM)
    float acc[1][64];
    gemm<128, 1, NKB>(acc, s.sA_s(), ring, true);
    // the previous pair's attention (the Q epilogue's scratch) has read sKV
    bar_sync(1, 256);
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
        *reinterpret_cast<uint32_t*>(s.sKV() + (r0 + 8 * hh) * LDKV + col) =
            pack_bf16x2(acc[0][4 * j + 2 * hh] + bk.x, acc[0][4 * j + 2 * hh + 1] + bk.y);
    }
    // the two heads' relative-position bias, [2][NT][NT] f32
    for (int i = tid; i < nh * NT * NT; i += 256) s.sbias()[i] = __ldg(a.relbias + h0 * NT * NT + i);
    bar_sync(1, 256);   // K | V of all rows (windows straddle the two halves)
    // after the last K | V GEMM nothing reads xn
    if (reload_x && h0 + 2 >= a.heads && (tid & 127) == 0) mbar_arrive(xreq(s));
    attend_pair(a, s, h0, nh, win0);
  }
  // O rows were written by the warps of both warpgroups
  fence_proxy_async();
  bar_sync(1, 256);
  gemm<NP, NH, NKB>(res, s.sQ_s(), ring, true);
}

// res + bias (staged) rounded to bf16 into sA's rows, for the loader warp
// to store (oreq). The caller's GEMMs have read this warpgroup's rows of
// sA; the other warpgroup's rows are its own. The rows are written
// swizzled (conflict-free) and each warp then moves its own 16 rows into
// the raw layout the image boxes take.
template <int CP>
__device__ __forceinline__ void store_windows(const WinArgs& a, const WinSmem& s,
                                              float (*res)[Tile<CP>::NP / 2],
                                              const float* bias) {
  constexpr int NP = Tile<CP>::NP, NH = Tile<CP>::NH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int q4 = lane & 3;
  const int row0 = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16;
  const int r0 = row0 + (lane >> 2);
  pairs_via_scratch<NP, NH, false>(
      res, scratch(s),
      [&](int p, int j, int) { return lds2(bias + p * NP + 8 * j + 2 * q4); },
      [&](int p, int j, int h, float2 v, float2 bo) {
        const int col = p * NP + 8 * j + 2 * q4;
        *reinterpret_cast<uint32_t*>(s.sA() + swz(r0 + 8 * h, col)) =
            pack_bf16x2(v.x + bo.x, v.y + bo.y);
        return v;
      });
  __syncwarp();
  reswizzle_rows<false>(s.sA(), row0, lane, CP);
  fence_proxy_async();
  bar_sync(2 + (tid >> 7), 128);
  if ((tid & 127) == 0) mbar_arrive(oreq(s));
}

// ---- the loader warp (K2, K8): image copies, issued by its lane 0

// this group's output rows in sA to the image `omap` by TMA, once both
// warpgroups have asked (parity opar of oreq); returns once the copies
// have read sA
template <int CP>
__device__ __forceinline__ void store_group(const WinArgs& a, const WinSmem& s,
                                            const CUtensorMap* omap, int win0, uint32_t opar) {
  mbar_wait(oreq(s), opar);
  const int nv = min(G, a.total_win - win0);
  const int nww = a.Wp / WS;
  const int per_img = (a.Hp / WS) * nww;
#pragma unroll 1
  for (int g = 0; g < nv; ++g) {
    const int win = win0 + g;
    const int b = win / per_img;
    const int rem = win - b * per_img;
#pragma unroll 1
    for (int blk = 0; blk < CP / 64; ++blk)
      tma_store_4d(omap, s.sA_s() + blk * BLK + g * NT * 128, blk * 64, (rem % nww) * WS,
                   (rem / nww) * WS, b);
  }
  bulk_commit();
  bulk_wait_read();
}

// a group's masks by the loader warp's lanes, then mready by lane 0
__device__ __forceinline__ void masks_ready(const WinArgs& a, const WinSmem& s, int win0) {
  window_masks(a, s, win0);
  __syncwarp();
  if ((threadIdx.x & 31) == 0) {
    __threadfence_block();
    mbar_arrive(mready(s));
  }
}

// ---- the MLP (K2, K9)

// res (+)= gelu(A W1^T + b1) W2^T over the hidden / HC chunks of the
// hidden layer, A the LN'd rows in the swizzled tile at a_s. Per chunk c:
// fc1 on wgmma, its 32 values a thread parked in the scratch scr, then the
// bias + erf-GELU of chunk c on the warps while the tensor cores run fc2 of
// chunk c - 1 (its accumulators are the residual's registers: nothing more
// is live beside the GELU than without the overlap). The GELU'd chunk,
// rounded to bf16, goes to one of two [M][HC] swizzled tiles at hid0 (in
// turn), which fc2 reads in the next pass. fresh: the first fc2 product
// overwrites res (K9) instead of adding to it (K2). b1 staged. after_fc1()
// runs once every warp of the warpgroup is past the last fc1 GEMM, which
// read A. The fc2 products of res are complete on return.
template <int CP, class AfterFc1>
__device__ __forceinline__ void mlp_chunks(float (*res)[Tile<CP>::NP / 2], uint32_t a_s,
                                           unsigned char* hid0, float2* scr, Ring& ring,
                                           const float* b1, int hidden, bool fresh,
                                           AfterFc1 after_fc1) {
  constexpr int NP = Tile<CP>::NP, NH = Tile<CP>::NH, NKB = Tile<CP>::NKB;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int q4 = lane & 3;
  const int r0 = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int wg_bar = 2 + (tid >> 7);
  const int n_chunks = hidden / HC;
  float2* mine = scr + (tid & 255);   // thread-major: conflict-free
#pragma unroll 1
  for (int c = 0; c < n_chunks; ++c) {
    unsigned char* hid = hid0 + (c & 1) * BLK;   // [M][HC] swizzled, bf16
    {
      float acc[1][HC / 2];
      gemm<HC, 1, NKB, Tile<CP>::KPS1>(acc, a_s, ring, true);
#pragma unroll
      for (int i = 0; i < HC / 4; ++i) mine[i * 256] = make_float2(acc[0][2 * i], acc[0][2 * i + 1]);
    }
    // fc2 of chunk c - 1 (none for c = 0) beside this chunk's GELU, which
    // runs once both of its slabs are in flight. Pair i of the chunk:
    // accumulator registers 2 i, 2 i + 1 (row r0 + 8 (i % 2), columns
    // 8 (i / 2) + 2 (lane % 4) + {0, 1}); four pairs' loads before their
    // stores (pairs_via_scratch)
    gemm<NP, NH, 1>(
        res, smem_u32(hid0 + ((c + 1) & 1) * BLK), ring, fresh && c == 1,
        [&](int k) {
          if (k != NH - 1) return;
#pragma unroll 1
          for (int i0 = 0; i0 < HC / 4; i0 += 4) {
            float2 v[4], bh[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              v[q] = mine[(i0 + q) * 256];
              bh[q] = lds2(b1 + c * HC + 8 * ((i0 + q) >> 1) + 2 * q4);
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int i = i0 + q;
              const float t0 = v[q].x + bh[q].x;
              const float t1 = v[q].y + bh[q].y;
              *reinterpret_cast<uint32_t*>(hid + swz(r0 + 8 * (i & 1), 8 * (i >> 1) + 2 * q4)) =
                  pack_bf16x2(0.5f * t0 * (1.0f + erff(t0 * 0.70710678118654752f)),
                              0.5f * t1 * (1.0f + erff(t1 * 0.70710678118654752f)));
            }
          }
        },
        c > 0);
    finish<NP, NH>(res, ring);
    fence_proxy_async();
    bar_sync(wg_bar, 128);
    if (c + 1 == n_chunks) after_fc1();
  }
  gemm<NP, NH, 1>(res, smem_u32(hid0 + ((n_chunks - 1) & 1) * BLK), ring, fresh && n_chunks == 1);
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

// the ring and barriers of a window kernel's plan (WinSmem) after its
// parameters (with mlp, the MLP's too): the dynamic shared memory to ask
// for, or 0 if fewer than two ring stages fit
inline int window_layout(WinArgs& a, bool mlp) {
  const int prm_bytes = 4 * (mlp ? 7 * PV + a.hidden : 4 * PV);
  a.off_ring = (OFF_PRM + prm_bytes + 1023) & ~1023;
  const int bars = 16 * MAX_STAGES + 8 * WIN_BARRIERS;
  const int fixed = a.off_ring + bars + 1024;
  a.stages = (227 * 1024 - fixed) / SLAB;
  if (a.stages > MAX_STAGES) a.stages = MAX_STAGES;
  if (a.stages < 2) return 0;
  a.off_bar = a.off_ring + a.stages * SLAB;
  return a.off_bar + bars + 1024;
}

}  // namespace swin
