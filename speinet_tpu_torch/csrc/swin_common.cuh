// Device code shared by the Swin kernels: K2 (swin_block.cu, the whole
// block), K8 (swin_attn.cu, LN1 + window cross-attention + proj) and K9
// (swin_mlp.cu, x + MLP(LN2(x))).
//
// A CTA of the window kernels (K2, K8) takes G = 5 consecutive 5x5 windows,
// 125 token rows padded to M = 128, of one stream image. Every projection
// is a [128 x K] x [K x N] WMMA product (bf16, f32 accumulate) whose A
// operand sits in shared memory and whose weights stream from L2 as
// column-major B fragments. Scores and softmax run per query token on CUDA
// cores (two threads per token split the 32-wide head), since a 25 x 25 x 32
// window product is too small for tensor-core tiles. The shift / pad mask
// (-100 per violated rule) is computed from the window's coordinates:
// image-region labels of shift_attn_mask (speinet_tpu/models/swinir.py:
// 61-77) and the rolled pad rule (:356-365).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

namespace swin {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int WS = 5;            // window size (the template's)
constexpr int N = WS * WS;       // tokens per window
constexpr int G = 5;             // windows per CTA
constexpr int ROWS = G * N;      // 125 live token rows
constexpr int M = 128;           // token rows incl. padding
constexpr int HD = 32;           // head dim
constexpr int HCH = 64;          // MLP hidden columns per chunk
constexpr int LDH = HCH + 8;     // padded row stride of the hidden chunk
constexpr int THREADS = 256;     // two per token row in the attention
constexpr int WARPS = THREADS / 32;
constexpr int RB = 8;            // token rows a warp keeps in flight in the row passes
constexpr unsigned FULL = 0xffffffffu;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

// arguments of the window kernels (K2 uses all, K8 all but LN2 / MLP)
struct Args {
  const bf16* x;
  const bf16* y;
  bf16* out;
  const float* ln1w;
  const float* ln1b;
  const bf16* wkv;    // [2C, C] (torch Linear layout: out x in)
  const float* bkv;
  const bf16* wq;     // [C, C]
  const float* bq;
  const bf16* wp;     // [C, C]
  const float* bp;
  const float* relbias;  // [heads, N, N]
  const float* ln2w;
  const float* ln2b;
  const bf16* w1;     // [hidden, C]
  const float* b1;
  const bf16* w2;     // [C, hidden]
  const float* b2;
  int B, Hp, Wp, C, hidden, heads, shift, h_valid, w_valid;
  float scale;
  int ldb, ldf;       // padded row strides (elements) of bf16 / f32 buffers
  int off_b, off_c, off_s;   // shared-memory region offsets (bytes)
};

inline int align128(int n) { return (n + 127) & ~127; }

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

// LayerNorm of one row held as 8 values per lane (lanes with lane*8 >= C
// hold nothing); one-pass clamped variance as in the JAX block.
__device__ __forceinline__ void ln8(float* v, bool act, int C, const float* w,
                                    const float* b, int lane) {
  float s = 0.0f, ss = 0.0f;
  if (act) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s += v[i];
      ss += v[i] * v[i];
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mu = s / C;
  const float var = fmaxf(ss / C - mu * mu, 0.0f);
  const float r = rsqrtf(var + 1e-5f);
  if (act) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = lane * 8 + i;
      v[i] = (v[i] - mu) * r * w[e] + b[e];
    }
  }
}

// acc[r] += A[row0 + 16r .., 0:K] x B, B column-major (a torch Linear weight
// [N_out, K] read from row n0), one B fragment per k-step shared by R rows
template <int R>
__device__ __forceinline__ void mma_rows(Acc* acc, const bf16* A, int lda,
                                         int row0, const bf16* Bcol, int ldb,
                                         int K) {
  for (int k0 = 0; k0 < K; k0 += 16) {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bf;
    wmma::load_matrix_sync(bf, Bcol + k0, ldb);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::load_matrix_sync(af, A + (size_t)(row0 + 16 * r) * lda + k0, lda);
      wmma::mma_sync(acc[r], af, bf, acc[r]);
    }
  }
}

// one 16x16 f32 tile -> (+bias[col]) then *mul or GELU -> bf16 at dst
template <bool GELU>
__device__ __forceinline__ void store_bf16(const Acc& f, float* st, bf16* dst,
                                           int ldd, const float* bias,
                                           float mul, int lane) {
  wmma::store_matrix_sync(st, f, 16, wmma::mem_row_major);
  __syncwarp();
  const int r = lane >> 1;
  const int c0 = (lane & 1) * 8;
  float v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float t = st[r * 16 + c0 + i] + bias[c0 + i];
    v[i] = GELU ? 0.5f * t * (1.0f + erff(t * 0.70710678118654752f)) : t * mul;
  }
  *reinterpret_cast<uint4*>(dst + (size_t)r * ldd + c0) = pack8(v);
  __syncwarp();
}

__device__ __forceinline__ int region(int i, int L, int shift) {
  return i < L - WS ? 0 : (i < L - shift ? 1 : 2);
}

// element offset of token row m's pixel in the [B, Hp, Wp, C] image, -1 for
// padding rows and rows past the last window
__device__ __forceinline__ long long pix_offset(const Args& a, int m, int win0,
                                                int total_win) {
  if (m >= ROWS) return -1;
  const int win = win0 + m / N;
  if (win >= total_win) return -1;
  const int n = m % N;
  const int nww = a.Wp / WS;
  const int per_img = (a.Hp / WS) * nww;
  const int b = win / per_img;
  const int rem = win - b * per_img;
  const int i = (rem / nww) * WS + n / WS;
  const int j = (rem % nww) * WS + n % WS;
  return (((long long)b * a.Hp + i) * a.Wp + j) * a.C;
}

// this CTA's token rows of the image `src`: RB 16-byte loads per lane issued
// before any is used (one warp per row otherwise waits out each row's
// device-memory latency in turn); zeros for padding rows
__device__ __forceinline__ void load_rows(const Args& a, const bf16* src,
                                          int m0, int win0, int total_win,
                                          int lane, bool act, uint4* raw,
                                          bool* ok) {
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const long long off = pix_offset(a, m0 + i * WARPS, win0, total_win);
    ok[i] = off >= 0;
    raw[i] = make_uint4(0, 0, 0, 0);
    if (ok[i] && act) raw[i] = *reinterpret_cast<const uint4*>(src + off + lane * 8);
  }
}

// LN1 of this CTA's token rows of `src` -> dst (bf16, row stride a.ldb)
__device__ __forceinline__ void ln1_rows(const Args& a, const bf16* src,
                                         bf16* dst, int win0, int total_win,
                                         int warp, int lane, bool act) {
  for (int m0 = warp; m0 < M; m0 += WARPS * RB) {
    uint4 raw[RB];
    bool ok[RB];
    load_rows(a, src, m0, win0, total_win, lane, act, raw, ok);
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      float v[8];
      unpack8(raw[i], v);
      if (ok[i]) ln8(v, act, a.C, a.ln1w, a.ln1b, lane);
      if (act)
        *reinterpret_cast<uint4*>(dst + (size_t)(m0 + i * WARPS) * a.ldb
                                  + lane * 8) = pack8(v);
    }
  }
}

// The attention half of a block for this CTA's windows, up to (not
// including) the output projection:
//     xn, yn = LN1(x), LN1(y)                           (f32 math, eps 1e-5)
//     q = (yn Wq + bq) * hd^-1/2,  k|v = xn Wkv + bkv    (bf16 operands, f32 sums)
//     per head: O = softmax(q k^T + relpos_bias + mask) v   (f32 softmax,
//                                                           bf16 probabilities)
// O (bf16, all heads) is left in bufB; bufA ends holding xn; rc holds the
// last head's K | V. Ends with a barrier.
__device__ __forceinline__ void attention(const Args& a, bf16* bufA, bf16* bufB,
                                          bf16* rc, float* st, int win0,
                                          int total_win) {
  const int C = a.C;
  const int ldb = a.ldb;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const bool act = lane * 8 < C;

  // ---- LN1(y) -> bufA
  ln1_rows(a, a.y, bufA, win0, total_win, warp, lane, act);
  __syncthreads();

  // ---- Q = (yn Wq^T + bq) * scale -> bufB, all heads at once
  for (int ni = warp; ni < C / 16; ni += WARPS) {
    Acc acc[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) wmma::fill_fragment(acc[r], 0.0f);
    mma_rows<8>(acc, bufA, ldb, 0, a.wq + (size_t)ni * 16 * C, C, C);
#pragma unroll
    for (int r = 0; r < 8; ++r)
      store_bf16<false>(acc[r], st, bufB + (size_t)r * 16 * ldb + ni * 16, ldb,
                        a.bq + ni * 16, a.scale, lane);
  }
  __syncthreads();

  // ---- LN1(x) -> bufA (yn is dead)
  ln1_rows(a, a.x, bufA, win0, total_win, warp, lane, act);
  __syncthreads();

  // attention thread mapping: token row m, half of the head's 32 channels
  const int m = tid >> 1;
  const int half = tid & 1;
  const bool row_valid = pix_offset(a, m, win0, total_win) >= 0;
  const int g = row_valid ? m / N : 0;
  const int n = row_valid ? m % N : 0;
  const int win = row_valid ? win0 + g : 0;
  const int nww = a.Wp / WS;
  const int rem = win % ((a.Hp / WS) * nww);
  const int wr = rem / nww;
  const int wc = rem % nww;
  const int qlab = 3 * region(wr * WS + n / WS, a.Hp, a.shift)
                   + region(wc * WS + n % WS, a.Wp, a.shift);
  // the -100 terms of every key of this token's window, the same for all
  // heads: bit j of `other` = key j in another shift region, of `pad` = key
  // j is padding after the roll
  unsigned other = 0, pad = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int ki = wr * WS + j / WS;
    const int kj = wc * WS + j % WS;
    if (a.shift > 0 &&
        3 * region(ki, a.Hp, a.shift) + region(kj, a.Wp, a.shift) != qlab)
      other |= 1u << j;
    if ((ki + a.shift) % a.Hp >= a.h_valid || (kj + a.shift) % a.Wp >= a.w_valid)
      pad |= 1u << j;
  }

  for (int h = 0; h < a.heads; ++h) {
    // ---- K_h, V_h = xn Wkv^T + bkv: 4 column strips x 2 row halves
    {
      const int s = warp & 3;
      const int rr = warp >> 2;
      const int feat = (s >= 2 ? C : 0) + h * HD + (s & 1) * 16;
      Acc acc[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) wmma::fill_fragment(acc[r], 0.0f);
      mma_rows<4>(acc, bufA, ldb, rr * 64, a.wkv + (size_t)feat * C, C, C);
      bf16* dst = rc + (s >= 2 ? M * HD : 0) + (s & 1) * 16;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        store_bf16<false>(acc[r], st, dst + (size_t)(rr * 64 + r * 16) * HD, HD,
                          a.bkv + feat, 1.0f, lane);
    }
    __syncthreads();

    // ---- scores, softmax and P V for token row m (Q read, O written in place)
    {
      bf16* qrow = bufB + (size_t)m * ldb + h * HD + half * 16;
      float q[16];
      unpack8(reinterpret_cast<const uint4*>(qrow)[0], q);
      unpack8(reinterpret_cast<const uint4*>(qrow)[1], q + 8);
      const bf16* kbase = rc + (size_t)g * N * HD + half * 16;
      const bf16* vbase = rc + (size_t)M * HD + (size_t)g * N * HD + half * 16;
      const float* bias = a.relbias + ((size_t)h * N + n) * N;
      float s[N];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float kv[16];
        unpack8(reinterpret_cast<const uint4*>(kbase + j * HD)[0], kv);
        unpack8(reinterpret_cast<const uint4*>(kbase + j * HD)[1], kv + 8);
        float part = 0.0f;
#pragma unroll
        for (int d = 0; d < 16; ++d) part += q[d] * kv[d];
        part += __shfl_xor_sync(FULL, part, 1);
        const float mval = ((other >> j) & 1u ? -100.0f : 0.0f)
                           + ((pad >> j) & 1u ? -100.0f : 0.0f);
        s[j] = part + bias[j] + mval;
        mx = fmaxf(mx, s[j]);
      }
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        s[j] = expf(s[j] - mx);
        sum += s[j];
      }
      float o[16];
#pragma unroll
      for (int d = 0; d < 16; ++d) o[d] = 0.0f;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float p = __bfloat162float(__float2bfloat16(s[j] / sum));
        float vv[16];
        unpack8(reinterpret_cast<const uint4*>(vbase + j * HD)[0], vv);
        unpack8(reinterpret_cast<const uint4*>(vbase + j * HD)[1], vv + 8);
#pragma unroll
        for (int d = 0; d < 16; ++d) o[d] += p * vv[d];
      }
      if (row_valid) {
        reinterpret_cast<uint4*>(qrow)[0] = pack8(o);
        reinterpret_cast<uint4*>(qrow)[1] = pack8(o + 8);
      }
    }
    __syncthreads();
  }
}

// The MLP on M rows, 64 hidden columns at a time:
//     x2 += gelu(xn2 W1^T + b1) W2^T        (hidden rounded to bf16)
// xn2: the LN2'd rows (bf16, stride ldb); x2: f32 accumulators (stride
// ldf); hid: a [M][LDH] bf16 scratch. Ends with a barrier.
__device__ __forceinline__ void mlp(const bf16* xn2, int ldb, float* x2, int ldf,
                                    bf16* hid, float* st, const bf16* w1,
                                    const float* b1, const bf16* w2, int C,
                                    int hidden) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int j0 = 0; j0 < hidden; j0 += HCH) {
    {
      const int s = warp & 3;
      const int rr = warp >> 2;
      Acc acc[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) wmma::fill_fragment(acc[r], 0.0f);
      mma_rows<4>(acc, xn2, ldb, rr * 64, w1 + (size_t)(j0 + s * 16) * C, C, C);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        store_bf16<true>(acc[r], st, hid + (size_t)(rr * 64 + r * 16) * LDH + s * 16,
                         LDH, b1 + j0 + s * 16, 1.0f, lane);
    }
    __syncthreads();
    for (int ni = warp; ni < C / 16; ni += WARPS) {
      Acc acc[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        wmma::load_matrix_sync(acc[r], x2 + (size_t)r * 16 * ldf + ni * 16, ldf,
                               wmma::mem_row_major);
      mma_rows<8>(acc, hid, LDH, 0, w2 + (size_t)ni * 16 * hidden + j0, hidden, HCH);
#pragma unroll
      for (int r = 0; r < 8; ++r)
        wmma::store_matrix_sync(x2 + (size_t)r * 16 * ldf + ni * 16, acc[r], ldf,
                                wmma::mem_row_major);
    }
    __syncthreads();
  }
}

}  // namespace swin
