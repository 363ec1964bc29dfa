// K2: one whole cross-attention Swin block per group of five 5x5 windows.
//
// Replaces speinet_tpu/ops/pallas_swin.py::fused_swin_block (pallas_call at
// :420, bodies _block_kernel :246 and _attn_compact :159). For every window
// of the rolled / padded images x (the K/V stream) and y (the Q stream):
//     xn, yn = LN1(x), LN1(y)                           (f32 math, eps 1e-5)
//     q = (yn Wq + bq) * hd^-1/2,  k|v = xn Wkv + bkv    (bf16 operands, f32 sums)
//     per head: P = softmax(q k^T + relpos_bias + mask)  (f32 softmax)
//     x2 = x + (P v) Wp + bp                             (residual in f32)
//     out = x2 + fc2(gelu_erf(fc1(LN2(x2))))             (rounded to bf16 once)
// The shift / pad mask (-100 per violated rule) is computed in the kernel
// from the window's coordinates: image-region labels of shift_attn_mask
// (speinet_tpu/models/swinir.py:61-77) and the rolled pad rule (:356-365).
//
// Bound on the H100: operations (~62 GFLOP per [180, 320, 256] stream image
// against ~88 MB, 0.063 ms vs 0.026 ms). Design: a CTA takes 5 consecutive
// windows = 125 token rows (padded to 128) of one stream and keeps the
// whole block's intermediate state in shared memory (~222 KB: the LN'd
// rows, Q -> attention output in place, K/V of one head, the f32 residual
// stream, one 64-wide slice of the MLP hidden layer), so only x, y and the
// output cross device memory. Every projection is a [128 x K] x [K x N]
// WMMA product (bf16, f32 accumulate) whose A operand sits in shared memory
// and whose weights stream from L2 as column-major B fragments, each warp
// owning whole columns so a weight fragment is fetched once per CTA where
// the work split allows. Scores and softmax are per query token on CUDA
// cores (two threads per token split the 32-wide head), since a 25 x 25 x 32
// window product is too small for tensor-core tiles. The TPU's column-group
// and head-quad packing are MXU layout devices and are not carried over.
// Weight-fragment reuse across CTAs (clusters / TMA multicast), wgmma and
// an on-tensor-core attention are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

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
constexpr unsigned FULL = 0xffffffffu;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

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

constexpr int RB = 8;   // token rows a warp keeps in flight in the row passes

// this CTA's token rows of the image `src`: RB 16-byte loads per lane issued
// before any is used (one warp per row otherwise waits out each row's
// device-memory latency in turn); zeros for padding rows
__device__ __forceinline__ void load_rows(const Args& a, const bf16* src,
                                          int m0, int win0, int total_win,
                                          int lane, bool act, uint4* raw,
                                          bool* ok) {
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const long long off = pix_offset(a, m0 + i * (THREADS / 32), win0, total_win);
    ok[i] = off >= 0;
    raw[i] = make_uint4(0, 0, 0, 0);
    if (ok[i] && act) raw[i] = *reinterpret_cast<const uint4*>(src + off + lane * 8);
  }
}

// LN1 of this CTA's token rows of `src` -> dst (bf16, row stride a.ldb)
__device__ __forceinline__ void ln1_rows(const Args& a, const bf16* src,
                                         bf16* dst, int win0, int total_win,
                                         int warp, int lane, bool act) {
  for (int m0 = warp; m0 < M; m0 += (THREADS / 32) * RB) {
    uint4 raw[RB];
    bool ok[RB];
    load_rows(a, src, m0, win0, total_win, lane, act, raw, ok);
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      float v[8];
      unpack8(raw[i], v);
      if (ok[i]) ln8(v, act, a.C, a.ln1w, a.ln1b, lane);
      if (act)
        *reinterpret_cast<uint4*>(dst + (size_t)(m0 + i * (THREADS / 32)) * a.ldb
                                  + lane * 8) = pack8(v);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1) swin_block_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* bufA = reinterpret_cast<bf16*>(smem);              // yn, then xn
  float* x2 = reinterpret_cast<float*>(smem);               // residual stream
  bf16* bufB = reinterpret_cast<bf16*>(smem + a.off_b);     // Q -> O, then LN2(x2)
  bf16* rc = reinterpret_cast<bf16*>(smem + a.off_c);       // K_h | V_h, then hidden chunk
  float* stage = reinterpret_cast<float*>(smem + a.off_s);  // [WARPS][16x16]

  const int C = a.C;
  const int ldb = a.ldb;
  const int ldf = a.ldf;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int win0 = blockIdx.x * G;
  const int total_win = a.B * (a.Hp / WS) * (a.Wp / WS);
  const bool act = lane * 8 < C;
  float* st = stage + warp * 256;

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

  // ---- x2 = O Wp^T (f32, into bufA's space: xn is dead)
  for (int ni = warp; ni < C / 16; ni += WARPS) {
    Acc acc[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) wmma::fill_fragment(acc[r], 0.0f);
    mma_rows<8>(acc, bufB, ldb, 0, a.wp + (size_t)ni * 16 * C, C, C);
#pragma unroll
    for (int r = 0; r < 8; ++r)
      wmma::store_matrix_sync(x2 + (size_t)r * 16 * ldf + ni * 16, acc[r], ldf,
                              wmma::mem_row_major);
  }
  __syncthreads();

  // ---- x2 = x + (O Wp^T + bp); LN2(x2) -> bufB
  for (int m0 = warp; m0 < M; m0 += WARPS * RB) {
    uint4 raw[RB];
    bool ok[RB];
    load_rows(a, a.x, m0, win0, total_win, lane, act, raw, ok);
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const int mm = m0 + i * WARPS;
      float v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      float* xr = x2 + (size_t)mm * ldf + lane * 8;
      if (ok[i] && act) {
        float xin[8];
        unpack8(raw[i], xin);
        const float4 p0 = reinterpret_cast<const float4*>(xr)[0];
        const float4 p1 = reinterpret_cast<const float4*>(xr)[1];
        const float pr[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = xin[e] + (pr[e] + a.bp[lane * 8 + e]);
      }
      if (act) {
        reinterpret_cast<float4*>(xr)[0] = make_float4(v[0], v[1], v[2], v[3]);
        reinterpret_cast<float4*>(xr)[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
      if (ok[i]) ln8(v, act, C, a.ln2w, a.ln2b, lane);
      if (act) *reinterpret_cast<uint4*>(bufB + (size_t)mm * ldb + lane * 8) = pack8(v);
    }
  }
  __syncthreads();

  // ---- MLP, 64 hidden columns at a time: x2 += gelu(LN2 W1^T + b1) W2^T
  for (int j0 = 0; j0 < a.hidden; j0 += HCH) {
    {
      const int s = warp & 3;
      const int rr = warp >> 2;
      Acc acc[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) wmma::fill_fragment(acc[r], 0.0f);
      mma_rows<4>(acc, bufB, ldb, rr * 64, a.w1 + (size_t)(j0 + s * 16) * C, C, C);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        store_bf16<true>(acc[r], st, rc + (size_t)(rr * 64 + r * 16) * LDH + s * 16,
                         LDH, a.b1 + j0 + s * 16, 1.0f, lane);
    }
    __syncthreads();
    for (int ni = warp; ni < C / 16; ni += WARPS) {
      Acc acc[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        wmma::load_matrix_sync(acc[r], x2 + (size_t)r * 16 * ldf + ni * 16, ldf,
                               wmma::mem_row_major);
      mma_rows<8>(acc, rc, LDH, 0, a.w2 + (size_t)ni * 16 * a.hidden + j0,
                  a.hidden, HCH);
#pragma unroll
      for (int r = 0; r < 8; ++r)
        wmma::store_matrix_sync(x2 + (size_t)r * 16 * ldf + ni * 16, acc[r], ldf,
                                wmma::mem_row_major);
    }
    __syncthreads();
  }

  // ---- out = x2 + b2 (bf16)
  for (int mm = warp; mm < M; mm += WARPS) {
    const long long off = pix_offset(a, mm, win0, total_win);
    if (off >= 0 && act) {
      const float* xr = x2 + (size_t)mm * ldf + lane * 8;
      const float4 p0 = reinterpret_cast<const float4*>(xr)[0];
      const float4 p1 = reinterpret_cast<const float4*>(xr)[1];
      const float pr[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = pr[i] + a.b2[lane * 8 + i];
      *reinterpret_cast<uint4*>(a.out + off + lane * 8) = pack8(v);
    }
  }
}

inline int align128(int n) { return (n + 127) & ~127; }

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
  if (ws != WS || Hp % WS != 0 || Wp % WS != 0 || C % 16 != 0 || C > 256 ||
      heads * HD != C || hidden % HCH != 0 || shift < 0 || shift >= WS ||
      h_valid < 1 || h_valid > Hp || w_valid < 1 || w_valid > Wp)
    return cudaErrorInvalidValue;
  const long long total_win = (long long)B * (Hp / WS) * (Wp / WS);
  const long long blocks = (total_win + G - 1) / G;
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const bf16*>(x);
  a.y = static_cast<const bf16*>(y);
  a.out = static_cast<bf16*>(out);
  a.ln1w = static_cast<const float*>(ln1w);
  a.ln1b = static_cast<const float*>(ln1b);
  a.wkv = static_cast<const bf16*>(wkv);
  a.bkv = static_cast<const float*>(bkv);
  a.wq = static_cast<const bf16*>(wq);
  a.bq = static_cast<const float*>(bq);
  a.wp = static_cast<const bf16*>(wp);
  a.bp = static_cast<const float*>(bp);
  a.relbias = static_cast<const float*>(relbias);
  a.ln2w = static_cast<const float*>(ln2w);
  a.ln2b = static_cast<const float*>(ln2b);
  a.w1 = static_cast<const bf16*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = static_cast<const bf16*>(w2);
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
  a.scale = scale;
  a.ldb = C + 8;   // +16 bytes per row: conflict-free fragment loads
  a.ldf = C + 4;
  const int bytes_a_bf = M * a.ldb * 2;
  const int bytes_a_f = M * a.ldf * 4;
  const int bytes_a = align128(bytes_a_bf > bytes_a_f ? bytes_a_bf : bytes_a_f);
  const int bytes_b = align128(M * a.ldb * 2);
  const int bytes_c = align128(2 * M * HD * 2 > M * LDH * 2 ? 2 * M * HD * 2 : M * LDH * 2);
  a.off_b = bytes_a;
  a.off_c = bytes_a + bytes_b;
  a.off_s = a.off_c + bytes_c;
  const int smem = a.off_s + WARPS * 256 * 4;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      swin_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  swin_block_kernel<<<(unsigned)blocks, THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
