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

#include "swin_common.cuh"

using namespace swin;

namespace {

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

  // ---- LN1, Q, K / V and the per-head attention: O -> bufB
  attention(a, bufA, bufB, rc, st, win0, total_win);

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
  mlp(bufB, ldb, x2, ldf, rc, st, a.w1, a.b1, a.w2, C, a.hidden);

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
