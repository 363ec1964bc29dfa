// K8: LN1 + window cross-attention + output projection of a Swin block,
// per group of five 5x5 windows.
//
// Replaces speinet_tpu/ops/pallas_swin.py::fused_window_cross_attention
// (pallas_call at :629, body _kernel :32). For every window of the rolled /
// padded images x (the K/V stream) and y (the Q stream):
//     xn, yn = LN1(x), LN1(y)                           (f32 math, eps 1e-5)
//     q = (yn Wq + bq) * hd^-1/2,  k|v = xn Wkv + bkv    (bf16 operands, f32 sums)
//     per head: O = softmax(q k^T + relpos_bias + mask) v  (f32 softmax)
//     out = bf16(O Wp + bp)
// The output is the attention branch alone, before the residual and still
// rolled / padded; the caller rolls back, crops, adds it to x and runs K9.
// The mask comes from window coordinates, as in K2; the TPU's packed
// g-window masks and block-diagonal bias are MXU tiling devices and are
// not carried over.
//
// Bound on the H100: operations. At [2, 180, 320, 256], 8 heads, window 5
// the projections take 8 C^2 and the scores 4 N C FLOP per token, ~6.3e10
// FLOP (0.064 ms at 989 TFLOP/s) against 177 MB of x, y and output
// (0.053 ms). Design: K2's attention stage (swin_common.cuh::attention)
// unchanged, then the projection as a [128 x C] x [C x C] WMMA product
// whose bf16 tiles land in the dead LN1 buffer and go out row by row to
// their pixels. ~160 KB of shared memory, one CTA per SM.

#include "swin_common.cuh"

using namespace swin;

namespace {

__global__ void __launch_bounds__(THREADS, 1) swin_attn_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* bufA = reinterpret_cast<bf16*>(smem);              // yn, xn, then the output
  bf16* bufB = reinterpret_cast<bf16*>(smem + a.off_b);     // Q -> O
  bf16* rc = reinterpret_cast<bf16*>(smem + a.off_c);       // K_h | V_h
  float* stage = reinterpret_cast<float*>(smem + a.off_s);  // [WARPS][16x16]

  const int C = a.C;
  const int ldb = a.ldb;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int win0 = blockIdx.x * G;
  const int total_win = a.B * (a.Hp / WS) * (a.Wp / WS);
  float* st = stage + warp * 256;

  attention(a, bufA, bufB, rc, st, win0, total_win);

  // ---- O Wp^T + bp -> bf16 into bufA (xn is dead)
  for (int ni = warp; ni < C / 16; ni += WARPS) {
    Acc acc[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) wmma::fill_fragment(acc[r], 0.0f);
    mma_rows<8>(acc, bufB, ldb, 0, a.wp + (size_t)ni * 16 * C, C, C);
#pragma unroll
    for (int r = 0; r < 8; ++r)
      store_bf16<false>(acc[r], st, bufA + (size_t)r * 16 * ldb + ni * 16, ldb,
                        a.bp + ni * 16, 1.0f, lane);
  }
  __syncthreads();

  // ---- rows out to their pixels
  if (lane * 8 < C) {
    for (int mm = warp; mm < M; mm += WARPS) {
      const long long off = pix_offset(a, mm, win0, total_win);
      if (off >= 0)
        *reinterpret_cast<uint4*>(a.out + off + lane * 8) =
            *reinterpret_cast<const uint4*>(bufA + (size_t)mm * ldb + lane * 8);
    }
  }
}

}  // namespace

// x, y, out [B, Hp, Wp, C] bf16 (rolled / padded); weights in torch Linear
// layout (bf16), biases, LayerNorm parameters and relbias [heads, 25, 25]
// in f32. h_valid / w_valid: the un-padded extent before the roll.
extern "C" int speinet_swin_attn(
    const void* x, const void* y, void* out, const void* ln1w,
    const void* ln1b, const void* wkv, const void* bkv, const void* wq,
    const void* bq, const void* wp, const void* bp, const void* relbias,
    int B, int Hp, int Wp, int C, int heads, int ws, int shift, int h_valid,
    int w_valid, float scale, void* stream) {
  if (ws != WS || Hp % WS != 0 || Wp % WS != 0 || C % 16 != 0 || C > 256 ||
      heads * HD != C || shift < 0 || shift >= WS || h_valid < 1 ||
      h_valid > Hp || w_valid < 1 || w_valid > Wp)
    return cudaErrorInvalidValue;
  const long long total_win = (long long)B * (Hp / WS) * (Wp / WS);
  const long long blocks = (total_win + G - 1) / G;
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  Args a = {};
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
  a.B = B;
  a.Hp = Hp;
  a.Wp = Wp;
  a.C = C;
  a.heads = heads;
  a.shift = shift;
  a.h_valid = h_valid;
  a.w_valid = w_valid;
  a.scale = scale;
  a.ldb = C + 8;   // +16 bytes per row: conflict-free fragment loads
  const int bytes_ab = align128(M * a.ldb * 2);
  a.off_b = bytes_ab;
  a.off_c = 2 * bytes_ab;
  a.off_s = a.off_c + align128(2 * M * HD * 2);
  const int smem = a.off_s + WARPS * 256 * 4;
  cudaError_t e = cudaFuncSetAttribute(
      swin_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  swin_attn_kernel<<<(unsigned)blocks, THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
