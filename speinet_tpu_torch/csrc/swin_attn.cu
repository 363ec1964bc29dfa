// K8: LN1 + window cross-attention + output projection of a Swin block,
// per group of five 5x5 windows.
//
// Replaces speinet_tpu/ops/pallas_swin.py::fused_window_cross_attention
// (pallas_call at :629, body _kernel :32). For every window of the rolled /
// padded images x (the K/V stream) and y (the Q stream):
//     xn, yn = LN1(x), LN1(y)                           (f32 math, eps 1e-5)
//     q = bf16((yn Wq + bq) * hd^-1/2),  k|v = bf16(xn Wkv + bkv)
//     per head: O = bf16(bf16(softmax(q k^T + relpos_bias + mask)) v)
//     out = bf16(O Wp + bp)
// (bf16 operands, f32 sums and softmax; the rounding points of _kernel
// :53-58 and :80-84). The output is the attention branch alone, before the
// residual and still rolled / padded; the caller rolls back, crops, adds it
// to x and runs K9. The mask comes from window coordinates, as in K2; the
// TPU's packed g-window masks and block-diagonal bias are MXU tiling
// devices and are not carried over.
//
// Bound on the H100: operations. At [2, 180, 320, 256], 8 heads, window 5
// the projections take 8 C^2 and the scores 4 N C FLOP per token, ~6.3e10
// FLOP (0.064 ms at 989 TFLOP/s) against 177 MB of x, y and output
// (0.053 ms). Design: K2's pipeline up to and including the projection,
// from swin_wgmma.cuh (its note has the stages), one window group a CTA:
// the loader warp brings y's windows into sQ and x's into sA by TMA and
// computes the masks, LN1 in place, Q on wgmma, K|V two heads at a time on
// wgmma, the attention on mma.sync, the projection on wgmma, the weights
// through a TMA ring that a producer warp keeps ahead. The epilogue is
// K8's own: + bp, rounded to bf16 into sA (dead since the last K|V GEMM),
// stored a window box at a time by the loader. Shared memory at C = 256:
// the window kernels' plan (swin_wgmma.cuh) without the MLP's parameters,
// ~221 KB with a 3-stage ring, one CTA per SM; registers: the
// projection's 128 f32 accumulators a consumer thread (232 after
// setmaxnreg).

#include "swin_wgmma.cuh"

using namespace swin;

namespace {

struct Maps {
  CUtensorMap q, kv, p;   // weights, [rows, K] in 64 x rows boxes
  CUtensorMap x, y, o;    // images, one window's 64 channels a box
};

template <int CP>
__global__ void __launch_bounds__(THREADS, 1) swin_attn_kernel(
    const __grid_constant__ Maps maps, const WinArgs a) {
  constexpr int NP = Tile<CP>::NP, NH = Tile<CP>::NH;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const WinSmem s = win_smem(smem, a);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int win0 = blockIdx.x * G;

  if (threadIdx.x == 0) init_window_barriers(s, a.stages);
  __syncthreads();

  if (warp >= 8) {
    producer_regs();
    if (warp == 8 && lane == 0) {
      // ---------------- producer: Q, K | V and proj slabs in consumption order
      Producer pr{s.ring_s, s.bar_s, a.stages, 0, 0};
      produce_attn<CP>(pr, &maps.q, &maps.kv, &maps.p, a.heads, a.C);
    } else if (warp == 9) {
      // ---------------- loader: y and x, the masks, then the output
      if (lane == 0) {
        load_windows<CP>(a, &maps.y, s.sQ_s(), ybar(s), win0);
        load_windows<CP>(a, &maps.x, s.sA_s(), xbar(s), win0);
      }
      masks_ready(a, s, win0);
      if (lane == 0) store_group<CP>(a, s, &maps.o, win0, 0);
    }
    return;
  }

  // ---------------- consumers
  consumer_regs();
  Ring ring{s.ring_s, s.bar_s, a.stages, 0, 0, 0};
  stage_params<CP>(a, s, false);
  bar_sync(1, 256);
  float res[NH][NP / 2];
  window_attention<CP>(a, s, ring, win0, 0, false, res);
  // ---- out = bf16(O Wp^T + bp), stored by the loader
  store_windows<CP>(a, s, res, s.bp());
}

template <int CP>
cudaError_t launch(WinArgs a, const void* wq, const void* wkv, const void* wp,
                   cudaStream_t stream) {
  constexpr int NP = Tile<CP>::NP;
  Maps maps;
  if (!make_map(&maps.q, wq, a.C, a.C, NP) || !make_map(&maps.kv, wkv, a.C, 2 * a.C, HD)
      || !make_map(&maps.p, wp, a.C, a.C, NP) || !make_img_map(&maps.x, a.x, a)
      || !make_img_map(&maps.y, a.y, a) || !make_img_map(&maps.o, a.out, a))
    return cudaErrorInvalidValue;
  const int smem = window_layout(a, false);
  if (smem == 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      swin_attn_kernel<CP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int blocks = (a.total_win + G - 1) / G;
  swin_attn_kernel<CP><<<blocks, THREADS, smem, stream>>>(maps, a);
  return cudaGetLastError();
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
  WinArgs a = {};
  if (!window_args(a, x, y, out, B, Hp, Wp, C, heads, ws, shift, h_valid, w_valid, scale))
    return cudaErrorInvalidValue;
  a.ln1w = static_cast<const float*>(ln1w);
  a.ln1b = static_cast<const float*>(ln1b);
  a.bkv = static_cast<const float*>(bkv);
  a.bq = static_cast<const float*>(bq);
  a.bp = static_cast<const float*>(bp);
  a.relbias = static_cast<const float*>(relbias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 64) return launch<64>(a, wq, wkv, wp, s);
  if (C <= 128) return launch<128>(a, wq, wkv, wp, s);
  return launch<256>(a, wq, wkv, wp, s);
}
