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
// The stages (ring, GEMM, LayerNorm, window attention, MLP chunks, window
// loads and stores) are swin_wgmma.cuh's, which K8 and K9 compose too.

#include "swin_wgmma.cuh"

using namespace swin;

namespace {

struct Maps {
  CUtensorMap q, kv, p, w1, w2;   // weights, [rows, K] in 64 x rows boxes
  CUtensorMap x, y, o;            // images, one window's 64 channels a box
};

template <int CP>
__global__ void __launch_bounds__(THREADS, 1) swin_block_kernel(
    const __grid_constant__ Maps maps, const WinArgs a) {
  constexpr int NP = Tile<CP>::NP, NH = Tile<CP>::NH;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const WinSmem s = win_smem(smem, a);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int win0 = blockIdx.x * G;
  const int C = a.C;

  // ring barriers, then y's and x's window barriers (x comes twice: LN1,
  // then the residual)
  if (tid == 0) init_barriers(s.bar_s, a.stages, 2);
  __syncthreads();

  if (warp >= 8) {
    // ---------------- producer: the block's slabs in consumption order
    producer_regs();
    if (warp != 8 || lane != 0) return;
    Producer pr{s.ring_s, s.bar_s, a.stages, 0, 0};
    produce_attn<CP>(pr, &maps.q, &maps.kv, &maps.p, a.heads, C);
    produce_mlp<CP>(pr, &maps.w1, &maps.w2, (a.hidden + HC - 1) / HC);
    return;
  }

  // ---------------- consumers
  consumer_regs();
  const int wg = warp >> 2;
  const int q4 = lane & 3;
  const int r0 = wg * 64 + (warp & 3) * 16 + (lane >> 2);   // accumulator rows r0, r0 + 8
  Ring ring{s.ring_s, s.bar_s, a.stages, 0, 0};

  // ---- x2 = x + (O Wp^T + bp): the residual, in registers from here on
  float res[NH][NP / 2];
  window_attention<CP>(a, s, &maps.x, &maps.y, ring, win0, true, res);
  long long off[2];
  off[0] = pix_off(a, r0, win0);
  off[1] = pix_off(a, r0 + 8, win0);
  mbar_wait(xbar(s), 1);
#pragma unroll
  for (int p = 0; p < NH; ++p)
#pragma unroll
    for (int j = 0; j < NP / 8; ++j) {
      const int col = p * NP + 8 * j + 2 * q4;
      if (col < C) {
        const float2 bpv = ldg2(a.bp + col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2 xv = make_float2(0.0f, 0.0f);
          if (off[h] >= 0)
            xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                s.sA + (col >> 6) * BLK + (r0 + 8 * h) * 128 + (col & 63) * 2));
          res[p][4 * j + 2 * h] = xv.x + (res[p][4 * j + 2 * h] + bpv.x);
          res[p][4 * j + 2 * h + 1] = xv.y + (res[p][4 * j + 2 * h + 1] + bpv.y);
        }
      }
    }
  // ---- LN2(x2) -> sA, over the raw x rows this quad has just read
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sm = 0.0f, ss = 0.0f;
#pragma unroll
    for (int p = 0; p < NH; ++p)
#pragma unroll
      for (int j = 0; j < NP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = res[p][4 * j + 2 * h + e];   // padded columns are 0
          sm += v;
          ss += v * v;
        }
    sm += __shfl_xor_sync(FULL, sm, 1);
    sm += __shfl_xor_sync(FULL, sm, 2);
    ss += __shfl_xor_sync(FULL, ss, 1);
    ss += __shfl_xor_sync(FULL, ss, 2);
    const float mu = sm / C;
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
        *reinterpret_cast<uint32_t*>(s.sA + swz(r0 + 8 * h, col)) = v;
      }
  }
  fence_proxy_async();
  bar_sync(2 + wg, 128);

  // ---- MLP, 128 hidden columns at a time: x2 += gelu(LN2 W1^T + b1) W2^T
  mlp_chunks<CP>(res, s.sA_s, s.sQ, ring, a.b1, a.hidden, false, [] {});

  // ---- out = x2 + b2, rounded to bf16 once, into sA's rows (this
  // warpgroup's last fc1 GEMM has read LN2's), then the windows by TMA
  store_windows<CP>(a, s, &maps.o, res, a.b2, win0);
}

template <int CP>
cudaError_t launch(WinArgs a, const void* wq, const void* wkv, const void* wp,
                   const void* w1, const void* w2, cudaStream_t stream) {
  constexpr int NP = Tile<CP>::NP;
  Maps maps;
  if (!make_map(&maps.q, wq, a.C, a.C, NP) || !make_map(&maps.kv, wkv, a.C, 2 * a.C, HD)
      || !make_map(&maps.p, wp, a.C, a.C, NP) || !make_map(&maps.w1, w1, a.C, a.hidden, HC)
      || !make_map(&maps.w2, w2, a.hidden, a.C, NP) || !make_img_map(&maps.x, a.x, a)
      || !make_img_map(&maps.y, a.y, a) || !make_img_map(&maps.o, a.out, a))
    return cudaErrorInvalidValue;
  const int smem = window_layout(a, CP, true);
  if (smem == 0) return cudaErrorInvalidValue;
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
  WinArgs a = {};
  if (hidden % 64 != 0 || hidden < 64 ||
      !window_args(a, x, y, out, B, Hp, Wp, C, heads, ws, shift, h_valid, w_valid, scale))
    return cudaErrorInvalidValue;
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
  a.hidden = hidden;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 64) return launch<64>(a, wq, wkv, wp, w1, w2, s);
  if (C <= 128) return launch<128>(a, wq, wkv, wp, w1, w2, s);
  return launch<256>(a, wq, wkv, wp, w1, w2, s);
}
