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
// against ~88 MB, 0.063 ms vs 0.026 ms). A second floor: every window group
// streams all of the block's bf16 weights from L2 (1.05 MB at C 256, hidden
// 512), 1.93 GB over the 1,844 groups of a video chunk's launch ([4, 180,
// 320, 256]), 0.28-0.35 ms at an L2 rate of 5.5-7 TB/s against 0.250 ms of
// operations: sharing slabs between the CTAs of a cluster (TMA multicast)
// is what would lift it.
//
// Schedule. Persistent CTAs, one an SM, each walking the groups of five
// consecutive windows (125 token rows, padded to 128) with a static stride.
// Warps 0-7 are two consumer warpgroups, each owning 64 token rows; warp 8's
// first thread streams the weight slabs of every group, in consumption
// order, through a 3-stage ring (at C 256); warp 9 loads the images and
// computes the masks, each copy as soon as the tile it fills is free:
// - y (the Q stream) lives in sQ, x (the K / V stream) in sA. The next
//   group's y comes once this group's fc2 GEMMs have read the hidden
//   chunks in sQ (yreq), its masks (two sets, by group parity) meanwhile;
//   the next group's x once this group's output has left sA, so it arrives
//   under the next LN1(y) and Q GEMM; x comes back for the residual once
//   the last K | V GEMM has read xn (xreq), under the last heads'
//   attention; the output leaves by TMA store when both warpgroups have
//   written it (oreq).
// - Every projection (Q; K|V of two heads at a time; proj; fc1 per 64-wide
//   hidden chunk; fc2) is a wgmma (m64nNk16, bf16, f32 accumulators in
//   registers) whose A (LN'd rows, attention output, GELU'd hidden chunk)
//   lies in shared memory in the canonical 128-byte-swizzled K-major layout;
//   each slab is one commit group, released once the next is in flight.
// - The f32 residual stays in registers: the proj accumulators get x (read
//   from the tile, swizzled in place first) + bp added, with LN2's row sums
//   taken in the same pass, LN2's bf16 rows become fc1's A, each fc1 chunk
//   goes through bias + GELU to a bf16 shared tile, fc2 accumulates onto
//   the residual registers, and the output is + b2 rounded to bf16 once.
//   The MLP is a software pipeline: chunk c's GELU runs on the warps while
//   the tensor cores accumulate chunk c - 1's fc2 onto the residual, so
//   the overlap costs no register beyond the residual's.
// - The attention runs per (window, head, 16-query half) in one warp on
//   mma.sync m16n8k16 (25 tokens padded to 32; f32 softmax on the
//   accumulator fragments; the bf16 probabilities reused in registers as
//   the A fragments of O = P v, O written over Q), three such tasks a warp
//   interleaved.
// Shared memory at C 256: sA and sQ 64 KB each, K | V of two heads 34 KB
// (the epilogues' 32 KB scratch and LN1's row statistics while K | V is
// dead), two mask sets 1 KB, two heads' relative-position bias 4.9 KB, the
// staged parameters 9 KB, the ring 48 KB, barriers: 226 KB and alignment.
// Measured (PERF.md): a group took ~112 us with one CTA per group and 189 KB
// of code fetched from L2 for every group; the code is now under 128 KB and
// a group ~73 us, of which ~18 us are tensor work at the card's peak. What
// still runs beside no MMA: the LayerNorms, the Q / K|V epilogues, the
// window attention and the residual (K|V's accumulators beside the
// attention's state, or fc1's beside the residual and the GELU, pass the
// 232 registers, and ptxas then serialises every MMA of the kernel); and
// the 3-stage ring holds less than one GEMM.
// C below 256 runs at CP = 64, 128 or 256 columns: TMA fills the weights'
// missing rows and columns with zeros and the padded columns stay zero.
// The stages (ring, GEMM, LayerNorm, window attention, MLP chunks, epilogue
// scratch, window loads and stores) are swin_wgmma.cuh's, which K8 and K9
// compose too.

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
  // 1024-aligned, by pointer arithmetic on the shared array so that every
  // address derived from it stays a shared-memory one
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const WinSmem s0 = win_smem(smem, a);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int C = a.C;
  const int groups = (a.total_win + G - 1) / G;

  if (tid == 0) init_window_barriers(s0, a.stages);
  __syncthreads();

  if (warp >= 8) {
    producer_regs();
    if (warp == 8 && lane == 0) {
      // ---------------- producer: every group's slabs in consumption order
      Producer pr{s0.ring_s, s0.bar_s, a.stages, 0, 0};
#pragma unroll 1
      for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
        produce_attn<CP>(pr, &maps.q, &maps.kv, &maps.p, a.heads, C);
        produce_mlp<CP>(pr, &maps.w1, &maps.w2, a.hidden / HC);
      }
    } else if (warp == 9) {
      // ---------------- loader: each group's masks and image copies, in
      // the order the consumers free their tiles
      int it = 0;
#pragma unroll 1
      for (int grp = blockIdx.x; grp < groups; grp += gridDim.x, ++it) {
        const WinSmem s = win_smem(smem, a, it & 1);
        const int win0 = grp * G;
        const int next = grp + (int)gridDim.x;
        if (it == 0) {
          if (lane == 0) {
            load_windows<CP>(a, &maps.y, s.sQ_s(), ybar(s), win0);
            load_windows<CP>(a, &maps.x, s.sA_s(), xbar(s), win0);
          }
          masks_ready(a, s, win0);
        }
        if (lane == 0) {
          mbar_wait(xreq(s), it & 1);   // the residual's x
          load_windows<CP>(a, &maps.x, s.sA_s(), xbar(s), win0);
        }
        if (next < groups) {
          // the next group's masks now, its y once this group's hidden
          // chunks in sQ are dead
          const WinSmem sn = win_smem(smem, a, (it + 1) & 1);
          masks_ready(a, sn, next * G);
          if (lane == 0) {
            mbar_wait(yreq(s), it & 1);
            load_windows<CP>(a, &maps.y, sn.sQ_s(), ybar(sn), next * G);
          }
        }
        if (lane == 0) {
          store_group<CP>(a, s, &maps.o, win0, it & 1);
          // sA is free: the next group's x comes in under its LN1(y) and Q
          if (next < groups) load_windows<CP>(a, &maps.x, s.sA_s(), xbar(s), next * G);
        }
        __syncwarp();
      }
    }
    return;
  }

  // ---------------- consumers
  consumer_regs();
  const int wg = warp >> 2;
  const int q4 = lane & 3;
  const int row0 = wg * 64 + (warp & 3) * 16;   // this warp's 16 token rows
  const int r0 = row0 + (lane >> 2);            // accumulator rows r0, r0 + 8
  Ring ring{s0.ring_s, s0.bar_s, a.stages, 0, 0, 0};
  stage_params<CP>(a, s0, true);
  bar_sync(1, 256);

  int it = 0;
#pragma unroll 1
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x, ++it) {
    // the masks alternate between two sets, the loader filling the next
    const WinSmem s = win_smem(smem, a, it & 1);
    const int win0 = grp * G;

    // ---- x2 = x + (O Wp^T + bp): the residual, in registers from here on
    float res[NH][NP / 2];
    window_attention<CP>(a, s, ring, win0, it & 1, true, res);
    const int nvalid = min(G, a.total_win - win0) * NT;   // token rows, then padding
    const bool ok0 = r0 < nvalid, ok1 = r0 + 8 < nvalid;
    mbar_wait(xbar(s), 1);
    reswizzle_rows<true>(s.sA(), row0, lane, CP);
    // LN2's sums over each row, taken in the same pass
    float sm0 = 0.0f, ss0 = 0.0f, sm1 = 0.0f, ss1 = 0.0f;
    pairs_via_scratch<NP, NH, true>(
        res, scratch(s),
        [&](int p, int j, int h) {   // bp and x, read unconditionally (no branch)
          const int col = p * NP + 8 * j + 2 * q4;
          const float2 x = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(s.sA() + swz(r0 + 8 * h, col)));
          return Pair2{lds2(s.bp() + col),
                       (h ? ok1 : ok0) ? x : make_float2(0.0f, 0.0f)};
        },
        [&](int p, int j, int h, float2 v, Pair2 bx) {
          const bool live = p * NP + 8 * j + 2 * q4 < C;
          v.x = live ? bx.b.x + (v.x + bx.a.x) : v.x;
          v.y = live ? bx.b.y + (v.y + bx.a.y) : v.y;
          // padded columns are 0
          if (h) {
            sm1 += v.x;
            ss1 += v.x * v.x;
            sm1 += v.y;
            ss1 += v.y * v.y;
          } else {
            sm0 += v.x;
            ss0 += v.x * v.x;
            sm0 += v.y;
            ss0 += v.y * v.y;
          }
          return v;
        });
    // ---- LN2(x2) -> sA, over the x values this thread has just read
    sm0 += __shfl_xor_sync(FULL, sm0, 1);
    sm0 += __shfl_xor_sync(FULL, sm0, 2);
    ss0 += __shfl_xor_sync(FULL, ss0, 1);
    ss0 += __shfl_xor_sync(FULL, ss0, 2);
    sm1 += __shfl_xor_sync(FULL, sm1, 1);
    sm1 += __shfl_xor_sync(FULL, sm1, 2);
    ss1 += __shfl_xor_sync(FULL, ss1, 1);
    ss1 += __shfl_xor_sync(FULL, ss1, 2);
    const float mu0 = sm0 / C, mu1 = sm1 / C;
    const float rs0 = rsqrtf(fmaxf(ss0 / C - mu0 * mu0, 0.0f) + 1e-5f);
    const float rs1 = rsqrtf(fmaxf(ss1 / C - mu1 * mu1, 0.0f) + 1e-5f);
    pairs_via_scratch<NP, NH, false>(
        res, scratch(s),
        [&](int p, int j, int) {   // LN2's weight and bias
          const int col = p * NP + 8 * j + 2 * q4;
          return Pair2{lds2(s.ln2w() + col), lds2(s.ln2b() + col)};
        },
        [&](int p, int j, int h, float2 v, Pair2 wb) {
          const int col = p * NP + 8 * j + 2 * q4;
          const float mu = h ? mu1 : mu0, rs = h ? rs1 : rs0;
          const uint32_t o =
              pack_bf16x2((v.x - mu) * rs * wb.a.x + wb.b.x, (v.y - mu) * rs * wb.a.y + wb.b.y);
          *reinterpret_cast<uint32_t*>(s.sA() + swz(r0 + 8 * h, col)) =
              (h ? ok1 : ok0) && col < C ? o : 0u;
          return v;
        });
    fence_proxy_async();
    bar_sync(2 + wg, 128);

    // ---- MLP, 128 hidden columns at a time: x2 += gelu(LN2 W1^T + b1) W2^T
    mlp_chunks<CP>(res, s.sA_s(), s.sQ(), scratch(s), ring, s.b1(), a.hidden, false, [] {});
    // this warpgroup's fc2 GEMMs have read its rows of the hidden chunks in
    // sQ: the next group's y may come in once the other's have too
    if ((tid & 127) == 0 && grp + (int)gridDim.x < groups) mbar_arrive(yreq(s));

    // ---- out = x2 + b2, rounded to bf16 once, into sA's rows (this
    // warpgroup's last fc1 GEMM has read LN2's), for the loader to store
    store_windows<CP>(a, s, res, s.b2());
  }
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
  const int smem = window_layout(a, true);
  if (smem == 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      swin_block_kernel<CP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  // persistent CTAs, one an SM, each walking the window groups with a
  // static stride
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int groups = (a.total_win + G - 1) / G;
  swin_block_kernel<CP><<<groups < sms ? groups : sms, THREADS, smem, stream>>>(maps, a);
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
