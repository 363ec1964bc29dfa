// K9: the MLP half of a Swin block over token rows,
//     out = x + bf16(fc2(bf16(gelu(fc1(bf16(LN2(x)))))))
//
// Replaces speinet_tpu/ops/pallas_swin.py::fused_ln_mlp (pallas_call at
// :131, body _ln_mlp_kernel :109). x and out are [rows, C] bf16 (the
// [B, L, C] stream flattened), LN2 in f32 with eps 1e-5 and the one-pass
// clamped variance, fc1 / fc2 bf16 products with f32 sums, the hidden layer
// and the fc2 result (+ b2) each rounded to bf16 as the TPU kernel rounds
// them (:115): unlike K2, which adds fc2 onto its f32 residual and rounds
// once, the MLP branch is rounded before x is added. GELU by erff (the
// TPU's 1.5e-7 erf polynomial has no reason to exist here).
//
// Bound on the H100: operations. At [2, 57,600, 256] with hidden 512 it is
// 4 C hidden = 6.0e10 FLOP (0.061 ms at 989 TFLOP/s) against 118 MB of
// input and output (0.035 ms). Design: K2's MLP stage and pipeline from
// swin_wgmma.cuh on 128 rows per CTA:
// - x arrives by TMA through a 2-D map over [rows, C] in 64-row x
//   64-channel boxes, 128-byte swizzled, each consumer warpgroup loading
//   and storing its own 64 rows, so the two warpgroups meet only at the
//   weight ring. TMA zero-fills the rows past the last one and clips the
//   stores there, so the ragged last CTA needs no masking.
// - LN2 in place on the tile (K2's LayerNorm), then K2's MLP pipeline
//   (swin_wgmma.cuh, mlp_chunks): fc1 per 64-wide hidden chunk on wgmma,
//   parked in a scratch, bias + erf-GELU into one of two bf16 swizzled
//   hidden tiles while the tensor cores run the chunk before's fc2, fc2
//   into accumulators of its own (the first chunk overwrites them),
//   weights through the producer's TMA ring.
// - x comes back by TMA into the LN tile once the last fc1 product has
//   read it (K2's "x twice"), overlapping the last chunk's fc2;
//   the epilogue adds it to bf16(fc2 + b2) in place in the swizzled tile
//   (conflict-free) and stores the rows by TMA.
// Shared memory at C = 256: LN / x tile 64 KB, two hidden tiles 32 KB, a
// 4-stage ring of 16 KB slabs, the GELU's 32 KB scratch, LN2's row
// statistics and the staged parameters (~200 KB, one CTA per SM).
// Registers per consumer thread (232 after setmaxnreg): 128 f32 fc2
// accumulators plus 32 of the fc1 chunk. C below 256 runs at CP = 64 or
// 128 columns, the padded columns zero (TMA fills the weights' missing
// rows and columns).

#include "swin_wgmma.cuh"

using namespace swin;

namespace {

struct Maps {
  CUtensorMap w1, w2;   // weights, [rows, K] in 64 x rows boxes
  CUtensorMap x, o;     // token rows, [rows, C] in 64 x 64 boxes
};

struct MlpArgs {
  const float *ln2w, *ln2b, *b1, *b2;
  long long rows;
  int C, hidden, stages, off_h, off_ring, off_scr, off_prm, off_bar;
};

template <int CP>
__global__ void __launch_bounds__(THREADS, 1) swin_mlp_kernel(
    const __grid_constant__ Maps maps, const MlpArgs a) {
  constexpr int NP = Tile<CP>::NP, NH = Tile<CP>::NH, NKB = Tile<CP>::NKB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sA = smem;                  // x, LN2(x), then x again and the output
  const uint32_t sA_s = smem_u32(sA);
  const uint32_t ring_s = smem_u32(smem + a.off_ring);
  const uint32_t bar_s = smem_u32(smem + a.off_bar);
  // the parameters, staged: LN2's weight and bias, b2 (each padded to CP),
  // b1 (padded to whole hidden chunks)
  float* ln2w = reinterpret_cast<float*>(smem + a.off_prm);
  float* ln2b = ln2w + CP;
  float* b2 = ln2w + 2 * CP;
  float* b1 = ln2w + 3 * CP;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int C = a.C;
  const long long row0 = (long long)blockIdx.x * M;

  // ring barriers, then one x barrier per consumer warpgroup
  if (tid == 0) init_barriers(bar_s, a.stages, 2);
  __syncthreads();

  if (warp >= 8) {
    // ---------------- producer: fc1 / fc2 slabs in consumption order
    producer_regs();
    if (warp != 8 || lane != 0) return;
    Producer pr{ring_s, bar_s, a.stages, 0, 0};
    produce_mlp<CP>(pr, &maps.w1, &maps.w2, a.hidden / HC);
    return;
  }

  // ---------------- consumers
  consumer_regs();
  const int wg = warp >> 2;
  const int q4 = lane & 3;
  const int r0 = wg * 64 + (warp & 3) * 16 + (lane >> 2);   // accumulator rows r0, r0 + 8
  const int wg_bar = 2 + wg;
  Ring ring{ring_s, bar_s, a.stages, 0, 0, 0};
  const uint32_t xbar = bar_s + 16 * MAX_STAGES + 8 * wg;
  const uint32_t rows_s = sA_s + wg * 64 * 128;   // this warpgroup's 64 rows
  const int grow = (int)(row0 + wg * 64);         // their first row in x
  // this warpgroup's rows of x by TMA, swizzled, issued by its first thread
  auto load_x = [&]() {
    if ((tid & 127) == 0) {
      mbar_expect_tx(xbar, NKB * 64 * 128);
#pragma unroll
      for (int blk = 0; blk < NKB; ++blk)
        tma_load_2d(rows_s + blk * BLK, &maps.x, xbar, blk * 64, grow);
    }
  };

  // ---- LN2(x) -> sA
  load_x();
  stage_vec(ln2w, a.ln2w, C, CP, tid, 256);
  stage_vec(ln2b, a.ln2b, C, CP, tid, 256);
  stage_vec(b2, a.b2, C, CP, tid, 256);
  stage_vec(b1, a.b1, a.hidden, a.hidden, tid, 256);
  bar_sync(1, 256);
  mbar_wait(xbar, 0);
  const int nvalid = (int)min((long long)M, a.rows - row0);
  ln_rows<true>(sA, wg * 64 + (warp & 3) * 16, nvalid, lane, CP, C, ln2w, ln2b,
                reinterpret_cast<float2*>(smem + a.off_scr + SCRATCH_BYTES) + warp * 16);
  fence_proxy_async();
  bar_sync(wg_bar, 128);

  // ---- y = fc2(gelu(fc1(LN2(x)))), x back into sA after the last fc1
  float res[NH][NP / 2];
  mlp_chunks<CP>(res, sA_s, smem + a.off_h, reinterpret_cast<float2*>(smem + a.off_scr), ring,
                 b1, a.hidden, true, load_x);

  // ---- out = x + bf16(y + b2) over x in the tile, then the rows by TMA
  mbar_wait(xbar, 1);
#pragma unroll
  for (int p = 0; p < NH; ++p)
#pragma unroll
    for (int j = 0; j < NP / 8; ++j) {
      const int col = p * NP + 8 * j + 2 * q4;
      if (col < C) {
        const float2 bo = lds2(b2 + col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          __nv_bfloat162* px =
              reinterpret_cast<__nv_bfloat162*>(sA + swz(r0 + 8 * h, col));
          const float2 xv = __bfloat1622float2(*px);
          const float y0 = __bfloat162float(__float2bfloat16(res[p][4 * j + 2 * h] + bo.x));
          const float y1 = __bfloat162float(__float2bfloat16(res[p][4 * j + 2 * h + 1] + bo.y));
          *px = __floats2bfloat162_rn(xv.x + y0, xv.y + y1);
        }
      }
    }
  fence_proxy_async();
  bar_sync(wg_bar, 128);
  if ((tid & 127) == 0) {
#pragma unroll
    for (int blk = 0; blk < NKB; ++blk) tma_store_2d(&maps.o, rows_s + blk * BLK, blk * 64, grow);
    bulk_commit();
    bulk_wait_read();
  }
}

template <int CP>
cudaError_t launch(MlpArgs a, const void* x, void* out, const void* w1, const void* w2,
                   cudaStream_t stream) {
  constexpr int NP = Tile<CP>::NP;
  Maps maps;
  if (!make_map(&maps.w1, w1, a.C, a.hidden, HC) || !make_map(&maps.w2, w2, a.hidden, a.C, NP)
      || !make_map(&maps.x, x, a.C, a.rows, 64) || !make_map(&maps.o, out, a.C, a.rows, 64))
    return cudaErrorInvalidValue;
  // LN / x tile, two hidden chunks, the ring, the GELU's scratch and LN2's
  // row statistics, the staged parameters, barriers
  const int tile = M * CP * 2;
  const int prm_bytes = 4 * (3 * CP + a.hidden);
  a.off_h = tile;
  a.off_ring = tile + 2 * M * HC * 2;
  const int scr_bytes = SCRATCH_BYTES + 8 * 16 * 8;   // the GELU's scratch, LN2's row statistics
  const int fixed = a.off_ring + scr_bytes + prm_bytes + 16 * MAX_STAGES + 16 + 1024;
  a.stages = (227 * 1024 - fixed) / SLAB;
  if (a.stages > MAX_STAGES) a.stages = MAX_STAGES;
  if (a.stages < 2) return cudaErrorInvalidValue;
  a.off_scr = a.off_ring + a.stages * SLAB;
  a.off_prm = a.off_scr + scr_bytes;
  a.off_bar = (a.off_prm + prm_bytes + 7) & ~7;
  const int smem = a.off_bar + 16 * MAX_STAGES + 16 + 1024;
  cudaError_t e = cudaFuncSetAttribute(
      swin_mlp_kernel<CP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const long long blocks = (a.rows + M - 1) / M;
  swin_mlp_kernel<CP><<<(unsigned)blocks, THREADS, smem, stream>>>(maps, a);
  return cudaGetLastError();
}

}  // namespace

// x, out [rows, C] bf16; w1 [hidden, C], w2 [C, hidden] bf16 (torch Linear
// layout); ln2w, ln2b, b1, b2 f32.
extern "C" int speinet_swin_mlp(const void* x, void* out, const void* ln2w,
                                const void* ln2b, const void* w1,
                                const void* b1, const void* w2, const void* b2,
                                long long rows, int C, int hidden,
                                void* stream) {
  // rows + M stays an int TMA coordinate
  if (rows < 1 || rows > 0x7fffffffLL - M || C % 16 != 0 || C < 16 || C > 256 ||
      hidden % 64 != 0 || hidden < 64)
    return cudaErrorInvalidValue;
  MlpArgs a;
  a.ln2w = static_cast<const float*>(ln2w);
  a.ln2b = static_cast<const float*>(ln2b);
  a.b1 = static_cast<const float*>(b1);
  a.b2 = static_cast<const float*>(b2);
  a.rows = rows;
  a.C = C;
  a.hidden = hidden;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 64) return launch<64>(a, x, out, w1, w2, s);
  if (C <= 128) return launch<128>(a, x, out, w1, w2, s);
  return launch<256>(a, x, out, w1, w2, s);
}
