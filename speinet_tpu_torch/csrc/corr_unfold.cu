// K5, K6 and K7: patch correlation max / argmax on explicit 3x3 unfolds,
// one kernel in three modes.
//
// K5 (SCALED) replaces speinet_tpu/ops/pallas_corr.py::
// correlation_argmax_pallas_lds (pallas_call at :260 in _corr_impl_lds :236,
// body _corr_kernel_lds :147):
//     R[k, i] = < bf16(ref[:, k] * bf16(inv[k])), lr[:, i] >   (f32 sums)
//     S[i]    = max_k R[k, i],   idx[i] = first k attaining it
// lr [B, D, L] and ref [B, D, Lr] are raw bf16 unfolds (D = 9C, D-major:
// row d holds all positions, positions contiguous), inv [B, Lr] f32. Rows
// of ref past Lr are masked out. The caller scales S by the query-side
// inverse norms afterwards; the argmax does not depend on them.
//
// K6 (PLAIN) replaces correlation_argmax_pallas_ld (pallas_call at :204,
// body _corr_kernel_ld :117): the same with the reference already scaled on
// the host (kernels/corr.py::scaled_reference), so no scale in the kernel.
// The operands it multiplies are then the very bf16 values K5 forms in its
// fragments, and the loop is the same, so K6 on the host-scaled reference
// returns K5's S and idx bit for bit.
// K7 (ROWS) replaces correlation_argmax_pallas (pallas_call at :83, body
// _corr_kernel :32): no scale, operands already L2-normalized, and the
// reference in [B, Lr, D] layout (each position's D values contiguous). Its
// B fragments come from ldmatrix without .trans on a staged [TK][DK] chunk
// whose rows are DK + 8 = 72 bf16 (144 bytes, an odd multiple of 16) apart;
// the D-major modes stage [DK][TL] chunks with rows 136 bf16 apart.
//
// Rounding: the TPU kernel multiplies the bf16 operand by inv cast to bf16
// and rounds the product to bf16 before the dot (pallas_corr.py:163). The
// product of two bf16 values is exact in f32, so rounding it once to
// nearest-even bf16, as this kernel's bf16x2 multiply does, gives the
// TPU's operand bit for bit.
//
// Bound on the H100, in every mode: operations. At 720p lv3 (L = Lr = 57,600, D = 1152)
// the product is 2*L*Lr*D = 7.64 TFLOP per sample against 265 MB of input.
// Design: a CTA owns 128 query positions and walks every 128-wide reference
// tile in ascending order. D is too deep to stage whole (a 128-position
// tile is 295 KB), so each tile pair is contracted 64 rows of D at a time:
// both raw 64 x 128 chunks go by cp.async into a 3-stage ring in shared
// memory (one barrier per chunk, two chunks in flight), and are multiplied
// on tensor cores (mma.sync m16n8k16 bf16, f32 accumulators held across
// the whole depth). In the D-major modes both operands are [D, positions]
// row-major, so both fragments come from ldmatrix.trans; rows are 136 bf16
// (272 bytes, an odd multiple of 16) apart, so the eight rows of every
// 8 x 8 matrix fall on eight bank groups. Each register of a B fragment
// holds two depth rows of one reference position, so K5's scale is applied
// there, after ldmatrix: one bf16x2 multiply rounded to nearest even, the correctly rounded
// product, which is what rounding the exact f32 product gives. After a
// tile's last chunk each warp folds its 32 x 64 scores into a per-query
// running (max, index), ties to the smaller index; the quads and the two
// warps of a query row block are merged the same way at the end, so the
// result is the first maximum, as the TPU kernel's ascending scan with a
// strict '>' gives. All CTAs sweep the reference tiles in the same order,
// so those resident together share each tile through L2. The query chunks
// are re-read from L2 / HBM for every reference tile (about 60 GB per 720p
// sample). A 256-wide query tile (one CTA per SM) was slower (PERF.md, PR
// 2); wgmma and TMA are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "tensor_core.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TL = 128;                    // query positions per CTA
constexpr int TK = 128;                    // reference positions per tile
constexpr int DK = 64;                     // depth rows per staged chunk
constexpr int STAGES = 3;                  // chunks in the shared-memory ring
constexpr int LDS = TL + 8;                // staged row pitch, bf16
constexpr int THREADS = 256;
constexpr int VECS = TL / 8;               // 16-byte vectors per staged row
constexpr int ROWS_PER_PASS = THREADS / VECS;
constexpr int PASSES = DK / ROWS_PER_PASS;
constexpr int LDK = DK + 8;                // staged row pitch of a [TK][DK] chunk
constexpr int LR_ELEMS = DK * LDS;         // one staged query chunk
static_assert(TL == TK, "one staging map serves both D-major operands");

enum Mode { SCALED, PLAIN, ROWS };

// bf16 elements of one ring stage: the query chunk, then the reference chunk
template <Mode MODE>
__host__ __device__ constexpr int stage_elems() {
  return LR_ELEMS + (MODE == ROWS ? TK * LDK : DK * LDS);
}

__device__ __forceinline__ bool better(float v, int q, float bv, int bq) {
  return v > bv || (v == bv && q < bq);
}

// two bf16 times one bf16 scale, rounded to nearest even
__device__ __forceinline__ uint32_t scale2(uint32_t v, __nv_bfloat162 s) {
  __nv_bfloat162 h;
  memcpy(&h, &v, 4);
  const __nv_bfloat162 r = __hmul2(h, s);
  uint32_t out;
  memcpy(&out, &r, 4);
  return out;
}

// REF is [B, D, ldr] (SCALED, PLAIN) or [B, Lr, D] (ROWS); INV is read in
// SCALED mode only
template <Mode MODE>
__global__ void __launch_bounds__(THREADS, 2) corr_unfold_kernel(
    const bf16* __restrict__ LR, const bf16* __restrict__ REF,
    const float* __restrict__ INV, float* __restrict__ S,
    int* __restrict__ IDX, int D, int L, int ldl, int Lr, int ldr) {
  constexpr int STAGE_ELEMS = stage_elems<MODE>();
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);                 // [STAGES][STAGE_ELEMS]
  float* comb_v = reinterpret_cast<float*>(ring + STAGES * STAGE_ELEMS);  // [TL]
  int* comb_q = reinterpret_cast<int*>(comb_v + TL);                      // [TL]

  const int b = blockIdx.y;
  const int i0 = blockIdx.x * TL;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wi = warp >> 1;   // query positions 32wi .. 32wi+31 of the tile
  const int wk = warp & 1;    // reference positions 64wk .. 64wk+63
  const bf16* lrb = LR + (size_t)b * D * ldl;
  const bf16* rfb = REF + (size_t)b * D * (MODE == ROWS ? Lr : ldr);
  const float* invb = MODE == SCALED ? INV + (size_t)b * Lr : nullptr;

  const int n_dc = (D + DK - 1) / DK;
  const int n_kt = (Lr + TK - 1) / TK;
  const int total = n_dc * n_kt;

  // staging map: this thread moves positions 8*col8 .. +7 of rows
  // srow + ROWS_PER_PASS * p of both chunks (ld % 8 == 0, so a vector is
  // wholly inside or wholly outside the padded row)
  const int col8 = tid % VECS;
  const int srow = tid / VECS;
  // ROWS mode's reference map: depth vector dvec of positions kpos + 32 p
  const int dvec = tid % (DK / 8);
  const int kpos = tid / (DK / 8);

  // issue the copies of chunk `step` (if any) into its ring stage; one
  // commit group per call, empty past the end, so group counts stay fixed
  auto issue = [&](int step) {
    if (step < total) {
      const int kt = step / n_dc;
      const int d0 = (step - kt * n_dc) * DK;
      bf16* lr_dst = ring + (step % STAGES) * STAGE_ELEMS;
      bf16* rf_dst = lr_dst + LR_ELEMS;
      const int i = i0 + col8 * 8;
      const int k = kt * TK + col8 * 8;
#pragma unroll
      for (int p = 0; p < PASSES; ++p) {
        const int r = srow + ROWS_PER_PASS * p;
        const bool d_ok = d0 + r < D;
        bf16* dl = lr_dst + r * LDS + col8 * 8;
        if (d_ok && i < ldl)
          __pipeline_memcpy_async(dl, lrb + (size_t)(d0 + r) * ldl + i, 16);
        else
          *reinterpret_cast<uint4*>(dl) = make_uint4(0, 0, 0, 0);
        if constexpr (MODE != ROWS) {
          bf16* dr = rf_dst + r * LDS + col8 * 8;
          if (d_ok && k < ldr)
            __pipeline_memcpy_async(dr, rfb + (size_t)(d0 + r) * ldr + k, 16);
          else
            *reinterpret_cast<uint4*>(dr) = make_uint4(0, 0, 0, 0);
        }
      }
      if constexpr (MODE == ROWS) {
        // [TK positions][DK depth]: 8 vectors per position row (D % 8 == 0,
        // so a vector is wholly inside or wholly outside the row)
        const int d = d0 + dvec * 8;
#pragma unroll
        for (int p = 0; p < TK * DK / 8 / THREADS; ++p) {
          const int pos = kpos + (THREADS / (DK / 8)) * p;
          const int kk = kt * TK + pos;
          bf16* dr = rf_dst + pos * LDK + dvec * 8;
          if (kk < Lr && d < D)
            __pipeline_memcpy_async(dr, rfb + (size_t)kk * D + d, 16);
          else
            *reinterpret_cast<uint4*>(dr) = make_uint4(0, 0, 0, 0);
        }
      }
    }
    __pipeline_commit();
  };

  // this lane's ldmatrix.trans row (a depth row) and column offset
  const int a_drow = (lane & 7) + ((lane >> 4) & 1) * 8;
  const int a_icol = ((lane >> 3) & 1) * 8;
  const int b_drow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_kcol = (lane >> 4) * 8;
  // this lane's ldmatrix row (a reference position) and depth offset in
  // ROWS mode: matrices (positions 0-7, depth 0-7), (0-7, 8-15), (8-15,
  // 0-7), (8-15, 8-15) are the same four B registers .trans gives above
  const int b_krow = (lane & 7) + ((lane >> 4) & 1) * 8;
  const int b_dcol = ((lane >> 3) & 1) * 8;
  const uint32_t ring_sa = static_cast<uint32_t>(__cvta_generic_to_shared(ring));

  float acc[2][8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.0f;
  // running (max, index) of query positions lane/4 and lane/4 + 8 of the
  // two m16 blocks of this warp, over the reference positions it holds
  float best_v[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
  int best_q[2][2] = {{0, 0}, {0, 0}};
  // bf16(inv) of reference position 8n + lane/4 of this warp's 64 in the
  // current tile: the column of n8 block n that this lane's B registers hold
  __nv_bfloat162 sc[8];

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) issue(st);
  for (int s = 0; s < total; ++s) {
    __pipeline_wait_prior(STAGES - 2);   // this thread's copies of chunk s
    __syncthreads();   // everyone's copies landed; stage (s-1) % STAGES is free
    issue(s + STAGES - 1);

    const int kt = s / n_dc;
    const int dc = s - kt * n_dc;
    if (MODE == SCALED && dc == 0) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int q = kt * TK + wk * 64 + 8 * n + (lane >> 2);
        sc[n] = __bfloat162bfloat162(__float2bfloat16_rn(q < Lr ? invb[q] : 0.0f));
      }
    }
    const uint32_t la = ring_sa + (uint32_t)((s % STAGES) * STAGE_ELEMS * 2);
    const uint32_t ra = la + (uint32_t)(LR_ELEMS * 2);
#pragma unroll
    for (int kk = 0; kk < DK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
        ldmatrix_x4_trans(a[m], la + (uint32_t)(((kk + a_drow) * LDS + wi * 32
                                                 + m * 16 + a_icol) * 2));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // depth rows kk..kk+15 of reference positions 16j .. 16j+15 of
        // this warp's 64: n8 blocks 2j (bm[0], bm[1]) and 2j+1 (bm[2], bm[3])
        uint32_t bm[4];
        if constexpr (MODE == ROWS) {
          ldmatrix_x4(bm, ra + (uint32_t)(((wk * 64 + j * 16 + b_krow) * LDK
                                           + kk + b_dcol) * 2));
        } else {
          ldmatrix_x4_trans(bm, ra + (uint32_t)(((kk + b_drow) * LDS + wk * 64
                                                 + j * 16 + b_kcol) * 2));
        }
        if constexpr (MODE == SCALED) {
          bm[0] = scale2(bm[0], sc[2 * j]);
          bm[1] = scale2(bm[1], sc[2 * j]);
          bm[2] = scale2(bm[2], sc[2 * j + 1]);
          bm[3] = scale2(bm[3], sc[2 * j + 1]);
        }
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma_bf16(acc[m][2 * j], a[m], bm[0], bm[1]);
          mma_bf16(acc[m][2 * j + 1], a[m], bm[2], bm[3]);
        }
      }
    }

    if (dc == n_dc - 1) {
      // acc[m][n][2h + e]: query position 32wi + 16m + lane/4 + 8h against
      // reference position kt*TK + 64wk + 8n + 2(lane%4) + e
      const int kbase = kt * TK + wk * 64 + 2 * (lane & 3);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = kbase + 8 * n + e;
          if (q < Lr) {
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float v = acc[m][n][2 * h + e];
                if (better(v, q, best_v[m][h], best_q[m][h])) {
                  best_v[m][h] = v;
                  best_q[m][h] = q;
                }
              }
          }
        }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.0f;
    }
  }
  __pipeline_wait_prior(0);

  // the four lanes of a quad scanned disjoint reference columns
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best_v[m][h], o);
        const int oq = __shfl_xor_sync(0xffffffffu, best_q[m][h], o);
        if (better(ov, oq, best_v[m][h], best_q[m][h])) {
          best_v[m][h] = ov;
          best_q[m][h] = oq;
        }
      }
  // the two warps of a query row block scanned disjoint reference columns
  const bool lead = (lane & 3) == 0;
  if (wk == 1 && lead) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int slot = wi * 32 + m * 16 + (lane >> 2) + 8 * h;
        comb_v[slot] = best_v[m][h];
        comb_q[slot] = best_q[m][h];
      }
  }
  __syncthreads();
  if (wk == 0 && lead) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int slot = wi * 32 + m * 16 + (lane >> 2) + 8 * h;
        float v = best_v[m][h];
        int q = best_q[m][h];
        if (better(comb_v[slot], comb_q[slot], v, q)) {
          v = comb_v[slot];
          q = comb_q[slot];
        }
        const int i = i0 + slot;
        if (i < L) {
          S[(size_t)b * L + i] = v;
          IDX[(size_t)b * L + i] = q;
        }
      }
  }
}

template <Mode MODE>
cudaError_t launch(const void* LR, const void* REF, const void* INV, void* S,
                   void* IDX, int B, int D, int L, int ldl, int Lr, int ldr,
                   cudaStream_t stream) {
  const size_t smem = (size_t)STAGES * stage_elems<MODE>() * sizeof(bf16)
                      + TL * (sizeof(float) + sizeof(int));
  cudaError_t e = cudaFuncSetAttribute(
      corr_unfold_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((L + TL - 1) / TL, B);
  corr_unfold_kernel<MODE><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(LR), static_cast<const bf16*>(REF),
      static_cast<const float*>(INV), static_cast<float*>(S),
      static_cast<int*>(IDX), D, L, ldl, Lr, ldr);
  return cudaGetLastError();
}

}  // namespace

// K5 / K6. LR [B, D, ldl] bf16 (positions >= L are padding), REF [B, D, ldr]
// bf16 (positions >= Lr are padding, masked), INV [B, Lr] f32 or null (no
// scale: K6) -> S [B, L] f32, IDX [B, L] int32. ldl and ldr must be
// multiples of 8 (16-byte rows).
extern "C" int speinet_corr_unfold(const void* LR, const void* REF,
                                   const void* INV, void* S, void* IDX, int B,
                                   int D, int L, int ldl, int Lr, int ldr,
                                   void* stream) {
  if (B < 1 || B > 65535 || D < 1 || L < 1 || Lr < 1 || ldl < L || ldr < Lr
      || ldl % 8 != 0 || ldr % 8 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (INV == nullptr)
    return launch<PLAIN>(LR, REF, INV, S, IDX, B, D, L, ldl, Lr, ldr, s);
  return launch<SCALED>(LR, REF, INV, S, IDX, B, D, L, ldl, Lr, ldr, s);
}

// K7. LR [B, D, ldl] bf16 as above, REF [B, Lr, D] bf16 (position-major)
// -> S [B, L] f32, IDX [B, L] int32. ldl and D must be multiples of 8.
extern "C" int speinet_corr_rows(const void* LR, const void* REF, void* S,
                                 void* IDX, int B, int D, int L, int ldl,
                                 int Lr, void* stream) {
  if (B < 1 || B > 65535 || D < 8 || D % 8 != 0 || L < 1 || Lr < 1 || ldl < L
      || ldl % 8 != 0)
    return cudaErrorInvalidValue;
  return launch<ROWS>(LR, REF, nullptr, S, IDX, B, D, L, ldl, Lr, 0,
                      static_cast<cudaStream_t>(stream));
}
