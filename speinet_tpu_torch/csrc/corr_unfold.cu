// K5, K6 and K7: patch correlation max / argmax on explicit 3x3 unfolds,
// one kernel in two operand layouts, with a scaling pre-pass for K5.
//
// K5 (scaled) replaces speinet_tpu/ops/pallas_corr.py::
// correlation_argmax_pallas_lds (pallas_call at :260 in _corr_impl_lds :236,
// body _corr_kernel_lds :147):
//     R[k, i] = < bf16(ref[:, k] * bf16(inv[k])), lr[:, i] >   (f32 sums)
//     S[i]    = max_k R[k, i],   idx[i] = first k attaining it
// lr [B, D, L] and ref [B, D, Lr] are raw bf16 unfolds (D = 9C, D-major:
// row d holds all positions, positions contiguous), inv [B, Lr] f32.
// Reference positions past Lr never win. The caller scales S by the
// query-side inverse norms afterwards; the argmax does not depend on them.
//
// K6 (D-major, no scale) replaces correlation_argmax_pallas_ld (pallas_call
// at :204, body _corr_kernel_ld :117): the same with the reference already
// scaled on the host (kernels/corr.py::scaled_reference).
// K7 (ROWS) replaces correlation_argmax_pallas (pallas_call at :83, body
// _corr_kernel :32): no scale, operands already L2-normalized, and the
// reference in [B, Lr, D] layout (each position's D values contiguous).
//
// K5's scale: a pre-pass (scale_kernel) writes bf16(ref * bf16(inv)) once
// per call into a scratch [B, D, ldr] buffer, and the K6 main loop runs on
// it. The TPU kernel multiplies the bf16 operand by inv cast to bf16 and
// rounds the product to bf16 before the dot (pallas_corr.py:163); the
// product of two bf16 values is exact in f32, so the bf16x2 multiply
// rounded to nearest even gives the TPU's operand bit for bit, the same
// operand the host forms, and K6 on the host-scaled reference returns K5's
// S and idx bit for bit by construction.
//
// Bound on the H100, in every mode: operations. At 720p lv3 (L = Lr =
// 57,600, D = 1152) the product is 2*L*Lr*D = 7.64 TFLOP per sample
// against 265 MB of input.
//
// Design (wgmma fed by TMA, warp-specialised, clusters of two CTAs):
// - A CTA owns 128 query positions and walks every reference tile of 256
//   positions in ascending order, contracting each tile pair 64 depth rows
//   at a time. Warps 0-7 are two consumer warpgroups, each holding a
//   64 x 256 f32 accumulator (wgmma m64n256k16, 128 registers a thread,
//   setmaxnreg 232); warps 8-11 are the producer warpgroup (setmaxnreg 40),
//   one thread of which issues every TMA load.
// - Ring of 4 stages, each a query chunk [64 depth][128 positions] (16 KB)
//   and a reference chunk (32 KB), written by TMA with 128-byte swizzle
//   under full / empty mbarriers. Ragged L, Lr and D tails are TMA's
//   out-of-bounds zero fill.
// - Operand layouts: in the D-major modes both operands are [D, positions]
//   in memory, so both are MN-major for wgmma (transpose bits set), stored
//   as 64 x 64 boxes (64 positions = 128 bytes inner, one row per depth).
//   In ROWS mode the reference chunk is [256 positions][64 depth], K-major.
// - The two CTAs of a cluster take query tiles 2j and 2j + 1 of the same
//   sample; each loads half of every reference chunk and multicasts it into
//   both CTAs' shared memory, so the reference is read from L2 once per
//   cluster. A stage is free when the consumers of both CTAs have released
//   it (each warpgroup arrives on its own and on the peer's empty barrier);
//   the query-tile count is padded to even (a CTA past L runs its loads
//   and MMAs on zero fill and writes nothing); the cluster syncs before
//   exit so no CTA leaves while its peer may still arrive on its barriers.
// - Epilogue in registers: after a tile's last chunk each thread folds its
//   two rows' 64 columns into a running (max, first index), columns past
//   Lr masked to -inf first (zero fill must never win a row whose scores
//   are all negative): a max over the 64 values, and only where it beats
//   the running best (strictly: tiles come in ascending order) a search
//   for its first column. At the end the four lanes of a quad merge, ties
//   to the smaller index, as the TPU kernel's ascending scan with a strict
//   '>' gives. (A fold that compared every value with the running best
//   cost a fifth of the kernel's time.)

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;
using namespace hopper;

namespace {

constexpr int TL = 128;                    // query positions per CTA
constexpr int TK = 256;                    // reference positions per tile
constexpr int DK = 64;                     // depth rows per chunk
constexpr int STAGES = 4;
constexpr int THREADS = 384;               // two consumer warpgroups + the producer
constexpr int BOX = 64 * 64 * 2;           // one 64 x 64 bf16 box, 128-byte rows
constexpr int A_BYTES = TL * DK * 2;
constexpr int B_BYTES = TK * DK * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr size_t SMEM = (size_t)STAGES * STAGE_BYTES + 16 * STAGES + 1024;

enum Mode { DMAJOR, ROWS };

struct Maps {
  CUtensorMap lr;    // [B][D][L] bf16, box 64 positions x 64 depth
  CUtensorMap ref;   // DMAJOR: [B][D][Lr], box 64 x 64; ROWS: [B][Lr][D], box 64 depth x 128
};

__device__ __forceinline__ bool better(float v, int q, float bv, int bq) {
  return v > bv || (v == bv && q < bq);
}

template <Mode MODE>
__global__ void __launch_bounds__(THREADS, 1) corr_unfold_kernel(
    const __grid_constant__ Maps maps, float* __restrict__ S, int* __restrict__ IDX,
    int D, int L, int Lr) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = ring + STAGES * STAGE_BYTES;
  auto full = [&](int i) { return bars + 8 * i; };
  auto empty = [&](int i) { return bars + 8 * (STAGES + i); };

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const uint32_t rank = cluster_rank();
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * TL;
  const int n_dc = (D + DK - 1) / DK;
  const int n_kt = (Lr + TK - 1) / TK;

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), 4);   // two consumer warpgroups in each CTA of the cluster
    }
    mbar_fence_init();
  }
  cluster_sync();

  if (warp >= 8) {
    // ---------------- producer: this CTA's query chunk, half the reference
    // chunk multicast to both CTAs
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      int st = 0;
      uint32_t ph = 0;
      const int k_half = rank * (TK / 2);
      for (int kt = 0; kt < n_kt; ++kt)
        for (int dc = 0; dc < n_dc; ++dc) {
          const int d0 = dc * DK;
          const int k0 = kt * TK + k_half;
          mbar_wait(empty(st), ph ^ 1);
          const uint32_t a_s = ring + st * STAGE_BYTES;
          const uint32_t b_s = a_s + A_BYTES + rank * (B_BYTES / 2);
          mbar_expect_tx(full(st), STAGE_BYTES);
          tma_load_3d(a_s, &maps.lr, full(st), i0, d0, b);
          tma_load_3d(a_s + BOX, &maps.lr, full(st), i0 + 64, d0, b);
          if constexpr (MODE == ROWS) {
            tma_load_3d_multicast(b_s, &maps.ref, full(st), 3, d0, k0, b);
          } else {
            tma_load_3d_multicast(b_s, &maps.ref, full(st), 3, k0, d0, b);
            tma_load_3d_multicast(b_s + BOX, &maps.ref, full(st), 3, k0 + 64, d0, b);
          }
          if (++st == STAGES) {
            st = 0;
            ph ^= 1;
          }
        }
    }
    cluster_sync();
    return;
  }

  // ---------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warp >> 2;      // query positions 64 wg .. 64 wg + 63 of the tile
  const int wq = warp & 3;
  const bool lead = (tid & 127) == 0;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  // running (max, index) of this thread's rows 16 wq + lane/4 (+ 8)
  float bv[2] = {-INFINITY, -INFINITY};
  int bq[2] = {0, 0};
  auto release = [&](int stage) {
    if (lead) {
      mbar_arrive_cluster(empty(stage), 0);
      mbar_arrive_cluster(empty(stage), 1);
    }
  };

  int st = 0, prev = -1;
  uint32_t ph = 0;
  for (int kt = 0; kt < n_kt; ++kt) {
    for (int dc = 0; dc < n_dc; ++dc) {
      mbar_wait(full(st), ph);
      const uint32_t a_s = ring + st * STAGE_BYTES + wg * BOX;
      const uint32_t b_s = ring + st * STAGE_BYTES + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        // A: MN-major, 16 depth rows = 2048 bytes a k16 step
        const uint64_t da = make_desc(a_s + kk * 2048, BOX, 1024, 1);
        if constexpr (MODE == ROWS) {
          // B: K-major [256 positions][64 depth], 32 bytes a k16 step
          const uint64_t db = make_desc(b_s + kk * 32, 16, 1024, 1);
          wgmma_ss256<1, 0>(acc, da, db, (dc | kk) != 0);
        } else {
          // B: MN-major, four 64-position boxes BOX bytes apart
          const uint64_t db = make_desc(b_s + kk * 2048, BOX, 1024, 1);
          wgmma_ss256<1, 1>(acc, da, db, (dc | kk) != 0);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();   // the previous chunk's MMAs have completed
      if (prev >= 0) release(prev);
      prev = st;
      if (++st == STAGES) {
        st = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs<128>(acc);
    release(prev);
    prev = -1;

    // acc[4j + 2h + e]: query 16 wq + lane/4 + 8h against reference
    // position kt * TK + 8j + 2(lane % 4) + e. Columns past Lr (zero fill)
    // go to -inf; then each row's maximum over this thread's 64 columns,
    // and only where it beats the running best, its first column.
    const int kb = kt * TK + 2 * (lane & 3);
    if (kt * TK + TK > Lr) {
#pragma unroll
      for (int j = 0; j < TK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (kb + 8 * j + e >= Lr) {
            acc[4 * j + e] = -INFINITY;
            acc[4 * j + 2 + e] = -INFINITY;
          }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m[4] = {acc[2 * h], acc[2 * h + 1], acc[4 + 2 * h], acc[4 + 2 * h + 1]};
#pragma unroll
      for (int j = 2; j < TK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          m[2 * (j & 1) + e] = fmaxf(m[2 * (j & 1) + e], acc[4 * j + 2 * h + e]);
      const float mx = fmaxf(fmaxf(m[0], m[1]), fmaxf(m[2], m[3]));
      if (mx > bv[h]) {   // strict: an earlier tile keeps a tie
        int q = 0;
#pragma unroll
        for (int j = TK / 8 - 1; j >= 0; --j)
#pragma unroll
          for (int e = 1; e >= 0; --e)
            if (acc[4 * j + 2 * h + e] == mx) q = kb + 8 * j + e;
        bv[h] = mx;
        bq[h] = q;
      }
    }
  }

  // the four lanes of a quad scanned disjoint reference columns
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv[h], o);
      const int oq = __shfl_xor_sync(0xffffffffu, bq[h], o);
      if (better(ov, oq, bv[h], bq[h])) {
        bv[h] = ov;
        bq[h] = oq;
      }
    }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + wg * 64 + wq * 16 + (lane >> 2) + 8 * h;
      if (i < L) {
        S[(size_t)b * L + i] = bv[h];
        IDX[(size_t)b * L + i] = bq[h];
      }
    }
  }
  cluster_sync();
}

// OUT[b, d, k] = bf16(REF[b, d, k] * bf16(INV[b, k])) (0 past Lr): one
// block a depth row (b, d), eight positions a thread; ldr % 8 == 0
__global__ void scale_kernel(const bf16* __restrict__ REF, const float* __restrict__ INV,
                             bf16* __restrict__ OUT, int D, int Lr, int ldr) {
  const size_t row = blockIdx.x;             // b * D + d
  const float* inv = INV + (size_t)(blockIdx.x / D) * Lr;
  const uint4* src = reinterpret_cast<const uint4*>(REF + row * ldr);
  uint4* dst = reinterpret_cast<uint4*>(OUT + row * ldr);
  for (int v = threadIdx.x; v < ldr / 8; v += blockDim.x) {
    const uint4 x = src[v];
    uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int k = 8 * v + 2 * p;
      const __nv_bfloat162 s = __halves2bfloat162(
          __float2bfloat16_rn(k < Lr ? inv[k] : 0.0f),
          __float2bfloat16_rn(k + 1 < Lr ? inv[k + 1] : 0.0f));
      __nv_bfloat162 h;
      memcpy(&h, &w[p], 4);
      const __nv_bfloat162 r = __hmul2(h, s);
      memcpy(&w[p], &r, 4);
    }
    dst[v] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <Mode MODE>
cudaError_t launch(const Maps& maps, void* S, void* IDX, int B, int D, int L, int Lr,
                   cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      corr_unfold_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  const int n_qt = (L + TL - 1) / TL;
  cfg.gridDim = dim3((n_qt + 1) / 2 * 2, B);   // whole clusters
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, corr_unfold_kernel<MODE>, maps, static_cast<float*>(S),
                         static_cast<int*>(IDX), D, L, Lr);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// K5 / K6. LR [B, D, ldl] bf16 (positions >= L are padding), REF [B, D, ldr]
// bf16 (positions >= Lr are padding, never read), INV [B, Lr] f32 or null
// (no scale: K6), SCRATCH [B, D, ldr] bf16 (K5 only: the scaled reference)
// -> S [B, L] f32, IDX [B, L] int32. ldl and ldr must be multiples of 8
// (16-byte rows for TMA).
extern "C" int speinet_corr_unfold(const void* LR, const void* REF, const void* INV,
                                   void* SCRATCH, void* S, void* IDX, int B, int D, int L,
                                   int ldl, int Lr, int ldr, void* stream) {
  if (B < 1 || B > 65535 || D < 1 || L < 1 || Lr < 1 || ldl < L || ldr < Lr
      || ldl % 8 != 0 || ldr % 8 != 0 || (INV != nullptr && SCRATCH == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* ref = REF;
  if (INV != nullptr) {
    if ((long long)B * D > 0x7fffffff) return cudaErrorInvalidValue;
    scale_kernel<<<B * D, 256, 0, s>>>(static_cast<const bf16*>(REF),
                                       static_cast<const float*>(INV),
                                       static_cast<bf16*>(SCRATCH), D, Lr, ldr);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    ref = SCRATCH;
  }
  Maps maps;
  if (!encode3(&maps.lr, LR, L, D, B, (uint64_t)ldl * 2, (uint64_t)D * ldl * 2, 64, 64)
      || !encode3(&maps.ref, ref, Lr, D, B, (uint64_t)ldr * 2, (uint64_t)D * ldr * 2, 64, 64))
    return cudaErrorInvalidValue;
  return launch<DMAJOR>(maps, S, IDX, B, D, L, Lr, s);
}

// K7. LR [B, D, ldl] bf16 as above, REF [B, Lr, D] bf16 (position-major)
// -> S [B, L] f32, IDX [B, L] int32. ldl and D must be multiples of 8.
extern "C" int speinet_corr_rows(const void* LR, const void* REF, void* S, void* IDX,
                                 int B, int D, int L, int ldl, int Lr, void* stream) {
  if (B < 1 || B > 65535 || D < 8 || D % 8 != 0 || L < 1 || Lr < 1 || ldl < L
      || ldl % 8 != 0)
    return cudaErrorInvalidValue;
  Maps maps;
  if (!encode3(&maps.lr, LR, L, D, B, (uint64_t)ldl * 2, (uint64_t)D * ldl * 2, 64, 64)
      || !encode3(&maps.ref, REF, D, Lr, B, (uint64_t)D * 2, (uint64_t)Lr * D * 2, 64, 128))
    return cudaErrorInvalidValue;
  return launch<ROWS>(maps, S, IDX, B, D, L, Lr, static_cast<cudaStream_t>(stream));
}
