// K4: 3x3-patch correlation with a running max / argmax over the whole
// reference map, in the banded form, never materializing the [L, Lr]
// score matrix.
//
// Replaces speinet_tpu/ops/pallas_corr.py::banded_corr_argmax (pallas_call
// at :526 in _corr_impl_banded :493, body _corr_kernel_banded :422):
//     R[p, q] = sum_{o in 3x3} <F[p + o], G[q + o]>      (zero padding)
//     S[p]    = max_q inv[q] * R[p, q],   idx[p] = first q attaining it
// with idx row-major over the reference's Hr x Wr grid (Hr, Wr may differ
// from H, W: the 'self' reference is the transposed map). The caller scales
// S by the query-side inverse norms afterwards.
//
// The banded form (as the TPU kernel). Each map comes padded by the wrapper
// (kernels/corr.py::banded_layout) with one zero row above and below and
// one zero column on the right, flattened to [B, positions, C]: pixel
// (r, c) of an H x W map sits at flat index (r + 1)(W + 1) + c, and its
// neighbour at offset (dy - 1, dx - 1) at that index + (dy - 1)(W + 1) +
// dx - 1, since the pad column absorbs a shift past either end of a row.
// Number query positions p = r(W + 1) + c over [0, H(W + 1)) and reference
// positions q = r(Wr + 1) + c alike; for tiles starting at p0 and q0 let
//     Csum[i, j] = sum_dy <Fpad[p0 + i + dy(W+1) - 1], Gpad[q0 + j + dy(Wr+1) - 1]>
// then R[p0 + i, q0 + j] = Csum[i, j] + Csum[i+1, j+1] + Csum[i+2, j+2]:
// three C-deep products per tile pair and three diagonal adds. The pad
// column's positions and those past the map are masked out of the
// reference and cropped from the query.
//
// Bound on the H100: operations. At 720p lv3 (L = Lr = 57,600, C = 128)
// the products are 2*3*L*Lr*C = 2.55 TFLOP per sample against 15 MB of
// padded maps.
//
// Design (K5-K7's skeleton: wgmma fed by TMA, warp-specialised, clusters
// of two CTAs):
// - A CTA owns 112 query positions and walks every reference tile of 256
//   positions (254 apart, the last two columns being the next tile's
//   diagonal halo) in ascending order. Warps 0-7 are two consumer
//   warpgroups, each holding a 64 x 256 f32 tile of Csum (wgmma m64n256k16,
//   setmaxnreg 232); warps 8-11 are the producer warpgroup (setmaxnreg 40),
//   whose first warp issues the TMA loads, one box per lane and stage.
// - Each consumer warp owns 16 A rows, query positions P .. P + 15 with
//   P = p0 + 14 * warp: rows 14 and 15 are only the diagonal halo of its 14
//   outputs, so no data crosses warps. TMA writes the warp's even positions
//   into its first 8 rows and its odd ones into the next 8, through two
//   tensor maps of 2-position pitch (one based a position later): a lane's
//   accumulator rows g and g + 8 are then positions 2g and 2g + 1, and
//   every output needs only its own lane and lane + 4 (positions 2g + 2,
//   2g + 3). This is why the wrapper pads each map to an even length.
// - Operands per (dy, 64-channel chunk), one stage of a 4-stage ring: the
//   CTA's query rows (16 boxes of 8 rows, 16 KB) and the reference slab
//   [256 positions][64 channels] (32 KB), K-major and 128-byte swizzled.
//   Full / empty mbarriers; the two CTAs of a cluster take query tiles 2j
//   and 2j + 1 of a sample, and each loads half of every reference slab and
//   multicasts it to both (K5-K7's release rules). Out-of-map rows and
//   channels past C are TMA's zero fill.
// - Each reference tile's scale and validity come in as one 2 KB bulk copy
//   of (inv, additive mask) pairs, [256][2] f32 built by the wrapper
//   (kernels/corr.py::banded_aux; the mask is -inf on the pad column, past
//   the map and on the two halo columns), in a ring of two slots of its own.
// - Epilogue in registers, per lane (rows 2g, 2g + 1 as C0, C1; columns 8J
//   + 2(lane % 4) + e): U = C0 + C1 one column on; R0 = U + (C0 of lane +
//   4) two columns on; R1 = C1 + (U of lane + 4) one column on. A column
//   shift stays in the lane (e = 0 -> 1) or reads lane + 1 of the quad,
//   the quad's lane 0 serving lane 3 from the next column group (a select
//   on the source side): five shuffles per 8 columns, streamed over J in
//   place. Then v = R * inv + mask and K5-K7's fold: a max over the lane's
//   64 columns, a search for its first column only where it beats the
//   running best (strictly: tiles come in ascending order), and at the end
//   a merge over the quad, ties to the smaller index. Ascending flat
//   positions are ascending row-major ones, so this is the first maximum
//   in row-major order, as the TPU kernel's scan with a strict '>' gives.
// - The outputs skip the query's pad column and map idx back to
//   row-major Hr x Wr.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int QW = 14;                     // outputs per warp (of its 16 A rows)
constexpr int TQ = 8 * QW;                 // query positions per CTA
constexpr int TK = 256;                    // reference positions per tile
constexpr int TKV = TK - 2;                // tile stride: outputs per tile
constexpr int DK = 64;                     // channels per chunk
constexpr int THREADS = 384;               // two consumer warpgroups + the producer
constexpr int ROWS8 = 8 * DK * 2;          // one 8-row box, 1024 bytes
constexpr int A_BYTES = 16 * ROWS8;        // a chunk's query rows: 8 warps x 16
constexpr int B_BYTES = TK * DK * 2;       // a chunk's reference slab
constexpr int AUX_BYTES = TK * 2 * 4;      // (inv, mask) per tile column
constexpr int STAGES = 4;
constexpr int STAGE_BYTES = B_BYTES + A_BYTES;   // reference slab, then query rows
constexpr int BARS = 2 * STAGES + 2 + 2;   // full, empty, aux full / empty
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
constexpr size_t SMEM = (size_t)RING_BYTES + 2 * AUX_BYTES + 8 * BARS + 1024;
constexpr unsigned FULL = 0xffffffffu;

struct Maps {
  CUtensorMap q_even;   // query positions 2k:     [B][Lq/2][C], box 64 ch x 8
  CUtensorMap q_odd;    // query positions 2k + 1: [B][Lq/2][C], box 64 ch x 8
  CUtensorMap ref;      // [B][Lr][C], box 64 ch x 128
};

__device__ __forceinline__ bool better(float v, int q, float bv, int bq) {
  return v > bv || (v == bv && q < bq);
}

__device__ __forceinline__ float4 lds4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr));
  return v;
}

// U[J] = C0 + C1 one column on, at column pair J of this lane (rows 2g,
// 2g + 1 are acc[4J + e], acc[4J + 2 + e])
__device__ __forceinline__ void u_pair(const float* acc, int J, bool wrap, int right,
                                       float* u) {
  const int jn = J < 31 ? J + 1 : J;
  const float c1 = __shfl_sync(FULL, wrap ? acc[4 * jn + 2] : acc[4 * J + 2], right);
  u[0] = acc[4 * J] + acc[4 * J + 3];
  u[1] = acc[4 * J + 1] + c1;
}

// Csum -> R in place: R[2g + h, c] = Csum[2g + h, c] + Csum[2g + h + 1, c + 1]
// + Csum[2g + h + 2, c + 2]. Rows of lanes 28-31 (the halo) and columns 254,
// 255 come out as garbage; the caller never uses them.
__device__ __forceinline__ void diagonal_adds(float* acc, int lane) {
  const int t4 = lane & 3;
  const bool wrap = t4 == 0;   // as a source, serves lane 3 of the quad one group on
  const int right = (lane & ~3) | ((t4 + 1) & 3);
  const int below = (lane + 4) & 31;
  const int below_right = (below & ~3) | ((t4 + 1) & 3);
  float u[2], un[2];
  u_pair(acc, 0, wrap, right, u);
#pragma unroll
  for (int J = 0; J < 32; ++J) {
    const int jn = J < 31 ? J + 1 : J;
    if (J < 31) {
      u_pair(acc, J + 1, wrap, right, un);
    } else {
      un[0] = u[0];
      un[1] = u[1];
    }
    const float d0 = __shfl_sync(FULL, wrap ? acc[4 * jn] : acc[4 * J], below_right);
    const float d1 = __shfl_sync(FULL, wrap ? acc[4 * jn + 1] : acc[4 * J + 1], below_right);
    const float v0 = __shfl_sync(FULL, u[1], below);
    const float v1 = __shfl_sync(FULL, wrap ? un[0] : u[0], below_right);
    acc[4 * J] = u[0] + d0;
    acc[4 * J + 1] = u[1] + d1;
    acc[4 * J + 2] += v0;
    acc[4 * J + 3] += v1;
    u[0] = un[0];
    u[1] = un[1];
  }
}

__global__ void __launch_bounds__(THREADS, 1) banded_corr_kernel(
    const __grid_constant__ Maps maps, const float* __restrict__ AUX, float* __restrict__ S,
    int* __restrict__ IDX, int H, int W, int Wr, int n_cc, int n_kt) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t aux_s = ring + RING_BYTES;
  const uint32_t bars = aux_s + 2 * AUX_BYTES;
  auto full = [&](int i) { return bars + 8 * i; };
  auto empty = [&](int i) { return bars + 8 * (STAGES + i); };
  auto aux_full = [&](int i) { return bars + 8 * (2 * STAGES + i); };
  auto aux_empty = [&](int i) { return bars + 8 * (2 * STAGES + 2 + i); };

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const uint32_t rank = cluster_rank();
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * TQ;
  const int wq = W + 1;
  const int wrq = Wr + 1;
  const int n_chunks = 3 * n_cc;

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), 4);   // two consumer warpgroups in each CTA of the cluster
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(aux_full(i), 1);
      mbar_init(aux_empty(i), 8);   // every consumer warp of this CTA
    }
    mbar_fence_init();
  }
  cluster_sync();

  if (warp >= 8) {
    // ---------------- producer warp 8: lane i < 16 loads warp i / 2's even
    // (i % 2 = 0) or odd query rows, lane 16 this CTA's half of the
    // reference slab (multicast to both CTAs), lane 17 each tile's (inv,
    // mask) row; one TMA per lane keeps issue off the critical path
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 8) {
      const int row_off = QW * (lane >> 1) + (lane & 1) - 1;
      int st = 0;
      uint32_t ph = 0;
      for (int kt = 0; kt < n_kt; ++kt) {
        if (lane == 17) {
          const int slot = kt & 1;
          mbar_wait(aux_empty(slot), ((kt >> 1) & 1) ^ 1);
          mbar_expect_tx(aux_full(slot), AUX_BYTES);
          bulk_load(aux_s + slot * AUX_BYTES, AUX + ((size_t)b * n_kt + kt) * TK * 2,
                    AUX_BYTES, aux_full(slot));
        }
        for (int dy = 0; dy < 3; ++dy)
          for (int cc = 0; cc < n_cc; ++cc) {
            mbar_wait(empty(st), ph ^ 1);
            const uint32_t stage = ring + st * STAGE_BYTES;
            if (lane == 0) mbar_expect_tx(full(st), STAGE_BYTES);
            if (lane < 16) {
              const int pos = p0 + dy * wq + row_off;
              tma_load_3d(stage + B_BYTES + lane * ROWS8,
                          (pos & 1) ? &maps.q_odd : &maps.q_even, full(st), cc * DK,
                          pos >> 1, b);
            } else if (lane == 16) {
              tma_load_3d_multicast(stage + rank * (B_BYTES / 2), &maps.ref, full(st), 3,
                                    cc * DK, kt * TKV + rank * (TK / 2) + dy * wrq - 1, b);
            }
            if (++st == STAGES) {
              st = 0;
              ph ^= 1;
            }
          }
      }
    }
    cluster_sync();
    return;
  }

  // ---------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warp >> 2;
  const int t4 = lane & 3;
  const bool lead = (tid & 127) == 0;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  // running (max, padded-flat index) of this lane's rows 2g and 2g + 1
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
    for (int ch = 0; ch < n_chunks; ++ch) {
      mbar_wait(full(st), ph);
      const uint32_t b_s = ring + st * STAGE_BYTES;
      const uint32_t a_s = b_s + B_BYTES + wg * (A_BYTES / 2);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        // both K-major [rows][64 channels], 32 bytes a k16 step
        const uint64_t da = make_desc(a_s + kk * 32, 16, 1024, 1);
        const uint64_t db = make_desc(b_s + kk * 32, 16, 1024, 1);
        wgmma_ss256<0, 0>(acc, da, db, (ch | kk) != 0);
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

    diagonal_adds(acc, lane);
    // v = R * inv + mask, columns 8J + 2 t4 + e of reference tile kt
    const int slot = kt & 1;
    mbar_wait(aux_full(slot), (kt >> 1) & 1);
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
      const float4 a = lds4(aux_s + slot * AUX_BYTES + (8 * j + 2 * t4) * 8);
      acc[4 * j] = fmaf(acc[4 * j], a.x, a.y);
      acc[4 * j + 1] = fmaf(acc[4 * j + 1], a.z, a.w);
      acc[4 * j + 2] = fmaf(acc[4 * j + 2], a.x, a.y);
      acc[4 * j + 3] = fmaf(acc[4 * j + 3], a.z, a.w);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(aux_empty(slot));

    const int kb = kt * TKV + 2 * t4;
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
      const float ov = __shfl_xor_sync(FULL, bv[h], o);
      const int oq = __shfl_xor_sync(FULL, bq[h], o);
      if (better(ov, oq, bv[h], bq[h])) {
        bv[h] = ov;
        bq[h] = oq;
      }
    }
  const int g = lane >> 2;
  if (t4 == 0 && g < QW / 2) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + QW * warp + 2 * g + h;
      const int r = p / wq;
      const int c = p - r * wq;
      if (r < H && c < W) {
        const size_t o = (size_t)b * H * W + (size_t)r * W + c;
        const int qr = bq[h] / wrq;
        S[o] = bv[h];
        IDX[o] = qr * Wr + (bq[h] - qr * wrq);
      }
    }
  }
  cluster_sync();
}

}  // namespace

// FP [B, Lq, C] and GP [B, Lr, C] bf16: the query and reference maps as
// kernels/corr.py::banded_layout pads them (Lq = (H + 2)(W + 1), or
// (H + 3)(W + 1) where that is odd; Lr likewise from Hr, Wr); AUX [B, n_kt, 256, 2] f32 from
// kernels/corr.py::banded_aux -> S [B, H*W] f32, IDX [B, H*W] int32
// (row-major over Hr x Wr).
extern "C" int speinet_banded_corr(const void* FP, const void* GP, const void* AUX, void* S,
                                   void* IDX, int B, int H, int W, int Hr, int Wr, int C,
                                   int n_kt, void* stream) {
  if (B < 1 || B > 65535 || C < 16 || C > 256 || C % 16 != 0 || H < 1 || W < 1 || Hr < 1
      || Wr < 1)
    return cudaErrorInvalidValue;
  auto padded = [](long long h, long long w) {   // a second zero row below if odd
    return (h + 2 + ((h + 2) * (w + 1) & 1)) * (w + 1);
  };
  const long long lq = padded(H, W), lr = padded(Hr, Wr);
  const long long lk = (long long)Hr * (Wr + 1);
  if (lq > 0x3fffffff || lr > 0x3fffffff || n_kt != (lk + TKV - 1) / TKV)
    return cudaErrorInvalidValue;
  Maps maps;
  const char* fp = static_cast<const char*>(FP);
  const uint64_t row = 2ull * C;
  if (!encode3(&maps.q_even, fp, C, lq / 2, B, 2 * row, lq * row, DK, 8)
      || !encode3(&maps.q_odd, fp + row, C, lq / 2, B, 2 * row, lq * row, DK, 8)
      || !encode3(&maps.ref, GP, C, lr, B, row, lr * row, DK, TK / 2))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      banded_corr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  const long long n_qt = ((long long)H * (W + 1) + TQ - 1) / TQ;
  cfg.gridDim = dim3((unsigned)((n_qt + 1) / 2 * 2), B);   // whole clusters
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, banded_corr_kernel, maps, static_cast<const float*>(AUX),
                         static_cast<float*>(S), static_cast<int*>(IDX), H, W, Wr,
                         (C + DK - 1) / DK, n_kt);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}
