// K4: 3x3-patch correlation with a running max / argmax over the whole
// reference map, never materializing the [L, Lr] score matrix.
//
// Replaces speinet_tpu/ops/pallas_corr.py::banded_corr_argmax (pallas_call
// at :526 in _corr_impl_banded :493, body _corr_kernel_banded :422):
//     R[p, q] = sum_{o in 3x3} <F[p + o], G[q + o]>      (zero padding)
//     S[p]    = max_q inv[q] * R[p, q],   idx[p] = first q attaining it
// with idx row-major over the reference's Hr x Wr grid (Hr, Wr may differ
// from H, W: the 'self' reference is the transposed map). The caller scales
// S by the query-side inverse norms afterwards.
//
// Bound on the H100: operations. At 720p lv3 (L = Lr = 57,600, C = 128) the
// product is 2*9*L*Lr*C = 7.6 TFLOP per sample in this direct form (2.55
// TFLOP in the TPU kernel's 3-row-shift + diagonal-add form) against a few
// MB of input. Design: a CTA owns a query tile of 8 x 16 positions and keeps
// its 10 x 18 halo (all C channels) in shared memory for the whole run; it
// walks every 8 x 16 reference tile in ascending order, stages that tile's
// halo, and contracts the nine shifted views of both halos on tensor cores
// (mma.sync m16n8k16 bf16, f32 accumulation: K = 9 offsets x C, read in
// place from the halos, so no unfold is built). Operands come in by
// ldmatrix, which needs only 16-byte alignment, so halo pixel rows are
// padded to C + 8 elements: the eight 16-byte rows of every 8 x 8 matrix
// then fall on eight different bank groups, with no conflict. Each warp
// holds a 32 x 64 block of scores in registers, scales it by inv[q], and
// folds it into a per-query running (max, index); ties break to the smaller
// index, so the result is the first maximum in row-major order, the same as
// the ascending scan with a strict '>' of the TPU kernel. No cross-CTA
// reduction is needed. The diagonal-add form, wgmma and double-buffered
// reference halos are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TR = 8;             // tile rows
constexpr int TC = 16;            // tile cols (one m16 tile of positions)
constexpr int HR = TR + 2;
constexpr int HC = TC + 2;
constexpr int HP = HR * HC;       // halo pixels
constexpr int THREADS = 256;

__device__ __forceinline__ void load_halo(bf16* dst, const bf16* src, int H,
                                          int W, int C, int ldh, int r0,
                                          int c0) {
  const int c8 = C / 8;
  for (int u = threadIdx.x; u < HP * c8; u += THREADS) {
    const int px = u / c8;
    const int cc = (u - px * c8) * 8;
    const int r = r0 - 1 + px / HC;
    const int c = c0 - 1 + px % HC;
    bf16* d = dst + (size_t)px * ldh + cc;
    if (r >= 0 && r < H && c >= 0 && c < W)   // asynchronous 16-byte copy
      __pipeline_memcpy_async(d, src + ((size_t)r * W + c) * C + cc, 16);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

__device__ __forceinline__ bool better(float v, int q, float bv, int bq) {
  return v > bv || (v == bv && q < bq);
}

__global__ void __launch_bounds__(THREADS, 2) corr_kernel(
    const bf16* __restrict__ F, const bf16* __restrict__ G,
    const float* __restrict__ inv, float* __restrict__ S,
    int* __restrict__ IDX, int H, int W, int Hr, int Wr, int C, int n_tc_q,
    int n_tr_r, int n_tc_r) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldh = C + 8;
  bf16* fq = reinterpret_cast<bf16*>(smem);                 // [HP][ldh] query halo
  bf16* gr = fq + (size_t)HP * ldh;                         // [HP][ldh] reference halo
  float* inv_s = reinterpret_cast<float*>(gr + (size_t)HP * ldh);  // [TR*TC]
  int* qid_s = reinterpret_cast<int*>(inv_s + TR * TC);     // [TR*TC], -1 off the map
  float* comb_v = reinterpret_cast<float*>(qid_s + TR * TC);
  int* comb_q = reinterpret_cast<int*>(comb_v + TR * TC);

  const int b = blockIdx.y;
  const int qr0 = (blockIdx.x / n_tc_q) * TR;
  const int qc0 = (blockIdx.x % n_tc_q) * TC;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wq = warp >> 1;   // query tile rows 2wq, 2wq+1 (one m16 tile each)
  const int wr = warp & 1;    // reference tile rows 4wr .. 4wr+3 (two n8 tiles each)
  const bf16* Fb = F + (size_t)b * H * W * C;
  const bf16* Gb = G + (size_t)b * Hr * Wr * C;
  const float* invb = inv + (size_t)b * Hr * Wr;

  load_halo(fq, Fb, H, W, C, ldh, qr0, qc0);

  // this lane's ldmatrix row within a 16 x 16 operand tile, and its column
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * 8;
  const uint32_t fq_s = static_cast<uint32_t>(__cvta_generic_to_shared(fq));
  const uint32_t gr_s = static_cast<uint32_t>(__cvta_generic_to_shared(gr));

  // running (max, index) of query positions lane/4 and lane/4 + 8 of query
  // tile rows 2wq and 2wq+1, over the reference columns this lane holds
  float best_v[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
  int best_q[2][2] = {{0, 0}, {0, 0}};

  const int n_rt = n_tr_r * n_tc_r;
  for (int rt = 0; rt < n_rt; ++rt) {
    const int rr0 = (rt / n_tc_r) * TR;
    const int rc0 = (rt % n_tc_r) * TC;
    __syncthreads();   // the previous reference tile is fully consumed
    load_halo(gr, Gb, Hr, Wr, C, ldh, rr0, rc0);
    if (tid < TR * TC) {
      const int r = rr0 + tid / TC;
      const int c = rc0 + tid % TC;
      const bool ok = r < Hr && c < Wr;
      inv_s[tid] = ok ? invb[r * Wr + c] : 0.0f;
      qid_s[tid] = ok ? r * Wr + c : -1;
    }
    __syncthreads();

    float acc[2][8][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

    for (int dy = 0; dy < 3; ++dy) {
      for (int dx = 0; dx < 3; ++dx) {
        uint32_t abase[2], bbase[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          abase[i] = fq_s + (uint32_t)((((2 * wq + i + dy) * HC + dx + a_row) * ldh
                                        + a_col) * 2);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bbase[j] = gr_s + (uint32_t)((((4 * wr + j + dy) * HC + dx + b_row) * ldh
                                        + b_col) * 2);
        for (int c0 = 0; c0 < C; c0 += 16) {
          uint32_t a[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i) ldmatrix_x4(a[i], abase[i] + c0 * 2);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            // positions 0-7 / 8-15 of reference row 4wr+j, channels lo / hi
            uint32_t bm[4];
            ldmatrix_x4(bm, bbase[j] + c0 * 2);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              mma_bf16(acc[i][2 * j], a[i], bm[0], bm[1]);
              mma_bf16(acc[i][2 * j + 1], a[i], bm[2], bm[3]);
            }
          }
        }
      }
    }

    // acc[i][n][2h + e]: query position lane/4 + 8h of query row 2wq+i
    // against reference position 8(n%2) + 2(lane%4) + e of reference row
    // 4wr + n/2
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int pos = (4 * wr + n / 2) * TC + (n % 2) * 8 + 2 * (lane & 3) + e;
        const int q = qid_s[pos];
        if (q >= 0) {
          const float sc = inv_s[pos];
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float v = acc[i][n][2 * h + e] * sc;
              if (better(v, q, best_v[i][h], best_q[i][h])) {
                best_v[i][h] = v;
                best_q[i][h] = q;
              }
            }
        }
      }
    }
  }

  // the four lanes of a quad scanned disjoint reference columns
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best_v[i][h], o);
        const int oq = __shfl_xor_sync(0xffffffffu, best_q[i][h], o);
        if (better(ov, oq, best_v[i][h], best_q[i][h])) {
          best_v[i][h] = ov;
          best_q[i][h] = oq;
        }
      }
  // the two warps of a query row pair scanned disjoint reference rows
  const bool lead = (lane & 3) == 0;
  __syncthreads();
  if (wr == 1 && lead) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int slot = (2 * wq + i) * TC + (lane >> 2) + 8 * h;
        comb_v[slot] = best_v[i][h];
        comb_q[slot] = best_q[i][h];
      }
  }
  __syncthreads();
  if (wr == 0 && lead) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int slot = (2 * wq + i) * TC + (lane >> 2) + 8 * h;
        float v = best_v[i][h];
        int q = best_q[i][h];
        if (better(comb_v[slot], comb_q[slot], v, q)) {
          v = comb_v[slot];
          q = comb_q[slot];
        }
        const int pr = qr0 + 2 * wq + i;
        const int pc = qc0 + (lane >> 2) + 8 * h;
        if (pr < H && pc < W) {
          S[(size_t)b * H * W + pr * W + pc] = v;
          IDX[(size_t)b * H * W + pr * W + pc] = q;
        }
      }
  }
}

}  // namespace

// F [B, H, W, C] bf16 query map, G [B, Hr, Wr, C] bf16 reference map,
// inv [B, Hr*Wr] f32 -> S [B, H*W] f32, IDX [B, H*W] int32.
extern "C" int speinet_banded_corr(const void* F, const void* G,
                                   const void* inv, void* S, void* IDX, int B,
                                   int H, int W, int Hr, int Wr, int C,
                                   void* stream) {
  if (C % 16 != 0 || C < 16 || C > 256 || H < 1 || W < 1 || Hr < 1 || Wr < 1)
    return cudaErrorInvalidValue;
  const int n_tr_q = (H + TR - 1) / TR;
  const int n_tc_q = (W + TC - 1) / TC;
  const int n_tr_r = (Hr + TR - 1) / TR;
  const int n_tc_r = (Wr + TC - 1) / TC;
  const size_t smem = 2 * (size_t)HP * (C + 8) * sizeof(bf16)
                      + 4 * TR * TC * sizeof(float);
  if (B > 65535) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      corr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(n_tr_q * n_tc_q, B);
  corr_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(F), static_cast<const bf16*>(G),
      static_cast<const float*>(inv), static_cast<float*>(S),
      static_cast<int*>(IDX), H, W, Hr, Wr, C, n_tc_q, n_tr_r, n_tc_r);
  return cudaGetLastError();
}
