// K1: NHWC 2-D convolution with odd k, stride 1 or 2, SAME padding (k/2),
// bf16 operands, f32 accumulation, f32 bias and optional ReLU fused into
// the epilogue.
//
// Replaces speinet_tpu/ops/pallas_conv.py::conv2d_mxu (pallas_call at :93,
// body _conv_kernel :28), which is stride-1 only and reaches the encoder's
// stride-2 convs through the space-to-depth rewrite of ops/s2d.py. That
// rewrite only fills the TPU's 128 lanes; this kernel takes stride 2
// directly, so the port has no s2d layer.
//
// Bound on the H100: operations. A 5x5 32->32 conv at 720x1280 is 47 GFLOP
// against 59 MB of input and output (0.05 ms of bf16 tensor-core time vs
// 0.035 ms of memory time), and the 64/128-channel convs are further above
// the ridge. Design: implicit GEMM on tensor cores (mma.sync m16n8k16 bf16,
// f32 accumulation). A CTA owns a run of consecutive output pixels of one
// output row (256 pixels x 32 output channels, or 128 x 64) and each of its
// 8 warps a 32-pixel x 32-channel block of accumulators in registers. For
// each kernel row the CTA stages, by asynchronous copies, the input row
// segment (all input channels, zero at the image border and in the pad to a
// multiple of 16 channels) and the k weight taps of that row (in
// input-channel chunks where the taps would not fit beside the row); every
// (kx, 16-channel) step then reads its operands by ldmatrix (the weights
// transposed) straight out of the staged row, so no im2col buffer is built.
// Staged rows are C + 8 and TN + 8 elements apart, so the eight 16-byte rows
// of every 8 x 8 matrix fall on eight different bank groups; at stride 2 the
// input row is stored as its even pixels, then its odd ones, so the pixels
// one fragment reads are adjacent there too. Inputs are read k times per
// output row (once per kernel row); the rest of the reuse comes from L2.
// wgmma, TMA and a multi-stage pipeline are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <stdint.h>

#include "tensor_core.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr size_t SMEM_BUDGET = 110 * 1024;   // two CTAs per SM

inline size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

union Pack8 {
  uint4 u;
  uint16_t h[8];
};

// TN output channels per CTA: warps form a (WARPS / WN) x WN grid of
// 32-pixel x (16 * NF)-channel blocks
template <int TN>
struct Tile {
  static constexpr int NF = TN >= 32 ? 2 : 1;        // 16-channel fragments per warp
  static constexpr int WN = TN / (16 * NF);          // warps along channels
  static constexpr int WM = WARPS / WN;              // warps along pixels
  static constexpr int TM = WM * 32;                 // output pixels per CTA
  static constexpr int LDW = TN + 8;                 // padded weight rows
};

template <int TN>
__global__ void __launch_bounds__(THREADS) conv_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w,
    const float* __restrict__ bias, bf16* __restrict__ out, int H, int W,
    int Cin, int cinp, int ck, int Ho, int Wo, int Co, int k, int stride,
    int pad, int relu, int n_co_tiles, int lds, int seg_bytes) {
  typedef Tile<TN> T;
  extern __shared__ __align__(128) unsigned char smem[];
  const int seg_w = (T::TM - 1) * stride + k;
  // staged row of input column `col`: in order at stride 1; even columns
  // first, then odd ones, at stride 2
  const int odd0 = stride == 2 ? (seg_w + 1) / 2 : 0;
  bf16* seg = reinterpret_cast<bf16*>(smem);                // [seg_w][lds]
  bf16* wsl = reinterpret_cast<bf16*>(smem + seg_bytes);    // [k][ck][LDW]
  float* stage = reinterpret_cast<float*>(smem);            // [TM][TN], after the loop
  const uint32_t seg_s = static_cast<uint32_t>(__cvta_generic_to_shared(seg));
  const uint32_t wsl_s = static_cast<uint32_t>(__cvta_generic_to_shared(wsl));

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp / T::WN;
  const int wn = warp % T::WN;
  const int ox0 = blockIdx.x * T::TM;
  const int oy = blockIdx.y;
  const int b = blockIdx.z / n_co_tiles;
  const int co0 = (blockIdx.z - b * n_co_tiles) * TN;
  const int ix0 = ox0 * stride - pad;
  const bool vec_in = (Cin % 8) == 0;
  const int c8n = cinp / 8;
  constexpr int n8 = TN / 8;
  // this lane's ldmatrix row and column within a 16 x 16 operand tile
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_col = (lane >> 4) * 8;

  // acc[i][n]: pixels wm*32 + 16i .. +15 x channels wn*16*NF + 8n .. +7
  float acc[2][2 * T::NF][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 2 * T::NF; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.0f;

  for (int ky = 0; ky < k; ++ky) {
    const int iy = oy * stride - pad + ky;
    const bool row_ok = iy >= 0 && iy < H;
    __syncthreads();   // the previous kernel row is consumed
    for (int u = tid; u < seg_w * c8n; u += THREADS) {
      const int col = u / c8n;
      const int c = (u - col * c8n) * 8;
      const int ix = ix0 + col;
      const int srow = stride == 2 ? (col & 1) * odd0 + (col >> 1) : col;
      bf16* dst = seg + (size_t)srow * lds + c;
      const bool inside = row_ok && ix >= 0 && ix < W && c < Cin;
      const bf16* src = x + (((size_t)b * H + iy) * W + ix) * Cin + c;
      if (inside && vec_in) {
        __pipeline_memcpy_async(dst, src, 16);
      } else {
        Pack8 v;
        v.u = make_uint4(0, 0, 0, 0);
        if (inside) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (c + i < Cin) v.h[i] = reinterpret_cast<const uint16_t*>(src)[i];
        }
        *reinterpret_cast<uint4*>(dst) = v.u;
      }
    }
    for (int cc0 = 0; cc0 < cinp; cc0 += ck) {
      if (cc0 > 0) __syncthreads();   // the previous weight chunk is consumed
      for (int u = tid; u < k * ck * n8; u += THREADS) {
        const int n = (u % n8) * 8;
        const int rest = u / n8;
        const int c = rest % ck;
        const int kx = rest / ck;
        bf16* dst = wsl + ((size_t)kx * ck + c) * T::LDW + n;
        if (cc0 + c < Cin)
          __pipeline_memcpy_async(
              dst, w + ((size_t)(ky * k + kx) * Cin + cc0 + c) * Co + co0 + n, 16);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncthreads();
      for (int kx = 0; kx < k; ++kx) {
        // staged row of output pixel p's tap kx: row0 + p
        const int row0 = stride == 2 ? (kx & 1) * odd0 + (kx >> 1) : kx;
        uint32_t abase[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          abase[i] = seg_s + (uint32_t)(((row0 + wm * 32 + i * 16 + a_row) * lds
                                         + cc0 + a_col) * 2);
        const uint32_t bbase = wsl_s + (uint32_t)((((size_t)kx * ck + b_row) * T::LDW
                                                   + wn * 16 * T::NF + b_col) * 2);
        for (int c0 = 0; c0 < ck; c0 += 16) {
          uint32_t a[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i) ldmatrix_x4(a[i], abase[i] + c0 * 2);
#pragma unroll
          for (int j = 0; j < T::NF; ++j) {
            // channels 16j .. +7 / +8 .. +15 of this warp's block, rows lo / hi
            uint32_t bm[4];
            ldmatrix_x4_trans(bm, bbase + (uint32_t)((c0 * T::LDW + j * 16) * 2));
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              mma_bf16(acc[i][2 * j], a[i], bm[0], bm[1]);
              mma_bf16(acc[i][2 * j + 1], a[i], bm[2], bm[3]);
            }
          }
        }
      }
    }
  }
  __syncthreads();   // the staging buffers become the epilogue's stage

  // acc[i][n][2h + e]: pixel wm*32 + 16i + lane/4 + 8h, channel
  // wn*16*NF + 8n + 2(lane%4) + e
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 2 * T::NF; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = wm * 32 + i * 16 + (lane >> 2) + 8 * h;
        const int ch = wn * 16 * T::NF + n * 8 + 2 * (lane & 3);
        *reinterpret_cast<float2*>(stage + (size_t)p * TN + ch) =
            make_float2(acc[i][n][2 * h], acc[i][n][2 * h + 1]);
      }
  __syncthreads();
  for (int e = tid; e < T::TM * TN; e += THREADS) {
    const int p = e / TN;
    const int n = e - p * TN;
    const int ox = ox0 + p;
    if (ox < Wo) {
      float v = stage[e] + bias[co0 + n];
      if (relu) v = fmaxf(v, 0.0f);
      out[(((size_t)b * Ho + oy) * Wo + ox) * Co + co0 + n] = __float2bfloat16(v);
    }
  }
}

template <int TN>
cudaError_t launch(const void* x, const void* w, const void* bias, void* out,
                   int B, int H, int W, int Cin, int Co, int k, int stride,
                   int relu, cudaStream_t stream) {
  typedef Tile<TN> T;
  const int pad = k / 2;
  const int Ho = (H + 2 * pad - k) / stride + 1;
  const int Wo = (W + 2 * pad - k) / stride + 1;
  const int cinp = (Cin + 15) / 16 * 16;
  // staged pixel rows 16 * odd bytes apart: the eight rows of an 8 x 8
  // matrix fall on eight different bank groups
  const int lds = cinp + 8;
  const int seg_w = (T::TM - 1) * stride + k;
  const size_t seg_bytes = align128((size_t)seg_w * lds * sizeof(bf16));
  // input channels per weight chunk: all of them if the k taps fit the budget
  int ck = cinp;
  while (ck > 16 && (seg_bytes + (size_t)k * ck * T::LDW * sizeof(bf16) > SMEM_BUDGET
                     || cinp % ck != 0))
    ck -= 16;
  const size_t main_bytes = seg_bytes + (size_t)k * ck * T::LDW * sizeof(bf16);
  const size_t stage_bytes = (size_t)T::TM * TN * sizeof(float);
  const size_t smem = main_bytes > stage_bytes ? main_bytes : stage_bytes;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  const int n_co = Co / TN;
  const dim3 grid((Wo + T::TM - 1) / T::TM, Ho, B * n_co);
  if (Ho < 1 || Wo < 1 || grid.y > 65535 || grid.z > 65535)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      conv_kernel<TN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  conv_kernel<TN><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(out), H, W, Cin,
      cinp, ck, Ho, Wo, Co, k, stride, pad, relu, n_co, lds, (int)seg_bytes);
  return cudaGetLastError();
}

}  // namespace

// x [B, H, W, Cin] bf16, w [k, k, Cin, Co] bf16, bias [Co] f32,
// out [B, Ho, Wo, Co] bf16 with Ho = (H - 1) / stride + 1 (SAME padding k/2).
extern "C" int speinet_conv2d(const void* x, const void* w, const void* bias,
                              void* out, int B, int H, int W, int Cin, int Co,
                              int k, int stride, int relu, void* stream) {
  if (k % 2 == 0 || k < 1 || Co % 16 != 0 || Cin < 1 || (stride != 1 && stride != 2))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Co % 64 == 0)
    return launch<64>(x, w, bias, out, B, H, W, Cin, Co, k, stride, relu, s);
  if (Co % 32 == 0)
    return launch<32>(x, w, bias, out, B, H, W, Cin, Co, k, stride, relu, s);
  return launch<16>(x, w, bias, out, B, H, W, Cin, Co, k, stride, relu, s);
}
