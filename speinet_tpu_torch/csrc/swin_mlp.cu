// K9: the MLP half of a Swin block over token rows,
//     out = x + bf16(fc2(bf16(gelu(fc1(bf16(LN2(x)))))))
//
// Replaces speinet_tpu/ops/pallas_swin.py::fused_ln_mlp (pallas_call at
// :131, body _ln_mlp_kernel :109). x and out are [rows, C] bf16 (the
// [B, L, C] stream flattened), LN2 in f32 with eps 1e-5 and the one-pass
// clamped variance, fc1 / fc2 bf16 products with f32 sums, the hidden layer
// and the fc2 result each rounded to bf16 as the TPU kernel rounds them,
// GELU by erff (the TPU's 1.5e-7 erf polynomial has no reason to exist
// here). Rows need not be a multiple of anything: the last CTA masks them.
//
// Bound on the H100: operations. At [2, 57,600, 256] with hidden 512 it is
// 4 C hidden = 6.0e10 FLOP (0.061 ms at 989 TFLOP/s) against 118 MB of
// input and output (0.035 ms). Design: K2's MLP stage (swin_common.cuh::
// mlp) on 128 rows per CTA: the LN2'd rows in shared memory as the A
// operand, the f32 fc2 sums accumulated in shared memory across 64-wide
// hidden chunks, one CTA (227 KB) per SM.

#include "swin_common.cuh"

using namespace swin;

namespace {

struct MlpArgs {
  const bf16* x;
  bf16* out;
  const float* ln2w;
  const float* ln2b;
  const bf16* w1;     // [hidden, C]
  const float* b1;
  const bf16* w2;     // [C, hidden]
  const float* b2;
  long long rows;
  int C, hidden;
  int ldb, ldf;       // padded row strides (elements) of bf16 / f32 buffers
  int off_b, off_c, off_s;   // shared-memory region offsets (bytes)
};

__global__ void __launch_bounds__(THREADS, 1) swin_mlp_kernel(const MlpArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);              // fc2 sums [M][ldf]
  bf16* xn = reinterpret_cast<bf16*>(smem + a.off_b);       // LN2(x) [M][ldb]
  bf16* hid = reinterpret_cast<bf16*>(smem + a.off_c);      // hidden chunk
  float* stage = reinterpret_cast<float*>(smem + a.off_s);  // [WARPS][16x16]

  const int C = a.C;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool act = lane * 8 < C;
  const long long row0 = (long long)blockIdx.x * M;

  // ---- LN2(x) -> xn, zero sums; RB rows in flight per warp
  for (int m0 = warp; m0 < M; m0 += WARPS * RB) {
    uint4 raw[RB];
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const long long r = row0 + m0 + i * WARPS;
      raw[i] = make_uint4(0, 0, 0, 0);
      if (r < a.rows && act)
        raw[i] = *reinterpret_cast<const uint4*>(a.x + r * C + lane * 8);
    }
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const int m = m0 + i * WARPS;
      float v[8];
      unpack8(raw[i], v);
      if (row0 + m < a.rows) ln8(v, act, C, a.ln2w, a.ln2b, lane);
      if (act) {
        *reinterpret_cast<uint4*>(xn + (size_t)m * a.ldb + lane * 8) = pack8(v);
        float* ar = acc + (size_t)m * a.ldf + lane * 8;
        reinterpret_cast<float4*>(ar)[0] = make_float4(0.f, 0.f, 0.f, 0.f);
        reinterpret_cast<float4*>(ar)[1] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
  __syncthreads();

  mlp(xn, a.ldb, acc, a.ldf, hid, stage + warp * 256, a.w1, a.b1, a.w2, C,
      a.hidden);

  // ---- out = x + bf16(sums + b2)
  if (act) {
    for (int m = warp; m < M; m += WARPS) {
      const long long r = row0 + m;
      if (r >= a.rows) break;
      float xin[8];
      unpack8(*reinterpret_cast<const uint4*>(a.x + r * C + lane * 8), xin);
      const float* ar = acc + (size_t)m * a.ldf + lane * 8;
      const float4 p0 = reinterpret_cast<const float4*>(ar)[0];
      const float4 p1 = reinterpret_cast<const float4*>(ar)[1];
      const float pr[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = xin[i] + __bfloat162float(__float2bfloat16(pr[i] + a.b2[lane * 8 + i]));
      *reinterpret_cast<uint4*>(a.out + r * C + lane * 8) = pack8(v);
    }
  }
}

}  // namespace

// x, out [rows, C] bf16; w1 [hidden, C], w2 [C, hidden] bf16 (torch Linear
// layout); ln2w, ln2b, b1, b2 f32.
extern "C" int speinet_swin_mlp(const void* x, void* out, const void* ln2w,
                                const void* ln2b, const void* w1,
                                const void* b1, const void* w2, const void* b2,
                                long long rows, int C, int hidden,
                                void* stream) {
  if (rows < 1 || C % 16 != 0 || C < 16 || C > 256 || hidden % HCH != 0 ||
      hidden < HCH)
    return cudaErrorInvalidValue;
  const long long blocks = (rows + M - 1) / M;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  MlpArgs a;
  a.x = static_cast<const bf16*>(x);
  a.out = static_cast<bf16*>(out);
  a.ln2w = static_cast<const float*>(ln2w);
  a.ln2b = static_cast<const float*>(ln2b);
  a.w1 = static_cast<const bf16*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = static_cast<const bf16*>(w2);
  a.b2 = static_cast<const float*>(b2);
  a.rows = rows;
  a.C = C;
  a.hidden = hidden;
  a.ldb = C + 8;   // +16 bytes per row: conflict-free fragment loads
  a.ldf = C + 4;
  a.off_b = align128(M * a.ldf * 4);
  a.off_c = a.off_b + align128(M * a.ldb * 2);
  a.off_s = a.off_c + align128(M * LDH * 2);
  const int smem = a.off_s + WARPS * 256 * 4;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      swin_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  swin_mlp_kernel<<<(unsigned)blocks, THREADS, smem,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
