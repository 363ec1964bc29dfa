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
// against 59 MB of input and output (0.048 ms of bf16 tensor-core time vs
// 0.035 ms of memory time), and the 64/128-channel convs are further above
// the ridge.
//
// Design: implicit GEMM on warpgroup MMAs (wgmma m64nNk16, bf16, f32
// accumulators in registers), warp-specialised. A CTA computes R = 2 * MT
// output rows x 64 output pixels x N output channels (N = all of Co up to
// 128). Warps 0-7 are two consumer warpgroups, each owning MT output rows
// (one m64 tile per row); warps 8-11 are the producer warpgroup.
// - One producer thread loads everything by TMA under mbarriers: the
//   (R - 1) * stride + k input rows the tile needs (64 * stride + k - 1
//   pixels, the input channels padded to 16, 32 or a multiple of 64, zeros
//   past the image), each row on its own barrier and issued a kernel row
//   ahead of the first tap that reads it; and the weights, slabs of 64
//   (N >= 64) or 128 rows of the flattened (tap, input channel) axis, each
//   one contiguous bulk copy (the wrapper lays the weights out in slab
//   order), through a ring of 2-8 stages under full / empty mbarriers, so
//   the next slab's copy overlaps this one's MMAs, and consumers keep one
//   MMA group in flight while they wait. (TMA costs a request per
//   innermost box row, so weights moved as 16-byte pieces, by threads or
//   as boxes with a 16-byte inner dimension, keep consumers waiting.) Inputs
//   whose channel count is not a multiple of 8 (the 3-channel in_conv) are
//   staged by the producer threads with scalar loads instead.
// - A slab's k16 steps are unrolled into straight-line MMAs (tap and
//   channel offsets advance by selects): MMAs under loops of runtime length
//   are serialised by ptxas (C7520).
// - A comes from shared memory, K-major without swizzle: a staged input row
//   is stored as [8-channel chunk][pixel][8] (at stride 2 twice, once for
//   the even pixels, once for the odd ones), so any 8 consecutive pixels of
//   a chunk are one 8 x 16-byte core matrix. For tap (ky, kx) the m64 tile
//   of output row r is 64 consecutive pixels of staged row r * stride + ky
//   starting at pixel kx (kx / 2 in the block of kx's parity): a
//   descriptor start offset, with no copy. (The canonical swizzled layouts
//   do not survive such an offset.)
// - B, the weight slab, is read N-major (the HWIO weights keep Co
//   contiguous): core matrices of 8 output channels x 8 rows, laid out
//   [N/8][slab rows][8].
// - The epilogue adds the f32 bias and applies ReLU to the accumulator
//   fragments, packs them to bf16 and writes each pixel's channels with
//   16-byte stores after a transpose within each quad of lanes.
// - Wide inputs (GROUPED): where the tile's whole staged rows do not fit in
//   shared memory (5x5 at 256 input channels, 5x5/2 at 128), the input
//   channels are staged 64 at a time. The CTA walks the groups in order,
//   each through all k * k taps, restaging its rows for every group after
//   both consumer warpgroups have released the previous one (one barrier a
//   group). A weight slab is then one (group, tap) pair of the wrapper's
//   tap-major slab order: the producer reads slab tap * groups + group.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>


#include "hopper.cuh"

typedef __nv_bfloat16 bf16;
using namespace hopper;

namespace {

constexpr int THREADS = 384;        // two consumer warpgroups + the producer warpgroup
constexpr int PRODUCERS = 128;
constexpr int TILE_W = 64;          // output pixels per row of a tile
constexpr int MAX_STAGES = 8;
constexpr int MAX_ROWS = 32;        // staged input rows per tile
constexpr int GROUP_C = 64;         // input channels staged at a time when GROUPED
constexpr size_t SMEM_MAX = 227 * 1024;

inline size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

// k16 steps per weight slab: 64 or 128 rows of the flattened (tap, input
// channel) axis, so a narrow slab still carries a few hundred MMA cycles
template <int N>
__host__ __device__ constexpr int slab_steps() { return N >= 64 ? 4 : 8; }

// tiles with at most 32 accumulators a thread run two CTAs per SM, so one
// CTA's staging and epilogue overlap the other's MMAs
template <int N, int MT>
__host__ __device__ constexpr int ctas_per_sm() { return N * MT <= 64 ? 2 : 1; }

struct ConvArgs {
  const bf16* x;
  const bf16* w;
  const float* bias;
  bf16* out;
  int H, W, Cin, cinp, Ho, Wo, Co, k, stride, pad, relu, n_co;
  int crow;       // channels of a staged row: cinp, or GROUP_C when GROUPED
  int seg_w;      // staged pixels per input row
  int npix;       // pixels of one parity block: seg_w, or (seg_w + 1) / 2 at stride 2
  int plane;      // bytes of one 8-channel chunk of a parity block: npix * 16
  int pblk;       // bytes of a parity block, 128-aligned
  int rowb;       // bytes of a staged row: stride parity blocks
  int nrows;      // staged input rows
  int n_slabs;    // weight slabs over k * k * cinp
  int stages;     // weight ring depth
  int in_bytes;   // offset of the weight ring
  int slab_bytes;
};

template <int N, int MT, bool GROUPED>
__global__ void __launch_bounds__(THREADS, (ctas_per_sm<N, MT>())) conv_kernel(
    const __grid_constant__ CUtensorMap xmap, const ConvArgs a) {
  constexpr int R = 2 * MT;
  constexpr int NB = N / 8;               // 8-channel column blocks
  constexpr int KS = slab_steps<N>();
  constexpr int SLAB_K = KS * 16;         // weight rows per slab
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t in_s = smem_u32(smem);
  const uint32_t ring_s = in_s + a.in_bytes;
  const uint32_t bar_s = ring_s + a.stages * a.slab_bytes;
  auto full = [&](int i) { return bar_s + 8 * i; };
  auto empty = [&](int i) { return bar_s + 8 * (MAX_STAGES + i); };
  auto rowbar = [&](int i) { return bar_s + 8 * (2 * MAX_STAGES + i); };
  // both consumer warpgroups are done with the staged rows of a group
  const uint32_t rows_free = bar_s + 8 * (2 * MAX_STAGES + MAX_ROWS);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int ox0 = blockIdx.x * TILE_W;
  const int oy0 = blockIdx.y * R;
  const int b = blockIdx.z / a.n_co;
  const int co0 = (blockIdx.z - b * a.n_co) * N;
  const int stride = a.stride;
  const int c8n = a.crow / 8;
  const int groups = a.cinp / a.crow;
  const uint32_t plane = a.plane;
  const int kk = a.k * a.k;
  const bool vec_in = (a.Cin % 8) == 0;

  if (tid == 0) {
    for (int i = 0; i < a.stages; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), 2);
    }
    for (int i = 0; i < a.nrows; ++i) mbar_init(rowbar(i), vec_in ? 1 : PRODUCERS);
    mbar_init(rows_free, 2);
    mbar_fence_init();
  }
  if (!vec_in) {   // scalar staging writes only the valid channels
    for (int u = tid; u < a.in_bytes / 16; u += THREADS)
      reinterpret_cast<uint4*>(smem)[u] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  if (warp >= 8) {
    // ---------------- producers
    const int pt = tid - 256;
    if (vec_in && pt != 0) return;   // one thread issues every TMA
    bf16* in = reinterpret_cast<bf16*>(smem);
    int issued = 0, st = 0;
    uint32_t ph = 0;
    for (int q = 0; q < a.n_slabs; ++q) {
      // GROUPED: slab q is tap q % kk of channel group g = q / kk
      const int g = GROUPED ? q / kk : 0;
      const int tap = GROUPED ? q - g * kk : 0;
      if (GROUPED && tap == 0 && g > 0) {
        mbar_wait(rows_free, (g - 1) & 1);   // group g - 1's rows are released
        issued = 0;
      }
      // the input rows this slab's last tap reads, and the next kernel
      // row's, so no consumer waits on a row issued just before it
      const int ky_last =
          GROUPED ? tap / a.k : min(kk - 1, (q * SLAB_K + SLAB_K - 1) / a.cinp) / a.k;
      const int need = min(a.nrows, (R - 1) * stride + ky_last + 2);
      for (; issued < need; ++issued) {
        const int iy = oy0 * stride - a.pad + issued;
        const int ix0 = ox0 * stride - a.pad;
        const uint32_t row_s = in_s + issued * a.rowb;
        if (vec_in) {
          // one box per parity block: at stride 2 every other pixel, from
          // ix0 (even block) and ix0 + 1 (odd block); zeros past the image
          mbar_expect_tx(rowbar(issued), stride * c8n * plane);
          for (int par = 0; par < stride; ++par)
            tma_load_5d(row_s + par * a.pblk, &xmap, rowbar(issued), 0, ix0 + par, g * c8n,
                        iy, b);
        } else {
          if (iy >= 0 && iy < a.H) {
            const bf16* xrow = a.x + ((size_t)b * a.H + iy) * a.W * a.Cin;
            // GROUPED restages every channel slot of the group (zeros past
            // Cin over the previous group's values); otherwise the valid
            // channels over the zeroed tile
            const int cn = GROUPED ? a.crow : a.Cin;
            for (int e = pt; e < a.seg_w * cn; e += PRODUCERS) {
              const int col = e / cn;
              const int cl = e - col * cn;
              const int c = g * a.crow + cl;
              const int ix = ix0 + col;
              const int par = stride == 2 ? col & 1 : 0;
              const int pos = stride == 2 ? col >> 1 : col;
              if (ix >= 0 && ix < a.W)
                in[((size_t)issued * a.rowb + par * a.pblk + (cl / 8) * plane) / 2 + pos * 8
                   + (cl & 7)] = c < a.Cin ? xrow[(size_t)ix * a.Cin + c] : __float2bfloat16(0.0f);
            }
          }
          mbar_arrive(rowbar(issued));
        }
      }
      // slab q of this CTA's output channels: one contiguous bulk copy
      if (pt == 0) {
        mbar_wait(empty(st), ph ^ 1);
        mbar_expect_tx(full(st), a.slab_bytes);
        const int slab = GROUPED ? tap * groups + g : q;
        bulk_load(ring_s + st * a.slab_bytes,
                  a.w + ((size_t)(co0 / N) * a.n_slabs + slab) * (a.slab_bytes / 2),
                  a.slab_bytes, full(st));
      }
      if (++st == a.stages) {
        st = 0;
        ph ^= 1;
      }
    }
    return;
  }

  // ---------------- consumers
  const int wg = warp >> 2;      // output rows wg * MT .. + MT - 1
  const int wq = warp & 3;       // pixels 16 wq .. + 15 of each m64 tile
  float acc[MT][N / 2];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[t][i] = 0.0f;
#pragma unroll
  for (int t = 0; t < MT; ++t) fence_regs<N / 2>(acc[t]);

  // the k16 step's tap (ky, kx) and channel offset c0, advanced by selects
  int ky = 0, kx = 0, c0 = 0;
  int st = 0, prev = -1, waited = -1;
  uint32_t ph = 0;
  for (int q = 0; q < a.n_slabs; ++q) {
    const int g = GROUPED ? q / kk : 0;
    const int tap = GROUPED ? q - g * kk : 0;
    if (GROUPED && tap == 0 && g > 0) {
      // every MMA of group g - 1 has read its rows: hand them back
      wgmma_wait<0>();
      if (lane == 0 && wq == 0) mbar_arrive(rows_free);
      waited = -1;
    }
    const int ky_last =
        GROUPED ? tap / a.k : min(kk - 1, (q * SLAB_K + SLAB_K - 1) / a.cinp) / a.k;
    const int last_row = (wg * MT + MT - 1) * stride + ky_last;
    for (; waited < last_row; ++waited) mbar_wait(rowbar(waited + 1), g & 1);
    mbar_wait(full(st), ph);
    fence_proxy_async();    // scalar staging's st.shared (Cin % 8 != 0) -> wgmma reads
    const uint32_t slab = ring_s + st * a.slab_bytes;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      // past the last tap (a partial last slab) the weights are zero: any
      // staged row will do
      const int ky_s = min(ky, a.k - 1);
      // tap kx reads its parity block from pixel kx / stride on
      const uint32_t col0 = stride == 2 ? (kx & 1) * a.pblk + (kx >> 1) * 16 : kx * 16;
      const uint64_t db = make_desc(slab + s * 256, 128, SLAB_K * 16, 0);
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        const int ir = (wg * MT + t) * stride + ky_s;
        const uint64_t da = make_desc(in_s + ir * a.rowb + (c0 / 8) * plane + col0, plane, 128, 0);
        wgmma_ss<N, 1>(acc[t], da, db, 1);
      }
      const bool wrap_c = c0 + 16 == a.crow;
      const bool wrap_x = wrap_c && kx + 1 == a.k;
      c0 = wrap_c ? 0 : c0 + 16;
      kx = wrap_x ? 0 : kx + (wrap_c ? 1 : 0);
      ky += wrap_x ? 1 : 0;
      if (GROUPED && ky == a.k) ky = 0;   // the next group starts at tap 0
    }
    wgmma_commit();
    wgmma_wait<1>();    // the previous slab's MMAs have completed
    if (prev >= 0 && lane == 0 && wq == 0) mbar_arrive(empty(prev));
    prev = st;
    if (++st == a.stages) {
      st = 0;
      ph ^= 1;
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int t = 0; t < MT; ++t) fence_regs<N / 2>(acc[t]);

  // ---- epilogue: bias, ReLU, bf16, 16-byte stores of 8 channels
  const int q4 = lane & 3;
#pragma unroll
  for (int t = 0; t < MT; ++t) {
    const int oy = oy0 + wg * MT + t;
    if (oy >= a.Ho) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ox = ox0 + wq * 16 + (lane >> 2) + 8 * h;
      bf16* orow = a.out + (((size_t)b * a.Ho + oy) * a.Wo + ox) * a.Co + co0;
      uint32_t wv[NB];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const float2 bb = __ldg(reinterpret_cast<const float2*>(a.bias + co0 + 8 * j + 2 * q4));
        float v0 = acc[t][4 * j + 2 * h] + bb.x;
        float v1 = acc[t][4 * j + 2 * h + 1] + bb.y;
        if (a.relu) {
          v0 = fmaxf(v0, 0.0f);
          v1 = fmaxf(v1, 0.0f);
        }
        wv[j] = pack_bf16x2(v0, v1);
      }
      if constexpr (NB % 4 == 0) {
#pragma unroll
        for (int J = 0; J < NB / 4; ++J) {
          const uint4 v = quad_transpose(wv + 4 * J);
          if (ox < a.Wo) *reinterpret_cast<uint4*>(orow + 8 * (4 * J + q4)) = v;
        }
      } else if (ox < a.Wo) {
#pragma unroll
        for (int j = 0; j < NB; ++j)
          *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * q4) = wv[j];
      }
    }
  }
}

template <int N, int MT, bool GROUPED>
cudaError_t launch(ConvArgs a, int B, size_t smem, cudaStream_t stream) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr || (reinterpret_cast<uintptr_t>(a.w) & 15) != 0)
    return cudaErrorInvalidValue;
  // the input as TMA sees it (Cin a multiple of 8; other widths are staged
  // by the producer threads): d0 8 channels, d1 pixel, d2 8-channel chunk,
  // d3 row, d4 image; a box is one staged row's parity block, every
  // stride-th pixel; reads past the image fill zeros
  CUtensorMap xmap = {};
  if (a.Cin % 8 == 0) {
    if ((reinterpret_cast<uintptr_t>(a.x) & 15) != 0) return cudaErrorInvalidValue;
    const cuuint64_t xd[5] = {8, (cuuint64_t)a.W, (cuuint64_t)a.Cin / 8, (cuuint64_t)a.H,
                              (cuuint64_t)B};
    const cuuint64_t xs[4] = {(cuuint64_t)a.Cin * 2, 16, (cuuint64_t)a.W * a.Cin * 2,
                              (cuuint64_t)a.H * a.W * a.Cin * 2};
    const cuuint32_t xb[5] = {8, (cuuint32_t)(a.npix * a.stride), (cuuint32_t)a.crow / 8, 1, 1};
    const cuuint32_t xe[5] = {1, (cuuint32_t)a.stride, 1, 1, 1};
    if (xb[1] > 256 || xb[2] > 256 ||
        enc(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<bf16*>(a.x), xd, xs, xb, xe,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  const dim3 grid((a.Wo + TILE_W - 1) / TILE_W, (a.Ho + 2 * MT - 1) / (2 * MT),
                  B * a.n_co);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      conv_kernel<N, MT, GROUPED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(conv_kernel<N, MT, GROUPED>,
                             cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (e != cudaSuccess) return e;
  conv_kernel<N, MT, GROUPED><<<grid, THREADS, smem, stream>>>(xmap, a);
  return cudaGetLastError();
}

// shared-memory plan of a tile of 2 * MT output rows within `budget` bytes
// with a ring of at least `min_stages` slabs, staging `crow` input
// channels of a row at a time; 0 if it does not fit
template <int N>
size_t plan(ConvArgs& a, int MT, size_t budget, int min_stages, int crow) {
  const int R = 2 * MT;
  a.crow = crow;
  a.nrows = (R - 1) * a.stride + a.k;
  a.seg_w = (TILE_W - 1) * a.stride + a.k;
  a.npix = a.stride == 2 ? (a.seg_w + 1) / 2 : a.seg_w;
  a.plane = a.npix * 16;
  a.pblk = (int)align128((size_t)crow / 8 * a.plane);
  a.rowb = a.stride * a.pblk;
  if (a.nrows > MAX_ROWS) return 0;
  a.slab_bytes = slab_steps<N>() * 16 * N * (int)sizeof(bf16);
  a.n_slabs = (a.k * a.k * a.cinp + slab_steps<N>() * 16 - 1) / (slab_steps<N>() * 16);
  const size_t in_bytes = (size_t)a.nrows * a.rowb;
  const size_t bars = 8 * (2 * MAX_STAGES + MAX_ROWS + 1);
  if (in_bytes + bars + (size_t)min_stages * a.slab_bytes > budget) return 0;
  a.stages = (int)((budget - in_bytes - bars) / a.slab_bytes);
  if (a.stages > MAX_STAGES) a.stages = MAX_STAGES;
  a.in_bytes = (int)in_bytes;
  return in_bytes + (size_t)a.stages * a.slab_bytes + bars;
}

// the first shared-memory plan that fits, in this order: narrow tiles two
// CTAs per SM; wider ones one CTA of four output rows (two rows with two
// CTAs per SM measured slower at N = 64), then of two; then rows too wide
// to stage whole, 64 input channels at a time (a slab is then one tap of
// one group, which needs 64-row slabs: N >= 64). Sets mt and grouped;
// returns the bytes of shared memory, 0 if no plan fits.
template <int N>
size_t choose(ConvArgs& a, int& mt, bool& grouped) {
  struct Try {
    int mt;
    size_t budget;
    int min_stages;
    bool grouped;
  };
  const size_t half = SMEM_MAX / 2 - 1024;
  const Try tries[] = {{2, half, 4, false}, {2, SMEM_MAX, 3, false}, {1, SMEM_MAX, 2, false},
                       {2, SMEM_MAX, 3, true}, {1, SMEM_MAX, 2, true}};
  for (const Try& t : tries) {
    if (t.budget == half && ctas_per_sm<N, 2>() != 2) continue;
    if (t.grouped && (N < 64 || a.cinp % GROUP_C != 0)) continue;
    ConvArgs c = a;
    const size_t smem = plan<N>(c, t.mt, t.budget, t.min_stages, t.grouped ? GROUP_C : a.cinp);
    if (smem) {
      a = c;
      mt = t.mt;
      grouped = t.grouped;
      return smem;
    }
  }
  return 0;
}

template <int N>
cudaError_t launch_n(ConvArgs a, int B, cudaStream_t stream) {
  a.n_co = a.Co / N;
  int mt;
  bool grouped;
  const size_t smem = choose<N>(a, mt, grouped);
  if (smem == 0) return cudaErrorInvalidValue;
  if constexpr (N >= 64) {
    if (grouped)
      return mt == 2 ? launch<N, 2, true>(a, B, smem, stream)
                     : launch<N, 1, true>(a, B, smem, stream);
  }
  return mt == 2 ? launch<N, 2, false>(a, B, smem, stream)
                 : launch<N, 1, false>(a, B, smem, stream);
}

template <int N>
int fits_n(ConvArgs a) {
  int mt;
  bool grouped;
  return choose<N>(a, mt, grouped) != 0;
}

// input channels padded to 16, 32 or a multiple of 64, so that a weight
// slab of 64 or 128 rows is whole taps or a whole part of one
int padded_cin(int Cin) { return Cin <= 16 ? 16 : Cin <= 32 ? 32 : (Cin + 63) / 64 * 64; }

}  // namespace

// x [B, H, W, Cin] bf16, bias [Co] f32, out [B, Ho, Wo, Co] bf16 with
// Ho = (H - 1) / stride + 1 (SAME padding k/2). w: the [k, k, Cin, Co] bf16
// weights in slab order (kernels/conv.py::slab_weights): [Co / N][slabs]
// [N / 8][slab rows][8], zero past Cin within cinp and past the last tap;
// N = 128, 64, 32 or 16 (the largest dividing Co), slab rows 64 for
// N >= 64 else 128, cinp = Cin padded to 16, 32 or a multiple of 64.
extern "C" int speinet_conv2d(const void* x, const void* w, const void* bias,
                              void* out, int B, int H, int W, int Cin, int Co,
                              int k, int stride, int relu, void* stream) {
  if (k % 2 == 0 || k < 1 || Co % 16 != 0 || Cin < 1 || (stride != 1 && stride != 2))
    return cudaErrorInvalidValue;
  ConvArgs a;
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const bf16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<bf16*>(out);
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.k = k;
  a.stride = stride;
  a.pad = k / 2;
  a.relu = relu;
  a.Co = Co;
  a.Ho = (H + 2 * a.pad - k) / stride + 1;
  a.Wo = (W + 2 * a.pad - k) / stride + 1;
  if (a.Ho < 1 || a.Wo < 1) return cudaErrorInvalidValue;
  a.cinp = padded_cin(Cin);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Co % 128 == 0) return launch_n<128>(a, B, s);
  if (Co % 64 == 0) return launch_n<64>(a, B, s);
  if (Co % 32 == 0) return launch_n<32>(a, B, s);
  return launch_n<16>(a, B, s);
}

// 1 if speinet_conv2d has a shared-memory plan for this conv (the wrapper
// asks before it launches), else 0
extern "C" int speinet_conv2d_fits(int Cin, int Co, int k, int stride) {
  if (k % 2 == 0 || k < 1 || Co % 16 != 0 || Cin < 1 || (stride != 1 && stride != 2)) return 0;
  ConvArgs a = {};
  a.Cin = Cin;
  a.Co = Co;
  a.k = k;
  a.stride = stride;
  a.cinp = padded_cin(Cin);
  if (Co % 128 == 0) return fits_n<128>(a);
  if (Co % 64 == 0) return fits_n<64>(a);
  if (Co % 32 == 0) return fits_n<32>(a);
  return fits_n<16>(a);
}
