// K3: one-pass cyclic 2-D roll of an NHWC tensor.
//
// Replaces speinet_tpu/ops/pallas_roll.py::roll2d (pallas_call at :115,
// body _roll_kernel :27):
//     out[b, i, j, :] = x[b, (i + sh) % H, (j + sw) % W, :]
// i.e. jnp.roll / torch.roll by (-sh, -sw) over (H, W).
//
// Bound on the H100: bytes. It moves every byte once in and once out
// (59 MB per [180, 320, 256] bf16 stream image, ~0.018 ms at 3.35 TB/s) and
// computes nothing. Design: each thread copies 16-byte units (8 bf16 of one
// pixel's channel row) with the modular source index computed per unit, so
// both the read and the write are coalesced 16-byte accesses; the TPU's
// row-band DMA scheme is a VMEM layout device and is not carried over. A
// pixel row whose byte count is not a multiple of 16 falls back to smaller
// units.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void roll_kernel(const T* __restrict__ x, T* __restrict__ out,
                            int total_units, int H, int W, int units_per_px,
                            int sh, int sw) {
  for (int u = blockIdx.x * blockDim.x + threadIdx.x; u < total_units;
       u += gridDim.x * blockDim.x) {
    const int px = u / units_per_px;
    const int e = u - px * units_per_px;
    const int j = px % W;
    const int t = px / W;
    const int i = t % H;
    const int b = t / H;
    int si = i + sh;
    if (si >= H) si -= H;
    int sj = j + sw;
    if (sj >= W) sj -= W;
    out[u] = x[((b * H + si) * W + sj) * units_per_px + e];
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, int B, int H, int W,
                   int row_bytes, int sh, int sw, cudaStream_t stream) {
  const int units_per_px = row_bytes / (int)sizeof(T);
  const long long total = (long long)B * H * W * units_per_px;
  if (total >= (1LL << 31)) return cudaErrorInvalidValue;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  roll_kernel<T><<<(int)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), (int)total, H, W,
      units_per_px, sh, sw);
  return cudaGetLastError();
}

}  // namespace

extern "C" int speinet_roll2d(const void* x, void* out, int B, int H, int W,
                              int row_bytes, int sh, int sw, void* stream) {
  if (H <= 0 || W <= 0 || sh < 0 || sh >= H || sw < 0 || sw >= W)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t a = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out);
  if (row_bytes % 16 == 0 && a % 16 == 0)
    return launch<uint4>(x, out, B, H, W, row_bytes, sh, sw, s);
  if (row_bytes % 4 == 0 && a % 4 == 0)
    return launch<uint32_t>(x, out, B, H, W, row_bytes, sh, sw, s);
  if (row_bytes % 2 == 0 && a % 2 == 0)
    return launch<uint16_t>(x, out, B, H, W, row_bytes, sh, sw, s);
  return launch<uint8_t>(x, out, B, H, W, row_bytes, sh, sw, s);
}

extern "C" const char* speinet_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
