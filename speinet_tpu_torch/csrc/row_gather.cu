// K10: batched row gather, out[b, l, :] = rows[b, idx[b, l], :].
//
// Replaces speinet_tpu/ops/pallas_gather.py::row_gather (pallas_call at :64,
// body _gather_kernel :32), the drop-in for the take_along_axis of the
// texture transfer's combined gather-fold. Here it serves the port's
// ops/patch_ops.py::gather_fold3_nhwc: rows [B, T, R] bf16 are the one-tile-
// padded s x s tiles of the three sharp pyramid levels side by side, idx
// [B, L] the nine pre-shifted tile indices of every lv3 position.
//
// Bound on the H100: bytes. Nothing is computed; at 720p (T = 58,604,
// R = 896, L = 518,400, B = 2) it writes 1.86 GB and reads at least the
// 210 MB table, ~0.62 ms at 3.35 TB/s. Design: one warp per output row,
// 16-byte vector copies with neighbouring lanes on neighbouring addresses,
// the row's index read by the warp itself (the TPU's scalar prefetch has no
// counterpart); each warp walks rows with a grid stride, so a fixed grid of
// a few waves covers any L. Index values are not checked: the caller builds
// them in [0, T).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <typename I>
__global__ void __launch_bounds__(THREADS) row_gather_kernel(
    const uint4* __restrict__ rows, const I* __restrict__ idx,
    uint4* __restrict__ out, long long n_out, int L, int T, int vecs) {
  const int lane = threadIdx.x & 31;
  const long long warp0 = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long stride = (long long)gridDim.x * WARPS;
  for (long long r = warp0; r < n_out; r += stride) {
    const long long b = r / L;
    const long long src = b * T + (long long)idx[r];
    const uint4* s = rows + src * vecs;
    uint4* d = out + r * vecs;
    for (int v = lane; v < vecs; v += 32) d[v] = s[v];
  }
}

template <typename I>
cudaError_t launch(const void* rows, const void* idx, void* out, int B,
                   int T, int R, int L, cudaStream_t stream) {
  const long long n_out = (long long)B * L;
  long long blocks = (n_out + WARPS - 1) / WARPS;
  if (blocks > 132 * 16) blocks = 132 * 16;
  row_gather_kernel<I><<<(int)blocks, THREADS, 0, stream>>>(
      static_cast<const uint4*>(rows), static_cast<const I*>(idx),
      static_cast<uint4*>(out), n_out, L, T, R / 8);
  return cudaGetLastError();
}

}  // namespace

// rows [B, T, R] bf16, idx [B, L] int32 (idx_bytes 4) or int64 (8) ->
// out [B, L, R] bf16. R must be a multiple of 8 (16-byte rows) and every
// pointer 16-byte aligned.
extern "C" int speinet_row_gather(const void* rows, const void* idx, void* out,
                                  int B, int T, int R, int L, int idx_bytes,
                                  void* stream) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(rows)
                      | reinterpret_cast<uintptr_t>(out);
  if (B < 1 || T < 1 || R < 8 || R % 8 != 0 || L < 1 || a % 16 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx_bytes == 8) return launch<long long>(rows, idx, out, B, T, R, L, s);
  if (idx_bytes == 4) return launch<int>(rows, idx, out, B, T, R, L, s);
  return cudaErrorInvalidValue;
}
