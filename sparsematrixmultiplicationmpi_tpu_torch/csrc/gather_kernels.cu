// Hopper (sm_90a) kernel of the ELL spill's explicit-gather route.
//
// Built with the other csrc/*.cu files into one shared library with a
// plain C interface (ops/_kernel_lib.py); the Python wrapper lives in
// ops/cuda_gather.py beside its plain PyTorch version. The entry point
// launches on the stream it is given, allocates nothing and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
//
// ---------------------------------------------------------------------
// B7  ell_gather_launch — replaces sparsematrixmultiplicationmpi_tpu/ops/
//     pallas_gather.py:_kernel (wrapper ell_gather_rows_pallas; caller
//     ops/ell.py::_spmm_ell_dma).
//
//   out[r, :] = sum_w vals[r, w] * v[cols[r, w], :]   over one ELL plane,
//   f32 in, f32 accumulation in w order, f32 out (Rt, k), k <= 128.
//
//   The TPU kernel starts one row DMA per (row, slot) from the scalar
//   core into a double-buffered VMEM stage, with v padded to 128 lanes
//   and the rows to a step multiple (Mosaic's slicing rules). Here one
//   warp owns one output row: its lanes read the row's W column ids and
//   values once, coalesced, 32 slots at a time, pass them round with
//   shuffles, and gather each addressed row of v with consecutive lanes
//   on consecutive columns (lane L holds columns L, L + 32, L + 64,
//   L + 96). Nothing is padded and any k <= 128 runs.
//
//   What bounds it on the H100: one k-wide row of v per slot, a
//   latency-bound gather (k = 32 f32 is one 128-byte line per slot);
//   eight warps per CTA and many CTAs per SM keep enough rows in flight.
// ---------------------------------------------------------------------

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 warps: 8 output rows per CTA
constexpr int kMaxK = 128;

__global__ void __launch_bounds__(kThreads)
ell_gather_kernel(const int* __restrict__ cols,
                  const float* __restrict__ vals,
                  const float* __restrict__ v, float* __restrict__ out,
                  int rows, int W, int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  float acc[kMaxK / 32] = {0.f, 0.f, 0.f, 0.f};
  const int* row_cols = cols + static_cast<size_t>(row) * W;
  const float* row_vals = vals + static_cast<size_t>(row) * W;
  for (int w0 = 0; w0 < W; w0 += 32) {
    const int n = min(32, W - w0);
    const int my_col = lane < n ? row_cols[w0 + lane] : 0;
    const float my_val = lane < n ? row_vals[w0 + lane] : 0.f;
    for (int j = 0; j < n; ++j) {
      const int c = __shfl_sync(0xffffffffu, my_col, j);
      const float a = __shfl_sync(0xffffffffu, my_val, j);
      const float* src = v + static_cast<size_t>(c) * k;
#pragma unroll
      for (int q = 0; q < kMaxK / 32; ++q) {
        const int col = lane + 32 * q;
        if (col < k) acc[q] = fmaf(a, src[col], acc[q]);
      }
    }
  }
  float* dst = out + static_cast<size_t>(row) * k;
#pragma unroll
  for (int q = 0; q < kMaxK / 32; ++q) {
    const int col = lane + 32 * q;
    if (col < k) dst[col] = acc[q];
  }
}

}  // namespace

extern "C" {

// B7. cols (rows, W) int32, vals (rows, W) f32, v (n, k) f32, out (rows,
// k) f32, all contiguous; 1 <= k <= 128 (checked by the wrapper).
int ell_gather_launch(const void* cols, const void* vals, const void* v,
                      void* out, int rows, int W, int k, void* stream) {
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const int per_cta = kThreads / 32;
  ell_gather_kernel<<<(rows + per_cta - 1) / per_cta, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cols), static_cast<const float*>(vals),
      static_cast<const float*>(v), static_cast<float*>(out), rows, W, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
