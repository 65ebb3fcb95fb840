// Hopper (sm_90a) kernel of the band-dense SpMM (the solver path).
//
// Built with the other csrc/*.cu files into one shared library with a
// plain C interface (ops/_kernel_lib.py); the Python wrapper lives in
// ops/cuda_banded.py beside its plain PyTorch version. The entry point
// launches on the stream it is given, allocates nothing and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
//
// ---------------------------------------------------------------------
// B5  band_launch — replaces sparsematrixmultiplicationmpi_tpu/ops/
//     pallas_banded.py:_band_kernel (wrapper band_matmul_pallas).
//
//   out[b*r + i, :] = sum_w band[b, i, w] * v[(b-1)*r + w, :]
//   for row blocks b of r rows, w over the 3r-wide window of the block and
//   its two neighbours; v rows outside [0, n) count as zero, and output
//   rows >= m are not written. f32 band: full f32 products and sums (the
//   reference's Precision.HIGHEST, no TF32). bf16 band: the products of
//   two bf16 values are exact in f32, summed in f32, and the sum rounded
//   to bf16 once.
//
//   The TPU kernel keeps a transposed, zero-padded (k, (nb+2)r) copy of v
//   and double-buffers each block's window into VMEM by hand, with k
//   padded to a multiple of 8 — Mosaic layout rules, not semantics. Here
//   v stays in its natural (n, k) layout, the kernel masks the halo at
//   both ends itself, and any k >= 1 runs.
//
//   What bounds it on the H100: the band stream. At the CG system's shape
//   (r = 128, 947 blocks, f32) one multiply reads 186.2 MB of band and
//   ~4 MB of v and output: >= 0.056 ms at 3.35 TB/s, while its 0.75 GFLOP
//   (k = 8) need ~0.011 ms of f32 FMA. So the design reads every band
//   element exactly once per 8 fat-vector columns, coalesced, and keeps
//   everything it multiplies with in registers:
//   * one CTA per (row block, tile of 8 columns of v); CTAs of one block
//     are adjacent in launch order, so that for k > 8 the band's re-reads
//     can come from L2;
//   * the CTA stages its (3r x 8) window of v once in shared memory
//     (column-major, rows padded so both the store and the 16-byte loads
//     are free of bank conflicts), then every lane copies the window rows
//     it will need into registers: lane L of a warp owns window columns
//     w = (32 s + L) * VEC + j, one 16-byte chunk of a band row per step
//     s (VEC = 4 f32 or 8 bf16 values);
//   * each warp streams whole band rows, two at a time for more loads in
//     flight: per row a lane issues STEPS 16-byte loads (consecutive lanes
//     on consecutive addresses) and VEC * STEPS * 8 FMAs into 8 f32
//     accumulators, one per output column;
//   * a transposing butterfly (9 shuffles instead of 8 x 5) sums the 8
//     accumulators over the 32 lanes; lanes 4c..4c+3 end up with one
//     column each and one of them writes it. Each row block owns its
//     output rows, so there are no atomics and the result is
//     deterministic.
//   r <= 128 (the only band the reference sends to its kernel). Tensor
//   cores, TMA and double-buffering are later work.
// ---------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBandThreads = 256;            // 8 warps
constexpr int kBandWarps = kBandThreads / 32;
constexpr int kBandKT = 8;                   // fat-vector columns per CTA
constexpr int kBandRows = 2;                 // band rows per warp step
constexpr int kBandMaxR = 128;
constexpr int kWinLd = 3 * kBandMaxR + 4;    // window row stride (floats)

__device__ __forceinline__ float band_to_f32(float x) { return x; }
__device__ __forceinline__ float band_to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T band_from_f32(float x);
template <>
__device__ __forceinline__ float band_from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 band_from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// A 16-byte chunk of a band row as floats.
__device__ __forceinline__ void unpack(const uint4& q, float (&x)[4]) {
  x[0] = __uint_as_float(q.x);
  x[1] = __uint_as_float(q.y);
  x[2] = __uint_as_float(q.z);
  x[3] = __uint_as_float(q.w);
}
__device__ __forceinline__ void unpack(const uint4& q, float (&x)[8]) {
  const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(u[i] << 16);  // lower address first
    x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// Sum each of the 8 accumulators over the warp. Three halving exchanges
// (16, 8, 4) trade half of the remaining columns with the partner lane,
// then two plain ones (2, 1) finish: lane L returns the full sum of column
// 4 * bit4(L) + 2 * bit3(L) + bit2(L).
__device__ __forceinline__ float reduce8(const float (&a)[8], int lane) {
  const unsigned full = 0xffffffffu;
  const bool u16 = lane & 16, u8 = lane & 8, u4 = lane & 4;
  float b4[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = u16 ? a[i] : a[i + 4];
    const float keep = u16 ? a[i + 4] : a[i];
    b4[i] = keep + __shfl_xor_sync(full, send, 16);
  }
  float b2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = u8 ? b4[i] : b4[i + 2];
    const float keep = u8 ? b4[i + 2] : b4[i];
    b2[i] = keep + __shfl_xor_sync(full, send, 8);
  }
  float y =
      (u4 ? b2[1] : b2[0]) + __shfl_xor_sync(full, u4 ? b2[0] : b2[1], 4);
  y += __shfl_xor_sync(full, y, 2);
  y += __shfl_xor_sync(full, y, 1);
  return y;
}

template <typename T>
__global__ void __launch_bounds__(kBandThreads)
band_kernel(const T* __restrict__ band, const T* __restrict__ v,
            T* __restrict__ out, int r, int m, int n, int k, int n_kt) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int STEPS = (3 * kBandMaxR / VEC + 31) / 32;
  __shared__ __align__(16) float win[kBandKT * kWinLd];

  const int b = blockIdx.x / n_kt;
  const int k0 = (blockIdx.x - b * n_kt) * kBandKT;
  const int w3 = 3 * r;
  const int lane = threadIdx.x & 31;

  // The (3r x 8) window of v, column-major, zero outside [0, n) x [0, k).
  const long long g0 = static_cast<long long>(b - 1) * r;
  for (int t = threadIdx.x; t < w3 * kBandKT; t += kBandThreads) {
    const int w = t / kBandKT;
    const int kk = t - w * kBandKT;
    const long long g = g0 + w;
    float x = 0.f;
    if (g >= 0 && g < n && k0 + kk < k) x = band_to_f32(v[g * k + k0 + kk]);
    win[kk * kWinLd + w] = x;
  }
  __syncthreads();

  // This lane's window rows, in registers for the whole block.
  float wv[STEPS][VEC][kBandKT];
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int w0 = (s * 32 + lane) * VEC;
#pragma unroll
    for (int kk = 0; kk < kBandKT; ++kk) {
#pragma unroll
      for (int j = 0; j < VEC; j += 4) {
        float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
        if (w0 < w3)
          q = *reinterpret_cast<const float4*>(&win[kk * kWinLd + w0 + j]);
        wv[s][j][kk] = q.x;
        wv[s][j + 1][kk] = q.y;
        wv[s][j + 2][kk] = q.z;
        wv[s][j + 3][kk] = q.w;
      }
    }
  }

  const T* blk = band + static_cast<size_t>(b) * r * w3;
  const long long row0 = static_cast<long long>(b) * r;
  // Output column of this lane after reduce8.
  const int col = ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 +
                  ((lane >> 2) & 1);
  for (int i0 = (threadIdx.x >> 5) * kBandRows; i0 < r;
       i0 += kBandWarps * kBandRows) {
    if (row0 + i0 >= m) break;  // warp-uniform: rows ascend
    uint4 q[kBandRows][STEPS];
#pragma unroll
    for (int h = 0; h < kBandRows; ++h) {
#pragma unroll
      for (int s = 0; s < STEPS; ++s) {
        const int w0 = (s * 32 + lane) * VEC;
        q[h][s] = make_uint4(0u, 0u, 0u, 0u);
        if (i0 + h < r && w0 < w3)
          q[h][s] = __ldg(reinterpret_cast<const uint4*>(
              blk + static_cast<size_t>(i0 + h) * w3 + w0));
      }
    }
#pragma unroll
    for (int h = 0; h < kBandRows; ++h) {
      float acc[kBandKT];
#pragma unroll
      for (int kk = 0; kk < kBandKT; ++kk) acc[kk] = 0.f;
#pragma unroll
      for (int s = 0; s < STEPS; ++s) {
        float a[VEC];
        unpack(q[h][s], a);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
#pragma unroll
          for (int kk = 0; kk < kBandKT; ++kk)
            acc[kk] = fmaf(a[j], wv[s][j][kk], acc[kk]);
        }
      }
      const float y = reduce8(acc, lane);
      const long long row = row0 + i0 + h;
      if ((lane & 3) == 0 && i0 + h < r && row < m && k0 + col < k)
        out[row * k + k0 + col] = band_from_f32<T>(y);
    }
  }
}

template <typename T>
cudaError_t launch_band(const void* band, const void* v, void* out, int nb,
                        int r, int m, int n, int k, cudaStream_t stream) {
  const int n_kt = (k + kBandKT - 1) / kBandKT;
  band_kernel<T><<<nb * n_kt, kBandThreads, 0, stream>>>(
      static_cast<const T*>(band), static_cast<const T*>(v),
      static_cast<T*>(out), r, m, n, k, n_kt);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// B5. band (nb, r, 3r) and v (n, k) contiguous, both f32 (dtype 0) or
// both bf16 (dtype 1); out (m, k) of the same dtype, m <= nb * r. Requires
// r % 8 == 0, r <= 128, k >= 1 and a 16-byte aligned band (checked by the
// wrapper, and r here again).
int band_launch(const void* band, const void* v, void* out, int nb, int r,
                int m, int n, int k, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r % 8 != 0 || r > kBandMaxR || r <= 0 || k < 1 || nb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_band<float>(band, v, out, nb, r, m, n, k, st);
  } else if (dtype == 1) {
    err = launch_band<__nv_bfloat16>(band, v, out, nb, r, m, n, k, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
