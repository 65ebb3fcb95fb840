// Hopper (sm_90a) kernel of the ELL spill's explicit-gather route.
//
// Built with the other csrc/*.cu files into one shared library with a
// plain C interface (ops/_kernel_lib.py); the Python wrappers live in
// ops/cuda_gather.py beside their plain PyTorch versions. The entry
// points launch on the stream they are given, allocate nothing and
// return cudaGetLastError() so the wrapper can raise on a refused launch.
//
// ---------------------------------------------------------------------
// B7  ell_gather_launch / ell_gather_bucketed_launch — replaces
//     sparsematrixmultiplicationmpi_tpu/ops/pallas_gather.py:_kernel
//     (wrapper ell_gather_rows_pallas; callers ops/ell.py::_spmm_ell_dma
//     and stack_bucketed, the spill route of spmm_bucketed and of the
//     windowed _finish).
//
//   out[r, :] = sum_w vals[r, w] * v[cols[r, w], :]   over ELL rows,
//   f32 in, f32 accumulation, f32 out (rows, k), k <= 128.
//   ell_gather_launch runs one plane; ell_gather_bucketed_launch runs every
//   bucket of a BucketedELL in one launch and writes them stacked, in
//   bucket order, followed by one zero row (a segment with W = 0): the
//   array the reference builds with a concatenate of per-bucket outputs.
//
//   The TPU kernel starts one row DMA per (row, slot) from the scalar
//   core into a double-buffered VMEM stage, with v padded to 128 lanes
//   and the rows to a step multiple (Mosaic's slicing rules). None of
//   that is needed here: nothing is padded and any k <= 128 runs.
//
//   What bounds it on the H100: the bytes are few (cop20k's U = 2 spill:
//   3.2 MB of cols and vals, <= 15.5 MB of distinct rows of v, 8.1 MB
//   out; <= 8 us at 3.35 TB/s), but every slot is a dependent gather of
//   one k-wide row of v (128 bytes at k = 32 f32), so the time is set by
//   how many such loads are in flight. The design keeps many in flight:
//   - lane groups of G lanes (k/4 float4s, rounded up to a power of two;
//     G = 8 at k = 32) each read one row of v, so a warp reads 32/G slots
//     at once;
//   - each lane first loads the column ids and values of a batch of 8 of
//     its slots, then the 8 rows of v, then accumulates: 8 independent
//     loads in flight per lane, 32 per warp at k = 32;
//   - a row takes a team of T groups (T a power of two, T <= 32/G), just
//     enough that one batch per lane covers its W slots, so a narrow row
//     leaves the rest of the warp to other rows (W = 2 at k = 32: four
//     rows a warp) and a wide one is spread (W = 24: one row, 4 groups);
//   - a team's partial sums are added with xor shuffles (so the sum is
//     not taken in slot order: results agree with the plain version
//     within tolerance, not bitwise);
//   - one launch covers all buckets: the per-bucket pointers, widths and
//     row offsets go in as one struct by value (__grid_constant__), so a
//     call makes no device copy, and CTA x finds its bucket by a scan of
//     the <= 17 segments' first CTAs.
//   k % 4 != 0 (or a v that is not 16-byte aligned) reads scalars instead
//   of float4s, with G = min(32, k rounded up to a power of two).
// ---------------------------------------------------------------------

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 128;
// 16 buckets and the zero row.
constexpr int kMaxSegments = 17;
// Slots a lane loads before it accumulates: float4 rows of v, scalar rows.
constexpr int kBatch4 = 8;
constexpr int kBatch1 = 4;

struct Segment {
  const int* cols;    // (rows, W) int32
  const float* vals;  // (rows, W) f32
  int W;
  int rows;
  int out_row0;   // first output row
  int team_log2;  // log2 T: slot groups per row
  int cta0;       // first CTA
};

struct Table {
  Segment seg[kMaxSegments];
  int n;
};

// VEC = 4: float4 loads, a group covers one row of v with one vector per
// lane (NQ = 1). VEC = 1: scalars, NQ columns per lane (k <= 32 NQ).
// BATCH slots per lane are loaded before any is accumulated.
template <int VEC, int NQ, int BATCH>
__global__ void __launch_bounds__(kThreads, 4)
ell_gather_kernel(const __grid_constant__ Table table,
                  const float* __restrict__ v, float* __restrict__ out, int k,
                  int group_log2) {
  const int cta = static_cast<int>(blockIdx.x);
  int s = 0;
  while (s + 1 < table.n && cta >= table.seg[s + 1].cta0) ++s;
  const Segment& sg = table.seg[s];
  const int G = 1 << group_log2;
  const int T = 1 << sg.team_log2;
  const int team_w = G * T;  // lanes per row, <= 32
  const int rows_per_warp = 32 / team_w;
  const int lane = threadIdx.x & 31;
  const int team = lane / team_w;
  const int t = (lane % team_w) / G;  // this lane's slot group
  const int gi = lane % G;            // and vector within the row of v
  const int row = ((cta - sg.cta0) * kWarps + (threadIdx.x >> 5)) *
                      rows_per_warp + team;
  const bool valid = row < sg.rows;
  const int kv = k / VEC;  // vectors per row of v

  float acc[VEC * NQ];
#pragma unroll
  for (int i = 0; i < VEC * NQ; ++i) acc[i] = 0.f;
  if (valid) {
    const int W = sg.W;
    const int* rc = sg.cols + static_cast<size_t>(row) * W;
    const float* rv = sg.vals + static_cast<size_t>(row) * W;
    for (int w0 = t; w0 < W; w0 += BATCH * T) {
      int c[BATCH];
      float a[BATCH];
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int w = w0 + j * T;
        c[j] = w < W ? __ldg(rc + w) : -1;
        a[j] = w < W ? __ldg(rv + w) : 0.f;
      }
      if constexpr (VEC == 4) {
        float4 x[BATCH];
#pragma unroll
        for (int j = 0; j < BATCH; ++j) {
          x[j] = (c[j] >= 0 && gi < kv)
                     ? __ldg(reinterpret_cast<const float4*>(
                                 v + static_cast<size_t>(c[j]) * k) +
                             gi)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int j = 0; j < BATCH; ++j) {
          acc[0] = fmaf(a[j], x[j].x, acc[0]);
          acc[1] = fmaf(a[j], x[j].y, acc[1]);
          acc[2] = fmaf(a[j], x[j].z, acc[2]);
          acc[3] = fmaf(a[j], x[j].w, acc[3]);
        }
      } else {
        float x[BATCH][NQ];
#pragma unroll
        for (int j = 0; j < BATCH; ++j)
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            const int col = gi + q * G;
            x[j][q] = (c[j] >= 0 && col < k)
                          ? __ldg(v + static_cast<size_t>(c[j]) * k + col)
                          : 0.f;
          }
#pragma unroll
        for (int j = 0; j < BATCH; ++j)
#pragma unroll
          for (int q = 0; q < NQ; ++q) acc[q] = fmaf(a[j], x[j][q], acc[q]);
      }
    }
  }
  // Every lane takes part: the slot groups of a team are lanes G apart.
  for (int off = G; off < team_w; off <<= 1) {
#pragma unroll
    for (int i = 0; i < VEC * NQ; ++i)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  }
  if (!valid || t != 0) return;
  float* dst = out + static_cast<size_t>(sg.out_row0 + row) * k;
  if constexpr (VEC == 4) {
    if (gi < kv) {
      reinterpret_cast<float4*>(dst)[gi] =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
  } else {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int col = gi + q * G;
      if (col < k) dst[col] = acc[q];
    }
  }
}

int ceil_log2(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

// segs: n rows of (cols, vals, W, rows, out_row0) as int64, on the host.
cudaError_t launch_gather(const long long* segs, int n, const float* v,
                          float* out, int k, cudaStream_t stream) {
  if (k < 1 || k > kMaxK || n < 1 || n > kMaxSegments)
    return cudaErrorInvalidValue;
  const bool vec4 = k % 4 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const int group_log2 = ceil_log2(vec4 ? k / 4 : (k < 32 ? k : 32));
  const int slots_log2 = 5 - group_log2;  // slot groups per warp
  const int batch = vec4 ? kBatch4 : kBatch1;
  Table table{};
  table.n = n;
  int ctas = 0;
  for (int i = 0; i < n; ++i) {
    const long long* row = segs + 5 * i;
    Segment& sg = table.seg[i];
    sg.cols = reinterpret_cast<const int*>(static_cast<uintptr_t>(row[0]));
    sg.vals = reinterpret_cast<const float*>(static_cast<uintptr_t>(row[1]));
    sg.W = static_cast<int>(row[2]);
    sg.rows = static_cast<int>(row[3]);
    sg.out_row0 = static_cast<int>(row[4]);
    // Groups a row needs for one batch per lane to cover its W slots.
    const int w_log2 = ceil_log2((sg.W + batch - 1) / batch);
    sg.team_log2 = w_log2 < slots_log2 ? w_log2 : slots_log2;
    sg.cta0 = ctas;
    const int rows_per_cta = kWarps * (32 >> (group_log2 + sg.team_log2));
    ctas += (sg.rows + rows_per_cta - 1) / rows_per_cta;
  }
  if (ctas == 0) return cudaSuccess;
  if (vec4) {
    ell_gather_kernel<4, 1, kBatch4><<<ctas, kThreads, 0, stream>>>(
        table, v, out, k, group_log2);
  } else {
    ell_gather_kernel<1, kMaxK / 32, kBatch1><<<ctas, kThreads, 0, stream>>>(
        table, v, out, k, group_log2);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// B7, one plane. cols (rows, W) int32, vals (rows, W) f32, v (n, k) f32,
// out (rows, k) f32, all contiguous; 1 <= k <= 128 (checked by the
// wrapper).
int ell_gather_launch(const void* cols, const void* vals, const void* v,
                      void* out, int rows, int W, int k, void* stream) {
  const long long seg[5] = {
      static_cast<long long>(reinterpret_cast<uintptr_t>(cols)),
      static_cast<long long>(reinterpret_cast<uintptr_t>(vals)), W, rows, 0};
  return static_cast<int>(launch_gather(seg, 1, static_cast<const float*>(v),
                                        static_cast<float*>(out), k,
                                        static_cast<cudaStream_t>(stream)));
}

// B7, every bucket in one launch. segs: a host array of n_seg rows of five
// int64 (cols pointer, vals pointer, W, rows, first output row); a row
// with W = 0 writes zeros. v (n, k) f32, out (sum of rows, k) f32, all
// contiguous; 1 <= k <= 128, n_seg <= 17 (checked by the wrapper).
int ell_gather_bucketed_launch(const void* segs, int n_seg, const void* v,
                               void* out, int k, void* stream) {
  return static_cast<int>(launch_gather(
      static_cast<const long long*>(segs), n_seg,
      static_cast<const float*>(v), static_cast<float*>(out), k,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
