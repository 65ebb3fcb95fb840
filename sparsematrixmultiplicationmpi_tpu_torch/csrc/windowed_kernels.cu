// Hopper (sm_90a) kernels of the windowed tile-pair SpMM main path.
//
// Built with nvcc into a shared library with a plain C interface and
// loaded with ctypes (ops/_kernel_lib.py); the Python wrappers live in
// ops/cuda_windowed.py, each beside its plain PyTorch version. Every
// entry point launches on the stream it is given, allocates nothing and
// returns cudaGetLastError() so the wrapper can raise on a refused launch.
//
// ---------------------------------------------------------------------
// B1  tmulti_launch  — replaces sparsematrixmultiplicationmpi_tpu/ops/
//     pallas_windowed.py:_kernel_tmulti (wrapper windowed_matmul_tmulti).
//
//   out_t[b] (k8 x R) = sum over pairs p of block b of
//                       slab[pair_chunk[p]] (k8 x C) . tiles_t[p] (C x R)
//   split3: sh.th + sh.tl + sl.th with bf16 hi/lo planes, f32 accumulation.
//   fuse:   the block's sum is written as the next chain state, bf16
//           [hi | lo] along the last axis (k8 x 2R), instead of f32.
//
//   The TPU kernel walks the pair list on one sequential grid and
//   flushes an SMEM-tracked accumulator when the block changes. Here one
//   CTA owns one output block b (and a <= 32-row slice of k8 and a
//   <= 128-column slice of R) and walks its own pair run
//   [block_ptr[b], block_ptr[b+1]): no cross-CTA reduction, no atomics,
//   a deterministic result, and a block with an empty run writes zeros.
//
//   What bounds it on the H100: per cop20k iterate it streams tiles_t
//   (10,288 pairs x 256 x 128 bf16 = 674 MB; >= 0.2 ms at 3.35 TB/s) and
//   computes 32.4 GFLOP of split3 products. On CUDA-core f32 FMAs
//   (67 TFLOP/s) that is >= 0.5 ms of compute; this kernel runs the
//   products on the tensor cores instead (mma.sync m16n8k16, bf16 in,
//   f32 accumulate: exact products, like the TPU's DEFAULT-precision
//   dots), which leaves the tile stream as the bound. The design keeps
//   that stream moving: a pair's tile goes to shared memory 128
//   contraction rows at a time (64 KB for both planes) with cp.async, 16
//   bytes a thread and all in flight at once, next to its slab rows
//   (17 KB); two CTAs share an SM, so one computes while the other
//   loads. Rows are padded by 16 bytes so ldmatrix (tile, transposed)
//   and the 32-bit slab fragment loads are free of bank conflicts. Each
//   of the 8 warps owns 16 output columns and all 32 rows: per 16-deep
//   step it loads 2 x 2 slab fragments and 2 x 2 tile fragments and
//   issues 12 mma (sh.th, sh.tl, sl.th for 2 x 2 output tiles). TMA,
//   wgmma and a deeper pipeline are later work.
//
// B2  chunk_slabs_launch — replaces pallas_windowed.py:chunk_slabs (its
//     Pallas relayout body).
//
//   (pad_rows, k) -> (n_chunks, k, C): each C-row chunk of the fat
//   vector transposed; with split, bf16 hi = rn(x), lo = rn(x - hi),
//   packed [hi | lo] along the last axis (n_chunks, k, 2C).
//
//   What bounds it: pure data movement (15.5 MB read, 15.5 MB written on
//   cop20k at k = 32; ~10 us at HBM rate). One CTA per 128-row x 32-column
//   tile of a chunk: reads coalesced along k, transposes through padded
//   shared memory (stride 33, no bank conflicts), writes coalesced along C.
// ---------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kCB = 128;   // contraction rows (of C) staged per step
constexpr int kKS = 32;    // k8 rows per CTA (two m16 tiles)
constexpr int kRS = 128;   // R columns per CTA (8 warps x 16)
constexpr int kPad = 8;    // bf16 row padding: 16 bytes
constexpr int kTileLd = kRS + kPad;  // staged tile row stride (bf16)
constexpr int kSlabLd = kCB + kPad;  // staged slab row stride (bf16)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Two k16 x n8 B fragments (n-tiles n0 and n0 + 8) from a row-major
// [k][n] bf16 tile: rows k0 + (lane % 16), transposed on load.
__device__ __forceinline__ void ldmatrix_b(const __nv_bfloat16* tile, int ld,
                                           int k0, int n0, int lane,
                                           unsigned (&b)[2][2]) {
  const __nv_bfloat16* p = tile + (k0 + (lane & 15)) * ld + n0 +
                           ((lane >> 4) << 3);
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0][0]), "=r"(b[0][1]), "=r"(b[1][0]), "=r"(b[1][1])
      : "r"(a));
}

// The m16 x k16 A fragment at rows m0.., columns k0.. of a row-major
// [m][k] bf16 slab.
__device__ __forceinline__ void load_a(const __nv_bfloat16* slab, int ld,
                                       int m0, int k0, int lane,
                                       unsigned (&a)[4]) {
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* p = slab + (m0 + g) * ld + k0 + 2 * t;
  a[0] = *reinterpret_cast<const unsigned*>(p);
  a[1] = *reinterpret_cast<const unsigned*>(p + 8 * ld);
  a[2] = *reinterpret_cast<const unsigned*>(p + 8);
  a[3] = *reinterpret_cast<const unsigned*>(p + 8 * ld + 8);
}

__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool SPLIT>
constexpr int tmulti_smem_bytes() {
  return (SPLIT ? 2 : 1) * (kCB * kTileLd + kKS * kSlabLd) *
         static_cast<int>(sizeof(__nv_bfloat16));
}

template <bool SPLIT, bool FUSE>
__global__ void __launch_bounds__(kThreads, 2)
tmulti_kernel(const int* __restrict__ block_ptr,
              const int* __restrict__ pair_chunk,
              const __nv_bfloat16* __restrict__ tiles_t,
              const __nv_bfloat16* __restrict__ slabs,
              void* __restrict__ out, int C, int R, int k8) {
  constexpr int planes = SPLIT ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  // s_tile[plane][c][r] (stride kTileLd), s_slab[plane][kk][c] (stride
  // kSlabLd), both bf16.
  __nv_bfloat16* s_tile = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_slab = s_tile + planes * kCB * kTileLd;

  const int b = blockIdx.x;
  const int k_base = blockIdx.y * kKS;
  const int r_base = blockIdx.z * kRS;
  const int ks = min(kKS, k8 - k_base);   // multiple of 8
  const int rs = min(kRS, R - r_base);    // multiple of 8
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int n0 = (tid >> 5) * 16;         // this warp's first column
  const bool active = n0 < rs;

  // Slab rows [ks, kKS) stay zero: their outputs are computed and
  // dropped, so a k8 that is not a multiple of 16 needs no other case.
  for (int i = tid; i < planes * kKS * kSlabLd; i += kThreads) {
    s_slab[i] = __float2bfloat16_rn(0.f);
  }

  float acc[2][2][4];  // [m-tile][n-tile][fragment]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;

  const size_t tile_elems = static_cast<size_t>(planes) * C * R;
  const size_t slab_elems = static_cast<size_t>(k8) * planes * C;
  const int vec_per_row = rs / 8;
  const int p_end = block_ptr[b + 1];
  for (int p = block_ptr[b]; p < p_end; ++p) {
    const __nv_bfloat16* tile = tiles_t + static_cast<size_t>(p) * tile_elems;
    const __nv_bfloat16* slab =
        slabs + static_cast<size_t>(pair_chunk[p]) * slab_elems;
    for (int c0 = 0; c0 < C; c0 += kCB) {
      __syncthreads();  // the previous step's reads are done
      // Tile rows [c0, c0 + kCB) of each plane, columns [r_base, +rs).
      for (int i = tid; i < planes * kCB * vec_per_row; i += kThreads) {
        const int row = i / vec_per_row;  // plane * kCB + c
        const int v = i % vec_per_row;
        const int plane = row / kCB;
        const int c = row % kCB;
        cp_async16(s_tile + row * kTileLd + v * 8,
                   tile + (static_cast<size_t>(plane) * C + c0 + c) * R +
                       r_base + v * 8);
      }
      // Slab rows [k_base, +ks), columns [c0, +kCB) of each plane.
      constexpr int kVecPerSlabRow = kCB / 8;
      for (int i = tid; i < planes * ks * kVecPerSlabRow; i += kThreads) {
        const int row = i / kVecPerSlabRow;  // plane * ks + kk
        const int v = i % kVecPerSlabRow;
        const int plane = row / ks;
        const int kk = row % ks;
        cp_async16(s_slab + (plane * kKS + kk) * kSlabLd + v * 8,
                   slab + static_cast<size_t>(k_base + kk) * planes * C +
                       plane * C + c0 + v * 8);
      }
      cp_async_wait_all();
      __syncthreads();
      if (active) {
#pragma unroll 2
        for (int k0 = 0; k0 < kCB; k0 += 16) {
          unsigned th[2][2], ah[2][4];
          ldmatrix_b(s_tile, kTileLd, k0, n0, lane, th);
          load_a(s_slab, kSlabLd, 0, k0, lane, ah[0]);
          load_a(s_slab, kSlabLd, 16, k0, lane, ah[1]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) mma(acc[mt][nt], ah[mt], th[nt]);
          if (SPLIT) {
            unsigned tl[2][2], al[2][4];
            ldmatrix_b(s_tile + kCB * kTileLd, kTileLd, k0, n0, lane, tl);
            load_a(s_slab + kKS * kSlabLd, kSlabLd, 0, k0, lane, al[0]);
            load_a(s_slab + kKS * kSlabLd, kSlabLd, 16, k0, lane, al[1]);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int nt = 0; nt < 2; ++nt) {
                mma(acc[mt][nt], ah[mt], tl[nt]);
                mma(acc[mt][nt], al[mt], th[nt]);
              }
          }
        }
      }
    }
  }
  if (!active) return;
  // Fragment (mt, nt, j): row mt*16 + g + 8*(j/2), column n0 + nt*8 + 2t
  // + (j%2); each thread writes column pairs.
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = mt * 16 + g + 8 * h;
        const int rc = n0 + nt * 8 + 2 * t;
        if (kk >= ks || rc >= rs) continue;
        const float x0 = acc[mt][nt][2 * h], x1 = acc[mt][nt][2 * h + 1];
        const size_t row = static_cast<size_t>(b) * k8 + k_base + kk;
        const int r = r_base + rc;
        if (FUSE) {
          // Next chain state: bf16 hi | lo along the last axis, (nb, k8, 2R).
          __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(out) +
                             row * (2 * R);
          const __nv_bfloat16 h0 = __float2bfloat16_rn(x0);
          const __nv_bfloat16 h1 = __float2bfloat16_rn(x1);
          *reinterpret_cast<__nv_bfloat162*>(o + r) = __halves2bfloat162(h0, h1);
          *reinterpret_cast<__nv_bfloat162*>(o + R + r) = __halves2bfloat162(
              __float2bfloat16_rn(x0 - __bfloat162float(h0)),
              __float2bfloat16_rn(x1 - __bfloat162float(h1)));
        } else {
          float* o = reinterpret_cast<float*>(out) + row * R;
          *reinterpret_cast<float2*>(o + r) = make_float2(x0, x1);
        }
      }
}

template <bool SPLIT, bool FUSE>
cudaError_t launch_tmulti(const int* block_ptr, const int* pair_chunk,
                          const __nv_bfloat16* tiles_t,
                          const __nv_bfloat16* slabs, void* out, int nb,
                          int C, int R, int k8, cudaStream_t stream) {
  constexpr int smem = tmulti_smem_bytes<SPLIT>();
  // The dynamic shared-memory limit is a per-device attribute of each
  // variant: set it at a device's first launch, not at every launch.
  static std::atomic<uint64_t> configured{0};  // bit d: device d is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (bit == 0 || !(configured.load() & bit)) {
    err = cudaFuncSetAttribute(tmulti_kernel<SPLIT, FUSE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    configured.fetch_or(bit);
  }
  const dim3 grid(nb, (k8 + kKS - 1) / kKS, (R + kRS - 1) / kRS);
  tmulti_kernel<SPLIT, FUSE><<<grid, kThreads, smem, stream>>>(
      block_ptr, pair_chunk, tiles_t, slabs, out, C, R, k8);
  return cudaGetLastError();
}

constexpr int kTC = 128;  // B2 tile: chunk rows
constexpr int kTK = 32;   // B2 tile: fat-vector columns

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // exact: x came from a bf16
}

// mode SPLIT: T = float in, bf16 [hi | lo] out; otherwise T in, T out.
template <bool SPLIT, typename T>
__global__ void __launch_bounds__(kThreads)
chunk_slabs_kernel(const T* __restrict__ v, void* __restrict__ out, int C,
                   int k) {
  __shared__ float s[kTC][kTK + 1];
  const int chunk = blockIdx.x;
  const int k0 = blockIdx.y * kTK;
  const int c0 = blockIdx.z * kTC;
  const int kw = min(kTK, k - k0);
  const T* src = v + (static_cast<size_t>(chunk) * C + c0) * k + k0;
  for (int i = threadIdx.x; i < kTC * kw; i += kThreads) {
    const int c = i / kw;
    const int kk = i % kw;
    s[c][kk] = to_f32<T>(src[static_cast<size_t>(c) * k + kk]);
  }
  __syncthreads();
  const int w = SPLIT ? 2 * C : C;
  for (int i = threadIdx.x; i < kw * kTC; i += kThreads) {
    const int kk = i / kTC;
    const int c = i % kTC;
    const float x = s[c][kk];
    const size_t o = (static_cast<size_t>(chunk) * k + k0 + kk) * w + c0 + c;
    if (SPLIT) {
      __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(out);
      const __nv_bfloat16 hi = __float2bfloat16_rn(x);
      dst[o] = hi;
      dst[o + C] = __float2bfloat16_rn(x - __bfloat162float(hi));
    } else {
      reinterpret_cast<T*>(out)[o] = from_f32<T>(x);
    }
  }
}

template <bool SPLIT, typename T>
cudaError_t launch_chunk_slabs(const void* v, void* out, int n_chunks, int C,
                               int k, cudaStream_t stream) {
  const dim3 grid(n_chunks, (k + kTK - 1) / kTK, C / kTC);
  chunk_slabs_kernel<SPLIT, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(v), out, C, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// B1. block_ptr (nb + 1) and pair_chunk (P) int32; tiles_t (P, planes*C,
// R) bf16; slabs (n_chunks, k8, planes*C) bf16; out (nb, k8, R) f32, or
// (nb, k8, 2R) bf16 with fuse (split only). Requires C % 128 == 0, R % 8 == 0,
// k8 % 8 == 0 and 16-byte aligned tiles_t (checked by the wrapper).
int tmulti_launch(const void* block_ptr, const void* pair_chunk,
                  const void* tiles_t, const void* slabs, void* out, int nb,
                  int C, int R, int k8, int split, int fuse, void* stream) {
  const int* bp = static_cast<const int*>(block_ptr);
  const int* pc = static_cast<const int*>(pair_chunk);
  const __nv_bfloat16* t = static_cast<const __nv_bfloat16*>(tiles_t);
  const __nv_bfloat16* s = static_cast<const __nv_bfloat16*>(slabs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (split) {
    err = fuse ? launch_tmulti<true, true>(bp, pc, t, s, out, nb, C, R, k8, st)
               : launch_tmulti<true, false>(bp, pc, t, s, out, nb, C, R, k8,
                                            st);
  } else if (!fuse) {
    err = launch_tmulti<false, false>(bp, pc, t, s, out, nb, C, R, k8, st);
  } else {
    err = cudaErrorInvalidValue;  // the one-plane state is a plain cast
  }
  return static_cast<int>(err);
}

// B2. v (n_chunks * C, k) contiguous. mode 0: f32 in, bf16 [hi | lo] out
// (n_chunks, k, 2C); mode 1: f32 -> f32 (n_chunks, k, C); mode 2: bf16 ->
// bf16 (n_chunks, k, C). Requires C % 128 == 0.
int chunk_slabs_launch(const void* v, void* out, int n_chunks, int C, int k,
                       int mode, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (mode == 0) {
    err = launch_chunk_slabs<true, float>(v, out, n_chunks, C, k, st);
  } else if (mode == 1) {
    err = launch_chunk_slabs<false, float>(v, out, n_chunks, C, k, st);
  } else if (mode == 2) {
    err = launch_chunk_slabs<false, __nv_bfloat16>(v, out, n_chunks, C, k,
                                                   st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Text of a CUDA error code returned by the entry points above.
const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
