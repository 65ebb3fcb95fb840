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
//   rows >= m are not written. f32 band: 3xTF32 on the tensor cores, each
//   operand split into a TF32 big part and the f32 rest, the products
//   big.big + big.small + small.big summed in f32 (about 2^-20 of each
//   product left out; split_tf32 below). bf16 band: the products of two
//   bf16 values are exact in f32, summed in f32, and the sum rounded to
//   bf16 once.
//
//   The TPU kernel keeps a transposed, zero-padded (k, (nb+2)r) copy of v
//   and double-buffers each block's window into VMEM by hand, with k
//   padded to a multiple of 8 — Mosaic layout rules, not semantics. Here
//   v stays in its natural (n, k) layout, the kernel masks the halo at
//   both ends itself, and any k >= 1 runs.
//
//   What bounds it on the H100: the band stream. At the CG system's shape
//   (r = 128, 947 blocks, f32) one multiply reads 186.2 MB of band:
//   >= 0.056 ms at 3.35 TB/s, plus v and the output (k = 32: 0.065 ms).
//   The band's products at k = 32 are 2.98 GFLOP: 0.045 ms of f32 FMA on
//   the CUDA cores, close to the byte bound and past it at k = 128, where
//   3xTF32 on the tensor cores costs 0.072 ms against 0.093 of bytes. So
//   the design reads every band element once for every width up to the
//   column chunk kc (the wrapper's BAND_K_CHUNK, at most 128), keeps HBM
//   busy with asynchronous copies, and multiplies on the tensor cores:
//   * one CTA per (row block, chunk of kc columns of v); the chunks of one
//     block are adjacent in launch order, so a wider k's re-reads of the
//     band can come from L2;
//   * the block's band streams through a shared-memory ring of column
//     slices (all r rows x 128 bytes of each row, one cache line), each
//     stage with the matching window rows of v (x the CTA's columns),
//     filled by 16-byte cp.async (zero-filled outside [0, n), past the
//     window and past k); three or four stages, all but one in flight
//     while one is multiplied, and two CTAs an SM;
//   * eight warps tile the (r x kc) output 4 x 2: warp (wm, wn) owns rows
//     32 wm .. 32 wm + 31 (two m16 tiles) and the n8 tiles wn, wn + 2, ...
//     of the chunk, in registers for the whole block; with one n8 tile
//     (k <= 8) they tile it 8 x 1, so every warp works. f32 operands are
//     split in registers as they are loaded (mma.sync m16n8k8 tf32, three
//     products each), bf16 ones go through ldmatrix to mma.sync m16n8k16;
//   * the kernel is built for 1, 2, 4 and 8 n8 tiles a warp, and a launch
//     takes the fewest its chunk needs: the loop over a warp's tiles,
//     unrolled for the widest chunk, slowed a narrow chunk on the card;
//   * each output element belongs to one CTA and one lane: no atomics,
//     and the result is deterministic.
//   The ring is column slices of every row rather than whole rows: whole
//   rows would leave a stage's r x kc product split across warps by
//   columns and summed again. Copying a slice as one bulk copy (TMA,
//   cp.async.bulk) per row was tried and was slower on the card: the copy
//   engine takes each 128-byte row copy as a request of its own.
//   r <= 128 (the only band the reference sends to its kernel); r % 16 ==
//   8 fills half an m16 tile, whose other rows stay zero in every stage.
//   A k whose rows are not 16-byte aligned stages v in 4-byte copies
//   (f32) or plain loads (bf16).
// ---------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

namespace {

constexpr int kBandThreads = 256;  // 8 warps
constexpr int kBandMaxR = 128;
constexpr int kBandMaxKc = 128;  // widest column chunk a CTA holds
// Shared memory a CTA may take: two CTAs an SM.
constexpr int kBandSmPerCta = 113 * 1024;

// Band columns a stage: 128 bytes of each band row, one cache line.
template <typename T>
constexpr int kBandKS = 128 / static_cast<int>(sizeof(T));

// The staged band row stride is KS + 8 elements: a 64-bit f32 fragment
// load at row g, column 2t hits banks 8g + 2t, and a bf16 row of 144 B
// puts ldmatrix's eight rows on distinct banks. The staged v row stride
// for a chunk of kcw columns: f32 4 mod 8 words, so the B loads at rows
// 2t, columns g hit distinct banks; bf16 an odd number of 16-byte units,
// for ldmatrix.trans.
template <typename T>
__host__ __device__ constexpr int band_ldv(int kcw);
template <>
__host__ __device__ constexpr int band_ldv<float>(int kcw) {
  return kcw + 4;
}
template <>
__host__ __device__ constexpr int band_ldv<__nv_bfloat16>(int kcw) {
  return (kcw + 15) / 16 * 16 + 8;
}

// Elements of one ring stage: the band slice (r rounded up to 16 rows),
// then v's KS window rows.
template <typename T>
__host__ __device__ constexpr int band_stage_elems(int r, int kcw) {
  return ((r + 15) & ~15) * (kBandKS<T> + 8) + kBandKS<T> * band_ldv<T>(kcw);
}

// n8 tiles a warp holds for a chunk of kcw columns (warps tile the chunk
// 4 x 2), and the ring's stages: four for chunks up to 32 columns, else
// three, so that two CTAs share an SM.
__host__ __device__ constexpr int band_ntw(int kcw) {
  return kcw <= 16 ? 1 : kcw <= 32 ? 2 : kcw <= 64 ? 4 : 8;
}
__host__ __device__ constexpr int band_stages(int ntw) {
  return ntw <= 2 ? 4 : 3;
}

template <typename T>
constexpr int band_smem_bytes(int r, int kcw) {
  return band_stages(band_ntw(kcw)) * band_stage_elems<T>(r, kcw) *
         static_cast<int>(sizeof(T));
}

static_assert(band_smem_bytes<float>(kBandMaxR, 32) <= kBandSmPerCta &&
                  band_smem_bytes<float>(kBandMaxR, 40) <= kBandSmPerCta &&
                  band_smem_bytes<float>(kBandMaxR, kBandMaxKc) <=
                      kBandSmPerCta,
              "f32 ring over two CTAs' share of an SM");
static_assert(
    band_smem_bytes<__nv_bfloat16>(kBandMaxR, 32) <= kBandSmPerCta &&
        band_smem_bytes<__nv_bfloat16>(kBandMaxR, kBandMaxKc) <=
            kBandSmPerCta,
    "bf16 ring over two CTAs' share of an SM");

// 16 bytes global -> shared, or 16 zero bytes where `in` is false.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// One element of v's window, where its rows are not 16-byte aligned: a
// 4-byte copy (zero-filled where `in` is false) for f32, a plain load for
// bf16 (no 2-byte cp.async).
__device__ __forceinline__ void stage_elem(float* dst, const float* src,
                                           bool in) {
  cp_async4(dst, src, in);
}
__device__ __forceinline__ void stage_elem(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           bool in) {
  *dst = in ? *src : zero_of<__nv_bfloat16>();
}

// x = big + small: big is x rounded to tf32 (10 mantissa bits) to
// nearest, ties away from zero (cvt.rna.tf32.f32's rounding of a finite
// x, in two integer operations); small = x - big is exact, and the tensor
// core reads its top 19 bits (tf32 by truncation), |error| <= 2^-21 |x|.
// big . big + big . small + small . big then leaves ~2^-20 of each product
// out. Every operand element is split on its way to the tensor cores, so
// this is the kernel's largest ALU cost: three operations an element. A
// NaN or infinite x leaves a NaN in small, so the product is NaN.
__device__ __forceinline__ void split_tf32(float x, unsigned& big,
                                           unsigned& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// Not volatile: the scheduler may interleave independent products.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The m16 x k16 A fragment at rows m0.., columns k0.. of a row-major
// [m][k] bf16 tile in shared memory.
__device__ __forceinline__ void ldmatrix_a(const __nv_bfloat16* tile, int ld,
                                           int m0, int k0, int lane,
                                           unsigned (&a)[4]) {
  const __nv_bfloat16* p =
      tile + (m0 + (lane & 15)) * ld + k0 + ((lane >> 4) << 3);
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(s));
}

// The k16 x n8 B fragment (mma's col layout) at rows k0.., columns n0..
// of a row-major [k][n] bf16 tile: transposed as it is loaded, so each
// register is two neighbouring k of one column.
__device__ __forceinline__ void ldmatrix_b_trans(const __nv_bfloat16* tile,
                                                 int ld, int k0, int n0,
                                                 int lane, unsigned (&b)[2]) {
  const __nv_bfloat16* p = tile + (k0 + (lane & 15)) * ld + n0;
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(b[0]), "=r"(b[1])
      : "r"(s));
}

// One warp's products for one ring stage: its m16 tiles (rows m0 and,
// where two, m0 + 16) against the n8 tiles wn + 2j below nt_cta.
template <int NTW>
__device__ __forceinline__ void band_stage_mma(
    const float* sa, const float* sv, int ldv, int m0, bool two, int wn,
    int nt_cta, int lane, float (&acc)[2][NTW][4]) {
  constexpr int KS = kBandKS<float>, LDA = KS + 8;
  const int g = lane >> 2, t = lane & 3;
  const float* ap = sa + (m0 + g) * LDA + 2 * t;
  const float* bp = sv + 2 * t * ldv + g + wn * 8;
#pragma unroll
  for (int kk = 0; kk < KS; kk += 8) {
    // In each 8-column step, staged columns 2t and 2t + 1 serve as mma's
    // k = t and t + 4 in both operands (the same permutation of the
    // sum's terms), so each A fragment pair is one 64-bit load.
    // A (m16 x k8, row): (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4).
    unsigned ab[2][4], as[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (i == 1 && !two) continue;
      const float* a = ap + i * 16 * LDA + kk;
      const float2 lo = *reinterpret_cast<const float2*>(a);
      const float2 hi = *reinterpret_cast<const float2*>(a + 8 * LDA);
      split_tf32(lo.x, ab[i][0], as[i][0]);
      split_tf32(hi.x, ab[i][1], as[i][1]);
      split_tf32(lo.y, ab[i][2], as[i][2]);
      split_tf32(hi.y, ab[i][3], as[i][3]);
    }
    // B (k8 x n8, col): (k = t, n = g), (t + 4, g) = v rows 2t, 2t + 1.
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      if (wn + 2 * j >= nt_cta) continue;
      const float* b = bp + kk * ldv + 16 * j;
      unsigned bb[2], bs[2];
      split_tf32(b[0], bb[0], bs[0]);
      split_tf32(b[ldv], bb[1], bs[1]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (i == 1 && !two) continue;
        mma_tf32(acc[i][j], as[i], bb);
        mma_tf32(acc[i][j], ab[i], bs);
        mma_tf32(acc[i][j], ab[i], bb);
      }
    }
  }
}

template <int NTW>
__device__ __forceinline__ void band_stage_mma(
    const __nv_bfloat16* sa, const __nv_bfloat16* sv, int ldv, int m0,
    bool two, int wn, int nt_cta, int lane, float (&acc)[2][NTW][4]) {
  constexpr int KS = kBandKS<__nv_bfloat16>, LDA = KS + 8;
#pragma unroll
  for (int kk = 0; kk < KS; kk += 16) {
    unsigned a[2][4];
    ldmatrix_a(sa, LDA, m0, kk, lane, a[0]);
    if (two) ldmatrix_a(sa, LDA, m0 + 16, kk, lane, a[1]);
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      if (wn + 2 * j >= nt_cta) continue;
      unsigned b[2];
      ldmatrix_b_trans(sv, ldv, kk, (wn + 2 * j) * 8, lane, b);
      mma_bf16(acc[0][j], a[0], b);
      if (two) mma_bf16(acc[1][j], a[1], b);
    }
  }
}

// out[row, col .. col + 1] of a row of k columns (col even).
__device__ __forceinline__ void store_pair(float* o, float x, float y,
                                           bool both, bool pair) {
  if (pair) {
    *reinterpret_cast<float2*>(o) = make_float2(x, y);
  } else {
    o[0] = x;
    if (both) o[1] = y;
  }
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* o, float x,
                                           float y, bool both, bool pair) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(x, y);
  } else {
    o[0] = __float2bfloat16_rn(x);
    if (both) o[1] = __float2bfloat16_rn(y);
  }
}

template <typename T, int NTW>
__global__ void __launch_bounds__(kBandThreads, 2)
band_kernel(const T* __restrict__ band, const T* __restrict__ v,
            T* __restrict__ out, int r, int m, int n, int k, int kc,
            int n_kc, int kcw, bool vec16) {
  constexpr int STAGES = band_stages(NTW);
  constexpr int KS = kBandKS<T>, LDA = KS + 8;
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  constexpr int CPR = KS / VEC;  // 16-byte copies per band row slice (8)
  constexpr int AQ = kBandMaxR * CPR / kBandThreads;  // of them a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int b = blockIdx.x / n_kc;
  const int k0 = (blockIdx.x - b * n_kc) * kc;
  const int ldv = band_ldv<T>(kcw);
  const int a_elems = ((r + 15) & ~15) * LDA;
  const int stage_elems = band_stage_elems<T>(r, kcw);
  const int w3 = 3 * r;
  const int n_steps = (w3 + KS - 1) / KS;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const T* blk = band + static_cast<size_t>(b) * r * w3;
  const long long g0 = static_cast<long long>(b - 1) * r;

  // Band rows [r, r rounded up to 16) of every stage are never copied and
  // stay zero (r % 16 == 8 fills half an m16 tile).
  const int r16 = (r + 15) & ~15;
  if (r16 != r) {
    const int pad = (r16 - r) * LDA;
    for (int i = tid; i < STAGES * pad; i += kBandThreads) {
      const int s = i / pad;
      smem[s * stage_elems + r * LDA + (i - s * pad)] = zero_of<T>();
    }
  }

  // Each thread's copies, the same at every stage but for the columns:
  // band rows tid / CPR + 32 q, 16-byte chunk tid % CPR of the slice; v's
  // (window row, chunk) i / vpr, i % vpr for i = tid + 256 q.
  const int a_col = (tid % CPR) * VEC;
  const T* a_src = blk + static_cast<size_t>(tid / CPR) * w3 + a_col;
  const int a_dst = (tid / CPR) * LDA + a_col;
  const int vpr = kcw / VEC;
  int v_w[AQ], v_c[AQ];
#pragma unroll
  for (int q = 0; q < AQ; ++q) {
    const int i = tid + q * kBandThreads;
    v_w[q] = i / vpr;
    v_c[q] = (i - v_w[q] * vpr) * VEC;
  }
  const int vcols = min(kcw, k - k0);

  // Stage s: band columns [s * KS, +KS) of every row, and v's window rows
  // (b - 1) r + s * KS .. + KS, columns k0 .. k0 + kcw; zeros outside the
  // window, outside [0, n) and past k.
  auto load = [&](int s) {
    T* sa = smem + (s % STAGES) * stage_elems;
    T* sv = sa + a_elems;
    const int c0 = s * KS;
    const bool a_in = c0 + a_col < w3;
#pragma unroll
    for (int q = 0; q < AQ; ++q) {
      if (tid / CPR + 32 * q >= r) break;
      cp_async16(sa + a_dst + 32 * q * LDA,
                 a_in ? a_src + static_cast<size_t>(32 * q) * w3 + c0 : blk,
                 a_in);
    }
    const long long gs = g0 + c0;  // v's row at window row c0
    if (vec16) {
#pragma unroll
      for (int q = 0; q < AQ; ++q) {
        if (v_w[q] >= KS) break;
        const long long gr = gs + v_w[q];
        const bool in = c0 + v_w[q] < w3 && gr >= 0 && gr < n &&
                        v_c[q] < vcols;
        cp_async16(sv + v_w[q] * ldv + v_c[q],
                   in ? v + gr * k + k0 + v_c[q] : v, in);
      }
    } else {
      for (int i = tid; i < KS * kcw; i += kBandThreads) {
        const int w = i / kcw, c = i - w * kcw;
        const long long gr = gs + w;
        const bool in = c0 + w < w3 && gr >= 0 && gr < n && c < vcols;
        stage_elem(sv + w * ldv + c, in ? v + gr * k + k0 + c : v, in);
      }
    }
  };

  // n8 tiles of this CTA's columns. Warps tile the output 4 x 2: warp
  // (wm, wn) owns rows 32 wm .. + 32 (two m16 tiles) and the n8 tiles wn,
  // wn + 2, ...; with one n8 tile (k <= 8), 8 x 1: one m16 tile each.
  const int nt_cta = (vcols + 7) >> 3;
  const bool one_tile = nt_cta == 1;
  const int wn = one_tile ? 0 : warp & 1;
  const int m0 = one_tile ? 16 * warp : 32 * (warp >> 1);
  const bool two = !one_tile && m0 + 16 < r;
  const bool busy = m0 < r && wn < nt_cta;
  float acc[2][NTW][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // Stages 0 .. STAGES - 2 in flight first; one (maybe empty) group each.
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_steps) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<STAGES - 2>();  // stage s has landed, for this thread
    // ... for every thread; and all are done with stage s - 1, so its slot
    // takes stage s + STAGES - 1 while this one is multiplied.
    __syncthreads();
    if (s + STAGES - 1 < n_steps) load(s + STAGES - 1);
    cp_async_commit();
    if (busy) {
      const T* sa = smem + (s % STAGES) * stage_elems;
      band_stage_mma<NTW>(sa, sa + a_elems, ldv, m0, two, wn, nt_cta, lane,
                          acc);
    }
  }
  cp_async_wait<0>();
  if (!busy) return;

  // Fragment e of tile (i, j): row m0 + 16 i + g + 8 (e / 2), column
  // (wn + 2j) * 8 + 2t + e % 2.
  const int g = lane >> 2, t = lane & 3;
  const bool pair = (k & 1) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (i == 1 && !two) continue;
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const int col = k0 + (wn + 2 * j) * 8 + 2 * t;
      if (wn + 2 * j >= nt_cta || col >= k) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + 16 * i + g + 8 * h;
        const long long orow = static_cast<long long>(b) * r + row;
        if (row >= r || orow >= m) continue;
        store_pair(out + orow * k + col, acc[i][j][2 * h],
                   acc[i][j][2 * h + 1], col + 1 < k, pair);
      }
    }
  }
}

// The dynamic shared-memory limit is a per-device attribute of each
// kernel: set it at a device's first launch, not at every launch.
template <typename Kernel>
cudaError_t set_smem_once(Kernel kernel, int smem,
                          std::atomic<uint64_t>& configured) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (bit == 0 || !(configured.load() & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured.fetch_or(bit);
  }
  return cudaSuccess;
}

template <typename T, int NTW>
cudaError_t launch_band_ntw(const void* band, const void* v, void* out,
                            int nb, int r, int m, int n, int k, int kc,
                            int kcw, cudaStream_t stream) {
  static std::atomic<uint64_t> configured{0};
  cudaError_t err =
      set_smem_once(band_kernel<T, NTW>, kBandSmPerCta, configured);
  if (err != cudaSuccess) return err;
  const int n_kc = (k + kc - 1) / kc;
  const bool vec16 = (static_cast<long long>(k) * sizeof(T)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(v) % 16 == 0;
  band_kernel<T, NTW>
      <<<nb * n_kc, kBandThreads, band_smem_bytes<T>(r, kcw), stream>>>(
          static_cast<const T*>(band), static_cast<const T*>(v),
          static_cast<T*>(out), r, m, n, k, kc, n_kc, kcw, vec16);
  return cudaGetLastError();
}

// The column chunk a CTA stages: kc, or k rounded up to 8 where smaller.
int band_kcw(int k, int kc) { return std::min(kc, (k + 7) / 8 * 8); }

template <typename T>
cudaError_t launch_band(const void* band, const void* v, void* out, int nb,
                        int r, int m, int n, int k, int kc,
                        cudaStream_t stream) {
  const int kcw = band_kcw(k, kc);
  switch (band_ntw(kcw)) {
    case 1:
      return launch_band_ntw<T, 1>(band, v, out, nb, r, m, n, k, kc, kcw,
                                   stream);
    case 2:
      return launch_band_ntw<T, 2>(band, v, out, nb, r, m, n, k, kc, kcw,
                                   stream);
    case 4:
      return launch_band_ntw<T, 4>(band, v, out, nb, r, m, n, k, kc, kcw,
                                   stream);
    default:
      return launch_band_ntw<T, 8>(band, v, out, nb, r, m, n, k, kc, kcw,
                                   stream);
  }
}

}  // namespace

extern "C" {

// B5. band (nb, r, 3r) and v (n, k) contiguous, both f32 (dtype 0) or
// both bf16 (dtype 1); out (m, k) of the same dtype, m <= nb * r. kc is
// the column chunk a CTA holds (the wrapper's BAND_K_CHUNK): a multiple
// of 8 up to 128. Requires r % 8 == 0, r <= 128, k >= 1, nb * ceil(k / kc)
// CTAs in an int, and a 16-byte aligned band (checked by the wrapper, and
// the shapes here again).
int band_launch(const void* band, const void* v, void* out, int nb, int r,
                int m, int n, int k, int kc, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r % 8 != 0 || r > kBandMaxR || r <= 0 || k < 1 || nb < 1 ||
      kc % 8 != 0 || kc < 8 || kc > kBandMaxKc ||
      static_cast<long long>(nb) * ((k + kc - 1) / kc) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_band<float>(band, v, out, nb, r, m, n, k, kc, st);
  } else if (dtype == 1) {
    err = launch_band<__nv_bfloat16>(band, v, out, nb, r, m, n, k, kc, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Dynamic shared memory of B5's launch for these shapes (bytes), or -1
// for shapes band_launch refuses.
int band_smem(int r, int k, int kc, int dtype) {
  if (r % 8 != 0 || r > kBandMaxR || r <= 0 || k < 1 || kc % 8 != 0 ||
      kc < 8 || kc > kBandMaxKc)
    return -1;
  if (dtype == 0) return band_smem_bytes<float>(r, band_kcw(k, kc));
  if (dtype == 1) return band_smem_bytes<__nv_bfloat16>(r, band_kcw(k, kc));
  return -1;
}

}  // extern "C"
