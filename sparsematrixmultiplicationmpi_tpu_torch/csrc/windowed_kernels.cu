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
//                       slab[pair_chunk[p]] (k8 x C) . tile_t[p] (C x R)
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
//   The tile operand is the compact plane (formats/windowed.py::
//   CompactTiles), not the dense tiles: per tile, column-major by output
//   column r, each nonzero's contraction index c (uint8, int16 past C =
//   256) and its bf16 hi | lo bits in one 32-bit word, with per-tile
//   column offsets (uint16 while C * R <= 65535, else int32). The dense
//   tiles of the cop20k main path are 98.4 % zeros (2.62 M nonzeros in
//   10,288 tiles of 128 x 128, 255 a tile on average): 674 MB a multiply
//   against ~13 MB of entries.
//
//   What bounds it on the H100: bytes, each input read once and the
//   output written once: on cop20k at k = 32 the entries and offsets
//   (~16 MB), the slabs (15.5 MB) and the fused state (15.5 MB), ~47 MB,
//   >= 0.014 ms at 3.35 TB/s; its 0.34 GFLOP of f32 FMAs (two per
//   entry and k, below) take >= 0.005 ms on the CUDA cores. The work a
//   CTA really does is larger: it stages every pair's whole slab (k8 x
//   2C, 16 KB) from L2 into shared memory, 169 MB a multiply, and each
//   entry costs shared loads (its record, the slab words of its c) and
//   two FMAs for each of the k8 rows. On the H100 the instructions of
//   the walk set the time: three CTAs an SM hide one another's copies
//   from L2, and the SM issues ~2 of its 4 instructions a cycle. Each
//   instruction taken from an entry's path moved B1 by ~1 % (PERF.md).
//
//   Design. The CTA walks windows of up to kCap entries of its columns,
//   a pair at a time (a denser tile takes several windows). Per window
//   it stages the slab transposed and interleaved, word [c][kk] = hi |
//   lo << 16, kk XOR-swizzled by multiples of 4 so that both the copy's
//   stores and the reads of one c are free of bank conflicts, and one
//   record per entry: the tile bits, and in one word the byte offset of
//   its c's words in the slab with the entry's column above it (written
//   as two half-words, by the entry's thread and the column's). 32
//   workers of eight lanes then split the window's entries into even
//   runs, each moved to a column start so that no column is shared (each
//   column thread finds the workers whose share begins in its column
//   with one division, no search), and walk them two entries at a time:
//   a lane holds four rows kk, so one 64-bit shared load brings an
//   entry's record and one 128-bit load the lane's four slab words at the
//   record's offset XOR the lane's rows, and one warp instruction serves
//   four entries; a running sum per column is added to the column's
//   accumulator in shared memory when the column changes. While every
//   worker of a warp has two entries left, none is checked against its
//   run's end. So the work is balanced whatever the tile's column counts
//   (2 per column on average, at most 26), and the sums are the same, bit
//   for bit, whatever the split. split3's sh.th + sh.tl + sl.th is summed
//   as sh.(th + tl) + sl.th: th + tl is the tile's f32 value, exact, so
//   the products are the same with one rounding fewer. The next window's
//   slab unit, entries and column bounds are loaded into registers while
//   a window is computed, the run's pair indices sit in shared memory,
//   and two stage buffers let one barrier per window separate a buffer's
//   reads from its next writes. Registers set the shape: three CTAs an SM
//   leave 80 a thread, and a wider batch or deeper prefetch spills.
//
//   Copying each pair's slab through a ring of shared-memory stages ahead
//   of the walk was built and measured three ways, all bit for bit the
//   same and all slower (bench/probe_b1_variants.py, PERF.md): producer
//   warps beside the walkers, fed through registers (they spill and wait
//   out the copy, 0.125-0.131 ms against 0.121) or by one bulk copy a
//   pair into landing buffers (0.129-0.138; two CTAs an SM fit), and all
//   warps transposing from bulk-copied landing buffers at three CTAs an
//   SM (0.129): the copy from shared memory costs more instructions than
//   the copy from registers, and no latency was left to hide.
//
//   Stored zeros are never multiplied: an Inf or NaN in the fat vector
//   reaches only the outputs of the entries that read it, as in a CSR
//   product (the TPU kernel's dense dot spreads it over the whole tile).
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
//
// B6  tmulti_phased_launch — replaces pallas_windowed.py:
//     _kernel_tmulti_resident (via _phase_call and
//     windowed_matmul_tmulti_phased).
//
//   B1's math over a PHASE-major pair list: phase i covers pairs
//   [pair_off_i, +n_i), chunk window [chunk_lo_i, +cpp) and row blocks
//   [block_lo_i, +nb_ph_i); its block and chunk ids are phase-local. The
//   output is one (k8 x R) f32 partial per (phase, local block), in phase
//   order; the wrapper adds the partials of each block in phase order
//   (deterministic, no atomics).
//
//   The TPU kernel holds a phase's whole slab window in VMEM, loaded once
//   per phase call. On the H100 a window (7.3 MB on cop20k at k = 32) is
//   far past the 228 KB of shared memory of an SM but fits the 50 MB L2,
//   so here "resident" means resident in L2 by access order: one launch
//   covers every phase, CTA x is the x-th (phase, local block) in phase
//   order, so the CTAs in flight at any time work on one or two phases'
//   windows and re-read their slabs from L2. Inside a CTA the work is
//   B1's: the same device function on the phase layout's compact plane
//   (the streamed route runs B1 on each phase's slice of it), so the two
//   routes agree bit for bit. Same bound as B1 (the phase layout's
//   dummies add no entries).
//
// B3  natural_compact_launch split — replaces pallas_windowed.py:
//     _kernel_split3 (wrapper windowed_matmul_split3).
// B4  natural_compact_launch one plane (bf16), natural_launch mode 2
//     (f32) — replace pallas_windowed.py:_kernel_plain (wrapper
//     windowed_matmul_pallas).
//
//   Natural layout: out[b] (R x k8, f32) = sum over the pairs p of block b
//   of tile[p] (R x C) . slab[pair_chunk[p]]^T (slab k8 x C). B3: bf16
//   hi|lo planes of both operands, th.sh + tl.sh + th.sl with f32
//   accumulation (summed as sh.(th + tl) + sl.th, as in B1). B4 bf16: one
//   bf16 plane, f32 accumulation. B4 f32 (mode 2): f32 tiles and slabs at
//   f32 accuracy (the reference's Precision.HIGHEST).
//
//   The TPU grid walks two pairs per step and zeroes the output block on
//   its first step, so the build pads each block's run to even length.
//   Here one CTA owns (block b, <= 128 tile rows r, <= 32 columns of k)
//   and walks b's run [block_ptr[b], block_ptr[b+1]): even runs are not
//   needed (the wrapper still checks the reference's even pair count), an
//   empty run writes zeros, and there are no atomics.
//
//   B3 and B4 bf16 read the compact plane of the natural tiles
//   (formats/windowed.py::CompactTiles with natural): a natural tile
//   (R x C) is the transpose of a B1 tile (C x R), and the plane stores
//   entries by output index r, then c, so it is exactly B1's plane of the
//   transposed tiles, and the body is B1's (tmulti_block) with a natural
//   epilogue: lane kk of a warp writes out[b][r][k_base + kk], 128
//   contiguous bytes per r. The dense tiles of the cop20k U = 2 routes are
//   98-99 % zeros: f32 (R = C = 256, 2,270 split tiles) 595 MB for 2.32 M
//   entries, bf16 (R = C = 512, 1,098 tiles) 576 MB for 2.44 M entries.
//
//   What bounds them on the H100: bytes, each input read once and the
//   output written once: the compact plane (~13.9 MB f32, ~12.0 MB bf16),
//   the slabs (15.5 MB f32 split, 7.8 MB bf16) and the output (15.5 MB),
//   ~45 MB >= 0.0134 ms (B3) and ~35 MB >= 0.0105 ms (B4 bf16) at 3.35
//   TB/s; their f32 FMAs (two per entry and k for B3, one for B4) take
//   less on the CUDA cores. As for B1, the work a CTA really does is
//   larger: it stages each pair's whole slab (32 KB at these shapes) from
//   L2 for ~500 entries of its rows. At C = 256 split or C = 512 bf16 a
//   CTA takes 99,616 B of shared memory, so two CTAs share an SM
//   (kNaturalCtas), and each thread may hold 128 registers: the whole
//   next slab is prefetched into registers while a window is computed
//   (kNaturalPrefetch), where B1 (three CTAs an SM) prefetches an eighth
//   of it. A pair with no entry in the CTA's rows (the even-run padding,
//   a tile whose entries lie in the other 128-row slice) is skipped
//   without staging. Stored zeros are never multiplied: an Inf or NaN in
//   the fat vector reaches only the outputs of the entries that read it,
//   as in a CSR product (the TPU kernels' dense dots spread it over the
//   whole tile).
//
//   The compact kernel stages at most kCMax = 512 columns. A chunk wider
//   than that (a caller may pin chunk_cols) keeps its dense natural
//   planes on the card (WindowedPairs.to), and natural_launch modes 0 and
//   1 run the dense kernel natural_kernel on them: the tiles on the
//   tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate), staged in
//   128-column K-slices by cp.async, each of 8 warps owning 16 tile rows
//   and all <= 32 columns of k; R = 8 fills half an m16 tile, the other
//   rows zero in shared memory. Its bound is the dense tile stream.
//
//   What bounds mode 2: the f32 tile stream, 626 MB per cop20k U = 2
//   multiply (2,270 x 256 x 256 x 4 B of tiles, plus slabs and output):
//   >= 0.187 ms at 3.35 TB/s. Its 9.5 GFLOP on the CUDA cores' f32 FMAs
//   (67 TFLOP/s) alone would take >= 0.142 ms, and a CUDA-core kernel
//   also pays the shared-memory traffic of its operand loads, so the
//   products go to the tensor cores in 3xTF32: each operand is split,
//   big = rna_tf32(x), small = rna_tf32(x - big), and mma.sync m16n8k8
//   tf32 (f32 accumulate) issues big.big + big.small + small.big:
//   products to ~2^-21 relative, 28.6 GFLOP, >= 0.058 ms at the TF32
//   peak, so the stream stays the bound. (One TF32 product, ~2^-11
//   relative, would not hold the f32 tier.) The layout is mode 0's
//   without any transposition: the f32 tile is mma's row-major A, the
//   f32 slab its col-layout B. 32-column K-slices (128 x 32 f32 of tile,
//   32 x 32 of slab) go through a three-stage ring with 16-byte
//   cp.async, so two slices load while one computes, and two CTAs share
//   an SM. Splitting costs instructions (two cvt and a subtract per
//   value), and split at every fragment load they, not the bytes, set
//   the time: all 8 warps would split the same slab values. So each
//   thread splits the slab values it copied as they land, into a big and
//   a small plane of the stage, and the warps load both; only the tile's
//   values, which one warp reads, are split at fragment load. In each
//   8-column step, staged columns 2t and 2t + 1 serve as mma's k = t and
//   t + 4 for both operands, so a fragment pair is one 64-bit load; rows
//   are padded by 8 floats, so those loads hit banks 8g + 2t, free of
//   conflicts. big.big goes to two accumulators, alternating by k-step,
//   and the two cross terms (2^-11 smaller) to a third, issued apart: the
//   sums that carry the result take a sixth of the steps of one shared
//   accumulator (the tensor cores' f32 accumulation does not round to
//   nearest, so its error grows with the number of steps).
// ---------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <cstring>
#include <type_traits>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 8;        // bf16 row padding of the natural kernels

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- B1 / B6: the compact tile plane ----------------------------------

constexpr int kCKS = 32;                // k8 rows per CTA
constexpr int kCCols = 16;              // output columns per warp (epilogue)
constexpr int kCRS = kWarps * kCCols;   // output columns per CTA
constexpr int kQ = 4;                   // k8 rows a lane holds in the walk
constexpr int kWorkerLanes = kCKS / kQ; // a worker: lanes for all k8 rows
constexpr int kWorkers = kThreads / kWorkerLanes;  // each walks its own run
constexpr int kBatch = 2;               // entries a worker loads at once
constexpr int kCMax = 512;              // widest chunk a CTA stages
constexpr int kCap = 1024;              // entries of a pair a CTA stages
constexpr int kSeg = 64;                // pair indices a CTA holds at once
constexpr int kTmultiCtas = 3;          // CTAs per SM (launch bounds)
// Whether B1 and B6 skip the pairs with no entry in a CTA's columns
// without staging them: their operands have few, and the check at each
// pair boundary cost B1 1.7 % (bench/probe_b1_variants.py).
constexpr bool kTmultiSkip = false;
// B3 / B4 bf16 on the compact natural plane (tmulti_natural_kernel): the
// same body at R, C = 256 (split) or 512 (bf16), where a CTA's 99,616 B of
// shared memory leave room for two CTAs an SM, so up to 128 registers a
// thread: more entries a batch, and the whole 32 KB slab of a window
// prefetched into registers (kNaturalPrefetch bytes a thread). Their
// operands hold many pairs with nothing in a CTA's rows (the even-run
// padding, tiles filled in one 128-row slice only), which they skip.
constexpr int kNaturalCtas = 2;
constexpr int kNaturalBatch = 4;
constexpr int kNaturalPrefetch = 128;
constexpr bool kNaturalSkip = true;

// What the body writes: B1's (nb, k8, R) f32, its fused next chain state
// (nb, k8, 2R) bf16 [hi | lo], or the natural (nb, R, k8) f32 of B3 / B4.
enum Out { kOutT, kOutFused, kOutNatural };

// The compact plane (formats/windowed.py::CompactTiles): pair_nz_ptr
// (P + 1) int32 global entry offsets, col_ptr (P, R + 1) ColT offsets
// within the pair, rows (nnz) RowT contraction indices, vals (nnz) Word
// (bf16 hi | lo << 16 with split, else one bf16).
struct Compact {
  const int* nz_ptr;
  const void* col_ptr;
  const void* rows;
  const void* vals;
};

// A staged slab value or an entry: bf16 hi | lo << 16 (split), or bf16.
template <bool SPLIT>
struct WordOf {
  using T = uint16_t;
};
template <>
struct WordOf<true> {
  using T = uint32_t;
};

// One staged window: the slab (C x kCKS words), kCap 8-byte entry
// records and the workers' run bounds (kWorkers + 1, padded to 16 B).
template <bool SPLIT>
__host__ __device__ constexpr int window_bytes(int C) {
  return C * kCKS * static_cast<int>(sizeof(typename WordOf<SPLIT>::T)) +
         kCap * 8 + (kWorkers + 4) * 4;
}

// Two window buffers, the accumulators and the pair indices.
template <bool SPLIT>
constexpr int tmulti_smem_bytes(int C) {
  return 2 * window_bytes<SPLIT>(C) + kCRS * kCKS * 4 + kSeg * 16;
}

// An N-byte vector: one shared-memory load or store.
template <int N>
struct Bits;
template <>
struct Bits<4> {
  using T = uint32_t;
};
template <>
struct Bits<8> {
  using T = uint2;
};
template <>
struct Bits<16> {
  using T = uint4;
};

// A lane's kQ staged slab words at byte offset `at` of the slab (a
// multiple of kQ words).
template <typename Word>
__device__ __forceinline__ void load_words(const unsigned char* s,
                                           unsigned at, Word (&w)[kQ]) {
  using V = typename Bits<kQ * sizeof(Word)>::T;
  const V v = *reinterpret_cast<const V*>(s + at);
  memcpy(w, &v, sizeof v);
}

// run[j] += s[j] . t for a lane's staged slab words s[j] and an entry's
// tile bits t. split3, sh.th + sh.tl + sl.th, is summed as sh.(th + tl)
// + sl.th: th + tl, the bf16 split of one f32 value, is that value, exact
// in f32, so the products are the same and one rounding fewer.
__device__ __forceinline__ void fma_words(const uint32_t (&s)[kQ], int t,
                                          float (&run)[kQ]) {
  const float th = __uint_as_float(static_cast<uint32_t>(t) << 16);
  const float ts =
      th + __uint_as_float(static_cast<uint32_t>(t) & 0xffff0000u);
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    run[j] = fmaf(__uint_as_float(s[j] << 16), ts, run[j]);
    run[j] = fmaf(__uint_as_float(s[j] & 0xffff0000u), th, run[j]);
  }
}

__device__ __forceinline__ void fma_words(const uint16_t (&s)[kQ], int t,
                                          float (&run)[kQ]) {
  const float th = __uint_as_float(static_cast<uint32_t>(t) << 16);
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    run[j] = fmaf(__uint_as_float(static_cast<uint32_t>(s[j]) << 16), th,
                  run[j]);
  }
}

// acc[j] += run[j], j < kQ (one vector load and store), and run = 0.
__device__ __forceinline__ void flush_run(float* acc, float (&run)[kQ]) {
  using V = typename Bits<kQ * 4>::T;
  V v = *reinterpret_cast<V*>(acc);
  float f[kQ];
  memcpy(f, &v, sizeof v);
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    f[j] += run[j];
    run[j] = 0.f;
  }
  memcpy(&v, f, sizeof v);
  *reinterpret_cast<V*>(acc) = v;
}

// The staged slab is c-major, s[c][kk] for the 32 rows kk of the CTA's
// k8 slice, with kk XOR-swizzled by the 8-column group of c: the 32 lanes
// reading one c (one per kk) and the stores of a copy step each hit 32
// distinct banks.
__device__ __forceinline__ int swizzled(int c, int kk) {
  return c * kCKS + (kk ^ ((c >> 1) & 0x1c));
}

// One staging unit: 16 columns of one slab row, in two 8-column groups
// (c0 and c0 + C / 2) so that the lanes of a row read it contiguously,
// 16 bytes each; hi and lo planes for split slabs.
struct Unit {
  uint4 h0, h1, l0, l1;
};

// Staging units a thread holds for `bytes` of slab (at least one): a
// unit is 16 columns of both planes (64 B) with SPLIT, else of one (32 B).
template <bool SPLIT>
__host__ __device__ constexpr int units_of(int bytes) {
  return bytes < (SPLIT ? 128 : 64) ? 1 : bytes / (SPLIT ? 64 : 32);
}

template <bool SPLIT>
__device__ __forceinline__ Unit load_unit(const __nv_bfloat16* row, int c0,
                                          int C) {
  Unit u{};
  u.h0 = __ldg(reinterpret_cast<const uint4*>(row + c0));
  u.h1 = __ldg(reinterpret_cast<const uint4*>(row + c0 + C / 2));
  if constexpr (SPLIT) {
    u.l0 = __ldg(reinterpret_cast<const uint4*>(row + C + c0));
    u.l1 = __ldg(reinterpret_cast<const uint4*>(row + C + c0 + C / 2));
  }
  return u;
}

// 8 columns from c of one plane (or hi | lo << 16 of two) into s.
template <bool SPLIT>
__device__ __forceinline__ void store_group(typename WordOf<SPLIT>::T* s,
                                            int c, int kk, uint4 h,
                                            uint4 l) {
  const unsigned hw[4] = {h.x, h.y, h.z, h.w};
  const unsigned lw[4] = {l.x, l.y, l.z, l.w};
  const int at = swizzled(c, kk);  // the group shares one swizzle
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (SPLIT) {
      s[at + 2 * i * kCKS] = __byte_perm(hw[i], lw[i], 0x5410);
      s[at + (2 * i + 1) * kCKS] = __byte_perm(hw[i], lw[i], 0x7632);
    } else {
      s[at + 2 * i * kCKS] = static_cast<uint16_t>(hw[i] & 0xffffu);
      s[at + (2 * i + 1) * kCKS] = static_cast<uint16_t>(hw[i] >> 16);
    }
  }
}

template <bool SPLIT>
__device__ __forceinline__ void store_unit(typename WordOf<SPLIT>::T* s,
                                           int c0, int kk, int C,
                                           const Unit& u) {
  store_group<SPLIT>(s, c0, kk, u.h0, u.l0);
  store_group<SPLIT>(s, c0 + C / 2, kk, u.h1, u.l1);
}

// hi = rn(x), lo = rn(x - hi): the bits of the fused chain state.
__device__ __forceinline__ void split_rn(float x, unsigned& hi,
                                         unsigned& lo) {
  const __nv_bfloat16 h = __float2bfloat16_rn(x);
  hi = __bfloat16_as_ushort(h);
  lo = __bfloat16_as_ushort(__float2bfloat16_rn(x - __bfloat162float(h)));
}

// A staged window in shared memory (window_bytes): the slab, one record
// per entry and the workers' run bounds split[0..kWorkers]. A record is
// the entry's tile bits and, in one word, the byte offset of its c's
// kQ-word groups in the slab (swizzled, below 2^16) with the entry's
// column above it, so the walk takes both from one load.
template <bool SPLIT>
struct Window {
  typename WordOf<SPLIT>::T* slab;
  int2* rec;
  int* split;

  __device__ static Window at(unsigned char* base, int C) {
    using Word = typename WordOf<SPLIT>::T;
    Window w;
    w.slab = reinterpret_cast<Word*>(base);
    w.rec = reinterpret_cast<int2*>(w.slab + C * kCKS);
    w.split = reinterpret_cast<int*>(w.rec + kCap);
    return w;
  }
};

// The window a CTA is on: pair q of the run [.., p_end), CTA-relative
// entry w0 of it. The run's pair indices sit in shared memory kSeg at a
// time (s_idx): the global offset of the pair's first entry, its chunk,
// and the pair-relative offsets of the CTA's first and past-last entry.
// Uniform over the CTA.
template <bool SKIP, typename ColT>
struct Cursor {
  int4* s_idx;
  const int* nz_ptr;
  const int* pair_chunk;
  const ColT* col_ptr;
  int p_end, R, r_base, rs;
  int seg0, q, w0;

  __device__ void load_seg() {
    for (int i = threadIdx.x; i < kSeg && seg0 + i < p_end; i += kThreads) {
      const int p = seg0 + i;
      const ColT* cp = col_ptr + static_cast<size_t>(p) * (R + 1) + r_base;
      s_idx[i] = make_int4(__ldg(nz_ptr + p), __ldg(pair_chunk + p),
                           __ldg(cp), __ldg(cp + rs));
    }
  }
  // Stage the indices from pair q on and, with SKIP, advance q past the
  // pairs with no entry in the CTA's columns (the build's padding pairs,
  // and tiles whose entries all lie in other column slices).
  __device__ void start(int p_begin) {
    seg0 = q = p_begin;
    w0 = 0;
    load_seg();
    __syncthreads();
    find_pair();
  }
  __device__ void find_pair() {
    for (; q < p_end; ++q) {
      if (q >= seg0 + kSeg) {  // past the staged indices
        __syncthreads();
        seg0 = q;
        load_seg();
        __syncthreads();
      }
      if (!SKIP) break;
      const int4 y = s_idx[q - seg0];
      if (y.w > y.z) break;
    }
  }
  __device__ int4 idx() const { return s_idx[q - seg0]; }
  // The pair's next window, or the next pair with entries.
  __device__ void next(int4 x) {
    w0 += kCap;
    if (w0 >= x.w - x.z) {
      w0 = 0;
      ++q;
      find_pair();
    }
  }
};

// A window's staging by the CTA's threads (this one t): PRE staging units
// a thread (unit u = t + i kThreads: slab row u / upr, columns from (u %
// upr) * 8), its share of the entries and, for thread r < rs, the bounds
// of column r's entries (CTA-relative) are loaded into registers while
// the previous window is walked (load), then written as the window
// (store): the rest of a wider slab is copied as it is stored.
template <bool SPLIT, int PRE, typename ColT, typename RowT>
struct Stager {
  using Word = typename WordOf<SPLIT>::T;
  static constexpr int kPer = kCap / kThreads;  // entries a thread stages
  const __nv_bfloat16* slabs;
  Compact tiles;
  int chunk_base, C, R, k8, k_base, ks, r_base, rs, t;
  Unit unit[PRE];
  int u_kk[PRE], u_c[PRE];
  int e_c[kPer], e_t[kPer], col_a, col_b;

  __device__ void init() {
    const int upr = C / 16;
#pragma unroll
    for (int i = 0; i < PRE; ++i) {
      const int u = t + i * kThreads;
      u_kk[i] = u < kCKS * upr ? u / upr : kCKS;
      u_c[i] = (u % upr) * 8;
    }
  }
  __device__ const __nv_bfloat16* slab_of(int chunk, int kk) const {
    return slabs + ((static_cast<size_t>(chunk_base) + chunk) * k8 + k_base +
                    kk) * (static_cast<size_t>(SPLIT ? 2 : 1) * C);
  }
  __device__ void load(int q, int4 x, int w0) {
#pragma unroll
    for (int i = 0; i < PRE; ++i) {
      if (u_kk[i] < ks) {
        unit[i] = load_unit<SPLIT>(slab_of(x.y, u_kk[i]), u_c[i], C);
      }
    }
    const RowT* __restrict__ rows = static_cast<const RowT*>(tiles.rows);
    const Word* __restrict__ vals = static_cast<const Word*>(tiles.vals);
    const int n = min(x.w - x.z - w0, kCap);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = t + i * kThreads;
      if (e < n) {
        e_c[i] = __ldg(rows + x.x + x.z + w0 + e);
        e_t[i] = __ldg(vals + x.x + x.z + w0 + e);
      }
    }
    if (t < rs) {
      const ColT* cp = static_cast<const ColT*>(tiles.col_ptr) +
                       static_cast<size_t>(q) * (R + 1) + r_base;
      col_a = static_cast<int>(__ldg(cp + t)) - x.z;
      col_b = static_cast<int>(__ldg(cp + t + 1)) - x.z;
    }
  }
  __device__ void store(const Window<SPLIT>& w, int4 x, int w0) const {
#pragma unroll
    for (int i = 0; i < PRE; ++i) {
      if (u_kk[i] < ks) store_unit<SPLIT>(w.slab, u_c[i], u_kk[i], C, unit[i]);
    }
    const int upr = C / 16;
    for (int u = t + PRE * kThreads; u < kCKS * upr; u += kThreads) {
      const int kk = u / upr, c0 = (u % upr) * 8;
      if (kk < ks) {
        store_unit<SPLIT>(w.slab, c0, kk, C,
                          load_unit<SPLIT>(slab_of(x.y, kk), c0, C));
      }
    }
    // Each record's low half-word (the slab offset) and tile bits by the
    // entry's thread, its high half-word (the column) by the column's.
    const int m = min(x.w - x.z - w0, kCap);  // the window's entries
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = t + i * kThreads;
      if (e < m) {
        const int c = e_c[i];
        reinterpret_cast<uint16_t*>(w.rec + e)[0] = static_cast<uint16_t>(
            (c * kCKS + ((c >> 1) & 0x1c)) * sizeof(Word));
        w.rec[e].y = e_t[i];
      }
    }
    // Worker v's even share begins at entry s(v) = ceil(v m / kWorkers).
    if (t < rs) {
      // Column t's entries in the window, [a, b): their column, and the
      // start of every worker whose share begins inside them (the next
      // column start, so that no column is split between workers): those
      // v from the first with s(v) >= a, floor((a - 1) kWorkers / m) + 1,
      // while s(v) < b.
      const int a = max(col_a - w0, 0), b = min(col_b - w0, m);
      for (int e = a; e < b; ++e) {
        reinterpret_cast<uint16_t*>(w.rec + e)[1] = static_cast<uint16_t>(t);
      }
      if (a < b) {
        for (int v = a == 0 ? 0 : (a - 1) * kWorkers / m + 1; v < kWorkers;
             ++v) {
          const int s = (v * m + kWorkers - 1) / kWorkers;
          if (s >= b) break;
          w.split[v] = s == a ? a : b;
        }
      }
    }
    // And the shares that begin past the last entry.
    if (t <= kWorkers && (t * m + kWorkers - 1) / kWorkers >= m) {
      w.split[t] = m;
    }
  }
};

// Worker tid / kWorkerLanes (lanes kWorkerLanes w.., rows kk = kq..kq +
// kQ - 1 of lane kq / kQ) walks its run of a staged window BATCH entries
// at a time; one shared load brings an entry's record (slab offset and
// column), one more a lane its kQ slab words (the swizzle keeps them
// contiguous). A running sum per column is added to the column's
// accumulator in s_acc when the column changes.
template <bool SPLIT, int BATCH>
__device__ __forceinline__ void walk_window(const Window<SPLIT>& w,
                                            float* s_acc, int tid) {
  using Word = typename WordOf<SPLIT>::T;
  const int lane = tid & 31;
  const int kq = kQ * (lane % kWorkerLanes);
  const unsigned kq_at = kq * sizeof(Word);  // the lane's rows, in bytes
  const unsigned char* slab = reinterpret_cast<const unsigned char*>(w.slab);
  int e = w.split[tid / kWorkerLanes];
  const int end = w.split[tid / kWorkerLanes + 1];
  int prev = e < end ? static_cast<unsigned>(w.rec[e].x) >> 16 : -1;
  float run[kQ] = {};
  // BATCH entries from e; with CHECKED, only those before the run's end.
  auto step = [&](auto checked) {
    constexpr bool CHECKED = decltype(checked)::value;
    int2 r[BATCH];
    Word wd[BATCH][kQ];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      if (!CHECKED || e + i < end) r[i] = w.rec[e + i];
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      if (!CHECKED || e + i < end) {
        load_words(slab, (static_cast<unsigned>(r[i].x) & 0xffffu) ^ kq_at,
                   wd[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      if (!CHECKED || e + i < end) {
        const int cl = static_cast<unsigned>(r[i].x) >> 16;
        if (cl != prev) {  // the column changed: add its sums
          flush_run(s_acc + prev * kCKS + kq, run);
          prev = cl;
        }
        fma_words(wd[i], r[i].y, run);
      }
    }
    e += BATCH;
  };
  // While every worker of the warp has BATCH entries left, no entry is
  // checked against its run's end.
  while (__all_sync(0xffffffffu, e + BATCH <= end)) {
    step(std::false_type{});
  }
  while (__any_sync(0xffffffffu, e < end)) step(std::true_type{});
  if (prev >= 0) flush_run(s_acc + prev * kCKS + kq, run);
}

// Output block b from the accumulators (warp `warp` writes columns
// r_base + warp * kCCols..), in the layout OUT.
template <int OUT>
__device__ __forceinline__ void write_block(const float* s_acc,
                                            void* __restrict__ out, int b,
                                            int R, int k8, int tid) {
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int k_base = blockIdx.y * kCKS;
  const int ks = min(kCKS, k8 - k_base);
  const int r_base = blockIdx.z * kCRS;
  const int r0 = r_base + warp * kCCols;          // this warp's output
  const int ncol = max(0, min(kCCols, R - r0));   // columns: 0, 8 or 16
  float acc[kCCols];
#pragma unroll
  for (int j = 0; j < kCCols; ++j) {
    acc[j] = s_acc[((r0 - r_base) + j) * kCKS + lane];
  }
  if (lane >= ks || ncol == 0) return;
  if constexpr (OUT == kOutNatural) {
    // (nb, R, k8): the warp's lanes write one r's 32 columns of k, 128
    // contiguous bytes, per store.
    float* o = reinterpret_cast<float*>(out) +
               (static_cast<size_t>(b) * R + r0) * k8 + k_base + lane;
#pragma unroll
    for (int j = 0; j < kCCols; ++j) {
      if (j < ncol) o[static_cast<size_t>(j) * k8] = acc[j];
    }
    return;
  }
  const size_t row = static_cast<size_t>(b) * k8 + k_base + lane;
  if constexpr (OUT == kOutFused) {
    // Next chain state: bf16 hi | lo along the last axis, (nb, k8, 2R).
    __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(out) +
                       row * (2 * R) + r0;
#pragma unroll
    for (int j0 = 0; j0 < kCCols; j0 += 8) {
      if (j0 >= ncol) break;
      unsigned h[4], l[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        unsigned h0, l0, h1, l1;
        split_rn(acc[j0 + 2 * i], h0, l0);
        split_rn(acc[j0 + 2 * i + 1], h1, l1);
        h[i] = h0 | (h1 << 16);
        l[i] = l0 | (l1 << 16);
      }
      *reinterpret_cast<uint4*>(o + j0) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(o + R + j0) =
          make_uint4(l[0], l[1], l[2], l[3]);
    }
  } else {
    float* o = reinterpret_cast<float*>(out) + row * R + r0;
#pragma unroll
    for (int j0 = 0; j0 < kCCols; j0 += 4) {
      if (j0 >= ncol) break;
      *reinterpret_cast<float4*>(o + j0) =
          make_float4(acc[j0], acc[j0 + 1], acc[j0 + 2], acc[j0 + 3]);
    }
  }
}

// One CTA's share of an output block of B1 / B6 / B3 / B4 bf16: the
// pairs [p_begin, p_end) (indices into the compact plane and pair_chunk),
// slabs at chunk_base + pair_chunk[p], the sum written as output block `b`
// in the layout OUT. blockIdx.y / .z pick the k8 and R slices.
//
// The CTA walks windows of up to kCap entries of its columns (a tile
// with more takes several; with SKIP, a pair with none in its columns
// takes none: no staging, no barrier): per window it stages the slab and
// the records (Stager) into one of two window buffers, then the kWorkers
// workers walk it (walk_window). Software-pipelined: while one window is
// walked, PRE staging units of the next window's slab and its entries
// are in flight to registers, and the next pair's indices, so no global
// load's latency sits between two windows; one barrier per window.
template <bool SPLIT, int OUT, int BATCH, int PRE, bool SKIP,
          typename ColT, typename RowT>
__device__ __forceinline__ void tmulti_block(
    int p_begin, int p_end, const int* __restrict__ pair_chunk,
    int chunk_base, Compact tiles, const __nv_bfloat16* __restrict__ slabs,
    void* __restrict__ out, int b, int C, int R, int k8) {
  extern __shared__ __align__(16) unsigned char smem[];
  // Two window buffers, the accumulators [kCRS][kCKS], the pair indices.
  float* s_acc = reinterpret_cast<float*>(smem + 2 * window_bytes<SPLIT>(C));
  int4* s_idx = reinterpret_cast<int4*>(s_acc + kCRS * kCKS);
  const int tid = threadIdx.x;
  const int k_base = blockIdx.y * kCKS;
  const int r_base = blockIdx.z * kCRS;
  const int rs = min(kCRS, R - r_base);

  for (int i = tid; i < kCRS * kCKS; i += kThreads) s_acc[i] = 0.f;
  Cursor<SKIP, ColT> cur{s_idx, tiles.nz_ptr, pair_chunk,
                         static_cast<const ColT*>(tiles.col_ptr), p_end, R,
                         r_base, rs};
  Stager<SPLIT, PRE, ColT, RowT> st{
      slabs, tiles, chunk_base, C, R, k8, k_base, min(kCKS, k8 - k_base),
      r_base, rs, tid};
  st.init();
  cur.start(p_begin);
  if (cur.q < p_end) st.load(cur.q, cur.idx(), 0);
  for (int win = 0; cur.q < p_end; ++win) {
    const Window<SPLIT> w =
        Window<SPLIT>::at(smem + (win & 1) * window_bytes<SPLIT>(C), C);
    const int4 x = cur.idx();
    // Its last readers finished before the previous window's barrier.
    st.store(w, x, cur.w0);
    cur.next(x);
    if (cur.q < p_end) st.load(cur.q, cur.idx(), cur.w0);
    __syncthreads();
    walk_window<SPLIT, BATCH>(w, s_acc, tid);
  }
  __syncthreads();
  write_block<OUT>(s_acc, out, b, R, k8, tid);
}

// B1: CTA x owns output block x.
template <bool SPLIT, bool FUSE, typename ColT, typename RowT>
__global__ void __launch_bounds__(kThreads, kTmultiCtas)
tmulti_kernel(const int* __restrict__ block_ptr,
              const int* __restrict__ pair_chunk, Compact tiles,
              const __nv_bfloat16* __restrict__ slabs,
              void* __restrict__ out, int C, int R, int k8) {
  const int b = blockIdx.x;
  tmulti_block<SPLIT, FUSE ? kOutFused : kOutT, kBatch, 1, kTmultiSkip,
               ColT, RowT>(
      block_ptr[b], block_ptr[b + 1], pair_chunk, 0, tiles, slabs, out, b, C,
      R, k8);
}

// B6: CTA x owns the x-th (phase, local block) in phase order. Row i of
// `phases` is (pair_off, chunk_lo, first partial block, offset of the
// phase's run bounds in block_ptr_ph); block_ptr_ph holds each phase's
// nb_ph + 1 run bounds relative to its pair_off.
template <bool SPLIT, typename ColT, typename RowT>
__global__ void __launch_bounds__(kThreads, kTmultiCtas)
tmulti_phased_kernel(const int* __restrict__ phases, int n_phases,
                     const int* __restrict__ block_ptr_ph,
                     const int* __restrict__ pair_chunk_ph, Compact tiles,
                     const __nv_bfloat16* __restrict__ slabs,
                     float* __restrict__ partials, int C, int R, int k8) {
  const int x = blockIdx.x;
  int ph = 0;
  while (ph + 1 < n_phases && phases[4 * (ph + 1) + 2] <= x) ++ph;
  const int pair_off = phases[4 * ph];
  const int chunk_lo = phases[4 * ph + 1];
  const int* bp = block_ptr_ph + phases[4 * ph + 3] + (x - phases[4 * ph + 2]);
  tmulti_block<SPLIT, kOutT, kBatch, 1, kTmultiSkip, ColT, RowT>(
      pair_off + bp[0], pair_off + bp[1], pair_chunk_ph, chunk_lo, tiles,
      slabs, partials, x, C, R, k8);
}

// B3 (SPLIT) and B4 bf16: CTA x owns output block x of the natural
// layout, over the compact natural plane (the transpose of B1's).
template <bool SPLIT, typename ColT, typename RowT>
__global__ void __launch_bounds__(kThreads, kNaturalCtas)
tmulti_natural_kernel(const int* __restrict__ block_ptr,
                      const int* __restrict__ pair_chunk, Compact tiles,
                      const __nv_bfloat16* __restrict__ slabs,
                      float* __restrict__ out, int C, int R, int k8) {
  const int b = blockIdx.x;
  tmulti_block<SPLIT, kOutNatural, kNaturalBatch,
               units_of<SPLIT>(kNaturalPrefetch), kNaturalSkip, ColT, RowT>(
      block_ptr[b], block_ptr[b + 1], pair_chunk, 0, tiles, slabs, out, b, C,
      R, k8);
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

// f(ColT{}, RowT{}) for the compact plane's index widths: bit 0 of
// `wide` is an int32 col_ptr (else uint16), bit 1 int16 rows (else
// uint8).
template <typename F>
cudaError_t by_index_widths(int wide, F f) {
  switch (wide) {
    case 0: return f(uint16_t{}, uint8_t{});
    case 1: return f(int{}, uint8_t{});
    case 2: return f(uint16_t{}, int16_t{});
    case 3: return f(int{}, int16_t{});
    default: return cudaErrorInvalidValue;
  }
}

template <bool SPLIT, bool FUSE>
cudaError_t launch_tmulti(const int* block_ptr, const int* pair_chunk,
                          Compact tiles, int wide,
                          const __nv_bfloat16* slabs, void* out, int nb,
                          int C, int R, int k8, cudaStream_t stream) {
  return by_index_widths(wide, [&](auto col, auto row) {
    using ColT = decltype(col);
    using RowT = decltype(row);
    static std::atomic<uint64_t> configured{0};  // bit d: device d is set
    auto kernel = tmulti_kernel<SPLIT, FUSE, ColT, RowT>;
    cudaError_t err =
        set_smem_once(kernel, tmulti_smem_bytes<SPLIT>(kCMax), configured);
    if (err != cudaSuccess) return err;
    const dim3 grid(nb, (k8 + kCKS - 1) / kCKS, (R + kCRS - 1) / kCRS);
    kernel<<<grid, kThreads, tmulti_smem_bytes<SPLIT>(C), stream>>>(
        block_ptr, pair_chunk, tiles, slabs, out, C, R, k8);
    return cudaGetLastError();
  });
}

template <bool SPLIT>
cudaError_t launch_tmulti_natural(const int* block_ptr, const int* pair_chunk,
                                  Compact tiles, int wide,
                                  const __nv_bfloat16* slabs, float* out,
                                  int nb, int C, int R, int k8,
                                  cudaStream_t stream) {
  return by_index_widths(wide, [&](auto col, auto row) {
    using ColT = decltype(col);
    using RowT = decltype(row);
    static std::atomic<uint64_t> configured{0};
    auto kernel = tmulti_natural_kernel<SPLIT, ColT, RowT>;
    cudaError_t err =
        set_smem_once(kernel, tmulti_smem_bytes<SPLIT>(kCMax), configured);
    if (err != cudaSuccess) return err;
    const dim3 grid(nb, (k8 + kCKS - 1) / kCKS, (R + kCRS - 1) / kCRS);
    kernel<<<grid, kThreads, tmulti_smem_bytes<SPLIT>(C), stream>>>(
        block_ptr, pair_chunk, tiles, slabs, out, C, R, k8);
    return cudaGetLastError();
  });
}

template <bool SPLIT>
cudaError_t launch_tmulti_phased(const int* phases, int n_phases,
                                 const int* block_ptr_ph,
                                 const int* pair_chunk_ph, Compact tiles,
                                 int wide, const __nv_bfloat16* slabs,
                                 float* partials, int n_partials, int C,
                                 int R, int k8, cudaStream_t stream) {
  return by_index_widths(wide, [&](auto col, auto row) {
    using ColT = decltype(col);
    using RowT = decltype(row);
    static std::atomic<uint64_t> configured{0};
    auto kernel = tmulti_phased_kernel<SPLIT, ColT, RowT>;
    cudaError_t err =
        set_smem_once(kernel, tmulti_smem_bytes<SPLIT>(kCMax), configured);
    if (err != cudaSuccess) return err;
    const dim3 grid(n_partials, (k8 + kCKS - 1) / kCKS, (R + kCRS - 1) / kCRS);
    kernel<<<grid, kThreads, tmulti_smem_bytes<SPLIT>(C), stream>>>(
        phases, n_phases, block_ptr_ph, pair_chunk_ph, tiles, slabs,
        partials, C, R, k8);
    return cudaGetLastError();
  });
}

// ---- B3 / B4 bf16 on dense tiles, for chunks past kCMax ----------------

constexpr int kNRS = 128;  // tile rows per CTA (8 warps x one m16 tile)
constexpr int kNCB = 128;  // contraction columns (of C) staged per step
constexpr int kNKS = 32;   // k8 columns per CTA (four n8 tiles)
constexpr int kNLd = kNCB + kPad;  // staged tile / slab row stride (bf16)

template <bool SPLIT>
constexpr int natural_smem_bytes() {
  return (SPLIT ? 2 : 1) * (kNRS + kNKS) * kNLd *
         static_cast<int>(sizeof(__nv_bfloat16));
}

// The m16 x k16 A fragment at rows m0.., columns k0.. of a row-major
// [m][k] bf16 tile in shared memory.
__device__ __forceinline__ void ldmatrix_a(const __nv_bfloat16* tile, int ld,
                                           int m0, int k0, int lane,
                                           unsigned (&a)[4]) {
  const __nv_bfloat16* p = tile + (m0 + (lane & 15)) * ld + k0 +
                           ((lane >> 4) << 3);
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(s));
}

// The k16 x n8 B fragment (mma's col layout) at columns n0.. of a
// row-major [n][k] bf16 slab: B[k][n] = slab[n][k], so each register is
// two neighbouring k of one slab row.
__device__ __forceinline__ void load_b(const __nv_bfloat16* slab, int ld,
                                       int n0, int k0, int lane,
                                       unsigned (&b)[2]) {
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* p = slab + (n0 + g) * ld + k0 + 2 * t;
  b[0] = *reinterpret_cast<const unsigned*>(p);
  b[1] = *reinterpret_cast<const unsigned*>(p + 8);
}

template <bool SPLIT>
__global__ void __launch_bounds__(kThreads, 2)
natural_kernel(const int* __restrict__ block_ptr,
               const int* __restrict__ pair_chunk,
               const __nv_bfloat16* __restrict__ tiles,
               const __nv_bfloat16* __restrict__ slabs,
               float* __restrict__ out, int C, int R, int k8) {
  constexpr int planes = SPLIT ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  // s_tile[plane][r][c], s_slab[plane][kk][c], both bf16, stride kNLd.
  __nv_bfloat16* s_tile = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_slab = s_tile + planes * kNRS * kNLd;

  const int b = blockIdx.x;
  const int r_base = blockIdx.y * kNRS;
  const int k_base = blockIdx.z * kNKS;
  const int rs = min(kNRS, R - r_base);   // multiple of 8
  const int ks = min(kNKS, k8 - k_base);  // multiple of 8
  const int n_tiles = ks / 8;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int m0 = (tid >> 5) * 16;         // this warp's first tile row
  const bool active = m0 < rs;

  // Everything is zeroed once: tile rows [rs, kNRS) and slab rows [ks,
  // kNKS) are never loaded, so R = 8 (half an m16 tile) and k8 = 8 need
  // no other case.
  for (int i = tid; i < planes * (kNRS + kNKS) * kNLd; i += kThreads) {
    s_tile[i] = __float2bfloat16_rn(0.f);
  }

  float acc[4][4];  // [n-tile][fragment]
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nt][j] = 0.f;

  const size_t row_w = static_cast<size_t>(planes) * C;  // tile / slab row
  const size_t tile_elems = row_w * R;
  const size_t slab_elems = row_w * k8;
  constexpr int kVec = kNCB / 8;  // 16-byte vectors per staged row
  const int p_end = block_ptr[b + 1];
  for (int p = block_ptr[b]; p < p_end; ++p) {
    const __nv_bfloat16* tile = tiles + static_cast<size_t>(p) * tile_elems;
    const __nv_bfloat16* slab =
        slabs + static_cast<size_t>(pair_chunk[p]) * slab_elems;
    for (int c0 = 0; c0 < C; c0 += kNCB) {
      __syncthreads();  // the previous step's reads are done
      for (int i = tid; i < planes * rs * kVec; i += kThreads) {
        const int row = i / kVec;  // plane * rs + r
        const int v = i % kVec;
        const int plane = row / rs;
        const int r = row % rs;
        cp_async16(s_tile + (plane * kNRS + r) * kNLd + v * 8,
                   tile + (r_base + r) * row_w + plane * C + c0 + v * 8);
      }
      for (int i = tid; i < planes * ks * kVec; i += kThreads) {
        const int row = i / kVec;  // plane * ks + kk
        const int v = i % kVec;
        const int plane = row / ks;
        const int kk = row % ks;
        cp_async16(s_slab + (plane * kNKS + kk) * kNLd + v * 8,
                   slab + (k_base + kk) * row_w + plane * C + c0 + v * 8);
      }
      cp_async_wait_all();
      __syncthreads();
      if (active) {
#pragma unroll 2
        for (int k0 = 0; k0 < kNCB; k0 += 16) {
          unsigned ah[4], bh[4][2];
          ldmatrix_a(s_tile, kNLd, m0, k0, lane, ah);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            if (nt < n_tiles) {
              load_b(s_slab, kNLd, nt * 8, k0, lane, bh[nt]);
              mma(acc[nt], ah, bh[nt]);
            }
          }
          if (SPLIT) {
            unsigned al[4];
            ldmatrix_a(s_tile + kNRS * kNLd, kNLd, m0, k0, lane, al);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              if (nt < n_tiles) {
                unsigned bl[2];
                load_b(s_slab + kNKS * kNLd, kNLd, nt * 8, k0, lane, bl);
                mma(acc[nt], al, bh[nt]);  // tl . sh
                mma(acc[nt], ah, bl);      // th . sl
              }
            }
          }
        }
      }
    }
  }
  if (!active) return;
  // Fragment (nt, j): tile row m0 + g + 8*(j/2), k column nt*8 + 2t + j%2.
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + g + 8 * h;
      const int kk = nt * 8 + 2 * t;
      if (r >= rs || kk >= ks) continue;
      float* o = out + (static_cast<size_t>(b) * R + r_base + r) * k8 +
                 k_base + kk;
      *reinterpret_cast<float2*>(o) =
          make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
    }
}

// ---- B4 f32: natural-layout contraction in 3xTF32 ---------------------

constexpr int kXRS = 128;  // tile rows per CTA (8 warps x one m16 tile)
constexpr int kXKS = 32;   // k8 columns per CTA (four n8 tiles)
constexpr int kXCB = 32;   // contraction columns (of C) per stage
// Staged row stride (f32): 64-bit fragment loads at row g, column 2t hit
// banks 8g + 2t, free of conflicts.
constexpr int kXLd = kXCB + 8;
// Stage: the tile slice, the slab slice's big terms (in place of the
// landed f32), its small terms.
constexpr int kXStage = (kXRS + 2 * kXKS) * kXLd;  // floats per stage
constexpr int kXStages = 3;  // two stages in flight while one computes
constexpr int kXSmemBytes =
    kXStages * kXStage * static_cast<int>(sizeof(float));  // 92,160

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = big + small + O(2^-22 |x|), both tf32 (round to nearest, ties away):
// big . big + big . small + small . big is an f32-accurate product.
__device__ __forceinline__ void split_tf32(float x, unsigned& big,
                                           unsigned& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n"
      : "=r"(small)
      : "f"(x - __uint_as_float(big)));
}

// Not volatile: the scheduler may interleave independent products.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads, 2)
natural_f32_kernel(const int* __restrict__ block_ptr,
                   const int* __restrict__ pair_chunk,
                   const float* __restrict__ tiles,
                   const float* __restrict__ slabs, float* __restrict__ out,
                   int C, int R, int k8) {
  extern __shared__ __align__(16) unsigned char smem[];
  // Stage s: s_tile[r][c] (kXRS rows, f32), then s_big[kk][c] and
  // s_small[kk][c] (kXKS rows each, tf32 bits), stride kXLd.
  float* stages = reinterpret_cast<float*>(smem);

  const int b = blockIdx.x;
  const int r_base = blockIdx.y * kXRS;
  const int k_base = blockIdx.z * kXKS;
  const int rs = min(kXRS, R - r_base);   // multiple of 8
  const int ks = min(kXKS, k8 - k_base);  // multiple of 8
  const int n_tiles = ks / 8;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (tid >> 5) * 16;         // this warp's first tile row
  const bool active = m0 < rs;

  // Tile rows [rs, kXRS) and slab rows [ks, kXKS) are never loaded and
  // stay zero in every stage (R = 8 fills half an m16 tile).
  if (rs < kXRS || ks < kXKS) {
    for (int i = tid; i < kXStages * kXStage; i += kThreads) stages[i] = 0.f;
  }

  // Two accumulators for big . big, alternating by k-step, and one for
  // the two small cross terms: each f32 sum takes half as many steps.
  float acc_big[2][4][4], acc_small[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc_big[0][nt][j] = acc_big[1][nt][j] = acc_small[nt][j] = 0.f;
    }

  // The CTA's work is a run of steps: step s covers pair p_begin +
  // s / spt, contraction columns [(s % spt) * kXCB, +kXCB).
  const int p_begin = block_ptr[b];
  const int spt = C / kXCB;
  const int n_steps = (block_ptr[b + 1] - p_begin) * spt;
  constexpr int kVec = kXCB / 4;  // 16-byte vectors per staged row
  auto load = [&](int s) {
    const int p = p_begin + s / spt;
    const int c0 = (s % spt) * kXCB;
    float* s_tile = stages + (s % kXStages) * kXStage;
    float* s_big = s_tile + kXRS * kXLd;
    const float* tile = tiles + static_cast<size_t>(p) * R * C;
    const float* slab = slabs + static_cast<size_t>(pair_chunk[p]) * k8 * C;
    for (int i = tid; i < rs * kVec; i += kThreads) {
      const int r = i / kVec, v = i % kVec;
      cp_async16(s_tile + r * kXLd + v * 4,
                 tile + static_cast<size_t>(r_base + r) * C + c0 + v * 4);
    }
    for (int i = tid; i < ks * kVec; i += kThreads) {
      const int kk = i / kVec, v = i % kVec;
      cp_async16(s_big + kk * kXLd + v * 4,
                 slab + static_cast<size_t>(k_base + kk) * C + c0 + v * 4);
    }
  };
  // Every warp reads the whole slab slice: split it once, as it lands.
  // Each thread splits the vectors it copied itself (the same loop as
  // load's), which are visible to it after its own wait.
  auto split_slab = [&](int s) {
    float* s_big = stages + (s % kXStages) * kXStage + kXRS * kXLd;
    float* s_small = s_big + kXKS * kXLd;
    for (int i = tid; i < ks * kVec; i += kThreads) {
      const int at = (i / kVec) * kXLd + (i % kVec) * 4;
      const float4 x = *reinterpret_cast<const float4*>(s_big + at);
      uint4 hi, lo;
      split_tf32(x.x, hi.x, lo.x);
      split_tf32(x.y, hi.y, lo.y);
      split_tf32(x.z, hi.z, lo.z);
      split_tf32(x.w, hi.w, lo.w);
      *reinterpret_cast<uint4*>(s_big + at) = hi;
      *reinterpret_cast<uint4*>(s_small + at) = lo;
    }
  };

  __syncthreads();  // the zero fill is done before any copy lands
  // Steps 0 .. kXStages - 2 in flight first; one (maybe empty) group each.
#pragma unroll
  for (int s = 0; s < kXStages - 1; ++s) {
    if (s < n_steps) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<kXStages - 2>();  // step s has landed, for this thread
    split_slab(s);
    // ... for every thread, split; and all are done with step s - 1, so
    // its stage takes step s + kXStages - 1 while this one computes.
    __syncthreads();
    if (s + kXStages - 1 < n_steps) load(s + kXStages - 1);
    cp_async_commit();
    if (active) {
      const float* s_tile = stages + (s % kXStages) * kXStage;
      const unsigned* s_big =
          reinterpret_cast<const unsigned*>(s_tile + kXRS * kXLd);
      const unsigned* s_small = s_big + kXKS * kXLd;
      // In each 8-column step, staged columns 2t and 2t + 1 serve as mma's
      // k = t and t + 4 in both operands (the same permutation of the
      // sum's terms), so each fragment pair is one 64-bit load.
      const float* a_row = s_tile + (m0 + g) * kXLd + 2 * t;
#pragma unroll
      for (int k0 = 0; k0 < kXCB; k0 += 8) {
        // A (m16 x k8, row): (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4).
        const float2 a_lo = *reinterpret_cast<const float2*>(a_row + k0);
        const float2 a_hi =
            *reinterpret_cast<const float2*>(a_row + 8 * kXLd + k0);
        unsigned ab[4], as[4];
        split_tf32(a_lo.x, ab[0], as[0]);
        split_tf32(a_hi.x, ab[1], as[1]);
        split_tf32(a_lo.y, ab[2], as[2]);
        split_tf32(a_hi.y, ab[3], as[3]);
        // B (k8 x n8, col) = slab rows: (k = t, n = g), (t + 4, g).
        unsigned bb[4][2], bs[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int at = (nt * 8 + g) * kXLd + k0 + 2 * t;
          const uint2 big2 = *reinterpret_cast<const uint2*>(s_big + at);
          const uint2 small2 = *reinterpret_cast<const uint2*>(s_small + at);
          bb[nt][0] = big2.x;
          bb[nt][1] = big2.y;
          bs[nt][0] = small2.x;
          bs[nt][1] = small2.y;
        }
        float (&big)[4][4] = acc_big[(k0 / 8) & 1];
        // The two products into acc_small are issued apart.
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          if (nt < n_tiles) mma_tf32(acc_small[nt], as, bb[nt]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          if (nt < n_tiles) mma_tf32(big[nt], ab, bb[nt]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          if (nt < n_tiles) mma_tf32(acc_small[nt], ab, bs[nt]);
      }
    }
  }
  if (!active) return;
  // Fragment (nt, j): tile row m0 + g + 8*(j/2), k column nt*8 + 2t + j%2.
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + g + 8 * h;
      const int kk = nt * 8 + 2 * t;
      if (r >= rs || kk >= ks) continue;
      float x[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int f = 2 * h + j;
        x[j] = (acc_big[0][nt][f] + acc_big[1][nt][f]) + acc_small[nt][f];
      }
      float* o = out + (static_cast<size_t>(b) * R + r_base + r) * k8 +
                 k_base + kk;
      *reinterpret_cast<float2*>(o) = make_float2(x[0], x[1]);
    }
}

cudaError_t launch_natural_f32(const int* block_ptr, const int* pair_chunk,
                               const float* tiles, const float* slabs,
                               float* out, int nb, int C, int R, int k8,
                               cudaStream_t stream) {
  static std::atomic<uint64_t> configured{0};
  cudaError_t err =
      set_smem_once(natural_f32_kernel, kXSmemBytes, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid(nb, (R + kXRS - 1) / kXRS, (k8 + kXKS - 1) / kXKS);
  natural_f32_kernel<<<grid, kThreads, kXSmemBytes, stream>>>(
      block_ptr, pair_chunk, tiles, slabs, out, C, R, k8);
  return cudaGetLastError();
}

template <bool SPLIT>
cudaError_t launch_natural(const int* block_ptr, const int* pair_chunk,
                           const void* tiles, const void* slabs, float* out,
                           int nb, int C, int R, int k8, cudaStream_t stream) {
  constexpr int smem = natural_smem_bytes<SPLIT>();
  static std::atomic<uint64_t> configured{0};
  cudaError_t err = set_smem_once(natural_kernel<SPLIT>, smem, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid(nb, (R + kNRS - 1) / kNRS, (k8 + kNKS - 1) / kNKS);
  natural_kernel<SPLIT><<<grid, kThreads, smem, stream>>>(
      block_ptr, pair_chunk, static_cast<const __nv_bfloat16*>(tiles),
      static_cast<const __nv_bfloat16*>(slabs), out, C, R, k8);
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

// B1. block_ptr (nb + 1) and pair_chunk (P) int32; the compact plane
// (nz_ptr, col_ptr, rows, vals; index widths `wide`, see by_index_widths)
// of tiles_t (P, planes*C, R); slabs (n_chunks, k8, planes*C) bf16; out
// (nb, k8, R) f32, or (nb, k8, 2R) bf16 with fuse (split only). Requires
// C % 128 == 0, C <= 512, R % 8 == 0, k8 % 8 == 0 and 16-byte aligned
// slabs (checked by the wrapper).
int tmulti_launch(const void* block_ptr, const void* pair_chunk,
                  const void* nz_ptr, const void* col_ptr, const void* rows,
                  const void* vals, int wide, const void* slabs, void* out,
                  int nb, int C, int R, int k8, int split, int fuse,
                  void* stream) {
  const int* bp = static_cast<const int*>(block_ptr);
  const int* pc = static_cast<const int*>(pair_chunk);
  const Compact t{static_cast<const int*>(nz_ptr), col_ptr, rows, vals};
  const __nv_bfloat16* s = static_cast<const __nv_bfloat16*>(slabs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (split) {
    err = fuse ? launch_tmulti<true, true>(bp, pc, t, wide, s, out, nb, C, R,
                                           k8, st)
               : launch_tmulti<true, false>(bp, pc, t, wide, s, out, nb, C,
                                            R, k8, st);
  } else if (!fuse) {
    err = launch_tmulti<false, false>(bp, pc, t, wide, s, out, nb, C, R, k8,
                                      st);
  } else {
    err = cudaErrorInvalidValue;  // the one-plane state is a plain cast
  }
  return static_cast<int>(err);
}

// B6. phases (n_phases, 4) int32 rows (pair_off, chunk_lo, first
// partial, offset into block_ptr_ph); block_ptr_ph int32 run bounds
// relative to each phase's pair_off; pair_chunk_ph (P) int32 phase-local;
// the compact plane of the phase-major tiles_t (P, planes*C, R); slabs
// (n_chunks, k8, planes*C) bf16; partials (n_partials, k8, R) f32. Same
// requirements as B1.
int tmulti_phased_launch(const void* phases, int n_phases,
                         const void* block_ptr_ph, const void* pair_chunk_ph,
                         const void* nz_ptr, const void* col_ptr,
                         const void* rows, const void* vals, int wide,
                         const void* slabs, void* partials, int n_partials,
                         int C, int R, int k8, int split, void* stream) {
  const int* ph = static_cast<const int*>(phases);
  const int* bp = static_cast<const int*>(block_ptr_ph);
  const int* pc = static_cast<const int*>(pair_chunk_ph);
  const Compact t{static_cast<const int*>(nz_ptr), col_ptr, rows, vals};
  const __nv_bfloat16* s = static_cast<const __nv_bfloat16*>(slabs);
  float* o = static_cast<float*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      split ? launch_tmulti_phased<true>(ph, n_phases, bp, pc, t, wide, s, o,
                                         n_partials, C, R, k8, st)
            : launch_tmulti_phased<false>(ph, n_phases, bp, pc, t, wide, s,
                                          o, n_partials, C, R, k8, st);
  return static_cast<int>(err);
}

// B3 / B4 bf16 on the compact natural plane. block_ptr (nb + 1) and
// pair_chunk (P) int32; the compact plane (nz_ptr, col_ptr, rows, vals;
// index widths `wide`) of the natural tiles (P, R, planes*C); slabs
// (n_chunks, k8, planes*C) bf16, [hi | lo] with split (B3), one plane
// without (B4 bf16); out (nb, R, k8) f32. Same requirements as B1.
int natural_compact_launch(const void* block_ptr, const void* pair_chunk,
                           const void* nz_ptr, const void* col_ptr,
                           const void* rows, const void* vals, int wide,
                           const void* slabs, void* out, int nb, int C,
                           int R, int k8, int split, void* stream) {
  const int* bp = static_cast<const int*>(block_ptr);
  const int* pc = static_cast<const int*>(pair_chunk);
  const Compact t{static_cast<const int*>(nz_ptr), col_ptr, rows, vals};
  const __nv_bfloat16* s = static_cast<const __nv_bfloat16*>(slabs);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      split ? launch_tmulti_natural<true>(bp, pc, t, wide, s, o, nb, C, R,
                                          k8, st)
            : launch_tmulti_natural<false>(bp, pc, t, wide, s, o, nb, C, R,
                                           k8, st);
  return static_cast<int>(err);
}

// B3 / B4 on dense natural tiles. block_ptr (nb + 1) and pair_chunk (P)
// int32; tiles (P, R, planes*C) and slabs (n_chunks, k8, planes*C): mode
// 0 bf16 [hi | lo] (B3) and mode 1 bf16 (B4) for chunks wider than the
// compact kernel stages (C > kCMax), mode 2 f32 (B4); out (nb, R, k8)
// f32. Requires C % 128 == 0, R % 8 == 0, k8 % 8 == 0 and 16-byte aligned
// tiles and slabs (checked by the wrapper).
int natural_launch(const void* block_ptr, const void* pair_chunk,
                   const void* tiles, const void* slabs, void* out, int nb,
                   int C, int R, int k8, int mode, void* stream) {
  const int* bp = static_cast<const int*>(block_ptr);
  const int* pc = static_cast<const int*>(pair_chunk);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (mode == 0) {
    err = launch_natural<true>(bp, pc, tiles, slabs, o, nb, C, R, k8, st);
  } else if (mode == 1) {
    err = launch_natural<false>(bp, pc, tiles, slabs, o, nb, C, R, k8, st);
  } else if (mode == 2) {
    err = launch_natural_f32(bp, pc, static_cast<const float*>(tiles),
                             static_cast<const float*>(slabs), o, nb, C, R,
                             k8, st);
  } else {
    err = cudaErrorInvalidValue;
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
