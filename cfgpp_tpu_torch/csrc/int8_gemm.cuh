// The int8 tensor-core GEMM core shared by int8_matmul.cu (gemm_s8) and
// int8_conv.cu (conv_s8), for Hopper (sm_90a); flash_attention_int8.cu
// takes its primitives (cp_async16, ldmatrix_x4, mma_s8) for its score.
//
// - mma.sync m16n8k32 s8 x s8 -> s32 in inline PTX.  Both operands are
//   k-contiguous (A [m, k] row, B [n, k] "col"), so plain ldmatrix (.x4, no
//   .trans) loads both fragments.
// - Shared memory rows of BK = 64 (or 128) bytes whose 16-byte chunks are
//   XOR-swizzled by row, so cp.async stores and ldmatrix reads are free of
//   bank conflicts.
// - `mma_ring`: a kStages-deep ring of cp.async.cg 16-byte copies and one
//   __syncthreads per k step: the copies of steps k+1..k+3 are in flight
//   while step k computes.  The caller's loaders say where each tile row's
//   16-byte chunks come from; chunks outside the operands are written as
//   zeros without a read (the zero-fill form), so they add nothing.
// - `store_tile` / `store_pair`: the epilogue from registers, in the plain
//   versions' _rn order: ((acc * s_row) * sw) + bias, + residual, one
//   rounding to bf16.  conv_s8 runs mma_ring and store_tile; gemm_s8 writes
//   the same loop and tile walk out itself (int8_matmul.cu says why) and
//   calls store_pair.
//   Each thread holds pairs of adjacent columns of the m16n8 C fragment,
//   reads the weight scales as float2 and the residual as bf16x2 / float2,
//   and stores bf16x2, or for f32 activations the bf16-rounded pair widened
//   to float2 (the TPU kernels write bf16 whatever they read).
// - Tiles: 128 x 128 with 8 warps of 64 x 32, or 64 x 64 with 4 warps of
//   32 x 32 (`large_tile_wins`).
// - A programmatic dependent launch (`launch_pdl`): the GEMM grid may be
//   scheduled while the pre-pass before it drains; `mma_ring` requests its
//   first B tiles (weights, which no pre-pass writes) and then waits
//   (griddepcontrol.wait) before it reads A.  It may also group the grid's
//   blocks into thread block clusters along z.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace int8_gemm {

// Output tile BM x BN of warps WM x WN each, k tiles of BK bytes (64 or
// 128: kChunks 16-byte chunks a row) through a ring of kStages.
template <int BM_, int BN_, int WM_, int WN_, int BK_ = 64, int STAGES_ = 4>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int BK = BK_, kStages = STAGES_, kChunks = BK / 16;
  static constexpr int kWarpsN = BN / WN;
  static constexpr int kThreads = (BM / WM) * kWarpsN * 32;
  static constexpr int MT = WM / 16;            // m16 tiles per warp
  static constexpr int NT = WN / 8;             // n8 tiles per warp
  static constexpr int kStageBytes = (BM + BN) * BK;
  static constexpr int kSmem = kStages * kStageBytes;
  static_assert(WM % 16 == 0 && WN % 16 == 0, "warp tile");
  static_assert(BK == 64 || BK == 128, "k tile");
  static_assert((BM * kChunks) % kThreads == 0 &&
                    (BN * kChunks) % kThreads == 0,
                "every thread issues the same number of copies");

  // Byte offset of 16-byte chunk `c` of tile row `r`.  The chunk index is
  // XORed with bits of the row (64-byte rows: bits 1-2; 128-byte rows: bits
  // 0-2), so the 8 rows of one ldmatrix phase and the chunks of one
  // cp.async phase each hit distinct 4-bank groups.
  static __device__ __forceinline__ int swz(int r, int c) {
    return r * BK + ((c ^ (BK == 64 ? (r >> 1) & 3 : r & 7)) << 4);
  }
};
using LargeTile = Tile<128, 128, 64, 32>;   // 8 warps, 2 x 4
using SmallTile = Tile<64, 64, 32, 32>;     // 4 warps, 2 x 2

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a b on the tensor cores: a 16x32 s8 (row), b 32x8 s8 (col), c s32.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ((acc * s_row) * sw) + bias, each step rounded on its own (as the plain
// versions).
__device__ __forceinline__ float dequant(int acc, float s_row, float sw,
                                         const float* bias, int col) {
  const float y = __fmul_rn(__fmul_rn(__int2float_rn(acc), s_row), sw);
  return bias ? __fadd_rn(y, bias[col]) : y;
}

// Two adjacent activations as f32, and two f32 outputs stored as T: each
// rounded once to bf16, kept as bf16 or widened back to f32.
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = __bfloat1622float2(__floats2bfloat162_rn(a, b));
}

template <class C>
using Acc = int[C::MT][C::NT][4];

// acc += A B^T over `ktiles` k tiles of C::BK bytes, through the cp.async
// ring in `smem` (C::kSmem bytes).  load_a(as, kt) / load_b(bs, kt) issue
// this thread's copies of k tile kt into the stage's A (BM rows) / B (BN
// rows) tile.  B's first tiles are requested before the grid-dependency
// wait (a no-op unless the launch let this grid start early), A's only
// after it.
template <class C, class LoadA, class LoadB>
__device__ __forceinline__ void mma_ring(int8_t* smem, int ktiles,
                                         const LoadA& load_a,
                                         const LoadB& load_b, Acc<C>& acc) {
  constexpr int MT = C::MT, NT = C::NT, kStages = C::kStages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / C::kWarpsN, wn = warp % C::kWarpsN;
  auto a_stage = [&](int s) { return smem + s * C::kStageBytes; };
  auto b_stage = [&](int s) {
    return smem + s * C::kStageBytes + C::BM * C::BK;
  };
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s)
    if (s < ktiles) load_b(b_stage(s), s);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_a(a_stage(s), s);
    cp_async_commit();
  }
  // ldmatrix lane roles: lanes 8i..8i+7 give the rows of matrix i
  const int li = lane / 8, lr = lane % 8;
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();   // this thread's copies of tile kt are in
    __syncthreads();                // everyone's are; stage kt-1 is free
    const int next = kt + kStages - 1;
    if (next < ktiles) {
      load_a(a_stage(next % kStages), next);
      load_b(b_stage(next % kStages), next);
    }
    cp_async_commit();
    const int8_t* as = a_stage(kt % kStages);
    const int8_t* bs = b_stage(kt % kStages);
#pragma unroll
    for (int ks = 0; ks < C::BK / 32; ++ks) {
      uint32_t af[MT][4], bfr[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(af[i], as + C::swz(wm * C::WM + i * 16 + (li & 1) * 8 + lr,
                                       2 * ks + (li >> 1)));
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t r[4];
        ldmatrix_x4(r, bs + C::swz(wn * C::WN + j * 16 + (li >> 1) * 8 + lr,
                                   2 * ks + (li & 1)));
        bfr[2 * j][0] = r[0];
        bfr[2 * j][1] = r[1];
        bfr[2 * j + 1][0] = r[2];
        bfr[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_s8(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
  }
}

// Output columns col, col+1 of row `row` of an [., n] output from their
// int32 sums: dequant, + residual, one rounding to bf16, stored as T.
template <typename T>
__device__ __forceinline__ void store_pair(int acc0, int acc1, float s_row,
                                           const float* __restrict__ sw,
                                           const float* __restrict__ bias,
                                           const T* __restrict__ res,
                                           T* __restrict__ out, int row,
                                           int col, int n) {
  const float2 sv = *reinterpret_cast<const float2*>(sw + col);
  float y0 = dequant(acc0, s_row, sv.x, bias, col);
  float y1 = dequant(acc1, s_row, sv.y, bias, col + 1);
  const int64_t o = int64_t(row) * n + col;
  if (res) {
    const float2 r2 = load2(res + o);
    y0 = __fadd_rn(y0, r2.x);
    y1 = __fadd_rn(y1, r2.y);
  }
  store2(out + o, y0, y1);
}

// The epilogue of output rows [m0, m0+BM) x cols [n0, n0+BN) of an [m, n]
// output: row_scale(row) is the row's activation scale.  The C fragment's
// element e of n8 tile j sits at row g + 8 (e >> 1), column 8 j + 2 t +
// (e & 1) of the warp tile.  n is even.
template <class C, typename T, class RowScale>
__device__ __forceinline__ void store_tile(const Acc<C>& acc, int m0, int n0,
                                           int m, int n,
                                           const RowScale& row_scale,
                                           const float* __restrict__ sw,
                                           const float* __restrict__ bias,
                                           const T* __restrict__ res,
                                           T* __restrict__ out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / C::kWarpsN, wn = warp % C::kWarpsN;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < C::MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * C::WM + i * 16 + g + 8 * half;
      if (row >= m) continue;
      const float s_row = row_scale(row);
#pragma unroll
      for (int j = 0; j < C::NT; ++j) {
        const int col = n0 + wn * C::WN + j * 8 + 2 * t;
        if (col >= n) continue;
        store_pair(acc[i][j][2 * half], acc[i][j][2 * half + 1], s_row, sw,
                   bias, res, out, row, col, n);
      }
    }
  }
}

// The card's SM count, read once per process.
inline int sm_count() {
  static const int count = [] {
    int dev = 0, v = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return count;
}

// Whether the 128 x 128 tile leaves the busiest SM less work than the
// 64 x 64 one for an m x n output (`cols`: output columns per block of each
// tile): blocks spread over the SMs in waves, and a 64 x 64 tile costs
// about 1.3x a 128 x 128 one per output (it moves twice the bytes per
// output through shared memory and L2).  The factor was read off an H100
// 80GB HBM3 with cfgpp_tpu_torch/tools/int8_ab.py: 128 x 128 wins at 240
// blocks on 132 SMs (SD-1.5 level 1 to_qkv) and loses at 192 (level 0,
// N = 320).
inline bool large_tile_wins(int64_t m, int n, int cols_large, int cols_small) {
  auto cost = [&](int bm, int bn, int cols, int per_output_x10) -> int64_t {
    const int64_t blocks = (m + bm - 1) / bm * ((n + cols - 1) / cols);
    return (blocks + sm_count() - 1) / sm_count() * bm * bn * per_output_x10;
  };
  return cost(LargeTile::BM, LargeTile::BN, cols_large, 10) <=
         cost(SmallTile::BM, SmallTile::BN, cols_small, 13);
}

// Launch kernel `Kern` as a programmatic dependent of the work before it
// in stream s (see mma_ring's griddepcontrol.wait), with C::kSmem bytes of
// dynamic shared memory (allowed once per kernel and library: the build's
// -fno-gnu-unique keeps this static apart in each loaded library) and,
// where cluster_z > 1, thread block clusters of cluster_z blocks along z.
template <class C, auto Kern, class... Args>
cudaError_t launch_pdl(dim3 grid, unsigned cluster_z, cudaStream_t s,
                       Args... args) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      Kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (attr != cudaSuccess) return attr;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[0].val.programmaticStreamSerializationAllowed = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = 1;
  attrs[1].val.clusterDim.y = 1;
  attrs[1].val.clusterDim.z = cluster_z;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = s;
  cfg.attrs = attrs;
  cfg.numAttrs = cluster_z > 1 ? 2 : 1;
  return cudaLaunchKernelEx(&cfg, Kern, args...);
}

// Resident blocks of `Kern` per SM (launch_pdl's block and shared memory),
// read once per kernel and process.
template <class C, auto Kern>
int blocks_per_sm() {
  static const int count = [] {
    int v = 1;
    cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         C::kSmem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&v, Kern, C::kThreads,
                                                  C::kSmem);
    return v > 0 ? v : 1;
  }();
  return count;
}

}  // namespace int8_gemm
