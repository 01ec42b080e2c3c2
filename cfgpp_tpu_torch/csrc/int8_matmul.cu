// W8A8 int8 matmul and the fused GEGLU feed-forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels cfgpp_tpu/kernels/int8_matmul.py:
// int8_matmul (body _kernel) and int8_ff_geglu (body _kernel_ff), with their
// numerics: an optional LayerNorm (f32 statistics, variance as E[x^2]-mu^2)
// or per-(sample, channel) affine on x; per-row absmax quantization
// x * (1/sx), sx = max(amax, 1e-6) * (1/127), round half to even, clip to
// +-127; an int8 x int8 dot with int32 accumulation against per-output-row
// int8 weights (torch layout w [N, K]); the rank-1 dequant acc*sx*sw, then
// + bias, + residual in f32, one rounding to bf16.  Every f32 step uses the
// _rn intrinsics so that nvcc contracts nothing into an fma: the plain
// PyTorch version (kernels/int8_matmul.py) rounds each step on its own.
//
// What bounds it on the H100: at the slice's shapes (M = 128..8192 rows,
// K = 320..5120, N = 320..5120) the int8 tensor-core work is small
// (2*M*N*K <= 86 GOP per call, under 50 us at the 1979 TOP/s peak) and the
// bytes of the bf16 activations in and out dominate, together with the
// launch cost of a call at the small mid-block shapes.
//
// What the design does about that.  A Hopper grid runs its blocks in no
// order, so the TPU kernel's reuse of one row block's quantized values
// across a sequential N loop has no counterpart.  Of the two ways to give
// every N block the quantized rows -- each block re-deriving scales and
// int8 values from x, or a pre-pass that writes them once -- this file
// takes the pre-pass: `quantize_rows` reads each bf16 row once (one warp per
// row, the LayerNorm statistics in the same warp) and writes int8 x and the
// row scale, so the GEMM reads 1 byte per element instead of 2 and never
// repeats the LayerNorm; the extra int8 write and read cost half of one
// bf16 read of x.  The GEMM (`gemm_s8`) runs nvcuda::wmma m16n16k16
// signed-char fragments with int accumulators: 128x128 output tiles, 64-deep
// k steps staged through shared memory, 8 warps of 32x64 (GEGLU: 32x32 of
// the value half and the same 32 columns of the gate half, so v*gelu(g) is
// formed in the epilogue of one block).
//
// int8_ff_geglu: the requantize scale of a hidden row needs the absmax over
// all N before the second dot, and the TPU kernel quantizes the hidden row
// from f32.  This first version writes the f32 hidden state [M, N] to
// device memory (42 MB at SD-1.5 level 0, M=8192, N=1280), requantizes it
// with the same `quantize_rows` pass, then runs the second GEMM with the
// residual in its epilogue.  It never quantizes from bf16.  Keeping the
// hidden rows on chip (small row blocks or a cluster) is the known next
// step.
//
// Built by cfgpp_tpu_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through ctypes (plain C entry points at the end of this file).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kQuantWarps = 8;   // rows per block of the quantize pass

enum Prologue { kNone = 0, kLayerNorm = 1, kAffine = 2 };

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float load_f(const bf16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float load_f(const float* p, int64_t i) { return p[i]; }

// One warp per row: optional prologue, absmax, quantize.  The prologue is
// recomputed in each pass instead of stored; it is the same arithmetic, so
// the amax pass and the quantize pass see the same values.
template <typename T>
__global__ void __launch_bounds__(kQuantWarps * 32)
quantize_rows(const T* __restrict__ x, const float* __restrict__ g,
              const float* __restrict__ b, int8_t* __restrict__ xq,
              float* __restrict__ sx, int m, int k, int mode,
              int rows_per_sample, float eps) {
  const int row = blockIdx.x * kQuantWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= m) return;
  const T* xr = x + int64_t(row) * k;
  float mu = 0.f, rstd = 1.f;
  const float* gr = g;
  const float* br = b;
  if (mode == kLayerNorm) {
    float s = 0.f, s2 = 0.f;
    for (int c = lane; c < k; c += 32) {
      const float v = load_f(xr, c);
      s = __fadd_rn(s, v);
      s2 = __fadd_rn(s2, __fmul_rn(v, v));
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    mu = __fdiv_rn(s, float(k));
    const float var = __fsub_rn(__fdiv_rn(s2, float(k)), __fmul_rn(mu, mu));
    rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  } else if (mode == kAffine) {
    const int64_t sample = row / rows_per_sample;
    gr = g + sample * k;
    br = b + sample * k;
  }
  auto value = [&](int c) -> float {
    const float v = load_f(xr, c);
    if (mode == kLayerNorm)
      return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mu), rstd), g[c]), b[c]);
    if (mode == kAffine) return __fadd_rn(__fmul_rn(v, gr[c]), br[c]);
    return v;
  };
  float amax = 0.f;
  for (int c = lane; c < k; c += 32) amax = fmaxf(amax, fabsf(value(c)));
  amax = warp_max(amax);
  const float s = __fmul_rn(fmaxf(amax, 1e-6f), 1.f / 127.f);
  const float inv = __fdiv_rn(1.f, s);
  int8_t* qr = xq + int64_t(row) * k;
  for (int c = lane; c < k; c += 32) {
    const float q = rintf(__fmul_rn(value(c), inv));
    qr[c] = static_cast<int8_t>(fminf(fmaxf(q, -127.f), 127.f));
  }
  if (lane == 0) sx[row] = s;
}

// ---------------------------------------------------------------- int8 GEMM
constexpr int BM = 128, BN = 128, BK = 64;
constexpr int kGemmThreads = 256;           // 8 warps: 4 (rows) x 2 (cols)
constexpr int kPlanes = BK / 16;            // 16-byte k planes of a tile
// A k plane holds 16 k values of every tile row, rows 16 bytes apart, so a
// 16x16 wmma fragment is 256 contiguous bytes and every fragment pointer is
// 32-byte aligned (wmma's rule; a 16-byte k offset inside a row breaks it).
// The 32-byte skew between planes spreads one 8-thread store phase (2 rows
// x 4 planes) over distinct banks.
constexpr int kPlaneBytes = BM * 16 + 32;
constexpr int kScratch = 2 * 16 * 16;       // ints per warp (value + gate)

// out rows [m0, m0+BM) x cols [n0, n0+BN) of a . w^T, a [m, k], w [rows, k]
// int8.  GEGLU: w has 2n rows (value rows, then gate rows) and the block
// covers BN/2 hidden columns: tile rows 0..63 of w are value rows n0.., rows
// 64..127 the gate rows n+n0..; the epilogue writes h = v*gelu(g) in f32.
template <bool GEGLU>
__global__ void __launch_bounds__(kGemmThreads)
gemm_s8(const int8_t* __restrict__ a, const int8_t* __restrict__ w,
        const float* __restrict__ sa, const float* __restrict__ sw,
        const float* __restrict__ bias, const bf16* __restrict__ res,
        bf16* __restrict__ out, float* __restrict__ hout, int m, int n, int k) {
  __shared__ __align__(128) int8_t as[kPlanes * kPlaneBytes];
  __shared__ __align__(128) int8_t bs[kPlanes * kPlaneBytes];
  __shared__ __align__(128) int scratch[kGemmThreads / 32][kScratch];

  constexpr int kCols = GEGLU ? BN / 2 : BN;   // output columns per block
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * kCols;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0);

  // tile row -> row of w (or -1 past the edge)
  auto w_row = [&](int r) -> int {
    if (!GEGLU) return n0 + r < n ? n0 + r : -1;
    const int c = n0 + (r % (BN / 2));
    return c < n ? (r < BN / 2 ? c : n + c) : -1;
  };
  // fragment j's first row in the B tile
  auto b_row = [&](int j) -> int {
    if (!GEGLU) return wn * 64 + j * 16;
    return (j < 2 ? 0 : BN / 2) + wn * 32 + (j % 2) * 16;
  };

  for (int k0 = 0; k0 < k; k0 += BK) {
    __syncthreads();   // the previous step's fragments are loaded
    for (int i = threadIdx.x; i < BM * kPlanes; i += kGemmThreads) {
      const int r = i / kPlanes, p = i % kPlanes;
      const int kc = k0 + p * 16;
      uint4 va = make_uint4(0u, 0u, 0u, 0u), vb = va;
      if (kc < k) {
        if (m0 + r < m)
          va = *reinterpret_cast<const uint4*>(a + int64_t(m0 + r) * k + kc);
        const int wr = w_row(r);
        if (wr >= 0) vb = *reinterpret_cast<const uint4*>(w + int64_t(wr) * k + kc);
      }
      *reinterpret_cast<uint4*>(as + p * kPlaneBytes + r * 16) = va;
      *reinterpret_cast<uint4*>(bs + p * kPlaneBytes + r * 16) = vb;
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(
            fa[i], reinterpret_cast<const signed char*>(
                       as + p * kPlaneBytes + (wm * 32 + i * 16) * 16), 16);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(
            fb[j], reinterpret_cast<const signed char*>(
                       bs + p * kPlaneBytes + b_row(j) * 16), 16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }

  int* sc = scratch[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < (GEGLU ? 2 : 4); ++j) {
      wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
      if constexpr (GEGLU)
        wmma::store_matrix_sync(sc + 256, acc[i][j + 2], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = m0 + wm * 32 + i * 16 + e / 16;
        const int col = n0 + (GEGLU ? wn * 32 : wn * 64) + j * 16 + e % 16;
        if (row >= m || col >= n) continue;
        const float s_row = sa[row];
        float y = __fmul_rn(__fmul_rn(__int2float_rn(sc[e]), s_row), sw[col]);
        if (bias) y = __fadd_rn(y, bias[col]);
        if constexpr (GEGLU) {
          float gt = __fmul_rn(__fmul_rn(__int2float_rn(sc[256 + e]), s_row), sw[n + col]);
          if (bias) gt = __fadd_rn(gt, bias[n + col]);
          const float gelu = __fmul_rn(
              __fmul_rn(gt, 0.5f),
              __fadd_rn(1.f, erff(__fmul_rn(gt, 0.70710678118654752f))));
          hout[int64_t(row) * n + col] = __fmul_rn(y, gelu);
        } else {
          if (res) y = __fadd_rn(y, __bfloat162float(res[int64_t(row) * n + col]));
          out[int64_t(row) * n + col] = __float2bfloat16_rn(y);
        }
      }
      __syncwarp();
    }
  }
}

template <typename T>
cudaError_t launch_quantize(const T* x, const float* g, const float* b,
                            int8_t* xq, float* sx, int m, int k, int mode,
                            int rows_per_sample, float eps, cudaStream_t s) {
  quantize_rows<T><<<(m + kQuantWarps - 1) / kQuantWarps, kQuantWarps * 32, 0, s>>>(
      x, g, b, xq, sx, m, k, mode, rows_per_sample, eps);
  return cudaGetLastError();
}

template <bool GEGLU>
cudaError_t launch_gemm(const int8_t* a, const int8_t* w, const float* sa,
                        const float* sw, const float* bias, const bf16* res,
                        bf16* out, float* hout, int m, int n, int k,
                        cudaStream_t s) {
  constexpr int cols = GEGLU ? BN / 2 : BN;
  dim3 grid((n + cols - 1) / cols, (m + BM - 1) / BM);
  gemm_s8<GEGLU><<<grid, kGemmThreads, 0, s>>>(a, w, sa, sw, bias, res, out,
                                               hout, m, n, k);
  return cudaGetLastError();
}

}  // namespace

// x bf16 [m, k] (contiguous); w int8 [n, k]; ws f32 [n]; bias f32 [n] or
// null; g/b: LayerNorm gamma/beta f32 [k] (mode 1) or affine scale/shift f32
// [m / rows_per_sample, k] (mode 2), else null; res bf16 [m, n] or null;
// out bf16 [m, n]; xq int8 [m, k] and sx f32 [m] are scratch.  k and n are
// multiples of 16.  Returns a cudaError_t (0 on success).
extern "C" int cfgpp_int8_matmul(const void* x, const void* w, const void* ws,
                                 const void* bias, const void* g, const void* b,
                                 const void* res, void* out, void* xq, void* sx,
                                 int m, int n, int k, int mode,
                                 int rows_per_sample, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_quantize(
      static_cast<const bf16*>(x), static_cast<const float*>(g),
      static_cast<const float*>(b), static_cast<int8_t*>(xq),
      static_cast<float*>(sx), m, k, mode, rows_per_sample, eps, s);
  if (err != cudaSuccess) return err;
  return launch_gemm<false>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(w),
      static_cast<const float*>(sx), static_cast<const float*>(ws),
      static_cast<const float*>(bias), static_cast<const bf16*>(res),
      static_cast<bf16*>(out), nullptr, m, n, k, s);
}

// x bf16 [m, k]; w1 int8 [2n, k] (value rows, then gate rows), s1/b1 f32
// [2n]; w2 int8 [o, n], s2/b2 f32 [o]; g/b LayerNorm f32 [k] (mode 1) or
// null (mode 0); res bf16 [m, o] or null; out bf16 [m, o].  Scratch: xq int8
// [m, k], sx f32 [m], h f32 [m, n], hq int8 [m, n], sh f32 [m].  k, n and o
// are multiples of 16.  Returns a cudaError_t (0 on success).
extern "C" int cfgpp_int8_ff_geglu(const void* x, const void* w1, const void* s1,
                                   const void* b1, const void* w2, const void* s2,
                                   const void* b2, const void* g, const void* b,
                                   const void* res, void* out, void* xq, void* sx,
                                   void* h, void* hq, void* sh, int m, int n,
                                   int k, int o, int mode, float eps,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kAffine) return int(cudaErrorInvalidValue);
  cudaError_t err = launch_quantize(
      static_cast<const bf16*>(x), static_cast<const float*>(g),
      static_cast<const float*>(b), static_cast<int8_t*>(xq),
      static_cast<float*>(sx), m, k, mode, 1, eps, s);
  if (err != cudaSuccess) return err;
  err = launch_gemm<true>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(w1),
      static_cast<const float*>(sx), static_cast<const float*>(s1),
      static_cast<const float*>(b1), nullptr, nullptr, static_cast<float*>(h),
      m, n, k, s);
  if (err != cudaSuccess) return err;
  err = launch_quantize(static_cast<const float*>(h), nullptr, nullptr,
                        static_cast<int8_t*>(hq), static_cast<float*>(sh), m, n,
                        kNone, 1, 0.f, s);
  if (err != cudaSuccess) return err;
  return launch_gemm<false>(
      static_cast<const int8_t*>(hq), static_cast<const int8_t*>(w2),
      static_cast<const float*>(sh), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<const bf16*>(res),
      static_cast<bf16*>(out), nullptr, m, o, n, s);
}
