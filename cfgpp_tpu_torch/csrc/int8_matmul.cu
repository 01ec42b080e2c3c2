// W8A8 int8 matmul and the fused GEGLU feed-forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels cfgpp_tpu/kernels/int8_matmul.py:
// int8_matmul (body _kernel) and int8_ff_geglu (body _kernel_ff), with their
// numerics: an optional LayerNorm (f32 statistics, variance as E[x^2]-mu^2)
// or per-(sample, channel) affine on x; per-row absmax quantization
// x * (1/sx), sx = max(amax, 1e-6) * (1/127), round half to even, clip to
// +-127; an int8 x int8 dot with int32 accumulation against per-output-row
// int8 weights (torch layout w [N, K]); the rank-1 dequant acc*sx*sw, then
// + bias, + residual in f32, one rounding to bf16 (the TPU kernels' output
// dtype whatever they read; for f32 activations see below).  Every f32 step
// uses the _rn intrinsics so that nvcc contracts nothing into an fma: the
// plain PyTorch version (kernels/int8_matmul.py) rounds each step on its
// own.
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
// bf16 read of x.
//
// The GEMM (`gemm_s8`) runs on the primitives it shares with int8_conv.cu
// (int8_gemm.cuh: mma.sync m16n8k32 s8 with ldmatrix on XOR-swizzled rows,
// a four-stage cp.async ring with zero-fill past m, n and k, a register
// epilogue in the plain version's _rn order, a 128 x 128 or 64 x 64 tile by
// the busiest SM's work, a programmatic dependent launch behind the
// quantize pass), here over the small k loops of the slice (K = 320 is
// five 64-byte steps).  No split over k.
// - GEGLU: the B tile holds 8 value rows and then the same 8 columns' gate
//   rows in each 16-row group, so a thread's n8 tiles 2j and 2j+1 hold the
//   value and the gate of the same two hidden columns; v*gelu(g) forms in
//   registers and is stored as float2.
//
// Activations: x, the residual and the output are all bf16 or all f32 (the
// `_f32` entry points).  The TPU kernels read either but always write bf16
// (out_shape bf16), which the JAX layers then cast to the module's dtype.
// So the f32 epilogue rounds its final value once to bf16, as the bf16 one
// does, and stores it widened to f32: exactly JAX's bf16 write followed by
// .astype(float32).  Only the quantize pre-pass and the epilogue see the
// activations' type: the GEMM core reads int8.  The FF's f32 hidden state
// is not an output and is not rounded.
//
// int8_ff_geglu: the requantize scale of a hidden row needs the absmax over
// all N before the second dot, and the TPU kernel quantizes the hidden row
// from f32.  This version writes the f32 hidden state [M, N] to device
// memory (42 MB at SD-1.5 level 0, M=8192, N=1280), requantizes it with the
// same `quantize_rows` pass, then runs the second GEMM with the residual in
// its epilogue.  It never quantizes from bf16.  Keeping the hidden rows on
// chip (small row blocks or a cluster) is the known next step.
//
// Built by cfgpp_tpu_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through ctypes (plain C entry points at the end of this file).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "int8_gemm.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using namespace int8_gemm;

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
// out rows [m0, m0+BM) x cols [n0, n0+BN) of a . w^T, a [m, k], w [rows, k]
// int8, both k-contiguous, on int8_gemm.cuh's primitives.  Its k loop and
// epilogue are written out here rather than taken from the header's
// mma_ring / store_tile (which int8_conv.cu runs): on those nvcc emits the
// same instructions with other registers and in another order, and
// int8_matmul measured 0.45% slower per SD-1.5 --quant dense request on an
// H100 (median of 20 readings in turns, quartiles 0.41-0.55%;
// cfgpp_tpu_torch/tools/int8_ab.py --pairs 10).
// GEGLU: w has 2n rows (value rows, then gate rows) and a block covers BN/2
// hidden columns: each 16-row group of the B tile holds 8 value rows
// n0+8j.. and then the same 8 columns' gate rows n+n0+8j.., so a warp's n8
// tiles 2j and 2j+1 are the value and the gate of the same 8 hidden columns
// and v*gelu(g) forms in registers.
template <class C, bool GEGLU, typename T>
__global__ void __launch_bounds__(C::kThreads)
gemm_s8(const int8_t* __restrict__ a, const int8_t* __restrict__ w,
        const float* __restrict__ sa, const float* __restrict__ sw,
        const float* __restrict__ bias, const T* __restrict__ res,
        T* __restrict__ out, float* __restrict__ hout, int m, int n, int k) {
  static_assert(C::BK == 64, "four 16-byte chunks a tile row");
  extern __shared__ __align__(128) int8_t smem[];
  constexpr int BM = C::BM, BN = C::BN, MT = C::MT, NT = C::NT;
  constexpr int BK = C::BK, kStages = C::kStages;
  constexpr int kCols = GEGLU ? BN / 2 : BN;   // output columns per block
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * kCols;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / C::kWarpsN, wn = warp % C::kWarpsN;
  const int ktiles = (k + BK - 1) / BK;

  // tile row -> row of w (or -1 past the edge)
  auto w_row = [&](int r) -> int {
    if (!GEGLU) return n0 + r < n ? n0 + r : -1;
    const int c = n0 + (r >> 4) * 8 + (r & 7);
    return c < n ? ((r & 8) ? n + c : c) : -1;
  };
  // Copies of k tile kt into ring stage `stage`; rows past m or n and chunks
  // past k are zero-filled without a read.
  auto load_a = [&](int stage, int kt) {
    int8_t* as = smem + stage * C::kStageBytes;
    const int k0 = kt * BK;
#pragma unroll
    for (int it = 0; it < BM * 4 / C::kThreads; ++it) {
      const int i = threadIdx.x + it * C::kThreads;
      const int r = i >> 2, c = i & 3, kc = k0 + c * 16;
      const bool ok = m0 + r < m && kc < k;
      cp_async16(as + C::swz(r, c), ok ? a + int64_t(m0 + r) * k + kc : a,
                 ok ? 16 : 0);
    }
  };
  auto load_b = [&](int stage, int kt) {
    int8_t* bs = smem + stage * C::kStageBytes + BM * BK;
    const int k0 = kt * BK;
#pragma unroll
    for (int it = 0; it < BN * 4 / C::kThreads; ++it) {
      const int i = threadIdx.x + it * C::kThreads;
      const int r = i >> 2, c = i & 3, kc = k0 + c * 16;
      const int wr = w_row(r);
      const bool ok = wr >= 0 && kc < k;
      cp_async16(bs + C::swz(r, c), ok ? w + int64_t(wr) * k + kc : w,
                 ok ? 16 : 0);
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // The weights do not depend on the quantize pass that precedes this
  // kernel in the stream, so their first tiles are requested before the
  // grid-dependency wait (a no-op unless the launch let this grid start
  // early); the quantized rows and their scales only after it.
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s)
    if (s < ktiles) load_b(s, s);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_a(s, s);
    cp_async_commit();
  }
  // ldmatrix lane roles: lanes 8i..8i+7 give the rows of matrix i
  const int li = lane / 8, lr = lane % 8;
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();   // this thread's copies of tile kt are in
    __syncthreads();                // everyone's are; stage kt-1 is free
    if (kt + kStages - 1 < ktiles) {
      load_a((kt + kStages - 1) % kStages, kt + kStages - 1);
      load_b((kt + kStages - 1) % kStages, kt + kStages - 1);
    }
    cp_async_commit();
    const int8_t* as = smem + (kt % kStages) * C::kStageBytes;
    const int8_t* bs = as + BM * BK;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
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

  // Epilogue from registers: the C fragment's element e of n8 tile j sits at
  // row g + 8 (e >> 1), column 8 j + 2 t + (e & 1) of the warp tile.
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * C::WM + i * 16 + g + 8 * half;
      if (row >= m) continue;
      const float s_row = sa[row];
      if constexpr (GEGLU) {
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
          const int col = n0 + (wn * C::WN / 16 + j) * 8 + 2 * t;
          if (col >= n) continue;
          const float2 sv = *reinterpret_cast<const float2*>(sw + col);
          const float2 sg = *reinterpret_cast<const float2*>(sw + n + col);
          float h[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = dequant(acc[i][2 * j][2 * half + e], s_row,
                                    e ? sv.y : sv.x, bias, col + e);
            const float gt = dequant(acc[i][2 * j + 1][2 * half + e], s_row,
                                     e ? sg.y : sg.x, bias, n + col + e);
            const float gelu = __fmul_rn(
                __fmul_rn(gt, 0.5f),
                __fadd_rn(1.f, erff(__fmul_rn(gt, 0.70710678118654752f))));
            h[e] = __fmul_rn(v, gelu);
          }
          *reinterpret_cast<float2*>(hout + int64_t(row) * n + col) =
              make_float2(h[0], h[1]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = n0 + wn * C::WN + j * 8 + 2 * t;
          if (col >= n) continue;
          store_pair(acc[i][j][2 * half], acc[i][j][2 * half + 1], s_row, sw,
                     bias, res, out, row, col, n);
        }
      }
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

// The tile by `large_tile_wins`; no split over k.  The GEGLU form writes
// only the f32 hidden state (T unused).
template <bool GEGLU, typename T>
cudaError_t launch_gemm(const int8_t* a, const int8_t* w, const float* sa,
                        const float* sw, const float* bias, const T* res,
                        T* out, float* hout, int m, int n, int k,
                        cudaStream_t s) {
  auto grid = [&](int bm, int cols) {
    return dim3((n + cols - 1) / cols, (m + bm - 1) / bm);
  };
  constexpr int kLarge = GEGLU ? LargeTile::BN / 2 : LargeTile::BN;
  constexpr int kSmall = GEGLU ? SmallTile::BN / 2 : SmallTile::BN;
  if (large_tile_wins(m, n, kLarge, kSmall))
    return launch_pdl<LargeTile, gemm_s8<LargeTile, GEGLU, T>>(
        grid(LargeTile::BM, kLarge), 1, s, a, w, sa, sw, bias, res, out, hout,
        m, n, k);
  return launch_pdl<SmallTile, gemm_s8<SmallTile, GEGLU, T>>(
      grid(SmallTile::BM, kSmall), 1, s, a, w, sa, sw, bias, res, out, hout, m,
      n, k);
}

template <typename T>
cudaError_t int8_matmul(const void* x, const void* w, const void* ws,
                        const void* bias, const void* g, const void* b,
                        const void* res, void* out, void* xq, void* sx, int m,
                        int n, int k, int mode, int rows_per_sample, float eps,
                        cudaStream_t s) {
  cudaError_t err = launch_quantize(
      static_cast<const T*>(x), static_cast<const float*>(g),
      static_cast<const float*>(b), static_cast<int8_t*>(xq),
      static_cast<float*>(sx), m, k, mode, rows_per_sample, eps, s);
  if (err != cudaSuccess) return err;
  return launch_gemm<false, T>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(w),
      static_cast<const float*>(sx), static_cast<const float*>(ws),
      static_cast<const float*>(bias), static_cast<const T*>(res),
      static_cast<T*>(out), nullptr, m, n, k, s);
}

template <typename T>
cudaError_t int8_ff_geglu(const void* x, const void* w1, const void* s1,
                          const void* b1, const void* w2, const void* s2,
                          const void* b2, const void* g, const void* b,
                          const void* res, void* out, void* xq, void* sx,
                          void* h, void* hq, void* sh, int m, int n, int k,
                          int o, int mode, float eps, cudaStream_t s) {
  if (mode == kAffine) return cudaErrorInvalidValue;
  cudaError_t err = launch_quantize(
      static_cast<const T*>(x), static_cast<const float*>(g),
      static_cast<const float*>(b), static_cast<int8_t*>(xq),
      static_cast<float*>(sx), m, k, mode, 1, eps, s);
  if (err != cudaSuccess) return err;
  err = launch_gemm<true, bf16>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(w1),
      static_cast<const float*>(sx), static_cast<const float*>(s1),
      static_cast<const float*>(b1), nullptr, nullptr, static_cast<float*>(h),
      m, n, k, s);
  if (err != cudaSuccess) return err;
  err = launch_quantize(static_cast<const float*>(h), nullptr, nullptr,
                        static_cast<int8_t*>(hq), static_cast<float*>(sh), m, n,
                        kNone, 1, 0.f, s);
  if (err != cudaSuccess) return err;
  return launch_gemm<false, T>(
      static_cast<const int8_t*>(hq), static_cast<const int8_t*>(w2),
      static_cast<const float*>(sh), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<const T*>(res),
      static_cast<T*>(out), nullptr, m, o, n, s);
}

}  // namespace

// x bf16 [m, k] (contiguous); w int8 [n, k]; ws f32 [n]; bias f32 [n] or
// null; g/b: LayerNorm gamma/beta f32 [k] (mode 1) or affine scale/shift f32
// [m / rows_per_sample, k] (mode 2), else null; res bf16 [m, n] or null;
// out bf16 [m, n]; xq int8 [m, k] and sx f32 [m] are scratch.  k and n are
// multiples of 16.  Returns a cudaError_t (0 on success).  The `_f32` entry
// point takes x, res and out in f32, with the same arguments otherwise.
extern "C" int cfgpp_int8_matmul(const void* x, const void* w, const void* ws,
                                 const void* bias, const void* g, const void* b,
                                 const void* res, void* out, void* xq, void* sx,
                                 int m, int n, int k, int mode,
                                 int rows_per_sample, float eps, void* stream) {
  return int8_matmul<bf16>(x, w, ws, bias, g, b, res, out, xq, sx, m, n, k,
                           mode, rows_per_sample, eps,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int cfgpp_int8_matmul_f32(const void* x, const void* w,
                                     const void* ws, const void* bias,
                                     const void* g, const void* b,
                                     const void* res, void* out, void* xq,
                                     void* sx, int m, int n, int k, int mode,
                                     int rows_per_sample, float eps,
                                     void* stream) {
  return int8_matmul<float>(x, w, ws, bias, g, b, res, out, xq, sx, m, n, k,
                            mode, rows_per_sample, eps,
                            static_cast<cudaStream_t>(stream));
}

// x bf16 [m, k]; w1 int8 [2n, k] (value rows, then gate rows), s1/b1 f32
// [2n]; w2 int8 [o, n], s2/b2 f32 [o]; g/b LayerNorm f32 [k] (mode 1) or
// null (mode 0); res bf16 [m, o] or null; out bf16 [m, o].  Scratch: xq int8
// [m, k], sx f32 [m], h f32 [m, n], hq int8 [m, n], sh f32 [m].  k, n and o
// are multiples of 16.  Returns a cudaError_t (0 on success).  The `_f32`
// entry point takes x, res and out in f32.
extern "C" int cfgpp_int8_ff_geglu(const void* x, const void* w1, const void* s1,
                                   const void* b1, const void* w2, const void* s2,
                                   const void* b2, const void* g, const void* b,
                                   const void* res, void* out, void* xq, void* sx,
                                   void* h, void* hq, void* sh, int m, int n,
                                   int k, int o, int mode, float eps,
                                   void* stream) {
  return int8_ff_geglu<bf16>(x, w1, s1, b1, w2, s2, b2, g, b, res, out, xq, sx,
                             h, hq, sh, m, n, k, o, mode, eps,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int cfgpp_int8_ff_geglu_f32(const void* x, const void* w1,
                                       const void* s1, const void* b1,
                                       const void* w2, const void* s2,
                                       const void* b2, const void* g,
                                       const void* b, const void* res,
                                       void* out, void* xq, void* sx, void* h,
                                       void* hq, void* sh, int m, int n, int k,
                                       int o, int mode, float eps,
                                       void* stream) {
  return int8_ff_geglu<float>(x, w1, s1, b1, w2, s2, b2, g, b, res, out, xq,
                              sx, h, hq, sh, m, n, k, o, mode, eps,
                              static_cast<cudaStream_t>(stream));
}
