// W8A8 3x3 convolution (stride 1, zero pad 1, NHWC) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cfgpp_tpu/kernels/int8_conv.py:int8_conv3x3
// (body _kernel), with its numerics: an optional f32 prologue
// silu(x*gs + gb) (per sample and channel; the GroupNorm + SiLU collapse),
// after which the zero-padded columns and the rows beyond the sample's edge
// are zero again; one activation scale per (sample, window of br output rows
// and their two halo rows), sx = max(amax, 1e-6) * (1/127); x * (1/sx)
// rounded half to even and clipped to +-127; nine shifted int8 x int8
// products with int32 accumulation against per-output-channel int8 weights;
// the dequant (acc*sx)*ws, then + bias, + residual in f32, one rounding to
// bf16 (none for f32 activations).  Every f32 step uses the _rn intrinsics so that nvcc contracts
// nothing into an fma: the plain PyTorch version (kernels/int8_conv.py)
// rounds each step on its own.
//
// Layouts: x [B, H, W, C] and residual/out [B, H, W, O], all bf16 or all
// f32 (the `_f32` entry point; the TPU kernel takes either), contiguous NHWC
// (the port's NCHW channels_last memory); w int8
// [O, 3, 3, C], so each tap's 16-channel slice of an output channel is one
// 16-byte load.
//
// What bounds it on the H100: at the SD-1.5 sites (32x32 and 64x64 latents,
// C = 640..1920, O = 640..1280, batch 2) each call is 27-60 GOP of int8
// work, under 40 us at the 1979 TOP/s peak, and reads 4-10 MB of
// activations; the re-quantization of each input element (once per column
// shift and output-channel block) and the synchronous k loop bound this
// first version, not the tensor cores.
//
// What the design does about that.  The windows overlap: a window's halo
// rows are interior rows of its neighbours, quantized there with another
// scale.  So no pre-pass can write one int8 copy per pixel, and the int8
// activations never go to device memory: quantization happens on load.
//   1. `window_amax` (grid: window x slice) applies the prologue and reduces
//      |x| over its part of a window; atomicMax on the float bits (all
//      values are >= 0) combines the slices.
//   2. `conv3x3_s8` computes one output tile of 128 pixels (R rows x TW
//      columns of one window, TW = 64 or 32) x 128 output channels.  For
//      each 64-channel chunk it loads the tile's (R+2) x (TW+2) input patch
//      from bf16 or f32, applies the prologue, zeroes the padding, quantizes with
//      the window's scale and stores three column-shifted int8 copies in
//      shared memory (as the TPU kernel stages its three dw shifts), so that
//      every tap (dh, dw) is a plain 128-row slice of copy dw starting dh*TW
//      pixels in, 32-byte aligned as wmma requires.  Per tap it stages the
//      weights' 128 x 64 slice and runs nvcuda::wmma m16n16k16 signed-char
//      fragments with int accumulators (8 warps of 32 x 64, as gemm_s8 in
//      int8_matmul.cu).  The epilogue dequantizes and writes x's type.
// Overlapping the loads with the products (cp.async / TMA), keeping the
// quantized patch across output-channel blocks, and wgmma are the known
// next steps.
//
// Built by cfgpp_tpu_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through ctypes (plain C entry point at the end of this file).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <algorithm>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BN = 128;                       // output channels per block
constexpr int BK = 64;                        // input channels per chunk
constexpr int kPlanes = BK / 16;              // 16-byte k planes of a chunk
constexpr int kThreads = 256;                 // 8 warps: 4 (pixels) x 2 (channels)
constexpr int kAmaxThreads = 256;
constexpr int kPlaneB = BN * 16 + 32;         // a weight plane, 32-byte skew
constexpr int kScratchBytes = kThreads / 32 * 256 * 4;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Eight consecutive activations (16- or 32-byte aligned) as f32.
__device__ __forceinline__ void load8(const bf16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 t = __bfloat1622float2(h[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ void store_f(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }

// silu(x*g + b) as the plain version computes it: x*g, + b, then
// v * sigmoid(v) with sigmoid = 1 / (1 + exp(-v)) (torch's formula).
template <bool GN>
__device__ __forceinline__ float prologue(float v, const float* g, const float* b,
                                          int c) {
  if constexpr (GN) {
    v = __fadd_rn(__fmul_rn(v, g[c]), b[c]);
    return __fmul_rn(v, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-v))));
  }
  return v;
}

__device__ __forceinline__ float window_scale(const unsigned* amax, int win) {
  return __fmul_rn(fmaxf(__uint_as_float(amax[win]), 1e-6f), 1.f / 127.f);
}

// |prologue(x)| max over window blockIdx.x's valid rows (h0-1 .. h0+br,
// inside the sample), split over gridDim.y blocks.
template <bool GN, typename T>
__global__ void __launch_bounds__(kAmaxThreads)
window_amax(const T* __restrict__ x, const float* __restrict__ gs,
            const float* __restrict__ gb, unsigned* __restrict__ amax, int H,
            int W, int C, int br) {
  const int win = blockIdx.x;
  const int hb = H / br;
  const int b = win / hb;
  const int hw0 = (win % hb) * br;
  const int r_lo = max(hw0 - 1, 0), r_hi = min(hw0 + br + 1, H);
  const int64_t groups = int64_t(r_hi - r_lo) * W * (C / 8);
  const int64_t g0 = groups * blockIdx.y / gridDim.y;
  const int64_t g1 = groups * (blockIdx.y + 1) / gridDim.y;
  const T* base = x + (int64_t(b) * H + r_lo) * W * C;
  const float* g = GN ? gs + int64_t(b) * C : nullptr;
  const float* bb = GN ? gb + int64_t(b) * C : nullptr;
  float m = 0.f;
  for (int64_t i = g0 + threadIdx.x; i < g1; i += kAmaxThreads) {
    float f[8];
    load8(base + i * 8, f);
    const int c = int((i * 8) % C);
#pragma unroll
    for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(prologue<GN>(f[j], g, bb, c + j)));
  }
  __shared__ float red[kAmaxThreads / 32];
  m = warp_max(m);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < kAmaxThreads / 32 ? red[threadIdx.x] : 0.f;
    m = warp_max(m);
    if (threadIdx.x == 0) atomicMax(amax + win, __float_as_uint(m));
  }
}

// Shared memory of one block: three column-shifted int8 copies of the input
// patch (k planes of (rmax+2)*tw pixels x 16 bytes, 32-byte skew), one weight
// tap (k planes of BN rows x 16 bytes), the epilogue's per-warp scratch.
struct ConvPlan {
  int tw, rmax, plane_a, copy_a;
  size_t bytes;
  __host__ __device__ explicit ConvPlan(int tw_) : tw(tw_), rmax(128 / tw_) {
    plane_a = (rmax + 2) * tw * 16 + 32;
    copy_a = kPlanes * plane_a;
    bytes = size_t(3) * copy_a + size_t(kPlanes) * kPlaneB + kScratchBytes;
  }
};

// One block: output pixels rows h0 .. h0+rows-1, columns col0 .. col0+tw-1
// of sample b (all inside one scale window), output channels o0 .. o0+BN-1.
template <bool GN, typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3_s8(const T* __restrict__ x, const int8_t* __restrict__ w,
           const float* __restrict__ ws, const float* __restrict__ bias,
           const float* __restrict__ gs, const float* __restrict__ gb,
           const T* __restrict__ res, T* __restrict__ out,
           const unsigned* __restrict__ amax, float* __restrict__ sx_out,
           int8_t* __restrict__ xq_out, int H, int W, int C, int O, int br,
           int tw, int rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  const ConvPlan P(tw);
  int8_t* as = reinterpret_cast<int8_t*>(smem);
  int8_t* bs = as + 3 * P.copy_a;
  int* scratch = reinterpret_cast<int*>(bs + kPlanes * kPlaneB);

  const int tiles_w = W / tw;
  const int tiles_per_win = (br / rows) * tiles_w;
  const int win = blockIdx.y / tiles_per_win;
  const int t = blockIdx.y % tiles_per_win;
  const int tr = t / tiles_w, tc = t % tiles_w;
  const int hb = H / br;
  const int b = win / hb;
  const int h0 = (win % hb) * br + tr * rows;
  const int col0 = tc * tw;
  const int o0 = blockIdx.x * BN;
  const float s = window_scale(amax, win);
  const float inv = __fdiv_rn(1.f, s);
  if (sx_out != nullptr && blockIdx.x == 0 && t == 0 && threadIdx.x == 0)
    sx_out[win] = s;
  const float* g = GN ? gs + int64_t(b) * C : nullptr;
  const float* bb = GN ? gb + int64_t(b) * C : nullptr;
  // the stages entry point also gets the windows, written once (by the
  // blocks of the first channel block) from the unshifted copy
  const bool write_xq = xq_out != nullptr && blockIdx.x == 0;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0);

  const int prow = P.rmax + 2;                // patch rows held (rows+2 used)
  const int items = 3 * prow * tw * (BK / 8);
  for (int c0 = 0; c0 < C; c0 += BK) {
    __syncthreads();   // the previous chunk's products are done with as / bs
    for (int i = threadIdx.x; i < items; i += kThreads) {
      const int grp = i % (BK / 8);
      int rest = i / (BK / 8);
      const int col = rest % tw;
      rest /= tw;
      const int r = rest % prow;
      const int dw = rest / prow;
      const int hi = h0 - 1 + r, wi = col0 + col + dw - 1, c = c0 + grp * 8;
      unsigned lo = 0u, hi8 = 0u;
      if (r < rows + 2 && hi >= 0 && hi < H && wi >= 0 && wi < W && c < C) {
        float f[8];
        load8(x + ((int64_t(b) * H + hi) * W + wi) * C + c, f);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float v = prologue<GN>(f[j], g, bb, c + j);
          const float q = fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.f), 127.f);
          const unsigned byte = static_cast<unsigned>(static_cast<int>(q)) & 0xffu;
          if (j < 4) lo |= byte << (8 * j);
          else hi8 |= byte << (8 * (j - 4));
        }
      }
      const uint2 q8 = make_uint2(lo, hi8);
      *reinterpret_cast<uint2*>(as + dw * P.copy_a + (grp / 2) * P.plane_a +
                                (r * tw + col) * 16 + (grp % 2) * 8) = q8;
      if (write_xq && dw == 1 && r < rows + 2 && c < C)
        *reinterpret_cast<uint2*>(
            xq_out + ((int64_t(win) * (br + 2) + tr * rows + r) * W + col0 + col) * C +
            c) = q8;
    }
    for (int tap = 0; tap < 9; ++tap) {
      if (tap > 0) __syncthreads();   // the previous tap's products are done with bs
      for (int i = threadIdx.x; i < BN * kPlanes; i += kThreads) {
        const int o = i / kPlanes, p = i % kPlanes;
        const int c = c0 + p * 16;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (o0 + o < O && c < C)
          v = *reinterpret_cast<const uint4*>(w + (int64_t(o0 + o) * 9 + tap) * C + c);
        *reinterpret_cast<uint4*>(bs + p * kPlaneB + o * 16) = v;
      }
      __syncthreads();
      // tap (dh, dw): output pixel m reads patch pixel m + dh*tw of copy dw
      const int8_t* a_tap = as + (tap % 3) * P.copy_a + (tap / 3) * tw * 16;
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> fb[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(
              fa[i], reinterpret_cast<const signed char*>(
                         a_tap + p * P.plane_a + (wm * 32 + i * 16) * 16), 16);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::load_matrix_sync(
              fb[j], reinterpret_cast<const signed char*>(
                         bs + p * kPlaneB + (wn * 64 + j * 16) * 16), 16);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    }
  }

  int* sc = scratch + warp * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int m = wm * 32 + i * 16 + e / 16;
        const int n = o0 + wn * 64 + j * 16 + e % 16;
        const int row = m / tw, col = m % tw;
        if (row >= rows || n >= O) continue;
        const int64_t px = (int64_t(b) * H + h0 + row) * W + col0 + col;
        float y = __fmul_rn(__fmul_rn(__int2float_rn(sc[e]), s), ws[n]);
        if (bias) y = __fadd_rn(y, bias[n]);
        if (res) y = __fadd_rn(y, to_f(res[px * O + n]));
        store_f(out + px * O + n, y);
      }
      __syncwarp();
    }
  }
}

template <bool GN, typename T>
cudaError_t launch(const T* x, const int8_t* w, const float* ws,
                   const float* bias, const float* gs, const float* gb,
                   const T* res, T* out, unsigned* amax, float* sx,
                   int8_t* xq, int B, int H, int W, int C, int O, int br,
                   cudaStream_t s) {
  const int nb = B * H / br;
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(unsigned) * nb, s);
  if (err != cudaSuccess) return err;
  // enough blocks to fill the card twice, each of at least 1024 groups of 8
  const int64_t groups = int64_t(std::min(br + 2, H)) * W * (C / 8);
  const int64_t slices =
      std::max<int64_t>(1, std::min<int64_t>((264 + nb - 1) / nb, groups / 1024));
  window_amax<GN, T><<<dim3(nb, unsigned(slices)), kAmaxThreads, 0, s>>>(x, gs, gb, amax,
                                                                     H, W, C, br);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int tw = W % 64 == 0 ? 64 : 32;
  const ConvPlan P(tw);
  const int rows = std::min(P.rmax, br);
  if (br % rows) return cudaErrorInvalidValue;
  auto kern = conv3x3_s8<GN, T>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(P.bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((O + BN - 1) / BN, nb * (br / rows) * (W / tw));
  kern<<<grid, kThreads, P.bytes, s>>>(x, w, ws, bias, gs, gb, res, out, amax, sx,
                                        xq, H, W, C, O, br, tw, rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t conv3x3(const void* x, const void* w, const void* ws,
                    const void* bias, const void* gs, const void* gb,
                    const void* res, void* out, void* amax, void* sx, void* xq,
                    int B, int H, int W, int C, int O, int br, cudaStream_t s) {
  if (C % 16 || W % 32 || br < 1 || H % br) return cudaErrorInvalidValue;
  const auto* xt = static_cast<const T*>(x);
  const auto* wq = static_cast<const int8_t*>(w);
  const auto* wsf = static_cast<const float*>(ws);
  const auto* bf = static_cast<const float*>(bias);
  const auto* g = static_cast<const float*>(gs);
  const auto* be = static_cast<const float*>(gb);
  const auto* r = static_cast<const T*>(res);
  auto* o = static_cast<T*>(out);
  auto* a = static_cast<unsigned*>(amax);
  auto* sxf = static_cast<float*>(sx);
  auto* q = static_cast<int8_t*>(xq);
  if (g != nullptr)
    return launch<true, T>(xt, wq, wsf, bf, g, be, r, o, a, sxf, q, B, H, W, C, O, br, s);
  return launch<false, T>(xt, wq, wsf, bf, g, be, r, o, a, sxf, q, B, H, W, C, O, br, s);
}

}  // namespace

// x bf16 [B, H, W, C] contiguous; w int8 [O, 3, 3, C]; ws f32 [O]; bias f32
// [O] or null; gs/gb f32 [B, C] (the prologue) or null; res bf16 [B, H, W, O]
// or null; out bf16 [B, H, W, O].  Scratch: amax (4 bytes x B*H/br).  sx f32
// [B*H/br] receives the window scales; xq int8 [B*H/br, br+2, W, C] the
// quantized windows, or null.  C a multiple of 16, W of 32, br divides H.
// Returns a cudaError_t (0 on success).  The `_f32` entry point takes x, res
// and out in f32, with the same arguments otherwise.
extern "C" int cfgpp_int8_conv3x3(const void* x, const void* w, const void* ws,
                                  const void* bias, const void* gs, const void* gb,
                                  const void* res, void* out, void* amax, void* sx,
                                  void* xq, int B, int H, int W, int C, int O,
                                  int br, void* stream) {
  return conv3x3<bf16>(x, w, ws, bias, gs, gb, res, out, amax, sx, xq, B, H, W,
                       C, O, br, static_cast<cudaStream_t>(stream));
}

extern "C" int cfgpp_int8_conv3x3_f32(const void* x, const void* w,
                                      const void* ws, const void* bias,
                                      const void* gs, const void* gb,
                                      const void* res, void* out, void* amax,
                                      void* sx, void* xq, int B, int H, int W,
                                      int C, int O, int br, void* stream) {
  return conv3x3<float>(x, w, ws, bias, gs, gb, res, out, amax, sx, xq, B, H,
                        W, C, O, br, static_cast<cudaStream_t>(stream));
}
