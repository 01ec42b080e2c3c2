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
// bf16, the TPU kernel's output dtype whatever it reads (for f32
// activations stored widened back to f32, exactly JAX's bf16 result cast to
// f32).  Every f32 step uses the _rn intrinsics so that nvcc contracts
// nothing into an fma: the plain PyTorch version (kernels/int8_conv.py)
// rounds each step on its own.
//
// Layouts: x [B, H, W, C] and residual/out [B, H, W, O], all bf16 or all
// f32 (the `_f32` entry point; the TPU kernel reads either), contiguous NHWC
// (the port's NCHW channels_last memory); w int8 [O, 3, 3, C], so a row of
// the weights is k-contiguous in tap-major order (k = (dh*3 + dw)*C + c).
//
// What bounds it on the H100: at the SD-1.5 sites (32x32 and 64x64 latents,
// C = 640..1920, O = 640..1280, batch 2) each call is 27-60 GOP of int8
// work, 14-31 us at the 1979 TOP/s peak, against 4-10 MB of activations
// (1-3 us at 3.35 TB/s): the tensor cores, if each input is quantized once.
//
// What the design does about that.  The TPU kernel quantizes its window
// once and reuses it over a sequential output-channel loop; a Hopper grid
// runs its blocks in no order, so the counterpart is a pass before the
// GEMM that quantizes each window exactly once.  The windows overlap (a
// window's halo rows are interior rows of its neighbours, quantized there
// with another scale), so the int8 copy holds br + 2 rows per window.
// Three passes on the stream, each checked:
//   1. `window_amax` (grid: window x slice) applies the prologue and reduces
//      |x| over its part of a window; atomicMax on the float bits (all
//      values are >= 0) combines the slices.
//   2. `quantize_windows` applies the prologue once per element and window
//      and writes the int8 windows xq [B*H/br, br+2, W, C] (rows beyond the
//      sample's edge zero) and the scales.  It reads x about (br+2)/br times
//      and writes half as many bytes; the buffer (2.9-6.6 MB at the SD-1.5
//      sites) stays in L2 for the GEMM.
//   3. `conv_s8`: an implicit GEMM, M = B*H*W output pixels, N = O,
//      K = 9*C in tap-major order, on int8_gemm.cuh (the mma.sync m16n8k32,
//      ldmatrix, swizzle and cp.async primitives int8_matmul.cu also uses,
//      and its mma_ring / store_tile: the ring, the register epilogue, a
//      programmatic dependent launch that requests the first weight tiles
//      before it waits for the windows), in 128 x 128 tiles with 128-byte k
//      steps.  The A tile of k step (tap (dh, dw), channels c0..c0+127) is
//      a gather: output pixel (b, h, w) reads row (win, h mod br + dh,
//      w + dw - 1) of the window buffer, win = (b*H + h)/br, by 16-byte
//      cp.async; columns outside [0, W) and channels past C take the
//      zero-fill form.  So no shifted copies and no padding columns exist,
//      and a tile may straddle windows: the epilogue scales each row by its
//      own pixel's window scale.
//   The 32^2 sites have 80-160 output tiles for 264 resident-block slots,
//   so the k loop is split over up to 4 blocks of a thread block cluster,
//   which add their int32 sums through distributed shared memory before
//   the one dequant (`reduce_cluster_tile`): exact in any order, so the
//   output is the unsplit one.
//
// Built by cfgpp_tpu_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through ctypes (plain C entry point at the end of this file).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <algorithm>
#include <math.h>
#include <stdint.h>

#include "int8_gemm.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using namespace int8_gemm;
namespace cg = cooperative_groups;

constexpr int kPassThreads = 256;   // window_amax and quantize_windows
constexpr int kMaxSplits = 4;       // blocks of one output tile over k

// The GEMM's tile: 128 x 128 outputs, 8 warps of 64 x 32, 128-byte k tiles
// (half the barriers and waits per product of the 64-byte ones) in three
// stages (96 KB, so that two blocks fit an SM).
using ConvTile = Tile<128, 128, 64, 32, 128, 3>;

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

__device__ __forceinline__ float window_scale(const unsigned* amax, int64_t win) {
  return __fmul_rn(fmaxf(__uint_as_float(amax[win]), 1e-6f), 1.f / 127.f);
}

// |prologue(x)| max over window blockIdx.x's valid rows (h0-1 .. h0+br,
// inside the sample), split over gridDim.y blocks.
template <bool GN, typename T>
__global__ void __launch_bounds__(kPassThreads)
window_amax(const T* __restrict__ x, const float* __restrict__ gs,
            const float* __restrict__ gb, unsigned* __restrict__ amax, int H,
            int W, int C, int br) {
  const int win = blockIdx.x;
  const int hb = H / br;
  const int b = win / hb;
  const int hw0 = (win % hb) * br;
  const int r_lo = max(hw0 - 1, 0), r_hi = min(hw0 + br + 1, H);
  const int c8 = C / 8;
  const int groups = (r_hi - r_lo) * W * c8;   // < 2^31: checked at launch
  const int g0 = int(int64_t(groups) * blockIdx.y / gridDim.y);
  const int g1 = int(int64_t(groups) * (blockIdx.y + 1) / gridDim.y);
  const T* base = x + (int64_t(b) * H + r_lo) * W * C;
  const float* g = GN ? gs + int64_t(b) * C : nullptr;
  const float* bb = GN ? gb + int64_t(b) * C : nullptr;
  float m = 0.f;
  for (int i = g0 + threadIdx.x; i < g1; i += kPassThreads) {
    float f[8];
    load8(base + int64_t(i) * 8, f);
    const int c = i % c8 * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(prologue<GN>(f[j], g, bb, c + j)));
  }
  __shared__ float red[kPassThreads / 32];
  m = warp_max(m);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < kPassThreads / 32 ? red[threadIdx.x] : 0.f;
    m = warp_max(m);
    if (threadIdx.x == 0) atomicMax(amax + win, __float_as_uint(m));
  }
}

// xq [nb, br+2, W, C] int8: row r of window win is input row
// (win % (H/br))*br - 1 + r of sample win / (H/br), prologued and quantized
// with the window's scale, or zeros beyond the sample's edge; sx [nb] the
// scales.  One thread per 8 channels (a 16-byte bf16 or 32-byte f32 load,
// an 8-byte int8 store), grid-stride.
template <bool GN, typename T>
__global__ void __launch_bounds__(kPassThreads)
quantize_windows(const T* __restrict__ x, const float* __restrict__ gs,
                 const float* __restrict__ gb,
                 const unsigned* __restrict__ amax, float* __restrict__ sx,
                 int8_t* __restrict__ xq, int H, int W, int C, int br,
                 int groups) {
  // 32-bit index math: groups < 2^31, checked at launch
  const int c8 = C / 8;
  const int per_row = W * c8;
  const int per_win = (br + 2) * per_row;
  const int hb = H / br;
  for (int i = blockIdx.x * kPassThreads + threadIdx.x; i < groups;
       i += gridDim.x * kPassThreads) {
    const int win = i / per_win;
    const int rest = i - win * per_win;
    const int r = rest / per_row;
    const int px = rest - r * per_row;           // col * c8 + chunk
    const int b = win / hb;
    const int h = (win - b * hb) * br - 1 + r;
    const float s = window_scale(amax, win);
    if (rest == 0) sx[win] = s;
    unsigned lo = 0u, hi = 0u;
    if (h >= 0 && h < H) {
      const float inv = __fdiv_rn(1.f, s);
      const int c = px % c8 * 8;
      const float* g = GN ? gs + int64_t(b) * C : nullptr;
      const float* bb = GN ? gb + int64_t(b) * C : nullptr;
      float f[8];
      load8(x + ((int64_t(b) * H + h) * per_row + px) * 8, f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v = prologue<GN>(f[j], g, bb, c + j);
        const float q = fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.f), 127.f);
        const unsigned byte = static_cast<unsigned>(static_cast<int>(q)) & 0xffu;
        if (j < 4) lo |= byte << (8 * j);
        else hi |= byte << (8 * (j - 4));
      }
    }
    *reinterpret_cast<uint2*>(xq + int64_t(i) * 8) = make_uint2(lo, hi);
  }
}

// The blocks of a cluster along z computed the same output tile over
// different k ranges.  Each writes its int32 tile to its shared memory (the
// drained ring; columns XOR-swizzled by row against bank conflicts), then
// reduces rows rank, rank + s, ... over the cluster's tiles (distributed
// shared memory) and stores them: the int32 sums are exact in any order,
// and the dequant comes after them, so the output equals the unsplit one.
template <class Cfg, typename T, class RowScale>
__device__ __forceinline__ void reduce_cluster_tile(
    const Acc<Cfg>& acc, int8_t* smem, int m0, int n0, int m, int O,
    const RowScale& row_scale, const float* __restrict__ ws,
    const float* __restrict__ bias, const T* __restrict__ res,
    T* __restrict__ out) {
  static_assert(Cfg::BM * Cfg::BN * 4 <= Cfg::kSmem, "the int32 tile fits the ring");
  cg::cluster_group cluster = cg::this_cluster();
  int* tile = reinterpret_cast<int*>(smem);
  auto at = [](int r, int c) { return r * Cfg::BN + (c ^ ((r & 7) << 3)); };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / Cfg::kWarpsN, wn = warp % Cfg::kWarpsN;
  const int g = lane / 4, t = lane % 4;
  cp_async_wait<0>();
  __syncthreads();                 // every warp is done with the ring
#pragma unroll
  for (int i = 0; i < Cfg::MT; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int j = 0; j < Cfg::NT; ++j) {
        const int r = wm * Cfg::WM + i * 16 + g + 8 * half;
        *reinterpret_cast<int2*>(tile + at(r, wn * Cfg::WN + j * 8 + 2 * t)) =
            make_int2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
      }
  cluster.sync();
  const int s = int(cluster.num_blocks()), rank = int(cluster.block_rank());
  constexpr int kPairs = Cfg::BN / 2;
  const int rows = (Cfg::BM - rank + s - 1) / s;
  for (int idx = threadIdx.x; idx < rows * kPairs; idx += Cfg::kThreads) {
    const int r = rank + (idx / kPairs) * s, c = (idx % kPairs) * 2;
    int2 sum = make_int2(0, 0);
    for (int q = 0; q < s; ++q) {
      const int2 v =
          *reinterpret_cast<const int2*>(cluster.map_shared_rank(tile, q) + at(r, c));
      sum.x += v.x;
      sum.y += v.y;
    }
    const int row = m0 + r;
    if (row < m && n0 + c < O)
      store_pair(sum.x, sum.y, row_scale(row), ws, bias, res, out, row, n0 + c, O);
  }
  cluster.sync();                  // no block leaves while its tile is read
}

// Output tile: pixels [m0, m0+BM) of the m = B*H*W output pixels x output
// channels [n0, n0+BN), from the window buffer xq and w [O, 9*C], over k
// steps [z * ksteps, (z + 1) * ksteps) of the 9 * ceil(C / BK) for
// blockIdx.z = z; with gridDim.z > 1 the z blocks of a tile form a cluster
// that reduces their sums (`reduce_cluster_tile`).
template <class Cfg, typename T>
__global__ void __launch_bounds__(Cfg::kThreads)
conv_s8(const int8_t* __restrict__ xq, const int8_t* __restrict__ w,
        const float* __restrict__ sx, const float* __restrict__ ws,
        const float* __restrict__ bias, const T* __restrict__ res,
        T* __restrict__ out, int m, int W, int C, int O, int br,
        int ksteps) {
  extern __shared__ __align__(128) int8_t smem[];
  constexpr int kCopiesA = Cfg::BM * Cfg::kChunks / Cfg::kThreads;
  constexpr int kCopiesB = Cfg::BN * Cfg::kChunks / Cfg::kThreads;
  constexpr int BK = Cfg::BK, kRowStep = Cfg::kThreads / Cfg::kChunks;
  const int m0 = blockIdx.y * Cfg::BM;
  const int n0 = blockIdx.x * Cfg::BN;
  const int chunks = (C + BK - 1) / BK;        // k steps per tap

  // This thread's copies: 16-byte chunk c of tile rows r, r + kThreads/4,
  // ...  For each A row, the window-buffer pixel its output pixel reads at
  // tap (0, 1) (window row h mod br, its own column) and which column
  // shifts dw = 0, 1, 2 stay inside [0, W) (none past the last pixel); for
  // each B row, its weight row, if inside O.  A k step then adds one offset.
  const int c = threadIdx.x % Cfg::kChunks, r0 = threadIdx.x / Cfg::kChunks;
  const int8_t* a_src[kCopiesA];
  unsigned a_dw[kCopiesA];
#pragma unroll
  for (int it = 0; it < kCopiesA; ++it) {
    const int p = m0 + r0 + it * kRowStep;
    const int64_t row = p / W;               // b*H + h
    const int col = int(p % W);
    a_src[it] = xq + (((row / br) * (br + 2) + row % br) * W + col) * C + c * 16;
    a_dw[it] = p < m ? (col > 0) | 2u | (col + 1 < W ? 4u : 0u) : 0u;
  }
  const int8_t* b_src[kCopiesB];
  bool b_ok[kCopiesB];
#pragma unroll
  for (int it = 0; it < kCopiesB; ++it) {
    const int o = n0 + r0 + it * kRowStep;
    b_ok[it] = o < O;
    b_src[it] = w + int64_t(o) * 9 * C + c * 16;
  }
  auto load_a = [&](int8_t* as, int kt) {
    const int tap = kt / chunks, dh = tap / 3, dw = tap - dh * 3;
    const int c0 = (kt - tap * chunks) * BK;
    const int off = (dh * W + dw - 1) * C + c0;
    const bool in_c = c0 + c * 16 < C;
#pragma unroll
    for (int it = 0; it < kCopiesA; ++it) {
      const bool ok = in_c && (a_dw[it] >> dw & 1u);
      cp_async16(as + Cfg::swz(r0 + it * kRowStep, c),
                 ok ? a_src[it] + off : xq, ok ? 16 : 0);
    }
  };
  auto load_b = [&](int8_t* bs, int kt) {
    const int tap = kt / chunks;
    const int c0 = (kt - tap * chunks) * BK;
    const int off = tap * C + c0;
    const bool in_c = c0 + c * 16 < C;
#pragma unroll
    for (int it = 0; it < kCopiesB; ++it) {
      const bool ok = in_c && b_ok[it];
      cp_async16(bs + Cfg::swz(r0 + it * kRowStep, c),
                 ok ? b_src[it] + off : w, ok ? 16 : 0);
    }
  };
  const int kt0 = blockIdx.z * ksteps;
  int acc[Cfg::MT][Cfg::NT][4];
  mma_ring<Cfg>(smem, min(ksteps, 9 * chunks - kt0),
                [&](int8_t* as, int kt) { load_a(as, kt0 + kt); },
                [&](int8_t* bs, int kt) { load_b(bs, kt0 + kt); }, acc);
  auto row_scale = [&](int row) { return sx[row / W / br]; };
  if (gridDim.z > 1)
    reduce_cluster_tile<Cfg>(acc, smem, m0, n0, m, O, row_scale, ws, bias, res,
                             out);
  else
    store_tile<Cfg>(acc, m0, n0, m, O, row_scale, ws, bias, res, out);
}

// The split over k: the fewest blocks per output tile (at most
// kMaxSplits) that give every resident-block slot of the card a block.
// Read off an H100 80GB HBM3 with cfgpp_tpu_torch/tools/int8_ab.py
// (--library int8_conv) against 64 x 64 and 64-byte-k tiles and every
// split up to 4: at the SD-1.5 sites this picks 2, 4, 4 and 1 (160, 80, 80
// and 320 tiles on 264 slots), each within 2% of the best measured.
template <typename T>
int conv_splits(int m, int O) {
  const int64_t slots =
      int64_t(sm_count()) * blocks_per_sm<ConvTile, conv_s8<ConvTile, T>>();
  const int64_t tiles = int64_t((m + ConvTile::BM - 1) / ConvTile::BM) *
                        ((O + ConvTile::BN - 1) / ConvTile::BN);
  return int(std::min<int64_t>(kMaxSplits, (slots + tiles - 1) / tiles));
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
  // enough blocks to fill the card 8 times, each of at least 256 groups of
  // 8 (a thread's loads in flight hide the latency; the loop has few turns)
  const int64_t groups = int64_t(std::min(br + 2, H)) * W * (C / 8);
  const int64_t want = int64_t(sm_count()) * 8;
  const int64_t slices =
      std::max<int64_t>(1, std::min<int64_t>((want + nb - 1) / nb, groups / 256));
  window_amax<GN, T><<<dim3(nb, unsigned(slices)), kPassThreads, 0, s>>>(
      x, gs, gb, amax, H, W, C, br);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int64_t qgroups = int64_t(nb) * (br + 2) * W * (C / 8);
  if (qgroups >= (int64_t(1) << 31)) return cudaErrorInvalidValue;
  const int64_t qblocks = std::min<int64_t>(
      (qgroups + kPassThreads - 1) / kPassThreads, int64_t(sm_count()) * 16);
  quantize_windows<GN, T><<<unsigned(qblocks), kPassThreads, 0, s>>>(
      x, gs, gb, amax, sx, xq, H, W, C, br, int(qgroups));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int m = B * H * W;   // < 2^30: qgroups >= 2 m (C >= 16) < 2^31
  const int splits = conv_splits<T>(m, O);
  const int ksteps = 9 * ((C + ConvTile::BK - 1) / ConvTile::BK);
  const dim3 grid((O + ConvTile::BN - 1) / ConvTile::BN,
                  (m + ConvTile::BM - 1) / ConvTile::BM, splits);
  return launch_pdl<ConvTile, conv_s8<ConvTile, T>>(
      grid, splits, s, xq, w, sx, ws, bias, res, out, m, W, C, O, br,
      (ksteps + splits - 1) / splits);
}

template <typename T>
cudaError_t conv3x3(const void* x, const void* w, const void* ws,
                    const void* bias, const void* gs, const void* gb,
                    const void* res, void* out, void* amax, void* sx, void* xq,
                    int B, int H, int W, int C, int O, int br, cudaStream_t s) {
  if (C % 16 || O % 2 || br < 1 || H % br || xq == nullptr)
    return cudaErrorInvalidValue;
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

// x bf16 [B, H, W, C] contiguous, 16-byte aligned; w int8 [O, 3, 3, C],
// 16-byte aligned; ws f32 [O] and bias f32 [O] or null, 8-byte aligned;
// gs/gb f32 [B, C] (the prologue) or null; res bf16 [B, H, W, O] or null;
// out bf16 [B, H, W, O].  Scratch: amax (4 bytes x B*H/br).  sx f32
// [B*H/br] receives the window scales; xq int8 [B*H/br, br+2, W, C] the
// quantized windows the GEMM reads.  C a multiple of 16, O of 2, br divides
// H.  Returns a cudaError_t (0 on success).  The `_f32` entry point takes
// x, res and out in f32 (out holding bf16-rounded values), with the same
// arguments otherwise.
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
