// Int8-score flash-attention forward for Hopper (sm_90a), bf16 or f32 in;
// the output rounded to bf16 as the TPU kernels write it (out_shape bf16),
// stored as bf16 or, for f32 inputs, widened back to f32.
//
// Replaces the Pallas TPU kernels cfgpp_tpu/kernels/flash_attention.py:
// flash_attention_hd_int8 and flash_attention_qkv_packed_int8, both with the
// body _kernel_single_int8, inside their single-kv-block domain (the callers
// in kernels/flash_attention.py run the bf16 / f32 kernels outside it, as
// the JAX functions do).  Its numerics, step by step: per (row, head) a q
// scale sq = max(amax|q|, 1e-6) * (1/127); per (batch, head) ONE scalar k
// scale sk over every kv row; q * (1/sq) and k * (1/sk) rounded half to even
// and clipped to +-127; an exact int8 q k^T with int32 accumulation; the
// scores s = acc * (sq * (sk * q_scale)) with q_scale = d^-1/2 * log2(e), in
// this order; kv columns at or past kv_len masked; p = exp2(s), max-free as
// the TPU's one-block softmax (_softmax_pv), rounded to v's dtype; out =
// (p@v) / max(sum p, 1e-37) with the sum over the rounded p.  Every step
// uses the _rn intrinsics and exp2f, so the int8 q and k, both scales and p
// equal the plain version's (kernels/flash_attention.py) bit for bit; only
// the f32 order of the two sums differs.  With f32 activations (the `_f32`
// entry points, as the TPU kernel takes f32) p is not rounded and p@v runs
// in f32 on the CUDA cores (`PvF32`): a TF32 or bf16 product would round p
// and v.
//
// Layout: token-major q [B, Nq, H*D], k/v [B, Nkv, H*D], each read with its
// own row stride; the packed entry point reads q, k and v in place as three
// channel-offset views of one [B, N, 3*H*D] array.
//
// What bounds it on the H100: at the SD-1.5 site (level 1: 1024 tokens,
// d=80, 8 heads, batch 2) the two products are 2.7 GOP of int8 and 2.7
// GFLOP of bf16, 4.1 us at the tensor cores' peak rates, and the q, k, v
// and out bytes (10.5 MB) 3.1 us of memory time: the work is small, so what
// bounds a call is the latency of its passes and how well the grid fills the
// card.
// The first form of this kernel lost most of it to shared-memory traffic:
// every block quantized each k tile again (16x per head at the site),
// stored its int32 scores and its p to shared memory for a one-warp-per-row
// softmax, and loaded its tiles synchronously.
//
// What the design does about that (FlashAttention-2 on mma.sync, the form
// of flash_attention.cu with the score in int8):
// 1. Pre-passes.  `k_absmax` reduces |k| per (batch, head) over every kv
//    row (atomicMax on the float bits).  `quantize_k` then writes int8 k
//    once per call into scratch, tile-ready: [B, H, Nkv_pad, DK], the head
//    dim zero-padded to the int8 mma depth DK (40->64, 64, 80->96, 160) and
//    the rows at or past kv_len zero up to Nkv_pad (Nkv rounded up to 64).
//    At the site it is 1.5 MB and stays in L2.
// 2. `flash_fwd_s8`, one block of four warps per 64 q rows x head x batch.
//    Each warp owns 16 q rows: it reads them from device memory straight
//    into the m16n8k32 A-fragment layout (each quad of lanes holds two whole
//    rows), takes the row amax across the quad, quantizes once and keeps the
//    int8 fragments in registers for the whole kv loop.  int8 k tiles and v
//    tiles stream through a two-stage cp.async ring (one __syncthreads per
//    tile).  S = q k^T runs on mma.sync m16n8k32 s8 -> s32 (int8_gemm.cuh);
//    its accumulator fragment has the layout of the f32 one of m16n8k16, so
//    the scores are dequantized, masked and exponentiated in registers, p is
//    rounded to bf16 there and becomes the A operand of p@v on m16n8k16
//    bf16, with v read by ldmatrix.trans.  No score or p goes through shared
//    memory, and the max-free softmax needs no running max or rescale.  The
//    output accumulator and the row sums stay in registers.
// 3. f32: the same score part; p (f32, not rounded) is staged through
//    shared memory into a register micro-tile FFMA product (flash_attention_
//    f32.cu's form), whose accumulator stays in registers across the loop.
// Sizing: the site's grid is 16 q tiles of 64 rows x 8 heads x batch 2 =
// 256 blocks of 128 threads, about two per SM, so every SM works; more
// rows per warp would leave SMs idle, fewer would repeat the k and v tile
// loads.  kv tiles of 64 rows (32 at d=160, whose output accumulator takes
// 80 registers a thread).
// Two other forms were built and measured on the H100 at the site (tools/
// int8_ab.py, in turns; PERF.md) and lost to this one: the two
// pre-passes fused into one launch (a cluster of 8 blocks per (batch, head)
// reducing the k max through distributed shared memory) with the main
// kernel as its programmatic dependent, 0.0556 ms a call against 0.0428
// (the cluster pass alone took 8 us, and the early main blocks slowed the
// f32 kernel by 40%); and each block's kv loop split over two or four
// groups of four warps whose sums are added at the end (exact to add: the
// softmax is max-free), 0.0516 / 0.0515 ms against 0.0422 at d=80 and
// 0.0354 / 0.0397 against 0.0359 at d=40: twice or four times the warps
// per SM did not pay (each block's shared memory grew as much; the
// profiler cannot say more, and ncu does not run on that machine).
//
// Built by cfgpp_tpu_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through ctypes (plain C entry points at the end of this file).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <algorithm>
#include <math.h>
#include <stdint.h>

#include "int8_gemm.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using int8_gemm::cp_async16;
using int8_gemm::cp_async_commit;
using int8_gemm::cp_async_wait;
using int8_gemm::ldmatrix_x4;
using int8_gemm::mma_s8;
using int8_gemm::smem_u32;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = kWarps * 16;      // q rows per block: 16 per warp
constexpr int kAmaxThreads = 256;
constexpr int kQuantThreads = 256;
constexpr int kKvPad = 64;            // scratch rows are padded to this

// The int8 k depth: the head dim padded to the m16n8k32 k step.
__host__ __device__ constexpr int k_depth(int d) { return (d + 31) / 32 * 32; }

// T: the activations' type (bf16, or f32 for the `_f32` entry points); v
// and p are held in it.
template <int D, int BKV, typename T>
struct Plan {
  static constexpr int DK = k_depth(D);          // int8 q/k depth
  static constexpr int DV = (D + 15) / 16 * 16;  // p@v output width
  static constexpr int LDK = DK + 16;            // k tile row, bytes: no ldmatrix bank conflicts
  static constexpr int LDV = DV + 16 / int(sizeof(T));   // v tile row, elements
  static constexpr int LDP = BKV + 4;            // f32 p rows (f32 path)
  static constexpr size_t k_stage = size_t(BKV) * LDK;
  static constexpr size_t v_stage = size_t(BKV) * LDV * sizeof(T);
  static constexpr size_t v_off = 2 * k_stage;
  static constexpr size_t p_off = v_off + 2 * v_stage;
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr size_t l_off = p_off + (kF32 ? size_t(kBQ) * LDP * 4 : 0);
  static constexpr size_t bytes = l_off + (kF32 ? size_t(kBQ) * 4 : 0);
  static_assert(D % 8 == 0 && BKV % 16 == 0 && DK % 32 == 0, "tile shape");
  static_assert(k_stage % 16 == 0 && v_stage % 16 == 0, "16-byte stages");
};

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float scale_of(float amax) {
  return __fmul_rn(fmaxf(amax, 1e-6f), 1.f / 127.f);
}

__device__ __forceinline__ unsigned quantize(float v, float inv) {
  const int q = static_cast<int>(fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.f), 127.f));
  return static_cast<unsigned>(q) & 0xffu;
}

// Four consecutive activations (8- or 16-byte aligned) as f32.
__device__ __forceinline__ void load4(const bf16* p, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}
__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
}

// Four int8 values of v * inv packed little-endian (k order) in a register.
__device__ __forceinline__ uint32_t quantize4(const float* f, float inv) {
  return quantize(f[0], inv) | quantize(f[1], inv) << 8 |
         quantize(f[2], inv) << 16 | quantize(f[3], inv) << 24;
}

// Two outputs, each rounded once to bf16, stored as T.
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = __bfloat1622float2(__floats2bfloat162_rn(a, b));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a b on the tensor cores: a 16x16 bf16 (row), b 16x8 bf16 (col), c f32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage-check outputs, each null unless the stages entry point asked.
struct Stages {
  int8_t* qq;   // [B, Nq, H*D]
  float* sq;    // [B, Nq, H]
  int8_t* kq;   // [B, Nkv, H*D], rows below kv_len
  float* sk;    // [B, H]
};

// |k| max over the kv rows of one (batch, head), split over gridDim.y blocks.
template <int D, typename T>
__global__ void __launch_bounds__(kAmaxThreads)
k_absmax(const T* __restrict__ k, unsigned* __restrict__ amax, int nkv,
         int heads, int64_t ldkv) {
  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  constexpr int kGroups = D / 4;
  const int64_t items = int64_t(nkv) * kGroups;
  const int64_t i0 = items * blockIdx.y / gridDim.y;
  const int64_t i1 = items * (blockIdx.y + 1) / gridDim.y;
  const T* kg = k + int64_t(b) * nkv * ldkv + int64_t(h) * D;
  float m = 0.f;
  for (int64_t i = i0 + threadIdx.x; i < i1; i += kAmaxThreads) {
    const int64_t r = i / kGroups;
    const int c = int(i % kGroups) * 4;
    float f[4];
    load4(kg + r * ldkv + c, f);
#pragma unroll
    for (int j = 0; j < 4; ++j) m = fmaxf(m, fabsf(f[j]));
  }
  __shared__ float red[kAmaxThreads / 32];
  m = warp_max(m);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < kAmaxThreads / 32 ? red[threadIdx.x] : 0.f;
    m = warp_max(m);
    if (threadIdx.x == 0) atomicMax(amax + bh, __float_as_uint(m));
  }
}

// int8 k, once per call: kq8 [B*H, nkp, DK], rows at or past kv_len and the
// columns D..DK zero.  One thread per 4 values.
template <int D, typename T>
__global__ void __launch_bounds__(kQuantThreads)
quantize_k(const T* __restrict__ k, const unsigned* __restrict__ amax,
           int8_t* __restrict__ kq8, Stages st, int nkv, int nkp, int heads,
           int kv_len, int64_t ldkv) {
  constexpr int DK = k_depth(D), kGroups = DK / 4;
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const float sk = scale_of(__uint_as_float(amax[bh]));
  const float inv = __fdiv_rn(1.f, sk);
  if (st.sk != nullptr && blockIdx.x == 0 && threadIdx.x == 0) st.sk[bh] = sk;
  const int i = blockIdx.x * kQuantThreads + threadIdx.x;
  if (i >= nkp * kGroups) return;
  const int r = i / kGroups, c = (i % kGroups) * 4;
  uint32_t q4 = 0;
  if (r < kv_len && c < D) {
    float f[4];
    load4(k + (int64_t(b) * nkv + r) * ldkv + int64_t(h) * D + c, f);
    q4 = quantize4(f, inv);
    if (st.kq != nullptr)
      *reinterpret_cast<uint32_t*>(st.kq + (int64_t(b) * nkv + r) * heads * D +
                                   int64_t(h) * D + c) = q4;
  }
  *reinterpret_cast<uint32_t*>(kq8 + (int64_t(bh) * nkp + r) * DK + c) = q4;
}

// acc += p v for f32 p and v (the `_f32` entry points), on the CUDA cores.
// Each thread holds a register micro-tile of TM rows x NC float4 column
// chunks for the whole kv loop; per kv row it reads one float4 of v per
// chunk and feeds it to TM rows, and p four kv rows at a time.
template <int BKV, int DV, int LDP, int LDV>
struct PvF32 {
  static constexpr int CL = 4, RG = kThreads / CL, TM = kBQ / RG, NC = DV / 4 / CL;
  static_assert(kBQ % RG == 0 && (DV / 4) % CL == 0 && BKV % 4 == 0, "p v micro-tile");
  float4 acc[TM][NC];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[m][n] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  __device__ __forceinline__ void add(const float* ps, const float* vs) {
    const int cl = threadIdx.x % CL, rg = threadIdx.x / CL;
#pragma unroll 2
    for (int j = 0; j < BKV; j += 4) {
      float4 p[TM];
#pragma unroll
      for (int m = 0; m < TM; ++m)
        p[m] = *reinterpret_cast<const float4*>(ps + (rg + RG * m) * LDP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          const float4 vv = *reinterpret_cast<const float4*>(
              vs + (j + jj) * LDV + 4 * (cl + CL * n));
#pragma unroll
          for (int m = 0; m < TM; ++m) {
            const float pm = jj == 0 ? p[m].x : jj == 1 ? p[m].y
                             : jj == 2 ? p[m].z : p[m].w;
            acc[m][n].x = fmaf(pm, vv.x, acc[m][n].x);
            acc[m][n].y = fmaf(pm, vv.y, acc[m][n].y);
            acc[m][n].z = fmaf(pm, vv.z, acc[m][n].z);
            acc[m][n].w = fmaf(pm, vv.w, acc[m][n].w);
          }
        }
      }
    }
  }
};

template <int D, int BKV, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_s8(const T* __restrict__ q, const int8_t* __restrict__ kq8,
             const T* __restrict__ v, T* __restrict__ o,
             const unsigned* __restrict__ kamax, Stages st, int nq, int nkv,
             int nkp, int heads, int kv_len, float q_scale, int64_t ldq,
             int64_t ldkv) {
  using P = Plan<D, BKV, T>;
  constexpr int DK = P::DK, DV = P::DV, LDK = P::LDK, LDV = P::LDV;
  constexpr int KS = DK / 32;          // k steps of q k^T
  constexpr int NS = BKV / 8;          // n tiles of the score tile
  constexpr int NO = DV / 8;           // n tiles of the output
  constexpr int kElems = 16 / int(sizeof(T));   // elements per 16-byte chunk
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* kst = reinterpret_cast<int8_t*>(smem);
  T* vst = reinterpret_cast<T*>(smem + P::v_off);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;      // mma fragment row / column group
  const int lr = lane % 8, li = lane / 8;    // ldmatrix row / matrix index
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int bh = b * heads + h;
  const int64_t hd = int64_t(heads) * D;     // the output's row stride
  const int8_t* kg = kq8 + int64_t(bh) * nkp * DK;
  const T* vg = v + int64_t(b) * nkv * ldkv + int64_t(h) * D;
  const int n_tiles = (kv_len + BKV - 1) / BKV;

  auto load_kv = [&](int j) {
    const int kv0 = j * BKV, valid = min(BKV, kv_len - kv0);
    int8_t* ks = kst + (j & 1) * P::k_stage;
    const int8_t* ksrc = kg + int64_t(kv0) * DK;   // BKV rows, contiguous
    for (int i = threadIdx.x; i < BKV * (DK / 16); i += kThreads) {
      const int r = i / (DK / 16), c = i % (DK / 16);
      cp_async16(ks + r * LDK + c * 16, ksrc + r * DK + c * 16, 16);
    }
    T* vs = vst + (j & 1) * (P::v_stage / sizeof(T));
    constexpr int kChunks = DV / kElems, kLive = D / kElems;
    for (int i = threadIdx.x; i < BKV * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const bool live = r < valid && c < kLive;
      cp_async16(vs + r * LDV + c * kElems,
                 live ? vg + int64_t(kv0 + r) * ldkv + c * kElems : vg,
                 live ? 16 : 0);
    }
  };
  load_kv(0);
  cp_async_commit();

  // q: each quad holds rows g and g+8 of the warp's 16, lane t the columns
  // 32 ks + 4 t .. +3 (A registers 0, 1) and 32 ks + 16 + 4 t .. +3 (2, 3)
  // of every k step: the m16n8k32 A-fragment layout.
  const float k_fac = __fmul_rn(scale_of(__uint_as_float(kamax[bh])), q_scale);
  uint32_t qa[KS][4];
  float fac[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + warp * 16 + g + 8 * half;
    const bool valid = row < nq;
    const T* qr = q + (int64_t(b) * nq + (valid ? row : 0)) * ldq + int64_t(h) * D;
    float x[KS][2][4];
    float amax = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        const int c = ks * 32 + part * 16 + 4 * t;
        if (valid && c < D) {
          load4(qr + c, x[ks][part]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) x[ks][part][e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) amax = fmaxf(amax, fabsf(x[ks][part][e]));
      }
    const float sq = scale_of(quad_max(amax));
    const float inv = __fdiv_rn(1.f, sq);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        const uint32_t q4 = quantize4(x[ks][part], inv);
        qa[ks][half + 2 * part] = q4;
        const int c = ks * 32 + part * 16 + 4 * t;
        if (st.qq != nullptr && valid && c < D)
          *reinterpret_cast<uint32_t*>(st.qq + (int64_t(b) * nq + row) * hd +
                                       int64_t(h) * D + c) = q4;
      }
    if (st.sq != nullptr && valid && t == 0)
      st.sq[(int64_t(b) * nq + row) * heads + h] = sq;
    fac[half] = __fmul_rn(sq, k_fac);
  }

  float acc[P::kF32 ? 1 : NO][4];           // bf16: the output fragments
  PvF32<BKV, DV, P::LDP, LDV> pv;           // f32: the output micro-tile
  if constexpr (P::kF32) {
    pv.zero();
  } else {
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
  float lsum[2] = {0.f, 0.f};
  // ldmatrix lane offsets: B from k (n-major: two n tiles x two 16-byte k
  // halves), B from v (k-major, .trans: two k halves x two n tiles)
  const int bk_off = ((li >> 1) * 8 + lr) * LDK + (li & 1) * 16;
  const int bv_off = ((li & 1) * 8 + lr) * LDV + (li >> 1) * 8;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<0>();
    __syncthreads();   // tile j is in; every warp is done with tile j-1's stage
    if (j + 1 < n_tiles) {
      load_kv(j + 1);
      cp_async_commit();
    }
    const int8_t* ks = kst + (j & 1) * P::k_stage;
    const T* vs = vst + (j & 1) * (P::v_stage / sizeof(T));

    // S = q k^T, int32 in registers
    int sacc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = 0;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kb[4];
        ldmatrix_x4(kb, ks + np * 16 * LDK + kk * 32 + bk_off);
        mma_s8(sacc[2 * np], qa[kk], kb[0], kb[1]);
        mma_s8(sacc[2 * np + 1], qa[kk], kb[2], kb[3]);
      }

    // p = exp2(acc * fac), max-free; element e of n tile n is row g + 8 (e
    // >> 1), column n * 8 + 2 t + (e & 1)
    const int kv0 = j * BKV;
    const bool partial = kv0 + BKV > kv_len;   // only the last tile
    float p[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe = 0.f;
        if (!partial || kv0 + n * 8 + 2 * t + (e & 1) < kv_len)
          pe = exp2f(__fmul_rn(__int2float_rn(sacc[n][e]), fac[e >> 1]));
        if constexpr (!P::kF32) pe = __bfloat162float(__float2bfloat16_rn(pe));
        p[n][e] = pe;
        lsum[e >> 1] += pe;
      }

    if constexpr (P::kF32) {
      float* ps = reinterpret_cast<float*>(smem + P::p_off);
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<float2*>(ps + (warp * 16 + g + 8 * half) * P::LDP +
                                     n * 8 + 2 * t) =
              make_float2(p[n][2 * half], p[n][2 * half + 1]);
      __syncthreads();   // every warp's p is in
      pv.add(ps, reinterpret_cast<const float*>(vs));
    } else {
      // acc += p v: p (bf16) from the score fragments, v through ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
        pa[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
        pa[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
        pa[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, reinterpret_cast<const bf16*>(vs) +
                                    kk * 16 * LDV + np * 16 + bv_off);
          mma_bf16(acc[2 * np], pa, vb[0], vb[1]);
          mma_bf16(acc[2 * np + 1], pa, vb[2], vb[3]);
        }
      }
    }
  }

  // out = acc / max(l, 1e-37), one rounding to bf16
  float l[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) l[half] = fmaxf(quad_sum(lsum[half]), 1e-37f);
  T* og = o + int64_t(b) * nq * hd + int64_t(h) * D;
  if constexpr (P::kF32) {
    float* ls = reinterpret_cast<float*>(smem + P::l_off);
    if (t == 0) {
      ls[warp * 16 + g] = l[0];
      ls[warp * 16 + g + 8] = l[1];
    }
    __syncthreads();
    using Pv = PvF32<BKV, DV, P::LDP, LDV>;
    const int cl = threadIdx.x % Pv::CL, rg = threadIdx.x / Pv::CL;
#pragma unroll
    for (int m = 0; m < Pv::TM; ++m) {
      const int r = rg + Pv::RG * m;
      if (q0 + r >= nq) continue;
      const float den = ls[r];
#pragma unroll
      for (int n = 0; n < Pv::NC; ++n) {
        const int c = 4 * (cl + Pv::CL * n);
        if (c >= D) continue;
        float* dst = og + int64_t(q0 + r) * hd + c;
        const float4 a = pv.acc[m][n];
        store2(dst, a.x / den, a.y / den);
        store2(dst + 2, a.z / den, a.w / den);
      }
    }
  } else {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + warp * 16 + g + 8 * half;
      if (row >= nq) continue;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int c = n * 8 + 2 * t;
        if (c < D)
          store2(og + int64_t(row) * hd + c, acc[n][2 * half] / l[half],
                 acc[n][2 * half + 1] / l[half]);
      }
    }
  }
}

// Scratch layout (kernels/flash_attention.py allocates it): the k amax,
// 4 bytes x batch*heads, from byte 0, as the first form of this file used it
// (so that form still runs under the same wrappers);
// then, from the next multiple of 128 bytes, int8 k [B*H, Nkv_pad, DK] with
// Nkv_pad = Nkv rounded up to 64.
inline size_t kq8_offset(int bh) { return (size_t(4) * bh + 127) / 128 * 128; }

template <int D, typename T>
cudaError_t launch(const T* q, const T* k, const T* v, T* o, void* scratch,
                   Stages st, int batch, int nq, int nkv, int heads,
                   int kv_len, float q_scale, int64_t ldq, int64_t ldkv,
                   cudaStream_t s) {
  constexpr int BKV = D > 128 ? 32 : 64;
  using P = Plan<D, BKV, T>;
  const int bh = batch * heads;
  const int nkp = (nkv + kKvPad - 1) / kKvPad * kKvPad;
  auto* amax = static_cast<unsigned*>(scratch);
  auto* kq8 = static_cast<int8_t*>(scratch) + kq8_offset(bh);
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(unsigned) * bh, s);
  if (err != cudaSuccess) return err;
  // enough blocks to fill the card twice, each of at least 32 rows
  const int slices = std::max(1, std::min((264 + bh - 1) / bh, nkv / 32));
  k_absmax<D, T><<<dim3(bh, slices), kAmaxThreads, 0, s>>>(k, amax, nkv, heads, ldkv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int groups = nkp * (P::DK / 4);
  quantize_k<D, T><<<dim3((groups + kQuantThreads - 1) / kQuantThreads, bh),
                     kQuantThreads, 0, s>>>(k, amax, kq8, st, nkv, nkp, heads,
                                            kv_len, ldkv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kern = flash_fwd_s8<D, BKV, T>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(P::bytes));
  if (attr != cudaSuccess) return attr;
  dim3 grid((nq + kBQ - 1) / kBQ, heads, batch);
  kern<<<grid, kThreads, P::bytes, s>>>(q, kq8, v, o, amax, st, nq, nkv, nkp,
                                        heads, kv_len, q_scale, ldq, ldkv);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     void* scratch, Stages st, int batch, int nq, int nkv,
                     int heads, int head_dim, int kv_len, float q_scale,
                     int64_t ldq, int64_t ldkv, cudaStream_t s) {
  const auto* qb = static_cast<const T*>(q);
  const auto* kb = static_cast<const T*>(k);
  const auto* vb = static_cast<const T*>(v);
  auto* ob = static_cast<T*>(o);
  switch (head_dim) {
    case 40: return launch<40, T>(qb, kb, vb, ob, scratch, st, batch, nq, nkv, heads, kv_len, q_scale, ldq, ldkv, s);
    case 64: return launch<64, T>(qb, kb, vb, ob, scratch, st, batch, nq, nkv, heads, kv_len, q_scale, ldq, ldkv, s);
    case 80: return launch<80, T>(qb, kb, vb, ob, scratch, st, batch, nq, nkv, heads, kv_len, q_scale, ldq, ldkv, s);
    case 160: return launch<160, T>(qb, kb, vb, ob, scratch, st, batch, nq, nkv, heads, kv_len, q_scale, ldq, ldkv, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: [batch, nq, heads*head_dim], k/v: [batch, nkv, heads*head_dim], o like
// q; all bf16, contiguous, 16-byte aligned.  1 <= kv_len <= nkv; the k scale
// is taken over all nkv rows.  kamax: scratch, 16-byte aligned, of the size
// in the layout note above launch() (kernels/flash_attention.py:
// `_int8_scratch_bytes`).  qq/sq/kq/sk: the stage outputs (see Stages) or
// null.  q_scale: head_dim^-1/2 * log2(e) as f32.  Returns a cudaError_t (0
// on success).  The `_f32` entry points take q, k, v and o in f32 (p is then
// not rounded; o holds bf16-rounded values, as the TPU kernel writes bf16).
extern "C" int cfgpp_flash_attention_hd_int8(
    const void* q, const void* k, const void* v, void* o, void* kamax, void* qq,
    void* sq, void* kq, void* sk, int batch, int nq, int nkv, int heads,
    int head_dim, int kv_len, float q_scale, void* stream) {
  const int64_t ld = int64_t(heads) * head_dim;
  const Stages st{static_cast<int8_t*>(qq), static_cast<float*>(sq),
                  static_cast<int8_t*>(kq), static_cast<float*>(sk)};
  return dispatch<bf16>(q, k, v, o, kamax, st, batch, nq, nkv, heads, head_dim,
                        kv_len, q_scale, ld, ld, static_cast<cudaStream_t>(stream));
}

extern "C" int cfgpp_flash_attention_hd_int8_f32(
    const void* q, const void* k, const void* v, void* o, void* kamax, void* qq,
    void* sq, void* kq, void* sk, int batch, int nq, int nkv, int heads,
    int head_dim, int kv_len, float q_scale, void* stream) {
  const int64_t ld = int64_t(heads) * head_dim;
  const Stages st{static_cast<int8_t*>(qq), static_cast<float*>(sq),
                  static_cast<int8_t*>(kq), static_cast<float*>(sk)};
  return dispatch<float>(q, k, v, o, kamax, st, batch, nq, nkv, heads, head_dim,
                         kv_len, q_scale, ld, ld, static_cast<cudaStream_t>(stream));
}

// qkv: [batch, n, 3*heads*head_dim] (q | k | v on the channel dim),
// contiguous, 16-byte aligned; o: [batch, n, heads*head_dim]; both bf16, or
// both f32 for the `_f32` entry point.  Self-attention, no mask.  Other
// arguments as above.
template <typename T>
int qkv_packed_int8(const void* qkv, void* o, void* kamax, void* qq, void* sq,
                    void* kq, void* sk, int batch, int n, int heads,
                    int head_dim, float q_scale, void* stream) {
  const int64_t hd = int64_t(heads) * head_dim;
  const T* q = static_cast<const T*>(qkv);
  const Stages st{static_cast<int8_t*>(qq), static_cast<float*>(sq),
                  static_cast<int8_t*>(kq), static_cast<float*>(sk)};
  return dispatch<T>(q, q + hd, q + 2 * hd, o, kamax, st, batch, n, n, heads,
                     head_dim, n, q_scale, 3 * hd, 3 * hd,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int cfgpp_flash_attention_qkv_packed_int8(
    const void* qkv, void* o, void* kamax, void* qq, void* sq, void* kq, void* sk,
    int batch, int n, int heads, int head_dim, float q_scale, void* stream) {
  return qkv_packed_int8<bf16>(qkv, o, kamax, qq, sq, kq, sk, batch, n, heads,
                               head_dim, q_scale, stream);
}

extern "C" int cfgpp_flash_attention_qkv_packed_int8_f32(
    const void* qkv, void* o, void* kamax, void* qq, void* sq, void* kq, void* sk,
    int batch, int n, int heads, int head_dim, float q_scale, void* stream) {
  return qkv_packed_int8<float>(qkv, o, kamax, qq, sq, kq, sk, batch, n, heads,
                                head_dim, q_scale, stream);
}
