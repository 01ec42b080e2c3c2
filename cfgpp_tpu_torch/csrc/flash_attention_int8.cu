// Int8-score flash-attention forward for Hopper (sm_90a), bf16 or f32 in;
// the output rounded to bf16 as the TPU kernels write it (out_shape bf16),
// stored as bf16 or, for f32 inputs, widened back to f32.
//
// Replaces the Pallas TPU kernels cfgpp_tpu/kernels/flash_attention.py:
// flash_attention_hd_int8 and flash_attention_qkv_packed_int8, both with the
// body _kernel_single_int8, with its numerics: per (row, head) a q scale
// sq = max(amax|q|, 1e-6) * (1/127); per (batch, head) ONE scalar k scale sk
// over every kv row; q * (1/sq) and k * (1/sk) rounded half to even and
// clipped to +-127; an int8 q k^T with int32 accumulation; the scores
// s = acc * (sq * (sk * q_scale)) with q_scale = d^-1/2 * log2(e) (so the
// softmax runs on exp2), kv columns at or past kv_len masked; p rounded to
// v's dtype before p@v with f32 accumulation; out = (p@v) / max(l, 1e-37).
// With bf16 activations p@v runs on bf16 wmma fragments; with f32 ones (the
// `_f32` entry points, as the TPU kernel takes f32) p is not rounded and
// p@v is an f32 FFMA micro-tile product (`pv_f32`): a TF32 or bf16 product
// would round p and v.
// The TPU kernel takes the whole kv sequence in one block and subtracts no
// max; this kernel streams 64-row kv tiles with a running max, which is the
// same softmax in real arithmetic and differs only in rounding.  The
// quantize and score steps use the _rn intrinsics, so the int8 q and k and
// both scales equal the plain version's (kernels/flash_attention.py) bit for
// bit.
//
// Layout: token-major q [B, Nq, H*D], k/v [B, Nkv, H*D], each read with its
// own row stride; the packed entry point reads q, k and v in place as three
// channel-offset views of one [B, N, 3*H*D] array (no d=40 split: Hopper
// has no lane rule).
//
// What bounds it on the H100: at the SD-1.5 site (level 1: 1024 tokens,
// d=80, 8 heads, batch 2) the two products are 2.7 GFLOP, a few us of
// tensor-core time; the per-tile softmax, run from shared memory by one warp
// per row, and the synchronous tile loads bound it, as they bound the bf16
// kernel in flash_attention.cu.
//
// What the design does about that.  The k scale needs |k| over the whole
// sequence before the first score: `k_absmax` (grid: batch*head x slice)
// reduces it first, with atomicMax on the float bits.  Then one block per
// (q tile, head, batch) quantizes its q tile once (one warp per row: amax,
// scale, int8) and streams the kv tiles, quantizing each k tile on load, so
// no int8 array reaches device memory.  The score product runs nvcuda::wmma
// m16n16k16 signed-char fragments with int accumulators on 16-byte k planes
// (32-byte aligned, as wmma requires), p@v bf16 fragments with f32
// accumulation, the online softmax between them as in flash_attention.cu.
//
// Built by cfgpp_tpu_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through ctypes (plain C entry points at the end of this file).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <algorithm>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kAmaxThreads = 256;

// T: the activations' type (bf16, or f32 for the `_f32` entry points); v
// and p are held in it.
template <int D, int BQ, int BKV, typename T>
struct Plan {
  static constexpr int DP = (D + 15) / 16 * 16;  // head dim padded to the mma depth
  static constexpr int NP = DP / 16;             // 16-byte k planes
  static constexpr int QPLANE = BQ * 16 + 32;    // int8 q plane, 32-byte skew
  static constexpr int KPLANE = BKV * 16 + 32;   // int8 k plane
  static constexpr int PAD = sizeof(T) == 2 ? 8 : 4;   // 16 bytes of skew
  static constexpr int LDH = DP + PAD;           // v tile
  static constexpr int LDS = BKV + 8;            // int32 scores
  static constexpr int LDP = BKV + PAD;          // probabilities
  static constexpr int LDO = DP + 4;             // output accumulator, f32
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + size_t(NP) * QPLANE;
  static constexpr size_t v_off = k_off + size_t(NP) * KPLANE;
  static constexpr size_t s_off = v_off + size_t(BKV) * LDH * sizeof(T);
  static constexpr size_t p_off = s_off + size_t(BQ) * LDS * sizeof(int);
  static constexpr size_t o_off = p_off + size_t(BQ) * LDP * sizeof(T);
  static constexpr size_t m_off = o_off + size_t(BQ) * LDO * sizeof(float);
  static constexpr size_t l_off = m_off + size_t(BQ) * sizeof(float);
  static constexpr size_t sq_off = l_off + size_t(BQ) * sizeof(float);
  static constexpr size_t bytes = sq_off + size_t(BQ) * sizeof(float);
  static_assert(BQ % 16 == 0 && BKV % 32 == 0, "tile shape");
  static_assert(D % 8 == 0, "rows are moved in 16-byte chunks");
};

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float scale_of(float amax) {
  return __fmul_rn(fmaxf(amax, 1e-6f), 1.f / 127.f);
}

__device__ __forceinline__ int8_t quantize(float v, float inv) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.f), 127.f));
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

// Eight consecutive elements copied (v tile rows: 16 bytes of bf16, 32 of
// f32), or zeros.
__device__ __forceinline__ void copy8(bf16* dst, const bf16* src, bool ok) {
  *reinterpret_cast<uint4*>(dst) =
      ok ? *reinterpret_cast<const uint4*>(src) : make_uint4(0u, 0u, 0u, 0u);
}
__device__ __forceinline__ void copy8(float* dst, const float* src, bool ok) {
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  reinterpret_cast<float4*>(dst)[0] = ok ? reinterpret_cast<const float4*>(src)[0] : z;
  reinterpret_cast<float4*>(dst)[1] = ok ? reinterpret_cast<const float4*>(src)[1] : z;
}

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ void store_f(bf16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
// The output: one rounding to bf16 whatever T is (p above stays in T).
__device__ __forceinline__ void store_out(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_out(float* p, float v) {
  *p = __bfloat162float(__float2bfloat16_rn(v));
}

// |k| max over the kv rows of one (batch, head), split over gridDim.y blocks.
template <int D, typename T>
__global__ void __launch_bounds__(kAmaxThreads)
k_absmax(const T* __restrict__ k, unsigned* __restrict__ amax, int nkv,
         int heads, int64_t ldkv) {
  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  constexpr int kGroups = D / 8;
  const int64_t items = int64_t(nkv) * kGroups;
  const int64_t i0 = items * blockIdx.y / gridDim.y;
  const int64_t i1 = items * (blockIdx.y + 1) / gridDim.y;
  const T* kg = k + int64_t(b) * nkv * ldkv + int64_t(h) * D;
  float m = 0.f;
  for (int64_t i = i0 + threadIdx.x; i < i1; i += kAmaxThreads) {
    const int64_t r = i / kGroups;
    const int c = int(i % kGroups) * 8;
    float f[8];
    load8(kg + r * ldkv + c, f);
#pragma unroll
    for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(f[j]));
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

// os += p v for f32 p and v (the `_f32` entry points): the TPU kernel rounds
// p to v's dtype, a no-op in f32, so the product stays f32 on the CUDA cores
// (a bf16 wmma would round both operands).  Each thread holds a register
// micro-tile of TM rows x NC float4 column chunks; per kv row it reads one
// float4 of v per chunk and feeds it to TM rows, and p four kv rows at a
// time (a float4 per row).
template <int BQ, int BKV, int DP, int LDP, int LDH, int LDO>
__device__ __forceinline__ void pv_f32(const float* ps, const float* vs,
                                       float* os) {
  constexpr int CL = 4, RG = kThreads / CL, TM = BQ / RG, NC = DP / 4 / CL;
  static_assert(BQ % RG == 0 && (DP / 4) % CL == 0 && BKV % 4 == 0,
                "p v micro-tile");
  const int cl = threadIdx.x % CL, rg = threadIdx.x / CL;
  float4 acc[TM][NC];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < NC; ++n)
      acc[m][n] = *reinterpret_cast<const float4*>(
          os + (rg + RG * m) * LDO + 4 * (cl + CL * n));
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
            vs + (j + jj) * LDH + 4 * (cl + CL * n));
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
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < NC; ++n)
      *reinterpret_cast<float4*>(os + (rg + RG * m) * LDO + 4 * (cl + CL * n)) =
          acc[m][n];
}

// Stage-check outputs, each null unless the stages entry point asked.
struct Stages {
  int8_t* qq;   // [B, Nq, H*D]
  float* sq;    // [B, Nq, H]
  int8_t* kq;   // [B, Nkv, H*D], rows below kv_len
  float* sk;    // [B, H]
};

template <int D, int BQ, int BKV, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_int8(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               const unsigned* __restrict__ kamax, Stages st, int nq, int nkv,
               int heads, int kv_len, float q_scale, int64_t ldq, int64_t ldkv) {
  using P = Plan<D, BQ, BKV, T>;
  constexpr int DP = P::DP;
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* qs = reinterpret_cast<int8_t*>(smem + P::q_off);
  int8_t* ks = reinterpret_cast<int8_t*>(smem + P::k_off);
  T* vs = reinterpret_cast<T*>(smem + P::v_off);
  int* si = reinterpret_cast<int*>(smem + P::s_off);
  T* ps = reinterpret_cast<T*>(smem + P::p_off);
  float* os = reinterpret_cast<float*>(smem + P::o_off);
  float* ms = reinterpret_cast<float*>(smem + P::m_off);
  float* ls = reinterpret_cast<float*>(smem + P::l_off);
  float* sqs = reinterpret_cast<float*>(smem + P::sq_off);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t hd = int64_t(heads) * D;   // the output's row stride
  const T* qg = q + (int64_t(b) * nq + q0) * ldq + int64_t(h) * D;
  const T* kg = k + int64_t(b) * nkv * ldkv + int64_t(h) * D;
  const T* vg = v + int64_t(b) * nkv * ldkv + int64_t(h) * D;
  const int q_rows = min(BQ, nq - q0);
  const float sk = scale_of(__uint_as_float(kamax[b * heads + h]));
  const float inv_k = __fdiv_rn(1.f, sk);
  const float k_fac = __fmul_rn(sk, q_scale);
  if (st.sk != nullptr && blockIdx.x == 0 && threadIdx.x == 0) st.sk[b * heads + h] = sk;

  // q tile: one warp per row; int8 into k planes, scale per row
  constexpr int kQPer = (DP + 31) / 32;
  for (int r = warp; r < BQ; r += kWarps) {
    float qv[kQPer];
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < kQPer; ++j) {
      const int c = lane + 32 * j;
      qv[j] = (r < q_rows && c < D) ? to_f(qg[r * ldq + c]) : 0.f;
      amax = fmaxf(amax, fabsf(qv[j]));
    }
    const float sq = scale_of(warp_max(amax));
    const float inv = __fdiv_rn(1.f, sq);
#pragma unroll
    for (int j = 0; j < kQPer; ++j) {
      const int c = lane + 32 * j;
      if (c >= DP) continue;
      const int8_t qq = c < D ? quantize(qv[j], inv) : int8_t(0);
      qs[(c / 16) * P::QPLANE + r * 16 + c % 16] = qq;
      if (st.qq != nullptr && r < q_rows && c < D)
        st.qq[(int64_t(b) * nq + q0 + r) * hd + int64_t(h) * D + c] = qq;
    }
    if (lane == 0) {
      sqs[r] = sq;
      if (st.sq != nullptr && r < q_rows)
        st.sq[(int64_t(b) * nq + q0 + r) * heads + h] = sq;
    }
  }
  for (int i = threadIdx.x; i < BQ * P::LDO; i += kThreads) os[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += kThreads) {
    ms[i] = -INFINITY;
    ls[i] = 0.f;
  }

  constexpr int kChunks = DP / 8;   // 8-value chunks of a padded row
  for (int kv0 = 0; kv0 < kv_len; kv0 += BKV) {
    __syncthreads();  // the previous tile's p@v has finished reading ks/vs/ps
    const int kv_rows = min(BKV, kv_len - kv0);
    for (int i = threadIdx.x; i < BKV * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      uint2 q8 = make_uint2(0u, 0u);
      const bool ok = r < kv_rows && c < D;
      if (ok) {
        float e[8];
        load8(kg + int64_t(kv0 + r) * ldkv + c, e);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const unsigned byte = static_cast<unsigned>(quantize(e[j], inv_k)) & 0xffu;
          if (j < 4) q8.x |= byte << (8 * j);
          else q8.y |= byte << (8 * (j - 4));
        }
        if (st.kq != nullptr && blockIdx.x == 0)
          *reinterpret_cast<uint2*>(st.kq + (int64_t(b) * nkv + kv0 + r) * hd +
                                    int64_t(h) * D + c) = q8;
      }
      *reinterpret_cast<uint2*>(ks + (c / 16) * P::KPLANE + r * 16 + c % 16) = q8;
      copy8(vs + r * P::LDH + c, vg + int64_t(kv0 + r) * ldkv + c, ok);
    }
    __syncthreads();

    // int32 scores q k^T on the tensor cores, 16x16 tiles spread over the warps
    for (int t = warp; t < (BQ / 16) * (BKV / 16); t += kWarps) {
      const int ti = t / (BKV / 16), tj = t % (BKV / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc;
      wmma::fill_fragment(acc, 0);
#pragma unroll
      for (int p = 0; p < P::NP; ++p) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, reinterpret_cast<const signed char*>(
                                       qs + p * P::QPLANE + ti * 16 * 16), 16);
        wmma::load_matrix_sync(fb, reinterpret_cast<const signed char*>(
                                       ks + p * P::KPLANE + tj * 16 * 16), 16);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(si + ti * 16 * P::LDS + tj * 16, acc, P::LDS,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // dequant and online softmax in log2 space, one warp per row
    for (int r = warp; r < BQ; r += kWarps) {
      const float fac = __fmul_rn(sqs[r], k_fac);
      float sv[BKV / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BKV / 32; ++j) {
        const int c = lane + 32 * j;
        const float s = c < kv_rows
                            ? __fmul_rn(__int2float_rn(si[r * P::LDS + c]), fac)
                            : -INFINITY;
        sv[j] = s;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, mx);  // finite: every tile holds a valid column
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BKV / 32; ++j) {
        const float p = exp2f(sv[j] - m_new);
        sum += p;
        store_f(ps + r * P::LDP + lane + 32 * j, p);   // bf16: p rounded
      }
      sum = warp_sum(sum);
      const float alpha = exp2f(m_old - m_new);
      for (int c = lane; c < DP; c += 32) os[r * P::LDO + c] *= alpha;
      __syncwarp();
      if (lane == 0) {
        ms[r] = m_new;
        ls[r] = ls[r] * alpha + sum;
      }
    }
    __syncthreads();

    if constexpr (sizeof(T) == 4) {
      pv_f32<BQ, BKV, DP, P::LDP, P::LDH, P::LDO>(ps, vs, os);
    } else {
      // acc += p v on the tensor cores (bf16 p and v)
      for (int t = warp; t < (BQ / 16) * (DP / 16); t += kWarps) {
        const int ti = t / (DP / 16), tj = t % (DP / 16);
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        float* dst = os + ti * 16 * P::LDO + tj * 16;
        wmma::load_matrix_sync(acc, dst, P::LDO, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BKV; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, ps + ti * 16 * P::LDP + kk, P::LDP);
          wmma::load_matrix_sync(fb, vs + kk * P::LDH + tj * 16, P::LDH);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(dst, acc, P::LDO, wmma::mem_row_major);
      }
    }
  }
  __syncthreads();

  T* og = o + (int64_t(b) * nq + q0) * hd + int64_t(h) * D;
  for (int i = threadIdx.x; i < q_rows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    store_out(og + r * hd + c, os[r * P::LDO + c] / fmaxf(ls[r], 1e-37f));
  }
}

template <int D, typename T>
cudaError_t launch(const T* q, const T* k, const T* v, T* o,
                   unsigned* kamax, Stages st, int batch, int nq, int nkv,
                   int heads, int kv_len, float q_scale, int64_t ldq, int64_t ldkv,
                   cudaStream_t s) {
  constexpr int BQ = 64, BKV = 64;
  using P = Plan<D, BQ, BKV, T>;
  const int bh = batch * heads;
  cudaError_t err = cudaMemsetAsync(kamax, 0, sizeof(unsigned) * bh, s);
  if (err != cudaSuccess) return err;
  // enough blocks to fill the card twice, each of at least 32 rows
  const int slices = std::max(1, std::min((264 + bh - 1) / bh, nkv / 32));
  k_absmax<D, T><<<dim3(bh, slices), kAmaxThreads, 0, s>>>(k, kamax, nkv, heads, ldkv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kern = flash_fwd_int8<D, BQ, BKV, T>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(P::bytes));
  if (err != cudaSuccess) return err;
  dim3 grid((nq + BQ - 1) / BQ, heads, batch);
  kern<<<grid, kThreads, P::bytes, s>>>(q, k, v, o, kamax, st, nq, nkv, heads,
                                        kv_len, q_scale, ldq, ldkv);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     void* kamax, Stages st, int batch, int nq, int nkv,
                     int heads, int head_dim, int kv_len, float q_scale,
                     int64_t ldq, int64_t ldkv, cudaStream_t s) {
  const auto* qb = static_cast<const T*>(q);
  const auto* kb = static_cast<const T*>(k);
  const auto* vb = static_cast<const T*>(v);
  auto* ob = static_cast<T*>(o);
  auto* a = static_cast<unsigned*>(kamax);
  switch (head_dim) {
    case 40: return launch<40, T>(qb, kb, vb, ob, a, st, batch, nq, nkv, heads, kv_len, q_scale, ldq, ldkv, s);
    case 64: return launch<64, T>(qb, kb, vb, ob, a, st, batch, nq, nkv, heads, kv_len, q_scale, ldq, ldkv, s);
    case 80: return launch<80, T>(qb, kb, vb, ob, a, st, batch, nq, nkv, heads, kv_len, q_scale, ldq, ldkv, s);
    case 160: return launch<160, T>(qb, kb, vb, ob, a, st, batch, nq, nkv, heads, kv_len, q_scale, ldq, ldkv, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: [batch, nq, heads*head_dim], k/v: [batch, nkv, heads*head_dim], o like
// q; all bf16, contiguous, 16-byte aligned.  1 <= kv_len <= nkv; the k scale
// is taken over all nkv rows.  kamax: scratch, 4 bytes x batch*heads.
// qq/sq/kq/sk: the stage outputs (see Stages) or null.  q_scale:
// head_dim^-1/2 * log2(e) as f32.  Returns a cudaError_t (0 on success).
// The `_f32` entry points take q, k, v and o in f32 (p is then not rounded;
// o holds bf16-rounded values, as the TPU kernel writes bf16).
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
