// Non-causal flash-attention forward for Hopper (sm_90a), f32 in and out.
//
// Replaces the Pallas TPU kernels cfgpp_tpu/kernels/flash_attention.py:
// flash_attention_hd (both bodies, _kernel_single and _kernel_multi) and
// flash_attention_qkv_packed, for f32 inputs.  The TPU kernel takes f32 and
// returns q's dtype; with f32 inputs it is f32 all the way (its
// p.astype(v.dtype) is a no-op).  The port's f32 callers are the VAE
// encoder (f32 by design, its mid-block attention is single-head d=512) and
// the whole model under --dtype float32.  bf16 inputs go to
// flash_attention.cu, which this file leaves alone.
//
// Layout and masking as flash_attention.cu: token-major q [B, Nq, H*D],
// k/v [B, Nkv, H*D], each read with its own row stride, so the packed entry
// point reads q, k and v in place as three channel-offset views of one
// [B, N, 3*H*D] array; kv rows at or past kv_len are masked and never read.
//
// Numerics: the TPU kernel's, in f32.  The d^-0.5 * log2(e) scale is folded
// into q; s = q k^T and the output accumulator are f32; an online softmax
// with a running max in log2 units and exp2f (the libm function, not the
// 2-ulp ex2.approx); p stays f32; out = acc / max(l, 1e-37).
//
// What bounds it on the H100: the two products, 4*Nq*Nkv*D flops per head,
// on the f32 CUDA cores (67 TFLOP/s; the tensor cores take no f32 operands
// without rounding them to TF32).  This first version makes no attempt at
// speed; it is simple and right.
//
// Design: CG consecutive threads share one query row; thread c of the group
// keeps the row's 16-byte chunks c, c + CG, c + 2*CG, ... of q (scaled) and
// of the output accumulator in registers, so a warp's CG distinct shared-
// memory reads of a k or v row fall in distinct banks.  A block of 128
// threads holds 128 / CG query rows of one (batch, head) and streams k/v in
// tiles of BKV rows through shared memory (synchronous float4 loads).  Per
// kv row each thread forms its partial dot, the group sums it with xor
// shuffles, and every thread of the group then holds the whole score.
//
// Built by cfgpp_tpu_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through ctypes (plain C entry points at the end of this file).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr double kLog2e = 1.4426950408889634;

// Head dim D, CG threads per query row, BKV kv rows per shared tile.
template <int D, int CG, int BKV>
struct Cfg {
  static constexpr int kChunks = D / 4;        // float4 chunks of a row
  static constexpr int NCH = kChunks / CG;     // chunks per thread
  static constexpr int RPB = kThreads / CG;    // query rows per block
  static_assert(D % 4 == 0 && kChunks % CG == 0, "chunks split evenly");
  static_assert(CG <= 32 && (CG & (CG - 1)) == 0, "a group lies in a warp");
  static_assert(2 * BKV * D * 4 <= 48 * 1024, "static shared memory");
};

template <int D, int CG, int BKV>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int nq,
              int nkv, int heads, int kv_len, float scale_log2, int64_t ldq,
              int64_t ldkv) {
  using C = Cfg<D, CG, BKV>;
  constexpr int NCH = C::NCH, kChunks = C::kChunks;
  __shared__ __align__(16) float4 ks[BKV * kChunks];
  __shared__ __align__(16) float4 vs[BKV * kChunks];

  const int cg = threadIdx.x % CG;
  const int row = blockIdx.x * C::RPB + threadIdx.x / CG;
  const int h = blockIdx.y, b = blockIdx.z;
  const bool live = row < nq;
  const float* kg = k + int64_t(b) * nkv * ldkv + int64_t(h) * D;
  const float* vg = v + int64_t(b) * nkv * ldkv + int64_t(h) * D;

  float4 qr[NCH], acc[NCH];
  {
    const float4* qg = reinterpret_cast<const float4*>(
        q + (int64_t(b) * nq + (live ? row : 0)) * ldq + int64_t(h) * D);
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      float4 x = live ? qg[cg + i * CG] : make_float4(0.f, 0.f, 0.f, 0.f);
      qr[i] = make_float4(x.x * scale_log2, x.y * scale_log2,
                          x.z * scale_log2, x.w * scale_log2);
      acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  float m_run = -INFINITY, l_run = 0.f;

  for (int kv0 = 0; kv0 < kv_len; kv0 += BKV) {
    const int valid = min(BKV, kv_len - kv0);
    for (int i = threadIdx.x; i < BKV * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (r < valid) {
        const int64_t off = int64_t(kv0 + r) * ldkv + 4 * c;
        kk = *reinterpret_cast<const float4*>(kg + off);
        vv = *reinterpret_cast<const float4*>(vg + off);
      }
      ks[i] = kk;
      vs[i] = vv;
    }
    __syncthreads();

    float s[BKV];
    float m_tile = -INFINITY;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        const float4 kk = ks[j * kChunks + cg + i * CG];
        part = fmaf(qr[i].x, kk.x, part);
        part = fmaf(qr[i].y, kk.y, part);
        part = fmaf(qr[i].z, kk.z, part);
        part = fmaf(qr[i].w, kk.w, part);
      }
#pragma unroll
      for (int off = CG / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      s[j] = j < valid ? part : -INFINITY;
      m_tile = fmaxf(m_tile, s[j]);
    }
    // finite: every tile holds a valid kv row
    const float m_new = fmaxf(m_run, m_tile);
    const float alpha = exp2f(m_run - m_new);
    m_run = m_new;
    l_run *= alpha;
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      acc[i].x *= alpha;
      acc[i].y *= alpha;
      acc[i].z *= alpha;
      acc[i].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      const float p = exp2f(s[j] - m_new);
      l_run += p;
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        const float4 vv = vs[j * kChunks + cg + i * CG];
        acc[i].x = fmaf(p, vv.x, acc[i].x);
        acc[i].y = fmaf(p, vv.y, acc[i].y);
        acc[i].z = fmaf(p, vv.z, acc[i].z);
        acc[i].w = fmaf(p, vv.w, acc[i].w);
      }
    }
    __syncthreads();   // every thread is done with this tile
  }

  if (!live) return;
  const float l = fmaxf(l_run, 1e-37f);
  float4* og = reinterpret_cast<float4*>(
      o + (int64_t(b) * nq + row) * (int64_t(heads) * D) + int64_t(h) * D);
#pragma unroll
  for (int i = 0; i < NCH; ++i)
    og[cg + i * CG] = make_float4(acc[i].x / l, acc[i].y / l, acc[i].z / l,
                                  acc[i].w / l);
}

template <int D, int CG, int BKV>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int batch, int nq, int nkv, int heads, int kv_len,
                   int64_t ldq, int64_t ldkv, cudaStream_t stream) {
  using C = Cfg<D, CG, BKV>;
  const float scale_log2 = float(kLog2e / sqrt(double(D)));
  dim3 grid((nq + C::RPB - 1) / C::RPB, heads, batch);
  flash_fwd_f32<D, CG, BKV><<<grid, kThreads, 0, stream>>>(
      q, k, v, o, nq, nkv, heads, kv_len, scale_log2, ldq, ldkv);
  return cudaGetLastError();
}

cudaError_t dispatch(const float* q, const float* k, const float* v, float* o,
                     int batch, int nq, int nkv, int heads, int head_dim,
                     int kv_len, int64_t ldq, int64_t ldkv, cudaStream_t s) {
  switch (head_dim) {
    case 40: return launch<40, 2, 32>(q, k, v, o, batch, nq, nkv, heads, kv_len, ldq, ldkv, s);
    case 64: return launch<64, 4, 32>(q, k, v, o, batch, nq, nkv, heads, kv_len, ldq, ldkv, s);
    case 80: return launch<80, 4, 32>(q, k, v, o, batch, nq, nkv, heads, kv_len, ldq, ldkv, s);
    case 160: return launch<160, 8, 32>(q, k, v, o, batch, nq, nkv, heads, kv_len, ldq, ldkv, s);
    case 512: return launch<512, 16, 8>(q, k, v, o, batch, nq, nkv, heads, kv_len, ldq, ldkv, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: [batch, nq, heads*head_dim], k/v: [batch, nkv, heads*head_dim], o like
// q; all f32, contiguous, 16-byte aligned.  1 <= kv_len <= nkv.  Returns a
// cudaError_t (0 on success).
extern "C" int cfgpp_flash_attention_hd_f32(const void* q, const void* k,
                                            const void* v, void* o, int batch,
                                            int nq, int nkv, int heads,
                                            int head_dim, int kv_len,
                                            void* stream) {
  const int64_t ld = int64_t(heads) * head_dim;
  return dispatch(static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<float*>(o), batch,
                  nq, nkv, heads, head_dim, kv_len, ld, ld,
                  static_cast<cudaStream_t>(stream));
}

// qkv: [batch, n, 3*heads*head_dim] f32 (q | k | v on the channel dim),
// contiguous, 16-byte aligned; o: [batch, n, heads*head_dim] f32.
// Self-attention, no mask.  Returns a cudaError_t (0 on success).
extern "C" int cfgpp_flash_attention_qkv_packed_f32(const void* qkv, void* o,
                                                    int batch, int n,
                                                    int heads, int head_dim,
                                                    void* stream) {
  const int64_t hd = int64_t(heads) * head_dim;
  const float* q = static_cast<const float*>(qkv);
  return dispatch(q, q + hd, q + 2 * hd, static_cast<float*>(o), batch, n, n,
                  heads, head_dim, n, 3 * hd, 3 * hd,
                  static_cast<cudaStream_t>(stream));
}
