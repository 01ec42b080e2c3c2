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
// on the f32 CUDA cores (67 TFLOP/s).  The tensor cores take no f32
// operands without rounding them to TF32 (10-bit mantissas), which would
// change the numbers, so every product is an FFMA.  At these shapes the
// attention is far above the card's ridge point, so the question is how
// many FFMA issue per shared-memory load and per barrier.
//
// Design: an FFMA flash forward blocked like an SGEMM.  A block owns BQ
// query rows of one (batch, head) and streams k/v in tiles of BKV rows.
// - Scores: each thread holds a TM1 x TN1 register micro-tile of S =
//   (q * scale) k^T; per 4 values of d it reads one float4 of q per row and
//   one of k per kv row from shared memory, so each load feeds 4*TM1 or
//   4*TN1 FFMA, and each score is computed once.  The 8 (or 16) lanes of a
//   phase read 8 consecutive k rows; rows are D + 4 floats apart, an odd
//   number of 16-byte units, so those reads fall in distinct banks, and the
//   q reads of a phase are one broadcast.  At d=512 the block's threads
//   split d into KS groups whose partial tiles are summed in shared memory.
// - Softmax: 8 lanes per row reduce the row max of a tile with 3 shuffles;
//   exp2f runs once per score; each lane keeps its rows' running max and
//   sum in registers.  P goes back to shared memory.
// - Output: O += P V, a TM2 x (4*NC) register micro-tile per thread (column
//   chunks interleaved over CL lanes, so a phase reads consecutive v
//   float4s); one float4 of P feeds four kv rows.  At d=80 the product runs
//   96 columns wide (v zero-padded) so that each thread holds 4 rows.
// - Tiles, read off an H100 with cfgpp_tpu_torch/tools/f32_attention_ab.py:
//   d=40 takes 8 x 8 score micro-tiles on 128-row blocks (254 registers, two
//   blocks per SM); 64-row blocks, 256 threads, 32-row kv tiles or the
//   padded output there were slower.
// - Loads: cp.async (L2 only) in dynamic shared memory, with k and v in two
//   buffers that overlap the compute: v tile t streams in while the scores
//   of tile t are formed (v tile 0 already under q's scaling), k tile t+1
//   while its softmax and P V run.  Rows past kv_len are zero-filled
//   without a read, and the last tile's scores and P V skip them.
// - d=512 (the VAE, one head): BQ = 32 rows (128 blocks at 4096 tokens, one
//   wave), so 32 query rows share each k/v tile read from L2 where the
//   first version shared it among 8; BQ = 32 at d=160 and 64 at d=80 keep
//   the level-2 and level-1 grids at 128 and 256 blocks.
//
// Built by cfgpp_tpu_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through ctypes (plain C entry points at the end of this file).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr double kLog2e = 1.4426950408889634;
constexpr int SR = 8;   // softmax lanes per row

// Head dim D; BQ query rows and BKV kv rows per tile; NT threads; KS groups
// splitting d in the score product, each of KL kv lanes x QL query lanes;
// CL column lanes in the output product over D2 >= D columns (v's columns
// past D are zero in shared memory, and their outputs are not stored: a
// wider product that lets each thread hold 4 rows feeds more FFMA per v
// load than the exact width would).
template <int D_, int BQ_, int BKV_, int NT_, int KS_, int KL_, int CL_,
          int D2_>
struct Cfg {
  static constexpr int D = D_, BQ = BQ_, BKV = BKV_, NT = NT_, KS = KS_,
                       KL = KL_, CL = CL_, D2 = D2_;
  static constexpr int GT = NT / KS;            // threads per d group
  static constexpr int QL = GT / KL;
  static constexpr int TM1 = BQ / QL, TN1 = BKV / KL, DG = D / KS;
  static constexpr int SQ = D + 4, SK = D + 4, SV = D2 + 4;  // row strides
  static constexpr int SS = BKV + (KL == 16 ? 16 : 8);
  static constexpr int RS = BQ * SR / NT;      // softmax rows per thread
  static constexpr int SC = BKV / SR;          // scores per lane and row
  static constexpr int RG = NT / CL;           // output row groups
  static constexpr int TM2 = BQ / RG, NC = D2 / 4 / CL;
  static constexpr int kFloats =
      BQ * SQ + BKV * SK + BKV * SV + KS * BQ * SS + 2 * BQ;
  static constexpr size_t kBytes = size_t(kFloats) * 4;
  static_assert(NT % KS == 0 && GT % KL == 0 && BQ % QL == 0 &&
                BKV % KL == 0 && D % KS == 0 && DG % 4 == 0, "score tile");
  static_assert((SK / 4) % 2 == 1, "k rows an odd number of 16-byte units");
  static_assert(RS >= 1 && (BQ * SR) % NT == 0 && BKV % SR == 0, "softmax");
  static_assert(NT % CL == 0 && BQ % RG == 0 && D2 >= D && D2 % 4 == 0 &&
                (D2 / 4) % CL == 0 && BKV % 4 == 0, "output tile");
  static_assert(kBytes <= 232448, "shared memory of one block");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
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

// Rows [0, valid) of a [ROWS, D] tile from global rows `ld` floats apart
// into shared rows STRIDE floats apart; rows past `valid` are zero-filled.
template <int ROWS, int STRIDE, int D, int NT>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int64_t ld, int valid) {
  constexpr int CH = D / 4;
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const bool ok = r < valid;
    cp_async16(dst + r * STRIDE + 4 * c, ok ? src + r * ld + 4 * c : src,
               ok ? 16 : 0);
  }
}

// S (partial over this thread's d group) = Qs Ks^T into Ss[group].  In a
// tile that is not FULL (the last, with `valid` < BKV kv rows: a 77-token
// cross-attention context leaves 13 of 64) the kv columns past `valid` are
// skipped, a whole n step at a time; their scores are masked later.
template <class C, bool FULL>
__device__ __forceinline__ void scores(const float* Qs, const float* Ks,
                                       float* Ss, int valid) {
  const int g = threadIdx.x / C::GT, lt = threadIdx.x % C::GT;
  const int tj = lt % C::KL, ti = lt / C::KL;
  const float* qb = Qs + ti * C::SQ + g * C::DG;
  const float* kb = Ks + tj * C::SK + g * C::DG;
  float s[C::TM1][C::TN1];
#pragma unroll
  for (int m = 0; m < C::TM1; ++m)
#pragma unroll
    for (int n = 0; n < C::TN1; ++n) s[m][n] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < C::DG; kk += 4) {
    float4 qv[C::TM1];
#pragma unroll
    for (int m = 0; m < C::TM1; ++m)
      qv[m] = *reinterpret_cast<const float4*>(qb + m * C::QL * C::SQ + kk);
#pragma unroll
    for (int n = 0; n < C::TN1; ++n) {
      if (!FULL && C::KL * n >= valid) break;
      const float4 kv =
          *reinterpret_cast<const float4*>(kb + n * C::KL * C::SK + kk);
#pragma unroll
      for (int m = 0; m < C::TM1; ++m) {
        s[m][n] = fmaf(qv[m].x, kv.x, s[m][n]);
        s[m][n] = fmaf(qv[m].y, kv.y, s[m][n]);
        s[m][n] = fmaf(qv[m].z, kv.z, s[m][n]);
        s[m][n] = fmaf(qv[m].w, kv.w, s[m][n]);
      }
    }
  }
  float* sp = Ss + g * C::BQ * C::SS;
#pragma unroll
  for (int m = 0; m < C::TM1; ++m)
#pragma unroll
    for (int n = 0; n < C::TN1; ++n)
      sp[(ti + C::QL * m) * C::SS + tj + C::KL * n] = s[m][n];
}

// Online softmax of one tile: the scores (summed over the d groups; kv
// columns at or past `valid` masked) become p = exp2(s - m_new) in Ss[0];
// alpha = exp2(m_old - m_new) per row goes to alpha_s.  Lane sl of a row's
// 8 lanes takes columns sl, sl + 8, ...; m_run / l_run are this thread's
// rows' running max and sum (every lane of a row holds the same values).
template <class C>
__device__ __forceinline__ void softmax(float* Ss, float* alpha_s,
                                        float (&m_run)[C::RS],
                                        float (&l_run)[C::RS], int valid) {
  const int sl = threadIdx.x % SR, r0 = threadIdx.x / SR;
#pragma unroll
  for (int t = 0; t < C::RS; ++t) {
    const int r = r0 + (C::NT / SR) * t;
    float* row = Ss + r * C::SS;
    float sv[C::SC];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < C::SC; ++i) {
      const int j = sl + SR * i;
      float x = row[j];
#pragma unroll
      for (int g = 1; g < C::KS; ++g) x += row[g * C::BQ * C::SS + j];
      sv[i] = j < valid ? x : -INFINITY;
      mx = fmaxf(mx, sv[i]);
    }
#pragma unroll
    for (int o = SR / 2; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    // finite: every tile holds a valid kv row
    const float m_new = fmaxf(m_run[t], mx);
    const float alpha = exp2f(m_run[t] - m_new);
    m_run[t] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < C::SC; ++i) {
      const float p = exp2f(sv[i] - m_new);
      sum += p;
      row[sl + SR * i] = p;
    }
#pragma unroll
    for (int o = SR / 2; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    l_run[t] = l_run[t] * alpha + sum;
    if (sl == 0) alpha_s[r] = alpha;
  }
}

// acc = acc * alpha + P V for this thread's rows rg + RG*m and float4
// column chunks cl + CL*n; a tile that is not FULL stops after its `valid`
// kv rows, rounded up to 4 (p = 0 and v = 0 in the rows past them).
template <class C, bool FULL>
__device__ __forceinline__ void pv(const float* Ss, const float* Vs,
                                   const float* alpha_s,
                                   float4 (&acc)[C::TM2][C::NC], int valid) {
  const int cl = threadIdx.x % C::CL, rg = threadIdx.x / C::CL;
#pragma unroll
  for (int m = 0; m < C::TM2; ++m) {
    const float a = alpha_s[rg + C::RG * m];
#pragma unroll
    for (int n = 0; n < C::NC; ++n) {
      acc[m][n].x *= a;
      acc[m][n].y *= a;
      acc[m][n].z *= a;
      acc[m][n].w *= a;
    }
  }
  const int rows = FULL ? C::BKV : (valid + 3) & ~3;
#pragma unroll 2
  for (int j = 0; j < rows; j += 4) {
    float4 p[C::TM2];
#pragma unroll
    for (int m = 0; m < C::TM2; ++m)
      p[m] = *reinterpret_cast<const float4*>(Ss + (rg + C::RG * m) * C::SS + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int n = 0; n < C::NC; ++n) {
        const float4 vv = *reinterpret_cast<const float4*>(
            Vs + (j + jj) * C::SV + 4 * (cl + C::CL * n));
#pragma unroll
        for (int m = 0; m < C::TM2; ++m) {
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

template <class C>
__global__ void __launch_bounds__(C::NT, 1)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int nq,
              int nkv, int heads, int kv_len, float scale_log2, int64_t ldq,
              int64_t ldkv) {
  constexpr int D = C::D, BQ = C::BQ, BKV = C::BKV, NT = C::NT;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * C::SQ;
  float* Vs = Ks + BKV * C::SK;
  float* Ss = Vs + BKV * C::SV;
  float* alpha_s = Ss + C::KS * BQ * C::SS;
  float* l_s = alpha_s + BQ;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const float* qg = q + (int64_t(b) * nq + q0) * ldq + int64_t(h) * D;
  const float* kg = k + int64_t(b) * nkv * ldkv + int64_t(h) * D;
  const float* vg = v + int64_t(b) * nkv * ldkv + int64_t(h) * D;

  if constexpr (C::D2 > D) {   // v's padding columns, zero for good
    constexpr int PAD = C::D2 - D;
    for (int i = threadIdx.x; i < BKV * PAD; i += NT)
      Vs[(i / PAD) * C::SV + D + i % PAD] = 0.f;
  }
  load_rows<BQ, C::SQ, D, NT>(Qs, qg, ldq, min(BQ, nq - q0));
  load_rows<BKV, C::SK, D, NT>(Ks, kg, ldkv, min(BKV, kv_len));
  cp_async_commit();
  // v tile 0 streams in under q's scaling and the first scores
  load_rows<BKV, C::SV, D, NT>(Vs, vg, ldkv, min(BKV, kv_len));
  cp_async_commit();
  cp_async_wait<1>();   // q and k tile 0
  __syncthreads();
  for (int i = threadIdx.x; i < BQ * D; i += NT) {
    float* x = Qs + (i / D) * C::SQ + i % D;
    *x = *x * scale_log2;
  }

  float4 acc[C::TM2][C::NC];
#pragma unroll
  for (int m = 0; m < C::TM2; ++m)
#pragma unroll
    for (int n = 0; n < C::NC; ++n) acc[m][n] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m_run[C::RS], l_run[C::RS];
#pragma unroll
  for (int t = 0; t < C::RS; ++t) {
    m_run[t] = -INFINITY;
    l_run[t] = 0.f;
  }

  const int ntiles = (kv_len + BKV - 1) / BKV;
  for (int t = 0; t < ntiles; ++t) {
    const int kv0 = t * BKV;
    const int valid = min(BKV, kv_len - kv0);
    if (t > 0) {
      cp_async_wait<0>();   // k tile t is in (this thread's copies) ...
      __syncthreads();      // ... everyone's; Vs and Ss are free again
      load_rows<BKV, C::SV, D, NT>(Vs, vg + int64_t(kv0) * ldkv, ldkv, valid);
      cp_async_commit();
    } else {
      __syncthreads();      // q's scaling is complete
    }
    if (valid == BKV) scores<C, true>(Qs, Ks, Ss, valid);
    else scores<C, false>(Qs, Ks, Ss, valid);
    __syncthreads();      // Ks is consumed; the score tile is complete
    const bool more = t + 1 < ntiles;
    if (more) {
      load_rows<BKV, C::SK, D, NT>(Ks, kg + int64_t(kv0 + BKV) * ldkv, ldkv,
                                   min(BKV, kv_len - kv0 - BKV));
      cp_async_commit();
    }
    softmax<C>(Ss, alpha_s, m_run, l_run, valid);
    if (more) cp_async_wait<1>();   // v tile t, not k tile t+1
    else cp_async_wait<0>();
    __syncthreads();      // P, alpha and v tile t visible to all
    if (valid == BKV) pv<C, true>(Ss, Vs, alpha_s, acc, valid);
    else pv<C, false>(Ss, Vs, alpha_s, acc, valid);
  }

  if (threadIdx.x % SR == 0) {
#pragma unroll
    for (int t = 0; t < C::RS; ++t)
      l_s[threadIdx.x / SR + (NT / SR) * t] = l_run[t];
  }
  __syncthreads();
  const int cl = threadIdx.x % C::CL, rg = threadIdx.x / C::CL;
#pragma unroll
  for (int m = 0; m < C::TM2; ++m) {
    const int r = rg + C::RG * m;
    if (q0 + r >= nq) continue;
    const float l = fmaxf(l_s[r], 1e-37f);
    float4* og = reinterpret_cast<float4*>(
        o + (int64_t(b) * nq + q0 + r) * (int64_t(heads) * D) + int64_t(h) * D);
#pragma unroll
    for (int n = 0; n < C::NC; ++n) {
      const float4 a = acc[m][n];
      if (4 * (cl + C::CL * n) < D)
        og[cl + C::CL * n] = make_float4(a.x / l, a.y / l, a.z / l, a.w / l);
    }
  }
}

template <class C>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int batch, int nq, int nkv, int heads, int kv_len,
                   int64_t ldq, int64_t ldkv, cudaStream_t stream) {
  auto kern = flash_fwd_f32<C>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::kBytes));
  if (attr != cudaSuccess) return attr;
  const float scale_log2 = float(kLog2e / sqrt(double(C::D)));
  dim3 grid((nq + C::BQ - 1) / C::BQ, heads, batch);
  kern<<<grid, C::NT, C::kBytes, stream>>>(q, k, v, o, nq, nkv, heads, kv_len,
                                           scale_log2, ldq, ldkv);
  return cudaGetLastError();
}

// Tiles per head dim: <D, BQ, BKV, NT, KS, KL, CL, D2>.
cudaError_t dispatch(const float* q, const float* k, const float* v, float* o,
                     int batch, int nq, int nkv, int heads, int head_dim,
                     int kv_len, int64_t ldq, int64_t ldkv, cudaStream_t s) {
  switch (head_dim) {
    case 40: return launch<Cfg<40, 128, 64, 128, 1, 8, 2, 40>>(q, k, v, o, batch, nq, nkv, heads, kv_len, ldq, ldkv, s);
    case 64: return launch<Cfg<64, 64, 64, 128, 1, 8, 8, 64>>(q, k, v, o, batch, nq, nkv, heads, kv_len, ldq, ldkv, s);
    case 80: return launch<Cfg<80, 64, 64, 128, 1, 8, 8, 96>>(q, k, v, o, batch, nq, nkv, heads, kv_len, ldq, ldkv, s);
    case 160: return launch<Cfg<160, 32, 64, 128, 1, 16, 8, 160>>(q, k, v, o, batch, nq, nkv, heads, kv_len, ldq, ldkv, s);
    case 512: return launch<Cfg<512, 32, 32, 256, 4, 8, 32, 512>>(q, k, v, o, batch, nq, nkv, heads, kv_len, ldq, ldkv, s);
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
