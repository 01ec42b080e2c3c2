// Non-causal flash-attention forward for Hopper (sm_90a), bf16 in and out.
//
// Replaces the Pallas TPU kernels cfgpp_tpu/kernels/flash_attention.py:
// flash_attention_hd, both of its bodies: _kernel_single (one kv block,
// max-free softmax) and _kernel_multi (streaming online softmax); and
// flash_attention_qkv_packed, the same math on a packed [B, N, 3*H*D]
// projection.  One streaming form covers both bodies: max-free and
// max-subtracted softmax are equal in real arithmetic, and the running max
// keeps any kv length in range.
//
// Layout: token-major q [B, Nq, H*D], k/v [B, Nkv, H*D] (the projections'
// own layout, so no head split or transpose reaches device memory), each
// read with its own row stride.  The packed entry point passes q, k and v
// as three channel-offset views of one [B, N, 3*H*D] array (offsets 0, H*D,
// 2*H*D; row stride 3*H*D), so the int8 path's fused to_qkv output is read
// in place and never sliced into copies.  The TPU kernel splits the pack at
// d=40 for a Mosaic lane rule; Hopper has no such rule, and this kernel
// reads every head dim in place.  kv rows at or past kv_len are masked; the
// caller may pass k/v pre-padded.
// Scores and the output accumulator are f32; p is rounded to bf16 before
// p@v, as the TPU kernel does.  out = acc / max(l, 1e-37).
//
// What bounds it on the H100: at long N (SD-1.5 level 0, 4096 tokens; the
// VAE mid-block, 4096 tokens at d=512) the two matrix products, 4*Nq*Nkv*D
// flops per head, on the bf16 tensor cores.  At kv=77 (cross-attention) the
// work is small and the bytes of q read and o written bound it.
// What the design does about that: one thread block per (q tile, head,
// batch) loads its q tile once and streams k/v tiles through shared memory,
// so q is read once and o written once; kv tiles stop at kv_len, so padded
// rows are never read.  Both products run on the tensor cores through
// nvcuda::wmma bf16 fragments with f32 accumulation.  The f32 accumulator
// lives in shared memory so that the per-row online-softmax rescale can
// address it; moving it into registers (mma.sync / wgmma) and overlapping
// the tile loads (cp.async / TMA) are the known next steps.
//
// Built by cfgpp_tpu_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through ctypes (plain C entry point at the end of this file).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory plan of one thread block.  Row strides carry a small skew
// (8 bf16 / 4 f32) so that consecutive rows start in different banks; every
// section and every 16-row tile start stays 32-byte aligned, as wmma needs.
template <int D, int BQ, int BKV>
struct Plan {
  static constexpr int DP = (D + 15) / 16 * 16;  // head dim padded to the mma depth (40 -> 48)
  static constexpr int LDH = DP + 8;             // q / k / v tiles, bf16
  static constexpr int LDS = BKV + 4;            // scores, f32
  static constexpr int LDP = BKV + 8;            // probabilities, bf16
  static constexpr int LDO = DP + 4;             // output accumulator, f32
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + size_t(BQ) * LDH * sizeof(bf16);
  static constexpr size_t v_off = k_off + size_t(BKV) * LDH * sizeof(bf16);
  static constexpr size_t s_off = v_off + size_t(BKV) * LDH * sizeof(bf16);
  static constexpr size_t p_off = s_off + size_t(BQ) * LDS * sizeof(float);
  static constexpr size_t o_off = p_off + size_t(BQ) * LDP * sizeof(bf16);
  static constexpr size_t m_off = o_off + size_t(BQ) * LDO * sizeof(float);
  static constexpr size_t l_off = m_off + size_t(BQ) * sizeof(float);
  static constexpr size_t bytes = l_off + size_t(BQ) * sizeof(float);
  static_assert(BQ % 16 == 0 && BKV % 32 == 0, "tile shape");
  static_assert(D % 8 == 0, "rows are moved in 16-byte chunks");
};

// Copy `rows` rows of one head (D bf16 values each, `stride` apart in device
// memory) into a shared tile of width DP.  Rows at or past `valid` and the
// columns D..DP are zero, so padded scores are finite and padded values add
// nothing to p@v.
template <int D, int DP, int LDH>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int rows,
                                          int valid, int64_t stride) {
  constexpr int kChunks = DP / 8;
  constexpr int kData = D / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid && c < kData)
      val = *reinterpret_cast<const uint4*>(src + r * stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LDH + c * 8) = val;
  }
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D, int BQ, int BKV>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, bf16* __restrict__ o, int nq, int nkv,
          int heads, int kv_len, float scale_log2, int64_t ldq, int64_t ldkv) {
  using P = Plan<D, BQ, BKV>;
  constexpr int DP = P::DP;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + P::q_off);
  bf16* ks = reinterpret_cast<bf16*>(smem + P::k_off);
  bf16* vs = reinterpret_cast<bf16*>(smem + P::v_off);
  float* ss = reinterpret_cast<float*>(smem + P::s_off);
  bf16* ps = reinterpret_cast<bf16*>(smem + P::p_off);
  float* os = reinterpret_cast<float*>(smem + P::o_off);
  float* ms = reinterpret_cast<float*>(smem + P::m_off);
  float* ls = reinterpret_cast<float*>(smem + P::l_off);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t ld = int64_t(heads) * D;   // the output's row stride
  const bf16* qg = q + (int64_t(b) * nq + q0) * ldq + int64_t(h) * D;
  const bf16* kg = k + int64_t(b) * nkv * ldkv + int64_t(h) * D;
  const bf16* vg = v + int64_t(b) * nkv * ldkv + int64_t(h) * D;
  const int q_rows = min(BQ, nq - q0);

  load_tile<D, DP, P::LDH>(qs, qg, BQ, q_rows, ldq);
  for (int i = threadIdx.x; i < BQ * P::LDO; i += kThreads) os[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += kThreads) {
    ms[i] = -INFINITY;
    ls[i] = 0.f;
  }

  for (int kv0 = 0; kv0 < kv_len; kv0 += BKV) {
    __syncthreads();  // the previous tile's p@v has finished reading ks/vs/ps
    const int kv_rows = min(BKV, kv_len - kv0);
    load_tile<D, DP, P::LDH>(ks, kg + int64_t(kv0) * ldkv, BKV, kv_rows, ldkv);
    load_tile<D, DP, P::LDH>(vs, vg + int64_t(kv0) * ldkv, BKV, kv_rows, ldkv);
    __syncthreads();

    // s = q k^T on the tensor cores, 16x16 tiles spread over the warps
    for (int t = warp; t < (BQ / 16) * (BKV / 16); t += kWarps) {
      const int ti = t / (BKV / 16), tj = t % (BKV / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, qs + ti * 16 * P::LDH + kk, P::LDH);
        wmma::load_matrix_sync(fb, ks + tj * 16 * P::LDH + kk, P::LDH);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(ss + ti * 16 * P::LDS + tj * 16, acc, P::LDS,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // online softmax in log2 space, one warp per row
    for (int r = warp; r < BQ; r += kWarps) {
      float sv[BKV / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BKV / 32; ++j) {
        const int c = lane + 32 * j;
        const float s = c < kv_rows ? ss[r * P::LDS + c] * scale_log2 : -INFINITY;
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
        ps[r * P::LDP + lane + 32 * j] = __float2bfloat16(p);
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

    // acc += p v on the tensor cores
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
  __syncthreads();

  bf16* og = o + (int64_t(b) * nq + q0) * ld + int64_t(h) * D;
  for (int i = threadIdx.x; i < q_rows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    og[r * ld + c] = __float2bfloat16(os[r * P::LDO + c] / fmaxf(ls[r], 1e-37f));
  }
}

template <int D, int BQ, int BKV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int batch, int nq, int nkv, int heads, int kv_len,
                   int64_t ldq, int64_t ldkv, cudaStream_t stream) {
  using P = Plan<D, BQ, BKV>;
  auto kern = flash_fwd<D, BQ, BKV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(P::bytes));
  if (err != cudaSuccess) return err;
  const float scale_log2 = kLog2e / sqrtf(float(D));
  dim3 grid((nq + BQ - 1) / BQ, heads, batch);
  kern<<<grid, kThreads, P::bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), nq, nkv, heads,
      kv_len, scale_log2, ldq, ldkv);
  return cudaGetLastError();
}

}  // namespace

namespace {

cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int batch, int nq, int nkv, int heads, int head_dim,
                     int kv_len, int64_t ldq, int64_t ldkv, cudaStream_t s) {
  switch (head_dim) {
    case 40: return launch<40, 64, 64>(q, k, v, o, batch, nq, nkv, heads, kv_len, ldq, ldkv, s);
    case 64: return launch<64, 64, 64>(q, k, v, o, batch, nq, nkv, heads, kv_len, ldq, ldkv, s);
    case 80: return launch<80, 64, 64>(q, k, v, o, batch, nq, nkv, heads, kv_len, ldq, ldkv, s);
    case 160: return launch<160, 64, 64>(q, k, v, o, batch, nq, nkv, heads, kv_len, ldq, ldkv, s);
    case 512: return launch<512, 32, 32>(q, k, v, o, batch, nq, nkv, heads, kv_len, ldq, ldkv, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: [batch, nq, heads*head_dim], k/v: [batch, nkv, heads*head_dim], o like
// q; all bf16, contiguous, 16-byte aligned.  1 <= kv_len <= nkv.  Returns a
// cudaError_t (0 on success).
extern "C" int cfgpp_flash_attention_hd(const void* q, const void* k,
                                        const void* v, void* o, int batch,
                                        int nq, int nkv, int heads,
                                        int head_dim, int kv_len,
                                        void* stream) {
  const int64_t ld = int64_t(heads) * head_dim;
  return dispatch(q, k, v, o, batch, nq, nkv, heads, head_dim, kv_len, ld, ld,
                  static_cast<cudaStream_t>(stream));
}

// qkv: [batch, n, 3*heads*head_dim] bf16 (q | k | v on the channel dim),
// contiguous, 16-byte aligned; o: [batch, n, heads*head_dim] bf16.
// Self-attention, no mask.  Returns a cudaError_t (0 on success).
extern "C" int cfgpp_flash_attention_qkv_packed(const void* qkv, void* o,
                                                int batch, int n, int heads,
                                                int head_dim, void* stream) {
  const int64_t hd = int64_t(heads) * head_dim;
  const bf16* q = static_cast<const bf16*>(qkv);
  return dispatch(q, q + hd, q + 2 * hd, o, batch, n, n, heads, head_dim, n,
                  3 * hd, 3 * hd, static_cast<cudaStream_t>(stream));
}
