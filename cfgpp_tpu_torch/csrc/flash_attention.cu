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
// in place and never sliced into copies.  kv rows at or past kv_len are
// masked and never read; the caller may pass k/v pre-padded.
// Numerics: scores and the output accumulator are f32, the running max is
// kept in log2 units (the 1/sqrt(D) scale folded into exp2), p is rounded
// to bf16 before p@v as the TPU kernel does, the row sum adds the f32 p, and
// out = acc / max(l, 1e-37).
//
// What bounds it on the H100: at long N (SD-1.5 level 0, 4096 tokens; the
// VAE mid-block, 4096 tokens at d=512) the two matrix products, 4*Nq*Nkv*D
// flops per head, on the bf16 tensor cores.  At kv=77 (cross-attention) the
// work is small and the bytes of q read and o written bound it.
//
// Design (FlashAttention-2 on mma.sync):
// - Each warp owns 16*MT query rows.  Its q fragments are loaded once into
//   registers (ldmatrix); S = q k^T runs on mma.sync m16n8k16 bf16 with the
//   scores in registers; the online softmax works on those fragments (row
//   max and sum across the four threads of a quad by shuffles); p is
//   rounded to bf16 in registers and becomes the A operand of p@v without
//   touching shared memory; v is read with ldmatrix.trans; the output
//   accumulator stays in registers for the whole kv loop.
// - k/v tiles stream through a two-stage shared-memory ring filled by
//   cp.async (16-byte copies, the zero-filling form for rows at or past
//   kv_len and for the head-dim padding), so tile j+1 loads while tile j
//   computes; one __syncthreads per tile.
// - d=40 is padded to 48 (the mma depth); the padding is zero-filled in
//   shared memory and never read from device memory.
// - Small grids (SD-1.5 level 2 and the mid block, 64 and 16 blocks of 4
//   warps) run one warp per block instead, so the grid covers more SMs.
// - d=512 (the VAE mid-block): 16 rows x 512 f32 do not fit one warp's
//   registers, so four warps share each 16-row group and each keeps a
//   128-column quarter of the output; each of the four computes the group's
//   full score tile (the q k^T work is repeated 4x: the simple first form).
// Why mma.sync and not wgmma: wgmma forms of the same loop (one or two
// warpgroups of 64 rows per block, q and p as register A operands, k and v
// through unswizzled shared-memory descriptors, with or without the next
// tile's q k^T issued under the softmax) were built and checked on the
// H100 and all ran slower than this form at SD-1.5 levels 0 and 1: at
// these head dims each product is a few small wgmmas whose latency the
// softmax does not hide, and the second score tile costs occupancy.  A
// producer warp and two consumer warpgroups in ping-pong (FlashAttention-3)
// is the form left to try (PERF.md).  A TMA tensor map per call would add
// host time to a host-bound path; cp.async needs none.
//
// Built by cfgpp_tpu_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through ctypes (plain C entry points at the end of this file).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// One instantiation: head dim D, MT 16-row m tiles per warp, RW row groups
// and CW column groups of warps per block, BKV kv rows per tile.
template <int D, int MT, int RW, int CW, int BKV>
struct Cfg {
  static constexpr int DP = (D + 15) / 16 * 16;  // head dim padded to the mma depth
  static constexpr int DC = DP / CW;             // output columns per warp
  static constexpr int LDH = DP + 8;             // smem row stride (bf16): no ldmatrix bank conflicts
  static constexpr int BQ = RW * MT * 16;        // q rows per block
  static constexpr int kThreads = RW * CW * 32;
  static constexpr bool kQRegs = DP <= 160;      // q fragments held in registers
  static constexpr size_t q_elems = size_t(BQ) * LDH;
  static constexpr size_t stage_elems = size_t(2) * BKV * LDH;   // k then v
  static constexpr size_t bytes = (q_elems + 2 * stage_elems) * sizeof(bf16);
  static_assert(D % 8 == 0, "rows are moved in 16-byte chunks");
  static_assert(DC % 16 == 0 && BKV % 16 == 0, "tile shape");
};

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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
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

// 2^x on the special-function unit: 2 ulp, results below 2^-126 flush to 0
// (beside each row's largest term, 1, they are below f32 resolution).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Issue the copies of `rows` rows of one head (D bf16 values each, `stride`
// apart in device memory) into a shared tile of width DP.  Rows at or past
// `valid` and the columns D..DP are zero-filled without a read.
template <int D, int DP, int LDH, int kThreads>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                int rows, int valid,
                                                int64_t stride) {
  constexpr int kChunks = DP / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool live = r < valid && c < D / 8;
    cp_async16(dst + r * LDH + c * 8, live ? src + r * stride + c * 8 : src,
               live ? 16 : 0);
  }
}

template <int D, int MT, int RW, int CW, int BKV>
__global__ void __launch_bounds__(Cfg<D, MT, RW, CW, BKV>::kThreads)
flash_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, bf16* __restrict__ o, int nq, int nkv,
          int heads, int kv_len, float scale_log2, int64_t ldq, int64_t ldkv) {
  using C = Cfg<D, MT, RW, CW, BKV>;
  constexpr int DP = C::DP, DC = C::DC, LDH = C::LDH, BQ = C::BQ;
  constexpr int kThreads = C::kThreads;
  constexpr int KQ = DP / 16;        // k steps of q k^T
  constexpr int NS = BKV / 8;        // n tiles of the score tile
  constexpr int NO = DC / 8;         // n tiles of a warp's output columns
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* kvs = qs + C::q_elems;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rw = warp / CW, cw = warp % CW;
  const int g = lane / 4, t = lane % 4;      // mma fragment row / column pair
  const int lr = lane % 8, li = lane / 8;    // ldmatrix row / matrix index
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const bf16* qg = q + (int64_t(b) * nq + q0) * ldq + int64_t(h) * D;
  const bf16* kg = k + int64_t(b) * nkv * ldkv + int64_t(h) * D;
  const bf16* vg = v + int64_t(b) * nkv * ldkv + int64_t(h) * D;
  const int q_rows = min(BQ, nq - q0);
  const int n_tiles = (kv_len + BKV - 1) / BKV;

  auto load_kv = [&](int j) {
    bf16* st = kvs + (j & 1) * C::stage_elems;
    const int kv0 = j * BKV, valid = min(BKV, kv_len - kv0);
    load_tile_async<D, DP, LDH, kThreads>(st, kg + int64_t(kv0) * ldkv, BKV,
                                          valid, ldkv);
    load_tile_async<D, DP, LDH, kThreads>(st + BKV * LDH,
                                          vg + int64_t(kv0) * ldkv, BKV, valid,
                                          ldkv);
  };
  load_tile_async<D, DP, LDH, kThreads>(qs, qg, BQ, q_rows, ldq);
  load_kv(0);
  cp_async_commit();

  const bf16* qw = qs + rw * MT * 16 * LDH;   // this warp's q rows
  // ldmatrix lane offsets: A (16x16, row-major source), B from k (n-major
  // source: two n tiles x two k halves), B from v (k-major source, .trans)
  const int a_off = ((li & 1) * 8 + lr) * LDH + (li >> 1) * 8;
  const int bk_off = ((li >> 1) * 8 + lr) * LDH + (li & 1) * 8;
  const int bv_off = ((li & 1) * 8 + lr) * LDH + (li >> 1) * 8 + cw * DC;

  float acc[MT][NO][4];
  float m_run[MT][2], l_run[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
    m_run[mt][0] = m_run[mt][1] = -INFINITY;
    l_run[mt][0] = l_run[mt][1] = 0.f;
  }
  uint32_t qf[C::kQRegs ? MT : 1][C::kQRegs ? KQ : 1][4];

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait_all();
    __syncthreads();   // tile j is in; every warp is done with tile j-1's stage
    if (j + 1 < n_tiles) {
      load_kv(j + 1);
      cp_async_commit();
    }
    if constexpr (C::kQRegs) {
      if (j == 0) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int kk = 0; kk < KQ; ++kk)
            ldmatrix_x4(qf[mt][kk], qw + mt * 16 * LDH + kk * 16 + a_off);
      }
    }
    const bf16* ks = kvs + (j & 1) * C::stage_elems;
    const bf16* vs = ks + BKV * LDH;

    // s = q k^T, f32 in registers
    float s[MT][NS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      uint32_t qa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (C::kQRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[mt][e] = qf[mt][kk][e];
        } else {
          ldmatrix_x4(qa[mt], qw + mt * 16 * LDH + kk * 16 + a_off);
        }
      }
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kb[4];
        ldmatrix_x4(kb, ks + np * 16 * LDH + kk * 16 + bk_off);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * np], qa[mt], kb[0], kb[1]);
          mma_bf16(s[mt][2 * np + 1], qa[mt], kb[2], kb[3]);
        }
      }
    }

    // online softmax on the fragments: thread holds rows g and g+8 of each
    // m tile, columns n*8 + 2t + {0, 1}
    const int kv0 = j * BKV;
    const bool partial = kv0 + BKV > kv_len;   // only the last tile
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (partial && kv0 + n * 8 + 2 * t + (e & 1) >= kv_len)
            s[mt][n][e] = -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[mt][n][e]);
        }
      float neg_m[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // finite: every tile holds a valid column
        const float m_new = fmaxf(m_run[mt][r], quad_max(mx[r]) * scale_log2);
        alpha[r] = fast_exp2(m_run[mt][r] - m_new);
        m_run[mt][r] = m_new;
        neg_m[r] = -m_new;
      }
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = fast_exp2(fmaf(s[mt][n][e], scale_log2, neg_m[e >> 1]));
          s[mt][n][e] = p;
          sum[e >> 1] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[mt][r] = l_run[mt][r] * alpha[r] + sum[r];
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][n][e] *= alpha[e >> 1];
    }

    // acc += p v: p (bf16) from the score fragments, v through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        pa[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        pa[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        pa[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        pa[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vs + kk * 16 * LDH + np * 16 + bv_off);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * np], pa[mt], vb[0], vb[1]);
          mma_bf16(acc[mt][2 * np + 1], pa[mt], vb[2], vb[3]);
        }
      }
    }
  }

  // out = acc / max(l, 1e-37), staged through the q tile for 16-byte stores
  __syncthreads();   // every warp is done reading q and the last k/v stage
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float l[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = fmaxf(quad_sum(l_run[mt][r]), 1e-37f);
    bf16* row = qs + (rw * MT * 16 + mt * 16 + g) * LDH + cw * DC + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(row + n * 8) = __floats2bfloat162_rn(
          acc[mt][n][0] / l[0], acc[mt][n][1] / l[0]);
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * LDH + n * 8) =
          __floats2bfloat162_rn(acc[mt][n][2] / l[1], acc[mt][n][3] / l[1]);
    }
  }
  __syncthreads();
  const int64_t ld = int64_t(heads) * D;   // the output's row stride
  bf16* og = o + (int64_t(b) * nq + q0) * ld + int64_t(h) * D;
  for (int i = threadIdx.x; i < q_rows * (D / 8); i += kThreads) {
    const int r = i / (D / 8), c = i % (D / 8);
    *reinterpret_cast<uint4*>(og + r * ld + c * 8) =
        *reinterpret_cast<const uint4*>(qs + r * LDH + c * 8);
  }
}

template <int D, int MT, int RW, int CW, int BKV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int batch, int nq, int nkv, int heads, int kv_len,
                   int64_t ldq, int64_t ldkv, cudaStream_t stream) {
  using C = Cfg<D, MT, RW, CW, BKV>;
  auto kern = flash_fwd<D, MT, RW, CW, BKV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::bytes));
  if (err != cudaSuccess) return err;
  const float scale_log2 = kLog2e / sqrtf(float(D));
  dim3 grid((nq + C::BQ - 1) / C::BQ, heads, batch);
  kern<<<grid, C::kThreads, C::bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), nq, nkv, heads,
      kv_len, scale_log2, ldq, ldkv);
  return cudaGetLastError();
}

constexpr int kSMs = 132;   // H100 SXM

// Four warps of 16*MT rows per block where that gives every SM a block;
// one warp per block otherwise (SD-1.5 level 2 and the mid block).
template <int D, int MT, int BKV>
cudaError_t launch_rows(const void* q, const void* k, const void* v, void* o,
                        int batch, int nq, int nkv, int heads, int kv_len,
                        int64_t ldq, int64_t ldkv, cudaStream_t s) {
  const int64_t blocks4 = int64_t((nq + 64 * MT - 1) / (64 * MT)) * heads * batch;
  if (blocks4 >= kSMs)
    return launch<D, MT, 4, 1, BKV>(q, k, v, o, batch, nq, nkv, heads, kv_len,
                                    ldq, ldkv, s);
  return launch<D, MT, 1, 1, BKV>(q, k, v, o, batch, nq, nkv, heads, kv_len,
                                  ldq, ldkv, s);
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int batch, int nq, int nkv, int heads, int head_dim,
                     int kv_len, int64_t ldq, int64_t ldkv, cudaStream_t s) {
  switch (head_dim) {
    case 40: return launch_rows<40, 2, 64>(q, k, v, o, batch, nq, nkv, heads, kv_len, ldq, ldkv, s);
    case 64: return launch_rows<64, 2, 64>(q, k, v, o, batch, nq, nkv, heads, kv_len, ldq, ldkv, s);
    case 80: return launch_rows<80, 1, 64>(q, k, v, o, batch, nq, nkv, heads, kv_len, ldq, ldkv, s);
    case 160: return launch_rows<160, 1, 32>(q, k, v, o, batch, nq, nkv, heads, kv_len, ldq, ldkv, s);
    case 512: return launch<512, 1, 2, 4, 32>(q, k, v, o, batch, nq, nkv, heads, kv_len, ldq, ldkv, s);
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
